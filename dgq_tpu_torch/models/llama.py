"""Functional LLaMA/LLaMA-2: the config, the fp primitives the INT8 engine
shares, and the fake-quant forward that calibration and evaluation run.

Port of ``dgq_tpu/models/llama.py``; the config's defaults are LLaMA-2-7B.
Params are nested dicts of tensors in the HF (out, in) layout:

  layers[i] = {
    'input_layernorm':          {'weight': (D,)},
    'self_attn': {'q_proj'|'k_proj'|'v_proj'|'o_proj': {'weight': (N, K)}},
    'post_attention_layernorm': {'weight': (D,)},
    'mlp': {'gate_proj'|'up_proj'|'down_proj': {'weight': (N, K)}},
  }

and quantization swaps a linear's dict for a
:class:`~dgq_tpu_torch.quant.packing.PackedLinear`.  ``QuantState`` holds
the phase toggles of the fake-quant forward.  Numerics as HF LlamaModel:
RMSNorm in fp32, rotate-half RoPE, fp32 softmax, GQA by head repetition.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from dgq_tpu_torch.quant.act_quant import make_act_quant_fn
from dgq_tpu_torch.quant.packing import PackedLinear, dequantize_linear, \
    packed_linear_from_arrays, tensor_from_array

Tensor = torch.Tensor

LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def tiny_llama_config(**overrides) -> LlamaConfig:
    """Tiny fixture config for CPU tests."""
    base = dict(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=4,
        max_position_embeddings=512,
    )
    base.update(overrides)
    return LlamaConfig(**base)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """HF LlamaRMSNorm: fp32 variance, weight applied after downcast."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (weight.to(dt) * xf.to(dt)).to(dt)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32):
    """(S,) positions -> cos/sin of shape (S, head_dim) (halves duplicated,
    HF layout)."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=dev) / head_dim))
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


class KVQuantState(NamedTuple):
    """Static per-tensor q/k/v scales frozen by kv calibration (scale =
    2 * absmax / 255, zero 128)."""

    q_scale: Tensor
    k_scale: Tensor
    v_scale: Tensor


@dataclasses.dataclass(frozen=True)
class QuantState:
    """Phase toggles of the fake-quant forward."""

    actq: bool = False
    wtq: bool = False
    kv: bool = False  # apply kv fake-quant where scales are present


# ---------------------------------------------------------------------------
# init / primitives
# ---------------------------------------------------------------------------


def init_llama_params(cfg: LlamaConfig, generator: torch.Generator, dtype=torch.float32,
                      device="cuda") -> Dict[str, Any]:
    """Random params (tests, fixtures, the smoke test), drawn from
    ``generator`` (on ``device``) in JAX's layout and scales: each linear
    N(0, 1) * 0.8 / sqrt(in), the embedding and head N(0, 1) * 0.02, norms
    one.  The bits differ from JAX's draws."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    nq = cfg.num_attention_heads * cfg.head_dim
    nkv = cfg.num_key_value_heads * cfg.head_dim

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)

    def lin(n_out, n_in):
        return {"weight": normal(n_out, n_in) * (0.8 / math.sqrt(n_in))}

    def ones():
        return {"weight": torch.ones((d,), dtype=dtype, device=device)}

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
            "input_layernorm": ones(),
            "self_attn": {"q_proj": lin(nq, d), "k_proj": lin(nkv, d), "v_proj": lin(nkv, d),
                          "o_proj": lin(d, nq)},
            "post_attention_layernorm": ones(),
            "mlp": {"gate_proj": lin(f, d), "up_proj": lin(f, d), "down_proj": lin(d, f)},
        })
    return {"embed_tokens": normal(cfg.vocab_size, d) * 0.02, "layers": layers,
            "norm": ones(), "lm_head": {"weight": normal(cfg.vocab_size, d) * 0.02}}


def llama_params_from_arrays(tree, device="cuda"):
    """The port's params from a params tree of numpy-convertible arrays (JAX's
    ``init_llama_params`` or PTQ output, say): dicts and lists kept, arrays
    made tensors on ``device``, packed linears (objects with a ``qweight``)
    made the port's PackedLinear."""
    if isinstance(tree, dict):
        return {k: llama_params_from_arrays(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [llama_params_from_arrays(v, device) for v in tree]
    if tree is None:
        return None
    if hasattr(tree, "qweight"):
        return packed_linear_from_arrays(tree, device)
    return tensor_from_array(tree, device)


def apply_rope(q: Tensor, k: Tensor, cos: Tensor, sin: Tensor):
    """q, k: (B, H, S, Dh); cos/sin: (S, Dh)."""
    cos = cos[None, None]
    sin = sin[None, None]
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def _kv_fake_quant(x: Tensor, scale: Tensor) -> Tensor:
    """Asymmetric 8-bit fake-quant, zero 128: round(x / scale) + 128 (half to
    even) clipped to [0, 255]."""
    q = torch.clamp(torch.round(x.to(torch.float32) / scale) + 128.0, 0.0, 255.0)
    return (scale * (q - 128.0)).to(x.dtype)


def linear_apply(lin, x: Tensor, qs: QuantState) -> Tensor:
    """An fp linear (dict) or a PackedLinear: optional static act quant, the
    weight dequantized on the fly, an fp matmul, the bias."""
    if isinstance(lin, PackedLinear):
        if qs.actq and lin.amax is not None:
            x = make_act_quant_fn(lin.act_method, lin.abits)(x, lin.amax)
        if not qs.wtq:
            raise ValueError("PackedLinear has no fp weight; wtq must be on")
        y = torch.matmul(x, dequantize_linear(lin).to(x.dtype))
        if lin.bias is not None:
            y = y + lin.bias.to(y.dtype)
        return y
    y = torch.matmul(x, lin["weight"].to(x.dtype).t())
    b = lin.get("bias")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------


def causal_mask(s_q: int, s_k: int, dtype=torch.float32, device="cuda") -> Tensor:
    """Additive causal mask (1, 1, S_q, S_k)."""
    i = torch.arange(s_q, device=device)[:, None] + (s_k - s_q)
    j = torch.arange(s_k, device=device)[None, :]
    m = torch.where(j <= i, torch.zeros((), device=device),
                    torch.full((), torch.finfo(torch.float32).min, device=device))
    return m[None, None].to(dtype)


def llama_attention(attn_params, x: Tensor, mask: Tensor, cos: Tensor, sin: Tensor,
                    cfg: LlamaConfig, qs: QuantState, kv_scales: Optional[KVQuantState] = None,
                    collect: Optional[dict] = None) -> Tensor:
    """Full-sequence attention (calibration and fake-quant eval): q/k/v proj
    -> RoPE -> GQA repeat -> q/k/v fake-quant (when calibrated) -> fp
    attention -> o_proj.  ``collect`` receives the post-RoPE q/k/v and
    o_proj's input."""
    b, s, _ = x.shape
    h, hk, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    q = linear_apply(attn_params["q_proj"], x, qs)
    k = linear_apply(attn_params["k_proj"], x, qs)
    v = linear_apply(attn_params["v_proj"], x, qs)

    q = q.reshape(b, s, h, dh).transpose(1, 2)
    k = k.reshape(b, s, hk, dh).transpose(1, 2)
    v = v.reshape(b, s, hk, dh).transpose(1, 2)
    q, k = apply_rope(q, k, cos, sin)

    rep = h // hk
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)

    if collect is not None:
        collect["q_rope"] = q
        collect["k_rope"] = k
        collect["v_rope"] = v

    if qs.kv and kv_scales is not None:
        q = _kv_fake_quant(q, kv_scales.q_scale)
        k = _kv_fake_quant(k, kv_scales.k_scale)
        v = _kv_fake_quant(v, kv_scales.v_scale)

    scores = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) / math.sqrt(dh)
    scores = scores + mask.to(torch.float32)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, h * dh)
    if collect is not None:
        collect["o_proj_inp"] = ctx
    return linear_apply(attn_params["o_proj"], ctx, qs)


def llama_mlp(mlp_params, x: Tensor, qs: QuantState, collect: Optional[dict] = None) -> Tensor:
    gate = linear_apply(mlp_params["gate_proj"], x, qs)
    up = linear_apply(mlp_params["up_proj"], x, qs)
    h = torch.nn.functional.silu(gate) * up
    if collect is not None:
        collect["down_proj_inp"] = h
    return linear_apply(mlp_params["down_proj"], h, qs)


def _norm(p, x: Tensor, eps: float) -> Tensor:
    """RMSNorm plus the meanact bias, when the layer has one."""
    y = rms_norm(x, p["weight"], eps)
    if p.get("bias") is not None:
        y = y + p["bias"].to(y.dtype)
    return y


def llama_block(layer_params, x: Tensor, mask: Tensor, cos: Tensor, sin: Tensor,
                cfg: LlamaConfig, qs: QuantState = QuantState(),
                kv_scales: Optional[KVQuantState] = None, collect_stats: bool = False):
    """One decoder block; with ``collect_stats`` also the dict of the
    intermediates calibration reads (the norms' outputs, the linears'
    inputs, the post-RoPE q/k/v)."""
    collect: Optional[dict] = {} if collect_stats else None

    ln1 = _norm(layer_params["input_layernorm"], x, cfg.rms_norm_eps)
    if collect is not None:
        collect["attn_ln_out"] = ln1
        collect["qkv_inp"] = ln1
    x = x + llama_attention(layer_params["self_attn"], ln1, mask, cos, sin, cfg, qs,
                            kv_scales, collect)

    ln2 = _norm(layer_params["post_attention_layernorm"], x, cfg.rms_norm_eps)
    if collect is not None:
        collect["mlp_ln_out"] = ln2
        collect["gate_up_inp"] = ln2
    x = x + llama_mlp(layer_params["mlp"], ln2, qs, collect)

    if collect is not None:
        return x, collect
    return x


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def llama_embed(params, input_ids: Tensor) -> Tensor:
    emb = params["embed_tokens"]
    return emb[input_ids.to(emb.device).long()]


def llama_head(params, x: Tensor, cfg: LlamaConfig) -> Tensor:
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    return torch.matmul(x, params["lm_head"]["weight"].to(x.dtype).t())


def llama_apply(params, input_ids: Tensor, cfg: LlamaConfig, qs: QuantState = QuantState(),
                kv_scales_per_layer=None) -> Tensor:
    """Full forward: (B, S) token ids -> (B, S, V) logits, on the device of
    the embedding."""
    _, s = input_ids.shape
    x = llama_embed(params, input_ids)
    dev = x.device
    mask = causal_mask(s, s, x.dtype, dev)
    cos, sin = rope_cos_sin(torch.arange(s, device=dev), cfg.head_dim, cfg.rope_theta, x.dtype)
    for i, layer in enumerate(params["layers"]):
        kv = None if kv_scales_per_layer is None else kv_scales_per_layer[i]
        x = llama_block(layer, x, mask, cos, sin, cfg, qs, kv)
    return llama_head(params, x, cfg)
