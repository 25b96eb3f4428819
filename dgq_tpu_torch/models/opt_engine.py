"""Real-quant INT8-dataflow OPT engine on one NVIDIA GPU.

Port of ``dgq_tpu/models/opt_engine.py:38-335`` without ``from_ptq_opt``,
which comes with the PTQ pipeline.  LayerNormQ -> q|k|v as one int8-out GEMM
(its alpha carries each part's output scale, and q's also 1/sqrt(Dh)) into
the INT8 KV cache -> attention -> requant (clamp -127) -> out_proj ->
LayerNormQ -> fc1 -> ReLU -> requant (clamp -128) -> fc2.  Every linear is
span-layout storage through K9 (``w4a8_matmul_packed``), int8 out for
q|k|v and f32 out with the bias in the epilogue for the others.  Decode
steps attend with K3 (``int8_decode_attention``; ``apply_sqrt_dh=False``,
since q already carries the scaling, and fp p @ V, as JAX's OPT path), or
K7 past the AUTO chunk; prompt windows attend with plain torch ops, as JAX
computes them outside any kernel.

Parameters keep the JAX layout (layers stacked on a leading L axis, q|k|v
fused along N, scales 8x row-replicated), so checkpoints and caches compare
directly.  The cache is written in place, as in the LLaMA engine.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from dgq_tpu_torch.models.engine import (
    EngineLinear,
    _lin_groupsize,
    _linear_s8,
    _requant,
    map_tensors,
    write_window,
)
from dgq_tpu_torch.models.opt import OPTConfig
from dgq_tpu_torch.ops.attention import (
    NEG,
    auto_decode_chunk,
    f32,
    int8_decode_attention,
    int8_decode_attention_chunked,
)
from dgq_tpu_torch.ops.quant_matmul import short_int_matmul, w4a8_matmul_packed

Tensor = torch.Tensor


class OPTEngineLayer(NamedTuple):
    """One OPT engine layer (stacked: every tensor has a leading L axis)."""

    ln1_weight: Tensor  # (D,) f32, / attn_input_scale
    ln1_bias: Tensor
    qkv_proj: EngineLinear  # int8 out; N = 3D
    out_proj: EngineLinear  # f32 out
    ln2_weight: Tensor  # / fc1_input_scale
    ln2_bias: Tensor
    fc1: EngineLinear  # f32 out
    fc2: EngineLinear  # f32 out
    q_scale: Tensor
    k_scale: Tensor
    v_scale: Tensor
    out_input_scale: Tensor
    fc2_input_scale: Tensor


@dataclasses.dataclass
class OPTEngineParams:
    embed_tokens: Tensor  # (V, D)
    embed_positions: Tensor  # (P + 2, D)
    layers: OPTEngineLayer  # stacked
    final_ln_weight: Tensor
    final_ln_bias: Tensor
    lm_head: Tensor  # (V, D)

    @functools.cached_property
    def layer_list(self) -> List[OPTEngineLayer]:
        """Per-layer views of the stacked layers, made once."""
        n = self.layers.ln1_weight.shape[0]
        return [map_tensors(lambda t, i=i: t[i], self.layers) for i in range(n)]


class OPTKVCache(NamedTuple):
    k: Tensor  # (L, B, H, Dh, Smax) int8, K stored transposed
    v: Tensor  # (L, B, H, Smax, Dh) int8
    length: "int | Tensor"  # tokens already cached (a 0-d device tensor inside a device loop)


def init_opt_kv_cache(cfg: OPTConfig, batch: int, max_len: int, device="cuda") -> OPTKVCache:
    n, h, dh = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    return OPTKVCache(
        k=torch.zeros((n, batch, h, dh, max_len), dtype=torch.int8, device=device),
        v=torch.zeros((n, batch, h, max_len, dh), dtype=torch.int8, device=device),
        length=0,
    )


@dataclasses.dataclass(frozen=True)
class OPTEngineConfig:
    """Static knobs of the OPT forward (the JAX fields this port honours;
    the device of the parameters takes the place of ``use_kernel``)."""

    cfg: OPTConfig
    # decode attention: -1 (AUTO) K3 up to Smax 8192 and K7 beyond; > 0
    # forces K7 with chunks of that size wherever Smax exceeds it; 0 never
    # chunks (max_position_embeddings caps OPT's cache at 2048: K3)
    decode_attn_chunk: int = -1
    kv_bits: int = 8
    tp_axis: Optional[str] = None

    def __post_init__(self):
        if self.kv_bits != 8:
            raise NotImplementedError("the OPT engine keeps an INT8 KV cache (kv_bits=8), as "
                                      "JAX's")
        if self.tp_axis is not None:
            raise NotImplementedError("tensor parallelism (tp_axis) is not ported yet "
                                      "(ROADMAP Queue 1 item 7)")


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, eps: float) -> Tensor:
    """fp32 LayerNorm."""
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * weight + bias


def _layer_norm_q(x: Tensor, weight_q: Tensor, bias_q: Tensor, eps: float) -> Tensor:
    """LayerNormQ: fp LN with scale-folded weight and bias, round -> int8."""
    return torch.clamp(torch.round(layer_norm(x, weight_q, bias_q, eps)), -128, 127).to(
        torch.int8)


def _linear_s8_int8out(lin: EngineLinear, x_s8: Tensor) -> Tensor:
    """int8 activations (..., K) -> int8 (..., N), requantised in K9's
    epilogue: ``clip(round(acc * alpha + bias))``."""
    x2 = x_s8.reshape(-1, x_s8.shape[-1]).contiguous()
    y = w4a8_matmul_packed(x2, lin.qweight, lin.wscales, lin.wzeros, lin.alpha, lin.bias,
                           groupsize=_lin_groupsize(lin), out_dtype=torch.int8,
                           scales_replicated=True)
    return y.reshape(*x_s8.shape[:-1], -1)


def _opt_qkv(ecfg: OPTEngineConfig, layer: OPTEngineLayer, x: Tensor):
    """LayerNormQ and the int8-out q|k|v of (B, S, D) activations -> q, k, v
    int8 (B, H, S, Dh)."""
    cfg = ecfg.cfg
    b, s, _ = x.shape
    dh = cfg.head_dim
    x_s8 = _layer_norm_q(x, layer.ln1_weight, layer.ln1_bias, cfg.layer_norm_eps)
    q, k, v = torch.chunk(_linear_s8_int8out(layer.qkv_proj, x_s8), 3, dim=-1)
    h = q.shape[-1] // dh
    return tuple(t.reshape(b, s, h, dh).transpose(1, 2) for t in (q, k, v))


def opt_decode_ctx(ecfg: OPTEngineConfig, layer: OPTEngineLayer, q_s8: Tensor, k_cache: Tensor,
                   v_cache: Tensor, lengths) -> Tensor:
    """One decode token per slot: q_s8 (B, H, Dh) over the slots' valid
    ``lengths`` (int or (B,)) -> (B, H, Dh) f32.  K3, or K7 past the AUTO
    chunk; the scaling is absorbed into q (no 1/sqrt(Dh)) and JAX's OPT path
    keeps fp p @ V."""
    smax = k_cache.shape[-1]
    chunk = ecfg.decode_attn_chunk
    if chunk < 0:  # AUTO
        chunk = auto_decode_chunk(smax)
    if chunk and smax > chunk:
        return int8_decode_attention_chunked(q_s8, k_cache, v_cache, lengths, layer.q_scale,
                                             layer.k_scale, layer.v_scale, chunk=chunk,
                                             apply_sqrt_dh=False)
    return int8_decode_attention(q_s8, k_cache, v_cache, lengths, layer.q_scale, layer.k_scale,
                                 layer.v_scale, apply_sqrt_dh=False)


def _opt_tail(ecfg: OPTEngineConfig, layer: OPTEngineLayer, x: Tensor, ctx: Tensor) -> Tensor:
    """The block after attention: requant (clamp -127) -> out_proj ->
    residual -> LayerNormQ -> fc1 -> ReLU -> requant -> fc2 -> residual."""
    cfg = ecfg.cfg
    ctx_s8 = _requant(ctx, layer.out_input_scale, qmin=-127.0)
    x = x + _linear_s8(layer.out_proj, ctx_s8)
    x_s8 = _layer_norm_q(x, layer.ln2_weight, layer.ln2_bias, cfg.layer_norm_eps)
    h1 = torch.relu(_linear_s8(layer.fc1, x_s8))
    h_s8 = _requant(h1, layer.fc2_input_scale)
    return x + _linear_s8(layer.fc2, h_s8)


def _opt_block(ecfg: OPTEngineConfig, layer: OPTEngineLayer, x: Tensor, k_cache: Tensor,
               v_cache: Tensor, cache_len, mask: Optional[Tensor]) -> Tensor:
    """One decoder block on (B, S, D) fp32 activations; writes the S new
    tokens' int8 K/V into the caches at [cache_len, cache_len + S)."""
    b, s, _ = x.shape
    q, k, v = _opt_qkv(ecfg, layer, x)
    h, dh = q.shape[1], q.shape[3]
    q_s8 = q.contiguous()
    write_window(k_cache, k.transpose(2, 3), cache_len, 3)
    write_window(v_cache, v, cache_len, 2)

    if s == 1:
        ctx = opt_decode_ctx(ecfg, layer, q_s8[:, :, 0, :], k_cache, v_cache,
                             cache_len + 1).reshape(b, 1, h * dh)
    else:
        # INT8 q.k^T over Dh (exact in float32), alpha = q_scale * k_scale
        scores = short_int_matmul(q_s8, k_cache) * (layer.q_scale * layer.k_scale)
        probs = torch.softmax(scores + mask[None, None], dim=-1)
        ctx = torch.matmul(probs, v_cache.to(torch.float32) * layer.v_scale)
        ctx = ctx.transpose(1, 2).reshape(b, s, h * dh)
    return _opt_tail(ecfg, layer, x, ctx)


def opt_engine_forward(ecfg: OPTEngineConfig, params: OPTEngineParams, input_ids: Tensor,
                       cache: OPTKVCache, *, window: str = "auto") -> Tuple[Tensor, OPTKVCache]:
    """Prefill or decode step: runs S tokens starting at cache.length.

    Returns (logits (B, S, V) f32, cache advanced by S).  ``window`` is
    accepted for the forward contract of the LLaMA engine; OPT applies fp
    p @ V everywhere, so it does not alter numerics.  Runs on the device of
    the parameters."""
    cfg = ecfg.cfg
    dev = params.embed_tokens.device
    input_ids = input_ids.to(dev)
    b, s = input_ids.shape
    smax = cache.k.shape[4]
    if not isinstance(cache.length, torch.Tensor) and cache.length + s > smax:
        raise ValueError(f"cache overflow: {cache.length} + {s} > {smax}")
    positions = cache.length + torch.arange(s, device=dev)
    x = (params.embed_tokens[input_ids] + params.embed_positions[positions + 2][None]).to(
        torch.float32)
    mask = None
    if s > 1:
        j = torch.arange(smax, device=dev)[None, :]
        mask = torch.where(j <= positions[:, None], f32(0.0, dev), f32(NEG, dev))

    for li, layer in enumerate(params.layer_list):
        x = _opt_block(ecfg, layer, x, cache.k[li], cache.v[li], cache.length, mask)

    x = layer_norm(x, params.final_ln_weight, params.final_ln_bias, cfg.layer_norm_eps)
    logits = torch.matmul(x, params.lm_head.to(x.dtype).t())
    return logits, cache._replace(length=cache.length + s)
