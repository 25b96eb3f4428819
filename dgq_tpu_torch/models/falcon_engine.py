"""Real-quant INT8-dataflow Falcon engine on one NVIDIA GPU.

Port of ``dgq_tpu/models/falcon_engine.py`` without ``from_ptq_falcon``,
which comes with the PTQ pipeline.  Falcon-7B's block is parallel: one fp
LayerNorm feeds both branches and is requantised twice, with the attention
branch's and the MLP's own input scales (clamp -127, round half to even);
query_key_value (f32 out) -> fp RoPE -> requant into the INT8 KV cache (K
transposed) -> attention -> requant (clamp -127) -> dense, beside
dense_h_to_4h -> GELU (erf) -> requant (clamp -127) -> dense_4h_to_h; the
residual adds both branches at once.  Every linear is span-layout storage
through K9 (``w4a8_matmul_packed``).

The attention is JAX's engine's at every window, plain ops outside any
kernel: the int8 q.K^T over the whole cache (``int_matmul``), the causal
mask over Smax, an fp32 softmax and fp32 p @ dequantised V; multi-query
(71 query heads on one kv head) folds as the LLaMA engine's GQA does.  The
batched serving decode (``serving/family_batch_engine.py``) attends with
K3 instead, as JAX's does.

Parameters keep the JAX layout (layers stacked on a leading L axis, scales
8x row-replicated), so checkpoints and caches compare directly.  The cache
is written in place, as in the other engines.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from dgq_tpu_torch.models.bloom_engine import check_family_config
from dgq_tpu_torch.models.engine import EngineLinear, _attention_scores, _linear_s8, _requant, \
    map_tensors, write_window
from dgq_tpu_torch.models.falcon import FalconConfig
from dgq_tpu_torch.models.llama import rope_cos_sin, rotate_half
from dgq_tpu_torch.models.mpt_engine import gelu_erf
from dgq_tpu_torch.models.opt_engine import layer_norm
from dgq_tpu_torch.ops.attention import NEG, f32

Tensor = torch.Tensor


class FalconEngineLayer(NamedTuple):
    """One Falcon engine layer (stacked: every tensor has a leading L axis)."""

    ln_weight: Tensor  # (D,) f32, NOT scale-folded: shared by the two branch scales
    ln_bias: Tensor
    qkv_proj: EngineLinear  # f32 out; [q (H Dh) | k (Hkv Dh) | v (Hkv Dh)]
    dense: EngineLinear  # f32 out
    fc1: EngineLinear  # f32 out
    fc2: EngineLinear  # f32 out
    attn_input_scale: Tensor
    fc1_input_scale: Tensor
    q_scale: Tensor
    k_scale: Tensor
    v_scale: Tensor
    dense_input_scale: Tensor
    fc2_input_scale: Tensor


@dataclasses.dataclass
class FalconEngineParams:
    embed_tokens: Tensor  # (V, D)
    layers: FalconEngineLayer  # stacked
    ln_f_weight: Tensor
    ln_f_bias: Tensor
    lm_head: Tensor  # (V, D)

    @functools.cached_property
    def layer_list(self) -> List[FalconEngineLayer]:
        """Per-layer views of the stacked layers, made once."""
        n = self.layers.ln_weight.shape[0]
        return [map_tensors(lambda t, i=i: t[i], self.layers) for i in range(n)]


class FalconKVCache(NamedTuple):
    k: Tensor  # (L, B, Hkv, Dh, Smax) int8, K stored transposed
    v: Tensor  # (L, B, Hkv, Smax, Dh) int8
    length: int  # tokens already cached


def init_falcon_kv_cache(cfg: FalconConfig, batch: int, max_len: int,
                         device="cuda") -> FalconKVCache:
    n, hk, dh = cfg.num_hidden_layers, cfg.num_kv_heads, cfg.head_dim
    return FalconKVCache(
        k=torch.zeros((n, batch, hk, dh, max_len), dtype=torch.int8, device=device),
        v=torch.zeros((n, batch, hk, max_len, dh), dtype=torch.int8, device=device),
        length=0,
    )


@dataclasses.dataclass(frozen=True)
class FalconEngineConfig:
    """Static knobs of the Falcon forward (the JAX fields this port honours;
    the device of the parameters takes the place of ``use_kernel``)."""

    cfg: FalconConfig
    kv_bits: int = 8
    tp_axis: Optional[str] = None

    def __post_init__(self):
        check_family_config(self.kv_bits, self.tp_axis, "the Falcon engine")


def _ln_fp(x: Tensor, w: Tensor, b: Tensor, eps: float) -> Tensor:
    """The fp LayerNorm both branches share (not scale-folded)."""
    return layer_norm(x, w, b, eps)


def falcon_branch_codes(ecfg: FalconEngineConfig, layer: FalconEngineLayer, x: Tensor):
    """The parallel block's one LayerNorm requantised twice: the attention
    branch's and the MLP's int8 inputs (clamp -127)."""
    ln = _ln_fp(x, layer.ln_weight, layer.ln_bias, ecfg.cfg.layer_norm_eps)
    return (_requant(ln, layer.attn_input_scale, qmin=-127.0),
            _requant(ln, layer.fc1_input_scale, qmin=-127.0))


def falcon_qkv(ecfg: FalconEngineConfig, layer: FalconEngineLayer, x_attn_s8: Tensor,
               cos: Tensor, sin: Tensor):
    """query_key_value of (B, S, D) int8 inputs, fp RoPE at ``cos``/``sin``
    (broadcasting against (B, H, S, Dh)), requantised -> q (B, H, S, Dh), k
    and v (B, Hkv, S, Dh) int8."""
    cfg = ecfg.cfg
    b, s, _ = x_attn_s8.shape
    h, hk, dh = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
    qkv = _linear_s8(layer.qkv_proj, x_attn_s8)
    q, k, v = torch.split(qkv, [h * dh, hk * dh, hk * dh], dim=-1)
    q = q.reshape(b, s, h, dh).transpose(1, 2)
    k = k.reshape(b, s, hk, dh).transpose(1, 2)
    v = v.reshape(b, s, hk, dh).transpose(1, 2)
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    return (_requant(q, layer.q_scale).contiguous(), _requant(k, layer.k_scale),
            _requant(v, layer.v_scale))


def falcon_tail(ecfg: FalconEngineConfig, layer: FalconEngineLayer, x: Tensor, ctx: Tensor,
                x_fc1_s8: Tensor) -> Tensor:
    """The block after attention: requant (clamp -127) -> dense, and the MLP
    branch dense_h_to_4h -> GELU (erf) -> requant (clamp -127) ->
    dense_4h_to_h; the residual adds both branches."""
    attn_out = _linear_s8(layer.dense, _requant(ctx, layer.dense_input_scale, qmin=-127.0))
    h1 = gelu_erf(_linear_s8(layer.fc1, x_fc1_s8))
    mlp_out = _linear_s8(layer.fc2, _requant(h1, layer.fc2_input_scale, qmin=-127.0))
    return x + attn_out + mlp_out


def _plain_attention(ecfg: FalconEngineConfig, layer: FalconEngineLayer, q_s8: Tensor,
                     k_cache: Tensor, v_cache: Tensor, mask: Tensor) -> Tensor:
    """JAX's Falcon attention: int8 q.K^T over the whole cache, the additive
    ``mask`` (S, Smax), fp32 softmax and p @ dequantised V -> (B, S, H Dh)."""
    cfg = ecfg.cfg
    b, h, s, dh = q_s8.shape
    hk = cfg.num_kv_heads
    scores = _attention_scores(q_s8.reshape(b, hk, (h // hk) * s, dh), k_cache, layer.q_scale,
                               layer.k_scale, dh)
    scores = scores.reshape(b, hk, h // hk, s, -1) + mask[None, None, None]
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.matmul(probs, (v_cache.to(torch.float32) * layer.v_scale)[:, :, None])
    return ctx.permute(0, 3, 1, 2, 4).reshape(b, s, h * dh)


def _falcon_block(ecfg: FalconEngineConfig, layer: FalconEngineLayer, x: Tensor,
                  k_cache: Tensor, v_cache: Tensor, cache_len: int, mask: Tensor,
                  pos_cos: Tensor, pos_sin: Tensor) -> Tensor:
    """One parallel block on (B, S, D) fp32 activations; writes the S new
    tokens' int8 K/V into the caches at [cache_len, cache_len + S)."""
    x_attn_s8, x_fc1_s8 = falcon_branch_codes(ecfg, layer, x)
    q, k, v = falcon_qkv(ecfg, layer, x_attn_s8, pos_cos[None, None], pos_sin[None, None])
    write_window(k_cache, k.transpose(2, 3), cache_len, 3)
    write_window(v_cache, v, cache_len, 2)
    ctx = _plain_attention(ecfg, layer, q, k_cache, v_cache, mask)
    return falcon_tail(ecfg, layer, x, ctx, x_fc1_s8)


def falcon_engine_forward(ecfg: FalconEngineConfig, params: FalconEngineParams,
                          input_ids: Tensor, cache: FalconKVCache, *,
                          window: str = "auto") -> Tuple[Tensor, FalconKVCache]:
    """Prefill or decode step: runs S tokens starting at cache.length.

    Returns (logits (B, S, V) f32, cache advanced by S).  ``window`` is
    accepted for the forward contract of the LLaMA engine; this family
    applies fp p @ V everywhere, so it does not alter numerics.  Runs on the
    device of the parameters."""
    cfg = ecfg.cfg
    dev = params.embed_tokens.device
    input_ids = input_ids.to(dev)
    b, s = input_ids.shape
    smax = cache.k.shape[4]
    if cache.length + s > smax:
        raise ValueError(f"cache overflow: {cache.length} + {s} > {smax}")
    x = params.embed_tokens[input_ids.long()].to(torch.float32)
    pos = cache.length + torch.arange(s, device=dev)
    pos_cos, pos_sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    j = torch.arange(smax, device=dev)[None, :]
    mask = torch.where(j <= pos[:, None], f32(0.0, dev), f32(NEG, dev))
    for li, layer in enumerate(params.layer_list):
        x = _falcon_block(ecfg, layer, x, cache.k[li], cache.v[li], cache.length, mask, pos_cos,
                          pos_sin)
    x = layer_norm(x, params.ln_f_weight, params.ln_f_bias, cfg.layer_norm_eps)
    logits = torch.matmul(x, params.lm_head.to(x.dtype).t())
    return logits, cache._replace(length=cache.length + s)
