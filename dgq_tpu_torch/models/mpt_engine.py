"""Real-quant INT8-dataflow MPT engine on one NVIDIA GPU.

Port of ``dgq_tpu/models/mpt_engine.py`` without ``from_ptq_mpt``, which
comes with the PTQ pipeline: the BLOOM engine's structure with MPT's
architecture.  LayerNormQ -> the fused Wqkv as one int8-out GEMM
(concatenated [q | k | v], each part's alpha carrying its own output
scale) into the INT8 KV cache (K transposed) -> INT8 q.k^T + ALiBi
(``bloom_engine.alibi_int8_attention``: K3, K7 past 8192 positions, K2) ->
fp32 softmax -> p @ dequantised V -> requant (clamp -127) -> out_proj ->
LayerNormQ -> up_proj -> GELU (erf) -> requant (clamp -127, MPT's own:
BLOOM clamps at -128) -> down_proj.  No embedding LayerNorm; the no_bias
configuration keeps zero LayerNorm biases.  Every linear is span-layout
storage through K9 (``w4a8_matmul_packed``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from dgq_tpu_torch.models.bloom_engine import (
    attend_window,
    causal_mask,
    check_family_config,
    slopes_on,
)
from dgq_tpu_torch.models.engine import EngineLinear, _linear_s8, _requant, map_tensors
from dgq_tpu_torch.models.mpt import MPTConfig
from dgq_tpu_torch.models.opt_engine import _layer_norm_q, _linear_s8_int8out, layer_norm
from dgq_tpu_torch.ops.attention import f32

Tensor = torch.Tensor


class MPTEngineLayer(NamedTuple):
    """One MPT engine layer (stacked: every tensor has a leading L axis)."""

    ln1_weight: Tensor  # (D,) f32, / attn_input_scale
    ln1_bias: Tensor
    qkv_proj: EngineLinear  # int8 out; concatenated [q | k | v] channels
    out_proj: EngineLinear  # f32 out
    ln2_weight: Tensor  # / fc1_input_scale
    ln2_bias: Tensor
    up_proj: EngineLinear  # f32 out
    down_proj: EngineLinear  # f32 out
    q_scale: Tensor
    k_scale: Tensor
    v_scale: Tensor
    out_input_scale: Tensor
    fc2_input_scale: Tensor


@dataclasses.dataclass
class MPTEngineParams:
    embed_tokens: Tensor  # (V, D)
    layers: MPTEngineLayer  # stacked
    norm_f_weight: Tensor
    norm_f_bias: Tensor
    lm_head: Tensor  # (V, D)

    @functools.cached_property
    def layer_list(self) -> List[MPTEngineLayer]:
        """Per-layer views of the stacked layers, made once."""
        n = self.layers.ln1_weight.shape[0]
        return [map_tensors(lambda t, i=i: t[i], self.layers) for i in range(n)]


class MPTKVCache(NamedTuple):
    k: Tensor  # (L, B, H, Dh, Smax) int8, K stored transposed
    v: Tensor  # (L, B, H, Smax, Dh) int8
    length: int  # tokens already cached


def init_mpt_kv_cache(cfg: MPTConfig, batch: int, max_len: int, device="cuda") -> MPTKVCache:
    n, h, dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    return MPTKVCache(
        k=torch.zeros((n, batch, h, dh, max_len), dtype=torch.int8, device=device),
        v=torch.zeros((n, batch, h, max_len, dh), dtype=torch.int8, device=device),
        length=0,
    )


@dataclasses.dataclass(frozen=True)
class MPTEngineConfig:
    """Static knobs of the MPT forward (the JAX fields this port honours;
    the device of the parameters takes the place of ``use_kernel``)."""

    cfg: MPTConfig
    kv_bits: int = 8
    tp_axis: Optional[str] = None

    def __post_init__(self):
        check_family_config(self.kv_bits, self.tp_axis)


def gelu_erf(x: Tensor) -> Tensor:
    """jax.nn.gelu(approximate=False), its operations in JAX's order."""
    return 0.5 * x * torch.special.erfc(-x * f32(math.sqrt(0.5), x.device))


def _mpt_qkv(ecfg: MPTEngineConfig, layer: MPTEngineLayer, x: Tensor):
    """LayerNormQ and the int8-out Wqkv of (B, S, D) activations, its
    concatenated [q | k | v] split -> q, k, v int8 (B, H, S, Dh)."""
    cfg = ecfg.cfg
    b, s, _ = x.shape
    x_s8 = _layer_norm_q(x, layer.ln1_weight, layer.ln1_bias, cfg.layer_norm_eps)
    return tuple(t.reshape(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)
                 for t in torch.chunk(_linear_s8_int8out(layer.qkv_proj, x_s8), 3, dim=-1))


def _mpt_tail(ecfg: MPTEngineConfig, layer: MPTEngineLayer, x: Tensor, ctx: Tensor) -> Tensor:
    """The block after attention: requant (clamp -127) -> out_proj ->
    residual -> LayerNormQ -> up_proj -> GELU (erf) -> requant (clamp -127)
    -> down_proj -> residual."""
    cfg = ecfg.cfg
    ctx_s8 = _requant(ctx, layer.out_input_scale, qmin=-127.0)
    x = x + _linear_s8(layer.out_proj, ctx_s8)
    x_s8 = _layer_norm_q(x, layer.ln2_weight, layer.ln2_bias, cfg.layer_norm_eps)
    h1 = gelu_erf(_linear_s8(layer.up_proj, x_s8))
    h_s8 = _requant(h1, layer.fc2_input_scale, qmin=-127.0)
    return x + _linear_s8(layer.down_proj, h_s8)


def _mpt_block(ecfg: MPTEngineConfig, layer: MPTEngineLayer, x: Tensor, k_cache: Tensor,
               v_cache: Tensor, cache_len: int, mask: Optional[Tensor],
               slopes: Tensor) -> Tensor:
    """One decoder block on (B, S, D) fp32 activations; writes the S new
    tokens' int8 K/V into the caches at [cache_len, cache_len + S)."""
    ctx = attend_window(_mpt_qkv(ecfg, layer, x), k_cache, v_cache, cache_len, layer, slopes,
                        mask)
    return _mpt_tail(ecfg, layer, x, ctx)


def mpt_engine_forward(ecfg: MPTEngineConfig, params: MPTEngineParams, input_ids: Tensor,
                       cache: MPTKVCache, *, window: str = "auto") -> Tuple[Tensor, MPTKVCache]:
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
    mask = causal_mask(cache.length, s, smax, dev)
    slopes = slopes_on(cfg.n_heads, str(dev))
    for li, layer in enumerate(params.layer_list):
        x = _mpt_block(ecfg, layer, x, cache.k[li], cache.v[li], cache.length, mask, slopes)
    x = layer_norm(x, params.norm_f_weight, params.norm_f_bias, cfg.layer_norm_eps)
    logits = torch.matmul(x, params.lm_head.to(x.dtype).t())
    return logits, cache._replace(length=cache.length + s)
