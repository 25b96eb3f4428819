"""Real-quant INT8-dataflow BLOOM engine on one NVIDIA GPU.

Port of ``dgq_tpu/models/bloom_engine.py`` without ``from_ptq_bloom``,
which comes with the PTQ pipeline.  Embedding LayerNorm, then per block:
LayerNormQ -> the fused query_key_value as one int8-out GEMM (its alpha
carries each interleaved (head, {q, k, v}, Dh) channel's own output scale)
into the INT8 KV cache (K transposed) -> INT8 q.k^T + ALiBi -> fp32 softmax
-> p @ dequantised V -> requant (clamp -127) -> dense -> LayerNormQ ->
dense_h_to_4h -> GELU (tanh) -> requant (clamp -128) -> dense_4h_to_h.
Every linear is span-layout storage through K9 (``w4a8_matmul_packed``, the
OPT engine's helpers).

``alibi_int8_attention``, which the MPT engine shares, attends a decode
token with K3 (``int8_decode_attention``) and a prompt window of more than
8 tokens on a cache of a multiple of 128 positions with K2
(``int8_prefill_attention``), both with their ALiBi operand, as JAX's; other
windows with plain torch ops, as JAX computes them outside any kernel.
Past ``DECODE_SHORT_SMAX`` positions, K3's limit on this card, a decode
token takes K7 (``int8_decode_attention_chunked``) with the same slopes, as
the LLaMA engine routes (JAX's engine calls its whole-cache K3 there).

Parameters keep the JAX layout (layers stacked on a leading L axis, scales
8x row-replicated), so checkpoints and caches compare directly.  The cache
is written in place, as in the other engines.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from dgq_tpu_torch.models.bloom import BloomConfig, alibi_slopes
from dgq_tpu_torch.models.engine import EngineLinear, _linear_s8, _requant, map_tensors, \
    write_window
from dgq_tpu_torch.models.opt_engine import _layer_norm_q, _linear_s8_int8out, layer_norm
from dgq_tpu_torch.ops.attention import (
    DECODE_SHORT_SMAX,
    NEG,
    _alibi_bias,
    auto_decode_chunk,
    f32,
    int8_decode_attention,
    int8_decode_attention_chunked,
    int8_prefill_attention,
    qk_scale,
)
from dgq_tpu_torch.ops.quant_matmul import short_int_matmul

Tensor = torch.Tensor


class BloomEngineLayer(NamedTuple):
    """One BLOOM engine layer (stacked: every tensor has a leading L axis)."""

    ln1_weight: Tensor  # (D,) f32, / attn_input_scale
    ln1_bias: Tensor
    qkv_proj: EngineLinear  # int8 out; interleaved (h, 3, dh) channels
    dense: EngineLinear  # f32 out
    ln2_weight: Tensor  # / fc1_input_scale
    ln2_bias: Tensor
    fc1: EngineLinear  # f32 out
    fc2: EngineLinear  # f32 out
    q_scale: Tensor
    k_scale: Tensor
    v_scale: Tensor
    dense_input_scale: Tensor
    fc2_input_scale: Tensor


@dataclasses.dataclass
class BloomEngineParams:
    embed_tokens: Tensor  # (V, D)
    emb_ln_weight: Tensor
    emb_ln_bias: Tensor
    layers: BloomEngineLayer  # stacked
    ln_f_weight: Tensor
    ln_f_bias: Tensor
    lm_head: Tensor  # (V, D)

    @functools.cached_property
    def layer_list(self) -> List[BloomEngineLayer]:
        """Per-layer views of the stacked layers, made once."""
        n = self.layers.ln1_weight.shape[0]
        return [map_tensors(lambda t, i=i: t[i], self.layers) for i in range(n)]


class BloomKVCache(NamedTuple):
    k: Tensor  # (L, B, H, Dh, Smax) int8, K stored transposed
    v: Tensor  # (L, B, H, Smax, Dh) int8
    length: int  # tokens already cached


def init_bloom_kv_cache(cfg: BloomConfig, batch: int, max_len: int,
                        device="cuda") -> BloomKVCache:
    n, h, dh = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    return BloomKVCache(
        k=torch.zeros((n, batch, h, dh, max_len), dtype=torch.int8, device=device),
        v=torch.zeros((n, batch, h, max_len, dh), dtype=torch.int8, device=device),
        length=0,
    )


@dataclasses.dataclass(frozen=True)
class BloomEngineConfig:
    """Static knobs of the BLOOM forward (the JAX fields this port honours;
    the device of the parameters takes the place of ``use_kernel``)."""

    cfg: BloomConfig
    kv_bits: int = 8
    tp_axis: Optional[str] = None

    def __post_init__(self):
        check_family_config(self.kv_bits, self.tp_axis)


def check_family_config(kv_bits: int, tp_axis, family: str = "the BLOOM and MPT engines"
                        ) -> None:
    """The family engines (``family``) keep an INT8 cache and run on one
    card."""
    if kv_bits != 8:
        raise NotImplementedError(f"{family}: an INT8 KV cache only (kv_bits=8), as JAX's")
    if tp_axis is not None:
        raise NotImplementedError("tensor parallelism (tp_axis) is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")


def gelu_tanh(x: Tensor) -> Tensor:
    """jax.nn.gelu(approximate=True), its operations in JAX's order."""
    c = f32(math.sqrt(2 / math.pi), x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


@functools.lru_cache(maxsize=64)
def slopes_on(n_heads: int, device: str) -> Tensor:
    """``alibi_slopes(n_heads)`` on ``device``, made once a device (read
    only)."""
    return alibi_slopes(n_heads, device)


def decode_ctx(q_s8: Tensor, k_cache: Tensor, v_cache: Tensor, lengths, q_scale: Tensor,
               k_scale: Tensor, v_scale: Tensor, slopes: Tensor) -> Tensor:
    """One decode token per slot with ALiBi: q_s8 (B, H, Dh) int8 over the
    slots' valid ``lengths`` (int or (B,)) -> (B, H, Dh) f32.  K3, or K7 past
    DECODE_SHORT_SMAX positions; fp p @ V (this family has no quant_pv)."""
    smax = k_cache.shape[-1]
    if smax > DECODE_SHORT_SMAX:
        return int8_decode_attention_chunked(q_s8, k_cache, v_cache, lengths, q_scale, k_scale,
                                             v_scale, chunk=auto_decode_chunk(smax) or smax,
                                             alibi_slopes=slopes)
    return int8_decode_attention(q_s8, k_cache, v_cache, lengths, q_scale, k_scale, v_scale,
                                 alibi_slopes=slopes)


def alibi_int8_attention(q_s8: Tensor, k_cache: Tensor, v_cache: Tensor, cache_len: int,
                         s: int, q_scale: Tensor, k_scale: Tensor, v_scale: Tensor,
                         slopes: Tensor, mask: Optional[Tensor]) -> Tensor:
    """The ALiBi engines' attention (BLOOM and MPT): s == 1 -> K3 (or K7);
    s > 8 on a cache of a multiple of 128 positions -> K2, the query window
    padded to a multiple of 128 rows; otherwise plain torch ops with the
    additive ``mask`` (S, Smax).  q_s8 (B, H, S, Dh) int8, caches (B, H,
    ...) -> (B, S, H * Dh) f32."""
    b, h, _, dh = q_s8.shape
    smax = k_cache.shape[-1]
    if s == 1:
        return decode_ctx(q_s8[:, :, 0, :].contiguous(), k_cache, v_cache, cache_len + 1,
                          q_scale, k_scale, v_scale, slopes).reshape(b, 1, h * dh)
    if s > 8 and smax % 128 == 0:
        sp = -(-s // 128) * 128
        qp = q_s8 if sp == s else torch.nn.functional.pad(q_s8, (0, 0, 0, sp - s))
        out = int8_prefill_attention(qp.contiguous(), k_cache, v_cache, cache_len + s, q_scale,
                                     k_scale, v_scale, cache_len, alibi_slopes=slopes)
        return out[:, :, :s].transpose(1, 2).reshape(b, s, h * dh)
    scores = short_int_matmul(q_s8, k_cache) * qk_scale(q_scale, k_scale, dh)
    scores = scores + _alibi_bias(slopes, h, 1, smax, q_s8.device)[:, 0] + mask[None, None]
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.matmul(probs, v_cache.to(torch.float32) * v_scale)
    return ctx.transpose(1, 2).reshape(b, s, h * dh)


def causal_mask(start: int, s: int, smax: int, device) -> Optional[Tensor]:
    """(S, Smax) additive mask of a window at ``start`` (None for one token:
    the decode kernels mask by length)."""
    if s == 1:
        return None
    i = start + torch.arange(s, device=device)[:, None]
    j = torch.arange(smax, device=device)[None, :]
    return torch.where(j <= i, f32(0.0, device), f32(NEG, device))


def _bloom_qkv(ecfg: BloomEngineConfig, layer: BloomEngineLayer, x: Tensor):
    """LayerNormQ and the int8-out query_key_value of (B, S, D) activations,
    its interleaved (h, 3, dh) channels split -> q, k, v int8 (B, H, S, Dh)."""
    cfg = ecfg.cfg
    b, s, _ = x.shape
    x_s8 = _layer_norm_q(x, layer.ln1_weight, layer.ln1_bias, cfg.layer_norm_eps)
    qkv = _linear_s8_int8out(layer.qkv_proj, x_s8).reshape(
        b, s, cfg.num_attention_heads, 3, cfg.head_dim)
    return tuple(qkv[:, :, :, i].transpose(1, 2) for i in range(3))


def _bloom_tail(ecfg: BloomEngineConfig, layer: BloomEngineLayer, x: Tensor,
                ctx: Tensor) -> Tensor:
    """The block after attention: requant (clamp -127) -> dense -> residual
    -> LayerNormQ -> dense_h_to_4h -> GELU (tanh) -> requant (clamp -128) ->
    dense_4h_to_h -> residual."""
    cfg = ecfg.cfg
    ctx_s8 = _requant(ctx, layer.dense_input_scale, qmin=-127.0)
    x = x + _linear_s8(layer.dense, ctx_s8)
    x_s8 = _layer_norm_q(x, layer.ln2_weight, layer.ln2_bias, cfg.layer_norm_eps)
    h1 = gelu_tanh(_linear_s8(layer.fc1, x_s8))
    h_s8 = _requant(h1, layer.fc2_input_scale)
    return x + _linear_s8(layer.fc2, h_s8)


def attend_window(qkv, k_cache: Tensor, v_cache: Tensor, cache_len: int, layer,
                  slopes: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Write a window's K/V (``qkv``: q, k, v int8 (B, H, S, Dh)) into the
    caches at [cache_len, cache_len + S) and attend it with
    ``alibi_int8_attention`` -> (B, S, H * Dh) f32."""
    q, k, v = qkv
    write_window(k_cache, k.transpose(2, 3), cache_len, 3)
    write_window(v_cache, v, cache_len, 2)
    return alibi_int8_attention(q.contiguous(), k_cache, v_cache, cache_len, q.shape[2],
                                layer.q_scale, layer.k_scale, layer.v_scale, slopes, mask)


def _bloom_block(ecfg: BloomEngineConfig, layer: BloomEngineLayer, x: Tensor, k_cache: Tensor,
                 v_cache: Tensor, cache_len: int, mask: Optional[Tensor],
                 slopes: Tensor) -> Tensor:
    """One decoder block on (B, S, D) fp32 activations; writes the S new
    tokens' int8 K/V into the caches at [cache_len, cache_len + S)."""
    ctx = attend_window(_bloom_qkv(ecfg, layer, x), k_cache, v_cache, cache_len, layer, slopes,
                        mask)
    return _bloom_tail(ecfg, layer, x, ctx)


def bloom_engine_forward(ecfg: BloomEngineConfig, params: BloomEngineParams, input_ids: Tensor,
                         cache: BloomKVCache, *,
                         window: str = "auto") -> Tuple[Tensor, BloomKVCache]:
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
    x = layer_norm(params.embed_tokens[input_ids.long()], params.emb_ln_weight,
                   params.emb_ln_bias, cfg.layer_norm_eps)
    mask = causal_mask(cache.length, s, smax, dev)
    slopes = slopes_on(cfg.num_attention_heads, str(dev))
    for li, layer in enumerate(params.layer_list):
        x = _bloom_block(ecfg, layer, x, cache.k[li], cache.v[li], cache.length, mask, slopes)
    x = layer_norm(x, params.ln_f_weight, params.ln_f_bias, cfg.layer_norm_eps)
    logits = torch.matmul(x, params.lm_head.to(x.dtype).t())
    return logits, cache._replace(length=cache.length + s)
