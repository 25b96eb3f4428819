"""Real-quant INT8-dataflow LLaMA engine on one NVIDIA GPU.

Port of ``dgq_tpu/models/engine.py``.  Prompt windows run every
linear through K1 (``w4a8_matmul_rp_pipe``) on rowpair storage, K9
(``w4a8_matmul_packed``) on span-only storage, or K10 (``w4a8_fpscale_matmul_packed``) under ``fp_scales``,
and attend with K2 (``int8_prefill_attention``) past 8 tokens; decode steps
attend with K3 (``int8_decode_attention``), or with K7
(``int8_decode_attention_chunked``) once the cache outgrows 8192 positions.
With ``kv_bits=4`` the cache holds INT4 codes packed two per byte along Dh
(``ops/kv4.py``) and every window attends, as JAX's does, with plain
materialised attention over the unpacked cache and fp p @ V (no K2, K3 or
K7; the paged batcher's decode takes K11).
With ``fused_decode`` (the default, as in JAX) decode steps and windows of
at most 8 tokens and 64 rows run each layer's linears through the fused
kernels K4
(``fused_norm_gemv_rp``: RMSNormQ + qkv), K5 (``fused_requant_gemv_rp``:
requant + o_proj + residual) and K6 (``fused_mlp_decode_rp``: the whole
MLP) on rowpair storage, or through K12 (``fused_norm_gemv``,
``fused_requant_gemv``, ``fused_mlp_decode``: the same three) on span-only
storage, with JAX's dispatch rules.  Activations enter the integer domain at
each RMSNormQ, and requantisation happens where the reference puts it:
post-RoPE q/k/v, pre-o_proj and pre-down_proj.

Parameters keep the JAX layout (layers stacked along a leading L axis, q|k|v
and gate|up fused along N, scales 8x row-replicated), so checkpoints and
caches compare directly.  ``lax.scan`` over layers becomes a Python loop.
The KV cache is written in place (JAX returns a new cache from
``dynamic_update_slice``); ``engine_forward`` returns a cache that shares the
input's tensors.  ``KVCache.length`` is a Python int, or a 0-d int tensor on
the device when the caller must not read the host between forwards
(``serving/speculative.spec_decode_scan``); the forward then trusts the
caller to keep the window inside the cache.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from dgq_tpu_torch.models.llama import LlamaConfig, rms_norm, rope_cos_sin, rotate_half
from dgq_tpu_torch.ops.attention import (
    NEG,
    _quantize_exp,
    auto_decode_chunk,
    f32,
    int8_decode_attention,
    int8_decode_attention_chunked,
    int8_prefill_attention,
    qk_scale,
)
from dgq_tpu_torch.ops.fused_decode import (
    fused_mlp_decode,
    fused_mlp_decode_rp,
    fused_norm_gemv,
    fused_norm_gemv_rp,
    fused_requant_gemv,
    fused_requant_gemv_rp,
)
from dgq_tpu_torch.ops.kv4 import kv4_scale, pack_nibbles, quantize_kv4, unpack_nibbles
from dgq_tpu_torch.ops.quant_matmul import (
    int_matmul,
    w4a8_fpscale_matmul_packed,
    w4a8_matmul_packed,
    w4a8_matmul_rp_pipe,
)

Tensor = torch.Tensor


class EngineLinear(NamedTuple):
    """Dual-grained W4A8 linear: the span layout ``qweight`` (K9, K10, K12)
    and/or the rowpair layout ``qw_rp`` (K1, K4-K6), with 8x row-replicated
    ``wscales``/``wzeros``; the compact plane rows feed the fused decode
    kernels (K4-K6, K12), and ``cs_fold`` is checked by K4-K6 but not read.  An
    fp-scale linear (``EngineConfig.fp_scales``) has span storage with fp32
    scales and zeros and no plane rows."""

    qweight: Optional[Tensor]  # (K//2, N) int8 span layout, None when rowpair-only
    wscales: Tensor  # (8G, N) int8 (f32 for fp-scale linears), group g at rows 8g..8g+7
    wzeros: Tensor  # (8G, N) int8 (f32 for fp-scale linears)
    alpha: Tensor  # (N,) f32 = wscales8 * input_scale
    bias: Optional[Tensor]  # (N,) f32 or None
    s_hi: Optional[Tensor] = None  # (G/2, N) int8 even-group scales
    s_lo: Optional[Tensor] = None  # (G/2, N) int8 odd-group scales
    z_hi: Optional[Tensor] = None
    z_lo: Optional[Tensor] = None
    qw_rp: Optional[Tensor] = None  # (K//2, N) int8 rowpair layout
    cs_fold: Optional[Tensor] = None  # (N,) int32


class EngineLayer(NamedTuple):
    """One engine layer (stacked: every tensor has a leading L axis).  q|k|v
    split at [Nq, Nq+Nkv]; gate|up at [F]."""

    ln1_weight: Tensor  # (D,) f32, pre-divided by attn_input_scale
    ln1_bias: Optional[Tensor]
    ln2_weight: Tensor  # (D,) f32, pre-divided by mlp_input_scale
    ln2_bias: Optional[Tensor]
    qkv_proj: EngineLinear
    o_proj: EngineLinear
    gate_up_proj: EngineLinear
    down_proj: EngineLinear
    q_scale: Tensor  # () f32 static post-RoPE scales
    k_scale: Tensor
    v_scale: Tensor
    out_input_scale: Tensor
    down_input_scale: Tensor


def map_tensors(fn, tree):
    """Apply ``fn`` to every tensor of an EngineLayer/EngineLinear tree."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(map_tensors(fn, f) for f in tree))


@dataclasses.dataclass
class EngineParams:
    embed_tokens: Tensor  # (V, D)
    layers: EngineLayer  # stacked
    norm_weight: Tensor  # (D,)
    lm_head: Tensor  # (V, D)
    rms_eps: float = 1e-5

    @functools.cached_property
    def layer_list(self) -> List[EngineLayer]:
        """Per-layer views of the stacked layers, made once."""
        n = self.layers.ln1_weight.shape[0]
        return [map_tensors(lambda t, i=i: t[i], self.layers) for i in range(n)]


class KVCache(NamedTuple):
    k: Tensor  # (L, B, Hkv, Dh, Smax) int8, K stored transposed (Dh/2 packed under kv_bits=4)
    v: Tensor  # (L, B, Hkv, Smax, Dh) int8 (Dh/2 packed under kv_bits=4)
    length: "int | Tensor"  # tokens already cached (a 0-d device tensor inside a device loop)


def check_kv_bits(kv_bits: int) -> None:
    if kv_bits not in (8, 4):
        raise ValueError(f"kv_bits must be 8 or 4, got {kv_bits}")


def kv_head_bytes(cfg: LlamaConfig, kv_bits: int) -> int:
    """Bytes of one cached head vector: Dh, or Dh/2 nibble-packed."""
    check_kv_bits(kv_bits)
    return cfg.head_dim if kv_bits == 8 else cfg.head_dim // 2


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  num_layers: Optional[int] = None, kv_bits: int = 8,
                  device="cuda") -> KVCache:
    n = num_layers or cfg.num_hidden_layers
    hk, dh = cfg.num_key_value_heads, kv_head_bytes(cfg, kv_bits)
    return KVCache(
        k=torch.zeros((n, batch, hk, dh, max_len), dtype=torch.int8, device=device),
        v=torch.zeros((n, batch, hk, max_len, dh), dtype=torch.int8, device=device),
        length=0,
    )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static knobs of the engine forward (the JAX fields this port honours)."""

    cfg: LlamaConfig
    # flash prefill kernel (K2) for windows of more than 8 tokens when Smax %
    # 128 == 0; the query window is padded to a multiple of 128 rows
    flash_prefill: bool = True
    # decode attention: -1 (AUTO) takes the whole-cache kernel K3 up to Smax
    # 8192 and the chunked kernel K7 beyond (auto_decode_chunk); > 0 forces
    # K7 with chunks of that size wherever Smax exceeds it; 0 never chunks
    decode_attn_chunk: int = -1
    # decode launch fusion: windows of at most 8 tokens and 64 rows run K4-K6
    # (norm + qkv, requant + o_proj + residual, the whole MLP) per layer
    fused_decode: bool = True
    # INT8 p @ V on decode windows (ops/attention._quantize_exp)
    quant_pv: bool = True
    # fp-scale engine (w4w8-fallback linears): every linear runs K10 and the
    # fused decode kernels are off
    fp_scales: bool = False
    # KV-cache precision: 8 (INT8) or 4 (symmetric INT4 packed two per byte
    # along Dh, ops/kv4.py: half the cache memory; plain attention, and K11
    # in the paged batcher's decode)
    kv_bits: int = 8

    def __post_init__(self):
        check_kv_bits(self.kv_bits)


def _rms_norm_q(x: Tensor, weight_q: Tensor, eps: float, bias_q=None) -> Tensor:
    """RMSNormQ: fp norm with pre-scaled weight, round -> int8."""
    y = rms_norm(x.to(torch.float32), weight_q, eps)
    if bias_q is not None:
        y = y + bias_q
    return torch.clamp(torch.round(y), -128, 127).to(torch.int8)


def _requant(x: Tensor, scale: Tensor, qmin: float = -128.0) -> Tensor:
    """round(x / scale) (half to even) clamped to int8."""
    return torch.clamp(torch.round(x / scale), qmin, 127.0).to(torch.int8)


def _attention_scores(q_s8, kt_s8, q_scale, k_scale, head_dim):
    """q.k^T in the INT8 domain (exact int32), then one scalar rescale."""
    return int_matmul(q_s8, kt_s8).to(torch.float32) * qk_scale(q_scale, k_scale, head_dim)


def _linear_s8(lin: EngineLinear, x_s8: Tensor, *, fp_scales: bool = False) -> Tensor:
    """int8 activations (..., K) -> fp32 (..., N), dispatched on what the
    linear stores: K1 on the rowpair layout when it exists; else K10 under
    ``fp_scales``; else K9 on the span layout.  The bias rides the kernels'
    epilogue."""
    if (lin.wscales.dtype == torch.float32) != fp_scales:
        raise ValueError(f"{lin.wscales.dtype} group scales with fp_scales={fp_scales}: "
                         "fp32 scales run with EngineConfig(fp_scales=True), int8 without")
    gs = _lin_groupsize(lin)
    x2 = x_s8.reshape(-1, x_s8.shape[-1]).contiguous()
    kw = dict(groupsize=gs, scales_replicated=True)
    if lin.qw_rp is not None and not fp_scales:
        y = w4a8_matmul_rp_pipe(x2, lin.qw_rp, lin.wscales, lin.wzeros, lin.alpha, lin.bias, **kw)
    elif fp_scales:
        y = w4a8_fpscale_matmul_packed(x2, lin.qweight, lin.wscales, lin.wzeros, lin.alpha,
                                       lin.bias, **kw)
    else:
        y = w4a8_matmul_packed(x2, lin.qweight, lin.wscales, lin.wzeros, lin.alpha, lin.bias,
                               **kw)
    return y.reshape(*x_s8.shape[:-1], -1)


def _lin_qw(lin: EngineLinear) -> Tensor:
    """Whichever packed weight exists (span, or rowpair-only) - same shape."""
    return lin.qweight if lin.qweight is not None else lin.qw_rp


def _lin_groupsize(lin: EngineLinear) -> int:
    """Groupsize from the packed layout (K = 2*rows, G = scale rows / 8)."""
    return (2 * _lin_qw(lin).shape[0] * 8) // lin.wscales.shape[0]


def _mlp_bf(span: int, fdim: int) -> int:
    """Intermediate-dim block of JAX's fused MLP kernel (a multiple of span,
    ~512 columns); checked by K6's wrapper as JAX checks it."""
    bf = span * max(1, 512 // span)
    return min(bf, fdim)


def _decode_fusable(layer: EngineLayer) -> bool:
    """Static shape check for the fused decode kernels, as JAX's: False
    falls back to the unfused per-op path."""
    gs = _lin_groupsize(layer.qkv_proj)
    span = 2 * gs
    for lin in (layer.qkv_proj, layer.o_proj, layer.gate_up_proj, layer.down_proj):
        if _lin_groupsize(lin) != gs or lin.s_hi is None:
            return False
        k = 2 * _lin_qw(lin).shape[0]
        n = lin.alpha.shape[-1]
        if k % span != 0 or (n % 512 != 0 and n % 128 != 0 and n >= 512):
            return False
    fdim = 2 * _lin_qw(layer.down_proj).shape[0]
    if layer.gate_up_proj.alpha.shape[-1] != 2 * fdim:
        return False
    bf = _mlp_bf(span, fdim)
    return fdim % bf == 0 and bf % span == 0


def _use_fused_rows(ecfg: EngineConfig, layer: EngineLayer, b: int, s: int) -> bool:
    """Gate for the fused decode kernels: they act on independent rows, so
    windows of s <= 8 tokens (speculative verification) flatten (B, S, D)
    -> (B*S, D) and ride the same kernels as s = 1, up to 64 rows (8 slots x
    8 verify tokens).  JAX's gate without ``use_kernel``: on CPU tensors the
    fused branch runs the kernels' plain versions."""
    return (s <= 8 and not ecfg.fp_scales and ecfg.fused_decode and b * s <= 64
            and _decode_fusable(layer))


def _rowpair_rows(layer: EngineLayer) -> bool:
    """Which fused kernels a layer takes: K4-K6 where it stores the rowpair
    layout, K12 on span-only storage (JAX's ``_use_s4`` without the
    ``int4_mxu`` switch, whose TPU path Hopper has no operand for)."""
    return layer.qkv_proj.qw_rp is not None


def _qkv_rows(ecfg: EngineConfig, layer: EngineLayer, x: Tensor, fused: bool) -> Tensor:
    """(B, S, D) -> qkv projections (B, S, N): K4 on the flattened rows, or
    RMSNormQ + ``_linear_s8``."""
    b, s, d = x.shape
    if fused:
        qp = layer.qkv_proj
        kw = dict(span=2 * _lin_groupsize(qp), eps=ecfg.cfg.rms_norm_eps)
        if _rowpair_rows(layer):
            y = fused_norm_gemv_rp(x.reshape(b * s, d), layer.ln1_weight, layer.ln1_bias,
                                   qp.qw_rp, qp.s_hi, qp.s_lo, qp.z_hi, qp.z_lo, qp.cs_fold,
                                   qp.alpha, qp.bias, **kw)
        else:
            y = fused_norm_gemv(x.reshape(b * s, d), layer.ln1_weight, layer.ln1_bias,
                                qp.qweight, qp.s_hi, qp.s_lo, qp.z_hi, qp.z_lo, qp.alpha,
                                qp.bias, **kw)
        return y.reshape(b, s, -1)
    x_s8 = _rms_norm_q(x, layer.ln1_weight, ecfg.cfg.rms_norm_eps, layer.ln1_bias)
    return _linear_s8(layer.qkv_proj, x_s8, fp_scales=ecfg.fp_scales)


def _block_tail(ecfg: EngineConfig, layer: EngineLayer, x: Tensor, ctx: Tensor,
                fused: bool) -> Tensor:
    """Attention context -> o_proj + residual -> MLP + residual: K5 and K6
    (rowpair) or K12 (span-only) on the flattened rows, or the unfused chain
    around ``_linear_s8``."""
    if fused:
        b, s, d = x.shape
        op, gu, dn = layer.o_proj, layer.gate_up_proj, layer.down_proj
        kw = dict(residual=x.reshape(b * s, d), span=2 * _lin_groupsize(op), qmin=-127.0,
                  fuse_residual=True)
        span_m = 2 * _lin_groupsize(gu)
        kw_m = dict(span=span_m, bf=_mlp_bf(span_m, 2 * _lin_qw(dn).shape[0]),
                    eps=ecfg.cfg.rms_norm_eps, fuse_residual=True)
        # (B*S, D) each, residuals added in the kernels
        if _rowpair_rows(layer):
            x = fused_requant_gemv_rp(ctx.reshape(b * s, -1), layer.out_input_scale, op.qw_rp,
                                      op.s_hi, op.s_lo, op.z_hi, op.z_lo, op.cs_fold, op.alpha,
                                      op.bias, **kw)
            y = fused_mlp_decode_rp(x, layer.ln2_weight, layer.ln2_bias, gu.qw_rp, gu.s_hi,
                                    gu.s_lo, gu.z_hi, gu.z_lo, gu.cs_fold, gu.alpha,
                                    layer.down_input_scale, dn.qw_rp, dn.wscales, dn.wzeros,
                                    dn.cs_fold, dn.alpha, dn.bias, **kw_m)
        else:
            x = fused_requant_gemv(ctx.reshape(b * s, -1), layer.out_input_scale, op.qweight,
                                   op.s_hi, op.s_lo, op.z_hi, op.z_lo, op.alpha, op.bias, **kw)
            y = fused_mlp_decode(x, layer.ln2_weight, layer.ln2_bias, gu.qweight, gu.s_hi,
                                 gu.s_lo, gu.z_hi, gu.z_lo, gu.alpha, layer.down_input_scale,
                                 dn.qweight, dn.wscales, dn.wzeros, dn.alpha, dn.bias, **kw_m)
        return y.reshape(b, s, d)
    kw = dict(fp_scales=ecfg.fp_scales)
    ctx_s8 = _requant(ctx, layer.out_input_scale, qmin=-127.0)
    x = x + _linear_s8(layer.o_proj, ctx_s8, **kw)
    x_s8 = _rms_norm_q(x, layer.ln2_weight, ecfg.cfg.rms_norm_eps, layer.ln2_bias)
    gate, up = torch.chunk(_linear_s8(layer.gate_up_proj, x_s8, **kw), 2, dim=-1)
    h_s8 = _requant(torch.nn.functional.silu(gate) * up, layer.down_input_scale)
    return x + _linear_s8(layer.down_proj, h_s8, **kw)


def write_window(cache: Tensor, new: Tensor, start, dim: int) -> None:
    """Write ``new`` into ``cache`` along ``dim`` at [start, start + S).
    ``start`` is an int, or a 0-d device tensor (no host read), which is
    clamped to the cache as JAX's dynamic_update_slice clamps it."""
    s = new.shape[dim]
    if isinstance(start, torch.Tensor):
        first = torch.clamp(start.long(), max=cache.shape[dim] - s)
        cache.index_copy_(dim, first + torch.arange(s, device=cache.device), new)
    else:
        cache.narrow(dim, start, s).copy_(new)


def _kv4_attention(layer: EngineLayer, q_s8: Tensor, k_cache: Tensor, v_cache: Tensor,
                   mask: Tensor, hk: int) -> Tensor:
    """Plain attention of (B, H, S, Dh) int8 queries over nibble-packed
    caches (unpacked whole, as JAX's kv4 branch): int32 scores with the
    effective int4 scales, additive ``mask`` (S, Smax), softmax and fp p @ V
    -> (B, S, H * Dh) f32."""
    b, h, s, dh = q_s8.shape
    k_all = unpack_nibbles(k_cache, axis=2)  # (B, Hkv, Dh, Smax)
    v_all = unpack_nibbles(v_cache, axis=-1)  # (B, Hkv, Smax, Dh)
    scores = _attention_scores(q_s8.reshape(b, hk, (h // hk) * s, dh), k_all, layer.q_scale,
                               kv4_scale(layer.k_scale), dh)
    scores = scores.reshape(b, hk, h // hk, s, -1) + mask[None, None, None]
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.matmul(probs, (v_all.to(torch.float32) * kv4_scale(layer.v_scale))[:, :, None])
    return ctx.permute(0, 3, 1, 2, 4).reshape(b, s, h * dh)


def _block(ecfg: EngineConfig, layer: EngineLayer, x: Tensor, k_cache: Tensor,
           v_cache: Tensor, cache_len, pos_cos: Tensor, pos_sin: Tensor, mask: Tensor,
           decode_window: bool = False) -> Tensor:
    """One decoder block on (B, S, D) fp32 activations; writes the S new
    tokens' int8 K/V (int4 nibbles under kv_bits=4) into the caches at
    [cache_len, cache_len + S) (``cache_len`` an int or a 0-d device
    tensor)."""
    cfg = ecfg.cfg
    b, s, _ = x.shape
    dh = cfg.head_dim
    hk = cfg.num_key_value_heads
    h = cfg.num_attention_heads
    rep = h // hk

    fused = _use_fused_rows(ecfg, layer, b, s)
    qkv = _qkv_rows(ecfg, layer, x, fused)
    q, k, v = torch.split(qkv, [h * dh, hk * dh, hk * dh], dim=-1)
    q = q.reshape(b, s, h, dh).transpose(1, 2)
    k = k.reshape(b, s, hk, dh).transpose(1, 2)
    v = v.reshape(b, s, hk, dh).transpose(1, 2)
    cos, sin = pos_cos[None, None], pos_sin[None, None]
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin

    q_s8 = _requant(q, layer.q_scale).contiguous()
    if ecfg.kv_bits == 4:
        # INT4 KV: quantise to [-7, 7], pack along Dh, write, then plain
        # attention over the unpacked cache for every window (JAX's branch)
        write_window(k_cache, pack_nibbles(quantize_kv4(k, layer.k_scale)).transpose(2, 3),
                     cache_len, 3)
        write_window(v_cache, pack_nibbles(quantize_kv4(v, layer.v_scale)), cache_len, 2)
        ctx = _kv4_attention(layer, q_s8, k_cache, v_cache, mask, hk)
        return _block_tail(ecfg, layer, x, ctx, fused)
    write_window(k_cache, _requant(k, layer.k_scale).transpose(2, 3), cache_len, 3)
    write_window(v_cache, _requant(v, layer.v_scale), cache_len, 2)
    smax = k_cache.shape[-1]

    if s == 1:
        chunk = ecfg.decode_attn_chunk
        if chunk < 0:  # AUTO: the chunked kernel once Smax outgrows 8k
            chunk = auto_decode_chunk(smax)
        if chunk and smax > chunk:
            ctx = int8_decode_attention_chunked(
                q_s8[:, :, 0, :], k_cache, v_cache, cache_len + 1,
                layer.q_scale, layer.k_scale, layer.v_scale, chunk=chunk,
                quant_pv=ecfg.quant_pv,
            )
        else:
            ctx = int8_decode_attention(
                q_s8[:, :, 0, :], k_cache, v_cache, cache_len + 1,
                layer.q_scale, layer.k_scale, layer.v_scale, quant_pv=ecfg.quant_pv,
            )
        ctx = ctx.reshape(b, 1, h * dh)
    elif (ecfg.flash_prefill and s > 8 and not (ecfg.quant_pv and decode_window)
          and smax % 128 == 0):
        # the query window is padded to 128 rows; pad rows attend to valid
        # keys only and are sliced off
        sp = -(-s // 128) * 128
        qp = torch.nn.functional.pad(q_s8, (0, 0, 0, sp - s)).contiguous()
        start = int(cache_len)  # K2 takes its window on the host
        ctx = int8_prefill_attention(
            qp, k_cache, v_cache, start + s, layer.q_scale, layer.k_scale,
            layer.v_scale, start,
        )
        ctx = ctx[:, :, :s].transpose(1, 2).reshape(b, s, h * dh)
    else:
        # plain materialised attention, as JAX runs outside its kernels
        qg = q_s8.reshape(b, hk, rep * s, dh)
        scores = _attention_scores(qg, k_cache, layer.q_scale, layer.k_scale, dh)
        scores = scores.reshape(b, hk, rep, s, smax) + mask[None, None, None]
        if ecfg.quant_pv and (s == 1 or decode_window):
            m = torch.amax(scores, dim=-1, keepdim=True)
            e = torch.exp(scores - m)
            denom = torch.sum(e, dim=-1, keepdim=True)
            acc = int_matmul(_quantize_exp(e), v_cache[:, :, None])
            ctx = acc.to(torch.float32) * ((layer.v_scale / f32(127.0, x.device)) / denom)
        else:
            probs = torch.softmax(scores, dim=-1)
            ctx = torch.matmul(probs, (v_cache.to(torch.float32) * layer.v_scale)[:, :, None])
        ctx = ctx.permute(0, 3, 1, 2, 4).reshape(b, s, h * dh)

    return _block_tail(ecfg, layer, x, ctx, fused)


def engine_forward(ecfg: EngineConfig, params: EngineParams, input_ids: Tensor,
                   cache: KVCache, *, window: str = "auto") -> Tuple[Tensor, KVCache]:
    """Prefill or decode step: runs S tokens starting at cache.length.

    Returns (logits (B, S, V) f32, cache advanced by S).  ``window`` declares
    the S > 1 window kind: "prefill" (fp p @ V whatever quant_pv says),
    "decode" (a speculative-verification window; quant_pv applies), or
    "auto" (S == 1 -> decode, S > 1 -> prefill).  Runs on the device of the
    parameters."""
    cfg = ecfg.cfg
    dev = params.embed_tokens.device
    input_ids = input_ids.to(dev)
    b, s = input_ids.shape
    smax = cache.k.shape[4]
    if not isinstance(cache.length, torch.Tensor) and cache.length + s > smax:
        raise ValueError(f"cache overflow: {cache.length} + {s} > {smax}")
    decode_window = window == "decode" or (window == "auto" and s == 1)
    x = params.embed_tokens[input_ids].to(torch.float32)

    positions = cache.length + torch.arange(s, device=dev)
    pos_cos, pos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    j = torch.arange(smax, device=dev)[None, :]
    mask = torch.where(j <= positions[:, None], f32(0.0, dev), f32(NEG, dev))

    for li, layer in enumerate(params.layer_list):
        x = _block(ecfg, layer, x, cache.k[li], cache.v[li], cache.length, pos_cos, pos_sin,
                   mask, decode_window=decode_window)

    x = rms_norm(x, params.norm_weight.to(x.dtype), cfg.rms_norm_eps)
    logits = torch.matmul(x, params.lm_head.to(x.dtype).t())
    return logits, cache._replace(length=cache.length + s)


def engine_decode_multi(ecfg: EngineConfig, params: EngineParams, tok: Tensor,
                        cache: KVCache, n: int):
    """``n`` greedy decode steps.  Returns (tokens (B, n), next_tok (B, 1),
    cache)."""
    toks = []
    for _ in range(n):
        logits, cache = engine_forward(ecfg, params, tok, cache)
        tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1), tok, cache


def generate(ecfg: EngineConfig, params: EngineParams, prompt_ids: Tensor,
             max_new_tokens: int, max_len: int, sampling=None,
             generator: Optional[torch.Generator] = None, decode_unroll: int = 1) -> Tensor:
    """Prefill + decode loop -> (B, max_new_tokens) int32 tokens; greedy by
    default, or sampled with SamplingParams from ``generator``.
    ``decode_unroll`` > 1 runs greedy steps through engine_decode_multi."""
    from dgq_tpu_torch.serving.sampling import SamplingParams, sample_logits

    sampling = sampling or SamplingParams()
    dev = params.embed_tokens.device
    b, _ = prompt_ids.shape
    cache = init_kv_cache(ecfg.cfg, b, max_len, kv_bits=ecfg.kv_bits, device=dev)
    logits, cache = engine_forward(ecfg, params, prompt_ids, cache)
    next_tok = sample_logits(logits[:, -1, :], sampling, generator)
    toks = [next_tok]
    remaining = max_new_tokens - 1
    if sampling.greedy and decode_unroll > 1:
        cols = [next_tok[:, None]]
        tok = next_tok[:, None]
        while remaining > 0:
            n = min(decode_unroll, remaining)
            chunk, tok, cache = engine_decode_multi(ecfg, params, tok, cache, n)
            cols.append(chunk)
            remaining -= n
        return torch.cat(cols, dim=1)
    for _ in range(remaining):
        logits, cache = engine_forward(ecfg, params, next_tok[:, None], cache)
        next_tok = sample_logits(logits[:, -1, :], sampling, generator)
        toks.append(next_tok)
    return torch.stack(toks, dim=1)
