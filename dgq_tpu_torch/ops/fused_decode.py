"""Fused decode kernels K4-K6 (rowpair weights) and K12 (span weights) with
their plain versions, K13's names, and the rowpair layout conversion helpers.

Port of ``dgq_tpu/ops/fused_decode.py``: the conversion helpers (:154-229),
``plane_colsums`` (:304), ``_rmsnorm_q`` (:340-344) and, under the JAX
names, the wrappers of the hand-written CUDA kernels that replace the TPU
kernels ``fused_norm_gemv_rp`` (K4, ``csrc/fused_norm_gemv_rp.cu``),
``fused_requant_gemv_rp`` (K5, ``csrc/fused_requant_gemv_rp.cu``),
``fused_mlp_decode_rp`` (K6, ``csrc/fused_mlp_decode_rp.cu``: two legs, the
gate|up product with its SiLU codes and the down product; all three on the
TMA + wgmma loop of ``csrc/fused_gemv_sm90.cuh``, tiled by ``fused_plan``
and, for K6's legs, ``mlp_plan``) and ``fused_norm_gemv``,
``fused_requant_gemv`` (K12's norm and requant entries,
``csrc/fused_gemv_span_sm90.cu``: K4's and K5's loop on span bytes, tiled by
``fused_plan`` with ``layout="span"``; ``span_stage_map`` is its order of
k), ``fused_mlp_decode`` (K12's MLP entry, ``csrc/fused_decode_span.cu``).
Each plain version (``*_xla``) makes
its int8 codes, takes the exact int32 product with the weights dequantised
to int8 (``(c4 - (z - 8)) * s`` rowpair, ``(c - z) * s`` span) and applies
the fp32 epilogue; CPU tensors take it, CUDA tensors launch the kernel.

``cs_fold`` is accepted and shape-checked but never read: the TPU kernels
split x into two s4 halves for the int4 MXU operand and add the folded
column-sum term back; the int32 accumulator is the same without the split,
which is how both the plain versions and the CUDA kernels compute it.  For
the same reason K13 (``fused_norm_gemv_s4``, ``fused_requant_gemv_s4``: K12's
first two functions with both operands split to s4 for the v5e int4 MXU,
bit-identical by construction) runs K12's kernel and counts under K12:
Hopper's tensor cores take no int4 operand, and ``plane_colsums``, the s4
path's pack-time constant, is checked but not read.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence

import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.quant.packing import unpack_nibbles

Tensor = torch.Tensor

NORM, REQUANT, MLP = "fused_norm_gemv_rp", "fused_requant_gemv_rp", "fused_mlp_decode_rp"
NORM_SPAN, REQUANT_SPAN, MLP_SPAN = "fused_norm_gemv", "fused_requant_gemv", "fused_mlp_decode"
_VP, _INT, _F32 = _cuda.VP, _cuda.INT, _cuda.F32
# K4 and K12's norm entry: x, lnw, lnb, eps, qw, s_hi, s_lo, z_hi, z_lo,
# alpha, beta, out, codes_out, M, N, K, gs, the plan (bm, splits, sps,
# cluster), the int32 partials of a K split and the stream
_NORM_ARGS = [_VP] * 3 + [_F32] + [_VP] * 9 + [_INT] * 8 + [_VP] * 2
# K5 and K12's requant entry: x, in_scale, qmin, qw, s_hi, s_lo, z_hi, z_lo,
# alpha, beta, residual, out, codes_out, then as the norm's from M
_REQUANT_ARGS = [_VP] * 2 + [_F32] + [_VP] * 10 + [_INT] * 8 + [_VP] * 2
# x, lnw, lnb, eps, down_scale, gu_qw, gu_s_hi, gu_s_lo, gu_z_hi, gu_z_lo,
# gu_alpha, d_qw, d_ws, d_wz, d_alpha, d_beta, fuse_residual, acc, out,
# xq_out, h_out, M, D, F, gs, sms, stream (K12's MLP)
_MLP_ARGS = [_VP] * 3 + [_F32] + [_VP] * 12 + [_INT] + [_VP] * 4 + [_INT] * 5 + [_VP]
# K6: as K12's MLP up to fuse_residual, then out, xq_out, h_out, M, D, F, gs
# and each leg's plan (bm, splits, sps, cluster) with its int32 scratch, and
# the stream
_MLP_RP_ARGS = ([_VP] * 3 + [_F32] + [_VP] * 12 + [_INT] + [_VP] * 3 + [_INT] * 4
                + ([_INT] * 4 + [_VP]) * 2 + [_VP])
# the C entry points of each source (a library's argtypes are set when it loads)
_SIGNATURES = {
    "fused_norm_gemv_rp": {NORM: _NORM_ARGS},
    "fused_requant_gemv_rp": {REQUANT: _REQUANT_ARGS},
    "fused_mlp_decode_rp": {MLP: _MLP_RP_ARGS},
    "fused_gemv_span_sm90": {NORM_SPAN: _NORM_ARGS, REQUANT_SPAN: _REQUANT_ARGS},
    "fused_decode_span": {MLP_SPAN: _MLP_ARGS},
}


def _lib(name: str):
    """The loaded library of kernel ``name``, its entry points typed."""
    stem = _cuda.SOURCES[name]
    return _cuda.library(stem, _SIGNATURES[stem])


def _stacked(a: torch.Tensor, trailing: int) -> torch.Tensor:
    return a.reshape((-1,) + tuple(a.shape[-trailing:]))


def pack_rowpair_s4(qweight_span: torch.Tensor, span: int) -> torch.Tensor:
    """Repack span-packed nibbles into the ROWPAIR-SHIFTED layout: byte r
    packs the zero-shifted codes ``(c - 8) & 0xF`` of logical rows 2r (LOW
    nibble) and 2r+1 (HIGH nibble).  Accepts stacked (..., K//2, N)."""
    lead = qweight_span.shape[:-2]
    outs = []
    for q in _stacked(qweight_span, 2):
        c4 = (unpack_nibbles(q, span).to(torch.int32) - 8) & 0xF
        byte = (c4[1::2] << 4) | c4[0::2]
        outs.append(byte.to(torch.uint8).view(torch.int8))
    out = torch.stack(outs)
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


def _scale_rows(sh: torch.Tensor, sl: torch.Tensor, g: int, n: int) -> torch.Tensor:
    s_g = torch.zeros((g, n), dtype=torch.int32, device=sh.device)
    s_g[0::2] = sh.to(torch.int32)
    s_g[1::2] = sl.to(torch.int32)
    return s_g


def rowpair_cs_fold(qweight_span: torch.Tensor, span: int,
                    s_hi: torch.Tensor, s_lo: torch.Tensor) -> torch.Tensor:
    """(..., N) int32 ``8 * sum_g s_g * colsum_g(c - 8)`` from span codes;
    s_hi/s_lo are the compact per-plane scale rows (even/odd groups)."""
    lead = qweight_span.shape[:-2]
    gs = span // 2
    outs = []
    for q, sh, sl in zip(_stacked(qweight_span, 2), _stacked(s_hi, 2), _stacked(s_lo, 2)):
        c4 = unpack_nibbles(q, span).to(torch.int32) - 8
        k, n = c4.shape
        cs = c4.reshape(k // gs, gs, n).sum(dim=1)
        outs.append(8 * torch.sum(cs * _scale_rows(sh, sl, cs.shape[0], n), dim=0,
                                     dtype=torch.int32))
    out = torch.stack(outs)
    return out.reshape(tuple(lead) + tuple(out.shape[-1:]))


def rowpair_cs_fold_rp(qw_rp: torch.Tensor, groupsize: int,
                       s_hi: torch.Tensor, s_lo: torch.Tensor) -> torch.Tensor:
    """rowpair_cs_fold computed from the rowpair layout itself."""
    from dgq_tpu_torch.ops.quant_matmul import unpack_rowpair_s4

    lead = qw_rp.shape[:-2]
    outs = []
    for q, sh, sl in zip(_stacked(qw_rp, 2), _stacked(s_hi, 2), _stacked(s_lo, 2)):
        c4 = unpack_rowpair_s4(q).to(torch.int32)
        k, n = c4.shape
        cs = c4.reshape(k // groupsize, groupsize, n).sum(dim=1)
        outs.append(8 * torch.sum(cs * _scale_rows(sh, sl, cs.shape[0], n), dim=0,
                                     dtype=torch.int32))
    out = torch.stack(outs)
    return out.reshape(tuple(lead) + tuple(out.shape[-1:]))


# --------------------------------------------------------------------------
# code makers (the kernels' prologues) and plain versions
# --------------------------------------------------------------------------

def _rmsnorm_q(x: Tensor, w: Tensor, b: Optional[Tensor], eps: float) -> Tensor:
    """RMSNormQ on (M, K) f32 rows -> int8: ``x * rsqrt(mean(x*x) + eps) * w
    + b``, rounded half to even and clipped to [-128, 127].  Bit for bit the
    engine's ``_rms_norm_q``: the two fp32 products commute, and the absent
    bias (JAX adds zeros) is skipped."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * w
    if b is not None:
        y = y + b
    return torch.clamp(torch.round(y), -128, 127).to(torch.int8)


def _requant_q(x: Tensor, scale: Tensor, qmin: float) -> Tensor:
    """round(x / scale) half to even (a division, as JAX writes it) clipped
    to [qmin, 127] -> int8."""
    return torch.clamp(torch.round(x / scale), qmin, 127.0).to(torch.int8)


def _silu_mul_q(g32: Tensor, u32: Tensor, alpha_g: Tensor, alpha_u: Tensor,
                scale: Tensor) -> Tensor:
    """K6's down-proj input codes from the int32 gate/up accumulators, in
    JAX's order: g = g32 * alpha_g, u = u32 * alpha_u, h = (g * sigmoid(g))
    * u, then round(h / scale) clipped to [-128, 127]."""
    g = g32.to(torch.float32) * alpha_g
    u = u32.to(torch.float32) * alpha_u
    h = (g * torch.sigmoid(g)) * u
    return torch.clamp(torch.round(h / scale), -128.0, 127.0).to(torch.int8)


def _planes(s_hi: Tensor, s_lo: Tensor) -> Tensor:
    """Compact (G, N) rows from the even-group and odd-group plane rows."""
    g2, n = s_hi.shape
    return torch.stack([s_hi, s_lo], dim=1).reshape(2 * g2, n)


def _plane_product(x_s8: Tensor, qw_rp: Tensor, s_hi: Tensor, s_lo: Tensor, z_hi: Tensor,
                   z_lo: Tensor, gs: int) -> Tensor:
    from dgq_tpu_torch.ops.quant_matmul import dequantize_rowpair, int_matmul

    return int_matmul(x_s8, dequantize_rowpair(qw_rp, _planes(s_hi, s_lo), _planes(z_hi, z_lo),
                                               gs))


def _epilogue(acc: Tensor, alpha: Tensor, beta: Optional[Tensor],
              residual: Optional[Tensor]) -> Tensor:
    y = acc.to(torch.float32) * alpha
    if beta is not None:
        y = y + beta
    if residual is not None:
        y = y + residual
    return y


def _hand_out(dst: Optional[Tensor], codes: Tensor) -> None:
    if dst is not None:
        dst.copy_(codes)


def _check_shapes(x: Tensor, qw_rp: Tensor, s_hi: Tensor, cs_fold: Tensor, span: int):
    m, k = x.shape
    k2, n = qw_rp.shape
    gs = span // 2
    if 2 * k2 != k or k % gs or gs % 32:
        raise ValueError(f"shapes: x {tuple(x.shape)}, qw_rp {tuple(qw_rp.shape)}, span {span}")
    if tuple(s_hi.shape) != (k // gs // 2, n):
        raise ValueError(f"plane rows {tuple(s_hi.shape)} != {(k // gs // 2, n)}")
    if tuple(cs_fold.shape) != (n,):
        raise ValueError(f"cs_fold {tuple(cs_fold.shape)} != {(n,)}")
    if not 1 <= m <= 64:
        raise ValueError(f"the fused decode kernels take 1 to 64 rows, got {m}")
    return m, k, n, gs


def fused_norm_gemv_rp_xla(x, ln_w, ln_b, qw_rp, s_hi, s_lo, z_hi, z_lo, cs_fold, alpha,
                           beta=None, *, span: int = 256, eps: float = 1e-6,
                           codes: Optional[Tensor] = None,
                           codes_out: Optional[Tensor] = None) -> Tensor:
    """Plain K4: ``(RMSNormQ(x) @ dequant(W)) * alpha + beta``.  ``codes``
    (M, K) int8 replaces the RMSNormQ codes; ``codes_out`` receives them."""
    gs = span // 2
    xq = _rmsnorm_q(x, ln_w, ln_b, eps) if codes is None else codes
    _hand_out(codes_out, xq)
    return _epilogue(_plane_product(xq, qw_rp, s_hi, s_lo, z_hi, z_lo, gs), alpha, beta, None)


def fused_requant_gemv_rp_xla(x, in_scale, qw_rp, s_hi, s_lo, z_hi, z_lo, cs_fold, alpha,
                              beta=None, residual=None, *, span: int = 256,
                              qmin: float = -127.0, fuse_residual: bool = True,
                              codes: Optional[Tensor] = None,
                              codes_out: Optional[Tensor] = None) -> Tensor:
    """Plain K5: ``(requant(x) @ dequant(W)) * alpha + beta (+ residual)``.
    ``codes`` (M, K) int8 replaces the requant codes; ``codes_out`` receives
    them."""
    gs = span // 2
    xq = _requant_q(x, in_scale, qmin) if codes is None else codes
    _hand_out(codes_out, xq)
    acc = _plane_product(xq, qw_rp, s_hi, s_lo, z_hi, z_lo, gs)
    return _epilogue(acc, alpha, beta, residual if fuse_residual else None)


def fused_mlp_decode_rp_xla(x, ln_w, ln_b, gu_qw_rp, gu_s_hi, gu_s_lo, gu_z_hi, gu_z_lo,
                            gu_cs_fold, gu_alpha, down_scale, d_qw_rp, d_wscales, d_wzeros,
                            d_cs_fold, d_alpha, d_beta=None, *, span: int = 256,
                            eps: float = 1e-6, fuse_residual: bool = True,
                            codes: Optional[Sequence[Tensor]] = None,
                            codes_out: Optional[Sequence[Tensor]] = None) -> Tensor:
    """Plain K6: RMSNormQ -> gate|up product -> SiLU(gate) * up -> requant
    -> down product -> ``acc * d_alpha + d_beta (+ x)``.  ``codes`` = (xq
    (M, D), h (M, F)) int8 replaces the norm and the down-input codes;
    ``codes_out`` (the same pair) receives them."""
    from dgq_tpu_torch.ops.quant_matmul import dequantize_rowpair, int_matmul

    gs = span // 2
    fdim = 2 * d_qw_rp.shape[0]
    xq = _rmsnorm_q(x, ln_w, ln_b, eps) if codes is None else codes[0]
    gu = _plane_product(xq, gu_qw_rp, gu_s_hi, gu_s_lo, gu_z_hi, gu_z_lo, gs)
    h_s8 = _silu_mul_q(gu[:, :fdim], gu[:, fdim:], gu_alpha[:fdim], gu_alpha[fdim:],
                       down_scale)
    if codes is not None:
        h_s8 = codes[1]
    if codes_out is not None:
        _hand_out(codes_out[0], xq)
        _hand_out(codes_out[1], h_s8)
    acc = int_matmul(h_s8, dequantize_rowpair(d_qw_rp, d_wscales[::8], d_wzeros[::8], gs))
    return _epilogue(acc, d_alpha, d_beta, x if fuse_residual else None)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _require_planes(dev, k: int, n: int, gs: int, planes, cs_fold, alpha, beta, align=4):
    for name, t in zip(("s_hi", "s_lo", "z_hi", "z_lo"), planes):
        _cuda.require(t, name, torch.int8, (k // gs // 2, n), dev, align=align)
    _cuda.require(alpha, "alpha", torch.float32, (n,), dev, align=4)
    if beta is not None:
        _cuda.require(beta, "beta", torch.float32, (n,), dev, align=4)
    if cs_fold is not None and cs_fold.device != dev:
        raise ValueError(f"cs_fold: expected a tensor on {dev}, got {cs_fold.device}")
    if n % 32 or k % 128:
        raise ValueError(f"the fused decode kernels need N % 32 == 0 and K % 128 == 0; "
                         f"got N={n}, K={k}")


def _require_scalar(t: Tensor, name: str, dev) -> None:
    _cuda.require(t, name, torch.float32, None, dev, align=4)
    if t.numel() != 1:
        raise ValueError(f"{name}: expected one float32 value, got shape {tuple(t.shape)}")


# K4, K5 and K12's norm and requant entries run on the main loop of the W4A8
# GEMMs (csrc/fused_gemv_sm90.cuh): a block owns FUSED_BN weight columns and
# one tile of bm token rows, streams its K range in stages of FUSED_STAGE_K
# logical k (64 packed rows) through a ring of FUSED_RING stages and keeps
# the codes of its K range in shared memory.
FUSED_TILES = (8, 16, 32, 48, 64)  # token-row tiles (wgmma N)
FUSED_BN, FUSED_STAGE_K, FUSED_RING = 128, 128, 4
FUSED_STAGE_BYTES = 64 * 128 + 8 * 128  # packed weight rows; four 32-k steps' scale and zero rows
SMEM_LIMIT = 232448  # dynamic shared memory a block may take
SMEM_PER_SM = 233472  # an SM's, of which each block's share takes 1 KB more
FUSED_CLUSTERS = (1, 2, 4, 8)  # column tiles that share their codes (8: the portable limit)
FUSED_SPLITS = (1, 2, 4, 8, 16)
# the split choice's costs, in stages of one block, fitted to the times of
# every candidate plan (python -m dgq_tpu_torch.scripts.fused_plan_sweep): a block's
# start and finish; a batch of K4's row loads (U = 16 float4 a lane) and of
# code-making loads (4 a thread); each block a cluster adds; the kernel that
# sums the splits
_FILL, _NORM_BATCH, _CODE_BATCH, _CLUSTER_BLOCK, _COMBINE = 6, 2, 2, 1, 3
LAYOUTS = ("rowpair", "span")  # the packed bytes: K4 and K5's, K12's


class FusedPlan(NamedTuple):
    """How K4, K5 or K12's norm or requant entry runs an (M, N, K) call:
    ``bm`` token rows (one tile for all M rows) by ``bn`` weight columns a
    block; clusters of ``cluster`` column tiles, which share their codes; K
    in ``stages`` stages of ``stage_k``, split into ``splits`` ranges of
    ``sps`` whole stages (the last may be shorter), whose int32 partials a
    second kernel sums; ``smem`` bytes of dynamic shared memory a block,
    ``per_sm`` blocks an SM."""
    bm: int
    bn: int
    cluster: int
    stage_k: int
    stages: int
    splits: int
    sps: int
    smem: int
    per_sm: int

    def grid(self, n: int):
        """The launch grid: column tiles (a whole number of clusters), K splits."""
        tiles = -(-n // self.bn)
        return -(-tiles // self.cluster) * self.cluster, self.splits


def fused_smem(bm: int, sps: int) -> int:
    """A K4/K5/K12 block's dynamic shared memory: the codes of its K range,
    the ring, its barriers, K4's row scales and 1 KB of alignment slack
    (``fused_smem`` in csrc/fused_gemv_sm90.cuh)."""
    return (bm * FUSED_STAGE_K * sps + FUSED_RING * FUSED_STAGE_BYTES + 16 * FUSED_RING + 256
            + 1024)


def _prologue(m: int, k: int, cluster: int, sps: int, norm: bool) -> float:
    """What a block does before its first product, in stages: K4's sums of
    squares of its own rows (a warp a row; fewer rows, fewer bytes from L2)
    and the codes of those rows over its K range."""
    rows = -(-m // cluster)
    cost = _NORM_BATCH * rows / 8 * -(-k // 2048) if norm else 0.0
    return cost + _CODE_BATCH * -(-rows * sps * FUSED_STAGE_K // 4 // 1024)


def split_unit(groupsize: int, layout: str = "rowpair") -> int:
    """The stages a K split's length is a multiple of: 1 for rowpair bytes;
    for span bytes the fewest stages (64 packed rows each) that hold whole
    spans (``groupsize`` packed rows), since a stage's two nibble planes lie
    ``groupsize`` apart in K and a block makes the codes of its own K range
    only."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is none of {LAYOUTS}")
    return 1 if layout == "rowpair" else groupsize // math.gcd(groupsize, 64)


def span_stage_map(st: int, groupsize: int) -> dict:
    """K12's order of k in stage ``st`` of span bytes (64 packed rows, 128
    logical k), as ``FusedSpan`` in csrc/fused_gemv_sm90.cuh computes it:
    ``{(kk, h): (k, group, plane_row)}`` for the 32-row step kk (packed rows
    p = 64 st + 32 kk .. + 31, of span t = p // groupsize) and the nibble
    half h (0 high, 1 low): the first of its 32 consecutive logical k, their
    group and that group's row in the compact planes (``s_hi``/``z_hi`` for
    h = 0, ``s_lo``/``z_lo`` for h = 1)."""
    out = {}
    for kk in (0, 1):
        p = 64 * st + 32 * kk
        t = p // groupsize
        for h in (0, 1):
            out[(kk, h)] = (p + (t + h) * groupsize, 2 * t + h, t)
    return out


def fused_candidates(m: int, n: int, k: int, groupsize: int, layout: str = "rowpair") -> list:
    """Every plan K4 and K5 (``layout="rowpair"``) or K12's norm and requant
    entries (``"span"``) can run an (m, n, k) call with at this group size:
    the smallest of FUSED_TILES that holds all m rows, under each cluster of
    FUSED_CLUSTERS and K split of FUSED_SPLITS whose shared memory fits, its
    length rounded up to ``split_unit`` stages (splits that give the same
    stages once), in that order."""
    unit = split_unit(groupsize, layout)
    if not 1 <= m <= FUSED_TILES[-1]:
        raise ValueError(f"the fused decode kernels take 1 to {FUSED_TILES[-1]} rows, got {m}")
    if n % 32 or k % FUSED_STAGE_K or groupsize % 32 or k % (2 * groupsize):
        raise ValueError(f"K4/K5/K12 need N % 32 == 0, K % 128 == 0 and a groupsize % 32 == 0 "
                         f"that divides K / 2; got N={n}, K={k}, groupsize={groupsize}")
    bm = next(t for t in FUSED_TILES if t >= m)
    stages = k // FUSED_STAGE_K
    plans = []
    for cx in FUSED_CLUSTERS:
        for s in FUSED_SPLITS:
            sps = -(-stages // s)
            sps = -(-sps // unit) * unit
            smem = fused_smem(bm, sps)
            if smem > SMEM_LIMIT:
                continue
            per_sm = 2 if 2 * (smem + 1024) <= SMEM_PER_SM else 1
            plan = FusedPlan(bm, FUSED_BN, cx, FUSED_STAGE_K, stages, -(-stages // sps), sps,
                             smem, per_sm)
            if plan not in plans:
                plans.append(plan)
    if not plans:
        raise ValueError(f"K4/K5/K12: no K split of K={k} fits {m} rows in shared memory")
    return plans


def _plan_cost(plan: FusedPlan, m: int, n: int, k: int, sms: int, norm: bool) -> float:
    """The stages of the busiest SM, wave by wave (``per_sm`` blocks share
    an SM), plus each wave's start, finish and prologue, plus the cluster's
    and the sum of the splits' costs."""
    tiles, splits = plan.grid(n)
    blocks, cost = tiles * splits, 0.0
    while blocks > 0:
        wave = min(blocks, sms * plan.per_sm)
        cost += -(-wave // sms) * plan.sps + _FILL + _prologue(m, k, plan.cluster, plan.sps, norm)
        blocks -= wave
    return cost + _CLUSTER_BLOCK * (plan.cluster - 1) + (_COMBINE if splits > 1 else 0.0)


@functools.lru_cache(maxsize=4096)
def fused_plan(m: int, n: int, k: int, groupsize: int, sms: int, norm: bool = True,
               layout: str = "rowpair") -> FusedPlan:
    """The tile, cluster and K split of K4 (``norm``) or K5, or on span
    bytes (``layout="span"``) of K12's norm or requant entry, for an (m, n,
    k) call with this group size on a card with ``sms`` SMs: of
    ``fused_candidates``, the first of least ``_plan_cost`` (one cost model:
    both layouts stream the same bytes a stage)."""
    return min(fused_candidates(m, n, k, groupsize, layout),
               key=lambda p: _plan_cost(p, m, n, k, sms, norm))


def mlp_plan(m: int, d: int, f: int, groupsize: int, sms: int):
    """The plans of K6's two legs for an (m, D, F) MLP on a card with
    ``sms`` SMs: the gate|up leg is K4's product, (m, 2F, D) with the
    RMSNormQ codes; the down leg K5's, (m, D, F) with codes it copies.  Each
    leg's block reads 128 columns of its weights a stage, so
    ``fused_plan``'s tiles, clusters, splits and costs hold for both."""
    return (fused_plan(m, 2 * f, d, groupsize, sms, True),
            fused_plan(m, d, f, groupsize, sms, False))


def _split_scratch(plan: FusedPlan, m: int, n: int, dev) -> Optional[Tensor]:
    """The (splits, m, n) int32 partials of a K split, or None."""
    return (torch.empty((plan.splits, m, n), dtype=torch.int32, device=dev)
            if plan.splits > 1 else None)


def launch_gemv(name: str, plan: FusedPlan, args_head, m: int, n: int, k: int, gs: int,
                dev) -> None:
    """Launch K4, K5 or K12's norm or requant entry (``name``) with
    ``plan``: the C entry point's arguments up to ``codes_out``
    (``args_head``), then the shapes, the plan and the int32 scratch of a K
    split."""
    part = _split_scratch(plan, m, n, dev)
    rc = getattr(_lib(name), name)(*args_head, m, n, k, gs, plan.bm, plan.splits, plan.sps,
                                   plan.cluster, _cuda.ptr(part), _cuda.stream(dev))
    _cuda.check(rc, name)


def launch_mlp_rp(plans, args_head, m: int, d: int, f: int, gs: int, dev) -> None:
    """Launch K6 with its legs' ``plans`` (gate|up, down): the C entry
    point's arguments up to ``h_out`` (``args_head``), then the shapes and
    each leg's plan with the int32 scratch of its K split."""
    gate_up, down = plans
    part_gu = _split_scratch(gate_up, m, 2 * f, dev)
    part_d = _split_scratch(down, m, d, dev)
    rc = _lib(MLP).fused_mlp_decode_rp(
        *args_head, m, d, f, gs, gate_up.bm, gate_up.splits, gate_up.sps, gate_up.cluster,
        _cuda.ptr(part_gu), down.bm, down.splits, down.sps, down.cluster, _cuda.ptr(part_d),
        _cuda.stream(dev))
    _cuda.check(rc, MLP)


def fused_norm_gemv_rp(x: Tensor, ln_w: Tensor, ln_b: Optional[Tensor], qw_rp: Tensor,
                       s_hi: Tensor, s_lo: Tensor, z_hi: Tensor, z_lo: Tensor,
                       cs_fold: Tensor, alpha: Tensor, beta: Optional[Tensor] = None, *,
                       span: int = 256, bn: int = 512, eps: float = 1e-6,
                       codes_out: Optional[Tensor] = None) -> Tensor:
    """K4: y = (RMSNormQ(x) @ dequant(W)) * alpha + beta in one call.

    x (M, K) f32 with 1 <= M <= 64; qw_rp (K//2, N) rowpair bytes; s_*/z_*
    the compact (G//2, N) even/odd group plane rows (G = K / (span // 2));
    ``cs_fold`` (N,) is checked and not read (see the module docstring);
    ``bn`` is the TPU column block and is not used: the CUDA kernel gives a
    block 128 columns (the last one padded inside the kernel when N % 128),
    all M rows in one tile of 8-64 token rows and a K range split by
    ``fused_plan``.  ``codes_out`` (M, K) int8, when given, receives the
    RMSNormQ codes.  CPU tensors take the plain version; on the card the
    call is one launch of the kernel and, when K is split, one of the kernel
    that sums the splits."""
    m, k, n, gs = _check_shapes(x, qw_rp, s_hi, cs_fold, span)
    if x.device.type == "cpu":
        return fused_norm_gemv_rp_xla(x, ln_w, ln_b, qw_rp, s_hi, s_lo, z_hi, z_lo, cs_fold,
                                      alpha, beta, span=span, eps=eps, codes_out=codes_out)
    dev = x.device
    _cuda.require(x, "x", torch.float32, (m, k), dev)
    _cuda.require(ln_w, "ln_w", torch.float32, (k,), dev)
    if ln_b is not None:
        _cuda.require(ln_b, "ln_b", torch.float32, (k,), dev)
    _cuda.require(qw_rp, "qw_rp", torch.int8, (k // 2, n), dev)
    _require_planes(dev, k, n, gs, (s_hi, s_lo, z_hi, z_lo), cs_fold, alpha, beta, align=16)
    if codes_out is not None:
        _cuda.require(codes_out, "codes_out", torch.int8, (m, k), dev, align=4)
    plan = fused_plan(m, n, k, gs, _sms(dev), True)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    launch_gemv(NORM, plan, (
        _cuda.ptr(x), _cuda.ptr(ln_w), _cuda.ptr(ln_b), float(eps), _cuda.ptr(qw_rp),
        _cuda.ptr(s_hi), _cuda.ptr(s_lo), _cuda.ptr(z_hi), _cuda.ptr(z_lo), _cuda.ptr(alpha),
        _cuda.ptr(beta), _cuda.ptr(out), _cuda.ptr(codes_out)), m, n, k, gs, dev)
    _cuda.count_launch(NORM)
    return out


def fused_requant_gemv_rp(x: Tensor, in_scale: Tensor, qw_rp: Tensor, s_hi: Tensor,
                          s_lo: Tensor, z_hi: Tensor, z_lo: Tensor, cs_fold: Tensor,
                          alpha: Tensor, beta: Optional[Tensor] = None,
                          residual: Optional[Tensor] = None, *, span: int = 256,
                          bn: int = 512, qmin: float = -127.0, fuse_residual: bool = True,
                          codes_out: Optional[Tensor] = None) -> Tensor:
    """K5: y = (requant(x) @ dequant(W)) * alpha + beta (+ residual) in one
    call; requant is round(x / in_scale) clipped to [qmin, 127].

    ``in_scale`` is a one-element float32 tensor read by the kernel on the
    device (no host sync).  Other arguments, the tiling and the launches as
    K4's; ``residual`` (M, N) f32 is added when ``fuse_residual``.  CPU
    tensors take the plain version."""
    m, k, n, gs = _check_shapes(x, qw_rp, s_hi, cs_fold, span)
    if fuse_residual and residual is None:
        raise ValueError("fuse_residual needs a residual")
    if x.device.type == "cpu":
        return fused_requant_gemv_rp_xla(x, in_scale, qw_rp, s_hi, s_lo, z_hi, z_lo, cs_fold,
                                         alpha, beta, residual, span=span, qmin=qmin,
                                         fuse_residual=fuse_residual, codes_out=codes_out)
    dev = x.device
    _cuda.require(x, "x", torch.float32, (m, k), dev)
    _require_scalar(in_scale, "in_scale", dev)
    _cuda.require(qw_rp, "qw_rp", torch.int8, (k // 2, n), dev)
    _require_planes(dev, k, n, gs, (s_hi, s_lo, z_hi, z_lo), cs_fold, alpha, beta, align=16)
    res = residual if fuse_residual else None
    if res is not None:
        _cuda.require(res, "residual", torch.float32, (m, n), dev, align=4)
    if codes_out is not None:
        _cuda.require(codes_out, "codes_out", torch.int8, (m, k), dev, align=4)
    plan = fused_plan(m, n, k, gs, _sms(dev), False)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    launch_gemv(REQUANT, plan, (
        _cuda.ptr(x), _cuda.ptr(in_scale), float(qmin), _cuda.ptr(qw_rp), _cuda.ptr(s_hi),
        _cuda.ptr(s_lo), _cuda.ptr(z_hi), _cuda.ptr(z_lo), _cuda.ptr(alpha), _cuda.ptr(beta),
        _cuda.ptr(res), _cuda.ptr(out), _cuda.ptr(codes_out)), m, n, k, gs, dev)
    _cuda.count_launch(REQUANT)
    return out


def fused_mlp_decode_rp(x: Tensor, ln_w: Tensor, ln_b: Optional[Tensor], gu_qw_rp: Tensor,
                        gu_s_hi: Tensor, gu_s_lo: Tensor, gu_z_hi: Tensor, gu_z_lo: Tensor,
                        gu_cs_fold: Tensor, gu_alpha: Tensor, down_scale: Tensor,
                        d_qw_rp: Tensor, d_wscales: Tensor, d_wzeros: Tensor,
                        d_cs_fold: Tensor, d_alpha: Tensor, d_beta: Optional[Tensor] = None,
                        *, span: int = 256, bf: int = 512, eps: float = 1e-6,
                        fuse_residual: bool = True,
                        codes_out: Optional[Sequence[Tensor]] = None) -> Tensor:
    """K6: the whole LLaMA MLP of a decode step in one call: RMSNormQ, the
    gate|up product, SiLU(gate) * up, requant by ``down_scale`` (a device
    scalar), the down product and ``acc * d_alpha + d_beta (+ x)``.

    gu_qw_rp (D//2, 2F) rowpair [gate | up] with compact plane rows;
    d_qw_rp (F//2, D) with its scales and zeros 8x row-replicated (8*Gf, D),
    as the engine stores them (the kernel reads row 8g of group g).  The
    cs_folds are checked and not read; ``bf`` is the TPU's F block, checked
    as JAX checks it: the CUDA kernel's gate|up blocks take 64 columns of F
    and its down blocks 128 rows of Wd a stage, and the exact int32 result
    does not depend on the block.  ``codes_out`` = (xq (M, D), h (M, F))
    int8 tensors, when given, receive the codes.  On the card the call is
    one K6 launch: its two legs (gate|up with the SiLU codes, then down),
    each followed by the kernel that sums its K splits where ``mlp_plan``
    splits K."""
    m, d, n2f, gs = _check_shapes(x, gu_qw_rp, gu_s_hi, gu_cs_fold, span)
    f2, dout = d_qw_rp.shape
    fdim = 2 * f2
    bf = min(bf, fdim)
    if n2f != 2 * fdim or dout != d or fdim % bf or bf % gs:
        raise ValueError(f"shapes: gate_up {tuple(gu_qw_rp.shape)}, down "
                         f"{tuple(d_qw_rp.shape)}, bf {bf}, groupsize {gs}")
    if tuple(d_wscales.shape) != (8 * fdim // gs, d) or tuple(d_cs_fold.shape) != (d,):
        raise ValueError(f"down scales {tuple(d_wscales.shape)} or cs_fold "
                         f"{tuple(d_cs_fold.shape)} do not fit F={fdim}, D={d}")
    if x.device.type == "cpu":
        return fused_mlp_decode_rp_xla(x, ln_w, ln_b, gu_qw_rp, gu_s_hi, gu_s_lo, gu_z_hi,
                                       gu_z_lo, gu_cs_fold, gu_alpha, down_scale, d_qw_rp,
                                       d_wscales, d_wzeros, d_cs_fold, d_alpha, d_beta,
                                       span=span, eps=eps, fuse_residual=fuse_residual,
                                       codes_out=codes_out)
    dev = x.device
    _cuda.require(x, "x", torch.float32, (m, d), dev)
    _cuda.require(ln_w, "ln_w", torch.float32, (d,), dev)
    if ln_b is not None:
        _cuda.require(ln_b, "ln_b", torch.float32, (d,), dev)
    _require_scalar(down_scale, "down_scale", dev)
    _cuda.require(gu_qw_rp, "gu_qw_rp", torch.int8, (d // 2, n2f), dev)
    _require_planes(dev, d, n2f, gs, (gu_s_hi, gu_s_lo, gu_z_hi, gu_z_lo), gu_cs_fold,
                    gu_alpha, None, align=16)
    _cuda.require(d_qw_rp, "d_qw_rp", torch.int8, (f2, d), dev)
    _cuda.require(d_wscales, "d_wscales", torch.int8, (8 * fdim // gs, d), dev)
    _cuda.require(d_wzeros, "d_wzeros", torch.int8, (8 * fdim // gs, d), dev)
    _require_planes(dev, fdim, d, gs, (), d_cs_fold, d_alpha, d_beta)
    # the two legs' K (D and F) and N (2F and D) as K4's and K5's
    plans = mlp_plan(m, d, fdim, gs, _sms(dev))
    xq_out = h_out = None
    if codes_out is not None:
        xq_out, h_out = codes_out
        _cuda.require(xq_out, "codes_out[0]", torch.int8, (m, d), dev, align=4)
        _cuda.require(h_out, "codes_out[1]", torch.int8, (m, fdim), dev, align=4)
    if h_out is None:  # the down leg's input
        h_out = torch.empty((m, fdim), dtype=torch.int8, device=dev)
    out = torch.empty((m, d), dtype=torch.float32, device=dev)
    launch_mlp_rp(plans, (
        _cuda.ptr(x), _cuda.ptr(ln_w), _cuda.ptr(ln_b), float(eps), _cuda.ptr(down_scale),
        _cuda.ptr(gu_qw_rp), _cuda.ptr(gu_s_hi), _cuda.ptr(gu_s_lo), _cuda.ptr(gu_z_hi),
        _cuda.ptr(gu_z_lo), _cuda.ptr(gu_alpha), _cuda.ptr(d_qw_rp), _cuda.ptr(d_wscales),
        _cuda.ptr(d_wzeros), _cuda.ptr(d_alpha), _cuda.ptr(d_beta), int(fuse_residual),
        _cuda.ptr(out), _cuda.ptr(xq_out), _cuda.ptr(h_out)), m, d, fdim, gs, dev)
    _cuda.count_launch(MLP)
    return out


# --------------------------------------------------------------------------
# K12: the same three functions on span-layout weights, and K13's names
# --------------------------------------------------------------------------

def _span_product(x_s8: Tensor, qweight: Tensor, s_hi: Tensor, s_lo: Tensor, z_hi: Tensor,
                  z_lo: Tensor, gs: int) -> Tensor:
    from dgq_tpu_torch.ops.quant_matmul import dequantize_span, int_matmul

    return int_matmul(x_s8, dequantize_span(qweight, _planes(s_hi, s_lo), _planes(z_hi, z_lo),
                                            gs))


def _check_span_shapes(x: Tensor, qweight: Tensor, s_hi: Tensor, span: int):
    m, k = x.shape
    k2, n = qweight.shape
    gs = span // 2
    if 2 * k2 != k or k % span or gs % 32:
        raise ValueError(f"shapes: x {tuple(x.shape)}, qweight {tuple(qweight.shape)}, "
                         f"span {span}")
    if tuple(s_hi.shape) != (k // span, n):
        raise ValueError(f"plane rows {tuple(s_hi.shape)} != {(k // span, n)}")
    if not 1 <= m <= 64:
        raise ValueError(f"the fused decode kernels take 1 to 64 rows, got {m}")
    return m, k, n, gs


def fused_norm_gemv_xla(x, ln_w, ln_b, qweight, s_hi, s_lo, z_hi, z_lo, alpha, beta=None, *,
                        span: int = 256, eps: float = 1e-6, codes: Optional[Tensor] = None,
                        codes_out: Optional[Tensor] = None) -> Tensor:
    """Plain K12 norm: ``(RMSNormQ(x) @ dequant(W)) * alpha + beta`` on span
    weights.  ``codes`` (M, K) int8 replaces the RMSNormQ codes;
    ``codes_out`` receives them."""
    xq = _rmsnorm_q(x, ln_w, ln_b, eps) if codes is None else codes
    _hand_out(codes_out, xq)
    acc = _span_product(xq, qweight, s_hi, s_lo, z_hi, z_lo, span // 2)
    return _epilogue(acc, alpha, beta, None)


def fused_requant_gemv_xla(x, in_scale, qweight, s_hi, s_lo, z_hi, z_lo, alpha, beta=None,
                           residual=None, *, span: int = 256, qmin: float = -127.0,
                           fuse_residual: bool = True, codes: Optional[Tensor] = None,
                           codes_out: Optional[Tensor] = None) -> Tensor:
    """Plain K12 requant: ``(requant(x) @ dequant(W)) * alpha + beta (+
    residual)`` on span weights; ``codes`` and ``codes_out`` as the norm's."""
    xq = _requant_q(x, in_scale, qmin) if codes is None else codes
    _hand_out(codes_out, xq)
    acc = _span_product(xq, qweight, s_hi, s_lo, z_hi, z_lo, span // 2)
    return _epilogue(acc, alpha, beta, residual if fuse_residual else None)


def fused_mlp_decode_xla(x, ln_w, ln_b, gu_qweight, gu_s_hi, gu_s_lo, gu_z_hi, gu_z_lo,
                         gu_alpha, down_scale, d_qweight, d_wscales, d_wzeros, d_alpha,
                         d_beta=None, *, span: int = 256, eps: float = 1e-6,
                         fuse_residual: bool = True,
                         codes: Optional[Sequence[Tensor]] = None,
                         codes_out: Optional[Sequence[Tensor]] = None) -> Tensor:
    """Plain K12 MLP: K6's chain on span weights.  ``codes`` = (xq (M, D), h
    (M, F)) int8 replaces the norm and the down-input codes; ``codes_out``
    (the same pair) receives them."""
    from dgq_tpu_torch.ops.quant_matmul import dequantize_span, int_matmul

    gs = span // 2
    fdim = 2 * d_qweight.shape[0]
    xq = _rmsnorm_q(x, ln_w, ln_b, eps) if codes is None else codes[0]
    gu = _span_product(xq, gu_qweight, gu_s_hi, gu_s_lo, gu_z_hi, gu_z_lo, gs)
    h_s8 = _silu_mul_q(gu[:, :fdim], gu[:, fdim:], gu_alpha[:fdim], gu_alpha[fdim:],
                       down_scale)
    if codes is not None:
        h_s8 = codes[1]
    if codes_out is not None:
        _hand_out(codes_out[0], xq)
        _hand_out(codes_out[1], h_s8)
    acc = int_matmul(h_s8, dequantize_span(d_qweight, d_wscales[::8], d_wzeros[::8], gs))
    return _epilogue(acc, d_alpha, d_beta, x if fuse_residual else None)


def fused_norm_gemv(x: Tensor, ln_w: Tensor, ln_b: Optional[Tensor], qweight: Tensor,
                    s_hi: Tensor, s_lo: Tensor, z_hi: Tensor, z_lo: Tensor, alpha: Tensor,
                    beta: Optional[Tensor] = None, *, span: int = 256, bn: int = 512,
                    eps: float = 1e-6, codes_out: Optional[Tensor] = None) -> Tensor:
    """K12: y = (RMSNormQ(x) @ dequant(W)) * alpha + beta in one call, on
    span weights.

    x (M, K) f32 with 1 <= M <= 64; qweight (K//2, N) span bytes (span = 2 *
    groupsize); s_*/z_* the compact (K // span, N) even/odd group plane rows;
    ``bn`` is the TPU column block and is not used: the CUDA kernel is K4's
    on span bytes, tiled by ``fused_plan(..., layout="span")``.
    ``codes_out`` (M, K) int8, when given, receives the RMSNormQ codes.  CPU
    tensors take the plain version; on the card the call is one launch of
    the kernel and, when K is split, one of the kernel that sums the
    splits."""
    m, k, n, gs = _check_span_shapes(x, qweight, s_hi, span)
    if x.device.type == "cpu":
        return fused_norm_gemv_xla(x, ln_w, ln_b, qweight, s_hi, s_lo, z_hi, z_lo, alpha, beta,
                                   span=span, eps=eps, codes_out=codes_out)
    dev = x.device
    _cuda.require(x, "x", torch.float32, (m, k), dev)
    _cuda.require(ln_w, "ln_w", torch.float32, (k,), dev)
    if ln_b is not None:
        _cuda.require(ln_b, "ln_b", torch.float32, (k,), dev)
    _cuda.require(qweight, "qweight", torch.int8, (k // 2, n), dev)
    _require_planes(dev, k, n, gs, (s_hi, s_lo, z_hi, z_lo), None, alpha, beta, align=16)
    if codes_out is not None:
        _cuda.require(codes_out, "codes_out", torch.int8, (m, k), dev, align=4)
    plan = fused_plan(m, n, k, gs, _sms(dev), True, "span")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    launch_gemv(NORM_SPAN, plan, (
        _cuda.ptr(x), _cuda.ptr(ln_w), _cuda.ptr(ln_b), float(eps), _cuda.ptr(qweight),
        _cuda.ptr(s_hi), _cuda.ptr(s_lo), _cuda.ptr(z_hi), _cuda.ptr(z_lo), _cuda.ptr(alpha),
        _cuda.ptr(beta), _cuda.ptr(out), _cuda.ptr(codes_out)), m, n, k, gs, dev)
    _cuda.count_launch(NORM_SPAN)
    return out


def fused_requant_gemv(x: Tensor, in_scale: Tensor, qweight: Tensor, s_hi: Tensor,
                       s_lo: Tensor, z_hi: Tensor, z_lo: Tensor, alpha: Tensor,
                       beta: Optional[Tensor] = None, residual: Optional[Tensor] = None, *,
                       span: int = 256, bn: int = 512, qmin: float = -127.0,
                       fuse_residual: bool = True,
                       codes_out: Optional[Tensor] = None) -> Tensor:
    """K12: y = (requant(x) @ dequant(W)) * alpha + beta (+ residual) in one
    call, on span weights; ``in_scale`` a one-element float32 tensor read on
    the device.  Other arguments, the tiling and the launches as
    ``fused_norm_gemv``'s (the kernel is K5's on span bytes).  CPU tensors
    take the plain version."""
    m, k, n, gs = _check_span_shapes(x, qweight, s_hi, span)
    if fuse_residual and residual is None:
        raise ValueError("fuse_residual needs a residual")
    if x.device.type == "cpu":
        return fused_requant_gemv_xla(x, in_scale, qweight, s_hi, s_lo, z_hi, z_lo, alpha, beta,
                                      residual, span=span, qmin=qmin,
                                      fuse_residual=fuse_residual, codes_out=codes_out)
    dev = x.device
    _cuda.require(x, "x", torch.float32, (m, k), dev)
    _require_scalar(in_scale, "in_scale", dev)
    _cuda.require(qweight, "qweight", torch.int8, (k // 2, n), dev)
    _require_planes(dev, k, n, gs, (s_hi, s_lo, z_hi, z_lo), None, alpha, beta, align=16)
    res = residual if fuse_residual else None
    if res is not None:
        _cuda.require(res, "residual", torch.float32, (m, n), dev, align=4)
    if codes_out is not None:
        _cuda.require(codes_out, "codes_out", torch.int8, (m, k), dev, align=4)
    plan = fused_plan(m, n, k, gs, _sms(dev), False, "span")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    launch_gemv(REQUANT_SPAN, plan, (
        _cuda.ptr(x), _cuda.ptr(in_scale), float(qmin), _cuda.ptr(qweight), _cuda.ptr(s_hi),
        _cuda.ptr(s_lo), _cuda.ptr(z_hi), _cuda.ptr(z_lo), _cuda.ptr(alpha), _cuda.ptr(beta),
        _cuda.ptr(res), _cuda.ptr(out), _cuda.ptr(codes_out)), m, n, k, gs, dev)
    _cuda.count_launch(REQUANT_SPAN)
    return out


def fused_mlp_decode(x: Tensor, ln_w: Tensor, ln_b: Optional[Tensor], gu_qweight: Tensor,
                     gu_s_hi: Tensor, gu_s_lo: Tensor, gu_z_hi: Tensor, gu_z_lo: Tensor,
                     gu_alpha: Tensor, down_scale: Tensor, d_qweight: Tensor,
                     d_wscales: Tensor, d_wzeros: Tensor, d_alpha: Tensor,
                     d_beta: Optional[Tensor] = None, *, span: int = 256, bf: int = 512,
                     eps: float = 1e-6, fuse_residual: bool = True,
                     codes_out: Optional[Sequence[Tensor]] = None) -> Tensor:
    """K12: the whole LLaMA MLP of a decode step in one call on span weights
    (K6's chain).  gu_qweight (D//2, 2F) span [gate | up] with compact plane
    rows; d_qweight (F//2, D) with 8x row-replicated (8*Gf, D) scales and
    zeros (the kernel reads row 8g of group g).  ``bf`` is the TPU's F block,
    checked as JAX checks it; the CUDA kernel's blocks take 32 F columns of an
    even group and the 32 beside them in the odd group.  ``codes_out`` = (xq
    (M, D), h (M, F)) int8, when given, receive the codes.  The call is one
    launch (a zero fill and a small epilogue kernel run inside it)."""
    m, d, n2f, gs = _check_span_shapes(x, gu_qweight, gu_s_hi, span)
    f2, dout = d_qweight.shape
    fdim = 2 * f2
    bf = min(bf, fdim)
    if n2f != 2 * fdim or dout != d or fdim % bf or bf % span:
        raise ValueError(f"shapes: gate_up {tuple(gu_qweight.shape)}, down "
                         f"{tuple(d_qweight.shape)}, bf {bf}, span {span}")
    if tuple(d_wscales.shape) != (8 * fdim // gs, d):
        raise ValueError(f"down scales {tuple(d_wscales.shape)} do not fit F={fdim}, D={d}")
    if x.device.type == "cpu":
        return fused_mlp_decode_xla(x, ln_w, ln_b, gu_qweight, gu_s_hi, gu_s_lo, gu_z_hi,
                                    gu_z_lo, gu_alpha, down_scale, d_qweight, d_wscales,
                                    d_wzeros, d_alpha, d_beta, span=span, eps=eps,
                                    fuse_residual=fuse_residual, codes_out=codes_out)
    dev = x.device
    _cuda.require(x, "x", torch.float32, (m, d), dev)
    _cuda.require(ln_w, "ln_w", torch.float32, (d,), dev)
    if ln_b is not None:
        _cuda.require(ln_b, "ln_b", torch.float32, (d,), dev)
    _require_scalar(down_scale, "down_scale", dev)
    _cuda.require(gu_qweight, "gu_qweight", torch.int8, (d // 2, n2f), dev, align=4)
    _require_planes(dev, d, n2f, gs, (gu_s_hi, gu_s_lo, gu_z_hi, gu_z_lo), None, gu_alpha,
                    None)
    _cuda.require(d_qweight, "d_qweight", torch.int8, (f2, d), dev, align=4)
    _cuda.require(d_wscales, "d_wscales", torch.int8, (8 * fdim // gs, d), dev, align=4)
    _cuda.require(d_wzeros, "d_wzeros", torch.int8, (8 * fdim // gs, d), dev, align=4)
    _require_planes(dev, fdim, d, gs, (), None, d_alpha, d_beta)
    xq_out = h_out = None
    if codes_out is not None:
        xq_out, h_out = codes_out
        _cuda.require(xq_out, "codes_out[0]", torch.int8, (m, d), dev, align=4)
        _cuda.require(h_out, "codes_out[1]", torch.int8, (m, fdim), dev, align=4)
    acc = torch.empty((m, d), dtype=torch.int32, device=dev)
    out = torch.empty((m, d), dtype=torch.float32, device=dev)
    rc = _lib(MLP_SPAN).fused_mlp_decode(
        _cuda.ptr(x), _cuda.ptr(ln_w), _cuda.ptr(ln_b), float(eps), _cuda.ptr(down_scale),
        _cuda.ptr(gu_qweight), _cuda.ptr(gu_s_hi), _cuda.ptr(gu_s_lo), _cuda.ptr(gu_z_hi),
        _cuda.ptr(gu_z_lo), _cuda.ptr(gu_alpha), _cuda.ptr(d_qweight), _cuda.ptr(d_wscales),
        _cuda.ptr(d_wzeros), _cuda.ptr(d_alpha), _cuda.ptr(d_beta), int(fuse_residual),
        _cuda.ptr(acc), _cuda.ptr(out), _cuda.ptr(xq_out), _cuda.ptr(h_out), m, d, fdim, gs,
        _sms(dev), _cuda.stream(dev))
    _cuda.check(rc, MLP_SPAN)
    _cuda.count_launch(MLP_SPAN)
    return out


def plane_colsums(qweight: Tensor, span: int = 256):
    """Per-plane column sums of the zero-shifted codes (c - 8), int32: the
    pack-time constant of K13's s4 path.  qweight (K//2, N) span bytes ->
    (csum_hi, csum_lo), each (K // span, N)."""
    k2, n = qweight.shape
    u = qweight.view(torch.uint8).to(torch.int32).reshape(2 * k2 // span, span // 2, n)
    return (((u >> 4) - 8).sum(dim=1, dtype=torch.int32),
            ((u & 0xF) - 8).sum(dim=1, dtype=torch.int32))


def _check_colsums(qweight: Tensor, span: int, csum_hi, csum_lo) -> None:
    want = (2 * qweight.shape[0] // span, qweight.shape[1])
    for name, c in (("csum_hi", csum_hi), ("csum_lo", csum_lo)):
        if c is not None and tuple(c.shape) != want:
            raise ValueError(f"{name} {tuple(c.shape)} != {want}")


def fused_norm_gemv_s4(x: Tensor, ln_w: Tensor, ln_b: Optional[Tensor], qweight: Tensor,
                       s_hi: Tensor, s_lo: Tensor, z_hi: Tensor, z_lo: Tensor, alpha: Tensor,
                       beta: Optional[Tensor] = None, csum_hi: Optional[Tensor] = None,
                       csum_lo: Optional[Tensor] = None, *, span: int = 256, bn: int = 512,
                       eps: float = 1e-6, codes_out: Optional[Tensor] = None) -> Tensor:
    """K13: ``fused_norm_gemv`` computed on the TPU's int4 MXU path, the same
    result bit for bit; runs K12 (see the module docstring).  ``csum_hi`` and
    ``csum_lo`` (``plane_colsums``) are checked and not read."""
    _check_colsums(qweight, span, csum_hi, csum_lo)
    return fused_norm_gemv(x, ln_w, ln_b, qweight, s_hi, s_lo, z_hi, z_lo, alpha, beta,
                           span=span, bn=bn, eps=eps, codes_out=codes_out)


def fused_requant_gemv_s4(x: Tensor, in_scale: Tensor, qweight: Tensor, s_hi: Tensor,
                          s_lo: Tensor, z_hi: Tensor, z_lo: Tensor, alpha: Tensor,
                          beta: Optional[Tensor] = None, residual: Optional[Tensor] = None,
                          csum_hi: Optional[Tensor] = None, csum_lo: Optional[Tensor] = None,
                          *, span: int = 256, bn: int = 512, qmin: float = -127.0,
                          fuse_residual: bool = True,
                          codes_out: Optional[Tensor] = None) -> Tensor:
    """K13: ``fused_requant_gemv`` on the TPU's int4 MXU path; runs K12 as
    ``fused_norm_gemv_s4`` does."""
    _check_colsums(qweight, span, csum_hi, csum_lo)
    return fused_requant_gemv(x, in_scale, qweight, s_hi, s_lo, z_hi, z_lo, alpha, beta,
                              residual, span=span, bn=bn, qmin=qmin,
                              fuse_residual=fuse_residual, codes_out=codes_out)
