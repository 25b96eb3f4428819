"""W4A8 GEMMs: K1 (rowpair layout), K9 and K14 (span layout, int8 group
scales) and K10 (span layout, fp32 group scales), with their plain versions.

Port of ``dgq_tpu/ops/quant_matmul.py``: ``unpack_rowpair_s4`` (:684-691),
the plain ``w4a8_matmul_rp_xla`` (:694-722), and under the JAX names the
wrappers of the hand-written CUDA kernels that replace the TPU kernels:
``w4a8_matmul_rp_pipe`` (K1, ``csrc/w4a8_rp_gemm.cu``);
``w4a8_matmul_packed`` (K9) and ``w4a8_fpscale_matmul_packed`` (K10), both
``csrc/w4a8_span_gemm.cu``.  ``w4a8_matmul_wres`` and ``w4a8_matmul_pipe``
(K14) compute K9's function with other TPU tilings (dequantise once per
weight block, dequantise one block ahead); on Hopper both are tiling choices
inside one kernel, so they launch K9's kernel and count under K9.

K1, K9 and K10 share one main loop (``csrc/w4a8_gemm_sm90.cuh``: a TMA ring
and wgmma with the weights as register fragments; K10 keeps one int32
accumulator set per nibble plane and flushes them into fp32 per span).
``gemm_plan`` chooses K1's and K9's tile and K split, ``fpscale_plan``
K10's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.quant.packing import unpack_nibbles

KERNEL = "w4a8_matmul_rp_pipe"
SPAN = "w4a8_matmul_packed"  # K9 (and K14's names)
FPSCALE = "w4a8_fpscale_matmul_packed"  # K10
# x, qw, scales, zeros, srep, M, N, K, gs, tile, splits, sps, alpha, beta, out, part, stream
_SIGNATURES = {"w4a8_rp_gemm": [_cuda.VP] * 4 + [_cuda.INT] * 8 + [_cuda.VP] * 5}
_SPAN_SIGNATURES = {
    # as K1's, then out_s8 before the stream
    "w4a8_span_gemm": [_cuda.VP] * 4 + [_cuda.INT] * 8 + [_cuda.VP] * 4 + [_cuda.INT, _cuda.VP],
    # x, qw, scales, zeros, srep, M, N, K, gs, tile, p_split, alpha, beta, out, part, stream
    "w4a8_fpscale_gemm": [_cuda.VP] * 4 + [_cuda.INT] * 7 + [_cuda.VP] * 5,
}

PREFILL_TILE, DECODE_TILE = 0, 1  # the main loop's tiles: 256 or 16 token rows
PREFILL_ROWS, DECODE_ROWS = 256, 16  # DECODE_ROWS: M at or below which the decode tile runs
TILE_N = 128  # weight columns a block owns
MAX_SPLITS = 16
_FILL_STAGES = 6  # a block's start and finish, in stages, for the split choice


class GemmPlan(NamedTuple):
    """How K1 or K9 runs an (M, N, K) call: ``tile`` (``PREFILL_TILE`` or
    ``DECODE_TILE``) of ``bm`` x ``bn`` outputs; K in ``stages`` stages of
    ``stage_k`` logical k, split into ``splits`` ranges of ``sps`` whole
    stages (the last may be shorter), summed exactly in int32."""
    tile: int
    bm: int
    bn: int
    stage_k: int
    stages: int
    splits: int
    sps: int

    def grid(self, m: int, n: int):
        """The launch grid: row tiles, column tiles, K splits."""
        return -(-m // self.bm), -(-n // self.bn), self.splits


@functools.lru_cache(maxsize=4096)
def gemm_plan(m: int, n: int, k: int, groupsize: int, layout: str, sms: int) -> GemmPlan:
    """The tile and K split of K1 (``layout="rowpair"``) or K9 (``"span"``)
    for an (m, n, k) call with this group size on a card with ``sms`` SMs.

    Up to DECODE_ROWS rows take the decode tile (16 token rows), more the
    prefill tile (256); both hold 128 weight columns.  A stage is 128
    logical k (64 packed rows), or 64 for span weights whose groupsize is not
    a multiple of 64, so that a stage lies inside one span.  The split is the
    one that minimises waves x (stages per split + a block's start and
    finish), which spreads the weight stream of a decode step over the card;
    the prefill tile is not split once its tiles fill the SMs, where the
    int32 partials would cost as much as they save."""
    if layout not in ("rowpair", "span"):
        raise ValueError(f"layout {layout!r}: 'rowpair' (K1) or 'span' (K9)")
    stage_k = 128 if layout == "rowpair" or groupsize % 64 == 0 else 64
    stages = -(-k // stage_k)
    tile, bm = (DECODE_TILE, DECODE_ROWS) if m <= DECODE_ROWS else (PREFILL_TILE, PREFILL_ROWS)
    tiles = -(-m // bm) * -(-n // TILE_N)
    if tile == PREFILL_TILE and tiles >= sms:
        return GemmPlan(tile, bm, TILE_N, stage_k, stages, 1, stages)
    splits, sps = _split(stages, 1, tiles, sms)
    return GemmPlan(tile, bm, TILE_N, stage_k, stages, splits, sps)


def _split(units: int, unit_stages: int, tiles: int, sms: int):
    """(splits, units a split) of K in whole units of ``unit_stages`` stages
    (K1 and K9: a stage; K10: a span) over ``tiles`` output tiles: the split
    that minimises waves x (stages a split + a block's start and finish)."""
    best = None
    for s in range(1, min(units, MAX_SPLITS) + 1):
        per = -(-units // s)
        splits = -(-units // per)
        cost = -(-tiles * splits // sms) * (per * unit_stages + _FILL_STAGES)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


# K10's tiles (token rows x 128 columns): decode and prefill (each thread
# holds three accumulator sets, two int32 planes and the fp32 sum)
FP_DECODE_TILE, FP_PREFILL_TILE = 0, 1
FP_TILE_ROWS = {FP_DECODE_TILE: 16, FP_PREFILL_TILE: 128}


@functools.lru_cache(maxsize=4096)
def fpscale_plan(m: int, n: int, k: int, groupsize: int, sms: int):
    """K10's (tile, packed rows per split) for an (m, n, k) call on a card
    with ``sms`` SMs.

    Up to DECODE_ROWS rows take the decode tile (16 token rows), more the
    prefill tile (128); both hold 128 weight columns.  A split holds whole
    spans (gs packed rows), as the kernel flushes its fp32 sum per span; the
    split is ``gemm_plan``'s choice (``_split``) in whole spans, and the
    prefill tile is not split once its tiles fill the SMs."""
    tile = FP_DECODE_TILE if m <= DECODE_ROWS else FP_PREFILL_TILE
    tiles = -(-m // FP_TILE_ROWS[tile]) * -(-n // TILE_N)
    kp = k // 2
    if tile != FP_DECODE_TILE and tiles >= sms:
        return tile, kp
    span_stages = groupsize // (64 if groupsize % 64 == 0 else 32)
    _, per = _split(kp // groupsize, span_stages, tiles, sms)
    return tile, per * groupsize


def fpscale_candidates(m: int, n: int, k: int, groupsize: int, sms: int) -> list:
    """Every K10 plan ``fpscale_plan`` weighs for an (m, n, k) call: its
    tile with each split ``_split`` can pick (whole spans a split, from one
    split up to MAX_SPLITS), the unsplit one first."""
    tile, _ = fpscale_plan(m, n, k, groupsize, sms)
    spans = k // 2 // groupsize
    pers = sorted({-(-spans // s) for s in range(1, min(spans, MAX_SPLITS) + 1)}, reverse=True)
    return [(tile, per * groupsize) for per in pers]


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer tensors (broadcasting like matmul).

    On the CPU it runs in int32.  CUDA has no int32 matmul, so there it runs
    in float64, exact while every partial sum stays below 2**53.  float32
    alone would be exact only for Dh-length s8 dots (|sum| <= 2**24), not for
    K = 11264 or Smax-length sums."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def short_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product of small integer tensors as float32, for sums whose
    every partial stays below 2**24 in magnitude (a 128-long dot of int8
    with int8 or with 0..15 codes): the operands are exact in float32 and in
    TF32 alike, and so is every partial sum."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def unpack_rowpair_s4(qw_rp: torch.Tensor) -> torch.Tensor:
    """(K//2, N) rowpair bytes -> (K, N) int8 shifted codes c - 8 in [-8, 7]."""
    u = qw_rp.view(torch.uint8).to(torch.int32)
    lo = ((u & 0xF) ^ 8) - 8
    hi = ((u >> 4) ^ 8) - 8
    k2, n = qw_rp.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * k2, n).to(torch.int8)


def dequantize_rowpair(qw_rp: torch.Tensor, wscales: torch.Tensor, wzeros: torch.Tensor,
                       groupsize: int) -> torch.Tensor:
    """(K, N) int8 weights (c4 - (z - 8)) * s from compact (G, N) scales."""
    c4 = unpack_rowpair_s4(qw_rp).to(torch.int32)
    z4 = torch.repeat_interleave(wzeros.to(torch.int32) - 8, groupsize, dim=0)
    s = torch.repeat_interleave(wscales.to(torch.int32), groupsize, dim=0)
    return ((c4 - z4) * s).to(torch.int8)


def _epilogue(acc: torch.Tensor, alpha: torch.Tensor, beta: Optional[torch.Tensor],
              out_dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``acc * alpha (+ beta)``, then f32 or ``clip(round(.))`` int8."""
    y = acc * alpha.reshape(1, -1)
    if beta is not None:
        y = y + beta.reshape(1, -1)
    if out_dtype == torch.int8:
        return torch.clamp(torch.round(y), -128, 127).to(torch.int8)
    return y


def w4a8_matmul_rp_xla(x_s8: torch.Tensor, qw_rp: torch.Tensor, wscales: torch.Tensor,
                       wzeros: torch.Tensor, alpha: torch.Tensor,
                       beta: Optional[torch.Tensor] = None, *,
                       groupsize: int = 128) -> torch.Tensor:
    """Plain rowpair GEMM: dequantise to int8, exact integer product, fp32
    epilogue ``acc * alpha + beta``.  ``wscales``/``wzeros`` are compact
    (G, N)."""
    acc = int_matmul(x_s8, dequantize_rowpair(qw_rp, wscales, wzeros, groupsize))
    return _epilogue(acc.to(torch.float32), alpha, beta, torch.float32)


def w4a8_matmul_rp_pipe(x_s8: torch.Tensor, qw_rp: torch.Tensor, wscales: torch.Tensor,
                        wzeros: torch.Tensor, alpha: torch.Tensor,
                        beta: Optional[torch.Tensor] = None, *, groupsize: int = 128,
                        scales_replicated: bool = False) -> torch.Tensor:
    """K1: (M, K) int8 x rowpair (K//2, N) -> (M, N) f32.

    ``scales_replicated``: scales and zeros arrive 8x row-replicated as
    (8G, N) (group g at row 8g), as the engine stores them.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    m, k = x_s8.shape
    k2, n = qw_rp.shape
    if 2 * k2 != k or k % groupsize:
        raise ValueError(f"shapes: x {tuple(x_s8.shape)}, qw_rp {tuple(qw_rp.shape)}, "
                         f"groupsize {groupsize}")
    srep = 8 if scales_replicated else 1
    g = k // groupsize
    if x_s8.device.type == "cpu":
        return w4a8_matmul_rp_xla(x_s8, qw_rp, wscales[::srep], wzeros[::srep], alpha, beta,
                                  groupsize=groupsize)
    dev = x_s8.device
    _cuda.require(x_s8, "x_s8", torch.int8, (m, k), dev)
    _cuda.require(qw_rp, "qw_rp", torch.int8, (k2, n), dev)
    _cuda.require(wscales, "wscales", torch.int8, (g * srep, n), dev)
    _cuda.require(wzeros, "wzeros", torch.int8, (g * srep, n), dev)
    _cuda.require(alpha, "alpha", torch.float32, (n,), dev, align=4)
    if beta is not None:
        _cuda.require(beta, "beta", torch.float32, (n,), dev, align=4)
    if n % 16 or k % 64 or groupsize % 64:
        raise ValueError(f"K1 needs N % 16 == 0, K % 64 == 0 and groupsize % 64 == 0; "
                         f"got N={n}, K={k}, groupsize={groupsize}")
    lib = _cuda.library(_cuda.SOURCES[KERNEL], _SIGNATURES)
    plan = gemm_plan(m, n, k, groupsize, "rowpair", _sms(dev))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = (torch.empty((plan.splits, m, n), dtype=torch.int32, device=dev)
            if plan.splits > 1 else None)
    rc = lib.w4a8_rp_gemm(
        _cuda.ptr(x_s8), _cuda.ptr(qw_rp), _cuda.ptr(wscales), _cuda.ptr(wzeros), srep,
        m, n, k, groupsize, plan.tile, plan.splits, plan.sps, _cuda.ptr(alpha), _cuda.ptr(beta),
        _cuda.ptr(out), _cuda.ptr(part), _cuda.stream(dev))
    _cuda.check(rc, KERNEL)
    _cuda.count_launch(KERNEL)
    return out


def dequantize_span(qweight: torch.Tensor, wscales: torch.Tensor, wzeros: torch.Tensor,
                    groupsize: int) -> torch.Tensor:
    """(K, N) int8 weights (c - z) * s from span bytes and compact (G, N)
    int8 scales and zeros (codes c unsigned, zeros not shifted)."""
    codes = unpack_nibbles(qweight, 2 * groupsize).to(torch.int32)
    z = torch.repeat_interleave(wzeros.to(torch.int32), groupsize, dim=0)
    s = torch.repeat_interleave(wscales.to(torch.int32), groupsize, dim=0)
    return ((codes - z) * s).to(torch.int8)


def w4a8_matmul_packed_xla(x_s8: torch.Tensor, qweight: torch.Tensor, wscales: torch.Tensor,
                           wzeros: torch.Tensor, alpha: torch.Tensor,
                           beta: Optional[torch.Tensor] = None, *, groupsize: int = 128,
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain span GEMM, as JAX's plain engine paths compute it
    (``opt_engine.py:281-293``, ``engine.py:505-527``): dequantise to int8,
    exact integer product, ``acc * alpha (+ beta)``, then f32 or
    ``clip(round(.), -128, 127)`` int8.  Compact (G, N) scales."""
    acc = int_matmul(x_s8, dequantize_span(qweight, wscales, wzeros, groupsize))
    return _epilogue(acc.to(torch.float32), alpha, beta, out_dtype)


def _span_launch(name: str, x_s8, qweight, wscales, wzeros, alpha, beta, groupsize: int,
                 scales_replicated: bool, out_dtype: torch.dtype, fp_plan=None):
    """Check the operands of K9 (int8 scales) or K10 (``name == FPSCALE``,
    f32 scales) and launch it; K10 with ``fp_plan`` (one of
    ``fpscale_candidates``) in place of ``fpscale_plan``'s."""
    fp = name == FPSCALE
    m, k = x_s8.shape
    k2, n = qweight.shape
    srep = 8 if scales_replicated else 1
    g = k // groupsize
    sdt = torch.float32 if fp else torch.int8
    dev = x_s8.device
    _cuda.require(x_s8, "x_s8", torch.int8, (m, k), dev)
    _cuda.require(qweight, "qweight", torch.int8, (k2, n), dev)
    _cuda.require(wscales, "wscales", sdt, (g * srep, n), dev)
    _cuda.require(wzeros, "wzeros", sdt, (g * srep, n), dev)
    _cuda.require(alpha, "alpha", torch.float32, (n,), dev, align=4)
    if beta is not None:
        _cuda.require(beta, "beta", torch.float32, (n,), dev, align=4)
    if n % 16 or groupsize % 32:
        raise ValueError(f"{name} needs N % 16 == 0 and groupsize % 32 == 0; "
                         f"got N={n}, groupsize={groupsize}")
    lib = _cuda.library(_cuda.SOURCES[name], _SPAN_SIGNATURES)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    args = (_cuda.ptr(x_s8), _cuda.ptr(qweight), _cuda.ptr(wscales), _cuda.ptr(wzeros), srep,
            m, n, k, groupsize)
    if fp:
        tile, p_split = fp_plan or fpscale_plan(m, n, k, groupsize, _sms(dev))
        splits = -(-k2 // p_split)
        part = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
                if splits > 1 else None)
        rc = lib.w4a8_fpscale_gemm(*args, tile, p_split, _cuda.ptr(alpha), _cuda.ptr(beta),
                                   _cuda.ptr(out), _cuda.ptr(part), _cuda.stream(dev))
    else:
        plan = gemm_plan(m, n, k, groupsize, "span", _sms(dev))
        part = (torch.empty((plan.splits, m, n), dtype=torch.int32, device=dev)
                if plan.splits > 1 else None)
        rc = lib.w4a8_span_gemm(*args, plan.tile, plan.splits, plan.sps, _cuda.ptr(alpha),
                                _cuda.ptr(beta), _cuda.ptr(out), _cuda.ptr(part),
                                int(out_dtype == torch.int8), _cuda.stream(dev))
    _cuda.check(rc, name)
    _cuda.count_launch(name)
    return out


def _check_span(x_s8, qweight, groupsize: int) -> None:
    k, k2 = x_s8.shape[1], qweight.shape[0]
    if 2 * k2 != k or k % (2 * groupsize):
        raise ValueError(f"shapes: x {tuple(x_s8.shape)}, qweight {tuple(qweight.shape)}, "
                         f"groupsize {groupsize}")


def w4a8_matmul_packed(x_s8: torch.Tensor, qweight: torch.Tensor, wscales: torch.Tensor,
                       wzeros: torch.Tensor, alpha: torch.Tensor,
                       beta: Optional[torch.Tensor] = None, *, groupsize: int = 128,
                       out_dtype: torch.dtype = torch.float32,
                       scales_replicated: bool = False) -> torch.Tensor:
    """K9: (M, K) int8 x span-packed (K//2, N) -> (M, N) f32, or int8 with
    ``out_dtype=torch.int8`` (``clip(round(acc * alpha + beta))``).

    ``scales_replicated``: int8 scales and zeros arrive 8x row-replicated as
    (8G, N), as the engines store them.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    _check_span(x_s8, qweight, groupsize)
    if out_dtype not in (torch.float32, torch.int8):
        raise ValueError(f"out_dtype {out_dtype}: K9 writes float32 or int8")
    if x_s8.device.type == "cpu":
        srep = 8 if scales_replicated else 1
        return w4a8_matmul_packed_xla(x_s8, qweight, wscales[::srep], wzeros[::srep], alpha,
                                      beta, groupsize=groupsize, out_dtype=out_dtype)
    return _span_launch(SPAN, x_s8, qweight, wscales, wzeros, alpha, beta, groupsize,
                        scales_replicated, out_dtype)


# K14's two TPU tilings of K9's function (dequantise each weight block once
# and keep it resident over M; dequantise one K block ahead of the dot) are
# tiling choices inside K9's kernel on Hopper: both names run K9.
w4a8_matmul_wres = w4a8_matmul_pipe = w4a8_matmul_packed


def w4a8_fpscale_matmul_packed_xla(x_s8: torch.Tensor, qweight: torch.Tensor,
                                   wscales: torch.Tensor, wzeros: torch.Tensor,
                                   alpha: torch.Tensor, beta: Optional[torch.Tensor] = None, *,
                                   groupsize: int = 128) -> torch.Tensor:
    """Plain fp-scale span GEMM, in the kernel's steps: per group g (in K
    order) the exact dot d_g of x with the raw codes and the row sum of x
    over the group, ``acc = acc + s_g * (d_g - z_g * rowsum_g)`` in fp32,
    then ``acc * alpha (+ beta)``.  Compact (G, N) f32 scales and zeros."""
    m, k = x_s8.shape
    g = k // groupsize
    codes = unpack_nibbles(qweight, 2 * groupsize).reshape(g, groupsize, -1)
    xg = x_s8.reshape(m, g, groupsize)
    rowsum = xg.to(torch.int32).sum(dim=-1).to(torch.float32)  # (M, G)
    acc = torch.zeros((m, qweight.shape[1]), dtype=torch.float32, device=x_s8.device)
    for i in range(g):
        d = short_int_matmul(xg[:, i], codes[i])
        acc = acc + wscales[i] * (d - wzeros[i] * rowsum[:, i:i + 1])
    return _epilogue(acc, alpha, beta, torch.float32)


def w4a8_fpscale_matmul_packed(x_s8: torch.Tensor, qweight: torch.Tensor,
                               wscales: torch.Tensor, wzeros: torch.Tensor,
                               alpha: torch.Tensor, beta: Optional[torch.Tensor] = None, *,
                               groupsize: int = 128,
                               scales_replicated: bool = False) -> torch.Tensor:
    """K10: (M, K) int8 x span-packed raw codes with fp32 group scales and
    zeros -> (M, N) f32.

    ``scales_replicated``: scales and zeros arrive 8x row-replicated as
    (8G, N), as the engine stores them (JAX's wrapper takes compact ones
    only).  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    _check_span(x_s8, qweight, groupsize)
    if x_s8.device.type == "cpu":
        srep = 8 if scales_replicated else 1
        return w4a8_fpscale_matmul_packed_xla(x_s8, qweight, wscales[::srep], wzeros[::srep],
                                              alpha, beta, groupsize=groupsize)
    return _span_launch(FPSCALE, x_s8, qweight, wscales, wzeros, alpha, beta, groupsize,
                        scales_replicated, torch.float32)
