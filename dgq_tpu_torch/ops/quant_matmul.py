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
"""

from __future__ import annotations

from typing import Optional

import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.quant.packing import unpack_nibbles

KERNEL = "w4a8_matmul_rp_pipe"
SPAN = "w4a8_matmul_packed"  # K9 (and K14's names)
FPSCALE = "w4a8_fpscale_matmul_packed"  # K10
_SIGNATURES = {
    "w4a8_rp_gemm_k_split": [_cuda.INT] * 4,
    "w4a8_rp_gemm": [_cuda.VP] * 4 + [_cuda.INT] * 6 + [_cuda.VP] * 5,
}
_SPAN_SIGNATURES = {
    "w4a8_span_gemm_p_split": [_cuda.INT] * 6,
    # x, qw, scales, zeros, srep, M, N, K, gs, p_split, alpha, beta, out, part, mode, stream
    "w4a8_span_gemm": [_cuda.VP] * 4 + [_cuda.INT] * 6 + [_cuda.VP] * 4 + [_cuda.INT, _cuda.VP],
}
_F32_OUT, _S8_OUT, _FP_MODE = 0, 1, 2  # the span kernel's modes


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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k_split = lib.w4a8_rp_gemm_k_split(m, n, k, sms)
    splits = -(-k // k_split)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = torch.empty((splits, m, n), dtype=torch.int32, device=dev) if splits > 1 else None
    rc = lib.w4a8_rp_gemm(
        _cuda.ptr(x_s8), _cuda.ptr(qw_rp), _cuda.ptr(wscales), _cuda.ptr(wzeros), srep,
        m, n, k, groupsize, k_split, _cuda.ptr(alpha), _cuda.ptr(beta), _cuda.ptr(out),
        _cuda.ptr(part), _cuda.stream(dev))
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


def _span_launch(mode: int, name: str, x_s8, qweight, wscales, wzeros, alpha, beta,
                 groupsize: int, scales_replicated: bool, out_dtype: torch.dtype):
    """Check the operands of the span kernel and launch it in ``mode``."""
    m, k = x_s8.shape
    k2, n = qweight.shape
    srep = 8 if scales_replicated else 1
    g = k // groupsize
    sdt = torch.float32 if mode == _FP_MODE else torch.int8
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p_split = lib.w4a8_span_gemm_p_split(m, n, k, groupsize, mode, sms)
    splits = -(-k2 // p_split)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    part = None
    if splits > 1:
        pdt = torch.float32 if mode == _FP_MODE else torch.int32
        part = torch.empty((splits, m, n), dtype=pdt, device=dev)
    rc = lib.w4a8_span_gemm(
        _cuda.ptr(x_s8), _cuda.ptr(qweight), _cuda.ptr(wscales), _cuda.ptr(wzeros), srep,
        m, n, k, groupsize, p_split, _cuda.ptr(alpha), _cuda.ptr(beta), _cuda.ptr(out),
        _cuda.ptr(part), mode, _cuda.stream(dev))
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
    mode = _S8_OUT if out_dtype == torch.int8 else _F32_OUT
    return _span_launch(mode, SPAN, x_s8, qweight, wscales, wzeros, alpha, beta, groupsize,
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
    return _span_launch(_FP_MODE, FPSCALE, x_s8, qweight, wscales, wzeros, alpha, beta,
                        groupsize, scales_replicated, torch.float32)
