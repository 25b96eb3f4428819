"""W4A8 GEMM on rowpair-packed weights: K1 and its plain version.

Port of ``dgq_tpu/ops/quant_matmul.py``: ``unpack_rowpair_s4`` (:684-691),
the plain ``w4a8_matmul_rp_xla`` (:694-722) and, under the JAX name
``w4a8_matmul_rp_pipe``, the wrapper of the hand-written CUDA kernel
``csrc/w4a8_rp_gemm.cu`` that replaces the TPU kernel of that name.
"""

from __future__ import annotations

from typing import Optional

import torch

from dgq_tpu_torch.ops import _cuda

KERNEL = "w4a8_matmul_rp_pipe"
_SIGNATURES = {
    "w4a8_rp_gemm_k_split": [_cuda.INT] * 4,
    "w4a8_rp_gemm": [_cuda.VP] * 4 + [_cuda.INT] * 6 + [_cuda.VP] * 5,
}


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer tensors (broadcasting like matmul).

    On the CPU it runs in int32.  CUDA has no int32 matmul, so there it runs
    in float64, exact while every partial sum stays below 2**53.  float32
    alone would be exact only for Dh-length s8 dots (|sum| <= 2**24), not for
    K = 11264 or Smax-length sums."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


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


def w4a8_matmul_rp_xla(x_s8: torch.Tensor, qw_rp: torch.Tensor, wscales: torch.Tensor,
                       wzeros: torch.Tensor, alpha: torch.Tensor,
                       beta: Optional[torch.Tensor] = None, *,
                       groupsize: int = 128) -> torch.Tensor:
    """Plain rowpair GEMM: dequantise to int8, exact integer product, fp32
    epilogue ``acc * alpha + beta``.  ``wscales``/``wzeros`` are compact
    (G, N)."""
    acc = int_matmul(x_s8, dequantize_rowpair(qw_rp, wscales, wzeros, groupsize))
    y = acc.to(torch.float32) * alpha.reshape(1, -1)
    if beta is not None:
        y = y + beta.reshape(1, -1)
    return y


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
