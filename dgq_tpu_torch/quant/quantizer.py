"""Uniform affine quantizer math.

Port of ``dgq_tpu/quant/quantizer.py``: per-row min/max scale and zero with
an optional MSE grid shrink, and the affine quantize/dequantize primitive, as
pure functions on tensors.  Numerics as the reference's: zero-range rows
(xmin == xmax == 0) become [-1, 1], symmetric mirroring, the ``p = 1 -
i/grid`` shrink schedule and ``zero = round(-xmin / scale)``; ``torch.round``
rounds half to even as ``jnp.round`` does.  The scale divides by maxq as XLA
computes it inside ``jit`` (where JAX's callers run it: ``naive_quantize``,
``gptq_quantize``, the MSE grid's scan): times the fp32 reciprocal of maxq.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class QuantParams(NamedTuple):
    """Per-row affine quantization parameters (scale, zero, maxq)."""

    scale: Tensor  # (rows,) or broadcastable
    zero: Tensor  # (rows,) float (rounded integer values)
    maxq: int  # 2**bits - 1


def affine_quantize_values(x: Tensor, scale, zero, maxq: int) -> Tensor:
    """Integer codes: clamp(round(x / scale) + zero, 0, maxq)."""
    return torch.clamp(torch.round(x / scale) + zero, 0, maxq)


def affine_quantize(x: Tensor, scale, zero, maxq: int) -> Tensor:
    """Fake-quantize: scale * (q - zero)."""
    q = affine_quantize_values(x, scale, zero, maxq)
    return scale * (q - zero)


def recip(c: float) -> float:
    """The fp32 reciprocal of a constant: XLA rewrites ``x / c`` under jit
    as ``x * recip(c)``."""
    return float(np.float32(1.0) / np.float32(c))


def _fma_f32(a: float, b: float, c: float) -> float:
    """fp32(a * b + c) with one rounding, for fp32 a, b, c (exact in
    float64 at the magnitudes of a grid's constants)."""
    return float(np.float32(float(np.float32(a)) * float(np.float32(b)) + float(np.float32(c))))


def _minmax_params(x2d: Tensor, maxq: int, sym: bool):
    """Per-row min/max scale and zero for a 2D (rows, elems) view."""
    zero_t = x2d.new_zeros(())
    xmin = torch.minimum(torch.amin(x2d, dim=1), zero_t)
    xmax = torch.maximum(torch.amax(x2d, dim=1), zero_t)
    if sym:
        xmax = torch.maximum(torch.abs(xmin), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, x2d.new_full((), -1.0), xmin)
    xmax = torch.where(degenerate, x2d.new_full((), 1.0), xmax)

    scale = (xmax - xmin) * recip(maxq)
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)
    return xmin, xmax, scale, zero


def find_params(x2d: Tensor, bits: int, *, sym: bool = False, mse: bool = False,
                norm: float = 2.4, grid: int = 100, maxshrink: float = 0.8) -> QuantParams:
    """Per-row quantization parameters for a 2D (rows, elems) tensor; the
    caller's reshape defines the rows.  ``mse=True`` runs the shrink grid p =
    1 - i/grid for i in [0, maxshrink*grid), keeping per row the p with the
    least sum |q(x) - x|^norm (strictly less: the first p wins a tie)."""
    maxq = 2**bits - 1
    x2d = x2d.to(torch.float32)
    xmin, xmax, scale, zero = _minmax_params(x2d, maxq, sym)
    if not mse:
        return QuantParams(scale=scale, zero=zero, maxq=maxq)

    nsteps = int(maxshrink * grid)
    best = torch.full((x2d.shape[0],), float("inf"), dtype=torch.float32, device=x2d.device)
    for i in range(nsteps):
        p = _fma_f32(-float(i), recip(grid), 1.0)
        xmin1 = p * xmin
        # XLA fuses p * xmax - xmin1 into one multiply-add (one rounding)
        scale1 = (p * xmax.double() - xmin1.double()).float() * recip(maxq)
        zero1 = zero if sym else torch.round(-xmin1 / scale1)
        q = affine_quantize(x2d, scale1[:, None], zero1[:, None], maxq)
        err = torch.sum(torch.abs(q - x2d) ** norm, dim=1)
        better = err < best
        best = torch.where(better, err, best)
        scale = torch.where(better, scale1, scale)
        zero = torch.where(better, zero1, zero)
    return QuantParams(scale=scale, zero=zero, maxq=maxq)


def quantize_with(params: QuantParams, x: Tensor) -> Tensor:
    """Fake-quantize ``x`` with broadcastable params."""
    return affine_quantize(x, params.scale, params.zero, params.maxq)


def find_params_weight_grouped(w: Tensor, bits: int, groupsize: int, *, sym: bool = False,
                               mse: bool = False) -> QuantParams:
    """Grouped per-(row, group) params for a 2D weight (out, in), flattened
    to (out * in // groupsize,) in ``view(-1, groupsize)`` order."""
    _, in_f = w.shape
    if groupsize <= 0:
        groupsize = in_f
    return find_params(w.reshape(-1, groupsize), bits, sym=sym, mse=mse)


@contextlib.contextmanager
def ieee_matmul():
    """fp32 matmuls in IEEE fp32 (no TF32) inside the block, the settings
    restored after it: the search scores rows by output MSE, and TF32's
    10-bit mantissa changes which clip ratio wins."""
    cuda_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(precision)
