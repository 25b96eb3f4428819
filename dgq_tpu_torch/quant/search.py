"""DGQ search-based weight quantization (``--wt_fun search``) and the naive
per-group min/max quantizer (``--wt_fun naive``).

Port of ``dgq_tpu/quant/search.py``:

  Stage 1: per-group asymmetric INT4 params from a 20-point clip-ratio grid
  (1.009 -> 0.80) per group, scored by the layer-output MSE on ``inp1`` (the
  last calibration sample's input), the clamp of W cumulative over the grid.

  Stage 2 (w4w8): a per-output-row INT8 rescale from an 80-point grid (1.01
  -> 0.20) over the row absmax, ``scale8 = absmax * r / 127``; the group
  scale becomes the integer ``round(scale4 / scale8)`` (>= 1) and codes are
  clamped so that ``(q - zero) * scale`` fits int8.

Stage 1's scales and zeros are rounded to bf16 between the stages, and
scale8 before the final requant, as JAX rounds them (round to nearest even
in both).  The fp32 arithmetic follows what XLA compiles JAX's jitted search
to: a grid ratio is ``top - (i + 1) * c`` with c = fp32(fp32(1 / grid) *
span) in one rounding (a fused multiply-add), and a division by a constant
is a product with its fp32 reciprocal.
A row keeps the first grid point of least MSE (``best > mse``, strict): two
candidates whose fp32 MSEs tie to the last ulp can swap when the sums run in
another order (XLA on the CPU, torch on the CPU, the card), so the tests hold
each flipped choice to a near tie.  Call under ``ieee_matmul`` on the card
(``search_quantize`` enters it itself): TF32 changes the winners.

Stage 2 builds one (N, K) fp32 candidate weight at a time; stage 1 runs a
chunk of groups at a time, its (groups, T, N) outputs kept under
``STAGE1_BYTES``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from dgq_tpu_torch.quant.packing import bf16_round
from dgq_tpu_torch.quant.quantizer import find_params_weight_grouped, ieee_matmul, \
    quantize_with, recip

Tensor = torch.Tensor

# stage 1 runs groups in chunks whose (chunk, T, N) fp32 outputs stay under this
STAGE1_BYTES = 1 << 29


class SearchResult(NamedTuple):
    scale: Tensor  # (N, G): integer-valued under w4w8, else the fp group scale
    zero: Tensor  # (N, G) integer-valued
    scale8: Tensor  # (N,) per-channel scale (zeros without w4w8)
    qweight_fp: Tensor  # (N, K) dequantized fake-quant weight


def _ratio(i: int, grid: int, top: float, span: float, device) -> Tensor:
    """The grid ratio ``top - (i + 1) / grid * span`` as XLA computes it:
    the constants folded to c = fp32(fp32(1 / grid) * span), then (i + 1) *
    c subtracted from fp32(top) with one rounding (exact in float64: the
    product of two fp32 values, the difference within 53 bits)."""
    c = np.float32(recip(grid)) * np.float32(span)
    r = np.float32(np.float64(np.float32(top)) - np.float64(i + 1) * np.float64(c))
    return torch.tensor(r, dtype=torch.float32, device=device)


def _stage1(W: Tensor, inp1: Tensor, groupsize: int, maxq: int, grid: int):
    """Stage 1 over every group: (scales, zeros), each (N, G), fp32."""
    n, k = W.shape
    g = k // groupsize
    t = inp1.shape[0]
    Wg = W.reshape(n, g, groupsize).transpose(0, 1)  # (G, N, gs)
    Xg = inp1.reshape(t, g, groupsize).transpose(0, 1)  # (G, T, gs)
    chunk = max(1, min(g, STAGE1_BYTES // max(1, 4 * t * n)))
    scales, zeros = [], []
    for c0 in range(0, g, chunk):
        W_t0, X_t = Wg[c0:c0 + chunk], Xg[c0:c0 + chunk]
        org_out = torch.matmul(X_t, W_t0.transpose(1, 2))  # (C, T, N)
        w_max = torch.amax(W_t0, dim=-1, keepdim=True)
        w_min = torch.amin(W_t0, dim=-1, keepdim=True)
        W_t = W_t0
        best = torch.full(w_max.shape[:2], float("inf"), device=W.device)
        bscale = torch.ones_like(best)
        bzero = torch.ones_like(best)
        for i in range(grid):
            ratio = _ratio(i, grid, 1.02, 0.22, W.device)
            # cumulative clamp: each ratio clamps the previous ratio's W
            W_t = torch.clamp(W_t, w_min * ratio, w_max * ratio)
            qscale = (w_max * ratio - w_min * ratio) * recip(maxq)
            qscale = torch.where(qscale == 0, torch.full_like(qscale, 1e-8), qscale)
            qzero = torch.round(-w_min * ratio / qscale)
            qtensor = torch.clamp(torch.round(W_t / qscale) + qzero, 0, maxq)
            out = torch.matmul(X_t, (qscale * (qtensor - qzero)).transpose(1, 2))
            mse = torch.mean(torch.square(org_out - out), dim=1)  # (C, N)
            better = best > mse
            best = torch.where(better, mse, best)
            bscale = torch.where(better, qscale[..., 0], bscale)
            bzero = torch.where(better, qzero[..., 0], bzero)
            del out, mse
        scales.append(bscale)
        zeros.append(bzero)
    return torch.cat(scales).t(), torch.cat(zeros).t()


def _w4w8_requant(W: Tensor, scale1: Tensor, zero1: Tensor, s8: Tensor, groupsize: int):
    """W re-quantized under a per-row scale8: (dequantized weight, integer
    group scales)."""
    n, k = W.shape
    g = k // groupsize
    qs = torch.clamp(torch.round(scale1 / s8[:, None]), min=1.0)  # (N, G)
    int_max = torch.floor(127.0 / qs)
    upper = torch.clamp(zero1 + int_max, max=15.0)
    lower = torch.clamp(zero1 - int_max, min=0.0)
    qsq = qs * s8[:, None]
    w_max = 127.0 * s8[:, None]
    Wc = torch.minimum(torch.maximum(W, -w_max), w_max).reshape(n, g, groupsize)
    codes = torch.round(Wc / qsq[:, :, None]) + zero1[:, :, None]
    codes = torch.minimum(torch.maximum(codes, lower[:, :, None]), upper[:, :, None])
    W_q = (qsq[:, :, None] * (codes - zero1[:, :, None])).reshape(n, k)
    return W_q, qs


def search_quantize(W: Tensor, inp1: Tensor, *, bits: int = 4, groupsize: int = 128,
                    w4w8: bool = True, grid1: int = 20, grid2: int = 80,
                    with_fallback: bool = False):
    """The DGQ search on a weight W (N = out, K = in) with calibration
    activations inp1 (T, K), on their device.  ``with_fallback=True`` (w4w8
    only) also returns the plain fp-group-scale result and both layer-output
    MSEs from the same stage 1: ``(res_w4w8, res_plain, err_w4w8,
    err_plain)``."""
    with ieee_matmul():
        return _search(W, inp1, bits, groupsize, w4w8, grid1, grid2, with_fallback)


def _search(W, inp1, bits, groupsize, w4w8, grid1, grid2, with_fallback):
    maxq = 2**bits - 1
    W = W.to(torch.float32)
    inp1 = inp1.to(torch.float32)
    n, k = W.shape
    if groupsize <= 0:
        groupsize = k
    if k % groupsize:
        raise ValueError(f"in_features {k} % groupsize {groupsize} != 0")
    scales, zeros = _stage1(W, inp1, groupsize, maxq, grid1)
    scale1, zero1 = bf16_round(scales), bf16_round(zeros)

    def plain() -> SearchResult:
        wg = W.reshape(-1, groupsize)
        s, z = scale1.reshape(-1, 1), zero1.reshape(-1, 1)
        q = torch.clamp(torch.round(wg / s) + z, 0, maxq)
        return SearchResult(scale1, zero1, torch.zeros((n,), device=W.device),
                            (s * (q - z)).reshape(n, k))

    if not w4w8:
        if with_fallback:
            raise ValueError("with_fallback requires w4w8=True")
        return plain()

    org_out = torch.matmul(inp1, W.t())  # (T, N)
    row_absmax = torch.amax(torch.abs(W), dim=-1)
    best = torch.full((n,), float("inf"), device=W.device)
    scale8 = torch.full((n,), 1e-8, device=W.device)
    for i in range(grid2):
        ratio = _ratio(i, grid2, 1.02, 0.82, W.device)
        s8 = row_absmax * ratio * recip(127.0)
        s8 = torch.where(s8 == 0, torch.full_like(s8, 1e-8), s8)
        W_q, _ = _w4w8_requant(W, scale1, zero1, s8, groupsize)
        mse = torch.mean(torch.square(org_out - torch.matmul(inp1, W_q.t())), dim=0)
        del W_q
        better = best > mse
        best = torch.where(better, mse, best)
        scale8 = torch.where(better, s8, scale8)

    # scale8 at its stored (bf16) precision before the final requant, so that
    # packing the fake-quant weight reproduces its codes
    scale8 = bf16_round(scale8)
    qweight_fp, qs = _w4w8_requant(W, scale1, zero1, scale8, groupsize)
    res = SearchResult(qs, zero1, scale8, qweight_fp)
    if not with_fallback:
        return res
    res_plain = plain()
    err_w4w8 = torch.mean(torch.square(torch.matmul(inp1, qweight_fp.t()) - org_out))
    err_plain = torch.mean(torch.square(torch.matmul(inp1, res_plain.qweight_fp.t()) - org_out))
    return res, res_plain, err_w4w8, err_plain


def naive_quantize(W: Tensor, *, bits: int = 4, groupsize: int = 128
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-group min/max quantization.  Returns (scale (N, G), zero (N, G),
    fake-quant weight (N, K))."""
    W = W.to(torch.float32)
    n, k = W.shape
    if groupsize <= 0:
        groupsize = k
    g = k // groupsize
    params = find_params_weight_grouped(W, bits, groupsize, sym=False, mse=False)
    qw = quantize_with(params._replace(scale=params.scale[:, None], zero=params.zero[:, None]),
                       W.reshape(-1, groupsize)).reshape(n, k)
    return params.scale.reshape(n, g), params.zero.reshape(n, g), qw
