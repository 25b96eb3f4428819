"""GPTQ weight quantization.

Port of ``dgq_tpu/quant/gptq.py``:

  * the Hessian H = 2/n * sum X X^T as a running mean in fp32 (``H *=
    n / (n + b); H += 2 / (n + b) X^T X``),
  * dead columns (zero diagonal) zeroed in W and given a unit diagonal, a
    damped Cholesky inverse (H -> chol -> inverse -> upper chol),
  * column-sequential quantization with error propagation in blocks of 128
    columns: within a block each column's error updates the block's later
    columns through the upper-triangular Hinv, across blocks one GEMM,
  * per-group scale and zero refreshed at each group boundary from the
    weight as it stood when its block began (a block starts with scale 1,
    zero 0 until its first boundary, as JAX's),
  * ``act_order``: columns by descending Hessian diagonal (a stable sort, as
    JAX's argsort), the contiguous groups' params re-derived from the final
    fake-quant weight.

``torch.linalg.cholesky`` and ``cholesky_solve`` differ from XLA's in the
last ulp, which can move a code across a rounding boundary, so GPTQ is held
to JAX's by its code-agreement rate, not by equality.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dgq_tpu_torch.quant.quantizer import find_params, ieee_matmul

Tensor = torch.Tensor


class GPTQResult(NamedTuple):
    scale: Tensor  # (N, G)
    zero: Tensor  # (N, G)
    qweight_fp: Tensor  # (N, K) dequantized fake-quant weight
    error: Tensor  # scalar sum of losses


def init_hessian(k: int, device="cuda"):
    """Fresh (H, nsamples) accumulator state."""
    return (torch.zeros((k, k), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.float32, device=device))


def update_hessian(H: Tensor, nsamples: Tensor, inp: Tensor, batches: int = 1):
    """Running Hessian update for activations inp (..., K); ``batches`` is
    the count of samples in ``inp`` (one per call in the sequential pass)."""
    x = inp.reshape(-1, inp.shape[-1]).to(torch.float32)
    new_n = nsamples + float(batches)
    H = H * (nsamples / new_n)
    x = torch.sqrt(2.0 / new_n) * x
    with ieee_matmul():
        return H + torch.matmul(x.t(), x), new_n


def gptq_quantize(W: Tensor, H: Tensor, *, bits: int = 4, groupsize: int = 128,
                  blocksize: int = 128, percdamp: float = 0.01,
                  act_order: bool = False) -> GPTQResult:
    with ieee_matmul():
        return _gptq(W, H, bits, groupsize, blocksize, percdamp, act_order)


def _gptq(W, H, bits, groupsize, blocksize, percdamp, act_order):
    W = W.to(torch.float32).clone()
    H = H.to(torch.float32).clone()
    n, k = W.shape
    dev = W.device
    maxq = 2**bits - 1
    if groupsize <= 0:
        groupsize = k
    blocksize = min(blocksize, k)
    if k % blocksize:
        blocksize = math.gcd(k, blocksize)
    if k % groupsize:
        raise ValueError(f"in_features {k} % groupsize {groupsize} != 0")
    g = k // groupsize

    dead = torch.diagonal(H) == 0
    H = H + torch.diag(dead.to(torch.float32))
    W[:, dead] = 0.0

    if act_order:
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        W = W[:, perm]
        H = H[perm][:, perm]

    damp = percdamp * torch.mean(torch.diagonal(H))
    H = H + damp * torch.eye(k, dtype=torch.float32, device=dev)
    L = torch.linalg.cholesky(H)
    Hfullinv = torch.cholesky_solve(torch.eye(k, dtype=torch.float32, device=dev), L)
    Hinv = torch.linalg.cholesky(Hfullinv, upper=True)

    Q = torch.zeros_like(W)
    losses = torch.zeros((), dtype=torch.float32, device=dev)
    scales = torch.zeros((g, n), dtype=torch.float32, device=dev)
    zeros = torch.zeros((g, n), dtype=torch.float32, device=dev)
    for i1 in range(0, k, blocksize):
        i2 = i1 + blocksize
        W1 = W[:, i1:i2].clone()
        Hinv1 = Hinv[i1:i2, i1:i2]
        Err1 = torch.zeros_like(W1)
        L1 = torch.zeros_like(W1)
        cur_scale = torch.ones((n,), dtype=torch.float32, device=dev)
        cur_zero = torch.zeros((n,), dtype=torch.float32, device=dev)
        for i in range(blocksize):
            col = i1 + i
            if col % groupsize == 0:
                p = find_params(W[:, col:col + groupsize], bits, sym=False, mse=False)
                cur_scale, cur_zero = p.scale, p.zero
                scales[col // groupsize] = cur_scale
                zeros[col // groupsize] = cur_zero
            w = W1[:, i].clone()
            d = Hinv1[i, i]
            q = torch.clamp(torch.round(w / cur_scale) + cur_zero, 0, maxq)
            q = cur_scale * (q - cur_zero)
            err = (w - q) / d
            # Hinv1[i, :i] == 0 (upper triangular): only columns >= i move
            W1[:, i:] -= err[:, None] * Hinv1[i, i:][None, :]
            Q[:, col] = q
            Err1[:, i] = err
            L1[:, i] = (w - q) ** 2 / d**2
        losses = losses + torch.sum(L1) / 2.0
        # cross-block propagation; columns before i2 are never read again
        W[:, i2:] -= torch.matmul(Err1, Hinv[i1:i2, i2:])

    if act_order:
        Q = Q[:, torch.argsort(perm)]
        p = find_params(Q.reshape(-1, groupsize), bits, sym=False, mse=False)
        scales = p.scale.reshape(n, g).t()
        zeros = p.zero.reshape(n, g).t()

    return GPTQResult(scale=scales.t().contiguous(), zero=zeros.t().contiguous(),
                      qweight_fp=Q, error=losses)
