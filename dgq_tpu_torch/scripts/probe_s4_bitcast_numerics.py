"""P4, the bitcast nibble order and its cost at the qkv decode shape.

Port of ``scripts/probe_s4_bitcast_numerics.py``.  ``numerics`` runs the
bitcast column map of P3 (``csrc/s4_gemv.cu``) at K 256 on one 256-column
block and says which golden it matches: A, the [low, high] interleave of
XLA's int4 order, or B, [all low | all high] halves, the order the TPU's
in-kernel bitcast gave on the chip.  ``paired_ab`` times it against the
production span kernel K12 (``fused_norm_gemv``) in rotated pairs.

``kern`` (the numerics kernel) and ``pl_bitcast`` (the paired one) are the
JAX probe's names; both run ``pallas_s4_bitcast``'s kernel and count under
it, with the column block as wide as the numerics' W (``kern``) or P3's 512
columns (``pl_bitcast``).

Run: ``python -m dgq_tpu_torch.scripts.probe_s4_bitcast_numerics`` on the
card, or with ``--cpu`` (the numerics, and the pairs at K 256, N 1024, on
the plain versions).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dgq_tpu_torch.scripts.probe_native_s4 import BN, k12_norm_gemv_case, pallas_s4_bitcast
from dgq_tpu_torch.utils.benchmarking import device_time

NUM_K, NUM_N2 = 256, 128  # the numerics: (K, N2) bytes -> (K, 2 N2) int4 columns


def kern(x: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """The numerics' bitcast dot: one column block as wide as W."""
    return pallas_s4_bitcast(x, wb, bn=2 * wb.shape[1])


def pl_bitcast(x: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """P3's bitcast dot (512-column blocks)."""
    return pallas_s4_bitcast(x, wb, bn=BN)


def goldens(x_np: np.ndarray, wb_np: np.ndarray):
    """(A: [lo, hi] interleaved, B: [lo | hi] halves) int32 products."""
    u = wb_np.astype(np.uint8)
    lo = ((u & 0xF) ^ 8).astype(np.int32) - 8
    hi = (((u >> 4) ^ 8).astype(np.int32)) - 8
    k, n2 = wb_np.shape
    inter = np.stack([lo, hi], axis=-1).reshape(k, 2 * n2)
    halves = np.concatenate([lo, hi], axis=1)
    xi = x_np.astype(np.int32)
    return xi @ inter, xi @ halves


def numerics(dev) -> dict:
    r = np.random.default_rng(1)
    wb_np = r.integers(-128, 128, (NUM_K, NUM_N2)).astype(np.int8)
    x_np = r.integers(-8, 8, (8, NUM_K)).astype(np.int8)
    got = kern(torch.from_numpy(x_np).to(dev), torch.from_numpy(wb_np).to(dev)).cpu().numpy()
    ga, gb = goldens(x_np, wb_np)
    res = {"view": [NUM_K, 2 * NUM_N2], "interleaved": bool(np.array_equal(got, ga)),
           "halves": bool(np.array_equal(got, gb))}
    print(f"bitcast view of ({NUM_K}, {NUM_N2}) bytes: {res['view']}", flush=True)
    print("matches [lo,hi]-interleaved:", res["interleaved"], flush=True)
    print("matches [lo|hi]-halves     :", res["halves"], flush=True)
    return res


def paired_ab(dev, k: int, n: int, reps: int = 6, iters: int = 48) -> dict:
    B = 8
    r = np.random.default_rng(0)

    def ri(lo, hi, shape):
        return torch.from_numpy(r.integers(lo, hi, shape).astype(np.int8)).to(dev)

    wb = ri(-128, 128, (k, n // 2))
    x4_8 = ri(-8, 8, (2 * B, k))
    x8 = ri(-127, 127, (B, k))
    k12 = k12_norm_gemv_case(r, dev, k, n)

    def fbp(out, x):
        return ((out[:, :k] & 0x7) - 4).to(torch.int8)

    def fbk(out, x):
        return (out[:, :k].to(torch.int32) & 0x7F).to(torch.int8)

    ratios = []
    for rep in range(reps):
        ts = {}
        for o in ([0, 1] if rep % 2 == 0 else [1, 0]):
            if o == 0:
                ts["s4"] = device_time(pl_bitcast, x4_8, wb, feedback=fbp, iters=iters,
                                       base_iters=max(1, iters // 4))
            else:
                ts["pk"] = device_time(k12, x8, feedback=fbk, iters=iters,
                                       base_iters=max(1, iters // 4))
        ratios.append(ts["pk"] / ts["s4"])
        print(f"[{rep}] s4-bitcast {ts['s4'] * 1e6:9.2f} us ({k * n / ts['s4'] / 1e9:6.1f} G) | "
              f"K12 {ts['pk'] * 1e6:9.2f} us ({k * n / ts['pk'] / 1e9:6.1f} G) | "
              f"K12/s4 = {ratios[-1]:5.2f} ({ts['s4'].clock})", flush=True)
    ratios.sort()
    med = ratios[len(ratios) // 2]
    print(f"median K12/s4 ratio over {len(ratios)} rotated pairs: {med:.3f}", flush=True)
    return {"median_k12_over_s4": med}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="the plain versions, K 256, N 1024")
    ap.add_argument("--reps", type=int, default=6, help="rotated pairs")
    ap.add_argument("--iters", type=int, default=48, help="long chain length (short: a quarter)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("probe_s4_bitcast_numerics: no CUDA device (torch.cuda.is_available() "
                         "is false); pass --cpu for the plain versions")
    dev = "cpu" if args.cpu else "cuda"
    k, n = (256, 1024) if args.cpu else (4096, 12288)
    return {**numerics(dev), **paired_ab(dev, k, n, args.reps, args.iters)}


if __name__ == "__main__":
    main()
