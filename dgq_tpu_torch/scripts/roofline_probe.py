"""P1, the INT8 ceiling probe: what share of the card's int8 peak can any
GEMM here reach?

Port of ``scripts/roofline_probe.py``.  At M = 2048, N = K = 4096 it pairs
each candidate with the fused W4A8 control K9 (``w4a8_matmul_packed``) in
turns and reports TOP/s, the share of the H100's 1979 TOP/s, and the median
ratio to the control:

  * ``s8_matmul``: a pure s8 GEMM (``csrc/s8_gemm.cu``, the TMA + wgmma
    main loop of K1 and K9 without the nibble unpack or dequantisation) at
    two tilings: if it matches the control, the unpack is hidden under the
    main loop and that loop is the gap to the peak;
  * ``torch._int_mm``, the library's s8 GEMM (in XLA's dot's place);
  * the fused rowpair control K1 (``w4a8_matmul_rp_pipe``).

Run: ``python -m dgq_tpu_torch.scripts.roofline_probe`` on the card, or
with ``--cpu`` at 256 x 256 x 256 on the plain versions (host times).
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops.fused_decode import pack_rowpair_s4
from dgq_tpu_torch.ops.quant_matmul import int_matmul, w4a8_matmul_packed, w4a8_matmul_rp_pipe
from dgq_tpu_torch.utils.benchmarking import gemm_tops
from dgq_tpu_torch.utils.profiling import H100_PEAK_INT8

M, N, K, G = 2048, 4096, 4096, 128
PEAK_TOPS = H100_PEAK_INT8 / 1e12
KERNEL = "s8_matmul"
# (bm, bn) -> the source's tiling index: K1's and K9's prefill tile, and a narrower one
TILINGS = {(256, 128): 0, (128, 128): 1}
_SIGNATURES = {"s8_gemm": [_cuda.VP] * 3 + [_cuda.INT] * 4 + [_cuda.VP]}


def s8_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 . (K, N) int8 -> (M, N) f32: the exact int32 product,
    rounded to f32 (half to even)."""
    return int_matmul(x, w).to(torch.float32)


def s8_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = 256, bn: int = 128) -> torch.Tensor:
    """P1: (M, K) int8 . (K, N) int8 -> (M, N) f32 through ``csrc/s8_gemm.cu``
    with (bm, bn) output tiles, one of ``TILINGS``.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    m, k = x.shape
    k2, n = w.shape
    if k2 != k:
        raise ValueError(f"shapes: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if (bm, bn) not in TILINGS:
        raise ValueError(f"tiling ({bm}, {bn}) is not one of {list(TILINGS)}")
    if x.device.type == "cpu":
        return s8_matmul_plain(x, w)
    dev = x.device
    _cuda.require(x, "x", torch.int8, (m, k), dev)
    _cuda.require(w, "w", torch.int8, (k, n), dev)
    if n % 16 or k % 128:
        raise ValueError(f"{KERNEL} needs N % 16 == 0 and K % 128 == 0; got N={n}, K={k}")
    lib = _cuda.library(_cuda.SOURCES[KERNEL], _SIGNATURES)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    rc = lib.s8_gemm(_cuda.ptr(x), _cuda.ptr(w), _cuda.ptr(out), m, n, k, TILINGS[(bm, bn)],
                     _cuda.stream(dev))
    _cuda.check(rc, KERNEL)
    _cuda.count_launch(KERNEL)
    return out


def column_major(w: torch.Tensor) -> torch.Tensor:
    """The same (K, N) matrix stored column-major, the layout cuBLASLt's int8
    kernels take."""
    return w.t().contiguous().t()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="256^3 on the plain versions, host clock")
    ap.add_argument("--pairs", type=int, default=4, help="rounds of candidate/control pairs")
    ap.add_argument("--iters", type=int, default=96, help="long chain length (short: a quarter)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("roofline_probe: no CUDA device (torch.cuda.is_available() is false); "
                         "pass --cpu for the plain versions")
    dev = "cpu" if args.cpu else "cuda"
    m, n, k = (256, 256, 256) if args.cpu else (M, N, K)
    rng = np.random.default_rng(0)

    def ri(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8)).to(dev)

    x = ri(-127, 128, (m, k))
    qw = ri(-128, 128, (k // 2, n))
    ws, wz = ri(1, 4, (k // G, n)), ri(0, 16, (k // G, n))
    al = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    w8 = ri(-127, 128, (k, n))
    qw_rp = pack_rowpair_s4(qw, 2 * G)
    kw = dict(iters=args.iters, base_iters=max(1, args.iters // 4), repeats=1,
              peak_tops=None if args.cpu else PEAK_TOPS)

    control = ("K9 w4a8_matmul_packed", w4a8_matmul_packed, (x, qw, ws, wz, al))
    cands = {
        "s8_matmul(256,128)": (functools.partial(s8_matmul, bm=256, bn=128), (x, w8)),
        "s8_matmul(128,128)": (functools.partial(s8_matmul, bm=128, bn=128), (x, w8)),
        "torch._int_mm": (torch._int_mm, (x, w8)),
        "torch._int_mm column-major": (torch._int_mm, (x, column_major(w8))),
        "K1 w4a8_matmul_rp_pipe": (
            lambda x_, *_: w4a8_matmul_rp_pipe(x_, qw_rp, ws, wz, al, groupsize=G), (x,)),
    }
    ratios = {name: [] for name in cands}
    best = {name: 0.0 for name in [*cands, control[0]]}
    for p in range(args.pairs):
        for name, (fn, fargs) in cands.items():
            _, t_ctrl = gemm_tops(control[1], control[2], m, n, k, **kw)
            dt, t_cand = gemm_tops(fn, fargs, m, n, k, **kw)
            ratios[name].append(t_cand / t_ctrl)
            best[name] = max(best[name], t_cand)
            best[control[0]] = max(best[control[0]], t_ctrl)
            print(f"pair {p} {name}: cand {t_cand:8.2f} ctrl {t_ctrl:8.2f} TOP/s "
                  f"ratio {t_cand / t_ctrl:.3f} ({dt.clock})", flush=True)
    print("\n== median paired ratio to the control, best TOP/s and share of "
          f"{PEAK_TOPS:.0f} TOP/s ==")
    for name, rs in ratios.items():
        med = sorted(rs)[len(rs) // 2]
        print(f"{name}: {med:.3f}x (spread {min(rs):.3f}-{max(rs):.3f}), best "
              f"{best[name]:.2f} TOP/s = {100 * best[name] / PEAK_TOPS:.1f}%")
    print(f"control {control[0]}: best {best[control[0]]:.2f} TOP/s = "
          f"{100 * best[control[0]] / PEAK_TOPS:.1f}%", flush=True)
    return {"best_tops": best, "median_ratio": {nm: sorted(rs)[len(rs) // 2]
                                                for nm, rs in ratios.items()}}


if __name__ == "__main__":
    main()
