"""P2, the raw int8 GEMV engines at decode shapes (M = 8, K 4096, N 12288).

Port of ``scripts/probe_gemv_engines.py``, whose kernels set the TPU's
matrix unit against its vector unit.  Hopper's analogues are its tensor
cores and its CUDA cores, the engines the fused decode kernels K4-K6 and
K12 choose between; one source, ``csrc/int8_gemv_engines.cu``:

  * ``mxu_gemv``: every row on the tensor cores (mma.sync, the 8 rows padded
    to 16 in registers);
  * ``vpu_gemv``: row 0 on the CUDA cores (``__dp4a``);
  * ``mix_gemv``: columns [0, nm) on the tensor cores for every row and [nm,
    N) with dp4a for row 0, in one launch: do the engines overlap?

Rates are in G weight elements a second, the figure of merit of a decode
step that streams its weights once.  ``torch._int_mm`` (rows padded to 32)
is the library's yardstick.

Run: ``python -m dgq_tpu_torch.scripts.probe_gemv_engines`` on the card, or
with ``--cpu`` at K 256, N 1024 on the plain versions (host times).
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops.quant_matmul import int_matmul
from dgq_tpu_torch.scripts.roofline_probe import column_major
from dgq_tpu_torch.utils.benchmarking import device_time

K, N, B = 4096, 12288, 8
MXU, VPU, MIX = "mxu_gemv", "vpu_gemv", "mix_gemv"
_SIGNATURES = {
    "mxu_gemv": [_cuda.VP] * 3 + [_cuda.INT] * 4 + [_cuda.VP],
    "vpu_gemv": [_cuda.VP] * 3 + [_cuda.INT] * 3 + [_cuda.VP],
    "mix_gemv": [_cuda.VP] * 4 + [_cuda.INT] * 5 + [_cuda.VP],
}
BLOCKS_PER_SM = 8  # the K split's target: enough weight loads in flight


def k_split(n: int, k: int, device) -> int:
    """Blocks over K per 64-column block: about BLOCKS_PER_SM blocks an SM,
    at most one per 128-row chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(k // 128, -(-BLOCKS_PER_SM * sms // (n // 64))))


def mix_split(n: int, frac: float) -> int:
    """Columns on the tensor cores: JAX's ``int(N * frac / 256) * 256``."""
    return int(n * frac / 256) * 256


def mxu_gemv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return int_matmul(x, w)


def vpu_gemv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return int_matmul(x[:1], w)


def mix_gemv_plain(x: torch.Tensor, w: torch.Tensor,
                   frac: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    nm = mix_split(w.shape[1], frac)
    return int_matmul(x, w[:, :nm]), int_matmul(x[:1], w[:, nm:])


def _check(x: torch.Tensor, w: torch.Tensor, what: str):
    m, k = x.shape
    k2, n = w.shape
    if k2 != k or m > 16:
        raise ValueError(f"{what}: x {tuple(x.shape)} (at most 16 rows), w {tuple(w.shape)}")
    dev = x.device
    _cuda.require(x, "x", torch.int8, (m, k), dev)
    _cuda.require(w, "w", torch.int8, (k, n), dev)
    if n % 64 or k % 128:
        raise ValueError(f"{what} needs N % 64 == 0 and K % 128 == 0; got N={n}, K={k}")
    return m, k, n, dev, _cuda.library(_cuda.SOURCES[what], _SIGNATURES)


def mxu_gemv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M <= 16, K) int8 . (K, N) int8 -> (M, N) int32 on the tensor cores.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return mxu_gemv_plain(x, w)
    m, k, n, dev, lib = _check(x, w, MXU)
    ks = k_split(n, k, dev)
    out = (torch.zeros if ks > 1 else torch.empty)((m, n), dtype=torch.int32, device=dev)
    _cuda.check(lib.mxu_gemv(_cuda.ptr(x), _cuda.ptr(w), _cuda.ptr(out), m, n, k, ks,
                             _cuda.stream(dev)), MXU)
    _cuda.count_launch(MXU)
    return out


def vpu_gemv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Row 0 of x . (K, N) int8 -> (1, N) int32 on the CUDA cores (dp4a)."""
    if x.device.type == "cpu":
        return vpu_gemv_plain(x, w)
    _, k, n, dev, lib = _check(x, w, VPU)
    ks = k_split(n, k, dev)
    out = (torch.zeros if ks > 1 else torch.empty)((1, n), dtype=torch.int32, device=dev)
    _cuda.check(lib.vpu_gemv(_cuda.ptr(x), _cuda.ptr(w), _cuda.ptr(out), n, k, ks,
                             _cuda.stream(dev)), VPU)
    _cuda.count_launch(VPU)
    return out


def mix_gemv(x: torch.Tensor, w: torch.Tensor,
             frac: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """((M, nm) int32 of x . w[:, :nm], (1, N - nm) int32 of x[:1] . w[:, nm:])
    in one launch, nm = ``mix_split(N, frac)``."""
    if x.device.type == "cpu":
        return mix_gemv_plain(x, w, frac)
    m, k, n, dev, lib = _check(x, w, MIX)
    nm = mix_split(n, frac)
    ks = k_split(n, k, dev)
    alloc = torch.zeros if ks > 1 else torch.empty
    om = alloc((m, nm), dtype=torch.int32, device=dev)
    ov = alloc((1, n - nm), dtype=torch.int32, device=dev)
    _cuda.check(lib.mix_gemv(_cuda.ptr(x), _cuda.ptr(w), _cuda.ptr(om), _cuda.ptr(ov), m, n, k,
                             nm, ks, _cuda.stream(dev)), MIX)
    _cuda.count_launch(MIX)
    return om, ov


def int_mm_rows32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The library yardstick: ``torch._int_mm`` with x padded to 32 rows
    (give it w column-major, the layout cuBLASLt's int8 kernels take)."""
    xp = torch.cat([x, x.new_zeros((32 - x.shape[0], x.shape[1]))]) if x.shape[0] < 32 else x
    return torch._int_mm(xp, w)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="K 256, N 1024 on the plain versions")
    ap.add_argument("--reps", type=int, default=3, help="round-robin passes")
    ap.add_argument("--iters", type=int, default=48, help="long chain length (short: a quarter)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("probe_gemv_engines: no CUDA device (torch.cuda.is_available() is "
                         "false); pass --cpu for the plain versions")
    dev = "cpu" if args.cpu else "cuda"
    k, n = (256, 1024) if args.cpu else (K, N)
    r = np.random.default_rng(0)
    w = torch.from_numpy(r.integers(-127, 127, (k, n)).astype(np.int8)).to(dev)
    x = torch.from_numpy(r.integers(-127, 127, (B, k)).astype(np.int8)).to(dev)
    wc = column_major(w)

    def fb(out, xin):
        lead = out[0] if isinstance(out, (list, tuple)) else out
        return (lead[:1, :k].to(torch.int32) & 0x7F).to(torch.int8) + xin * 0

    cands = (
        ("mxu (tensor cores)", lambda a: mxu_gemv(a, w)),
        ("vpu (dp4a, row 0) ", lambda a: vpu_gemv(a, w)),
        ("mix 50/50         ", lambda a: mix_gemv(a, w)),
        ("mix 2/3 mxu       ", lambda a: mix_gemv(a, w, frac=0.67)),
        ("torch._int_mm rows 32", lambda a: int_mm_rows32(a, wc)),
    )
    best = {}
    for rep in range(args.reps):
        for name, f in cands:
            t = device_time(f, x, feedback=fb, iters=args.iters,
                            base_iters=max(1, args.iters // 4), repeats=2)
            best[name.strip()] = min(best.get(name.strip(), float("inf")), t)
            print(f"[{rep}] {name}: {t * 1e6:9.2f} us -> {k * n / t / 1e9:7.1f} G elem/s "
                  f"({t.clock})", flush=True)
    return {"best_s": best}


if __name__ == "__main__":
    main()
