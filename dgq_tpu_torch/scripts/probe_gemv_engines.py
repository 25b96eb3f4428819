"""P2, the raw int8 GEMV engines at decode shapes (M = 8, K 4096, N 12288).

Port of ``scripts/probe_gemv_engines.py``, whose kernels set the TPU's
matrix unit against its vector unit.  Hopper's analogues are its tensor
cores and its CUDA cores, the engines the fused decode kernels K4-K6 and
K12 choose between; one source, ``csrc/int8_gemv_engines.cu``:

  * ``mxu_gemv``: every row on the tensor cores (wgmma, the 8 rows as its
    B operand);
  * ``vpu_gemv``: row 0 on the CUDA cores (``__dp4a``);
  * ``mix_gemv``: columns [0, nm) on the tensor cores for every row and [nm,
    N) with dp4a for row 0, in one launch: do the engines overlap?

What bounds them is the weight bytes, and they stream them on the loop of
K4-K6 and K12 (``csrc/fused_gemv_sm90.cuh``: a TMA ring, x's rows by TMA as
the codes, the int8 Loader ``FusedS8``) with no unpack, no codes to make
and no epilogue: P2 is the ceiling that loop can reach at a decode shape.
The plan (``gemv_plan``: the K split, whose int32 partials a second kernel
sums) is the most splits whose blocks all run at once, so that every SM
streams about the same bytes: four at P2's shape, which a sweep of
``gemv_candidates`` on the card (``chip_smoke.py``'s probes phase) found
within a few percent of each engine's fastest plan.

Rates are in G weight elements a second, the figure of merit of a decode
step that streams its weights once.  ``torch._int_mm`` (rows padded to 32)
is the library's yardstick.  On the card each call is timed alone after an
L2 flush (``flushed_seconds``): at about 20 us a call, a chain of calls
would time the host's launches; with ``--cpu`` the chain runs on the host.

Run: ``python -m dgq_tpu_torch.scripts.probe_gemv_engines`` on the card, or
with ``--cpu`` at K 256, N 1024 on the plain versions (host times).
"""

from __future__ import annotations

import argparse
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops.fused_decode import SMEM_LIMIT, SMEM_PER_SM, fused_smem
from dgq_tpu_torch.ops.quant_matmul import int_matmul
from dgq_tpu_torch.scripts.roofline_probe import column_major
from dgq_tpu_torch.utils.benchmarking import device_time, flushed_seconds

K, N, B = 4096, 12288, 8
MXU, VPU, MIX = "mxu_gemv", "vpu_gemv", "mix_gemv"
_SIGNATURES = {
    "mxu_gemv": [_cuda.VP] * 4 + [_cuda.INT] * 5 + [_cuda.VP],
    "vpu_gemv": [_cuda.VP] * 4 + [_cuda.INT] * 4 + [_cuda.VP],
    "mix_gemv": [_cuda.VP] * 6 + [_cuda.INT] * 6 + [_cuda.VP],
}
# the kernels' shape: one tile of 8 token rows (wgmma N), 128 columns a block,
# stages of 128 int8 rows (``FusedS8``'s 16 KB, in the fused body's ring of 4)
GEMV_BM, GEMV_BN, GEMV_STAGE_K = 8, 128, 128
GEMV_STAGE_BYTES = GEMV_STAGE_K * GEMV_BN
GEMV_SPLITS = (1, 2, 4, 8)  # at most 8: the kernel that sums them
GEMV_MAX_PER_SM = 3  # __launch_bounds__(F_THREADS, 3): registers for three blocks an SM


class GemvPlan(NamedTuple):
    """How P2 runs an (N, K) call: K in ``splits`` ranges of ``sps`` stages
    (whose int32 partials a second kernel sums); ``smem`` bytes of dynamic
    shared memory a block, ``per_sm`` blocks an SM."""
    splits: int
    sps: int
    smem: int
    per_sm: int


def gemv_smem(sps: int, bm: int = GEMV_BM, stage: int = GEMV_STAGE_BYTES) -> int:
    """A P2 block's dynamic shared memory (``fused_smem`` with FusedS8's
    stage), or P3's (``bm`` 16 token rows, FusedS4's ``stage`` of 8 KB)."""
    return fused_smem(bm, sps, stage)


def gemv_candidates(n: int, k: int, bm: int = GEMV_BM,
                    stage: int = GEMV_STAGE_BYTES) -> list:
    """Every plan P2 (or, at its ``bm`` and ``stage`` bytes, P3) can run an
    (N, K) call with: each K split of GEMV_SPLITS that divides the stages of
    K, whose shared memory fits, in that order."""
    if n <= 0 or k <= 0 or n % GEMV_BN or k % GEMV_STAGE_K:
        raise ValueError(f"P2 needs N % {GEMV_BN} == 0 and K % {GEMV_STAGE_K} == 0; "
                         f"got N={n}, K={k}")
    stages = k // GEMV_STAGE_K
    plans = []
    for splits in GEMV_SPLITS:
        if stages % splits:
            continue
        sps = stages // splits
        smem = gemv_smem(sps, bm, stage)
        per_sm = min(GEMV_MAX_PER_SM, SMEM_PER_SM // (smem + 1024))
        if smem <= SMEM_LIMIT and per_sm:
            plans.append(GemvPlan(splits, sps, smem, per_sm))
    return plans


@functools.lru_cache(maxsize=256)
def gemv_plan(n: int, k: int, sms: int, bm: int = GEMV_BM,
              stage: int = GEMV_STAGE_BYTES) -> GemvPlan:
    """P2's plan for an (N, K) call on a card with ``sms`` SMs (P3's at its
    ``bm`` and ``stage``): of ``gemv_candidates``, the most splits whose
    blocks all run at once (one wave of ``per_sm`` blocks an SM), else the
    fewest."""
    plans = gemv_candidates(n, k, bm, stage)
    one_wave = [p for p in plans if n // GEMV_BN * p.splits <= sms * p.per_sm]
    return one_wave[-1] if one_wave else plans[0]


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


def launch_shape(x_shape, w_shape, nm: Optional[int] = None) -> Tuple[int, int, int]:
    """(M, K, N) of a call with x (M, K) and w (K, N), and the tensor-core
    columns nm of a mix, as the C entry points take them; raises
    ValueError on what they reject: rows over the 8-row tile, N or nm off
    the 128-column tile, K off the 128-k stage."""
    m, k = x_shape
    k2, n = w_shape
    if k2 != k or not 1 <= m <= GEMV_BM:
        raise ValueError(f"P2: x {tuple(x_shape)} (1 to {GEMV_BM} rows), w {tuple(w_shape)}")
    if n <= 0 or k <= 0 or n % GEMV_BN or k % GEMV_STAGE_K:
        raise ValueError(f"P2 needs N % {GEMV_BN} == 0 and K % {GEMV_STAGE_K} == 0; "
                         f"got N={n}, K={k}")
    if nm is not None and (nm % GEMV_BN or not 0 <= nm <= n):
        raise ValueError(f"P2's mix needs nm % {GEMV_BN} == 0 in [0, N]; got nm={nm}, N={n}")
    return m, k, n


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x: torch.Tensor, w: torch.Tensor, what: str, nm: Optional[int] = None):
    m, k, n = launch_shape(x.shape, w.shape, nm)
    dev = x.device
    _cuda.require(x, "x", torch.int8, (m, k), dev)
    _cuda.require(w, "w", torch.int8, (k, n), dev)
    return m, k, n, dev, _cuda.library(_cuda.SOURCES[what], _SIGNATURES)


def _part(plan: GemvPlan, rows: int, cols: int, dev) -> Optional[torch.Tensor]:
    """The (splits, rows, cols) int32 partials of a K split, or None."""
    if plan.splits == 1 or cols == 0:
        return None
    return torch.empty((plan.splits, rows, cols), dtype=torch.int32, device=dev)


def _launch(lib, what: str, plan: GemvPlan, dev, ptrs, ints) -> None:
    """One call of the C entry point ``what``: the tensors' pointers, the
    shapes, the plan, the stream; then count the launch."""
    _cuda.check(getattr(lib, what)(*ptrs, *ints, plan.splits, plan.sps, _cuda.stream(dev)),
                what)
    _cuda.count_launch(what)


def mxu_gemv(x: torch.Tensor, w: torch.Tensor, plan: Optional[GemvPlan] = None) -> torch.Tensor:
    """(M <= 8, K) int8 . (K, N) int8 -> (M, N) int32 on the tensor cores,
    under ``plan`` (default ``gemv_plan``).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return mxu_gemv_plain(x, w)
    m, k, n, dev, lib = _check(x, w, MXU)
    plan = plan or gemv_plan(n, k, _sms(dev))
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    part = _part(plan, m, n, dev)
    _launch(lib, MXU, plan, dev, (_cuda.ptr(x), _cuda.ptr(w), _cuda.ptr(out), _cuda.ptr(part)),
            (m, n, k))
    return out


def vpu_gemv(x: torch.Tensor, w: torch.Tensor, plan: Optional[GemvPlan] = None) -> torch.Tensor:
    """Row 0 of x . (K, N) int8 -> (1, N) int32 on the CUDA cores (dp4a)."""
    if x.device.type == "cpu":
        return vpu_gemv_plain(x, w)
    _, k, n, dev, lib = _check(x, w, VPU)
    plan = plan or gemv_plan(n, k, _sms(dev))
    out = torch.empty((1, n), dtype=torch.int32, device=dev)
    part = _part(plan, 1, n, dev)
    _launch(lib, VPU, plan, dev, (_cuda.ptr(x), _cuda.ptr(w), _cuda.ptr(out), _cuda.ptr(part)),
            (n, k))
    return out


def mix_gemv(x: torch.Tensor, w: torch.Tensor, frac: float = 0.5,
             plan: Optional[GemvPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """((M, nm) int32 of x . w[:, :nm], (1, N - nm) int32 of x[:1] . w[:, nm:])
    in one launch, nm = ``mix_split(N, frac)``."""
    if x.device.type == "cpu":
        return mix_gemv_plain(x, w, frac)
    nm = mix_split(w.shape[1], frac)
    m, k, n, dev, lib = _check(x, w, MIX, nm)
    plan = plan or gemv_plan(n, k, _sms(dev))
    om = torch.empty((m, nm), dtype=torch.int32, device=dev)
    ov = torch.empty((1, n - nm), dtype=torch.int32, device=dev)
    pm, pv = _part(plan, m, nm, dev), _part(plan, 1, n - nm, dev)
    _launch(lib, MIX, plan, dev, (_cuda.ptr(x), _cuda.ptr(w), _cuda.ptr(om), _cuda.ptr(ov),
                                  _cuda.ptr(pm), _cuda.ptr(pv)), (m, n, k, nm))
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
    ap.add_argument("--iters", type=int, default=48,
                    help="calls a reading on the card; on the CPU the long chain's length "
                         "(short: a quarter)")
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
    # on the card a call is shorter than the host's launch of it: each call is
    # timed alone, after an L2 flush
    flush = None if args.cpu else torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    best = {}
    for rep in range(args.reps):
        for name, f in cands:
            if flush is not None:
                t = flushed_seconds(lambda f=f: f(x), flush, args.iters)
            else:
                t = device_time(f, x, feedback=fb, iters=args.iters,
                                base_iters=max(1, args.iters // 4), repeats=2)
            best[name.strip()] = min(best.get(name.strip(), float("inf")), t)
            print(f"[{rep}] {name}: {t * 1e6:9.2f} us -> {k * n / t / 1e9:7.1f} G elem/s "
                  f"({t.clock})", flush=True)
    if flush is not None:
        print(f"plan: {gemv_plan(n, k, _sms(torch.device(dev)))}", flush=True)
    return {"best_s": best}


if __name__ == "__main__":
    main()
