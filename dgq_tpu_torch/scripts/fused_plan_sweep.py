"""K4 and K5 under every plan that ``fused_plan`` chooses among, timed on
the card.

``fused_plan`` (``ops/fused_decode.py``) gives the fused decode GEMVs K4
(``fused_norm_gemv_rp``, the q|k|v linear) and K5 (``fused_requant_gemv_rp``,
o_proj and its residual) a cluster of column tiles and a K split by a cost
model whose constants were fitted to these times.  For each row count, at
LLaMA-2-7B's widths and one group size, this script launches every plan of
``fused_candidates`` through ``launch_rowpair``, holds its output equal bit
for bit to the chosen plan's (the splits are summed in int32 before the
epilogue, so the plan moves no bit), and prints one JSON line a plan: the
plan, its device time from CUDA events (both kernels of a split call, each
call after an L2 flush, less the flushes alone) and whether ``fused_plan``
chose it.  Then the card's name and power limit, as nvidia-smi gives them.

Run: ``python -m dgq_tpu_torch.scripts.fused_plan_sweep [--rows 4 40]
[--groupsize 128]`` on the card (the kernels have no CPU version).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops import fused_decode as fd

D, QKV = 4096, 12288  # LLaMA-2-7B: hidden width, q|k|v outputs


def _inputs(name: str, m: int, gs: int, gen: torch.Generator, dev):
    """(n, k, the C entry point's arguments up to codes_out, out, the
    tensors those arguments point into) of K4 or K5 at m rows: random
    rowpair bytes, compact plane rows with scales in [1, 4) and zeros in
    [4, 12) (as the synthetic engines draw them)."""
    n, k = (QKV, D) if name == fd.NORM else (D, D)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)

    qw = ri(-128, 128, (k // 2, n))
    planes = [ri(lo, hi, (k // gs // 2, n)) for lo, hi in ((1, 4), (1, 4), (4, 12), (4, 12))]
    alpha = torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-5
    x = torch.randn((m, k), generator=gen, device=dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    if name == fd.NORM:
        lnw = torch.full((k,), 10.0, device=dev)
        head = (p(x), p(lnw), None, 1e-5, p(qw), *map(p, planes), p(alpha), None, p(out), None)
        keep = (x, lnw)
    else:
        scale = torch.full((1,), 0.05, device=dev)
        res = torch.randn((m, n), generator=gen, device=dev)
        head = (p(x), p(scale), -127.0, p(qw), *map(p, planes), p(alpha), None, p(res), p(out),
                None)
        keep = (x, scale, res)
    return n, k, head, out, (qw, planes, alpha, keep)


def _device_ms(fn, flush: torch.Tensor, iters: int) -> float:
    """Device milliseconds a call of ``fn``, from CUDA events alone:
    ``iters`` calls, each after an L2 flush, less the same flushes without
    the calls.  The flushes keep the card busier than the host's launches,
    so host gaps stay out of the difference.  (torch.profiler loses its
    records after some tens of traces in one process.)"""
    fn()

    def run(call: bool) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            flush.zero_()
            if call:
                fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return (run(True) - run(False)) / iters


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 40])
    ap.add_argument("--groupsize", type=int, default=128)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_plan_sweep: no CUDA device (K4 and K5 run on the card only)")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for m in args.rows:
        for name in (fd.NORM, fd.REQUANT):
            gs = args.groupsize
            n, k, head, out, alive = _inputs(name, m, gs, gen, dev)
            chosen = fd.fused_plan(m, n, k, gs, sms, name == fd.NORM)
            fd.launch_rowpair(name, chosen, head, m, n, k, gs, dev)
            want = out.clone()
            for plan in fd.fused_candidates(m, n, k, gs):
                def call(plan=plan):
                    fd.launch_rowpair(name, plan, head, m, n, k, gs, dev)

                out.zero_()
                call()
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} M={m}: {plan} differs from {chosen}")
                row = {"kernel": name, "M": m, "N": n, "K": k, "groupsize": gs,
                       **plan._asdict(), "ms": _device_ms(call, flush, args.iters),
                       "chosen": plan == chosen}
                print(json.dumps(row), flush=True)
                rows.append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return rows


if __name__ == "__main__":
    main()
