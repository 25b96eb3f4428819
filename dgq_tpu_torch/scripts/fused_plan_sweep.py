"""K4, K5 and K6's two legs under every plan that ``fused_plan`` chooses
among, timed on the card.

``fused_plan`` (``ops/fused_decode.py``) gives the fused decode GEMVs K4
(``fused_norm_gemv_rp``, the q|k|v linear) and K5 (``fused_requant_gemv_rp``,
o_proj and its residual) a cluster of column tiles and a K split by a cost
model whose constants were fitted to these times; ``mlp_plan`` gives K6
(``fused_mlp_decode_rp``) the same model's plans for its gate|up leg (K4's
product at N = 2F) and its down leg (K5's at K = F).  For each row count, at
LLaMA-2-7B's widths and one group size, this script launches every plan of
``fused_candidates`` through ``launch_rowpair`` (K6: every plan of one leg
with the other leg's chosen plan, through ``launch_mlp_rp``), holds its
output equal bit for bit to the chosen plan's (the splits are summed in
int32 before the epilogue, so the plan moves no bit), and prints one JSON
line a plan: the plan, its device time from CUDA events (every kernel of
the call, each call after an L2 flush, less the flushes alone) and whether
the plan functions chose it.  Then the card's name and power limit, as
nvidia-smi gives them.

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

D, QKV, F = 4096, 12288, 11264  # LLaMA-2-7B: hidden width, q|k|v outputs, padded MLP width


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


def _mlp_inputs(m: int, gs: int, gen: torch.Generator, dev):
    """(the C entry point's arguments up to h_out, out, the tensors they
    point into) of K6 at m rows: gate|up and down weights drawn as
    ``_inputs`` draws them, the down scales 8x row-replicated."""
    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)

    gqw = ri(-128, 128, (D // 2, 2 * F))
    gplanes = [ri(lo, hi, (D // gs // 2, 2 * F)) for lo, hi in ((1, 4), (1, 4), (4, 12), (4, 12))]
    galpha = torch.rand((2 * F,), generator=gen, device=dev) * 1e-3 + 5e-4
    dqw = ri(-128, 128, (F // 2, D))
    dws = torch.repeat_interleave(ri(1, 4, (F // gs, D)), 8, dim=0)
    dwz = torch.repeat_interleave(ri(4, 12, (F // gs, D)), 8, dim=0)
    dalpha = torch.rand((D,), generator=gen, device=dev) * 1e-3 + 1e-5
    x = torch.randn((m, D), generator=gen, device=dev)
    lnw = torch.full((D,), 10.0, device=dev)
    hscale = torch.full((1,), 0.5, device=dev)
    h = torch.empty((m, F), dtype=torch.int8, device=dev)
    out = torch.empty((m, D), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    head = (p(x), p(lnw), None, 1e-5, p(hscale), p(gqw), *map(p, gplanes), p(galpha), p(dqw),
            p(dws), p(dwz), p(dalpha), None, 1, p(out), None, p(h))
    return head, out, (gqw, gplanes, galpha, dqw, dws, dwz, dalpha, x, lnw, hscale, h)


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
        raise SystemExit("fused_plan_sweep: no CUDA device (K4-K6 run on the card only)")
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
        # K6: each leg's every plan, the other leg at its chosen plan
        gs = args.groupsize
        head, out, alive = _mlp_inputs(m, gs, gen, dev)
        chosen = fd.mlp_plan(m, D, F, gs, sms)
        fd.launch_mlp_rp(chosen, head, m, D, F, gs, dev)
        want = out.clone()
        for leg, (n, k) in enumerate(((2 * F, D), (D, F))):
            for plan in fd.fused_candidates(m, n, k, gs):
                plans = (plan, chosen[1]) if leg == 0 else (chosen[0], plan)

                def call(plans=plans):
                    fd.launch_mlp_rp(plans, head, m, D, F, gs, dev)

                out.zero_()
                call()
                if not torch.equal(out, want):
                    raise AssertionError(f"K6 M={m} leg {leg}: {plan} differs from {chosen}")
                row = {"kernel": fd.MLP, "leg": ("gate_up", "down")[leg], "M": m, "N": n,
                       "K": k, "groupsize": gs, **plan._asdict(),
                       "ms": _device_ms(call, flush, args.iters), "chosen": plan == chosen[leg]}
                print(json.dumps(row), flush=True)
                rows.append(row)
        del alive
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return rows


if __name__ == "__main__":
    main()
