"""K4, K5 and K6's two legs, or K12's norm and requant entries, under every
plan that ``fused_plan`` chooses among, timed on the card.

``fused_plan`` (``ops/fused_decode.py``) gives the fused decode GEMVs K4
(``fused_norm_gemv_rp``, the q|k|v linear) and K5 (``fused_requant_gemv_rp``,
o_proj and its residual) a cluster of column tiles and a K split by a cost
model whose constants were fitted to these times; ``mlp_plan`` gives K6
(``fused_mlp_decode_rp``) the same model's plans for its gate|up leg (K4's
product at N = 2F) and its down leg (K5's at K = F); with ``--span``, K12's
norm and requant entries (``fused_norm_gemv``, ``fused_requant_gemv``: K4's
and K5's kernel on span bytes, whose K splits hold whole spans) take the
same model's plans among ``fused_candidates(..., "span")``.  For each row
count, at LLaMA-2-7B's widths and one group size, this script launches
every plan of ``fused_candidates`` through ``launch_gemv`` (K6: every plan
of one leg with the other leg's chosen plan, through ``launch_mlp_rp``),
holds its
output equal bit for bit to the chosen plan's (the splits are summed in
int32 before the epilogue, so the plan moves no bit), and prints one JSON
line a plan: the plan, its device time from CUDA events (every kernel of
the call, each call after FLUSHES passes of an L2 flush, less the flushes
alone; the median of READINGS readings) and whether the plan functions
chose it.  With ``--repeat R`` each cell first holds every plan R times
against the chosen plan (each round in a new random order, an L2 flush
before each call, every call's outputs compared; one JSON line a cell with
the calls per plan that differed, then an AssertionError if any did), which
is how a race between plans shows; ``--no-time`` stops there.  Then the
card's name and power limit, as nvidia-smi gives them.

Run: ``python -m dgq_tpu_torch.scripts.fused_plan_sweep [--rows 4 40]
[--groupsize 128] [--span] [--repeat R [--no-time]]`` on the card (the
kernels have no CPU version).
"""

from __future__ import annotations

import argparse
import functools
import json
import random
import subprocess

import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops import fused_decode as fd

D, QKV, F = 4096, 12288, 11264  # LLaMA-2-7B: hidden width, q|k|v outputs, padded MLP width
# passes of the 128 MB flush before each call: enough card time (~40 us a pass on an H100)
# that the host's launch of the next call (~40 us of Python) never leaves the card idle; with
# one pass the host's gaps entered the 12 us o_proj calls' times (up to 1.3x the profiler's)
FLUSHES = 3
# readings a plan, of which the median is kept: one reading gave outliers both ways (2-3x)
READINGS = 3


def _inputs(name: str, m: int, gs: int, gen: torch.Generator, dev):
    """(n, k, the C entry point's arguments up to codes_out, out, the
    tensors those arguments point into) of K4 or K5 (or K12's norm or
    requant entry) at m rows: random packed bytes (either layout), compact
    plane rows with scales in [1, 4) and zeros in [4, 12) (as the synthetic
    engines draw them)."""
    norm = name in (fd.NORM, fd.NORM_SPAN)
    n, k = (QKV, D) if norm else (D, D)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)

    qw = ri(-128, 128, (k // 2, n))
    planes = [ri(lo, hi, (k // gs // 2, n)) for lo, hi in ((1, 4), (1, 4), (4, 12), (4, 12))]
    alpha = torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-5
    x = torch.randn((m, k), generator=gen, device=dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    if norm:
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
    ``iters`` calls, each after FLUSHES passes of an L2 flush, less the same
    flushes without the calls, the median of READINGS such readings.  The
    flushes keep the card busier than the host's launches, so host gaps stay
    out of the difference.  (torch.profiler loses its records after some
    tens of traces in one process.)"""
    fn()

    def run(call: bool) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            for _ in range(FLUSHES):
                flush.zero_()
            if call:
                fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    readings = sorted((run(True) - run(False)) / iters for _ in range(READINGS))
    return readings[READINGS // 2]


def _hold(calls: dict, outs, wants, rounds: int, flush: torch.Tensor, rng) -> dict:
    """Each plan's call (``calls``: plan -> call) ``rounds`` times, the plans
    in a new random order each round and an L2 flush before each call, its
    outputs compared with the chosen plan's (``wants``) after every call:
    the calls per plan whose outputs differed."""
    bad = {plan: torch.zeros((), dtype=torch.int64, device=flush.device) for plan in calls}
    for _ in range(rounds):
        order = list(calls)
        rng.shuffle(order)
        for plan in order:
            flush.zero_()
            for o in outs:
                o.zero_()
            calls[plan]()
            for o, w in zip(outs, wants):
                bad[plan] += (o != w).any()
    return {f"c{p.cluster}s{p.splits}": int(v) for p, v in bad.items()}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 40])
    ap.add_argument("--groupsize", type=int, default=128)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--span", action="store_true",
                    help="K12's norm and requant entries on span bytes (no K6)")
    ap.add_argument("--repeat", type=int, default=0,
                    help="first hold every plan this many times against the chosen plan")
    ap.add_argument("--no-time", action="store_true", help="hold the plans, time none")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_plan_sweep: no CUDA device (K4-K6 run on the card only)")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = random.Random(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    def hold(what: dict, calls: dict, outs, wants):
        if args.repeat:
            bad = _hold(calls, outs, wants, args.repeat, flush, rng)
            emit({**what, "repeat": args.repeat, "mismatches": bad})
            if any(bad.values()):
                raise AssertionError(f"{what}: plans differ from the chosen plan: {bad}")

    layout = "span" if args.span else "rowpair"
    names = (fd.NORM_SPAN, fd.REQUANT_SPAN) if args.span else (fd.NORM, fd.REQUANT)
    for m in args.rows:
        gs = args.groupsize
        for name in names:
            n, k, head, out, alive = _inputs(name, m, gs, gen, dev)
            chosen = fd.fused_plan(m, n, k, gs, sms, name == names[0], layout)
            fd.launch_gemv(name, chosen, head, m, n, k, gs, dev)
            want = out.clone()
            calls = {plan: functools.partial(fd.launch_gemv, name, plan, head, m, n, k, gs, dev)
                     for plan in fd.fused_candidates(m, n, k, gs, layout)}
            hold({"kernel": name, "M": m, "groupsize": gs}, calls, [out], [want])
            for plan, call in calls.items() if not args.no_time else ():
                out.zero_()
                call()
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} M={m}: {plan} differs from {chosen}")
                emit({"kernel": name, "M": m, "N": n, "K": k, "groupsize": gs,
                      **plan._asdict(), "ms": _device_ms(call, flush, args.iters),
                      "chosen": plan == chosen})
        if args.span:
            continue
        # K6: each leg's every plan, the other leg at its chosen plan
        head, out, alive = _mlp_inputs(m, gs, gen, dev)
        h = alive[-1]
        chosen = fd.mlp_plan(m, D, F, gs, sms)
        fd.launch_mlp_rp(chosen, head, m, D, F, gs, dev)
        want, want_h = out.clone(), h.clone()
        for leg, (n, k) in enumerate(((2 * F, D), (D, F))):
            calls = {plan: functools.partial(fd.launch_mlp_rp,
                                             (plan, chosen[1]) if leg == 0 else (chosen[0], plan),
                                             head, m, D, F, gs, dev)
                     for plan in fd.fused_candidates(m, n, k, gs)}
            leg_name = ("gate_up", "down")[leg]
            hold({"kernel": fd.MLP, "leg": leg_name, "M": m, "groupsize": gs}, calls, [h, out],
                 [want_h, want])
            for plan, call in calls.items() if not args.no_time else ():
                out.zero_()
                call()
                if not torch.equal(out, want):
                    raise AssertionError(f"K6 M={m} leg {leg}: {plan} differs from {chosen}")
                emit({"kernel": fd.MLP, "leg": leg_name, "M": m, "N": n, "K": k,
                      "groupsize": gs, **plan._asdict(), "ms": _device_ms(call, flush, args.iters),
                      "chosen": plan == chosen[leg]})
        del alive
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return rows


if __name__ == "__main__":
    main()
