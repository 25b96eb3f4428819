"""K8 (``int8_paged_decode_attention``) and K11 (``int4_paged_decode_attention``)
at every cluster size that ``paged_plan`` chooses among, and K3 on the
same cache, timed on the card.

The shapes are LLaMA-2-7B's paged decode step (32 query heads of 128, pages
of 128 positions, 16 pages a slot, 8 slots over a shuffled pool of 1 + 128
pages whose unused table entries point at the null page 0): K8's timed case
(lengths 1-2048 across page boundaries, MHA and GQA, quant_pv on and off),
the serving step (lengths 299-1398) and K11's case on INT4 nibble pages.
For each shape this script launches the kernel at every cluster of
``DECODE_CLUSTERS`` through ``_paged_launch``, holds each output against
the plain version (K8 within 1e-5, K11 within 1e-5 of its largest output)
and prints one JSON line a cluster: the kernel's device time from torch.profiler
(mean of ``--iters`` calls, each after an L2 flush of 128 MB of zeros, as
``chip_smoke.py`` times K8), the device time from CUDA events alone, both again
after a flush that reads 128 MB (``clean_``: the L2 left clean, as a decode
step's weight reads leave it; the zeros leave dirty lines that the call's
misses write back) and whether ``paged_plan`` chose it.
``--k3``: also K3 (``int8_decode_attention``) at every cluster of
``DECODE_CLUSTERS`` through ``_decode_launch`` on the INT8 shapes' cache
gathered dense, held within K3's gates.  ``--repeat R --no-time``: every
cluster R times in a new random order a round, an L2 flush before each
call, each output compared with that cluster's first output (a race shows
so).
Then the card's name and power limit, as nvidia-smi gives them.

Run: ``python -m dgq_tpu_torch.scripts.paged_plan_sweep [--iters 20] [--k3]``
on the card (the kernels have no CPU version).
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess

import numpy as np
import torch

from dgq_tpu_torch.ops import attention as att
from dgq_tpu_torch.utils.benchmarking import flushed_seconds

H, DH, PS, NPG, SLOTS = 32, 128, 128, 16, 8  # 7B heads, pages of 128, max_len 2048, 8 slots
K8_LENGTHS = (1, 127, 128, 129, 700, 1000, 1536, 2048)  # chip_smoke.py's K8 case
SERVE = (299, 1398, 650, 1020, 812, 455, 1203, 977)  # 8 serving slots
# (name, kv heads, lengths, quant_pv, nibble pages)
SHAPES = (("k8", 32, K8_LENGTHS, True, False), ("k8_fp", 32, K8_LENGTHS, False, False),
          ("k8_gqa", 8, K8_LENGTHS, True, False), ("k8_serve", 32, SERVE, True, False),
          ("k11", 32, K8_LENGTHS, False, True), ("k11_gqa", 8, K8_LENGTHS, False, True),
          ("k11_serve", 32, SERVE, False, True))
PAGED_NAMES = ("paged_attn_cluster",)  # K8's and K11's kernel
K3_NAMES = ("decode_attn_cluster",)


def paged_table(lengths, npg: int, ps: int, seed: int) -> np.ndarray:
    """A (slots, npg) int32 table of distinct shuffled pool pages 1.. for the
    pages each length needs (an inactive slot's length may run past the
    table); the entries past them point at null page 0."""
    need = [min(-(-n // ps), npg) for n in lengths]
    perm = np.random.default_rng(seed).permutation(np.arange(1, 1 + len(lengths) * npg))
    table = np.zeros((len(lengths), npg), np.int32)
    k = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[k:k + n]
        k += n
    return table


def _flush(flush: torch.Tensor, clean: bool) -> None:
    """The L2 flush: 128 MB of zeros written, which leaves the L2 full of
    dirty lines that the call's misses write back, or (``clean``) 128 MB
    read, which leaves it clean, as a decode step's weight reads do."""
    if clean:
        flush.view(torch.int64).sum()
    else:
        flush.zero_()


def _events_ms(fn, flush: torch.Tensor, iters: int, clean: bool) -> float:
    """Device milliseconds a call from CUDA events alone: ``iters`` calls,
    each after a flush, less the same flushes without the calls (the
    chained launches' overlap counted once)."""
    if not clean:
        return 1e3 * flushed_seconds(fn, flush, iters)
    fn()

    def run(call: bool) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            _flush(flush, True)
            if call:
                fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return sorted((run(True) - run(False)) / iters for _ in range(3))[1]


def _kernel_ms(fn, names, flush: torch.Tensor, iters: int, clean: bool = False,
               attempts: int = 3) -> float:
    """Mean device milliseconds of the kernels whose names hold one of
    ``names`` over ``iters`` calls of ``fn``, each after an L2 flush, from
    torch.profiler; a trace that records no device time of them (seen on
    the card) is taken again, up to ``attempts`` times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                _flush(flush, clean)
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                 for e in prof.key_averages() if any(n in e.key for n in names))
        if us > 0:
            return us / iters / 1e3
    raise RuntimeError(f"torch.profiler saw no device time of {names}")


def _k3_gate(got, ref, quant_pv: bool, what: str) -> None:
    if quant_pv:
        rel = ((got - ref).norm() / ref.norm()).item()
        if not rel < 1e-3:
            raise AssertionError(f"{what}: relative L2 error {rel}")
    else:
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4, msg=what)


def _shape_inputs(hk, lens, kv4, gen, dev, seed):
    b = len(lens)
    pages = 1 + b * NPG

    def ri(lo, shape):
        return torch.randint(lo, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    q = ri(-127, (b, H, DH))
    if kv4:  # random bytes: two signed int4 codes each
        kt_pool, v_pool = ri(-128, (pages, hk, DH // 2, PS)), ri(-128, (pages, hk, PS, DH // 2))
    else:
        kt_pool, v_pool = ri(-127, (pages, hk, DH, PS)), ri(-127, (pages, hk, PS, DH))
    qs, ks, vs = (torch.rand((), generator=gen, device=dev) * 0.02 + 0.01 for _ in range(3))
    if kv4:  # the caller's effective int4 scales (int8 scales x 127 / 7)
        ks, vs = ks * 127 / 7, vs * 127 / 7
    table = torch.from_numpy(paged_table(lens, NPG, PS, seed)).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kt_pool, v_pool, table, lengths, (qs, ks, vs)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--k3", action="store_true",
                    help="also K3 at every cluster on the INT8 shapes' cache gathered dense")
    ap.add_argument("--shapes", nargs="+", default=[s[0] for s in SHAPES],
                    choices=[s[0] for s in SHAPES])
    ap.add_argument("--repeat", type=int, default=0,
                    help="hold every cluster this many times against its first output")
    ap.add_argument("--no-time", action="store_true", help="hold the clusters, time none")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("paged_plan_sweep: no CUDA device (K8 and K11 run on the card only)")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = random.Random(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    for i, (name, hk, lens, quant_pv, kv4) in enumerate(SHAPES):
        if name not in args.shapes:
            continue
        q, kt_pool, v_pool, table, lengths, (qs, ks, vs) = _shape_inputs(hk, lens, kv4, gen,
                                                                         dev, seed=8 + i)
        b = len(lens)
        what = {"shape": name, "B": b, "H": H, "Hkv": hk, "Dh": DH, "page": PS,
                "table_width": NPG, "lengths": list(lens), "quant_pv": quant_pv, "kv4": kv4}
        if kv4:
            ref = att.int4_paged_decode_attention_xla(q, kt_pool, v_pool, table, lengths, qs, ks,
                                                      vs)
            tol = 1e-5 * ref.abs().max().item()
        else:
            ref = att.int8_paged_decode_attention_xla(q, kt_pool, v_pool, table, lengths, qs,
                                                      ks, vs, quant_pv=quant_pv)
            tol = 1e-5
        scales = att._kernel_scales(qs, ks, vs, DH, True)
        chosen = att.paged_plan(b, hk, H // hk, DH, NPG, PS, sms, kv4)
        calls = {}
        for c in att.DECODE_CLUSTERS:
            def call(c=c):
                return att._paged_launch(q, kt_pool, v_pool, table, lengths, scales, quant_pv,
                                         kv4, c)

            err = (call() - ref).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{name} cluster {c}: max abs err {err} > {tol}")
            calls[c] = call
        if args.repeat:
            firsts = {c: call().clone() for c, call in calls.items()}
            bad = {c: 0 for c in calls}
            for _ in range(args.repeat):
                order = list(calls)
                rng.shuffle(order)
                for c in order:
                    _flush(flush, False)
                    bad[c] += int(not torch.equal(calls[c](), firsts[c]))
            emit({**what, "repeat": args.repeat, "mismatches": bad})
            if any(bad.values()):
                raise AssertionError(f"{name}: clusters whose calls differ: {bad}")
        for c, call in calls.items() if not args.no_time else ():
            emit({**what, "cluster": c, "chosen": c == chosen,
                  "ms": _kernel_ms(call, PAGED_NAMES, flush, args.iters),
                  "events_ms": _events_ms(call, flush, args.iters, False),
                  "clean_ms": _kernel_ms(call, PAGED_NAMES, flush, args.iters, True),
                  "clean_events_ms": _events_ms(call, flush, args.iters, True)})
        if args.k3 and not kv4 and not args.no_time:
            kt, v = (t.contiguous() for t in att.gather_paged_kv(kt_pool, v_pool, table))
            for c in att.DECODE_CLUSTERS:
                def k3(c=c):
                    return att._decode_launch(q, kt, v, lengths, scales, quant_pv, c)

                _k3_gate(k3(), ref, quant_pv, f"K3 at {name} cluster {c}")
                emit({**what, "k3_cluster": c,
                      "ms": _kernel_ms(k3, K3_NAMES, flush, args.iters),
                      "events_ms": _events_ms(k3, flush, args.iters, False),
                      "clean_ms": _kernel_ms(k3, K3_NAMES, flush, args.iters, True),
                      "clean_events_ms": _events_ms(k3, flush, args.iters, True)})
            del kt, v
        del q, kt_pool, v_pool
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return rows


if __name__ == "__main__":
    main()
