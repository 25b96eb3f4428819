"""K3 (``int8_decode_attention``) at every cluster size that ``decode_plan``
chooses among, and with ``--k7`` K7 (``int8_decode_attention_chunked``) at
every plan of ``chunked_candidates``, timed on the card.

``decode_plan`` (``ops/attention.py``) spreads each (slot, kv head) of a
decode step over a thread-block cluster of 2, 4 or 8 blocks.  For each shape
of LLaMA-2-7B's decode step (4 slots at lengths 287-278, MHA and GQA, and 8
serving slots at lengths 299-1398, Smax 2048) this script launches K3 at
every cluster size through ``_decode_launch``, holds it against the plain
version within K3's gates (relative L2 error under 1e-3 with quant_pv, else
rtol = atol = 2e-4) and prints one JSON line a cluster: its kernel's device
time from torch.profiler (mean of ``--iters`` calls, each after an L2
flush, as ``chip_smoke.py`` times K3) and whether the plan chose it.

``--k7``: the long caches instead (K7_SHAPES: ``chip_smoke.py``'s K7 cases,
the port bench's ``longctx`` and 8 query heads a kv head at 32,768 and
65,536 positions).  For each, K3's body through ``_decode_launch`` at every
cluster of DECODE_CLUSTERS whose block holds its scores (``k3_cluster``),
K7 at every plan of ``chunked_candidates`` through ``_chunked_launch``
(``cluster``, ``scratch`` and ``split``, and whether ``chunked_plan`` chose
it), and K7 as its wrapper runs it (``wrapper``: all of the call's device
time, whatever its kernels' names), each held against the plain version
(K3's gates; K7 within 1e-5) and timed after a flush of zeros and after a
clean one (``clean_``: 128 MB read), from torch.profiler and from CUDA
events (a plan of K7: its profiler time and its clean events time).
``--k7 wrapper``: the wrapper alone, so that two trees' K7 can be compared
in one call (the script copied into the other tree).

``--rows``: K3's and K7's split kernels (a rep outside 1, 2, 4 and 8) at
ROWS_SHAPES (``chip_smoke.py``'s split cases: Falcon-7B's serving decode, 8
slots at 71 query heads on one kv head, Dh 64; 48 heads on 8 at Dh 128;
Falcon-7B's heads at 16,384 positions; and its batched serving decode at
16,384 as ``chip_smoke.py``'s main_falcon runs it, 4 slots of 260
positions), each plan of ``rows_candidates`` through ``_rows_launch``
(``cluster``, ``recompute``, ``keep_k``, and whether ``rows_plan`` chose
it; its device time from CUDA events), then the wrapper as a path calls it
(all of the call's device time, whatever its kernels' names), each held
against the plain version (K3's gates; K7's within 1e-5) and timed after a
flush of zeros and after a clean one.
``--rows wrapper``: the wrappers alone (two trees compared in one call).
Then the card's name and power limit, as nvidia-smi gives them.

Run: ``python -m dgq_tpu_torch.scripts.decode_plan_sweep [--iters 20]
[--k7 [wrapper] | --rows [wrapper]]`` on the card (the kernels have no CPU
version).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from dgq_tpu_torch.ops import attention as att
from dgq_tpu_torch.scripts.paged_plan_sweep import _events_ms, _flush, _kernel_ms

H, DH, SMAX = 32, 128, 2048  # LLaMA-2-7B's query heads and head width; the cache
MAIN = (287, 284, 281, 278)  # the main path's last decode step at batch 4
SERVE = (299, 1398, 650, 1020, 812, 455, 1203, 977)  # 8 serving slots
SHAPES = ((32, MAIN, True), (32, MAIN, False), (8, MAIN, True), (32, SERVE, True))
K7_LENGTHS = (5000, 9000, 12000, 16000)  # chip_smoke.py's K7 cases, 4 slots
# (name, H, Hkv, Smax, lengths, quant_pv): K7's timed cases, the bench's longctx (one slot
# decoding from a nearly full cache), and 8 query heads a kv head (64 of 8, as LLaMA-2-70B)
K7_SHAPES = (("k7", 32, 32, 16384, K7_LENGTHS, True),
             ("k7_fp", 32, 32, 16384, K7_LENGTHS, False),
             ("k7_gqa", 32, 8, 16384, K7_LENGTHS, True),
             ("longctx_16k", 32, 32, 16384, (16374,), True),
             ("longctx_32k", 32, 32, 32768, (32758,), True),
             ("longctx_32k_fp", 32, 32, 32768, (32758,), False),
             ("rep8_32k", 64, 8, 32768, (32758,), True),
             ("rep8_64k", 64, 8, 65536, (65526,), True))
K3_NAMES = ("decode_attn_cluster",)
K7_NAMES = ("long_attn_cluster",)
FALCON_SERVE = tuple(1 + 2047 * i // 7 for i in range(8))  # chip_smoke.py's FALCON_LENGTHS
# (name, H, Hkv, Dh, Smax, lengths, quant_pv): K3's split cases (Smax 2048) and K7's (16,384)
ROWS_SHAPES = (("falcon_serve", 71, 1, 64, 2048, FALCON_SERVE, False),
               ("falcon_serve_qpv", 71, 1, 64, 2048, FALCON_SERVE, True),
               ("gqa_48_8", 48, 8, 128, 2048, (1, 700, 1501, 2048), False),
               ("falcon_16k", 71, 1, 64, 16384, K7_LENGTHS, False),
               ("falcon_16k_qpv", 71, 1, 64, 16384, K7_LENGTHS, True),
               ("falcon_long_step", 71, 1, 64, 16384, (260,) * 4, False))


def _gate(got: torch.Tensor, ref: torch.Tensor, quant_pv: bool, what: str) -> None:
    if quant_pv:
        rel = ((got - ref).norm() / ref.norm()).item()
        if not rel < 1e-3:
            raise AssertionError(f"{what}: relative L2 error {rel}")
    else:
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4, msg=what)


def _device_ms(fn, flush: torch.Tensor, iters: int, clean: bool = False) -> float:
    """Mean device milliseconds of every kernel ``fn`` launches, whatever
    its name, over ``iters`` calls each after an L2 flush, from
    torch.profiler; the flush's own kernels are left out."""
    def trace(call):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                _flush(flush, clean)
                call()
            torch.cuda.synchronize()
        return {e.key: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                for e in prof.key_averages()}

    fn()
    torch.cuda.synchronize()
    flush_keys = set(trace(lambda: None))
    for _ in range(3):
        us = sum(t for k, t in trace(fn).items() if k not in flush_keys)
        if us > 0:
            return us / iters / 1e3
    raise RuntimeError("torch.profiler saw no device time besides the flush")


def _times(fn, names, flush: torch.Tensor, iters: int) -> dict:
    """The four times of one kernel: profiler and events, zeros and clean flush."""
    if names is None:
        return {"ms": _device_ms(fn, flush, iters),
                "events_ms": _events_ms(fn, flush, iters, False),
                "clean_ms": _device_ms(fn, flush, iters, True),
                "clean_events_ms": _events_ms(fn, flush, iters, True)}
    return {"ms": _kernel_ms(fn, names, flush, iters),
            "events_ms": _events_ms(fn, flush, iters, False),
            "clean_ms": _kernel_ms(fn, names, flush, iters, True),
            "clean_events_ms": _events_ms(fn, flush, iters, True)}


def _k3_shapes(args, sms, gen, flush, dev, emit) -> None:
    def ri(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    for hk, lens, quant_pv in SHAPES:
        b = len(lens)
        q, kt, v = ri((b, H, DH)), ri((b, hk, DH, SMAX)), ri((b, hk, SMAX, DH))
        qs, ks, vs = (torch.rand((), generator=gen, device=dev) * 0.02 + 0.01 for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        scales = att._kernel_scales(qs, ks, vs, DH, True)
        ref = att.int8_decode_attention_xla(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv)
        chosen = att.decode_plan(b, hk, H // hk, DH, SMAX, sms)
        for c in att.DECODE_CLUSTERS:
            def call(c=c):
                return att._decode_launch(q, kt, v, lengths, scales, quant_pv, c)

            _gate(call(), ref, quant_pv, f"K3 B={b} Hkv={hk} quant_pv={quant_pv} cluster {c}")
            emit({"B": b, "H": H, "Hkv": hk, "Dh": DH, "Smax": SMAX, "lengths": list(lens),
                  "quant_pv": quant_pv, "cluster": c,
                  "ms": _kernel_ms(call, K3_NAMES, flush, args.iters), "chosen": c == chosen})


def _k7_shapes(args, sms, gen, flush, dev, emit) -> None:
    def ri(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    for name, h, hk, smax, lens, quant_pv in K7_SHAPES:
        b = len(lens)
        q, kt, v = ri((b, h, DH)), ri((b, hk, DH, smax)), ri((b, hk, smax, DH))
        qs, ks, vs = (torch.rand((), generator=gen, device=dev) * 0.02 + 0.01 for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        scales = att._kernel_scales(qs, ks, vs, DH, True)
        ref = att.int8_decode_attention_xla(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv)
        what = {"shape": name, "B": b, "H": h, "Hkv": hk, "Dh": DH, "Smax": smax,
                "lengths": list(lens), "quant_pv": quant_pv}

        def held(out, what_):
            err = (out - ref).abs().max().item()
            if not err <= 1e-5:
                raise AssertionError(f"K7 {what_}: max abs err {err} > 1e-5")
            return err

        if args.k7 == "all":
            for c in att.DECODE_CLUSTERS:
                if att.decode_smem_bytes(DH, h // hk, smax, c) > att.DECODE_SMEM_LIMIT:
                    continue

                def k3(c=c):
                    return att._decode_launch(q, kt, v, lengths, scales, quant_pv, c)

                _gate(k3(), ref, quant_pv, f"K3 at {name} cluster {c}")
                emit({**what, "k3_cluster": c, **_times(k3, K3_NAMES, flush, args.iters)})
            chosen = att.chunked_plan(b, hk, h // hk, DH, smax, sms)
            for plan in att.chunked_candidates(hk, h // hk, DH, smax):
                def k7(plan=plan):
                    return att._chunked_launch(q, kt, v, lengths, scales, quant_pv, plan)

                err = held(k7(), f"at {name} {plan}")
                emit({**what, "cluster": plan.cluster, "scratch": plan.scratch,
                      "split": plan.split, "chosen": plan == chosen, "max_abs_err": err,
                      "ms": _kernel_ms(k7, K7_NAMES, flush, args.iters),
                      "clean_events_ms": _events_ms(k7, flush, args.iters, True)})

        def wrapper():
            return att.int8_decode_attention_chunked(q, kt, v, lengths, qs, ks, vs,
                                                     chunk=att.auto_decode_chunk(smax),
                                                     quant_pv=quant_pv)

        err = held(wrapper(), f"at {name}")
        emit({**what, "wrapper": True, "max_abs_err": err,
              **_times(wrapper, None, flush, args.iters)})
        del q, kt, v


def _rows_shapes(args, sms, gen, flush, dev, emit) -> None:
    def ri(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    for name, h, hk, dh, smax, lens, quant_pv in ROWS_SHAPES:
        b = len(lens)
        q, kt, v = ri((b, h, dh)), ri((b, hk, dh, smax)), ri((b, hk, smax, dh))
        qs, ks, vs = (torch.rand((), generator=gen, device=dev) * 0.02 + 0.01 for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        ref = att.int8_decode_attention_xla(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv)
        what = {"shape": name, "B": b, "H": h, "Hkv": hk, "Dh": dh, "Smax": smax,
                "lengths": list(lens), "quant_pv": quant_pv}
        long = smax > att.DECODE_SHORT_SMAX

        def held(out, what_):
            if long:
                err = (out - ref).abs().max().item()
                if not err <= 1e-5:
                    raise AssertionError(f"K7 {what_}: max abs err {err} > 1e-5")
                return err
            _gate(out, ref, quant_pv, f"K3 {what_}")
            return (out - ref).abs().max().item()

        if args.rows == "all":
            scales = att._kernel_scales(qs, ks, vs, dh, True)
            kind = att.CHUNKED if long else att.DECODE
            chosen = att.rows_plan(b, hk, h // hk, dh, smax, sms, quant_pv)
            for plan in att.rows_candidates(h // hk, dh, smax, quant_pv):
                def call(plan=plan):
                    return att._rows_launch(kind, q, kt, v, lengths, scales, quant_pv, plan)

                err = held(call(), f"at {name} {plan}")
                emit({**what, **plan._asdict(), "chosen": plan == chosen, "max_abs_err": err,
                      "events_ms": _events_ms(call, flush, args.iters, False),
                      "clean_events_ms": _events_ms(call, flush, args.iters, True)})

        def wrapper():
            if long:
                return att.int8_decode_attention_chunked(q, kt, v, lengths, qs, ks, vs,
                                                         chunk=att.auto_decode_chunk(smax),
                                                         quant_pv=quant_pv)
            return att.int8_decode_attention(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv)

        err = held(wrapper(), f"at {name}")
        emit({**what, "wrapper": True, "max_abs_err": err,
              **_times(wrapper, None, flush, args.iters)})
        del q, kt, v


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--k7", nargs="?", const="all", choices=("all", "wrapper"),
                    help="K7's long caches instead of K3's shapes (wrapper: K7's wrapper alone)")
    ap.add_argument("--rows", nargs="?", const="all", choices=("all", "wrapper"),
                    help="K3's and K7's split kernels (wrapper: the wrappers alone)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_plan_sweep: no CUDA device (K3 and K7 run on the card only)")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    (_rows_shapes if args.rows else _k7_shapes if args.k7 else _k3_shapes)(
        args, sms, gen, flush, dev, emit)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return rows


if __name__ == "__main__":
    main()
