"""K3 (``int8_decode_attention``) at every cluster size that ``decode_plan``
chooses among, timed on the card.

``decode_plan`` (``ops/attention.py``) spreads each (slot, kv head) of a
decode step over a thread-block cluster of 2, 4 or 8 blocks.  For each shape
of LLaMA-2-7B's decode step (4 slots at lengths 287-278, MHA and GQA, and 8
serving slots at lengths 299-1398, Smax 2048) this script launches K3 at
every cluster size through ``_decode_launch``, holds it against the plain
version within K3's gates (relative L2 error under 1e-3 with quant_pv, else
rtol = atol = 2e-4) and prints one JSON line a cluster: its kernel's device
time from torch.profiler (mean of ``--iters`` calls, each after an L2
flush, as ``chip_smoke.py`` times K3) and whether the plan chose it.  Then
the card's name and power limit, as nvidia-smi gives them.

Run: ``python -m dgq_tpu_torch.scripts.decode_plan_sweep [--iters 20]`` on
the card (the kernel has no CPU version).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from dgq_tpu_torch.ops import attention as att

H, DH, SMAX = 32, 128, 2048  # LLaMA-2-7B's query heads and head width; the cache
MAIN = (287, 284, 281, 278)  # the main path's last decode step at batch 4
SERVE = (299, 1398, 650, 1020, 812, 455, 1203, 977)  # 8 serving slots
SHAPES = ((32, MAIN, True), (32, MAIN, False), (8, MAIN, True), (32, SERVE, True))


def _gate(got: torch.Tensor, ref: torch.Tensor, quant_pv: bool, what: str) -> None:
    if quant_pv:
        rel = ((got - ref).norm() / ref.norm()).item()
        if not rel < 1e-3:
            raise AssertionError(f"{what}: relative L2 error {rel}")
    else:
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4, msg=what)


def _kernel_ms(fn, flush: torch.Tensor, iters: int) -> float:
    """Mean device milliseconds of K3's kernel over ``iters`` calls of
    ``fn``, each after an L2 flush, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
             for e in prof.key_averages() if "decode_attn_cluster" in e.key)
    if us <= 0:
        raise RuntimeError("torch.profiler saw no device time of decode_attn_cluster")
    return us / iters / 1e3


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_plan_sweep: no CUDA device (K3 runs on the card only)")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def ri(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    rows = []
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
            row = {"B": b, "H": H, "Hkv": hk, "Dh": DH, "Smax": SMAX, "lengths": list(lens),
                   "quant_pv": quant_pv, "cluster": c, "ms": _kernel_ms(call, flush, args.iters),
                   "chosen": c == chosen}
            print(json.dumps(row), flush=True)
            rows.append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return rows


if __name__ == "__main__":
    main()
