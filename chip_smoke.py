#!/usr/bin/env python3
"""Smoke test of the dgq_tpu_torch port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports no JAX.  Phases, each printing one JSON line with its seconds:

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: the thirteen CUDA sources, one nvcc each, started together; the
   logs of the sources on wgmma (K1, K4-K6, K9, K10, K12, P1 and P2 on the
   TMA + wgmma loop, and K2) must not hold ptxas warnings
   C7514, C7515 or C7520 (wgmma serialised), nor may their libraries' SASS
   (``cuobjdump -sass``) hold a kernel whose every IGMMA or HGMMA is waited
   for at once (serialised with no warning); K2's, K3's, K4's, K5's, K6's,
   K10's, K12's, P2's and P5's registers and spills are recorded, K4-K6's
   and K12's must hold no spill and at most 113 registers, P2's no spill
   and at most 75 (three blocks an SM).
3. kernels: K1 ``w4a8_matmul_rp_pipe``, K2 ``int8_prefill_attention``, K3
   ``int8_decode_attention``, the fused decode kernels K4
   ``fused_norm_gemv_rp``, K5 ``fused_requant_gemv_rp`` and K6
   ``fused_mlp_decode_rp``, K7 ``int8_decode_attention_chunked`` and K8
   ``int8_paged_decode_attention`` held against their plain PyTorch versions
   at the main paths' shapes (LLaMA-2-7B, batch 4, prompt 256, cache 2048;
   K1 at M = 4, 1024 and 2048; K4-K6 at 4 rows and at 40 = 8 slots x a
   5-token verify window; K7 at cache 16384 in chunks of 4096; K8 at 8 slots
   over a shuffled pool of 128-token pages) and timed beside the plain
   version, one PyTorch library call for the same function (CUDA events
   around the call, and its kernels' device time from the profiler), and
   the bound.  K2 is also held (not timed) at K2_EXTRA: query windows at
   offsets off the 64-row grid, several blocks a head, Dh 64 with GQA and
   an odd count of query tiles.
   K1's int32 accumulators (alpha 1) and outputs equal the plain version's,
   also at EXTRA_GEMMS (rows that fill no tile, a width that is no multiple
   of the tile's, groupsize 64; not timed).  K4-K6 make their int8 codes
   inside the kernel: their codes are compared with the plain version's (at
   most 1 apart, >= 99.9% equal), and the int32 accumulators (alpha 1, beta
   0) and outputs with the plain version run on the kernel's codes, which
   must agree exactly; K6's norm codes must equal RMSNormQ in the kernels'
   order and its h codes ``_silu_mul_q`` of the plain gate/up sums on them,
   bit for bit, also in the sweep (1, 9 and 64 rows, then 4 and 40 rows at
   groupsize 32).  K4 and K5 are also held at FUSED_CHECK_ROWS rows
   (every token-row tile, with and without clusters), groupsize 64 and 128
   and a ragged width, then at groupsize 32 (one scale row a 32-k step, the
   kernels' other instantiation, after the first in the same process): the codes they hand out equal K5's plain requant and
   K4's RMSNormQ summed in the kernel's order (and the plain version's
   within 1), the int32 accumulators and the outputs equal the plain
   version's on them, with beta, the residual (K5), the norm bias (K4) and
   ``codes_out`` each on and off.  K7 and K8 agree with their plain versions within
   1e-5, and K8 on a contiguous table with K3 on the same cache.  Then K9
   ``w4a8_matmul_packed`` (which also serves K14's names) at OPT-6.7B shapes
   (q|k|v int8 out, out_proj, fc1 and fc2 f32 out, with biases) and K10
   ``w4a8_fpscale_matmul_packed`` at LLaMA-2-7B shapes, each at M = 4, 1024
   and 2048: K9's int32 accumulators and outputs equal the plain version's,
   also at EXTRA_GEMMS and EXTRA_SPAN_GEMMS (groupsize 32);
   K10 equals it where K is not split over blocks and lies within K10_TOL of
   the largest output where it is, also at K10_EXTRA (1, 16 and 17 rows,
   groupsizes 64 and 32, no bias), timed at 1024 and 2048 rows beside K9
   on int8 scales of the same shapes.  K3 is held at
   K3_TIMED (the main decode step, MHA and GQA, quant_pv on and off, and
   serve_dense's 8 slots), each also at every cluster size (held) and beside
   K7's tiled body on the same cache (timed), and at K3_EXTRA (lengths 1, off
   the ranks' grid and Smax, Dh 64, Smax % 16 == 4, Smax 8192).  Last K11
   ``int4_paged_decode_attention``
   on K8's pool, table and lengths with INT4 nibble pages, MHA and GQA:
   within K11_TOL of the largest output of its plain version, and on a
   contiguous table of K8 without quant_pv on the unpacked INT8 pool.  Then
   K12 ``fused_norm_gemv``, ``fused_requant_gemv`` and ``fused_mlp_decode``
   (which also serve K13's names) on span weights at K4-K6's shapes and row
   counts, held as K4-K6 are against their plain versions and, by their
   int32 accumulators, against K4-K6 on ``pack_rowpair_s4`` of the same
   weights (equal), and timed beside them; all three also at
   SPAN_SWEEP_ROWS x SPAN_SWEEP_GS (1-64 rows, groupsizes 32, 64, 128)
   under every plan of ``fused_candidates(..., "span")`` (the MLP: every
   plan of each leg, the other leg at ``mlp_plan``'s): codes equal to the
   plain requant, RMSNormQ in the kernels' order and (the MLP's h)
   ``_silu_mul_q`` of the plain gate/up sums on them, accumulators equal to
   the plain version's and to K4's/K5's/K6's, outputs within rtol 1e-6.
   Last the plan hold (``fused_plan_sweep --repeat``, PLAN_HOLD): K4, K5,
   both legs of K6, and K12's three entries (the MLP's two legs) at 9, 40
   and 64 rows, every plan HOLD_ROUNDS times in shuffled order with an L2
   flush before each call, each call's outputs equal to the chosen plan's
   (a race between plans shows here, not in one call a plan); then K10's
   (``_k10_plan_hold``): every ``fpscale_candidates`` plan at 1, 4, 40 and
   1024 rows K10_HOLD_ROUNDS times, each call equal to its plan's first
   output; the lines go to ``chiprun_out/plan_hold.txt``.
4. main: ``build_llama_engine(LlamaConfig())`` (32 layers, full width, random
   weights from seed 0) then ``generate`` of 32 greedy tokens for 4 prompts
   of 256 tokens with the default ``EngineConfig`` (fused decode), with every
   kernel's launches counted over that call; then a timed replay and a
   profiled decode-step breakdown.
5. main_unfused: the same with ``fused_decode=False`` (K1 at every step, no
   K4-K6), at full depth.
6. main_long: the same as main with a cache of 16384 positions and 8 new
   tokens, so every decode step attends through K7 (32 x 7 launches).
7. serve: the paged serving daemon, the slice's main path, at full 7B width
   and depth: ``save_engine`` then ``dgq_tpu_torch.serve.build_server`` with
   ``--paged`` and a registered 300-token prefix, driven over a socket with
   24 requests of 100-1500 prompt tokens and 64 new tokens (12 streaming,
   one cancelled mid-stream over a second connection, 8 under the prefix),
   then the metrics op; latencies as the client sees them beside
   ``metrics()``.  The served tokens must equal a direct
   ``PagedBatcher.run()`` of the same requests, only the prefix pages may
   stay in use, K8 must run 32 times per decode forward, and a run with a
   pool of 48 pages must preempt and finish every request.  Also a profiled
   paged decode step at 8 slots, and (not gated) which requests' tokens
   equal ``generate`` of the request alone, with the first token that
   differs.
8. serve_kv4: the paged daemon on INT4 nibble pages (``--paged --kv-bits
   4``) on the same 7B checkpoint with the first 12 of serve's requests (one
   streaming request cancelled): the served tokens must equal a direct
   ``PagedBatcher(kv_bits=4).run()``, K11 must run 32 times per decode
   forward and K8, K3, K7 and K2 never, ``kv_bytes_per_token`` must be
   131,072 (half the INT8 pool's), and a pool of 40 pages must preempt and
   finish every request.  Also a profiled 8-slot decode step.
9. serve_dense: the daemon without ``--paged`` (the dense
   ``ContinuousBatcher``, CLI defaults: 8 slots, max-len 2048, admit-batch
   4, prefill-chunk 512) with the same 12 requests and the prefix: the
   served tokens must equal a direct ``ContinuousBatcher.run()`` and one
   with ``decode_steps=4``; K3 and each of K4-K6 must run 32 times per
   decode forward.  Then a direct ``ContinuousBatcher`` run with INT4 KV,
   reported (not gated) against serve_kv4's tokens: K11 and the plain
   attention sum in different orders.
10. opt: ``build_opt_engine(OPTConfig())`` (OPT-6.7B, 32 layers, random
   weights from seed 0), prefill of 4 x 256 tokens and 32 greedy tokens
   through ``opt_engine_forward`` in a cache of 2048, launches counted (K9
   4,096, K3 992, nothing else); a profiled decode step; then one
   ``ppl_eval_engine`` window of 2048 tokens (K9 128 launches at M = 2048).
11. main_fpscale: main's run on ``build_llama_engine(..., fp_scales=True)``
   with ``EngineConfig(fp_scales=True)``: K10 for every linear, K2 and K3,
   nothing else (fused decode is off under fp_scales).
12. main_span: main's run on span-only storage (``keep_span=True``, every
   ``qw_rp`` and ``cs_fold`` dropped): K9 128, K2 32, K3 992 and each K12
   entry 992 launches, no K1 and no K4-K6; then ``generate_speculative`` of
   one prompt (spec_k 4, 32 tokens), host loop and ``ondevice=True``: K12
   on every verify window and plain step; its tokens against ``generate``'s
   are reported, not gated.
13. serve_spec: the dense daemon with ``--spec-k 4`` on serve_dense's
   checkpoint, 12 requests and prefix, all queued before its first step:
   the served tokens must equal a direct ``ContinuousBatcher(spec_k=4).run()``
   (and its speculation counts), K3 must run once per layer of every plain
   decode forward and K4-K6 of every forward, verify windows (8 slots x 5
   rows) included.  Reported: the speculation metrics, client numbers and
   tokens against serve_dense's, direct runs with ``decode_steps=4`` and with
   ``spec_adaptive=False``, and a profiled 8-slot verify step (its plain
   attention also timed alone at the step's shapes).
14. serve_fpscale: the dense daemon on an fp-scale checkpoint
   (``save_engine`` of ``build_llama_engine(fp_scales=True)``, 7B width
   and depth) with the first 4 of serve_dense's requests, all queued before
   its first step: ``serve`` takes ``fp_scales`` from the stored scales; the
   served tokens must equal a direct ``ContinuousBatcher.run()`` with
   ``EngineConfig(fp_scales=True)``; K10 and K2 run, K3 once per layer of
   every decode forward, and no K1 or K4-K6.
15. parity: at full width and 2 layers, the kernel path against the plain
   path on the card (prefill logits, 8 teacher-forced decode steps and a
   5-token ``window="decode"`` verify window), fused, unfused, fp-scale
   (K10) and INT4 KV, ``paged_prefill`` + 8 teacher-forced
   ``paged_decode_batched`` steps over a shuffled page table with INT8 (K8)
   and INT4 (K11) pages, and the OPT engine (K9; prefill and 8 decode
   steps) and span-only fused decode (K9 and K12; prefill, 8 steps and the
   window); INT4 caches are compared as unpacked codes.  With random weights
   at full width one int8 code that flips at a rounding boundary (fp32 sums
   taken in another order) changes the rows after it by more than the
   tolerance, so the plain run
   checks each of its int8 code tensors against the kernel run's (at most 1
   apart, >= 99.9% equal) and then continues from the kernel run's codes;
   the fused kernels hand their codes out through ``codes_out``.
16. checkpoint: ``save_engine`` then ``load_engine`` at full width and 2
   layers, for the LLaMA and the OPT engine: bit-equal tensors and equal
   greedy tokens.
17. probes (run right after kernels): the tools' path.  Each probe's main (``dgq_tpu_torch/scripts``:
   P1 ``roofline_probe``, P2 ``probe_gemv_engines``, P3
   ``probe_native_s4``, P4 ``probe_s4_bitcast_numerics``, P5
   ``probe_quant_pv_parts``) at a cut depth (PROBE_ARGS), with launches
   counted over those calls (every probe kernel at least once), P4's
   numerics matching the [low | high] halves and P3 reading element 0 from
   the low nibble; their printout goes to ``chiprun_out/probes.txt``.  Then
   each probe kernel against its plain version at the probe's shapes and
   timed as K1-K12 are: P1 ``s8_matmul`` (M 2048, N = K = 4096, both
   tilings: K1's and K9's prefill block of 256 rows x 128 columns, and 128 x
   128), P2 ``mxu_gemv``, ``vpu_gemv``, ``mix_gemv`` (8 rows, K 4096, N
   12288; the mix at 50% and 67% tensor-core columns), each bit-equal under
   every plan of ``gemv_candidates`` (each plan's time from CUDA events:
   the sweep that ``gemv_plan``'s rule is held to), every plan then held
   P2_HOLD_ROUNDS times in shuffled order with an L2 flush before each call
   against its first output, and timed at the chosen plan also after a
   flush that leaves the L2 clean (with the library call, and
   ``torch.amax`` reading the same weight bytes in order: the card's
   streaming rate); ``mxu_gemv`` also at K4's bytes (N 6144), P3
   ``pallas_s4``, ``pallas_s4_bitcast`` (16 rows of int4 codes;
   P4's ``kern`` at K 256 and one 256-column block) with int32 results (P1:
   the f32 of int32) equal; P5 ``attn`` (K3's body) in its six modes at 32
   heads and a cache of 2048 (MHA, full length; GQA 4:1 at 1707 positions;
   both also at 3 slots of lengths 0, 1 and 2048), under every cluster of
   DECODE_CLUSTERS, each slot within PV_TOL of its largest output.  Beside
   the profiler's kernel time each case records ``events_ms``, the same
   time from CUDA events alone (``Timer.events``).
18. bench: ``python -m dgq_tpu_torch.bench`` (BENCH_ARGS) in a subprocess:
   exactly one line on stdout, a numeric value, no ``degraded``, the card's
   name, K9 and K1 launched by its GEMM round; its launches summed over its
   stages are the bench path's.

Then the line ``{"kernels": [...]}``, the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without that
last line.  Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

DEV = "cuda"  # every tensor of the run lives on the card
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1979e12  # dense int8 tensor cores
FP16_OPS_PER_S = 989e12  # dense fp16 / bf16 tensor cores
FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores

BATCH, PROMPT, SMAX, NEW_TOKENS = 4, 256, 2048, 32
DECODE_LEN = PROMPT + NEW_TOKENS - 1  # valid cache length at the last decode step
LONG_SMAX, LONG_CHUNK, LONG_NEW = 16384, 4096, 8  # main_long: K7 (AUTO chunk of 16384)
K7_LENGTHS = (5000, 9000, 12000, 16000)
PS, SLOTS = 128, 8  # serving: page size and slots (the serve CLI's defaults)
K8_LENGTHS = (1, 127, 128, 129, 700, 1000, 1536, 2048)
SERVE_REQUESTS, SERVE_NEW, PREFIX_LEN, TIGHT_PAGES = 24, 64, 300, 49
# serve_kv4 and serve_dense: the first 12 requests; 40 usable pages hold the
# prefix's 3 and less than the 46 the first 8 requests reach
SERVE_KV4, SERVE_DENSE, TIGHT_PAGES_KV4 = 12, 12, 41
SPEC_K = 4  # speculative drafts per step (main_span, serve_spec)
# K1 and K9 run the shared main loop (gemm_sm90) and, when K is split, splitk_combine; each
# instantiation names its loader
K1_NAMES = ["RowpairLoader"]
# K4 and K5: the TMA + wgmma kernel and, when K is split, the kernel that sums the splits
K4_NAMES = ["norm_gemv_rp_sm90", "norm_gemv_rp_combine"]
K5_NAMES = ["requant_gemv_rp_sm90", "requant_gemv_rp_combine"]
# K6: its gate|up leg and its down leg, each with the kernel that sums its K splits
K6_NAMES = ["mlp_gate_up_rp", "mlp_down_rp"]
# K12's three entry points on K4's, K5's and K6's TMA + wgmma kernels (one source; each kernel
# with the kernel that sums its K splits; the MLP's two legs)
K12_NAMES = {"fused_norm_gemv": ["norm_gemv_span_sm90", "norm_gemv_span_combine"],
             "fused_requant_gemv": ["requant_gemv_span_sm90", "requant_gemv_span_combine"],
             "fused_mlp_decode": ["mlp_gate_up_span", "mlp_down_span"]}
K12_ALL = [n for names in K12_NAMES.values() for n in names]
K3_NAMES = ["decode_attn_cluster"]
K78_NAMES = ["chunk_attn_kernel", "combine_kernel"]  # K7 and K8 share their kernels
K9_NAMES = ["SpanLoader"]
K10_NAMES = ["SpanCodesLoader"]  # the shared loop and its split combine, K10's loader
FUSED_ROWS = (BATCH, 40)  # a decode step; 8 slots x a 5-token verify window
# (N, K) of the four linears of a LLaMA-2-7B layer (F padded to 11264)
LINEARS = {"qkv_proj": (12288, 4096), "o_proj": (4096, 4096),
           "gate_up_proj": (22528, 4096), "down_proj": (4096, 11264)}
# (N, K) of the four linears of an OPT-6.7B layer; q|k|v writes int8
OPT_LINEARS = {"qkv_proj": (12288, 4096), "out_proj": (4096, 4096),
               "fc1": (16384, 4096), "fc2": (4096, 16384)}
PPL_LEN = 2048  # one perplexity window of OPT (max_position_embeddings)
SPAN_ROWS = (BATCH, BATCH * PROMPT, PPL_LEN)  # K9/K10: decode step, prefill, ppl window
K10_TOL = 1e-5  # of the largest |output|, where K10 splits K (fp32 sums reassociated)
K11_TOL = 1e-5  # of the largest |output|: per-tile flash partials against one softmax


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Timer:
    """Timing on the card, with the L2 cache flushed before each call.

    ``timer(fn)``: CUDA events around one call (host launch gaps included),
    median over ``iters`` calls after warm-up.  ``timer.kernel(fn, names)``:
    the device time of the kernels whose names contain one of ``names``,
    from torch.profiler, averaged over ``iters`` calls; ``timer.device(fn)``
    that of all of ``fn``'s kernels."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
        self.flush_keys = None  # the flush's kernel names, learned by the first ``device``
        self.last_kernels = []  # the kernel names the last ``device`` call counted

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]

    def events(self, fn, iters: int = 50, clean: bool = False) -> float:
        """Device time of ``fn`` from CUDA events alone: ``iters`` calls,
        each after an L2 flush, less the same flushes without the calls.
        The flushes keep the card busier than the host's launches, so host
        gaps stay out of the difference."""
        torch = self.torch
        fn()

        def run(call):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                self._flush(clean)
                if call:
                    fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)

        return (run(True) - run(False)) / iters

    def _flush(self, clean: bool) -> None:
        """The L2 flush: 128 MB of zeros written, so that the L2 holds dirty
        lines which the next call's misses write back, or (``clean``) 128 MB
        read, which leaves it clean."""
        if clean:
            self.flush.view(self.torch.int64).sum()
        else:
            self.flush.zero_()

    def _profile(self, fn, iters: int) -> dict:
        """Device microseconds by kernel name over ``iters`` calls of ``fn``,
        each after an L2 flush."""
        torch = self.torch
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        return {e.key: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                for e in prof.key_averages()}

    def kernel(self, fn, names, iters: int = 20, attempts: int = 3) -> float:
        """A trace that records no device activity at all (seen once on the
        card) is taken again, up to ``attempts`` times."""
        fn()
        self.torch.cuda.synchronize()
        for _ in range(attempts):
            seen = self._profile(fn, iters)
            total_us = sum(us for key, us in seen.items() if any(n in key for n in names))
            if total_us > 0:
                return total_us / iters / 1e3
        raise RuntimeError(f"profiler saw no device time for {names}; it saw {seen}")

    def device(self, fn, iters: int = 20, attempts: int = 3) -> float:
        """Device time of every kernel that ``fn`` launches, whatever its
        name (a library call's own kernels), from torch.profiler, averaged
        over ``iters`` calls; the L2 flush's kernels are left out."""
        if self.flush_keys is None:
            self.flush_keys = set(self._profile(lambda: None, 3))
        fn()
        self.torch.cuda.synchronize()
        for _ in range(attempts):
            seen = self._profile(fn, iters)
            self.last_kernels = sorted(key for key in seen if key not in self.flush_keys)
            total_us = sum(us for key, us in seen.items() if key not in self.flush_keys)
            if total_us > 0:
                return total_us / iters / 1e3
        raise RuntimeError(f"profiler saw no device time besides the flush; it saw {seen}")

    def library(self, fn) -> dict:
        """A library yardstick: ``library_ms``, CUDA events around one call
        (host dispatch included), and ``library_device_ms``, its kernels'
        device time."""
        return {"library_ms": self(fn), "library_device_ms": self.device(fn)}


def bound_ms(nbytes: float, *unit_seconds: float):
    """The larger of the byte time and the busiest unit's operation time:
    int8 tensor cores and fp32 cores run at once, so their times overlap."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    op_seconds = max(unit_seconds)
    return max(t_bytes, op_seconds) * 1e3, ("bytes" if t_bytes >= op_seconds else "operations")


def phase_device(torch, state):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    state["smi"] = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state["kind"] = torch.cuda.get_device_name(0)
    return {"card": state["smi"], "kind": state["kind"], "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


# the sources on wgmma (K1, K9, K10, P1, K4-K6, K12 and P2 on the TMA + wgmma loop of
# w4a8_gemm_sm90.cuh; K2), whose nvcc logs must not hold ptxas warnings C7514, C7515 or C7520
# (wgmma serialised: right, but slower)
WGMMA_SOURCES = ("w4a8_rp_gemm", "w4a8_span_gemm", "s8_gemm", "fused_norm_gemv_rp",
                 "fused_requant_gemv_rp", "fused_mlp_decode_rp", "fused_gemv_span_sm90",
                 "int8_gemv_engines", "int8_prefill_attention")


def _ptxas_entries(log: str, marker: str) -> dict:
    """Registers and spills of the entry functions whose names hold
    ``marker``, from an nvcc log with ``-Xptxas -v``."""
    import re

    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            # the anonymous namespace's mangled name holds the source's name: leave it out
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", m.group(1))
            entry = name if marker in name else None
            continue
        if entry is None:
            continue
        args = re.findall(r"Li(\d+)E", entry)  # the template's int arguments
        name = re.search(r"[a-z_]*" + marker, entry).group(0)
        key = name + (f"<{', '.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(key, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def _serialised_wgmma(sass: str) -> dict:
    """From a ``cuobjdump -sass`` listing: per function that holds IGMMA or
    HGMMA (int8 or 16-bit wgmma), whether every one is waited for at once,
    i.e. the next GMMA or WARPGROUP.DEPBAR after it is
    ``WARPGROUP.DEPBAR.LE gsb0, 0x0``.
    That is how ptxas serialises wgmmas, also when it prints no C7515 (two
    fragment sets given the same registers); a pipelined loop issues two
    IGMMAs back to back and then waits for all but the last group."""
    import re

    events, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            events[fn] = []
        elif fn is not None and re.search(r"\b[IH]GMMA\b", line):
            events[fn].append("mma")
        elif fn is not None and "WARPGROUP.DEPBAR" in line:
            events[fn].append("wait0" if re.search(r"gsb0, 0x0\s*;", line) else "wait")
    return {f: all(e[i + 1:i + 2] == ["wait0"] for i, x in enumerate(e) if x == "mma")
            for f, e in events.items() if "mma" in e}


def phase_build(torch, state):
    from dgq_tpu_torch.ops import _cuda

    seconds = _cuda.build()
    version = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True, text=True,
                             timeout=60).stdout
    nvcc = next((line for line in version.splitlines() if "release" in line), version.strip())
    ptxas, igmma_kernels = {}, {}
    for stem in WGMMA_SOURCES:
        log = (_cuda.BUILD_DIR / f"{stem}.log").read_text()
        for code in ("C7514", "C7515", "C7520"):
            if code in log:
                raise AssertionError(f"csrc/{stem}.cu: ptxas serialised the wgmmas ({code})")
        if stem.startswith("fused_"):
            ptxas[stem] = _ptxas_entries(log, "_span_sm90" if "span" in stem else "_rp_sm90")
            # fused_plan lets two blocks of 288 threads share an SM: 113 registers a thread
            for name, e in ptxas[stem].items():
                if e.get("registers", 0) > 65536 // (2 * 288) or e.get("spill_bytes", 0):
                    raise AssertionError(f"csrc/{stem}.cu: {name} takes {e}")
        elif stem == "int8_gemv_engines":
            # gemv_plan lets three blocks of 288 threads share an SM: 75 registers a thread
            ptxas[stem] = _ptxas_entries(log, "gemv_sm90")
            for name, e in ptxas[stem].items():
                if e.get("registers", 0) > 65536 // (3 * 288) or e.get("spill_bytes", 0):
                    raise AssertionError(f"csrc/{stem}.cu: {name} takes {e}")
        elif stem == "int8_prefill_attention":
            ptxas[stem] = _ptxas_entries(log, "prefill_attn_sm90")
        elif stem == "w4a8_span_gemm":  # K10: three accumulator sets a consumer thread
            ptxas[stem] = _ptxas_entries(log, "SpanCodesLoader")
        sass = subprocess.run([str(Path(_cuda._nvcc()).with_name("cuobjdump")), "-sass",
                               str(_cuda._lib_path(stem))], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        serial = _serialised_wgmma(sass)
        if not serial:
            raise AssertionError(f"csrc/{stem}.cu: no IGMMA or HGMMA in its SASS")
        if any(serial.values()):
            raise AssertionError(f"csrc/{stem}.cu: wgmmas serialised in "
                                 f"{[f for f, bad in serial.items() if bad]}")
        igmma_kernels[stem] = len(serial)
    k3_log = (_cuda.BUILD_DIR / "int8_decode_attention.log").read_text()
    ptxas["int8_decode_attention"] = _ptxas_entries(k3_log, "decode_attn_cluster")
    p5_log = (_cuda.BUILD_DIR / "quant_pv_parts_attention.log").read_text()
    ptxas["quant_pv_parts_attention"] = _ptxas_entries(p5_log, "pv_parts_cluster")
    return {"nvcc_seconds": seconds, "nvcc": nvcc, "no_c7515": list(WGMMA_SOURCES),
            "igmma_kernels_pipelined": igmma_kernels, "ptxas": ptxas}


def _k1_cases(torch, timer, gen):
    from dgq_tpu_torch.ops.quant_matmul import dequantize_rowpair, w4a8_matmul_rp_pipe, \
        w4a8_matmul_rp_xla

    cases = []
    gs = 128
    for m in SPAN_ROWS:
        for name, (n, k) in LINEARS.items():
            def ri(lo, hi, shape):
                return torch.randint(lo, hi, shape, generator=gen, device=DEV, dtype=torch.int8)

            x = ri(-128, 128, (m, k))
            qw = ri(-128, 128, (k // 2, n))
            ws, wz = ri(1, 4, (k // gs, n)), ri(4, 12, (k // gs, n))
            ws8 = torch.repeat_interleave(ws, 8, dim=0)
            wz8 = torch.repeat_interleave(wz, 8, dim=0)
            alpha = torch.rand((n,), generator=gen, device=DEV) * 1e-3 + 1e-5
            one = torch.ones((n,), device=DEV)

            def kern(a=alpha):
                return w4a8_matmul_rp_pipe(x, qw, ws8, wz8, a, groupsize=gs,
                                           scales_replicated=True)

            def plain(a=alpha):
                return w4a8_matmul_rp_xla(x, qw, ws, wz, a, groupsize=gs)

            acc_k, acc_p = kern(one), plain(one)
            torch.cuda.synchronize()
            if not torch.equal(acc_k, acc_p):
                bad = (acc_k != acc_p).sum().item()
                raise AssertionError(f"K1 {name} M={m}: {bad} accumulators differ")
            y_k, y_p = kern(), plain()
            if not torch.equal(y_k, y_p):
                raise AssertionError(f"K1 {name} M={m}: {(y_k != y_p).sum().item()} outputs differ")
            err = (y_k - y_p).abs().max().item()
            lib = _int_mm_times(torch, timer, x, dequantize_rowpair(qw, ws, wz, gs))
            nbytes = m * k + k * n // 2 + 2 * (k // gs) * n + 4 * n + 4 * m * n
            b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k / INT8_OPS_PER_S)
            cases.append({"linear": name, "M": m, "N": n, "K": k, "max_abs_err": err,
                          "ms": timer.kernel(kern, K1_NAMES), "call_ms": timer(kern),
                          "plain_ms": timer(plain, iters=10),
                          **lib, "library_rows": max(m, 32),
                          "bound_ms": b_ms, "bound_by": b_by})
            del x, qw, ws, wz, ws8, wz8, acc_k, acc_p, y_k, y_p
    return cases + _gemm_extra_cases(torch, gen, span=False)


# K1's and K9's shapes beside the main paths', held bit-equal and not timed: rows that
# fill no tile (M = 1, 17, 100, 1000) and a width that is a multiple of 16 but not of the
# tiles' 256 columns (N = 4112), at groupsize 128; the qkv linear at groupsize 64 (both)
# and 32 (K9) at a decode step and a prefill.  (M, N, K, groupsize)
EXTRA_GEMMS = ([(m, 4112, 4096, 128) for m in (1, 17, 100, 1000)]
               + [(m, 12288, 4096, 64) for m in (BATCH, BATCH * PROMPT)])
EXTRA_SPAN_GEMMS = [(m, 12288, 4096, 32) for m in (BATCH, BATCH * PROMPT)]


def _gemm_extra_cases(torch, gen, span):
    """K1 (``span`` false) or K9 at EXTRA_GEMMS (K9 also EXTRA_SPAN_GEMMS): the
    int32 accumulators (alpha 1, no bias) and the outputs (K9: f32 and int8,
    with a bias) equal the plain version's."""
    from dgq_tpu_torch.ops import quant_matmul as qm

    cases = []
    for m, n, k, gs in EXTRA_GEMMS + (EXTRA_SPAN_GEMMS if span else []):
        x = torch.randint(-128, 128, (m, k), generator=gen, device=DEV, dtype=torch.int8)
        qw, ws, wz = _q4_weights(torch, gen, k, n, gs)
        ws8, wz8 = torch.repeat_interleave(ws, 8, dim=0), torch.repeat_interleave(wz, 8, dim=0)
        alpha = torch.rand((n,), generator=gen, device=DEV) * 1e-3 + 1e-5
        beta = torch.randn((n,), generator=gen, device=DEV)
        one = torch.ones((n,), device=DEV)
        if span:
            runs = [(one, None, torch.float32), (alpha, beta, torch.float32),
                    (alpha, beta, torch.int8)]

            def kern(a, b, o):
                return qm.w4a8_matmul_packed(x, qw, ws8, wz8, a, b, groupsize=gs, out_dtype=o,
                                             scales_replicated=True)

            def plain(a, b, o):
                return qm.w4a8_matmul_packed_xla(x, qw, ws, wz, a, b, groupsize=gs, out_dtype=o)
        else:
            runs = [(one, None, torch.float32), (alpha, None, torch.float32)]

            def kern(a, b, o):
                return qm.w4a8_matmul_rp_pipe(x, qw, ws8, wz8, a, groupsize=gs,
                                              scales_replicated=True)

            def plain(a, b, o):
                return qm.w4a8_matmul_rp_xla(x, qw, ws, wz, a, groupsize=gs)
        for a, b, o in runs:
            got, want = kern(a, b, o), plain(a, b, o)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                what = "accumulators" if b is None and a is one else f"{str(o)[6:]} outputs"
                raise AssertionError(f"{'K9' if span else 'K1'} M={m} N={n} K={k} gs={gs}: "
                                     f"{(got != want).sum().item()} {what} differ")
        plan = qm.gemm_plan(m, n, k, gs, "span" if span else "rowpair",
                            torch.cuda.get_device_properties(0).multi_processor_count)
        cases.append({"linear": "extra", "M": m, "N": n, "K": k, "groupsize": gs, "extra": True,
                      "bit_equal": True, "max_abs_err": 0.0, "plan": plan._asdict()})
        del x, qw, ws, wz, ws8, wz8
    return cases


def _int_mm_times(torch, timer, x, w8) -> dict:
    """Times of torch._int_mm of x against pre-dequantised int8 weights, the
    library yardstick of K1, K4-K6, K9, K12 and the probes P1-P3
    (``Timer.library``); x is padded to 32 rows, since _int_mm takes more
    than 16.  The faster of the second operand as it is (row-major) and
    column-major, the layout cuBLASLt's int8 kernels take (a build may
    refuse the row-major one), by events and by device time each."""
    m, k = x.shape
    if m < 32:
        x = torch.cat([x, torch.zeros((32 - m, k), dtype=x.dtype, device=x.device)])
    times = []
    for w in (w8, w8.t().contiguous().t()):
        try:
            torch._int_mm(x, w)
        except RuntimeError:
            continue
        times.append(timer.library(lambda w=w: torch._int_mm(x, w)))
    return {key: min(t[key] for t in times) for key in times[0]}


def _sum_times(*times) -> dict:
    return {key: sum(t[key] for t in times) for key in times[0]}


def _attn_inputs(torch, gen, b, h, hk, s, dh, smax):
    def ri(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8)

    scales = [torch.rand((), generator=gen, device=DEV) * 0.02 + 0.01 for _ in range(3)]
    return ri((b, h, s, dh)), ri((b, hk, dh, smax)), ri((b, hk, smax, dh)), scales


def _k2_cases(torch, timer, gen):
    from dgq_tpu_torch.ops.attention import int8_prefill_attention, int8_prefill_attention_xla

    cases = []
    b, h, sp, dh = BATCH, 32, PROMPT, 128
    for hk in (32, 8):
        q, kt, v, (qs, ks, vs) = _attn_inputs(torch, gen, b, h, hk, sp, dh, SMAX)
        plen = sp

        def kern():
            return int8_prefill_attention(q, kt, v, plen, qs, ks, vs, 0)

        def plain():
            return int8_prefill_attention_xla(q, kt, v, plen, qs, ks, vs, 0)

        out_k, out_p = kern(), plain()
        err = (out_k - out_p).abs().max().item()
        ref_max = out_p.abs().max().item()
        if not err <= 3e-4 * ref_max:
            raise AssertionError(f"K2 Hkv={hk}: max abs err {err} > 3e-4 * {ref_max}")
        qb = (q.float() * qs).to(torch.bfloat16)
        kb = (kt[..., :plen].transpose(2, 3).float() * ks).to(torch.bfloat16).contiguous()
        vb = (v[:, :, :plen].float() * vs).to(torch.bfloat16)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def lib_call():
            return sdpa(qb, kb, vb, is_causal=True, enable_gqa=hk != h)

        lib = timer.library(lib_call)
        # the yardstick's kernels (SDPA picks its backend) and its device time by
        # CUDA events, a second reading beside the profiler's
        lib["library_kernels"] = [key[:100] for key in timer.last_kernels]
        lib["library_events_ms"] = timer.events(lib_call)
        pairs = sp * (sp + 1) // 2  # causal (query, key) pairs per head
        flops = 2.0 * dh * b * h * pairs
        nbytes = b * h * sp * dh + 2 * b * hk * plen * dh + 4 * b * h * sp * dh
        # the score product on int8 tensor cores; p @ V as two fp16 products (p_hi,
        # p_lo) with fp32 sums on the 16-bit tensor cores
        b_ms, b_by = bound_ms(nbytes, flops / INT8_OPS_PER_S, 2 * flops / FP16_OPS_PER_S)
        cases.append({"B": b, "H": h, "Hkv": hk, "Sp": sp, "Smax": SMAX, "plen": plen,
                      "max_abs_err": err, "ms": timer.kernel(kern, ["prefill_attn_sm90"]),
                      "call_ms": timer(kern), "plain_ms": timer(plain, iters=10),
                      **lib, "bound_ms": b_ms, "bound_by": b_by})
    return cases


# K2 held (not timed) where the main path's shape does not take it: (B, H, Hkv, Sp, Dh,
# Smax, prompt_len, q_offset): one request's chunk at an offset off the 64-row grid (several
# blocks a head), a long chunk far into the cache, Dh 64 with 4 query heads a kv head, and a
# perplexity window (33 query tiles a head, an odd count)
K2_EXTRA = ((1, 32, 32, 512, 128, 2048, 700, 300), (1, 32, 8, 1024, 128, 4096, 3000, 1976),
            (2, 8, 2, 192, 64, 512, 300, 77), (1, 32, 32, 2112, 128, 2112, 2100, 0))


def _k2_extra_cases(torch, gen):
    from dgq_tpu_torch.ops.attention import int8_prefill_attention, int8_prefill_attention_xla

    out = []
    for b, h, hk, sp, dh, smax, plen, off in K2_EXTRA:
        q, kt, v, (qs, ks, vs) = _attn_inputs(torch, gen, b, h, hk, sp, dh, smax)
        got = int8_prefill_attention(q, kt, v, plen, qs, ks, vs, off)
        want = int8_prefill_attention_xla(q, kt, v, plen, qs, ks, vs, off)
        err, ref_max = (got - want).abs().max().item(), want.abs().max().item()
        if not err <= 3e-4 * ref_max:
            raise AssertionError(f"K2 {(b, h, hk, sp, dh, smax, plen, off)}: max abs err {err} "
                                 f"> 3e-4 * {ref_max}")
        out.append({"B": b, "H": h, "Hkv": hk, "Sp": sp, "Dh": dh, "Smax": smax, "plen": plen,
                    "q_offset": off, "max_abs_err": err, "ref_max": ref_max})
        del q, kt, v, got, want
    return out


def _sdpa_decode_ms(torch, timer, q, kt, v, scales, lengths) -> dict:
    """The library yardstick of K3, K7 and K8 (a different arithmetic): bf16
    SDPA for one query token per head over each slot's valid positions of a
    dense (B, Hkv, Dh, Smax) cache, timed two ways: one call padded to
    max(lengths) with a per-slot mask, and one call per slot over its own
    length, summed.  ``library_ms`` and ``library_device_ms``
    (``Timer.library``) are the faster of the two."""
    qs, ks, vs = scales
    lens = lengths.tolist()
    n = max(lens)
    gqa = kt.shape[1] != q.shape[1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qb = (q[:, :, None].float() * qs).to(torch.bfloat16)
    kb = (kt[..., :n].transpose(2, 3).float() * ks).to(torch.bfloat16).contiguous()
    vb = (v[:, :, :n].float() * vs).to(torch.bfloat16).contiguous()
    mask = (torch.arange(n, device=q.device)[None] < lengths[:, None])[:, None, None]
    padded = timer.library(lambda: sdpa(qb, kb, vb, attn_mask=mask, enable_gqa=gqa))
    slots = [(qb[i:i + 1], kb[i:i + 1, :, :m].contiguous(), vb[i:i + 1, :, :m].contiguous())
             for i, m in enumerate(lens)]

    def per_slot():
        for a, b, c in slots:
            sdpa(a, b, c, enable_gqa=gqa)

    ragged = timer.library(per_slot)
    return {"library_ms": min(padded["library_ms"], ragged["library_ms"]),
            "library_device_ms": min(padded["library_device_ms"], ragged["library_device_ms"]),
            "library_padded_ms": padded["library_ms"],
            "library_per_slot_ms": ragged["library_ms"],
            "library_padded_device_ms": padded["library_device_ms"],
            "library_per_slot_device_ms": ragged["library_device_ms"]}


def _decode_bound(b, h, hk, dh, keys, quant_pv, extra_bytes=0, kv_bytes=1.0):
    """Bound of single-token attention over ``keys`` cache positions in all:
    K and V of those positions (``kv_bytes`` per code: 1, or 0.5 for nibble
    pages), q, lengths and out moved once; the QK dot in int8, p @ V in int8
    (quant_pv) or fp32."""
    flops = 2.0 * dh * h * keys
    nbytes = b * h * dh + 2 * hk * keys * dh * kv_bytes + 4 * b + 4 * b * h * dh + extra_bytes
    if quant_pv:  # both dots on the int8 tensor cores
        return bound_ms(nbytes, 2 * flops / INT8_OPS_PER_S)
    return bound_ms(nbytes, flops / INT8_OPS_PER_S, flops / FP32_OPS_PER_S)


def _check_k3(torch, what, got, ref, quant_pv) -> float:
    """K3's gates: a relative L2 error under 1e-3 with quant_pv (an exp
    rounded otherwise moves a code by one), else rtol = atol = 2e-4."""
    if quant_pv:
        rel = ((got - ref).norm() / ref.norm()).item()
        if not rel < 1e-3:
            raise AssertionError(f"{what}: relative L2 error {rel}")
    else:
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4, msg=what)
    return (got - ref).abs().max().item()


# K3 timed: (B, Hkv, lengths, quant_pv): the main path's decode step at its last
# step's lengths, MHA and GQA, and serve_dense's 8 slots (lengths of 299-1398)
SERVE_DENSE_LENGTHS = (299, 1398, 650, 1020, 812, 455, 1203, 977)
K3_TIMED = ((BATCH, 32, tuple(DECODE_LEN - 3 * i for i in range(BATCH)), True),
            (BATCH, 32, tuple(DECODE_LEN - 3 * i for i in range(BATCH)), False),
            (BATCH, 8, tuple(DECODE_LEN - 3 * i for i in range(BATCH)), True),
            (SLOTS, 32, SERVE_DENSE_LENGTHS, True))
# K3 held (not timed): (B, H, Hkv, Dh, Smax, lengths): one position, lengths off the
# ranks' 16-position grid and the whole cache, at Hkv 32 and 8; Dh 64 with 4 query heads a kv
# head; a cache whose rows are not 16-byte aligned (Smax % 16 == 4: 4-byte copies); K3's
# largest cache (8192) with 8 query heads a kv head
K3_EXTRA = ((3, 32, 32, 128, SMAX, (1, 1001, SMAX)), (3, 32, 8, 128, SMAX, (SMAX, 37, 1)),
            (2, 8, 2, 64, 512, (511, 2)), (2, 8, 8, 128, 2052, (2052, 77)),
            (2, 64, 8, 128, 8192, (8192, 5003)))


def _k3_cases(torch, timer, gen):
    """K3 against its plain version at K3_TIMED (timed beside K7's tiled
    body at the same shapes and bf16 SDPA; held at every cluster size) and
    at K3_EXTRA (quant_pv on and off, not timed)."""
    from dgq_tpu_torch.ops import attention as att

    cases = []
    h, dh = 32, 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, hk, lens, quant_pv in K3_TIMED:
        q, kt, v, (qs, ks, vs) = _attn_inputs(torch, gen, b, h, hk, 1, dh, SMAX)
        q = q[:, :, 0].contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device=DEV)

        def kern():
            return att.int8_decode_attention(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv)

        def plain():
            return att.int8_decode_attention_xla(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv)

        def k7_body():  # K7's tiled body on the dense cache: tile max, codes, combine
            return att.int8_decode_attention_chunked(q, kt, v, lengths, qs, ks, vs,
                                                     chunk=att.TILE, quant_pv=quant_pv)

        what = f"K3 B={b} Hkv={hk} quant_pv={quant_pv}"
        out_p = plain()
        err = _check_k3(torch, what, kern(), out_p, quant_pv)
        _check_k3(torch, f"K7's body at {what}", k7_body(), out_p, quant_pv)
        scales = att._kernel_scales(qs, ks, vs, dh, True)
        for c in att.DECODE_CLUSTERS:  # every cluster the plan chooses among, held
            got = att._decode_launch(q, kt, v, lengths, scales, quant_pv, c)
            _check_k3(torch, f"{what} cluster {c}", got, out_p, quant_pv)
        b_ms, b_by = _decode_bound(b, h, hk, dh, int(lengths.sum().item()), quant_pv)
        cases.append({"B": b, "H": h, "Hkv": hk, "Smax": SMAX, "lengths": list(lens),
                      "quant_pv": quant_pv, "max_abs_err": err,
                      "cluster": att.decode_plan(b, hk, h // hk, dh, SMAX, sms),
                      "ms": timer.kernel(kern, K3_NAMES), "call_ms": timer(kern),
                      "k7_body_ms": timer.kernel(k7_body, K78_NAMES),
                      "plain_ms": timer(plain, iters=10), "bound_ms": b_ms, "bound_by": b_by,
                      **_sdpa_decode_ms(torch, timer, q, kt, v, (qs, ks, vs), lengths)})
        del q, kt, v
    for b, hq, hk, dhx, smax, lens in K3_EXTRA:
        q, kt, v, (qs, ks, vs) = _attn_inputs(torch, gen, b, hq, hk, 1, dhx, smax)
        q = q[:, :, 0].contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device=DEV)
        for quant_pv in (True, False):
            got = att.int8_decode_attention(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv)
            ref = att.int8_decode_attention_xla(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv)
            what = f"K3 {(b, hq, hk, dhx, smax, lens)} quant_pv={quant_pv}"
            cases.append({"B": b, "H": hq, "Hkv": hk, "Dh": dhx, "Smax": smax,
                          "lengths": list(lens), "quant_pv": quant_pv, "extra": True,
                          "max_abs_err": _check_k3(torch, what, got, ref, quant_pv)})
        del q, kt, v
    return cases


def _code_stats(got, ref):
    d = (got.int() - ref.int()).abs()
    return int(d.max().item()), (d == 0).float().mean().item()


def _check_codes(what, stats) -> None:
    if stats[0] > 1 or stats[1] < 0.999:
        raise AssertionError(f"{what}: int8 codes differ by up to {stats[0]}, "
                             f"{stats[1]} of them equal")


def _q4_weights(torch, gen, k, n, gs=128, fp=False):
    """Random packed int4 bytes (k/2, n), either layout, with compact (G, n)
    scales in [1, 4) and zeros in [4, 12), as the synthetic engines draw
    them; ``fp``: fp32 scales (times a per-channel factor in [0.5, 1)) and
    zeros."""
    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=DEV, dtype=torch.int8)

    qw, ws, wz = ri(-128, 128, (k // 2, n)), ri(1, 4, (k // gs, n)), ri(4, 12, (k // gs, n))
    if fp:
        ws = ws.float() * (torch.rand((n,), generator=gen, device=DEV) * 0.5 + 0.5)
        wz = wz.float()
    return qw, ws, wz


def _plane_rows(ws, wz):
    return (ws[0::2].contiguous(), ws[1::2].contiguous(), wz[0::2].contiguous(),
            wz[1::2].contiguous())


def _fused_check(torch, c):
    """Hold a fused kernel against its plain version (a case from one of
    the ``_k*_case`` makers).

    ``kern(acc, codes_out)`` and ``plain(acc, codes)``: with ``acc`` alpha is
    1 and beta and the residual are off, so the f32 output is the int32
    accumulator.  The kernel's codes (``codes_out``) are compared with the
    plain version's own (``own(kernel_codes)``), then the plain version runs
    on the kernel's codes and must give the same accumulators and outputs
    (rtol 1e-6, as K1).  A K12 case also holds its accumulators against
    K4-K6's kernel on ``pack_rowpair_s4`` of the same weights
    (``twin(acc, codes_out)``): equal."""
    kern, plain, what = c["kern"], c["plain"], c["what"]
    codes = [torch.empty(sh, dtype=torch.int8, device=DEV) for sh in c["shapes"]]
    acc_k = kern(True, codes)
    acc_p = plain(True, codes)
    torch.cuda.synchronize()
    if not torch.equal(acc_k, acc_p):
        raise AssertionError(f"{what}: {(acc_k != acc_p).sum().item()} accumulators differ")
    extra = {}
    if "twin" in c:
        rp_codes = [torch.empty_like(t) for t in codes]
        acc_rp = c["twin"](True, rp_codes)
        torch.cuda.synchronize()
        if not torch.equal(acc_k, acc_rp):
            raise AssertionError(f"{what}: {(acc_k != acc_rp).sum().item()} accumulators "
                                 "differ from K4-K6's on the rowpair copy")
        extra["int32_equal_rowpair_kernel"] = True
    if "exact" in c:
        for i, (got, want) in enumerate(zip(codes, c["exact"](codes))):
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: {(got != want).sum().item()} of codes {i} "
                                     "differ from the plain version's in the kernel's order")
        extra["codes_bit_equal"] = True
    stats = [_code_stats(k, o) for k, o in zip(codes, c["own"](codes))]
    for i, st in enumerate(stats):
        _check_codes(f"{what} codes {i}", st)
    y_k, y_p = kern(False, None), plain(False, codes)
    torch.testing.assert_close(y_k, y_p, rtol=1e-6, atol=0)
    err_own = (y_k - plain(False, None)).abs().max().item()
    return {**c["meta"], "max_abs_err": (y_k - y_p).abs().max().item(),
            "max_abs_err_own_codes": err_own, "code_max_diff": max(st[0] for st in stats),
            "code_min_equal_share": min(st[1] for st in stats), **extra}


def _layout(torch, qw, gs, span):
    """The packed bytes a fused case hands its kernel: span codes as drawn
    (K12), or read as rowpair bytes (K4-K6); with ``span``, also their
    rowpair copy and the dequantiser of the span layout."""
    from dgq_tpu_torch.ops import fused_decode as fd
    from dgq_tpu_torch.ops.quant_matmul import dequantize_rowpair, dequantize_span

    if span:
        return qw, fd.pack_rowpair_s4(qw, 2 * gs), dequantize_span
    return qw, None, dequantize_rowpair


def _k4_case(torch, gen, m, gs, extras, span=False):
    """K4 (RMSNormQ + qkv_proj), or with ``span`` K12's norm entry, at the
    main path's width; ``extras`` turns on the norm bias and beta."""
    from dgq_tpu_torch.ops import _cuda
    from dgq_tpu_torch.ops import fused_decode as fd

    eps = 1e-5
    n, k = LINEARS["qkv_proj"]
    qw, ws, wz = _q4_weights(torch, gen, k, n, gs)
    qw, qw_rp, deq = _layout(torch, qw, gs, span)
    planes = _plane_rows(ws, wz)
    csf = torch.zeros((n,), dtype=torch.int32, device=DEV)  # checked, not read
    alpha = torch.rand((n,), generator=gen, device=DEV) * 1e-3 + 1e-5
    beta = torch.randn((n,), generator=gen, device=DEV) if extras else None
    lnb = torch.randn((k,), generator=gen, device=DEV) if extras else None
    one = torch.ones((n,), device=DEV)
    x = torch.randn((m, k), generator=gen, device=DEV)
    lnw = torch.full((k,), 10.0, device=DEV)
    fn, plain_fn = ((fd.fused_norm_gemv, fd.fused_norm_gemv_xla) if span
                    else (fd.fused_norm_gemv_rp, fd.fused_norm_gemv_rp_xla))
    w = (qw, *planes) if span else (qw, *planes, csf)

    def kern(acc, codes_out, fn=fn, w=w):
        return fn(x, lnw, lnb, *w, one if acc else alpha, None if acc else beta, span=2 * gs,
                  eps=eps, codes_out=codes_out[0] if codes_out else None)

    def plain(acc, codes):
        return plain_fn(x, lnw, lnb, *w, one if acc else alpha, None if acc else beta,
                        span=2 * gs, eps=eps, codes=codes[0] if codes else None)

    def lib(timer):
        return _int_mm_times(torch, timer, fd._rmsnorm_q(x, lnw, lnb, eps), deq(qw, ws, wz, gs))

    c = {"what": f"{'K12 norm' if span else 'K4'} M={m} gs={gs}", "kern": kern, "plain": plain,
         "own": lambda codes: [fd._rmsnorm_q(x, lnw, lnb, eps)], "shapes": [(m, k)],
         "exact": lambda codes: [_rmsnorm_q_ordered(torch, x, lnw, lnb, eps)],
         "names": K12_NAMES["fused_norm_gemv"] if span else K4_NAMES,
         "meta": {"linear": "qkv_proj", "M": m, "N": n, "K": k},
         "nbytes": 4 * m * k + 4 * k + k * n // 2 + 2 * (k // gs) * n + 8 * n + 4 * m * n,
         "ops": 2.0 * m * n * k, "lib": lib}
    if span:  # K4 on the rowpair copy of the same bytes
        c["twin"] = functools.partial(kern, fn=fd.fused_norm_gemv_rp, w=(qw_rp, *planes, csf))
        c["twin_names"] = K4_NAMES

        def at_plan(acc, codes_out, plan):
            y = torch.empty((m, n), dtype=torch.float32, device=DEV)
            p = _cuda.ptr
            fd.launch_gemv(fd.NORM_SPAN, plan, (
                p(x), p(lnw), p(lnb), eps, p(qw), *map(p, planes), p(one if acc else alpha),
                p(None if acc else beta), p(y), p(codes_out[0] if codes_out else None)),
                m, n, k, gs, DEV)
            return y

        c["at_plan"] = at_plan
    return c


def _k5_case(torch, gen, m, gs, extras, span=False):
    """K5 (requant + o_proj + residual), or with ``span`` K12's requant
    entry, at the main path's width; ``extras`` turns on beta."""
    from dgq_tpu_torch.ops import _cuda
    from dgq_tpu_torch.ops import fused_decode as fd

    n, k = LINEARS["o_proj"]
    qw, ws, wz = _q4_weights(torch, gen, k, n, gs)
    qw, qw_rp, deq = _layout(torch, qw, gs, span)
    planes = _plane_rows(ws, wz)
    csf = torch.zeros((n,), dtype=torch.int32, device=DEV)
    alpha = torch.rand((n,), generator=gen, device=DEV) * 1e-3 + 1e-5
    beta = torch.randn((n,), generator=gen, device=DEV) if extras else None
    one = torch.ones((n,), device=DEV)
    x = torch.randn((m, k), generator=gen, device=DEV)
    res = torch.randn((m, n), generator=gen, device=DEV)
    scale = torch.full((), 0.05, device=DEV)
    fn, plain_fn = ((fd.fused_requant_gemv, fd.fused_requant_gemv_xla) if span
                    else (fd.fused_requant_gemv_rp, fd.fused_requant_gemv_rp_xla))
    w = (qw, *planes) if span else (qw, *planes, csf)

    def kern(acc, codes_out, fn=fn, w=w):
        return fn(x, scale, *w, one if acc else alpha, None if acc else beta,
                  None if acc else res, span=2 * gs, qmin=-127.0, fuse_residual=not acc,
                  codes_out=codes_out[0] if codes_out else None)

    def plain(acc, codes):
        return plain_fn(x, scale, *w, one if acc else alpha, None if acc else beta,
                        None if acc else res, span=2 * gs, qmin=-127.0, fuse_residual=not acc,
                        codes=codes[0] if codes else None)

    def lib(timer):
        return _int_mm_times(torch, timer, fd._requant_q(x, scale, -127.0),
                             deq(qw, ws, wz, gs))

    def own(codes):
        return [fd._requant_q(x, scale, -127.0)]

    c = {"what": f"{'K12 requant' if span else 'K5'} M={m} gs={gs}", "kern": kern,
         "plain": plain, "own": own, "exact": own,
         "shapes": [(m, k)], "names": K12_NAMES["fused_requant_gemv"] if span else K5_NAMES,
         "meta": {"linear": "o_proj", "M": m, "N": n, "K": k},
         "nbytes": 4 * m * k + 4 + k * n // 2 + 2 * (k // gs) * n + 4 * n + 8 * m * n,
         "ops": 2.0 * m * n * k, "lib": lib}
    if span:  # K5 on the rowpair copy of the same bytes
        c["twin"] = functools.partial(kern, fn=fd.fused_requant_gemv_rp,
                                      w=(qw_rp, *planes, csf))
        c["twin_names"] = K5_NAMES

        def at_plan(acc, codes_out, plan):
            y = torch.empty((m, n), dtype=torch.float32, device=DEV)
            p = _cuda.ptr
            fd.launch_gemv(fd.REQUANT_SPAN, plan, (
                p(x), p(scale), -127.0, p(qw), *map(p, planes), p(one if acc else alpha),
                p(None if acc else beta), p(None if acc else res), p(y),
                p(codes_out[0] if codes_out else None)), m, n, k, gs, DEV)
            return y

        c["at_plan"] = at_plan
    return c


def _k6_case(torch, gen, m, gs, extras, span=False):
    """K6 (the MLP), or with ``span`` K12's MLP entry, at the main path's
    width; ``extras`` turns on the norm bias and the down-proj beta."""
    from dgq_tpu_torch.ops import _cuda
    from dgq_tpu_torch.ops import fused_decode as fd

    eps = 1e-5
    n2f, d = LINEARS["gate_up_proj"]
    f = n2f // 2
    gqw, gws, gwz = _q4_weights(torch, gen, d, n2f, gs)
    dqw, dws, dwz = _q4_weights(torch, gen, f, d, gs)
    gqw, gqw_rp, deq = _layout(torch, gqw, gs, span)
    dqw, dqw_rp, _ = _layout(torch, dqw, gs, span)
    gplanes = _plane_rows(gws, gwz)
    dws8, dwz8 = torch.repeat_interleave(dws, 8, dim=0), torch.repeat_interleave(dwz, 8, dim=0)
    gcsf = torch.zeros((n2f,), dtype=torch.int32, device=DEV)
    dcsf = torch.zeros((d,), dtype=torch.int32, device=DEV)
    galpha = torch.rand((n2f,), generator=gen, device=DEV) * 1e-3 + 5e-4
    dalpha = torch.rand((d,), generator=gen, device=DEV) * 1e-3 + 1e-5
    dbeta = torch.randn((d,), generator=gen, device=DEV) if extras else None
    lnb = torch.randn((d,), generator=gen, device=DEV) if extras else None
    one = torch.ones((d,), device=DEV)
    lnw = torch.full((d,), 10.0, device=DEV)
    hscale = torch.full((), 0.5, device=DEV)
    x = torch.randn((m, d), generator=gen, device=DEV)

    def args(acc, gq=gqw, dq=dqw, rowpair=not span):
        if rowpair:
            return (x, lnw, lnb, gq, *gplanes, gcsf, galpha, hscale, dq, dws8, dwz8, dcsf,
                    one if acc else dalpha, None if acc else dbeta)
        return (x, lnw, lnb, gq, *gplanes, galpha, hscale, dq, dws8, dwz8,
                one if acc else dalpha, None if acc else dbeta)

    fn, plain_fn = ((fd.fused_mlp_decode, fd.fused_mlp_decode_xla) if span
                    else (fd.fused_mlp_decode_rp, fd.fused_mlp_decode_rp_xla))

    def kern(acc, codes_out):
        return fn(*args(acc), span=2 * gs, bf=512, eps=eps, fuse_residual=not acc,
                  codes_out=codes_out)

    def plain(acc, codes):
        return plain_fn(*args(acc), span=2 * gs, eps=eps, fuse_residual=not acc, codes=codes)

    def own(codes):
        # the down-proj input codes from the kernel's norm codes: checks
        # SiLU * up on its own, not a norm code flip passed on
        product = fd._span_product if span else fd._plane_product
        gu = product(codes[0], gqw, *gplanes, gs)
        return [fd._rmsnorm_q(x, lnw, lnb, eps),
                fd._silu_mul_q(gu[:, :f], gu[:, f:], galpha[:f], galpha[f:], hscale)]

    def lib(timer):
        hq = torch.randint(-128, 128, (m, f), generator=gen, device=DEV, dtype=torch.int8)
        return _sum_times(_int_mm_times(torch, timer, fd._rmsnorm_q(x, lnw, lnb, eps),
                                        deq(gqw, gws, gwz, gs)),
                          _int_mm_times(torch, timer, hq, deq(dqw, dws, dwz, gs)))

    c = {"what": f"{'K12 mlp' if span else 'K6'} M={m} gs={gs}", "kern": kern, "plain": plain,
         "own": own, "shapes": [(m, d), (m, f)],
         "names": K12_NAMES["fused_mlp_decode"] if span else K6_NAMES,
         "meta": {"M": m, "D": d, "F": f},
         "nbytes": (8 * m * d + 4 * d + d * n2f // 2 + 2 * (d // gs) * n2f + 4 * n2f
                    + f * d // 2 + 2 * (f // gs) * d + 4 * d + 4),
         "ops": 2.0 * m * (n2f * d + f * d), "lib": lib}
    # the codes exactly: the norm codes are K4's (RMSNormQ in the kernel's order), the h
    # codes _silu_mul_q of the plain gate/up sums on them
    c["exact"] = lambda codes: [_rmsnorm_q_ordered(torch, x, lnw, lnb, eps), own(codes)[1]]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    layout = "span" if span else "rowpair"
    c["meta"]["plans"] = [p._asdict() for p in fd.mlp_plan(m, d, f, gs, sms, layout)]
    if span:  # K6 on the rowpair copies of the same bytes
        c["twin"] = lambda acc, codes_out: fd.fused_mlp_decode_rp(
            *args(acc, gqw_rp, dqw_rp, rowpair=True), span=2 * gs, bf=512, eps=eps,
            fuse_residual=not acc, codes_out=codes_out)
        c["twin_names"] = K6_NAMES

        def at_plan(acc, codes_out, plans):
            """K12's MLP under the legs' ``plans`` (gate|up, down), launched as
            ``fused_plan_sweep`` launches it; ``codes_out`` = (xq, h)."""
            y = torch.empty((m, d), dtype=torch.float32, device=DEV)
            xq, h = codes_out if codes_out else (None, torch.empty((m, f), dtype=torch.int8,
                                                                   device=DEV))
            p = _cuda.ptr
            fd.launch_mlp(fd.MLP_SPAN, plans, (
                p(x), p(lnw), p(lnb), eps, p(hscale), p(gqw), *map(p, gplanes), p(galpha),
                p(dqw), p(dws8), p(dwz8), p(one if acc else dalpha), p(None if acc else dbeta),
                int(not acc), p(y), p(xq), p(h)), m, d, f, gs, DEV)
            return y

        c["at_plan"] = at_plan
    return c


FUSED_CASES = {"k4": _k4_case, "k5": _k5_case, "k6": _k6_case}
# K12's entries: K4-K6's case makers on span weights
SPAN_CASES = {"fused_norm_gemv": _k4_case, "fused_requant_gemv": _k5_case,
                 "fused_mlp_decode": _k6_case}


def _fused_cases(torch, timer, gen, span=False):
    """K4-K6, or with ``span`` K12's three entries, at the main path's row
    counts: checked and timed (K12 beside its K4-K6 twin on the rowpair
    copy of the same bytes, ``twin_ms``)."""
    makers = SPAN_CASES if span else FUSED_CASES
    out = {key: [] for key in makers}
    for m in FUSED_ROWS:
        for key, build in makers.items():
            c = build(torch, gen, m, 128, extras=False, span=span)
            case = _fused_check(torch, c)

            def run(c=c):
                return c["kern"](False, None)

            b_ms, b_by = bound_ms(c["nbytes"], c["ops"] / INT8_OPS_PER_S)
            case.update({"ms": timer.kernel(run, c["names"]), "call_ms": timer(run),
                         "plain_ms": timer(lambda c=c: c["plain"](False, None), iters=10),
                         "bound_ms": b_ms, "bound_by": b_by, **c["lib"](timer)})
            if "twin" in c:
                case["twin_ms"] = timer.kernel(lambda c=c: c["twin"](False, None),
                                               c["twin_names"])
            out[key].append(case)
            del c
    return out


# K12's norm and requant entries held under every plan of fused_candidates(..., "span"): rows
# (every token-row tile, ragged and full) by group size (QS 2 at 32; 1 at 64; whole spans of
# two stages at 128)
SPAN_SWEEP_ROWS, SPAN_SWEEP_GS = (1, 4, 5, 9, 40, 64), (32, 64, 128)


def _span_gemv_sweep(torch, gen):
    """K12's norm and requant entries at SPAN_SWEEP_ROWS x SPAN_SWEEP_GS
    with beta, the residual (requant) and the norm bias on, under every plan
    of ``fused_candidates(..., "span")``, each launched as the sweep script
    launches it (``launch_gemv``; the wrappers take ``fused_plan``'s plan,
    which the kernels phase holds): the codes they hand out equal the
    plain requant and RMSNormQ summed in the kernels' order, the int32
    accumulators equal the plain version's on them and K4's or K5's on the
    rowpair copy, and the outputs lie within rtol 1e-6 of the plain
    version's.  (Not timed here: CUDA events would time the host;
    ``python -m dgq_tpu_torch.scripts.fused_plan_sweep
    --span`` times every plan.)"""
    from dgq_tpu_torch.ops import fused_decode as fd

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for m, gs in itertools.product(SPAN_SWEEP_ROWS, SPAN_SWEEP_GS):
        for key in ("fused_norm_gemv", "fused_requant_gemv"):
            c = SPAN_CASES[key](torch, gen, m, gs, extras=True, span=True)
            norm, (n, k) = key == "fused_norm_gemv", (c["meta"]["N"], c["meta"]["K"])
            want = c["exact"](None)
            acc_p, y_p = c["plain"](True, want), c["plain"](False, want)
            twin_codes = [torch.empty_like(t) for t in want]
            acc_twin = c["twin"](True, twin_codes)
            if not torch.equal(twin_codes[0], want[0]):
                raise AssertionError(f"{c['what']}: the twin's codes differ")
            chosen = fd.fused_plan(m, n, k, gs, sms, norm, "span")
            plans = fd.fused_candidates(m, n, k, gs, "span")
            for plan in plans:
                what = f"{c['what']} {plan}"
                codes = [torch.empty_like(t) for t in want]
                acc = c["at_plan"](True, codes, plan)
                for tag, got, ref in (("codes", codes[0], want[0]), ("accumulators", acc, acc_p),
                                      ("accumulators against the twin", acc, acc_twin)):
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{what}: {(got != ref).sum().item()} {tag} differ")
                torch.testing.assert_close(c["at_plan"](False, None, plan), y_p, rtol=1e-6,
                                           atol=0)
            out.append({**c["meta"], "kernel": key, "groupsize": gs, "plans": len(plans),
                        "chosen": chosen._asdict(), "bit_equal": True, "codes_equal": True,
                        "int32_equal_rowpair_kernel": True})
            del c
    return out


def _span_mlp_sweep(torch, gen):
    """K12's MLP at SPAN_SWEEP_ROWS x SPAN_SWEEP_GS with the norm bias, the
    down-proj beta and the residual on, under every plan of each leg
    (``fused_candidates(..., "span")`` of its product) with the other leg at
    ``mlp_plan``'s, each launched as the sweep script launches it
    (``launch_mlp``): the xq and h codes equal RMSNormQ in the kernels'
    order and ``_silu_mul_q`` of the plain gate/up sums on those codes, the
    int32 sums of the down leg equal the plain version's on them and K6's
    on the rowpair copy, and the outputs lie within rtol 1e-6 of the plain
    version's.  (Not timed here; ``fused_plan_sweep --span`` times every
    plan.)"""
    from dgq_tpu_torch.ops import fused_decode as fd

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for m, gs in itertools.product(SPAN_SWEEP_ROWS, SPAN_SWEEP_GS):
        c = _k6_case(torch, gen, m, gs, extras=True, span=True)
        d, f = c["meta"]["D"], c["meta"]["F"]
        # the ordered norm codes, then h from the plain gate/up sums on them
        want = c["exact"](c["exact"]([torch.zeros((m, d), dtype=torch.int8, device=DEV)]))
        acc_p, y_p = c["plain"](True, want), c["plain"](False, want)
        twin_codes = [torch.empty_like(t) for t in want]
        acc_twin = c["twin"](True, twin_codes)
        for tag, got, ref in (("xq", twin_codes[0], want[0]), ("h", twin_codes[1], want[1])):
            if not torch.equal(got, ref):
                raise AssertionError(f"{c['what']}: the twin's {tag} codes differ")
        chosen = fd.mlp_plan(m, d, f, gs, sms, "span")
        calls = 0
        for leg, (n, k) in enumerate(((2 * f, d), (d, f))):
            for plan in fd.fused_candidates(m, n, k, gs, "span"):
                plans = (plan, chosen[1]) if leg == 0 else (chosen[0], plan)
                what = f"{c['what']} leg {leg} {plan}"
                codes = [torch.empty_like(t) for t in want]
                acc = c["at_plan"](True, codes, plans)
                for tag, got, ref in (("xq codes", codes[0], want[0]),
                                      ("h codes", codes[1], want[1]),
                                      ("accumulators", acc, acc_p),
                                      ("accumulators against the twin", acc, acc_twin)):
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{what}: {(got != ref).sum().item()} {tag} differ")
                torch.testing.assert_close(c["at_plan"](False, None, plans), y_p, rtol=1e-6,
                                           atol=0)
                calls += 1
        out.append({**c["meta"], "kernel": "fused_mlp_decode", "groupsize": gs,
                    "plans": calls, "bit_equal": True, "codes_equal": True,
                    "int32_equal_rowpair_kernel": True})
        del c
    return out


def _fused_sweep(torch, gen, span=False):
    """K6 checked (not timed) off the main path's shapes: 1 row, 9 rows at
    groupsize 64, and 64 rows (the engine's cap), then 4 and 40 rows at
    groupsize 32 (one scale row a 32-k step: the legs' other instantiation,
    after the first in the same process), with bias, beta and residual on;
    with ``span`` K12's MLP and its norm and requant entries under every
    plan (``_span_mlp_sweep``, ``_span_gemv_sweep``).  (K4 and K5:
    ``_rowpair_gemv_checks``.)"""
    if span:
        return _span_mlp_sweep(torch, gen) + _span_gemv_sweep(torch, gen)
    out = []
    for m, gs in ((1, 128), (9, 64), (64, 128), (4, 32), (40, 32)):
        out.append({**_fused_check(torch, _k6_case(torch, gen, m, gs, extras=True)),
                    "groupsize": gs})
    return out


# K4 and K5 held bit-equal, not timed: every token-row tile, clusters or none, groupsize 64
# and 128, and (at 9 and 40 rows) RAGGED_N columns past the main path's width, which a
# 128-column block covers in part; then at FUSED_GS32_ROWS rows groupsize 32, whose
# kernels (a scale row a 32-k step) run after the others' in one process
FUSED_CHECK_ROWS = (1, 4, 8, 9, 17, 40, 64)
RAGGED_N = 96
FUSED_GS32_ROWS = (1, 4, 17, 40, 64)


def _rmsnorm_q_ordered(torch, x, w, b, eps):
    """RMSNormQ codes summed in the CUDA kernels' fixed order
    (``fgemv::rmsnorm_codes``, ``row_rsqrt`` in csrc/fused_gemv_sm90.cuh):
    lane l of a warp adds the squares of x[4l + 128j + c] for j = 0, 1, ...
    and c = 0..3 in turn, then an xor butterfly adds the 32 lane sums; each
    step one fp32 operation rounded on its own.  The plain version's
    torch.mean sums in another order, so one code in ~10^5 lands 1 apart."""
    m, k = x.shape
    sq = (x * x).reshape(m, k // 128, 32, 4)
    ss = torch.zeros((m, 32), dtype=torch.float32, device=x.device)
    for j in range(k // 128):
        for c in range(4):
            ss = ss + sq[:, j, :, c]
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        ss = ss + ss[:, lanes ^ o]
    y = x * torch.rsqrt(ss[:, :1] / k + eps) * w
    if b is not None:
        y = y + b
    return torch.clamp(torch.round(y), -128, 127).to(torch.int8)


def _rowpair_gemv_checks(torch, gen):
    """K4 and K5 against their plain versions: the codes they hand out
    (``codes_out``) equal K5's plain requant and, for K4, the RMSNormQ codes
    summed in the kernel's fixed order (``_rmsnorm_q_ordered``; the plain
    version's within 1 and >= 99.9% equal); the int32 accumulators (alpha 1,
    no beta, no residual) equal the plain version's on those codes, and so
    do the outputs with beta, K5's residual, K4's norm bias and
    ``codes_out`` each on and off (the handed-out codes again equal)."""
    from dgq_tpu_torch.ops import fused_decode as fd

    eps, sms = 1e-5, torch.cuda.get_device_properties(0).multi_processor_count
    shapes = ([(m, gs, 0) for gs in (64, 128) for m in FUSED_CHECK_ROWS]
              + [(m, 64, RAGGED_N) for m in (9, 40)]
              + [(m, 32, 0) for m in FUSED_GS32_ROWS] + [(9, 32, RAGGED_N)])
    out = []
    for (m, gs, extra), norm in itertools.product(shapes, (True, False)):
        n, k = LINEARS["qkv_proj" if norm else "o_proj"]
        n += extra
        qw, ws, wz = _q4_weights(torch, gen, k, n, gs)
        w = (qw, *_plane_rows(ws, wz), torch.zeros((n,), dtype=torch.int32, device=DEV))
        alpha = torch.rand((n,), generator=gen, device=DEV) * 1e-3 + 1e-5
        beta = torch.randn((n,), generator=gen, device=DEV)
        one = torch.ones((n,), device=DEV)
        x = torch.randn((m, k), generator=gen, device=DEV)
        lnw = torch.full((k,), 10.0, device=DEV)
        scale = torch.full((), 0.05, device=DEV)
        # K4: without and with the norm bias (it moves the codes); K5: without and with the
        # residual (it does not)
        sides = (None, torch.randn((k,) if norm else (m, n), generator=gen, device=DEV))
        what = f"{'K4' if norm else 'K5'} M={m} N={n} gs={gs}"

        def run(a, b, side, codes_out=None, codes=None):
            if norm:
                fn = fd.fused_norm_gemv_rp if codes is None else fd.fused_norm_gemv_rp_xla
                kw = {"codes_out": codes_out} if codes is None else {"codes": codes}
                return fn(x, lnw, side, *w, a, b, span=2 * gs, eps=eps, **kw)
            fn = fd.fused_requant_gemv_rp if codes is None else fd.fused_requant_gemv_rp_xla
            kw = {"codes_out": codes_out} if codes is None else {"codes": codes}
            return fn(x, scale, *w, a, b, side, span=2 * gs, qmin=-127.0,
                      fuse_residual=side is not None, **kw)

        def check_equal(tag, got, want):
            if not torch.equal(got, want):
                raise AssertionError(f"{what} {tag}: {(got != want).sum().item()} differ")

        runs, plain_stats = 0, []
        for side in (sides if norm else sides[:1]):
            codes = torch.empty((m, k), dtype=torch.int8, device=DEV)
            acc = run(one, None, side, codes_out=codes)
            if norm:
                check_equal("codes", codes, _rmsnorm_q_ordered(torch, x, lnw, side, eps))
                plain_stats.append(_code_stats(codes, fd._rmsnorm_q(x, lnw, side, eps)))
                _check_codes(f"{what} codes against the plain version", plain_stats[-1])
            else:
                check_equal("codes", codes, fd._requant_q(x, scale, -127.0))
            check_equal("accumulators", acc, run(one, None, side, codes=codes))
            for b, s2, co in itertools.product((None, beta), sides if not norm else (side,),
                                               (False, True)):
                got = torch.empty_like(codes) if co else None
                check_equal(f"outputs (beta {b is not None}, side {s2 is not None}, "
                            f"codes_out {co})", run(alpha, b, s2, codes_out=got),
                            run(alpha, b, s2, codes=codes))
                if co:
                    check_equal("handed-out codes", got, codes)
                runs += 1
        plan = fd.fused_plan(m, n, k, gs, sms, norm)
        out.append({"kernel": "K4" if norm else "K5", "M": m, "N": n, "K": k, "groupsize": gs,
                    "plan": plan._asdict(), "output_runs": runs, "bit_equal": True,
                    "codes_equal": True, "max_abs_err": 0.0,
                    "codes_vs_plain": [{"max_diff": d, "equal_share": e} for d, e in plain_stats]})
        del qw, ws, wz, w, x
    return out


def _k9_cases(torch, timer, gen):
    """K9 at OPT-6.7B shapes: q|k|v int8 out, the others f32 out, every one
    with a bias, at a decode step, a prefill and a perplexity window.  The
    int32 accumulators (alpha 1, no bias) and the outputs must equal the
    plain version's."""
    from dgq_tpu_torch.ops.quant_matmul import dequantize_span, w4a8_matmul_packed, \
        w4a8_matmul_packed_xla

    cases = []
    gs = 128
    for m in SPAN_ROWS:
        for name, (n, k) in OPT_LINEARS.items():
            od = torch.int8 if name == "qkv_proj" else torch.float32
            x = torch.randint(-128, 128, (m, k), generator=gen, device=DEV, dtype=torch.int8)
            qw, ws, wz = _q4_weights(torch, gen, k, n, gs)
            ws8, wz8 = torch.repeat_interleave(ws, 8, dim=0), torch.repeat_interleave(wz, 8, dim=0)
            alpha = torch.rand((n,), generator=gen, device=DEV) * 1e-3 + 1e-5
            beta = torch.randn((n,), generator=gen, device=DEV)
            one = torch.ones((n,), device=DEV)

            def kern(a=alpha, b=beta, o=od):
                return w4a8_matmul_packed(x, qw, ws8, wz8, a, b, groupsize=gs, out_dtype=o,
                                          scales_replicated=True)

            def plain(a=alpha, b=beta, o=od):
                return w4a8_matmul_packed_xla(x, qw, ws, wz, a, b, groupsize=gs, out_dtype=o)

            what = f"K9 {name} M={m}"
            acc_k, acc_p = kern(one, None, torch.float32), plain(one, None, torch.float32)
            torch.cuda.synchronize()
            if not torch.equal(acc_k, acc_p):
                raise AssertionError(f"{what}: {(acc_k != acc_p).sum().item()} accumulators differ")
            y_k, y_p = kern(), plain()
            if not torch.equal(y_k, y_p):
                raise AssertionError(f"{what}: {(y_k != y_p).sum().item()} outputs differ")
            lib = _int_mm_times(torch, timer, x, dequantize_span(qw, ws, wz, gs))
            nbytes = m * k + k * n // 2 + 2 * (k // gs) * n + 8 * n + od.itemsize * m * n
            b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k / INT8_OPS_PER_S)
            cases.append({"linear": name, "M": m, "N": n, "K": k, "out": str(od)[6:],
                          "max_abs_err": (y_k.float() - y_p.float()).abs().max().item(),
                          "ms": timer.kernel(kern, K9_NAMES), "call_ms": timer(kern),
                          "plain_ms": timer(plain, iters=5), **lib,
                          "library_rows": max(m, 32), "bound_ms": b_ms, "bound_by": b_by})
            del x, qw, ws, wz, ws8, wz8, acc_k, acc_p, y_k, y_p
    return cases + _gemm_extra_cases(torch, gen, span=True)


# K10 held (not timed) off the timed cases: (M, linear, groupsize, beta): a lone row, the
# decode tile's last and the prefill tile's first row count, groupsize 64 (stages of 64 packed
# rows, two a span at 128) and 32 (stages of 32 packed rows, one group a plane), no bias
K10_EXTRA = ((1, "o_proj", 128, True), (16, "qkv_proj", 128, True), (17, "down_proj", 128, True),
             (16, "gate_up_proj", 128, False), (4, "o_proj", 64, False),
             (1024, "o_proj", 64, True), (4, "qkv_proj", 32, True), (17, "o_proj", 32, False),
             (1024, "down_proj", 32, False))


def _k10_case(torch, gen, m, n, k, gs, beta_on):
    """K10 on random operands against its plain version: equal unsplit,
    within K10_TOL of the largest output split.  Returns the check's record
    and the (kern, plain, x, w_fp) the timed cases use."""
    from dgq_tpu_torch.ops import quant_matmul as qm
    from dgq_tpu_torch.quant.packing import unpack_nibbles

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = torch.randint(-128, 128, (m, k), generator=gen, device=DEV, dtype=torch.int8)
    qw, ws, wz = _q4_weights(torch, gen, k, n, gs, fp=True)
    ws8, wz8 = torch.repeat_interleave(ws, 8, dim=0), torch.repeat_interleave(wz, 8, dim=0)
    alpha = torch.rand((n,), generator=gen, device=DEV) * 1e-3 + 1e-5
    beta = torch.randn((n,), generator=gen, device=DEV) if beta_on else None
    plan = qm.fpscale_plan(m, n, k, gs, sms)

    def kern():
        return qm.w4a8_fpscale_matmul_packed(x, qw, ws8, wz8, alpha, beta, groupsize=gs,
                                             scales_replicated=True)

    def plain():
        return qm.w4a8_fpscale_matmul_packed_xla(x, qw, ws, wz, alpha, beta, groupsize=gs)

    splits = -(-(k // 2) // plan[1])
    y_k, y_p = kern(), plain()
    torch.cuda.synchronize()
    err = (y_k - y_p).abs().max().item()
    top = y_p.abs().max().item()
    equal = torch.equal(y_k, y_p)
    if not (equal or (splits > 1 and err <= K10_TOL * top)):
        raise AssertionError(f"K10 M={m} N={n} K={k} gs={gs} plan {plan} ({splits} splits): "
                             f"max abs err {err}, largest output {top}")

    def w_fp():
        codes = unpack_nibbles(qw, 2 * gs).float()
        return (codes - torch.repeat_interleave(wz, gs, dim=0)) * torch.repeat_interleave(
            ws, gs, dim=0)

    rec = {"M": m, "N": n, "K": k, "groupsize": gs, "beta": beta_on, "tile": plan[0],
           "splits": splits, "bit_equal": equal, "max_abs_err": err, "largest_output": top}
    return rec, (kern, plain, x, w_fp)


def _k10_cases(torch, timer, gen):
    """K10 at LLaMA-2-7B shapes (fp32 group scales) at a decode step, a
    prefill and 2048 rows, timed (at 1024 and 2048 rows beside K9 on int8
    scales of the same shapes), then at K10_EXTRA, held only: equal to the plain version where K is not
    split over blocks, within K10_TOL of the largest output where it is."""
    from dgq_tpu_torch.ops import quant_matmul as qm

    def alpha_one(n):
        return torch.ones((n,), device=DEV)

    cases = []
    gs = 128
    for m in SPAN_ROWS:
        for name, (n, k) in LINEARS.items():
            rec, (kern, plain, x, w_fp) = _k10_case(torch, gen, m, n, k, gs, True)
            xf, wf = x.float(), w_fp()
            lib = timer.library(lambda: torch.matmul(xf, wf))
            del xf, wf
            g = k // gs
            nbytes = m * k + k * n // 2 + 8 * g * n + 8 * n + 4 * m * n
            flops = 4.0 * m * n * g + 2.0 * m * n  # per group s * (d - z * rowsum) + acc; epilogue
            b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k / INT8_OPS_PER_S,
                                  flops / FP32_OPS_PER_S)
            case = {"linear": name, **rec, "ms": timer.kernel(kern, K10_NAMES),
                    "call_ms": timer(kern), "plain_ms": timer(plain, iters=5), **lib,
                    "bound_ms": b_ms, "bound_by": b_by}
            if m > qm.DECODE_ROWS:
                # the yardstick of the same shapes: K9 on int8 scales
                qw9, ws9, wz9 = (torch.repeat_interleave(t, 8, dim=0) if i else t
                                 for i, t in enumerate(_q4_weights(torch, gen, k, n, gs)))
                case["k9_same_shape_ms"] = timer.kernel(
                    lambda: qm.w4a8_matmul_packed(x, qw9, ws9, wz9, alpha_one(n), None,
                                                  groupsize=gs, scales_replicated=True), K9_NAMES)
                del qw9, ws9, wz9
            cases.append(case)
    for m, name, gsx, beta_on in K10_EXTRA:
        n, k = LINEARS[name]
        rec, _ = _k10_case(torch, gen, m, n, k, gsx, beta_on)
        cases.append({"linear": name, **rec, "extra": True})
    return cases


def _check_close(what, got, ref, tol=1e-5) -> float:
    err = (got - ref).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: max abs err {err} > {tol}")
    return err


def _k7_cases(torch, timer, gen):
    """K7 at 7B long-context shapes: Smax 16384 in AUTO chunks of 4096, the
    slots' lengths spread over the chunks."""
    from dgq_tpu_torch.ops.attention import int8_decode_attention_chunked, \
        int8_decode_attention_xla

    cases = []
    b, h, dh = BATCH, 32, 128
    lengths = torch.tensor(K7_LENGTHS, dtype=torch.int32, device=DEV)
    for hk, quant_pv in ((32, True), (32, False), (8, True)):
        q, kt, v, (qs, ks, vs) = _attn_inputs(torch, gen, b, h, hk, 1, dh, LONG_SMAX)
        q = q[:, :, 0].contiguous()

        def kern():
            return int8_decode_attention_chunked(q, kt, v, lengths, qs, ks, vs, chunk=LONG_CHUNK,
                                                 quant_pv=quant_pv)

        def plain():
            return int8_decode_attention_xla(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv)

        err = _check_close(f"K7 Hkv={hk} quant_pv={quant_pv}", kern(), plain())
        b_ms, b_by = _decode_bound(b, h, hk, dh, sum(K7_LENGTHS), quant_pv)
        cases.append({"B": b, "H": h, "Hkv": hk, "Smax": LONG_SMAX, "chunk": LONG_CHUNK,
                      "lengths": list(K7_LENGTHS), "quant_pv": quant_pv, "max_abs_err": err,
                      "ms": timer.kernel(kern, K78_NAMES), "call_ms": timer(kern),
                      "plain_ms": timer(plain, iters=5), "bound_ms": b_ms, "bound_by": b_by,
                      **_sdpa_decode_ms(torch, timer, q, kt, v, (qs, ks, vs), lengths)})
        del q, kt, v
    return cases


def _paged_table(lengths, npg, seed):
    """A (slots, npg) int32 table of distinct shuffled pool pages 1.. for the
    pages each length needs; the entries past them point at null page 0."""
    import numpy as np

    need = [-(-n // PS) for n in lengths]
    perm = np.random.default_rng(seed).permutation(np.arange(1, 1 + len(lengths) * npg))
    table = np.zeros((len(lengths), npg), np.int32)
    k = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[k:k + n]
        k += n
    return table


def _contiguous_pool(torch, kt_pool, v_pool, table):
    """The dense (B, Hkv, Dh, NP*ps) K and V of a pool's slots, and the same
    pages laid out as pool pages 1.. in slot order behind the null page (the
    pool of an identity table)."""
    from dgq_tpu_torch.ops.attention import gather_paged_kv

    slots, npg = table.shape
    _, hk, dh, ps = kt_pool.shape
    kt, v = [t.contiguous() for t in gather_paged_kv(kt_pool, v_pool, table)]
    kt_c = torch.cat([kt_pool[:1], kt.reshape(slots, hk, dh, npg, ps).permute(
        0, 3, 1, 2, 4).reshape(slots * npg, hk, dh, ps)]).contiguous()
    v_c = torch.cat([v_pool[:1], v.reshape(slots, hk, npg, ps, dh).permute(
        0, 2, 1, 3, 4).reshape(slots * npg, hk, ps, dh)]).contiguous()
    return kt, v, kt_c, v_c


def _k8_cases(torch, timer, gen):
    """K8 at 7B serving shapes: 8 slots, 128-token pages, a pool of 1 + 8 x
    16 pages, a shuffled table with null-page entries, lengths 1..2048 across
    page boundaries.  Each case also holds K8 on a contiguous table against
    K3 on the same dense cache."""
    from dgq_tpu_torch.ops.attention import int8_decode_attention, \
        int8_paged_decode_attention, int8_paged_decode_attention_xla

    cases = []
    h, dh, npg = 32, 128, SMAX // PS
    pages = 1 + SLOTS * npg
    lengths = torch.tensor(K8_LENGTHS, dtype=torch.int32, device=DEV)
    table = torch.from_numpy(_paged_table(K8_LENGTHS, npg, seed=8)).to(DEV)
    for hk, quant_pv in ((32, True), (32, False), (8, True)):
        def ri(shape):
            return torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8)

        q = ri((SLOTS, h, dh))
        kt_pool, v_pool = ri((pages, hk, dh, PS)), ri((pages, hk, PS, dh))
        qs, ks, vs = [torch.rand((), generator=gen, device=DEV) * 0.02 + 0.01 for _ in range(3)]

        def kern():
            return int8_paged_decode_attention(q, kt_pool, v_pool, table, lengths, qs, ks, vs,
                                               quant_pv=quant_pv)

        def plain():
            return int8_paged_decode_attention_xla(q, kt_pool, v_pool, table, lengths, qs, ks,
                                                   vs, quant_pv=quant_pv)

        what = f"K8 Hkv={hk} quant_pv={quant_pv}"
        out_k = kern()
        err = _check_close(what, out_k, plain())
        # the same cache dense, and as pages 1.. on an identity table
        kt, v, kt_c, v_c = _contiguous_pool(torch, kt_pool, v_pool, table)
        ident = (1 + torch.arange(SLOTS * npg, device=DEV, dtype=torch.int32)).reshape(SLOTS, npg)
        err_k3 = _check_close(
            f"{what} contiguous table vs K3",
            int8_paged_decode_attention(q, kt_c, v_c, ident, lengths, qs, ks, vs,
                                        quant_pv=quant_pv),
            int8_decode_attention(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv))
        # the valid positions' K and V, as K3 and K7 count them, plus the table
        b_ms, b_by = _decode_bound(SLOTS, h, hk, dh, sum(K8_LENGTHS), quant_pv,
                                   extra_bytes=4 * SLOTS * npg)
        cases.append({"slots": SLOTS, "H": h, "Hkv": hk, "page": PS, "pool_pages": pages,
                      "table_width": npg, "lengths": list(K8_LENGTHS), "quant_pv": quant_pv,
                      "max_abs_err": err, "max_abs_err_vs_k3_contiguous": err_k3,
                      "ms": timer.kernel(kern, K78_NAMES), "call_ms": timer(kern),
                      "plain_ms": timer(plain, iters=10), "bound_ms": b_ms, "bound_by": b_by,
                      **_sdpa_decode_ms(torch, timer, q, kt, v, (qs, ks, vs), lengths)})
        del kt_pool, v_pool, kt, v, kt_c, v_c
    return cases


def _k11_cases(torch, timer, gen):
    """K11 at 7B serving shapes on INT4 nibble pages: K8's pool, table and
    lengths with random bytes (two signed codes each), MHA and GQA.  Each
    case also holds K11 on a contiguous table against K8 without quant_pv on
    the unpacked INT8 pool of the same codes."""
    from dgq_tpu_torch.ops.attention import int4_paged_decode_attention, \
        int4_paged_decode_attention_xla, int8_paged_decode_attention
    from dgq_tpu_torch.ops.kv4 import unpack_nibbles

    cases = []
    h, dh, npg = 32, 128, SMAX // PS
    pages = 1 + SLOTS * npg
    lengths = torch.tensor(K8_LENGTHS, dtype=torch.int32, device=DEV)
    table = torch.from_numpy(_paged_table(K8_LENGTHS, npg, seed=11)).to(DEV)
    ident = (1 + torch.arange(SLOTS * npg, device=DEV, dtype=torch.int32)).reshape(SLOTS, npg)
    for hk in (32, 8):
        def ri(lo, shape):
            return torch.randint(lo, 128, shape, generator=gen, device=DEV, dtype=torch.int8)

        q = ri(-127, (SLOTS, h, dh))
        kt_pool, v_pool = ri(-128, (pages, hk, dh // 2, PS)), ri(-128, (pages, hk, PS, dh // 2))
        # the caller's effective int4 scales (int8 scales x 127 / 7)
        qs, ks4, vs4 = [torch.rand((), generator=gen, device=DEV) * 0.02 + 0.01 for _ in range(3)]
        ks4, vs4 = ks4 * 127 / 7, vs4 * 127 / 7

        def kern():
            return int4_paged_decode_attention(q, kt_pool, v_pool, table, lengths, qs, ks4, vs4)

        def plain():
            return int4_paged_decode_attention_xla(q, kt_pool, v_pool, table, lengths, qs, ks4,
                                                   vs4)

        what = f"K11 Hkv={hk}"
        out_k, out_p = kern(), plain()
        top = out_p.abs().max().item()
        err = _check_close(what, out_k, out_p, K11_TOL * top)
        # on a contiguous table: the nibble pages through K11, and the same
        # codes unpacked into an INT8 pool through K8
        _, _, kt_c4, v_c4 = _contiguous_pool(torch, kt_pool, v_pool, table)
        kt, v, kt_c, v_c = _contiguous_pool(torch, unpack_nibbles(kt_pool, axis=2),
                                            unpack_nibbles(v_pool, axis=-1), table)
        err_k8 = _check_close(
            f"{what} contiguous table vs K8",
            int4_paged_decode_attention(q, kt_c4, v_c4, ident, lengths, qs, ks4, vs4),
            int8_paged_decode_attention(q, kt_c, v_c, ident, lengths, qs, ks4, vs4,
                                        quant_pv=False), K11_TOL * top)
        # the valid positions' nibbles, half K8's bytes, plus the table
        b_ms, b_by = _decode_bound(SLOTS, h, hk, dh, sum(K8_LENGTHS), False,
                                   extra_bytes=4 * SLOTS * npg, kv_bytes=0.5)
        cases.append({"slots": SLOTS, "H": h, "Hkv": hk, "page": PS, "pool_pages": pages,
                      "table_width": npg, "lengths": list(K8_LENGTHS), "max_abs_err": err,
                      "largest_output": top, "max_abs_err_vs_k8_contiguous": err_k8,
                      "ms": timer.kernel(kern, K78_NAMES), "call_ms": timer(kern),
                      "plain_ms": timer(plain, iters=10), "bound_ms": b_ms, "bound_by": b_by,
                      **_sdpa_decode_ms(torch, timer, q, kt, v, (qs, ks4, vs4), lengths)})
        del kt_pool, v_pool, kt, v, kt_c, v_c, kt_c4, v_c4
    return cases


def phase_kernels(torch, state):
    timer = Timer(torch)
    gen = torch.Generator(device=DEV).manual_seed(0)
    state["k1"] = _k1_cases(torch, timer, gen)
    state["k2"] = _k2_cases(torch, timer, gen)
    k2_extra = _k2_extra_cases(torch, gen)
    state["k3"] = _k3_cases(torch, timer, gen)
    state.update(_fused_cases(torch, timer, gen))
    k45 = _rowpair_gemv_checks(torch, gen)
    sweep = _fused_sweep(torch, gen)
    state["k7"] = _k7_cases(torch, timer, gen)
    state["k8"] = _k8_cases(torch, timer, gen)
    state["k9"] = _k9_cases(torch, timer, gen)
    state["k10"] = _k10_cases(torch, timer, gen)
    state["k11"] = _k11_cases(torch, timer, gen)
    state["k12"] = _fused_cases(torch, timer, gen, span=True)
    sweep12 = _fused_sweep(torch, gen, span=True)
    del timer
    torch.cuda.empty_cache()
    hold = _plan_hold(torch)
    return {**{f"k{i}": state[f"k{i}"] for i in range(1, 13)}, "k2_checks": k2_extra,
            "k4_k5_checks": k45, "k6_sweep": sweep, "k12_sweep": sweep12, "plan_hold": hold}


# the plan hold: the rows at which a stage released before its loads returned once gave
# another result under some plans (K splits of more stages than the ring holds), rounds a plan
PLAN_HOLD, HOLD_ROUNDS = ("--rows", "9", "40", "64", "--groupsize", "128", "--no-time"), 100


def _plan_hold(torch):
    """K4, K5, K6's legs (and with ``--span`` K12's norm and requant
    entries and its MLP's legs) held under every plan HOLD_ROUNDS times
    against the chosen plan by ``fused_plan_sweep``, then K10's plans
    (``_k10_plan_hold``), the printout kept for chiprun_out/plan_hold.txt:
    the calls held per cell."""
    import contextlib
    import io

    from dgq_tpu_torch.scripts import fused_plan_sweep

    buf, rows = io.StringIO(), []
    try:
        for extra in ((), ("--span",)):
            with contextlib.redirect_stdout(buf):
                rows += fused_plan_sweep.main([*PLAN_HOLD, "--repeat", str(HOLD_ROUNDS), *extra])
        rows = [{k: r[k] for k in ("kernel", "leg", "M") if k in r}
                | {"calls": HOLD_ROUNDS * len(r["mismatches"]), "mismatches": 0} for r in rows]
        for r in _k10_plan_hold(torch, lambda r: buf.write(json.dumps(r) + "\n")):
            rows.append({"kernel": r["kernel"], "M": r["M"],
                         "calls": r["repeat"] * len(r["mismatches"]), "mismatches": 0})
    finally:
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "plan_hold.txt").write_text(buf.getvalue())
    return rows


# K10's plan hold: every plan fpscale_plan weighs at these rows, N = K = 4096, groupsize 128;
# its row-sum warps release a ring stage right after their shared loads and dp4a sums
K10_HOLD_ROWS, K10_HOLD_ROUNDS = (1, 4, 40, 1024), 300


def _k10_plan_hold(torch, log):
    """K10 under every plan of ``fpscale_candidates`` at K10_HOLD_ROWS,
    K10_HOLD_ROUNDS rounds, each in a new random order with an L2 flush
    before each call.  Every call must equal its own plan's first output
    bit for bit (a race shows so); that output must equal the chosen plan's
    where neither splits K, and lie within K10_TOL of the largest output
    where one does.  One record a row count (the calls a plan that
    differed), each handed to ``log`` first; an AssertionError after the
    record if any did."""
    import random

    from dgq_tpu_torch.ops import quant_matmul as qm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=DEV).manual_seed(10)
    rng = random.Random(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    n = k = 4096
    gs = 128
    out = []
    for m in K10_HOLD_ROWS:
        x = torch.randint(-128, 128, (m, k), generator=gen, device=DEV, dtype=torch.int8)
        qw, ws, wz = _q4_weights(torch, gen, k, n, gs, fp=True)
        ws8, wz8 = torch.repeat_interleave(ws, 8, dim=0), torch.repeat_interleave(wz, 8, dim=0)
        alpha = torch.rand((n,), generator=gen, device=DEV) * 1e-3 + 1e-5
        beta = torch.randn((n,), generator=gen, device=DEV)

        def call(plan):
            return qm._span_launch(qm.FPSCALE, x, qw, ws8, wz8, alpha, beta, gs, True,
                                   torch.float32, fp_plan=plan)

        chosen = qm.fpscale_plan(m, n, k, gs, sms)
        plans = qm.fpscale_candidates(m, n, k, gs, sms)
        want = call(chosen)
        top = want.abs().max().item()
        refs = {plan: call(plan) for plan in plans}
        errs = {}
        for plan, y in refs.items():
            errs[plan] = (y - want).abs().max().item()
            split = plan[1] < k // 2 or chosen[1] < k // 2
            if not (errs[plan] <= K10_TOL * top if split else torch.equal(y, want)):
                raise AssertionError(f"K10 M={m} plan {plan}: max abs err {errs[plan]} against "
                                     f"the chosen {chosen} (largest output {top})")
        bad = {plan: torch.zeros((), dtype=torch.int64, device=DEV) for plan in plans}
        for _ in range(K10_HOLD_ROUNDS):
            order = list(plans)
            rng.shuffle(order)
            for plan in order:
                flush.zero_()
                bad[plan] += (call(plan) != refs[plan]).any()
        rec = {"kernel": qm.FPSCALE, "M": m, "N": n, "K": k, "groupsize": gs,
               "chosen": list(chosen), "repeat": K10_HOLD_ROUNDS,
               "mismatches": {f"t{t}p{p}": int(v) for (t, p), v in bad.items()},
               "max_abs_err_vs_chosen": {f"t{t}p{p}": e for (t, p), e in errs.items()},
               "largest_output": top}
        out.append(rec)
        log(rec)
        if any(rec["mismatches"].values()):
            raise AssertionError(f"K10 M={m}: calls differ from their plan's first output: "
                                 f"{rec['mismatches']}")
        del x, qw, ws, wz, ws8, wz8
    return out


def _drive_main(torch, cfg, ecfg, want, smax=SMAX, new_tokens=NEW_TOKENS,
                attn=("K3", K3_NAMES), linear=("K1", K1_NAMES), span_only=False,
                extra=None):
    """build_llama_engine + generate with launch counts (must equal
    ``want``), then a timed step-by-step replay and a profiled breakdown in
    which ``attn`` and ``linear`` name the decode attention and the linears'
    kernel groups.  The engine has fp32 group scales under
    ``ecfg.fp_scales``; ``span_only``: span codes with plane rows and no
    rowpair copy (``keep_span``, then ``qw_rp`` and ``cs_fold`` dropped).
    ``extra(eng, prompts, toks)`` runs before the engine is freed and its
    dict is reported under "extra"."""
    import numpy as np

    from dgq_tpu_torch.models.engine import engine_forward, generate, init_kv_cache
    from dgq_tpu_torch.models.synthetic import build_llama_engine
    from dgq_tpu_torch.ops import _cuda

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_llama_engine(cfg, seed=0, device=DEV, fp_scales=ecfg.fp_scales,
                             keep_span=span_only)
    if span_only:
        eng = _drop_rowpair(eng)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)).to(DEV)

    _cuda.reset_launches()
    t0 = time.perf_counter()
    toks = generate(ecfg, eng, prompts, new_tokens, smax)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if toks.shape != (BATCH, new_tokens) or toks.dtype != torch.int32:
        raise AssertionError(f"tokens {tuple(toks.shape)} {toks.dtype}")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("token out of range")

    # timed replay of the same path, step by step
    steps = new_tokens - 1
    cache = init_kv_cache(cfg, BATCH, smax, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = engine_forward(ecfg, eng, prompts, cache)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(logits).all())
    replay = [tok]
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = engine_forward(ecfg, eng, tok[:, None], cache)
        finite &= bool(torch.isfinite(logits).all())
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        replay.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    if not finite:
        raise AssertionError("non-finite logits")
    breakdown = _profile_decode(torch, ecfg, eng, tok, cache, 4, attn, linear)
    if not torch.equal(torch.stack(replay, dim=1), toks):
        raise AssertionError("replay tokens differ from generate's")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del cache, logits
    extra_out = extra(eng, prompts, toks) if extra is not None else None
    del eng
    torch.cuda.empty_cache()
    return {"layers": cfg.num_hidden_layers, "fused_decode": ecfg.fused_decode,
            "fp_scales": ecfg.fp_scales, "batch": BATCH, "prompt": PROMPT, "new_tokens": new_tokens, "max_len": smax,
            "launches": launches, "engine_build_s": build_s, "generate_s": gen_s,
            "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "decode_tok_per_s": BATCH * 1e3 / decode_ms,
            "generate_tok_per_s": BATCH * new_tokens / gen_s,
            "peak_gib": peak_gb, "decode_step_breakdown": breakdown,
            "tokens_row0": toks[0].tolist(), **({"extra": extra_out} if extra else {})}


def _drop_rowpair(eng):
    """Span-only params: every linear's ``qw_rp`` and ``cs_fold`` set to None."""
    import dataclasses

    lins = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")
    return dataclasses.replace(eng, layers=eng.layers._replace(**{
        n: getattr(eng.layers, n)._replace(qw_rp=None, cs_fold=None) for n in lins}))


ROWPAIR_FUSED = ("fused_norm_gemv_rp", "fused_requant_gemv_rp", "fused_mlp_decode_rp")


def _want_launches(layers: int, fused: bool, new_tokens: int = NEW_TOKENS, chunked=False,
                   linear="w4a8_matmul_rp_pipe", fused_kernels=ROWPAIR_FUSED):
    """Launches of every kernel over ``generate`` on the LLaMA engine:
    ``linear`` runs the four linears of each layer at prefill, and at every
    decode step unless the fused kernels (``fused_kernels``: K4-K6, or K12
    on span-only storage) take them."""
    steps = new_tokens - 1
    decode_linears = 0 if fused else 4 * layers * steps
    fused_calls = layers * steps if fused else 0
    want = {name: 0 for name in SOURCES_OF}
    want.update({linear: 4 * layers + decode_linears,
                 "int8_prefill_attention": layers,
                 "int8_decode_attention": 0 if chunked else layers * steps,
                 **{name: fused_calls for name in fused_kernels},
                 "int8_decode_attention_chunked": layers * steps if chunked else 0})
    return want


def phase_main(torch, state):
    """The default EngineConfig (fused decode) at full 7B depth."""
    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig()
    ecfg = EngineConfig(cfg=cfg)
    if not ecfg.fused_decode:
        raise AssertionError("the default EngineConfig must run fused decode")
    out = _drive_main(torch, cfg, ecfg, _want_launches(cfg.num_hidden_layers, True))
    state["launches"] = out["launches"]
    return out


def phase_main_unfused(torch, state):
    """fused_decode=False (K1 at every decode step) at full 7B depth."""
    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig()
    return _drive_main(torch, cfg, EngineConfig(cfg=cfg, fused_decode=False),
                       _want_launches(cfg.num_hidden_layers, False))


def phase_main_long(torch, state):
    """The default EngineConfig at full 7B depth with a 16384-position cache:
    AUTO decode chunking takes K7 (chunks of 4096) at every decode step."""
    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.ops.attention import auto_decode_chunk

    cfg = LlamaConfig()
    if auto_decode_chunk(LONG_SMAX) != LONG_CHUNK:
        raise AssertionError(f"AUTO chunk of {LONG_SMAX} is not {LONG_CHUNK}")
    out = _drive_main(torch, cfg, EngineConfig(cfg=cfg),
                      _want_launches(cfg.num_hidden_layers, True, LONG_NEW, chunked=True),
                      smax=LONG_SMAX, new_tokens=LONG_NEW, attn=("K7", K78_NAMES))
    state["launches_long"] = out["launches"]
    return out


def phase_main_fpscale(torch, state):
    """The LLaMA engine with fp32 group scales (EngineConfig(fp_scales=True),
    the w4w8-fallback representation) at full 7B depth: K10 for every linear,
    fused decode off, K2 at prefill and K3 at every decode step."""
    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig()
    out = _drive_main(torch, cfg, EngineConfig(cfg=cfg, fp_scales=True),
                      _want_launches(cfg.num_hidden_layers, False,
                                     linear="w4a8_fpscale_matmul_packed"),
                      linear=("K10", K10_NAMES))
    state["launches_fpscale"] = out["launches"]
    return out


def phase_main_span(torch, state):
    """Span-only storage at full 7B depth (``build_llama_engine(keep_span=
    True)`` with every ``qw_rp`` and ``cs_fold`` dropped): main's generate
    with K9 at prefill and K12 at every decode step (K1 and K4-K6 never);
    then ``generate_speculative`` of one prompt, host loop and on device,
    with K12 on every verify window."""
    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig()
    ecfg = EngineConfig(cfg=cfg)
    layers = cfg.num_hidden_layers
    out = _drive_main(torch, cfg, ecfg,
                      _want_launches(layers, True, linear="w4a8_matmul_packed",
                                     fused_kernels=tuple(K12_NAMES)),
                      linear=("K9", K9_NAMES), span_only=True,
                      extra=lambda eng, prompts, toks: _span_speculative(torch, ecfg, eng,
                                                                         prompts[:1]))
    state["launches_span"] = out["launches"]
    return out


def _span_speculative(torch, ecfg, eng, prompt):
    """generate_speculative (spec_k SPEC_K, NEW_TOKENS tokens) on the
    span-only engine, host loop and on device, its forwards counted by
    kind: K12 must run once per layer on every verify window and every
    plain step, K3 on the plain steps only, K9 and K2 at the prefill only.
    Reported, not gated: its tokens against ``generate``'s of the same
    prompt (decode steps and verify windows round differently)."""
    from dgq_tpu_torch.models.engine import engine_forward, generate
    from dgq_tpu_torch.ops import _cuda
    from dgq_tpu_torch.serving.speculative import generate_speculative

    layers = ecfg.cfg.num_hidden_layers
    ref = generate(ecfg, eng, prompt, NEW_TOKENS, SMAX)[0].tolist()
    runs = {}
    for ondevice in (False, True):
        forwards = {"prefill": 0, "verify": 0, "plain": 0}

        def forward(ecfg_, params, ids, cache, window="auto"):
            kind = ("verify" if window == "decode" else
                    "plain" if ids.shape[1] == 1 else "prefill")
            forwards[kind] += 1
            return engine_forward(ecfg_, params, ids, cache, window=window)

        _cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, stats = generate_speculative(ecfg, eng, prompt, NEW_TOKENS, SMAX, spec_k=SPEC_K,
                                           ondevice=ondevice, forward_fn=forward)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        want = {name: 0 for name in SOURCES_OF}
        want.update({name: layers * (forwards["verify"] + forwards["plain"])
                     for name in K12_NAMES})
        want.update({"w4a8_matmul_packed": 4 * layers, "int8_prefill_attention": layers,
                     "int8_decode_attention": layers * forwards["plain"]})
        if launches != want or forwards["verify"] < 1 or forwards["prefill"] != 1:
            raise AssertionError(f"speculative (ondevice={ondevice}): launches {launches} != "
                                 f"{want}, forwards {forwards}")
        got = toks[0].tolist()
        if len(got) != NEW_TOKENS:
            raise AssertionError(f"{len(got)} speculative tokens")
        runs["ondevice" if ondevice else "host"] = {
            "seconds": secs, "tok_per_s": NEW_TOKENS / secs, "stats": stats,
            "forwards": forwards, "k12_launches_each": want["fused_norm_gemv"],
            "tokens_equal_generate": got == ref,
            "first_diff_vs_generate": next((i for i, (a, b) in enumerate(zip(got, ref))
                                            if a != b), None)}
    return {"spec_k": SPEC_K, "prompt": prompt.shape[1], "new_tokens": NEW_TOKENS, **runs}


def _opt_greedy(torch, ecfg, eng, prompts, new_tokens, smax):
    """Prefill then greedy decode through opt_engine_forward: (tokens (B,
    new_tokens), cache, finite logits, prefill ms, decode ms per step)."""
    from dgq_tpu_torch.models.opt_engine import init_opt_kv_cache, opt_engine_forward

    cache = init_opt_kv_cache(ecfg.cfg, prompts.shape[0], smax, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = opt_engine_forward(ecfg, eng, prompts, cache)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    finite = bool(torch.isfinite(logits).all())
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        logits, cache = opt_engine_forward(ecfg, eng, tok[:, None], cache)
        finite &= bool(torch.isfinite(logits).all())
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        toks.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(1, new_tokens - 1)
    return torch.stack(toks, dim=1), cache, finite, prefill_ms, decode_ms


def phase_opt(torch, state):
    """The OPT engine at OPT-6.7B width and depth (OPTConfig(): 32 layers, D
    4096, F 16384, MHA, vocab 50272), random weights from seed 0: prefill of
    4 x 256 tokens and 32 greedy tokens in a cache of 2048, with every
    kernel's launches counted (K9 for every linear, K3 at every decode step,
    nothing else); a profiled decode-step breakdown; then one perplexity
    window of 2048 tokens through ppl_eval_engine (K9 at M = 2048 only)."""
    import numpy as np

    from dgq_tpu_torch.models.opt import OPTConfig
    from dgq_tpu_torch.models.opt_engine import OPTEngineConfig, init_opt_kv_cache, \
        opt_engine_forward
    from dgq_tpu_torch.models.synthetic import build_opt_engine
    from dgq_tpu_torch.ops import _cuda
    from dgq_tpu_torch.utils.evalutils import ppl_eval_engine

    cfg = OPTConfig()
    ecfg = OPTEngineConfig(cfg=cfg)
    layers = cfg.num_hidden_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_opt_engine(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)).to(DEV)

    _cuda.reset_launches()
    t0 = time.perf_counter()
    toks, cache, finite, prefill_ms, decode_ms = _opt_greedy(torch, ecfg, eng, prompts,
                                                             NEW_TOKENS, SMAX)
    gen_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    want = {name: 0 for name in SOURCES_OF}
    want.update({"w4a8_matmul_packed": 4 * layers * NEW_TOKENS,
                 "int8_decode_attention": layers * (NEW_TOKENS - 1)})
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if toks.shape != (BATCH, NEW_TOKENS) or not finite:
        raise AssertionError(f"tokens {tuple(toks.shape)}, finite logits {finite}")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("token out of range")

    prof = {"tok": toks[:, -1], "cache": cache}

    def step():
        logits, prof["cache"] = opt_engine_forward(ecfg, eng, prof["tok"][:, None],
                                                   prof["cache"])
        prof["tok"] = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    breakdown = _profile_steps(torch, step, 4, ("K3", K3_NAMES),
                               ("K9", K9_NAMES))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del cache, prof

    # one perplexity window at the longest context OPT takes
    stream = np.random.default_rng(1).integers(0, cfg.vocab_size, PPL_LEN).astype(np.int32)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    ppl = ppl_eval_engine(ecfg, eng, stream, seqlen=PPL_LEN, forward_fn=opt_engine_forward,
                          init_cache_fn=init_opt_kv_cache)
    torch.cuda.synchronize()
    ppl_s = time.perf_counter() - t0
    ppl_launches = dict(_cuda.LAUNCHES)
    want_ppl = {name: 0 for name in SOURCES_OF}
    want_ppl["w4a8_matmul_packed"] = 4 * layers
    if ppl_launches != want_ppl:
        raise AssertionError(f"ppl window launches {ppl_launches} != {want_ppl}")
    if not (np.isfinite(ppl) and ppl > 1.0):
        raise AssertionError(f"perplexity {ppl}")
    del eng
    torch.cuda.empty_cache()
    state["launches_opt"] = launches
    return {"layers": layers, "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
            "max_len": SMAX, "launches": launches, "engine_build_s": build_s,
            "generate_s": gen_s, "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "decode_tok_per_s": BATCH * 1e3 / decode_ms,
            "generate_tok_per_s": BATCH * NEW_TOKENS / gen_s, "peak_gib": peak_gb,
            "decode_step_breakdown": breakdown, "tokens_row0": toks[0].tolist(),
            "ppl_window": {"seqlen": PPL_LEN, "ppl": ppl, "seconds": ppl_s,
                           "launches": ppl_launches}}


def _serve_requests(cfg):
    """The serve phase's requests, from seed 0: prompts of 100-1500 tokens,
    every third one (8 of 24) starting with the registered prefix; every
    second one streams."""
    import numpy as np

    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN).astype(np.int32)
    reqs = []
    for i in range(SERVE_REQUESTS):
        if i % 3 == 0:
            tail = rng.integers(0, cfg.vocab_size, int(rng.integers(1, 1501 - PREFIX_LEN)))
            prompt = np.concatenate([prefix, tail.astype(np.int32)])
        else:
            prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(100, 1501))).astype(np.int32)
        reqs.append({"prompt_ids": prompt, "stream": i % 2 == 1})
    return prefix, reqs


def _percentiles(ms):
    ms = sorted(ms)
    return {"p50": ms[len(ms) // 2], "p95": ms[min(len(ms) - 1, int(len(ms) * 0.95))]}


def _drive_socket(srv, reqs, cancel_uid, hold=False):
    """Send every request over one connection (pipelined), cancel
    ``cancel_uid`` (None: no cancel) at its first streamed tokens over a
    second connection (the first one's reader is still submitting the
    requests behind it), read every reply, then the metrics op.  Requests
    take uids 0.. in the order sent.  ``hold``: the scheduler loop waits,
    behind its lock, until every request is queued, so that the daemon steps
    through the schedule of a direct run.  Also returns the latencies the
    client sees: e2e from the send of all requests to each final reply, TTFT
    to each streaming request's first tokens."""
    import socket

    addr = (srv.host, srv.port)
    with socket.create_connection(addr, timeout=300) as sock, \
            socket.create_connection(addr, timeout=300) as ctl:
        f, cf = sock.makefile("r"), ctl.makefile("r")

        def send(s, obj):
            s.sendall((json.dumps(obj) + "\n").encode())

        t0 = time.perf_counter()
        if hold:
            srv._locks[0].acquire()
        try:
            for r in reqs:
                send(sock, {"prompt_ids": r["prompt_ids"].tolist(),
                            "max_new_tokens": SERVE_NEW, "stream": r["stream"]})
            while hold and srv._submit_qs[0].qsize() < len(reqs):
                time.sleep(0.001)
        finally:
            if hold:
                srv._locks[0].release()
        finals, streamed, acks, first_ms, e2e_ms = {}, {}, [], {}, {}
        while len(finals) < len(reqs):
            msg = json.loads(f.readline())
            if "error" in msg:
                raise AssertionError(f"server error: {msg}")
            uid, now_ms = msg["uid"], (time.perf_counter() - t0) * 1e3
            streamed.setdefault(uid, []).extend(msg.get("token_ids", []))
            first_ms.setdefault(uid, now_ms)
            if msg["done"]:
                finals[uid], e2e_ms[uid] = msg, now_ms
                wall = now_ms / 1e3
            elif uid == cancel_uid and not acks:
                send(ctl, {"op": "cancel", "uid": uid})
                acks.append(json.loads(cf.readline()))
        send(sock, {"op": "metrics"})
        metrics = json.loads(f.readline())
    client = {"e2e_ms": _percentiles([e2e_ms[u] for u in e2e_ms if u != cancel_uid]),
              "stream_ttft_ms": _percentiles([first_ms[u] for u, r in enumerate(reqs)
                                              if r["stream"]])}
    return finals, streamed, acks, metrics, wall, client


def _serve_daemon(torch, cfg, flags, reqs, prefix, cancel_uid, forward, verify=None,
                  hold=False, fp_scales=False):
    """save_engine of the full-width engine of seed 0 (with fp32 group scales
    under ``fp_scales``), then
    ``dgq_tpu_torch.serve.build_server`` with ``flags`` and the registered
    prefix, driven over a socket with ``reqs`` (``cancel_uid`` and ``hold``
    as ``_drive_socket``'s).  ``forward`` (module, name) is the decode
    forward whose calls are counted, and ``verify`` the speculative
    verification forward, if any.  Gates what every served run must show (no
    recovery, the cancel, SERVE_NEW tokens, streams equal to outputs, the
    prefix hits) and returns the parsed args, the server's batcher and the
    run's record."""
    import tempfile

    from dgq_tpu_torch import serve
    from dgq_tpu_torch.models.synthetic import build_llama_engine
    from dgq_tpu_torch.ops import _cuda
    from dgq_tpu_torch.utils import checkpoint

    build_dir = ROOT / "dgq_tpu_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build_dir))
    try:
        eng = build_llama_engine(cfg, seed=0, device=DEV, fp_scales=fp_scales)
        ckpt = str(tmp / "engine.safetensors")
        t0 = time.perf_counter()
        checkpoint.save_engine(ckpt, eng, cfg)
        save_s = time.perf_counter() - t0
        del eng
        torch.cuda.empty_cache()
        (tmp / "prefix.json").write_text(json.dumps(prefix.tolist()))
        args = serve.build_parser().parse_args(
            [ckpt, *flags, "--port", "0", "--prefix", str(tmp / "prefix.json"),
             "--metrics-interval", "0"])
        forwards, load_s = {"n": 0, "verify": 0}, []
        counted_fns = [(forward, "n")] + ([(verify, "verify")] if verify else [])
        saved = [(mod, name, getattr(mod, name)) for (mod, name), _ in counted_fns]
        real_load = checkpoint.load_engine

        def counter(fn, key):
            def counted(*a, **k):
                forwards[key] += 1
                return fn(*a, **k)
            return counted

        def timed_load(*a, **k):
            t = time.perf_counter()
            out = real_load(*a, **k)
            torch.cuda.synchronize()
            load_s.append(time.perf_counter() - t)
            return out

        for ((mod, name), key), (_, _, fn) in zip(counted_fns, saved):
            setattr(mod, name, counter(fn, key))
        checkpoint.load_engine = timed_load
        try:
            _cuda.reset_launches()
            t0 = time.perf_counter()
            srv = serve.build_server(args)
            start_s = time.perf_counter() - t0
            with srv:
                finals, streamed, acks, metrics, wall, client = _drive_socket(
                    srv, reqs, cancel_uid, hold=hold)
                torch.cuda.synchronize()
                launches = dict(_cuda.LAUNCHES)
                batcher = srv.batcher
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
            checkpoint.load_engine = real_load
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if batcher._recoveries:
        raise AssertionError(f"the served run recovered {batcher._recoveries} time(s)")
    cancelled = finals.get(cancel_uid, {"output_ids": None})
    if cancel_uid is not None and not (acks and acks[0]["cancelled_ok"]
                                       and cancelled.get("cancelled")):
        raise AssertionError(f"request {cancel_uid} was not cancelled mid-stream: {acks}")
    served = {uid: m["output_ids"] for uid, m in finals.items() if uid != cancel_uid}
    short = {uid: len(t) for uid, t in served.items() if len(t) != SERVE_NEW}
    if short:
        raise AssertionError(f"requests with other than {SERVE_NEW} tokens: {short}")
    for uid, r in enumerate(reqs):
        if r["stream"] and streamed[uid] != finals[uid]["output_ids"]:
            raise AssertionError(f"request {uid}: streamed tokens differ from its output")
    if metrics.get("prefix_hits") != sum(i % 3 == 0 for i in range(len(reqs))):
        raise AssertionError(f"prefix hits {metrics.get('prefix_hits')}")
    if not forwards["n"]:
        raise AssertionError("no decode forward ran")
    served_tokens = sum(len(m["output_ids"]) for m in finals.values())
    record = {"layers": cfg.num_hidden_layers, "slots": args.slots, "max_len": args.max_len,
              "prefill_chunk": args.prefill_chunk, "requests": len(reqs),
              "new_tokens": SERVE_NEW, "prompt_tokens": sum(len(r["prompt_ids"]) for r in reqs),
              "save_engine_s": save_s, "load_engine_s": load_s[0], "build_server_s": start_s,
              "served_wall_s": wall, "served_tokens": served_tokens,
              "client_tok_per_s": served_tokens / wall, "client_latency": client,
              "metrics": metrics, "decode_forwards": forwards["n"], "launches": launches,
              "cancelled": None if cancel_uid is None else {
                  "uid": cancel_uid, "tokens": len(cancelled["output_ids"])}}
    if verify:
        record["verify_forwards"] = forwards["verify"]
    return args, batcher, served, cancelled["output_ids"], record


def _check_attention_launches(launches, name, per_forward):
    """``name`` ran ``per_forward`` (layers x decode forwards) times and no
    other decode attention kernel ran."""
    if launches[name] != per_forward:
        raise AssertionError(f"{name} launches {launches[name]} != {per_forward}")
    for other in ("int8_decode_attention", "int8_decode_attention_chunked",
                  "int8_paged_decode_attention", "int4_paged_decode_attention"):
        if other != name and launches[other]:
            raise AssertionError(f"{other} launched {launches[other]} times beside {name}")


def _direct_run(torch, make, prefix, reqs, **kw):
    """A batcher made by ``make(**kw)`` with the prefix registered, running
    ``reqs`` to the end: (batcher, {uid: tokens}, seconds)."""
    from dgq_tpu_torch.serving.scheduler import Request

    b = make(**kw)
    b.register_prefix(prefix)
    for uid, r in enumerate(reqs):
        b.add_request(Request(uid=uid, prompt_ids=r["prompt_ids"], max_new_tokens=SERVE_NEW))
    t0 = time.perf_counter()
    out = {r.uid: r.output_ids for r in b.run()}
    torch.cuda.synchronize()
    return b, out, time.perf_counter() - t0


def _check_equal(what, served, want) -> None:
    diff = [uid for uid, t in served.items() if t != want[uid]]
    if diff:
        raise AssertionError(f"served tokens differ from {what} for {diff}")


def _paged_serve_tail(torch, cfg, args, params, prefix, reqs, served, kv_bits, tight_pages,
                      attn):
    """The paged phases' direct runs: the served tokens must equal a direct
    PagedBatcher.run(); a pool of ``tight_pages`` must preempt and finish
    every request; then a profiled decode step with all 8 slots decoding
    (``attn`` names the decode attention's kernel group)."""
    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.serving import paged
    from dgq_tpu_torch.serving.scheduler import Request

    ecfg = EngineConfig(cfg=cfg, kv_bits=kv_bits)

    def make(**kw):
        return paged.PagedBatcher(ecfg, params, num_slots=args.slots, max_len=args.max_len,
                                  page_size=args.page_size, prefill_chunk=args.prefill_chunk,
                                  **kw)

    b, want, direct_s = _direct_run(torch, make, prefix, reqs)
    _check_equal("a direct PagedBatcher.run()", served, want)
    del b
    tight, tight_out, tight_s = _direct_run(torch, make, prefix, reqs, num_pages=tight_pages)
    if tight.preemptions < 1:
        raise AssertionError(f"a pool of {tight_pages - 1} pages did not preempt")
    if sorted(tight_out) != list(range(len(reqs))) or any(
            len(t) != SERVE_NEW for t in tight_out.values()):
        raise AssertionError("the tight pool did not finish every request")
    tight_rec = {"num_pages": tight_pages, "preemptions": tight.preemptions, "run_s": tight_s,
                 "share_equal_direct": sum(tight_out[u] == want[u] for u in want) / len(want)}
    del tight
    torch.cuda.empty_cache()

    prof_b = make()
    for uid in range(SLOTS):
        prof_b.add_request(Request(uid=uid, prompt_ids=reqs[uid]["prompt_ids"],
                                   max_new_tokens=SERVE_NEW))
    while prof_b.queue or prof_b.pending:
        prof_b.step()
    if sum(r is not None for r in prof_b.slots) != SLOTS:
        raise AssertionError("not every slot is decoding before the profiled steps")
    lengths = [int(n) for n in prof_b.lengths_h]
    breakdown = _profile_steps(torch, prof_b.step, 4, attn)
    del prof_b
    return want, {"page_size": args.page_size, "direct_run_s": direct_s,
                  "served_equal_direct": True, "tight_pool": tight_rec,
                  "paged_decode_step": {"slots": SLOTS, "lengths": lengths, **breakdown}}


def phase_serve(torch, state):
    """The paged serving daemon at full 7B width and depth, over a socket."""
    from dgq_tpu_torch.models.engine import EngineConfig, generate
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.serving import paged

    cfg = LlamaConfig()
    prefix, reqs = _serve_requests(cfg)
    cancel_uid = 1  # a streaming request of the first wave
    args, batcher, served, cancelled, rec = _serve_daemon(
        torch, cfg, ["--paged"], reqs, prefix, cancel_uid, (paged, "paged_decode_batched"))
    params, layers = batcher.params, cfg.num_hidden_layers
    prefix_pages = -(-PREFIX_LEN // PS)
    if rec["metrics"]["pages_in_use"] != prefix_pages:
        raise AssertionError(f"{rec['metrics']['pages_in_use']} pages in use after the run, "
                             f"{prefix_pages} pinned by the prefix")
    _check_attention_launches(rec["launches"], "int8_paged_decode_attention",
                              layers * rec["decode_forwards"])
    del batcher
    want, tail = _paged_serve_tail(torch, cfg, args, params, prefix, reqs, served, 8,
                                   TIGHT_PAGES, ("K8", K78_NAMES))
    rec["cancelled"]["prefix_of_direct_run"] = (
        want[cancel_uid][:len(cancelled)] == cancelled)

    # not gated: the dense engine on each request alone, and the index of
    # the first token where it differs (0: the prefill's token)
    first_diff = []
    t0 = time.perf_counter()
    for uid, r in enumerate(reqs):
        prompt = torch.from_numpy(r["prompt_ids"][None]).to(DEV)
        alone = generate(EngineConfig(cfg=cfg), params, prompt, SERVE_NEW, args.max_len)[0]
        first_diff.append(next((i for i, (a, b) in enumerate(zip(alone.tolist(), want[uid]))
                                if a != b), None))
    alone_s = time.perf_counter() - t0
    state["launches_serve"] = rec["launches"]
    return {**rec, **tail,
            "alone_generate_share_equal": first_diff.count(None) / len(reqs),
            "alone_generate_first_diff": first_diff, "alone_generate_s": alone_s}


def phase_serve_kv4(torch, state):
    """The paged daemon on INT4 nibble pages (``--paged --kv-bits 4``) at
    full 7B width and depth, over a socket with the first SERVE_KV4 of phase
    serve's requests: K11 at every decode forward, no other decode attention
    and no K2 (INT4 KV prefills with the plain attention); half the INT8
    pool's bytes per token."""
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.serving import paged

    cfg = LlamaConfig()
    prefix, reqs = _serve_requests(cfg)
    reqs = reqs[:SERVE_KV4]
    args, batcher, served, _, rec = _serve_daemon(
        torch, cfg, ["--paged", "--kv-bits", "4"], reqs, prefix, 1,
        (paged, "paged_decode_batched"))
    params, layers = batcher.params, cfg.num_hidden_layers
    m = rec["metrics"]
    kv8 = 2 * layers * cfg.num_key_value_heads * cfg.head_dim  # INT8 bytes per token
    if (m["kv_bits"], m["kv_bytes_per_token"]) != (4, kv8 // 2) or batcher.kv_bytes_per_token != \
            kv8 // 2:
        raise AssertionError(f"kv_bits {m['kv_bits']}, {m['kv_bytes_per_token']} bytes per "
                             f"token: not half of INT8's {kv8}")
    if m["pages_in_use"] != -(-PREFIX_LEN // PS):
        raise AssertionError(f"{m['pages_in_use']} pages in use after the run")
    _check_attention_launches(rec["launches"], "int4_paged_decode_attention",
                              layers * rec["decode_forwards"])
    if rec["launches"]["int8_prefill_attention"]:
        raise AssertionError("K2 ran on the INT4 KV path")
    del batcher
    want, tail = _paged_serve_tail(torch, cfg, args, params, prefix, reqs, served, 4,
                                   TIGHT_PAGES_KV4, ("K11", K78_NAMES))
    state["launches_serve_kv4"] = rec["launches"]
    state["serve_kv4_tokens"] = want
    return {**rec, **tail, "kv_bytes_per_token_int8": kv8}


def phase_serve_dense(torch, state):
    """The dense daemon (``serve`` without ``--paged``: the ContinuousBatcher
    with the CLI's defaults, 8 slots, max-len 2048, admit-batch 4,
    prefill-chunk 512) at full 7B width and depth over a socket with the
    first SERVE_DENSE of phase serve's requests: K3 and K4-K6 once per layer
    at every decode forward.  The served tokens must equal a direct
    ContinuousBatcher.run() and one with decode_steps=4.  Then (not gated) a
    direct INT4 KV run, against phase serve_kv4's tokens."""
    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.serving import scheduler

    cfg = LlamaConfig()
    prefix, reqs = _serve_requests(cfg)
    reqs = reqs[:SERVE_DENSE]
    args, batcher, served, _, rec = _serve_daemon(
        torch, cfg, [], reqs, prefix, 1, (scheduler, "engine_decode_batched"))
    params, layers = batcher.params, cfg.num_hidden_layers
    if type(batcher).__name__ != "ContinuousBatcher" or batcher.admit_batch != 4:
        raise AssertionError(f"the daemon without --paged runs {type(batcher).__name__}")
    per_forward = layers * rec["decode_forwards"]
    _check_attention_launches(rec["launches"], "int8_decode_attention", per_forward)
    fused = {n: rec["launches"][n] for n in ("fused_norm_gemv_rp", "fused_requant_gemv_rp",
                                              "fused_mlp_decode_rp")}
    if any(n != per_forward for n in fused.values()):
        raise AssertionError(f"K4-K6 launches {fused} != {per_forward}")
    del batcher

    def make(kv_bits=8, **kw):
        return scheduler.ContinuousBatcher(
            EngineConfig(cfg=cfg, kv_bits=kv_bits), params, num_slots=args.slots,
            max_len=args.max_len, prefill_pad=args.prefill_pad,
            prefill_chunk=args.prefill_chunk, admit_batch=args.admit_batch, **kw)

    _, want, direct_s = _direct_run(torch, make, prefix, reqs)
    _check_equal("a direct ContinuousBatcher.run()", served, want)
    _, multi, multi_s = _direct_run(torch, make, prefix, reqs, decode_steps=4)
    _check_equal("a direct run with decode_steps=4", served, multi)
    _, kv4, kv4_s = _direct_run(torch, make, prefix, reqs, kv_bits=4)
    if sorted(kv4) != list(range(len(reqs))) or any(len(t) != SERVE_NEW for t in kv4.values()):
        raise AssertionError("the dense INT4 KV run did not finish every request")
    paged4 = state.get("serve_kv4_tokens")
    torch.cuda.empty_cache()

    # a profiled dense decode step with all 8 slots decoding
    prof_b = make()
    for uid in range(SLOTS):
        prof_b.add_request(scheduler.Request(uid=uid, prompt_ids=reqs[uid]["prompt_ids"],
                                             max_new_tokens=SERVE_NEW))
    while prof_b.queue or prof_b.pending:
        prof_b.step()
    if sum(r is not None for r in prof_b.slots) != SLOTS:
        raise AssertionError("not every slot is decoding before the profiled steps")
    lengths = [int(n) for n in prof_b.lengths_h]
    breakdown = _profile_steps(torch, prof_b.step, 4, ("K3", K3_NAMES))
    del prof_b
    state["launches_serve_dense"] = rec["launches"]
    state["serve_dense"] = {"tokens": want, "client_tok_per_s": rec["client_tok_per_s"],
                            "client_latency": rec["client_latency"]}
    return {**rec, "prefill_pad": args.prefill_pad, "admit_batch": args.admit_batch,
            "direct_run_s": direct_s, "served_equal_direct": True,
            "decode_steps_4_run_s": multi_s, "served_equal_decode_steps_4": True,
            "kv4_direct_run_s": kv4_s,
            # per request, the index of the first token where the dense INT4
            # run leaves serve_kv4's tokens (None: equal; 0: the prefill's)
            "kv4_first_diff_vs_paged_kv4": None if paged4 is None else [
                next((i for i, (a, b) in enumerate(zip(kv4[u], paged4[u])) if a != b), None)
                for u in sorted(kv4)],
            "dense_decode_step": {"slots": SLOTS, "lengths": lengths, **breakdown}}


SERVE_FPSCALE = 4  # serve_fpscale: the first 4 of serve_dense's requests


def phase_serve_fpscale(torch, state):
    """The dense daemon on an fp-scale checkpoint (fp32 group scales, the
    w4w8-fallback representation) at full 7B width and depth: ``serve``
    takes ``fp_scales`` from the stored scales, so every linear runs K10, K2
    at prefill and K3 at every decode forward, and no K1 or K4-K6.  The first
    SERVE_FPSCALE of serve_dense's requests, all queued before the daemon's
    first step; the served tokens must equal a direct ContinuousBatcher.run()
    with EngineConfig(fp_scales=True)."""
    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.serving import scheduler

    cfg = LlamaConfig()
    prefix, reqs = _serve_requests(cfg)
    reqs = reqs[:SERVE_FPSCALE]
    args, batcher, served, _, rec = _serve_daemon(
        torch, cfg, [], reqs, prefix, None, (scheduler, "engine_decode_batched"), hold=True,
        fp_scales=True)
    params, layers = batcher.params, cfg.num_hidden_layers
    if not batcher.ecfg.fp_scales:
        raise AssertionError("serve did not take fp_scales from the fp-scale checkpoint")
    launches = rec["launches"]
    _check_attention_launches(launches, "int8_decode_attention", layers * rec["decode_forwards"])
    others = {n: launches[n] for n in ("w4a8_matmul_rp_pipe", *ROWPAIR_FUSED) if launches[n]}
    if others or not launches["w4a8_fpscale_matmul_packed"] or not launches[
            "int8_prefill_attention"]:
        raise AssertionError(f"the fp-scale daemon's launches: {launches}")
    del batcher

    def make(**kw):
        return scheduler.ContinuousBatcher(
            EngineConfig(cfg=cfg, fp_scales=True), params, num_slots=args.slots,
            max_len=args.max_len, prefill_pad=args.prefill_pad,
            prefill_chunk=args.prefill_chunk, admit_batch=args.admit_batch, **kw)

    _, want, direct_s = _direct_run(torch, make, prefix, reqs)
    _check_equal("a direct ContinuousBatcher(fp_scales=True).run()", served, want)
    del params
    torch.cuda.empty_cache()
    state["launches_serve_fpscale"] = launches
    return {**rec, "direct_run_s": direct_s, "served_equal_direct": True}


def phase_serve_spec(torch, state):
    """The dense daemon with ``--spec-k SPEC_K`` (speculative decoding in the
    ContinuousBatcher, CLI defaults otherwise) at full 7B width and depth on
    serve_dense's checkpoint, requests and prefix, all queued before the
    daemon's first step: verify windows of 8 slots x 5 tokens through K4-K6
    with plain attention, K3 on plain steps.  The served tokens must equal a
    direct ``ContinuousBatcher(spec_k=SPEC_K).run()``.  Reported: the
    speculation metrics, client numbers and tokens against serve_dense's
    (verify windows and K3 round differently), direct runs with
    decode_steps=4 and with speculation never suspended, and a profiled
    8-slot verify step."""
    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.serving import scheduler

    cfg = LlamaConfig()
    prefix, reqs = _serve_requests(cfg)
    reqs = reqs[:SERVE_DENSE]
    args, batcher, served, _, rec = _serve_daemon(
        torch, cfg, ["--spec-k", str(SPEC_K)], reqs, prefix, None,
        (scheduler, "engine_decode_batched"), verify=(scheduler, "engine_verify_batched"),
        hold=True)
    params, layers = batcher.params, cfg.num_hidden_layers
    if type(batcher).__name__ != "ContinuousBatcher" or batcher.spec_k != SPEC_K:
        raise AssertionError(f"the daemon with --spec-k runs {type(batcher).__name__}")
    decode_calls = layers * rec["decode_forwards"]
    fused_calls = layers * (rec["decode_forwards"] + rec["verify_forwards"])
    _check_attention_launches(rec["launches"], "int8_decode_attention", decode_calls)
    fused = {n: rec["launches"][n] for n in ROWPAIR_FUSED}
    if rec["verify_forwards"] < 1 or any(n != fused_calls for n in fused.values()):
        raise AssertionError(f"K4-K6 launches {fused} != {fused_calls}, or no verify window")
    spec_stats = dict(batcher.spec_stats)
    del batcher

    def make(**kw):
        return scheduler.ContinuousBatcher(
            EngineConfig(cfg=cfg), params, num_slots=args.slots, max_len=args.max_len,
            prefill_pad=args.prefill_pad, prefill_chunk=args.prefill_chunk,
            admit_batch=args.admit_batch, spec_k=SPEC_K, **kw)

    direct_b, want, direct_s = _direct_run(torch, make, prefix, reqs)
    _check_equal(f"a direct ContinuousBatcher(spec_k={SPEC_K}).run()", served, want)
    if direct_b.spec_stats != spec_stats:
        raise AssertionError(f"spec stats {spec_stats} != the direct run's "
                             f"{direct_b.spec_stats}")
    del direct_b
    multi_b, multi, multi_s = _direct_run(torch, make, prefix, reqs, decode_steps=4)
    multi_rec = {"run_s": multi_s, "spec_stats": dict(multi_b.spec_stats),
                 "spec_multi_calls": multi_b.timings.get("dispatch:spec_multi", [0])[0],
                 "share_equal_served": sum(multi[u] == want[u] for u in want) / len(want)}
    del multi_b
    # speculation never suspended: the verify path's own cost and yield
    always_b, always, always_s = _direct_run(torch, make, prefix, reqs, spec_adaptive=False)
    always_rec = {"run_s": always_s, "spec_stats": dict(always_b.spec_stats),
                  "verify_calls": always_b.timings.get("dispatch:spec_verify", [0])[0],
                  "share_equal_served": sum(always[u] == want[u] for u in want) / len(want)}
    del always_b
    torch.cuda.empty_cache()

    # a profiled verify step: all 8 slots decoding, speculation always on
    prof_b = make(spec_adaptive=False)
    for uid in range(SLOTS):
        prof_b.add_request(scheduler.Request(uid=uid, prompt_ids=reqs[uid]["prompt_ids"],
                                             max_new_tokens=SERVE_NEW))
    while prof_b.queue or prof_b.pending:
        prof_b.step()
    if sum(r is not None for r in prof_b.slots) != SLOTS:
        raise AssertionError("not every slot is decoding before the profiled steps")
    lengths = [int(n) for n in prof_b.lengths_h]
    n0 = prof_b.timings.get("dispatch:spec_verify", [0])[0]
    breakdown = _profile_steps(torch, prof_b.step, 4, ("K3", K3_NAMES))
    if prof_b.timings["dispatch:spec_verify"][0] - n0 != 4:
        raise AssertionError("the profiled steps were not all verify steps")
    del prof_b
    attn_ms = _verify_attention_ms(torch, cfg, lengths)

    dense = state.get("serve_dense")
    m = rec["metrics"]
    out = {**rec, "spec_k": SPEC_K, "spec_stats": spec_stats,
           "spec_tokens_per_step": m.get("spec_tokens_per_step"),
           "spec_suspensions": m.get("spec_suspensions"), "direct_run_s": direct_s,
           "served_equal_direct": True, "decode_steps_4": multi_rec,
           "spec_always_on": always_rec,
           "verify_step": {"slots": SLOTS, "rows": SLOTS * (SPEC_K + 1), "lengths": lengths,
                           **breakdown,
                           # of "other": the plain attention, timed alone per layer
                           "verify_attention_ms_per_layer": attn_ms,
                           "verify_attention_ms_per_step": attn_ms * layers}}
    if dense is not None:
        out["vs_serve_dense"] = {
            "client_tok_per_s": dense["client_tok_per_s"],
            "client_latency": dense["client_latency"],
            "share_equal_tokens": sum(want[u] == dense["tokens"][u] for u in want) / len(want),
            # per request, the first token where speculation leaves the plain
            # batcher's tokens (None: equal)
            "first_diff": [next((i for i, (a, b) in enumerate(zip(want[u], dense["tokens"][u]))
                                 if a != b), None) for u in sorted(want)]}
    state["launches_serve_spec"] = rec["launches"]
    return out


def _profile_decode(torch, ecfg, eng, tok, cache, steps: int, attn, linear=("K1", K1_NAMES)):
    """Device time of ``steps`` engine decode steps by kernel group."""
    from dgq_tpu_torch.models.engine import engine_forward

    state = {"tok": tok, "cache": cache}

    def step():
        logits, state["cache"] = engine_forward(ecfg, eng, state["tok"][:, None], state["cache"])
        state["tok"] = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    return _profile_steps(torch, step, steps, attn, linear)


def _profile_steps(torch, step, steps: int, attn, linear=("K1", K1_NAMES)):
    """Device time of ``steps`` calls of ``step`` by kernel group (the
    linears' GEMM ``linear`` and the decode attention ``attn``, each (label,
    kernel names), K4-K6, K12, the rest), against the wall time of the same
    steps."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    names = {linear[0]: linear[1], attn[0]: attn[1], "K4": K4_NAMES, "K5": K5_NAMES,
             "K6": K6_NAMES, "K12": K12_ALL}
    groups = {g: 0.0 for g in [*names, "other"]}
    launches = {g: 0 for g in groups}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        if us <= 0:
            continue
        g = next((g for g, ns in names.items() if any(n in e.key for n in ns)), "other")
        groups[g] += us / steps / 1e3
        launches[g] += e.count // steps
    busy = sum(groups.values())
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": groups,
            "device_launches_per_step": launches,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms)}


def _verify_attention_ms(torch, cfg, lengths, iters: int = 10):
    """Device time of one layer's plain verify attention
    (``batch_engine.verify_attention`` with quant_pv) at a verify step's
    shapes: SLOTS slots at ``lengths``, SPEC_K + 1 queries each, a cache of
    SMAX, random int8 codes; every kernel of the call, from the profiler."""
    from dgq_tpu_torch.serving.batch_engine import verify_attention

    gen = torch.Generator(device=DEV).manual_seed(7)
    h, hk, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def ri(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8)

    q, kt, v = ri((SLOTS, h, SPEC_K + 1, dh)), ri((SLOTS, hk, dh, SMAX)), ri((SLOTS, hk, SMAX, dh))
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    scale = torch.full((), 0.05, device=DEV)

    def call():
        return verify_attention(q, kt, v, lens, scale, scale, scale, quant_pv=True)

    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
             for e in prof.key_averages())
    return us / iters / 1e3


class _CodeRecorder:
    """Record every int8 code tensor the engine makes: RMSNormQ and requant
    in the unfused glue, and the codes the fused kernels K4-K6 make inside
    (through their ``codes_out``).  With ``force`` (codes recorded by an
    earlier run) the plain run's code makers are wrapped instead: each new
    code tensor is compared with the recorded one, which is handed on, so
    that a code that flips at a rounding boundary does not cascade through
    the layers that follow."""

    # name -> code tensors it hands out; the MLPs' down weight (F/2 rows) is
    # argument DOWN_ARG[name] after x
    FUSED_CODES = {"fused_norm_gemv_rp": 1, "fused_requant_gemv_rp": 1,
                   "fused_mlp_decode_rp": 2, "fused_norm_gemv": 1, "fused_requant_gemv": 1,
                   "fused_mlp_decode": 2}
    DOWN_ARG = {"fused_mlp_decode_rp": 10, "fused_mlp_decode": 9}

    def __init__(self, force=None):
        self.force = force
        self.codes, self.stats = [], []

    def __enter__(self):
        import torch

        from dgq_tpu_torch.models import engine, opt_engine
        from dgq_tpu_torch.ops import fused_decode
        from dgq_tpu_torch.serving import paged

        # the paged decode block requantises q/k/v (or quantises k/v to int4)
        # through its own bindings; the OPT block makes codes in LayerNormQ,
        # in K9's int8 epilogue (q|k|v) and in its requants
        self.saved = [(engine, n, getattr(engine, n))
                      for n in ("_rms_norm_q", "_requant", "quantize_kv4")]
        self.saved += [(paged, n, getattr(paged, n)) for n in ("_requant", "quantize_kv4")]
        self.saved += [(opt_engine, n, getattr(opt_engine, n))
                       for n in ("_layer_norm_q", "_linear_s8_int8out", "_requant")]
        if self.force is None:
            self.saved += [(engine, n, getattr(engine, n)) for n in self.FUSED_CODES]
        else:  # the plain versions' code makers
            self.saved += [(fused_decode, n, getattr(fused_decode, n))
                           for n in ("_rmsnorm_q", "_requant_q", "_silu_mul_q")]

        def rec(fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                if self.force is None:
                    self.codes.append(out.clone())
                    return out
                ref = self.force.codes[len(self.stats)]
                self.stats.append(_code_stats(out, ref))
                return ref
            return wrapped

        def rec_fused(fn, n_codes, down_arg):
            def wrapped(x, *a, **k):
                # (M, K) codes of x; an MLP also the (M, F) down-proj input
                # codes, F = 2 * rows of its down weight
                shapes = [x.shape] + ([(x.shape[0], 2 * a[down_arg].shape[0])]
                                      if n_codes == 2 else [])
                codes = [x.new_empty(sh, dtype=torch.int8) for sh in shapes]
                out = fn(x, *a, codes_out=codes[0] if n_codes == 1 else tuple(codes), **k)
                self.codes.extend(codes)
                return out
            return wrapped

        for mod, name, fn in self.saved:
            if name in self.FUSED_CODES:
                setattr(mod, name, rec_fused(fn, self.FUSED_CODES[name],
                                             self.DOWN_ARG.get(name)))
            else:
                setattr(mod, name, rec(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class _PlainPath:
    """Swap the engine's and the paged decode block's kernel wrappers for
    their plain versions (the reference run on the card); restores them on
    exit."""

    def __enter__(self):
        from dgq_tpu_torch.models import engine, opt_engine
        from dgq_tpu_torch.ops import attention, fused_decode, quant_matmul
        from dgq_tpu_torch.serving import paged

        self.saved = [(engine, n, getattr(engine, n)) for n in
                      ("w4a8_matmul_rp_pipe", "int8_prefill_attention", "int8_decode_attention",
                       "int8_decode_attention_chunked", "fused_norm_gemv_rp",
                       "fused_requant_gemv_rp", "fused_mlp_decode_rp", "w4a8_matmul_packed",
                       "w4a8_fpscale_matmul_packed", "fused_norm_gemv", "fused_requant_gemv",
                       "fused_mlp_decode")]
        self.saved += [(paged, n, getattr(paged, n)) for n in
                       ("int8_paged_decode_attention", "int4_paged_decode_attention")]
        self.saved += [(opt_engine, n, getattr(opt_engine, n)) for n in
                       ("w4a8_matmul_packed", "int8_decode_attention",
                        "int8_decode_attention_chunked")]

        def k1(x, qw, ws, wz, alpha, beta=None, *, groupsize, scales_replicated):
            step = 8 if scales_replicated else 1
            return quant_matmul.w4a8_matmul_rp_xla(x, qw, ws[::step], wz[::step], alpha, beta,
                                                   groupsize=groupsize)

        def k9(x, qw, ws, wz, alpha, beta=None, *, scales_replicated, **k):
            step = 8 if scales_replicated else 1
            return quant_matmul.w4a8_matmul_packed_xla(x, qw, ws[::step], wz[::step], alpha,
                                                       beta, **k)

        def k10(x, qw, ws, wz, alpha, beta=None, *, scales_replicated, **k):
            step = 8 if scales_replicated else 1
            return quant_matmul.w4a8_fpscale_matmul_packed_xla(x, qw, ws[::step], wz[::step],
                                                               alpha, beta, **k)

        def k6(*a, bf, **k):  # the TPU's F block; the plain version has none
            return fused_decode.fused_mlp_decode_rp_xla(*a, **k)

        def k12_mlp(*a, bf, **k):
            return fused_decode.fused_mlp_decode_xla(*a, **k)

        engine.w4a8_matmul_packed = opt_engine.w4a8_matmul_packed = k9
        engine.w4a8_fpscale_matmul_packed = k10
        opt_engine.int8_decode_attention = attention.int8_decode_attention_xla
        engine.w4a8_matmul_rp_pipe = k1
        engine.int8_prefill_attention = attention.int8_prefill_attention_xla
        engine.int8_decode_attention = attention.int8_decode_attention_xla
        engine.fused_norm_gemv_rp = fused_decode.fused_norm_gemv_rp_xla
        engine.fused_requant_gemv_rp = fused_decode.fused_requant_gemv_rp_xla
        def k7(*a, chunk, **k):  # the plain version is the whole-cache one
            return attention.int8_decode_attention_xla(*a, **k)

        engine.fused_mlp_decode_rp = k6
        engine.fused_norm_gemv = fused_decode.fused_norm_gemv_xla
        engine.fused_requant_gemv = fused_decode.fused_requant_gemv_xla
        engine.fused_mlp_decode = k12_mlp
        engine.int8_decode_attention_chunked = opt_engine.int8_decode_attention_chunked = k7
        paged.int8_paged_decode_attention = attention.int8_paged_decode_attention_xla
        paged.int4_paged_decode_attention = attention.int4_paged_decode_attention_xla
        return self

    def __exit__(self, *exc):
        for mod, n, f in self.saved:
            setattr(mod, n, f)


def _teacher_forced(torch, ecfg, eng, prompts, steps, window):
    """Prefill, one forward per column of ``steps``, then ``window`` as one
    decode-side (verify) window; returns every forward's logits."""
    from dgq_tpu_torch.models.engine import engine_forward, init_kv_cache

    cache = init_kv_cache(ecfg.cfg, prompts.shape[0], SMAX, kv_bits=ecfg.kv_bits, device=DEV)
    logits, cache = engine_forward(ecfg, eng, prompts, cache)
    out = [logits]
    for i in range(steps.shape[1]):
        logits, cache = engine_forward(ecfg, eng, steps[:, i:i + 1], cache)
        out.append(logits)
    logits, cache = engine_forward(ecfg, eng, window, cache, window="decode")
    out.append(logits)
    return out, _codes(ecfg, cache.k, cache.v)


def _codes(ecfg, k, v):
    """The cache's codes by name; nibble caches unpacked, so that codes and
    not bytes are compared."""
    from dgq_tpu_torch.ops.kv4 import unpack_nibbles

    if ecfg.kv_bits == 4:
        k, v = unpack_nibbles(k, axis=-2), unpack_nibbles(v, axis=-1)
    return {"k": k, "v": v}


def _paged_teacher_forced(torch, ecfg, eng, prompts, steps):
    """paged_prefill of each prompt into shuffled pages of a pool, then one
    paged_decode_batched step per column of ``steps`` with every slot
    active; returns every call's logits and the pool."""
    from dgq_tpu_torch.serving.paged import init_paged_cache, paged_decode_batched, \
        paged_prefill

    b, npg = prompts.shape[0], SMAX // PS
    cache = init_paged_cache(ecfg.cfg, b, 1 + b * npg, PS, kv_bits=ecfg.kv_bits, device=DEV)
    table = _paged_table([SMAX] * b, npg, seed=5)
    out = []
    for i in range(b):
        logits, cache = paged_prefill(ecfg, eng, i, prompts[i], prompts.shape[1],
                                      table[i, :prompts.shape[1] // PS].tolist(), cache)
        out.append(logits)
    table_dev = torch.from_numpy(table).to(DEV)
    active = torch.ones((b,), dtype=torch.bool, device=DEV)
    for i in range(steps.shape[1]):
        logits, cache = paged_decode_batched(ecfg, eng, steps[:, i].contiguous(), cache,
                                             table_dev, active)
        out.append(logits)
    return out, _codes(ecfg, cache.kt, cache.v)


def _opt_teacher_forced(torch, ecfg, eng, prompts, steps):
    """OPT: prefill, then one forward per column of ``steps``."""
    from dgq_tpu_torch.models.opt_engine import init_opt_kv_cache, opt_engine_forward

    cache = init_opt_kv_cache(ecfg.cfg, prompts.shape[0], SMAX, device=DEV)
    logits, cache = opt_engine_forward(ecfg, eng, prompts, cache)
    out = [logits]
    for i in range(steps.shape[1]):
        logits, cache = opt_engine_forward(ecfg, eng, steps[:, i:i + 1], cache)
        out.append(logits)
    return out, {"k": cache.k, "v": cache.v}


def _parity(torch, run):
    """``run()`` -> (logits list, {name: int8 cache}) once on the kernel
    path recording its codes, once on the plain path forced onto them."""
    with _CodeRecorder() as rec_k:
        got, gc = run()
    with _PlainPath(), _CodeRecorder(force=rec_k) as rec_p:
        ref, rc = run()
    if len(rec_p.stats) != len(rec_k.codes):
        raise AssertionError(f"{len(rec_k.codes)} code tensors in the kernel run, "
                             f"{len(rec_p.stats)} in the plain run")
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    code_max = max(m for m, _ in rec_p.stats)
    code_equal = min(e for _, e in rec_p.stats)
    _check_codes("parity", (code_max, code_equal))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-3, atol=2e-3)
    kv = {}
    for name in gc:
        d_max, eq = _code_stats(gc[name], rc[name])
        kv[name] = {"max_diff": d_max, "equal_share": eq}
        _check_codes(f"{name} cache", (d_max, eq))
    return {"logits_max_abs_err": errs, "last_forward_max_abs_err": errs[-1],
            "code_tensors": len(rec_p.stats), "code_max_diff": code_max,
            "code_min_equal_share": code_equal,
            "code_tensors_with_flips": sum(e < 1.0 for _, e in rec_p.stats), "cache": kv}


def phase_parity(torch, state):
    import numpy as np

    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.models.opt import OPTConfig
    from dgq_tpu_torch.models.opt_engine import OPTEngineConfig
    from dgq_tpu_torch.models.synthetic import build_llama_engine, build_opt_engine

    cfg = LlamaConfig(num_hidden_layers=2)
    eng = build_llama_engine(cfg, seed=2, device=DEV)
    rng = np.random.default_rng(1)

    def ids(n, vocab=cfg.vocab_size):
        return torch.from_numpy(rng.integers(0, vocab, (BATCH, n)).astype(np.int32)).to(DEV)

    prompts, steps, window = ids(PROMPT), ids(8), ids(5)
    ecfg = EngineConfig(cfg=cfg)
    unfused = EngineConfig(cfg=cfg, fused_decode=False)
    out = {"layers": 2, "verify_window": 5,
           "fused": _parity(torch, lambda: _teacher_forced(torch, ecfg, eng, prompts, steps,
                                                           window)),
           "unfused": _parity(torch, lambda: _teacher_forced(torch, unfused, eng, prompts, steps,
                                                             window)),
           "paged": _parity(torch, lambda: _paged_teacher_forced(torch, ecfg, eng, prompts,
                                                                 steps))}
    # INT4 KV: the dense engine (plain attention, K1 and K4-K6 around it) and
    # the paged batcher's functions (K11)
    kv4 = EngineConfig(cfg=cfg, kv_bits=4)
    out["kv4"] = _parity(torch, lambda: _teacher_forced(torch, kv4, eng, prompts, steps, window))
    out["paged_kv4"] = _parity(torch, lambda: _paged_teacher_forced(torch, kv4, eng, prompts,
                                                                    steps))
    del eng
    # span-only storage: K9 at prefill, K12 at the decode steps and the window
    span_eng = _drop_rowpair(build_llama_engine(cfg, seed=2, device=DEV, keep_span=True))
    out["span_fused"] = _parity(torch, lambda: _teacher_forced(torch, ecfg, span_eng, prompts,
                                                               steps, window))
    del span_eng
    # the paths of phases main_fpscale (K10) and opt (K9), at full width
    fp_eng = build_llama_engine(cfg, seed=2, device=DEV, fp_scales=True)
    fp_cfg = EngineConfig(cfg=cfg, fp_scales=True)
    out["fpscale"] = _parity(torch, lambda: _teacher_forced(torch, fp_cfg, fp_eng, prompts,
                                                            steps, window))
    del fp_eng
    ocfg = OPTConfig(num_hidden_layers=2)
    opt_eng = build_opt_engine(ocfg, seed=2, device=DEV)
    oprompts, osteps = ids(PROMPT, ocfg.vocab_size), ids(8, ocfg.vocab_size)
    out["opt"] = _parity(torch, lambda: _opt_teacher_forced(
        torch, OPTEngineConfig(cfg=ocfg), opt_eng, oprompts, osteps))
    del opt_eng
    torch.cuda.empty_cache()
    return out


def phase_checkpoint(torch, state):
    import numpy as np

    from dgq_tpu_torch.models.engine import EngineConfig, generate
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.models.synthetic import build_llama_engine
    from dgq_tpu_torch.utils.checkpoint import engine_arrays, load_engine, save_engine

    cfg = LlamaConfig(num_hidden_layers=2)
    eng = build_llama_engine(cfg, seed=3, device=DEV)
    ckdir = ROOT / "dgq_tpu_torch" / "_build" / "smoke_ckpt"
    ckdir.mkdir(parents=True, exist_ok=True)
    path = str(ckdir / "engine.safetensors")
    try:
        t0 = time.perf_counter()
        save_engine(path, eng, cfg)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng2, cfg2 = load_engine(path, device=DEV)
        load_s = time.perf_counter() - t0
        size_mb = Path(path).stat().st_size / 2**20
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    if cfg2 != cfg:
        raise AssertionError(f"config {cfg2} != {cfg}")
    a, b = engine_arrays(eng), engine_arrays(eng2)
    if set(a) != set(b):
        raise AssertionError(f"keys differ: {set(a) ^ set(b)}")
    for key in a:
        if a[key].dtype != b[key].dtype or not torch.equal(a[key], b[key]):
            raise AssertionError(f"{key} differs after the round trip")
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 24)).astype(np.int32)).to(DEV)
    t1 = generate(EngineConfig(cfg=cfg), eng, prompt, 8, 256)
    t2 = generate(EngineConfig(cfg=cfg2), eng2, prompt, 8, 256)
    if not torch.equal(t1, t2):
        raise AssertionError("greedy tokens differ after the round trip")
    del eng, eng2
    return {"tensors": len(a), "file_mib": size_mb, "save_s": save_s, "load_s": load_s,
            "opt": _opt_round_trip(torch)}


def _opt_round_trip(torch):
    """save_engine(arch="opt") then load_engine of a 2-layer OPT-6.7B-wide
    engine: bit-equal span-only tensors and equal greedy tokens."""
    import numpy as np

    from dgq_tpu_torch.models.opt import OPTConfig
    from dgq_tpu_torch.models.opt_engine import OPTEngineConfig, OPTEngineParams
    from dgq_tpu_torch.models.synthetic import build_opt_engine
    from dgq_tpu_torch.utils.checkpoint import engine_arrays, load_engine, save_engine

    cfg = OPTConfig(num_hidden_layers=2)
    eng = build_opt_engine(cfg, seed=3, device=DEV)
    ckdir = ROOT / "dgq_tpu_torch" / "_build" / "smoke_ckpt_opt"
    ckdir.mkdir(parents=True, exist_ok=True)
    path = str(ckdir / "opt_engine.safetensors")
    try:
        t0 = time.perf_counter()
        save_engine(path, eng, cfg, arch="opt")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng2, cfg2 = load_engine(path, device=DEV)
        load_s = time.perf_counter() - t0
        size_mb = Path(path).stat().st_size / 2**20
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    if cfg2 != cfg or not isinstance(eng2, OPTEngineParams):
        raise AssertionError(f"config {cfg2} != {cfg}, or not an OPT engine")
    a, b = engine_arrays(eng), engine_arrays(eng2)
    if set(a) != set(b) or any(k.endswith(("/qw_rp", "/s_hi")) for k in b):
        raise AssertionError(f"keys differ: {set(a) ^ set(b)}")
    for key in a:
        if a[key].dtype != b[key].dtype or not torch.equal(a[key], b[key]):
            raise AssertionError(f"{key} differs after the round trip")
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 24)).astype(np.int32)).to(DEV)
    t1 = _opt_greedy(torch, OPTEngineConfig(cfg=cfg), eng, prompt, 8, 256)[0]
    t2 = _opt_greedy(torch, OPTEngineConfig(cfg=cfg2), eng2, prompt, 8, 256)[0]
    if not torch.equal(t1, t2):
        raise AssertionError("OPT greedy tokens differ after the round trip")
    return {"tensors": len(a), "file_mib": size_mb, "save_s": save_s, "load_s": load_s}


PROBE_MODULES = ("roofline_probe", "probe_gemv_engines", "probe_native_s4",
                 "probe_s4_bitcast_numerics", "probe_quant_pv_parts")
# each probe's main at a cut depth: one round of its candidates, short chains
PROBE_ARGS = {"roofline_probe": ["--pairs", "1", "--iters", "24"],
              "probe_gemv_engines": ["--reps", "1", "--iters", "24"],
              "probe_native_s4": ["--reps", "1", "--iters", "24"],
              "probe_s4_bitcast_numerics": ["--reps", "2", "--iters", "24"],
              "probe_quant_pv_parts": ["--cycles", "1", "--iters", "24"]}
PROBE_KERNELS = ("s8_matmul", "mxu_gemv", "vpu_gemv", "mix_gemv", "pallas_s4",
                 "pallas_s4_bitcast", "quant_pv_parts_attn")
PV_TOL = 1e-5  # of the largest |output|: P5's f32 sums (denom, p @ V) in another order


def _probe_gemm_cases(torch, timer, gen):
    """P1 at its shape and both tilings; P2's three engines and P3's two
    column maps at theirs (P4's numerics shape too): int32 results (P1's
    f32 of int32) equal to the plain versions'."""
    from dgq_tpu_torch.scripts import probe_gemv_engines as p2
    from dgq_tpu_torch.scripts import probe_native_s4 as p3
    from dgq_tpu_torch.scripts import probe_s4_bitcast_numerics as p4
    from dgq_tpu_torch.scripts import roofline_probe as p1

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=DEV, dtype=torch.int8)

    def check_equal(what, got, want):
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {(a != b).sum().item()} outputs differ")

    def case(name, names, kern, plain, nbytes, ops, library, **info):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check_equal(f"{name} {info}", got, want)
        b_ms, b_by = bound_ms(nbytes, ops / INT8_OPS_PER_S)
        return {**info, "max_abs_err": 0.0, "ms": timer.kernel(kern, names),
                "events_ms": timer.events(kern), "call_ms": timer(kern),
                "plain_ms": timer(plain, iters=5),
                **library(), "bound_ms": b_ms, "bound_by": b_by}

    cases = {}
    m, n, k = p1.M, p1.N, p1.K
    x, w = ri(-127, 128, (m, k)), ri(-127, 128, (k, n))
    lib = _int_mm_times(torch, timer, x, w)
    cases["s8_matmul"] = [
        case("P1", ["S8Loader"], lambda t=t: p1.s8_matmul(x, w, bm=t[0], bn=t[1]),
             lambda: p1.s8_matmul_plain(x, w), m * k + k * n + 4 * m * n, 2.0 * m * n * k,
             lambda: lib, M=m, N=n, K=k, tile=list(t), library_rows=m)
        for t in p1.TILINGS]
    del x, w
    k, n, b = p2.K, p2.N, p2.B
    x, w = ri(-127, 127, (b, k)), ri(-127, 127, (k, n))
    cases.update(_p2_cases(torch, timer, p2, x, w, case, check_equal))
    del x, w
    k, n, b = p3.K, p3.N, 2 * p3.B
    x, wb = ri(-8, 8, (b, k)), ri(-128, 128, (k, n // 2))
    lib = _int_mm_times(torch, timer, x, p3.unpack_s4_pairs(wb))
    common = dict(nbytes=b * k + k * n // 2 + 4 * b * n, ops=2.0 * b * n * k)
    cases["pallas_s4"] = [case("P3 pairs", ["s4_gemv_kernel"], lambda: p3.pallas_s4(x, wb),
                               lambda: p3.pallas_s4_plain(x, wb), library=lambda: lib,
                               M=b, N=n, K=k, library_rows=32, **common)]
    cases["pallas_s4_bitcast"] = [case(
        "P3 bitcast", ["s4_gemv_kernel"], lambda: p3.pallas_s4_bitcast(x, wb),
        lambda: p3.pallas_s4_bitcast_plain(x, wb), library=lambda: lib, M=b, N=n, K=k,
        bn=p3.BN, library_rows=32, **common)]
    del x, wb
    k, n2 = p4.NUM_K, p4.NUM_N2
    x, wb = ri(-8, 8, (8, k)), ri(-128, 128, (k, n2))
    cases["pallas_s4_bitcast"].append(case(
        "P4 kern", ["s4_gemv_kernel"], lambda: p4.kern(x, wb),
        lambda: p3.pallas_s4_bitcast_plain(x, wb, 2 * n2), 8 * k + k * n2 + 4 * 8 * 2 * n2,
        2.0 * 8 * 2 * n2 * k,
        lambda: _int_mm_times(torch, timer, x, p3.unpack_s4_halves(wb, 2 * n2)),
        M=8, N=2 * n2, K=k, bn=2 * n2, routed="kern", library_rows=32))
    return cases


# P2's engines (each kernel a call launches: the engine's and, when K is split, the sum of
# the splits), its cases (entry, the mix's tensor-core share) and its plan hold's rounds
P2_NAMES = {"mxu_gemv": ["mxu_gemv_sm90", "gemv_engines_combine"],
            "vpu_gemv": ["vpu_gemv_sm90", "gemv_engines_combine"],
            "mix_gemv": ["mix_gemv_sm90", "gemv_engines_combine"]}
P2_CASES = (("mxu_gemv", None), ("vpu_gemv", None), ("mix_gemv", 0.5), ("mix_gemv", 0.67))
P2_HOLD_ROUNDS = 100


def _p2_cases(torch, timer, p2, x, w, case, check_equal):
    """P2's engines at the probe's shape (P2_CASES): each under every plan
    of ``gemv_candidates`` bit-equal to its plain version and timed alone
    after an L2 flush (``flushed_seconds``: CUDA events around the call,
    its kernels and the gap between them); every plan then called
    P2_HOLD_ROUNDS times, each round in a new random order with an L2 flush
    before each call, every call equal to its plan's first output (a race
    shows so); the case at ``gemv_plan``'s plan timed as the other probes
    are, every kernel of the call counted, and by CUDA events again (with
    the library call and, for the card's streaming rate, ``torch.amax``
    over the same weight bytes) after a flush that leaves the L2 clean
    (``*_clean_l2``: no dirty lines to write back).  The tensor-core engine
    also at K4's bytes (``at_k4_bytes``: half the columns, 25.2 MB, about
    what K4 streams at M = 4), bit-equal and timed as the cases are, for
    the loop's rate at that size beside K4's."""
    import random

    from dgq_tpu_torch.utils.benchmarking import flushed_seconds

    b, k = x.shape
    n = w.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen, plans = p2.gemv_plan(n, k, sms), p2.gemv_candidates(n, k)
    rng = random.Random(0)
    wc = w.t().contiguous().t()
    # _int_mm_times' padding to 32 rows, made outside the timed call
    pads = {rows: torch.cat([x[:rows], x.new_zeros((32 - rows, k))]) for rows in (1, b)}
    libs = {rows: {**_int_mm_times(torch, timer, x[:rows], w), "library_events_ms_clean_l2":
                   timer.events(lambda xp=pads[rows]: torch._int_mm(xp, wc), clean=True)}
            for rows in (1, b)}
    # the same bytes read in order by one library reduction: the card's streaming rate
    wi = w.view(torch.int32)
    read = {"read_events_ms": timer.events(lambda: torch.amax(wi)),
            "read_events_ms_clean_l2": timer.events(lambda: torch.amax(wi), clean=True)}
    def outs(o):
        return o if isinstance(o, tuple) else (o,)

    out = {}
    for name, frac in P2_CASES:
        info = {}
        if name == "mxu_gemv":
            def call(plan):
                return p2.mxu_gemv(x, w, plan=plan)
            plain, rows, nbytes = (lambda: p2.mxu_gemv_plain(x, w)), b, b * k + k * n + 4 * b * n
            ops = 2.0 * b * n * k
        elif name == "vpu_gemv":
            def call(plan):
                return p2.vpu_gemv(x, w, plan=plan)
            plain, rows, nbytes = (lambda: p2.vpu_gemv_plain(x, w)), 1, k + k * n + 4 * n
            ops = 2.0 * n * k
        else:
            nm = p2.mix_split(n, frac)

            def call(plan, frac=frac):
                return p2.mix_gemv(x, w, frac, plan=plan)
            plain = functools.partial(p2.mix_gemv_plain, x, w, frac)
            rows, nbytes = b, b * k + k * n + 4 * b * nm + 4 * (n - nm)
            ops, info = 2.0 * k * (b * nm + n - nm), {"frac": frac, "nm": nm}
        library = libs[rows]
        want = plain()
        refs, sweep = {}, {}
        for plan in plans:
            tag = f"s{plan.splits}"
            refs[plan] = call(plan)
            torch.cuda.synchronize()
            check_equal(f"P2 {name} {info} plan {plan}", refs[plan], want)
            # CUDA events: each profiler trace costs the process (some tens lose records)
            sweep[tag] = 1e3 * flushed_seconds(lambda plan=plan: call(plan), timer.flush, 20)
        bad = {plan: torch.zeros((), dtype=torch.int64, device=DEV) for plan in plans}
        for _ in range(P2_HOLD_ROUNDS):
            order = list(plans)
            rng.shuffle(order)
            for plan in order:
                timer.flush.zero_()
                for got, ref in zip(outs(call(plan)), outs(refs[plan])):
                    bad[plan] += (got != ref).any()
        hold = {f"s{p.splits}": int(v) for p, v in bad.items()}
        if any(hold.values()):
            raise AssertionError(f"P2 {name} {info}: calls differ from their plan's first "
                                 f"output: {hold}")
        if name == "mxu_gemv":
            wh = w[:, :n // 2].contiguous()
            half = p2.gemv_plan(n // 2, k, sms)
            check_equal("P2 mxu_gemv at K4's bytes", p2.mxu_gemv(x, wh), p2.mxu_gemv_plain(x, wh))
            info["at_k4_bytes"] = {
                "N": n // 2, "bytes": b * k + k * n // 2 + 4 * b * n // 2,
                "plan": half._asdict(),
                "ms": timer.kernel(lambda: p2.mxu_gemv(x, wh), P2_NAMES[name])}
            del wh
        out.setdefault(name, []).append(case(
            f"P2 {name}", P2_NAMES[name], lambda: call(chosen), plain, nbytes, ops,
            lambda library=library: library, M=rows, N=n, K=k, **info, library_rows=32,
            events_ms_clean_l2=timer.events(lambda: call(chosen), clean=True), **read,
            plan=chosen._asdict(), plans=len(plans), plan_ms=sweep,
            hold={"rounds": P2_HOLD_ROUNDS, "calls": P2_HOLD_ROUNDS * len(plans),
                  "mismatches": 0}))
    return out


# P5's cases: (kv heads, the slots' lengths, timed); the hold-only slots take K3's edge cases
P5_CASES = ((32, (2048,), True), (8, (2048 - 2048 // 6,), True), (32, (0, 1, 2048), False),
            (8, (0, 1, 2048), False))


def _probe_pv_cases(torch, timer, gen):
    """P5's six modes at its shape (MHA, one slot, full cache) and at GQA
    4:1 with a shorter length, timed at ``decode_plan``'s cluster, and at
    three slots of lengths 0, 1 and Smax (MHA and GQA): each slot's output
    under every cluster of DECODE_CLUSTERS within PV_TOL of the largest
    output of the plain version's; s32dot's equality reported."""
    from dgq_tpu_torch.ops.attention import DECODE_CLUSTERS
    from dgq_tpu_torch.scripts import probe_quant_pv_parts as p5

    cases = []
    h, dh, smax = p5.H, p5.DH, p5.SMAX
    for hk, lens, timed in P5_CASES:
        b = len(lens)
        q, kt, v, _ = _attn_inputs(torch, gen, b, h, hk, 1, dh, smax)
        q = q[:, :, 0].contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device=DEV)
        lib = {}
        if timed:
            length = lens[0]
            qb = (q[:, :, None].float() * p5.QK_SCALE).to(torch.bfloat16)
            kb = kt[..., :length].transpose(2, 3).to(torch.bfloat16).contiguous()
            vb = (v[:, :, :length].float() * p5.V_SCALE).to(torch.bfloat16).contiguous()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = timer.library(lambda: sdpa(qb, kb, vb, scale=1.0, enable_gqa=hk != h))
        for mode in p5.MODES:
            def kern(mode=mode, cluster=None):
                return p5.attn(q, kt, v, lengths, mode, cluster=cluster)

            def plain(mode=mode):
                return p5.attn_plain(q, kt, v, lengths, mode)

            out_p = plain()
            top = out_p.abs().amax(dim=(1, 2))  # a slot's largest output
            errs, equal = {}, True
            for cluster in DECODE_CLUSTERS:
                out_k = kern(cluster=cluster)
                err = (out_k - out_p).abs().amax(dim=(1, 2))
                if not bool((err <= PV_TOL * top).all()):
                    raise AssertionError(f"P5 {mode} Hkv={hk} lengths {lens} cluster {cluster}: "
                                         f"max abs err {err.tolist()} > {PV_TOL} * "
                                         f"{top.tolist()}")
                errs[cluster] = err.max().item()
                equal &= bool(torch.equal(out_k, out_p))
            case = {"mode": mode, "B": b, "H": h, "Hkv": hk, "Smax": smax, "lengths": list(lens),
                    "clusters": list(DECODE_CLUSTERS), "max_abs_err": max(errs.values()),
                    "max_abs_err_by_cluster": errs, "largest_output": top.max().item(),
                    "equal": equal}
            if timed:
                b_ms, b_by = _decode_bound(b, h, hk, dh, b * lens[0],
                                           mode not in ("fp", "nodeq"))
                case.update({"ms": timer.kernel(kern, ["pv_parts_cluster"]),
                             "events_ms": timer.events(kern), "call_ms": timer(kern),
                             "plain_ms": timer(plain, iters=10), "bound_ms": b_ms,
                             "bound_by": b_by, **(lib if mode == "fp" else dict.fromkeys(lib))})
            cases.append(case)
        del q, kt, v
    return cases


def _drive_probes(torch):
    """The tools' main path: each probe's main, at PROBE_ARGS' depth, with
    its printout kept for chiprun_out/probes.txt."""
    import contextlib
    import importlib
    import io

    results, buf = {}, io.StringIO()
    for name in PROBE_MODULES:
        mod = importlib.import_module(f"dgq_tpu_torch.scripts.{name}")
        buf.write(f"== python -m dgq_tpu_torch.scripts.{name} {' '.join(PROBE_ARGS[name])}\n")
        with contextlib.redirect_stdout(buf):
            results[name] = mod.main(PROBE_ARGS[name])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "probes.txt").write_text(buf.getvalue())
    return results


def phase_probes(torch, state):
    from dgq_tpu_torch.ops import _cuda

    _cuda.reset_launches()
    results = _drive_probes(torch)
    torch.cuda.synchronize()
    state["launches_probes"] = dict(_cuda.LAUNCHES)
    missing = [n for n in PROBE_KERNELS if not state["launches_probes"][n]]
    if missing:
        raise AssertionError(f"the probes' mains launched no {missing}")
    num = results["probe_s4_bitcast_numerics"]
    if not (num["halves"] and not num["interleaved"]):
        raise AssertionError(f"P4 numerics: the bitcast map matched {num}, not the halves")
    if results["probe_native_s4"]["order"] != "elem0=LO nibble":
        raise AssertionError(f"P3 pairs: {results['probe_native_s4']['order']}")
    timer = Timer(torch)
    gen = torch.Generator(device=DEV).manual_seed(7)
    state["probes"] = _probe_gemm_cases(torch, timer, gen)
    state["probes"]["quant_pv_parts_attn"] = _probe_pv_cases(torch, timer, gen)
    del timer
    torch.cuda.empty_cache()
    return {"launches": {n: state["launches_probes"][n] for n in PROBE_KERNELS},
            "mains": results, "cases": state["probes"]}


BENCH_ARGS = ["--deadline", "480", "--rounds", "1"]


def phase_bench(torch, state):
    """``python -m dgq_tpu_torch.bench`` in a subprocess: exactly one line on
    stdout, parseable, with a numeric value, no ``degraded``, the card's name,
    and K9 and K1 launched by the GEMM round.  Its launches, summed over its
    stages, are the bench path's."""
    from dgq_tpu_torch.ops import _cuda

    torch.cuda.empty_cache()  # the bench's stages allocate in processes of their own
    cmd = [sys.executable, "-m", "dgq_tpu_torch.bench", *BENCH_ARGS]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=float(BENCH_ARGS[1]) + 120)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bench.txt").write_text(f"$ {' '.join(cmd[1:])}\n{proc.stdout}\n{proc.stderr}")
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench: rc {proc.returncode}, {len(lines)} stdout lines; stderr "
                             f"{proc.stderr[-1500:]}")
    res = json.loads(lines[0])
    extra = res.get("extra", {})
    if not isinstance(res.get("value"), (int, float)) or res.get("degraded"):
        raise AssertionError(f"bench: value {res.get('value')!r}, errors {extra.get('errors')}")
    if extra.get("device") != state["kind"]:
        raise AssertionError(f"bench: device {extra.get('device')!r}, the card is "
                             f"{state['kind']!r}")
    rnd = extra.get("launches", {}).get("round", {})
    if not (rnd.get("w4a8_matmul_packed") and rnd.get("w4a8_matmul_rp_pipe")):
        raise AssertionError(f"bench: the GEMM round launched {rnd}, not K9 and K1")
    state["launches_bench"] = {name: 0 for name in _cuda.SOURCES}
    for part in extra["launches"].values():
        for name, n in part.items():
            state["launches_bench"][name] += n
    return {"line": res}


SOURCES_OF = {
    "w4a8_matmul_rp_pipe": ("dgq_tpu_torch/csrc/w4a8_rp_gemm.cu",
                            "dgq_tpu/ops/quant_matmul.py:639"),
    "int8_prefill_attention": ("dgq_tpu_torch/csrc/int8_prefill_attention.cu",
                               "dgq_tpu/ops/attention.py:301"),
    "int8_decode_attention": ("dgq_tpu_torch/csrc/int8_decode_attention.cu",
                              "dgq_tpu/ops/attention.py:179"),
    "fused_norm_gemv_rp": ("dgq_tpu_torch/csrc/fused_norm_gemv_rp.cu",
                           "dgq_tpu/ops/fused_decode.py:605"),
    "fused_requant_gemv_rp": ("dgq_tpu_torch/csrc/fused_requant_gemv_rp.cu",
                              "dgq_tpu/ops/fused_decode.py:701"),
    "fused_mlp_decode_rp": ("dgq_tpu_torch/csrc/fused_mlp_decode_rp.cu",
                            "dgq_tpu/ops/fused_decode.py:1249"),
    "int8_decode_attention_chunked": ("dgq_tpu_torch/csrc/int8_chunked_decode_attention.cu",
                                      "dgq_tpu/ops/attention.py:542"),
    "int8_paged_decode_attention": ("dgq_tpu_torch/csrc/int8_chunked_decode_attention.cu",
                                    "dgq_tpu/ops/attention.py:679"),
    "int4_paged_decode_attention": ("dgq_tpu_torch/csrc/int8_chunked_decode_attention.cu",
                                    "dgq_tpu/ops/attention.py:887"),
    "w4a8_matmul_packed": ("dgq_tpu_torch/csrc/w4a8_span_gemm.cu",
                           "dgq_tpu/ops/quant_matmul.py:173"),
    "w4a8_fpscale_matmul_packed": ("dgq_tpu_torch/csrc/w4a8_span_gemm.cu",
                                   "dgq_tpu/ops/quant_matmul.py:941"),
    "fused_norm_gemv": ("dgq_tpu_torch/csrc/fused_gemv_span_sm90.cu",
                        "dgq_tpu/ops/fused_decode.py:423"),
    "fused_requant_gemv": ("dgq_tpu_torch/csrc/fused_gemv_span_sm90.cu",
                           "dgq_tpu/ops/fused_decode.py:916"),
    "fused_mlp_decode": ("dgq_tpu_torch/csrc/fused_gemv_span_sm90.cu",
                         "dgq_tpu/ops/fused_decode.py:1071"),
    "s8_matmul": ("dgq_tpu_torch/csrc/s8_gemm.cu", "scripts/roofline_probe.py:55"),
    "mxu_gemv": ("dgq_tpu_torch/csrc/int8_gemv_engines.cu", "scripts/probe_gemv_engines.py:51"),
    "vpu_gemv": ("dgq_tpu_torch/csrc/int8_gemv_engines.cu", "scripts/probe_gemv_engines.py:64"),
    "mix_gemv": ("dgq_tpu_torch/csrc/int8_gemv_engines.cu", "scripts/probe_gemv_engines.py:111"),
    "pallas_s4": ("dgq_tpu_torch/csrc/s4_gemv.cu", "scripts/probe_native_s4.py:111"),
    "pallas_s4_bitcast": ("dgq_tpu_torch/csrc/s4_gemv.cu", "scripts/probe_native_s4.py:147"),
    "quant_pv_parts_attn": ("dgq_tpu_torch/csrc/quant_pv_parts_attention.cu",
                            "scripts/probe_quant_pv_parts.py:91"),
}
# K14 (w4a8_matmul_wres, w4a8_matmul_pipe) computes K9's function and runs it.
# K13 (fused_norm_gemv_s4, fused_requant_gemv_s4) computes K12's first two
# functions bit for bit with both operands split to s4 for the TPU's int4
# MXU; Hopper's tensor cores take no int4 operand, so the names run K12.
ALSO_REPLACES = {"w4a8_matmul_packed": ["dgq_tpu/ops/quant_matmul.py:305",
                                        "dgq_tpu/ops/quant_matmul.py:463"],
                 "fused_norm_gemv": ["dgq_tpu/ops/fused_decode.py:513"],
                 "fused_requant_gemv": ["dgq_tpu/ops/fused_decode.py:841"],
                 # P4's kern (numerics, :37 and :66) and pl_bitcast (:104)
                 "pallas_s4_bitcast": ["scripts/probe_s4_bitcast_numerics.py:37",
                                       "scripts/probe_s4_bitcast_numerics.py:66",
                                       "scripts/probe_s4_bitcast_numerics.py:104"]}
# the path whose launches each kernel's entry reports: K7 runs on main_long
# only, K8 on the paged serving path only, K9 on the OPT engine, K10 on the
# fp-scale LLaMA engine, K11 on paged serving with INT4 KV, K12 on span-only
# storage, the probes' kernels on the probes' mains
PATH_OF = {"int8_decode_attention_chunked": "launches_long",
           "int8_paged_decode_attention": "launches_serve",
           "w4a8_matmul_packed": "launches_opt",
           "w4a8_fpscale_matmul_packed": "launches_fpscale",
           "int4_paged_decode_attention": "launches_serve_kv4",
           **{name: "launches_span" for name in K12_NAMES},
           **{name: "launches_probes" for name in PROBE_KERNELS}}
PATHS = {"main": "launches", "main_long": "launches_long", "serve": "launches_serve",
         "opt": "launches_opt", "main_fpscale": "launches_fpscale",
         "serve_kv4": "launches_serve_kv4", "serve_dense": "launches_serve_dense",
         "main_span": "launches_span", "serve_spec": "launches_serve_spec",
         "serve_fpscale": "launches_serve_fpscale", "probes": "launches_probes",
         "bench": "launches_bench"}
LINE_PHASES = {"kernels", *PATHS}


def kernels_line(state):
    """One entry per kernel.  K1, K9, K10: the four linears of one layer at
    prefill (M = 1024) summed (K1 LLaMA under fused decode, K9 OPT, K10
    LLaMA with fp32 scales); K2, K3: the main path's MHA case (K3 with
    quant_pv); K4-K6: the decode step (M = 4); K7, K8: the MHA case with
    quant_pv; K11: the MHA case; K12: the decode step (M = 4); the probes:
    their own shapes (P1 with 256 x 128 tiles, P5 in fp mode, MHA).
    ``launches`` counts the kernel over the path that runs it (main; K7
    main_long; K8 serve; K9 opt; K10 main_fpscale; K11 serve_kv4; K12
    main_span; the probes' kernels the probes' mains), and
    ``launches_by_path`` over each.  Every case is listed under ``cases``."""
    cases = {"w4a8_matmul_rp_pipe": state["k1"], "int8_prefill_attention": state["k2"],
             "int8_decode_attention": state["k3"], "fused_norm_gemv_rp": state["k4"],
             "fused_requant_gemv_rp": state["k5"], "fused_mlp_decode_rp": state["k6"],
             "int8_decode_attention_chunked": state["k7"],
             "int8_paged_decode_attention": state["k8"],
             "w4a8_matmul_packed": state["k9"], "w4a8_fpscale_matmul_packed": state["k10"],
             "int4_paged_decode_attention": state["k11"], **state["k12"], **state["probes"]}
    head = {
        "int8_prefill_attention": state["k2"][0],
        "int8_decode_attention": state["k3"][0],
        "int8_decode_attention_chunked": state["k7"][0],
        "int8_paged_decode_attention": state["k8"][0],
        "int4_paged_decode_attention": state["k11"][0],
    }
    for name in ("w4a8_matmul_rp_pipe", "w4a8_matmul_packed", "w4a8_fpscale_matmul_packed"):
        pre = [c for c in cases[name] if c["M"] == BATCH * PROMPT and not c.get("extra")]
        head[name] = {key: sum(c[key] for c in pre)
                      for key in ("ms", "plain_ms", "library_ms", "library_device_ms",
                                  "bound_ms")}
        head[name]["bound_by"] = "operations" if all(
            c["bound_by"] == "operations" for c in pre) else "bytes"
    for name in (*ROWPAIR_FUSED, *K12_NAMES):
        head[name] = next(c for c in cases[name] if c["M"] == BATCH)
    for name in PROBE_KERNELS:  # the probe's own shape (P1 256 x 128 tiles, P5 fp MHA)
        head[name] = cases[name][0]
    out = []
    for name, (source, replaces) in SOURCES_OF.items():
        h = head[name]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": state[PATH_OF.get(name, "launches")][name],
                 "launches_by_path": {p: state[k][name] for p, k in PATHS.items()},
                 "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
                 "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                 "bound_by": h["bound_by"], "library_ms": h["library_ms"],
                 "library_device_ms": h["library_device_ms"],
                 "cases": cases[name]}
        if "twin_ms" in h:  # K12: K4-K6 on the rowpair copy of the same bytes
            entry["twin_ms"] = h["twin_ms"]
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        out.append(entry)
    return {"kernels": out}


PHASES = {
    "device": phase_device,
    "build": phase_build,
    "kernels": phase_kernels,
    "probes": phase_probes,
    "main": phase_main,
    "main_unfused": phase_main_unfused,
    "main_long": phase_main_long,
    "serve": phase_serve,
    "serve_kv4": phase_serve_kv4,
    "serve_dense": phase_serve_dense,
    "opt": phase_opt,
    "main_fpscale": phase_main_fpscale,
    "main_span": phase_main_span,
    "serve_spec": phase_serve_spec,
    "serve_fpscale": phase_serve_fpscale,
    "parity": phase_parity,
    "checkpoint": phase_checkpoint,
    "bench": phase_bench,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        ap.error(f"unknown phases {unknown}")

    if not (ROOT / "dgq_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no dgq_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    state, failed, report = {}, [], {}
    for name in ["device"] + [p for p in phases if p != "device"]:
        t0 = time.perf_counter()
        try:
            result = PHASES[name](torch, state)
            torch.cuda.synchronize()
        except Exception as e:  # report every phase; the exit code says it failed
            import traceback

            traceback.print_exc()
            failed.append(name)
            result = {"error": f"{type(e).__name__}: {e}"}
        line = {"phase": name, "ok": name not in failed,
                "seconds": time.perf_counter() - t0, **result}
        report[name] = line
        emit(line)

    if LINE_PHASES <= set(phases) and not LINE_PHASES & set(failed):
        report["kernels_line"] = kernels_line(state)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    if "kernels_line" in report:
        emit(report["kernels_line"])
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": state["kind"],
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
