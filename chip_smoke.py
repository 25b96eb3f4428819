#!/usr/bin/env python3
"""Smoke test of the dgq_tpu_torch port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports no JAX.  Phases, each printing one JSON line with its seconds:

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: the three CUDA kernels, one nvcc each, started together.
3. kernels: K1 ``w4a8_matmul_rp_pipe``, K2 ``int8_prefill_attention`` and K3
   ``int8_decode_attention`` held against their plain PyTorch versions at the
   main path's shapes (LLaMA-2-7B, batch 4, prompt 256, cache 2048) and timed
   with CUDA events (median of 20 calls after warm-up, L2 flushed before each
   call) beside the plain version, one PyTorch library call for the same
   function, and the bound; decode at Smax 16384 must raise for K7.
4. main: ``build_llama_engine(LlamaConfig())`` (32 layers, full width, random
   weights from seed 0) then ``generate`` of 32 greedy tokens for 4 prompts
   of 256 tokens, with every kernel's launches counted over that call.
5. parity: at full width and 2 layers, the kernel path against the plain
   path on the card (prefill logits and 8 teacher-forced decode steps).
   With random weights at full width one int8 code that flips at a rounding
   boundary (fp32 sums taken in another order) changes the rows after it by
   more than the tolerance, so the plain run checks each of its int8 code
   tensors against the kernel run's (at most 1 apart, >= 99.9% equal) and
   then continues from the kernel run's codes.
6. checkpoint: ``save_engine`` then ``load_engine`` at full width and 2
   layers: bit-equal tensors and equal greedy tokens.

Then the line ``{"kernels": [...]}``, the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without that
last line.  Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1979e12  # dense int8 tensor cores
FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores

BATCH, PROMPT, SMAX, NEW_TOKENS = 4, 256, 2048, 32
DECODE_LEN = PROMPT + NEW_TOKENS - 1  # valid cache length at the last decode step
K1_NAMES = ["rp_gemm_kernel", "splitk_epilogue"]  # K1 launches both when it splits K
# (N, K) of the four linears of a LLaMA-2-7B layer (F padded to 11264)
LINEARS = {"qkv_proj": (12288, 4096), "o_proj": (4096, 4096),
           "gate_up_proj": (22528, 4096), "down_proj": (4096, 11264)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Timer:
    """Timing on the card, with the L2 cache flushed before each call.

    ``timer(fn)``: CUDA events around one call (host launch gaps included),
    median over ``iters`` calls after warm-up.  ``timer.kernel(fn, names)``:
    the device time of the kernels whose names contain one of ``names``,
    from torch.profiler, averaged over ``iters`` calls."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

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

    def kernel(self, fn, names, iters: int = 20) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for e in prof.key_averages():
            if any(n in e.key for n in names):
                total_us += getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        if total_us <= 0:
            raise RuntimeError(f"profiler saw no device time for {names}")
        return total_us / iters / 1e3


def bound_ms(nbytes: float, op_seconds: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
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


def phase_build(torch, state):
    from dgq_tpu_torch.ops import _cuda

    return {"nvcc_seconds": _cuda.build()}


def _k1_cases(torch, timer, gen):
    from dgq_tpu_torch.ops.quant_matmul import dequantize_rowpair, w4a8_matmul_rp_pipe, \
        w4a8_matmul_rp_xla

    cases = []
    gs = 128
    for m in (BATCH * PROMPT, BATCH):
        for name, (n, k) in LINEARS.items():
            def ri(lo, hi, shape):
                return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int8)

            x = ri(-128, 128, (m, k))
            qw = ri(-128, 128, (k // 2, n))
            ws, wz = ri(1, 4, (k // gs, n)), ri(4, 12, (k // gs, n))
            ws8 = torch.repeat_interleave(ws, 8, dim=0)
            wz8 = torch.repeat_interleave(wz, 8, dim=0)
            alpha = torch.rand((n,), generator=gen, device="cuda") * 1e-3 + 1e-5
            one = torch.ones((n,), device="cuda")

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
            torch.testing.assert_close(y_k, y_p, rtol=1e-6, atol=0)
            err = (y_k - y_p).abs().max().item()
            lib_ms = None
            if m > 16:
                w8 = dequantize_rowpair(qw, ws, wz, gs)
                try:
                    torch._int_mm(x, w8)
                except RuntimeError:  # this build wants the second operand column-major
                    w8 = w8.t().contiguous().t()
                lib_ms = timer(lambda: torch._int_mm(x, w8))
                del w8
            nbytes = m * k + k * n // 2 + 2 * (k // gs) * n + 4 * n + 4 * m * n
            b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k / INT8_OPS_PER_S)
            cases.append({"linear": name, "M": m, "N": n, "K": k, "max_abs_err": err,
                          "ms": timer.kernel(kern, K1_NAMES), "call_ms": timer(kern),
                          "plain_ms": timer(plain, iters=10),
                          "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
            del x, qw, ws, wz, ws8, wz8, acc_k, acc_p, y_k, y_p
    return cases


def _attn_inputs(torch, gen, b, h, hk, s, dh, smax):
    def ri(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    scales = [torch.rand((), generator=gen, device="cuda") * 0.02 + 0.01 for _ in range(3)]
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
        lib_ms = timer(lambda: sdpa(qb, kb, vb, is_causal=True, enable_gqa=hk != h))
        pairs = sp * (sp + 1) // 2  # causal (query, key) pairs per head
        flops = 2.0 * dh * b * h * pairs
        nbytes = b * h * sp * dh + 2 * b * hk * plen * dh + 4 * b * h * sp * dh
        b_ms, b_by = bound_ms(nbytes, flops / INT8_OPS_PER_S + flops / FP32_OPS_PER_S)
        cases.append({"B": b, "H": h, "Hkv": hk, "Sp": sp, "Smax": SMAX, "plen": plen,
                      "max_abs_err": err, "ms": timer.kernel(kern, ["prefill_attn_kernel"]),
                      "call_ms": timer(kern), "plain_ms": timer(plain, iters=10),
                      "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
    return cases


def _k3_cases(torch, timer, gen):
    from dgq_tpu_torch.ops.attention import int8_decode_attention, int8_decode_attention_xla

    cases = []
    b, h, dh = BATCH, 32, 128
    for hk, quant_pv in ((32, True), (32, False), (8, True)):
        q, kt, v, (qs, ks, vs) = _attn_inputs(torch, gen, b, h, hk, 1, dh, SMAX)
        q = q[:, :, 0].contiguous()
        lengths = torch.tensor([DECODE_LEN - 3 * i for i in range(b)], dtype=torch.int32,
                               device="cuda")

        def kern():
            return int8_decode_attention(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv)

        def plain():
            return int8_decode_attention_xla(q, kt, v, lengths, qs, ks, vs, quant_pv=quant_pv)

        out_k, out_p = kern(), plain()
        err = (out_k - out_p).abs().max().item()
        if quant_pv:
            rel = ((out_k - out_p).norm() / out_p.norm()).item()
            if not rel < 1e-3:
                raise AssertionError(f"K3 Hkv={hk} quant_pv: relative L2 error {rel}")
        else:
            torch.testing.assert_close(out_k, out_p, rtol=2e-4, atol=2e-4)
        n = int(lengths.max().item())
        qb = (q[:, :, None].float() * qs).to(torch.bfloat16)
        kb = (kt[..., :n].transpose(2, 3).float() * ks).to(torch.bfloat16).contiguous()
        vb = (v[:, :, :n].float() * vs).to(torch.bfloat16)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = timer(lambda: sdpa(qb, kb, vb, enable_gqa=hk != h))
        keys = int(lengths.sum().item())
        flops = 2.0 * dh * h * keys
        pv_rate = INT8_OPS_PER_S if quant_pv else FP32_OPS_PER_S
        nbytes = b * h * dh + 2 * hk * keys * dh + 4 * b + 4 * b * h * dh
        b_ms, b_by = bound_ms(nbytes, flops / INT8_OPS_PER_S + flops / pv_rate)
        cases.append({"B": b, "H": h, "Hkv": hk, "Smax": SMAX, "lengths": lengths.tolist(),
                      "quant_pv": quant_pv, "max_abs_err": err,
                      "ms": timer.kernel(kern, ["decode_attn_kernel"]), "call_ms": timer(kern),
                      "plain_ms": timer(plain, iters=10), "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by})
    return cases


def _check_k7_raise(torch):
    from dgq_tpu_torch.models.engine import EngineConfig, engine_forward, init_kv_cache
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.models.synthetic import build_llama_engine

    cfg = LlamaConfig(num_hidden_layers=1)
    eng = build_llama_engine(cfg, seed=1, device="cuda")
    cache = init_kv_cache(cfg, 1, 16384, device="cuda")
    tok = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    try:
        engine_forward(EngineConfig(cfg=cfg), eng, tok, cache)
    except NotImplementedError as e:
        if "int8_decode_attention_chunked" not in str(e):
            raise AssertionError(f"K7 raise does not name the kernel: {e}") from e
        return str(e)
    raise AssertionError("decode at Smax 16384 did not raise NotImplementedError")


def phase_kernels(torch, state):
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state["k1"] = _k1_cases(torch, timer, gen)
    state["k2"] = _k2_cases(torch, timer, gen)
    state["k3"] = _k3_cases(torch, timer, gen)
    k7 = _check_k7_raise(torch)
    del timer
    torch.cuda.empty_cache()
    return {"k1": state["k1"], "k2": state["k2"], "k3": state["k3"], "k7_raise": k7}


def phase_main(torch, state):
    import numpy as np

    from dgq_tpu_torch.models.engine import EngineConfig, engine_forward, generate, \
        init_kv_cache
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.models.synthetic import build_llama_engine
    from dgq_tpu_torch.ops import _cuda

    cfg = LlamaConfig()
    t0 = time.perf_counter()
    eng = build_llama_engine(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ecfg = EngineConfig(cfg=cfg)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)).cuda()

    _cuda.reset_launches()
    t0 = time.perf_counter()
    toks = generate(ecfg, eng, prompts, NEW_TOKENS, SMAX)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    state["launches"] = launches
    layers, steps = cfg.num_hidden_layers, NEW_TOKENS - 1
    want = {"w4a8_matmul_rp_pipe": 4 * layers * NEW_TOKENS, "int8_prefill_attention": layers,
            "int8_decode_attention": layers * steps}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if toks.shape != (BATCH, NEW_TOKENS) or toks.dtype != torch.int32:
        raise AssertionError(f"tokens {tuple(toks.shape)} {toks.dtype}")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("token out of range")

    # timed replay of the same path, step by step
    cache = init_kv_cache(cfg, BATCH, SMAX, device="cuda")
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
    breakdown = _profile_decode(torch, ecfg, eng, tok, cache, steps=4)
    if not torch.equal(torch.stack(replay, dim=1), toks):
        raise AssertionError("replay tokens differ from generate's")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del eng, cache, logits
    torch.cuda.empty_cache()
    return {"layers": layers, "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
            "max_len": SMAX, "launches": launches, "engine_build_s": build_s,
            "generate_s": gen_s, "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "decode_tok_per_s": BATCH * 1e3 / decode_ms,
            "generate_tok_per_s": BATCH * NEW_TOKENS / gen_s,
            "peak_gib": peak_gb, "decode_step_breakdown": breakdown,
            "tokens_row0": toks[0].tolist()}


def _profile_decode(torch, ecfg, eng, tok, cache, steps: int):
    """Device time of ``steps`` decode steps by kernel group (K1, K3, the
    rest), against the wall time of the same steps."""
    from dgq_tpu_torch.models.engine import engine_forward

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = engine_forward(ecfg, eng, tok[:, None], cache)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    groups = {"K1": 0.0, "K3": 0.0, "other": 0.0}
    launches = {"K1": 0, "K3": 0, "other": 0}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        if us <= 0:
            continue
        g = ("K1" if any(n in e.key for n in K1_NAMES)
             else "K3" if "decode_attn_kernel" in e.key else "other")
        groups[g] += us / steps / 1e3
        launches[g] += e.count // steps
    busy = sum(groups.values())
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": groups,
            "device_launches_per_step": launches,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms)}


class _CodeRecorder:
    """Record every int8 code tensor the engine's RMSNormQ and requant make;
    with ``force`` (codes recorded by an earlier run), compare each new code
    tensor with the recorded one and hand on the recorded codes, so that a
    code that flips at a rounding boundary does not cascade through the
    layers that follow."""

    def __init__(self, force=None):
        self.force = force
        self.codes, self.stats = [], []

    def __enter__(self):
        from dgq_tpu_torch.models import engine

        self.engine = engine
        self.saved = (engine._rms_norm_q, engine._requant)

        def rec(fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                if self.force is None:
                    self.codes.append(out.clone())
                    return out
                ref = self.force.codes[len(self.stats)]
                d = (out.int() - ref.int()).abs()
                self.stats.append((int(d.max().item()), (d == 0).float().mean().item()))
                return ref
            return wrapped

        engine._rms_norm_q = rec(self.saved[0])
        engine._requant = rec(self.saved[1])
        return self

    def __exit__(self, *exc):
        self.engine._rms_norm_q, self.engine._requant = self.saved


class _PlainPath:
    """Swap the engine's kernel wrappers for their plain versions (the
    reference run on the card); restores them on exit."""

    def __enter__(self):
        from dgq_tpu_torch.models import engine
        from dgq_tpu_torch.ops import attention, quant_matmul

        self.engine = engine
        self.saved = {n: getattr(engine, n) for n in
                      ("w4a8_matmul_rp_pipe", "int8_prefill_attention", "int8_decode_attention")}

        def k1(x, qw, ws, wz, alpha, beta=None, *, groupsize, scales_replicated):
            step = 8 if scales_replicated else 1
            return quant_matmul.w4a8_matmul_rp_xla(x, qw, ws[::step], wz[::step], alpha, beta,
                                                   groupsize=groupsize)

        engine.w4a8_matmul_rp_pipe = k1
        engine.int8_prefill_attention = attention.int8_prefill_attention_xla
        engine.int8_decode_attention = attention.int8_decode_attention_xla
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.engine, n, f)


def _teacher_forced(torch, ecfg, eng, prompts, steps):
    from dgq_tpu_torch.models.engine import engine_forward, init_kv_cache

    cache = init_kv_cache(ecfg.cfg, prompts.shape[0], SMAX, device="cuda")
    logits, cache = engine_forward(ecfg, eng, prompts, cache)
    out = [logits]
    for i in range(steps.shape[1]):
        logits, cache = engine_forward(ecfg, eng, steps[:, i:i + 1], cache)
        out.append(logits)
    return out, cache


def phase_parity(torch, state):
    import numpy as np

    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.models.synthetic import build_llama_engine

    cfg = LlamaConfig(num_hidden_layers=2)
    eng = build_llama_engine(cfg, seed=2, device="cuda")
    ecfg = EngineConfig(cfg=cfg)
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)).cuda()
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, 8)).astype(np.int32)).cuda()
    with _CodeRecorder() as rec_k:
        got, gc = _teacher_forced(torch, ecfg, eng, prompts, steps)
    with _PlainPath(), _CodeRecorder(force=rec_k) as rec_p:
        ref, rc = _teacher_forced(torch, ecfg, eng, prompts, steps)
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    code_max = max(m for m, _ in rec_p.stats)
    code_equal = min(e for _, e in rec_p.stats)
    if code_max > 1 or code_equal < 0.999:
        raise AssertionError(f"int8 codes: max diff {code_max}, min equal share {code_equal}")
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-3, atol=2e-3)
    kv = {}
    for name, a, b in (("k", gc.k, rc.k), ("v", gc.v, rc.v)):
        d = (a.int() - b.int()).abs()
        kv[name] = {"max_diff": int(d.max().item()), "equal_share": (d == 0).float().mean().item()}
        if kv[name]["max_diff"] > 1 or kv[name]["equal_share"] < 0.999:
            raise AssertionError(f"{name} cache: {kv[name]}")
    return {"layers": 2, "logits_max_abs_err": errs, "code_tensors": len(rec_p.stats),
            "code_max_diff": code_max, "code_min_equal_share": code_equal,
            "code_tensors_with_flips": sum(e < 1.0 for _, e in rec_p.stats), "cache": kv}


def phase_checkpoint(torch, state):
    import numpy as np

    from dgq_tpu_torch.models.engine import EngineConfig, generate
    from dgq_tpu_torch.models.llama import LlamaConfig
    from dgq_tpu_torch.models.synthetic import build_llama_engine
    from dgq_tpu_torch.utils.checkpoint import engine_arrays, load_engine, save_engine

    cfg = LlamaConfig(num_hidden_layers=2)
    eng = build_llama_engine(cfg, seed=3, device="cuda")
    ckdir = ROOT / "dgq_tpu_torch" / "_build" / "smoke_ckpt"
    ckdir.mkdir(parents=True, exist_ok=True)
    path = str(ckdir / "engine.safetensors")
    try:
        t0 = time.perf_counter()
        save_engine(path, eng, cfg)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng2, cfg2 = load_engine(path, device="cuda")
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
        0, cfg.vocab_size, (1, 24)).astype(np.int32)).cuda()
    t1 = generate(EngineConfig(cfg=cfg), eng, prompt, 8, 256)
    t2 = generate(EngineConfig(cfg=cfg2), eng2, prompt, 8, 256)
    if not torch.equal(t1, t2):
        raise AssertionError("greedy tokens differ after the round trip")
    return {"tensors": len(a), "file_mib": size_mb, "save_s": save_s, "load_s": load_s}


SOURCES_OF = {
    "w4a8_matmul_rp_pipe": ("dgq_tpu_torch/csrc/w4a8_rp_gemm.cu",
                            "dgq_tpu/ops/quant_matmul.py:639"),
    "int8_prefill_attention": ("dgq_tpu_torch/csrc/int8_prefill_attention.cu",
                               "dgq_tpu/ops/attention.py:301"),
    "int8_decode_attention": ("dgq_tpu_torch/csrc/int8_decode_attention.cu",
                              "dgq_tpu/ops/attention.py:179"),
}


def kernels_line(state):
    """One entry per kernel.  K1: the four linears of one layer at prefill
    (M = 1024) summed; K2, K3: the main path's MHA case (K3 with quant_pv).
    Every case is listed under ``cases``."""
    k1 = state["k1"]
    pre = [c for c in k1 if c["M"] == BATCH * PROMPT]
    head = {
        "w4a8_matmul_rp_pipe": {key: sum(c[key] for c in pre)
                                for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "int8_prefill_attention": state["k2"][0],
        "int8_decode_attention": state["k3"][0],
    }
    head["w4a8_matmul_rp_pipe"]["bound_by"] = "operations" if all(
        c["bound_by"] == "operations" for c in pre) else "bytes"
    cases = {"w4a8_matmul_rp_pipe": k1, "int8_prefill_attention": state["k2"],
             "int8_decode_attention": state["k3"]}
    out = []
    for name, (source, replaces) in SOURCES_OF.items():
        h = head[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": state["launches"][name],
                    "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
                    "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                    "bound_by": h["bound_by"], "library_ms": h["library_ms"],
                    "cases": cases[name]})
    return {"kernels": out}


PHASES = {
    "device": phase_device,
    "build": phase_build,
    "kernels": phase_kernels,
    "main": phase_main,
    "parity": phase_parity,
    "checkpoint": phase_checkpoint,
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

    if {"kernels", "main"} <= set(phases) and not {"kernels", "main"} & set(failed):
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
