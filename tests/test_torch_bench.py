"""The port's timing tools and bench on the CPU.

``utils/profiling.engine_decode_roofline`` against JAX's, field by field;
``utils/benchmarking`` on CPU tensors (host clock, and the result says so);
``int8_gemm_feedback`` against JAX's; and ``python -m dgq_tpu_torch.bench``
with ``--cpu`` (one JSON line with bench.py's keys), a 1 s deadline (the
skipped stages recorded), SIGTERM (the best line so far) and, without
``--cpu`` on a machine with no CUDA device, one line naming it and a
non-zero exit."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dgq_tpu.utils import benchmarking as jbench
from dgq_tpu.utils import profiling as jprof
from dgq_tpu_torch import bench
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.utils import benchmarking as tbench
from dgq_tpu_torch.utils import profiling as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the test workers share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("batch,context", [(1, 1024), (4, 2048), (8, 16384)])
def test_engine_decode_roofline_matches_jax(batch, context):
    for kw in ({}, dict(peak_int8=tprof.H100_PEAK_INT8, hbm_gbps=tprof.H100_HBM_BYTES_PER_S)):
        want = jprof.engine_decode_roofline(JaxLlamaConfig(), batch, context,
                                            peak_int8=kw.get("peak_int8", 1979e12),
                                            hbm_gbps=kw.get("hbm_gbps", 3.35e12))
        got = tprof.engine_decode_roofline(LlamaConfig(), batch, context, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.bound == want.bound
        assert got.achieved(0.02) == want.achieved(0.02)
    assert tprof.H100_PEAK_INT8 == 1979e12 and tprof.H100_HBM_BYTES_PER_S == 3.35e12


def test_trace_reports_whether_the_profiler_ran(tmp_path):
    with tprof.trace(str(tmp_path)) as t:
        torch.ones(64).sum()
    assert t.profiler and t.wall_s > 0 and os.path.exists(t.path)
    assert any("sum" in e.key for e in t.prof.key_averages())
    with tprof.trace(enabled=False) as t:
        pass
    assert not t.profiler and t.prof is None


def test_device_time_and_gemm_tops_on_the_host():
    x = torch.randint(-127, 128, (32, 64), dtype=torch.int8)
    w = torch.randint(-127, 128, (64, 64), dtype=torch.int8)
    dt = tbench.device_time(lambda a: (torch._int_mm(a, w) & 0x7F).to(torch.int8), x,
                            iters=8, base_iters=2, repeats=2)
    assert dt > 0 and dt.clock == tbench.HOST
    dt, tops = tbench.gemm_tops(torch._int_mm, (x, w), 32, 64, 64, iters=8, base_iters=2,
                                repeats=1)
    assert dt > 0 and tops > 0 and dt.clock == tbench.HOST
    # a floor above what was measured is what is reported
    dt = tbench.device_time(lambda a: a, x, iters=4, base_iters=1, repeats=1, min_dt=1.0)
    assert dt == 1.0 and dt.clock == tbench.HOST
    with pytest.raises(ValueError, match="feedback"):
        tbench.device_time(lambda a: a.float(), x, iters=2, base_iters=1, repeats=1)


@pytest.mark.parametrize("n", [96, 48])
def test_int8_gemm_feedback_matches_jax(n):
    rng = np.random.default_rng(4)
    out = (rng.normal(size=(8, n)) * 3e4).astype(np.float32)
    want = np.asarray(jbench.int8_gemm_feedback(8, 64)(jnp.asarray(out), None))
    got = tbench.int8_gemm_feedback(8, 64)(torch.from_numpy(out), None).numpy()
    assert got.dtype == np.int8 and got.shape == (8, 64) and np.array_equal(got, want)
    iout = rng.integers(-2 ** 30, 2 ** 30, (8, n)).astype(np.int32)
    want = np.asarray(jbench.int8_gemm_feedback(8, 64)(jnp.asarray(iout), None))
    assert np.array_equal(tbench.int8_gemm_feedback(8, 64)(torch.from_numpy(iout), None).numpy(),
                          want)


def test_peak_is_looked_up_from_the_card_name():
    assert bench.peak_int8_ops("NVIDIA H100 80GB HBM3") == 1979e12
    with pytest.raises(ValueError, match="no int8 peak"):
        bench.peak_int8_ops("NVIDIA A100-SXM4-80GB")


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k not in ("DGQ_BENCH_FORCE_CPU",
                                                            "DGQ_BENCH_DEADLINE_S")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(kw)
    return env


def _one_line(stdout: str) -> dict:
    lines = stdout.strip().splitlines()
    assert len(lines) == 1, stdout
    return json.loads(lines[0])


def test_bench_cpu_prints_one_line_with_bench_keys():
    proc = subprocess.run([sys.executable, "-m", "dgq_tpu_torch.bench", "--cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    d = _one_line(proc.stdout)
    assert {"metric", "value", "unit", "vs_baseline", "extra"} <= set(d)
    assert d["unit"] == "fraction_of_roofline" and "degraded" not in d, d
    extra = d["extra"]
    assert extra["fused_us"] > 0 and extra["decode_ms_per_step_7b_b1"] > 0
    assert extra["device"] == "cpu" and extra["clock"] == "host"
    for key in ("xla_s8_us", "s8_matmul_us", "serving_tok_s_7b_8slots",
                "serving_spec_tok_s_7b_8slots", "longctx", "spec_tok_s_7b_b1",
                "decode_floor_witness_ms"):
        assert key in extra, key
    assert d["vs_baseline"] == pytest.approx(d["value"] / 0.90, abs=1e-4)


def test_bench_deadline_records_the_skipped_stages():
    proc = subprocess.run([sys.executable, "-m", "dgq_tpu_torch.bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=_env(DGQ_BENCH_FORCE_CPU="1", DGQ_BENCH_DEADLINE_S="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    d = _one_line(proc.stdout)
    assert d["extra"]["fused_us"] > 0
    skipped = d["extra"]["skipped"]
    assert [s.split(":")[0] for s in skipped] == list(bench.STAGES)
    assert all("skipped (deadline" in s for s in skipped), skipped


def test_bench_sigterm_prints_the_best_line_so_far():
    proc = subprocess.Popen([sys.executable, "-m", "dgq_tpu_torch.bench", "--cpu"], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=_env())
    time.sleep(6.0)  # past the handlers' registration, inside a stage
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    d = _one_line(out)
    assert d["unit"] == "fraction_of_roofline"
    assert d["extra"]["terminated_by_signal"] == signal.SIGTERM


def test_bench_without_a_card_exits_nonzero_naming_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run([sys.executable, "-m", "dgq_tpu_torch.bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=120, env=_env())
    assert proc.returncode != 0
    d = _one_line(proc.stdout)
    assert d["degraded"] and "no CUDA device" in d["extra"]["errors"][0]


SASS = """
\t\tFunction : _ZN50_GLOBAL__N__d6001200_17_w4a8_span_gemm_cu_3b27619f9gemm_sm90ILi16EEEvv
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                      /* 0x0000000000007919 */
\t\tFunction : _ZN50_GLOBAL__N__d6001200_17_w4a8_span_gemm_cu_3b27619f7combineEv
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
"""


def test_sass_diff_strips_the_namespace_hash_and_compares_by_function():
    """``scripts/sass_diff``: a kernel keeps its name when the source's path
    (which the anonymous namespace's mangled name holds) changes, and a
    changed instruction, a new and a removed function are each reported."""
    from dgq_tpu_torch.scripts import sass_diff

    mine = sass_diff.functions(SASS)
    assert mine == {"_ZN9gemm_sm90ILi16EEEvv": ["LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X"],
                    "_ZN7combineEv": ["EXIT"]}
    moved = SASS.replace("d6001200_17_w4a8_span_gemm_cu_3b27619f",
                         "0badf00d_19_decode_attention_cuh_cu_12345678")
    assert sass_diff.functions(moved) == mine
    row = sass_diff.compare("w4a8_span_gemm", mine, mine)
    assert row["same"] == 2 and not (row["differ"] or row["only_this"] or row["only_other"])
    theirs = {"_ZN9gemm_sm90ILi16EEEvv": ["LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.Y"],
              "_ZN3oldEv": ["EXIT"]}
    row = sass_diff.compare("w4a8_span_gemm", mine, theirs)
    assert row["same"] == 0 and row["only_this"] == ["_ZN7combineEv"]
    assert row["only_other"] == ["_ZN3oldEv"]
    assert row["differ"] == [{"function": "_ZN9gemm_sm90ILi16EEEvv", "instructions": [2, 2],
                              "first": 1, "this": "S2R R0, SR_TID.X",
                              "other": "S2R R0, SR_TID.Y"}]


def test_sass_diff_strips_a_namespace_that_ends_in_the_source_name():
    """The anonymous namespace of some sources (s8_gemm.cu, s4_gemv.cu, as
    cuobjdump printed them) ends in the source's name instead of a hex hash:
    their kernels keep their names across two trees too."""
    from dgq_tpu_torch.scripts import sass_diff

    names = ["_ZN42_GLOBAL__N__3f92f9f8_10_s8_gemm_cu_s8_gemm9gemm_sm90INS_8S8LoaderELi128ELi5E"
             "Li2EEEv14CUtensorMap_stS2_S2_S2_NS_8GemmArgsE",
             "_ZN42_GLOBAL__N__6274fef9_10_s8_gemm_cu_s8_gemm9gemm_sm90INS_8S8LoaderELi128ELi5E"
             "Li2EEEv14CUtensorMap_stS2_S2_S2_NS_8GemmArgsE"]
    listings = [f"\t\tFunction : {n}\n        /*0000*/                   EXIT ;\n" for n in names]
    mine, theirs = (sass_diff.functions(t) for t in listings)
    assert mine == theirs == {"_ZN9gemm_sm90INS_8S8LoaderELi128ELi5ELi2EEEv14CUtensorMap_stS2_"
                              "S2_S2_NS_8GemmArgsE": ["EXIT"]}
    assert sass_diff.compare("s8_gemm", mine, theirs)["same"] == 1
