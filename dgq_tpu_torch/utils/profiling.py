"""Profiling and the analytic decode roofline.

Port of ``dgq_tpu/utils/profiling.py``:

  * ``trace``: a context around ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) that reports whether the profiler
    ran, the wall time, and the profile itself for ``key_averages()``;
  * ``EngineRoofline`` and ``engine_decode_roofline``: per-token operations
    and bytes of the W4A8 LLaMA engine's decode step from the model's
    dimensions, with the same arithmetic as JAX's, against the H100's peaks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Optional

import torch

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
H100_PEAK_INT8 = 1979e12  # int8 tensor-core operations per second
H100_PEAK_BF16 = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class TraceResult:
    profiler: bool  # whether torch.profiler ran
    wall_s: float = 0.0
    prof: Optional[object] = None  # the torch.profiler.profile, for key_averages()
    path: Optional[str] = None  # the chrome trace written, if a log_dir was given


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, enabled: bool = True):
    """``with trace() as t:`` profiles the block; ``t.profiler`` says
    whether the profiler ran (False when disabled or when it failed to
    start), ``t.wall_s`` is the block's wall time, and with ``log_dir`` the
    chrome trace is written to ``<log_dir>/trace.json``."""
    res = TraceResult(profiler=False)
    t0 = time.perf_counter()
    prof = None
    if enabled:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            res.profiler = True
        except RuntimeError as e:
            print(f"[trace] profiler did not start: {e}")
            prof = None
    try:
        yield res
    finally:
        if prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            res.prof = prof
            if log_dir is not None:
                Path(log_dir).mkdir(parents=True, exist_ok=True)
                res.path = str(Path(log_dir) / "trace.json")
                prof.export_chrome_trace(res.path)
        res.wall_s = time.perf_counter() - t0
        print(f"[trace] wall: {res.wall_s:.3f}s"
              + (f", profile in {res.path}" if res.path else
                 ", profiled" if res.profiler else " (profiler unavailable)"))


@dataclasses.dataclass
class EngineRoofline:
    flops_per_token: float
    weight_bytes: float
    kv_bytes_per_token: float  # at a given context length
    compute_bound_s: float
    bandwidth_bound_s: float

    @property
    def bound(self) -> str:
        return "compute" if self.compute_bound_s > self.bandwidth_bound_s else "bandwidth"

    def achieved(self, step_time_s: float) -> dict:
        floor = max(self.compute_bound_s, self.bandwidth_bound_s)
        return {
            "step_time_s": step_time_s,
            "floor_s": floor,
            "fraction_of_roofline": floor / step_time_s,
            "bound": self.bound,
        }


def engine_decode_roofline(
    cfg,
    batch: int = 1,
    context: int = 1024,
    *,
    peak_int8: float = H100_PEAK_INT8,
    hbm_gbps: float = H100_HBM_BYTES_PER_S,
) -> EngineRoofline:
    """Analytic decode-step roofline of the W4A8 LLaMA engine.

    Weights stream once per step (int4 packed + int8 group scales); the INT8
    KV cache reads ``context`` tokens per layer; the operations are the
    linears' GEMVs, the lm_head and attention (padded rows are overhead,
    not work).  ``hbm_gbps`` is in bytes per second (JAX's name)."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    nq = cfg.num_attention_heads * cfg.head_dim
    nkv = cfg.num_key_value_heads * cfg.head_dim
    L = cfg.num_hidden_layers
    v = cfg.vocab_size

    lin_params = L * (d * (nq + 2 * nkv) + nq * d + 2 * d * f + f * d)
    flops = 2 * batch * (lin_params + v * d)  # GEMVs + lm_head
    attn_flops = 2 * batch * L * 2 * nq * context  # qk + pv
    weight_bytes = lin_params / 2 + lin_params / 128  # int4 packed + int8 scales
    weight_bytes += 2 * v * d  # bf16 embed+head (tied storage read once)
    kv_bytes = batch * L * 2 * nkv * context  # int8 K and V

    total_flops = flops + attn_flops
    total_bytes = weight_bytes + kv_bytes
    return EngineRoofline(
        flops_per_token=total_flops,
        weight_bytes=weight_bytes,
        kv_bytes_per_token=kv_bytes,
        compute_bound_s=total_flops / peak_int8,
        bandwidth_bound_s=total_bytes / hbm_gbps,
    )
