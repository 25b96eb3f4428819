"""Build, bind and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``_build/lib<name>.so`` at first use and loaded with ``ctypes``; the C entry
points take raw pointers and the stream as ``c_void_p`` and return
``cudaGetLastError()``.  Nothing here runs at import time, so the package
imports on machines without a GPU or a CUDA toolkit.

Launch counters: every kernel wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel and nowhere else, so a run can show that the main path
went through the kernels (``reset_launches`` before, read after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# kernel name -> csrc source stem
SOURCES = {
    "w4a8_matmul_rp_pipe": "w4a8_rp_gemm",
    "int8_prefill_attention": "int8_prefill_attention",
    "int8_decode_attention": "int8_decode_attention",
    # K2's, K3's and K7's ALiBi instantiations (BLOOM, MPT), counted apart; K7's
    # in a source of its own, built beside K7's
    "int8_prefill_attention_alibi": "int8_prefill_attention",
    "int8_decode_attention_alibi": "int8_decode_attention",
    "int8_decode_attention_chunked_alibi": "long_decode_attention_alibi",
    # K3's and K7's split kernels (any number of query heads a kv head: Falcon-7B's 71 on one),
    # one source, counted apart, with and without ALiBi
    "int8_decode_attention_split": "decode_attention_rows",
    "int8_decode_attention_split_alibi": "decode_attention_rows",
    "int8_decode_attention_chunked_split": "decode_attention_rows",
    "int8_decode_attention_chunked_split_alibi": "decode_attention_rows",
    "fused_norm_gemv_rp": "fused_norm_gemv_rp",
    "fused_requant_gemv_rp": "fused_requant_gemv_rp",
    "fused_mlp_decode_rp": "fused_mlp_decode_rp",
    # K12 (which also serves K13's names): the fused decode entry points on
    # span weights, K4's, K5's and K6's TMA + wgmma loop on span bytes (one
    # source)
    "fused_norm_gemv": "fused_gemv_span_sm90",
    "fused_requant_gemv": "fused_gemv_span_sm90",
    "fused_mlp_decode": "fused_gemv_span_sm90",
    # K7: K3's body on long caches, clusters up to 16 and scores in device memory
    "int8_decode_attention_chunked": "long_decode_attention",
    # K8 and K11: K3's body over the page pool (csrc/decode_attention.cuh), INT8 or nibble codes
    "int8_paged_decode_attention": "paged_decode_attention",
    "int4_paged_decode_attention": "paged_decode_attention",
    # K9 (which also serves K14's names) and K10: one source, three epilogues
    "w4a8_matmul_packed": "w4a8_span_gemm",
    "w4a8_fpscale_matmul_packed": "w4a8_span_gemm",
    # the probes of dgq_tpu_torch/scripts/: P1 the pure s8 GEMM; P2 the three
    # GEMV engines, one source; P3 the two s4 column maps, one source (P4's
    # names run the bitcast map); P5 decode attention in six p @ V modes, on
    # K3's body (csrc/decode_attention.cuh)
    "s8_matmul": "s8_gemm",
    "mxu_gemv": "int8_gemv_engines",
    "vpu_gemv": "int8_gemv_engines",
    "mix_gemv": "int8_gemv_engines",
    "pallas_s4": "s4_gemv",
    "pallas_s4_bitcast": "s4_gemv",
    "quant_pv_parts_attn": "quant_pv_parts_attention",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

VP, INT, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float  # argtypes of the C entry points

_libs: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(stem: str) -> Path:
    # the shared headers are hashed too: every source may include them
    text = (SRC_DIR / f"{stem}.cu").read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def build(stems: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the given sources (default: all) that are not built yet, one
    nvcc each, all started together; returns seconds per source built."""
    stems = list(stems) if stems is not None else sorted(set(SOURCES.values()))
    nvcc = None
    jobs = []
    for stem in stems:
        out = _lib_path(stem)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log_path = BUILD_DIR / f"{stem}.log"
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{stem}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((stem, proc, tmp, out, log_path, time.perf_counter()))
    failed = []
    for stem, proc, tmp, out, log_path, t0 in jobs:
        rc = proc.wait()
        BUILD_SECONDS[stem] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"csrc/{stem}.cu (rc {rc}):\n{log_path.read_text()[-4000:]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {s: BUILD_SECONDS[s] for s, *_ in jobs}


def library(stem: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built if needed; each C
    function named in ``signatures`` gets those argtypes and an int result."""
    lib = _libs.get(stem)
    if lib is None:
        build([stem])
        lib = ctypes.CDLL(str(_lib_path(stem)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[stem] = lib
    return lib


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc == -1:  # the entry point's own argument checks (K4-K6, K12)
        raise ValueError(f"{what}: the kernel's entry point rejected its arguments")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
            device: Optional[torch.device] = None, align: int = 16) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape,
    contiguity and base-pointer alignment for vector loads."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer must be {align}-byte aligned")
