"""Rules of the dgq_tpu_torch package that hold without a GPU.

It imports neither JAX nor dgq_tpu; its kernel wrappers take their plain
versions on CPU tensors without counting a launch; configurations that need
a kernel not yet ported raise NotImplementedError."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dgq_tpu_torch.models import engine as teng
from dgq_tpu_torch.models.llama import tiny_llama_config
from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops import attention as tat
from dgq_tpu_torch.ops import quant_matmul as tqm

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "dgq_tpu_torch"
SOURCES = [p for p in PKG.rglob("*.py") if "_build" not in p.parts]
MODULES = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                 for p in SOURCES if p.name != "__init__.py")


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'dgq_tpu' or k.startswith('dgq_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.]|import\s+dgq_tpu\b(?!_torch)"
                         r"|from\s+dgq_tpu[\s.])", re.M)
    for path in SOURCES:
        assert not pattern.search(path.read_text()), path
    assert len(MODULES) >= 10


def test_wrappers_take_plain_versions_on_cpu_without_launches():
    _cuda.reset_launches()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-128, 128, (4, 256)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-128, 128, (128, 64)).astype(np.int8))
    ws = torch.ones((2, 64), dtype=torch.int8)
    wz = torch.full((2, 64), 8, dtype=torch.int8)
    y = tqm.w4a8_matmul_rp_pipe(x, qw, ws, wz, torch.ones(64))
    torch.testing.assert_close(y, tqm.w4a8_matmul_rp_xla(x, qw, ws, wz, torch.ones(64)),
                               rtol=0, atol=0)

    q = torch.from_numpy(rng.integers(-127, 128, (1, 2, 64, 64)).astype(np.int8))
    kt = torch.from_numpy(rng.integers(-127, 128, (1, 2, 64, 128)).astype(np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (1, 2, 128, 64)).astype(np.int8))
    s = torch.tensor(0.02)
    out = tat.int8_prefill_attention(q, kt, v, 64, s, s, s, 0)
    torch.testing.assert_close(out, tat.int8_prefill_attention_xla(q, kt, v, 64, s, s, s, 0),
                               rtol=0, atol=0)
    out = tat.int8_decode_attention(q[:, :, 0], kt, v, 50, s, s, s, quant_pv=True)
    torch.testing.assert_close(
        out, tat.int8_decode_attention_xla(q[:, :, 0], kt, v, 50, s, s, s, quant_pv=True),
        rtol=0, atol=0)
    assert _cuda.LAUNCHES == {name: 0 for name in _cuda.SOURCES}


def test_unported_configurations_raise():
    cfg = tiny_llama_config()
    with pytest.raises(NotImplementedError, match="fused_norm_gemv_rp"):
        teng.EngineConfig(cfg=cfg, fused_decode=True)
    with pytest.raises(NotImplementedError, match="kv_bits=4"):
        teng.EngineConfig(cfg=cfg, kv_bits=4)
    with pytest.raises(NotImplementedError, match="kv_bits=4"):
        teng.init_kv_cache(cfg, 1, 64, kv_bits=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ALiBi"):
        s = torch.tensor(0.02)
        tat.int8_decode_attention(torch.zeros((1, 2, 64), dtype=torch.int8),
                                  torch.zeros((1, 2, 64, 8), dtype=torch.int8),
                                  torch.zeros((1, 2, 8, 64), dtype=torch.int8), 1, s, s, s,
                                  alibi_slopes=torch.ones(2))
