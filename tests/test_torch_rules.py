"""Rules of the dgq_tpu_torch package that hold without a GPU.

It imports neither JAX nor dgq_tpu; its kernel wrappers take their plain
versions on CPU tensors without counting a launch (K1-K12, and K13's and
K14's names; the probes P1-P5, and P4's names); fused decode on span-only
storage takes K12; configurations that need a module not yet ported raise
NotImplementedError, and a KV precision other than 8 or 4 bits raises
ValueError."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dgq_tpu_torch.models import engine as teng
from dgq_tpu_torch.models.llama import tiny_llama_config
from dgq_tpu_torch.models.synthetic import build_llama_engine
from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops import attention as tat
from dgq_tpu_torch.ops import fused_decode as tfd
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

    # K4-K6 on one layer of a tiny random engine
    layer = build_llama_engine(tiny_llama_config(hidden_size=256, intermediate_size=512),
                               seed=0, device="cpu").layer_list[0]
    xf = torch.from_numpy(rng.normal(size=(3, 256)).astype(np.float32))
    qp, op, gu, dn = layer.qkv_proj, layer.o_proj, layer.gate_up_proj, layer.down_proj

    def planes(lin):
        return lin.qw_rp, lin.s_hi, lin.s_lo, lin.z_hi, lin.z_lo, lin.cs_fold

    codes = torch.empty((3, 256), dtype=torch.int8)
    y = tfd.fused_norm_gemv_rp(xf, layer.ln1_weight, None, *planes(qp), qp.alpha,
                               codes_out=codes)
    torch.testing.assert_close(y, tfd.fused_norm_gemv_rp_xla(xf, layer.ln1_weight, None,
                                                             *planes(qp), qp.alpha),
                               rtol=0, atol=0)
    assert torch.equal(codes, tfd._rmsnorm_q(xf, layer.ln1_weight, None, 1e-6))
    y = tfd.fused_requant_gemv_rp(xf, layer.out_input_scale, *planes(op), op.alpha,
                                  residual=xf)
    torch.testing.assert_close(y, tfd.fused_requant_gemv_rp_xla(
        xf, layer.out_input_scale, *planes(op), op.alpha, residual=xf), rtol=0, atol=0)
    args = (xf, layer.ln2_weight, None, *planes(gu), gu.alpha, layer.down_input_scale,
            dn.qw_rp, dn.wscales, dn.wzeros, dn.cs_fold, dn.alpha)
    torch.testing.assert_close(tfd.fused_mlp_decode_rp(*args),
                               tfd.fused_mlp_decode_rp_xla(*args), rtol=0, atol=0)

    # K7 (chunked decode) and K8 (paged decode)
    lengths = torch.tensor([50], dtype=torch.int32)
    for quant_pv in (True, False):
        out = tat.int8_decode_attention_chunked(q[:, :, 0], kt, v, lengths, s, s, s, chunk=32,
                                                quant_pv=quant_pv)
        torch.testing.assert_close(out, tat.int8_decode_attention_xla(
            q[:, :, 0], kt, v, lengths, s, s, s, quant_pv=quant_pv), rtol=0, atol=0)
        pool_k = kt.reshape(2, 64, 4, 32).permute(2, 0, 1, 3).contiguous()
        pool_v = v.reshape(2, 4, 32, 64).permute(1, 0, 2, 3).contiguous()
        table = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32)
        out = tat.int8_paged_decode_attention(q[:, :, 0], pool_k, pool_v, table, lengths, s, s,
                                              s, quant_pv=quant_pv)
        torch.testing.assert_close(out, tat.int8_paged_decode_attention_xla(
            q[:, :, 0], pool_k, pool_v, table, lengths, s, s, s, quant_pv=quant_pv),
            rtol=0, atol=0)
    # K11 (paged decode over INT4 nibble pages)
    pool_k4 = torch.from_numpy(rng.integers(-128, 128, (4, 2, 32, 32)).astype(np.int8))
    pool_v4 = torch.from_numpy(rng.integers(-128, 128, (4, 2, 32, 32)).astype(np.int8))
    out = tat.int4_paged_decode_attention(q[:, :, 0], pool_k4, pool_v4, table, lengths, s, s, s)
    torch.testing.assert_close(out, tat.int4_paged_decode_attention_xla(
        q[:, :, 0], pool_k4, pool_v4, table, lengths, s, s, s), rtol=0, atol=0)
    assert _cuda.LAUNCHES == {name: 0 for name in _cuda.SOURCES}
    assert {"fused_norm_gemv_rp", "fused_requant_gemv_rp", "fused_mlp_decode_rp",
            "int8_decode_attention_chunked", "int8_paged_decode_attention",
            "int4_paged_decode_attention"} <= set(_cuda.LAUNCHES)
    # one CUDA source serves K7, K8 and K11
    assert len({_cuda.SOURCES[n] for n in ("int8_decode_attention_chunked",
                                            "int8_paged_decode_attention",
                                            "int4_paged_decode_attention")}) == 1


def test_span_wrappers_take_plain_versions_on_cpu_without_launches():
    """K9 (with K14's names, which run it) and K10 on CPU tensors."""
    _cuda.reset_launches()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-128, 128, (5, 256)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-128, 128, (128, 64)).astype(np.int8))
    ws = torch.from_numpy(rng.integers(1, 4, (2, 64)).astype(np.int8))
    wz = torch.from_numpy(rng.integers(4, 12, (2, 64)).astype(np.int8))
    alpha, beta = torch.full((64,), 1e-3), torch.ones(64)
    for out_dtype in (torch.float32, torch.int8):
        want = tqm.w4a8_matmul_packed_xla(x, qw, ws, wz, alpha, beta, out_dtype=out_dtype)
        for fn in (tqm.w4a8_matmul_packed, tqm.w4a8_matmul_wres, tqm.w4a8_matmul_pipe):
            assert torch.equal(fn(x, qw, ws, wz, alpha, beta, out_dtype=out_dtype), want)
    wsf, wzf = ws.float() * 0.7, wz.float()
    assert torch.equal(tqm.w4a8_fpscale_matmul_packed(x, qw, wsf, wzf, alpha, beta),
                       tqm.w4a8_fpscale_matmul_packed_xla(x, qw, wsf, wzf, alpha, beta))
    assert _cuda.LAUNCHES == {name: 0 for name in _cuda.SOURCES}
    assert _cuda.SOURCES["w4a8_matmul_packed"] == _cuda.SOURCES["w4a8_fpscale_matmul_packed"]
    assert not {"w4a8_matmul_wres", "w4a8_matmul_pipe"} & set(_cuda.LAUNCHES)  # count as K9


def test_k12_wrappers_take_plain_versions_on_cpu_without_launches():
    """K12 and K13's names on CPU tensors: the plain versions, no launch;
    K12's norm and requant entries share one CUDA source (K4's and K5's
    TMA + wgmma kernel on span bytes), its MLP entry has its own, and K13's
    names count as K12."""
    _cuda.reset_launches()
    layer = build_llama_engine(tiny_llama_config(hidden_size=256, intermediate_size=512),
                               seed=0, device="cpu", keep_span=True).layer_list[0]
    xf = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 256)).astype(np.float32))
    qp, op, gu, dn = layer.qkv_proj, layer.o_proj, layer.gate_up_proj, layer.down_proj

    def planes(lin):
        return lin.qweight, lin.s_hi, lin.s_lo, lin.z_hi, lin.z_lo

    y = tfd.fused_norm_gemv(xf, layer.ln1_weight, None, *planes(qp), qp.alpha)
    assert torch.equal(y, tfd.fused_norm_gemv_xla(xf, layer.ln1_weight, None, *planes(qp),
                                                  qp.alpha))
    assert torch.equal(y, tfd.fused_norm_gemv_rp(xf, layer.ln1_weight, None, qp.qw_rp,
                                                 *planes(qp)[1:], qp.cs_fold, qp.alpha))
    assert torch.equal(y, tfd.fused_norm_gemv_s4(xf, layer.ln1_weight, None, *planes(qp),
                                                 qp.alpha))
    y = tfd.fused_requant_gemv(xf, layer.out_input_scale, *planes(op), op.alpha, residual=xf)
    assert torch.equal(y, tfd.fused_requant_gemv_xla(xf, layer.out_input_scale, *planes(op),
                                                     op.alpha, residual=xf))
    assert torch.equal(y, tfd.fused_requant_gemv_s4(xf, layer.out_input_scale, *planes(op),
                                                    op.alpha, residual=xf))
    args = (xf, layer.ln2_weight, None, *planes(gu), gu.alpha, layer.down_input_scale,
            dn.qweight, dn.wscales, dn.wzeros, dn.alpha)
    assert torch.equal(tfd.fused_mlp_decode(*args), tfd.fused_mlp_decode_xla(*args))
    assert _cuda.LAUNCHES == {name: 0 for name in _cuda.SOURCES}
    assert _cuda.SOURCES["fused_norm_gemv"] == _cuda.SOURCES["fused_requant_gemv"] == \
        _cuda.SOURCES["fused_mlp_decode"] == "fused_gemv_span_sm90"
    assert not {"fused_norm_gemv_s4", "fused_requant_gemv_s4"} & set(_cuda.LAUNCHES)


def test_unported_configurations_raise():
    cfg = tiny_llama_config(hidden_size=256, intermediate_size=512)
    assert teng.EngineConfig(cfg=cfg).fused_decode  # the JAX default
    # a fused decode step on span-only storage takes K12 (its plain versions
    # here) and gives the logits of the rowpair copy's K4-K6
    both = build_llama_engine(cfg, seed=0, device="cpu", keep_span=True)
    lins = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")
    span_only = both.layers._replace(**{n: getattr(both.layers, n)._replace(
        qw_rp=None, cs_fold=None) for n in lins})
    eng = teng.EngineParams(both.embed_tokens, span_only, both.norm_weight, both.lm_head,
                            both.rms_eps)
    prompt = torch.arange(1, 9, dtype=torch.int32)[None]
    out = []
    for params in (eng, both):
        cache = teng.init_kv_cache(cfg, 1, 64, device="cpu")
        _, cache = teng.engine_forward(teng.EngineConfig(cfg=cfg), params, prompt, cache)
        out.append(teng.engine_forward(teng.EngineConfig(cfg=cfg), params,
                                       torch.zeros((1, 1), dtype=torch.int32), cache)[0])
    assert torch.equal(out[0], out[1])
    eng = both
    # the KV precision is 8 or 4 bits
    with pytest.raises(ValueError, match="kv_bits must be 8 or 4"):
        teng.EngineConfig(cfg=cfg, kv_bits=3)
    with pytest.raises(ValueError, match="kv_bits must be 8 or 4"):
        teng.init_kv_cache(cfg, 1, 64, kv_bits=3, device="cpu")
    from dgq_tpu_torch.serving import paged

    with pytest.raises(ValueError, match="kv_bits must be 8 or 4"):
        paged.init_paged_cache(cfg, 1, 4, 16, kv_bits=3, device="cpu")
    for kw in (dict(mesh=object()), dict(fns=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
            paged.PagedBatcher(teng.EngineConfig(cfg=cfg), eng, max_len=64, page_size=16, **kw)
    with pytest.raises(NotImplementedError, match="ALiBi"):
        s = torch.tensor(0.02)
        tat.int8_decode_attention(torch.zeros((1, 2, 64), dtype=torch.int8),
                                  torch.zeros((1, 2, 64, 8), dtype=torch.int8),
                                  torch.zeros((1, 2, 8, 64), dtype=torch.int8), 1, s, s, s,
                                  alibi_slopes=torch.ones(2))


def test_probe_wrappers_take_plain_versions_on_cpu_without_launches():
    """P1-P5 on CPU tensors: the plain versions, no launch; P2's three
    engines share a source, P3's two column maps another, and P4's names
    (kern, pl_bitcast) run the bitcast map and count under it."""
    from dgq_tpu_torch.scripts import probe_gemv_engines as p2
    from dgq_tpu_torch.scripts import probe_native_s4 as p3
    from dgq_tpu_torch.scripts import probe_quant_pv_parts as p5
    from dgq_tpu_torch.scripts import probe_s4_bitcast_numerics as p4
    from dgq_tpu_torch.scripts import roofline_probe as p1

    _cuda.reset_launches()
    rng = np.random.default_rng(5)

    def ri(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8))

    x, w = ri(-127, 128, (128, 256)), ri(-127, 128, (256, 128))
    assert torch.equal(p1.s8_matmul(x, w), p1.s8_matmul_plain(x, w))
    x8 = x[:8]
    assert torch.equal(p2.mxu_gemv(x8, w), p2.mxu_gemv_plain(x8, w))
    assert torch.equal(p2.vpu_gemv(x8, w), p2.vpu_gemv_plain(x8, w))
    for a, b in zip(p2.mix_gemv(x8, w), p2.mix_gemv_plain(x8, w)):
        assert torch.equal(a, b)
    x4, wb = ri(-8, 8, (16, 256)), ri(-128, 128, (256, 256))
    assert torch.equal(p3.pallas_s4(x4, wb), p3.pallas_s4_plain(x4, wb))
    assert torch.equal(p3.pallas_s4_bitcast(x4, wb), p3.pallas_s4_bitcast_plain(x4, wb))
    assert torch.equal(p4.pl_bitcast(x4, wb), p3.pallas_s4_bitcast_plain(x4, wb))
    assert torch.equal(p4.kern(x4, wb), p3.pallas_s4_bitcast_plain(x4, wb, 512))
    q, kt, v = ri(-127, 128, (1, 4, 128)), ri(-127, 128, (1, 2, 128, 64)), ri(-127, 128,
                                                                          (1, 2, 64, 128))
    length = torch.tensor([50], dtype=torch.int32)
    for mode in p5.MODES:
        assert torch.equal(p5.attn(q, kt, v, length, mode), p5.attn_plain(q, kt, v, length, mode))
    with pytest.raises(ValueError, match="mode"):
        p5.attn(q, kt, v, length, "fast")
    assert _cuda.LAUNCHES == {name: 0 for name in _cuda.SOURCES}
    assert len({_cuda.SOURCES[n] for n in ("mxu_gemv", "vpu_gemv", "mix_gemv")}) == 1
    assert _cuda.SOURCES["pallas_s4"] == _cuda.SOURCES["pallas_s4_bitcast"]
    assert not {"kern", "pl_bitcast", "attn"} & set(_cuda.LAUNCHES)
