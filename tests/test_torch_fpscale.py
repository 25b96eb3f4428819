"""The dgq_tpu_torch LLaMA engine with fp32 group scales (``fp_scales``, the
w4w8-fallback representation) and its GEMM K10 held against dgq_tpu on the
CPU.

K10's plain version takes the kernel's steps: an exact int32 dot per group
with the raw codes, then ``acc + s * (d - z * rowsum)`` in fp32, group by
group in K order.  JAX's Pallas K10 in interpret mode takes the same steps,
so the two agree to the last few ulps (XLA on the CPU may contract a multiply
and an add into one fused step): rtol 1e-6 of the largest output.  The
engine's weights are numpy-seeded, written by JAX's ``save_engine`` and read
by the port's ``load_engine``; both engines prefill and decode 16 greedy
tokens, JAX plain (``use_kernel=False``, whose fp-scale branch multiplies
dequantised fp32 weights instead) and with its kernels in interpret mode."""

import dataclasses
import json
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.models import engine as jeng
from dgq_tpu.models.llama import tiny_llama_config
from dgq_tpu.ops import quant_matmul as jqm
from dgq_tpu.serving.scheduler import ContinuousBatcher as JBatcher
from dgq_tpu.serving.scheduler import Request as JRequest
from dgq_tpu.utils import checkpoint as jck
from dgq_tpu.utils.evalutils import ppl_eval_engine as jax_ppl
from dgq_tpu_torch import serve as tserve
from dgq_tpu_torch.models import engine as teng
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.ops import quant_matmul as tqm
from dgq_tpu_torch.serving.paged import PagedBatcher
from dgq_tpu_torch.serving.scheduler import ContinuousBatcher, Request
from dgq_tpu_torch.utils import checkpoint as tck
from dgq_tpu_torch.utils.evalutils import ppl_eval_engine

CFG = tiny_llama_config(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2)
TCFG = LlamaConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
SMAX = 64
STEPS = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them (the
    port's CPU paths ran ~10x slower beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def fp_inputs(m, k, n, gs, seed):
    """int8 x, span bytes, fp32 group scales (int scale x per-channel fp
    factor) and integer-valued fp32 zeros, alpha, beta."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    qw = rng.integers(-128, 128, size=(k // 2, n)).astype(np.int8)
    ws = (rng.integers(1, 4, size=(k // gs, n)) * rng.uniform(0.5, 1.0, size=(n,))).astype(
        np.float32)
    wz = rng.integers(4, 12, size=(k // gs, n)).astype(np.float32)
    alpha = rng.uniform(1e-5, 1e-3, size=(n,)).astype(np.float32)
    beta = rng.normal(size=(n,)).astype(np.float32)
    return x, qw, ws, wz, alpha, beta


@pytest.mark.parametrize("gs", [64, 128])
@pytest.mark.parametrize("m", [1, 5, 40, 130])
def test_k10_plain_matches_jax(m, gs):
    k, n = 1024, 256
    x, qw, ws, wz, alpha, beta = fp_inputs(m, k, n, gs, seed=m + gs)
    for b in (None, beta):
        ref = np.asarray(jqm.w4a8_fpscale_matmul_packed(
            jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws), jnp.asarray(wz),
            jnp.asarray(alpha), None if b is None else jnp.asarray(b), groupsize=gs,
            span=2 * gs, bm=128, bn=128, interpret=True))
        got = tqm.w4a8_fpscale_matmul_packed(_t(x), _t(qw), _t(ws), _t(wz), _t(alpha),
                                             None if b is None else _t(b), groupsize=gs).numpy()
        assert got.dtype == np.float32 and got.shape == (m, n)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
        rep = tqm.w4a8_fpscale_matmul_packed(
            _t(x), _t(qw), _t(np.repeat(ws, 8, axis=0)), _t(np.repeat(wz, 8, axis=0)),
            _t(alpha), None if b is None else _t(b), groupsize=gs,
            scales_replicated=True).numpy()
        np.testing.assert_array_equal(rep, got)
    # integer-valued unit scales and zero zeros: the exact int32 product
    one = np.ones_like(ws)
    exact = tqm.w4a8_fpscale_matmul_packed(_t(x), _t(qw), _t(one), _t(0 * wz),
                                           torch.ones(n), groupsize=gs).numpy()
    codes = tqm.unpack_nibbles(_t(qw), 2 * gs).numpy().astype(np.int64)
    np.testing.assert_array_equal(exact, x.astype(np.int64) @ codes)


def _split_emulated(x, qw, ws, wz, alpha, beta, gs, p_split):
    """K10 with K split as the plan splits it: each split sums its own groups
    from 0 in the plain version's steps, then the splits are added in split
    order and the epilogue applied (``splitk_combine``)."""
    m, k = x.shape
    acc = None
    for p0 in range(0, k // 2, p_split):
        p1 = min(p0 + p_split, k // 2)
        g0, g1 = 2 * p0 // gs, 2 * p1 // gs
        part = tqm.w4a8_fpscale_matmul_packed(
            x[:, 2 * p0:2 * p1].contiguous(), qw[p0:p1].contiguous(), ws[g0:g1], wz[g0:g1],
            torch.ones_like(alpha), groupsize=gs)
        acc = part if acc is None else acc + part
    return tqm._epilogue(acc, alpha, beta, torch.float32)


@pytest.mark.parametrize("k,m", [(4096, 4), (11264, 1), (4096, 16)])
def test_k10_split_in_plan_order_matches_jax(k, m):
    """The split sum in the order of the plan's splits at a LLaMA-2-7B K (the
    plan of o_proj / down_proj at that M on 132 SMs, on 256 columns): within
    1e-5 of the largest output of JAX's kernel in interpret mode, as the card
    holds a split K10."""
    gs, n = 128, 256
    tile, p_split = tqm.fpscale_plan(m, 4096, k, gs, 132)
    assert tile == tqm.FP_DECODE_TILE and p_split < k // 2  # the plan splits K
    x, qw, ws, wz, alpha, beta = fp_inputs(m, k, n, gs, seed=k + m)
    ref = np.asarray(jqm.w4a8_fpscale_matmul_packed(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws), jnp.asarray(wz), jnp.asarray(alpha),
        jnp.asarray(beta), groupsize=gs, span=2 * gs, bm=128, bn=128, interpret=True))
    got = _split_emulated(*(_t(a) for a in (x, qw, ws, wz, alpha, beta)), gs, p_split).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _fp_arrays(seed=0):
    """A numpy-seeded fp-scale LLaMA engine under save_engine's keys, as
    JAX's from_ptq converts a mixed model: span storage, fp32 group scales
    and zeros 8x row-replicated, alpha = the input scale, no plane rows and
    no rowpair copy."""
    rng = np.random.default_rng(seed)
    d, nl, gs = CFG.hidden_size, CFG.num_hidden_layers, 128
    f = CFG.intermediate_size
    nq, nkv = CFG.num_attention_heads * CFG.head_dim, CFG.num_key_value_heads * CFG.head_dim

    def lin(prefix, n_out, n_in, alpha):
        ws = rng.integers(1, 4, (nl, n_in // gs, n_out)) * rng.uniform(0.5, 1.0, (nl, 1, n_out))
        return {
            f"{prefix}/qweight": rng.integers(-128, 128, (nl, n_in // 2, n_out)).astype(np.int8),
            f"{prefix}/wscales": np.repeat(ws, 8, axis=1).astype(np.float32),
            f"{prefix}/wzeros": np.repeat(rng.integers(4, 12, (nl, n_in // gs, n_out)), 8,
                                          axis=1).astype(np.float32),
            f"{prefix}/alpha": np.full((nl, n_out), alpha, np.float32),
        }

    out = {
        "embed_tokens": (rng.normal(size=(CFG.vocab_size, d)) * 0.02).astype(np.float32),
        "norm_weight": np.ones((d,), np.float32),
        "lm_head": (rng.normal(size=(CFG.vocab_size, d)) * 0.02).astype(np.float32),
        "layers/ln1_weight": np.full((nl, d), 10.0, np.float32),
        "layers/ln2_weight": np.full((nl, d), 10.0, np.float32),
    }
    out.update(lin("layers/qkv_proj", nq + 2 * nkv, d, 1e-3))
    out.update(lin("layers/o_proj", d, nq, 1e-4))
    out.update(lin("layers/gate_up_proj", 2 * f, d, 1e-4))
    out.update(lin("layers/down_proj", d, f, 1e-4))
    for name in ("q_scale", "k_scale", "v_scale", "out_input_scale", "down_input_scale"):
        out[f"layers/{name}"] = np.full((nl,), 0.05, np.float32)
    return out


@pytest.fixture(scope="module")
def fp_ckpt(tmp_path_factory):
    """The fp-scale engine in JAX, written by JAX's save_engine: (path, JAX
    params)."""
    arrays = _fp_arrays()
    layers = jck._rebuild_namedtuple(
        jeng.EngineLayer, {k[len("layers/"):]: jnp.asarray(v) for k, v in arrays.items()
                           if k.startswith("layers/")})
    j = jeng.EngineParams(embed_tokens=jnp.asarray(arrays["embed_tokens"]), layers=layers,
                          norm_weight=jnp.asarray(arrays["norm_weight"]),
                          lm_head=jnp.asarray(arrays["lm_head"]), rms_eps=CFG.rms_norm_eps)
    path = str(tmp_path_factory.mktemp("fp") / "fp_engine.safetensors")
    jck.save_engine(path, j, CFG)
    return path, j, arrays


@pytest.fixture(scope="module")
def engines(fp_ckpt):
    path, j, arrays = fp_ckpt
    t, tcfg = tck.load_engine(path, device="cpu")
    assert tcfg == TCFG
    got = tck.engine_arrays(t)
    assert set(got) == set(arrays)  # f32 scales load as stored: no plane rows, no rowpair
    for key, a in arrays.items():
        assert torch.equal(got[key], _t(a)), key
    return j, t


JAX_MODES = {
    "plain": dict(use_kernel=False),
    "interpret": dict(use_kernel=True, interpret=True, bm_prefill=128, bm_decode=128),
}


def _greedy(forward, ecfg, eng, prompt, steps, cache, to_np, from_np, argmax):
    logits, cache = forward(ecfg, eng, from_np(prompt), cache)
    out, toks = [to_np(logits)], []
    for _ in range(steps):
        tok = argmax(logits)
        toks.append(to_np(tok)[:, 0])
        logits, cache = forward(ecfg, eng, tok, cache)
        out.append(to_np(logits))
    return out, np.stack(toks, 1), to_np(cache.k), to_np(cache.v)


def run_jax(eng, ecfg, prompt, steps):
    return _greedy(jeng.engine_forward, ecfg, eng, prompt, steps,
                   jeng.init_kv_cache(ecfg.cfg, prompt.shape[0], SMAX), np.asarray, jnp.asarray,
                   lambda lg: jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32))


def run_port(eng, ecfg, prompt, steps):
    return _greedy(teng.engine_forward, ecfg, eng, prompt, steps,
                   teng.init_kv_cache(ecfg.cfg, prompt.shape[0], SMAX, device="cpu"),
                   lambda a: a.numpy(), torch.from_numpy,
                   lambda lg: torch.argmax(lg[:, -1:], dim=-1).to(torch.int32))


def assert_runs_match(got, ref):
    """Greedy tokens equal, logits within 2e-3, int8 caches within 1 and
    >= 99.9% equal."""
    (gl, gt, gk, gv), (rl, rt, rk, rv) = got, ref
    np.testing.assert_array_equal(gt, rt)
    for g, r in zip(gl, rl):
        np.testing.assert_allclose(g, r, rtol=2e-3, atol=2e-3)
    for g, r in ((gk, rk), (gv, rv)):
        diff = np.abs(g.astype(np.int32) - r.astype(np.int32))
        assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999


@pytest.mark.parametrize("mode", list(JAX_MODES))
def test_fpscale_engine_matches_jax(engines, mode):
    """Prefill of 2 x 20 tokens and 16 greedy decode steps; fused decode is
    off under fp_scales in both packages."""
    j, t = engines
    prompt = np.random.default_rng(3).integers(0, CFG.vocab_size, (2, 20)).astype(np.int32)
    jcfg = jeng.EngineConfig(cfg=CFG, fp_scales=True, **JAX_MODES[mode])
    tcfg = teng.EngineConfig(cfg=TCFG, fp_scales=True)
    assert not teng._use_fused_rows(tcfg, t.layer_list[0], 2, 1)
    got = run_port(t, tcfg, prompt, STEPS)
    assert_runs_match(got, run_jax(j, jcfg, prompt, STEPS))
    assert len(set(got[1].ravel().tolist())) > 2  # the greedy tokens are not degenerate


def test_fpscale_ppl_matches_jax(engines):
    """ppl_eval_engine with its default LLaMA functions, two windows."""
    j, t = engines
    stream = np.random.default_rng(4).integers(0, CFG.vocab_size, 2 * 32).astype(np.int32)
    ref = jax_ppl(jeng.EngineConfig(cfg=CFG, use_kernel=False, fp_scales=True), j, stream,
                  seqlen=32)
    got = ppl_eval_engine(teng.EngineConfig(cfg=TCFG, fp_scales=True), t, stream, seqlen=32)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


# serving an fp-scale checkpoint: the batchers take fp_scales from the stored
# group scales (JAX's from_checkpoint and serve leave it off and run the
# int8-scale branch on fp32 scales; the port matches JAX's batcher built with
# EngineConfig(fp_scales=True))
SERVE_PROMPTS = (20, 9, 14)
SERVE_NEW = 8


@pytest.fixture(scope="module")
def served_want(fp_ckpt):
    """{uid: greedy tokens} of JAX's ContinuousBatcher with fp_scales=True."""
    _, j, _ = fp_ckpt
    ref = JBatcher(jeng.EngineConfig(cfg=CFG, use_kernel=False, fp_scales=True), j,
                   num_slots=2, max_len=SMAX, prefill_pad=8)
    for uid, p in enumerate(_serve_prompts()):
        ref.add_request(JRequest(uid=uid, prompt_ids=p, max_new_tokens=SERVE_NEW))
    want = {r.uid: r.output_ids for r in ref.run()}
    assert len({t for toks in want.values() for t in toks}) > 2  # not degenerate
    return want


def _serve_prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in SERVE_PROMPTS]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_fpscale_checkpoint_from_checkpoint_matches_jax(fp_ckpt, served_want, kind):
    """Both batchers' ``from_checkpoint`` turn fp_scales on for fp32 group
    scales, and serve JAX's fp_scales=True tokens."""
    path = fp_ckpt[0]
    if kind == "dense":
        b = ContinuousBatcher.from_checkpoint(path, device="cpu", num_slots=2, max_len=SMAX,
                                              prefill_pad=8)
    else:
        b = PagedBatcher.from_checkpoint(path, device="cpu", num_slots=2, max_len=SMAX,
                                         page_size=16)
    assert b.ecfg.fp_scales
    for uid, p in enumerate(_serve_prompts()):
        b.add_request(Request(uid=uid, prompt_ids=p, max_new_tokens=SERVE_NEW))
    assert {r.uid: r.output_ids for r in b.run()} == served_want


@pytest.mark.parametrize("paged", [False, True])
def test_fpscale_checkpoint_serves_over_the_daemon(fp_ckpt, served_want, paged):
    """``serve.build_server`` on the fp-scale checkpoint, over a localhost
    socket: the served tokens are JAX's fp_scales=True batcher's."""
    flags = ["--cpu", "--port", "0", "--max-len", str(SMAX), "--slots", "2",
             "--metrics-interval", "0", "--prefill-pad", "8"]
    if paged:
        flags += ["--paged", "--page-size", "16"]
    args = tserve.build_parser().parse_args([fp_ckpt[0], *flags])
    with tserve.build_server(args) as srv:
        assert srv.batcher.ecfg.fp_scales
        with socket.create_connection((srv.host, srv.port), timeout=120) as sock:
            f = sock.makefile("r")
            for p in _serve_prompts():
                sock.sendall((json.dumps({"prompt_ids": p.tolist(),
                                          "max_new_tokens": SERVE_NEW}) + "\n").encode())
            finals = {}
            while len(finals) < len(SERVE_PROMPTS):
                msg = json.loads(f.readline())
                if msg["done"]:
                    finals[msg["uid"]] = msg["output_ids"]
    assert finals == served_want


def test_fp_scales_of_rejects_a_mixed_engine(engines):
    """fp32 scales in some linears and int8 in others raise, naming both
    kinds; one kind gives fp_scales directly."""
    _, t = engines
    assert tck.fp_scales_of(t)
    o = t.layers.o_proj
    mixed = dataclasses.replace(t, layers=t.layers._replace(
        o_proj=o._replace(wscales=o.wscales.to(torch.int8))))
    with pytest.raises(ValueError, match=r"layers/qkv_proj.*layers/o_proj"):
        tck.fp_scales_of(mixed)
