"""The dgq_tpu_torch OPT engine and the span-layout GEMM K9 (which also
serves K14's names) held against dgq_tpu on the CPU.

K9's plain version is held against JAX's Pallas kernels in interpret mode
and against the plain branches of JAX's engines, on numpy-seeded inputs.
The OPT engine's weights are numpy-seeded, written by JAX's
``save_engine(..., arch="opt")`` and read by the port's ``load_engine``
(and back), then both engines prefill and decode 16 greedy tokens: JAX as
its own tests run it, plain (``use_kernel=False``) and with its kernels in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.models import engine as jeng
from dgq_tpu.models import opt_engine as jopt
from dgq_tpu.models.opt import tiny_opt_config
from dgq_tpu.ops import quant_matmul as jqm
from dgq_tpu.utils import checkpoint as jck
from dgq_tpu.utils.evalutils import ppl_eval_engine as jax_ppl
from dgq_tpu_torch.models import opt_engine as topt
from dgq_tpu_torch.models.opt import OPTConfig
from dgq_tpu_torch.ops import quant_matmul as tqm
from dgq_tpu_torch.utils import checkpoint as tck
from dgq_tpu_torch.utils.evalutils import ppl_eval_engine

CFG = tiny_opt_config(hidden_size=256, ffn_dim=512, num_attention_heads=4, vocab_size=256)
TCFG = OPTConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
GS = 64
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


def span_inputs(m, k, n, gs, seed):
    """int8 x, span bytes, compact int8 scales in [1, 4) and zeros in
    [4, 12), alpha and beta."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    qw = rng.integers(-128, 128, size=(k // 2, n)).astype(np.int8)
    ws = rng.integers(1, 4, size=(k // gs, n)).astype(np.int8)
    wz = rng.integers(4, 12, size=(k // gs, n)).astype(np.int8)
    alpha = rng.uniform(1e-5, 1e-3, size=(n,)).astype(np.float32)
    beta = rng.normal(size=(n,)).astype(np.float32)
    return x, qw, ws, wz, alpha, beta


def _check_out(got, ref, int8):
    if int8:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gs", [64, 128])
@pytest.mark.parametrize("m", [1, 5, 40, 130])
def test_k9_plain_matches_jax(m, gs):
    """int8 and f32 out, with and without beta: equal to JAX's K9 in
    interpret mode and to the plain branches of its OPT and LLaMA engines
    (int8 exactly; f32 within 1e-6, JAX's interpret mode may fuse the
    epilogue's multiply and add)."""
    k, n = 512, 256
    x, qw, ws, wz, alpha, beta = span_inputs(m, k, n, gs, seed=m + gs)
    rep = np.repeat(ws, 8, axis=0), np.repeat(wz, 8, axis=0)
    for int8 in (False, True):
        for b in (None, beta):
            got = tqm.w4a8_matmul_packed(
                _t(x), _t(qw), _t(rep[0]), _t(rep[1]), _t(alpha), None if b is None else _t(b),
                groupsize=gs, out_dtype=torch.int8 if int8 else torch.float32,
                scales_replicated=True).numpy()
            assert got.dtype == (np.int8 if int8 else np.float32) and got.shape == (m, n)
            ref = jqm.w4a8_matmul_packed(
                jnp.asarray(x), jnp.asarray(qw), jnp.asarray(rep[0]), jnp.asarray(rep[1]),
                jnp.asarray(alpha), None if b is None else jnp.asarray(b), groupsize=gs,
                span=2 * gs, bm=128, bn=128, out_dtype=jnp.int8 if int8 else jnp.float32,
                interpret=True, scales_replicated=True)
            _check_out(got, np.asarray(ref), int8)
            lin = jeng.EngineLinear(qweight=jnp.asarray(qw), wscales=jnp.asarray(rep[0]),
                                    wzeros=jnp.asarray(rep[1]), alpha=jnp.asarray(alpha),
                                    bias=None if b is None else jnp.asarray(b))
            if int8:
                xla = jopt._linear_s8_int8out(lin, jnp.asarray(x), use_kernel=False, bm=128,
                                              interpret=False)
            else:
                xla = jeng._linear_s8(lin, jnp.asarray(x), use_kernel=False)
            np.testing.assert_array_equal(got, np.asarray(xla))
            # compact scales give the same
            again = tqm.w4a8_matmul_packed(
                _t(x), _t(qw), _t(ws), _t(wz), _t(alpha), None if b is None else _t(b),
                groupsize=gs, out_dtype=torch.int8 if int8 else torch.float32).numpy()
            np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("name", ["w4a8_matmul_wres", "w4a8_matmul_pipe"])
def test_k14_names_match_jax(name):
    """JAX's dequant-once and pipelined span kernels in interpret mode against
    the port's names, which run K9."""
    gs, m, k, n = 128, 40, 1024, 256
    x, qw, ws, wz, alpha, beta = span_inputs(m, k, n, gs, seed=7)
    rep = np.repeat(ws, 8, axis=0), np.repeat(wz, 8, axis=0)
    blocks = dict(bm=128, bn=128) if name == "w4a8_matmul_wres" else dict(bm=128, bn=128, bk=512)
    for int8 in (False, True):
        ref = getattr(jqm, name)(
            jnp.asarray(x), jnp.asarray(qw), jnp.asarray(rep[0]), jnp.asarray(rep[1]),
            jnp.asarray(alpha), jnp.asarray(beta), groupsize=gs, span=2 * gs,
            out_dtype=jnp.int8 if int8 else jnp.float32, interpret=True,
            scales_replicated=True, **blocks)
        got = getattr(tqm, name)(_t(x), _t(qw), _t(rep[0]), _t(rep[1]), _t(alpha), _t(beta),
                                 groupsize=gs, out_dtype=torch.int8 if int8 else torch.float32,
                                 scales_replicated=True).numpy()
        _check_out(got, np.asarray(ref), int8)


def _opt_arrays(seed=0):
    """A numpy-seeded OPT engine under save_engine's keys: span-only
    linears (groupsize 64) with biases, every layer its own draw."""
    rng = np.random.default_rng(seed)
    d, f, nl = CFG.hidden_size, CFG.ffn_dim, CFG.num_hidden_layers

    def lin(prefix, n_out, n_in, alpha, bias):
        return {
            f"{prefix}/qweight": rng.integers(-128, 128, (nl, n_in // 2, n_out)).astype(np.int8),
            f"{prefix}/wscales": np.repeat(rng.integers(1, 4, (nl, n_in // GS, n_out)), 8,
                                           axis=1).astype(np.int8),
            f"{prefix}/wzeros": np.repeat(rng.integers(4, 12, (nl, n_in // GS, n_out)), 8,
                                          axis=1).astype(np.int8),
            f"{prefix}/alpha": rng.uniform(alpha / 2, 2 * alpha, (nl, n_out)).astype(np.float32),
            f"{prefix}/bias": (rng.normal(size=(nl, n_out)) * bias).astype(np.float32),
        }

    def vec(lo, hi):
        return rng.uniform(lo, hi, (nl, d)).astype(np.float32)

    out = {
        "embed_tokens": rng.normal(size=(CFG.vocab_size, d)).astype(np.float32),
        "embed_positions": rng.normal(size=(CFG.max_position_embeddings + 2, d)).astype(
            np.float32),
        "final_ln_weight": np.ones((d,), np.float32),
        "final_ln_bias": np.zeros((d,), np.float32),
        "lm_head": (rng.normal(size=(CFG.vocab_size, d)) * 0.5).astype(np.float32),
        "layers/ln1_weight": vec(8, 12), "layers/ln1_bias": vec(-2, 2),
        "layers/ln2_weight": vec(8, 12), "layers/ln2_bias": vec(-2, 2),
    }
    out.update(lin("layers/qkv_proj", 3 * d, d, 1e-2, 3.0))
    out.update(lin("layers/out_proj", d, d, 1e-4, 0.1))
    out.update(lin("layers/fc1", f, d, 1e-4, 0.1))
    out.update(lin("layers/fc2", d, f, 1e-4, 0.1))
    for name in ("q_scale", "k_scale", "v_scale", "out_input_scale", "fc2_input_scale"):
        out[f"layers/{name}"] = rng.uniform(0.04, 0.06, (nl,)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """JAX's OPTEngineParams, saved by JAX's save_engine, loaded by the
    port's load_engine."""
    arrays = _opt_arrays()
    j = jck._rebuild_namedtuple(jopt.OPTEngineParams, {k: jnp.asarray(v) for k, v in arrays.items()})
    path = str(tmp_path_factory.mktemp("opt") / "opt_engine.safetensors")
    jck.save_engine(path, j, CFG, arch="opt")
    t, tcfg = tck.load_engine(path, device="cpu")
    assert tcfg == TCFG and isinstance(t, topt.OPTEngineParams)
    return j, t, arrays


def test_opt_checkpoint_round_trips_with_jax(engines, tmp_path):
    """JAX's file loads into bit-equal tensors with span-only storage (no
    rowpair or plane rows derived), and the port's file loads in JAX."""
    j, t, arrays = engines
    got = tck.engine_arrays(t)
    assert set(got) == set(arrays)
    for key, a in arrays.items():
        assert got[key].dtype == _t(a).dtype and torch.equal(got[key], _t(a)), key
    assert t.layers.qkv_proj.qw_rp is None and t.layers.fc2.s_hi is None
    path = str(tmp_path / "port.safetensors")
    tck.save_engine(path, t, TCFG, arch="opt")
    j2, cfg2 = jck.load_engine(path)
    assert cfg2 == CFG
    for key, a in arrays.items():
        leaf = j2
        for part in key.split("/"):
            leaf = getattr(leaf, part)
        np.testing.assert_array_equal(np.asarray(leaf), a, err_msg=key)


JAX_MODES = {
    "plain": dict(use_kernel=False),
    "interpret": dict(use_kernel=True, interpret=True, bm_prefill=128, bm_decode=128),
}


def _greedy_jax(eng, ecfg, prompt, steps, cache):
    logits, cache = jopt.opt_engine_forward(ecfg, eng, jnp.asarray(prompt), cache)
    out, toks = [np.asarray(logits)], []
    for _ in range(steps):
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok)[:, 0])
        logits, cache = jopt.opt_engine_forward(ecfg, eng, tok, cache)
        out.append(np.asarray(logits))
    return out, np.stack(toks, 1), np.asarray(cache.k), np.asarray(cache.v)


def _greedy_port(eng, ecfg, prompt, steps, cache, forward):
    logits, cache = forward(ecfg, eng, torch.from_numpy(prompt), cache)
    out, toks = [logits.numpy()], []
    for _ in range(steps):
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        toks.append(tok.numpy()[:, 0])
        logits, cache = forward(ecfg, eng, tok, cache)
        out.append(logits.numpy())
    assert cache.length == prompt.shape[1] + steps
    return out, np.stack(toks, 1), cache.k.numpy(), cache.v.numpy()


def assert_cache_close(got, ref):
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert np.mean(diff == 0) >= 0.999


def assert_runs_match(got, ref):
    """Greedy tokens equal, logits within 2e-3 (JAX's own tolerance for its
    kernel paths), int8 caches within 1 and >= 99.9% equal."""
    (gl, gt, gk, gv), (rl, rt, rk, rv) = got, ref
    np.testing.assert_array_equal(gt, rt)
    for g, r in zip(gl, rl):
        np.testing.assert_allclose(g, r, rtol=2e-3, atol=2e-3)
    assert_cache_close(gk, rk)
    assert_cache_close(gv, rv)


@pytest.mark.parametrize("mode", list(JAX_MODES))
def test_opt_engine_matches_jax(engines, mode):
    """Prefill of 2 x 20 tokens and 16 greedy decode steps."""
    j, t, _ = engines
    prompt = np.random.default_rng(5).integers(0, CFG.vocab_size, (2, 20)).astype(np.int32)
    ref = _greedy_jax(j, jopt.OPTEngineConfig(cfg=CFG, **JAX_MODES[mode]), prompt, STEPS,
                      jopt.init_opt_kv_cache(CFG, 2, SMAX))
    got = _greedy_port(t, topt.OPTEngineConfig(cfg=TCFG), prompt, STEPS,
                       topt.init_opt_kv_cache(TCFG, 2, SMAX, device="cpu"),
                       topt.opt_engine_forward)
    assert_runs_match(got, ref)
    assert len(set(got[1].ravel().tolist())) > 2  # the greedy tokens are not degenerate


def test_opt_ppl_matches_jax(engines):
    """ppl_eval_engine over a two-window stream, the OPT pair of functions
    handed in as JAX's test does."""
    j, t, _ = engines
    stream = np.random.default_rng(9).integers(0, CFG.vocab_size, 2 * 32).astype(np.int32)
    ref = jax_ppl(jopt.OPTEngineConfig(cfg=CFG, use_kernel=False), j, stream, seqlen=32,
                  forward_fn=jopt.opt_engine_forward, init_cache_fn=jopt.init_opt_kv_cache)
    got = ppl_eval_engine(topt.OPTEngineConfig(cfg=TCFG), t, stream, seqlen=32,
                          forward_fn=topt.opt_engine_forward,
                          init_cache_fn=topt.init_opt_kv_cache)
    assert np.isfinite(got) and got > 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        ppl_eval_engine(topt.OPTEngineConfig(cfg=TCFG), t, stream, seqlen=32, mesh=object())


def test_opt_config_options():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        topt.OPTEngineConfig(cfg=TCFG, tp_axis="tp")
    with pytest.raises(NotImplementedError, match="kv_bits=8"):
        topt.OPTEngineConfig(cfg=TCFG, kv_bits=4)
    assert OPTConfig().head_dim == 128 and OPTConfig().ffn_dim == 16384  # OPT-6.7B
