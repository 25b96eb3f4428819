"""The dgq_tpu_torch LLaMA engine held against dgq_tpu's on the CPU.

Weights come from dgq_tpu's synthetic builder and are carried across with
engine_params_from_arrays; prompts are numpy-seeded.  The JAX side runs as
its own tests run it: the plain path (use_kernel=False) and the Pallas
kernels in interpret mode with fused_decode off and on (the default).  The
port's fused default and its unfused path are each held against all three."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.models import engine as jeng
from dgq_tpu.models.llama import tiny_llama_config
from dgq_tpu.models.synthetic import build_llama_engine
from dgq_tpu_torch.models import engine as teng
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.utils.checkpoint import engine_params_from_arrays

CFG = tiny_llama_config(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2)
TCFG = LlamaConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
SMAX = 256
STEPS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them (the
    port's CPU paths ran ~10x slower beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_arrays(eng):
    leaves, _ = jax.tree_util.tree_flatten_with_path(eng)
    return {"/".join(str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k))))
                     for k in path): np.asarray(leaf) for path, leaf in leaves}


@pytest.fixture(scope="module")
def engines():
    j = build_llama_engine(CFG, seed=0)
    t = engine_params_from_arrays(_jax_arrays(j), j.rms_eps, device="cpu")
    return j, t


JAX_MODES = {
    "plain": dict(use_kernel=False),
    "interpret": dict(use_kernel=True, interpret=True, fused_decode=False,
                      bm_prefill=128, bm_decode=128),
    "interpret_fused": dict(use_kernel=True, interpret=True, fused_decode=True,
                            bm_prefill=128, bm_decode=128),
}


def _run_jax(eng, mode, prompt, steps):
    return _run_jax_cfg(eng, jeng.EngineConfig(cfg=CFG, **JAX_MODES[mode]), prompt, steps)


def _run_jax_cfg(eng, ecfg, prompt, steps):
    cache = jeng.init_kv_cache(CFG, prompt.shape[0], SMAX)
    logits, cache = jeng.engine_forward(ecfg, eng, jnp.asarray(prompt), cache)
    out = [np.asarray(logits)]
    for i in range(steps.shape[1]):
        logits, cache = jeng.engine_forward(ecfg, eng, jnp.asarray(steps[:, i:i + 1]), cache)
        out.append(np.asarray(logits))
    return out, np.asarray(cache.k), np.asarray(cache.v)


def _run_port(eng, prompt, steps, **overrides):
    ecfg = teng.EngineConfig(cfg=TCFG, **overrides)
    cache = teng.init_kv_cache(TCFG, prompt.shape[0], SMAX, device="cpu")
    logits, cache = teng.engine_forward(ecfg, eng, torch.from_numpy(prompt), cache)
    out = [logits.numpy()]
    for i in range(steps.shape[1]):
        logits, cache = teng.engine_forward(ecfg, eng, torch.from_numpy(steps[:, i:i + 1]),
                                            cache)
        out.append(logits.numpy())
    assert cache.length == prompt.shape[1] + steps.shape[1]
    return out, cache.k.numpy(), cache.v.numpy()


def _assert_cache_close(got, ref):
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert np.mean(diff == 0) >= 0.999


@pytest.mark.parametrize("prompt_len", [128, 12])  # flash prefill path, plain path
def test_engine_matches_jax(engines, prompt_len):
    jparams, tparams = engines
    rng = np.random.default_rng(prompt_len)
    prompt = rng.integers(0, CFG.vocab_size, size=(2, prompt_len)).astype(np.int32)
    steps = rng.integers(0, CFG.vocab_size, size=(2, STEPS)).astype(np.int32)
    refs = {mode: _run_jax(jparams, mode, prompt, steps) for mode in JAX_MODES}
    for fused in (True, False):  # the default (fused decode) and the unfused path
        got, gk, gv = _run_port(tparams, prompt, steps, fused_decode=fused)
        for mode, (ref, rk, rv) in refs.items():
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g, r, rtol=2e-3, atol=2e-3,
                                           err_msg=f"{mode}, fused={fused}")
            _assert_cache_close(gk, rk)
            _assert_cache_close(gv, rv)


def test_generate_greedy_matches_jax(engines):
    jparams, tparams = engines
    prompt = np.random.default_rng(3).integers(0, CFG.vocab_size, size=(2, 20)).astype(np.int32)
    ref = np.asarray(jeng.generate(jeng.EngineConfig(cfg=CFG, **JAX_MODES["interpret_fused"]),
                                   jparams, jnp.asarray(prompt), 16, SMAX))
    got = teng.generate(teng.EngineConfig(cfg=TCFG), tparams, torch.from_numpy(prompt), 16,
                        SMAX)
    assert got.dtype == torch.int32 and got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), ref)
    unrolled = teng.generate(teng.EngineConfig(cfg=TCFG), tparams, torch.from_numpy(prompt),
                             16, SMAX, decode_unroll=4)
    np.testing.assert_array_equal(unrolled.numpy(), ref)
    unfused = teng.generate(teng.EngineConfig(cfg=TCFG, fused_decode=False), tparams,
                            torch.from_numpy(prompt), 16, SMAX)
    np.testing.assert_array_equal(unfused.numpy(), ref)


def test_verify_window_fused_matches_unfused(engines):
    """An S = 5 decode-side window (speculative verification) rides K4-K6 on
    its flattened rows; its logits match the unfused path's."""
    _, tparams = engines
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(0, CFG.vocab_size, size=(2, 12)).astype(np.int32))
    window = torch.from_numpy(rng.integers(0, CFG.vocab_size, size=(2, 5)).astype(np.int32))
    out = {}
    for fused in (True, False):
        ecfg = teng.EngineConfig(cfg=TCFG, fused_decode=fused)
        cache = teng.init_kv_cache(TCFG, 2, SMAX, device="cpu")
        _, cache = teng.engine_forward(ecfg, tparams, prompt, cache)
        assert teng._use_fused_rows(ecfg, tparams.layer_list[0], 2, 5) == fused
        out[fused], _ = teng.engine_forward(ecfg, tparams, window, cache, window="decode")
    np.testing.assert_allclose(out[True].numpy(), out[False].numpy(), rtol=2e-4, atol=2e-4)


def _jax_layer(jparams):
    return jax.tree_util.tree_map(lambda a: a[0], jparams.layers)


@pytest.mark.parametrize("b,s", [(1, 1), (2, 5), (8, 8), (1, 9), (2, 8), (13, 5), (64, 1),
                                 (65, 1)])
def test_fused_dispatch_matches_jax(engines, b, s):
    """The same shapes take the fused path in both packages."""
    jparams, tparams = engines
    jcfg = jeng.EngineConfig(cfg=CFG, **JAX_MODES["interpret_fused"])
    tcfg = teng.EngineConfig(cfg=TCFG)
    jl, tl = _jax_layer(jparams), tparams.layer_list[0]
    assert teng._decode_fusable(tl) == jeng._decode_fusable(jl)
    assert teng._use_fused_rows(tcfg, tl, b, s) == jeng._use_fused_rows(jcfg, jl, b, s)
    off = dataclasses.replace(tcfg, fused_decode=False)
    assert not teng._use_fused_rows(off, tl, b, s)
    # a layer without plane rows is not fusable in either package
    jl2 = jl._replace(o_proj=jl.o_proj._replace(s_hi=None))
    tl2 = tl._replace(o_proj=tl.o_proj._replace(s_hi=None))
    assert teng._decode_fusable(tl2) == jeng._decode_fusable(jl2) is False


@pytest.mark.parametrize("top_k,top_p", [(8, 1.0), (0, 0.5), (12, 0.6)])
def test_sampling_masks_match_jax(top_k, top_p):
    """Top-k / top-p keep the same tokens as JAX: every token JAX draws is
    kept by the port's mask and every kept token is drawn by both."""
    from dgq_tpu.serving.sampling import SamplingParams as JParams, sample_logits as jsample
    from dgq_tpu_torch.serving.sampling import SamplingParams, filter_logits, sample_logits

    logits = np.random.default_rng(top_k).normal(size=(4, 64)).astype(np.float32) * 0.5
    n = 4000
    jdraws = np.asarray(jsample(jnp.asarray(np.tile(logits, (n, 1))),
                                JParams(temperature=0.7, top_k=top_k, top_p=top_p),
                                jax.random.PRNGKey(0))).reshape(n, 4)
    params = SamplingParams(temperature=0.7, top_k=top_k, top_p=top_p)
    kept = torch.isfinite(filter_logits(torch.from_numpy(logits), params)).numpy()
    gen = torch.Generator().manual_seed(0)
    tdraws = sample_logits(torch.from_numpy(np.tile(logits, (n, 1))), params,
                           gen).numpy().reshape(n, 4)
    for row in range(4):
        want = set(np.flatnonzero(kept[row]))
        assert set(jdraws[:, row]) == want
        assert set(tdraws[:, row]) == want
    greedy = sample_logits(torch.from_numpy(logits), SamplingParams())
    np.testing.assert_array_equal(greedy.numpy(), np.argmax(logits, axis=-1))


@pytest.mark.parametrize("mode", ["plain", "interpret"])
def test_span_storage_unfused_matches_jax(mode):
    """A span-only engine (no rowpair copy) runs every linear through K9 in
    both packages (fused decode off: on span storage it would need K12)."""
    j = build_llama_engine(CFG, seed=1, keep_span=True)
    t = engine_params_from_arrays(_jax_arrays(j), j.rms_eps, device="cpu")
    lins = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")
    j = dataclasses.replace(j, layers=j.layers._replace(**{
        n: getattr(j.layers, n)._replace(qw_rp=None, cs_fold=None) for n in lins}))
    t = dataclasses.replace(t, layers=t.layers._replace(**{
        n: getattr(t.layers, n)._replace(qw_rp=None, cs_fold=None) for n in lins}))
    assert t.layers.qkv_proj.qweight is not None and t.layers.qkv_proj.qw_rp is None
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, CFG.vocab_size, size=(2, 12)).astype(np.int32)
    steps = rng.integers(0, CFG.vocab_size, size=(2, STEPS)).astype(np.int32)
    jcfg = jeng.EngineConfig(cfg=CFG, fused_decode=False,
                             **{k: v for k, v in JAX_MODES[mode].items() if k != "fused_decode"})
    ref = _run_jax_cfg(j, jcfg, prompt, steps)
    calls = []
    real = teng.w4a8_matmul_packed
    teng.w4a8_matmul_packed = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        got, gk, gv = _run_port(t, prompt, steps, fused_decode=False)
    finally:
        teng.w4a8_matmul_packed = real
    assert len(calls) == 4 * CFG.num_hidden_layers * (1 + STEPS)
    for g, r in zip(got, ref[0]):
        np.testing.assert_allclose(g, r, rtol=2e-3, atol=2e-3)
    _assert_cache_close(gk, ref[1])
    _assert_cache_close(gv, ref[2])



def _span_only(seed):
    """The same span-only params in both packages: build_llama_engine's
    keep_span storage with the rowpair copy dropped."""
    j = build_llama_engine(CFG, seed=seed, keep_span=True)
    t = engine_params_from_arrays(_jax_arrays(j), j.rms_eps, device="cpu")
    lins = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")
    j = dataclasses.replace(j, layers=j.layers._replace(**{
        n: getattr(j.layers, n)._replace(qw_rp=None, cs_fold=None) for n in lins}))
    t = dataclasses.replace(t, layers=t.layers._replace(**{
        n: getattr(t.layers, n)._replace(qw_rp=None, cs_fold=None) for n in lins}))
    return j, t


def test_span_storage_fused_matches_jax():
    """Fused decode on a span-only engine takes K12 (its plain versions on
    CPU tensors) in the port and JAX's K12 kernels in interpret mode: the
    prefill, 8 teacher-forced steps and a 5-token verify window give JAX's
    logits and int8 caches, with K12's three entries once per layer of every
    fused forward, and greedy generation JAX's 16 tokens."""
    j, t = _span_only(4)
    assert t.layers.qkv_proj.qweight is not None and t.layers.qkv_proj.s_hi is not None
    tl = t.layer_list[0]
    assert teng._use_fused_rows(teng.EngineConfig(cfg=TCFG), tl, 2, 5)
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, CFG.vocab_size, size=(2, 12)).astype(np.int32)
    steps = rng.integers(0, CFG.vocab_size, size=(2, STEPS)).astype(np.int32)
    window = rng.integers(0, CFG.vocab_size, size=(2, 5)).astype(np.int32)
    jcfg = jeng.EngineConfig(cfg=CFG, **JAX_MODES["interpret_fused"])
    jcache = jeng.init_kv_cache(CFG, 2, SMAX)
    logits, jcache = jeng.engine_forward(jcfg, j, jnp.asarray(prompt), jcache)
    ref = [np.asarray(logits)]
    for i in range(STEPS):
        logits, jcache = jeng.engine_forward(jcfg, j, jnp.asarray(steps[:, i:i + 1]), jcache)
        ref.append(np.asarray(logits))
    logits, jcache = jeng.engine_forward(jcfg, j, jnp.asarray(window), jcache, window="decode")
    ref.append(np.asarray(logits))

    calls = {name: 0 for name in ("fused_norm_gemv", "fused_requant_gemv", "fused_mlp_decode",
                                  "fused_norm_gemv_rp")}
    real = {name: getattr(teng, name) for name in calls}

    def counted(name):
        def fn(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return fn

    tcfg = teng.EngineConfig(cfg=TCFG)
    try:
        for name in calls:
            setattr(teng, name, counted(name))
        cache = teng.init_kv_cache(TCFG, 2, SMAX, device="cpu")
        logits, cache = teng.engine_forward(tcfg, t, torch.from_numpy(prompt), cache)
        got = [logits.numpy()]
        for i in range(STEPS):
            logits, cache = teng.engine_forward(tcfg, t, torch.from_numpy(steps[:, i:i + 1]),
                                                cache)
            got.append(logits.numpy())
        logits, cache = teng.engine_forward(tcfg, t, torch.from_numpy(window), cache,
                                            window="decode")
        got.append(logits.numpy())
    finally:
        for name, fn in real.items():
            setattr(teng, name, fn)
    fused_forwards = STEPS + 1
    assert calls == {"fused_norm_gemv": CFG.num_hidden_layers * fused_forwards,
                     "fused_requant_gemv": CFG.num_hidden_layers * fused_forwards,
                     "fused_mlp_decode": CFG.num_hidden_layers * fused_forwards,
                     "fused_norm_gemv_rp": 0}
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=2e-3, atol=2e-3)
    _assert_cache_close(cache.k.numpy(), np.asarray(jcache.k))
    _assert_cache_close(cache.v.numpy(), np.asarray(jcache.v))

    gen_prompt = np.random.default_rng(23).integers(0, CFG.vocab_size, (2, 20)).astype(np.int32)
    want = np.asarray(jeng.generate(jcfg, j, jnp.asarray(gen_prompt), 16, SMAX))
    np.testing.assert_array_equal(
        teng.generate(tcfg, t, torch.from_numpy(gen_prompt), 16, SMAX).numpy(), want)
    assert len(set(want.ravel().tolist())) > 2
