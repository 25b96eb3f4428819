"""dgq_tpu_torch's speculative decoding held against dgq_tpu's on the CPU.

The scenarios of tests/test_speculative.py and
tests/test_path_consistency.py's test_speculative_bitwise_greedy, run
through both packages on the same weights: prompt-lookup drafting on the
host and on the device (with JAX's dynamic_slice clamp at the buffer's
end), host-loop and on-device generation with quant_pv on and off, the
capacity edges, the verify step's rollback, draft-model speculation, and
OPT through ``forward_fn``.  The LLaMA weights come from dgq_tpu's
build_llama_engine carried across with engine_params_from_arrays; JAX runs its plain
path (use_kernel=False), the port its default (fused decode, the kernels'
plain versions on CPU tensors).  Emitted tokens must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.models import engine as jeng
from dgq_tpu.models.llama import LlamaConfig as JLlamaConfig
from dgq_tpu.models.synthetic import build_llama_engine
from dgq_tpu.serving import speculative as jspec
from dgq_tpu_torch.models import engine as teng
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.serving import speculative as tspec
from dgq_tpu_torch.utils.checkpoint import engine_params_from_arrays

CFG = JLlamaConfig(vocab_size=128, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=256)
TCFG = LlamaConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})


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


def _pair(seed):
    j = build_llama_engine(CFG, seed=seed)
    return j, engine_params_from_arrays(_jax_arrays(j), j.rms_eps, device="cpu")


@pytest.fixture(scope="module")
def engines():
    return _pair(3)


def _cfgs(quant_pv=True):
    return (jeng.EngineConfig(cfg=CFG, use_kernel=False, quant_pv=quant_pv),
            teng.EngineConfig(cfg=TCFG, quant_pv=quant_pv))


def _both(engines, prompt, max_new, max_len, quant_pv=True, **kw):
    """generate_speculative through both packages, and the port's generate."""
    (jp, tp), (jc, tc) = engines, _cfgs(quant_pv)
    jout, jstats = jspec.generate_speculative(jc, jp, jnp.asarray(prompt), max_new, max_len,
                                              **kw)
    tout, tstats = tspec.generate_speculative(tc, tp, torch.from_numpy(prompt), max_new,
                                              max_len, **kw)
    plain = teng.generate(tc, tp, torch.from_numpy(prompt), max_new, max_len)
    assert tout.dtype == torch.int32 and tout.shape == (1, max_new)
    return np.asarray(jout), jstats, tout.numpy(), tstats, plain.numpy()


NGRAM_CASES = [  # (history, k, max_ngram, JAX's expected draft or None)
    ([7, 8, 9, 5, 6, 11, 12, 13, 5, 6], 3, 2, [11, 12, 13]),  # finds the repeat
    ([5, 6, 1, 1, 5, 6, 2, 2, 5, 6], 2, 2, [2, 2]),  # the most recent match wins
    ([1, 2, 3, 4], 3, 3, None),  # no repeat: a degenerate draft
    ([5, 6, 9, 5, 6], 3, 2, [9, 5, 6]),  # the continuation may cover the suffix
    ([9, 5, 5, 5], 3, 2, [5, 5, 5]),  # a short continuation, padded
]


@pytest.mark.parametrize("case", range(len(NGRAM_CASES)))
def test_ngram_propose_matches_jax(case):
    h, k, n, want = NGRAM_CASES[case]
    got = tspec.ngram_propose(h, k, max_ngram=n)
    np.testing.assert_array_equal(got, jspec.ngram_propose(h, k, max_ngram=n))
    assert got.dtype == np.int32 and got.shape == (k,)
    if want is not None:
        assert list(got) == want


def test_device_ngram_matches_host_and_jax():
    """device_ngram_propose equals the host version where the continuation
    lies inside the valid region, and JAX's device version everywhere:
    random buffers of every length, so that matches near the buffer's end
    take dynamic_slice's clamp to L - k, and the no-match fallback."""
    cases = [c[0] for c in NGRAM_CASES[:2]] + [[5, 6, 9, 5, 6], [3, 5, 3, 5, 3, 5, 3, 5, 9, 3, 5]]
    for h in cases:
        buf = np.zeros(32, np.int32)
        buf[:len(h)] = h
        got = tspec.device_ngram_propose(torch.from_numpy(buf), torch.tensor(len(h)), 3, 2)
        np.testing.assert_array_equal(got.numpy(), tspec.ngram_propose(h, 3, max_ngram=2))
    rng = np.random.default_rng(0)
    L, clamped = 12, 0
    for trial in range(60):
        buf = rng.integers(0, 4, L).astype(np.int32)
        length = int(rng.integers(1, L + 1))
        k, n = int(rng.integers(1, 5)), int(rng.integers(1, 4))
        want = np.asarray(jspec.device_ngram_propose(jnp.asarray(buf), jnp.asarray(length), k, n))
        got = tspec.device_ngram_propose(torch.from_numpy(buf), torch.tensor(length), k, n)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{buf} {length} {k} {n}")
        # a match whose continuation starts past L - k reads the clamped slice
        host = tspec.ngram_propose(buf[:length], k, max_ngram=n)
        clamped += not np.array_equal(got.numpy(), host)
    assert clamped > 0  # the clamp (or stale tokens past the length) was exercised
    # the continuation of the match at 6 starts at 7, past L - k = 4: the
    # slice is clamped to buf[4:8], where the host version pads [9, 9, 9, 9]
    buf = np.asarray([1, 2, 3, 4, 5, 6, 9, 9], np.int32)
    got = tspec.device_ngram_propose(torch.from_numpy(buf), torch.tensor(8), 4, 1)
    want = jspec.device_ngram_propose(jnp.asarray(buf), jnp.asarray(8, jnp.int32), 4, 1)
    assert got.tolist() == np.asarray(want).tolist() == [5, 6, 9, 9]
    assert list(tspec.ngram_propose(buf, 4, max_ngram=1)) == [9, 9, 9, 9]
    fallback = tspec.device_ngram_propose(torch.tensor([1, 2, 3, 4] + [0] * 12, dtype=torch.int32),
                                          torch.tensor(4), 3, 3)
    assert fallback.shape == (3,)
    # the batched form used by the batcher: one row per slot
    bufs = torch.from_numpy(rng.integers(0, 4, (5, L)).astype(np.int32))
    lens = torch.tensor([1, 4, 7, 11, 12], dtype=torch.int32)
    rows = tspec.ngram_rows(bufs, lens, 3, 3)
    for i in range(5):
        assert torch.equal(rows[i], tspec.device_ngram_propose(bufs[i], lens[i], 3, 3))


@pytest.mark.parametrize("quant_pv", [True, False])
@pytest.mark.parametrize("ondevice", [False, True])
def test_spec_generate_matches_jax(engines, quant_pv, ondevice):
    """A random prompt and a repetitive one (on which a random model loops
    and prompt lookup accepts drafts): the tokens equal JAX's and plain
    greedy decoding's, host loop or on-device chunks, quant_pv on or off."""
    kw = dict(spec_k=4, ondevice=ondevice, chunk_steps=4)
    prompts = [np.random.default_rng(0).integers(0, 128, (1, 16)).astype(np.int32),
               np.asarray([[3, 5, 3, 5, 3, 5, 3, 5]], np.int32)]
    for i, prompt in enumerate(prompts):
        jout, jstats, tout, tstats, plain = _both(engines, prompt, 28, 128, quant_pv, **kw)
        np.testing.assert_array_equal(tout, jout)
        np.testing.assert_array_equal(tout, plain)
        assert tstats == jstats
        if i == 1:
            assert tstats["tokens_per_step"] > 1.2, tstats


@pytest.mark.parametrize("ondevice,max_new,max_len", [(False, 12, 16), (True, 18, 24)])
def test_spec_generate_capacity_edge(engines, ondevice, max_new, max_len):
    """No room for a speculative window (host: 4 + 12 = 16 = max_len; on the
    device: no room for a chunk of 4 steps): plain steps give the exact
    output."""
    prompt = np.asarray([[3, 5, 3, 5]], np.int32)
    jout, jstats, tout, tstats, plain = _both(engines, prompt, max_new, max_len, spec_k=4,
                                              ondevice=ondevice, chunk_steps=4)
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tout, plain)
    assert tstats == jstats


def test_spec_verify_step_rollback_length(engines):
    """Garbage drafts: the emitted tokens are plain decode's, and the cache
    length covers prompt + tok + the accepted drafts, as JAX's."""
    (jp, tp), (jc, tc) = engines, _cfgs()
    prompt = np.asarray([[1, 2, 3, 4]], np.int32)
    jcache = jeng.init_kv_cache(CFG, 1, 64)
    logits, jcache = jeng.engine_forward(jc, jp, jnp.asarray(prompt), jcache)
    jtok = jnp.argmax(logits[:, -1:, :], -1).astype(jnp.int32)
    tcache = teng.init_kv_cache(TCFG, 1, 64, device="cpu")
    logits, tcache = teng.engine_forward(tc, tp, torch.from_numpy(prompt), tcache)
    ttok = torch.argmax(logits[:, -1:, :], -1).to(torch.int32)
    assert int(ttok[0, 0]) == int(jtok[0, 0])
    drafts = (int(ttok[0, 0]) + 1 + np.arange(4, dtype=np.int32))[None, :] % 128
    jo, jn, jnext, jc2 = jspec.spec_verify_step(jc, jp, jtok, jnp.asarray(drafts), jcache)
    to, tn, tnext, tc2 = tspec.spec_verify_step(tc, tp, ttok, torch.from_numpy(drafts), tcache)
    n = int(tn)
    assert n == int(jn) and 1 <= n <= 5 and int(tnext[0, 0]) == int(jnext[0, 0])
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert int(tc2.length) == int(jc2.length) == 4 + n
    ref = teng.generate(tc, tp, torch.from_numpy(prompt), n + 1, 64)
    np.testing.assert_array_equal(ref[0, 1:n + 1].numpy(), to[0, :n].numpy())


def test_draft_model_self_and_bad_draft(engines):
    """The target as its own draft accepts every draft (5 tokens a step at K
    = 4); a different random model drafts badly; both give JAX's tokens and
    plain greedy decoding's."""
    (jp, tp), (jc, tc) = engines, _cfgs()
    jbad, tbad = _pair(99)
    for seed, (jd, td), fast in ((1, (jp, tp), True), (2, (jbad, tbad), False)):
        prompt = np.random.default_rng(seed).integers(0, 128, (1, 12)).astype(np.int32)
        jout, jstats = jspec.generate_speculative(jc, jp, jnp.asarray(prompt), 20, 128,
                                                  spec_k=4, draft=(jc, jd))
        tout, tstats = tspec.generate_speculative(tc, tp, torch.from_numpy(prompt), 20, 128,
                                                  spec_k=4, draft=(tc, td))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(
            tout.numpy(), teng.generate(tc, tp, torch.from_numpy(prompt), 20, 128).numpy())
        assert tstats == jstats
        if fast:
            assert tstats["tokens_per_step"] > 4.0, tstats
    with pytest.raises(ValueError, match="host-loop only"):
        tspec.generate_speculative(tc, tp, torch.from_numpy(prompt), 4, 64, draft=(tc, tp),
                                   ondevice=True)


def _opt_pair(tmp_path):
    """A numpy-seeded OPT engine (span-only linears with biases) saved by
    JAX's save_engine and loaded by the port's load_engine."""
    from dgq_tpu.models import opt_engine as jopt
    from dgq_tpu.models.opt import tiny_opt_config
    from dgq_tpu.utils import checkpoint as jck
    from dgq_tpu_torch.utils import checkpoint as tck

    cfg = tiny_opt_config(hidden_size=256, ffn_dim=512, num_attention_heads=4, vocab_size=256)
    rng = np.random.default_rng(7)
    d, f, nl, gs = cfg.hidden_size, cfg.ffn_dim, cfg.num_hidden_layers, 64

    def lin(prefix, n_out, n_in, alpha, bias):
        return {f"{prefix}/qweight": rng.integers(-128, 128, (nl, n_in // 2, n_out)).astype(
                    np.int8),
                f"{prefix}/wscales": np.repeat(rng.integers(1, 4, (nl, n_in // gs, n_out)), 8,
                                               axis=1).astype(np.int8),
                f"{prefix}/wzeros": np.repeat(rng.integers(4, 12, (nl, n_in // gs, n_out)), 8,
                                              axis=1).astype(np.int8),
                f"{prefix}/alpha": rng.uniform(alpha / 2, 2 * alpha, (nl, n_out)).astype(
                    np.float32),
                f"{prefix}/bias": (rng.normal(size=(nl, n_out)) * bias).astype(np.float32)}

    arrays = {"embed_tokens": rng.normal(size=(cfg.vocab_size, d)).astype(np.float32),
              "embed_positions": rng.normal(size=(cfg.max_position_embeddings + 2, d)).astype(
                  np.float32),
              "final_ln_weight": np.ones((d,), np.float32),
              "final_ln_bias": np.zeros((d,), np.float32),
              "lm_head": (rng.normal(size=(cfg.vocab_size, d)) * 0.5).astype(np.float32)}
    for name in ("ln1", "ln2"):
        arrays[f"layers/{name}_weight"] = rng.uniform(8, 12, (nl, d)).astype(np.float32)
        arrays[f"layers/{name}_bias"] = rng.uniform(-2, 2, (nl, d)).astype(np.float32)
    arrays.update(lin("layers/qkv_proj", 3 * d, d, 1e-2, 3.0))
    arrays.update(lin("layers/out_proj", d, d, 1e-4, 0.1))
    arrays.update(lin("layers/fc1", f, d, 1e-4, 0.1))
    arrays.update(lin("layers/fc2", d, f, 1e-4, 0.1))
    for name in ("q_scale", "k_scale", "v_scale", "out_input_scale", "fc2_input_scale"):
        arrays[f"layers/{name}"] = rng.uniform(0.04, 0.06, (nl,)).astype(np.float32)
    j = jck._rebuild_namedtuple(jopt.OPTEngineParams,
                                {k: jnp.asarray(v) for k, v in arrays.items()})
    path = str(tmp_path / "opt.safetensors")
    jck.save_engine(path, j, cfg, arch="opt")
    t, tcfg = tck.load_engine(path, device="cpu")
    return cfg, j, tcfg, t


@pytest.mark.parametrize("ondevice", [False, True])
def test_spec_generate_family_generic_opt(tmp_path, ondevice):
    """OPT through forward_fn/init_cache_fn: JAX's tokens, and the port's
    plain greedy decoding through the same forward."""
    from dgq_tpu.models import opt_engine as jopt
    from dgq_tpu_torch.models import opt_engine as topt

    cfg, j, tcfg, t = _opt_pair(tmp_path)
    jc, tc = jopt.OPTEngineConfig(cfg=cfg, use_kernel=False), topt.OPTEngineConfig(cfg=tcfg)
    prompt = np.asarray([[3, 5, 3, 5, 3, 5]], np.int32)
    kw = dict(spec_k=3, ondevice=ondevice, chunk_steps=2)
    jout, jstats = jspec.generate_speculative(
        jc, j, jnp.asarray(prompt), 16, 64, forward_fn=jopt.opt_engine_forward,
        init_cache_fn=lambda c, b, m: jopt.init_opt_kv_cache(c, b, m), **kw)
    tout, tstats = tspec.generate_speculative(
        tc, t, torch.from_numpy(prompt), 16, 64, forward_fn=topt.opt_engine_forward,
        init_cache_fn=lambda c, b, m: topt.init_opt_kv_cache(c, b, m, device="cpu"), **kw)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tstats == jstats and tstats["tokens"] == 16
    cache = topt.init_opt_kv_cache(tcfg, 1, 64, device="cpu")
    logits, cache = topt.opt_engine_forward(tc, t, torch.from_numpy(prompt), cache)
    ref = []
    for _ in range(16):
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        ref.append(int(tok))
        logits, cache = topt.opt_engine_forward(tc, t, tok, cache)
    assert tout[0].tolist() == ref
