"""The dgq_tpu_torch dense ContinuousBatcher held against dgq_tpu's on the CPU.

The same requests through JAX's ContinuousBatcher (use_kernel=False) and the
port's give the same greedy tokens: a queue longer than the slots,
multi-step decode windows, chunked prefill, batched admission, a registered
prefix, cancel, recovery from a failed step, INT4 KV and speculative
decoding; and the port's
dense INT4 batcher gives its own paged INT4 batcher's tokens, as JAX's
tests/test_kv4.py asserts for JAX's.  Weights come from dgq_tpu's synthetic
builder and are carried across with engine_params_from_arrays; prompts are
numpy-seeded."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from dgq_tpu.models import engine as jeng
from dgq_tpu.models.llama import tiny_llama_config
from dgq_tpu.models.synthetic import build_llama_engine
from dgq_tpu.serving.scheduler import ContinuousBatcher as JBatcher
from dgq_tpu.serving.scheduler import Request as JRequest
from dgq_tpu_torch.models import engine as teng
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.serving import batch_engine as tbatch
from dgq_tpu_torch.serving import paged as tpaged
from dgq_tpu_torch.serving import scheduler as tsched
from dgq_tpu_torch.serving.scheduler import ContinuousBatcher, Request
from dgq_tpu_torch.utils.checkpoint import engine_params_from_arrays

CFG = tiny_llama_config(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2)
TCFG = LlamaConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
MAX_LEN, PAD = 64, 8


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


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32) for n in lens]


def _port(tparams, kv_bits=8, **kw):
    return ContinuousBatcher(teng.EngineConfig(cfg=TCFG, kv_bits=kv_bits), tparams,
                             num_slots=kw.pop("num_slots", 2), max_len=kw.pop("max_len", MAX_LEN),
                             prefill_pad=PAD, **kw)


def _run_both(engines, prompts, max_new, prefix=None, kv_bits=8, setup=None, **kw):
    """The same requests through JAX's and the port's ContinuousBatcher."""
    jparams, tparams = engines
    out = {}
    for name, mk, req in (
        ("jax", lambda: JBatcher(jeng.EngineConfig(cfg=CFG, use_kernel=False, kv_bits=kv_bits),
                                 jparams, num_slots=kw.get("num_slots", 2), max_len=MAX_LEN,
                                 prefill_pad=PAD,
                                 **{k: v for k, v in kw.items() if k != "num_slots"}), JRequest),
        ("port", lambda: _port(tparams, kv_bits, **dict(kw)), Request),
    ):
        b = mk()
        if prefix is not None:
            b.register_prefix(prefix)
        for i, p in enumerate(prompts):
            b.add_request(req(uid=i, prompt_ids=p.copy(), max_new_tokens=max_new))
        if setup is not None:
            setup(name, b)
        out[name] = (b, {r.uid: r.output_ids for r in b.run()})
    return out


SCENARIOS = {
    # more requests than slots
    "queue": dict(lens=(6, 9, 4, 7, 12), max_new=5, kw={}),
    # windows of 4 greedy steps, clamped near the cache's end
    "decode_steps": dict(lens=(5, 30, 3), max_new=12, kw=dict(decode_steps=4)),
    # prompts past the chunk prefill one chunk per step beside decoding slots
    "chunked_prefill": dict(lens=(4, 22, 5, 17), max_new=5, kw=dict(num_slots=3,
                                                                     prefill_chunk=8)),
    # up to 3 short prompts in one batched prefill
    "admit_batch": dict(lens=(6, 9, 4, 13, 7), max_new=4, kw=dict(num_slots=3, admit_batch=3)),
    # INT4 KV with 2-step windows
    "kv4": dict(lens=(6, 9, 12, 4), max_new=5, kw=dict(decode_steps=2), kv_bits=4),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_batcher_matches_jax(engines, name):
    sc = SCENARIOS[name]
    out = _run_both(engines, _prompts(len(name), sc["lens"]), sc["max_new"],
                    kv_bits=sc.get("kv_bits", 8), **sc["kw"])
    (jb, want), (tb, got) = out["jax"], out["port"]
    assert got == want, (got, want)
    assert sorted(got) == list(range(len(sc["lens"])))
    assert tb.metrics()["requests_finished"] == jb.metrics()["requests_finished"]
    if name == "kv4":
        assert tb.cache.k.shape == jb.cache.k.shape
        assert tb.cache.k.shape[3] == CFG.head_dim // 2


def test_batcher_prefix_matches_jax(engines):
    """Prompts under a registered prefix start from its template (one with a
    remainder longer than the chunk goes through chunked prefill)."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, CFG.vocab_size, size=10).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, CFG.vocab_size, n).astype(np.int32)])
               for n in (3, 5, 14)] + _prompts(6, (7,))
    out = _run_both(engines, prompts, 4, prefix=prefix, prefill_chunk=8)
    (jb, want), (tb, got) = out["jax"], out["port"]
    assert got == want, (got, want)
    assert tb.prefix_hits == jb.prefix_hits == 3


def test_batcher_cancel_matches_jax(engines):
    """A cancel of a decoding request and of a queued one: both finish
    cancelled with what they had, and the others keep JAX's tokens."""
    prompts = _prompts(7, (6, 9, 5))

    def cancel(name, b):
        b.step()
        assert b.cancel(0) and b.cancel(2) and not b.cancel(9)

    out = _run_both(engines, prompts, 6, setup=cancel)
    (jb, want), (tb, got) = out["jax"], out["port"]
    assert got == want, (got, want)
    done = {r.uid: r for r in tb.finished}
    assert done[0].cancelled and done[2].cancelled and not done[1].cancelled
    assert len(got[0]) == 2 and got[2] == [] and len(got[1]) == 6  # prefill + one decode


def test_batcher_recovery_keeps_tokens(engines, monkeypatch):
    """An injected failure of the third decode call rebuilds the cache from
    host history; the tokens stay JAX's undisturbed tokens."""
    prompts = _prompts(8, (6, 11, 4))
    real = tsched.engine_decode_batched
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("device lost (injected)")
        return real(*a, **kw)

    def inject(name, b):
        if name == "port":
            monkeypatch.setattr(tsched, "engine_decode_batched", flaky)

    out = _run_both(engines, prompts, 6, setup=inject)
    tb, got = out["port"]
    assert calls["n"] > 3 and tb._recoveries == 1 == tb.metrics()["recoveries"]
    assert got == out["jax"][1]


def test_dense_kv4_matches_paged_kv4(engines):
    """INT4 KV: the dense batcher and the paged batcher give the same tokens,
    with prefix sharing and 2-step windows engaged (JAX's
    tests/test_kv4.py scenario)."""
    _, tparams = engines
    prompts = _prompts(5, (6, 9, 12, 4))
    prefix = prompts[2][:8].copy()
    prompts.append(np.concatenate([prefix, [7, 7, 2]]).astype(np.int32))
    ecfg = teng.EngineConfig(cfg=TCFG, kv_bits=4)
    runs = {}
    for name, b in (("dense", ContinuousBatcher(ecfg, tparams, num_slots=2, max_len=32,
                                                prefill_pad=8, decode_steps=2)),
                    ("paged", tpaged.PagedBatcher(ecfg, tparams, num_slots=2, max_len=32,
                                                  page_size=8, decode_steps=2))):
        if name == "paged":
            b.register_prefix(prefix)
        for i, p in enumerate(prompts):
            b.add_request(Request(uid=i, prompt_ids=p.copy(), max_new_tokens=4))
        runs[name] = {r.uid: r.output_ids for r in b.run()}
        if name == "paged":
            assert b.prefix_hits > 0
    assert runs["dense"] == runs["paged"]


def test_unported_options_raise(engines):
    # spec_k > 0 is ported: a speculative batcher gives JAX's tokens (the
    # scenarios are in tests/test_torch_serving_spec.py)
    prompts = [np.asarray([3, 5, 3, 5, 3, 5], np.int32), _prompts(9, (7,))[0]]
    out = _run_both(engines, prompts, 8, spec_k=2)
    (jb, want), (tb, got) = out["jax"], out["port"]
    assert got == want and tb.spec_k == 2 and tb.spec_stats == jb.spec_stats
    assert tb.spec_stats["steps"] > 0
    _, tparams = engines
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        _port(tparams, mesh=object())
    # fns is ported: the LLaMA functions handed in as a namespace give JAX's tokens (the
    # OPT, BLOOM and MPT namespaces are in tests/test_torch_family.py)
    fns = SimpleNamespace(**{name: getattr(tbatch, name) for name in (
        "engine_prefill_slot", "engine_prefill_chunk", "engine_decode_batched",
        "engine_decode_multi", "copy_prefix_into_slot", "init_batched_cache")})
    want = _run_both(engines, prompts, 8, decode_steps=2, prefill_chunk=8)["jax"][1]
    b = _port(tparams, fns=fns, decode_steps=2, prefill_chunk=8)
    for i, p in enumerate(prompts):
        b.add_request(Request(uid=i, prompt_ids=p.copy(), max_new_tokens=8))
    assert {r.uid: r.output_ids for r in b.run()} == want and b._f is fns
    with pytest.raises(ValueError, match="does not fit"):
        _port(tparams).add_request(Request(uid=0, prompt_ids=np.zeros(64, np.int32),
                                           max_new_tokens=2))


def test_prefix_chunk_at_cache_end(engines):
    """A prefix remainder prefilled in chunks from an unaligned position runs
    past the cache (prefix 5, prompt 60, chunk 16, max_len 64): the port cuts
    the last chunk at the cache end (only padding lies beyond) and gives the
    tokens of the prompt without the prefix, which are JAX's.  (JAX's
    dynamic_update_slice moves that chunk's write back instead and gives
    other tokens; ROADMAP Queue 3.)"""
    jparams, tparams = engines
    prompt = np.random.default_rng(3).integers(0, CFG.vocab_size, 60).astype(np.int32)
    ref = JBatcher(jeng.EngineConfig(cfg=CFG, use_kernel=False), jparams, num_slots=1,
                   max_len=MAX_LEN, prefill_pad=PAD, prefill_chunk=16)
    ref.add_request(JRequest(uid=0, prompt_ids=prompt.copy(), max_new_tokens=3))
    want = ref.run()[0].output_ids
    got = []
    for prefix in (None, prompt[:5]):
        b = _port(tparams, num_slots=1, prefill_chunk=16)
        if prefix is not None:
            b.register_prefix(prefix)
        b.add_request(Request(uid=0, prompt_ids=prompt.copy(), max_new_tokens=3))
        got.append(b.run()[0].output_ids)
    assert got == [want, want]


def test_prefix_chunk_ending_short_of_padding(engines):
    """A prefix remainder chunked from a prefix length off the chunk grid
    reaches the prompt's end before the padded end (prefix 20, chunk 32, a
    70-token prompt: chunks end at 52, 84; padded to 96): the walk stops
    there and gives the tokens of the prompt without the prefix, which are
    JAX's.  (JAX's walk goes on to a chunk with no real token and fails its
    assert; ROADMAP Queue 3.)"""
    jparams, tparams = engines
    prompt = np.random.default_rng(1).integers(0, CFG.vocab_size, 70).astype(np.int32)
    ref = JBatcher(jeng.EngineConfig(cfg=CFG, use_kernel=False), jparams, num_slots=1,
                   max_len=MAX_LEN * 2, prefill_pad=PAD, prefill_chunk=32)
    ref.add_request(JRequest(uid=0, prompt_ids=prompt.copy(), max_new_tokens=3))
    want = ref.run()[0].output_ids
    got = []
    for prefix in (None, prompt[:20]):
        b = _port(tparams, num_slots=1, prefill_chunk=32, max_len=MAX_LEN * 2)
        if prefix is not None:
            b.register_prefix(prefix)
        b.add_request(Request(uid=0, prompt_ids=prompt.copy(), max_new_tokens=3))
        got.append(b.run()[0].output_ids)
        assert b._recoveries == 0
    assert got == [want, want]
