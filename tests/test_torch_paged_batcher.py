"""The dgq_tpu_torch PagedBatcher held against dgq_tpu's on the CPU.

The port's PagedBatcher against JAX's on the scenarios of tests/test_paged.py
(a queue, multi-step decode, preemption, chunked prefill, prefix sharing,
cancel and recovery) and against its own ``generate``.  Weights come from
dgq_tpu's synthetic builder and are carried across with
engine_params_from_arrays; prompts are numpy-seeded."""

import jax
import numpy as np
import pytest
import torch

from dgq_tpu.models import engine as jeng
from dgq_tpu.models.llama import tiny_llama_config
from dgq_tpu.models.synthetic import build_llama_engine
from dgq_tpu.serving import paged as jpaged
from dgq_tpu.serving.scheduler import Request as JRequest
from dgq_tpu_torch.models import engine as teng
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.serving import paged as tpaged
from dgq_tpu_torch.serving.scheduler import Request
from dgq_tpu_torch.utils.checkpoint import engine_params_from_arrays

CFG = tiny_llama_config(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2)
TCFG = LlamaConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
JCFG = jeng.EngineConfig(cfg=CFG, use_kernel=False)
PS, MAX_LEN = 8, 64


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


# -- the batcher -----------------------------------------------------------------


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32) for n in lens]


def _run_both(engines, prompts, max_new, prefix=None, setup=None, **kw):
    """Run the same requests through JAX's and the port's PagedBatcher."""
    jparams, tparams = engines
    out = {}
    for name, mk, req in (
        ("jax", lambda: jpaged.PagedBatcher(JCFG, jparams, **kw), JRequest),
        ("port", lambda: tpaged.PagedBatcher(teng.EngineConfig(cfg=TCFG), tparams, **kw),
         Request),
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
    "queue": dict(lens=(6, 9, 4, 7), max_new=4, kw=dict(num_slots=2, max_len=32)),
    "decode_steps": dict(lens=(5, 7, 3), max_new=6, kw=dict(num_slots=2, decode_steps=4)),
    # 5 usable pages of 8 for two sequences that peak at 6 pages
    "preemption": dict(lens=(14, 10), max_new=10, kw=dict(num_slots=2, num_pages=6)),
    "chunked_prefill": dict(lens=(4, 22, 5), max_new=5, kw=dict(num_slots=3,
                                                                  prefill_chunk=8)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_batcher_matches_jax(engines, name):
    sc = SCENARIOS[name]
    kw = {"page_size": PS, "max_len": MAX_LEN, **sc["kw"]}
    out = _run_both(engines, _prompts(len(name), sc["lens"]), sc["max_new"], **kw)
    (jb, want), (tb, got) = out["jax"], out["port"]
    assert got == want, (got, want)
    assert tb.pages_in_use() == jb.pages_in_use() == 0
    assert tb.preemptions == jb.preemptions
    if name == "preemption":
        assert tb.preemptions >= 1


def test_batcher_prefix_sharing_matches_jax(engines):
    """Prefix-admitted requests share the prefix's full pages (refcounts as
    JAX's), copy the partial tail page, and emit JAX's tokens."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, CFG.vocab_size, size=12).astype(np.int32)  # 1.5 pages
    prompts = [np.concatenate([prefix, rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)])
               for n in (5, 3)]
    mid = {}

    def admit(name, b):
        b._admit()
        first = b._prefix[0]["pages"][0]
        mid[name] = (b.prefix_hits, int(b.refs[first]), b.table[:, :2].copy())

    out = _run_both(engines, prompts, 4, prefix=prefix, setup=admit, num_slots=2,
                    max_len=MAX_LEN, page_size=PS)
    assert out["port"][1] == out["jax"][1]
    hits, refs, table = mid["port"]
    assert (hits, refs) == (2, 3) == mid["jax"][:2]
    np.testing.assert_array_equal(table, mid["jax"][2])
    assert table[0, 1] != table[1, 1]  # the tail page is copied per slot
    tb = out["port"][0]
    assert tb.pages_in_use() == len(tb._prefix[0]["pages"])


def test_batcher_cancel_and_recovery_match_jax(engines, monkeypatch):
    """Cancel releases a decoding request's pages; an injected failure of
    the third decode step rebuilds the pool (prefix re-registered) and the
    tokens stay JAX's undisturbed tokens."""
    jparams, tparams = engines
    b = tpaged.PagedBatcher(teng.EngineConfig(cfg=TCFG), tparams, num_slots=2, max_len=32,
                            page_size=PS)
    p = np.arange(6, dtype=np.int32)
    r0 = Request(uid=0, prompt_ids=p, max_new_tokens=20)
    b.add_request(r0)
    b.step()
    assert b.pages_in_use() > 0 and r0.output_ids
    assert b.cancel(0) and r0.cancelled and b.pages_in_use() == 0 and not b.has_work
    b.add_request(Request(uid=1, prompt_ids=p, max_new_tokens=3))
    assert [r.uid for r in b.run()] == [0, 1] and b.pages_in_use() == 0

    rng = np.random.default_rng(31)
    prefix = rng.integers(0, CFG.vocab_size, size=10).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, CFG.vocab_size, 4).astype(np.int32)]),
               rng.integers(0, CFG.vocab_size, 7).astype(np.int32)]
    real = tpaged.paged_decode_batched
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("device lost (injected)")
        return real(*a, **kw)

    def inject(name, batcher):
        if name == "port":
            monkeypatch.setattr(tpaged, "paged_decode_batched", flaky)

    out = _run_both(engines, prompts, 6, prefix=prefix, setup=inject, num_slots=2,
                    max_len=MAX_LEN, page_size=PS)
    tb, got = out["port"]
    assert calls["n"] > 3 and tb._recoveries == 1
    assert got == out["jax"][1]
    assert tb.pages_in_use() == len(tb._prefix[0]["pages"])


def test_batcher_matches_own_generate(engines):
    """Each request's tokens from the port's batcher equal ``generate`` of
    that request alone: decode rows are independent of batch composition."""
    _, tparams = engines
    prompts = _prompts(8, (6, 13, 4, 21, 9))
    ecfg = teng.EngineConfig(cfg=TCFG)
    b = tpaged.PagedBatcher(ecfg, tparams, num_slots=3, max_len=MAX_LEN, page_size=PS)
    for i, p in enumerate(prompts):
        b.add_request(Request(uid=i, prompt_ids=p, max_new_tokens=8))
    got = {r.uid: r.output_ids for r in b.run()}
    for i, p in enumerate(prompts):
        alone = teng.generate(ecfg, tparams, torch.from_numpy(p[None]), 8, MAX_LEN)
        assert got[i] == alone[0].tolist(), i
