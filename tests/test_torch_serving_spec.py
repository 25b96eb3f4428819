"""Speculative decoding in dgq_tpu_torch's ContinuousBatcher (spec_k > 0)
held against dgq_tpu's on the CPU.

The scenarios of tests/test_serving_spec.py and
tests/test_path_consistency.py's test_speculative_bitwise_greedy and
test_serving_spec_matches_plain_serving, run through both packages' batchers on the same weights (JAX plain,
use_kernel=False; the port's default, the kernels' plain versions on CPU
tensors): the verify window against sequential decode steps, single
speculative steps and on-device windows (decode_steps > 1), EOS, a sampling
slot, the capacity edge, INT4 KV, the adaptive policy and the metrics.  The
port's tokens and speculation counts must equal JAX's, and its tokens those
of its own batcher without speculation."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.models import engine as jeng
from dgq_tpu.models.llama import tiny_llama_config
from dgq_tpu.models.synthetic import build_llama_engine
from dgq_tpu.serving import batch_engine as jbe
from dgq_tpu.serving.sampling import SamplingParams as JSamplingParams
from dgq_tpu.serving.scheduler import ContinuousBatcher as JBatcher
from dgq_tpu.serving.scheduler import Request as JRequest
from dgq_tpu_torch.models import engine as teng
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.serving import batch_engine as tbe
from dgq_tpu_torch.serving.sampling import SamplingParams
from dgq_tpu_torch.serving.scheduler import ContinuousBatcher, Request
from dgq_tpu_torch.utils.checkpoint import engine_params_from_arrays

CFG = tiny_llama_config(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2)
TCFG = LlamaConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
SYS = [9, 4, 2, 7, 1, 8, 3, 6]


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
    return j, engine_params_from_arrays(_jax_arrays(j), j.rms_eps, device="cpu")


def _run(engines, prompts, max_new, *, port=True, quant_pv=True, kv_bits=8, eos=None,
         sampling=None, **kw):
    """One batcher of either package over the requests -> (batcher, {uid:
    tokens}); ``sampling`` (uid -> temperature) makes those requests
    sample."""
    jp, tp = engines
    kw = {"num_slots": 3, "max_len": 64, "prefill_pad": 16, **kw}
    if port:
        b = ContinuousBatcher(teng.EngineConfig(cfg=TCFG, quant_pv=quant_pv, kv_bits=kv_bits),
                              tp, **kw)
        req, sp = Request, SamplingParams
    else:
        b = JBatcher(jeng.EngineConfig(cfg=CFG, use_kernel=False, quant_pv=quant_pv,
                                       kv_bits=kv_bits), jp, **kw)
        req, sp = JRequest, JSamplingParams
    for i, p in enumerate(prompts):
        temp = (sampling or {}).get(i)
        b.add_request(req(uid=i, prompt_ids=np.asarray(p, np.int32), max_new_tokens=max_new,
                          eos_token_id=eos,
                          sampling=None if temp is None else sp(temperature=temp)))
    return b, {r.uid: list(r.output_ids) for r in b.run()}


def test_verify_step_matches_sequential_decode(engines):
    """engine_verify_batched on [tok, d1, d2], the drafts being the true
    continuation, gives at position i the token that sequential decode
    steps give, and JAX's logits."""
    jp, tp = engines
    ecfg = teng.EngineConfig(cfg=TCFG)
    jcfg = jeng.EngineConfig(cfg=CFG, use_kernel=False)
    prompt = np.random.default_rng(3).integers(0, CFG.vocab_size, 8).astype(np.int32)
    padded = np.pad(prompt, (0, 8))
    cache = tbe.init_batched_cache(TCFG, 2, 64, device="cpu")
    logits, cache = tbe.engine_prefill_slot(ecfg, tp, 0, torch.from_numpy(padded), 8, cache)
    tok = int(torch.argmax(logits))
    seq = tbe.BatchedKVCache(cache.k.clone(), cache.v.clone(), cache.lengths.clone())
    seq_toks, cur = [], tok
    active = torch.tensor([True, False])
    for _ in range(3):
        lg, seq = tbe.engine_decode_batched(ecfg, tp, torch.tensor([cur, 0], dtype=torch.int32),
                                            seq, active)
        cur = int(torch.argmax(lg[0]))
        seq_toks.append(cur)
    ids = np.zeros((2, 3), np.int32)
    ids[0] = [tok, seq_toks[0], seq_toks[1]]
    lengths = cache.lengths.clone()
    vlogits, cache = tbe.engine_verify_batched(ecfg, tp, torch.from_numpy(ids), cache)
    assert torch.argmax(vlogits, dim=-1)[0].tolist() == seq_toks
    assert torch.equal(cache.lengths, lengths)  # the window leaves the lengths alone

    jcache = jbe.init_batched_cache(CFG, 2, 64)
    _, jcache = jbe.engine_prefill_slot(jcfg, jp, jnp.asarray(0, jnp.int32), jnp.asarray(padded),
                                        jnp.asarray(8, jnp.int32), jcache)
    jlogits, _ = jbe.engine_verify_batched(jcfg, jp, jnp.asarray(ids), jcache)
    np.testing.assert_allclose(vlogits.numpy(), np.asarray(jlogits), rtol=2e-3, atol=2e-3)


P1 = [3, 5, 3, 5, 3, 5, 3, 5]
P2 = [7, 7, 2, 7, 7, 2, 7, 7]
SCENARIOS = {
    # repetitive prompts, so that prompt lookup accepts drafts
    "spec": dict(prompts=[P1, P2], max_new=16, kw=dict(spec_k=3)),
    # decode_steps on-device speculative steps per call
    "spec_multi": dict(prompts=[P1, P2], max_new=16, kw=dict(spec_k=3, decode_steps=2)),
    # more requests than slots, under the conservative multi-step gate
    "spec_multi_queue": dict(prompts=[P1, P2, P1[:6], P2[:5], [1, 2, 3, 1, 2, 3]], max_new=10,
                             kw=dict(spec_k=2, decode_steps=3, num_slots=2)),
    # one slot at the cache's edge: speculation until 8 + 5 no longer fits
    "near_capacity": dict(prompts=[P1], max_new=12,
                          kw=dict(spec_k=4, num_slots=1, max_len=16, prefill_pad=8)),
    # INT4 KV: the verify window appends nibbles and keeps fp p @ V
    "kv4": dict(prompts=[P1, P2], max_new=12, kw=dict(spec_k=3, kv_bits=4)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_batcher_spec_matches_jax(engines, name):
    sc = SCENARIOS[name]
    kw = sc["kw"]
    tb, got = _run(engines, sc["prompts"], sc["max_new"], **kw)
    jb, want = _run(engines, sc["prompts"], sc["max_new"], port=False, **kw)
    _, plain = _run(engines, sc["prompts"], sc["max_new"],
                    **{k: v for k, v in kw.items() if k not in ("spec_k", "decode_steps")})
    assert got == want, (got, want)
    assert got == plain
    assert tb.spec_stats == jb.spec_stats
    assert tb.spec_stats["steps"] > 0
    if "multi" in name:  # decode_steps speculative steps in one call, one host read
        assert "dispatch:spec_multi" in tb.timings and "sync:spec_multi" in tb.timings
    if name in ("spec", "spec_multi"):
        # random tiny models loop: speculation accepts drafts
        assert tb.spec_stats["tokens"] > tb.spec_stats["steps"], tb.spec_stats


@pytest.mark.parametrize("kw", [dict(spec_k=3), dict(spec_k=3, decode_steps=3)])
def test_batcher_spec_eos(engines, kw):
    """EOS = the 5th plain token: the speculative run stops at the same place
    as JAX's and as the plain run."""
    p = [3, 5, 3, 5, 3, 5]
    _, plain = _run(engines, [p], 12)
    eos = plain[0][4]
    _, got = _run(engines, [p], 12, eos=eos, **kw)
    _, want = _run(engines, [p], 12, eos=eos, port=False, **kw)
    _, plain_eos = _run(engines, [p], 12, eos=eos)
    assert got == want == plain_eos
    assert got[0][-1] == eos


def test_batcher_spec_sampling_slot_falls_back(engines):
    """A sampling request keeps speculation off while it is live; the run
    completes and the greedy request keeps JAX's tokens."""
    p = [3, 5, 3, 5]
    tb, got = _run(engines, [p, p], 8, spec_k=3, num_slots=2, sampling={1: 0.9})
    _, want = _run(engines, [p, p], 8, spec_k=3, num_slots=2, sampling={1: 0.9}, port=False)
    assert all(len(t) == 8 for t in got.values())
    assert got[0] == want[0]
    assert tb.spec_stats["steps"] == 0


def test_batcher_metrics_match_jax(engines):
    p = [3, 5] * 3
    tb, _ = _run(engines, [p], 8, spec_k=3, num_slots=2)
    jb, _ = _run(engines, [p], 8, spec_k=3, num_slots=2, port=False)
    m, jm = tb.metrics(), jb.metrics()
    json.dumps(m)
    assert m["requests_finished"] == 1 and m["tokens_generated"] == 8
    assert m["slots_active"] == 0 and m["recoveries"] == 0
    assert m["spec_tokens_per_step"] >= 1.0
    spec = [k for k in jm if k.startswith("spec_")]
    assert spec and {k: m[k] for k in spec} == {k: jm[k] for k in spec}
    assert "dispatch:spec_verify" in m["dispatch_timings"]


def test_spec_adaptive_policy_matches_jax(engines):
    """Low-yield calls suspend speculation for spec_probe_every steps, then
    it re-probes with a fresh EWMA; high-yield calls never suspend: the same
    state as JAX's batcher after the same notes."""
    jp, tp = engines
    pairs = []
    for cls, ecfg, params in ((ContinuousBatcher, teng.EngineConfig(cfg=TCFG), tp),
                              (JBatcher, jeng.EngineConfig(cfg=CFG, use_kernel=False), jp)):
        b = cls(ecfg, params, num_slots=2, max_len=64, prefill_pad=16, spec_k=3,
                spec_cost_ratio=1.35, spec_probe_every=16)
        for _ in range(8):
            b._spec_note(tokens=2, steps=2)  # 1.0 token a step < 1.35
        assert b._spec_suspended == 16
        ticks = [b._spec_paying() for _ in range(17)]
        assert ticks == [False] * 16 + [True] and b._spec_ewma is None
        b2 = cls(ecfg, params, num_slots=2, max_len=64, prefill_pad=16, spec_k=3)
        for _ in range(32):
            b2._spec_note(tokens=4, steps=2)
        pairs.append((b._spec_suspensions, b2._spec_suspended, b2._spec_paying(),
                      round(b2._spec_ewma, 6)))
    assert pairs[0] == pairs[1]


def test_spec_adaptive_outputs_stay_exact(engines):
    """Random prompts (low acceptance) with a short probe period cross
    suspend/resume boundaries: the tokens stay JAX's and plain decoding's."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab_size, 12).astype(np.int32) for _ in range(3)]
    tb, got = _run(engines, prompts, 10, spec_k=3, spec_probe_every=4)
    jb, want = _run(engines, prompts, 10, spec_k=3, spec_probe_every=4, port=False)
    _, plain = _run(engines, prompts, 10)
    assert got == want == plain
    assert tb.spec_stats == jb.spec_stats and tb._spec_suspensions == jb._spec_suspensions


@pytest.mark.parametrize("quant_pv", [False, True])
def test_serving_spec_matches_plain_serving(engines, quant_pv):
    """spec_k = 3 serving gives the tokens of spec_k = 0 serving and of
    JAX's spec batcher, with quant_pv on and off (verify windows quantise p
    @ V exactly as decode steps do)."""
    prompts = [SYS + [3, 5, 3, 5], [1, 2, 3, 4, 1, 2, 3, 4]]
    kw = dict(num_slots=3, max_len=64, prefill_pad=8, quant_pv=quant_pv)
    _, plain = _run(engines, prompts, 10, **kw)
    _, spec = _run(engines, prompts, 10, spec_k=3, **kw)
    _, want = _run(engines, prompts, 10, spec_k=3, port=False, **kw)
    assert plain == spec == want


@pytest.mark.parametrize("quant_pv", [False, True])
def test_speculative_bitwise_greedy(engines, quant_pv):
    """generate_speculative's tokens equal plain greedy decoding's and JAX's
    speculative tokens, with quant_pv on and off (verify windows quantise p
    @ V as decode steps do)."""
    from dgq_tpu.serving.speculative import generate_speculative as jgen
    from dgq_tpu_torch.serving.speculative import generate_speculative

    jp, tp = engines
    jcfg = jeng.EngineConfig(cfg=CFG, use_kernel=False, quant_pv=quant_pv)
    tcfg = teng.EngineConfig(cfg=TCFG, quant_pv=quant_pv)
    prompt = np.asarray([[9, 4, 2, 7, 9, 4, 2, 7, 9, 4]], np.int32)
    got, stats = generate_speculative(tcfg, tp, torch.from_numpy(prompt), 12, 64, spec_k=3)
    want, jstats = jgen(jcfg, jp, jnp.asarray(prompt), 12, 64, spec_k=3)
    plain = teng.generate(tcfg, tp, torch.from_numpy(prompt), 12, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert stats == jstats
