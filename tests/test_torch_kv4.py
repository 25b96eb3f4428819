"""INT4 KV of dgq_tpu_torch held against dgq_tpu's on the CPU.

The nibble packing and quantisation byte for byte; K11's plain version
against JAX's Pallas kernel in interpret mode and JAX's plain paged
attention on the unpacked pool; the ``kv_bits=4`` engine (prefill, fused and
unfused decode) against JAX's plain path; and the PagedBatcher on nibble
pages against JAX's.  Weights come from dgq_tpu's synthetic builder and are
carried across with engine_params_from_arrays; inputs are numpy-seeded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.models import engine as jeng
from dgq_tpu.models.llama import tiny_llama_config
from dgq_tpu.models.synthetic import build_llama_engine
from dgq_tpu.ops import attention as jat
from dgq_tpu.ops import kv4 as jkv4
from dgq_tpu.serving import paged as jpaged
from dgq_tpu.serving.scheduler import Request as JRequest
from dgq_tpu_torch.models import engine as teng
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops import attention as tat
from dgq_tpu_torch.ops import kv4 as tkv4
from dgq_tpu_torch.serving import paged as tpaged
from dgq_tpu_torch.serving.scheduler import Request
from dgq_tpu_torch.utils.checkpoint import engine_params_from_arrays

CFG = tiny_llama_config(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2)
TCFG = LlamaConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
JCFG4 = jeng.EngineConfig(cfg=CFG, use_kernel=False, kv_bits=4)
SMAX, STEPS = 64, 8


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


# -- packing ----------------------------------------------------------------------


@pytest.mark.parametrize("axis", [-1, 2, 1, 0])
def test_kv4_packing_matches_jax(axis):
    """quantize_kv4, pack_nibbles and unpack_nibbles byte-equal to JAX's."""
    rng = np.random.default_rng(axis + 7)
    x = (rng.normal(size=(2, 4, 6, 8)) * 0.6).astype(np.float32)
    scale8 = np.float32(0.011)
    j4 = jkv4.quantize_kv4(jnp.asarray(x), jnp.float32(scale8))
    t4 = tkv4.quantize_kv4(torch.from_numpy(x), torch.tensor(scale8))
    assert t4.dtype == torch.int8 and int(t4.abs().max()) == 7
    np.testing.assert_array_equal(t4.numpy(), np.asarray(j4))
    jp = np.asarray(jkv4.pack_nibbles(j4, axis=axis))
    tp = tkv4.pack_nibbles(t4, axis=axis)
    assert tp.dtype == torch.int8
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tkv4.unpack_nibbles(tp, axis=axis).numpy(),
                                  np.asarray(jkv4.unpack_nibbles(jnp.asarray(jp), axis=axis)))
    np.testing.assert_array_equal(tkv4.unpack_nibbles(tp, axis=axis).numpy(), t4.numpy())
    assert float(tkv4.kv4_scale(torch.tensor(scale8))) == float(
        jnp.float32(scale8) * jkv4.KV4_RATIO)


# -- K11: the plain version against JAX -------------------------------------------


@pytest.mark.parametrize("hk", [4, 2])  # MHA, GQA 2:1
def test_int4_paged_attention_plain_matches_jax(hk):
    """K11's plain version within 1e-5 of the largest |output| of JAX's
    Pallas kernel (interpret) and of JAX's plain paged attention on the
    unpacked pool, with null-page table entries and lengths 1, ps, ps + 1."""
    rng = np.random.default_rng(hk)
    b, h, dh, ps, npg, p = 4, 4, 64, 16, 4, 16
    q = rng.integers(-127, 128, (b, h, dh)).astype(np.int8)
    kt_pool = rng.integers(-128, 128, (p, hk, dh // 2, ps)).astype(np.int8)
    v_pool = rng.integers(-128, 128, (p, hk, ps, dh // 2)).astype(np.int8)
    table = np.asarray([[3, 0, 0, 0], [7, 0, 0, 0], [1, 2, 0, 0], [11, 4, 5, 6]], np.int32)
    lengths = np.asarray([1, ps, ps + 1, 61], np.int32)
    qs, ks4, vs4 = np.float32(0.01), np.float32(0.3), np.float32(0.4)
    jargs = [jnp.asarray(a) for a in (q, kt_pool, v_pool, table, lengths)]
    jsc = [jnp.float32(x) for x in (qs, ks4, vs4)]
    ref_k = np.asarray(jat.int4_paged_decode_attention(*jargs, *jsc, interpret=True))
    ref_x = np.asarray(jat.int8_paged_decode_attention_xla(
        jargs[0], jkv4.unpack_nibbles(jargs[1], axis=2), jkv4.unpack_nibbles(jargs[2], axis=-1),
        *jargs[3:], *jsc))
    _cuda.reset_launches()
    targs = [torch.from_numpy(a) for a in (q, kt_pool, v_pool, table, lengths)]
    tsc = [torch.tensor(x) for x in (qs, ks4, vs4)]
    got = tat.int4_paged_decode_attention(*targs, *tsc).numpy()
    assert _cuda.LAUNCHES[tat.PAGED_KV4] == 0
    tol = 1e-5 * np.abs(ref_x).max()
    np.testing.assert_allclose(got, ref_x, rtol=0, atol=tol)
    np.testing.assert_allclose(got, ref_k, rtol=0, atol=tol)
    # the same codes as an unpacked INT8 pool through K8's plain version
    k8 = tat.int8_paged_decode_attention_xla(
        targs[0], tkv4.unpack_nibbles(targs[1], axis=2), tkv4.unpack_nibbles(targs[2], axis=-1),
        *targs[3:], *tsc, quant_pv=False)
    np.testing.assert_array_equal(got, k8.numpy())


# -- the kv_bits=4 engine ----------------------------------------------------------


def _unpacked(k, v):
    return (np.asarray(jkv4.unpack_nibbles(jnp.asarray(k), axis=3)),
            np.asarray(jkv4.unpack_nibbles(jnp.asarray(v), axis=-1)))


def _assert_codes_close(got, ref):
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert np.mean(diff == 0) >= 0.999


@pytest.mark.parametrize("fused", [True, False])
def test_kv4_engine_matches_jax(engines, fused):
    """Prefill and 8 teacher-forced decode steps on the packed cache: logits
    allclose to JAX's plain kv_bits=4 path, unpacked cache codes within 1
    and >= 99.9% equal; then 16 greedy tokens equal."""
    jparams, tparams = engines
    rng = np.random.default_rng(40 + fused)
    prompt = rng.integers(0, CFG.vocab_size, size=(2, 12)).astype(np.int32)
    steps = rng.integers(0, CFG.vocab_size, size=(2, STEPS)).astype(np.int32)
    jc = jeng.init_kv_cache(CFG, 2, SMAX, kv_bits=4)
    tcfg = teng.EngineConfig(cfg=TCFG, kv_bits=4, fused_decode=fused)
    tc = teng.init_kv_cache(TCFG, 2, SMAX, kv_bits=4, device="cpu")
    assert tc.k.shape == jc.k.shape == (2, 2, 2, CFG.head_dim // 2, SMAX)
    assert tc.v.shape == jc.v.shape
    _cuda.reset_launches()
    for i in range(STEPS + 1):
        ids = prompt if i == 0 else steps[:, i - 1:i]
        jl, jc = jeng.engine_forward(JCFG4, jparams, jnp.asarray(ids), jc)
        tl, tc = teng.engine_forward(tcfg, tparams, torch.from_numpy(ids), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3, atol=2e-3)
    for got, ref in zip(_unpacked(tc.k.numpy(), tc.v.numpy()), _unpacked(jc.k, jc.v)):
        _assert_codes_close(got, ref)
    assert all(n == 0 for n in _cuda.LAUNCHES.values())
    want = np.asarray(jeng.generate(JCFG4, jparams, jnp.asarray(prompt), 16, SMAX))
    got = teng.generate(tcfg, tparams, torch.from_numpy(prompt), 16, SMAX)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_bits_checked():
    with pytest.raises(ValueError, match="kv_bits must be 8 or 4"):
        teng.EngineConfig(cfg=TCFG, kv_bits=3)
    with pytest.raises(ValueError, match="kv_bits must be 8 or 4"):
        tpaged.init_paged_cache(TCFG, 1, 4, 16, kv_bits=2, device="cpu")


# -- the PagedBatcher on nibble pages ----------------------------------------------


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32) for n in lens]


def _run_paged(engines, prompts, max_new, prefix=None, **kw):
    """The same requests through JAX's and the port's kv_bits=4 PagedBatcher."""
    jparams, tparams = engines
    out = {}
    for name, b, req in (
        ("jax", jpaged.PagedBatcher(JCFG4, jparams, **kw), JRequest),
        ("port", tpaged.PagedBatcher(teng.EngineConfig(cfg=TCFG, kv_bits=4), tparams, **kw),
         Request),
    ):
        if prefix is not None:
            b.register_prefix(prefix)
        for i, p in enumerate(prompts):
            b.add_request(req(uid=i, prompt_ids=p.copy(), max_new_tokens=max_new))
        out[name] = (b, {r.uid: r.output_ids for r in b.run()})
    return out


def test_kv4_paged_batcher_matches_jax(engines):
    """Nibble pages with prefix sharing and 2-step decode windows: JAX's
    tokens, and half the INT8 pool's bytes per token."""
    prompts = _prompts(5, (6, 9, 12, 4))
    prefix = prompts[2][:8].copy()
    prompts.append(np.concatenate([prefix, [7, 7, 2]]).astype(np.int32))
    out = _run_paged(engines, prompts, 4, prefix=prefix, num_slots=2, max_len=32, page_size=8,
                     decode_steps=2)
    (jb, want), (tb, got) = out["jax"], out["port"]
    assert got == want, (got, want)
    assert tb.prefix_hits == jb.prefix_hits > 0
    assert tb.cache.kt.shape == jb.cache.kt.shape
    np.testing.assert_array_equal(tb.lengths_h, np.asarray(jb.lengths_h))

    tb8 = tpaged.PagedBatcher(teng.EngineConfig(cfg=TCFG), engines[1], num_slots=2, max_len=32,
                              page_size=8)
    assert tb.kv_bytes_per_token * 2 == tb8.kv_bytes_per_token
    assert tb.kv_bytes_per_token == jb.kv_bytes_per_token
    m = tb.metrics()
    assert m["kv_bits"] == 4 and m["kv_bytes_per_token"] == tb.kv_bytes_per_token
    assert m["tokens_per_hbm_gib"] == 2 * tb8.metrics()["tokens_per_hbm_gib"]


def test_kv4_paged_preemption_matches_jax(engines):
    """A pool of 4 usable pages for two requests preempts, finishes with
    JAX's tokens, and equals the unconstrained pool's."""
    prompts = _prompts(6, (9, 12))
    tight = _run_paged(engines, prompts, 6, num_slots=2, max_len=32, page_size=8, num_pages=5)
    (jb, want), (tb, got) = tight["jax"], tight["port"]
    assert got == want, (got, want)
    assert tb.preemptions == jb.preemptions > 0
    free = tpaged.PagedBatcher(teng.EngineConfig(cfg=TCFG, kv_bits=4), engines[1], num_slots=2,
                               max_len=32, page_size=8)
    for i, p in enumerate(prompts):
        free.add_request(Request(uid=i, prompt_ids=p.copy(), max_new_tokens=6))
    assert {r.uid: r.output_ids for r in free.run()} == got
