"""The dgq_tpu_torch paged serving path held against dgq_tpu's on the CPU.

K7's and K8's plain versions against the Pallas kernels in interpret mode
and JAX's plain versions; the paged device functions against JAX's plain
path (use_kernel=False); and the engine's forced chunked decode against
JAX's interpret-mode K7.  The PagedBatcher is held against JAX's in
tests/test_torch_paged_batcher.py.  Weights come from dgq_tpu's synthetic
builder and are carried across with engine_params_from_arrays; inputs are
numpy-seeded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.models import engine as jeng
from dgq_tpu.models.llama import tiny_llama_config
from dgq_tpu.models.synthetic import build_llama_engine
from dgq_tpu.ops import attention as jat
from dgq_tpu.serving import paged as jpaged
from dgq_tpu_torch.models import engine as teng
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops import attention as tat
from dgq_tpu_torch.serving import paged as tpaged
from dgq_tpu_torch.utils.checkpoint import engine_params_from_arrays

CFG = tiny_llama_config(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2)
TCFG = LlamaConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
JCFG = jeng.EngineConfig(cfg=CFG, use_kernel=False)


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


def _scales():
    return 0.01, 0.02, 0.03


# -- K8 and K7: the plain versions against JAX ---------------------------------


@pytest.mark.parametrize("hk", [4, 2])  # MHA, GQA 2:1
@pytest.mark.parametrize("quant_pv", [True, False])
def test_paged_attention_plain_matches_jax(hk, quant_pv):
    """K8's plain version == JAX's Pallas kernel (interpret) and JAX's plain
    version, with null-page table entries and lengths crossing pages."""
    rng = np.random.default_rng(hk + 10 * quant_pv)
    b, h, dh, ps, npg, p = 3, 4, 64, 16, 4, 16
    q = rng.integers(-127, 128, (b, h, dh)).astype(np.int8)
    kt_pool = rng.integers(-127, 128, (p, hk, dh, ps)).astype(np.int8)
    v_pool = rng.integers(-127, 128, (p, hk, ps, dh)).astype(np.int8)
    table = np.asarray([[3, 7, 0, 0], [1, 2, 9, 0], [11, 4, 5, 6]], np.int32)
    lengths = np.asarray([17, 40, 64], np.int32)
    qs, ks, vs = _scales()
    jargs = [jnp.asarray(a) for a in (q, kt_pool, v_pool, table, lengths)]
    jsc = [jnp.float32(x) for x in (qs, ks, vs)]
    ref_k = np.asarray(jat.int8_paged_decode_attention(*jargs, *jsc, interpret=True,
                                                       quant_pv=quant_pv))
    ref_x = np.asarray(jat.int8_paged_decode_attention_xla(*jargs, *jsc, quant_pv=quant_pv))
    _cuda.reset_launches()
    targs = [torch.from_numpy(a) for a in (q, kt_pool, v_pool, table, lengths)]
    tsc = [torch.tensor(x, dtype=torch.float32) for x in (qs, ks, vs)]
    got = tat.int8_paged_decode_attention(*targs, *tsc, quant_pv=quant_pv).numpy()
    assert _cuda.LAUNCHES[tat.PAGED] == 0
    np.testing.assert_allclose(got, ref_k, atol=1e-4)
    np.testing.assert_allclose(got, ref_x, atol=1e-5)
    np.testing.assert_allclose(
        tat.int8_paged_decode_attention_xla(*targs, *tsc, quant_pv=quant_pv).numpy(), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("quant_pv", [True, False])
def test_chunked_attention_plain_matches_jax(quant_pv):
    """K7's plain version (the dense decode attention) == JAX's chunked
    Pallas kernel in interpret mode, chunk 128 at Smax 512."""
    rng = np.random.default_rng(20 + quant_pv)
    b, h, hk, dh, smax = 2, 4, 2, 64, 512
    q = rng.integers(-127, 128, (b, h, dh)).astype(np.int8)
    kt = rng.integers(-127, 128, (b, hk, dh, smax)).astype(np.int8)
    v = rng.integers(-127, 128, (b, hk, smax, dh)).astype(np.int8)
    lengths = np.asarray([200, 512], np.int32)
    qs, ks, vs = _scales()
    ref = np.asarray(jat.int8_decode_attention_chunked(
        *[jnp.asarray(a) for a in (q, kt, v, lengths)], *[jnp.float32(x) for x in (qs, ks, vs)],
        chunk=128, interpret=True, quant_pv=quant_pv))
    _cuda.reset_launches()
    got = tat.int8_decode_attention_chunked(
        *[torch.from_numpy(a) for a in (q, kt, v, lengths)],
        *[torch.tensor(x, dtype=torch.float32) for x in (qs, ks, vs)], chunk=128,
        quant_pv=quant_pv).numpy()
    assert _cuda.LAUNCHES[tat.CHUNKED] == 0
    np.testing.assert_allclose(got, ref, atol=1e-4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tat.int8_decode_attention_chunked(torch.from_numpy(q), torch.from_numpy(kt),
                                          torch.from_numpy(v), 5, *[torch.tensor(0.1)] * 3,
                                          chunk=384)


# -- the paged device functions against JAX's plain path -----------------------


def _assert_pool_close(got, ref):
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert np.mean(diff == 0) >= 0.999


def test_paged_device_functions_match_jax(engines):
    """paged_prefill, paged_prefill_chunk (two chunks) and two
    paged_decode_batched steps == JAX's (use_kernel=False): logits and the
    whole pool, and the lengths."""
    jparams, tparams = engines
    rng = np.random.default_rng(3)
    ps, npg, slots = 16, 4, 3
    p1 = rng.integers(0, CFG.vocab_size, 20).astype(np.int32)  # slot 1: 2 pages
    p2 = rng.integers(0, CFG.vocab_size, 23).astype(np.int32)  # slot 2: chunks of 16
    table = np.zeros((slots, npg), np.int32)
    table[1, :2] = [5, 9]
    table[2, :2] = [2, 6]
    buf1 = np.pad(p1, (0, 32 - len(p1)))
    chunks = [(np.asarray(p2[:16]), 0, 16), (np.pad(p2[16:], (0, 9)), 16, 7)]
    toks = np.asarray([[0, 7, 11], [0, 19, 23]], np.int32)
    active = np.asarray([False, True, True])

    jc = jpaged.init_paged_cache(CFG, slots, num_pages=1 + slots * npg, page_size=ps)
    jl = []
    out, jc = jpaged.paged_prefill(JCFG, jparams, jnp.int32(1), jnp.asarray(buf1),
                                   jnp.int32(len(p1)), jnp.asarray([5, 9], jnp.int32), jc)
    jl.append(np.asarray(out))
    for ids, start, valid in chunks:
        out, jc = jpaged.paged_prefill_chunk(JCFG, jparams, jnp.int32(2), jnp.asarray(ids),
                                             jnp.int32(start), jnp.int32(valid),
                                             jnp.asarray(table[2]), jc)
        jl.append(np.asarray(out))
    for t in toks:
        out, jc = jpaged.paged_decode_batched(JCFG, jparams, jnp.asarray(t), jc,
                                              jnp.asarray(table), jnp.asarray(active))
        jl.append(np.asarray(out))

    tcfg = teng.EngineConfig(cfg=TCFG)
    tc = tpaged.init_paged_cache(TCFG, slots, num_pages=1 + slots * npg, page_size=ps,
                                 device="cpu")
    tl = []
    out, tc = tpaged.paged_prefill(tcfg, tparams, 1, torch.from_numpy(buf1), len(p1), [5, 9], tc)
    tl.append(out.numpy())
    for ids, start, valid in chunks:
        out, tc = tpaged.paged_prefill_chunk(tcfg, tparams, 2, torch.from_numpy(ids), start,
                                             valid, table[2], tc)
        tl.append(out.numpy())
    for t in toks:
        out, tc = tpaged.paged_decode_batched(tcfg, tparams, torch.from_numpy(t), tc,
                                              torch.from_numpy(table), torch.from_numpy(active))
        tl.append(out.numpy())

    for got, ref in zip(tl, jl):
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    _assert_pool_close(tc.kt.numpy(), np.asarray(jc.kt))
    _assert_pool_close(tc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    assert tc.lengths.tolist() == [0, 22, 25]


def test_engine_forced_chunk_matches_jax(engines):
    """``decode_attn_chunk=128`` at Smax 512 (K7's plain version on the CPU)
    == JAX's interpret-mode chunked kernel path."""
    jparams, tparams = engines
    smax, steps = 512, 4
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, CFG.vocab_size, (2, 12)).astype(np.int32)
    cols = rng.integers(0, CFG.vocab_size, (2, steps)).astype(np.int32)
    jcfg = jeng.EngineConfig(cfg=CFG, use_kernel=True, interpret=True, decode_attn_chunk=128,
                             bm_prefill=128, bm_decode=128)
    jc = jeng.init_kv_cache(CFG, 2, smax)
    tcfg = teng.EngineConfig(cfg=TCFG, decode_attn_chunk=128)
    tc = teng.init_kv_cache(TCFG, 2, smax, device="cpu")
    jl, jc = jeng.engine_forward(jcfg, jparams, jnp.asarray(prompt), jc)
    tl, tc = teng.engine_forward(tcfg, tparams, torch.from_numpy(prompt), tc)
    _cuda.reset_launches()
    for i in range(steps):
        jl, jc = jeng.engine_forward(jcfg, jparams, jnp.asarray(cols[:, i:i + 1]), jc)
        tl, tc = teng.engine_forward(tcfg, tparams, torch.from_numpy(cols[:, i:i + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3, atol=2e-3)
    assert _cuda.LAUNCHES[tat.CHUNKED] == 0  # CPU tensors: the plain version
