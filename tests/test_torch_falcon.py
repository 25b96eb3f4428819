"""K3 and K7 at any number of query heads a kv head, and the Falcon engine
and its serving, held against dgq_tpu on the CPU.

* The plain K3 and K7 (what the wrappers run on CPU tensors) against JAX's
  ``int8_decode_attention`` and ``int8_decode_attention_chunked`` in
  interpret mode at 3, 6 and 71 query heads a kv head (Dh 64, Smax 256),
  both p @ V rules, within 1e-5 of the largest output.
* The split kernels' head map, emulated: a kv head's rep query heads served
  as ``decode_split(rep)`` (or each of ``chunked_splits(rep)``) virtual kv
  heads of ``virtual_rep`` rows over the same K and V, the last head's rows
  past its live ones given a zero q and not stored, each row's query head
  (its q row, its output row and its ALiBi slope) from the kernel's map
  ``(g / nv) rep + (g % nv) vrep + r``; held against JAX's K3 at rep 71 with
  and without ALiBi, both p @ V rules.  The plans at Falcon-7B's shapes.
* ``falcon_engine_forward``: prefill and decode logits within 1e-4 of
  JAX's on an engine made by JAX's ``ptq`` at tiny size with one kv head,
  carried over by ``falcon_engine_params_from_arrays``; its checkpoint both
  ways; ``family_batcher("falcon")`` against JAX's (chunked prefill, a
  prefix, ``decode_steps=4``): equal tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.config import ActQuantConfig, QuantConfig, WtQuantConfig
from dgq_tpu.models import falcon_engine as jfe
from dgq_tpu.models.falcon import init_falcon_params, tiny_falcon_config
from dgq_tpu.ops import attention as jatt
from dgq_tpu.quant.calibrate import ptq
from dgq_tpu.serving import family_batch_engine as jfam
from dgq_tpu.serving.scheduler import Request as JRequest
from dgq_tpu.utils import checkpoint as jck
from dgq_tpu.utils.datautils import synthetic_stream
from dgq_tpu_torch.models import falcon_engine as tfe
from dgq_tpu_torch.models.bloom import alibi_slopes
from dgq_tpu_torch.models.falcon import FalconConfig
from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops import attention as tatt
from dgq_tpu_torch.serving import family_batch_engine as tfam
from dgq_tpu_torch.serving.scheduler import Request
from dgq_tpu_torch.utils import checkpoint as tck

SMAX, CHUNK, DH = 256, 128, 64
LENGTHS = (SMAX, 37)
MAX_LEN, PAD = 64, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, rep, hk):
    r = np.random.default_rng(seed)
    b, h = len(LENGTHS), rep * hk
    q = r.integers(-127, 128, (b, h, DH)).astype(np.int8)
    kt = r.integers(-127, 128, (b, hk, DH, SMAX)).astype(np.int8)
    v = r.integers(-127, 128, (b, hk, SMAX, DH)).astype(np.int8)
    qs, ks, vs = (np.float32(x) for x in r.random(3) * 0.02 + 0.01)
    return q, kt, v, np.array(LENGTHS, np.int32), qs, ks, vs


def _jax_k3(q, kt, v, lengths, qs, ks, vs, quant_pv, slopes=None):
    return np.asarray(jatt.int8_decode_attention(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), jnp.asarray(lengths), jnp.asarray(qs),
        jnp.asarray(ks), jnp.asarray(vs), interpret=True, quant_pv=quant_pv,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes)))


def _torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
                 else torch.tensor(a) for a in arrays)


@pytest.mark.parametrize("quant_pv", [False, True])
@pytest.mark.parametrize("rep,hk", [(3, 2), (6, 2), (71, 1)])
def test_decode_any_rep_plain_matches_jax(rep, hk, quant_pv):
    """The plain K3 and K7 at a rep outside 1, 2, 4 and 8 against JAX's K3
    and chunked K7 in interpret mode (chunks of 128)."""
    arrays = _inputs(rep + 100 * quant_pv, rep, hk)
    ref = _jax_k3(*arrays, quant_pv)
    ref7 = np.asarray(jatt.int8_decode_attention_chunked(
        *(jnp.asarray(a) for a in arrays), chunk=CHUNK, interpret=True, quant_pv=quant_pv))
    _cuda.reset_launches()
    got = tatt.int8_decode_attention(*_torch(*arrays), quant_pv=quant_pv).numpy()
    got7 = tatt.int8_decode_attention_chunked(*_torch(*arrays), chunk=CHUNK,
                                              quant_pv=quant_pv).numpy()
    assert all(n == 0 for n in _cuda.LAUNCHES.values())  # CPU tensors: the plain versions
    largest = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * largest)
    np.testing.assert_allclose(got7, ref7, rtol=0, atol=1e-5 * largest)


def _head_map(rep, split):
    """The split kernels' map (``RaggedKV``): virtual head j of a kv head ->
    (first query head within the kv head, live rows), and the rows a head."""
    vrep = tatt.virtual_rep(rep, split)
    return [(j * vrep, min(vrep, rep - j * vrep)) for j in range(split)], vrep


def _split_emulated(q, kt, v, lengths, qs, ks, vs, quant_pv, split, slopes=None):
    """(B, H, Dh) f32 as the split kernels compute it: each virtual kv head
    runs the whole kernel's function on vrep query rows (its live rows' q,
    zeros past them; row r's slope that of query head h0 + min(r, live - 1))
    over its kv head's K and V; only the live rows are stored."""
    b, h, dh = q.shape
    hk = kt.shape[1]
    rep = h // hk
    heads, vrep = _head_map(rep, split)
    out = np.full((b, h, dh), np.nan, np.float32)
    for g in range(hk * split):
        kv, (first, live) = g // split, heads[g % split]
        h0 = kv * rep + first
        assert 1 <= live <= vrep
        qv = np.zeros((b, vrep, dh), np.int8)
        qv[:, :live] = q[:, h0:h0 + live]
        sl = None if slopes is None else torch.from_numpy(
            slopes[h0 + np.minimum(np.arange(vrep), live - 1)])
        o = tatt.int8_decode_attention_xla(
            torch.from_numpy(qv), torch.from_numpy(kt[:, kv:kv + 1]),
            torch.from_numpy(v[:, kv:kv + 1]), torch.from_numpy(lengths), torch.tensor(qs),
            torch.tensor(ks), torch.tensor(vs), quant_pv=quant_pv, alibi_slopes=sl).numpy()
        assert np.isfinite(o).all()  # the zero rows too
        assert np.isnan(out[:, h0:h0 + live]).all()  # each query head once
        out[:, h0:h0 + live] = o[:, :live]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("quant_pv", [False, True])
@pytest.mark.parametrize("alibi", [False, True])
def test_split_kernel_head_map_matches_jax(alibi, quant_pv):
    """Falcon-7B's 71 query heads on one kv head, at K3's split (9 heads of
    8, the last with 7 live rows) and at every split K7's plans take (18
    heads of 4, the last with 3): JAX's K3 within 1e-5 of the largest
    output, with ALiBi (slopes of 71 heads, scaled so that late positions
    win) and without."""
    rep = 71
    arrays = _inputs(7 + 10 * alibi + quant_pv, rep, 1)
    slopes = alibi_slopes(rep).numpy() * 8.0 if alibi else None
    ref = _jax_k3(*arrays, quant_pv, slopes)
    largest = np.abs(ref).max()
    assert tatt.decode_split(rep) == 9 and tatt.chunked_splits(rep) == [9, 18]
    for split in tatt.chunked_splits(rep):
        got = _split_emulated(*arrays, quant_pv, split, slopes)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * largest)
    if alibi:  # the slopes move the result: the map's slope index is held
        plain = _split_emulated(*arrays, quant_pv, 9)
        assert np.abs(plain - ref).max() > 1e-2 * largest


@pytest.mark.parametrize("rep", [1, 2, 3, 4, 6, 8, 12, 16, 71])
def test_split_plans_cover_every_query_head(rep):
    """decode_split, chunked_splits and virtual_rep: the whole kernels keep
    rep in DECODE_REPS (K3 unsplit, K7 at splits dividing rep); any other
    rep's virtual heads serve each query head once, none empty, at a REP the
    split kernels are compiled for; the plans fit a block at Falcon-7B's
    serving shape (8 slots, cache 2048) and at 16,384 positions."""
    split = tatt.decode_split(rep)
    if rep in tatt.DECODE_REPS:
        assert split == 1 and tatt.virtual_rep(rep, 1) == rep
        assert tatt.chunked_splits(rep) == [s for s in tatt.CHUNKED_SPLITS if rep % s == 0]
    for s in ([split] if rep in tatt.DECODE_REPS else tatt.chunked_splits(rep)):
        heads, vrep = _head_map(rep, s)
        assert rep in tatt.DECODE_REPS or vrep in tatt.SPLIT_REPS
        covered = [first + r for first, live in heads for r in range(live)]
        assert covered == list(range(rep)) and all(live >= 1 for _, live in heads)
    c = tatt.decode_plan(8, 1, rep, DH, 2048, 132)
    assert c in tatt.DECODE_CLUSTERS
    assert tatt.decode_smem_bytes(DH, tatt.virtual_rep(rep, split), 2048, c) \
        <= tatt.DECODE_SMEM_LIMIT
    plan = tatt.chunked_plan(4, 1, rep, DH, 16384, 132)
    assert plan in tatt.chunked_candidates(1, rep, DH, 16384)
    short = tatt.chunked_plan(8, 1, rep, DH, 2048, 132)
    assert short == tatt.ChunkedPlan(c, False, split)
    with pytest.raises(ValueError, match="do not serve"):
        tatt.virtual_rep(71, 8)


@pytest.fixture(scope="module")
def falcon(tmp_path_factory):
    """JAX's Falcon engine from ``ptq`` at tiny size (one kv head, groupsize
    32, as Falcon-7B's), its arrays under save_engine's names, the port's
    engine carried over from them, and JAX's save_engine file."""
    cfg = tiny_falcon_config(hidden_size=128, num_attention_heads=4, num_kv_heads=1)
    params = init_falcon_params(cfg, jax.random.PRNGKey(0))
    calib = jnp.asarray(synthetic_stream(cfg.vocab_size, 2 * 32).reshape(2, 32))
    qcfg = QuantConfig(act_quant=ActQuantConfig(), wt_quant=WtQuantConfig(groupsize=32),
                       smoothquant=True, kvquant=True)
    res = ptq(params, cfg, calib, qcfg, arch="falcon", verbose=False)
    j = jfe.from_ptq_falcon(res.params, res.kv_scales, cfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(j)
    arrays = {"/".join(k.name for k in path): np.asarray(leaf) for path, leaf in leaves}
    t = tck.falcon_engine_params_from_arrays(arrays, device="cpu")
    path = str(tmp_path_factory.mktemp("falcon") / "falcon.safetensors")
    jck.save_engine(path, j, cfg, arch="falcon")
    return cfg, j, t, arrays, path


def _port_cfg(jcfg):
    return FalconConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


def test_falcon_checkpoint_round_trips_with_jax(falcon, tmp_path):
    """JAX's file loads into the carried tensors bit for bit; the port's
    file loads in JAX with the same arrays."""
    cfg, _, t, arrays, path = falcon
    loaded, tcfg = tck.load_engine(path, device="cpu")
    assert tcfg == _port_cfg(cfg) and type(loaded) is tfe.FalconEngineParams
    got = tck.engine_arrays(loaded)
    assert set(got) == set(arrays) == set(tck.engine_arrays(t))
    for key, a in arrays.items():
        assert torch.equal(got[key], torch.from_numpy(np.array(a))), key
    out = str(tmp_path / "port.safetensors")
    tck.save_engine(out, t, tcfg, arch="falcon")
    j2, cfg2 = jck.load_engine(out)
    assert cfg2 == cfg
    for key, a in arrays.items():
        leaf = j2
        for part in key.split("/"):
            leaf = getattr(leaf, part)
        np.testing.assert_array_equal(np.asarray(leaf), a, err_msg=key)


def test_falcon_engine_forward_matches_jax(falcon):
    """Prefill of 2 x 20 tokens in a cache of 128, then 6 greedy steps:
    logits within 1e-4, equal tokens, caches within one code; the plain
    attention at every window (no kernel launches on CPU tensors either)."""
    cfg, j, t, _, _ = falcon
    tcfg = _port_cfg(cfg)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jecfg, tecfg = jfe.FalconEngineConfig(cfg=cfg, use_kernel=False), tfe.FalconEngineConfig(
        cfg=tcfg)
    jl, jc = jfe.falcon_engine_forward(jecfg, j, jnp.asarray(prompt),
                                       jfe.init_falcon_kv_cache(cfg, 2, 128))
    _cuda.reset_launches()
    tl, tc = tfe.falcon_engine_forward(tecfg, t, torch.from_numpy(prompt),
                                       tfe.init_falcon_kv_cache(tcfg, 2, 128, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for _ in range(6):
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tl[:, -1:], dim=-1).numpy(), tok)
        jl, jc = jfe.falcon_engine_forward(jecfg, j, jnp.asarray(tok), jc)
        tl, tc = tfe.falcon_engine_forward(tecfg, t, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert all(n == 0 for n in _cuda.LAUNCHES.values())
    assert tc.length == int(jc.length) == 26
    for got, ref in ((tc.k, jc.k), (tc.v, jc.v)):
        diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
        assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999
    with pytest.raises(NotImplementedError, match="kv_bits=8"):
        tfe.FalconEngineConfig(cfg=tcfg, kv_bits=4)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        tfe.FalconEngineConfig(cfg=tcfg, tp_axis="tp")


def _run(b, req_cls, prompts, max_new, prefix):
    b.register_prefix(prefix)
    for i, p in enumerate(prompts):
        b.add_request(req_cls(uid=i, prompt_ids=p.copy(), max_new_tokens=max_new))
    return {r.uid: r.output_ids for r in b.run()}


def test_falcon_batcher_matches_jax(falcon):
    """More requests than slots, prompts past the chunk, three under the
    registered prefix (one remainder past the chunk), windows of 4 greedy
    steps: the tokens of JAX's batcher; ``batcher_from_checkpoint`` reads
    the family from the manifest."""
    cfg, j, t, _, path = falcon
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 10).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (6, 23, 9)]
    prompts += [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n).astype(np.int32)])
                for n in (3, 20, 7)]
    kw = dict(num_slots=3, max_len=MAX_LEN, prefill_pad=PAD, prefill_chunk=16, decode_steps=4)
    jb = jfam.family_batcher("falcon", jfe.FalconEngineConfig(cfg=cfg, use_kernel=False), j, **kw)
    tb = tfam.family_batcher("falcon", tfe.FalconEngineConfig(cfg=_port_cfg(cfg)), t, **kw)
    want = _run(jb, JRequest, prompts, 9, prefix)
    got = _run(tb, Request, prompts, 9, prefix)
    assert got == want and tb.prefix_hits == jb.prefix_hits == 3
    assert len({tok for toks in got.values() for tok in toks}) > 4  # not degenerate
    arch, b = tfam.batcher_from_checkpoint(path, device="cpu", num_slots=2, max_len=MAX_LEN,
                                           prefill_pad=PAD)
    assert arch == "falcon" and b._f is not None and b.cache.k.shape[2] == cfg.num_kv_heads
