"""K3 and K7 at any number of query heads a kv head, and the Falcon engine
and its serving, held against dgq_tpu on the CPU.

* The plain K3 and K7 (what the wrappers run on CPU tensors) against JAX's
  ``int8_decode_attention`` and ``int8_decode_attention_chunked`` in
  interpret mode at 3, 6 and 71 query heads a kv head (Dh 64, Smax 256),
  both p @ V rules, within 1e-5 of the largest output.
* The split kernels' arithmetic (``csrc/decode_attention_rows.cu``: one
  cluster a (slot, kv head), every query row of the kv head in the block),
  emulated at every cluster of ``rows_candidates``: q's rows padded to 16
  with zero rows (a dead row's slope 0), each rank's exact int32 scores
  over its positions; with quant_pv the row max over the cluster's ranks,
  e = exp(s - m) once a position and codes trunc(127 e + 0.5) with an int32
  p @ V, the ranks' sums in rank order; fp p @ V in one pass, each warp's
  running max over its half of each tile, e = 2^(s log2 e - m log2 e) and
  P = 4096 e in two fp16 pieces (p_hi, p_lo) times V in fp32, the two
  warps' and then the ranks' sums rescaled to the larger max, v_scale /
  4096 in the epilogue; held against JAX's K3 (and, without ALiBi, its
  chunked K7) in interpret mode at rep 3, 6 and 71, both p @ V rules, with
  and without ALiBi (whose slope index moves the result).
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


def _rows_emulated(q, kt, v, lengths, qs, ks, vs, cluster, slopes=None):
    """(B, H, Dh) f32 as K3's and K7's split kernels compute it with quant_pv
    in a cluster of ``cluster`` blocks a (slot, kv head), rank by rank: the
    row max over the cluster's ranks, then each rank's codes times V, the
    ranks' sums in rank order."""
    b, h, dh = q.shape
    hk = kt.shape[1]
    rep = h // hk
    rp = 16 * -(-rep // 16)  # rows of the block: q padded with zero rows
    f32 = np.float32
    qk = f32(tatt.qk_scale(torch.tensor(qs), torch.tensor(ks), dh).item())
    vs127 = f32(f32(vs) / f32(127.0))
    out = np.full((b, h, dh), np.nan, f32)
    for bi in range(b):
        n_valid = int(lengths[bi])
        per = tatt.decode_rank_positions(n_valid, cluster)
        for g in range(hk):
            qv = np.zeros((rp, dh), np.int64)
            qv[:rep] = q[bi, g * rep:(g + 1) * rep]
            sl = np.zeros(rp, f32)
            if slopes is not None:
                sl[:rep] = slopes[g * rep:(g + 1) * rep]
            ranks = []
            for r in range(cluster):
                p0 = r * per
                n = max(0, min(per, n_valid - p0))
                s = (qv @ kt[bi, g, :, p0:p0 + n].astype(np.int64)).astype(f32) * qk
                if slopes is not None:  # the product, then the sum, each rounded
                    s = s + sl[:, None] * np.arange(p0, p0 + n, dtype=f32)
                ranks.append((p0, n, s))
            m = np.max([s.max(axis=1) for _, n, s in ranks if n], axis=0)
            acc, den = 0, np.zeros(rp, f32)
            for p0, n, s in ranks:  # rank order; expf, the plain version's exp
                e = np.exp(s - m[:, None])
                codes = (e * f32(127.0) + f32(0.5)).astype(np.int64)
                acc = acc + codes @ v[bi, g, p0:p0 + n].astype(np.int64)
                den = den + e.sum(axis=1, dtype=f32)
            o = np.broadcast_to(acc, (rp, dh)).astype(f32) * (vs127 / den)[:, None]
            assert np.isfinite(o).all()  # the dead rows too
            out[bi, g * rep:(g + 1) * rep] = o[:rep]
    assert not np.isnan(out).any()
    return out


def _rows_emulated_online(q, kt, v, lengths, qs, ks, vs, cluster, slopes=None):
    """(B, H, Dh) f32 as the split kernels' one pass against a running max
    computes it (fp p @ V) in a cluster of ``cluster`` blocks a (slot, kv
    head): each warp's half of every 64-position tile of a rank keeps its
    own running row max, rescaling its sums when a tile raises it; the two
    halves, then the ranks in rank order, are added rescaled to the larger
    max."""
    b, h, dh = q.shape
    hk = kt.shape[1]
    rep = h // hk
    rp = 16 * -(-rep // 16)
    f32, f64 = np.float32, np.float64
    qk = f32(tatt.qk_scale(torch.tensor(qs), torch.tensor(ks), dh).item())
    vsp = f32(f32(vs) * f32(1.0 / 4096))
    log2e = f32(1.4426950408889634)
    neg = f32(np.finfo(np.float32).min)

    def ex2(x):
        return np.exp2(x.astype(f32)).astype(f32)

    def scale(m):  # the weight of sums kept against max m, taken to max mm
        def w(mm):
            with np.errstate(over="ignore", invalid="ignore"):  # m = finfo.min: weight 0
                return np.where(m == neg, f32(0), ex2((m * log2e).astype(f32)
                                                      - (mm * log2e).astype(f32)))
        return w

    out = np.full((b, h, dh), np.nan, f32)
    for bi in range(b):
        n_valid = int(lengths[bi])
        per = tatt.decode_rank_positions(n_valid, cluster)
        for g in range(hk):
            qv = np.zeros((rp, dh), np.int64)
            qv[:rep] = q[bi, g * rep:(g + 1) * rep]
            sl = np.zeros(rp, f32)
            if slopes is not None:
                sl[:rep] = slopes[g * rep:(g + 1) * rep]
            ranks = []
            for r in range(cluster):
                p0 = r * per
                n = max(0, min(per, n_valid - p0))
                halves = []
                for w in range(2):  # the two warps of a row tile: 32 positions of each tile
                    m = np.full(rp, neg, f32)
                    den, acc = np.zeros(rp, f32), np.zeros((rp, dh), f32)
                    for t0 in range(0, n, 64):
                        lo_, hi_ = t0 + 32 * w, min(t0 + 32 * w + 32, n)
                        if lo_ >= hi_:
                            continue
                        s = (qv @ kt[bi, g, :, p0 + lo_:p0 + hi_].astype(np.int64)).astype(f32) * qk
                        if slopes is not None:
                            s = s + sl[:, None] * np.arange(p0 + lo_, p0 + hi_, dtype=f32)
                        tm = s.max(axis=1)
                        up = tm > m
                        alpha = np.where(up, scale(m)(tm), f32(1))
                        den = np.where(up, den * alpha, den).astype(f32)
                        acc = np.where(up[:, None], acc * alpha[:, None], acc).astype(f32)
                        m = np.where(up, tm, m)
                        e = ex2(s.astype(f64) * log2e - (m * log2e).astype(f32)[:, None])
                        big = e * f32(4096.0)
                        hi = big.astype(np.float16)
                        lo = (big - hi.astype(f32)).astype(np.float16)
                        part = (hi.astype(f64) + lo.astype(f64)) @ v[bi, g, p0 + lo_:p0 + hi_]
                        acc = (acc + part.astype(f32)).astype(f32)
                        den = (den + e.sum(axis=1, dtype=f32)).astype(f32)
                    halves.append((m, den, acc))
                (m0, d0, a0), (m1, d1, a1) = halves
                mm = np.maximum(m0, m1)
                w0, w1 = scale(m0)(mm), scale(m1)(mm)
                ranks.append((mm, (d0 * w0 + d1 * w1).astype(f32),
                              (a1 * w1[:, None] + a0 * w0[:, None]).astype(f32)))
            top = np.max([mk for mk, _, _ in ranks], axis=0)
            den, acc = np.zeros(rp, f32), np.zeros((rp, dh), f32)
            for mk, dk, ak in ranks:  # rank order
                wk = scale(mk)(top)
                den = (wk * dk + den).astype(f32)
                acc = (wk[:, None] * ak + acc).astype(f32)
            o = (acc * vsp) / den[:, None]
            assert np.isfinite(o).all()
            out[bi, g * rep:(g + 1) * rep] = o[:rep]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("quant_pv", [False, True])
@pytest.mark.parametrize("rep,hk", [(3, 2), (6, 2), (71, 1)])
def test_split_kernels_emulated_match_jax(rep, hk, quant_pv, alibi):
    """The split kernels' arithmetic at every cluster of ``rows_candidates``
    (quant_pv: its scores kept or recomputed give the same numbers; fp p @ V
    in one pass against a running max) against JAX's K3 (and, without
    ALiBi, its chunked K7) in interpret mode, within 1e-5 of the largest
    output; ALiBi's slopes (of rep hk heads, scaled so that late positions
    win) in the kernel's row order move the result, a reversed order within
    the kv head does not give it."""
    arrays = _inputs(7 + rep + 10 * alibi + quant_pv, rep, hk)
    slopes = alibi_slopes(rep * hk).numpy() * 8.0 if alibi else None
    ref = _jax_k3(*arrays, quant_pv, slopes)
    refs = [ref] if alibi else [ref, np.asarray(jatt.int8_decode_attention_chunked(
        *(jnp.asarray(a) for a in arrays), chunk=CHUNK, interpret=True, quant_pv=quant_pv))]
    largest = np.abs(ref).max()
    plans = tatt.rows_candidates(rep, DH, SMAX, quant_pv)
    assert tatt.rows_plan(len(LENGTHS), hk, rep, DH, SMAX, 132, quant_pv) in plans
    clusters = sorted({p.cluster for p in plans})
    assert clusters == list(tatt.ROWS_CLUSTERS)

    def emulated(cluster, sl):
        if quant_pv:
            return _rows_emulated(*arrays[:7], cluster, sl)
        return _rows_emulated_online(*arrays[:7], cluster, sl)

    for cluster in clusters:
        got = emulated(cluster, slopes)
        for want in refs:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * largest)
    if alibi:  # the slope index is held: each kv head's slopes reversed give another result
        wrong = slopes.reshape(hk, rep)[:, ::-1].reshape(-1).copy()
        moved = emulated(tatt.ROWS_CLUSTERS[0], wrong)
        assert np.abs(moved - ref).max() > 1e-2 * largest


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
