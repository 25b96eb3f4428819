"""K7's arithmetic on the card, emulated on the CPU, against dgq_tpu.

The CUDA kernel K7 (``csrc/long_decode_attention.cu``) runs only on the
card: K3's cluster body (``decode_attention.cuh``) under ``chunked_plan``,
with clusters of up to 16 blocks, each rank's scores and codes in its
block's shared memory or in a device-memory scratch of (B, Hkv, cluster)
runs of 5 rep chmax bytes, a kv head's query heads split over virtual kv
heads where the plan says so, and the slots taken longest first.  That is
emulated here rank by rank, through the kernel's own byte offsets: every
rank's scores are written to its buffer (its block's, or its run of one
scratch filled with random bytes first, as ``torch.empty`` leaves it)
before any rank reads them back, its exp-weights or codes are written over
every position of its tiles (zeros past its length, which the p @ V loop
reads in quads), and each block finds its slot by the kernel's rank of the
lengths (ties by index).  The emulation is held against JAX's
``int8_decode_attention_chunked`` in interpret mode and against the port's
plain version within K3's gates on the card: a relative L2 error under
1e-3 with quant_pv (an exp rounded otherwise may move a code by one), else
rtol = atol = 2e-4.  Dh 64, rep 1 and 8, Smax 1024 in chunks of 128 and
256, ragged lengths, at every plan of ``chunked_candidates``.  The plan
itself is held at K7's shapes (Smax 16,384-65,536, rep 1, 4 and 8, 1 and
4 slots): its block fits, or the scores go to the scratch, and the ranks
cover every length once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.ops import attention as jatt
from dgq_tpu_torch.ops import attention as tatt

NEG = np.float32(np.finfo(np.float32).min)
SMS = 132


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _longest_first(lengths, z):
    """The slot a block of blockIdx.z serves (``longest_first``): the one
    whose rank by length, longest first and ties by index, is z."""
    hits = [s for s, ls in enumerate(lengths)
            if sum(lj > ls or (lj == ls and j < s) for j, lj in enumerate(lengths)) == z]
    assert len(hits) == 1, (lengths, z, hits)
    return hits[0]


def _k7_emulated(q, kt, v, lengths, qk, v_scale, quant_pv, plan, rng):
    """(B, H, Dh) f32 as K7 computes it under ``plan``, through the bytes of
    each rank's scores and codes."""
    b, h, dh = q.shape
    smax = kt.shape[3]
    hk = kt.shape[1] * plan.split  # virtual kv heads: kv head g // split, rep / split queries
    rep, c, tile = h // hk, plan.cluster, tatt.DECODE_TILE
    chmax = tatt.decode_chmax(smax, c)
    run = 5 * rep * chmax  # a rank's bytes: f32 scores [rep][chmax], then u8 codes [rep][chmax]
    # the scratch as the wrapper allocates it, or one private buffer a block
    mem = rng.integers(0, 256, b * hk * c * run, dtype=np.uint8)
    vs127 = np.float32(v_scale) / np.float32(127.0)
    out = np.full((b, h, dh), np.nan, np.float32)
    work = []
    for z in range(b):
        bi = _longest_first(list(lengths), z)
        n_valid = int(lengths[bi])
        per = tatt.decode_rank_positions(n_valid, c)
        for g in range(hk):
            for r in range(c):
                p0 = r * per
                n = max(0, min(per, n_valid - p0))
                base = ((bi * hk + g) * c + r) * run
                work.append((bi, g, r, p0, n, base))
    # 1: every rank's scores, before any rank reads
    for bi, g, r, p0, n, base in work:
        qg = q[bi, g * rep:(g + 1) * rep].astype(np.int64)
        s = (qg @ kt[bi, g // plan.split, :, p0:p0 + n].astype(np.int64)).astype(np.float32)
        s = s * np.float32(qk)
        sc = mem[base:base + 4 * rep * chmax].view(np.float32).reshape(rep, chmax)
        sc[:, :n] = s
    # 2: the cluster's max of the ranks' maxima, then exp-weights over whole tiles
    gmax = {}
    for bi, g, r, p0, n, base in work:
        sc = mem[base:base + 4 * rep * chmax].view(np.float32).reshape(rep, chmax)
        m = sc[:, :n].max(axis=1) if n else np.full(rep, NEG, np.float32)
        gmax[bi, g] = np.maximum(gmax.get((bi, g), np.full(rep, NEG, np.float32)), m)
    dens = {}
    for bi, g, r, p0, n, base in work:
        ntile = -(-n // tile)
        sc = mem[base:base + 4 * rep * chmax].view(np.float32).reshape(rep, chmax)
        codes = mem[base + 4 * rep * chmax:base + run].reshape(rep, chmax)
        e = np.zeros((rep, ntile * tile), np.float32)
        e[:, :n] = np.exp(sc[:, :n] - gmax[bi, g][:, None])
        dens[bi, g, r] = e.sum(axis=1, dtype=np.float32)
        if quant_pv:
            codes[:, :ntile * tile] = tatt._quantize_exp(torch.from_numpy(e)).numpy().view(np.uint8)
        else:
            sc[:, :ntile * tile] = e
    # 3: p @ V over each tile's position quads, ranks summed in rank order by rank 0
    accs = {}
    for bi, g, r, p0, n, base in work:
        nq4 = -(-n // 4) * 4  # the quads the p @ V loop reads: codes past n are zeros
        vr = v[bi, g // plan.split, p0:p0 + nq4].astype(np.int64)
        if quant_pv:
            w = mem[base + 4 * rep * chmax:base + run].reshape(rep, chmax)[:, :nq4]
            acc = w.view(np.int8).astype(np.int64) @ vr
        else:
            w = mem[base:base + 4 * rep * chmax].view(np.float32).reshape(rep, chmax)[:, :nq4]
            acc = w @ (vr.astype(np.float32) * np.float32(v_scale))
        accs[bi, g, r] = acc
    for bi in range(b):
        for g in range(hk):
            acc = sum(accs[bi, g, r] for r in range(c))
            den = np.float32(0)
            for r in range(c):
                den = den + dens[bi, g, r]
            if quant_pv:
                o = acc.astype(np.float32) * (vs127 / den[:, None])
            else:
                o = acc / den[:, None]
            out[bi, g * rep:(g + 1) * rep] = o
    return out


def _inputs(seed, b, h, hk, dh, smax):
    r = np.random.default_rng(seed)
    q = r.integers(-127, 128, (b, h, dh)).astype(np.int8)
    kt = r.integers(-127, 128, (b, hk, dh, smax)).astype(np.int8)
    v = r.integers(-127, 128, (b, hk, smax, dh)).astype(np.int8)
    qs, ks, vs = (np.float32(x) for x in r.random(3) * 0.02 + 0.01)
    return q, kt, v, qs, ks, vs


def _check(got, ref, quant_pv):
    assert np.isfinite(got).all()
    if quant_pv:
        rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        assert rel < 1e-3, rel
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("quant_pv", [True, False])
@pytest.mark.parametrize("h,hk,chunk,lengths", [
    (4, 4, 128, (1, 700, 1024)),       # MHA: one position, ragged, the whole cache
    (16, 2, 256, (333, 1000, 333, 5)),  # rep 8, tied lengths, a slot off the rank grid
])
def test_k7_emulation_matches_jax_and_plain(h, hk, chunk, lengths, quant_pv):
    dh, smax = 64, 1024
    b = len(lengths)
    q, kt, v, qs, ks, vs = _inputs(h + chunk, b, h, hk, dh, smax)
    lens = np.asarray(lengths, np.int32)
    ref = np.asarray(jatt.int8_decode_attention_chunked(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), jnp.asarray(lens), jnp.float32(qs),
        jnp.float32(ks), jnp.float32(vs), chunk=chunk, quant_pv=quant_pv, interpret=True))
    t = [torch.from_numpy(a) for a in (q, kt, v)]
    tq, tk, tv = (torch.tensor(x) for x in (qs, ks, vs))
    plain = tatt.int8_decode_attention_chunked(*t, torch.from_numpy(lens), tq, tk, tv,
                                               chunk=chunk, quant_pv=quant_pv).numpy()
    _check(plain, ref, quant_pv)
    qk = tatt.qk_scale(tq, tk, dh).item()
    plans = tatt.chunked_candidates(hk, h // hk, dh, smax)
    assert tatt.chunked_plan(b, hk, h // hk, dh, smax, SMS) in plans
    assert {p.cluster for p in plans if not p.scratch} == set(tatt.CHUNKED_CLUSTERS)
    rng = np.random.default_rng(0)
    for plan in plans:
        got = _k7_emulated(q, kt, v, lens, qk, vs, quant_pv, plan, rng)
        _check(got, ref, quant_pv)
        _check(got, plain, quant_pv)


def test_longest_first_is_a_permutation_longest_first():
    for lengths in ((5, 9, 5, 9, 1), (7,), (3, 3, 3), (16000, 5000, 12000, 9000)):
        order = [_longest_first(lengths, z) for z in range(len(lengths))]
        assert sorted(order) == list(range(len(lengths)))
        assert [lengths[s] for s in order] == sorted(lengths, reverse=True)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("rep,hk", [(1, 32), (4, 8), (8, 8)])
@pytest.mark.parametrize("smax", [16384, 32768, 65536])
def test_chunked_plan_fits_and_tiles(b, rep, hk, smax):
    """K7's plan: one of ``chunked_candidates``, at the largest cluster, the
    smallest head split whose clusters give CHUNKED_BLOCKS_PER_SM blocks an
    SM; its block (with the body's static shared memory) holds a rank's
    scores, or the scores go to the scratch (where no block holds them, or
    where the scratch lets more blocks of several query heads share an SM);
    its ranks cover every valid length exactly once, each within the
    positions a rank holds, and the scratch gives each rank its own run."""
    dh = 128
    plan = tatt.chunked_plan(b, hk, rep, dh, smax, SMS)
    c, split = plan.cluster, plan.split
    assert plan in tatt.chunked_candidates(hk, rep, dh, smax)
    assert c == max(tatt.CHUNKED_CLUSTERS)
    fill = [s for s in tatt.CHUNKED_SPLITS
            if rep % s == 0 and b * hk * s * c >= tatt.CHUNKED_BLOCKS_PER_SM * SMS]
    assert split == (fill[0] if fill else rep)
    r = rep // split
    room = tatt.DECODE_SMEM_LIMIT - tatt.decode_static_bytes(dh, r)
    assert tatt.decode_smem_bytes(dh, r, smax, c, plan.scratch) <= room
    if plan.scratch:
        assert (tatt.decode_smem_bytes(dh, r, smax, c) > room or r > 1 and (
            tatt._blocks_per_sm(tatt.decode_smem_bytes(dh, r, smax, c, True))
            > tatt._blocks_per_sm(tatt.decode_smem_bytes(dh, r, smax, c))))
    chmax = tatt.decode_chmax(smax, c)
    assert chmax % tatt.DECODE_TILE == 0 and c * chmax >= smax
    for n in sorted({1, 15, 16, 17, smax // 3, smax - 10, smax}):
        per = tatt.decode_rank_positions(n, c)
        assert per % 16 == 0 and per <= chmax
        spans = [(k * per, min((k + 1) * per, n)) for k in range(c)]
        covered = [pos for lo, hi in spans for pos in range(lo, hi)]
        assert covered == list(range(n))
    if plan.scratch:  # (B, Hkv split, cluster) runs of 5 (rep / split) chmax bytes, 16-aligned
        run = 5 * r * chmax
        assert run % 16 == 0
        starts = {((bi * hk * split + g) * c + k) * run for bi in range(b)
                  for g in range(hk * split) for k in range(c)}
        assert len(starts) == b * hk * split * c
        assert max(starts) + run == b * hk * c * 5 * rep * chmax  # _chunked_launch's bytes


@pytest.mark.parametrize("b,hk,rep,dh,smax", [(4, 32, 1, 128, 2048), (4, 8, 4, 128, 2048),
                                              (8, 32, 1, 128, 2048), (2, 8, 8, 128, 8192),
                                              (2, 2, 8, 64, 1024)])
def test_chunked_plan_takes_k3s_on_the_caches_k3_takes(b, hk, rep, dh, smax):
    """Up to DECODE_SHORT_SMAX positions (where ``auto_decode_chunk`` picks
    K3) K7 runs K3's cluster, unsplit, with the scores in shared memory."""
    assert tatt.auto_decode_chunk(smax) == 0
    plan = tatt.chunked_plan(b, hk, rep, dh, smax, SMS)
    assert plan == tatt.ChunkedPlan(tatt.decode_plan(b, hk, rep, dh, smax, SMS), False, 1)
    assert plan in tatt.chunked_candidates(hk, rep, dh, smax)


def test_k7_wrapper_keeps_the_chunk_check_and_takes_the_plain_version_on_cpu():
    q, kt, v, qs, ks, vs = _inputs(1, 2, 4, 4, 64, 512)
    t = [torch.from_numpy(a) for a in (q, kt, v)]
    sc = [torch.tensor(x) for x in (qs, ks, vs)]
    lengths = torch.tensor([100, 512], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tatt.int8_decode_attention_chunked(*t, lengths, *sc, chunk=384)
    for chunk in (4, 128, 512):  # any chunk that divides Smax: the kernel does not walk chunks
        got = tatt.int8_decode_attention_chunked(*t, lengths, *sc, chunk=chunk, quant_pv=True)
        torch.testing.assert_close(got, tatt.int8_decode_attention_xla(
            *t, lengths, *sc, quant_pv=True), rtol=0, atol=0)
