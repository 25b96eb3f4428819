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


# ---- K3's and K7's split kernels (csrc/decode_attention_rows.cu) ----

def _word(buf, off):
    return int(buf[off:off + 4].view("<u4")[0])


def _put16(buf, off, words):
    buf[off:off + 16] = np.array(words, "<u4").view(np.uint8)


def _byte_perm(x, y, s):
    """CUDA's __byte_perm: result byte i is byte (s >> 4i) & 7 of y:x."""
    b = (x | y << 32).to_bytes(8, "little")
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _transpose4x4(r):
    """decode_attention.cuh's transpose4x4: rows r0..r3 -> c[e] = byte e of
    each row, in row order."""
    t0, t1 = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[2], r[3], 0x5140)
    t2, t3 = _byte_perm(r[0], r[1], 0x7362), _byte_perm(r[2], r[3], 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def _swz(row, off):
    return off ^ ((off >> 3) & (0x70 if row == 128 else 0x30))


def _s8x2_to_h2(w, i):
    biased = _byte_perm(w ^ 0x80808080, 0x64646464, 0x4342 if i else 0x4140)
    h = np.array([biased], "<u4").view(np.float16) - np.float16(1152)
    return int(h.view("<u4")[0])


def _chunk16(rowb, r, c):
    """chunk16<ROWB>: 16-byte chunk c of row r, its low three bits XOR the row's."""
    return r * rowb + ((c ^ (r & 7)) << 4)


def _to_f16(raw, rows, width):
    """to_f16<R, W>: a raw tile of ``rows`` rows of ``width`` int8 bytes ->
    the same layout in fp16 (rows of 2 width bytes, chunks swizzled)."""
    tile = np.zeros(rows * 2 * width, np.uint8)
    for i in range(rows * (width // 16)):
        r, c = divmod(i, width // 16)
        w = [_word(raw, r * width + 16 * c + 4 * k) for k in range(4)]
        for half in range(2):
            _put16(tile, _chunk16(2 * width, r, 2 * c + half),
                   [_s8x2_to_h2(w[2 * half + k // 2], k % 2) for k in range(4)])
    return tile


def _ldsm(buf, addrs, trans):
    """ldmatrix .x4 (.trans): lane l gives row l % 8 of matrix l // 8 (8 b16
    at addrs[l]); returns regs[lane][matrix] as fp16 pairs (low, high)."""
    mats = [np.stack([buf[addrs[8 * m + r]:addrs[8 * m + r] + 16].view(np.float16)
                      for r in range(8)]) for m in range(4)]
    regs = np.zeros((32, 4, 2), np.float16)
    for j in range(32):
        for m in range(4):
            if trans:
                regs[j, m] = mats[m][2 * (j % 4):2 * (j % 4) + 2, j // 4]
            else:
                regs[j, m] = mats[m][j // 4, 2 * (j % 4):2 * (j % 4) + 2]
    return regs


def _turn_v_s8(raw, dh):
    """turn_v_s8: V [64][dh] -> V^T [dh][64 slots] int8 in the scores'
    fragment order (rows of 64 bytes, swizzled 64 bytes)."""
    dq_n = dh // 4
    tv = np.zeros(64 * dh, np.uint8)
    for unit in range(4 * dq_n):
        dq, kp = unit % dq_n, unit // dq_n
        odd = kp & 1
        r = [_word(raw, (16 * kp + (i ^ odd)) * dh + 4 * dq) for i in range(16)]
        w = [_transpose4x4([r[(4 * m + i) ^ odd] for i in range(4)]) for m in range(4)]
        for ep in range(4):
            e = (ep + (dq >> 1)) & 3
            _put16(tv, _swz(64, (4 * dq + e) * 64 + 16 * kp),
                   [_byte_perm(w[t >> 1][e], w[2 + (t >> 1)][e], 0x7632 if t & 1 else 0x5410)
                    for t in range(4)])
    return tv


def _bytes(word):
    return np.array([word], "<u4").view(np.int8).astype(np.int64)


@pytest.mark.parametrize("quant_pv", [False, True])
@pytest.mark.parametrize("dh", [64, 128])
def test_split_kernels_turns_and_fragments(dh, quant_pv):
    """The split kernels' shared-memory tiles and mma.sync fragments, byte
    for byte as the CUDA source makes them: q's rows and the K^T tile in
    fp16 (chunks swizzled), read by ldmatrix into each warp's (wp = 0, 1)
    m16n8k16 A and (transposed) B fragments, give q.k of its 32 positions
    exactly; its p @ V, the scores' accumulator layout (row gq or gq + 8,
    position 8j + 2t + (e & 1) of n8 tile j) taken as the A fragments, is
    the warp's 32 positions' P times V: P's two fp16 pieces against the V
    tile in fp16 through ldmatrix.trans, or (quant_pv) int8 codes in the k
    order 2t, 2t + 1, 8 + 2t, 9 + 2t a 16 against V^T int8 (m16n8k32)."""
    rng = np.random.default_rng(dh + quant_pv)
    kt = rng.integers(-127, 128, (dh, 64)).astype(np.int8)
    v = rng.integers(-127, 128, (64, dh)).astype(np.int8)
    q = rng.integers(-127, 128, (16, dh)).astype(np.int8)  # one m16 tile of rows
    tk = _to_f16(kt.view(np.uint8).reshape(-1).copy(), dh, 64)
    tq = _to_f16(q.view(np.uint8).reshape(-1).copy(), 16, dh)
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for wp in range(2):
        for ks in range(dh // 16):  # q.k: A = q's 16 dims, B = K^T's, two n8 tiles a load
            qa = _ldsm(tq, [_chunk16(2 * dh, lane & 15, 2 * ks + (lane >> 4))
                            for lane in range(32)], False)
            amat = np.zeros((16, 16))
            for lane, (gq, t) in enumerate(lanes):
                for reg, (row, k0) in enumerate(((gq, 2 * t), (gq + 8, 2 * t),
                                                 (gq, 8 + 2 * t), (gq + 8, 8 + 2 * t))):
                    amat[row, k0:k0 + 2] = qa[lane, reg]
            np.testing.assert_array_equal(amat, q[:, 16 * ks:16 * ks + 16])
            for jp in range(2):
                kb = _ldsm(tk, [_chunk16(128, 16 * ks + 8 * ((lane >> 3) & 1) + (lane & 7),
                                         4 * wp + 2 * jp + (lane >> 4)) for lane in range(32)],
                           True)
                for half in range(2):  # n8 tile 2 jp + half: registers 2 half, 2 half + 1
                    bmat = np.zeros((16, 8))
                    for lane, (gq, t) in enumerate(lanes):
                        bmat[2 * t:2 * t + 2, gq] = kb[lane, 2 * half]
                        bmat[8 + 2 * t:10 + 2 * t, gq] = kb[lane, 2 * half + 1]
                    pos = 32 * wp + 8 * (2 * jp + half)
                    np.testing.assert_array_equal(bmat, kt[16 * ks:16 * ks + 16, pos:pos + 8])
                    np.testing.assert_array_equal(amat @ bmat, q[:, 16 * ks:16 * ks + 16].astype(
                        np.int64) @ kt[16 * ks:16 * ks + 16, pos:pos + 8].astype(np.int64))
        # p @ V of the warp's 32 positions: x[row][position] in the scores' layout
        x = rng.random((16, 32)).astype(np.float32)
        x[rng.random((16, 32)) < 0.3] = 0.0
        vw = v[32 * wp:32 * wp + 32].astype(np.float64)

        def c_layout(jj, e, gq, t):  # sf[jj][e] of lane (gq, t)
            return x[gq + 8 * (e >> 1), 8 * jj + 2 * t + (e & 1)]

        if quant_pv:
            tv = _turn_v_s8(v.view(np.uint8).reshape(-1).copy(), dh)
            codes = (x * np.float32(127.0) + np.float32(0.5)).astype(np.int64)
            amat = np.zeros((16, 32), np.int64)
            for gq, t in lanes:
                c = [[int(c_layout(jj, e, gq, t) * np.float32(127.0) + np.float32(0.5))
                      for e in range(4)] for jj in range(4)]
                pa = [c[0][0] | c[0][1] << 8 | c[1][0] << 16 | c[1][1] << 24,
                      c[0][2] | c[0][3] << 8 | c[1][2] << 16 | c[1][3] << 24,
                      c[2][0] | c[2][1] << 8 | c[3][0] << 16 | c[3][1] << 24,
                      c[2][2] | c[2][3] << 8 | c[3][2] << 16 | c[3][3] << 24]
                for reg, (row, k0) in enumerate(((gq, 4 * t), (gq + 8, 4 * t),
                                                 (gq, 16 + 4 * t), (gq + 8, 16 + 4 * t))):
                    amat[row, k0:k0 + 4] = _bytes(pa[reg])
            for jd in range(dh // 8):
                bmat = np.zeros((32, 8), np.int64)
                for gq, t in lanes:
                    d = 8 * jd + gq
                    bmat[4 * t:4 * t + 4, gq] = _bytes(_word(tv, _swz(64, d * 64 + 32 * wp) + 4 * t))
                    bmat[16 + 4 * t:20 + 4 * t, gq] = _bytes(
                        _word(tv, _swz(64, d * 64 + 32 * wp + 16) + 4 * t))
                np.testing.assert_array_equal(amat @ bmat,
                                              codes @ vw[:, 8 * jd:8 * jd + 8].astype(np.int64))
            continue
        tv = _to_f16(v.view(np.uint8).reshape(-1).copy(), 64, dh)
        got = np.zeros((16, dh))
        for kk in range(2):  # positions 16 kk .. of the warp's: n8 tiles 2kk, 2kk + 1
            ahi, alo = np.zeros((16, 16)), np.zeros((16, 16))
            for gq, t in lanes:
                for r in range(4):
                    row, k0 = gq + 8 * (r & 1), 2 * t + 8 * (r >> 1)
                    pair = np.array([c_layout(2 * kk + (r >> 1), 2 * (r & 1) + i, gq, t)
                                     for i in range(2)], np.float32) * np.float32(4096.0)
                    hi = pair.astype(np.float16)
                    lo = (pair - hi.astype(np.float32)).astype(np.float16)
                    ahi[row, k0:k0 + 2], alo[row, k0:k0 + 2] = hi, lo
            for jp in range(dh // 16):
                vb = _ldsm(tv, [_chunk16(2 * dh, 32 * wp + 16 * kk + 8 * ((lane >> 3) & 1)
                                         + (lane & 7), 2 * jp + (lane >> 4)) for lane in range(32)],
                           True)
                for half in range(2):  # n8 tile (dims) 2 jp + half
                    bmat = np.zeros((16, 8))
                    for lane, (gq, t) in enumerate(lanes):
                        bmat[2 * t:2 * t + 2, gq] = vb[lane, 2 * half]
                        bmat[8 + 2 * t:10 + 2 * t, gq] = vb[lane, 2 * half + 1]
                    d0 = 8 * (2 * jp + half)
                    np.testing.assert_array_equal(bmat, vw[16 * kk:16 * kk + 16, d0:d0 + 8])
                    got[:, d0:d0 + 8] += ahi @ bmat + alo @ bmat
        want = (x.astype(np.float64) * 4096.0) @ vw
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -20 * 4096 * 128 * 32)


def _rows_layout_total(dh, rep, smax, plan, quant_pv):
    """csrc/decode_attention_rows.cu's Layout(dh, rp, chmax, qpv,
    recompute).total, with chmax and recompute as its C entry takes them."""
    chmax = -(-(-(-smax // plan.cluster)) // 64) * 64
    recompute = 0 if not plan.recompute else 2 if plan.keep_k else 1
    rp, slot = 16 * -(-rep // 16), 64 * dh
    tv = 32768 + (chmax // 64 if recompute == 2 else 1) * 2 * slot
    q = max(tv + 2 * slot, 4 * rp * (dh + 8))
    scores = q + 2 * rp * dh
    return scores + (4 * rp * (chmax + 8) if quant_pv and recompute == 0 else 0)


@pytest.mark.parametrize("rep", [3, 6, 12, 16, 71])
@pytest.mark.parametrize("b,smax", [(8, 2048), (4, 16384)])
def test_rows_plan_fits_and_serves_every_query_head(b, smax, rep):
    """The split kernels' plan (one function for K3's and K7's wrappers, so
    K7 takes K3's plan on the caches K3 takes) at Falcon-7B's serving decode
    (8 slots at 2048) and batched decode at 16,384 (4 slots), both p @ V
    rules: one of ``rows_candidates``, each of which fits a block's shared
    memory with the body's static bytes, as the kernel's ``Layout`` counts
    it; fp p @ V keeps no scores (one pass against a running max); quant_pv's
    scores stay in shared memory wherever the plan's block holds them (at
    2048 it does); two warps a 16-row tile, at least ROWS_MIN_THREADS; every
    query head of the kv head written once by the ranks' rows r, r + C, ..;
    the cluster's ranks cover every valid length once.  The whole kernels'
    plans refuse such a rep."""
    dh = 64
    for quant_pv in (False, True):
        plan = tatt.rows_plan(b, 1, rep, dh, smax, SMS, quant_pv)
        plans = tatt.rows_candidates(rep, dh, smax, quant_pv)
        assert plan in plans
        for p in plans:
            smem = tatt.rows_smem_bytes(dh, rep, smax, p, quant_pv)
            assert smem + tatt.ROWS_STATIC_BYTES <= tatt.DECODE_SMEM_LIMIT
            assert smem == _rows_layout_total(dh, rep, smax, p, quant_pv)
            assert quant_pv or not (p.recompute or p.keep_k)
        # quant_pv's scores kept where they fit, else the K tiles, else K streamed again
        if quant_pv:
            kept = plan._replace(recompute=False, keep_k=False) in plans
            assert plan.recompute == (not kept)
            assert plan.keep_k == (plan.recompute and plan._replace(keep_k=True) in plans)
            assert smax > tatt.DECODE_SHORT_SMAX or not plan.recompute
        c = plan.cluster
        assert b * c <= SMS or c == 2
        assert sorted(r for k in range(c) for r in range(k, rep, c)) == list(range(rep))
        chmax = tatt.decode_chmax(smax, c)
        for n in sorted({1, 17, smax // 3, smax}):
            per = tatt.decode_rank_positions(n, c)
            assert per % 16 == 0 and per <= chmax
            spans = [(k * per, min((k + 1) * per, n)) for k in range(c)]
            assert [pos for lo, hi in spans for pos in range(lo, hi)] == list(range(n))
    threads = tatt.rows_threads(rep)
    assert threads == max(tatt.ROWS_MIN_THREADS, 64 * -(-rep // 16)) and threads <= 512
    for whole in (tatt.decode_plan, tatt.chunked_plan):
        with pytest.raises(ValueError, match="rows_plan"):
            whole(b, 1, rep, dh, smax, SMS)
