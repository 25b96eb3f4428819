"""K8's and K11's arithmetic on the card, emulated on the CPU, against dgq_tpu.

The CUDA kernels K8 and K11 (``csrc/paged_decode_attention.cu``) run K3's
body (``csrc/decode_attention.cuh``) over a page pool: a cluster of C
blocks per (slot, kv head), rank r taking the positions [r per, (r + 1) per)
below the slot's length (``decode_rank_positions``; the length clamped to
the table's NP * ps positions, as an inactive slot's may run past it).  A
rank looks each copy's page up in the slot's table row as it streams its
tiles: K 16 positions a copy (4 when ps % 16 != 0), which never leave their
page, V one position's row.  The cluster takes the GLOBAL row max over its
ranks' maxima; with quant_pv (K8) each rank makes its codes against it and
sums its p @ V exactly in int32, and rank 0 adds the ranks' sums and exp
sums in rank order, then acc * ((v_scale / 127) / sum l); otherwise (K11
always) fp32 exp-weights and p @ V of v * v_scale over the same sums.
K11's nibble K rows sign-extend four nibbles at once (``sext_nibbles``)
into words of four dims in natural order.  That arithmetic is emulated here
rank by rank, through a shuffled table with null-page entries, and held
against JAX's ``int8_paged_decode_attention`` and
``int4_paged_decode_attention`` in interpret mode and against the port's
plain versions (what the wrappers run on CPU tensors) within K3's gates on
the card: a relative L2 error under 1e-3 with quant_pv (an exp rounded
otherwise may move a code by one), else rtol = atol = 2e-4.  Dh 64 and
128, rep 1 and 4, pages of 16, 64 and 128 positions (and 12: 4-byte K
copies), lengths 1 and a page boundary +- 1, and an inactive slot whose
length runs past its table; every cluster size and the plan's.
``paged_plan`` itself is held at the engine's shapes: its cluster fits a
block's shared memory and its ranks cover every length."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.ops import attention as jatt
from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops import attention as tatt
from dgq_tpu_torch.ops.kv4 import unpack_nibbles

NEG = torch.finfo(torch.float32).min
SMS = 132


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sext_nibbles(x: torch.Tensor) -> torch.Tensor:
    """The kernel's sign extension of the low nibble of each byte (0..15)
    to int8: ((x ^ 8) + 0x78) ^ 0x80, byte by byte without a carry."""
    u = x.to(torch.int32)
    return (((u ^ 0x08) + 0x78) ^ 0x80).to(torch.uint8).view(torch.int8)


def _k_tile(kt_pool, table_row, g, p0, n, kv4):
    """(Dh, n) int8 K codes of logical positions p0 .. p0 + n - 1, copied a
    chunk at a time (16 positions, 4 when ps % 16 != 0), each chunk's page
    table_row[p / ps], rounded up inside the page past the length; nibble
    pages: rows 2 dq and 2 dq + 1 sign-extended into dims 4 dq .. 4 dq + 3."""
    rows, ps = kt_pool.shape[2], kt_pool.shape[3]
    cw = 16 if ps % 16 == 0 else 4
    cols = []
    for p in range(p0, p0 + n, cw):
        off = p % ps
        assert p % cw == 0 and off + cw <= ps  # a copy never leaves its page
        cols.append(kt_pool[int(table_row[p // ps]), g, :, off:off + cw])
    k = torch.cat(cols, dim=1)[:, :n] if cols else kt_pool[0, g, :, :0]
    if not kv4:
        return k
    packed = k.view(torch.uint8).reshape(rows // 2, 2, n)
    r0, r1 = packed[:, 0], packed[:, 1]  # dims 4 dq, 4 dq + 1 / 4 dq + 2, 4 dq + 3
    dims = [_sext_nibbles(r0 & 0xF), _sext_nibbles(r0 >> 4), _sext_nibbles(r1 & 0xF),
            _sext_nibbles(r1 >> 4)]
    return torch.stack(dims, dim=1).reshape(2 * rows, n)


def _v_tile(v_pool, table_row, g, p0, n, kv4):
    """(n, Dh) V codes, one position's row a copy, each in its page."""
    ps = v_pool.shape[2]
    v = torch.stack([v_pool[int(table_row[p // ps]), g, p % ps] for p in range(p0, p0 + n)]) \
        if n else v_pool[0, g, :0]
    if not kv4:
        return v
    u = v.to(torch.int32) & 0xFF
    lo, hi = ((u & 0xF) ^ 8) - 8, ((u >> 4) ^ 8) - 8  # sext4 of each nibble
    return torch.stack([lo, hi], dim=2).reshape(n, 2 * v.shape[1]).to(torch.int8)


def _paged_emulated(q, kt_pool, v_pool, table, lengths, qk, v_scale, quant_pv, kv4, cluster):
    """(B, H, Dh) f32 as K8 / K11 compute it, rank by rank of each cluster."""
    b, h, dh = q.shape
    hk, ps = kt_pool.shape[1], kt_pool.shape[3]
    npos = table.shape[1] * ps
    rep = h // hk
    vs127 = v_scale / torch.tensor(127.0)
    out = torch.empty((b, h, dh), dtype=torch.float32)
    for bi in range(b):
        n_valid = min(int(lengths[bi]), npos)
        per = tatt.decode_rank_positions(n_valid, cluster)
        ranks = [(r * per, max(0, min(per, n_valid - r * per))) for r in range(cluster)]
        for g in range(hk):
            heads = slice(g * rep, (g + 1) * rep)
            qg = q[bi, heads].to(torch.int32)
            scores = []
            m = torch.full((rep,), NEG)
            for p0, n in ranks:  # a rank past the length has no positions and keeps NEG
                k = _k_tile(kt_pool, table[bi], g, p0, n, kv4).to(torch.int32)
                s = (qg @ k).to(torch.float32) * qk
                scores.append(s)
                if n:
                    m = torch.maximum(m, s.amax(dim=1))  # the cluster's max of the maxima
            acc = torch.zeros((rep, dh), dtype=torch.int32 if quant_pv else torch.float32)
            den = torch.zeros((rep,))
            for (p0, n), s in zip(ranks, scores):  # rank order
                e = torch.exp(s - m[:, None])
                den = den + e.sum(dim=1)
                v = _v_tile(v_pool, table[bi], g, p0, n, kv4)
                if quant_pv:
                    acc = acc + tatt._quantize_exp(e).to(torch.int32) @ v.to(torch.int32)
                else:
                    acc = acc + e @ (v.to(torch.float32) * v_scale)
            if quant_pv:
                out[bi, heads] = acc.to(torch.float32) * (vs127 / den[:, None])
            else:
                out[bi, heads] = acc / den[:, None]
    return out


def _check(got, ref, quant_pv):
    if quant_pv:
        rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        assert rel < 1e-3, rel
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def _inputs(seed, h, hk, dh, ps, npg, kv4):
    """q, a pool of 1 + 5 npg pages, a shuffled table with null-page (0)
    entries past each slot's pages, lengths 1, ps - 1, ps, ps + 1 and an
    inactive slot's NP * ps + 5, and scales."""
    r = np.random.default_rng(seed)
    lengths = np.asarray([1, max(ps - 1, 1), ps, ps + 1, npg * ps + 5], np.int32)
    b, pages = len(lengths), 1 + len(lengths) * npg
    rows, lo = (dh // 2, -128) if kv4 else (dh, -127)
    q = r.integers(-127, 128, (b, h, dh)).astype(np.int8)
    kt_pool = r.integers(lo, 128, (pages, hk, rows, ps)).astype(np.int8)
    v_pool = r.integers(lo, 128, (pages, hk, ps, rows)).astype(np.int8)
    perm = r.permutation(np.arange(1, pages))
    table = np.zeros((b, npg), np.int32)
    k = 0
    for i, n in enumerate(lengths):
        need = min(-(-int(n) // ps), npg)
        table[i, :need] = perm[k:k + need]
        k += need
    qs, ks, vs = (np.float32(x) for x in r.random(3) * 0.02 + 0.01)
    if kv4:  # the effective int4 scales (int8 scales x 127 / 7)
        ks, vs = np.float32(ks * 127 / 7), np.float32(vs * 127 / 7)
    return q, kt_pool, v_pool, table, lengths, qs, ks, vs


@pytest.mark.parametrize("mode", ["quant_pv", "fp", "kv4"])
@pytest.mark.parametrize("dh,h,hk,ps,npg", [
    (128, 2, 2, 128, 4),  # MHA, 128-position pages
    (64, 2, 2, 16, 16),   # Dh 64, 16-position pages
    (128, 4, 1, 64, 4),   # rep 4, 64-position pages
    (64, 8, 2, 128, 2),   # Dh 64, rep 4
])
def test_paged_emulation_matches_jax_and_plain(dh, h, hk, ps, npg, mode):
    quant_pv, kv4 = mode == "quant_pv", mode == "kv4"
    q, kt_pool, v_pool, table, lengths, qs, ks, vs = _inputs(dh + h + ps, h, hk, dh, ps, npg,
                                                             kv4)
    jargs = [jnp.asarray(a) for a in (q, kt_pool, v_pool, table, lengths)]
    jsc = [jnp.float32(x) for x in (qs, ks, vs)]
    t = [torch.from_numpy(a) for a in (q, kt_pool, v_pool, table, lengths)]
    tq, tk, tv = (torch.tensor(x) for x in (qs, ks, vs))
    _cuda.reset_launches()
    if kv4:
        ref = np.asarray(jatt.int4_paged_decode_attention(*jargs, *jsc, interpret=True))
        plain = tatt.int4_paged_decode_attention(*t, tq, tk, tv).numpy()
        assert _cuda.LAUNCHES[tatt.PAGED_KV4] == 0
        # the kernel's nibble unpack gives the plain version's codes, page by page
        kt8 = unpack_nibbles(t[1], axis=2)
        ident = torch.arange(t[1].shape[0])
        for c in (0, t[1].shape[0] - 1):
            for g in range(hk):
                np.testing.assert_array_equal(
                    _k_tile(t[1], ident, g, c * ps, ps, True).numpy(), kt8[c, g].numpy())
    else:
        ref = np.asarray(jatt.int8_paged_decode_attention(*jargs, *jsc, interpret=True,
                                                          quant_pv=quant_pv))
        plain = tatt.int8_paged_decode_attention(*t, tq, tk, tv, quant_pv=quant_pv).numpy()
        assert _cuda.LAUNCHES[tatt.PAGED] == 0
    _check(plain, ref, quant_pv)
    qk = tatt.qk_scale(tq, tk, dh)
    plan = tatt.paged_plan(len(lengths), hk, h // hk, dh, npg, ps, SMS, kv4)
    for cluster in sorted({*tatt.DECODE_CLUSTERS, plan}):
        got = _paged_emulated(*t, qk, tv, quant_pv, kv4, cluster).numpy()
        _check(got, ref, quant_pv)
        _check(got, plain, quant_pv)


@pytest.mark.parametrize("quant_pv", [True, False])
def test_paged_emulation_four_byte_copies(quant_pv):
    """Pages of 12 positions (ps % 16 != 0): K copied 4 positions at a time,
    ranks whose tiles cross pages, against the plain version."""
    dh, h, hk, ps, npg = 64, 4, 2, 12, 12
    q, kt_pool, v_pool, table, lengths, qs, ks, vs = _inputs(5, h, hk, dh, ps, npg, False)
    t = [torch.from_numpy(a) for a in (q, kt_pool, v_pool, table, lengths)]
    tq, tk, tv = (torch.tensor(x) for x in (qs, ks, vs))
    plain = tatt.int8_paged_decode_attention(*t, tq, tk, tv, quant_pv=quant_pv).numpy()
    qk = tatt.qk_scale(tq, tk, dh)
    for cluster in tatt.DECODE_CLUSTERS:
        _check(_paged_emulated(*t, qk, tv, quant_pv, False, cluster).numpy(), plain, quant_pv)


@pytest.mark.parametrize("b,hk,rep,dh,npg,ps", [
    (8, 32, 1, 128, 16, 128), (8, 8, 4, 128, 16, 128), (4, 32, 1, 128, 16, 128),
    (1, 8, 8, 128, 16, 128), (2, 2, 2, 64, 4, 16), (64, 8, 4, 128, 16, 128),
    (8, 32, 1, 128, 128, 16), (3, 4, 8, 64, 20, 12), (8, 8, 8, 128, 32, 128),
])
@pytest.mark.parametrize("kv4", [False, True])
def test_paged_plan_fits_and_covers(b, hk, rep, dh, npg, ps, kv4):
    """The plan is a cluster of DECODE_CLUSTERS (K3's rule on the table's NP *
    ps positions) whose block, ring (K11's of nibble tiles) and page cache
    fit its shared memory, and its ranks cover every length, an
    inactive slot's clamped to the table, exactly once, each within the
    positions a rank can hold; a rank's first position is a multiple of 16,
    so no K copy leaves its page."""
    c = tatt.paged_plan(b, hk, rep, dh, npg, ps, SMS, kv4)
    npos = npg * ps
    assert c in tatt.DECODE_CLUSTERS
    assert tatt.paged_smem_bytes(dh, rep, npg, ps, c, kv4) <= tatt.DECODE_SMEM_LIMIT
    fits = [x for x in tatt.DECODE_CLUSTERS
            if tatt.paged_smem_bytes(dh, rep, npg, ps, x, kv4) <= tatt.DECODE_SMEM_LIMIT]
    wave = [x for x in fits if b * hk * x <= tatt.DECODE_BLOCKS_PER_SM * SMS]
    assert c == (max(wave) if wave else min(fits))  # K3's rule, with the ring and the page cache
    chmax = -(-(-(-npos // c)) // tatt.DECODE_TILE) * tatt.DECODE_TILE
    for length in sorted({1, ps - 1 or 1, ps, ps + 1, npos - 1, npos, npos + 5}):
        n = min(length, npos)
        per = tatt.decode_rank_positions(n, c)
        assert per % 16 == 0 and per <= chmax and c * per >= n


def test_paged_plan_rejects_a_table_no_cluster_holds():
    """A table whose positions no cluster's shared memory holds is refused
    with K8/K11's message (K3's body keeps a rank's scores on chip)."""
    with pytest.raises(ValueError, match="K8/K11"):
        tatt.paged_plan(8, 8, 8, 128, 512, 128, SMS)
    with pytest.raises(ValueError, match="multiple of 4"):
        tatt.paged_plan(8, 8, 8, 128, 16, 10, SMS)
