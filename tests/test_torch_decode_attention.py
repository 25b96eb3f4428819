"""K3's arithmetic on the card, emulated on the CPU, against dgq_tpu.

The CUDA kernel K3 (``csrc/int8_decode_attention.cu``) runs only on the
card.  It spreads each (slot, kv head) over a cluster of blocks: rank r
takes a contiguous share of the valid positions (``decode_rank_positions``),
scores it in int32, and the cluster takes the row max from the ranks'
maxima; each rank then makes its codes against that global max (or its fp32
exp-weights without quant_pv), its exp sum and its p @ V sums (int32 under
quant_pv), and rank 0 adds the ranks' sums in rank order.  That arithmetic
is emulated here rank by rank and held against JAX's
``int8_decode_attention`` in interpret mode and against the port's plain
version (what ``int8_decode_attention`` runs on CPU tensors) within K3's
gates on the card: a relative L2 error under 1e-3 with quant_pv (an exp
rounded otherwise may move a code by one), else rtol = atol = 2e-4.  Heads
rep 1 and 4, Dh 64 and 128, lengths 1, ragged and Smax, every cluster size
and the plan's.  The plan itself is held at the engine's shapes: its
cluster fits a block's shared memory and tiles the positions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.ops import attention as jatt
from dgq_tpu_torch.ops import attention as tatt

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


def _k3_emulated(q, kt, v, lengths, qk, v_scale, quant_pv, cluster):
    """(B, H, Dh) f32 as K3 computes it, rank by rank of each cluster."""
    b, h, dh = q.shape
    hk = kt.shape[1]
    rep = h // hk
    vs127 = v_scale / torch.tensor(127.0)
    out = torch.empty((b, h, dh), dtype=torch.float32)
    for bi in range(b):
        n_valid = int(lengths[bi])
        per = tatt.decode_rank_positions(n_valid, cluster)
        spans = [(r * per, min((r + 1) * per, n_valid)) for r in range(cluster)]
        for g in range(hk):
            qg = q[bi, g * rep:(g + 1) * rep].to(torch.int32)
            scores = [(qg @ kt[bi, g, :, p0:p1].to(torch.int32)).to(torch.float32) * qk
                      for p0, p1 in spans]  # empty for a rank past the length
            m = torch.full((rep,), NEG)
            for s in scores:  # the cluster's max of the ranks' maxima
                if s.shape[1]:
                    m = torch.maximum(m, s.amax(dim=1))
            acc = torch.zeros((rep, dh), dtype=torch.int32 if quant_pv else torch.float32)
            den = torch.zeros((rep,))
            for (p0, p1), s in zip(spans, scores):  # rank order
                e = torch.exp(s - m[:, None])
                den = den + e.sum(dim=1)
                vr = v[bi, g, p0:p1]
                if quant_pv:
                    acc = acc + tatt._quantize_exp(e).to(torch.int32) @ vr.to(torch.int32)
                else:
                    acc = acc + e @ (vr.to(torch.float32) * v_scale)
            if quant_pv:
                out[bi, g * rep:(g + 1) * rep] = acc.to(torch.float32) * (vs127 / den[:, None])
            else:
                out[bi, g * rep:(g + 1) * rep] = acc / den[:, None]
    return out


def _inputs(seed, b, h, hk, dh, smax):
    r = np.random.default_rng(seed)
    q = r.integers(-127, 128, (b, h, dh)).astype(np.int8)
    kt = r.integers(-127, 128, (b, hk, dh, smax)).astype(np.int8)
    v = r.integers(-127, 128, (b, hk, smax, dh)).astype(np.int8)
    # scales as the engine's calibration gives them: scores of a few units
    qs, ks, vs = (np.float32(x) for x in r.random(3) * 0.02 + 0.01)
    return q, kt, v, qs, ks, vs


def _check(got, ref, quant_pv):
    if quant_pv:
        rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        assert rel < 1e-3, rel
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("quant_pv", [True, False])
@pytest.mark.parametrize("dh,h,hk,smax,lengths", [
    (128, 4, 4, 256, (1, 77, 256)),     # MHA: one position, ragged, the whole cache
    (128, 8, 2, 320, (320, 131, 1)),    # rep 4, a length off the rank grid
    (64, 4, 1, 192, (5, 190, 64)),      # Dh 64, rep 4
])
def test_k3_emulation_matches_jax_and_plain(dh, h, hk, smax, lengths, quant_pv):
    b = len(lengths)
    q, kt, v, qs, ks, vs = _inputs(dh + h + smax, b, h, hk, dh, smax)
    lens = np.asarray(lengths, np.int32)
    ref = np.asarray(jatt.int8_decode_attention(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), jnp.asarray(lens), jnp.float32(qs),
        jnp.float32(ks), jnp.float32(vs), quant_pv=quant_pv, interpret=True))
    t = [torch.from_numpy(a) for a in (q, kt, v)]
    tq, tk, tv = (torch.tensor(x) for x in (qs, ks, vs))
    plain = tatt.int8_decode_attention(*t, torch.from_numpy(lens), tq, tk, tv,
                                       quant_pv=quant_pv).numpy()
    _check(plain, ref, quant_pv)
    qk = tatt.qk_scale(tq, tk, dh)
    plan = tatt.decode_plan(b, hk, h // hk, dh, smax, SMS)
    for cluster in sorted({*tatt.DECODE_CLUSTERS, plan}):
        got = _k3_emulated(*t, lens, qk, tv, quant_pv, cluster).numpy()
        _check(got, ref, quant_pv)
        _check(got, plain, quant_pv)


@pytest.mark.parametrize("b,hk,rep,dh", [(4, 32, 1, 128), (8, 32, 1, 128), (4, 8, 4, 128),
                                         (1, 8, 8, 128), (2, 2, 2, 64), (64, 8, 4, 128)])
@pytest.mark.parametrize("smax", [16, 64, 2048, 2052, 8192])
def test_decode_plan_fits_and_tiles(b, hk, rep, dh, smax):
    """The plan's cluster (at least 2) fits a block's shared memory, fills at
    most DECODE_BLOCKS_PER_SM blocks an SM where any cluster does, and its
    ranks cover every valid length exactly once, each within the positions
    a rank can hold."""
    c = tatt.decode_plan(b, hk, rep, dh, smax, SMS)
    assert c in tatt.DECODE_CLUSTERS and c >= 2
    assert tatt.decode_smem_bytes(dh, rep, smax, c) <= tatt.DECODE_SMEM_LIMIT
    if b * hk * c > tatt.DECODE_BLOCKS_PER_SM * SMS:
        assert c == min(x for x in tatt.DECODE_CLUSTERS
                        if tatt.decode_smem_bytes(dh, rep, smax, x) <= tatt.DECODE_SMEM_LIMIT)
    chmax = -(-(-(-smax // c)) // tatt.DECODE_TILE) * tatt.DECODE_TILE
    for n in sorted({1, 2, 15, 16, 17, smax // 3 or 1, smax - 1 or 1, smax}):
        per = tatt.decode_rank_positions(n, c)
        assert per % 16 == 0 and per <= chmax
        assert c * per >= n  # ranks 0 .. c - 1 cover [0, n), the ones past n empty
