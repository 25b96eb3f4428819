"""ALiBi in K2 and K3 (and K7, K3's body) held against dgq_tpu on the CPU.

The plain versions the wrappers run on CPU tensors take ``alibi_slopes`` as
JAX's kernels do: slope[h] x key position added to query head h's scaled
scores before the mask.  The plain K3 is held against JAX's
``int8_decode_attention`` in interpret mode with ``alibi_slopes`` at 1, 2, 4
and 8 query heads a kv head, both p @ V rules, lengths 1 to Smax; the plain
K2 against JAX's ``int8_prefill_attention`` in interpret mode at offsets;
both within 1e-5 of the largest output.  K2's ALiBi arithmetic on the card
(log2 units, the bias taken as slope (kpos - qpos), the online softmax and
p in two fp16 pieces) is emulated tile by tile and held within the card's
gate.  ``alibi_slopes`` equals JAX's at 4, 32, 40 and 112 heads (the
non-power-of-two branch at 40 and 112)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.models import bloom as jbloom
from dgq_tpu.ops import attention as jatt
from dgq_tpu_torch.models import bloom as tbloom
from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops import attention as tatt

LOG2E = 1.4426950408889634
BQ = BKV = 64
GATE = 3e-4  # K2's gate on the card, of the largest |output|


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, h, hk, s, dh, smax):
    r = np.random.default_rng(seed)
    q = r.integers(-127, 128, (b, h, s, dh)).astype(np.int8)
    kt = r.integers(-127, 128, (b, hk, dh, smax)).astype(np.int8)
    v = r.integers(-127, 128, (b, hk, smax, dh)).astype(np.int8)
    qs, ks, vs = (np.float32(x) for x in r.random(3) * 0.02 + 0.01)
    return q, kt, v, qs, ks, vs


@pytest.mark.parametrize("n_heads", [4, 32, 40, 112])
def test_alibi_slopes_match_jax(n_heads):
    got = tbloom.alibi_slopes(n_heads).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbloom.alibi_slopes(n_heads)))
    assert got.dtype == np.float32 and got.shape == (n_heads,)


@pytest.mark.parametrize("quant_pv", [False, True])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_k3_alibi_plain_matches_jax(rep, quant_pv):
    """The slot lengths 1, ragged and Smax; slopes of 8 heads from BLOOM's
    rule, so that late positions win (scores move by ~10 a position)."""
    b, hk, dh, smax = 3, 8 // rep, 32, 64
    h = hk * rep
    q, kt, v, qs, ks, vs = _inputs(rep + 10 * quant_pv, b, h, hk, 1, dh, smax)
    q = q[:, :, 0]
    lengths = np.array([1, 37, smax], np.int32)
    slopes = np.asarray(jbloom.alibi_slopes(h)) * 8.0
    ref = np.asarray(jatt.int8_decode_attention(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), jnp.asarray(lengths), jnp.asarray(qs),
        jnp.asarray(ks), jnp.asarray(vs), interpret=True, quant_pv=quant_pv,
        alibi_slopes=jnp.asarray(slopes)))
    args = (torch.from_numpy(q), torch.from_numpy(kt), torch.from_numpy(v),
            torch.from_numpy(lengths), torch.tensor(qs), torch.tensor(ks), torch.tensor(vs))
    _cuda.reset_launches()
    got = tatt.int8_decode_attention(*args, quant_pv=quant_pv,
                                     alibi_slopes=torch.from_numpy(slopes)).numpy()
    # K7's plain version is K3's: the ALiBi engines route past 8192 positions there
    long = tatt.int8_decode_attention_chunked(*args, chunk=smax, quant_pv=quant_pv,
                                              alibi_slopes=torch.from_numpy(slopes)).numpy()
    assert all(n == 0 for n in _cuda.LAUNCHES.values())  # CPU tensors: the plain versions
    largest = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * largest)
    np.testing.assert_array_equal(long, got)
    # the bias moves the result: not the function without it
    plain = tatt.int8_decode_attention(*args, quant_pv=quant_pv).numpy()
    assert np.abs(plain - got).max() > 1e-2 * largest


def _k2_alibi_emulated(q, kt, v, plen, qk, v_scale, q_offset, slopes):
    """(B, H, S, Dh) f32 as K2's ALiBi instantiation computes it: per 64-row
    query tile, the kv tiles up to its causal end, scores in log2 units
    s qk log2e + slope log2e (kpos - qpos) on every tile, online softmax,
    p in two fp16 pieces against fp16 V with fp32 sums."""
    b, h, s, dh = q.shape
    hk = kt.shape[1]
    neg = torch.finfo(torch.float32).min
    qkl = qk * torch.tensor(LOG2E)
    out = torch.empty((b, h, s, dh), dtype=torch.float32)
    for bi in range(b):
        for hi in range(h):
            kth, vh = kt[bi, hi // (h // hk)], v[bi, hi // (h // hk)]
            sl = slopes[hi] * torch.tensor(LOG2E)
            for t in range(s // BQ):
                qt = q[bi, hi, BQ * t:BQ * (t + 1)].to(torch.int32)
                qpos = q_offset + BQ * t + torch.arange(BQ)[:, None]
                m = torch.full((BQ, 1), neg)
                l_sum = torch.zeros((BQ, 1))
                acc = torch.zeros((BQ, dh))
                for j in range(-(-min(plen, q_offset + BQ * (t + 1)) // BKV)):
                    keys = slice(BKV * j, BKV * (j + 1))
                    kpos = BKV * j + torch.arange(BKV)[None, :]
                    x = ((qt @ kth[:, keys].to(torch.int32)).to(torch.float32) * qkl
                         + sl * (kpos - qpos).to(torch.float32))
                    x = torch.where((kpos <= qpos) & (kpos < plen), x, torch.tensor(neg))
                    m_new = torch.maximum(m, x.amax(dim=1, keepdim=True))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(x - m_new)
                    l_sum = l_sum * alpha + p.sum(dim=1, keepdim=True)
                    p_hi = p.to(torch.float16)
                    p_lo = (p - p_hi.to(torch.float32)).to(torch.float16)
                    vf = vh[keys].to(torch.float16).to(torch.float32)
                    acc = acc * alpha + (p_hi.to(torch.float32) @ vf + p_lo.to(torch.float32) @ vf)
                    m = m_new
                out[bi, hi, BQ * t:BQ * (t + 1)] = acc * (v_scale / torch.clamp(l_sum, min=1e-20))
    return out


@pytest.mark.parametrize("h,hk,s,q_offset,plen", [
    (4, 4, 64, 0, 64),      # MHA, a prompt from position 0
    (4, 2, 64, 37, 90),     # GQA, a chunk at an offset off the tile grid, padded rows
    (8, 2, 128, 64, 192),   # four query heads a kv head, two query tiles, a full cache
])
def test_k2_alibi_plain_matches_jax(h, hk, s, q_offset, plen):
    """The plain K2 with ALiBi against JAX's kernel in interpret mode within
    1e-5 of the largest output, and K2's ALiBi arithmetic (emulated) within
    the card's gate of both."""
    b, dh, smax = 2, 32, 192
    q, kt, v, qs, ks, vs = _inputs(h + hk + q_offset, b, h, hk, s, dh, smax)
    slopes = np.asarray(jbloom.alibi_slopes(h)) * 4.0
    ref = np.asarray(jatt.int8_prefill_attention(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), jnp.asarray(plen, jnp.int32),
        jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(q_offset, jnp.int32),
        bq=64, bkv=64, interpret=True, alibi_slopes=jnp.asarray(slopes)))
    tq, tkt, tv = torch.from_numpy(q), torch.from_numpy(kt), torch.from_numpy(v)
    tsl = torch.from_numpy(slopes)
    got = tatt.int8_prefill_attention(tq, tkt, tv, plen, torch.tensor(qs), torch.tensor(ks),
                                      torch.tensor(vs), q_offset, alibi_slopes=tsl).numpy()
    emu = _k2_alibi_emulated(tq, tkt, tv, plen, tatt.qk_scale(torch.tensor(qs),
                                                               torch.tensor(ks), dh),
                             torch.tensor(vs), q_offset, tsl).numpy()
    largest = np.abs(ref).max()
    rows = slice(0, plen - q_offset)  # rows past the prompt are padding, as JAX's
    np.testing.assert_allclose(got[:, :, rows], ref[:, :, rows], rtol=0, atol=1e-5 * largest)
    np.testing.assert_allclose(emu[:, :, rows], got[:, :, rows], rtol=0, atol=GATE * largest)
    # the bias moves the result
    plain = tatt.int8_prefill_attention(tq, tkt, tv, plen, torch.tensor(qs), torch.tensor(ks),
                                        torch.tensor(vs), q_offset).numpy()
    assert np.abs(plain - got).max() > 1e-2 * largest


def test_alibi_bias_layout():
    """Query head g rep + r takes slope [g, r] (JAX's reshape(hk, rep)), the
    product rounded once."""
    sl = torch.tensor([0.5, 0.25, 0.125, 0.0625])
    bias = tatt._alibi_bias(sl, 2, 2, 5, "cpu")
    assert bias.shape == (2, 2, 1, 5)
    torch.testing.assert_close(bias[1, 0, 0], 0.125 * torch.arange(5.0), rtol=0, atol=0)
