"""K2's arithmetic on the card, emulated on the CPU, against dgq_tpu.

The CUDA kernel K2 (``csrc/int8_prefill_attention.cu``) runs only on the
card.  Its arithmetic is emulated here in torch, tile by tile: the int8
score product, the mask, the online fp32 softmax with ``exp2`` of the
scaled difference, and p @ V as two fp16 pieces of p (p_hi = half(p),
p_lo = half(p - p_hi)) against V's int8 codes (exact in fp16) with fp32
sums, v_scale applied in the epilogue.  The emulation is held against
JAX's ``int8_prefill_attention`` in interpret mode and against the port's
plain version (what ``int8_prefill_attention`` runs on CPU tensors) within
the card's gate: 3e-4 of the largest output.  Dh 64 and 128, GQA (Hkv <
H), and a query window at an offset off the 64-row tile grid, with padded
rows past the prompt."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.ops import attention as jatt
from dgq_tpu_torch.ops import attention as tatt

BQ = BKV = 64  # the kernel's query and kv tiles
GATE = 3e-4    # of the largest |output|, as chip_smoke.py holds the card
LOG2E = 1.4426950408889634


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _k2_emulated(q, kt, v, plen, qk, v_scale, q_offset):
    """(B, H, S, Dh) f32 as K2 computes it: per 64-row query tile, the kv
    tiles up to its causal end, online softmax in fp32, p split into two
    fp16 pieces against fp16 V with fp32 sums."""
    b, h, s, dh = q.shape
    hk = kt.shape[1]
    neg = torch.finfo(torch.float32).min
    out = torch.empty((b, h, s, dh), dtype=torch.float32)
    for bi in range(b):
        for hi in range(h):
            kth, vh = kt[bi, hi // (h // hk)], v[bi, hi // (h // hk)]
            for t in range(s // BQ):
                qt = q[bi, hi, BQ * t:BQ * (t + 1)].to(torch.int32)
                qpos = q_offset + BQ * t + torch.arange(BQ)[:, None]
                m = torch.full((BQ, 1), neg)
                l_sum = torch.zeros((BQ, 1))
                acc = torch.zeros((BQ, dh))
                nkv = -(-min(plen, q_offset + BQ * (t + 1)) // BKV)
                for j in range(nkv):
                    keys = slice(BKV * j, BKV * (j + 1))
                    s32 = qt @ kth[:, keys].to(torch.int32)
                    x = s32.to(torch.float32) * qk
                    kpos = BKV * j + torch.arange(BKV)[None, :]
                    x = torch.where((kpos <= qpos) & (kpos < plen), x, torch.tensor(neg))
                    m_new = torch.maximum(m, x.amax(dim=1, keepdim=True))
                    alpha = torch.exp2((m - m_new) * LOG2E)
                    p = torch.exp2((x - m_new) * LOG2E)
                    l_sum = l_sum * alpha + p.sum(dim=1, keepdim=True)
                    p_hi = p.to(torch.float16)
                    p_lo = (p - p_hi.to(torch.float32)).to(torch.float16)
                    vf = vh[keys].to(torch.float16).to(torch.float32)
                    acc = acc * alpha + (p_hi.to(torch.float32) @ vf + p_lo.to(torch.float32) @ vf)
                    m = m_new
                out[bi, hi, BQ * t:BQ * (t + 1)] = acc * (v_scale / torch.clamp(l_sum, min=1e-20))
    return out


def _inputs(seed, b, h, hk, s, dh, smax):
    r = np.random.default_rng(seed)
    q = r.integers(-127, 128, (b, h, s, dh)).astype(np.int8)
    kt = r.integers(-127, 128, (b, hk, dh, smax)).astype(np.int8)
    v = r.integers(-127, 128, (b, hk, smax, dh)).astype(np.int8)
    # scales as the engine's calibration gives them: scores of a few units
    qs, ks, vs = (np.float32(x) for x in r.random(3) * 0.02 + 0.01)
    return q, kt, v, qs, ks, vs


@pytest.mark.parametrize("dh,h,hk,s,q_offset,plen", [
    (128, 4, 4, 128, 0, 128),   # MHA, prefill from position 0
    (128, 4, 2, 128, 37, 150),  # GQA, a chunk at an offset off the tile grid, padded rows
    (64, 4, 1, 192, 5, 190),    # Dh 64, four query heads a kv head
])
def test_k2_emulation_matches_jax_and_plain(dh, h, hk, s, q_offset, plen):
    b, smax = 2, 256
    q, kt, v, qs, ks, vs = _inputs(dh + hk + q_offset, b, h, hk, s, dh, smax)
    ref_j = np.asarray(jatt.int8_prefill_attention(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), jnp.asarray(plen, jnp.int32),
        jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(q_offset, jnp.int32),
        bq=64, bkv=64, interpret=True))
    tq, tkt, tv = torch.from_numpy(q), torch.from_numpy(kt), torch.from_numpy(v)
    qk = tatt.qk_scale(torch.tensor(qs), torch.tensor(ks), dh)
    plain = tatt.int8_prefill_attention(tq, tkt, tv, plen, torch.tensor(qs), torch.tensor(ks),
                                        torch.tensor(vs), q_offset).numpy()
    emu = _k2_emulated(tq, tkt, tv, plen, qk, torch.tensor(vs), q_offset).numpy()
    largest = np.abs(ref_j).max()
    assert largest > 0
    np.testing.assert_allclose(plain, ref_j, rtol=0, atol=1e-5 * largest)
    np.testing.assert_allclose(emu, ref_j, rtol=0, atol=GATE * largest)
    np.testing.assert_allclose(emu, plain, rtol=0, atol=GATE * largest)
    # far inside the gate: the split leaves ~2^-22 of each product
    assert np.abs(emu - plain).max() < 1e-5 * largest


def test_k2_p_split_error_bound():
    """p_hi + p_lo is p to 2^-22 relative where p_lo is a normal fp16, and
    to 2^-25 absolute below (fp16 subnormals), over p in (0, 1]."""
    p = torch.cat([torch.rand(200000), torch.logspace(-12, 0, 20000, base=2.0),
                   torch.tensor([1.0, 2.0 ** -14, 2.0 ** -24])])
    hi = p.to(torch.float16).to(torch.float32)
    lo = (p - hi).to(torch.float16).to(torch.float32)
    err = (p - (hi + lo)).abs()
    assert torch.all(err <= torch.maximum(p * 2.0 ** -22, torch.tensor(2.0 ** -25)))
    # a single fp16 piece would not do
    assert (p - hi).abs().max() > 2.0 ** -13
