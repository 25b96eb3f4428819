"""dgq_tpu_torch's fused decode kernels K4-K6 held against dgq_tpu on the CPU.

On CPU tensors each wrapper (``fused_norm_gemv_rp``,
``fused_requant_gemv_rp``, ``fused_mlp_decode_rp``) runs its plain PyTorch
version; these tests hold that against the Pallas kernels in interpret mode
on the same numpy inputs (the JAX side taking ``cs_fold`` from
``rowpair_cs_fold``), and the port's int8 codes against JAX's.  Tolerances
are those of tests/test_fused_decode.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.ops import fused_decode as jfd
from dgq_tpu.quant.packing import pack_nibbles
from dgq_tpu_torch.ops import fused_decode as tfd

SPAN, GS = 256, 128
D, N, F = 256, 512, 1024


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them (the
    port's CPU paths ran ~10x slower beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mk(k, n, seed):
    """Rowpair weights of a (k, n) linear for both packages: (jax args, port
    args) = (qw_rp, s_hi, s_lo, z_hi, z_lo, cs_fold, alpha), plus the
    8x-replicated scales and zeros."""
    r = np.random.default_rng(seed)
    codes = r.integers(0, 16, size=(k, n)).astype(np.int8)
    qw = pack_nibbles(jnp.asarray(codes), span=SPAN)
    sc = r.integers(1, 4, size=(k // GS, n)).astype(np.int8)
    zr = r.integers(0, 16, size=(k // GS, n)).astype(np.int8)
    al = (r.random(n) * 0.01).astype(np.float32)
    planes = (sc[0::2], sc[1::2], zr[0::2], zr[1::2])
    qw_rp = np.asarray(jfd.pack_rowpair_s4(qw, SPAN))
    csf = np.asarray(jfd.rowpair_cs_fold(qw, SPAN, jnp.asarray(planes[0]),
                                         jnp.asarray(planes[1])))
    arrays = (qw_rp, *planes, csf, al)
    repl = (np.repeat(sc, 8, 0), np.repeat(zr, 8, 0))
    return ([jnp.asarray(a) for a in arrays], [_t(a) for a in arrays],
            [jnp.asarray(a) for a in repl], [_t(a) for a in repl])


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    m = 5
    x = (rng.normal(size=(m, D)) * 3).astype(np.float32)
    lnw = (rng.random(D) + 0.5).astype(np.float32) * 20
    lnb = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    beta = rng.normal(size=(N,)).astype(np.float32)
    resid = rng.normal(size=(m, N)).astype(np.float32)
    return x, lnw, lnb, beta, resid


@pytest.mark.parametrize("with_bias", [True, False])
def test_k4_plain_matches_jax_kernel(rows, with_bias):
    x, lnw, lnb, beta, _ = rows
    lnb = lnb if with_bias else None
    jw, tw, _, _ = _mk(D, N, 1)
    eps = 1e-5
    ref = np.asarray(jfd.fused_norm_gemv_rp(
        jnp.asarray(x), jnp.asarray(lnw), None if lnb is None else jnp.asarray(lnb), *jw,
        jnp.asarray(beta), span=SPAN, bn=256, eps=eps, interpret=True))
    got = tfd.fused_norm_gemv_rp(_t(x), _t(lnw), None if lnb is None else _t(lnb), *tw,
                                 _t(beta), span=SPAN, eps=eps).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    codes_j = np.asarray(jfd._rmsnorm_q(jnp.asarray(x), jnp.asarray(lnw)[None],
                                        0.0 if lnb is None else jnp.asarray(lnb)[None], eps))
    codes_t = tfd._rmsnorm_q(_t(x), _t(lnw), None if lnb is None else _t(lnb), eps).numpy()
    np.testing.assert_array_equal(codes_t, codes_j)
    assert len(np.unique(codes_t)) > 100  # the codes span the int8 range


@pytest.mark.parametrize("fuse_residual", [True, False])
def test_k5_plain_matches_jax_kernel(rows, fuse_residual):
    x, _, _, beta, resid = rows
    jw, tw, _, _ = _mk(D, N, 2)
    scale = np.float32(0.07)
    res_j = jnp.asarray(resid) if fuse_residual else None
    res_t = _t(resid) if fuse_residual else None
    ref = np.asarray(jfd.fused_requant_gemv_rp(
        jnp.asarray(x), jnp.asarray(scale), *jw, jnp.asarray(beta), res_j, span=SPAN, bn=256,
        qmin=-127.0, fuse_residual=fuse_residual, interpret=True))
    got = tfd.fused_requant_gemv_rp(_t(x), torch.tensor(scale), *tw, _t(beta), res_t,
                                    span=SPAN, qmin=-127.0,
                                    fuse_residual=fuse_residual).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    codes_j = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / scale), -127.0, 127.0))
    codes_t = tfd._requant_q(_t(x), torch.tensor(scale), -127.0).numpy()
    np.testing.assert_array_equal(codes_t, codes_j.astype(np.int8))


@pytest.mark.parametrize("fuse_residual", [True, False])
def test_k6_plain_matches_jax_kernel(rows, fuse_residual):
    x, lnw, lnb, _, _ = rows
    jg, tg, _, _ = _mk(D, 2 * F, 3)
    jd, td, jrep, trep = _mk(F, D, 4)
    hscale = np.float32(0.05)
    dbias = (np.random.default_rng(5).normal(size=(D,)) * 0.1).astype(np.float32)
    eps = 1e-5
    ref = np.asarray(jfd.fused_mlp_decode_rp(
        jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb), *jg, jnp.asarray(hscale), jd[0],
        *jrep, jd[5], jd[6], jnp.asarray(dbias), span=SPAN, bf=512, eps=eps,
        fuse_residual=fuse_residual, interpret=True))
    got = tfd.fused_mlp_decode_rp(_t(x), _t(lnw), _t(lnb), *tg, torch.tensor(hscale), td[0],
                                  *trep, td[5], td[6], _t(dbias), span=SPAN, bf=512, eps=eps,
                                  fuse_residual=fuse_residual).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)

    # the down-proj input codes: JAX's SiLU * up rule on the same int32 gate/up
    xq = tfd._rmsnorm_q(_t(x), _t(lnw), _t(lnb), eps)
    gu = tfd._plane_product(xq, *tg[:5], GS)
    g32, u32 = gu[:, :F].numpy(), gu[:, F:].numpy()
    g = jnp.asarray(g32).astype(jnp.float32) * jg[6][:F]
    u = jnp.asarray(u32).astype(jnp.float32) * jg[6][F:]
    h = (g * jax.nn.sigmoid(g)) * u
    h_j = np.asarray(jnp.clip(jnp.round(h / hscale), -128.0, 127.0)).astype(np.int8)
    h_t = tfd._silu_mul_q(gu[:, :F], gu[:, F:], tg[6][:F], tg[6][F:],
                          torch.tensor(hscale)).numpy()
    np.testing.assert_array_equal(h_t, h_j)
    assert len(np.unique(h_t)) > 100


def test_plain_versions_take_forced_codes(rows):
    """``codes`` replaces a plain version's own codes (the card's parity
    check continues the plain run from the kernel's codes)."""
    x, lnw, lnb, beta, resid = rows
    _, tw, _, _ = _mk(D, N, 6)
    codes = torch.from_numpy(np.random.default_rng(7).integers(-128, 128, (5, D)).astype(np.int8))
    want = tfd._epilogue(tfd._plane_product(codes, *tw[:5], GS), tw[6], _t(beta), None)
    got = tfd.fused_norm_gemv_rp_xla(_t(x), _t(lnw), _t(lnb), *tw, _t(beta), codes=codes)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = tfd.fused_requant_gemv_rp_xla(_t(x), torch.tensor(0.1), *tw, _t(beta), _t(resid),
                                        codes=codes)
    torch.testing.assert_close(got, want + _t(resid), rtol=0, atol=0)
    _, tg, _, _ = _mk(D, 2 * F, 8)
    _, td, _, trep = _mk(F, D, 9)
    h = torch.from_numpy(np.random.default_rng(10).integers(-128, 128, (5, F)).astype(np.int8))
    from dgq_tpu_torch.ops.quant_matmul import dequantize_rowpair, int_matmul

    want = int_matmul(h, dequantize_rowpair(td[0], trep[0][::8], trep[1][::8], GS)).float()
    got = tfd.fused_mlp_decode_rp_xla(_t(x), _t(lnw), None, *tg, torch.tensor(0.05), td[0],
                                      *trep, td[5], torch.ones(D), None, fuse_residual=False,
                                      codes=(codes, h))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_check_shapes(rows):
    x, lnw, lnb, beta, _ = rows
    _, tw, _, _ = _mk(D, N, 1)
    with pytest.raises(ValueError, match="cs_fold"):
        tfd.fused_norm_gemv_rp(_t(x), _t(lnw), None, *tw[:5], tw[5][:-1], tw[6])
    with pytest.raises(ValueError, match="1 to 64 rows"):
        tfd.fused_norm_gemv_rp(torch.zeros((65, D)), _t(lnw), None, *tw)
    with pytest.raises(ValueError, match="residual"):
        tfd.fused_requant_gemv_rp(_t(x), torch.tensor(0.1), *tw)
