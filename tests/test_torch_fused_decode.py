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


# --------------------------------------------------------------------------
# K12 (span weights) and K13's names, at tests/test_fused_decode.py's shapes
# --------------------------------------------------------------------------

KD, KN, KF, KB = 512, 768, 1024, 2


def _mk_span(k, n, gs, seed):
    """Span weights of a (k, n) linear: (jax args, port args) = (qweight,
    s_hi, s_lo, z_hi, z_lo, alpha), the 8x-replicated scales and zeros (port),
    and the port's rowpair args (qw_rp, planes, cs_fold) of the same codes."""
    r = np.random.default_rng(seed)
    codes = r.integers(0, 16, size=(k, n)).astype(np.int8)
    qw = np.asarray(pack_nibbles(jnp.asarray(codes), span=2 * gs))
    sc = r.integers(1, 4, size=(k // gs, n)).astype(np.int8)
    zr = r.integers(0, 16, size=(k // gs, n)).astype(np.int8)
    al = (r.random(n) * 0.01).astype(np.float32)
    arrays = (qw, sc[0::2], sc[1::2], zr[0::2], zr[1::2], al)
    tq = _t(qw)
    rp = (tfd.pack_rowpair_s4(tq, 2 * gs), *[_t(a) for a in arrays[1:5]],
          tfd.rowpair_cs_fold(tq, 2 * gs, _t(sc[0::2]), _t(sc[1::2])))
    repl = (_t(np.repeat(sc, 8, 0)), _t(np.repeat(zr, 8, 0)))
    return [jnp.asarray(a) for a in arrays], [_t(a) for a in arrays], repl, rp


@pytest.mark.parametrize("gs", [32, 64, 128, 96])
def test_span_stage_map_names_every_k_once(gs):
    """``span_stage_map``, the order of k in K12's stages of 64 packed rows
    (``FusedSpan`` in csrc/fused_gemv_sm90.cuh), over every stage of K: its
    32-k runs name each logical k once; each run's codes are nibble h of its
    32 packed rows, as JAX's ``pack_nibbles`` put them there and the port's
    ``unpack_nibbles`` reads them; and its group and plane row give the
    scale and zero that ``dequantize_span`` applies to those k."""
    from dgq_tpu_torch.ops.quant_matmul import dequantize_span
    from dgq_tpu_torch.quant.packing import unpack_nibbles

    k, n = 768, 64
    r = np.random.default_rng(gs)
    codes = r.integers(0, 16, size=(k, n)).astype(np.int8)
    qw = _t(np.asarray(pack_nibbles(jnp.asarray(codes), span=2 * gs)))
    sc = _t(r.integers(1, 4, size=(k // gs, n)).astype(np.int8))
    zr = _t(r.integers(0, 16, size=(k // gs, n)).astype(np.int8))
    planes = {0: (sc[0::2], zr[0::2]), 1: (sc[1::2], zr[1::2])}  # (s, z) of s_hi/z_hi, s_lo/z_lo
    w8 = dequantize_span(qw, sc, zr, gs).to(torch.int32)
    unpacked = unpack_nibbles(qw, 2 * gs)
    byte = qw.view(torch.uint8).to(torch.int32)
    seen = []
    for st in range(k // 128):
        stage = tfd.span_stage_map(st, gs)
        assert sorted(stage) == [(0, 0), (0, 1), (1, 0), (1, 1)]
        for (kk, h), (k0, group, row) in stage.items():
            ks = list(range(k0, k0 + 32))
            seen += ks
            rows = byte[64 * st + 32 * kk: 64 * st + 32 * kk + 32]
            nib = (rows >> 4) if h == 0 else (rows & 0xF)
            assert torch.equal(nib, _t(codes[k0:k0 + 32]).to(torch.int32))
            assert torch.equal(unpacked[k0:k0 + 32].to(torch.int32), nib)
            assert all(kx // gs == group for kx in ks) and group % 2 == h and row == group // 2
            s_row, z_row = (p[row].to(torch.int32) for p in planes[h])
            assert torch.equal(w8[k0:k0 + 32], ((nib - z_row) * s_row).to(torch.int8).int())
    assert sorted(seen) == list(range(k))


@pytest.fixture(scope="module")
def span_rows():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(KB, KD)) * 3).astype(np.float32)
    lnw = (rng.random(KD) + 0.5).astype(np.float32)
    lnb = (rng.normal(size=(KD,)) * 0.1).astype(np.float32)
    beta = rng.normal(size=(KN,)).astype(np.float32)
    resid = rng.normal(size=(KB, KN)).astype(np.float32)
    return x, lnw, lnb, beta, resid


def _close_to_largest(got, ref):
    """Within 1e-6 of the largest |output| (JAX's interpret mode may fuse the
    epilogue's multiply and add)."""
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("gs", [64, 128])
def test_k12_norm_requant_plain_match_jax_kernel(span_rows, gs):
    """K12's first two plain versions against JAX's kernels in interpret
    mode: the int32 accumulators (alpha 1, no beta) equal, the outputs
    within 1e-6 of the largest; and the accumulators equal K4/K5's plain
    versions on pack_rowpair_s4 of the same weights."""
    x, lnw, lnb, beta, resid = span_rows
    jw, tw, _, rp = _mk_span(KD, KN, gs, 11 + gs)
    one_j, one_t = jnp.ones((KN,), jnp.float32), torch.ones(KN)
    span, eps, scale = 2 * gs, 1e-6, np.float32(0.07)
    acc_j = np.asarray(jfd.fused_norm_gemv(jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb),
                                           *jw[:5], one_j, span=span, bn=256, eps=eps,
                                           interpret=True))
    acc_t = tfd.fused_norm_gemv(_t(x), _t(lnw), _t(lnb), *tw[:5], one_t, span=span, eps=eps)
    np.testing.assert_array_equal(acc_t.numpy(), acc_j)
    assert np.abs(acc_j).max() > 100 and np.all(acc_j == np.round(acc_j))
    rp_acc = tfd.fused_norm_gemv_rp(_t(x), _t(lnw), _t(lnb), *rp, one_t, span=span, eps=eps)
    assert torch.equal(acc_t, rp_acc)
    y_j = np.asarray(jfd.fused_norm_gemv(jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb),
                                         *jw, jnp.asarray(beta), span=span, bn=256, eps=eps,
                                         interpret=True))
    _close_to_largest(tfd.fused_norm_gemv(_t(x), _t(lnw), _t(lnb), *tw, _t(beta), span=span,
                                          eps=eps).numpy(), y_j)

    acc_j = np.asarray(jfd.fused_requant_gemv(jnp.asarray(x), jnp.asarray(scale), *jw[:5], one_j,
                                              span=span, bn=256, fuse_residual=False,
                                              interpret=True))
    acc_t = tfd.fused_requant_gemv(_t(x), torch.tensor(scale), *tw[:5], one_t, span=span,
                                   fuse_residual=False)
    np.testing.assert_array_equal(acc_t.numpy(), acc_j)
    rp_acc = tfd.fused_requant_gemv_rp(_t(x), torch.tensor(scale), *rp, one_t, span=span,
                                       fuse_residual=False)
    assert torch.equal(acc_t, rp_acc)
    for fuse in (True, False):
        y_j = np.asarray(jfd.fused_requant_gemv(
            jnp.asarray(x), jnp.asarray(scale), *jw, jnp.asarray(beta),
            jnp.asarray(resid) if fuse else None, span=span, bn=256, qmin=-127.0,
            fuse_residual=fuse, interpret=True))
        y_t = tfd.fused_requant_gemv(_t(x), torch.tensor(scale), *tw, _t(beta),
                                     _t(resid) if fuse else None, span=span, qmin=-127.0,
                                     fuse_residual=fuse)
        _close_to_largest(y_t.numpy(), y_j)


@pytest.mark.parametrize("gs", [64, 128])
def test_k12_mlp_plain_matches_jax_kernel(span_rows, gs):
    """K12's MLP plain version against JAX's kernel in interpret mode (down
    accumulators equal with alpha 1; outputs within 1e-6 of the largest, the
    residual on and off), and its accumulators against K6's plain version on
    pack_rowpair_s4 of the same weights; its down-input codes span the int8
    range."""
    x, lnw, lnb, _, _ = span_rows
    jg, tg, _, rpg = _mk_span(KD, 2 * KF, gs, 21 + gs)
    jd, td, trep, rpd = _mk_span(KF, KD, gs, 31 + gs)
    span, eps, hscale = 2 * gs, 1e-6, np.float32(0.05)
    jrep = [jnp.asarray(a.numpy()) for a in trep]
    one = np.ones((KD,), np.float32)

    def jax_mlp(alpha, fuse):
        return np.asarray(jfd.fused_mlp_decode(
            jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb), *jg, jnp.asarray(hscale), jd[0],
            *jrep, jnp.asarray(alpha), None, span=span, bf=512, eps=eps, fuse_residual=fuse,
            interpret=True))

    def port_mlp(alpha, fuse, codes_out=None):
        return tfd.fused_mlp_decode(_t(x), _t(lnw), _t(lnb), *tg, torch.tensor(hscale), td[0],
                                    *trep, _t(alpha), None, span=span, bf=512, eps=eps,
                                    fuse_residual=fuse, codes_out=codes_out)

    h = torch.empty((KB, KF), dtype=torch.int8)
    acc_t = port_mlp(one, False, (torch.empty((KB, KD), dtype=torch.int8), h))
    np.testing.assert_array_equal(acc_t.numpy(), jax_mlp(one, False))
    assert len(np.unique(h.numpy())) > 100
    rp_acc = tfd.fused_mlp_decode_rp(_t(x), _t(lnw), _t(lnb), *rpg, tg[5],
                                     torch.tensor(hscale), rpd[0], *trep, rpd[5], torch.ones(KD),
                                     span=span, bf=512, eps=eps, fuse_residual=False)
    assert torch.equal(acc_t, rp_acc)
    for fuse in (True, False):
        _close_to_largest(port_mlp(jd[5], fuse).numpy(), jax_mlp(np.asarray(jd[5]), fuse))


def test_k12_plain_versions_take_forced_codes(span_rows):
    """``codes`` replaces a K12 plain version's own codes, as K4-K6's."""
    x, lnw, lnb, beta, resid = span_rows
    gs = 128
    _, tw, _, _ = _mk_span(KD, KN, gs, 41)
    codes = torch.from_numpy(np.random.default_rng(7).integers(-128, 128, (KB, KD)).astype(
        np.int8))
    want = tfd._epilogue(tfd._span_product(codes, *tw[:5], gs), tw[5], _t(beta), None)
    got = tfd.fused_norm_gemv_xla(_t(x), _t(lnw), _t(lnb), *tw, _t(beta), codes=codes)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = tfd.fused_requant_gemv_xla(_t(x), torch.tensor(0.1), *tw, _t(beta), _t(resid),
                                     codes=codes)
    torch.testing.assert_close(got, want + _t(resid), rtol=0, atol=0)


@pytest.mark.parametrize("span", [128, 256])
def test_k13_names_and_plane_colsums_match_jax(span_rows, span):
    """plane_colsums equals JAX's; the K13 names equal K12 (they run it) and
    JAX's K13 kernels in interpret mode, with the colsums passed or not;
    wrong colsum shapes are refused."""
    x, lnw, lnb, beta, resid = span_rows
    gs = span // 2
    jw, tw, _, _ = _mk_span(KD, KN, gs, 51 + gs)
    csh_j, csl_j = jfd.plane_colsums(jw[0], span)
    csh, csl = tfd.plane_colsums(tw[0], span)
    assert csh.dtype == torch.int32 and csh.shape == (KD // span, KN)
    np.testing.assert_array_equal(csh.numpy(), np.asarray(csh_j))
    np.testing.assert_array_equal(csl.numpy(), np.asarray(csl_j))
    scale = np.float32(0.07)
    for cs in ((csh, csl), (None, None)):
        got = tfd.fused_norm_gemv_s4(_t(x), _t(lnw), _t(lnb), *tw, _t(beta), *cs, span=span)
        assert torch.equal(got, tfd.fused_norm_gemv(_t(x), _t(lnw), _t(lnb), *tw, _t(beta),
                                                    span=span))
        want = np.asarray(jfd.fused_norm_gemv_s4(
            jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb), *jw, jnp.asarray(beta), csh_j,
            csl_j, span=span, bn=256, interpret=True))
        _close_to_largest(got.numpy(), want)
        got = tfd.fused_requant_gemv_s4(_t(x), torch.tensor(scale), *tw, _t(beta), _t(resid),
                                        *cs, span=span)
        assert torch.equal(got, tfd.fused_requant_gemv(_t(x), torch.tensor(scale), *tw,
                                                       _t(beta), _t(resid), span=span))
        want = np.asarray(jfd.fused_requant_gemv_s4(
            jnp.asarray(x), jnp.asarray(scale), *jw, jnp.asarray(beta), jnp.asarray(resid),
            csh_j, csl_j, span=span, bn=256, interpret=True))
        _close_to_largest(got.numpy(), want)
    with pytest.raises(ValueError, match="csum_hi"):
        tfd.fused_norm_gemv_s4(_t(x), _t(lnw), None, *tw, None, csh[:-1], csl, span=span)


def test_k12_wrappers_check_shapes(span_rows):
    x, lnw, _, _, _ = span_rows
    _, tw, _, _ = _mk_span(KD, KN, 128, 61)
    with pytest.raises(ValueError, match="plane rows"):
        tfd.fused_norm_gemv(_t(x), _t(lnw), None, tw[0], tw[1][:-1], *tw[2:])
    with pytest.raises(ValueError, match="1 to 64 rows"):
        tfd.fused_norm_gemv(torch.zeros((65, KD)), _t(lnw), None, *tw)
    with pytest.raises(ValueError, match="residual"):
        tfd.fused_requant_gemv(_t(x), torch.tensor(0.1), *tw)
    with pytest.raises(ValueError, match="shapes"):  # K not a multiple of the span
        tfd.fused_norm_gemv(torch.zeros((1, 384)), torch.ones(384), None,
                            torch.zeros((192, KN), dtype=torch.int8), *tw[1:], span=256)
