"""K6 as the card runs it, two legs under ``mlp_plan``, held on the CPU.

On the card ``fused_mlp_decode_rp`` (``csrc/fused_mlp_decode_rp.cu``) runs
the LLaMA MLP as two legs on the TMA + wgmma loop of K4 and K5: the gate|up
product with the RMSNormQ codes and the SiLU codes h, then the down product
of h, each leg's K split into ranges of whole 128-k stages by its plan
(``mlp_plan`` in ``dgq_tpu_torch/ops/fused_decode.py``) and the int32
partials of the splits summed in split order.  Here that decomposition is
run in torch for every split either leg can take, at the CPU tests' widths,
and held against JAX's ``fused_mlp_decode_rp`` in interpret mode: leg 1's h
codes equal ``_silu_mul_q`` of the unsplit gate/up sums (and the codes the
plain version hands out), leg 2's partials summed in split order equal the
unsplit int32 product, and the output equals the plain version's and JAX's
within tests/test_torch_fused_decode.py's tolerance.  Then the plan itself,
in the manner of tests/test_torch_fused_plan.py, at LLaMA-2-7B's MLP and the
tests' widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.ops import fused_decode as jfd
from dgq_tpu.quant.packing import pack_nibbles
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.ops import fused_decode as tfd
from dgq_tpu_torch.ops.quant_matmul import dequantize_rowpair, int_matmul

SPAN, GS = 256, 128
D, F, M = 256, 1024, 5
SMS = 132


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(k, n, seed):
    """Rowpair weights of a (k, n) linear for both packages: (jax, port) =
    (qw_rp, s_hi, s_lo, z_hi, z_lo, cs_fold, alpha), and the 8x-replicated
    scales and zeros of each."""
    r = np.random.default_rng(seed)
    qw = pack_nibbles(jnp.asarray(r.integers(0, 16, size=(k, n)).astype(np.int8)), span=SPAN)
    sc = r.integers(1, 4, size=(k // GS, n)).astype(np.int8)
    zr = r.integers(0, 16, size=(k // GS, n)).astype(np.int8)
    planes = (sc[0::2], sc[1::2], zr[0::2], zr[1::2])
    csf = np.asarray(jfd.rowpair_cs_fold(qw, SPAN, *map(jnp.asarray, planes[:2])))
    arrays = (np.asarray(jfd.pack_rowpair_s4(qw, SPAN)), *planes, csf,
              (r.random(n) * 0.01).astype(np.float32))
    repl = (np.repeat(sc, 8, 0), np.repeat(zr, 8, 0))
    return ([jnp.asarray(a) for a in arrays], [_t(a) for a in arrays],
            [jnp.asarray(a) for a in repl], [_t(a) for a in repl])


@pytest.fixture(scope="module")
def mlp():
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(M, D)) * 3).astype(np.float32)
    lnw = (rng.random(D) + 0.5).astype(np.float32) * 20
    lnb = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    dbias = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    jg, tg, _, _ = _weights(D, 2 * F, 12)
    jd, td, jrep, trep = _weights(F, D, 13)
    hscale = np.float32(0.05)
    eps = 1e-5
    ref = np.asarray(jfd.fused_mlp_decode_rp(
        jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb), *jg, jnp.asarray(hscale), jd[0],
        *jrep, jd[5], jd[6], jnp.asarray(dbias), span=SPAN, bf=512, eps=eps,
        fuse_residual=True, interpret=True))
    return dict(x=_t(x), lnw=_t(lnw), lnb=_t(lnb), dbias=_t(dbias), tg=tg, td=td, trep=trep,
                hscale=torch.tensor(hscale), eps=eps, ref=ref)


def _split_sum(xq: torch.Tensor, w8: torch.Tensor, plan) -> torch.Tensor:
    """The int32 partials of the plan's K splits (whole stages; the last may
    be shorter), summed in split order."""
    acc = None
    for z in range(plan.splits):
        k0, k1 = z * plan.sps, min((z + 1) * plan.sps, plan.stages)
        part = int_matmul(xq[:, k0 * plan.stage_k:k1 * plan.stage_k], w8[k0 * plan.stage_k:
                                                                         k1 * plan.stage_k])
        acc = part if acc is None else acc + part
    return acc


def _leg_plans(n, k):
    return tfd.fused_candidates(M, n, k, GS)


@pytest.mark.parametrize("leg1", range(len(_leg_plans(2 * F, D))))
def test_gate_up_leg_splits_give_the_plain_h_codes(mlp, leg1):
    plan = _leg_plans(2 * F, D)[leg1]
    tg = mlp["tg"]
    xq = tfd._rmsnorm_q(mlp["x"], mlp["lnw"], mlp["lnb"], mlp["eps"])
    w8 = dequantize_rowpair(tg[0], tfd._planes(tg[1], tg[2]), tfd._planes(tg[3], tg[4]), GS)
    gu = _split_sum(xq, w8, plan)
    assert torch.equal(gu, tfd._plane_product(xq, *tg[:5], GS))
    h = tfd._silu_mul_q(gu[:, :F], gu[:, F:], tg[6][:F], tg[6][F:], mlp["hscale"])
    codes = (torch.empty((M, D), dtype=torch.int8), torch.empty((M, F), dtype=torch.int8))
    tfd.fused_mlp_decode_rp(mlp["x"], mlp["lnw"], mlp["lnb"], *tg, mlp["hscale"],
                            mlp["td"][0], *mlp["trep"], mlp["td"][5], mlp["td"][6],
                            mlp["dbias"], span=SPAN, eps=mlp["eps"], codes_out=codes)
    assert torch.equal(codes[0], xq) and torch.equal(codes[1], h)
    assert len(torch.unique(h)) > 100  # the codes span the int8 range


@pytest.mark.parametrize("leg2", range(len(_leg_plans(D, F))))
def test_down_leg_splits_sum_to_the_unsplit_product(mlp, leg2):
    plan = _leg_plans(D, F)[leg2]
    td, trep = mlp["td"], mlp["trep"]
    h = torch.from_numpy(np.random.default_rng(leg2).integers(-128, 128, (M, F)).astype(
        np.int8))
    w8 = dequantize_rowpair(td[0], trep[0][::8], trep[1][::8], GS)
    acc = _split_sum(h, w8, plan)
    assert torch.equal(acc, int_matmul(h, w8))
    # the combine's epilogue on the summed partials is the plain version's on the codes
    want = tfd.fused_mlp_decode_rp_xla(mlp["x"], mlp["lnw"], None, *mlp["tg"], mlp["hscale"],
                                       td[0], *trep, td[5], td[6], mlp["dbias"],
                                       codes=(torch.zeros((M, D), dtype=torch.int8), h))
    torch.testing.assert_close(tfd._epilogue(acc, td[6], mlp["dbias"], mlp["x"]), want,
                               rtol=0, atol=0)


def test_two_legs_match_jax_kernel(mlp):
    """Both legs under the plan the card takes at these widths, against JAX."""
    tg, td, trep = mlp["tg"], mlp["td"], mlp["trep"]
    p1, p2 = tfd.mlp_plan(M, D, F, GS, SMS)
    xq = tfd._rmsnorm_q(mlp["x"], mlp["lnw"], mlp["lnb"], mlp["eps"])
    gu = _split_sum(xq, dequantize_rowpair(tg[0], tfd._planes(tg[1], tg[2]),
                                           tfd._planes(tg[3], tg[4]), GS), p1)
    h = tfd._silu_mul_q(gu[:, :F], gu[:, F:], tg[6][:F], tg[6][F:], mlp["hscale"])
    acc = _split_sum(h, dequantize_rowpair(td[0], trep[0][::8], trep[1][::8], GS), p2)
    got = tfd._epilogue(acc, td[6], mlp["dbias"], mlp["x"]).numpy()
    np.testing.assert_allclose(got, mlp["ref"], rtol=1e-4, atol=1e-3)
    plain = tfd.fused_mlp_decode_rp(mlp["x"], mlp["lnw"], mlp["lnb"], *tg, mlp["hscale"],
                                    td[0], *trep, td[5], td[6], mlp["dbias"], span=SPAN,
                                    eps=mlp["eps"]).numpy()
    np.testing.assert_array_equal(got, plain)


# ---- the plan ----------------------------------------------------------------

# (D, F) of LLaMA-2-7B's MLP (F as published and padded to a multiple of 512) and of the CPU
# tests
MLPS = [(LlamaConfig().hidden_size, LlamaConfig().intermediate_size), (4096, 11264), (D, F),
        (512, 1024)]
PLAN_CASES = [(d, f, gs) for d, f in MLPS for gs in (32, 64, 128) if d % (2 * gs) == 0]


@pytest.mark.parametrize("d,f,gs", PLAN_CASES)
def test_mlp_plan_gives_each_leg_a_plan_that_covers_it(d, f, gs):
    for m in range(1, 65):
        gate_up, down = tfd.mlp_plan(m, d, f, gs, SMS)
        what = f"M={m} D={d} F={f} gs={gs}: {gate_up} {down}"
        # each leg is the fused GEMV plan of its own product
        assert gate_up == tfd.fused_plan(m, 2 * f, d, gs, SMS, True), what
        assert down == tfd.fused_plan(m, d, f, gs, SMS, False), what
        for plan, n, k in ((gate_up, 2 * f, d), (down, d, f)):
            assert plan.bm >= m and plan.stages * plan.stage_k == k, what
            assert plan.splits == -(-plan.stages // plan.sps), what
            assert (plan.splits - 1) * plan.sps < plan.stages, what  # no empty split
            tiles, _ = plan.grid(n)
            assert tiles % plan.cluster == 0 and tiles * plan.bn >= n, what
            assert plan.smem == tfd.fused_smem(plan.bm, plan.sps) <= tfd.SMEM_LIMIT, what
        # a gate|up block takes 64 gate columns and the same 64 up columns: F / 64 blocks
        assert gate_up.grid(2 * f)[0] >= f // 64 > gate_up.grid(2 * f)[0] - gate_up.cluster, what


def test_mlp_plan_at_a_decode_step_and_a_verify_window():
    # batch 4: one 8-row tile a leg; the down leg's 32 column tiles split K to reach the SMs
    gate_up, down = tfd.mlp_plan(4, 4096, 11264, 128, SMS)
    assert gate_up.bm == down.bm == 8
    assert down.grid(4096)[0] * down.splits >= SMS // 2
    # 8 slots x a 5-token window: one 48-row tile, each weight byte read once a leg
    assert {p.bm for p in tfd.mlp_plan(40, 4096, 11264, 128, SMS)} == {48}


@pytest.mark.parametrize("d,f", [(4096, 11264 + 64), (4096 + 32, 11264), (64, 128)])
def test_mlp_plan_refuses_widths_the_legs_do_not_take(d, f):
    # F % 128 (the down leg's stages), D % 128 (the gate|up leg's); the tiny config's D = 64
    with pytest.raises(ValueError):
        tfd.mlp_plan(4, d, f, 32, SMS)


# ---- K12's MLP: the same two legs on span bytes --------------------------------


def _span_weights(k, n, gs, seed):
    """Span weights of a (k, n) linear for both packages: (jax, port) =
    (qweight, s_hi, s_lo, z_hi, z_lo, alpha), the 8x-replicated scales and
    zeros (port), and the compact (G, n) scales and zeros (port)."""
    r = np.random.default_rng(seed)
    qw = np.asarray(pack_nibbles(jnp.asarray(r.integers(0, 16, size=(k, n)).astype(np.int8)),
                                 span=2 * gs))
    sc = r.integers(1, 4, size=(k // gs, n)).astype(np.int8)
    zr = r.integers(0, 16, size=(k // gs, n)).astype(np.int8)
    arrays = (qw, sc[0::2], sc[1::2], zr[0::2], zr[1::2], (r.random(n) * 0.01).astype(np.float32))
    return ([jnp.asarray(a) for a in arrays], [_t(a) for a in arrays],
            (_t(np.repeat(sc, 8, 0)), _t(np.repeat(zr, 8, 0))), (_t(sc), _t(zr)))


@pytest.fixture(scope="module", params=[32, 64, 128])
def span_mlp(request):
    """K12's MLP at the CPU widths and groupsize ``param``: JAX's kernel in
    interpret mode with the norm bias, the down bias and the residual (the
    output), and with alpha 1 and neither (the down leg's int32 sums)."""
    gs = request.param
    rng = np.random.default_rng(21 + gs)
    x = (rng.normal(size=(M, D)) * 3).astype(np.float32)
    lnw = (rng.random(D) + 0.5).astype(np.float32) * 20
    lnb = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    dbias = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    jg, tg, _, gc = _span_weights(D, 2 * F, gs, 22 + gs)
    jd, td, trep, dc = _span_weights(F, D, gs, 23 + gs)
    hscale, eps = np.float32(0.05), 1e-5
    jrep = [jnp.asarray(a.numpy()) for a in trep]

    def jax_mlp(alpha, bias, fuse):
        return np.asarray(jfd.fused_mlp_decode(
            jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb), *jg, jnp.asarray(hscale), jd[0],
            *jrep, alpha, bias, span=2 * gs, bf=512, eps=eps, fuse_residual=fuse,
            interpret=True))

    return dict(gs=gs, x=_t(x), lnw=_t(lnw), lnb=_t(lnb), dbias=_t(dbias), tg=tg, td=td,
                trep=trep, gc=gc, dc=dc, hscale=torch.tensor(hscale), eps=eps,
                ref=jax_mlp(jd[5], jnp.asarray(dbias), True),
                ref_acc=jax_mlp(jnp.ones((D,), jnp.float32), None, False),
                xq_jax=np.asarray(jfd._rmsnorm_q(jnp.asarray(x), jnp.asarray(lnw),
                                                 jnp.asarray(lnb), eps)))


def test_span_gate_up_boxes_dequantise_to_dequantize_span(span_mlp):
    """The gate|up leg's order of k on span bytes: a block's stage holds two
    boxes of 64 packed rows x 64 columns, gate columns [64 b, 64 b + 64) and
    the same up columns F + 64 b ..; ``span_stage_map`` names each 32-k run
    of a stage, nibble h of its 32 packed rows, and its plane row.  Every
    run of every box, dequantised with that plane row of s_hi/z_hi (h = 0)
    or s_lo/z_lo (h = 1), equals ``dequantize_span``'s weights there, and
    the runs name each logical k of D once."""
    from dgq_tpu_torch.ops.quant_matmul import dequantize_span

    gs, tg = span_mlp["gs"], span_mlp["tg"]
    sc, zr = span_mlp["gc"]
    w8 = dequantize_span(tg[0], sc, zr, gs).to(torch.int32)
    byte = tg[0].view(torch.uint8).to(torch.int32)
    planes = {0: (tg[1], tg[3]), 1: (tg[2], tg[4])}
    for b in range(F // 64):
        gate = torch.arange(64 * b, 64 * b + 64)
        cols = torch.cat([gate, F + gate])
        seen = []
        for st in range(D // 128):
            for (kk, h), (k0, group, row) in tfd.span_stage_map(st, gs).items():
                rows = byte[64 * st + 32 * kk: 64 * st + 32 * kk + 32][:, cols]
                nib = (rows >> 4) if h == 0 else (rows & 0xF)
                s_row, z_row = (p[row][cols].to(torch.int32) for p in planes[h])
                assert group // 2 == row and group % 2 == h
                assert torch.equal(((nib - z_row) * s_row).to(torch.int8).int(),
                                   w8[k0:k0 + 32][:, cols]), (b, st, kk, h)
                seen += range(k0, k0 + 32)
        assert sorted(seen) == list(range(D))


def _span_leg_plans(n, k, gs):
    return tfd.fused_candidates(M, n, k, gs, "span")


def test_span_legs_under_every_plan_match_jax_kernel(span_mlp):
    """K12's MLP as the card runs it: under every span plan of either leg
    (K splits of whole spans, their int32 partials summed in split order)
    the gate|up sums equal the unsplit product, the xq codes equal JAX's
    RMSNormQ and the plain version's, the h codes JAX's SiLU * up rule on
    those sums and the plain version's, the down leg's sums JAX's kernel's
    (alpha 1), and the output equals the plain version's and lies within
    1e-6 of the largest of JAX's."""
    from dgq_tpu_torch.ops.quant_matmul import dequantize_span

    gs, tg, td, trep = span_mlp["gs"], span_mlp["tg"], span_mlp["td"], span_mlp["trep"]
    x, lnw, lnb, eps, hscale = (span_mlp[k] for k in ("x", "lnw", "lnb", "eps", "hscale"))
    xq = tfd._rmsnorm_q(x, lnw, lnb, eps)
    np.testing.assert_array_equal(xq.numpy(), span_mlp["xq_jax"])
    wg = dequantize_span(tg[0], *span_mlp["gc"], gs)
    wd = dequantize_span(td[0], *span_mlp["dc"], gs)
    gu_full = int_matmul(xq, wg)
    g_j = np.asarray(gu_full[:, :F].numpy(), np.float32) * np.asarray(tg[5][:F].numpy())
    u_j = np.asarray(gu_full[:, F:].numpy(), np.float32) * np.asarray(tg[5][F:].numpy())
    hj = (jnp.asarray(g_j) * jax.nn.sigmoid(jnp.asarray(g_j))) * jnp.asarray(u_j)
    h_jax = np.asarray(jnp.clip(jnp.round(hj / np.float32(0.05)), -128.0, 127.0).astype(jnp.int8))
    codes = (torch.empty((M, D), dtype=torch.int8), torch.empty((M, F), dtype=torch.int8))
    plain = tfd.fused_mlp_decode(x, lnw, lnb, *tg, hscale, td[0], *trep, td[5],
                                 span_mlp["dbias"], span=2 * gs, eps=eps, codes_out=codes)
    assert torch.equal(codes[0], xq)
    np.testing.assert_array_equal(codes[1].numpy(), h_jax)
    assert len(torch.unique(codes[1])) > 100  # the codes span the int8 range
    for plan in _span_leg_plans(2 * F, D, gs):
        gu = _split_sum(xq, wg, plan)
        assert torch.equal(gu, gu_full), plan
        h = tfd._silu_mul_q(gu[:, :F], gu[:, F:], tg[5][:F], tg[5][F:], hscale)
        assert torch.equal(h, codes[1]), plan
    want_acc = torch.tensor(span_mlp["ref_acc"])
    for plan in _span_leg_plans(D, F, gs):
        acc = _split_sum(codes[1], wd, plan)
        assert torch.equal(acc.to(torch.float32), want_acc), plan
        got = tfd._epilogue(acc, td[5], span_mlp["dbias"], x)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
    ref = span_mlp["ref"]
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
