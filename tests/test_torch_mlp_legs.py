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
