"""The plan of the W4A8 GEMMs K1 and K9 (``gemm_plan``) and of K10
(``fpscale_plan``), held on the CPU.

``gemm_plan`` chooses the tile and the K split that the CUDA entry points
take; the kernels run on the card only, so these tests hold what the plan
promises them, at every linear shape of ``LlamaConfig()``, ``OPTConfig()`` and
the tiny configs of the CPU tests, for the row counts the engines give (a
decode step, verify windows, prefill chunks, a perplexity window), each
group size the wrappers accept and the H100's 132 SMs:

- K is covered exactly: the splits' stage ranges tile [0, stages) with no
  gap, no overlap and no empty split, stages x stage_k covers K, and every
  split boundary is a stage boundary, and for K9 a stage's packed rows lie
  inside one span, so that each of its halves lies in one group;
- the grid is nonzero in every dimension and tiles M and N;
- the decode tile runs up to 16 rows, the prefill tile above, and the
  prefill tile is split only when its tiles leave SMs idle;
- K10's split holds whole spans, as its kernel flushes per span.
"""

import pytest

from dgq_tpu_torch.models.llama import LlamaConfig, tiny_llama_config
from dgq_tpu_torch.models.opt import OPTConfig, tiny_opt_config
from dgq_tpu_torch.ops import quant_matmul as qm

SMS = 132
ROWS = (1, 4, 17, 40, 256, 1024, 2048)


def _pad(f, mult=256):
    return -(-f // mult) * mult


def _llama_linears(cfg):
    d, dh = cfg.hidden_size, cfg.head_dim
    qkv = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * dh
    shapes = set()
    for f in (cfg.intermediate_size, _pad(cfg.intermediate_size)):  # F as given and padded
        shapes |= {(qkv, d), (d, cfg.num_attention_heads * dh), (2 * f, d), (d, f)}
    return shapes


def _opt_linears(cfg):
    d, f = cfg.hidden_size, cfg.ffn_dim
    return {(3 * d, d), (d, d), (f, d), (d, f)}


LINEARS = sorted(_llama_linears(LlamaConfig()) | _llama_linears(tiny_llama_config())
                 | _opt_linears(OPTConfig()) | _opt_linears(tiny_opt_config()))


def _accepted(layout, n, k, gs):
    """What the wrappers accept (K1: N % 16, K % 64, gs % 64, K % gs; K9: N % 16,
    gs % 32, K % (2 gs))."""
    if layout == "rowpair":
        return n % 16 == 0 and k % 64 == 0 and gs % 64 == 0 and k % gs == 0
    return n % 16 == 0 and gs % 32 == 0 and k % (2 * gs) == 0


CASES = [(layout, n, k, gs) for layout, sizes in (("rowpair", (64, 128)), ("span", (32, 64, 128)))
         for n, k in LINEARS for gs in sizes if _accepted(layout, n, k, gs)]


@pytest.mark.parametrize("layout,n,k,gs", CASES)
def test_gemm_plan_covers_k_and_the_grid(layout, n, k, gs):
    for m in ROWS:
        plan = qm.gemm_plan(m, n, k, gs, layout, SMS)
        what = f"{layout} M={m} N={n} K={k} gs={gs}: {plan}"
        # the stage: 64 packed rows, or 32 for span weights whose groups are not a multiple of 64
        assert plan.stage_k == (64 if layout == "span" and gs % 64 else 128), what
        assert plan.stages == -(-k // plan.stage_k) and (plan.stages - 1) * plan.stage_k < k, what
        if layout == "span":  # a stage's packed rows lie in one span, so its halves in one group
            assert k % plan.stage_k == 0 and gs % (plan.stage_k // 2) == 0, what
        else:  # each 64-k half of a stage lies in one group
            assert gs % (plan.stage_k // 2) == 0, what
        # the splits tile [0, stages) in whole stages, none empty
        assert 1 <= plan.splits <= qm.MAX_SPLITS and plan.sps >= 1, what
        bounds = [min(z * plan.sps, plan.stages) for z in range(plan.splits + 1)]
        assert bounds[0] == 0 and bounds[-1] == plan.stages, what
        assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:])), what
        assert plan.splits == -(-plan.stages // plan.sps), what
        # the grid: nonzero, and its tiles cover M and N
        gm, gn, gz = plan.grid(m, n)
        assert gm >= 1 and gn >= 1 and gz == plan.splits, what
        assert gm * plan.bm >= m > (gm - 1) * plan.bm and gn * plan.bn >= n > (gn - 1) * plan.bn, what
        assert (plan.tile, plan.bm) == ((qm.DECODE_TILE, qm.DECODE_ROWS) if m <= qm.DECODE_ROWS
                                        else (qm.PREFILL_TILE, qm.PREFILL_ROWS)), what
        assert plan.bn == qm.TILE_N, what
        # the prefill tile splits only when its output tiles leave SMs idle
        assert plan.tile == qm.DECODE_TILE or plan.splits == 1 or gm * gn < SMS, what


def test_gemm_plan_spreads_a_decode_step_over_the_card():
    # the 7B o_proj at batch 4: 32 column tiles, so K is split to fill the SMs
    plan = qm.gemm_plan(4, 4096, 4096, 128, "rowpair", SMS)
    gm, gn, gz = plan.grid(4, 4096)
    assert gm * gn == 32 and gm * gn * gz <= SMS and gz >= 2
    # gate_up at batch 4: 176 column tiles are 1.3 waves, a split of 2 evens them
    assert qm.gemm_plan(4, 22528, 4096, 128, "rowpair", SMS).splits == 2
    # prefill fills the card with tiles alone
    assert qm.gemm_plan(1024, 12288, 4096, 128, "span", SMS).splits == 1


def test_gemm_plan_rejects_an_unknown_layout():
    with pytest.raises(ValueError):
        qm.gemm_plan(4, 4096, 4096, 128, "s4", SMS)


LLAMA_7B = _llama_linears(LlamaConfig())


@pytest.mark.parametrize("n,k", LINEARS)
def test_fpscale_plan_splits_whole_spans(n, k):
    """K10's splits tile K/2 in whole spans (its kernel flushes per span),
    at most MAX_SPLITS, the prefill tile unsplit once its tiles fill the
    SMs; at LLaMA-2-7B's shapes for every M from 1 to 2048."""
    rows = range(1, 2049) if (n, k) in LLAMA_7B else ROWS
    for gs in (32, 64, 128):
        if k % (2 * gs):
            continue
        for m in rows:
            tile, p_split = qm.fpscale_plan(m, n, k, gs, SMS)
            what = f"M={m} N={n} K={k} gs={gs}: {(tile, p_split)}"
            assert tile == (qm.FP_DECODE_TILE if m <= qm.DECODE_ROWS else qm.FP_PREFILL_TILE)
            assert p_split > 0 and p_split % gs == 0 and p_split <= k // 2, what
            splits = -(-(k // 2) // p_split)
            assert (splits - 1) * p_split < k // 2 <= splits * p_split, what
            assert splits <= qm.MAX_SPLITS, what
            tiles = -(-m // qm.FP_TILE_ROWS[tile]) * -(-n // qm.TILE_N)
            assert tile == qm.FP_DECODE_TILE or splits == 1 or tiles < SMS, what


def test_fpscale_plan_spreads_a_decode_step_over_the_card():
    # the 7B o_proj at batch 4: 32 column tiles, so K is split in whole spans
    tile, p_split = qm.fpscale_plan(4, 4096, 4096, 128, SMS)
    assert tile == qm.FP_DECODE_TILE and 2048 // p_split >= 2
    # prefill: 8 x 96 tiles fill the card unsplit
    assert qm.fpscale_plan(1024, 12288, 4096, 128, SMS) == (qm.FP_PREFILL_TILE, 2048)


@pytest.mark.parametrize("m", [1, 4, 40, 1024])
def test_fpscale_candidates_are_every_split_the_plan_weighs(m):
    """K10's plan hold (chip_smoke.py) runs every ``fpscale_candidates``
    plan: fpscale_plan's tile with each whole-span split ``_split`` can
    pick, unsplit first, the chosen one among them, none empty."""
    n = k = 4096
    for gs in (32, 64, 128):
        spans = k // 2 // gs
        plans = qm.fpscale_candidates(m, n, k, gs, SMS)
        chosen = qm.fpscale_plan(m, n, k, gs, SMS)
        assert chosen in plans and plans[0] == (chosen[0], k // 2)
        assert len(set(plans)) == len(plans) and all(t == chosen[0] for t, _ in plans)
        want = {-(-spans // s) * gs for s in range(1, min(spans, qm.MAX_SPLITS) + 1)}
        assert {p for _, p in plans} == want
        for _, p_split in plans:
            splits = -(-(k // 2) // p_split)
            assert p_split % gs == 0 and (splits - 1) * p_split < k // 2 <= splits * p_split
