"""The plan of the fused decode GEMVs K4 and K5 (``fused_plan`` in
``dgq_tpu_torch/ops/fused_decode.py``), held on the CPU.

``fused_plan`` chooses the token-row tile, the cluster of column tiles and
the K split that the CUDA entry points take; the kernels run on the card
only, so these tests hold what the plan promises them, at every fused-decode
linear shape of ``LlamaConfig()`` (q|k|v and o_proj) and of the CPU tests,
for every row count the fused kernels take (1-64), each group size 32, 64
and 128 that the shape allows, and the H100's 132 SMs:

- one row tile covers M: the smallest of the tiles that holds all rows;
- the splits take whole stages and tile [0, stages) with no gap, no overlap
  and no empty split, so every block has work;
- the column tiles cover N, in whole clusters;
- the shared memory fits a block (and two, where the plan lets two share an
  SM), and is what the kernel's layout takes.

The same plan on span bytes (``layout="span"``: K12's norm and requant
entries) splits K in whole spans only, and refuses what the rowpair plan
refuses.
"""

import pytest

from dgq_tpu_torch.models.llama import LlamaConfig, tiny_llama_config
from dgq_tpu_torch.ops import fused_decode as fd

SMS = 132
ROWS = range(1, 65)


def _fused_linears(cfg):
    """(N, K) of the two linears K4 and K5 run: q|k|v and o_proj."""
    d, dh = cfg.hidden_size, cfg.head_dim
    qkv = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * dh
    return {(qkv, d), (d, cfg.num_attention_heads * dh)}


# LLaMA-2-7B, and the widths of tests/test_torch_fused_decode.py (D 256, N 512)
LINEARS = sorted(_fused_linears(LlamaConfig()) | {(512, 256), (256, 256)})
CASES = [(n, k, gs) for n, k in LINEARS for gs in (32, 64, 128) if k % (2 * gs) == 0]


@pytest.mark.parametrize("norm", [True, False], ids=["K4", "K5"])
@pytest.mark.parametrize("n,k,gs", CASES)
def test_fused_plan_covers_rows_k_and_columns(n, k, gs, norm):
    for m in ROWS:
        plan = fd.fused_plan(m, n, k, gs, SMS, norm)
        what = f"M={m} N={n} K={k} gs={gs}: {plan}"
        # one row tile covers M, the smallest that does
        assert plan.bm in fd.FUSED_TILES and plan.bm >= m, what
        assert all(t < m for t in fd.FUSED_TILES if t < plan.bm), what
        # whole stages of 128 k; the splits tile [0, stages), none empty
        assert plan.stage_k == fd.FUSED_STAGE_K and plan.stages * plan.stage_k == k, what
        bounds = [min(z * plan.sps, plan.stages) for z in range(plan.splits + 1)]
        assert bounds[0] == 0 and bounds[-1] == plan.stages, what
        assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:])), what
        assert plan.splits == -(-plan.stages // plan.sps), what
        # the column tiles cover N in whole clusters; padding stays inside the last cluster
        tiles, splits = plan.grid(n)
        assert plan.cluster in fd.FUSED_CLUSTERS and tiles % plan.cluster == 0, what
        assert tiles * plan.bn >= n > (tiles - plan.cluster) * plan.bn, what
        assert splits == plan.splits, what
        # shared memory: the kernel's layout, within a block's limit (two blocks' where two share)
        assert plan.smem == fd.fused_smem(plan.bm, plan.sps) <= fd.SMEM_LIMIT, what
        assert plan.per_sm in (1, 2), what
        assert plan.per_sm == 1 or 2 * (plan.smem + 1024) <= fd.SMEM_PER_SM, what


def test_fused_plan_spreads_a_decode_step_over_the_card():
    # the 7B o_proj at batch 4: 32 column tiles, so K is split to reach the SMs
    plan = fd.fused_plan(4, 4096, 4096, 128, SMS, False)
    tiles, splits = plan.grid(4096)
    assert tiles == 32 and splits >= 4 and plan.bm == 8
    # a verify window of 8 slots x 5 rows takes one 48-row tile, not five 8-row ones
    assert fd.fused_plan(40, 12288, 4096, 128, SMS, True).bm == 48


@pytest.mark.parametrize("m,n,k,gs", [(0, 4096, 4096, 128), (65, 4096, 4096, 128),
                                      (4, 4100, 4096, 128), (4, 4096, 4000, 128),
                                      (4, 4096, 4096, 48), (4, 4096, 4096, 4096)])
def test_fused_plan_refuses_shapes_the_kernels_do_not_take(m, n, k, gs):
    with pytest.raises(ValueError):
        fd.fused_plan(m, n, k, gs, SMS, True)


def test_fused_plan_forced_choices_and_the_tiny_config():
    # the plans a sweep forces are the candidates the plan chooses among: each
    # cluster and split once, the chosen plan one of them
    plans = fd.fused_candidates(40, 4096, 4096, 128)
    assert fd.fused_plan(40, 4096, 4096, 128, SMS, False) in plans
    assert len(set(plans)) == len(plans)
    # 48 rows of codes over all of K do not fit beside the ring: K is split
    assert {(p.cluster, p.splits) for p in plans} == {
        (c, s) for c in fd.FUSED_CLUSTERS for s in fd.FUSED_SPLITS if s > 1}
    forced = next(p for p in plans if (p.cluster, p.splits) == (1, 2))
    assert (forced.bm, forced.sps) == (48, 16)
    # the tiny CPU config's widths (K = 64) are not a multiple of a stage: the
    # wrappers take the plain versions there on the CPU and refuse on the card
    cfg = tiny_llama_config()
    for n, k in _fused_linears(cfg):
        with pytest.raises(ValueError):
            fd.fused_plan(4, n, k, 32, SMS, True)


# K12's norm and requant entries: K4's and K5's kernel on span bytes, whose K
# splits hold whole spans (a stage's two nibble planes lie groupsize apart in K)
@pytest.mark.parametrize("norm", [True, False], ids=["norm", "requant"])
@pytest.mark.parametrize("n,k,gs", CASES)
def test_span_plan_candidates_cover_k_once_in_whole_spans(n, k, gs, norm):
    unit = fd.split_unit(gs, "span")
    assert (64 * unit) % gs == 0 and all((64 * u) % gs for u in range(1, unit))
    for m in ROWS:
        plans = fd.fused_candidates(m, n, k, gs, "span")
        assert fd.fused_plan(m, n, k, gs, SMS, norm, "span") in plans
        assert len(set(plans)) == len(plans)
        for plan in plans:
            what = f"M={m} N={n} K={k} gs={gs}: {plan}"
            # the splits' logical k ranges [128 sps z, 128 sps (z + 1)) tile [0, K) ...
            edges = [min(z * plan.sps, plan.stages) * plan.stage_k for z in range(plan.splits + 1)]
            assert edges[0] == 0 and edges[-1] == k, what
            assert all(b > a for a, b in zip(edges, edges[1:])), what
            # ... and start and end on whole spans (2 gs logical k, gs packed rows)
            assert all(e % (2 * gs) == 0 for e in edges), what
            assert plan.splits == 1 or plan.sps % unit == 0, what
            assert plan.smem == fd.fused_smem(plan.bm, plan.sps) <= fd.SMEM_LIMIT, what
            tiles, splits = plan.grid(n)
            assert tiles % plan.cluster == 0 and tiles * plan.bn >= n and splits == plan.splits


def test_span_plan_matches_the_rowpair_plan_where_spans_allow():
    # at groupsize 32 and 64 every stage holds whole spans: the same candidates and choice
    for gs in (32, 64):
        for m, n, k in ((4, 12288, 4096), (40, 4096, 4096), (1, 512, 256)):
            assert fd.fused_candidates(m, n, k, gs, "span") == fd.fused_candidates(m, n, k, gs)
            for norm in (True, False):
                assert (fd.fused_plan(m, n, k, gs, SMS, norm, "span")
                        == fd.fused_plan(m, n, k, gs, SMS, norm))
    # at 128 a split is an even number of stages
    assert all(p.sps % 2 == 0 for p in fd.fused_candidates(4, 4096, 4096, 128, "span"))
    with pytest.raises(ValueError, match="layout"):
        fd.fused_candidates(4, 4096, 4096, 128, "columns")


@pytest.mark.parametrize("m,n,k,gs", [(0, 4096, 4096, 128), (65, 4096, 4096, 128),
                                      (4, 4100, 4096, 128), (4, 4096, 4000, 128),
                                      (4, 4096, 4096, 48), (4, 4096, 4096, 4096)])
def test_span_plan_refuses_what_the_rowpair_plan_refuses(m, n, k, gs):
    with pytest.raises(ValueError):
        fd.fused_plan(m, n, k, gs, SMS, True, "span")
    with pytest.raises(ValueError):
        fd.fused_candidates(m, n, k, gs, "span")


@pytest.mark.parametrize("gs", [32, 64, 96, 128])
def test_span_plan_blocks_read_only_codes_of_their_own_k_range(gs):
    """The kernel makes the codes of a block's K range only: under every
    span candidate, each stage of a split reads (``span_stage_map``) 32-k
    runs that lie inside that split's range of logical k."""
    k = 3 * 2 * gs * 4 if gs == 96 else 4096
    for m in (1, 9, 64):
        for plan in fd.fused_candidates(m, 4096, k, gs, "span"):
            for z in range(plan.splits):
                first, end = z * plan.sps, min((z + 1) * plan.sps, plan.stages)
                lo, hi = first * plan.stage_k, end * plan.stage_k
                for st in range(first, end):
                    for kk_h, (k0, _, _) in fd.span_stage_map(st, gs).items():
                        assert lo <= k0 and k0 + 32 <= hi, (m, plan, st, kk_h)
