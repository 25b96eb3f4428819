"""P2's plan and launch checks, and the fused decode Loaders' stage constants.

The P2 engines (``csrc/int8_gemv_engines.cu``) run only on the card; here
their plan (``gemv_candidates``, ``gemv_plan``: the K split) is held to
what the C entry points take: every candidate covers K and N exactly in
whole 128-k stages, its shared memory (the Python twin of ``fused_smem``)
fits a block and leaves the blocks an SM it assumes, the chosen plan is the
most splits whose blocks run in one wave, and the mix's tensor-core columns
fall on a column-tile edge; ``launch_shape``
raises ValueError on what the entry points reject.  The rowpair and span
Loaders of K4-K6 and K12 keep their stages: 8,192 weight bytes and 1,024 of
scale rows, in a ring of 4, as the header and its Python twin say.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from dgq_tpu_torch.ops import fused_decode as fd
from dgq_tpu_torch.scripts import probe_gemv_engines as p2

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "dgq_tpu_torch" / "csrc"
# (N, K): P2's shape, the CPU probe's, LLaMA-2-7B's other linears
SHAPES = ((p2.N, p2.K), (1024, 256), (4096, 4096), (22528, 4096), (4096, 11264))


@pytest.mark.parametrize("n,k", SHAPES)
def test_p2_candidates_cover_k_and_n_and_fit(n, k):
    stages = k // p2.GEMV_STAGE_K
    plans = p2.gemv_candidates(n, k)
    assert plans and len(set(plans)) == len(plans)
    assert [p.splits for p in plans] == sorted(p.splits for p in plans)
    for plan in plans:
        assert stages % plan.splits == 0 and plan.splits * plan.sps == stages, plan
        assert n // p2.GEMV_BN * p2.GEMV_BN == n
        assert plan.smem == p2.gemv_smem(plan.sps) == fd.fused_smem(
            p2.GEMV_BM, plan.sps, p2.GEMV_STAGE_BYTES) <= fd.SMEM_LIMIT, plan
        assert 1 <= plan.per_sm <= p2.GEMV_MAX_PER_SM, plan
        assert plan.per_sm * (plan.smem + 1024) <= fd.SMEM_PER_SM, plan
    for sms in (132, 114, 78):
        assert p2.gemv_plan(n, k, sms) in plans


@pytest.mark.parametrize("n,k,sms,splits", [
    (p2.N, p2.K, 132, 4),   # P2's shape on an H100 SXM: 384 blocks, three an SM
    (p2.N // 2, p2.K, 132, 8),  # K4's bytes: 48 column tiles
    (p2.N, p2.K, 100, 2),   # a smaller card: 192 blocks, two an SM
    (p2.N, p2.K, 30, 1),    # no split fits one wave: the fewest
])
def test_p2_plan_is_the_most_splits_in_one_wave(n, k, sms, splits):
    plan = p2.gemv_plan(n, k, sms)
    assert plan.splits == splits, plan
    tiles = n // p2.GEMV_BN
    for other in p2.gemv_candidates(n, k):
        if other.splits > plan.splits:
            assert tiles * other.splits > sms * other.per_sm, other
    if tiles * plan.splits > sms * plan.per_sm:
        assert plan == p2.gemv_candidates(n, k)[0]


def test_p2_smem_twin_matches_the_header_formula():
    # fused_smem: codes (bm x 128 a stage of the split), ring, 2 barriers a stage, 256, slack
    for bm, sps, stage in ((8, 32, 16384), (8, 4, 16384), (64, 8, 9216)):
        assert fd.fused_smem(bm, sps, stage) == \
            bm * 128 * sps + fd.FUSED_RING * stage + 16 * fd.FUSED_RING + 256 + 1024
    assert fd.fused_smem(64, 8) == fd.fused_smem(64, 8, fd.FUSED_STAGE_BYTES)
    src = (CSRC / "fused_gemv_sm90.cuh").read_text()
    assert ("return static_cast<size_t>(bm) * 128 * sps + F_RING * stage + 2 * F_RING * 8 + 256 "
            "+ 1024;") in src
    cu = (CSRC / "int8_gemv_engines.cu").read_text()
    assert cu.count(f"__launch_bounds__(F_THREADS, {p2.GEMV_MAX_PER_SM})") == 3
    assert "fused_smem(G_BM, g.sps, FusedS8::STAGE)" in cu
    assert "constexpr int G_BM = 8;" in cu and p2.GEMV_BM == 8


@pytest.mark.parametrize("frac", [0.5, 0.67, 0.1, 0.75, 1.0])
def test_p2_mix_split_falls_on_a_column_tile_edge(frac):
    nm = p2.mix_split(p2.N, frac)
    assert nm == int(p2.N * frac / 256) * 256
    assert nm % p2.GEMV_BN == 0 and 0 <= nm <= p2.N
    assert p2.launch_shape((p2.B, p2.K), (p2.K, p2.N), nm) == (p2.B, p2.K, p2.N)


@pytest.mark.parametrize("x_shape,w_shape,nm,match", [
    ((9, 256), (256, 1024), None, "rows"),
    ((0, 256), (256, 1024), None, "rows"),
    ((8, 256), (128, 1024), None, "rows"),
    ((8, 256), (256, 1000), None, "N %"),
    ((8, 200), (200, 1024), None, "K %"),
    ((8, 256), (256, 1024), 64, "nm"),
    ((8, 256), (256, 1024), 1152, "nm"),
    ((8, 256), (256, 1024), -128, "nm"),
])
def test_p2_check_rejects_what_the_kernels_do_not_take(x_shape, w_shape, nm, match):
    with pytest.raises(ValueError, match=match):
        p2.launch_shape(x_shape, w_shape, nm)
    # the wrappers' check asks launch_shape first, before the device
    x = torch.zeros(x_shape, dtype=torch.int8)
    w = torch.zeros(w_shape, dtype=torch.int8)
    with pytest.raises(ValueError, match=match):
        p2._check(x, w, p2.MIX, nm)


def test_p2_wrappers_take_a_plan_and_the_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-127, 127, (8, 256)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 127, (256, 1024)).astype(np.int8))
    want = x.numpy().astype(np.int32) @ w.numpy().astype(np.int32)
    for plan in p2.gemv_candidates(1024, 256):
        assert np.array_equal(p2.mxu_gemv(x, w, plan=plan).numpy(), want)
        assert np.array_equal(p2.vpu_gemv(x, w, plan=plan).numpy(), want[:1])
        om, ov = p2.mix_gemv(x, w, 0.5, plan=plan)
        assert np.array_equal(om.numpy(), want[:, :512]) and np.array_equal(ov.numpy(),
                                                                           want[:1, 512:])


def _struct(src: str, name: str) -> str:
    i = src.index(f"struct {name}")
    return src[i:src.index("\n};", i)]


def test_packed_loaders_keep_their_stages():
    """K4-K6 and K12 stream 64 packed rows of 128 columns and up to 8 scale
    and zero rows a stage (8,192 + 1,024 bytes) through a ring of 4; only
    P2's FusedS8 takes 128 int8 rows and no scale rows."""
    assert fd.FUSED_STAGE_BYTES == 8192 + 1024 and fd.FUSED_RING == 4
    assert fd.FUSED_BN == p2.GEMV_BN == 128 and fd.FUSED_STAGE_K == p2.GEMV_STAGE_K == 128
    src = (CSRC / "fused_gemv_sm90.cuh").read_text()
    for line in ("constexpr int F_RING = 4;", "constexpr int F_W_BYTES = 64 * BN;",
                 "constexpr int F_SCL_ROWS = 8;",
                 "constexpr int F_STAGE = F_W_BYTES + F_SCL_ROWS * BN;  // 9216"):
        assert line in src, line
    for name in ("FusedRowpair", "FusedSpan"):
        body = _struct(src, name)
        consts = re.search(r"static constexpr int W_ROWS = 64, W_BYTES = F_W_BYTES, "
                           r"R = 2 \* QS, STAGE = F_STAGE;", body)
        assert consts, name
    s8 = _struct(src, "FusedS8")
    assert "W_ROWS = 128, W_BYTES = 128 * BN, R = 0, STAGE = W_BYTES;" in s8
    assert p2.GEMV_STAGE_BYTES == 128 * 128
    # the body takes every stage constant from its Loader, and one ring depth for all
    body = src[src.index("void fused_gemv_body("):src.index("void fused_combine_body(")]
    assert not re.search(r"\bF_(STAGE|W_BYTES)\b", body)
    assert "ring + F_RING * L::STAGE" in body
