"""The probes of dgq_tpu_torch/scripts held against the JAX probes on the CPU.

The JAX probe kernels P1 (``s8_matmul``), P2 (``mxu_gemv``, ``vpu_gemv``,
``mix_gemv``) and P5 (``attn``, six modes) run in interpret mode, imported
from ``scripts/`` with small shapes set on their module constants.  XLA on
the CPU refuses the int4 dot of P3 and P4, so their plain versions are held
against JAX's emulation of the chip's nibble order
(``dgq_tpu.ops.fused_decode._bitcast_rows_s4``, reshaped as the probe
reshapes it), XLA's own int8 -> int4 bitcast, and the probe's interleaved
golden, with int32 numpy dots.  On CPU tensors the port's wrappers run
their plain versions.

Tolerances: int32 results bit-equal; P1's f32 of int32 bit-equal; P5's fp
and nodeq within 1e-5 relative (f32 sums in another order), the integer
modes' outputs within 1e-5 relative and s32dot's (the float of the int32
sums) bit-equal."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dgq_tpu.ops.fused_decode import _bitcast_rows_s4
from dgq_tpu_torch.scripts import probe_gemv_engines as t2
from dgq_tpu_torch.scripts import probe_native_s4 as t3
from dgq_tpu_torch.scripts import probe_quant_pv_parts as t5
from dgq_tpu_torch.scripts import probe_s4_bitcast_numerics as t4
from dgq_tpu_torch.scripts import roofline_probe as t1

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the test workers share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_probe(name):
    spec = importlib.util.spec_from_file_location(f"jax_probe_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def j1():
    return _jax_probe("roofline_probe")


@pytest.fixture(scope="module")
def j2():
    return _jax_probe("probe_gemv_engines")


@pytest.fixture(scope="module")
def j5():
    return _jax_probe("probe_quant_pv_parts")


def _ints(rng, lo, hi, shape):
    return rng.integers(lo, hi, shape).astype(np.int8)


def test_p1_s8_matmul_matches_jax(j1):
    rng = np.random.default_rng(0)
    x, w = _ints(rng, -127, 128, (256, 256)), _ints(rng, -127, 128, (256, 256))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j1.s8_matmul(jnp.asarray(x), jnp.asarray(w), bm=128, bn=128, bk=128))
    for bm, bn in t1.TILINGS:
        got = t1.s8_matmul(torch.from_numpy(x), torch.from_numpy(w), bm=bm, bn=bn).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want)
    # past 2^24 the f32 of the int32 sum rounds half to even, as the kernel's __int2float_rn
    x, w = _ints(rng, -127, 128, (4, 4096)), _ints(rng, -127, 128, (4096, 16))
    x[0], w[:, 0] = 127, 127
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24
    got = t1.s8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert np.array_equal(got, exact.astype(np.float32))


def test_p2_gemv_engines_match_jax(j2, monkeypatch):
    monkeypatch.setattr(j2, "K", 256)
    monkeypatch.setattr(j2, "N", 1024)
    rng = np.random.default_rng(1)
    w, x = _ints(rng, -127, 127, (256, 1024)), _ints(rng, -127, 127, (j2.B, 256))
    wj, xj, wt, xt = jnp.asarray(w), jnp.asarray(x), torch.from_numpy(w), torch.from_numpy(x)
    with pltpu.force_tpu_interpret_mode():
        mxu = np.asarray(j2.mxu_gemv(xj, wj))
        vpu = np.asarray(j2.vpu_gemv(xj, wj))
        om, ov = (np.asarray(a) for a in j2.mix_gemv(xj, wj))
    assert np.array_equal(t2.mxu_gemv(xt, wt).numpy(), mxu)
    assert np.array_equal(t2.vpu_gemv(xt, wt).numpy(), vpu)
    gm, gv = t2.mix_gemv(xt, wt)
    assert gm.shape == om.shape == (j2.B, 512) and gv.shape == ov.shape == (1, 512)
    assert np.array_equal(gm.numpy(), om) and np.array_equal(gv.numpy(), ov)
    for n, frac in ((12288, 0.5), (12288, 0.67), (1024, 0.75), (4096, 0.1)):
        assert t2.mix_split(n, frac) == int(n * frac / 256) * 256


MODES = ("fp", "nodeq", "quant", "quant_fast", "noround", "s32dot")


def test_p5_quant_pv_parts_match_jax(j5, monkeypatch):
    smax, h = 256, 4
    monkeypatch.setattr(j5, "SMAX", smax)
    rng = np.random.default_rng(2)
    q = _ints(rng, -127, 128, (1, h, 128))
    kt = _ints(rng, -127, 128, (1, h, 128, smax))
    v = _ints(rng, -127, 128, (1, h, smax, 128))
    length = np.array([200], np.int32)
    args_t = [torch.from_numpy(a) for a in (q, kt, v, length)]
    assert t5.MODES == MODES
    with pltpu.force_tpu_interpret_mode():
        want = {m: np.asarray(j5.attn(*(jnp.asarray(a) for a in (q, kt, v, length)), mode=m))
                for m in MODES}
    for mode in MODES:
        got = t5.attn(*args_t, mode).numpy()
        assert got.shape == (1, h, 128) and np.isfinite(got).all()
        if mode == "s32dot":
            assert np.array_equal(got, want[mode])  # the int32 sums, exactly
        else:
            top = np.abs(want[mode]).max()
            np.testing.assert_allclose(got, want[mode], rtol=1e-5, atol=1e-5 * top)
    # the three rounding rules differ, and masked positions weigh nothing
    assert not np.array_equal(want["quant"], want["noround"])
    longer = t5.attn(args_t[0], args_t[1], args_t[2], torch.tensor([201], dtype=torch.int32),
                     "fp")
    assert not torch.equal(longer, t5.attn(*args_t, "fp"))


@pytest.mark.parametrize("hk", [4, 1], ids=["mha", "gqa"])
def test_p5_matches_jax_at_k3_edge_lengths(j5, monkeypatch, hk):
    """P5's six plain modes against JAX's probe at the lengths K3's body is
    held at on the card: 0 (no valid position: every score is finfo.min, so
    every e is 1 over all Smax positions), 1 and Smax, MHA and GQA."""
    smax, h = 256, 4
    monkeypatch.setattr(j5, "SMAX", smax)
    rng = np.random.default_rng(3 + hk)
    q = _ints(rng, -127, 128, (3, h, 128))
    kt = _ints(rng, -127, 128, (3, hk, 128, smax))
    v = _ints(rng, -127, 128, (3, hk, smax, 128))
    length = np.array([0, 1, smax], np.int32)
    args_t = [torch.from_numpy(a) for a in (q, kt, v, length)]
    with pltpu.force_tpu_interpret_mode():
        want = {m: np.asarray(j5.attn(*(jnp.asarray(a) for a in (q, kt, v, length)), mode=m))
                for m in MODES}
    for mode in MODES:
        got = t5.attn(*args_t, mode).numpy()
        assert got.shape == (3, h, 128) and np.isfinite(got).all()
        for b in range(3):  # each slot against its own largest output
            top = np.abs(want[mode][b]).max()
            np.testing.assert_allclose(got[b], want[mode][b], rtol=1e-5, atol=1e-5 * top)
        if mode == "s32dot":
            assert np.array_equal(got, want[mode])
    # length 0 weighs every position alike: s32dot is 127 x the sum of v over the cache
    v_sum = v[0].astype(np.int64).sum(axis=1)  # (Hkv, Dh)
    np.testing.assert_array_equal(t5.attn(*args_t, "s32dot").numpy()[0],
                                  127.0 * np.repeat(v_sum, h // hk, axis=0))


def test_p5_launch_shape_checks_and_decode_plan_cluster():
    """P5's C entry's integer arguments, as its wrapper makes them: the
    cluster is K3's ``decode_plan``, the mode's index is its place in the C
    entry's rule enum (csrc/decode_attention.cuh), and what the entry
    rejects raises first."""
    from dgq_tpu_torch.ops.attention import DECODE_CLUSTERS, decode_plan

    src = (ROOT / "dgq_tpu_torch" / "csrc" / "decode_attention.cuh").read_text()
    enum = src[src.index("enum PvRule {"):].split("}")[0]
    for i, mode in enumerate(MODES):
        assert f"PV_{mode.upper()} = {i}" in enum
        args = t5.launch_shape((1, 32, 128), (1, 32, 128, 2048), mode, 132)
        assert args == (1, 32, 32, 128, 2048, i, decode_plan(1, 32, 1, 128, 2048, 132))
    # one slot of 32 heads: 32 x 8 blocks fill two an SM
    assert t5.launch_shape((1, 32, 128), (1, 32, 128, 2048), "fp", 132)[-1] == 8
    assert t5.launch_shape((4, 32, 128), (4, 8, 128, 1707 + 1), "fp", 132)[2] == 8
    for cluster in DECODE_CLUSTERS:
        assert t5.launch_shape((1, 32, 128), (1, 32, 128, 2048), "quant", 132,
                               cluster)[-1] == cluster
    bad = [((1, 32, 64), (1, 32, 64, 2048)), ((1, 32, 128), (1, 3, 128, 2048)),
           ((1, 24, 128), (1, 8, 128, 2048)), ((1, 32, 128), (1, 32, 128, 2046))]
    for q_shape, kt_shape in bad:
        with pytest.raises(ValueError):
            t5.launch_shape(q_shape, kt_shape, "fp", 132)
    with pytest.raises(ValueError, match="cluster"):
        t5.launch_shape((1, 32, 128), (1, 32, 128, 2048), "fp", 132, 16)
    with pytest.raises(ValueError, match="mode"):
        t5.launch_shape((1, 32, 128), (1, 32, 128, 2048), "fast", 132)


def test_p5_codes_at_exact_ties():
    """quant (half to even) and quant_fast (trunc(127 e + 0.5)) part exactly
    where 127 e is x.5 in f32: codes as JAX's expressions give them."""
    e = [np.float32((k + 0.5) / 127) for k in range(127)]
    ties = np.array([x for x, k in zip(e, range(127))
                     if np.float32(x * np.float32(127)) == k + 0.5], np.float32)
    assert len(ties) > 20
    jt = jnp.asarray(ties)
    want = {"quant": np.asarray(jnp.round(jt * 127.0).astype(jnp.int8)),
            "quant_fast": np.asarray((jt * 127.0 + 0.5).astype(jnp.int8)),
            "noround": np.asarray((jt * 127.0).astype(jnp.int8))}
    for mode, codes in want.items():
        assert np.array_equal(t5.exp_codes(torch.from_numpy(ties), mode).numpy(), codes), mode
    assert not np.array_equal(want["quant"], want["quant_fast"])
    assert np.array_equal(want["quant"] % 2, np.zeros_like(want["quant"]))  # to even


def test_p3_p4_nibble_maps_match_jax():
    k, n, b = 256, 1024, 16
    rng = np.random.default_rng(3)
    wb = _ints(rng, -128, 128, (k, n // 2))
    x = _ints(rng, -8, 8, (b, k))
    xt, wbt = torch.from_numpy(x), torch.from_numpy(wb)
    # pallas_s4_bitcast: each 512-column block is the chip's bitcast of its
    # (K, 256) bytes (row r -> int4 rows 2r low, 2r+1 high) reshaped to (K, 512)
    h = t3.BN // 2
    halves = np.concatenate(
        [np.asarray(_bitcast_rows_s4(jnp.asarray(wb[:, j:j + h]), interpret=True)).reshape(k, -1)
         for j in range(0, n // 2, h)], axis=1).astype(np.int32)
    assert np.array_equal(t3.unpack_s4_halves(wbt).numpy(), halves)
    assert np.array_equal(t3.pallas_s4_bitcast(xt, wbt).numpy(), x.astype(np.int32) @ halves)
    assert np.array_equal(t4.pl_bitcast(xt, wbt).numpy(), x.astype(np.int32) @ halves)
    # pallas_s4: XLA's int4 packing, from XLA's own bitcast on the CPU
    pairs = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(wb), jnp.int4)
                       .astype(jnp.int32)).reshape(k, n)
    assert np.array_equal(t3.unpack_s4_pairs(wbt).numpy(), pairs)
    assert np.array_equal(t3.pallas_s4(xt, wbt).numpy(), x.astype(np.int32) @ pairs)
    assert t3.check_bitcast_order("cpu") == "elem0=LO nibble"
    # the interleaved golden A and the halves golden B of the numerics probe
    # (scripts/probe_s4_bitcast_numerics.py:49-54) at its K 256, 128 bytes
    wb_n = _ints(rng, -128, 128, (t4.NUM_K, t4.NUM_N2))
    x_n = _ints(rng, -8, 8, (8, t4.NUM_K))
    u = wb_n.astype(np.uint8)
    lo = ((u & 0xF) ^ 8).astype(np.int32) - 8
    hi = ((u >> 4).astype(np.int32) ^ 8) - 8
    golden_a = x_n.astype(np.int32) @ np.stack([lo, hi], axis=-1).reshape(t4.NUM_K, -1)
    golden_b = x_n.astype(np.int32) @ np.concatenate([lo, hi], axis=1)
    ga, gb = t4.goldens(x_n, wb_n)
    assert np.array_equal(ga, golden_a) and np.array_equal(gb, golden_b)
    assert np.array_equal(t3.pallas_s4(torch.from_numpy(x_n), torch.from_numpy(wb_n)).numpy(),
                          golden_a)
    assert np.array_equal(t4.kern(torch.from_numpy(x_n), torch.from_numpy(wb_n)).numpy(),
                          golden_b)
    assert t4.numerics("cpu") == {"view": [256, 256], "interleaved": False, "halves": True}


def _s4_column(byte, j, halves, bn):
    """FusedS4::column: the weight column of nibble j (0 low, 1 high) of byte
    column ``byte`` of the (K, N / 2) bytes."""
    if not halves:
        return 2 * byte + j
    half = bn // 2
    return (byte // half) * bn + j * half + byte % half


def _s4_kernel_emulated(x, wb, halves, bn):
    """(M, N) int64 as P3's kernel computes it: per block of 128 columns
    (64 byte columns), each stage of 128 rows x 64 bytes laid out as TMA
    writes it swizzled 64 bytes (bytes past N / 2 zero), each thread (cp,
    t) reading its byte column at FusedS4's offsets, rows 2t, 2t + 1, 8 +
    2t, 9 + 2t of each 16 of a 32-k step (FusedS8's k slots), the nibbles
    sign-extended, and the two sums written to the Loader's columns."""
    m, k = x.shape
    n2 = wb.shape[1]
    n = 2 * n2
    u = wb.view(np.uint8)
    xi = x.astype(np.int64)
    out = np.zeros((m, n), np.int64)
    written = np.zeros(n, np.int64)
    rows, cols = np.meshgrid(np.arange(128), np.arange(64), indexing="ij")
    swz = rows * 64 + ((((cols >> 4) ^ ((rows >> 1) & 3)) << 4) | (cols & 15))
    slots = (0, 1, 8, 9, 16, 17, 24, 25)  # past the thread's row 2t of the step
    assert sorted(2 * t + d for t in range(4) for d in slots) == list(range(32))
    for bx in range(-(-n // 128)):
        acc = np.zeros((m, 64, 2), np.int64)
        for st in range(k // 128):
            src = np.zeros((128, 64), np.uint8)
            hi = min(64, n2 - 64 * bx)
            src[:, :hi] = u[128 * st:128 * st + 128, 64 * bx:64 * bx + hi]
            box = np.zeros(128 * 64, np.uint8)
            box[swz] = src
            for cp in range(64):
                for t in range(4):
                    off = 2 * t * 64 + ((((cp >> 4) ^ t) << 4) | (cp & 15))
                    for h in range(2):
                        for kk in range(2):
                            step = 64 * h + 32 * kk
                            for d in slots:
                                byte = int(box[off + (step + d) * 64])
                                kr = 128 * st + step + 2 * t + d
                                for j in range(2):
                                    code = (((byte >> (4 * j)) & 0xF) ^ 8) - 8
                                    acc[:, cp, j] += xi[:, kr] * code
        for cp in range(64):
            byte = 64 * bx + cp
            if byte >= n2:
                continue
            for j in range(2):
                c = _s4_column(byte, j, halves, bn)
                out[:, c] = acc[:, cp, j]
                written[c] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("n,bn", [(1024, t3.BN), (256, 256), (1024 - 64, 64)])
def test_p3_nibble_loader_maps_match_unpack_and_jax(n, bn):
    """FusedS4's addresses and column maps, both maps, against the plain
    versions' unpack and JAX's nibble orders (a width of 960: a block past
    N / 2)."""
    k = 256
    rng = np.random.default_rng(n + bn)
    wb = _ints(rng, -128, 128, (k, n // 2))
    x = _ints(rng, -8, 8, (16, k))
    wbt = torch.from_numpy(wb)
    pairs = t3.unpack_s4_pairs(wbt).numpy().astype(np.int64)
    xla = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(wb), jnp.int4)
                     .astype(jnp.int32)).reshape(k, n)
    assert np.array_equal(pairs, xla)
    assert np.array_equal(_s4_kernel_emulated(x, wb, False, 0), x.astype(np.int64) @ pairs)
    halves = t3.unpack_s4_halves(wbt, bn).numpy().astype(np.int64)
    h = bn // 2
    chip = np.concatenate(
        [np.asarray(_bitcast_rows_s4(jnp.asarray(wb[:, j:j + h]), interpret=True)).reshape(k, -1)
         for j in range(0, n // 2, h)], axis=1)
    assert np.array_equal(halves, chip)
    assert np.array_equal(_s4_kernel_emulated(x, wb, True, bn), x.astype(np.int64) @ halves)


@pytest.mark.parametrize("n,k", [(t3.N, t3.K), (1024, 256), (256, 256), (960, 256),
                                 (4096, 11264)])
def test_p3_plan_at_its_stage_bytes(n, k):
    """``s4_plan``: P2's rule at P3's 16-row tile and 8 KB stage, over the
    128-column blocks that cover N: its splits divide K's stages, its block
    fits shared memory and the blocks an SM it assumes; four splits at the
    probe's shape on an H100 (96 column blocks, three an SM)."""
    import dgq_tpu_torch.ops.fused_decode as fd

    stages = k // t2.GEMV_STAGE_K
    for sms in (132, 78):
        plan = t3.s4_plan(n, k, sms)
        assert stages % plan.splits == 0 and plan.splits * plan.sps == stages
        assert plan.smem == fd.fused_smem(t3.S4_BM, plan.sps, t3.S4_STAGE_BYTES) <= fd.SMEM_LIMIT
        assert plan.per_sm * (plan.smem + 1024) <= fd.SMEM_PER_SM
        assert plan in t2.gemv_candidates(-(-n // 128) * 128, k, t3.S4_BM, t3.S4_STAGE_BYTES)
    if (n, k) == (t3.N, t3.K):
        assert t3.s4_plan(n, k, 132).splits == 4
    cu = (ROOT / "dgq_tpu_torch" / "csrc" / "s4_gemv.cu").read_text()
    hdr = (ROOT / "dgq_tpu_torch" / "csrc" / "fused_gemv_sm90.cuh").read_text()
    assert f"constexpr int S4_BM = {t3.S4_BM};" in cu
    assert "fused_smem(S4_BM, sps, FusedS4<false>::STAGE)" in cu
    assert "W_ROWS = 128, W_BYTES = 128 * 64, R = 0, STAGE = W_BYTES;" in hdr
    assert t3.S4_STAGE_BYTES == 128 * 64
    assert cu.count(f"__launch_bounds__(F_THREADS, {t2.GEMV_MAX_PER_SM})") == 1


def test_p3_wrappers_take_a_plan_and_the_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    wb = torch.from_numpy(_ints(rng, -128, 128, (256, 512)))
    x = torch.from_numpy(_ints(rng, -8, 8, (16, 256)))
    for plan in t2.gemv_candidates(1024, 256, t3.S4_BM, t3.S4_STAGE_BYTES):
        assert torch.equal(t3.pallas_s4(x, wb, plan=plan), t3.pallas_s4_plain(x, wb))
        assert torch.equal(t3.pallas_s4_bitcast(x, wb, plan=plan),
                           t3.pallas_s4_bitcast_plain(x, wb))


@pytest.mark.parametrize("name", ["roofline_probe", "probe_gemv_engines", "probe_native_s4",
                                  "probe_s4_bitcast_numerics", "probe_quant_pv_parts"])
def test_probe_main_runs_on_the_cpu(name, capsys):
    """Each probe's main with ``--cpu``: its plain versions, host times."""
    mod = importlib.import_module(f"dgq_tpu_torch.scripts.{name}")
    short = {"roofline_probe": ["--pairs", "1"], "probe_quant_pv_parts": ["--cycles", "1"]}
    res = mod.main(["--cpu", "--iters", "4", *short.get(name, ["--reps", "1"])])
    assert isinstance(res, dict) and res
    assert "(host)" in capsys.readouterr().out
