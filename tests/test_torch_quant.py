"""The port's quantization primitives held against dgq_tpu on the CPU.

Inputs are made from a seed with numpy and carried into both packages.

* ``find_params`` (min/max and the MSE grid, asym and sym, a zero row),
  ``find_params_weight_grouped`` and ``quantize_with`` (JAX's under
  ``jax.jit``, as its callers run them: XLA divides by maxq as a product
  with its fp32 reciprocal, and so does the port); the four activation
  quantizers; ``pack_linear`` (4, 3 and 8 bits), ``pack_linear_w4w8``,
  ``dequantize_linear`` and ``dequantize_to_int8``: equal.
* ``_outlier_scales``, ``smooth_llama_layer``, the weight-only recipe and
  ``mean_ln_fcs``: within 1e-6 relative.
* ``search_quantize`` (plain, w4w8, ``with_fallback``) and ``naive_quantize``
  on fixed weights and ``inp1``: scales, zeros, scale8 and codes equal.  A
  row keeps the first grid point of least fp32 MSE (``best > mse``,
  ``dgq_tpu/quant/search.py:73``, ``:181``), and the sums run in another
  order in XLA than in torch, so a near tie can flip a row's choice: the
  test names each such row and holds the two candidates' MSEs (float64, from
  the same fp32 candidate weights) within 1e-6 relative of each other; any
  other difference fails.
* ``gptq_quantize`` with ``act_order`` off and on, on a full-rank Hessian
  (512 tokens for K 256, as calibration's 18 x 2048 tokens make it; a
  rank-deficient one amplifies the last-ulp differences of torch's Cholesky
  from XLA's into whole groups): at least 99.5% of codes equal and every
  other code one step off; the rate is printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.quant import act_quant as jaq
from dgq_tpu.quant import gptq as jgptq
from dgq_tpu.quant import packing as jpk
from dgq_tpu.quant import quantizer as jqz
from dgq_tpu.quant import search as jsearch
from dgq_tpu.quant import smooth as jsm
from dgq_tpu_torch.quant import act_quant as taq
from dgq_tpu_torch.quant import gptq as tgptq
from dgq_tpu_torch.quant import packing as tpk
from dgq_tpu_torch.quant import quantizer as tqz
from dgq_tpu_torch.quant import search as tsearch
from dgq_tpu_torch.quant import smooth as tsm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(seed, n=128, k=512):
    """Gaussian weights with a few outlier input columns."""
    r = np.random.default_rng(seed)
    w = (r.standard_normal((n, k)) * 0.05).astype(np.float32)
    w[:, r.integers(0, k, 4)] *= 8
    return w


def _acts(seed, t=64, k=512):
    return np.random.default_rng(seed + 100).standard_normal((t, k)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


# ---------------------------------------------------------------------------
# quantizer, act quant, packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("mse", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_find_params_matches_jax(sym, mse, bits):
    x = _weights(1, 48, 128)
    x[3] = 0.0  # the zero-range row
    x[5] = np.abs(x[5])  # xmin clamps to 0
    a = jax.jit(jqz.find_params, static_argnums=1, static_argnames=("sym", "mse"))(
        jnp.asarray(x), bits, sym=sym, mse=mse)
    b = tqz.find_params(_t(x), bits, sym=sym, mse=mse)
    assert a.maxq == b.maxq
    np.testing.assert_array_equal(np.asarray(a.scale), _np(b.scale))
    np.testing.assert_array_equal(np.asarray(a.zero), _np(b.zero))
    qa = jqz.quantize_with(a._replace(scale=a.scale[:, None], zero=a.zero[:, None]),
                           jnp.asarray(x))
    qb = tqz.quantize_with(b._replace(scale=b.scale[:, None], zero=b.zero[:, None]), _t(x))
    np.testing.assert_array_equal(np.asarray(qa), _np(qb))


@pytest.mark.parametrize("groupsize", [32, 128, -1])
def test_grouped_params_and_affine_values_match_jax(groupsize):
    w = _weights(2, 64, 256)
    a = jax.jit(jqz.find_params_weight_grouped, static_argnums=(1, 2))(jnp.asarray(w), 4,
                                                                       groupsize)
    b = tqz.find_params_weight_grouped(_t(w), 4, groupsize)
    np.testing.assert_array_equal(np.asarray(a.scale), _np(b.scale))
    np.testing.assert_array_equal(np.asarray(a.zero), _np(b.zero))
    gs = 256 if groupsize == -1 else groupsize
    wg = w.reshape(-1, gs)
    va = jqz.affine_quantize_values(jnp.asarray(wg), a.scale[:, None], a.zero[:, None], 15)
    vb = tqz.affine_quantize_values(_t(wg), b.scale[:, None], b.zero[:, None], 15)
    np.testing.assert_array_equal(np.asarray(va), _np(vb))


@pytest.mark.parametrize("method", ["static", "per_tensor", "per_token", "per_tensor_asym",
                                    None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [6, 24])
def test_act_quant_matches_jax(method, dtype, rows):
    r = np.random.default_rng(3)
    x = (r.standard_normal((2, rows, 64)) * 2).astype(np.float32)
    x[0, 1, 7] = 40.0  # an outlier channel
    absmax = np.float32(np.abs(x).max() * 0.8)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = _t(x).to(getattr(torch, dtype))
    a = jaq.make_act_quant_fn(method, 8)(xj, jnp.asarray(absmax))
    b = taq.make_act_quant_fn(method, 8)(xt, torch.tensor(absmax))
    assert b.dtype == xt.dtype
    np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), _np(b))


def _packed_equal(a, b):
    for f in ("qweight", "wscales", "wzeros", "wscales8", "bias", "amax"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.asarray(x).dtype == _np(y).dtype or f == "qweight", f
            np.testing.assert_array_equal(np.asarray(x), _np(y), err_msg=f)
    for f in ("in_features", "out_features", "groupsize", "w4w8", "act_method", "abits",
              "span", "wbits"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("bits,groupsize,k", [(4, 128, 512), (4, 64, 192), (3, 32, 256),
                                              (8, 128, 256)])
def test_pack_linear_and_dequantize_match_jax(bits, groupsize, k):
    w = _weights(4, 96, k)
    scale, zero, qw = jsearch.naive_quantize(jnp.asarray(w), bits=bits, groupsize=groupsize)
    bias = np.random.default_rng(5).standard_normal(96).astype(np.float32)
    a = jpk.pack_linear(qw, scale.reshape(-1), zero.reshape(-1), groupsize,
                        bias=jnp.asarray(bias), amax=jnp.float32(3.5), bits=bits)
    b = tpk.pack_linear(_t(qw), _t(scale).reshape(-1), _t(zero).reshape(-1), groupsize,
                        bias=_t(bias), amax=torch.tensor(3.5), bits=bits)
    _packed_equal(a, b)
    assert b.qweight.dtype == {4: torch.int8, 3: torch.int8, 8: torch.uint8}[bits]
    np.testing.assert_array_equal(np.asarray(jpk.dequantize_linear(a)),
                                  _np(tpk.dequantize_linear(b)))


@pytest.mark.parametrize("groupsize,k", [(128, 512), (64, 192)])
def test_pack_linear_w4w8_and_int8_dequant_match_jax(groupsize, k):
    w, x = _weights(6, 96, k), _acts(6, 32, k)
    res = jsearch.search_quantize(jnp.asarray(w), jnp.asarray(x), groupsize=groupsize)
    a = jpk.pack_linear_w4w8(res.qweight_fp, res.scale, res.zero, res.scale8, groupsize,
                             amax=jnp.float32(2.0))
    b = tpk.pack_linear_w4w8(_t(res.qweight_fp), _t(res.scale), _t(res.zero),
                             _t(res.scale8), groupsize, amax=torch.tensor(2.0))
    _packed_equal(a, b)
    np.testing.assert_array_equal(np.asarray(jpk.dequantize_linear(a)),
                                  _np(tpk.dequantize_linear(b)))
    np.testing.assert_array_equal(np.asarray(jpk.dequantize_to_int8(a)),
                                  _np(tpk.dequantize_to_int8(b)))
    # arbitrary fp weights (not the search's): the int8-range clamp decides codes
    w2 = w * 3.0
    a2 = jpk.pack_linear_w4w8(jnp.asarray(w2), res.scale, res.zero, res.scale8, groupsize)
    b2 = tpk.pack_linear_w4w8(_t(w2), _t(res.scale), _t(res.zero), _t(res.scale8), groupsize)
    _packed_equal(a2, b2)
    # carried across by packed_linear_from_arrays
    _packed_equal(a, tpk.packed_linear_from_arrays(a, device="cpu"))


# ---------------------------------------------------------------------------
# smoothing
# ---------------------------------------------------------------------------


def _layer_arrays(seed, d=64, f=160, bias=False):
    r = np.random.default_rng(seed)

    def lin(n, k):
        out = {"weight": (r.standard_normal((n, k)) * 0.1).astype(np.float32)}
        if bias:
            out["bias"] = r.standard_normal(n).astype(np.float32)
        return out

    return {"input_layernorm": {"weight": (1 + 0.1 * r.standard_normal(d)).astype(np.float32)},
            "self_attn": {n: lin(d, d) for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "post_attention_layernorm": {"weight": np.ones(d, np.float32)},
            "mlp": {"gate_proj": lin(f, d), "up_proj": lin(f, d), "down_proj": lin(d, f)}}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _tree_close(a, b, rtol):
    for k in a:
        if isinstance(a[k], dict):
            _tree_close(a[k], b[k], rtol)
        else:
            assert _rel(_np(b[k]), np.asarray(a[k])) <= rtol, k


@pytest.mark.parametrize("n", [64, 400, 4096])
def test_outlier_scales_match_jax(n):
    s = np.abs(np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    s[:3] *= 50
    assert _rel(_np(tsm._outlier_scales(_t(s))), jsm._outlier_scales(jnp.asarray(s))) <= 1e-6
    tiny = s * 1e-6  # baseline under 1e-4: no smoothing
    np.testing.assert_array_equal(_np(tsm._outlier_scales(_t(tiny))), np.ones(n, np.float32))


@pytest.mark.parametrize("weight_only", [False, True])
def test_smooth_llama_layer_matches_jax(weight_only):
    layer = _layer_arrays(7)
    r = np.random.default_rng(8)
    stats = {"attn_ln_out_absmax": np.abs(r.standard_normal(64) * 3).astype(np.float32),
             "mlp_ln_out_absmax": np.abs(r.standard_normal(64) * 3).astype(np.float32),
             "down_proj_inp_absmax": np.abs(r.standard_normal(160) * 3).astype(np.float32)}
    stats["attn_ln_out_absmax"][5] = 90.0
    if weight_only:
        a = jsm.smooth_llama_layer_weight_only(_map(jnp.asarray, layer))
        b = tsm.smooth_llama_layer_weight_only(_map(_t, layer))
    else:
        a = jsm.smooth_llama_layer(_map(jnp.asarray, layer), _map(jnp.asarray, stats))
        b = tsm.smooth_llama_layer(_map(_t, layer), _map(_t, stats))
    _tree_close(a, b, 1e-6)


def test_mean_ln_fcs_matches_jax():
    layer = _layer_arrays(9, bias=True)
    med = np.random.default_rng(10).standard_normal(64).astype(np.float32)
    ws = [layer["self_attn"][n]["weight"] for n in ("q_proj", "k_proj")]
    bs = [layer["self_attn"]["q_proj"]["bias"], None]
    a_ln, a_bs = jsm.mean_ln_fcs(jnp.asarray(layer["input_layernorm"]["weight"]), None,
                                 [jnp.asarray(w) for w in ws],
                                 [None if b is None else jnp.asarray(b) for b in bs],
                                 jnp.asarray(med))
    b_ln, b_bs = tsm.mean_ln_fcs(_t(layer["input_layernorm"]["weight"]), None,
                                 [_t(w) for w in ws], [None if b is None else _t(b) for b in bs],
                                 _t(med))
    assert _rel(_np(b_ln), a_ln) <= 1e-6
    for x, y in zip(a_bs, b_bs):
        assert _rel(_np(y), x) <= 1e-6


# ---------------------------------------------------------------------------
# search and naive
# ---------------------------------------------------------------------------


def _mse64(x, w_row, wq_row):
    x = x.astype(np.float64)
    return float(np.mean((x @ w_row.astype(np.float64) - x @ wq_row.astype(np.float64)) ** 2))


def _stage1_candidates(w, x, row, g, gs, grid=20):
    """Each stage-1 grid point of one (row, group), as the search computes
    it in fp32 (the clamp cumulative): (bf16 scale, zero, float64 MSE)."""
    w_t0 = torch.from_numpy(w[row:row + 1, g * gs:(g + 1) * gs].copy())
    xg = x[:, g * gs:(g + 1) * gs]
    w_max, w_min = w_t0.amax(-1, keepdim=True), w_t0.amin(-1, keepdim=True)
    w_t, out = w_t0, []
    for i in range(grid):
        r = tsearch._ratio(i, grid, 1.02, 0.22, "cpu")
        w_t = torch.clamp(w_t, w_min * r, w_max * r)
        qs = (w_max * r - w_min * r) * tqz.recip(15)
        qz = torch.round(-w_min * r / qs)
        wq = qs * (torch.clamp(torch.round(w_t / qs) + qz, 0, 15) - qz)
        out.append((float(tpk.bf16_round(qs)), float(qz), _mse64(xg, w_t0[0].numpy(),
                                                                       wq[0].numpy())))
    return out


def _stage2_candidates(w, x, scale1, zero1, row, gs, grid=80):
    """Each stage-2 grid point of one row: (bf16 scale8, float64 MSE)."""
    w_r = torch.from_numpy(w[row:row + 1].copy())
    absmax = w_r.abs().amax(-1)
    out = []
    for i in range(grid):
        s8 = absmax * tsearch._ratio(i, grid, 1.02, 0.82, "cpu") * tqz.recip(127.0)
        wq, _ = tsearch._w4w8_requant(w_r, _t(scale1[row:row + 1]), _t(zero1[row:row + 1]), s8,
                                      gs)
        out.append((float(tpk.bf16_round(s8)), _mse64(x, w_r[0].numpy(), wq[0].numpy())))
    return out


def _near_tie(cands, chosen_a, chosen_b, what):
    """The two choices' MSEs (the least over the grid points that round to
    each chosen value) within 1e-6 relative; printed."""
    ma = min(m for c, m in cands if c == chosen_a)
    mb = min(m for c, m in cands if c == chosen_b)
    rel = abs(ma - mb) / max(ma, mb)
    print(f"near tie at {what}: JAX {chosen_a!r} (mse {ma:.9e}), torch {chosen_b!r} "
          f"(mse {mb:.9e}), relative {rel:.2e}")
    assert rel <= 1e-6, what


def _stage1_flips(w, x, gs, a, b):
    """Rows whose stage-1 choice differs, each held to a near tie."""
    rows = set()
    for row, g in zip(*np.nonzero((np.asarray(a.scale) != _np(b.scale))
                                  | (np.asarray(a.zero) != _np(b.zero)))):
        _near_tie([(s, m) for s, _, m in _stage1_candidates(w, x, row, g, gs)],
                  float(np.asarray(a.scale)[row, g]), float(_np(b.scale)[row, g]),
                  f"stage 1 row {row} group {g}")
        rows.add(int(row))
    return rows


# (seed, groupsize, inp1 drawn from the weights' generator): the last case
# holds a stage-2 near tie (row 48: two scale8 candidates whose MSEs differ by
# 5e-7 relative), so the tie handling is exercised
CASES = [(0, 128, False), (1, 64, False), (2, 128, False), (3, 64, False), (1, 64, True)]


def _case(seed, joint):
    if not joint:
        return _weights(seed), _acts(seed)
    r = np.random.default_rng(seed)
    w = (r.standard_normal((128, 512)) * 0.05).astype(np.float32)
    w[:, r.integers(0, 512, 4)] *= 8
    return w, r.standard_normal((64, 512)).astype(np.float32)


@pytest.mark.parametrize("seed,gs,joint", CASES)
def test_search_plain_matches_jax(seed, gs, joint):
    w, x = _case(seed, joint)
    a = jsearch.search_quantize(jnp.asarray(w), jnp.asarray(x), groupsize=gs, w4w8=False)
    b = tsearch.search_quantize(_t(w), _t(x), groupsize=gs, w4w8=False)
    keep = sorted(set(range(w.shape[0])) - _stage1_flips(w, x, gs, a, b))
    np.testing.assert_array_equal(np.asarray(a.qweight_fp)[keep], _np(b.qweight_fp)[keep])
    np.testing.assert_array_equal(np.asarray(a.scale8), _np(b.scale8))


def _w4w8_compare(w, x, gs, a, b, plain_a, plain_b):
    """w4w8 results equal outside rows whose stage-1 or stage-2 choice
    flipped at a near tie; packed codes too."""
    flipped = _stage1_flips(w, x, gs, plain_a, plain_b)
    s8a, s8b = np.asarray(a.scale8), _np(b.scale8)
    for row in np.nonzero(s8a != s8b)[0]:
        if int(row) in flipped:
            continue
        _near_tie(_stage2_candidates(w, x, np.asarray(plain_a.scale), np.asarray(plain_a.zero),
                                     row, gs), float(s8a[row]), float(s8b[row]),
                  f"stage 2 row {row}")
        flipped.add(int(row))
    keep = sorted(set(range(w.shape[0])) - flipped)
    for f in ("scale", "zero", "scale8", "qweight_fp"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f))[keep],
                                      _np(getattr(b, f))[keep], err_msg=f)
    pa = jpk.pack_linear_w4w8(a.qweight_fp, a.scale, a.zero, a.scale8, gs)
    pb = tpk.pack_linear_w4w8(b.qweight_fp, b.scale, b.zero, b.scale8, gs)
    ca = np.asarray(jpk.unpack_nibbles(pa.qweight, pa.span))
    cb = _np(tpk.unpack_nibbles(pb.qweight, pb.span))
    np.testing.assert_array_equal(ca[:, keep], cb[:, keep])
    return flipped


@pytest.mark.parametrize("seed,gs,joint", CASES)
def test_search_w4w8_matches_jax(seed, gs, joint):
    w, x = _case(seed, joint)
    plain_a = jsearch.search_quantize(jnp.asarray(w), jnp.asarray(x), groupsize=gs, w4w8=False)
    plain_b = tsearch.search_quantize(_t(w), _t(x), groupsize=gs, w4w8=False)
    a = jsearch.search_quantize(jnp.asarray(w), jnp.asarray(x), groupsize=gs)
    b = tsearch.search_quantize(_t(w), _t(x), groupsize=gs)
    flipped = _w4w8_compare(w, x, gs, a, b, plain_a, plain_b)
    assert len(flipped) <= 2, flipped


@pytest.mark.parametrize("seed,gs,joint", CASES[:2] + CASES[-1:])
def test_search_with_fallback_matches_jax(seed, gs, joint):
    w, x = _case(seed, joint)
    ja = jsearch.search_quantize(jnp.asarray(w), jnp.asarray(x), groupsize=gs,
                                 with_fallback=True)
    tb = tsearch.search_quantize(_t(w), _t(x), groupsize=gs, with_fallback=True)
    flipped = _w4w8_compare(w, x, gs, ja[0], tb[0], ja[1], tb[1])
    np.testing.assert_array_equal(np.asarray(ja[1].scale), _np(tb[1].scale))
    np.testing.assert_array_equal(np.asarray(ja[1].qweight_fp), _np(tb[1].qweight_fp))
    assert _rel(float(tb[3]), float(ja[3])) <= 1e-5  # the plain error
    # the w4w8 error: a flipped row's scale8 rounds (bf16) to another value
    rel = _rel(float(tb[2]), float(ja[2]))
    print(f"w4w8 layer-output error: relative difference {rel:.2e}, rows flipped {flipped}")
    assert rel <= (1e-3 if flipped else 1e-5)


@pytest.mark.parametrize("bits,gs", [(4, 128), (4, 32), (3, 64), (4, -1)])
def test_naive_quantize_matches_jax(bits, gs):
    w = _weights(11, 64, 256)
    a = jsearch.naive_quantize(jnp.asarray(w), bits=bits, groupsize=gs)
    b = tsearch.naive_quantize(_t(w), bits=bits, groupsize=gs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), _np(y))


# ---------------------------------------------------------------------------
# GPTQ
# ---------------------------------------------------------------------------


def _codes(res, gs):
    """The packed codes of a GPTQ result (as calibration packs it)."""
    pl = tpk.pack_linear(_t(res.qweight_fp), _t(res.scale).reshape(-1),
                         _t(res.zero).reshape(-1), gs)
    return tpk.unpack_nibbles(pl.qweight, pl.span).numpy().astype(np.int32)


@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("gs", [128, 32])
def test_gptq_codes_agree_with_jax(act_order, gs):
    w, x = _weights(12, 96, 256), _acts(12, 512, 256)
    x[:, 17] = 0.0  # a dead column
    hj, nj = jgptq.init_hessian(256)
    ht, nt = tgptq.init_hessian(256, "cpu")
    for i in range(0, 512, 128):  # four samples of 128 tokens: a full-rank Hessian
        hj, nj = jgptq.update_hessian(hj, nj, jnp.asarray(x[i:i + 128]))
        ht, nt = tgptq.update_hessian(ht, nt, _t(x[i:i + 128]))
    assert _rel(_np(ht), hj) <= 1e-5
    a = jgptq.gptq_quantize(jnp.asarray(w), hj, groupsize=gs, act_order=act_order)
    b = tgptq.gptq_quantize(_t(w), _t(np.asarray(hj)), groupsize=gs, act_order=act_order)
    ca, cb = _codes(a, gs), _codes(b, gs)
    equal = float(np.mean(ca == cb))
    print(f"gptq act_order={act_order} gs={gs}: {equal:.5f} of {ca.size} codes equal, "
          f"error {float(a.error):.6e} / {float(b.error):.6e}")
    assert equal >= 0.995
    assert np.abs(ca - cb).max() <= 1
    assert _rel(float(b.error), float(a.error)) <= 1e-3
