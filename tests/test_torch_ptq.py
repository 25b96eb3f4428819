"""The port's PTQ pipeline held against dgq_tpu on the CPU, on JAX's
``tiny:llama`` (hidden 256, 2 layers, 4 heads; 2 x 64 synthetic calibration
tokens; search + w4w8 + smoothing + kvquant, and once with meanact), its
params carried across by ``llama_params_from_arrays``.

* ``ptq_llama``: at least 99.9% of packed codes, int8 group scales, zeros
  and scale8 equal (the search's near ties may flip a row, see
  ``tests/test_torch_quant.py``); amax and kv scales within 1e-5 relative;
  the agreement printed.  Held for the whole model, and block by block on
  shared inputs: each block of the port calibrated on the inputs JAX's
  blocks gave it.  With activation fake-quant, kv fake-quant and smoothing
  off, every code, scale and zero of the whole model equal.
* The fake-quant ``llama_apply`` (fp, and with act, weight and kv fake-quant)
  on JAX's own PTQ result carried across: logits within 1e-3 of JAX's, the
  port's fake-quant roundings held to JAX's (``_follow_jax_roundings``).
* ``from_ptq`` and ``from_ptq_auto`` on JAX's PTQ result (dual-grained, and
  a model mixing w4w8-fallback linears): integer engine arrays (span and
  rowpair codes, int8 scales, zeros, ``cs_fold``) equal to JAX's engine
  under its save_engine names, fp arrays within 1e-6 relative.
* ``ppl_eval`` of the fake-quant forward within 1e-4 relative of JAX's, and
  the port's fake-quant and engine perplexities within 5% of each other
  (JAX's own gate, ``tests/test_accuracy_gate.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.config import ActQuantConfig as JAct, QuantConfig as JQuant, WtQuantConfig as JWt
from dgq_tpu.models import engine as jeng
from dgq_tpu.models import llama as jll
from dgq_tpu.quant import calibrate as jcal
from dgq_tpu.quant import packing as jpk
from dgq_tpu.quant import resume as jresume
from dgq_tpu.quant.calibrate import ptq_llama as jptq_llama
from dgq_tpu.utils import evalutils as jev
from dgq_tpu.utils.datautils import synthetic_stream as jsynthetic_stream
from dgq_tpu_torch.config import ActQuantConfig, QuantConfig, WtQuantConfig
from dgq_tpu_torch.models import engine as teng
from dgq_tpu_torch.models import llama as tll
from dgq_tpu_torch.quant import packing as tpk
from dgq_tpu_torch.quant.calibrate import calibrate_layer, ptq, ptq_llama
from dgq_tpu_torch.utils import evalutils as tev
from dgq_tpu_torch.utils.checkpoint import engine_arrays
from dgq_tpu_torch.utils.datautils import synthetic_stream
from dgq_tpu_torch.utils.metrics import QuantReport

SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    kw = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=4)
    return jll.tiny_llama_config(**kw), tll.tiny_llama_config(**kw)


def _qcfgs(meanact=False, fallback=None, roundings=True):
    """search + w4w8 + smoothing + kvquant + static activation quant; without
    ``roundings`` no activation fake-quant, no kv fake-quant, no smoothing."""
    wt = dict(method="search", w4w8=True, groupsize=128, w4w8_fallback_ratio=fallback)
    q = dict(smoothquant=roundings, kvquant=roundings, meanact=meanact)
    return (JQuant(act_quant=JAct() if roundings else None, wt_quant=JWt(**wt), **q),
            QuantConfig(act_quant=ActQuantConfig() if roundings else None,
                        wt_quant=WtQuantConfig(**wt), **q))


def jax_ptq_with_inputs(jparams, jcfg, calib, jq):
    """JAX's ``ptq`` and the input of each of its blocks (numpy, block 0's
    the embeddings), read through its resume hook: ``save_ptq_state`` gets
    the running activations after every block."""
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jresume, "load_ptq_state", lambda resume_dir: None)
        mp.setattr(jresume, "save_ptq_state", lambda resume_dir, nxt, layers, kv, inps:
                   outs.__setitem__(nxt, np.asarray(inps)))
        res = jcal.ptq(jparams, jcfg, jnp.asarray(calib), jq, arch="llama", verbose=False,
                       resume_dir="unused")
    inputs = [np.array(jll.llama_embed(jparams, jnp.asarray(calib)))]
    inputs += [np.array(outs[li]) for li in range(1, len(jparams["layers"]))]
    return res, inputs


def _kv(kvs):
    return [None if kv is None else tll.KVQuantState(*(tpk.tensor_from_array(x) for x in kv))
            for kv in kvs]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jparams = jll.init_llama_params(jcfg, jax.random.PRNGKey(0))
    tparams = tll.llama_params_from_arrays(jparams, "cpu")
    calib = jsynthetic_stream(jcfg.vocab_size, 2 * SEQ).reshape(2, SEQ)
    np.testing.assert_array_equal(calib, synthetic_stream(tcfg.vocab_size, 2 * SEQ).reshape(2, SEQ))
    out = {"jcfg": jcfg, "tcfg": tcfg, "jparams": jparams, "tparams": tparams, "calib": calib}
    for name, kw in (("plain", {}), ("meanact", {"meanact": True})):
        jq, tq = _qcfgs(**kw)
        jres, inputs = jax_ptq_with_inputs(jparams, jcfg, calib, jq)
        out[name] = (jres, ptq_llama(tparams, tcfg, calib, tq, verbose=False))
        out[name + "_inputs"] = inputs
    return out


def _linears(params):
    for li, layer in enumerate(params["layers"]):
        for sub in ("self_attn", "mlp"):
            for name in sorted(layer[sub]):  # JAX's tree_map sorts dict keys
                yield f"{li}.{name}", layer[sub][name]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _agreement(jlayers, tlayers, jkv, tkv):
    """Equal shares of two PTQ results' packed codes, int8 group scales,
    zeros and scale8 over ``jlayers``/``tlayers``; amax, the folded biases,
    the kv scales and the norms' weights asserted on the way."""
    counts = {k: [0, 0] for k in ("codes", "wscales", "wzeros", "wscales8")}
    for (name, a), (_, b) in zip(_linears({"layers": jlayers}), _linears({"layers": tlayers})):
        assert isinstance(b, tpk.PackedLinear) and b.w4w8 and a.span == b.span, name
        pairs = {"codes": (jpk.unpack_nibbles(a.qweight, a.span),
                           tpk.unpack_nibbles(b.qweight, b.span)),
                 "wscales": (a.wscales, b.wscales), "wzeros": (a.wzeros, b.wzeros),
                 "wscales8": (a.wscales8, b.wscales8)}
        for k, (x, y) in pairs.items():
            x, y = _np(x), _np(y)
            assert x.shape == y.shape and x.dtype == y.dtype, (name, k)
            counts[k][0] += int(np.sum(x == y))
            counts[k][1] += x.size
        assert (a.amax is None) == (b.amax is None), name
        if a.amax is not None:
            assert _rel(_np(b.amax), _np(a.amax)) <= 1e-5, name
        assert (a.bias is None) == (b.bias is None), name
        if a.bias is not None:  # meanact's W @ mid-range: sums that cancel
            assert _rel(_np(b.bias), _np(a.bias)) <= 1e-3, name
    for ka, kb in zip(jkv, tkv):
        assert (ka is None) == (kb is None)
        for x, y in zip(ka or (), kb or ()):
            assert _rel(_np(y), _np(x)) <= 1e-5
    for li, (la, lb) in enumerate(zip(jlayers, tlayers)):
        for ln in ("input_layernorm", "post_attention_layernorm"):
            assert _rel(_np(lb[ln]["weight"]), _np(la[ln]["weight"])) <= 1e-5, (li, ln)
    return {k: eq / n for k, (eq, n) in counts.items()}


@pytest.mark.parametrize("variant", ["plain", "meanact"])
def test_ptq_llama_matches_jax(setup, variant):
    """The whole model, and each block on the inputs JAX's blocks gave it
    (``calibrate_layer``): the shares printed, each >= 99.9%."""
    jres, tres = setup[variant]
    jlayers = jres.params["layers"]
    shares = _agreement(jlayers, tres.params["layers"], jres.kv_scales, tres.kv_scales)
    print(f"ptq {variant}: whole model, equal shares {shares}")
    for k, share in shares.items():
        assert share >= 0.999, (k, share)
    _, tq = _qcfgs(meanact=variant == "meanact")
    for li, inp in enumerate(setup[variant + "_inputs"]):
        got = calibrate_layer(setup["tparams"]["layers"][li], torch.from_numpy(inp),
                              setup["tcfg"], tq)
        shares = _agreement(jlayers[li:li + 1], [got.layer], jres.kv_scales[li:li + 1],
                            [got.kv_scales])
        print(f"ptq {variant}: block {li} on JAX's inputs, equal shares {shares}")
        for k, share in shares.items():
            assert share >= 0.999, (li, k, share)


def test_ptq_llama_without_roundings_matches_jax_exactly(setup):
    """No activation fake-quant, no kv fake-quant, no smoothing: nothing
    rounds between the blocks, so ulp-level differences of the fp forward
    cannot move a code, and the whole model's codes, scales and zeros equal
    JAX's; amax is not calibrated."""
    jq, tq = _qcfgs(roundings=False)
    jres = jptq_llama(setup["jparams"], setup["jcfg"], jnp.asarray(setup["calib"]), jq,
                      verbose=False)
    tres = ptq_llama(setup["tparams"], setup["tcfg"], setup["calib"], tq, verbose=False)
    assert all(kv is None for kv in tres.kv_scales)
    shares = _agreement(jres.params["layers"], tres.params["layers"], jres.kv_scales,
                        tres.kv_scales)
    assert all(share == 1.0 for share in shares.values()), shares


def _carried(res):
    """JAX's PTQ result as the port's params and kv scales."""
    return tll.llama_params_from_arrays(res.params, "cpu"), _kv(res.kv_scales)


QUANT_MODES = {"fp": {}, "wtq": dict(wtq=True), "wtq_kv": dict(wtq=True, kv=True),
               "full": dict(actq=True, wtq=True, kv=True)}
TIE = 1e-3  # a code that may round either way: within this many steps of x.5


def _codes(x, scale, kind):
    """The integer codes of a fake-quant: static activation quant
    (symmetric, 127) or the kv fake-quant (zero 128)."""
    q = np.round(x / scale)
    return np.clip(q, -127, 127) if kind == "act" else np.clip(q + 128, 0, 255)


def _tie_checked(kind, xj, xt, scale, yj, yt, ties):
    """JAX's fake-quant output where the port's rounds the same codes or
    rounds a value at a near tie the other way (one step, both values
    within TIE of the x.5 between the codes); any other difference fails."""
    cj, ct = _codes(xj, scale, kind), _codes(xt, scale, kind)
    diff = cj != ct
    if diff.any():
        lo = np.minimum(cj, ct)[diff] - (128 if kind == "kv" else 0)
        dist = np.maximum(np.abs(xj[diff] / scale - lo - 0.5), np.abs(xt[diff] / scale - lo - 0.5))
        assert np.all(np.abs(cj - ct)[diff] == 1) and dist.max() <= TIE, (kind, dist.max())
        ties.append((kind, int(diff.sum()), float(dist.max())))
    np.testing.assert_array_equal(yt[~diff], yj[~diff])
    return yj


def _follow_jax_roundings(mp):
    """Record every fake-quant rounding of JAX's forward (activation quant
    and kv fake-quant, in call order), then hold the port's to them: each
    code equal to JAX's, or a near tie rounded the other way after ulp-level
    differences of the norms and matmuls before it, where the port takes
    JAX's code (``_tie_checked``) so that one rounding does not move every
    later position.  Returns (JAX's records, the ties followed)."""
    log, ties = [], []
    j_act, t_act = jll.make_act_quant_fn, tll.make_act_quant_fn
    j_kv, t_kv = jll._kv_fake_quant, tll._kv_fake_quant

    def j_act_fn(method, bits=8):
        assert method == "static" and bits == 8, (method, bits)
        f = j_act(method, bits)

        def g(x, absmax):
            y = f(x, absmax)
            log.append(("act", np.asarray(x), np.float32(absmax) / np.float32(127),
                        np.asarray(y)))
            return y
        return g

    def j_kv_fn(x, scale):
        y = j_kv(x, scale)
        log.append(("kv", np.asarray(x), np.float32(scale), np.asarray(y)))
        return y

    def follow(kind, x, scale, y):
        rkind, xj, sj, yj = log.pop(0)
        assert rkind == kind and xj.shape == tuple(x.shape) and sj == scale, (rkind, kind)
        return torch.from_numpy(np.array(_tie_checked(kind, xj, x.numpy(), sj, yj, y.numpy(),
                                                      ties)))

    def t_act_fn(method, bits=8):
        f = t_act(method, bits)
        return lambda x, absmax: follow("act", x, np.float32(absmax.numpy()) / np.float32(127),
                                        f(x, absmax))

    mp.setattr(jll, "make_act_quant_fn", j_act_fn)
    mp.setattr(jll, "_kv_fake_quant", j_kv_fn)
    mp.setattr(tll, "make_act_quant_fn", t_act_fn)
    mp.setattr(tll, "_kv_fake_quant", lambda x, scale: follow(
        "kv", x, np.float32(scale.numpy()), t_kv(x, scale)))
    return log, ties


@pytest.mark.parametrize("variant", ["plain", "meanact"])
@pytest.mark.parametrize("mode", list(QUANT_MODES))
def test_fake_quant_forward_matches_jax(setup, variant, mode, monkeypatch):
    """Logits within 1e-3 of JAX's.  A fake-quant code of the port may round
    a near tie the other way (``_follow_jax_roundings``: any other
    difference fails); the port then takes JAX's code, since one code a step
    off moves that token's q, k and v and so every later position (by up to
    0.03 on this model, ROADMAP Queue 3).  The ties are printed, with the
    logits of a run that does not follow them."""
    jres, _ = setup[variant]
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    qs = QUANT_MODES[mode]
    if qs:
        tparams, tkv = _carried(jres)
        free = _np(tll.llama_apply(tparams, torch.from_numpy(ids), tcfg, tll.QuantState(**qs),
                                   tkv))
        log, ties = _follow_jax_roundings(monkeypatch)
        a = jll.llama_apply(jres.params, jnp.asarray(ids), jcfg, jll.QuantState(**qs),
                            jres.kv_scales)
        b = tll.llama_apply(tparams, torch.from_numpy(ids), tcfg, tll.QuantState(**qs), tkv)
        assert not log, len(log)  # every rounding of JAX's was met by the port's
    else:
        a = jll.llama_apply(setup["jparams"], jnp.asarray(ids), jcfg)
        b = tll.llama_apply(setup["tparams"], torch.from_numpy(ids), tcfg)
        free, ties = _np(b), []
    a, b = np.asarray(a), _np(b)
    err = float(np.max(np.abs(b - a)))
    free_err = float(np.max(np.abs(free - a)))
    top1 = float(np.mean(a.argmax(-1) == free.argmax(-1)))
    print(f"fake-quant logits ({variant}, {mode}): max abs err {err:.3e}; ties followed {ties}; "
          f"not following them: max abs err {free_err:.3e}, top-1 equal {top1:.3f}")
    assert err <= 1e-3


def _jax_engine_arrays(eng):
    leaves, _ = jax.tree_util.tree_flatten_with_path(eng)
    return {"/".join(str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k))))
                     for k in path): np.asarray(leaf) for path, leaf in leaves}


def _engines_match(jeng_params, teng_params):
    ja, ta = _jax_engine_arrays(jeng_params), engine_arrays(teng_params)
    assert set(ja) == set(ta), set(ja) ^ set(ta)
    for key, x in ja.items():
        y = _np(ta[key])
        x = _np(x)
        assert x.shape == y.shape and x.dtype == y.dtype, (key, x.dtype, y.dtype)
        if np.issubdtype(x.dtype, np.integer):
            np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            assert _rel(y, x) <= 1e-6, key
    assert teng_params.rms_eps == jeng_params.rms_eps


@pytest.mark.parametrize("keep_span", [False, True])
def test_from_ptq_matches_jax(setup, keep_span):
    jres, _ = setup["plain"]
    tparams, tkv = _carried(jres)
    _engines_match(jeng.from_ptq(jres.params, jres.kv_scales, setup["jcfg"], keep_span=keep_span),
                   teng.from_ptq(tparams, tkv, setup["tcfg"], keep_span=keep_span))


@pytest.fixture(scope="module")
def mixed(setup):
    """A model mixing dual-grained and w4w8-fallback linears: JAX's PTQ with
    every linear falling back (ratio 0), its layer 0 beside layer 1 of the
    dual-grained run."""
    jq, _ = _qcfgs(fallback=0.0)
    fb = jptq_llama(setup["jparams"], setup["jcfg"], jnp.asarray(setup["calib"]), jq,
                    verbose=False)
    jres, _ = setup["plain"]
    params = {**jres.params, "layers": [fb.params["layers"][0], jres.params["layers"][1]]}
    return params, [fb.kv_scales[0], jres.kv_scales[1]]


def test_from_ptq_auto_mixed_fallback_matches_jax(setup, mixed):
    jparams, jkv = mixed
    assert not all(lin.w4w8 for _, lin in _linears(jparams))
    tparams = tll.llama_params_from_arrays(jparams, "cpu")
    jecfg, je = jeng.from_ptq_auto(jparams, jkv, setup["jcfg"])
    tecfg, te = teng.from_ptq_auto(tparams, _kv(jkv), setup["tcfg"])
    assert jecfg.fp_scales and tecfg.fp_scales
    _engines_match(je, te)
    # the engine runs: prefill logits of the fp-scale engine against the fake-quant forward
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 32)).astype(np.int32))
    cache = teng.init_kv_cache(setup["tcfg"], 1, 64, device="cpu")
    logits, _ = teng.engine_forward(tecfg, te, ids, cache)
    fq = tll.llama_apply(tparams, ids, setup["tcfg"], tll.QuantState(True, True, True),
                         _kv(jkv))
    agree = float((logits.argmax(-1) == fq.argmax(-1)).float().mean())
    assert agree > 0.8, agree


def test_ppl_eval_matches_jax_and_engine(setup):
    jres, _ = setup["plain"]
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    tparams, tkv = _carried(jres)
    stream = jsynthetic_stream(jcfg.vocab_size, 4 * SEQ, seed=5)
    qs = dict(actq=True, wtq=True, kv=True)
    jqs = jll.QuantState(**qs)
    ppl_j = jev.ppl_eval(lambda ps, ids: jll.llama_apply(ps[0], ids, jcfg, jqs, ps[1]),
                         (jres.params, jres.kv_scales), stream, seqlen=SEQ)
    tqs = tll.QuantState(**qs)
    ppl_t = tev.ppl_eval(lambda ps, ids: tll.llama_apply(ps[0], ids, tcfg, tqs, ps[1]),
                         (tparams, tkv), stream, seqlen=SEQ)
    print(f"ppl fake-quant: JAX {ppl_j:.6f}, port {ppl_t:.6f}")
    assert abs(ppl_t - ppl_j) / ppl_j <= 1e-4
    # the port's own PTQ: fake-quant and engine perplexities track each other
    _, tres = setup["plain"]
    ppl_fq = tev.ppl_eval(lambda ps, ids: tll.llama_apply(ps[0], ids, tcfg, tqs, ps[1]),
                          (tres.params, tres.kv_scales), stream, seqlen=SEQ)
    ecfg, eng = teng.from_ptq_auto(tres.params, tres.kv_scales, tcfg)
    ppl_eng = tev.ppl_eval_engine(ecfg, eng, stream, seqlen=SEQ)
    print(f"ppl port: fake-quant {ppl_fq:.4f}, engine {ppl_eng:.4f}")
    assert np.isfinite(ppl_fq) and np.isfinite(ppl_eng)
    assert abs(ppl_eng - ppl_fq) / ppl_fq < 0.05


def test_ptq_report_and_offload(setup):
    """``report=`` gathers one record a linear; ``offload=True`` (params in
    host memory, each layer moved to the compute device) gives the same
    result."""
    _, tq = _qcfgs()
    report, timings = QuantReport(), []
    res = ptq(setup["tparams"], setup["tcfg"], setup["calib"], tq, verbose=False, report=report,
              offload=True, device="cpu", timings=timings)
    assert len(report.records) == 14 and report.summary()["n_linears"] == 14
    assert all(r.output_snr is not None and r.output_snr < 0.1 for r in report.records)
    assert [t["layer"] for t in timings] == [0, 1]
    assert {"pass1", "pass2", "pass3", "search:q_proj", "pack:down_proj"} <= set(timings[0])
    _, base = setup["plain"]
    for (name, a), (_, b) in zip(_linears(base.params), _linears(res.params)):
        assert torch.equal(a.qweight, b.qweight) and torch.equal(a.wscales, b.wscales), name


def test_unported_options_raise(setup):
    _, tq = _qcfgs()
    with pytest.raises(NotImplementedError, match="item 7"):
        ptq(setup["tparams"], setup["tcfg"], setup["calib"], tq, mesh=object())
    with pytest.raises(NotImplementedError, match="item 4"):
        ptq(setup["tparams"], setup["tcfg"], setup["calib"], tq, resume_dir="/nonexistent")
    with pytest.raises(NotImplementedError, match="item 4"):
        ptq(setup["tparams"], setup["tcfg"], setup["calib"], tq, arch="opt")
