"""The Mixtral (sparse-MoE) engine and its serving, the router and the INT8
bmm held against dgq_tpu on the CPU.

* ``route_topk`` against JAX's on random rows and on rows with tied
  probabilities (JAX's top_k puts the lower expert first among equals).
* ``mixtral_engine_forward``: prefill and decode logits within 1e-4 of
  JAX's, on engines made by JAX's ``ptq`` at tiny size (4 experts, top 2,
  GQA 2:1), once with int8 group scales and once mixed (every linear fallen
  back to fp32 group scales: ``fp_scales``, K10's plain version), carried
  over by ``mixtral_engine_params_from_arrays``; their checkpoints both
  ways and ``fp_scales_of``; ``family_batcher("mixtral")`` against JAX's
  (chunked prefill, a prefix, ``decode_steps=4``): equal tokens, with
  ``batcher_from_checkpoint`` taking ``fp_scales`` from the stored scales.
* ``bmm_s8t_s8n_f32t`` and ``BMM_S8T_S8N_F32T`` against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.config import ActQuantConfig, QuantConfig, WtQuantConfig
from dgq_tpu.models import mixtral as jmix
from dgq_tpu.models import mixtral_engine as jme
from dgq_tpu.ops import bmm as jbmm
from dgq_tpu.quant.calibrate import ptq
from dgq_tpu.serving import family_batch_engine as jfam
from dgq_tpu.serving.scheduler import Request as JRequest
from dgq_tpu.utils import checkpoint as jck
from dgq_tpu.utils.datautils import synthetic_stream
from dgq_tpu_torch.models import mixtral as tmix
from dgq_tpu_torch.models import mixtral_engine as tme
from dgq_tpu_torch.ops import bmm as tbmm
from dgq_tpu_torch.serving import family_batch_engine as tfam
from dgq_tpu_torch.serving.scheduler import Request
from dgq_tpu_torch.utils import checkpoint as tck

MAX_LEN, PAD = 64, 8
KINDS = ("int8", "fp")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg):
    return tmix.MixtralConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    """kind -> (JAX's engine from ``ptq`` at tiny size, its arrays under
    save_engine's names, the port's engine carried over from them, JAX's
    save_engine file): "int8" dual-grained, "fp" with every linear fallen
    back to fp32 group scales (``w4w8_fallback_ratio=0``)."""
    cfg = jmix.tiny_mixtral_config(hidden_size=128, intermediate_size=256,
                                   num_attention_heads=4, num_key_value_heads=2)
    params = jmix.init_mixtral_params(cfg, jax.random.PRNGKey(0))
    calib = jnp.asarray(synthetic_stream(cfg.vocab_size, 2 * 32).reshape(2, 32))
    out = {}
    for kind, ratio in zip(KINDS, (None, 0.0)):
        qcfg = QuantConfig(act_quant=ActQuantConfig(),
                           wt_quant=WtQuantConfig(groupsize=32, w4w8_fallback_ratio=ratio),
                           smoothquant=True, kvquant=True)
        res = ptq(params, cfg, calib, qcfg, arch="mixtral", verbose=False)
        j = jme.from_ptq_mixtral(res.params, res.kv_scales, cfg)
        leaves, _ = jax.tree_util.tree_flatten_with_path(j)
        arrays = {"/".join(k.name for k in path): np.asarray(leaf) for path, leaf in leaves}
        t = tck.mixtral_engine_params_from_arrays(arrays, device="cpu")
        path = str(tmp_path_factory.mktemp(kind) / "mixtral.safetensors")
        jck.save_engine(path, j, cfg, arch="mixtral")
        out[kind] = (j, t, arrays, path)
    return cfg, out


def test_route_topk_matches_jax():
    """Random rows and rows of tied probabilities: the same weights and the
    same experts in the same order (the lower index first among equals)."""
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(2, 5, 8)).astype(np.float32)
    rows[0, 0] = [1.0, 2.0, 2.0, 0.5, 2.0, -1.0, 2.0, 0.0]  # four tied at the top
    rows[0, 1] = 0.25  # all tied
    rows[1, 2, 3] = rows[1, 2, 6] = rows[1, 2].max() + 1.0  # a tie for the first place
    for k in (1, 2, 3):
        jw, ji = jmix.route_topk(jnp.asarray(rows), k)
        tw, ti = tmix.route_topk(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    _, ti = tmix.route_topk(torch.from_numpy(rows), 2)
    assert ti[0, 0].tolist() == [1, 2] and ti[0, 1].tolist() == [0, 1]
    assert ti[1, 2].tolist() == [3, 6]


@pytest.mark.parametrize("kind", KINDS)
def test_mixtral_checkpoint_round_trips_with_jax(mixtral, kind, tmp_path):
    """JAX's file loads into the carried tensors bit for bit (the experts'
    leaves on (L, E, ...)); the port's file loads in JAX; ``fp_scales_of``
    reads the kind."""
    cfg, engines = mixtral
    _, t, arrays, path = engines[kind]
    loaded, tcfg = tck.load_engine(path, device="cpu")
    assert tcfg == _port_cfg(cfg) and type(loaded) is tme.MixtralEngineParams
    assert tuple(loaded.layers.w13.qweight.shape[:2]) == (cfg.num_hidden_layers,
                                                          cfg.num_local_experts)
    assert tck.fp_scales_of(loaded) == (kind == "fp")
    got = tck.engine_arrays(loaded)
    assert set(got) == set(arrays) == set(tck.engine_arrays(t))
    for key, a in arrays.items():
        assert torch.equal(got[key], torch.from_numpy(np.array(a))), key
    out = str(tmp_path / "port.safetensors")
    tck.save_engine(out, t, tcfg, arch="mixtral")
    j2, cfg2 = jck.load_engine(out)
    assert cfg2 == cfg
    for key, a in arrays.items():
        leaf = j2
        for part in key.split("/"):
            leaf = getattr(leaf, part)
        np.testing.assert_array_equal(np.asarray(leaf), a, err_msg=key)


@pytest.mark.parametrize("kind", KINDS)
def test_mixtral_engine_forward_matches_jax(mixtral, kind):
    """Prefill of 2 x 20 tokens in a cache of 128 (the port's K2 branch),
    then 6 greedy steps (K3's): logits within 1e-4, equal tokens, caches
    within one code; the parallelism knobs and INT4 KV raise."""
    cfg, engines = mixtral
    j, t, _, _ = engines[kind]
    fp = kind == "fp"
    tcfg = _port_cfg(cfg)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jecfg = jme.MixtralEngineConfig(cfg=cfg, use_kernel=False, fp_scales=fp)
    tecfg = tme.MixtralEngineConfig(cfg=tcfg, fp_scales=fp)
    jl, jc = jme.mixtral_engine_forward(jecfg, j, jnp.asarray(prompt),
                                        jme.init_mixtral_kv_cache(cfg, 2, 128))
    tl, tc = tme.mixtral_engine_forward(tecfg, t, torch.from_numpy(prompt),
                                        tme.init_mixtral_kv_cache(tcfg, 2, 128, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for _ in range(6):
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tl[:, -1:], dim=-1).numpy(), tok)
        jl, jc = jme.mixtral_engine_forward(jecfg, j, jnp.asarray(tok), jc)
        tl, tc = tme.mixtral_engine_forward(tecfg, t, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert tc.length == int(jc.length) == 26
    for got, ref in ((tc.k, jc.k), (tc.v, jc.v)):
        diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
        assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999
    with pytest.raises(ValueError, match="fp_scales"):  # the scales' kind is checked
        tme.mixtral_engine_forward(tme.MixtralEngineConfig(cfg=tcfg, fp_scales=not fp), t,
                                   torch.from_numpy(prompt),
                                   tme.init_mixtral_kv_cache(tcfg, 2, 128, device="cpu"))
    for bad in (dict(kv_bits=4), dict(ep_axis="ep"), dict(tp_axis="tp")):
        with pytest.raises(NotImplementedError):
            tme.MixtralEngineConfig(cfg=tcfg, **bad)


def _run(b, req_cls, prompts, max_new, prefix):
    b.register_prefix(prefix)
    for i, p in enumerate(prompts):
        b.add_request(req_cls(uid=i, prompt_ids=p.copy(), max_new_tokens=max_new))
    return {r.uid: r.output_ids for r in b.run()}


@pytest.mark.parametrize("kind", KINDS)
def test_mixtral_batcher_matches_jax(mixtral, kind):
    """More requests than slots, prompts past the chunk, three under the
    registered prefix, windows of 4 greedy steps: the tokens of JAX's
    batcher (built with the engine's ``fp_scales``); the port's
    ``batcher_from_checkpoint`` takes ``fp_scales`` from the stored scales
    and serves the same tokens."""
    cfg, engines = mixtral
    j, t, _, path = engines[kind]
    fp = kind == "fp"
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 10).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (6, 23, 9)]
    prompts += [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n).astype(np.int32)])
                for n in (3, 20, 7)]
    kw = dict(num_slots=3, max_len=MAX_LEN, prefill_pad=PAD, prefill_chunk=16, decode_steps=4)
    jb = jfam.family_batcher("mixtral", jme.MixtralEngineConfig(cfg=cfg, use_kernel=False,
                                                                fp_scales=fp), j, **kw)
    want = _run(jb, JRequest, prompts, 9, prefix)
    arch, tb = tfam.batcher_from_checkpoint(path, device="cpu", **kw)
    assert arch == "mixtral" and tb._f is not None and tb.ecfg.fp_scales == fp
    got = _run(tb, Request, prompts, 9, prefix)
    assert got == want and tb.prefix_hits == jb.prefix_hits == 3
    assert len({tok for toks in got.values() for tok in toks}) > 4  # not degenerate


def test_bmm_matches_jax():
    """alpha (a @ b^T) of int8 operands, batched, exact before the scale."""
    rng = np.random.default_rng(2)
    a = rng.integers(-128, 128, (2, 3, 5, 64)).astype(np.int8)
    b = rng.integers(-128, 128, (2, 3, 7, 64)).astype(np.int8)
    sa, sb = np.float32(0.013), np.float32(0.021)
    ref = np.asarray(jbmm.bmm_s8t_s8n_f32t(jnp.asarray(a), jnp.asarray(b), sa * sb))
    got = tbmm.bmm_s8t_s8n_f32t(torch.from_numpy(a), torch.from_numpy(b), sa * sb)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 5, 7)
    np.testing.assert_array_equal(got.numpy(), ref)
    mod = tbmm.BMM_S8T_S8N_F32T.from_scale(sa, sb)
    ref_mod = np.asarray(jbmm.BMM_S8T_S8N_F32T.from_scale(sa, sb)(jnp.asarray(a),
                                                                  jnp.asarray(b)))
    np.testing.assert_array_equal(mod(torch.from_numpy(a), torch.from_numpy(b)).numpy(), ref_mod)
    np.testing.assert_array_equal(tbmm.BMM_S8T_S8N_F32T()(torch.from_numpy(a),
                                                          torch.from_numpy(b)).numpy(),
                                  np.asarray(jbmm.BMM_S8T_S8N_F32T()(jnp.asarray(a),
                                                                     jnp.asarray(b))))
