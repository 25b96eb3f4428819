"""The dgq_tpu_torch BLOOM and MPT engines and the family-generic serving
(OPT, BLOOM and MPT through ``ContinuousBatcher(fns=...)``) held against
dgq_tpu on the CPU.

Each engine's weights are numpy-seeded arrays under JAX's save_engine names:
JAX's engine parameters are rebuilt from them, written by JAX's
``save_engine`` and read by the port's ``load_engine`` (and back), and
carried over by the weight-carry functions.  Then:

* ``bloom_engine_forward`` and ``mpt_engine_forward``: the logits of a
  prefill of 2 x 20 tokens (K2's plain version with ALiBi in the port, JAX's
  plain path) and of 6 greedy decode steps (K3's plain version with ALiBi)
  within 1e-4 of JAX's (``use_kernel=False``, as JAX's own tests run them);
* ``opt_batcher`` and ``family_batcher("bloom"/"mpt")`` against JAX's on the
  same requests, with chunked prefill, a registered prefix and
  ``decode_steps=4``: the tokens are equal;
* the daemon (``serve.build_server``) on an OPT, a BLOOM and an MPT
  checkpoint: it starts over the family's batcher and serves a request over
  a localhost socket with the tokens of a direct run; the LLaMA-only options
  exit."""

import json
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.models import bloom_engine as jbe
from dgq_tpu.models import mpt_engine as jme
from dgq_tpu.models import opt_engine as jopt
from dgq_tpu.models.bloom import tiny_bloom_config
from dgq_tpu.models.mpt import tiny_mpt_config
from dgq_tpu.models.opt import tiny_opt_config
from dgq_tpu.serving import family_batch_engine as jfam
from dgq_tpu.serving.opt_batch_engine import opt_batcher as jopt_batcher
from dgq_tpu.serving.scheduler import Request as JRequest
from dgq_tpu.utils import checkpoint as jck
from dgq_tpu_torch import serve as tserve
from dgq_tpu_torch.models import bloom_engine as tbe
from dgq_tpu_torch.models import mpt_engine as tme
from dgq_tpu_torch.models import opt_engine as topt
from dgq_tpu_torch.models.bloom import BloomConfig
from dgq_tpu_torch.models.mpt import MPTConfig
from dgq_tpu_torch.models.opt import OPTConfig
from dgq_tpu_torch.serving import family_batch_engine as tfam
from dgq_tpu_torch.serving.opt_batch_engine import opt_batcher
from dgq_tpu_torch.serving.scheduler import Request
from dgq_tpu_torch.utils import checkpoint as tck

GS = 64
MAX_LEN, PAD = 64, 8


def _port_cfg(cls, jcfg):
    return cls(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


FAMILIES = {
    "bloom": dict(cfg=tiny_bloom_config(hidden_size=128, num_attention_heads=4),
                  tcfg=BloomConfig, jparams=jbe.BloomEngineParams,
                  lins=("qkv_proj", "dense", "fc1", "fc2"), ffn=4,
                  scales=("dense_input_scale", "fc2_input_scale"), interleaved=True,
                  top=("emb_ln_weight", "emb_ln_bias", "ln_f_weight", "ln_f_bias")),
    "mpt": dict(cfg=tiny_mpt_config(d_model=128, n_heads=4), tcfg=MPTConfig,
                jparams=jme.MPTEngineParams,
                lins=("qkv_proj", "out_proj", "up_proj", "down_proj"), ffn=4, scales=("out_input_scale", "fc2_input_scale"), interleaved=False,
                top=("norm_f_weight", "norm_f_bias")),
    "opt": dict(cfg=tiny_opt_config(hidden_size=128, ffn_dim=256, num_attention_heads=4,
                                    max_position_embeddings=128),
                tcfg=OPTConfig, jparams=jopt.OPTEngineParams,
                lins=("qkv_proj", "out_proj", "fc1", "fc2"), ffn=None,
                scales=("out_input_scale", "fc2_input_scale"), interleaved=None,
                top=("final_ln_weight", "final_ln_bias")),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(arch, seed=0):
    """A numpy-seeded engine of ``arch`` under save_engine's keys: span-only
    linears (groupsize 64) with biases (none for MPT's no_bias), the fused
    q|k|v's alpha carrying each part's own output scale (BLOOM interleaved,
    MPT concatenated), every layer its own draw."""
    fam = FAMILIES[arch]
    cfg = fam["cfg"]
    rng = np.random.default_rng(seed)
    d, nl = cfg.hidden_size, cfg.num_hidden_layers
    h = cfg.n_heads if arch == "mpt" else cfg.num_attention_heads
    dh = d // h
    f = cfg.ffn_dim if fam["ffn"] is None else fam["ffn"] * d
    bias = arch != "mpt"
    qkv_scales = rng.uniform(0.04, 0.06, (nl, 3)).astype(np.float32)

    def lin(prefix, n_out, n_in, alpha, b_scale):
        out = {
            f"{prefix}/qweight": rng.integers(-128, 128, (nl, n_in // 2, n_out)).astype(np.int8),
            f"{prefix}/wscales": np.repeat(rng.integers(1, 4, (nl, n_in // GS, n_out)), 8,
                                           axis=1).astype(np.int8),
            f"{prefix}/wzeros": np.repeat(rng.integers(4, 12, (nl, n_in // GS, n_out)), 8,
                                          axis=1).astype(np.int8),
            f"{prefix}/alpha": (rng.uniform(alpha / 2, 2 * alpha, (nl, n_out))
                                ).astype(np.float32),
        }
        if bias:
            out[f"{prefix}/bias"] = (rng.normal(size=(nl, n_out)) * b_scale).astype(np.float32)
        return out

    def vec(lo, hi):
        return rng.uniform(lo, hi, (nl, d)).astype(np.float32)

    lins = fam["lins"]
    out = {
        "embed_tokens": rng.normal(size=(cfg.vocab_size, d)).astype(np.float32),
        "lm_head": (rng.normal(size=(cfg.vocab_size, d)) * 0.5).astype(np.float32),
        "layers/ln1_weight": vec(8, 12), "layers/ln1_bias": vec(-2, 2),
        "layers/ln2_weight": vec(8, 12), "layers/ln2_bias": vec(-2, 2),
    }
    for name in fam["top"]:
        out[name] = (np.ones if name.endswith("weight") else np.zeros)((d,), np.float32)
    if arch == "opt":
        out["embed_positions"] = rng.normal(size=(cfg.max_position_embeddings + 2, d)).astype(
            np.float32)
    out.update(lin(f"layers/{lins[0]}", 3 * d, d, 1e-2, 3.0))
    if fam["interleaved"] is not None:  # each part's own output scale, per channel
        per = (np.tile(np.repeat(qkv_scales, dh, axis=1), (1, h)) if fam["interleaved"]
               else np.repeat(qkv_scales, d, axis=1))
        out[f"layers/{lins[0]}/alpha"] = (5e-4 / per).astype(np.float32)
    out.update(lin(f"layers/{lins[1]}", d, d, 1e-4, 0.1))
    out.update(lin(f"layers/{lins[2]}", f, d, 1e-4, 0.1))
    out.update(lin(f"layers/{lins[3]}", d, f, 1e-4, 0.1))
    out["layers/q_scale"], out["layers/k_scale"], out["layers/v_scale"] = qkv_scales.T.copy()
    for name in fam["scales"]:
        out[f"layers/{name}"] = rng.uniform(0.04, 0.06, (nl,)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """arch -> (JAX's engine params, the port's, the arrays, checkpoint
    path): JAX's params written by JAX's save_engine and read by the port's
    load_engine."""
    out = {}
    for arch, fam in FAMILIES.items():
        arrays = _arrays(arch)
        j = jck._rebuild_namedtuple(fam["jparams"],
                                    {k: jnp.asarray(v) for k, v in arrays.items()})
        path = str(tmp_path_factory.mktemp(arch) / f"{arch}.safetensors")
        jck.save_engine(path, j, fam["cfg"], arch=arch)
        t, tcfg = tck.load_engine(path, device="cpu")
        assert tcfg == _port_cfg(fam["tcfg"], fam["cfg"])
        out[arch] = (j, t, arrays, path)
    return out


@pytest.mark.parametrize("arch", ["bloom", "mpt"])
def test_checkpoint_round_trips_with_jax(engines, arch, tmp_path):
    """JAX's file loads into bit-equal span-only tensors; the weight-carry
    function gives the same from the arrays; the port's file loads in JAX
    (``load_engine_any`` reads it back too)."""
    j, t, arrays, _ = engines[arch]
    got = tck.engine_arrays(t)
    assert set(got) == set(arrays)
    for key, a in arrays.items():
        assert torch.equal(got[key], torch.from_numpy(a)), key
    carry = {"bloom": tck.bloom_engine_params_from_arrays,
             "mpt": tck.mpt_engine_params_from_arrays}[arch](arrays, device="cpu")
    assert all(torch.equal(v, got[k]) for k, v in tck.engine_arrays(carry).items())
    assert t.layers.qkv_proj.qw_rp is None and t.layers.qkv_proj.s_hi is None
    path = str(tmp_path / "port.safetensors")
    cfg = FAMILIES[arch]["cfg"]
    tck.save_engine(path, t, _port_cfg(FAMILIES[arch]["tcfg"], cfg), arch=arch)
    j2, cfg2 = jck.load_engine(path)
    assert cfg2 == cfg
    for key, a in arrays.items():
        leaf = j2
        for part in key.split("/"):
            leaf = getattr(leaf, part)
        np.testing.assert_array_equal(np.asarray(leaf), a, err_msg=key)
    again, _ = tck.load_engine_any(path, device="cpu")
    assert type(again) is type(t)


ENGINE = {
    "bloom": (jbe.BloomEngineConfig, jbe.bloom_engine_forward, jbe.init_bloom_kv_cache,
              tbe.BloomEngineConfig, tbe.bloom_engine_forward, tbe.init_bloom_kv_cache),
    "mpt": (jme.MPTEngineConfig, jme.mpt_engine_forward, jme.init_mpt_kv_cache,
            tme.MPTEngineConfig, tme.mpt_engine_forward, tme.init_mpt_kv_cache),
}


@pytest.mark.parametrize("arch", ["bloom", "mpt"])
def test_engine_forward_matches_jax(engines, arch):
    """Prefill of 2 x 20 tokens in a cache of 128 (the port's K2 branch),
    then 6 greedy steps (K3's): logits within 1e-4, equal tokens, caches
    within one code."""
    jcfg_cls, jfwd, jinit, tcfg_cls, tfwd, tinit = ENGINE[arch]
    j, t, _, _ = engines[arch]
    cfg = FAMILIES[arch]["cfg"]
    tcfg = _port_cfg(FAMILIES[arch]["tcfg"], cfg)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jecfg, tecfg = jcfg_cls(cfg=cfg, use_kernel=False), tcfg_cls(cfg=tcfg)
    jl, jc = jfwd(jecfg, j, jnp.asarray(prompt), jinit(cfg, 2, 128))
    tl, tc = tfwd(tecfg, t, torch.from_numpy(prompt), tinit(tcfg, 2, 128, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for _ in range(6):
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tl[:, -1:], dim=-1).numpy(), tok)
        jl, jc = jfwd(jecfg, j, jnp.asarray(tok), jc)
        tl, tc = tfwd(tecfg, t, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert tc.length == int(jc.length) == 26
    for got, ref in ((tc.k, jc.k), (tc.v, jc.v)):
        diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
        assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999
    with pytest.raises(NotImplementedError, match="kv_bits=8"):
        tcfg_cls(cfg=tcfg, kv_bits=4)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        tcfg_cls(cfg=tcfg, tp_axis="tp")


def _jax_ecfg(arch, cfg):
    return {"opt": jopt.OPTEngineConfig, "bloom": jbe.BloomEngineConfig,
            "mpt": jme.MPTEngineConfig}[arch](cfg=cfg, use_kernel=False)


def _port_ecfg(arch, cfg):
    tcfg = _port_cfg(FAMILIES[arch]["tcfg"], cfg)
    return {"opt": topt.OPTEngineConfig, "bloom": tbe.BloomEngineConfig,
            "mpt": tme.MPTEngineConfig}[arch](cfg=tcfg)


def _run(b, req_cls, prompts, max_new, prefix):
    b.register_prefix(prefix)
    for i, p in enumerate(prompts):
        b.add_request(req_cls(uid=i, prompt_ids=p.copy(), max_new_tokens=max_new))
    return {r.uid: r.output_ids for r in b.run()}


@pytest.mark.parametrize("arch", ["opt", "bloom", "mpt"])
def test_family_batcher_matches_jax(engines, arch):
    """More requests than slots, prompts past the chunk, three under the
    registered prefix (one remainder past the chunk), windows of 4 greedy
    steps: the tokens of JAX's batcher."""
    j, t, _, _ = engines[arch]
    cfg = FAMILIES[arch]["cfg"]
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 10).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (6, 23, 9)]
    prompts += [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n).astype(np.int32)])
                for n in (3, 20, 7)]
    kw = dict(num_slots=3, max_len=MAX_LEN, prefill_pad=PAD, prefill_chunk=16, decode_steps=4)
    if arch == "opt":
        jb, tb = jopt_batcher(_jax_ecfg(arch, cfg), j, **kw), opt_batcher(
            _port_ecfg(arch, cfg), t, **kw)
    else:
        jb = jfam.family_batcher(arch, _jax_ecfg(arch, cfg), j, **kw)
        tb = tfam.family_batcher(arch, _port_ecfg(arch, cfg), t, **kw)
    want = _run(jb, JRequest, prompts, 9, prefix)
    got = _run(tb, Request, prompts, 9, prefix)
    assert got == want and tb.prefix_hits == jb.prefix_hits == 3
    assert len({tok for toks in got.values() for tok in toks}) > 4  # not degenerate
    with pytest.raises(ValueError, match="admit_batch=1, spec_k=0"):
        (opt_batcher(_port_ecfg(arch, cfg), t, admit_batch=2) if arch == "opt"
         else tfam.family_batcher(arch, _port_ecfg(arch, cfg), t, spec_k=2))


def test_family_batcher_dispatch(engines):
    """batcher_from_checkpoint takes the family from the manifest; falcon
    and mixtral get the ContinuousBatcher over their ``fns`` (their
    parity: tests/test_torch_falcon.py, test_torch_mixtral.py); an INT4
    cache is LLaMA's only."""
    from dgq_tpu_torch.models import falcon_engine as tfe, mixtral_engine as tmx, synthetic
    from dgq_tpu_torch.models.falcon import tiny_falcon_config
    from dgq_tpu_torch.models.mixtral import tiny_mixtral_config

    for arch in ("opt", "bloom", "mpt"):
        got, b = tfam.batcher_from_checkpoint(engines[arch][3], device="cpu", num_slots=2,
                                              max_len=MAX_LEN, prefill_pad=PAD)
        assert got == arch and b._f is not None and b.cache.k.shape[-1] == MAX_LEN
    j, t, _, _ = engines["bloom"]
    cfg = FAMILIES["bloom"]["cfg"]
    fcfg, mcfg = tiny_falcon_config(), tiny_mixtral_config(hidden_size=256,
                                                           intermediate_size=256)
    for arch, ecfg, params in (
            ("falcon", tfe.FalconEngineConfig(cfg=fcfg),
             synthetic.build_falcon_engine(fcfg, device="cpu")),
            ("mixtral", tmx.MixtralEngineConfig(cfg=mcfg),
             synthetic.build_mixtral_engine(mcfg, device="cpu"))):
        b = tfam.family_batcher(arch, ecfg, params, num_slots=2, max_len=MAX_LEN,
                                prefill_pad=PAD)
        assert type(b).__name__ == "ContinuousBatcher" and b._f is not None
        with pytest.raises(ValueError, match="admit_batch=1, spec_k=0"):
            tfam.family_batcher(arch, ecfg, params, admit_batch=2)
    with pytest.raises(ValueError, match="INT4 KV is implemented for the LLaMA engine only"):
        tfam.bloom_serving_fns().init_batched_cache(_port_ecfg("bloom", cfg).cfg, 1, 8,
                                                    kv_bits=4, device="cpu")


FLAGS = ["--cpu", "--port", "0", "--max-len", str(MAX_LEN), "--prefill-pad", str(PAD),
         "--slots", "2", "--metrics-interval", "0"]


@pytest.mark.parametrize("arch", ["opt", "bloom", "mpt"])
def test_serve_family_checkpoint(engines, arch):
    """The daemon on a non-LLaMA checkpoint starts over the family's batcher
    (admit-batch 1) and serves a request over a localhost socket with the
    tokens of a direct run of the same batcher."""
    path = engines[arch][3]
    cfg = FAMILIES[arch]["cfg"]
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 13).astype(np.int32)
    args = tserve.build_parser().parse_args([path, *FLAGS, "--admit-batch", "1"])
    assert tserve._unported(args) == ""
    with tserve.build_server(args) as srv:
        assert type(srv.batcher).__name__ == "ContinuousBatcher" and srv.batcher._f is not None
        with socket.create_connection((srv.host, srv.port), timeout=120) as s:
            s.sendall((json.dumps({"prompt_ids": prompt.tolist(), "max_new_tokens": 5})
                       + "\n").encode())
            served = json.loads(s.makefile("r").readline())["output_ids"]
    _, b = tfam.batcher_from_checkpoint(path, device="cpu", num_slots=2, max_len=MAX_LEN,
                                        prefill_pad=PAD)
    b.add_request(Request(uid=0, prompt_ids=prompt, max_new_tokens=5))
    assert served == b.run()[0].output_ids


@pytest.mark.parametrize("extra", [["--paged"], ["--spec-k", "2"], [], ["--tp", "2"],
                                   ["--kv-bits", "4", "--admit-batch", "1"]])
def test_serve_family_llama_only_options_exit(engines, extra):
    """--paged, --spec-k, --admit-batch > 1 (the CLI's default is 4), --tp
    and --kv-bits 4 are LLaMA's: the daemon exits on a non-LLaMA
    checkpoint, naming them."""
    args = tserve.build_parser().parse_args([engines["mpt"][3], *FLAGS, *extra])
    with pytest.raises(SystemExit, match="LLaMA-only; checkpoint is mpt"):
        tserve.build_server(args)
