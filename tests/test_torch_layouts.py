"""dgq_tpu_torch layouts and checkpoints held bit-equal against dgq_tpu.

Span nibble packing, the rowpair repack and its unpack, the cs_fold rows,
and engine checkpoints written by one package and read by the other."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.models.llama import tiny_llama_config
from dgq_tpu.models.synthetic import build_llama_engine
from dgq_tpu.ops import fused_decode as jfd
from dgq_tpu.ops import quant_matmul as jqm
from dgq_tpu.quant import packing as jpk
from dgq_tpu.utils import checkpoint as jck
from dgq_tpu_torch.ops import fused_decode as tfd
from dgq_tpu_torch.ops import quant_matmul as tqm
from dgq_tpu_torch.quant import packing as tpk
from dgq_tpu_torch.utils import checkpoint as tck

CFG = tiny_llama_config(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("span", [0, 64, 256])
def test_pack_unpack_nibbles_match_jax(span):
    rng = np.random.default_rng(span)
    codes = rng.integers(0, 16, size=(512, 48)).astype(np.int8)
    packed_j = np.asarray(jpk.pack_nibbles(jnp.asarray(codes), span))
    packed_t = tpk.pack_nibbles(torch.from_numpy(codes), span).numpy()
    np.testing.assert_array_equal(packed_t, packed_j)
    np.testing.assert_array_equal(tpk.unpack_nibbles(_t(packed_j), span).numpy(),
                                  np.asarray(jpk.unpack_nibbles(jnp.asarray(packed_j), span)))
    np.testing.assert_array_equal(tpk.unpack_nibbles(torch.from_numpy(packed_t), span).numpy(),
                                  codes)


@pytest.mark.parametrize("stacked", [False, True])
def test_rowpair_repack_and_cs_fold_match_jax(stacked):
    rng = np.random.default_rng(7)
    gs, k, n = 128, 512, 64
    lead = (3,) if stacked else ()
    qw = rng.integers(-128, 128, size=lead + (k // 2, n)).astype(np.int8)
    s_hi = rng.integers(1, 4, size=lead + (k // gs // 2, n)).astype(np.int8)
    s_lo = rng.integers(1, 4, size=lead + (k // gs // 2, n)).astype(np.int8)

    rp_j = np.asarray(jfd.pack_rowpair_s4(jnp.asarray(qw), 2 * gs))
    rp_t = tfd.pack_rowpair_s4(_t(qw), 2 * gs).numpy()
    np.testing.assert_array_equal(rp_t, rp_j)

    csf_j = np.asarray(jfd.rowpair_cs_fold(jnp.asarray(qw), 2 * gs, jnp.asarray(s_hi),
                                           jnp.asarray(s_lo)))
    csf_t = tfd.rowpair_cs_fold(_t(qw), 2 * gs, _t(s_hi), _t(s_lo)).numpy()
    assert csf_t.dtype == csf_j.dtype == np.int32
    np.testing.assert_array_equal(csf_t, csf_j)
    csf_rp_j = np.asarray(jfd.rowpair_cs_fold_rp(jnp.asarray(rp_j), gs, jnp.asarray(s_hi),
                                                 jnp.asarray(s_lo)))
    np.testing.assert_array_equal(csf_rp_j, csf_j)
    csf_rp_t = tfd.rowpair_cs_fold_rp(_t(rp_j), gs, _t(s_hi), _t(s_lo)).numpy()
    assert csf_rp_t.dtype == np.int32
    np.testing.assert_array_equal(csf_rp_t, csf_rp_j)

    one = rp_j.reshape((-1,) + rp_j.shape[-2:])[0]
    np.testing.assert_array_equal(tqm.unpack_rowpair_s4(_t(one)).numpy(),
                                  np.asarray(jqm.unpack_rowpair_s4(jnp.asarray(one))))


def _jax_arrays(eng):
    leaves, _ = jax.tree_util.tree_flatten_with_path(eng)
    out = {}
    for path, leaf in leaves:
        key = "/".join(str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k))))
                       for k in path)
        out[key] = np.asarray(leaf)
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def jax_engine():
    return build_llama_engine(CFG, seed=0)


def test_jax_checkpoint_loads_bit_equal(tmp_path, jax_engine):
    path = str(tmp_path / "eng.safetensors")
    jck.save_engine(path, jax_engine, CFG)
    eng, cfg = tck.load_engine(path, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(CFG)
    assert eng.rms_eps == jax_engine.rms_eps
    ref = _jax_arrays(jax_engine)
    got = tck.engine_arrays(eng)
    assert set(got) == set(ref)
    assert eng.embed_tokens.dtype == torch.bfloat16
    for key, arr in ref.items():
        t = got[key]
        assert tuple(t.shape) == arr.shape, key
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          _bits(arr), err_msg=key)
        else:
            np.testing.assert_array_equal(t.numpy(), arr, err_msg=key)


def test_port_checkpoint_loads_in_jax_bit_equal(tmp_path, jax_engine):
    ref = _jax_arrays(jax_engine)
    eng = tck.engine_params_from_arrays(ref, jax_engine.rms_eps, device="cpu")
    path = str(tmp_path / "port.safetensors")
    tck.save_engine(path, eng, tck.LlamaConfig(**dataclasses.asdict(CFG)))
    jeng, jcfg = jck.load_engine(path)
    assert jcfg == CFG
    assert jeng.rms_eps == jax_engine.rms_eps
    back = _jax_arrays(jeng)
    assert set(back) == set(ref)
    for key, arr in ref.items():
        assert back[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(_bits(back[key]), _bits(arr), err_msg=key)


def test_synthetic_engine_matches_jax_layout(jax_engine):
    """The port's random engine has JAX's keys, shapes and dtypes, the same
    value ranges, and round-trips through the port's checkpoint."""
    from dgq_tpu_torch.models.synthetic import build_llama_engine as tbuild

    ref = _jax_arrays(jax_engine)
    eng = tbuild(tck.LlamaConfig(**dataclasses.asdict(CFG)), seed=0, device="cpu")
    got = tck.engine_arrays(eng)
    assert set(got) == set(ref)
    for key, arr in ref.items():
        t = got[key]
        assert tuple(t.shape) == arr.shape, key
        assert str(t.dtype).removeprefix("torch.") == arr.dtype.name, key
    ws = got["layers/qkv_proj/wscales"].int()
    wz = got["layers/qkv_proj/wzeros"].int()
    assert ws.min() >= 1 and ws.max() <= 3 and wz.min() >= 4 and wz.max() <= 11
    np.testing.assert_array_equal(
        got["layers/gate_up_proj/cs_fold"].numpy(),
        np.asarray(jfd.rowpair_cs_fold_rp(jnp.asarray(got["layers/gate_up_proj/qw_rp"].numpy()),
                                          128, jnp.asarray(got["layers/gate_up_proj/s_hi"].numpy()),
                                          jnp.asarray(got["layers/gate_up_proj/s_lo"].numpy()))))
