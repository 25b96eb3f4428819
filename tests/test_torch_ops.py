"""dgq_tpu_torch kernels' plain versions held against dgq_tpu on the CPU.

On CPU tensors each wrapper (K1 w4a8_matmul_rp_pipe, K2
int8_prefill_attention, K3 int8_decode_attention) runs its plain PyTorch
version; these tests hold that against the JAX plain versions and the Pallas
kernels in interpret mode on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgq_tpu.ops import attention as jat
from dgq_tpu.ops import quant_matmul as jqm
from dgq_tpu_torch.ops import attention as tat
from dgq_tpu_torch.ops import quant_matmul as tqm


def _t(a):
    return torch.from_numpy(np.array(a))


def _gemm_inputs(m, k, n, gs, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    qw = rng.integers(-128, 128, size=(k // 2, n)).astype(np.int8)
    ws = rng.integers(1, 4, size=(k // gs, n)).astype(np.int8)
    wz = rng.integers(4, 12, size=(k // gs, n)).astype(np.int8)
    alpha = rng.uniform(1e-5, 1e-3, size=(n,)).astype(np.float32)
    beta = rng.normal(size=(n,)).astype(np.float32)
    return x, qw, ws, wz, alpha, beta


@pytest.mark.parametrize("m,k,n", [(4, 512, 256), (40, 1024, 384)])
def test_k1_plain_matches_jax(m, k, n):
    gs = 128
    x, qw, ws, wz, alpha, beta = _gemm_inputs(m, k, n, gs, seed=m)
    one = np.ones((n,), np.float32)
    rep = (np.repeat(ws, 8, axis=0), np.repeat(wz, 8, axis=0))
    # alpha = 1, beta = 0: the f32 output is the int32 accumulator, exactly
    acc_j = np.asarray(jqm.w4a8_matmul_rp_xla(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws),
                                              jnp.asarray(wz), jnp.asarray(one), groupsize=gs))
    acc_pipe = np.asarray(jqm.w4a8_matmul_rp_pipe(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(rep[0]), jnp.asarray(rep[1]),
        jnp.asarray(one), jnp.zeros((n,), jnp.float32), groupsize=gs, bm=128, bn=128, bk=256,
        interpret=True, scales_replicated=True))
    acc_t = tqm.w4a8_matmul_rp_pipe(_t(x), _t(qw), _t(rep[0]), _t(rep[1]), _t(one),
                                    torch.zeros(n), groupsize=gs,
                                    scales_replicated=True).numpy()
    np.testing.assert_array_equal(acc_t, acc_j)
    np.testing.assert_array_equal(acc_t, acc_pipe)
    y_j = np.asarray(jqm.w4a8_matmul_rp_xla(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws),
                                            jnp.asarray(wz), jnp.asarray(alpha),
                                            jnp.asarray(beta), groupsize=gs))
    y_t = tqm.w4a8_matmul_rp_pipe(_t(x), _t(qw), _t(ws), _t(wz), _t(alpha), _t(beta),
                                  groupsize=gs).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-6, atol=1e-6)


def _attn_inputs(b, h, hk, s, dh, smax, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(b, h, s, dh)).astype(np.int8)
    kt = rng.integers(-127, 128, size=(b, hk, dh, smax)).astype(np.int8)
    v = rng.integers(-127, 128, size=(b, hk, smax, dh)).astype(np.int8)
    scales = tuple(np.float32(x) for x in rng.uniform(0.01, 0.03, size=3))
    return q, kt, v, scales


def test_k2_plain_matches_jax_kernel_with_offset():
    q, kt, v, (qs, ks, vs) = _attn_inputs(2, 4, 2, 128, 64, 384, seed=1)
    plen, off = 200, 72
    ref = np.asarray(jat.int8_prefill_attention(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), jnp.int32(plen), jnp.float32(qs),
        jnp.float32(ks), jnp.float32(vs), jnp.int32(off), bq=128, bkv=128, interpret=True))
    got = tat.int8_prefill_attention(_t(q), _t(kt), _t(v), plen, torch.tensor(qs),
                                     torch.tensor(ks), torch.tensor(vs), off).numpy()
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)
    # without an offset the plain version is JAX's plain version
    ref0 = np.asarray(jat.int8_prefill_attention_xla(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), jnp.int32(plen), jnp.float32(qs),
        jnp.float32(ks), jnp.float32(vs)))
    got0 = tat.int8_prefill_attention(_t(q), _t(kt), _t(v), plen, torch.tensor(qs),
                                      torch.tensor(ks), torch.tensor(vs)).numpy()
    np.testing.assert_allclose(got0, ref0, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("quant_pv", [False, True])
def test_k3_plain_matches_jax_kernel(quant_pv):
    q, kt, v, (qs, ks, vs) = _attn_inputs(3, 4, 2, 1, 64, 256, seed=2 + quant_pv)
    q = q[:, :, 0]
    lengths = np.array([1, 97, 256], np.int32)
    args_j = (jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), jnp.asarray(lengths),
              jnp.float32(qs), jnp.float32(ks), jnp.float32(vs))
    ref = np.asarray(jat.int8_decode_attention(*args_j, interpret=True, quant_pv=quant_pv))
    ref_xla = np.asarray(jat.int8_decode_attention_xla(*args_j, quant_pv=quant_pv))
    got = tat.int8_decode_attention(_t(q), _t(kt), _t(v), _t(lengths), torch.tensor(qs),
                                    torch.tensor(ks), torch.tensor(vs),
                                    quant_pv=quant_pv).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, ref_xla, rtol=2e-4, atol=2e-4)


def test_kernel_scalars_take_jax_bits():
    """The scalars a kernel takes are float32 and computed in JAX's order."""
    qs, ks, vs = np.float32(0.0173), np.float32(0.0291), np.float32(0.047)
    qk_j = np.asarray((jnp.float32(qs) * jnp.float32(ks)) / np.sqrt(128.0).item())
    qk_t = tat.qk_scale(torch.tensor(qs), torch.tensor(ks), 128).numpy()
    assert qk_t.dtype == np.float32 and qk_t.tobytes() == qk_j.astype(np.float32).tobytes()
    v127_j = np.asarray(jnp.float32(vs) / 127.0)
    v127_t = tat._kernel_scales(torch.tensor(qs), torch.tensor(ks), torch.tensor(vs), 128,
                                True)[2].numpy()
    assert v127_t.tobytes() == v127_j.astype(np.float32).tobytes()
