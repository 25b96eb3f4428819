"""INT8-KV attention: K2 (flash prefill) and K3 (decode) with plain versions.

Port of ``dgq_tpu/ops/attention.py``: ``_quantize_exp`` (:35-65),
``auto_decode_chunk`` (:473-488), the plain ``int8_prefill_attention_xla``
(:315-334) and ``int8_decode_attention_xla`` (:337-374), and the wrappers of
the hand-written CUDA kernels ``csrc/int8_prefill_attention.cu`` and
``csrc/int8_decode_attention.cu`` under the JAX names
``int8_prefill_attention`` and ``int8_decode_attention``.

Cache layout as in JAX: K transposed (B, Hkv, Dh, Smax), V (B, Hkv, Smax, Dh),
both int8.  GQA folds query head h onto kv head h // (H // Hkv).

Every scalar handed to a kernel is a float32 tensor computed in JAX's order,
e.g. ``(q_scale * k_scale) / sqrt(Dh)`` with the divisor a float32 tensor: a
Python float divisor would take other bits (CUDA turns division by a host
scalar into multiplication by its reciprocal).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops.quant_matmul import int_matmul

PREFILL = "int8_prefill_attention"
DECODE = "int8_decode_attention"
_SIGNATURES = {
    PREFILL: {PREFILL: [_cuda.VP] * 5 + [_cuda.INT] * 8 + [_cuda.VP]},
    DECODE: {DECODE: [_cuda.VP] * 7 + [_cuda.INT] * 6 + [_cuda.VP]},
}

NEG = torch.finfo(torch.float32).min


def f32(value: float, device) -> torch.Tensor:
    """A float32 scalar tensor on ``device``."""
    return torch.full((), value, dtype=torch.float32, device=device)


def qk_scale(q_scale: torch.Tensor, k_scale: torch.Tensor, head_dim: int,
             apply_sqrt_dh: bool = True) -> torch.Tensor:
    """(q_scale * k_scale) / sqrt(Dh) as a float32 scalar tensor."""
    qk = (q_scale * k_scale).to(torch.float32)
    return qk / f32(math.sqrt(head_dim), qk.device) if apply_sqrt_dh else qk


def _quantize_exp(e: torch.Tensor) -> torch.Tensor:
    """INT8 codes trunc(127 * e + 0.5) of exp-weights e = exp(s - m) in [0, 1].

    The row max of e is exactly 1, so the constant scale 1/127 gives the
    codes a per-row scale would; the caller folds 1/denom into its epilogue.
    Two separate float32 ops (multiply, then add) and a truncating cast, as
    the JAX rule is written: an fma would move codes across the .5 boundary."""
    return (e * 127.0 + 0.5).to(torch.int8)


def auto_decode_chunk(smax: int) -> int:
    """0 (whole-cache decode kernel) up to 8k context, else the largest chunk
    in {4096..128} dividing ``smax`` (the chunked kernel, not yet ported)."""
    if smax <= 8192:
        return 0
    for c in (4096, 2048, 1024, 512, 256, 128):
        if smax % c == 0:
            return c
    return 0


def _no_alibi(alibi_slopes) -> None:
    if alibi_slopes is not None:
        raise NotImplementedError("ALiBi attention is not ported yet (BLOOM/MPT slice)")


def int8_prefill_attention_xla(q_s8, kt_cache, v_cache, prompt_len, q_scale, k_scale, v_scale,
                               q_offset=None, apply_sqrt_dh: bool = True) -> torch.Tensor:
    """Plain causal attention over the INT8 cache -> (B, H, S, Dh) f32;
    materialises the (S, Smax) scores.  Query row i sits at absolute
    position ``q_offset + i``."""
    b, h, s, dh = q_s8.shape
    _, hk, _, smax = kt_cache.shape
    rep = h // hk
    dev = q_s8.device
    qk = qk_scale(q_scale, k_scale, dh, apply_sqrt_dh)
    s32 = int_matmul(q_s8.reshape(b, hk, rep * s, dh), kt_cache)
    scores = s32.to(torch.float32).reshape(b, hk, rep, s, smax) * qk
    off = 0 if q_offset is None else int(q_offset)
    qpos = (off + torch.arange(s, device=dev))[:, None]
    kpos = torch.arange(smax, device=dev)[None, :]
    valid = (kpos <= qpos) & (kpos < int(prompt_len))
    scores = torch.where(valid, scores, f32(NEG, dev))
    p = torch.softmax(scores, dim=-1)
    vf = v_cache.to(torch.float32) * v_scale
    out = torch.matmul(p, vf[:, :, None])
    return out.reshape(b, h, s, dh)


def _lengths(length, b: int, device) -> torch.Tensor:
    if isinstance(length, torch.Tensor):
        return length.to(device=device, dtype=torch.int32).expand(b).contiguous()
    return torch.full((b,), int(length), dtype=torch.int32, device=device)


def int8_decode_attention_xla(q_s8, kt_cache, v_cache, length, q_scale, k_scale, v_scale,
                              apply_sqrt_dh: bool = True, quant_pv: bool = False,
                              alibi_slopes=None) -> torch.Tensor:
    """Plain single-token attention over the INT8 cache -> (B, H, Dh) f32;
    ``quant_pv`` quantises the exp-weights to int8 codes for an exact
    integer p @ V with 1/denom in the epilogue."""
    _no_alibi(alibi_slopes)
    b, h, dh = q_s8.shape
    _, hk, _, smax = kt_cache.shape
    rep = h // hk
    dev = q_s8.device
    lengths = _lengths(length, b, dev)
    qk = qk_scale(q_scale, k_scale, dh, apply_sqrt_dh)
    s32 = int_matmul(q_s8.reshape(b, hk, rep, dh), kt_cache)
    s = s32.to(torch.float32) * qk
    pos = torch.arange(smax, device=dev)[None, None, None, :]
    s = torch.where(pos < lengths[:, None, None, None], s, f32(NEG, dev))
    if quant_pv:
        m = torch.amax(s, dim=-1, keepdim=True)
        e = torch.exp(s - m)
        denom = torch.sum(e, dim=-1, keepdim=True)
        acc = int_matmul(_quantize_exp(e), v_cache)
        out = acc.to(torch.float32) * ((v_scale / f32(127.0, dev)) / denom)
    else:
        p = torch.softmax(s, dim=-1)
        out = torch.matmul(p, v_cache.to(torch.float32) * v_scale)
    return out.reshape(b, h, dh)


def _kernel_scales(q_scale, k_scale, v_scale, dh: int, apply_sqrt_dh: bool) -> torch.Tensor:
    vs = v_scale.to(torch.float32)
    return torch.stack([qk_scale(q_scale, k_scale, dh, apply_sqrt_dh), vs,
                        vs / f32(127.0, vs.device)]).contiguous()


def _check_cache(kt_cache, v_cache, b: int, dh: int, dev):
    _, hk, _, smax = kt_cache.shape
    _cuda.require(kt_cache, "kt_cache", torch.int8, (b, hk, dh, smax), dev)
    _cuda.require(v_cache, "v_cache", torch.int8, (b, hk, smax, dh), dev)
    return hk, smax


def int8_prefill_attention(q_s8: torch.Tensor, kt_cache: torch.Tensor, v_cache: torch.Tensor,
                           prompt_len: Union[int, torch.Tensor], q_scale, k_scale, v_scale,
                           q_offset: Optional[Union[int, torch.Tensor]] = None, *,
                           apply_sqrt_dh: bool = True, alibi_slopes=None) -> torch.Tensor:
    """K2: causal flash attention over the INT8 cache -> (B, H, S, Dh) f32.

    q (B, H, S, Dh) int8 with S a multiple of 64 on CUDA; ``prompt_len`` is
    the total valid length, ``q_offset`` the absolute position of query row
    0.  CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _no_alibi(alibi_slopes)
    if q_s8.device.type == "cpu":
        return int8_prefill_attention_xla(q_s8, kt_cache, v_cache, prompt_len, q_scale,
                                          k_scale, v_scale, q_offset, apply_sqrt_dh)
    b, h, s, dh = q_s8.shape
    dev = q_s8.device
    _cuda.require(q_s8, "q_s8", torch.int8, (b, h, s, dh), dev)
    hk, smax = _check_cache(kt_cache, v_cache, b, dh, dev)
    plen, off = int(prompt_len), 0 if q_offset is None else int(q_offset)
    if h % hk or s % 64 or smax % 64 or dh not in (64, 128) or not 1 <= plen <= smax or off < 0:
        raise ValueError(f"K2 needs H % Hkv == 0, S % 64 == 0, Smax % 64 == 0, Dh in (64, 128), "
                         f"1 <= prompt_len <= Smax, q_offset >= 0; got H={h}, Hkv={hk}, S={s}, "
                         f"Smax={smax}, Dh={dh}, prompt_len={plen}, q_offset={off}")
    scales = _kernel_scales(q_scale, k_scale, v_scale, dh, apply_sqrt_dh)
    out = torch.empty((b, h, s, dh), dtype=torch.float32, device=dev)
    lib = _cuda.library(_cuda.SOURCES[PREFILL], _SIGNATURES[PREFILL])
    rc = lib.int8_prefill_attention(
        _cuda.ptr(q_s8), _cuda.ptr(kt_cache), _cuda.ptr(v_cache), _cuda.ptr(scales),
        _cuda.ptr(out), b, h, hk, s, dh, smax, plen, off, _cuda.stream(dev))
    _cuda.check(rc, PREFILL)
    _cuda.count_launch(PREFILL)
    return out


def int8_decode_attention(q_s8: torch.Tensor, kt_cache: torch.Tensor, v_cache: torch.Tensor,
                          length: Union[int, torch.Tensor], q_scale, k_scale, v_scale, *,
                          apply_sqrt_dh: bool = True, quant_pv: bool = False,
                          alibi_slopes=None) -> torch.Tensor:
    """K3: single-token attention over the INT8 cache -> (B, H, Dh) f32.

    ``length`` (int, () or (B,)) counts the valid cache positions per slot,
    the current token included; each must be at least 1.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    _no_alibi(alibi_slopes)
    if q_s8.device.type == "cpu":
        return int8_decode_attention_xla(q_s8, kt_cache, v_cache, length, q_scale, k_scale,
                                         v_scale, apply_sqrt_dh, quant_pv)
    b, h, dh = q_s8.shape
    dev = q_s8.device
    _cuda.require(q_s8, "q_s8", torch.int8, (b, h, dh), dev, align=4)
    hk, smax = _check_cache(kt_cache, v_cache, b, dh, dev)
    if h % hk or (h // hk) not in (1, 2, 4, 8) or smax % 4 or dh not in (64, 128):
        raise ValueError(f"K3 needs H / Hkv in (1, 2, 4, 8), Smax % 4 == 0, Dh in (64, 128); "
                         f"got H={h}, Hkv={hk}, Smax={smax}, Dh={dh}")
    lengths = _lengths(length, b, dev)
    scales = _kernel_scales(q_scale, k_scale, v_scale, dh, apply_sqrt_dh)
    sbuf = torch.empty((b, h, smax), dtype=torch.float32, device=dev)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    lib = _cuda.library(_cuda.SOURCES[DECODE], _SIGNATURES[DECODE])
    rc = lib.int8_decode_attention(
        _cuda.ptr(q_s8), _cuda.ptr(kt_cache), _cuda.ptr(v_cache), _cuda.ptr(lengths),
        _cuda.ptr(scales), _cuda.ptr(sbuf), _cuda.ptr(out), b, h, hk, dh, smax, int(quant_pv),
        _cuda.stream(dev))
    _cuda.check(rc, DECODE)
    _cuda.count_launch(DECODE)
    return out
