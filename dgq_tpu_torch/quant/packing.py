"""INT4 nibble packing (span and pair layouts) and the packed linear.

Port of ``dgq_tpu/quant/packing.py``.  Weights are stored input-major as
``(K//2, N)`` int8 bytes.  With ``span == 2*groupsize`` each byte row r of a
span packs logical row r (high nibble) and row r + span/2 (low nibble), so
each nibble plane is one quantization group; ``span == 0`` packs adjacent
rows (2*k2 high, 2*k2+1 low).

``PackedLinear`` holds a quantized linear: nibble codes, per-(group, out
channel) scales and zeros (int8 under the dual-grained ``w4w8`` packing,
whose effective fp scale is ``wscales * wscales8``; fp32 otherwise), the
per-channel ``wscales8``, an fp bias and the static activation absmax.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def pack_nibbles(codes_kn: torch.Tensor, span: int = 0) -> torch.Tensor:
    """Pack (K, N) integer codes in [0, 15] into (K//2, N) int8 bytes."""
    k, n = codes_kn.shape
    if k % 2:
        raise ValueError(f"K={k} must be even to nibble-pack")
    c = codes_kn.to(torch.int32)
    if span:
        if k % span:
            raise ValueError(f"K={k} must be a multiple of span={span}")
        half = span // 2
        cs = c.reshape(k // span, span, n)
        hi = cs[:, :half, :].reshape(k // 2, n)
        lo = cs[:, half:, :].reshape(k // 2, n)
    else:
        hi = c[0::2, :]
        lo = c[1::2, :]
    byte = (hi << 4) | (lo & 0xF)
    return byte.to(torch.uint8).view(torch.int8)


def unpack_nibbles(packed: torch.Tensor, span: int = 0) -> torch.Tensor:
    """Unpack (K//2, N) int8 bytes into (K, N) int8 codes in [0, 15]."""
    k2, n = packed.shape
    ub = packed.view(torch.uint8).to(torch.int32)
    hi = ub >> 4
    lo = ub & 0xF
    if span:
        half = span // 2
        out = torch.cat([hi.reshape(k2 // half, half, n),
                         lo.reshape(k2 // half, half, n)], dim=1).reshape(2 * k2, n)
    else:
        out = torch.stack([hi, lo], dim=1).reshape(2 * k2, n)
    return out.to(torch.int8)


def tensor_from_array(a, device=None) -> Tensor:
    """A tensor from a numpy-convertible array (a copy; JAX's bfloat16
    arrays reinterpreted bit for bit), on ``device`` when given."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    return t if device is None else t.to(device)


@dataclasses.dataclass
class PackedLinear:
    """Quantized-linear state (K = in_features, N = out_features, G = K //
    groupsize):

      qweight:  (K//2, N) int8 nibble codes (wbits <= 4), or (K, N) uint8 /
                int32 unpacked codes (wbits 8 / 16)
      wscales:  (G, N) int8 (w4w8) or f32 group scales
      wzeros:   (G, N) int8 (w4w8) or f32 group zeros
      wscales8: (N,) f32 per-output-channel scale (w4w8 only), else None
      bias:     (N,) f32 or None
      amax:     () f32 static activation absmax (act scale amax / 127) or None
    """

    qweight: Tensor
    wscales: Tensor
    wzeros: Tensor
    wscales8: Optional[Tensor]
    bias: Optional[Tensor]
    amax: Optional[Tensor]
    in_features: int
    out_features: int
    groupsize: int
    w4w8: bool
    act_method: Optional[str] = "static"
    abits: int = 8
    span: int = 0  # nibble layout: 0 = adjacent pair, else 2 * groupsize
    wbits: int = 4  # weight bits; >= 8 stores codes unpacked


PACKED_ARRAYS = ("qweight", "wscales", "wzeros", "wscales8", "bias", "amax")
PACKED_META = ("in_features", "out_features", "groupsize", "w4w8", "act_method", "abits",
               "span", "wbits")


def packed_linear_from_arrays(pl, device="cuda") -> PackedLinear:
    """The port's PackedLinear from another's arrays and static fields: any
    object with PackedLinear's attribute names (JAX's PackedLinear, say), or
    a mapping of them; arrays are numpy-convertible, absent ones None."""
    get = pl.get if isinstance(pl, Mapping) else (lambda k, d=None: getattr(pl, k, d))
    arrays = {k: None if get(k) is None else tensor_from_array(get(k), device)
              for k in PACKED_ARRAYS}
    return PackedLinear(**arrays, **{k: get(k) for k in PACKED_META if get(k) is not None})


def _group_scales_to_k(scales_gn: Tensor, groupsize: int) -> Tensor:
    """Broadcast (G, N) group params to (K, N)."""
    return torch.repeat_interleave(scales_gn, groupsize, dim=0)


def bf16_round(x: Tensor) -> Tensor:
    """fp32 values rounded to bf16 (nearest even) and back: the precision
    scales are stored at."""
    return x.to(torch.bfloat16).to(torch.float32)


def _f32_or_none(x) -> Optional[Tensor]:
    return None if x is None else torch.as_tensor(x).to(torch.float32)


def pack_linear(weight_nk: Tensor, scale_flat: Tensor, zero_flat: Tensor, groupsize: int, *,
                bias: Optional[Tensor] = None, amax=None, act_method: Optional[str] = "static",
                bits: int = 4) -> PackedLinear:
    """Plain (not dual-grained) packing.  ``scale_flat``/``zero_flat`` are
    per-(out row, group) params flattened to (N*G,) in ``view(-1,
    groupsize)`` order; they are stored bf16-rounded.  ``bits <= 4``
    nibble-packs; ``bits >= 8`` stores the codes unpacked (uint8 for 8-bit,
    int32 for 16-bit)."""
    if bits not in (2, 3, 4, 8, 16):
        raise ValueError(f"pack_linear: unsupported wbits={bits}")
    n, k = weight_nk.shape
    g = k // groupsize
    scales = bf16_round(scale_flat.reshape(n, g))
    zeros = bf16_round(zero_flat.reshape(n, g))
    wg = weight_nk.to(torch.float32).reshape(n, g, groupsize)
    codes = torch.round(wg / scales[:, :, None] + zeros[:, :, None])
    codes = torch.clamp(codes, 0, (1 << bits) - 1)
    codes_kn = codes.reshape(n, k).t()
    if bits >= 8:
        qweight = codes_kn.to(torch.uint8 if bits == 8 else torch.int32).contiguous()
        span = 0
    else:
        span = 2 * groupsize if k % (2 * groupsize) == 0 else 0
        qweight = pack_nibbles(codes_kn, span)
    return PackedLinear(
        qweight=qweight, wscales=scales.t().contiguous(), wzeros=zeros.t().contiguous(),
        wscales8=None, bias=_f32_or_none(bias), amax=_f32_or_none(amax), in_features=k,
        out_features=n, groupsize=groupsize, w4w8=False, act_method=act_method, span=span,
        wbits=bits)


def pack_linear_w4w8(weight_nk: Tensor, scale_flat: Tensor, zero_flat: Tensor,
                     scale8_n: Tensor, groupsize: int, *, bias: Optional[Tensor] = None,
                     amax=None, act_method: Optional[str] = "static") -> PackedLinear:
    """Dual-grained packing.  ``scale_flat`` holds integer-valued group
    scales (>= 1), ``zero_flat`` integer-valued zeros, ``scale8_n`` the
    per-channel fp scale (stored bf16-rounded); codes are taken against the
    effective scale wscales * bf16(wscales8) and clamped so that |code -
    zero| * wscale fits int8."""
    n, k = weight_nk.shape
    g = k // groupsize
    iscales = scale_flat.reshape(n, g)
    izeros = zero_flat.reshape(n, g)
    scale8 = bf16_round(scale8_n.reshape(n))
    qscales = iscales * scale8[:, None]
    wg = weight_nk.to(torch.float32).reshape(n, g, groupsize)
    codes = torch.round(wg / qscales[:, :, None] + izeros[:, :, None])
    int_max = torch.floor(127.0 / torch.clamp(iscales, min=1.0))
    upper = torch.clamp(izeros + int_max, max=15.0)[:, :, None]
    lower = torch.clamp(izeros - int_max, min=0.0)[:, :, None]
    codes = torch.clamp(torch.minimum(torch.maximum(codes, lower), upper), 0, 15)
    codes_kn = codes.reshape(n, k).t()
    span = 2 * groupsize if k % (2 * groupsize) == 0 else 0
    return PackedLinear(
        qweight=pack_nibbles(codes_kn, span), wscales=iscales.t().to(torch.int8).contiguous(),
        wzeros=izeros.t().to(torch.int8).contiguous(), wscales8=scale8,
        bias=_f32_or_none(bias), amax=_f32_or_none(amax), in_features=k, out_features=n,
        groupsize=groupsize, w4w8=True, act_method=act_method, span=span)


def dequantize_linear(pl: PackedLinear) -> Tensor:
    """The fp32 weight in (K, N) layout."""
    if pl.wbits >= 8:
        codes = pl.qweight.to(torch.float32)
    else:
        codes = unpack_nibbles(pl.qweight, pl.span).to(torch.float32)
    scales = pl.wscales.to(torch.float32)
    if pl.w4w8:
        scales = scales * pl.wscales8.to(torch.float32)[None, :]
    zeros = pl.wzeros.to(torch.float32)
    return ((codes - _group_scales_to_k(zeros, pl.groupsize))
            * _group_scales_to_k(scales, pl.groupsize))


def dequantize_to_int8(pl: PackedLinear) -> Tensor:
    """Dequantize to the INT8 domain only: (codes - zero) * int8 group
    scale, the integer half of the dual-grained factorization (the fp half,
    wscales8, is the per-channel epilogue); fits int8 by the w4w8 clamp."""
    if not pl.w4w8:
        raise ValueError("the int8 dequant path requires dual-grained packing")
    codes = unpack_nibbles(pl.qweight, pl.span).to(torch.int32)
    scales_k = _group_scales_to_k(pl.wscales.to(torch.int32), pl.groupsize)
    zeros_k = _group_scales_to_k(pl.wzeros.to(torch.int32), pl.groupsize)
    return ((codes - zeros_k) * scales_k).to(torch.int8)
