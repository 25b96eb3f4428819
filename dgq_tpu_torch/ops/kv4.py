"""INT4 KV-cache packing (the ``kv_bits=4`` engine mode).

Port of ``dgq_tpu/ops/kv4.py``.  K/V quantise to symmetric INT4 [-7, 7] and
pack two codes per byte along the HEAD dim, so every cache position stays
byte-aligned for positional writes:

  K cache (B, Hkv, Dh,   Smax) int8  ->  (B, Hkv, Dh//2, Smax) packed
  V cache (B, Hkv, Smax, Dh)   int8  ->  (B, Hkv, Smax, Dh//2) packed

Even Dh indices go to the low nibble, odd ones to the high nibble (the
opposite of the span weight layout of ``quant/packing.pack_nibbles``, which
puts group 2t high).  Scales derive from the calibrated INT8 scales:
``scale4 = scale8 * 127 / 7`` maps the same absmax onto the int4 grid.
"""

from __future__ import annotations

import torch

# int8 -> int4 range ratio: same absmax, 4-bit symmetric grid
KV4_RATIO = 127.0 / 7.0


def kv4_scale(scale8: torch.Tensor) -> torch.Tensor:
    """The effective int4 scale ``scale8 * 127/7``, the ratio a float32 as
    JAX rounds its weakly typed constant."""
    return scale8 * torch.tensor(KV4_RATIO, dtype=torch.float32, device=scale8.device)


def quantize_kv4(x: torch.Tensor, scale8: torch.Tensor) -> torch.Tensor:
    """fp -> int4 codes in [-7, 7] (stored in int8), using the calibrated
    int8 scale."""
    return torch.clamp(torch.round(x / kv4_scale(scale8)), -7, 7).to(torch.int8)


def pack_nibbles(x4: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int4 codes pairwise along ``axis`` (of even length): even
    indices -> low nibble, odd -> high nibble.  Bytes are assembled as uint8
    and reinterpreted as int8."""
    ax = axis % x4.ndim
    if x4.shape[ax] % 2:
        raise ValueError(f"axis {axis} of {tuple(x4.shape)} must have even length")
    u = x4.movedim(ax, -1).contiguous().view(torch.uint8)
    packed = ((u[..., 1::2] << 4) | (u[..., 0::2] & 0xF)).view(torch.int8)
    return packed.movedim(-1, ax).contiguous()


def unpack_nibbles(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of pack_nibbles: int8 bytes -> sign-extended int4 values,
    interleaved back to the original order along ``axis``.  The nibbles are
    sign-extended on int32 (a right shift of the int8 byte widened to int32
    is arithmetic)."""
    ax = axis % packed.ndim
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    shape = list(packed.shape)
    shape[ax] *= 2
    return torch.stack([lo, hi], dim=ax + 1).reshape(shape).to(torch.int8)
