"""INT4 nibble packing (span and pair layouts).

Port of ``dgq_tpu/quant/packing.py:35-84``.  Weights are stored input-major
as ``(K//2, N)`` int8 bytes.  With ``span == 2*groupsize`` each byte row r of
a span packs logical row r (high nibble) and row r + span/2 (low nibble), so
each nibble plane is one quantization group; ``span == 0`` packs adjacent
rows (2*k2 high, 2*k2+1 low).
"""

from __future__ import annotations

import torch


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
