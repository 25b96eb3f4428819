"""Rowpair layout conversion helpers.

Port of the conversion helpers of ``dgq_tpu/ops/fused_decode.py:154-229``.
The fused decode kernels of that module (``fused_norm_gemv_rp``,
``fused_requant_gemv_rp``, ``fused_mlp_decode_rp``) are not ported yet;
``cs_fold`` is carried for them and is not read by the unfused engine path.
"""

from __future__ import annotations

import torch

from dgq_tpu_torch.quant.packing import unpack_nibbles


def _stacked(a: torch.Tensor, trailing: int) -> torch.Tensor:
    return a.reshape((-1,) + tuple(a.shape[-trailing:]))


def pack_rowpair_s4(qweight_span: torch.Tensor, span: int) -> torch.Tensor:
    """Repack span-packed nibbles into the ROWPAIR-SHIFTED layout: byte r
    packs the zero-shifted codes ``(c - 8) & 0xF`` of logical rows 2r (LOW
    nibble) and 2r+1 (HIGH nibble).  Accepts stacked (..., K//2, N)."""
    lead = qweight_span.shape[:-2]
    outs = []
    for q in _stacked(qweight_span, 2):
        c4 = (unpack_nibbles(q, span).to(torch.int32) - 8) & 0xF
        byte = (c4[1::2] << 4) | c4[0::2]
        outs.append(byte.to(torch.uint8).view(torch.int8))
    out = torch.stack(outs)
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


def _scale_rows(sh: torch.Tensor, sl: torch.Tensor, g: int, n: int) -> torch.Tensor:
    s_g = torch.zeros((g, n), dtype=torch.int32, device=sh.device)
    s_g[0::2] = sh.to(torch.int32)
    s_g[1::2] = sl.to(torch.int32)
    return s_g


def rowpair_cs_fold(qweight_span: torch.Tensor, span: int,
                    s_hi: torch.Tensor, s_lo: torch.Tensor) -> torch.Tensor:
    """(..., N) int32 ``8 * sum_g s_g * colsum_g(c - 8)`` from span codes;
    s_hi/s_lo are the compact per-plane scale rows (even/odd groups)."""
    lead = qweight_span.shape[:-2]
    gs = span // 2
    outs = []
    for q, sh, sl in zip(_stacked(qweight_span, 2), _stacked(s_hi, 2), _stacked(s_lo, 2)):
        c4 = unpack_nibbles(q, span).to(torch.int32) - 8
        k, n = c4.shape
        cs = c4.reshape(k // gs, gs, n).sum(dim=1)
        outs.append(8 * torch.sum(cs * _scale_rows(sh, sl, cs.shape[0], n), dim=0,
                                     dtype=torch.int32))
    out = torch.stack(outs)
    return out.reshape(tuple(lead) + tuple(out.shape[-1:]))


def rowpair_cs_fold_rp(qw_rp: torch.Tensor, groupsize: int,
                       s_hi: torch.Tensor, s_lo: torch.Tensor) -> torch.Tensor:
    """rowpair_cs_fold computed from the rowpair layout itself."""
    from dgq_tpu_torch.ops.quant_matmul import unpack_rowpair_s4

    lead = qw_rp.shape[:-2]
    outs = []
    for q, sh, sl in zip(_stacked(qw_rp, 2), _stacked(s_hi, 2), _stacked(s_lo, 2)):
        c4 = unpack_rowpair_s4(q).to(torch.int32)
        k, n = c4.shape
        cs = c4.reshape(k // groupsize, groupsize, n).sum(dim=1)
        outs.append(8 * torch.sum(cs * _scale_rows(sh, sl, cs.shape[0], n), dim=0,
                                     dtype=torch.int32))
    out = torch.stack(outs)
    return out.reshape(tuple(lead) + tuple(out.shape[-1:]))
