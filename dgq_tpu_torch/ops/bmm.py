"""INT8 batched matmul: the reference's BMM_S8T_S8N_F32T API.

Port of ``dgq_tpu/ops/bmm.py``: ``bmm_s8t_s8n_f32t(a, b, alpha)`` computes
``alpha * (a @ b^T)`` for row-major int8 ``a`` (..., M, K) and ``b`` (...,
N, K) -> (..., M, N) f32.  JAX computes it outside any Pallas kernel (an
int8 dot_general), and so does this port: an exact int32 product
(``int_matmul``), then one f32 scale.
"""

from __future__ import annotations

import torch

from dgq_tpu_torch.ops.quant_matmul import int_matmul


def bmm_s8t_s8n_f32t(a_s8: torch.Tensor, b_s8: torch.Tensor, alpha) -> torch.Tensor:
    """(..., M, K) int8 x (..., N, K) int8 -> (..., M, N) f32, times ``alpha``
    (s_a * s_b)."""
    s32 = int_matmul(a_s8, b_s8.transpose(-1, -2))
    return s32.to(torch.float32) * torch.as_tensor(alpha, dtype=torch.float32,
                                                   device=s32.device)


class BMM_S8T_S8N_F32T:
    """Stateful wrapper mirroring the reference module: ``alpha`` set at
    construction or from the two operands' scales."""

    def __init__(self, alpha: float = 1.0):
        self.alpha = torch.as_tensor(alpha, dtype=torch.float32)

    @classmethod
    def from_scale(cls, a_scale, b_scale):
        out = cls()
        out.alpha = (torch.as_tensor(a_scale, dtype=torch.float32)
                     * torch.as_tensor(b_scale, dtype=torch.float32))
        return out

    def __call__(self, a_s8: torch.Tensor, b_s8: torch.Tensor) -> torch.Tensor:
        return bmm_s8t_s8n_f32t(a_s8, b_s8, self.alpha)
