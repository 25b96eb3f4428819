"""Token sampling: greedy, temperature, top-k and top-p.

Port of ``dgq_tpu/serving/sampling.py``.  Greedy is bit-compatible with JAX
(first index of the max); the top-k and top-p masks are JAX's; the draw
comes from an explicit ``torch.Generator`` and so gives other tokens than
``jax.random`` from the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def filter_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Tempered (B, V) f32 logits with the top-k / top-p excluded set at -inf."""
    x = logits.to(torch.float32) / params.temperature
    if params.top_k > 0:
        kth = torch.sort(x, dim=-1).values[:, -params.top_k][:, None]
        x = torch.where(x < kth, float("-inf"), x)
    if params.top_p < 1.0:
        sorted_x = torch.flip(torch.sort(x, dim=-1).values, dims=[-1])
        cum = torch.cumsum(torch.softmax(sorted_x, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p (the argmax
        # is always kept)
        cutoff_idx = torch.sum(cum < params.top_p, dim=-1).clamp(max=x.shape[-1] - 1)
        kth = torch.gather(sorted_x, -1, cutoff_idx[:, None])
        x = torch.where(x < kth, float("-inf"), x)
    return x


def sample_logits(logits: torch.Tensor, params: SamplingParams,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B,) int32 token ids."""
    if params.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("non-greedy sampling needs a torch.Generator")
    probs = torch.softmax(filter_logits(logits, params), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
