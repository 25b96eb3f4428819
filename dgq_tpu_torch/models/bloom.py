"""BLOOM configuration and its ALiBi slopes.

Port of ``BloomConfig``, ``tiny_bloom_config`` and ``alibi_slopes`` from
``dgq_tpu/models/bloom.py`` (:36-99); the defaults are BLOOM-7B1.  The
fake-quant BLOOM model comes with the PTQ pipeline.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 4096
    num_hidden_layers: int = 30
    num_attention_heads: int = 32
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def tiny_bloom_config(**overrides) -> BloomConfig:
    """Tiny fixture config for CPU tests."""
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4)
    base.update(overrides)
    return BloomConfig(**base)


def alibi_slopes(n_heads: int, device="cpu") -> torch.Tensor:
    """HF BLOOM's ALiBi slopes (H,) f32: a geometric series over the largest
    power of two of heads, and for the rest every other term of the series
    of twice as many heads."""
    closest_pow2 = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest_pow2) - 3)))
    slopes = [base ** (i + 1) for i in range(closest_pow2)]
    if closest_pow2 != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest_pow2) - 3)))
        num_extra = min(closest_pow2, n_heads - closest_pow2)
        slopes += [extra_base ** (2 * i + 1) for i in range(num_extra)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)
