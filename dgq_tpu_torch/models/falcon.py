"""Falcon configuration.

Port of ``FalconConfig`` and ``tiny_falcon_config`` from
``dgq_tpu/models/falcon.py`` (:39-60); the defaults are Falcon-7B (parallel
attention and MLP off one LayerNorm, a fused multi-query query_key_value of
71 query heads and 1 kv head, RoPE, GELU).  The fake-quant Falcon model
comes with the PTQ pipeline.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FalconConfig:
    vocab_size: int = 65024
    hidden_size: int = 4544
    num_hidden_layers: int = 32
    num_attention_heads: int = 71
    num_kv_heads: int = 1  # multi-query
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    parallel_attn: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def tiny_falcon_config(**overrides) -> FalconConfig:
    """Tiny fixture config for CPU tests."""
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_kv_heads=1)
    base.update(overrides)
    return FalconConfig(**base)
