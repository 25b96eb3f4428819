"""MPT configuration.

Port of ``MPTConfig`` and ``tiny_mpt_config`` from ``dgq_tpu/models/mpt.py``
(:33-64); the defaults are MPT-7B.  MPT's attention takes BLOOM's ALiBi
slopes (``models/bloom.alibi_slopes``).  The fake-quant MPT model comes
with the PTQ pipeline.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MPTConfig:
    vocab_size: int = 50368
    d_model: int = 4096
    n_heads: int = 32
    n_layers: int = 32
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    layer_norm_eps: float = 1e-5
    no_bias: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ffn_dim(self) -> int:
        return self.expansion_ratio * self.d_model

    # the names the other configs use, for code shared across families
    @property
    def hidden_size(self) -> int:
        return self.d_model

    @property
    def num_hidden_layers(self) -> int:
        return self.n_layers

    @property
    def num_attention_heads(self) -> int:
        return self.n_heads


def tiny_mpt_config(**overrides) -> MPTConfig:
    """Tiny fixture config for CPU tests."""
    base = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, max_seq_len=256)
    base.update(overrides)
    return MPTConfig(**base)
