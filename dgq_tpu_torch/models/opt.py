"""OPT configuration.

Port of ``OPTConfig`` and ``tiny_opt_config`` from ``dgq_tpu/models/opt.py``
(:32-59); the defaults are OPT-6.7B.  The fake-quant OPT model comes with
the PTQ pipeline.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 4096
    ffn_dim: int = 16384
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    max_position_embeddings: int = 2048
    do_layer_norm_before: bool = True
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def tiny_opt_config(**overrides) -> OPTConfig:
    """Tiny fixture config for CPU tests."""
    base = dict(
        vocab_size=256,
        hidden_size=64,
        ffn_dim=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        max_position_embeddings=512,
    )
    base.update(overrides)
    return OPTConfig(**base)
