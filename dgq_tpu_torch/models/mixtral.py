"""Mixtral configuration and its top-k router.

Port of ``MixtralConfig`` (with its ``layer_norm_eps`` alias),
``tiny_mixtral_config`` and ``route_topk`` from ``dgq_tpu/models/mixtral.py``
(:67-165); the defaults are Mixtral-8x7B (a sparse mixture-of-experts
LLaMA: 8 SwiGLU experts a layer, each token routed to 2).  The fake-quant
Mixtral model comes with the PTQ pipeline.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e6
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def layer_norm_eps(self) -> float:
        """The eps under the name the other families' configs use (the family
        batcher's final norm reads it); Mixtral's norms are RMS."""
        return self.rms_norm_eps


def tiny_mixtral_config(**overrides) -> MixtralConfig:
    """Tiny fixture config for CPU tests."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
                num_experts_per_tok=2, max_position_embeddings=512)
    base.update(overrides)
    return MixtralConfig(**base)


def route_topk(router_logits: torch.Tensor, k: int):
    """Top-k routing with renormalised softmax weights (HF Mixtral's
    norm_topk_prob): softmax over all experts, the k largest, their mass
    renormalised to 1 -> (weights (..., k), expert index (..., k) int64).
    Ties go to the lower expert index, as ``jax.lax.top_k`` orders them: a
    stable descending sort (``torch.topk`` promises no order among equal
    values)."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]
    return topw / torch.sum(topw, dim=-1, keepdim=True), topi
