"""Slot-based batched execution for the OPT INT8 engine.

Port of ``dgq_tpu/serving/opt_batch_engine.py``: the OPT namespace of
device functions (``opt_serving_fns``) through which the family-generic
``ContinuousBatcher`` (``serving/scheduler.py``, its ``fns``) serves OPT:
learned positional embeddings (+2 offset), LayerNormQ blocks, no RoPE, MHA,
the int8-out q|k|v whose q carries 1/sqrt(Dh), as an adapter of
``family_batch_engine``'s slot machinery.  Prefill runs the engine's own
block (``models/opt_engine._opt_block``) on one slot; a decode step appends
each slot's K/V at its own offset and attends with K3
(``int8_decode_attention``, the per-slot lengths read on the device), every
linear through K9.  As in the port's other batched engines, the cache is
written in place and every function returns the cache it was given.

Usage:
    from dgq_tpu_torch.serving.opt_batch_engine import opt_batcher
    b = opt_batcher(ecfg, params, num_slots=8, max_len=512)
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from dgq_tpu_torch.models.opt_engine import (
    OPTEngineConfig,
    OPTEngineParams,
    _opt_block,
    _opt_qkv,
    _opt_tail,
    layer_norm,
    opt_decode_ctx,
)
from dgq_tpu_torch.serving.batch_engine import copy_prefix_into_slot
from dgq_tpu_torch.serving.family_batch_engine import (
    FamilyBatchedKVCache,
    _family_decode_batched,
    _family_init_cache,
    _family_prefill_chunk,
    _family_prefill_slot,
    append_kv,
    decode_multi,
)

Tensor = torch.Tensor


def _embed(ecfg: OPTEngineConfig, params: OPTEngineParams, ids: Tensor,
           positions: Tensor) -> Tensor:
    """Token plus learned position embeddings (+2 offset) -> f32."""
    tok = params.embed_tokens[ids.long()]
    return (tok + params.embed_positions[positions.long() + 2]).to(torch.float32)


def _opt_decode_block_batched(ecfg: OPTEngineConfig, layer, x: Tensor, k_cache: Tensor,
                              v_cache: Tensor, lengths: Tensor) -> Tensor:
    """One OPT block for one decode token per slot: x (B, 1, D), caches
    (B, H, ...) written in place, lengths (B,) on the device."""
    b = x.shape[0]
    q, k, v = _opt_qkv(ecfg, layer, x)
    h, dh = q.shape[1], q.shape[3]
    append_kv(k_cache, v_cache, k, v, lengths)
    ctx = opt_decode_ctx(ecfg, layer, q[:, :, 0, :].contiguous(), k_cache, v_cache,
                         lengths.long() + 1)
    return _opt_tail(ecfg, layer, x, ctx.reshape(b, 1, h * dh))


# OPT on the family slot machinery (``family_batch_engine``'s adapter contract)
_OPT = SimpleNamespace(
    hk_dh=lambda cfg: (cfg.num_attention_heads, cfg.head_dim),
    embed=_embed,
    block_prefill=_opt_block,
    block_decode=_opt_decode_block_batched,
    final=lambda params, x, eps: layer_norm(x, params.final_ln_weight, params.final_ln_bias,
                                            eps),
)


def init_opt_batched_cache(cfg, batch: int, max_len: int, kv_bits: int = 8,
                           device="cuda") -> FamilyBatchedKVCache:
    return _family_init_cache(_OPT, cfg, batch, max_len, kv_bits, device)


def opt_prefill_slot(ecfg: OPTEngineConfig, params: OPTEngineParams, slot_idx: int,
                     input_ids: Tensor, prompt_len: int, cache: FamilyBatchedKVCache):
    """Prefill one slot from position 0 with the (S,) padded prompt of
    ``prompt_len`` real tokens; returns (last-token logits (V,), cache)."""
    return _family_prefill_slot(_OPT, ecfg, params, slot_idx, input_ids, prompt_len, cache)


def opt_prefill_chunk(ecfg: OPTEngineConfig, params: OPTEngineParams, slot_idx: int,
                      chunk_ids: Tensor, start: int, valid: int, cache: FamilyBatchedKVCache):
    """Prefill one chunk of a prompt into slot ``slot_idx`` at cache position
    ``start``; ``valid`` counts its real tokens."""
    return _family_prefill_chunk(_OPT, ecfg, params, slot_idx, chunk_ids, start, valid, cache)


def opt_decode_batched(ecfg: OPTEngineConfig, params: OPTEngineParams, tokens: Tensor,
                       cache: FamilyBatchedKVCache, active: Optional[Tensor] = None):
    """One decode step for every slot -> (logits (B, V), cache); only the
    ``active`` (B,) bool slots advance their length (all when None)."""
    return _family_decode_batched(_OPT, ecfg, params, tokens, cache, active)


def opt_decode_multi(ecfg: OPTEngineConfig, params: OPTEngineParams, tokens: Tensor,
                     cache: FamilyBatchedKVCache, active: Tensor, steps: int):
    """``steps`` greedy decode steps in one call -> (tokens (steps, B), cache)."""
    return decode_multi(opt_decode_batched, ecfg, params, tokens, cache, active, steps)


# the dense cache's prefix install is the LLaMA batched engine's, field for field
opt_copy_prefix_into_slot = copy_prefix_into_slot


def opt_serving_fns() -> SimpleNamespace:
    """The OPT namespace for ``ContinuousBatcher(fns=...)``.  No batched
    prefill and no speculative functions: keep admit_batch=1 and spec_k=0
    (the scheduler never calls them then)."""
    return SimpleNamespace(
        engine_prefill_slot=opt_prefill_slot,
        engine_prefill_chunk=opt_prefill_chunk,
        engine_decode_batched=opt_decode_batched,
        engine_decode_multi=opt_decode_multi,
        copy_prefix_into_slot=opt_copy_prefix_into_slot,
        init_batched_cache=init_opt_batched_cache,
    )


def opt_batcher(ecfg: OPTEngineConfig, params: OPTEngineParams, **kw):
    """Continuous batching over the OPT INT8 engine."""
    from dgq_tpu_torch.serving.scheduler import ContinuousBatcher

    if kw.get("admit_batch", 1) > 1 or kw.get("spec_k", 0) > 0:
        raise ValueError("OPT serving supports admit_batch=1, spec_k=0")
    return ContinuousBatcher(ecfg, params, fns=opt_serving_fns(), **kw)
