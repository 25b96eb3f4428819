"""Continuous batching for the OPT, BLOOM, MPT, Falcon and Mixtral INT8
engines.

Port of ``dgq_tpu/serving/family_batch_engine.py``, and the slot machinery
that ``serving/opt_batch_engine.py``'s OPT namespace runs on too: with the
LLaMA path, every engine family is served by the same ``ContinuousBatcher``
(``serving/scheduler.py`` resolves its device functions through ``fns``).

Family specifics live here:
  * BLOOM - embedding LayerNorm, ALiBi, the interleaved (h, 3, dh) fused
    q|k|v, GELU (tanh) (``models/bloom_engine.py``);
  * MPT - plain embedding, ALiBi, the concatenated [q | k | v], GELU (erf)
    (``models/mpt_engine.py``);
  * Falcon - RoPE, multi-query attention (Falcon-7B: 71 query heads on one
    kv head), one fp LayerNorm feeding the parallel attention and MLP
    branches at their own input scales, the parallel residual
    (``models/falcon_engine.py``);
  * Mixtral - RoPE, GQA, the sparse MoE tail (``models/mixtral_engine.py``).

Each family provides slot prefill, chunk prefill (long prompts and prefix
remainders), batched decode with per-slot lengths (and ALiBi, or RoPE at
each slot's position), multi-step decode and the prefix-template copy, over
one generic slot machinery (``_make_family_fns``) and an adapter.  Prefill
runs the engine's own block on one slot (K2, with ALiBi for BLOOM and MPT,
for windows of more than 8 tokens; Falcon's block attends plainly, as
JAX's); a decode step appends each slot's K/V at its own offset and attends
with K3 (K7 past 8192 positions), the per-slot lengths read on the device
(``_decode_ctx``): Falcon-7B's through K3's split kernel; every linear runs
K9 (K10 for a Mixtral checkpoint of fp32 group scales).  The cache is
written in place, as in the port's other batched engines.
"""

from __future__ import annotations

import json
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from dgq_tpu_torch.models.bloom_engine import (
    BloomEngineConfig,
    _bloom_block,
    _bloom_qkv,
    _bloom_tail,
    decode_ctx,
    slopes_on,
)
from dgq_tpu_torch.models.falcon_engine import (
    FalconEngineConfig,
    _falcon_block,
    falcon_branch_codes,
    falcon_qkv,
    falcon_tail,
)
from dgq_tpu_torch.models.llama import rms_norm, rope_cos_sin
from dgq_tpu_torch.models.mixtral_engine import (
    MixtralEngineConfig,
    _mixtral_block,
    mixtral_qkv,
    mixtral_tail,
)
from dgq_tpu_torch.models.opt_engine import layer_norm
from dgq_tpu_torch.models.mpt_engine import MPTEngineConfig, _mpt_block, _mpt_qkv, _mpt_tail
from dgq_tpu_torch.serving.batch_engine import _causal_mask, copy_prefix_into_slot

Tensor = torch.Tensor


class FamilyBatchedKVCache(NamedTuple):
    k: Tensor  # (L, B, Hkv, Dh, Smax) int8, K transposed
    v: Tensor  # (L, B, Hkv, Smax, Dh) int8
    lengths: Tensor  # (B,) int32


def check_int8_cache(kv_bits: int) -> None:
    if kv_bits != 8:
        raise ValueError(f"kv_bits={kv_bits}: INT4 KV is implemented for the LLaMA engine only "
                         "(serving/batch_engine.py); this family serves the INT8 cache")


def append_kv(k_cache: Tensor, v_cache: Tensor, k: Tensor, v: Tensor, lengths: Tensor) -> None:
    """Per-slot append of one token's K/V ((B, H, 1, Dh) int8) at each slot's
    length, clamped to the cache as JAX's dynamic_update_slice clamps it."""
    bi = torch.arange(k.shape[0], device=k.device)
    pos = torch.clamp(lengths.long(), max=k_cache.shape[-1] - 1)
    k_cache[bi, :, :, pos] = k[:, :, 0, :]
    v_cache[bi, :, pos, :] = v[:, :, 0, :]


def decode_multi(decode_batched, ecfg, params, tokens: Tensor, cache, active: Tensor,
                 steps: int):
    """``steps`` greedy steps of ``decode_batched`` for every active slot ->
    (tokens (steps, B), cache); inactive slots carry their input token
    through."""
    toks = []
    t = tokens
    for _ in range(steps):
        logits, cache = decode_batched(ecfg, params, t, cache, active)
        t = torch.where(active, torch.argmax(logits, dim=-1).to(torch.int32), t)
        toks.append(t)
    return torch.stack(toks), cache


def _decode_ctx(ecfg, q_s8: Tensor, k_cache: Tensor, v_cache: Tensor, lengths: Tensor, layer,
                slopes: Optional[Tensor]) -> Tensor:
    """Per-slot decode attention, with ALiBi ``slopes`` or without (None):
    q_s8 (B, H, 1, Dh) -> (B, 1, H * Dh) f32.  K3 (K7 past
    DECODE_SHORT_SMAX positions; either's split kernel at a rep outside 1,
    2, 4 and 8) over each slot's length plus the new token, fp p @ V."""
    b, h, _, dh = q_s8.shape
    return decode_ctx(q_s8[:, :, 0, :].contiguous(), k_cache, v_cache, lengths.long() + 1,
                      layer.q_scale, layer.k_scale, layer.v_scale, slopes).reshape(b, 1, h * dh)


# -- generic slot machinery ---------------------------------------------------
#
# adapter contract (a SimpleNamespace):
#   hk_dh(cfg) -> (Hkv, Dh) of the cache layout
#   embed(ecfg, params, ids (B, S), positions (B or 1, S)) -> x (B, S, D) f32
#   block_prefill(ecfg, layer, x, k, v, start, mask) -> x   (k, v: one slot's caches)
#   block_decode(ecfg, layer, x, k, v, lengths) -> x
#   final(params, x, eps) -> normed x


def _family_init_cache(adapter, cfg, batch: int, max_len: int, kv_bits: int = 8,
                       device="cuda") -> FamilyBatchedKVCache:
    check_int8_cache(kv_bits)
    hk, dh = adapter.hk_dh(cfg)
    n = cfg.num_hidden_layers
    return FamilyBatchedKVCache(
        k=torch.zeros((n, batch, hk, dh, max_len), dtype=torch.int8, device=device),
        v=torch.zeros((n, batch, hk, max_len, dh), dtype=torch.int8, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _family_prefill(adapter, ecfg, params, slot_idx: int, ids: Tensor, start: int,
                    mask: Tensor, cache: FamilyBatchedKVCache, row: int) -> Tensor:
    """The engine's blocks over a window of slot ``slot_idx`` at ``start``
    -> logits (V,) of window row ``row``."""
    dev = params.embed_tokens.device
    x = adapter.embed(ecfg, params, ids[None, :].to(dev),
                      start + torch.arange(ids.shape[0], device=dev)[None, :])
    for li, layer in enumerate(params.layer_list):
        x = adapter.block_prefill(ecfg, layer, x, cache.k[li, slot_idx:slot_idx + 1],
                                  cache.v[li, slot_idx:slot_idx + 1], start, mask)
    x = adapter.final(params, x, ecfg.cfg.layer_norm_eps)
    return torch.matmul(params.lm_head.to(x.dtype), x[0, row])


def _family_prefill_slot(adapter, ecfg, params, slot_idx: int, input_ids: Tensor,
                         prompt_len: int, cache: FamilyBatchedKVCache):
    """Prefill one slot from position 0 with the (S,) padded prompt of
    ``prompt_len`` real tokens; returns (last-token logits (V,), cache)."""
    dev = params.embed_tokens.device
    mask = _causal_mask(torch.arange(input_ids.shape[0], device=dev), cache.k.shape[4],
                        prompt_len)
    logits = _family_prefill(adapter, ecfg, params, slot_idx, input_ids, 0, mask, cache,
                             prompt_len - 1)
    cache.lengths[slot_idx] = prompt_len
    return logits, cache


def _family_prefill_chunk(adapter, ecfg, params, slot_idx: int, chunk_ids: Tensor, start: int,
                          valid: int, cache: FamilyBatchedKVCache):
    """One chunk at cache position ``start`` (``valid`` real tokens), cut at
    the cache's end as ``batch_engine.engine_prefill_chunk``."""
    dev = params.embed_tokens.device
    smax = cache.k.shape[4]
    c = min(chunk_ids.shape[0], smax - start)
    mask = _causal_mask(start + torch.arange(c, device=dev), smax)
    logits = _family_prefill(adapter, ecfg, params, slot_idx, chunk_ids[:c], start, mask, cache,
                             valid - 1)
    cache.lengths[slot_idx] = start + valid
    return logits, cache


def _family_decode_batched(adapter, ecfg, params, tokens: Tensor, cache: FamilyBatchedKVCache,
                           active: Optional[Tensor] = None):
    """One decode step for every slot -> (logits (B, V), cache); only the
    ``active`` (B,) bool slots advance their length (all when None)."""
    x = adapter.embed(ecfg, params, tokens[:, None].to(params.embed_tokens.device),
                      cache.lengths[:, None])
    for li, layer in enumerate(params.layer_list):
        x = adapter.block_decode(ecfg, layer, x, cache.k[li], cache.v[li], cache.lengths)
    x = adapter.final(params, x, ecfg.cfg.layer_norm_eps)
    logits = torch.matmul(x[:, 0], params.lm_head.to(x.dtype).t())
    cache.lengths.add_(1 if active is None else active.to(torch.int32))
    return logits, cache


def _make_family_fns(adapter) -> SimpleNamespace:
    """The ``fns`` namespace of an adapter's family.  Each entry calls this
    module's generic function by name when it runs (a wrapper set on the
    module, e.g. a call counter, takes effect)."""
    def decode_batched(ecfg, params, tokens, cache, active=None):
        return _family_decode_batched(adapter, ecfg, params, tokens, cache, active)

    return SimpleNamespace(
        engine_prefill_slot=lambda *a: _family_prefill_slot(adapter, *a),
        engine_prefill_chunk=lambda *a: _family_prefill_chunk(adapter, *a),
        engine_decode_batched=decode_batched,
        engine_decode_multi=lambda ecfg, params, tokens, cache, active, steps: decode_multi(
            decode_batched, ecfg, params, tokens, cache, active, steps),
        copy_prefix_into_slot=copy_prefix_into_slot,
        init_batched_cache=lambda *a, **k: _family_init_cache(adapter, *a, **k),
    )


def _slopes(ecfg, x: Tensor) -> Tensor:
    return slopes_on(ecfg.cfg.num_attention_heads, str(x.device))


# -- BLOOM --------------------------------------------------------------------


def _bloom_decode_block_batched(ecfg: BloomEngineConfig, layer, x: Tensor, k_cache: Tensor,
                                v_cache: Tensor, lengths: Tensor) -> Tensor:
    """``_bloom_block`` at one token a slot with per-slot append and length."""
    q, k, v = _bloom_qkv(ecfg, layer, x)
    append_kv(k_cache, v_cache, k, v, lengths)
    ctx = _decode_ctx(ecfg, q, k_cache, v_cache, lengths, layer, _slopes(ecfg, x))
    return _bloom_tail(ecfg, layer, x, ctx)


def bloom_serving_fns() -> SimpleNamespace:
    return _make_family_fns(SimpleNamespace(
        hk_dh=lambda cfg: (cfg.num_attention_heads, cfg.head_dim),
        embed=lambda ecfg, params, ids, positions: layer_norm(
            params.embed_tokens[ids.long()], params.emb_ln_weight, params.emb_ln_bias,
            ecfg.cfg.layer_norm_eps),
        block_prefill=lambda ecfg, layer, x, k, v, start, mask: _bloom_block(
            ecfg, layer, x, k, v, start, mask, _slopes(ecfg, x)),
        block_decode=_bloom_decode_block_batched,
        final=lambda params, x, eps: layer_norm(x, params.ln_f_weight, params.ln_f_bias, eps),
    ))


# -- MPT ----------------------------------------------------------------------


def _mpt_decode_block_batched(ecfg: MPTEngineConfig, layer, x: Tensor, k_cache: Tensor,
                              v_cache: Tensor, lengths: Tensor) -> Tensor:
    """``_mpt_block`` at one token a slot with per-slot append and length."""
    q, k, v = _mpt_qkv(ecfg, layer, x)
    append_kv(k_cache, v_cache, k, v, lengths)
    ctx = _decode_ctx(ecfg, q, k_cache, v_cache, lengths, layer, _slopes(ecfg, x))
    return _mpt_tail(ecfg, layer, x, ctx)


def mpt_serving_fns() -> SimpleNamespace:
    return _make_family_fns(SimpleNamespace(
        hk_dh=lambda cfg: (cfg.n_heads, cfg.head_dim),
        embed=lambda ecfg, params, ids, positions: params.embed_tokens[ids.long()].to(
            torch.float32),
        block_prefill=lambda ecfg, layer, x, k, v, start, mask: _mpt_block(
            ecfg, layer, x, k, v, start, mask, _slopes(ecfg, x)),
        block_decode=_mpt_decode_block_batched,
        final=lambda params, x, eps: layer_norm(x, params.norm_f_weight, params.norm_f_bias,
                                                eps),
    ))


# -- Falcon and Mixtral (RoPE) -------------------------------------------------


def _slot_rope(cfg, lengths: Tensor):
    """cos, sin (B, 1, 1, Dh) at each slot's position ``lengths`` (B,)."""
    cos, sin = rope_cos_sin(lengths, cfg.head_dim, cfg.rope_theta)
    return cos[:, None, None], sin[:, None, None]


def _window_rope(cfg, start: int, x: Tensor):
    """cos, sin (S, Dh) of the (B, S, D) window ``x`` at position ``start``."""
    return rope_cos_sin(start + torch.arange(x.shape[1], device=x.device), cfg.head_dim,
                        cfg.rope_theta)


def _falcon_decode_block_batched(ecfg: FalconEngineConfig, layer, x: Tensor, k_cache: Tensor,
                                 v_cache: Tensor, lengths: Tensor) -> Tensor:
    """``_falcon_block`` at one token a slot with per-slot RoPE, append and
    length; the attention K3 (Falcon-7B: its split kernel at 71 query heads
    a kv head), as JAX's batched decode attends."""
    x_attn_s8, x_fc1_s8 = falcon_branch_codes(ecfg, layer, x)
    q, k, v = falcon_qkv(ecfg, layer, x_attn_s8, *_slot_rope(ecfg.cfg, lengths))
    append_kv(k_cache, v_cache, k, v, lengths)
    ctx = _decode_ctx(ecfg, q, k_cache, v_cache, lengths, layer, None)
    return falcon_tail(ecfg, layer, x, ctx, x_fc1_s8)


def falcon_serving_fns() -> SimpleNamespace:
    def block_prefill(ecfg, layer, x, k, v, start, mask):
        return _falcon_block(ecfg, layer, x, k, v, start, mask, *_window_rope(ecfg.cfg, start, x))

    return _make_family_fns(SimpleNamespace(
        hk_dh=lambda cfg: (cfg.num_kv_heads, cfg.head_dim),
        embed=lambda ecfg, params, ids, positions: params.embed_tokens[ids.long()].to(
            torch.float32),
        block_prefill=block_prefill,
        block_decode=_falcon_decode_block_batched,
        final=lambda params, x, eps: layer_norm(x, params.ln_f_weight, params.ln_f_bias, eps),
    ))


def _mixtral_decode_block_batched(ecfg: MixtralEngineConfig, layer, x: Tensor,
                                  k_cache: Tensor, v_cache: Tensor, lengths: Tensor) -> Tensor:
    """``_mixtral_block`` at one token a slot with per-slot RoPE, append and
    length: K3 (K7 past DECODE_SHORT_SMAX positions), then the sparse MoE
    tail, which is position-independent."""
    q, k, v = mixtral_qkv(ecfg, layer, x, *_slot_rope(ecfg.cfg, lengths))
    append_kv(k_cache, v_cache, k, v, lengths)
    ctx = _decode_ctx(ecfg, q, k_cache, v_cache, lengths, layer, None)
    return mixtral_tail(ecfg, layer, x, ctx)


def mixtral_serving_fns() -> SimpleNamespace:
    def block_prefill(ecfg, layer, x, k, v, start, mask):
        return _mixtral_block(ecfg, layer, x, k, v, start, *_window_rope(ecfg.cfg, start, x),
                              mask)

    return _make_family_fns(SimpleNamespace(
        hk_dh=lambda cfg: (cfg.num_key_value_heads, cfg.head_dim),
        embed=lambda ecfg, params, ids, positions: params.embed_tokens[ids.long()].to(
            torch.float32),
        block_prefill=block_prefill,
        block_decode=_mixtral_decode_block_batched,
        final=lambda params, x, eps: rms_norm(x, params.norm_weight.to(x.dtype), eps),
    ))


_FAMILY_FNS = {"bloom": bloom_serving_fns, "mpt": mpt_serving_fns,
               "falcon": falcon_serving_fns, "mixtral": mixtral_serving_fns}


def family_batcher(arch: str, ecfg, params, **kw):
    """Continuous batching for any engine family: llama -> the
    ContinuousBatcher on its own functions; opt -> ``opt_batcher``; bloom,
    mpt, falcon, mixtral -> the ContinuousBatcher over their ``fns``
    (admit_batch=1, spec_k=0, as JAX's)."""
    from dgq_tpu_torch.serving.scheduler import ContinuousBatcher

    if arch == "opt":
        from dgq_tpu_torch.serving.opt_batch_engine import opt_batcher

        return opt_batcher(ecfg, params, **kw)
    if arch == "llama":
        return ContinuousBatcher(ecfg, params, **kw)
    if arch not in _FAMILY_FNS:
        raise ValueError(f"unknown engine family {arch!r}")
    if kw.get("admit_batch", 1) > 1 or kw.get("spec_k", 0) > 0:
        raise ValueError(f"{arch} serving supports admit_batch=1, spec_k=0")
    return ContinuousBatcher(ecfg, params, fns=_FAMILY_FNS[arch](), **kw)


def batcher_from_checkpoint(path: str, *, device="cuda", **kw):
    """Serving startup from any family's save_engine checkpoint: the family
    comes from the manifest's ``arch`` and the right batcher is made (llama
    gets the ContinuousBatcher with its full feature set; the other
    families the ``fns``-based scheduler).  LLaMA and Mixtral take
    ``fp_scales`` from the stored scales (JAX's omits it for Mixtral and
    would run fp32 scales through the int8-scale path).  Returns (arch,
    batcher)."""
    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.models.opt_engine import OPTEngineConfig
    from dgq_tpu_torch.utils.checkpoint import fp_scales_of, load_engine_any

    eng, cfg = load_engine_any(path, device=device)
    with open(path + ".json") as f:
        arch = json.load(f).get("arch", "llama")
    if arch == "llama":
        ecfg = EngineConfig(cfg=cfg, fp_scales=fp_scales_of(eng))
    elif arch == "mixtral":
        ecfg = MixtralEngineConfig(cfg=cfg, fp_scales=fp_scales_of(eng))
    else:
        ecfg = {"opt": OPTEngineConfig, "bloom": BloomEngineConfig, "mpt": MPTEngineConfig,
                "falcon": FalconEngineConfig}[arch](cfg=cfg)
    return arch, family_batcher(arch, ecfg, eng, **kw)
