"""Slot-based batched engine execution for continuous batching.

Port of ``dgq_tpu/serving/batch_engine.py``.  The dense KV cache holds B
independent slots, each with its own length:

  * ``engine_prefill_slot``, ``engine_prefill_batched`` and
    ``engine_prefill_chunk`` run the engine's own block stack
    (``models/engine._block``) on one slot, on several slots at once, or on
    one chunk of a slot's prompt, so prefill numerics are the engine's;
  * ``engine_decode_batched`` runs one decode token for every slot at its own
    position (per-slot RoPE, per-slot append, per-slot length), with K3
    (``int8_decode_attention``) or, past 8192 positions, K7
    (``int8_decode_attention_chunked``), both reading the lengths on the
    device; under ``kv_bits=4`` the plain attention over the unpacked cache,
    as JAX's;
  * ``engine_decode_multi`` runs several greedy steps in one call;
  * ``engine_verify_batched`` runs a speculative-verification window of
    K+1 tokens per slot at the slot's own offset (lengths unchanged), and
    ``engine_spec_decode_multi`` several speculative steps with drafting,
    acceptance and the appends on the device, one host read per call.  The
    window's linears take the fused kernels (K4-K6, or K12 on span-only
    storage) on its flattened rows; its attention is plain torch ops over
    the slot's cache, as JAX's is XLA (the reference's choice for a window
    of ~5 queries, not a missing kernel), with quant_pv's INT8 p @ V on
    INT8 caches as the decode kernels compute it.

Inactive slots decode garbage at a fixed position that the scheduler
ignores.  JAX's ``jit``/``scan``/``vmap`` become Python loops over layers
and steps and written-out batch dimensions.  As in the port's engine, the
cache is written in place (JAX returns new arrays); every function returns
the cache it was given.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from dgq_tpu_torch.models.engine import (
    EngineConfig,
    EngineParams,
    _attention_scores,
    _block,
    _block_tail,
    _qkv_rows,
    _requant,
    _use_fused_rows,
    kv_head_bytes,
)
from dgq_tpu_torch.models.llama import rms_norm, rope_cos_sin, rotate_half
from dgq_tpu_torch.ops.attention import (
    NEG,
    _quantize_exp,
    auto_decode_chunk,
    f32,
    int8_decode_attention,
    int8_decode_attention_chunked,
    int8_decode_attention_xla,
)
from dgq_tpu_torch.ops.kv4 import kv4_scale, pack_nibbles, quantize_kv4, unpack_nibbles
from dgq_tpu_torch.ops.quant_matmul import int_matmul

Tensor = torch.Tensor


class BatchedKVCache(NamedTuple):
    k: Tensor  # (L, B, Hkv, Dh, Smax) int8, K transposed (Dh/2 packed under kv_bits=4)
    v: Tensor  # (L, B, Hkv, Smax, Dh) int8 (Dh/2 packed under kv_bits=4)
    lengths: Tensor  # (B,) int32 per-slot valid token counts


def init_batched_cache(cfg, batch: int, max_len: int, kv_bits: int = 8,
                       device="cuda") -> BatchedKVCache:
    n, hk, dh = cfg.num_hidden_layers, cfg.num_key_value_heads, kv_head_bytes(cfg, kv_bits)
    return BatchedKVCache(
        k=torch.zeros((n, batch, hk, dh, max_len), dtype=torch.int8, device=device),
        v=torch.zeros((n, batch, hk, max_len, dh), dtype=torch.int8, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _causal_mask(positions: Tensor, smax: int, limit: Optional[int] = None) -> Tensor:
    """(S, smax) additive mask: 0 where key j <= query position (and j < limit)."""
    dev = positions.device
    j = torch.arange(smax, device=dev)[None, :]
    ok = j <= positions[:, None]
    if limit is not None:
        ok = ok & (j < limit)
    return torch.where(ok, f32(0.0, dev), f32(NEG, dev))


def _last_logits(ecfg: EngineConfig, params: EngineParams, x: Tensor, row: int) -> Tensor:
    """Logits (V,) of row ``row`` of a (1, S, D) window."""
    x = rms_norm(x, params.norm_weight.to(x.dtype), ecfg.cfg.rms_norm_eps)
    return torch.matmul(params.lm_head.to(x.dtype), x[0, row])


def _embed(params: EngineParams, ids: Tensor) -> Tensor:
    return params.embed_tokens[ids.to(params.embed_tokens.device).long()].to(torch.float32)


def engine_prefill_slot(ecfg: EngineConfig, params: EngineParams, slot_idx: int,
                        input_ids: Tensor, prompt_len: int,
                        cache: BatchedKVCache) -> Tuple[Tensor, BatchedKVCache]:
    """Prefill one slot from position 0 with the (S,) padded prompt of
    ``prompt_len`` real tokens; returns (last-token logits (V,), cache)."""
    cfg = ecfg.cfg
    dev = params.embed_tokens.device
    s = input_ids.shape[0]
    x = _embed(params, input_ids[None, :])
    pos_cos, pos_sin = rope_cos_sin(torch.arange(s, device=dev), cfg.head_dim, cfg.rope_theta)
    # causal within the prompt; everything beyond the fresh slot is masked
    mask = _causal_mask(torch.arange(s, device=dev), cache.k.shape[4], prompt_len)
    for li, layer in enumerate(params.layer_list):
        x = _block(ecfg, layer, x, cache.k[li, slot_idx:slot_idx + 1],
                   cache.v[li, slot_idx:slot_idx + 1], 0, pos_cos, pos_sin, mask)
    cache.lengths[slot_idx] = prompt_len
    return _last_logits(ecfg, params, x, prompt_len - 1), cache


def engine_prefill_chunk(ecfg: EngineConfig, params: EngineParams, slot_idx: int,
                         chunk_ids: Tensor, start: int, valid: int,
                         cache: BatchedKVCache) -> Tuple[Tensor, BatchedKVCache]:
    """Prefill one chunk of a prompt into slot ``slot_idx`` at cache position
    ``start``; ``valid`` counts its real tokens.  Returns (last valid token's
    logits (V,), cache with the slot's length set to start + valid).

    Padding positions of the chunk write K/V past the slot's length, which
    later chunks and decode overwrite and attention masks.  A chunk that
    would run past the cache is cut at its end: only padding lies there
    (JAX's dynamic_update_slice would instead move the whole write back)."""
    cfg = ecfg.cfg
    dev = params.embed_tokens.device
    smax = cache.k.shape[4]
    c = min(chunk_ids.shape[0], smax - start)
    x = _embed(params, chunk_ids[None, :c])
    positions = start + torch.arange(c, device=dev)
    pos_cos, pos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    mask = _causal_mask(positions, smax)
    for li, layer in enumerate(params.layer_list):
        x = _block(ecfg, layer, x, cache.k[li, slot_idx:slot_idx + 1],
                   cache.v[li, slot_idx:slot_idx + 1], start, pos_cos, pos_sin, mask)
    cache.lengths[slot_idx] = start + valid
    return _last_logits(ecfg, params, x, valid - 1), cache


def engine_prefill_batched(ecfg: EngineConfig, params: EngineParams, slot_idx: Sequence[int],
                           input_ids: Tensor, prompt_lens: Sequence[int],
                           cache: BatchedKVCache) -> Tuple[Tensor, BatchedKVCache]:
    """Prefill A prompts (A, S), padded to a common S, into A distinct slots
    in one pass.  The shared causal mask is exact for mixed lengths: real
    token i attends keys j <= i, all below its own prompt length.  Each
    layer gathers the A slots' caches, runs the block and writes them back.
    Returns (per-slot last-token logits (A, V), cache)."""
    cfg = ecfg.cfg
    dev = params.embed_tokens.device
    a, s = input_ids.shape
    x = _embed(params, input_ids)
    pos_cos, pos_sin = rope_cos_sin(torch.arange(s, device=dev), cfg.head_dim, cfg.rope_theta)
    mask = _causal_mask(torch.arange(s, device=dev), cache.k.shape[4])
    idx = torch.as_tensor(list(slot_idx), dtype=torch.long, device=dev)
    for li, layer in enumerate(params.layer_list):
        k_slots, v_slots = cache.k[li, idx], cache.v[li, idx]
        x = _block(ecfg, layer, x, k_slots, v_slots, 0, pos_cos, pos_sin, mask)
        cache.k[li, idx], cache.v[li, idx] = k_slots, v_slots
    lens = torch.as_tensor(list(prompt_lens), dtype=torch.long, device=dev)
    cache.lengths[idx] = lens.to(torch.int32)
    x = rms_norm(x, params.norm_weight.to(x.dtype), cfg.rms_norm_eps)
    last = x[torch.arange(a, device=dev), lens - 1]  # (A, D)
    return torch.matmul(last, params.lm_head.to(x.dtype).t()), cache


def copy_prefix_into_slot(cache: BatchedKVCache, slot_idx: int, k_template: Tensor,
                          v_template: Tensor, prefix_len: int) -> BatchedKVCache:
    """Prefix caching: install a precomputed prefix KV ((L, 1, Hkv, ...)
    templates from ``engine_prefill_slot`` on a one-slot cache) into slot
    ``slot_idx`` and set its length, so admission prefills only the rest."""
    cache.k[:, slot_idx:slot_idx + 1] = k_template
    cache.v[:, slot_idx:slot_idx + 1] = v_template
    cache.lengths[slot_idx] = prefix_len
    return cache


def _decode_block_batched(ecfg: EngineConfig, layer, x: Tensor, k_cache: Tensor,
                          v_cache: Tensor, lengths: Tensor, pos_cos: Tensor,
                          pos_sin: Tensor) -> Tensor:
    """One decoder block for one decode token per slot: x (B, 1, D), caches
    (B, Hkv, ...) written in place, lengths (B,) on the device; each slot
    appends at its own offset and attends over its own length."""
    cfg = ecfg.cfg
    b = x.shape[0]
    dh, h, hk = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads

    fused = _use_fused_rows(ecfg, layer, b, 1)
    qkv = _qkv_rows(ecfg, layer, x, fused)
    q, k, v = torch.split(qkv, [h * dh, hk * dh, hk * dh], dim=-1)
    q = q.reshape(b, 1, h, dh).transpose(1, 2)
    k = k.reshape(b, 1, hk, dh).transpose(1, 2)
    v = v.reshape(b, 1, hk, dh).transpose(1, 2)
    cos, sin = pos_cos[:, None], pos_sin[:, None]  # per-slot positions
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    q_s8 = _requant(q, layer.q_scale)[:, :, 0, :].contiguous()

    # per-slot append; the index is clamped to the cache as JAX's
    # dynamic_update_slice clamps it
    lengths = lengths.long()
    bi = torch.arange(b, device=x.device)
    pos = torch.clamp(lengths, max=k_cache.shape[-1] - 1)
    if ecfg.kv_bits == 4:
        k_cache[bi, :, :, pos] = pack_nibbles(quantize_kv4(k, layer.k_scale))[:, :, 0, :]
        v_cache[bi, :, pos, :] = pack_nibbles(quantize_kv4(v, layer.v_scale))[:, :, 0, :]
        ctx = int8_decode_attention_xla(
            q_s8, unpack_nibbles(k_cache, axis=2), unpack_nibbles(v_cache, axis=-1),
            lengths + 1, layer.q_scale, kv4_scale(layer.k_scale), kv4_scale(layer.v_scale),
        ).reshape(b, 1, h * dh)
        return _block_tail(ecfg, layer, x, ctx, fused)
    k_cache[bi, :, :, pos] = _requant(k, layer.k_scale)[:, :, 0, :]
    v_cache[bi, :, pos, :] = _requant(v, layer.v_scale)[:, :, 0, :]

    smax = k_cache.shape[-1]
    chunk = ecfg.decode_attn_chunk
    if chunk < 0:  # AUTO, as the engine's dispatch
        chunk = auto_decode_chunk(smax)
    if chunk and smax > chunk:
        ctx = int8_decode_attention_chunked(q_s8, k_cache, v_cache, lengths + 1, layer.q_scale,
                                            layer.k_scale, layer.v_scale, chunk=chunk,
                                            quant_pv=ecfg.quant_pv)
    else:
        ctx = int8_decode_attention(q_s8, k_cache, v_cache, lengths + 1, layer.q_scale,
                                    layer.k_scale, layer.v_scale, quant_pv=ecfg.quant_pv)
    return _block_tail(ecfg, layer, x, ctx.reshape(b, 1, h * dh), fused)


def engine_decode_batched(ecfg: EngineConfig, params: EngineParams, tokens: Tensor,
                          cache: BatchedKVCache,
                          active: Optional[Tensor] = None) -> Tuple[Tensor, BatchedKVCache]:
    """One decode step for every slot -> (logits (B, V), cache); only the
    ``active`` (B,) bool slots advance their length (all when None)."""
    cfg = ecfg.cfg
    x = _embed(params, tokens[:, None])
    pos_cos, pos_sin = rope_cos_sin(cache.lengths, cfg.head_dim, cfg.rope_theta)
    pos_cos, pos_sin = pos_cos[:, None], pos_sin[:, None]  # (B, 1, Dh)
    for li, layer in enumerate(params.layer_list):
        x = _decode_block_batched(ecfg, layer, x, cache.k[li], cache.v[li], cache.lengths,
                                  pos_cos, pos_sin)
    x = rms_norm(x, params.norm_weight.to(x.dtype), cfg.rms_norm_eps)
    logits = torch.matmul(x[:, 0], params.lm_head.to(x.dtype).t())
    cache.lengths.add_(1 if active is None else active.to(torch.int32))
    return logits, cache


def engine_decode_multi(ecfg: EngineConfig, params: EngineParams, tokens: Tensor,
                        cache: BatchedKVCache, active: Tensor,
                        steps: int) -> Tuple[Tensor, BatchedKVCache]:
    """``steps`` greedy decode steps for every active slot -> (tokens (steps,
    B), cache); inactive slots carry their input token through.  Tokens
    after a slot's EOS are discarded by the scheduler."""
    toks = []
    t = tokens
    for _ in range(steps):
        logits, cache = engine_decode_batched(ecfg, params, t, cache, active)
        t = torch.where(active, torch.argmax(logits, dim=-1).to(torch.int32), t)
        toks.append(t)
    return torch.stack(toks), cache


def _verify_block_batched(ecfg: EngineConfig, layer, x: Tensor, k_cache: Tensor,
                          v_cache: Tensor, lengths: Tensor, pos_cos: Tensor,
                          pos_sin: Tensor) -> Tensor:
    """One decoder block for a K+1-token verification window per slot: x (B,
    K1, D), caches (B, Hkv, ...) written in place at each slot's offset,
    lengths (B,) on the device.  Query i of a slot attends its history and
    window tokens 0..i.  The projections and the tail are the engine's own
    (``_qkv_rows``, ``_block_tail``), so verification rounds as the engine
    does; the attention is plain, as JAX's."""
    cfg = ecfg.cfg
    b, k1, _ = x.shape
    dh, h, hk = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads

    fused = _use_fused_rows(ecfg, layer, b, k1)
    qkv = _qkv_rows(ecfg, layer, x, fused)
    q, k, v = torch.split(qkv, [h * dh, hk * dh, hk * dh], dim=-1)
    q = q.reshape(b, k1, h, dh).transpose(1, 2)
    k = k.reshape(b, k1, hk, dh).transpose(1, 2)
    v = v.reshape(b, k1, hk, dh).transpose(1, 2)
    cos, sin = pos_cos[:, None], pos_sin[:, None]  # (B, 1, K1, Dh)
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    q_s8 = _requant(q, layer.q_scale)

    # per-slot append of the window, its start clamped to the cache as JAX's
    # dynamic_update_slice clamps it
    smax = k_cache.shape[-1]
    lengths = lengths.long()
    bi = torch.arange(b, device=x.device)[:, None]
    pos = torch.clamp(lengths, max=smax - k1)[:, None] + torch.arange(k1, device=x.device)
    if ecfg.kv_bits == 4:
        k_cache[bi, :, :, pos] = pack_nibbles(quantize_kv4(k, layer.k_scale)).transpose(1, 2)
        v_cache[bi, :, pos, :] = pack_nibbles(quantize_kv4(v, layer.v_scale)).transpose(1, 2)
        kt_att, v_att = unpack_nibbles(k_cache, axis=2), unpack_nibbles(v_cache, axis=-1)
        k_eff, v_eff = kv4_scale(layer.k_scale), kv4_scale(layer.v_scale)
    else:
        k_cache[bi, :, :, pos] = _requant(k, layer.k_scale).transpose(1, 2)
        v_cache[bi, :, pos, :] = _requant(v, layer.v_scale).transpose(1, 2)
        kt_att, v_att = k_cache, v_cache
        k_eff, v_eff = layer.k_scale, layer.v_scale

    ctx = verify_attention(q_s8, kt_att, v_att, lengths, layer.q_scale, k_eff, v_eff,
                           quant_pv=ecfg.quant_pv and ecfg.kv_bits == 8)
    return _block_tail(ecfg, layer, x, ctx, fused)


def verify_attention(q_s8: Tensor, kt: Tensor, v: Tensor, lengths: Tensor, q_scale: Tensor,
                     k_scale: Tensor, v_scale: Tensor, quant_pv: bool) -> Tensor:
    """Plain attention of a verification window: q_s8 (B, H, K1, Dh) int8
    over the unpacked int8 caches kt (B, Hkv, Dh, Smax) and v (B, Hkv, Smax,
    Dh); query i of slot b attends positions <= lengths[b] + i.  With
    ``quant_pv`` the decode kernels' INT8 p @ V (exp weights coded against
    the global row max), so accepted drafts reproduce a decode step's
    arithmetic; else fp p @ V.  -> ctx (B, K1, H * Dh) f32."""
    b, h, k1, dh = q_s8.shape
    hk, smax = kt.shape[1], kt.shape[-1]
    dev = q_s8.device
    scores = _attention_scores(q_s8.reshape(b, hk, (h // hk) * k1, dh), kt, q_scale, k_scale,
                               dh).reshape(b, hk, h // hk, k1, smax)
    qpos = lengths[:, None] + torch.arange(k1, device=dev)  # (B, K1)
    ok = torch.arange(smax, device=dev)[None, None, :] <= qpos[:, :, None]  # (B, K1, Smax)
    scores = torch.where(ok[:, None, None], scores, f32(NEG, dev))
    if quant_pv:
        m = torch.amax(scores, dim=-1, keepdim=True)
        e = torch.exp(scores - m)
        denom = torch.sum(e, dim=-1, keepdim=True)
        acc = int_matmul(_quantize_exp(e), v[:, :, None])
        ctx = acc.to(torch.float32) * ((v_scale / f32(127.0, dev)) / denom)
    else:  # INT4 KV keeps fp p @ V everywhere
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs, (v.to(torch.float32) * v_scale)[:, :, None])
    return ctx.permute(0, 3, 1, 2, 4).reshape(b, k1, h * dh)


def engine_verify_batched(ecfg: EngineConfig, params: EngineParams, tokens: Tensor,
                          cache: BatchedKVCache) -> Tuple[Tensor, BatchedKVCache]:
    """Speculative verification for every slot: tokens (B, K1) = [pending
    token, K drafts] per slot -> (logits (B, K1, V), cache with the window's
    K/V written at each slot's offset and the lengths unchanged: the caller
    sets them after acceptance; entries past a slot's length are masked and
    later overwritten)."""
    cfg = ecfg.cfg
    b, k1 = tokens.shape
    x = _embed(params, tokens)
    positions = cache.lengths.long()[:, None] + torch.arange(k1, device=x.device)
    pos_cos, pos_sin = rope_cos_sin(positions.reshape(-1), cfg.head_dim, cfg.rope_theta)
    pos_cos, pos_sin = pos_cos.reshape(b, k1, -1), pos_sin.reshape(b, k1, -1)
    for li, layer in enumerate(params.layer_list):
        x = _verify_block_batched(ecfg, layer, x, cache.k[li], cache.v[li], cache.lengths,
                                  pos_cos, pos_sin)
    x = rms_norm(x, params.norm_weight.to(x.dtype), cfg.rms_norm_eps)
    return torch.matmul(x, params.lm_head.to(x.dtype).t()), cache


def engine_spec_decode_multi(ecfg: EngineConfig, params: EngineParams, bufs: Tensor,
                             buf_lens: Tensor, tokens: Tensor, cache: BatchedKVCache,
                             active: Tensor, steps: int, spec_k: int = 4, max_ngram: int = 3):
    """``steps`` speculative steps for every active slot, queued on the device
    with no host read: per-slot prompt-lookup drafts (``ngram_rows``), one
    batched verification, acceptance and the append to each slot's token
    buffer (bufs (B, L) int32, prompt + emitted with the pending token
    last, first buf_lens (B,) valid).

    Returns (bufs, buf_lens, tokens, cache, outs (steps, B, K+1), n_outs
    (steps, B)).  Inactive slots never advance.  Tokens past a finish are
    discarded by the scheduler, which guarantees room for the worst case
    steps * (K+1)."""
    from dgq_tpu_torch.serving.speculative import accept, ngram_rows, write_rows

    outs, n_outs = [], []
    for _ in range(steps):
        drafts = ngram_rows(bufs, buf_lens, spec_k, max_ngram)
        logits, cache = engine_verify_batched(
            ecfg, params, torch.cat([tokens[:, None], drafts], dim=1), cache)
        out, n_acc, corr = accept(drafts, torch.argmax(logits, dim=-1).to(torch.int32))
        n_out = torch.where(active, n_acc + 1, 0).to(torch.int32)
        bufs = torch.where(active[:, None], write_rows(bufs, out, buf_lens), bufs)
        buf_lens = buf_lens + n_out
        tokens = torch.where(active, corr, tokens)
        # the window left the lengths alone: active slots advance by the
        # consumed prefix (the pending token and the accepted drafts)
        cache = cache._replace(lengths=cache.lengths + torch.where(active, n_acc + 1, 0).to(
            torch.int32))
        outs.append(out)
        n_outs.append(n_out)
    return bufs, buf_lens, tokens, cache, torch.stack(outs), torch.stack(n_outs)
