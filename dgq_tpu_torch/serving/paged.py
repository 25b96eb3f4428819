"""Paged KV cache serving (vLLM-style) on one GPU.

Port of ``dgq_tpu/serving/paged.py``.  KV lives in fixed-size pages (default
128 tokens) shared by all slots; a per-slot page table maps logical pages to
pool pages, so memory scales with tokens in flight, not slots x max_len, and
a registered prompt prefix is shared: admitted slots point their tables at
the prefix's pool pages (refcounted on the host) and copy only a partial
tail page.

  * The page table is a (B, NP) int32 tensor handed to every decode step;
    the decode attention is K8 (``ops/attention.int8_paged_decode_attention``)
    on INT8 pages, or K11 (``int4_paged_decode_attention``) on the INT4
    nibble pages of ``kv_bits=4`` (half the bytes per token), which read
    each slot's pages through it on the device.
  * Pool page 0 is the reserved null page: unallocated table entries and
    inactive slots read and write it harmlessly (reads are masked by length).
  * Page allocation, freeing and refcounts live on the host in
    ``PagedBatcher``; the device state is the pool and the per-slot lengths.
  * As in the port's engine, the pool is written in place (JAX returns new
    arrays); every function returns the cache it was given.

Prefill runs the engine's own block stack (``models/engine._block``) on a
dense scratch and page-ifies the result, so its numerics are the engine's.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dgq_tpu_torch.models.engine import (
    EngineConfig,
    EngineParams,
    _block,
    _block_tail,
    _qkv_rows,
    _requant,
    _use_fused_rows,
    kv_head_bytes,
)
from dgq_tpu_torch.models.llama import rms_norm, rope_cos_sin, rotate_half
from dgq_tpu_torch.ops.attention import int4_paged_decode_attention, int8_paged_decode_attention
from dgq_tpu_torch.ops.kv4 import kv4_scale, pack_nibbles, quantize_kv4
from dgq_tpu_torch.serving.batch_engine import _causal_mask, _last_logits
from dgq_tpu_torch.serving.sampling import SamplingParams, sample_logits
from dgq_tpu_torch.serving.scheduler import _hit_stop

Tensor = torch.Tensor
NULL_PAGE = 0


class PagedKVCache(NamedTuple):
    """Device state of the paged pool.  The page table is not part of it:
    the host owns it (PagedBatcher) and passes it per call."""

    kt: Tensor  # (L, P, Hkv, Dh, ps) int8, K transposed within the page (Dh/2 under kv_bits=4)
    v: Tensor  # (L, P, Hkv, ps, Dh) int8 (Dh/2 under kv_bits=4)
    lengths: Tensor  # (B,) int32 per-slot token counts


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int = 128,
                     kv_bits: int = 8, device="cuda") -> PagedKVCache:
    """``num_pages`` includes the reserved null page 0; usable pages are
    1..num_pages-1.  ``kv_bits=4`` packs two codes per byte along Dh
    (``ops/kv4.py``)."""
    n, hk, dh = cfg.num_hidden_layers, cfg.num_key_value_heads, kv_head_bytes(cfg, kv_bits)
    return PagedKVCache(
        kt=torch.zeros((n, num_pages, hk, dh, page_size), dtype=torch.int8, device=device),
        v=torch.zeros((n, num_pages, hk, page_size, dh), dtype=torch.int8, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def paged_prefill(ecfg: EngineConfig, params: EngineParams, slot_idx: int, input_ids: Tensor,
                  prompt_len: int, pages: Sequence[int], cache: PagedKVCache,
                  write_slot: bool = True) -> Tuple[Tensor, PagedKVCache]:
    """Prefill a prompt from position 0 and write its K/V into ``pages``.

    ``input_ids`` (S,) with S a multiple of the page size; ``pages`` the S /
    ps distinct pool pages to fill.  Each layer runs the engine block on a
    dense (1, Hkv, Dh, S) scratch (Dh taken from the pool, so nibble pages
    get a packed scratch), which is then cut into pages.
    ``write_slot=False`` fills pages without touching any slot's length (the
    prefix template of register_prefix).  Returns the last prompt token's
    logits (V,)."""
    cfg = ecfg.cfg
    dev = params.embed_tokens.device
    s = input_ids.shape[0]
    _, _, hk, dh, ps = cache.kt.shape
    npg = s // ps
    x = params.embed_tokens[input_ids.to(dev).long()[None, :]].to(torch.float32)
    positions = torch.arange(s, device=dev)
    pos_cos, pos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    mask = _causal_mask(positions, s, prompt_len)
    k_scr = torch.empty((1, hk, dh, s), dtype=torch.int8, device=dev)  # fully written per layer
    v_scr = torch.empty((1, hk, s, dh), dtype=torch.int8, device=dev)
    pg = torch.as_tensor(list(pages), dtype=torch.long, device=dev)
    for li, layer in enumerate(params.layer_list):
        x = _block(ecfg, layer, x, k_scr, v_scr, 0, pos_cos, pos_sin, mask)
        cache.kt[li, pg] = k_scr[0].reshape(hk, dh, npg, ps).permute(2, 0, 1, 3)
        cache.v[li, pg] = v_scr[0].reshape(hk, npg, ps, dh).permute(1, 0, 2, 3)
    if write_slot:
        cache.lengths[slot_idx] = prompt_len
    return _last_logits(ecfg, params, x, prompt_len - 1), cache


def paged_prefill_chunk(ecfg: EngineConfig, params: EngineParams, slot_idx: int,
                        chunk_ids: Tensor, start: int, valid: int, table_row: Sequence[int],
                        cache: PagedKVCache) -> Tuple[Tensor, PagedKVCache]:
    """Prefill one chunk at position ``start`` of a slot whose earlier
    positions already live in pages (prefix-shared admission, chunked long
    prompts).

    Each layer gathers the slot's pages into a dense (1, Hkv, Dh, NP*ps)
    view, runs the engine block (which appends the chunk at ``start`` and
    attends over the dense view), and writes back the pages the chunk
    covers: the block changes only [start, start + C), so every other page
    (shared prefix pages among them) keeps its bytes, as JAX's write-back of
    all pages leaves them.  ``valid`` counts the real tokens of the chunk."""
    cfg = ecfg.cfg
    dev = params.embed_tokens.device
    c = chunk_ids.shape[0]
    _, _, hk, dh, ps = cache.kt.shape
    tr = torch.as_tensor(np.asarray(table_row), dtype=torch.long, device=dev)
    npg = tr.shape[0]
    smax = npg * ps
    x = params.embed_tokens[chunk_ids.to(dev).long()[None, :]].to(torch.float32)
    positions = start + torch.arange(c, device=dev)
    pos_cos, pos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    mask = _causal_mask(positions, smax)
    first, last = start // ps, (start + c - 1) // ps + 1
    for li, layer in enumerate(params.layer_list):
        kd = cache.kt[li, tr].permute(1, 2, 0, 3).reshape(1, hk, dh, smax)
        vd = cache.v[li, tr].permute(1, 0, 2, 3).reshape(1, hk, smax, dh)
        x = _block(ecfg, layer, x, kd, vd, start, pos_cos, pos_sin, mask)
        cache.kt[li, tr[first:last]] = kd[0].reshape(hk, dh, npg, ps)[:, :, first:last].permute(
            2, 0, 1, 3)
        cache.v[li, tr[first:last]] = vd[0].reshape(hk, npg, ps, dh)[:, first:last].permute(
            1, 0, 2, 3)
    cache.lengths[slot_idx] = start + valid
    return _last_logits(ecfg, params, x, valid - 1), cache


def _paged_decode_block(ecfg: EngineConfig, layer, x: Tensor, kt_pool: Tensor, v_pool: Tensor,
                        table: Tensor, lengths: Tensor, active: Tensor, pos_cos: Tensor,
                        pos_sin: Tensor) -> Tensor:
    """One decoder block, one decode token per slot, over the paged pool
    (written in place): the engine's decode block with a page append and K8,
    or with a nibble append and K11 under kv_bits=4 (fp p @ V: INT4 KV
    never takes quant_pv)."""
    cfg = ecfg.cfg
    b = x.shape[0]
    dh, h, hk = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    ps = kt_pool.shape[3]

    fused = _use_fused_rows(ecfg, layer, b, 1)
    qkv = _qkv_rows(ecfg, layer, x, fused)
    q, k, v = torch.split(qkv, [h * dh, hk * dh, hk * dh], dim=-1)
    q = q.reshape(b, 1, h, dh).transpose(1, 2)
    k = k.reshape(b, 1, hk, dh).transpose(1, 2)
    v = v.reshape(b, 1, hk, dh).transpose(1, 2)
    cos, sin = pos_cos[:, None], pos_sin[:, None]  # per-slot positions
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    q_s8 = _requant(q, layer.q_scale)

    # append: each slot writes its token at (page, offset); inactive slots
    # are pinned to the null page so a freed slot can never corrupt a page
    # that was reallocated to someone else (the index is clamped for them:
    # an inactive slot's length may point past its table)
    lengths = lengths.long()
    lp = torch.clamp(lengths // ps, max=table.shape[1] - 1)
    phys = torch.where(active, table[torch.arange(b, device=x.device), lp].long(), NULL_PAGE)
    off = lengths % ps
    if ecfg.kv_bits == 4:
        kt_pool[phys, :, :, off] = pack_nibbles(quantize_kv4(k, layer.k_scale))[:, :, 0, :]
        v_pool[phys, :, off, :] = pack_nibbles(quantize_kv4(v, layer.v_scale))[:, :, 0, :]
        ctx = int4_paged_decode_attention(
            q_s8[:, :, 0, :].contiguous(), kt_pool, v_pool, table, lengths + 1,
            layer.q_scale, kv4_scale(layer.k_scale), kv4_scale(layer.v_scale),
        ).reshape(b, 1, h * dh)
        return _block_tail(ecfg, layer, x, ctx, fused)
    kt_pool[phys, :, :, off] = _requant(k, layer.k_scale)[:, :, 0, :]
    v_pool[phys, :, off, :] = _requant(v, layer.v_scale)[:, :, 0, :]

    ctx = int8_paged_decode_attention(
        q_s8[:, :, 0, :].contiguous(), kt_pool, v_pool, table, lengths + 1,
        layer.q_scale, layer.k_scale, layer.v_scale, quant_pv=ecfg.quant_pv,
    ).reshape(b, 1, h * dh)
    return _block_tail(ecfg, layer, x, ctx, fused)


def paged_decode_batched(ecfg: EngineConfig, params: EngineParams, tokens: Tensor,
                         cache: PagedKVCache, table: Tensor,
                         active: Tensor) -> Tuple[Tensor, PagedKVCache]:
    """One decode step for every slot over the paged pool -> (logits (B, V),
    cache with the active slots' lengths advanced).  ``table`` (B, NP) int32
    and ``active`` (B,) bool on the device; the caller guarantees each active
    slot's table has a page for position lengths[slot]."""
    cfg = ecfg.cfg
    x = params.embed_tokens[tokens.long()[:, None]].to(torch.float32)
    pos_cos, pos_sin = rope_cos_sin(cache.lengths, cfg.head_dim, cfg.rope_theta)
    pos_cos, pos_sin = pos_cos[:, None], pos_sin[:, None]  # (B, 1, Dh)
    for li, layer in enumerate(params.layer_list):
        x = _paged_decode_block(ecfg, layer, x, cache.kt[li], cache.v[li], table, cache.lengths,
                                active, pos_cos, pos_sin)
    x = rms_norm(x, params.norm_weight.to(x.dtype), cfg.rms_norm_eps)
    logits = torch.matmul(x[:, 0], params.lm_head.to(x.dtype).t())
    cache.lengths.add_(active.to(torch.int32))
    return logits, cache


def paged_decode_multi(ecfg: EngineConfig, params: EngineParams, tokens: Tensor,
                       cache: PagedKVCache, table: Tensor, active: Tensor,
                       steps: int) -> Tuple[Tensor, PagedKVCache]:
    """``steps`` greedy decode steps -> (tokens (steps, B), cache).  The
    caller pre-allocates pages covering lengths..lengths+steps-1 per active
    slot."""
    toks = []
    t = tokens
    for _ in range(steps):
        logits, cache = paged_decode_batched(ecfg, params, t, cache, table, active)
        nt = torch.argmax(logits, dim=-1).to(torch.int32)
        t = torch.where(active, nt, t)
        toks.append(t)
    return torch.stack(toks), cache


def copy_page(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy pool page ``src`` -> ``dst`` across all layers (copy-on-write of
    a partial prefix tail page at admission)."""
    cache.kt[:, dst] = cache.kt[:, src]
    cache.v[:, dst] = cache.v[:, src]
    return cache


# -- host-side batcher --------------------------------------------------------


class PagedBatcher:
    """Continuous batching over the paged pool.

    ``add_request`` / ``step`` / ``run`` / ``cancel`` / ``metrics`` /
    ``register_prefix`` with page-pool semantics:

      * memory = ``num_pages`` x page bytes, independent of num_slots x
        max_len: size the pool to the expected tokens in flight;
      * registered prefixes are shared: admitted slots point at the prefix's
        pool pages (refcounted); only a partial tail page is copied;
      * pool exhaustion preempts the youngest slot (its request re-queues
        with its generated tokens and resumes by re-prefill: recompute
        preemption);
      * ``prefill_chunk`` (page-aligned) prefills long prompts one chunk per
        step, so decode of the other slots never stalls behind them;
      * a failing step rebuilds the pool from host history and retries, up
        to ``max_recoveries`` times.

    Decode runs 1 or ``decode_steps`` tokens per call.  The pages hold INT8
    or, under ``ecfg.kv_bits == 4``, INT4 nibbles.  Runs on the device of
    the parameters."""

    def __init__(self, ecfg: EngineConfig, params: EngineParams, *, num_slots: int = 8,
                 max_len: int = 2048, page_size: int = 128, num_pages: Optional[int] = None,
                 decode_steps: int = 1, mesh=None, fns=None, max_recoveries: int = 3,
                 prefill_chunk: int = 0):
        if mesh is not None or fns is not None:
            raise NotImplementedError("tensor- and pipeline-parallel paged serving (mesh, fns) is "
                                      "not ported yet (ROADMAP Queue 1 item 7)")
        if max_len % page_size != 0:
            raise ValueError(f"max_len {max_len} must be a multiple of page_size {page_size}")
        if prefill_chunk and prefill_chunk % page_size != 0:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be a multiple of "
                f"page_size {page_size} (chunk boundaries are page boundaries)")
        self.ecfg = ecfg
        self.params = params
        self.device = params.embed_tokens.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.ps = page_size
        self.np_per_slot = max_len // page_size
        # default pool: dense-equivalent capacity + the null page
        self.num_pages = num_pages if num_pages else 1 + num_slots * self.np_per_slot
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (null page + 1)")
        self.decode_steps = max(1, decode_steps)

        self.cache = self._new_cache()
        # host-side allocator state
        self.free: List[int] = list(range(self.num_pages - 1, 0, -1))  # stack; 0 reserved
        self.refs = np.zeros((self.num_pages,), np.int32)
        self.table = np.zeros((num_slots, self.np_per_slot), np.int32)
        self.n_pages = np.zeros((num_slots,), np.int32)  # allocated logical pages per slot
        # host mirror of cache.lengths: the scheduler never reads the device
        # tensor (a device round trip per read)
        self.lengths_h = np.zeros((num_slots,), np.int32)

        self.queue = deque()
        self.slots: List[Optional[object]] = [None] * num_slots
        self.next_tokens = np.zeros((num_slots,), np.int32)
        self.finished: List[object] = []
        self._finished_count = 0
        self._finished_tokens = 0
        self._prefix: Optional[list] = None
        self.prefix_hits = 0
        self.preemptions = 0
        self.prefill_chunk = prefill_chunk
        # slot -> in-progress chunked prefill {"padded", "pos", "n", "resume"}
        self.pending: dict = {}
        self.max_recoveries = max_recoveries
        self._recoveries = 0
        self._seed = 0
        self._gen: Optional[torch.Generator] = None
        self._lat = deque(maxlen=512)  # (ttft_s, e2e_s) samples
        self._t0 = time.time()

    @classmethod
    def from_checkpoint(cls, path: str, *, device="cuda", kv_bits: int = 8, **kw):
        """Serving startup straight from a ``save_engine`` checkpoint, with
        ``fp_scales`` taken from the stored group scales; ``kv_bits=4``
        serves on INT4 nibble pages."""
        from dgq_tpu_torch.utils.checkpoint import fp_scales_of, load_engine

        eng, cfg = load_engine(path, device=device)
        ecfg = EngineConfig(cfg=cfg, kv_bits=kv_bits, fp_scales=fp_scales_of(eng))
        return cls(ecfg, eng, **kw)

    def _new_cache(self) -> PagedKVCache:
        return init_paged_cache(self.ecfg.cfg, self.num_slots, self.num_pages, self.ps,
                                kv_bits=self.ecfg.kv_bits, device=self.device)

    def _dev(self, a: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- allocator ----------------------------------------------------------

    def _alloc(self, n: int) -> Optional[List[int]]:
        if len(self.free) < n:
            return None
        pages = [self.free.pop() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
        return pages

    def _release(self, pages) -> None:
        for p in pages:
            p = int(p)
            if p == NULL_PAGE:
                continue
            self.refs[p] -= 1
            assert self.refs[p] >= 0, f"page {p} refcount underflow"
            if self.refs[p] == 0:
                self.free.append(p)

    def _free_slot(self, slot: int) -> None:
        n = int(self.n_pages[slot])
        self._release(self.table[slot, :n])
        self.table[slot, :] = NULL_PAGE
        self.n_pages[slot] = 0
        self.slots[slot] = None

    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self.free)

    @property
    def kv_bytes_per_token(self) -> int:
        """Resident pool bytes per cached token (K + V, all layers):
        L * Hkv * Dh * 2 for INT8; kv_bits=4 halves it (nibble pages)."""
        n, _, hk, dh, _ = self.cache.kt.shape
        return int(2 * n * hk * dh)

    # -- public API ----------------------------------------------------------

    def check_request(self, req) -> None:
        """Raise ValueError for a request this batcher can never serve (reads
        no batcher state, so the server calls it without the batcher's
        lock)."""
        n = len(req.prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        padded = -(-n // self.ps) * self.ps
        if padded > self.max_len or n + 1 > self.max_len:
            raise ValueError(
                f"prompt of {n} tokens (padded {padded}) does not fit "
                f"max_len={self.max_len} (page_size={self.ps})")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    def add_request(self, req) -> None:
        self.check_request(req)
        if getattr(req, "t_submit", None) is None:
            req.t_submit = time.time()
        self.queue.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def cancel(self, uid: int) -> bool:
        """Cancel a request by uid (queued, mid-prefill, or decoding); its
        pages go back to the pool at once."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                return self._finish_cancelled(r)
        for s, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                self.pending.pop(s, None)
                self._free_slot(s)
                self.lengths_h[s] = 0
                return self._finish_cancelled(r)
        return False

    def _finish_cancelled(self, req) -> bool:
        req.cancelled = True
        self._finish_req(req)
        return True

    def _finish_req(self, req) -> None:
        """Single point for completion bookkeeping."""
        now = time.time()
        req.done = True
        if getattr(req, "t_first", None) is None and req.output_ids:
            req.t_first = now
        if getattr(req, "t_done", None) is None:
            req.t_done = now
        self.finished.append(req)
        self._finished_count += 1
        self._finished_tokens += len(req.output_ids)
        if getattr(req, "t_submit", None) is not None:
            self._lat.append((
                (req.t_first - req.t_submit) if req.t_first else None,
                req.t_done - req.t_submit,
            ))

    def register_prefix(self, prefix_ids) -> None:
        """Prefill ``prefix_ids`` once into pool pages; admitted prompts that
        start with it share those pages (full pages by reference, the
        partial tail page by copy)."""
        ids = np.asarray(prefix_ids, np.int32)
        if len(ids) == 0:
            raise ValueError("empty prefix")
        padded = -(-len(ids) // self.ps) * self.ps
        if len(ids) + 1 >= self.max_len or padded > self.max_len:
            raise ValueError(f"prefix of {len(ids)} tokens leaves no room in "
                             f"max_len={self.max_len}")
        npg = padded // self.ps
        pages = self._alloc(npg)
        if pages is None:
            raise RuntimeError(f"pool exhausted: prefix needs {npg} pages, {len(self.free)} free")
        buf = np.zeros((padded,), np.int32)
        buf[: len(ids)] = ids
        _, self.cache = paged_prefill(self.ecfg, self.params, 0, torch.from_numpy(buf), len(ids),
                                      pages, self.cache, write_slot=False)
        # the _alloc refcount of 1 is the registry's pin: it is never
        # released (no unregister), so prefix pages outlive every slot
        if self._prefix is None:
            self._prefix = []
        self._prefix.append({"ids": ids, "pages": pages, "len": len(ids)})
        self._prefix.sort(key=lambda d: -d["len"])

    def metrics(self) -> dict:
        now = time.time()
        gen = self._finished_tokens + sum(len(r.output_ids) for r in self.slots if r is not None)
        occ = sum(r is not None for r in self.slots)
        out = {
            "wall_s": round(now - self._t0, 3),
            "tokens_generated": gen,
            "tokens_per_s": round(gen / max(now - self._t0, 1e-9), 2),
            "requests_finished": self._finished_count,
            "requests_queued": len(self.queue),
            "slots_active": occ,
            "slot_occupancy": round(occ / self.num_slots, 3),
            "pages_total": self.num_pages - 1,
            "pages_in_use": self.pages_in_use(),
            "kv_bits": self.ecfg.kv_bits,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "tokens_per_hbm_gib": int((1 << 30) // self.kv_bytes_per_token),
            "page_utilization": round(self.pages_in_use() / (self.num_pages - 1), 3),
            "preemptions": self.preemptions,
            "prefills_pending": len(self.pending),
        }
        if self._lat:
            e2e = sorted(s[1] for s in self._lat)
            out["e2e_ms_p50"] = round(e2e[len(e2e) // 2] * 1e3, 1)
            out["e2e_ms_p95"] = round(e2e[min(len(e2e) - 1, int(len(e2e) * 0.95))] * 1e3, 1)
            ttft = sorted(s[0] for s in self._lat if s[0] is not None)
            if ttft:
                out["ttft_ms_p50"] = round(ttft[len(ttft) // 2] * 1e3, 1)
                out["ttft_ms_p95"] = round(ttft[min(len(ttft) - 1, int(len(ttft) * 0.95))] * 1e3,
                                           1)
        if self._prefix is not None:
            out["prefix_hits"] = self.prefix_hits
        return out

    def step(self) -> None:
        """One admit + decode pass.  A failing step is recovered: the pool is
        rebuilt, prefixes re-registered, every live slot re-prefilled from
        its request's host-side history, and the step retried; past
        ``max_recoveries`` the error propagates."""
        try:
            self._step_inner()
        except Exception:  # noqa: BLE001 - device errors are not typed
            self._recoveries += 1
            if self._recoveries > self.max_recoveries:
                raise
            self._recover()
            self._step_inner()

    def _step_inner(self) -> None:
        self._admit()
        self._advance_pending()
        if any(r is not None and s not in self.pending for s, r in enumerate(self.slots)):
            self._decode()

    def _recover(self) -> None:
        """Rebuild device state from host history: fresh pool and allocator,
        prefixes re-prefilled, every live slot re-admitted at its exact
        position (prompt + consumed tokens; the pending next token is on the
        host)."""
        for s_ in list(self.pending):
            req = self.slots[s_]
            self.slots[s_] = None
            self.queue.appendleft(req)
        self.pending.clear()
        live = [(s_, r) for s_, r in enumerate(self.slots) if r is not None]
        prefixes = [p["ids"] for p in (self._prefix or [])]
        self.cache = self._new_cache()
        self.free = list(range(self.num_pages - 1, 0, -1))
        self.refs[:] = 0
        self.table[:, :] = NULL_PAGE
        self.n_pages[:] = 0
        self.lengths_h[:] = 0
        self.slots = [None] * self.num_slots
        self._prefix = None
        for ids in prefixes:
            self.register_prefix(ids)
        for s_, req in live:
            assert req.output_ids, "live slot must have emitted a token"
            req._preempt_hist = np.concatenate([
                np.asarray(req.prompt_ids, np.int32),
                np.asarray(req.output_ids[:-1], np.int32),
            ])
            req._preempt_next = int(self.next_tokens[s_])
            if not self._admit_one(s_, req):
                # the pool cannot fit the resume right now: back to the queue
                self.queue.appendleft(req)

    def run(self) -> List[object]:
        while self.has_work:
            self.step()
        return self.finished

    # -- internals -----------------------------------------------------------

    def _match_prefix(self, p: np.ndarray):
        for pre in self._prefix or ():
            n = pre["len"]
            if len(p) > n and np.array_equal(p[:n], pre["ids"]):
                return pre
        return None

    def _admit(self) -> None:
        free_slots = [s for s in range(self.num_slots) if self.slots[s] is None]
        while free_slots and self.queue:
            req = self.queue[0]
            slot = free_slots[0]
            if not self._admit_one(slot, req):
                break  # pool exhausted: stop admitting, decode drains pages
            self.queue.popleft()
            free_slots.pop(0)

    def _admit_one(self, slot: int, req) -> bool:
        """Prefill ``req`` into ``slot``.  Returns False (leaving req queued)
        when the pool cannot supply the pages."""
        hist = np.asarray(req.prompt_ids, np.int32)
        resume_token = None
        if getattr(req, "_preempt_hist", None) is not None:
            hist = req._preempt_hist
            resume_token = req._preempt_next
        pre = None if resume_token is not None else self._match_prefix(hist)
        if pre is not None and self._admit_prefix(slot, req, pre):
            return True
        c = self.prefill_chunk
        if c and len(hist) > c and -(-len(hist) // c) * c <= self.max_len:
            # long prompt: one chunk per scheduler step (head-of-line bound),
            # pages allocated lazily per chunk in _advance_pending; re-pad to
            # a chunk multiple so every chunk holds >= 1 real token
            padded_c = np.zeros((-(-len(hist) // c) * c,), np.int32)
            padded_c[: len(hist)] = hist
            self.slots[slot] = req
            self.pending[slot] = {"padded": padded_c, "pos": 0, "n": len(hist),
                                  "resume": resume_token}
            return True
        padded = -(-len(hist) // self.ps) * self.ps
        npg = padded // self.ps
        pages = self._alloc(npg)
        if pages is None:
            return False
        buf = np.zeros((padded,), np.int32)
        buf[: len(hist)] = hist
        logits, self.cache = paged_prefill(self.ecfg, self.params, slot, torch.from_numpy(buf),
                                           len(hist), pages, self.cache)
        self.table[slot, :npg] = pages
        self.n_pages[slot] = npg
        self.slots[slot] = req
        self.lengths_h[slot] = len(hist)
        if resume_token is not None:
            req._preempt_hist = None
            req._preempt_next = None
            self.next_tokens[slot] = resume_token
        else:
            tok = self._pick_token(req, logits[None, :])
            req.output_ids.append(tok)
            self.next_tokens[slot] = tok
            self._maybe_finish(slot)
        return True

    def _admit_prefix(self, slot: int, req, pre) -> bool:
        """Admission under a registered prefix: share full pages, copy the
        partial tail page, prefill only the remainder."""
        n = pre["len"]
        full = n // self.ps  # whole shared pages
        tail_used = n % self.ps
        p = np.asarray(req.prompt_ids, np.int32)
        rem = p[n:]
        rem_padded = -(-len(rem) // self.ps) * self.ps
        # pages the slot needs beyond the shared ones: a copied tail page
        # (if partial) + pages covering the remainder beyond the tail
        tail_cap = (self.ps - tail_used) % self.ps
        over = max(0, len(rem) - tail_cap)
        n_new = (1 if tail_used else 0) + (-(-over // self.ps) if over else 0)
        total_lp = -(-(n + len(rem)) // self.ps)
        if total_lp > self.np_per_slot:
            return False  # does not fit a slot; the caller falls back
        new_pages = self._alloc(n_new) if n_new else []
        if new_pages is None:
            return False
        for i in range(full):  # share the full pages
            src = pre["pages"][i]
            self.table[slot, i] = src
            self.refs[src] += 1
        li = full
        if tail_used:
            dst = new_pages[0]
            self.cache = copy_page(self.cache, pre["pages"][full], dst)
            self.table[slot, li] = dst
            li += 1
        for pg in new_pages[(1 if tail_used else 0):]:
            self.table[slot, li] = pg
            li += 1
        self.n_pages[slot] = li
        # the remainder prefills at position n over the slot's paged view
        buf = np.zeros((rem_padded,), np.int32)
        buf[: len(rem)] = rem
        logits, self.cache = paged_prefill_chunk(self.ecfg, self.params, slot,
                                                 torch.from_numpy(buf), n, len(rem),
                                                 self.table[slot].copy(), self.cache)
        self.slots[slot] = req
        self.lengths_h[slot] = n + len(rem)
        tok = self._pick_token(req, logits[None, :])
        req.output_ids.append(tok)
        self.next_tokens[slot] = tok
        self.prefix_hits += 1
        self._maybe_finish(slot)
        return True

    def _advance_pending(self) -> None:
        """Advance one chunked prefill by one chunk (pages allocated for
        exactly that chunk)."""
        if not self.pending:
            return
        slot = next(iter(self.pending))
        st = self.pending[slot]
        req = self.slots[slot]
        c = self.prefill_chunk
        padded, pos = st["padded"], st["pos"]
        end = min(pos + c, len(padded))
        need_lp = -(-end // self.ps)  # logical pages covering [0, end)
        add = need_lp - int(self.n_pages[slot])
        if add > 0:
            pages = self._alloc(add)
            if pages is None:
                if not self._preempt_one(exclude=slot):
                    if not any(r is not None and s_ != slot for s_, r in enumerate(self.slots)):
                        raise RuntimeError(
                            f"pool of {self.num_pages - 1} pages cannot hold "
                            f"one {self.prefill_chunk}-token prefill chunk")
                    return  # wait for decode to drain pages
                pages = self._alloc(add)
                if pages is None:
                    return
            np_s = int(self.n_pages[slot])
            self.table[slot, np_s: np_s + add] = pages
            self.n_pages[slot] = np_s + add
        chunk = np.zeros((c,), np.int32)
        chunk[: end - pos] = padded[pos:end]
        valid = min(st["n"], end) - pos
        assert valid >= 1, (pos, end, st["n"])
        logits, self.cache = paged_prefill_chunk(self.ecfg, self.params, slot,
                                                 torch.from_numpy(chunk), pos, valid,
                                                 self.table[slot].copy(), self.cache)
        st["pos"] = end
        self.lengths_h[slot] = min(st["n"], end)  # == pos + valid
        if end >= len(padded):
            del self.pending[slot]
            if st["resume"] is not None:
                req._preempt_hist = None
                req._preempt_next = None
                self.next_tokens[slot] = st["resume"]
            else:
                tok = self._pick_token(req, logits[None, :])
                req.output_ids.append(tok)
                self.next_tokens[slot] = tok
                self._maybe_finish(slot)

    def _ensure_decode_pages(self, steps: int) -> bool:
        """Allocate pages so every active slot can append ``steps`` tokens.
        Preempts the youngest slot on exhaustion.  Returns False if nothing
        is active afterwards."""
        while True:
            lens = self.lengths_h
            need: List[Tuple[int, int]] = []  # (slot, pages to add)
            for s, r in enumerate(self.slots):
                if r is None or s in self.pending:
                    continue
                last_lp = (int(lens[s]) + steps - 1) // self.ps
                if last_lp >= self.np_per_slot:
                    continue  # the capacity finish triggers in _maybe_finish
                add = last_lp + 1 - int(self.n_pages[s])
                if add > 0:
                    need.append((s, add))
            total = sum(a for _, a in need)
            if total <= len(self.free):
                for s, add in need:
                    pages = self._alloc(add)
                    np_s = int(self.n_pages[s])
                    self.table[s, np_s: np_s + add] = pages
                    self.n_pages[s] = np_s + add
                return any(r is not None for r in self.slots)
            if not self._preempt_one():
                return any(r is not None for r in self.slots)

    def _preempt_one(self, exclude: int = -1) -> bool:
        """Evict the youngest active slot (fewest generated tokens): its pages
        free, its request re-queues carrying its generation so far and
        resumes by re-prefill.  Mid-chunked-prefill slots restart from
        scratch."""
        cands = [s for s, r in enumerate(self.slots) if r is not None and s != exclude]
        if not cands or (exclude < 0 and len(cands) <= 1):
            return False  # never preempt the last slot: it could not progress
        s = min(cands, key=lambda i: len(self.slots[i].output_ids))
        req = self.slots[s]
        req._preempt_hist = np.concatenate([
            np.asarray(req.prompt_ids, np.int32),
            np.asarray(req.output_ids[:-1], np.int32),
        ]) if req.output_ids else np.asarray(req.prompt_ids, np.int32)
        req._preempt_next = int(self.next_tokens[s]) if req.output_ids else None
        if req._preempt_next is None:
            req._preempt_hist = None
        self.pending.pop(s, None)
        self._free_slot(s)
        self.lengths_h[s] = 0
        self.cache.lengths[s] = 0
        self.queue.appendleft(req)
        self.preemptions += 1
        return True

    def _table_width(self) -> int:
        """Attention cost tracks allocated pages, not max_len: the table is
        cut to the widest slot, bucketed to a power of two (as JAX buckets
        it to bound its compiled programs)."""
        tw = 1
        peak = int(self.n_pages.max()) if len(self.n_pages) else 1
        while tw < peak:
            tw *= 2
        return min(tw, self.np_per_slot)

    def _decode(self) -> None:
        steps = self.decode_steps
        if steps > 1:
            active = [r for s, r in enumerate(self.slots)
                      if r is not None and s not in self.pending]
            lens = self.lengths_h
            if (
                self.pending
                or any(r.sampling is not None and not r.sampling.greedy for r in active)
                # every step's append position must stay < max_len
                or any(int(lens[s]) + steps >= self.max_len
                       for s, r in enumerate(self.slots) if r is not None)
            ):
                steps = 1
            elif self.queue and any(r.eos_token_id is not None or r.stop_sequences
                                    for r in active):
                # queued work + stop-capable requests: bound the admission
                # delay an early stop causes
                steps = min(steps, 4)
        if not self._ensure_decode_pages(steps):
            return
        active_mask = np.asarray([r is not None and s not in self.pending
                                  for s, r in enumerate(self.slots)])
        table_dev = self._dev(self.table[:, :self._table_width()])
        tokens = self._dev(self.next_tokens)
        active = self._dev(active_mask)
        if steps > 1:
            toks, self.cache = paged_decode_multi(self.ecfg, self.params, tokens, self.cache,
                                                  table_dev, active, steps)
            self.lengths_h += np.where(active_mask, steps, 0).astype(np.int32)
            toks = toks.cpu().numpy()  # (steps, B)
            for slot in range(self.num_slots):
                req = self.slots[slot]
                if req is None or slot in self.pending:
                    continue
                for i in range(steps):
                    if req.done:
                        break
                    tok = int(toks[i, slot])
                    req.output_ids.append(tok)
                    self.next_tokens[slot] = tok
                    self._maybe_finish(slot)
            return
        logits, self.cache = paged_decode_batched(self.ecfg, self.params, tokens, self.cache,
                                                  table_dev, active)
        self.lengths_h += active_mask.astype(np.int32)
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()
        for slot, req in enumerate(self.slots):
            if req is None or slot in self.pending:
                continue
            if req.sampling is None or req.sampling.greedy:
                tok = int(greedy[slot])
            else:
                tok = self._pick_token(req, logits[slot][None, :])
            req.output_ids.append(tok)
            self.next_tokens[slot] = tok
            self._maybe_finish(slot)

    def _pick_token(self, req, logits_row: Tensor) -> int:
        sp = req.sampling or SamplingParams()
        if sp.greedy:
            return int(torch.argmax(logits_row))
        if self._gen is None:
            self._gen = torch.Generator(device=logits_row.device).manual_seed(self._seed)
        return int(sample_logits(logits_row, sp, self._gen)[0])

    def _maybe_finish(self, slot: int) -> None:
        req = self.slots[slot]
        if req is None:
            return
        if getattr(req, "t_first", None) is None and req.output_ids:
            req.t_first = time.time()
        hit_eos = _hit_stop(req)
        hit_max = len(req.output_ids) >= req.max_new_tokens
        hit_cap = int(self.lengths_h[slot]) + 1 >= self.max_len
        if hit_eos or hit_max or hit_cap:
            self._finish_req(req)
            self._free_slot(slot)
            self.lengths_h[slot] = 0
            self.cache.lengths[slot] = 0
