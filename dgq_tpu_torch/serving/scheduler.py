"""Continuous batching scheduler over the dense slot cache.

Port of ``dgq_tpu/serving/scheduler.py``: ``Request``, its stop test and the
``ContinuousBatcher``.  A fixed pool of B cache slots: queued requests are
prefilled into free slots (one at a time, or ``admit_batch`` short ones in
one batched prefill; long prompts in ``prefill_chunk`` pieces, one per step;
prompts under a registered prefix from its cached KV), one batched decode
step (a multi-step window, or with ``spec_k`` a speculative verify step or
window) advances every active slot, and a finished request frees its slot
at once.

A host-side control loop around the device functions of
``serving/batch_engine.py``, or of another engine family's namespace handed
in as ``fns`` (``serving/opt_batch_engine.opt_serving_fns``,
``serving/family_batch_engine``'s).  Every scheduling decision reads the
host mirror ``lengths_h`` of the device lengths, never the device tensor.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from dgq_tpu_torch.models.engine import EngineConfig, EngineParams
from dgq_tpu_torch.serving.batch_engine import (
    copy_prefix_into_slot,
    engine_decode_batched,
    engine_decode_multi,
    engine_prefill_batched,
    engine_prefill_chunk,
    engine_prefill_slot,
    engine_spec_decode_multi,
    engine_verify_batched,
    init_batched_cache,
)
from dgq_tpu_torch.serving.sampling import SamplingParams, sample_logits
from dgq_tpu_torch.serving.speculative import ngram_propose


@dataclasses.dataclass
class Request:
    uid: int
    prompt_ids: np.ndarray  # (S,)
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    sampling: Optional[object] = None  # SamplingParams; None => greedy
    # multi-token stop sequences: generation finishes when the output ends
    # with any of them (the sequence itself stays in the output)
    stop_sequences: Optional[List[List[int]]] = None
    # filled in by the batcher:
    output_ids: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    # latency stamps (seconds, time.time()): submission, first emitted
    # token, completion - the basis of TTFT and e2e latency
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


def _hit_stop(req: Request) -> bool:
    """EOS token or any multi-token stop sequence at the output tail."""
    if not req.output_ids:
        return False
    if req.eos_token_id is not None and req.output_ids[-1] == req.eos_token_id:
        return True
    for seq in req.stop_sequences or ():
        n = len(seq)
        if n and len(req.output_ids) >= n and req.output_ids[-n:] == list(seq):
            return True
    return False


class ContinuousBatcher:
    """Continuous batching over a dense (slots x max_len) KV cache.

    ``prefill_chunk`` > 0 prefills prompts longer than the chunk one chunk
    per scheduler step, so a long prompt does not stall the other slots'
    decode.  ``admit_batch`` > 1 admits up to that many short queued prompts
    in one batched prefill.  ``decode_steps`` > 1 runs up to that many greedy
    steps per call (``engine_decode_multi``) while nothing is mid-prefill and
    every active request is greedy; cache capacity and queued stop-capable
    requests clamp the window, tokens past a finish are discarded, and a
    window that cannot finish any request is left unread so that the next
    window is queued on the device before the host reads this one.
    ``spec_k`` > 0 turns on prompt-lookup speculative decoding: a step feeds
    [pending token, K drafts] per slot through one batched verification
    (``engine_verify_batched``), or with ``decode_steps`` > 1 runs that many
    speculative steps on the device (``engine_spec_decode_multi``), while
    every active request is greedy and has room; otherwise the step is a
    plain one.  With ``spec_adaptive`` speculation suspends for
    ``spec_probe_every`` steps when the accepted tokens per verify step
    (an EWMA) fall below ``spec_cost_ratio``, a verify step's cost in plain
    steps.  A failing step rebuilds the cache from host history and
    retries, up to ``max_recoveries`` times.  The cache precision follows
    ``ecfg.kv_bits``.  ``fns`` makes the scheduler family-generic, as JAX's:
    a namespace of the device functions ``engine_prefill_slot``,
    ``engine_prefill_chunk``, ``engine_decode_batched``,
    ``engine_decode_multi``, ``copy_prefix_into_slot`` and
    ``init_batched_cache`` of another engine family (the batched prefill and
    the speculative functions only where it has them: keep ``admit_batch=1``
    and ``spec_k=0`` otherwise).  Runs on the device of the parameters."""

    def __init__(self, ecfg: EngineConfig, params: EngineParams, *, num_slots: int = 8,
                 max_len: int = 2048, prefill_pad: int = 128, prefill_chunk: int = 0,
                 admit_batch: int = 1, decode_steps: int = 1, spec_k: int = 0,
                 spec_max_ngram: int = 3, spec_adaptive: bool = True,
                 spec_cost_ratio: float = 1.35, spec_probe_every: int = 256,
                 max_recoveries: int = 3, mesh=None, fns=None):
        if mesh is not None:
            raise NotImplementedError("tensor- and pipeline-parallel serving (mesh) is not "
                                      "ported yet (ROADMAP Queue 1 item 7)")
        # the device functions' namespace: another family's, or (None) this
        # module's globals, looked up at each call (tests monkeypatch them)
        self._f = fns
        self.ecfg = ecfg
        self.params = params
        self.device = params.embed_tokens.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill_pad = prefill_pad
        self.prefill_chunk = prefill_chunk
        self.admit_batch = max(1, admit_batch)
        self.decode_steps = max(1, decode_steps)
        self.spec_k = max(0, spec_k)
        self.spec_max_ngram = spec_max_ngram
        self.spec_stats = {"steps": 0, "tokens": 0}
        self.spec_adaptive = spec_adaptive
        self.spec_cost_ratio = spec_cost_ratio
        self.spec_probe_every = max(1, spec_probe_every)
        self._spec_ewma: Optional[float] = None
        self._spec_ewma_n = 0
        self._spec_suspended = 0  # steps left in a suspension
        self._spec_suspensions = 0  # suspensions so far
        self.max_recoveries = max_recoveries
        self._recoveries = 0
        self.cache = self._new_cache()
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * num_slots
        # slot -> in-progress chunked prefill: {"padded", "pos"}
        self.pending: dict = {}
        self.next_tokens = np.zeros((num_slots,), np.int32)
        # host mirror of cache.lengths: every decision reads this, never the
        # device tensor (a device round trip per read); the host knows every
        # transition (prefill sets, decode advances the active slots)
        self.lengths_h = np.zeros((num_slots,), np.int32)
        # the last multi-step window's device tokens, left unread so that the
        # next window is queued before the host waits for this one
        self._inflight = None  # (toks (n, B), slot snapshot, n)
        # device next-token vector: chains window N's output into window N+1
        self._next_dev: Optional[torch.Tensor] = None
        self._next_dev_ok = False
        # per-dispatch-kind host time: kind -> [count, total_s]
        self.timings: dict = {}
        self.finished: List[Request] = []
        # cumulative counters for metrics(): ``finished`` may be drained by
        # a consumer (serving/server.py)
        self._finished_count = 0
        self._finished_tokens = 0
        self._prefix: Optional[list] = None
        self.prefix_hits = 0
        self._lat: Deque = deque(maxlen=512)  # (ttft_s, e2e_s) samples
        self._t0 = time.time()
        self._seed = 0
        self._gen: Optional[torch.Generator] = None

    @classmethod
    def from_checkpoint(cls, path: str, *, device="cuda", kv_bits: int = 8, **kw):
        """Serving startup straight from a ``save_engine`` checkpoint, with
        ``fp_scales`` taken from the stored group scales; ``kv_bits=4``
        serves on the packed INT4 cache."""
        from dgq_tpu_torch.utils.checkpoint import fp_scales_of, load_engine

        eng, cfg = load_engine(path, device=device)
        ecfg = EngineConfig(cfg=cfg, kv_bits=kv_bits, fp_scales=fp_scales_of(eng))
        return cls(ecfg, eng, **kw)

    def _fn(self, name: str):
        """Device function by name: from ``fns`` when given, else this
        module's global (late-bound, as JAX's)."""
        if self._f is not None:
            return getattr(self._f, name)
        return globals()[name]

    def _new_cache(self):
        return self._fn("init_batched_cache")(self.ecfg.cfg, self.num_slots, self.max_len,
                                              kv_bits=self.ecfg.kv_bits, device=self.device)

    def _t(self, kind: str, t0: float) -> None:
        """Add the host time since ``t0`` to ``kind``: dispatch:* queues
        device work, sync:* waits for device results."""
        c = self.timings.setdefault(kind, [0, 0.0])
        c[0] += 1
        c[1] += time.time() - t0

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        # a copy: the host arrays are mutated while queued work may read them
        return torch.from_numpy(np.array(a)).to(self.device)

    # -- public API ----------------------------------------------------------

    def check_request(self, req: Request) -> None:
        """Raise ValueError for a request this batcher can never serve (reads
        no batcher state, so the server calls it without the batcher's
        lock)."""
        n = len(req.prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        padded = -(-n // self.prefill_pad) * self.prefill_pad
        if padded > self.max_len or n + 1 > self.max_len:
            raise ValueError(f"prompt of {n} tokens (padded {padded}) does not fit "
                             f"max_len={self.max_len} (prefill_pad={self.prefill_pad})")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    def add_request(self, req: Request) -> None:
        # an unservable request is rejected here, not in the step loop (where
        # it would look like a device failure and be retried)
        self.check_request(req)
        if req.t_submit is None:
            req.t_submit = time.time()
        self.queue.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def _finish_req(self, req: Request) -> None:
        """Single point for completion bookkeeping."""
        now = time.time()
        req.done = True
        if req.t_first is None and req.output_ids:
            req.t_first = now
        if req.t_done is None:
            req.t_done = now
        self.finished.append(req)
        self._finished_count += 1
        self._finished_tokens += len(req.output_ids)
        if req.t_submit is not None:
            self._lat.append((
                (req.t_first - req.t_submit) if req.t_first else None,
                req.t_done - req.t_submit,
            ))

    def register_prefix(self, prefix_ids) -> None:
        """Prefill ``prefix_ids`` once into a one-slot template cache; every
        admitted prompt that starts with it installs the template and
        prefills only the rest.  Several prefixes may be registered;
        admission takes the longest match."""
        ids = np.asarray(prefix_ids, np.int32)
        if len(ids) == 0:
            raise ValueError("empty prefix")
        padded_len = -(-len(ids) // self.prefill_pad) * self.prefill_pad
        if len(ids) + 1 >= self.max_len or padded_len > self.max_len:
            raise ValueError(f"prefix of {len(ids)} tokens (padded {padded_len}) leaves no room "
                             f"in max_len={self.max_len}")
        tmp = self._fn("init_batched_cache")(self.ecfg.cfg, 1, self.max_len,
                                             kv_bits=self.ecfg.kv_bits, device=self.device)
        _, tmp = self._fn("engine_prefill_slot")(self.ecfg, self.params, 0,
                                     torch.from_numpy(self._pad_prompt(ids)), len(ids), tmp)
        if self._prefix is None:
            self._prefix = []
        self._prefix.append({"ids": ids, "k": tmp.k, "v": tmp.v, "len": len(ids)})
        self._prefix.sort(key=lambda d: -d["len"])  # longest first: the first match is best

    def _match_prefix(self, p: np.ndarray):
        for pre in self._prefix or ():
            n = pre["len"]
            if len(p) > n and np.array_equal(p[:n], pre["ids"]):
                return pre
        return None

    def _chunk_padded(self, prompt: np.ndarray) -> Optional[np.ndarray]:
        """The prompt re-padded to a multiple of ``prefill_chunk`` (every
        chunk holds a real token), or None where it should prefill whole."""
        c = self.prefill_chunk
        if not c or len(self._pad_prompt(prompt)) <= c:
            return None
        out = np.zeros((-(-len(prompt) // c) * c,), np.int32)
        out[:len(prompt)] = prompt
        return out

    def _try_prefix_admit(self, slot: int, req: Request) -> bool:
        """Admit ``req`` through the longest matching prefix template.  A
        device failure re-queues the request before re-raising."""
        if self._prefix is None:
            return False
        p = np.asarray(req.prompt_ids, np.int32)
        pre = self._match_prefix(p)
        if pre is None:
            return False
        n = pre["len"]
        rem = p[n:]
        padded = self._pad_prompt(rem)
        if n + len(padded) > self.max_len:
            return False  # the remainder's padding would overrun: the normal path
        try:
            self.cache = self._fn("copy_prefix_into_slot")(self.cache, slot, pre["k"], pre["v"], n)
            if self.prefill_chunk and len(padded) > self.prefill_chunk:
                # long remainder: the rest goes through the chunk machinery,
                # at absolute positions from the prefix length
                self.slots[slot] = req
                self.pending[slot] = {"padded": self._chunk_padded(p), "pos": n}
                self.lengths_h[slot] = n
                self.prefix_hits += 1
                return True
            logits, self.cache = self._fn("engine_prefill_chunk")(
                self.ecfg, self.params, slot, torch.from_numpy(padded), n, len(rem), self.cache)
            tok = self._pick_token(req, logits[None, :])
        except Exception:
            self.slots[slot] = None
            self.pending.pop(slot, None)
            self.queue.appendleft(req)
            raise
        req.output_ids.append(tok)
        self.slots[slot] = req
        self.next_tokens[slot] = tok
        self._next_dev_ok = False
        self.lengths_h[slot] = n + len(rem)
        self.prefix_hits += 1
        self._maybe_finish(slot)
        return True

    def cancel(self, uid: int) -> bool:
        """Cancel a request by uid, queued, mid chunked prefill or decoding:
        it finishes at once with ``cancelled=True`` and the tokens it has;
        its slot frees for the next admission.  False when the uid is
        unknown or already finished."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                return self._finish_cancelled(r)
        for s, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                self.slots[s] = None  # freed; the next admission prefills from 0
                self.pending.pop(s, None)
                return self._finish_cancelled(r)
        return False

    def _finish_cancelled(self, req: Request) -> bool:
        req.cancelled = True
        self._finish_req(req)
        return True

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
            "prefills_pending": len(self.pending),
            "recoveries": self._recoveries,
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
        if self.spec_k > 0:
            st = self.spec_stats
            out["spec_steps"] = st["steps"]
            out["spec_tokens"] = st["tokens"]
            out["spec_tokens_per_step"] = round(st["tokens"] / max(st["steps"], 1), 3)
            if self.spec_adaptive:
                out["spec_suspended_steps"] = self._spec_suspended
                out["spec_suspensions"] = self._spec_suspensions
                if self._spec_ewma is not None:
                    out["spec_rate_ewma"] = round(self._spec_ewma, 3)
        if self._prefix is not None:
            out["prefix_hits"] = self.prefix_hits
        if self.timings:
            out["dispatch_timings"] = {
                k: {"count": c, "total_s": round(s, 4), "avg_ms": round(s / max(c, 1) * 1e3, 3)}
                for k, (c, s) in sorted(self.timings.items())
            }
        return out

    def step(self) -> None:
        """Admit queued requests into free slots, advance at most one chunked
        prefill by one chunk, then one decode step or window for the fully
        prefilled slots.  A failing step is recovered: the cache is rebuilt,
        every live slot re-prefilled from its request's token history, and
        the step retried; past ``max_recoveries`` the error propagates."""
        try:
            self._step_inner()
        except Exception:  # noqa: BLE001 - device errors are not typed
            self._recoveries += 1
            if self._recoveries > self.max_recoveries:
                raise
            self._recover()
            self._step_inner()

    def _step_inner(self) -> None:
        if self._inflight is not None:
            fl, self._inflight = self._inflight, None
            self._process_window(*fl)
        self._admit()
        self._advance_pending()
        if any(r is not None and s not in self.pending for s, r in enumerate(self.slots)):
            spec_ok = self.spec_k > 0 and self._spec_paying()
            if spec_ok and self._can_decode_spec_multi():
                self._decode_spec_multi()
            elif spec_ok and self._can_decode_spec():
                self._decode_spec()
            else:
                n = self._multi_window_steps()
                if n > 1:
                    self._decode_multi(n)
                else:
                    self._decode_step()

    def _recover(self) -> None:
        """Rebuild device state from host history: a fresh cache holding,
        for every live slot, its prompt and every token decode has consumed
        (all generated tokens but the last, the pending next token).  Slots
        mid chunked prefill go back to the queue head; an unread window is
        dropped (its tokens were never emitted)."""
        self._inflight = None
        self._next_dev_ok = False
        self.lengths_h[:] = 0
        self.cache = self._new_cache()
        for slot in list(self.pending):
            req = self.slots[slot]
            self.slots[slot] = None
            self.queue.appendleft(req)
        self.pending.clear()
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            assert req.output_ids, "live non-pending slot must have a token"
            hist = np.concatenate([np.asarray(req.prompt_ids, np.int32),
                                   np.asarray(req.output_ids[:-1], np.int32)])
            _, self.cache = self._fn("engine_prefill_slot")(
                self.ecfg, self.params, slot, torch.from_numpy(self._pad_prompt(hist)), len(hist),
                self.cache)
            self.next_tokens[slot] = req.output_ids[-1]
            self.lengths_h[slot] = len(hist)

    def _multi_window_steps(self) -> int:
        """The largest safe multi-step window for this call (<= 1: a single
        step).  The fullest slot's cache room clamps it, to a power of two;
        a request reaching max_new mid-window costs only discarded tokens;
        stop-capable requests under queue pressure cap it at 4 steps, so an
        early stop delays an admission by at most 3."""
        if self.decode_steps <= 1 or self.pending:
            return 1
        active = [r for r in self.slots if r is not None]
        if any(r.sampling is not None and not r.sampling.greedy for r in active):
            return 1  # per-token host-side sampling
        occupied = [s for s, r in enumerate(self.slots) if r is not None]
        n = min(self.decode_steps,
                int(self.max_len - 1 - max(self.lengths_h[s] for s in occupied)))
        if self.queue and any(r.eos_token_id is not None or r.stop_sequences for r in active):
            n = min(n, 4)
        if n >= self.decode_steps:
            return self.decode_steps
        if n <= 1:
            return 1
        return 1 << (n.bit_length() - 1)

    # -- speculative decoding ------------------------------------------------

    def _queue_blocks_multi(self) -> bool:
        """Speculative windows keep JAX's conservative gate: queued work with
        a free slot, or a request that finishes inside the window, forces
        single speculative steps so that a freed slot is admitted at once."""
        if not self.queue:
            return False
        if any(s is None for s in self.slots):
            return True
        return any(r.max_new_tokens - len(r.output_ids) < self.decode_steps
                   for r in self.slots if r is not None)

    def _spec_active(self):
        """The active slots when speculation may run now: nothing mid-prefill,
        every active request greedy and wanting at least 2 more tokens; else
        None."""
        if self.spec_k <= 0 or self.pending:
            return None
        active = [(s, r) for s, r in enumerate(self.slots) if r is not None]
        if not active or any(r.sampling is not None and not r.sampling.greedy
                             for _, r in active):
            return None  # verification is greedy: a sampling slot opts the batch out
        if any(r.max_new_tokens - len(r.output_ids) < 2 for _, r in active):
            return None
        return active

    def _can_decode_spec_multi(self) -> bool:
        """``decode_steps`` speculative steps in one device call, when the
        worst case of every active slot, decode_steps * (K+1) tokens, fits."""
        if self.decode_steps <= 1 or self._queue_blocks_multi():
            return False
        active = self._spec_active()
        worst = self.decode_steps * (self.spec_k + 1)
        return active is not None and all(int(self.lengths_h[s]) + worst <= self.max_len
                                          for s, _ in active)

    def _can_decode_spec(self) -> bool:
        """One speculative step, when every active slot has room for its
        K+1-token window below the cache's end."""
        active = self._spec_active()
        return active is not None and all(
            int(self.lengths_h[s]) + self.spec_k + 1 < self.max_len for s, _ in active)

    def _spec_paying(self) -> bool:
        """The adaptive gate: False while suspended (one tick per step)."""
        if not self.spec_adaptive:
            return True
        if self._spec_suspended > 0:
            self._spec_suspended -= 1
            return False
        return True

    def _spec_note(self, tokens: int, steps: int) -> None:
        """Record a speculative call's yield; suspend speculation when the
        tokens-per-step EWMA no longer covers a verify step's cost."""
        if not self.spec_adaptive or steps <= 0:
            return
        rate = tokens / steps
        self._spec_ewma = rate if self._spec_ewma is None else 0.8 * self._spec_ewma + 0.2 * rate
        self._spec_ewma_n += steps
        if self._spec_ewma_n >= 8 and self._spec_ewma < self.spec_cost_ratio:
            self._spec_suspended = self.spec_probe_every
            self._spec_suspensions += 1
            self._spec_ewma = None
            self._spec_ewma_n = 0

    def _emit_spec(self, slot: int, tokens) -> bool:
        """Append one speculative step's tokens to a slot's request, stopping at
        its stop condition or max_new; True when it finished (the slot is
        then freed)."""
        req = self.slots[slot]
        self.spec_stats["steps"] += 1
        for tok in tokens:
            req.output_ids.append(int(tok))
            self.next_tokens[slot] = int(tok)
            self.spec_stats["tokens"] += 1
            if _hit_stop(req) or len(req.output_ids) >= req.max_new_tokens:
                self._finish_req(req)
                self.slots[slot] = None  # the next admission re-prefills from 0
                return True
        if req.t_first is None and req.output_ids:
            req.t_first = time.time()
        return False

    def _decode_spec(self) -> None:
        """One speculative step for every active slot: prompt-lookup drafts on
        the host, one batched verification, acceptance per slot."""
        k = self.spec_k
        ids = np.zeros((self.num_slots, k + 1), np.int32)
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            hist = np.concatenate([np.asarray(r.prompt_ids, np.int64),
                                   np.asarray(r.output_ids, np.int64)])
            ids[s, 0] = self.next_tokens[s]
            ids[s, 1:] = ngram_propose(hist, k, max_ngram=self.spec_max_ngram)
        t0 = time.time()
        logits, self.cache = self._fn("engine_verify_batched")(self.ecfg, self.params,
                                                               self._dev(ids), self.cache)
        self._t("dispatch:spec_verify", t0)
        self._next_dev_ok = False
        t0 = time.time()
        greedy = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()  # (B, K+1)
        self._t("sync:spec_verify", t0)
        tok0, step0 = self.spec_stats["tokens"], self.spec_stats["steps"]
        for s in range(self.num_slots):
            if self.slots[s] is None:
                continue
            n_acc = 0
            while n_acc < k and ids[s, 1 + n_acc] == greedy[s, n_acc]:
                n_acc += 1
            if not self._emit_spec(s, list(ids[s, 1:1 + n_acc]) + [greedy[s, n_acc]]):
                # the pending token and the accepted drafts were fed; the
                # correction is the new pending token
                self.lengths_h[s] += 1 + n_acc
        self._spec_note(self.spec_stats["tokens"] - tok0, self.spec_stats["steps"] - step0)
        self.cache = self.cache._replace(lengths=self._dev(self.lengths_h))

    def _decode_spec_multi(self) -> None:
        """decode_steps speculative steps in one call with one host read;
        tokens past a slot's finish are discarded (its cache advanced
        harmlessly: the next admission re-prefills from 0)."""
        k, n = self.spec_k, self.decode_steps
        bufs = np.zeros((self.num_slots, self.max_len), np.int32)
        lens = np.zeros((self.num_slots,), np.int32)
        active = np.zeros((self.num_slots,), bool)
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            hist = np.concatenate([np.asarray(r.prompt_ids, np.int32),
                                   np.asarray(r.output_ids, np.int32)])
            bufs[s, :len(hist)] = hist
            lens[s] = len(hist)
            active[s] = True
        tok0, step0 = self.spec_stats["tokens"], self.spec_stats["steps"]
        t0 = time.time()
        _, _, _, self.cache, outs, n_outs = self._fn("engine_spec_decode_multi")(
            self.ecfg, self.params, self._dev(bufs), self._dev(lens), self._dev(self.next_tokens),
            self.cache, self._dev(active), n, spec_k=k, max_ngram=self.spec_max_ngram)
        self._t("dispatch:spec_multi", t0)
        self._next_dev_ok = False
        t0 = time.time()
        got = torch.cat([outs.flatten(), n_outs.flatten()]).cpu().numpy()  # one read
        self._t("sync:spec_multi", t0)
        outs_h = got[:outs.numel()].reshape(tuple(outs.shape))  # (n, B, K+1)
        n_h = got[outs.numel():].reshape(tuple(n_outs.shape))  # (n, B)
        # the device advanced each active slot by its consumed prefix per step
        self.lengths_h += n_h.sum(axis=0).astype(np.int32)
        for s in range(self.num_slots):
            if self.slots[s] is None:
                continue
            for i in range(n):
                if self._emit_spec(s, outs_h[i, s, :int(n_h[i, s])]):
                    break
        self._spec_note(self.spec_stats["tokens"] - tok0, self.spec_stats["steps"] - step0)

    def run(self) -> List[Request]:
        while self.has_work:
            self.step()
        # an unread window can outlive has_work only when every one of its
        # requests was cancelled; its tokens are discarded
        self._inflight = None
        return self.finished

    # -- internals -----------------------------------------------------------

    def _pad_prompt(self, ids: np.ndarray) -> np.ndarray:
        pad = -(-len(ids) // self.prefill_pad) * self.prefill_pad
        out = np.zeros((pad,), np.int32)
        out[:len(ids)] = ids
        return out

    def _admit(self) -> None:
        free = [s for s in range(self.num_slots) if self.slots[s] is None]
        short: List[tuple] = []  # (slot, req, padded prompt)
        while free and self.queue:
            req = self.queue.popleft()
            slot = free.pop(0)
            if self._try_prefix_admit(slot, req):
                continue
            prompt = np.asarray(req.prompt_ids, np.int32)
            padded_c = self._chunk_padded(prompt)
            if padded_c is not None:  # long prompt: chunk by chunk across steps
                self.slots[slot] = req
                self.pending[slot] = {"padded": padded_c, "pos": 0}
                continue
            short.append((slot, req, self._pad_prompt(prompt)))
            if len(short) >= self.admit_batch:
                self._prefill_group(short)
                short = []
        if short:
            self._prefill_group(short)

    def _prefill_group(self, group: List[tuple]) -> None:
        """Prefill 1..admit_batch prompts: one slot alone, or one batched
        prefill.  On a failure the group's unserved requests go back to the
        queue head, so _recover sees a consistent picture."""
        try:
            self._prefill_group_inner(group)
        except Exception:
            for slot, req, _ in reversed(group):
                if req.done or req.output_ids:
                    continue  # fully processed before the error surfaced
                self.slots[slot] = None
                self.queue.appendleft(req)
            raise

    def _prefill_group_inner(self, group: List[tuple]) -> None:
        t0 = time.time()
        if len(group) == 1:
            slot, req, padded = group[0]
            logits, self.cache = self._fn("engine_prefill_slot")(
                self.ecfg, self.params, slot, torch.from_numpy(padded), len(req.prompt_ids),
                self.cache)
            rows = logits[None, :]
        else:
            s_max = max(len(p) for _, _, p in group)
            ids = np.zeros((len(group), s_max), np.int32)
            for i, (_, _, p) in enumerate(group):
                ids[i, :len(p)] = p
            rows, self.cache = self._fn("engine_prefill_batched")(
                self.ecfg, self.params, [s for s, _, _ in group], torch.from_numpy(ids),
                [len(r.prompt_ids) for _, r, _ in group], self.cache)
        self._t("dispatch:prefill", t0)
        self._next_dev_ok = False
        greedy_rows = None
        if all(r.sampling is None or r.sampling.greedy for _, r, _ in group):
            t0 = time.time()
            greedy_rows = torch.argmax(rows, dim=-1).cpu().numpy()  # one read for the group
            self._t("sync:prefill", t0)
        for i, (slot, req, _) in enumerate(group):
            tok = (int(greedy_rows[i]) if greedy_rows is not None
                   else self._pick_token(req, rows[i][None, :]))
            req.output_ids.append(tok)
            self.slots[slot] = req
            self.next_tokens[slot] = tok
            self.lengths_h[slot] = len(req.prompt_ids)
            self._maybe_finish(slot)

    def _advance_pending(self) -> None:
        """Advance one chunked prefill by one chunk."""
        if not self.pending:
            return
        slot = next(iter(self.pending))
        st = self.pending[slot]
        req = self.slots[slot]
        padded, pos = st["padded"], st["pos"]
        c = self.prefill_chunk
        chunk = np.zeros((c,), np.int32)
        end = min(pos + c, len(padded))
        chunk[:end - pos] = padded[pos:end]
        true_len = len(req.prompt_ids)
        valid = min(true_len, end) - pos
        assert valid >= 1, (pos, end, true_len)  # the walk stops at the prompt's end
        t0 = time.time()
        logits, self.cache = self._fn("engine_prefill_chunk")(
            self.ecfg, self.params, slot, torch.from_numpy(chunk), pos, valid, self.cache)
        self._t("dispatch:prefill_chunk", t0)
        st["pos"] = end
        self.lengths_h[slot] = pos + valid
        # a walk from a prefix length off the chunk grid can pass the prompt's
        # end before the padded end (JAX's goes on to an empty chunk and fails)
        if end >= min(len(padded), true_len):
            del self.pending[slot]
            tok = self._pick_token(req, logits[None, :])
            req.output_ids.append(tok)
            self.next_tokens[slot] = tok
            self._next_dev_ok = False
            self._maybe_finish(slot)

    def _decode_step(self) -> None:
        # mid-prefill slots neither advance nor emit until their last chunk
        active = np.asarray([r is not None and s not in self.pending
                             for s, r in enumerate(self.slots)])
        t0 = time.time()
        logits, self.cache = self._fn("engine_decode_batched")(
            self.ecfg, self.params, self._dev(self.next_tokens), self.cache, self._dev(active))
        self._t("dispatch:decode", t0)
        self._next_dev_ok = False
        self.lengths_h += active.astype(np.int32)
        t0 = time.time()
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()
        self._t("sync:decode", t0)
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

    def _next_tokens_dev(self) -> torch.Tensor:
        """The next-token vector on the device: the last window's output
        while nothing changed it on the host, else uploaded."""
        if self._next_dev_ok and self._next_dev is not None:
            return self._next_dev
        return self._dev(self.next_tokens)

    def _window_cannot_finish(self, n: int) -> bool:
        """True when no active request can finish inside an n-step window
        (no stop conditions, more than n tokens of headroom, cache room past
        it): only then may the window stay unread."""
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            if r.eos_token_id is not None or r.stop_sequences:
                return False
            if len(r.output_ids) + n >= r.max_new_tokens:
                return False
            if self.lengths_h[s] + 1 >= self.max_len:  # the mirror is already += n
                return False
        return True

    def _decode_multi(self, n: int) -> None:
        """n greedy steps in one call; the window stays unread when it cannot
        finish a request (the next step queues window N+1 on the device,
        chained through the device token vector, before reading window N)."""
        active_mask = np.asarray([r is not None for r in self.slots])
        t0 = time.time()
        toks, self.cache = self._fn("engine_decode_multi")(
            self.ecfg, self.params, self._next_tokens_dev(), self.cache, self._dev(active_mask), n)
        self._t("dispatch:decode_multi", t0)
        self.lengths_h += np.where(active_mask, n, 0).astype(np.int32)
        # inactive rows carry their token through: toks[-1] is the whole vector
        self._next_dev = toks[n - 1]
        self._next_dev_ok = True
        snapshot = list(self.slots)
        if self._window_cannot_finish(n):
            self._inflight = (toks, snapshot, n)
        else:
            self._process_window(toks, snapshot, n)

    def _process_window(self, toks_dev: torch.Tensor, snapshot, n: int) -> None:
        """Read one window's tokens and apply them in order; a request freed
        since the dispatch (cancel) is skipped by identity."""
        t0 = time.time()
        toks = toks_dev.cpu().numpy()  # (n, B)
        self._t("sync:decode_multi", t0)
        for slot, req in enumerate(snapshot):
            if req is None or req.done or self.slots[slot] is not req:
                continue
            for i in range(n):
                if req.done:
                    break
                tok = int(toks[i, slot])
                req.output_ids.append(tok)
                self.next_tokens[slot] = tok
                self._maybe_finish(slot)

    def _pick_token(self, req: Request, logits_row: torch.Tensor) -> int:
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
        if req.t_first is None and req.output_ids:
            req.t_first = time.time()
        hit_stop = _hit_stop(req)
        hit_max = len(req.output_ids) >= req.max_new_tokens
        hit_cap = int(self.lengths_h[slot]) + 1 >= self.max_len
        if hit_stop or hit_max or hit_cap:
            self._finish_req(req)
            self.slots[slot] = None  # the next admission overwrites the slot
