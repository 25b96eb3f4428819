"""Speculative decoding: prompt-lookup (n-gram) or draft-model drafting with
exact greedy verification.

Port of ``dgq_tpu/serving/speculative.py``.  Every emitted token is the
greedy argmax of the model's verification forward, so the output is always
a valid greedy decode of the model.  It equals ``generate``'s tokens when
decode and verify round the same way (the plain paths the CPU tests run);
on the card an s = 1 decode step and an s = K+1 verify window take their
fp32 sums in other orders (K3 against plain attention, K4-K6 or K12 at
other row counts), so a near-tie argmax may flip; ``chip_smoke.py``
reports the first divergence.

Drafting is prompt lookup: the longest suffix n-gram of the sequence so far
is found earlier in it and the K tokens that followed become the draft
(``ngram_propose`` on the host, ``device_ngram_propose`` on the device), or
a draft model rolls K greedy tokens (``draft_model_propose``).  Verification
feeds [pending token, K drafts] through one ``window="decode"`` forward; the
cache length is rolled back to cover exactly the accepted prefix (entries
past it are masked by every attention path and overwritten later).

``spec_decode_scan`` runs a chunk of steps with drafting, verification,
acceptance and the token-buffer append all on the device: the cache length
stays a device tensor and nothing reads the host inside the chunk, so the
caller pays one host read per chunk (JAX's ``lax.scan`` becomes a Python
loop that only queues work).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from dgq_tpu_torch.models.engine import (
    EngineConfig,
    EngineParams,
    KVCache,
    engine_forward,
    init_kv_cache,
)

Tensor = torch.Tensor


def ngram_propose(history, k: int, *, max_ngram: int = 3, window: int = 4096) -> np.ndarray:
    """Draft ``k`` tokens by prompt lookup: the tokens that followed the most
    recent earlier occurrence of the longest suffix n-gram (n <= max_ngram),
    padded by repeating the last of them; with no match, the last token
    repeated (a degenerate draft that verification rejects)."""
    h = np.asarray(history, dtype=np.int64)[-window:]
    L = h.shape[0]
    for n in range(min(max_ngram, L - 1), 0, -1):
        suffix = h[L - n:]
        windows = np.lib.stride_tricks.sliding_window_view(h, n)  # (L-n+1, n)
        starts = np.nonzero((windows == suffix).all(axis=1))[0]
        starts = starts[starts + n < L]  # a continuation must exist
        if starts.size == 0:
            continue
        s = int(starts[-1])
        cont = h[s + n: s + n + k]
        out = np.empty(k, np.int32)
        out[: cont.shape[0]] = cont
        out[cont.shape[0]:] = int(cont[-1])
        return out
    return np.full(k, int(h[-1]), np.int32)


def ngram_rows(bufs: Tensor, lengths: Tensor, k: int, max_ngram: int = 3) -> Tensor:
    """``device_ngram_propose`` of every row of bufs (B, L) int32 with its
    length (B,): (B, k) int32 drafts, on the device, with no host read."""
    b, L = bufs.shape
    dev = bufs.device
    idx = torch.arange(L, device=dev)[None, :]
    lens = lengths.to(device=dev, dtype=torch.long).reshape(b, 1)
    best_p = torch.full((b, 1), -1, dtype=torch.long, device=dev)
    best_found = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    for n in range(max_ngram, 0, -1):  # the first (longest) match wins
        match = torch.ones((b, L), dtype=torch.bool, device=dev)
        for i in range(n):
            j = lens - n + i  # suffix token i; a negative index wraps, as JAX's
            s_i = torch.gather(bufs, 1, torch.where(j < 0, j + L, j))
            match &= torch.roll(bufs, -i, dims=1) == s_i  # position p tests buf[p + i]
        # a continuation must exist (p + n < length), which also excludes the
        # suffix's own occurrence
        match &= (idx + n) < lens
        p = torch.amax(torch.where(match, idx, -1), dim=1, keepdim=True)
        found = p >= 0
        best_p = torch.where(found & ~best_found, p + n, best_p)
        best_found |= found
    start = torch.where(best_found, best_p, lens - 1)
    # JAX's dynamic_slice clamps the start so that k tokens fit
    start = torch.clamp(start, 0, L - k)
    return torch.gather(bufs, 1, start + torch.arange(k, device=dev)[None, :])


def device_ngram_propose(buf: Tensor, length: Tensor, k: int, max_ngram: int = 3) -> Tensor:
    """The device mirror of ``ngram_propose`` over a fixed-capacity buffer
    (L,) int32 whose first ``length`` (0-d) tokens are valid -> (k,) int32.
    Tokens read past ``length`` are stale buffer contents: legal drafts
    that verification rejects or, where they equal the greedy token,
    rightly accepts."""
    return ngram_rows(buf[None, :], length.reshape(1), k, max_ngram)[0]


def accept(drafts: Tensor, greedy: Tensor):
    """Acceptance of K drafts (B, K) against the verify window's greedy
    tokens (B, K+1): (out (B, K+1) - the accepted drafts, the correction,
    then zeros -, n_acc (B,) int32, corr (B,) int32).  Draft i is accepted
    when it and every draft before it equal the model's token."""
    b, kd = drafts.shape
    match = (drafts == greedy[:, :-1]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    corr = torch.gather(greedy, 1, n_acc[:, None].long())[:, 0]
    pos = torch.arange(kd + 1, device=drafts.device)[None, :]
    drafts_pad = torch.nn.functional.pad(drafts, (0, 1))
    out = torch.where(pos < n_acc[:, None], drafts_pad,
                      torch.where(pos == n_acc[:, None], corr[:, None], 0))
    return out.to(torch.int32), n_acc, corr


def spec_verify_step(ecfg: EngineConfig, params: EngineParams, tok: Tensor, drafts: Tensor,
                     cache: KVCache, forward_fn=engine_forward):
    """One speculative step: feed [tok, drafts] (tok (1, 1), drafts (1, K))
    as a ``window="decode"`` window, accept the longest draft prefix the
    model agrees with, emit those and the model's correction.

    Returns (out (1, K+1) int32, first n_out valid; n_out (0-d); next_tok
    (1, 1); the cache, its length covering exactly the fed and accepted
    prefix, as a 0-d device tensor).  ``forward_fn`` is any family's engine
    forward (``opt_engine_forward`` too): forward(ecfg, params, ids, cache,
    window=) -> (logits, cache) over a cache whose entries past ``length``
    are masked and overwritten."""
    dev = params.embed_tokens.device
    tok, drafts = tok.to(dev, torch.int32), drafts.to(dev, torch.int32)
    ids = torch.cat([tok, drafts], dim=1)
    # window="decode": with quant_pv the K+1 window quantises p @ V as the
    # s == 1 decode step does, so accepted drafts reproduce decode's logits
    logits, cache2 = forward_fn(ecfg, params, ids, cache, window="decode")
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    out, n_acc, corr = accept(drafts, greedy)
    # roll back: tok and the accepted drafts are context; the rejected
    # drafts' K/V lie past the length, masked and later overwritten
    return out, n_acc[0] + 1, corr[:, None], cache2._replace(length=cache.length + 1 + n_acc[0])


def draft_model_propose(decfg, dparams, dcache, feed_toks, k: int, forward_fn=None):
    """Draft ``k`` tokens with a draft model: feed the tokens it has not
    eaten yet (``feed_toks``, the pending token last) as one decode-side
    window, then roll k-1 greedy single-token steps.  Returns (drafts (k,)
    int32 on the device, the draft cache advanced over feed_toks and
    drafts[:-1])."""
    forward_fn = forward_fn or engine_forward
    dev = dparams.embed_tokens.device
    ids = torch.as_tensor(list(feed_toks), dtype=torch.int32, device=dev)[None, :]
    # a mid-generation catch-up, not a prompt: declared a decode window, so a
    # self-draft equals the target's verify windows bit for bit
    logits, dcache = forward_fn(decfg, dparams, ids, dcache, window="decode")
    t = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
    drafts = [t[0, 0]]
    for _ in range(k - 1):
        logits, dcache = forward_fn(decfg, dparams, t, dcache)
        t = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        drafts.append(t[0, 0])
    return torch.stack(drafts), dcache


def write_rows(bufs: Tensor, rows: Tensor, starts: Tensor) -> Tensor:
    """bufs (B, L) with rows (B, W) written at per-row ``starts`` (B,), each
    start clamped so that the row fits, as JAX's dynamic_update_slice; a new
    tensor."""
    L, w = bufs.shape[1], rows.shape[1]
    first = torch.clamp(starts.to(torch.long), max=L - w)
    return bufs.scatter(1, first[:, None] + torch.arange(w, device=bufs.device)[None, :],
                        rows.to(bufs.dtype))


def spec_decode_scan(ecfg: EngineConfig, params: EngineParams, buf: Tensor, buf_len: Tensor,
                     tok: Tensor, cache: KVCache, steps: int, spec_k: int = 4,
                     max_ngram: int = 3, forward_fn=engine_forward):
    """``steps`` speculative steps queued on the device with no host read:
    drafting (``device_ngram_propose``), verification, acceptance and the
    append to the token buffer (L,) int32, whose first ``buf_len`` (0-d)
    tokens are prompt + emitted (the pending ``tok`` (1, 1) last).

    Returns (buf, buf_len, tok, cache, outs (steps, K+1), n_outs (steps,)),
    all on the device.  The caller guarantees capacity: buf_len + steps *
    (spec_k + 1) fits the buffer and the cache."""
    outs, n_outs = [], []
    for _ in range(steps):
        drafts = device_ngram_propose(buf, buf_len, spec_k, max_ngram)[None, :]
        out, n_out, tok, cache = spec_verify_step(ecfg, params, tok, drafts, cache,
                                                  forward_fn=forward_fn)
        # entries past n_out are scratch that the next step's append overwrites
        buf = write_rows(buf[None, :], out, buf_len.reshape(1))[0]
        buf_len = buf_len + n_out
        outs.append(out[0])
        n_outs.append(n_out)
    return buf, buf_len, tok, cache, torch.stack(outs), torch.stack(n_outs)


def generate_speculative(ecfg: EngineConfig, params: EngineParams, prompt_ids: Tensor,
                         max_new_tokens: int, max_len: int, *, spec_k: int = 4,
                         max_ngram: int = 3, ondevice: bool = False, chunk_steps: int = 8,
                         forward_fn=None, init_cache_fn=None,
                         draft=None) -> Tuple[Tensor, dict]:
    """Greedy generation of one sequence (prompt_ids (1, S)) with prompt-lookup
    speculative decoding -> ((1, max_new_tokens) int32 tokens, stats: steps,
    tokens, tokens_per_step).  Near the cache's end it falls back to plain
    single-token steps so that no window overruns ``max_len``.

    ``ondevice``: chunks of ``chunk_steps`` steps through
    ``spec_decode_scan``, one host read per chunk instead of one per step.
    ``draft=(draft_ecfg, draft_params)``: a draft model proposes (host loop
    only); its cache rolls back to the accepted prefix as the target's
    does, and a bad draft costs acceptance, never tokens.
    ``forward_fn``/``init_cache_fn`` (forward(ecfg, params, ids, cache,
    window=) and init(cfg, batch, max_len)) make it family-generic; they
    default to the LLaMA engine's on the parameters' device."""
    b, s = prompt_ids.shape
    if b != 1:
        raise ValueError("speculative generate is per sequence (the batcher serves B > 1)")
    if draft is not None and ondevice:
        raise ValueError("draft-model speculation is host-loop only (ondevice=False)")
    dev = params.embed_tokens.device
    forward_fn = forward_fn or engine_forward
    init_cache_fn = init_cache_fn or (lambda cfg, batch, n: init_kv_cache(
        cfg, batch, n, kv_bits=ecfg.kv_bits, device=dev))
    prompt_ids = prompt_ids.to(dev)
    cache = init_cache_fn(ecfg.cfg, b, max_len)
    logits, cache = forward_fn(ecfg, params, prompt_ids, cache)
    next_tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)  # (1, 1)
    first = int(next_tok[0, 0])
    history: List[int] = [int(t) for t in prompt_ids[0].tolist()] + [first]
    toks: List[int] = [first]
    steps = 0

    def plain_step():
        nonlocal logits, cache, next_tok
        logits, cache = forward_fn(ecfg, params, next_tok, cache)
        next_tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        toks.append(int(next_tok[0, 0]))
        history.append(toks[-1])

    if draft is not None:
        decfg, dparams = draft
        dcache = init_cache_fn(decfg.cfg, b, max_len)
        _, dcache = forward_fn(decfg, dparams, prompt_ids, dcache)  # the draft's prefill
        dvalid = s  # tokens the draft cache validly covers
        draft_unfed: List[int] = []  # consumed tokens the draft has not eaten
    if ondevice:
        buf = torch.zeros((max_len,), dtype=torch.int32, device=dev)
        buf[:len(history)] = torch.as_tensor(history, dtype=torch.int32, device=dev)
        buf_len = torch.tensor(len(history), dtype=torch.int32, device=dev)
        while len(toks) < max_new_tokens:
            worst = chunk_steps * (spec_k + 1)
            if s + len(toks) + worst + spec_k + 1 > max_len or len(toks) + 1 >= max_new_tokens:
                plain_step()  # the capacity edge, or one token left
                steps += 1
                continue
            buf, buf_len, next_tok, cache, outs, n_outs = spec_decode_scan(
                ecfg, params, buf, buf_len, next_tok, cache, chunk_steps, spec_k=spec_k,
                max_ngram=max_ngram, forward_fn=forward_fn)
            got = torch.cat([outs.flatten(), n_outs.to(torch.int32)]).cpu()  # one read a chunk
            outs_h, n_h = got[:outs.numel()].reshape(outs.shape), got[outs.numel():]
            for i in range(chunk_steps):
                toks.extend(int(t) for t in outs_h[i, :int(n_h[i])])
            # the pending token is not fed: the cache holds the rest
            cache = cache._replace(length=s + len(toks) - 1)
            steps += chunk_steps
        toks = toks[:max_new_tokens]
        return (torch.tensor(toks, dtype=torch.int32, device=dev)[None, :],
                {"steps": steps + 1, "tokens": len(toks),
                 "tokens_per_step": len(toks) / max(steps, 1)})
    while len(toks) < max_new_tokens:
        # tokens fed so far: s + len(toks) - 1; a step feeds up to spec_k + 1
        if s + len(toks) + spec_k + 1 > max_len or len(toks) + 1 >= max_new_tokens:
            if draft is not None:
                draft_unfed.append(int(next_tok[0, 0]))  # the draft never ate it
            plain_step()  # the capacity edge, or one token left
            steps += 1
            continue
        if draft is not None:
            feed = draft_unfed + [int(next_tok[0, 0])]
            dcache = dcache._replace(length=dvalid)
            d_toks, dcache = draft_model_propose(decfg, dparams, dcache, feed, spec_k,
                                                 forward_fn=forward_fn)
            drafts = d_toks[None, :]
        else:
            drafts = torch.from_numpy(ngram_propose(history, spec_k, max_ngram=max_ngram))[None]
        out, n_out, next_tok, cache = spec_verify_step(ecfg, params, next_tok, drafts, cache,
                                                       forward_fn=forward_fn)
        got = torch.cat([out[0], n_out.reshape(1).to(torch.int32)]).cpu()  # one read a step
        new = [int(t) for t in got[:int(got[-1])]]
        toks.extend(new)
        history.extend(new)
        cache = cache._replace(length=s + len(toks) - 1)
        steps += 1
        if draft is not None:
            # the draft cache holds feed + drafts[:-1]; its valid prefix now
            # runs through draft n_acc
            n_acc = len(new) - 1
            if n_acc < spec_k:
                dvalid += len(feed) + n_acc
                draft_unfed = []
            else:  # every draft accepted: the last one was never fed
                dvalid += len(feed) + spec_k - 1
                draft_unfed = [new[spec_k - 1]]
    toks = toks[:max_new_tokens]
    return (torch.tensor(toks, dtype=torch.int32, device=dev)[None, :],
            {"steps": steps + 1, "tokens": len(toks),
             "tokens_per_step": len(toks) / max(steps, 1)})
