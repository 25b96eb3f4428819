"""Perplexity through the real-quant INT8 engines.

Port of ``ppl_eval_engine`` (``dgq_tpu/utils/evalutils.py:162-216``), the
paper's perplexity loop: the stream is cut into windows of ``seqlen`` tokens,
each window is one prefill of a fresh cache, and the prefill logits score
every next token.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def ppl_eval_engine(ecfg, params, token_stream, seqlen: int = 2048, *, mesh=None,
                    max_samples: Optional[int] = None, verbose: bool = False,
                    forward_fn=None, init_cache_fn=None) -> float:
    """Perplexity of ``token_stream`` under the engine, on the device of the
    parameters.  Defaults to the LLaMA engine; pass
    ``forward_fn(ecfg, params, ids, cache)`` and
    ``init_cache_fn(cfg, batch, max_len, device=...)`` for another family,
    e.g. ``opt_engine_forward`` and ``init_opt_kv_cache``."""
    if mesh is not None:
        raise NotImplementedError("the sharded engine (mesh) is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")
    from dgq_tpu_torch.models.engine import engine_forward, init_kv_cache

    forward_fn = forward_fn or engine_forward
    init_cache_fn = init_cache_fn or init_kv_cache
    dev = params.embed_tokens.device
    tokens = np.asarray(token_stream).reshape(-1)
    nsamples = len(tokens) // seqlen
    if max_samples is not None:
        nsamples = min(nsamples, max_samples)

    nlls = []
    for i in range(nsamples):
        batch = torch.from_numpy(tokens[i * seqlen:(i + 1) * seqlen][None].astype(np.int32)).to(dev)
        cache = init_cache_fn(ecfg.cfg, 1, seqlen, device=dev)
        logits, _ = forward_fn(ecfg, params, batch, cache)
        logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, batch[:, 1:, None].long())
        nlls.append(float(torch.mean(nll)) * seqlen)
        if verbose:
            print(f"[ppl-engine] window {i + 1}/{nsamples}: "
                  f"{np.exp(np.sum(nlls) / ((i + 1) * seqlen)):.4f}")
    return float(np.exp(np.sum(nlls) / (nsamples * seqlen)))
