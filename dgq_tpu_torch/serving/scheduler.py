"""Serving requests: ``Request`` and its stop test.

Port of ``dgq_tpu/serving/scheduler.py:39-70``, the part the paged batcher
(``serving/paged.py``) and the server (``serving/server.py``) use.  The dense
``ContinuousBatcher`` of that module is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


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
