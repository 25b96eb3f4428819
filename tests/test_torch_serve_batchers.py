"""The dgq_tpu_torch serving daemon over its other batchers on the CPU: the
dense ContinuousBatcher (``serve`` without ``--paged``), with speculative
decoding (``--spec-k 2``), and the paged batcher on INT4 nibble pages
(``--paged --kv-bits 4``), each over a live localhost socket on a checkpoint
that dgq_tpu's save_engine wrote, against JAX's batcher on the same
checkpoint."""

import json
import socket

import numpy as np
import pytest
import torch

from dgq_tpu.models import engine as jeng
from dgq_tpu.models.llama import tiny_llama_config
from dgq_tpu.models.synthetic import build_llama_engine
from dgq_tpu.serving.paged import PagedBatcher as JPagedBatcher
from dgq_tpu.serving.scheduler import ContinuousBatcher as JBatcher
from dgq_tpu.serving.scheduler import Request as JRequest
from dgq_tpu.utils.checkpoint import save_engine
from dgq_tpu_torch import serve as tserve

CFG = tiny_llama_config(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2)
FLAGS = ["--cpu", "--port", "0", "--max-len", "64", "--slots", "2", "--metrics-interval", "0"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the test workers share the
    CPU cores, and torch's spinning thread pools oversubscribe them (the
    port's CPU paths ran ~10x slower beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    eng = build_llama_engine(CFG, seed=0)
    path = str(tmp_path_factory.mktemp("serve") / "eng.safetensors")
    save_engine(path, eng, CFG, arch="llama")
    return path, eng


def _send(sock, obj):
    sock.sendall((json.dumps(obj) + "\n").encode())


def _round_trip(srv, prompts, max_new):
    """Pipeline every request (the second streams) over one connection;
    returns {uid: output_ids}, the streamed deltas and the metrics op."""
    with socket.create_connection((srv.host, srv.port), timeout=120) as s:
        f = s.makefile("r")
        for i, p in enumerate(prompts):
            _send(s, {"prompt_ids": p.tolist(), "max_new_tokens": max_new, "stream": i == 1})
        finals, streamed = {}, {}
        while len(finals) < len(prompts):
            msg = json.loads(f.readline())
            streamed.setdefault(msg["uid"], []).extend(msg.get("token_ids", []))
            if msg["done"]:
                finals[msg["uid"]] = msg["output_ids"]
        _send(s, {"op": "metrics"})
        return finals, streamed, json.loads(f.readline())


@pytest.mark.parametrize("mode", ["dense", "dense_spec", "paged_kv4"])
def test_server_round_trip_matches_jax(ckpt, mode):
    """Served tokens equal JAX's batcher of the same kind on the same
    checkpoint: the dense ContinuousBatcher (batched admission, chunked
    prefill), or the paged batcher on INT4 pages."""
    path, jparams = ckpt
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in (9, 21, 5, 14)]
    if mode == "dense":
        flags = ["--prefill-pad", "8", "--prefill-chunk", "16", "--admit-batch", "2"]
        ref = JBatcher(jeng.EngineConfig(cfg=CFG, use_kernel=False), jparams, num_slots=2,
                       max_len=64, prefill_pad=8, prefill_chunk=16, admit_batch=2)
    elif mode == "dense_spec":
        flags = ["--prefill-pad", "8", "--spec-k", "2"]
        ref = JBatcher(jeng.EngineConfig(cfg=CFG, use_kernel=False), jparams, num_slots=2,
                       max_len=64, prefill_pad=8, spec_k=2)
        prompts = [np.asarray([3, 5, 3, 5, 3, 5, 3], np.int32)] + prompts[1:]
    else:
        flags = ["--paged", "--kv-bits", "4", "--page-size", "16"]
        ref = JPagedBatcher(jeng.EngineConfig(cfg=CFG, use_kernel=False, kv_bits=4), jparams,
                            num_slots=2, max_len=64, page_size=16)
    for i, p in enumerate(prompts):
        ref.add_request(JRequest(uid=i, prompt_ids=p, max_new_tokens=6))
    want = {r.uid: r.output_ids for r in ref.run()}

    args = tserve.build_parser().parse_args([path, *FLAGS, *flags])
    with tserve.build_server(args) as srv:
        finals, streamed, metrics = _round_trip(srv, prompts, 6)
        batcher = srv.batcher
    assert finals == want
    assert streamed[1] == finals[1]
    assert metrics["requests_finished"] == len(prompts)
    assert metrics["tokens_generated"] == 6 * len(prompts)
    if mode == "dense":
        assert type(batcher).__name__ == "ContinuousBatcher" and batcher.admit_batch == 2
    elif mode == "dense_spec":
        # requests reach the daemon's loop over time, so its speculative
        # steps may fall otherwise than the direct run's; its tokens may not
        assert batcher.spec_k == 2 and metrics["spec_steps"] > 0
    else:
        assert metrics["kv_bits"] == 4 and metrics["pages_in_use"] == 0
        assert metrics["kv_bytes_per_token"] == (
            2 * CFG.num_hidden_layers * CFG.num_key_value_heads * CFG.head_dim // 2)
