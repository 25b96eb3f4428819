"""The dgq_tpu_torch serving daemon on the CPU: its CLI against dgq_tpu's,
a live socket over a checkpoint that dgq_tpu's save_engine wrote (the paged
batcher; the dense, speculative and INT4 daemons in
tests/test_torch_serve_batchers.py), and the exits of the options not ported
yet."""

import json
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from dgq_tpu import serve as jserve
from dgq_tpu.models import engine as jeng
from dgq_tpu.models.llama import tiny_llama_config
from dgq_tpu.models.synthetic import build_llama_engine
from dgq_tpu.serving.paged import PagedBatcher as JPagedBatcher
from dgq_tpu.serving.scheduler import Request as JRequest
from dgq_tpu.utils.checkpoint import save_engine
from dgq_tpu_torch import serve as tserve

CFG = tiny_llama_config(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2)
FLAGS = ["--cpu", "--paged", "--port", "0", "--page-size", "16", "--max-len", "64",
         "--slots", "2", "--metrics-interval", "0"]


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


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    assert _actions(tserve.build_parser()) == _actions(jserve.build_parser())


def _send(sock, obj):
    sock.sendall((json.dumps(obj) + "\n").encode())


def test_server_round_trip_matches_jax(ckpt):
    """A plain request, a streaming one (its deltas make up its output), a
    cancel mid-stream and the metrics op, over a localhost socket; the
    tokens equal JAX's PagedBatcher on the same checkpoint."""
    path, jparams = ckpt
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in (9, 21)]

    ref = JPagedBatcher(jeng.EngineConfig(cfg=CFG, use_kernel=False), jparams, num_slots=2,
                        max_len=64, page_size=16)
    for i, p in enumerate(prompts):
        ref.add_request(JRequest(uid=i, prompt_ids=p, max_new_tokens=8))
    want = {r.uid: r.output_ids for r in ref.run()}

    args = tserve.build_parser().parse_args([path, *FLAGS])
    with tserve.build_server(args) as srv:
        assert srv.batcher.device.type == "cpu" and srv.batcher.ps == 16
        with socket.create_connection((srv.host, srv.port), timeout=120) as s:
            f = s.makefile("r")
            _send(s, {"prompt_ids": prompts[0].tolist(), "max_new_tokens": 8})
            plain = json.loads(f.readline())
            assert plain["done"] and plain["output_ids"] == want[0]
            assert plain["e2e_ms"] >= plain["ttft_ms"] >= 0

            _send(s, {"prompt_ids": prompts[1].tolist(), "max_new_tokens": 8, "stream": True})
            deltas = []
            while True:
                msg = json.loads(f.readline())
                deltas += msg["token_ids"]
                if msg["done"]:
                    break
            assert msg["output_ids"] == deltas == want[1]

            _send(s, {"prompt_ids": [3, 5, 3, 5], "max_new_tokens": 40, "stream": True})
            first = json.loads(f.readline())
            assert not first["done"] and first["token_ids"]
            _send(s, {"op": "cancel", "uid": first["uid"]})
            replies = []  # stream deltas, the ack and the final reply, in any order
            while not (any(r.get("done") for r in replies)
                       and any("cancelled_ok" in r for r in replies)):
                replies.append(json.loads(f.readline()))
            final = next(r for r in replies if r.get("done"))
            ack = next(r for r in replies if "cancelled_ok" in r)
            assert ack["cancelled_ok"] and final["cancelled"]
            assert len(final["output_ids"]) < 40

            _send(s, {"op": "metrics"})
            m = json.loads(f.readline())
            assert m["requests_finished"] == 3 and m["pages_in_use"] == 0
            assert m["tokens_generated"] == 16 + len(final["output_ids"])


def test_submit_does_not_wait_for_the_scheduler_lock(ckpt):
    """A submit while the scheduler loop holds its lock (a step in flight)
    returns at once, a request the batcher can never serve raises at once,
    and the queued request is served once the lock is free."""
    path, _ = ckpt
    args = tserve.build_parser().parse_args([path, *FLAGS])
    with tserve.build_server(args) as srv:
        uids, done = [], threading.Event()
        with srv._locks[0]:
            threading.Thread(target=lambda: (uids.append(srv.submit([3, 5, 3, 5], 4)),
                                             done.set()), daemon=True).start()
            assert done.wait(10), "submit waited for the scheduler loop's lock"
            with pytest.raises(ValueError, match="does not fit"):
                srv.submit(list(range(64)), 4)
        req = srv.wait(uids[0], timeout=120)
        assert len(req.output_ids) == 4 and req.t_first >= req.t_submit
        assert srv.metrics()["requests_finished"] == 1

        # many submitting threads at once: no request or count is lost
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: uids.extend(
                srv.submit([3, 5, 3, 5], 2) for _ in range(2))) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)
        assert all(len(srv.wait(u, timeout=120).output_ids) == 2 for u in uids[1:])
        assert len(uids) == 17 and srv._outstanding == [0]
        assert srv.metrics()["requests_finished"] == 17


def test_prefix_flag_registers_prefix(ckpt, tmp_path):
    path, _ = ckpt
    prefix = tmp_path / "prefix.txt"
    prefix.write_text(" ".join(str(t) for t in range(20)))
    args = tserve.build_parser().parse_args([path, *FLAGS, "--prefix", str(prefix)])
    with tserve.build_server(args) as srv:
        assert srv.batcher.pages_in_use() == 2  # 20 tokens in pages of 16
        with socket.create_connection((srv.host, srv.port), timeout=120) as s:
            f = s.makefile("r")
            _send(s, {"prompt_ids": list(range(20)) + [7, 9], "max_new_tokens": 4})
            assert len(json.loads(f.readline())["output_ids"]) == 4
        assert srv.batcher.prefix_hits == 1


@pytest.mark.parametrize("extra,item", [
    (["--paged"], None),  # ported: no exit
    ([], None),  # the dense batcher
    (["--paged", "--kv-bits", "4"], None),  # INT4 KV
    (["--spec-k", "2"], None),  # speculative decoding in the dense batcher
    (["--paged", "--spec-k", "2"], None),  # ignored with --paged, as JAX's
    (["--paged", "--tp", "2"], "Queue 1 item 7"),
    (["--pp", "2"], "Queue 1 item 7"),
    (["--paged", "--dp", "2"], "Queue 1 item 7"),
])
def test_unported_options_exit_with_roadmap_item(ckpt, extra, item):
    path, _ = ckpt
    args = tserve.build_parser().parse_args([path, "--cpu", "--port", "0", *extra])
    if item is None:  # a ported option starts a server over the batcher it names
        assert tserve._unported(args) == ""
        with tserve.build_server(args) as srv:
            assert type(srv.batcher).__name__ == (
                "PagedBatcher" if args.paged else "ContinuousBatcher")
            assert srv.batcher.ecfg.kv_bits == args.kv_bits
            if not args.paged:
                assert srv.batcher.spec_k == args.spec_k
        return
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        tserve.build_server(args)


def test_unported_checkpoints_exit_with_roadmap_item(tmp_path):
    # an orbax directory exits naming its item; every family's save_engine file is served
    # (OPT, BLOOM, MPT: tests/test_torch_family.py), a Falcon one included
    from dgq_tpu_torch.models.falcon import tiny_falcon_config
    from dgq_tpu_torch.models.synthetic import build_falcon_engine
    from dgq_tpu_torch.utils.checkpoint import save_engine as tsave_engine

    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    args = tserve.build_parser().parse_args([str(orbax), "--paged", "--cpu"])
    with pytest.raises(SystemExit, match="ROADMAP Queue 1 item 1"):
        tserve.build_server(args)
    cfg = tiny_falcon_config()
    falcon = str(tmp_path / "falcon.safetensors")
    tsave_engine(falcon, build_falcon_engine(cfg, device="cpu"), cfg, arch="falcon")
    args = tserve.build_parser().parse_args([falcon, "--cpu", "--port", "0", "--admit-batch",
                                             "1", "--max-len", "64", "--prefill-pad", "8"])
    assert tserve._unported(args) == ""
    with tserve.build_server(args) as srv:
        assert type(srv.batcher).__name__ == "ContinuousBatcher" and srv.batcher._f is not None
    args = tserve.build_parser().parse_args([falcon, "--paged", "--cpu"])
    with pytest.raises(SystemExit, match="LLaMA-only; checkpoint is falcon"):
        tserve.build_server(args)
