"""Serving daemon CLI: ``python -m dgq_tpu_torch.serve ENGINE_CKPT [flags]``.

Port of ``dgq_tpu/serve.py``: the JSON-lines TCP server
(``serving/server.py``) over the dense ``ContinuousBatcher``
(``serving/scheduler.py``), or with ``--paged`` over a ``PagedBatcher``
(``serving/paged.py``), loaded straight from a ``save_engine`` checkpoint
(the port's or ``dgq_tpu``'s: the files are the same).  ``--kv-bits 4``
serves either on the INT4 cache; ``--spec-k`` > 0 turns on prompt-lookup
speculative decoding in the dense batcher.  OPT, BLOOM, MPT, Falcon and
Mixtral checkpoints are served by the dense batcher over their family's
device functions (``serving/family_batch_engine.batcher_from_checkpoint``);
``--paged``, ``--tp``/``--pp``/``--dp`` > 1, ``--spec-k``, ``--admit-batch``
> 1 and ``--kv-bits 4`` are LLaMA's and exit for them.  The flags are
``dgq_tpu.serve``'s; those of paths not ported yet (``--tp``/``--pp``/``--dp``
> 1, orbax directories) exit with a message naming the ROADMAP item.  As with JAX's ``--paged``, ``--spec-k`` and
``--admit-batch`` are ignored there.  Runs on the GPU; ``--cpu`` runs the
plain versions on the CPU.

Example:
    python -m dgq_tpu_torch.serve eng.safetensors --port 8471 --slots 8 --spec-k 4
    python -m dgq_tpu_torch.serve eng.safetensors --paged --kv-bits 4
    python -m dgq_tpu_torch.serve mpt.safetensors --admit-batch 1
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description="dgq_tpu_torch serving daemon")
    p.add_argument("checkpoint", help="engine checkpoint (save_engine output)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--prefill-chunk", type=int, default=512,
                   help="chunked prefill size (bounds head-of-line latency)")
    p.add_argument("--prefill-pad", type=int, default=128,
                   help="prompt padding granularity (<= max-len)")
    p.add_argument("--admit-batch", type=int, default=4)
    p.add_argument("--decode-steps", type=int, default=1)
    p.add_argument("--spec-k", type=int, default=0,
                   help="prompt-lookup speculative decoding draft length")
    p.add_argument("--prefix", type=str, default=None, action="append",
                   help="path to a shared-prompt token-id file (json list or "
                        "whitespace-separated ints): prefilled once, every "
                        "matching request reuses the cached prefix KV; "
                        "repeatable (longest match wins)")
    p.add_argument("--metrics-interval", type=float, default=30.0,
                   help="seconds between metrics log lines (0 disables)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel shards: serve over a (dp=1, tp) "
                        "device mesh (packed weights column/row-sharded, KV "
                        "over kv heads; parallel/sharded_serving.py)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel serving replicas: dp independent "
                        "batchers on disjoint device groups (each of size "
                        "--tp), requests routed to the least-loaded replica; "
                        "throughput scales with dp for replica-sized models")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages over a ('pp','tp') mesh: "
                        "layers + KV cache sharded over pp, decode runs the "
                        "slots as GPipe microbatches (parallel/pp_serving.py); "
                        "composes with --tp/--spec-k/--admit-batch/--paged "
                        "(the page pool layer-shards per stage)")
    p.add_argument("--paged", action="store_true",
                   help="paged KV cache (serving/paged.py): memory scales "
                        "with tokens in flight, prefixes share pool pages; "
                        "composes with --tp and --prefill-chunk (page-"
                        "aligned); ignores --admit-batch/--spec-k")
    p.add_argument("--page-size", type=int, default=128,
                   help="tokens per KV page (paged mode)")
    p.add_argument("--num-pages", type=int, default=0,
                   help="KV pool pages incl. the null page (paged mode); "
                        "0 = dense-equivalent capacity (slots x max-len)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain PyTorch versions)")
    p.add_argument("--kv-bits", type=int, default=8, choices=[4, 8],
                   help="KV-cache precision: 8 (INT8, reference parity) or "
                        "4 (packed INT4: half the cache memory; paged decode "
                        "through K11 with --paged, plain attention without)")
    return p


def _unported(args) -> str:
    """The ROADMAP item of the first option this port does not serve yet,
    or ''."""
    if os.path.isdir(args.checkpoint):
        return ("orbax (sharded) engine checkpoints are not ported yet (ROADMAP Queue 1 item 1); "
                "serve a save_engine safetensors file")
    if _arch(args) == "llama" and (args.tp > 1 or args.pp > 1 or args.dp > 1):
        return ("--tp/--pp/--dp > 1 (parallel serving) are not ported yet "
                "(ROADMAP Queue 1 item 7)")
    return ""


def _arch(args) -> str:
    with open(args.checkpoint + ".json") as f:
        return json.load(f).get("arch", "llama")


# the options only the LLaMA engine serves, as JAX's serve rejects them for the other
# families (and --kv-bits 4: their caches are INT8 only)
def _llama_only(args) -> list:
    flags = {"--paged": args.paged, "--tp": args.tp > 1, "--pp": args.pp > 1,
             "--dp": args.dp > 1, "--spec-k": args.spec_k > 0,
             "--admit-batch > 1": args.admit_batch > 1, "--kv-bits 4": args.kv_bits != 8}
    return [flag for flag, on in flags.items() if on]


def _read_prefix(path: str):
    with open(path) as f:
        text = f.read().strip()
    return json.loads(text) if text.startswith("[") else [int(t) for t in text.split()]


def build_server(args):
    """The BatcherServer over a ContinuousBatcher, or a PagedBatcher with
    ``--paged``, of ``args.checkpoint``; an OPT, BLOOM, MPT, Falcon or
    Mixtral checkpoint over the ContinuousBatcher with its family's device
    functions.  Exits
    with the ROADMAP item for options not ported yet, and for LLaMA-only
    options on another family's checkpoint."""
    from dgq_tpu_torch.models.engine import EngineConfig
    from dgq_tpu_torch.serving.family_batch_engine import batcher_from_checkpoint
    from dgq_tpu_torch.serving.paged import PagedBatcher
    from dgq_tpu_torch.serving.scheduler import ContinuousBatcher
    from dgq_tpu_torch.utils.checkpoint import fp_scales_of, load_engine

    why = _unported(args)
    if why:
        raise SystemExit(f"dgq_tpu_torch.serve: {why}")
    device = "cpu" if args.cpu else "cuda"
    arch = _arch(args)
    if arch != "llama":
        llama_only = _llama_only(args)
        if llama_only:
            raise SystemExit(f"dgq_tpu_torch.serve: {', '.join(llama_only)} are LLaMA-only; "
                             f"checkpoint is {arch}")
        _, batcher = batcher_from_checkpoint(
            args.checkpoint, device=device, num_slots=args.slots, max_len=args.max_len,
            prefill_pad=min(args.prefill_pad, args.max_len), prefill_chunk=args.prefill_chunk,
            decode_steps=args.decode_steps)
        return _serve(args, batcher)
    eng, cfg = load_engine(args.checkpoint, device=device)
    ecfg = EngineConfig(cfg=cfg, kv_bits=args.kv_bits, fp_scales=fp_scales_of(eng))
    if args.paged:
        chunk = (args.prefill_chunk // args.page_size) * args.page_size  # page-align
        batcher = PagedBatcher(
            ecfg, eng, num_slots=args.slots, max_len=args.max_len,
            page_size=args.page_size, num_pages=args.num_pages or None,
            decode_steps=args.decode_steps, prefill_chunk=chunk,
        )
    else:
        batcher = ContinuousBatcher(
            ecfg, eng, num_slots=args.slots, max_len=args.max_len,
            prefill_pad=min(args.prefill_pad, args.max_len),
            prefill_chunk=args.prefill_chunk, admit_batch=args.admit_batch,
            decode_steps=args.decode_steps, spec_k=args.spec_k,
        )
    return _serve(args, batcher)


def _serve(args, batcher):
    """The BatcherServer over ``batcher``, with the ``--prefix`` files
    registered."""
    from dgq_tpu_torch.serving.server import BatcherServer

    for path in args.prefix or ():
        ids = _read_prefix(path)
        batcher.register_prefix(ids)
        print(f"[dgq_tpu_torch.serve] prefix cached: {len(ids)} tokens", flush=True)
    return BatcherServer(batcher, host=args.host, port=args.port)


def main(argv=None):
    args = build_parser().parse_args(argv)
    srv = build_server(args)
    layout = f"paged, page_size={args.page_size}" if args.paged else "dense"
    print(f"[dgq_tpu_torch.serve] listening on {srv.host}:{srv.port} "
          f"(slots={args.slots}, max_len={args.max_len}, {layout}, kv_bits={args.kv_bits}, "
          f"spec_k={0 if args.paged else args.spec_k})",
          flush=True)
    try:
        while True:
            time.sleep(args.metrics_interval or 3600)
            if args.metrics_interval:
                print(f"[dgq_tpu_torch.serve] {srv.metrics()}", flush=True)
    except KeyboardInterrupt:
        print("[dgq_tpu_torch.serve] shutting down")
        srv.close()


if __name__ == "__main__":
    main()
