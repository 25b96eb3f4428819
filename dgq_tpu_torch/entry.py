"""The PTQ command line: ``python -m dgq_tpu_torch.entry MODEL DATASET ...``.

Port of ``dgq_tpu/entry.py`` with the same flags, e.g.

  python -m dgq_tpu_torch.entry tiny:llama synthetic --wt_fun search \\
      --groupsize 128 --w4w8 --smoothquant --kvquant --inference_mod \\
      --save_engine eng.safetensors --eval

MODEL is a local HF LLaMA checkpoint directory or ``tiny:llama`` (random
weights from ``--seed``).  The flow: fp params -> layer-sequential
calibration (smoothing, search / GPTQ / naive quantization, packing) ->
``--save_safetensors`` -> ``--inference_mod``: the INT8 engine
(``from_ptq_auto``), ``--save_engine`` -> ``--eval``: perplexity, through
the engine when one was built, else the fake-quant forward.  Runs on the
card; ``--cpu`` runs on the CPU, and without it a machine with no card
exits 1 naming the missing device.  Not ported yet: the other families
(ROADMAP Queue 1 item 4), ``--mmlu_eval`` (item 4), ``--calib_dp > 1`` and
``--save_engine_sharded`` (item 7); each raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dgq_tpu_torch.entry")
    p.add_argument("model", type=str, help="HF LLaMA model dir, or tiny[:llama]")
    p.add_argument("dataset", type=str,
                   choices=["wikitext2", "ptb", "c4", "ptb_new", "c4_new", "synthetic"],
                   help="calibration dataset")
    p.add_argument("--nsamples", type=int, default=18)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--wbits", type=int, default=4, choices=[2, 3, 4, 8, 16])
    p.add_argument("--abits", type=int, default=8, choices=[8, 16])
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--save", type=str, default="", help="(alias of --save_safetensors)")
    p.add_argument("--save_safetensors", type=str, default="")
    p.add_argument("--load", type=str, default="", help="load quantized checkpoint")
    p.add_argument("--groupsize", type=int, default=-1)
    p.add_argument("--act-order", action="store_true")
    p.add_argument("--act_fun", type=str, default="static",
                   choices=["static", "per_tensor", "per_token", "per_tensor_asym", "no"])
    p.add_argument("--wt_fun", type=str, default="naive",
                   choices=["naive", "search", "gptq", "no"])
    p.add_argument("--smoothquant", action="store_true")
    p.add_argument("--kvquant", action="store_true")
    p.add_argument("--meanact", action="store_true")
    p.add_argument("--w4w8", action="store_true", help="dual grained quantization")
    p.add_argument("--w4w8_fallback_ratio", type=float, default=None,
                   help="per-layer fallback to plain fp-group-scale quant when the "
                        "dual-grained layer-output MSE exceeds this factor of the plain MSE")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--mmlu_eval", type=str, default="no",
                   help="not ported yet: only 'no' is accepted")
    p.add_argument("--inference_mod", action="store_true",
                   help="convert to the real-quant INT8 engine after load")
    p.add_argument("--save_engine", type=str, default="",
                   help="after --inference_mod: save the converted INT8 engine (safetensors)")
    p.add_argument("--save_engine_sharded", type=str, default="",
                   help="not ported yet (sharded engine directories)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--eval_samples", type=int, default=None, help="cap ppl windows")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--calib_dp", type=int, default=1,
                   help="not ported yet: only 1 is accepted")
    for flag in ("--benchmark", "--check", "--sym", "--true-sequential", "--observe",
                 "--nearest"):
        p.add_argument(flag, action="store_true", help="accepted for CLI parity (no-op)")
    p.add_argument("--csqa_eval", type=str, default="no", help="no-op (CLI parity)")
    return p


def generate_qconfig(args):
    from dgq_tpu_torch.config import ActQuantConfig, QuantConfig, WtQuantConfig

    act = None if args.act_fun == "no" else ActQuantConfig(bits=args.abits, method=args.act_fun)
    wt = None
    if args.wt_fun != "no":
        wt = WtQuantConfig(bits=args.wbits, method=args.wt_fun, groupsize=args.groupsize,
                           w4w8=args.w4w8, w4w8_fallback_ratio=args.w4w8_fallback_ratio,
                           percdamp=args.percdamp, act_order=args.act_order)
    return QuantConfig(act_quant=act, wt_quant=wt, smoothquant=args.smoothquant,
                       meanact=args.meanact, kvquant=args.kvquant, nsamples=args.nsamples)


def _unported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item}); "
                               "run it with python -m dgq_tpu.entry")


def prepare_model(model: str, seed: int = 0, device="cuda"):
    """(params, cfg, arch, model_dir or None) on ``device``."""
    from dgq_tpu_torch.models import llama as L

    if model.startswith("tiny"):
        arch = model.split(":")[1] if ":" in model else "llama"
        if arch != "llama":
            raise _unported(f"the tiny:{arch} fixture (PTQ of {arch})", 4)
        cfg = L.tiny_llama_config(hidden_size=256, intermediate_size=512,
                                  num_attention_heads=4, num_key_value_heads=4)
        gen = torch.Generator(device=device).manual_seed(seed)
        return L.init_llama_params(cfg, gen, torch.float32, device), cfg, arch, None
    with open(os.path.join(model, "config.json")) as f:
        model_type = json.load(f).get("model_type", "llama")
    if model_type != "llama":
        raise _unported(f"HF ingestion and PTQ of {model_type!r}", 4)
    from dgq_tpu_torch.models.hf_loader import load_llama_config, load_llama_params

    return load_llama_params(model, device=device), load_llama_config(model), "llama", model


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mmlu_eval != "no":
        raise _unported("--mmlu_eval (mmlu_accuracy, prepare_mmlu)", 4)
    if args.calib_dp > 1:
        raise _unported("--calib_dp > 1 (data-parallel calibration)", 7)
    if args.save_engine_sharded:
        raise _unported("--save_engine_sharded (sharded engine directories)", 7)
    if not args.cpu and not torch.cuda.is_available():
        print("dgq_tpu_torch.entry: no CUDA device: torch.cuda.is_available() is false "
              "(pass --cpu to run on the CPU)", file=sys.stderr)
        return 1
    device = "cpu" if args.cpu else "cuda"

    from dgq_tpu_torch.models.llama import QuantState, llama_apply
    from dgq_tpu_torch.quant.calibrate import ptq
    from dgq_tpu_torch.utils.checkpoint import load_quantized, save_engine, save_quantized
    from dgq_tpu_torch.utils.datautils import get_calib_samples, get_eval_stream
    from dgq_tpu_torch.utils.evalutils import ppl_eval, ppl_eval_engine

    params, cfg, arch, model_dir = prepare_model(args.model, args.seed, device)
    qcfg = generate_qconfig(args)
    print(f"[dgq_tpu_torch] arch={arch} device={device} qconfig={qcfg}")
    seqlen = 64 if args.model.startswith("tiny") else qcfg.seqlen

    if args.load:
        params, cfg, qcfg, kv_scales = load_quantized(args.load, device)
        print(f"[dgq_tpu_torch] loaded {args.load}")
    else:
        calib = get_calib_samples(args.dataset, args.nsamples, seed=args.seed, seqlen=seqlen,
                                  model_path=model_dir, vocab_size=cfg.vocab_size,
                                  data_path=args.data_path)
        tick = time.time()
        res = ptq(params, cfg, calib, qcfg, arch=arch)
        print(f"[dgq_tpu_torch] PTQ took {time.time() - tick:.1f}s")
        params, kv_scales = res.params, res.kv_scales
        out_path = args.save_safetensors or args.save
        if out_path:
            save_quantized(out_path, params, cfg, qcfg, kv_scales, arch=arch)
            print(f"[dgq_tpu_torch] saved {out_path}")

    engine_state = None
    if args.inference_mod:
        from dgq_tpu_torch.models.engine import from_ptq_auto

        engine_state = from_ptq_auto(params, kv_scales, cfg)
        print("[dgq_tpu_torch] converted to INT8 engine"
              + (" (fp32 group scales)" if engine_state[0].fp_scales else ""))
        if args.save_engine:
            save_engine(args.save_engine, engine_state[1], cfg, arch=arch)
            print(f"[dgq_tpu_torch] saved engine {args.save_engine}")
    elif args.save_engine:
        print("[dgq_tpu_torch] --save_engine requires --inference_mod; ignoring")

    if args.eval:
        qs = QuantState(actq=qcfg.actq, wtq=qcfg.wtq, kv=qcfg.kvquant)
        if args.dataset == "synthetic":
            datasets = ["synthetic"]
        elif args.dataset.endswith("_new"):
            datasets = ["wikitext2", "ptb_new", "c4_new"]
        else:
            datasets = ["wikitext2", "ptb", "c4"]
        for ds in datasets:
            try:
                stream = get_eval_stream(ds, seqlen=seqlen, model_path=model_dir,
                                         vocab_size=cfg.vocab_size, data_path=args.data_path)
            except (ImportError, OSError, ValueError) as e:
                print(f"[dgq_tpu_torch] {ds}: unavailable offline ({type(e).__name__}: {e}); "
                      "skipping")
                continue
            if engine_state is not None:
                ppl = ppl_eval_engine(engine_state[0], engine_state[1], stream, seqlen,
                                      max_samples=args.eval_samples, verbose=True)
                print(f"[dgq_tpu_torch] {ds} ppl (INT8 engine) = {ppl:.4f}")
            else:
                ppl = ppl_eval(lambda pk, batch: llama_apply(pk[0], batch, cfg, qs, pk[1]),
                               (params, kv_scales), stream, seqlen,
                               max_samples=args.eval_samples, verbose=True)
                print(f"[dgq_tpu_torch] {ds} ppl = {ppl:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
