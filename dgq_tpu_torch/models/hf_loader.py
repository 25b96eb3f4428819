"""HuggingFace LLaMA checkpoint ingestion, from a local directory.

Port of ``dgq_tpu/models/hf_loader.py`` for LLaMA (``load_llama_config``,
``load_llama_params``), reading the safetensors shards with the port's own
reader (``utils/checkpoint.read_safetensors``).  It loads the same params
as JAX's loader and ties ``lm_head`` to the embedding when the head is
absent; unlike it, it warns naming every tensor it does not use (an HF
``rotary_emb.inv_freq``, say) and every param a layer lacks.  The other
families' loaders are not ported yet (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Iterator, Tuple

import torch

from dgq_tpu_torch.models.llama import LlamaConfig

NORMS = ("input_layernorm", "post_attention_layernorm")
PROJS = {"self_attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
         "mlp": ("gate_proj", "up_proj", "down_proj")}


def load_llama_config(model_dir: str) -> LlamaConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    return LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )


def _open_shards(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) for every tensor of the directory's safetensors
    shards (those of ``model.safetensors.index.json`` when present)."""
    from dgq_tpu_torch.utils.checkpoint import read_safetensors

    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shards = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    for shard in shards:
        yield from read_safetensors(os.path.join(model_dir, shard)).items()


def _place(params: Dict, name: str, t: torch.Tensor) -> bool:
    """Put one HF tensor into the params tree; False for a name JAX's loader
    passes over."""
    if name == "model.embed_tokens.weight":
        params["embed_tokens"] = t
    elif name == "model.norm.weight":
        params["norm"] = {"weight": t}
    elif name == "lm_head.weight":
        params["lm_head"] = {"weight": t}
    elif name.startswith("model.layers."):
        parts = name.split(".")
        li, sub = int(parts[2]), parts[3]
        if li >= len(params["layers"]):
            return False
        layer = params["layers"][li]
        if sub in NORMS and parts[4:] == ["weight"]:
            layer[sub]["weight"] = t
        elif sub in PROJS and len(parts) == 6 and parts[4] in PROJS[sub]:
            layer[sub][parts[4]][parts[5]] = t  # weight / bias
        else:
            return False
    else:
        return False
    return True


def load_llama_params(model_dir: str, dtype=torch.bfloat16, device="cuda") -> Dict:
    """HF LLaMA weights -> the params tree (``dtype`` on ``device``)."""
    cfg = load_llama_config(model_dir)
    params: Dict = {"layers": [
        {**{n: {} for n in NORMS}, **{sub: {p: {} for p in projs} for sub, projs in PROJS.items()}}
        for _ in range(cfg.num_hidden_layers)]}
    unmatched = []
    for name, t in _open_shards(model_dir):
        if not _place(params, name, t.to(device=device, dtype=dtype)):
            unmatched.append(name)
    if unmatched:
        warnings.warn(f"{len(unmatched)} checkpoint tensor(s) not loaded: "
                      f"{', '.join(sorted(unmatched))}", stacklevel=2)
    missing = [f"model.{k}.weight" for k in ("embed_tokens", "norm") if k not in params]
    for li, layer in enumerate(params["layers"]):
        missing += [f"model.layers.{li}.{n}.weight" for n in NORMS if "weight" not in layer[n]]
        missing += [f"model.layers.{li}.{sub}.{p}.weight" for sub, projs in PROJS.items()
                    for p in projs if "weight" not in layer[sub][p]]
    if missing:
        warnings.warn(f"{len(missing)} param(s) missing from the checkpoint: "
                      f"{', '.join(missing)}", stacklevel=2)
    if "lm_head" not in params and "embed_tokens" in params:
        if not cfg.tie_word_embeddings:
            warnings.warn("checkpoint has no lm_head.weight and tie_word_embeddings is not "
                          "set; tying lm_head to embed_tokens", stacklevel=2)
        params["lm_head"] = {"weight": params["embed_tokens"]}
    return params
