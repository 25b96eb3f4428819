"""Architecture adapters for the calibration loop.

Port of ``dgq_tpu/quant/arch.py`` for LLaMA.  An adapter gives the generic
PTQ loop (``quant/calibrate.py``) what differs between families:

  * ``embed``            token ids -> block-0 inputs
  * ``make_aux``         per-sequence data (mask, RoPE tables)
  * ``block``            the block apply, optionally with its collect dict
  * ``linears``          name -> (param path, collect key of its input)
  * ``max_absmax_keys``  collect keys kept as a running max of channel absmax
  * ``kv_keys``          collect keys kept as a running min (the kv stats)
  * ``minmax_keys``      keys kept as running (max, min) for --meanact
  * ``smooth``/``meanact``  param rewrites from the collected stats
  * ``head``             final norm + lm head (for eval)

The other families' adapters are not ported yet (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from typing import Dict

import torch

from dgq_tpu_torch.models import llama as llama_mod
from dgq_tpu_torch.models.llama import KVQuantState, QuantState
from dgq_tpu_torch.quant import smooth as smooth_mod

UNPORTED_ARCHS = ("opt", "bloom", "mpt", "falcon", "mixtral")


class LlamaAdapter:
    name = "llama"

    linears = {
        "q_proj": (("self_attn", "q_proj"), "qkv_inp"),
        "k_proj": (("self_attn", "k_proj"), "qkv_inp"),
        "v_proj": (("self_attn", "v_proj"), "qkv_inp"),
        "o_proj": (("self_attn", "o_proj"), "o_proj_inp"),
        "gate_proj": (("mlp", "gate_proj"), "gate_up_inp"),
        "up_proj": (("mlp", "up_proj"), "gate_up_inp"),
        "down_proj": (("mlp", "down_proj"), "down_proj_inp"),
    }
    max_absmax_keys = ("attn_ln_out", "mlp_ln_out", "down_proj_inp", "o_proj_inp")
    kv_keys = ("q_rope", "k_rope", "v_rope")
    minmax_keys = ("attn_ln_out", "mlp_ln_out")
    hessian_fams = ("qkv_inp", "o_proj_inp", "gate_up_inp", "down_proj_inp")

    def __init__(self, cfg):
        self.cfg = cfg

    def layers(self, params):
        return params["layers"]

    def rebuild(self, params, new_layers):
        return {**params, "layers": new_layers}

    def embed(self, params, input_ids):
        return llama_mod.llama_embed(params, input_ids)

    def make_aux(self, seqlen, dtype, device):
        mask = llama_mod.causal_mask(seqlen, seqlen, dtype, device)
        cos, sin = llama_mod.rope_cos_sin(torch.arange(seqlen, device=device),
                                          self.cfg.head_dim, self.cfg.rope_theta, dtype)
        return (mask, cos, sin)

    def block(self, layer, x, aux, qs: QuantState, kv_scales, collect_stats=False):
        mask, cos, sin = aux
        return llama_mod.llama_block(layer, x, mask, cos, sin, self.cfg, qs, kv_scales,
                                     collect_stats)

    def smooth(self, layer, stats: Dict[str, torch.Tensor]):
        return smooth_mod.smooth_llama_layer(layer, {
            "attn_ln_out_absmax": stats["attn_ln_out"],
            "mlp_ln_out_absmax": stats["mlp_ln_out"],
            "down_proj_inp_absmax": stats["down_proj_inp"],
        })

    def meanact(self, layer, stats_max, stats_min):
        from dgq_tpu_torch.quant.calibrate import apply_meanact_llama

        return apply_meanact_llama(layer, stats_max, stats_min)

    def head(self, params, x):
        return llama_mod.llama_head(params, x, self.cfg)

    def kv_state(self, stats_min) -> KVQuantState:
        maxq = 255.0
        return KVQuantState(
            q_scale=2.0 * torch.amax(stats_min["q_rope"]) / maxq,
            k_scale=2.0 * torch.amax(stats_min["k_rope"]) / maxq,
            v_scale=2.0 * torch.amax(stats_min["v_rope"]) / maxq,
        )


def get_adapter(arch: str, cfg):
    if arch == "llama":
        return LlamaAdapter(cfg)
    if arch in UNPORTED_ARCHS:
        raise NotImplementedError(f"PTQ of {arch!r} is not ported yet (ROADMAP Queue 1 item 4: "
                                  "LLaMA first); quantize it with dgq_tpu")
    raise KeyError(arch)
