"""SmoothQuant-style outlier migration as pure parameter transforms.

Port of ``dgq_tpu/quant/smooth.py``: each transform takes tensors and returns
new ones, and ``smooth_llama_layer`` / ``smooth_llama_layer_weight_only``
wire them into a LLaMA layer's param dict.  Numerics as the reference's: the
top-0.5% baseline ``basl = int(len * 0.005 + 1.5)``, scales = act / baseline
with scales <= baseline pinned to 1, no smoothing when baseline < 1e-4.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor


def _outlier_scales(act_scales: Tensor) -> Tensor:
    """Per-channel migration scale."""
    n = act_scales.shape[0]
    basl = int(n * 0.005 + 1.5)
    baseline = torch.sort(act_scales).values[-basl]
    scales = act_scales / baseline
    scales = torch.where(act_scales <= baseline, torch.ones_like(scales), scales)
    return torch.where(baseline < 1e-4, torch.ones_like(scales), scales)


def smooth_ln_fcs(ln_weight: Tensor, ln_bias: Optional[Tensor], fc_weights: List[Tensor],
                  act_scales: Tensor) -> Tuple[Tensor, Optional[Tensor], List[Tensor]]:
    """Divide the norm's weight (and bias), multiply the fcs' input columns;
    fc weights are (out, in), act_scales the norm output's per-channel absmax
    (max over samples)."""
    scales = _outlier_scales(act_scales.to(torch.float32))
    s = scales.to(ln_weight.dtype)
    new_ln_w = ln_weight / s
    new_ln_b = None if ln_bias is None else ln_bias / s
    new_fcs = [fc * scales.to(fc.dtype)[None, :] for fc in fc_weights]
    return new_ln_w, new_ln_b, new_fcs


def smooth_llama_mlp(up_weight: Tensor, up_bias: Optional[Tensor], down_weight: Tensor,
                     act_scales: Tensor) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """Migrate down_proj input outliers into up_proj output rows (gate
    untouched)."""
    scales = _outlier_scales(act_scales.to(torch.float32))
    s_up = scales.to(up_weight.dtype)
    new_up_w = up_weight / s_up[:, None]
    new_up_b = None if up_bias is None else up_bias / s_up
    new_down_w = down_weight * scales.to(down_weight.dtype)[None, :]
    return new_up_w, new_up_b, new_down_w


def smooth_ln_fcs_weight(ln_weight: Tensor, ln_bias: Optional[Tensor], fc_weights: List[Tensor]
                         ) -> Tuple[Tensor, Optional[Tensor], List[Tensor]]:
    """Weight-only (data-free) variant: geometric-mean column scale, clamped
    to [0.2, 5]."""
    ws = torch.stack([torch.mean(torch.abs(fc.to(torch.float32)), dim=0) for fc in fc_weights])
    ws = ws / torch.mean(ws, dim=1, keepdim=True)
    scales = torch.prod(ws, dim=0) ** (1.0 / len(fc_weights))
    scales = torch.clamp(scales, 0.2, 5.0)
    s = scales.to(ln_weight.dtype)
    new_ln_w = ln_weight * s
    new_ln_b = None if ln_bias is None else ln_bias * s
    new_fcs = [fc / scales.to(fc.dtype)[None, :] for fc in fc_weights]
    return new_ln_w, new_ln_b, new_fcs


def smooth_fc_weight(v_weight: Tensor, v_bias: Optional[Tensor], o_weight: Tensor
                     ) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """Balance v_proj's output rows against o_proj's input columns by
    o_proj's per-column weight magnitude."""
    best = torch.mean(torch.abs(o_weight.to(torch.float32)), dim=0)
    scales = torch.clamp(best / torch.mean(best), 0.2, 5.0)
    sv = scales.to(v_weight.dtype)
    new_v_w = v_weight * sv[:, None]
    new_v_b = None if v_bias is None else v_bias * sv
    new_o_w = o_weight / scales.to(o_weight.dtype)[None, :]
    return new_v_w, new_v_b, new_o_w


def mean_ln_fcs(ln_weight: Tensor, ln_bias: Optional[Tensor], fc_weights: List[Tensor],
                fc_biases: List[Optional[Tensor]], act_median: Tensor
                ) -> Tuple[Tensor, List[Optional[Tensor]]]:
    """Fold the activation mean into the norm's bias and compensate in the fc
    biases (--meanact).  Returns (new_ln_bias, new_fc_biases)."""
    med = act_median.to(torch.float32)
    new_ln_b = (-med if ln_bias is None else ln_bias.to(torch.float32) - med).to(ln_weight.dtype)
    new_fc_biases = []
    for fc_w, fc_b in zip(fc_weights, fc_biases):
        tmp = torch.matmul(fc_w.to(torch.float32), med)
        nb = tmp if fc_b is None else fc_b.to(torch.float32) + tmp
        new_fc_biases.append(nb.to(fc_w.dtype))
    return new_ln_b, new_fc_biases


def smooth_att_qk(q_weight: Tensor, k_weight: Tensor, q_out_scales: Tensor,
                  k_out_scales: Tensor) -> Tuple[Tensor, Tensor]:
    """Balance q/k output ranges per channel, preserving q.k^T: q rows
    divided by s = sqrt(q_scale / k_scale), k rows multiplied by s."""
    s = torch.sqrt(q_out_scales.to(torch.float32) / k_out_scales.to(torch.float32))
    return q_weight / s.to(q_weight.dtype)[:, None], k_weight * s.to(k_weight.dtype)[:, None]


def smooth_ov(v_weight: Tensor, v_bias: Optional[Tensor], o_weight: Tensor, act_scales: Tensor
              ) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """Migrate o_proj input outliers into v_proj rows (top-50% baseline)."""
    num = o_weight.shape[1]
    basl = int(num * 0.5 + 1.5)
    baseline = torch.sort(act_scales.to(torch.float32)).values[-basl]
    scales = act_scales / baseline
    scales = torch.where(act_scales <= baseline, torch.ones_like(scales), scales)
    scales = torch.where(baseline < 1e-4, torch.ones_like(scales), scales)
    new_o = o_weight * scales.to(o_weight.dtype)[None, :]
    new_v = v_weight / scales.to(v_weight.dtype)[:, None]
    new_vb = None if v_bias is None else v_bias / scales.to(v_bias.dtype)
    return new_v, new_vb, new_o


# ---------------------------------------------------------------------------
# LLaMA wiring
# ---------------------------------------------------------------------------


def copy_tree(tree):
    """A copy of nested dicts and lists, the leaves (tensors, packed linears)
    shared."""
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [copy_tree(v) for v in tree]
    return tree


def _set_weights(p: Dict, sub: str, names, weights) -> None:
    for name, w in zip(names, weights):
        p[sub][name] = {**p[sub][name], "weight": w}


QKV = ("q_proj", "k_proj", "v_proj")
GATE_UP = ("gate_proj", "up_proj")


def smooth_llama_layer(layer_params: Dict, stats: Dict) -> Dict:
    """The LLaMA smoothing recipe on a layer's param dict, from pass-1 stats:

      stats['attn_ln_out_absmax']   (D,) max-over-samples norm-1 output absmax
      stats['mlp_ln_out_absmax']    (D,) the same for norm 2
      stats['down_proj_inp_absmax'] (F,) max-over-samples down_proj input absmax
    """
    p = copy_tree(layer_params)
    new_ln1, _, new_qkv = smooth_ln_fcs(p["input_layernorm"]["weight"], None,
                                        [p["self_attn"][k]["weight"] for k in QKV],
                                        stats["attn_ln_out_absmax"])
    p["input_layernorm"] = {**p["input_layernorm"], "weight": new_ln1}
    _set_weights(p, "self_attn", QKV, new_qkv)

    new_ln2, _, new_gu = smooth_ln_fcs(p["post_attention_layernorm"]["weight"], None,
                                       [p["mlp"][k]["weight"] for k in GATE_UP],
                                       stats["mlp_ln_out_absmax"])
    p["post_attention_layernorm"] = {**p["post_attention_layernorm"], "weight": new_ln2}
    _set_weights(p, "mlp", GATE_UP, new_gu)

    new_up, _, new_down = smooth_llama_mlp(p["mlp"]["up_proj"]["weight"], None,
                                           p["mlp"]["down_proj"]["weight"],
                                           stats["down_proj_inp_absmax"])
    _set_weights(p, "mlp", ("up_proj", "down_proj"), (new_up, new_down))
    return p


def smooth_llama_layer_weight_only(layer_params: Dict) -> Dict:
    """The data-free weight smoothing recipe."""
    p = copy_tree(layer_params)
    new_ln1, _, new_qkv = smooth_ln_fcs_weight(p["input_layernorm"]["weight"], None,
                                               [p["self_attn"][k]["weight"] for k in QKV])
    p["input_layernorm"] = {**p["input_layernorm"], "weight": new_ln1}
    _set_weights(p, "self_attn", QKV, new_qkv)

    new_v, _, new_o = smooth_fc_weight(p["self_attn"]["v_proj"]["weight"], None,
                                       p["self_attn"]["o_proj"]["weight"])
    _set_weights(p, "self_attn", ("v_proj", "o_proj"), (new_v, new_o))

    new_ln2, _, new_gu = smooth_ln_fcs_weight(p["post_attention_layernorm"]["weight"], None,
                                              [p["mlp"][k]["weight"] for k in GATE_UP])
    p["post_attention_layernorm"] = {**p["post_attention_layernorm"], "weight": new_ln2}
    _set_weights(p, "mlp", GATE_UP, new_gu)

    new_up, _, new_down = smooth_fc_weight(p["mlp"]["up_proj"]["weight"], None,
                                           p["mlp"]["down_proj"]["weight"])
    _set_weights(p, "mlp", ("up_proj", "down_proj"), (new_up, new_down))
    return p
