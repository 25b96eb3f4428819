"""Layer-sequential PTQ calibration.

Port of ``dgq_tpu/quant/calibrate.py``.  Three replays per block, in the
reference's order:

  pass 1 (fp)        norm-output absmax and late-linear input absmax (max
                     over samples), q/k/v absmax (min over samples), channel
                     max/min for --meanact
  -> meanact fold, smoothing (weight rewrites), kv scales frozen
  pass 2 (fp + kv fake-quant)
                     per-linear input absmax (min over samples), the last
                     sample's inputs (``inp1``), Hessians for GPTQ
  -> each linear quantized (search, GPTQ or naive) and packed
  pass 3 (quantized) outputs feed the next block

Statistics are reduced as the reference reduces them: every calibration
sample is one batch, its per-channel absmax taken first, then the max or the
min over samples; ``inp1`` is the last sample's input only; the Hessian is a
running mean in fp32.  The activation clamp is amax = max over channels of
the min-over-samples channel absmax.

Runs on the device of the embedding, or with ``offload=True`` on ``device``
(default the card) with the params in host memory, one layer moved over for
its three passes and its packed result moved back.  fp32 matmuls run IEEE
(no TF32) throughout.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from dgq_tpu_torch.config import QuantConfig
from dgq_tpu_torch.models.llama import KVQuantState, LlamaConfig, QuantState
from dgq_tpu_torch.quant.arch import get_adapter
from dgq_tpu_torch.quant.gptq import gptq_quantize, init_hessian, update_hessian
from dgq_tpu_torch.quant.packing import PackedLinear, dequantize_linear, pack_linear, \
    pack_linear_w4w8
from dgq_tpu_torch.quant.quantizer import ieee_matmul
from dgq_tpu_torch.quant.search import naive_quantize, search_quantize
from dgq_tpu_torch.quant.smooth import copy_tree, mean_ln_fcs

Tensor = torch.Tensor


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def tree_to(tree, device):
    """Every tensor of a params tree (dicts, lists, PackedLinears) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, PackedLinear):
        return dataclasses.replace(tree, **{
            f.name: tree_to(getattr(tree, f.name), device) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _channel_absmax(x: Tensor) -> Tensor:
    return torch.amax(torch.abs(x.reshape(-1, x.shape[-1])), dim=0).to(torch.float32)


def _per_sample_channel_absmax(x: Tensor) -> Tensor:
    """(B, ..., D) -> (B, D): each sample's per-channel absmax, reduced
    before any statistic over samples."""
    red = tuple(range(1, x.dim() - 1))
    return torch.amax(torch.abs(x), dim=red).to(torch.float32)


def _channel_max(x: Tensor) -> Tensor:
    return torch.amax(x.reshape(-1, x.shape[-1]), dim=0).to(torch.float32)


def _channel_min(x: Tensor) -> Tensor:
    return torch.amin(x.reshape(-1, x.shape[-1]), dim=0).to(torch.float32)


class _Pass1State(NamedTuple):
    max_absmax: Dict[str, Tensor]  # running max of channel absmax
    kv_absmax: Dict[str, Tensor]  # running min (the kv stats)
    ch_max: Dict[str, Tensor]  # running channel max (meanact)
    ch_min: Dict[str, Tensor]


def _merge_pass1(adapter, collect, st: Optional[_Pass1State], meanact: bool) -> _Pass1State:
    mx = {k: _channel_absmax(collect[k]) for k in adapter.max_absmax_keys}
    kv = {k: torch.amin(_per_sample_channel_absmax(collect[k]), dim=0) for k in adapter.kv_keys}
    cmx = {k: _channel_max(collect[k]) for k in adapter.minmax_keys} if meanact else {}
    cmn = {k: _channel_min(collect[k]) for k in adapter.minmax_keys} if meanact else {}
    if st is None:
        return _Pass1State(mx, kv, cmx, cmn)
    return _Pass1State(
        {k: torch.maximum(st.max_absmax[k], v) for k, v in mx.items()},
        {k: torch.minimum(st.kv_absmax[k], v) for k, v in kv.items()},
        {k: torch.maximum(st.ch_max[k], v) for k, v in cmx.items()},
        {k: torch.minimum(st.ch_min[k], v) for k, v in cmn.items()},
    )


def apply_meanact_llama(layer_params: Dict, stats_max: Dict, stats_min: Dict) -> Dict:
    """--meanact for LLaMA: fold the norm outputs' mid-range into the fc
    biases."""
    p = copy_tree(layer_params)
    for ln, sub, names, key in (("input_layernorm", "self_attn", ("q_proj", "k_proj", "v_proj"),
                                 "attn_ln_out"),
                                ("post_attention_layernorm", "mlp", ("gate_proj", "up_proj"),
                                 "mlp_ln_out")):
        med = (stats_max[key] + stats_min[key]) / 2.0
        ln_b, new_bs = mean_ln_fcs(p[ln]["weight"], None, [p[sub][k]["weight"] for k in names],
                                   [p[sub][k].get("bias") for k in names], med)
        p[ln] = {**p[ln], "bias": ln_b}
        for name, b in zip(names, new_bs):
            p[sub][name] = {**p[sub][name], "bias": b}
    return p


class _Laps:
    """Seconds between marks, summed by key; on the card each mark waits for
    the device first."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.out: Dict[str, float] = {}
        self.t = self._now()

    def _now(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def mark(self, key: str) -> None:
        t = self._now()
        self.out[key] = self.out.get(key, 0.0) + t - self.t
        self.t = t


def _quantize_linear(lin, inp1, hessian, qcfg: QuantConfig, amax, laps: Optional[_Laps] = None,
                     name: str = "") -> PackedLinear:
    """Quantize and pack one linear; with ``laps``, the search and the
    packing timed apart under ``search:<name>`` and ``pack:<name>``."""
    w = lin["weight"].to(torch.float32)
    bias = lin.get("bias")
    wq = qcfg.wt_quant
    groupsize = qcfg.groupsize_for(w.shape[1])
    act_method = qcfg.act_quant.method if qcfg.act_quant else None
    kw = dict(bias=bias, amax=amax, act_method=act_method)

    def mark(key):
        if laps is not None:
            laps.mark(f"{key}:{name}")

    if wq.method == "search":
        if wq.w4w8 and wq.w4w8_fallback_ratio is not None:
            # one search: stage 1 shared, both errors from the same call
            res, res_plain, err_w4w8, err_plain = search_quantize(
                w, inp1, bits=wq.bits, groupsize=groupsize, w4w8=True, with_fallback=True)
            fallback = float(err_w4w8) > wq.w4w8_fallback_ratio * max(float(err_plain), 1e-30)
            mark("search")
            if fallback:
                out = pack_linear(res_plain.qweight_fp, res_plain.scale.reshape(-1),
                                  res_plain.zero.reshape(-1), groupsize, bits=wq.bits, **kw)
            else:
                out = pack_linear_w4w8(res.qweight_fp, res.scale, res.zero, res.scale8,
                                       groupsize, **kw)
        else:
            res = search_quantize(w, inp1, bits=wq.bits, groupsize=groupsize, w4w8=wq.w4w8)
            mark("search")
            if wq.w4w8:
                out = pack_linear_w4w8(res.qweight_fp, res.scale, res.zero, res.scale8,
                                       groupsize, **kw)
            else:
                out = pack_linear(res.qweight_fp, res.scale.reshape(-1), res.zero.reshape(-1),
                                  groupsize, bits=wq.bits, **kw)
    elif wq.method == "gptq":
        res = gptq_quantize(w, hessian[0], bits=wq.bits, groupsize=groupsize,
                            percdamp=wq.percdamp, act_order=wq.act_order)
        mark("search")
        out = pack_linear(res.qweight_fp, res.scale.reshape(-1), res.zero.reshape(-1), groupsize,
                          bits=wq.bits, **kw)
    elif wq.method == "naive":
        scale, zero, wq_fp = naive_quantize(w, bits=wq.bits, groupsize=groupsize)
        mark("search")
        out = pack_linear(wq_fp, scale.reshape(-1), zero.reshape(-1), groupsize, bits=wq.bits,
                          **kw)
    else:
        raise NotImplementedError(wq.method)
    mark("pack")
    return out


class PTQResult(NamedTuple):
    params: Any
    kv_scales: List[Optional[KVQuantState]]


def ptq(params, cfg, calib_ids, qcfg: QuantConfig, *, arch: str = "llama",
        verbose: bool = True, report=None, offload: bool = False,
        resume_dir: Optional[str] = None, mesh=None, device=None,
        timings: Optional[list] = None) -> PTQResult:
    """Quantize a params tree layer-sequentially.  ``calib_ids`` is
    (nsamples, seqlen) token ids (numpy or a tensor).  ``report`` (a
    ``utils.metrics.QuantReport``) receives one record per linear.  With
    ``offload=True`` the params stay where they are (host memory) and each
    layer runs on ``device`` (default the card).  ``timings``: a list that
    receives one dict a layer of seconds (pass1, pass2, pass3, and
    ``search:<linear>``/``pack:<linear>``), each mark after the device
    finished."""
    if mesh is not None:
        raise NotImplementedError("data-parallel calibration (mesh, --calib_dp) is not ported "
                                  "yet (ROADMAP Queue 1 item 7)")
    if resume_dir is not None:
        raise NotImplementedError("resumable calibration (resume_dir, quant/resume.py) is not "
                                  "ported yet (ROADMAP Queue 1 item 4)")
    adapter = get_adapter(arch, cfg)
    if device is None:
        device = "cuda" if offload else params["embed_tokens"].device
    with ieee_matmul(), torch.no_grad():
        return _ptq(adapter, params, calib_ids, qcfg, arch, verbose, report, offload,
                    torch.device(device), timings)


def _ptq(adapter, params, calib_ids, qcfg, arch, verbose, report, offload, device, timings):
    ids = torch.as_tensor(np.asarray(calib_ids), dtype=torch.int64, device=device)
    if offload:
        embed = {k: tree_to(v, device) for k, v in params.items() if k != "layers"}
        inps = adapter.embed({**embed, "layers": []}, ids)
        del embed
    else:
        inps = adapter.embed(params, ids)  # (nsamples, S, D)
    aux = adapter.make_aux(ids.shape[1], inps.dtype, device)

    new_layers, kv_scales_all = [], []
    for li, layer in enumerate(adapter.layers(params)):
        if verbose:
            print(f"[ptq:{arch}] layer {li}")
        laps = _Laps(device) if timings is not None else None
        if offload:
            layer = tree_to(layer, device)
        layer, kv_scales, inps = _calibrate_layer(adapter, layer, inps, aux, qcfg, li, report,
                                                  verbose, laps)
        kv_scales_all.append(kv_scales)
        if laps is not None:
            timings.append({"layer": li, **laps.out})
        new_layers.append(tree_to(layer, "cpu") if offload else layer)

    return PTQResult(params=adapter.rebuild(params, new_layers), kv_scales=kv_scales_all)


class LayerResult(NamedTuple):
    layer: Any  # the block's params, its linears packed
    kv_scales: Optional[KVQuantState]
    outputs: Tensor  # pass 3: the quantized block's outputs, the next block's inputs


def calibrate_layer(layer, inps, cfg, qcfg: QuantConfig, *,
                    arch: str = "llama") -> LayerResult:
    """One block of ``ptq`` on its inputs ``inps`` (nsamples, S, D), on their
    device: what ``ptq`` does for a block when the blocks before it
    produced ``inps``.  Lets two runs be held block by block on the same
    inputs."""
    adapter = get_adapter(arch, cfg)
    aux = adapter.make_aux(inps.shape[1], inps.dtype, inps.device)
    with ieee_matmul(), torch.no_grad():
        return LayerResult(*_calibrate_layer(adapter, layer, inps, aux, qcfg, 0, None, False,
                                             None))


def _calibrate_layer(adapter, layer, inps, aux, qcfg, li, report, verbose, laps):
    """The three passes over one block: (packed layer, kv scales, outputs)."""
    nsamples = inps.shape[0]
    fp_qs = QuantState(actq=False, wtq=False, kv=False)
    kv_on_qs = QuantState(actq=False, wtq=False, kv=True)
    quant_qs = QuantState(actq=qcfg.actq, wtq=qcfg.wtq, kv=True)
    need_hessian = qcfg.wtq and qcfg.wt_quant.method == "gptq"

    # ---- pass 1: stats, one sample at a time ----
    st: Optional[_Pass1State] = None
    for j in range(nsamples):
        _, collect = adapter.block(layer, inps[j:j + 1], aux, fp_qs, None, collect_stats=True)
        st = _merge_pass1(adapter, collect, st, qcfg.meanact)
        del collect

    # ---- transforms ----
    if qcfg.meanact:
        layer = adapter.meanact(layer, st.ch_max, st.ch_min)
    if qcfg.smoothquant:
        layer = adapter.smooth(layer, st.max_absmax)
    kv_scales = adapter.kv_state(st.kv_absmax) if qcfg.kvquant else None
    if laps is not None:
        laps.mark("pass1")

    # ---- pass 2: per-linear absmax (+ Hessian), kv fake-quant live ----
    absmaxes: Dict[str, Tensor] = {}
    hessians: Dict[str, Any] = {}
    last_inputs = None
    for j in range(nsamples):
        _, collect = adapter.block(layer, inps[j:j + 1], aux, kv_on_qs, kv_scales,
                                   collect_stats=True)
        for name, (_, fam) in adapter.linears.items():
            am = torch.amin(_per_sample_channel_absmax(collect[fam]), dim=0)
            prev = absmaxes.get(name)
            absmaxes[name] = am if prev is None else torch.minimum(prev, am)
        if need_hessian:
            for fam in adapter.hessian_fams:
                if fam not in hessians:
                    hessians[fam] = init_hessian(collect[fam].shape[-1], inps.device)
                hessians[fam] = update_hessian(*hessians[fam], collect[fam], batches=1)
        # only the LAST sample's inputs are kept as inp1
        last_inputs = {fam: collect[fam][-1:] for fam in adapter.hessian_fams}
        del collect
    if laps is not None:
        laps.mark("pass2")

    # ---- quantize + pack each linear ----
    layer = copy_tree(layer)
    for name, (path, fam) in adapter.linears.items():
        lin = _get(layer, path)
        inp1 = last_inputs[fam].reshape(-1, last_inputs[fam].shape[-1])
        amax = torch.amax(absmaxes[name]) if qcfg.actq else None
        t0 = time.time()
        packed = _quantize_linear(lin, inp1, hessians.get(fam), qcfg, amax, laps, name)
        if report is not None:
            _report_linear(report, li, name, lin, packed, inp1, amax, t0, verbose)
            if laps is not None:
                laps.mark("report")
        _set(layer, path, packed)
    del hessians, last_inputs

    # ---- pass 3: the quantized block feeds the next ----
    outs = torch.cat([adapter.block(layer, inps[j:j + 1], aux, quant_qs, kv_scales)
                      for j in range(nsamples)])
    if laps is not None:
        laps.mark("pass3")
    return layer, kv_scales, outs


def _report_linear(report, li, name, lin, packed, inp1, amax, t0, verbose):
    from dgq_tpu_torch.utils.metrics import LinearQuantRecord, weight_quant_metrics

    w_fp = lin["weight"].to(torch.float32)
    w_q = dequantize_linear(packed).t()  # (N, K)
    wsnr, osnr = weight_quant_metrics(w_fp, w_q, inp1)
    report.add(LinearQuantRecord(
        layer=li, name=name, weight_error=float(torch.mean((w_q - w_fp) ** 2)),
        weight_snr=wsnr, output_snr=osnr, amax=None if amax is None else float(amax),
        time_s=time.time() - t0), verbose=verbose)


def ptq_llama(params, cfg: LlamaConfig, calib_ids, qcfg: QuantConfig, *,
              verbose: bool = True) -> PTQResult:
    """LLaMA entry point."""
    return ptq(params, cfg, calib_ids, qcfg, arch="llama", verbose=verbose)
