"""Quantization observability: SNR metrics and per-linear reporting.

Port of ``dgq_tpu/utils/metrics.py``: ``snr_error``, the per-linear record
calibration emits (``ptq(report=...)``), the report that gathers them and
``weight_quant_metrics``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def snr_error(y_pred: Tensor, y_real: Tensor, reduction: str = "mean") -> Tensor:
    """||y_pred - y_real||^2 / ||y_real||^2 per first-dim sample; lower is
    better, 0 identical."""
    yp = y_pred.to(torch.float32).reshape(y_pred.shape[0], -1)
    yr = y_real.to(torch.float32).reshape(y_real.shape[0], -1)
    noise = torch.sum((yp - yr) ** 2, dim=1)
    signal = torch.sum(yr**2, dim=1)
    ratio = noise / torch.clamp(signal, min=1e-20)
    if reduction == "mean":
        return torch.mean(ratio)
    if reduction == "sum":
        return torch.sum(ratio)
    return ratio


@dataclasses.dataclass
class LinearQuantRecord:
    layer: int
    name: str
    weight_error: float  # GPTQ loss or weight MSE
    weight_snr: float  # ||w_q - w||^2 / ||w||^2
    output_snr: Optional[float]  # layer-output SNR on calib inp1
    amax: Optional[float]
    time_s: float

    def row(self) -> str:
        osnr = "-" if self.output_snr is None else f"{self.output_snr:.3e}"
        amax = "-" if self.amax is None else f"{self.amax:.3f}"
        return (f"L{self.layer:<3d} {self.name:<16s} werr={self.weight_error:.4e} "
                f"wSNR={self.weight_snr:.3e} outSNR={osnr} amax={amax} t={self.time_s:.2f}s")


@dataclasses.dataclass
class QuantReport:
    records: List[LinearQuantRecord] = dataclasses.field(default_factory=list)

    def add(self, rec: LinearQuantRecord, verbose: bool = True):
        self.records.append(rec)
        if verbose:
            print("[quant] " + rec.row())

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(r) for r in self.records], indent=1)

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        return {
            "mean_weight_snr": float(np.mean([r.weight_snr for r in self.records])),
            "max_weight_snr": float(np.max([r.weight_snr for r in self.records])),
            "mean_output_snr": float(np.mean(
                [r.output_snr for r in self.records if r.output_snr is not None] or [0])),
            "total_time_s": float(np.sum([r.time_s for r in self.records])),
            "n_linears": len(self.records),
        }


def weight_quant_metrics(w_fp: Tensor, w_q: Tensor, inp1: Optional[Tensor] = None):
    """(weight_snr, output_snr) of a quantized linear."""
    wsnr = float(snr_error(w_q[None], w_fp[None]))
    osnr = None
    if inp1 is not None:
        inp1 = inp1.to(torch.float32)
        osnr = float(snr_error(torch.matmul(inp1, w_q.t())[None],
                               torch.matmul(inp1, w_fp.t())[None]))
    return wsnr, osnr
