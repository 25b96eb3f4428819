"""Quantization configuration.

Port of ``dgq_tpu/config.py``: the PTQ knobs as validated frozen dataclasses,
kept 1:1 with the CLI (wbits, abits, groupsize, act method, weight method
naive/search/gptq, w4w8, smoothquant, meanact, kvquant, and the GPTQ knobs
percdamp and act_order), with the same validation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

ACT_METHODS = ("static", "per_tensor", "per_token", "per_tensor_asym")
WT_METHODS = ("naive", "search", "gptq")


@dataclasses.dataclass(frozen=True)
class ActQuantConfig:
    """Activation quantization."""

    bits: int = 8
    method: str = "static"

    def __post_init__(self):
        if self.method not in ACT_METHODS:
            raise ValueError(f"act method {self.method!r} not in {ACT_METHODS}")
        if self.bits not in (8, 16):
            raise ValueError(f"abits must be 8 or 16, got {self.bits}")


@dataclasses.dataclass(frozen=True)
class WtQuantConfig:
    """Weight quantization."""

    bits: int = 4
    method: str = "search"
    groupsize: int = 128  # -1 => one group per full input row
    w4w8: bool = True  # dual-grained: int8 group scale x fp per-channel scale
    # w4w8 fallback (BASELINE config 3): when the dual-grained int8-scale
    # constraint degrades a linear's layer-output error by more than this
    # factor over the plain fp-group-scale quantization, that linear is
    # packed with fp scales instead (served by the fp-group-scale GEMM).
    # None disables the check (all layers dual-grained).
    w4w8_fallback_ratio: Optional[float] = None
    # GPTQ-only knobs:
    percdamp: float = 0.01
    act_order: bool = False

    def __post_init__(self):
        if self.method not in WT_METHODS:
            raise ValueError(f"wt method {self.method!r} not in {WT_METHODS}")
        if self.bits not in (2, 3, 4, 8, 16):
            raise ValueError(f"wbits must be in (2,3,4,8,16), got {self.bits}")
        if self.w4w8 and self.bits != 4:
            raise ValueError("w4w8 dual-grained packing requires wbits=4")
        if self.groupsize != -1 and self.groupsize <= 0:
            raise ValueError("groupsize must be positive or -1")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Full quantization config."""

    act_quant: Optional[ActQuantConfig] = ActQuantConfig()
    wt_quant: Optional[WtQuantConfig] = WtQuantConfig()
    smoothquant: bool = True
    meanact: bool = False
    kvquant: bool = True
    nsamples: int = 32
    seqlen: int = 2048

    @property
    def actq(self) -> bool:
        return self.act_quant is not None

    @property
    def wtq(self) -> bool:
        return self.wt_quant is not None

    def groupsize_for(self, in_features: int) -> int:
        g = self.wt_quant.groupsize
        return in_features if g == -1 else g


def default_w4a8_config(**overrides) -> QuantConfig:
    """The canonical DGQ run: W4A8 g128 search + w4w8 + smooth + kvquant."""
    return dataclasses.replace(QuantConfig(), **overrides)
