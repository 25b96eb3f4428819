"""Activation fake-quantization functions.

Port of ``dgq_tpu/quant/act_quant.py``: each takes and returns an fp tensor
(math in fp32, the result in the input's dtype); the static variant takes
the calibrated absmax.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def quantize_activation_static(t: Tensor, absmax: Tensor, n_bits: int = 8) -> Tensor:
    """Static per-tensor symmetric."""
    q_max = 2 ** (n_bits - 1) - 1
    scale = torch.as_tensor(absmax, device=t.device).to(torch.float32) / q_max
    tq = torch.clamp(torch.round(t.to(torch.float32) / scale), -q_max, q_max) * scale
    return tq.to(t.dtype)


def quantize_activation_per_token_absmax(t: Tensor, n_bits: int = 8) -> Tensor:
    """Dynamic per-token absmax."""
    q_max = 2 ** (n_bits - 1) - 1
    tf = t.to(torch.float32)
    scales = torch.amax(torch.abs(tf), dim=-1, keepdim=True)
    scales = torch.clamp(scales, min=1e-5) / q_max
    tq = torch.clamp(torch.round(tf / scales), -q_max - 1, q_max) * scales
    return tq.to(t.dtype)


def quantize_activation_per_tensor_absmax(t: Tensor, n_bits: int = 8) -> Tensor:
    """Dynamic per-tensor absmax with the top-10 robust clip: scale =
    min(2 * 10th-largest channel absmax, largest channel absmax)."""
    q_max = 2 ** (n_bits - 1) - 1
    tf = t.to(torch.float32)
    flat = tf.reshape(-1, tf.shape[-1])
    if flat.shape[1] > 10:
        maxs = torch.sort(torch.amax(torch.abs(flat), dim=0)).values
        scale = torch.minimum(maxs[-10] * 2, maxs[-1])
    else:
        scale = torch.amax(torch.abs(flat))
    scale = torch.clamp(scale, min=1e-5) / q_max
    tq = torch.clamp(torch.round(tf / scale), -q_max - 1, q_max) * scale
    return tq.to(t.dtype)


def quantize_activation_per_tensor_asym(t: Tensor, n_bits: int = 8) -> Tensor:
    """Dynamic per-tensor asymmetric, skipping the first 3 rows when there
    are more than 10 (the BOS-outlier heuristic)."""
    q_max = 2**n_bits - 1
    tf = t.to(torch.float32)
    flat = tf.reshape(-1, tf.shape[-1])
    rows = flat[3:] if flat.shape[0] > 10 else flat
    minv, maxv = torch.amin(rows), torch.amax(rows)
    scale = torch.clamp(maxv - minv, min=1e-5) / q_max
    tq = torch.clamp(torch.round((tf - minv) / scale), 0, q_max) * scale + minv
    return tq.to(t.dtype)


def make_act_quant_fn(method: Optional[str], n_bits: int = 8) -> Callable:
    """Dispatch on the method name; every variant takes (t, absmax), the
    dynamic ones ignoring absmax, so call sites are uniform."""
    if method is None:
        return lambda t, absmax=None: t
    if method == "static":
        return lambda t, absmax: quantize_activation_static(t, absmax, n_bits)
    if method == "per_tensor":
        return lambda t, absmax=None: quantize_activation_per_tensor_absmax(t, n_bits)
    if method == "per_token":
        return lambda t, absmax=None: quantize_activation_per_token_absmax(t, n_bits)
    if method == "per_tensor_asym":
        return lambda t, absmax=None: quantize_activation_per_tensor_asym(t, n_bits)
    raise NotImplementedError(method)
