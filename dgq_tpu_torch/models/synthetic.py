"""Synthetic (random-weight) engines at real model shapes.

Port of ``dgq_tpu/models/synthetic.py:18-76``: the same value ranges and the
same rowpair-only storage, drawn from a ``torch.Generator`` on the target
device (so the bits differ from JAX's).  Scales are drawn from [1, 4) and
zeros from [4, 12), so (c - z) * s fits int8 by construction.
"""

from __future__ import annotations

import torch

from dgq_tpu_torch.models.engine import EngineLayer, EngineLinear, EngineParams
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.ops.fused_decode import rowpair_cs_fold_rp


def random_engine_linear(gen: torch.Generator, n_out: int, n_in: int, g: int = 128,
                         device="cuda") -> EngineLinear:
    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8, device=device)

    qw_rp = randint(-128, 128, (n_in // 2, n_out))
    ws = randint(1, 4, (n_in // g, n_out))
    wz = randint(4, 12, (n_in // g, n_out))
    return EngineLinear(
        qweight=None,
        wscales=torch.repeat_interleave(ws, 8, dim=0),
        wzeros=torch.repeat_interleave(wz, 8, dim=0),
        alpha=torch.full((n_out,), 1e-4, dtype=torch.float32, device=device),
        bias=None,
        s_hi=ws[0::2].contiguous(),
        s_lo=ws[1::2].contiguous(),
        z_hi=wz[0::2].contiguous(),
        z_lo=wz[1::2].contiguous(),
        qw_rp=qw_rp,
        cs_fold=rowpair_cs_fold_rp(qw_rp, g, ws[0::2], ws[1::2]),
    )


def build_llama_engine(cfg: LlamaConfig, seed: int = 0, device="cuda") -> EngineParams:
    """Random engine params at cfg's exact shapes, the MLP dim padded to a
    multiple of 1024 as engine conversion pads it."""
    d, f = cfg.hidden_size, -(-cfg.intermediate_size // 1024) * 1024
    nq = cfg.num_attention_heads * cfg.head_dim
    nkv = cfg.num_key_value_heads * cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def scalar(v):
        return torch.full((), v, dtype=torch.float32, device=device)

    per_layer = []
    for _ in range(cfg.num_hidden_layers):
        per_layer.append(EngineLayer(
            ln1_weight=torch.full((d,), 10.0, dtype=torch.float32, device=device),
            ln1_bias=None,
            ln2_weight=torch.full((d,), 10.0, dtype=torch.float32, device=device),
            ln2_bias=None,
            qkv_proj=random_engine_linear(gen, nq + 2 * nkv, d, device=device),
            o_proj=random_engine_linear(gen, d, nq, device=device),
            gate_up_proj=random_engine_linear(gen, 2 * f, d, device=device),
            down_proj=random_engine_linear(gen, d, f, device=device),
            q_scale=scalar(0.05),
            k_scale=scalar(0.05),
            v_scale=scalar(0.05),
            out_input_scale=scalar(0.05),
            down_input_scale=scalar(0.05),
        ))
    stacked = _stack(per_layer)
    del per_layer

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).to(torch.bfloat16) * 0.02

    return EngineParams(
        embed_tokens=normal((cfg.vocab_size, d)),
        layers=stacked,
        norm_weight=torch.ones((d,), dtype=torch.float32, device=device),
        lm_head=normal((cfg.vocab_size, d)),
        rms_eps=cfg.rms_norm_eps,
    )


def _stack(trees):
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*(_stack([t[i] for t in trees]) for i in range(len(first))))
