"""Real-quant INT8-dataflow Mixtral (sparse-MoE) engine on one NVIDIA GPU.

Port of ``dgq_tpu/models/mixtral_engine.py`` without ``from_ptq_mixtral``,
which comes with the PTQ pipeline.  The attention half is the LLaMA
engine's dataflow: RMSNormQ -> the fused q|k|v (f32 out) -> fp RoPE ->
requant into the INT8 KV cache (K transposed) -> K3 at one token a slot
(K7 past the decode chunk, ``auto_decode_chunk``), K2 for windows of more
than 8 tokens on a cache of a multiple of 128 positions (the query window
padded to 128 rows), plain ops otherwise, fp p @ V everywhere (this family
has no quant_pv) -> requant (clamp -127) -> o_proj.  The MLP half is the
sparse MoE block (``_moe_tail``): one RMSNormQ whose codes every expert
takes, an fp32 router on the dequantised codes (clamped to [-127, 127], as
the fake-quant path routes), top-k routing (``models/mixtral.route_topk``),
and the experts computed dense over E (SwiGLU, each with its own w2
requant scale), combined with the routing mask.

Every linear runs K9 (``w4a8_matmul_packed``) on span storage, or K10
(``w4a8_fpscale_matmul_packed``) under ``fp_scales`` (the w4w8-fallback
representation: fp32 group scales).  Parameters keep the JAX layout
(layers stacked on a leading L axis, the experts' linears on (L, E, ...)),
so checkpoints and caches compare directly.  The cache is written in
place, as in the other engines.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from dgq_tpu_torch.models.engine import EngineLinear, _attention_scores, _linear_s8, _requant, \
    _rms_norm_q, map_tensors, write_window
from dgq_tpu_torch.models.llama import rms_norm, rope_cos_sin, rotate_half
from dgq_tpu_torch.models.mixtral import MixtralConfig, route_topk
from dgq_tpu_torch.ops.attention import (
    NEG,
    auto_decode_chunk,
    f32,
    int8_decode_attention,
    int8_decode_attention_chunked,
    int8_prefill_attention,
)

Tensor = torch.Tensor


class MixtralEngineLayer(NamedTuple):
    """One Mixtral engine layer (stacked: every tensor has a leading L axis;
    ``w13`` and ``w2`` lead with (L, E)).  A ``layer_list`` view holds one
    layer, its ``w13`` and ``w2`` a list of the E experts' linears."""

    ln1_weight: Tensor  # (D,) f32, / attn_input_scale
    ln1_bias: Optional[Tensor]
    ln2_weight: Tensor  # (D,) f32, / moe_input_scale
    ln2_bias: Optional[Tensor]
    qkv_proj: EngineLinear  # fused q|k|v
    o_proj: EngineLinear
    gate_weight: Tensor  # (E, D) f32 router (never quantised)
    gate_bias: Optional[Tensor]  # (E,)
    w13: EngineLinear  # the experts' fused w1|w3, leaves (E, ...)
    w2: EngineLinear  # leaves (E, ...)
    q_scale: Tensor
    k_scale: Tensor
    v_scale: Tensor
    out_input_scale: Tensor
    moe_input_scale: Tensor  # () the router input's dequant scale
    w2_input_scale: Tensor  # (E,) per-expert requant scales


@dataclasses.dataclass
class MixtralEngineParams:
    embed_tokens: Tensor  # (V, D)
    layers: MixtralEngineLayer  # stacked
    norm_weight: Tensor
    lm_head: Tensor  # (V, D)

    @functools.cached_property
    def layer_list(self) -> List[MixtralEngineLayer]:
        """Per-layer views of the stacked layers, each expert's linears split
        out into lists, made once."""
        n, e = self.layers.ln1_weight.shape[0], self.layers.w13.alpha.shape[1]
        out = []
        for i in range(n):
            lay = map_tensors(lambda t, i=i: t[i], self.layers)
            out.append(lay._replace(
                w13=[map_tensors(lambda t, j=j: t[j], lay.w13) for j in range(e)],
                w2=[map_tensors(lambda t, j=j: t[j], lay.w2) for j in range(e)]))
        return out


class MixtralKVCache(NamedTuple):
    k: Tensor  # (L, B, Hkv, Dh, Smax) int8, K stored transposed
    v: Tensor  # (L, B, Hkv, Smax, Dh) int8
    length: int  # tokens already cached


def init_mixtral_kv_cache(cfg: MixtralConfig, batch: int, max_len: int,
                          device="cuda") -> MixtralKVCache:
    n, hk, dh = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    return MixtralKVCache(
        k=torch.zeros((n, batch, hk, dh, max_len), dtype=torch.int8, device=device),
        v=torch.zeros((n, batch, hk, max_len, dh), dtype=torch.int8, device=device),
        length=0,
    )


@dataclasses.dataclass(frozen=True)
class MixtralEngineConfig:
    """Static knobs of the Mixtral forward (the JAX fields this port honours;
    the device of the parameters takes the place of ``use_kernel``)."""

    cfg: MixtralConfig
    # fp-scale linears (the w4w8-fallback representation): every linear runs K10
    fp_scales: bool = False
    # decode attention: -1 (AUTO) K3 up to Smax 8192 and K7 beyond (auto_decode_chunk); > 0
    # forces K7 with chunks of that size wherever Smax exceeds it; 0 never chunks
    decode_attn_chunk: int = -1
    kv_bits: int = 8
    ep_axis: Optional[str] = None
    tp_axis: Optional[str] = None

    def __post_init__(self):
        if self.kv_bits != 8:
            raise NotImplementedError("the Mixtral engine: an INT8 KV cache only (kv_bits=8), "
                                      "as JAX's")
        if self.ep_axis is not None or self.tp_axis is not None:
            raise NotImplementedError("expert and tensor parallelism (ep_axis, tp_axis) are not "
                                      "ported yet (ROADMAP Queue 1 item 7)")


def _moe_tail(ecfg: MixtralEngineConfig, layer: MixtralEngineLayer, x: Tensor) -> Tensor:
    """The sparse MoE MLP of a ``layer_list`` view on int8 dataflow: one
    RMSNormQ, the fp32 router on max(codes, -127) x moe_input_scale (plus
    its bias), top-k routing, every expert dense (w1|w3 -> SiLU x up ->
    requant at the expert's w2 scale -> w2) weighted by its routing mass,
    then the residual."""
    cfg = ecfg.cfg
    kw = dict(fp_scales=ecfg.fp_scales)
    x_s8 = _rms_norm_q(x, layer.ln2_weight, cfg.rms_norm_eps, layer.ln2_bias)
    xf = torch.clamp(x_s8, min=-127).to(torch.float32) * layer.moe_input_scale
    router_logits = torch.matmul(xf, layer.gate_weight.t())
    if layer.gate_bias is not None:
        router_logits = router_logits + layer.gate_bias
    topw, topi = route_topk(router_logits, cfg.num_experts_per_tok)
    experts = torch.arange(len(layer.w13), device=x.device)
    # each expert's routing mass, (..., E): sum over k of topw where topi == e, as JAX's
    mass = torch.sum(topw[..., None, :] * (topi[..., None, :] == experts[:, None]).to(topw.dtype),
                     dim=-1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e, (w13, w2) in enumerate(zip(layer.w13, layer.w2)):
        gu = _linear_s8(w13, x_s8, **kw)
        f = gu.shape[-1] // 2
        h_s8 = _requant(torch.nn.functional.silu(gu[..., :f]) * gu[..., f:],
                        layer.w2_input_scale[e])
        out = out + mass[..., e:e + 1] * _linear_s8(w2, h_s8, **kw)
    return x + out


def mixtral_qkv(ecfg: MixtralEngineConfig, layer: MixtralEngineLayer, x: Tensor,
                cos: Tensor, sin: Tensor):
    """RMSNormQ and the fused q|k|v of (B, S, D) activations, fp RoPE at
    ``cos``/``sin`` (broadcasting against (B, H, S, Dh)), requantised -> q
    (B, H, S, Dh), k and v (B, Hkv, S, Dh) int8."""
    cfg = ecfg.cfg
    b, s, _ = x.shape
    dh = cfg.head_dim
    x_s8 = _rms_norm_q(x, layer.ln1_weight, cfg.rms_norm_eps, layer.ln1_bias)
    qkv = _linear_s8(layer.qkv_proj, x_s8, fp_scales=ecfg.fp_scales)
    rep = cfg.num_attention_heads // cfg.num_key_value_heads
    hk = qkv.shape[-1] // dh // (rep + 2)
    h = rep * hk
    q, k, v = torch.split(qkv, [h * dh, hk * dh, hk * dh], dim=-1)
    q = q.reshape(b, s, h, dh).transpose(1, 2)
    k = k.reshape(b, s, hk, dh).transpose(1, 2)
    v = v.reshape(b, s, hk, dh).transpose(1, 2)
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    return (_requant(q, layer.q_scale).contiguous(), _requant(k, layer.k_scale),
            _requant(v, layer.v_scale))


def mixtral_tail(ecfg: MixtralEngineConfig, layer: MixtralEngineLayer, x: Tensor,
                 ctx: Tensor) -> Tensor:
    """The block after attention: requant (clamp -127) -> o_proj ->
    residual -> ``_moe_tail``."""
    ctx_s8 = _requant(ctx, layer.out_input_scale, qmin=-127.0)
    x = x + _linear_s8(layer.o_proj, ctx_s8, fp_scales=ecfg.fp_scales)
    return _moe_tail(ecfg, layer, x)


def _mixtral_block(ecfg: MixtralEngineConfig, layer: MixtralEngineLayer, x: Tensor,
                   k_cache: Tensor, v_cache: Tensor, cache_len: int, pos_cos: Tensor,
                   pos_sin: Tensor, mask: Optional[Tensor]) -> Tensor:
    """One decoder block on (B, S, D) fp32 activations; writes the S new
    tokens' int8 K/V into the caches at [cache_len, cache_len + S)."""
    b, s, _ = x.shape
    q_s8, k_s8, v_s8 = mixtral_qkv(ecfg, layer, x, pos_cos[None, None], pos_sin[None, None])
    h, dh = q_s8.shape[1], q_s8.shape[3]
    hk = k_s8.shape[1]
    write_window(k_cache, k_s8.transpose(2, 3), cache_len, 3)
    write_window(v_cache, v_s8, cache_len, 2)
    smax = k_cache.shape[-1]
    if s == 1:
        chunk = ecfg.decode_attn_chunk
        if chunk < 0:  # AUTO: the chunked kernel once Smax outgrows 8k
            chunk = auto_decode_chunk(smax)
        args = (q_s8[:, :, 0, :], k_cache, v_cache, cache_len + 1, layer.q_scale,
                layer.k_scale, layer.v_scale)
        if chunk and smax > chunk:
            ctx = int8_decode_attention_chunked(*args, chunk=chunk)
        else:
            ctx = int8_decode_attention(*args)
        ctx = ctx.reshape(b, 1, h * dh)
    elif s > 8 and smax % 128 == 0:
        # the query window is padded to 128 rows; pad rows attend to valid keys only and are
        # sliced off
        sp = -(-s // 128) * 128
        qp = torch.nn.functional.pad(q_s8, (0, 0, 0, sp - s)).contiguous()
        ctx = int8_prefill_attention(qp, k_cache, v_cache, cache_len + s, layer.q_scale,
                                     layer.k_scale, layer.v_scale, cache_len)
        ctx = ctx[:, :, :s].transpose(1, 2).reshape(b, s, h * dh)
    else:  # plain materialised attention, as JAX runs outside its kernels
        scores = _attention_scores(q_s8.reshape(b, hk, (h // hk) * s, dh), k_cache,
                                   layer.q_scale, layer.k_scale, dh)
        scores = scores.reshape(b, hk, h // hk, s, smax) + mask[None, None, None]
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs, (v_cache.to(torch.float32) * layer.v_scale)[:, :, None])
        ctx = ctx.permute(0, 3, 1, 2, 4).reshape(b, s, h * dh)
    return mixtral_tail(ecfg, layer, x, ctx)


def mixtral_engine_forward(ecfg: MixtralEngineConfig, params: MixtralEngineParams,
                           input_ids: Tensor, cache: MixtralKVCache, *,
                           window: str = "auto") -> Tuple[Tensor, MixtralKVCache]:
    """Prefill or decode step: runs S tokens starting at cache.length.

    Returns (logits (B, S, V) f32, cache advanced by S).  ``window`` is
    accepted for the forward contract of the LLaMA engine; this family
    applies fp p @ V everywhere, so it does not alter numerics.  Runs on the
    device of the parameters."""
    cfg = ecfg.cfg
    dev = params.embed_tokens.device
    input_ids = input_ids.to(dev)
    b, s = input_ids.shape
    smax = cache.k.shape[4]
    if cache.length + s > smax:
        raise ValueError(f"cache overflow: {cache.length} + {s} > {smax}")
    x = params.embed_tokens[input_ids.long()].to(torch.float32)
    positions = cache.length + torch.arange(s, device=dev)
    pos_cos, pos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    j = torch.arange(smax, device=dev)[None, :]
    mask = torch.where(j <= positions[:, None], f32(0.0, dev), f32(NEG, dev))
    for li, layer in enumerate(params.layer_list):
        x = _mixtral_block(ecfg, layer, x, cache.k[li], cache.v[li], cache.length, pos_cos,
                           pos_sin, mask)
    x = rms_norm(x, params.norm_weight.to(x.dtype), cfg.rms_norm_eps)
    logits = torch.matmul(x, params.lm_head.to(x.dtype).t())
    return logits, cache._replace(length=cache.length + s)
