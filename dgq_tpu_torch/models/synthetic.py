"""Synthetic (random-weight) engines at real model shapes.

Port of ``dgq_tpu/models/synthetic.py:18-76`` (the LLaMA engine: rowpair-only
storage, or with ``keep_span`` span codes beside the rowpair copy derived
from them) and of ``build_opt_engine`` in ``scripts/bench_decode_opt.py:27-75``
(the OPT engine, span-only storage), with the same value ranges, plus an
fp-scale LLaMA engine (span storage, fp32 group scales and zeros, the
w4w8-fallback representation) and the BLOOM and MPT engines (span-only
storage as OPT's, their fused q|k|v's alpha carrying each part's own output
scale as ``from_ptq_bloom``/``from_ptq_mpt`` fold it), and the Falcon and
Mixtral engines (span-only storage, the Mixtral experts' linears stacked on
(L, E), drawn into tensors made once: Mixtral-8x7B's 29 GB would not stand
a stacking copy).  Every layer is drawn on its own from a
``torch.Generator`` on the target device (so the bits differ from JAX's).
Scales are drawn from [1, 4) and zeros from [4, 12), so (c - z) * s fits
int8 by construction; the fp-scale engine multiplies the integer scale by a
per-channel fp32 factor in [0.5, 1), so |(c - z) * s| stays below 128.
"""

from __future__ import annotations

import itertools

import torch

from dgq_tpu_torch.models.engine import EngineLayer, EngineLinear, EngineParams
from dgq_tpu_torch.models.bloom import BloomConfig
from dgq_tpu_torch.models.bloom_engine import BloomEngineLayer, BloomEngineParams
from dgq_tpu_torch.models.falcon import FalconConfig
from dgq_tpu_torch.models.falcon_engine import FalconEngineLayer, FalconEngineParams
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.models.mixtral import MixtralConfig
from dgq_tpu_torch.models.mixtral_engine import MixtralEngineLayer, MixtralEngineParams
from dgq_tpu_torch.models.mpt import MPTConfig
from dgq_tpu_torch.models.mpt_engine import MPTEngineLayer, MPTEngineParams
from dgq_tpu_torch.models.opt import OPTConfig
from dgq_tpu_torch.models.opt_engine import OPTEngineLayer, OPTEngineParams
from dgq_tpu_torch.ops.fused_decode import pack_rowpair_s4, rowpair_cs_fold, rowpair_cs_fold_rp


def random_engine_linear(gen: torch.Generator, n_out: int, n_in: int, g: int = 128,
                         device="cuda", keep_span: bool = False) -> EngineLinear:
    """Rowpair codes with compact plane rows; ``keep_span``: the drawn bytes
    are span codes, kept, and the rowpair copy is derived from them."""
    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8, device=device)

    packed = randint(-128, 128, (n_in // 2, n_out))
    ws = randint(1, 4, (n_in // g, n_out))
    wz = randint(4, 12, (n_in // g, n_out))
    if keep_span:
        qweight, qw_rp = packed, pack_rowpair_s4(packed, 2 * g)
        cs_fold = rowpair_cs_fold(packed, 2 * g, ws[0::2], ws[1::2])
    else:
        qweight, qw_rp = None, packed
        cs_fold = rowpair_cs_fold_rp(qw_rp, g, ws[0::2], ws[1::2])
    return EngineLinear(
        qweight=qweight,
        wscales=torch.repeat_interleave(ws, 8, dim=0),
        wzeros=torch.repeat_interleave(wz, 8, dim=0),
        alpha=torch.full((n_out,), 1e-4, dtype=torch.float32, device=device),
        bias=None,
        s_hi=ws[0::2].contiguous(),
        s_lo=ws[1::2].contiguous(),
        z_hi=wz[0::2].contiguous(),
        z_lo=wz[1::2].contiguous(),
        qw_rp=qw_rp,
        cs_fold=cs_fold,
    )


def random_span_linear(gen: torch.Generator, n_out: int, n_in: int, g: int = 128,
                       device="cuda", fp_scales: bool = False, bias: bool = False) -> EngineLinear:
    """Span-only storage (no rowpair copy, no plane rows): int8 group scales
    and zeros (K9), or fp32 ones for ``fp_scales`` (K10)."""
    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8, device=device)

    qweight = randint(-128, 128, (n_in // 2, n_out))
    ws = randint(1, 4, (n_in // g, n_out))
    wz = randint(4, 12, (n_in // g, n_out))
    if fp_scales:  # int scale x per-channel fp factor, integer-valued fp zeros
        s8 = torch.rand((n_out,), generator=gen, device=device) * 0.5 + 0.5
        ws, wz = ws.to(torch.float32) * s8, wz.to(torch.float32)
    return EngineLinear(
        qweight=qweight,
        wscales=torch.repeat_interleave(ws, 8, dim=0),
        wzeros=torch.repeat_interleave(wz, 8, dim=0),
        alpha=torch.full((n_out,), 1e-4, dtype=torch.float32, device=device),
        bias=torch.zeros((n_out,), dtype=torch.float32, device=device) if bias else None,
    )


def _scalar(v, device):
    return torch.full((), v, dtype=torch.float32, device=device)


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(torch.bfloat16) * 0.02


def build_llama_engine(cfg: LlamaConfig, seed: int = 0, device="cuda",
                       fp_scales: bool = False, keep_span: bool = False) -> EngineParams:
    """Random engine params at cfg's exact shapes, the MLP dim padded to a
    multiple of 1024 as engine conversion pads it.  ``fp_scales``: span
    storage with fp32 group scales, run with ``EngineConfig(fp_scales=True)``.
    ``keep_span`` (JAX's argument): span codes and plane rows beside the
    rowpair copy derived from them; with ``qw_rp`` and ``cs_fold`` set to
    None the engine is span-only and fused decode runs K12."""
    d, f = cfg.hidden_size, -(-cfg.intermediate_size // 1024) * 1024
    nq = cfg.num_attention_heads * cfg.head_dim
    nkv = cfg.num_key_value_heads * cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def lin(n_out, n_in):
        if fp_scales:
            return random_span_linear(gen, n_out, n_in, device=device, fp_scales=True)
        return random_engine_linear(gen, n_out, n_in, device=device, keep_span=keep_span)

    per_layer = []
    for _ in range(cfg.num_hidden_layers):
        per_layer.append(EngineLayer(
            ln1_weight=torch.full((d,), 10.0, dtype=torch.float32, device=device),
            ln1_bias=None,
            ln2_weight=torch.full((d,), 10.0, dtype=torch.float32, device=device),
            ln2_bias=None,
            qkv_proj=lin(nq + 2 * nkv, d),
            o_proj=lin(d, nq),
            gate_up_proj=lin(2 * f, d),
            down_proj=lin(d, f),
            q_scale=_scalar(0.05, device),
            k_scale=_scalar(0.05, device),
            v_scale=_scalar(0.05, device),
            out_input_scale=_scalar(0.05, device),
            down_input_scale=_scalar(0.05, device),
        ))
    stacked = _stack(per_layer)
    del per_layer
    return EngineParams(
        embed_tokens=_normal(gen, (cfg.vocab_size, d), device),
        layers=stacked,
        norm_weight=torch.ones((d,), dtype=torch.float32, device=device),
        lm_head=_normal(gen, (cfg.vocab_size, d), device),
        rms_eps=cfg.rms_norm_eps,
    )


def build_opt_engine(cfg: OPTConfig, seed: int = 0, device="cuda") -> OPTEngineParams:
    """Random OPT engine params at cfg's exact shapes, every layer drawn on
    its own: span-only linears with zero fp32 biases (so K9's epilogue adds
    one), the LayerNorms pre-scaled by 10, static scales 0.05, and bf16
    embeddings, positions and lm_head."""
    d, f = cfg.hidden_size, cfg.ffn_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def vec(v):
        return torch.full((d,), v, dtype=torch.float32, device=device)

    per_layer = []
    for _ in range(cfg.num_hidden_layers):
        per_layer.append(OPTEngineLayer(
            ln1_weight=vec(10.0),
            ln1_bias=vec(0.0),
            qkv_proj=random_span_linear(gen, 3 * d, d, device=device, bias=True),
            out_proj=random_span_linear(gen, d, d, device=device, bias=True),
            ln2_weight=vec(10.0),
            ln2_bias=vec(0.0),
            fc1=random_span_linear(gen, f, d, device=device, bias=True),
            fc2=random_span_linear(gen, d, f, device=device, bias=True),
            q_scale=_scalar(0.05, device),
            k_scale=_scalar(0.05, device),
            v_scale=_scalar(0.05, device),
            out_input_scale=_scalar(0.05, device),
            fc2_input_scale=_scalar(0.05, device),
        ))
    stacked = _stack(per_layer)
    del per_layer
    return OPTEngineParams(
        embed_tokens=_normal(gen, (cfg.vocab_size, d), device),
        embed_positions=_normal(gen, (cfg.max_position_embeddings + 2, d), device),
        layers=stacked,
        final_ln_weight=vec(1.0),
        final_ln_bias=vec(0.0),
        lm_head=_normal(gen, (cfg.vocab_size, d), device),
    )


# the ALiBi engines' static q, k and v scales: three values, so that the fused q|k|v's alpha
# differs by part
QKV_SCALES = (0.05, 0.04, 0.06)


def _qkv_alpha(h: int, dh: int, interleaved: bool, device) -> torch.Tensor:
    """A fused q|k|v's alpha, 5e-6 (input scale x weight scale) over each
    channel's output scale: interleaved (h, 3, dh) channels (BLOOM) or
    concatenated [q | k | v] (MPT)."""
    parts = torch.tensor(QKV_SCALES, dtype=torch.float32, device=device)
    per_channel = (parts.repeat_interleave(dh).repeat(h) if interleaved
                   else parts.repeat_interleave(h * dh))
    return torch.full_like(per_channel, 5e-6) / per_channel


def _family_layer(cls, gen, d: int, f: int, h: int, dh: int, interleaved: bool, bias: bool,
                  device):
    """One BLOOM or MPT layer (``cls``'s fields in order): LayerNorms pre-scaled
    by 10, span-only linears (zero fp32 biases where ``bias``), static
    scales QKV_SCALES and 0.05."""
    def vec(v):
        return torch.full((d,), v, dtype=torch.float32, device=device)

    qkv = random_span_linear(gen, 3 * d, d, device=device, bias=bias)
    qkv = qkv._replace(alpha=_qkv_alpha(h, dh, interleaved, device))
    q, k, v = (_scalar(x, device) for x in QKV_SCALES)
    return cls(vec(10.0), vec(0.0), qkv, random_span_linear(gen, d, d, device=device, bias=bias),
               vec(10.0), vec(0.0), random_span_linear(gen, f, d, device=device, bias=bias),
               random_span_linear(gen, d, f, device=device, bias=bias), q, k, v,
               _scalar(0.05, device), _scalar(0.05, device))


def build_bloom_engine(cfg: BloomConfig, seed: int = 0, device="cuda") -> BloomEngineParams:
    """Random BLOOM engine params at cfg's exact shapes (the MLP 4 x hidden),
    every layer drawn on its own, as ``build_opt_engine``'s: linears with
    zero biases, bf16 embeddings and lm_head, unit embedding and final
    LayerNorms."""
    d, h, dh = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    layers = _stack([_family_layer(BloomEngineLayer, gen, d, 4 * d, h, dh, True, True, device)
                     for _ in range(cfg.num_hidden_layers)])
    ones = torch.ones((d,), dtype=torch.float32, device=device)
    return BloomEngineParams(
        embed_tokens=_normal(gen, (cfg.vocab_size, d), device),
        emb_ln_weight=ones, emb_ln_bias=torch.zeros_like(ones), layers=layers,
        ln_f_weight=ones.clone(), ln_f_bias=torch.zeros_like(ones),
        lm_head=_normal(gen, (cfg.vocab_size, d), device),
    )


def build_mpt_engine(cfg: MPTConfig, seed: int = 0, device="cuda") -> MPTEngineParams:
    """Random MPT engine params at cfg's exact shapes, as ``build_bloom_engine``
    draws them, with bias-free linears (MPT's no_bias) and no embedding
    LayerNorm."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    layers = _stack([_family_layer(MPTEngineLayer, gen, d, cfg.ffn_dim, h, dh, False,
                                   not cfg.no_bias, device) for _ in range(cfg.n_layers)])
    ones = torch.ones((d,), dtype=torch.float32, device=device)
    return MPTEngineParams(
        embed_tokens=_normal(gen, (cfg.vocab_size, d), device), layers=layers,
        norm_f_weight=ones, norm_f_bias=torch.zeros_like(ones),
        lm_head=_normal(gen, (cfg.vocab_size, d), device),
    )


def span_stack(gen: torch.Generator, lead: tuple, n_out: int, n_in: int, g: int = 128,
               device="cuda", fp_scales: bool = False) -> EngineLinear:
    """Span-only linears stacked on the leading dims ``lead`` (e.g. (L, E)),
    each drawn as ``random_span_linear`` draws one, into tensors made once."""
    dt = torch.float32 if fp_scales else torch.int8
    qweight = torch.empty((*lead, n_in // 2, n_out), dtype=torch.int8, device=device)
    wscales = torch.empty((*lead, 8 * (n_in // g), n_out), dtype=dt, device=device)
    wzeros = torch.empty_like(wscales)
    for idx in itertools.product(*(range(n) for n in lead)):
        lin = random_span_linear(gen, n_out, n_in, g, device, fp_scales)
        qweight[idx].copy_(lin.qweight)
        wscales[idx].copy_(lin.wscales)
        wzeros[idx].copy_(lin.wzeros)
        del lin
    return EngineLinear(qweight=qweight, wscales=wscales, wzeros=wzeros,
                        alpha=torch.full((*lead, n_out), 1e-4, dtype=torch.float32,
                                         device=device), bias=None)


def _full(shape, v, device):
    return torch.full(shape, v, dtype=torch.float32, device=device)


def build_falcon_engine(cfg: FalconConfig, seed: int = 0, device="cuda",
                        groupsize: int = 32) -> FalconEngineParams:
    """Random Falcon engine params at cfg's exact shapes (the MLP 4 x hidden):
    bias-free span linears query_key_value, dense, dense_h_to_4h and
    dense_4h_to_h at ``groupsize`` (32 at Falcon-7B's hidden 4544 = 71 x 64:
    the span layout needs K % (2 groupsize) == 0), a unit LayerNorm with zero
    bias that both branches requantise at 0.1, static scales 0.05, bf16
    embeddings and lm_head."""
    d, n = cfg.hidden_size, cfg.num_hidden_layers
    nqkv = (cfg.num_attention_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def lin(n_out, n_in):
        return span_stack(gen, (n,), n_out, n_in, groupsize, device)

    layers = FalconEngineLayer(
        ln_weight=_full((n, d), 1.0, device), ln_bias=_full((n, d), 0.0, device),
        qkv_proj=lin(nqkv, d), dense=lin(d, d), fc1=lin(4 * d, d), fc2=lin(d, 4 * d),
        attn_input_scale=_full((n,), 0.1, device), fc1_input_scale=_full((n,), 0.1, device),
        q_scale=_full((n,), 0.05, device), k_scale=_full((n,), 0.05, device),
        v_scale=_full((n,), 0.05, device), dense_input_scale=_full((n,), 0.05, device),
        fc2_input_scale=_full((n,), 0.05, device))
    ones = torch.ones((d,), dtype=torch.float32, device=device)
    return FalconEngineParams(
        embed_tokens=_normal(gen, (cfg.vocab_size, d), device), layers=layers,
        ln_f_weight=ones, ln_f_bias=torch.zeros_like(ones),
        lm_head=_normal(gen, (cfg.vocab_size, d), device))


def build_mixtral_engine(cfg: MixtralConfig, seed: int = 0, device="cuda",
                         fp_scales: bool = False) -> MixtralEngineParams:
    """Random Mixtral engine params at cfg's exact shapes, groupsize 128:
    the fused q|k|v and o_proj, each layer's E experts' fused w1|w3 and w2
    stacked on (L, E) (int8 group scales, or fp32 ones for ``fp_scales``,
    run with ``MixtralEngineConfig(fp_scales=True)``), the RMSNorms
    pre-scaled by 10, a router ``gate_weight`` (E, D) f32 drawn at 0.02, the
    router input scale 0.1, per-expert w2 requant scales spread over [0.04,
    0.06], static scales 0.05, bf16 embeddings and lm_head."""
    d, f, n, e = (cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers,
                  cfg.num_local_experts)
    nq = cfg.num_attention_heads * cfg.head_dim
    nkv = cfg.num_key_value_heads * cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def lin(lead, n_out, n_in):
        return span_stack(gen, lead, n_out, n_in, 128, device, fp_scales)

    layers = MixtralEngineLayer(
        ln1_weight=_full((n, d), 10.0, device), ln1_bias=None,
        ln2_weight=_full((n, d), 10.0, device), ln2_bias=None,
        qkv_proj=lin((n,), nq + 2 * nkv, d), o_proj=lin((n,), d, nq),
        gate_weight=torch.randn((n, e, d), generator=gen, dtype=torch.float32,
                                device=device) * 0.02,
        gate_bias=None, w13=lin((n, e), 2 * f, d), w2=lin((n, e), d, f),
        q_scale=_full((n,), 0.05, device), k_scale=_full((n,), 0.05, device),
        v_scale=_full((n,), 0.05, device), out_input_scale=_full((n,), 0.05, device),
        moe_input_scale=_full((n,), 0.1, device),
        w2_input_scale=torch.linspace(0.04, 0.06, e, device=device).repeat(n, 1))
    return MixtralEngineParams(
        embed_tokens=_normal(gen, (cfg.vocab_size, d), device), layers=layers,
        norm_weight=torch.ones((d,), dtype=torch.float32, device=device),
        lm_head=_normal(gen, (cfg.vocab_size, d), device))


def _stack(trees):
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*(_stack([t[i] for t in trees]) for i in range(len(first))))
