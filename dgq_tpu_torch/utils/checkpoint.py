"""Engine checkpoints: ``save_engine`` / ``load_engine`` for ``arch`` "llama",
"opt", "bloom", "mpt", "falcon" and "mixtral", and ``load_engine_any``.

Port of ``dgq_tpu/utils/checkpoint.py:223-248`` and ``:402-511``: one
safetensors file of flat ``/``-joined keys (``layers/qkv_proj/qw_rp``, ...)
plus a ``<path>.json`` manifest, interchangeable with the JAX package's
files.  The format is read and written here directly (no ``safetensors``
package): an 8-byte little-endian header length, a JSON header naming each
tensor's dtype, shape and byte range, then the raw little-endian bytes.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Dict, Mapping

import numpy as np
import torch

from dgq_tpu_torch.models.bloom import BloomConfig
from dgq_tpu_torch.models.bloom_engine import BloomEngineLayer, BloomEngineParams
from dgq_tpu_torch.models.engine import EngineLayer, EngineLinear, EngineParams, map_tensors
from dgq_tpu_torch.models.falcon import FalconConfig
from dgq_tpu_torch.models.falcon_engine import FalconEngineLayer, FalconEngineParams
from dgq_tpu_torch.models.llama import LlamaConfig
from dgq_tpu_torch.models.mixtral import MixtralConfig
from dgq_tpu_torch.models.mixtral_engine import MixtralEngineLayer, MixtralEngineParams
from dgq_tpu_torch.models.mpt import MPTConfig
from dgq_tpu_torch.models.mpt_engine import MPTEngineLayer, MPTEngineParams
from dgq_tpu_torch.models.opt import OPTConfig
from dgq_tpu_torch.models.opt_engine import OPTEngineLayer, OPTEngineParams

ARCHS = ("llama", "opt", "bloom", "mpt", "falcon", "mixtral")

_DTYPES = {
    "I8": torch.int8,
    "I32": torch.int32,
    "F32": torch.float32,
    "BF16": torch.bfloat16,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _bytes(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a contiguous CPU tensor, as a uint8 array view."""
    return t.reshape(-1).view(torch.uint8).numpy()


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """Write tensors (copied to the CPU) as one safetensors file, keys sorted."""
    cpu = {name: tensors[name].detach().to("cpu").contiguous() for name in sorted(tensors)}
    header: Dict[str, dict] = {}
    offset = 0
    for name, t in cpu.items():
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} not supported")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in cpu.values():
            f.write(_bytes(t))


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a safetensors file into CPU tensors."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            if meta["dtype"] not in _DTYPES:
                raise TypeError(f"{name}: dtype {meta['dtype']} not supported")
            t = torch.empty(meta["shape"], dtype=_DTYPES[meta["dtype"]])
            b0, b1 = meta["data_offsets"]
            if b1 - b0 != t.numel() * t.element_size():
                raise ValueError(f"{name}: {b1 - b0} bytes for shape {meta['shape']}")
            f.seek(8 + n + b0)
            if f.readinto(_bytes(t)) != b1 - b0:
                raise ValueError(f"{name}: file ends inside the tensor")
            out[name] = t
    return out


def _flatten(prefix: str, tree, out: Dict[str, torch.Tensor]) -> None:
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
        return
    for name, value in zip(tree._fields, tree):
        _flatten(f"{prefix}/{name}", value, out)


def engine_arrays(eng) -> Dict[str, torch.Tensor]:
    """Any family's engine params (EngineParams, OPTEngineParams, ...,
    MixtralEngineParams) -> flat ``/``-joined keys, as JAX's save_engine
    names them (None fields are left out)."""
    out: Dict[str, torch.Tensor] = {}
    for f in dataclasses.fields(eng):
        value = getattr(eng, f.name)
        if isinstance(value, (torch.Tensor, tuple)):  # not rms_eps, a manifest entry
            _flatten(f.name, value, out)
    return out


def _check_arch(arch: str) -> None:
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}")


def save_engine(path: str, eng, cfg, arch: str = "llama") -> None:
    """Write ``eng`` (EngineParams for "llama", OPTEngineParams for "opt",
    BloomEngineParams for "bloom", MPTEngineParams for "mpt",
    FalconEngineParams for "falcon", MixtralEngineParams for "mixtral") and
    its ``<path>.json`` manifest, as JAX's save_engine does."""
    _check_arch(arch)
    write_safetensors(path, engine_arrays(eng))
    manifest = {"format_version": 1, "kind": "engine", "arch": arch,
                "model_config": dataclasses.asdict(cfg)}
    if hasattr(eng, "rms_eps"):
        manifest["rms_eps"] = eng.rms_eps
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from JAX: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _stored_linear(t: Mapping[str, torch.Tensor], prefix: str) -> EngineLinear:
    """An EngineLinear as stored: missing fields (None when saved) are None."""
    return EngineLinear(*(t.get(f"{prefix}/{name}") for name in EngineLinear._fields))


def _linear(t: Mapping[str, torch.Tensor], prefix: str) -> EngineLinear:
    from dgq_tpu_torch.ops.fused_decode import pack_rowpair_s4, rowpair_cs_fold

    ws, wz = t[f"{prefix}/wscales"], t[f"{prefix}/wzeros"]
    if ws.dtype != torch.int8:  # fp-scale linear: span storage only, no plane rows
        return _stored_linear(t, prefix)
    # compact plane rows, derived from the 8x-replicated copies when absent
    # (group g at rows 8g..8g+7: even groups rows 0::16, odd groups 8::16)
    s_hi = t.get(f"{prefix}/s_hi", ws[..., 0::16, :].contiguous())
    s_lo = t.get(f"{prefix}/s_lo", ws[..., 8::16, :].contiguous())
    qweight, qw_rp = t.get(f"{prefix}/qweight"), t.get(f"{prefix}/qw_rp")
    cs_fold = t.get(f"{prefix}/cs_fold")
    if qw_rp is None:  # span-only checkpoint: derive the rowpair layout
        if qweight is None:
            raise KeyError(f"{prefix}: neither qw_rp nor qweight present")
        span = 2 * (2 * qweight.shape[-2] * 8) // ws.shape[-2]
        qw_rp = pack_rowpair_s4(qweight, span)
        cs_fold = rowpair_cs_fold(qweight, span, s_hi, s_lo)
    return EngineLinear(
        qweight=qweight, wscales=ws, wzeros=wz, alpha=t[f"{prefix}/alpha"],
        bias=t.get(f"{prefix}/bias"), s_hi=s_hi, s_lo=s_lo,
        z_hi=t.get(f"{prefix}/z_hi", wz[..., 0::16, :].contiguous()),
        z_lo=t.get(f"{prefix}/z_lo", wz[..., 8::16, :].contiguous()),
        qw_rp=qw_rp, cs_fold=cs_fold,
    )


def engine_params_from_arrays(tensors: Mapping[str, object], rms_eps: float,
                              device="cuda") -> EngineParams:
    """EngineParams from arrays (numpy or torch) under save_engine's keys."""
    t = {k: _to_tensor(v) for k, v in tensors.items()}
    layers = EngineLayer(
        ln1_weight=t["layers/ln1_weight"],
        ln1_bias=t.get("layers/ln1_bias"),
        ln2_weight=t["layers/ln2_weight"],
        ln2_bias=t.get("layers/ln2_bias"),
        qkv_proj=_linear(t, "layers/qkv_proj"),
        o_proj=_linear(t, "layers/o_proj"),
        gate_up_proj=_linear(t, "layers/gate_up_proj"),
        down_proj=_linear(t, "layers/down_proj"),
        q_scale=t["layers/q_scale"],
        k_scale=t["layers/k_scale"],
        v_scale=t["layers/v_scale"],
        out_input_scale=t["layers/out_input_scale"],
        down_input_scale=t["layers/down_input_scale"],
    )

    return EngineParams(
        embed_tokens=_move(t["embed_tokens"], device),
        layers=map_tensors(lambda x: _move(x, device), layers),
        norm_weight=_move(t["norm_weight"], device),
        lm_head=_move(t["lm_head"], device),
        rms_eps=float(rms_eps),
    )


def _move(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device).contiguous()


def _span_params_from_arrays(cls, layer_cls, lins, tensors: Mapping[str, object], device,
                             optional=()):
    """``cls`` (a span-only engine's params: OPT, BLOOM, MPT, Falcon,
    Mixtral) from arrays (numpy or torch) under save_engine's keys; the
    linears ``lins`` keep their span-only storage, as JAX loads them (each
    leaf with the layers' leading axes: (L, E, ...) for Mixtral's experts);
    the fields ``optional`` are None where the arrays leave them out."""
    t = {k: _to_tensor(v) for k, v in tensors.items()}
    layers = layer_cls(**{
        name: (_stored_linear(t, f"layers/{name}") if name in lins
               else t.get(f"layers/{name}") if name in optional else t[f"layers/{name}"])
        for name in layer_cls._fields})
    top = {f.name: _move(t[f.name], device) for f in dataclasses.fields(cls)
           if f.name != "layers"}
    return cls(layers=map_tensors(lambda x: _move(x, device), layers), **top)


def opt_engine_params_from_arrays(tensors: Mapping[str, object],
                                  device="cuda") -> OPTEngineParams:
    """OPTEngineParams from arrays (numpy or torch) under save_engine's keys."""
    return _span_params_from_arrays(OPTEngineParams, OPTEngineLayer,
                                    ("qkv_proj", "out_proj", "fc1", "fc2"), tensors, device)


def bloom_engine_params_from_arrays(tensors: Mapping[str, object],
                                    device="cuda") -> BloomEngineParams:
    """BloomEngineParams from arrays (numpy or torch) under save_engine's
    keys, e.g. JAX's ``BloomEngineParams`` flattened as its save_engine
    names them."""
    return _span_params_from_arrays(BloomEngineParams, BloomEngineLayer,
                                    ("qkv_proj", "dense", "fc1", "fc2"), tensors, device)


def mpt_engine_params_from_arrays(tensors: Mapping[str, object],
                                  device="cuda") -> MPTEngineParams:
    """MPTEngineParams from arrays (numpy or torch) under save_engine's keys."""
    return _span_params_from_arrays(MPTEngineParams, MPTEngineLayer,
                                    ("qkv_proj", "out_proj", "up_proj", "down_proj"), tensors,
                                    device)


def falcon_engine_params_from_arrays(tensors: Mapping[str, object],
                                     device="cuda") -> FalconEngineParams:
    """FalconEngineParams from arrays (numpy or torch) under save_engine's
    keys, e.g. JAX's ``FalconEngineParams`` flattened as its save_engine
    names them."""
    return _span_params_from_arrays(FalconEngineParams, FalconEngineLayer,
                                    ("qkv_proj", "dense", "fc1", "fc2"), tensors, device)


def mixtral_engine_params_from_arrays(tensors: Mapping[str, object],
                                      device="cuda") -> MixtralEngineParams:
    """MixtralEngineParams from arrays (numpy or torch) under save_engine's
    keys (the experts' ``layers/w13/...`` and ``layers/w2/...`` leading with
    (L, E)); the norms' and the router's biases may be absent (None)."""
    return _span_params_from_arrays(MixtralEngineParams, MixtralEngineLayer,
                                    ("qkv_proj", "o_proj", "w13", "w2"), tensors, device,
                                    optional=("ln1_bias", "ln2_bias", "gate_bias"))


# arch -> (its config, its params from save_engine's arrays) for the span-only engines
_SPAN_ARCHS = {"opt": (OPTConfig, opt_engine_params_from_arrays),
               "bloom": (BloomConfig, bloom_engine_params_from_arrays),
               "mpt": (MPTConfig, mpt_engine_params_from_arrays),
               "falcon": (FalconConfig, falcon_engine_params_from_arrays),
               "mixtral": (MixtralConfig, mixtral_engine_params_from_arrays)}


def fp_scales_of(eng) -> bool:
    """``EngineConfig.fp_scales`` for a loaded LLaMA engine, or
    ``MixtralEngineConfig.fp_scales`` for a Mixtral one: True when every
    linear stores fp32 group scales (the w4w8-fallback representation),
    False when every one stores int8 scales; an engine that mixes the two
    raises, naming the linears of each kind."""
    kinds = {name: lin.wscales.dtype == torch.float32
             for name, lin in zip(eng.layers._fields, eng.layers)
             if isinstance(lin, EngineLinear)}
    if len(set(kinds.values())) > 1:
        fp = [f"layers/{n}" for n, k in kinds.items() if k]
        s8 = [f"layers/{n}" for n, k in kinds.items() if not k]
        raise ValueError(f"engine mixes fp32 group scales ({', '.join(fp)}) with int8 ones "
                         f"({', '.join(s8)}): one EngineConfig(fp_scales=...) cannot run both")
    return next(iter(kinds.values()))


def load_engine(path: str, device="cuda"):
    """(engine params, model config) from a save_engine checkpoint, the
    family read from the manifest's ``arch``: (EngineParams, LlamaConfig),
    (OPTEngineParams, OPTConfig), (BloomEngineParams, BloomConfig),
    (MPTEngineParams, MPTConfig), (FalconEngineParams, FalconConfig) or
    (MixtralEngineParams, MixtralConfig)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    arch = manifest.get("arch", "llama")
    _check_arch(arch)
    if arch in _SPAN_ARCHS:
        cfg_cls, from_arrays = _SPAN_ARCHS[arch]
        return from_arrays(read_safetensors(path), device), cfg_cls(**manifest["model_config"])
    cfg = LlamaConfig(**manifest["model_config"])
    return engine_params_from_arrays(read_safetensors(path), manifest["rms_eps"], device), cfg


def load_engine_any(path: str, device="cuda"):
    """Engine-checkpoint loader dispatch, as JAX's: a file is a save_engine
    checkpoint of any ported family (``load_engine``, by the manifest's
    ``arch``); a directory is an orbax checkpoint, not ported yet."""
    import os

    if os.path.isdir(path):
        raise NotImplementedError("orbax (sharded) engine checkpoints are not ported yet "
                                  "(ROADMAP Queue 1 item 1); load a save_engine safetensors file")
    return load_engine(path, device)
