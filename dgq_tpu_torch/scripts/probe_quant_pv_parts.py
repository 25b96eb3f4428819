"""P5, where the cost of INT8 p @ V (quant_pv) goes in decode attention.

Port of ``scripts/probe_quant_pv_parts.py``.  Six variants of one decode
attention at the 7B shape (one slot, 32 heads, Dh 128, a full cache of
2048), sharing the scores and softmax prologue, on K3's kernel body
(``csrc/quant_pv_parts_attention.cu`` over ``csrc/decode_attention.cuh``: a
cluster of ``decode_plan``'s size per (slot, kv head)), so that what each
variant costs is what it would cost inside K3:

  fp          p @ (v * v_scale) in f32                  (the fast baseline)
  nodeq       (p @ v) * v_scale                          (is the scale free?)
  quant       rint(127 e) -> int8 dot -> epilogue        (jnp.round, half to even)
  quant_fast  trunc(127 e + 0.5) -> int8 dot -> epilogue (K3's shipped rule)
  noround     trunc(127 e) -> int8 dot -> epilogue       (is the rounding the cost?)
  s32dot      trunc(127 e) -> int8 dot, no epilogue      (is the epilogue the cost?)

``quant`` and ``quant_fast`` differ only where 127 e is exactly x.5.  On the
card ``fp`` and ``nodeq`` divide by the exp sum once, at the end, as K3
does (the TPU probe and the plain version divide each e first).  Times are
measured round-robin, and each variant's ratio to ``fp`` is the median of
the per-pass ratios.  On the card each call is timed alone after an L2
flush (``flushed_seconds``): the kernel takes less time than the host's
launch of it, so the TPU probe's chain of dependent calls would time the
host; on the CPU the chain runs as the TPU probe runs it.

Run: ``python -m dgq_tpu_torch.scripts.probe_quant_pv_parts`` on the card,
or with ``--cpu`` at 4 heads and a cache of 256 on the plain version.
"""

from __future__ import annotations

import argparse
import functools
from typing import Optional

import numpy as np
import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops.attention import DECODE_CLUSTERS, decode_plan
from dgq_tpu_torch.ops.quant_matmul import int_matmul
from dgq_tpu_torch.utils.benchmarking import device_time, flushed_seconds

B, H, HK, DH, SMAX = 1, 32, 32, 128, 2048
MODES = ("fp", "nodeq", "quant", "quant_fast", "noround", "s32dot")
KERNEL = "quant_pv_parts_attn"
# the TPU probe's fixed scales, rounded to f32 as jnp.float32 rounds them
QK_SCALE = float(np.float32(0.01 * 0.01 / 11.3))
V_SCALE = float(np.float32(0.01))
# q, kt, v, lengths, scales, out, B, H, Hkv, Dh, Smax, mode, cluster, stream
_SIGNATURES = {"quant_pv_parts_attention": [_cuda.VP] * 6 + [_cuda.INT] * 7 + [_cuda.VP]}


def exp_codes(e: torch.Tensor, mode: str) -> torch.Tensor:
    """int8 codes of the exp weights e in [0, 1] under an integer mode; the
    f32 product and sum are two roundings, as the JAX expressions take them."""
    e127 = e * 127.0
    if mode == "quant":
        return torch.round(e127).to(torch.int8)  # half to even, as jnp.round
    if mode == "quant_fast":
        return (e127 + 0.5).to(torch.int8)  # a truncating cast
    if mode in ("noround", "s32dot"):
        return e127.to(torch.int8)
    raise ValueError(f"mode {mode!r} has no codes")


def attn_plain(q_s8: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, length: torch.Tensor,
               mode: str) -> torch.Tensor:
    """q (B, H, Dh) int8, kt (B, Hkv, Dh, Smax) int8, v (B, Hkv, Smax, Dh)
    int8, length (B,) int32 -> (B, H, Dh) f32."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    b, h, dh = q_s8.shape
    hk, smax = kt.shape[1], kt.shape[3]
    dev = q_s8.device
    qg = q_s8.reshape(b, hk, h // hk, dh)
    scores = int_matmul(qg, kt)  # (B, Hkv, rep, Smax) int32
    s = scores.to(torch.float32) * torch.tensor(QK_SCALE, dtype=torch.float32, device=dev)
    pos = torch.arange(smax, device=dev)
    valid = (pos[None, :] < length.to(dev)[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.finfo(torch.float32).min)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    v_scale = torch.tensor(V_SCALE, dtype=torch.float32, device=dev)
    if mode == "fp":
        out = torch.matmul(e / denom, v.to(torch.float32) * v_scale)
    elif mode == "nodeq":
        out = torch.matmul(e / denom, v.to(torch.float32)) * v_scale
    else:
        acc = int_matmul(exp_codes(e, mode), v).to(torch.float32)
        out = acc if mode == "s32dot" else acc * ((v_scale / 127.0) / denom)
    return out.reshape(b, h, dh)


@functools.lru_cache(maxsize=None)
def kernel_scales(device) -> torch.Tensor:
    """The kernel's f32 scales on ``device``: qk_scale, v_scale and v_scale
    / 127 (in the plain version's order); made once a device, so that a
    call copies nothing from the host."""
    vs = torch.tensor(V_SCALE, dtype=torch.float32, device=device)
    return torch.stack([torch.tensor(QK_SCALE, dtype=torch.float32, device=device), vs,
                        vs / torch.tensor(127.0, dtype=torch.float32, device=device)])


def launch_shape(q_shape, kt_shape, mode: str, sms: int, cluster: Optional[int] = None):
    """The integer arguments of P5's C entry ``quant_pv_parts_attention``
    for q (B, H, Dh) and kt (B, Hkv, Dh, Smax) in ``mode``: (B, H, Hkv, Dh,
    Smax, the mode's index, the cluster), the cluster ``decode_plan``'s on
    a card of ``sms`` SMs unless given.  Raises ValueError on what the entry
    rejects: Dh other than 128, H / Hkv outside (1, 2, 4, 8), Smax % 4, a
    cluster outside DECODE_CLUSTERS."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    b, h, dh = q_shape
    hk, smax = kt_shape[1], kt_shape[3]
    if hk <= 0 or h % hk or h // hk not in (1, 2, 4, 8) or dh != 128 or smax % 4:
        raise ValueError(f"{KERNEL} needs Dh 128, H / Hkv in (1, 2, 4, 8) and Smax % 4 == 0; "
                         f"got q {tuple(q_shape)}, kt {tuple(kt_shape)}")
    if cluster is None:
        cluster = decode_plan(b, hk, h // hk, dh, smax, sms)
    elif cluster not in DECODE_CLUSTERS:
        raise ValueError(f"{KERNEL}: cluster {cluster} is none of {DECODE_CLUSTERS}")
    return b, h, hk, dh, smax, MODES.index(mode), cluster


def attn(q_s8: torch.Tensor, kt: torch.Tensor, v: torch.Tensor, length: torch.Tensor,
         mode: str, *, cluster: Optional[int] = None) -> torch.Tensor:
    """P5 in ``mode`` (one of ``MODES``); ``length`` (B,) int32, each in [0,
    Smax] (0: no valid position, every e is 1).  CPU tensors take the plain
    version; CUDA tensors launch the kernel in clusters of ``cluster``
    blocks a (slot, kv head), by default ``decode_plan``'s size."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if q_s8.device.type == "cpu":
        return attn_plain(q_s8, kt, v, length, mode)
    dev = q_s8.device
    b, h, hk, dh, smax, index, cluster = launch_shape(
        q_s8.shape, kt.shape, mode, torch.cuda.get_device_properties(dev).multi_processor_count,
        cluster)
    _cuda.require(q_s8, "q_s8", torch.int8, (b, h, dh), dev, align=4)
    _cuda.require(kt, "kt", torch.int8, (b, hk, dh, smax), dev)
    _cuda.require(v, "v", torch.int8, (b, hk, smax, dh), dev)
    _cuda.require(length, "length", torch.int32, (b,), dev, align=4)
    lib = _cuda.library(_cuda.SOURCES[KERNEL], _SIGNATURES)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    rc = lib.quant_pv_parts_attention(
        _cuda.ptr(q_s8), _cuda.ptr(kt), _cuda.ptr(v), _cuda.ptr(length),
        _cuda.ptr(kernel_scales(dev)), _cuda.ptr(out), b, h, hk, dh, smax, index, cluster,
        _cuda.stream(dev))
    _cuda.check(rc, KERNEL)
    _cuda.count_launch(KERNEL)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="4 heads, cache 256, the plain version")
    ap.add_argument("--cycles", type=int, default=3, help="round-robin passes")
    ap.add_argument("--iters", type=int, default=48,
                    help="calls a reading on the card; on the CPU the long chain's length "
                         "(short: a quarter)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("probe_quant_pv_parts: no CUDA device (torch.cuda.is_available() is "
                         "false); pass --cpu for the plain version")
    dev = "cpu" if args.cpu else "cuda"
    h, hk, smax = (4, 4, 256) if args.cpu else (H, HK, SMAX)
    r = np.random.default_rng(0)

    def ri(shape):
        return torch.from_numpy(r.integers(-127, 128, shape).astype(np.int8)).to(dev)

    q, kt, v = ri((B, h, DH)), ri((B, hk, DH, smax)), ri((B, hk, smax, DH))
    length = torch.full((B,), smax, dtype=torch.int32, device=dev)

    def fb(out, qin):
        del qin
        return torch.clamp(torch.round(out * 8.0), -127, 127).to(torch.int8)

    # on the card a call (~15 us) is shorter than the host's launch of it, so a
    # chain of calls would time the host: each call is timed alone, after an L2 flush
    flush = None if args.cpu else torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    res = {mode: [] for mode in MODES}
    for _ in range(args.cycles):
        for mode in MODES:
            if flush is not None:
                t = flushed_seconds(lambda mode=mode: attn(q, kt, v, length, mode), flush,
                                    args.iters)
            else:
                t = device_time(lambda a, mode=mode: attn(a, kt, v, length, mode), q,
                                feedback=fb, iters=args.iters,
                                base_iters=max(1, args.iters // 4), repeats=1)
            res[mode].append(t)
    for mode in MODES:
        reps = ", ".join(f"{t * 1e6:8.2f}" for t in res[mode])
        print(f"{mode:10s}: best {min(res[mode]) * 1e6:8.2f} us  reps [{reps}] "
              f"({res[mode][0].clock})", flush=True)
    ratios = {}
    for mode in MODES[1:]:
        rs = sorted(res[mode][i] / res["fp"][i] for i in range(args.cycles))
        ratios[mode] = rs[len(rs) // 2]
        print(f"paired {mode:10s}/fp: median {ratios[mode]:5.2f}  "
              f"[{', '.join(f'{x:4.2f}' for x in rs)}]", flush=True)
    return {"best_s": {m: min(ts) for m, ts in res.items()}, "ratio_to_fp": ratios}


if __name__ == "__main__":
    main()
