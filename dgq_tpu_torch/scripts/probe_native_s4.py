"""P3, the int4 weight feed: an s4 GEMV from packed nibbles at the qkv decode
shape (16 rows of int4 codes, K 4096, N 12288).

Port of ``scripts/probe_native_s4.py``.  The TPU's matrix unit takes int4
operands, so the JAX probe asks whether int4 weights stream to it with no
unpack.  Hopper's tensor cores take no int4 operand: here the kernel
(``csrc/s4_gemv.cu``) reads the packed bytes, sign-extends the nibbles to
int8 in registers and runs s8 mma.sync, so the probe measures the
nibble-unpack cost that K1, K4-K6 and K12 pay on their weights, in two
column maps:

  * ``pallas_s4``: (K, N/2) bytes in XLA's int4 order, W[k, 2j] the low
    nibble of byte j and W[k, 2j+1] its high nibble (``check_bitcast_order``
    prints the order the kernel reads);
  * ``pallas_s4_bitcast``: each ``bn`` = 512 columns of W are [low nibbles |
    high nibbles] of their 256 bytes, what the TPU's in-kernel bitcast and
    reshape of a (K, 256) byte block give (byte row r -> int4 rows 2r (low)
    and 2r+1 (high), then reshape(K, 512)).

Beside them: the int8-dense GEMV on ``torch._int_mm`` (rows padded to 32),
the same dot on the int8 weights the nibbles unpack to (the library's
yardstick), and the production span kernel K12 (``fused_norm_gemv``).  The
JAX probe's candidates B and C, int4 dots that XLA itself lowers, have no
counterpart: the card has no int4 operand.

Run: ``python -m dgq_tpu_torch.scripts.probe_native_s4`` on the card, or
with ``--cpu`` at K 256, N 1024 on the plain versions (host times).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops.fused_decode import fused_norm_gemv
from dgq_tpu_torch.ops.quant_matmul import int_matmul
from dgq_tpu_torch.scripts.probe_gemv_engines import int_mm_rows32
from dgq_tpu_torch.scripts.roofline_probe import column_major
from dgq_tpu_torch.utils.benchmarking import device_time

K, N = 4096, 12288
B = 8  # decode rows; the int4 paths run 2B stacked rows of codes
BN = 512  # the TPU probe's column block: the bitcast map's period
PAIRS, HALVES = "pallas_s4", "pallas_s4_bitcast"
_SIGNATURES = {"s4_gemv": [_cuda.VP] * 3 + [_cuda.INT] * 6 + [_cuda.VP]}
BLOCKS_PER_SM = 8  # the K split's target: enough weight loads in flight


def k_split(n: int, k: int, device) -> int:
    """Blocks over K per 64-column block: about BLOCKS_PER_SM blocks an SM,
    at most one per 128-row chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(k // 128, -(-BLOCKS_PER_SM * sms // (n // 64))))


def _nibbles(wb: torch.Tensor):
    u = wb.view(torch.uint8).to(torch.int32)
    return ((u & 0xF) ^ 8) - 8, ((u >> 4) ^ 8) - 8


def unpack_s4_pairs(wb: torch.Tensor) -> torch.Tensor:
    """(K, N/2) bytes -> (K, N) int8: W[:, 2j] low nibble, W[:, 2j+1] high."""
    lo, hi = _nibbles(wb)
    k, n2 = wb.shape
    return torch.stack([lo, hi], dim=-1).reshape(k, 2 * n2).to(torch.int8)


def unpack_s4_halves(wb: torch.Tensor, bn: int = BN) -> torch.Tensor:
    """(K, N/2) bytes -> (K, N) int8, each bn columns [low | high] nibbles of
    their bn/2 bytes."""
    lo, hi = _nibbles(wb)
    k, n2 = wb.shape
    h = bn // 2
    return torch.cat([lo.reshape(k, n2 // h, h), hi.reshape(k, n2 // h, h)],
                     dim=-1).reshape(k, 2 * n2).to(torch.int8)


def pallas_s4_plain(x: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    return int_matmul(x, unpack_s4_pairs(wb))


def pallas_s4_bitcast_plain(x: torch.Tensor, wb: torch.Tensor, bn: int = BN) -> torch.Tensor:
    return int_matmul(x, unpack_s4_halves(wb, bn))


def _launch(name: str, x: torch.Tensor, wb: torch.Tensor, halves: bool, bn: int) -> torch.Tensor:
    m, k = x.shape
    k2, n2 = wb.shape
    n = 2 * n2
    if k2 != k or m > 16:
        raise ValueError(f"{name}: x {tuple(x.shape)} (at most 16 rows), wb {tuple(wb.shape)}")
    dev = x.device
    _cuda.require(x, "x", torch.int8, (m, k), dev)
    _cuda.require(wb, "wb", torch.int8, (k, n2), dev)
    if n % 64 or k % 128 or (halves and (bn % 64 or n % bn)):
        raise ValueError(f"{name} needs N % 64 == 0, K % 128 == 0 (and N % bn == 0, bn % 64 "
                         f"== 0); got N={n}, K={k}, bn={bn}")
    lib = _cuda.library(_cuda.SOURCES[name], _SIGNATURES)
    ks = k_split(n, k, dev)
    out = (torch.zeros if ks > 1 else torch.empty)((m, n), dtype=torch.int32, device=dev)
    _cuda.check(lib.s4_gemv(_cuda.ptr(x), _cuda.ptr(wb), _cuda.ptr(out), m, n, k, int(halves),
                            bn, ks, _cuda.stream(dev)), name)
    _cuda.count_launch(name)
    return out


def pallas_s4(x: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """(M <= 16, K) int8 codes . W -> (M, N) int32, W from (K, N/2) bytes in
    XLA's int4 order.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if x.device.type == "cpu":
        return pallas_s4_plain(x, wb)
    return _launch(PAIRS, x, wb, False, 0)


def pallas_s4_bitcast(x: torch.Tensor, wb: torch.Tensor, bn: int = BN) -> torch.Tensor:
    """(M <= 16, K) int8 codes . W -> (M, N) int32, each bn columns of W
    [low | high] nibbles of (K, bn/2) bytes.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return pallas_s4_bitcast_plain(x, wb, bn)
    return _launch(HALVES, x, wb, True, bn)


def check_bitcast_order(dev) -> str:
    """Which nibble of a byte does ``pallas_s4`` read as element 0?  One
    byte 0x21 (low 1, high 2) at (0, 0) and a one-hot row of x."""
    wb = torch.zeros((128, 32), dtype=torch.int8, device=dev)
    wb[0, 0] = 0x21
    x = torch.zeros((1, 128), dtype=torch.int8, device=dev)
    x[0, 0] = 1
    pair = pallas_s4(x, wb)[0, :2].tolist()
    order = "elem0=LO nibble" if pair == [1, 2] else "elem0=HI nibble"
    print(f"byte 0x21 -> {pair} ({order})", flush=True)
    return order


def k12_norm_gemv_case(r, dev, k, n):
    """K12's operands at (K, N): f32 rows, span bytes and plane rows."""
    g = k // 128

    def ri(lo, hi, shape):
        return torch.from_numpy(r.integers(lo, hi, shape).astype(np.int8)).to(dev)

    planes = (ri(1, 4, (g // 2, n)), ri(1, 4, (g // 2, n)), ri(0, 16, (g // 2, n)),
              ri(0, 16, (g // 2, n)))
    al = torch.from_numpy((r.random(n) * 1e-4).astype(np.float32)).to(dev)
    lnw = torch.ones((k,), dtype=torch.float32, device=dev)
    qw = ri(-128, 128, (k // 2, n))

    def kern(x, *_):
        return fused_norm_gemv(x.to(torch.float32), lnw, None, qw, *planes, al)

    return kern


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="K 256, N 1024 on the plain versions")
    ap.add_argument("--reps", type=int, default=3, help="round-robin passes")
    ap.add_argument("--iters", type=int, default=48, help="long chain length (short: a quarter)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("probe_native_s4: no CUDA device (torch.cuda.is_available() is "
                         "false); pass --cpu for the plain versions")
    dev = "cpu" if args.cpu else "cuda"
    k, n = (256, 1024) if args.cpu else (K, N)
    r = np.random.default_rng(0)

    def ri(lo, hi, shape):
        return torch.from_numpy(r.integers(lo, hi, shape).astype(np.int8)).to(dev)

    w8 = ri(-127, 127, (k, n))
    x8 = ri(-127, 127, (B, k))
    x4_8 = ri(-8, 8, (2 * B, k))
    wb = ri(-128, 128, (k, n // 2))
    w_pairs = unpack_s4_pairs(wb)
    order = check_bitcast_order(dev)

    def fb8(out, x):
        return (out[:x.shape[0], :k] & 0x7F).to(torch.int8)

    def fb4(out, x):
        return ((out[:x.shape[0], :k] & 0x7) - 4).to(torch.int8)

    def fbk(out, x):
        return (out[:, :k].to(torch.int32) & 0x7F).to(torch.int8)

    cands = [
        ("A int8-dense _int_mm  ", int_mm_rows32, (x8, column_major(w8)), fb8),
        ("D pallas_s4           ", pallas_s4, (x4_8, wb), fb4),
        ("D2 pallas_s4_bitcast  ", pallas_s4_bitcast, (x4_8, wb), fb4),
        ("s4 unpacked _int_mm   ", int_mm_rows32, (x4_8, column_major(w_pairs)), fb4),
        ("E K12 fused_norm_gemv ", k12_norm_gemv_case(r, dev, k, n), (x8,), fbk),
    ]
    best = {}
    for rep in range(args.reps):
        for name, f, fargs, fb in cands:
            t = device_time(f, *fargs, feedback=fb, iters=args.iters,
                            base_iters=max(1, args.iters // 4))
            best[name.strip()] = min(best.get(name.strip(), float("inf")), t)
            print(f"[{rep}] {name}: {t * 1e6:9.2f} us -> {k * n / t / 1e9:7.1f} G welem/s "
                  f"({t.clock})", flush=True)
    return {"order": order, "best_s": best}


if __name__ == "__main__":
    main()
