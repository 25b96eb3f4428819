"""KV-cache attention: K2 (flash prefill), K3 (decode), K7 (long-context
decode), K8 (paged decode) and K11 (paged decode over INT4 nibble pages)
with plain versions.

Port of ``dgq_tpu/ops/attention.py``: ``_quantize_exp`` (:35-65),
``auto_decode_chunk`` (:473-488), ``gather_paged_kv`` (:752-761), the plain
``int8_prefill_attention_xla`` (:315-334), ``int8_decode_attention_xla``
(:337-374) and ``int8_paged_decode_attention_xla`` (:912-923), and the
wrappers of the hand-written CUDA kernels under the JAX names:
``int8_prefill_attention`` (``csrc/int8_prefill_attention.cu``),
``int8_decode_attention`` (``csrc/int8_decode_attention.cu``, a cluster of
blocks per (slot, kv head), its cluster from ``decode_plan``),
``int8_decode_attention_chunked`` (``csrc/long_decode_attention.cu``, K3's
body on long caches, its cluster and scores from ``chunked_plan``; with
ALiBi ``csrc/long_decode_attention_alibi.cu``), and
``int8_paged_decode_attention``
and ``int4_paged_decode_attention``, which share
``csrc/paged_decode_attention.cu`` (K3's body over the page pool, its
cluster from ``paged_plan``).  K11's plain version,
``int4_paged_decode_attention_xla``, is what JAX runs off its kernel
(``dgq_tpu/serving/paged.py:259-270``): unpack both pools, then K8's plain
version without quant_pv.

Cache layout as in JAX: K transposed (B, Hkv, Dh, Smax), V (B, Hkv, Smax, Dh),
both int8; a page pool holds (P, Hkv, Dh, ps) and (P, Hkv, ps, Dh) pages
found through a (B, NP) int32 table, or (P, Hkv, Dh/2, ps) and (P, Hkv, ps,
Dh/2) nibble pages (``ops/kv4.py``).  GQA folds query head h onto kv head
h // (H // Hkv).

K2, K3 and K7 take ``alibi_slopes`` (H,), a slope a query head (BLOOM, MPT):
slope x key position is added to the scaled scores before the mask, as
JAX's kernels add it (``dgq_tpu/ops/attention.py:92-102``, ``:286-287``);
those launches count under ``<name>_alibi``.

K3 and K7 take any number of query heads a kv head, as JAX's do (Falcon-7B:
71 on one).  Their whole kernels are compiled for rep = H / Hkv in
DECODE_REPS; any other rep (up to ROWS_MAX_REP) runs their split kernels
(``csrc/decode_attention_rows.cu``): one cluster a (slot, kv head) with every
query row of the kv head in the block, both products on the tensor cores,
its cluster and where the scores live from ``rows_plan``; those launches
count under ``<name>_split`` (and ``<name>_split_alibi``).

Every scalar handed to a kernel is a float32 tensor computed in JAX's order,
e.g. ``(q_scale * k_scale) / sqrt(Dh)`` with the divisor a float32 tensor: a
Python float divisor would take other bits (CUDA turns division by a host
scalar into multiplication by its reciprocal).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Union

import torch

from dgq_tpu_torch.ops import _cuda
from dgq_tpu_torch.ops.kv4 import unpack_nibbles
from dgq_tpu_torch.ops.quant_matmul import int_matmul

PREFILL = "int8_prefill_attention"
DECODE = "int8_decode_attention"
CHUNKED = "int8_decode_attention_chunked"
ALIBI = "_alibi"  # the launch count of a kernel's ALiBi instantiation: its name + ALIBI
SPLIT = "_split"  # K3's and K7's split kernels (any rep): the name + SPLIT (+ ALIBI)
ROWS = "int8_decode_attention_rows"  # their C entry, one for both
PAGED = "int8_paged_decode_attention"
PAGED_KV4 = "int4_paged_decode_attention"
_PAGED_SIGNATURES = {  # one library, two entry points
    PAGED: [_cuda.VP] * 7 + [_cuda.INT] * 8 + [_cuda.VP],
    PAGED_KV4: [_cuda.VP] * 7 + [_cuda.INT] * 7 + [_cuda.VP],
}
_SIGNATURES = {
    PREFILL: {PREFILL: [_cuda.VP] * 6 + [_cuda.INT] * 8 + [_cuda.VP]},
    DECODE: {DECODE: [_cuda.VP] * 7 + [_cuda.INT] * 7 + [_cuda.VP]},
    ROWS: {ROWS: [_cuda.VP] * 7 + [_cuda.INT] * 8 + [_cuda.VP]},
    CHUNKED: {CHUNKED: [_cuda.VP] * 7 + [_cuda.INT] * 8 + [_cuda.VP]},
    CHUNKED + ALIBI: {CHUNKED + ALIBI: [_cuda.VP] * 8 + [_cuda.INT] * 8 + [_cuda.VP]},
    PAGED: _PAGED_SIGNATURES,
    PAGED_KV4: _PAGED_SIGNATURES,
}
# K3: a cluster of DECODE_CLUSTERS[i] blocks per (slot, kv head), each taking a
# contiguous share of the valid positions through a ring of DECODE_RING tiles
# of DECODE_TILE positions (csrc/int8_decode_attention.cu); K7 also clusters of
# 16, Hopper's non-portable size, a rank's scores in a device-memory scratch,
# and a kv head's query heads split over CHUNKED_SPLITS[i] virtual kv heads
DECODE_CLUSTERS = (2, 4, 8)
CHUNKED_CLUSTERS = (2, 4, 8, 16)
CHUNKED_SPLITS = (1, 2, 4, 8)
DECODE_TILE, DECODE_RING, DECODE_THREADS = 64, 4, 128
DECODE_SMEM_LIMIT = 232448  # an H100 block's shared memory
DECODE_SM_SMEM = 233472  # an H100 SM's (228 KB)
CHUNKED_BLOCKS_PER_SM = 3  # K7's aim for its head split: blocks an SM at clusters of 16
DECODE_BLOCKS_PER_SM = 2  # the cluster plan's aim: a wave of at most two blocks an SM
DECODE_SHORT_SMAX = 8192  # the caches K3 takes (auto_decode_chunk), and K7 with K3's plan
# rep = H / Hkv of K3's and K7's whole kernels; any other rep up to ROWS_MAX_REP runs their
# split kernels (csrc/decode_attention_rows.cu): one cluster of ROWS_CLUSTERS[i] blocks a
# (slot, kv head), two warps a 16-row tile of the kv head's query rows, a ring of
# ROWS_RING_BYTES of raw tiles of DECODE_TILE positions, and the body's static shared memory
# (row maxima and sums, the ring's barriers)
DECODE_REPS = (1, 2, 4, 8)
ROWS_CLUSTERS = (2, 4, 8, 16)
ROWS_RING_BYTES, ROWS_MAX_REP, ROWS_MIN_THREADS = 32768, 128, 256
ROWS_RANK_POSITIONS = 256  # rows_plan's most positions of the cache a rank
ROWS_STATIC_BYTES = 4 * (6 * ROWS_MAX_REP + ROWS_MAX_REP // 2 * 16) + 8 * 8

NEG = torch.finfo(torch.float32).min


def f32(value: float, device) -> torch.Tensor:
    """A float32 scalar tensor on ``device``."""
    return torch.full((), value, dtype=torch.float32, device=device)


def qk_scale(q_scale: torch.Tensor, k_scale: torch.Tensor, head_dim: int,
             apply_sqrt_dh: bool = True) -> torch.Tensor:
    """(q_scale * k_scale) / sqrt(Dh) as a float32 scalar tensor."""
    qk = (q_scale * k_scale).to(torch.float32)
    return qk / f32(math.sqrt(head_dim), qk.device) if apply_sqrt_dh else qk


def _quantize_exp(e: torch.Tensor) -> torch.Tensor:
    """INT8 codes trunc(127 * e + 0.5) of exp-weights e = exp(s - m) in [0, 1].

    The row max of e is exactly 1, so the constant scale 1/127 gives the
    codes a per-row scale would; the caller folds 1/denom into its epilogue.
    Two separate float32 ops (multiply, then add) and a truncating cast, as
    the JAX rule is written: an fma would move codes across the .5 boundary."""
    return (e * 127.0 + 0.5).to(torch.int8)


def auto_decode_chunk(smax: int) -> int:
    """0 (whole-cache decode kernel K3) up to 8k context, else the largest
    chunk in {4096..128} dividing ``smax`` (JAX's chunked kernel; here K7,
    K3's body under ``chunked_plan``)."""
    if smax <= DECODE_SHORT_SMAX:
        return 0
    for c in (4096, 2048, 1024, 512, 256, 128):
        if smax % c == 0:
            return c
    return 0


def _alibi_bias(alibi_slopes, hk: int, rep: int, smax: int, device) -> torch.Tensor:
    """(Hkv, rep, 1, Smax) slope x key position, query head g rep + r at
    [g, r] (JAX's ``slopes.reshape(hk, rep)``): the product rounded once, as
    the kernels compute it."""
    sl = torch.as_tensor(alibi_slopes, dtype=torch.float32).to(device).reshape(hk, rep, 1, 1)
    return sl * torch.arange(smax, device=device, dtype=torch.float32)


def int8_prefill_attention_xla(q_s8, kt_cache, v_cache, prompt_len, q_scale, k_scale, v_scale,
                               q_offset=None, apply_sqrt_dh: bool = True,
                               alibi_slopes=None) -> torch.Tensor:
    """Plain causal attention over the INT8 cache -> (B, H, S, Dh) f32;
    materialises the (S, Smax) scores.  Query row i sits at absolute
    position ``q_offset + i``; ``alibi_slopes`` (H,) adds slope[h] x key
    position to query head h's scores."""
    b, h, s, dh = q_s8.shape
    _, hk, _, smax = kt_cache.shape
    rep = h // hk
    dev = q_s8.device
    qk = qk_scale(q_scale, k_scale, dh, apply_sqrt_dh)
    s32 = int_matmul(q_s8.reshape(b, hk, rep * s, dh), kt_cache)
    scores = s32.to(torch.float32).reshape(b, hk, rep, s, smax) * qk
    if alibi_slopes is not None:
        scores = scores + _alibi_bias(alibi_slopes, hk, rep, smax, dev)
    off = 0 if q_offset is None else int(q_offset)
    qpos = (off + torch.arange(s, device=dev))[:, None]
    kpos = torch.arange(smax, device=dev)[None, :]
    valid = (kpos <= qpos) & (kpos < int(prompt_len))
    scores = torch.where(valid, scores, f32(NEG, dev))
    p = torch.softmax(scores, dim=-1)
    vf = v_cache.to(torch.float32) * v_scale
    out = torch.matmul(p, vf[:, :, None])
    return out.reshape(b, h, s, dh)


def _lengths(length, b: int, device) -> torch.Tensor:
    if isinstance(length, torch.Tensor):
        return length.to(device=device, dtype=torch.int32).expand(b).contiguous()
    return torch.full((b,), int(length), dtype=torch.int32, device=device)


def int8_decode_attention_xla(q_s8, kt_cache, v_cache, length, q_scale, k_scale, v_scale,
                              apply_sqrt_dh: bool = True, quant_pv: bool = False,
                              alibi_slopes=None) -> torch.Tensor:
    """Plain single-token attention over the INT8 cache -> (B, H, Dh) f32;
    ``quant_pv`` quantises the exp-weights to int8 codes for an exact
    integer p @ V with 1/denom in the epilogue; ``alibi_slopes`` (H,) adds
    slope[h] x position to query head h's scores before the mask."""
    b, h, dh = q_s8.shape
    _, hk, _, smax = kt_cache.shape
    rep = h // hk
    dev = q_s8.device
    lengths = _lengths(length, b, dev)
    qk = qk_scale(q_scale, k_scale, dh, apply_sqrt_dh)
    s32 = int_matmul(q_s8.reshape(b, hk, rep, dh), kt_cache)
    s = s32.to(torch.float32) * qk
    if alibi_slopes is not None:
        s = s + _alibi_bias(alibi_slopes, hk, rep, smax, dev)[:, :, 0]
    pos = torch.arange(smax, device=dev)[None, None, None, :]
    s = torch.where(pos < lengths[:, None, None, None], s, f32(NEG, dev))
    if quant_pv:
        m = torch.amax(s, dim=-1, keepdim=True)
        e = torch.exp(s - m)
        denom = torch.sum(e, dim=-1, keepdim=True)
        acc = int_matmul(_quantize_exp(e), v_cache)
        out = acc.to(torch.float32) * ((v_scale / f32(127.0, dev)) / denom)
    else:
        p = torch.softmax(s, dim=-1)
        out = torch.matmul(p, v_cache.to(torch.float32) * v_scale)
    return out.reshape(b, h, dh)


def _kernel_scales(q_scale, k_scale, v_scale, dh: int, apply_sqrt_dh: bool) -> torch.Tensor:
    vs = v_scale.to(torch.float32)
    return torch.stack([qk_scale(q_scale, k_scale, dh, apply_sqrt_dh), vs,
                        vs / f32(127.0, vs.device)]).contiguous()


def _slopes(alibi_slopes, h: int, dev) -> Optional[torch.Tensor]:
    """The kernels' ALiBi operand: (H,) f32 on the card, or None."""
    if alibi_slopes is None:
        return None
    sl = torch.as_tensor(alibi_slopes).to(device=dev, dtype=torch.float32).contiguous()
    _cuda.require(sl, "alibi_slopes", torch.float32, (h,), dev, align=4)
    return sl


def _check_cache(kt_cache, v_cache, b: int, dh: int, dev):
    _, hk, _, smax = kt_cache.shape
    _cuda.require(kt_cache, "kt_cache", torch.int8, (b, hk, dh, smax), dev)
    _cuda.require(v_cache, "v_cache", torch.int8, (b, hk, smax, dh), dev)
    return hk, smax


def int8_prefill_attention(q_s8: torch.Tensor, kt_cache: torch.Tensor, v_cache: torch.Tensor,
                           prompt_len: Union[int, torch.Tensor], q_scale, k_scale, v_scale,
                           q_offset: Optional[Union[int, torch.Tensor]] = None, *,
                           apply_sqrt_dh: bool = True, alibi_slopes=None) -> torch.Tensor:
    """K2: causal flash attention over the INT8 cache -> (B, H, S, Dh) f32.

    q (B, H, S, Dh) int8 with S a multiple of 64 on CUDA; ``prompt_len`` is
    the total valid length, ``q_offset`` the absolute position of query row
    0; ``alibi_slopes`` (H,) f32 adds slope[h] x key position (the kernel's
    ALiBi instantiation).  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if q_s8.device.type == "cpu":
        return int8_prefill_attention_xla(q_s8, kt_cache, v_cache, prompt_len, q_scale,
                                          k_scale, v_scale, q_offset, apply_sqrt_dh,
                                          alibi_slopes)
    b, h, s, dh = q_s8.shape
    dev = q_s8.device
    _cuda.require(q_s8, "q_s8", torch.int8, (b, h, s, dh), dev)
    hk, smax = _check_cache(kt_cache, v_cache, b, dh, dev)
    plen, off = int(prompt_len), 0 if q_offset is None else int(q_offset)
    if h % hk or s % 64 or smax % 64 or dh not in (64, 128) or not 1 <= plen <= smax or off < 0:
        raise ValueError(f"K2 needs H % Hkv == 0, S % 64 == 0, Smax % 64 == 0, Dh in (64, 128), "
                         f"1 <= prompt_len <= Smax, q_offset >= 0; got H={h}, Hkv={hk}, S={s}, "
                         f"Smax={smax}, Dh={dh}, prompt_len={plen}, q_offset={off}")
    scales = _kernel_scales(q_scale, k_scale, v_scale, dh, apply_sqrt_dh)
    slopes = _slopes(alibi_slopes, h, dev)
    out = torch.empty((b, h, s, dh), dtype=torch.float32, device=dev)
    lib = _cuda.library(_cuda.SOURCES[PREFILL], _SIGNATURES[PREFILL])
    rc = lib.int8_prefill_attention(
        _cuda.ptr(q_s8), _cuda.ptr(kt_cache), _cuda.ptr(v_cache), _cuda.ptr(scales),
        _cuda.ptr(slopes), _cuda.ptr(out), b, h, hk, s, dh, smax, plen, off, _cuda.stream(dev))
    _cuda.check(rc, PREFILL)
    _cuda.count_launch(PREFILL if slopes is None else PREFILL + ALIBI)
    return out


def decode_rank_positions(length: int, cluster: int) -> int:
    """K3's positions per cluster rank for a slot of ``length`` valid
    positions: ceil(length / cluster) rounded up to 16 (16-byte copies);
    rank r takes [r * per, (r + 1) * per) of the valid positions."""
    return -(-(-(-length // cluster)) // 16) * 16


def decode_chmax(smax: int, cluster: int) -> int:
    """The most positions a rank can take: ceil(Smax / cluster) rounded up
    to the tile (the kernel's ``chmax``, its scores' row stride)."""
    return -(-(-(-smax // cluster)) // DECODE_TILE) * DECODE_TILE


def decode_smem_bytes(dh: int, rep: int, smax: int, cluster: int, scratch: bool = False) -> int:
    """K3's dynamic shared memory a block (the kernel's ``Layout``) at ``rep``
    query heads a kv head (or, K7, a head split's group): the ring
    of tiles, the scores and codes of the most positions a rank can take
    (none with ``scratch``: K7's device-memory scores), rank 0's gathering
    area of every rank's sums, the q.k partial sums."""
    scores = 0 if scratch else 5 * rep * decode_chmax(smax, cluster)
    return (DECODE_RING * dh * (DECODE_TILE + 16) + scores
            + 4 * cluster * rep * (dh + 1) + 4 * (DECODE_THREADS // 32) * rep * DECODE_TILE)


@functools.lru_cache(maxsize=1024)
def decode_plan(b: int, hk: int, rep: int, dh: int, smax: int, sms: int) -> int:
    """K3's cluster size (rep in DECODE_REPS; any other rep: ``rows_plan``):
    the largest in DECODE_CLUSTERS whose B x Hkv x cluster blocks fit
    DECODE_BLOCKS_PER_SM blocks an SM, else the smallest (a rank then streams
    at most half of a slot's positions); larger when the shared memory of
    the positions a rank can take (Smax / cluster) would not fit a block.
    Fitted on an H100 (``python -m dgq_tpu_torch.scripts.decode_plan_sweep``,
    ``PERF.md``): a call is a few microseconds of serial steps, so more
    blocks than the card runs at once only add waves."""
    if rep not in DECODE_REPS:
        raise ValueError(f"K3's whole kernels take rep in {DECODE_REPS}, got {rep}: rows_plan")
    fits = [c for c in DECODE_CLUSTERS
            if decode_smem_bytes(dh, rep, smax, c) <= DECODE_SMEM_LIMIT]
    if not fits:
        raise ValueError(f"K3: Smax {smax} at Dh {dh} and rep {rep} fits no cluster of "
                         f"{DECODE_CLUSTERS}")
    return _wave_cluster(b, hk, sms, fits)


def _wave_cluster(b: int, hk: int, sms: int, fits) -> int:
    """The largest of the clusters ``fits`` whose B x Hkv x cluster blocks fit
    DECODE_BLOCKS_PER_SM blocks an SM, else the smallest."""
    wave = [c for c in fits if b * hk * c <= DECODE_BLOCKS_PER_SM * sms]
    return max(wave) if wave else fits[0]


class ChunkedPlan(NamedTuple):
    """How K7's whole kernels run: each kv head's query heads in ``split``
    groups (virtual kv heads of rep / split query heads each, reading the
    same K and V), clusters of ``cluster`` blocks a (slot, virtual kv head),
    each rank's scores and codes in its block's shared memory, or
    (``scratch``) in a device-memory scratch of the wrapper's."""
    cluster: int
    scratch: bool
    split: int = 1


def decode_static_bytes(dh: int, rep: int) -> int:
    """The body's static shared memory a block: q's words, the block
    reduction's, the row maxima and exp sums, K7's slot (which shares the
    block's DECODE_SMEM_LIMIT with the dynamic)."""
    return 4 * rep * (dh // 4) + 4 * (DECODE_THREADS // 32) * rep + 3 * 4 * rep + 4


def chunked_splits(rep: int) -> list:
    """K7's head splits of its whole kernels (rep in DECODE_REPS), fewest
    virtual kv heads first: those of CHUNKED_SPLITS that divide rep."""
    return [s for s in CHUNKED_SPLITS if rep % s == 0]


def chunked_candidates(hk: int, rep: int, dh: int, smax: int) -> list:
    """Every plan K7's whole kernels can run a (Hkv, rep, Dh, Smax) cache
    with: for each split of ``chunked_splits(rep)``, each cluster of
    CHUNKED_CLUSTERS whose block holds its rank's scores, then each whose
    block fits with the scores in the scratch."""
    plans = []
    for split in chunked_splits(rep):
        r = rep // split
        room = DECODE_SMEM_LIMIT - decode_static_bytes(dh, r)
        plans += [ChunkedPlan(c, False, split) for c in CHUNKED_CLUSTERS
                  if decode_smem_bytes(dh, r, smax, c) <= room]
        plans += [ChunkedPlan(c, True, split) for c in CHUNKED_CLUSTERS
                  if decode_smem_bytes(dh, r, smax, c, True) <= room]
    return plans


def _blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` dynamic bytes (and the body's static ones, within
    1 KB) that share an SM's 228 KB, each with the 1 KB the card reserves."""
    return DECODE_SM_SMEM // (smem + 2048)


@functools.lru_cache(maxsize=1024)
def chunked_plan(b: int, hk: int, rep: int, dh: int, smax: int, sms: int) -> ChunkedPlan:
    """K7's plan for its whole kernels (rep in DECODE_REPS; any other rep:
    ``rows_plan``), fitted on an H100 at K7's shapes
    (``python -m dgq_tpu_torch.scripts.decode_plan_sweep --k7``, ``PERF.md``):
    K3's (``decode_plan``) for the caches K3 takes (up to DECODE_SHORT_SMAX
    positions), where a rank's few tiles make the launch's waves the cost;
    past them:
    - the smallest split of a kv head's rep query heads whose clusters of
      16 give at least CHUNKED_BLOCKS_PER_SM blocks an SM (one slot at 8
      query heads a kv head: 4 groups of 2);
    - clusters of 16, the largest: a long rank's serial tiles set the time;
    - each rank's scores in its block's shared memory where they fit,
      unless the block serves several query heads and the scratch lets more
      blocks share an SM (with one query head a block, the scratch's
      latency in the rank's serial loops cost more than a block an SM
      saved)."""
    if rep not in DECODE_REPS:
        raise ValueError(f"K7's whole kernels take rep in {DECODE_REPS}, got {rep}: rows_plan")
    if smax <= DECODE_SHORT_SMAX:
        return ChunkedPlan(decode_plan(b, hk, rep, dh, smax, sms), False)
    plans = chunked_candidates(hk, rep, dh, smax)
    if not plans:
        raise ValueError(f"K7: Dh {dh} at rep {rep} fits no block")
    split = next((s for s in CHUNKED_SPLITS if rep % s == 0
                  and b * hk * s * CHUNKED_CLUSTERS[-1] >= CHUNKED_BLOCKS_PER_SM * sms), rep)
    c = max(p.cluster for p in plans if p.split == split)
    r = rep // split
    held = ChunkedPlan(c, False, split) in plans
    more = (_blocks_per_sm(decode_smem_bytes(dh, r, smax, c, True))
            > _blocks_per_sm(decode_smem_bytes(dh, r, smax, c)))
    return ChunkedPlan(c, not held or (r > 1 and more), split)


class RowsPlan(NamedTuple):
    """How K3's and K7's split kernels (a rep outside DECODE_REPS) run a
    call: one cluster of ``cluster`` blocks a (slot, kv head), each block
    with every query row of the kv head.  fp p @ V runs in one pass over K
    and V against a running max, each warp's and rank's sums rescaled to the
    largest at the end.  quant_pv's codes need the slot's max first: between
    the max pass and the exp its scores stay in the block's shared memory,
    or (``recompute``) are computed again in a second pass, from the rank's
    K tiles kept in shared memory in fp16 (``keep_k``) or from K streamed
    again."""
    cluster: int
    recompute: bool = False
    keep_k: bool = False


def rows_threads(rep: int) -> int:
    """Threads a block of the split kernels: two warps a 16-row tile, and at
    least ROWS_MIN_THREADS (the warps past the rows' only copy and convert
    tiles)."""
    return max(ROWS_MIN_THREADS, 64 * -(-rep // 16))


def rows_smem_bytes(dh: int, rep: int, smax: int, plan: RowsPlan, quant_pv: bool) -> int:
    """The split kernels' dynamic shared memory a block under ``plan`` (the
    kernel's ``Layout``): the ring of raw tiles, the K tile (``recompute``
    and ``keep_k``: all the rank's K tiles) and the V tile in fp16, q's rows
    padded to 16 in fp16 and, with quant_pv unless ``recompute``, the f32
    scores of the most positions a rank can take (a row of ``decode_chmax``
    over the cluster's ranks, + 8)."""
    rp = 16 * -(-rep // 16)
    chmax = decode_chmax(smax, plan.cluster)
    ktiles = chmax // DECODE_TILE if plan.recompute and plan.keep_k else 1
    base = max(ROWS_RING_BYTES + (2 * ktiles + 2) * DECODE_TILE * dh, 4 * rp * (dh + 8))
    kept = quant_pv and not plan.recompute
    return base + 2 * rp * dh + (4 * rp * (chmax + 8) if kept else 0)


def _rows_modes(quant_pv: bool) -> tuple:
    """(recompute, keep_k) in the plan's order of preference: quant_pv's
    scores kept, recomputed from the kept K tiles, from K streamed again;
    fp p @ V keeps none."""
    return ((False, False), (True, True), (True, False)) if quant_pv else ((False, False),)


def rows_candidates(rep: int, dh: int, smax: int, quant_pv: bool = False) -> list:
    """Every plan the split kernels can run a (rep, Dh, Smax) cache with:
    for each of ``_rows_modes``, each cluster of ROWS_CLUSTERS whose block
    fits."""
    room = DECODE_SMEM_LIMIT - ROWS_STATIC_BYTES
    return [p for recompute, keep_k in _rows_modes(quant_pv)
            for p in (RowsPlan(c, recompute, keep_k) for c in ROWS_CLUSTERS)
            if rows_smem_bytes(dh, rep, smax, p, quant_pv) <= room]


def _rows_blocks_per_sm(dh: int, rep: int, smax: int, plan: RowsPlan, quant_pv: bool) -> int:
    """Blocks of the split kernels under ``plan`` that share an SM: its 64 K
    registers at the kernels' 128 a thread, its 2048 threads and 228 KB (the
    body's static bytes and the 1 KB the card reserves a block)."""
    smem = rows_smem_bytes(dh, rep, smax, plan, quant_pv)
    threads = rows_threads(rep)
    return min(65536 // (128 * threads), 2048 // threads,
               DECODE_SM_SMEM // (smem + ROWS_STATIC_BYTES + 1024))


@functools.lru_cache(maxsize=1024)
def rows_plan(b: int, hk: int, rep: int, dh: int, smax: int, sms: int,
              quant_pv: bool = False) -> RowsPlan:
    """The split kernels' plan, for K3 and K7 alike (so K7 takes K3's on the
    caches K3 takes), fitted on an H100
    (``python -m dgq_tpu_torch.scripts.decode_plan_sweep --rows``,
    ``PERF.md``): ranks enough that a rank takes at most ROWS_RANK_POSITIONS
    of the cache (a few serial tiles: a rank's tiles, not the bytes, set the
    time), at most 16; the cluster halved while its blocks would not all
    run at once; quant_pv's scores in shared memory where the block holds
    them, else recomputed from the rank's K tiles kept there, else from K
    streamed again."""
    if not 1 <= rep <= ROWS_MAX_REP:
        raise ValueError(f"the split kernels take 1 to {ROWS_MAX_REP} query heads a kv head, "
                         f"got {rep}")
    room = DECODE_SMEM_LIMIT - ROWS_STATIC_BYTES

    def plan(cluster):
        for recompute, keep_k in _rows_modes(quant_pv):
            p = RowsPlan(cluster, recompute, keep_k)
            if rows_smem_bytes(dh, rep, smax, p, quant_pv) <= room:
                return p
        raise ValueError(f"the split kernels: Dh {dh} at rep {rep} fits no block")

    ranks = min(16, max(2, 1 << (-(-smax // ROWS_RANK_POSITIONS) - 1).bit_length()))
    p = plan(ranks)
    while p.cluster > 2 and b * hk * p.cluster > _rows_blocks_per_sm(dh, rep, smax, p,
                                                                      quant_pv) * sms:
        p = plan(p.cluster // 2)
    return p


def int8_decode_attention(q_s8: torch.Tensor, kt_cache: torch.Tensor, v_cache: torch.Tensor,
                          length: Union[int, torch.Tensor], q_scale, k_scale, v_scale, *,
                          apply_sqrt_dh: bool = True, quant_pv: bool = False,
                          alibi_slopes=None) -> torch.Tensor:
    """K3: single-token attention over the INT8 cache -> (B, H, Dh) f32.

    ``length`` (int, () or (B,)) counts the valid cache positions per slot,
    the current token included; each must be at least 1.  ``alibi_slopes``
    (H,) f32 adds slope[h] x position (the kernel's ALiBi instantiation).
    A rep = H / Hkv outside DECODE_REPS runs the split kernels under
    ``rows_plan``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if q_s8.device.type == "cpu":
        return int8_decode_attention_xla(q_s8, kt_cache, v_cache, length, q_scale, k_scale,
                                         v_scale, apply_sqrt_dh, quant_pv, alibi_slopes)
    b, h, dh = q_s8.shape
    dev = q_s8.device
    _cuda.require(q_s8, "q_s8", torch.int8, (b, h, dh), dev, align=4)
    hk, smax = _check_cache(kt_cache, v_cache, b, dh, dev)
    if h % hk or smax % 4 or dh not in (64, 128) or h // hk > ROWS_MAX_REP:
        raise ValueError(f"K3 needs H % Hkv == 0, H / Hkv <= {ROWS_MAX_REP}, Smax % 4 == 0, "
                         f"Dh in (64, 128); got H={h}, Hkv={hk}, Smax={smax}, Dh={dh}")
    lengths = _lengths(length, b, dev)
    scales = _kernel_scales(q_scale, k_scale, v_scale, dh, apply_sqrt_dh)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slopes = _slopes(alibi_slopes, h, dev)
    if h // hk not in DECODE_REPS:
        return _rows_launch(DECODE, q_s8, kt_cache, v_cache, lengths, scales, quant_pv,
                            rows_plan(b, hk, h // hk, dh, smax, sms, quant_pv), slopes)
    return _decode_launch(q_s8, kt_cache, v_cache, lengths, scales, quant_pv,
                          decode_plan(b, hk, h // hk, dh, smax, sms), slopes)


def _decode_launch(q_s8, kt_cache, v_cache, lengths, scales, quant_pv: bool,
                   cluster: int, slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3's whole kernels (rep in DECODE_REPS) in clusters of
    ``cluster`` blocks on checked operands (``lengths`` (B,) int32, the
    kernel's scales and, for ALiBi, the (H,) slopes on the card)."""
    b, h, dh = q_s8.shape
    hk, smax = kt_cache.shape[1], kt_cache.shape[3]
    dev = q_s8.device
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    lib = _cuda.library(_cuda.SOURCES[DECODE], _SIGNATURES[DECODE])
    rc = lib.int8_decode_attention(
        _cuda.ptr(q_s8), _cuda.ptr(kt_cache), _cuda.ptr(v_cache), _cuda.ptr(lengths),
        _cuda.ptr(scales), _cuda.ptr(slopes), _cuda.ptr(out), b, h, hk, dh, smax,
        int(quant_pv), cluster, _cuda.stream(dev))
    _cuda.check(rc, DECODE)
    _cuda.count_launch(DECODE if slopes is None else DECODE + ALIBI)
    return out


def _rows_launch(name: str, q_s8, kt_cache, v_cache, lengths, scales, quant_pv: bool,
                 plan: RowsPlan, slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3's (``name`` DECODE) or K7's (CHUNKED) split kernels under
    ``plan`` on checked operands (``lengths`` (B,) int32, the kernel's
    scales and, for ALiBi, the (H,) slopes on the card); the launch counts
    under ``name`` + SPLIT (+ ALIBI)."""
    b, h, dh = q_s8.shape
    hk, smax = kt_cache.shape[1], kt_cache.shape[3]
    dev = q_s8.device
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    count_name = name + SPLIT + ("" if slopes is None else ALIBI)
    lib = _cuda.library(_cuda.SOURCES[count_name], _SIGNATURES[ROWS])
    rc = lib.int8_decode_attention_rows(
        _cuda.ptr(q_s8), _cuda.ptr(kt_cache), _cuda.ptr(v_cache), _cuda.ptr(lengths),
        _cuda.ptr(scales), _cuda.ptr(slopes), _cuda.ptr(out), b, h, hk, dh, smax,
        int(quant_pv), plan.cluster, int(plan.recompute) + int(plan.recompute and plan.keep_k),
        _cuda.stream(dev))
    _cuda.check(rc, count_name)
    _cuda.count_launch(count_name)
    return out


def _chunked_launch(q_s8, kt_cache, v_cache, lengths, scales, quant_pv: bool,
                    plan: ChunkedPlan, slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K7's whole kernels (rep in DECODE_REPS) under ``plan`` on
    checked operands (``lengths`` (B,) int32, the kernel's scales and, for
    ALiBi, the (H,) slopes on the card), with the ranks' scratch of (B, Hkv
    split, cluster, 5 (rep / split) chmax) bytes where the plan keeps the
    scores there."""
    b, h, dh = q_s8.shape
    hk, smax = kt_cache.shape[1], kt_cache.shape[3]
    dev = q_s8.device
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    scratch = None
    if plan.scratch:  # B Hkv split cluster runs of 5 (rep / split) chmax bytes
        scratch = torch.empty((b * hk * plan.cluster * 5 * (h // hk)
                               * decode_chmax(smax, plan.cluster),), dtype=torch.uint8, device=dev)
    name = CHUNKED if slopes is None else CHUNKED + ALIBI
    lib = _cuda.library(_cuda.SOURCES[name], _SIGNATURES[name])
    head = (_cuda.ptr(q_s8), _cuda.ptr(kt_cache), _cuda.ptr(v_cache), _cuda.ptr(lengths),
            _cuda.ptr(scales))
    tail = (_cuda.ptr(out), _cuda.ptr(scratch), b, h, hk, dh, smax, int(quant_pv),
            plan.cluster, plan.split, _cuda.stream(dev))
    if slopes is None:
        rc = lib.int8_decode_attention_chunked(*head, *tail)
    else:
        rc = lib.int8_decode_attention_chunked_alibi(*head, _cuda.ptr(slopes), *tail)
    _cuda.check(rc, name)
    _cuda.count_launch(name)
    return out


def gather_paged_kv(kt_pool: torch.Tensor, v_pool: torch.Tensor, table: torch.Tensor):
    """Densify a paged pool: (B, Hkv, Dh, NP*ps) K-transposed and
    (B, Hkv, NP*ps, Dh) V, in logical-position order."""
    b, npg = table.shape
    _, hk, dh, ps = kt_pool.shape
    idx = table.long()
    kt = kt_pool[idx].permute(0, 2, 3, 1, 4).reshape(b, hk, dh, npg * ps)
    v = v_pool[idx].permute(0, 2, 1, 3, 4).reshape(b, hk, npg * ps, dh)
    return kt, v


def int8_paged_decode_attention_xla(q_s8, kt_pool, v_pool, table, length, q_scale, k_scale,
                                    v_scale, apply_sqrt_dh: bool = True,
                                    quant_pv: bool = False) -> torch.Tensor:
    """Plain paged decode attention: gather the slots' pages dense, then the
    contiguous decode attention (unallocated pages are masked by length)."""
    kt, v = gather_paged_kv(kt_pool, v_pool, table)
    return int8_decode_attention_xla(q_s8, kt, v, length, q_scale, k_scale, v_scale,
                                     apply_sqrt_dh=apply_sqrt_dh, quant_pv=quant_pv)


def _check_heads(what: str, h: int, hk: int, dh: int, any_rep: bool = False) -> None:
    """K7 (``any_rep``) takes any H % Hkv == 0 up to ROWS_MAX_REP query heads
    a kv head; K8 and K11 H / Hkv in DECODE_REPS (their page address has no
    split kernels)."""
    if (h % hk or (h // hk not in DECODE_REPS and not (any_rep and h // hk <= ROWS_MAX_REP))
            or dh not in (64, 128)):
        reps = f"H % Hkv == 0, H / Hkv <= {ROWS_MAX_REP}" if any_rep else f"H / Hkv in {DECODE_REPS}"
        raise ValueError(f"{what} needs {reps} and Dh in (64, 128); "
                         f"got H={h}, Hkv={hk}, Dh={dh}")


def int8_decode_attention_chunked(q_s8: torch.Tensor, kt_cache: torch.Tensor,
                                  v_cache: torch.Tensor, length: Union[int, torch.Tensor],
                                  q_scale, k_scale, v_scale, *, chunk: int = 2048,
                                  apply_sqrt_dh: bool = True, quant_pv: bool = False,
                                  alibi_slopes=None) -> torch.Tensor:
    """K7: single-token attention over a long INT8 cache -> (B, H, Dh) f32.

    The same function as ``int8_decode_attention_xla``, its plain version:
    with ``quant_pv`` the codes are taken against the global row max over
    all positions.  ``chunk`` is JAX's chunk, which must divide Smax; the
    kernel (K3's body under ``chunked_plan``) does not walk chunks.
    ``length`` counts the valid positions per slot (each at least 1).
    ``alibi_slopes`` (H,) f32 adds slope[h] x position, as K3's (the ALiBi
    engines route caches past DECODE_SHORT_SMAX here, JAX's to its K3).  A
    rep = H / Hkv outside DECODE_REPS runs the split kernels under
    ``rows_plan``, as K3's.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    b, h, dh = q_s8.shape
    _, hk, _, smax = kt_cache.shape
    if chunk <= 0 or smax % chunk:
        raise ValueError(f"Smax {smax} must be a multiple of the chunk {chunk}")
    if q_s8.device.type == "cpu":
        return int8_decode_attention_xla(q_s8, kt_cache, v_cache, length, q_scale, k_scale,
                                         v_scale, apply_sqrt_dh, quant_pv, alibi_slopes)
    dev = q_s8.device
    _cuda.require(q_s8, "q_s8", torch.int8, (b, h, dh), dev, align=4)
    _check_cache(kt_cache, v_cache, b, dh, dev)
    _check_heads("K7", h, hk, dh, any_rep=True)
    if smax % 4:
        raise ValueError(f"K7 needs Smax % 4 == 0; got Smax={smax}")
    lengths = _lengths(length, b, dev)
    scales = _kernel_scales(q_scale, k_scale, v_scale, dh, apply_sqrt_dh)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slopes = _slopes(alibi_slopes, h, dev)
    if h // hk not in DECODE_REPS:
        return _rows_launch(CHUNKED, q_s8, kt_cache, v_cache, lengths, scales, quant_pv,
                            rows_plan(b, hk, h // hk, dh, smax, sms, quant_pv), slopes)
    return _chunked_launch(q_s8, kt_cache, v_cache, lengths, scales, quant_pv,
                           chunked_plan(b, hk, h // hk, dh, smax, sms), slopes)


def paged_smem_bytes(dh: int, rep: int, npg: int, ps: int, cluster: int,
                     kv4: bool = False) -> int:
    """K8's and K11's dynamic shared memory a block (the kernel's ``Layout``
    over the table's NP * ps positions): K3's, with K11's tiles of twice the
    positions (nibbles: the same bytes) and the rank's page cache
    (``rank_pages``, ``csrc/decode_attention.cuh``)."""
    tile = 2 * DECODE_TILE if kv4 else DECODE_TILE
    chmax = -(-(-(-(npg * ps) // cluster)) // tile) * tile
    return (DECODE_RING * dh * (DECODE_TILE + 16) + 5 * rep * chmax
            + 4 * cluster * rep * (dh + 1) + 4 * (DECODE_THREADS // 32) * rep * tile
            + 4 * (-(-chmax // ps) + 1))


@functools.lru_cache(maxsize=1024)
def paged_plan(b: int, hk: int, rep: int, dh: int, npg: int, ps: int, sms: int,
               kv4: bool = False) -> int:
    """K8's and K11's cluster size: K3's rule (``decode_plan``) for a cache
    of the table's NP * ps positions, among the clusters whose block with
    its page cache fits.  Held on an H100 at K8's and K11's shapes
    (``python -m dgq_tpu_torch.scripts.paged_plan_sweep``, ``PERF.md``)."""
    if ps <= 0 or ps % 4:
        raise ValueError(f"K8/K11 need a page size that is a multiple of 4; got {ps}")
    fits = [c for c in DECODE_CLUSTERS
            if paged_smem_bytes(dh, rep, npg, ps, c, kv4) <= DECODE_SMEM_LIMIT]
    if not fits:
        raise ValueError(f"K8/K11: a table of {npg} pages of {ps} positions at Dh {dh} and rep "
                         f"{rep} fits no cluster of {DECODE_CLUSTERS}")
    return _wave_cluster(b, hk, sms, fits)


def _paged_launch(q_s8, kt_pool, v_pool, table, lengths, scales, quant_pv: bool, kv4: bool,
                  cluster: int) -> torch.Tensor:
    """Launch K8 (or, ``kv4``, K11 on nibble pages) in clusters of
    ``cluster`` blocks on checked operands (``lengths`` (B,) int32 and the
    kernel's scales on the card)."""
    b, h, dh = q_s8.shape
    hk, ps = kt_pool.shape[1], kt_pool.shape[3]
    npg = table.shape[1]
    dev = q_s8.device
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    name = PAGED_KV4 if kv4 else PAGED
    lib = _cuda.library(_cuda.SOURCES[name], _SIGNATURES[name])
    head = (_cuda.ptr(q_s8), _cuda.ptr(kt_pool), _cuda.ptr(v_pool), _cuda.ptr(table),
            _cuda.ptr(lengths), _cuda.ptr(scales), _cuda.ptr(out), b, h, hk, dh, ps, npg, cluster)
    if kv4:
        rc = lib.int4_paged_decode_attention(*head, _cuda.stream(dev))
    else:
        rc = lib.int8_paged_decode_attention(*head, int(quant_pv), _cuda.stream(dev))
    _cuda.check(rc, name)
    _cuda.count_launch(name)
    return out


def int8_paged_decode_attention(q_s8: torch.Tensor, kt_pool: torch.Tensor,
                                v_pool: torch.Tensor, table: torch.Tensor,
                                length: Union[int, torch.Tensor], q_scale, k_scale, v_scale, *,
                                apply_sqrt_dh: bool = True,
                                quant_pv: bool = False) -> torch.Tensor:
    """K8: single-token attention over a paged INT8 pool -> (B, H, Dh) f32.

    Logical page c of slot b lives at pool page ``table[b, c]``; positions at
    or past ``length[b]`` (each at least 1) are masked, so unallocated
    entries may point at the null page.  The same function as K7 over the
    gathered cache (``int8_paged_decode_attention_xla``, its plain version).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q_s8.device.type == "cpu":
        return int8_paged_decode_attention_xla(q_s8, kt_pool, v_pool, table, length, q_scale,
                                               k_scale, v_scale, apply_sqrt_dh, quant_pv)
    b, h, dh = q_s8.shape
    p, hk, _, ps = kt_pool.shape
    npg = table.shape[1]
    dev = q_s8.device
    _cuda.require(q_s8, "q_s8", torch.int8, (b, h, dh), dev, align=4)
    _cuda.require(kt_pool, "kt_pool", torch.int8, (p, hk, dh, ps), dev)
    _cuda.require(v_pool, "v_pool", torch.int8, (p, hk, ps, dh), dev)
    _cuda.require(table, "table", torch.int32, (b, npg), dev, align=4)
    _check_heads("K8", h, hk, dh)
    lengths = _lengths(length, b, dev)
    scales = _kernel_scales(q_scale, k_scale, v_scale, dh, apply_sqrt_dh)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _paged_launch(q_s8, kt_pool, v_pool, table, lengths, scales, quant_pv, False,
                         paged_plan(b, hk, h // hk, dh, npg, ps, sms))


def int4_paged_decode_attention_xla(q_s8, kt_pool, v_pool, table, length, q_scale, k_scale4,
                                   v_scale4, apply_sqrt_dh: bool = True) -> torch.Tensor:
    """Plain paged decode attention over INT4 nibble pages: unpack both
    pools, then K8's plain version with fp p @ V (INT4 KV never takes
    quant_pv).  ``k_scale4``/``v_scale4`` are the effective int4 scales."""
    return int8_paged_decode_attention_xla(q_s8, unpack_nibbles(kt_pool, axis=2),
                                           unpack_nibbles(v_pool, axis=-1), table, length,
                                           q_scale, k_scale4, v_scale4,
                                           apply_sqrt_dh=apply_sqrt_dh, quant_pv=False)


def int4_paged_decode_attention(q_s8: torch.Tensor, kt_pool: torch.Tensor,
                                v_pool: torch.Tensor, table: torch.Tensor,
                                length: Union[int, torch.Tensor], q_scale, k_scale4, v_scale4, *,
                                apply_sqrt_dh: bool = True) -> torch.Tensor:
    """K11: single-token attention over a paged pool of INT4 nibble pages ->
    (B, H, Dh) f32.

    ``kt_pool`` (P, Hkv, Dh/2, ps) and ``v_pool`` (P, Hkv, ps, Dh/2) hold two
    signed int4 codes per byte along Dh, the even dim in the low nibble;
    ``k_scale4``/``v_scale4`` are the effective int4 scales (int8 scale x
    127/7, ``ops/kv4.kv4_scale``).  Table and lengths as K8.  The int32 q.k
    and the fp32 softmax and p @ V of ``int4_paged_decode_attention_xla``, its
    plain version.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if q_s8.device.type == "cpu":
        return int4_paged_decode_attention_xla(q_s8, kt_pool, v_pool, table, length, q_scale,
                                               k_scale4, v_scale4, apply_sqrt_dh)
    b, h, dh = q_s8.shape
    p, hk, dh2, ps = kt_pool.shape
    npg = table.shape[1]
    dev = q_s8.device
    if 2 * dh2 != dh:
        raise ValueError(f"K11 needs nibble pages of Dh / 2 = {dh // 2} bytes, got {dh2}")
    _cuda.require(q_s8, "q_s8", torch.int8, (b, h, dh), dev, align=4)
    _cuda.require(kt_pool, "kt_pool", torch.int8, (p, hk, dh2, ps), dev)
    _cuda.require(v_pool, "v_pool", torch.int8, (p, hk, ps, dh2), dev)
    _cuda.require(table, "table", torch.int32, (b, npg), dev, align=4)
    _check_heads("K11", h, hk, dh)
    lengths = _lengths(length, b, dev)
    scales = _kernel_scales(q_scale, k_scale4, v_scale4, dh, apply_sqrt_dh)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _paged_launch(q_s8, kt_pool, v_pool, table, lengths, scales, False, True,
                         paged_plan(b, hk, h // hk, dh, npg, ps, sms, True))
