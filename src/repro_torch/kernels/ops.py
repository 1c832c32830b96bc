"""Wrappers of the port's CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, and launches its kernel on the current CUDA
stream. Tensors on the CPU take the kernel's plain version in `ref.py`
(that is how the CPU tests run); tensors on a GPU launch the kernel or
raise, never fall back. Each wrapper counts its kernel launches in
`<wrapper>.launches` (`launch_counts`, `reset_launch_counts`), so a run
can show that its path went through the kernels.

The launch path is kept short, since most calls of the port take a few
microseconds of device time: one pass of checks per wrapper (`_checked`),
the C entry point from `build.ENTRY`, and the current stream's raw handle
without building a `torch.cuda.Stream` (`_stream`).

A wrapper on the dry run's path (`flash_prefill`, `flash_prefill_paged`,
`decode_attention`, `decode_attention_q8`, `ecoscan`) handed a tensor
without data (fake or meta) takes the trace route of `cost.node`: it
records its kernel's node, costed by `kernels/cost.py`, in the active
dry-run trace and returns empty outputs; outside a trace it raises. It
computes nothing there: no plain version runs.

A launch that fails raises `KernelError` (as does a kernel that does not
build or load). `is_kernel_fault` tells such a fault, or a CUDA error
that PyTorch raised, from any other exception: the serving ladders
(retrieval and SCR fallbacks, the session's retry, the schedulers'
strikes) degrade around the others and re-raise kernel faults.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import build, cost, ref
from repro_torch.kernels.build import KernelError

KERNELS = ("kmeans_assign", "ecoscan", "scr_select", "decode_attention_paged",
           "flash_prefill", "decode_attention", "scr_score", "pq_adc",
           "decode_attention_q8", "decode_attention_paged_q8",
           "flash_prefill_paged")


def _checked(*specs) -> torch.device:
    """Check each (tensor, name, dtype, ndim) of `specs`: one device for
    all, the dtype, the number of dimensions, contiguity. Returns the
    device."""
    dev = specs[0][0].device
    for t, name, dtype, ndim in specs:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{ndim}-d")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    return dev


# PyTorch's raw getter of the current stream (the one Triton's launcher
# uses); the public call builds a torch.cuda.Stream object on every call
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev: torch.device) -> int:
    """The current CUDA stream of `dev` (the current device when `dev`
    has no index) as a cudaStream_t handle."""
    idx = dev.index
    if idx is None:
        idx = torch.cuda.current_device()
    if _raw_stream is not None:
        return _raw_stream(idx)
    return torch.cuda.current_stream(idx).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise KernelError(f"{name} kernel launch failed: cudaError {err}")


# PyTorch's exception for an error the device reported (where the
# installed torch has it)
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)


def is_kernel_fault(e: BaseException) -> bool:
    """Whether `e` is a fault of a kernel or of the device: a
    `KernelError`, PyTorch's `AcceleratorError`, or a RuntimeError whose
    message starts "CUDA error". A fallback that catches exceptions
    re-raises these."""
    if isinstance(e, KernelError):
        return True
    if _ACCELERATOR_ERROR is not None and isinstance(e, _ACCELERATOR_ERROR):
        return True
    return isinstance(e, RuntimeError) and str(e).startswith("CUDA error")


def _no_backward(name: str, *ts: torch.Tensor) -> None:
    """The attention kernels have no backward, so a wrapper refuses an
    input that autograd tracks (grad mode on and requires_grad): its
    output would carry no gradient on the card. It refuses on the CPU
    too, where the plain version would have differentiated, so the CPU
    tests see what the card would hide. Training attends through
    `models.layers.attention`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError(f"{name}: an input requires grad, and the kernel "
                         "has no backward (train through "
                         "models.layers.attention)")


_DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _attention_dtype(q: torch.Tensor) -> str:
    """The C entry point's suffix for q's dtype (f32 or bf16)."""
    if q.dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"q: dtype {q.dtype}, expected f32 or bf16")
    return _DTYPE_SUFFIX[q.dtype]


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor):
    """x [N, d] f32; centroids [NC, d] f32 -> (assign [N] i32, sqdist [N]
    f32): each row's nearest centroid (lower id on ties) and its squared
    distance (||x||^2 - 2 x.c) + ||c||^2."""
    dev = _checked((x, "x", torch.float32, 2),
                   (centroids, "centroids", torch.float32, 2))
    N, d = x.shape
    NC = centroids.shape[0]
    if centroids.shape[1] != d or NC == 0:
        raise ValueError(f"centroids {tuple(centroids.shape)} vs x "
                         f"{tuple(x.shape)}")
    if dev.type == "cpu":
        return ref.kmeans_assign(x, centroids)
    assign = torch.empty(N, dtype=torch.int32, device=dev)
    sqdist = torch.empty(N, dtype=torch.float32, device=dev)
    if N:
        _raise_on(build.entry("kmeans_assign")(
            x.data_ptr(), centroids.data_ptr(), N, NC, d, assign.data_ptr(),
            sqdist.data_ptr(), _stream(dev)),
            "kmeans_assign")
        kmeans_assign.launches += 1
    return assign, sqdist


# ecoscan's merge keeps two top-k buffers of (distance, flat, slot) and
# a chunk of 256 candidates in shared memory (csrc/ecoscan.cu)
ECOSCAN_MAX_K = (227 * 1024 // 4 - 3 * 256) // 6
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The ticket counters of the kernels whose last block merges
    (ecoscan: one a query; decode_attention: one a (row, kv head, head
    group)) for launches on `stream` of `dev`: at least n ints, zero
    before a launch and zero again after it (the last block of each
    counter resets it). One buffer a stream, shared by those kernels
    (launches on one stream do not overlap), so launches on two streams
    share no counter; it is allocated (zeroed) only when a larger n
    first comes."""
    t = _tickets.get((dev.index, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _tickets[(dev.index, stream)] = t
    return t


def ecoscan(q: torch.Tensor, data: torch.Tensor, lens: torch.Tensor,
            probes: torch.Tensor, k: int,
            block_map: Optional[torch.Tensor] = None):
    """q [B, d] f32; data [R, CAP, d] f32; lens [R] i32; probes [B, P] i32
    (< 0: padding); block_map [NC] i32 (identity when None). Returns the
    k nearest probed rows per query: (dists [B, k] f32, slots [B, k] i32
    = row*CAP + j), (NEG, -1) past the valid candidates. On the card one
    launch scans tiles of ref.ECOSCAN_TILE rows of every probed list and
    the last block of each query merges them; a None block_map is a null
    pointer, the kernel's identity."""
    specs = ((q, "q", torch.float32, 2), (data, "data", torch.float32, 3),
             (lens, "lens", torch.int32, 1), (probes, "probes", torch.int32, 2))
    if block_map is not None:
        specs += ((block_map, "block_map", torch.int32, 1),)
    dev = _checked(*specs)
    B, d = q.shape
    R, CAP, d2 = data.shape
    P = probes.shape[1]
    if d2 != d or lens.shape[0] != R or probes.shape[0] != B or k < 1:
        raise ValueError("ecoscan shapes disagree")
    if R * CAP >= 2 ** 31:
        raise ValueError(f"ecoscan: {R} x {CAP} slots pass the int32 slot "
                         "ids")
    if cost.traced(q):
        return cost.node("ecoscan", lambda: (
            q.new_empty((B, k)), q.new_empty((B, k), dtype=torch.int32)),
            q, data, lens, probes, k, block_map)
    if dev.type == "cpu":
        return ref.ecoscan(q, data, lens, probes, k, block_map=block_map)
    if B == 0 or P == 0 or CAP == 0:
        return (torch.full((B, k), ref.NEG, dtype=torch.float32, device=dev),
                torch.full((B, k), -1, dtype=torch.int32, device=dev))
    if B > 65535 or k > ECOSCAN_MAX_K:
        raise ValueError(f"ecoscan: B {B} > 65535 or k {k} > {ECOSCAN_MAX_K}"
                         " (the merge's shared memory)")
    out = ecoscan_launch(q, data, lens, probes, k, block_map)
    ecoscan.launches += 1
    return out


ECOSCAN_TILES = (16, 32, 64)    # the tiles of the C entry `ecoscan_tile`


def ecoscan_launch(q, data, lens, probes, k: int, block_map=None,
                   tile: Optional[int] = None):
    """Launch the ecoscan kernel on CUDA tensors that pass `ecoscan`'s
    checks (no launch counted): through the C entry `ecoscan` at
    ref.ECOSCAN_TILE when `tile` is None (the wrapper's call), else
    through `ecoscan_tile` at a forced tile of ECOSCAN_TILES rows (probes
    and checks on the card). Returns (dists, slots) as `ecoscan`."""
    B, d = q.shape
    CAP = data.shape[1]
    P = probes.shape[1]
    t = ref.ECOSCAN_TILE if tile is None else tile
    # the merge writes every output slot; scratch: a sorted list of
    # min(k, t) (distance, flat, slot) triples for each of the tiles
    out_d = torch.empty((B, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=q.device)
    scratch = torch.empty(3 * B * P * (-(-CAP // t)) * min(k, t),
                          dtype=torch.int32, device=q.device)
    stream = _stream(q.device)
    args = (q.data_ptr(), data.data_ptr(), lens.data_ptr(), probes.data_ptr(),
            None if block_map is None else block_map.data_ptr(), B, CAP, d,
            P, k)
    rest = (scratch.data_ptr(), tickets(q.device, stream, B).data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), stream)
    if tile is None:
        _raise_on(build.entry("ecoscan")(*args, *rest), "ecoscan")
    else:
        _raise_on(build.entry("ecoscan_tile")(*args, tile, *rest),
                  f"ecoscan at tile {tile}")
    return out_d, out_i


def scr_select(q: torch.Tensor, data: torch.Tensor, lens: torch.Tensor,
               doc_ids: torch.Tensor):
    """q [B, d] f32; data [ND, CAPW, d] f32; lens [ND] i32; doc_ids
    [B, K] i32 (< 0: padding). Returns (scores [B, K] f32, wins [B, K]
    i32): each doc's best window score and id, (-NEG, -1) for padding
    and windowless docs."""
    dev = _checked((q, "q", torch.float32, 2),
                   (data, "data", torch.float32, 3),
                   (lens, "lens", torch.int32, 1),
                   (doc_ids, "doc_ids", torch.int32, 2))
    B, d = q.shape
    ND, CAPW, d2 = data.shape
    K = doc_ids.shape[1]
    if d2 != d or lens.shape[0] != ND or doc_ids.shape[0] != B:
        raise ValueError("scr_select shapes disagree")
    if dev.type == "cpu":
        return ref.scr_select(q, data, lens, doc_ids)
    if B == 0 or K == 0 or ND == 0 or CAPW == 0:
        return (torch.full((B, K), -ref.NEG, dtype=torch.float32, device=dev),
                torch.full((B, K), -1, dtype=torch.int32, device=dev))
    # one warp of each (query, doc slot) pair writes its output entry
    scores = torch.empty((B, K), dtype=torch.float32, device=dev)
    wins = torch.empty((B, K), dtype=torch.int32, device=dev)
    _raise_on(build.entry("scr_select")(
        q.data_ptr(), data.data_ptr(), lens.data_ptr(), doc_ids.data_ptr(),
        B, CAPW, d, K, scores.data_ptr(), wins.data_ptr(), _stream(dev)),
        "scr_select")
    scr_select.launches += 1
    return scores, wins


SM_COUNT = 132        # streaming multiprocessors of an H100 SXM
FLASH_PREFILL_DH = (32, 64, 80, 128, 256)
# keys per tile of flash_prefill: 64 on the bf16 `tc` route
# (csrc/flash_prefill.cu `kBK`), 32 on the f32 route
# (csrc/prefill_f32.cuh `kTK`). Keys that
# start at a multiple of it split into the same tiles, summed in the same
# order, as keys that start at position 0
FLASH_KEY_TILE = 64
# flash_prefill's routes: "cuda" (f32 on the CUDA cores, the 1e-5
# check), "tc" (bf16 on `mma.sync`, csrc/flash_prefill.cu), "wgmma" (bf16
# on `wgmma` fed by TMA, csrc/flash_prefill_sm90.cu) at PREFILL_WGMMA_DH
PREFILL_ROUTES = ("cuda", "tc", "wgmma")
PREFILL_WGMMA_DH = (64, 80, 128, 256)
# the plans (keys a tile, stages, consumer warpgroups of 64 query rows,
# blocks an SM) that csrc/flash_prefill_sm90.cu compiles
# (FLASH_WGMMA_PLAN) at each dh. The first is the long plan, whose keys
# are the route's key tile: at dh 64 one consumer, two blocks an SM (the
# two blocks' warpgroups overlap each other's exponentials and products
# with no turns to take; two consumers taking turns measured slower,
# PERF.md), at dh 80 (rows padded to 128 columns in shared memory) and
# dh 128 two consumers taking turns (at h2o's wave row 0.282 ms against
# 0.359 for dh 64's way at 64-key tiles, PERF.md), at dh 256 one consumer
# and one block an SM. The narrow plan (the long plan's keys, one
# consumer: at dh 64 and 256 the long plan itself) takes a grid that the
# long plan's blocks would not spread over every SM, the short plan
# (64-key tiles, one consumer: at dh 256 the long plan too) at most
# PREFILL_SHORT keys
PREFILL_PLANS = {64: ((128, 2, 1, 2), (64, 2, 1, 3)),
                 80: ((128, 2, 2, 1), (128, 2, 1, 1), (64, 2, 1, 2)),
                 128: ((128, 2, 2, 1), (128, 2, 1, 1), (64, 2, 1, 2)),
                 256: ((64, 2, 1, 1),)}
PREFILL_SHORT = 64    # keys that the short plan takes


def prefill_route(dtype: torch.dtype, dh: int) -> str:
    """The route of a `flash_prefill` call, by dtype and dh alone (so a
    wave's full prefill and the continuous engine's chunks of one model
    take the same): "wgmma" for bf16 at dh in PREFILL_WGMMA_DH, "tc" for
    bf16 at any other dh (32; the tc route stays as the yardstick that
    `flash_prefill_launch(route="tc")` forces), "cuda" for f32."""
    if dtype is torch.bfloat16:
        return "wgmma" if dh in PREFILL_WGMMA_DH else "tc"
    return "cuda"


def _plan_info(dh: int, plan: Tuple[int, int, int, int]) -> Dict[str, int]:
    keys, stages, consumers, per_sm = plan
    rows = 64 * consumers
    dhp = -(-dh // 64) * 64     # a row padded to the 64-column atoms
    return {"keys": keys, "stages": stages, "consumers": consumers,
            "blocks_per_sm": per_sm, "rows": rows,
            "smem": 1024 + (rows + 2 * stages * keys) * dhp * 2 + 256}


# every compiled plan's info, and each dh's (long, narrow, short) plans,
# built once: a chunk's call is launch-bound, so the pick is a lookup
_PLAN_INFO = {(dh, p): _plan_info(dh, p) for dh, plans in PREFILL_PLANS.items()
              for p in plans}
_PLAN_PICKS = {dh: (plans[0],
                    next(p for p in plans if p[0] == plans[0][0]
                         and p[2] == 1),
                    next(p for p in plans if p[0] == PREFILL_SHORT
                         and p[2] == 1))
               for dh, plans in PREFILL_PLANS.items()}


def prefill_plan(dh: int, Sq: Optional[int] = None, Sk: Optional[int] = None,
                 blocks: int = SM_COUNT,
                 plan: Optional[Tuple[int, int, int, int]] = None
                 ) -> Dict[str, int]:
    """The wgmma route's tile for Sq queries over Sk keys at dh in
    `blocks` (batch x query heads) blocks of query rows, or a forced
    `plan` of PREFILL_PLANS[dh]: the short plan where Sk <=
    PREFILL_SHORT, the narrow plan where the long plan's grid has fewer
    blocks than the card has SMs, else the long plan. A row's sums depend
    only on the key tiles, not on the block that holds it, so every
    choice gives the long plan's output: the narrow plan's keys are the
    long plan's, and the short plan's keys fall in one tile either way.
    Returns (a shared dict: read, do not change) keys, stages,
    consumers, blocks_per_sm, rows (64 a consumer) and the block's shared
    bytes (`Plan::SMEM`: 1 KB of alignment, Q [rows, dh] and the K and V
    rings [stages, keys, dh] in bf16 with dh padded to a multiple of 64,
    256 bytes of mbarriers), which the wrapper hands to the kernel: it
    refuses a plan it does not compile or bytes that are not the plan's."""
    if plan is None:
        long_, narrow, short = _PLAN_PICKS[dh]
        plan = long_
        if Sk is not None and Sk <= PREFILL_SHORT:
            plan = short
        elif Sq is not None and blocks * -(-Sq // (64 * long_[2])) < SM_COUNT:
            plan = narrow
    return _PLAN_INFO[(dh, tuple(plan))]


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0, kv_len: Optional[int] = None):
    """q [B, Sq, H, dh]; k, v [B, Sk, G, dh] (f32 or bf16, same as q;
    H % G == 0). Query i at absolute position q_offset + i attends the
    keys at positions < kv_len (Sk when None) that `causal` and `window`
    leave unmasked. Returns [B, Sq, H, dh] in q's dtype. On the card the
    call is one launch on the route `prefill_route` picks (bf16 on the
    tensor cores, by `wgmma` at dh 64, 80, 128 and 256 and by `mma.sync`
    at dh 32; f32 on the CUDA cores, in full f32); dh is one of
    FLASH_PREFILL_DH. Counts its launches by route in
    `flash_prefill.routes`. Refuses inputs that require grad
    (`_no_backward`)."""
    _no_backward("flash_prefill", q, k, v)
    _attention_dtype(q)
    dev = _checked((q, "q", q.dtype, 4), (k, "k", q.dtype, 4),
                   (v, "v", q.dtype, 4))
    B, Sq, H, dh = q.shape
    Bk, Sk, G, dhk = k.shape
    if v.shape != k.shape or Bk != B or dhk != dh or G == 0 or H % G:
        raise ValueError(f"flash_prefill shapes disagree: q {tuple(q.shape)},"
                         f" k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q_offset < 0 or (window is not None and window < 1):
        raise ValueError(f"q_offset {q_offset} < 0 or window {window} < 1")
    kv = Sk if kv_len is None else max(0, min(int(kv_len), Sk))
    if cost.traced(q):
        return cost.node("flash_prefill", lambda: torch.empty_like(q), q, k,
                         v, causal=causal, window=window, q_offset=q_offset,
                         kv_len=kv)
    if dev.type == "cpu":
        return ref.flash_prefill(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv)
    if dh not in FLASH_PREFILL_DH:
        raise ValueError(f"flash_prefill: dh {dh} not in {FLASH_PREFILL_DH}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill: q, k, v must be 16-byte aligned")
    route = prefill_route(q.dtype, dh)
    out = flash_prefill_launch(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv, route=route)
    if B and Sq and H:
        flash_prefill.launches += 1
        flash_prefill.routes[route] += 1
    return out


def flash_prefill_launch(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None, q_offset: int = 0,
                         kv_len: Optional[int] = None,
                         route: Optional[str] = None,
                         plan: Optional[Tuple[int, int, int, int]] = None):
    """Launch flash_prefill on CUDA tensors that pass `flash_prefill`'s
    checks (no launch counted) -> [B, Sq, H, dh]: on the route
    `prefill_route` picks and the plan `prefill_plan` gives where `route`
    and `plan` are None, else on a forced route ("cuda", "tc" or
    "wgmma") and, on the wgmma route, a forced plan of PREFILL_PLANS[dh],
    for checks and probes. Raises ValueError for a route or plan that q's
    dtype or dh does not take: "cuda" takes f32, "tc" bf16, "wgmma" bf16
    at PREFILL_WGMMA_DH (`prefill_plan`'s tile for the shape where `plan`
    is None)."""
    B, Sq, H, dh = q.shape
    Sk, G = k.shape[1], k.shape[2]
    kv = Sk if kv_len is None else max(0, min(int(kv_len), Sk))
    route = prefill_route(q.dtype, dh) if route is None else route
    if (route not in PREFILL_ROUTES or dh not in FLASH_PREFILL_DH
            or (route == "cuda") != (q.dtype is torch.float32)
            or q.dtype not in _DTYPE_SUFFIX
            or (route == "wgmma" and dh not in PREFILL_WGMMA_DH)
            or (plan is not None and (route != "wgmma" or tuple(plan)
                                      not in PREFILL_PLANS[dh]))):
        raise ValueError(f"flash_prefill: route {route!r}, plan {plan} not "
                         f"taken at q {tuple(q.shape)} ({q.dtype})")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0 or H == 0:
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Sq, Sk, H, G, dh,
            int(causal), window or 0, q_offset, kv, 1.0 / math.sqrt(dh))
    stream = _stream(q.device)
    if route == "wgmma":
        p = prefill_plan(dh, Sq, Sk, B * H, plan)
        err = build.entry("flash_prefill_wgmma")(
            *args, p["keys"], p["stages"], p["consumers"], p["blocks_per_sm"],
            p["smem"], out.data_ptr(), stream)
    else:
        err = build.entry("flash_prefill_" + _DTYPE_SUFFIX[q.dtype])(
            *args, out.data_ptr(), stream)
    if err:
        _raise_on(err, f"flash_prefill ({route}, plan {plan})")
    return out


# flash_prefill_paged's bf16 routes (csrc/flash_prefill_paged.cu
# namespace tc: a warp's m-tile of 16 rows each; csrc/
# flash_prefill_paged_sm90.cu: one consumer warpgroup's wgmma rows): 64
# query rows a block, key tiles of 64 (32 at dh 256 on tc, which divides
# it). A chunk's history starts at a multiple of PAGED_KEY_TILE in bf16
# (`prefill_paged_key_tile`)
PAGED_ROWS = 64
PAGED_KEY_TILE = 64
# flash_prefill_paged's routes: "cuda" (f32 q on the CUDA cores,
# bit-equal to flash_prefill on the gathered buffer), "tc" (bf16 q on
# `mma.sync`), "wgmma" (bf16 q on `wgmma` fed by TMA boxes of the pages)
# at PAGED_WGMMA_DH: every paged path's dh (qwen2.5 and granite-moe 64,
# h2o-danube 80, the zoo's 128)
PAGED_ROUTES = ("cuda", "tc", "wgmma")
PAGED_WGMMA_DH = (64, 80, 128)


def prefill_paged_route(dtype: torch.dtype, dh: int) -> str:
    """The route of a `flash_prefill_paged` call, by q's dtype and dh
    alone (a bf16 or an int8 pool alike): "wgmma" for bf16 at dh in
    PAGED_WGMMA_DH, "tc" for bf16 at any other dh, "cuda" for f32."""
    if dtype is torch.bfloat16:
        return "wgmma" if dh in PAGED_WGMMA_DH else "tc"
    return "cuda"


def prefill_paged_key_tile(dtype: torch.dtype, dh: int) -> int:
    """The key tile that a chunk's first history position rounds down to
    (`dense.chunk_rows`) on the route `flash_prefill_paged` takes at
    (dtype, dh): PAGED_KEY_TILE for bf16 (both tensor-core routes'
    tiles), FLASH_KEY_TILE in f32 (a multiple of the f32 route's 32-key
    tiles, so that a chunk sums in the tiles of the wave's full prefill,
    bit for bit)."""
    return PAGED_KEY_TILE if dtype is torch.bfloat16 else FLASH_KEY_TILE


class PagedPlan(NamedTuple):
    """A flash_prefill_paged launch on the tensor cores (route tc or
    wgmma, the same plan): grid (splits, row_blocks, G); the call's
    `tiles` key tiles of `key_tile` keys from key-buffer position `kbeg`
    (the kernel takes all three from here). The kernel's split s walks
    the tiles [s * tiles // splits, (s + 1) * tiles // splits)."""
    splits: int
    row_blocks: int
    key_tile: int
    kbeg: int
    tiles: int


@functools.lru_cache(maxsize=4096)
def prefill_paged_plan(C: int, hist: int, G: int, Hg: int, dh: int,
                       window: Optional[int] = None,
                       splits: Optional[int] = None) -> PagedPlan:
    """The bf16 routes' plan for a chunk of C queries over `hist`
    history keys (offset - lo), G kv heads of Hg query heads at dh, from
    these host-known ints alone (a chunk's call is launch-bound, so the
    plan is a cached lookup). The key walk starts at the first query's
    window rounded down to the key tile (`kbeg`) and ends at the last
    query (key-buffer position hist + C). Row blocks of PAGED_ROWS of
    the group's Hg * C (position, head) rows; as many splits as one wave of
    G * row_blocks * splits blocks over the card's SM_COUNT SMs holds (a
    block past them waits for a whole split's walk: at h2o's last ring
    chunk on an H100, 9 splits, 144 blocks, took 0.0315 ms against 8's
    0.0265 by attention_probe --chunk), at least two tiles a split, one
    split where that gives fewer than two (a one-tile history); `splits`
    forces a count (1 .. tiles) for checks and probes."""
    bk = PAGED_KEY_TILE if dh <= 128 else PAGED_KEY_TILE // 2
    kbeg = max(0, hist - window + 1) // bk * bk if window else 0
    tiles = -(-(hist + C - kbeg) // bk)
    rows = -(-Hg * C // PAGED_ROWS)
    if splits is None:
        splits = min(tiles // 2, SM_COUNT // (G * rows))
        splits = splits if splits >= 2 else 1
    elif not 1 <= splits <= max(1, tiles):
        raise ValueError(f"flash_prefill_paged: {splits} splits of {tiles} "
                         "key tiles")
    return PagedPlan(splits, rows, bk, kbeg, tiles)


def flash_prefill_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        row: torch.Tensor, *, offset: int, lo: int,
                        page_size: int, ring_len: int = 0,
                        window: Optional[int] = None,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None):
    """A prompt chunk's attention over its slot's page pool, the history
    read in the kernel. q [1, C, H, dh] (f32 or bf16); k, v [C, G, dh] the
    chunk's own keys in q's dtype; k_pool, v_pool [P, page_size, G, dh]
    one layer of the pool, in q's dtype or int8 with f32 scales k_scale,
    v_scale [P, page_size, G]; row [W] i32 the slot's page-table row;
    `offset`, `lo` the chunk's first position and its history's
    (`dense.chunk_rows`), offset - lo within the ring (`ring_len`, or
    W * page_size for a row that never wraps). Computes
    `ref.flash_prefill_paged`: the history [lo, offset) through the row,
    then the chunk, causal within `window`. Returns [1, C, H, dh] in q's
    dtype. On the card one launch: bf16 q on the tensor cores, the
    splits of `prefill_paged_plan` merged in their last block; f32 q on
    the CUDA cores, bit-equal to `flash_prefill` on the gathered
    buffer; the route by `prefill_paged_route` (bf16 at dh 64, 80 and
    128 on wgmma, at the others on tc), its launches counted by route in
    `flash_prefill_paged.routes`. Refuses inputs that require grad
    (`_no_backward`)."""
    _no_backward("flash_prefill_paged", q, k, v)
    _attention_dtype(q)
    q8 = k_pool.dtype == torch.int8
    pool = torch.int8 if q8 else q.dtype
    specs = ((q, "q", q.dtype, 4), (k, "k", q.dtype, 3), (v, "v", q.dtype, 3),
             (k_pool, "k_pool", pool, 4), (v_pool, "v_pool", pool, 4),
             (row, "row", torch.int32, 1))
    if (k_scale is not None) != q8 or (v_scale is not None) != q8:
        raise ValueError("flash_prefill_paged: an int8 pool takes k_scale "
                         "and v_scale, a float pool neither")
    if q8:
        specs += ((k_scale, "k_scale", torch.float32, 3),
                  (v_scale, "v_scale", torch.float32, 3))
    dev = _checked(*specs)
    B, C, H, dh = q.shape
    P, ps, G, dh2 = k_pool.shape
    W = row.shape[0]
    ring = ring_len or W * ps
    if (B != 1 or k.shape != (C, G, dh) or v.shape != k.shape
            or v_pool.shape != k_pool.shape or dh2 != dh or G == 0 or H % G
            or ps != page_size
            or (q8 and (k_scale.shape != k_pool.shape[:3]
                        or v_scale.shape != k_pool.shape[:3]))):
        raise ValueError(f"flash_prefill_paged shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, pool "
                         f"{tuple(k_pool.shape)}, page_size {page_size}")
    if (not 0 <= lo <= offset or offset - lo >= ring + PAGED_KEY_TILE
            or ring > W * ps or (window is not None and window < 1)):
        raise ValueError(f"flash_prefill_paged: offset {offset}, lo {lo}, "
                         f"ring {ring} over {W} pages of {ps}, window "
                         f"{window}")
    kw = dict(offset=offset, lo=lo, page_size=page_size, ring_len=ring_len,
              window=window, k_scale=k_scale, v_scale=v_scale)
    if cost.traced(q):
        return cost.node("flash_prefill_paged", lambda: torch.empty_like(q),
                         q, k, v, k_pool, v_pool, row, **kw)
    if dev.type == "cpu":
        return ref.flash_prefill_paged(q, k, v, k_pool, v_pool, row, **kw)
    if dh not in FLASH_PREFILL_DH:
        raise ValueError(f"flash_prefill_paged: dh {dh} not in "
                         f"{FLASH_PREFILL_DH}")
    if any(t.data_ptr() % 16 for t in (q, k, v, k_pool, v_pool)):
        raise ValueError("flash_prefill_paged: q, k, v and the pools must be "
                         "16-byte aligned")
    route = prefill_paged_route(q.dtype, dh)
    out = flash_prefill_paged_launch(q, k, v, k_pool, v_pool, row,
                                     route=route, **kw)
    if C:
        flash_prefill_paged.launches += 1
        flash_prefill_paged.routes[route] += 1
    return out


def flash_prefill_paged_launch(q, k, v, k_pool, v_pool, row, *, offset: int,
                               lo: int, page_size: int, ring_len: int = 0,
                               window: Optional[int] = None, k_scale=None,
                               v_scale=None, splits: Optional[int] = None,
                               route: Optional[str] = None):
    """Launch flash_prefill_paged on CUDA tensors that pass its wrapper's
    checks (no launch counted) -> [1, C, H, dh]: on the route
    `prefill_paged_route` picks where `route` is None, else on a forced
    route for checks and probes ("cuda" takes f32 q, "tc" bf16, "wgmma"
    bf16 at PAGED_WGMMA_DH; ValueError otherwise); bf16 at
    `prefill_paged_plan`'s splits, or a forced count (1 .. the call's key
    tiles); f32 one split only."""
    C, H, dh = q.shape[1:]
    G = k.shape[1]
    hist = offset - lo
    route = prefill_paged_route(q.dtype, dh) if route is None else route
    if (route not in PAGED_ROUTES
            or (route == "cuda") != (q.dtype is torch.float32)
            or (route == "wgmma" and dh not in PAGED_WGMMA_DH)):
        raise ValueError(f"flash_prefill_paged: route {route!r} not taken "
                         f"at q {tuple(q.shape)} ({q.dtype})")
    if route == "cuda" and splits not in (None, 1):
        raise ValueError("flash_prefill_paged: the f32 route takes one "
                         "split")
    out = torch.empty_like(q)
    if C == 0:
        return out
    ring = ring_len or row.shape[0] * page_size
    stream = _stream(q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pool.data_ptr(),
            _ptr(k_scale), v_pool.data_ptr(), _ptr(v_scale), row.data_ptr(),
            C, H, G, dh, page_size, ring, lo, hist, window or 0,
            1.0 / math.sqrt(dh))
    n = 1
    if route == "cuda":
        err = build.entry("flash_prefill_paged_f32")(*args, out.data_ptr(),
                                                     stream)
    else:
        plan = prefill_paged_plan(C, hist, G, H // G, dh, window, splits)
        n = plan.splits
        part, tick = _split_scratch(q.device, stream, G * plan.row_blocks,
                                    PAGED_ROWS * (dh + 2), n, 1)
        tail = (plan.kbeg, plan.tiles, plan.row_blocks, n, _ptr(part),
                _ptr(tick), out.data_ptr(), stream)
        if route == "wgmma":
            err = build.entry("flash_prefill_paged_wgmma")(
                *args, k_pool.shape[0], *tail)
        else:
            err = build.entry("flash_prefill_paged_bf16")(*args, *tail)
    if err:
        _raise_on(err, f"flash_prefill_paged ({route}, {n} splits)")
    return out


DECODE_TILE = 64      # positions per tile of the two decode kernels
DECODE_BLOCKS_PER_SM = 4   # decode kernel blocks resident on one SM


def _split_plan(tiles: int, pairs: int, Hg: int, most: int
                ) -> Tuple[int, int]:
    """(splits, head_groups) of a split decode launch over `pairs` (row, kv
    head) pairs whose rows span `tiles` DECODE_TILE tiles, at most `most`
    splits: the rule of both decode kernels. Splits of at least two
    tiles, enough to fill the card's SM_COUNT SMs with
    DECODE_BLOCKS_PER_SM blocks each; but no split at all where that
    gives two or fewer (the last block's merge costs about three tiles of
    time, more than such a split saves: attention_probe, PERF.md). Where
    pairs*splits blocks leave SMs idle, each group's Hg heads go to
    head_groups blocks of ceil(Hg / head_groups) heads (every group
    non-empty), up to one block an SM: they need no merge."""
    splits = min(tiles // 2,
                 -(-SM_COUNT * DECODE_BLOCKS_PER_SM // pairs), most)
    if splits <= 2:
        splits = 1
    groups = 1
    if pairs * splits < SM_COUNT and Hg > 1:
        groups = max(1, min(Hg, SM_COUNT // (pairs * splits)))
        groups = -(-Hg // -(-Hg // groups))
    return splits, groups


def decode_split_plan(B: int, G: int, S: int, Hg: int = 1
                      ) -> Tuple[int, int]:
    """(splits, head_groups) of `decode_attention` (and
    `decode_attention_q8`) for B rows of G kv heads over S cache slots,
    Hg query heads a kv head, from host-known shapes only: grid (splits,
    G * head_groups, B), by `_split_plan`'s rule. Split s covers
    `ref.decode_split_ranges`; each starts at a multiple of DECODE_TILE."""
    tiles = -(-S // DECODE_TILE)
    return _split_plan(tiles, max(1, B * G), Hg, tiles)


# head dims of decode_attention's tensor-core route (csrc/decode_attention.cu
# namespace tc). It takes a bf16 cache at every Hg: attention_probe timed
# both routes at Hg 1, 2, 4, 7 and 16 in one process and the tensor cores
# won at each (PERF.md)
DECODE_TC_DH = (32, 64, 80, 128, 256)
DECODE_ROUTES = ("cuda", "tc")


def decode_route(dtype: torch.dtype, dh: int) -> str:
    """The route of a `decode_attention` call: "tc" (tensor cores) for a
    bf16 cache at dh in DECODE_TC_DH, else "cuda" (CUDA cores: f32, the
    1e-5 check route, or a dh the tensor-core kernel is not built for)."""
    return ("tc" if dtype is torch.bfloat16 and dh in DECODE_TC_DH
            else "cuda")


def decode_paged_route(dtype: torch.dtype, dh: int) -> str:
    """The route of a `decode_attention_paged` or
    `decode_attention_paged_q8` call, by q's dtype: "tc" (tensor cores,
    over a bf16 pool or an int8 one widened to bf16 in shared memory)
    for bf16 q at dh in DECODE_TC_DH, else "cuda" (CUDA cores: f32 q, the
    1e-5 check route, or a dh the tensor-core kernel is not built
    for)."""
    return decode_route(dtype, dh)


SMEM_LIMIT = 227 * 1024     # dynamic shared memory a block may take
DECODE_MAX_GROUP = 2048     # Hg * dh of the int8 kernels on the CUDA cores
DECODE_WIDE_GROUP = 4096    # Hg * dh of a float cache on the CUDA cores


def decode_smem_bytes(Hg: int, dh: int, esz: int, q8: bool = False,
                      stages: int = 2) -> int:
    """Shared memory of a CUDA-core decode block of Hg heads, contiguous
    or paged (`decode_split_kernel`, csrc/decode_body.cuh, whose kTile
    is DECODE_TILE): the K and V rings [stages, DECODE_TILE, dh + 16/esz]
    in the cache's type (esz bytes an element), then in f32 the queries
    [Hg, dh], a tile's scores [Hg, DECODE_TILE], the running max, sum and
    correction [Hg], and for an int8 cache (`q8`) the K and V scale rings
    [2, DECODE_TILE]."""
    row = dh + 16 // esz
    return (2 * stages * DECODE_TILE * row * esz
            + (Hg * dh + Hg * DECODE_TILE + 3 * Hg
               + (4 * DECODE_TILE if q8 else 0)) * 4)


def decode_tc_smem_bytes(dh: int, q8: bool = False) -> int:
    """Shared memory of a tensor-core decode block (`tc::smem_bytes`,
    csrc/decode_body.cuh): the K and V rings [2, DECODE_TILE, dh + 8] and
    Q [16, dh + 8] in bf16, P [16, DECODE_TILE + 8] in bf16, then in f32
    the scores [16, DECODE_TILE + 8] and the running max, sum and
    correction [16], the row slots of two tiles [2, DECODE_TILE] (8 bytes
    each); over an int8 pool (`q8`) then the f32 K and V scale rings [2,
    DECODE_TILE] each (its int8 rows wait in registers)."""
    return ((4 * DECODE_TILE + 16) * (dh + 8) * 2 + 16 * (DECODE_TILE + 8) * 2
            + (16 * (DECODE_TILE + 8) + 3 * 16) * 4 + 2 * DECODE_TILE * 8
            + (4 * DECODE_TILE * 4 if q8 else 0))


def decode_merge_bytes(splits: int, Hb: int) -> int:
    """Shared memory of the merge in the last split block
    (`merge_floats`, csrc/decode_split.cuh): the partials' m, l and the
    weights [splits, Hb] each and the denominators [Hb] in f32 (0 with
    one split)."""
    return (3 * splits + 1) * Hb * 4 if splits > 1 else 0


def decode_stages(Hg: int, dh: int, esz: int, q8: bool = False) -> int:
    """K/V ring stages of a CUDA-core decode block of Hg heads: 2 (the
    next tile loads while one computes), or 1 when two do not fit
    SMEM_LIMIT (f32 at dh 256: recurrentgemma's ring in the 1e-5
    check)."""
    return 2 if decode_smem_bytes(Hg, dh, esz, q8) <= SMEM_LIMIT else 1


def _decode_limits(name: str, Hg: int, dh: int, esz: int, q8: bool,
                   max_group: int = DECODE_MAX_GROUP,
                   stages: int = 2) -> None:
    """Raise unless a decode kernel takes this grouping: Hg <= 16, Hg*dh
    <= max_group, dh a multiple of 16 bytes' worth of the cache type, and
    the block's shared memory at `stages` within SMEM_LIMIT."""
    if (Hg > 16 or Hg * dh > max_group or dh % (16 // esz) or dh % 8
            or decode_smem_bytes(Hg, dh, esz, q8, stages) > SMEM_LIMIT):
        raise ValueError(f"{name}: Hg={Hg}, dh={dh} outside the kernel's "
                         f"limits (Hg <= 16, Hg*dh <= {max_group}, dh a "
                         "multiple of 8 and of a 16-byte row load, 227 KB of "
                         "shared memory)")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


_partials: Dict[Tuple[int, int], torch.Tensor] = {}


def _split_scratch(dev, stream: int, pairs: int, per_split: int,
                   splits: int, groups: int):
    """(partials, tickets) of a split decode launch over `pairs` (row, kv
    head) pairs: the stream's f32 partials, at least pairs * splits *
    per_split floats, and its ticket counters (`tickets`, pairs * groups
    of them); both None with one split. One partials buffer a stream, as
    the tickets are (launches on one stream do not overlap), allocated
    only when a larger launch first comes: a call allocates nothing but
    its output."""
    if splits == 1:
        return None, None
    n = pairs * splits * per_split
    part = _partials.get((dev.index, stream))
    if part is None or part.numel() < n:
        part = torch.empty(n, dtype=torch.float32, device=dev)
        _partials[(dev.index, stream)] = part
    return part, tickets(dev, stream, pairs * groups)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Union[int, torch.Tensor], ring: bool = False):
    """q [B, H, dh]; k, v [B, S, G, dh] (f32 or bf16, same as q); kv_len
    an int or an i32 [B] tensor of each row's length. `ring`: the cache is
    a sliding-window ring (mask length min(kv_len, S)). Returns
    [B, H, dh] in q's dtype. The kernel takes Hg = H/G <= 16 heads a kv
    head with Hg*dh <= DECODE_WIDE_GROUP. On the card the call is one
    launch (`decode_attention_launch`): `decode_route` picks the tensor
    cores or the CUDA cores, `decode_split_plan` the splits and head
    groups, and the last split block of each (row, kv head, head group)
    merges. Refuses inputs that require grad (`_no_backward`)."""
    _no_backward("decode_attention", q, k, v)
    suffix = _attention_dtype(q)
    specs = ((q, "q", q.dtype, 3), (k, "k", q.dtype, 4), (v, "v", q.dtype, 4))
    if isinstance(kv_len, torch.Tensor):
        specs += ((kv_len, "kv_len", torch.int32, 1),)
    dev = _checked(*specs)
    B, H, dh = q.shape
    Bk, S, G, dhk = k.shape
    if v.shape != k.shape or Bk != B or dhk != dh or G == 0 or H % G:
        raise ValueError(f"decode_attention shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if isinstance(kv_len, torch.Tensor):
        if kv_len.shape[0] != B:
            raise ValueError(f"kv_len: {kv_len.shape[0]} rows, q has {B}")
    if cost.traced(q):
        return cost.node("decode_attention", lambda: torch.empty_like(q), q,
                         k, v, kv_len, ring)
    if dev.type == "cpu":
        return ref.decode_attention(q, k, v, kv_len, ring=ring)
    Hg, esz = H // G, q.element_size()
    _decode_limits("decode_attention", Hg, dh, esz, False, DECODE_WIDE_GROUP,
                   decode_stages(Hg, dh, esz))
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k, v must be 16-byte aligned")
    out = decode_attention_launch(q, k, v, kv_len)
    if B and S:
        decode_attention.launches += 1
    return out


def decode_attention_launch(q, k, v, kv_len, *, route: Optional[str] = None,
                            splits: Optional[int] = None,
                            head_groups: Optional[int] = None):
    """Launch the decode_attention kernel on CUDA tensors that pass
    `decode_attention`'s checks (no launch counted) -> [B, H, dh]: at the
    wrapper's choices (`decode_route`, `decode_split_plan`) where an
    argument is None, else at a forced route ("cuda" or "tc"), split
    count (1 .. the cache's tiles) or head grouping (1 .. Hg, every group
    non-empty), for checks and probes. Raises ValueError for a forced
    value the kernel does not take. A ring's min(kv_len, S) over S
    positions is the same mask as kv_len, so no ring flag is passed."""
    suffix = _attention_dtype(q)
    B, H, dh = q.shape
    S, G = k.shape[1], k.shape[2]
    dev = q.device
    Hg, esz = H // G, q.element_size()
    plan = decode_split_plan(B, G, S, Hg)
    splits = plan[0] if splits is None else int(splits)
    groups = plan[1] if head_groups is None else int(head_groups)
    route = decode_route(q.dtype, dh) if route is None else route
    Hb = -(-Hg // max(1, groups))
    if (route not in DECODE_ROUTES
            or (route == "tc" and (q.dtype is not torch.bfloat16
                                   or dh not in DECODE_TC_DH))
            or not 1 <= splits <= max(1, -(-S // DECODE_TILE))
            or not 1 <= groups <= Hg or -(-Hg // Hb) != groups):
        raise ValueError(f"decode_attention: route {route!r}, splits "
                         f"{splits}, head groups {groups} not taken at q "
                         f"{tuple(q.shape)} ({q.dtype}), S {S}")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    if route == "tc":
        stages, smem = 2, decode_tc_smem_bytes(dh)
    else:
        stages = decode_stages(Hb, dh, esz)
        smem = decode_smem_bytes(Hb, dh, esz, stages=stages)
    smem = max(smem, decode_merge_bytes(splits, Hb))
    if not isinstance(kv_len, torch.Tensor):
        kv_len = torch.full((B,), int(kv_len), dtype=torch.int32, device=dev)
    stream = _stream(dev)
    part, tick = _split_scratch(dev, stream, B * G, Hg * (dh + 2), splits,
                                groups)
    err = build.entry("decode_attention_" + suffix)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), B, S, H,
        G, dh, 1.0 / math.sqrt(dh), splits, groups, int(route == "tc"),
        stages, smem, _ptr(part), _ptr(tick), out.data_ptr(), stream)
    if err:
        _raise_on(err, f"decode_attention ({route}, {splits} splits, "
                  f"{groups} head groups)")
    return out


def decode_paged_split_plan(B: int, G: int, W: int, ps: int, Hg: int = 1
                            ) -> Tuple[int, int]:
    """(splits, head_groups) of `decode_attention_paged` and
    `decode_attention_paged_q8` for B rows of G kv heads through W-entry
    tables of ps-position pages, Hg query heads a kv head, from
    host-known shapes only (the row's kv_len stays on the device): grid
    (splits, G * head_groups, B), by `_split_plan`'s rule over the
    table's W*ps positions, never more splits than entries W. Split s
    covers the entries `ref.decode_paged_split_ranges(W, splits)[s]`; a
    split past a row's ceil(kv_len / ps) entries loads nothing and only
    takes its ticket."""
    return _split_plan(-(-W * ps // DECODE_TILE), max(1, B * G), Hg, W)


def _paged_launch(name: str, q, k, v, k_scale, v_scale, kv_len, table,
                  route: Optional[str], splits: Optional[int],
                  head_groups: Optional[int]):
    """Launch decode_attention_paged (k_scale None: a float pool) or
    decode_attention_paged_q8 (an int8 pool and its scales) on CUDA
    tensors that pass the wrapper's checks -> [B, H, dh], at the plan's
    and route's choices where an argument is None; raises ValueError for
    a forced value (or, for the wrapper, a grouping: at most 16 heads a
    block, Hb*dh within the CUDA cores' pairs) the kernel does not take.
    One launch; none counted."""
    B, H, dh = q.shape
    ps, G = k.shape[1], k.shape[2]
    W = table.shape[1]
    Hg, q8 = H // G, k_scale is not None
    esz = 1 if q8 else q.element_size()
    plan = decode_paged_split_plan(B, G, W, ps, Hg)
    splits = plan[0] if splits is None else int(splits)
    groups = plan[1] if head_groups is None else int(head_groups)
    route = decode_paged_route(q.dtype, dh) if route is None else route
    Hb = -(-Hg // max(1, groups))
    if route == "tc":
        stages, smem = 2, decode_tc_smem_bytes(dh, q8)
        taken = q.dtype is torch.bfloat16 and dh in DECODE_TC_DH and Hb <= 16
    else:
        stages = decode_stages(Hb, dh, esz, q8)
        smem = decode_smem_bytes(Hb, dh, esz, q8, stages)
        taken = (route == "cuda" and Hb <= 16 and smem <= SMEM_LIMIT
                 and Hb * dh <= (DECODE_MAX_GROUP if q8 else
                                 DECODE_WIDE_GROUP)
                 and dh % 8 == 0 and dh % (16 // esz) == 0)
    if (not taken or not 1 <= splits <= max(1, W)
            or not 1 <= groups <= Hg or -(-Hg // Hb) != groups):
        raise ValueError(f"{name}: route {route!r}, splits {splits}, head "
                         f"groups {groups} not taken at q {tuple(q.shape)} "
                         f"({q.dtype}), W {W}, ps {ps}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    smem = max(smem, decode_merge_bytes(splits, Hb))
    stream = _stream(q.device)
    part, tick = _split_scratch(q.device, stream, B * G, Hg * (dh + 2),
                                splits, groups)
    pool = ((k.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
             v_scale.data_ptr()) if q8 else (k.data_ptr(), v.data_ptr()))
    err = build.entry(f"{name}_{_attention_dtype(q)}")(
        q.data_ptr(), *pool, kv_len.data_ptr(), table.data_ptr(), B, H, G,
        dh, ps, W, 1.0 / math.sqrt(dh), splits, groups, int(route == "tc"),
        stages, smem, _ptr(part), _ptr(tick), out.data_ptr(), stream)
    if err:
        _raise_on(err, f"{name} ({route}, {splits} splits, {groups} head "
                  "groups)")
    return out


def decode_attention_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor, table: torch.Tensor):
    """q [B, H, dh]; k, v [P, ps, G, dh] one layer of the page pool (f32
    or bf16, same as q); kv_len [B] i32; table [B, W] i32 valid page ids.
    Returns [B, H, dh] in q's dtype. On the card the call is one launch
    (`decode_attention_paged_launch`): `decode_paged_route` picks the
    tensor cores (bf16) or the CUDA cores (f32), `decode_paged_split_plan`
    the splits of the table and the head groups, and the last split block
    of each (row, kv head, head group) merges. Refuses inputs that
    require grad (`_no_backward`)."""
    _no_backward("decode_attention_paged", q, k, v)
    _attention_dtype(q)
    dev = _checked((q, "q", q.dtype, 3), (k, "k", q.dtype, 4),
                   (v, "v", q.dtype, 4), (kv_len, "kv_len", torch.int32, 1),
                   (table, "table", torch.int32, 2))
    B, H, dh = q.shape
    P, ps, G, dh2 = k.shape
    if (v.shape != k.shape or dh2 != dh or G == 0 or H % G
            or kv_len.shape[0] != B or table.shape[0] != B):
        raise ValueError("decode_attention_paged shapes disagree")
    if dev.type == "cpu":
        return ref.decode_attention_paged(q, k, v, kv_len, table)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention_paged: k, v must be 16-byte "
                         "aligned")
    out = decode_attention_paged_launch(q, k, v, kv_len, table)
    if B:
        decode_attention_paged.launches += 1
    return out


def decode_attention_paged_launch(q, k, v, kv_len, table, *,
                                  route: Optional[str] = None,
                                  splits: Optional[int] = None,
                                  head_groups: Optional[int] = None):
    """Launch the decode_attention_paged kernel on CUDA tensors that pass
    `decode_attention_paged`'s checks (no launch counted) -> [B, H, dh]:
    at the wrapper's choices (`decode_paged_route`,
    `decode_paged_split_plan`) where an argument is None, else at a
    forced route ("cuda" or "tc"), split count (1 .. W) or head grouping
    (1 .. Hg, every group non-empty), for checks and probes. Raises
    ValueError for a forced value the kernel does not take."""
    return _paged_launch("decode_attention_paged", q, k, v, None, None,
                         kv_len, table, route, splits, head_groups)


def decode_attention_q8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                        vq: torch.Tensor, vs: torch.Tensor,
                        kv_len: Union[int, torch.Tensor], ring: bool = False):
    """int8-KV decode: q [B, H, dh] (f32 or bf16); kq, vq [B, S, G, dh]
    int8; ks, vs [B, S, G] f32 scales; kv_len an int or an i32 [B] tensor;
    `ring` as `decode_attention`. Returns [B, H, dh] in q's dtype
    (`ref.decode_attention_q8`). On the card the kernel reads the int8
    cache and the scales directly on the CUDA cores, split as
    `decode_attention` is (`decode_split_plan`), one launch a call.
    Refuses inputs that require grad (`_no_backward`)."""
    _no_backward("decode_attention_q8", q, ks, vs)
    suffix = _attention_dtype(q)
    specs = ((q, "q", q.dtype, 3), (kq, "kq", torch.int8, 4),
             (ks, "ks", torch.float32, 3), (vq, "vq", torch.int8, 4),
             (vs, "vs", torch.float32, 3))
    if isinstance(kv_len, torch.Tensor):
        specs += ((kv_len, "kv_len", torch.int32, 1),)
    dev = _checked(*specs)
    B, H, dh = q.shape
    Bk, S, G, dhk = kq.shape
    if (vq.shape != kq.shape or Bk != B or dhk != dh or G == 0 or H % G
            or ks.shape != kq.shape[:3] or vs.shape != kq.shape[:3]):
        raise ValueError(f"decode_attention_q8 shapes disagree: q "
                         f"{tuple(q.shape)}, kq {tuple(kq.shape)}, ks "
                         f"{tuple(ks.shape)}")
    if isinstance(kv_len, torch.Tensor) and kv_len.shape[0] != B:
        raise ValueError(f"kv_len: {kv_len.shape[0]} rows, q has {B}")
    if cost.traced(q):
        return cost.node("decode_attention_q8", lambda: torch.empty_like(q),
                         q, kq, ks, vq, vs, kv_len, ring)
    if dev.type == "cpu":
        return ref.decode_attention_q8(q, kq, ks, vq, vs, kv_len, ring=ring)
    Hg = H // G
    _decode_limits("decode_attention_q8", Hg, dh, 1, True)
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError("decode_attention_q8: kq, vq must be 16-byte "
                         "aligned")
    if not isinstance(kv_len, torch.Tensor):
        kv_len = torch.full((B,), int(kv_len), dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    splits, groups = decode_split_plan(B, G, S, Hg)
    Hb = -(-Hg // groups)
    stream = _stream(dev)
    part, tick = _split_scratch(dev, stream, B * G, Hg * (dh + 2), splits,
                                groups)
    # over S positions, ring's min(kv_len, S) is the same mask as kv_len
    fn = build.entry("decode_attention_q8_" + suffix)
    _raise_on(fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
                 vs.data_ptr(), kv_len.data_ptr(), B, S, H, G, dh,
                 1.0 / math.sqrt(dh), splits, groups, 2,
                 max(decode_smem_bytes(Hb, dh, 1, True),
                     decode_merge_bytes(splits, Hb)),
                 _ptr(part), _ptr(tick), out.data_ptr(), stream),
              "decode_attention_q8")
    decode_attention_q8.launches += 1
    return out


def decode_attention_paged_q8(q: torch.Tensor, kq: torch.Tensor,
                              ks: torch.Tensor, vq: torch.Tensor,
                              vs: torch.Tensor, kv_len: torch.Tensor,
                              table: torch.Tensor):
    """int8-KV paged decode: q [B, H, dh] (f32 or bf16); kq, vq [P, ps, G,
    dh] int8 and ks, vs [P, ps, G] f32, one layer of the int8 page pool;
    kv_len [B] i32; table [B, W] i32 valid page ids. Returns [B, H, dh]
    in q's dtype (`ref.decode_attention_paged_q8`). On the card the kernel
    reads the int8 pages and their scales through the table, on the route
    and plan of `decode_attention_paged` (bf16 q: the tensor cores, the
    int8 rows widened to bf16 in shared memory), one launch a call.
    Refuses inputs that require grad (`_no_backward`)."""
    _no_backward("decode_attention_paged_q8", q, ks, vs)
    _attention_dtype(q)
    dev = _checked((q, "q", q.dtype, 3), (kq, "kq", torch.int8, 4),
                   (ks, "ks", torch.float32, 3), (vq, "vq", torch.int8, 4),
                   (vs, "vs", torch.float32, 3),
                   (kv_len, "kv_len", torch.int32, 1),
                   (table, "table", torch.int32, 2))
    B, H, dh = q.shape
    P, ps, G, dh2 = kq.shape
    if (vq.shape != kq.shape or dh2 != dh or G == 0 or H % G
            or ks.shape != kq.shape[:3] or vs.shape != kq.shape[:3]
            or kv_len.shape[0] != B or table.shape[0] != B):
        raise ValueError("decode_attention_paged_q8 shapes disagree")
    if dev.type == "cpu":
        return ref.decode_attention_paged_q8(q, kq, ks, vq, vs, kv_len, table)
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError("decode_attention_paged_q8: kq, vq must be 16-byte "
                         "aligned")
    out = decode_attention_paged_q8_launch(q, kq, ks, vq, vs, kv_len, table)
    if B:
        decode_attention_paged_q8.launches += 1
    return out


def decode_attention_paged_q8_launch(q, kq, ks, vq, vs, kv_len, table, *,
                                     route: Optional[str] = None,
                                     splits: Optional[int] = None,
                                     head_groups: Optional[int] = None):
    """`decode_attention_paged_launch` over an int8 pool: the
    decode_attention_paged_q8 kernel on CUDA tensors that pass its
    wrapper's checks, at forced route, split count or head grouping (no
    launch counted)."""
    return _paged_launch("decode_attention_paged_q8", q, kq, vq, ks, vs,
                         kv_len, table, route, splits, head_groups)


def scr_score(windows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """windows [B, NW, d] f32; q [B, d] f32 -> scores [B, NW] f32, the
    inner product of each window with its query. The shortest launch
    path of the wrappers (a legacy query's call is ~1 us of device time):
    CUDA inputs that pass `_checked`'s checks, made inline by cheap
    getters (no `torch.device` built, no spec tuples), launch at once on
    the raw stream; anything else goes through `_checked`, which raises
    what it finds, or to the plain version on the CPU."""
    f32 = torch.float32
    if (windows.is_cuda and q.is_cuda and windows.dtype is f32
            and q.dtype is f32 and windows.dim() == 3 and q.dim() == 2
            and windows.is_contiguous() and q.is_contiguous()
            and windows.get_device() == q.get_device()):
        idx = windows.get_device()
    else:
        idx = -1
        _checked((windows, "windows", f32, 3), (q, "q", f32, 2))
    B, NW, d = windows.shape
    if q.shape != (B, d):
        raise ValueError(f"scr_score: q {tuple(q.shape)} vs windows "
                         f"{tuple(windows.shape)}")
    if idx < 0:
        return ref.scr_score(windows, q)
    out = windows.new_empty((B, NW))        # f32 on windows' device
    if B and NW:
        err = build.entry("scr_score")(
            windows.data_ptr(), q.data_ptr(), B, NW, d, out.data_ptr(),
            _raw_stream(idx) if _raw_stream is not None
            else _stream(windows.device))
        if err:
            _raise_on(err, "scr_score")
        scr_score.launches += 1
    return out


PQ_ADC_MAX_K = 256


def pq_adc(lut: torch.Tensor, codes: torch.Tensor,
           starts: Optional[torch.Tensor] = None,
           offsets: Optional[torch.Tensor] = None,
           rows: Optional[int] = None) -> torch.Tensor:
    """lut [B, M, K] f32 (K <= 256) distance tables; codes [N, M] uint8
    (a code >= K adds NaN) -> scores [B, N] f32 = sum_m lut[b, m,
    codes[n, m]], summed in numpy's order (`ref.pq_adc`). With segments,
    starts [S] i32 and offsets [S + 1] i32 (non-decreasing from 0, and
    `rows` = offsets[S], the host's count): segment s is the code rows
    starts[s] .. starts[s] + offsets[s+1] - offsets[s] - 1, scored into
    out[:, offsets[s]:offsets[s+1]] of scores [B, rows]; a row outside
    [0, N) scores NaN (`ref.pq_adc_segments`). One launch either way;
    on the card M <= 128, numpy's pairwise block."""
    specs = ((lut, "lut", torch.float32, 3), (codes, "codes", torch.uint8, 2))
    seg = starts is not None or offsets is not None
    if seg:
        if starts is None or offsets is None or rows is None:
            raise ValueError("pq_adc: segments need starts, offsets and rows")
        specs += ((starts, "starts", torch.int32, 1),
                  (offsets, "offsets", torch.int32, 1))
    dev = _checked(*specs)
    B, M, K = lut.shape
    N = codes.shape[0]
    if codes.shape[1] != M:
        raise ValueError(f"pq_adc: codes {tuple(codes.shape)} vs lut "
                         f"{tuple(lut.shape)}")
    if K > PQ_ADC_MAX_K:
        raise ValueError(f"pq_adc: K {K} > {PQ_ADC_MAX_K} (uint8 codes)")
    if seg and offsets.shape[0] != starts.shape[0] + 1:
        raise ValueError(f"pq_adc: {starts.shape[0]} starts, "
                         f"{offsets.shape[0]} offsets")
    if dev.type == "cpu":
        if not seg:
            return ref.pq_adc(lut, codes)
        if int(offsets[0]) != 0 or int(offsets[-1]) != rows or bool(
                (offsets[1:] < offsets[:-1]).any()):
            raise ValueError("pq_adc: offsets must rise from 0 to rows")
        return ref.pq_adc_segments(lut, codes, starts, offsets)
    T = rows if seg else N
    out = pq_adc_launch(lut, codes, starts, offsets, T)
    if out.numel():
        pq_adc.launches += 1
    return out


def pq_adc_launch(lut, codes, starts, offsets, rows: int,
                  forced: Optional[Tuple[int, int, int]] = None):
    """Launch the pq_adc kernel on CUDA tensors that pass `pq_adc`'s
    checks (no launch counted) -> scores [B, rows]: through the C entry
    `pq_adc` when `forced` is None (the wrapper's call), else through
    `pq_adc_forced` at forced (queries a lookup 1, 2 or 4, threads a
    block 32..1024, grid width; 0 sizes the grid as `pq_adc` does), for
    probes and checks. No launch when B or rows is 0."""
    B, M, K = lut.shape
    S = 0 if starts is None else starts.shape[0]
    if M > ref.PQ_SUM_BLOCK or B > 65535 or (M * 256 + 2 * S + 1) * 4 > \
            227 * 1024:
        raise ValueError(f"pq_adc: M {M} > {ref.PQ_SUM_BLOCK} (numpy's "
                         f"pairwise block), B {B} > 65535, or {S} segments "
                         "past the shared memory beside the table")
    out = lut.new_empty((B, rows))          # f32 on lut's device
    if B == 0 or rows == 0:
        return out
    args = (lut.data_ptr(), codes.data_ptr(),
            None if starts is None else starts.data_ptr(),
            None if offsets is None else offsets.data_ptr(), B, S,
            codes.shape[0], rows, M, K)
    if forced is None:
        _raise_on(build.entry("pq_adc")(*args, out.data_ptr(),
                                        _stream(lut.device)), "pq_adc")
    else:
        _raise_on(build.entry("pq_adc_forced")(
            *args, *forced, out.data_ptr(), _stream(lut.device)),
            f"pq_adc forced {forced}")
    return out


_WRAPPERS = {n: globals()[n] for n in KERNELS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0
    flash_prefill.routes = dict.fromkeys(PREFILL_ROUTES, 0)
    flash_prefill_paged.routes = dict.fromkeys(PAGED_ROUTES, 0)


def launch_counts() -> Dict[str, int]:
    return {n: w.launches for n, w in _WRAPPERS.items()}


reset_launch_counts()
