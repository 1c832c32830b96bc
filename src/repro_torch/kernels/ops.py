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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import build, ref

KERNELS = ("kmeans_assign", "ecoscan", "scr_select", "decode_attention_paged",
           "flash_prefill", "decode_attention", "scr_score", "pq_adc")


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
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


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


def ecoscan_tickets(dev: torch.device, stream: int, B: int) -> torch.Tensor:
    """The ecoscan kernel's per-query ticket counters for launches on
    `stream` of `dev`: at least B ints, zero before a launch and zero
    again after it (the last block of each query resets its counter).
    One buffer a stream, so launches on two streams share no counter;
    it is allocated (zeroed) only when a larger B first comes."""
    t = _tickets.get((dev.index, stream))
    if t is None or t.numel() < B:
        t = torch.zeros(max(B, 64), dtype=torch.int32, device=dev)
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
    rest = (scratch.data_ptr(), ecoscan_tickets(q.device, stream,
                                                B).data_ptr(),
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


FLASH_PREFILL_DH = (32, 64, 80, 128)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0, kv_len: Optional[int] = None):
    """q [B, Sq, H, dh]; k, v [B, Sk, G, dh] (f32 or bf16, same as q;
    H % G == 0). Query i at absolute position q_offset + i attends the
    keys at positions < kv_len (Sk when None) that `causal` and `window`
    leave unmasked. Returns [B, Sq, H, dh] in q's dtype. On the card bf16
    runs on the tensor cores, f32 on the CUDA cores (in full f32)."""
    suffix = _attention_dtype(q)
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
    if dev.type == "cpu":
        return ref.flash_prefill(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv)
    if dh not in FLASH_PREFILL_DH:
        raise ValueError(f"flash_prefill: dh {dh} not in {FLASH_PREFILL_DH}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill: q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0 or H == 0:
        return out
    fn = build.entry("flash_prefill_" + suffix)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Sq, Sk, H, G,
                 dh, int(causal), window or 0, q_offset, kv,
                 1.0 / math.sqrt(dh), out.data_ptr(), _stream(dev)),
              "flash_prefill")
    flash_prefill.launches += 1
    return out


DECODE_TILE = 64      # positions per tile of the two decode kernels
SM_COUNT = 132        # streaming multiprocessors of an H100 SXM
DECODE_BLOCKS_PER_SM = 4   # decode kernel blocks resident on one SM


def decode_split_plan(B: int, G: int, S: int) -> int:
    """Splits of each row's cache for `decode_attention`, from host-known
    shapes only: enough (splits, G, B) blocks to fill the card's SM_COUNT
    SMs with DECODE_BLOCKS_PER_SM blocks each, each split at least two
    DECODE_TILE tiles (so at most tiles // 2 splits, and 1 when B*G
    blocks already fill the card or the cache is short). Split s covers
    `ref.decode_split_ranges`."""
    tiles = -(-S // DECODE_TILE)
    want = -(-SM_COUNT * DECODE_BLOCKS_PER_SM // max(1, B * G))
    return max(1, min(want, tiles // 2))


def decode_smem_bytes(Hg: int, dh: int, esz: int) -> int:
    """Shared memory of a `decode_attention` or `decode_attention_paged`
    block (both kernels' kTile is DECODE_TILE): the two-stage K and V
    rings [2, DECODE_TILE, dh + 16/esz] in the cache's type (esz bytes an
    element), then in f32 the group's queries [Hg, dh], a tile's scores
    [Hg, DECODE_TILE] and the running max, sum and correction [Hg]."""
    row = dh + 16 // esz
    return (4 * DECODE_TILE * row * esz
            + (Hg * dh + Hg * DECODE_TILE + 3 * Hg) * 4)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Union[int, torch.Tensor], ring: bool = False):
    """q [B, H, dh]; k, v [B, S, G, dh] (f32 or bf16, same as q); kv_len
    an int or an i32 [B] tensor of each row's length. `ring`: the cache is
    a sliding-window ring (mask length min(kv_len, S)). Returns
    [B, H, dh] in q's dtype. On the card the cache is split across
    `decode_split_plan(B, G, S)` blocks per (row, kv head); with more than
    one split a second, small kernel merges the partials. The call counts
    one launch either way."""
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
    if dev.type == "cpu":
        return ref.decode_attention(q, k, v, kv_len, ring=ring)
    Hg = H // G
    smem = decode_smem_bytes(Hg, dh, q.element_size())
    if Hg > 16 or Hg * dh > 2048 or dh % 8 or smem > 227 * 1024:
        raise ValueError(f"decode_attention: Hg={Hg}, dh={dh} outside the "
                         "kernel's limits (Hg <= 16, Hg*dh <= 2048, dh a "
                         "multiple of 8, 227 KB of shared memory)")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k, v must be 16-byte aligned")
    if not isinstance(kv_len, torch.Tensor):
        kv_len = torch.full((B,), int(kv_len), dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    splits = decode_split_plan(B, G, S)
    # the partials of the splits (one split writes `out` directly)
    part = torch.empty(B * G * splits * Hg * (dh + 2), dtype=torch.float32,
                       device=dev) if splits > 1 else None
    # over S positions, ring's min(kv_len, S) is the same mask as kv_len
    fn = build.entry("decode_attention_" + suffix)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 B, S, H, G, dh, 1.0 / math.sqrt(dh), splits, smem,
                 None if part is None else part.data_ptr(), out.data_ptr(),
                 _stream(dev)), "decode_attention")
    decode_attention.launches += 1
    return out


def decode_paged_split_plan(B: int, G: int, W: int, ps: int) -> int:
    """Splits of each row's page table for `decode_attention_paged`, from
    host-known shapes only (the row's kv_len stays on the device): enough
    (splits, G, B) blocks to fill the card's SM_COUNT SMs with
    DECODE_BLOCKS_PER_SM blocks each, but never more splits than table
    entries W, nor than DECODE_TILE-position tiles in the table's W*ps
    positions (so a split holds a tile's worth of positions on average).
    Split s covers `ref.decode_paged_split_ranges(W, splits)[s]`."""
    tiles = -(-W * ps // DECODE_TILE)
    want = -(-SM_COUNT * DECODE_BLOCKS_PER_SM // max(1, B * G))
    return max(1, min(want, W, tiles))


def decode_attention_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor, table: torch.Tensor):
    """q [B, H, dh]; k, v [P, ps, G, dh] one layer of the page pool (f32
    or bf16, same as q); kv_len [B] i32; table [B, W] i32 valid page ids.
    Returns [B, H, dh] in q's dtype. On the card the table is split
    across `decode_paged_split_plan(B, G, W, ps)` blocks per (row, kv
    head); with more than one split a second, small kernel merges the
    partials. The call counts one launch either way."""
    suffix = _attention_dtype(q)
    dev = _checked((q, "q", q.dtype, 3), (k, "k", q.dtype, 4),
                   (v, "v", q.dtype, 4), (kv_len, "kv_len", torch.int32, 1),
                   (table, "table", torch.int32, 2))
    B, H, dh = q.shape
    P, ps, G, dh2 = k.shape
    W = table.shape[1]
    if (v.shape != k.shape or dh2 != dh or G == 0 or H % G
            or kv_len.shape[0] != B or table.shape[0] != B):
        raise ValueError("decode_attention_paged shapes disagree")
    if dev.type == "cpu":
        return ref.decode_attention_paged(q, k, v, kv_len, table)
    Hg = H // G
    if (Hg > 16 or Hg * dh > 2048 or dh % 8
            or decode_smem_bytes(Hg, dh, q.element_size()) > 227 * 1024):
        raise ValueError(f"decode_attention_paged: Hg={Hg}, dh={dh} outside "
                         "the kernel's limits (Hg <= 16, Hg*dh <= 2048, dh a "
                         "multiple of 8, 227 KB of shared memory)")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention_paged: k, v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    splits = decode_paged_split_plan(B, G, W, ps)
    # the partials of the splits (one split writes `out` directly)
    part = torch.empty(B * G * splits * Hg * (dh + 2), dtype=torch.float32,
                       device=dev) if splits > 1 else None
    fn = build.entry("decode_attention_paged_" + suffix)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 table.data_ptr(), B, H, G, dh, ps, W, splits,
                 None if part is None else part.data_ptr(), out.data_ptr(),
                 _stream(dev)), "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


def scr_score(windows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """windows [B, NW, d] f32; q [B, d] f32 -> scores [B, NW] f32, the
    inner product of each window with its query."""
    dev = _checked((windows, "windows", torch.float32, 3),
                   (q, "q", torch.float32, 2))
    B, NW, d = windows.shape
    if tuple(q.shape) != (B, d):
        raise ValueError(f"scr_score: q {tuple(q.shape)} vs windows "
                         f"{tuple(windows.shape)}")
    if dev.type == "cpu":
        return ref.scr_score(windows, q)
    out = windows.new_empty((B, NW))        # f32 on windows' device
    if B == 0 or NW == 0:
        return out
    _raise_on(build.entry("scr_score")(
        windows.data_ptr(), q.data_ptr(), B, NW, d, out.data_ptr(),
        _stream(dev)), "scr_score")
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


def launch_counts() -> Dict[str, int]:
    return {n: w.launches for n, w in _WRAPPERS.items()}


reset_launch_counts()
