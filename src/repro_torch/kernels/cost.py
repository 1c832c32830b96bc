"""The cost of each kernel of `ops.KERNELS`: its FLOPs, the bytes it must
move (each input read once, each output written once) and the peak its
operations run at (`roofline.hardware`), for the work the TPU kernel
computes. Each function takes its wrapper's arguments.

From shapes alone (fake or meta tensors: the dry run's count) a kernel
is charged the most its shapes allow: every probe distinct and every
list full for `ecoscan`, every retrieved doc's windows for `scr_select`,
every slot of a cache or page table for the decode kernels. Where the
values are at hand (tensors with data, and plain ints: chip_smoke's
lens, probes, block maps, kv lengths) it counts what this call's data
needs, the distinct rows it reads. `flash_prefill` counts the (query,
key) pairs that causal, window, q_offset and kv_len leave unmasked,
which shapes and ints decide, and `flash_prefill_paged` the same pairs
over the history rows its queries attend.

The trace route: a wrapper handed a fake or meta tensor (`traced`)
records one node named after its kernel, costed here, in the active
trace (`tracing`, which `roofline.graph.trace_cost` opens) and returns
empty outputs of the kernel's shapes and types (`node`). Nothing is
computed; with no trace active `node` raises.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, List, NamedTuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.roofline import hardware as hw


class Cost(NamedTuple):
    flops: float
    bytes: float
    peak: str           # "bf16" or "f32": the peak its FLOPs run at

    def bound_ms(self):
        """(the least ms the card could take, "bytes" or "operations":
        the term that sets it)."""
        t_bytes = self.bytes / hw.HBM_BYTES_S
        t_ops = self.flops / hw.PEAKS[self.peak]
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")


def traced(t) -> bool:
    """Whether `t` is a tensor without data (fake or meta)."""
    return isinstance(t, FakeTensor) or (isinstance(t, torch.Tensor)
                                         and t.is_meta)


def _values(*ts) -> bool:
    return all(t is None or not traced(t) for t in ts)


# ------------------------------------------------------------ the kernels


def kmeans_assign(x, centroids) -> Cost:
    N, d = x.shape
    NC = centroids.shape[0]
    return Cost(2.0 * N * NC * d + 2.0 * (N + NC) * d,
                (N * d + NC * d) * 4 + N * 8, "f32")


def ecoscan(q, data, lens, probes, k: int, block_map=None) -> Cost:
    """The rows of the probed (mapped, unmasked) lists once, q, the
    probes, the map and the outputs; FLOPs 2 d a candidate row and 2 d a
    distinct row (its norm)."""
    B, d = q.shape
    CAP = data.shape[1]
    maps = 0 if block_map is None else block_map.numel()
    if _values(lens, probes, block_map):
        blk = probes.long() if block_map is None else \
            block_map[probes.clamp(min=0).long()].long()
        ok = (probes >= 0) & (blk >= 0)
        rows = int(lens[torch.unique(blk[ok])].clamp(max=CAP).sum())
        cand = int(lens[blk.clamp(min=0)].clamp(max=CAP)[ok].sum())
    else:
        rows = cand = B * probes.shape[1] * CAP
    return Cost(2.0 * d * (cand + rows),
                (rows * d + B * d + probes.numel() + maps + B * k * 2) * 4,
                "f32")


def scr_select(q, data, lens, doc_ids) -> Cost:
    B, d = q.shape
    K = doc_ids.shape[1]
    if _values(lens, doc_ids):
        valid = doc_ids >= 0
        n_win = int(lens[doc_ids.clamp(min=0).long()][valid].sum())
        rows = int(lens[torch.unique(doc_ids[valid].long())].sum())
    else:
        n_win = rows = B * K * data.shape[1]
    return Cost(2.0 * d * n_win,
                rows * d * 4 + B * d * 4 + doc_ids.numel() * 4 + B * K * 8,
                "f32")


def _paged_positions(kv_len, W: int, ps: int):
    """(positions attended, pages read) of a paged call: each row's
    kv_len clamped to its table; every slot of the tables from shapes."""
    B = kv_len.shape[0]
    if not _values(kv_len):
        return B * W * ps, B * W
    kv = int(kv_len.clamp(min=0, max=W * ps).sum())
    npg = int(((kv_len.clamp(min=0) + ps - 1) // ps).clamp(max=W).sum())
    return kv, npg


def decode_attention_paged(q, k, v, kv_len, table) -> Cost:
    B, H, dh = q.shape
    _, ps, G, _ = k.shape
    kv, npg = _paged_positions(kv_len, table.shape[1], ps)
    esz = q.element_size()
    return Cost(4.0 * kv * H * dh,
                2 * kv * G * dh * esz + 2 * q.numel() * esz + (npg + B) * 4,
                hw.peak_kind(q.dtype))


def unmasked_pairs(sq: int, q_offset: int, kv_len: int, window, causal
                   ) -> int:
    """(query, key) pairs that causal / window / kv_len leave unmasked."""
    qpos = q_offset + np.arange(sq)
    hi = np.minimum(kv_len, qpos + 1) if causal else np.full(sq, kv_len)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq)
    return int(np.clip(hi - lo, 0, None).sum())


def flash_prefill(q, k, v, *, causal: bool = True, window=None,
                  q_offset: int = 0, kv_len=None) -> Cost:
    B, Sq, H, dh = q.shape
    Sk, G = k.shape[1], k.shape[2]
    kv = Sk if kv_len is None else max(0, min(int(kv_len), Sk))
    esz = q.element_size()
    pairs = unmasked_pairs(Sq, q_offset, kv, window, causal)
    return Cost(4.0 * dh * H * B * pairs,
                (2 * q.numel() + 2 * B * kv * G * dh) * esz,
                hw.peak_kind(q.dtype))


def flash_prefill_paged(q, k, v, k_pool, v_pool, row, *, offset: int,
                        lo: int, page_size: int, ring_len: int = 0,
                        window=None, k_scale=None, v_scale=None) -> Cost:
    """q read and the output written, the chunk's K/V and the history's
    rows that some query attends (positions [max(lo, offset - window +
    1), offset), each row of K and V once, with its f32 scales from an
    int8 pool), the table entries they sit on; FLOPs 4 dh a head and
    unmasked (query, key) pair. Shapes and ints decide it all."""
    _, C, H, dh = q.shape
    G = k.shape[1]
    esz = q.element_size()
    first = max(lo, offset - window + 1) if window else lo
    rows = max(0, offset - first)
    row_bytes = 2 * G * (dh * k_pool.element_size()
                         + (4 if k_scale is not None else 0))
    pages = -(-rows // page_size) + (1 if rows else 0)
    pairs = unmasked_pairs(C, offset - lo, offset + C - lo, window, True)
    return Cost(4.0 * dh * H * pairs,
                2 * q.numel() * esz + 2 * C * G * dh * esz + rows * row_bytes
                + min(pages, row.shape[0]) * 4, hw.peak_kind(q.dtype))


def _decode_positions(kv_len, B: int, S: int) -> int:
    """Positions a contiguous decode call reads: each row's min(kv_len,
    S), or S where that is 0 (a ring's mask); every slot from shapes."""
    if isinstance(kv_len, torch.Tensor):
        if not _values(kv_len):
            return B * S
        n = kv_len.long().clamp(max=S)
        return int(torch.where(n > 0, n, S).sum())
    n = min(int(kv_len), S)
    return B * (n if n > 0 else S)


def decode_attention(q, k, v, kv_len, ring: bool = False) -> Cost:
    B, H, dh = q.shape
    S, G = k.shape[1], k.shape[2]
    n = _decode_positions(kv_len, B, S)
    esz = q.element_size()
    return Cost(4.0 * n * H * dh,
                2 * n * G * dh * esz + 2 * q.numel() * esz + 4 * B,
                hw.peak_kind(q.dtype))


def _q8(q, n_pos: int, G: int) -> Cost:
    """An int8 decode call over n_pos positions: int8 K and V and their
    f32 scales once, q read and the output written once, kv_len."""
    B, H, dh = q.shape
    esz = q.element_size()
    return Cost(4.0 * n_pos * H * dh,
                2 * n_pos * G * (dh + 4) + 2 * q.numel() * esz + 4 * B,
                hw.peak_kind(q.dtype))


def decode_attention_q8(q, kq, ks, vq, vs, kv_len, ring: bool = False
                        ) -> Cost:
    S, G = kq.shape[1], kq.shape[2]
    return _q8(q, _decode_positions(kv_len, q.shape[0], S), G)


def decode_attention_paged_q8(q, kq, ks, vq, vs, kv_len, table) -> Cost:
    kv, _ = _paged_positions(kv_len, table.shape[1], kq.shape[1])
    return _q8(q, kv, kq.shape[2])


def scr_score(windows, q) -> Cost:
    B, NW, d = windows.shape
    return Cost(2.0 * B * NW * d, (B * NW * d + B * d + B * NW) * 4, "f32")


def pq_adc(lut, codes, starts=None, offsets=None, rows=None) -> Cost:
    B, M, K = lut.shape
    if starts is None:
        rows, seg_bytes = codes.shape[0], 0
    else:
        seg_bytes = (starts.numel() + offsets.numel()) * 4
    return Cost(float(B * rows * M),
                rows * M + (B * M * K + B * rows) * 4 + seg_bytes, "f32")


# ------------------------------------------------------------- the trace

_TRACES: List[Callable[[str, Cost], None]] = []


@contextmanager
def tracing(record: Callable[[str, Cost], None]):
    """Within the block, kernel nodes go to `record(name, cost)`."""
    _TRACES.append(record)
    try:
        yield
    finally:
        _TRACES.pop()


def node(name: str, outputs: Callable[[], object], *args, **kw):
    """The trace route of wrapper `name`: record its node, costed by this
    module's function of that name on the wrapper's arguments, in the
    active trace and return `outputs()` (empty tensors of the kernel's
    shapes and types). Raises with no trace active."""
    if not _TRACES:
        raise RuntimeError(
            f"{name}: a tensor without data (fake or meta) outside a dry-run "
            "trace (roofline.graph.trace_cost); the kernel computes nothing "
            "on it")
    _TRACES[-1](name, globals()[name](*args, **kw))
    return outputs()
