"""The parts of `jax.random` that the reference's sampled decoding uses,
in plain PyTorch on the device of its inputs, equal bit for bit to jax's
threefry2x32 PRNG in its partitionable layout (`jax_threefry_partitionable`,
on by default since jax 0.5).

A key is two 32-bit words, carried as an int64 tensor [..., 2]: PyTorch
has no shifts on `uint32` on the CPU, so every word is a non-negative
int64 below 2^32 and every add is masked back to 32 bits.

- `prng_key(seed)` is `jax.random.PRNGKey(seed)` ([0, seed] for
  0 <= seed < 2^31); `fold_in(key, data)` is threefry of the counter
  (0, data) under `key`.
- `random_bits(key, shape)`: the words `y0 ^ y1` of threefry over the
  counters (0, i), i = 0 .. prod(shape) - 1.
- `uniform(key, shape)`: jax's `uniform(minval=tiny, maxval=1)` in its
  order of operations; `gumbel` is `-log(-log(u))` of it, where `log`
  may round one ulp apart from XLA's.
- `categorical(key, row)` and `sample_rows(...)`, the reference
  engine's `_sample_rows`: a greedy row takes the first maximum; a
  sampled row draws under `fold_in(key, t)` as `first_argmax(row.f32 +
  gumbel)`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.ref import first_argmax

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32 tiny (the smallest normal) and jax's `maxval - minval` in f32
_TINY = float(np.finfo(np.float32).tiny)
_SPAN = float(np.float32(1.0) - np.float32(_TINY))


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds, five key injections) of the counter
    words (x0, x1) under the key words (k0, k1); int64 tensors or numpy
    arrays of 32-bit values, broadcast together. Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as an int64 [2] tensor on the host."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2^31)")
    return torch.tensor([0, seed], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for keys [..., 2] and 32-bit
    non-negative data (an int or an int tensor broadcast against the
    keys' leading shape)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data & M32)
    return torch.stack([y0, y1], -1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32) as int64 values; `key` [2],
    or [B, 2] for B independent draws of `shape` ([B, *shape] out)."""
    n = int(np.prod(shape))
    ctr = torch.arange(n, dtype=torch.int64, device=key.device)
    k0, k1 = key[..., 0, None], key[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return (y0 ^ y1).reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.uniform(key, shape, minval=tiny, maxval=1)` in float32:
    the top 23 bits as the mantissa of [1, 2), minus 1, scaled and
    shifted in f32, floored at tiny."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * _SPAN + _TINY, _TINY)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.gumbel(key, shape)` in float32 ("low" mode)."""
    return -torch.log(-torch.log(uniform(key, shape)))


def categorical(key: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, row)` over the last axis: the first
    maximum of the f32 logits plus Gumbel noise. `key` [2] for one row
    or [B, 2] for rows [B, V]."""
    row = row.float()
    return first_argmax(row + gumbel(key, row.shape[-1:]), -1)


def sample_rows(logits: torch.Tensor, keys, ts, greedy) -> torch.Tensor:
    """One next token a row, every row in one call: the reference
    engine's `_sample_rows`.

    logits [B, V] (any float dtype; upcast to f32); keys [B, 2] int
    stream roots, ts [B] draw counters and greedy [B] flags, on the host
    (numpy or sequences). A greedy row takes the first maximum; a sampled
    row draws `categorical(fold_in(keys[b], ts[b]), logits[b])`. Only the
    sampled rows are drawn, in one batch; their keys are folded on the
    host (a few words) and uploaded once. Returns [B] int64 on the
    logits' device; nothing is read back here."""
    rows = logits.float()
    out = first_argmax(rows, -1)
    sampled = np.flatnonzero(~np.asarray(greedy, bool))
    if len(sampled):
        dev = rows.device
        k = np.asarray(keys, np.int64)[sampled]
        t = np.asarray(ts, np.int64)[sampled] & M32
        y0, y1 = threefry2x32(k[:, 0], k[:, 1], np.zeros_like(t), t)
        folded = torch.as_tensor(np.stack([y0, y1], -1), device=dev)
        idx = torch.as_tensor(sampled, device=dev)
        out = out.index_copy(0, idx, categorical(folded, rows[idx]))
    return out
