"""The split plan of the port's `decode_attention_paged` kernel and a
plain model of its split-and-merge arithmetic
(`ref.decode_attention_paged_split`), on the CPU. The plan must cover
each row's table entries exactly once, never make more splits than table
entries, and fill the card's SMs where the table is long enough. The
model (partials per split of table entries, cut at each row's
ceil(kv_len / ps) entries, merged in split order as the CUDA merge
kernel does) is held in float32 to `ref.decode_attention_paged` at 1e-5
(f32 sums in another order) and to the Pallas kernel in interpret mode
at 2e-4 (the JAX package's own tolerance for it), and in bf16 to
`ref.decode_attention_paged` at 2e-2 (probabilities rounded to bf16
against another running max). Tables repeat entries, run backwards and
point their tail entries at page 0, as the engine's do.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import \
    decode_attention_paged as j_decode_paged
from repro_torch.kernels import ops, ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("W", [1, 2, 18, 130])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("B", [1, 4, 16, 64])
def test_paged_split_plan_covers_the_table_once(B, G, W):
    for ps in (8, 16, 32, 128):
        splits = ops.decode_paged_split_plan(B, G, W, ps)
        assert 1 <= splits <= W
        ranges = ref.decode_paged_split_ranges(W, splits)
        assert len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == W
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2                       # contiguous, no overlap
        assert all(hi > lo for lo, hi in ranges)   # no split without entries
        # the blocks fill the card unless the table is too short: then one
        # split per entry, or per DECODE_TILE positions of the table
        tiles = -(-W * ps // ops.DECODE_TILE)
        assert (B * G * splits >= ops.SM_COUNT * ops.DECODE_BLOCKS_PER_SM
                or splits == min(W, tiles))


def test_paged_split_plan_at_the_path_shapes():
    assert ops.decode_paged_split_plan(4, 2, 18, 32) == 9     # main path
    assert ops.decode_paged_split_plan(4, 2, 130, 32) == 65   # long cache
    assert ops.decode_paged_split_plan(4, 2, 4, 16) == 1      # one tile
    assert ops.decode_paged_split_plan(64, 8, 130, 32) == 2


def test_kernel_tiles_are_decode_tile():
    # ops.decode_smem_bytes sizes both decode kernels from DECODE_TILE
    csrc = Path(ops.__file__).parent / "csrc"
    for name in ("decode_attention.cu", "decode_attention_paged.cu"):
        tile = re.search(r"^constexpr int kTile = (\d+);",
                         (csrc / name).read_text(), re.M).group(1)
        assert int(tile) == ops.DECODE_TILE, name


def _tables(kind, B, W, P, r):
    if kind == "shuffled":
        return np.stack([r.permutation(P)[:W] for _ in range(B)])
    if kind == "reversed":
        return np.stack([np.arange(W)[::-1] + b for b in range(B)]) % P
    if kind == "repeated":
        return np.stack([np.repeat(r.permutation(P)[:(W + 1) // 2], 2)[:W]
                         for _ in range(B)])
    t = np.stack([r.permutation(P)[:W] for _ in range(B)])   # tail at page 0
    t[:, (W + 1) // 2:] = 0
    return t


CASES = [
    # B, H, G, dh, P, ps, W, kv_len, table
    (4, 4, 2, 32, 8, 16, 4, [0, 1, 16, 64], "repeated"),
    (4, 14, 2, 64, 24, 32, 18, [0, 1, 96, 576], "reversed"),
    (3, 8, 2, 32, 12, 8, 9, [72, 8, 41], "tail"),
    (2, 32, 8, 80, 10, 16, 10, [160, 33], "shuffled"),
    (4, 4, 1, 32, 6, 24, 5, [-3, 24, 25, 120], "tail"),
]


@pytest.mark.parametrize("B,H,G,dh,P,ps,W,kv_len,table", CASES)
def test_paged_split_model_matches_pallas_and_oracle(B, H, G, dh, P, ps, W,
                                                     kv_len, table):
    r = np.random.default_rng(9)
    q = r.standard_normal((B, H, dh)).astype(np.float32)
    kp = r.standard_normal((P, ps, G, dh)).astype(np.float32)
    vp = r.standard_normal((P, ps, G, dh)).astype(np.float32)
    tb = _tables(table, B, W, P, r).astype(np.int32)
    lens = np.asarray(kv_len, np.int32)
    args = tuple(_t(a) for a in (q, kp, vp, lens, tb))
    want = ref.decode_attention_paged(*args)
    plan = ops.decode_paged_split_plan(B, G, W, ps)
    pallas = np.asarray(j_decode_paged(*(jnp.asarray(a) for a in
                                         (q, kp, vp, lens, tb)),
                                       interpret=True))
    for splits in sorted({1, 2, 3, W, plan} & set(range(1, W + 1))):
        got = ref.decode_attention_paged_split(*args, splits)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("splits", [1, 2, 5, 18])
def test_paged_split_model_bf16(splits):
    r = np.random.default_rng(10)
    B, H, G, dh, P, ps, W = 4, 14, 2, 64, 40, 32, 18
    q, kp, vp = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                 .bfloat16() for s in ((B, H, dh), (P, ps, G, dh),
                                       (P, ps, G, dh)))
    tb = _t(_tables("tail", B, W, P, r).astype(np.int32))
    lens = torch.tensor([0, 1, 320, 577], dtype=torch.int32)
    got = ref.decode_attention_paged_split(q, kp, vp, lens, tb, splits)
    want = ref.decode_attention_paged(q, kp, vp, lens, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2)
