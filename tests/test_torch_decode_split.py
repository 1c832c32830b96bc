"""The split plan of the port's `decode_attention` kernel and a plain
model of its split-and-merge arithmetic (`ref.decode_attention_split`),
on the CPU. The plan must tile each row's cache exactly once, in splits
of at least two tiles, never more splits than tiles, and cover the
card's SMs where the cache is long enough. The model (partials per
split, merged in split order, as the CUDA merge kernel does) is held in
float32 to `ref.decode_attention` at 1e-5 (f32 sums in another order)
and to the Pallas kernel in interpret mode at 2e-4 (the JAX package's
own tolerance for it), and in bf16 to `ref.decode_attention` at 2e-2
(probabilities rounded to bf16 against another running max).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as j_decode
from repro_torch.kernels import ops, ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 200, 4096, 4609,
                               40000])
def test_split_plan_tiles_the_cache_once(S):
    tiles = -(-S // ops.DECODE_TILE)
    for B in (1, 2, 3, 4, 16, 64, 200):
        for G in (1, 2, 8):
            splits = ops.decode_split_plan(B, G, S)
            assert 1 <= splits <= tiles
            ranges = ref.decode_split_ranges(S, splits)
            assert len(ranges) == splits
            assert ranges[0][0] == 0 and ranges[-1][1] == S
            for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
                assert hi == lo2                   # contiguous, no overlap
            for lo, hi in ranges:
                assert lo % ops.DECODE_TILE == 0
                if splits > 1:                     # at least two tiles
                    assert -(-(hi - lo) // ops.DECODE_TILE) >= 2
            # the blocks fill the card unless the cache is too short
            assert (B * G * splits
                    >= ops.SM_COUNT * ops.DECODE_BLOCKS_PER_SM
                    or splits == max(1, tiles // 2))


def test_split_plan_at_the_path_shapes():
    assert ops.decode_split_plan(1, 8, 4096) == 32       # h2o ring, B 1
    assert ops.decode_split_plan(2, 8, 4096) == 32       # h2o ring, B 2
    assert ops.decode_split_plan(4, 8, 4096) == 17
    assert ops.decode_split_plan(16, 2, 160) == 1        # qwen wave
    assert ops.decode_split_plan(4, 2, 40) == 1


def test_smem_bytes_of_the_path_shapes():
    # h2o ring in bf16: two 64 x 88 bf16 rings each for K and V, then f32
    assert ops.decode_smem_bytes(4, 80, 2) == 4 * 64 * 88 * 2 + (
        4 * 80 + 4 * 64 + 12) * 4
    assert ops.decode_smem_bytes(7, 128, 4) <= 227 * 1024


@pytest.mark.parametrize("B,H,G,dh,S,kv_len,splits", [
    (4, 8, 2, 32, 128, [3, 100, 128, 57], 2),        # per-row lengths
    (2, 4, 1, 32, 192, [400, 20], 3),                # ring: a row past S
    (3, 4, 2, 32, 128, [0, 5, -2], 2),               # kv_len <= 0: uniform
    (2, 4, 2, 32, 512, [1, 70], 8),                  # empty splits
    (1, 32, 8, 80, 256, [300], None),                # h2o grouping, plan
    (2, 32, 8, 80, 640, [641, 300], None),           # h2o, ragged splits
    (2, 14, 2, 64, 200, [150, 200], 3),              # S not a tile multiple
])
def test_split_model_matches_pallas_and_oracle(B, H, G, dh, S, kv_len,
                                               splits):
    r = np.random.default_rng(7)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((B, H, dh), (B, S, G, dh), (B, S, G, dh)))
    lens = np.asarray(kv_len, np.int32)
    if splits is None:
        splits = ops.decode_split_plan(B, G, S)
        assert splits > 1
    ring = bool((lens > S).any())
    got = ref.decode_attention_split(_t(q), _t(k), _t(v), _t(lens), splits)
    want = ref.decode_attention(_t(q), _t(k), _t(v), _t(lens), ring=ring)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the Pallas kernel's uniform row of kv_len <= 0 spans its padded
    # tiles, so it is compared where ts divides S
    ts = 64 if S % 64 == 0 else 512
    if (lens > 0).all() or S % ts == 0:
        pallas = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(lens), ts=ts, interpret=True,
                          ring=ring)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_split_model_bf16_and_split_count(splits):
    r = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((2, 8, 64), (2, 320, 2, 64),
                                     (2, 320, 2, 64)))
    lens = torch.tensor([320, 97], dtype=torch.int32)
    got = ref.decode_attention_split(q, k, v, lens, splits)
    want = ref.decode_attention(q, k, v, lens)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2)
    one = ref.decode_attention_split(q.float(), k.float(), v.float(), lens, 1)
    many = ref.decode_attention_split(q.float(), k.float(), v.float(), lens,
                                      splits)
    np.testing.assert_allclose(many.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-5)
