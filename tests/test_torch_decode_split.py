"""The split plan of the port's `decode_attention` kernel, a plain model
of its split-and-merge arithmetic (`ref.decode_attention_split`), and
the wrappers' input checks (every wrapper's, and `scr_score`'s inline
one), on the CPU. The plan must tile each
row's cache exactly once and cover each head once, in splits that start
at a tile and hold at least two tiles, no split where two-tile splits
would be two or fewer, and head groups only where the blocks leave SMs
idle. The model (partials per split and head group, merged in split
order, as the kernel's last block does) is held in float32 to
`ref.decode_attention` at 1e-5 (f32 sums in another order) and to the
Pallas kernel in interpret mode at 2e-4 (the JAX package's own
tolerance for it), and in bf16 to `ref.decode_attention` at 2e-2
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


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 200, 512, 1500,
                               4096, 4609, 40000])
def test_split_plan_tiles_the_cache_once(S):
    tiles = -(-S // ops.DECODE_TILE)
    for B in (1, 2, 3, 4, 16, 64, 200):
        for G in (1, 2, 8, 12):
            for Hg in (1, 2, 4, 7, 16):
                splits, groups = ops.decode_split_plan(B, G, S, Hg)
                assert 1 <= splits <= tiles
                ranges = ref.decode_split_ranges(S, splits)
                assert len(ranges) == splits
                assert ranges[0][0] == 0 and ranges[-1][1] == S
                for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
                    assert hi == lo2               # contiguous, no overlap
                for lo, hi in ranges:
                    assert lo % ops.DECODE_TILE == 0
                # every head in one group, no group empty
                heads = ref.decode_head_groups(Hg, groups)
                assert len(heads) == groups
                assert [h for lo, hi in heads for h in range(lo, hi)] == \
                    list(range(Hg))
                # splits of at least two tiles, enough to fill the card,
                # and none where two-tile splits would be two or fewer
                two = min(tiles // 2, -(-ops.SM_COUNT
                                        * ops.DECODE_BLOCKS_PER_SM
                                        // (B * G)))
                if splits > 1:
                    assert min(hi - lo for lo, hi in ranges[:-1]) \
                        >= 2 * ops.DECODE_TILE
                    assert -(-(ranges[-1][1] - ranges[-1][0])
                             // ops.DECODE_TILE) >= 2
                assert splits == (two if two > 2 else 1)
                # head groups only where the blocks leave SMs idle, up to
                # one block an SM
                if groups > 1:
                    assert B * G * splits < ops.SM_COUNT
                    assert B * G * splits * groups <= ops.SM_COUNT


@pytest.mark.parametrize("B,G,S,Hg,plan", [
    (2, 1, 512, 16, (4, 16)),         # recurrentgemma ring: 128 blocks
    (2, 12, 1500, 1, (12, 1)),        # whisper cross-attention
    (16, 2, 280, 7, (1, 4)),          # qwen wave: no split, 4 head groups
    (16, 2, 160, 7, (1, 4)),
    (4, 2, 40, 7, (1, 7)),            # one tile: one head a block
    (1, 8, 4096, 4, (32, 1)),         # h2o ring, B 1
    (2, 8, 4096, 4, (32, 1)),         # h2o ring, B 2
    (4, 8, 4096, 4, (17, 1)),
    (16, 8, 280, 2, (1, 1)),          # MoE wave
    (1, 1, 8192, 8, (64, 2)),         # chip_smoke's "64 splits" edge
])
def test_split_plan_at_the_path_shapes(B, G, S, Hg, plan):
    assert ops.decode_split_plan(B, G, S, Hg) == plan


def test_smem_bytes_of_the_path_shapes():
    # h2o ring in bf16: two 64 x 88 bf16 rings each for K and V, then f32
    assert ops.decode_smem_bytes(4, 80, 2) == 4 * 64 * 88 * 2 + (
        4 * 80 + 4 * 64 + 12) * 4
    assert ops.decode_smem_bytes(7, 128, 4) <= 227 * 1024


@pytest.mark.parametrize("B,H,G,dh,S,kv_len,splits,groups", [
    (4, 8, 2, 32, 128, [3, 100, 128, 57], 2, 1),     # per-row lengths
    (2, 4, 1, 32, 192, [400, 20], 3, 2),             # ring: a row past S
    (3, 4, 2, 32, 128, [0, 5, -2], 2, 2),            # kv_len <= 0: uniform
    (2, 4, 2, 32, 512, [1, 70], 8, 1),               # empty splits
    (1, 32, 8, 80, 256, [300], None, None),          # h2o grouping, plan
    (2, 32, 8, 80, 640, [641, 300], None, None),     # h2o, ragged splits
    (2, 14, 2, 64, 200, [150, 200], 3, 3),           # S not a tile multiple
    (2, 16, 1, 256, 192, [193, 70], None, None),     # recurrentgemma ring
    (2, 16, 1, 256, 128, [128, 1], 2, 16),           # one head a block
    (2, 12, 12, 64, 1500, [1500, 1499], 24, 1),      # whisper: one tile
])
def test_split_model_matches_pallas_and_oracle(B, H, G, dh, S, kv_len,
                                               splits, groups):
    r = np.random.default_rng(7)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((B, H, dh), (B, S, G, dh), (B, S, G, dh)))
    lens = np.asarray(kv_len, np.int32)
    if splits is None:
        splits, groups = ops.decode_split_plan(B, G, S, H // G)
        assert splits > 1 or groups > 1
    ring = bool((lens > S).any())
    got = ref.decode_attention_split(_t(q), _t(k), _t(v), _t(lens), splits,
                                     head_groups=groups)
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


@pytest.mark.parametrize("splits,groups,route", [
    (1, 1, "cuda"), (2, 1, "cuda"), (5, 1, "cuda"), (1, 1, "tc"),
    (5, 1, "tc"), (5, 2, "tc"), (5, 4, "tc"), (2, 4, "cuda")])
def test_split_model_bf16_and_split_count(splits, groups, route):
    r = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((2, 8, 64), (2, 320, 2, 64),
                                     (2, 320, 2, 64)))
    lens = torch.tensor([320, 97], dtype=torch.int32)
    got = ref.decode_attention_split(q, k, v, lens, splits, groups, route)
    want = ref.decode_attention(q, k, v, lens)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2)
    one = ref.decode_attention_split(q.float(), k.float(), v.float(), lens, 1)
    many = ref.decode_attention_split(q.float(), k.float(), v.float(), lens,
                                      splits, groups)
    np.testing.assert_allclose(many.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_split_model_refuses_what_the_kernel_refuses():
    q, k = torch.zeros(1, 4, 48).bfloat16(), torch.zeros(1, 64, 1, 48)
    with pytest.raises(ValueError):                  # tc needs bf16
        ref.decode_attention_split(q.float(), k, k, 64, 1, route="tc")
    with pytest.raises(ValueError):                  # tc: dh 48 not built
        ref.decode_attention_split(q, k.bfloat16(), k.bfloat16(), 64, 1,
                                   route="tc")
    with pytest.raises(ValueError):                  # 3 groups of 2: one empty
        ref.decode_attention_split(q.float(), k, k, 64, 1, head_groups=3)
    assert ref.decode_head_groups(7, 3) == [(0, 3), (3, 6), (6, 7)]
    assert ops.decode_route(torch.bfloat16, 256) == "tc"
    assert ops.decode_route(torch.float32, 256) == "cuda"
    assert ops.decode_route(torch.bfloat16, 48) == "cuda"


def test_smem_of_the_tensor_core_route():
    # K, V rings and Q in bf16 rows of dh + 8, P, then f32 scores and
    # the three running vectors, and two tiles' row slots (8 bytes each);
    # one dh-256 block within 227 KB
    assert ops.decode_tc_smem_bytes(256) == (4 * 64 + 16) * 264 * 2 + \
        16 * 72 * 2 + (16 * 72 + 48) * 4 + 2 * 64 * 8
    assert all(ops.decode_tc_smem_bytes(d) <= ops.SMEM_LIMIT
               for d in ops.DECODE_TC_DH)
    assert ops.decode_merge_bytes(1, 16) == 0
    assert ops.decode_merge_bytes(8, 2) == 25 * 2 * 4


class _FakeCuda:
    """The getters `ops.scr_score`'s inline check reads of a CUDA tensor,
    over a CPU tensor (the inline path runs only for CUDA tensors)."""

    def __init__(self, t, index=0):
        self._t, self._index = t, index
        self.is_cuda, self.dtype, self.shape = True, t.dtype, t.shape
        self.device = torch.device("cuda", index)

    def get_device(self):
        return self._index

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._t.is_contiguous()


def _bad_pairs():
    w, q = torch.zeros(2, 4, 8), torch.zeros(2, 8)
    yield "dtype", (w, 0), (q.double(), 0)
    yield "ndim", (w, 0), (w, 0)
    yield "contiguous", (w.transpose(1, 2), 0), (q, 0)
    yield "device index", (w, 0), (q, 1)
    yield "on the cpu", (w, 0), (q, None)


@pytest.mark.parametrize("case", [c for c, *_ in _bad_pairs()])
def test_scr_score_inline_check_raises_as_checked(case):
    """scr_score's inline check of CUDA inputs hands every input it does
    not pass to `_checked`, which raises what the full check finds."""
    _, *pair = next(p for p in _bad_pairs() if p[0] == case)
    w, q = (t if i is None else _FakeCuda(t, i) for t, i in pair)
    with pytest.raises((TypeError, ValueError)) as inline:
        ops.scr_score(w, q)
    with pytest.raises((TypeError, ValueError)) as full:
        ops._checked((w, "windows", torch.float32, 3),
                     (q, "q", torch.float32, 2))
    assert type(inline.value) is type(full.value)
    assert str(inline.value) == str(full.value)


def _wrapper_cases():
    f, i32 = torch.float32, torch.int32
    q, w = torch.zeros(2, 8), torch.zeros(2, 4, 8)
    lens = torch.zeros(3, dtype=i32)
    qd, kd = torch.zeros(2, 4, 32), torch.zeros(2, 16, 2, 32)
    k8, s8 = torch.zeros(2, 16, 2, 32, dtype=torch.int8), torch.zeros(2, 16, 2)
    pk, ps = torch.zeros(4, 8, 2, 32), torch.zeros(4, 8, 2)
    pk8 = pk.to(torch.int8)
    kv, tb = torch.ones(2, dtype=i32), torch.zeros(2, 2, dtype=i32)
    return {
        "kmeans_assign": (lambda: ops.kmeans_assign(q.double(), q), TypeError),
        "ecoscan": (lambda: ops.ecoscan(q, torch.zeros(3, 4, 8), lens,
                                        torch.zeros(2, 4, dtype=i32)[:, ::2],
                                        2), ValueError),
        "scr_select": (lambda: ops.scr_select(q, torch.zeros(3, 4, 8),
                                              lens.long(),
                                              torch.zeros(2, 1, dtype=i32)),
                       TypeError),
        "decode_attention_paged": (lambda: ops.decode_attention_paged(
            qd, pk, pk, kv, tb[None]), ValueError),
        "flash_prefill": (lambda: ops.flash_prefill(
            torch.zeros(1, 4, 4, 32), kd[:1].transpose(1, 2), kd[:1]),
            ValueError),
        "decode_attention": (lambda: ops.decode_attention(
            qd, kd, kd, kv.to(f)), TypeError),
        "scr_score": (lambda: ops.scr_score(w, q[:, None]), ValueError),
        "pq_adc": (lambda: ops.pq_adc(torch.zeros(1, 2, 4),
                                      torch.zeros(5, 2, dtype=i32)),
                   TypeError),
        "decode_attention_q8": (lambda: ops.decode_attention_q8(
            qd, k8, s8.double(), k8, s8, kv), TypeError),
        "decode_attention_paged_q8": (lambda: ops.decode_attention_paged_q8(
            qd, pk8, ps, pk8.transpose(1, 2), ps, kv, tb), ValueError),
        "flash_prefill_paged": (lambda: ops.flash_prefill_paged(
            torch.zeros(1, 4, 4, 32), kd[0, :4], kd[0, :4], pk,
            pk.transpose(1, 2), tb[0], offset=8, lo=0, page_size=8),
            ValueError),
    }


@pytest.mark.parametrize("name", ops.KERNELS)
def test_every_wrapper_still_checks_its_inputs(name):
    call, exc = _wrapper_cases()[name]
    with pytest.raises(exc):
        call()
