"""The split plan and route of the port's `decode_attention_paged` and
`decode_attention_paged_q8` kernels and plain models of their
split-and-merge arithmetic (`ref.decode_attention_paged_split`,
`ref.decode_attention_paged_q8_split`), on the CPU. The plan (splits,
head groups) must cover each row's table entries exactly once, never
make more splits than table entries, leave no head group empty, and
follow decode_attention's rule over the table's positions. The model
(partials per split of table entries, cut at each row's ceil(kv_len /
ps) entries, each head group on its own, merged in split order as the
kernel's last split block does) is held in float32 to
`ref.decode_attention_paged` at 1e-5 (f32 sums in another order) and to
the Pallas kernel in interpret mode at 2e-4 (the JAX package's own
tolerance for it), and in bf16 to `ref.decode_attention_paged` at 2e-2
(probabilities rounded to bf16 against another running max). The int8
model (on the tensor cores: int8 rows widened to bf16, k_scale on the f32
score, bf16(p * v_scale) into the PV product) is held to
`ref.decode_attention_paged_q8` and to the reference's jnp
`layers.decode_attention_q8` over the gathered pages. Tables repeat
entries, run backwards and point their tail entries at page 0, as the
engine's do. The shared-memory functions are held to the kernel
source's own expressions.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import \
    decode_attention_paged as j_decode_paged
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

CSRC = Path(ops.__file__).parent / "csrc"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("W", [1, 2, 18, 130])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("B", [1, 4, 16, 64])
def test_paged_split_plan_covers_the_table_once(B, G, W):
    for ps in (8, 16, 32, 128):
        for Hg in (1, 4, 7, 16):
            splits, groups = ops.decode_paged_split_plan(B, G, W, ps, Hg)
            assert 1 <= splits <= W
            ranges = ref.decode_paged_split_ranges(W, splits)
            assert len(ranges) == splits
            assert ranges[0][0] == 0 and ranges[-1][1] == W
            for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
                assert hi == lo2                   # contiguous, no overlap
            # no split without entries
            assert all(hi > lo for lo, hi in ranges)
            # every head in one group, no group empty
            heads = ref.decode_head_groups(Hg, groups)
            assert len(heads) == groups
            assert [h for lo, hi in heads for h in range(lo, hi)] == \
                list(range(Hg))
            # decode_attention's rule over the table's W*ps positions:
            # two-tile splits enough to fill the card, none where they
            # would be two or fewer, never more than W
            tiles = -(-W * ps // ops.DECODE_TILE)
            two = min(tiles // 2, W, -(-ops.SM_COUNT
                                       * ops.DECODE_BLOCKS_PER_SM // (B * G)))
            assert splits == (two if two > 2 else 1)
            assert (splits, groups) == ops.decode_split_plan(
                B, G, W * ps, Hg) or two == W
            # head groups only where the blocks leave SMs idle, up to one
            # block an SM
            if groups > 1:
                assert B * G * splits < ops.SM_COUNT
                assert B * G * splits * groups <= ops.SM_COUNT


def test_paged_split_plan_at_the_path_shapes():
    plan = ops.decode_paged_split_plan
    assert plan(4, 2, 18, 32, 7) == (4, 4)       # main path: 2 of 4 hold kv
    assert plan(4, 2, 130, 32, 7) == (32, 1)     # long cache
    assert plan(2, 8, 128, 32, 4) == (32, 1)     # h2o's ring pages
    assert plan(4, 2, 4, 16, 1) == (1, 1)        # one tile
    assert plan(4, 2, 4, 16, 7) == (1, 7)        # one tile: a head a block
    assert plan(64, 8, 130, 32, 2) == (1, 1)     # the card is full


def test_paged_route_by_dtype_and_dh():
    for dh in ops.DECODE_TC_DH:
        assert ops.decode_paged_route(torch.bfloat16, dh) == "tc"
        assert ops.decode_paged_route(torch.float32, dh) == "cuda"
    for dh in (48, 96, 112):
        assert ops.decode_paged_route(torch.bfloat16, dh) == "cuda"


def test_kernel_tiles_are_decode_tile():
    # ops.decode_smem_bytes and decode_tc_smem_bytes size both decode
    # kernels from DECODE_TILE: the shared body defines kTile, and the two
    # sources take it from there
    body = (CSRC / "decode_body.cuh").read_text()
    tile = re.search(r"^constexpr int kTile = (\d+);", body, re.M).group(1)
    assert int(tile) == ops.DECODE_TILE
    for name in ("decode_attention.cu", "decode_attention_paged.cu"):
        src = (CSRC / name).read_text()
        assert '#include "decode_body.cuh"' in src, name
        assert not re.search(r"constexpr int kTile", src), name


def _tc_smem_expr():
    """tc::smem_bytes's return expression in csrc/decode_body.cuh, as
    Python, with its constants."""
    body = (CSRC / "decode_body.cuh").read_text()
    consts = {name: re.search(rf"constexpr int {name} = ([^;]+);", body
                              ).group(1).split("//")[0]
              for name in ("kM", "kPR", "kSR")}
    expr = re.search(r"constexpr int smem_bytes\(\) \{\s*return ([^;]+);",
                     body).group(1)
    expr = re.sub(r"\(Q8 \? ([^:]+) : 0\)", r"((\1) if Q8 else 0)",
                  " ".join(expr.split()))
    return expr, consts


@pytest.mark.parametrize("q8", [False, True])
def test_tc_smem_bytes_match_the_kernel(q8):
    expr, consts = _tc_smem_expr()
    env = {"kTile": ops.DECODE_TILE}
    for name, value in consts.items():
        env[name] = eval(value, {}, dict(env))
    assert env["kM"] == 16 and env["kPR"] == env["kSR"] == ops.DECODE_TILE + 8
    for dh in ops.DECODE_TC_DH:
        want = eval(expr, {}, dict(env, DH=dh, Q8=q8))
        assert ops.decode_tc_smem_bytes(dh, q8) == want
        # with the merge's scratch, within a block's shared memory
        assert max(want, ops.decode_merge_bytes(130, 16)) <= ops.SMEM_LIMIT
    # an int8 pool adds its scale rings [2, 64] f32 for K and V (its rows
    # wait in registers)
    assert ops.decode_tc_smem_bytes(64, True) - ops.decode_tc_smem_bytes(
        64) == 4 * 64 * 4


def test_merge_bytes_match_the_kernel():
    # ops.decode_merge_bytes mirrors merge_floats in csrc/decode_split.cuh
    src = (CSRC / "decode_split.cuh").read_text()
    expr = re.search(r"merge_floats\(int splits, int nh\) \{\s*"
                     r"return ([^;]+);", src).group(1)
    for splits, nh in ((2, 1), (9, 7), (32, 4), (130, 16)):
        floats = eval(expr, {}, dict(splits=splits, nh=nh))
        assert ops.decode_merge_bytes(splits, nh) == floats * 4
    assert ops.decode_merge_bytes(1, 16) == 0


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
    Hg = H // G
    plan = ops.decode_paged_split_plan(B, G, W, ps, Hg)
    pallas = np.asarray(j_decode_paged(*(jnp.asarray(a) for a in
                                         (q, kp, vp, lens, tb)),
                                       interpret=True))
    groups = sorted({1, plan[1], Hg} | ({2} if Hg % 2 == 0 else set()))
    for splits in sorted({1, 2, 3, W, plan[0]} & set(range(1, W + 1))):
        for hg in groups:
            got = ref.decode_attention_paged_split(*args, splits, hg)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.parametrize("splits,groups,route", [
    (1, 1, "cuda"), (2, 1, "cuda"), (5, 1, "cuda"), (18, 1, "cuda"),
    (1, 1, "tc"), (4, 4, "tc"), (5, 7, "tc"), (18, 2, "tc")])
def test_paged_split_model_bf16(splits, groups, route):
    r = np.random.default_rng(10)
    B, H, G, dh, P, ps, W = 4, 14, 2, 64, 40, 32, 18
    q, kp, vp = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                 .bfloat16() for s in ((B, H, dh), (P, ps, G, dh),
                                       (P, ps, G, dh)))
    tb = _t(_tables("tail", B, W, P, r).astype(np.int32))
    lens = torch.tensor([0, 1, 320, 577], dtype=torch.int32)
    got = ref.decode_attention_paged_split(q, kp, vp, lens, tb, splits,
                                           groups, route)
    want = ref.decode_attention_paged(q, kp, vp, lens, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_paged_split_model_refuses_what_the_kernel_refuses():
    q, kp = torch.zeros(1, 4, 48), torch.zeros(3, 16, 1, 48)
    tb = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):                  # tc needs bf16
        ref.decode_attention_paged_split(q, kp, kp, lens, tb, 1, route="tc")
    with pytest.raises(ValueError):                  # tc: dh 48 not built
        ref.decode_attention_paged_split(q.bfloat16(), kp.bfloat16(),
                                         kp.bfloat16(), lens, tb, 1,
                                         route="tc")
    with pytest.raises(ValueError):                  # 3 groups of 2: one empty
        ref.decode_attention_paged_split(q, kp, kp, lens, tb, 1, 3)


def _q8_pool(r, P, ps, G, dh, zero_slots=()):
    """int8 pages and scales (`quantize_kv`) of a random pool, with the
    pool positions `zero_slots` (flat P*ps indices) zeroed first: their
    scales clamp to 1e-10."""
    x = r.standard_normal((2, P * ps, G, dh)).astype(np.float32) * 2
    x[:, list(zero_slots)] = 0
    kq, ks = L.quantize_kv(torch.from_numpy(x[0]))
    vq, vs = L.quantize_kv(torch.from_numpy(x[1]))
    return [t.reshape((P, ps) + t.shape[1:]) for t in (kq, ks, vq, vs)]


Q8_CASES = [
    # B, H, G, dh, P, ps, W, kv_len, table, zeroed pool slots
    (4, 14, 2, 64, 24, 32, 18, [0, 1, 96, 577], "reversed", (0, 5, 40)),
    (3, 8, 2, 80, 12, 24, 3, [64, 64, 40], "shuffled", ()),
    (2, 32, 8, 80, 10, 16, 10, [160, 33], "tail", (17,)),
    (4, 4, 2, 32, 8, 16, 4, [0, 1, 16, 64], "repeated", ()),
]


@pytest.mark.parametrize("B,H,G,dh,P,ps,W,kv_len,table,zeros", Q8_CASES)
def test_paged_q8_split_model_matches_reference(B, H, G, dh, P, ps, W,
                                                kv_len, table, zeros):
    r = np.random.default_rng(11)
    q = torch.from_numpy(r.standard_normal((B, H, dh)).astype(np.float32))
    pool = _q8_pool(r, P, ps, G, dh, zeros)
    tb = _t(_tables(table, B, W, P, r).astype(np.int32))
    lens = torch.tensor(kv_len, dtype=torch.int32)
    Hg = H // G
    plan = ops.decode_paged_split_plan(B, G, W, ps, Hg)
    gathered = [ref._gather_pages(t, tb) for t in pool]
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        qd = q.to(dt)
        want = ref.decode_attention_paged_q8(qd, *pool, lens, tb)
        # the reference in f32 over the same (bf16-exact) values: in bf16
        # it rounds its scores to bf16, which the kernels do not
        jwant = np.asarray(JL.decode_attention_q8(
            jnp.asarray(qd.float().numpy())[:, None],
            *(jnp.asarray(t.numpy()) for t in gathered),
            jnp.asarray(lens.numpy()))[:, 0])
        routes = ["cuda"] + (["tc"] if dt == torch.bfloat16 else [])
        for route in routes:
            for splits in sorted({1, 2, W, plan[0]} & set(range(1, W + 1))):
                for hg in sorted({1, plan[1], Hg}):
                    got = ref.decode_attention_paged_q8_split(
                        qd, *pool, lens, tb, splits, hg, route)
                    assert got.dtype == dt
                    np.testing.assert_allclose(
                        got.float().numpy(), want.float().numpy(), rtol=tol,
                        atol=tol)
                    np.testing.assert_allclose(got.float().numpy(), jwant,
                                               rtol=tol, atol=tol)


def test_paged_q8_model_widens_exactly_and_scales_like_the_kernel():
    """The int8 tensor-core arithmetic, written out: every int8 value is
    exact in bf16; a score is (q . kq) * scale * k_scale in f32; P V takes
    bf16(exp(s - m) * v_scale), the sum takes exp(s - m) unscaled. With
    one split and one head group the model is that formula exactly."""
    r = np.random.default_rng(12)
    B, H, G, dh, P, ps, W = 2, 8, 2, 32, 6, 16, 3
    kq, ks, vq, vs = _q8_pool(r, P, ps, G, dh)
    ints = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(ints.to(torch.bfloat16).float(), ints.float())
    q = torch.from_numpy(r.standard_normal((B, H, dh)).astype(np.float32)
                         ).bfloat16()
    tb = torch.tensor([[4, 0, 2], [1, 1, 5]], dtype=torch.int32)
    lens = torch.tensor([40, 17], dtype=torch.int32)
    got = ref.decode_attention_paged_q8_split(q, kq, ks, vq, vs, lens, tb, 1,
                                              1, "tc")
    k, v = (ref._gather_pages(t, tb).to(torch.bfloat16).float()
            for t in (kq, vq))
    ksg, vsg = (ref._gather_pages(t, tb) for t in (ks, vs))
    S = W * ps
    s = torch.einsum("bgnd,bsgd->bgns", q.float().reshape(B, G, H // G, dh),
                     k) * (1.0 / dh ** 0.5)
    s = s * ksg.permute(0, 2, 1)[:, :, None, :]
    mask = torch.arange(S)[None, :] < lens[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pv = (p * vsg.permute(0, 2, 1)[:, :, None, :]).bfloat16().float()
    o = torch.einsum("bgns,bsgd->bgnd", pv, v) / p.sum(-1)[..., None]
    assert torch.equal(got, o.reshape(B, H, dh).bfloat16())
