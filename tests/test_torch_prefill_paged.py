"""flash_prefill_paged on the CPU: its plain version against the JAX
package's `repro.models.layers.attention` over the buffer that
`repro.models.dense.paged_attn_chunk` assembles from the pool through
`_pool_gather` (float32, 1e-5; rows that wrap a ring and rows that do
not, a history that starts past position 0, a table that repeats and
reverses pages, int8 pools with their scales); the bf16 route's split
plan (`ops.prefill_paged_plan`); the wrapper's refusals and its trace
route; `DenseLM.prefill_chunk_paged` making one flash_prefill_paged call
a layer and no flash_prefill call; the source's tile constants. The
kernel itself runs on the card only: chip_smoke.py holds it against the
plain version there."""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import dense as jdense
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.kernels import cost, ops, ref
from repro_torch.models import layers as L
from repro_torch.models.dense import DenseLM, chunk_rows, init_page_pool

SRC = (Path(ops.__file__).parent / "csrc" / "flash_prefill_paged.cu"
       ).read_text()


def _reference(q, k, v, kp, vp, row, offset, ps, ring_len, window,
               ks=None, vs=None):
    """The JAX package's chunk attention over its own assembled buffer:
    a ring's cursors placed at their absolute positions, or a row's pool
    with the chunk written and gathered whole (paged_attn_chunk)."""
    C = q.shape[1]
    kq, vq = jnp.asarray(k), jnp.asarray(v)
    pools = [jnp.asarray(kp), jnp.asarray(vp)]
    scales = None if ks is None else [jnp.asarray(ks), jnp.asarray(vs)]
    jrow = jnp.asarray(row)

    def gathered(i):
        g = jdense._pool_gather(pools[i], jrow, ps)
        if scales is None:
            return g
        return JL.dequantize_kv(g, jdense._pool_gather(scales[i], jrow, ps),
                                jnp.float32)
    if ring_len:
        abs_len = offset + C
        j = jnp.arange(ring_len)
        p_hist = offset - 1 - ((offset - 1 - j) % ring_len)
        dst = jnp.where(p_hist >= 0, p_hist, abs_len)
        full = []
        for i, new in ((0, kq), (1, vq)):
            buf = jnp.zeros((abs_len,) + new.shape[1:], jnp.float32)
            buf = buf.at[dst].set(gathered(i)[:ring_len], mode="drop")
            full.append(jax.lax.dynamic_update_slice(buf, new, (offset, 0, 0)))
    else:
        p = offset + np.arange(C)
        pg, off = jrow[p // ps], p % ps
        for i, new in ((0, kq), (1, vq)):
            if scales is None:
                pools[i] = pools[i].at[pg, off].set(new)
            else:
                qv, s = JL.quantize_kv(new)
                pools[i] = pools[i].at[pg, off].set(qv)
                scales[i] = scales[i].at[pg, off].set(s)
        full = [gathered(0), gathered(1)]
    out = JL.attention(jnp.asarray(q), full[0][None], full[1][None],
                       causal=True, window=window, q_offset=offset,
                       kv_len=offset + C)
    return np.asarray(out)


CASES = {
    # label: (C, H, G, dh, ps, W, P, offset, ring_len, window, row kind)
    "row": (8, 4, 2, 16, 8, 6, 10, 24, 0, None, "perm"),
    "row, history 0": (8, 4, 2, 16, 8, 6, 10, 0, 0, None, "perm"),
    "ring not wrapped": (8, 4, 2, 16, 8, 4, 10, 16, 32, 32, "perm"),
    "ring wrapped": (8, 4, 2, 16, 8, 4, 10, 40, 32, 32, "perm"),
    "ring wrapped, lo > 0": (8, 8, 2, 32, 8, 4, 10, 120, 32, 32, "perm"),
    "ring over 24-position pages, lo > 0": (8, 4, 1, 16, 24, 3, 8, 136, 64,
                                            64, "perm"),
    "pages repeated and reversed": (8, 4, 2, 16, 8, 8, 14, 32, 0, None,
                                    "repeat"),
}


def _row(kind, W, P, rng):
    if kind == "repeat":     # history pages 3, 7, 7, 3; the chunk's its own
        return np.asarray([3, 7, 7, 3] + list(range(9, 9 + W - 4)), np.int32)
    return rng.permutation(P)[:W].astype(np.int32)


@pytest.mark.parametrize("int8", [False, True], ids=["f32 pool", "int8 pool"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_reference(case, int8):
    C, H, G, dh, ps, W, P, offset, ring_len, window, kind = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    q = rng.standard_normal((1, C, H, dh)).astype(np.float32)
    k, v = (rng.standard_normal((C, G, dh)).astype(np.float32)
            for _ in range(2))
    kp, vp = (rng.standard_normal((P, ps, G, dh)).astype(np.float32)
              for _ in range(2))
    row = _row(kind, W, P, rng)
    tq, trow = torch.tensor(q), torch.tensor(row)
    tk, tv = torch.tensor(k), torch.tensor(v)
    tile = ops.prefill_paged_key_tile(torch.float32, dh)
    lo, _ = chunk_rows(trow, offset, C, offset + C, ps, ring_len, tile=tile)
    if "lo > 0" in case:
        assert lo > 0
    kw = dict(offset=offset, lo=lo, page_size=ps, ring_len=ring_len,
              window=window)
    if int8:
        (kq, ks), (vq, vs) = (L.quantize_kv(torch.tensor(t)) for t in (kp, vp))
        tk, tv = (L.dequantize_kv(*L.quantize_kv(t), torch.float32)
                  for t in (tk, tv))
        got = ref.flash_prefill_paged(tq, tk, tv, kq, vq, trow, k_scale=ks,
                                      v_scale=vs, **kw)
        want = _reference(q, tk.numpy(), tv.numpy(), kq.numpy(), vq.numpy(),
                          row, offset, ps, ring_len, window, ks.numpy(),
                          vs.numpy())
    else:
        got = ref.flash_prefill_paged(tq, tk, tv, torch.tensor(kp),
                                      torch.tensor(vp), trow, **kw)
        want = _reference(q, k, v, kp, vp, row, offset, ps, ring_len, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the wrapper on the CPU is the plain version
    wrapped = ops.flash_prefill_paged(
        tq, tk, tv, *((kq, vq) if int8 else (torch.tensor(kp),
                                             torch.tensor(vp))), trow,
        **kw, **({"k_scale": ks, "v_scale": vs} if int8 else {}))
    assert torch.equal(wrapped, got)


def test_history_rows_in_position_order():
    row = torch.tensor([4, 0, 2], dtype=torch.int32)
    got = ref.history_rows(row, 5, 11, 4, 12)
    cur = np.arange(5, 11) % 12
    assert got.tolist() == (np.asarray([4, 0, 2])[cur // 4] * 4
                            + cur % 4).tolist()


@pytest.mark.parametrize("C,hist,G,Hg,dh,window", [
    (32, 4128, 8, 4, 80, 4096), (32, 64, 2, 7, 64, None),
    (32, 200, 8, 6, 128, None), (77, 130, 1, 12, 128, None),
    (20, 150, 1, 16, 256, 40), (1, 257, 2, 7, 64, None),
    (32, 0, 8, 2, 64, None), (32, 20000, 2, 7, 64, None)])
def test_plan_covers_every_key_tile_once(C, hist, G, Hg, dh, window):
    """The plan's tiles run from the first query's window (rounded down
    to a key tile) past the last query by less than a tile, and under the
    kernel's rule (split s walks the tiles [s * tiles // splits, (s + 1) *
    tiles // splits)) the splits take each tile once, every split at
    least one; forced counts alike, and more splits than tiles refused."""
    plan = ops.prefill_paged_plan(C, hist, G, Hg, dh, window)
    bk = plan.key_tile
    assert bk == (64 if dh <= 128 else 32)
    first = max(0, hist - window + 1) if window else 0
    assert plan.kbeg % bk == 0 and plan.kbeg <= first < plan.kbeg + bk
    kend = plan.kbeg + plan.tiles * bk
    assert hist + C <= kend < hist + C + bk
    assert plan.row_blocks == -(-Hg * C // ops.PAGED_ROWS)
    for n in sorted({plan.splits, 1, plan.tiles, max(1, plan.tiles // 3)}):
        p = ops.prefill_paged_plan(C, hist, G, Hg, dh, window, n)
        assert p._replace(splits=plan.splits) == plan and p.splits == n
        walked = [t for s in range(n)
                  for t in range(s * p.tiles // n, (s + 1) * p.tiles // n)]
        assert walked == list(range(p.tiles))
        assert all((s + 1) * p.tiles // n > s * p.tiles // n
                   for s in range(n))
    with pytest.raises(ValueError):
        ops.prefill_paged_plan(C, hist, G, Hg, dh, window, plan.tiles + 1)


def test_plan_is_a_function_of_host_ints():
    """The plan is cached on its ints: the same ints give the same plan
    object, every field is a Python int (nothing read from a tensor)."""
    a = ops.prefill_paged_plan(32, 4128, 8, 4, 80, 4096)
    assert ops.prefill_paged_plan(32, 4128, 8, 4, 80, 4096) is a
    assert all(type(f) is int for f in a)


def test_plan_fills_the_card_at_h2o_ring_chunk():
    """h2o-danube's last ring chunk (C 32, Hg 4, G 8, dh 80, 4,160 keys):
    one wave of blocks over the SMs, as many as fit."""
    p = ops.prefill_paged_plan(32, 4128, 8, 4, 80, 4096)
    blocks = p.splits * p.row_blocks * 8
    assert p.kbeg == 0 and p.tiles * p.key_tile == 4160
    assert p.row_blocks == 2
    assert ops.SM_COUNT - p.row_blocks * 8 < blocks <= ops.SM_COUNT


@pytest.mark.parametrize("hist", [0, 1, 32, 64])
def test_plan_takes_one_split_at_a_one_tile_history(hist):
    assert ops.prefill_paged_plan(32, hist, 2, 7, 64).splits == 1


def _args(dtype=torch.float32, q8=False, C=8, H=4, G=2, dh=16, P=6, ps=8,
          W=4):
    q = torch.randn(1, C, H, dh, dtype=dtype)
    k, v = torch.randn(C, G, dh, dtype=dtype), torch.randn(C, G, dh,
                                                          dtype=dtype)
    kp, vp = torch.randn(P, ps, G, dh), torch.randn(P, ps, G, dh)
    kw = dict(offset=8, lo=0, page_size=ps)
    if q8:
        (kp, ks), (vp, vs) = L.quantize_kv(kp), L.quantize_kv(vp)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return (q, k, v, kp, vp, torch.arange(W, dtype=torch.int32)), kw


@pytest.mark.parametrize("bad", [
    "lo past offset", "history past the ring", "ring past the row",
    "pool dtype", "int8 without scales", "scales on a float pool",
    "row dtype", "page size", "batch 2", "window 0", "k shape"])
def test_wrapper_refuses(bad):
    (q, k, v, kp, vp, row), kw = _args(q8=bad in ("int8 without scales",))
    if bad == "lo past offset":
        kw["lo"] = 9
    elif bad == "history past the ring":
        kw.update(offset=200, lo=0, ring_len=16)
    elif bad == "ring past the row":
        kw["ring_len"] = 64
    elif bad == "pool dtype":
        kp, vp = kp.double(), vp.double()
    elif bad == "int8 without scales":
        del kw["k_scale"], kw["v_scale"]
    elif bad == "scales on a float pool":
        kw.update(k_scale=torch.ones(kp.shape[:3]),
                  v_scale=torch.ones(kp.shape[:3]))
    elif bad == "row dtype":
        row = row.long()
    elif bad == "page size":
        kw["page_size"] = 4
    elif bad == "batch 2":
        q = q.expand(2, -1, -1, -1).contiguous()
    elif bad == "window 0":
        kw["window"] = 0
    elif bad == "k shape":
        k = k[:, :1].contiguous()
    with pytest.raises((ValueError, TypeError)):
        ops.flash_prefill_paged(q, k, v, kp, vp, row, **kw)


def test_wrapper_refuses_inputs_that_require_grad():
    (q, k, v, kp, vp, row), kw = _args()
    with pytest.raises(ValueError, match="requires grad"):
        ops.flash_prefill_paged(q.requires_grad_(), k, v, kp, vp, row, **kw)


@pytest.mark.parametrize("q8", [False, True])
def test_trace_route_records_the_cost(q8):
    """On meta tensors inside a trace the wrapper records one
    flash_prefill_paged node: 4 dh FLOPs a head and unmasked pair; bytes
    of q, the output, the chunk's K/V and the history rows the queries
    attend (int8 with their scales) and the table entries."""
    (q, k, v, kp, vp, row), kw = _args(dtype=torch.bfloat16, q8=q8, C=8,
                                       H=4, G=2, dh=16, P=12, ps=8, W=10)
    kw.update(offset=40, lo=0, window=20)
    meta = [t.to("meta") for t in (q, k, v, kp, vp, row)]
    if q8:
        kw.update(k_scale=kw["k_scale"].to("meta"),
                  v_scale=kw["v_scale"].to("meta"))
    seen = []
    with cost.tracing(lambda name, c: seen.append((name, c))):
        out = ops.flash_prefill_paged(*meta, **kw)
    assert out.shape == q.shape and out.is_meta
    (name, c), = seen
    assert name == "flash_prefill_paged"
    pairs = cost.unmasked_pairs(8, 40, 48, 20, True)
    assert c.flops == 4.0 * 16 * 4 * pairs and c.peak == "bf16"
    rows = 40 - (40 - 20 + 1)
    row_bytes = 2 * 2 * (16 * (1 if q8 else 2) + (4 if q8 else 0))
    assert c.bytes == (2 * q.numel() * 2 + 2 * 8 * 2 * 16 * 2
                       + rows * row_bytes + min(-(-rows // 8) + 1, 10) * 4)


@pytest.mark.parametrize("arch,over", [
    ("qwen25_0_5b", {}), ("qwen25_0_5b", {"kv_quant": True}),
    ("h2o_danube_1_8b", {})], ids=["dense", "int8", "ring"])
def test_chunk_calls_the_kernel_once_a_layer(arch, over, monkeypatch):
    """`prefill_chunk_paged` attends each layer with one
    flash_prefill_paged call (ints for offset and lo, the pool's layer,
    its scales under int8) and never calls flash_prefill."""
    cfg = dataclasses.replace(get_config(arch).reduced(dtype="float32"),
                              **over)
    lm = DenseLM(cfg, device="cpu")
    ps, ring = 8, cfg.sliding_window or 0
    W = -(-ring // ps) if ring else 12
    pool = init_page_pool(cfg, W + 2, ps, device="cpu")
    calls, wrong = [], []
    real = ops.flash_prefill_paged

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_prefill_paged", spy)
    monkeypatch.setattr(ops, "flash_prefill",
                        lambda *a, **kw: wrong.append(1))
    row = torch.arange(W, dtype=torch.int32)
    offset = 96 if ring else 32
    lm.prefill_chunk_paged(pool, torch.ones(1, 8, dtype=torch.long), row,
                           offset, page_size=ps, ring_len=ring)
    assert len(calls) == cfg.num_layers and not wrong
    for kw in calls:
        assert type(kw["offset"]) is int and type(kw["lo"]) is int
        assert ("k_scale" in kw) == bool(cfg.kv_quant)
        assert kw["window"] == cfg.sliding_window


def test_source_tiles_are_the_wrappers():
    """csrc/flash_prefill_paged.cu's block rows and key tile are
    PAGED_ROWS and PAGED_KEY_TILE."""
    const = {n: int(re.search(rf"^constexpr int {n} = (\d+);", SRC,
                              re.M).group(1)) for n in ("kThreads", "kBK")}
    assert re.search(r"^constexpr int kRows = 16 \* kWarps;", SRC, re.M)
    assert const["kThreads"] // 32 * 16 == ops.PAGED_ROWS
    assert const["kBK"] == ops.PAGED_KEY_TILE
