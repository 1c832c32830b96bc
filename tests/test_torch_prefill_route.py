"""flash_prefill's routes and the wgmma route's tile plans, on the CPU:
`ops.prefill_route` for every (dtype, dh), `ops.flash_prefill_launch`'s
refusal of a forced route or plan that the dtype or dh cannot take,
`ops.prefill_plan` per dh (the plans that csrc/flash_prefill_sm90.cu
compiles, their shared memory within the card's with dh 80's rows
padded to 128 columns, the pick by shape), and
`dense.chunk_rows` rounding a ring chunk's first key to the key tile of
the route that `flash_prefill_paged` takes at the model's dtype and dh
(`ops.prefill_paged_key_tile`). The kernels themselves run on the
card only: chip_smoke.py holds every route against the plain version
there."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import dense
from repro_torch.models.dense import DenseLM, chunk_rows

SM90 = (Path(ops.__file__).parent / "csrc" / "flash_prefill_sm90.cu"
        ).read_text()
SMEM_BLOCK = 232448        # dynamic shared memory a block may take
SMEM_SM = 233472           # shared memory of an SM (228 KB)


@pytest.mark.parametrize("dh", ops.FLASH_PREFILL_DH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_route(dtype, dh):
    want = ("cuda" if dtype is torch.float32
            else "wgmma" if dh in (64, 80, 128, 256) else "tc")
    assert ops.prefill_route(dtype, dh) == want


def _qkv(dtype, dh, sq=8, sk=8):
    return (torch.zeros(1, sq, 4, dh, dtype=dtype),
            torch.zeros(1, sk, 2, dh, dtype=dtype),
            torch.zeros(1, sk, 2, dh, dtype=dtype))


@pytest.mark.parametrize("dtype,dh,route,plan", [
    (torch.float32, 64, "tc", None),
    (torch.float32, 64, "wgmma", None),
    (torch.bfloat16, 64, "cuda", None),
    (torch.bfloat16, 80, "wgmma", (128, 2, 1, 2)),
    (torch.bfloat16, 32, "wgmma", None),
    (torch.bfloat16, 256, "wgmma", (128, 2, 1, 1)),
    (torch.bfloat16, 64, "tc", (128, 2, 1, 2)),
    (torch.bfloat16, 64, "wgmma", (128, 2, 2, 2)),
    (torch.bfloat16, 128, "wgmma", (128, 2, 1, 2)),
    (torch.bfloat16, 64, "mma", None),
], ids=["f32 on tc", "f32 on wgmma", "bf16 on cuda", "dh 80 on wgmma",
        "dh 32 on wgmma", "dh 256 on wgmma", "a plan on tc",
        "a plan not compiled", "dh 128 at dh 64's plan", "no such route"])
def test_launch_refuses_what_the_route_cannot_take(dtype, dh, route, plan):
    """Refused before any launch: a route the dtype does not take, dh 32
    on wgmma, a plan on tc, and a plan not compiled at its dh (dh 80 at dh
    64's long plan, dh 256 at dh 128's narrow one)."""
    with pytest.raises(ValueError, match="not taken"):
        ops.flash_prefill_launch(*_qkv(dtype, dh), route=route, plan=plan)


def test_compiled_plans_are_the_wrappers():
    """The source's FLASH_WGMMA_PLAN lines are PREFILL_PLANS, and its
    producer keeps the registers the plans' sums assume."""
    compiled = {}
    for d, k, s, c, n in re.findall(
            r"^  FLASH_WGMMA_PLAN\((\d+), (\d+), (\d+), (\d+), (\d+)\)$",
            SM90, re.M):
        compiled.setdefault(int(d), set()).add((int(k), int(s), int(c),
                                                int(n)))
    assert compiled == {dh: set(p) for dh, p in ops.PREFILL_PLANS.items()}
    assert re.search(r"^constexpr int kProducerRegs = 24;", SM90, re.M)
    assert "SMEM = 1024 + Q_BYTES + 2 * ST * KV_BYTES + 256;" in SM90


def _consumer_regs(consumers, per_sm):
    """`Plan::CONSUMER_REGS`: the launch's registers a thread, plus what
    the producer's drop to 24 frees, at most 240."""
    launch = 65536 // (128 * (consumers + 1) * per_sm) // 8 * 8
    return min(240, (launch + (launch - 24) // consumers) // 8 * 8)


@pytest.mark.parametrize("dh", ops.PREFILL_WGMMA_DH)
def test_plans_fit_the_card(dh):
    """Every plan at dh: keys a multiple of wgmma's k-step and its N,
    64 rows a consumer, shared memory (rows padded to the 64-column
    atoms) within a block's and its blocks' within an SM's, and
    registers for S, P and O (f32 keys / 2, bf16 keys / 4 and f32 dh / 2
    a thread) with room to spare."""
    for plan in ops.PREFILL_PLANS[dh]:
        p = ops.prefill_plan(dh, plan=plan)
        keys, stages, consumers, per_sm = plan
        assert (p["keys"], p["stages"], p["consumers"],
                p["blocks_per_sm"]) == plan
        assert keys % 16 == 0 and keys <= 256 and stages >= 1
        assert consumers in (1, 2) and p["rows"] == 64 * consumers
        dhp = -(-dh // 64) * 64
        assert p["smem"] == (1024 + (p["rows"] + 2 * stages * keys) * dhp * 2
                             + 256)
        assert p["smem"] <= SMEM_BLOCK
        assert per_sm * (p["smem"] + 1024) <= SMEM_SM
        assert keys // 2 + keys // 4 + dh // 2 + 24 <= _consumer_regs(
            consumers, per_sm)


@pytest.mark.parametrize("plan", ops.PREFILL_PLANS[80])
def test_dh80_shared_memory_counts_the_padded_columns(plan):
    """dh 80's 160-byte rows sit in 128 columns of shared memory (TMA's
    zero fill pads them): each of its plans takes the bytes of dh 128's
    rows at the same tiles, more than 160-byte rows would, and its
    blocks still fit an SM."""
    keys, stages, consumers, per_sm = plan
    p = ops.prefill_plan(80, plan=plan)
    rows = 64 * consumers + 2 * stages * keys
    assert p["smem"] == 1024 + rows * 128 * 2 + 256
    assert p["smem"] == ops._plan_info(128, plan)["smem"]
    assert p["smem"] > 1024 + rows * 80 * 2 + 256
    assert per_sm * (p["smem"] + 1024) <= SMEM_SM
    assert ops.prefill_plan(80)["smem"] == 165120      # the long plan


@pytest.mark.parametrize("dh", ops.PREFILL_WGMMA_DH)
def test_plan_picked_by_shape_keeps_the_key_tile(dh):
    """The wrapper's pick: the short plan at <= 64 keys, the narrow plan
    (one consumer) where the long plan's grid leaves SMs idle, else the
    long plan; every pick's keys are the long plan's key tile, or all
    keys fall in one tile (so each gives the long plan's sums)."""
    long_ = ops.prefill_plan(dh)
    tile = ops.PREFILL_PLANS[dh][0][0]
    assert long_["keys"] == tile
    for sq, sk, blocks in ((32768, 32768, 28), (32, 96, 14), (64, 64, 1536),
                           (1, 50, 14), (320, 320, 24), (8192, 8192, 24),
                           (1500, 1500, 24), (32, 1500, 24), (77, 64, 8)):
        p = ops.prefill_plan(dh, sq, sk, blocks)
        assert p["keys"] == tile or sk <= p["keys"]
        if sk <= ops.PREFILL_SHORT:
            assert (p["keys"], p["consumers"]) == (ops.PREFILL_SHORT, 1)
        elif blocks * -(-sq // long_["rows"]) < ops.SM_COUNT:
            assert (p["keys"], p["consumers"]) == (tile, 1)
        else:
            assert p == long_


@pytest.mark.parametrize("dtype,dh", [
    (torch.bfloat16, 64), (torch.bfloat16, 128), (torch.bfloat16, 80),
    (torch.float32, 64)])
@pytest.mark.parametrize("offset,ring_len", [
    (0, 64), (96, 64), (160, 64), (288, 96), (4160, 4096), (200, 0)])
def test_chunk_rows_rounds_to_the_routes_key_tile(dtype, dh, offset,
                                                  ring_len):
    """A 32-token chunk's history starts on the key tile of the
    flash_prefill_paged route that (dtype, dh) takes, at or before
    offset - ring: the chunk's keys fall into the kernel's tiles at
    absolute positions (in f32 the wave's full prefill's tiles)."""
    ps, c = 8, 32
    W = (ring_len or 256) // ps
    row = torch.arange(W, dtype=torch.int32)
    tile = ops.prefill_paged_key_tile(dtype, dh)
    assert tile % (ops.PAGED_KEY_TILE if dtype is torch.bfloat16 else 32) == 0
    lo, _ = chunk_rows(row, offset, c, offset + c, ps, ring_len, tile=tile)
    ring = ring_len or W * ps
    assert lo % tile == 0
    assert lo <= max(0, offset - ring) < lo + tile
    assert ref.history_rows(row, lo, offset, ps, ring).numel() == offset - lo


def test_chunked_prefill_passes_its_routes_key_tile(monkeypatch):
    """`prefill_chunk_paged` rounds to the key tile of the
    flash_prefill_paged route that the model's compute dtype and head dim
    take (`ops.prefill_paged_key_tile`)."""
    cfg = get_config("h2o_danube_1_8b").reduced()
    lm = DenseLM(cfg, device="cpu")
    asked, seen = [], {}

    def key_tile(dtype, dh):
        asked.append((dtype, dh))
        return 4096

    def spy(*args, **kw):
        seen.update(kw)
        raise StopIteration
    monkeypatch.setattr(ops, "prefill_paged_key_tile", key_tile)
    monkeypatch.setattr(dense, "chunk_rows", spy)
    with pytest.raises(StopIteration):
        lm.prefill_chunk_paged({}, torch.zeros((1, 4), dtype=torch.long),
                               torch.zeros(4, dtype=torch.int32), 0,
                               page_size=8, ring_len=64)
    assert asked == [(cfg.torch_dtype, cfg.resolved_head_dim)]
    assert seen == {"tile": 4096}
