"""flash_prefill_paged's routes on the CPU: `ops.prefill_paged_route` for
every (dtype, dh), `ops.flash_prefill_paged_launch`'s refusal of a forced
route that the dtype or dh cannot take, the plan that both bf16 routes
walk (`ops.prefill_paged_plan`) at the wgmma route's path shapes, the
wgmma source's rows, key tile and head dims against the wrapper's, the
launch counts by route, and the ctypes signatures of every C entry point
against the parameter lists in the sources. The kernels themselves run
on the card only: chip_smoke.py holds both bf16 routes against the plain
version there."""
import ctypes
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build, ops

CSRC = Path(ops.__file__).parent / "csrc"
SM90 = (CSRC / "flash_prefill_paged_sm90.cu").read_text()


@pytest.mark.parametrize("dh", ops.FLASH_PREFILL_DH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_paged_route(dtype, dh):
    want = ("cuda" if dtype is torch.float32
            else "wgmma" if dh in (64, 80, 128) else "tc")
    assert ops.prefill_paged_route(dtype, dh) == want


def _chunk(dtype, dh, C=8, H=4, G=2, P=6, ps=8, W=4):
    q = torch.zeros(1, C, H, dh, dtype=dtype)
    k, v = torch.zeros(C, G, dh, dtype=dtype), torch.zeros(C, G, dh,
                                                          dtype=dtype)
    kp, vp = torch.zeros(P, ps, G, dh, dtype=dtype), torch.zeros(
        P, ps, G, dh, dtype=dtype)
    return (q, k, v, kp, vp, torch.arange(W, dtype=torch.int32)), dict(
        offset=8, lo=0, page_size=ps)


@pytest.mark.parametrize("dtype,dh,route,splits", [
    (torch.float32, 64, "tc", None),
    (torch.float32, 64, "wgmma", None),
    (torch.bfloat16, 64, "cuda", None),
    (torch.bfloat16, 32, "wgmma", None),
    (torch.bfloat16, 256, "wgmma", None),
    (torch.bfloat16, 64, "mma", None),
    (torch.float32, 64, "cuda", 2),
], ids=["f32 on tc", "f32 on wgmma", "bf16 on cuda", "dh 32 on wgmma",
        "dh 256 on wgmma", "no such route", "f32 at 2 splits"])
def test_launch_refuses_what_the_route_cannot_take(dtype, dh, route, splits):
    args, kw = _chunk(dtype, dh)
    with pytest.raises(ValueError, match="route|split"):
        ops.flash_prefill_paged_launch(*args, route=route, splits=splits,
                                       **kw)


# the wgmma route's path shapes and edges: (C, hist, G, Hg, dh, window)
WGMMA_SHAPES = [
    (32, 64, 2, 7, 64, None),          # the main path's chunk
    (32, 0, 2, 7, 64, None),           # at a history of 0
    (32, 4128, 8, 4, 80, 4096),        # h2o's last ring chunk
    (32, 64, 8, 2, 64, None),          # the MoE chunk
    (32, 64, 8, 6, 128, None),         # the nemotron chunk
    (1, 257, 2, 7, 64, None),          # C 1
    (77, 130, 1, 12, 128, None),       # C 77, Hg 12
    (32, 72, 2, 4, 128, 60),           # a ring of 60 that wraps in an atom
    (32, 120, 2, 4, 80, None),         # pages of 4 positions
]


@pytest.mark.parametrize("C,hist,G,Hg,dh,window", WGMMA_SHAPES)
def test_wgmma_plan_covers_every_key_tile_once(C, hist, G, Hg, dh, window):
    """At the wgmma route's shapes the plan is a function of host ints
    (cached: the same ints give the same object, every field an int), its
    tiles are the source's kBK keys from the first query's window (rounded
    down to a tile) to past the last key, its row blocks the source's
    kRows rows of the group's Hg * C, and its splits take each tile once
    (split s: tiles [s * tiles // splits, (s + 1) * tiles // splits)),
    forced counts alike; its blocks fill at most one wave of the SMs
    (the kernel runs one block an SM)."""
    assert ops.prefill_paged_route(torch.bfloat16, dh) == "wgmma"
    rows = int(re.search(r"^constexpr int kRows = (\d+);", SM90, re.M)[1])
    tile = int(re.search(r"^constexpr int kBK = (\d+);", SM90, re.M)[1])
    plan = ops.prefill_paged_plan(C, hist, G, Hg, dh, window)
    assert plan.key_tile == tile and plan.row_blocks == -(-Hg * C // rows)
    first = max(0, hist - window + 1) if window else 0
    assert plan.kbeg % tile == 0 and plan.kbeg <= first < plan.kbeg + tile
    assert ops.prefill_paged_plan(C, hist, G, Hg, dh, window) is plan
    assert all(type(f) is int for f in plan)
    assert hist + C <= plan.kbeg + plan.tiles * tile < hist + C + tile
    assert plan.splits * plan.row_blocks * G <= ops.SM_COUNT or \
        plan.splits == 1
    for n in sorted({plan.splits, 1, plan.tiles}):
        p = ops.prefill_paged_plan(C, hist, G, Hg, dh, window, n)
        walked = [t for s in range(n)
                  for t in range(s * p.tiles // n, (s + 1) * p.tiles // n)]
        assert walked == list(range(p.tiles))
        assert all((s + 1) * p.tiles // n > s * p.tiles // n
                   for s in range(n))


def test_wgmma_source_is_the_wrappers():
    """csrc/flash_prefill_paged_sm90.cu: 64 rows a block (one consumer
    warpgroup's wgmma M) and key tiles of PAGED_KEY_TILE, a producer and a
    consumer warpgroup, and the head dims it compiles are PAGED_WGMMA_DH."""
    const = {n: int(re.search(rf"^constexpr int {n} = (\d+);", SM90,
                              re.M)[1])
             for n in ("kRows", "kBK", "kThreads", "kStages")}
    assert const["kRows"] == ops.PAGED_ROWS == 64
    assert const["kBK"] == ops.PAGED_KEY_TILE
    assert const["kThreads"] == 2 * 128
    assert const["kStages"] >= 2
    compiled = re.search(r"^    (PAGED_WGMMA\(\d+\)[ A-Z_()\d]*)$", SM90,
                         re.M)[1]
    assert tuple(int(d) for d in re.findall(r"\((\d+)\)", compiled)) == \
        ops.PAGED_WGMMA_DH


def test_launch_counts_by_route_reset():
    ops.flash_prefill_paged.routes["wgmma"] = 3
    ops.reset_launch_counts()
    assert ops.flash_prefill_paged.routes == dict.fromkeys(ops.PAGED_ROUTES,
                                                           0)
    assert set(ops.PAGED_ROUTES) == {"cuda", "tc", "wgmma"}


_CTYPE = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
          "int": ctypes.c_int, "float": ctypes.c_float}


def _c_params(lib: str, fn: str):
    """The ctypes types of the parameters of `extern "C" int fn(...)` in
    csrc/<lib>.cu."""
    src = (CSRC / f"{lib}.cu").read_text()
    m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)
    assert m, f"{fn} not in {lib}.cu"
    out = []
    for p in m[1].split(","):
        words = " ".join(p.split()).rsplit(" ", 1)[0].replace(" *", "*")
        out.append(_CTYPE[words])
    return out


@pytest.mark.parametrize("lib,fn", [(lib, fn) for lib, fns in
                                    build.SIGNATURES.items() for fn in fns])
def test_signatures_are_the_sources(lib, fn):
    """Every C entry point's ctypes argument types (`build.SIGNATURES`)
    are its parameters in the source, one for one: a missing or extra
    argument would shift every argument after it."""
    assert build.SIGNATURES[lib][fn] == _c_params(lib, fn)


def test_signatures_hold_the_wgmma_route():
    assert set(build.SIGNATURES["flash_prefill_paged_sm90"]) == {
        "flash_prefill_paged_wgmma", "flash_prefill_paged_wgmma_maps"}
    paged = build.SIGNATURES["flash_prefill_paged"]["flash_prefill_paged_bf16"]
    wgmma = build.SIGNATURES["flash_prefill_paged_sm90"][
        "flash_prefill_paged_wgmma"]
    # the tc entry's arguments and the pool's page count after the scale
    assert wgmma == paged[:18] + [ctypes.c_int] + paged[18:]


def test_trace_tool_imports_the_port_alone():
    """tools/paged_trace.py imports (no card needed) without JAX or the
    reference package, and its patch finds every source line it stamps."""
    import subprocess
    import sys
    root = Path(__file__).resolve().parents[1]
    code = (f"import sys; sys.path[:0] = [{str(root / 'src')!r}, "
            f"{str(root / 'tools')!r}]\n"
            "import paged_trace as pt\n"
            "from repro_torch.kernels import build\n"
            "src = (build.CSRC / 'flash_prefill_paged_sm90.cu').read_text()\n"
            "pt.patch(src, pt.KERNEL_STAMPS)\n"
            "hdr = (build.CSRC / 'prefill_paged.cuh').read_text()\n"
            "pt.patch(hdr, pt.MERGE_STAMPS)\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               or m == 'repro' for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
