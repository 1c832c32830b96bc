"""The port's continuous engine across the model zoo against the JAX
package on the CPU (tests/test_paged_families.py's contract), on float32
reduced configs with the same converted params: the port's wave and
continuous greedy tokens equal to the reference `Engine`'s for
sliding-window (ring pages), int8-KV, MoE and sliding-window + int8
configs; the ring wraparound with one slot past the window beside one
inside it, with the reference's `ring_len` and `table_width`;
`supports_paged` equal to the reference's; routing by `continuous=None`,
the refusal of unsupported configs, and sampled MoE tokens equal to the
reference's."""
import dataclasses
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jmodel
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels import ops, ref
from repro_torch.models.dense import chunk_rows
from repro_torch.models.model import build_model, supports_paged
from repro_torch.models.moe import MoELM
from repro_torch.serving.engine import ContinuousEngine, Engine

ARCH = {"swa": "h2o_danube_1_8b", "int8": "qwen25_0_5b",
        "moe": "granite_moe_1b_a400m", "swa_int8": "h2o_danube_1_8b"}


def _cfgs(kind):
    """(reference config, port config), reduced, float32."""
    over = dict(dtype="float32", kv_quant="int8" in kind)
    return (j_get_config(ARCH[kind]).reduced(**over),
            get_config(ARCH[kind]).reduced(**over))


def _models(kind, seed):
    jcfg, cfg = _cfgs(kind)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, build_model(cfg, device="cpu", params=params)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, 500, n).astype(np.int32) for n in lens]


def _same(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.tokens == w.tokens, f"{what}: request {i} diverged"
        assert g.prompt_len == w.prompt_len


@pytest.mark.parametrize("kind", ["swa", "int8", "moe", "swa_int8"])
def test_paged_and_wave_match_reference(kind):
    """Mixed lengths over 2 slots (admission churn, chunked prefill): the
    port's wave and continuous tokens equal the reference's, which equal
    each other."""
    jcfg, jparams, cfg, lm = _models(kind, 0)
    prompts = _prompts(7, (16, 24, 33, 40, 9))
    ref = JEngine(jcfg, jparams, max_len=96, slots=2)
    want = ref.generate(prompts, max_new=6, continuous=False)
    _same(ref.generate(prompts, max_new=6, continuous=True), want,
          f"{kind} reference continuous")
    eng = Engine(lm, max_len=96, slots=2)
    _same(eng.generate(prompts, max_new=6, continuous=False), want,
          f"{kind} wave")
    cont = eng.generate(prompts, max_new=6, continuous=True)
    _same(cont, want, f"{kind} continuous")
    assert all(c.prefill_s > 0 for c in cont)
    ce = eng.continuous(2)
    assert ce.steps > 0
    assert set(ce.cache) == ({"k", "v", "k_s", "v_s"} if cfg.kv_quant
                             else {"k", "v"})


@pytest.mark.parametrize("kind", ["swa", "swa_int8"])
def test_ring_wraparound_mixed_slots(kind):
    """One slot's kv_len passes the 64-position window (an 80-token
    prompt) beside one that stays inside it: both equal the reference's
    tokens on both paths, and each slot's ring maps ceil(64 / ps) pages,
    as the reference's engine does."""
    jcfg, jparams, cfg, lm = _models(kind, 1)
    assert cfg.sliding_window == jcfg.sliding_window == 64
    prompts = _prompts(11, (80, 20))
    ref = JEngine(jcfg, jparams, max_len=96, slots=2)
    want = ref.generate(prompts, max_new=8, continuous=False)
    eng = Engine(lm, max_len=96, slots=2)
    _same(eng.generate(prompts, max_new=8, continuous=True), want,
          f"{kind} continuous across the wrap")
    _same(eng.generate(prompts, max_new=8, continuous=False), want,
          f"{kind} wave across the wrap")
    ce, jce = eng.continuous(2), ref.continuous(2)
    _same(jce.generate(prompts, max_new=8), want, "reference continuous")
    assert (ce.ring_len, ce.table_width, ce.abs_len, ce.num_pages) == (
        jce.ring_len, jce.table_width, jce.abs_len, jce.num_pages)
    assert ce.ring_len == 64 and ce.table_width == -(-64 // ce.page_size)
    assert ce.prefix is None
    for name, t in ce.cache.items():
        assert tuple(t.shape) == tuple(jce.cache[name].shape), name


def test_ring_len_not_a_page_multiple():
    """A 64-position ring over 24-position pages: the last of its 3 pages
    is filled to 16 and the kernel masks by kv_len, never by W * ps."""
    jcfg, jparams, cfg, lm = _models("swa", 2)
    prompts = _prompts(13, (80, 20, 41))
    want = JEngine(jcfg, jparams, max_len=96, slots=2,
                   page_size=24).generate(prompts, max_new=8,
                                          continuous=True)
    eng = Engine(lm, max_len=96, slots=2, page_size=24)
    _same(eng.generate(prompts, max_new=8), want, "ring over 24-position "
          "pages")
    ce = eng.continuous()
    assert ce.ring_len == 64 and ce.table_width == 3


@pytest.mark.parametrize("offset,limit,ring_len", [
    (0, 5, 64), (32, 64, 64), (96, 128, 64), (160, 170, 64), (288, 320, 96),
    (64, 80, 0), (160, 176, 0)],
    ids=["ring first chunk", "ring fills", "ring wraps", "ring ragged",
         "ring 96 past a tile", "row", "row ragged past the table"])
def test_chunk_rows(offset, limit, ring_len):
    """A 32-token chunk's history starts on a key tile at or before
    offset - ring (so it holds every query's window), runs in position
    order through each position's cursor (p % ring_len, or p without a
    ring) up to offset, and only real tokens inside the row are
    written."""
    ps, W, c = 8, (ring_len or 168) // 8, 32
    row = torch.randperm(64)[:W].to(torch.int32)
    lo, (pg, off) = chunk_rows(row, offset, c, limit, ps, ring_len,
                               tile=ops.FLASH_KEY_TILE)
    ring = ring_len or W * ps
    gather = ref.history_rows(row, lo, offset, ps, ring)
    assert lo % ops.FLASH_KEY_TILE == 0
    assert lo <= max(0, offset - ring) < lo + ops.FLASH_KEY_TILE
    cur = torch.arange(lo, offset) % ring
    assert torch.equal(gather, row.long()[cur // ps] * ps + cur % ps)
    end = min(offset + c, limit if ring_len else min(limit, W * ps))
    cur = torch.arange(offset, max(offset, end)) % ring
    assert torch.equal(pg, row.long()[cur // ps])
    assert torch.equal(off, cur % ps)


def test_flash_key_tile_is_the_kernels():
    csrc = Path(ops.__file__).parent / "csrc"
    src = "".join((csrc / name).read_text() for name in (
        "flash_prefill.cu", "prefill_f32.cuh"))
    tile = {name: int(re.search(rf"^constexpr int {name} = (\d+);", src,
                                re.M).group(1)) for name in ("kBK", "kTK")}
    assert tile["kBK"] == ops.FLASH_KEY_TILE
    assert ops.FLASH_KEY_TILE % tile["kTK"] == 0


def test_supports_paged_matches_reference():
    """Over the port's configs, full size and reduced, with and without
    a window and int8 KV: the port's answer is the reference's, and
    moe+int8 / moe+swa are the excluded combos."""
    seen = 0
    for arch in ARCH_IDS:
        for size in ("full", "reduced"):
            jc, tc = j_get_config(arch), get_config(arch)
            if size == "reduced":
                jc, tc = jc.reduced(), tc.reduced()
            for over in ({}, {"kv_quant": True}, {"sliding_window": 64},
                         {"kv_quant": True, "sliding_window": 64}):
                j = dataclasses.replace(jc, **over)
                t = dataclasses.replace(tc, **over)
                assert supports_paged(t) == jmodel.supports_paged(j), \
                    (arch, size, over)
                seen += 1
    assert seen == 8 * len(ARCH_IDS)
    moe = get_config("granite_moe_1b_a400m")
    assert supports_paged(moe)
    assert not supports_paged(dataclasses.replace(moe, kv_quant=True))
    assert not supports_paged(dataclasses.replace(moe, sliding_window=64))


def test_unsupported_combos_raise():
    """MoELM refuses a window or int8 KV (the reference's MoE wave path
    defines neither); the continuous engine refuses any config
    `supports_paged` excludes; a sampled MoE request draws the
    reference's tokens."""
    moe = get_config("granite_moe_1b_a400m").reduced(dtype="float32")
    for over in ({"kv_quant": True}, {"sliding_window": 64}):
        bad = dataclasses.replace(moe, **over)
        with pytest.raises(ValueError):
            MoELM(bad, device="cpu")
        with pytest.raises(ValueError, match="slot-paged"):
            ContinuousEngine(SimpleNamespace(cfg=bad,
                                             device=torch.device("cpu")))
    with pytest.raises(ValueError):
        build_model(dataclasses.replace(moe, family="mamba2"), device="cpu")
    # a sampled MoE request runs, and draws the reference's tokens
    jcfg, jparams, _, lm = _models("moe", 0)
    prompts = _prompts(5, (14, 14, 22))
    want = JEngine(jcfg, jparams, max_len=64).continuous().generate(
        prompts, max_new=6, greedy=False, seed=3)
    got = Engine(lm, max_len=64).continuous().generate(
        prompts, max_new=6, greedy=False, seed=3)
    _same(got, want, "moe sampled")


def test_moe_tokens_independent_of_coresidents():
    """Serving MoE never drops a token: the same request gives the same
    tokens beside three co-residents of different content (capacity T,
    each row's experts its own)."""
    _, _, cfg, lm = _models("moe", 2)
    target = _prompts(9, (18,))[0]

    def run(co_seed):
        ce = ContinuousEngine(lm, slots=4, max_len=96)
        tid = ce.submit(target, max_new=6, rid=50)
        r2 = np.random.default_rng(co_seed)
        for i in range(3):
            ce.submit(r2.integers(4, 500, 16 + 8 * i).astype(np.int32),
                      max_new=6, rid=i)
        res = {}
        while ce.pending:
            for ev in ce.step():
                if ev.kind == "done":
                    res[ev.rid] = ev.result.tokens
        return res[tid]

    assert run(1) == run(2) == run(3)
