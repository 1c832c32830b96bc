"""Tensor-parallel serving of the dense family, in one process: the split
rule (`models.model.tp_layout`) at every dense config x tp in {2, 4, 8,
16}; `convert.shard_params` at every dense config's whole shapes (views
of aranges, no storage), its parts re-assembled to the whole; the ranks
of a tp group run as threads over `ThreadGroup` (the no-grad collectives
of `dist.collectives.AxisGroup`, summed in rank order), their prefill,
cache and decode held to the unsplit model, at a tp that splits the
heads and at tps that do not (attention whole on every rank); the
random parts' draws; the paths that refuse a part. The multi-rank cases
against the reference are in tests/torch_mesh_cases.py.

The reference's padded-head grouping at a tp that does not divide the
heads (`layers.pad_heads`, `expand_kv`, then `attention`'s h // (H / G)
groups) pairs query heads with another group's kv head: pinned here
(ROADMAP, differences from the reference that stay); the port keeps such
an attention whole."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import shard_params
from repro_torch.models import model as tm
from repro_torch.models.dense import DenseLM
from repro_torch.serving.engine import ContinuousEngine, Engine

DENSE = [a for a in ARCH_IDS if get_config(a).family == "dense"]
TPS = (2, 4, 8, 16)


class ThreadGroup:
    """`tp` threads of one process as the ranks of a group: `rank(r)` is
    rank r's view, with `size`, `all_reduce` (in place; every rank gets
    the sum in rank order) and `all_gather`."""

    def __init__(self, tp):
        self.size = tp
        self.barrier = threading.Barrier(tp, timeout=60)
        self.slots = [None] * tp

    def rank(self, r):
        return _Rank(self, r)


class _Rank:
    def __init__(self, group, r):
        self.group, self.r, self.size = group, r, group.size

    def _swap(self, t, fn):
        g = self.group
        g.slots[self.r] = t.clone()
        g.barrier.wait()
        out = fn(g.slots)
        g.barrier.wait()                 # every rank has read the slots
        return out

    def all_reduce(self, t):
        def total(slots):
            s = slots[0].clone()
            for x in slots[1:]:
                s += x
            return s
        return t.copy_(self._swap(t, total))

    def all_gather(self, t, dim):
        return self._swap(t, lambda slots: torch.cat(slots, dim))


def run_ranks(tp, fn):
    """[fn(r, rank r's group view) for r < tp], the ranks as threads, on
    one intra-op thread (tp threads of small ops would oversubscribe a
    pool a thread)."""
    group = ThreadGroup(tp)
    out, errors = [None] * tp, []
    threads_before = torch.get_num_threads()
    torch.set_num_threads(1)

    def body(r):
        try:
            out[r] = fn(r, group.rank(r))
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)
            group.barrier.abort()
    threads = [threading.Thread(target=body, args=(r,)) for r in range(tp)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        torch.set_num_threads(threads_before)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


# ------------------------------------------------------------ split rule


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", DENSE)
def test_split_rule(arch, tp):
    """The attention splits exactly when H % tp == 0 and G % tp == 0 or
    tp % G == 0; then the ranks' query heads cover the H heads once, in
    rank order, and each rank's all read its kv heads (kv head floor(r G
    / tp) where tp > G). The FFN and the vocabulary split where tp
    divides d_ff and the padded vocabulary; norms and the vision stub's
    projection stay whole."""
    cfg = get_config(arch)
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    lays = [tm.tp_layout(cfg, tp, r) for r in range(tp)]
    attn = H % tp == 0 and (G % tp == 0 or tp % G == 0)
    assert all(x.attn == attn for x in lays)
    assert all(x.ffn == (cfg.d_ff % tp == 0) for x in lays)
    assert all(x.vocab == (cfg.vocab_padded % tp == 0) for x in lays)
    whole = tm.param_shapes(cfg)
    specs = tm.param_specs(cfg)
    for r, x in enumerate(lays):
        assert set(x.cuts) <= {n for n, a in specs.items() if "tp" in a}
        assert not any("norm" in n or n == "patch_proj" for n in x.cuts)
        if not attn:
            assert (x.heads, x.kv_heads) == (H, G)
            assert not set(x.cuts) & set(tm.Q_SIDE + tm.KV_SIDE)
            continue
        assert x.heads * tp == H and x.q0 == r * x.heads
        groups = {h // (H // G) for h in range(x.q0, x.q0 + x.heads)}
        assert groups == set(range(x.kv0, x.kv0 + x.kv_heads)), (r, groups)
        if tp > G:
            assert x.kv_heads == 1 and x.kv0 == r * G // tp
        assert x.cuts["wq"] == (2, x.q0 * hd, x.heads * hd)
        assert x.cuts["wo"] == (1, x.q0 * hd, x.heads * hd)
        assert x.cuts["wk"] == (2, x.kv0 * hd, x.kv_heads * hd)
        shapes = tm.param_shapes(cfg, x)
        assert shapes["wq"][2] * tp == whole["wq"][2]
    if attn:
        assert sum(x.heads for x in lays) == H


def test_split_rule_examples():
    """qwen2.5's 14 / 2 heads split at tp 2 (one kv head a rank), not at
    4 (attention whole; its FFN of 4,864 and vocabulary of 152,064 still
    split); qwen2-72b's 64 / 8 at tp 4 (2 kv heads a rank, d_ff 7,392,
    a quarter of the vocabulary) and at 16 (kv head g on ranks 2g and 2g
    + 1)."""
    q = get_config("qwen25_0_5b")
    a = tm.tp_layout(q, 2, 1)
    assert (a.attn, a.heads, a.kv_heads, a.kv0) == (True, 7, 1, 1)
    b = tm.tp_layout(q, 4, 3)
    assert (b.attn, b.heads, b.kv_heads, b.ffn, b.vocab) == \
        (False, 14, 2, True, True)
    big = get_config("qwen2_72b")
    c = tm.tp_layout(big, 4, 0)
    assert (c.heads, c.kv_heads) == (16, 2)
    assert tm.param_shapes(big, c)["w1"] == (80, 8192, 7392)
    assert tm.param_shapes(big, c)["lm_head"] == (8192, 152064 // 4)
    assert [tm.tp_layout(big, 16, r).kv0 for r in range(16)] == \
        [r // 2 for r in range(16)]
    with pytest.raises(ValueError):
        tm.tp_layout(big, 4, 4)


def _index_params(shapes, dim_of):
    """Whole-shaped views (stride 0 but along one dimension) whose values
    are their index along dimension dim_of[name] (0 for a whole one)."""
    out = {}
    for n, s in shapes.items():
        d = dim_of.get(n, 0)
        view = [1] * len(s)
        view[d] = s[d]
        out[n] = torch.arange(s[d]).view(view).expand(s)
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_shard_params_reassemble(arch):
    """At every tp of TPS, every rank's `shard_params` part has the
    rank's `param_shapes`, is a view (no copy), and the distinct parts
    of each cut weight, in order along the cut, re-assemble to the whole
    (each index once; ranks that share a part hold the same one); an
    uncut weight is the whole on every rank."""
    cfg = get_config(arch)
    whole = tm.param_shapes(cfg)
    for tp in TPS:
        dims = {n: c[0] for n, c in tm.tp_layout(cfg, tp, 0).cuts.items()}
        params = _index_params(whole, dims)
        parts = {n: {} for n in whole}
        for r in range(tp):
            lay = tm.tp_layout(cfg, tp, r)
            got = shard_params(params, cfg, tp, r)
            assert {n: tuple(t.shape) for n, t in got.items()} == \
                tm.param_shapes(cfg, lay)
            for n, t in got.items():
                assert t.untyped_storage().data_ptr() == \
                    params[n].untyped_storage().data_ptr()
                d = dims.get(n, 0)
                idx = t[tuple(slice(None) if i == d else 0
                              for i in range(t.ndim))]
                parts[n].setdefault(int(idx[0]), idx)
                assert torch.equal(parts[n][int(idx[0])], idx)
        for n, s in whole.items():
            seq = torch.cat([parts[n][k] for k in sorted(parts[n])])
            assert torch.equal(seq, torch.arange(s[dims.get(n, 0)])), n


# ----------------------------------------------------- the ranks' model


def _whole_and_prompt(arch, S=21, **over):
    cfg = get_config(arch).reduced(dtype="float32", **over)
    whole = DenseLM(cfg, device="cpu", seed=0)
    toks = torch.tensor(np.random.default_rng(0).integers(
        4, 500, (2, S)), dtype=torch.long)
    return cfg, whole, toks


def _serve(lm, toks, steps=3):
    """(prefill logits, its cache, the logits of `steps` decode steps of
    fixed tokens over the cache grown by `steps` slots)."""
    logits, cache = lm.prefill(toks)
    first = {n: t.clone() for n, t in cache.items()}
    if not lm.cfg.sliding_window:
        cache = {n: torch.cat([t, t.new_zeros(t.shape[:2] + (steps,)
                                              + t.shape[3:])], 2)
                 for n, t in cache.items()}
    S = toks.shape[1]
    out = [lm.decode_step(cache, toks[:, i:i + 1], S + i)
           for i in range(steps)]
    return logits, first, out


@pytest.mark.parametrize("arch,tp", [
    ("qwen25_0_5b", 2), ("qwen25_0_5b", 4), ("qwen25_0_5b", 8),
    ("qwen25_0_5b", 3), ("h2o_danube_1_8b", 4)],
    ids=["heads-2", "kv-replicated-4", "whole-attention-8", "all-whole-3",
         "h2o-ring-4"])
def test_parts_equal_unsplit_model(arch, tp):
    """The tp ranks' parts of the reduced f32 model (H 4, G 2), given the
    whole weights, run together: every rank's prefill logits and decode
    logits within 1e-5 of the unsplit model's, its cache planes the
    unsplit cache's kv heads (`kv0`...). At tp 8 the heads do not split
    (attention whole on every rank, the FFN and vocabulary split); at
    tp 3 nothing divides, and every rank computes the unsplit model's
    outputs bit for bit. h2o's 80 positions wrap its 64-slot ring."""
    S = 80 if arch == "h2o_danube_1_8b" else 21
    cfg, whole, toks = _whole_and_prompt(arch, S)
    want = _serve(whole, toks)
    params = dict(whole.named_parameters())

    def rank(r, group):
        lm = DenseLM(cfg, device="cpu", params=params, shard=(tp, r),
                     group=group)
        return lm.tp, _serve(lm, toks)
    for lay, (logits, cache, steps) in run_ranks(tp, rank):
        exact = not (lay.attn or lay.ffn or lay.vocab)
        assert exact == (tp == 3) and lay.attn == (tp in (2, 4))
        pairs = [(logits, want[0])] + list(zip(steps, want[2]))
        for got, w in pairs:
            if exact:
                assert torch.equal(got, w)
            else:
                torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)
        for n, t in cache.items():
            w = want[1][n].narrow(3, lay.kv0, lay.kv_heads)
            torch.testing.assert_close(t, w, rtol=1e-5, atol=1e-5)


def test_wave_engine_on_parts():
    """The wave Engine over each rank's part gives the unsplit model's
    greedy tokens on every rank (int8 KV, tp 4: kv heads replicated)."""
    cfg, whole, _ = _whole_and_prompt("qwen25_0_5b", kv_quant=True)
    prompts = [np.random.default_rng(i).integers(4, 500, n).astype(np.int32)
               for i, n in enumerate((21, 21, 9))]
    want = [r.tokens for r in Engine(whole, max_len=48).generate(
        prompts, max_new=6, continuous=False)]
    params = dict(whole.named_parameters())

    def rank(r, group):
        lm = DenseLM(cfg, device="cpu", params=params, shard=(4, r),
                     group=group)
        return [x.tokens for x in Engine(lm, max_len=48).generate(
            prompts, max_new=6)]            # a part routes to the waves
    assert run_ranks(4, rank) == [want] * 4


class _Solo:
    """A group of one rank: a part of tp is one rank's share of the work
    (its collectives the identity)."""
    size = 1

    def all_reduce(self, t):
        return t

    def all_gather(self, t, dim):
        return t


def test_random_parts():
    """Random parts drawn from (seed, name, the part's index): ranks 0
    and 1 of tp 4 share kv head 0 (their wk, wv equal), hold other query
    heads, FFN columns and vocabulary rows (different draws), the same
    norms; a share's logits cover its quarter of the vocabulary."""
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    a, b = (DenseLM(cfg, device="cpu", seed=3, shard=(4, r), group=_Solo())
            for r in (0, 1))
    assert torch.equal(a.wk, b.wk) and torch.equal(a.bk, b.bk)
    for n in ("wq", "wo", "w1", "w2", "tok_embed"):
        assert not torch.equal(getattr(a, n), getattr(b, n)), n
    assert torch.equal(a.attn_norm, b.attn_norm)
    assert torch.equal(a.wq, DenseLM(cfg, device="cpu", seed=3, shard=(4, 0),
                                     group=_Solo()).wq)
    logits, cache = a.prefill(torch.randint(0, 128, (2, 9)))
    assert logits.shape == (2, cfg.vocab_padded // 4)
    assert cache["k"].shape == (cfg.num_layers, 2, 9, 1, 32)


def test_parts_refuse_one_device_paths():
    """The continuous engine, training and a part without a group
    refuse; a MoE model serves whole."""
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    part = DenseLM(cfg, device="cpu", shard=(2, 0), group=_Solo())
    with pytest.raises(ValueError, match="one device"):
        ContinuousEngine(part)
    with pytest.raises(NotImplementedError, match="training"):
        part.forward_logits(torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="group"):
        DenseLM(cfg, device="cpu", shard=(2, 0))
    with pytest.raises(ValueError, match="ranks"):
        DenseLM(cfg, device="cpu", shard=(2, 0), group=ThreadGroup(4))
    moe = get_config("granite_moe_1b_a400m").reduced(dtype="float32")
    with pytest.raises(ValueError, match="serves one device"):
        tm.build_model(moe, device="cpu", shard=(2, 0), group=_Solo())


# ------------------------------------------ the reference's padded heads


def test_reference_padded_heads_misgroup():
    """qwen2.5's 14 query heads over 2 kv heads at tp 4 in the
    reference: `pad_heads` pads q to 16 heads, `expand_kv` repeats each
    kv head twice ([kv0, kv0, kv1, kv1]), and `attention` groups head h
    with expanded head h // 4. So q7 (of kv head 1: 7 // 7) reads a copy
    of kv0: its output is q7's attention over kv0, not over kv1, the
    unpadded attention's; q0-q6 and q8-q13 keep their groups. The port
    keeps this attention whole at tp 4 (`tp_layout`)."""
    rng = np.random.default_rng(0)
    B, S, H, G, dh, tp = 1, 8, 14, 2, 16, 4
    q = jnp.asarray(rng.standard_normal((B, S, H, dh)), jnp.float32)
    k, v = (jnp.asarray(rng.standard_normal((B, S, G, dh)), jnp.float32)
            for _ in range(2))
    qp, h = JL.pad_heads(q, tp)
    ke, ve = JL.expand_kv(k, tp), JL.expand_kv(v, tp)
    assert (qp.shape[2], h, ke.shape[2]) == (16, 14, 4)
    padded = np.asarray(JL.attention(qp, ke, ve, causal=True))[:, :, :h]
    right = np.asarray(JL.attention(q, k, v, causal=True))
    wrong = [h_ for h_ in range(H) if not np.allclose(
        padded[:, :, h_], right[:, :, h_], rtol=1e-5, atol=1e-6)]
    assert wrong == [7]
    on_kv0 = np.asarray(JL.attention(q[:, :, 7:8], k[:, :, :1], v[:, :, :1],
                                     causal=True))[:, :, 0]
    np.testing.assert_allclose(padded[:, :, 7], on_kv0, rtol=1e-5,
                               atol=1e-6)
    assert not tm.tp_layout(get_config("qwen25_0_5b"), tp, 0).attn
