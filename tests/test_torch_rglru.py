"""The port's RG-LRU family (recurrentgemma-9b) against the JAX package
on the CPU, on the float32 reduced config with 5 layers (one stacked
"rra" block and two recurrent tail layers; the default reduced config's
2 layers hold no attention), local window 64, with converted params: the
doubling scan against `lax.associative_scan` of the reference's
`combine`; prefill logits, states and rings at prompts below and above
the window; four decode steps; the wave engine's greedy tokens against
the reference `Engine`'s; and the reference's ring rule (F10): with a
prompt shorter than the window the ring holds the prompt's positions
only, so the port's decode equals the reference's and not the full
forward, and with the ring padded to the window it equals the full
forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import Engine as JEngine
from repro_torch.models import rglru
from repro_torch.serving.engine import Engine
from torch_parity import (assert_close, j_decode, j_prefill, pair, prompts,
                          rel_err)

ARCH = "recurrentgemma_9b"


@pytest.fixture(scope="module")
def models():
    out = pair(ARCH, num_layers=5)
    cfg = out[2]
    assert [c for _, c, _ in rglru.layer_plan(cfg)] == list("rrarr")
    assert cfg.rglru.local_window == 64 and cfg.num_kv_heads == 1
    return out


@pytest.mark.parametrize("S", [1, 7, 64, 100])
def test_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    log_a = -rng.uniform(1e-3, 2.0, (2, S, 16)).astype(np.float32)
    bx = rng.standard_normal((2, S, 16)).astype(np.float32)

    def comb(e1, e2):
        return e1[0] + e2[0], jnp.exp(e2[0]) * e1[1] + e2[1]
    _, want = jax.jit(lambda a, b: jax.lax.associative_scan(
        comb, (a, b), axis=1))(jnp.asarray(log_a), jnp.asarray(bx))
    got = rglru.rglru_scan(torch.tensor(log_a), torch.tensor(bx))
    assert_close(got.numpy(), want, f"scan at S {S}")


@pytest.mark.parametrize("S", [40, 80], ids=["below-window", "past-window"])
def test_prefill_and_decode_match_reference(models, S):
    jcfg, jparams, cfg, lm = models
    rng = np.random.default_rng(S)
    toks = rng.integers(3, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = j_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill(torch.tensor(toks.astype(np.int64)))
    assert_close(tl.numpy(), jl, "prefill logits")
    assert set(tc) == set(jc)
    assert tc["s2_k"].shape[2] == min(S, 64)
    for n in jc:
        assert_close(tc[n].numpy(), jc[n], f"prefill {n}")
    for pos in range(S, S + 4):
        tok = rng.integers(3, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = j_decode(jcfg, jparams, jc, jnp.asarray(tok),
                                    jnp.int32(pos))
        tl = lm.decode_step(tc, torch.tensor(tok.astype(np.int64)), pos)
        assert_close(tl.numpy(), jl, f"decode logits at {pos}")
    for n in jc:
        assert_close(tc[n].numpy(), jc[n], f"{n} after decode")


def test_wave_tokens_match_reference_engine(models):
    """Mixed lengths, one past the window; the Engine routes rglru to
    waves."""
    jcfg, jparams, cfg, lm = models
    ps = prompts(5, (20, 70, 20, 9))
    want = JEngine(jcfg, jparams, max_len=96).generate(ps, max_new=6)
    eng = Engine(lm, max_len=96)
    got = eng.generate(ps, max_new=6)
    assert not eng._cont
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.tokens == w.tokens, f"request {i} diverged"


def test_ring_rule_f10(models):
    """A 16-token prompt under the 64-slot window: decode writes position
    16 into slot 0 of the 16-slot ring (the reference's rule, mirrored).
    Padded by hand to the window's 64 slots, the ring keeps every key,
    and four decode steps equal the full forward within 1e-5."""
    jcfg, jparams, cfg, lm = models
    S, steps = 16, 4
    rng = np.random.default_rng(9)
    toks = rng.integers(3, cfg.vocab_size, (2, S + steps)).astype(np.int32)
    tt = torch.tensor(toks.astype(np.int64))
    full = lm.logits_from_hidden(lm.hidden_states(tt))     # [2, S+4, V]
    _, jc = j_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])})
    _, ring = lm.prefill(tt[:, :S])
    padded = {n: (torch.cat([t, t.new_zeros(t.shape[:2] + (64 - S,)
                                            + t.shape[3:])], 2)
                  if n.endswith(("_k", "_v")) else t.clone())
              for n, t in ring.items()}
    worst_ring = 0.0
    for j, pos in enumerate(range(S, S + steps)):
        tok = jnp.asarray(toks[:, pos:pos + 1])
        jl, jc = j_decode(jcfg, jparams, jc, tok, jnp.int32(pos))
        got = lm.decode_step(ring, tt[:, pos:pos + 1], pos)
        assert_close(got.numpy(), jl, f"ring decode at {pos}")
        pad = lm.decode_step(padded, tt[:, pos:pos + 1], pos)
        assert_close(pad.numpy(), full[:, pos].numpy(),
                     f"padded ring at {pos}")
        worst_ring = max(worst_ring, rel_err(got.numpy(),
                                             full[:, pos].numpy()))
    assert worst_ring > 1e-3, "the short ring should have dropped keys"
