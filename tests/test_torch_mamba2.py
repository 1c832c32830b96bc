"""The port's Mamba2 family (mamba2-780m) against the JAX package on the
CPU, on the float32 reduced config (chunk 32, 8 heads of 32, state 16)
with converted params: `ssd_chunked` at lengths that are and are not a
whole number of chunks, prefill logits and states, four decode steps,
the wave engine's greedy tokens against the reference `Engine`'s and
the reference's random init (bf16: tests/test_torch_zoo.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jmamba2
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import mamba2
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.serving.engine import Engine
from torch_parity import assert_close, j_decode, j_prefill, pair, prompts

ARCH = "mamba2_780m"


@pytest.fixture(scope="module")
def models():
    return pair(ARCH)


@pytest.mark.parametrize("S", [45, 64, 7])
def test_ssd_chunked_matches_reference(models, S):
    """S 45: a ragged tail chunk (zero-dt padding); 64: two whole
    chunks; 7: one chunk shorter than chunk_size."""
    jcfg, jparams, cfg, lm = models
    d_in, H, P, N = mamba2.dims(cfg)
    rng = np.random.default_rng(S)
    xs = rng.standard_normal((2, S, d_in)).astype(np.float32)
    bm, cm = (rng.standard_normal((2, S, N)).astype(np.float32)
              for _ in range(2))
    dt = rng.uniform(1e-3, 0.2, (2, S, H)).astype(np.float32)
    lp = {k: v[1] for k, v in jparams["layers"].items()}
    want_y, want_h = jax.jit(jmamba2.ssd_chunked, static_argnums=0)(
        jcfg, lp, *(jnp.asarray(t) for t in (xs, bm, cm, dt)))
    got_y, got_h = mamba2.ssd_chunked(cfg, lm.A_log[1], lm.D[1], *(
        torch.tensor(t) for t in (xs, bm, cm, dt)))
    assert_close(got_y.numpy(), want_y, f"y at S {S}")
    assert_close(got_h.numpy(), want_h, f"final state at S {S}")


def test_prefill_and_decode_match_reference(models):
    jcfg, jparams, cfg, lm = models
    S = 45
    rng = np.random.default_rng(0)
    toks = rng.integers(3, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = j_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill(torch.tensor(toks.astype(np.int64)))
    assert_close(tl.numpy(), jl, "prefill logits")
    assert set(tc) == set(jc) == {"h", "conv"}
    assert tc["h"].dtype == torch.float32
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
    """Mixed lengths: three waves; the Engine routes mamba2 to waves."""
    jcfg, jparams, cfg, lm = models
    ps = prompts(3, (20, 33, 20, 9))
    want = JEngine(jcfg, jparams, max_len=64).generate(ps, max_new=6)
    eng = Engine(lm, max_len=64)
    got = eng.generate(ps, max_new=6)
    assert not eng._cont                   # never the continuous engine
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.tokens == w.tokens, f"request {i} diverged"


def test_random_init_follows_reference():
    """dt_bias: softplus(dt_bias) in (1e-3, 1e-1); A_log: log of (1, 16);
    D zeros; all three f32 in a bf16 model."""
    cfg = get_config(ARCH).reduced()
    lm = Mamba2LM(cfg, device="cpu", seed=0)
    sp = torch.nn.functional.softplus(lm.dt_bias)
    assert lm.dt_bias.dtype == lm.A_log.dtype == lm.D.dtype == torch.float32
    assert lm.w_xz.dtype == torch.bfloat16
    assert 1e-3 <= float(sp.min()) and float(sp.max()) <= 1e-1 + 1e-6
    a = torch.exp(lm.A_log)
    assert 1.0 <= float(a.min()) and float(a.max()) <= 16.0 + 1e-4
    assert not lm.D.any()
