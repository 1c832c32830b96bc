"""The port's encoder-decoder family (whisper-small) against the JAX
package on the CPU, on the float32 reduced config (2 + 2 layers, 24
frames) with converted params: the parameter layout, the encoder's
output, the prefill's logits and caches (self-attention k, v over the
decoder prompt; cross_k, cross_v over the frames), four decode steps on
the grown cache (only k and v grow; the cross planes keep the frames),
and the Engine's refusal of a frames model."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jencdec
from repro.models import model as jmodel
from repro_torch.convert import flat_names
from repro_torch.models.encdec import param_shapes
from repro_torch.serving.engine import Engine, grow_cache
from torch_parity import (assert_close, grow_reference, j_decode, j_prefill,
                          pair)

ARCH = "whisper_small"


@pytest.fixture(scope="module")
def models():
    return pair(ARCH)


@pytest.fixture(scope="module")
def inputs(models):
    cfg = models[2]
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, cfg.encdec.cross_kv_len, cfg.d_model)
                                 ).astype(np.float32)
    dec = rng.integers(3, cfg.vocab_size, (2, 9)).astype(np.int32)
    return frames, dec


def test_param_layout_matches_reference(models):
    jcfg, _, cfg, _ = models
    want = {k: tuple(v.shape)
            for k, v in flat_names(jmodel.param_shapes(jcfg)).items()}
    assert {k: s for k, (s, _) in param_shapes(cfg).items()} == want
    assert "frame_proj" in want and "dec_cross_wq" in want


def test_encoder_matches_reference(models, inputs):
    jcfg, jparams, cfg, lm = models
    frames, _ = inputs
    want = jax.jit(jencdec.encode, static_argnums=0)(jcfg, jparams,
                                                     jnp.asarray(frames))
    assert_close(lm.encode(torch.tensor(frames)).numpy(), want, "encoder")


def test_prefill_and_decode_match_reference(models, inputs):
    jcfg, jparams, cfg, lm = models
    frames, dec = inputs
    S, F, grown = dec.shape[1], frames.shape[1], 16
    jl, jc = j_prefill(jcfg, jparams, {"frames": jnp.asarray(frames),
                                       "dec_tokens": jnp.asarray(dec)})
    tl, tc = lm.prefill(torch.tensor(frames), torch.tensor(dec))
    assert_close(tl.numpy(), jl, "prefill logits")
    assert set(tc) == set(jc) == {"k", "v", "cross_k", "cross_v"}
    for n in jc:
        assert_close(tc[n].numpy(), jc[n], f"prefill {n}")
    jc = grow_reference(jc, ("k", "v"), grown)
    tc = grow_cache(cfg, tc, grown)
    assert tc["k"].shape[2] == grown and tc["cross_k"].shape[2] == F
    rng = np.random.default_rng(1)
    for pos in range(S, S + 4):
        tok = rng.integers(3, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = j_decode(jcfg, jparams, jc, jnp.asarray(tok), jnp.int32(pos))
        tl = lm.decode_step(tc, torch.tensor(tok.astype(np.int64)), pos)
        assert_close(tl.numpy(), jl, f"decode logits at {pos}")
    for n in jc:
        assert_close(tc[n].numpy(), jc[n], f"{n} after decode")


def test_engine_refuses_frames_model(models):
    with pytest.raises(ValueError, match="token-only"):
        Engine(models[3])
