"""The port's vision branch of the dense family (qwen2-vl-2b: stub patch
embeddings, M-RoPE) against the JAX package on the CPU: `apply_mrope`
at the full head dim (sections 16 / 24 / 24) and at the reduced one
(the sections rescaled), the prefill and decode M-RoPE ids, and on the
float32 reduced config with converted params the prefill's logits and
caches over 256 patches and 12 text tokens and four decode steps; a
vision config stays off the paged path and the Engine."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import dense as jdense
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.models import dense, layers
from repro_torch.models.model import supports_paged
from repro_torch.serving.engine import Engine, grow_cache
from torch_parity import (assert_close, grow_reference, j_decode, j_prefill,
                          pair)

ARCH = "qwen2_vl_2b"


@pytest.fixture(scope="module")
def models():
    return pair(ARCH)


@pytest.mark.parametrize("dh", [128, 32, 8], ids=["full", "reduced", "tiny"])
def test_apply_mrope_matches_reference(dh):
    """dh 128: the sections fill the 64 slots; dh 32 and 8: rescaled."""
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 20, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 20, 3))
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                               (16, 24, 24), 1e6)
    got = layers.apply_mrope(torch.tensor(x), torch.tensor(pos),
                             (16, 24, 24), 1e6)
    assert_close(got.numpy(), want, f"M-RoPE at dh {dh}")


def test_mrope_positions_match_reference():
    S = dense.N_IMG + 40
    assert dense.N_IMG == jdense.N_IMG and dense.IMG_GRID == jdense.IMG_GRID
    np.testing.assert_array_equal(dense.mrope_positions(S).numpy(),
                                  np.asarray(jdense.mrope_positions(S)))
    for pos in (S, S + 7):
        np.testing.assert_array_equal(
            dense.mrope_positions_decode(pos, 3).numpy(),
            np.asarray(jdense.mrope_positions_decode(jnp.int32(pos), 3)))


def test_prefill_and_decode_match_reference(models):
    jcfg, jparams, cfg, lm = models
    rng = np.random.default_rng(0)
    S = dense.N_IMG + 12
    toks = rng.integers(3, cfg.vocab_size, (2, S)).astype(np.int32)
    patches = rng.standard_normal((2, dense.N_IMG, cfg.d_model)
                                  ).astype(np.float32)
    jl, jc = j_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                       "patches": jnp.asarray(patches)})
    tl, tc = lm.prefill(torch.tensor(toks.astype(np.int64)),
                        torch.tensor(patches))
    assert_close(tl.numpy(), jl, "prefill logits")
    for n in ("k", "v"):
        assert_close(tc[n].numpy(), jc[n], f"prefill {n}")
    jc = grow_reference(jc, ("k", "v"), S + 4)
    tc = grow_cache(cfg, tc, S + 4)
    for pos in range(S, S + 4):
        tok = rng.integers(3, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = j_decode(jcfg, jparams, jc, jnp.asarray(tok), jnp.int32(pos))
        tl = lm.decode_step(tc, torch.tensor(tok.astype(np.int64)), pos)
        assert_close(tl.numpy(), jl, f"decode logits at {pos}")
    for n in ("k", "v"):
        assert_close(tc[n].numpy(), jc[n], f"{n} after decode")


def test_vision_needs_patches_and_stays_off_the_engine(models):
    cfg, lm = models[2], models[3]
    assert not supports_paged(cfg) and not supports_paged(get_config(ARCH))
    with pytest.raises(ValueError, match="patches"):
        lm.prefill(torch.zeros(1, dense.N_IMG + 2, dtype=torch.long))
    with pytest.raises(ValueError, match="token-only"):
        Engine(lm)
