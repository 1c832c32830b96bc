"""The port's attention kernels' plain versions against the JAX package,
in float32 on the CPU: `flash_prefill` against the Pallas kernel
(interpret mode) on the sweep shapes of tests/test_kernels.py and against
`models.layers.attention` with a query offset, a kv length and a window;
`decode_attention` against the Pallas kernel (interpret mode) and the
jnp oracle with a scalar, a per-row and a ring kv_len. Plus the wrappers'
input checks. On the CPU the port's wrappers run their plain versions;
chip_smoke.py holds the CUDA kernels to those versions on the card.

Tolerances: against the Pallas kernels 2e-4, the JAX package's own for
them (tiled online softmax against one softmax); against the jnp
functions 1e-5 (f32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_prefill import flash_prefill as j_flash_prefill
from repro.models import layers as jL
from repro_torch.kernels import ops


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _normal(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("B,H,S,dh,window", [
    (1, 2, 256, 32, None),
    (1, 2, 300, 64, 64),
    (2, 4, 128, 32, None),
])
def test_flash_prefill_matches_pallas(B, H, S, dh, window):
    q, k, v = _normal(0, *[(B, H, S, dh)] * 3)
    want = j_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           window=window, interpret=True)
    # the port takes the model's [B, S, H, dh] layout
    got = ops.flash_prefill(*[_t(a.transpose(0, 2, 1, 3)) for a in (q, k, v)],
                            causal=True, window=window)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3),
                               np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("Sq,Sk,H,G,dh,q_offset,kv_len,window", [
    (8, 40, 4, 2, 32, 24, 32, None),     # a chunk over a padded buffer
    (16, 64, 4, 2, 32, 40, 56, 20),      # ... with a window
    (33, 33, 8, 2, 80, 0, None, 8),      # window < a tile, dh 80
    (32, 352, 14, 2, 64, 64, 96, None),  # qwen2.5 width, main-path chunk
])
def test_flash_prefill_matches_layers_attention(Sq, Sk, H, G, dh, q_offset,
                                                kv_len, window):
    q, k, v = _normal(1, (2, Sq, H, dh), (2, Sk, G, dh), (2, Sk, G, dh))
    want = jL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, window=window, q_offset=q_offset,
                        kv_len=kv_len)
    got = ops.flash_prefill(_t(q), _t(k), _t(v), causal=True, window=window,
                            q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,G,dh,S,kv_len,ring", [
    (1, 4, 1, 32, 128, 100, False),
    (2, 8, 2, 64, 700, 650, False),
    (2, 16, 16, 64, 512, 512, False),
    (4, 8, 2, 32, 128, [3, 100, 128, 57], False),   # per-row lengths
    (2, 4, 1, 32, 64, [150, 20], True),             # one row wrapped
    (2, 32, 8, 80, 96, 200, True),                  # h2o grouping, wrapped
])
def test_decode_attention_matches_pallas_and_oracle(B, H, G, dh, S, kv_len,
                                                    ring):
    q, k, v = _normal(2, (B, H, dh), (B, S, G, dh), (B, S, G, dh))
    lens = np.asarray(kv_len, np.int32)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    t_len = _t(lens) if lens.ndim else int(lens)
    got = ops.decode_attention(_t(q), _t(k), _t(v), t_len, ring=ring).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_decode(*args, interpret=True, ring=ring)),
        rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(jref.decode_attention(
        *args, ring=ring)), rtol=1e-5, atol=1e-5)


def test_decode_attention_scalar_equals_per_row():
    q, k, v = _normal(3, (3, 4, 32), (3, 50, 2, 32), (3, 50, 2, 32))
    one = ops.decode_attention(_t(q), _t(k), _t(v), 17)
    rows = ops.decode_attention(_t(q), _t(k), _t(v),
                                torch.full((3,), 17, dtype=torch.int32))
    assert torch.equal(one, rows)


def test_attention_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 8, 4, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(TypeError):
        ops.flash_prefill(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError):                       # H % G
        ops.flash_prefill(q, torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32))
    with pytest.raises(ValueError):                       # not contiguous
        ops.flash_prefill(q.transpose(1, 2), kv, kv)
    with pytest.raises(ValueError):
        ops.flash_prefill(q, kv, kv, window=0)
    qd = torch.zeros(2, 4, 32)
    kd = torch.zeros(2, 16, 2, 32)
    with pytest.raises(TypeError):                        # mixed dtypes
        ops.decode_attention(qd, kd.bfloat16(), kd, 4)
    with pytest.raises(TypeError):                        # kv_len dtype
        ops.decode_attention(qd, kd, kd, torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError):                       # kv_len rows
        ops.decode_attention(qd, kd, kd, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.decode_attention(qd, kd[:, ::2], kd[:, ::2], 4)
