"""The port's scr_select and decode_attention_paged kernel functions
against the JAX package's Pallas kernels (interpret mode) and pure-jnp
oracles, on the sweeps and edge cases of tests/test_kernels.py, plus the
wrappers' input checks. On the CPU the port's wrappers run their plain
PyTorch versions; chip_smoke.py holds the CUDA kernels to those versions
on the card. Inputs are numpy arrays from a seed, fed to both packages.

Tolerances: window ids exact; scr_select scores 2e-5 (f32 sums in
another order); decode_attention_paged (f32) 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import \
    decode_attention_paged as j_decode_paged
from repro.kernels.scr_select import scr_select as j_scr_select
from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


def _rng(i):
    return np.random.default_rng(i)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scr_check(q, data, lens, ids):
    st, wt = ops.scr_select(_t(q), _t(data), _t(lens), _t(ids))
    args = (jnp.asarray(q), jnp.asarray(data), jnp.asarray(lens),
            jnp.asarray(ids))
    for sj, wj in (j_scr_select(*args, interpret=True), jref.scr_select(*args)):
        np.testing.assert_allclose(st.numpy(), np.asarray(sj),
                                   rtol=2e-5, atol=2e-5)
        assert (wt.numpy() == np.asarray(wj)).all()
    return st.numpy(), wt.numpy()


@pytest.mark.parametrize("B,d,ND,CAPW,K", [
    (1, 32, 6, 8, 3),
    (3, 64, 12, 24, 5),
    (2, 128, 40, 17, 9),
])
def test_scr_select_sweep(B, d, ND, CAPW, K):
    r = _rng(5)
    q = r.standard_normal((B, d)).astype(np.float32)
    data = r.standard_normal((ND, CAPW, d)).astype(np.float32)
    lens = r.integers(0, CAPW + 1, ND).astype(np.int32)
    ids = r.integers(0, ND, (B, K)).astype(np.int32)
    _scr_check(q, data, lens, ids)


def test_scr_select_padded_windowless_and_first_max():
    r = _rng(6)
    q = r.standard_normal((2, 16)).astype(np.float32)
    data = r.standard_normal((4, 8, 16)).astype(np.float32)
    lens = np.asarray([3, 0, 8, 1], np.int32)
    s, w = _scr_check(q, data, lens,
                      np.asarray([[0, 1, -1], [2, 3, 1]], np.int32))
    assert w[0, 1] == -1 and w[0, 2] == -1 and w[1, 2] == -1
    assert s[0, 1] == -tref.NEG and w[1, 1] == 0
    one = np.ones(8, np.float32)
    data = np.stack([np.stack([one * 0.5, one, one, one * 0.2])])
    _, w = _scr_check(np.ones((1, 8), np.float32), data,
                      np.asarray([4], np.int32), np.asarray([[0]], np.int32))
    assert w[0, 0] == 1


@pytest.mark.parametrize("B,H,G,dh,P,ps,W", [
    (3, 4, 2, 32, 8, 16, 4),     # reduced-config grouping (Hg = 2)
    (4, 14, 2, 64, 12, 32, 3),   # qwen2.5-0.5B grouping (Hg = 7)
])
def test_decode_attention_paged(B, H, G, dh, P, ps, W):
    r = _rng(7)
    q = r.standard_normal((B, H, dh)).astype(np.float32)
    kp = r.standard_normal((P, ps, G, dh)).astype(np.float32)
    vp = r.standard_normal((P, ps, G, dh)).astype(np.float32)
    table = np.stack([r.permutation(P)[:W] for _ in range(B)]).astype(np.int32)
    table[0, 0] = table[1, 0]        # rows 0 and 1 share a prefix page
    lens = np.asarray([W * ps, ps + 5, 2 * ps - 1, 1][:B], np.int32)
    table[1, 2:] = 0                 # unmapped tail entries (masked)
    ot = ops.decode_attention_paged(_t(q), _t(kp), _t(vp), _t(lens),
                                    _t(table))
    args = tuple(jnp.asarray(a) for a in (q, kp, vp, lens, table))
    for oj in (j_decode_paged(*args, interpret=True),
               jref.decode_attention_paged(*args)):
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj),
                                   rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(2, 8)
    with pytest.raises(TypeError):
        ops.kmeans_assign(q.double(), q.double())
    with pytest.raises(ValueError):
        ops.scr_select(q, torch.zeros(3, 4, 8), torch.zeros(3, dtype=torch.int32),
                       torch.zeros(2, 2, dtype=torch.int32).t())
    with pytest.raises(ValueError):
        ops.ecoscan(q, torch.zeros(3, 4, 7), torch.zeros(3, dtype=torch.int32),
                    torch.zeros(2, 1, dtype=torch.int32), 2)


def test_cuda_entry_raises_without_gpu():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
