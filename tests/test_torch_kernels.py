"""The port's scr_select, decode_attention_paged, scr_score and pq_adc
kernel functions against the JAX package's Pallas kernels (interpret
mode) and pure-jnp oracles, on the sweeps and edge cases of
tests/test_kernels.py, plus the wrappers' input checks. On the CPU the
port's wrappers run their plain PyTorch versions; chip_smoke.py holds the
CUDA kernels to those versions on the card. Inputs are numpy arrays from
a seed, fed to both packages.

Tolerances: window ids exact; scr_select scores 2e-5 (f32 sums in
another order); decode_attention_paged (f32), scr_score and pq_adc 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import \
    decode_attention_paged as j_decode_paged
from repro.kernels.pq_adc import pq_adc as j_pq_adc
from repro.kernels.scr_score import scr_score as j_scr_score
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


@pytest.mark.parametrize("B,NW,d", [(1, 5, 32), (3, 200, 64), (2, 257, 128),
                                    (1, 30, 384), (2, 9, 50)])
def test_scr_score_sweep(B, NW, d):
    r = _rng(8)
    w = r.standard_normal((B, NW, d)).astype(np.float32)
    q = r.standard_normal((B, d)).astype(np.float32)
    before = ops.launch_counts()["scr_score"]
    st = ops.scr_score(_t(w), _t(q))
    assert ops.launch_counts()["scr_score"] == before    # CPU: plain version
    args = (jnp.asarray(w), jnp.asarray(q))
    for sj in (j_scr_score(*args, interpret=True), jref.scr_score(*args)):
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5,
                                   atol=1e-5)


def test_scr_score_empty():
    assert ops.scr_score(torch.zeros(0, 4, 8), torch.zeros(0, 8)).shape == \
        (0, 4)
    assert ops.scr_score(torch.zeros(2, 0, 8), torch.zeros(2, 8)).shape == \
        (2, 0)


@pytest.mark.parametrize("B,M,N", [(1, 4, 100), (2, 8, 513), (3, 16, 64),
                                   (1, 8, 1)])
def test_pq_adc_sweep(B, M, N):
    r = _rng(9)
    lut = r.standard_normal((B, M, 256)).astype(np.float32)
    codes = r.integers(0, 256, (N, M)).astype(np.uint8)
    codes[0] = 255
    codes[-1] = 0
    pt = ops.pq_adc(_t(lut), _t(codes))
    args = (jnp.asarray(lut), jnp.asarray(codes))
    for pj in (j_pq_adc(*args, interpret=True), jref.pq_adc(*args)):
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                                   atol=1e-5)


def test_pq_adc_small_tables():
    """K < 256 (nbits < 8), as the reference's IVFPQ gathers from
    [m, ksub] tables: the sum of the looked-up entries."""
    r = _rng(10)
    lut = r.standard_normal((2, 5, 16)).astype(np.float32)
    codes = r.integers(0, 16, (40, 5)).astype(np.uint8)
    want = lut[:, np.arange(5)[None, :], codes.astype(np.int64)].sum(-1)
    np.testing.assert_allclose(ops.pq_adc(_t(lut), _t(codes)).numpy(), want,
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
    with pytest.raises(ValueError):
        ops.scr_score(torch.zeros(2, 4, 8), torch.zeros(3, 8))
    with pytest.raises(TypeError):
        ops.scr_score(torch.zeros(2, 4, 8).double(), q.double())


def test_cuda_entry_raises_without_gpu():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
