"""The port's int8 KV cache against the JAX package on the CPU:
`quantize_kv` / `dequantize_kv` bit-equal to the reference's; the plain
int8 decode attention (`ref.decode_attention_q8`: contiguous, ring,
per-row kv_len) within 1e-5 of `layers.decode_attention_q8`, its paged
variant equal to the gathered one, and both wrappers on CPU tensors
equal to them; the int8 wave `prefill` / `decode_step` logits and caches
against `dense.prefill` / `decode_step` of a `kv_quant` config (qwen2.5,
and h2o past its ring); the int8 paged chunk prefill and paged decode,
plain and ring, against the reference's on the same page tables."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import dense as jdense
from repro.models import layers as JL
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.dense import DenseLM, init_page_pool


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32) * 3
    x[0, 2] = 0.0                                   # the 1e-10 clamp
    x[1, 4, 1, :5] = [0.5, -0.5, 1.5, 2.5, -127.0]  # halves to even
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    jq, js = JL.quantize_kv(jx)
    tq, ts = L.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = JL.dequantize_kv(jq, js, jnp.float32)
    td = L.dequantize_kv(tq, ts, torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert float(ts.min()) == np.float32(1e-10)


def _q8_inputs(B, S, G, H, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kq, ks = JL.quantize_kv(jnp.asarray(rng.standard_normal(
        (B, S, G, dh)).astype(np.float32)))
    vq, vs = JL.quantize_kv(jnp.asarray(rng.standard_normal(
        (B, S, G, dh)).astype(np.float32)))
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("kv_len,ring", [
    (23, False), (40, True), (95, True), ([1, 17, 40, 0], False),
    ([1, 17, 63, 40], True)], ids=["scalar", "ring-full", "ring-wrapped",
                                   "per-row", "per-row-ring"])
def test_decode_attention_q8_matches_reference(kv_len, ring):
    B, S, G, H, dh = 4, 40, 2, 4, 32
    q, kq, ks, vq, vs = _q8_inputs(B, S, G, H, dh, 1)
    kl = jnp.asarray(kv_len, jnp.int32)
    want = JL.decode_attention_q8(jnp.asarray(q)[:, None], kq, ks, vq, vs,
                                  kl, ring=ring)[:, 0]
    tl = kv_len if isinstance(kv_len, int) else torch.tensor(
        kv_len, dtype=torch.int32)
    args = (torch.tensor(q), _t(kq), _t(ks), _t(vq), _t(vs), tl)
    got = ref.decode_attention_q8(*args, ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(ops.decode_attention_q8(*args, ring=ring), got)


def test_decode_attention_paged_q8_equals_gathered():
    """Pages through tables that repeat, reverse and point tail entries at
    page 0; kv_len 0, 1, a page end and the whole table."""
    P, ps, G, H, dh = 10, 8, 2, 4, 32
    q, kq, ks, vq, vs = _q8_inputs(1, P * ps, G, H, dh, 2)
    pool = [_t(a).reshape((P, ps) + a.shape[2:]) for a in (kq, ks, vq, vs)]
    table = torch.tensor([[3, 1, 0, 0], [9, 8, 7, 6], [2, 2, 5, 4],
                          [6, 0, 0, 0]], dtype=torch.int32)
    kv_len = torch.tensor([0, 32, 8, 1], dtype=torch.int32)
    qb = torch.tensor(np.random.default_rng(3).standard_normal(
        (4, H, dh)).astype(np.float32))
    got = ref.decode_attention_paged_q8(qb, *pool, kv_len, table)
    g = [ref._gather_pages(t, table) for t in pool]
    want = ref.decode_attention_q8(qb, *g, kv_len)
    assert torch.equal(got, want)
    assert torch.equal(ops.decode_attention_paged_q8(qb, *pool, kv_len,
                                                     table), got)
    jwant = JL.decode_attention_q8(
        jnp.asarray(qb.numpy())[:, None], *(jnp.asarray(t.numpy())
                                            for t in g),
        jnp.asarray(kv_len.numpy()))[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-5)


def _models(arch, seed):
    jcfg = j_get_config(arch).reduced(dtype="float32", kv_quant=True)
    cfg = get_config(arch).reduced(dtype="float32", kv_quant=True)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, DenseLM(cfg, device="cpu", params=params)


def _pad(c, n, cat, zeros):
    return {k: cat([v, zeros(v.shape[:2] + (n - v.shape[2],) + v.shape[3:],
                             v.dtype)], 2) for k, v in c.items()}


# A value at a rounding half of x / s lands one int8 step apart when the
# f32 k or v differ in the last bit (matmul order), and a step in an early
# layer moves later layers' k, v by ~1e-4: so a whole int8 prefill is
# held at 1e-3 with int8 values within one step; a decode step from the
# reference's own cache is held at 1e-4. The next test shows the cause:
# on the reference's own f32 k, v the port's int8 cache is bit-equal.
@pytest.mark.parametrize("arch", ["qwen25_0_5b", "h2o_danube_1_8b"])
def test_int8_wave_prefill_and_decode_match_reference(arch):
    jcfg, jparams, cfg, lm = _models(arch, 0)
    S = 80 if cfg.sliding_window else 21          # 80 wraps the 64 ring
    rng = np.random.default_rng(0)
    toks = rng.integers(3, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill(torch.tensor(toks.astype(np.int64)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-3)
    assert set(tc) == set(jc) == {"k", "v", "k_s", "v_s"}
    assert tc["k"].dtype == torch.int8 and tc["k_s"].dtype == torch.float32
    assert tc["k"].shape[2] == (64 if cfg.sliding_window else S)
    for n in ("k", "v"):
        d = np.abs(tc[n].numpy().astype(int) - np.asarray(jc[n]).astype(int))
        assert d.max() <= 1 and d.mean() < 0.02, (n, d.max(), d.mean())
    for n in ("k_s", "v_s"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   rtol=1e-3, atol=1e-7)
    if not cfg.sliding_window:
        jc = _pad(jc, S + 3, jnp.concatenate, jnp.zeros)
    tc = {n: _t(c).clone() for n, c in jc.items()}
    for pos in range(S, S + 3):
        tok = rng.integers(3, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jcfg, jparams, jc, jnp.asarray(tok),
                                    jnp.int32(pos))
        tl = lm.decode_step(tc, torch.tensor(tok.astype(np.int64)), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for n in ("k", "v"):
            d = tc[n].numpy().astype(int) - np.asarray(jc[n]).astype(int)
            assert np.abs(d).max() <= 1, n
    np.testing.assert_allclose(tc["v_s"].numpy(), np.asarray(jc["v_s"]),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ["qwen25_0_5b", "h2o_danube_1_8b"])
def test_int8_prefill_cache_bit_equal_on_reference_kv(arch, monkeypatch):
    """Every layer's k, v replaced by the reference's own f32 ones (its
    `_scan_blocks` collects them): the port's prefill then writes an int8
    cache (values, scales and, past the window, the ring's roll)
    bit-equal to the reference's."""
    jcfg, jparams, cfg, lm = _models(arch, 0)
    S = 80 if cfg.sliding_window else 21
    toks = np.random.default_rng(0).integers(3, cfg.vocab_size, (2, S)
                                             ).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    _, jc = jmodel.prefill(jcfg, jparams, batch)
    x, positions = jdense.embed_inputs(jcfg, jparams, batch)
    _, (jk, jv) = jdense._scan_blocks(jcfg, jparams, x, positions,
                                      seq_sp=False, collect_kv=True,
                                      fake_quant_kv=True)
    own = lm._qkv

    def qkv(i, y, pos):
        return own(i, y, pos)[0], _t(jk[i]), _t(jv[i])
    monkeypatch.setattr(lm, "_qkv", qkv)
    _, tc = lm.prefill(torch.tensor(toks.astype(np.int64)))
    for n in ("k", "k_s", "v", "v_s"):
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]),
                                      err_msg=n)


def _no_padding(pool, row, first, end, ps):
    """The reference's pool with positions [first, end) of `row`
    zeroed: its chunk without a ring also writes the last chunk's
    padding, which the port never writes (no query reads a position
    before a decode step writes it)."""
    pool = np.array(pool)
    for p in range(first, end):
        pool[:, row[p // ps], p % ps] = 0
    return pool


@pytest.mark.parametrize("arch,ring_len", [("qwen25_0_5b", 0),
                                           ("h2o_danube_1_8b", 64)],
                         ids=["pages", "ring-pages"])
def test_int8_paged_chunks_and_decode_match_reference(arch, ring_len):
    """An 83-token prompt in 16-token chunks through one slot's row (the
    ring wraps at 64), then three decode steps of three slots (one
    inactive); logits within 1e-4, the pool's scales within 1e-5 but
    where the reference writes the last chunk's padding."""
    jcfg, jparams, cfg, lm = _models(arch, 1)
    ps, P, C = 8, 36, 16
    abs_len = 96 if ring_len else 0
    W = ring_len // ps if ring_len else 11
    jc = jmodel.init_page_pool(jcfg, P, ps, dtype=jnp.float32)
    tc = init_page_pool(cfg, P, ps, device="cpu")
    rng = np.random.default_rng(4)
    rows = rng.permutation(P)[:3 * W].reshape(3, W).astype(np.int32)
    prompt = rng.integers(3, cfg.vocab_size, 83).astype(np.int32)
    for off in range(0, len(prompt), C):
        chunk = prompt[off:off + C]
        real = len(chunk)
        chunk = np.pad(chunk, (0, C - real))
        jl, jc = jmodel.prefill_chunk_paged(
            jcfg, jparams, jc, jnp.asarray(chunk[None]),
            jnp.asarray(rows[0]), jnp.int32(off), jnp.int32(off + real),
            page_size=ps, ring_len=ring_len, abs_len=abs_len)
        tl = lm.prefill_chunk_paged(
            tc, torch.tensor(chunk[None].astype(np.int64)),
            torch.tensor(rows[0]), off, off + real, page_size=ps,
            ring_len=ring_len)
        np.testing.assert_allclose(tl[0, :real].numpy(),
                                   np.asarray(jl)[0, :real], rtol=1e-4,
                                   atol=1e-4)
    pad_end = 0 if ring_len else W * ps
    np.testing.assert_allclose(
        tc["k_s"].numpy(), _no_padding(jc["k_s"], rows[0], 83, pad_end, ps),
        rtol=1e-5, atol=1e-7)
    pos = np.asarray([83, 3, 5], np.int32)
    active = np.asarray([True, True, False])
    for _ in range(3):
        tok = rng.integers(3, cfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step_paged(
            jcfg, jparams, jc, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(active), jnp.asarray(rows), page_size=ps,
            ring_len=ring_len)
        tl = lm.decode_step_paged(
            tc, torch.tensor(tok.astype(np.int64)),
            torch.tensor(pos.astype(np.int64)), torch.tensor(active),
            torch.tensor(rows), page_size=ps, ring_len=ring_len)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   rtol=1e-4, atol=1e-4)
        pos = pos + active
    np.testing.assert_allclose(
        tc["v_s"].numpy(), _no_padding(jc["v_s"], rows[0], 86, pad_end, ps),
        rtol=1e-5, atol=1e-7)
