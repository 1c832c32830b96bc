"""The whole model zoo of the port against the JAX package on the CPU:
`ARCH_IDS` is the reference's `ARCH_IDS + PAPER_IDS`; every config, full
and reduced, equals the reference's field by field (the sub-configs of
the mamba2, rglru and encdec families included); every reduced config's
parameter layout is the reference's and `build_model` builds it;
`supports_paged` agrees over the zoo with and without a window, int8 KV
or M-RoPE; nemotron-4-15b's squared-ReLU FFN and arctic-480b's dense
residual beside 128 -> 4 experts give the reference's greedy tokens on
the continuous engine; the four new families' bf16 prefill logits are
within F3's tolerance of the reference's; and a random tensor past
`DRAW_WHOLE` is drawn in runs in the generator's order."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import PAPER_IDS
from repro.configs import get_config as j_get_config
from repro.models import model as jmodel
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import flat_names
from repro_torch.models import dense
from repro_torch.models.model import FAMILIES, build_model, supports_paged
from repro_torch.serving.engine import Engine
from torch_parity import j_prefill, pair, prompts, rel_err

SUB = ("mamba", "rglru", "encdec")


def test_arch_ids_are_the_references():
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS + PAPER_IDS)
    assert set(FAMILIES) == {"dense", "moe", "encdec", "rglru", "mamba2"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_matches_reference(arch):
    for size in ("full", "reduced"):
        cfg, jcfg = get_config(arch), j_get_config(arch)
        if size == "reduced":
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        for f in dataclasses.fields(cfg):
            if f.name == "moe":
                for g in dataclasses.fields(cfg.moe):
                    assert (getattr(cfg.moe, g.name)
                            == getattr(jcfg.moe, g.name)), (size, g.name)
            else:
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), \
                    (size, f.name)
        for name in SUB:
            assert (dataclasses.asdict(getattr(cfg, name))
                    == dataclasses.asdict(getattr(jcfg, name))), (size, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_layout_matches_reference(arch):
    """The reduced config's parameter names and shapes are the
    reference's tree flattened (`convert.flat_names`); the model builds
    with random weights, F32_KEEP parameters in f32."""
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    if cfg.family == "rglru":
        jcfg, cfg = (c.reduced(num_layers=5) for c in (jcfg, cfg))
    want = {k: tuple(v.shape)
            for k, v in flat_names(jmodel.param_shapes(jcfg)).items()}
    model = FAMILIES[cfg.family]
    assert {k: s for k, (s, _) in model.shapes(cfg).items()} == want
    lm = build_model(cfg, device="cpu", seed=1)
    assert isinstance(lm, model)
    for name, p in lm.named_parameters():
        assert p.dtype == (torch.float32 if dense.keeps_f32(name)
                           else torch.bfloat16), name


def test_supports_paged_over_the_zoo():
    seen = 0
    for arch in ARCH_IDS:
        for base in (get_config(arch), get_config(arch).reduced()):
            jbase = j_get_config(arch)
            if base.name.endswith("-reduced"):
                jbase = jbase.reduced()
            for over in ({}, {"kv_quant": True}, {"sliding_window": 64},
                         {"rope_type": "mrope"}, {"modality": "text"}):
                assert (supports_paged(dataclasses.replace(base, **over))
                        == jmodel.supports_paged(dataclasses.replace(
                            jbase, **over))), (arch, over)
                seen += 1
    assert seen == 10 * len(ARCH_IDS)
    paged = {a for a in ARCH_IDS if supports_paged(get_config(a))}
    assert paged == {"arctic_480b", "granite_moe_1b_a400m", "qwen2_72b",
                     "mistral_large_123b", "nemotron_4_15b",
                     "h2o_danube_1_8b", "qwen25_0_5b"}


@pytest.mark.parametrize("arch", ["nemotron_4_15b", "arctic_480b"])
def test_continuous_tokens_match_reference(arch):
    """nemotron: squared-ReLU FFN without w3; arctic: top-2 of 4 experts
    beside the dense residual FFN. Mixed lengths through 2 slots."""
    jcfg, jparams, cfg, lm = pair(arch)
    assert (cfg.act == "sq_relu") == (arch == "nemotron_4_15b")
    assert cfg.moe.dense_residual == (arch == "arctic_480b")
    assert supports_paged(cfg)
    ps = prompts(7, (16, 37, 9))
    want = JEngine(jcfg, jparams, max_len=64, slots=2).generate(
        ps, max_new=5)
    got = Engine(lm, max_len=64, slots=2).generate(ps, max_new=5)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.tokens == w.tokens, f"{arch} request {i} diverged"


@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_9b",
                                  "whisper_small", "qwen2_vl_2b"])
def test_bf16_prefill_within_tolerance(arch):
    """bf16 on both sides rounds at other places (F3): prefill logits
    within 3e-2 of the largest |logit| (1.5e-3 to 4.9e-3 measured), the
    greedy pick equal wherever the reference's top two are further apart
    than that."""
    over = {"num_layers": 5} if arch == "recurrentgemma_9b" else {}
    jcfg, jparams, cfg, lm = pair(arch, dtype="bfloat16", **over)
    rng = np.random.default_rng(1)
    if cfg.family == "encdec":
        frames = rng.standard_normal((2, cfg.encdec.cross_kv_len,
                                      cfg.d_model)).astype(np.float32)
        dec = rng.integers(3, cfg.vocab_size, (2, 9))
        jl, _ = j_prefill(jcfg, jparams, {"frames": jnp.asarray(frames),
                                          "dec_tokens": jnp.asarray(dec)})
        tl, _ = lm.prefill(torch.tensor(frames), torch.tensor(dec))
    elif cfg.modality == "vision":
        toks = rng.integers(3, cfg.vocab_size, (2, dense.N_IMG + 12))
        patches = rng.standard_normal((2, dense.N_IMG, cfg.d_model)
                                      ).astype(np.float32)
        jl, _ = j_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                          "patches": jnp.asarray(patches)})
        tl, _ = lm.prefill(torch.tensor(toks), torch.tensor(patches))
    else:
        toks = rng.integers(3, cfg.vocab_size, (2, 40))
        jl, _ = j_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
        tl, _ = lm.prefill(torch.tensor(toks))
    jl = np.asarray(jl.astype(jnp.float32))
    got = tl.float().numpy()
    assert rel_err(got, jl) <= 3e-2
    top2 = np.sort(jl, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 3e-2 * np.abs(jl).max()
    assert (got.argmax(-1) == jl.argmax(-1))[clear].all()


def test_large_draws_are_sliced(monkeypatch):
    """Past DRAW_WHOLE a tensor is filled in runs of DRAW_SLICE elements
    of its flat order, each run the next draw of the generator: the same
    numbers as drawing the runs one after another."""
    monkeypatch.setattr(dense, "DRAW_WHOLE", 100)
    monkeypatch.setattr(dense, "DRAW_SLICE", 32)
    shape = (3, 4, 5, 2)                        # 120: runs 32, 32, 32, 24
    gen = torch.Generator().manual_seed(3)
    got = dense.random_tensor("normal", shape, torch.float32, gen, "cpu")
    gen = torch.Generator().manual_seed(3)
    want = torch.cat([torch.randn(m, generator=gen) * 0.02
                      for m in (32, 32, 32, 24)]).reshape(shape)
    assert torch.equal(got, want)
    lam = dense.random_tensor("lam", shape, torch.float32,
                              torch.Generator().manual_seed(3), "cpu")
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert 0.37 < float(a.min()) and float(a.max()) < 0.81
    small = dense.random_tensor("normal", (4, 5), torch.bfloat16,
                                torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(small, (torch.randn(
        4, 5, generator=torch.Generator().manual_seed(3)) * 0.02).to(
        torch.bfloat16))
