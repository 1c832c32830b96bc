"""The port's H100 cost model against the reference's count: the dry
run's configs and cells, FLOPs of a traced step against
`repro.roofline.hlo.structural_cost` of the reference's compiled HLO
(the gte-small encoder, the qwen2.5 prefill, the sharded retrieval and
its collectives on 4 ranks), the byte rules on hand-counted cases, the
kernel wrappers' trace route, and `PERF.md`'s bounds recomputed by
`kernels/cost.py`."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.config import SHAPES as J_SHAPES
from repro.configs import cells as j_cells
from repro.configs import get_config as j_get_config
from repro.configs import skipped_cells as j_skipped_cells
from repro.models import model as jmodel
from repro.roofline.hlo import structural_cost
from repro_torch.config import SHAPES
from repro_torch.configs import ARCH_IDS, cells, get_config, skipped_cells
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun
from repro_torch.roofline import graph, hardware as hw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# FLOPs of a traced step against the reference's HLO count
FLOPS_RTOL = 0.01


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    assert {n: (s.seq_len, s.global_batch, s.kind)
            for n, s in SHAPES.items()} == \
        {n: (s.seq_len, s.global_batch, s.kind) for n, s in J_SHAPES.items()}
    assert [s.name for s in cells(arch)] == [s.name for s in j_cells(arch)]
    assert skipped_cells(arch) == j_skipped_cells(arch)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert cfg.subquadratic == jcfg.subquadratic
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def _reference_flops(fn, *structs) -> float:
    hlo = jax.jit(fn).lower(*structs).compile().as_text()
    return structural_cost(hlo)["flops"]


def _port(cfg, run):
    """The cost dict of `run(model, mode)` on the port's fake model."""
    mode = graph.fake_mode()
    with mode:
        lm = dryrun.fake_model(cfg)
    return run(lm, mode)


def _layer_attention_flops(cfg, B, Sq, pairs):
    return 4.0 * cfg.resolved_head_dim * cfg.num_heads * B * pairs * \
        cfg.num_layers


def test_encoder_flops_match_reference():
    """gte-small's encoder forward (non-causal: every pair attended; S is
    the reference attention's 1,024-key chunk, so it pads nothing)."""
    B, S = 2, 1024
    jcfg = j_get_config("gte_small").reduced()
    cfg = get_config("gte_small").reduced()
    want = _reference_flops(
        lambda p, t: jmodel.encode(jcfg, p, {"tokens": t}),
        jmodel.param_shapes(jcfg),
        jax.ShapeDtypeStruct((B, S), jnp.int32))

    def run(lm, mode):
        with mode:
            toks = torch.zeros((B, S), dtype=torch.long)
        return graph.trace_cost(lm.encode, toks, mode=mode)
    got = _port(cfg, run)
    assert got["kernel_nodes"] == {"flash_prefill": cfg.num_layers}
    assert abs(got["flops"] - want) <= FLOPS_RTOL * want, (got["flops"], want)


def test_prefill_flops_match_reference():
    """qwen2.5's prefill: the reference's attention scores every (query,
    key) pair of its chunk, the port's flash_prefill only the unmasked
    ones, so the masked pairs' FLOPs (from the shapes) come off."""
    B, S = 1, 1024
    jcfg = j_get_config("qwen25_0_5b").reduced()
    cfg = get_config("qwen25_0_5b").reduced()
    want = _reference_flops(
        lambda p, t: jmodel.prefill(jcfg, p, {"tokens": t}),
        jmodel.param_shapes(jcfg),
        jax.ShapeDtypeStruct((B, S), jnp.int32))
    masked = _layer_attention_flops(cfg, B, S, S * S - S * (S + 1) // 2)

    def run(lm, mode):
        with mode:
            toks = torch.zeros((B, S), dtype=torch.long)
        return graph.trace_cost(lm.prefill, toks, mode=mode)
    got = _port(cfg, run)
    assert got["kernel_nodes"] == {"flash_prefill": cfg.num_layers}
    want -= masked
    assert abs(got["flops"] - want) <= FLOPS_RTOL * want, (got["flops"], want)


RETRIEVAL = dict(B=8, NC=16, CAP=32, d=16, n_probe=4, k=3)

SCRIPT_REFERENCE_RETRIEVAL = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from repro.core.distributed import (make_sharded_retrieval,
                                        retrieval_input_structs,
                                        retrieval_shardings)
    from repro.launch.mesh import make_test_mesh
    from repro.roofline.hlo import structural_cost
    a = json.loads(sys.argv[1])
    mesh = make_test_mesh(2, 2)
    fn = make_sharded_retrieval(mesh, k=a["k"], n_probe=a["n_probe"])
    structs = retrieval_input_structs(B=a["B"], NC=a["NC"], CAP=a["CAP"],
                                      d=a["d"])
    hlo = jax.jit(fn, in_shardings=retrieval_shardings(mesh)).lower(
        *structs).compile().as_text()
    print(json.dumps(structural_cost(hlo)))
""")


@pytest.fixture(scope="module", autouse=True)
def reference_retrieval():
    """The reference's retrieval lowered in a subprocess on 4 forced host
    devices, started with the module's first test so that it runs while
    the others do (`retrieval_costs` waits for it)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    with subprocess.Popen([sys.executable, "-c", SCRIPT_REFERENCE_RETRIEVAL,
                           json.dumps(RETRIEVAL)], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True,
                          env=env) as proc:
        yield proc
        proc.kill()


@pytest.fixture(scope="module")
def retrieval_costs(reference_retrieval):
    """(port's cost on a 2 x 2 fake mesh as rank 0, the reference's
    structural cost on 4 forced host devices)."""
    stdout, stderr = reference_retrieval.communicate(timeout=300)
    assert reference_retrieval.returncode == 0, stderr[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    from repro_torch.launch import retrieval_dryrun
    from repro_torch.launch.mesh import make_test_mesh
    dryrun.fake_world(4)
    try:
        mesh = make_test_mesh(2, 2, device_type="cpu")
        a = RETRIEVAL
        got = retrieval_dryrun.trace(mesh, B=a["B"], NC=a["NC"], cap=a["CAP"],
                                     d=a["d"], n_probe=a["n_probe"],
                                     k=a["k"])
    finally:
        dryrun.release()
    return got, want


def test_retrieval_flops_match_reference(retrieval_costs):
    """The route's product and the scan's dots equal the reference's
    (2 B NC d + 2 B P CAP d); the port's ecoscan cost adds the rows'
    norms (2 d a row), which the reference's HLO bills as elementwise."""
    got, want = retrieval_costs
    a = RETRIEVAL
    norms = 2.0 * a["d"] * a["B"] * a["n_probe"] * a["CAP"]
    assert want["flops"] == 2.0 * a["B"] * a["NC"] * a["d"] + \
        2.0 * a["B"] * a["n_probe"] * a["CAP"] * a["d"]
    assert got["flops"] == want["flops"] + norms
    assert got["kernel_nodes"] == {"ecoscan": 1}


def test_retrieval_collectives_match_reference(retrieval_costs):
    """Each rank's top k all-gathered over the 4 ranks: the port gathers
    an axis at a time, the reference over both at once; the ring bytes
    agree."""
    got, want = retrieval_costs
    assert got["collective_total"] == pytest.approx(want["collective_total"])
    assert got["coll_all-gather"] == pytest.approx(want["coll_all-gather"])
    assert got["collective_total"] > 0


def _cost_of(fn, *shapes_and_types):
    mode = graph.fake_mode()
    with mode:
        args = [torch.zeros(s, dtype=t) for s, t in shapes_and_types]
    return graph.trace_cost(fn, *args, mode=mode)


def test_byte_rules_linear():
    """A Linear with bias: one addmm, 2 M K N FLOPs at the f32 peak; x,
    the weight, the bias and the output once (the weight's transpose is a
    view)."""
    f32 = torch.float32
    c = _cost_of(lambda x, w, b: torch.nn.functional.linear(x, w, b),
                 ((4, 8), f32), ((16, 8), f32), ((16,), f32))
    assert c["flops"] == 2 * 4 * 8 * 16 and c["flops_f32"] == c["flops"]
    assert c["bytes"] == (4 * 8 + 16 * 8 + 16 + 4 * 16) * 4
    assert c["t_compute_s"] == c["flops"] / hw.F32_FLOPS_S
    assert c["peak_bytes"] == (4 * 8 + 16 * 8 + 16 + 4 * 16) * 4


def test_byte_rules_views():
    """A chain of views costs nothing; the sum after it reads the
    expanded tensor's distinct elements once and writes its output."""
    def fn(x):
        y = x.view(6, 4).permute(1, 0)[1:3].unsqueeze(0).expand(5, 2, 6)
        z = y.transpose(1, 2)
        return z.sum()
    c = _cost_of(fn, ((24,), torch.bfloat16))
    assert list(c["ops"]) == ["aten.sum"]
    assert c["bytes"] == 2 * 6 * 2 + 2
    assert c["flops"] == 0


def test_byte_rules_window_writes():
    """An in-place write into a window bills twice the window (copy_
    into a slice; index_put_ with its indices); a gather twice its
    output plus its indices, not its table."""
    f32, i64 = torch.float32, torch.int64

    def write(buf, src, idx, vals):
        buf[10:20] = src
        buf.index_put_((idx,), vals)
        return buf
    c = _cost_of(write, ((100, 8), f32), ((10, 8), f32), ((5,), i64),
                 ((5, 8), f32))
    assert c["ops"]["aten.copy_"]["bytes"] == 2 * 10 * 8 * 4
    assert c["ops"]["aten.index_put_"]["bytes"] == 2 * 5 * 8 * 4 + 5 * 8
    assert c["bytes"] == 2 * 10 * 8 * 4 + 2 * 5 * 8 * 4 + 5 * 8
    g = _cost_of(lambda t, i: t[i], ((1000, 8), f32), ((4,), i64))
    assert g["bytes"] == 2 * 4 * 8 * 4 + 4 * 8


def test_peak_counts_live_storages():
    """The peak: the args, then each storage from the op that makes it to
    its last tensor's end."""
    def fn(x):
        a = x * 2            # 4 KB
        b = a + 1            # 4 KB, a still alive
        del a
        return b.sum()
    c = _cost_of(fn, ((1024,), torch.float32))
    assert c["peak_bytes"] == 3 * 4096


def test_wrappers_raise_outside_a_trace():
    """The trace route computes nothing: a wrapper fed a meta tensor with
    no trace active raises."""
    m = dict(device="meta")
    bf = torch.bfloat16
    q = torch.empty(1, 64, 4, 64, dtype=bf, **m)
    kv = torch.empty(1, 64, 2, 64, dtype=bf, **m)
    with pytest.raises(RuntimeError, match="outside a dry-run trace"):
        ops.flash_prefill(q, kv, kv)
    qd = torch.empty(1, 4, 64, dtype=bf, **m)
    with pytest.raises(RuntimeError, match="outside a dry-run trace"):
        ops.decode_attention(qd, kv, kv, 64)
    k8 = torch.empty(1, 64, 2, 64, dtype=torch.int8, **m)
    ks = torch.empty(1, 64, 2, **m)
    with pytest.raises(RuntimeError, match="outside a dry-run trace"):
        ops.decode_attention_q8(qd, k8, ks, k8, ks, 64)
    with pytest.raises(RuntimeError, match="outside a dry-run trace"):
        ops.ecoscan(torch.empty(2, 16, **m), torch.empty(4, 8, 16, **m),
                    torch.empty(4, dtype=torch.int32, **m),
                    torch.empty(2, 3, dtype=torch.int32, **m), 2)
    with pytest.raises(ValueError, match="int32 slot ids"):
        ops.ecoscan(torch.empty(2, 16, **m),
                    torch.empty(2 ** 21, 2 ** 10, 16, **m),
                    torch.empty(2 ** 21, dtype=torch.int32, **m),
                    torch.empty(2, 3, dtype=torch.int32, **m), 2)


def _digits(ms, places):
    return f"{ms:.{places}f}"


def test_perf_bounds_recomputed():
    """Five bounds of PERF.md section 6, from their shapes, to their
    printed digits."""
    m = dict(device="meta")
    bf, f32 = torch.bfloat16, torch.float32
    # h2o wave flash_prefill: 10,487,808 pairs a head, ops-bound in bf16
    q = torch.empty(1, 4608, 32, 80, dtype=bf, **m)
    kv = torch.empty(1, 4608, 8, 80, dtype=bf, **m)
    assert cost.unmasked_pairs(4608, 0, 4608, 4096, True) == 10_487_808
    ms, by = cost.flash_prefill(q, kv, kv, window=4096).bound_ms()
    assert (_digits(ms, 3), by) == ("0.109", "operations")
    # qwen wave decode_attention: 16 rows of kv_len 136 over 280 slots
    qd = torch.empty(16, 14, 64, dtype=bf, **m)
    kd = torch.empty(16, 280, 2, 64, dtype=bf, **m)
    lens = torch.full((16,), 136, dtype=torch.int32)
    ms, by = cost.decode_attention(qd, kd, kd, lens).bound_ms()
    assert (_digits(ms, 6), by) == ("0.000350", "bytes")
    # scr_score at a legacy query
    ms, by = cost.scr_score(torch.empty(1, 30, 384, **m),
                            torch.empty(1, 384, **m)).bound_ms()
    assert (_digits(ms, 7), by) == ("0.0000142", "bytes")
    # pq_adc at the flat shape
    ms, by = cost.pq_adc(torch.empty(16, 8, 256, dtype=f32, **m),
                         torch.empty(100_000, 8, dtype=torch.uint8,
                                     **m)).bound_ms()
    assert (_digits(ms, 5), by) == ("0.00219", "bytes")
    # kmeans_assign at the EcoVector build
    ms, by = cost.kmeans_assign(torch.empty(16384, 384, **m),
                                torch.empty(256, 384, **m)).bound_ms()
    assert (_digits(ms, 4), by) == ("0.0483", "operations")


def test_every_kernel_has_a_cost():
    assert all(callable(getattr(cost, n, None)) for n in ops.KERNELS)


def test_link_rates_follow_the_nodes():
    """NVLink within an 8-GPU node, the NIC across nodes: the 16 x 16
    mesh's "model" group (16 consecutive ranks) spans two nodes."""
    assert hw.link_bytes_s(range(8)) == hw.NVLINK_BYTES_S
    assert hw.link_bytes_s(range(16)) == hw.NIC_BYTES_S
