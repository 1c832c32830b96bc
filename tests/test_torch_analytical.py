"""The port's copy of the paper's §3.4 model (`core/analytical.py`)
against the JAX package's: every function, for every algorithm, at the
paper's defaults and at other settings, gives the same numbers; unknown
algorithms raise ValueError in both."""
import pytest

from repro.core import analytical as J
from repro_torch.core import analytical as A

ALGS = ["IVF", "IVFPQ", "HNSW", "HNSWPQ", "IVF-DISK", "IVFPQ-DISK",
        "IVF-HNSW", "EcoVector"]
SETTINGS = [dict(N=1_000_000, d=128),
            dict(N=290_000, d=256, Nc=1024, M=32, M_pq=16, nbits=4,
                 M_cent=8)]


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("setting", range(len(SETTINGS)))
def test_memory_and_ops_equal(alg, setting):
    kw = SETTINGS[setting]
    assert A.memory_bytes(alg, **kw) == J.memory_bytes(alg, **kw)
    ops_kw = {k: v for k, v in kw.items() if k != "d"}
    for n_probe in (1, 4, 16):
        assert A.n_search_ops(alg, n_probe=n_probe, d=kw["d"], **ops_kw) == \
            J.n_search_ops(alg, n_probe=n_probe, d=kw["d"], **ops_kw)
    disk_kw = {k: kw[k] for k in ("N", "d")}
    disk_kw["Nc"] = kw.get("Nc", 64)
    assert A.disk_bytes_per_probe(alg, **disk_kw) == \
        J.disk_bytes_per_probe(alg, **disk_kw)


@pytest.mark.parametrize("alg", ALGS)
def test_latency_and_energy_equal(alg):
    for kw in (dict(N=1_000_000, d=128), dict(N=50_000, d=384, Nc=256,
                                              n_probe=8, M=16)):
        lat = A.search_latency_ms(alg, **kw)
        assert lat == J.search_latency_ms(alg, **kw)
        assert lat["total_ms"] == lat["t_s_ms"] + lat["t_d_ms"]
        assert A.search_energy_mj(alg, **kw) == J.search_energy_mj(alg, **kw)


def test_hardware_model_and_helpers_equal():
    assert A.HW == A.HardwareModel() and A.HW.__dict__ == J.HW.__dict__
    for d in (64, 128, 384):
        assert A.HW.t_op_ms(d) == J.HW.t_op_ms(d)
    for M in (1, 2, 12, 16, 32):
        assert A._p0(M) == J._p0(M)
    for t_s, t_d in ((0.0, 0.0), (1.5, 0.2), (12.0, 3.0)):
        assert A.energy_mj(t_s, t_d) == J.energy_mj(t_s, t_d)
    hw = A.HardwareModel(cpu_hz=3.0e9, volt=4.0)
    jhw = J.HardwareModel(cpu_hz=3.0e9, volt=4.0)
    assert A.energy_mj(2.0, 1.0, hw) == J.energy_mj(2.0, 1.0, jhw)
    assert A.search_latency_ms("EcoVector", N=10_000, d=128, hw=hw) == \
        J.search_latency_ms("EcoVector", N=10_000, d=128, hw=jhw)


@pytest.mark.parametrize("fn", ["memory_bytes", "n_search_ops"])
def test_unknown_algorithm_raises(fn):
    kw = dict(N=1000, d=16) if fn == "memory_bytes" else dict(N=1000)
    for mod in (A, J):
        with pytest.raises(ValueError):
            getattr(mod, fn)("FLAT", **kw)
