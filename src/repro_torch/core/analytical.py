"""The paper's analytical models (§3.4): memory (Table 1), search latency
(Table 2: CPU + disk I/O), and energy (§3.4.3); a copy of
`repro.core.analytical` (plain Python). These are the paper's phone
model, not measurements of any machine.

Constants follow the paper's setting: 500 CPU cycles per 128-d distance at
2.4 GHz; UFS 4.0 disk (T_seek 0.025 ms, T_cmd 0.015 ms, 3.6e-7 ms/B);
I_cpu 2300 uA, I_disk 800 uA at V = 3.8 V.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareModel:
    cpu_cycles_per_dist_128d: float = 500.0
    cpu_hz: float = 2.4e9
    t_seek_ms: float = 0.025
    t_cmd_ms: float = 0.015
    t_transfer_ms_per_byte: float = 3.6e-7
    i_cpu_ua: float = 2300.0
    i_disk_ua: float = 800.0
    volt: float = 3.8

    def t_op_ms(self, dim: int) -> float:
        cycles = self.cpu_cycles_per_dist_128d * dim / 128.0
        return cycles / self.cpu_hz * 1e3


HW = HardwareModel()
P0 = None  # computed from M per call


def _p0(M: int) -> float:
    return 1.0 / math.log(max(M, 2))


# ------------------------------------------------------------- Table 1


def memory_bytes(alg: str, *, N: int, d: int, Nc: int = 64, M: int = 16,
                 M_pq: int = 8, nbits: int = 8, M_cent: int = 16) -> float:
    p0 = _p0(M)
    p0c = _p0(M_cent)
    if alg == "IVF":
        return Nc * 4 * d + 8 * N + N * 4 * d
    if alg == "IVFPQ":
        return Nc * 4 * d + 8 * N + N * (M_pq * nbits / 8) + 2 ** nbits * 4 * d
    if alg == "HNSW":
        return N * 4 * d + 4 * N * M / (1 - p0)
    if alg == "HNSWPQ":
        return (N * (M_pq * nbits / 8) + 4 * N * M / (1 - p0)
                + 2 ** nbits * 4 * d)
    if alg == "IVF-DISK":
        return Nc * 4 * d + 8 * N + 4 * d * (N / Nc)
    if alg == "IVFPQ-DISK":
        return (Nc * 4 * d + 8 * N + (N / Nc) * M_pq * nbits / 8
                + 2 ** nbits * 4 * d)
    if alg == "IVF-HNSW":
        return 4 * Nc * (d + M_cent / (1 - p0c)) + 8 * N + 4 * d * (N / Nc)
    if alg == "EcoVector":
        return (4 * Nc * (d + M_cent / (1 - p0c)) + 8 * N
                + (N / Nc) * 4 * (d + M / (1 - p0)))
    raise ValueError(alg)


# ------------------------------------------------------------- Table 2


def n_search_ops(alg: str, *, N: int, Nc: int = 64, n_probe: int = 4,
                 M: int = 16, M_pq: int = 8, nbits: int = 8, d: int = 128,
                 ef_h: int = 64, ef_c: int = 16, ef_l: int = 16,
                 M_cent: int = 16) -> float:
    """Equivalent 128-d-unit distance computations per query (Table 2)."""
    if alg == "IVF" or alg == "IVF-DISK":
        return Nc + n_probe * N / Nc
    if alg == "IVFPQ" or alg == "IVFPQ-DISK":
        return (Nc + n_probe * (N / Nc) * (M_pq / d) * (nbits / 8)
                + 2 ** nbits)
    if alg == "HNSW":
        return ef_h * M
    if alg == "HNSWPQ":
        return ef_h * M * (M_pq / d) * (nbits / 8) + 2 ** nbits
    if alg == "IVF-HNSW":
        return ef_c * M_cent + n_probe * N / Nc
    if alg == "EcoVector":
        return ef_c * M_cent + n_probe * ef_l * M
    raise ValueError(alg)


def disk_bytes_per_probe(alg: str, *, N: int, d: int, Nc: int, M: int = 16,
                         M_pq: int = 8, nbits: int = 8) -> float:
    avg = N / Nc
    if alg in ("IVF-DISK", "IVF-HNSW"):
        return avg * 4 * d
    if alg == "IVFPQ-DISK":
        return avg * M_pq * nbits / 8
    if alg == "EcoVector":
        p0 = _p0(M)
        return avg * 4 * (d + M / (1 - p0))
    return 0.0


def search_latency_ms(alg: str, *, N: int, d: int, Nc: int = 64,
                      n_probe: int = 4, hw: HardwareModel = HW,
                      **kw) -> dict:
    """T_search = t_s + t_d (§3.4.2). Returns both parts + total (ms)."""
    ops_ = n_search_ops(alg, N=N, Nc=Nc, n_probe=n_probe, d=d, **kw)
    t_s = ops_ * hw.t_op_ms(d)
    dbytes = disk_bytes_per_probe(alg, N=N, d=d, Nc=Nc,
                                  M=kw.get("M", 16),
                                  M_pq=kw.get("M_pq", 8),
                                  nbits=kw.get("nbits", 8))
    n_seek = n_probe if dbytes else 0
    t_d = n_seek * (hw.t_seek_ms + hw.t_cmd_ms
                    + dbytes * hw.t_transfer_ms_per_byte)
    return {"t_s_ms": t_s, "t_d_ms": t_d, "total_ms": t_s + t_d}


# ------------------------------------------------------------- §3.4.3


def energy_mj(t_s_ms: float, t_d_ms: float, hw: HardwareModel = HW) -> float:
    """E = V * (I_cpu * t_s + I_disk * t_d), in millijoules."""
    return hw.volt * (hw.i_cpu_ua * 1e-6 * t_s_ms
                      + hw.i_disk_ua * 1e-6 * t_d_ms)


def search_energy_mj(alg: str, **kw) -> float:
    lat = search_latency_ms(alg, **kw)
    return energy_mj(lat["t_s_ms"], lat["t_d_ms"])
