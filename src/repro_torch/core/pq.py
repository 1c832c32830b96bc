"""Product quantisation: codebook training, encoding, ADC tables (the
port of `repro.core.pq`).

Used by the IVFPQ / IVFPQ-DISK baselines. Training runs the port's
k-means (its assignment step on the `kmeans_assign` kernel); ADC scoring
runs the `pq_adc` kernel, a gather from the query's table in shared
memory, where the reference sums a numpy gather. Encoding, decoding and
the tables stay numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.kmeans import kmeans
from repro_torch.kernels import ops


class PQ:
    def __init__(self, dim: int, m: int = 8, nbits: int = 8, device="cuda"):
        assert dim % m == 0, "dim must divide into m sub-vectors"
        self.dim = dim
        self.m = m
        self.nbits = nbits
        self.ksub = 2 ** nbits
        self.dsub = dim // m
        self.device = resolve_device(device)
        self.codebooks = np.zeros((m, self.ksub, self.dsub), np.float32)

    def train(self, x: np.ndarray, iters: int = 8, seed: int = 0):
        x = np.asarray(x, np.float32)
        for j in range(self.m):
            sub = x[:, j * self.dsub:(j + 1) * self.dsub]
            cent, _ = kmeans(sub, min(self.ksub, sub.shape[0]), iters,
                             seed + j, device=self.device)
            self.codebooks[j, : cent.shape[0]] = cent
        return self

    def encode(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        codes = np.zeros((x.shape[0], self.m), np.uint8)
        for j in range(self.m):
            sub = x[:, j * self.dsub:(j + 1) * self.dsub]
            d = (np.sum(sub ** 2, 1)[:, None]
                 - 2 * sub @ self.codebooks[j].T
                 + np.sum(self.codebooks[j] ** 2, 1)[None, :])
            codes[:, j] = np.argmin(d, axis=1)
        return codes

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = np.zeros((codes.shape[0], self.dim), np.float32)
        for j in range(self.m):
            out[:, j * self.dsub:(j + 1) * self.dsub] = \
                self.codebooks[j][codes[:, j].astype(np.int64)]
        return out

    def adc_table(self, q: np.ndarray) -> np.ndarray:
        """Distance LUT [m, ksub] for one query (squared L2 per subspace)."""
        tabs = np.zeros((self.m, self.ksub), np.float32)
        for j in range(self.m):
            sub = q[j * self.dsub:(j + 1) * self.dsub]
            diff = self.codebooks[j] - sub
            tabs[j] = np.einsum("kd,kd->k", diff, diff)
        return tabs

    def adc_lookup(self, tabs: np.ndarray, codes: np.ndarray) -> np.ndarray:
        """sum_m tabs[m, codes[n, m]] for codes [N, m] uint8: one `pq_adc`
        launch on the PQ's device. Returns [N] f32 as numpy."""
        lut = torch.tensor(np.asarray(tabs, np.float32)[None],
                           device=self.device)
        c = torch.tensor(np.ascontiguousarray(codes, np.uint8),
                         device=self.device)
        return ops.pq_adc(lut, c)[0].cpu().numpy()

    def adc_scores(self, q: np.ndarray, codes: np.ndarray) -> np.ndarray:
        return self.adc_lookup(self.adc_table(q), codes)

    def memory_bytes(self, n: int) -> int:
        return n * self.m * self.nbits // 8 + self.ksub * self.dim * 4
