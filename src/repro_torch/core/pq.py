"""Product quantisation: codebook training, encoding, ADC tables (the
port of `repro.core.pq`).

Used by the IVFPQ / IVFPQ-DISK baselines. Training runs the port's
k-means (its assignment step on the `kmeans_assign` kernel); ADC scoring
runs the `pq_adc` kernel, a gather from the query's table in shared
memory summed in numpy's order, where the reference sums a numpy
gather. Encoding, decoding and the tables stay numpy, as in the
reference. A scoring call over segments of a device pack stages the
table and the segments in one pinned host buffer and copies them to the
device in one copy; the scores come back with `.cpu()`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.kmeans import kmeans
from repro_torch.kernels import ops

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.uint8): torch.uint8}


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
        self._host = self._dev = None       # staging of the scoring inputs
        self._views = {}                    # layout -> its staged views

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

    def _stage(self, *arrays):
        """Copy numpy arrays to the PQ's device in one copy, through one
        host buffer (pinned on a GPU; reused, since each scoring call
        waits for its scores), each at a 16-byte aligned offset. Returns
        the device tensors, in the arrays' dtypes and shapes; the views
        of a layout (one a probe width) are made once."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        key = tuple((a.dtype, a.shape) for a in arrays)
        views = self._views.get(key)
        if views is None:
            at = np.cumsum([0] + [-(-a.nbytes // 16) * 16 for a in arrays])
            if self._host is None or self._host.numel() < at[-1]:
                cuda = self.device.type == "cuda"
                self._host = torch.empty(max(int(at[-1]), 1 << 16),
                                         dtype=torch.uint8, pin_memory=cuda)
                self._dev = (torch.empty_like(self._host, device=self.device)
                             if cuda else self._host)
                self._views = {}
            views = (self._host[:at[-1]], self._dev[:at[-1]],
                     [(o, o + a.nbytes) for a, o in zip(arrays, at)],
                     [self._dev[o:o + a.nbytes].view(_TORCH_DTYPE[a.dtype])
                      .view(a.shape) for a, o in zip(arrays, at)])
            self._views[key] = views
        host, dev, spans, out = views
        h = host.numpy()
        for a, (lo, hi) in zip(arrays, spans):
            h[lo:hi] = a.reshape(-1).view(np.uint8)
        if dev is not host:
            dev.copy_(host, non_blocking=True)
        return out

    def adc_lookup(self, tabs: np.ndarray, codes: np.ndarray) -> np.ndarray:
        """sum_m tabs[m, codes[n, m]] for codes [N, m] uint8: one `pq_adc`
        launch on the PQ's device. Returns [N] f32 as numpy."""
        lut = torch.tensor(np.asarray(tabs, np.float32)[None],
                           device=self.device)
        c = torch.tensor(np.ascontiguousarray(codes, np.uint8),
                         device=self.device)
        return ops.pq_adc(lut, c)[0].cpu().numpy()

    def adc_segments(self, tabs: np.ndarray, pack: torch.Tensor,
                     starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """The scores of the pack rows starts[s] .. starts[s] + lens[s] - 1
        of every segment s, in segment order: [sum(lens)] f32 as numpy.
        pack [N, m] uint8 lives on the PQ's device; the table and the
        segments travel in one copy, and one `pq_adc` launch scores
        them all."""
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        lut, st, off = self._stage(np.asarray(tabs, np.float32)[None],
                                   np.asarray(starts, np.int32), offsets)
        return ops.pq_adc(lut, pack, st, off,
                          rows=int(offsets[-1]))[0].cpu().numpy()

    def adc_scores(self, q: np.ndarray, codes: np.ndarray) -> np.ndarray:
        return self.adc_lookup(self.adc_table(q), codes)

    def memory_bytes(self, n: int) -> int:
        return n * self.m * self.nbits // 8 + self.ksub * self.dim * 4
