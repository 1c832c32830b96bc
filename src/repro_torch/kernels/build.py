"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, loaded with `ctypes`. All
sources build at the first use of any kernel, one `nvcc` process per
source, all started together. Libraries land in `build/repro_torch_kernels/`
at the repository root, named by a hash of their sources (the `.cu` and
every shared `.cuh` header) and flags, so a changed source rebuilds and
an unchanged one is reused. nvcc's output,
with `-Xptxas -v` register and shared-memory use, is kept beside each
library as `<kernel>.log`. Every C entry point is looked up once, when
its library loads, into `ENTRY` (name -> ctypes function), so a launch
costs one dict lookup and the ctypes call.

Every failure here (no nvcc, a failed compile, a library that does not
load) raises `KernelError`: a kernel fault, which the serving ladders
never absorb (`ops.is_kernel_fault`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of each library: name -> argument types (return: int,
# the cudaError_t of the launch)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "kmeans_assign": {
        "kmeans_assign": [_P, _P, _I, _I, _I, _P, _P, _P]},
    "ecoscan": {
        "ecoscan": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P, _P],
        "ecoscan_tile": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P]},
    "scr_select": {
        "scr_select": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]},
    "decode_attention_paged": {
        "decode_attention_paged_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _I, _P, _P, _P],
        "decode_attention_paged_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _I, _P, _P, _P],
        "decode_attention_paged_q8_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                          _I, _I, _I, _I, _I, _P, _P, _P],
        "decode_attention_paged_q8_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                           _I, _I, _I, _I, _I, _P, _P, _P]},
    "decode_attention": {
        "decode_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                 _I, _I, _P, _P, _P],
        "decode_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                  _I, _I, _P, _P, _P],
        "decode_attention_q8_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _F, _I, _I, _P, _P, _P],
        "decode_attention_q8_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _I, _F, _I, _I, _P, _P, _P]},
    "flash_prefill": {
        "flash_prefill_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _F, _P, _P],
        "flash_prefill_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _F, _P, _P]},
    "scr_score": {
        "scr_score": [_P, _P, _I, _I, _I, _P, _P]},
    "pq_adc": {
        "pq_adc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
        "pq_adc_forced": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P]},
}


class KernelError(RuntimeError):
    """A kernel fault: a kernel that does not build, load or launch.
    Serving's fallbacks re-raise it instead of degrading around it
    (`ops.is_kernel_fault`)."""


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
ENTRY: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels build only on a "
                          "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel library not yet built (in parallel) and load
    all of them. Returns the seconds spent compiling (0 when cached)."""
    with _lock:
        if len(_libs) == len(SIGNATURES):
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {n: _target(n) for n in SIGNATURES if not _target(n).exists()}
        t0 = time.perf_counter()
        if todo:
            nvcc = _nvcc()
            procs = {}
            for name, out in todo.items():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                procs[name] = (subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, out)
            failed = []
            for name, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                (BUILD_DIR / f"{name}.log").write_text(log)
                if proc.returncode != 0:
                    failed.append(f"{name}:\n{log}")
                else:
                    os.replace(tmp, out)
            if failed:
                raise KernelError("nvcc failed for " + "\n".join(failed))
        seconds = time.perf_counter() - t0
        for name, fns in SIGNATURES.items():
            if name in _libs:
                continue
            try:
                lib = ctypes.CDLL(str(_target(name)))
            except OSError as e:
                raise KernelError(f"{name}: library did not load: {e}") from e
            for fn, argtypes in fns.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                ENTRY[fn] = f
            _libs[name] = lib
        return seconds


def entry(fn: str):
    """The ctypes function of C entry point `fn` (builds everything on
    first use)."""
    f = ENTRY.get(fn)
    if f is None:
        build_all()
        f = ENTRY[fn]
    return f
