"""Deterministic crash and corruption injection for the storage layer,
the port of `repro.core.store_faults`.

Faults are indexed by the filesystem-op counter that `store._fs_event`
advances, never by wall clock, so the same plan crashes at the same
byte boundary on any host, and at the same op as the reference's (the
two stores count the same events).

  * `CrashPlan(at=k)`: in-process, the k-th fs op raises
    `InjectedCrash`; the caller drops the live object and reloads from
    disk, which exercises the on-disk states a kill -9 between two
    syscalls can leave.
  * ``REPRO_STORE_CRASH_AT=<k>``: the k-th fs op calls `os._exit`, no
    flush, no atexit. The kill -9 tests spawn the workload below with it:
    ``python -m repro_torch.core.store_faults --root DIR --stage wal
    [--device cpu]`` (the workload's EcoVector build runs
    `kmeans_assign` on `--device`, default cuda).

`flip_byte` / `truncate_file` mutate a committed file in place, the
models of bit-rot and torn flash pages.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from repro_torch.core import store


class InjectedCrash(RuntimeError):
    """Raised by in-process crash plans, so tests tell scripted crashes
    from real bugs."""


class CrashPlan:
    """Context manager: crash at the `at`-th filesystem op (1-based)
    counted from entry. `fired` records whether the plan triggered."""

    def __init__(self, at: int, exit_code: Optional[int] = None):
        self.at = at
        self.exit_code = exit_code
        self.fired = False

    def _hook(self, name: str, count: int) -> None:
        if count == self.at:
            self.fired = True
            if self.exit_code is not None:
                os._exit(self.exit_code)
            raise InjectedCrash(f"injected crash at fs op {count} ({name})")

    def __enter__(self) -> "CrashPlan":
        store.reset_fs_ops()
        store.set_crash_hook(self._hook)
        return self

    def __exit__(self, *exc) -> None:
        store.set_crash_hook(None)


def count_fs_ops(fn: Callable[[], None]) -> int:
    """Run `fn` with no crash hook; return how many fs ops it performed
    (the bound of a CrashPlan sweep)."""
    store.reset_fs_ops()
    store.set_crash_hook(None)
    try:
        fn()
    finally:
        n = store.fs_ops()
    return n


def flip_byte(path: str, offset: int, xor: int = 0xFF) -> None:
    """XOR one byte in place (bit-rot). The offset wraps into the file."""
    size = os.path.getsize(path)
    if size == 0:
        return
    offset = int(offset) % size
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ (xor & 0xFF)]))


def truncate_file(path: str, keep_bytes: int) -> None:
    """Truncate to `keep_bytes` (a torn page or partial write)."""
    with open(path, "r+b") as f:
        f.truncate(max(0, int(keep_bytes)))


# --------------------------------------------- subprocess kill -9 workload

def _crash_workload(root: str, stage: str, seed: int = 0, n: int = 96,
                    dim: int = 16, wal_ops: int = 12,
                    device: str = "cuda") -> None:
    """The reference's deterministic EcoVector workload for the kill -9
    harness. Stages (each includes the earlier ones' effects):
      build_save : build + first generation save
      wal        : + `wal_ops` journaled inserts and deletes, each
                   acknowledged into ``<root>/acked.txt`` after the op
                   returns (the parent's ground truth)
      compact    : + a second save() folding the WAL into gen 1
    The ack file is appended with raw os calls + fsync, outside the
    counted fs ops."""
    from repro_torch.core.ecovector import EcoVector

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, dim)).astype(np.float32)
    ev = EcoVector(dim, n_clusters=8, M=8, ef_construction=32,
                   storage_dir=os.path.join(root, "live"), seed=seed,
                   device=device)
    ev.build(X)
    ev.save(os.path.join(root, "journal"))
    if stage == "build_save":
        return
    ack_fd = os.open(os.path.join(root, "acked.txt"),
                     os.O_WRONLY | os.O_CREAT | os.O_APPEND)

    def ack(line: str) -> None:
        os.write(ack_fd, (line + "\n").encode())
        os.fsync(ack_fd)

    base = 10 ** 6
    for i in range(wal_ops):
        if i % 3 == 2:
            vid = base + i - 1
            ev.delete(vid)
            ack(f"delete {vid}")
        else:
            vec = rng.normal(size=(dim,)).astype(np.float32)
            ev.insert(base + i, vec)
            ack(f"insert {base + i}")
    if stage == "wal":
        return
    ev.save()
    ack("compacted")


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--stage", default="wal",
                   choices=["build_save", "wal", "compact"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--wal-ops", type=int, default=12)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    # REPRO_STORE_CRASH_AT in the environment arms the hard-exit hook when
    # the store is imported; an uninjected run completes and exits 0
    _crash_workload(args.root, args.stage, seed=args.seed,
                    wal_ops=args.wal_ops, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
