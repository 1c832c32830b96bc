"""Crash-safety soak of the durable store (the port of
`tools/soak_store.py`; the same sweeps, invariants, output lines and
exit codes, plus `--device` for the EcoVector builds' `kmeans_assign`).

Three sweeps, all deterministic (faults keyed on the index of the
filesystem op, never on wall clock):

  1. Crash sweep: an in-process `CrashPlan` kills the EcoVector save /
     WAL-append / compaction workload at every fs op in turn (every
     third with `--quick`); after each crash the journal must reload to
     a complete index (or report no committed generation) with every
     acknowledged mutation present.
  2. Kill -9 sweep: the same workload in a subprocess
     (`python -m repro_torch.core.store_faults`) with
     `REPRO_STORE_CRASH_AT` arming a hard `os._exit` at a sample of op
     indices: no atexit, no flush, a power cut.
  3. Fuzz sweep: byte flips and truncations at seeded offsets in live
     spill files; every mutation must be detected by the scrubber and
     tolerated by search (quarantine and degrade, never garbage results
     or a crash), and the committed generation stays whole.

Exit 0 = all invariants held. A violation prints the failing sweep point
and exits 1.

Usage: python -m repro_torch.launch.soak_store [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import warnings
from typing import Iterable, List, Optional

import numpy as np

import repro_torch
from repro_torch.core import store, store_faults
from repro_torch.core.ecovector import EcoVector

# crash-sweep ops: every fourth deletes the id inserted just before
_N_OPS = 8
_OPS = [("delete", 10 ** 6 + i - 1) if i % 4 == 3 else
        ("insert", 10 ** 6 + i) for i in range(_N_OPS)]


def _fail(msg: str) -> None:
    print(f"SOAK FAIL: {msg}")
    sys.exit(1)


def _workload(root: str, acked: list, device: str,
              stop: Optional[str] = None) -> None:
    """Build + save, the journaled ops, the compaction. `acked` grows as
    each op returns, so after a crash it holds exactly the acknowledged
    prefix, the ground truth of the recovery. `stop` ("save" or "wal")
    ends the workload after that stage."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(160, 12)).astype(np.float32)
    vecs = rng.normal(size=(_N_OPS, 12)).astype(np.float32)
    ev = EcoVector(12, n_clusters=6, M=8, ef_construction=32,
                   device=device).build(X)
    ev.save(root)
    if stop == "save":
        return
    for (op, vid), v in zip(_OPS, vecs):
        if op == "delete":
            ev.delete(vid)
        else:
            ev.insert(vid, v)
        acked.append((op, vid))
    if stop == "wal":
        return
    ev.save()
    acked.append(("compacted", -1))


def _count_ops(device: str, stop: Optional[str] = None) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        return store_faults.count_fs_ops(
            lambda: _workload(os.path.join(tmp, "probe"), [], device, stop))


def stage_points(device: str) -> List[int]:
    """One crash point in each stage of the workload: the first save,
    the journaled ops, the compaction (the middle op of each)."""
    n_save = _count_ops(device, "save")
    n_wal = _count_ops(device, "wal")
    total = _count_ops(device)
    return [max(1, n_save // 2), (n_save + n_wal) // 2 + 1,
            (n_wal + total) // 2 + 1]


def crash_sweep(step: int, device: str = "cuda",
                points: Optional[Iterable[int]] = None) -> int:
    """Crash at every `step`-th fs op of the workload (or at `points`)
    and verify each recovery; returns the points checked."""
    if points is None:
        points = range(1, _count_ops(device) + 1, step)
    checked = 0
    for at in points:
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "j")
            acked: list = []
            with store_faults.CrashPlan(at):
                try:
                    _workload(root, acked, device)
                except store_faults.InjectedCrash:
                    pass
            # exempt the one in-flight op (durable but unacked is allowed)
            n_mut = len([a for a in acked if a[0] != "compacted"])
            inflight = _OPS[n_mut][1] if n_mut < len(_OPS) else None
            _verify(root, [a for a in acked if a[1] != inflight], at, device)
            checked += 1
    return checked


def _verify(root: str, acked: list, at: int, device: str,
            dim: int = 12) -> None:
    """Post-crash invariants: loadable (or nothing committed and nothing
    acknowledged), no acknowledged write lost, search still answers."""
    try:
        ev = EcoVector.load(root, device=device)
    except FileNotFoundError:
        if acked:
            _fail(f"at={at}: journal empty but ops were acknowledged: "
                  f"{acked}")
        return
    expect = {vid: op == "insert" for op, vid in acked if op != "compacted"}
    for vid, present in expect.items():
        if (vid in ev.assign) != present:
            _fail(f"at={at}: acknowledged {'insert' if present else 'delete'}"
                  f" of {vid} lost after reload")
    rng = np.random.default_rng(1)
    for q in rng.normal(size=(4, dim)).astype(np.float32):
        ids, _ = ev.search(q, 5, n_probe=6)
        if len(ids) != 5:
            _fail(f"at={at}: degraded search returned {len(ids)}/5")


def kill9_sweep(points: Iterable[int], device: str = "cuda") -> int:
    """The store_faults workload (stage compact) in a subprocess killed
    by a hard exit at each of `points`; verify each recovery."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    ops = [("delete", 10 ** 6 + i - 1) if i % 3 == 2 else
           ("insert", 10 ** 6 + i) for i in range(12)]
    checked = 0
    for at in points:
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, REPRO_STORE_CRASH_AT=str(at),
                       PYTHONPATH=os.pathsep.join(
                           [src] + [p for p in os.environ.get(
                               "PYTHONPATH", "").split(os.pathsep) if p]))
            p = subprocess.run(
                [sys.executable, "-m", "repro_torch.core.store_faults",
                 "--root", tmp, "--stage", "compact", "--device", device],
                env=env, capture_output=True, text=True, timeout=300)
            if p.returncode not in (0, 42):
                _fail(f"kill9 at={at}: workload rc={p.returncode}\n"
                      f"{p.stdout}{p.stderr}")
            acked = []
            ack_path = os.path.join(tmp, "acked.txt")
            if os.path.exists(ack_path):
                with open(ack_path) as f:
                    for line in f.read().splitlines():
                        parts = line.split()
                        acked.append((parts[0], int(parts[1])
                                      if len(parts) > 1 else -1))
            # exempt the single in-flight (never acknowledged) op
            n_mut = len([a for a in acked if a[0] != "compacted"])
            inflight = ops[n_mut][1] if n_mut < len(ops) else None
            _verify(os.path.join(tmp, "journal"),
                    [a for a in acked if a[1] != inflight], at, device,
                    dim=16)
            checked += 1
    return checked


def fuzz_sweep(n_mutations: int, device: str = "cuda") -> int:
    """Rot one live spill file a trial (a byte flip or a truncation at a
    seeded offset): the scrubber must see it, search must still answer,
    the cluster must rebuild, the committed generation must be whole."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(160, 12)).astype(np.float32)
    Q = X[rng.choice(len(X), 8)]
    checked = 0
    for trial in range(n_mutations):
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "j")
            ev = EcoVector(12, n_clusters=6, M=8, ef_construction=32,
                           device=device).build(X)
            ev.device_pack()
            ev.save(root)
            victim = int(rng.integers(ev.n_clusters))
            path = ev._path(victim)
            if rng.integers(2):
                store_faults.flip_byte(path, int(rng.integers(1 << 20)))
            else:
                store_faults.truncate_file(
                    path, int(rng.integers(os.path.getsize(path))))
            if all(r["ok"] for r in store.scrub_path(
                    os.path.dirname(path))):
                _fail(f"fuzz trial {trial}: scrub missed the mutation "
                      f"in {path}")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for q in Q:
                    ids, _ = ev.search(q, 5, n_probe=6)
                    if len(ids) != 5:
                        _fail(f"fuzz trial {trial}: search returned "
                              f"{len(ids)}/5 after corruption")
            if ev.stats.corrupt_reads:
                ev.rebuild_cluster(victim)
                if ev.stats.quarantined:
                    _fail(f"fuzz trial {trial}: rebuild left quarantine")
            ev2 = EcoVector.load(root, device=device)
            for q in Q:
                if len(ev2.search(q, 5, n_probe=6)[0]) != 5:
                    _fail(f"fuzz trial {trial}: committed snapshot "
                          f"damaged by live-file mutation")
            checked += 1
    return checked


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="storage crash-safety soak")
    p.add_argument("--quick", action="store_true",
                   help="CI-sized sweeps (sampled crash points)")
    p.add_argument("--device", default="cuda",
                   help="device of the EcoVector builds (cuda or cpu)")
    args = p.parse_args(argv)
    step = 3 if args.quick else 1
    kill_points = ((10, 30, 52, 95) if args.quick
                   else tuple(range(5, 101, 5)))
    fuzz_trials = 6 if args.quick else 24

    n = crash_sweep(step, args.device)
    print(f"crash sweep: {n} injection points ok")
    n = kill9_sweep(kill_points, args.device)
    print(f"kill -9 sweep: {n} subprocess crashes recovered")
    n = fuzz_sweep(fuzz_trials, args.device)
    print(f"fuzz sweep: {n} corruption trials detected + tolerated")
    print("storage soak: all invariants held")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
