"""The port's EcoVector and WindowIndex durability against the JAX
package's on the CPU (the reference's fixture: DIM 16, 320 vectors in 8
blobs, 8 clusters, M 8, efc 32, seed 7).

The port loads a generation the reference committed, with its WAL, and
gives the reference's `load`: the same assignments, host-search ids and
distances (exact), and device-search ids (exact) with distances within
8 f32 ulps of the largest squared norm (`dist_atol`: the plain ecoscan's
||x||^2 - 2 x.q + ||q||^2 rounds in each package's own sum order, and
this fixture's norms reach ~17, where tests/test_torch_retrieval.py's
2e-5 holds at norms ~1); it does so with `jax` and `repro` blocked. After the same ops from that generation the two packages'
WAL files and array records are byte-equal and their pickled records
differ only by the class-path strings; they count the same fs ops. The
port's own round trips (save / load, WAL replay, churn with
compaction) are bit-identical, an in-process crash at every fs op of a
save or of a WAL burst loses no acknowledged op, and so does a real
`kill -9` of `python -m repro_torch.core.store_faults` mid-WAL,
mid-first-commit and mid-compaction. Corruption behaves as the
reference's (quarantine, degraded search, rebuild, save refusing to
launder), and `MobileRAG(retrieval_state=)` restores without embedding
the corpus and rebuilds from a corrupt state with a warning."""
import os
import pickle
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest

from repro.core import store as jstore
from repro.core.ecovector import EcoVector as JEcoVector
from repro.core.scr import SCRConfig as JSCRConfig
from repro.core.window_index import WindowIndex as JWindowIndex
from repro.serving.embedder import HashEmbedder as JHashEmbedder
from repro_torch.core import store, store_faults
from repro_torch.core.ecovector import EcoVector
from repro_torch.core.window_index import WindowIndex
from repro_torch.serving.embedder import HashEmbedder

from test_torch_store import pickle_ops

DIM = 16
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
RENAME = [(a, b) for (a, _), (b, _) in store.CLASS_MAP.items()]
KW = dict(n_clusters=8, M=8, ef_construction=32)


@pytest.fixture(autouse=True)
def _clean_hooks():
    for s in (store, jstore):
        s.set_crash_hook(None)
        s.reset_fs_ops()
    yield
    for s in (store, jstore):
        s.set_crash_hook(None)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.normal(scale=4.0, size=(8, DIM))
    X = (centers.repeat(40, axis=0)
         + rng.normal(size=(320, DIM))).astype(np.float32)
    Q = X[rng.choice(len(X), 16)] + 0.05 * rng.normal(
        size=(16, DIM)).astype(np.float32)
    return X, Q.astype(np.float32)


def dist_atol(X, Q):
    """8 f32 ulps of the largest ||x||^2 + ||q||^2 of the data."""
    top = float((X.astype(np.float64) ** 2).sum(1).max()
                + (Q.astype(np.float64) ** 2).sum(1).max())
    return 8 * float(np.finfo(np.float32).eps) * top


def _ev(X, **kw):
    return EcoVector(DIM, device="cpu", **dict(KW, **kw)).build(X)


def _ops(rng, n=6, base=10 ** 6):
    """n journaled ops: inserts, and a delete of the second insert."""
    out = [("insert", base + i, rng.normal(size=DIM).astype(np.float32))
           for i in range(n - 1)]
    return out + [("delete", base + 1, None)]


def _apply(ev, ops):
    for op, vid, vec in ops:
        if op == "insert":
            ev.insert(vid, vec)
        else:
            ev.delete(vid)


def _same_search(a, b, Q, k=10, n_probe=8):
    for q in Q:
        ia, da = a.search(q, k, n_probe=n_probe)
        ib, db = b.search(q, k, n_probe=n_probe)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(da, db)


@pytest.fixture(scope="module")
def ref_root(data, tmp_path_factory):
    """A generation the reference committed (gen 0) and its WAL (6 ops)."""
    X, _ = data
    root = str(tmp_path_factory.mktemp("refgen") / "j")
    jev = JEcoVector(DIM, **KW).build(X)
    jev.save(root)
    _apply(jev, _ops(np.random.default_rng(4)))
    jev._journal.close()
    return root


def _copy(root, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(root, dst)
    return dst


# ------------------------------------------- the port reads the reference

def test_port_loads_reference_generation(tmp_path, data, ref_root):
    X, Q = data
    ev = EcoVector.load(_copy(ref_root, tmp_path, "p"), device="cpu")
    jev = JEcoVector.load(_copy(ref_root, tmp_path, "r"))
    assert ev.stats.wal_replayed == jev.stats.wal_replayed == 6
    assert ev.assign == jev.assign
    assert ev.cluster_members == jev.cluster_members
    np.testing.assert_array_equal(ev.centroids, jev.centroids)
    _same_search(ev, jev, Q)
    ids, d = ev.search_device_batched(Q, k=10, n_probe=4)
    jids, jd = jev.search_device_batched(Q, k=10, n_probe=4,
                                         use_pallas=False)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(d, np.asarray(jd), rtol=0,
                               atol=dist_atol(X, Q))


_BLOCKED = r"""
import json, sys, warnings
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {src!r})
from repro_torch.core.ecovector import EcoVector
from repro_torch.core.tiered import TieredEcoVector
from repro_torch.core.window_index import WindowIndex
from repro_torch.serving.embedder import HashEmbedder
import numpy as np
Q = np.load({q!r})
ev = EcoVector.load({eco!r}, device="cpu")
tv = TieredEcoVector.load({tier!r}, device="cpu")
wi = WindowIndex.load(HashEmbedder(dim=64).fit({docs!r}), {win!r},
                      device="cpu")
out = dict(assign=sorted(ev.assign.items()), replayed=ev.stats.wal_replayed,
           host=[ev.search(q, 10, n_probe=8)[0].tolist() for q in Q],
           tier=tv.search_device_batched(Q, k=10, n_probe=4)[0].tolist(),
           texts=wi.texts, replayed_wi=wi.stats.wal_replayed,
           embeds=wi.stats.embed_calls, lens=wi.pack()[1].tolist())
assert "jax" not in sys.modules or sys.modules["jax"] is None
print(json.dumps(out))
"""

WDOCS = [
    ("Volcanoes are studied by geologists. "
     "Their eruptions follow magma pressure. "
     "Monitoring stations track seismic activity."),
    ("The Tiramisu dessert originated in Italy. "
     "Recipe of the Tiramisu includes cheese and coffee. "
     "Many cafes now offer Tiramisu for pick-up."),
    "One single sentence about astronomy.",
    "",
    ("Quantum computers use qubits. "
     "Error correction is the central challenge."),
]


def test_port_reads_reference_with_jax_and_repro_blocked(tmp_path, data,
                                                         ref_root):
    """EcoVector.load, TieredEcoVector.load and WindowIndex.load on
    generations (and WALs) the reference committed, in a process where
    `jax` and `repro` cannot be imported: the reference's own loads'
    answers."""
    from repro.core.tiered import TieredEcoVector as JTiered
    X, Q = data
    np.save(tmp_path / "q.npy", Q)
    eco = _copy(ref_root, tmp_path, "eco")
    jt = JTiered(DIM, storage_dir=str(tmp_path / "jts"), **KW).build(X)
    jt.set_device_budget(int(0.5 * jt.all_resident_bytes()))
    jt.search_device_batched(Q, k=10, n_probe=4, use_pallas=False)
    tier = str(tmp_path / "tier")
    jt.save(tier)
    jt.insert(9 * 10 ** 6, X[0])
    jt._journal.close()
    jemb = JHashEmbedder(dim=64).fit([d for d in WDOCS if d])
    jw = JWindowIndex(jemb, JSCRConfig(3, 2, 1)).build(WDOCS)
    win = str(tmp_path / "win")
    jw.save(win)
    jw.add("Fresh document about deep sea vents. They host life.")
    jw.remove(4)
    jw._journal.close()
    code = _BLOCKED.format(src=SRC, q=str(tmp_path / "q.npy"), eco=eco,
                           tier=tier, win=win,
                           docs=[d for d in WDOCS if d])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    got = json.loads(out.stdout.splitlines()[-1])
    jev = JEcoVector.load(_copy(ref_root, tmp_path, "r"))
    assert got["assign"] == [list(kv) for kv in sorted(jev.assign.items())]
    assert got["replayed"] == 6
    assert got["host"] == [jev.search(q, 10, n_probe=8)[0].tolist()
                           for q in Q]
    jt2 = JTiered.load(_copy(tier, tmp_path, "tr"))
    assert got["tier"] == np.asarray(jt2.search_device_batched(
        Q, k=10, n_probe=4, use_pallas=False)[0]).tolist()
    jw2 = JWindowIndex.load(jemb, _copy(win, tmp_path, "wr"))
    assert got["texts"] == jw2.texts and got["replayed_wi"] == 2
    assert got["lens"] == jw2.pack()[1].tolist()
    assert got["embeds"] == 0       # the replayed ops are packed lazily


def test_reference_state_naming_another_class_is_refused(tmp_path,
                                                         ref_root):
    """A generation whose pickled state names a `repro.` class the port
    does not map is refused with CorruptSegmentError (and a pipeline
    would rebuild from it)."""
    from repro.core.ecovector import EcoVectorStats
    root = _copy(ref_root, tmp_path, "bad")
    j = jstore.Journal(root)
    meta, recs = jstore.decode_segment(j.read_file(0, "state.seg"))
    recs[2] = pickle.dumps(EcoVectorStats())
    tmp = j.begin()
    for name in os.listdir(j.gen_dir(0)):
        if name.startswith("cluster_"):
            shutil.copy(os.path.join(j.gen_dir(0), name), tmp)
    jstore.write_segment(os.path.join(tmp, "state.seg"), recs,
                         {"centroids": meta["centroids"]},
                         kind="ecovector.state")
    j.commit()
    with pytest.raises(store.CorruptSegmentError, match="EcoVectorStats"):
        EcoVector.load(root, device="cpu")


# ------------------------------------------------------ byte-level match

def _segment(path, pkg):
    return pkg.read_segment(path)


def _assert_gen_matches(gen, jgen, pickled):
    """Every file of two generation dirs: the same names; segment records
    byte-equal, except the records in `pickled` (file -> record indices),
    whose pickles differ only by the class paths."""
    names = sorted(n for n in os.listdir(gen) if n != "MANIFEST.json")
    assert names == sorted(n for n in os.listdir(jgen)
                           if n != "MANIFEST.json")
    for name in names:
        a, b = os.path.join(gen, name), os.path.join(jgen, name)
        if name.endswith(".raw"):
            assert open(a, "rb").read() == open(b, "rb").read(), name
            continue
        ma, ra = store.read_segment(a)
        mb, rb = jstore.read_segment(b)
        assert ma == mb and len(ra) == len(rb), name
        idx = pickled.get(name, pickled.get(name.split("_")[0], ()))
        for i, (x, y) in enumerate(zip(ra, rb)):
            if i in idx and x != y:
                # a graph the port re-pickled (a spill file it never
                # rewrote is copied as the reference wrote it)
                assert pickle_ops(y, RENAME) == pickle_ops(x), (name, i)
            else:
                assert x == y, (name, i)


def test_generation_bytes_match_reference(tmp_path, ref_root):
    """From the reference's generation and WAL, the same ops in both
    packages: byte-equal WAL files; after the compaction the generation's
    records are byte-equal (the centroids, the state dict), the pickled
    graphs differing only by the HNSW class path; and 2 more ops give
    byte-equal WALs of the new generation."""
    roots = {"p": _copy(ref_root, tmp_path, "p"),
             "r": _copy(ref_root, tmp_path, "r")}
    ev = EcoVector.load(roots["p"], device="cpu")
    jev = JEcoVector.load(roots["r"])
    ops = _ops(np.random.default_rng(9), n=4, base=2 * 10 ** 6)
    _apply(ev, ops)
    _apply(jev, ops)
    for e in (ev, jev):
        e._journal.close()
    wal = "wal_00000000.log"
    assert open(os.path.join(roots["p"], wal), "rb").read() == \
        open(os.path.join(roots["r"], wal), "rb").read()
    assert ev.save() == jev.save() == 1
    _assert_gen_matches(os.path.join(roots["p"], "gen_00000001"),
                        os.path.join(roots["r"], "gen_00000001"),
                        {"state.seg": (2,), "cluster": (0,)})
    more = _ops(np.random.default_rng(10), n=2, base=3 * 10 ** 6)
    _apply(ev, more)
    _apply(jev, more)
    for e in (ev, jev):
        e._journal.close()
    wal = "wal_00000001.log"
    assert open(os.path.join(roots["p"], wal), "rb").read() == \
        open(os.path.join(roots["r"], wal), "rb").read()


def test_window_generation_bytes_match_reference(tmp_path):
    """A window index the reference committed, loaded by both, the same
    add / update / remove: byte-equal WALs, packs and lens records; the
    state record differs only by the SCRConfig class path."""
    jemb = JHashEmbedder(dim=64).fit([d for d in WDOCS if d])
    emb = HashEmbedder(dim=64).fit([d for d in WDOCS if d])
    root = str(tmp_path / "w")
    JWindowIndex(jemb, JSCRConfig(3, 2, 1)).build(WDOCS).save(root)
    roots = {"p": _copy(root, tmp_path, "p"), "r": _copy(root, tmp_path, "r")}
    wi = WindowIndex.load(emb, roots["p"], device="cpu")
    jw = JWindowIndex.load(jemb, roots["r"])
    for w in (wi, jw):
        w.add("Fresh document about deep sea vents. They host life.")
        w.update(2, "Astronomy text, now revised with telescopes.")
        w.remove(4)
        w._journal.close()
    wal = "wal_00000000.log"
    assert open(os.path.join(roots["p"], wal), "rb").read() == \
        open(os.path.join(roots["r"], wal), "rb").read()
    assert wi.save() == jw.save() == 1
    _assert_gen_matches(os.path.join(roots["p"], "gen_00000001"),
                        os.path.join(roots["r"], "gen_00000001"),
                        {"windows.seg": (0,)})
    wi2 = WindowIndex.load(emb, roots["p"], device="cpu")
    assert wi2.texts == jw.texts and wi2.stats.wal_replayed == 0
    np.testing.assert_array_equal(wi2.pack()[0], jw.pack()[0])


@pytest.mark.parametrize("workload", ["build_save", "compaction", "wal"])
def test_fs_ops_equal_to_reference(tmp_path, data, ref_root, workload):
    """The same workload counts the same fs events, by name and in
    order, in both packages."""
    X, _ = data
    events = {}
    for name, (s, cls, kw) in {
            "p": (store, EcoVector, {"device": "cpu"}),
            "r": (jstore, JEcoVector, {})}.items():
        names = []
        if workload == "build_save":
            def fn():
                cls(DIM, storage_dir=str(tmp_path / f"s{name}"), **KW,
                    **kw).build(X).save(str(tmp_path / f"j{name}"))
        else:
            ev = cls.load(_copy(ref_root, tmp_path, name), **kw)
            ops = _ops(np.random.default_rng(5), n=6, base=5 * 10 ** 6)
            fn = (ev.save if workload == "compaction"
                  else (lambda ev=ev, ops=ops: _apply(ev, ops)))
        s.set_crash_hook(lambda n_, c_, names=names: names.append(n_))
        try:
            fn()
        finally:
            s.set_crash_hook(None)
        events[name] = names
    assert events["p"] == events["r"] and events["p"]
    if workload == "build_save":
        assert len(events["p"]) == 8 * 3 + 3 + 5


# ------------------------------------------------ the port's round trips

def test_ecovector_save_load_bit_identical(tmp_path, data):
    X, Q = data
    ev = _ev(X)
    assert ev.save(str(tmp_path / "j")) == 0
    ev2 = EcoVector.load(str(tmp_path / "j"), device="cpu")
    assert ev2.assign == ev.assign and ev2.stats.wal_replayed == 0
    _same_search(ev, ev2, Q)
    ia, da = ev.search_device_batched(Q[:4], k=5, n_probe=8)
    ib, db = ev2.search_device_batched(Q[:4], k=5, n_probe=8)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(da, db)


def test_ecovector_churn_cycles_match_reference(tmp_path, data, ref_root):
    """From the reference's generation: insert / update / remove cycles
    with a compaction each round, in both packages; each reload is
    bit-identical to the live index and to the reference's reload."""
    _, Q = data
    rng = np.random.default_rng(3)
    root, jroot = (_copy(ref_root, tmp_path, "p"),
                   _copy(ref_root, tmp_path, "r"))
    ev = EcoVector.load(root, device="cpu")
    jev = JEcoVector.load(jroot)
    base = 10 ** 7
    for cycle in range(3):
        ops = [("insert", base + 6 * cycle + i,
                rng.normal(size=DIM).astype(np.float32)) for i in range(6)]
        upd = base + 6 * cycle + 1
        ops += [("delete", base + 6 * cycle, None), ("delete", upd, None),
                ("insert", upd, rng.normal(size=DIM).astype(np.float32))]
        _apply(ev, ops)
        _apply(jev, ops)
        assert ev.save() == jev.save() == cycle + 1
        ev2 = EcoVector.load(root, device="cpu")
        assert ev2.assign == ev.assign == jev.assign
        assert ev2.stats.wal_replayed == 0
        _same_search(ev, ev2, Q)
        _same_search(ev2, JEcoVector.load(jroot), Q)


def test_ecovector_wal_replay(tmp_path, data):
    X, Q = data
    ev = _ev(X)
    root = str(tmp_path / "j")
    ev.save(root)
    ev.device_arrays()                       # the dirty-mark path is live
    _apply(ev, _ops(np.random.default_rng(4)))
    ev2 = EcoVector.load(root, device="cpu")
    assert ev2.stats.wal_replayed == 6
    assert ev2.assign == ev.assign
    _same_search(ev, ev2, Q)
    ia, da = ev.search_device_batched(Q, k=10, n_probe=4)
    ib, db = ev2.search_device_batched(Q, k=10, n_probe=4)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(da, db)


def test_save_without_root_or_build_refused(tmp_path):
    ev = EcoVector(DIM, device="cpu", **KW)
    with pytest.raises(ValueError):
        ev.save()
    with pytest.raises(store.StoreError):
        ev.save(str(tmp_path / "j"))
    with pytest.raises(FileNotFoundError):
        EcoVector.load(str(tmp_path / "empty"), device="cpu")


# ------------------------------------------------------- crash injection

def test_ecovector_save_crash_sweep(tmp_path, data):
    """A crash at every fs op of save(): the journal reloads to a whole
    index, or reports none committed."""
    X, Q = data
    ev = _ev(X)
    total = store_faults.count_fs_ops(
        lambda: ev.save(str(tmp_path / "probe")))
    assert total == 3 + 5
    for at in range(1, total + 1):
        root = str(tmp_path / f"r{at}")
        ev._journal = None
        with store_faults.CrashPlan(at) as plan:
            try:
                ev.save(root)
            except store_faults.InjectedCrash:
                pass
        try:
            ev2 = EcoVector.load(root, device="cpu")
        except FileNotFoundError:
            assert plan.fired
            continue
        assert ev2.assign == ev.assign
        assert len(ev2.search(Q[0], 5, n_probe=8)[0]) == 5
    ev._journal = None


def test_wal_crash_never_loses_acknowledged_ops(tmp_path, data):
    """A crash at every fs op of a journaled burst: every op that
    returned before the crash is there after a reload (the one in flight
    may or may not be)."""
    X, _ = data
    rng = np.random.default_rng(5)
    base_root = str(tmp_path / "base")
    ev0 = _ev(X)
    ev0.save(base_root)
    vecs = rng.normal(size=(6, DIM)).astype(np.float32)
    ops = [("delete", 10 ** 6 + 1) if i == 4 else ("insert", 10 ** 6 + i)
           for i in range(len(vecs))]

    def burst(ev, acked):
        for i, (op, vid) in enumerate(ops):
            if op == "delete":
                ev.delete(vid)
            else:
                ev.insert(vid, vecs[i])
            acked.append((op, vid))

    total = store_faults.count_fs_ops(lambda: burst(ev0, []))
    assert total == 5 * len(ops)
    for at in range(1, total + 1):
        root = str(tmp_path / f"r{at}")
        shutil.copytree(base_root, root)
        ev = EcoVector.load(root, device="cpu")
        acked = []
        with store_faults.CrashPlan(at):
            try:
                burst(ev, acked)
            except store_faults.InjectedCrash:
                pass
        ev2 = EcoVector.load(root, device="cpu")
        inflight = ops[len(acked)][1] if len(acked) < len(ops) else None
        expect = {vid: op == "insert" for op, vid in acked}
        for vid, present in expect.items():
            if vid != inflight:
                assert (vid in ev2.assign) == present, (at, vid, present)


def _run_workload(root, stage, crash_at=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC)
    if crash_at is not None:
        env["REPRO_STORE_CRASH_AT"] = str(crash_at)
    cmd = [sys.executable, "-m", "repro_torch.core.store_faults",
           "--root", str(root), "--stage", stage, "--device", "cpu"]
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _workload_ops(wal_ops=12, base=10 ** 6):
    return [("delete", base + i - 1) if i % 3 == 2 else
            ("insert", base + i) for i in range(wal_ops)]


def _check_acked_survive(root):
    """The ack log against the reloaded index: no acknowledged op lost
    (the one in flight at the kill is exempt)."""
    ack_path = os.path.join(root, "acked.txt")
    acked, compacted = [], False
    if os.path.exists(ack_path):
        with open(ack_path) as f:
            for line in f.read().splitlines():
                parts = line.split()
                if parts[0] in ("insert", "delete"):
                    acked.append((parts[0], int(parts[1])))
                elif parts[0] == "compacted":
                    compacted = True
    ops = _workload_ops()
    assert acked == ops[:len(acked)]
    inflight = ops[len(acked)][1] if len(acked) < len(ops) else None
    try:
        ev = EcoVector.load(os.path.join(root, "journal"), device="cpu")
    except FileNotFoundError:
        assert not acked and not compacted
        return None
    for op, vid in acked:
        if vid != inflight:
            live = dict((v, o == "insert") for o, v in acked)[vid]
            assert (vid in ev.assign) == live, (vid, live)
    if compacted:
        assert store.Journal(os.path.join(root, "journal")).latest() >= 1
    assert len(ev.search(np.zeros(DIM, np.float32), 5, n_probe=8)[0]) == 5
    return ev


@pytest.mark.parametrize("stage,crash_at", [
    # the workload's fs ops, as the reference's: 1-27 build spills and
    # state, 28-32 the first commit, 33-92 the WAL'd ops (5 each), 93-100
    # the compaction
    ("wal", 29), ("wal", 52), ("compact", 97)])
def test_kill9_subprocess_recovery(tmp_path, stage, crash_at):
    """A real os._exit at the crash_at-th fs op (mid-first-commit,
    mid-WAL, mid-compaction): every acknowledged op is there."""
    p = _run_workload(tmp_path, stage, crash_at=crash_at)
    assert p.returncode == 42, p.stdout + p.stderr
    _check_acked_survive(str(tmp_path))


def test_kill9_uninjected_run_completes(tmp_path):
    p = _run_workload(tmp_path, "compact")
    assert p.returncode == 0, p.stdout + p.stderr
    ev = _check_acked_survive(str(tmp_path))
    assert store.Journal(str(tmp_path / "journal")).latest() == 1
    assert ev.stats.wal_replayed == 0


# --------------------------------------------------- corruption at query

def test_byte_flip_quarantine_search_degrades(data):
    X, Q = data
    ev = _ev(X)
    ev.device_pack()                          # salvage source
    victim = 2
    store_faults.flip_byte(ev._path(victim), 100)
    with pytest.warns(UserWarning, match="quarantin"):
        for q in Q:
            assert len(ev.search(q, 10, n_probe=8)[0]) == 10
    assert (ev.stats.corrupt_reads, ev.stats.quarantined) == (1, 1)
    assert victim in ev._quarantined
    assert os.path.exists(ev._path(victim) + ".quarantined")
    ia, _ = ev.search_device_batched(Q[:4], k=5, n_probe=8)
    for r, q in zip(ia, Q[:4]):
        np.testing.assert_array_equal(r, ev.search(q, 5, n_probe=8)[0])
    assert ev.rebuild_cluster(victim) > 0
    assert (ev.stats.rebuilt, ev.stats.quarantined) == (1, 0)
    assert not os.path.exists(ev._path(victim) + ".quarantined")
    assert len(ev.search(Q[0], 10, n_probe=8)[0]) == 10


def test_truncated_spill_file_is_clear_error(data):
    X, _ = data
    ev = _ev(X)
    p = ev._path(0)
    store_faults.truncate_file(p, os.path.getsize(p) // 2)
    with pytest.raises(store.CorruptSegmentError, match="truncated"):
        ev._load_cluster(0)


def test_mutations_on_quarantined_cluster(data):
    X, _ = data
    ev = _ev(X)
    ev.device_pack()
    victim = int(ev.assign[0])
    store_faults.flip_byte(ev._path(victim), 120)
    with pytest.warns(UserWarning):
        assert ev._load_cluster_checked(victim) is None
    assert 0 not in ev.assign
    ev.delete(0)                              # tolerated
    ev.insert(0, X[0])                        # routes back -> rebuild
    assert 0 in ev.assign
    assert (ev.stats.rebuilt, ev.stats.quarantined) == (1, 0)
    assert 0 in ev.search(X[0], 5, n_probe=8)[0]


def test_save_refuses_to_launder_corruption(tmp_path, data):
    X, Q = data
    ev = _ev(X)
    ev.device_pack()
    store_faults.flip_byte(ev._path(3), 90)
    with pytest.warns(UserWarning):
        ev.save(str(tmp_path / "j"))
    assert all(r["ok"] for r in store.scrub_path(str(tmp_path / "j")))
    ev2 = EcoVector.load(str(tmp_path / "j"), device="cpu")
    assert 3 in ev2._quarantined
    for q in Q:
        assert len(ev2.search(q, 10, n_probe=8)[0]) == 10


# ------------------------------------------------------- window index

class _CountingEmbed:
    def __init__(self, inner):
        self.inner = inner
        self.calls = 0
        self.texts = 0

    def __call__(self, texts):
        self.calls += 1
        self.texts += len(texts)
        return self.inner(texts)


@pytest.fixture(scope="module")
def embed():
    return HashEmbedder(dim=64).fit([d for d in WDOCS if d])


def test_window_index_save_load_no_reembed(tmp_path, embed):
    from repro_torch.core.scr import SCRConfig
    wi = WindowIndex(embed, SCRConfig(3, 2, 1), device="cpu").build(WDOCS)
    data0, lens0 = wi.pack()
    root = str(tmp_path / "w")
    wi.save(root)
    counter = _CountingEmbed(embed)
    wi2 = WindowIndex.load(counter, root, device="cpu")
    data2, lens2 = wi2.pack()
    assert counter.calls == 0
    np.testing.assert_array_equal(data0, data2)
    np.testing.assert_array_equal(lens0, lens2)
    assert (wi2.texts, wi2.spans, wi2.cfg) == (wi.texts, wi.spans, wi.cfg)
    d_t, l_t = wi2.device_arrays()
    assert np.array_equal(d_t.numpy(), data0) and d_t.data_ptr() != \
        data2.ctypes.data


def test_window_index_wal_and_compaction(tmp_path, embed):
    from repro_torch.core.scr import SCRConfig
    wi = WindowIndex(embed, SCRConfig(3, 2, 1), device="cpu").build(WDOCS)
    root = str(tmp_path / "w")
    wi.save(root)
    di = wi.add("Fresh document about deep sea vents. They host life.")
    wi.update(2, "Astronomy text, now revised with telescopes.")
    wi.remove(4)
    wi2 = WindowIndex.load(embed, root, device="cpu")
    assert wi2.stats.wal_replayed == 3 and wi2.texts == wi.texts
    d1, l1 = wi.pack()
    d2, l2 = wi2.pack()
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(d1, d2)
    assert wi.save() == 1
    wi3 = WindowIndex.load(embed, root, device="cpu")
    assert wi3.stats.wal_replayed == 0 and wi3.texts == wi.texts
    assert int(wi3.pack()[1][4]) == 0 and di == len(WDOCS)


# --------------------------------------------------- pipeline snapshot

def _pipe(docs, emb, **kw):
    from repro_torch.serving.rag import MobileRAG
    return MobileRAG(docs, emb, top_k=3, device="cpu", **kw)


def test_mobilerag_retrieval_state_roundtrip(tmp_path):
    from repro_torch.data.synthetic import make_qa_corpus
    corpus = make_qa_corpus(n_docs=40, n_questions=4, seed=0)
    emb = HashEmbedder(dim=64).fit(corpus.docs)
    state = str(tmp_path / "state")
    c1 = _CountingEmbed(emb)
    pipe = _pipe(corpus.docs, c1, retrieval_state=state)
    assert c1.texts > 0
    assert store.Journal(os.path.join(state, "ecovector")).latest() == 0
    c2 = _CountingEmbed(emb)
    warm = _pipe(corpus.docs, c2, retrieval_state=state)
    assert c2.texts == 0                      # construction embeds nothing
    qs = [e.question for e in corpus.examples[:4]]
    a, b = pipe.answer_batch(qs), warm.answer_batch(qs)
    assert [x.doc_ids for x in a] == [x.doc_ids for x in b]
    assert [x.prompt for x in a] == [x.prompt for x in b]
    assert c2.texts == len(qs)                # query embeds only


def test_mobilerag_restores_reference_state(tmp_path):
    """The port's pipeline restores the reference's retrieval_state
    without embedding the corpus: the same index assignments and window
    pack, and the reference's host-search doc ids."""
    from repro.data.synthetic import make_qa_corpus as j_make_qa_corpus
    from repro.serving.rag import MobileRAG as JMobileRAG
    corpus = j_make_qa_corpus("squad", n_docs=40, n_questions=4, seed=0)
    state = str(tmp_path / "state")
    jpipe = JMobileRAG(corpus.docs, JHashEmbedder(dim=64).fit(corpus.docs),
                       top_k=3, retrieval_state=state)
    c = _CountingEmbed(HashEmbedder(dim=64).fit(corpus.docs))
    pipe = _pipe(corpus.docs, c, retrieval_state=state,
                 device_retrieval=False)
    assert c.texts == 0
    assert pipe.index.assign == jpipe.index.assign
    np.testing.assert_array_equal(pipe.window_index.pack()[0],
                                  jpipe.window_index.pack()[0])
    qs = [e.question for e in corpus.examples[:4]]
    # sets: the SCR order of near-tied windows is each package's (F5)
    assert [set(a.doc_ids) for a in pipe.answer_batch(qs)] == \
        [set(a.doc_ids) for a in jpipe.answer_batch(qs)]


def test_mobilerag_corrupt_state_rebuilds(tmp_path):
    from repro_torch.data.synthetic import make_qa_corpus
    corpus = make_qa_corpus(n_docs=30, n_questions=2, seed=1)
    emb = HashEmbedder(dim=64).fit(corpus.docs)
    state = str(tmp_path / "state")
    _pipe(corpus.docs, emb, retrieval_state=state)
    j = store.Journal(os.path.join(state, "ecovector"))
    store_faults.flip_byte(
        os.path.join(j.gen_dir(j.latest()), "state.seg"), 200)
    with pytest.warns(UserWarning, match="rebuilding"):
        pipe = _pipe(corpus.docs, emb, retrieval_state=state)
    assert len(pipe.answer_batch([corpus.examples[0].question])[0]
               .doc_ids) > 0
    c3 = _CountingEmbed(emb)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*rebuilding.*")
        _pipe(corpus.docs, c3, retrieval_state=state)
    assert c3.texts == 0
