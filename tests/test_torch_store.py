"""The port's durable store against the JAX package's on the CPU.

Segments, raw payloads, WAL files and journal manifests written by the
two packages from the same inputs are byte-equal, and each package reads
the other's; both refuse the same bit flips, truncations and trailing
bytes; both count the same fs events, by name and in order, so a crash
plan stops the same op in both; the port's crash sweeps keep a file old
or new and a journal at a whole generation; torn and corrupt WAL tails
replay the same prefix; scrub reports agree item for item. The mapping
unpickler loads the reference's pickled HNSW and SCRConfig as the
port's classes and refuses every other `repro.` class with
`CorruptSegmentError`. Every comparison is exact."""
import io
import json
import os
import pickle
import pickletools
import struct

import numpy as np
import pytest

from repro.core import store as jstore
from repro.core import store_faults as jfaults
from repro_torch.core import store, store_faults
from repro_torch.core.store import (CorruptSegmentError, Journal, StoreError,
                                    WriteAheadLog)

PKGS = {"port": (store, store_faults), "ref": (jstore, jfaults)}


@pytest.fixture(autouse=True)
def _clean_hooks():
    """Every test starts and ends with no crash hook armed in either
    package."""
    for s in (store, jstore):
        s.set_crash_hook(None)
        s.reset_fs_ops()
    yield
    for s in (store, jstore):
        s.set_crash_hook(None)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _events(pkg, fn):
    """The fs events `fn` makes in one package's store, in order."""
    names = []
    pkg.set_crash_hook(lambda name, count: names.append(name))
    try:
        fn()
    finally:
        pkg.set_crash_hook(None)
    return names


def pickle_ops(blob, rename=()):
    """A pickle's opcode stream without its frame lengths, with each
    (old, new) string in `rename` replaced: two pickles that differ only
    by class-path strings give equal streams."""
    out = []
    for op, arg, _ in pickletools.genops(blob):
        if op.name == "FRAME":
            continue
        for old, new in rename:
            if arg == old:
                arg = new
        out.append((op.name, arg))
    return out


# ------------------------------------------------------------- segments

@pytest.mark.parametrize("writer", ["port", "ref"])
def test_segment_bytes_equal_and_cross_read(tmp_path, writer):
    recs = [b"hello", b"", b"\x00" * 1024]
    paths = {}
    for name, (s, _) in PKGS.items():
        paths[name] = str(tmp_path / f"{name}.seg")
        s.write_segment(paths[name], recs, {"x": 1}, kind="t")
        assert not os.path.exists(paths[name] + ".tmp")
    assert _bytes(paths["port"]) == _bytes(paths["ref"])
    reader = store if writer == "ref" else jstore
    meta, out = reader.read_segment(paths[writer], kind="t")
    assert out == recs and meta == {"x": 1, "kind": "t"}
    assert reader.verify_segment(paths[writer], kind="t") == \
        _bytes(paths[writer])


def test_segment_kind_mismatch(tmp_path):
    p = str(tmp_path / "a.seg")
    store.write_segment(p, [b"x"], kind="cluster")
    for s in (store, jstore):
        with pytest.raises(s.CorruptSegmentError, match="kind"):
            s.read_segment(p, kind="manifest")
        with pytest.raises(s.CorruptSegmentError, match="kind"):
            s.verify_segment(p, kind="manifest")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_obj_roundtrip_across_packages(tmp_path, writer):
    obj = {"a": np.arange(3).tolist(), "b": "text",
           "ids": np.arange(5, dtype=np.int64)}
    p = str(tmp_path / "o.bin")
    PKGS[writer][0].dump_obj(p, obj, kind="k")
    reader = store if writer == "ref" else jstore
    got = reader.load_obj(p, kind="k")
    assert got["a"] == obj["a"] and got["b"] == obj["b"]
    np.testing.assert_array_equal(got["ids"], obj["ids"])


def test_foreign_file_rejected(tmp_path):
    p = str(tmp_path / "legacy.bin")
    with open(p, "wb") as f:
        pickle.dump({"oops": 1}, f)
    with pytest.raises(CorruptSegmentError, match="magic"):
        store.load_obj(p)


def _flipped(p, good, off, fault):
    with open(p, "wb") as f:
        f.write(good)
    fault(p, off)


def test_every_byte_flip_detected_as_reference(tmp_path):
    """Bit-rot anywhere (header, meta, framing, payload) fails both
    packages' validation; the port's flip_byte makes the reference's
    bytes."""
    p, q = str(tmp_path / "a.seg"), str(tmp_path / "b.seg")
    store.write_segment(p, [b"payload-one", b"payload-two"], {"m": 2})
    good = _bytes(p)
    size = len(good)
    for off in range(0, size, max(1, size // 64)):
        _flipped(p, good, off, store_faults.flip_byte)
        _flipped(q, good, off, jfaults.flip_byte)
        assert _bytes(p) == _bytes(q)
        for s in (store, jstore):
            with pytest.raises(s.CorruptSegmentError):
                s.read_segment(p)


def test_every_truncation_detected_as_reference(tmp_path):
    p = str(tmp_path / "a.seg")
    store.write_segment(p, [b"some-payload" * 8], {"m": 1})
    good = _bytes(p)
    for keep in range(0, len(good), max(1, len(good) // 32)):
        with open(p, "wb") as f:
            f.write(good)
        store_faults.truncate_file(p, keep)
        assert _bytes(p) == good[:keep]
        msgs = []
        for s in (store, jstore):
            with pytest.raises(s.CorruptSegmentError) as e:
                s.read_segment(p)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_trailing_garbage_detected(tmp_path):
    p = str(tmp_path / "a.seg")
    store.write_segment(p, [b"x"], {})
    with open(p, "ab") as f:
        f.write(b"\x00" * 7)
    for s in (store, jstore):
        with pytest.raises(s.CorruptSegmentError, match="trailing"):
            s.read_segment(p)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64])
def test_array_record_matches_reference(dtype):
    a = np.arange(24, dtype=dtype).reshape(2, 3, 4)
    payload, spec = store.array_record(a)
    assert (payload, spec) == jstore.array_record(a)
    b = store.record_array(payload, spec)
    assert b.dtype == a.dtype and b.shape == a.shape and b.flags.writeable
    np.testing.assert_array_equal(a, b)
    with pytest.raises(CorruptSegmentError):
        store.record_array(payload[:-a.itemsize], spec)


def test_atomic_write_bytes_matches_reference(tmp_path):
    blob = bytes(range(256)) * 9
    names = {}
    for name, (s, _) in PKGS.items():
        p = str(tmp_path / f"{name}.raw")
        names[name] = _events(s, lambda: s.atomic_write_bytes(p, blob))
        assert _bytes(p) == blob and not os.path.exists(p + ".tmp")
    assert names["port"] == names["ref"] == ["raw.write", "raw.fsync",
                                             "raw.rename"]


def test_atomic_write_crash_leaves_old_or_nothing(tmp_path):
    """A crash at every fs op of a segment overwrite leaves the old file
    or the new one, intact; the sweep has the reference's length."""
    p = str(tmp_path / "a.seg")
    store.write_segment(p, [b"old"], kind="t")
    total = store_faults.count_fs_ops(
        lambda: store.write_segment(p, [b"new"], kind="t"))
    assert total == jfaults.count_fs_ops(
        lambda: jstore.write_segment(p, [b"new"], kind="t")) == 3
    for at in range(1, total + 1):
        store.write_segment(p, [b"old"], kind="t")
        with store_faults.CrashPlan(at) as plan:
            try:
                store.write_segment(p, [b"new"], kind="t")
            except store_faults.InjectedCrash:
                pass
        assert plan.fired
        _, recs = store.read_segment(p, kind="t")
        assert recs in ([b"old"], [b"new"])


# ------------------------------------------------------------------ WAL

FRAMES = [b"one", b"", b"three" * 100]


def test_wal_bytes_equal_and_cross_replay(tmp_path):
    paths = {}
    for name, (s, _) in PKGS.items():
        paths[name] = str(tmp_path / f"{name}.log")
        w = s.WriteAheadLog(paths[name], generation=3)
        for fr in FRAMES:
            w.append(fr)
        w.close()
    assert _bytes(paths["port"]) == _bytes(paths["ref"])
    assert WriteAheadLog.replay(paths["ref"]) == (FRAMES, False)
    assert jstore.WriteAheadLog.replay(paths["port"]) == (FRAMES, False)


def test_wal_missing_and_empty(tmp_path):
    assert WriteAheadLog.replay(str(tmp_path / "nope.log")) == ([], False)
    p = str(tmp_path / "empty.log")
    open(p, "wb").close()
    assert WriteAheadLog.replay(p) == ([], False)
    with open(p, "wb") as f:
        f.write(b"RW")                          # a torn header
    assert WriteAheadLog.replay(p) == jstore.WriteAheadLog.replay(p) == \
        ([], True)


def test_wal_torn_tail_replays_as_reference(tmp_path):
    """Truncated anywhere, the log replays the reference's prefix of
    intact frames, in order, and flags the tail."""
    p = str(tmp_path / "w.log")
    w = WriteAheadLog(p)
    frames = [f"op-{i}".encode() * (i + 1) for i in range(6)]
    for fr in frames:
        w.append(fr)
    w.close()
    good = _bytes(p)
    for keep in range(len(good) - 1, 0, -max(1, len(good) // 40)):
        with open(p, "wb") as f:
            f.write(good[:keep])
        ops, torn = WriteAheadLog.replay(p)
        assert (ops, torn) == jstore.WriteAheadLog.replay(p)
        assert ops == frames[:len(ops)]
        if len(ops) < len(frames):
            assert torn


def test_wal_corrupt_frame_stops_replay(tmp_path):
    p = str(tmp_path / "w.log")
    w = WriteAheadLog(p)
    for i in range(4):
        w.append(f"frame-{i}".encode())
    w.close()
    hdr = struct.calcsize("<4sHHQ")
    frame = struct.calcsize("<II") + len(b"frame-0")
    store_faults.flip_byte(p, hdr + 2 * frame + struct.calcsize("<II") + 3)
    assert WriteAheadLog.replay(p) == jstore.WriteAheadLog.replay(p) == \
        ([b"frame-0", b"frame-1"], True)


# -------------------------------------------------------------- journal

def _commit_gen(s, j, payload: bytes) -> int:
    tmp = j.begin()
    s.write_segment(os.path.join(tmp, "state.seg"), [payload], kind="t")
    return j.commit()


def _journal_workload(s, root):
    j = s.Journal(root)
    _commit_gen(s, j, b"a")
    j.append(b"m1")
    j.append(b"m2")
    _commit_gen(s, j, b"b")
    j.append(b"m3")
    j.close()


def test_journal_files_and_events_match_reference(tmp_path):
    """The same journal workload gives the same fs events, in order, and
    byte-equal generation files, manifests and WAL in both packages."""
    roots, events = {}, {}
    for name, (s, _) in PKGS.items():
        roots[name] = str(tmp_path / name)
        events[name] = _events(s, lambda: _journal_workload(s, roots[name]))
    assert events["port"] == events["ref"]
    assert events["port"][:8] == [
        "segment.write", "segment.fsync", "segment.rename", "gen.manifest",
        "dir.replace", "dir.replaced", "gen.commit", "wal.rotate"]
    assert events["port"].count("wal.write") == 3
    for rel in ("gen_00000000/state.seg", "gen_00000000/MANIFEST.json",
                "gen_00000001/state.seg", "gen_00000001/MANIFEST.json",
                "wal_00000001.log"):
        assert _bytes(os.path.join(roots["port"], rel)) == \
            _bytes(os.path.join(roots["ref"], rel)), rel
    assert sorted(os.listdir(roots["port"])) == sorted(os.listdir(
        roots["ref"]))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journal_reads_other_package(tmp_path, writer):
    root = str(tmp_path / "j")
    _journal_workload(PKGS[writer][0], root)
    reader = store if writer == "ref" else jstore
    j = reader.Journal(root)
    assert j.generations() == [0, 1] and j.latest() == 1
    _, recs = reader.decode_segment(j.read_file(1, "state.seg"))
    assert recs == [b"b"]
    assert j.replay() == ([b"m3"], False) and j.wal_records() == 1


def test_journal_generations_and_read(tmp_path):
    j = Journal(str(tmp_path))
    assert j.latest() is None and j.replay() == ([], False)
    assert (_commit_gen(store, j, b"gen-zero"),
            _commit_gen(store, j, b"gen-one")) == (0, 1)
    assert j.generations() == [0, 1] and j.generation == 1
    _, recs = store.decode_segment(j.read_file(1, "state.seg"))
    assert recs == [b"gen-one"]
    meta, recs = j.read_segment(1, "state.seg", "t", 1)
    assert recs == [b"gen-one"] and meta["kind"] == "t"
    with pytest.raises(CorruptSegmentError, match="malformed"):
        j.read_segment(1, "state.seg", "t", 2)


def test_journal_wal_rotation(tmp_path):
    j = Journal(str(tmp_path))
    with pytest.raises(StoreError):
        j.append(b"no base generation yet")
    with pytest.raises(StoreError):
        j.commit()                              # commit without begin
    _commit_gen(store, j, b"base")
    j.append(b"m1")
    j.append(b"m2")
    assert j.wal_records() == 2
    _commit_gen(store, j, b"compacted")
    assert j.wal_records() == 0
    assert [n for n in os.listdir(tmp_path) if n.startswith("wal_")] == []


def test_journal_manifest_detects_bitrot(tmp_path):
    j = Journal(str(tmp_path))
    _commit_gen(store, j, b"data" * 100)
    store_faults.flip_byte(os.path.join(j.gen_dir(0), "state.seg"), 50)
    with pytest.raises(CorruptSegmentError, match="manifest"):
        j.read_file(0, "state.seg")
    with pytest.raises(jstore.CorruptSegmentError, match="manifest"):
        jstore.Journal(str(tmp_path)).read_file(0, "state.seg")


def test_journal_crash_sweep_never_half_commits(tmp_path):
    """A crash at every fs op of a second commit: the latest generation
    is always whole (gen 0 or gen 1), and the WAL op is dropped only once
    the commit that folds it is visible. The sweep has the reference's
    length."""
    def second_commit(s, root):
        j = s.Journal(root)
        _commit_gen(s, j, b"a")
        j.append(b"op")
        return lambda: _commit_gen(s, j, b"b")

    totals = {name: f.count_fs_ops(second_commit(s, str(tmp_path / name)))
              for name, (s, f) in PKGS.items()}
    assert totals["port"] == totals["ref"] == 8
    for at in range(1, totals["port"] + 1):
        root = str(tmp_path / f"r{at}")
        j = Journal(root)
        _commit_gen(store, j, b"a")
        j.append(b"op")
        with store_faults.CrashPlan(at):
            try:
                _commit_gen(store, j, b"b")
            except store_faults.InjectedCrash:
                pass
        j.close()
        j2 = Journal(root)
        g = j2.latest()
        assert g in (0, 1)
        _, recs = store.decode_segment(j2.read_file(g, "state.seg"))
        assert recs == [b"a" if g == 0 else b"b"]
        if g == 0:
            assert j2.replay() == ([b"op"], False)


def test_stale_tmp_and_gateless_dirs_ignored(tmp_path):
    j = Journal(str(tmp_path))
    _commit_gen(store, j, b"real")
    os.makedirs(tmp_path / "gen_00000005.tmp")
    os.makedirs(tmp_path / "gen_00000007")      # no MANIFEST.json
    assert Journal(str(tmp_path)).latest() == 0
    assert store.numbered_dirs(str(tmp_path), "gen_", "MANIFEST.json") == \
        jstore.numbered_dirs(str(tmp_path), "gen_", "MANIFEST.json") == [0]


def test_atomic_replace_dir_events(tmp_path):
    for name, (s, _) in PKGS.items():
        tmp, final = tmp_path / f"{name}.tmp", tmp_path / name
        for d in (tmp, final):
            d.mkdir()
        (tmp / "f").write_bytes(b"new")
        (final / "f").write_bytes(b"old")
        assert _events(s, lambda: s.atomic_replace_dir(
            str(tmp), str(final))) == ["dir.replace", "dir.replaced"]
        assert (final / "f").read_bytes() == b"new" and not tmp.exists()


# ---------------------------------------------------------------- scrub

def _reports(reps, base):
    return [(os.path.relpath(r["item"], base), r["ok"], r.get("records"))
            for r in reps]


def test_scrub_clean_and_corrupt_as_reference(tmp_path):
    root = str(tmp_path)
    j = Journal(root)
    tmp = j.begin()
    store.write_segment(os.path.join(tmp, "state.seg"), [b"x" * 500],
                        kind="t")
    j.commit()
    j.append(b"mutation")
    j.close()
    reps = store.scrub_path(root)
    assert reps and all(r["ok"] for r in reps)
    assert _reports(reps, root) == _reports(jstore.scrub_path(root), root)
    store_faults.flip_byte(os.path.join(j.gen_dir(0), "state.seg"), 200)
    reps = store.scrub_path(root)
    assert any(not r["ok"] for r in reps)
    assert _reports(reps, root) == _reports(jstore.scrub_path(root), root)


def test_scrub_plain_spill_dir_and_file(tmp_path):
    d = tmp_path / "spill"
    d.mkdir()
    store.write_segment(str(d / "c0.bin"), [b"ok"], kind="c")
    store.write_segment(str(d / "c1.bin"), [b"ok"], kind="c")
    (d / "payload.raw").write_bytes(b"raw")     # skipped: no framing
    store_faults.truncate_file(str(d / "c1.bin"), 10)
    reps = {os.path.basename(r["item"]): r["ok"]
            for r in store.scrub_path(str(d))}
    assert reps == {"c0.bin": True, "c1.bin": False}
    assert _reports(store.scrub_path(str(d)), d) == \
        _reports(jstore.scrub_path(str(d)), d)
    assert [r["ok"] for r in store.scrub_path(str(d / "c1.bin"))] == [False]


def test_quarantine_file(tmp_path):
    p = str(tmp_path / "bad.bin")
    with open(p, "wb") as f:
        f.write(b"junk")
    assert store.quarantine_file(p) == p + ".quarantined"
    assert not os.path.exists(p) and os.path.exists(p + ".quarantined")
    assert store.quarantine_file(str(tmp_path / "gone.bin")) is None


# -------------------------------------------------------------- pickles

def test_reference_classes_map_to_the_port(tmp_path):
    """The reference's pickled HNSW and SCRConfig load as the port's
    classes (equal fields), through load_obj and loads alike; the port's
    own pickles of them differ from the reference's only by the class
    paths."""
    from repro.core.hnsw import HNSW as JHNSW
    from repro.core.scr import SCRConfig as JSCRConfig
    from repro_torch.core.hnsw import HNSW
    from repro_torch.core.scr import SCRConfig
    rng = np.random.default_rng(0)
    g = JHNSW(8, M=4, ef_construction=16, seed=3, max_elements=16)
    for i, v in enumerate(rng.normal(size=(12, 8)).astype(np.float32)):
        g.insert(i, v)
    p = str(tmp_path / "g.bin")
    jstore.dump_obj(p, {"graph": g, "cfg": JSCRConfig(4, 2, 1)}, kind="k")
    got = store.load_obj(p, kind="k")
    assert type(got["graph"]) is HNSW and type(got["cfg"]) is SCRConfig
    assert vars(got["graph"]).keys() == vars(g).keys()
    assert (got["graph"].levels, got["graph"].neighbors) == \
        (g.levels, g.neighbors)
    np.testing.assert_array_equal(got["graph"].vectors, g.vectors)
    assert (got["cfg"].sliding_window_size, got["cfg"].overlap_size,
            got["cfg"].context_extension_size) == (4, 2, 1)
    mine = pickle.dumps({"graph": got["graph"], "cfg": got["cfg"]},
                        protocol=pickle.HIGHEST_PROTOCOL)
    theirs = pickle.dumps({"graph": g, "cfg": JSCRConfig(4, 2, 1)},
                          protocol=pickle.HIGHEST_PROTOCOL)
    assert pickle_ops(theirs, [(a, b) for (a, _), (b, _) in
                               store.CLASS_MAP.items()]) == pickle_ops(mine)


@pytest.mark.parametrize("cls_path", [
    "repro.core.ecovector:EcoVectorStats",
    "repro.core.window_index:WindowIndexStats",
    "repro.core.scr:SCRResult",
])
def test_other_reference_classes_refused(tmp_path, cls_path):
    """A reference pickle that names any other `repro.` class is refused
    with CorruptSegmentError, in `loads` and through `load_obj`."""
    import importlib
    mod, name = cls_path.split(":")
    cls = getattr(importlib.import_module(mod), name)
    obj = cls(*([[]] * 4 + [0, 0])) if name == "SCRResult" else cls()
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    with pytest.raises(CorruptSegmentError, match="no counterpart"):
        store.loads(blob)
    p = str(tmp_path / "x.bin")
    jstore.dump_obj(p, obj)
    with pytest.raises(CorruptSegmentError, match=name):
        store.load_obj(p)


def test_env_crash_hook_exits_at_nth_op(tmp_path):
    """REPRO_STORE_CRASH_AT arms a hard exit at the n-th fs op when the
    store is imported, as in the reference."""
    import subprocess
    import sys
    code = ("import sys; from repro_torch.core import store; "
            f"[store.write_segment({str(tmp_path / 's')!r} + str(i), [b'x'])"
            " for i in range(3)]")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, REPRO_STORE_CRASH_AT="5",
               REPRO_STORE_CRASH_EXIT="7")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 7, out.stderr
    # ops 1-3 wrote s0; op 5 (s1's fsync) exits before s1's rename
    assert sorted(os.listdir(tmp_path)) == ["s0", "s1.tmp"]


def test_manifest_is_reference_json(tmp_path):
    j = Journal(str(tmp_path))
    _commit_gen(store, j, b"payload")
    man = j.manifest(0)
    blob = _bytes(os.path.join(tmp_path, "gen_00000000", "state.seg"))
    assert man == {"generation": 0, "files": {"state.seg": {
        "size": len(blob), "crc32": __import__("zlib").crc32(blob)}}}
    assert json.load(io.open(os.path.join(
        j.gen_dir(0), "MANIFEST.json"))) == jstore.Journal(
            str(tmp_path)).manifest(0)
