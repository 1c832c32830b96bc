"""Durable retrieval state, the port of `repro.core.store`: checksummed
segments, atomic commits, generation snapshots and a write-ahead log.

  * **Checksummed segment files**: magic + version + JSON meta +
    per-record CRC32. `read_segment` refuses anything truncated,
    bit-flipped or foreign with `CorruptSegmentError`.
  * **Atomic writes**: a segment (or a raw payload) stages to
    `path + ".tmp"`, is fsync'd, then `os.replace`d, so a crash leaves
    the previous file or the new one, never a torn mix.
  * **Generation snapshots** (`Journal`): a full index save is a
    `gen_XXXXXXXX/` directory with a `MANIFEST.json` of per-file CRCs,
    staged under `.tmp` and committed by one rename. Readers trust only
    directories whose manifest exists at the final path.
  * **A write-ahead log** per generation (`wal_XXXXXXXX.log`): a
    mutation is appended and fsync'd before it applies, so every
    acknowledged op survives kill -9; load replays the WAL on top of the
    generation, and the next save folds it into a new generation and
    rotates the log. A torn tail was never acknowledged and is dropped.

The bytes are the reference's: a file written by either package has the
same framing, the same CRCs and the same fs events in the same order
(`_fs_event`: `segment.write`, `segment.fsync`, `segment.rename`,
`raw.*`, `dir.replace`, `dir.replaced`, `wal.write`, `wal.fsync`,
`gen.manifest`, `gen.commit`, `wal.rotate`; `core/tiered.py` adds
`cold.append` and `cold.fsync`), so a crash plan that stops the n-th op
stops the same op in both. The ``REPRO_STORE_CRASH_AT`` variable arms a
hard exit at the n-th op, as in the reference.

Every pickled record the port reads goes through `loads`, whose
unpickler maps the reference's class paths to the port's by name
(`CLASS_MAP`) and refuses any other `repro.` path with
`CorruptSegmentError`, never importing `repro`. So a generation the JAX
package committed loads into the port. The port writes its own class
paths, so its pickled records differ from the reference's by those
strings only.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import re
import shutil
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"RSG1"          # repro segment, format v1
WAL_MAGIC = b"RWL1"      # repro write-ahead log, format v1
VERSION = 1
_HDR = struct.Struct("<4sHHII")    # magic, version, flags, meta_len, meta_crc
_REC = struct.Struct("<QI")        # record length, record crc32
_WAL_HDR = struct.Struct("<4sHHQ")  # magic, version, flags, generation
_WAL_REC = struct.Struct("<II")    # frame length, frame crc32

MANIFEST = "MANIFEST.json"
GEN_PREFIX = "gen_"
_GEN_RE = re.compile(r"^gen_(\d{8})$")

# the reference's pickled classes and their counterparts in the port
CLASS_MAP = {
    ("repro.core.hnsw", "HNSW"): ("repro_torch.core.hnsw", "HNSW"),
    ("repro.core.scr", "SCRConfig"): ("repro_torch.core.scr", "SCRConfig"),
}


class StoreError(Exception):
    """Base class for durable-store failures."""


class CorruptSegmentError(StoreError):
    """A file failed magic/version/length/CRC validation (bit-rot,
    truncation, or a foreign file where a segment was expected)."""


# ----------------------------------------------------------------- pickles


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "repro" or module.startswith("repro."):
            target = CLASS_MAP.get((module, name))
            if target is None:
                raise CorruptSegmentError(
                    f"pickled class {module}.{name} has no counterpart in "
                    f"the port")
            module, name = target
        return super().find_class(module, name)


def loads(blob: bytes) -> Any:
    """Unpickle a record written by either package (`CLASS_MAP`)."""
    return _Unpickler(io.BytesIO(blob)).load()


# --------------------------------------------------------------- crash hooks

_crash_hook: Optional[Callable[[str, int], None]] = None
_fs_ops = 0


def set_crash_hook(fn: Optional[Callable[[str, int], None]]) -> None:
    """Install (or clear) the fault-injection hook. It receives
    (event_name, op_index) before each durability-relevant fs step and
    may raise or `os._exit` to simulate a crash at exactly that point."""
    global _crash_hook
    _crash_hook = fn


def reset_fs_ops() -> None:
    global _fs_ops
    _fs_ops = 0


def fs_ops() -> int:
    return _fs_ops


def _fs_event(name: str) -> None:
    global _fs_ops
    _fs_ops += 1
    if _crash_hook is not None:
        _crash_hook(name, _fs_ops)


def _env_crash_hook() -> None:
    """Arm a hard-exit crash hook from the environment: the kill -9
    harness sets REPRO_STORE_CRASH_AT=<n> (and optionally
    REPRO_STORE_CRASH_EXIT=<code>) so the n-th fs op ends the process
    without cleanup, like a power cut."""
    at = int(os.environ.get("REPRO_STORE_CRASH_AT", "0") or 0)
    if at <= 0:
        return
    code = int(os.environ.get("REPRO_STORE_CRASH_EXIT", "42"))

    def hook(name: str, count: int) -> None:
        if count >= at:
            os._exit(code)

    set_crash_hook(hook)


_env_crash_hook()


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync so a rename survives power loss."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ------------------------------------------------------------ segment format

def _encode_segment(records: List[bytes], meta: Dict[str, Any]) -> bytes:
    mb = json.dumps(meta, sort_keys=True).encode()
    out = [_HDR.pack(MAGIC, VERSION, 0, len(mb), zlib.crc32(mb)), mb,
           struct.pack("<I", len(records))]
    for r in records:
        out.append(_REC.pack(len(r), zlib.crc32(r)))
        out.append(r)
    return b"".join(out)


def write_segment(path: str, records: List[bytes],
                  meta: Optional[Dict[str, Any]] = None, *,
                  kind: str = "blob") -> None:
    """Atomically write a checksummed segment: stage to `.tmp`, fsync,
    rename over `path`, fsync the directory."""
    meta = dict(meta or {})
    meta.setdefault("kind", kind)
    blob = _encode_segment(records, meta)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        _fs_event("segment.write")
        f.flush()
        os.fsync(f.fileno())
    _fs_event("segment.fsync")
    os.replace(tmp, path)
    _fs_event("segment.rename")
    _fsync_dir(os.path.dirname(path))


def atomic_write_bytes(path: str, blob: bytes) -> None:
    """Atomically replace `path` with raw bytes (no segment framing), for
    payloads whose integrity a companion manifest tracks (the tiered cold
    pack's per-cluster CRCs)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        _fs_event("raw.write")
        f.flush()
        os.fsync(f.fileno())
    _fs_event("raw.fsync")
    os.replace(tmp, path)
    _fs_event("raw.rename")
    _fsync_dir(os.path.dirname(path))


def decode_segment(blob: bytes,
                   path: str = "<bytes>") -> Tuple[Dict[str, Any],
                                                   List[bytes]]:
    """Validate and decode segment bytes (magic, version, meta CRC, every
    record CRC, exact length); raises CorruptSegmentError otherwise."""
    def bad(reason: str) -> CorruptSegmentError:
        return CorruptSegmentError(f"{path}: {reason}")

    if len(blob) < _HDR.size:
        raise bad(f"truncated header ({len(blob)} bytes)")
    magic, ver, flags, mlen, mcrc = _HDR.unpack_from(blob, 0)
    if magic != MAGIC:
        raise bad(f"bad magic {magic!r} (expected {MAGIC!r})")
    if ver != VERSION:
        raise bad(f"unsupported segment version {ver}")
    if flags != 0:
        raise bad(f"unsupported flags 0x{flags:04x}")
    off = _HDR.size
    if len(blob) < off + mlen + 4:
        raise bad("truncated metadata")
    mb = blob[off:off + mlen]
    if zlib.crc32(mb) != mcrc:
        raise bad("metadata CRC mismatch")
    try:
        meta = json.loads(mb.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise bad(f"metadata undecodable: {e}") from None
    off += mlen
    (nrec,) = struct.unpack_from("<I", blob, off)
    off += 4
    records: List[bytes] = []
    for i in range(nrec):
        if len(blob) < off + _REC.size:
            raise bad(f"truncated at record {i} header")
        rlen, rcrc = _REC.unpack_from(blob, off)
        off += _REC.size
        if len(blob) < off + rlen:
            raise bad(f"truncated at record {i} payload "
                      f"({len(blob) - off} of {rlen} bytes)")
        payload = blob[off:off + rlen]
        if zlib.crc32(payload) != rcrc:
            raise bad(f"record {i} CRC mismatch")
        records.append(payload)
        off += rlen
    if off != len(blob):
        raise bad(f"{len(blob) - off} trailing bytes after last record")
    return meta, records


def _check_kind(path: str, meta: Dict[str, Any], kind: Optional[str]):
    if kind is not None and meta.get("kind") != kind:
        raise CorruptSegmentError(
            f"{path}: kind {meta.get('kind')!r} where {kind!r} expected")


def read_segment(path: str,
                 kind: Optional[str] = None) -> Tuple[Dict[str, Any],
                                                      List[bytes]]:
    """Read and validate a segment file; `kind` (when given) must match
    the writer's."""
    with open(path, "rb") as f:
        blob = f.read()
    meta, records = decode_segment(blob, path)
    _check_kind(path, meta, kind)
    return meta, records


def verify_segment(path: str, kind: Optional[str] = None) -> bytes:
    """Validate a segment file and return its raw bytes (the copy of a
    spill file into a snapshot is refused if it no longer checks out)."""
    with open(path, "rb") as f:
        blob = f.read()
    meta, _ = decode_segment(blob, path)
    _check_kind(path, meta, kind)
    return blob


def dump_obj(path: str, obj: Any, *, kind: str = "pickle") -> None:
    """Atomic, checksummed pickle of `obj` (a one-record segment)."""
    write_segment(path,
                  [pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)],
                  kind=kind)


def load_obj(path: str, *, kind: Optional[str] = None) -> Any:
    """Unpickle a `dump_obj` file of either package after checking
    magic, length and CRC."""
    _, records = read_segment(path, kind=kind)
    if len(records) != 1:
        raise CorruptSegmentError(
            f"{path}: expected 1 record, found {len(records)}")
    return loads(records[0])


def array_record(a: np.ndarray) -> Tuple[bytes, Dict[str, Any]]:
    """(payload bytes, spec) for storing a numpy array as one record."""
    a = np.ascontiguousarray(a)
    return a.tobytes(), {"dtype": str(a.dtype), "shape": list(a.shape)}


def record_array(payload: bytes, spec: Dict[str, Any]) -> np.ndarray:
    a = np.frombuffer(payload, dtype=np.dtype(spec["dtype"]))
    expect = int(np.prod(spec["shape"])) if spec["shape"] else 1
    if a.size != expect:
        raise CorruptSegmentError(
            f"array record: {a.size} elements where shape "
            f"{spec['shape']} implies {expect}")
    return a.reshape(spec["shape"]).copy()


# ------------------------------------------------- atomic dir commit helpers

def atomic_replace_dir(tmp: str, final: str) -> None:
    """Commit a fully staged directory over `final` with one rename
    (removing a previous `final` first: a re-commit of the same
    number)."""
    if os.path.isdir(final):
        shutil.rmtree(final)
    _fs_event("dir.replace")
    os.replace(tmp, final)
    _fs_event("dir.replaced")
    _fsync_dir(os.path.dirname(final))


def numbered_dirs(root: str, prefix: str, gate_file: str) -> List[int]:
    """Committed `<prefix>NNNNNNNN` directories under `root`, ascending.
    Only directories holding `gate_file` count: a crash mid-commit
    leaves at worst a `.tmp` (or a gate-less dir) that is ignored."""
    if not os.path.isdir(root):
        return []
    pat = re.compile(r"^" + re.escape(prefix) + r"(\d{8})$")
    out = []
    for name in os.listdir(root):
        m = pat.match(name)
        if m and os.path.isfile(os.path.join(root, name, gate_file)):
            out.append(int(m.group(1)))
    return sorted(out)


# ------------------------------------------------------------ write-ahead log

class WriteAheadLog:
    """Append-only, CRC-framed mutation log. `append` is durable when it
    returns (frame written, flushed and fsync'd); `replay` yields every
    intact frame and drops a torn tail, which was never acknowledged."""

    def __init__(self, path: str, generation: int = 0):
        self.path = path
        self.generation = generation
        self._f = None

    def append(self, payload: bytes) -> None:
        if self._f is None:
            fresh = (not os.path.exists(self.path)
                     or os.path.getsize(self.path) == 0)
            self._f = open(self.path, "ab")
            if fresh:
                self._f.write(_WAL_HDR.pack(WAL_MAGIC, VERSION, 0,
                                            self.generation))
        frame = _WAL_REC.pack(len(payload), zlib.crc32(payload)) + payload
        self._f.write(frame)
        _fs_event("wal.write")
        self._f.flush()
        os.fsync(self._f.fileno())
        _fs_event("wal.fsync")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    @staticmethod
    def replay(path: str) -> Tuple[List[bytes], bool]:
        """(intact frames, torn_tail). A missing, empty or torn-header
        log replays as no ops: nothing in it was acknowledged."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return [], False
        if len(blob) < _WAL_HDR.size:
            return [], len(blob) > 0
        magic, ver, _flags, _gen = _WAL_HDR.unpack_from(blob, 0)
        if magic != WAL_MAGIC or ver != VERSION:
            return [], True
        off = _WAL_HDR.size
        ops: List[bytes] = []
        while off < len(blob):
            if len(blob) < off + _WAL_REC.size:
                return ops, True
            rlen, rcrc = _WAL_REC.unpack_from(blob, off)
            off += _WAL_REC.size
            if len(blob) < off + rlen:
                return ops, True
            payload = blob[off:off + rlen]
            if zlib.crc32(payload) != rcrc:
                # nothing after a corrupt frame can be trusted
                return ops, True
            ops.append(payload)
            off += rlen
        return ops, False


# ------------------------------------------------------- generation journal

class Journal:
    """Generation-numbered snapshot directory + per-generation WAL.

    Layout under `root`::

        gen_00000000/           committed snapshot (MANIFEST.json gate)
        gen_00000001.tmp/       crashed partial commit (ignored)
        wal_00000001.log        mutations since gen 1 was committed

    `begin()` stages a tmp dir the caller fills; `commit()` writes a
    manifest of per-file CRC32s, renames the dir into place and rotates
    the WAL. `append()` / `replay()` journal mutations against the
    current generation."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._staged: Optional[Tuple[int, str]] = None
        self._wal: Optional[WriteAheadLog] = None
        self._gen: Optional[int] = self.latest()

    def gen_dir(self, g: int) -> str:
        return os.path.join(self.root, f"{GEN_PREFIX}{g:08d}")

    def wal_path(self, g: int) -> str:
        return os.path.join(self.root, f"wal_{g:08d}.log")

    def generations(self) -> List[int]:
        return numbered_dirs(self.root, GEN_PREFIX, MANIFEST)

    def latest(self) -> Optional[int]:
        gens = self.generations()
        return gens[-1] if gens else None

    @property
    def generation(self) -> Optional[int]:
        return self._gen

    def begin(self) -> str:
        """Stage the next generation; returns the tmp dir to fill. A
        stale tmp of a crashed commit is discarded."""
        latest = self.latest()
        g = (latest if latest is not None else -1) + 1
        tmp = self.gen_dir(g) + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        self._staged = (g, tmp)
        return tmp

    def commit(self) -> int:
        """Manifest, atomic rename, WAL rotation. A crash before the
        rename keeps the previous generation and its whole WAL; after
        it, the new generation holds every folded op and the stale WAL
        is ignored by name and removed at the next commit."""
        if self._staged is None:
            raise StoreError("commit() without begin()")
        g, tmp = self._staged
        files = {}
        for name in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, name), "rb") as f:
                blob = f.read()
            files[name] = {"size": len(blob), "crc32": zlib.crc32(blob)}
        man = {"generation": g, "files": files}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(man, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        _fs_event("gen.manifest")
        atomic_replace_dir(tmp, self.gen_dir(g))
        _fs_event("gen.commit")
        self._staged = None
        # rotate: the committed snapshot holds every logged mutation
        if self._wal is not None:
            self._wal.close()
        self._gen = g
        self._wal = None
        for name in os.listdir(self.root):
            if name.startswith("wal_") and name != f"wal_{g:08d}.log":
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass
        _fs_event("wal.rotate")
        return g

    def manifest(self, g: int) -> Dict[str, Any]:
        with open(os.path.join(self.gen_dir(g), MANIFEST)) as f:
            return json.load(f)

    def read_file(self, g: int, name: str, verify: bool = True) -> bytes:
        """A generation file's bytes, checked against the manifest CRC."""
        path = os.path.join(self.gen_dir(g), name)
        with open(path, "rb") as f:
            blob = f.read()
        if verify:
            ent = self.manifest(g)["files"].get(name)
            if ent is None:
                raise CorruptSegmentError(f"{path}: not in manifest")
            if len(blob) != ent["size"] or zlib.crc32(blob) != ent["crc32"]:
                raise CorruptSegmentError(
                    f"{path}: manifest CRC/size mismatch (bit-rot inside "
                    f"a committed generation)")
        return blob

    def read_segment(self, g: int, name: str, kind: str,
                     n_records: int) -> Tuple[Dict[str, Any], List[bytes]]:
        """A generation's segment file, checked against the manifest,
        its own CRCs, its kind and its record count."""
        path = os.path.join(self.gen_dir(g), name)
        meta, recs = decode_segment(self.read_file(g, name), path)
        if meta.get("kind") != kind or len(recs) != n_records:
            raise CorruptSegmentError(
                f"{path}: generation {g} {kind} segment malformed")
        return meta, recs

    def append(self, payload: bytes) -> None:
        if self._gen is None:
            raise StoreError(
                "WAL append before any committed generation: call save() "
                "once to establish the base snapshot")
        if self._wal is None:
            self._wal = WriteAheadLog(self.wal_path(self._gen), self._gen)
        self._wal.append(payload)

    def replay(self) -> Tuple[List[bytes], bool]:
        if self._gen is None:
            return [], False
        return WriteAheadLog.replay(self.wal_path(self._gen))

    def wal_records(self) -> int:
        return len(self.replay()[0])

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    def scrub(self, deep: bool = True) -> List[Dict[str, Any]]:
        """Verify every committed generation (manifest CRCs, and with
        `deep` every segment's own record CRCs) and the active WAL. One
        report dict per item; `ok=False` entries are corruption."""
        out: List[Dict[str, Any]] = []
        for g in self.generations():
            try:
                man = self.manifest(g)
            except (OSError, json.JSONDecodeError) as e:
                out.append({"item": self.gen_dir(g), "ok": False,
                            "error": f"unreadable manifest: {e}"})
                continue
            for name in man["files"]:
                path = os.path.join(self.gen_dir(g), name)
                rep = {"item": path, "ok": True}
                try:
                    blob = self.read_file(g, name)
                    if deep and name.endswith((".seg", ".bin")):
                        decode_segment(blob, path)
                except (OSError, StoreError) as e:
                    rep = {"item": path, "ok": False, "error": str(e)}
                out.append(rep)
        if self._gen is not None:
            wp = self.wal_path(self._gen)
            if os.path.exists(wp):
                ops, torn = WriteAheadLog.replay(wp)
                out.append({"item": wp, "ok": not torn, "records": len(ops),
                            **({"error": "torn/corrupt tail"} if torn
                               else {})})
        return out


def scrub_path(path: str, deep: bool = True) -> List[Dict[str, Any]]:
    """Scrub a Journal root (gen_* dirs / wal_* logs), a plain spill
    directory of segment files, or one segment file."""
    if not os.path.isdir(path):
        rep: Dict[str, Any] = {"item": path, "ok": True}
        try:
            read_segment(path)
        except (OSError, StoreError) as e:
            rep = {"item": path, "ok": False, "error": str(e)}
        return [rep]
    names = os.listdir(path)
    if any(_GEN_RE.match(n) for n in names) or any(
            n.startswith("wal_") for n in names):
        return Journal(path).scrub(deep=deep)
    out = []
    for name in sorted(names):
        p = os.path.join(path, name)
        if not os.path.isfile(p) or name.endswith(
                (".tmp", ".quarantined", ".raw")):
            # .raw payloads carry no framing: their per-cluster CRCs live
            # in a companion manifest (`tiered.scrub_cold_pack`)
            continue
        try:
            read_segment(p)
            out.append({"item": p, "ok": True})
        except (OSError, StoreError) as e:
            out.append({"item": p, "ok": False, "error": str(e)})
    return out


def quarantine_file(path: str) -> Optional[str]:
    """Move a corrupt file aside (``path + ".quarantined"``) so readers
    stop tripping on it but the bytes stay for forensics or a rebuild.
    Returns the new path, or None if the move failed."""
    dst = path + ".quarantined"
    try:
        os.replace(path, dst)
        return dst
    except OSError:
        return None
