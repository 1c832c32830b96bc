"""Checksummed segment files: the port's copy of the segment format of
`repro.core.store`.

A segment is magic + version + JSON meta + per-record CRC32, written with
the atomic stage -> fsync -> rename protocol, so a crash leaves either
the previous file or the new one, and `read_segment` refuses anything
truncated, bit-flipped or foreign with `CorruptSegmentError`. The bytes
are the reference's format: a file written by either package loads in
the other. The reference's crash hooks, generation journal and WAL are
not ported yet.
"""
from __future__ import annotations

import json
import os
import pickle
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"RSG1"          # repro segment, format v1
VERSION = 1
_HDR = struct.Struct("<4sHHII")    # magic, version, flags, meta_len, meta_crc
_REC = struct.Struct("<QI")        # record length, record crc32


class StoreError(Exception):
    """Base class for durable-store failures."""


class CorruptSegmentError(StoreError):
    """A file failed magic/version/length/CRC validation (bit-rot,
    truncation, or a foreign file where a segment was expected)."""


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
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
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


def read_segment(path: str,
                 kind: Optional[str] = None) -> Tuple[Dict[str, Any],
                                                      List[bytes]]:
    """Read and validate a segment file; `kind` (when given) must match
    the writer's."""
    with open(path, "rb") as f:
        blob = f.read()
    meta, records = decode_segment(blob, path)
    if kind is not None and meta.get("kind") != kind:
        raise CorruptSegmentError(
            f"{path}: kind {meta.get('kind')!r} where {kind!r} expected")
    return meta, records


def dump_obj(path: str, obj: Any, *, kind: str = "pickle") -> None:
    """Atomic, checksummed pickle of `obj` (a one-record segment)."""
    write_segment(path,
                  [pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)],
                  kind=kind)


def load_obj(path: str, *, kind: Optional[str] = None) -> Any:
    """Unpickle a `dump_obj` file after checking magic, length and CRC."""
    _, records = read_segment(path, kind=kind)
    if len(records) != 1:
        raise CorruptSegmentError(
            f"{path}: expected 1 record, found {len(records)}")
    return pickle.loads(records[0])
