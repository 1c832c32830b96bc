"""Offline index scrubber (the port of `tools/scrub_index.py`): walk a
durable-store directory and verify every checksum before the data is
needed in anger.

Handles both layouts `core/store.py` produces:

  * a Journal root (``gen_XXXXXXXX/`` snapshots + ``wal_*.log``): every
    committed generation's files are checked against the manifest CRCs,
    segment files are also validated record by record, and the active
    WAL is replayed for torn or corrupt frames;
  * a plain spill directory of segment files (an index's live
    ``storage_dir``).

Tiered indexes get two more passes: the cold pack's payload spans and
CRCs a cluster (``cold_manifest.seg`` / ``cold_payload.raw``, in journal
generations and live spill directories), and the tier assignment of the
latest committed generation (hot and cold disjoint; hot, cold and
quarantined cover every cluster).

Exit status: 0 when everything checks out, 1 when corruption was found.
``--quarantine`` moves corrupt plain files aside
(``<name>.quarantined``) so the owning index rebuilds them on its next
load; committed generation files are never moved (the manifest records
them: the fix is a fresh save()).

Usage:
  python -m repro_torch.launch.scrub_index PATH [PATH ...]
      [--shallow] [--quarantine] [--json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core import store, tiered


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="verify checksums of durable retrieval state")
    p.add_argument("paths", nargs="+",
                   help="journal roots or spill directories to scrub")
    p.add_argument("--shallow", action="store_true",
                   help="manifest CRCs only; skip the validation of each "
                        "segment's records")
    p.add_argument("--quarantine", action="store_true",
                   help="move corrupt plain spill files aside")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    args = p.parse_args(argv)

    reports = []
    for path in args.paths:
        for rep in store.scrub_path(path, deep=not args.shallow):
            rep = dict(rep, root=path)
            plain = (os.path.dirname(os.path.abspath(rep["item"]))
                     == os.path.abspath(path))
            if (not rep["ok"] and args.quarantine and plain
                    and not rep["item"].endswith(".log")):
                rep["quarantined_to"] = store.quarantine_file(rep["item"])
            reports.append(rep)
        if not args.shallow and os.path.isdir(path):
            names = os.listdir(path)
            if any(n.startswith(("gen_", "wal_")) for n in names):
                extra = tiered.scrub_tier_state(path)
            else:
                extra = tiered.scrub_cold_pack(path)
            reports.extend(dict(r, root=path) for r in extra)

    bad = [r for r in reports if not r["ok"]]
    if args.as_json:
        json.dump({"checked": len(reports), "corrupt": len(bad),
                   "reports": reports}, sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        for r in reports:
            mark = "ok  " if r["ok"] else "BAD "
            extra = f"  ({r['error']})" if not r["ok"] else ""
            print(f"{mark}{r['item']}{extra}")
        print(f"scrub: {len(reports)} items, {len(bad)} corrupt")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
