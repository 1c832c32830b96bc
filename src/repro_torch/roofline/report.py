"""The dry run's JSONs as the roofline table (markdown and CSV), and the
cells worth a closer look. The port of `repro.roofline.report`, with
the H100's HBM fit (80 GB) for the TPU's 16 GB.

  PYTHONPATH=src python -m repro_torch.roofline.report [--dir results/dryrun]
      [--csv out.csv]
"""
from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

HDRS = ["arch", "shape", "mesh", "chips", "t_compute_s", "t_memory_s",
        "t_collective_s", "dominant", "model_flops", "flops_total",
        "useful_ratio", "roofline_frac", "peak_GB_per_dev", "fits_80g"]


def load(outdir: Path) -> list:
    """One row a model cell's JSON (the retrieval cells and the summary
    are not model cells); an error row for a cell that failed."""
    rows = []
    for f in sorted(Path(outdir).glob("*.json")):
        r = json.loads(f.read_text())
        if "arch" not in r or "shape" not in r:
            continue
        if r.get("status") != "ok":
            rows.append({"arch": r["arch"], "shape": r["shape"],
                         "mesh": r["mesh"], "error": r.get("error")})
            continue
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "chips": r["chips"], "t_compute_s": r["t_compute_s"],
            "t_memory_s": r["t_memory_s"],
            "t_collective_s": r["t_collective_s"],
            "dominant": r["dominant"], "model_flops": r["model_flops"],
            "flops_total": r["flops_total"],
            "useful_ratio": r.get("useful_flops_ratio"),
            "roofline_frac": r.get("roofline_fraction"),
            "peak_GB_per_dev": (r.get("peak_bytes_per_device") or 0) / 1e9,
            "fits_80g": r.get("fits_hbm_80g"),
        })
    return rows


def fmt(v) -> str:
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return f"{v:.4g}"
    return str(v)


def markdown(rows, mesh: str = "pod1") -> str:
    out = ["| " + " | ".join(HDRS) + " |", "|" + "---|" * len(HDRS)]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | {mesh} | error: "
                       f"{r['error']} |")
            continue
        out.append("| " + " | ".join(fmt(r.get(h, "")) for h in HDRS)
                   + " |")
    return "\n".join(out)


def interesting(rows) -> dict:
    """The three cells to climb first: the worst fit (else the lowest
    roofline fraction), the most collective-bound, and the one most like
    the paper's serving (decode on the sLM-class generator)."""
    ok = [r for r in rows if r.get("mesh") == "pod1" and "error" not in r
          and r.get("roofline_frac")]
    over = [r for r in ok if r.get("fits_80g") is False]
    worst = max(over, key=lambda r: r["peak_GB_per_dev"]) if over else \
        min(ok, key=lambda r: r["roofline_frac"])
    coll = max(ok, key=lambda r: r["t_collective_s"] /
               max(r["t_compute_s"], r["t_memory_s"], 1e-12))
    rep = next((r for r in ok if r["arch"] == "h2o_danube_1_8b"
                and r["shape"] == "decode_32k"), ok[0])
    return {"worst_fit_or_roofline": worst, "most_collective_bound": coll,
            "paper_representative": rep}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--csv", default="")
    args = ap.parse_args(argv)
    rows = load(Path(args.dir))
    print(markdown(rows, "pod1"))
    print()
    print("## multi-pod (pod2)")
    print(markdown(rows, "pod2"))
    print()
    for why, r in interesting(rows).items():
        print(f"hillclimb[{why}]: {r['arch']} x {r['shape']} "
              f"(dominant={r['dominant']}, frac={fmt(r['roofline_frac'])})")
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=HDRS + ["error"],
                               extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)


if __name__ == "__main__":
    main()
