"""Per-op byte and FLOP breakdown of a dry-run cell: the profile of the
cost model (no clock on the host; the count is the profile). The port
of `repro.roofline.breakdown`, over a trace instead of HLO text.

  PYTHONPATH=src python -m repro_torch.roofline.breakdown --arch \\
      qwen25_0_5b --shape decode_32k [--multi-pod] [--top 25]
"""
from __future__ import annotations

import argparse


def breakdown(cost: dict, top: int = 25) -> str:
    """Bytes and FLOPs by aten op (kernel nodes by name, "kernel.<name>")
    and the largest single ops of a `graph.trace_cost` dict, as text."""
    lines = ["== bytes by op =="]
    ops = sorted(cost["ops"].items(), key=lambda kv: -kv[1]["bytes"])
    for name, r in ops[:top]:
        lines.append(f"{name:40s} {r['bytes'] / 1e9:12.3f} GB "
                     f"{r['flops'] / 1e12:10.3f} TFLOP x{r['n']}")
    lines.append("")
    lines.append("== top single ops (bytes) ==")
    for t in cost["top"][:top]:
        lines.append(f"{t['bytes'] / 1e9:10.3f} GB {t['op']:32s} "
                     f"{t['shapes']}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import dryrun
    mesh = dryrun.production_mesh(args.multi_pod)
    sh.set_fsdp_spans_pods(args.multi_pod and dryrun.get_config(
        args.arch).param_count() > dryrun.FSDP_PODS_PARAMS)
    cost, _ = dryrun.trace_cell(args.arch, args.shape, mesh)
    dryrun.release()
    print(breakdown(cost, args.top))


if __name__ == "__main__":
    main()
