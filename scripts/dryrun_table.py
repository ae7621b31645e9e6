#!/usr/bin/env python3
"""The port's dry-run table: every arch × shape (``--shapes``: a subset)
on the ``1x1`` and ``4x1`` meshes (``--mesh``: any of the dry run's —
``1x4``, ``2x2``, ``pod`` and ``multipod`` among them), one ``python -m
repro_torch.launch.dryrun`` process an arch and shape, ``--jobs`` at a
time, then a markdown table of the JSON records: one row an arch, a
column a shape and mesh, each cell the per-device state and peak GB and
whether the peak fits 80 GB.

    PYTHONPATH=src python scripts/dryrun_table.py --out results/dryrun_torch
    PYTHONPATH=src python scripts/dryrun_table.py --mesh pod,multipod

The default ``--device cuda`` runs fake CUDA tensors, which needs a
PyTorch built with CUDA (no card is used); ``--device cpu`` runs the
CPU path, where the slots of ``4x1`` share one device (no per-card
peak).  A ``pod`` or ``multipod`` cell reckons one slot's program on one
fake device (``launch.dryrun.slot_peaks``), so it needs one card's
ordinal only.  Existing records in ``--out`` are kept.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import arch_names  # noqa: E402
from repro_torch.launch.shapes import SHAPES  # noqa: E402


def run(out: str, device: str, jobs: int, meshes: str, shapes: str) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def one(cell):
        arch, shape = cell
        with open(os.path.join(out, f"{arch}__{shape}.log"), "a") as log:
            subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", meshes,
                 "--device", device, "--out", out], env=env,
                stdout=log, stderr=log)

    # shape by shape, so the cells of the shapes listed first finish first
    with ThreadPoolExecutor(jobs) as pool:
        list(pool.map(one, [(a, s) for s in shapes.split(",")
                            for a in arch_names()]))


def cell(out: str, arch: str, shape: str, mesh: str) -> str:
    """``state / peak`` GB a device, ``✓`` where the peak fits 80 GB;
    ``—`` for a peak not run (the state alone exceeds 80 GB); ``n/a``
    where the slots shared one device (``--device cpu``), so no peak is
    one card's."""
    path = os.path.join(out, f"{arch}__{shape}__{mesh}.json")
    if not os.path.exists(path):
        return "missing"
    rec = json.load(open(path))
    if "skipped" in rec:
        return "skip"
    if "error" in rec:
        return "error"
    pk = rec["per_device_peak_bytes"]
    text = f"{rec['state_bytes']['total'] / 1e9:.1f} / " + (
        f"{pk / 1e9:.1f}" if pk is not None
        else "n/a" if rec["peak_bytes"] else "—")
    return text + (" ✓" if rec["fits_80gb"] else "")


def table(out: str, meshes: str, shapes: str) -> str:
    cols = [(shape, mesh) for shape in shapes.split(",")
            for mesh in meshes.split(",")]
    rows = ["| arch | " + " | ".join(f"{s} {m}" for s, m in cols) + " |",
            "|---|" + "---|" * len(cols)]
    for arch in arch_names():
        rows.append(f"| {arch} | " + " | ".join(
            cell(out, arch, s, m) for s, m in cols) + " |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--mesh", default="1x1,4x1")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated: " + ", ".join(SHAPES))
    ap.add_argument("--table-only", action="store_true",
                    help="print the table of the records in --out")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if not args.table_only:
        run(args.out, args.device, args.jobs, args.mesh, args.shapes)
    print(table(args.out, args.mesh, args.shapes))
    print(f"records: {len(glob.glob(os.path.join(args.out, '*.json')))}")


if __name__ == "__main__":
    main()
