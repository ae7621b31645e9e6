#!/usr/bin/env python3
"""Hold the dry run's one-slot reckoning against the whole program.

For the five families' smoke configs (one layer; the hybrid one period
of two), the train step, prefill and decode of 4 sequences of 8 tokens
at ``4x1``, ``1x4`` and ``2x2``: slot 0's and slot n−1's peak as
``launch.dryrun.slot_peaks`` reckons it (the other slots on ``meta``,
their work not run) beside ``MemTracker``'s peak of the same slot in
the whole program (the other slots on ``meta``, their work run), both
on fake CPU tensors.  Prints one line a comparison and exits 1 if any
differ.

    PYTHONPATH=src python scripts/one_slot_check.py [--families dense,moe]
        [--kinds train] [--meshes 2x2]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402

FAMILIES = {"dense": "h2o-danube-1.8b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-370m", "hybrid": "jamba-1.5-large-398b",
            "encdec": "whisper-base"}
CUT = {"dense": dict(num_layers=1), "moe": dict(num_layers=1),
       "ssm": dict(num_layers=1),
       "hybrid": dict(num_layers=2, attn_period=2, attn_index=1),
       "encdec": dict(num_layers=1, num_encoder_layers=1)}


def config(family):
    return smoke_config(FAMILIES[family]).replace(**CUT[family])


def shape(kind):
    return shapes.ShapeSpec(kind, kind, 8, 4)


def compare(family, kind, mesh_name):
    """(slot, the whole program's peak, the reckoning) for slots 0 and
    n−1."""
    cfg, spec = config(family), shape(kind)
    base = dryrun.make_mesh(mesh_name, "cpu")
    out = []
    for s in sorted({0, base.size - 1}):
        whole = dryrun.measure_peak(cfg, spec,
                                    dryrun.slot_mesh(base, s, "cpu"))["cpu"]
        one = dryrun.slot_peaks(cfg, spec, base, "cpu", slots=[s])
        out.append((s, whole, one[f"slot {s}"]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--kinds", default="train,prefill,decode")
    ap.add_argument("--meshes", default="4x1,1x4,2x2")
    args = ap.parse_args()
    torch.set_num_threads(1)
    bad = total = 0
    for family in args.families.split(","):
        for kind in args.kinds.split(","):
            for mesh in args.meshes.split(","):
                t0 = time.perf_counter()
                for s, whole, one in compare(family, kind, mesh):
                    total += 1
                    bad += whole != one
                    print(f"{family} {kind} {mesh} slot {s}: whole {whole} "
                          f"one slot {one} "
                          f"{'equal' if whole == one else 'DIFFER'} "
                          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"{total - bad} of {total} equal")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
