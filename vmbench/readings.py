"""The readings that the limits of ``correct`` are set from: for each
seed, one run of the cell at its own size and load, its answers and the
control's answers to the same requests both held to the exact
reference.  All seeds run in one process.

    python3 vmbench/readings.py --workload <cell> --seeds 11,12,13 \\
        --seconds 5

Prints one line a seed, then the lower reading of each number (the
largest the program gave) and the upper (the smallest the control gave).
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from vmbench import harness                                # noqa: E402


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(cell, seed, args.seconds, trace=False,
                               control=True, out=lambda **kw: None)
        prog = {n: c["value"] for n, c in res["compared"].items()}
        ctrl = {n: v for n, (v, _) in res["control"]["numbers"].items()}
        for n, v in prog.items():
            lower[n] = max(lower.get(n, 0.0), v)
        for n, v in ctrl.items():
            upper[n] = min(upper.get(n, float("inf")), v)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "program": prog, "control": ctrl,
                          "control_correct": res["control"]["correct"],
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()}}), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
