#!/usr/bin/env python3
"""Build and run ``scripts/fp32_loop_micro.cu`` on the card: the fp32 FMA
rate on registers alone beside ``topk_f32``'s product loop on a static
shared tile (no copies, barriers or epilogue).  Prints the card's name and
power limit, the clock while the loops run, and one JSON line a loop.

    python3 scripts/fp32_loop_micro.py          # needs nvcc and one card
"""

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        print("fp32_loop_micro: nvcc not found", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "fp32_loop_micro"
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-std=c++17", "-o", str(exe),
                        str(HERE / "fp32_loop_micro.cu")], check=True)
        query = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                 "--format=csv,noheader"]
        print(subprocess.run(query, capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
        run = subprocess.Popen([str(exe)], stdout=subprocess.PIPE, text=True)
        clocks = []
        while run.poll() is None:
            clocks.append(subprocess.run(query, capture_output=True,
                                         text=True).stdout.strip())
        print(run.stdout.read(), end="", flush=True)
        print("clocks while running:", sorted(set(clocks)), flush=True)
        return run.returncode


if __name__ == "__main__":
    sys.exit(main())
