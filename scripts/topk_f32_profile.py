#!/usr/bin/env python3
"""Device time of one ``ops.topk`` call at the unfiltered shape (Q = 128,
N = 1,048,576, d = 128, kp = 16, l2, f32), split by kernel with
``torch.profiler``: ``topk_f32``'s split-N pass, the merge of the partial
lists and the two memsets of its scratch.  Seeded random table; each
query is a table row plus 0.3·N(0, 1) noise, as in ``chip_smoke.py``'s
unfiltered phase.

    python3 scripts/topk_f32_profile.py        # needs one card
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("topk_f32_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.distance_topk import distance_topk
    _build.library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d, q, calls = 1 << 20, 128, 128, 10
    y = torch.randn((n, d), generator=gen, device="cuda")
    rows = torch.randint(0, n, (q,), generator=gen, device="cuda")
    x = (y[rows] + 0.3 * torch.randn((q, d), generator=gen,
                                     device="cuda")).contiguous()
    for _ in range(3):
        distance_topk(x, y, 16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            distance_topk(x, y, 16)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            print(f"{e.key[:72]:72s} launches {e.count:3d}  ms a call "
                  f"{e.device_time_total / 1000 / calls:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
