#!/usr/bin/env python3
"""A/B of two checkouts on one card: ``chip_smoke.py``'s main path, the
kernel measurements that follow it and the unfiltered phase, in the
order ``chip_smoke.main`` runs them, for the checkout at ``argv[1]``.

Compare two commits inside one machine call, in turns, e.g. with the
parent unpacked by ``git archive`` into an ignored directory:

    for t in build/parent . . build/parent; do python3 chip_ab.py $t; done

Prints the phases' JSON lines and one ``AB <checkout> {kernel: ms}``
line per run.
"""

import json
import sys

if __name__ == "__main__":
    root = sys.argv[1]
    sys.path.insert(0, root)
    sys.path.insert(0, root + "/src")
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    out = cs.phase_main_path()
    (args_a, la, ta), (args_b, lb, tb), call, table = out[:4]
    kernels = [cs.measure_kernel_a(*args_a, la, ta),
               cs.measure_kernel_b(args_b[0], lb, tb)]
    del args_a, args_b
    torch.cuda.empty_cache()
    kernels[1]["sq8_call"] = cs.measure_sq8_call(call)
    del call
    torch.cuda.empty_cache()
    kernels += cs.phase_unfiltered(table)
    print("AB", root, json.dumps({k["name"]: k["ms"] for k in kernels}),
          flush=True)
