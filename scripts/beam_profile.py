#!/usr/bin/env python3
"""Step time of the fused HNSW beam (``beam_f32``, ``csrc/beam.cu``)
against the number of pairs in flight, on ``chip_smoke.py``'s beam bucket
(8 graphs of 131,072 nodes over ``make_scale_corpus(1_048_576, 128)``,
32-NN lists, 64 queries a graph, ef = 64, k = 10, float l2): for P of 1,
8, 132, 264 and 512 pairs (a subset spread over the graphs; 132 pairs is
one block an SM) the kernel's ms, the longest pair's steps, µs a step
and its clock64() cycles a step by phase, beside the same for the
parent's kernel when ``build/parent`` holds an unpacked parent checkout;
then the SASS instruction count of each ``beam_f32_kernel``
instantiation (``cuobjdump``).

    python3 scripts/beam_profile.py
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

PAIRS = (1, 8, 132, 264, 512)


def sass_counts(lib_path: Path) -> dict:
    """Instructions of each beam_f32_kernel instantiation in the SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if "beam_f32_kernel" in m.group(1) else None
            if name:
                args = re.findall(r"L[bi](\d+)E", name)
                name = f"beam_f32_kernel<{','.join(args)}>"
                counts[name] = 0
            continue
        if name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", ln):
            counts[name] += 1
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("beam_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import hnsw_torch
    from repro_torch.data.corpora import make_scale_corpus
    from repro_torch.kernels import _build
    _build.library()
    print(cs.card_line(), flush=True)
    parent = cs.parent_hnsw()
    table = torch.from_numpy(make_scale_corpus(1_048_576, 128)[0]).cuda()
    ids, level0, entry = cs.beam_graphs(table, seed=5)["bucket"]
    nbr = hnsw_torch.neighbour_table(ids, level0)
    rng = torch.Generator(device="cuda").manual_seed(6)
    rows = torch.randint(0, table.shape[0], (cs.BEAM_QUERIES,),
                         generator=rng, device="cuda")
    q = (table[rows] + 0.3 * torch.randn((cs.BEAM_QUERIES, table.shape[1]),
                                         generator=rng, device="cuda"))
    gidx = torch.arange(cs.BEAM_GRAPHS, dtype=torch.int32,
                        device="cuda").repeat_interleave(cs.BEAM_QUERIES)
    queries = q.repeat(cs.BEAM_GRAPHS, 1).contiguous()
    kw = dict(k=cs.K, ef=cs.BEAM_EF, metric="l2")
    for p in PAIRS:
        pick = torch.arange(0, 512, 512 // p, device="cuda")[:p]
        a = (table, ids, nbr, entry, gidx[pick].contiguous(),
             queries[pick].contiguous())
        old = (table, ids, level0) + a[3:]
        line = {"pairs": p}
        _, _, st = hnsw_torch.beam_f32(*a, stats=True, **kw)
        split = cs.beam_split(st)
        ms = cs.cuda_ms(lambda: hnsw_torch.beam_f32(*a, **kw), reps=50)
        line["this"] = {"ms": ms, "steps": split["steps"],
                        "us_per_step": ms * 1e3 / max(split["steps"], 1),
                        "cycles_per_step": {
                            k: round(v) for k, v in
                            split["cycles_per_step"].items()}}
        if parent is not None:
            _, _, st = parent.beam_f32(*old, stats=True, **kw)
            ms = cs.cuda_ms(lambda: parent.beam_f32(*old, **kw), reps=50)
            steps = int(st["steps"].max())
            line["parent"] = {"ms": ms, "steps": steps,
                              "us_per_step": ms * 1e3 / max(steps, 1)}
        print(json.dumps(line), flush=True)
    print(json.dumps({"sass": sass_counts(
        _build.build_dir() / "libkernels.so")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
