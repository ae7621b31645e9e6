#!/usr/bin/env python3
"""A/B of two checkouts on one card: ``chip_smoke.py``'s main path, the
kernel measurements that follow it and the unfiltered phase, in the
order ``chip_smoke.main`` runs them, for the checkout at ``argv[1]``.

Compare two commits inside one machine call, in turns, e.g. with the
parent unpacked by ``git archive`` into an ignored directory:

    for t in build/parent . . build/parent; do python3 chip_ab.py $t; done

Prints the phases' JSON lines and one ``AB <checkout> {kernel: ms}``
line per run; ``topk_f32_bench_max`` is the checkout's ``distance_topk``
at Q = 1024 × N = 65,536 × d = 768, kp = 16 (``bench_kernels.py``'s
largest shape), timed in the same process.

An optional second argument names LM phases to run first in the same
process, as ``chip_smoke.main`` does, to see what they leave behind for
the main path: ``parity`` (``phase_lm_parity``, whose reference runs on
the CPU) and ``embed`` (``phase_lm_model``, ``phase_lm_embed`` and
``phase_lm_generate`` on the card), ``profile``
(``phase_lm_profile``: one decode step under ``torch.profiler``),
comma-separated; ``build`` starts the LM index
build (``chip_smoke.LMRun``, a child process) over random 3,000 × 2,560
vectors of the mtg corpus, so that it runs beside the main path:

    for b in none parity embed none; do python3 chip_ab.py . $b; done
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    cs.phase_build()
    before = set(sys.argv[2].split(",")) if len(sys.argv) > 2 else set()
    card = cs.card_line()
    if "parity" in before:
        cs.phase_lm_parity(card)
    if "embed" in before:
        model = cs.phase_lm_model(card)
        cs.phase_lm_embed(model, card).stop()
        cs.phase_lm_generate(model, card)
        del model
        torch.cuda.empty_cache()
    if "profile" in before:
        cs.phase_lm_profile(card)
    run = None
    if "build" in before:
        import numpy as np

        from repro_torch.data.corpora import make_corpus
        _, seqs = make_corpus("mtg", scale=1.0)
        vecs = np.random.default_rng(0).standard_normal(
            (len(seqs), 2560)).astype(np.float32)
        requests, attrs = cs.lm_requests(vecs, seqs,
                                         np.random.default_rng(1))
        run = cs.LMRun(seqs, vecs, requests, attrs)
        run.start()
    try:
        out = cs.phase_main_path()
    finally:
        if run is not None:
            run.stop()
    (args_a, la, ta), (args_b, lb, tb), call, table = out[:4]
    kernels = [cs.measure_kernel_a(*args_a, la, ta),
               cs.measure_kernel_b(args_b[0], lb, tb)]
    del args_a, args_b
    torch.cuda.empty_cache()
    kernels[1]["sq8_call"] = cs.measure_sq8_call(call)
    del call
    torch.cuda.empty_cache()
    kernels += cs.phase_unfiltered(table)
    del table
    torch.cuda.empty_cache()
    from repro_torch.kernels.distance_topk import distance_topk
    gen = torch.Generator(device="cuda").manual_seed(7)
    xb = torch.randn((1024, 768), generator=gen, device="cuda")
    yb = torch.randn((65_536, 768), generator=gen, device="cuda")
    ms = {k["name"]: k["ms"] for k in kernels}
    ms["topk_f32_bench_max"] = cs.cuda_ms(lambda: distance_topk(xb, yb, 16),
                                          reps=3)
    print("AB", root, json.dumps(ms), flush=True)
