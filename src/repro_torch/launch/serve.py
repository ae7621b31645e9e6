"""Serving launcher — build a VectorMaton index over a corpus and serve
batched pattern-constrained queries on the port.

Port of ``src/repro/launch/serve.py``, plus ``--device`` (default
``cuda``: the card; ``cpu`` runs the plain PyTorch path):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --corpus spam --queries 200 --pattern-len 3 --k 10
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.baselines import ground_truth, recall
from ..core.vectormaton import VectorMatonConfig
from ..data.corpora import make_corpus, sample_patterns
from ..serve.engine import Request, RetrievalEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="spam")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--pattern-len", type=int, default=3)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ef-search", type=int, default=64)
    ap.add_argument("--T", type=int, default=200)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=None)
    args = ap.parse_args(argv)

    vecs, seqs = make_corpus(args.corpus, scale=args.scale)
    print(f"[serve] corpus {args.corpus}: n={len(seqs)} "
          f"total_len={sum(len(s) for s in seqs)} dim={vecs.shape[1]} "
          f"device={args.device}")
    t0 = time.time()
    eng = RetrievalEngine(vecs, seqs,
                          VectorMatonConfig(T=args.T, M=16, ef_con=100,
                                            device=args.device),
                          workers=args.workers)
    print(f"[serve] index built in {time.time()-t0:.1f}s; "
          f"stats={eng.index.stats()}")

    pats = sample_patterns(seqs, args.pattern_len, args.queries)
    rng = np.random.default_rng(0)
    reqs = [Request(vector=rng.standard_normal(vecs.shape[1]
                                               ).astype(np.float32),
                    pattern=p, k=args.k, ef_search=args.ef_search)
            for p in pats]
    t0 = time.time()
    resps = eng.serve_batch(reqs)
    dt = time.time() - t0
    recs = []
    for r, resp in zip(reqs, resps):
        gt = ground_truth(eng.index.vectors, eng.index.esam, r.pattern,
                          r.vector, r.k)
        recs.append(recall(resp.ids, gt))
    print(f"[serve] {len(reqs)} queries in {dt:.2f}s "
          f"({len(reqs)/dt:.0f} QPS), mean recall@{args.k} "
          f"{np.mean(recs):.3f}")
    if args.checkpoint:
        eng.checkpoint(args.checkpoint)
        print(f"[serve] index checkpointed to {args.checkpoint}")


if __name__ == "__main__":
    main()
