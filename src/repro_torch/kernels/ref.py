"""Plain PyTorch oracles of the distance kernels.

Port of ``src/repro/kernels/ref.py``.  The plain versions of the CUDA
kernels (``distance_topk.dense_distance`` and the top-k built on it)
compute their distances with these two functions.  ``topk_ref`` ranks
with a stable sort, so on equal distance the lower column comes first,
as ``lax.top_k`` orders them; ``torch.topk`` leaves that order
unspecified.
"""

from __future__ import annotations

import torch


def pairwise_sqdist_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances in GEMM form.  x: (Q, d), y: (N, d) -> (Q, N)
    float32.  Matmuls run in full fp32 only with
    ``torch.backends.cuda.matmul.allow_tf32`` False (the default)."""
    x, y = x.float(), y.float()
    x2 = (x * x).sum(-1, keepdim=True)                   # (Q, 1)
    y2 = (y * y).sum(-1)[None, :]                        # (1, N)
    return (x2 + y2 - 2.0 * (x @ y.T)).clamp_min(0.0)


def pairwise_negdot_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negative inner product (so smaller == closer, as for L2)."""
    return -(x.float() @ y.float().T)


def topk_ref(x: torch.Tensor, y: torch.Tensor, k: int, metric: str = "l2"):
    """Exact k nearest neighbours of each query: (Q, k) ascending
    distances and int32 base indices (k ≤ N)."""
    if metric == "l2":
        d = pairwise_sqdist_ref(x, y)
    elif metric == "ip":
        d = pairwise_negdot_ref(x, y)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    pos = torch.argsort(d, dim=1, stable=True)[:, :k]
    return d.gather(1, pos), pos.to(torch.int32)


__all__ = ["pairwise_sqdist_ref", "pairwise_negdot_ref", "topk_ref"]
