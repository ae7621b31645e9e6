"""Dense pairwise squared-L2 / negative-dot distance matrix.

Port of ``src/repro/kernels/pairwise.py``.  ``pairwise_distance`` is the
wrapper of kernel C (``csrc/pairwise.cu``, the port of the Pallas
``_pairwise_kernel``): on a CUDA tensor it launches the hand-written
kernel, on a CPU tensor it runs the plain PyTorch version
``distance_topk.dense_distance``, the same distances every plain top-k
of this package ranks.  d is taken whole at any width (the kernel walks
it in 16-word chunks, with 16-byte loads when d % 4 == 0 and scalar
loads otherwise); the reference has no chunked fallback either.
"""

from __future__ import annotations

import torch

from . import _build
from .distance_topk import (_ACCUMS, _METRICS, _require, check_inputs,
                            dense_distance, vec_loads_ok)
from .tuning import select_f32_tiles


def pairwise_distance(x: torch.Tensor, y: torch.Tensor, *,
                      metric: str = "l2", accum: str = "f32") -> torch.Tensor:
    """Kernel C: (Q, d) × (N, d) -> (Q, N) fp32 distances, GEMM form, as
    ``_dist_tile`` computes them (``accum="bf16"`` rounds the operands).
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/pairwise.cu`` (``launches`` counts those launches) or raise —
    there is no fallback."""
    _require(metric in _METRICS, f"unknown metric {metric!r}")
    _require(accum in _ACCUMS, f"unknown accum {accum!r}")
    if x.device.type == "cpu":
        return dense_distance(x, y, metric=metric, accum=accum)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    q, d = x.shape
    n = y.shape[0]
    check_inputs(x.device, (("x", x, torch.float32, (q, d)),
                            ("y", y, torch.float32, (n, d))))
    _require(q > 0 and n > 0 and d > 0, f"empty product ({q}, {n}, {d})")
    bq, bn = select_f32_tiles(q)
    out = torch.empty((q, n), dtype=torch.float32, device=x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check("pairwise_f32", lib.pairwise_f32(
        x.data_ptr(), y.data_ptr(), q, n, d, int(metric == "ip"),
        int(accum == "bf16"), int(vec_loads_ok(x, y)), bq, bn,
        out.data_ptr(), stream))
    pairwise_distance.launches += 1
    return out


pairwise_distance.launches = 0


__all__ = ["pairwise_distance"]
