"""Int8 error-feedback gradient compression — port of the single-device
half of ``src/repro/distributed/collectives.py``.

Wire format: per-tensor symmetric int8 quantization (absmax scale) with
an error-feedback accumulator, so the quantization residual re-enters
the next step's gradient.  Both entry points act on a mapping of names
to gradient tensors:

  * ``compress_decompress(grads)`` — a drop-in ``grad_transform`` for
    ``train.step.make_train_step``: the values that would cross the wire
    are the quantized ones;
  * ``make_error_feedback_transform()`` — the stateful variant.

``compressed_psum`` (quantize -> all-reduce -> dequantize across a mesh
axis) belongs to the distributed training slice and is not here.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

f32 = torch.float32


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(f32) * scale


def make_error_feedback_transform() -> Tuple[Callable, Callable]:
    """Returns (transform, init_state): ``transform(grads, ef) ->
    (compressed grads, new ef)``; ``init_state(params)`` gives fp32
    zeros of the parameters' shapes."""

    def init_state(params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(p.shape, dtype=f32, device=p.device)
                for k, p in params.items()}

    def transform(grads: Mapping[str, torch.Tensor],
                  ef: Mapping[str, torch.Tensor]):
        comp, new_ef = {}, {}
        for k, g in grads.items():
            g = g.to(f32) + ef[k]
            q, s = _quantize(g)
            comp[k] = _dequantize(q, s)
            new_ef[k] = g - comp[k]
        return comp, new_ef

    return transform, init_state


def compress_decompress(grads: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Stateless wire-format simulation (no error feedback); each
    gradient keeps its dtype."""
    out = {}
    for k, g in grads.items():
        q, s = _quantize(g.to(f32))
        out[k] = _dequantize(q, s).to(g.dtype)
    return out


__all__ = ["compress_decompress", "make_error_feedback_transform"]
