"""Distributed-optimization collectives: int8 error-feedback gradient
compression and the all-reduces of the data-parallel step — port of
``src/repro/distributed/collectives.py``.

Wire format: per-tensor symmetric int8 quantization (absmax scale) with
an error-feedback accumulator, so the quantization residual re-enters
the next step's gradient.

  * ``compress_decompress(grads)`` — a drop-in ``grad_transform`` for
    ``train.step.make_train_step`` (a mapping of names to gradients):
    the values that would cross the wire are the quantized ones;
  * ``make_error_feedback_transform()`` — the stateful variant;
  * ``compressed_psum(xs)`` — quantize -> int32 sum -> dequantize over
    the per-shard tensors of one mesh axis, with one shared scale;
  * ``all_reduce_mean(xs)`` — the plain all-reduce the data-parallel
    step runs on its gradients and MoE routing fractions.

Where the reference's collectives run inside ``shard_map`` (one program
a device, ``psum`` / ``pmax`` over a named axis), the port's take the
list of per-shard tensors along the axis, in shard order, and one
process reduces them (as ``ops.merge_topk_allgather`` folds the shards
of a sharded search); there are no ``torch.distributed`` process groups.
Each returns one tensor a shard, on that shard's device; shards on one
device share one result tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

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


def _to_shards(total: torch.Tensor, xs: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """``total`` (on the first shard's device) once on each distinct
    device of ``xs``, in shard order."""
    per_device = {total.device: total}
    out = []
    for x in xs:
        if x.device not in per_device:
            per_device[x.device] = total.to(x.device)
        out.append(per_device[x.device])
    return out


def compressed_psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Quantize -> all-reduce (int32 sum) -> dequantize over the shards
    ``xs`` of one mesh axis.  The scale is shared: the max over shards
    of ``max|x|/127 + 1e-12``, so the sum moves int8 codes and one fp32
    scalar.  Returns the fp32 sum, one tensor a shard."""
    dev = xs[0].device
    scale = torch.stack([(torch.max(torch.abs(x)) / 127.0 + 1e-12).to(dev)
                         for x in xs]).max()
    total = None
    for x in xs:
        q = torch.clamp(torch.round(x / scale.to(x.device)), -127, 127
                        ).to(torch.int32).to(dev)
        total = q if total is None else total.add_(q)
    return _to_shards(total.to(f32) * scale, xs)


def all_reduce_mean(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean of the shards ``xs`` of one mesh axis, summed in fp32
    in shard order and rounded once to the shards' dtype; one tensor a
    shard."""
    dev = xs[0].device
    total = xs[0].to(f32, copy=True)
    for x in xs[1:]:
        total.add_(x.to(dev, f32))
    total.div_(len(xs))
    return _to_shards(total.to(xs[0].dtype), xs)


__all__ = ["compress_decompress", "make_error_feedback_transform",
           "compressed_psum", "all_reduce_mean"]
