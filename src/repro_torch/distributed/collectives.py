"""Distributed-optimization collectives: int8 error-feedback gradient
compression and the all-reduces of the data-parallel step — port of
``src/repro/distributed/collectives.py``.

Wire format: per-tensor symmetric int8 quantization (absmax scale) with
an error-feedback accumulator, so the quantization residual re-enters
the next step's gradient.  The tensor is the reference's leaf: the
port's per-layer gradients of one stacked leaf (``layers.3.attn.wq``
for every layer index) share one scale, the absmax over every layer,
and under FSDP and tensor-parallel placement over every slot's shard
too, the TP ranks' included (one max all-reduce a leaf), as GSPMD sees
the global array.

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

from . import fsdp

f32 = torch.float32


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(f32) * scale


def _stacked(name: str) -> str:
    """The reference's leaf of a port gradient's name: the name without
    its layer indices."""
    return ".".join(p for p in name.split(".") if not p.isdigit())


def _leaf_scales(grads: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The quantization scale of each gradient: ``max|g|/127 + 1e-12``
    over its whole reference leaf — every layer's gradient in
    ``grads``, and every distinct shard of a cut one (its data shards
    and its TP ranks) — on the gradient's device."""
    amax: Dict[str, torch.Tensor] = {}
    for k, g in grads.items():
        g_group = fsdp.group(g)
        for part in ([g] if g_group is None else g_group.unique()):
            m = torch.max(torch.abs(part.to(f32))).to(g.device)
            key = _stacked(k)
            amax[key] = m if key not in amax else torch.maximum(
                amax[key], m.to(amax[key].device))
    return {k: (amax[_stacked(k)] / 127.0 + 1e-12).to(g.device)
            for k, g in grads.items()}


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
        if any(fsdp.group(g) is not None for g in grads.values()):
            raise NotImplementedError(
                "error feedback on FSDP-sharded gradients")
        fed = {k: g.to(f32) + ef[k] for k, g in grads.items()}
        comp, new_ef = {}, {}
        for k, s in _leaf_scales(fed).items():
            g = fed[k]
            q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
            comp[k] = _dequantize(q, s)
            new_ef[k] = g - comp[k]
        return comp, new_ef

    return transform, init_state


def compress_decompress(grads: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Stateless wire-format simulation (no error feedback); each
    gradient keeps its dtype.  One scale a reference leaf
    (``_leaf_scales``): the absmax over its layers and its shards."""
    out = {}
    for k, s in _leaf_scales(grads).items():
        g = grads[k]
        q = torch.clamp(torch.round(g.to(f32) / s), -127, 127
                        ).to(torch.int8)
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
