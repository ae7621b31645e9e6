"""Activation-sharding context — the pins at the reference's layer
boundaries and the per-layer FSDP all-gather.  Port of
``src/repro/distributed/actctx.py`` without JAX.

In the reference, ``shard(x, kind)`` is a ``with_sharding_constraint``
that tells GSPMD how an activation is laid out over the mesh, and
``gather_params`` pins a layer's sliced weights to their gathered
layout.  The port places nothing by a pin: the data-parallel train step
(``train.step``) cuts the batch into shards itself and runs each
shard's forward on its device.  So here a pin is a check: under that
step, ``shard`` verifies that ``x`` is the local shard its spec
implies (its rows, its other axes, its device) and returns it.  With
``gather_rules`` set (FSDP placement, ``distributed.fsdp``),
``gather_params`` is the all-gather itself: every sharded leaf of the
layer is concatenated from its owners onto the calling shard's device,
and its backward reduce-scatters the cotangent to them.

State is set by the launcher (``configure``, ``use``) and by the step
around each shard's forward and backward (``local_shard``).  Without a
configured mesh — every serving path, every one-device run — ``shard``
and ``gather_params`` return their input after one dictionary lookup.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch
from torch import nn

from . import fsdp
from .sharding import P

_STATE = {"mesh": None, "dp": None, "tp": "model", "gather_rules": None,
          "local": None}


def configure(mesh, dp: Optional[Tuple[str, ...]], tp: str = "model",
              gather_rules=None) -> None:
    """The mesh, its data-parallel axes, its TP axis and, under FSDP
    placement, the ``ShardingRules`` the leaves were placed by."""
    _STATE["mesh"] = mesh
    _STATE["dp"] = dp
    _STATE["tp"] = tp
    _STATE["gather_rules"] = gather_rules


@contextmanager
def use(mesh, dp, tp: str = "model", gather_rules=None):
    old = dict(_STATE)
    configure(mesh, dp, tp, gather_rules)
    try:
        yield
    finally:
        _STATE.update(old)


@contextmanager
def local_shard(split: int, device):
    """Inside: the forward of one batch shard on ``device``, whose rows
    are 1/``split`` of the batch the reference's forward would see
    (``split`` = 1 for a replicated batch)."""
    old = _STATE["local"]
    _STATE["local"] = (split, device)
    try:
        yield
    finally:
        _STATE["local"] = old


def gather_params(tree):
    """The reference's per-layer FSDP all-gather.  With ``gather_rules``
    and a mesh configured: ``tree`` (a layer's ``ParamTree``, or a dict
    or list of its parts) as nested dicts and lists whose leaves that
    FSDP placement cut (``fsdp.group``) are gathered whole onto the
    calling shard's device, along the axis ``gathered_rule`` releases
    (``fsdp.gather``: its backward is the gradient reduce-scatter); the
    leaves the spec tables replicate pass through.  Otherwise ``tree``
    itself.  Called inside the region ``layers.remat`` recomputes, so no
    layer's gathered weights outlive the layer."""
    if _STATE["gather_rules"] is None or _STATE["mesh"] is None:
        return tree
    local = _STATE["local"]
    device = None if local is None else local[1]

    def one(node):
        if isinstance(node, torch.Tensor):
            return fsdp.gather(node, node.device if device is None
                               else device)
        if isinstance(node, (list, tuple, nn.ModuleList)):
            return [one(v) for v in node]
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        return {k: one(v) for k, v in (*node.named_parameters(recurse=False),
                                       *node.named_children())}
    return one(tree)


def _size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _div(n: int, mesh, axes) -> bool:
    if axes is None:
        return False
    return n % _size(mesh, axes) == 0


def spec(shape: Tuple[int, ...], kind: str) -> P:
    """The spec ``shard`` pins an activation of the global ``shape`` to,
    on the configured mesh.  kind:
      'btd'      — batch over DP, rest replicated;
      'btd_sp'   — batch over DP, *sequence* over TP;
      'btd_fsdp' — batch over DP, feature over TP;
      'bthd'     — batch over DP, heads over TP;
      'bd' / 'bt' — batch over DP;
      'btf'      — batch over DP, last axis over TP (logits over vocab).
    Every axis falls back to replicated when not divisible."""
    mesh = _STATE["mesh"]
    dp, tp = _STATE["dp"], _STATE["tp"]
    nd = len(shape)
    dpx = dp if _div(shape[0], mesh, dp) else None
    if kind == "btd":
        return P(dpx, *((None,) * (nd - 1)))
    if kind == "btd_sp":
        seq = tp if (nd >= 3 and _div(shape[1], mesh, tp)) else None
        return P(dpx, seq, *((None,) * (nd - 2)))
    if kind == "btd_fsdp":
        last = tp if _div(shape[-1], mesh, tp) else None
        return P(dpx, *((None,) * (nd - 2)), last)
    if kind == "bthd":
        h = tp if _div(shape[2], mesh, tp) else None
        return P(dpx, None, h, None)
    if kind in ("bd", "bt"):
        return P(dpx, None)
    if kind == "btf":
        last = tp if _div(shape[-1], mesh, tp) else None
        return P(dpx, *((None,) * (nd - 2)), last)
    raise ValueError(kind)


def _local_shape(shape: Tuple[int, ...], sp: P) -> Tuple[int, ...]:
    """The shape of one shard of an array of global ``shape`` laid out
    by ``sp`` on the configured mesh."""
    mesh = _STATE["mesh"]
    return tuple(n if ax is None else n // _size(mesh, ax)
                 for n, ax in zip(shape, sp))


def shard(x, kind: str):
    """Pin ``x`` to ``spec(global shape, kind)``; returns ``x``.  Under
    ``local_shard`` it raises unless ``x`` has the local shape that spec
    implies and lies on the shard's device."""
    if _STATE["mesh"] is None:
        return x
    local = _STATE["local"]
    if local is None:
        return x
    split, device = local
    shape = (x.shape[0] * split,) + tuple(x.shape[1:])
    sp = spec(shape, kind)
    want = _local_shape(shape, sp)
    if tuple(x.shape) != want or x.device != device:
        raise RuntimeError(
            f"actctx.shard({kind!r}): a shard of {shape} under {sp} is "
            f"{want} on {device}, got {tuple(x.shape)} on {x.device}")
    return x


__all__ = ["configure", "use", "local_shard", "gather_params", "spec",
           "shard"]
