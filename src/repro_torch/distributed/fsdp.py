"""FSDP placement over the data axis — what the reference's launcher
asks of GSPMD with ``ShardingRules.param_shardings`` on a ``(data = n,
model = 1)`` mesh (``src/repro/launch/train.py``), done by hand.

A parameter whose spec shards it over the FSDP axes is held as n
shards, slot s of the mesh holding the s-th cut of the leaf along the
axis the spec names, on that slot's device; every other parameter is
one replica a distinct device.  The port's parameters are the
reference's stacked ``(L, …)`` leaves sliced by layer, so a leaf's spec
is the stacked leaf's spec without its leading layer axes
(``shard_dims``).

Each shard leads to its ``Group`` (the cut axis and every slot's shard,
in slot order) through the attribute ``_fsdp``, so any one of them
leads to the others: ``gather`` all-gathers a leaf onto a device (an
autograd function whose backward is the reduce-scatter of the
cotangent), and ``whole`` concatenates it for a host copy.  AdamW
moments are linked the same way, and so are a step's gradients for its
``grad_transform``.  The references run one way only: the anchor shard
(the one its caller keeps: slot 0's parameter, slot 0's moment) holds
its group, the group holds the other shards, and the rest are weak
references.  So no reference cycle forms, and a leaf's shards are freed
as soon as its anchor is dropped.

``place(model, mesh, rules)`` cuts a model in place and returns one
module a slot (``cut=False``: every leaf a replica); ``train.step``
runs its data-parallel step over them and
``launch.dryrun`` runs the same placement on fake tensors.
"""

from __future__ import annotations

import copy
import weakref
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn


class Group:
    """The shards of one leaf: ``shards[s]`` on slot s's device, the
    leaf cut into equal parts along ``dim``.  The group refers to its
    anchor weakly (the anchor holds the group) and to the others
    strongly."""

    __slots__ = ("dim", "_anchor", "_at", "_others", "__weakref__")

    def __init__(self, dim: int, shards: Sequence[torch.Tensor],
                 anchor: int):
        self.dim = dim
        self._at = anchor
        self._anchor = weakref.ref(shards[anchor])
        self._others = [None if i == anchor else t
                        for i, t in enumerate(shards)]

    @property
    def shards(self) -> List[torch.Tensor]:
        out = list(self._others)
        out[self._at] = self._anchor()
        return out


def group(t) -> Optional[Group]:
    """The group of a shard, or None for a whole tensor."""
    g = getattr(t, "_fsdp", None)
    if isinstance(g, weakref.ref):
        g = g()
        if g is None:
            raise ValueError("a shard whose anchor was dropped: its "
                             "group is gone")
    return g


def link(shards: Sequence[torch.Tensor], dim: int, anchor: int = 0
         ) -> List[torch.Tensor]:
    """Make ``shards`` (slot order) one group, held by
    ``shards[anchor]``; returns them."""
    g = Group(dim, shards, anchor)
    ref = weakref.ref(g)
    for i, t in enumerate(shards):
        t._fsdp = g if i == anchor else ref
    return list(shards)


def slot(t) -> int:
    """The slot of a shard in its group (found by identity)."""
    return next(i for i, s in enumerate(group(t).shards) if s is t)


def split(t: torch.Tensor, dim: int, devices: Sequence[torch.device]
          ) -> List[torch.Tensor]:
    """``t`` cut into ``len(devices)`` equal parts along ``dim``, part
    s a contiguous copy on ``devices[s]``."""
    parts = t.detach().chunk(len(devices), dim)
    return [c.to(d, copy=True, memory_format=torch.contiguous_format)
            for c, d in zip(parts, devices)]


def whole(t: torch.Tensor, device=None) -> torch.Tensor:
    """The whole leaf of a shard, concatenated on ``device`` (default
    the shard's); a whole tensor is returned as it is, or detached and
    moved to ``device``."""
    g = group(t)
    if g is None:
        return t if device is None else t.detach().to(device)
    dev = t.device if device is None else torch.device(device)
    return torch.cat([s.detach().to(dev) for s in g.shards], g.dim)


class _Gather(torch.autograd.Function):
    """All-gather of one leaf onto ``device``; the backward sends each
    owner its slice of the cotangent (summed into the owner's gradient
    over every caller: the reduce-scatter)."""

    @staticmethod
    def forward(ctx, dim, device, *shards):
        ctx.dim = dim
        ctx.devices = [s.device for s in shards]
        ctx.sizes = [s.shape[dim] for s in shards]
        return torch.cat([s.to(device) for s in shards], dim)

    @staticmethod
    def backward(ctx, g):
        parts = torch.split(g, ctx.sizes, ctx.dim)
        # copies: a view kept as an owner's gradient would keep the
        # whole gathered cotangent alive
        return (None, None) + tuple(p.to(d, copy=True) for p, d in
                                    zip(parts, ctx.devices))


def place_like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``t``, a whole tensor of parameter ``p``'s leaf (a moment, a
    restored weight), laid out as ``p`` is: cut into shards on the
    owners of ``p``'s group and linked (the one in ``p``'s slot is
    returned), or moved to ``p``'s device."""
    g = group(p)
    if g is None:
        return t.to(p.device)
    at = slot(p)
    return link(split(t, g.dim, [s.device for s in g.shards]), g.dim,
                anchor=at)[at]


def gather(t: torch.Tensor, device) -> torch.Tensor:
    """The whole leaf of shard ``t`` on ``device``, differentiable into
    every shard; a whole tensor is returned as it is."""
    g = group(t)
    if g is None:
        return t
    return _Gather.apply(g.dim, torch.device(device), *g.shards)


# --------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------- #

def _released(spec, gathered) -> List[int]:
    return [i for i, (a, b) in enumerate(zip(spec, gathered)) if a != b]


def shard_dims(cfg, rules, params: Dict[str, torch.Tensor]
               ) -> Dict[str, Optional[int]]:
    """For each of the port's parameter names: the axis of its
    per-layer tensor that ``rules`` shard over the FSDP axes (the one
    ``gathered_rule`` releases), or None.  The spec is the reference's
    stacked leaf's (``convert.reference_shapes``), its leading layer
    axes dropped: one for each list index in the name."""
    from ..models.convert import reference_shapes
    ref = reference_shapes(cfg, params)
    specs = rules.param_specs(ref)
    out = {}
    for name in params:
        parts = name.split(".")
        path = [p for p in parts if not p.isdigit()]
        lead = len(parts) - len(path)
        leaf, spec = ref, specs
        for p in path:
            leaf, spec = leaf[p], spec[p]
        dims = _released(spec[lead:], rules.gathered_rule(
            path[-1], leaf.shape)[lead:])
        if len(dims) > 1:
            raise ValueError(f"{name}: spec {spec} shards more than one "
                             "axis of a layer over the FSDP axes")
        out[name] = dims[0] if dims else None
    return out


def set_param(module: nn.Module, name: str, param: nn.Parameter) -> None:
    """Replace ``module``'s parameter ``name`` (a state-dict name)."""
    prefix, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(prefix) if prefix else module, leaf, param)


def place(model: nn.Module, mesh, rules, *, cut: bool = True
          ) -> List[nn.Module]:
    """Lay ``model``'s parameters over the slots of ``mesh`` (``model``
    axis 1; slot s is ``mesh.devices.flat[s]``): every leaf that
    ``rules`` shard over the FSDP axes becomes n linked shards, the
    others one replica a distinct device; ``cut=False`` makes every
    leaf a replica (the replicated layout).  Returns one module a slot;
    slot 0's is ``model`` itself, whose sharded leaves are replaced by
    slot 0's shards (so the whole leaves are freed).  ``model`` must
    lie on slot 0's device."""
    slots = list(mesh.devices.flat)
    n = len(slots)
    if model.device != slots[0]:
        raise ValueError(f"the model lies on {model.device}; slot 0 of "
                         f"the mesh is {slots[0]}")
    params = dict(model.named_parameters())
    dims = (shard_dims(model.cfg, rules, params) if cut and n > 1
            else dict.fromkeys(params))
    # the other slots' modules, their parameters placeholders until cut
    memo = {id(p): nn.Parameter(torch.empty(0, device="meta"))
            for p in params.values()}
    modules = [model] + [copy.deepcopy(model, dict(memo))
                         for _ in range(n - 1)]
    replicas: Dict[torch.device, Dict[str, nn.Parameter]] = {}
    for name in list(params):
        p = params.pop(name)
        dim = dims[name]
        if dim is None:
            for s, d in enumerate(slots[1:], 1):
                rep = replicas.setdefault(d, {})
                if name not in rep:
                    rep[name] = p if d == slots[0] else nn.Parameter(
                        p.detach().to(d, copy=True),
                        requires_grad=p.requires_grad)
                set_param(modules[s], name, rep[name])
            continue
        if p.shape[dim] % n:
            raise ValueError(f"{name}: axis {dim} of {tuple(p.shape)} does "
                             f"not divide over {n} slots")
        shards = link([nn.Parameter(t, requires_grad=p.requires_grad)
                       for t in split(p, dim, slots)], dim)
        for s in range(n):
            set_param(modules[s], name, shards[s])
        del p
    return modules


def batch_slots(rules, batch: int):
    """(the slot of each batch shard, the split of the rows) on
    ``rules``' mesh: one shard a slot where ``batch_specs`` cuts the
    batch, else the whole batch once on each distinct device (its first
    slot)."""
    from ..models.convert import ShapeLeaf
    slots = list(rules.mesh.devices.flat)
    spec = rules.batch_specs({"x": ShapeLeaf((batch,))}, batch)["x"]
    if spec[0] is None:
        return [slots.index(d) for d in dict.fromkeys(slots)], 1
    return list(range(len(slots))), len(slots)


def load_whole(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy whole tensors (a state dict) into ``model``'s parameters:
    a sharded leaf receives its cut in every slot's shard; a whole one
    is copied as ``load_state_dict`` does.  The step copies the
    replicated leaves to its other devices at its next new optimizer
    state."""
    params = dict(model.named_parameters())
    missing = set(params) - set(state)
    if missing:
        raise KeyError(f"missing {sorted(missing)[:4]}")
    with torch.no_grad():
        for name, t in state.items():
            p = params[name]
            g = group(p)
            if g is None:
                p.copy_(t)
                continue
            for s, part in zip(g.shards, t.chunk(len(g.shards), g.dim)):
                s.copy_(part)


__all__ = ["Group", "group", "link", "slot", "split", "whole",
           "place_like", "gather",
           "shard_dims", "set_param", "place", "batch_slots", "load_whole"]
