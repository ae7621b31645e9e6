"""FSDP and tensor-parallel placement over a ``(data, model)`` mesh —
what the reference's launcher asks of GSPMD with
``ShardingRules.param_shardings`` (``src/repro/launch/train.py``),
done by hand.

A parameter whose spec cuts it over ``model`` is held as TP rank j's
part (heads, FFN columns or rows, experts, SSD heads, vocabulary) on
the slots of column j; one whose spec cuts it over the FSDP axes is
cut again into data index i's part on slot (i, j); slots that would
hold the same part on one device share one tensor.  Every other
parameter is one replica a distinct device.  The port's parameters are
the reference's stacked ``(L, …)`` leaves sliced by layer, so a leaf's
spec is the stacked leaf's spec without its leading layer axes
(``cut_dims``).

Each shard leads to its ``Group`` (the cut axes, the grid and every
slot's shard, in slot order) through the attribute ``_fsdp``, so any
one of them leads to the others: ``gather`` all-gathers a TP rank's
data shards onto a device (an autograd function whose backward is the
reduce-scatter of the cotangent), and ``whole`` joins every part for a
host copy.  AdamW moments are linked the same way (``like``), and so
are a step's gradients for its ``grad_transform``.  The references run
one way only: the anchor shard (the one its caller keeps: slot 0's
parameter, slot 0's moment) holds its group, the group holds the other
shards, and the rest are weak references.  So no reference cycle
forms, and a leaf's shards are freed as soon as its anchor is dropped.

``place(model, mesh, rules)`` cuts a model in place and returns one
module a slot (``cut=False``: nothing cut over data); ``train.step``
runs its mesh step over them and ``launch.dryrun`` runs the same
placement on fake tensors.

A decode cache is laid out by ``ShardingRules.cache_specs``
(``PlacedCache``): the K/V caches' sequence over ``model`` (or over
``(data, model)`` where the batch does not divide the data axis), the
SSM states' heads and the conv histories' channels over ``model``, the
batch over ``data``.  ``init_cache`` makes every slot's zeros at its
local shape (no whole cache on any slot), ``place_cache`` cuts a whole
cache, ``whole_cache`` joins one; ``PlacedCache.row`` is a data row's
view, which prefill reads (``RowCache``), and ``MeshCache`` the whole
mesh's, which the weight-stationary decode reads (each data row's
K/V and SSM states for the batch rows it holds).

In one slot's reckoning (``actctx.one_slot``) the slots on ``meta``
share one module, and each leaf's and each cache leaf's parts there
one tensor: nothing of theirs is computed, and a pod's 255 other slots
cost no more than one.
"""

from __future__ import annotations

import copy
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class Group:
    """The shards of one leaf, in slot order over a ``(data, model)``
    grid of ``shape`` (slot s = i·model + j): slot (i, j) holds the i-th
    cut along ``dim`` (the FSDP axis; None: not cut over data) of the
    j-th cut along ``tp_dim`` (the TP axis; None: not cut over model).
    Slots that hold the same cut on one device share one tensor (a leaf
    replicated over ``model``, such as ``wk``, is one tensor a data cut
    a device), so ``shards`` may repeat a tensor.  The group refers to
    its anchor weakly (the anchor holds the group) and to the other
    distinct tensors strongly."""

    __slots__ = ("dim", "tp_dim", "shape", "_index", "_at", "_anchor",
                 "_others", "__weakref__")

    def __init__(self, dim: Optional[int], shards: Sequence[torch.Tensor],
                 anchor: int, tp_dim: Optional[int] = None, shape=None):
        self.dim = dim
        self.tp_dim = tp_dim
        self.shape = tuple(shape) if shape is not None else (len(shards), 1)
        uniq: List[torch.Tensor] = []
        index = []
        for t in shards:
            u = next((u for u, o in enumerate(uniq) if o is t), None)
            if u is None:
                u = len(uniq)
                uniq.append(t)
            index.append(u)
        self._index = index
        self._at = index[anchor]
        self._anchor = weakref.ref(shards[anchor])
        self._others = [None if u == self._at else t
                        for u, t in enumerate(uniq)]

    def unique(self) -> List[torch.Tensor]:
        """The distinct tensors, in the order of their first slot."""
        out = list(self._others)
        out[self._at] = self._anchor()
        return out

    @property
    def shards(self) -> List[torch.Tensor]:
        uniq = self.unique()
        return [uniq[u] for u in self._index]

    def first_slots(self) -> List[int]:
        """The first slot of each distinct tensor (``unique``'s order)."""
        return [self._index.index(u) for u in range(len(self._others))]

    def column(self, j: int) -> List[torch.Tensor]:
        """The shards of TP rank ``j``, one a data index."""
        data, model = self.shape
        sh = self.shards
        return [sh[i * model + j] for i in range(data)]

    def piece(self, t: torch.Tensor, s: int) -> torch.Tensor:
        """Slot ``s``'s cut of ``t``, a whole tensor of the leaf (a view)."""
        return _piece(t, s, self.dim, self.tp_dim, self.shape)


def _piece(t, s: int, dim, tp_dim, shape) -> torch.Tensor:
    data, model = shape
    i, j = divmod(s, model)
    if tp_dim is not None:
        t = t.chunk(model, tp_dim)[j]
    if dim is not None:
        t = t.chunk(data, dim)[i]
    return t


def group(t) -> Optional[Group]:
    """The group of a shard, or None for a whole tensor."""
    g = getattr(t, "_fsdp", None)
    if isinstance(g, weakref.ref):
        g = g()
        if g is None:
            raise ValueError("a shard whose anchor was dropped: its "
                             "group is gone")
    return g


def link(shards: Sequence[torch.Tensor], dim: Optional[int],
         anchor: int = 0, tp_dim: Optional[int] = None, shape=None
         ) -> List[torch.Tensor]:
    """Make ``shards`` (slot order; a tensor may repeat) one group over a
    ``shape`` grid (default: ``len(shards)`` data slots), held by
    ``shards[anchor]``; returns them."""
    g = Group(dim, shards, anchor, tp_dim, shape)
    ref = weakref.ref(g)
    held = shards[anchor]
    for t in shards:
        t._fsdp = g if t is held else ref
    return list(shards)


def slot(t) -> int:
    """The first slot of a shard in its group (found by identity)."""
    return next(i for i, s in enumerate(group(t).shards) if s is t)


def split(t: torch.Tensor, dim: int, devices: Sequence[torch.device]
          ) -> List[torch.Tensor]:
    """``t`` cut into ``len(devices)`` equal parts along ``dim``, part
    s a contiguous copy on ``devices[s]``."""
    parts = t.detach().chunk(len(devices), dim)
    return [c.to(d, copy=True, memory_format=torch.contiguous_format)
            for c, d in zip(parts, devices)]


def whole(t: torch.Tensor, device=None) -> torch.Tensor:
    """The whole leaf of a shard, joined on ``device`` (default the
    shard's): each TP rank's data cuts, then the ranks; a whole tensor
    is returned as it is, or detached and moved to ``device``."""
    g = group(t)
    if g is None:
        return t if device is None else t.detach().to(device)
    dev = t.device if device is None else torch.device(device)
    cols = []
    for j in (range(g.shape[1]) if g.tp_dim is not None else [0]):
        col = [s.detach().to(dev) for s in g.column(j)]
        cols.append(col[0] if g.dim is None else torch.cat(col, g.dim))
    return cols[0] if g.tp_dim is None else torch.cat(cols, g.tp_dim)


def like(p: torch.Tensor, make) -> torch.Tensor:
    """A tensor laid out as parameter ``p``: ``make(shard, slot)`` for
    each distinct shard of ``p``'s group (its first slot), linked with
    the same grid and sharing, the one in ``p``'s slot returned; or
    ``make(p, 0)`` for a whole ``p``."""
    g = group(p)
    if g is None:
        return make(p, 0)
    made = [make(u, s) for u, s in zip(g.unique(), g.first_slots())]
    grid = [made[u] for u in g._index]
    at = slot(p)
    return link(grid, g.dim, anchor=at, tp_dim=g.tp_dim, shape=g.shape)[at]


class _Gather(torch.autograd.Function):
    """All-gather of one leaf onto ``device``; the backward sends each
    owner its slice of the cotangent (summed into the owner's gradient
    over every caller: the reduce-scatter)."""

    @staticmethod
    def forward(ctx, dim, device, *shards):
        from . import tp
        ctx.dim = dim
        ctx.devices = [s.device for s in shards]
        ctx.sizes = [s.shape[dim] for s in shards]
        return tp._join(shards, dim, device)

    @staticmethod
    def backward(ctx, g):
        from . import actctx
        parts = torch.split(g, ctx.sizes, ctx.dim)
        # copies: a view kept as an owner's gradient would keep the
        # whole gathered cotangent alive
        return (None, None) + tuple(
            p.to(d, copy=True) if actctx.live(d) else torch.empty(
                p.shape, dtype=p.dtype, device="meta")
            for p, d in zip(parts, ctx.devices))


def place_like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``t``, a whole tensor of parameter ``p``'s leaf (a moment, a
    restored weight), laid out as ``p`` is: cut into shards on the
    owners of ``p``'s group and linked (the one in ``p``'s slot is
    returned), or moved to ``p``'s device."""
    g = group(p)
    if g is None:
        return t.to(p.device)
    return like(p, lambda u, s: g.piece(t.detach(), s).to(
        u.device, copy=True, memory_format=torch.contiguous_format))


# leaves ``gather`` has all-gathered since the count was last set to 0
COUNTS = {"gathers": 0}


def gather(t: torch.Tensor, device, rank: Optional[int] = None
           ) -> torch.Tensor:
    """The leaf of shard ``t`` gathered over the data axis only (what
    ``gathered_rule`` releases) on ``device``, differentiable into each
    data shard: TP rank ``rank``'s cut of the leaf (default: the rank of
    ``t``'s first slot); each counts one in ``COUNTS["gathers"]``.  A
    whole tensor, or one not cut over data, is returned as it is."""
    g = group(t)
    if g is None or g.dim is None:
        return t
    if rank is None:
        rank = slot(t) % g.shape[1]
    COUNTS["gathers"] += 1
    return _Gather.apply(g.dim, torch.device(device), *g.column(rank))


# --------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------- #

def _axis_of(entries, axis) -> List[int]:
    return [i for i, e in enumerate(entries)
            if e == axis or (isinstance(e, tuple) and axis in e)]


def cut_dims(cfg, rules, params: Dict[str, torch.Tensor]
             ) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
    """For each of the port's parameter names: (the axis of its
    per-layer tensor that ``rules`` shard over the FSDP axes — the one
    ``gathered_rule`` releases —, the axis they shard over ``model``),
    each None where there is none.  The spec is the reference's stacked
    leaf's (``convert.reference_shapes``), its leading layer axes
    dropped: one for each list index in the name."""
    from ..models.convert import reference_shapes
    from .sharding import TP
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
        gathered = rules.gathered_rule(path[-1], leaf.shape)
        dims = [i for i, (a, b) in enumerate(zip(spec[lead:],
                                                 gathered[lead:])) if a != b]
        tps = _axis_of(tuple(gathered)[lead:], TP)
        if len(dims) > 1 or len(tps) > 1:
            raise ValueError(f"{name}: spec {spec} shards more than one "
                             "axis of a layer over an axis of the mesh")
        out[name] = (dims[0] if dims else None, tps[0] if tps else None)
    return out


def shard_dims(cfg, rules, params: Dict[str, torch.Tensor]
               ) -> Dict[str, Optional[int]]:
    """The FSDP half of ``cut_dims``: each name's axis cut over data."""
    return {k: d for k, (d, _) in cut_dims(cfg, rules, params).items()}


def set_param(module: nn.Module, name: str, param: nn.Parameter) -> None:
    """Replace ``module``'s parameter ``name`` (a state-dict name)."""
    prefix, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(prefix) if prefix else module, leaf, param)


def place(model: nn.Module, mesh, rules, *, cut: bool = True
          ) -> List[nn.Module]:
    """Lay ``model``'s parameters over the slots of a ``(data, model)``
    ``mesh`` (slot s = i·model + j is ``mesh.devices.flat[s]``): a leaf
    the spec tables cut over ``model`` is cut into TP rank j's part
    (``cut_dims``' TP axis: heads, FFN columns or rows, experts, SSD
    heads, vocabulary), and one they cut over the FSDP axes is cut into
    data index i's part of that; slots holding the same part on one
    device share one tensor, and the parts are linked (``Group``).
    Every other leaf is one replica a distinct device.  ``cut=False``
    (the replicated layout) cuts nothing over data; the model axis is
    always cut.  Returns one module a slot; slot 0's is ``model``
    itself, whose cut leaves are replaced by slot 0's shards (so the
    whole leaves are freed).  ``model`` must lie on slot 0's device."""
    from . import actctx
    slots = list(mesh.devices.flat)
    n = len(slots)
    model_size = mesh.shape.get("model", 1)
    data = n // model_size
    if model.device != slots[0]:
        raise ValueError(f"the model lies on {model.device}; slot 0 of "
                         f"the mesh is {slots[0]}")
    params = dict(model.named_parameters())
    dims = (cut_dims(model.cfg, rules, params) if n > 1
            else {k: (None, None) for k in params})
    # the other slots' modules, their parameters placeholders until cut;
    # in one slot's reckoning (``actctx.one_slot``) the slots on ``meta``
    # share one module, and each leaf's parts there one tensor
    shared = actctx.skipping()
    memo = {id(p): nn.Parameter(torch.empty(0, device="meta"))
            for p in params.values()}
    modules = [model]
    phantom = model if shared and not actctx.live(slots[0]) else None
    for d in slots[1:]:
        if shared and not actctx.live(d):
            phantom = phantom or copy.deepcopy(model, dict(memo))
            modules.append(phantom)
        else:
            modules.append(copy.deepcopy(model, dict(memo)))
    replicas: Dict[torch.device, Dict[str, nn.Parameter]] = {}
    for name in list(params):
        p = params.pop(name)
        dim, tp_dim = dims[name]
        if not cut or data == 1:
            dim = None
        if model_size == 1:
            tp_dim = None
        if dim is None and tp_dim is None:
            for s, d in enumerate(slots[1:], 1):
                rep = replicas.setdefault(d, {})
                if name not in rep:
                    rep[name] = p if d == slots[0] else nn.Parameter(
                        p.detach().to(d, copy=True),
                        requires_grad=p.requires_grad)
                set_param(modules[s], name, rep[name])
            continue
        for ax, size in ((dim, data), (tp_dim, model_size)):
            if ax is not None and p.shape[ax] % size:
                raise ValueError(f"{name}: axis {ax} of {tuple(p.shape)} "
                                 f"does not divide over {size} slots")
        shape = (data, model_size)
        made: Dict[tuple, nn.Parameter] = {}
        grid = []
        for s, d in enumerate(slots):
            i, j = divmod(s, model_size)
            key = (i if dim is not None else 0,
                   j if tp_dim is not None else 0, d)
            if shared and not actctx.live(d):
                key = (None, None, d)
            if key not in made:
                made[key] = nn.Parameter(
                    _piece(p.detach(), s, dim, tp_dim, shape).to(
                        d, copy=True, memory_format=torch.contiguous_format),
                    requires_grad=p.requires_grad)
            grid.append(made[key])
        link(grid, dim, tp_dim=tp_dim, shape=shape)
        for s in range(n):
            set_param(modules[s], name, grid[s])
        del p
    for m in modules:
        m.tp_size = model_size
    return modules


def batch_slots(rules, batch: int):
    """(the first slot of each data row that runs a batch shard, the
    split of the rows) on ``rules``' mesh: one shard a data row where
    ``batch_specs`` cuts the batch (every rank of a row sees the row's
    rows), else the whole batch once on each distinct device of the
    rows' first slots.  Serving such a batch, a decode cache's K/V are
    cut along the sequence over every slot (``cache_specs``: ``(data,
    model)``), so each of those rows attends over all the slots'
    pieces (``RowCache``)."""
    from ..models.convert import ShapeLeaf
    slots = list(rules.mesh.devices.flat)
    model_size = rules.mesh.shape.get("model", 1)
    rows = list(range(0, len(slots), model_size))
    spec = rules.batch_specs({"x": ShapeLeaf((batch,))}, batch)["x"]
    if spec[0] is None:
        seen = {}
        for r in rows:
            seen.setdefault(slots[r], r)
        return list(seen.values()), 1
    return rows, len(rows)


def load_whole(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy whole tensors (a state dict) into ``model``'s parameters:
    every distinct shard of a cut leaf receives its slot's cut; a whole
    one is copied as ``load_state_dict`` does.  The step copies the
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
            for u, s in zip(g.unique(), g.first_slots()):
                u.copy_(g.piece(t, s))


# --------------------------------------------------------------------- #
# the decode cache over the slots
# --------------------------------------------------------------------- #

def _tree_map(fn, tree, specs):
    """``fn(path, leaf, spec)`` over a cache tree and its spec tree."""
    from .sharding import map_with_path

    def one(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        return fn(path, leaf, spec)
    return map_with_path(one, tree)


def _cut_index(entry, s: int, mesh) -> Optional[int]:
    """The index along an axis that spec ``entry`` cuts of slot ``s``'s
    piece (None: not cut): slot s's coordinates over the named axes, in
    the entry's order, flattened."""
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    coords = dict(zip(mesh.axis_names,
                      np.unravel_index(s, mesh.devices.shape)))
    index = 0
    for a in axes:
        index = index * mesh.shape[a] + int(coords[a])
    return index


def _cache_key(spec, s: int, mesh) -> tuple:
    return tuple(_cut_index(e, s, mesh) for e in spec)


def _cache_piece(t: torch.Tensor, spec, s: int, mesh) -> torch.Tensor:
    """Slot ``s``'s piece of ``t``, a whole leaf laid out by ``spec``
    (a view)."""
    from ..launch.mesh import axis_size
    for axis, (e, k) in enumerate(zip(spec, _cache_key(spec, s, mesh))):
        if k is not None:
            t = t.chunk(axis_size(mesh, e), axis)[k]
    return t


class PlacedCache:
    """A decode cache laid out over the slots of a ``(data, model)``
    mesh as ``ShardingRules.cache_specs`` says: ``slots[s]`` is slot s's
    tree (the reference's layout, every leaf the slot's piece on its
    device; slots that would hold the same piece on one device share
    one tensor), ``specs`` the spec tree, ``batch`` the global batch."""

    def __init__(self, slots: List, specs, mesh, batch: int):
        self.slots = slots
        self.specs = specs
        self.mesh = mesh
        self.batch = batch

    def row(self, first: int) -> "RowCache":
        """The view of the data row whose rank 0 is slot ``first``."""
        return RowCache(self, first)

    def view(self, leaf: torch.Tensor, index) -> torch.Tensor:
        """``leaf[index]``, one view a piece and index, made once."""
        views = self.__dict__.setdefault("_views", {})
        key = (id(leaf), index)
        if key not in views:
            views[key] = leaf[index]
        return views[key]

    def over_mesh(self, modules) -> "MeshCache":
        """The whole mesh's view (``MeshCache``) for the placement's
        ``modules``, made once a cache (it leads back here weakly: no
        cycle keeps a dropped cache, or its modules, alive)."""
        if "_mesh" not in self.__dict__:
            self._mesh = MeshCache(self, modules)
        return self._mesh


class RowCache:
    """A data row's view of a ``PlacedCache``: ``ranks[j]`` is TP rank
    j's slot tree; ``kv(path, index)`` the K/V pieces a layer attends
    over.  The sequence ranks of a K/V leaf are the slots its spec cuts
    the sequence over: the row's TP ranks (``model``), every slot of the
    mesh (``(data, model)``: a batch the data axis does not divide), or
    none (a sequence the axis does not divide: each TP rank holds it
    whole)."""

    def __init__(self, placed: PlacedCache, first: int):
        t = placed.mesh.shape.get("model", 1)
        self.placed = placed
        self.ranks = placed.slots[first:first + t]
        self._first = first

    def _seq_slots(self, path) -> Optional[List[int]]:
        spec = self.placed.specs
        for k in path:
            spec = spec[k]
        entry = spec[-3]                      # (..., B, S, G, hd)
        if entry is None:
            return None
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if axes == ("model",):
            return list(range(self._first, self._first + len(self.ranks)))
        # over (data, model): the slots of this row's pod
        mesh = self.placed.mesh
        pod = mesh.shape["data"] * len(self.ranks)
        lo = self._first - self._first % pod
        return list(range(lo, lo + pod))

    def kv(self, path, index) -> "SeqKV":
        """Layer ``index`` (its leading indices) of the K/V pair under
        ``path`` (the keys above ``k`` and ``v``)."""
        from ..models.layers import SeqKV
        seq = self._seq_slots(tuple(path) + ("k",))
        trees = (self.ranks if seq is None
                 else [self.placed.slots[s] for s in seq])

        def at(tree, key):
            for k in path:
                tree = tree[k]
            return self.placed.view(tree[key], index)
        return SeqKV([at(t, "k") for t in trees],
                     [at(t, "v") for t in trees], seq is not None)


    def states(self, path, index) -> List[dict]:
        """Layer ``index`` of the SSM state under ``path``: each TP rank's
        (views)."""
        return [_state_at(tree, path, index) for tree in self.ranks]


def _state_at(tree, path, index) -> dict:
    for k in path:
        tree = tree[k]
    return {k: v[index] for k, v in tree.items()}


class MeshCache:
    """The whole mesh's view of a ``PlacedCache`` in a weight-stationary
    decode (``serve.step``'s decode over a mesh): one forward runs every
    sequence over the TP ranks of data row 0, each product on the data
    shards where its weight lies, and each layer's cache is read and
    written where it lies.  ``kv`` groups the data rows by the batch rows
    they hold (a cut batch: one row each; a batch the data axis does not
    cut: every row holds all of it), ``states`` likewise for the SSM
    states; ``modules`` are the placement's (one a slot), whose data
    rows' parameters update the states they hold."""

    def __init__(self, placed: PlacedCache, modules):
        self.placed = weakref.proxy(placed)
        self.modules = modules
        self.t = placed.mesh.shape.get("model", 1)
        self.firsts = list(range(0, len(placed.slots), self.t))

    def _rows(self, path, r: int) -> slice:
        """The batch rows data row ``r`` holds of the leaf at ``path``
        (its batch axis is the fourth from last)."""
        spec = self.placed.specs
        for k in path:
            spec = spec[k]
        if spec[-4] is None:
            return slice(None)
        b = self.placed.batch // len(self.firsts)
        return slice(r * b, (r + 1) * b)

    def _groups(self, path, make, tensors):
        """[(rows, [make(row view, its first slot) of each distinct
        copy])] over the data rows, in row order, a group a distinct
        slice of the batch; a copy is told by where ``tensors(item)``
        lie (a view's base and offset)."""
        groups = {}
        for r, first in enumerate(self.firsts):
            rows = self._rows(path, r)
            item = make(self.placed.row(first), first)
            key = tuple((id(t if t._base is None else t._base),
                         t.storage_offset()) for t in tensors(item))
            group = groups.setdefault((rows.start, rows.stop),
                                      (rows, [], set()))
            if key not in group[2]:
                group[2].add(key)
                group[1].append(item)
        return [(rows, items) for rows, items, _ in groups.values()]

    def _once(self, key, make):
        made = self.__dict__.setdefault("_made", {})
        if key not in made:
            made[key] = make()
        return made[key]

    def kv(self, path, index):
        """Layer ``index`` of the K/V pair under ``path``: a
        ``layers.MeshKV`` (made once: its views stay the cache's)."""
        return self._once(("kv", tuple(path), index),
                          lambda: self._kv(path, index))

    def _kv(self, path, index):
        from ..models.layers import MeshKV, SeqKV
        groups = self._groups(tuple(path) + ("k",),
                              lambda row, _: row.kv(path, index),
                              lambda kv: [*kv.k, *kv.v])
        reads = [copies[0] if copies[0].spread else SeqKV(
            copies[0].k[:1], copies[0].v[:1], True) for _, copies in groups]
        return MeshKV([rows for rows, _ in groups], reads,
                      [copies for _, copies in groups])

    def states(self, path, index) -> list:
        """Layer ``index`` of the SSM state under ``path``: one
        ``ssm.Holder`` a distinct slice of the batch, computed with the
        parameters of the first data row that holds it (made once)."""
        return self._once(("ssm", tuple(path), index),
                          lambda: self._states(path, index))

    def _states(self, path, index) -> list:
        from ..models.ssm import Holder
        groups = self._groups(tuple(path) + ("ssm",), lambda row, first: (
            first, row.states(path, index)), lambda item: [
                v for st in item[1] for v in st.values()])
        return [Holder(rows, self.modules[copies[0][0]:
                                          copies[0][0] + self.t],
                       [c for _, c in copies]) for rows, copies in groups]


def _placed(make, tree, mesh, rules, batch: int) -> PlacedCache:
    """A ``PlacedCache`` of ``tree`` whose slot pieces ``make(path, leaf,
    spec, s)`` gives (one call a distinct piece and device; in one slot's
    reckoning, one tensor for every piece on ``meta``)."""
    from . import actctx
    specs = rules.cache_specs(tree, batch)
    devices = list(mesh.devices.flat)
    made: Dict[tuple, torch.Tensor] = {}

    def slot_tree(s):
        def one(path, leaf, spec):
            key = (path, None if not actctx.live(devices[s])
                   else _cache_key(spec, s, mesh), devices[s])
            if key not in made:
                made[key] = make(path, leaf, spec, s)
            return made[key]
        return _tree_map(one, tree, specs)
    return PlacedCache([slot_tree(s) for s in range(len(devices))], specs,
                       mesh, batch)


def init_cache(tree, mesh, rules, batch: int) -> PlacedCache:
    """Zeros at every slot's local shape: ``tree`` is the whole cache's
    structure (leaves with a shape and a dtype: ``meta`` tensors,
    ``ShapeLeaf``s); no whole leaf is made."""
    from ..launch.mesh import axis_size
    devices = list(mesh.devices.flat)

    def make(path, leaf, spec, s):
        shape = [n if e is None else n // axis_size(mesh, e)
                 for n, e in zip(leaf.shape, spec)]
        return torch.zeros(shape, dtype=leaf.dtype, device=devices[s])
    return _placed(make, tree, mesh, rules, batch)


def place_cache(cache, mesh, rules, batch: int) -> PlacedCache:
    """A whole cache (the reference's layout) cut into every slot's
    piece, each a contiguous copy on the slot's device."""
    devices = list(mesh.devices.flat)

    def make(path, leaf, spec, s):
        return _cache_piece(leaf.detach(), spec, s, mesh).to(
            devices[s], copy=True, memory_format=torch.contiguous_format)
    return _placed(make, cache, mesh, rules, batch)


def whole_cache(placed: PlacedCache, device=None):
    """The whole cache joined from the slots' pieces, on ``device``
    (default slot 0's)."""
    from ..launch.mesh import axis_size
    mesh = placed.mesh
    dev = torch.device(device) if device is not None \
        else mesh.devices.flat[0]

    def join(path, _, spec):
        pieces = [t for t in placed.slots]
        for k in path:
            pieces = [t[k] for t in pieces]
        first = pieces[0]
        shape = [n if e is None else n * axis_size(mesh, e)
                 for n, e in zip(first.shape, spec)]
        out = torch.empty(shape, dtype=first.dtype, device=dev)
        for s, piece in enumerate(pieces):
            _cache_piece(out, spec, s, mesh).copy_(piece)
        return out
    return _tree_map(join, placed.slots[0], placed.specs)


__all__ = ["Group", "group", "link", "slot", "split", "whole", "like",
           "place_like", "COUNTS", "gather", "cut_dims", "shard_dims", "set_param",
           "place", "batch_slots", "load_whole", "PlacedCache", "RowCache",
           "MeshCache",
           "init_cache", "place_cache", "whole_cache"]
