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

Under tensor parallelism (a ``model`` axis > 1) a batch shard is a data
row of slots, one a TP rank, and the models run each layer's ranks in
turn (``tp_ranks``, ``on_rank``).  A pin then checks the local shape
with the TP cut: ``btd_sp`` cuts the sequence, ``btd_fsdp`` the
features, ``bthd`` the heads, ``btf`` the vocabulary; the row's
residual is the list of the ranks' cuts where the spec cuts it over
``model`` (``shard_ranks`` moves it between layouts with
``distributed.tp``'s collectives, as GSPMD reshards at a constraint,
and then pins it).  ``gather_params`` gathers over the data axis only,
onto the rank's device: the gathered leaf stays the rank's TP cut.

Decode over a mesh runs in the reference's weight-stationary layout
(``use(..., stationary=True)``, the reference's ``configure(mesh,
None)``): the activations are replicated over ``data`` (the pins cut
no batch), ``gather_params`` gathers nothing, and every product with a
weight cut over ``data`` runs on each data shard where it lies
(``layers.over_data``): partials over the contracted axis summed once in
fp32, or slices of the output's columns joined.

State is set by the launcher (``configure``, ``use``) and by the step
around each shard's forward and backward (``local_shard``).  Without a
configured mesh — every serving path, every one-device run — ``shard``
and ``gather_params`` return their input after one dictionary lookup.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import fsdp
from .sharding import P

_STATE = {"mesh": None, "dp": None, "tp": "model", "gather_rules": None,
          "stationary": False, "local": None, "rank": None,
          "one_slot": False}


def configure(mesh, dp: Optional[Tuple[str, ...]], tp: str = "model",
              gather_rules=None, stationary: bool = False) -> None:
    """The mesh, its data-parallel axes, its TP axis and, under FSDP
    placement, the ``ShardingRules`` the leaves were placed by;
    ``stationary``: a decode in the weight-stationary layout (the
    weights used where they lie, no gather)."""
    _STATE["mesh"] = mesh
    _STATE["dp"] = dp
    _STATE["tp"] = tp
    _STATE["gather_rules"] = gather_rules
    _STATE["stationary"] = stationary


@contextmanager
def use(mesh, dp, tp: str = "model", gather_rules=None,
        stationary: bool = False):
    old = dict(_STATE)
    configure(mesh, dp, tp, gather_rules, stationary)
    try:
        yield
    finally:
        _STATE.update(old)


def stationary() -> bool:
    """Whether a weight-stationary decode over a mesh is running."""
    return _STATE["stationary"] and _STATE["mesh"] is not None


@contextmanager
def one_slot():
    """Inside: one slot's reckoning (``launch.dryrun``).  Every slot of
    the mesh but the reckoned one lies on the ``meta`` device, whose
    tensors hold no bytes, and work whose every output would land there
    is not run: each such rank's, data row's, shard's or collective's
    result is a ``meta`` placeholder of its shape (``tp.placeholder``).
    What the reckoned slot computes, and every buffer a collective
    leaves on it, is what the whole program would make there; only the
    other slots' work, which leaves nothing on it, is left out."""
    old = _STATE["one_slot"]
    _STATE["one_slot"] = True
    try:
        yield
    finally:
        _STATE["one_slot"] = old


def live(device) -> bool:
    """Whether work on ``device`` runs: always, but in one slot's
    reckoning, where only the reckoned slot's (a device that is not
    ``meta``) does."""
    return not _STATE["one_slot"] or torch.device(device).type != "meta"


def skipping() -> bool:
    """Whether one slot's reckoning is running (``one_slot``)."""
    return _STATE["one_slot"]


def rank_live(j: int) -> bool:
    """Whether TP rank ``j``'s part of the running row's layer runs: its
    device is live, or, in a weight-stationary decode, a slot of its
    column (where its products run) is."""
    if not _STATE["one_slot"]:
        return True
    if live(tp_devices()[j]):
        return True
    if _STATE["stationary"]:
        mesh = _STATE["mesh"]
        t = mesh.shape.get("model", 1)
        return any(live(d) for d in list(mesh.devices.flat)[j::t])
    return False


def running_rank() -> int:
    """The TP rank whose part of a layer runs (``on_rank``; 0 outside
    one)."""
    return _STATE["rank"] or 0


@contextmanager
def local_shard(split: int, device, ranks: Optional[Sequence] = None,
                devices: Optional[Sequence] = None):
    """Inside: the forward of one batch shard on ``device``, whose rows
    are 1/``split`` of the batch the reference's forward would see
    (``split`` = 1 for a replicated batch).  Under tensor parallelism
    (a ``model`` axis > 1) the shard is a data row of slots: ``ranks``
    are their modules in TP-rank order and ``devices`` their devices,
    rank 0's being ``device``; the models run each rank's part of a
    layer there (``tp_ranks``).  A row of one rank (``model`` = 1) runs
    the one-device forward, save where a mesh's cache takes it over its
    ranks (``row_ranks``: serving on a mesh)."""
    old = _STATE["local"], _STATE["rank"]
    _STATE["local"] = (split, torch.device(device),
                       None if ranks is None else list(ranks),
                       None if devices is None
                       else [torch.device(d) for d in devices])
    _STATE["rank"] = None
    try:
        yield
    finally:
        _STATE["local"], _STATE["rank"] = old


def row_ranks() -> Optional[List[nn.Module]]:
    """The modules of the running data row's ranks (one a TP rank; one
    for ``model`` = 1), or None outside a row of a mesh."""
    local = _STATE["local"]
    return None if local is None else local[2]


def tp_ranks() -> Optional[List[nn.Module]]:
    """The modules of the running data row's TP ranks, or None outside a
    tensor-parallel row (a ``model`` axis > 1)."""
    ranks = row_ranks()
    return None if ranks is None or len(ranks) < 2 else ranks


def tp_devices() -> List[torch.device]:
    """The devices of the running row's TP ranks."""
    return list(_STATE["local"][3])


@contextmanager
def on_rank(rank: int):
    """Inside: TP rank ``rank``'s part of a layer (its pins and its
    FSDP gathers are that rank's)."""
    old = _STATE["rank"]
    _STATE["rank"] = rank
    try:
        yield
    finally:
        _STATE["rank"] = old


def _device():
    local = _STATE["local"]
    if local is None:
        return None
    rank = _STATE["rank"]
    return local[1] if rank is None or local[3] is None else local[3][rank]


def gather_params(tree, rank: Optional[int] = None):
    """The reference's per-layer FSDP all-gather.  With ``gather_rules``
    and a mesh configured: ``tree`` (a layer's ``ParamTree``, or a dict
    or list of its parts) as nested dicts and lists whose leaves that
    FSDP placement cut over data (``fsdp.group``) are gathered onto the
    calling shard's device — TP rank ``rank``'s (default: the running
    rank's, else rank 0's) — along the axis ``gathered_rule`` releases
    (``fsdp.gather``: its backward is the gradient reduce-scatter); the
    gathered leaf stays that rank's TP cut, and the leaves not cut over
    data pass through.  Otherwise ``tree`` itself.  Called inside the
    region ``layers.remat`` recomputes, so no layer's gathered weights
    outlive the layer."""
    if _STATE["gather_rules"] is None or _STATE["mesh"] is None:
        return tree
    if rank is None:
        rank = _STATE["rank"] or 0
    with on_rank(rank):
        device = _device()
    if rank and device is not None and not live(device):
        # one slot's reckoning: a rank > 0 off the reckoned slot runs
        # nothing that reads its gathered weights
        return tree

    def one(node):
        if isinstance(node, torch.Tensor):
            return fsdp.gather(node, node.device if device is None
                               else device, rank)
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


# the axis a spec cuts over the TP axis, for each kind that cuts one
_TP_AXIS = {"btd_sp": 1, "btd_fsdp": -1, "bthd": 2, "btf": -1}


def _check(x, want, device, kind, shape, sp):
    if tuple(x.shape) != want or x.device != device:
        raise RuntimeError(
            f"actctx.shard({kind!r}): a shard of {shape} under {sp} is "
            f"{want} on {device}, got {tuple(x.shape)} on {x.device}")


def shard(x, kind: str, size: Optional[int] = None):
    """Pin ``x`` to ``spec(global shape, kind)``; returns ``x``.  Under
    ``local_shard`` it raises unless ``x`` has the local shape that spec
    implies and lies on the shard's device.  In a tensor-parallel row
    ``x`` is one tensor (the running rank's — ``size``, where given, is
    the global size of the axis ``kind`` may cut over ``model``: a
    rank's heads of ``num_heads``, its logits of the vocabulary —, or,
    outside a rank, the row's replicated value on rank 0's device) or
    the list of the ranks' cuts along the axis the spec cuts over
    ``model``."""
    if _STATE["mesh"] is None:
        return x
    local = _STATE["local"]
    if local is None:
        return x
    split = local[0]
    if isinstance(x, (list, tuple)):
        axis = _TP_AXIS[kind] % x[0].dim()
        shape = [n * (split if i == 0 else 1) * (len(x) if i == axis else 1)
                 for i, n in enumerate(x[0].shape)]
        sp = spec(tuple(shape), kind)
        if sp[axis] != _STATE["tp"]:
            raise RuntimeError(
                f"actctx.shard({kind!r}): {len(x)} cuts along axis {axis} "
                f"of {tuple(shape)}, which {sp} does not cut over "
                f"{_STATE['tp']!r}")
        want = _local_shape(tuple(shape), sp)
        for part, device in zip(x, local[3]):
            _check(part, want, device, kind, tuple(shape), sp)
        return x
    shape = [x.shape[0] * split] + list(x.shape[1:])
    if size is not None:
        shape[_TP_AXIS[kind] % x.dim()] = size
    shape = tuple(shape)
    sp = spec(shape, kind)
    _check(x, _local_shape(shape, sp), _device(), kind, shape, sp)
    return x


def tp_axis(shape: Tuple[int, ...], kind: str) -> Optional[int]:
    """The axis of an activation of the global ``shape`` that
    ``spec(shape, kind)`` cuts over the TP axis, or None."""
    sp = spec(shape, kind)
    hits = [i for i, e in enumerate(sp) if e == _STATE["tp"]]
    return hits[0] if hits else None


def shard_ranks(xs: List[torch.Tensor], axis: Optional[int], kind: str):
    """A tensor-parallel row's residual laid out as the pin ``kind``
    asks, and pinned (``shard``): ``xs`` is the row's replicated value
    (``[x]``, ``axis`` None) or the ranks' cuts along ``axis``.  Returns
    (the residual, its axis): moved between the layouts by the
    collectives of ``distributed.tp`` (a split, a gather), as GSPMD
    reshards at a ``with_sharding_constraint``."""
    from . import tp
    split = _STATE["local"][0]
    part = xs[0]
    shape = [n * (split if i == 0 else 1)
             * (len(xs) if axis is not None and i == axis else 1)
             for i, n in enumerate(part.shape)]
    want = tp_axis(tuple(shape), kind)
    if want != axis:
        row = xs[0] if axis is None else tp.gather_seq(xs, axis)
        xs = [row] if want is None else tp.split_to_ranks(
            row, want, tp_devices())
        axis = want
    shard(xs[0] if axis is None else xs, kind)
    return xs, axis


__all__ = ["configure", "use", "stationary", "one_slot", "live",
           "skipping", "rank_live", "running_rank", "local_shard",
           "row_ranks", "tp_ranks", "tp_devices",
           "on_rank", "gather_params", "spec", "shard", "tp_axis",
           "shard_ranks"]
