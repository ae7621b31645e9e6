"""Tensor-parallel collectives over the ``model`` axis of one data row —
what GSPMD inserts for the reference's specs that cut heads, FFN
columns, experts, SSD heads and the vocabulary over ``model``
(``ShardingRules._param_rule``), written out as autograd functions.

One Python thread drives every rank of a row (``train.step``), so a
collective takes the list of the ranks' tensors, in rank order, and
returns one tensor a rank on that rank's device; a sum is a fold in
fp32, rank 0 first, cast once to the parts' dtype (the style of
``collectives.all_reduce_mean``).  Where every rank lies on one device
(the CPU tests, one card), each copy is a view, never a second
allocation.

  * ``copy_to_ranks(x, devices)`` — Megatron's *f*: each rank gets
    ``x``; the backward sums the ranks' gradients;
  * ``reduce_from_ranks(parts)`` — Megatron's *g*: the sum of the
    row-parallel partials.  The sum lands once, on rank 0's device:
    what follows it is replicated work, which the port runs once a row
    (so a shared replica's gradient is not counted once a rank); its
    backward hands that gradient to every rank — the identity a rank of
    Megatron's, whose copy would take the same gradient;
  * ``all_gather(parts, dim)`` / ``reduce_scatter_seq(parts, dim)`` —
    the sequence-parallel pair, along axis 1 for the ``btd_sp``
    residual and along the feature axis for ``btd_fsdp``; each is the
    other's backward;
  * ``gather_seq(parts, dim)`` — the cut parts joined once, on rank 0's
    device (its backward cuts the gradient back);
  * ``split_to_ranks(x, dim, devices)`` — rank j takes the j-th cut of
    ``x`` (a replicated residual entering the sequence-parallel layout,
    the routing tensors cut over the experts); the backward joins the
    gradients on ``x``'s device.

``enter`` and ``leave`` put them together at a sublayer's edges: the
ranks' normed inputs from the row's residual, and the residual's
update from the ranks' outputs.  ``run_ranks`` runs a part on each
rank; in one slot's reckoning (``actctx.one_slot``) a rank, and a
collective's destination, off the reckoned slot get ``meta``
placeholders instead.

Serving needs no gradient, and its collectives run over the ranks that
hold a decode cache's sequence (a row's TP ranks, or every slot of the
mesh) as well as over the TP ranks.  They are plain functions over
lists of rank tensors, in the same style (fp32, rank 0 first, views
where ranks share a device):

  * ``max_over_ranks`` / ``sum_over_ranks`` — the element-wise max and
    the fp32 sum of the parts, on every part's device (a softmax spread
    over the sequence ranks);
  * ``fold_to(parts, device)`` — the fp32 sum on one device, not cast
    (the attention context's partials);
  * ``gather_to(parts, dim, devices)`` — the parts joined along ``dim``
    on each of ``devices`` (the query heads, from the TP ranks to the
    sequence ranks);
  * ``argmax_over_ranks(parts)`` — the greedy token of logits cut over
    the ranks by vocabulary: the lowest global index of the maximum, as
    ``jnp.argmax`` takes it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from . import actctx

f32 = torch.float32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def placeholder(tree):
    """A ``meta`` tensor of each tensor's shape and dtype in ``tree`` (a
    tensor, or lists, tuples and dicts of them): the result of work that
    one slot's reckoning does not run (``actctx.one_slot``)."""
    if isinstance(tree, torch.Tensor):
        return _meta(tree.shape, tree.dtype)
    if isinstance(tree, dict):
        return {k: placeholder(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(placeholder(v) for v in tree)
    return tree


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _unflatten(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return tree


class _Mark(torch.autograd.Function):
    """Where a rank's part that one slot's reckoning does not run would
    be, in the autograd graph: a node over the tensors the part would
    read, which saves one of them, as the part would (so a recomputed
    region, ``layers.remat``, runs on to it before it stops), and whose
    backward hands them ``meta`` zeros (so the nodes around it wait for
    it as they would for the part)."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.shapes = [(t.shape, t.dtype) for t in inputs]
        ctx.save_for_backward(inputs[0])
        return _meta((), f32)

    @staticmethod
    def backward(ctx, g):
        return tuple(_meta(shape, dtype) for shape, dtype in ctx.shapes)


class _Stand(torch.autograd.Function):
    """Placeholders of the shapes of ``like`` that follow a ``_Mark``."""

    @staticmethod
    def forward(ctx, like, mark):
        return tuple(_meta(t.shape, t.dtype) for t in like)

    @staticmethod
    def backward(ctx, *grads):
        return None, _meta((), f32)


def fan_out(items, fn, live) -> list:
    """``[fn(i) for i in items]`` without autograd (a serving step's data
    rows or data shards).  In one slot's reckoning an item whose work
    cannot reach the reckoned slot (``live(i)`` false) gets a placeholder
    of the first run item's result; where none is live, the first runs
    (on ``meta``), so that its result's shape is known."""
    items = list(items)
    if not actctx.skipping():
        return [fn(i) for i in items]
    run = [i for i in items if live(i)] or items[:1]
    out = {i: fn(i) for i in run}
    ref = out[run[0]]
    return [out[i] if i in out else placeholder(ref) for i in items]


def run_ranks(js, fn, live=None, inputs=None) -> list:
    """``[fn(j) for j in js]``, each under ``actctx.on_rank(j)``.  In one
    slot's reckoning a rank whose part cannot reach the reckoned slot
    (``live(j)``, by default ``actctx.rank_live``) gets a placeholder of
    the first run rank's result — under autograd, one that follows a
    ``_Mark`` over ``inputs(j)``, the tensors its part would read, made
    where the part would run; where none is live, the first rank runs
    (on ``meta``), so that its result's shape is known."""
    if not actctx.skipping():
        out = []
        for j in js:
            with actctx.on_rank(j):
                out.append(fn(j))
        return out
    js = list(js)
    live = live or actctx.rank_live
    run = [j for j in js if live(j)] or js[:1]
    out, marks = {}, {}
    for j in js:
        if j in run:
            with actctx.on_rank(j):
                out[j] = fn(j)
        elif inputs is not None and torch.is_grad_enabled():
            deps = [t for t in _leaves(inputs(j)) if t.requires_grad]
            if deps:
                marks[j] = _Mark.apply(*deps)
    ref = out[run[0]]

    def stand(j):
        if j not in marks:
            return placeholder(ref)
        return _unflatten(ref, iter(_Stand.apply(_leaves(ref), marks[j])))
    return [out[j] if j in out else stand(j) for j in js]


def _fold(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Σ parts in fp32 on ``device``, rank 0 first, cast once to the
    parts' dtype."""
    return fold_to(parts, device).to(parts[0].dtype)


def _to(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``: a view where it lies there already."""
    return x.view_as(x) if x.device == device else x.to(device)


def _dim(dim: int, nd: int) -> int:
    return dim % nd


def _bounds(n: int, t: int, dim: int) -> List[int]:
    if n % t:
        raise ValueError(f"axis {dim} of size {n} does not divide over "
                         f"{t} ranks")
    return [n // t] * t


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, x):
        ctx.device = x.device
        return tuple(_to(x, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        return None, _fold(grads, ctx.device)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.devices = [p.device for p in parts]
        return _fold(parts, parts[0].device)

    @staticmethod
    def backward(ctx, g):
        return tuple(_to(g, d) for d in ctx.devices)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        joined = {}
        out = []
        for d in ctx.devices:
            if d not in joined:
                joined[d] = _join(parts, dim, d)
                out.append(joined[d])
            else:
                out.append(joined[d].view_as(joined[d]))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        out, start = [], 0
        for d, n in zip(ctx.devices, ctx.sizes):
            out.append(_fold([g.narrow(ctx.dim, start, n) for g in grads],
                             d) if actctx.live(d) else _meta(
                grads[0].shape[:ctx.dim] + (n,) + grads[0].shape[
                    ctx.dim + 1:], grads[0].dtype))
            start += n
        return (None,) + tuple(out)


def _join(parts, dim: int, device) -> torch.Tensor:
    """The parts joined along ``dim`` on ``device`` (a placeholder where
    one slot's reckoning does not run it)."""
    if not actctx.live(device):
        shape = list(parts[0].shape)
        shape[dim] = sum(p.shape[dim] for p in parts)
        return _meta(shape, parts[0].dtype)
    return torch.cat([p.to(device) for p in parts], dim)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        n = parts[0].shape[dim]
        sizes = _bounds(n, len(parts), dim)
        out, start = [], 0
        for d, size in zip(ctx.devices, sizes):
            out.append(_fold([p.narrow(dim, start, size) for p in parts], d)
                       if actctx.live(d) else _meta(
                parts[0].shape[:dim] + (size,) + parts[0].shape[dim + 1:],
                parts[0].dtype))
            start += size
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        joined = {}
        for d in ctx.devices:
            if d not in joined:
                joined[d] = _join(grads, ctx.dim, d)
        return (None,) + tuple(joined[d] for d in ctx.devices)


class _GatherRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        return _join(parts, dim, parts[0].device)

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(_to(p, d) for p, d in zip(
            torch.split(g, ctx.sizes, ctx.dim), ctx.devices))


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, x):
        ctx.dim = dim
        ctx.device = x.device
        sizes = _bounds(x.shape[dim], len(devices), dim)
        return tuple(_to(p, d) for p, d in zip(torch.split(x, sizes, dim),
                                               devices))

    @staticmethod
    def backward(ctx, *grads):
        return None, None, _join(grads, ctx.dim, ctx.device)


def copy_to_ranks(x: torch.Tensor, devices: Sequence) -> List[torch.Tensor]:
    """Megatron's *f*: ``x`` on every rank's device (views where it lies
    there); the backward sums the ranks' gradients onto ``x``."""
    return list(_Copy.apply(list(devices), x))


def reduce_from_ranks(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Megatron's *g*: Σ of the row-parallel partials in fp32, rank 0
    first, cast once, on rank 0's device; every rank's partial takes its
    gradient."""
    if len(parts) == 1:
        return parts[0]
    return _Reduce.apply(*parts)


def all_gather(parts: Sequence[torch.Tensor], dim: int
               ) -> List[torch.Tensor]:
    """The parts joined along ``dim`` on every rank's device (one join a
    distinct device, views for the ranks that share it); the backward is
    the reduce-scatter of the ranks' gradients."""
    return list(_AllGather.apply(_dim(dim, parts[0].dim()), *parts))


def reduce_scatter_seq(parts: Sequence[torch.Tensor], dim: int
                       ) -> List[torch.Tensor]:
    """Rank j's cut of Σ parts along ``dim`` (fp32, rank 0 first, cast
    once), on rank j's device; the backward all-gathers the gradient."""
    return list(_ReduceScatter.apply(_dim(dim, parts[0].dim()), *parts))


def gather_seq(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The parts joined along ``dim`` once, on rank 0's device."""
    return _GatherRow.apply(_dim(dim, parts[0].dim()), *parts)


def split_to_ranks(x: torch.Tensor, dim: int, devices: Sequence
                   ) -> List[torch.Tensor]:
    """Rank j's j-th equal cut of ``x`` along ``dim``, on rank j's device
    (a view where it lies there)."""
    return list(_Split.apply(_dim(dim, x.dim()), list(devices), x))


# --------------------------------------------------------------------- #
# a sublayer's entry and exit on a data row's residual
# --------------------------------------------------------------------- #

def enter(xs: Sequence[torch.Tensor], axis, norm, devices: Sequence
          ) -> List[torch.Tensor]:
    """Each rank's whole normed input of a sublayer from the row's
    residual ``xs`` — ``[x]``, the replicated value (``axis`` None), or
    the ranks' cuts along ``axis``.  ``norm(x, rank)`` norms with that
    rank's replica of the weights.  Replicated: normed once, then *f*
    (its backward sums the ranks' gradients before the norm's, as one
    device does, and a replica shared by the ranks takes one gradient).
    Cut along the sequence (the ``btd_sp`` layout): each rank norms its
    cut, then the all-gather (Megatron's sequence parallelism; each
    rank's weight gradient is its rows' share).  Cut along the feature
    axis (``btd_fsdp``), which a norm needs whole: joined on rank 0
    (``gather_seq``), normed once, then *f*."""
    if axis is None:
        return copy_to_ranks(norm(xs[0], 0), devices)
    if axis == 1:
        return all_gather(run_ranks(range(len(xs)),
                                    lambda j: norm(xs[j], j),
                                    inputs=lambda j: xs[j]), 1)
    return copy_to_ranks(norm(gather_seq(xs, axis), 0), devices)


def ranks_to_run(partial: bool, axis, t: int) -> range:
    """The ranks that compute a sublayer: all of them, save for a whole
    (uncut) sublayer on a replicated residual, which rank 0 runs once."""
    return range(t if partial or axis is not None else 1)


def leave(outs: Sequence[torch.Tensor], axis, partial: bool
          ) -> List[torch.Tensor]:
    """The residual's update in its layout from the ranks' sublayer
    outputs: row-parallel partials are summed (the reduce-scatter along
    ``axis``, or *g* to the replicated value); whole outputs are cut to
    each rank's part (no collective), or rank 0's is taken."""
    if partial:
        return (reduce_scatter_seq(outs, axis) if axis is not None
                else [reduce_from_ranks(outs)])
    if axis is None:
        return [outs[0]]
    n = outs[0].shape[axis] // len(outs)
    return [o.narrow(axis, j * n, n) for j, o in enumerate(outs)]


# --------------------------------------------------------------------- #
# serving: no gradient; over the sequence ranks or the TP ranks
# --------------------------------------------------------------------- #

def _on_each(x: torch.Tensor, devices: Sequence) -> List[torch.Tensor]:
    """``x`` on each of ``devices``: one copy a distinct device, views
    for the devices that repeat and for ``x``'s own."""
    made = {}
    out = []
    for d in devices:
        d = torch.device(d)
        if d not in made:
            made[d] = x if x.device == d else x.to(d)
        out.append(made[d].view_as(made[d]))
    return out


def max_over_ranks(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The element-wise max of the parts in fp32 (exact in any order), on
    each part's device."""
    if actctx.live(parts[0].device):
        top = parts[0].to(f32, copy=True)
        for p in parts[1:]:
            top = torch.maximum(top, p.to(top.device, f32))
    else:
        top = _meta(parts[0].shape, f32)
    return _on_each(top, [p.device for p in parts])


def sum_over_ranks(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Σ parts in fp32, rank 0 first, cast once to the parts' dtype, on
    each part's device."""
    return _on_each(_fold(parts, parts[0].device),
                    [p.device for p in parts])


def fold_to(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Σ parts in fp32, rank 0 first, on ``device``; the sum stays fp32
    (a placeholder where one slot's reckoning does not run it)."""
    if not actctx.live(device):
        return _meta(parts[0].shape, f32)
    total = parts[0].to(device, f32, copy=True)
    for p in parts[1:]:
        total.add_(p.to(device, f32))
    return total


def gather_to(parts: Sequence[torch.Tensor], dim: int, devices: Sequence
              ) -> List[torch.Tensor]:
    """The parts joined along ``dim`` on each of ``devices`` (one join a
    distinct device, views for the rest)."""
    joined = _join(parts, _dim(dim, parts[0].dim()), parts[0].device) \
        if len(parts) > 1 else parts[0]
    return _on_each(joined, devices)


def argmax_over_ranks(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The argmax over the last axis of logits cut over the ranks by
    vocabulary: ``parts[j]`` (…, V_j) holds the columns V_0 + … +
    V_{j-1} onwards (a rank past the real vocabulary may hold none).
    Each rank takes its maximum and the first index of it; the ranks'
    are joined on rank 0's device, a later rank winning only where its
    maximum is larger, so the lowest global index wins ties, as
    ``jnp.argmax`` does.  Returns int64 indices on rank 0's device."""
    dev = parts[0].device
    if not actctx.live(dev):
        return _meta(parts[0].shape[:-1], torch.int64)
    best_v = best_i = None
    off = 0
    for p in parts:
        if p.shape[-1]:
            idx = torch.argmax(p, dim=-1, keepdim=True)
            val = torch.gather(p, -1, idx)[..., 0].to(dev, f32)
            idx = idx[..., 0].to(dev) + off
            if best_v is None:
                best_v, best_i = val, idx
            else:
                take = val > best_v
                best_v = torch.where(take, val, best_v)
                best_i = torch.where(take, idx, best_i)
        off += p.shape[-1]
    return best_i


__all__ = ["placeholder", "fan_out", "run_ranks", "copy_to_ranks", "reduce_from_ranks",
           "all_gather",
           "reduce_scatter_seq", "gather_seq", "split_to_ranks", "enter",
           "ranks_to_run", "leave", "max_over_ranks", "sum_over_ranks",
           "fold_to", "gather_to", "argmax_over_ranks"]
