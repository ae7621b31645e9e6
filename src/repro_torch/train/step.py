"""Train-step builder: forward + backward, clip, AdamW, optional
microbatch accumulation, gradient compression and data and tensor
parallelism over a mesh — port of ``src/repro/train/step.py``.

The reference's step is a pure function that XLA compiles, its buffers
donated, and GSPMD inserts the collectives from the shardings of its
inputs.  Here the weights live in the model and the step updates them,
and the optimizer's moments, in place; it returns its metrics as device
tensors and never waits on the host.  With a ``(data, model)`` mesh the
step does what GSPMD does for a batch sharded over ``data`` and the
weights placed as the reference's launcher places them
(``ShardingRules.param_specs``: ZeRO-3 over the data axis, tensor
parallelism over the model axis; ``distributed.fsdp``):

  * the batch (every key: ``tokens``, ``patch_embeds``, ``frames``) is
    cut along its leading axis as ``ShardingRules.batch_specs`` says,
    one shard a data row of slots (every TP rank of a row sees its
    rows); a batch the axis does not divide is replicated, as in the
    reference, and the rows on distinct devices each run it whole;
  * every leaf the spec cuts over ``model`` (heads, FFN columns and
    rows, experts, SSD heads, vocabulary) is held as TP rank j's part on
    the slots of column j, and every leaf it cuts over the FSDP axes as
    data index i's cut of that on slot (i, j), and so are its AdamW
    moments; every other leaf is one replica a distinct device, shared
    by the slots on it.  ``placement="replicated"`` cuts nothing over
    data; the model axis is always cut;
  * every data row runs its forward over its TP ranks
    (``actctx.local_shard(..., ranks=)``: each layer's ranks inside one
    recomputed region, joined by ``distributed.tp``'s collectives); in
    each layer the forward all-gathers the layer's data shards onto each
    rank's device (``actctx.gather_params``).  The MoE routing fractions
    of every dispatch window are all-reduced over the data rows before
    any backward, so each row's loss carries the global Switch aux loss
    (its gradient flows through the row's own mean router
    probabilities only, as in the single-device step); then each row
    runs its backward, in which the gathers send each owner its slice of
    the cotangent;
  * the tensors that hold one part of a leaf — a replicated leaf's
    devices, a leaf cut over data but not over ``model`` on the cards
    of one data index, a replica every TP rank used — are summed in
    fp32 and share the sum (the data axis's mean, the model axis's sum);
  * the global grad norm counts each part of each leaf once, the
    ``grad_transform`` runs on each slot's gradients, and each slot runs
    AdamW on the tensors it is the first to hold.

So the step's numbers are the single-device step's up to the order of
sums.  In one slot's reckoning (``actctx.one_slot``, the dry run) a
data row none of whose slots is reckoned runs no forward or backward:
the reckoned slot receives, in its place, the gradient slices the
row's gathers would send it; and the slots off it update nothing.
Peak activation memory is the single-device step's too, not 1/n of
it: every row's forward is alive until the routing fractions are
reduced.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import optimizer as opt
from ..distributed import actctx, fsdp, tp
from ..distributed.collectives import all_reduce_mean
from ..distributed.sharding import ShardingRules
from ..models import moe as MOE
from ..models.transformer import AUX_WEIGHT

f32 = torch.float32


def make_train_step(model, opt_cfg: opt.OptConfig, *, accum_steps: int = 1,
                    remat: bool = True, accum_dtype=f32,
                    grad_transform: Optional[Callable] = None,
                    grad_constraint: Optional[Callable] = None,
                    mesh=None, placement: str = "fsdp") -> Callable:
    """``train_step(opt_state, batch) -> metrics`` for ``model`` (an
    ``LM`` or ``EncDec``), whose parameters become trainable here.

    ``batch``: the ``TokenPipeline`` dict (numpy arrays or tensors);
    with ``accum_steps`` > 1 it is split along its leading axis into
    that many microbatches, whose gradients accumulate in
    ``accum_dtype`` and are averaged; each microbatch has its own MoE
    capacity and aux loss, as in the reference.  ``grad_transform``:
    optional hook applied to the mean gradients (a mapping of names to
    tensors), e.g. ``distributed.collectives.compress_decompress``.
    ``metrics``: ``loss``, ``aux`` (the summed MoE aux loss, the mean
    over microbatches), ``grad_norm`` and ``lr``, device scalars on the
    model's device.

    ``grad_constraint``: the reference's per-microbatch hook on the raw
    gradients (there, a sharding pin whose value is the identity),
    applied to each microbatch's gradients as the reference applies it.
    On a mesh the step lays the gradients out itself (the pin's
    reduce-scatter is the gather's backward) and no slot sees a whole
    raw gradient, so there it must be None.

    ``mesh`` (``launch.mesh.Mesh`` over ``(data, model)``): the mesh
    step of the module docstring, ``placement`` ``"fsdp"`` (the
    reference launcher's layout) or ``"replicated"`` over the data axis,
    tensor parallelism over the model axis.  With
    accumulation each microbatch is cut into the data shards, so
    microbatch i holds the same rows as on one device.  Building the
    step places ``model`` in place (``fsdp.place``; the model must lie
    on the mesh's first device): its cut leaves become slot 0's shards,
    and the step's ``slots`` holds one module a slot (slot i·model + j:
    data row i, TP rank j).  ``opt_state`` is
    slot 0's: ``opt.init`` on the placed model links every slot's
    moments; a state of whole tensors (a restored checkpoint, or
    ``opt.init`` before the step was built) is cut at the first call
    with it, and the replicated leaves and moments are copied to the
    other devices then too.  ``fsdp.load_whole`` loads whole weights
    into the shards; ``convert.to_reference_state`` gathers them
    back."""
    if isinstance(accum_dtype, str):
        accum_dtype = opt._DTYPES[accum_dtype]
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    names = list(params)
    dev = model.device
    if placement not in ("replicated", "fsdp"):
        raise ValueError(f"placement {placement!r}: 'replicated' or 'fsdp'")
    if mesh is not None:
        if grad_constraint is not None:
            raise ValueError("grad_constraint on a mesh: the step lays "
                             "the gradients out itself (pass None)")
        return _data_parallel_step(model, opt_cfg, mesh, names, accum_steps,
                                   remat, accum_dtype, grad_transform,
                                   cut=placement == "fsdp")
    leaves = list(params.values())

    def loss_and_grads(batch):
        with MOE.collect_aux_stats() as stats:
            loss = model.loss(batch, remat=remat)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        if grad_constraint is not None:
            grads = grad_constraint(grads)
        return loss.detach(), _aux(stats, model, dev), grads

    def train_step(opt_state: Dict, batch: Dict) -> Dict:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if accum_steps == 1:
            loss, aux, grads = loss_and_grads(batch)
        else:
            # microbatches over the leading batch axis: peak activation
            # memory at 1/accum of the full batch
            loss = torch.zeros((), dtype=f32, device=dev)
            aux = torch.zeros((), dtype=f32, device=dev)
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype, device=dev)
                     for k, p in params.items()}
            for mb in _microbatches(batch, accum_steps):
                l, a, g = loss_and_grads(mb)
                loss, aux = loss + l, aux + a
                for k, acc in grads.items():
                    acc.add_(g[k])
                del g
            loss, aux = loss / accum_steps, aux / accum_steps
            grads = {k: g / accum_steps for k, g in grads.items()}
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, _, metrics = opt.update(opt_cfg, grads, opt_state, params)
        metrics["loss"] = loss
        metrics["aux"] = aux
        return metrics

    return train_step


def _microbatches(batch: Dict, accum_steps: int):
    for i in range(accum_steps):
        yield {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                            + tuple(v.shape[1:]))[i]
               for k, v in batch.items()}


def _aux(stats, model, dev) -> torch.Tensor:
    """The summed aux loss of one forward's records, detached."""
    if not stats:
        return torch.zeros((), dtype=f32, device=dev)
    return MOE.aux_from_stats(stats, model.cfg.num_experts).detach()


def _classes(params, names, mesh):
    """For each leaf: the slots that hold a distinct tensor of it, in
    slot order (``owner``: the first slot of each), grouped by the part
    of the leaf they hold — slots on a column for a cut over ``model``,
    on a row for a cut over data, all of them for a replicated leaf.
    Every tensor of a group ends up with the group's summed gradient."""
    t = mesh.shape.get("model", 1)
    slots = list(mesh.devices.flat)
    owners, classes = {}, {}
    for k in names:
        seen, per = {}, {}
        g = fsdp.group(params[0][k])
        for s in range(len(params)):
            key = (None if g is None or g.dim is None else s // t,
                   None if g is None or g.tp_dim is None else s % t)
            # a distinct tensor: a distinct part on a distinct device (what
            # ``fsdp.place`` shares; one slot's reckoning shares more)
            if key + (slots[s],) in seen:
                continue
            seen[key + (slots[s],)] = s
            per.setdefault(key, []).append(s)
        owners[k] = sorted(seen.values())
        classes[k] = list(per.values())
    return owners, classes


def _data_parallel_step(model, opt_cfg, mesh, names, accum_steps, remat,
                        accum_dtype, grad_transform, cut):
    rules = ShardingRules(model.cfg, mesh)
    slots = list(mesh.devices.flat)
    n = len(slots)
    t = mesh.shape.get("model", 1)
    modules = fsdp.place(model, mesh, rules, cut=cut)
    params = [dict(m.named_parameters()) for m in modules]
    owners, classes = _classes(params, names, mesh)
    # what slot s holds and updates: the leaves whose tensor it is the
    # first slot to hold
    owned = [[k for k in names if s in owners[k]] for s in range(n)]
    gathers = any(fsdp.group(p) is not None and fsdp.group(p).dim is not None
                  for p in params[0].values())
    # a row whose TP ranks lie on several cards runs its backward on this
    # thread: the recomputed regions switch ranks in ``actctx``'s state,
    # which the autograd engine's device threads would share
    spread = t > 1 and any(len(set(slots[r:r + t])) > 1
                           for r in range(0, n, t))
    held = {"opt_id": None, "opt": None}

    def place_opt(opt_state):
        """Every slot's optimizer state from slot 0's ``opt_state``."""
        states = [opt_state] + [{"m": {}, "v": {}} for _ in range(n - 1)]
        for part in ("m", "v"):
            for k in names:
                p0, m = params[0][k], opt_state[part][k]
                if fsdp.group(p0) is None:
                    for s in owners[k][1:]:
                        states[s][part][k] = m.to(slots[s], copy=True)
                    continue
                if fsdp.group(m) is None:
                    whole = fsdp.whole(p0, "meta").shape
                    if m.shape != whole:
                        raise ValueError(
                            f"opt_state[{part!r}][{k!r}]: {tuple(m.shape)} "
                            "is neither linked shards nor the whole leaf")
                    m = opt_state[part][k] = fsdp.place_like(m, p0)
                shards = fsdp.group(m).shards
                for s in owners[k][1:]:
                    states[s][part][k] = shards[s]
        for s in range(1, n):
            states[s]["step"] = opt_state["step"].to(slots[s], copy=True)
        with torch.no_grad():
            for k in names:
                if fsdp.group(params[0][k]) is None:
                    for s in owners[k][1:]:
                        params[s][k].copy_(params[0][k])
        held.update(opt_id=id(opt_state), opt=states)

    def in_row(s, split):
        """The contexts of the data row whose rank 0 is slot ``s``."""
        row = range(s, s + t)
        return actctx.use(mesh, rules.dp,
                          gather_rules=rules if gathers else None), \
            actctx.local_shard(split, slots[s],
                               ranks=[modules[r] for r in row],
                               devices=[slots[r] for r in row])

    def microbatch(mb, runners, split):
        """Forward every data row (each over its TP ranks), all-reduce
        the routing fractions, backward every row (into the leaves'
        ``.grad``: the reduce-scatter, the TP collectives' backward and
        the device sums).  Returns (loss, aux)."""
        b = next(iter(mb.values())).shape[0]
        outs = []
        for i, s in enumerate(runners):
            if not row_live(s, split):
                outs.append(None)
                continue
            lo, hi = (i * b // split, (i + 1) * b // split) if split > 1 \
                else (0, b)
            part = {k: torch.as_tensor(v[lo:hi]).to(slots[s])
                    for k, v in mb.items()}
            use, local = in_row(s, split)
            with use, local, MOE.collect_aux_stats() as stats:
                loss = modules[s].loss(part, remat=remat)
            outs.append((loss, stats))
        ref = next(o for o in outs if o is not None)
        if any(o is None for o in outs):
            used[:] = _gathered(ref[0])
        outs = [(tp.placeholder(ref[0]), [st._replace(
            me=tp.placeholder(st.me), ce=tp.placeholder(st.ce))
            for st in ref[1]]) if o is None else o for o in outs]
        losses, aux = _global_aux(outs, split, model.cfg.num_experts)
        for i, s in enumerate(runners):
            use, local = in_row(s, split)
            with use, local, torch.autograd.set_multithreading_enabled(
                    not spread):  # the recomputed regions gather again
                if row_live(s, split):
                    torch.autograd.backward(losses[i])
                else:
                    arrivals(s)
        losses = [l.detach().to(slots[0]) for l in losses[:split]]
        return sum(losses) / split, aux.to(slots[0])

    def row_live(s, split) -> bool:
        """Whether the data row whose rank 0 is slot ``s`` runs: always,
        but in one slot's reckoning, where a row of a cut batch none of
        whose slots is reckoned leaves nothing on the reckoned slot but
        the slices its gathers' backward sends it (``arrivals``)."""
        return split == 1 or any(actctx.live(d) for d in slots[s:s + t])

    used = []       # the reckoned slot's shards a row's backward reaches

    def arrivals(s):
        """One slot's reckoning, in place of the backward of a data row
        (rank 0 at slot ``s``) that it does not run: what the backward of
        the row's gathers that reach the reckoned slot's shards — those
        the reckoned slot's own row reaches (``_gathered``), a row's rank
        using the same leaves in every row — leaves there: each its slice
        of the row's gradient (the reduce-scatter), a fresh tensor that
        becomes the shard's gradient or is added into it, as autograd
        accumulates it."""
        with torch.no_grad():
            for p in used:
                fresh = torch.empty(p.shape, dtype=p.dtype, device=p.device)
                if p.grad is None:
                    p.grad = fresh
                else:
                    p.grad.add_(fresh)
                del fresh

    def grad_of(s, k):
        p = params[s][k]
        if not actctx.live(slots[s]):
            return None     # one slot's reckoning: made where needed
        g = p.grad
        p.grad = None
        # a replica no rank's part reached (a router on a TP rank > 0)
        return torch.zeros_like(p) if g is None else g


    def train_step(opt_state: Dict, batch: Dict) -> Dict:
        if held["opt_id"] != id(opt_state):
            place_opt(opt_state)
        for s in range(n):
            for p in params[s].values():
                p.grad = None
        b = next(iter(batch.values())).shape[0]
        runners, split = fsdp.batch_slots(rules, b // accum_steps)
        acc = [{} for _ in range(n)]
        loss = aux = 0.0
        for mb in (_microbatches(batch, accum_steps) if accum_steps > 1
                   else [batch]):
            l, a = microbatch(mb, runners, split)
            loss, aux = loss + l, aux + a
            if accum_steps > 1:
                for s in range(n):
                    if not actctx.live(slots[s]):
                        continue
                    for k in owned[s]:
                        g = grad_of(s, k)
                        if k in acc[s]:
                            acc[s][k].add_(g)
                        else:
                            acc[s][k] = g.to(accum_dtype, copy=True)
        grads = [{k: acc[s].pop(k, None) if accum_steps > 1
                  else grad_of(s, k) for k in owned[s]} for s in range(n)]

        def grad(s, k):     # one slot's reckoning: a placeholder
            g = grads[s][k]
            return tp.placeholder(params[s][k]) if g is None else g
        # the mean over the data rows and microbatches: the tensors that
        # hold one part of a leaf (a data cut's model replicas, a
        # replicated leaf's devices, a replica each TP rank used) are
        # summed in fp32 and share the sum
        count = len(runners) * accum_steps
        for k in names:
            for cls in classes[k]:
                if not any(actctx.live(slots[s]) for s in cls):
                    continue
                parts = [grad(s, k) for s in cls]
                if len(parts) == 1:
                    if count > 1:
                        parts[0].div_(count)
                    continue
                total = parts[0].to(f32, copy=True)
                for g in parts[1:]:
                    total.add_(g.to(total.device, f32))
                total.div_(count)
                for g in parts:
                    g.copy_(total)
        for k in names:
            g0 = fsdp.group(params[0][k])
            if g0 is not None:
                first = {id(params[s][k]): s for s in owners[k]}
                fsdp.link([grad(first[id(p)], k) for p in g0.shards],
                          g0.dim, tp_dim=g0.tp_dim, shape=g0.shape)
        if grad_transform is not None:
            # a slot that shares its device with an earlier one and
            # holds no shard owns nothing
            grads = [grad_transform(g) if g else g for g in grads]
        # the global norm: each part of each leaf once
        sq = [torch.linalg.vector_norm(grad(cls[0], k), dtype=f32
                                       ).square().to(slots[0])
              for k in names for cls in classes[k]]
        gnorm = torch.sqrt(torch.stack(sq).sum())
        metrics = None
        for s in range(n):
            g = grads[s]
            grads[s] = None
            if not actctx.live(slots[s]) and s:
                continue        # one slot's reckoning: nothing lands here
            live = actctx.live(slots[s])
            _, _, m = opt.update(opt_cfg, g if live else {},
                                 held["opt"][s],
                                 {k: params[s][k] for k in owned[s]}
                                 if live else {}, gnorm=gnorm.to(slots[s]))
            del g
            metrics = m if metrics is None else metrics
        metrics["loss"] = loss / accum_steps
        metrics["aux"] = aux / accum_steps
        return metrics

    train_step.slots = modules
    return train_step


def _gathered(loss) -> list:
    """The shards on a live device (``actctx.live``) whose gathers
    (``fsdp.gather``) the autograd graph of ``loss`` reaches, once a
    gather."""
    out, seen, stack = [], set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        nexts = [f for f, _ in node.next_functions if f is not None]
        if isinstance(node, fsdp._Gather._backward_cls):
            out += [f.variable for f in nexts if hasattr(f, "variable")
                    and actctx.live(f.variable.device)]
        stack.extend(nexts)
    return out


def _global_aux(outs, split: int, num_experts: int):
    """Each shard's loss with the global Switch aux loss in place of its
    own, and the global aux value.  ``outs``: (loss, aux records) a
    shard.  A window's global aux is E · Σ_e mean_s(me_s) · ce_e with
    ``ce`` all-reduced over the shards; shard s's share of its gradient
    is E · Σ_e me_s · ce_e, so its loss gains AUX_WEIGHT · that minus
    its local aux term.  A replicated batch (``split`` = 1) has nothing
    to reduce."""
    losses = [loss for loss, _ in outs]
    dev = losses[0].device
    first = outs[0][1]
    if not first:
        return losses, torch.zeros((), dtype=f32, device=dev)
    if split == 1:
        return losses, MOE.aux_from_stats(first, num_experts).detach()
    aux = torch.zeros((), dtype=f32, device=dev)
    ce = [all_reduce_mean([st[j].ce for _, st in outs])
          for j in range(len(first))]
    for s, (_, stats) in enumerate(outs):
        corr = sum(st.weight * num_experts
                   * torch.sum(st.me * (ce[j][s] - st.ce))
                   for j, st in enumerate(stats))
        losses[s] = losses[s] + AUX_WEIGHT * corr
        aux = aux + MOE.aux_from_stats(
            [st._replace(ce=ce[j][s]) for j, st in enumerate(stats)],
            num_experts).detach().to(dev) / len(outs)
    return losses, aux


__all__ = ["make_train_step"]
