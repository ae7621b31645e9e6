"""Train-step builder: forward + backward, clip, AdamW, optional
microbatch accumulation, gradient compression and data parallelism over
a mesh — port of ``src/repro/train/step.py``.

The reference's step is a pure function that XLA compiles, its buffers
donated, and GSPMD inserts the data-parallel collectives from the
shardings of its inputs.  Here the weights live in the model and the
step updates them, and the optimizer's moments, in place; it returns its
metrics as device tensors and never waits on the host.  With a mesh
(``model`` axis 1) the step does what GSPMD does for a batch sharded
over ``data`` and the weights placed as the reference's launcher places
them (``ShardingRules.param_specs``, ZeRO-3 over the data axis,
``distributed.fsdp``):

  * the batch (every key: ``tokens``, ``patch_embeds``, ``frames``) is
    cut along its leading axis as ``ShardingRules.batch_specs`` says,
    one shard a slot of the data axis; a batch the axis does not divide
    is replicated, as in the reference, and each distinct device runs
    it whole;
  * every leaf whose spec shards it over the FSDP axes is held as one
    shard a slot, on the slot's device, and so are its AdamW moments;
    every other leaf (with ``model`` = 1: the embedding, the head,
    norms, routers) is one replica a distinct device, shared by the
    slots on it.  ``placement="replicated"`` cuts no leaf: one replica
    of every weight and moment a device;
  * every shard runs its forward on its slot's device; inside each
    layer's recomputed region the forward all-gathers the layer's
    shards onto that device (``actctx.gather_params``).  The MoE
    routing fractions of every dispatch window are all-reduced before
    any backward, so each shard's loss carries the global Switch aux
    loss (its gradient flows through the shard's own mean router
    probabilities only, as in the single-device step); then each shard
    runs its backward, in which the gather sends each owner its slice
    of the cotangent: the sharded leaves' gradients arrive
    reduce-scattered, the replicated leaves' summed on each device, and
    those are all-reduced across devices in fp32;
  * the global grad norm is the sum of every owner's local squares plus
    the replicated leaves' counted once, the ``grad_transform`` runs on
    each slot's gradients, and each slot runs AdamW on what it holds.

So the step's numbers are the single-device step's up to the order of
sums.  Peak activation memory is the single-device step's too, not 1/n
of it: every shard's forward is alive until the routing fractions are
reduced.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import optimizer as opt
from ..distributed import actctx, fsdp
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

    ``mesh`` (``launch.mesh.Mesh``, ``model`` axis 1): the data-parallel
    step of the module docstring, ``placement`` ``"fsdp"`` (the
    reference launcher's layout) or ``"replicated"``.  With
    accumulation each microbatch is cut into the data shards, so
    microbatch i holds the same rows as on one device.  Building the
    step places ``model`` in place (``fsdp.place``; the model must lie
    on the mesh's first device): its cut leaves become slot 0's shards,
    and the step's ``slots`` holds one module a slot.  ``opt_state`` is
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


def _model_axis_one(mesh) -> None:
    if mesh.shape.get("model", 1) != 1:
        raise ValueError(
            f"the port's train step runs data parallelism only (no tensor "
            f"parallelism); got a model axis of {mesh.shape['model']}")


def _data_parallel_step(model, opt_cfg, mesh, names, accum_steps, remat,
                        accum_dtype, grad_transform, cut):
    _model_axis_one(mesh)
    rules = ShardingRules(model.cfg, mesh)
    slots = list(mesh.devices.flat)
    n = len(slots)
    modules = fsdp.place(model, mesh, rules, cut=cut)
    params = [dict(m.named_parameters()) for m in modules]
    devices = list(dict.fromkeys(slots))
    first = {d: slots.index(d) for d in devices}
    dims = {k: fsdp.group(p).dim for k, p in params[0].items()
            if fsdp.group(p) is not None}
    # what slot s holds and updates: its shards, and the replicated
    # leaves where it is the first slot on its device
    owned = [[k for k in names if k in dims or first[slots[s]] == s]
             for s in range(n)]
    held = {"opt_id": None, "opt": None}

    def place_opt(opt_state):
        """Every slot's optimizer state from slot 0's ``opt_state``."""
        states = [opt_state] + [{"m": {}, "v": {}} for _ in range(n - 1)]
        for part in ("m", "v"):
            for k in names:
                t = opt_state[part][k]
                if k not in dims:
                    for d in devices[1:]:
                        states[first[d]][part][k] = t.to(d, copy=True)
                    continue
                if fsdp.group(t) is None:
                    shape = list(params[0][k].shape)
                    shape[dims[k]] *= n
                    if list(t.shape) != shape:
                        raise ValueError(
                            f"opt_state[{part!r}][{k!r}]: {tuple(t.shape)} "
                            "is neither linked shards nor the whole leaf")
                    t = opt_state[part][k] = fsdp.link(
                        fsdp.split(t, dims[k], slots), dims[k])[0]
                for s, shard in enumerate(fsdp.group(t).shards[1:], 1):
                    states[s][part][k] = shard
        for s in range(1, n):
            states[s]["step"] = opt_state["step"].to(slots[s], copy=True)
        with torch.no_grad():
            for d in devices[1:]:
                for k in names:
                    if k not in dims:
                        params[first[d]][k].copy_(params[0][k])
        held.update(opt_id=id(opt_state), opt=states)

    def in_shard(s, split):
        return actctx.use(mesh, rules.dp,
                          gather_rules=rules if dims else None), \
            actctx.local_shard(split, slots[s])

    def microbatch(mb, runners, split):
        """Forward every shard, all-reduce the routing fractions,
        backward every shard (into the leaves' ``.grad``: the
        reduce-scatter and the device sums).  Returns (loss, aux)."""
        b = next(iter(mb.values())).shape[0]
        outs = []
        for i, s in enumerate(runners):
            lo, hi = (i * b // split, (i + 1) * b // split) if split > 1 \
                else (0, b)
            part = {k: torch.as_tensor(v[lo:hi]).to(slots[s])
                    for k, v in mb.items()}
            use, local = in_shard(s, split)
            with use, local, MOE.collect_aux_stats() as stats:
                loss = modules[s].loss(part, remat=remat)
            outs.append((loss, stats))
        losses, aux = _global_aux(outs, split, model.cfg.num_experts)
        for i, s in enumerate(runners):
            use, local = in_shard(s, split)
            with use, local:      # the recomputed regions gather again
                torch.autograd.backward(losses[i])
        losses = [l.detach().to(slots[0]) for l in losses[:split]]
        return sum(losses) / split, aux.to(slots[0])

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
                    for k in owned[s]:
                        p = params[s][k]
                        if k in acc[s]:
                            acc[s][k].add_(p.grad)
                        else:
                            acc[s][k] = p.grad.to(accum_dtype, copy=True)
                        p.grad = None
        grads = [{} for _ in range(n)]
        for s in range(n):
            for k in owned[s]:
                p = params[s][k]
                grads[s][k] = acc[s].pop(k) if accum_steps > 1 else p.grad
                p.grad = None
        # the mean over the batch shards and microbatches: the sharded
        # leaves' sums are on their owners; the replicated leaves' device
        # sums are all-reduced
        count = len(runners) * accum_steps
        for k in names:
            if k in dims or len(devices) == 1:
                for s in range(n):
                    if k in grads[s] and count > 1:
                        grads[s][k].div_(count)
                continue
            parts = [grads[first[d]][k] for d in devices]
            total = parts[0].to(f32, copy=True)
            for g in parts[1:]:
                total.add_(g.to(slots[0], f32))
            total.div_(count)
            for d, g in zip(devices, parts):
                g.copy_(total)
        for k, dim in dims.items():
            fsdp.link([grads[s][k] for s in range(n)], dim)
        if grad_transform is not None:
            # a slot that shares its device with an earlier one and
            # holds no shard owns nothing
            grads = [grad_transform(g) if g else g for g in grads]
        # the global norm: each owner's squares, the replicated leaves once
        sq = [torch.linalg.vector_norm(g, dtype=f32).square().to(slots[0])
              for s in range(n) for k, g in grads[s].items()
              if k in dims or s == 0]
        gnorm = torch.sqrt(torch.stack(sq).sum())
        metrics = None
        for s in range(n):
            g = grads[s]
            grads[s] = None
            _, _, m = opt.update(opt_cfg, g, held["opt"][s],
                                 {k: params[s][k] for k in owned[s]},
                                 gnorm=gnorm.to(slots[s]))
            del g
            metrics = m if metrics is None else metrics
        metrics["loss"] = loss / accum_steps
        metrics["aux"] = aux / accum_steps
        return metrics

    train_step.slots = modules
    return train_step


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
