"""Train-step builder: forward + backward, clip, AdamW, optional
microbatch accumulation, gradient compression and data parallelism over
a mesh — port of ``src/repro/train/step.py``.

The reference's step is a pure function that XLA compiles, its buffers
donated, and GSPMD inserts the data-parallel all-reduce from the
shardings of its inputs.  Here the weights live in the model and the
step updates them, and the optimizer's moments, in place; it returns its
metrics as device tensors and never waits on the host.  With a mesh the
step does what GSPMD does for a batch sharded over ``data`` and
replicated weights (the reference launcher's layout with ``model = 1``):

  * the batch (every key: ``tokens``, ``patch_embeds``, ``frames``) is
    cut along its leading axis as ``ShardingRules.batch_specs`` says,
    one shard a slot of the data axis; a batch the axis does not divide
    is replicated, as in the reference, and each distinct device runs
    it whole;
  * each distinct device holds one replica of the weights and moments
    (the model's own on its device, copies elsewhere); shards on one
    device share it;
  * every shard runs its forward on its device; the MoE routing
    fractions of every dispatch window are all-reduced before any
    backward, so each shard's loss carries the global Switch aux loss
    (its gradient flows through the shard's own mean router
    probabilities only, as in the single-device step); then each shard
    runs its backward;
  * the gradients are all-reduced (mean) across the data axis, the
    ``grad_transform`` runs on each device's copy, and each device runs
    one AdamW update of its replica.

So the step's numbers are the single-device step's up to the order of
fp32 sums.  Peak activation memory is the single-device step's too, not
1/n of it: every shard's forward is alive until the routing fractions
are reduced.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import torch
from torch import nn

from . import optimizer as opt
from ..distributed import actctx
from ..distributed.collectives import all_reduce_mean
from ..distributed.sharding import ShardingRules
from ..models import moe as MOE
from ..models.convert import ShapeLeaf
from ..models.transformer import AUX_WEIGHT

f32 = torch.float32


def make_train_step(model, opt_cfg: opt.OptConfig, *, accum_steps: int = 1,
                    remat: bool = True, accum_dtype=f32,
                    grad_transform: Optional[Callable] = None,
                    mesh=None) -> Callable:
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

    ``mesh`` (``launch.mesh.Mesh``, ``model`` axis 1): the data-parallel
    step of the module docstring.  With accumulation each microbatch is
    cut into the data shards, so microbatch i holds the same rows as on
    one device.  The model must lie on one of the mesh's devices; the
    replicas on the others are copied from it and from ``opt_state`` at
    the first call with a given ``opt_state`` object; the step's
    ``replicas`` maps each distinct device to its model.  The reference's
    ``grad_constraint`` (a sharding pin for FSDP) has no counterpart
    while every device holds full weights."""
    if isinstance(accum_dtype, str):
        accum_dtype = opt._DTYPES[accum_dtype]
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    names = list(params)
    dev = model.device
    if mesh is not None:
        return _data_parallel_step(model, opt_cfg, mesh, names, accum_steps,
                                   remat, accum_dtype, grad_transform)
    leaves = list(params.values())

    def loss_and_grads(batch):
        with MOE.collect_aux_stats() as stats:
            loss = model.loss(batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), _aux(stats, model, dev), dict(zip(names, grads))

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


def _replica(model: nn.Module, dev: torch.device) -> nn.Module:
    """A copy of ``model`` on ``dev`` whose parameters are trainable
    copies of the model's (each copied once, straight to ``dev``)."""
    memo = {id(p): nn.Parameter(p.detach().to(dev), requires_grad=True)
            for p in model.parameters()}
    return copy.deepcopy(model, memo).to(dev)


def _data_parallel_step(model, opt_cfg, mesh, names, accum_steps, remat,
                        accum_dtype, grad_transform):
    if mesh.shape.get("model", 1) != 1:
        raise ValueError(
            f"the port's train step runs data parallelism only (every "
            f"device a full replica); got a model axis of "
            f"{mesh.shape['model']}")
    rules = ShardingRules(model.cfg, mesh)
    primary = model.device
    devices = []
    for d in mesh.devices.flat:
        if d not in devices:
            devices.append(d)
    if primary not in devices:
        raise ValueError(f"the model lies on {primary}, which is not a "
                         f"device of {mesh}")
    devices.remove(primary)
    devices.insert(0, primary)
    held = {"opt_id": None, "models": {primary: model}, "opt": {}}

    def replicate(opt_state):
        """One replica a distinct device, copied from the model and
        ``opt_state`` (the primary's)."""
        held["opt"] = {primary: opt_state}
        for d in devices[1:]:
            held["models"][d] = _replica(model, d)
            held["opt"][d] = {
                "m": {k: t.to(d) for k, t in opt_state["m"].items()},
                "v": {k: t.to(d) for k, t in opt_state["v"].items()},
                "step": opt_state["step"].to(d)}
        held["opt_id"] = id(opt_state)

    def layout(b: int):
        """(the device of each batch shard, the split of the rows)."""
        spec = rules.batch_specs({"x": ShapeLeaf((b,))}, b)["x"]
        shard_devs = rules.shard_devices(spec)
        return shard_devs, (len(shard_devs) if spec[0] is not None else 1)

    def microbatch(mb, acc):
        """Forward every shard, all-reduce the routing fractions,
        backward every shard; add each shard's gradients into ``acc``
        (one dict a shard).  Returns (loss, aux) on the primary."""
        b = next(iter(mb.values())).shape[0]
        shard_devs, split = layout(b)
        n = len(shard_devs)
        outs = []
        for s, d in enumerate(shard_devs):
            lo, hi = (s * b // n, (s + 1) * b // n) if split > 1 else (0, b)
            part = {k: torch.as_tensor(v[lo:hi]).to(d) for k, v in mb.items()}
            with actctx.use(mesh, rules.dp), actctx.local_shard(split, d), \
                    MOE.collect_aux_stats() as stats:
                loss = held["models"][d].loss(part, remat=remat)
            outs.append((loss, stats))
        losses, aux = _global_aux(outs, split, model.cfg.num_experts)
        for s, d in enumerate(shard_devs):
            leaves = list(held["models"][d].parameters())
            grads = torch.autograd.grad(losses[s], leaves)
            for k, g in zip(names, grads):
                if k in acc[s]:
                    acc[s][k].add_(g)
                else:
                    acc[s][k] = (g if accum_steps == 1
                                 else g.to(accum_dtype, copy=True))
            del grads
        losses = [l.detach().to(primary) for l in losses[:split]]
        return sum(losses) / split, aux.to(primary)

    def train_step(opt_state: Dict, batch: Dict) -> Dict:
        if held["opt_id"] != id(opt_state):
            replicate(opt_state)
        b = next(iter(batch.values())).shape[0]
        shard_devs, split = layout(b // accum_steps)
        acc = [{} for _ in shard_devs]
        loss = aux = 0.0
        for mb in (_microbatches(batch, accum_steps) if accum_steps > 1
                   else [batch]):
            l, a = microbatch(mb, acc)
            loss, aux = loss + l, aux + a
        # the all-reduce across the data axis, leaf by leaf (each
        # shard's gradient freed once reduced); a replicated batch
        # leaves every device its own, equal, gradients
        grads = {d: {} for d in devices}
        for k in names:
            shards = [a.pop(k) for a in acc]
            if split > 1:
                shards = all_reduce_mean(shards)
            for d, g in dict(zip(shard_devs, shards)).items():
                grads[d][k] = g if accum_steps == 1 else g / accum_steps
        metrics = None
        for d in devices:
            g = grads.pop(d)
            if grad_transform is not None:
                g = grad_transform(g)
            _, _, m = opt.update(opt_cfg, g, held["opt"][d],
                                 dict(held["models"][d].named_parameters()))
            del g
            metrics = m if metrics is None else metrics
        metrics["loss"] = loss / accum_steps
        metrics["aux"] = aux / accum_steps
        return metrics

    train_step.replicas = held["models"]
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
