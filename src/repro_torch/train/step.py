"""Train-step builder: forward + backward, clip, AdamW, optional
microbatch accumulation and gradient compression — port of
``src/repro/train/step.py``.

The reference's step is a pure function that XLA compiles, its buffers
donated.  Here the weights live in the model and the step updates them,
and the optimizer's moments, in place; it returns its metrics as device
tensors and never waits on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import optimizer as opt

f32 = torch.float32


def make_train_step(model, opt_cfg: opt.OptConfig, *, accum_steps: int = 1,
                    remat: bool = True, accum_dtype=f32,
                    grad_transform: Optional[Callable] = None) -> Callable:
    """``train_step(opt_state, batch) -> metrics`` for ``model`` (an
    ``LM`` or ``EncDec``), whose parameters become trainable here.

    ``batch``: the ``TokenPipeline`` dict (numpy arrays or tensors);
    with ``accum_steps`` > 1 it is split along its leading axis into
    that many microbatches, whose gradients accumulate in
    ``accum_dtype`` and are averaged.  ``grad_transform``: optional hook
    applied to the mean gradients (a mapping of names to tensors), e.g.
    ``distributed.collectives.compress_decompress``.  ``metrics``:
    ``loss``, ``grad_norm`` and ``lr``, device scalars.  The reference's
    ``grad_constraint`` (a sharding pin) has no counterpart on one
    device."""
    if isinstance(accum_dtype, str):
        accum_dtype = opt._DTYPES[accum_dtype]
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    leaves = list(params.values())
    dev = model.device

    def loss_and_grads(batch):
        loss = model.loss(batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(params, grads))

    def train_step(opt_state: Dict, batch: Dict) -> Dict:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if accum_steps == 1:
            loss, grads = loss_and_grads(batch)
        else:
            # microbatches over the leading batch axis: peak activation
            # memory at 1/accum of the full batch
            loss = torch.zeros((), dtype=f32, device=dev)
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype, device=dev)
                     for k, p in params.items()}
            for i in range(accum_steps):
                mb = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = loss_and_grads(mb)
                loss = loss + l
                for k, acc in grads.items():
                    acc.add_(g[k])
                del g
            loss = loss / accum_steps
            grads = {k: g / accum_steps for k, g in grads.items()}
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, _, metrics = opt.update(opt_cfg, grads, opt_state, params)
        metrics["loss"] = loss
        return metrics

    return train_step


__all__ = ["make_train_step"]
