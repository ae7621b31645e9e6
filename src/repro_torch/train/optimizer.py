"""AdamW with global-norm clipping and cosine schedule — port of
``src/repro/train/optimizer.py``.

Numerics: params may live in bf16; moments are fp32 (``moment_dtype``)
and the update math is fp32, the step an int32 device tensor and the
learning rate and bias corrections fp32 device scalars, so nothing
waits on the host; the parameter-dtype cast comes last.

Parameters, gradients and moments are mappings of the parameters'
names to tensors (``dict(model.named_parameters())``).  ``update``
works leaf by leaf with the clip scale fused in and writes the
parameters and moments in place (the PyTorch counterpart of the
reference's buffer donation): its fp32 temporaries never exceed one
leaf's, where a whole-tree update would hold an fp32 copy of the model.

Under FSDP and tensor-parallel placement (``distributed.fsdp``) a
parameter may be one shard of a leaf cut over the data and model axes:
``init`` gives it moments of every distinct shard, linked the same way, and ``update`` takes the
global gradient norm from the step, which alone sees every shard.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..distributed import fsdp

f32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # Moment storage dtype; the update math stays fp32.
    moment_dtype: str = "float32"


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to
    ``min_lr_ratio · lr`` at ``total_steps``; fp32, on ``step``'s
    device (an int or an int tensor)."""
    step = torch.as_tensor(step).to(f32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Mapping[str, torch.Tensor], moment_dtype=f32) -> Dict:
    """Zero moments of the parameters' shapes, on their devices, and
    ``step`` = 0 (int32, on the first parameter's device).  The moments
    of a shard are zeros of every distinct shard of its group, linked as
    the parameter's shards are."""
    if isinstance(moment_dtype, str):
        moment_dtype = _DTYPES[moment_dtype]

    def zeros(p):
        return fsdp.like(p, lambda s, _: torch.zeros(
            s.shape, dtype=moment_dtype, device=s.device))
    dev = next(iter(params.values())).device
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (one reduction
    a leaf, no fp32 copy of it)."""
    return torch.sqrt(torch.stack([
        torch.linalg.vector_norm(g, dtype=f32).square()
        for g in tree.values()]).sum())


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g.to(f32) * scale for k, g in grads.items()}, norm


@torch.no_grad()
def update(cfg: OptConfig, grads: Mapping[str, torch.Tensor],
           opt_state: Dict, params: Mapping[str, torch.Tensor],
           gnorm: Optional[torch.Tensor] = None
           ) -> Tuple[Mapping[str, torch.Tensor], Dict, Dict]:
    """One AdamW step: returns (params, opt_state, metrics), the first
    two the objects passed in, updated in place (``step`` too).
    ``metrics``: ``grad_norm`` (before clipping) and ``lr``, device
    scalars.  Weight decay applies to every leaf, as in the
    reference.  ``gnorm``: the global norm of the whole gradient, where
    ``grads`` is one device's part of it (FSDP shards); by default the
    norm of ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    opt_state["step"].add_(1)
    step = opt_state["step"].to(f32)
    lr = lr_schedule(cfg, opt_state["step"])
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    for k, p in params.items():
        g = grads[k].to(f32) * scale
        m, v = opt_state["m"][k], opt_state["v"][k]
        mf = m.to(f32, copy=m.dtype != f32)   # m itself when fp32
        vf = v.to(f32, copy=v.dtype != f32)
        mf.mul_(b1).add_(g, alpha=1 - b1)
        vf.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (mf / bc1).div_(torch.sqrt(vf / bc2).add_(cfg.eps))
        upd.add_(p, alpha=cfg.weight_decay).mul_(lr)
        p.copy_(torch.sub(p.to(f32), upd, out=upd))
        if mf is not m:
            m.copy_(mf)
            v.copy_(vf)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


__all__ = ["OptConfig", "lr_schedule", "init", "global_norm",
           "clip_by_global_norm", "update"]
