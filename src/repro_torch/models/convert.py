"""Carry the reference's weights across: ``from_reference_params(cfg,
params)`` turns a parameter pytree of ``repro.models`` (``LM.init`` or
``EncDec.init``; JAX, numpy or ``ml_dtypes`` arrays) into a state dict of
the port's ``LM`` / ``EncDec`` for ``load_state_dict``.

The reference stacks each layer stack along a leading axis; the port
holds one submodule per layer, so the conversion unstacks and converts,
and changes no tensor's per-layer shape.  bf16 arrays arrive as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: their bits
are copied exactly through ``uint16``.  Imports no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import ModelConfig


def to_tensor(a) -> torch.Tensor:
    """A host copy of one array with its exact bits and dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()
        ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, n: int):
    """A pytree of stacked arrays -> a list of n per-entry pytrees."""
    return [_map(tree, lambda a, i=i: a[i]) for i in range(n)]


def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            _flatten(v, name + ".", out)
        else:
            out[name] = to_tensor(v)


def _lm_tree(cfg: ModelConfig, params: Dict) -> Dict:
    tree = {k: v for k, v in params.items() if k != "layers"}
    lyr = params["layers"]
    if cfg.family == "ssm":
        tree["layers"] = _unstack(lyr, cfg.num_layers)
    elif cfg.attn_period:
        nb = cfg.num_layers // cfg.attn_period
        blocks = _unstack(lyr, nb)
        for blk in blocks:
            for sub in ("mamba", "mlp", "moe"):
                n = next(_leaves(blk[sub])).shape[0]
                blk[sub] = _unstack(blk[sub], n)
        tree["layers"] = blocks
    else:
        tree["layers"] = _unstack(lyr, cfg.num_layers)
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def from_reference_params(cfg: ModelConfig, params: Dict
                          ) -> Dict[str, torch.Tensor]:
    """The reference's parameter pytree for ``cfg`` -> the port's state
    dict (CPU tensors; ``load_state_dict`` copies them to the module's
    device)."""
    params = _map(params, np.asarray)
    if cfg.is_encoder_decoder:
        tree = dict(params)
        tree["enc_layers"] = _unstack(params["enc_layers"],
                                      cfg.num_encoder_layers)
        tree["dec_layers"] = _unstack(params["dec_layers"], cfg.num_layers)
    else:
        tree = _lm_tree(cfg, params)
    out: Dict[str, torch.Tensor] = {}
    _flatten(tree, "", out)
    return out


__all__ = ["from_reference_params", "to_tensor"]
