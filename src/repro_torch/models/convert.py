"""Carry weights and train states between the packages.

``from_reference_params(cfg, params)`` turns a parameter pytree of
``repro.models`` (``LM.init`` or ``EncDec.init``; JAX, numpy or
``ml_dtypes`` arrays) into a state dict of the port's ``LM`` /
``EncDec`` for ``load_state_dict``; ``to_reference_params(cfg, sd)`` is
its inverse, a nested dict of numpy arrays in the reference's layout.
``from_reference_state`` / ``to_reference_state`` do the same for a
whole train state ``{"params", "opt": {"m", "v", "step"}}``, whose
moments have the parameters' shapes.

The reference stacks each layer stack along a leading axis; the port
holds one submodule per layer, so the conversion unstacks (or stacks)
and changes no tensor's per-layer shape.  numpy has no bfloat16 of its
own: bf16 arrives as ``ml_dtypes.bfloat16`` or as the raw 2-byte
``|V2`` that a reference checkpoint restores to, and leaves as ``|V2``
(``.view(ml_dtypes.bfloat16)`` gives the reference's dtype); the bits
are copied exactly.  The parameters and moments of an FSDP-placed
model are shards (``distributed.fsdp``): ``to_numpy``, and so
``to_reference_params`` and ``to_reference_state``, gather each into
its whole leaf (pass ``dict(model.named_parameters())``, whose tensors
carry their shards; ``state_dict()`` detaches them).  Imports no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import ModelConfig
from ..distributed import fsdp


BF16_RAW = np.dtype("V2")      # a bf16 array's bytes, as numpy holds them


def _array(a):
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def to_tensor(a) -> torch.Tensor:
    """A copy of one array with its exact bits and dtype
    (``ml_dtypes.bfloat16`` and raw ``|V2`` arrays are bf16); a tensor
    is copied where it lies."""
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_RAW:
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()
        ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of one tensor; bf16 becomes raw ``|V2`` bytes.  An
    FSDP shard (``distributed.fsdp``) is gathered: the copy is its whole
    leaf."""
    t = fsdp.whole(t, "cpu").detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RAW).copy()
    return t.numpy().copy()


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
    """The reference's parameter pytree for ``cfg`` (arrays, or tensors
    as ``CheckpointManager.restore`` gives them) -> the port's state
    dict (CPU tensors from arrays, tensors where they lay;
    ``load_state_dict`` copies them to the module's device)."""
    params = _map(params, _array)
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


def _nest(sd: Dict[str, torch.Tensor], leaf=to_numpy) -> Dict:
    """``{"layers.3.attn.wq": t}`` -> nested dicts and lists of
    ``leaf(t)``, numpy arrays by default (the inverse of ``_flatten``)."""
    root: Dict = {}
    for name, t in sd.items():
        node = root
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf(t)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


class ShapeLeaf:
    """A leaf of ``reference_shapes``: a ``shape`` and, where known, a
    torch ``dtype`` (the counterpart of ``jax.ShapeDtypeStruct``)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype=None):
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self) -> str:
        return f"ShapeLeaf({self.shape}, {self.dtype})"


def _stack(entries):
    """A list of per-entry pytrees -> one pytree of stacked arrays (or
    of stacked ``ShapeLeaf`` shapes)."""
    first = entries[0]
    if isinstance(first, dict):
        return {k: _stack([e[k] for e in entries]) for k in first}
    if isinstance(first, ShapeLeaf):
        return ShapeLeaf((len(entries),) + first.shape, first.dtype)
    return np.stack(entries)


def _stack_layers(cfg: ModelConfig, tree: Dict) -> Dict:
    """A nested per-layer tree -> the reference's stacked layout."""
    if cfg.is_encoder_decoder:
        tree["enc_layers"] = _stack(tree["enc_layers"])
        tree["dec_layers"] = _stack(tree["dec_layers"])
        return tree
    if cfg.attn_period:
        for blk in tree["layers"]:
            for sub in ("mamba", "mlp", "moe"):
                blk[sub] = _stack(blk[sub])
    tree["layers"] = _stack(tree["layers"])
    return tree


def to_reference_params(cfg: ModelConfig, sd: Dict[str, torch.Tensor]
                        ) -> Dict:
    """The port's state dict (or any mapping of the parameters' names
    to tensors of their shapes, such as an AdamW moment) -> the
    reference's parameter pytree for ``cfg``: nested dicts of numpy
    arrays, each layer stack stacked along a leading axis."""
    return _stack_layers(cfg, _nest(sd))


def reference_shapes(cfg: ModelConfig, sd: Dict[str, torch.Tensor]
                     ) -> Dict:
    """``to_reference_params``' tree with ``ShapeLeaf`` leaves in place
    of arrays: the reference's leaf shapes, no tensor copied (what
    ``distributed.sharding.ShardingRules.param_specs`` reads)."""
    return _stack_layers(cfg, _nest(
        sd, leaf=lambda t: ShapeLeaf(t.shape, getattr(t, "dtype", None))))


def from_reference_state(cfg: ModelConfig, state: Dict):
    """A reference train state ``{"params", "opt": {"m", "v", "step"}}``
    (as ``repro``'s ``opt.init`` / ``make_train_step`` keep it, or as a
    checkpoint restores it) -> (state dict, the port's optimizer state
    ``{"m", "v", "step"}`` with ``step`` an int32 tensor).  Arrays become
    CPU tensors; tensors stay on their device."""
    opt = state["opt"]
    step = opt["step"]
    return (from_reference_params(cfg, state["params"]),
            {"m": from_reference_params(cfg, opt["m"]),
             "v": from_reference_params(cfg, opt["v"]),
             "step": (step.to(torch.int32) if isinstance(step, torch.Tensor)
                      else torch.as_tensor(np.asarray(step),
                                           dtype=torch.int32))})


def to_reference_state(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                       opt_state: Dict) -> Dict:
    """The port's parameters (name -> tensor) and optimizer state -> the
    reference's train state ``{"params", "opt": {"m", "v", "step"}}`` as
    numpy (``step`` an int32 scalar)."""
    return {"params": to_reference_params(cfg, params),
            "opt": {"m": to_reference_params(cfg, opt_state["m"]),
                    "v": to_reference_params(cfg, opt_state["v"]),
                    "step": np.asarray(int(opt_state["step"]),
                                       dtype=np.int32)}}


__all__ = ["from_reference_params", "to_reference_params",
           "from_reference_state", "to_reference_state", "to_tensor",
           "to_numpy", "BF16_RAW", "reference_shapes", "ShapeLeaf"]
