"""Sharding rules — DP/FSDP/TP/EP/SP spec tables for every arch and shape.
Port of ``src/repro/distributed/sharding.py`` without JAX.

Strategy (the reference's, DESIGN.md §5):
  * TP over `model`: attention heads, FFN hidden, experts (EP), SSD
    heads, vocab;
  * FSDP over `data`: the non-TP dimension of every ≥2-D weight;
  * DP over (`pod`, `data`): batch;
  * SP: decode KV caches shard their sequence axis over `model`;
    batch-1 long-context shards sequence over (`data`, `model`).

Every rule degrades gracefully: an axis is sharded only when its size
divides the mesh axis; otherwise it stays replicated.

A spec is a ``P``: a tuple with one entry per array axis, each ``None``
(replicated), a mesh axis name, or a tuple of names — what
``jax.sharding.PartitionSpec`` holds.  Spec trees mirror the shape trees
they are computed from: nested dicts (and lists) in the reference's
layout, whose leaves are anything with a ``.shape`` (tensors, arrays,
``convert.reference_shapes``' leaves); a leaf's rule is chosen by the
last dict key on its path, as the reference's ``DictKey`` lookup does.
The mesh is anything with a ``shape`` mapping of axis sizes and
``axis_names``: ``launch.mesh.Mesh`` here.

The data-parallel train step (``train.step``) splits the batch by
``batch_specs``; with ``placement="fsdp"`` it also places the
parameters and moments by ``param_specs`` / ``opt_specs`` and gathers
each layer along the axis ``gathered_rule`` releases
(``distributed.fsdp``).  The dry run (``launch.dryrun``) reckons
per-device state bytes from the same tables on any layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..launch.mesh import axis_size, dp_axes
from ..models.config import ModelConfig

TP = "model"


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``.
    A tuple of one name is held as that name, as ``PartitionSpec``
    holds it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def map_with_path(fn, tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over a nested dict / list tree, the path a
    tuple of the dict keys and list indices above the leaf (the
    counterpart of ``jax.tree_util.tree_map_with_path``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_name(path: Tuple) -> str:
    """The last dict key on the path (list indices are not names)."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


class ShardingRules:
    """Builds spec trees for params / optimizer / batches / caches of
    one (arch, mesh) pair."""

    def __init__(self, cfg: ModelConfig, mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.tp = mesh.shape[TP]
        self.dp = dp_axes(mesh)
        self.dp_size = axis_size(mesh, self.dp)
        # FSDP spans the full DP group (pod × data on multi-pod meshes)
        self.fsdp = self.dp if len(self.dp) > 1 else self.dp[0]
        self.fsdp_size = self.dp_size

    # ------------------------------------------------------------------ #
    def _tp_if(self, dim: int) -> Optional[str]:
        return TP if _div(dim, self.tp) else None

    def _fsdp_if(self, dim: int):
        return self.fsdp if _div(dim, self.fsdp_size) else None

    def _param_rule(self, name: str, shape: Tuple[int, ...]) -> P:
        cfg = self.cfg
        nd = len(shape)

        def pad(tail):
            return P(*((None,) * (nd - len(tail)) + tuple(tail)))

        if name in ("embed",):
            return P(self._tp_if(shape[0]), None)
        if name in ("lm_head",):
            return P(None, self._tp_if(shape[1]))
        if name in ("wq",):
            return pad([self._fsdp_if(shape[-3]), self._tp_if(shape[-2]),
                        None])
        if name in ("wk", "wv"):
            return pad([self._fsdp_if(shape[-3]), None, None])
        if name in ("wo",):
            return pad([self._tp_if(shape[-3]), None,
                        self._fsdp_if(shape[-1])])
        if name in ("w_gate", "w_up"):
            if nd >= 3 and cfg.num_experts and shape[-3] == cfg.num_experts:
                return pad([self._tp_if(shape[-3]),
                            self._fsdp_if(shape[-2]), None])
            return pad([self._fsdp_if(shape[-2]), self._tp_if(shape[-1])])
        if name == "w_down":
            if nd >= 3 and cfg.num_experts and shape[-3] == cfg.num_experts:
                return pad([self._tp_if(shape[-3]), None,
                            self._fsdp_if(shape[-1])])
            return pad([self._tp_if(shape[-2]), self._fsdp_if(shape[-1])])
        if name in ("w_in",):
            return pad([self._fsdp_if(shape[-2]), self._tp_if(shape[-1])])
        if name in ("w_out",):
            return pad([self._tp_if(shape[-2]), self._fsdp_if(shape[-1])])
        if name in ("z_proj", "x_proj", "b_proj", "c_proj", "dt_proj"):
            return pad([self._fsdp_if(shape[-2]), self._tp_if(shape[-1])])
        if name == "out_proj":
            return pad([self._tp_if(shape[-2]), self._fsdp_if(shape[-1])])
        if name.startswith("conv_") and name.endswith("_w"):
            return pad([None, self._tp_if(shape[-1])])
        if name.startswith("conv_") and name.endswith("_b"):
            return pad([self._tp_if(shape[-1])])
        if name in ("A_log", "D", "dt_bias"):
            return pad([self._tp_if(shape[-1])])
        # norms, routers, biases: replicated
        return P(*((None,) * nd))

    def gathered_rule(self, name: str, shape: Tuple[int, ...]) -> P:
        """The per-layer spec *after* the explicit FSDP gather: FSDP axes
        replaced by replication, TP axes kept."""
        base = self._param_rule(name, shape)
        fsdp = self.fsdp

        def drop(entry):
            if entry is None:
                return None
            if entry == fsdp:
                return None
            if isinstance(entry, tuple) and isinstance(fsdp, tuple) \
                    and set(entry) == set(fsdp):
                return None
            return entry
        return P(*(drop(e) for e in base))

    # ------------------------------------------------------------------ #
    def param_specs(self, params_shape: Any) -> Any:
        """Spec tree matching a (shape-only) param tree in the
        reference's layout."""
        return map_with_path(
            lambda path, leaf: self._param_rule(_leaf_name(path),
                                                tuple(leaf.shape)),
            params_shape)

    # ------------------------------------------------------------------ #
    def batch_specs(self, batch_shape: Dict[str, Any], batch_size: int
                    ) -> Dict[str, Any]:
        """Every leaf's leading axis over DP when ``batch_size`` divides
        the DP group, else over ``data`` when it divides that, else
        replicated."""
        dp = self.dp if _div(batch_size, self.dp_size) else (
            "data" if _div(batch_size, self.fsdp_size) else None)

        def rule(path, leaf):
            nd = len(leaf.shape)
            if nd == 0:
                return P()
            return P(*((dp,) + (None,) * (nd - 1)))
        return map_with_path(rule, batch_shape)

    # ------------------------------------------------------------------ #
    def cache_specs(self, cache_shape: Any, batch_size: int) -> Any:
        """Decode-cache specs.  KV caches: (..., B, S, G, hd) — batch
        over DP when divisible, else sequence over (data, model) (SP for
        the batch-1 long-context shape).  SSM states: (..., B, H, P, N)
        — heads over TP."""
        batch_dp = self.dp if _div(batch_size, self.dp_size) else None

        def rule(path, leaf):
            name = _leaf_name(path)
            shape = tuple(leaf.shape)
            nd = len(shape)

            def pad(tail):
                return P(*((None,) * (nd - len(tail)) + tuple(tail)))

            if name in ("k", "v"):                     # (..., B, S, G, hd)
                seq = shape[-3]
                if batch_dp is not None:
                    return pad([batch_dp, self._tp_if(seq), None, None])
                if _div(seq, axis_size(self.mesh, ("data", TP))):
                    return pad([None, ("data", TP), None, None])
                return pad([None, self._tp_if(seq), None, None])
            if name == "ssm":                          # (..., B, H, P, N)
                return pad([batch_dp, self._tp_if(shape[-3]), None, None])
            if name.startswith("conv"):                # (..., B, K-1, C)
                return pad([batch_dp, None, self._tp_if(shape[-1])])
            return P(*((None,) * nd))
        return map_with_path(rule, cache_shape)

    # ------------------------------------------------------------------ #
    def opt_specs(self, params_shape: Any) -> Any:
        """Adam moments share the param specs; scalars replicated."""
        pspecs = self.param_specs(params_shape)
        return {"m": pspecs, "v": pspecs, "step": P()}

    def shard_devices(self, spec: P):
        """The device of each shard of an array placed by ``spec``: a
        list over the entries of the spec's leading axis (the batch
        shards of ``batch_specs``), one device each; a replicated
        leading axis gives each distinct device of the mesh once."""
        lead = spec[0] if len(spec) else None
        if lead is None:
            seen = []
            for d in self.mesh.devices.flat:
                if d not in seen:
                    seen.append(d)
            return seen
        axes = (lead,) if isinstance(lead, str) else tuple(lead)
        grid = self.mesh.devices
        names = list(self.mesh.axis_names)
        # the other axes replicate: take their first index
        order = [names.index(a) for a in axes] + [
            i for i, a in enumerate(names) if a not in axes]
        grid = grid.transpose(order)
        n = axis_size(self.mesh, axes)
        return [grid.reshape((n, -1))[s, 0] for s in range(n)]


__all__ = ["ShardingRules", "P", "TP", "map_with_path"]
