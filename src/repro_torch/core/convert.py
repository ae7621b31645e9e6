"""Carry a reference index across: read a ``repro`` checkpoint directory.

``from_reference_checkpoint`` reads, with numpy alone, the directory that
``repro.distributed.checkpoint.save_vectormaton`` writes — ``esam.npz``,
``vectors.npy``, ``sequences.npy``, ``attributes.npy`` (when present),
``states.npz`` and one ``graph_<state>.npz`` per graph state — and
rebuilds it the way ``load_vectormaton`` does, through ``ESAM.from_arrays``
and ``HNSW.from_packed``.  The result is a port ``VectorMaton`` whose
index is the reference's own: the same automaton, the same graphs, the
same tombstones, answered by the port's executor.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Optional

import numpy as np

from .esam import ESAM
from .hnsw import HNSW
from .planner import AdaptivePlanner
from .vectormaton import (_HNSW, _RAW, VectorMaton, VectorMatonConfig,
                          _StateIndex, check_config)


def _saved_config(states, base: VectorMatonConfig) -> VectorMatonConfig:
    """``base`` with the index parameters the checkpoint recorded."""
    c = states["config"]
    cfg = dataclasses.replace(
        base, T=int(c[0]), M=int(c[1]), ef_con=int(c[2]),
        metric="l2" if c[3] == 0 else "ip", reuse=bool(c[4]),
        skip_build=bool(c[5]), seed=int(c[6]))
    if len(c) > 7:
        cfg.quantize = "sq8" if c[7] == 1 else "none"
    if len(c) > 10:            # write-path knobs (older checkpoints lack)
        cfg.compact_min_inserts = int(c[8])
        cfg.compact_ratio = float(c[9]) / 10_000
        cfg.auto_compact = bool(c[10])
    if "schema" in states:     # typed attribute schema (older lack it)
        cfg.schema = json.loads(str(states["schema"])) or None
    return cfg


def from_reference_checkpoint(path: str,
                              config: Optional[VectorMatonConfig] = None,
                              device: str = "cuda") -> VectorMaton:
    """Load the reference checkpoint at ``path`` into a port index.

    The index parameters (T, M, ef_con, metric, reuse, skip_build, seed,
    quantize, the compaction knobs and the schema) come from the
    checkpoint; ``config`` supplies the rest (backend, accum, plan mode)
    and ``device`` where the torch backend runs."""
    states = np.load(os.path.join(path, "states.npz"))
    base = dataclasses.replace(config or VectorMatonConfig(), device=device)
    cfg = _saved_config(states, base)
    check_config(cfg)
    vm = VectorMaton.__new__(VectorMaton)
    vm.config = cfg
    vm.vectors = np.load(os.path.join(path, "vectors.npy"))
    seq_path = os.path.join(path, "sequences.npy")
    vm.sequences = (np.load(seq_path, allow_pickle=True).tolist()
                    if os.path.exists(seq_path) else [])
    attr_path = os.path.join(path, "attributes.npy")
    vm.attributes = (np.load(attr_path, allow_pickle=True).tolist()
                     if os.path.exists(attr_path)
                     else [{} for _ in vm.sequences])
    vm.attributes.extend({} for _ in range(
        len(vm.sequences) - len(vm.attributes)))
    vm.esam = ESAM.from_arrays(dict(np.load(
        os.path.join(path, "esam.npz"), allow_pickle=True)))
    vm.esam.finalize()
    vm.inherit = states["inherit"].tolist()
    vm.deleted = set(int(x) for x in states["deleted"])
    vm._lock = threading.Lock()
    vm._compact_lock = threading.Lock()
    vm.planner = AdaptivePlanner(cfg.plan_mode)
    meta = states["delta_meta"] if "delta_meta" in states else None
    vm._gen_seq = int(meta[0]) + 1 if meta is not None else 0
    vm.n_compactions = int(meta[3]) if meta is not None else 0
    vm.runtime_builds = int(meta[4]) if meta is not None else 0
    kinds, raw_ptr, raw_data = (states["kinds"], states["raw_ptr"],
                                states["raw_data"])
    vm.state_index = []
    for u in range(len(kinds)):
        if kinds[u] == -1:
            vm.state_index.append(None)
        elif kinds[u] == 0:
            vm.state_index.append(_StateIndex(
                _RAW, raw_ids=raw_data[raw_ptr[u]:raw_ptr[u + 1]].copy()))
        else:
            g = HNSW.from_packed(vm.vectors, dict(np.load(
                os.path.join(path, f"graph_{u}.npz"))))
            vm.state_index.append(_StateIndex(_HNSW, graph=g))
    if vm.deleted:               # graphs skip tombstones in-scan
        for idx in vm.state_index:
            if idx is not None and idx.kind == _HNSW:
                for vid in vm.deleted & set(int(x) for x in idx.graph.ids):
                    idx.graph.mark_deleted(vid)
    vm._refresh_runtime()
    return vm


__all__ = ["from_reference_checkpoint"]
