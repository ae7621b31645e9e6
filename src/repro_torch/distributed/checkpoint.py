"""Index checkpoints — the restart path after a failure (DESIGN.md §5).

Port of the index half of ``src/repro/distributed/checkpoint.py``
(``save_vectormaton``, ``load_checkpoint_meta``, ``load_vectormaton``).
The on-disk format is the reference's to the letter — the same file
names, array names, dtypes, ``config`` and ``delta_meta`` layouts and
``meta.json`` sidecar — so a checkpoint written by either package loads
in the other.  The train-state ``CheckpointManager`` waits for the LM
stack (ROADMAP Queue 1, "training").

An index checkpoint holds the ESAM struct-of-arrays, the per-state index
descriptors and the vector table.  It restores without any index
rebuild.  A checkpoint taken mid-churn is complete by construction: the
write path patches the build-side state indexes and vector table as
inserts land (only the packed runtime is deferred), so the saved arrays
embed the delta and pending tombstones round-trip via ``deleted``.
Restore therefore lands on a fresh generation — a free compaction point —
with delta/compaction counters carried across via ``delta_meta`` so
generation numbering keeps advancing monotonically.

Atomicity: everything is written into ``<dir>.tmp`` then ``os.replace``d,
so a crash mid-save never corrupts the latest good checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Dict, List, Optional

import numpy as np


def save_vectormaton(vm, path: str,
                     extra_meta: Optional[Dict] = None) -> None:
    from ..core.vectormaton import _RAW
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    if extra_meta is not None:
        # caller-owned sidecar (e.g. the replication watermark a rejoining
        # replica replays from, DESIGN.md §10).  Written inside the tmp
        # dir so the atomic rename commits checkpoint + meta together.
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(extra_meta, f)
    np.savez_compressed(os.path.join(tmp, "esam.npz"),
                        **{k: v for k, v in vm.esam.to_arrays().items()})
    np.save(os.path.join(tmp, "vectors.npy"), vm.vectors)
    # original sequences: required for LIKE residual verification after a
    # restore (predicates re-compile against the restored runtime)
    np.save(os.path.join(tmp, "sequences.npy"),
            np.asarray(list(getattr(vm, "sequences", [])), dtype=object),
            allow_pickle=True)
    # per-record attributes + typed schema: restored predicates on Tag /
    # Range leaves re-derive the sorted attribute segments at rebuild
    attrs = list(getattr(vm, "attributes", []))
    if any(attrs) or getattr(vm.config, "schema", None):
        np.save(os.path.join(tmp, "attributes.npy"),
                np.asarray(attrs, dtype=object), allow_pickle=True)
    # state indexes: raw sets into one CSR; graphs into per-state npz
    raw_ptr = [0]
    raw_data: List[np.ndarray] = []
    kinds = np.full(len(vm.state_index), -1, dtype=np.int8)
    graph_states = []
    for u, idx in enumerate(vm.state_index):
        if idx is None:
            raw_ptr.append(raw_ptr[-1])
            continue
        if idx.kind == _RAW:
            kinds[u] = 0
            raw_data.append(idx.raw_ids)
            raw_ptr.append(raw_ptr[-1] + len(idx.raw_ids))
        else:
            kinds[u] = 1
            raw_ptr.append(raw_ptr[-1])
            graph_states.append(u)
            np.savez_compressed(os.path.join(tmp, f"graph_{u}.npz"),
                                **idx.graph.pack_full())
    np.savez_compressed(
        os.path.join(tmp, "states.npz"),
        kinds=kinds,
        inherit=np.asarray(vm.inherit, dtype=np.int64),
        raw_ptr=np.asarray(raw_ptr, dtype=np.int64),
        raw_data=(np.concatenate(raw_data) if raw_data
                  else np.empty(0, np.int64)),
        deleted=np.asarray(sorted(vm.deleted), dtype=np.int64),
        graph_states=np.asarray(graph_states, dtype=np.int64),
        schema=np.asarray(json.dumps(getattr(vm.config, "schema", None)
                                     or {})),
        config=np.asarray([vm.config.T, vm.config.M, vm.config.ef_con,
                           0 if vm.config.metric == "l2" else 1,
                           int(vm.config.reuse), int(vm.config.skip_build),
                           vm.config.seed,
                           0 if getattr(vm.config, "quantize", "none")
                           == "none" else 1,
                           getattr(vm.config, "compact_min_inserts", 256),
                           int(getattr(vm.config, "compact_ratio", 0.25)
                               * 10_000),
                           int(getattr(vm.config, "auto_compact", True))],
                          dtype=np.int64),
        # write-path counters: [generation, delta pending at save,
        # delta version, compactions, runtime builds].  The saved index
        # arrays already embed the delta's inserts (state indexes are
        # patched online), so restore folds them into a fresh generation:
        # generation / compactions / runtime builds round-trip; pending
        # and version are save-time observability only (what was in
        # flight when the checkpoint was cut), never restored
        delta_meta=np.asarray(
            [vm._runtime.generation if vm._runtime is not None else -1,
             vm._runtime.delta.pending if vm._runtime is not None else 0,
             vm._runtime.delta.version if vm._runtime is not None else 0,
             getattr(vm, "n_compactions", 0),
             getattr(vm, "runtime_builds", 0)], dtype=np.int64))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_checkpoint_meta(path: str) -> Dict:
    """The ``extra_meta`` sidecar a checkpoint was saved with ({} for
    checkpoints written without one)."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _saved_config(states, base):
    """``base`` with the index parameters the checkpoint recorded."""
    c = states["config"]
    cfg = dataclasses.replace(
        base, T=int(c[0]), M=int(c[1]), ef_con=int(c[2]),
        metric="l2" if c[3] == 0 else "ip", reuse=bool(c[4]),
        skip_build=bool(c[5]), seed=int(c[6]),
        quantize="sq8" if len(c) > 7 and c[7] == 1 else "none")
    if len(c) > 10:            # write-path knobs (older checkpoints lack)
        cfg.compact_min_inserts = int(c[8])
        cfg.compact_ratio = float(c[9]) / 10_000
        cfg.auto_compact = bool(c[10])
    if "schema" in states:     # typed attribute schema (older lack it)
        cfg.schema = json.loads(str(states["schema"])) or None
    return cfg


def load_vectormaton(cls, path: str, config=None, device: str = "cuda"):
    """Restore the index checkpointed at ``path`` (written by this
    package or by the reference) as a ``cls`` instance.

    The index parameters (T, M, ef_con, metric, reuse, skip_build, seed,
    quantize, the compaction knobs and the schema) come from the
    checkpoint; ``config`` supplies the rest (backend, accum, plan mode)
    and ``device`` where the torch backend runs."""
    from ..core.esam import ESAM
    from ..core.hnsw import HNSW
    from ..core.planner import AdaptivePlanner
    from ..core.vectormaton import (VectorMatonConfig, _HNSW, _RAW,
                                    _StateIndex, check_config)
    states = np.load(os.path.join(path, "states.npz"))
    config = _saved_config(states, dataclasses.replace(
        config or VectorMatonConfig(), device=device))
    check_config(config)
    vm = cls.__new__(cls)
    vm.config = config
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
    # fresh adaptive planner (cost-model EWMAs are host-local runtime
    # measurements — deliberately not persisted; calibration defaults
    # re-seed it and feedback re-accumulates on the restored host)
    vm.planner = AdaptivePlanner(config.plan_mode)
    # write-path counters: resume generation numbering past the saved one
    # (the restored runtime is a fresh generation — the saved delta's
    # inserts are already embedded in the state indexes / vector table)
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
    # Re-apply tombstones into every per-state graph whose base contains a
    # deleted id.  Graphs persist their own deleted sets, but a checkpoint
    # written by an older saver may carry the global set only — the union
    # is idempotent and restores the invariant that graph searches skip
    # tombstones in-scan.
    if vm.deleted:
        for idx in vm.state_index:
            if idx is not None and idx.kind == _HNSW:
                for vid in vm.deleted & set(int(x) for x in idx.graph.ids):
                    idx.graph.mark_deleted(vid)
    # restored indexes flatten straight back into the packed query
    # runtime — no rebuild; the rebuilt runtime re-derives the device
    # tombstone mask from vm.deleted at to_device() time
    vm._refresh_runtime()
    return vm


__all__ = ["save_vectormaton", "load_checkpoint_meta", "load_vectormaton"]
