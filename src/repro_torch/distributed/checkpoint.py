"""Index checkpoints — the restart path after a failure (DESIGN.md §5).

Port of ``src/repro/distributed/checkpoint.py``: the index half
(``save_vectormaton``, ``load_checkpoint_meta``, ``load_vectormaton``)
and the train-state ``CheckpointManager``.  The on-disk formats are the
reference's to the letter — the same file names, array names, dtypes,
``config`` and ``delta_meta`` layouts and ``meta.json`` sidecar; for
train states the ``step_%010d`` directories, ``arrays.npz`` and
``manifest.json`` — so a checkpoint written by either package loads in
the other.

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
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import fsdp
from ..models.convert import (BF16_RAW, from_reference_state, to_numpy,
                              to_tensor)


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
    from ..core.trace import Trace
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
    vm.trace = Trace()
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


# --------------------------------------------------------------------- #
# train-state checkpoints
# --------------------------------------------------------------------- #

def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [rebuild(node[k]) for k in sorted(keys, key=int)]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _host(x) -> np.ndarray:
    """A host copy of one leaf: tensors (bf16 as raw ``|V2`` bytes, as
    the reference's bf16 arrays land in ``arrays.npz``) or arrays."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.array(x, copy=True)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == BF16_RAW else str(a.dtype)


class CheckpointManager:
    """Step-indexed train-state checkpoints with atomic commit, async
    save, retention, and resume-from-latest.  ``save`` takes a nested
    dict/list tree of tensors or numpy arrays (the reference's layout:
    ``convert.to_reference_state``); ``restore`` returns the tree with
    every leaf a tensor — bf16 where ``manifest.json`` says
    ``"bfloat16"``, whichever package wrote it.

    A data-parallel run (``train.step`` over a mesh) saves one replica,
    the one on the mesh's first device: every replica holds the same
    weights and moments, as the reference's replicated arrays are saved
    once.  An FSDP run saves whole leaves too, each gathered from its
    shards' owners (``convert.to_numpy``).  So the layout does not
    depend on the mesh, and a run on one device and a run over any data
    mesh, either placement, resume from each other's checkpoints:
    ``restore_train_state`` scatters every leaf into the shards of the
    model it resumes (the step copies the replicated leaves to its other
    devices at its next call)."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        # Copy every leaf to the host *before* handing off to the async
        # thread, so the train loop may overwrite its tensors in place.
        host_flat = {k: _host(v) for k, v in _flatten(tree).items()}
        if blocking:
            self._write(step, host_flat)
        else:
            self.wait()
            self._async_thread = threading.Thread(
                target=self._write, args=(step, host_flat), daemon=True)
            self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _write(self, step: int, host_flat: Dict[str, np.ndarray]) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "arrays": {}}
        np.savez(os.path.join(tmp, "arrays.npz"), **host_flat)
        for k, v in host_flat.items():
            manifest["arrays"][k] = {"shape": list(v.shape),
                                     "dtype": _dtype_name(v)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None) -> Any:
        """Load checkpoint ``step`` (default latest) as a tree of tensors
        on ``device`` (default the CPU).  ``device`` takes the place of
        the reference's ``sharding_tree``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = {k: v["dtype"]
                      for k, v in json.load(f)["arrays"].items()}
        flat = {}
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            for k in npz.files:
                a = npz[k]
                if dtypes[k] == "bfloat16":
                    a = a.view(BF16_RAW)
                t = to_tensor(a)
                flat[k] = t if device is None else t.to(device)
        return _unflatten(flat)

    def restore_train_state(self, model, step: Optional[int] = None):
        """Resume ``model`` (an ``LM`` or ``EncDec``, placed or not) from
        checkpoint ``step`` (default latest): its parameters are loaded
        in place — an FSDP-placed model's cut into its shards, over
        whatever data count it was placed on (``fsdp.load_whole``) — and
        its optimizer state is returned with every moment laid out as its
        parameter is (``fsdp.place_like``) and ``step`` on the model's
        device.  Returns (opt_state, the checkpoint's ``meta`` step)."""
        state = self.restore(step)
        sd, ostate = from_reference_state(model.cfg, state)
        fsdp.load_whole(model, sd)
        del sd
        params = dict(model.named_parameters())
        opt_state = {part: {k: fsdp.place_like(t, params[k])
                            for k, t in ostate[part].items()}
                     for part in ("m", "v")}
        opt_state["step"] = ostate["step"].to(model.device)
        return opt_state, int(state["meta"]["step"])


__all__ = ["save_vectormaton", "load_checkpoint_meta", "load_vectormaton",
           "CheckpointManager"]
