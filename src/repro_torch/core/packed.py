"""Packed query runtime — the planner/executor substrate (DESIGN.md §3).

Port of ``src/repro/core/packed.py``.  The host half (``VectorStore``,
``DeltaRuntime``, ``plan``, ``chain_cover``, ``_gather_work``,
``_assemble_scan_batch``, ``_merge_fetch``, the residual loop and the
staleness checks) is the reference's, verbatim.  The device half runs on
PyTorch tensors on ``PackedRuntime.device`` (backend ``"torch"``; the
reference's ``"jax"``): the resident table, CSR and tombstone mask, the
scan launches (kernel A / kernel B through ``kernels.ops`` and
``kernels.quant``), the batched beam (``hnsw_torch``), the residual
distance matrix and the device merge.  ``dispatch`` enqueues device work
without reading results back (apart from the SQ8 certificate read and
the residual loop's ranks, as in the reference; its blocking
host-to-device copies of descriptors and ids do wait for the stream) and
ends by queueing the copies of its outputs to pinned host memory behind
a CUDA event; ``fetch`` waits on that event alone, so a
pipelined caller that dispatched wave N+1 first never waits for it when
it fetches wave N.  The NumPy backend is the host oracle, as in the
reference.

The build-time structures (ESAM dicts, per-state ``_StateIndex`` objects,
``HNSW`` instances) are pointer-rich host objects: right for incremental
construction, wrong for the hot query path.  At finalize time this module
flattens them into struct-of-arrays form:

  * ``kind``      (n_states,)  int8   — NONE / RAW / GRAPH per state;
  * ``inherit``   (n_states,)  int64  — inheritance-chain successor (-1 end);
  * ``base_ptr``  (n_states+1,) int64 + ``base_ids`` (Σ|base|,) int64 — CSR
    of *every* state's base-ID segment (raw and graph states alike), so a
    chain walk is a handful of array reads and the union of a chain's
    segments is exactly V_state (Lemma 4);
  * per-graph padded neighbour matrices (``HNSW.pack()``) kept by state.

Query execution splits into a host **planner** and a device-resident
**executor** over *compiled predicates* (core/predicate.py, DESIGN.md §3):

  * ``PackedRuntime.plan`` coalesces requests with identical predicate keys
    into one ``PlanEntry`` carrying the predicate's compiled sources —
    chain covers as CSR *descriptor ranges*, explicit id sets, composed
    membership masks, residual verifiers — no per-state Python objects
    survive into execution;
  * ``PackedRuntime.execute`` answers the whole batch touching the host
    only for planning integers and the final (k,) results: ALL
    brute-force candidate sets go through ONE descriptor-driven segmented
    distance+top-k launch (``ops.topk_segmented_desc`` — frozen covers
    resolve against the device-resident CSR, zero candidate-id upload;
    only post-watermark delta tails ship ids + rows), graph states run
    ONE fused beam launch per size bucket vmapped over (graph, query)
    pairs (conjunction bitmaps stacked per distinct mask; tombstone
    over-fetch clamped at the beam's ef capacity, past which the resident
    deleted bitmap filters in-loop), ``residual`` sources run an
    over-fetch + exact host-side verification loop until k verified hits,
    and the per-request merge — dedup across OR disjuncts, tombstone
    filter, cut to k — folds on device (``ops.merge_topk_device``) for
    requests whose parts are all launch rows.  Every dynamic dimension is
    power-of-two bucketed, so steady-state serving replays a fixed
    executable set (launch/retrace counters in ``kernels.ops``, traffic
    counters in ``PackedRuntime.traffic``).

Device placement (DESIGN.md §2): ``to_device()`` uploads the vector table,
the base-ID CSR, a deleted-mask, and the graph matrices (per state and as
size-bucketed stacks) exactly once; queries afterwards ship only the
plan's integers, the query rows, and the bounded delta tail.  The host
backend runs the same plan with NumPy kernels and a NumPy merge — the
bit-exactness oracle for every device stage (the ``use_descriptors`` /
``fuse_graphs`` / ``device_merge`` toggles force the legacy paths for
parity tests).

Write path (DESIGN.md §4): a built ``PackedRuntime`` is an immutable
**generation**.  Inserts never touch its arrays — they land in the
attached ``DeltaRuntime`` (per-state delta ID lists plus a growable
``VectorStore`` owned by the VectorMaton), and every execution strategy
merges delta candidates: chain/scan segments get the delta IDs appended
to their brute-forced sets (still one segmented kernel launch, with rows
past the device-upload watermark shipped per batch), ``filtered_graph``
and ``residual`` verify delta IDs host-side.  A compaction
(``VectorMaton.compact``) folds delta + tombstone GC into a fresh
generation and swaps it in with a single reference assignment; plans are
stamped with the generation that compiled them and refuse to execute
against another, so readers that snapshot a runtime keep a consistent
view across the swap.
"""

from __future__ import annotations

import time
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.quant import (quantize_sq8_ext, sq8_supported,
                             topk_sq8_segmented_desc)
from .hnsw_torch import hnsw_search_fused, hnsw_search_fused_filtered
from .predicate import CompiledPredicate, CompiledSource

KIND_NONE = -1
KIND_RAW = 0
KIND_GRAPH = 1

_EMPTY_F = np.empty(0, np.float32)
_EMPTY_I = np.empty(0, np.int64)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A synchronous device-to-host copy (the residual loop's ranks)."""
    return t.cpu().numpy()


class VectorStore:
    """Append-only (n, d) float32 table with capacity-doubling growth.

    Replaces the O(N)-copy-per-insert ``np.concatenate`` write path: an
    append is an O(d) row write, and the backing buffer reallocates only
    O(log n) times, so total copy traffic is bounded by ~2× the final
    table size (``bytes_copied`` tracks it; bench_churn asserts the
    bound).  ``view`` is the live (n, d) prefix — a zero-copy slice that
    must be re-fetched after an append, because a reallocation moves the
    data to a new buffer.
    """

    def __init__(self, vectors: np.ndarray, min_capacity: int = 64) -> None:
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        if v.ndim != 2:
            raise ValueError("VectorStore expects an (n, d) table")
        self.n = len(v)
        cap = max(min_capacity, self.n)
        self._buf = np.empty((cap, v.shape[1]), dtype=np.float32)
        self._buf[:self.n] = v
        self.reallocations = 0
        self.bytes_copied = int(v.nbytes)

    @property
    def view(self) -> np.ndarray:
        return self._buf[:self.n]

    def append(self, row: np.ndarray) -> int:
        row = np.asarray(row, dtype=np.float32)
        if row.shape != (self._buf.shape[1],):
            raise ValueError(
                f"expected a ({self._buf.shape[1]},) vector, got shape "
                f"{row.shape} (a scalar or mis-shaped row would silently "
                "broadcast into a corrupt table row)")
        if self.n == len(self._buf):
            grown = np.empty((2 * len(self._buf), self._buf.shape[1]),
                             dtype=np.float32)
            grown[:self.n] = self._buf[:self.n]
            self._buf = grown
            self.reallocations += 1
            self.bytes_copied += int(self.n * self._buf.shape[1] * 4)
        self._buf[self.n] = row
        self.n += 1
        return self.n - 1


class DeltaRuntime:
    """Append-only insert log layered over one frozen generation.

    Exactness argument (DESIGN.md §4): for a freeze-time state u the
    frozen chain cover is exactly V_u at freeze time (Lemma 4), and V
    sets only ever *append* post-freeze ids, so
    ``V_u(now) = frozen cover ∪ chain-delta(u)`` where chain-delta is
    the union of ``state_delta`` lists along u's frozen inheritance
    chain (the affected-state logic in ``VectorMaton.insert`` lands each
    new id at exactly one chain state, mirroring the cover's
    disjointness).  States created after the freeze carry no frozen
    cover and are answered from their live ESAM V set, which the
    predicate compiler reads directly.  Tombstones are subtracted at
    execute time, so every strategy is exact over
    base ∪ delta − tombstones.
    """

    def __init__(self, n_base: int, n_states: int) -> None:
        self.n_base = n_base        # vector-count watermark at freeze
        self.n_states = n_states    # state-count watermark at freeze
        self.version = 0            # bumped per insert (pred-cache key)
        self.pending = 0            # inserts folded by the next compaction
        self.state_delta: Dict[int, List[int]] = {}
        # post-freeze ids in arrival order: the replication delta log is
        # extracted from this (extract_delta_records, DESIGN.md §10) —
        # state_delta scatters ids per chain state, which loses the write
        # order a follower must replay
        self.inserted: List[int] = []
        # graphs born after the freeze — raw→graph promotions and HNSW
        # indexes built for post-freeze clone states.  They are invisible
        # to the frozen generation (not in graph_objs), so delete() must
        # fan tombstones into them directly, and their existence triggers
        # a compaction so the next generation actually searches them.
        self.fresh_graph_states: set = set()

    @property
    def empty(self) -> bool:
        return self.pending == 0

    def record(self, state: int, vector_id: int) -> None:
        """Log that ``state``'s base set gained ``vector_id``.  Called
        from the insert path's affected-state logic; post-freeze states
        are served from the live ESAM and are not recorded."""
        if state < self.n_states:
            self.state_delta.setdefault(state, []).append(vector_id)


def extract_delta_records(vm) -> List[Dict]:
    """Reify the live delta of ``vm``'s current generation as ordered
    replication payloads (DESIGN.md §10).

    One ``{'op': 'insert', ...}`` record per post-freeze id — carrying
    the vector row (copied: the growable table may reallocate under the
    caller), the sequence, and the attributes, in arrival order from
    ``DeltaRuntime.inserted`` — followed by one ``{'op': 'delete', ...}``
    per live tombstone (delete marks are idempotent, so replaying the
    full set is exact even when some predate the freeze).

    The write leader uses this to seed a replica-set delta log when
    replication attaches to an index that already carries unfolded
    writes: a follower bootstrapped from the attach-time checkpoint acks
    the seeded watermark, and a later rejoiner restoring an older
    checkpoint replays these records like any shipped batch.
    """
    rt = vm.runtime
    out: List[Dict] = []
    vectors = vm.vectors
    for i in rt.delta.inserted:
        out.append({
            "op": "insert", "vector_id": int(i),
            "vector": np.array(vectors[i]),
            "sequence": vm.sequences[i],
            "attributes": (dict(vm.attributes[i])
                           if i < len(vm.attributes) else {}),
        })
    for vid in sorted(vm.deleted):
        out.append({"op": "delete", "vector_id": int(vid)})
    return out


@dataclass
class ChainCover:
    """A state's inheritance-chain cover in CSR coordinates (== V_state).

    ``states`` is aligned with ``segments``: the chain state that owns each
    segment.  The sharded executor resolves covers against a *shard-local*
    CSR, whose per-state pointers are keyed by state id — the global
    ``(lo, hi)`` ranges are meaningless there, so the states ride along."""
    segments: List[Tuple[int, int]]
    raw_segments: List[Tuple[int, int]]
    graph_states: List[int]
    size: int
    states: List[int] = field(default_factory=list)


@dataclass
class PlanEntry:
    """Execution plan for one compiled predicate (≥ 1 coalesced requests)."""
    key: object                              # predicate coalescing key
    requests: List[int]                      # request positions in the batch
    sources: List[CompiledSource]            # OR-disjuncts to execute+merge
    est: int = 0                             # estimated |qualified set|

    @property
    def state(self) -> int:
        """Anchor state when the entry is a plain CONTAINS chain; -1 for
        boolean predicates (kept for introspection/tests)."""
        if len(self.sources) == 1 and self.sources[0].strategy == "chain":
            return self.sources[0].anchor
        return -1


@dataclass
class QueryPlan:
    n_requests: int
    entries: List[PlanEntry]
    misses: List[int]                        # requests provably empty
    generation: int = 0                      # runtime that compiled the plan
    delta_version: int = 0                   # delta watermark at compile time

    @property
    def coalesced(self) -> int:
        """Requests answered by a shared plan entry."""
        return sum(len(e.requests) - 1 for e in self.entries)

    @property
    def strategies(self) -> Counter:
        """source strategy -> count, over all entries (bench/debug)."""
        return Counter(s.strategy for e in self.entries for s in e.sources)


@dataclass
class PendingExecution:
    """In-flight result of ``PackedRuntime.dispatch`` (DESIGN.md §7).

    Holds everything ``fetch`` needs to assemble the final per-request
    results: the device launch outputs (CUDA launches are asynchronous,
    so the kernels may still be running), the per-request (launch, row)
    routing, host-computed parts (residual verification), and — when the
    device merge ran — the merged ``(R, k)`` device tensors.  ``host_*``
    are the host copies ``fetch`` reads: on the card, pinned tensors
    whose copies were queued at the end of ``dispatch`` and complete at
    ``ready`` (a CUDA event recorded after them; never read one before
    it); on the CPU, the outputs themselves.  Between ``dispatch`` and
    ``fetch`` the host is free to plan and dispatch the NEXT wave;
    waiting on ``ready`` in ``fetch`` is the only point that blocks on
    the device, and it waits for this wave's work alone.
    """
    plan: QueryPlan
    k: int
    out: List[Tuple[np.ndarray, np.ndarray]]
    launches: List[Tuple[object, object]]
    dev_parts: List[List[Tuple[int, int]]]
    parts: List[List[Tuple[np.ndarray, np.ndarray]]]
    dev_only: List[int] = field(default_factory=list)
    merged: Optional[Tuple[object, object]] = None   # (md, mi) on device
    host_merged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    host_launches: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict)     # launch index -> host (vals, gids)
    ready: Optional[torch.cuda.Event] = None
    fetched: bool = False


class PackedRuntime:
    """Flattened, device-residable view of a built VectorMaton index."""

    def __init__(self, vectors: np.ndarray, kind: np.ndarray,
                 inherit: np.ndarray, base_ptr: np.ndarray,
                 base_ids: np.ndarray, graphs: Dict[int, Dict[str, np.ndarray]],
                 graph_objs: Dict[int, object], *, metric: str = "l2",
                 backend: str = "numpy", deleted: Optional[set] = None,
                 sequences: Optional[Sequence] = None,
                 quantize: str = "none", accum: str = "f32",
                 generation: int = 0, device: str = "cuda"):
        self.device = torch.device(device)   # where to_device uploads
        self.vectors = vectors          # live view; base rows are immutable
        self.kind = kind
        self.inherit = inherit
        self.base_ptr = base_ptr
        self.base_ids = base_ids
        self.graphs = graphs            # state -> HNSW.pack() arrays
        self.graph_objs = graph_objs    # state -> host HNSW (host beam search)
        self.metric = metric
        self.backend = backend
        self.deleted = deleted if deleted is not None else set()
        self.sequences = list(sequences) if sequences is not None else []
        self.quantize = quantize
        self.accum = accum
        self.generation = generation
        self.n_states = len(kind)       # state-count watermark at freeze
        # CSR segment count: automaton states + attribute pseudo-segments
        # appended by ``build`` (per-attribute sorted-ID arrays).  Only
        # [0, n_states) are automaton states (kind/inherit/delta apply);
        # [n_states, n_csr) are attribute segments addressed by
        # attr_num/attr_tag and resolved as descriptors like any other.
        self.n_csr = len(base_ptr) - 1
        self.attr_schema: Dict[str, str] = {}
        self.attr_num: Dict[str, Tuple[int, np.ndarray]] = {}
        self.attr_tag: Dict[str, Dict[str, int]] = {}
        self.attributes: List[dict] = []   # live view, same as sequences
        self.delta = DeltaRuntime(len(vectors), len(kind))
        # id -> graph states whose node set contains it (delete fan-out)
        self._id_graph_states: Optional[Dict[int, List[int]]] = None
        self._dev: Optional[dict] = None    # device cache, built once
        self._dev_n = 0                     # vector count at upload time
        # predicate key -> (delta version at compile, compiled predicate,
        # planner-measured winning strategy at compile — a later measured
        # winner invalidates the entry so the re-compile replays it)
        self._pred_cache: Dict[
            str, Tuple[int, CompiledPredicate, Optional[str]]] = {}
        # owning index's AdaptivePlanner (set by build; None for bare
        # runtimes).  Executors report (strategy, units, ms) through it;
        # the fold happens at wave heads only (DESIGN.md §11).
        self.planner = None
        # device-resident execution (DESIGN.md §3).  The three toggles are
        # parity escape hatches: each False routes that stage through the
        # legacy host-mediated path, which tests/test_device_exec.py uses
        # as the bit-exactness oracle for the device-resident path.
        self.use_descriptors = True     # CSR descriptors vs host id upload
        self.fuse_graphs = True         # bucket-fused vs per-state beams
        self.device_merge = True        # device vs host per-request merge
        # host→device traffic accounting, per batch class (bench gate);
        # the shard_* classes stay at 0 until the sharded executor is
        # ported, so the key set matches the reference's
        self.traffic: Dict[str, int] = {
            "batches": 0, "bytes_to_device": 0, "candidate_id_bytes": 0,
            "query_bytes": 0, "descriptor_bytes": 0, "row_bytes": 0,
            "mask_bytes": 0, "shard_batches": 0, "shard_mask_bytes": 0,
            "shard_descriptor_bytes": 0, "shard_tail_bytes": 0,
            "shard_query_bytes": 0}
        # SQ8 scan-path accounting: every batch is either certified
        # (provably equal to the fp32 scan) or escalated to it; fallbacks
        # count batches the eligibility gate routed to fp32 outright
        self.sq8_stats: Dict[str, int] = {
            "batches": 0, "certified": 0, "escalations": 0, "fallbacks": 0}
        self._sq8_warned = False
        # adaptive escalation policy: a workload whose candidate sets are
        # too dense for the worst-case certificate (big n, tight
        # neighbour gaps) would pay int8 scan + rerank + fp32 scan every
        # batch; after this many CONSECUTIVE escalations the runtime
        # flips to the fp32 scan outright (counted as fallbacks), so the
        # sq8 default is never asymptotically slower than fp32.  A
        # certified batch resets the streak.  ``sq8_escalate=False``
        # trusts the rerank output without the certificate sync — the
        # approximate operating point the frontier benchmark measures.
        self.sq8_escalate = True
        self._sq8_bad_streak = 0
        self.SQ8_MAX_STREAK = 3
        # cumulative per-wave wall-clock (ms), surfaced by
        # maintenance_stats as time_*_ms.  Device dispatch is async, so
        # launch_ms is trace+dispatch cost and merge_ms absorbs the sync.
        self.wave_times: Dict[str, float] = {
            "plan_ms": 0.0, "upload_ms": 0.0, "launch_ms": 0.0,
            "merge_ms": 0.0}

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #

    @classmethod
    def build(cls, vm, generation: int = 0) -> "PackedRuntime":
        """Flatten a VectorMaton's chain structure + per-state indexes."""
        from .vectormaton import _RAW  # local import avoids cycle

        n = vm.esam.num_states
        kind = np.full(n, KIND_NONE, dtype=np.int8)
        base_ptr = np.zeros(n + 1, dtype=np.int64)
        chunks: List[np.ndarray] = []
        graphs: Dict[int, Dict[str, np.ndarray]] = {}
        graph_objs: Dict[int, object] = {}
        for u in range(n):
            idx = vm.state_index[u] if u < len(vm.state_index) else None
            if idx is None:
                base_ptr[u + 1] = base_ptr[u]
                continue
            if idx.kind == _RAW:
                kind[u] = KIND_RAW
                seg = np.asarray(idx.raw_ids, dtype=np.int64)
            else:
                kind[u] = KIND_GRAPH
                seg = np.asarray(idx.graph.ids, dtype=np.int64)
                graphs[u] = idx.graph.pack()
                graph_objs[u] = idx.graph
            chunks.append(seg)
            base_ptr[u + 1] = base_ptr[u] + len(seg)
        # Attribute pseudo-segments (DESIGN.md §9): one sorted-by-value
        # ID segment per numeric field (rank ranges answer Range leaves
        # as descriptor slices) and one sorted-ID segment per (tag field,
        # value).  They live in the same CSR as chain segments, so the
        # resident base_ids answers them with zero candidate-id upload.
        schema = dict(getattr(vm.config, "schema", None) or {})
        attr_rows = getattr(vm, "attributes", None) or []
        attr_num: Dict[str, Tuple[int, np.ndarray]] = {}
        attr_tag: Dict[str, Dict[str, int]] = {}
        attr_segs: List[np.ndarray] = []
        if schema:
            n_rows = min(len(vm.vectors), len(attr_rows))

            def _pseudo(seg: np.ndarray) -> int:
                attr_segs.append(np.asarray(seg, dtype=np.int64))
                return n + len(attr_segs) - 1

            for f in sorted(schema):
                if schema[f] == "numeric":
                    ids = np.asarray([i for i in range(n_rows)
                                      if f in attr_rows[i]], np.int64)
                    vals = np.asarray([float(attr_rows[int(i)][f])
                                       for i in ids], np.float64)
                    order = np.lexsort((ids, vals))
                    attr_num[f] = (_pseudo(ids[order]), vals[order])
                else:
                    groups: Dict[str, List[int]] = {}
                    for i in range(n_rows):
                        v = attr_rows[i].get(f)
                        if v is not None:
                            groups.setdefault(str(v), []).append(i)
                    attr_tag[f] = {
                        v: _pseudo(np.asarray(groups[v], np.int64))
                        for v in sorted(groups)}
        if attr_segs:
            lens = np.asarray([len(s) for s in attr_segs], np.int64)
            base_ptr = np.concatenate(
                [base_ptr, base_ptr[-1] + np.cumsum(lens)])
            chunks.extend(attr_segs)
        base_ids = (np.concatenate(chunks) if chunks
                    else np.empty(0, np.int64))
        rt = cls(vm.vectors, kind, np.asarray(vm.inherit, dtype=np.int64),
                 base_ptr, base_ids, graphs, graph_objs,
                 metric=vm.config.metric, backend=vm.config.backend,
                 deleted=vm.deleted,
                 quantize=getattr(vm.config, "quantize", "none"),
                 accum=getattr(vm.config, "accum", "f32"),
                 generation=generation, device=vm.config.device)
        # share (don't copy) the live sequence list: residual verification
        # of delta ids must see sequences appended after this freeze
        rt.sequences = getattr(vm, "sequences", rt.sequences)
        rt.attr_schema = schema
        rt.attr_num = attr_num
        rt.attr_tag = attr_tag
        # live view for the same reason as sequences: attribute leaves
        # evaluate post-freeze inserts host-side at compile time
        rt.attributes = getattr(vm, "attributes", rt.attributes)
        # the index-owned planner: feedback outlives this generation
        rt.planner = getattr(vm, "planner", None)
        return rt

    # ------------------------------------------------------------------ #
    # device residency
    # ------------------------------------------------------------------ #

    def to_device(self) -> dict:
        """Upload the packed arrays once; reused by every later batch.
        ``_dev_n`` records the row count at upload time — delta rows
        appended later are shipped per batch by the executor's
        watermark-split gather, never by re-uploading the table.

        Graph matrices upload twice over: per state (legacy per-graph
        path, parity oracle) and as size-bucketed ``(G, n_max, 2M)``
        stacks (``graph_buckets``) that the fused executor vmaps one beam
        launch over per bucket.  ``graph_slot`` maps a state to its
        (bucket key, stack row).  Stack padding: ids 0 / neighbours -1 —
        padded slots are unreachable (no entry point or edge leads to
        them), asserted by the fused-vs-per-graph parity test."""
        if self._dev is None:
            dev = self.device
            self._dev_n = len(self.vectors)
            dmask = np.zeros(self._dev_n, dtype=bool)
            if self.deleted:
                gone = [i for i in self.deleted if i < self._dev_n]
                dmask[gone] = True
            by_bucket: Dict[Tuple[int, int], List[int]] = {}
            for u, pk in self.graphs.items():
                bkey = (ops.bucket(len(pk["ids"]), 8),
                        pk["level0"].shape[1])
                by_bucket.setdefault(bkey, []).append(u)
            buckets: Dict[Tuple[int, int], dict] = {}
            slots: Dict[int, Tuple[Tuple[int, int], int]] = {}
            for bkey, states in by_bucket.items():
                n_pad, width = bkey
                g = len(states)
                ids = np.zeros((g, n_pad), np.int32)
                lvl = np.full((g, n_pad, width), -1, np.int32)
                ent = np.zeros(g, np.int32)
                for j, u in enumerate(states):
                    pk = self.graphs[u]
                    ids[j, :len(pk["ids"])] = pk["ids"]
                    lvl[j, :len(pk["level0"])] = pk["level0"]
                    ent[j] = pk["entry"][0]
                    slots[u] = (bkey, j)
                buckets[bkey] = {
                    "ids": torch.from_numpy(ids).to(dev),
                    "level0": torch.from_numpy(lvl).to(dev),
                    "entry": torch.from_numpy(ent).to(dev),
                }
            self._dev = {
                "vectors": torch.from_numpy(
                    np.ascontiguousarray(self.vectors, np.float32)).to(dev),
                "base_ids": torch.from_numpy(
                    self.base_ids.astype(np.int32)).to(dev),
                "deleted": torch.from_numpy(dmask).to(dev),
                "graphs": {
                    u: {"ids": torch.from_numpy(
                            pk["ids"].astype(np.int32))[None].to(dev),
                        "level0": torch.from_numpy(
                            pk["level0"].astype(np.int32))[None].to(dev),
                        "entry": torch.from_numpy(
                            pk["entry"][:1].astype(np.int32)).to(dev)}
                    for u, pk in self.graphs.items()},
                "graph_buckets": buckets,
                "graph_slot": slots,
            }
        if self.quantize == "sq8" and "quant" not in self._dev:
            # resident int8 table: codes + per-row (scale, sqnorm,
            # code-L1) — the SQ8 scan reads these instead of the fp32
            # rows; derived on device from the already-resident table so
            # nothing extra ships from the host.  Outside the ``if`` so
            # a runtime toggled to sq8 after its first upload (bench
            # strategy sweeps) still gets the table.
            self._dev["quant"] = quantize_sq8_ext(self._dev["vectors"])
        return self._dev

    def to_device_sharded(self, mesh, axis: str = "data",
                          n: Optional[int] = None):
        """Row-sharded residency is not ported yet (ROADMAP Queue 1 item 7,
        the sharded executor)."""
        raise NotImplementedError(
            "repro_torch has no sharded executor yet: ROADMAP Queue 1 "
            "item 7 (distributed/sharded_search.py) ports it")

    def mark_deleted(self, vector_id: int) -> None:
        """Keep the device-side tombstone mask in sync: one in-place write
        into the resident mask (the reference rebuilt the immutable array
        with ``.at[].set``).  Delta ids past the upload watermark are
        filtered host-side when their candidate lists are built."""
        if self._dev is not None and vector_id < self._dev_n:
            self._dev["deleted"][vector_id] = True

    def graph_states_of(self, vector_id: int) -> List[int]:
        """Graph states whose node set contains ``vector_id``.  Built from
        the live host graph objects (not the frozen CSR) so ids added to
        a graph after this generation froze still fan tombstones out;
        the insert path invalidates the cache when it grows a graph."""
        if self._id_graph_states is None:
            m: Dict[int, List[int]] = {}
            for u, g in self.graph_objs.items():
                for gid in g.ids:
                    m.setdefault(int(gid), []).append(u)
            self._id_graph_states = m
        return self._id_graph_states.get(int(vector_id), [])

    # ------------------------------------------------------------------ #
    # planner (host)
    # ------------------------------------------------------------------ #

    def plan(self, compiled: Sequence[CompiledPredicate]) -> QueryPlan:
        """Coalesce a batch of compiled predicates into plan entries.
        Requests whose predicates share a canonical key share one entry;
        provably-empty predicates (pattern ∉ corpus) are misses."""
        entries: Dict[object, PlanEntry] = {}
        misses: List[int] = []
        for r, cp in enumerate(compiled):
            if cp.empty:
                misses.append(r)
                continue
            e = entries.get(cp.key)
            if e is None:
                e = PlanEntry(cp.key, [], cp.sources, cp.est)
                entries[cp.key] = e
            e.requests.append(r)
        return QueryPlan(len(compiled), list(entries.values()), misses,
                         generation=self.generation,
                         delta_version=self.delta.version)

    def chain_cover(self, state: int) -> ChainCover:
        """Walk the inheritance chain; CSR ranges covering exactly V_state."""
        segments: List[Tuple[int, int]] = []
        raw_segments: List[Tuple[int, int]] = []
        graph_states: List[int] = []
        states: List[int] = []
        size = 0
        u = state
        while u != -1:
            lo, hi = int(self.base_ptr[u]), int(self.base_ptr[u + 1])
            if hi > lo:
                segments.append((lo, hi))
                states.append(u)
                size += hi - lo
                if self.kind[u] == KIND_RAW:
                    raw_segments.append((lo, hi))
                else:
                    graph_states.append(u)
            u = int(self.inherit[u])
        return ChainCover(segments, raw_segments, graph_states, size,
                          states=states)

    def chain_delta_ids(self, state: int) -> np.ndarray:
        """New ids in V_state since this generation froze, sorted.  Walks
        the frozen inheritance chain: the insert path records each new id
        at exactly one chain state (the deepest whose V gained it), so
        the union along the chain is disjoint and, together with the
        frozen cover, reproduces the live V_state exactly."""
        sd = self.delta.state_delta
        if not sd:
            return _EMPTY_I
        out: List[int] = []
        u = state
        while u != -1:
            out.extend(sd.get(u, ()))
            u = int(self.inherit[u])
        if not out:
            return _EMPTY_I
        return np.sort(np.asarray(out, dtype=np.int64))

    def entry_mask(self, entry: PlanEntry) -> np.ndarray:
        """Exact (n,) bool membership of the entry's qualified set — OR over
        sources, residual verification applied.  Feeds the distributed
        path's per-entry validity mask and the test oracles."""
        n = len(self.vectors)
        m = np.zeros(n, dtype=bool)
        for s in entry.sources:
            sm = np.zeros(n, dtype=bool)
            if s.strategy in ("chain", "filtered_graph"):
                for lo, hi in s.segments:
                    sm[self.base_ids[lo:hi]] = True
                if s.delta_ids is not None:
                    sm[s.delta_ids] = True
                if s.allowed is not None:
                    a = s.allowed
                    if len(a) < n:
                        a = np.pad(a, (0, n - len(a)))
                    sm &= a[:n]
            else:
                sm[s.ids] = True
                if s.delta_ids is not None:
                    sm[s.delta_ids] = True
            if s.verify is not None:
                for i in np.nonzero(sm)[0]:
                    if not s.verify.matches(self.sequences[int(i)],
                                            self._attrs_of(int(i))):
                        sm[i] = False
            m |= sm
        return m

    def _attrs_of(self, gid: int) -> Optional[dict]:
        """Record attributes for residual verification; None when the
        collection carries no attributes (pattern-only predicates never
        read them)."""
        a = self.attributes
        return a[gid] if a and gid < len(a) else None

    # ------------------------------------------------------------------ #
    # executor
    # ------------------------------------------------------------------ #

    def execute(self, queries: np.ndarray, plan: QueryPlan, k: int,
                ef_search: int = 64
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Answer every request in the plan; returns [(dists, ids)] aligned
        with the request batch.

        Device (torch) backend — the warm path touches the host only for
        planning integers and the final (k,) results (DESIGN.md §3):

          * ONE descriptor-driven segmented kernel launch for every
            brute-forced candidate set (frozen chain covers resolve
            against the resident CSR on device; only delta tails past the
            upload watermark ship per batch);
          * ONE fused beam launch per graph size bucket, vmapped over
            (graph, query) pairs — not one per state — with the tombstone
            over-fetch clamped at the beam's ef-list capacity (past it
            the resident deleted bitmap filters in-loop instead);
          * ONE device-side merge (segmented dedup + top-k fold) for all
            requests whose parts are device launch rows; requests with
            host-side parts (``residual`` verification) merge on host.

        Host (numpy) backend: same plan, NumPy kernels, host merge — the
        bit-exactness oracle for every device stage."""
        return self.fetch(self.dispatch(queries, plan, k,
                                        ef_search=ef_search))

    def dispatch(self, queries, plan: QueryPlan, k: int,
                 ef_search: int = 64) -> PendingExecution:
        """Launch every device stage of the plan WITHOUT syncing on the
        results (DESIGN.md §7): staleness checks, the segmented scan
        launch, the fused beam launches, residual verification (host
        work), and the device-side merge fold are all dispatched — CUDA
        launches are asynchronous, so the outputs are device futures — and
        the per-request assembly integers are packed into a
        ``PendingExecution``.  The caller overlaps the next wave's
        planning/dispatch with this wave's device execution and calls
        ``fetch`` when it needs the results.  ``execute`` is the
        synchronous composition.

        ``queries`` is an (n, d) array, or a pinned CPU tensor (a
        ``serve.step`` staging slot), which uploads asynchronously; on the
        torch backend the wave's queries upload once and every stage
        gathers its rows on the device."""
        if plan.generation != self.generation:
            raise ValueError(
                f"stale plan: compiled against generation "
                f"{plan.generation}, executing on generation "
                f"{self.generation} — snapshot the runtime once per batch "
                "(VectorMaton.snapshot) so a compaction swap cannot split "
                "plan and execute across generations")
        if plan.delta_version != self.delta.version:
            raise ValueError(
                f"stale plan: compiled at delta version "
                f"{plan.delta_version}, executing at "
                f"{self.delta.version} — an insert landed between plan "
                "and execute, so the plan's delta id lists are "
                "incomplete; re-plan (query_batch does this per batch)")
        queries, qdev = self._wave_queries(queries)
        out: List[Tuple[np.ndarray, np.ndarray]] = [
            (_EMPTY_F, _EMPTY_I)] * plan.n_requests
        parts: List[List[Tuple[np.ndarray, np.ndarray]]] = [
            [] for _ in range(plan.n_requests)]
        launches: List[Tuple[object, object]] = []   # (vals, gids) on device
        dev_parts: List[List[Tuple[int, int]]] = [
            [] for _ in range(plan.n_requests)]      # (launch idx, row)
        pending = PendingExecution(plan=plan, k=k, out=out,
                                   launches=launches, dev_parts=dev_parts,
                                   parts=parts)
        if not plan.entries:
            pending.fetched = True
            return pending
        scan_items, graph_shared, graph_filtered, residual_items = (
            self._gather_work(plan))
        if self.backend == "torch":
            self.traffic["batches"] += 1
            if self.quantize == "sq8":
                self._execute_scan_sq8(qdev, scan_items, k, launches,
                                       dev_parts)
            else:
                self._execute_scan_device(qdev, scan_items, k, launches,
                                          dev_parts)
            t0 = time.perf_counter()
            self._execute_graphs_device(qdev, graph_shared, graph_filtered,
                                        k, ef_search, launches, dev_parts)
            self.wave_times["launch_ms"] += (time.perf_counter() - t0) * 1e3
        else:
            self._execute_scan_host(queries, scan_items, k, parts)
            self._execute_graphs_host(queries, graph_shared, graph_filtered,
                                      k, ef_search, parts)
        for e, s in residual_items:
            self._execute_residual(queries if qdev is None else qdev, e, s,
                                   k, parts)
        # device-merge half that can be DISPATCHED now: requests whose
        # parts are all launch rows fold on device; the (R, k) result
        # stays a device future until fetch
        t0 = time.perf_counter()
        n = plan.n_requests
        if launches and self.device_merge:
            pending.dev_only = [r for r in range(n)
                                if dev_parts[r] and not parts[r]]
        if pending.dev_only:
            pending.merged = self._merge_device_launch(
                pending.dev_only, launches, dev_parts, k)
        if self.backend == "torch":
            self._queue_host_copies(pending)
        self.wave_times["merge_ms"] += (time.perf_counter() - t0) * 1e3
        return pending

    def _wave_queries(self, queries):
        """The wave's (n, d) query matrix as a host array and — torch
        backend — its one upload to the device: asynchronous from a
        pinned CPU tensor (a staging slot, which the caller keeps leased
        until the wave's event), a blocking copy from an array."""
        if isinstance(queries, torch.Tensor):
            host, src = queries.numpy(), queries
        else:
            host = np.ascontiguousarray(queries, dtype=np.float32)
            src = torch.from_numpy(host)
        if self.backend != "torch":
            return host, None
        return host, src.to(self.device, non_blocking=src.is_pinned())

    def _rows(self, qdev: torch.Tensor, reqs) -> torch.Tensor:
        """Rows ``reqs`` of the wave's device query matrix."""
        return qdev[torch.from_numpy(
            np.asarray(reqs, dtype=np.int64)).to(self.device)]

    def _queue_host_copies(self, pending: PendingExecution) -> None:
        """Queue the copies ``fetch`` will read — the device merge's
        (R, k) rows, and the launch outputs of requests that merge on the
        host (residual parts present) — into pinned host tensors, then
        record ``pending.ready`` after them on the wave's stream.  On the
        CPU the outputs are already host tensors."""
        done = set(pending.dev_only)
        need = sorted({li for r in range(pending.plan.n_requests)
                       if r not in done for li, _ in pending.dev_parts[r]})
        if self.device.type != "cuda":
            pending.host_merged = pending.merged
            pending.host_launches = {li: pending.launches[li]
                                     for li in need}
            return

        def copy(t: torch.Tensor) -> torch.Tensor:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            return h

        if pending.merged is not None:
            pending.host_merged = (copy(pending.merged[0]),
                                   copy(pending.merged[1]))
        pending.host_launches = {li: (copy(pending.launches[li][0]),
                                      copy(pending.launches[li][1]))
                                 for li in need}
        pending.ready = torch.cuda.Event()
        pending.ready.record()

    def fetch(self, pending: PendingExecution
              ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Sync on a dispatched wave's device results and assemble the
        final per-request (dists, ids).  This is the ONLY point the
        executor blocks on the device, and it waits on this wave's own
        event (recorded after its host copies), so a pipelined caller
        fetches wave N while wave N+1 is already executing."""
        if pending.fetched:
            return pending.out
        t0 = time.perf_counter()
        self._merge_fetch(pending)
        self.wave_times["merge_ms"] += (time.perf_counter() - t0) * 1e3
        pending.fetched = True
        return pending.out

    def _merge_fetch(self, pending: PendingExecution) -> None:
        """Per-request merge: dedup ids across OR disjuncts / overlapping
        sources (keep the closest), drop tombstones, cut to k.  Requests
        whose parts are all device launch rows were folded on device at
        dispatch (``merge_topk_device``) — here their (R, k) rows cross
        to the host; the rest — host backend, or residual parts present —
        run the NumPy merge, which is the bit-exactness oracle
        (``device_merge=False`` forces it everywhere)."""
        plan, launches, dev_parts, parts, k, out = (
            pending.plan, pending.launches, pending.dev_parts,
            pending.parts, pending.k, pending.out)
        n = plan.n_requests
        dev_only = pending.dev_only
        if pending.ready is not None:
            pending.ready.synchronize()       # this wave's copies only
        if pending.host_merged is not None:
            md, mi = (pending.host_merged[0].numpy(),
                      pending.host_merged[1].numpy())
            for j, r in enumerate(dev_only):
                valid = mi[j] >= 0
                out[r] = (md[j][valid], mi[j][valid].astype(np.int64))
        done = set(dev_only)
        conv: List[Optional[Tuple[np.ndarray, np.ndarray]]] = (
            [None] * len(launches))

        def _host_rows(li: int) -> Tuple[np.ndarray, np.ndarray]:
            if conv[li] is None:
                v, g = pending.host_launches[li]
                conv[li] = (v.numpy(), g.numpy())
            return conv[li]

        for r in range(n):
            if r in done:
                continue
            host_parts = parts[r]
            if dev_parts[r]:
                pre = []
                for li, row in dev_parts[r]:
                    v, g = _host_rows(li)
                    valid = g[row] >= 0
                    pre.append((v[row][valid],
                                g[row][valid].astype(np.int64)))
                host_parts = pre + host_parts
            if not host_parts:
                continue
            d = np.concatenate([p[0] for p in host_parts])
            i = np.concatenate([p[1] for p in host_parts])
            if self.deleted:
                keep = ~np.isin(i, np.fromiter(self.deleted,
                                               dtype=np.int64))
                d, i = d[keep], i[keep]
            order = np.argsort(d, kind="stable")
            d, i = d[order], i[order]
            # OR disjuncts can overlap: keep the first (closest) per id
            _, first = np.unique(i, return_index=True)
            if len(first) != len(i):
                keep = np.zeros(len(i), dtype=bool)
                keep[first] = True
                d, i = d[keep], i[keep]
            out[r] = (d[:k], i[:k])

    def _merge_device_launch(self, reqs: List[int], launches, dev_parts,
                             k: int) -> Tuple[object, object]:
        """Stack this batch's launch outputs into one (T, W) pool, gather
        each request's rows by index matrix, and fold dedup + top-k on
        device — replacing the per-request Python concatenate/argsort
        loop with one bucketed launch and ONE (R, k) transfer back.
        Returns the (R_pad, k) device arrays WITHOUT syncing: ``fetch``
        crosses them to the host when the caller needs the results."""
        dev = self.to_device()
        w = max(int(v.shape[1]) for v, _ in launches)
        pd, pi, offs = [], [], []
        t = 0
        for v, g in launches:
            if int(v.shape[1]) < w:
                v = torch.nn.functional.pad(v, (0, w - int(v.shape[1])),
                                            value=float("inf"))
                g = torch.nn.functional.pad(g, (0, w - int(g.shape[1])),
                                            value=-1)
            pd.append(v)
            pi.append(g)
            offs.append(t)
            t += int(v.shape[0])
        t_pad = ops.bucket(t + 1, 8)
        big_d = torch.nn.functional.pad(torch.cat(pd, 0), (0, 0, 0, t_pad - t),
                                        value=float("inf"))
        big_i = torch.nn.functional.pad(torch.cat(pi, 0), (0, 0, 0, t_pad - t),
                                        value=-1)
        s_max = ops.bucket(max(len(dev_parts[r]) for r in reqs), 1)
        r_pad = ops.bucket(len(reqs), 8)
        sel = np.full((r_pad, s_max), t_pad - 1, np.int64)   # padding row
        for j, r in enumerate(reqs):
            for s, (li, row) in enumerate(dev_parts[r]):
                sel[j, s] = offs[li] + row
        delmask = (dev["deleted"] if self._dev_n
                   else torch.zeros(1, dtype=torch.bool, device=self.device))
        md, mi = ops.merge_topk_device(
            big_d, big_i, torch.from_numpy(sel).to(self.device), delmask, k)
        ops.record_launch("merge", (t_pad, s_max, w, r_pad, k))
        return md, mi

    def _gather_work(self, plan: QueryPlan):
        """Split the plan into the executor's four work classes.

        Scan items are ``(entry, frozen CSR segments, explicit tail
        ids)``: the device executor resolves the segments as descriptors
        against the resident CSR (zero candidate-id upload), the host
        executor materializes both.  Tails hold everything that is not a
        frozen segment — delta inserts, masked conjunction survivors,
        post-freeze state V sets."""
        scan_items: List[Tuple[PlanEntry, List[Tuple[int, int]],
                               np.ndarray]] = []
        graph_shared: Dict[int, List[int]] = {}
        graph_filtered: List[Tuple[int, np.ndarray, List[int]]] = []
        residual_items: List[Tuple[PlanEntry, CompiledSource]] = []
        for e in plan.entries:
            for s in e.sources:
                delta = (s.delta_ids if s.delta_ids is not None
                         and len(s.delta_ids) else None)
                if s.strategy == "chain":
                    tail = delta if delta is not None else _EMPTY_I
                    if s.raw_segments or len(tail):
                        scan_items.append((e, list(s.raw_segments), tail))
                    for u in s.graph_states:
                        graph_shared.setdefault(u, []).extend(e.requests)
                elif s.strategy == "scan":
                    if len(s.ids):
                        scan_items.append((e, [], s.ids))
                elif s.strategy == "filtered_graph":
                    parts = []
                    if s.raw_segments:
                        cand = np.concatenate(
                            [self.base_ids[lo:hi]
                             for lo, hi in s.raw_segments])
                        cand = cand[s.allowed[cand]]
                        if len(cand):
                            parts.append(cand)
                    if delta is not None:     # host-verified at compile time
                        parts.append(delta)
                    if parts:
                        scan_items.append((e, [], np.concatenate(parts)))
                    for u in s.graph_states:
                        graph_filtered.append((u, s.allowed, e.requests))
                elif s.strategy == "residual":
                    residual_items.append((e, s))
                else:  # pragma: no cover - compiler invariant
                    raise ValueError(f"unknown strategy {s.strategy!r}")
        return scan_items, graph_shared, graph_filtered, residual_items

    # ---- brute-forced candidate sets ---------------------------------- #

    def _live(self, cand: np.ndarray) -> np.ndarray:
        if self.deleted:
            cand = cand[~np.isin(
                cand, np.fromiter(self.deleted, dtype=np.int64))]
        return cand

    def _device_rows(self, cand_np: np.ndarray):
        """(len(cand), d) rows on device: base rows gathered from the
        resident table, rows past the upload watermark (delta inserts)
        shipped from the host per call — the delta is bounded by the
        compaction threshold, so this stays small against the distance
        work itself."""
        dev = self.to_device()
        dn = self._dev_n
        cand_dev = torch.from_numpy(
            np.asarray(cand_np, np.int64)).to(self.device)
        tail = cand_np >= dn
        if not tail.any():
            return dev["vectors"][cand_dev]
        if dn == 0:
            return torch.from_numpy(
                np.ascontiguousarray(self.vectors[cand_np])).to(self.device)
        y = dev["vectors"][cand_dev.clamp(max=dn - 1)]
        y[torch.from_numpy(np.nonzero(tail)[0]).to(self.device)] = (
            torch.from_numpy(np.ascontiguousarray(
                self.vectors[cand_np[tail]])).to(self.device))
        return y

    @staticmethod
    def _scan_units(scan_items) -> int:
        """Cost-model work units for a scan batch: candidate rows ranked,
        summed as |cand| × |requests| per item (DESIGN.md §11)."""
        units = 0
        for e, segs, tail in scan_items:
            cand = sum(hi - lo for lo, hi in segs) + len(tail)
            units += cand * len(e.requests)
        return units

    def _observe(self, strategy: str, units: int, dt_s: float) -> None:
        """Report one executed work item to the owning index's planner
        (no-op for bare runtimes / static mode); folded at wave heads."""
        if self.planner is not None:
            self.planner.observe(strategy, units, dt_s * 1e3)

    def _execute_scan_host(self, queries, scan_items, k, parts) -> None:
        t0 = time.perf_counter()
        for e, segs, tail in scan_items:
            chunks = [self.base_ids[lo:hi] for lo, hi in segs]
            if len(tail):
                chunks.append(tail)
            cand = self._live(np.concatenate(chunks))
            if len(cand) == 0:
                continue
            sub = self.vectors[cand]
            d, li = ops.topk_numpy(queries[e.requests], sub,
                                   min(k, len(cand)), metric=self.metric)
            for row, r in enumerate(e.requests):
                valid = li[row] >= 0
                parts[r].append((d[row][valid], cand[li[row][valid]]))
        self._observe("scan", self._scan_units(scan_items),
                      time.perf_counter() - t0)

    def _assemble_scan_batch(self, queries, scan_items):
        """Flatten the batch's scan items into one descriptor launch:
        frozen CSR segments become ``(start, len, owner)`` triples; tails
        split at the upload watermark into resident ids (device-gathered,
        device-tombstoned) and shipped ids (+ their rows — only the
        post-watermark delta ever ships).  ``use_descriptors=False``
        demotes every segment to explicit ids (the legacy
        candidate-upload path, kept as the parity oracle)."""
        if not scan_items:
            return None
        self.to_device()
        dn = self._dev_n
        q_rows: List[int] = []
        q_owner: List[int] = []
        dstarts: List[int] = []
        dlens: List[int] = []
        downers: List[int] = []
        tres: List[np.ndarray] = []
        tres_o: List[np.ndarray] = []
        tship: List[np.ndarray] = []
        tship_o: List[np.ndarray] = []
        id_bytes = 0
        for owner, (e, segs, tail) in enumerate(scan_items):
            if not self.use_descriptors and segs:
                chunks = [self.base_ids[lo:hi] for lo, hi in segs]
                if len(tail):
                    chunks.append(tail)
                tail = np.concatenate(chunks)
                segs = []
            for lo, hi in segs:
                dstarts.append(lo)
                dlens.append(hi - lo)
                downers.append(owner)
            if len(tail):
                tail = np.asarray(tail, dtype=np.int64)
                res = tail[tail < dn]
                ship = tail[tail >= dn]
                if len(ship) and self.deleted:   # past the resident mask
                    ship = ship[~np.isin(
                        ship, np.fromiter(self.deleted, np.int64))]
                if len(res):
                    tres.append(res.astype(np.int32))
                    tres_o.append(np.full(len(res), owner, np.int32))
                if len(ship):
                    tship.append(ship.astype(np.int32))
                    tship_o.append(np.full(len(ship), owner, np.int32))
            q_rows.extend(e.requests)
            q_owner.extend([owner] * len(e.requests))
        cat = (lambda xs: np.concatenate(xs) if xs
               else np.empty(0, np.int32))
        tres_i, tres_ow = cat(tres), cat(tres_o)
        tship_i, tship_ow = cat(tship), cat(tship_o)
        nd = sum(dlens)
        if nd + len(tres_i) + len(tship_i) == 0:
            return None
        rows = (self.vectors[tship_i.astype(np.int64)] if len(tship_i)
                else np.empty((0, queries.shape[1]), np.float32))
        # traffic accounting mirrors the padded buckets actually shipped
        d_dim = queries.shape[1]
        qp = ops.bucket(len(q_rows))
        dp = ops.bucket(len(dstarts), 8) if nd else 0
        tr, ts = ops.bucket(len(tres_i)), ops.bucket(len(tship_i))
        tf = self.traffic
        tf["query_bytes"] += qp * (d_dim * 4 + 4)
        tf["descriptor_bytes"] += dp * 12
        tf["candidate_id_bytes"] += (tr + ts) * 8    # ids + owner ids
        tf["row_bytes"] += ts * d_dim * 4
        tf["bytes_to_device"] += (qp * (d_dim * 4 + 4) + dp * 12
                                  + (tr + ts) * 8 + ts * d_dim * 4)
        return (q_rows, np.asarray(q_owner, np.int32),
                np.asarray(dstarts, np.int32), np.asarray(dlens, np.int32),
                np.asarray(downers, np.int32), tres_i, tres_ow,
                tship_i, tship_ow, rows)

    def _execute_scan_device(self, queries, scan_items, k, launches,
                             dev_parts) -> None:
        """ONE descriptor-driven segmented Pallas launch for every
        brute-forced candidate set in the batch — chain raw segments,
        OR-union scans, masked conjunction scans alike.  Entries with
        several sources expand into one query row per (request, source)
        pair; outputs stay on device for the merge fold."""
        t0 = time.perf_counter()
        flat = self._assemble_scan_batch(queries, scan_items)
        self.wave_times["upload_ms"] += (time.perf_counter() - t0) * 1e3
        if flat is None:
            return
        (q_rows, q_owner, dstarts, dlens, downers, tres_i, tres_ow,
         tship_i, tship_ow, rows) = flat
        dev = self.to_device()
        t0 = time.perf_counter()
        v, g = ops.topk_segmented_desc(
            dev["vectors"], dev["base_ids"], dev["deleted"],
            self._rows(queries, q_rows), q_owner, dstarts, dlens, downers,
            tres_i, tres_ow, tship_i, rows, tship_ow, k,
            metric=self.metric, accum=self.accum)
        dt = time.perf_counter() - t0
        self.wave_times["launch_ms"] += dt * 1e3
        self._observe("scan", self._scan_units(scan_items), dt)
        li = len(launches)
        launches.append((v, g))
        for row, r in enumerate(q_rows):
            dev_parts[r].append((li, row))

    def _execute_scan_sq8(self, queries, scan_items, k, launches,
                          dev_parts) -> None:
        """Default SQ8 scan path (``VectorMatonConfig.quantize='sq8'``):
        the whole batch's candidate sets run ONE segmented int8 launch
        against the resident quantized table, an fp32 rerank of the
        over-fetched top-kq, and the exactness certificate
        (``quant._sq8_topk_descriptors``).  A batch whose certificate
        fails on any query row is re-run through the fp32 descriptor
        path, so results always equal the fp32 scan's; ``sq8_stats``
        counts certified vs escalated batches.  Batches the eligibility
        gate rejects outright (metric/dim/k outside ``sq8_supported``)
        fall back to the fp32 path with a one-time warning."""
        d_dim = int(queries.shape[1])
        if not sq8_supported(k, d_dim, self.metric):
            if not self._sq8_warned:
                warnings.warn(
                    f"sq8 scan path unsupported for k={k}, dim={d_dim}, "
                    f"metric={self.metric!r}; falling back to the fp32 "
                    "scan (recorded in sq8_stats['fallbacks'])",
                    RuntimeWarning, stacklevel=3)
                self._sq8_warned = True
            self.sq8_stats["fallbacks"] += 1
            self._execute_scan_device(queries, scan_items, k, launches,
                                      dev_parts)
            return
        if self.sq8_escalate and self._sq8_bad_streak >= self.SQ8_MAX_STREAK:
            # the certificate keeps failing on this workload: int8 scan
            # plus escalation is pure overhead, so serve fp32 directly
            self.sq8_stats["fallbacks"] += 1
            self._execute_scan_device(queries, scan_items, k, launches,
                                      dev_parts)
            return
        overfetch = max(1, min(4, 128 // max(k, 1)))
        t0 = time.perf_counter()
        flat = self._assemble_scan_batch(queries, scan_items)
        self.wave_times["upload_ms"] += (time.perf_counter() - t0) * 1e3
        if flat is None:
            return
        (q_rows, q_owner, dstarts, dlens, downers, tres_i, tres_ow,
         tship_i, tship_ow, rows) = flat
        dev = self.to_device()
        self.sq8_stats["batches"] += 1
        t0 = time.perf_counter()
        x = self._rows(queries, q_rows)
        v, g, cert = topk_sq8_segmented_desc(
            dev["vectors"], dev["quant"], dev["base_ids"], dev["deleted"],
            x, q_owner, dstarts, dlens, downers,
            tres_i, tres_ow, tship_i, rows, tship_ow, k,
            overfetch=overfetch)
        if not self.sq8_escalate:
            # approximate operating point: trust the rerank, never read
            # the certificate back (no device sync on the hot path)
            pass
        elif bool(cert.all()):                      # device sync
            self.sq8_stats["certified"] += 1
            self._sq8_bad_streak = 0
        else:
            # quantization noise could have pushed a true top-k candidate
            # out of the over-fetched set: redo the whole batch exactly
            v, g = ops.topk_segmented_desc(
                dev["vectors"], dev["base_ids"], dev["deleted"],
                x, q_owner, dstarts, dlens, downers,
                tres_i, tres_ow, tship_i, rows, tship_ow, k,
                metric=self.metric, accum=self.accum)
            self.sq8_stats["escalations"] += 1
            self._sq8_bad_streak += 1
        dt = time.perf_counter() - t0
        self.wave_times["launch_ms"] += dt * 1e3
        self._observe("scan", self._scan_units(scan_items), dt)
        li = len(launches)
        launches.append((v, g))
        for row, r in enumerate(q_rows):
            dev_parts[r].append((li, row))

    # ---- graph states ------------------------------------------------- #

    def _execute_graphs_host(self, queries, graph_shared, graph_filtered,
                             k, ef_search, parts) -> None:
        for u, reqs in graph_shared.items():
            g = self.graph_objs[u]
            for r in reqs:
                d, i = g.search(queries[r], k, ef_search)
                parts[r].append((d, i))
        t0 = time.perf_counter()
        n_pairs = 0
        for u, allowed, reqs in graph_filtered:
            g = self.graph_objs[u]
            n_pairs += len(reqs)
            for r in reqs:
                d, i = g.search(queries[r], k, ef_search, allowed=allowed)
                parts[r].append((d, i))
        if n_pairs:
            self._observe("filtered_graph",
                          n_pairs * max(ef_search, k),
                          time.perf_counter() - t0)

    def _graph_fetch_width(self, k: int, ef_search: int
                           ) -> Tuple[int, int, bool]:
        """Tombstone over-fetch policy (DESIGN.md §3): over-fetch
        ``k + |deleted|`` rounded to a lane multiple, but NEVER past the
        beam's ef-list capacity — slots past ef can only be padding, and
        the old unbounded ``k + len(deleted)`` silently widened the beam
        (and retraced) per tombstone.  Past the capacity the executor
        switches to in-loop bitmap filtering (tombstones skipped in-scan,
        no over-fetch at all).  Returns (kk, ef_cap, bitmap_tombs)."""
        ef_cap = max(ef_search, k)
        n_del = len(self.deleted)
        if n_del == 0:
            return k, ef_cap, False
        if k + n_del <= ef_cap:
            return min(((k + n_del + 7) // 8) * 8, ef_cap), ef_cap, False
        return k, ef_cap, True

    def _execute_graphs_device(self, queries, graph_shared, graph_filtered,
                               k, ef_search, launches, dev_parts) -> None:
        """Beam searches, one fused launch per graph size bucket: all
        (graph, query) pairs against same-bucket states vmap together —
        filtered pairs (conjunction bitmaps, or the tombstone bitmap when
        the over-fetch clamp binds) in a second launch per bucket with the
        DISTINCT masks stacked once.  ``fuse_graphs=False`` falls back to
        one launch per state (the parity oracle)."""
        if not graph_shared and not graph_filtered:
            return
        dev = self.to_device()
        dn = self._dev_n
        kk, ef_cap, bitmap_tombs = self._graph_fetch_width(k, ef_search)
        d_dim = queries.shape[1]

        def emit(vals, gids, reqs):
            li = len(launches)
            launches.append((vals, gids))
            for row, r in enumerate(reqs):
                dev_parts[r].append((li, row))

        def compose_mask(allowed: Optional[np.ndarray]) -> np.ndarray:
            """(dn,) bool: candidate bitmap ∧ ¬tombstones, host-composed.
            ``None`` means tombstones-only (the clamp fallback)."""
            dmask = np.zeros(dn, dtype=bool)
            if self.deleted:
                gone = [i for i in self.deleted if i < dn]
                dmask[gone] = True
            if allowed is None:
                return ~dmask
            am = allowed
            if len(am) < dn:
                am = np.pad(am, (0, dn - len(am)))
            return am[:dn] & ~dmask

        def to_dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        if not self.fuse_graphs:
            # legacy per-state launches (parity oracle for the fused path):
            # the fused beam over a one-graph stack of the state's arrays
            al = (to_dev(compose_mask(None))[None] if bitmap_tombs
                  else None)
            for u, reqs in graph_shared.items():
                h = dev["graphs"][u]
                zero = torch.zeros(len(reqs), dtype=torch.int64,
                                   device=self.device)
                qd = self._rows(queries, reqs)
                if al is None:
                    d, i = hnsw_search_fused(
                        dev["vectors"], h["ids"], h["level0"], h["entry"],
                        zero, qd, k=kk, ef=ef_cap, metric=self.metric)
                else:
                    d, i = hnsw_search_fused_filtered(
                        dev["vectors"], h["ids"], h["level0"], h["entry"],
                        al, zero, zero, qd, k=k, ef=ef_cap,
                        metric=self.metric)
                ops.record_launch(
                    "graph_state", (u, len(reqs), kk, ef_cap, bitmap_tombs))
                emit(d, i, reqs)
            for u, allowed, reqs in graph_filtered:
                h = dev["graphs"][u]
                zero = torch.zeros(len(reqs), dtype=torch.int64,
                                   device=self.device)
                t0 = time.perf_counter()
                d, i = hnsw_search_fused_filtered(
                    dev["vectors"], h["ids"], h["level0"], h["entry"],
                    to_dev(compose_mask(allowed))[None], zero, zero,
                    self._rows(queries, reqs), k=k,
                    ef=ef_cap, metric=self.metric)
                self._observe("filtered_graph", len(reqs) * ef_cap,
                              time.perf_counter() - t0)
                ops.record_launch(
                    "graph_state_filt", (u, len(reqs), k, ef_cap))
                emit(d, i, reqs)
            return

        # fused path: group (graph, query) pairs by size bucket
        plain: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = {}
        filt: Dict[Tuple[int, int], dict] = {}

        def add_filtered(u, mask_key, allowed, reqs):
            bkey, slot = dev["graph_slot"][u]
            fr = filt.setdefault(bkey, {"masks": [], "mkey": {},
                                        "slots": [], "midx": [],
                                        "reqs": []})
            mi = fr["mkey"].get(mask_key)
            if mi is None:
                mi = len(fr["masks"])
                fr["mkey"][mask_key] = mi
                fr["masks"].append(compose_mask(allowed))
            for r in reqs:
                fr["slots"].append(slot)
                fr["midx"].append(mi)
                fr["reqs"].append(r)

        for u, reqs in graph_shared.items():
            if bitmap_tombs:
                add_filtered(u, "tombstones", None, reqs)
                continue
            bkey, slot = dev["graph_slot"][u]
            sl, rq = plain.setdefault(bkey, ([], []))
            for r in reqs:
                sl.append(slot)
                rq.append(r)
        for u, allowed, reqs in graph_filtered:
            add_filtered(u, id(allowed), allowed, reqs)

        for bkey, (slots, reqs) in plain.items():
            b = dev["graph_buckets"][bkey]
            p = len(reqs)
            p_pad = ops.bucket(p, 8)
            gi = np.zeros(p_pad, np.int32)
            gi[:p] = slots
            qm = torch.zeros((p_pad, d_dim), dtype=torch.float32,
                             device=self.device)
            qm[:p] = self._rows(queries, reqs)
            d, i = hnsw_search_fused(
                dev["vectors"], b["ids"], b["level0"], b["entry"],
                to_dev(gi), qm, k=kk, ef=ef_cap,
                metric=self.metric)
            ops.record_launch("graph_fused",
                              (bkey, p_pad, kk, ef_cap, self.metric))
            self.traffic["query_bytes"] += p_pad * (d_dim * 4 + 4)
            self.traffic["bytes_to_device"] += p_pad * (d_dim * 4 + 4)
            emit(d[:p], i[:p], reqs)
        for bkey, fr in filt.items():
            b = dev["graph_buckets"][bkey]
            p = len(fr["reqs"])
            p_pad = ops.bucket(p, 8)
            gi = np.zeros(p_pad, np.int32)
            gi[:p] = fr["slots"]
            mi_arr = np.zeros(p_pad, np.int32)
            mi_arr[:p] = fr["midx"]
            qm = torch.zeros((p_pad, d_dim), dtype=torch.float32,
                             device=self.device)
            qm[:p] = self._rows(queries, fr["reqs"])
            mn_pad = ops.bucket(len(fr["masks"]), 1)
            mm = np.zeros((mn_pad, dn), dtype=bool)
            for j, m in enumerate(fr["masks"]):
                mm[j] = m
            t0 = time.perf_counter()
            d, i = hnsw_search_fused_filtered(
                dev["vectors"], b["ids"], b["level0"], b["entry"],
                to_dev(mm), to_dev(mi_arr), to_dev(gi),
                qm, k=k, ef=ef_cap, metric=self.metric)
            self._observe("filtered_graph", p * ef_cap,
                          time.perf_counter() - t0)
            ops.record_launch("graph_fused_filt",
                              (bkey, p_pad, mn_pad, k, ef_cap, self.metric))
            self.traffic["mask_bytes"] += mn_pad * dn
            self.traffic["query_bytes"] += p_pad * (d_dim * 4 + 4)
            self.traffic["bytes_to_device"] += (mn_pad * dn
                                                + p_pad * (d_dim * 4 + 4))
            emit(d[:p], i[:p], fr["reqs"])

    # ---- residual verification (strategy c) --------------------------- #

    def _dense_dist(self, qmat, cand: np.ndarray):
        """The (Q, |cand|) dense distance matrix of ``qmat`` (the wave's
        device rows on torch, an array on numpy) against
        ``vectors[cand]`` — computed ONCE per residual source and kept on
        the backend that computed it (device tensor on torch, ndarray on
        numpy) so the over-fetch loop re-ranks without recomputing or
        shipping the whole matrix."""
        if self.backend == "torch":
            x = qmat                      # the wave's device rows
            y = self._device_rows(np.asarray(cand))
            if self.metric == "l2":
                d = ((x * x).sum(1, keepdim=True) + (y * y).sum(1)
                     - 2.0 * x @ y.T)
                return d.clamp_min(0.0)
            return -(x @ y.T)
        x = np.asarray(qmat, dtype=np.float32)
        y = np.asarray(self.vectors[cand], dtype=np.float32)
        if self.metric == "l2":
            d = (np.sum(x * x, axis=1, keepdims=True)
                 + np.sum(y * y, axis=1) - 2.0 * (x @ y.T))
            np.maximum(d, 0.0, out=d)
            return d
        return -(x @ y.T)

    def _rank_topm(self, dmat, m: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-m (ascending distances, column indices) of a cached dense
        distance matrix; only the (Q, m) winners cross to the host.  m is
        unbounded (the over-fetch loop outgrows the 128-wide scan
        kernels), so the device path takes the first m of a stable sort
        (lower column first on ties, as ``lax.top_k``)."""
        m = min(m, int(dmat.shape[1]))
        if self.backend == "torch":
            pos = torch.argsort(dmat, dim=1, stable=True)[:, :m]
            return _to_host(dmat.gather(1, pos)), _to_host(pos)
        part = np.argpartition(dmat, m - 1, axis=1)[:, :m]
        pv = np.take_along_axis(dmat, part, axis=1)
        order = np.argsort(pv, axis=1, kind="stable")
        return (np.take_along_axis(pv, order, axis=1),
                np.take_along_axis(part, order, axis=1))

    def _execute_residual(self, queries, e: PlanEntry, s: CompiledSource,
                          k: int, parts) -> None:
        """Over-fetch + exact host-side verification: compute the dense
        distance matrix ONCE (kept on its backend), rank the top-m, and
        verify hits in distance order, doubling m — a re-rank of the
        cached matrix plus more verification, never a distance recompute
        — until every request has k verified hits (or the prefilter is
        exhausted).  The old loop recomputed the full dense distance
        matrix every round, paying O(rounds · Q · |cand| · d) for
        distances it already had; only the (Q, m) winners ever cross to
        the host.

        Adaptive escalation (DESIGN.md §11): the loop tracks observed
        verification yield; when a row's projected need ``k/yield``
        already covers the whole prefilter — the doubling ramp would
        provably walk every candidate anyway — it jumps straight to the
        full scan instead of re-ranking through the remaining doublings,
        reports the switch to the planner (``planner_residual_switches``)
        and remembers it per (predicate, delta version) so a re-compile
        starts there (``CompiledSource.residual_full``).  Result-
        identical: the top-m ranking of the cached matrix is prefix-
        stable in m, and assembly still stops at k verified hits."""
        t_start = time.perf_counter()
        cand = self._live(s.ids)
        if len(cand) == 0:
            return
        seqs = self.sequences
        cache: Dict[int, bool] = {}

        def ok(gid: int) -> bool:
            v = cache.get(gid)
            if v is None:
                v = bool(s.verify.matches(seqs[gid], self._attrs_of(gid)))
                cache[gid] = v
            return v

        reqs = e.requests
        adaptive = (self.planner is not None
                    and getattr(self.planner, "adaptive", False))
        dmat = self._dense_dist(
            self._rows(queries, reqs) if isinstance(queries, torch.Tensor)
            else queries[reqs], cand)
        m = (len(cand) if (s.residual_full and adaptive)
             else min(len(cand), max(4 * k, k)))
        while True:
            d, li = self._rank_topm(dmat, m)
            done = True
            checked = cnt = 0
            for row in range(len(reqs)):
                cnt = checked = 0
                for c in li[row]:
                    if c < 0:
                        break
                    checked += 1
                    if ok(int(cand[c])):
                        cnt += 1
                        if cnt >= k:
                            break
                if cnt < k:
                    done = False
                    break
            if done or m >= len(cand):
                break
            grown = min(2 * m, len(cand))
            if adaptive and checked:
                # yield-collapse switch: the failing row verified cnt of
                # checked ranked candidates, so it needs ~k·checked/cnt
                # ranked rows; once that projection covers the whole
                # prefilter AND the next doubling wouldn't, escalate to
                # the full scan in one step
                need = (k * checked) // max(cnt, 1)
                if need >= len(cand) and grown < len(cand):
                    m = len(cand)
                    s.residual_full = True
                    self.planner.note_residual_switch(
                        e.key, int(self.delta.version))
                    continue
            m = grown
        self._observe("residual", m * len(reqs),
                      time.perf_counter() - t_start)
        for row, r in enumerate(reqs):
            vd: List[float] = []
            vi: List[int] = []
            for pos, c in enumerate(li[row]):
                if c < 0:
                    break
                gid = int(cand[c])
                if ok(gid):
                    vd.append(float(d[row][pos]))
                    vi.append(gid)
                    if len(vi) == k:
                        break
            parts[r].append((np.asarray(vd, np.float32),
                             np.asarray(vi, np.int64)))

    # ------------------------------------------------------------------ #
    # accounting
    # ------------------------------------------------------------------ #

    def chain_ids(self, state: int) -> np.ndarray:
        """V_state reconstructed from the CSR chain cover (Lemma 4)."""
        segs = []
        u = state
        while u != -1:
            segs.append(self.base_ids[self.base_ptr[u]:self.base_ptr[u + 1]])
            u = int(self.inherit[u])
        return (np.concatenate(segs) if segs else np.empty(0, np.int64))

    def stats(self) -> Dict[str, int]:
        return {
            "states": len(self.kind),
            "raw_states": int((self.kind == KIND_RAW).sum()),
            "graph_states": int((self.kind == KIND_GRAPH).sum()),
            "base_entries": int(self.base_ptr[-1]),
            "attr_segments": self.n_csr - self.n_states,
            "device_resident": int(self._dev is not None),
            "generation": self.generation,
            "delta_pending": self.delta.pending,
        }
