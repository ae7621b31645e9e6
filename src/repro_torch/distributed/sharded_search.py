"""Distributed vector search over the row shards of a mesh.

Port of ``src/repro/distributed/sharded_search.py``.  The packed
generation is row-sharded over the mesh's ``data`` axis at upload time —
vector table, tombstone bitmap, SQ8 table and a **shard-local CSR** (each
state's base-ID segment re-grouped by owning shard, ids rebased to local
rows) — and a warm query batch runs on the shards' devices:

  * each plan entry's predicate lowers to per-shard ``(seg_start,
    seg_len, owner)`` **descriptors** against the local CSR (frozen chain
    covers) or to a per-shard candidate tail cached on device keyed by
    ``(predicate key, delta version)`` (bitmap compositions, residual-
    verified sets, resident delta ids) — no dense ``(N,)`` mask is built
    or shipped on the warm path;
  * every shard expands its descriptors, gathers its rows and runs ONE
    launch of kernel A (``topk_seg_f32``) — or, under ``quantize="sq8"``,
    ONE launch of kernel B (``qtopk_seg_sq8``) plus an fp32 rerank and the
    exactness certificate — for all of the batch's entries; the shards'
    winners fold on the mesh's first device (``ops.merge_topk_allgather``);
  * delta overflow keeps the §4 contract: qualified ids past the shard
    watermark are brute-forced host-side and merged, so answers stay
    exact mid-churn.

Where the reference runs one ``shard_map`` over the shards, the port
loops over them in one process: S shards make S kernel launches a wave.
Shards that share a device are row slices of one tensor on it, so
``make_host_mesh(data=4, device="cuda")`` holds the table once on the
card.  On a CPU device the kernels' plain versions run.

``sharded_topk`` is the raw numeric primitive (arbitrary ``N`` on any
mesh; pad rows never win); ``PackedRuntime.shard_descriptors = False``
forces the dense-mask path (one mask and one sweep per entry), kept as
the parity oracle.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import distance_topk, ops, quant

_EMPTY_I = np.empty(0, np.int64)
_INF = float("inf")


@dataclass
class _Block:
    """Consecutive shards ``[s0, s1)`` that live on one device: their rows
    are one tensor there, and each shard's table is a slice of it."""
    device: torch.device
    s0: int
    s1: int


def _blocks(devices: List[torch.device]) -> List[_Block]:
    out: List[_Block] = []
    for s, dev in enumerate(devices):
        if out and out[-1].device == dev:
            out[-1].s1 = s + 1
        else:
            out.append(_Block(dev, s, s + 1))
    return out


def _split(blocks: List[_Block], tensors: List[torch.Tensor], rows: int
           ) -> List[torch.Tensor]:
    """Per-shard views: shard s is rows ``[(s − s0)·rows, +rows)`` of its
    block's tensor."""
    return [t[(s - b.s0) * rows:(s - b.s0 + 1) * rows]
            for b, t in zip(blocks, tensors) for s in range(b.s0, b.s1)]


def _upload_i32(device: torch.device, *arrays: np.ndarray
                ) -> List[torch.Tensor]:
    """One host-to-device copy of several small int32 arrays; returns a
    view of each in its shape."""
    flat = np.concatenate([np.ravel(a).astype(np.int32, copy=False)
                           for a in arrays])
    t = torch.from_numpy(flat).to(device)
    out, off = [], 0
    for a in arrays:
        out.append(t[off:off + a.size].view(a.shape))
        off += a.size
    return out


def _shard_topk_merge(q_dev: Dict[torch.device, torch.Tensor],
                      tables: List[torch.Tensor], local_n: int, n: int,
                      k: int, metric: str,
                      masks: Optional[List[torch.Tensor]]):
    """Per shard, one kernel A launch of every query row against the
    shard's rows (pad rows past ``n`` and rows ``masks`` rules out get
    owner −1), then the cross-shard fold on the first shard's device."""
    kp = ops._check_k(k)
    outs_v, outs_i = [], []
    for s, table in enumerate(tables):
        dev = table.device
        q = q_dev[dev]
        col_g = s * local_n + torch.arange(local_n, device=dev)
        valid = col_g < n
        if masks is not None:
            valid = valid & masks[s]
        owners = torch.where(valid, 0, -1).to(torch.int32)
        qseg = torch.zeros(q.shape[0], dtype=torch.int32, device=dev)
        vals, idx = distance_topk.topk_seg_f32(q, table, qseg, owners, kp,
                                               metric=metric)
        vals, idx = vals[:, :k], idx[:, :k].long()
        outs_v.append(vals)
        outs_i.append(torch.where(idx >= 0, s * local_n + idx, -1))
    dev0 = tables[0].device
    return ops.merge_topk_allgather(
        torch.stack([v.to(dev0) for v in outs_v]),
        torch.stack([i.to(dev0) for i in outs_i]), k)


def sharded_topk(mesh, queries, base, k: int, *, metric: str = "l2",
                 axis: str = "data", valid_mask=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``queries`` (Q, d) against ``base`` (N, d) split
    into ``mesh.shape[axis]`` row shards, each on its device.

    ``valid_mask`` (N,) bool — e.g. the pattern-qualified subset V_p of a
    VectorMaton state; invalid rows never win.  ``N`` may be arbitrary:
    the table is padded to a shard multiple and pad rows are masked in
    the sweep.  Returns (dists (Q, k), global indices (Q, k)) on the
    mesh's first device; unfilled slots — fewer than ``k`` qualifying
    rows — are ``(+inf, -1)``, as ``ops.topk_numpy`` pads."""
    devices = mesh.axis_devices(axis)
    shards = len(devices)
    base = torch.as_tensor(base, dtype=torch.float32)
    n = int(base.shape[0])
    local_n = max(1, -(-n // shards))
    n_pad = local_n * shards
    mask = (None if valid_mask is None
            else torch.as_tensor(valid_mask, dtype=torch.bool))
    if n_pad != n:
        base = torch.cat([base, base.new_zeros((n_pad - n, base.shape[1]))])
        if mask is not None:
            mask = torch.cat([mask, mask.new_zeros(n_pad - n)])
    tables = [base[s * local_n:(s + 1) * local_n].to(dev).contiguous()
              for s, dev in enumerate(devices)]
    masks = (None if mask is None else
             [mask[s * local_n:(s + 1) * local_n].to(dev)
              for s, dev in enumerate(devices)])
    q = torch.as_tensor(queries, dtype=torch.float32)
    q_dev = {dev: q.to(dev).contiguous() for dev in set(devices)}
    return _shard_topk_merge(q_dev, tables, local_n, n, k, metric, masks)


# ===================================================================== #
# sharded device residency (one per (generation, mesh, watermark))
# ===================================================================== #

@dataclass
class _EntrySpec:
    """Device-executable form of one plan entry against one residency.

    ``states``: frozen chain states whose covers run as per-shard CSR
    descriptors (zero upload).  ``ranges``: partial attribute-segment
    slices ``(pseudo_state, rank_lo, rank_hi)`` — a numeric Range leaf;
    the dispatcher intersects the global rank window with each shard's
    rank run to get per-shard descriptor columns (still zero upload).
    ``tails``: per block, a (shards in block, t_pad) tensor of local row
    ids resident on device (-1 padding) — bitmap compositions, residual
    survivors, resident delta ids — uploaded once and cached.  ``extra``:
    qualified ids past the shard watermark, brute-forced host-side."""
    states: List[int]
    tails: Optional[List[torch.Tensor]]
    t_pad: int
    extra: np.ndarray
    ranges: List[Tuple[int, int, int]] = field(default_factory=list)


class ShardedDeviceIndex:
    """Row-sharded residency of one ``PackedRuntime`` generation.

    Built once per (mesh, axis, watermark) by
    ``PackedRuntime.to_device_sharded``; holds the sharded vector table,
    the sharded tombstone bitmap, the SQ8 table, the shard-local CSR, and
    the per-predicate spec cache.  Each per-shard attribute is a list
    indexed by shard of views into one tensor per block of shards that
    share a device.  The watermark ``n`` freezes which rows are resident
    — later delta inserts overflow to the host brute force exactly like
    the single-device upload watermark (DESIGN.md §4).
    """

    PRED_CACHE_MAX = 256
    TAILS_CACHE_MAX = 64

    def __init__(self, runtime, mesh, axis: str = "data",
                 n: Optional[int] = None) -> None:
        self.rt = runtime
        self.mesh = mesh
        self.axis = axis
        self.devices = mesh.axis_devices(axis)
        self.shards = len(self.devices)
        self.blocks = _blocks(self.devices)
        n = int(n) if n is not None else len(runtime.vectors)
        self.n = n
        self.local_n = max(1, -(-n // self.shards))
        self.n_pad = self.local_n * self.shards
        d = runtime.vectors.shape[1]
        ln = self.local_n
        vec_blocks, del_blocks = [], []
        dmask = np.zeros(self.n_pad, dtype=bool)
        if runtime.deleted:
            dmask[[i for i in runtime.deleted if i < n]] = True
        for b in self.blocks:
            lo, hi = b.s0 * ln, b.s1 * ln
            t = torch.zeros((hi - lo, d), dtype=torch.float32,
                            device=b.device)
            m = max(0, min(hi, n) - lo)
            if m:
                t[:m] = torch.from_numpy(np.ascontiguousarray(
                    runtime.vectors[lo:lo + m], dtype=np.float32)).to(
                        b.device)
            vec_blocks.append(t)
            del_blocks.append(torch.from_numpy(dmask[lo:hi].copy()).to(
                b.device))
        self._vec_blocks = vec_blocks
        self.vectors = _split(self.blocks, vec_blocks, ln)
        self._deleted_blocks = del_blocks
        self.deleted = _split(self.blocks, del_blocks, ln)
        self._del_seen = set(runtime.deleted)
        self.quant = None
        if getattr(runtime, "quantize", "none") == "sq8":
            self.quantize()
        # ---- shard-local CSR: per state, the segment's ids re-grouped by
        # owning shard and rebased to local row indices.  A chain cover on
        # shard s is then the descriptor (csr_ptr[s][u], length) per chain
        # state u — host-resolvable integers, never a mask.
        base_ids = np.asarray(runtime.base_ids, dtype=np.int64)
        # n_csr counts chain states PLUS the attribute pseudo-segments
        # appended at build time — both address the same shard-local CSR
        n_csr = len(runtime.base_ptr) - 1
        state_of = np.repeat(np.arange(n_csr, dtype=np.int64),
                             np.diff(runtime.base_ptr))
        resident = base_ids < n
        ids_r, st_r = base_ids[resident], state_of[resident]
        owner = ids_r // ln
        local = (ids_r % ln).astype(np.int32)
        # shard-major, state-minor, original order within — one stable sort
        order = np.lexsort((np.arange(len(ids_r)), st_r, owner))
        per = np.bincount(owner * n_csr + st_r,
                          minlength=self.shards * n_csr
                          ).reshape(self.shards, n_csr)
        ptr = np.zeros((self.shards, n_csr + 1), np.int64)
        np.cumsum(per, axis=1, out=ptr[:, 1:])
        shard_len = ptr[:, -1]
        l_pad = ops.bucket(int(shard_len.max()) if len(ids_r) else 1, 8)
        csr = np.zeros((self.shards, l_pad), np.int32)
        sorted_local = local[order]
        off = 0
        for s in range(self.shards):
            m = int(shard_len[s])
            csr[s, :m] = sorted_local[off:off + m]
            off += m
        self.csr_ptr = ptr                      # host: descriptor lookup
        self.csr_local = [
            v[0] for v in _split(self.blocks, [
                torch.from_numpy(csr[b.s0:b.s1]).to(b.device)
                for b in self.blocks], 1)]
        # base ids past the watermark (a sharded table older than the
        # generation's vector table): per-state host overflow, merged
        # with the delta extras at query time
        self._overflow: Dict[int, np.ndarray] = {}
        if not resident.all():
            ids_o, st_o = base_ids[~resident], state_of[~resident]
            for u in np.unique(st_o):
                self._overflow[int(u)] = ids_o[st_o == u]
        # ---- attribute pseudo-segments (DESIGN.md §9): a Range leaf is a
        # RANK window [a, b) of one value-sorted segment.  The lexsort
        # above is stable in original segment order, so within (shard,
        # state) the shard-local run preserves ascending global rank —
        # a global rank window is therefore CONTIGUOUS per shard, located
        # by binary search over each shard's rank run.  Non-resident
        # members keep their ranks so overflow respects the window too.
        self._seg_ranks: Dict[int, List[np.ndarray]] = {}
        self._rank_overflow: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        ptr_g = np.asarray(runtime.base_ptr, dtype=np.int64)
        for u in range(runtime.n_states, n_csr):
            lo, hi = int(ptr_g[u]), int(ptr_g[u + 1])
            seg = base_ids[lo:hi]
            ranks = np.arange(hi - lo, dtype=np.int64)
            rm = seg < n
            ow = seg[rm] // ln
            rr = ranks[rm]
            self._seg_ranks[u] = [rr[ow == s] for s in range(self.shards)]
            if not rm.all():
                self._rank_overflow[u] = (ranks[~rm], seg[~rm])
        # (predicate key, delta version) -> _EntrySpec, LRU + stale purge
        self._pred_cache: "OrderedDict[Tuple, _EntrySpec]" = OrderedDict()
        # batch-signature -> concatenated tails (warm waves re-use the
        # device-side concat instead of re-emitting it every wave)
        self._tails_cache: "OrderedDict[Tuple, List[torch.Tensor]]" = (
            OrderedDict())

    def quantize(self) -> None:
        """Derive the resident int8 table (codes, scale, sqnorm, code-L1)
        from the fp32 shards on their devices, sharded like them: the
        SQ8 sweep gathers these per candidate and only touches fp32 rows
        for the (Q, kq) rerank gather.  Pad rows quantize to all-zero
        codes and are owner-masked anyway.  Runs at build under
        ``quantize="sq8"``, and at the first SQ8 batch of a runtime
        toggled to it later."""
        per_block = [quant.quantize_sq8_ext(t) for t in self._vec_blocks]
        parts = [_split(self.blocks, [pb[j] for pb in per_block],
                        self.local_n) for j in range(4)]
        self.quant = list(zip(*parts))

    # ------------------------------------------------------------------ #
    def sync_tombstones(self, deleted: set) -> None:
        """Fold deletes that landed after this residency was built into
        the resident bitmap — one in-place write per block of shards in a
        batch that saw new deletes, not a mask re-upload."""
        if len(deleted) == len(self._del_seen):
            return
        new = np.asarray(sorted(i for i in deleted - self._del_seen
                                if i < self.n), dtype=np.int64)
        for b, mask in zip(self.blocks, self._deleted_blocks):
            lo = b.s0 * self.local_n
            mine = new[(new >= lo) & (new < b.s1 * self.local_n)] - lo
            if len(mine):
                mask[torch.from_numpy(mine).to(b.device)] = True
        self._del_seen = set(deleted)

    # ------------------------------------------------------------------ #
    def entry_spec(self, entry, delta_version: int) -> _EntrySpec:
        """Cached lowering of one plan entry (DESIGN.md §5): purge
        version-stale entries, refresh recency on hit, evict LRU."""
        key = (entry.key, delta_version)
        spec = self._pred_cache.get(key)
        if spec is not None:
            self._pred_cache.move_to_end(key)
            return spec
        for stale in [kk for kk in self._pred_cache
                      if kk[1] != delta_version]:
            del self._pred_cache[stale]
        while len(self._pred_cache) >= self.PRED_CACHE_MAX:
            self._pred_cache.popitem(last=False)
        spec = self._build_spec(entry)
        self._pred_cache[key] = spec
        return spec

    def _build_spec(self, entry) -> _EntrySpec:
        n = self.n
        srcs = entry.sources
        if len(srcs) == 1 and srcs[0].strategy == "chain":
            # frozen chain cover -> descriptors; resident delta -> tail;
            # post-watermark delta (and overflow base ids) -> host extras.
            # Cover segments are disjoint (Lemma 4) and disjoint from the
            # delta, so the candidate pool carries no duplicates.
            s = srcs[0]
            states = list(s.seg_states)
            ranges = [(int(u), int(a), int(b))
                      for u, a, b in getattr(s, "attr_ranges", [])]
            delta = (np.asarray(s.delta_ids, np.int64)
                     if s.delta_ids is not None else _EMPTY_I)
            res = delta[delta < n]
            extras = [delta[delta >= n]]
            extras += [self._overflow[u] for u in states
                       if u in self._overflow]
            # partial attr windows: only overflow ids whose RANK falls
            # inside [a, b) qualify
            for u, a, b in ranges:
                if u in self._rank_overflow:
                    rk, ids_o = self._rank_overflow[u]
                    extras.append(ids_o[(rk >= a) & (rk < b)])
        else:
            # boolean composition / residual: the exact member set is
            # host-computed once (residual verification included) and the
            # resident half lives on device from then on — the dense mask
            # never ships
            mask = self.rt.entry_mask(entry)
            ids = np.nonzero(mask)[0].astype(np.int64)
            states = []
            ranges = []
            res = ids[ids < n]
            extras = [ids[ids >= n]]
        tails, t_pad = (self._upload_tails(res) if len(res)
                        else (None, 0))
        extra = (np.sort(np.concatenate(extras)) if any(len(x) for x in
                                                        extras)
                 else _EMPTY_I)
        return _EntrySpec(states=states, tails=tails, t_pad=t_pad,
                          extra=extra, ranges=ranges)

    def _upload_tails(self, ids: np.ndarray
                      ) -> Tuple[List[torch.Tensor], int]:
        """Group explicit resident candidate ids by owning shard, rebase
        to local rows, pad to a bucket, upload per block.  Happens once
        per (predicate, delta version) — the warm path replays the
        resident tensors."""
        owner = ids // self.local_n
        local = (ids % self.local_n).astype(np.int32)
        cnt = np.bincount(owner, minlength=self.shards)
        t_pad = ops.bucket(int(cnt.max()), 8)
        arr = np.full((self.shards, t_pad), -1, np.int32)
        order = np.argsort(owner, kind="stable")
        sorted_local = local[order]
        off = 0
        for s in range(self.shards):
            arr[s, :cnt[s]] = sorted_local[off:off + cnt[s]]
            off += int(cnt[s])
        tf = self.rt.traffic
        tf["shard_tail_bytes"] += int(arr.nbytes)
        tf["bytes_to_device"] += int(arr.nbytes)
        return [torch.from_numpy(arr[b.s0:b.s1]).to(b.device)
                for b in self.blocks], t_pad

    def batch_tails(self, tail_parts: List[Tuple[object, List, int]],
                    t_pad_total: int, delta_version: int
                    ) -> List[torch.Tensor]:
        """Concatenate the batch's per-entry resident tails along the
        candidate axis (per block, on its device) and pad to the bucket.
        Cached per batch signature — the ordered predicate keys plus the
        delta version, which fully determine the concatenated id content
        (specs are rebuilt deterministically per (key, version)); a
        steady-state wave replays one resident tensor per block.  Owner
        ids are NOT baked in: they depend on the batch's entry order and
        ship as planning integers per wave."""
        key = (tuple((ekey, tp) for ekey, _, tp in tail_parts),
               t_pad_total, delta_version)
        hit = self._tails_cache.get(key)
        if hit is not None:
            self._tails_cache.move_to_end(key)
            return hit
        for stale in [kk for kk in self._tails_cache
                      if kk[2] != delta_version]:
            del self._tails_cache[stale]    # dead: version can't hit again
        cat = []
        for j, b in enumerate(self.blocks):
            parts = [arrs[j] for _, arrs, _ in tail_parts]
            t = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
            if t.shape[1] < t_pad_total:
                t = torch.nn.functional.pad(
                    t, (0, t_pad_total - t.shape[1]), value=-1)
            cat.append(t)
        while len(self._tails_cache) >= self.TAILS_CACHE_MAX:
            self._tails_cache.popitem(last=False)
        self._tails_cache[key] = cat
        return cat


# ===================================================================== #
# the sweep: one kernel launch per shard for a whole batch of entries
# ===================================================================== #

@dataclass
class _Wave:
    """One wave's launch inputs on one block's device: the bucketed query
    rows and owners, the replicated descriptor and tail owners, and the
    block's per-shard descriptor columns and tails."""
    q: torch.Tensor            # (Qp, d) fp32
    qseg: torch.Tensor         # (Qp,) int32
    downer: torch.Tensor       # (Dp,) int32
    towner: torch.Tensor       # (Tp,) int32
    dstart: torch.Tensor       # (shards in block, Dp) int32
    dlen: torch.Tensor         # (shards in block, Dp) int32
    tails: torch.Tensor        # (shards in block, Tp) int32


def _shard_candidates(sh: ShardedDeviceIndex, w: _Wave, s: int, j: int,
                      n_desc: int):
    """Shard ``s`` (row ``j`` of its block): descriptor expansion then the
    tail, as local row ids and owners; tombstoned rows and padding get
    the unmatchable owner −3."""
    t1 = w.tails[j]
    return distance_topk.resident_candidates(
        sh.csr_local[s], sh.deleted[s], w.dstart[j], w.dlen[j], w.downer,
        t1.clamp_min(0), torch.where(t1 >= 0, w.towner, -3), n_desc)


def _global_ids(s: int, local_n: int, cand: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    nc = int(cand.shape[0])
    return torch.where(idx >= 0, s * local_n
                       + cand.long()[idx.clamp(0, nc - 1)], -1)


def _sweep(sh: ShardedDeviceIndex, waves: List[_Wave], n_desc: int, k: int,
           metric: str):
    """The fp32 sweep: per shard, ONE kernel A launch over its candidates,
    then the cross-shard fold.  Returns (vals, gids) (Qp, k) on the first
    shard's device."""
    kp = ops._check_k(k)
    outs_v, outs_i = [], []
    for b, w in zip(sh.blocks, waves):
        for j, s in enumerate(range(b.s0, b.s1)):
            cand, own = _shard_candidates(sh, w, s, j, n_desc)
            y = sh.vectors[s][cand.long()]
            vals, idx = distance_topk.topk_seg_f32(w.q, y, w.qseg, own, kp,
                                                   metric=metric)
            outs_v.append(vals[:, :k])
            outs_i.append(_global_ids(s, sh.local_n, cand,
                                      idx[:, :k].long()))
    dev0 = sh.devices[0]
    return ops.merge_topk_allgather(
        torch.stack([v.to(dev0) for v in outs_v]),
        torch.stack([i.to(dev0) for i in outs_i]), k)


def _sweep_sq8(sh: ShardedDeviceIndex, waves: List[_Wave], n_desc: int,
               k: int, kq: int):
    """The quantized twin of ``_sweep``: per shard, ONE kernel B launch to
    the top-kq quantized candidates, an exact fp32 rerank of ONLY those
    rows (GEMM form), and the per-shard exactness certificate
    (``kernels.quant`` module docstring).  The third output is the
    batch-global count of uncertified query rows, summed over shards (the
    reference's psum): zero means the merged result provably equals the
    fp32 sweep's; the caller escalates otherwise."""
    outs_v, outs_i, bads = [], [], []
    dev0 = sh.devices[0]
    for b, w in zip(sh.blocks, waves):
        qp, d_dim = int(w.q.shape[0]), int(w.q.shape[1])
        xq, sx, x2, xl1 = quant.quantize_sq8_ext(w.q)
        x2r = (w.q * w.q).sum(-1, keepdim=True)
        for j, s in enumerate(range(b.s0, b.s1)):
            cand, own = _shard_candidates(sh, w, s, j, n_desc)
            ci = cand.long()
            nc = int(cand.shape[0])
            yq, sy, y2, yl1 = (a[ci] for a in sh.quant[s])
            kqe = min(kq, nc)
            vals_q, idx = quant.qtopk_seg_sq8(
                xq, yq, sx[:, 0], x2[:, 0], sy[:, 0].contiguous(),
                y2[:, 0].contiguous(), w.qseg, own, ops._round_up(kqe, 8))
            vals_q, idx = vals_q[:, :kqe], idx[:, :kqe].long()
            # exact fp32 rerank of the shard-local winners only
            rows = sh.vectors[s][ci[idx.clamp(0, nc - 1)]]   # (Q, kqe, d)
            xy = torch.bmm(rows, w.q[:, :, None])[..., 0]
            c2 = (rows * rows).sum(-1)
            d2 = (x2r + c2 - 2.0 * xy).clamp_min(0.0)
            d2 = torch.where(idx >= 0, d2, _INF)
            ke = min(k, kqe)
            pos = torch.argsort(d2, dim=1, stable=True)[:, :ke]
            fidx = idx.gather(1, pos)
            vals = torch.where(fidx >= 0, d2.gather(1, pos), _INF)
            gid = _global_ids(s, sh.local_n, cand, fidx)
            if ke < k:
                vals = torch.nn.functional.pad(vals, (0, k - ke),
                                               value=_INF)
                gid = torch.nn.functional.pad(gid, (0, k - ke), value=-1)
            outs_v.append(vals)
            outs_i.append(gid)
            if nc <= kq:
                continue      # every shard-local candidate was reranked
            live = own >= 0
            u = torch.where(live, sy[:, 0], 0.0)
            t = torch.where(live, sy[:, 0] * (yl1[:, 0] + d_dim / 2.0), 0.0)
            umax, tmax = quant.owner_max(
                own.long().clamp(0, qp - 1), torch.stack([u, t], 1),
                qp).unbind(1)
            oq = w.qseg.long().clamp(0, qp - 1)
            eps = sx[:, 0] * (xl1[:, 0] * umax[oq] + tmax[oq])
            qkq = vals_q[:, -1]
            dk = vals[:, k - 1]
            margin = eps + 1e-5 * (qkq.abs() + dk.abs()) + 1e-12
            cert = torch.isposinf(qkq) | (dk < qkq - margin)
            bads.append((~cert).sum().to(dev0))
    mv, mi = ops.merge_topk_allgather(
        torch.stack([v.to(dev0) for v in outs_v]),
        torch.stack([i.to(dev0) for i in outs_i]), k)
    bad = (torch.stack(bads).sum() if bads
           else torch.zeros((), dtype=torch.int64, device=dev0))
    return mv, mi, bad


# ===================================================================== #
# plan executor
# ===================================================================== #

def _extras_block(runtime, queries_np: np.ndarray, entry,
                  extra_ids: np.ndarray, metric: str):
    """Delta-overflow fold, shared by the descriptor and dense paths:
    drop tombstoned overflow ids and compute their host-side distance
    block against the entry's requests (the overflow is bounded by the
    compaction threshold, DESIGN.md §4)."""
    if len(extra_ids) and runtime.deleted:
        extra_ids = extra_ids[~np.isin(
            extra_ids, np.fromiter(runtime.deleted, dtype=np.int64))]
    if not len(extra_ids):
        return None, extra_ids
    ev = np.asarray(runtime.vectors[extra_ids], dtype=np.float32)
    qm = queries_np[entry.requests]
    if metric == "l2":
        ed = ((qm[:, None, :] - ev[None, :, :]) ** 2).sum(-1)
    else:
        ed = -(qm @ ev.T)
    return ed, extra_ids


def _merge_extras_row(dr: np.ndarray, ir: np.ndarray, ed_row: np.ndarray,
                      extra_ids: np.ndarray, k: int):
    """Stable-sort merge of one request's device winners with its host
    overflow block — the same tie-breaking as the single-device merge, so
    the descriptor and dense paths stay bit-identical."""
    dr = np.concatenate([dr, ed_row.astype(np.float32)])
    ir = np.concatenate([ir, extra_ids])
    order = np.argsort(dr, kind="stable")[:k]
    return dr[order], ir[order]


@dataclass
class ShardedPending:
    """In-flight result of ``sharded_plan_dispatch`` (DESIGN.md §7).

    ``dv``/``gv`` are the sweep's (rows, k) outputs on the mesh's first
    device; CUDA launches are asynchronous, so the sweep may still be
    running when dispatch returns.  On a card, dispatch ends by queueing
    their copies into pinned host tensors (``host``) behind the event
    ``ready``, so ``sharded_plan_fetch`` waits for this wave alone before
    it runs the sentinel filter + delta-overflow merge.  The SQ8
    certificate (``int(bad)``) is an inherent sync point and is resolved
    INSIDE dispatch — escalation to the fp32 sweep must happen before the
    launch set is final."""
    plan: object
    k: int
    metric: str
    queries_np: np.ndarray
    specs: List[_EntrySpec]
    out: List[Tuple[np.ndarray, np.ndarray]]
    dv: Optional[torch.Tensor] = None
    gv: Optional[torch.Tensor] = None
    host: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    ready: Optional[torch.cuda.Event] = None
    fetched: bool = False


def sharded_plan_topk(mesh, base, runtime, queries, plan, k: int, *,
                      metric: str = "l2", axis: str = "data"):
    """Execute a batched QueryPlan against the row-sharded generation.

    ``runtime`` is the PackedRuntime whose CSR the plan indexes into;
    ``plan`` comes from ``runtime.plan(...)`` / ``VectorMaton.plan(...)``.
    ``base`` fixes the shard watermark: an integer row count, a table
    whose length is the watermark (only its length is read; the
    residency gathers rows from the runtime itself), or ``None`` to
    freeze the runtime's current table length on first use.  Returns
    [(dists, ids)] aligned with the request batch; tombstoned IDs never
    win.

    Warm-path traffic per batch is the query matrix plus per-shard
    descriptor triples (``shard_descriptor_bytes``); per-predicate
    resident tails upload once into the spec cache
    (``shard_tail_bytes``); NO dense per-entry mask is built or shipped
    (``shard_mask_bytes`` stays 0 — the path behind
    ``runtime.shard_descriptors = False`` is the parity oracle, which
    matches up to exact-distance ties between DISTINCT ids: the
    descriptor pool is CSR-expansion order, the dense pool ascending row
    order).  All entries execute through one kernel launch per shard with
    the cross-shard top-k folded on device.

    Delta overflow (DESIGN.md §4): qualified ids past the shard
    watermark — inserts still sitting in the runtime's delta, pending
    compaction and re-shard — are brute-forced host-side against the
    runtime's live vector view and merged into each request's top-k, so
    answers remain exact mid-churn.
    """
    return sharded_plan_fetch(runtime, sharded_plan_dispatch(
        mesh, base, runtime, queries, plan, k, metric=metric, axis=axis))


def sharded_plan_dispatch(mesh, base, runtime, queries, plan, k: int, *,
                          metric: str = "l2",
                          axis: str = "data") -> ShardedPending:
    """Launch the sharded sweep for a batched QueryPlan WITHOUT syncing
    on the merged top-k (DESIGN.md §7): staleness checks, entry
    lowering, descriptor/tail assembly and the per-shard launches all run
    here; the (rows, k) outputs stay on the device inside the returned
    ``ShardedPending`` until ``sharded_plan_fetch``.  The dense-mask
    oracle path and the SQ8 certificate check are synchronous inside
    dispatch (the certificate decides whether the fp32 sweep must also
    launch)."""
    # same snapshot discipline as PackedRuntime.execute: a plan's CSR
    # offsets and delta id lists are only meaningful against the runtime
    # state that compiled them
    if plan.generation != runtime.generation:
        raise ValueError(
            f"stale plan: compiled against generation {plan.generation}, "
            f"sharded-executing on generation {runtime.generation} — "
            "snapshot the runtime once per batch")
    if plan.delta_version != runtime.delta.version:
        raise ValueError(
            f"stale plan: compiled at delta version {plan.delta_version}, "
            f"sharded-executing at {runtime.delta.version} — an insert "
            "landed between plan and execute; re-plan")
    queries_np = np.ascontiguousarray(np.asarray(queries),
                                      dtype=np.float32)
    out = [(np.empty(0, np.float32), np.empty(0, np.int64))
           ] * plan.n_requests
    if not plan.entries:
        return ShardedPending(plan=plan, k=k, metric=metric,
                              queries_np=queries_np, specs=[], out=out,
                              fetched=True)
    n_hint = None
    if base is not None:
        n_hint = (int(base) if isinstance(base, (int, np.integer))
                  else int(base.shape[0]))
    sh = runtime.to_device_sharded(mesh, axis=axis, n=n_hint)
    if not getattr(runtime, "shard_descriptors", True):
        out = _sharded_plan_topk_dense(sh, runtime, queries_np, plan, k,
                                       metric=metric)
        return ShardedPending(plan=plan, k=k, metric=metric,
                              queries_np=queries_np, specs=[], out=out,
                              fetched=True)
    sh.sync_tombstones(runtime.deleted)
    tf = runtime.traffic
    tf["shard_batches"] += 1
    d_dim = queries_np.shape[1]

    # ---- lower entries (cached) and assemble the launches -------------- #
    specs = [sh.entry_spec(e, plan.delta_version) for e in plan.entries]
    q_rows: List[int] = []
    q_owner: List[int] = []
    dstart_cols: List[np.ndarray] = []
    dlen_cols: List[np.ndarray] = []
    downer: List[int] = []
    tail_parts: List[Tuple[object, List, int, int]] = []
    for oi, (e, spec) in enumerate(zip(plan.entries, specs)):
        for u in spec.states:
            dstart_cols.append(sh.csr_ptr[:, u])
            dlen_cols.append(sh.csr_ptr[:, u + 1] - sh.csr_ptr[:, u])
            downer.append(oi)
        for u, a, b in spec.ranges:
            # partial attribute window: per shard, intersect the global
            # rank window [a, b) with the shard's ascending rank run —
            # the slice is contiguous in the shard-local CSR, so this is
            # still a pure descriptor (two binary searches, zero upload)
            runs = sh._seg_ranks[u]
            starts = np.empty(sh.shards, np.int64)
            lens = np.empty(sh.shards, np.int64)
            for si in range(sh.shards):
                lo_i = int(np.searchsorted(runs[si], a, side="left"))
                hi_i = int(np.searchsorted(runs[si], b, side="left"))
                starts[si] = sh.csr_ptr[si, u] + lo_i
                lens[si] = hi_i - lo_i
            dstart_cols.append(starts)
            dlen_cols.append(lens)
            downer.append(oi)
        if spec.tails is not None:
            tail_parts.append((e.key, spec.tails, oi, spec.t_pad))
        q_rows.extend(e.requests)
        q_owner.extend([oi] * len(e.requests))

    n_desc = 0
    d_pad = 0
    if downer:
        dlen_np = np.stack(dlen_cols, axis=1).astype(np.int32)
        dstart_np = np.stack(dstart_cols, axis=1).astype(np.int32)
        d_pad = ops.bucket(len(downer), 8)
        if d_pad > len(downer):
            pad = d_pad - len(downer)
            dlen_np = np.pad(dlen_np, ((0, 0), (0, pad)))
            dstart_np = np.pad(dstart_np, ((0, 0), (0, pad)))
        downer_np = np.full(d_pad, -3, np.int32)
        downer_np[:len(downer)] = downer
        n_desc = ops.bucket(int(dlen_np.sum(axis=1).max()), 8)
    else:
        dstart_np = np.zeros((sh.shards, 0), np.int32)
        dlen_np = np.zeros((sh.shards, 0), np.int32)
        downer_np = np.zeros(0, np.int32)

    # canonical order: the tails cache keys on this sequence, so rotating
    # predicate arrival orders must collapse to one concatenated array
    tail_parts.sort(key=lambda p: str(p[0]))
    t_total = sum(tp for _, _, _, tp in tail_parts)
    t_pad = ops.bucket(t_total, 8) if t_total else 0
    if tail_parts:
        towner_np = np.full(t_pad, -3, np.int32)
        off = 0
        for _, _, oi, tp in tail_parts:
            towner_np[off:off + tp] = oi
            off += tp
        tails_dev = sh.batch_tails(
            [(ekey, arrs, tp) for ekey, arrs, _, tp in tail_parts],
            t_pad, plan.delta_version)
    else:
        towner_np = np.zeros(0, np.int32)
        tails_dev = [torch.zeros((b.s1 - b.s0, 0), dtype=torch.int32,
                                 device=b.device) for b in sh.blocks]

    pending = ShardedPending(plan=plan, k=k, metric=metric,
                             queries_np=queries_np, specs=specs, out=out)
    if q_rows and n_desc + t_pad > 0:
        q_n = len(q_rows)
        q_pad = ops.bucket(q_n, 8)
        qmat = np.zeros((q_pad, d_dim), np.float32)
        qmat[:q_n] = queries_np[q_rows]
        qseg = np.full(q_pad, -1, np.int32)
        qseg[:q_n] = q_owner
        key = (q_pad, n_desc, d_pad, t_pad, k, metric, sh.shards,
               sh.local_n, d_dim)
        waves = []
        for b, tails in zip(sh.blocks, tails_dev):
            qs, do, to, ds, dl = _upload_i32(
                b.device, qseg, downer_np, towner_np,
                dstart_np[b.s0:b.s1], dlen_np[b.s0:b.s1])
            waves.append(_Wave(q=torch.from_numpy(qmat).to(b.device),
                               qseg=qs, downer=do, towner=to, dstart=ds,
                               dlen=dl, tails=tails))
        dv = gv = None
        t_sweep = time.perf_counter()
        streak_out = (getattr(runtime, "sq8_escalate", True)
                      and getattr(runtime, "_sq8_bad_streak", 0)
                      >= getattr(runtime, "SQ8_MAX_STREAK", 3))
        sq8 = getattr(runtime, "quantize", "none") == "sq8"
        if sq8 and sh.quant is None:
            sh.quantize()
        if (sq8 and not streak_out
                and quant.sq8_supported(k, d_dim, metric)):
            # quantized sweep + per-shard certificate; a failed batch
            # escalates to the fp32 sweep below (exactness contract),
            # and a streak of failures flips the runtime to fp32
            # outright (same adaptive policy as the single-device path)
            kq = min(128, max(k, k * max(1, min(4, 128 // max(k, 1)))))
            dv, gv, bad = _sweep_sq8(sh, waves, n_desc, k, kq)
            ops.record_launch("sq8_sharded_sweep", key + (kq,))
            runtime.sq8_stats["batches"] += 1
            if not getattr(runtime, "sq8_escalate", True):
                pass          # approximate point: trust the rerank
            elif int(bad):
                runtime.sq8_stats["escalations"] += 1
                runtime._sq8_bad_streak += 1
                dv = gv = None
            else:
                runtime.sq8_stats["certified"] += 1
                runtime._sq8_bad_streak = 0
        elif sq8:
            runtime.sq8_stats["fallbacks"] += 1
        if dv is None:
            dv, gv = _sweep(sh, waves, n_desc, k, metric)
            ops.record_launch("sharded_sweep", key)
        planner = getattr(runtime, "planner", None)
        if planner is not None:
            # the sharded sweep is the distributed scan strategy: report
            # its observed cost (rows ranked × query rows) into the
            # index-owned cost model — folded at the next wave head, like
            # every other executor observation (DESIGN.md §11)
            planner.observe("scan",
                            (int(dlen_np.sum()) + t_total) * q_n,
                            (time.perf_counter() - t_sweep) * 1e3)
        desc_bytes = sh.shards * d_pad * 8 + d_pad * 4 + t_pad * 4
        tf["shard_descriptor_bytes"] += desc_bytes
        tf["shard_query_bytes"] += q_pad * (d_dim * 4 + 4)
        tf["bytes_to_device"] += desc_bytes + q_pad * (d_dim * 4 + 4)
        pending.dv, pending.gv = dv, gv
        if dv.device.type == "cuda":
            pending.host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True) for t in (dv, gv))
            pending.ready = torch.cuda.Event()
            pending.ready.record(torch.cuda.current_stream(dv.device))
    return pending


def sharded_plan_fetch(runtime, pending: ShardedPending
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Wait for a dispatched sharded wave and run the host merge:
    sentinel filter + delta-overflow fold per request.  This is the only
    device→host wait of the sharded wave, and on a card it waits for this
    wave's own copies — a pipelined caller fetches wave N while wave
    N+1's launches are already in flight."""
    if pending.fetched:
        return pending.out
    plan, k, metric = pending.plan, pending.k, pending.metric
    queries_np, out = pending.queries_np, pending.out
    vals = gids = None
    if pending.dv is not None:
        if pending.ready is not None:
            pending.ready.synchronize()
            dv, gv = pending.host
        else:
            dv, gv = pending.dv, pending.gv
        vals = dv.numpy()
        gids = gv.numpy().astype(np.int64, copy=False)
    row = 0
    for e, spec in zip(plan.entries, pending.specs):
        ed, extra_ids = _extras_block(runtime, queries_np, e, spec.extra,
                                      metric)
        for j, r in enumerate(e.requests):
            if vals is not None:
                vrow, irow = vals[row], gids[row]
                valid = np.isfinite(vrow) & (irow >= 0)
                dr, ir = vrow[valid], irow[valid]
            else:
                dr = np.empty(0, np.float32)
                ir = np.empty(0, np.int64)
            row += 1
            if ed is not None:
                dr, ir = _merge_extras_row(dr, ir, ed[j], extra_ids, k)
            out[r] = (dr.astype(np.float32, copy=False),
                      ir.astype(np.int64, copy=False))
    pending.fetched = True
    return out


def _sharded_plan_topk_dense(sh: ShardedDeviceIndex, runtime,
                             queries_np: np.ndarray, plan, k: int, *,
                             metric: str):
    """Per-entry dense-mask path — the parity oracle for the descriptor
    executor (``runtime.shard_descriptors = False``): one host-composed
    (N,) validity mask upload and one sweep per entry.
    ``shard_mask_bytes`` counts what the descriptor path saves."""
    n = sh.n
    tf = runtime.traffic
    tf["shard_batches"] += 1
    out = [(np.empty(0, np.float32), np.empty(0, np.int64))
           ] * plan.n_requests
    deleted = runtime.deleted
    for entry in plan.entries:
        full_mask = runtime.entry_mask(entry)
        extra_ids = (np.nonzero(full_mask[n:])[0].astype(np.int64) + n
                     if len(full_mask) > n else np.empty(0, np.int64))
        mask = full_mask[:n]
        if len(mask) < n:
            mask = np.pad(mask, (0, n - len(mask)))
        if deleted:
            mask[[i for i in deleted if i < n]] = False
        tf["shard_mask_bytes"] += int(mask.nbytes)
        tf["bytes_to_device"] += int(mask.nbytes)
        # the padded resident table; pad rows are masked False
        mask_pad = np.pad(mask, (0, sh.n_pad - n))
        masks = [torch.from_numpy(
            mask_pad[s * sh.local_n:(s + 1) * sh.local_n].copy()).to(dev)
            for s, dev in enumerate(sh.devices)]
        qm = torch.from_numpy(
            np.ascontiguousarray(queries_np[entry.requests]))
        q_dev = {dev: qm.to(dev) for dev in set(sh.devices)}
        d, i = _shard_topk_merge(q_dev, sh.vectors, sh.local_n, n, k,
                                 metric, masks)
        d = d.cpu().numpy()
        i = i.cpu().numpy().astype(np.int64)
        ed, extra_ids = _extras_block(runtime, queries_np, entry,
                                      extra_ids, metric)
        for row, r in enumerate(entry.requests):
            valid = np.isfinite(d[row]) & (i[row] >= 0)
            dr, ir = d[row][valid], i[row][valid]
            if ed is not None:
                dr, ir = _merge_extras_row(dr, ir, ed[row], extra_ids, k)
            out[r] = (dr, ir)
    return out


__all__ = ["sharded_topk", "ShardedDeviceIndex", "ShardedPending",
           "sharded_plan_topk", "sharded_plan_dispatch",
           "sharded_plan_fetch"]
