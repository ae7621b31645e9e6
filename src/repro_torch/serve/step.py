"""Serve-step builders — prefill and single-token greedy decode — and
the double-buffered host staging ring for the pipelined retrieval
executor.

Port of ``src/repro/serve/step.py``.  ``make_prefill``,
``make_prefill_encdec`` and ``make_decode`` return step functions over
an ``LM`` / ``EncDec`` module: the weights live in the module, so the
steps take no ``params`` argument (the reference's first positional
one); they run under ``torch.inference_mode()`` and pick the next token
greedily (``argmax``, the first index among equal logits, as
``jnp.argmax``).

With ``mesh=`` (a ``(data, model)`` ``launch.mesh.Mesh``) the steps
serve the module as the reference's dry run lowers them on a mesh: the
first call places it once as the train step does (``fsdp.place``:
weights cut over ``model`` by ``ShardingRules.param_specs`` and over
``data``), the placement kept (``MeshStep.slots``, one module a slot)
and shared by every builder of the module on that mesh; the cache is a
``fsdp.PlacedCache`` cut as ``cache_specs`` cuts it (the K/V's sequence
over ``model``, or over ``(data, model)`` for a batch the data axis does
not divide; SSM heads and conv channels over ``model``; the batch over
``data``).  Prefill, as the reference lowers it with its
``gather_rules``, runs each data row that serves a batch shard
(``fsdp.batch_slots``) over its ranks, each layer's weights gathered
over ``data`` inside the layer.  Decode runs in the reference's
weight-stationary layout (its ``actctx.configure(mesh, None)``): no
weight moves; one forward takes every sequence over the TP ranks of
data row 0, the activations replicated over ``data``; each product with
a weight cut over ``data`` runs on every data shard where it lies (fp32
partials summed once, or column slices joined: ``layers.over_data``),
and each layer's cache is read and written where it lies
(``fsdp.MeshCache``), the contexts and states of the data rows joined
over ``data``.  The greedy token is the argmax over the vocabulary cut
over the ranks (``tp.argmax_over_ranks``).  ``MeshStep.last_logits()``
joins the last call's logits (B, vocab) on slot 0's device, for a check
against the one-device call.

``StagingRing`` (DESIGN.md §7): the planner thread assembles wave N+1's
query matrix into one of two preallocated host buffers while wave N's
launches execute, so wave formation never allocates on the hot path and
the upload for wave N+1 reads from a buffer the in-flight wave cannot
touch.  A slot is held from planning until the wave's results are
fetched; with a depth-1 plan queue plus one in-flight wave, two slots
are exactly enough and ``acquire`` throttles the planner when it runs
more than a full pipeline ahead.

On a CUDA engine the slots are pinned host tensors (``pin=True``), so
the wave's query upload is an asynchronous copy (``non_blocking=True``)
on the wave's stream.  Such a copy still reads the slot after the host
has moved on: the dispatch stage marks the slot with ``guard()`` (a CUDA
event after the wave's launches), and ``release()`` waits for that event
before the slot can be refilled.  Unpinned slots (a CPU engine) are
plain buffers; pinning is never attempted there, and a failure to pin
raises.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch


class StagingStall(TimeoutError):
    """A staging-slot lease timed out: every upload slot stayed leased
    past the deadline, i.e. the fetch stage is not draining and the
    pipeline is wedged.  Carries the ring depth and the observed wait so
    the stall is diagnosable (and countable in ``maintenance_stats`` via
    ``staging_stalls``) instead of surfacing as an anonymous
    ``TimeoutError``."""

    def __init__(self, depth: int, wait_ms: float):
        super().__init__(
            f"StagingRing.acquire: all {depth} upload slots leased after "
            f"{wait_ms:.0f} ms — the fetch stage is not draining "
            f"(pipeline stalled)")
        self.depth = depth
        self.wait_ms = wait_ms


class StagingSlot:
    """One leased buffer of a ``StagingRing``: ``view(n)`` is the filled
    (n, d) prefix as an array, ``tensor(n)`` the same memory as a
    (pinned) tensor the dispatch stage uploads from; ``release()``
    returns the slot to the ring (idempotent) once every copy that reads
    it has completed."""

    def __init__(self, ring: "StagingRing", idx: int, n: int) -> None:
        self._ring = ring
        self._idx = idx
        self._n = n
        self._event: Optional[torch.cuda.Event] = None

    def view(self, n: Optional[int] = None) -> np.ndarray:
        return self._ring._views[self._idx][:self._n if n is None else n]

    def tensor(self, n: Optional[int] = None) -> torch.Tensor:
        return self._ring._bufs[self._idx][:self._n if n is None else n]

    @property
    def pinned(self) -> bool:
        return self._ring.pin

    def guard(self) -> None:
        """Mark the slot as read by the work queued so far on the current
        CUDA stream (an asynchronous upload from it): ``release`` waits
        for that work.  No-op for an unpinned slot, whose copies are
        synchronous."""
        if self._ring.pin and self._idx >= 0:
            self._event = torch.cuda.Event()
            self._event.record()

    def release(self) -> None:
        if self._idx >= 0:
            if self._event is not None:
                self._event.synchronize()
                self._event = None
            self._ring._release(self._idx)
            self._idx = -1


class StagingRing:
    """Double-buffered host staging for wave query matrices.

    ``acquire(queries)`` copies the wave's (n, d) query rows into a free
    preallocated slot (growing the slot's row capacity geometrically if
    the wave is larger than anything seen), blocking while both slots
    are leased — i.e. while a full pipeline (one planned + one in-flight
    wave) is outstanding.  This bounds planner run-ahead without a
    second queue and makes wave formation allocation-free at steady
    state.  ``pin=True`` allocates the slots in page-locked memory."""

    def __init__(self, dim: int, capacity: int = 64, slots: int = 2,
                 pin: bool = False) -> None:
        self.dim = int(dim)
        self.pin = bool(pin)
        self._bufs = [self._alloc(capacity) for _ in range(slots)]
        self._views = [b.numpy() for b in self._bufs]
        self._free = list(range(slots))
        self._cv = threading.Condition()
        self.grows = 0          # observability: hot-path reallocations
        self.waits = 0          # acquire() calls that had to block
        self.stalls = 0         # leases that timed out (StagingStall)

    def _alloc(self, rows: int) -> torch.Tensor:
        return torch.empty((rows, self.dim), dtype=torch.float32,
                           pin_memory=self.pin)

    def acquire(self, queries: np.ndarray,
                timeout: Optional[float] = None) -> StagingSlot:
        q = np.asarray(queries, dtype=np.float32)
        n = q.shape[0]
        t0 = time.perf_counter()
        with self._cv:
            if not self._free:
                self.waits += 1
            if not self._cv.wait_for(lambda: bool(self._free),
                                     timeout=timeout):
                self.stalls += 1
                raise StagingStall(
                    depth=len(self._bufs),
                    wait_ms=(time.perf_counter() - t0) * 1e3)
            idx = self._free.pop()
        if self._bufs[idx].shape[0] < n:
            self._bufs[idx] = self._alloc(max(n, self._bufs[idx].shape[0]
                                              * 2))
            self._views[idx] = self._bufs[idx].numpy()
            self.grows += 1
        self._views[idx][:n] = q
        return StagingSlot(self, idx, n)

    def _release(self, idx: int) -> None:
        with self._cv:
            self._free.append(idx)
            self._cv.notify()


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def placement(model, mesh):
    """(the ``ShardingRules`` of ``model`` on ``mesh``, one module a
    slot): ``model`` placed on the mesh at the first call and kept on it,
    so every builder of one model on one mesh serves one placement.  The
    model keeps the other slots' modules only (slot 0's is the model
    itself: no reference cycle, so a dropped model frees its shards)."""
    from ..distributed import fsdp
    from ..distributed.sharding import ShardingRules
    held = getattr(model, "_serve_placement", None)
    if held is not None:
        if held[0] != mesh:
            raise ValueError(f"the model is placed on {held[0]}, not {mesh}")
        return held[1], [model, *held[2]]
    rules = ShardingRules(model.cfg, mesh)
    slots = fsdp.place(model, mesh, rules) if mesh.size > 1 else [model]
    model._serve_placement = (mesh, rules, slots[1:])
    return rules, slots


class MeshStep:
    """A serving step over a mesh: ``body(step, *args)`` builds the
    call's cache and runs ``rows`` — ``call(module, rows, row cache)``
    on each data row that serves a batch shard (``fsdp.batch_slots``),
    over its ranks, the weights gathered over ``data`` layer by layer —
    or ``stationary`` — ``call(module, mesh cache)`` once, the weights
    used where they lie —, whose logits are the ranks' columns.
    ``slots``: one module a slot; ``last_logits()`` joins the last
    call's logits (B, vocab) on slot 0's device."""

    def __init__(self, model, mesh, body):
        self.model, self.mesh, self.body = model, mesh, body
        self.slots = None
        self._logits = None

    @torch.inference_mode()
    def __call__(self, *args, **kwargs):
        return self.body(self, *args, **kwargs)

    def rows(self, batch: int, cache, call) -> torch.Tensor:
        """The next tokens (B,), on slot 0's device."""
        from ..distributed import actctx, fsdp, tp
        rules, self.slots = placement(self.model, self.mesh)
        slots = list(self.mesh.devices.flat)
        t = self.mesh.shape.get("model", 1)
        runners, split = fsdp.batch_slots(rules, batch)
        logits = []
        for i, s in enumerate(runners):
            if split > 1 and not any(actctx.live(d)
                                     for d in slots[s:s + t]):
                # one slot's reckoning: a row of a cut batch that holds
                # nothing of the reckoned slot leaves nothing on it
                logits.append(None)
                continue
            rows = (slice(i * batch // split, (i + 1) * batch // split)
                    if split > 1 else slice(None))
            with actctx.use(self.mesh, rules.dp, gather_rules=rules), \
                    actctx.local_shard(split, slots[s],
                                       ranks=self.slots[s:s + t],
                                       devices=slots[s:s + t]):
                logits.append(call(self.slots[s], rows, cache.row(s)))
        ref = next(row for row in logits if row is not None)
        logits = [tp.placeholder(ref) if row is None else row
                  for row in logits]
        self._logits = logits if split > 1 else logits[:1]
        return torch.cat([tp.argmax_over_ranks(row).to(slots[0])
                          for row in self._logits]).to(torch.int32)

    def stationary(self, cache, call) -> torch.Tensor:
        """The next tokens (B,), on slot 0's device, of a decode in the
        weight-stationary layout: ``call(module, fsdp.MeshCache)`` once,
        over the TP ranks of data row 0, the pins replicating the batch
        over ``data`` and no weight gathered."""
        from ..distributed import actctx, fsdp, tp
        _, self.slots = placement(self.model, self.mesh)
        slots = list(self.mesh.devices.flat)
        t = self.mesh.shape.get("model", 1)
        # one data row (no weight cut over data): nothing to fan out
        with actctx.use(self.mesh, None, stationary=len(slots) > t), \
                actctx.local_shard(1, slots[0], ranks=self.slots[:t],
                                   devices=slots[:t]):
            logits = call(self.slots[0], cache.over_mesh(self.slots))
        self._logits = [logits]
        return tp.argmax_over_ranks(logits).to(slots[0]).to(torch.int32)

    def last_logits(self) -> torch.Tensor:
        dev = self.mesh.devices.flat[0]
        return torch.cat([torch.cat([part.to(dev) for part in row], -1)
                          for row in self._logits])


def _part(x, rows, device):
    return None if x is None else x[rows].to(device)


def _new_cache(step, structure, batch: int):
    from ..distributed import fsdp
    rules, _ = placement(step.model, step.mesh)
    return fsdp.init_cache(structure, step.mesh, rules, batch)


def make_prefill(model, max_len: int, mesh=None) -> Callable:
    """``prefill(tokens[, patch_embeds]) -> (cache, next tokens (B,))``;
    over ``mesh`` a ``MeshStep`` whose cache is a ``fsdp.PlacedCache``."""
    if mesh is None:
        @torch.inference_mode()
        def prefill(tokens, patch_embeds=None):
            cache, logits = model.prefill(tokens, max_len,
                                          patch_embeds=patch_embeds)
            return cache, _greedy(logits)
        return prefill

    def body(step, tokens, patch_embeds=None):
        b = tokens.shape[0]
        cache = _new_cache(step, step.model.init_cache(b, max_len, "meta"),
                           b)
        return cache, step.rows(b, cache, lambda m, rows, c: m.prefill(
            _part(tokens, rows, m.device), max_len,
            _part(patch_embeds, rows, m.device), cache=c)[1])
    return MeshStep(model, mesh, body)


def make_prefill_encdec(model, max_dec: int, mesh=None) -> Callable:
    """``prefill(frames, tokens) -> (cache, next tokens (B,))``; over
    ``mesh`` a ``MeshStep`` whose cache is a ``fsdp.PlacedCache``."""
    if mesh is None:
        @torch.inference_mode()
        def prefill(frames, tokens):
            cache, logits = model.prefill(frames, tokens, max_dec)
            return cache, _greedy(logits)
        return prefill

    def body(step, frames, tokens):
        b = tokens.shape[0]
        cache = _new_cache(step, step.model.cache_structure(
            b, max_dec, frames.shape[1]), b)
        return cache, step.rows(b, cache, lambda m, rows, c: m.prefill(
            _part(frames, rows, m.device), _part(tokens, rows, m.device),
            max_dec, cache=c)[1])
    return MeshStep(model, mesh, body)


def make_decode(model, mesh=None) -> Callable:
    """``decode(cache, token (B, 1), pos) -> (next (B, 1), cache)``; the
    cache (over ``mesh``, the ``fsdp.PlacedCache`` a mesh prefill made)
    is updated in place."""
    if mesh is None:
        @torch.inference_mode()
        def decode(cache, token, pos):
            logits, cache = model.decode_step(cache, token, pos)
            return _greedy(logits)[:, None], cache
        return decode

    def body(step, cache, token, pos):
        return step.stationary(cache, lambda m, c: m.decode_step(
            c, token.to(m.device), pos)[0])[:, None], cache
    return MeshStep(model, mesh, body)


__all__ = ["StagingStall", "StagingSlot", "StagingRing", "placement",
           "MeshStep", "make_prefill", "make_prefill_encdec", "make_decode"]
