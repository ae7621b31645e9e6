"""Dry run of the port: per-card memory fit and roofline terms for every
(arch × shape × mesh) cell, reckoned on the CPU with no card and no
allocation.  Port of ``src/repro/launch/dryrun.py``, which lowers and
compiles each cell on 512 placeholder TPU devices and reads
``compiled.memory_analysis()``; PyTorch has no compiler to ask, so here:

  * state bytes — exact, from the spec tables: every parameter's local
    shape on the cell's mesh (``ShardingRules.param_specs``, the
    reference's stacked leaves) times its dtype's bytes, split into the
    parameters, the gradients (or, with microbatch accumulation, the
    accumulators) and the AdamW moments; a decode cell adds its cache
    (``cache_specs``);
  * peak bytes — where the state fits the card, the port's own train
    step (FSDP placement over the data axis; on ``1x4`` and ``2x2``
    tensor parallelism over the model axis too), prefill or decode, run
    on fake tensors
    (``FakeTensorMode``) under ``MemTracker``, over a fake mesh of the
    cell's devices (``cuda:0``…``cuda:3`` for ``4x1``, ``1x4`` and
    ``2x2``), so each device's
    peak is its own.  The fake ``cuda`` tensors take the port's card
    path (bf16 GEMMs with fp32 outputs) — the dry run's explicit
    ``device`` argument, not a fallback: the model entry points asked
    for ``cuda`` without a card still raise.  Fake ``cuda`` tensors
    need a PyTorch built with CUDA and as many visible cards as the mesh
    has slots (their memory unused); ``device="cpu"`` runs anywhere, but
    there the slots of a four-slot mesh share one device: the record
    keeps their summed peak (``peak_mode`` says so) and gives no
    per-card peak and no ``fits_80gb``.  A cell whose state alone
    exceeds 80 GB a device does not fit (the peak holds the state) and
    runs no step.  Prefill and decode run through ``serve.step``'s
    builders over the mesh, the cache cut as ``cache_specs`` cuts it
    (``fsdp.init_cache``: a batch the data axis does not divide spreads
    its K/V's sequence over every slot), decode in the reference's
    weight-stationary layout (no weight gathered);
  * the ``pod`` (16 × 16) and ``multipod`` (2 × 16 × 16, FSDP over
    ``(pod, data)``) layouts' peaks — one slot's program
    (``slot_peaks``): under SPMD every slot runs the same program, so
    the reckoned slot lies on the fake device and the other 255 (511)
    on ``meta``, and the work that leaves nothing on the reckoned slot
    is not run (``actctx.one_slot``: placeholders for the other ranks',
    data rows' and shards' results, every buffer a collective leaves on
    the slot made as the whole program makes it).  Slot 0, which the
    one thread that drives a mesh loads (the whole model before
    placement, the greedy tokens), and slot n−1 are reckoned; the
    per-card peak is the larger.  On ``4x1``, ``1x4`` and ``2x2`` the
    same reckoning equals the whole program's peak for that slot (its
    other slots on ``meta``: ``tests/test_torch_pod_dryrun.py``);
  * roofline — ``analysis.step_flops`` and ``analysis.hbm_bytes`` (the
    reference's analytic terms), and a collective term reckoned from the
    step's own traffic: each layer's FSDP all-gathers (twice under
    remat: the forward and the recomputation), the reduce-scatter of the
    sharded leaves' gradients and the all-reduce of the replicated
    leaves'; prefill's gathers once; decode's activations over the data
    axis (``stationary_collectives``: its weights stay where they lie),
    and at ``model`` > 1 the tensor-parallel collectives of the step,
    the prefill or the decode step (``tp_collectives``) — with no HLO to
    parse, ``analysis.parse_collectives`` is not used — over the NVIDIA
    H100 SXM's datasheet rates: one link rate, NVLink's 450 GB/s a card,
    which holds inside one node of 8 cards (a pod's 256 cards span 32
    nodes), as the reference keeps one ICI rate.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \\
        --mesh 4x1
    python -m repro_torch.launch.dryrun --all [--mesh 1x1,4x1] \\
        [--out results/dryrun_torch]

One JSON file a cell, ``<arch>__<shape>__<mesh>.json``, in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..configs import arch_names, get_config
from ..distributed import actctx, fsdp
from ..distributed.sharding import ShardingRules, map_with_path
from ..models.convert import reference_shapes
from ..models.encdec import EncDec
from ..models.transformer import LM
from ..serve import step as serve_step
from ..train import optimizer as opt
from ..train.step import make_train_step
from . import analysis
from .mesh import Mesh, axis_size, dp_axes, make_production_mesh
from .shapes import (SHAPES, ShapeSpec, decode_args_struct,
                     prefill_args_struct, skip_reason, train_batch_struct,
                     whisper_dec_len)

# --- NVIDIA H100 SXM5 80GB datasheet constants ---------------------------- #
PEAK_FLOPS = 989e12          # dense bf16 / card (H100 SXM)
HBM_BW = 3.35e12             # bytes/s / card (H100 SXM, HBM3)
LINK_BW = 450e9              # bytes/s / card each way (H100 SXM, NVLink 4)
HBM_CAPACITY = 80e9          # bytes / card (H100 80GB)

# Microbatch accumulation for the big-model train cells: activation memory
# scales 1/accum at identical math (the production knob for these sizes).
TRAIN_ACCUM = {
    "granite-34b": 4,
    "qwen3-moe-235b-a22b": 8,
    "jamba-1.5-large-398b": 16,
}
# bf16 optimizer moments / grad accumulators for the models whose fp32
# train state alone approaches (235B) or exceeds (398B) per-chip HBM.
MOMENT_DTYPE = {
    "qwen3-moe-235b-a22b": "bfloat16",
    "jamba-1.5-large-398b": "bfloat16",
}
ACCUM_DTYPE = {
    "qwen3-moe-235b-a22b": "bfloat16",
    "jamba-1.5-large-398b": "bfloat16",
}

MESHES = ("1x1", "4x1", "1x4", "2x2", "pod", "multipod")

# ------------------------------------------------------------------------ #


def build_model(cfg, device="cpu"):
    return (EncDec if cfg.is_encoder_decoder else LM)(cfg, device=device)


def model_flops(cfg, shape: ShapeSpec) -> float:
    """Napkin MODEL_FLOPS: 6·N_active·D (train), 2·N_active·D (fwd)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.batch * shape.seq
        return 6.0 * n * d
    if shape.kind == "prefill":
        return 2.0 * n * shape.batch * shape.seq
    return 2.0 * n * shape.batch  # decode: one token per sequence


def make_mesh(name: str, device: str = "cuda") -> Mesh:
    """A cell's mesh: ``1x1`` / ``4x1`` / ``1x4`` / ``2x2`` (data ×
    model) over fake devices ``<device>:0``… (all one device for
    ``cpu``), or the reference's production layouts (placeholder
    devices)."""
    if name in ("pod", "multipod"):
        return make_production_mesh(multi_pod=name == "multipod")
    data, model = (int(x) for x in name.split("x"))
    devs = [torch.device(device, i) if device != "cpu"
            else torch.device("cpu") for i in range(data * model)]
    grid = np.empty(data * model, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(data, model), ("data", "model"))


def _dtype_bytes(name: str) -> int:
    return torch.empty((), dtype=opt._DTYPES[name]).element_size()


def _local_elements(shape, spec, mesh) -> int:
    n = 1
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        n *= dim if ax is None else dim // axis_size(mesh, ax)
    return n


def _local_bytes(tree, specs, mesh, itemsize=None) -> int:
    """Σ over the leaves of ``tree`` (beside their ``specs``) of their
    local elements on ``mesh`` × bytes (the leaf's dtype, or
    ``itemsize``)."""
    if isinstance(tree, dict):
        return sum(_local_bytes(tree[k], specs[k], mesh, itemsize)
                   for k in tree)
    if isinstance(tree, list):
        return sum(_local_bytes(t, s, mesh, itemsize)
                   for t, s in zip(tree, specs))
    return _local_elements(tree.shape, specs, mesh) * (
        itemsize or tree.dtype.itemsize)


def state_bytes(cfg, ref_shapes, rules, shape: ShapeSpec, *, accum: int,
                moment_dtype: str, accum_dtype: str,
                cache_struct=None) -> Dict[str, int]:
    """Per-device bytes of the state a cell holds, from the spec tables:
    parameters; for train, gradients (accumulators in ``accum_dtype``
    with accumulation) and the two moments; for decode, the cache."""
    mesh = rules.mesh
    pspecs = rules.param_specs(ref_shapes)
    out = {"params": _local_bytes(ref_shapes, pspecs, mesh)}
    if shape.kind == "train":
        out["grads"] = (_local_bytes(ref_shapes, pspecs, mesh,
                                     _dtype_bytes(accum_dtype))
                        if accum > 1 else out["params"])
        out["moments"] = 2 * _local_bytes(ref_shapes, pspecs, mesh,
                                          _dtype_bytes(moment_dtype))
    if cache_struct is not None:
        out["cache"] = _local_bytes(
            cache_struct, rules.cache_specs(cache_struct, shape.batch), mesh)
    out["total"] = sum(out.values())
    return out


def fsdp_collectives(ref_shapes, dims, n: int, kind: str, *, accum: int,
                     remat: bool, grad_bytes: int, tp: int = 1
                     ) -> Dict[str, Any]:
    """Per-device wire bytes of the FSDP step's own collectives
    (``analysis._wire_bytes``' ring factors): the layers' all-gathers
    (each microbatch; twice under remat), the reduce-scatter of the
    sharded leaves' gradients (each microbatch) and the all-reduce of
    the replicated leaves' gradients (``grad_bytes`` an element, once);
    prefill gathers once and decode, whose weights stay where they lie
    (``stationary_collectives``), not at all.  ``dims``: each stacked
    leaf's (cut over data, cut over model); a leaf cut over ``model``
    moves its TP rank's 1/``tp`` over the data axis."""
    sharded = replicated = 0
    for name, leaf in _named_leaves(ref_shapes):
        b = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        data_cut, tp_cut = dims[name]
        if tp_cut:
            b //= tp
        if data_cut:
            sharded += b
        else:
            replicated += b // leaf.dtype.itemsize * grad_bytes
    per_op = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    if n > 1:
        if kind == "train":
            per_op["all-gather"] = analysis._wire_bytes(
                "all-gather", sharded, n) * (2 if remat else 1) * accum
            per_op["reduce-scatter"] = analysis._wire_bytes(
                "reduce-scatter", sharded / n, n) * accum
            per_op["all-reduce"] = analysis._wire_bytes(
                "all-reduce", replicated, n)
        elif kind == "prefill":
            per_op["all-gather"] = analysis._wire_bytes(
                "all-gather", sharded, n)
    return {"bytes_per_op": per_op, "total_bytes": sum(per_op.values()),
            "sharded_param_bytes": sharded}


# a layer's products whose weight the data axis cuts along the contracted
# (input) axis, and along the output's last axis
_INPUT_CUT = ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "z_proj",
              "x_proj", "b_proj", "c_proj", "dt_proj")
_OUTPUT_CUT = ("wo", "w_down", "w_out", "out_proj")


def stationary_collectives(cfg, shape: ShapeSpec, leaves, n: int,
                           tp: int) -> Dict[str, Any]:
    """Per-device wire bytes over the FSDP group (``n`` data rows) of a
    decode step in the weight-stationary layout (``analysis._wire_bytes``'
    ring factors): every product of the step whose weight is cut over
    data moves activations, not weights — one token of each of the
    ``shape.batch`` sequences, replicated over data.  A weight cut along
    its contracted axis (q/k/v, gate/up, the SSD projections, the
    experts' gate and up) all-reduces its fp32 partials of its TP rank's
    output columns; one cut along the output's last axis (o, down, out,
    the SSD's out) all-gathers the slices of its output (fp32 where the
    heads or columns are cut over ``model``, a row-parallel partial).
    ``leaves``: (the port's parameter name, its per-layer shape, the
    axis cut over data, the axis cut over ``model``) of every parameter;
    the encoder's layers and the cross-attention's K/V projections run
    in prefill only."""
    per_op = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    rows = shape.batch
    item = _dtype_bytes(cfg.dtype)
    products = 0
    for name, pshape, dim, tp_dim in leaves:
        parts = name.split(".")
        leaf = parts[-1]
        if dim is None or parts[0] == "enc_layers" or (
                "cross" in parts and leaf in ("wk", "wv")):
            continue
        local = list(pshape)
        if tp_dim is not None:
            local[tp_dim] //= tp
        numel = int(np.prod(local))
        if leaf in _INPUT_CUT:
            per_op["all-reduce"] += analysis._wire_bytes(
                "all-reduce", rows * numel // local[dim] * 4, n)
        elif leaf in _OUTPUT_CUT:
            experts = leaf == "w_down" and len(local) == 3
            out = local[-1] * (local[0] if experts else 1)
            wide = tp_dim is not None and not experts
            per_op["all-gather"] += analysis._wire_bytes(
                "all-gather", rows * out * (4 if wide else item), n)
        else:
            raise ValueError(f"{name}: a weight cut over data that no "
                             "decode product is known to use")
        products += 1
    return {"bytes_per_op": per_op, "total_bytes": sum(per_op.values()),
            "products": products, "rows": rows}


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def tp_collectives(cfg, shape: ShapeSpec, mesh: Mesh, *, accum: int,
                   remat: bool) -> Dict[str, Any]:
    """Per-device wire bytes of the tensor-parallel collectives over the
    model axis (``analysis._wire_bytes``' ring factors), for one data
    row's rows (B / data, or B where the data axis does not divide it)
    in the model's dtype.  The train step and prefill: each sublayer
    (attention, FFN, SSD mixer; whisper's cross-attention too) enters
    with an all-gather of the residual cut over ``model`` and leaves with
    a reduce-scatter of its row-parallel partials (the
    sequence-parallel pair of ``distributed.tp``; an all-reduce each
    where the sequence does not divide) — the train step in the forward,
    again in the recomputation under remat, and swapped in the backward;
    the SSD mixers also all-gather B and C (their convs' outputs); the
    vocabulary-parallel loss all-reduces three fp32 numbers a token
    (max, sum of exponentials, gold logit).  Decode, which runs every
    sequence over one row's ranks (the weight-stationary layout):
    each sublayer's partials all-reduced (B × 1 × d) and each attention
    layer's query heads all-gathered, over the whole batch; three fp32
    terms reduced over the ranks that hold a data row's cache sequence
    (``cache_specs``: the row's TP ranks, or a pod's slots for a batch
    the data axis does not divide), for the rows it holds — the scores'
    max and sum (B × H each) and the context (B × H × hd); the SSD
    mixers all-gather B and C.  Serving's greedy token all-gathers a
    value and an index a sequence and rank
    (``tp.argmax_over_ranks``)."""
    from ..models.convert import ShapeLeaf
    t = mesh.shape["model"]
    dp = axis_size(mesh, dp_axes(mesh))
    rows = shape.batch // dp if shape.batch % dp == 0 else shape.batch
    item = _dtype_bytes(cfg.dtype)
    if cfg.is_encoder_decoder:
        sub = 2 * cfg.num_encoder_layers + 3 * cfg.num_layers
        attn = 2 * cfg.num_layers
    elif cfg.family == "ssm":
        sub, attn = cfg.num_layers, 0
    else:
        sub = 2 * cfg.num_layers
        attn = (cfg.num_layers // cfg.attn_period if cfg.attn_period
                else cfg.num_layers)
    mixers = (cfg.num_layers if cfg.family == "ssm" else
              cfg.num_layers - cfg.num_layers // cfg.attn_period
              if cfg.attn_period else 0)
    gn = cfg.ssm_groups * cfg.ssm_state
    per_op = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    wire = analysis._wire_bytes
    if shape.kind == "decode":
        seq = ShardingRules(cfg, mesh).cache_specs(
            {"k": ShapeLeaf((shape.batch, shape.seq, cfg.num_kv_heads,
                             cfg.head_dim))}, shape.batch)["k"][1]
        m = 1 if seq is None else axis_size(mesh, seq)
        heads = cfg.num_heads * cfg.head_dim
        # the stationary decode runs every sequence over one row's ranks;
        # each data row attends for the rows it holds (``rows``)
        per_op["all-reduce"] = wire("all-reduce",
                                    shape.batch * cfg.d_model * item,
                                    t) * sub
        per_op["all-gather"] = wire("all-gather",
                                    shape.batch * heads * item, t) * attn
        if m > 1:
            per_op["all-reduce"] += wire(
                "all-reduce", rows * (2 * cfg.num_heads + heads) * 4, m) * attn
        if mixers and gn % t == 0:
            per_op["all-gather"] += wire("all-gather", 2 * rows * gn * item,
                                         t) * mixers
        per_op["all-gather"] += wire("all-gather", shape.batch * 12, t)
        return {"bytes_per_op": per_op, "total_bytes": sum(per_op.values()),
                "sublayers": sub, "sequence_parallel": False,
                "sequence_ranks": m}
    passes = (3 if remat else 2) * accum if shape.kind == "train" else 1
    act = rows * shape.seq * cfg.d_model * item
    sp = shape.seq % t == 0
    if sp:
        per_op["all-gather"] = wire("all-gather", act, t) * sub * passes
        per_op["reduce-scatter"] = wire("reduce-scatter", act / t,
                                        t) * sub * passes
    else:
        per_op["all-reduce"] = wire("all-reduce", act, t) * 2 * sub * passes
    if mixers and gn % t == 0:
        per_op["all-gather"] += wire(
            "all-gather", 2 * rows * shape.seq * gn * item, t) \
            * mixers * passes
    if shape.kind == "train":
        per_op["all-reduce"] += wire("all-reduce", 3 * rows * shape.seq * 4,
                                     t) * passes
    else:
        per_op["all-gather"] += wire("all-gather", rows * 12, t)
    return {"bytes_per_op": per_op, "total_bytes": sum(per_op.values()),
            "sublayers": sub, "sequence_parallel": sp}


def _stacked_dims(cuts) -> Dict[str, tuple]:
    """Whether each reference leaf (dotted stacked name) is cut over the
    FSDP axes, and whether over ``model``, from ``fsdp.cut_dims``."""
    out = {}
    for name, (dim, tp_dim) in cuts.items():
        key = ".".join(p for p in name.split(".") if not p.isdigit())
        data_cut, tp_cut = out.get(key, (False, False))
        out[key] = (data_cut or dim is not None, tp_cut or tp_dim is not None)
    return out


# ------------------------------------------------------------------------ #
# the fake run
# ------------------------------------------------------------------------ #

def _fake(struct, device):
    return torch.zeros(struct.shape, dtype=struct.dtype, device=device)


def _run_train(cfg, model, shape, mesh, accum, mdt, adt):
    step = make_train_step(
        model, opt.OptConfig(moment_dtype=mdt), accum_steps=accum,
        remat=True, accum_dtype=adt,
        mesh=mesh if mesh.size > 1 else None, placement="fsdp")
    ostate = opt.init(dict(model.named_parameters()), moment_dtype=mdt)
    batch = {k: _fake(v, "cpu")
             for k, v in train_batch_struct(cfg, shape).items()}
    step(ostate, batch)


def _run_serve(cfg, model, shape, mesh, rules):
    """Prefill or decode of the whole batch through ``serve.step``'s
    builders, over the mesh (``mesh=``; one device without): the weights
    placed as the train step places them and gathered layer by layer,
    each data row over its ranks, the cache cut as ``cache_specs`` cuts
    it (no slot holds a whole one).  The inputs lie on the CPU (the
    builders move each row's part to its slot).  Returns the outputs,
    which a server keeps (the cache)."""
    on = mesh if mesh.size > 1 else None
    first = mesh.devices.flat[0]
    if shape.kind == "prefill":
        args = [_fake(a, "cpu") for a in prefill_args_struct(cfg, shape)]
        if cfg.is_encoder_decoder:
            fn = serve_step.make_prefill_encdec(
                model, whisper_dec_len(cfg, shape.seq), mesh=on)
        else:
            fn = serve_step.make_prefill(model, shape.seq, mesh=on)
        return fn(*args)
    cache_s, tok_s, _ = decode_args_struct(cfg, shape, model)
    if on:
        # a server places its weights before it makes its cache: the
        # whole model on slot 0 and a cache piece never coexist
        serve_step.placement(model, mesh)
    cache = (fsdp.init_cache(cache_s, mesh, rules, shape.batch) if on
             else map_with_path(lambda _, t: _fake(t, first), cache_s))
    # the last position the self-attention cache holds (the reference's
    # traced position clamps; the port's raises)
    last = (whisper_dec_len(cfg, shape.seq) if cfg.is_encoder_decoder
            else shape.seq) - 1
    return serve_step.make_decode(model, mesh=on)(
        cache, _fake(tok_s, "cpu"), last)


def measure_peak(cfg, shape: ShapeSpec, mesh: Mesh, *, accum: int = 1,
                 moment_dtype: str = "float32",
                 accum_dtype: str = "float32", fake: bool = True,
                 one_slot: bool = False) -> Dict[str, int]:
    """Each device's peak bytes (``MemTracker``) over one call of the
    port's step for ``shape``: the model built (on the CPU, then moved
    to the mesh's first device), its placement, the optimizer state and
    one train step; or one prefill / decode.  On fake tensors, or
    (``fake=False``, a small config on the CPU) real ones.  Slots on the
    ``meta`` device hold no bytes; ``one_slot``: the slots but one lie
    there, and the work that leaves nothing on the other is not run
    (``actctx.one_slot``)."""
    import contextlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    import torch._dynamo.config as dynamo_config
    rules = ShardingRules(cfg, mesh)
    first = mesh.devices.flat[0]
    live = next(d for d in mesh.devices.flat if d.type != "meta")
    # fake cuda and meta tensors in one program trip the fake tensors'
    # dispatch cache in torch 2.11 (an in-kernel assertion at the first
    # backward op): run such a reckoning without the cache
    mixed = live.type == "cuda" and any(d.type == "meta"
                                        for d in mesh.devices.flat)
    with (FakeTensorMode(allow_non_fake_inputs=True) if fake
          else contextlib.nullcontext()), \
            dynamo_config.patch(fake_tensor_cache_enabled=not mixed):
        model = build_model(cfg)
        if first != model.device:
            # parameter by parameter: Module.to cannot swap fake tensors
            for name, p in list(model.named_parameters()):
                fsdp.set_param(model, name, nn.Parameter(p.detach().to(
                    first), requires_grad=p.requires_grad))
        tracker = MemTracker()
        tracker.track_external(model)
        # one thread runs the backward of every device: the fake mode's
        # state is not safe across the autograd engine's device threads
        with tracker, torch.autograd.set_multithreading_enabled(False), \
                (actctx.one_slot() if one_slot else contextlib.nullcontext()):
            if shape.kind == "train":
                _run_train(cfg, model, shape, mesh, accum, moment_dtype,
                           accum_dtype)
            else:
                _run_serve(cfg, model, shape, mesh, rules)
        peak = tracker.get_tracker_snapshot("peak")
    return {str(d): int(v["Total"]) for d, v in peak.items()
            if d.type == live.type}


def slot_mesh(mesh: Mesh, s: int, device) -> Mesh:
    """``mesh``'s layout with slot ``s`` on ``device`` and every other
    slot on ``meta``: one slot's reckoning."""
    grid = np.full(mesh.devices.shape, torch.device("meta"), dtype=object)
    grid.flat[s] = torch.device(device)
    return Mesh(grid, mesh.axis_names)


def slot_peaks(cfg, shape: ShapeSpec, mesh: Mesh, device, *, slots=None,
               **kw) -> Dict[str, int]:
    """One slot's peak bytes a reckoned slot (``measure_peak(...,
    one_slot=True)`` on ``slot_mesh``): slots 0 and n−1 by default —
    slot 0 holds what the one thread that drives the mesh puts there
    (the model before placement, the greedy tokens), slot n−1 is a slot
    like any other.  Keys ``"slot <s>"``."""
    n = mesh.size
    out = {}
    for s in (sorted({0, n - 1}) if slots is None else slots):
        peaks = measure_peak(cfg, shape, slot_mesh(mesh, s, device),
                             one_slot=True, **kw)
        out[f"slot {s}"] = peaks[str(torch.device(device))]
    return out


# ------------------------------------------------------------------------ #

def lower_cell(arch: str, shape, mesh, *, device: str = "cuda",
               accum_steps: int = 1, cfg=None, peak: bool = True
               ) -> Dict[str, Any]:
    """One cell's record.  ``shape``: a name in ``SHAPES`` or a
    ``ShapeSpec``; ``mesh``: a name in ``MESHES`` (its devices fake
    ``device`` slots) or a ``launch.mesh.Mesh``; ``cfg``: the arch's
    config by default; ``peak=False`` skips the fake run."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh_name = mesh if isinstance(mesh, str) else "x".join(
        str(v) for v in mesh.shape.values())
    reason = skip_reason(cfg, shape.name)
    if reason:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "skipped": reason}
    if isinstance(mesh, str):
        mesh = make_mesh(mesh, device)
    rules = ShardingRules(cfg, mesh)
    n = mesh.size
    accum, mdt, adt = 1, "float32", "float32"
    if shape.kind == "train":
        mdt = MOMENT_DTYPE.get(arch, "float32")
        adt = ACCUM_DTYPE.get(arch, "float32")
        accum = max(accum_steps, TRAIN_ACCUM.get(arch, 1))
        # each microbatch must stay divisible by the DP axis group
        accum = min(accum, max(shape.batch // rules.dp_size, 1))

    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = build_model(cfg)
        params = dict(model.named_parameters())
        ref_shapes = reference_shapes(cfg, params)
        cuts = fsdp.cut_dims(cfg, rules, params)
        dims = _stacked_dims(cuts)
        leaves = [(k, tuple(p.shape), *cuts[k]) for k, p in params.items()]
        cache_struct = (decode_args_struct(cfg, shape, model)[0]
                        if shape.kind == "decode" else None)
        del model, params
    state = state_bytes(cfg, ref_shapes, rules, shape, accum=accum,
                        moment_dtype=mdt, accum_dtype=adt,
                        cache_struct=cache_struct)

    tp = mesh.shape["model"]
    # a pod's 256 slots (512 over two pods) run one slot's program each
    one_slot = mesh.size > 4
    over = state["total"] >= HBM_CAPACITY
    t0 = time.time()
    peaks, peak_reason = None, None
    kw = dict(accum=accum, moment_dtype=mdt, accum_dtype=adt)
    if over:
        # the port holds at least the spec tables' state on each device
        peak_reason = (f"the state alone, {state['total'] / 1e9:.1f} GB a "
                       f"device, exceeds {HBM_CAPACITY / 1e9:.0f} GB")
    elif peak and one_slot:
        peaks = slot_peaks(cfg, shape, mesh, torch.device(device, 0)
                           if device != "cpu" else "cpu", **kw)
    elif peak:
        peaks = measure_peak(cfg, shape, mesh, **kw)
    measure_s = time.time() - t0
    per_device = max(peaks.values()) if peaks else None
    shared = not one_slot and len(set(mesh.devices.flat)) < n
    peak_mode = None if peaks is None else (
        f"one slot's program on fake {device} tensors (slots "
        f"{', '.join(k[5:] for k in peaks)} of {n}; the others meta)"
        if one_slot else f"fake {mesh.devices.flat[0].type} tensors, "
        + (f"the {n} slots sharing one device: each peak is their sum"
           if shared else "one device a slot"))
    if peaks is not None and shared:
        # one device's peak holds every slot's: no one card's fit
        per_device = None
        peak_reason = (f"the mesh's {n} slots share one device, whose peak "
                       "is their sum, not one card's")

    a_flops_total = analysis.step_flops(cfg, shape.batch, shape.seq,
                                        shape.kind)
    cache_bytes = 0.0
    if shape.kind != "train":
        cs = cache_struct
        if cs is None:
            with FakeTensorMode(allow_non_fake_inputs=True):
                cs = decode_args_struct(cfg, shape, build_model(cfg))[0]
        cache_bytes = analysis.cache_total_bytes(cs)
    a_bytes_dev = analysis.hbm_bytes(cfg, shape.batch, shape.seq,
                                     shape.kind, n,
                                     cache_bytes_total=cache_bytes)
    grad_item = _dtype_bytes(adt) if accum > 1 else _dtype_bytes(cfg.dtype)
    coll = fsdp_collectives(
        ref_shapes, dims, rules.fsdp_size, shape.kind, accum=accum,
        remat=True, grad_bytes=grad_item, tp=tp)
    if shape.kind == "decode" and rules.fsdp_size > 1:
        coll["data"] = stationary_collectives(cfg, shape, leaves,
                                              rules.fsdp_size, tp)
        coll["total_bytes"] += coll["data"]["total_bytes"]
    if tp > 1:
        coll["tp"] = tp_collectives(cfg, shape, mesh, accum=accum,
                                    remat=True)
        coll["total_bytes"] += coll["tp"]["total_bytes"]
    mf = model_flops(cfg, shape)
    compute_t = a_flops_total / n / PEAK_FLOPS
    memory_t = a_bytes_dev / HBM_BW
    coll_t = coll["total_bytes"] / LINK_BW
    terms = {"compute": compute_t, "memory": memory_t,
             "collective": coll_t}
    dominant = max(terms.items(), key=lambda kv: kv[1])[0]
    return {
        "arch": arch, "shape": shape.name, "kind": shape.kind,
        "batch": shape.batch, "seq": shape.seq,
        "mesh": {a: int(mesh.shape[a]) for a in mesh.axis_names},
        "mesh_name": mesh_name, "devices": int(n),
        "device": str(mesh.devices.flat[0].type),
        "accum_steps": accum, "moment_dtype": mdt, "accum_dtype": adt,
        "state_bytes": state,
        "peak_bytes": peaks, "peak_mode": peak_mode,
        "per_device_peak_bytes": per_device,
        "peak_reason": peak_reason, "measure_s": measure_s,
        "fits_80gb": False if over else (
            None if per_device is None else bool(per_device < HBM_CAPACITY)),
        "analytic_flops_total": a_flops_total,
        "analytic_bytes_per_device": a_bytes_dev,
        "cache_bytes_total": cache_bytes,
        "collectives": coll,
        "model_flops_total": mf,
        "useful_flops_ratio": mf / a_flops_total,
        "roofline_s": terms,
        "dominant": dominant,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="1x1",
                    help="comma-separated: " + ", ".join(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="the fake devices.  cuda: fake cuda:0..3 tensors for 1x1 / "
             "4x1 / 1x4 / 2x2, one device a slot, so each peak is one "
             "card's; needs a PyTorch built with CUDA and as many visible "
             "cards as the mesh has slots (four for 4x1, 1x4, 2x2), whose "
             "memory it does not use; pod and multipod reckon one slot's "
             "program on a fake cuda:0 (one card), the other slots meta.  "
             "cpu: the CPU path, runs anywhere; the slots of a four-slot "
             "mesh share the one CPU device, so its record holds their "
             "summed peak and no per-card peak or fit; a pod's reckoned "
             "slot is the CPU, its peak one slot's")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = arch_names() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = args.mesh.split(",")
    for m in meshes:
        if m not in MESHES:
            ap.error(f"--mesh {m!r}: one of {', '.join(MESHES)}")
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                name = f"{arch}__{shape}__{mesh}"
                path = os.path.join(args.out, name + ".json")
                if os.path.exists(path):
                    print(f"[skip existing] {name}")
                    continue
                print(f"[dryrun] {name} ...", flush=True)
                try:
                    rec = lower_cell(arch, shape, mesh, device=args.device,
                                     accum_steps=args.accum_steps)
                except Exception as e:  # record failures, keep going
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[dryrun] {name}: {_status(rec)}", flush=True)


def _status(rec: Dict[str, Any]) -> str:
    if "skipped" in rec:
        return "SKIP " + rec["skipped"]
    if "error" in rec:
        return "ERROR " + rec["error"][:120]
    st = rec["state_bytes"]["total"] / 1e9
    pk = rec["per_device_peak_bytes"]
    peak = (f"peak={pk / 1e9:.2f}GB fits_80gb={rec['fits_80gb']}"
            if pk is not None else f"peak=n/a ({rec['peak_reason']})")
    return (f"ok state={st:.2f}GB {peak} dominant={rec['dominant']} "
            f"({rec['measure_s']:.1f}s)")


if __name__ == "__main__":
    main()
