"""One slot's reckoning in the port's dry run (``launch.dryrun.slot_peaks``
under ``actctx.one_slot``) held against the whole program, on the CPU.

Under SPMD every slot of a mesh runs the same program, so the dry run
reckons a ``pod`` (16 × 16) or ``multipod`` (2 × 16 × 16) cell's per-card
peak from one slot's program: the reckoned slot on the fake device,
every other slot on ``meta`` (no bytes), and the work that leaves
nothing on the reckoned slot not run.  Here the reckoning of slot 0 and
of slot n−1 equals, to the byte, ``MemTracker``'s peak of the same slot
in the whole program — that slot on the CPU, every other slot on
``meta``, all of their work run: the train step (data rows skipped,
their gathers' gradient slices sent to the slot), prefill (gathers, a
batch cut over data) and decode (the weight-stationary layout) of the
five families' smoke configs, cut to one layer (the hybrid to one
period of two) and 4 sequences of 8 tokens.  The cases are chosen to fit
the suite's time: every family's prefill and decode at ``2x2``, a train
step at ``2x2`` (a data row's gathers sending the slot its slices) and at
``4x1`` (three skipped rows), and a decode at ``4x1`` and at ``1x4``; ``scripts/one_slot_check.py`` runs every family ×
kind × mesh.  At ``1x1`` the reckoning is the one-device
run; at ``pod`` and ``multipod`` the reckoned slot holds exactly the
spec tables' state (``dryrun.state_bytes``).
"""

import importlib.util
import os

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import smoke_config
from repro_torch.distributed import actctx, fsdp
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun, shapes
from repro_torch.models.convert import reference_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "one_slot_check", os.path.join(ROOT, "scripts", "one_slot_check.py"))
check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: fake tensors gain nothing from more, and
    under a parallel test run they keep this file from thrashing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = ([(f, k, "2x2") for f in check.FAMILIES for k in ("decode",
                                                           "prefill")]
         + [("dense", "train", "2x2"), ("ssm", "train", "4x1"),
            ("hybrid", "decode", "4x1"), ("ssm", "decode", "1x4")])


@pytest.mark.parametrize("family,kind,mesh", CASES,
                         ids=["-".join(c) for c in CASES])
def test_one_slot_peak_equals_the_whole_program(family, kind, mesh):
    """Slots 0 and n−1: ``slot_peaks`` equals the whole program's peak
    of that slot, its other slots on ``meta``."""
    for slot, whole, one in check.compare(family, kind, mesh):
        assert one == whole, (family, kind, mesh, slot)


def test_one_device_reckoning_is_the_one_device_run():
    """At ``1x1`` the one slot is the whole mesh: the reckoning runs
    the one-device program and gives its peak exactly."""
    cfg = check.config("dense")
    mesh = dryrun.make_mesh("1x1", "cpu")
    for kind in ("decode", "prefill", "train"):
        spec = check.shape(kind)
        assert dryrun.slot_peaks(cfg, spec, mesh, "cpu") == {
            "slot 0": dryrun.measure_peak(cfg, spec, mesh)["cpu"]}, kind


@pytest.mark.parametrize("family", ["dense", "hybrid", "encdec"])
def test_reckoned_slot_holds_the_spec_state_on_pods(family):
    """On ``pod`` and ``multipod`` (FSDP over ``(pod, data)``) the
    reckoned slot (0 and n−1) holds exactly ``state_bytes``' parameters
    and, for a decode of 64 sequences (a batch the 32 data rows of two
    pods cut) and of 3 (a batch they do not: the K/V's sequence spread
    over a pod's slots), its cache piece."""
    cfg = check.config(family)
    for name in ("pod", "multipod"):
        base = dryrun.make_mesh(name)
        for s in (0, base.size - 1):
            mesh = dryrun.slot_mesh(base, s, "cpu")
            rules = ShardingRules(cfg, mesh)
            with FakeTensorMode(allow_non_fake_inputs=True):
                model = dryrun.build_model(cfg)
                ref = reference_shapes(cfg, dict(model.named_parameters()))
                for k, p in list(model.named_parameters()):
                    fsdp.set_param(model, k, torch.nn.Parameter(
                        p.detach().to(mesh.devices.flat[0])))
                with actctx.one_slot():
                    slots = fsdp.place(model, mesh, rules)
                    held = {id(p): p for p in slots[s].parameters()}
                    for batch in (64, 3):
                        spec = shapes.ShapeSpec("d", "decode", 256, batch)
                        struct = shapes.decode_args_struct(cfg, spec,
                                                           model)[0]
                        placed = fsdp.init_cache(struct, mesh, rules, batch)
                        state = dryrun.state_bytes(
                            cfg, ref, rules, spec, accum=1,
                            moment_dtype="float32", accum_dtype="float32",
                            cache_struct=struct)
                        assert sum(p.numel() * p.element_size()
                                   for p in held.values()) == \
                            state["params"], (name, s)
                        assert _tree_bytes(placed.slots[s]) == \
                            state["cache"], (name, s, batch)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def test_one_slot_peak_equals_the_whole_program_on_a_pod():
    """At ``pod`` itself (16 × 16), a decode whose batch the data rows
    cut (32 sequences, the layout of ``decode_32k``): slot 255's
    reckoning of qwen3-4b's smoke config equals the whole program of
    that slot.  One layer, narrow widths, but 8 kv heads over the 16
    sequence ranks of a data row."""
    cfg = smoke_config("qwen3-4b").replace(
        num_layers=1, num_heads=32, num_kv_heads=8, head_dim=16,
        d_model=256, d_ff=512, vocab_size=512)
    spec = shapes.ShapeSpec("d", "decode", 64, 32)
    base = dryrun.make_mesh("pod", "cpu")
    one = dryrun.slot_peaks(cfg, spec, base, "cpu", slots=[255])
    whole = dryrun.measure_peak(cfg, spec,
                                dryrun.slot_mesh(base, 255, "cpu"))["cpu"]
    assert one == {"slot 255": whole}
