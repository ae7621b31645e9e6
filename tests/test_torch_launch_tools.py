"""The port's launch tools beside the reference's, on the CPU:
``launch.shapes``, ``launch.analysis``, ``launch.mesh.make_production_mesh``
and the dry run (``launch.dryrun``).

* shapes: every arch × shape's train batch, prefill arguments and decode
  cache (built on fake tensors by the port's ``init_cache``; by
  ``jax.eval_shape`` in the reference) have the reference's shapes and
  dtypes, and the same skip reasons;
* analysis: the analytic FLOPs and HBM bytes of every cell are the
  reference's, to the last bit (the same formulas);
* the dry run's per-device state bytes — parameters, gradients or
  accumulators, moments, decode caches — equal the sum over the
  reference's ``ShardingRules`` local shapes × dtype bytes on
  ``AbstractMesh`` at (1, 1), (4, 1), (16, 16) and (2, 16, 16);
* the dry run's fake peak (``FakeTensorMode`` under ``MemTracker``)
  equals ``MemTracker``'s peak of the same step on real CPU tensors, on
  smoke configs.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported,
so its constants are read from its source, and its production mesh is
built in a child process with 512 placeholder CPU devices.
"""

import ast
import importlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import arch_names, get_config, smoke_config
from repro_torch.distributed import fsdp
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import analysis, dryrun, shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.convert import reference_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the smoke steps gain nothing from more, and
    under a parallel test run they keep this file from thrashing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    imp = importlib.import_module
    jax = imp("jax")
    return types.SimpleNamespace(
        jax=jax, jnp=imp("jax.numpy"),
        shapes=imp("repro.launch.shapes"),
        analysis=imp("repro.launch.analysis"),
        Rules=imp("repro.distributed.sharding").ShardingRules,
        LM=imp("repro.models.transformer").LM,
        EncDec=imp("repro.models.encdec").EncDec,
        opt=imp("repro.train.optimizer"),
        configs=imp("repro.configs"))


@pytest.fixture(scope="module")
def fake_models():
    """Every full config's port model on fake tensors (no bytes)."""
    cache = {}

    def get(name):
        if name not in cache:
            with FakeTensorMode(allow_non_fake_inputs=True):
                cache[name] = dryrun.build_model(get_config(name))
        return cache[name]
    return get


def ref_model(ref, name):
    cfg = ref.configs.get_config(name)
    return (ref.EncDec if cfg.is_encoder_decoder else ref.LM)(cfg)


def flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of structs (either
    package's)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).replace("torch.", ""))}


# --------------------------------------------------------------------- #
# shapes, analysis, the production mesh
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", arch_names())
def test_shapes_match_reference(ref, fake_models, name):
    """All four shapes of one arch: skip reasons, decoder lengths, the
    train batch, the prefill arguments and the decode arguments."""
    cfg, rcfg = get_config(name), ref.configs.get_config(name)
    assert list(shapes.SHAPES) == list(ref.shapes.SHAPES)
    for key, spec in shapes.SHAPES.items():
        rspec = ref.shapes.SHAPES[key]
        assert (spec.name, spec.kind, spec.seq, spec.batch) == (
            rspec.name, rspec.kind, rspec.seq, rspec.batch)
        assert shapes.skip_reason(cfg, key) == \
            ref.shapes.skip_reason(rcfg, key)
        assert shapes.whisper_dec_len(cfg, spec.seq) == \
            ref.shapes.whisper_dec_len(rcfg, spec.seq)
        assert flat(shapes.train_batch_struct(cfg, spec)) == flat(
            ref.shapes.train_batch_struct(rcfg, rspec))
        assert flat(shapes.prefill_args_struct(cfg, spec)) == flat(
            ref.shapes.prefill_args_struct(rcfg, rspec))
        if spec.kind == "decode":
            got = shapes.decode_args_struct(cfg, spec, fake_models(name))
            want = ref.shapes.decode_args_struct(rcfg, rspec,
                                                 ref_model(ref, name))
            assert flat(got) == flat(want), (name, key)
            assert analysis.cache_total_bytes(got[0]) == \
                ref.analysis.cache_total_bytes(want[0])


def test_analysis_matches_reference_on_every_cell(ref):
    for name in arch_names():
        cfg, rcfg = get_config(name), ref.configs.get_config(name)
        assert analysis.param_bytes(cfg) == ref.analysis.param_bytes(rcfg)
        for spec in shapes.SHAPES.values():
            args = (spec.batch, spec.seq, spec.kind)
            assert analysis.forward_flops(cfg, *args) == \
                ref.analysis.forward_flops(rcfg, *args)
            for remat in (True, False):
                assert analysis.step_flops(cfg, *args, remat=remat) == \
                    ref.analysis.step_flops(rcfg, *args, remat=remat)
            for chips in (1, 4, 256, 512):
                assert analysis.hbm_bytes(
                    cfg, *args, chips, cache_bytes_total=3e9) == \
                    ref.analysis.hbm_bytes(rcfg, *args, chips,
                                           cache_bytes_total=3e9)
    for kind, rbytes, g in (("all-gather", 1e6, 4), ("all-reduce", 3e5, 8),
                            ("reduce-scatter", 7e4, 2), ("all-to-all", 5, 1),
                            ("collective-permute", 9e3, 16)):
        assert analysis._wire_bytes(kind, rbytes, g) == \
            ref.analysis._wire_bytes(kind, rbytes, g)


def _reference_dryrun_source():
    with open(os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")) as f:
        return ast.parse(f.read())


def test_dryrun_keeps_the_reference_knobs():
    """``TRAIN_ACCUM``, ``MOMENT_DTYPE``, ``ACCUM_DTYPE`` and
    ``model_flops`` are the reference's."""
    tree = _reference_dryrun_source()
    consts, funcs = {}, {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            consts[node.targets[0].id] = ast.literal_eval(node.value)
        if isinstance(node, ast.FunctionDef) and node.name == "model_flops":
            ns = {"ShapeSpec": shapes.ShapeSpec}
            exec(compile(ast.Module([node], []), "<ref>", "exec"), ns)
            funcs["model_flops"] = ns["model_flops"]
    for key in ("TRAIN_ACCUM", "MOMENT_DTYPE", "ACCUM_DTYPE"):
        assert getattr(dryrun, key) == consts[key], key
    for name in arch_names():
        for spec in shapes.SHAPES.values():
            assert dryrun.model_flops(get_config(name), spec) == \
                funcs["model_flops"](get_config(name), spec)


def test_production_mesh_matches_reference():
    code = ("import os\n"
            "os.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=512'\n"
            "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
            "from repro.launch.mesh import make_production_mesh\n"
            "for mp in (False, True):\n"
            "    m = make_production_mesh(multi_pod=mp)\n"
            "    print(dict(m.shape), tuple(m.axis_names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = out.stdout.strip().splitlines()
    for mp, line in zip((False, True), want):
        mesh = make_production_mesh(multi_pod=mp)
        assert f"{dict(mesh.shape)} {tuple(mesh.axis_names)}" == line
        assert {str(d) for d in mesh.devices.flat} == {"meta"}


# --------------------------------------------------------------------- #
# the dry run: state bytes and peaks
# --------------------------------------------------------------------- #

def _ref_local_bytes(ref, structs, specs, mesh, itemsize=None):
    total = 0
    leaves = ref.jax.tree.leaves(structs)
    spec_leaves = ref.jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, ref.jax.sharding.PartitionSpec))
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim):
            if ax is not None:
                axes = (ax,) if isinstance(ax, str) else ax
                dim //= int(np.prod([mesh.shape[a] for a in axes]))
            n *= dim
        total += n * (itemsize or leaf.dtype.itemsize)
    return total


def _ref_state_bytes(ref, name, key, mesh_name, params, cache):
    """The reference's per-device state of one cell from its own spec
    tables on an ``AbstractMesh``: ``params`` its parameter structs,
    ``cache`` a decode cell's cache structs."""
    rcfg = ref.configs.get_config(name)
    spec = ref.shapes.SHAPES[key]
    mesh = ref.jax.sharding.AbstractMesh(*MESHES[mesh_name])
    rules = ref.Rules(rcfg, mesh)
    pspecs = rules.param_specs(params)
    out = {"params": _ref_local_bytes(ref, params, pspecs, mesh)}
    if spec.kind == "train":
        accum = max(1, dryrun.TRAIN_ACCUM.get(name, 1))
        accum = min(accum, max(spec.batch // rules.dp_size, 1))
        mdt = np.dtype(ref.jnp.dtype(dryrun.MOMENT_DTYPE.get(name,
                                                             "float32")))
        adt = np.dtype(ref.jnp.dtype(dryrun.ACCUM_DTYPE.get(name,
                                                            "float32")))
        out["grads"] = (_ref_local_bytes(ref, params, pspecs, mesh,
                                         adt.itemsize)
                        if accum > 1 else out["params"])
        out["moments"] = 2 * _ref_local_bytes(ref, params, pspecs, mesh,
                                              mdt.itemsize)
    if spec.kind == "decode":
        out["cache"] = _ref_local_bytes(
            ref, cache, rules.cache_specs(cache, spec.batch), mesh)
    out["total"] = sum(out.values())
    return out


@pytest.mark.parametrize("name", arch_names())
def test_state_bytes_match_reference_spec_tables(ref, fake_models, name):
    """Every shape of one arch on the four layouts (skipped cells
    aside)."""
    model = fake_models(name)
    cfg = get_config(name)
    with FakeTensorMode(allow_non_fake_inputs=True):
        ref_shapes = reference_shapes(cfg, dict(model.named_parameters()))
    rmodel = ref_model(ref, name)
    rparams = ref.jax.eval_shape(
        lambda: rmodel.init(ref.jax.random.PRNGKey(0)))
    caches = {key: (shapes.decode_args_struct(cfg, spec, model)[0],
                    ref.shapes.decode_args_struct(
                        ref.configs.get_config(name),
                        ref.shapes.SHAPES[key], rmodel)[0])
              for key, spec in shapes.SHAPES.items()
              if spec.kind == "decode" and not shapes.skip_reason(cfg, key)}
    for mesh_name in MESHES:
        rules = ShardingRules(cfg, dryrun.make_mesh(mesh_name, "cpu"))
        for key, spec in shapes.SHAPES.items():
            if shapes.skip_reason(cfg, key):
                continue
            accum, mdt, adt = 1, "float32", "float32"
            if spec.kind == "train":
                mdt = dryrun.MOMENT_DTYPE.get(name, mdt)
                adt = dryrun.ACCUM_DTYPE.get(name, adt)
                accum = min(dryrun.TRAIN_ACCUM.get(name, 1),
                            max(spec.batch // rules.dp_size, 1))
            cache, rcache = caches.get(key, (None, None))
            got = dryrun.state_bytes(cfg, ref_shapes, rules, spec,
                                     accum=accum, moment_dtype=mdt,
                                     accum_dtype=adt, cache_struct=cache)
            assert got == _ref_state_bytes(ref, name, key, mesh_name,
                                           rparams, rcache), (mesh_name, key)


def test_lower_cell_records_without_a_fake_run():
    """A whole record for a train cell (no fake run) and a pod cell:
    state bytes, the FSDP collective term (none on one device; the
    reference's ring factors on four) and the roofline terms on the H100
    datasheet rates; the pod's decode (a smoke config, one slot's
    program on the CPU for slots 0 and 255) with a per-card peak, its
    fit, and a collective term of the data axis's activations and the
    model axis's, no weight gathered."""
    one = dryrun.lower_cell("qwen3-4b", "train_4k", "1x1", peak=False)
    four = dryrun.lower_cell("qwen3-4b", "train_4k", "4x1", peak=False)
    pod = dryrun.lower_cell("qwen3-4b", shapes.ShapeSpec(
        "decode", "decode", 256, 32), "pod", device="cpu",
        cfg=smoke_config("qwen3-4b"))
    assert one["collectives"]["total_bytes"] == 0
    sharded = four["collectives"]["sharded_param_bytes"]
    ops = four["collectives"]["bytes_per_op"]
    assert ops["all-gather"] == 2 * sharded * 3 / 4
    assert ops["reduce-scatter"] == sharded * 3 / 4
    assert four["state_bytes"]["params"] < one["state_bytes"]["params"]
    assert one["roofline_s"]["compute"] == (
        analysis.step_flops(get_config("qwen3-4b"), 256, 4096, "train")
        / dryrun.PEAK_FLOPS)
    assert set(pod["peak_bytes"]) == {"slot 0", "slot 255"}
    assert pod["per_device_peak_bytes"] == max(pod["peak_bytes"].values())
    assert pod["per_device_peak_bytes"] > pod["state_bytes"]["total"]
    assert pod["peak_reason"] is None and pod["fits_80gb"] is True
    coll = pod["collectives"]
    assert coll["bytes_per_op"]["all-gather"] == 0    # no weight gathered
    assert coll["data"]["total_bytes"] > 0 and coll["tp"]["total_bytes"] > 0
    assert coll["total_bytes"] == coll["data"]["total_bytes"] \
        + coll["tp"]["total_bytes"]
    assert pod["roofline_s"]["collective"] == (coll["total_bytes"]
                                               / dryrun.LINK_BW)
    skipped = dryrun.lower_cell("qwen3-4b", "long_500k", "1x1")
    assert "skipped" in skipped


CASES = [("qwen3-4b", "train", "1x1", 32), ("qwen3-4b", "prefill", "1x1", 32),
         ("qwen3-4b", "decode", "1x1", 32),
         ("qwen3-moe-30b-a3b", "train", "2x1", 32),
         ("mamba2-370m", "decode", "4x1", 32),
         ("whisper-base", "prefill", "1x1", 32),
         ("whisper-base", "decode", "1x1", 1024),
         ("qwen3-4b", "prefill", "1x4", 32),
         ("jamba-1.5-large-398b", "decode", "2x2", 32)]


@pytest.mark.parametrize("name,kind,mesh,seq", CASES)
def test_fake_peak_equals_real_cpu_peak(name, kind, mesh, seq):
    """The dry run's peak of a smoke config on fake CPU tensors equals
    ``MemTracker``'s peak of the same step on real ones (whisper's decode
    cache holds its decoder length, not the frames')."""
    cfg = smoke_config(name)
    spec = shapes.ShapeSpec(kind, kind, seq, 8)
    rec = dryrun.lower_cell(name, spec, mesh, device="cpu", cfg=cfg)
    real = dryrun.measure_peak(
        cfg, spec, dryrun.make_mesh(mesh, "cpu"), accum=rec["accum_steps"],
        moment_dtype=rec["moment_dtype"], accum_dtype=rec["accum_dtype"],
        fake=False)
    assert rec["peak_bytes"] == real
    if mesh == "1x1":
        assert rec["per_device_peak_bytes"] > rec["state_bytes"]["total"]
        assert rec["fits_80gb"] is True
        assert rec["peak_mode"] == "fake cpu tensors, one device a slot"
    else:
        # the slots share the CPU: its peak is their sum, no card's
        assert rec["per_device_peak_bytes"] is None
        assert rec["fits_80gb"] is None
        assert "sharing one device" in rec["peak_mode"]
        assert real["cpu"] > rec["state_bytes"]["total"]


def test_serving_records_at_1x4_and_2x2():
    """Prefill and decode at ``model`` > 1 are no longer queued: their
    records carry a peak (the CPU's, the slots' sum) and a
    tensor-parallel collective term — prefill's sequence-parallel pair a
    sublayer, decode's all-reduces over the ranks that hold the cache's
    sequence."""
    cfg = smoke_config("qwen3-4b")
    for kind, mesh in (("prefill", "2x2"), ("decode", "1x4")):
        spec = shapes.ShapeSpec(kind, kind, 32, 8)
        rec = dryrun.lower_cell("qwen3-4b", spec, mesh, device="cpu",
                                cfg=cfg)
        assert rec["peak_bytes"]["cpu"] > rec["state_bytes"]["total"]
        tp = rec["collectives"]["tp"]
        assert tp["total_bytes"] > 0 and tp["sublayers"] == 2 * \
            cfg.num_layers
        if kind == "decode":
            assert tp["sequence_ranks"] == 4


def test_batch_one_decode_cuts_its_cache_over_the_data_axis():
    """A batch-1 decode at ``4x1`` (``long_500k``'s layout, at a smoke
    config): ``cache_specs`` cuts the K/V's sequence over ``(data,
    model)``, so each slot holds a quarter of the whole cache — in the
    state bytes and in the pieces the run allocates — and the fake peak
    equals a real CPU run's."""
    name = "h2o-danube-1.8b"
    cfg = smoke_config(name)
    spec = shapes.ShapeSpec("long", "decode", 64, 1)
    one = dryrun.lower_cell(name, spec, "1x1", device="cpu", cfg=cfg)
    rec = dryrun.lower_cell(name, spec, "4x1", device="cpu", cfg=cfg)
    assert rec["state_bytes"]["cache"] * 4 == one["state_bytes"]["cache"]
    mesh = dryrun.make_mesh("4x1", "cpu")
    real = dryrun.measure_peak(cfg, spec, mesh, fake=False)
    assert rec["peak_bytes"] == real
    model = dryrun.build_model(cfg)
    placed = fsdp.init_cache(model.init_cache(1, 64, "meta"), mesh,
                             ShardingRules(cfg, mesh), 1)
    assert [tuple(t["k"].shape) for t in placed.slots] == [
        (cfg.num_layers, 1, 16, cfg.num_kv_heads, cfg.head_dim)] * 4


def test_cli_writes_one_file_a_cell(tmp_path, capsys, monkeypatch):
    """One file a cell and a status line each; the pods' one-slot peaks
    (``tests/test_torch_pod_dryrun.py``) stand in as given numbers."""
    monkeypatch.setattr(dryrun, "slot_peaks", lambda cfg, shape, mesh, dev,
                        **kw: {"slot 0": 3e9, f"slot {mesh.size - 1}": 2e9})
    dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k", "--mesh",
                 "pod,multipod", "--out", str(tmp_path)])
    files = sorted(os.listdir(tmp_path))
    assert files == ["qwen3-4b__train_4k__multipod.json",
                     "qwen3-4b__train_4k__pod.json"]
    assert capsys.readouterr().out.count("peak=3.00GB fits_80gb=True") == 2
