"""The port's FSDP placement (``make_train_step(..., placement="fsdp")``,
``distributed.fsdp``) on the CPU, beside the single-device step of both
packages.

A mesh here is ``make_host_mesh(data=n, device="cpu")``: n slots on the
one CPU device, each holding its own shard of every leaf the spec tables
cut over ``data`` (the layout of n cards, on one device).  Inputs are the
``TokenPipeline``'s batches (8 × 16), the weights the reference's
``init`` carried into the port.  Tolerances, those of
``tests/test_torch_train_dp.py``:

* against the port's one-device step (fp32 smoke configs, 3 steps):
  loss, MoE aux loss and grad norm within rtol 1e-5 (fp32 sums in
  another order); parameters under the Adam rule — elements whose
  gradient exceeds 1e-4·max|g| of their leaf at every step within rtol
  1e-5 + atol 1e-7, the others within 2·lr a step;
* against the reference's single-device trajectory (its jitted step):
  losses and parameters within atol 5e-3 / rtol 5e-3.

The reference is imported inside fixtures, so the card, which has no
JAX, can still collect this file.
"""

import gc
import importlib
import json
import os
import shutil
import types
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import actctx, fsdp
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as MOE
from repro_torch.models.convert import (from_reference_params,
                                        to_reference_params)
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step

FAMILIES = {"dense": "h2o-danube-1.8b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-370m", "hybrid": "jamba-1.5-large-398b",
            "encdec": "whisper-base"}
B, S, STEPS, LR = 8, 16, 3, 1e-3
RTOL = 1e-5             # port FSDP vs port one-device, fp32
REF_TOL = 5e-3          # the reference test's atol / rtol


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    under a parallel test run they keep this file from thrashing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    imp = importlib.import_module
    return types.SimpleNamespace(
        jax=imp("jax"), jnp=imp("jax.numpy"),
        LM=imp("repro.models.transformer").LM,
        EncDec=imp("repro.models.encdec").EncDec,
        opt=imp("repro.train.optimizer"),
        step=imp("repro.train.step"),
        ckpt=imp("repro.distributed.checkpoint"),
        collectives=imp("repro.distributed.collectives"),
        Rules=imp("repro.distributed.sharding").ShardingRules,
        configs=imp("repro.configs"))


def ref_model(ref, name):
    rcfg = ref.configs.smoke_config(name)
    return (ref.EncDec if rcfg.is_encoder_decoder else ref.LM)(rcfg)


@pytest.fixture(scope="module")
def runs(ref):
    """Cached per family: the reference's initial weights, its
    single-device trajectory, and the port's one-device trajectory."""
    cache = {}

    def get(family):
        if family not in cache:
            name = FAMILIES[family]
            rm = ref_model(ref, name)
            params = rm.init(ref.jax.random.PRNGKey(0))
            pipe = TokenPipeline(smoke_config(name), B, S)
            rstep = ref.jax.jit(ref.step.make_train_step(
                rm, ref.opt.OptConfig(lr=LR)))
            p, o, losses = params, ref.opt.init(params), []
            for i in range(STEPS):
                p, o, m = rstep(p, o, pipe.batch_at(i))
                losses.append(float(m["loss"]))
            cache[family] = types.SimpleNamespace(
                params0=params, ref_losses=losses,
                ref_final=from_reference_params(smoke_config(name), p),
                one=port_run(name, params, None))
        return cache[family]
    return get


def port_model(name, params0):
    cfg = smoke_config(name)
    model = (EncDec if cfg.is_encoder_decoder else LM)(cfg, device="cpu")
    model.load_state_dict(from_reference_params(cfg, params0))
    return model


def whole_params(model):
    return {k: fsdp.whole(p).detach().clone()
            for k, p in model.named_parameters()}


def port_run(name, params0, mesh, steps=STEPS, opt_first=False, **kw):
    """``steps`` port train steps from the reference's weights (FSDP
    placement over ``mesh``; one device without): each step's metrics
    and whole gradients, the final whole parameters, the step and the
    optimizer state.  ``opt_first``: the optimizer state is made from
    the whole parameters before the step is built (the step cuts it at
    its first call)."""
    model = port_model(name, params0)
    seen = []

    def keep(g):
        # slot 0's call comes first and holds every leaf: its shards
        # joined give the whole gradient, the replicated leaves as they are
        if not seen:
            seen.append({k: fsdp.whole(t).clone() for k, t in g.items()})
        return g

    ostate = opt.init(dict(model.named_parameters())) if opt_first else None
    step = make_train_step(model, opt.OptConfig(lr=LR), mesh=mesh,
                           placement="fsdp", grad_transform=keep, **kw)
    if ostate is None:
        ostate = opt.init(dict(model.named_parameters()))
    pipe = TokenPipeline(smoke_config(name), B, S)
    metrics, grads = [], []
    for i in range(steps):
        m = step(ostate, pipe.batch_at(i))
        metrics.append({k: float(m[k]) for k in ("loss", "aux",
                                                 "grad_norm")})
        grads.append(seen[0])
        seen.clear()
    return types.SimpleNamespace(
        metrics=metrics, grads=grads, ostate=ostate, step=step, model=model,
        params=whole_params(model))


def adam_close(got, want, steps, lr=LR):
    for k, w in want.params.items():
        g = torch.stack([gs[k].abs() / gs[k].abs().max().clamp_min(1e-30)
                         for gs in want.grads]).amin(0)
        tight = g > 1e-4
        a, b = got.params[k], w
        np.testing.assert_allclose(a[tight].numpy(), b[tight].numpy(),
                                   rtol=RTOL, atol=1e-7, err_msg=k)
        err = (a - b).abs()[~tight]
        assert bool((err <= 2 * lr * steps).all()), (k, float(err.max()))


def metrics_close(got, want):
    for g, w in zip(got.metrics, want.metrics):
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                       atol=1e-30, err_msg=key)


def stacked_local_shape(ref, name, data):
    """Each port parameter's local shape on a ``(data, 1)`` mesh as the
    reference's rules imply it: its stacked leaf's spec, without the
    leading layer axes, applied to the per-layer shape."""
    rcfg = ref.configs.smoke_config(name)
    shapes = ref.jax.eval_shape(
        lambda: ref_model(ref, name).init(ref.jax.random.PRNGKey(0)))
    rules = ref.Rules(rcfg, ref.jax.sharding.AbstractMesh(
        (data, 1), ("data", "model")))
    specs = rules.param_specs(shapes)

    def local(port_name, shape):
        parts = port_name.split(".")
        path = [p for p in parts if not p.isdigit()]
        spec = specs
        for p in path:
            spec = spec[p]
        tail = tuple(spec)[len(parts) - len(path):]
        return tuple(n // data if ax == "data" else n
                     for n, ax in zip(shape, tail + (None,) * len(shape)))
    return local


# --------------------------------------------------------------------- #
# the step
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_fsdp_steps_match_one_device_and_reference(ref, runs, family, data):
    """3 FSDP steps over ``data`` slots: every metric, gradient and
    parameter equals the port's one-device steps (MoE aux loss included)
    and the reference's single-device trajectory; each slot holds only
    its shards (the local shape the reference's spec implies), and so
    do the moments."""
    r = runs(family)
    name = FAMILIES[family]
    mesh = make_host_mesh(data=data, device="cpu")
    run = port_run(name, r.params0, mesh, opt_first=data == 2)
    metrics_close(run, r.one)
    adam_close(run, r.one, STEPS)
    for g_run, g_one in zip(run.grads, r.one.grads):
        for k, w in g_one.items():
            np.testing.assert_allclose(
                g_run[k].numpy(), w.numpy(), rtol=1e-4,
                atol=1e-5 * float(w.abs().max()), err_msg=k)
    assert int(run.ostate["step"]) == STEPS
    np.testing.assert_allclose([m["loss"] for m in run.metrics],
                               r.ref_losses, rtol=REF_TOL, atol=REF_TOL)
    for k, w in r.ref_final.items():
        np.testing.assert_allclose(run.params[k].numpy(), w.numpy(),
                                   rtol=REF_TOL, atol=REF_TOL, err_msg=k)

    local = stacked_local_shape(ref, name, data)
    slots = run.step.slots
    assert len(slots) == data and slots[0] is run.model
    cut = 0
    for s, module in enumerate(slots):
        for k, p in module.named_parameters():
            whole = tuple(r.one.params[k].shape)
            assert tuple(p.shape) == local(k, whole), (s, k)
            if tuple(p.shape) != whole:
                cut += 1
                assert fsdp.group(p).shards[s] is p
    assert cut > 0
    for part in ("m", "v"):
        for k, t in run.ostate[part].items():
            assert t.shape == run.model.get_parameter(k).shape, (part, k)


def test_replicated_batch_and_accumulation(runs):
    """A batch of 6 on 4 slots is replicated (one runner on the one
    device): the step is the one-device step (the grad norm sums the
    shards' squares in another order).  ``accum_steps=2``
    over 2 slots matches the one-device step with the same accumulation
    and accumulates in fp32."""
    r = runs("moe")
    name = FAMILIES["moe"]
    model_a = port_model(name, r.params0)
    model_b = port_model(name, r.params0)
    step_a = make_train_step(model_a, opt.OptConfig(lr=LR))
    step_b = make_train_step(model_b, opt.OptConfig(lr=LR),
                             mesh=make_host_mesh(data=4, device="cpu"),
                             placement="fsdp")
    oa = opt.init(dict(model_a.named_parameters()))
    ob = opt.init(dict(model_b.named_parameters()))
    pipe = TokenPipeline(smoke_config(name), 6, S)
    for i in range(2):
        ma, mb = step_a(oa, pipe.batch_at(i)), step_b(ob, pipe.batch_at(i))
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(mb[key]), float(ma[key]),
                                       rtol=RTOL, err_msg=key)
    for k, p in whole_params(model_b).items():
        np.testing.assert_allclose(p.numpy(), model_a.get_parameter(k)
                                   .detach().numpy(), rtol=RTOL, atol=1e-7,
                                   err_msg=k)

    one = types.SimpleNamespace(metrics=[], grads=[], params=None)
    model = port_model(name, r.params0)
    step = make_train_step(model, opt.OptConfig(lr=LR), accum_steps=2,
                           grad_transform=lambda g: one.grads.append(
                               dict(g)) or g)
    ostate = opt.init(dict(model.named_parameters()))
    pipe = TokenPipeline(smoke_config(name), B, S)
    for i in range(2):
        m = step(ostate, pipe.batch_at(i))
        one.metrics.append({k: float(m[k]) for k in ("loss", "aux",
                                                     "grad_norm")})
    one.params = whole_params(model)
    run = port_run(name, r.params0, make_host_mesh(data=2, device="cpu"),
                   steps=2, accum_steps=2)
    metrics_close(run, one)
    adam_close(run, one, 2)
    assert all(g.dtype == torch.float32 for g in run.grads[0].values())


def test_grad_constraint_applied_on_one_device_refused_on_a_mesh():
    """``grad_constraint`` runs on each microbatch's raw gradients on one
    device, as in the reference: one that halves them halves the grad
    norm.  On a mesh, where no slot holds a whole raw gradient, it is
    refused rather than dropped."""
    cfg = smoke_config("qwen3-4b")
    batch = TokenPipeline(cfg, B, S).batch_at(0)
    norms, calls = [], []

    def halve(g):
        calls.append(len(g))
        return {k: v / 2 for k, v in g.items()}

    for constraint in (None, halve):
        model = LM(cfg, device="cpu", seed=1)
        step = make_train_step(model, opt.OptConfig(lr=LR), accum_steps=2,
                               grad_constraint=constraint)
        m = step(opt.init(dict(model.named_parameters())), batch)
        norms.append(float(m["grad_norm"]))
    assert len(calls) == 2
    np.testing.assert_allclose(norms[1], norms[0] / 2, rtol=1e-6)
    with pytest.raises(ValueError, match="grad_constraint"):
        make_train_step(LM(cfg, device="cpu"), opt.OptConfig(),
                        mesh=make_host_mesh(data=2, device="cpu"),
                        grad_constraint=halve)


def test_shards_freed_without_the_collector():
    """The shards of a placed model and of its moments refer to their
    group one way only: with the garbage collector off, replacing the
    optimizer state before the first step (a resume) frees the old
    moments' shards at once, and dropping the model, the step and the
    optimizer state after a step frees every shard."""
    cfg = smoke_config("qwen3-4b")

    def shards(tensors):
        return [weakref.ref(t) for m in tensors if fsdp.group(m) is not None
                for t in fsdp.group(m).shards]

    def moments(ostate):
        return shards([*ostate["m"].values(), *ostate["v"].values()])

    enabled = gc.isenabled()
    gc.disable()
    try:
        model = LM(cfg, device="cpu")
        step = make_train_step(model, opt.OptConfig(lr=LR),
                               mesh=make_host_mesh(data=4, device="cpu"))
        ostate = opt.init(dict(model.named_parameters()))
        old = moments(ostate)
        ostate = opt.init(dict(model.named_parameters()))
        assert old and all(r() is None for r in old)
        step(ostate, TokenPipeline(cfg, B, S).batch_at(0))
        held = moments(ostate) + shards(
            [p for module in step.slots for p in module.parameters()])
        assert all(r() is not None for r in held)
        del model, step, ostate
        assert all(r() is None for r in held)
    finally:
        if enabled:
            gc.enable()


def test_fsdp_needs_model_axis_one_and_the_first_slot(ref):
    """A ``(2, 2)`` mesh builds a step whose slots hold the spec's local
    shapes (data and model cuts; the step itself is held to the
    one-device step in ``tests/test_torch_tp.py``), and an unknown
    placement is refused."""
    name = "qwen3-4b"
    cfg = smoke_config(name)
    model = LM(cfg, device="cpu")
    whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
    step = make_train_step(model, opt.OptConfig(),
                           mesh=make_host_mesh(data=2, model=2, device="cpu"),
                           placement="fsdp")
    rules = ref.Rules(ref.configs.smoke_config(name),
                      ref.jax.sharding.AbstractMesh((2, 2),
                                                    ("data", "model")))
    specs = rules.param_specs(ref.jax.eval_shape(
        lambda: ref_model(ref, name).init(ref.jax.random.PRNGKey(0))))
    size = {"data": 2, "model": 2, None: 1}
    assert len(step.slots) == 4
    for s, module in enumerate(step.slots):
        for k, p in module.named_parameters():
            parts = k.split(".")
            spec = specs
            for part in [q for q in parts if not q.isdigit()]:
                spec = spec[part]
            tail = tuple(spec)[sum(q.isdigit() for q in parts):]
            assert tuple(p.shape) == tuple(
                n // size[ax] for n, ax in zip(whole[k], tail)), (s, k)
    with pytest.raises(ValueError, match="placement"):
        make_train_step(model, opt.OptConfig(), placement="zero")


# --------------------------------------------------------------------- #
# the gathers under remat
# --------------------------------------------------------------------- #

def _saved_during_forward(model, mesh, batch, remat):
    """Run slot 0's forward of an FSDP-placed model under a
    ``saved_tensors_hooks`` count: (bytes saved, bytes of gathered
    weights among them, gathered weights still alive after the
    forward, gathered weights made)."""
    rules = ShardingRules(model.cfg, mesh)
    modules = fsdp.place(model, mesh, rules)
    model.requires_grad_(True)
    made = []
    forward = fsdp._Gather.forward

    def record(ctx, dim, device, *shards):
        out = forward(ctx, dim, device, *shards)
        made.append(weakref.ref(out))
        return out

    saved = {"bytes": 0, "gathered": 0}

    def pack(t):
        n = t.untyped_storage().nbytes()
        saved["bytes"] += n
        ptr = t.untyped_storage().data_ptr()
        alive = {r().untyped_storage().data_ptr() for r in made
                 if r() is not None}
        if ptr in alive:
            saved["gathered"] += n
        return t

    fsdp._Gather.forward = staticmethod(record)
    try:
        with actctx.use(mesh, rules.dp, gather_rules=rules), \
                actctx.local_shard(mesh.size, mesh.devices.flat[0]), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
                MOE.collect_aux_stats():
            part = {k: torch.as_tensor(v[:B // mesh.size])
                    for k, v in batch.items()}
            loss = modules[0].loss(part, remat=remat)
    finally:
        fsdp._Gather.forward = forward
    alive = sum(r() is not None for r in made)
    del loss
    return saved["bytes"], saved["gathered"], alive, len(made)


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_remat_saves_no_gathered_weights(family):
    """Under remat each layer gathers its weights inside the region the
    backward recomputes: the tensors saved for the backward (counted by
    ``saved_tensors_hooks``, checkpoint inputs included) hold no gathered
    weight, and none outlives the forward.  Without remat the same count
    sees the gathered weights the GEMMs save, so it can see them."""
    name = FAMILIES[family]
    cfg = smoke_config(name)
    batch = TokenPipeline(cfg, B, S).batch_at(0)
    mesh = make_host_mesh(data=2, device="cpu")
    total, gathered, alive, made = _saved_during_forward(
        LM(cfg, device="cpu"), mesh, batch, remat=True)
    assert made >= cfg.num_layers
    assert total > 0 and gathered == 0 and alive == 0, (total, gathered,
                                                        alive)
    total, gathered, alive, made = _saved_during_forward(
        LM(cfg, device="cpu"), mesh, batch, remat=False)
    assert gathered > 0 and alive > 0


# --------------------------------------------------------------------- #
# compression, checkpoints, the launcher
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_compress_decompress_on_shards_matches_reference(ref, family):
    """``compress_decompress`` over each slot's gradients (its shards,
    and slot 0 the replicated leaves) equals the reference's on the
    whole stacked tree: one scale a reference leaf, over every layer and
    every shard.  A per-shard scale would differ."""
    name = FAMILIES[family]
    cfg = smoke_config(name)
    rng = np.random.default_rng(3)
    model = LM(cfg, device="cpu")
    grads = {k: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                 .astype(np.float32) * (1 + i % 5))
             for i, (k, p) in enumerate(model.named_parameters())}
    tree = to_reference_params(cfg, grads)
    want = from_reference_params(cfg, ref.jax.jit(
        ref.collectives.compress_decompress)(tree))
    mesh = make_host_mesh(data=4, device="cpu")
    dims = fsdp.shard_dims(cfg, ShardingRules(cfg, mesh), grads)
    slots = [{} for _ in range(4)]
    for k, g in grads.items():
        if dims[k] is None:
            slots[0][k] = g
            continue
        for s, t in enumerate(fsdp.link(fsdp.split(g, dims[k],
                                                   ["cpu"] * 4), dims[k])):
            slots[s][k] = t
    outs = [C.compress_decompress(d) for d in slots]
    for k, w in want.items():
        if dims[k] is None:
            got = outs[0][k]
        else:
            got = torch.cat([o[k] for o in outs], dims[k])
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    k = next(k for k, d in dims.items() if d is not None)
    per_shard = {k: fsdp.split(grads[k], dims[k], ["cpu"] * 4)[0]}
    assert not torch.equal(C.compress_decompress(per_shard)[k],
                           outs[0][k])


def test_compressed_fsdp_step_matches_one_device(runs):
    """The launcher's ``--compress-grads`` transform inside the FSDP step
    equals it inside the one-device step."""
    r = runs("moe")
    name = FAMILIES["moe"]
    out = []
    for mesh in (None, make_host_mesh(data=4, device="cpu")):
        model = port_model(name, r.params0)
        step = make_train_step(model, opt.OptConfig(lr=LR), mesh=mesh,
                               placement="fsdp",
                               grad_transform=C.compress_decompress)
        ostate = opt.init(dict(model.named_parameters()))
        pipe = TokenPipeline(smoke_config(name), B, S)
        losses = [float(step(ostate, pipe.batch_at(i))["loss"])
                  for i in range(2)]
        out.append((losses, whole_params(model)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=RTOL)
    for k, p in out[0][1].items():
        np.testing.assert_allclose(out[1][1][k].numpy(), p.numpy(),
                                   rtol=RTOL, atol=2 * LR * 2, err_msg=k)


def _args(*extra):
    return launch_train.parse_args(
        ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
         "--batch", "8", "--seq", "16", "--log-every", "1", *extra])


def test_checkpoints_cross_between_1_2_and_4_shards(ref, tmp_path):
    """The launcher with FSDP placement over 4 slots saves whole leaves
    (the reference's layout, gathered from the shards): runs over 1, 2
    and 4 slots resume from it, and a 4-slot run resumes from a
    one-device run's, each taking the uninterrupted 4-slot run's steps;
    the reference's ``CheckpointManager`` restores it (fp32) and takes
    the same next step."""
    meshes = {1: None, 2: make_host_mesh(data=2, device="cpu"),
              4: make_host_mesh(data=4, device="cpu")}
    full = launch_train.run(_args("--steps", "5"), mesh=meshes[4])
    want = [h["loss"] for h in full.history[3:]]
    dirs = {}
    for n in (4, 1):
        dirs[n] = str(tmp_path / f"save{n}")
        launch_train.run(_args("--steps", "3", "--ckpt-dir", dirs[n]),
                         mesh=meshes[n])
    with open(os.path.join(dirs[4], "step_0000000003",
                           "manifest.json")) as f:
        manifest = json.load(f)["arrays"]
    assert manifest["params/layers/attn/wq"]["shape"] == [
        smoke_config("qwen3-moe-30b-a3b").num_layers,
        *fsdp.whole(full.model.layers[0].attn.wq).shape]
    for src, dst in ((4, 1), (4, 2), (4, 4), (1, 4)):
        tmp = str(tmp_path / f"{src}_to_{dst}")
        shutil.copytree(dirs[src], tmp)
        run = launch_train.run(
            _args("--steps", "5", "--ckpt-dir", tmp, "--resume"),
            mesh=meshes[dst])
        assert [h["step"] for h in run.history] == [3, 4]
        np.testing.assert_allclose([h["loss"] for h in run.history], want,
                                   rtol=RTOL, err_msg=f"{src} -> {dst}")
        if dst > 1:
            w = run.model.layers[0].attn.wq
            assert w.shape[0] * dst == fsdp.whole(w).shape[0]

    jnp = ref.jnp
    state = ref.ckpt.CheckpointManager(dirs[4]).restore(3)
    rp = ref.jax.tree.map(jnp.asarray, state["params"])
    ro = ref.jax.tree.map(jnp.asarray, state["opt"])
    ro["step"] = jnp.asarray(ro["step"], jnp.int32)
    rcfg = ref.configs.smoke_config("qwen3-moe-30b-a3b")
    rstep = ref.jax.jit(ref.step.make_train_step(
        ref.LM(rcfg), ref.opt.OptConfig(lr=3e-3, warmup_steps=5,
                                        total_steps=5)))
    _, o4, m4 = rstep(rp, ro, TokenPipeline(
        smoke_config("qwen3-moe-30b-a3b"), 8, 16).batch_at(3))
    assert int(o4["step"]) == 4
    np.testing.assert_allclose(float(m4["loss"]), want[0], rtol=1e-4)


def test_launcher_placement_defaults():
    """The launcher places by the spec tables by default, over its own
    mesh (one slot on the CPU: the plain step) or one passed to ``run``;
    ``--placement replicated`` keeps every leaf whole on every slot, and
    both take the same first step."""
    mesh = make_host_mesh(data=2, device="cpu")
    cut = launch_train.run(_args("--steps", "1"), mesh=mesh)
    assert len(cut.step_fn.slots) == 2
    assert any(fsdp.group(p) is not None for p in cut.model.parameters())
    rep = launch_train.run(_args("--steps", "1", "--placement",
                                 "replicated"), mesh=mesh)
    assert len(rep.step_fn.slots) == 2
    assert all(fsdp.group(p) is None for m in rep.step_fn.slots
               for p in m.parameters())
    np.testing.assert_allclose(cut.history[0]["loss"],
                               rep.history[0]["loss"], rtol=RTOL)


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["moe", "encdec"])
def test_gpu_fsdp_step_matches_one_device(cuda, family):
    """The fp32 smoke step with FSDP placement over
    ``make_host_mesh(data=4)`` (one card a slot where there are four,
    else slots sharing the cards) against the one-device step on the
    first card, 2 steps: metrics within rtol 1e-5, parameters under the
    Adam rule; every shard on its slot's card."""
    name = FAMILIES[family]
    cfg = smoke_config(name)
    pipe = TokenPipeline(cfg, B, S)
    runs_ = []
    for mesh in (None, make_host_mesh(data=4)):
        model = (EncDec if cfg.is_encoder_decoder else LM)(
            cfg, device="cuda:0", seed=2)
        seen = []
        step = make_train_step(
            model, opt.OptConfig(lr=LR), mesh=mesh, placement="fsdp",
            grad_transform=lambda g: seen.append(
                {k: fsdp.whole(t, "cpu") for k, t in g.items()}) or g)
        ostate = opt.init(dict(model.named_parameters()))
        metrics, grads = [], []
        for i in range(2):
            m = step(ostate, pipe.batch_at(i))
            metrics.append({k: float(m[k]) for k in ("loss", "aux",
                                                     "grad_norm")})
            grads.append(seen[0])
            seen.clear()
        runs_.append(types.SimpleNamespace(
            metrics=metrics, grads=grads,
            params={k: fsdp.whole(p, "cpu").detach()
                    for k, p in model.named_parameters()}))
        if mesh is not None:
            for s, module in enumerate(step.slots):
                for p in module.parameters():
                    g = fsdp.group(p)
                    if g is not None:
                        assert p.device == mesh.devices.flat[s]
    metrics_close(runs_[1], runs_[0])
    adam_close(runs_[1], runs_[0], 2)


FULL = ["--arch", "qwen3-4b", "--batch", "8", "--seq", "128",
        "--steps", "3", "--log-every", "1"]
FULL_LOSS_TOL = (1e-3, 2e-2, 5e-2)   # steps 0, 1, 2, relative


def _card_peaks(args, mesh=None):
    """``launch.train.run``: its losses, each card's peak allocated
    bytes, its step times (host ms) and the bytes each card still holds
    once the run is dropped."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    run = launch_train.run(launch_train.parse_args(args), mesh=mesh)
    torch.cuda.synchronize()
    peaks = [torch.cuda.max_memory_allocated(i)
             for i in range(torch.cuda.device_count())]
    losses = [h["loss"] for h in run.history]
    ms = [h["ms"] for h in run.history]
    del run
    torch.cuda.empty_cache()
    left = [torch.cuda.memory_allocated(i)
            for i in range(torch.cuda.device_count())]
    return types.SimpleNamespace(losses=losses, peaks=peaks, ms=ms,
                                 left=left)


@pytest.mark.gpu
def test_gpu_launcher_fsdp_over_every_card(cuda):
    """qwen3-4b at full width and depth through ``launch.train.run`` on
    the default mesh (every visible card, FSDP placement), 3 steps of
    8 × 128: every card's peak stays below the replicated layout's on
    the same mesh, and the losses equal a one-card run's within
    ``train_dp_full``'s tolerances (1e-3, 2e-2 relative at steps 0 and
    1; 5e-2 at step 2).  A run of as many slots on the first card alone
    tells the shards' GEMM shapes from the cards' transfers.  Each
    card's peak, each run's losses and step times, and the bytes each
    card holds once a run is dropped are written beside the dry run's
    prediction for the same cell to ``results/fsdp_every_card.json``
    and printed."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.shapes import ShapeSpec
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    runs = {"one_card": _card_peaks(
                FULL, mesh=make_host_mesh(data=1, device="cuda:0")),
            "replicated": _card_peaks(FULL + ["--placement", "replicated"],
                                      mesh=make_host_mesh(data=n)),
            "fsdp": _card_peaks(FULL),
            "fsdp_slots_on_one_card": _card_peaks(
                FULL, mesh=make_host_mesh(data=n, device="cuda:0"))}
    one, cut = runs["one_card"].losses, runs["fsdp"].losses
    for i, (c, r) in enumerate(zip(runs["fsdp"].peaks,
                                   runs["replicated"].peaks)):
        assert c < r, (i, c, r)
    for i, tol in enumerate(FULL_LOSS_TOL):
        assert abs(cut[i] - one[i]) <= tol * abs(one[i]), (i, cut, one)
    grid = np.empty((n, 1), dtype=object)
    grid[:, 0] = [torch.device("cuda", i) for i in range(n)]
    cell = dryrun.lower_cell("qwen3-4b", ShapeSpec("train_full", "train",
                                                   128, 8),
                             Mesh(grid, ("data", "model")))
    os.makedirs("results", exist_ok=True)
    record = {"card": torch.cuda.get_device_name(0), "cards": n,
              **{key: {k: getattr(r, attr) for k, r in runs.items()}
                 for key, attr in (("losses", "losses"),
                                   ("peak_bytes", "peaks"),
                                   ("step_ms", "ms"),
                                   ("bytes_left_after", "left"))},
              "dryrun_peak_bytes": cell["peak_bytes"],
              "dryrun_state_bytes": cell["state_bytes"]}
    with open("results/fsdp_every_card.json", "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
