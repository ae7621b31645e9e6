"""The port's data-parallel train step with replicated weights
(``make_train_step(..., mesh=, placement="replicated")``) and the
launcher over a mesh with ``--placement replicated``, on the CPU, beside
the single-device step of both packages.

A mesh here is ``make_host_mesh(data=n, device="cpu")``: n batch shards
on the one CPU device, sharing its one replica of the weights.  Inputs
are the ``TokenPipeline``'s batches (8 × 16, the reference test's
``test_train_step_multidevice_matches_single``), the weights the
reference's ``init``, carried into the port.  Tolerances, stated per
check:

* against the port's one-device step (fp32 smoke configs, 3 steps):
  loss, MoE aux loss and grad norm within rtol 1e-5 (fp32 sums in
  another order); parameters under the Adam rule of
  ``tests/test_torch_train.py`` over the 3 steps — elements whose
  gradient exceeds 1e-4·max|g| of their leaf at every step within rtol
  1e-5 + atol 1e-7, the others within 2·lr a step;
* against the reference's single-device trajectory (its jitted step):
  losses and parameters within the reference test's atol 5e-3 / rtol
  5e-3 (that test itself fails under jax 0.9, so the single-device
  trajectory is the reference here).

The MoE case is sensitive to the aux loss: a per-shard-mean aux loss
misses the one-device loss and router gradients by far more than those
tolerances, which a test shows.  The reference is imported inside
fixtures, so the card, which has no JAX, can still collect this file.
"""

import importlib
import shutil
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import from_reference_params
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step

FAMILIES = {"dense": "h2o-danube-1.8b", "moe": "qwen3-moe-30b-a3b",
            "hybrid": "jamba-1.5-large-398b", "vlm": "internvl2-1b",
            "encdec": "whisper-base"}
B, S, STEPS, LR = 8, 16, 3, 1e-3
RTOL = 1e-5             # port DP vs port one-device, fp32
REF_TOL = 5e-3          # the reference test's atol / rtol


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
        configs=imp("repro.configs"))


@pytest.fixture(scope="module")
def runs(ref):
    """Cached per family: the reference's initial weights, its
    single-device trajectory, and the port's one-device trajectory."""
    cache = {}

    def get(family):
        if family not in cache:
            name = FAMILIES[family]
            rcfg = ref.configs.smoke_config(name)
            rm = (ref.EncDec if rcfg.is_encoder_decoder else ref.LM)(rcfg)
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


def port_run(name, params0, mesh, steps=STEPS, batch=B, **kw):
    """``steps`` port train steps from the reference's weights: the
    metrics of each, every step's gradients and the final parameters."""
    model = port_model(name, params0)
    seen = []
    step = make_train_step(model, opt.OptConfig(lr=LR), mesh=mesh,
                           placement="replicated",
                           grad_transform=lambda g: seen.append(g) or g,
                           **kw)
    ostate = opt.init(dict(model.named_parameters()))
    pipe = TokenPipeline(smoke_config(name), batch, S)
    metrics = []
    for i in range(steps):
        m = step(ostate, pipe.batch_at(i))
        metrics.append({k: float(m[k]) for k in ("loss", "aux",
                                                 "grad_norm")})
    return types.SimpleNamespace(
        metrics=metrics, grads=seen, ostate=ostate,
        params={k: p.detach().clone() for k, p in model.named_parameters()})


def adam_close(got, want, steps, lr=LR):
    """The Adam rule of the module docstring; returns the count of
    loose elements."""
    loose = 0
    for k, w in want.params.items():
        g = torch.stack([gs[k].abs() / gs[k].abs().max().clamp_min(1e-30)
                         for gs in want.grads]).amin(0)
        tight = g > 1e-4
        a, b = got.params[k], w
        np.testing.assert_allclose(a[tight].numpy(), b[tight].numpy(),
                                   rtol=RTOL, atol=1e-7, err_msg=k)
        err = (a - b).abs()[~tight]
        loose += err.numel()
        assert bool((err <= 2 * lr * steps).all()), (k, float(err.max()))
    return loose


def metrics_close(got, want):
    for g, w in zip(got.metrics, want.metrics):
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                       atol=1e-30, err_msg=key)


@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_dp_steps_match_one_device_and_reference(runs, family, data):
    """3 data-parallel steps over ``data`` CPU shards: every metric and
    parameter equals the port's one-device steps (MoE aux loss included)
    and the reference's single-device trajectory."""
    r = runs(family)
    name = FAMILIES[family]
    dp = port_run(name, r.params0, make_host_mesh(data=data, device="cpu"))
    metrics_close(dp, r.one)
    adam_close(dp, r.one, STEPS)
    assert int(dp.ostate["step"]) == STEPS
    if family in ("moe", "hybrid"):
        assert all(m["aux"] > 0 for m in dp.metrics)
    np.testing.assert_allclose([m["loss"] for m in dp.metrics],
                               r.ref_losses, rtol=REF_TOL, atol=REF_TOL)
    for k, w in r.ref_final.items():
        np.testing.assert_allclose(dp.params[k].numpy(), w.numpy(),
                                   rtol=REF_TOL, atol=REF_TOL, err_msg=k)


def test_per_shard_mean_aux_would_differ(runs):
    """The MoE case is sensitive: the mean of the shards' own losses
    (each with its own Switch aux loss) misses the one-device loss by
    more than 10× the tolerance at 4 shards, and its router gradients by
    far more than the Adam rule allows; the data-parallel step's global
    aux loss matches."""
    r = runs("moe")
    name = FAMILIES["moe"]
    model = port_model(name, r.params0)
    model.requires_grad_(True)
    names, leaves = zip(*model.named_parameters())
    batch = TokenPipeline(smoke_config(name), B, S).batch_at(0)
    full = model.loss(batch)
    g_full = dict(zip(names, torch.autograd.grad(full, leaves)))
    naive = sum(model.loss({k: v[i * 2:(i + 1) * 2]
                            for k, v in batch.items()})
                for i in range(4)) / 4
    g_naive = dict(zip(names, torch.autograd.grad(naive, leaves)))
    naive, full = float(naive.detach()), float(full.detach())
    rel = abs(naive - full) / full
    assert rel > 10 * RTOL, rel
    router = [k for k in names if k.endswith("router")]
    worst = max(float((g_naive[k] - g_full[k]).abs().max()
                      / g_full[k].abs().max()) for k in router)
    assert worst > 1e-2, worst
    np.testing.assert_allclose(full, r.one.metrics[0]["loss"], rtol=RTOL)
    dp = port_run(name, r.params0, make_host_mesh(data=4, device="cpu"),
                  steps=1)
    np.testing.assert_allclose(dp.metrics[0]["loss"], full, rtol=RTOL)
    for k in router:
        np.testing.assert_allclose(dp.grads[0][k].numpy(),
                                   g_full[k].numpy(), rtol=1e-4,
                                   atol=1e-6 * float(g_full[k].abs().max()))


def test_replicated_batch_fallback(runs):
    """A batch of 6 on 4 shards: ``batch_specs`` replicates it, as the
    reference does, and the step is the one-device step exactly."""
    mesh = make_host_mesh(data=4, device="cpu")
    name = FAMILIES["moe"]
    rules = ShardingRules(smoke_config(name), mesh)
    specs = rules.batch_specs(TokenPipeline(smoke_config(name), 6, S)
                              .batch_at(0), 6)
    assert specs["tokens"] == (None, None)
    r = runs("moe")
    one = port_run(name, r.params0, None, steps=2, batch=6)
    dp = port_run(name, r.params0, mesh, steps=2, batch=6)
    assert dp.metrics == one.metrics
    for k, p in one.params.items():
        assert torch.equal(dp.params[k], p), k


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_accumulation_inside_the_shards(runs, family):
    """``accum_steps=2`` over 2 shards: each microbatch is cut into the
    shards and keeps its own capacity and aux loss, so the step equals
    the one-device step with the same accumulation."""
    r = runs(family)
    name = FAMILIES[family]
    one = port_run(name, r.params0, None, steps=2, accum_steps=2)
    dp = port_run(name, r.params0, make_host_mesh(data=2, device="cpu"),
                  steps=2, accum_steps=2)
    metrics_close(dp, one)
    adam_close(dp, one, 2)
    assert all(g.dtype == torch.float32 for g in dp.grads[0].values())


def _args(*extra):
    return launch_train.parse_args(
        ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
         "--batch", "8", "--seq", "16", "--log-every", "1",
         "--placement", "replicated", *extra])


def test_launcher_over_a_mesh(capsys):
    """``launch.train.run`` over a 2-shard mesh trains as the one-device
    launcher does (its default mesh on the CPU is one slot): the same
    losses and parameters, the reference's log lines."""
    one = launch_train.run(_args("--steps", "3"))
    assert one.mesh.shape == {"data": 1, "model": 1}
    mesh = make_host_mesh(data=2, device="cpu")
    dp = launch_train.run(_args("--steps", "3"), mesh=mesh)
    assert dp.mesh is mesh
    out = capsys.readouterr().out.splitlines()
    assert sum(l.startswith("[train] step ") for l in out) == 6
    np.testing.assert_allclose([h["loss"] for h in dp.history],
                               [h["loss"] for h in one.history], rtol=RTOL)
    for (k, p), q in zip(dp.model.named_parameters(),
                         one.model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=RTOL, atol=2 * 3e-3 * 3, err_msg=k)
    assert int(dp.opt_state["step"]) == 3


def test_checkpoints_cross_between_dp_and_one_device(ref, tmp_path):
    """A data-parallel run's checkpoint holds one replica in the
    reference's layout: a one-device run resumes from it, a
    data-parallel run resumes from a one-device run's, each matching the
    resume of the same kind, and the reference's restore reads it and
    takes the same next step."""
    mesh = make_host_mesh(data=2, device="cpu")
    dirs = {kind: str(tmp_path / kind) for kind in ("dp", "one")}
    launch_train.run(_args("--steps", "3", "--ckpt-dir", dirs["dp"]),
                     mesh=mesh)
    launch_train.run(_args("--steps", "3", "--ckpt-dir", dirs["one"]))
    resumed = {}
    for src in ("dp", "one"):
        for kind, m in (("dp", mesh), ("one", None)):
            tmp = str(tmp_path / f"{src}_to_{kind}")
            shutil.copytree(dirs[src], tmp)
            run = launch_train.run(
                _args("--steps", "5", "--ckpt-dir", tmp, "--resume"), mesh=m)
            assert [h["step"] for h in run.history] == [3, 4]
            resumed[src, kind] = [h["loss"] for h in run.history]
    for src in ("dp", "one"):
        np.testing.assert_allclose(resumed[src, "dp"], resumed[src, "one"],
                                   rtol=RTOL)
    np.testing.assert_allclose(resumed["dp", "one"], resumed["one", "one"],
                               rtol=RTOL)

    # the reference restores the data-parallel checkpoint and steps on
    jnp = ref.jnp
    state = ref.ckpt.CheckpointManager(dirs["dp"]).restore(3)
    rp = ref.jax.tree.map(jnp.asarray, state["params"])
    ro = ref.jax.tree.map(jnp.asarray, state["opt"])
    ro["step"] = jnp.asarray(ro["step"], jnp.int32)
    rcfg = ref.configs.smoke_config("qwen3-moe-30b-a3b")
    rstep = ref.step.make_train_step(
        ref.LM(rcfg), ref.opt.OptConfig(lr=3e-3, warmup_steps=5,
                                        total_steps=5))
    _, o4, m4 = rstep(rp, ro, TokenPipeline(
        smoke_config("qwen3-moe-30b-a3b"), 8, 16).batch_at(3))
    assert int(o4["step"]) == 4
    np.testing.assert_allclose(float(m4["loss"]), resumed["dp", "one"][0],
                               rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["moe", "encdec"])
def test_gpu_dp_step_matches_one_device(cuda, family):
    """The fp32 smoke step over ``make_host_mesh(data=4)`` (one card a
    shard where there are four, else shards sharing the cards) against
    the one-device step on the first card, 2 steps: metrics within rtol
    1e-5, parameters under the Adam rule, and every replica equal to
    the first."""
    name = FAMILIES[family]
    cfg = smoke_config(name)
    pipe = TokenPipeline(cfg, B, S)
    runs_ = []
    for mesh in (None, make_host_mesh(data=4)):
        model = (EncDec if cfg.is_encoder_decoder else LM)(
            cfg, device="cuda:0", seed=2)
        seen = []
        step = make_train_step(
            model, opt.OptConfig(lr=LR), mesh=mesh, placement="replicated",
            grad_transform=lambda g: seen.append(
                {k: t.cpu() for k, t in g.items()}) or g)
        ostate = opt.init(dict(model.named_parameters()))
        metrics = []
        for i in range(2):
            m = step(ostate, pipe.batch_at(i))
            metrics.append({k: float(m[k]) for k in ("loss", "aux",
                                                     "grad_norm")})
        runs_.append(types.SimpleNamespace(
            metrics=metrics, grads=seen,
            params={k: p.detach().cpu()
                    for k, p in model.named_parameters()}))
        if mesh is not None:
            # one replica a distinct card, each with the same weights
            for s, other in enumerate(step.slots):
                d = mesh.devices.flat[s]
                for (k, p), q in zip(model.named_parameters(),
                                     other.parameters()):
                    assert q.device == d
                    assert torch.equal(p.cpu(), q.cpu()), (d, k)
    metrics_close(runs_[1], runs_[0])
    adam_close(runs_[1], runs_[0], 2)


@pytest.mark.gpu
def test_gpu_launcher_default_mesh_is_every_card(cuda):
    """``launch.train.run`` on the card builds its mesh over every
    visible card (``data`` = the card count) and trains as a one-card
    mesh does: the same losses within rtol 1e-5."""
    args = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--batch", "8",
            "--seq", "16", "--steps", "3"]
    every = launch_train.run(launch_train.parse_args(args))
    assert every.mesh.shape == {"data": torch.cuda.device_count(),
                                "model": 1}
    one = launch_train.run(launch_train.parse_args(args),
                           mesh=make_host_mesh(data=1, device="cuda:0"))
    np.testing.assert_allclose([h["loss"] for h in every.history],
                               [h["loss"] for h in one.history], rtol=RTOL)
