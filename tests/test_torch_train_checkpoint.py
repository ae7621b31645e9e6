"""Train-state checkpoints, the training launcher and the
``examples/train_embedder.py`` flow of the port, on the CPU, beside the
reference.

* ``CheckpointManager``: the counterparts of ``tests/test_checkpoint.py``'s
  roundtrip, retention, async, atomic and resume-equivalence tests;
  checkpoints cross between the packages both ways through
  ``convert.{from,to}_reference_state``; the reference cannot read back
  its own bf16 checkpoints (its restore returns raw ``|V2`` bytes that
  ``jnp.asarray`` refuses), the port reads the same files.
* ``launch.train.main`` with ``--smoke --device cpu``, then ``--resume``.
* The embedder flow (mamba2-370m cut to 12 layers, vocab 8,192, fp32,
  SSD chunk 64) at 1 × 64 tokens a step and 4 steps (the example runs
  300 of 8 × 128; the reference's jitted step takes ~5 s a step at this
  size on the CPU), its losses held to the reference's.

Tolerances: losses rtol 1e-4; parameters after a step under the Adam
rule of ``tests/test_torch_train.py`` (elements whose reference gradient
exceeds 1e-4·max|g| of their leaf within atol 1e-7 + rtol 1e-6, the
others within 2·lr); a resumed trajectory within the reference test's
atol 1e-5 / rtol 1e-4.  The reference is imported inside fixtures.
"""

import importlib
import json
import os
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.elastic import StragglerMonitor
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import (from_reference_params,
                                        from_reference_state,
                                        to_reference_state)
from repro_torch.models.transformer import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step


@pytest.fixture(scope="module")
def ref():
    imp = importlib.import_module
    return types.SimpleNamespace(
        jax=imp("jax"), jnp=imp("jax.numpy"),
        LM=imp("repro.models.transformer").LM,
        opt=imp("repro.train.optimizer"),
        step=imp("repro.train.step"),
        pipeline=imp("repro.data.pipeline"),
        ckpt=imp("repro.distributed.checkpoint"),
        configs=imp("repro.configs"))


def _tree(step):
    return {"params": {"w": torch.full((4, 4), float(step)),
                       "b": np.arange(3.0)},
            "opt": {"m": [torch.ones(2) * step, np.zeros(1)]},
            "meta": {"step": np.asarray(step)}}


# --------------------------------------------------------------------- #
# the manager
# --------------------------------------------------------------------- #

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tree(5))
    out = mgr.restore(5)
    np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                  np.full((4, 4), 5.0))
    assert isinstance(out["opt"]["m"], list)
    np.testing.assert_array_equal(out["opt"]["m"][0].numpy(), np.ones(2) * 5)
    assert int(out["meta"]["step"]) == 5


def test_resume_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    out = mgr.restore()
    np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                  np.full((4, 4), 4.0))


def test_async_save_copies_to_host_first(tmp_path):
    """The async save takes its host copy before it returns: writing the
    tensor in place afterwards changes nothing on disk."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(7)
    mgr.save(7, tree, blocking=False)
    tree["params"]["w"].fill_(-1.0)
    mgr.wait()
    assert mgr.latest_step() == 7
    np.testing.assert_array_equal(mgr.restore(7)["params"]["w"].numpy(),
                                  np.full((4, 4), 7.0))


def test_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1))
    assert all(not n.endswith(".tmp") for n in os.listdir(tmp_path))
    # a stale .tmp from a crashed save is neither a step nor in the way
    os.makedirs(tmp_path / "step_0000000002.tmp")
    assert mgr.all_steps() == [1]
    mgr.save(2, _tree(2))
    assert mgr.all_steps() == [1, 2]


def test_restore_onto_device(tmp_path):
    """``device`` takes the place of the reference's ``sharding_tree``:
    every leaf lands there as a tensor."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": np.arange(8.0)})
    out = mgr.restore(1, device="cpu")
    assert isinstance(out["w"], torch.Tensor) and out["w"].device.type == "cpu"
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(8.0))


def test_bf16_checkpoints_cross_both_ways(ref, tmp_path):
    """bf16 leaves: the reference writes raw 2-byte ``|V2`` arrays with
    ``"bfloat16"`` in ``manifest.json``, and its own restore returns
    them as ``|V2``, which ``jnp.asarray`` refuses (the reference cannot
    resume a bf16 train state: ROADMAP Queue 3).  The port reads that
    file bit-exactly, and writes the same manifest and bytes."""
    jnp = ref.jnp
    x = (jnp.arange(24, dtype=jnp.float32).reshape(4, 6) / 7
         ).astype(jnp.bfloat16)
    rdir, tdir = tmp_path / "ref", tmp_path / "port"
    ref.ckpt.CheckpointManager(str(rdir)).save(3, {"p": {"w": x}})
    back = ref.ckpt.CheckpointManager(str(rdir)).restore(3)["p"]["w"]
    assert back.dtype == np.dtype("V2")
    with pytest.raises(TypeError, match="V2"):
        jnp.asarray(back)

    got = CheckpointManager(str(rdir)).restore(3)["p"]["w"]
    assert got.dtype == torch.bfloat16
    bits = np.asarray(x).view(np.uint16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), bits)

    CheckpointManager(str(tdir)).save(3, {"p": {"w": got}})
    mans = [json.load(open(d / "step_0000000003" / "manifest.json"))
            for d in (rdir, tdir)]
    assert mans[0]["arrays"] == mans[1]["arrays"]
    assert mans[1]["arrays"]["p/w"]["dtype"] == "bfloat16"
    raw = [np.load(d / "step_0000000003" / "arrays.npz")["p/w"]
           for d in (rdir, tdir)]
    assert raw[0].dtype == raw[1].dtype == np.dtype("V2")
    assert raw[0].tobytes() == raw[1].tobytes()


# --------------------------------------------------------------------- #
# train states
# --------------------------------------------------------------------- #

def _port_model(cfg, sd, seed=9):
    model = LM(cfg, device="cpu", seed=seed)
    model.load_state_dict(sd)
    return model


def test_train_resume_equivalence(tmp_path):
    """Stop after 3 steps, checkpoint, restore into a fresh model and
    optimizer, take 3 more: the parameters of 6 uninterrupted steps."""
    cfg = smoke_config("h2o-danube-1.8b")
    pipe = TokenPipeline(cfg, 2, 16)
    ocfg = opt.OptConfig(lr=1e-3)

    def fresh(sd=None):
        model = LM(cfg, device="cpu", seed=0)
        if sd is not None:
            model.load_state_dict(sd)
        return model, make_train_step(model, ocfg)

    m1, step1 = fresh()
    o1 = opt.init(dict(m1.named_parameters()))
    for i in range(6):
        step1(o1, pipe.batch_at(i))

    m2, step2 = fresh()
    o2 = opt.init(dict(m2.named_parameters()))
    for i in range(3):
        step2(o2, pipe.batch_at(i))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, to_reference_state(cfg, dict(m2.named_parameters()), o2))
    sd, o3 = from_reference_state(cfg, mgr.restore(3))
    m3, step3 = fresh(sd)
    assert int(o3["step"]) == 3
    for i in range(3, 6):
        step3(o3, pipe.batch_at(i))
    for (k, a), b in zip(m1.named_parameters(), m3.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def _ref_train(ref, name, steps, batches):
    """The reference's smoke model trained ``steps`` unjitted steps:
    (model, params, opt state, step fn, grads of the last step)."""
    rm = ref.LM(ref.configs.smoke_config(name))
    params = rm.init(ref.jax.random.PRNGKey(0))
    seen = []
    step = ref.step.make_train_step(
        rm, ref.opt.OptConfig(lr=1e-3),
        grad_transform=lambda g: seen.append(g) or g)
    ostate = ref.opt.init(params)
    for i in range(steps):
        params, ostate, _ = step(params, ostate, batches(i))
    return rm, params, ostate, step, seen


def _adam_close(cfg, model, ref_params, ref_grads, lr):
    want = from_reference_params(cfg, ref_params)
    grads = from_reference_params(cfg, ref_grads)
    for k, p in model.named_parameters():
        got, w = p.detach().numpy(), want[k].numpy()
        g = np.abs(grads[k].numpy())
        tight = g > 1e-4 * g.max()
        np.testing.assert_allclose(got[tight], w[tight], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        assert (np.abs(got - w) <= 2 * lr).all(), k


def test_reference_checkpoint_resumes_in_the_port(ref, tmp_path):
    """A train state the reference wrote (fp32 smoke, stacked layers,
    after 2 steps) restores into the port through the train-state
    converter; the port's next step matches the reference's."""
    cfg = smoke_config("qwen3-4b")
    pipe = TokenPipeline(cfg, 2, 16)
    rm, params, ostate, rstep, _ = _ref_train(ref, "qwen3-4b", 2,
                                              pipe.batch_at)
    ref.ckpt.CheckpointManager(str(tmp_path)).save(
        2, {"params": params, "opt": ostate,
            "meta": {"step": np.asarray(2)}})
    state = CheckpointManager(str(tmp_path)).restore()
    assert int(state["meta"]["step"]) == 2
    sd, tostate = from_reference_state(cfg, state)
    assert int(tostate["step"]) == 2 and tostate["step"].dtype == torch.int32
    model = _port_model(cfg, sd)
    tm = make_train_step(model, opt.OptConfig(lr=1e-3))(
        tostate, pipe.batch_at(2))

    seen = []
    rstep = ref.step.make_train_step(
        rm, ref.opt.OptConfig(lr=1e-3),
        grad_transform=lambda g: seen.append(g) or g)
    p3, o3, m3 = rstep(params, ostate, pipe.batch_at(2))
    np.testing.assert_allclose(float(tm["loss"]), float(m3["loss"]),
                               rtol=1e-4)
    assert int(tostate["step"]) == int(o3["step"]) == 3
    _adam_close(cfg, model, p3, seen[0], 1e-3)


def test_port_checkpoint_resumes_in_the_reference(ref, tmp_path):
    """An fp32 train state the port wrote after 2 steps (from the
    reference's initial weights) restores in the reference, whose next
    step matches the port's."""
    jnp = ref.jnp
    cfg = smoke_config("qwen3-4b")
    pipe = TokenPipeline(cfg, 2, 16)
    rm = ref.LM(ref.configs.smoke_config("qwen3-4b"))
    params0 = rm.init(ref.jax.random.PRNGKey(0))
    model = _port_model(cfg, from_reference_params(cfg, params0))
    step = make_train_step(model, opt.OptConfig(lr=1e-3))
    ostate = opt.init(dict(model.named_parameters()))
    for i in range(2):
        step(ostate, pipe.batch_at(i))
    tree = to_reference_state(cfg, dict(model.named_parameters()), ostate)
    tree["meta"] = {"step": np.asarray(2)}
    CheckpointManager(str(tmp_path)).save(2, tree)

    state = ref.ckpt.CheckpointManager(str(tmp_path)).restore()
    rp = ref.jax.tree.map(jnp.asarray, state["params"])
    ro = ref.jax.tree.map(jnp.asarray, state["opt"])
    ro["step"] = jnp.asarray(ro["step"], jnp.int32)
    assert ref.jax.tree.structure(rp) == ref.jax.tree.structure(params0)
    seen = []
    rstep = ref.step.make_train_step(
        rm, ref.opt.OptConfig(lr=1e-3),
        grad_transform=lambda g: seen.append(g) or g)
    p3, o3, m3 = rstep(rp, ro, pipe.batch_at(2))
    tm = step(ostate, pipe.batch_at(2))
    np.testing.assert_allclose(float(tm["loss"]), float(m3["loss"]),
                               rtol=1e-4)
    assert int(o3["step"]) == int(ostate["step"]) == 3
    _adam_close(cfg, model, p3, seen[0], 1e-3)


# --------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------- #

LOG_LINE = re.compile(r"^\[train\] step +(\d+) loss (\S+) gnorm (\S+) "
                      r"lr (\S+) \d+ ms$")


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` for 4
    steps with a checkpoint every 2, then ``--resume`` to 6: the
    reference's log lines, checkpoints at 2, 4 and 6 in the reference's
    layout, the second run starting where the first stopped."""
    ck = str(tmp_path / "ck")
    common = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
              "--batch", "2", "--seq", "16", "--ckpt-dir", ck,
              "--ckpt-every", "2", "--log-every", "1"]
    launch_train.main(common + ["--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    steps = [int(m.group(1)) for m in map(LOG_LINE.match, out) if m]
    assert steps == [0, 1, 2, 3]
    assert all(np.isfinite(float(LOG_LINE.match(l).group(2)))
               for l in out if LOG_LINE.match(l))
    assert out[-1].startswith("[train] done in ")
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [2, 4]
    state = mgr.restore(4)
    assert int(state["meta"]["step"]) == 4
    assert int(state["opt"]["step"]) == 4
    assert state["params"]["layers"]["attn"]["wq"].shape[0] == \
        smoke_config("qwen3-4b").num_layers        # stacked, as in repro

    launch_train.main(common + ["--steps", "6", "--resume"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[train] resumed from step 4"
    assert [int(m.group(1)) for m in map(LOG_LINE.match, out) if m] == [4, 5]
    assert mgr.all_steps() == [2, 4, 6]            # keep=3, the default
    assert int(mgr.restore()["opt"]["step"]) == 6


def test_launcher_compressed_gradients(capsys):
    """``--compress-grads`` trains through ``compress_decompress``."""
    run = launch_train.run(launch_train.parse_args(
        ["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "16",
         "--compress-grads"]))
    assert [h["step"] for h in run.history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in run.history)
    assert int(run.opt_state["step"]) == 3


def test_launcher_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "qwen3-4b", "--smoke", "--steps", "1"])


# --------------------------------------------------------------------- #
# the examples/train_embedder.py flow
# --------------------------------------------------------------------- #

EMBEDDER = dict(name="mamba2-100m", num_layers=12, ssm_chunk=64,
                vocab_size=8192, dtype="float32")


def train_embedder_flow(model, steps, batch, seq, ckpt_dir, ckpt_every):
    """The example's loop on the port: AdamW with its schedule, async
    checkpoints every ``ckpt_every`` steps and a final one (keep 2),
    straggler monitoring; then restore the latest checkpoint into a
    fresh model and take one more step.  Returns (losses, the resumed
    step's loss, checkpoint steps)."""
    cfg = model.cfg
    step_fn = make_train_step(
        model, opt.OptConfig(lr=3e-3, warmup_steps=20, total_steps=steps),
        remat=True)
    params = dict(model.named_parameters())
    ostate = opt.init(params)
    pipe = TokenPipeline(cfg, batch, seq)
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    straggler = StragglerMonitor()
    losses = []
    for step in range(steps):
        m = step_fn(ostate, pipe.batch_at(step))
        losses.append(float(m["loss"]))
        straggler.record("host0", 0.0)
        if step and step % ckpt_every == 0:
            ckpt.save(step, to_reference_state(cfg, params, ostate),
                      blocking=False)
    ckpt.save(steps, to_reference_state(cfg, params, ostate))
    ckpt.wait()
    assert losses[-1] < losses[0], "loss did not improve"

    sd, o2 = from_reference_state(cfg, ckpt.restore())
    fresh = LM(cfg, device=model.device, seed=1)
    fresh.load_state_dict(sd)
    m = make_train_step(
        fresh, opt.OptConfig(lr=3e-3, warmup_steps=20, total_steps=steps),
        remat=True)(o2, pipe.batch_at(steps))
    assert int(o2["step"]) == steps + 1
    return losses, float(m["loss"]), ckpt.all_steps()


def test_train_embedder_flow_beside_reference(ref, tmp_path):
    """The example's model, schedule, checkpoints and resume on the
    port, every step's loss (and the resumed step's) within 1e-4 of the
    reference's jitted step from the same weights and batches."""
    steps, batch, seq = 4, 1, 64
    rcfg = ref.configs.get_config("mamba2-370m").replace(**EMBEDDER)
    cfg = get_config("mamba2-370m").replace(**EMBEDDER)
    rm = ref.LM(rcfg)
    params = rm.init(ref.jax.random.PRNGKey(0))
    rstep = ref.jax.jit(ref.step.make_train_step(
        rm, ref.opt.OptConfig(lr=3e-3, warmup_steps=20, total_steps=steps),
        remat=True))
    rpipe = ref.pipeline.TokenPipeline(rcfg, batch, seq)
    ostate = ref.opt.init(params)
    want = []
    for i in range(steps + 1):
        params, ostate, m = rstep(params, ostate, rpipe.batch_at(i))
        want.append(float(m["loss"]))

    rm0 = ref.LM(rcfg).init(ref.jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu", seed=0)
    model.load_state_dict(from_reference_params(cfg, rm0))
    losses, resumed, kept = train_embedder_flow(
        model, steps, batch, seq, str(tmp_path), ckpt_every=2)
    assert kept == [2, 4]
    np.testing.assert_allclose(losses, want[:steps], rtol=1e-4)
    np.testing.assert_allclose(resumed, want[steps], rtol=1e-4)
