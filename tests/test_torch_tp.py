"""The port's tensor parallelism (``make_train_step(..., mesh=
make_host_mesh(data=a, model=t))``, ``distributed.tp``) on the CPU,
beside the single-device step of both packages.

A mesh here is ``make_host_mesh(data=a, model=t, device="cpu")``: a·t
slots on the one CPU device, slot (i, j) holding data index i's cut of
TP rank j's part of every leaf the spec tables cut (the layout of a·t
cards, on one device).  Inputs are the ``TokenPipeline``'s batches
(8 × 16), the weights the reference's ``init`` carried into the port.
Tolerances, those of ``tests/test_torch_fsdp.py``:

* against the port's one-device step (fp32 smoke configs, 3 steps):
  loss, MoE aux loss and grad norm within rtol 1e-5 (fp32 sums in
  another order); parameters under the Adam rule — elements whose
  gradient exceeds 1e-4·max|g| of their leaf at every step within rtol
  1e-5 + atol 1e-7, the others within 2·lr a step;
* against the reference's single-device trajectory (its jitted step):
  losses and parameters within atol 5e-3 / rtol 5e-3.

One reference trajectory and one port one-device run a family serve
every mesh case (module-scoped).  The reference is imported inside
fixtures, so the card, which has no JAX, can still collect this file.
"""

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
from repro_torch.distributed import actctx, fsdp, tp
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import from_reference_params
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step

FAMILIES = {"dense": "h2o-danube-1.8b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-370m", "hybrid": "jamba-1.5-large-398b",
            "encdec": "whisper-base"}
B, S, STEPS, LR = 8, 16, 3, 1e-3
RTOL = 1e-5             # port TP vs port one-device, fp32
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


def port_run(name, params0, mesh, steps=STEPS, **kw):
    """``steps`` port train steps from the reference's weights (over
    ``mesh``; one device without): each step's metrics and whole
    gradients, the final whole parameters, the step and the optimizer
    state."""
    model = port_model(name, params0)
    seen = []

    def keep(g):
        # slot 0's call comes first: its shards' groups give every whole
        # gradient, the replicated leaves as they are
        if not seen:
            seen.append({k: fsdp.whole(t).clone() for k, t in g.items()})
        return g

    step = make_train_step(model, opt.OptConfig(lr=LR), mesh=mesh,
                           grad_transform=keep, **kw)
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


def reference_local_shape(ref, name, data, model):
    """Each port parameter's local shape on a ``(data, model)`` mesh as
    the reference's rules imply it: its stacked leaf's spec, without the
    leading layer axes, applied to the per-layer shape."""
    rcfg = ref.configs.smoke_config(name)
    shapes = ref.jax.eval_shape(
        lambda: ref_model(ref, name).init(ref.jax.random.PRNGKey(0)))
    rules = ref.Rules(rcfg, ref.jax.sharding.AbstractMesh(
        (data, model), ("data", "model")))
    specs = rules.param_specs(shapes)
    size = {"data": data, "model": model, None: 1}

    def local(port_name, shape):
        parts = port_name.split(".")
        path = [p for p in parts if not p.isdigit()]
        spec = specs
        for p in path:
            spec = spec[p]
        tail = tuple(spec)[len(parts) - len(path):]
        return tuple(n // size[ax]
                     for n, ax in zip(shape, tail + (None,) * len(shape)))
    return local


def assert_slots_hold_spec_shapes(ref, name, step, whole, data, model):
    """Every slot's every leaf has the local shape of the reference's
    spec on the ``(data, model)`` mesh, and a cut leaf's slot holds its
    own shard; some leaf is cut over ``model``."""
    local = reference_local_shape(ref, name, data, model)
    slots = step.slots
    assert len(slots) == data * model
    tp_cut = 0
    for s, module in enumerate(slots):
        for k, p in module.named_parameters():
            assert tuple(p.shape) == local(k, tuple(whole[k].shape)), (s, k)
            g = fsdp.group(p)
            if g is not None:
                assert g.shards[s] is p and g.shape == (data, model), (s, k)
                tp_cut += g.tp_dim is not None
    assert tp_cut > 0


# --------------------------------------------------------------------- #
# the step
# --------------------------------------------------------------------- #

CASES = [("dense", (2, 2)), ("moe", (2, 2)), ("ssm", (2, 2)),
         ("hybrid", (2, 2)), ("encdec", (2, 2)), ("dense", (1, 4)),
         ("moe", (1, 4)), ("hybrid", (1, 2)), ("dense", (1, 8))]


@pytest.mark.parametrize("family,mesh", CASES,
                         ids=[f"{f}-{a}x{t}" for f, (a, t) in CASES])
def test_tp_steps_match_one_device_and_reference(ref, runs, family, mesh):
    """3 steps over a ``(data, model)`` mesh of CPU slots: every metric
    and parameter, and the first step's gradients, equal the port's
    one-device steps (MoE aux loss included) and the reference's
    single-device trajectory; each
    slot holds only its TP and FSDP shards (the local shape the
    reference's spec implies), and so do the moments.  ``(1, 4)`` gives
    each rank one of the smoke model's 4 query heads against 2 kv heads
    (the global GQA mapping); ``(1, 8)`` cuts FFN and vocabulary but not
    the 4 heads (attention runs whole on every rank); ``(2, 2)`` ssm
    gathers B/C, which the spec cuts over ``model``."""
    r = runs(family)
    name = FAMILIES[family]
    data, model = mesh
    run = port_run(name, r.params0, make_host_mesh(data=data, model=model,
                                                   device="cpu"))
    metrics_close(run, r.one)
    adam_close(run, r.one, STEPS)
    # the first step's gradients, from the same weights: later steps start
    # from weights the Adam rule lets differ (elements of tiny gradient
    # within 2·lr), and the hybrid's SSD leaves feel that
    for k, w in r.one.grads[0].items():
        np.testing.assert_allclose(
            run.grads[0][k].numpy(), w.numpy(), rtol=1e-4,
            atol=1e-5 * float(w.abs().max()), err_msg=k)
    assert int(run.ostate["step"]) == STEPS
    np.testing.assert_allclose([m["loss"] for m in run.metrics],
                               r.ref_losses, rtol=REF_TOL, atol=REF_TOL)
    for k, w in r.ref_final.items():
        np.testing.assert_allclose(run.params[k].numpy(), w.numpy(),
                                   rtol=REF_TOL, atol=REF_TOL, err_msg=k)
    assert_slots_hold_spec_shapes(ref, name, run.step, r.one.params, data,
                                  model)
    for part in ("m", "v"):
        for k, t in run.ostate[part].items():
            assert t.shape == run.model.get_parameter(k).shape, (part, k)
    if (family, mesh) == ("dense", (1, 8)):
        layer = run.model.layers[0]
        assert fsdp.group(layer.attn.wq) is None          # 4 heads, t = 8
        assert fsdp.group(layer.ffn.w_up).tp_dim == 1
        assert fsdp.group(run.model.embed).tp_dim == 0
    if (family, mesh) == ("ssm", (2, 2)):
        mamba = run.model.layers[0].mamba
        cfg = smoke_config(name)
        assert mamba.b_proj.shape[-1] * 2 == cfg.ssm_groups * cfg.ssm_state


def test_compressed_tp_step_matches_one_device(runs):
    """The launcher's ``--compress-grads`` transform inside the ``(2, 2)``
    step equals it inside the one-device step: one scale a reference
    leaf, over every layer, data shard and TP rank."""
    r = runs("moe")
    name = FAMILIES["moe"]
    out = []
    for mesh in (None, make_host_mesh(data=2, model=2, device="cpu")):
        model = port_model(name, r.params0)
        step = make_train_step(model, opt.OptConfig(lr=LR), mesh=mesh,
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


# --------------------------------------------------------------------- #
# the parts
# --------------------------------------------------------------------- #

def _fold(arrays):
    """Σ arrays in fp32, the first first: what the collectives compute."""
    total = np.asarray(arrays[0], dtype=np.float32).copy()
    for a in arrays[1:]:
        total += np.asarray(a, dtype=np.float32)
    return total


def _ranked(rng, t, shape):
    return [torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                         requires_grad=True) for _ in range(t)]


def test_collectives_against_numpy():
    """Forward and backward of every TP collective against numpy on
    four ranks of the CPU, and every copy on one device a view of one
    tensor (no second allocation)."""
    rng = np.random.default_rng(0)
    t, dev = 4, [torch.device("cpu")] * 4
    cot = [rng.standard_normal((2, 8, 4)).astype(np.float32)
           for _ in range(t)]

    def back(outs):
        torch.autograd.backward(outs, [torch.tensor(c, dtype=torch.float32)
                                       for c in cot[:len(outs)]])

    x = torch.tensor(rng.standard_normal((2, 8, 4)), dtype=torch.float32,
                     requires_grad=True)
    outs = tp.copy_to_ranks(x, dev)
    assert all(o.data_ptr() == x.data_ptr() for o in outs)
    back(outs)
    np.testing.assert_array_equal(x.grad.numpy(), _fold(cot))

    parts = _ranked(rng, t, (2, 8, 4))
    total = tp.reduce_from_ranks(parts)
    np.testing.assert_array_equal(total.detach().numpy(), _fold(
        [p.detach().numpy() for p in parts]))
    back([total])
    for p in parts:
        np.testing.assert_allclose(p.grad.numpy(), cot[0])

    for dim in (1, -1):
        parts = _ranked(rng, t, (2, 2, 4) if dim == 1 else (2, 8, 1))
        outs = tp.all_gather(parts, dim)
        want = np.concatenate([p.detach().numpy() for p in parts], dim)
        assert all(o.data_ptr() == outs[0].data_ptr() for o in outs)
        for o in outs:
            np.testing.assert_array_equal(o.detach().numpy(), want)
        back(outs)
        summed = np.split(_fold(cot), t, axis=dim)
        for p, w in zip(parts, summed):
            np.testing.assert_array_equal(p.grad.numpy(), w)

        parts = _ranked(rng, t, (2, 8, 4))
        outs = tp.reduce_scatter_seq(parts, dim)
        want = np.split(_fold([p.detach().numpy() for p in parts]), t,
                        axis=dim)
        for o, w in zip(outs, want):
            np.testing.assert_array_equal(o.detach().numpy(), w)
        cut = [np.split(c, t, axis=dim)[j] for j, c in enumerate(cot)]
        torch.autograd.backward(outs, [torch.tensor(c, dtype=torch.float32)
                                       for c in cut])
        for p in parts:
            np.testing.assert_array_equal(p.grad.numpy(),
                                          np.concatenate(cut, dim)
                                          .astype(np.float32))

        parts = _ranked(rng, t, (2, 2, 4) if dim == 1 else (2, 8, 1))
        row = tp.gather_seq(parts, dim)
        np.testing.assert_array_equal(row.detach().numpy(), np.concatenate(
            [p.detach().numpy() for p in parts], dim))
        back([row])
        for p, w in zip(parts, np.split(cot[0], t, axis=dim)):
            np.testing.assert_allclose(p.grad.numpy(), w.astype(np.float32))

        x = torch.tensor(rng.standard_normal((2, 8, 4)), dtype=torch.float32,
                         requires_grad=True)
        outs = tp.split_to_ranks(x, dim, dev)
        assert all(o._base is x for o in outs)
        cut = [np.split(c, t, axis=dim)[j] for j, c in enumerate(cot)]
        torch.autograd.backward(outs, [torch.tensor(c, dtype=torch.float32)
                                       for c in cut])
        np.testing.assert_allclose(x.grad.numpy(), np.concatenate(cut, dim)
                                   .astype(np.float32))


@pytest.mark.parametrize("t", [2, 4])
def test_vocab_parallel_ce_matches_chunked_ce(t):
    """The vocabulary-parallel loss over t ranks equals ``chunked_ce_loss``
    on the whole head, loss and gradients (hidden states and head), on a
    padded vocabulary (labels below 100 of 128 columns, every column in
    the logsumexp) and a sequence that leaves a remainder chunk."""
    rng = np.random.default_rng(t)
    b, s, d, v, vocab = 2, 13, 8, 128, 100
    hidden = torch.tensor(rng.standard_normal((b, s, d)), dtype=torch.float32,
                          requires_grad=True)
    head = torch.tensor(rng.standard_normal((d, v)), dtype=torch.float32,
                        requires_grad=True)
    labels = torch.tensor(rng.integers(0, vocab, (b, s)))
    mask = torch.tensor(rng.random((b, s)) > 0.2)
    want = L.chunked_ce_loss(hidden, head, labels, mask, chunk=5)
    gh, gw = torch.autograd.grad(want, (hidden, head))
    hiddens = tp.copy_to_ranks(hidden, ["cpu"] * t)
    heads = list(head.chunk(t, 1))
    got = L.vocab_parallel_ce_loss(hiddens, heads, labels, mask, chunk=5)
    th, tw = torch.autograd.grad(got, (hidden, head))
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=1e-6)
    np.testing.assert_allclose(th.numpy(), gh.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tw.numpy(), gw.numpy(), rtol=1e-5, atol=1e-7)


def _row_grads(model, mesh, batch):
    """One forward and backward of the first data row of a TP-placed
    model, under the step's contexts: the gradients of the leaves that
    no axis cuts (one replica on the one device)."""
    rules = ShardingRules(model.cfg, mesh)
    modules = fsdp.place(model, mesh, rules)
    model.requires_grad_(True)
    t = mesh.shape["model"]
    row = list(mesh.devices.flat)[:t]
    with actctx.use(mesh, rules.dp), actctx.local_shard(
            1, row[0], ranks=modules[:t], devices=row), \
            MOE.collect_aux_stats():
        model.loss(batch).backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()
            if fsdp.group(p) is None}


def test_replicated_norm_gradient_counted_once():
    """Four TP ranks on one device share one replica of each norm: its
    gradient is the one-device gradient, not four times it (every rank
    norms only the rows it uses, or the row norms once and hands the
    result on through *f*)."""
    name = FAMILIES["dense"]
    cfg = smoke_config(name)
    batch = {"tokens": TokenPipeline(cfg, B, S).batch_at(0)["tokens"]}
    one = LM(cfg, device="cpu", seed=4)
    one.requires_grad_(True)
    one.loss(batch).backward()
    grads = _row_grads(LM(cfg, device="cpu", seed=4),
                       make_host_mesh(data=1, model=4, device="cpu"), batch)
    norms = [k for k in grads if "ln" in k or k == "final_norm"]
    assert "final_norm" in norms and "layers.0.ln1" in norms
    for k in norms:
        want = one.get_parameter(k).grad
        np.testing.assert_allclose(grads[k].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


def test_ssm_block_gathers_b_and_c():
    """``mamba2_block_tp`` over 2 ranks, whose spec cuts ``b_proj`` /
    ``c_proj`` and their convs over ``model`` (g·N = 16), equals the
    one-device ``mamba2_block`` in its output and its weights'
    gradients; a rank scanning only its own cut of B and C would not."""
    cfg = smoke_config(FAMILIES["ssm"])
    gen = torch.Generator().manual_seed(0)
    whole = SSM.init_mamba2(gen, cfg, torch.float32)
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    mesh = make_host_mesh(data=1, model=2, device="cpu")
    rules = ShardingRules(cfg, mesh)
    model = LM(cfg, device="cpu")
    dims = fsdp.cut_dims(cfg, rules, dict(model.named_parameters()))
    params = [{}, {}]
    for k, w in whole.items():
        w.requires_grad_(True)
        tdim = dims[f"layers.0.mamba.{k}"][1]
        for j in range(2):
            params[j][k] = w if tdim is None else w.chunk(2, tdim)[j]
    assert params[0]["b_proj"].shape[-1] == cfg.ssm_groups * cfg.ssm_state // 2
    y, _ = SSM.mamba2_block(whole, x, cfg)
    want = torch.autograd.grad(y.square().sum(), list(whole.values()))
    with actctx.use(mesh, rules.dp), actctx.local_shard(
            1, "cpu", ranks=[model, model], devices=["cpu", "cpu"]):
        outs, partial, states = SSM.mamba2_block_tp(params, [x, x], cfg)
    assert partial and states is None
    got = tp.reduce_from_ranks(outs)
    np.testing.assert_allclose(got.detach().numpy(), y.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(got.square().sum(), list(whole.values()))
    for k, g, w in zip(whole, grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_placed_dense_and_whisper_prefill_and_decode():
    """A dense and a whisper module placed over ``(1, 2)`` prefill and
    decode through ``make_prefill`` / ``make_prefill_encdec`` /
    ``make_decode(..., mesh=)`` with the one-device calls' logits, tokens
    and cache (the whole test of serving over meshes is
    ``tests/test_torch_tp_serve.py``).  What still raises: a forward of a
    module holding one TP rank's weights outside a data row, and a plain
    cache passed inside a tensor-parallel row."""
    from repro_torch.serve.step import (make_decode, make_prefill,
                                        make_prefill_encdec)
    mesh = make_host_mesh(data=1, model=2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, (2, 4)))
    for name in (FAMILIES["dense"], FAMILIES["encdec"]):
        cfg = smoke_config(name)
        frames = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (2, 24, cfg.d_model)).astype(np.float32))
        args = (frames, tokens) if cfg.is_encoder_decoder else (tokens,)
        out = []
        for m in (None, mesh):
            model = (EncDec if cfg.is_encoder_decoder else LM)(
                cfg, device="cpu")
            pre = (make_prefill_encdec if cfg.is_encoder_decoder
                   else make_prefill)(model, 8, mesh=m)
            dec = make_decode(model, mesh=m)
            cache, nxt = pre(*args)
            toks = [nxt]
            for pos in range(4, 8):
                nxt, cache = dec(cache, toks[-1][:, None], pos)
                toks.append(nxt[:, 0])
            out.append((torch.stack(toks), cache if m is None
                        else fsdp.whole_cache(cache), pre, model))
        (one, c1, _, _), (two, c2, pre, model) = out
        assert torch.equal(one, two), name
        kv = c1["self"] if cfg.is_encoder_decoder else c1
        kv2 = c2["self"] if cfg.is_encoder_decoder else c2
        np.testing.assert_allclose(kv2["k"].numpy(), kv["k"].numpy(),
                                   rtol=RTOL, atol=1e-6)
        assert len(pre.slots) == 2 and pre.slots[0] is model
        with pytest.raises(ValueError, match="one TP rank's weights"):
            pre.slots[1].forward(tokens) if not cfg.is_encoder_decoder \
                else pre.slots[1].encode(frames)
    cfg = smoke_config(FAMILIES["dense"])
    model = LM(cfg, device="cpu")
    rules = ShardingRules(cfg, mesh)
    modules = fsdp.place(model, mesh, rules)
    with actctx.use(mesh, rules.dp), actctx.local_shard(
            1, "cpu", ranks=modules, devices=["cpu", "cpu"]):
        with pytest.raises(ValueError, match="must be a data row's view"):
            model.forward(tokens, cache=LM(cfg, device="cpu").init_cache(
                2, 8), cache_pos=0)


def test_remat_saves_no_gathered_weights_nor_tp_copies():
    """Under remat each layer gathers its ranks' weights and all-gathers
    its residual inside the region the backward recomputes: the tensors
    saved for the backward (``saved_tensors_hooks``, checkpoint inputs
    included) hold no gathered weight and no layer's all-gathered
    activation — only the final hidden state's, the loss's input, as
    one device keeps its hidden state — and none outlives the forward.
    Without remat the same count sees them."""
    name = FAMILIES["dense"]
    cfg = smoke_config(name)
    batch = TokenPipeline(cfg, B, S).batch_at(0)
    mesh = make_host_mesh(data=2, model=2, device="cpu")

    def saved(remat):
        model = LM(cfg, device="cpu")
        rules = ShardingRules(cfg, mesh)
        modules = fsdp.place(model, mesh, rules)
        for m in modules:
            m.requires_grad_(True)
        made = []          # (call index, output), every gather's outputs
        wraps = {}
        for cls in (fsdp._Gather, tp._AllGather):
            fwd = cls.forward

            def record(ctx, *args, fwd=fwd, cls=cls):
                out = fwd(ctx, *args)
                n = len({i for i, _, _ in made})
                for o in (out if isinstance(out, tuple) else (out,)):
                    made.append((n, cls, weakref.ref(o)))
                return out
            wraps[cls] = fwd
            cls.forward = staticmethod(record)
        kept = set()

        def pack(t):
            ptr = t.untyped_storage().data_ptr()
            for i, _, r in made:
                if r() is not None and r().untyped_storage().data_ptr() \
                        == ptr:
                    kept.add(i)
            return t
        try:
            with actctx.use(mesh, rules.dp, gather_rules=rules), \
                    actctx.local_shard(2, mesh.devices.flat[0],
                                       ranks=modules[:2],
                                       devices=list(mesh.devices.flat)[:2]), \
                    torch.autograd.graph.saved_tensors_hooks(pack,
                                                             lambda t: t), \
                    MOE.collect_aux_stats():
                part = {k: torch.as_tensor(v[:B // 2])
                        for k, v in batch.items()}
                loss = model.loss(part, remat=remat)
        finally:
            for cls, fwd in wraps.items():
                cls.forward = staticmethod(fwd)
        # the last all-gather is the final norm's: the loss's input
        last = max(i for i, cls, _ in made if cls is tp._AllGather)
        alive = {i for i, _, r in made if r() is not None} - {last}
        calls = {i: cls for i, cls, _ in made}
        del loss
        return kept - {last}, alive, calls

    kept, alive, calls = saved(True)
    assert sum(c is fsdp._Gather for c in calls.values()) >= cfg.num_layers
    assert sum(c is tp._AllGather for c in calls.values()) \
        >= 2 * cfg.num_layers
    assert not kept and not alive, (kept, alive)
    kept, alive, calls = saved(False)
    assert {calls[i] for i in kept} == {fsdp._Gather, tp._AllGather}
    assert alive


# --------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------- #

def _args(*extra):
    return launch_train.parse_args(
        ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
         "--batch", "8", "--seq", "16", "--log-every", "1", *extra])


def test_checkpoints_cross_between_1x1_2x1_and_2x2(tmp_path):
    """The launcher's checkpoints hold whole leaves (the reference's
    layout, joined from every TP rank's and data shard's part): a
    checkpoint written at ``1x1``, ``2x1`` or ``2x2`` resumes at each of
    the others, each taking the uninterrupted run's next steps."""
    meshes = {"1x1": None, "2x1": make_host_mesh(data=2, device="cpu"),
              "2x2": make_host_mesh(data=2, model=2, device="cpu")}
    full = launch_train.run(_args("--steps", "5"), mesh=meshes["2x2"])
    want = [h["loss"] for h in full.history[3:]]
    dirs = {}
    for src in meshes:
        dirs[src] = str(tmp_path / f"save{src}")
        launch_train.run(_args("--steps", "3", "--ckpt-dir", dirs[src]),
                         mesh=meshes[src])
    with open(os.path.join(dirs["2x2"], "step_0000000003",
                           "manifest.json")) as f:
        manifest = json.load(f)["arrays"]
    assert manifest["params/layers/attn/wq"]["shape"] == [
        smoke_config("qwen3-moe-30b-a3b").num_layers,
        *fsdp.whole(full.model.layers[0].attn.wq).shape]
    for src in meshes:
        for dst in meshes:
            if src == dst:
                continue
            tmp = str(tmp_path / f"{src}_to_{dst}")
            shutil.copytree(dirs[src], tmp)
            run = launch_train.run(
                _args("--steps", "5", "--ckpt-dir", tmp, "--resume"),
                mesh=meshes[dst])
            assert [h["step"] for h in run.history] == [3, 4]
            np.testing.assert_allclose([h["loss"] for h in run.history],
                                       want, rtol=RTOL,
                                       err_msg=f"{src} -> {dst}")
            if dst == "2x2":
                w = run.model.layers[0].attn.wq
                assert w.shape[0] * 2 == fsdp.whole(w).shape[0]
                assert w.shape[1] * 2 == fsdp.whole(w).shape[1]


# --------------------------------------------------------------------- #
# on four cards
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


FULL = ["--arch", "qwen3-4b", "--batch", "8", "--seq", "128",
        "--steps", "3", "--log-every", "1"]
FULL_LOSS_TOL = (1e-3, 2e-2, 5e-2)   # steps 0, 1, 2, relative


def _card_run(args, mesh=None):
    """``launch.train.run``: its losses, each card's peak allocated
    bytes and its step times (host ms)."""
    for i in range(torch.cuda.device_count()):
        # a card's allocator keeps no stats to reset before it allocates
        torch.zeros(1, device=torch.device("cuda", i))
        torch.cuda.reset_peak_memory_stats(i)
    run = launch_train.run(launch_train.parse_args(args), mesh=mesh)
    torch.cuda.synchronize()
    peaks = [torch.cuda.max_memory_allocated(i)
             for i in range(torch.cuda.device_count())]
    out = types.SimpleNamespace(losses=[h["loss"] for h in run.history],
                                peaks=peaks,
                                ms=[h["ms"] for h in run.history])
    del run
    torch.cuda.empty_cache()
    return out


@pytest.mark.gpu
def test_gpu_tp_over_four_cards(cuda):
    """qwen3-4b at full width and depth through ``launch.train.run``
    over ``make_host_mesh(data=1, model=4)`` and ``(data=2, model=2)``
    (one card a slot), 3 steps of 8 × 128: the losses equal a one-card
    run's within ``FULL_LOSS_TOL``, and each card's peak lies within
    10 % of the dry run's fake peak for the same cell.  Each run's
    losses, step times (host ms) and per-card peaks, and the dry run's,
    are written to ``results/tp_four_cards.json`` and printed."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    one = _card_run(FULL, mesh=make_host_mesh(data=1, device="cuda:0"))
    record = {"card": torch.cuda.get_device_name(0), "one_card": vars(one)}
    shape = ShapeSpec("train_full", "train", 128, 8)
    worst = {}
    for data, model in ((1, 4), (2, 2)):
        name = f"{data}x{model}"
        run = _card_run(FULL, mesh=make_host_mesh(data=data, model=model))
        cell = dryrun.lower_cell("qwen3-4b", shape, name)
        fake = [cell["peak_bytes"][f"cuda:{i}"] for i in range(4)]
        record[name] = {**vars(run), "dryrun_peak_bytes": fake,
                        "dryrun_state_bytes": cell["state_bytes"],
                        "dryrun_collective_bytes":
                            cell["collectives"]["total_bytes"]}
        for i, tol in enumerate(FULL_LOSS_TOL):
            worst[name, i] = abs(run.losses[i] - one.losses[i]) / abs(
                one.losses[i])
            assert worst[name, i] <= tol, (name, i, run.losses, one.losses)
        for c, (got, f) in enumerate(zip(run.peaks, fake)):
            assert abs(f - got) <= 0.1 * got, (name, c, got, f)
    os.makedirs("results", exist_ok=True)
    with open("results/tp_four_cards.json", "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
