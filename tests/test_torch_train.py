"""The port's training path (``repro_torch.train``, ``LM.loss``,
``chunked_ce_loss``, ``TokenPipeline``, ``collectives``) against the
reference on the CPU, at smoke sizes.

Inputs are made from a seed with numpy and handed to both packages; the
reference's weights are carried into the port with
``convert.from_reference_params``.  The reference's ``make_train_step``
runs without ``jax.jit``, as ``tests/test_archs.py`` runs it, except in
the 30-step trajectory, which jits it as ``test_train_loss_decreases``
does.  Tolerances, stated per check:

* losses and grad norms in fp32: rtol 1e-5 (fp32 sums in another order);
* gradients: rtol 1e-4 and atol 1e-5·max|g| of the leaf;
* parameters after AdamW steps ("the Adam rule"): Adam's first step
  moves an element by about lr·sign(g), so an element whose gradient is
  rounding noise may flip by up to 2·lr between two implementations.
  Elements whose reference |g| exceeds 1e-4·max|g| of their leaf are
  held to atol 1e-7 + rtol 1e-6; the others (counted in the assertion
  message) to 2·lr;
* bf16 parameters and moments: one bf16 ulp (rtol 2⁻⁷).

The reference is imported inside fixtures, so the card, which has no
JAX, can still collect this file.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import arch_names, smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models.convert import from_reference_params
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step

B, S = 2, 16
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    imp = importlib.import_module
    return types.SimpleNamespace(
        jax=imp("jax"), jnp=imp("jax.numpy"), L=imp("repro.models.layers"),
        LM=imp("repro.models.transformer").LM,
        EncDec=imp("repro.models.encdec").EncDec,
        opt=imp("repro.train.optimizer"),
        step=imp("repro.train.step"),
        pipeline=imp("repro.data.pipeline"),
        collectives=imp("repro.distributed.collectives"),
        configs=imp("repro.configs"))


def _batch(cfg, rng, b=B, s=S):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model))).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = (0.1 * rng.standard_normal(
            (b, 24, cfg.d_model))).astype(np.float32)
    return batch


def _models(ref, name):
    """(reference model, its params, the port's model with them)."""
    cfg = smoke_config(name)
    rcfg = ref.configs.smoke_config(name)
    rm = (ref.EncDec if cfg.is_encoder_decoder else ref.LM)(rcfg)
    params = rm.init(ref.jax.random.PRNGKey(0))
    tm = (EncDec if cfg.is_encoder_decoder else LM)(cfg, device="cpu")
    tm.load_state_dict(from_reference_params(cfg, params))
    return cfg, rm, params, tm


def _ref_step(ref, rm, params, batch, ocfg, **kw):
    """One reference train step, unjitted: (new params, opt state,
    metrics, the mean gradients it applied)."""
    seen = []

    def capture(g):
        seen.append(g)
        return g

    step = ref.step.make_train_step(rm, ref.opt.OptConfig(**ocfg),
                                    grad_transform=capture, **kw)
    p2, o2, m = step(params, ref.opt.init(params), batch)
    return p2, o2, m, seen[0]


def _close_grads(cfg, got, ref_grads):
    want = from_reference_params(cfg, ref_grads)
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k].float().numpy()
        np.testing.assert_allclose(
            g.detach().float().numpy(), w, rtol=1e-4,
            atol=1e-5 * max(float(np.abs(w).max()), 1e-30), err_msg=k)


def _adam_close(cfg, model, ref_params, ref_grads, lr):
    """The Adam rule of the module docstring over every leaf."""
    want = from_reference_params(cfg, ref_params)
    grads = from_reference_params(cfg, ref_grads)
    loose = 0
    for k, p in model.named_parameters():
        got, w = p.detach().float().numpy(), want[k].float().numpy()
        g = np.abs(grads[k].float().numpy())
        tight = g > 1e-4 * g.max()
        np.testing.assert_allclose(got[tight], w[tight], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        err = np.abs(got - w)[~tight]
        loose += err.size
        assert (err <= 2 * lr).all(), (k, float(err.max()), loose)
    return loose


# --------------------------------------------------------------------- #
# whole train steps
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", arch_names())
def test_smoke_train_step_matches_reference(ref, name):
    """Every architecture in fp32: the loss, every leaf's gradient and
    the parameters after one AdamW step equal the reference's; the step
    counter is 1 and the parameters moved."""
    cfg, rm, params, tm = _models(ref, name)
    batch = _batch(cfg, np.random.default_rng(1))
    ocfg = dict(lr=1e-3)
    p2, o2, m, ref_grads = _ref_step(ref, rm, params, batch, ocfg,
                                     remat=True)

    seen = []
    step = make_train_step(tm, opt.OptConfig(**ocfg), remat=True,
                           grad_transform=lambda g: seen.append(g) or g)
    ostate = opt.init(dict(tm.named_parameters()))
    metrics = step(ostate, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(m["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(m["grad_norm"]), rtol=LOSS_RTOL)
    assert float(metrics["lr"]) == pytest.approx(float(m["lr"]), rel=1e-6)
    _close_grads(cfg, seen[0], ref_grads)
    _adam_close(cfg, tm, p2, ref_grads, ocfg["lr"])
    assert int(ostate["step"]) == int(o2["step"]) == 1
    assert ostate["step"].dtype == torch.int32
    before = from_reference_params(cfg, params)
    assert sum(float((p.detach() - before[k]).abs().sum())
               for k, p in tm.named_parameters()) > 0


@pytest.mark.parametrize("name", ["qwen3-4b", "jamba-1.5-large-398b"])
def test_accum_steps_match_reference(ref, name):
    """``accum_steps=2``: two microbatches along the batch axis, fp32
    accumulation, the mean applied — against the reference's scan.
    jamba's MoE capacity is per microbatch on both sides."""
    cfg, rm, params, tm = _models(ref, name)
    batch = _batch(cfg, np.random.default_rng(3), b=4)
    ocfg = dict(lr=1e-3)
    p2, _, m, ref_grads = _ref_step(ref, rm, params, batch, ocfg,
                                    accum_steps=2)
    seen = []
    step = make_train_step(tm, opt.OptConfig(**ocfg), accum_steps=2,
                           grad_transform=lambda g: seen.append(g) or g)
    metrics = step(opt.init(dict(tm.named_parameters())), batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(m["loss"]),
                               rtol=LOSS_RTOL)
    assert all(g.dtype == torch.float32 for g in seen[0].values())
    _close_grads(cfg, seen[0], ref_grads)
    _adam_close(cfg, tm, p2, ref_grads, ocfg["lr"])


@pytest.mark.parametrize("name", ["qwen3-4b", "mamba2-370m",
                                  "jamba-1.5-large-398b",
                                  "qwen3-moe-30b-a3b"])
def test_remat_on_and_off_agree(name):
    """``remat`` recomputes layers in the backward pass and changes no
    number: the same loss and gradients with it on and off."""
    cfg = smoke_config(name)
    model = LM(cfg, device="cpu", seed=4)
    model.requires_grad_(True)
    batch = _batch(cfg, np.random.default_rng(4))
    out = []
    for remat in (True, False):
        loss = model.loss(batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    (l1, g1), (l0, g0) = out
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_train_loss_trajectory_matches_reference(ref):
    """The counterpart of ``test_archs.py::test_train_loss_decreases``:
    30 steps of the qwen3-4b smoke model on the pipeline's batches, the
    port's losses within 1e-4 relative of the reference's at every step
    (2e-6 measured; rounding differences compound through Adam), and a
    drop of at least 0.3."""
    cfg, rm, params, tm = _models(ref, "qwen3-4b")
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=30)
    rstep = ref.jax.jit(ref.step.make_train_step(
        rm, ref.opt.OptConfig(**ocfg)))
    step = make_train_step(tm, opt.OptConfig(**ocfg))
    rpipe = ref.pipeline.TokenPipeline(ref.configs.smoke_config("qwen3-4b"),
                                       4, 32)
    pipe = TokenPipeline(cfg, 4, 32)
    rostate = ref.opt.init(params)
    ostate = opt.init(dict(tm.named_parameters()))
    want, got = [], []
    for i in range(30):
        params, rostate, m = rstep(params, rostate, rpipe.batch_at(i))
        want.append(float(m["loss"]))
        got.append(float(step(ostate, pipe.batch_at(i))["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] - 0.3, got[:3] + got[-3:]


# --------------------------------------------------------------------- #
# the loss
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("s,chunk,masked", [(20, 512, False),
                                            (40, 16, False),
                                            (32, 8, True)])
def test_chunked_ce_loss_matches_reference(ref, s, chunk, masked):
    """s < chunk (one slab), s not a multiple of the chunk (a remainder
    slab), and a random mask: the loss and its gradients with respect to
    the hidden states and the head, against the reference.  The head has
    more columns than the labels reach (a padded vocabulary)."""
    jax, jnp = ref.jax, ref.jnp
    rng = np.random.default_rng(s + chunk)
    b, d, v = 3, 24, 80
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    head = (0.3 * rng.standard_normal((d, v))).astype(np.float32)
    y = rng.integers(0, 64, (b, s)).astype(np.int32)
    m = rng.random((b, s)) < 0.6 if masked else np.ones((b, s), bool)

    def rloss(h, head):
        return ref.L.chunked_ce_loss(h, head, jnp.asarray(y),
                                     jnp.asarray(m), chunk=chunk)

    want, (wh, wd) = jax.value_and_grad(rloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_(True)
    thead = torch.from_numpy(head).requires_grad_(True)
    got = L.chunked_ce_loss(th, thead, torch.from_numpy(y),
                            torch.from_numpy(m), chunk=chunk)
    gh, gd = torch.autograd.grad(got, (th, thead))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for a, w in ((gh, wh), (gd, wd)):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_loss_covers_the_padded_vocabulary():
    """The head's pad columns (vocab padded to a multiple of 256) enter
    the logsumexp, as in the reference: slicing them off changes the
    loss."""
    cfg = smoke_config("qwen3-4b")
    model = LM(cfg, device="cpu", seed=2)
    assert model.vocab_padded > cfg.vocab_size
    batch = _batch(cfg, np.random.default_rng(2))
    with torch.no_grad():
        full = model.loss(batch)
        hidden, _, _ = model.forward(torch.from_numpy(batch["tokens"]))
        tokens = torch.from_numpy(batch["tokens"])
        labels = torch.cat([tokens[:, 1:], tokens[:, :1] * 0], dim=1)
        mask = torch.ones(labels.shape, dtype=torch.bool)
        mask[:, -1] = False
        cut = L.chunked_ce_loss(hidden, model.embed.t()[:, :cfg.vocab_size],
                                labels, mask)
    assert abs(float(full) - float(cut)) > 1e-4


def test_ssd_gradient_finite_where_reference_overflows(ref):
    """A chunk whose decay passes e^88 (large Δ, as training reaches in
    ``examples/train_embedder.py``'s 300 steps on the card): the
    reference's ``_ssd_chunked`` takes the exp of the masked entries
    too, so its gradient with respect to Δ is NaN (0·inf; ROADMAP
    Queue 3).  The port masks before the exp: the same output and the
    same (finite) gradient with respect to x, a finite one for Δ."""
    jax, jnp = ref.jax, ref.jnp
    rSSM = importlib.import_module("repro.models.ssm")
    from repro_torch.models import ssm as SSM
    rng = np.random.default_rng(14)
    xh = rng.standard_normal((1, 16, 2, 4)).astype(np.float32)
    dt = np.full((1, 16, 2), 10.0, np.float32)
    a_log = np.log(np.array([4.0, 16.0], np.float32))
    bm = rng.standard_normal((1, 16, 1, 4)).astype(np.float32)
    cm = rng.standard_normal((1, 16, 1, 4)).astype(np.float32)
    d = np.ones(2, np.float32)

    def rloss(xh, dt):
        y, h = rSSM._ssd_chunked(xh, dt, jnp.asarray(a_log),
                                 jnp.asarray(bm), jnp.asarray(cm),
                                 jnp.asarray(d), 16)
        return jnp.sum(y) + jnp.sum(h), y

    (_, ry), (rgx, rgd) = jax.value_and_grad(
        rloss, argnums=(0, 1), has_aux=True)(jnp.asarray(xh),
                                             jnp.asarray(dt))
    assert np.isnan(np.asarray(rgd)).any()
    assert np.isfinite(np.asarray(rgx)).all()

    tx = torch.from_numpy(xh).requires_grad_(True)
    tdt = torch.from_numpy(dt).requires_grad_(True)
    y, h = SSM._ssd_chunked(tx, tdt, torch.from_numpy(a_log),
                            torch.from_numpy(bm), torch.from_numpy(cm),
                            torch.from_numpy(d), 16)
    gx, gd = torch.autograd.grad(y.sum() + h.sum(), (tx, tdt))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry),
                               rtol=1e-5, atol=1e-5)
    assert torch.isfinite(gd).all()
    np.testing.assert_allclose(gx.numpy(), np.asarray(rgx), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------- #
# the optimizer
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("step", [0, 3, 100, 5050, 10000, 12000])
def test_lr_schedule_matches_reference(ref, step):
    """At 0, within warmup, at its end, mid-run, at the end and past
    it."""
    cfg = opt.OptConfig()
    want = ref.opt.lr_schedule(ref.opt.OptConfig(), ref.jnp.int32(step))
    got = opt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _tree(rng, dtype=np.float32, scale=1.0):
    return {"a": (scale * rng.standard_normal((5, 7))).astype(dtype),
            "b": {"c": (scale * rng.standard_normal(11)).astype(dtype),
                  "d": (scale * rng.standard_normal((2, 3, 4))
                        ).astype(dtype)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("case", ["clip_active", "clip_inactive",
                                  "bf16_params_and_moments"])
def test_update_matches_reference(ref, case):
    """Three successive AdamW updates (the bias corrections move) with
    the clip active (norm far above ``clip_norm``) or inactive, and with
    bf16 parameters and bf16 moments (``moment_dtype``): parameters,
    moments, step, grad norm and lr."""
    jnp = ref.jnp
    bf16 = case.startswith("bf16")
    clip = 0.5 if case == "clip_active" else 1e6
    kw = dict(lr=1e-2, clip_norm=clip, warmup_steps=2, total_steps=10,
              moment_dtype="bfloat16" if bf16 else "float32")
    rng = np.random.default_rng(7)
    params = _tree(rng)
    grads = [_tree(rng, scale=3.0) for _ in range(3)]
    dt = jnp.bfloat16 if bf16 else jnp.float32
    rp = ref.jax.tree.map(lambda x: jnp.asarray(x, dt), params)
    rs = ref.opt.init(rp, moment_dtype=kw["moment_dtype"])
    tdt = torch.bfloat16 if bf16 else torch.float32
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in _flat(params).items()}
    ts = opt.init(tp, moment_dtype=kw["moment_dtype"])
    assert all(m.dtype == tdt for m in ts["m"].values())
    for g in grads:
        rp, rs, rm = ref.opt.update(ref.opt.OptConfig(**kw),
                                    ref.jax.tree.map(jnp.asarray, g),
                                    rs, rp)
        tg = {k: torch.from_numpy(v) for k, v in _flat(g).items()}
        _, _, tm = opt.update(opt.OptConfig(**kw), tg, ts, tp)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].item(), float(rm["lr"]),
                                   rtol=1e-6)
    assert int(ts["step"]) == int(rs["step"]) == 3
    rtol, atol = (2 ** -7, 0.0) if bf16 else (1e-5, 1e-7)
    for got, want in ((tp, rp), (ts["m"], rs["m"]), (ts["v"], rs["v"])):
        for k, w in _flat(want).items():
            assert got[k].dtype == tdt
            np.testing.assert_allclose(
                got[k].float().numpy(), np.asarray(w, np.float32),
                rtol=rtol, atol=atol, err_msg=k)


def test_clip_by_global_norm_matches_reference(ref):
    rng = np.random.default_rng(8)
    g = _tree(rng, scale=2.0)
    want, wn = ref.opt.clip_by_global_norm(
        ref.jax.tree.map(ref.jnp.asarray, g), 1.0)
    got, gn = opt.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in _flat(g).items()}, 1.0)
    np.testing.assert_allclose(gn.item(), float(wn), rtol=1e-6)
    for k, w in _flat(want).items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-8)


# --------------------------------------------------------------------- #
# data pipeline and gradient compression
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["qwen3-4b", "internvl2-1b",
                                  "whisper-base"])
def test_token_pipeline_bit_equal(ref, name):
    """Plain, vlm (patch embeddings) and encdec (frames, tokens cut to
    ``max_decode_len``) batches equal the reference's bit for bit, at
    any step; iterating with ``device`` gives tensors of them."""
    cfg = smoke_config(name)
    rp = ref.pipeline.TokenPipeline(ref.configs.smoke_config(name), 3, 24,
                                    seed=5)
    tp = TokenPipeline(cfg, 3, 24, seed=5)
    for step in (0, 1, 17):
        want, got = rp.batch_at(step), tp.batch_at(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    first = next(iter(TokenPipeline(cfg, 3, 24, seed=5, device="cpu")))
    for k, v in rp.batch_at(0).items():
        assert isinstance(first[k], torch.Tensor)
        np.testing.assert_array_equal(first[k].numpy(), v)


def test_compress_decompress_matches_reference(ref):
    rng = np.random.default_rng(9)
    g = _tree(rng, scale=0.3)
    want = ref.collectives.compress_decompress(
        ref.jax.tree.map(ref.jnp.asarray, g))
    got = C.compress_decompress(
        {k: torch.from_numpy(v) for k, v in _flat(g).items()})
    for k, w in _flat(want).items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-9)
        assert len(np.unique(got[k].numpy())) <= 255


def test_error_feedback_matches_reference(ref):
    """Three rounds of the stateful transform: the compressed gradients
    and the residual carried into the next round."""
    rng = np.random.default_rng(10)
    rt, rinit = ref.collectives.make_error_feedback_transform()
    tt, tinit = C.make_error_feedback_transform()
    p = _tree(rng)
    ref_ef = rinit(ref.jax.tree.map(ref.jnp.asarray, p))
    ef = tinit({k: torch.from_numpy(v) for k, v in _flat(p).items()})
    for _ in range(3):
        g = _tree(rng, scale=0.1)
        want, ref_ef = rt(ref.jax.tree.map(ref.jnp.asarray, g), ref_ef)
        got, ef = tt({k: torch.from_numpy(v) for k, v in _flat(g).items()},
                     ef)
        for tree_w, tree_g in ((want, got), (ref_ef, ef)):
            for k, w in _flat(tree_w).items():
                np.testing.assert_allclose(tree_g[k].numpy(),
                                           np.asarray(w), rtol=1e-5,
                                           atol=1e-8)


# --------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_mm_f32_gradients_match_widened_cpu(cuda):
    """``mm_f32``'s bf16 GEMM with an fp32 output on the card, value and
    gradients, against the CPU path that widens the operands: the
    forward within fp32 rounding, each gradient within two bf16 ulps of
    its largest element (the card rounds the fp32 cotangent to bf16
    before its GEMM)."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((96, 160)).astype(np.float32)
                         ).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((160, 72)).astype(np.float32)
                         ).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((96, 72)).astype(np.float32))
    out = []
    for dev in ("cpu", cuda):
        ta = a.to(dev).requires_grad_(True)
        tb = b.to(dev).requires_grad_(True)
        y = L.mm_f32(ta, tb)
        assert y.dtype == torch.float32
        ga, gb = torch.autograd.grad((y * w.to(dev)).sum(), (ta, tb))
        assert ga.dtype == gb.dtype == torch.bfloat16
        out.append([t.detach().float().cpu().numpy() for t in (y, ga, gb)])
    (y0, a0, b0), (y1, a1, b1) = out
    np.testing.assert_allclose(y1, y0, rtol=1e-5,
                               atol=1e-5 * np.abs(y0).max())
    for got, want in ((a1, a0), (b1, b0)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 ** -7 * np.abs(want).max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", arch_names())
def test_gpu_smoke_train_step_matches_cpu(cuda, name):
    """One train step of the same fp32 smoke model on the card and on
    the CPU: the loss within rtol 1e-4 and the parameters under the
    Adam rule (the card's own gradients set which elements are
    tight)."""
    cfg = smoke_config(name)
    batch = _batch(cfg, np.random.default_rng(12))
    runs = []
    for dev in ("cpu", "cuda"):
        model = (EncDec if cfg.is_encoder_decoder else LM)(
            cfg, device="cpu", seed=3).to(dev)
        seen = []
        step = make_train_step(model, opt.OptConfig(lr=1e-3),
                               grad_transform=lambda g: seen.append(g) or g)
        m = step(opt.init(dict(model.named_parameters())), batch)
        runs.append((float(m["loss"]),
                     {k: p.detach().cpu().numpy()
                      for k, p in model.named_parameters()},
                     {k: g.cpu().numpy() for k, g in seen[0].items()}))
    (l0, p0, g0), (l1, p1, _) = runs
    np.testing.assert_allclose(l1, l0, rtol=1e-4)
    for k, want in p0.items():
        g = np.abs(g0[k])
        tight = g > 1e-4 * g.max()
        np.testing.assert_allclose(p1[k][tight], want[tight], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        assert (np.abs(p1[k] - want) <= 2e-3 + 1e-6).all(), k
