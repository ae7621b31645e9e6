"""The port's serving steps over ``(data, model)`` meshes on the CPU
(``make_prefill`` / ``make_prefill_encdec`` / ``make_decode(...,
mesh=make_host_mesh(data=a, model=t, device="cpu"))``), beside the
one-device steps of both packages.

A mesh here is a·t slots on the one CPU device: slot (i, j) holds data
index i's cut of TP rank j's part of every weight the spec tables cut
(``ShardingRules.param_specs``) and its piece of the cache
(``ShardingRules.cache_specs``).  The five families' smoke configs (fp32)
carry the reference's weights (``from_reference_params``); every run
prefills B × S = 4 × 8 tokens into a cache of ``MAX_LEN`` = 16 and takes
6 greedy decode steps, fed the reference's tokens.  Tolerances:

* against the port's one-device calls: the last logits at every step
  within rtol 1e-5 (atol 1e-5·max|logit|: fp32 sums in another order —
  the softmax's max and sum and the context reduced over the sequence
  ranks, the row-parallel partials summed in fp32), the joined cache
  likewise, the greedy tokens equal but at a near tie (1e-5·max|logit|);
* against the reference's single-device ``prefill`` / ``decode_step``
  (jitted): logits and the joined cache within 5e-3 (atol and rtol, the
  tolerance ``tests/test_torch_fsdp.py`` uses), tokens equal but at a
  near tie of the reference's logits (2e-4·max|logit|, as
  ``tests/test_torch_lm_serving.py``).

One reference run and one port one-device run a family serve every mesh
case (module-scoped).  The reference is imported inside fixtures, so the
card, which has no JAX, can still collect this file.
"""

import importlib
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.distributed import actctx, fsdp, tp
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import from_reference_params
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM, logits_tp
from repro_torch.serve.step import (make_decode, make_prefill,
                                    make_prefill_encdec)

FAMILIES = {"dense": "h2o-danube-1.8b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-370m", "hybrid": "jamba-1.5-large-398b",
            "encdec": "whisper-base"}
B, S, MAX_LEN, STEPS, S_ENC = 4, 8, 16, 6, 24
RTOL = 1e-5             # port mesh vs port one-device, fp32
REF_TOL = 5e-3          # the reference test's atol / rtol
TIE_TOL = 2e-4          # a near tie of the reference's logits, relative


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
        Rules=imp("repro.distributed.sharding").ShardingRules,
        configs=imp("repro.configs"))


def _inputs(cfg):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = (0.1 * rng.standard_normal((B, S_ENC, cfg.d_model))
              ).astype(np.float32) if cfg.is_encoder_decoder else None
    return toks, frames


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


@pytest.fixture(scope="module")
def runs(ref):
    """Cached per family: the reference's weights, its prefill and decode
    steps (each step's logits, the tokens it feeds, its final cache), and
    the port's one-device run fed the same tokens."""
    cache = {}

    def get(family):
        if family not in cache:
            name = FAMILIES[family]
            cfg = smoke_config(name)
            rcfg = ref.configs.smoke_config(name)
            rm = (ref.EncDec if rcfg.is_encoder_decoder else ref.LM)(rcfg)
            params = rm.init(ref.jax.random.PRNGKey(0))
            toks, frames = _inputs(cfg)
            jnp = ref.jnp
            if cfg.is_encoder_decoder:
                rc, lg = ref.jax.jit(rm.prefill, static_argnums=3)(
                    params, jnp.asarray(frames), jnp.asarray(toks), MAX_LEN)
            else:
                rc, lg = ref.jax.jit(rm.prefill, static_argnums=2)(
                    params, jnp.asarray(toks), MAX_LEN)
            dec = ref.jax.jit(rm.decode_step)
            logits = [np.asarray(lg)]
            feed = []
            for i in range(STEPS):
                feed.append(logits[-1].argmax(-1).astype(np.int32))
                lg, rc = dec(params, rc, jnp.asarray(feed[-1][:, None]),
                             jnp.int32(S + i))
                logits.append(np.asarray(lg))
            cache[family] = types.SimpleNamespace(
                name=name, cfg=cfg, params0=params, toks=toks,
                frames=frames, feed=feed, ref_logits=logits,
                ref_cache=_host(rc),
                one=port_run(name, params, None, toks, frames, feed))
        return cache[family]
    return get


def port_run(name, params0, mesh, toks, frames, feed, max_len=MAX_LEN):
    """The port's prefill and ``STEPS`` decode steps fed ``feed``: over
    ``mesh``, through the mesh step builders (each step's joined logits
    and greedy tokens, the final cache joined); without, through the
    model's one-device ``prefill`` / ``decode_step``."""
    cfg = smoke_config(name)
    model = (EncDec if cfg.is_encoder_decoder else LM)(cfg, device="cpu")
    model.load_state_dict(from_reference_params(cfg, params0))
    t = torch.from_numpy(toks)
    args = (t,) if frames is None else (torch.from_numpy(frames), t)
    if mesh is None:
        cache, lg = model.prefill(*args, max_len)
        logits = [lg.numpy()]
        for i, tok in enumerate(feed):
            lg, cache = model.decode_step(cache, torch.from_numpy(
                tok[:, None]), S + i)
            logits.append(lg.numpy())
        return types.SimpleNamespace(
            logits=logits, tokens=[lg.argmax(-1) for lg in logits],
            cache=_host(cache))
    prefill = (make_prefill_encdec if cfg.is_encoder_decoder
               else make_prefill)(model, max_len, mesh=mesh)
    decode = make_decode(model, mesh=mesh)
    fsdp.COUNTS["gathers"] = 0
    cache, nxt = prefill(*args)
    gathers = [fsdp.COUNTS["gathers"]]
    logits, tokens = [prefill.last_logits().numpy()], [nxt.numpy()]
    for i, tok in enumerate(feed):
        fsdp.COUNTS["gathers"] = 0
        nxt, cache = decode(cache, torch.from_numpy(
            tok[:toks.shape[0], None]), S + i)
        gathers.append(fsdp.COUNTS["gathers"])
        logits.append(decode.last_logits().numpy())
        tokens.append(nxt.numpy()[:, 0])
    return types.SimpleNamespace(
        logits=logits, tokens=tokens, cache=_host(fsdp.whole_cache(cache)),
        model=model, slots=prefill.slots, placed=cache, gathers=gathers)


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def near_tie_equal(got, want, logits, tol):
    for i in np.nonzero(got != want)[0]:
        assert logits[i, want[i]] - logits[i, got[i]] <= tol, i


def tree_close(got, want, rtol, atol_rel, rows, upto):
    """The caches agree on their first ``rows`` sequences and, for the
    self-attention K/V, the first ``upto`` positions (the filled ones)."""
    for path, w in _leaves(want):
        g = _at(got, path)
        batch_axis = w.ndim - (3 if path[-1].startswith("conv") else 4)
        index = [slice(None)] * batch_axis + [slice(rows)]
        if path[-1] in ("k", "v") and path[0] != "cross":
            index.append(slice(upto))
        w, g = w[tuple(index)], g[tuple(index)]
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_rel * max(float(np.abs(w).max()),
                                                 1e-30),
            err_msg="/".join(path))


def assert_slots_hold_spec_shapes(ref, run, name, data, model, batch):
    """Every slot's weights and cache pieces have the local shapes the
    reference's spec tables give on the ``(data, model)`` mesh; returns
    the reference's cache specs."""
    rcfg = ref.configs.smoke_config(name)
    shapes = ref.jax.eval_shape(lambda: (
        ref.EncDec if rcfg.is_encoder_decoder else ref.LM)(rcfg).init(
            ref.jax.random.PRNGKey(0)))
    rules = ref.Rules(rcfg, ref.jax.sharding.AbstractMesh(
        (data, model), ("data", "model")))
    pspecs = rules.param_specs(shapes)
    cspecs = rules.cache_specs(run.cache, batch)
    size = {"data": data, "model": model, None: 1,
            ("data", "model"): data * model}

    def local(shape, spec):
        return tuple(n // size[ax] for n, ax in zip(
            shape, tuple(spec) + (None,) * len(shape)))
    whole = {k: fsdp.whole(p) for k, p in run.model.named_parameters()}
    assert len(run.slots) == data * model
    for s, module in enumerate(run.slots):
        for k, p in module.named_parameters():
            parts = k.split(".")
            path = [q for q in parts if not q.isdigit()]
            spec = tuple(_at(pspecs, path))[len(parts) - len(path):]
            assert tuple(p.shape) == local(whole[k].shape, spec), (s, k)
    for tree in run.placed.slots:
        for path, w in _leaves(run.cache):
            assert tuple(_at(tree, path).shape) == local(
                w.shape, _at(cspecs, path)), path
    return cspecs


# --------------------------------------------------------------------- #
# the meshes
# --------------------------------------------------------------------- #

CASES = [("dense", (2, 2), {}), ("moe", (2, 2), {}), ("ssm", (2, 2), {}),
         ("hybrid", (2, 2), {}), ("encdec", (2, 2), {}),
         ("dense", (2, 1), {}), ("encdec", (2, 1), {}),
         ("dense", (1, 4), {}), ("moe", (1, 4), {}), ("hybrid", (1, 2), {}),
         ("dense", (2, 2), {"max_len": 15}), ("dense", (2, 2), {"batch": 3}),
         ("hybrid", (2, 2), {"batch": 3})]


def _id(case):
    family, (a, t), kw = case
    return "-".join([family, f"{a}x{t}"] + [f"{k}{v}" for k, v in kw.items()])


@pytest.mark.parametrize("family,mesh,kw", CASES, ids=[_id(c) for c in CASES])
def test_mesh_serving_matches_one_device_and_reference(ref, runs, family,
                                                       mesh, kw):
    """Prefill and 6 decode steps over a ``(data, model)`` mesh: the last
    logits at every step, the greedy tokens and the joined cache equal
    the port's one-device run and the reference's; every slot holds
    exactly its spec's weights and cache piece; decode, in the
    reference's weight-stationary layout, gathers no weight
    (``fsdp.COUNTS``), prefill gathers each layer cut over data.
    ``(2, 1)`` cuts every weight over data alone.  ``(1, 4)`` gives each
    rank one of the smoke model's 4 query heads against 2 kv heads (the
    GQA mapping), and its dense case decodes past danube's window of 8
    with 4 positions a rank, so rank 0's are all masked at the last
    steps; ``max_len`` 15 leaves the cache's sequence whole on every TP
    rank (``t`` does not divide it); a batch of 3 (``data`` does not
    divide it) cuts the sequence over ``(data, model)``."""
    r = runs(family)
    data, model = mesh
    batch = kw.get("batch", B)
    max_len = kw.get("max_len", MAX_LEN)
    frames = None if r.frames is None else r.frames[:batch]
    run = port_run(r.name, r.params0, make_host_mesh(
        data=data, model=model, device="cpu"), r.toks[:batch], frames,
        r.feed, max_len)
    for i, (got, one, want) in enumerate(zip(run.logits, r.one.logits,
                                             r.ref_logits)):
        one, want = one[:batch], want[:batch]
        scale = float(np.abs(one).max())
        np.testing.assert_allclose(got, one, rtol=RTOL, atol=RTOL * scale,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(got, want, rtol=REF_TOL, atol=REF_TOL,
                                   err_msg=f"step {i}")
        near_tie_equal(run.tokens[i], r.one.tokens[i][:batch], one,
                       RTOL * scale)
        near_tie_equal(run.tokens[i], want.argmax(-1), want,
                       TIE_TOL * float(np.abs(want).max()))
    assert run.gathers[1:] == [0] * STEPS
    assert (run.gathers[0] > 0) == (data > 1)
    filled = S + STEPS
    tree_close(run.cache, r.one.cache, RTOL, RTOL, batch, filled)
    tree_close(run.cache, r.ref_cache, REF_TOL, REF_TOL, batch, filled)
    cspecs = assert_slots_hold_spec_shapes(ref, run, r.name, data, model,
                                           batch)
    kv = cspecs["attn"] if family == "hybrid" else \
        cspecs["self"] if family == "encdec" else cspecs
    if family in ("ssm",):
        assert tuple(cspecs["ssm"])[-3] == "model"
    elif "max_len" in kw:
        assert tuple(kv["k"])[-3] is None
    elif "batch" in kw:
        assert tuple(kv["k"])[-3] == ("data", "model")
    else:
        assert tuple(kv["k"])[-3] == "model"
    if (family, mesh) == ("dense", (1, 4)):
        window = r.cfg.sliding_window
        assert 0 < window < filled and filled - window >= max_len // model


# --------------------------------------------------------------------- #
# the parts
# --------------------------------------------------------------------- #

def test_sequence_spread_softmax_against_numpy():
    """``layers._attend_spread`` over 3 ranks of 5 positions each equals
    one softmax in numpy over the 15: masked tails (causal at positions
    9 and 8, a window of 4), and a rank whose positions are all masked."""
    rng = np.random.default_rng(0)
    b, g, r, hd, n, ranks = 2, 2, 3, 8, 5, 3
    q = rng.standard_normal((b, 1, g, r, hd)).astype(np.float32)
    k = rng.standard_normal((b, n * ranks, g, hd)).astype(np.float32)
    v = rng.standard_normal((b, n * ranks, g, hd)).astype(np.float32)
    pos = np.array([[9], [8]])
    for window, causal in ((0, True), (4, True), (0, False)):
        got = L._attend_spread(
            [torch.from_numpy(q)] * ranks,
            list(torch.from_numpy(k).split(n, 1)),
            list(torch.from_numpy(v).split(n, 1)),
            [0, n, 2 * n], torch.from_numpy(pos), window, causal,
            torch.float32, torch.device("cpu")).numpy()
        sc = np.einsum("bsgrk,btgk->bgrst", q, k) / np.sqrt(hd)
        t_pos = np.arange(n * ranks)
        mask = np.ones((b, n * ranks), bool)
        if causal:
            mask &= t_pos[None] <= pos
        if window:
            mask &= (pos - t_pos[None]) < window
        if window:
            assert not mask[:, :n].any()          # rank 0 all masked
        sc = np.where(mask[:, None, None, None], sc, -np.inf)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        want = np.einsum("bgrst,btgk->bsgrk", p, v)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_argmax_over_a_cut_vocabulary():
    """``tp.argmax_over_ranks`` equals ``np.argmax`` (the first index of
    the maximum) with ties inside a rank and across ranks, and
    ``logits_tp`` drops a padded vocabulary's columns: a rank may keep
    some or none."""
    rng = np.random.default_rng(1)
    full = rng.integers(0, 4, (6, 24)).astype(np.float32)   # many ties
    full[0, 5] = full[0, 17] = 9.0                          # across ranks
    full[1, 8] = full[1, 9] = 9.0                           # at a border
    parts = list(torch.from_numpy(full).split(8, 1))
    np.testing.assert_array_equal(tp.argmax_over_ranks(parts).numpy(),
                                  full.argmax(-1))
    hidden = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    head = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    for vocab in (16, 11, 3):
        got = logits_tp([hidden] * 4, list(head.split(4, 1)), 16, vocab)
        assert [p.shape[1] for p in got] == [
            max(0, min(4, vocab - o)) for o in (0, 4, 8, 12)]
        want = (hidden @ head)[:, :vocab]
        np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(tp.argmax_over_ranks(got).numpy(),
                                      want.argmax(-1).numpy())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_place_and_whole_cache_round_trip(family):
    """``fsdp.place_cache`` then ``whole_cache`` gives the cache back for
    every cache kind (K/V, SSM states, conv histories, whisper's self and
    cross pairs) at ``(2, 2)``, a batch the data axis does not divide and
    a sequence ``t`` does not divide; ``init_cache`` gives every slot
    zeros of its piece's shape."""
    cfg = smoke_config(FAMILIES[family])
    model = (EncDec if cfg.is_encoder_decoder else LM)(cfg, device="cpu")
    gen = torch.Generator().manual_seed(2)
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    rules = ShardingRules(cfg, mesh)
    for batch, max_len in ((4, 16), (3, 16), (4, 15)):
        struct = (model.cache_structure(batch, max_len, S_ENC)
                  if cfg.is_encoder_decoder
                  else model.init_cache(batch, max_len, "meta"))

        def fill(tree):
            if isinstance(tree, dict):
                return {k: fill(v) for k, v in tree.items()}
            return torch.randn(tree.shape, generator=gen).to(tree.dtype)
        whole = fill(struct)
        placed = fsdp.place_cache(whole, mesh, rules, batch)
        zeros = fsdp.init_cache(struct, mesh, rules, batch)
        back = fsdp.whole_cache(placed)
        for path, w in _leaves(whole):
            assert torch.equal(_at(back, path), w), path
            for s in range(4):
                z = _at(zeros.slots[s], path)
                assert z.shape == _at(placed.slots[s], path).shape
                assert not z.any()


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)])
def test_mesh_decode_leaves_no_cycle(mesh):
    """A model, its steps and its cache over a mesh are freed by their
    reference counts once dropped, after a decode (whose mesh view of
    the cache is kept on the cache): no cycle waits for the collector
    with the model's weights."""
    import gc
    import weakref
    gc.disable()
    try:
        model = LM(smoke_config("qwen3-4b"), device="cpu", seed=0)
        grid = make_host_mesh(data=mesh[0], model=mesh[1], device="cpu")
        prefill = make_prefill(model, 8, mesh=grid)
        decode = make_decode(model, mesh=grid)
        cache, nxt = prefill(torch.zeros((2, 4), dtype=torch.long))
        decode(cache, nxt[:, None], 4)
        alive = weakref.ref(model)
        del model, prefill, decode, cache, nxt
        assert alive() is None
    finally:
        gc.enable()


def test_ssm_decode_with_cut_b_and_c():
    """``mamba2_block_tp`` with a state over 2 ranks, whose spec cuts
    ``b_proj`` / ``c_proj``, their convs and conv histories over
    ``model`` (g·N = 16): a prefill of 8 tokens and 3 O(1) decode steps
    equal the one-device ``mamba2_block``'s outputs and states (each
    rank's cut of them); a rank updating with only its own cut of B and
    C would not."""
    cfg = smoke_config(FAMILIES["ssm"])
    gen = torch.Generator().manual_seed(0)
    whole = SSM.init_mamba2(gen, cfg, torch.float32)
    mesh = make_host_mesh(data=1, model=2, device="cpu")
    rules = ShardingRules(cfg, mesh)
    model = LM(cfg, device="cpu")
    dims = fsdp.cut_dims(cfg, rules, dict(model.named_parameters()))
    params = [{}, {}]
    for k, w in whole.items():
        tdim = dims[f"layers.0.mamba.{k}"][1]
        for j in range(2):
            params[j][k] = w if tdim is None else w.chunk(2, tdim)[j]
    assert params[0]["conv_b_w"].shape[-1] * 2 == cfg.ssm_groups \
        * cfg.ssm_state
    state = SSM.init_mamba_state(cfg, 2, torch.float32)
    cut = {"ssm": 1, "conv_x": 2, "conv_b": 2, "conv_c": 2}
    states = [{k: v.chunk(2, cut[k])[j].clone() for k, v in state.items()}
              for j in range(2)]
    xs = [torch.randn((2, 8, cfg.d_model), generator=gen)] + [
        torch.randn((2, 1, cfg.d_model), generator=gen) for _ in range(3)]
    with actctx.use(mesh, rules.dp), actctx.local_shard(
            1, "cpu", ranks=[model, model], devices=["cpu", "cpu"]):
        for x in xs:
            y, state = SSM.mamba2_block(whole, x, cfg, state=state)
            outs, partial, new = SSM.mamba2_block_tp(params, [x, x], cfg,
                                                     states)
            assert partial
            np.testing.assert_allclose(tp.reduce_from_ranks(outs).numpy(),
                                       y.numpy(), rtol=1e-5, atol=1e-6)
            for k, v in state.items():
                np.testing.assert_allclose(
                    torch.cat([n[k] for n in new], cut[k]).numpy(),
                    v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
            states = new


# --------------------------------------------------------------------- #
# on four cards
# --------------------------------------------------------------------- #

GPU_BATCH, GPU_LEN, GPU_STEPS = 8, 32768, 8
GPU_TIE_TOL = 2e-2      # bf16 near ties, a share of max|logit|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _fill(write, cfg):
    """Every layer's K and V of a (B, ``GPU_LEN``) cache from a seeded
    generator on card 0, one layer at a time: ``write(key, layer,
    values)``."""
    gen = torch.Generator(device="cuda:0")
    for l in range(cfg.num_layers):
        for i, key in enumerate(("k", "v")):
            gen.manual_seed(1000 + 2 * l + i)
            write(key, l, torch.randn(
                (GPU_BATCH, GPU_LEN, cfg.num_kv_heads, cfg.head_dim),
                generator=gen, device="cuda:0").to(torch.bfloat16))


def _card_decode(cache, decode, first, feed=None):
    """``GPU_STEPS`` greedy steps from position ``GPU_LEN - GPU_STEPS``
    (``decode(cache, token (B, 1), pos) -> (logits, tokens (B,))``), fed
    their own tokens or ``feed``'s: each step's tokens and logits, its
    host ms, and each card's peak allocated bytes from the first step
    on (the cache filled before)."""
    for i in range(torch.cuda.device_count()):
        torch.zeros(1, device=torch.device("cuda", i))   # the allocator's
        torch.cuda.synchronize(i)                         # stats exist
        torch.cuda.reset_peak_memory_stats(i)
    tok, toks, logits, ms = first, [], [], []
    for i in range(GPU_STEPS):
        t0 = time.perf_counter()
        lg, nxt = decode(cache, tok[:, None], GPU_LEN - GPU_STEPS + i)
        for c in range(torch.cuda.device_count()):
            torch.cuda.synchronize(c)
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg.float().cpu().numpy())
        toks.append(nxt.cpu().numpy())
        tok = nxt if feed is None else feed[i]
    peaks = [torch.cuda.max_memory_allocated(i)
             for i in range(torch.cuda.device_count())]
    return types.SimpleNamespace(tokens=toks, logits=logits, ms=ms,
                                 peaks=peaks)


@pytest.mark.gpu
def test_gpu_decode_over_four_cards(cuda):
    """qwen3-4b at full width and depth, bf16, 8 sequences and a cache of
    32,768 positions filled from a seeded generator alike for every
    layout (no 32k prefill): 8 greedy decode steps from position 32,760
    on one card, then over ``make_host_mesh(data=1, model=4)`` and
    ``(data=2, model=2)`` (one card a slot; the cache's sequence cut
    over ``model``, a quarter of it a card), fed the one card's tokens:
    each step's tokens equal the one card's but at near ties
    (``GPU_TIE_TOL``·max|logit|), and each card's peak lies within 10 %
    of the dry run's fake peak for the same cell.  Each run's host ms a
    step, per-card peaks and largest logit error, and the dry run's
    peaks, are written to ``results/tp_serve_four_cards.json`` and
    printed."""
    import json
    import os
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.serve.step import placement
    cfg = get_config("qwen3-4b")
    shape = ShapeSpec("decode_8x32k", "decode", GPU_LEN, GPU_BATCH)
    model = LM(cfg, device="cuda:0", seed=0)
    first = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, GPU_BATCH)).to("cuda:0")
    cache = model.init_cache(GPU_BATCH, GPU_LEN)
    _fill(lambda key, l, val: cache[key][l].copy_(val), cfg)

    def one_decode(cache, tok, pos):
        lg, _ = model.decode_step(cache, tok, pos)
        return lg, torch.argmax(lg, -1)
    one = _card_decode(cache, one_decode, first)
    del cache
    torch.cuda.empty_cache()
    fake = dryrun.lower_cell("qwen3-4b", shape, "1x1")
    record = {"card": torch.cuda.get_device_name(0),
              "one_card": {"ms": one.ms, "peaks": one.peaks,
                           "tokens": [t.tolist() for t in one.tokens],
                           "dryrun_peak_bytes": fake["peak_bytes"]}}
    feed = [torch.from_numpy(t).to("cuda:0") for t in one.tokens]
    bad = []
    for data, tp_size in ((1, 4), (2, 2)):
        name = f"{data}x{tp_size}"
        mesh = make_host_mesh(data=data, model=tp_size)
        if model is None:           # a model is placed on one mesh
            model = LM(cfg, device="cuda:0", seed=0)
        rules, slots = placement(model, mesh)
        placed = fsdp.init_cache(model.init_cache(
            GPU_BATCH, GPU_LEN, "meta"), mesh, rules, GPU_BATCH)

        def write(key, l, val):
            for s, tree in enumerate(placed.slots):
                tree[key][l].copy_(fsdp._cache_piece(
                    val[None], placed.specs[key], s, mesh)[0])
        _fill(write, cfg)
        decode = make_decode(model, mesh=mesh)

        def mesh_decode(cache, tok, pos):
            nxt, _ = decode(cache, tok, pos)
            return decode.last_logits(), nxt[:, 0]
        run = _card_decode(placed, mesh_decode, first, feed)
        worst = 0.0
        for i, (lg, want) in enumerate(zip(run.logits, one.logits)):
            scale = float(np.abs(want).max())
            worst = max(worst, float(np.abs(lg - want).max()) / scale)
            for b in np.nonzero(run.tokens[i] != one.tokens[i])[0]:
                gap = want[b, one.tokens[i][b]] - want[b, run.tokens[i][b]]
                if gap > GPU_TIE_TOL * scale:
                    bad.append((name, "token", i, int(b), float(gap)))
        cell = dryrun.lower_cell("qwen3-4b", shape, name)
        fake = [cell["peak_bytes"][f"cuda:{i}"] for i in range(4)]
        record[name] = {"ms": run.ms, "peaks": run.peaks,
                        "max_rel_logit_err": worst,
                        "dryrun_peak_bytes": fake,
                        "dryrun_state_bytes": cell["state_bytes"],
                        "dryrun_collective_bytes":
                            cell["collectives"]["total_bytes"],
                        "slot_cache_bytes": [
                            t["k"].numel() * t["k"].element_size() * 2
                            for t in placed.slots]}
        print(json.dumps({name: record[name]}), flush=True)
        bad += [(name, "peak", c, got, f) for c, (got, f) in
                enumerate(zip(run.peaks, fake)) if abs(f - got) > 0.1 * got]
        # the next layout's peaks must not hold this one's weights
        del placed, decode, slots
        model = None
        torch.cuda.empty_cache()
    os.makedirs("results", exist_ok=True)
    with open("results/tp_serve_four_cards.json", "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    assert not bad, bad
