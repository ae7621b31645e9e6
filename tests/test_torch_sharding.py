"""The port's sharding rules, activation pins and collectives against the
reference, on the CPU.

* ``ShardingRules`` (``repro_torch.distributed.sharding``): the
  reference's rules are read in-process on a ``jax.sharding.AbstractMesh``
  (no device needed) and the port's on a ``launch.mesh.Mesh`` of the same
  shape, for all ten full configs (shapes from ``jax.eval_shape`` of the
  reference's ``init``) on the meshes (1, 1), (8, 1), (2, 4), (4, 2),
  (1, 8) and the pod (2, 16, 16): ``param_specs``, ``gathered_rule`` of
  every leaf, ``opt_specs``, ``batch_specs`` at batch 1, 6, 8 and 256,
  and ``cache_specs`` of the smoke decode caches (the port's own
  ``init_cache`` beside the reference's) must be equal.  The port's own
  parameter layout (``convert.reference_shapes`` of a smoke model) gives
  the reference's shapes and specs.  Plus the counterpart of
  ``tests/test_distributed.py::test_sharding_rules_cover_all_archs``.
* ``actctx``: the spec of each of the seven kinds on every mesh over a
  grid of shapes, against the reference's ``shard``, whose
  ``with_sharding_constraint`` argument is captured; the port's pins
  return their input without a mesh and check the local shard under
  the data-parallel step.
* ``compressed_psum``: bit-equal to the reference's under ``shard_map``
  (one child process with eight XLA host devices) and within the
  reference test's 8·scale of the exact sum; ``all_reduce_mean``
  against numpy.

The reference is imported inside fixtures, so the card, which has no
JAX, can still collect this file.
"""

import importlib
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import arch_names, get_config, smoke_config
from repro_torch.distributed import actctx
from repro_torch.distributed.collectives import (all_reduce_mean,
                                                 compressed_psum)
from repro_torch.distributed.sharding import P, ShardingRules
from repro_torch.launch.mesh import Mesh, dp_axes
from repro_torch.models.convert import ShapeLeaf, reference_shapes
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
MESHES = [((1, 1), ("data", "model")), ((8, 1), ("data", "model")),
          ((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((1, 8), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
KINDS = ("btd", "btd_sp", "btd_fsdp", "bthd", "bd", "bt", "btf")


@pytest.fixture(scope="module")
def ref():
    imp = importlib.import_module
    jax = imp("jax")
    return types.SimpleNamespace(
        jax=jax, P=jax.sharding.PartitionSpec,
        Rules=imp("repro.distributed.sharding").ShardingRules,
        actctx=imp("repro.distributed.actctx"),
        dp_axes=imp("repro.launch.mesh").dp_axes,
        LM=imp("repro.models.transformer").LM,
        EncDec=imp("repro.models.encdec").EncDec,
        configs=imp("repro.configs"))


@pytest.fixture(scope="module")
def full_shapes(ref):
    """Every full config's parameter shapes (no allocation)."""
    out = {}
    for name in arch_names():
        cfg = ref.configs.get_config(name)
        model = (ref.EncDec if cfg.is_encoder_decoder else ref.LM)(cfg)
        out[name] = ref.jax.eval_shape(
            lambda m=model: m.init(ref.jax.random.PRNGKey(0)))
    return out


def port_mesh(shape, names):
    return Mesh(np.full(shape, "cpu", dtype=object), names)


def rules_pair(ref, name, shape, names):
    """(reference rules on an AbstractMesh, port rules on a Mesh)."""
    return (ref.Rules(ref.configs.get_config(name),
                      ref.jax.sharding.AbstractMesh(shape, names)),
            ShardingRules(get_config(name), port_mesh(shape, names)))


def plain(ref, tree):
    """A reference spec tree with each PartitionSpec as a tuple."""
    return ref.jax.tree.map(tuple, tree,
                            is_leaf=lambda x: isinstance(x, ref.P))


def leaves_with_names(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_names(v, k)
    else:
        yield name, tuple(tree.shape)


# --------------------------------------------------------------------- #
# ShardingRules
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", arch_names())
def test_param_and_opt_specs_match_reference(ref, full_shapes, name):
    """``param_specs``, ``opt_specs`` and every leaf's ``gathered_rule``
    of the full config, on every mesh."""
    shapes = full_shapes[name]
    for shape, names in MESHES:
        r, t = rules_pair(ref, name, shape, names)
        got = t.param_specs(shapes)
        assert got == plain(ref, r.param_specs(shapes)), (name, shape)
        assert all(isinstance(s, P) for s in _spec_list(got))
        assert t.opt_specs(shapes) == plain(ref, r.opt_specs(shapes))
        for leaf, lshape in leaves_with_names(shapes):
            assert t.gathered_rule(leaf, lshape) == tuple(
                r.gathered_rule(leaf, lshape)), (name, shape, leaf)


@pytest.mark.parametrize("name", arch_names())
def test_port_layout_gives_reference_shapes_and_specs(ref, name):
    """``convert.reference_shapes`` of the port's smoke model is the
    reference's smoke parameter tree (names and shapes), and the specs
    the port computes from it equal the reference's from its own."""
    cfg = smoke_config(name)
    rcfg = ref.configs.smoke_config(name)
    model = (EncDec if cfg.is_encoder_decoder else LM)(cfg, device="cpu")
    ours = reference_shapes(cfg, model.state_dict())
    rm = (ref.EncDec if rcfg.is_encoder_decoder else ref.LM)(rcfg)
    theirs = ref.jax.eval_shape(lambda: rm.init(ref.jax.random.PRNGKey(0)))
    assert dict(leaves_with_names(ours)) == dict(
        leaves_with_names(theirs))
    assert ref.jax.tree.map(lambda s: tuple(s.shape), theirs) == \
        ref.jax.tree.map(lambda s: s.shape, ours,
                         is_leaf=lambda x: isinstance(x, ShapeLeaf))
    for shape, names in (MESHES[2], MESHES[5]):
        r, t = rules_pair(ref, name, shape, names)
        assert t.param_specs(ours) == plain(ref, r.param_specs(theirs))


def _batch_shapes(cfg, b, seq=16):
    out = {"tokens": (b, seq)}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = (b, cfg.num_patches, cfg.d_model)
    if cfg.is_encoder_decoder:
        out["frames"] = (b, seq, cfg.d_model)
    return out


@pytest.mark.parametrize("batch", [1, 6, 8, 256])
def test_batch_specs_match_reference(ref, batch):
    """Every arch's batch (``tokens``, ``patch_embeds``, ``frames``) on
    every mesh: the leading axis over DP where ``batch`` divides it,
    else replicated — the reference's specs."""
    for name in arch_names():
        shapes = _batch_shapes(get_config(name), batch)
        for shape, names in MESHES:
            r, t = rules_pair(ref, name, shape, names)
            want = plain(ref, r.batch_specs(
                {k: ref.jax.ShapeDtypeStruct(v, np.int32)
                 for k, v in shapes.items()}, batch))
            got = t.batch_specs({k: ShapeLeaf(v) for k, v in shapes.items()},
                                batch)
            assert got == want, (name, shape, batch)


@pytest.mark.parametrize("name", arch_names())
def test_cache_specs_match_reference(ref, name):
    """``cache_specs`` of the smoke decode caches at batch 1 and 8 (the
    port's ``init_cache`` tensors beside ``jax.eval_shape`` of the
    reference's), under the full config's rules on every mesh."""
    cfg = smoke_config(name)
    rcfg = ref.configs.smoke_config(name)
    model = (EncDec if cfg.is_encoder_decoder else LM)(cfg, device="cpu")
    rm = (ref.EncDec if rcfg.is_encoder_decoder else ref.LM)(rcfg)
    for b in (1, 8):
        ours = model.init_cache(b, 32)
        theirs = ref.jax.eval_shape(lambda: rm.init_cache(b, 32))
        for shape, names in MESHES:
            r, t = rules_pair(ref, name, shape, names)
            assert t.cache_specs(ours, b) == plain(
                ref, r.cache_specs(theirs, b)), (name, b, shape)


def test_sharding_rules_cover_all_archs(full_shapes):
    """Every param leaf of every arch gets a spec whose sharded dims
    divide the mesh axes (the 2 × 4 mesh), the counterpart of the
    reference's test."""
    mesh = port_mesh((2, 4), ("data", "model"))
    for name in arch_names():
        specs = ShardingRules(get_config(name), mesh).param_specs(
            full_shapes[name])
        for (leaf, lshape), spec in zip(leaves_with_names(
                full_shapes[name]), _spec_list(specs)):
            assert len(spec) == len(lshape), (name, leaf)
            for dim, ax in zip(lshape, spec):
                if ax is None:
                    continue
                size = (mesh.shape[ax] if isinstance(ax, str) else
                        int(np.prod([mesh.shape[a] for a in ax])))
                assert dim % size == 0, (name, leaf, lshape, spec)


def _spec_list(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_list(v)
    else:
        yield tree


def test_shard_devices_follow_the_mesh():
    """A batch shard's device: the data axis' slots in order; a
    replicated batch runs once on each distinct device."""
    devs = np.array([[torch.device("cpu")], [torch.device("meta")]],
                    dtype=object)
    rules = ShardingRules(smoke_config("qwen3-4b"),
                          Mesh(devs, ("data", "model")))
    assert rules.shard_devices(P("data", None)) == [torch.device("cpu"),
                                                    torch.device("meta")]
    assert rules.shard_devices(P(None, None)) == [torch.device("cpu"),
                                                  torch.device("meta")]
    one = ShardingRules(smoke_config("qwen3-4b"),
                        port_mesh((4, 1), ("data", "model")))
    assert one.shard_devices(P("data")) == [torch.device("cpu")] * 4
    assert one.shard_devices(P(None)) == [torch.device("cpu")]
    assert P(("data",), None) == ("data", None)
    assert P(("pod", "data")) == (("pod", "data"),)


# --------------------------------------------------------------------- #
# actctx
# --------------------------------------------------------------------- #

def _kind_shapes(kind):
    bs, ss, hs = (1, 2, 6, 8, 16, 32), (1, 4, 6, 16), (3, 4, 8, 64)
    two = [(b, h) for b in bs for h in hs]
    three = [(b, s, h) for b in bs for s in ss for h in hs]
    if kind in ("bd", "bt"):
        return two
    if kind == "bthd":
        return [(b, s, h, 16) for b in bs for s in ss for h in hs]
    return three + two if kind == "btd" else three


@pytest.mark.parametrize("kind", KINDS)
def test_actctx_specs_match_reference(ref, monkeypatch, kind):
    """The spec each kind pins an activation to, on every mesh and a
    grid of batch, sequence and feature sizes (divisible and not): the
    port's ``actctx.spec`` against the argument the reference's
    ``shard`` hands ``with_sharding_constraint``."""
    seen = []
    monkeypatch.setattr(ref.actctx, "NamedSharding",
                        lambda mesh, spec: spec)
    monkeypatch.setattr(ref.jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    for shape, names in MESHES:
        am = ref.jax.sharding.AbstractMesh(shape, names)
        pm = port_mesh(shape, names)
        for xs in _kind_shapes(kind):
            with ref.actctx.use(am, ref.dp_axes(am)):
                ref.actctx.shard(np.zeros(xs, np.float32), kind)
            with actctx.use(pm, dp_axes(pm)):
                got = actctx.spec(xs, kind)
            assert got == seen.pop(), (kind, shape, xs)


def test_actctx_without_a_mesh_returns_its_input():
    x = torch.zeros(4, 8, 16)
    tree = {"w": torch.zeros(2)}
    assert actctx.shard(x, "btd") is x
    assert actctx.gather_params(tree) is tree
    with actctx.use(port_mesh((2, 1), ("data", "model")), ("data",)):
        assert actctx.shard(x, "btd_sp") is x   # no shard scope: whole


def test_actctx_checks_the_local_shard():
    """Under ``local_shard`` a pin holds its input to the shard its spec
    implies: a (2, 8, 16) shard of a 2-way split is 1/2 of a global
    batch of 4 on a data=2 mesh; on a data=4 mesh the same split is
    wrong, and so is another device."""
    x = torch.zeros(2, 8, 16)
    mesh2 = port_mesh((2, 1), ("data", "model"))
    with actctx.use(mesh2, ("data",)), \
            actctx.local_shard(2, torch.device("cpu")):
        for kind in ("btd", "btd_sp", "btd_fsdp", "btf"):
            assert actctx.shard(x, kind) is x
    with actctx.use(port_mesh((4, 1), ("data", "model")), ("data",)), \
            actctx.local_shard(2, torch.device("cpu")):
        with pytest.raises(RuntimeError, match="a shard of"):
            actctx.shard(x, "btd")
    with actctx.use(mesh2, ("data",)), \
            actctx.local_shard(2, torch.device("meta")):
        with pytest.raises(RuntimeError, match="on meta"):
            actctx.shard(x, "btd")
    # a replicated batch (split 1) of 3 rows on 2 shards
    with actctx.use(mesh2, ("data",)), \
            actctx.local_shard(1, torch.device("cpu")):
        y = torch.zeros(3, 8, 16)
        assert actctx.shard(y, "btd") is y


# --------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------- #

def psum_cases():
    """(name, per-shard inputs (shards, ...)) from numpy seeds."""
    rng = np.random.default_rng(2)
    wide = rng.standard_normal((4, 3000)).astype(np.float32)
    wide[2, 17] = 40.0                      # one outlier sets the scale
    mixed = (rng.standard_normal((2, 77, 5))
             * np.array([1e-3, 1.0])[:, None, None]).astype(np.float32)
    zero = rng.standard_normal((8, 1024)).astype(np.float32)
    zero[3] = 0.0
    return {"test8": np.random.default_rng(2).standard_normal(
                (8, 1024)).astype(np.float32),
            "outlier4": wide, "mixed2": mixed, "zero_shard8": zero}


def reference_psums(path):
    """In a child with 8 XLA host devices: the reference's
    ``compressed_psum`` under ``shard_map`` for every case."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh as JMesh, PartitionSpec as JP
    from repro.distributed.collectives import compressed_psum as ref_psum
    out = {}
    for name, x in psum_cases().items():
        n = x.shape[0]
        mesh = JMesh(np.array(jax.devices()[:n]), ("data",))
        rest = (None,) * (x.ndim - 1)
        fn = shard_map(lambda v: ref_psum(v[0], "data"), mesh=mesh,
                       in_specs=JP("data", *rest), out_specs=JP(),
                       check_rep=False)
        out[name] = np.asarray(fn(jnp.asarray(x)))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref_psums(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("psum_ref") / "ref.npz")
    code = textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8")
        import jax
        assert len(jax.devices()) == 8
        sys.path.insert(0, {TESTS!r})
        import test_torch_sharding
        test_torch_sharding.reference_psums({path!r})
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", list(psum_cases()))
def test_compressed_psum_bit_equal_to_reference(ref_psums, case):
    """The port's ``compressed_psum`` over the shards equals the
    reference's under ``shard_map`` bit for bit, on every shard, and
    lies within the reference test's 8·scale of the exact sum."""
    x = psum_cases()[case]
    out = compressed_psum([torch.from_numpy(s) for s in x])
    assert len(out) == x.shape[0]
    assert all(o is out[0] for o in out)            # one device: shared
    got = out[0].numpy()
    want = ref_psums[case]
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), case
    scale = np.abs(x).max() / 127.0
    exact = x.astype(np.float64).sum(0)
    assert np.max(np.abs(got - exact)) <= 8 * scale + 1e-5


def test_all_reduce_mean_matches_numpy():
    """The mean of the shards: fp32 sums, within fp32 rounding of the
    fp64 mean; bf16 shards get the fp32 mean rounded once; shards on
    one device share the result."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 33, 7)).astype(np.float32)
    out = all_reduce_mean([torch.from_numpy(s) for s in x])
    assert len(out) == 4 and all(o is out[0] for o in out)
    np.testing.assert_allclose(out[0].numpy(), x.astype(np.float64).mean(0),
                               rtol=1e-6, atol=1e-7)
    xb = [torch.from_numpy(s).to(torch.bfloat16) for s in x]
    got = all_reduce_mean(xb)[0]
    assert got.dtype == torch.bfloat16
    total = xb[0].float()
    for t in xb[1:]:
        total = total + t.float()
    assert torch.equal(got, (total / 4).to(torch.bfloat16))


@pytest.mark.gpu
def test_gpu_compressed_psum_bit_equal_to_cpu():
    """``compressed_psum`` and ``all_reduce_mean`` over the shards of
    ``make_host_mesh(data=4)`` (one card a shard where there are four):
    each shard's result lies on its shard's device, bit-equal to the
    same call on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch.mesh import make_host_mesh
    devices = make_host_mesh(data=4).axis_devices("data")
    x = psum_cases()["outlier4"]
    for fn in (compressed_psum, all_reduce_mean):
        want = fn([torch.from_numpy(s) for s in x])[0]
        got = fn([torch.from_numpy(s).to(d) for s, d in zip(x, devices)])
        for d, g in zip(devices, got):
            assert g.device == d
            assert torch.equal(g.cpu().view(torch.int32),
                               want.view(torch.int32)), (fn.__name__, d)
