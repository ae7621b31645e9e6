"""The first slice end to end: ``repro`` (``backend="jax"``) against
``repro_torch`` (``device="cpu"``, the plain PyTorch path).

The same seeded corpus, queries, inserts, deletes and compaction go
through both packages; every wave must give equal ids and distances
within atol 2e-4 / rtol 1e-4 (the reference's own parity tolerance:
XLA and PyTorch sum in different orders).  Scenarios cover the SQ8
default and the fp32 scan, raw-only and graph-backed indexes, frozen,
mid-delta and compacted generations, and a multi-segment LIKE (the
residual path).  The reference is imported inside fixtures so the card,
which has no JAX, can still collect this file.
"""

import importlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.core.convert import from_reference_checkpoint
from repro_torch.core.vectormaton import VectorMaton, VectorMatonConfig
from repro_torch.kernels import ops as tops

DIM = 16
PREDS = ["a", "ab", "abc", "ba", "a OR cd", "dd", "a AND NOT b",
         "LIKE 'a%b%c'", "b AND c"]
STAGES = ["frozen", "mid_delta", "compacted"]


@pytest.fixture(scope="module")
def ref():
    return types.SimpleNamespace(
        vm=importlib.import_module("repro.core.vectormaton"),
        ckpt=importlib.import_module("repro.distributed.checkpoint"),
        ops=importlib.import_module("repro.kernels.ops"))


def _corpus(seed=7, n=230):
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("abcd"), size=rng.integers(5, 15)))
            for _ in range(n)]
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    return vecs, seqs


def _assert_same(res_ref, res_port, what):
    assert len(res_ref) == len(res_port)
    for p, (dr, ir), (dt, it) in zip(PREDS, res_ref, res_port):
        assert np.array_equal(ir, it), (what, p, ir, it)
        np.testing.assert_allclose(dt, dr, atol=2e-4, rtol=1e-4,
                                   err_msg=f"{what} {p}")


@pytest.fixture(scope="module", params=[
    ("sq8", 10 ** 9), ("none", 10 ** 9), ("sq8", 20), ("none", 20)],
    ids=["sq8-raw", "none-raw", "sq8-graph", "none-graph"])
def scenario(request, ref):
    """Run one churn scenario through both packages; record each stage."""
    quantize, t = request.param
    # launch counters are per process: start both from zero so the
    # launch_* keys reflect this scenario only
    ref.ops.reset_launch_stats()
    tops.reset_launch_stats()
    vecs, seqs = _corpus()
    cfg = dict(T=t, M=8, ef_con=40, quantize=quantize, auto_compact=False)
    vm_r = ref.vm.VectorMaton(vecs, seqs, ref.vm.VectorMatonConfig(
        backend="jax", **cfg))
    vm_t = VectorMaton(vecs, seqs, VectorMatonConfig(device="cpu", **cfg))
    if t < 10 ** 9:
        assert len(vm_t.runtime.graphs) > 0
    rng = np.random.default_rng(3)
    out = {}

    def wave(stage):
        q = rng.standard_normal((len(PREDS), DIM)).astype(np.float32)
        out[stage] = (vm_r.query_batch(q, PREDS, 6),
                      vm_t.query_batch(q, PREDS, 6))

    wave("frozen")
    for _ in range(25):                  # past the upload watermark
        v = rng.standard_normal(DIM).astype(np.float32)
        s = "".join(rng.choice(list("abcd"), size=9))
        vm_r.insert(v, s)
        vm_t.insert(v, s)
    for vid in rng.choice(len(seqs), 40, replace=False):
        vm_r.delete(int(vid))
        vm_t.delete(int(vid))
    wave("mid_delta")
    vm_r.compact()
    vm_t.compact()
    wave("compacted")
    out["stats"] = (vm_r.maintenance_stats(), vm_t.maintenance_stats())
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_query_batch_matches_reference(scenario, stage):
    _assert_same(*scenario[stage], stage)


def test_maintenance_stats_keys_match_reference(scenario):
    stats_r, stats_t = scenario["stats"]
    assert set(stats_r) == set(stats_t)
    for key in ("generation", "compactions", "deleted", "delta_pending"):
        assert stats_r[key] == stats_t[key], key


def test_sq8_streak_matches_reference(ref):
    """Near-duplicate rows make every certificate fail: both packages
    escalate, then fall back after the same streak.  The rows are near
    ties by construction, so the answers are compared by distance."""
    vecs, seqs = _corpus()
    rng = np.random.default_rng(9)
    base = 10.0 * rng.standard_normal(DIM).astype(np.float32)
    vecs = base + 1e-4 * vecs
    vm_r = ref.vm.VectorMaton(vecs, seqs, ref.vm.VectorMatonConfig(
        T=10 ** 9, backend="jax"))
    vm_t = VectorMaton(vecs, seqs, VectorMatonConfig(T=10 ** 9,
                                                     device="cpu"))
    for _ in range(5):
        q = rng.standard_normal((2, DIM)).astype(np.float32)
        res_r = vm_r.query_batch(q, ["a", "b"], 6)
        res_t = vm_t.query_batch(q, ["a", "b"], 6)
        for (dr, _), (dt, _) in zip(res_r, res_t):
            np.testing.assert_allclose(dt, dr, atol=2e-4, rtol=1e-4)
    assert vm_t.runtime.sq8_stats == vm_r.runtime.sq8_stats
    assert vm_t.runtime.sq8_stats["fallbacks"] >= 2


def test_from_reference_checkpoint(ref, tmp_path):
    """A checkpoint written by the reference loads into the port and
    answers as the reference's own restore does."""
    vecs, seqs = _corpus(seed=11)
    vm_r = ref.vm.VectorMaton(vecs, seqs, ref.vm.VectorMatonConfig(
        T=20, M=8, ef_con=40, backend="jax", auto_compact=False))
    rng = np.random.default_rng(12)
    for _ in range(10):
        vm_r.insert(rng.standard_normal(DIM).astype(np.float32), "abcab")
    for vid in (3, 17, 42, 231):
        vm_r.delete(vid)
    path = str(tmp_path / "ckpt")
    ref.ckpt.save_vectormaton(vm_r, path)
    back_r = ref.ckpt.load_vectormaton(ref.vm.VectorMaton, path)
    back_r.config.backend = "jax"
    back_r._refresh_runtime()
    back_t = from_reference_checkpoint(path, device="cpu")
    assert back_t.deleted == back_r.deleted
    assert back_t.esam.num_states == back_r.esam.num_states
    assert back_t.config.T == 20 and back_t.config.backend == "torch"
    assert len(back_t.runtime.graphs) == len(back_r.runtime.graphs) > 0
    q = rng.standard_normal((len(PREDS), DIM)).astype(np.float32)
    _assert_same(back_r.query_batch(q, PREDS, 6),
                 back_t.query_batch(q, PREDS, 6), "restored")


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "new = ['repro_torch.distributed.sharding',"
        " 'repro_torch.distributed.actctx', 'repro_torch.launch.shapes',"
        " 'repro_torch.launch.analysis', 'repro_torch.launch.dryrun']\n"
        "assert all(m in sys.modules for m in new), new\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 62          # every module imported


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vecs, seqs = _corpus(n=20)
    assert VectorMatonConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VectorMaton(vecs, seqs)
    with pytest.raises(ValueError, match="unknown backend"):
        VectorMaton(vecs, seqs, VectorMatonConfig(backend="jax",
                                                  device="cpu"))
