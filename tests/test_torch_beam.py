"""The fused HNSW beam: the port's plain ``_beam`` (what CPU tensors run)
held bit for bit to ``repro.core.hnsw_jax`` on integer-valued data, the
wrappers' routing and argument checks, and (``gpu``) the CUDA kernel
``beam_f32`` held to ``_beam`` on the card.

One small bucket of three graphs is reused by every case.  Vectors and
queries are integers in [-2, 2] at d = 5, so every distance is exact in
fp32 in any summation order and equal distances are common: the tie
rules (first minimum picked, lower position first in each fold) decide
the answers.  The ``quirks`` variant gives the entry rows a real
neighbour 0 followed by -1 pads (the pad's clipped write resets
``visited[0]``, so node 0 can enter the list twice) and every third
row a repeated neighbour (both copies enter the fold).  The ``wide``
buckets take the kernel's wide rows (2M of 33, 96 and 128, so lanes
32 and up of the warp that reads a row) and its longest ef-list (1,024):
a real neighbour 0 past position 32 followed by pads, a real 0 early in
a row with the pads past position 32, and repeats 64 positions apart.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.core import hnsw_torch

V, D, G, N, M2 = 160, 5, 3, 64, 6
P, EF, K = 9, 16, 6


@pytest.fixture(scope="module")
def ref():
    names = {"jnp": "jax.numpy", "hnsw_jax": "repro.core.hnsw_jax"}
    return types.SimpleNamespace(
        **{k: importlib.import_module(v) for k, v in names.items()})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bucket(quirks: bool):
    """(vectors, ids, level0, entry, gidx, queries, masks, midx) as numpy:
    G graphs of N, N - 7 and N // 2 slots, 0-padded ids, rows of 1..2M
    neighbours padded with -1."""
    rng = np.random.default_rng(7)
    vecs = rng.integers(-2, 3, (V, D)).astype(np.float32)
    queries = rng.integers(-2, 3, (P, D)).astype(np.float32)
    ids = np.zeros((G, N), np.int32)
    lvl = np.full((G, N, M2), -1, np.int32)
    entry = np.zeros(G, np.int32)
    for g, n in enumerate((N, N - 7, N // 2)):
        ids[g, :n] = rng.choice(V, n, replace=False)
        for s in range(n):
            deg = int(rng.integers(1, M2 + 1))
            lvl[g, s, :deg] = rng.integers(0, n, deg)
        entry[g] = int(rng.integers(1, n))
        if quirks:
            lvl[g, entry[g]] = -1
            lvl[g, entry[g], :3] = [0, 1 + g, 2 + g]
            lvl[g, 3::3, 1] = lvl[g, 3::3, 0]
    gidx = np.arange(P, dtype=np.int32) % G
    masks = rng.random((2, V)) < 0.5
    midx = rng.integers(0, 2, P).astype(np.int32)
    return vecs, ids, lvl, entry, gidx, queries, masks, midx


BUCKETS = {"ties": _bucket(False), "quirks": _bucket(True)}


def _wide_bucket(m2: int, n: int, ef: int):
    """One graph of n slots at d = 12 with rows of up to m2 neighbours:
    the entry row a real 0 at position 32 then -1 pads, every fifth row
    a real 0 at position 1 with pads from position 32, every seventh row
    one neighbour repeated 64 positions apart (when m2 allows) and a
    real 0 at position 70 then pads.  Returns the bucket's arrays and
    its ef."""
    rng = np.random.default_rng(m2)
    v_n, d, p = n + 40, 12, 6
    vecs = rng.integers(-2, 3, (v_n, d)).astype(np.float32)
    queries = rng.integers(-2, 3, (p, d)).astype(np.float32)
    ids = rng.choice(v_n, n, replace=False).astype(np.int32)[None]
    lvl = np.full((1, n, m2), -1, np.int32)
    for s in range(n):
        deg = int(rng.integers(m2 // 2, m2 + 1))
        lvl[0, s, :deg] = rng.integers(1, n, deg)
    lvl[0, ::5, 1] = 0
    lvl[0, ::5, 32:] = -1
    if m2 > 70:
        lvl[0, ::7, 66] = lvl[0, ::7, 2]
        lvl[0, ::7, 70] = 0
        lvl[0, ::7, 71:] = -1
    entry = np.array([n // 3], np.int32)
    lvl[0, entry[0], 32] = 0
    lvl[0, entry[0], 33:] = -1
    gidx = np.zeros(p, np.int32)
    masks = rng.random((2, v_n)) < 0.5
    midx = rng.integers(0, 2, p).astype(np.int32)
    return (vecs, ids, lvl, entry, gidx, queries, masks, midx), ef


WIDE = {f"m2_{m2}_ef_{ef}": _wide_bucket(m2, n, ef)
        for m2, n, ef in ((33, 512, 64), (96, 512, 64), (128, 4096, 1024))}


def _run(fns, arrays, conv, *, filtered, k=K, ef=EF, metric="l2",
         max_iter=None):
    vecs, ids, lvl, ent, gidx, q, masks, midx = (conv(a) for a in arrays)
    if filtered:
        return fns.hnsw_search_fused_filtered(
            vecs, ids, lvl, ent, masks, midx, gidx, q, k=k, ef=ef,
            max_iter=max_iter, metric=metric)
    return fns.hnsw_search_fused(vecs, ids, lvl, ent, gidx, q, k=k, ef=ef,
                                 max_iter=max_iter, metric=metric)


def _cpu(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bit_equal(ref_out, port_out):
    (jd, ji), (td, ti) = ref_out, port_out
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = td.numpy(), ti.numpy()
    assert np.array_equal(ji, ti), (ji, ti)
    assert jd.tobytes() == td.tobytes(), (jd, td)


@pytest.mark.parametrize("bucket", sorted(BUCKETS))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("filtered", [False, True])
def test_plain_beam_bit_equal_on_integer_ties(ref, bucket, metric, filtered):
    arrays = BUCKETS[bucket]
    want = _run(ref.hnsw_jax, arrays, ref.jnp.asarray, filtered=filtered,
                metric=metric)
    got = _run(hnsw_torch, arrays, _cpu, filtered=filtered, metric=metric)
    _bit_equal(want, got)
    assert (np.asarray(want[1]) >= 0).any()


@pytest.mark.parametrize("bucket", sorted(WIDE))
@pytest.mark.parametrize("filtered", [False, True])
def test_plain_beam_bit_equal_on_wide_rows(ref, bucket, filtered):
    arrays, ef = WIDE[bucket]
    want = _run(ref.hnsw_jax, arrays, ref.jnp.asarray, filtered=filtered,
                k=10, ef=ef)
    got = _run(hnsw_torch, arrays, _cpu, filtered=filtered, k=10, ef=ef)
    _bit_equal(want, got)
    assert (np.asarray(want[1]) >= 0).any()


@pytest.mark.parametrize("filtered", [False, True])
def test_plain_beam_cut_by_max_iter(ref, filtered):
    arrays = BUCKETS["quirks"]
    want = _run(ref.hnsw_jax, arrays, ref.jnp.asarray, filtered=filtered,
                max_iter=3)
    got = _run(hnsw_torch, arrays, _cpu, filtered=filtered, max_iter=3)
    _bit_equal(want, got)
    full = _run(hnsw_torch, arrays, _cpu, filtered=filtered)
    assert not torch.equal(got[1], full[1])     # the cut changed answers


@pytest.mark.parametrize("filtered", [False, True])
def test_plain_beam_k_equal_to_ef(ref, filtered):
    arrays = BUCKETS["ties"]
    want = _run(ref.hnsw_jax, arrays, ref.jnp.asarray, filtered=filtered,
                k=EF)
    got = _run(hnsw_torch, arrays, _cpu, filtered=filtered, k=EF)
    _bit_equal(want, got)


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("filtered", [False, True])
def test_k_above_ef_raises_in_both_packages(ref, pkg, filtered):
    fns, conv = ((ref.hnsw_jax, ref.jnp.asarray) if pkg == "ref"
                 else (hnsw_torch, _cpu))
    with pytest.raises(ValueError, match="ef-list capacity"):
        _run(fns, BUCKETS["ties"], conv, filtered=filtered, k=EF + 1)


def test_cpu_tensors_take_the_plain_beam_and_the_kernel_checks_first():
    arrays = BUCKETS["quirks"]
    before = hnsw_torch.beam_f32.launches
    for filtered in (False, True):
        got = _run(hnsw_torch, arrays, _cpu, filtered=filtered)
        vecs, ids, lvl, ent, gidx, q, masks, midx = map(_cpu, arrays)
        fk = dict(masks=masks, midx=midx) if filtered else {}
        want = hnsw_torch._beam(vecs, ids, lvl, ent, gidx, q, k=K, ef=EF,
                                max_iter=None, metric="l2", **fk)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    vecs, ids, lvl, ent, gidx, q, masks, midx = map(_cpu, arrays)
    wide = torch.zeros((V, 2 * D))
    wide[:, ::2] = vecs
    with pytest.raises(ValueError, match="vectors must be contiguous"):
        hnsw_torch.beam_f32(wide[:, ::2], ids, lvl, ent, gidx, q, k=K,
                            ef=EF)
    with pytest.raises(ValueError, match="ef=1040 above"):
        hnsw_torch.beam_f32(vecs, ids, lvl, ent, gidx, q, k=K, ef=1040)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        hnsw_torch.beam_f32(vecs, ids, lvl, ent, gidx, q, k=K, ef=EF)
    assert hnsw_torch.beam_f32.launches == before == 0


def _gpu_case(cuda, monkeypatch, arrays, placement, *, k, ef, metric,
              filtered):
    """``beam_f32`` on the card against ``_beam``: bit-equal results and
    visited slots, one launch, the visited bitmaps where ``placement``
    says (``"global"`` by a budget of 0 bytes for two blocks an SM)."""
    vecs, ids, lvl, ent, gidx, q, masks, midx = (
        _cpu(a).to(cuda) for a in arrays)
    fk = dict(masks=masks, midx=midx) if filtered else {}
    plain_visited = []
    want = hnsw_torch._beam(vecs, ids, lvl, ent, gidx, q, k=k, ef=ef,
                            max_iter=None, metric=metric,
                            visited_out=plain_visited, **fk)
    if placement == "global":
        monkeypatch.setattr(hnsw_torch, "_SMEM_TWO_BLOCKS", 0)
    before = hnsw_torch.beam_f32.launches
    got_d, got_i, stats = hnsw_torch.beam_f32(
        vecs, ids, lvl, ent, gidx, q, k=k, ef=ef, metric=metric, stats=True,
        **fk)
    torch.cuda.synchronize()
    assert hnsw_torch.beam_f32.launches == before + 1
    assert stats["bitmap"] == placement
    assert torch.equal(got_i, want[1])
    assert got_d.cpu().numpy().tobytes() == want[0].cpu().numpy().tobytes()
    assert torch.equal(stats["visited"], plain_visited[0])


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", sorted(BUCKETS))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("placement", ["shared", "global"])
def test_gpu_kernel_bit_equal_to_plain(cuda, monkeypatch, bucket, metric,
                                       filtered, placement):
    _gpu_case(cuda, monkeypatch, BUCKETS[bucket], placement, k=K, ef=EF,
              metric=metric, filtered=filtered)


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", sorted(WIDE))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("placement", ["shared", "global"])
def test_gpu_kernel_bit_equal_on_wide_rows(cuda, monkeypatch, bucket, metric,
                                           filtered, placement):
    arrays, ef = WIDE[bucket]
    _gpu_case(cuda, monkeypatch, arrays, placement, k=10, ef=ef,
              metric=metric, filtered=filtered)
