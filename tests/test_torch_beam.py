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
row a repeated neighbour (both copies enter the fold).  The ``dense``
variant ties almost every key: vectors in {0, 1} and rows that repeat
their first three neighbours.  The ``wide`` buckets take wide rows (2M
of 33, 96, 128 and 130, the last two chunks of the kernel's row) and
long ef-lists (1,024 and 1,040): a real neighbour 0 past position 32
followed by pads, a real 0 early in a row with the pads past position
32, repeats 64 positions apart, and past 128 a real 0 at the end of
the first chunk then pads, a real 0 in the second chunk and a
neighbour repeated across the two.  The ``deep`` buckets take wide
vectors, past one round of the kernel's distance loop: d = 131 (scalar
loads), 516 and the LM's 2,560 (float4 loads).  The ``gpu`` cases hold
the entry points on CUDA tensors to ``_beam`` on the CPU under both
placements of the visited bitmap, of the ef-list and of the query.
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


def _bucket(kind: str):
    """(vectors, ids, level0, entry, gidx, queries, masks, midx) as numpy:
    G graphs of N, N - 7 and N // 2 slots, 0-padded ids, rows of 1..2M
    neighbours padded with -1.  ``quirks``: see the module's note;
    ``dense``: vectors and queries in {0, 1} (six distances in all, so
    most keys tie) and every other row its first three neighbours twice."""
    rng = np.random.default_rng(7)
    lo, hi = (0, 2) if kind == "dense" else (-2, 3)
    vecs = rng.integers(lo, hi, (V, D)).astype(np.float32)
    queries = rng.integers(lo, hi, (P, D)).astype(np.float32)
    ids = np.zeros((G, N), np.int32)
    lvl = np.full((G, N, M2), -1, np.int32)
    entry = np.zeros(G, np.int32)
    for g, n in enumerate((N, N - 7, N // 2)):
        ids[g, :n] = rng.choice(V, n, replace=False)
        for s in range(n):
            deg = int(rng.integers(1, M2 + 1))
            lvl[g, s, :deg] = rng.integers(0, n, deg)
        entry[g] = int(rng.integers(1, n))
        if kind == "quirks":
            lvl[g, entry[g]] = -1
            lvl[g, entry[g], :3] = [0, 1 + g, 2 + g]
            lvl[g, 3::3, 1] = lvl[g, 3::3, 0]
        if kind == "dense":
            lvl[g, ::2, 3:] = lvl[g, ::2, :3]
    gidx = np.arange(P, dtype=np.int32) % G
    masks = rng.random((2, V)) < 0.5
    midx = rng.integers(0, 2, P).astype(np.int32)
    return vecs, ids, lvl, entry, gidx, queries, masks, midx


BUCKETS = {kind: _bucket(kind) for kind in ("ties", "quirks", "dense")}


def _wide_bucket(m2: int, n: int, ef: int, d: int = 12):
    """One graph of n slots at d (12 unless given) with rows of up to m2
    neighbours:
    the entry row a real 0 at position 32 then -1 pads, every fifth row
    a real 0 at position 1 with pads from position 32, every seventh row
    one neighbour repeated 64 positions apart (when m2 allows) and a
    real 0 at position 70 then pads; past 128 positions (two chunks of
    the kernel's row) every eleventh row a real 0 at position 127 then
    pads, the next a real 0 at position 129 and the next its neighbour at
    position 3 again at 129.  Returns the bucket's arrays and its ef."""
    rng = np.random.default_rng(m2 if d == 12 else (m2, d))
    v_n, p = n + 40, 6
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
    if m2 > 128:
        lvl[0, ::11, 127] = 0
        lvl[0, ::11, 128:] = -1
        lvl[0, 1::11, 129] = 0
        lvl[0, 2::11, 129] = lvl[0, 2::11, 3]
    entry = np.array([n // 3], np.int32)
    lvl[0, entry[0], 32] = 0
    lvl[0, entry[0], 33:] = -1
    gidx = np.zeros(p, np.int32)
    masks = rng.random((2, v_n)) < 0.5
    midx = rng.integers(0, 2, p).astype(np.int32)
    return (vecs, ids, lvl, entry, gidx, queries, masks, midx), ef


WIDE = {f"m2_{m2}_ef_{ef}": _wide_bucket(m2, n, ef)
        for m2, n, ef in ((33, 512, 64), (96, 512, 64), (128, 4096, 1024),
                          (130, 1024, 64), (33, 2048, 1040))}
DEEP = {f"d_{d}": _wide_bucket(33, 512, 64, d) for d in (131, 516, 2560)}


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


@pytest.mark.parametrize("bucket", sorted(DEEP))
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_plain_beam_bit_equal_on_deep_vectors(ref, bucket, metric):
    arrays, ef = DEEP[bucket]
    for filtered in (False, True):
        want = _run(ref.hnsw_jax, arrays, ref.jnp.asarray, filtered=filtered,
                    k=10, ef=ef, metric=metric)
        got = _run(hnsw_torch, arrays, _cpu, filtered=filtered, k=10, ef=ef,
                   metric=metric)
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
    nbr = hnsw_torch.neighbour_table(ids, lvl)
    wide = torch.zeros((V, 2 * D))
    wide[:, ::2] = vecs
    with pytest.raises(ValueError, match="vectors must be contiguous"):
        hnsw_torch.beam_f32(wide[:, ::2], ids, nbr, ent, gidx, q, k=K,
                            ef=EF)
    with pytest.raises(ValueError, match="nbr shape"):
        hnsw_torch.beam_f32(vecs, ids, nbr[..., :1], ent, gidx, q, k=K,
                            ef=EF)
    with pytest.raises(ValueError, match="ef-list capacity"):
        hnsw_torch.beam_f32(vecs, ids, nbr, ent, gidx, q, k=EF + 1, ef=EF)
    for ef in (EF, 1040):        # no ef limit: the device is what refuses
        with pytest.raises(ValueError, match="runs on CUDA tensors"):
            hnsw_torch.beam_f32(vecs, ids, nbr, ent, gidx, q, k=K, ef=ef)
    assert hnsw_torch.beam_f32.launches == before == 0


def test_upload_neighbour_table_is_ids_of_level0(monkeypatch):
    """``PackedRuntime.to_device`` gives every size bucket and every
    graph state the table ``beam_f32`` reads, where it builds one (on
    CUDA; here forced): (level0, ids[g, level0]) pairs, (-1, -1) where
    level0 pads, and level0 then only the table's slot plane.  A CPU
    upload builds none."""
    from repro_torch.core import packed
    from repro_torch.core.vectormaton import VectorMaton, VectorMatonConfig
    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("abcd"), size=rng.integers(5, 15)))
            for _ in range(230)]
    vecs = rng.standard_normal((230, 8)).astype(np.float32)
    vm = VectorMaton(vecs, seqs, VectorMatonConfig(
        device="cpu", T=20, M=8, ef_con=40))
    plain = vm.runtime.to_device()
    vm.runtime._dev = None
    real = packed._graph_arrays
    monkeypatch.setattr(packed, "_graph_arrays",
                        lambda ids, lvl, ent, dev, table: real(
                            ids, lvl, ent, dev, True))
    dev = vm.runtime.to_device()
    stacks = {"bucket": [(plain["graph_buckets"][b], a) for b, a in
                         dev["graph_buckets"].items()],
              "state": [(plain["graphs"][u], a) for u, a in
                        dev["graphs"].items()]}
    assert all(stacks.values())
    pads = 0
    for kind, pairs in stacks.items():
        for p, a in pairs:
            assert "nbr" not in p, kind
            ids, lvl = p["ids"].numpy(), p["level0"].numpy()
            g = np.arange(len(ids))[:, None, None]
            want = np.where(lvl >= 0, ids[g, np.clip(lvl, 0, None)], -1)
            nbr = a["nbr"]
            assert nbr.dtype == torch.int32 and nbr.is_contiguous(), kind
            assert np.array_equal(nbr[..., 0].numpy(), lvl), kind
            assert np.array_equal(nbr[..., 1].numpy(), want), kind
            assert a["level0"].data_ptr() == nbr.data_ptr(), kind
            assert torch.equal(a["level0"], p["level0"]), kind
            pads += int((lvl < 0).sum())
    assert pads > 0


def _gpu_case(cuda, monkeypatch, arrays, placement, list_place, *, k, ef,
              metric, filtered, query_place="shared"):
    """The entry point on CUDA tensors against ``_beam`` on the CPU:
    bit-equal results, ``beam_f32`` launched; then ``beam_f32(stats=
    True)``: the same, visited slots equal to ``_beam``'s, the visited
    bitmaps, ef-lists and query where ``placement``, ``list_place`` and
    ``query_place`` say (``"global"`` by a budget of 0 bytes), a cycle
    count for each phase."""
    host = [_cpu(a) for a in arrays]
    vecs, ids, lvl, ent, gidx, q, masks, midx = host
    fk = dict(masks=masks, midx=midx) if filtered else {}
    plain_visited = []
    want = hnsw_torch._beam(vecs, ids, lvl, ent, gidx, q, k=k, ef=ef,
                            max_iter=None, metric=metric,
                            visited_out=plain_visited, **fk)
    if placement == "global":
        monkeypatch.setattr(hnsw_torch, "_SMEM_TWO_BLOCKS", 0)
    if list_place == "global":
        monkeypatch.setattr(hnsw_torch, "_SMEM_LIST", 0)
    if query_place == "global":
        monkeypatch.setattr(hnsw_torch, "_SMEM_QUERY", 0)
    on_card = [t.to(cuda) for t in host]
    before = hnsw_torch.beam_f32.launches
    got_d, got_i = _run(hnsw_torch, on_card, lambda t: t,
                        filtered=filtered, k=k, ef=ef, metric=metric)
    torch.cuda.synchronize()
    assert hnsw_torch.beam_f32.launches == before + 1
    assert torch.equal(got_i.cpu(), want[1])
    assert got_d.cpu().numpy().tobytes() == want[0].numpy().tobytes()
    vecs, ids, lvl, ent, gidx, q, masks, midx = on_card
    fk = dict(masks=masks, midx=midx) if filtered else {}
    got_d, got_i, stats = hnsw_torch.beam_f32(
        vecs, ids, hnsw_torch.neighbour_table(ids, lvl), ent, gidx, q, k=k,
        ef=ef, metric=metric, stats=True, **fk)
    torch.cuda.synchronize()
    assert hnsw_torch.beam_f32.launches == before + 2
    assert (stats["bitmap"], stats["list"], stats["query"]) == (
        placement, list_place, query_place)
    assert torch.equal(got_i.cpu(), want[1])
    assert got_d.cpu().numpy().tobytes() == want[0].numpy().tobytes()
    assert torch.equal(stats["visited"].cpu(), plain_visited[0])
    assert int(stats["steps"].max()) > 0
    assert stats["cycles"].shape == (len(gidx), len(hnsw_torch._PROF))
    assert bool((stats["cycles"] >= 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", sorted(BUCKETS))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("placement", ["shared", "global"])
@pytest.mark.parametrize("list_place", ["shared", "global"])
def test_gpu_kernel_bit_equal_to_plain(cuda, monkeypatch, bucket, metric,
                                       filtered, placement, list_place):
    _gpu_case(cuda, monkeypatch, BUCKETS[bucket], placement, list_place,
              k=K, ef=EF, metric=metric, filtered=filtered)


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", sorted(WIDE))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("placement", ["shared", "global"])
@pytest.mark.parametrize("list_place", ["shared", "global"])
def test_gpu_kernel_bit_equal_on_wide_rows(cuda, monkeypatch, bucket, metric,
                                           filtered, placement, list_place):
    arrays, ef = WIDE[bucket]
    _gpu_case(cuda, monkeypatch, arrays, placement, list_place, k=10, ef=ef,
              metric=metric, filtered=filtered)


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", sorted(DEEP))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("query_place", ["shared", "global"])
def test_gpu_kernel_bit_equal_on_deep_vectors(cuda, monkeypatch, bucket,
                                              metric, filtered, query_place):
    arrays, ef = DEEP[bucket]
    list_place = "global" if query_place == "global" else "shared"
    _gpu_case(cuda, monkeypatch, arrays, "shared", list_place, k=10, ef=ef,
              metric=metric, filtered=filtered, query_place=query_place)
