"""The owner-range tile skip of kernels A and B, and the SQ8
certificate's owner maxima, held against the JAX reference.

Kernel A (``csrc/topk_seg.cu``) and kernel B (``csrc/qtopk_seg.cu``) sort
the query rows by owner and skip every (row tile, column tile) pair whose
two-sign owner ranges do not meet.  Here the plain versions of their
pre-pass and tile test (``distance_topk.tile_owner_ranges`` /
``tiles_meet``) drive a plain
segmented top-k that looks only at the pairs the rule keeps; it must
equal the port's plain ``segmented_dense_topk`` and the reference's
Pallas kernel in interpret mode on every owner layout the main path can
produce, and the rule must keep every pair of equal owners.  Tolerances
as in ``test_torch_kernels.py``: ids and sentinels equal, distances atol
2e-4 / rtol 1e-4 against the reference, bit-equal within the port.

The SQ8 side: the top-k over only the pairs kept at kernel B's tiles
equals ``sq8_dense_segmented`` and the reference's ``_qtopk_seg_kernel``
in interpret mode (bit-equal), the owner-sorted row order gives the same
result once permuted back, and ``quant.owner_max`` (the certificate's
per-owner maxima) is bit-equal to ``scatter_reduce(amax)`` and to the
reference's ``.at[own].max``.

The ``gpu`` tests hold both CUDA kernels against their plain versions on
the same layouts, and their tile counters against the rule's count.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import distance_topk as tdt
from repro_torch.kernels import quant as tq
from repro_torch.kernels import tuning as ttune

ATOL, RTOL = 2e-4, 1e-4
I32_MAX, I32_MIN = 2 ** 31 - 1, -2 ** 31

LAYOUTS = ("runs", "random", "tombstones", "pad_rows", "empty_owner",
           "negative_match", "ragged_q")


@pytest.fixture(scope="module")
def ref():
    names = {"jnp": "jax.numpy", "ops": "repro.kernels.ops",
             "quant": "repro.kernels.quant"}
    return types.SimpleNamespace(
        **{k: importlib.import_module(v) for k, v in names.items()})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def layout(name, seed=0, q=24, n=300, d=16, owners=5):
    """(x, y, qseg, cseg) numpy inputs of one owner layout:

    runs            owner-sorted descriptor runs then owner-sorted tail
                    runs (tiles straddle the boundaries), rows in owner
                    order, a few -3 tombstones;
    random          unsorted random owners on both sides;
    tombstones      runs with 30 % of the columns scattered -3;
    pad_rows        runs with the last third of the rows -1;
    empty_owner     runs with rows of an owner that has no candidates;
    negative_match  runs with rows and a stretch of columns owning -5;
    ragged_q        runs with Q = 27, not a multiple of any row tile here.
    """
    rng = np.random.default_rng(seed)
    if name == "ragged_q":
        q = 27
    x = rng.standard_normal((q, d)).astype(np.float32)
    y = rng.standard_normal((n, d)).astype(np.float32)
    if name == "random":
        qseg = rng.integers(-1, owners + 2, q)
        cseg = rng.integers(-3, owners, n)
    else:
        cut = 2 * n // 3
        cseg = np.concatenate([np.sort(rng.integers(0, owners, cut)),
                               np.sort(rng.integers(0, owners, n - cut))])
        qseg = np.sort(rng.integers(0, owners, q))
        cseg[rng.random(n) < (0.3 if name == "tombstones" else 0.03)] = -3
        if name == "pad_rows":
            qseg[-(q // 3):] = -1
        elif name == "empty_owner":
            qseg[: q // 4] = owners + 7
        elif name == "negative_match":
            qseg[: q // 4] = -5
            cseg[n // 3: n // 3 + n // 8] = -5
    return x, y, qseg.astype(np.int32), cseg.astype(np.int32)


def skip_topk(x, y, qseg, cseg, k, bq, bn, *, metric="l2", accum="f32"):
    """Segmented top-k over only the (row tile, column tile) pairs the
    skip rule keeps, rows tiled in the order of a stable argsort of
    ``qseg`` as kernel A tiles them; pairs in skipped tiles count as
    masked.  Returns the result in caller row order, and the keep mask."""
    perm = torch.argsort(qseg, stable=True)
    keep = tdt.tiles_meet(tdt.tile_owner_ranges(qseg[perm], bq),
                          tdt.tile_owner_ranges(cseg, bn))
    q, n = x.shape[0], y.shape[0]
    row_tile = torch.empty(q, dtype=torch.long)
    row_tile[perm] = torch.arange(q) // bq
    pair_kept = keep[row_tile][:, torch.arange(n) // bn]
    dist = tdt.dense_distance(x, y, metric=metric, accum=accum)
    match = (qseg[:, None] == cseg[None, :]) & pair_kept
    vals, idx = tdt.stable_topk(torch.where(match, dist, float("inf")), k)
    return vals, idx, keep


def _t(a, dev="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("name", LAYOUTS)
def test_tile_owner_ranges_match_brute_force(name):
    _, _, qseg, cseg = layout(name)
    for owners, block in ((cseg, 16), (np.sort(qseg), 4), (cseg, 256)):
        got = tdt.tile_owner_ranges(_t(owners), block).numpy()
        for t in range(got.shape[0]):
            o = owners[t * block:(t + 1) * block]
            pos, neg = o[o >= 0], o[o < 0]
            want = [pos.min() if len(pos) else I32_MAX,
                    pos.max() if len(pos) else I32_MIN,
                    neg.min() if len(neg) else I32_MAX,
                    neg.max() if len(neg) else I32_MIN]
            assert got[t].tolist() == want, (t, o)


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("bq,bn,q,n", [(4, 16, 24, 300),
                                       (*ttune.SQ8_TILE, 100, 20_000)],
                         ids=["tiny", "kernel_tiles"])
def test_skip_rule_keeps_every_equal_owner_pair(name, bq, bn, q, n):
    _, _, qseg, cseg = layout(name, seed=1, q=q, n=n)
    qs, cs = _t(qseg), _t(cseg)
    perm = torch.argsort(qs, stable=True).numpy()
    keep = tdt.tiles_meet(tdt.tile_owner_ranges(qs[perm], bq),
                          tdt.tile_owner_ranges(cs, bn)).numpy()
    rows, cols = np.nonzero(qseg[perm][:, None] == cseg[None, :])
    assert keep[rows // bq, cols // bn].all()
    # owner-grouped columns: most tiles go, once rows span several tiles
    # (ragged_q's 27 rows are one row tile of 32 holding every owner)
    if name != "random" and keep.shape[0] > 1:
        assert keep.mean() < 0.6, keep.mean()


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("metric,accum,k,tiles", [
    ("l2", "f32", 5, (4, 16)),
    ("ip", "bf16", 12, ttune.F32_NARROW),
])
def test_skip_topk_matches_reference(ref, name, metric, accum, k, tiles):
    x, y, qseg, cseg = layout(name, seed=2)
    vs, is_, keep = skip_topk(_t(x), _t(y), _t(qseg), _t(cseg), k, *tiles,
                              metric=metric, accum=accum)
    vd, id_ = tdt.segmented_dense_topk(_t(x), _t(y), _t(qseg), _t(cseg), k,
                                       metric=metric, accum=accum)
    assert torch.equal(is_, id_) and torch.equal(vs, vd)
    vp, ip = ref.ops.topk_segmented(ref.jnp.asarray(x), ref.jnp.asarray(y),
                                    qseg, cseg, k, metric=metric,
                                    interpret=True, accum=accum)
    vp, ip = np.asarray(vp), np.asarray(ip)
    assert np.array_equal(ip, is_.numpy())
    fin = np.isfinite(vp)
    assert np.array_equal(fin, np.isfinite(vs.numpy()))
    np.testing.assert_allclose(vs.numpy()[fin], vp[fin], atol=ATOL,
                               rtol=RTOL)


def sq8_layout(name, seed, **kw):
    """One owner layout as kernel B's inputs: codes, scales and squared
    norms (``quantize_sq8``) and owners, CPU tensors."""
    x, y, qseg, cseg = layout(name, seed=seed, **kw)
    xq, sx, x2 = tq.quantize_sq8(_t(x))
    yq, sy, y2 = tq.quantize_sq8(_t(y))
    return (xq, yq, sx[:, 0].contiguous(), x2[:, 0].contiguous(),
            sy[:, 0].contiguous(), y2[:, 0].contiguous(), _t(qseg),
            _t(cseg))


@pytest.mark.parametrize("name", LAYOUTS)
def test_sq8_skip_topk_matches_plain_and_reference(ref, name):
    """Kernel B's owner skip at its own tiles: a top-k of the quantized
    distances over only the kept pairs equals the plain version and the
    reference's Pallas kernel, bit for bit."""
    xq, yq, sx, x2, sy, y2, qseg, cseg = sq8_layout(name, 4, q=40, n=700)
    q, n, k = xq.shape[0], yq.shape[0], 16
    bq, bn = ttune.SQ8_TILE
    perm = torch.argsort(qseg, stable=True)
    keep = tdt.tiles_meet(tdt.tile_owner_ranges(qseg[perm], bq),
                          tdt.tile_owner_ranges(cseg, bn))
    row_tile = torch.empty(q, dtype=torch.long)
    row_tile[perm] = torch.arange(q) // bq
    kept = keep[row_tile][:, torch.arange(n) // bn]
    dist = tq._sq8_dist(xq, sx, x2, yq, sy, y2)
    match = (qseg[:, None] == cseg[None, :]) & kept
    vs, is_ = tdt.stable_topk(torch.where(match, dist, float("inf")), k)
    vd, id_ = tq.sq8_dense_segmented(xq, yq, sx, x2, sy, y2, qseg, cseg, k)
    assert torch.equal(is_, id_) and torch.equal(vs, vd)

    def pad(a, rows, fill=0):                # the reference's tile grid
        a = a.numpy()
        a = a.reshape(a.shape[0], -1)
        width = ((0, rows - a.shape[0]), (0, 0))
        return ref.jnp.asarray(np.pad(a, width, constant_values=fill))

    qp, np_ = -(-q // 8) * 8, -(-n // 128) * 128
    vp, ip = ref.quant._quantized_topk_segmented(
        pad(xq, qp), pad(sx, qp), pad(x2, qp), pad(yq, np_), pad(sy, np_),
        pad(y2, np_), pad(qseg, qp, -1), pad(cseg, np_, -3).T, k,
        block_q=8, block_n=128, interpret=True, valid_n=n)
    assert np.array_equal(np.asarray(ip)[:q], is_.numpy())
    assert np.array_equal(np.asarray(vp)[:q], vs.numpy())


@pytest.mark.parametrize("name", LAYOUTS)
def test_owner_sorted_rows_give_the_same_sq8_result(name):
    """Kernel B works on rows in the order of a stable argsort of qseg
    and its merge writes row perm[r]: the plain version over the sorted
    rows, permuted back, is the plain version over the rows as given."""
    xq, yq, sx, x2, sy, y2, qseg, cseg = sq8_layout(name, 5)
    want = tq.sq8_dense_segmented(xq, yq, sx, x2, sy, y2, qseg, cseg, 12)
    perm = torch.argsort(qseg, stable=True)
    got = tq.sq8_dense_segmented(xq[perm], yq, sx[perm], x2[perm], sy, y2,
                                 qseg[perm], cseg, 12)
    for w, g in zip(want, got):
        back = torch.empty_like(g)
        back[perm] = g
        assert torch.equal(back, w)


@pytest.mark.parametrize("name", LAYOUTS)
def test_owner_max_bit_equal_to_scatter_reduce_and_reference(ref, name):
    """The certificate's per-owner maxima of u = sy and t = sy·(l1 + d/2)
    over live columns, on each owner layout (tombstones, pads, owners
    with no columns, one owner in several runs), at several sizes so
    that blocks of the partial maxima straddle runs."""
    rng = np.random.default_rng(6)
    for n in (300, 5_000, 70_000):
        _, _, qseg, cseg = layout(name, seed=6, n=n, d=4)
        qp = qseg.shape[0]
        sy = rng.uniform(1e-3, 2.0, n).astype(np.float32)
        l1 = rng.integers(0, 4000, n).astype(np.float32)
        cs = _t(cseg)
        live = cs >= 0
        own = cs.long().clamp(0, qp - 1)
        u = torch.where(live, _t(sy), 0.0)
        t = torch.where(live, _t(sy) * (_t(l1) + 64.0), 0.0)
        got = tq.owner_max(own, torch.stack([u, t], 1), qp)
        for col, v in enumerate((u, t)):
            want = torch.zeros(qp).scatter_reduce(0, own, v, "amax")
            assert torch.equal(got[:, col], want)
            jref = ref.jnp.zeros((qp,), ref.jnp.float32).at[
                ref.jnp.asarray(own.numpy())].max(ref.jnp.asarray(v.numpy()))
            assert np.array_equal(np.asarray(jref), got[:, col].numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("name", LAYOUTS)
def test_gpu_topk_seg_layout_matches_plain(cuda, name):
    x, y, qseg, cseg = (_t(a, cuda) for a in
                        layout(name, seed=3, q=100, n=20_000, d=128))
    tdt.reset_tile_stats()
    vk, ik = tdt.topk_seg_f32(x, y, qseg, cseg, 16)
    torch.cuda.synchronize()
    vp, ip = tdt.segmented_dense_topk(x, y, qseg, cseg, 16)
    vk, ik, vp, ip = (a.cpu().numpy() for a in (vk, ik, vp, ip))
    fin = np.isfinite(vp)
    tol = 1e-4 * max(float(np.abs(vp[fin]).max()) if fin.any() else 1.0, 1.0)
    assert np.array_equal(np.isfinite(vk), fin)
    assert np.array_equal(ik == -1, ~fin)
    if fin.any():
        assert np.abs(vk[fin] - vp[fin]).max() <= tol
    for r in range(vp.shape[0]):        # ids equal except near ties
        f = fin[r]
        if f.any():
            kth = vp[r][f][-1]
            assert (set(ik[r][f][vk[r][f] < kth - 2 * tol].tolist())
                    == set(ip[r][f][vp[r][f] < kth - 2 * tol].tolist()))
    _, _, keep = skip_topk(x.cpu(), y.cpu(), qseg.cpu(), cseg.cpu(), 16,
                           *ttune.select_f32_tiles(100, segmented=True))
    assert tdt.tile_stats() == {"computed": int(keep.sum()),
                                "total": keep.numel()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", LAYOUTS)
def test_gpu_qtopk_seg_layout_bit_equal(cuda, name):
    args = [a.to(cuda) for a in sq8_layout(name, 7, q=100, n=20_000, d=128)]
    tdt.reset_tile_stats()
    vk, ik = tq.qtopk_seg_sq8(*args, 40)
    torch.cuda.synchronize()
    vp, ip = tq.sq8_dense_segmented(*args, 40)
    assert torch.equal(vk, vp) and torch.equal(ik, ip)
    qseg, cseg = args[6].cpu(), args[7].cpu()
    bq, bn = ttune.SQ8_TILE
    keep = tdt.tiles_meet(
        tdt.tile_owner_ranges(qseg[torch.argsort(qseg, stable=True)], bq),
        tdt.tile_owner_ranges(cseg, bn))
    assert tdt.tile_stats("qtopk_seg_sq8") == {"computed": int(keep.sum()),
                                               "total": keep.numel()}
