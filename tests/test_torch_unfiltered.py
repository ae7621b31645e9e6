"""The port's unsegmented exact k-NN surface (``ops.topk``,
``ops.pairwise_sqdist``, ``quant.quantized_topk`` /
``quant.topk_sq8_rerank``, ``ops.topk_segmented``, ``kernels/ref.py``)
held against the JAX reference, and its CUDA kernels against their
plain versions.

CPU tests feed the same numpy inputs (made from a seed) to ``repro`` and
``repro_torch``.  The reference runs its Pallas kernels in interpret mode
and, where it has them, its XLA twins; the port runs the plain PyTorch
versions that CPU tensors take.  Tolerances: ids equal; distances atol
2e-4 / rtol 1e-4 (the reference's own parity tolerance: XLA and PyTorch
sum in other orders), pairwise matrices atol 1e-4·max|d|; sentinels
(+inf, -1) equal; the quantized scan bit-equal.

Tests marked ``gpu`` compare each CUDA kernel with its plain version on
the card and skip without one.  The reference is imported inside the
``ref`` fixture, so the card, which has no JAX, collects this file.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import distance_topk as tdt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise as tpw
from repro_torch.kernels import quant as tq
from repro_torch.kernels import ref as tref

ATOL, RTOL = 2e-4, 1e-4


@pytest.fixture(scope="module")
def ref():
    names = {"jnp": "jax.numpy", "ops": "repro.kernels.ops",
             "quant": "repro.kernels.quant", "ref": "repro.kernels.ref",
             "tuning": "repro.kernels.tuning"}
    return types.SimpleNamespace(
        **{k: importlib.import_module(v) for k, v in names.items()})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _data(seed, q, n, d, dup=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((q, d)).astype(np.float32)
    y = rng.standard_normal((n, d)).astype(np.float32)
    if dup:                          # exact ties: each row three times
        y = np.repeat(y[: (n + 2) // 3], 3, axis=0)[:n]
    return x, y


def _same(vp, ip, vt, it):
    vp, ip = np.asarray(vp), np.asarray(ip)
    vt, it = np.asarray(vt), np.asarray(it)
    assert np.array_equal(ip, it), (ip, it)
    fin = np.isfinite(vp)
    assert np.array_equal(fin, np.isfinite(vt))
    np.testing.assert_allclose(vt[fin], vp[fin], atol=ATOL, rtol=RTOL)


# --------------------------------------------------------------------- #
# ops.topk (topk_f32's plain version)
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("metric,accum,k,n,dup,impl", [
    ("l2", "f32", 5, 300, False, "pallas"),
    ("ip", "f32", 5, 300, False, "pallas"),
    ("l2", "bf16", 5, 300, False, "pallas"),
    ("ip", "bf16", 5, 300, False, "pallas"),
    ("l2", "f32", 128, 300, False, "pallas"),
    ("l2", "f32", 5, 259, True, "pallas"),       # ragged N, exact ties
    ("l2", "f32", 10, 7, False, "pallas"),       # N < k
    ("ip", "f32", 128, 100, False, "pallas"),
    ("l2", "f32", 5, 259, True, "xla"),
    ("ip", "f32", 128, 300, False, "xla"),
])
def test_topk_matches_reference(ref, metric, accum, k, n, dup, impl):
    x, y = _data(1, 6, n, 16, dup=dup)
    jx, jy = ref.jnp.asarray(x), ref.jnp.asarray(y)
    if impl == "pallas":
        vp, ip = ref.ops.topk(jx, jy, k, metric=metric, interpret=True,
                              accum=accum)
    else:
        vp, ip = ref.ops.topk_xla(jx, jy, k, metric=metric)
    vt, it = tops.topk(_t(x), _t(y), k, metric=metric, accum=accum)
    assert vt.shape == it.shape == (6, k) and it.dtype == torch.int32
    _same(vp, ip, vt, it)
    assert int(it.max()) < n
    if k > n:
        assert np.all(it[:, n:].numpy() == -1)
        assert np.all(np.isposinf(vt[:, n:].numpy()))


# --------------------------------------------------------------------- #
# topk_f32's split fold with a shared row bound, simulated in plain code
# --------------------------------------------------------------------- #

_MASKED = np.uint64(2 ** 64 - 1)


def _words(dist):
    """make_key's order-preserving uint32 of fp32 distances (-0 as +0)."""
    b = np.ascontiguousarray(dist, np.float32).view(np.uint32)
    b = np.where(b << np.uint32(1) == 0, np.uint32(0), b)
    return np.where(b >> np.uint32(31) == 1, ~b,
                    b | np.uint32(0x80000000)).astype(np.uint64)


def _value(words):
    u = np.asarray(words, np.uint64).astype(np.uint32)
    b = np.where(u >> np.uint32(31) == 1, u & np.uint32(0x7FFFFFFF), ~u)
    return b.view(np.float32)


def _simulate_split_fold(dist, kp, bn, splits, seed, publish_at=0,
                         union_at=1):
    """The fold of ``csrc/topk_dense.cu`` in plain code: the column tiles
    of each split visited in an order drawn from ``seed`` (blocks run in
    no order), each row's running top-kp keys per split, a tile keeping
    only columns whose distance word is at or below the lesser of the
    row's own k-th word and the bound shared by every split (lowered by
    each full list, and by the k-th of the union of the lists the splits
    published once); then the merge.  Returns (values, columns) with
    (+inf, -1) where a slot stays empty."""
    q, n = dist.shape
    words = _words(dist)
    keys = (words << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    n_tiles = -(-n // bn)
    per = -(-n_tiles // splits)
    lists = np.full((splits, q, kp), _MASKED, np.uint64)
    bound = np.full(q, 2 ** 32 - 1, np.uint64)
    pub, done = {}, [0] * splits
    todo = [s for s in range(splits) for _ in range(
        max(0, min(n_tiles, (s + 1) * per) - s * per))]
    np.random.default_rng(seed).shuffle(todo)
    for s in todo:
        t = s * per + done[s]
        cols = slice(t * bn, min(n, (t + 1) * bn))
        kth = lists[s, :, kp - 1]
        own = np.where(kth == _MASKED, np.uint64(2 ** 32 - 1),
                       kth >> np.uint64(32))
        thr = np.minimum(own, bound)
        cand = np.where(words[:, cols] <= thr[:, None], keys[:, cols],
                        _MASKED)
        lists[s] = np.sort(np.concatenate([lists[s], cand], 1), 1)[:, :kp]
        full = lists[s, :, kp - 1] != _MASKED
        bound = np.where(full, np.minimum(
            bound, lists[s, :, kp - 1] >> np.uint64(32)), bound)
        if done[s] == publish_at:
            pub[s] = lists[s].copy()
        if done[s] == union_at and pub:
            union = np.sort(np.concatenate(list(pub.values()), 1),
                            1)[:, kp - 1]
            bound = np.where(union != _MASKED, np.minimum(
                bound, union >> np.uint64(32)), bound)
        done[s] += 1
    best = np.sort(lists.transpose(1, 0, 2).reshape(q, -1), 1)[:, :kp]
    empty = best == _MASKED
    vals = np.where(empty, np.inf, _value(best >> np.uint64(32)))
    empty |= np.isposinf(vals)
    return (np.where(empty, np.inf, vals).astype(np.float32),
            np.where(empty, -1, (best & np.uint64(0xFFFFFFFF))
                     .astype(np.int64)).astype(np.int32))


@pytest.mark.parametrize("metric,dup,n,kp,seed", [
    ("l2", False, 1000, 16, 0), ("ip", False, 1000, 16, 1),
    ("l2", True, 997, 16, 2),                  # exact ties across splits
    ("ip", True, 997, 8, 3),                   # negative ties
    ("ip", True, 1200, 40, 4), ("l2", False, 37, 64, 5),   # N < kp
    ("l2", "many", 1000, 16, 6), ("ip", "many", 1000, 40, 7)])
def test_topk_f32_split_fold_with_shared_bound(ref, metric, dup, n, kp,
                                               seed):
    """Dropping every column above the lesser of a row's own k-th and the
    bound its splits share, in any order of the splits' tiles, keeps the
    exact top-kp: the keys equal ``dense_topk``'s and the reference
    ``_topk_kernel``'s (interpret mode), ids and sentinels alike.
    ``"many"``: 20 distinct rows, so every rank is a tie across splits."""
    x, y = _data(20 + seed, 9, n, 24, dup=dup is True)
    if dup == "many":
        y = y[np.random.default_rng(seed).integers(0, 20, n)]
    want_v, want_i = tdt.dense_topk(_t(x), _t(y), kp, metric=metric)
    dist = tdt.dense_distance(_t(x), _t(y), metric=metric).numpy()
    jx, jy = ref.jnp.asarray(x), ref.jnp.asarray(y)
    rv, ri = ref.ops.topk(jx, jy, kp, metric=metric, interpret=True)
    for order in range(3):
        got_v, got_i = _simulate_split_fold(dist, kp, bn=32, splits=7,
                                            seed=100 * seed + order)
        assert np.array_equal(got_i, want_i.numpy())
        assert np.array_equal(got_v, want_v.numpy())
        _same(rv, ri, got_v, got_i)
    if metric == "ip":
        assert (dist < 0).any()


@pytest.mark.parametrize("q", [1, 100, 128, 1000])
@pytest.mark.parametrize("k", [1, 16, 40, 128])
def test_topk_f32_tile_policy_h100_budget(q, k):
    """``topk_f32``'s policy: a tile of ``DENSE_TILES`` whose thread grid
    is the block's 256 threads, within one block's shared memory at every
    d (x resident where it fits, streamed past that), one block an SM,
    and one wave of blocks at N = 2^20 that fills at least 90 % of it."""
    from repro_torch.kernels import tuning as tt
    for d in (8, 97, 128, 768, 4096):
        bq, bn, resident = tt.select_dense_tile(q, d, k)
        tm, tn = tt.DENSE_TILES[(bq, bn)][:2]
        assert (bq // tm) * (bn // tn) == tt.THREADS
        assert tt.dense_smem_bytes(bq, bn, k, d, resident) <= tt.SMEM_BUDGET
        assert tt.dense_blocks_per_sm(bq, bn, k, d, resident) == 1
        if (bq, bn) == tt.DENSE_WIDE:
            assert q > tt.DENSE_NARROW[0]
        if not resident:
            assert tt.dense_smem_bytes(bq, bn, k, d, True) > tt.SMEM_BUDGET
        for n in (1000, 2 ** 20):
            s = tt.select_dense_splits(q, n, bq, bn, k=k, d=d,
                                       resident=resident)
            n_tiles, q_tiles = -(-n // bn), -(-q // bq)
            assert 1 <= s <= n_tiles
            per = -(-n_tiles // s)
            assert -(-n_tiles // per) == s          # no empty split
            if n == 2 ** 20 and q_tiles <= tt.SM_COUNT:
                assert q_tiles * s <= tt.SM_COUNT
                assert q_tiles * s >= 0.9 * tt.SM_COUNT


# --------------------------------------------------------------------- #
# ops.pairwise_sqdist (pairwise_f32's plain version)
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("metric,accum,n", [
    ("l2", "f32", 300), ("ip", "f32", 300), ("l2", "bf16", 259),
    ("ip", "bf16", 259), ("l2", "f32", 7)])
def test_pairwise_matches_reference(ref, metric, accum, n):
    x, y = _data(2, 9, n, 24)
    want = np.asarray(ref.ops.pairwise_sqdist(
        ref.jnp.asarray(x), ref.jnp.asarray(y), metric=metric,
        interpret=True, accum=accum))
    got = tops.pairwise_sqdist(_t(x), _t(y), metric=metric, accum=accum)
    assert got.shape == (9, n) and got.dtype == torch.float32
    tol = 1e-4 * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


# --------------------------------------------------------------------- #
# SQ8: the unsegmented quantized scan and the rerank entry point
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kqp,n,d,dup", [(40, 300, 16, False),
                                         (128, 300, 37, False),
                                         (24, 13, 100, False),
                                         (40, 259, 16, True)])
def test_quantized_topk_bit_equal_to_reference(ref, kqp, n, d, dup):
    x, y = _data(3, 5, n, d, dup=dup)
    xq, sx, x2 = (np.array(a) for a in
                  ref.quant.quantize_sq8(ref.jnp.asarray(x)))
    yq, sy, y2 = (np.array(a) for a in
                  ref.quant.quantize_sq8(ref.jnp.asarray(y)))
    bq, bn = ref.tuning.select_tiles(5, n, d, itemsize=1, k=kqp)
    qp, np_ = -(-5 // bq) * bq, -(-n // bn) * bn

    def pad(a, rows):
        return ref.jnp.asarray(np.pad(a, ((0, rows - a.shape[0]), (0, 0))))

    vp, ip = ref.quant.quantized_topk(
        pad(xq, qp), pad(sx, qp), pad(x2, qp), pad(yq, np_), pad(sy, np_),
        pad(y2, np_), kqp, block_q=bq, block_n=bn, interpret=True,
        valid_n=n)
    vt, it = tq.quantized_topk(_t(xq), _t(sx[:, 0]), _t(x2[:, 0]), _t(yq),
                               _t(sy[:, 0]), _t(y2[:, 0]), kqp)
    assert np.array_equal(np.asarray(ip)[:5], it.numpy())
    assert np.array_equal(np.asarray(vp)[:5], vt.numpy())


@pytest.mark.parametrize("q,n,d,k,overfetch", [
    (8, 1000, 64, 10, 4), (4, 300, 100, 5, 4), (6, 300, 32, 4, 16),
    (3, 20, 16, 32, 4)])                          # N < k: (+inf, -1) tail
def test_topk_sq8_rerank_matches_reference(ref, q, n, d, k, overfetch):
    x, y = _data(q + n, q, n, d)
    vp, ip = ref.quant.topk_sq8_rerank(ref.jnp.asarray(x),
                                       ref.jnp.asarray(y), k,
                                       overfetch=overfetch, interpret=True)
    vt, it = tq.topk_sq8_rerank(_t(x), _t(y), k, overfetch=overfetch)
    assert vt.shape == it.shape == (q, k)
    _same(vp, ip, vt, it)


# --------------------------------------------------------------------- #
# ops.topk_segmented (host-materialised segmented API over kernel A)
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("metric,k", [("l2", 4), ("ip", 9), ("l2", 128)])
def test_topk_segmented_matches_reference(ref, metric, k):
    rng = np.random.default_rng(4)
    x, y = _data(5, 7, 259, 16)
    cseg = rng.integers(0, 3, 259).astype(np.int32)
    qseg = np.asarray([0, 1, 2, 0, -1, 3, 2], np.int32)  # -1: no match,
    vp, ip = ref.ops.topk_segmented(                      # 3: empty
        ref.jnp.asarray(x), ref.jnp.asarray(y), qseg, cseg, k,
        metric=metric, interpret=True)
    vt, it = tops.topk_segmented(_t(x), _t(y), qseg, cseg, k, metric=metric)
    _same(vp, ip, vt, it)
    assert np.all(it[4].numpy() == -1) and np.all(it[5].numpy() == -1)


# --------------------------------------------------------------------- #
# kernels/ref.py, the k and overfetch contracts, the slice as a whole
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ref_oracles_match_reference(ref, metric):
    x, y = _data(6, 5, 140, 33)
    jx, jy = ref.jnp.asarray(x), ref.jnp.asarray(y)
    fn = "pairwise_sqdist_ref" if metric == "l2" else "pairwise_negdot_ref"
    np.testing.assert_allclose(getattr(tref, fn)(_t(x), _t(y)).numpy(),
                               np.asarray(getattr(ref.ref, fn)(jx, jy)),
                               atol=ATOL, rtol=RTOL)
    vp, ip = ref.ref.topk_ref(jx, jy, 12, metric=metric)
    vt, it = tref.topk_ref(_t(x), _t(y), 12, metric=metric)
    _same(vp, ip, vt, it)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_k_and_overfetch_raise_in_both_packages(ref, pkg):
    x, y = _data(7, 2, 300, 32)
    if pkg == "ref":
        x, y, kw = ref.jnp.asarray(x), ref.jnp.asarray(y), {"interpret": True}
        ops, quant = ref.ops, ref.quant
    else:
        x, y, kw = _t(x), _t(y), {}
        ops, quant = tops, tq
    seg = np.zeros(2, np.int32), np.zeros(300, np.int32)
    with pytest.raises(ValueError, match="exceeds kernel max"):
        ops.topk(x, y, 129, **kw)
    with pytest.raises(ValueError, match="exceeds kernel max"):
        ops.topk_segmented(x, y, *seg, 129, **kw)
    with pytest.raises(ValueError, match="128-lane"):
        quant.topk_sq8_rerank(x, y, 64, overfetch=4, **kw)
    v, _ = quant.topk_sq8_rerank(x, y, 32, overfetch=4, **kw)  # 128: legal
    assert tuple(v.shape) == (2, 32)


@pytest.mark.parametrize("q,n,d,k", [(8, 1000, 64, 10), (16, 513, 100, 7)])
def test_unfiltered_slice_against_host_oracle(ref, q, n, d, k):
    """The slice end to end on one base, as ``chip_smoke.py`` drives it:
    ``ops.topk`` equals the reference's NumPy oracle, ``pairwise_sqdist``
    ranks the same way, and the SQ8 rerank keeps recall ≥ 0.9 with every
    returned distance the exact fp32 distance of its row."""
    x, y = _data(q * n, q, n, d)
    ov, oi = ref.ops.topk_numpy(x, y, k)
    tv, ti = tops.topk(_t(x), _t(y), k)
    _same(ov, oi, tv, ti)
    dv, di = tdt.stable_topk(tops.pairwise_sqdist(_t(x), _t(y)), k)
    assert torch.equal(di, ti)
    sv, si = tq.topk_sq8_rerank(_t(x), _t(y), k)
    rec = np.mean([len(set(si[r].tolist()) & set(oi[r].tolist())) / k
                   for r in range(q)])
    assert rec >= 0.9
    exact = ((y[si.numpy()] - x[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(sv.numpy(), exact, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------- #
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------- #

def _agree(vk, ik, vp, ip, tol):
    """Values within ``tol``; ids equal except near ties at the k-th."""
    vk, ik, vp, ip = (a.cpu().numpy() for a in (vk, ik, vp, ip))
    fin = np.isfinite(vp)
    assert np.array_equal(np.isfinite(vk), fin)
    assert np.array_equal(ik == -1, ~fin)
    if fin.any():
        assert np.abs(vk[fin] - vp[fin]).max() <= tol
    for r in range(vp.shape[0]):
        f = fin[r]
        if f.any():
            kth = vp[r][f][-1]
            assert (set(ik[r][f][vk[r][f] < kth - 2 * tol].tolist())
                    == set(ip[r][f][vp[r][f] < kth - 2 * tol].tolist()))


@pytest.mark.gpu
@pytest.mark.parametrize("metric,accum,kp,q,n,d,dup,offset", [
    ("l2", "f32", 16, 100, 5000, 128, False, 0),
    ("l2", "f32", 128, 100, 3000, 64, False, 0),
    ("ip", "f32", 24, 100, 1037, 100, False, 0),
    ("l2", "bf16", 16, 100, 2000, 128, False, 0),
    ("l2", "f32", 40, 100, 900, 48, True, 0),
    ("l2", "f32", 64, 100, 50, 32, False, 0),      # N < kp
    ("l2", "f32", 16, 200, 20000, 768, False, 0),  # x streamed
    ("l2", "f32", 32, 50, 777, 97, False, 1),      # misaligned: 4-byte copies
    ("l2", "f32", 16, 129, 3000, 128, False, 1),
    ("ip", "f32", 16, 129, 3000, 128, False, 0),   # ragged Q
    ("l2", "f32", 128, 129, 5000, 128, False, 0),
    ("ip", "f32", 16, 128, 40000, 64, True, 0)])   # ties across splits
def test_gpu_topk_f32_matches_plain(cuda, metric, accum, kp, q, n, d, dup,
                                    offset):
    x, y = _data(12, q, n, d, dup=dup)
    x = _t(x, cuda)
    if offset:  # a view that starts `offset` words into its buffer
        buf = torch.empty(n * d + offset, device=cuda)
        buf[offset:] = _t(y, cuda).reshape(-1)
        y = buf[offset:].view(n, d)
        assert not tdt.vec_loads_ok(x, y)
    else:
        y = _t(y, cuda)
    before = tdt.distance_topk.launches
    vk, ik = tdt.distance_topk(x, y, kp, metric=metric, accum=accum)
    torch.cuda.synchronize()
    assert tdt.distance_topk.launches == before + 1
    vp, ip = tdt.dense_topk(x, y, kp, metric=metric, accum=accum)
    fin = torch.isfinite(vp)
    tol = 1e-4 * max(float(vp[fin].abs().max()), 1.0)
    _agree(vk, ik, vp, ip, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kqp,q,n,d", [
    (40, 100, 5000, 128), (128, 100, 3000, 64), (32, 100, 777, 100),
    (40, 100, 700, 4096), (64, 100, 30, 16), (40, 128, 4097, 128),
    (8, 129, 1037, 8), (8, 33, 2000, 130), (128, 1, 999, 100)])
def test_gpu_qtopk_sq8_bit_equal(cuda, kqp, q, n, d):
    x, y = _data(13, q, n, d)
    xq, sx, x2 = tq.quantize_sq8(_t(x, cuda))
    yq, sy, y2 = tq.quantize_sq8(_t(y, cuda))
    args = (xq, sx[:, 0].contiguous(), x2[:, 0].contiguous(), yq,
            sy[:, 0].contiguous(), y2[:, 0].contiguous(), kqp)
    before = tq.quantized_topk.launches
    vk, ik = tq.quantized_topk(*args)
    torch.cuda.synchronize()
    assert tq.quantized_topk.launches == before + 1
    vp, ip = tq.sq8_dense(*args)
    assert torch.equal(vk, vp) and torch.equal(ik, ip)


@pytest.mark.gpu
@pytest.mark.parametrize("metric,accum,q,n,d", [
    ("l2", "f32", 100, 5000, 128), ("ip", "f32", 100, 1037, 100),
    ("l2", "bf16", 37, 2000, 64), ("ip", "bf16", 5, 70, 33)])
def test_gpu_pairwise_f32_matches_plain(cuda, metric, accum, q, n, d):
    x, y = (_t(a, cuda) for a in _data(14, q, n, d))
    before = tpw.pairwise_distance.launches
    got = tpw.pairwise_distance(x, y, metric=metric, accum=accum)
    torch.cuda.synchronize()
    assert tpw.pairwise_distance.launches == before + 1
    want = tdt.dense_distance(x, y, metric=metric, accum=accum)
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= tol
