"""The port's kernel modules held against the JAX reference, and the CUDA
kernels held against their plain versions.

CPU tests feed the same numpy inputs (made from a seed) to ``repro`` and
``repro_torch``.  The reference runs its Pallas kernels in interpret mode
(``REPRO_IMPL=pallas``) and its XLA twins (``REPRO_IMPL=xla``), the port
its plain PyTorch versions (what CPU tensors take).  Tolerances: ids
equal, distances atol 2e-4 / rtol 1e-4 (the reference's own parity
tolerance; summation order differs between XLA and PyTorch), sentinels
(+inf, -1) equal, SQ8 codes, certificates and merges bit-equal.

Tests marked ``gpu`` compare each CUDA kernel with its plain version on
the card and skip without one.  The reference is imported inside the
``ref`` fixture, so the card, which has no JAX, collects this file and
runs ``pytest -m gpu``.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.core import hnsw_torch
from repro_torch.kernels import distance_topk as tdt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise as tpw
from repro_torch.kernels import quant as tq
from repro_torch.kernels import tuning as ttune

ATOL, RTOL = 2e-4, 1e-4


@pytest.fixture(scope="module")
def ref():
    names = {"jnp": "jax.numpy", "ops": "repro.kernels.ops",
             "dt": "repro.kernels.distance_topk",
             "quant": "repro.kernels.quant",
             "hnsw_jax": "repro.core.hnsw_jax", "hnsw": "repro.core.hnsw"}
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


def _seg_data(seed, q=6, n=300, d=16, owners=3, dup=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((q, d)).astype(np.float32)
    y = rng.standard_normal((n, d)).astype(np.float32)
    if dup:                          # exact ties: each row three times
        y = np.repeat(y[: (n + 2) // 3], 3, axis=0)[:n]
    qseg = rng.integers(0, owners, q).astype(np.int32)
    qseg[-1] = -1                    # a row that matches nothing
    qseg[0] = owners + 1             # an owner with no candidates
    cseg = rng.integers(0, owners, n).astype(np.int32)
    return x, y, qseg, cseg


def _same(vp, ip, vt, it):
    vp, ip = np.asarray(vp), np.asarray(ip)
    vt, it = np.asarray(vt), np.asarray(it)
    assert np.array_equal(ip, it), (ip, it)
    fin = np.isfinite(vp)
    assert np.array_equal(fin, np.isfinite(vt))
    np.testing.assert_allclose(vt[fin], vp[fin], atol=ATOL, rtol=RTOL)


# --------------------------------------------------------------------- #
# segmented fp32 top-k (kernel A's plain version)
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("metric,accum,k,dup,impl", [
    ("l2", "f32", 5, False, "pallas"),
    ("l2", "f32", 5, True, "pallas"),
    ("ip", "f32", 7, False, "pallas"),
    ("l2", "bf16", 5, False, "pallas"),
    ("ip", "bf16", 5, False, "pallas"),
    ("l2", "f32", 128, False, "pallas"),
    ("l2", "f32", 5, True, "xla"),
    ("ip", "f32", 128, False, "xla"),
])
def test_segmented_topk_matches_reference(ref, metric, accum, k, dup, impl):
    x, y, qseg, cseg = _seg_data(1, dup=dup)
    jx, jy = ref.jnp.asarray(x), ref.jnp.asarray(y)
    if impl == "pallas":
        vp, ip = ref.ops.topk_segmented(jx, jy, qseg, cseg, k,
                                        metric=metric, interpret=True,
                                        accum=accum)
    else:
        vp, ip = ref.ops.topk_segmented_xla(jx, jy, qseg, cseg, k,
                                            metric=metric)
    vt, it = tdt.topk_seg_f32(_t(x), _t(y), _t(qseg), _t(cseg), k,
                              metric=metric, accum=accum)
    _same(vp, ip, vt, it)
    assert np.all(it[-1].numpy() == -1) and np.all(it[0].numpy() == -1)


# --------------------------------------------------------------------- #
# descriptor expansion and flat candidate assembly
# --------------------------------------------------------------------- #

def _desc_inputs(seed):
    """Resident table + CSR + tombstones, descriptors with padding, a
    resident tail and a shipped tail past the upload watermark."""
    rng = np.random.default_rng(seed)
    n, d = 120, 8
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    base_ids = rng.permutation(n).astype(np.int32)
    deleted = rng.random(n) < 0.15
    starts = np.asarray([0, 40, 90, 0, 0, 0, 0, 0], np.int32)
    lens = np.asarray([25, 30, 20, 0, 0, 0, 0, 0], np.int32)
    owners = np.asarray([0, 1, 0, -3, -3, -3, -3, -3], np.int32)
    tres = rng.integers(0, n, 128).astype(np.int32)
    tres_o = np.where(np.arange(128) < 50, 2, -3).astype(np.int32)
    tship = np.arange(n, n + 128).astype(np.int32)
    tship_o = np.where(np.arange(128) < 9, 1, -3).astype(np.int32)
    rows = rng.standard_normal((128, d)).astype(np.float32)
    return (vectors, base_ids, deleted, starts, lens, owners, tres, tres_o,
            tship, tship_o, rows)


def test_expand_descriptors_matches_reference(ref):
    _, base_ids, _, starts, lens, owners, *_ = _desc_inputs(2)
    jc, jo = ref.dt.expand_descriptors(
        ref.jnp.asarray(base_ids), ref.jnp.asarray(starts),
        ref.jnp.asarray(lens), ref.jnp.asarray(owners), 128)
    tc, to = tdt.expand_descriptors(_t(base_ids), _t(starts), _t(lens),
                                    _t(owners), 128)
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(jo), to.numpy())


def test_assemble_flat_candidates_matches_reference(ref):
    args = _desc_inputs(3)
    jy, jc, jg = ref.dt.assemble_flat_candidates(
        *[ref.jnp.asarray(a) for a in args], 128)
    ty, tc, tg = tdt.assemble_flat_candidates(*[_t(a) for a in args], 128)
    assert np.array_equal(np.asarray(jy), ty.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(jg), tg.numpy())
    assert (tc.numpy() == -3).sum() > 5 * 8      # tombstones + padding


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_descriptor_topk_matches_reference(ref, monkeypatch, impl):
    monkeypatch.setenv("REPRO_IMPL", impl)
    (vectors, base_ids, deleted, starts, lens, owners, tres, tres_o, tship,
     tship_o, rows) = _desc_inputs(4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    qseg = np.asarray([0, 1, 2, 1, 0], np.int32)
    host = (x, qseg, starts[:3], lens[:3], owners[:3], tres[:50],
            tres_o[:50], tship[:9], rows[:9], tship_o[:9])
    jv, jg = ref.ops.topk_segmented_desc(
        ref.jnp.asarray(vectors), ref.jnp.asarray(base_ids),
        ref.jnp.asarray(deleted), *host, 6)
    tv, tg = tops.topk_segmented_desc(_t(vectors), _t(base_ids),
                                      _t(deleted), *host, 6)
    _same(jv, jg, tv, tg)


# --------------------------------------------------------------------- #
# SQ8: codes, descriptor scan + rerank + certificate
# --------------------------------------------------------------------- #

def test_quantize_sq8_ext_codes_bit_equal(ref):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((64, 37)) * rng.uniform(0.01, 50, (64, 1))
         ).astype(np.float32)
    x[3] = 0.0
    x[5, :4] = [0.5, -0.5, 1.5, -2.5]          # exact halves after scaling
    jq, js, jsq, jl1 = ref.quant.quantize_sq8_ext(ref.jnp.asarray(x))
    tq_, ts, tsq, tl1 = tq.quantize_sq8_ext(_t(x))
    assert np.array_equal(np.asarray(jq), tq_.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jl1), tl1.numpy())
    np.testing.assert_allclose(np.asarray(jsq), tsq.numpy(), rtol=1e-6)


@pytest.mark.parametrize("impl,near", [("pallas", False), ("xla", False),
                                       ("xla", True)])
def test_sq8_descriptor_path_matches_reference(ref, monkeypatch, impl,
                                               near):
    """``near``: near-duplicate rows make the certificate fail, so the
    False branch is compared too."""
    monkeypatch.setenv("REPRO_IMPL", impl)
    (vectors, base_ids, deleted, starts, lens, owners, tres, tres_o, tship,
     tship_o, rows) = _desc_inputs(7)
    rng = np.random.default_rng(8)
    if near:
        vectors = (vectors[:1] + 1e-3 * vectors).astype(np.float32)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    qseg = np.asarray([0, 1, 2, 1, 0], np.int32)
    host = (x, qseg, starts[:3], lens[:3], owners[:3], tres[:50],
            tres_o[:50], tship[:9], rows[:9], tship_o[:9])
    jvec = ref.jnp.asarray(vectors)
    jv, jg, jc = ref.quant.topk_sq8_segmented_desc(
        jvec, ref.quant.quantize_sq8_ext(jvec), ref.jnp.asarray(base_ids),
        ref.jnp.asarray(deleted), *host, 6, overfetch=4)
    tvec = _t(vectors)
    tv, tg, tc = tq.topk_sq8_segmented_desc(
        tvec, tq.quantize_sq8_ext(tvec), _t(base_ids), _t(deleted), *host,
        6, overfetch=4)
    _same(jv, jg, tv, tg)
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert bool(np.asarray(jc).all()) is not near


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_overfetch_raise_in_both_packages(ref, pkg):
    args = _desc_inputs(9)
    x = np.zeros((2, 8), np.float32)
    host = (x, np.zeros(2, np.int32), args[3][:1], args[4][:1],
            args[5][:1], args[6][:0], args[7][:0], args[8][:0],
            args[10][:0], args[9][:0])
    with pytest.raises(ValueError, match="128-lane"):
        if pkg == "ref":
            v = ref.jnp.asarray(args[0])
            ref.quant.topk_sq8_segmented_desc(
                v, ref.quant.quantize_sq8_ext(v), ref.jnp.asarray(args[1]),
                ref.jnp.asarray(args[2]), *host, 40, overfetch=4)
        else:
            v = _t(args[0])
            tq.topk_sq8_segmented_desc(
                v, tq.quantize_sq8_ext(v), _t(args[1]), _t(args[2]), *host,
                40, overfetch=4)
    with pytest.raises(ValueError, match="exceeds kernel max"):
        if pkg == "ref":
            ref.ops.topk_segmented_desc(
                ref.jnp.asarray(args[0]), ref.jnp.asarray(args[1]),
                ref.jnp.asarray(args[2]), *host, 129)
        else:
            tops.topk_segmented_desc(_t(args[0]), _t(args[1]),
                                     _t(args[2]), *host, 129)


# --------------------------------------------------------------------- #
# device merge
# --------------------------------------------------------------------- #

def test_merge_topk_device_bit_equal(ref):
    rng = np.random.default_rng(10)
    t, w, r, s, k, n = 24, 16, 9, 4, 10, 60
    big_d = np.sort(rng.random((t, w)).astype(np.float32), 1)
    big_d[:, ::5] = big_d[:, :1]                     # equal distances
    big_i = rng.integers(0, n, (t, w)).astype(np.int32)   # duplicate ids
    big_d[rng.random((t, w)) < 0.1] = np.inf
    big_i[rng.random((t, w)) < 0.1] = -1
    big_d[-1], big_i[-1] = np.inf, -1                # padding row
    sel = rng.integers(0, t, (r, s)).astype(np.int32)
    sel[0, 2:] = t - 1
    deleted = rng.random(n) < 0.2
    jd, ji = ref.ops.merge_topk_device(
        ref.jnp.asarray(big_d), ref.jnp.asarray(big_i),
        ref.jnp.asarray(sel), ref.jnp.asarray(deleted), k)
    td, ti = tops.merge_topk_device(_t(big_d), _t(big_i), _t(sel),
                                    _t(deleted), k)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jd), td.numpy())


# --------------------------------------------------------------------- #
# fused beam search
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def graphs(ref):
    """Two graphs of different sizes stacked as the executor stacks a
    size bucket (0-padded ids, -1-padded neighbours)."""
    rng = np.random.default_rng(11)
    n, d = 260, 12
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    parts = [ref.hnsw.HNSW(vecs, M=6, ef_con=40, seed=s).build(ids).pack()
             for s, ids in enumerate([range(0, 200), range(120, 260)])]
    n_max = 200
    ids = np.zeros((2, n_max), np.int32)
    lvl = np.full((2, n_max, parts[0]["level0"].shape[1]), -1, np.int32)
    ent = np.zeros(2, np.int32)
    for g, pk in enumerate(parts):
        ids[g, :len(pk["ids"])] = pk["ids"]
        lvl[g, :len(pk["level0"])] = pk["level0"]
        ent[g] = pk["entry"][0]
    gidx = np.asarray([0, 1, 0, 1, 1, 0], np.int32)
    queries = rng.standard_normal((6, d)).astype(np.float32)
    masks = rng.random((2, n)) < 0.6
    midx = np.asarray([0, 1, 1, 0, 1, 0], np.int32)
    return vecs, ids, lvl, ent, gidx, queries, masks, midx


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("filtered", [False, True])
def test_fused_beam_matches_reference(ref, graphs, metric, filtered):
    vecs, ids, lvl, ent, gidx, queries, masks, midx = graphs
    j = [ref.jnp.asarray(a) for a in graphs]
    t = [_t(a) for a in graphs]
    if filtered:
        jd, ji = ref.hnsw_jax.hnsw_search_fused_filtered(
            j[0], j[1], j[2], j[3], j[6], j[7], j[4], j[5], k=8, ef=24,
            metric=metric)
        td, ti = hnsw_torch.hnsw_search_fused_filtered(
            t[0], t[1], t[2], t[3], t[6], t[7], t[4], t[5], k=8, ef=24,
            metric=metric)
    else:
        jd, ji = ref.hnsw_jax.hnsw_search_fused(
            j[0], j[1], j[2], j[3], j[4], j[5], k=8, ef=24, metric=metric)
        td, ti = hnsw_torch.hnsw_search_fused(
            t[0], t[1], t[2], t[3], t[4], t[5], k=8, ef=24, metric=metric)
    _same(jd, ji, td, ti)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_beam_capacity_raise_in_both_packages(ref, graphs, pkg):
    fused = (ref.hnsw_jax.hnsw_search_fused if pkg == "ref"
             else hnsw_torch.hnsw_search_fused)
    conv = ref.jnp.asarray if pkg == "ref" else _t
    a = [conv(x) for x in graphs]
    with pytest.raises(ValueError, match="ef-list capacity"):
        fused(a[0], a[1], a[2], a[3], a[4], a[5], k=33, ef=32)


# --------------------------------------------------------------------- #
# H100 tile policy and wrapper contracts (no card needed)
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("d", [8, 100, 128, 4096])
@pytest.mark.parametrize("kqp", [8, 40, 128])
def test_sq8_tile_and_splits_h100_budget(kqp, d):
    """The SQ8 kernels' policy: a tile of eight 32×32 warp tiles whose
    columns fit the fold's u8 candidate slots, two blocks of it per SM
    within the H100's shared memory at any kqp (d is walked in chunks, so
    it does not change the footprint), and splits that keep ≥ 2 blocks
    per SM at N ≥ 10⁶, at most one per column tile, the partial lists
    under the cap."""
    bq, bn = ttune.SQ8_TILE
    dp = -(-d // 16) * 16
    assert dp <= ttune.SQ8_DIM_CAP
    assert bq % 32 == 0 and bn % 32 == 0 and bn <= 256
    assert (bq // 32) * (bn // 32) * 32 == ttune.THREADS
    assert ttune.sq8_smem_bytes(bq, bn, kqp) <= ttune.SMEM_BUDGET
    assert bq * (bn + 8) * 4 <= ttune.SQ8_CHUNK * (bq + bn)  # dist in a stage
    per_block = ttune.sq8_smem_bytes(bq, bn, kqp) \
        + ttune.SMEM_PER_BLOCK_RESERVED
    assert ttune.SM_SMEM // per_block >= 2       # two blocks per SM
    for q in (1, 100, 128, 1000):
        for segmented in (False, True):
            for n in (1000, 2_097_152):
                s = ttune.select_sq8_splits(q, n, bq, bn, k=kqp,
                                            segmented=segmented)
                assert 1 <= s <= max(-(-n // bn), 1) and s <= 65_535
                if n >= 10 ** 6:
                    assert -(-q // bq) * s >= 2 * ttune.SM_COUNT
                if segmented and s > ttune.select_splits(q, n, bq, bn):
                    assert q * s * kqp * 8 <= ttune.F32_PARTIAL_CAP


@pytest.mark.parametrize("k", [1, 16, 40, 128])
@pytest.mark.parametrize("q", [1, 100, 128, 1000])
def test_select_f32_tiles_h100_budget(q, k):
    """The fp32 kernels' policy (kernel A segmented, ``pairwise_f32`` at
    k = 0 unsegmented): an instantiated tile whose 256-thread grid divides
    it, within one block's shared memory (at least two blocks per SM on
    the wide tile), and ≥ 2 blocks per SM at N ≥ 10⁶; the segmented tile
    is the narrow one, and its partial lists stay under the cap."""
    for segmented in (False, True):
        kk = k if segmented else 0
        bq, bn = ttune.select_f32_tiles(q, segmented=segmented)
        tm, tn = ttune.F32_TILES[(bq, bn)]
        assert bq % tm == 0 and bn % tn == 0 and tm % 4 == 0 and tn % 4 == 0
        assert (bq // tm) * (bn // tn) == ttune.THREADS
        assert bq % 32 == 0 and bn % 32 == 0        # the stage swizzle
        assert ttune.f32_smem_bytes(bq, bn, kk) <= ttune.SMEM_BUDGET
        if (bq, bn) == ttune.F32_WIDE:
            assert ttune.f32_blocks_per_sm(bq, bn, kk) >= 2
            assert not segmented and q > 32
        if segmented:
            assert (bq, bn) == ttune.F32_NARROW
        for n in (1000, 2_097_152):
            s = ttune.select_f32_splits(q, n, bq, bn, k=kk,
                                        segmented=segmented)
            assert 1 <= s <= max(-(-n // bn), 1) and s <= 65_535
            if n >= 10 ** 6:
                assert -(-q // bq) * s >= 2 * ttune.SM_COUNT
            if segmented and s > ttune.select_splits(q, n, bq, bn):
                assert q * s * kk * 8 <= ttune.F32_PARTIAL_CAP
    pw = ttune.select_f32_tiles(q)
    assert ttune.f32_smem_bytes(*pw, 0) <= ttune.SMEM_BUDGET
    assert pw == (ttune.F32_NARROW if q <= 32 else ttune.F32_WIDE)


def test_wrappers_reject_other_devices_without_fallback():
    x = torch.zeros((4, 8), device="meta")
    seg = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdt.topk_seg_f32(x, x, seg, seg, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        tq.qtopk_seg_sq8(x.to(torch.int8), x.to(torch.int8), seg.float(),
                         seg.float(), seg.float(), seg.float(), seg, seg, 8)
    with pytest.raises(ValueError, match="outside the kernel"):
        tdt.topk_seg_f32(x, x, seg, seg, 129)
    with pytest.raises(ValueError, match="unsupported device"):
        tdt.distance_topk(x, x, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        tpw.pairwise_distance(x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        tq.quantized_topk(x.to(torch.int8), seg.float(), seg.float(),
                          x.to(torch.int8), seg.float(), seg.float(), 8)
    with pytest.raises(ValueError, match="outside the kernel"):
        tdt.distance_topk(x, x, 129)


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
@pytest.mark.parametrize("metric,accum,kp,n,d,dup", [
    ("l2", "f32", 16, 5000, 128, False), ("l2", "f32", 128, 3000, 64, False),
    ("ip", "f32", 24, 1037, 100, False), ("l2", "bf16", 16, 2000, 128,
                                          False),
    ("l2", "f32", 40, 900, 48, True)])
def test_gpu_topk_seg_f32_matches_plain(cuda, metric, accum, kp, n, d, dup):
    x, y, qseg, cseg = (_t(a, cuda) for a in
                        _seg_data(12, q=100, n=n, d=d, owners=4, dup=dup))
    before = tdt.topk_seg_f32.launches
    vk, ik = tdt.topk_seg_f32(x, y, qseg, cseg, kp, metric=metric,
                              accum=accum)
    torch.cuda.synchronize()
    assert tdt.topk_seg_f32.launches == before + 1
    vp, ip = tdt.segmented_dense_topk(x, y, qseg, cseg, kp, metric=metric,
                                      accum=accum)
    fin = torch.isfinite(vp)
    tol = 1e-4 * max(float(vp[fin].abs().max()), 1.0)
    _agree(vk, ik, vp, ip, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kqp,q,n,d", [
    (40, 100, 5000, 128), (128, 100, 3000, 64), (32, 100, 777, 100),
    (40, 100, 700, 4096), (8, 37, 1037, 8), (40, 129, 2049, 100),
    (128, 70, 999, 130), (8, 1, 300, 128)])
def test_gpu_qtopk_seg_sq8_bit_equal(cuda, kqp, q, n, d):
    x, y, qseg, cseg = _seg_data(13, q=q, n=n, d=d, owners=4)
    xq, sx, x2 = tq.quantize_sq8(_t(x, cuda))
    yq, sy, y2 = tq.quantize_sq8(_t(y, cuda))
    args = (xq, yq, sx[:, 0].contiguous(), x2[:, 0].contiguous(),
            sy[:, 0].contiguous(), y2[:, 0].contiguous(), _t(qseg, cuda),
            _t(cseg, cuda), kqp)
    before = tq.qtopk_seg_sq8.launches
    vk, ik = tq.qtopk_seg_sq8(*args)
    torch.cuda.synchronize()
    assert tq.qtopk_seg_sq8.launches == before + 1
    vp, ip = tq.sq8_dense_segmented(*args)
    assert torch.equal(vk, vp) and torch.equal(ik, ip)
