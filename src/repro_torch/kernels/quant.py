"""SQ8 quantized scan + fp32 rerank + exactness certificate.

Port of the descriptor half of ``src/repro/kernels/quant.py`` (the
default main-path scan, ``quantize="sq8"``).  Per-row symmetric int8
codes halve-to-quarter the bytes of the brute-force scan; an fp32 rerank
of the over-fetched top-kq and a per-query certificate make the result
provably equal to the fp32 scan's, and the executor escalates a batch
whose certificate fails (see the reference module docstring for the
bound |D − D̂| ≤ sx·sy·(‖x_q‖₁ + ‖y_q‖₁ + d/2)).

``qtopk_seg_sq8`` is the wrapper of kernel B (``csrc/qtopk_seg.cu``,
the port of the Pallas ``_qtopk_seg_kernel``), ``quantized_topk`` of its
unsegmented instantiation ``qtopk_sq8`` (the port of ``_qtopk_kernel``,
reached from ``topk_sq8_rerank``): on a CUDA tensor each launches the
hand-written kernel, on a CPU tensor it runs its plain PyTorch version
(``sq8_dense_segmented``, ``sq8_dense``); given the same inputs the two
are bit-identical.  The reranks and the certificate are plain PyTorch,
as they were XLA code in the reference.
"""

from __future__ import annotations

import torch

from . import _build
from .distance_topk import (_require, check_inputs, masked_topk, owner_sort,
                            resident_candidates, scan_buffers, stable_topk,
                            tile_counter)
from .tuning import SQ8_DIM_CAP, SQ8_TILE, select_sq8_splits

_INF = float("inf")

# Above this k the overfetch factor (128-lane scratch / k) drops below 2
# and the quantized scan stops paying for its rerank tail.
SQ8_MAX_K = 64


def sq8_supported(k: int, dim: int, metric: str = "l2") -> bool:
    """Eligibility gate for the SQ8 scan path: L2 only (the certificate
    is an L2 identity), dim within ``SQ8_DIM_CAP``, and k small enough
    that the 128-wide scratch still buys an overfetch factor ≥ 2."""
    return metric == "l2" and int(dim) <= SQ8_DIM_CAP and int(k) <= SQ8_MAX_K


def quantize_sq8(x: torch.Tensor):
    """Per-row symmetric int8: (codes int8, scale f32 (rows,1), squared
    norm f32 (rows,1) of the ORIGINAL rows).  True division and
    round-half-to-even, as ``jnp.round``, so codes equal the reference's
    bit for bit."""
    xf = x.float()
    scale = xf.abs().amax(1, keepdim=True) / 127.0 + 1e-12
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    sq = (xf * xf).sum(1, keepdim=True)
    return q, scale, sq


def quantize_sq8_ext(x: torch.Tensor):
    """``quantize_sq8`` plus the L1 norm of the codes (f32 (rows,1)) —
    the per-row term of the certificate; the resident quantized table."""
    q, scale, sq = quantize_sq8(x)
    l1 = q.to(torch.int32).abs().sum(1, keepdim=True).float()
    return q, scale, sq, l1


def _sq8_dist(xq, sx, x2, yq, sy, y2):
    """The dense (Q, N) quantized distances of ``qtopk_seg_sq8`` and
    ``qtopk_sq8``.  The int8 dot runs as an fp64 matmul of the codes —
    every partial sum is an integer below 2⁵³, so it is exact — then the
    kernels' association: ``cross = (float(dot)·sx)·sy``,
    ``dist = max((x2 + y2) − 2·cross, 0)``."""
    dot = (xq.double() @ yq.double().T).float()
    cross = (dot * sx.reshape(-1, 1)) * sy.reshape(1, -1)
    return ((x2.reshape(-1, 1) + y2.reshape(1, -1)) - 2.0 * cross
            ).clamp_min(0.0)


def sq8_dense_segmented(xq, yq, sx, x2, sy, y2, qseg, cseg, k: int):
    """Plain PyTorch version of kernel B: ``_sq8_dist`` under the owner
    mask.  ``sx``, ``x2`` (Q,), ``sy``, ``y2`` (N,).  Returns (Q, k)
    ascending quantized distances and flat columns, (+inf, -1)
    padding."""
    return masked_topk(_sq8_dist(xq, sx, x2, yq, sy, y2), qseg, cseg, k)


def sq8_dense(xq, sx, x2, yq, sy, y2, k: int):
    """Plain PyTorch version of ``qtopk_sq8``: ``_sq8_dist`` over every
    column, then the stable top-k."""
    return stable_topk(_sq8_dist(xq, sx, x2, yq, sy, y2), k)


def _pad_codes(xq, yq):
    """Zero-pad the code rows to a multiple of 16 bytes, as the kernels
    read them (16-byte copies from 16-byte aligned bases; a misaligned
    view is copied); zero codes add nothing to the dot."""
    d = xq.shape[1]
    dp = -(-d // 16) * 16
    if dp != d:
        xq = torch.nn.functional.pad(xq, (0, dp - d))
        yq = torch.nn.functional.pad(yq, (0, dp - d))
    xq, yq = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (xq, yq))
    return xq, yq, dp


def _sq8_launch(q: int, n: int, kqp: int, device, *, segmented: bool):
    """Tiles, N-splits and fresh buffers of one SQ8 split-N launch:
    ``(bq, bn, S, bound, flags, partial, vals, idx)``; ``bound`` (Q,)
    fp32 +inf is where the splits share each row's k-th distance."""
    bq, bn = SQ8_TILE
    s = select_sq8_splits(q, n, bq, bn, k=kqp, segmented=segmented)
    bound = torch.full((q,), _INF, dtype=torch.float32, device=device)
    return (bq, bn, s, bound, *scan_buffers(q, kqp, bq, s, device))


def qtopk_seg_sq8(xq, yq, sx, x2, sy, y2, qseg, cseg, kqp: int):
    """Kernel B: segmented int8 scan to the top-kqp quantized distances.
    ``xq`` (Q, d), ``yq`` (N, d) int8; ``sx``, ``x2`` (Q,), ``sy``, ``y2``
    (N,) fp32; ``qseg`` (Q,), ``cseg`` (N,) int32.  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/qtopk_seg.cu``
    (``launches`` counts those launches; rows sorted by owner, tile pairs
    whose owners cannot meet skipped, the computed ones counted in
    ``distance_topk.tile_stats("qtopk_seg_sq8")``) or raise — no
    fallback."""
    _require(1 <= kqp <= 128, f"kqp={kqp} outside the kernel's 1..128")
    if xq.device.type == "cpu":
        return sq8_dense_segmented(xq, yq, sx, x2, sy, y2, qseg, cseg, kqp)
    _require(xq.device.type == "cuda", f"unsupported device {xq.device}")
    q, d = xq.shape
    n = yq.shape[0]
    check_inputs(xq.device, (("xq", xq, torch.int8, (q, d)),
                             ("yq", yq, torch.int8, (n, d)),
                             ("sx", sx, torch.float32, (q,)),
                             ("x2", x2, torch.float32, (q,)),
                             ("sy", sy, torch.float32, (n,)),
                             ("y2", y2, torch.float32, (n,)),
                             ("qseg", qseg, torch.int32, (q,)),
                             ("cseg", cseg, torch.int32, (n,))))
    _require(q > 0 and n > 0 and 0 < d <= SQ8_DIM_CAP,
             f"unsupported scan shape ({q}, {n}, {d})")
    xq, yq, dp = _pad_codes(xq, yq)
    bq, bn, s, bound, flags, partial, vals, idx = _sq8_launch(
        q, n, kqp, xq.device, segmented=True)
    n_tiles, q_tiles = -(-n // bn), -(-q // bq)
    perm, ranges = owner_sort(qseg, q_tiles, n_tiles)
    counter = tile_counter("qtopk_seg_sq8", xq.device, q_tiles * n_tiles)
    lib = _build.library()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    _build.check("qtopk_seg_sq8", lib.qtopk_seg_sq8(
        xq.data_ptr(), yq.data_ptr(), sx.data_ptr(), x2.data_ptr(),
        sy.data_ptr(), y2.data_ptr(), qseg.data_ptr(), cseg.data_ptr(),
        perm.data_ptr(), ranges.data_ptr(), flags.data_ptr(),
        counter.data_ptr(), bound.data_ptr(), q, n, dp, kqp, bq, bn, s,
        partial.data_ptr(), vals.data_ptr(), idx.data_ptr(), stream))
    qtopk_seg_sq8.launches += 1
    return vals, idx


qtopk_seg_sq8.launches = 0


def quantized_topk(xq, sx, x2, yq, sy, y2, kqp: int):
    """``qtopk_sq8``: int8 scan of every query row against every code row
    to the top-kqp quantized distances (argument order of the
    reference's ``quantized_topk``).  ``xq`` (Q, d), ``yq`` (N, d) int8;
    ``sx``, ``x2`` (Q,), ``sy``, ``y2`` (N,) fp32.  Ragged N is masked in
    the kernel, so nothing is padded but the code width.  CPU tensors
    take the plain version ``sq8_dense``; CUDA tensors launch
    ``csrc/qtopk_seg.cu``'s unsegmented entry (``launches`` counts those
    launches) or raise — no fallback."""
    _require(1 <= kqp <= 128, f"kqp={kqp} outside the kernel's 1..128")
    if xq.device.type == "cpu":
        return sq8_dense(xq, sx, x2, yq, sy, y2, kqp)
    _require(xq.device.type == "cuda", f"unsupported device {xq.device}")
    q, d = xq.shape
    n = yq.shape[0]
    check_inputs(xq.device, (("xq", xq, torch.int8, (q, d)),
                             ("sx", sx, torch.float32, (q,)),
                             ("x2", x2, torch.float32, (q,)),
                             ("yq", yq, torch.int8, (n, d)),
                             ("sy", sy, torch.float32, (n,)),
                             ("y2", y2, torch.float32, (n,))))
    _require(q > 0 and n > 0 and 0 < d <= SQ8_DIM_CAP,
             f"unsupported scan shape ({q}, {n}, {d})")
    xq, yq, dp = _pad_codes(xq, yq)
    bq, bn, s, bound, flags, partial, vals, idx = _sq8_launch(
        q, n, kqp, xq.device, segmented=False)
    lib = _build.library()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    _build.check("qtopk_sq8", lib.qtopk_sq8(
        xq.data_ptr(), yq.data_ptr(), sx.data_ptr(), x2.data_ptr(),
        sy.data_ptr(), y2.data_ptr(), flags.data_ptr(), bound.data_ptr(), q,
        n, dp, kqp, bq, bn, s, partial.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), stream))
    quantized_topk.launches += 1
    return vals, idx


quantized_topk.launches = 0


def _check_overfetch(k: int, overfetch: int) -> int:
    """kq = k·overfetch (at least k); raises past the 128-wide scratch."""
    kq = max(k * overfetch, k)
    if kq > 128:
        raise ValueError(
            f"k*overfetch={kq} exceeds the quantized kernel's 128-lane "
            f"scratch budget (k={k}, overfetch={overfetch}); lower k or "
            f"overfetch (the executor clamps overfetch to 128//k)")
    return kq


def topk_sq8_rerank(x: torch.Tensor, y: torch.Tensor, k: int, *,
                    overfetch: int = 4):
    """Top-k at int8 scan bandwidth: the quantized top-(k·overfetch) of
    every row of ``y`` (``quantized_topk``), then an exact fp32 rerank of
    those candidates only, in difference form Σ(y − x)² as the
    reference's ``topk_sq8_rerank``, and a stable top-k.  Both sides are
    quantized on every call, as in the reference.  Returns (Q, k)
    ascending distances and int32 row indices; (+inf, -1) where ``y`` has
    fewer than k rows.  ``k·overfetch > 128`` raises."""
    n = y.shape[0]
    kq = _check_overfetch(k, overfetch)
    xq, sx, x2 = quantize_sq8(x)
    yq, sy, y2 = quantize_sq8(y)
    kqp = min(-(-kq // 8) * 8, 128)
    _, idx = quantized_topk(xq, sx[:, 0], x2[:, 0], yq, sy[:, 0], y2[:, 0],
                            kqp)
    idx = idx[:, :kq].long()
    cand = y[idx.clamp(0, n - 1)].float()               # (Q, kq, d)
    diff = cand - x.float()[:, None, :]
    d2 = torch.where(idx >= 0, (diff * diff).sum(-1), _INF)
    pos = torch.argsort(d2, dim=1, stable=True)[:, :k]
    return d2.gather(1, pos), idx.gather(1, pos).to(torch.int32)


def owner_max(own: torch.Tensor, vals: torch.Tensor, n_owners: int):
    """Per owner, the max of ``vals`` (N, C) fp32, all ≥ 0, over the
    entries that ``own`` (N,) int64 in [0, n_owners) assigns it, and 0
    for an owner with none: bit-equal to ``zeros(n_owners,
    C).scatter_reduce(0, own, vals, "amax")`` (the reference's
    ``.at[own].max``), since a max is exact in any order.  That scatter
    sends all N entries to ≤ n_owners addresses, so on the card its
    atomics serialise.  Here entry i goes to the partial max of (block
    i // B, owner), so no address takes more than B entries, then a
    reduction over the blocks.  Non-negative floats order as their bits,
    so the partial maxima are int32 maxima of the bits (native integer
    atomics instead of compare-and-swap loops)."""
    n, c = vals.shape
    block = max(256, -(-n * n_owners // (1 << 22)))   # ≤ 4M partials
    slot = (torch.arange(n, device=own.device) // block) * n_owners + own
    part = torch.zeros((-(-n // block) * n_owners, c), dtype=torch.int32,
                       device=own.device)
    part.scatter_reduce_(0, slot[:, None].expand(n, c),
                         vals.contiguous().view(torch.int32), "amax")
    return part.view(-1, n_owners, c).amax(0).view(torch.float32)


def _sq8_topk_descriptors(vectors, vq, vsc, vsq, vl1, base_ids, deleted, x,
                          qseg, starts, lens, owners, tail_res_ids,
                          tail_res_owners, tail_ship_ids, tail_ship_owners,
                          tail_ship_rows, k: int, kq: int, *, n_desc: int):
    """Descriptor-resolved SQ8 scan (kernel B) + fp32 rerank +
    certificate, the port of the reference's ``_sq8_topk_descriptors``.
    Candidate codes come from the resident quantized table ``(vq, vsc,
    vsq, vl1)``; only the shipped tail is quantized per call.  ``qseg``
    is (Q, 1).  Returns ``(vals, gids, cert)``: exact reranked distances,
    global ids, and a per-query bool that is True iff the result provably
    equals the fp32 scan's."""
    cand_res, own_res = resident_candidates(
        base_ids, deleted, starts, lens, owners, tail_res_ids,
        tail_res_owners, n_desc)
    n_res = int(cand_res.shape[0])
    ts = int(tail_ship_rows.shape[0])

    yq_p, sy_p, y2_p, l1_p = [], [], [], []
    if n_res:
        ci = cand_res.long()
        yq_p.append(vq[ci])
        sy_p.append(vsc[ci])
        y2_p.append(vsq[ci])
        l1_p.append(vl1[ci])
    if ts:
        sq, ssc, ssq, sl1 = quantize_sq8_ext(tail_ship_rows)
        yq_p.append(sq)
        sy_p.append(ssc)
        y2_p.append(ssq)
        l1_p.append(sl1)
    yq, sy, y2, yl1 = (torch.cat(p, 0) for p in (yq_p, sy_p, y2_p, l1_p))
    cseg = torch.cat([own_res, tail_ship_owners.to(torch.int32)])
    gid_flat = torch.cat([cand_res, tail_ship_ids.to(torch.int32)])
    n = n_res + ts
    qp, d = x.shape

    # --- int8 segmented scan: top-kq by quantized distance -------------
    xq, sx, x2, xl1 = quantize_sq8_ext(x)
    vals_q, idx = qtopk_seg_sq8(
        xq.contiguous(), yq.contiguous(), sx[:, 0].contiguous(),
        x2[:, 0].contiguous(), sy[:, 0].contiguous(), y2[:, 0].contiguous(),
        qseg[:, 0].contiguous(), cseg.contiguous(), kq)

    # --- exact fp32 rerank: gather only the (Q, kq, d) candidate rows --
    idx = idx.long()
    idxc = idx.clamp(0, n - 1)
    rowi = gid_flat.long()[idxc]             # resident gid == vectors row
    if n_res and ts:
        nv = max(int(vectors.shape[0]), 1)
        from_res = vectors[rowi.clamp(0, nv - 1)]
        from_ship = tail_ship_rows[(idxc - n_res).clamp(0, ts - 1)]
        cand = torch.where((idxc < n_res)[..., None], from_res, from_ship)
    elif ts:
        cand = tail_ship_rows[idxc]
    else:
        cand = vectors[rowi]
    xf = x.float()
    candf = cand.float()
    # GEMM form, as the fp32 scan, so certified results are
    # numerically interchangeable with it
    xy = torch.bmm(candf, xf[:, :, None])[..., 0]
    c2 = (candf * candf).sum(-1)
    x2r = (xf * xf).sum(-1, keepdim=True)
    d2 = (x2r + c2 - 2.0 * xy).clamp_min(0.0)
    d2 = torch.where(idx >= 0, d2, _INF)
    pos = torch.argsort(d2, dim=1, stable=True)[:, :k]
    fidx = idx.gather(1, pos)
    gids = torch.where(fidx >= 0, gid_flat.long()[fidx.clamp(0, n - 1)], -1)
    vals = torch.where(fidx >= 0, d2.gather(1, pos), _INF)

    # --- certificate: can any excluded candidate beat the top-k? -------
    live = cseg >= 0
    own = cseg.long().clamp(0, qp - 1)      # indexed by OWNER, not row
    u = torch.where(live, sy[:, 0], 0.0)
    t = torch.where(live, sy[:, 0] * (yl1[:, 0] + d / 2.0), 0.0)
    umax, tmax = owner_max(own, torch.stack([u, t], 1), qp).unbind(1)
    oq = qseg[:, 0].long().clamp(0, qp - 1)
    eps = sx[:, 0] * (xl1[:, 0] * umax[oq] + tmax[oq])
    qkq = vals_q[:, -1]                      # kq-th kept quantized dist
    dk = vals[:, k - 1]                      # k-th exact reranked dist
    # margin absorbs f32 rounding of the quantized estimate; a NaN or a
    # clamped-to-zero q_kq fails the comparison and escalates safely
    margin = eps + 1e-5 * (qkq.abs() + dk.abs()) + 1e-12
    cert = torch.isposinf(qkq) | (dk < qkq - margin)
    return vals, gids.to(torch.int32), cert


def topk_sq8_segmented_desc(vectors, quant, base_ids, deleted, x, qseg,
                            desc_starts, desc_lens, desc_owners,
                            tail_res_ids, tail_res_owners, tail_ship_ids,
                            tail_ship_rows, tail_ship_owners, k: int, *,
                            overfetch: int = 4):
    """Batched SQ8 executor path: ONE segmented quantized launch for every
    scan item in the batch.  ``quant`` is the resident int8 table ``(vq,
    vsc, vsq, vl1)``; same descriptor/tail contract and shape bucketing
    as ``ops.topk_segmented_desc``; ``k·overfetch > 128`` raises.
    Returns ``(vals, gids, cert)`` on the table's device."""
    from .ops import _round_up, pad_descriptor_batch, record_launch
    q = x.shape[0]
    kq = _check_overfetch(k, overfetch)
    args, key = pad_descriptor_batch(
        x, qseg, desc_starts, desc_lens, desc_owners, tail_res_ids,
        tail_res_owners, tail_ship_ids, tail_ship_rows, tail_ship_owners,
        device=vectors.device)
    kqp = min(_round_up(kq, 8), 128)
    vq, vsc, vsq, vl1 = quant
    vals, gids, cert = _sq8_topk_descriptors(
        vectors, vq, vsc, vsq, vl1, base_ids, deleted, *args, k, kqp,
        n_desc=key[1])
    record_launch("sq8_scan", key + (k, kqp))
    vals, gids, cert = vals[:q], gids[:q], cert[:q]
    bad = (gids < 0) | ~torch.isfinite(vals)
    return (torch.where(bad, _INF, vals), torch.where(bad, -1, gids),
            cert)


__all__ = ["SQ8_MAX_K", "sq8_supported", "quantize_sq8", "quantize_sq8_ext",
           "qtopk_seg_sq8", "sq8_dense_segmented", "quantized_topk",
           "sq8_dense", "topk_sq8_rerank", "topk_sq8_segmented_desc",
           "owner_max"]
