"""Shared transformer building blocks — port of
``src/repro/models/layers.py`` in plain PyTorch.

Conventions (the reference's, kept so the two compare like with like)
---------------------------------------------------------------------
* Activations (B, S, d); attention heads grouped GQA-style: q is
  (B, S, G, R, hd) in decode, with G = kv heads, R = H/G query heads per
  group.
* Parameters keep the reference's per-layer shapes: ``wq`` (d, H, hd),
  ``wk``/``wv`` (d, G, hd), ``wo`` (H, hd, d), MLP weights (d, f) and
  (f, d).  A layer's parameters are any mapping of name to tensor (a
  plain dict in the tests, a ``ParamTree`` inside the models).
* Numerics follow the reference's ``preferred_element_type`` line by
  line.  Where the reference keeps an fp32 product (q/k/v and the MLP's
  gate and up in prefill, attention scores, logits), the port computes
  it with fp32 accumulation and an fp32 result (``mm_f32``); where it
  casts straight back to the activation dtype, the port multiplies in
  the activation dtype (fp32 accumulation inside the GEMM).  In decode
  (S == 1) the reference accumulates in the activation dtype; so does
  the port.  Norms, softmax and rope run in fp32.
* The reference's ``actctx.shard`` pins stand where the reference has
  them (``distributed/actctx.py``): without a configured mesh they
  return their input; under the data-parallel train step they check
  that an activation is its shard's.
* Training runs the same functions under autograd.  Where the reference
  wraps a body in ``jax.checkpoint``, the port wraps it in ``remat``
  (``torch.utils.checkpoint``, non-reentrant): its activations are
  recomputed in the backward pass instead of saved.
"""

from __future__ import annotations

import math
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed import actctx

f32 = torch.float32
MASK_VALUE = -1e30             # the reference's mask value, not -inf
INT32_MAX = 2 ** 31 - 1


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------- #
# products
# --------------------------------------------------------------------- #

class _MmF32(torch.autograd.Function):
    """One GEMM of two bf16/fp16 operands on the card with an fp32
    output.  ``aten::mm.dtype`` has no derivative (torch 2.11), so the
    backward is written here: each gradient is the same kind of GEMM (operands in
    the operand dtype, fp32 accumulation), rounded once to its
    operand's dtype.  The incoming fp32 cotangent is rounded to the
    operand dtype first; the reference's transposed dot multiplies it
    in fp32 (a difference within the final rounding)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=f32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g, b.t(), out_dtype=f32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a.t(), g, out_dtype=f32).to(b.dtype)
        return ga, gb


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) × (K, N) with fp32 accumulation and an fp32 result — the
    reference's ``preferred_element_type=f32`` kept in fp32.  bf16/fp16
    operands on the card go through one GEMM with an fp32 output
    (``out_dtype``, differentiable through ``_MmF32``); on the CPU they
    are widened first (each product of two bf16 values is exact in fp32,
    so both give the same sum up to its order)."""
    if a.dtype == f32 and b.dtype == f32:
        return a @ b
    if a.is_cuda and a.dtype == b.dtype:
        return _MmF32.apply(a, b)
    return a.to(f32) @ b.to(f32)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass —
    the reference's ``jax.checkpoint``.  Without autograd (serving,
    ``inference_mode``) it is a plain call."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def contract(x: torch.Tensor, w: torch.Tensor, keep_f32: bool, k: int = 1
             ) -> torch.Tensor:
    """Contract the last axis of ``x`` (..., d) with the first ``k`` axes
    of ``w`` (d = their product; (*lead, *rest)) -> (..., *rest).
    ``keep_f32``: the product stays fp32 (``mm_f32``); else it is in
    ``x``'s dtype.  A data shard of a weight in a weight-stationary
    decode multiplies where it lies (``over_data``)."""
    if not actctx.stationary():
        return _contract(x, w, keep_f32, k)
    return over_data(x, w, lambda x, w, keep: _contract(x, w, keep, k),
                     keep_f32)


def _contract(x, w, keep_f32: bool, k: int):
    lead, d = x.shape[:-1], x.shape[-1]
    rest = w.shape[k:]
    x2, w2 = x.reshape(-1, d), w.reshape(d, -1)
    out = mm_f32(x2, w2) if keep_f32 else x2 @ w2.to(x.dtype)
    return out.reshape(*lead, *rest)


def _data_column(w):
    """(the axis ``w`` is cut along over ``data``, the data shards of
    its column), where ``w`` is one slot's shard of a weight cut over
    ``data`` in a weight-stationary decode (``actctx.stationary``); else
    None.  The column is the running TP rank's where ``w`` lies in it
    (a leaf the model axis does not cut is one tensor a device, shared
    by the ranks there), else ``w``'s own."""
    if not actctx.stationary():
        return None
    from ..distributed import fsdp
    g = fsdp.group(w)
    if g is None or g.dim is None:
        return None
    shards = g.shards
    t = g.shape[1]
    at = next(s for s, sh in enumerate(shards) if sh is w)
    j = actctx.running_rank()
    if shards[at - at % t + j] is not w:
        j = at % t
    return g.dim, g.column(j)


def over_data(x: torch.Tensor, w: torch.Tensor, fn, keep_f32: bool,
              w_axis: int = 0) -> torch.Tensor:
    """``fn(x, w, keep_f32)`` — a product that contracts the last axis of
    ``x`` with axis ``w_axis`` of ``w``, fp32 where ``keep_f32``, else in
    ``x``'s dtype — where ``w`` may be one slot's shard of a weight cut
    over ``data`` in a weight-stationary decode (the reference's decode
    layout: the weights stay cut over both axes, the activations are
    replicated over ``data``).  Each data shard of the column computes on
    its own device.  Where the shards cut the contracted axis, shard i
    multiplies its chunk of ``x``'s last axis into an fp32 partial and
    the partials are summed once on ``x``'s device (``tp.fold_to``, data
    row 0 first), then cast unless ``keep_f32``: one rounding, as one
    device's product.  Where they cut the output's last axis, each shard
    gives its slice of it, joined on ``x``'s device (``tp.gather_to``).  Anything else:
    ``fn(x, w, keep_f32)``."""
    col = _data_column(w)
    if col is None:
        return fn(x, w, keep_f32)
    from ..distributed import tp
    dim, shards = col

    def each(one):          # one(i, shard) on every data shard
        return tp.fan_out(range(len(shards)), lambda i: one(i, shards[i]),
                          lambda i: actctx.live(shards[i].device))
    if dim == w_axis:
        n = x.shape[-1] // len(shards)
        total = tp.fold_to(each(lambda i, sh: fn(
            x.narrow(-1, i * n, n).to(sh.device), sh, True)), x.device)
        return total if keep_f32 else total.to(x.dtype)
    if dim != w.dim() - 1:
        raise ValueError(f"a weight cut over data along axis {dim} of "
                         f"{w.dim()}, which the product neither contracts "
                         "nor keeps last")
    return tp.gather_to(each(lambda i, sh: fn(x.to(sh.device), sh,
                                              keep_f32)), -1, [x.device])[0]


# --------------------------------------------------------------------- #
# norms / activations / rope
# --------------------------------------------------------------------- #

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(f32))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(f32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * (1.0 + scale.to(f32)) \
        + bias.to(f32)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (PyTorch's default is the
    exact erf form)."""
    return F.gelu(x, approximate="tanh")


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, ..., hd) with positions (B, S)."""
    hd = x.shape[-1]
    freqs = torch.tensor(rope_frequencies(hd, theta), dtype=f32,
                         device=x.device)
    angles = positions.to(f32)[..., None] * freqs              # (B, S, hd/2)
    while angles.dim() < x.dim():
        angles = angles[..., None, :]                           # head axes
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# initialisation: the reference's distributions from a torch.Generator
# --------------------------------------------------------------------- #

def normal(gen: torch.Generator, shape, dtype: torch.dtype,
           scale: float = 0.02) -> torch.Tensor:
    """N(0, scale²) drawn in fp32 on the generator's device, cast to
    ``dtype``."""
    return (torch.randn(shape, generator=gen, dtype=f32,
                        device=gen.device) * scale).to(dtype)


def init_attention(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, qk_norm: bool,
                   dtype: torch.dtype) -> dict:
    p = {
        "wq": normal(gen, (d_model, num_heads, head_dim), dtype),
        "wk": normal(gen, (d_model, num_kv_heads, head_dim), dtype),
        "wv": normal(gen, (d_model, num_kv_heads, head_dim), dtype),
        "wo": normal(gen, (num_heads, head_dim, d_model), dtype),
    }
    if qk_norm:
        p["q_norm"] = torch.zeros(head_dim, dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros(head_dim, dtype=dtype, device=gen.device)
    return p


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype: torch.dtype) -> dict:
    if act == "swiglu":
        return {"w_gate": normal(gen, (d_model, d_ff), dtype),
                "w_up": normal(gen, (d_model, d_ff), dtype),
                "w_down": normal(gen, (d_ff, d_model), dtype)}
    return {"w_in": normal(gen, (d_model, d_ff), dtype),
            "w_out": normal(gen, (d_ff, d_model), dtype)}


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype: torch.dtype) -> torch.Tensor:
    return normal(gen, (vocab, d_model), dtype)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #

def _expand_kv(kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, G, hd) -> (B, T, H, hd) by repeating each kv head H/G
    times."""
    b, t, g, hd = kv.shape
    rep = num_heads // g
    return kv[:, :, :, None, :].expand(b, t, g, rep, hd).reshape(
        b, t, num_heads, hd)


Q_CHUNK = 512  # query-block size: scores never exceed (B, H, Q_CHUNK, T)


def _window_mask(q_pos: torch.Tensor, t_pos: torch.Tensor, window: int
                 ) -> torch.Tensor:
    """(q_pos - t_pos) < window, where window 0 means no window."""
    win = INT32_MAX if window == 0 else int(window)
    return (q_pos[..., None] - t_pos) < win


def _attend_block(qb, kh, vh, qp, t_pos, window: int, causal: bool, dtype):
    """One query block against full K/V.  qb: (B,qc,H,hd) in the compute
    dtype; kh/vh: (B,T,H,hd); qp: (B,qc).  Returns ctx (B,qc,H,hd) in
    ``dtype`` (the reference's fp32 context, rounded as its caller
    does)."""
    hd = qb.shape[-1]
    scores = torch.einsum("bshk,bthk->bhst", qb.to(f32),
                          kh.to(f32)) / math.sqrt(hd)
    if causal:
        mask = t_pos[None, None, :] <= qp[:, :, None]           # (B,qc,T)
    else:
        mask = torch.ones(qp.shape + (t_pos.shape[0],), dtype=torch.bool,
                          device=qb.device)
    mask = mask & _window_mask(qp, t_pos, window)
    scores = scores.masked_fill(~mask[:, None, :, :], MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhst,bthk->bshk", probs, vh.to(dtype))


def attention(params: Mapping, x: torch.Tensor, *,
              positions: torch.Tensor, window: int, num_kv_heads: int,
              rope: bool, rope_theta: float, norm_eps: float,
              cache: Optional[dict] = None, cache_pos: Optional[int] = None,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              causal: bool = True, num_heads: Optional[int] = None,
              head_offset: int = 0) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA attention (``params``: the layer's weights; the reference's
    ``params`` pytree becomes any mapping of tensors).

    Train/prefill (S > 1): query-blocked attention over the fresh local
    K/V — scores never materialise beyond (B, H, Q_CHUNK, T).

    Decode (S == 1) with a cache: grouped GQA straight against the full
    ``max_len`` cache, masked by position.

    Cross-attention: ``kv_override`` supplies fixed (k, v); causal=False.

    ``cache`` ({"k", "v"}: (B, max_len, G, hd)) is written IN PLACE at
    ``cache_pos`` and returned; the reference returns an updated copy,
    and silently clamps a write that would run past ``max_len``
    (``dynamic_update_slice``), overwriting earlier entries — the port
    raises ``ValueError`` instead.  ``window`` is this layer's integer
    window (0 = full).  Returns (output (B,S,d), cache or None).

    Tensor parallelism: ``params["wq"]`` / ``["wo"]`` may hold a TP
    rank's heads, global heads ``head_offset`` … of ``num_heads``; the
    rank takes the kv heads its query heads map to under the global GQA
    grouping (head h ↦ h // (num_heads / G)), slicing the whole
    ``wk``/``wv`` (or ``kv_override``) for the compute only, and the
    output is the rank's row-parallel partial of the sum over heads, in
    fp32 (``mlp``'s ``partial``).  With a cache (in prefill, the rank's
    whole copy of a sequence the mesh does not cut) the rank writes every
    kv head and attends with its own; decode over a mesh is
    ``attention_mesh_decode``'s.
    """
    b, s, d = x.shape
    wide = s > 1        # decode accumulates in the activation dtype
    q = contract(x, params["wq"], wide).to(f32)
    local = params["wq"].shape[-2]
    heads = local if num_heads is None else num_heads
    part = local != heads   # a TP rank's partial: kept fp32 (``partial``)
    kv_idx = None
    if local != heads:
        rep = heads // num_kv_heads
        lo = head_offset // rep
        hi = (head_offset + local - 1) // rep + 1
        kv_idx = (torch.arange(local, device=x.device) + head_offset
                  ) // rep - lo
    if kv_override is None:
        wk, wv = params["wk"], params["wv"]
        if kv_idx is not None and cache is None:
            # only the kv heads this rank's queries read; a cache takes all
            wk, wv = wk[..., lo:hi, :], wv[..., lo:hi, :]
        k = contract(x, wk, wide).to(f32)
        v = contract(x, wv, wide).to(f32)
    else:
        k, v = kv_override
        if kv_idx is not None:
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = (rms_norm(k, params["k_norm"], norm_eps)
             if kv_override is None else k)
    if rope and kv_override is None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    new_cache = None
    if cache is not None:
        start, max_len = int(cache_pos), cache["k"].shape[1]
        if start < 0 or start + s > max_len:
            raise ValueError(
                f"cache overflow: writing {s} positions at {start} into a "
                f"cache of max_len {max_len}")
        k = k.to(cache["k"].dtype)
        v = v.to(cache["v"].dtype)
        cache["k"][:, start:start + s] = k
        cache["v"][:, start:start + s] = v
        new_cache = cache
        if s == 1:
            k, v = cache["k"], cache["v"]   # decode attends over the cache
        # prefill keeps the fresh local k/v (the cache was empty before)
        if kv_idx is not None:
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]

    hd = q.shape[-1]
    num_heads = q.shape[2]

    if s == 1 and cache is not None:
        g = k.shape[2]                      # a TP rank's: its kv heads
        r = num_heads // g
        qg = q.to(x.dtype).reshape(b, 1, g, r, hd)
        scores = torch.einsum("bsgrk,btgk->bgrst", qg.to(f32),
                              k.to(x.dtype).to(f32)) / math.sqrt(hd)
        t_pos = torch.arange(k.shape[1], device=x.device)
        pos0 = positions[:, 0]
        mask = (t_pos[None, :] <= pos0[:, None]) \
            & _window_mask(pos0, t_pos, window)                 # (B,T)
        scores = scores.masked_fill(~mask[:, None, None, None, :],
                                    MASK_VALUE)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bgrst,btgk->bsgrk", probs, v.to(x.dtype))
        ctx = ctx.reshape(b, 1, num_heads, hd).to(x.dtype)
        out = contract(ctx.reshape(b, 1, num_heads * hd), params["wo"],
                       part, k=2)
        return out if part else out.to(x.dtype), new_cache

    if kv_idx is None:
        kh = _expand_kv(k, num_heads).to(x.dtype)              # (B,T,H,hd)
        vh = _expand_kv(v, num_heads).to(x.dtype)
    else:
        kh = k.index_select(2, kv_idx).to(x.dtype)
        vh = v.index_select(2, kv_idx).to(x.dtype)
    qc = actctx.shard(q.to(x.dtype), "bthd", size=heads)
    t_pos = torch.arange(kh.shape[1], device=x.device)
    if s <= Q_CHUNK:
        ctx = _attend_block(qc, kh, vh, positions, t_pos, window, causal,
                            x.dtype)
    else:
        # each query block is recomputed in backward, as the
        # reference's checkpointed scan body is
        ctx = torch.cat([
            remat(_attend_block, qc[:, i:i + Q_CHUNK], kh, vh,
                  positions[:, i:i + Q_CHUNK], t_pos, window, causal,
                  x.dtype)
            for i in range(0, s, Q_CHUNK)], dim=1)
    ctx = ctx.to(x.dtype)
    out = contract(ctx.reshape(b, s, num_heads * hd), params["wo"], part,
                   k=2)
    return out if part else out.to(x.dtype), new_cache


# --------------------------------------------------------------------- #
# attention over a cache laid out over the slots (serving on a mesh)
# --------------------------------------------------------------------- #

class SeqKV(NamedTuple):
    """One layer's K/V cache as a data row sees it on a mesh: ``k`` /
    ``v`` the pieces (B, S_p, G, hd), in sequence order, of the ranks
    that hold its sequence (``spread``); or, where the spec leaves the
    sequence whole, one whole copy a TP rank (``spread`` False)."""
    k: List[torch.Tensor]
    v: List[torch.Tensor]
    spread: bool

    def offsets(self) -> List[int]:
        if not self.spread:
            return [0] * len(self.k)
        return np.cumsum([0] + [k.shape[1] for k in self.k[:-1]]).tolist()

    def length(self) -> int:
        return (sum(k.shape[1] for k in self.k) if self.spread
                else self.k[0].shape[1])


def cache_kv(params: Mapping, x: torch.Tensor, *, positions: torch.Tensor,
             rope: bool, rope_theta: float, norm_eps: float,
             dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K/V of every kv head that ``attention`` caches for ``x``
    (after ``k_norm`` and rope), cast to the cache's ``dtype``."""
    wide = x.shape[1] > 1
    k = contract(x, params["wk"], wide).to(f32)
    v = contract(x, params["wv"], wide).to(f32)
    if "k_norm" in params:
        k = rms_norm(k, params["k_norm"], norm_eps)
    if rope:
        k = apply_rope(k, positions, rope_theta)
    return k.to(dtype), v.to(dtype)


def write_kv(kv: SeqKV, k: torch.Tensor, v: torch.Tensor, start: int
             ) -> None:
    """Write ``k``/``v`` (B, s, G, hd) at positions ``start`` … into the
    pieces that hold them (every distinct copy where the sequence is not
    cut), in place.  A write past the cache raises ``ValueError``, as
    ``attention``'s does."""
    s = k.shape[1]
    total = kv.length()
    if start < 0 or start + s > total:
        raise ValueError(f"cache overflow: writing {s} positions at {start} "
                         f"into a cache of max_len {total}")
    seen = set()
    for kp, vp, off in zip(kv.k, kv.v, kv.offsets()):
        if id(kp) in seen:
            continue
        seen.add(id(kp))
        lo, hi = max(start, off), min(start + s, off + kp.shape[1])
        if lo < hi:
            kp[:, lo - off:hi - off] = k[:, lo - start:hi - start].to(
                kp.device, kp.dtype)
            vp[:, lo - off:hi - off] = v[:, lo - start:hi - start].to(
                vp.device, vp.dtype)


def _attend_spread(qs, ks, vs, offsets, positions, window: int,
                   causal: bool, dtype, device) -> torch.Tensor:
    """Grouped decode attention whose keys lie on several ranks: rank p
    holds ``qs[p]`` (B, 1, G', R', hd), its copy of the queries, and
    ``ks[p]`` / ``vs[p]`` (B, S_p, G', hd), the positions ``offsets[p]``
    … of the sequence.  Each rank scores its positions (masked by their
    global position: causal, the window); the max and the sum of
    exponentials are reduced over the ranks in fp32; each rank forms its
    probabilities in ``dtype`` (the reference's rounding) and its fp32
    partial of the context, and the partials are summed on ``device``,
    rank 0 first, and cast once.  Returns (B, 1, G', R', hd)."""
    from ..distributed import tp
    hd = qs[0].shape[-1]

    def score(p):
        dev = ks[p].device
        sc = torch.einsum("bsgrk,btgk->bgrst", qs[p].to(f32),
                          ks[p].to(dtype).to(f32)) / math.sqrt(hd)
        t_pos = offsets[p] + torch.arange(ks[p].shape[1], device=dev)
        pos0 = positions[:, 0].to(dev)
        mask = _window_mask(pos0, t_pos, window)               # (B,T)
        if causal:
            mask = mask & (t_pos[None, :] <= pos0[:, None])
        return sc.masked_fill(~mask[:, None, None, None, :], MASK_VALUE)

    def each(fn):           # fn(p) on every rank (``tp.fan_out``)
        return tp.fan_out(range(len(ks)), fn,
                          lambda p: actctx.live(ks[p].device))
    scores = each(score)
    tops = tp.max_over_ranks(each(lambda p: scores[p].amax(-1,
                                                          keepdim=True)))
    exps = each(lambda p: torch.exp(scores[p] - tops[p]))
    sums = tp.sum_over_ranks(each(lambda p: exps[p].sum(-1, keepdim=True)))
    parts = each(lambda p: torch.einsum(
        "bgrst,btgk->bsgrk", (exps[p] / sums[p]).to(dtype).to(f32),
        vs[p].to(dtype).to(f32)))
    return tp.fold_to(parts, device).to(dtype)


class MeshKV(NamedTuple):
    """One layer's K/V cache as a weight-stationary decode sees it over
    the whole mesh (``fsdp.MeshCache.kv``): one group a distinct slice of
    the batch — its ``rows``, the pieces it attends over (``reads``, a
    ``SeqKV`` in sequence order: the data row's TP ranks, every slot of a
    sequence spread over ``(data, model)``, or the one whole copy of the
    row's rank 0), and every copy its K/V are written into (``writes``:
    each data row that holds those rows)."""
    rows: List[slice]
    reads: List[SeqKV]
    writes: List[List[SeqKV]]


def attention_mesh_decode(params: Sequence[Mapping],
                          xs: Sequence[torch.Tensor], kv: MeshKV, *,
                          positions: torch.Tensor, window: int,
                          num_heads: int, num_kv_heads: int, rope: bool,
                          rope_theta: float, norm_eps: float,
                          causal: bool = True,
                          cache_pos: Optional[int] = None
                          ) -> List[torch.Tensor]:
    """Decode (S == 1) attention of the TP ranks of a weight-stationary
    decode over the mesh's cache: rank j holds ``params[j]`` (its heads
    of ``wq`` / ``wo``; ``wk`` / ``wv`` whole over ``model``; every leaf
    one data row's cut, used where it lies: ``contract``) and ``xs[j]``,
    its copy of the normed input of the whole batch (B, 1, d).  Each
    rank's query heads are projected for every sequence (the partials of
    the data shards summed in fp32); the token's K/V (every kv head, from
    rank 0's copy) go into each group's copies at ``cache_pos`` (None: a
    cross-attention's cache, read only).  Each group attends where its
    cache lies: the ranks' query heads of its rows are gathered onto the
    slots that hold its sequence, each scores every head over its
    positions, and the softmax's max and sum are reduced over them
    (``_attend_spread``); the groups' contexts are joined over ``data``
    on rank 0's device and each TP rank takes its heads of them into its
    rows of ``wo`` (each data shard its slice of the output's columns,
    joined).  Returns the ranks' outputs (B, 1, d): fp32 row-parallel
    partials where the heads are cut (to be summed,
    ``tp.reduce_from_ranks``), else rank 0's whole output alone, in the
    input's dtype."""
    from ..distributed import actctx, tp
    b, _, d = xs[0].shape
    dtype = xs[0].dtype
    local = params[0]["wq"].shape[-2]
    ranks = range(len(params)) if local < num_heads else range(1)

    def query(j):
        q = contract(xs[j], params[j]["wq"], False).to(f32)
        if "q_norm" in params[j]:
            q = rms_norm(q, params[j]["q_norm"], norm_eps)
        if rope:
            q = apply_rope(q, positions.to(q.device), rope_theta)
        return q.to(dtype)
    qs = tp.run_ranks(ranks, query)
    if cache_pos is not None:
        k, v = cache_kv(params[0], xs[0], positions=positions, rope=rope,
                        rope_theta=rope_theta, norm_eps=norm_eps,
                        dtype=kv.reads[0].k[0].dtype)
    g, hd = num_kv_heads, qs[0].shape[-1]

    def attend(i):          # group i's rows, where its cache lies
        rows, read, writes = kv.rows[i], kv.reads[i], kv.writes[i]
        n = qs[0][rows].shape[0]
        if cache_pos is not None:
            for copy in writes:
                write_kv(copy, k[rows], v[rows], int(cache_pos))
        q_all = tp.gather_to([q[rows] for q in qs], 2,
                             [kk.device for kk in read.k])
        return _attend_spread(
            [q.reshape(n, 1, g, num_heads // g, hd) for q in q_all], read.k,
            read.v, read.offsets(), positions[rows], window, causal, dtype,
            xs[0].device).reshape(n, 1, num_heads * hd)

    def live(i):            # the group touches a live slot
        return any(actctx.live(t.device) for t in (
            xs[0], *kv.reads[i].k, *(kk for c in kv.writes[i] for kk in c.k)))
    ctxs = tp.fan_out(range(len(kv.rows)), attend, live)
    ctx = torch.cat(ctxs, 0) if len(ctxs) > 1 else ctxs[0]
    partial = len(ranks) > 1

    def output(j):
        part = ctx[..., j * local * hd:(j + 1) * local * hd].to(xs[j].device)
        out = contract(part, params[j]["wo"], partial, k=2)
        return out if partial else out.to(dtype)
    return tp.run_ranks(ranks, output)


# --------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------- #

def mlp(params: Mapping, x: torch.Tensor, partial: bool = False
        ) -> torch.Tensor:
    """``partial``: ``params`` hold a TP rank's FFN columns and rows, so
    the output is a row-parallel partial, kept fp32: the ranks' partials
    are summed in fp32 and cast once (``tp.reduce_from_ranks``), as
    GSPMD sums the reference's fp32 partial products — a rounding of
    each partial would move the residual by an ulp, enough to flip a
    near tie in a later MoE routing."""
    # prefill keeps gate/up in fp32 (the reference's preferred fp32 is
    # not cast back); decode (S == 1) accumulates in the activation dtype
    wide = x.shape[1] > 1
    if "w_gate" in params:
        g = contract(x, params["w_gate"], wide)
        u = contract(x, params["w_up"], wide)
        h = swiglu(g.to(f32), u.to(f32)).to(x.dtype)
        out = contract(h, params["w_down"], partial)
    else:
        h = gelu(contract(x, params["w_in"], wide).to(f32))
        out = contract(h.to(x.dtype), params["w_out"], partial)
    return out if partial else out.to(x.dtype)


# --------------------------------------------------------------------- #
# loss
# --------------------------------------------------------------------- #

def chunked_ce_loss(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over the unmasked positions without
    materialising (B, S, V) logits: one (B, chunk, V) fp32 slab at a
    time, recomputed in the backward pass (``remat``), as the
    reference's checkpointed scan does.  The S mod chunk positions left
    over run as one more slab, not recomputed, as in the reference.
    ``head``: (d, V), every column of it (a padded vocabulary's pad
    columns too) in the logsumexp."""
    b, s, d = hidden.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=hidden.device)
    chunk = min(chunk, s)
    n_chunks = s // chunk
    rem = s - n_chunks * chunk

    def one(h, y, m):
        logits = mm_f32(h.reshape(-1, d), head).reshape(
            h.shape[0], h.shape[1], -1)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
        m = m.to(f32)
        return torch.sum((lse - gold) * m), torch.sum(m)

    tot = torch.zeros((), dtype=f32, device=hidden.device)
    cnt = torch.zeros((), dtype=f32, device=hidden.device)
    for i in range(0, n_chunks * chunk, chunk):
        tl, tc = remat(one, hidden[:, i:i + chunk], labels[:, i:i + chunk],
                       mask[:, i:i + chunk])
        tot, cnt = tot + tl, cnt + tc
    if rem:
        tl, tc = one(hidden[:, -rem:], labels[:, -rem:], mask[:, -rem:])
        tot, cnt = tot + tl, cnt + tc
    return tot / torch.clamp(cnt, min=1.0)


def vocab_parallel_ce_loss(hiddens, heads, labels: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           chunk: int = 512) -> torch.Tensor:
    """``chunked_ce_loss`` with the head cut over the TP ranks by
    vocabulary: rank j holds ``hiddens[j]`` (B, S, d), its copy of the
    hidden state, and ``heads[j]`` (d, V_j), the head's columns
    V_0 + … + V_{j-1} onwards, on its device.  Each rank builds only its
    (B, chunk, V_j) fp32 slab; the logsumexp is the global max plus the
    log of the ranks' sums of exponentials, and the gold logit comes from
    the rank that owns the label, both joined by
    ``tp.reduce_from_ranks`` (fp32).  ``labels``/``mask`` and the
    result lie on rank 0's device; chunks as ``chunked_ce_loss``'s,
    recomputed in the backward pass over every rank."""
    from ..distributed import tp
    b, s, d = hiddens[0].shape
    dev = labels.device
    devices = [h.device for h in hiddens]
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=dev)
    offsets = np.cumsum([0] + [w.shape[1] for w in heads[:-1]]).tolist()
    vocab = sum(w.shape[1] for w in heads)
    chunk = min(chunk, s)
    n_chunks = s // chunk
    rem = s - n_chunks * chunk

    def one(y, m, *hs):
        logits = tp.run_ranks(range(len(hs)), lambda j: actctx.shard(
            mm_f32(hs[j].reshape(-1, d), heads[j]).reshape(
                hs[j].shape[0], hs[j].shape[1], -1), "btf", size=vocab),
            inputs=lambda j: (hs[j], heads[j]))
        with torch.no_grad():
            top = torch.stack([lj.amax(-1).to(dev) for lj in logits]
                              ).amax(0)                        # (B, c)
        sums, golds = [], []
        for j, (lj, off) in enumerate(zip(logits, offsets)):
            yj = y.to(devices[j]).long() - off
            inside = (yj >= 0) & (yj < lj.shape[-1])
            sums.append(torch.exp(lj - top.to(devices[j])[..., None]
                                  ).sum(-1))
            gold = torch.gather(lj, -1, yj.clamp(0, lj.shape[-1] - 1
                                                 )[..., None])[..., 0]
            golds.append(torch.where(inside, gold, torch.zeros_like(gold)))
        lse = top + torch.log(tp.reduce_from_ranks(sums))
        m = m.to(f32)
        return (torch.sum((lse - tp.reduce_from_ranks(golds)) * m),
                torch.sum(m))

    tot = torch.zeros((), dtype=f32, device=dev)
    cnt = torch.zeros((), dtype=f32, device=dev)
    for i in range(0, n_chunks * chunk, chunk):
        tl, tc = remat(one, labels[:, i:i + chunk], mask[:, i:i + chunk],
                       *[h[:, i:i + chunk] for h in hiddens])
        tot, cnt = tot + tl, cnt + tc
    if rem:
        tl, tc = one(labels[:, -rem:], mask[:, -rem:],
                     *[h[:, -rem:] for h in hiddens])
        tot, cnt = tot + tl, cnt + tc
    return tot / torch.clamp(cnt, min=1.0)


__all__ = ["mm_f32", "remat", "chunked_ce_loss", "vocab_parallel_ce_loss",
           "contract", "rms_norm", "layer_norm", "swiglu", "gelu",
           "rope_frequencies", "apply_rope", "normal", "init_attention",
           "init_mlp", "init_embedding", "attention", "mlp", "Q_CHUNK",
           "SeqKV", "cache_kv", "write_kv", "MeshKV", "attention_mesh_decode",
           "over_data"]
