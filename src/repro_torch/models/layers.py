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
from typing import Mapping, Optional, Tuple

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


def contract(x: torch.Tensor, w: torch.Tensor, keep_f32: bool
             ) -> torch.Tensor:
    """Contract the last axis of ``x`` (..., d) with the first axis of
    ``w`` (d, *rest) -> (..., *rest).  ``keep_f32``: the product stays
    fp32 (``mm_f32``); else it is in ``x``'s dtype."""
    lead, d = x.shape[:-1], x.shape[-1]
    rest = w.shape[1:]
    x2, w2 = x.reshape(-1, d), w.reshape(d, -1)
    out = mm_f32(x2, w2) if keep_f32 else x2 @ w2.to(x.dtype)
    return out.reshape(*lead, *rest)


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
              causal: bool = True) -> Tuple[torch.Tensor, Optional[dict]]:
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
    """
    b, s, d = x.shape
    wide = s > 1        # decode accumulates in the activation dtype
    q = contract(x, params["wq"], wide).to(f32)
    if kv_override is None:
        k = contract(x, params["wk"], wide).to(f32)
        v = contract(x, params["wv"], wide).to(f32)
    else:
        k, v = kv_override
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

    hd = q.shape[-1]
    num_heads = q.shape[2]

    if s == 1 and cache is not None:
        g = num_kv_heads
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
        out = contract(ctx.reshape(b, 1, num_heads * hd),
                       params["wo"].reshape(num_heads * hd, d), False)
        return out.to(x.dtype), new_cache

    kh = _expand_kv(k, num_heads).to(x.dtype)                  # (B,T,H,hd)
    vh = _expand_kv(v, num_heads).to(x.dtype)
    qc = actctx.shard(q.to(x.dtype), "bthd")
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
    out = contract(ctx.reshape(b, s, num_heads * hd),
                   params["wo"].reshape(num_heads * hd, d), False)
    return out.to(x.dtype), new_cache


# --------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------- #

def mlp(params: Mapping, x: torch.Tensor) -> torch.Tensor:
    # prefill keeps gate/up in fp32 (the reference's preferred fp32 is
    # not cast back); decode (S == 1) accumulates in the activation dtype
    wide = x.shape[1] > 1
    if "w_gate" in params:
        g = contract(x, params["w_gate"], wide)
        u = contract(x, params["w_up"], wide)
        h = swiglu(g.to(f32), u.to(f32)).to(x.dtype)
        return contract(h, params["w_down"], False).to(x.dtype)
    h = gelu(contract(x, params["w_in"], wide).to(f32))
    return contract(h.to(x.dtype), params["w_out"], False).to(x.dtype)


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


__all__ = ["mm_f32", "remat", "chunked_ce_loss", "contract", "rms_norm", "layer_norm", "swiglu", "gelu",
           "rope_frequencies", "apply_rope", "normal", "init_attention",
           "init_mlp", "init_embedding", "attention", "mlp", "Q_CHUNK"]
