"""Mixture-of-Experts FFN — port of ``src/repro/models/moe.py``: top-k
routing with capacity-bounded dispatch, in plain PyTorch.

Dispatch/combine are one-hot einsums, as in the reference.  Capacity:
C = min(max(8, ceil8(int(S·K·cf/E))), S) per dispatch window; tokens
overflowing an expert's capacity are dropped (combine weight zero).  A
(token, k) pair's slot in its expert's buffer is a cumsum over the
token-major flattened (S·K) order, and the top-k puts the lower expert
first on ties (``lax.top_k``'s rule, through a stable descending sort),
so the same tokens drop as in the reference.

The Switch aux loss of a dispatch window is ``E · Σ_e me_e · ce_e``: the
mean router probability ``me`` (differentiable) times the share of
routed slots ``ce`` (from top-k indices: no gradient), both means over
the window's (B, S).  A data-parallel step sees 1/n of the rows a shard,
so it needs both factors of every window: under ``collect_aux_stats()``
each window's forward records ``AuxStat(me, ce, weight)``, where
``weight`` is the window's share of its layer's aux (1/windows).  The
records come from the first forward pass only: ``remat``'s recompute
runs in the backward pass, after the collector has closed.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Mapping, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from .layers import normal, over_data, remat

f32 = torch.float32


def init_moe(gen: torch.Generator, d_model: int, num_experts: int,
             moe_d_ff: int, dtype: torch.dtype) -> dict:
    return {
        "router": normal(gen, (d_model, num_experts), f32),  # fp32 router
        "w_gate": normal(gen, (num_experts, d_model, moe_d_ff), dtype),
        "w_up": normal(gen, (num_experts, d_model, moe_d_ff), dtype),
        "w_down": normal(gen, (num_experts, moe_d_ff, d_model), dtype),
    }


def _capacity(tokens: int, num_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = int(tokens * top_k * capacity_factor / num_experts)
    c = max(8, -(-c // 8) * 8)  # round up to 8 (the reference's lanes)
    # a single token occupies at most one slot per expert: decode needs
    # capacity exactly 1
    return min(c, tokens)


MOE_CHUNK = 4096


class AuxStat(NamedTuple):
    """One dispatch window's Switch statistics: ``me`` (E,) with its
    graph, ``ce`` (E,) detached, and the window's weight in the summed
    aux loss."""
    me: torch.Tensor
    ce: torch.Tensor
    weight: float


_COLLECT: dict = {"stats": None}


@contextmanager
def collect_aux_stats():
    """Within: every MoE window's forward appends its ``AuxStat`` to
    the list this yields, in forward order."""
    old = _COLLECT["stats"]
    stats: List[AuxStat] = []
    _COLLECT["stats"] = stats
    try:
        yield stats
    finally:
        _COLLECT["stats"] = old


def aux_from_stats(stats, num_experts: int) -> torch.Tensor:
    """Σ weight · E · Σ_e me_e · ce_e over the records: the model's
    summed aux loss (the value of ``forward``'s ``aux``)."""
    return sum(st.weight * num_experts * torch.sum(st.me * st.ce)
               for st in stats)


def moe_ffn(params: Mapping, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, chunk: int = MOE_CHUNK
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).

    Sequences longer than ``chunk`` run in ``chunk``-token windows, each
    with its own capacity (the reference's checkpointed ``lax.scan``
    becomes a loop of ``remat`` calls); S must then be a multiple of
    ``chunk``."""
    (out,), aux = _windows(lambda w: _moe_core(
        params, w, top_k=top_k, capacity_factor=capacity_factor), [x], chunk)
    return out, aux


def _windows(fn, xs: Sequence[torch.Tensor], chunk: int):
    """``fn(*xs) -> (*outs, aux)`` — one output an input — over the
    inputs' ``chunk``-token windows when S exceeds ``chunk``, each
    recomputed in the backward pass and its ``AuxStat`` records weighted
    by 1/windows; the outputs joined, the aux the mean.  Returns (outs,
    aux)."""
    s = xs[0].shape[1]
    if s <= chunk:
        *outs, aux = fn(*xs)
        return outs, aux
    if s % chunk:
        raise ValueError(f"moe_ffn: S={s} is not a multiple of the "
                         f"dispatch window {chunk}")
    nc = s // chunk
    stats = _COLLECT["stats"]
    first = None if stats is None else len(stats)
    outs = [[] for _ in xs]
    aux = torch.zeros((), dtype=f32, device=xs[0].device)
    for i in range(nc):
        *out, a = remat(fn, *[x[:, i * chunk:(i + 1) * chunk] for x in xs])
        for o, part in zip(outs, out):
            o.append(part)
        aux = aux + a
    if stats is not None:
        stats[first:] = [st._replace(weight=st.weight / nc)
                         for st in stats[first:]]
    return [torch.cat(o, dim=1) for o in outs], aux / nc


def top_k_lower_first(values: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, the lower index
    first among equal values (``torch.topk`` leaves that order
    unspecified)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: Mapping, x: torch.Tensor, *, top_k: int, cap: int):
    """The router: (probs (B,S,E), gate values (B,S,K) with dropped pairs
    zeroed, expert ids (B,S,K), slot of each pair in its expert's buffer
    (B,S,K), kept (B,S,K))."""
    b, s, _ = x.shape
    e = params["router"].shape[-1]
    logits = torch.einsum("bsd,de->bse", x.to(f32), params["router"].to(f32))
    probs = torch.softmax(logits, dim=-1)                     # (B,S,E)
    gate_vals, gate_idx = top_k_lower_first(probs, top_k)     # (B,S,K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    # position of each (token, k) within its expert's capacity buffer:
    # a cumsum over the token-major flattened (S·K) order
    flat = F.one_hot(gate_idx, e).to(f32).reshape(b, s * top_k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(
        b, s, top_k, e)
    pos = torch.sum(pos_in_expert * flat.reshape(b, s, top_k, e), dim=-1)
    keep = pos < cap
    return probs, gate_vals * keep.to(f32), gate_idx, pos, keep


def _dispatch(params: Mapping, x: torch.Tensor, *, top_k: int,
              capacity_factor: float):
    """One window's routing: (dispatch (B,S,E,C), combine (B,S,E,C), both
    in ``x``'s dtype, the aux loss); records its ``AuxStat``."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    cap = _capacity(s, e, top_k, capacity_factor)
    probs, gate_vals, gate_idx, pos, keep = route(params, x, top_k=top_k,
                                                  cap=cap)
    onehot = F.one_hot(gate_idx, e).to(f32)                   # (B,S,K,E)

    # load-balancing aux loss (Switch): E * Σ_e f_e · p_e
    me = probs.mean(dim=(0, 1))                               # (E,)
    ce_frac = onehot.sum(dim=2).mean(dim=(0, 1))              # (E,)
    aux = e * torch.sum(me * ce_frac)
    if _COLLECT["stats"] is not None:
        _COLLECT["stats"].append(AuxStat(me, ce_frac.detach(), 1.0))

    # jax.nn.one_hot gives a zero row for an index past the last class;
    # F.one_hot raises, so dropped slots are clamped and then zeroed
    pos_oh = F.one_hot(pos.long().clamp(max=cap - 1), cap).to(f32) \
        * keep[..., None]
    dispatch = torch.einsum("bske,bskc->bsec", onehot, pos_oh
                            ).to(x.dtype)                     # (B,S,E,C)
    combine = torch.einsum("bsk,bske,bskc->bsec", gate_vals, onehot, pos_oh
                           ).to(x.dtype)
    return dispatch, combine, aux


def _experts(params: Mapping, x: torch.Tensor, dispatch: torch.Tensor,
             combine: torch.Tensor, partial: bool = False) -> torch.Tensor:
    """The experts of ``params`` (E_local of them, matching the E axis of
    ``dispatch``/``combine``) on their tokens, combined back: (B,S,d);
    ``partial``: a TP rank's share of the experts, combined in fp32 (the
    row-parallel partial ``layers.mlp`` keeps)."""
    # prefill keeps gate/up in fp32; decode (S == 1) accumulates in the
    # activation dtype, as the reference does
    wide = x.shape[1] > 1
    xin = torch.einsum("bsd,bsec->becd", x, dispatch).to(x.dtype)
    g = over_data(xin, params["w_gate"], _expert_mm, wide, 1)
    u = over_data(xin, params["w_up"], _expert_mm, wide, 1)
    h = (F.silu(g.to(f32)) * u.to(f32)).to(x.dtype)
    eo = over_data(h, params["w_down"], _expert_mm, False, 1).to(x.dtype)
    if partial:
        return torch.einsum("becd,bsec->bsd", eo.to(f32), combine.to(f32))
    return torch.einsum("becd,bsec->bsd", eo, combine).to(x.dtype)


def _expert_mm(x: torch.Tensor, w: torch.Tensor, keep_f32: bool
               ) -> torch.Tensor:
    """(B, E, C, k) × (E, k, n) -> (B, E, C, n): fp32 products where
    ``keep_f32`` (both operands widened, exact in fp32), else in ``x``'s
    dtype."""
    if keep_f32:
        return torch.einsum("becd,edf->becf", x.to(f32), w.to(f32))
    return torch.einsum("becd,edf->becf", x, w)


def _moe_core(params: Mapping, x: torch.Tensor, *, top_k: int,
              capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    dispatch, combine, aux = _dispatch(params, x, top_k=top_k,
                                       capacity_factor=capacity_factor)
    return _experts(params, x, dispatch, combine), aux


def moe_ffn_tp(params: Sequence[Mapping], xs: Sequence[torch.Tensor], *,
               top_k: int, capacity_factor: float = 1.25,
               chunk: int = MOE_CHUNK):
    """``moe_ffn`` over the TP ranks of a data row: rank j holds
    ``params[j]`` (the replicated router; its E/t experts where the spec
    cuts them over ``model``) and ``xs[j]``, its copy of the input
    (B, S, d).  The row routes once, on rank 0 (so the aux loss and its
    ``AuxStat`` count once); each rank takes the cut of ``dispatch`` /
    ``combine`` of its experts (``tp.split_to_ranks``) and returns its
    partial of the output.  Returns (the ranks' outputs, aux, whether
    they are partials to sum); experts the axis does not cut run whole
    on every rank.  Windows as ``moe_ffn``'s."""
    from ..distributed import tp
    e = params[0]["router"].shape[-1]
    partial = params[0]["w_gate"].shape[-3] < e
    devices = [x.device for x in xs]

    def window(*ws):
        dispatch, combine, aux = _dispatch(params[0], ws[0], top_k=top_k,
                                           capacity_factor=capacity_factor)
        if partial:
            dsp = tp.split_to_ranks(dispatch, 2, devices)
            cmb = tp.split_to_ranks(combine, 2, devices)
        else:
            dsp = tp.copy_to_ranks(dispatch, devices)
            cmb = tp.copy_to_ranks(combine, devices)
        return (*tp.run_ranks(range(len(params)), lambda j: _experts(
            params[j], ws[j], dsp[j], cmb[j], partial),
            inputs=lambda j: (ws[j], dsp[j], cmb[j])), aux)

    outs, aux = _windows(window, xs, chunk)
    return outs, aux, partial


__all__ = ["init_moe", "moe_ffn", "moe_ffn_tp", "_moe_core", "_capacity",
           "route", "top_k_lower_first", "MOE_CHUNK", "AuxStat", "collect_aux_stats",
           "aux_from_stats"]
