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
from typing import List, Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import normal, remat

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
    b, s, d = x.shape
    if s > chunk:
        if s % chunk:
            raise ValueError(f"moe_ffn: S={s} is not a multiple of the "
                             f"dispatch window {chunk}")
        nc = s // chunk
        stats = _COLLECT["stats"]
        first = None if stats is None else len(stats)
        outs, aux = [], torch.zeros((), dtype=f32, device=x.device)
        for i in range(nc):
            out, a = remat(_moe_window, params,
                           x[:, i * chunk:(i + 1) * chunk], top_k,
                           capacity_factor)
            outs.append(out)
            aux = aux + a
        if stats is not None:
            stats[first:] = [st._replace(weight=st.weight / nc)
                             for st in stats[first:]]
        return torch.cat(outs, dim=1), aux / nc
    return _moe_core(params, x, top_k=top_k,
                     capacity_factor=capacity_factor)


def _moe_window(params, x, top_k, capacity_factor):
    return _moe_core(params, x, top_k=top_k,
                     capacity_factor=capacity_factor)


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


def _moe_core(params: Mapping, x: torch.Tensor, *, top_k: int,
              capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
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

    # prefill keeps gate/up in fp32; decode (S == 1) accumulates in the
    # activation dtype, as the reference does
    wide = s > 1
    xin = torch.einsum("bsd,bsec->becd", x, dispatch).to(x.dtype)
    if wide:
        g = torch.einsum("becd,edf->becf", xin.to(f32),
                         params["w_gate"].to(f32))
        u = torch.einsum("becd,edf->becf", xin.to(f32),
                         params["w_up"].to(f32))
    else:
        g = torch.einsum("becd,edf->becf", xin, params["w_gate"])
        u = torch.einsum("becd,edf->becf", xin, params["w_up"])
    h = (F.silu(g.to(f32)) * u.to(f32)).to(x.dtype)
    eo = torch.einsum("becf,efd->becd", h, params["w_down"]).to(x.dtype)
    out = torch.einsum("becd,bsec->bsd", eo, combine).to(x.dtype)
    return out, aux


__all__ = ["init_moe", "moe_ffn", "_moe_core", "_capacity", "route",
           "top_k_lower_first", "MOE_CHUNK", "AuxStat", "collect_aux_stats",
           "aux_from_stats"]
