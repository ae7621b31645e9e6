"""Mamba2 — SSD (state-space duality) block, chunked-scan formulation.
Port of ``src/repro/models/ssm.py`` in plain PyTorch.

Per head h the recurrence is
    H_t = a_t · H_{t-1} + (Δ_t x_t) B_tᵀ          (P×N state)
    y_t = H_t C_t + D · x_t
with a_t = exp(−exp(A_log)·Δ_t), Δ = softplus(dt + dt_bias).

The chunked SSD decomposition computes an intra-chunk quadratic term and
carries the chunk state ``h`` from chunk to chunk; the reference's
checkpointed ``lax.scan`` over chunks becomes a Python loop of ``remat``
calls that carries ``h`` exactly as its ``body`` does, with the
``exp(cum)`` differences in fp32.  Decode is the O(1) state update.  Projections are split per
segment (z, x, B, C, dt) as in the reference.
"""

from __future__ import annotations

from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .layers import contract, normal, remat

f32 = torch.float32


def init_mamba2(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    gn = g * n
    dev = gen.device
    return {
        "z_proj": normal(gen, (d, di), dtype),
        "x_proj": normal(gen, (d, di), dtype),
        "b_proj": normal(gen, (d, gn), dtype),
        "c_proj": normal(gen, (d, gn), dtype),
        "dt_proj": normal(gen, (d, h), dtype),
        "conv_x_w": normal(gen, (cfg.ssm_conv, di), dtype),
        "conv_x_b": torch.zeros(di, dtype=dtype, device=dev),
        "conv_b_w": normal(gen, (cfg.ssm_conv, gn), dtype),
        "conv_b_b": torch.zeros(gn, dtype=dtype, device=dev),
        "conv_c_w": normal(gen, (cfg.ssm_conv, gn), dtype),
        "conv_c_b": torch.zeros(gn, dtype=dtype, device=dev),
        "A_log": torch.tensor(np.log(np.linspace(1.0, 16.0, h)), dtype=f32,
                              device=dev),
        "D": torch.ones(h, dtype=f32, device=dev),
        "dt_bias": torch.full((h,), -4.6, dtype=f32, device=dev),
        "out_proj": normal(gen, (di, d), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B, L, C), w: (K, C) (the reference's
    layout; ``F.conv1d`` takes it as (C, 1, K)).

    ``history``: (B, K-1, C) left context (prefill continuation)."""
    k, c = w.shape
    if history is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([history, x], dim=1)
    # lax.conv_general_dilated with feature_group_count=C is a
    # cross-correlation, as F.conv1d(groups=C) is
    out = F.conv1d(xp.to(f32).transpose(1, 2),
                   w.to(f32).t().reshape(c, 1, k), groups=c)
    return (out.transpose(1, 2) + b.to(f32)).to(x.dtype)


def _conv_step(x_t: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               history: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token conv via ring buffer.  x_t: (B, 1, C)."""
    buf = torch.cat([history, x_t], dim=1)                    # (B, K, C)
    out = (torch.einsum("bkc,kc->bc", buf.to(f32), w.to(f32))
           + b.to(f32))[:, None, :]
    return out.to(x_t.dtype), buf[:, 1:, :]


def _ssd_chunked(xh, dt, a_log, Bm, Cm, D, chunk: int, h0=None):
    """Chunked SSD, one chunk at a time.

    xh: (B,L,H,P); dt: (B,L,H); Bm/Cm: (B,L,G,N).
    ``h0``: optional initial state (B,H,P,N) — prefill-with-state.
    Returns y (B,L,H,P) and the final state (B,H,P,N).  One chunk's
    (B,H,Q,Q) score tile lives at a time, as in the reference."""
    b, l, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if l % chunk:
        raise ValueError(f"_ssd_chunked: L={l} is not a multiple of the "
                         f"chunk {chunk}")
    rep = h // g

    la = (-torch.exp(a_log)[None, None, :] * dt).to(f32)      # log a (B,L,H)
    xdt = xh.to(f32) * dt[..., None]                           # Δx
    ii = torch.arange(chunk, device=xh.device)
    causal = ii[:, None] >= ii[None, :]

    def body(h_prev, la_k, xdt_k, B_k, C_k):
        cum = torch.cumsum(la_k, dim=1)                        # (B,Q,H)
        total = cum[:, -1, :]                                  # (B,H)
        Bh = torch.repeat_interleave(B_k, rep, dim=2) if g != h else B_k
        Ch = torch.repeat_interleave(C_k, rep, dim=2) if g != h else C_k
        cb = torch.einsum("bihn,bjhn->bhij", Ch, Bh)           # (B,H,Q,Q)
        # the causal mask goes in before the exp: the reference takes
        # exp(cum_i - cum_j) of the masked (j > i) entries too and selects
        # them away after, so once a chunk's decay passes e^88 its
        # backward gives 0·inf = NaN.  Equal values and gradients
        # wherever the reference's are finite.
        diff = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            ~causal[None, :, :, None], float("-inf"))         # (B,Q,Q,H)
        scores = cb * torch.exp(diff).permute(0, 3, 1, 2)      # (B,H,Q,Q)
        y_intra = torch.einsum("bhij,bjhp->bihp", scores, xdt_k)
        y_inter = torch.einsum("bihn,bhpn,bih->bihp", Ch, h_prev,
                               torch.exp(cum))
        w_state = torch.exp(total[:, None, :] - cum)           # (B,Q,H)
        h_chunk = torch.einsum("bjhp,bjhn,bjh->bhpn", xdt_k, Bh, w_state)
        return (h_prev * torch.exp(total)[:, :, None, None] + h_chunk,
                y_intra + y_inter)

    h_prev = (torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
              if h0 is None else h0.to(f32))
    ys = []
    for c0 in range(0, l, chunk):
        h_prev, y_k = remat(body, h_prev, la[:, c0:c0 + chunk],
                            xdt[:, c0:c0 + chunk],
                            Bm[:, c0:c0 + chunk].to(f32),
                            Cm[:, c0:c0 + chunk].to(f32))
        ys.append(y_k)
    y = torch.cat(ys, dim=1)
    y = y + D[None, None, :, None] * xh.to(f32)
    return y, h_prev


def mamba2_block(params: Mapping, x: torch.Tensor, cfg,
                 state: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, L, d).  state: {'ssm': (B,H,P,N), 'conv_x': (B,K-1,di),
    'conv_b': (B,K-1,gn), 'conv_c': (B,K-1,gn)}.

    Train: state=None — chunked SSD, returns (y, None).
    Prefill: state given, L > 1 — chunked SSD seeded from state.
    Decode: state given, L == 1 — O(1) update.
    Returns a new state dict (the given one is not modified)."""
    b, l, d = x.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    k = cfg.ssm_conv

    def proj(w):            # the reference casts each projection back
        return contract(x, w, False).to(x.dtype)

    z = proj(params["z_proj"])
    xr = proj(params["x_proj"])
    br = proj(params["b_proj"])
    cr = proj(params["c_proj"])
    dt_r = proj(params["dt_proj"])

    decode = state is not None and l == 1
    if decode:
        xc, new_cx = _conv_step(xr, params["conv_x_w"], params["conv_x_b"],
                                state["conv_x"])
        bc, new_cb = _conv_step(br, params["conv_b_w"], params["conv_b_b"],
                                state["conv_b"])
        cc, new_cc = _conv_step(cr, params["conv_c_w"], params["conv_c_b"],
                                state["conv_c"])
    else:
        hist = (None, None, None) if state is None else (
            state["conv_x"], state["conv_b"], state["conv_c"])
        xc = _causal_conv(xr, params["conv_x_w"], params["conv_x_b"],
                          hist[0])
        bc = _causal_conv(br, params["conv_b_w"], params["conv_b_b"],
                          hist[1])
        cc = _causal_conv(cr, params["conv_c_w"], params["conv_c_b"],
                          hist[2])
        if state is not None:   # histories from the unpadded rows
            new_cx = torch.cat([state["conv_x"], xr], dim=1)[:, -(k - 1):]
            new_cb = torch.cat([state["conv_b"], br], dim=1)[:, -(k - 1):]
            new_cc = torch.cat([state["conv_c"], cr], dim=1)[:, -(k - 1):]

    xh = F.silu(xc.to(f32)).to(x.dtype).reshape(b, l, h, p)
    Bm = F.silu(bc.to(f32)).to(x.dtype).reshape(b, l, g, n)
    Cm = F.silu(cc.to(f32)).to(x.dtype).reshape(b, l, g, n)
    dt = F.softplus(dt_r.to(f32) + params["dt_bias"][None, None, :])

    if not decode:
        chunk = min(cfg.ssm_chunk, l)
        pad = (-l) % chunk
        if pad:  # inert padding: dt=0 => a=1, Δx=0
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            Bm_p = F.pad(Bm, (0, 0, 0, 0, 0, pad))
            Cm_p = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        else:
            xh_p, dt_p, Bm_p, Cm_p = xh, dt, Bm, Cm
        y, h_last = _ssd_chunked(
            xh_p, dt_p, params["A_log"], Bm_p, Cm_p, params["D"], chunk,
            h0=None if state is None else state["ssm"])
        y = y[:, :l]
        new_state = (None if state is None else
                     {"ssm": h_last, "conv_x": new_cx, "conv_b": new_cb,
                      "conv_c": new_cc})
    else:
        rep = h // g
        a = torch.exp(-torch.exp(params["A_log"])[None, :] * dt[:, 0])
        Bh = (torch.repeat_interleave(Bm[:, 0], rep, dim=1) if g != h
              else Bm[:, 0])
        Ch = (torch.repeat_interleave(Cm[:, 0], rep, dim=1) if g != h
              else Cm[:, 0])
        xdt = xh[:, 0].to(f32) * dt[:, 0][..., None]           # (B,H,P)
        h_new = (state["ssm"] * a[:, :, None, None]
                 + torch.einsum("bhp,bhn->bhpn", xdt, Bh.to(f32)))
        y = (torch.einsum("bhpn,bhn->bhp", h_new, Ch.to(f32))
             + params["D"][None, :, None] * xh[:, 0].to(f32))
        y = y[:, None]                                          # (B,1,H,P)
        new_state = {"ssm": h_new, "conv_x": new_cx, "conv_b": new_cb,
                     "conv_c": new_cc}

    y = y.reshape(b, l, di).to(x.dtype)
    y = y * F.silu(z.to(f32)).to(x.dtype)
    out = contract(y, params["out_proj"], False).to(x.dtype)
    return out, new_state


class Holder(NamedTuple):
    """The slots that hold one slice of a serving batch's SSM state (a
    data row's, or every row's copy of a batch the axis does not cut):
    its batch ``rows``; ``ranks``, the modules of the data row whose
    state is computed (None: the caller's ``params``); ``copies``, each
    copy of the state as its TP ranks hold it (one dict a rank: the SSM
    state's heads and the conv histories' channels as ``cache_specs``
    cuts them), the first computed and every one written."""
    rows: slice
    ranks: Optional[list]
    copies: List[List[dict]]


def mamba2_block_tp(params: Sequence[Mapping], xs: Sequence[torch.Tensor],
                    cfg, states: Optional[Sequence[dict]] = None,
                    holders: Optional[Sequence[Holder]] = None,
                    select=None):
    """``mamba2_block`` over the TP ranks of a data row: rank j holds
    ``params[j]`` and ``xs[j]``, its copy of the input (B, L, d), and,
    when serving, ``states[j]``, its cut of the layer's state (the SSM
    state's heads and the conv histories' channels as ``cache_specs``
    cuts them).  Where the spec cuts the SSD heads over ``model`` each
    rank projects, convolves and scans its heads (``z_proj`` /
    ``x_proj`` / ``dt_proj`` columns, ``conv_x_*``, ``A_log`` / ``D`` /
    ``dt_bias``) and returns its row-parallel partial through its rows
    of ``out_proj``.  B and C are shared by every head of a group, so
    where the spec also cuts ``b_proj`` / ``c_proj`` and their convs (a
    storage layout: GSPMD keeps the global semantics) the ranks' conv
    outputs are all-gathered before the scan (or, in decode, the O(1)
    update), and each rank takes the groups its heads map to.  Prefill
    seeds each rank's scan from its state and returns its final chunk
    state.  Returns (outputs — fp32 partials to sum, as ``layers.mlp``'s
    —, whether they are partials, each rank's new state or None); heads
    the axis does not cut run whole on every rank (each updates its own
    state), and rank 0's output is the sublayer's.

    ``holders`` (a weight-stationary decode over the mesh; ``states``
    unused): the ranks project every sequence where their weights lie
    (``layers.contract``); each holder's conv and state update run on
    the slots that hold its rows, with its data row's parameters
    (``select(module)``: the layer's of a rank's module), its new state
    written into each of its copies; the rows' outputs are joined over
    ``data`` on each rank's device before ``out_proj``.  Returns (the
    outputs, whether partials, None)."""
    from ..distributed import actctx, tp
    heads, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    p = cfg.ssm_head_dim
    k = cfg.ssm_conv
    local = params[0]["A_log"].shape[-1]
    cut_bc = params[0]["b_proj"].shape[-1] < g * n
    if local == heads and cut_bc:
        raise ValueError(f"SSD heads ({heads}) that the model axis does "
                         "not cut, with B/C projections that it does")
    partial = local < heads
    rep = heads // g
    b, l, d = xs[0].shape
    decode = (states is not None or holders is not None) and l == 1
    dtype = xs[0].dtype

    def proj(x, w):
        return contract(x, w, False).to(x.dtype)

    raws = tp.run_ranks(range(len(xs)), lambda j: {
        key: proj(xs[j], params[j][f"{key}_proj"])
        for key in ("z", "dt", "x", "b", "c")}, inputs=lambda j: xs[j])
    if holders is None:
        holders = [Holder(slice(None), None, [
            [None] * len(xs) if states is None else list(states)])]
        write = False
    else:
        write = True
    chunk = min(cfg.ssm_chunk, l)
    pad = (-l) % chunk
    news = []

    def one(i):             # holder i's rows, where its state lies
        holder = holders[i]
        hp = params if holder.ranks is None else [select(m)
                                                  for m in holder.ranks]
        sts = holder.copies[0]
        rows = raws[0]["x"][holder.rows].shape[0]
        devs = [x.device if st is None else st["ssm"].device
                for x, st in zip(xs, sts)]

        def convs(j):
            pj, raw, st, dev = hp[j], raws[j], sts[j], devs[j]
            q = {key: raw[key][holder.rows].to(dev) for key in ("z", "dt")}
            for key in ("x", "b", "c"):
                r = raw[key][holder.rows].to(dev)
                w, bias = pj[f"conv_{key}_w"], pj[f"conv_{key}_b"]
                if decode:
                    q[f"{key}c"], q[f"conv_{key}"] = _conv_step(
                        r, w, bias, st[f"conv_{key}"])
                    continue
                q[f"{key}c"] = _causal_conv(
                    r, w, bias, None if st is None else st[f"conv_{key}"])
                if st is not None:   # histories from the unpadded rows
                    q[f"conv_{key}"] = torch.cat(
                        [st[f"conv_{key}"], r], dim=1)[:, -(k - 1):]
            return q
        parts = tp.run_ranks(range(len(xs)), convs,
                             inputs=lambda j: raws[j])
        if cut_bc:
            for key in ("bc", "cc"):
                for part, full in zip(parts, tp.all_gather(
                        [q[key] for q in parts], -1)):
                    part[key] = full

        def scan(j):
            pj, q, st = hp[j], parts[j], sts[j]
            off = j * local if partial else 0
            lo, hi = off // rep, (off + local - 1) // rep + 1
            if local % (hi - lo) or (hi - lo > 1
                                     and (off % rep or local % rep)):
                raise ValueError(f"TP rank {j}'s SSD heads {off}..."
                                 f"{off + local} straddle the groups of "
                                 f"{rep} heads")
            xh = F.silu(q["xc"].to(f32)).to(dtype).reshape(rows, l, local, p)
            Bm = F.silu(q["bc"].to(f32)).to(dtype).reshape(rows, l, g, n)[
                :, :, lo:hi]
            Cm = F.silu(q["cc"].to(f32)).to(dtype).reshape(rows, l, g, n)[
                :, :, lo:hi]
            dt = F.softplus(q["dt"].to(f32) + pj["dt_bias"][None, None, :])
            if decode:
                r = local // (hi - lo)
                a = torch.exp(-torch.exp(pj["A_log"])[None, :] * dt[:, 0])
                Bh = torch.repeat_interleave(Bm[:, 0], r, dim=1)
                Ch = torch.repeat_interleave(Cm[:, 0], r, dim=1)
                xdt = xh[:, 0].to(f32) * dt[:, 0][..., None]
                h_last = (st["ssm"] * a[:, :, None, None]
                          + torch.einsum("bhp,bhn->bhpn", xdt, Bh.to(f32)))
                y = (torch.einsum("bhpn,bhn->bhp", h_last, Ch.to(f32))
                     + pj["D"][None, :, None] * xh[:, 0].to(f32))[:, None]
            else:
                if pad:  # inert padding: dt=0 => a=1, Δx=0
                    xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
                    dt = F.pad(dt, (0, 0, 0, pad))
                    Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
                    Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
                y, h_last = _ssd_chunked(xh, dt, pj["A_log"], Bm, Cm,
                                         pj["D"], chunk,
                                         h0=None if st is None else st["ssm"])
                y = y[:, :l]
            new = None if st is None else {
                "ssm": h_last, **{f"conv_{key}": q[f"conv_{key}"]
                                  for key in ("x", "b", "c")}}
            return y.reshape(rows, l, local * p).to(dtype), new
        done = tp.run_ranks(range(len(xs)), scan,
                            inputs=lambda j: parts[j])
        for j, (_, new) in enumerate(done):
            if new is not None:
                news.append(new)
                if write:
                    for copy in holder.copies:
                        for key, v in new.items():
                            copy[j][key].copy_(v)
        return [y for y, _ in done]

    def live(i):            # the holder's state touches a live slot
        return holders[i].ranks is None or any(
            actctx.live(st["ssm"].device) for c in holders[i].copies
            for st in c)
    ys = [[y.to(x.device) for y in per] for x, per in zip(xs, zip(
        *tp.fan_out(range(len(holders)), one, live)))]

    def output(j):
        y = torch.cat(ys[j], 0) if len(ys[j]) > 1 else ys[j][0]
        y = y * F.silu(raws[j]["z"].to(f32)).to(dtype)
        out = contract(y, params[j]["out_proj"], partial)   # fp32 partial
        return out if partial else out.to(dtype)
    outs = tp.run_ranks(range(len(xs)), output,
                        inputs=lambda j: (ys[j], raws[j]["z"]))
    return outs, partial, None if write or states is None else news


def init_mamba_state(cfg, batch: int, dtype: torch.dtype,
                     device="cpu") -> dict:
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    k = cfg.ssm_conv
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    return {
        "ssm": z(batch, cfg.ssm_heads, cfg.ssm_head_dim, n, dt=f32),
        "conv_x": z(batch, k - 1, di),
        "conv_b": z(batch, k - 1, g * n),
        "conv_c": z(batch, k - 1, g * n),
    }


__all__ = ["init_mamba2", "mamba2_block", "mamba2_block_tp", "Holder", "_ssd_chunked", "_causal_conv",
           "_conv_step", "init_mamba_state"]
