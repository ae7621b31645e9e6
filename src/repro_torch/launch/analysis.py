# Verbatim copy of src/repro/launch/analysis.py (no imports of repro), but
# for cache_total_bytes, which walks its tree without jax.tree.leaves.
"""Roofline-term extraction from the compiled dry-run artifact.

Why not raw ``cost_analysis()``: XLA's HloCostAnalysis visits each
computation once — a `lax.scan` over 94 layers reports ~1/94th of the real
FLOPs, bytes, and collective traffic.  Three-term methodology used here
(documented in EXPERIMENTS.md §Roofline):

  * compute term   — analytic FLOPs (exact per-family formulas below;
    train counts fwd + 2×bwd + 1×remat-recompute = 4× forward);
  * memory term    — analytic HBM traffic (params/opt/grads re-reads with
    remat factor, KV-cache reads for decode, major activation tensors);
  * collective term — parsed from the post-SPMD optimized HLO, with every
    instruction weighted by the trip count of its enclosing while loops
    (trip counts recovered from the loop-condition constants), and ring
    wire-cost factors per collective kind.

``cost_analysis()`` / ``memory_analysis()`` numbers are still recorded
raw — memory_analysis is the per-chip fit proof (buffer assignment is not
trip-count-dependent), and cost_analysis serves as a consistency floor.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from ..models.config import ModelConfig

# --------------------------------------------------------------------- #
# analytic FLOPs
# --------------------------------------------------------------------- #

def _vocab_padded(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 256) * 256


def _attn_layer_flops(cfg: ModelConfig, tokens: float, ctx_avg: float
                      ) -> float:
    """Per-layer attention FLOPs for `tokens` query tokens with average
    attended context `ctx_avg`."""
    d, h, g, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    proj = 2 * tokens * d * (h * hd) * 2      # q & o
    proj += 2 * tokens * d * (g * hd) * 2     # k & v
    sdp = 2 * tokens * ctx_avg * h * hd * 2   # scores + ctx
    return proj + sdp


def _mlp_layer_flops(cfg: ModelConfig, tokens: float) -> float:
    mult = 3 if cfg.act == "swiglu" else 2
    return 2 * tokens * cfg.d_model * cfg.d_ff * mult


def _moe_layer_flops(cfg: ModelConfig, tokens: float) -> float:
    router = 2 * tokens * cfg.d_model * cfg.num_experts
    expert = (2 * tokens * cfg.experts_per_token * cfg.capacity_factor
              * cfg.d_model * cfg.moe_d_ff * 3)
    return router + expert


def _ssd_layer_flops(cfg: ModelConfig, tokens: float, decode: bool) -> float:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, p = (cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                  cfg.ssm_head_dim)
    proj = 2 * tokens * d * (2 * di + 2 * g * n + h)
    proj += 2 * tokens * di * d               # out_proj
    if decode:
        state = 2 * tokens * h * p * n * 2    # update + readout
        return proj + state
    q = cfg.ssm_chunk
    intra = 2 * tokens * q * h * (n + p)      # cb + y_intra (per token: Q·..)
    inter = 2 * tokens * h * p * n * 2        # chunk states + y_inter
    return proj + intra + inter


def forward_flops(cfg: ModelConfig, batch: int, seq: int,
                  kind: str) -> float:
    """Total forward FLOPs for one step of `kind` (train fwd / prefill /
    decode).  For decode, seq = cache depth and one token decodes per
    sequence."""
    decode = kind == "decode"
    tokens = float(batch) * (1.0 if decode else seq)
    total = 0.0
    for l in range(cfg.num_layers):
        if cfg.is_attn_layer(l):
            w = cfg.layer_window(l, seq)
            if decode:
                ctx = float(seq if w == 0 else min(w, seq))
            else:
                ctx = float(seq / 2 if w == 0 else min(w, seq / 2))
            total += _attn_layer_flops(cfg, tokens, ctx)
        else:
            total += _ssd_layer_flops(cfg, tokens, decode)
        if cfg.is_moe_layer(l):
            total += _moe_layer_flops(cfg, tokens)
        elif cfg.d_ff:
            total += _mlp_layer_flops(cfg, tokens)
    if cfg.is_encoder_decoder:
        # encoder over `seq` frames + cross-attention from decoder
        enc_tokens = float(batch) * seq
        dec_tokens = tokens
        for _ in range(cfg.num_encoder_layers):
            total += _attn_layer_flops(cfg, enc_tokens, seq / 2)
            total += _mlp_layer_flops(cfg, enc_tokens)
        cross_ctx = float(seq)
        total += cfg.num_layers * _attn_layer_flops(cfg, dec_tokens,
                                                    cross_ctx)
    total += 2 * tokens * cfg.d_model * _vocab_padded(cfg)   # lm head
    return total


def step_flops(cfg: ModelConfig, batch: int, seq: int, kind: str,
               remat: bool = True) -> float:
    fwd = forward_flops(cfg, batch, seq, kind)
    if kind == "train":
        return fwd * (4.0 if remat else 3.0)  # fwd + 2×bwd (+1 recompute)
    return fwd


# --------------------------------------------------------------------- #
# analytic HBM traffic (per device, per step)
# --------------------------------------------------------------------- #

def param_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    base = cfg.param_count()
    base += (_vocab_padded(cfg) - cfg.vocab_size) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    return float(base) * dtype_bytes


def hbm_bytes(cfg: ModelConfig, batch: int, seq: int, kind: str,
              chips: int, cache_bytes_total: float = 0.0) -> float:
    """Per-device HBM bytes for one step (napkin, documented)."""
    p_local = param_bytes(cfg) / chips
    if kind == "train":
        # params ×3 reads (fwd, bwd, remat) + grad fp32 w+r + adam m,v r+w
        # + param write
        traffic = p_local * 3 + 2 * p_local * 4 + 4 * p_local * 4 \
            + p_local
        # activations: per layer, per local token: carry + qkv/ssm + ffn
        tokens_local = batch * seq / chips * 16  # dp shards only (model
        # axis replicates activations over tp; tp=16)
        d = cfg.d_model
        per_tok_layer = 2 * (4 * d + 2 * (cfg.d_ff or cfg.d_model * 6))
        traffic += cfg.num_layers * tokens_local * per_tok_layer * 2
        return traffic
    if kind == "prefill":
        tokens_local = batch * seq / chips * 16
        d = cfg.d_model
        per_tok_layer = 2 * (4 * d + 2 * (cfg.d_ff or cfg.d_model * 6))
        return p_local + cfg.num_layers * tokens_local * per_tok_layer \
            + cache_bytes_total / chips
    # decode: read every live parameter + the whole cache, once
    return p_local + cache_bytes_total / chips


def cache_total_bytes(cache_shape_tree) -> float:
    import numpy as np
    total = 0
    for leaf in _tree_leaves(cache_shape_tree):
        total += float(np.prod(leaf.shape)) * leaf.dtype.itemsize
    return total


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------- #
# HLO collective parse with while-loop trip counts
# --------------------------------------------------------------------- #

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
                "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8, "c64": 8, "c128": 16}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_COMP_START = re.compile(
    r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s+\(.*\)\s*->.*\{\s*$")
_BODY_RE = re.compile(r"body=%?([\w\.\-]+)")
_TRIP_RE = re.compile(r"\"known_trip_count\":\{\"n\":\"(\d+)\"\}")
_OP_RE = re.compile(r"=\s*(?:\()?\s*(\w+)\[([0-9,]*)\][^ ]*\s+([a-z0-9-]+)\(")
_TUPLE_OP_RE = re.compile(r"=\s*\(([^)]*)\)\s+([a-z0-9-]+)\(")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
_GROUPS_V2_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _split_computations(hlo: str) -> Dict[str, List[str]]:
    """Computations are flat brace-delimited blocks; layout / replica-group
    / backend-config braces are balanced within single lines, so per-line
    net brace count isolates the block bodies."""
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    depth = 0
    for line in hlo.splitlines():
        stripped = line.strip()
        if depth == 0:
            m = _COMP_START.match(stripped)
            if m:
                cur = m.group(1)
                comps[cur] = []
                depth = 1
                continue
        else:
            depth += stripped.count("{") - stripped.count("}")
            if depth <= 0:
                cur = None
                depth = 0
                continue
            if cur is not None:
                comps[cur].append(stripped)
    return comps


def _tensor_bytes(dt: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dt, 4)


def _wire_bytes(kind: str, rbytes: float, g: int) -> float:
    g = max(g, 2)
    if kind == "all-gather":
        return rbytes * (g - 1) / g
    if kind == "all-reduce":
        return 2 * rbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return rbytes * (g - 1)
    if kind == "all-to-all":
        return rbytes * (g - 1) / g
    return rbytes


def parse_collectives(hlo_text: str) -> Dict[str, Any]:
    comps = _split_computations(hlo_text)

    # while edges: body computation -> trip count, from the while
    # instruction's backend_config ("known_trip_count") — XLA records it
    # for every counted loop jax.lax.scan produces.
    body_trip: Dict[str, int] = {}
    parent: Dict[str, List[str]] = {}
    for name, lines in comps.items():
        for ln in lines:
            if " while(" not in ln and not ln.startswith("while("):
                continue
            bm = _BODY_RE.search(ln)
            if not bm:
                continue
            body = bm.group(1)
            tm = _TRIP_RE.search(ln)
            body_trip[body] = int(tm.group(1)) if tm else 1
            parent.setdefault(body, []).append(name)

    def multiplier(comp: str, seen=()) -> int:
        if comp in seen:
            return 1
        mult = body_trip.get(comp, 1) if comp in body_trip else 1
        pars = parent.get(comp, [])
        if not pars:
            return mult
        return mult * max(multiplier(p, seen + (comp,)) for p in pars)

    per_op = {c: 0.0 for c in _COLLECTIVES}
    counts = {c: 0 for c in _COLLECTIVES}
    weighted = {c: 0.0 for c in _COLLECTIVES}
    for name, lines in comps.items():
        mult = multiplier(name)
        for ln in lines:
            opname = None
            rbytes = 0
            m = _OP_RE.search(ln)
            if m:
                dt, dims, opname = m.groups()
                rbytes = _tensor_bytes(dt, dims)
            else:
                mt = _TUPLE_OP_RE.search(ln)
                if mt:
                    parts, opname = mt.groups()
                    for tm in re.finditer(r"(\w+)\[([0-9,]*)\]", parts):
                        rbytes += _tensor_bytes(*tm.groups())
            if opname is None:
                continue
            base = None
            for c in _COLLECTIVES:
                if opname == c or opname == c + "-start":
                    base = c
                    break
            if base is None:
                continue
            g = 1
            gm = _GROUPS_RE.search(ln)
            if gm:
                g = len(gm.group(1).split(","))
            else:
                gm2 = _GROUPS_V2_RE.search(ln)
                if gm2:
                    g = int(gm2.group(2))
            wire = _wire_bytes(base, rbytes, g)
            per_op[base] += wire * mult
            weighted[base] += wire * mult
            counts[base] += 1
    return {"bytes_per_op": per_op, "counts": counts,
            "total_bytes": sum(per_op.values()),
            "trip_counts_found": sorted(set(body_trip.values()))[-8:]}
