# Verbatim copy of src/repro/configs/__init__.py (no imports of repro).
"""Assigned-architecture registry.

Each module defines CONFIG (the exact published numbers from the assignment
table — see DESIGN.md §6) and this package adds `get_config(name)` plus
`smoke_config(name)`, a structurally-identical reduced variant for CPU
smoke tests (same family/layer-pattern/flags, tiny dims).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..models.config import ModelConfig

from . import (gemma3_1b, granite_34b, h2o_danube_1_8b, internvl2_1b,
               jamba_1_5_large_398b, mamba2_370m, qwen3_4b,
               qwen3_moe_30b_a3b, qwen3_moe_235b_a22b, whisper_base)

_MODULES = [qwen3_moe_30b_a3b, qwen3_moe_235b_a22b, granite_34b, gemma3_1b,
            qwen3_4b, h2o_danube_1_8b, internvl2_1b, mamba2_370m,
            jamba_1_5_large_398b, whisper_base]

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def arch_names() -> List[str]:
    return list(ARCHS.keys())


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced config of the same family: small layers/width, few experts,
    tiny vocab — used by per-arch CPU smoke tests.  Full configs are only
    exercised via the dry-run (ShapeDtypeStruct, no allocation)."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else None,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=128,
        dtype="float32",
    )
    if cfg.num_experts:
        kw.update(num_experts=4,
                  experts_per_token=min(cfg.experts_per_token, 2),
                  moe_d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=8)
    if cfg.attn_period:
        kw.update(attn_period=4, attn_index=2, num_layers=4)
    if cfg.is_encoder_decoder:
        kw.update(num_encoder_layers=2, num_layers=2)
    if cfg.sliding_window:
        kw.update(sliding_window=8)
    if cfg.global_every:
        kw.update(global_every=3)
    if cfg.frontend == "vision_stub":
        kw.update(num_patches=8)
    return cfg.replace(**kw)
