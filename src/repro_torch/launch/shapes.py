"""Assigned input shapes and their abstract specs — port of
``src/repro/launch/shapes.py`` without JAX.

Four shapes per architecture (40 cells):
    train_4k     seq 4,096   batch 256   -> train_step
    prefill_32k  seq 32,768  batch 32    -> serve prefill
    decode_32k   seq 32,768  batch 128   -> serve_step (1 token, 32k cache)
    long_500k    seq 524,288 batch 1     -> serve_step (1 token, 500k cache)

Skips (DESIGN.md §6): long_500k only for sub-quadratic families — ssm,
hybrid, and bounded-window SWA (gemma3-1b, h2o-danube); pure full-attention
archs skip it.  Everything else lowers for all archs.

Whisper (enc-dec): seq_len is the *encoder* frame length; decoder length is
capped at max_decode_len (448).  VLM: 256 patch embeddings replace the
first 256 token positions so total context == seq_len.

Where the reference returns ``jax.ShapeDtypeStruct`` leaves, these return
``convert.ShapeLeaf`` (a shape and a torch dtype).  ``decode_args_struct``
builds the cache with the port's own ``init_cache`` on ``meta`` tensors
(no bytes are allocated), as ``jax.eval_shape`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.convert import ShapeLeaf

Struct = ShapeLeaf


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

_LONG_OK_FAMILIES = ("ssm", "hybrid")


def skip_reason(cfg: ModelConfig, shape: str) -> Optional[str]:
    if shape == "long_500k":
        if cfg.family in _LONG_OK_FAMILIES:
            return None
        if cfg.sliding_window:      # bounded-window SWA: sub-quadratic
            return None
        return ("full-attention arch: 500k dense-KV decode is the "
                "quadratic-memory regime the shape spec excludes")
    return None


def whisper_dec_len(cfg: ModelConfig, seq: int) -> int:
    return min(cfg.max_decode_len, max(seq // 8, 64))


def train_batch_struct(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    b, s = shape.batch, shape.seq
    if cfg.is_encoder_decoder:
        return {"frames": Struct((b, s, cfg.d_model), torch.bfloat16),
                "tokens": Struct((b, whisper_dec_len(cfg, s)), torch.int32)}
    if cfg.frontend == "vision_stub":
        return {"tokens": Struct((b, s - cfg.num_patches), torch.int32),
                "patch_embeds": Struct((b, cfg.num_patches, cfg.d_model),
                                       torch.bfloat16)}
    return {"tokens": Struct((b, s), torch.int32)}


def prefill_args_struct(cfg: ModelConfig, shape: ShapeSpec) -> tuple:
    """Positional arg structs for the prefill function (after params)."""
    b, s = shape.batch, shape.seq
    if cfg.is_encoder_decoder:
        return (Struct((b, s, cfg.d_model), torch.bfloat16),
                Struct((b, whisper_dec_len(cfg, s)), torch.int32))
    if cfg.frontend == "vision_stub":
        return (Struct((b, s - cfg.num_patches), torch.int32),
                Struct((b, cfg.num_patches, cfg.d_model), torch.bfloat16))
    return (Struct((b, s), torch.int32),)


def _structs(tree):
    if isinstance(tree, dict):
        return {k: _structs(v) for k, v in tree.items()}
    return Struct(tree.shape, tree.dtype)


def decode_args_struct(cfg: ModelConfig, shape: ShapeSpec, model
                       ) -> Tuple[Any, Struct, Struct]:
    """(cache_struct, token_struct, pos_struct) for serve_decode."""
    b, s = shape.batch, shape.seq
    if cfg.is_encoder_decoder:
        cache = model.cache_structure(b, whisper_dec_len(cfg, s), s)
    else:
        cache = model.init_cache(b, s, "meta")
    cache = _structs(cache)
    token = Struct((b, 1), torch.int32)
    pos = Struct((), torch.int32)
    return cache, token, pos


__all__ = ["ShapeSpec", "SHAPES", "skip_reason", "whisper_dec_len",
           "train_batch_struct", "prefill_args_struct",
           "decode_args_struct"]
