# Verbatim copy of src/repro/models/config.py (no imports of repro).
"""Unified architecture config covering all 10 assigned families.

One dataclass, one source of truth: the per-arch files in repro/configs/
instantiate this with the exact published numbers (see the assignment table
in DESIGN.md §6).  Model code branches only on the *structural* fields
(family, layer pattern), never on the arch name.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                       # dense-FFN hidden dim (0 for pure-MoE/ssm)
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // num_heads

    # --- MoE ---------------------------------------------------------- #
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0               # per-expert FFN hidden dim
    moe_every: int = 1              # MoE on layers where (l % moe_every)==moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # dispatch window (tokens) for the chunked MoE path: large windows
    # minimize per-chunk expert-grad reductions (qwen-MoE), small windows
    # bound dispatch memory via the chunk-level remat (jamba)
    moe_dispatch_chunk: int = 4096

    # --- attention flavour -------------------------------------------- #
    qk_norm: bool = False
    sliding_window: int = 0         # 0 = full attention
    global_every: int = 0           # >0: every Nth layer full, rest sliding
    rope: bool = True
    rope_theta: float = 1e4

    # --- SSM (mamba2) -------------------------------------------------- #
    ssm_state: int = 0              # N (d_state)
    ssm_expand: int = 2             # d_inner = expand * d_model
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # --- hybrid (jamba) ------------------------------------------------ #
    attn_period: int = 0            # >0: layer l is attention iff
    attn_index: int = 0             #     (l % attn_period) == attn_index

    # --- enc-dec (whisper) --------------------------------------------- #
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    max_decode_len: int = 448       # whisper decoder context cap

    # --- modality frontend stub ---------------------------------------- #
    frontend: str = "none"          # none | audio_stub | vision_stub
    num_patches: int = 0            # vision_stub prefix length

    # --- numerics ------------------------------------------------------ #
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "swiglu"             # swiglu | gelu

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    # ------------------------------------------------------------------ #
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, l: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_period:
            return (l % self.attn_period) == self.attn_index
        return True

    def is_moe_layer(self, l: int) -> bool:
        if self.num_experts == 0:
            return False
        return (l % self.moe_every) == self.moe_offset

    def layer_window(self, l: int, seq_len: int) -> int:
        """Effective attention window for layer l (0 => full)."""
        if self.sliding_window == 0:
            return 0
        if self.global_every and (l % self.global_every
                                  == self.global_every - 1):
            return 0
        return self.sliding_window

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ #
    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        hd = self.head_dim
        d = self.d_model
        n = 0
        for l in range(self.num_layers):
            if self.is_attn_layer(l):
                n += d * self.num_heads * hd          # q
                n += 2 * d * self.num_kv_heads * hd   # k, v
                n += self.num_heads * hd * d          # o
                if self.qk_norm:
                    n += 2 * hd
            else:  # mamba2 block
                di, g, ns, h = (self.d_inner, self.ssm_groups,
                                self.ssm_state, self.ssm_heads)
                n += d * (2 * di + 2 * g * ns + h)    # in_proj
                n += self.ssm_conv * (di + 2 * g * ns)  # conv
                n += 2 * h                            # A_log, D
                n += h                                # dt_bias
                n += di * d                           # out_proj
            if self.is_moe_layer(l):
                n += d * self.num_experts             # router
                n += self.num_experts * 3 * d * self.moe_d_ff
            elif self.d_ff:
                mult = 3 if self.act == "swiglu" else 2
                n += mult * d * self.d_ff
            n += 2 * d                                # norms
        if self.is_encoder_decoder:
            for _ in range(self.num_encoder_layers):
                n += 4 * d * self.num_heads * hd
                n += (3 if self.act == "swiglu" else 2) * d * self.d_ff
                n += 2 * d
            n += self.num_layers * (4 * d * self.num_heads * hd + d)  # cross
        n += self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        n += d                                        # final norm
        return n

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top-k experts only)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = sum(self.is_moe_layer(l)
                           for l in range(self.num_layers))
        all_experts = n_moe_layers * self.num_experts * 3 * self.d_model \
            * self.moe_d_ff
        active = n_moe_layers * self.experts_per_token * 3 * self.d_model \
            * self.moe_d_ff
        return full - all_experts + active
