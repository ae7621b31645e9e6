# Verbatim copy of src/repro/configs/jamba_1_5_large_398b.py (no imports of repro).
"""jamba-1.5-large-398b — [hybrid] 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16 experts top-2 — Mamba+attention 1:7 interleave.
[arXiv:2403.19887; hf]

Layer pattern: period-8 blocks with attention at index 4 (1:7 attn:mamba);
MoE on every other layer (16e top-2), dense FFN on the rest — the Jamba
block recipe.  Attention layers carry no positional encoding (the SSM
provides position), matching the paper."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    moe_every=2,
    moe_offset=1,
    attn_period=8,
    attn_index=4,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_groups=1,
    rope=False,
    capacity_factor=1.25,
    moe_dispatch_chunk=512,
)
