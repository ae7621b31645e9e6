# Verbatim copy of src/repro/configs/qwen3_moe_30b_a3b.py (no imports of repro).
"""qwen3-moe-30b-a3b — [moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]

d_ff=768 is the *per-expert* FFN width (moe_intermediate_size); every layer
is MoE.  Qwen3 family: head_dim=128 (explicit in HF config), qk_norm on.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    qk_norm=True,
    rope_theta=1e6,
    capacity_factor=1.25,
)
