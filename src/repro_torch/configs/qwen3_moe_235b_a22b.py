# Verbatim copy of src/repro/configs/qwen3_moe_235b_a22b.py (no imports of repro).
"""qwen3-moe-235b-a22b — [moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    qk_norm=True,
    rope_theta=1e6,
    capacity_factor=1.25,
)
