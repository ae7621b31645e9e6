# Verbatim copy of src/repro/configs/internvl2_1b.py (no imports of repro).
"""internvl2-1b — [vlm] 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2/Qwen2 backbone.  [arXiv:2404.16821; hf]

Backbone-only per the assignment: the ViT frontend is a STUB —
`input_specs()` supplies precomputed patch embeddings (B, 256, d_model)
prepended to the token embeddings."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    frontend="vision_stub",
    num_patches=256,
    tie_embeddings=True,
    rope_theta=1e6,
)
