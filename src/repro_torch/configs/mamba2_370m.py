# Verbatim copy of src/repro/configs/mamba2_370m.py (no imports of repro).
"""mamba2-370m — [ssm] 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

d_inner = 2 * d_model = 2048, head_dim 64 -> 32 SSD heads, 1 group,
conv kernel 4, chunk 256."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_groups=1,
    rope=False,
    tie_embeddings=True,
)
