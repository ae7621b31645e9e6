# Verbatim copy of src/repro/configs/gemma3_1b.py (no imports of repro).
"""gemma3-1b — [dense] 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global sliding-window, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

window=512 (gemma3), every 6th layer global; head_dim=256; tied embeddings.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    sliding_window=512,
    global_every=6,
    tie_embeddings=True,
    rope_theta=1e6,
)
