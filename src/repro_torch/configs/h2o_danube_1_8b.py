# Verbatim copy of src/repro/configs/h2o_danube_1_8b.py (no imports of repro).
"""h2o-danube-1.8b — [dense] 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1e4,
)
