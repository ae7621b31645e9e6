# Verbatim copy of src/repro/configs/whisper_base.py (no imports of repro).
"""whisper-base — [audio] 6L enc + 6L dec d_model=512 8H (kv=8) d_ff=2048
vocab=51865 — encoder-decoder, conv frontend (stub).
[arXiv:2212.04356; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    is_encoder_decoder=True,
    num_encoder_layers=6,
    max_decode_len=448,
    act="gelu",
    rope=False,
    tie_embeddings=True,
    frontend="audio_stub",
)
