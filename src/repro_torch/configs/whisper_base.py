"""whisper-base — encoder-decoder with conv frontend (stubbed).
[arXiv:2212.04356]

6L (decoder) d_model=512 8H d_ff=2048 vocab=51865; 6 encoder layers.
The conv frontend is a STUB per the brief: ``input_specs()`` provides
precomputed frame embeddings of shape (batch, 1500, d_model).
Full attention + enc-dec ⇒ long_500k skipped.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,            # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51_865,
    mlp_kind="gelu",        # Whisper uses a plain 2-matrix GELU MLP
    rope_theta=0.0,        # whisper uses learned/sinusoidal positions; we use
                           # sinusoidal added at embed (no RoPE)
    n_enc_layers=6,
    enc_seq=1500,          # 30 s of audio at 50 Hz after the conv stub
    subquadratic=False,
    notes="enc-dec; conv frontend stub; sinusoidal positions (no RoPE)",
)

REDUCED = ModelConfig(
    name="whisper-base-reduced",
    family="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    mlp_kind="gelu",
    rope_theta=0.0,
    n_enc_layers=2,
    enc_seq=64,
    notes="smoke-test reduction of whisper-base",
)
