"""qwen3-0.6b — dense GQA with qk_norm. [hf:Qwen/Qwen3-8B family]

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151_936,
    d_head=128,            # qwen3 uses d_head=128 (> d_model/n_heads)
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    subquadratic=False,
    notes="qk_norm (RMSNorm on q/k per-head), GQA kv=8",
)

REDUCED = ModelConfig(
    name="qwen3-0.6b-reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=384,
    vocab=512,
    d_head=32,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    notes="smoke-test reduction of qwen3-0.6b",
)
