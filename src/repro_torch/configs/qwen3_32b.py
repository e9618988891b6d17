"""qwen3-32b — dense GQA with qk_norm. [hf:Qwen/Qwen3-8B family]

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151_936,
    d_head=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    subquadratic=False,
    notes="qk_norm, GQA kv=8",
)

REDUCED = ModelConfig(
    name="qwen3-32b-reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    d_head=32,
    qk_norm=True,
    rope_theta=1_000_000.0,
    notes="smoke-test reduction of qwen3-32b",
)
