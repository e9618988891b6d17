"""starcoder2-7b — dense GQA, RoPE. [arXiv:2402.19173]

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
36 heads % 16 != 0 → sharding rules use sequence-sharded attention on the
16-way model axis (see repro.distributed.sharding).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49_152,
    mlp_kind="gelu",        # StarCoder2 uses a plain 2-matrix GELU MLP
    qk_norm=False,
    rope_theta=100_000.0,
    subquadratic=False,
    notes="GQA kv=4, RoPE; 36 heads not divisible by 16-way model axis",
)

REDUCED = ModelConfig(
    name="starcoder2-7b-reduced",
    family="dense",
    n_layers=2,
    d_model=144,            # keeps the 36-head flavour: 6 heads x 24
    n_heads=6,
    n_kv_heads=2,
    d_ff=576,
    vocab=512,
    mlp_kind="gelu",
    rope_theta=100_000.0,
    notes="smoke-test reduction of starcoder2-7b",
)
