"""mamba2-370m — attention-free SSM with state-space duality (SSD).
[arXiv:2405.21060]

48L d_model=1024 (attn-free) vocab=50280, ssm_state=128.
O(1) decode state ⇒ long_500k runs.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,           # unused (attention-free); kept for uniform plumbing
    n_kv_heads=1,
    d_ff=0,
    vocab=50_280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    subquadratic=True,
    notes="SSD (state-space duality); attention-free; O(1) decode state",
)

REDUCED = ModelConfig(
    name="mamba2-370m-reduced",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=512,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, n_groups=1, chunk=32),
    subquadratic=True,
    notes="smoke-test reduction of mamba2-370m",
)
