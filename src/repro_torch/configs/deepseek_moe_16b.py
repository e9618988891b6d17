"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066]

28L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1408 vocab=102400, MoE 64e top-6.
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,          # dense-equivalent per-expert width
    vocab=102_400,
    rope_theta=10_000.0,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        expert_d_ff=1408,
        n_shared_experts=2,
        shared_d_ff=1408,
        capacity_factor=1.25,
        every=1,
    ),
    subquadratic=False,
    notes="2 shared + 64 routed top-6 fine-grained experts",
)

REDUCED = ModelConfig(
    name="deepseek-moe-16b-reduced",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=512,
    moe=MoEConfig(capacity_factor=8.0, 
        n_experts=8,
        top_k=2,
        expert_d_ff=96,
        n_shared_experts=2,
        shared_d_ff=96,
        every=1,
    ),
    notes="smoke-test reduction of deepseek-moe-16b",
)
