"""mixtral-8x22b — MoE 8 experts top-2 with sliding-window attention.
[arXiv:2401.04088]

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA.
SWA ⇒ O(window) decode KV ⇒ long_500k runs (window-clipped cache).
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32_768,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    moe=MoEConfig(
        n_experts=8,
        top_k=2,
        expert_d_ff=16384,
        n_shared_experts=0,
        capacity_factor=1.25,
        every=1,
    ),
    subquadratic=True,   # sliding window bounds decode KV
    notes="8 experts top-2; sliding-window attention (window=4096)",
)

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    sliding_window=64,
    moe=MoEConfig(capacity_factor=8.0, n_experts=4, top_k=2, expert_d_ff=256, every=1),
    subquadratic=True,
    notes="smoke-test reduction of mixtral-8x22b",
)
