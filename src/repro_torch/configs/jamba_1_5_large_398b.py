"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with MoE.
[arXiv:2403.19887]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
KV only in 1/8 layers ⇒ long_500k runs (9 attention layers of KV).
"""

from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65_536,
    rope_theta=10_000.0,   # Jamba uses no RoPE on attn layers; we keep RoPE
                           # (positional handling noted in DESIGN.md)
    attn_every=8,          # 1 attention layer per 8 (7 mamba : 1 attn)
    moe=MoEConfig(
        n_experts=16,
        top_k=2,
        expert_d_ff=24576,
        n_shared_experts=0,
        capacity_factor=1.25,
        every=2,           # MoE replaces MLP every other layer
    ),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=128, n_groups=8, chunk=256),
    subquadratic=True,
    notes="Mamba+attn 1:7 interleave; MoE 16e top-2 every other layer",
)

REDUCED = ModelConfig(
    name="jamba-1.5-large-398b-reduced",
    family="hybrid",
    n_layers=4,            # one 1:3 hybrid block x 2 for the smoke test
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    attn_every=4,
    moe=MoEConfig(capacity_factor=8.0, n_experts=4, top_k=2, expert_d_ff=256, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, n_groups=2, chunk=32),
    subquadratic=True,
    notes="smoke-test reduction of jamba-1.5-large-398b",
)
