"""qwen2-vl-72b — VLM transformer backbone with M-RoPE. [arXiv:2409.12191]

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Per the brief the modality frontend is a STUB: ``input_specs()`` supplies
precomputed patch embeddings + 3D (temporal, h, w) position ids for M-RoPE.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152_064,
    m_rope=True,
    rope_theta=1_000_000.0,
    subquadratic=False,
    notes="M-RoPE (3D positions), dynamic-resolution frontend stubbed",
)

REDUCED = ModelConfig(
    name="qwen2-vl-72b-reduced",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=384,
    vocab=512,
    m_rope=True,
    rope_theta=1_000_000.0,
    notes="smoke-test reduction of qwen2-vl-72b",
)
