"""command-r-plus-104b — dense GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01]

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
Pure full attention → long_500k is skipped (DESIGN.md §Arch-applicability).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256_000,
    qk_norm=False,
    rope_theta=75_000.0,
    tie_embeddings=True,   # Cohere ties input/output embeddings
    subquadratic=False,
    notes="GQA kv=8, no biases, tied embeddings",
)

REDUCED = ModelConfig(
    name="command-r-plus-104b-reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=352,
    vocab=512,
    rope_theta=75_000.0,
    tie_embeddings=True,
    notes="smoke-test reduction of command-r-plus-104b",
)
