"""Plain reference of a dense decoder (Qwen3: grouped-query attention with
RMSNorm on each head's q and k, rotary positions, SwiGLU MLP, the LM head
tied to the embedding), in float32.  The layers are in
:mod:`perfbench.reference.common`; this module gives the MLP half."""

from __future__ import annotations

from .common import swiglu


def ffn(lw, h, rows, conf, lin):
    """SwiGLU MLP of every token: [gate | up] = h @ wi, then
    (silu(gate) * up) @ wo."""
    del rows, conf
    return swiglu(h, lw["mlp"]["wi"], lw["mlp"]["wo"], lin)
