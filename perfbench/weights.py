"""The benchmark's weights: drawn from the run's seed by one generator on
the device, one call a stacked leaf (a leaf holds every layer's copy), in
the type they are served in.  Both the program and the plain reference get
these tensors; the reference gets them drawn again from the same seed after
the program's state is freed, so it reads nothing the program touched.

The tree has the program's layout for a decoder of one layer kind (period
1): ``blocks[0]`` holds every layer stacked on axis 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .yardstick import dims

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def layout(conf: Dict) -> Dict:
    """Nested dict of (shape, dtype, kind) leaves in the served type
    (``torch_dtype``; the router stays float32); kind is "ones", "embed"
    (std 0.02) or "dense" (std 1 / sqrt(fan_in), fan_in = shape[-2])."""
    m = dims(conf)
    nb, d = m.n_layers, m.d_model
    dt = DTYPES[conf["torch_dtype"]]
    vp = round_up(m.vocab, 512)
    attn = {"wq": ((nb, d, m.q_dim), dt, "dense"),
            "wk": ((nb, d, m.kv_dim), dt, "dense"),
            "wv": ((nb, d, m.kv_dim), dt, "dense"),
            "wo": ((nb, m.q_dim, d), dt, "dense")}
    if conf.get("qk_norm"):
        attn["q_norm"] = {"scale": ((nb, m.d_head), dt, "ones")}
        attn["k_norm"] = {"scale": ((nb, m.d_head), dt, "ones")}
    block = {"ln1": {"scale": ((nb, d), dt, "ones")}, "attn": attn,
             "ln2": {"scale": ((nb, d), dt, "ones")}}
    if m.moe:
        if m.dense_layers:
            raise ValueError("a leading dense layer is a second layer kind; "
                             "this layout holds one")
        f, e, ns = m.expert_d_ff, m.n_experts, m.n_shared
        block["moe"] = {
            "router": ((nb, d, e), torch.float32, "dense"),
            "wi": ((nb, e, d, 2 * f), dt, "dense"),
            "wo": ((nb, e, f, d), dt, "dense"),
            "shared": {"wi": ((nb, d, 2 * ns * f), dt, "dense"),
                       "wo": ((nb, ns * f, d), dt, "dense")}}
    else:
        block["mlp"] = {"wi": ((nb, d, 2 * m.d_ff), dt, "dense"),
                        "wo": ((nb, m.d_ff, d), dt, "dense")}
    tree = {"embed": {"w": ((vp, d), dt, "embed")},
            "final_norm": {"scale": ((d,), dt, "ones")},
            "blocks": [block]}
    if not conf.get("tie_word_embeddings"):
        tree["lm_head"] = {"w": ((vp, d), dt, "embed")}
    return tree


def _leaves(tree, path=()) -> List[Tuple[Tuple, object]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], path + (k,))
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, path + (i,))
        return out
    return [(path, tree)]


def make(conf: Dict, seed: int, device) -> Dict:
    """The weight tree for ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [build(v) for v in tree]
        shape, dtype, kind = tree
        t = torch.empty(shape, dtype=dtype, device=device)
        if kind == "ones":
            return t.fill_(1.0)
        std = 0.02 if kind == "embed" else 1.0 / math.sqrt(shape[-2])
        return t.normal_(0.0, std, generator=gen)

    return build(layout(conf))


def signature(tree) -> List[Tuple[Tuple, Tuple, str]]:
    """(path, shape, dtype) of every tensor leaf, in path order."""
    return [(p, tuple(t.shape), str(t.dtype)) for p, t in _leaves(tree)]

