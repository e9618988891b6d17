"""Workload descriptions: per-layer shape tables.

Copy of ``repro.core.workloads`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_vengine.py`` holds the two against each other).

The faithful-reproduction benchmarks use the paper's four CNNs at 224x224
(VGG16, ResNet50, Inception v3, MobileNet v1) exactly as in §6.1.  The layer
tables below drive the static compiler -> IFP tiling -> latency simulator.
Angel-Eye runs 8-bit fixed point, so activation/weight dtypes default to 1 B.

The LM serving stack converts a model config into the same ``Layer`` IR via
:func:`lm_layer_table`, which is what lets the paper's per-layer
{width | output-channel} tiling choice act as a {data- | tensor-}parallel
sharding selector for transformers.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class Layer:
    """A conv/matmul-like layer.  ``w`` is the width-tiling dim (pixels for
    CNNs, tokens for LMs); ``c_out`` is the output-channel-tiling dim."""

    name: str
    h: int
    w: int
    c_in: int
    c_out: int
    kh: int = 1
    kw: int = 1
    stride: int = 1
    groups: int = 1
    abytes: int = 1     # activation bytes/elem
    wbytes: int = 1     # weight bytes/elem
    # for LM pseudo-layers whose "weights" are a KV cache / SSM state:
    extra_in_bytes: float = 0.0

    # -- cost terms ---------------------------------------------------------
    @property
    def flops(self) -> float:
        return 2.0 * self.h * self.w * self.c_out * (self.c_in // self.groups) * self.kh * self.kw

    @property
    def weight_nbytes(self) -> float:
        return float(self.c_out * (self.c_in // self.groups) * self.kh * self.kw * self.wbytes)

    def input_nbytes(self, w_cols: int | None = None, c_in: int | None = None) -> float:
        """Bytes of input feature map needed to produce ``w_cols`` output
        columns (with halo for kw>1) over ``c_in`` input channels."""
        w_cols = self.w if w_cols is None else w_cols
        c_in = self.c_in if c_in is None else c_in
        h_in = self.h * self.stride + max(self.kh - self.stride, 0)
        w_in = w_cols * self.stride + max(self.kw - self.stride, 0)
        return float(h_in * w_in * c_in * self.abytes) + self.extra_in_bytes

    @property
    def output_nbytes(self) -> float:
        return float(self.h * self.w * self.c_out * self.abytes)

    @property
    def is_depthwise(self) -> bool:
        return self.groups > 1 and self.groups == self.c_in == self.c_out


Workload = List[Layer]


# ---------------------------------------------------------------------------
# Paper CNNs (224 x 224 input, batch 1, int8)
# ---------------------------------------------------------------------------


def vgg16() -> Workload:
    layers: Workload = []
    cfg = [(64, 2, 224), (128, 2, 112), (256, 3, 56), (512, 3, 28), (512, 3, 14)]
    c_in = 3
    for b, (c, n, hw) in enumerate(cfg):
        for i in range(n):
            layers.append(Layer(f"conv{b+1}_{i+1}", hw, hw, c_in, c, 3, 3))
            c_in = c
    layers.append(Layer("fc6", 1, 1, 512 * 7 * 7, 4096))
    layers.append(Layer("fc7", 1, 1, 4096, 4096))
    layers.append(Layer("fc8", 1, 1, 4096, 1000))
    return layers


def resnet50() -> Workload:
    L: Workload = [Layer("conv1", 112, 112, 3, 64, 7, 7, stride=2)]
    stages = [  # (n_blocks, mid, out, hw)
        (3, 64, 256, 56),
        (4, 128, 512, 28),
        (6, 256, 1024, 14),
        (3, 512, 2048, 7),
    ]
    c_in = 64
    for s, (n, mid, out, hw) in enumerate(stages):
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            pre = f"res{s+2}{chr(ord('a')+b)}"
            L.append(Layer(f"{pre}_1x1a", hw, hw, c_in, mid, 1, 1, stride=stride))
            L.append(Layer(f"{pre}_3x3", hw, hw, mid, mid, 3, 3))
            L.append(Layer(f"{pre}_1x1b", hw, hw, mid, out, 1, 1))
            if b == 0:
                L.append(Layer(f"{pre}_proj", hw, hw, c_in, out, 1, 1, stride=stride))
            c_in = out
    L.append(Layer("fc", 1, 1, 2048, 1000))
    return L


def inception_v3() -> Workload:
    """Inception v3 branch convolutions (299x299 input).  Branches within a
    module are independent layers — natural fodder for multi-core tiling."""
    L: Workload = [
        Layer("stem_c1", 149, 149, 3, 32, 3, 3, stride=2),
        Layer("stem_c2", 147, 147, 32, 32, 3, 3),
        Layer("stem_c3", 147, 147, 32, 64, 3, 3),
        Layer("stem_c4", 73, 73, 64, 80, 1, 1),
        Layer("stem_c5", 71, 71, 80, 192, 3, 3),
    ]

    def inception_a(tag: str, c_in: int, pool_c: int) -> None:
        hw = 35
        L.append(Layer(f"{tag}_b1_1x1", hw, hw, c_in, 64))
        L.append(Layer(f"{tag}_b2_1x1", hw, hw, c_in, 48))
        L.append(Layer(f"{tag}_b2_5x5", hw, hw, 48, 64, 5, 5))
        L.append(Layer(f"{tag}_b3_1x1", hw, hw, c_in, 64))
        L.append(Layer(f"{tag}_b3_3x3a", hw, hw, 64, 96, 3, 3))
        L.append(Layer(f"{tag}_b3_3x3b", hw, hw, 96, 96, 3, 3))
        L.append(Layer(f"{tag}_pool_1x1", hw, hw, c_in, pool_c))

    inception_a("mixed0", 192, 32)
    inception_a("mixed1", 256, 64)
    inception_a("mixed2", 288, 64)

    # reduction A
    L.append(Layer("mixed3_b1_3x3", 17, 17, 288, 384, 3, 3, stride=2))
    L.append(Layer("mixed3_b2_1x1", 35, 35, 288, 64))
    L.append(Layer("mixed3_b2_3x3a", 35, 35, 64, 96, 3, 3))
    L.append(Layer("mixed3_b2_3x3b", 17, 17, 96, 96, 3, 3, stride=2))

    def inception_b(tag: str, c7: int) -> None:
        hw, c_in = 17, 768
        L.append(Layer(f"{tag}_b1_1x1", hw, hw, c_in, 192))
        L.append(Layer(f"{tag}_b2_1x1", hw, hw, c_in, c7))
        L.append(Layer(f"{tag}_b2_1x7", hw, hw, c7, c7, 1, 7))
        L.append(Layer(f"{tag}_b2_7x1", hw, hw, c7, 192, 7, 1))
        L.append(Layer(f"{tag}_b3_1x1", hw, hw, c_in, c7))
        L.append(Layer(f"{tag}_b3_7x1a", hw, hw, c7, c7, 7, 1))
        L.append(Layer(f"{tag}_b3_1x7a", hw, hw, c7, c7, 1, 7))
        L.append(Layer(f"{tag}_b3_7x1b", hw, hw, c7, c7, 7, 1))
        L.append(Layer(f"{tag}_b3_1x7b", hw, hw, c7, 192, 1, 7))
        L.append(Layer(f"{tag}_pool_1x1", hw, hw, c_in, 192))

    inception_b("mixed4", 128)
    inception_b("mixed5", 160)
    inception_b("mixed6", 160)
    inception_b("mixed7", 192)

    # reduction B
    L.append(Layer("mixed8_b1_1x1", 17, 17, 768, 192))
    L.append(Layer("mixed8_b1_3x3", 8, 8, 192, 320, 3, 3, stride=2))
    L.append(Layer("mixed8_b2_1x1", 17, 17, 768, 192))
    L.append(Layer("mixed8_b2_1x7", 17, 17, 192, 192, 1, 7))
    L.append(Layer("mixed8_b2_7x1", 17, 17, 192, 192, 7, 1))
    L.append(Layer("mixed8_b2_3x3", 8, 8, 192, 192, 3, 3, stride=2))

    def inception_c(tag: str, c_in: int) -> None:
        hw = 8
        L.append(Layer(f"{tag}_b1_1x1", hw, hw, c_in, 320))
        L.append(Layer(f"{tag}_b2_1x1", hw, hw, c_in, 384))
        L.append(Layer(f"{tag}_b2_1x3", hw, hw, 384, 384, 1, 3))
        L.append(Layer(f"{tag}_b2_3x1", hw, hw, 384, 384, 3, 1))
        L.append(Layer(f"{tag}_b3_1x1", hw, hw, c_in, 448))
        L.append(Layer(f"{tag}_b3_3x3", hw, hw, 448, 384, 3, 3))
        L.append(Layer(f"{tag}_b3_1x3", hw, hw, 384, 384, 1, 3))
        L.append(Layer(f"{tag}_b3_3x1", hw, hw, 384, 384, 3, 1))
        L.append(Layer(f"{tag}_pool_1x1", hw, hw, c_in, 192))

    inception_c("mixed9", 1280)
    inception_c("mixed10", 2048)
    L.append(Layer("fc", 1, 1, 2048, 1000))
    return L


def mobilenet_v1() -> Workload:
    L: Workload = [Layer("conv1", 112, 112, 3, 32, 3, 3, stride=2)]
    # (c_out of pointwise, output hw, stride of depthwise)
    cfg = [
        (64, 112, 1), (128, 56, 2), (128, 56, 1), (256, 28, 2), (256, 28, 1),
        (512, 14, 2), (512, 14, 1), (512, 14, 1), (512, 14, 1), (512, 14, 1),
        (512, 14, 1), (1024, 7, 2), (1024, 7, 1),
    ]
    c_in = 32
    for i, (c, hw, s) in enumerate(cfg):
        L.append(Layer(f"dw{i+1}", hw, hw, c_in, c_in, 3, 3, stride=s, groups=c_in))
        L.append(Layer(f"pw{i+1}", hw, hw, c_in, c, 1, 1))
        c_in = c
    L.append(Layer("fc", 1, 1, 1024, 1000))
    return L


CNN_WORKLOADS = {
    "vgg16": vgg16,
    "resnet50": resnet50,
    "inception_v3": inception_v3,
    "mobilenet": mobilenet_v1,
}


# ---------------------------------------------------------------------------
# LM decoder layers -> Layer IR (for the LM-serving virtualization engine)
# ---------------------------------------------------------------------------


def lm_layer_table(
    *,
    n_layers: int,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_ff: int,
    vocab: int,
    seq: int,
    batch: int = 1,
    moe_experts: int = 0,
    moe_topk: int = 0,
    abytes: int = 2,
    wbytes: int = 2,
    decode: bool = False,
) -> Workload:
    """Transformer decoder as a Layer table (tokens on the width axis).

    ``decode=True`` prices one new token per sequence against a KV cache of
    ``seq`` (the cache read shows up as ``extra_in_bytes`` of the attention
    pseudo-layer — the "weights" analogue that output-channel tiling shards).
    """
    d_head = d_model // n_heads
    tokens = batch * (1 if decode else seq)
    kv_ctx = seq
    L: Workload = []
    for i in range(n_layers):
        L.append(Layer(f"l{i}_qkv", 1, tokens, d_model,
                       (n_heads + 2 * n_kv_heads) * d_head,
                       abytes=abytes, wbytes=wbytes))
        # attention as a pseudo-layer: flops = 4*tokens*ctx*d per (shared) head
        attn_flops_cols = 2 * kv_ctx * d_head * n_heads * 2  # qk + av
        kv_bytes = 2 * kv_ctx * n_kv_heads * d_head * abytes
        L.append(Layer(f"l{i}_attn", 1, tokens, attn_flops_cols // 2, 1,
                       abytes=abytes, wbytes=0, extra_in_bytes=kv_bytes))
        L.append(Layer(f"l{i}_out", 1, tokens, n_heads * d_head, d_model,
                       abytes=abytes, wbytes=wbytes))
        if moe_experts:
            # active experts only (top-k routed); each is up+gate+down
            for e in range(moe_topk):
                L.append(Layer(f"l{i}_moe{e}_up", 1, tokens, d_model, 2 * d_ff,
                               abytes=abytes, wbytes=wbytes))
                L.append(Layer(f"l{i}_moe{e}_down", 1, tokens, d_ff, d_model,
                               abytes=abytes, wbytes=wbytes))
        else:
            L.append(Layer(f"l{i}_up", 1, tokens, d_model, 2 * d_ff,
                           abytes=abytes, wbytes=wbytes))
            L.append(Layer(f"l{i}_down", 1, tokens, d_ff, d_model,
                           abytes=abytes, wbytes=wbytes))
    L.append(Layer("lm_head", 1, tokens, d_model, vocab, abytes=abytes, wbytes=wbytes))
    return L


def workload_stats(layers: Workload) -> dict:
    return {
        "layers": len(layers),
        "gflops": sum(l.flops for l in layers) / 1e9,
        "weight_mb": sum(l.weight_nbytes for l in layers) / 1e6,
        "act_mb": sum(l.output_nbytes for l in layers) / 1e6,
    }
