"""Gradient compression: block-wise symmetric int8 quantization with error
feedback, and the cross-pod all-reduce on an int8 wire.  Counterpart of
``repro.distributed.compression``: the AdamW moments of
``optim.adamw(quantize=True)`` are stored this way, and
:func:`pod_psum_compressed` combines the pods' gradients in
``training.make_train_step`` over the ``"pod"`` axis of a process mesh
(``launch.mesh.make_host_mesh`` inside a ``torch.distributed`` group).

Rounding is half to even in both packages (``torch.round``,
``jnp.round``), and a float becomes int8 by truncation in both.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..tree import leaves, tree_map, unflatten_like


def _blockify(x, block: int):
    flat = x.reshape(-1)
    n = flat.shape[0]
    nb = (n + block - 1) // block
    pad = nb * block - n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(nb, block), n


def quantize_int8(x, *, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8.  Returns (q (nb, block) int8, scale
    (nb, 1) f32)."""
    xb, _ = _blockify(x.float(), block)
    scale = torch.amax(torch.abs(xb), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, shape, *, block: int = 256):
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def quantization_error(x, *, block: int = 256):
    q, s = quantize_int8(x, block=block)
    return x - dequantize_int8(q, s, x.shape, block=block).to(x.dtype)


def init_error_feedback(params):
    """Zero f32 residual tree matching the grads."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_with_feedback(g, e, *, block: int = 256):
    """One tensor: returns (q, scale, new_residual)."""
    corrected = g.float() + e
    q, s = quantize_int8(corrected, block=block)
    deq = dequantize_int8(q, s, g.shape, block=block)
    return q, s, corrected - deq


def pod_psum_compressed(grads, error_fb, *, mesh, axis: str = "pod",
                        block: int = 256, log=None):
    """All-reduce ``grads`` over ``axis`` of a process mesh with an int8
    wire, the reference's scheme (shared scale, overflow-safe), leaf by
    leaf:

      1. x = g / n + e in f32, in blocks of ``block``; the shared block
         scale s = max over the ranks of max |x| (a MAX all-reduce of 4 B a
         block), divided by 127 / n;
      2. q = round(x / s) clipped to [-127 / n, 127 / n], int8;
      3. the SUM all-reduce of q is exact: n terms of at most 127 / n stay
         in [-127, 127], so the big collective moves 1 B an element;
      4. the reduced mean gradient is sum(q) s; the new error feedback x -
         q s keeps the n-times coarser grid from biasing the updates.

    Returns (reduced mean-gradient f32 tree, new error-feedback tree).
    ``log`` (``spmd.CollectiveLog``) counts the two collectives' bytes."""
    from .sharding import mesh_axis_size
    from .spmd import mesh_all_reduce

    n = mesh_axis_size(mesh, axis)

    def one(g, e):
        x = g.float() / n + e
        xb, total = _blockify(x, block)
        local_max = torch.amax(torch.abs(xb), dim=1, keepdim=True)
        gmax = mesh_all_reduce(local_max, mesh, axis, op="max", log=log,
                               site="pod-scale-max")
        # the reference divides by the constant 127 / n, which XLA compiles
        # to a product with its f32 reciprocal: so does the port, bit for bit
        scale = torch.clamp(gmax * (1.0 / (127.0 / n)), min=1e-12)
        q = torch.clamp(torch.round(xb / scale), -127.0 / n,
                        127.0 / n).to(torch.int8)
        q_sum = mesh_all_reduce(q, mesh, axis, log=log, site="pod-int8-sum")
        red = (q_sum.float() * scale).reshape(-1)[:total].reshape(g.shape)
        # x - q s as XLA's fused multiply-add gives it, without rounding q s
        # to f32 first: q s is exact in f64 (8 bits by 24 bits)
        deq = (q.double() * scale.double()).reshape(-1)[:total].reshape(g.shape)
        e_new = (x.double() - deq).float()
        return red, e_new

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(error_fb))]
    return (unflatten_like(grads, [r for r, _ in out]),
            unflatten_like(grads, [e for _, e in out]))


def pod_psum_compressed_ref(g_pods, e_pods, *, block: int = 256):
    """:func:`pod_psum_compressed` of one leaf in one process: the pods'
    gradients ``g_pods`` and error feedback ``e_pods`` (lists, one tensor a
    pod) in, the reduced gradient and each pod's new feedback out, by the
    same arithmetic with the two collectives done in place (the max and the
    int8 sum over the list, in pod order)."""
    n = len(g_pods)
    xs, blocks = [], []
    for g, e in zip(g_pods, e_pods):
        x = g.float() / n + e
        xs.append(x)
        blocks.append(_blockify(x, block))
    gmax = torch.stack([torch.amax(torch.abs(xb), dim=1, keepdim=True)
                        for xb, _ in blocks]).amax(dim=0)
    scale = torch.clamp(gmax * (1.0 / (127.0 / n)), min=1e-12)
    qs = [torch.clamp(torch.round(xb / scale), -127.0 / n,
                      127.0 / n).to(torch.int8) for xb, _ in blocks]
    q_sum = torch.stack(qs).sum(dim=0, dtype=torch.int8)
    shape, total = g_pods[0].shape, blocks[0][1]
    red = (q_sum.float() * scale).reshape(-1)[:total].reshape(shape)
    e_new = [(x.double() - (q.double() * scale.double()).reshape(-1)[:total]
              .reshape(shape)).float() for x, q in zip(xs, qs)]
    return red, e_new


__all__ = ["compress_with_feedback", "dequantize_int8", "init_error_feedback",
           "pod_psum_compressed", "pod_psum_compressed_ref",
           "quantization_error", "quantize_int8"]
