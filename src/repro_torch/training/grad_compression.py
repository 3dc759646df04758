"""int8 error-feedback gradient compression.

The port of ``repro.training.grad_compression``
(``src/repro/training/grad_compression.py``): before the cross-pod gradient
sum, gradients are quantized to int8 with a per-tensor scale; the
quantization error is kept in a local error-feedback (EF) buffer and added
back into the next step's gradient, the standard EF-SGD recipe that keeps
compressed training convergent.

Here are the building blocks, the single-process round trip
(``ef_compress_grads``, the wire format without the sum), which the train
loop's ``compression="int8_ef"`` and ``sparse.prune.refreeze_training_step``
use, and ``compressed_cross_pod_sum``, the sum over the ``pod`` axis of a
``torch.distributed`` mesh. Both ``jnp.round`` and ``torch.round`` round
half to even, so the int8 codes are bit-equal to the reference's.

Gradient lists are lists of tensors in one order (a model's
``parameters()``), as in ``training.optimizer``. The reference quantizes
each leaf of its parameter tree with one scale, and stacks each layer
leaf over the layers; the port holds such a leaf as one tensor per layer,
so ``ef_quantize_stacked`` takes one scale over all of them. On a mesh
the leaf's tensors are ``DTensor``s: the scale is that of the whole leaf,
its ``amax`` taken over every shard (a MAX over the axes the leaf is split
on), so the codes are the one-rank run's, bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import errors
from repro_torch.models import sharding as S
from repro_torch.models.sharding import active_mesh


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0, 1.0)


def _codes(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    xf = x.to(torch.float32)
    scale = _scale(torch.max(torch.abs(xf)))
    return _codes(xf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_quantize(grad: torch.Tensor, ef: torch.Tensor):
    """Quantize (grad + ef); return (q, scale, new_ef)."""
    target = grad.to(torch.float32) + ef
    q, scale = quantize_int8(target)
    new_ef = target - dequantize_int8(q, scale)
    return q, scale, new_ef


def ef_quantize_stacked(grads: list, efs: list):
    """``ef_quantize`` of one leaf held as several tensors (a layer-stacked
    leaf, one tensor per layer) under one scale: (qs, scale, new_efs), the
    codes and EF buffers of each tensor's local shard where the tensors are
    ``DTensor``s (their ``amax`` over the mesh axes they are split on)."""
    split = S.sharded_axes(grads[0]) if isinstance(grads[0], DTensor) else ()
    mesh = grads[0].device_mesh if split else None
    grads = [g.to_local() if isinstance(g, DTensor) else g for g in grads]
    efs = [e.to_local() if isinstance(e, DTensor) else e for e in efs]
    targets = [g.to(torch.float32) + e for g, e in zip(grads, efs)]
    amax = torch.stack([torch.max(torch.abs(t)) for t in targets]).max()
    for a in split:
        amax = S.all_reduce(amax, mesh, a, op=dist.ReduceOp.MAX)
    scale = _scale(amax)
    qs = [_codes(t, scale) for t in targets]
    return qs, scale, [t - dequantize_int8(q, scale) for t, q in zip(targets, qs)]


def compressed_cross_pod_sum(grads, ef_buffers, axis_name: str = "pod", *, mesh=None):
    """EF-int8 sum over the ranks of ``axis_name`` for a list (or dict) of grads.

    Every rank of the axis calls it with its own grads and EF buffers.
    ``mesh`` (a ``DeviceMesh`` holding ``axis_name``) defaults to the one
    active under ``models.sharding.axis_rules``. Per leaf: the shared scale
    from an ``all_reduce(MAX)`` of the local ``amax`` (so the integer sum is
    well-defined), the int8 codes, their ``all_reduce(SUM)`` as int32 (exact:
    pod counts are small; the wire format is the int8 payload), dequantized
    with the shared scale. Returns ``(summed, new_ef)``: the sums in each
    grad's dtype, the new EF buffers in float32.
    """
    mesh = active_mesh() if mesh is None else mesh
    if mesh is None:
        raise errors.InvalidArgError(
            "compressed_cross_pod_sum needs a mesh: pass mesh= or call it under axis_rules")
    if axis_name not in tuple(mesh.mesh_dim_names or ()):
        raise errors.InvalidArgError(f"mesh has no axis {axis_name!r}: {mesh.mesh_dim_names}")
    if isinstance(grads, dict):
        out = compressed_cross_pod_sum(list(grads.values()), [ef_buffers[k] for k in grads],
                                       axis_name, mesh=mesh)
        return dict(zip(grads, out[0])), dict(zip(grads, out[1]))
    group = mesh.get_group(axis_name)

    def one(g, ef):
        target = g.to(torch.float32) + ef
        amax = torch.max(torch.abs(target))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = _scale(amax)
        q = _codes(target, scale)
        new_ef = target - dequantize_int8(q, scale)
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        return (summed.to(torch.float32) * scale).to(g.dtype), new_ef

    out = [one(g, e) for g, e in zip(grads, ef_buffers, strict=True)]
    return [s for s, _ in out], [e for _, e in out]


def ef_compress_grads(grads, ef_buffers):
    """Single-process EF-int8 round trip: the wire format without the psum.

    Each gradient passes through the int8 quantize/dequantize of the
    cross-pod path, with its error-feedback buffer absorbing the rounding
    error. Returns ``(decompressed_grads, new_ef_buffers)``, lists (or, for
    dicts of tensors, dicts) in the order given, grads in their own dtype.
    """
    if isinstance(grads, dict):
        out = ef_compress_grads(list(grads.values()), [ef_buffers[k] for k in grads])
        return dict(zip(grads, out[0])), dict(zip(grads, out[1]))
    qs = [ef_quantize(g, e) for g, e in zip(grads, ef_buffers)]
    return ([dequantize_int8(q, s).to(g.dtype) for (q, s, _), g in zip(qs, grads)],
            [e for _, _, e in qs])


def init_ef_buffers(params):
    """float32 zeros shaped (and, on a mesh, placed) like each parameter (a
    list, or a dict for a dict)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    if isinstance(params, dict):
        return {k: zeros(p) for k, p in params.items()}
    return [zeros(p) for p in params]
