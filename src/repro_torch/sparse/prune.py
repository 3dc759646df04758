"""Block-structured magnitude pruning — produces CB-shaped weight sparsity.

Whole B x B blocks are kept or dropped by Frobenius norm, so the surviving
weight is exactly the block-sparse structure the CB kernels consume. This
is how the paper's technique becomes a training/serving feature rather
than a standalone kernel demo.

``refreeze_spec`` makes the pattern periodically dynamic: every k training
steps the block mask is recomputed from the current tile magnitudes. A
mask-stable refreeze returns the SAME spec object — the matmul cache in
``linear.py`` keys on spec identity, so its device metadata and combine
plans survive every step on which the structure did not drift.

Masks are bit-equal to the JAX package's (``src/repro/sparse/prune.py``);
the per-row coverage loop there is one array operation here.
"""
from __future__ import annotations

import numpy as np
import torch


def _cover_rows(mask: np.ndarray, norms: np.ndarray) -> None:
    """Keep each empty block row's largest block, in place (row coverage)."""
    empty = np.flatnonzero(~mask.any(axis=1))
    mask[empty, np.argmax(norms[empty], axis=1)] = True


def block_sparsity_pattern(
    w: np.ndarray, block_size: int, keep_fraction: float
) -> np.ndarray:
    """Boolean (mb, nb) mask of surviving blocks (top-|keep| by Fro norm)."""
    m, n = w.shape
    B = block_size
    mb, nb = -(-m // B), -(-n // B)
    wp = np.zeros((mb * B, nb * B), dtype=w.dtype)
    wp[:m, :n] = w
    norms = np.square(
        wp.reshape(mb, B, nb, B).transpose(0, 2, 1, 3)
    ).sum(axis=(2, 3))
    keep = max(1, int(round(keep_fraction * mb * nb)))
    thresh = np.partition(norms.reshape(-1), -keep)[-keep]
    mask = norms >= thresh
    # Tie-breaking can keep a few extra blocks; trim deterministically.
    extra = int(mask.sum()) - keep
    if extra > 0:
        flat = np.flatnonzero(mask.reshape(-1))
        order = np.argsort(norms.reshape(-1)[flat], kind="stable")
        mask.reshape(-1)[flat[order[:extra]]] = False
    # Every block row keeps >= 1 block (a non-dead output row).
    _cover_rows(mask, norms)
    return mask


def block_magnitude_prune(
    w: np.ndarray, block_size: int, keep_fraction: float
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (pruned dense weight, block mask)."""
    m, n = w.shape
    B = block_size
    mask = block_sparsity_pattern(w, block_size, keep_fraction)
    full = np.repeat(np.repeat(mask, B, axis=0), B, axis=1)[:m, :n]
    return w * full, mask


# ---------------------------------------------------------------------------
# Mask refreeze: periodically re-derive the block pattern during training.
# ---------------------------------------------------------------------------

def refreeze_due(step: int, every_k: int) -> bool:
    """Whether a mask refreeze fires on this (0-based) training step."""
    return every_k > 0 and step > 0 and step % every_k == 0


def refreeze_spec(params, spec, *, keep_fraction: float | None = None):
    """Recompute the block mask from current magnitudes; rebuild only on drift.

    Returns ``(params, spec, changed)``. When the freshly pruned mask
    equals the spec's mask, the ORIGINAL ``params`` and ``spec`` objects
    come back untouched (``changed=False``). On drift, a new spec is built
    through ``spec_from_mask`` and the surviving tile values are carried
    over (newly admitted blocks start at zero). The magnitudes are read on
    the host; bfloat16 tiles are read as float32 there (numpy has no
    bfloat16).
    """
    from . import linear as _linear  # lazy: linear imports prune at load

    kf = spec.keep_fraction if keep_fraction is None else keep_fraction
    tiles = params["tiles"]
    w = _linear.dense_equivalent(params, spec).detach().cpu()
    if w.dtype == torch.bfloat16:
        w = w.float()
    a = w.numpy().T                                   # (out, in)
    new_mask = block_sparsity_pattern(a, spec.block_size, kf)
    if np.array_equal(new_mask, _linear.spec_block_mask(spec)):
        return params, spec, False
    new_spec = _linear.spec_from_mask(
        new_mask, spec.in_features, spec.out_features,
        block_size=spec.block_size, keep_fraction=kf,
    )
    new_params = dict(params)
    new_params["tiles"] = torch.from_numpy(
        np.ascontiguousarray(_linear.gather_tiles(a, new_spec))
    ).to(device=tiles.device, dtype=tiles.dtype)
    return new_params, new_spec, True


def refreeze_training_step(
    params,
    ef,
    spec,
    x,
    y,
    *,
    step: int,
    every_k: int,
    lr: float = 1e-2,
    keep_fraction: float | None = None,
    impl: str = "cuda",
    group_size: int | None = None,
    plan=None,
):
    """One EF-int8-compressed SGD step with mask refreeze every ``every_k``.

    The dynamic-sparsity training hook of the reference
    (``src/repro/sparse/prune.py``): the mean squared error of
    ``cb_linear_apply(params, spec, x)`` against ``y``, its tile gradient
    through the int8 error-feedback wire format
    (``training.grad_compression.ef_compress_grads``), plain SGD on the tile
    stream, and on refreeze steps the mask re-derived from the updated
    magnitudes. A mask-stable step keeps the exact same spec (and with it
    the layer's cached device state and combine plans); a drifted mask
    rebuilds the spec and resets the EF buffers to the new tile shapes.
    ``params`` and ``ef`` are ``{"tiles": tensor}``; the product runs on the
    tiles' device with ``impl`` (``"cuda"``: the kernel on a CUDA tensor,
    its plain version on a CPU one).

    Returns ``(params, ef, spec, loss, changed)``.
    """
    from repro_torch.training import grad_compression as _gc

    from . import linear as _linear

    tiles = params["tiles"].detach().requires_grad_(True)
    pred = _linear.cb_linear_apply({"tiles": tiles}, spec, x, impl=impl, group_size=group_size,
                                   plan=plan, device=tiles.device)
    loss = torch.mean((pred.to(torch.float32) - y.to(torch.float32)) ** 2)
    (g,) = torch.autograd.grad(loss, [tiles])
    grads, ef = _gc.ef_compress_grads({"tiles": g}, ef)
    params = {k: (p - lr * grads[k].to(p.dtype)).detach() for k, p in params.items()}
    changed = False
    if refreeze_due(step, every_k):
        params, spec, changed = refreeze_spec(params, spec, keep_fraction=keep_fraction)
        if changed:
            ef = _gc.init_ef_buffers(params)
    return params, ef, spec, loss.detach(), changed
