"""``lax.while_loop`` on device-resident state, read back every few steps.

The JAX package keeps a whole solve inside one ``lax.while_loop``: the
device runs ``body`` while ``cond`` holds and the host waits once. Here the
loop state is a tuple of tensors on the operator's device and the loop
predicate is a device ``bool`` tensor, ``active``. Every state update of an
iteration goes through ``torch.where(active, new, old)``, so an iteration
enqueued after the stop changes nothing (its counter ``k`` included), and
the host reads ``active`` only once every ``SYNC_EVERY`` iterations, the
first time after ``SYNC_EVERY`` of them. The final state — iteration
count, history buffer, status, best iterate — is therefore the while
loop's exactly; the cost of the sparse reads is at most ``SYNC_EVERY - 1``
iterations computed and thrown away (``SYNC_EVERY`` when the loop has
nothing to do at all). A run of at most ``SYNC_EVERY`` iterations reads
nothing, so it can be captured in a CUDA graph.

``HOST_SYNCS`` counts those reads per loop (``"cg"``, ``"pagerank"``, ...),
as each kernel wrapper's ``launches`` counts its launches: the port's
counterpart of the JAX package's trace counter, which has no meaning
without tracing.
"""
from __future__ import annotations

import collections

import torch

# Measured on an H100 (scripts/solver_probe.py): one iteration enqueues in
# 0.35-1.5 ms of host time against 0.15-0.6 ms on the device, so a read costs
# little beyond the overlap it ends, while every masked iteration costs a whole
# enqueue; reading every 2 iterations was fastest or within noise of it.
SYNC_EVERY = 2

HOST_SYNCS: collections.Counter = collections.Counter()


def while_loop(site: str, cond, body, state: tuple, max_steps: int,
               sync_every: int | None = None) -> tuple:
    """Run ``state = body(state)`` while ``cond(state)`` holds, at most
    ``max_steps`` times; ``cond`` returns a device ``bool`` tensor.

    ``body`` returns a tuple parallel to ``state``; an entry it returns
    unchanged (the same object) is kept without a ``where``. ``max_steps``
    must bound the iterations ``cond`` allows (each solver's ``cond``
    includes ``k < maxiter``), so stopping there reads nothing more.
    ``sync_every`` is the calling solver's own interval where its body
    waits for the device anyway (``None``: ``SYNC_EVERY``).
    """
    every = SYNC_EVERY if sync_every is None else sync_every
    active: torch.Tensor = cond(state)
    for step in range(max_steps):
        if step and step % every == 0:
            HOST_SYNCS[site] += 1
            if not bool(active):  # cblint: disable=CB211 -- the counted read
                break
        new = body(state)
        state = tuple(n if n is o else torch.where(active, n, o) for n, o in zip(new, state))
        active = cond(state)
    return state
