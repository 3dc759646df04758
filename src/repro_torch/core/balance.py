"""Inter-thread-block load balancing (paper §3.4, Alg. 2).

A min-heap keyed on accumulated nnz assigns sub-blocks (largest first) to
(thread-block, warp-slot) pairs so every thread block processes the same
NUMBER of sub-blocks while the total NNZ per thread block is near-equal.
The block-COO high-level metadata then gets permuted once — enabled by the
independence property of the 2D structure.

Two deployments of the same algorithm:

  * ``tb_load_balance``    — the paper's: slots = thread blocks x warps.
  * ``grid_group_balance`` — the stream packer's: slots = the blocks one
    stream row (one kernel group) carries.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass
class BalanceResult:
    """Permutation produced by the balancer.

    ``slots[s]`` = original block index occupying slot ``s`` (or -1 pad).
    ``perm`` = slots with -1 kept (length = num_groups * group_size).
    ``group_loads[g]`` = total nnz assigned to group g.
    """

    slots: np.ndarray
    group_loads: np.ndarray
    num_groups: int
    group_size: int

    @property
    def load_std(self) -> float:
        return float(np.std(self.group_loads))

    @property
    def load_imbalance(self) -> float:
        """max/mean load ratio (1.0 = perfect)."""
        mean = self.group_loads.mean() if len(self.group_loads) else 0.0
        return float(self.group_loads.max() / mean) if mean > 0 else 1.0


def _heap_assign(nnz_per_blk: np.ndarray, num_groups: int, group_size: int) -> BalanceResult:
    """Alg. 2: sort desc by nnz; repeatedly give next block to the least
    loaded group that still has a free slot."""
    nnz = np.asarray(nnz_per_blk, dtype=np.int64)
    order = np.argsort(-nnz, kind="stable")
    slots = [-1] * (num_groups * group_size)
    loads = [0] * num_groups
    # heap entries: (load, group_id, used_slots); the group id makes every
    # entry distinct, so the pop order is a function of the entries alone.
    heap = [(0, g, 0) for g in range(num_groups)]
    # plain Python ints keep the inner loop out of numpy scalar arithmetic
    for blk, w in zip(order.tolist(), nnz[order].tolist()):
        load, gid, used = heap[0]
        slots[gid * group_size + used] = blk
        load += w
        loads[gid] = load
        if used + 1 < group_size:
            heapq.heapreplace(heap, (load, gid, used + 1))
        else:
            heapq.heappop(heap)
    slots = np.asarray(slots, dtype=np.int64)
    loads = np.asarray(loads, dtype=np.int64)
    return BalanceResult(slots=slots, group_loads=loads, num_groups=num_groups, group_size=group_size)


def tb_load_balance(nnz_per_blk: np.ndarray, warps_per_tb: int = 8) -> BalanceResult:
    """Paper Alg. 2: one warp per sub-block, ``warps_per_tb`` warps per TB."""
    nblk = len(nnz_per_blk)
    num_tb = max(1, -(-nblk // warps_per_tb))
    return _heap_assign(nnz_per_blk, num_tb, warps_per_tb)


def grid_group_balance(load_per_blk: np.ndarray, group_size: int) -> BalanceResult:
    """Alg. 2 at *group* granularity (the batched execution engine).

    A "group" is the set of sub-blocks one stream row carries (the
    paper's thread block). Each group holds at most
    ``group_size`` blocks; the heap hands the heaviest remaining block to
    the lightest group, so the per-step loads come out near-equal.

    ``load_per_blk`` is whatever each block costs the step: nnz for dense
    tiles (uniform-shape groups, cache balance), or the *padded payload
    width* for panel/COO groups — there the array width every group stores is
    ``max_g sum(widths in g)``, so equalizing summed width across groups
    directly minimizes the padding the widest group forces on the rest.
    """
    nblk = len(load_per_blk)
    num_groups = max(1, -(-nblk // group_size))
    return _heap_assign(load_per_blk, num_groups, group_size)


def apply_balance(result: BalanceResult, *metadata: np.ndarray, pad_values=None):
    """Permute parallel metadata arrays into slot order.

    Empty slots get ``pad_values[k]`` (default 0). Returns a tuple of
    arrays of length num_groups * group_size.
    """
    out = []
    for k, arr in enumerate(metadata):
        pad = 0 if pad_values is None else pad_values[k]
        dest = np.full(len(result.slots), pad, dtype=np.asarray(arr).dtype)
        mask = result.slots >= 0
        dest[mask] = np.asarray(arr)[result.slots[mask]]
        out.append(dest)
    return tuple(out)
