"""Device-level CB-SpMV: the paper's load balancer, scaled to a mesh axis.

The port of ``repro.core.distributed``. The paper balances sub-blocks
across thread blocks (8 warp slots each); here the same min-heap algorithm
balances sub-blocks across the ranks of the ``model`` mesh axis
(``balance.device_load_balance``). Equal block count per rank gives
uniform shard shapes and near-equal nnz gives near-equal work: the
straggler story at mesh scale.

Pipeline:
  1. ``shard_streams``   (host) — pq-assign blocks to ranks, build one
     ``SpMVStreams`` per rank, pad every stream to the largest per-rank
     shape with zero blocks, stack into leading-axis-``D`` tensors (the
     reference's arrays, byte for byte).
  2. ``distributed_spmv`` — over a ``torch.distributed`` ``DeviceMesh``:
     each rank runs ``ops.cb_spmv`` (the CUDA kernels and the combine) on
     its own shard against a replicated x, on its own card and current
     stream, then one collective over the axis's process group combines
     the partial y: ``all_reduce`` (``"psum"``) or ``reduce_scatter_tensor``
     (``"psum_scatter"``), the counterparts of the reference's ``psum`` /
     ``psum_scatter`` under ``shard_map``.

x stays replicated (SpMV x is tiny relative to the matrix); y combine is
one collective — the communication-minimal schedule for 1D row-partitioned
SpMV.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import errors
from repro_torch.kernels import ops

from . import balance
from .cb_matrix import CBMatrix
from .streams import _STREAM_FIELDS, SpMVStreams, build_streams, resolve_device


def _pad_axis0(arr: np.ndarray, target: int) -> np.ndarray:
    if arr.shape[0] == target:
        return arr
    pad = np.zeros((target - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _pad_axis_last(arr: np.ndarray, target: int) -> np.ndarray:
    if arr.shape[-1] == target:
        return arr
    widths = [(0, 0)] * (arr.ndim - 1) + [(0, target - arr.shape[-1])]
    return np.pad(arr, widths)


@dataclasses.dataclass(eq=False)
class ShardedStreams:
    """Per-device SpMV streams stacked on a leading device axis.

    The static fields of ``streams`` (``m``, ``n``, ``mb``,
    ``colagg_applied``) are shard 0's, as the reference's ``tree_map``
    keeps them; its block counts (``num_dense`` ...) read the stacked
    axis, so take a rank's streams with ``shard`` before counting blocks.
    """

    num_devices: int
    streams: SpMVStreams      # every tensor has leading dim D
    device_nnz: np.ndarray    # (D,) achieved nnz per device (diagnostics)

    @property
    def load_imbalance(self) -> float:
        mean = self.device_nnz.mean()
        return float(self.device_nnz.max() / mean) if mean > 0 else 1.0

    def shard(self, d: int) -> SpMVStreams:
        """Rank ``d``'s streams (views of the stacked tensors, on their device)."""
        return dataclasses.replace(
            self.streams, **{f: getattr(self.streams, f)[d] for f in _STREAM_FIELDS})

    def local(self, d: int, device: torch.device) -> SpMVStreams:
        """Rank ``d``'s streams on ``device``, moved on first use and kept, so
        the copy and ``ops.cb_spmv``'s per-stream preparation (regroup, the
        combine's order) happen once, as for a single-device stream."""
        cache = self.__dict__.setdefault("_local", {})
        key = (int(d), device)
        if key not in cache:
            cache[key] = self.shard(d).to(device)
        return cache[key]


def shard_streams(cb: CBMatrix, num_devices: int) -> ShardedStreams:
    """pq-balance CB blocks across devices and build uniform stacked streams."""
    if num_devices < 1:
        raise errors.InvalidArgError(f"num_devices must be >= 1, got {num_devices}")
    real_idx = np.flatnonzero(cb.nnz_per_blk > 0)
    result = balance.device_load_balance(cb.nnz_per_blk[real_idx], num_devices)

    per_dev: list[SpMVStreams] = []
    for d in range(num_devices):
        slots = result.slots[d * result.group_size : (d + 1) * result.group_size]
        per_dev.append(build_streams(_sub_matrix(cb, real_idx[slots[slots >= 0]])))

    # Uniform shapes: pad block counts and inner pads to the per-axis max.
    nd = max(s.num_dense for s in per_dev)
    np_ = max(s.num_panel for s in per_dev)
    nc = max(s.num_coo for s in per_dev)
    Kp = max(s.panel_vals.shape[2] for s in per_dev)
    Ep = max(s.coo_codes.shape[1] for s in per_dev)
    rows = {"dense_tiles": nd, "dense_brow": nd, "dense_xidx": nd,
            "panel_vals": np_, "panel_brow": np_, "panel_xidx": np_,
            "coo_codes": nc, "coo_vals": nc, "coo_brow": nc, "coo_xidx": nc}
    lanes = {"panel_vals": Kp, "panel_xidx": Kp, "coo_codes": Ep, "coo_vals": Ep,
             "coo_xidx": Ep}

    def padded(s: SpMVStreams, f: str) -> np.ndarray:
        a = getattr(s, f).numpy()
        if f in lanes:
            a = _pad_axis_last(a, lanes[f])
        return _pad_axis0(a, rows[f])

    stacked = dataclasses.replace(per_dev[0], **{
        f: torch.from_numpy(np.stack([padded(s, f) for s in per_dev]))
        for f in _STREAM_FIELDS})
    return ShardedStreams(num_devices=num_devices, streams=stacked,
                          device_nnz=result.group_loads.copy())


def _sub_matrix(cb: CBMatrix, block_slots: np.ndarray) -> CBMatrix:
    """A view-style CBMatrix restricted to the given metadata slots: the
    payload stays whole, and ``vp_per_blk`` keeps pointing into it."""
    return dataclasses.replace(
        cb,
        blk_row_idx=cb.blk_row_idx[block_slots],
        blk_col_idx=cb.blk_col_idx[block_slots],
        nnz_per_blk=cb.nnz_per_blk[block_slots],
        type_per_blk=cb.type_per_blk[block_slots],
        vp_per_blk=cb.vp_per_blk[block_slots],
        nnz=int(cb.nnz_per_blk[block_slots].sum()),
    )


def _placements(mesh, axis: str) -> list:
    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def distributed_spmv(
    sharded: ShardedStreams,
    x: torch.Tensor,
    mesh,
    axis: str = "model",
    *,
    impl: str = "cuda",
    device=None,
    combine: str = "psum_scatter",
) -> torch.Tensor:
    """y = A @ x with A's blocks pq-balanced over ``axis``; x replicated.

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` whose
    ``mesh_dim_names`` hold ``axis``, of size ``sharded.num_devices``; every
    rank of the axis's group calls this with the same ``sharded`` and ``x``.
    The rank runs ``ops.cb_spmv(impl=impl)`` on shard
    ``mesh.get_local_rank(axis)`` on ``device`` (default: CUDA, the current
    card; ``"cpu"`` for the plain reference path under gloo).

    ``combine`` picks the partial-y reduction:

      * ``"psum_scatter"`` (default) — y padded to a multiple of D and
        reduce-scattered: each rank keeps only its y shard, so the combine
        moves ``m`` elements per rank instead of ``D * m``. When D divides
        ``m`` the result is a ``DTensor`` sharded over ``axis``
        (``Shard(0)``); with a ragged tail it is the gathered ``y[:m]``,
        as the reference's slice re-gathers the last shard.
      * ``"psum"`` — ``all_reduce``: a replicated tensor of length ``m``.
    """
    if combine not in ("psum", "psum_scatter"):
        raise errors.InvalidArgError(f"unknown combine {combine!r}")
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise errors.InvalidArgError(f"mesh has no axis {axis!r}: {names}")
    D, ranks = sharded.num_devices, mesh.size(names.index(axis))
    if ranks != D:
        raise errors.InvalidArgError(
            f"streams are sharded {D} ways, mesh axis {axis!r} has {ranks} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    local = sharded.local(mesh.get_local_rank(axis), dev)
    y = ops.cb_spmv(local, x, impl=impl, device=dev)
    group = mesh.get_group(axis)
    if combine == "psum":
        dist.all_reduce(y, group=group)
        return y
    m = sharded.streams.m
    m_pad = -(-m // D) * D          # reduce-scatter needs an axis divisible by D
    out = torch.empty(m_pad // D, dtype=y.dtype, device=dev)
    dist.reduce_scatter_tensor(out, y if m == m_pad else F.pad(y, (0, m_pad - m)),
                               group=group)
    if m == m_pad:                  # still sharded over ``axis``
        return DTensor.from_local(out, mesh, _placements(mesh, axis), run_check=False,
                                  shape=torch.Size([m_pad]), stride=(1,))
    # ragged tail: gather, then cut the padding (the c10d collective, which
    # gloo serves on CUDA tensors too, where DTensor's full_tensor() fails)
    full = torch.empty(m_pad, dtype=y.dtype, device=dev)
    dist.all_gather_into_tensor(full, out, group=group)
    return full[:m]
