"""Public entry points for the CB-SpMV kernels.

``cb_spmv(streams, x)`` runs the batched super-block execution engine:
x is gathered through each format's ``*_xidx`` (torch indexing with the
int32 indices as stored), each per-format stream becomes at most ONE
kernel launch covering every super-block group of that format (the
paper's "segregated per-format streams" in place of intra-kernel
branching), every kernel writes its per-slot partials into one shared
``(slots, B)`` buffer, and ONE fixed-order combine adds them into y.

``streams`` may be either

  * ``SuperBlockStreams`` (from ``build_super_streams``) — blocks already
    packed into width-bucketed, load-balanced groups at preprocessing
    time; ``group_size`` is baked into the stream, or
  * ``SpMVStreams`` (from ``build_streams``) — the one-block-per-row
    layout. ``group_size=G`` then regroups it with pure reshapes: G rows
    fuse into one group. Regrouping keeps each format's global padding
    width (only the host-side packer can shrink it).

``impl`` selects between the hand-written CUDA kernels (``"cuda"``, the
default) and the plain PyTorch reference (``"reference"``,
``kernels/ref.py``). The entry points run on a CUDA device unless the
caller passes ``device="cpu"``: with no CUDA device present the default
raises ``errors.DeviceUnavailableError``. With ``impl="cuda"`` and CUDA
tensors the kernels are launched, or the call raises — there is no
fallback; with CPU tensors each kernel wrapper takes its plain PyTorch
version (how the CPU tests exercise this module).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import errors
from repro_torch.core.streams import (
    SUBLANE, SpMVStreams, SuperBlockStreams, even_group, resolve_device,
)

from . import cb_block_dense, cb_colagg, cb_coo, cb_combine, ref


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad axis 0 to ``rows`` (ragged tails regroup as inert slots)."""
    return F.pad(t, (0, 0) * (t.ndim - 1) + (0, rows - t.shape[0]))


def _slot_brow(brow_blocks: torch.Tensor, width: int, groups: int) -> torch.Tensor:
    """Expand per-block rows to per-SUBLANE-slot rows (block-major lanes)."""
    per_block = width // SUBLANE
    if groups == 0 or per_block == 0:
        return torch.zeros((groups, 0), dtype=torch.int32, device=brow_blocks.device)
    return brow_blocks.reshape(-1).repeat_interleave(per_block).reshape(groups, -1)


def _regroup(streams: SpMVStreams, G: int) -> SuperBlockStreams:
    """Fuse G one-block rows per super-block row with pure reshapes.

    Padding rows appended to ragged tails carry zero payload and brow 0,
    so they add exact zeros. The lane order of fused panel/coo rows is
    block-major (member g owns lanes [g*K, (g+1)*K)); since the flat
    stream's K is already a SUBLANE multiple, the per-slot brow arrays
    are just each block's row repeated over its K // SUBLANE slots. Each
    format uses its own evened member count.
    """
    B, mb = streams.block_size, streams.mb

    gd, Gd = even_group(streams.num_dense, G)
    d_tiles = _pad_rows(streams.dense_tiles, gd * Gd).reshape(gd, Gd * B, B)
    d_brow = _pad_rows(streams.dense_brow, gd * Gd).reshape(gd, Gd)
    d_xidx = _pad_rows(streams.dense_xidx, gd * Gd).reshape(gd, Gd, B)

    np_, Kp = streams.panel_vals.shape[0], streams.panel_vals.shape[2]
    gp, Gp = even_group(np_, G)
    p_vals = (
        _pad_rows(streams.panel_vals, gp * Gp)
        .reshape(gp, Gp, B, Kp)
        .permute(0, 2, 1, 3)
        .reshape(gp, B, Gp * Kp)
    )
    p_xidx = _pad_rows(streams.panel_xidx, gp * Gp).reshape(gp, Gp * Kp)
    p_brow = _slot_brow(_pad_rows(streams.panel_brow, gp * Gp), Kp, gp)

    nc, Ep = streams.coo_codes.shape
    gc, Gc = even_group(nc, G)
    c_codes = _pad_rows(streams.coo_codes, gc * Gc).reshape(gc, Gc * Ep)
    c_vals = _pad_rows(streams.coo_vals, gc * Gc).reshape(gc, Gc * Ep)
    c_xidx = _pad_rows(streams.coo_xidx, gc * Gc).reshape(gc, Gc * Ep)
    c_brow = _slot_brow(_pad_rows(streams.coo_brow, gc * Gc), Ep, gc)

    return SuperBlockStreams(
        block_size=B, m=streams.m, n=streams.n, mb=mb,
        colagg_applied=streams.colagg_applied, group_size=G,
        dense_tiles=d_tiles, dense_brow=d_brow, dense_xidx=d_xidx,
        panel_vals=p_vals, panel_brow=p_brow, panel_xidx=p_xidx,
        coo_codes=c_codes, coo_vals=c_vals, coo_brow=c_brow,
        coo_xidx=c_xidx,
    )


def _resolve_plan(streams, plan, group_size):
    """Fold an autotune ``Plan`` into the effective ``group_size``.

    Duck-typed (any object with ``block_size``/``group_size``) so this
    module never imports the autotune package. The plan's block size
    must match the streams it is applied to; an explicit conflicting
    ``group_size`` is an error, matching the SuperBlockStreams contract.
    """
    if plan is None:
        return group_size
    if plan.block_size != streams.block_size:
        raise errors.InvalidArgError(
            f"plan was made for block_size={plan.block_size}; "
            f"streams carry block_size={streams.block_size}"
        )
    if group_size is not None and group_size != plan.group_size:
        raise errors.InvalidArgError(
            f"plan chose group_size={plan.group_size}; conflicting "
            f"explicit group_size={group_size}"
        )
    return plan.group_size


def _check_group_size(streams, group_size) -> None:
    """Shared argument contract of ``cb_spmv`` / ``cb_spmv_into``."""
    if group_size is not None and group_size < 1:
        raise errors.InvalidArgError(f"group_size must be >= 1, got {group_size}")
    if isinstance(streams, SuperBlockStreams):
        if group_size is not None and group_size != streams.group_size:
            raise errors.InvalidArgError(
                f"stream was packed with group_size={streams.group_size}; "
                f"cannot re-batch to {group_size} post hoc"
            )


def spmv_launch_stats(
    streams: SpMVStreams | SuperBlockStreams, group_size: int | None = None
) -> dict:
    """Per-format groups / padded elements one ``cb_spmv`` call runs.

    Pure shape arithmetic: for a packed ``SuperBlockStreams`` the
    geometry is read off directly; for a flat ``SpMVStreams`` +
    ``group_size`` it replicates ``_regroup``'s ``even_group`` padding
    arithmetic without building anything — tested equal to the
    actually-regrouped stream. ``launches`` counts the per-format kernel
    launches the batched engine makes: one per non-empty format (the
    combine's launches are counted on its own wrapper).
    """
    B = streams.block_size
    if isinstance(streams, SuperBlockStreams):
        G = streams.group_size
        steps = {"dense": streams.num_dense_groups,
                 "panel": streams.num_panel_groups,
                 "coo": streams.num_coo_groups}
        padded = streams.padded_work()
    else:
        G = int(group_size or 1)
        gd, Gd = even_group(streams.num_dense, G)
        gp, Gp = even_group(streams.num_panel, G)
        gc, Gc = even_group(streams.num_coo, G)
        Kp = streams.panel_vals.shape[2]
        Ep = streams.coo_codes.shape[1]
        steps = {"dense": gd, "panel": gp, "coo": gc}
        padded = {"dense": gd * Gd * B * B, "panel": gp * B * Gp * Kp,
                  "coo": gc * Gc * Ep}
    steps = {k: int(v) for k, v in steps.items()}
    padded = {k: int(v) for k, v in padded.items()}
    return {
        "group_size": int(G),
        "steps": steps,
        "padded": padded,
        "launches": {k: int(steps[k] > 0) for k in steps},
        "steps_total": sum(steps.values()),
        "padded_total": sum(padded.values()),
    }


# ---------------------------------------------------------------------------
# The batched engine: gather -> <=1 kernel per format -> one combine.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Prepared:
    """What ``cb_spmv`` derives from a stream once and keeps on it."""

    sup: SuperBlockStreams
    brow: torch.Tensor                          # (T,) int32, dense|panel|coo slots
    combine: cb_combine.CombinePlan | None      # fixed summation order (CUDA only)


def _prepare(streams, group_size) -> _Prepared:
    """Regroup (flat streams) and fix the combine order, cached on ``streams``.

    Both depend only on the stream's block rows and shapes, so they are
    computed on first use and reused by every later call on the same
    stream object — the sort behind the combine plan runs on the host.
    """
    key = None if isinstance(streams, SuperBlockStreams) else int(group_size or 1)
    cache = streams.__dict__.setdefault("_prepared", {})
    if key not in cache:
        sup = streams if key is None else _regroup(streams, key)
        brow = torch.cat([sup.dense_brow.reshape(-1), sup.panel_brow.reshape(-1),
                          sup.coo_brow.reshape(-1)])
        plan = (cb_combine.plan_combine(brow, brow.device)
                if brow.device.type == "cuda" and brow.numel() else None)
        cache[key] = _Prepared(sup=sup, brow=brow, combine=plan)
    return cache[key]


def _gather(x: torch.Tensor, xidx: torch.Tensor) -> torch.Tensor:
    """x[xidx] with the int32 indices as stored (no int64 copy of the stream)."""
    return torch.index_select(x, 0, xidx.reshape(-1)).reshape(xidx.shape)


def _accumulate(y: torch.Tensor, prep: _Prepared, x: torch.Tensor) -> torch.Tensor:
    """y += A @ x in place: gather, one kernel per present format, combine."""
    s = prep.sup
    B = s.block_size
    x32 = x.to(torch.float32)
    parts = torch.empty((prep.brow.numel(), B), dtype=torch.float32, device=y.device)
    nd, npn = s.dense_brow.numel(), s.panel_brow.numel()
    if s.num_dense_groups:
        cb_block_dense.block_dense_spmv_batched(
            s.dense_tiles, _gather(x32, s.dense_xidx),
            out=parts[:nd].view(s.dense_xidx.shape))
    if s.num_panel_groups:
        cb_colagg.panel_spmv_batched(
            s.panel_vals, _gather(x32, s.panel_xidx),
            out=parts[nd:nd + npn].view(*s.panel_brow.shape, B))
    if s.num_coo_groups:
        cb_coo.coo_spmv_batched(
            s.coo_codes, s.coo_vals, _gather(x32, s.coo_xidx), block_size=B,
            out=parts[nd + npn:].view(*s.coo_brow.shape, B))
    return cb_combine.segment_combine(y, parts, prep.brow, B, prep.combine)


def _enter(streams, x, impl, group_size, plan, device):
    """Validate a call; return (x on the call's device, effective group size)."""
    group_size = _resolve_plan(streams, plan, group_size)
    _check_group_size(streams, group_size)
    if impl not in ("cuda", "reference"):
        raise errors.InvalidArgError(f"unknown impl {impl!r}")
    dev = resolve_device(device)
    if streams.device.type != dev.type:
        raise errors.InvalidArgError(
            f"streams live on {streams.device} but the call runs on {dev}; "
            f"move them first with streams.to({dev.type!r})")
    x = torch.as_tensor(x, device=streams.device)
    if x.shape != (streams.n,):
        raise errors.InvalidArgError(f"x has shape {tuple(x.shape)}, expected ({streams.n},)")
    return x, group_size


def cb_spmv(
    streams: SpMVStreams | SuperBlockStreams,
    x: torch.Tensor,
    *,
    impl: str = "cuda",
    group_size: int | None = None,
    plan=None,
    device=None,
) -> torch.Tensor:
    """y = A @ x over the CB streams. x: (n,) -> y: (m,).

    ``device`` is where the call runs: ``None`` means CUDA (raising
    ``errors.DeviceUnavailableError`` when none is present), ``"cpu"``
    the CPU. The streams must already live there (``streams.to(device)``);
    ``x`` is moved if need be.

    ``group_size`` only applies to ``SpMVStreams`` input: blocks are
    fused G per group via ``_regroup``. ``SuperBlockStreams`` carry their
    group size from the host-side packer; passing a conflicting value is
    an error. ``plan`` (an autotune ``Plan``, duck-typed) supplies the
    group size the planner chose — it must agree with both an explicit
    ``group_size`` and a packed stream's.

    ``impl="cuda"`` returns float32 whatever the payload dtype (the
    kernels accumulate in float32). ``impl="reference"`` stays an
    *independent* oracle: it consumes the stream layout as given (no
    regrouping) and accumulates in the promoted dtype, so batched kernel
    results are always checked against math that never touched the
    batching code.

    The regrouped layout and the combine's fixed summation order are
    derived on the first call and cached on the stream object. Two calls
    with the same inputs return the same bits.
    """
    x, group_size = _enter(streams, x, impl, group_size, plan, device)
    if impl == "reference":
        if isinstance(streams, SuperBlockStreams):
            return ref.super_spmv(streams, x)
        return ref.cb_spmv(streams, x)
    y = torch.zeros(streams.m, dtype=torch.float32, device=x.device)
    return _accumulate(y, _prepare(streams, group_size), x)


def cb_spmv_into(
    y_acc: torch.Tensor,
    streams: SpMVStreams | SuperBlockStreams,
    x: torch.Tensor,
    *,
    impl: str = "cuda",
    group_size: int | None = None,
    plan=None,
    device=None,
) -> torch.Tensor:
    """``y_acc += A @ x`` **in place**; returns ``y_acc``.

    The iterative-solver pattern: the same ``y`` buffer is reused across
    thousands of matvecs. The JAX package donates the accumulator so XLA
    can alias the output onto it; here the in-place accumulate into the
    caller's own ``(m,)`` float32 buffer takes the place of donation —
    no buffer is allocated for y, and the caller keeps using ``y_acc``.
    Other arguments as in :func:`cb_spmv`.
    """
    x, group_size = _enter(streams, x, impl, group_size, plan, device)
    if y_acc.shape != (streams.m,) or y_acc.device != x.device:
        raise errors.InvalidArgError(
            f"y_acc must be ({streams.m},) on {x.device}, got "
            f"{tuple(y_acc.shape)} on {y_acc.device}")
    if impl == "reference":
        sub = ref.super_spmv if isinstance(streams, SuperBlockStreams) else ref.cb_spmv
        return y_acc.add_(sub(streams, x))
    if y_acc.dtype != torch.float32 or not y_acc.is_contiguous():
        raise errors.InvalidArgError(
            "y_acc must be a contiguous float32 tensor for impl='cuda'")
    return _accumulate(y_acc, _prepare(streams, group_size), x)
