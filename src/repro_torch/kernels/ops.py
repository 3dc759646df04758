"""Public entry points for the CB-SpMV and CB-SpMM kernels.

``cb_spmv(streams, x)`` runs the batched super-block execution engine:
x is gathered through the dense and panel formats' ``*_xidx`` (torch
indexing with the int32 indices as stored; the COO kernel reads x through
``coo_xidx`` itself), each per-format stream becomes at most ONE
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

After a successful dispatch each entry point records its launch
accounting (``repro.ops.{spmv,spmv_into,spmm}.*``, the JAX package's
metric names) in ``repro_torch.obs``; with obs disabled that is one
boolean check, and results are bit-identical either way. ``cb_spmv`` and
``cb_spmv_into`` count every kernel a call launches, beyond the JAX
package's series: ``launches{format=gather}`` (one x gather per present
dense or panel format, recorded as 0 where there is none),
``{format=combine}`` (the combine's passes) and, for ``cb_spmv``,
``{format=fill}`` (y's zero-fill). Each runs under one ``obs`` span of its
own name, which a recording ``torch.profiler`` also sees. They also record
``compact_elems{format=panel}``: the value slots the bitmap panel kernel
read (0 on the CPU path, or without a panel).

On CUDA tensors the panel format runs on the bitmap encoding of the panels
(``cb_colagg.compact_panels``): derived from the stream's own payload on its
first call, or handed over by a value updater, which scatters fresh values
straight into it. For finite x the partials, and so y, are the bits the
padded panels give, as on the CPU path. Where x holds an inf or a NaN, a
row reads it only at its own non-zeros on CUDA, while the CPU path and
``impl="reference"`` also add 0 * x at the padding lanes of the row's panel
group, so CUDA's y can be finite where the CPU's is NaN.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import errors, obs
from repro_torch.core.streams import (
    LANE, SUBLANE, SpMVStreams, SuperBlockStreams, SuperTileStream, TileStream,
    even_group, resolve_device, spmm_block_n,
)

from . import cb_block_dense, cb_colagg, cb_coo, cb_combine, cb_spmm as cb_spmm_kernel, ref


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
    gathers, the combine and y's fill are ``_engine_launches``).
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
# The batched engine: <=1 kernel per format (dense and panel on a gathered x) -> one combine.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Prepared:
    """What ``cb_spmv`` derives from a stream once and keeps on it."""

    sup: SuperBlockStreams
    brow: torch.Tensor                          # (T,) int32, dense|panel|coo slots
    combine: cb_combine.CombinePlan | None      # fixed summation order (CUDA only)
    stats: dict                                 # spmv_launch_stats, for _record_call
    engine: dict                                # entry -> launches beside the format kernels
    records: dict = dataclasses.field(default_factory=dict)   # _record_call's batches
    panel: tuple | None = None                  # (payload, its _version, its bitmap encoding)


def _engine_launches(stats: dict, combine, num_slots: int, m: int) -> dict:
    """The kernels a call launches beside its format kernels, per entry point:
    one x gather per present dense or panel format (the COO kernel reads x
    itself), the combine's passes (the CUDA plan's, or the one ``index_add_``
    of the CPU path) and, for ``cb_spmv``, y's fill."""
    gather = stats["launches"]["dense"] + stats["launches"]["panel"]
    passes = len(combine.passes) if combine is not None else int(num_slots > 0)
    into = {"gather": gather, "combine": passes}
    return {"spmv": dict(into, fill=int(m > 0)), "spmv_into": into}


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
        stats = spmv_launch_stats(streams, key)
        cache[key] = _Prepared(sup=sup, brow=brow, combine=plan, stats=stats,
                               engine=_engine_launches(stats, plan, brow.numel(), sup.m))
    return cache[key]


def share_prepared(template, stream, panel: cb_colagg.CompactPanels | None = None) -> None:
    """Hand ``stream`` what ``template`` derived for its first call.

    ``stream`` is a packed ``SuperBlockStreams`` or ``SuperTileStream`` with
    the template's metadata and new payloads (a value updater's output).
    The block rows, tile route and combine plan depend on the metadata
    only, so ``stream`` gets the template's (computed now if the template
    has none yet) with its own payloads behind them: no second host sort.
    The panels' bitmap encoding depends on the payload: ``panel`` is
    ``stream``'s own (an updater scatters its values into it), and without
    one ``stream`` derives its own at its first CUDA call, never the
    template's.
    """
    if isinstance(template, SuperBlockStreams):
        prep = _prepare(template, None)
        vals = stream.panel_vals
        own = None if panel is None else (vals, vals._version, panel)
        stream.__dict__["_prepared"] = {None: dataclasses.replace(prep, sup=stream, panel=own)}
    else:
        _, route = _prepare_tiles(template, None)
        stream.__dict__["_prepared"] = {None: (stream, route)}


def _gather(x: torch.Tensor, xidx: torch.Tensor) -> torch.Tensor:
    """x[xidx] with the int32 indices as stored (no int64 copy of the stream)."""
    return torch.index_select(x, 0, xidx.reshape(-1)).reshape(xidx.shape)


def _panel_encoding(prep: _Prepared) -> cb_colagg.CompactPanels | None:
    """The bitmap encoding the panel kernel reads in place of
    ``prep.sup.panel_vals``; None off CUDA or where the stream has no panel.

    Derived on the device the first time it is asked for (unless
    ``share_prepared`` handed one over), and again only for another payload
    tensor or one changed in place since (its ``_version``): a stream given
    another's prepared state never reads that one's encoding.
    """
    vals = prep.sup.panel_vals
    if vals.device.type != "cuda" or not prep.sup.num_panel_groups:
        return None
    if prep.panel is None or prep.panel[0] is not vals or prep.panel[1] != vals._version:
        prep.panel = (vals, vals._version, cb_colagg.compact_panels(vals))
    return prep.panel[2]


def _compact_elems(prep: _Prepared) -> int:
    """The value slots the bitmap panel kernel reads a call; 0 where it does not run."""
    enc = _panel_encoding(prep)
    return enc.elems if enc is not None else 0


def _accumulate(y: torch.Tensor, prep: _Prepared, x: torch.Tensor) -> torch.Tensor:
    """y += A @ x in place: one kernel per present format (dense and panel on
    a gathered x, COO on x itself), then the combine. On CUDA the panel
    kernel reads the bitmap encoding (``_panel_encoding``)."""
    s = prep.sup
    B = s.block_size
    x32 = x.to(torch.float32).contiguous()
    parts = torch.empty((prep.brow.numel(), B), dtype=torch.float32, device=y.device)
    nd, npn = s.dense_brow.numel(), s.panel_brow.numel()
    if s.num_dense_groups:
        cb_block_dense.block_dense_spmv_batched(
            s.dense_tiles, _gather(x32, s.dense_xidx),
            out=parts[:nd].view(s.dense_xidx.shape))
    if s.num_panel_groups:
        xg, out = _gather(x32, s.panel_xidx), parts[nd:nd + npn].view(*s.panel_brow.shape, B)
        enc = _panel_encoding(prep)
        if enc is None:
            cb_colagg.panel_spmv_batched(s.panel_vals, xg, out=out)
        else:
            cb_colagg.panel_spmv_bitmap(enc.cvals, enc.mask, xg, out=out)
    if s.num_coo_groups:
        cb_coo.coo_spmv_batched(
            s.coo_codes, s.coo_vals, s.coo_xidx, x32, block_size=B,
            out=parts[nd + npn:].view(*s.coo_brow.shape, B))
    return cb_combine.segment_combine(y, parts, prep.brow, B, prep.combine)


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with a CUDA device's missing index read as the current device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_impl_device(streams, impl, device) -> None:
    """``impl`` is known and ``streams`` live on the very device the call
    runs on (``cuda:1`` streams do not pass for a ``cuda:0`` call)."""
    if impl not in ("cuda", "reference"):
        raise errors.InvalidArgError(f"unknown impl {impl!r}")
    dev = _indexed(resolve_device(device))
    if _indexed(streams.device) != dev:
        raise errors.InvalidArgError(
            f"streams live on {streams.device} but the call runs on {dev}; "
            f"move them first with streams.to({str(dev)!r})")


def _call_batch(entry: str, stats: dict | None, impl: str, plan,
                engine: dict | None = None, compact: int | None = None) -> obs.Batch:
    """One call's launch accounting, as registry updates.

    Every call counts ``calls{impl}``; only the CUDA engine launches kernels,
    so ``launches`` / ``steps`` / ``padded_elems`` per format are recorded
    for ``impl="cuda"`` alone (the JAX package records them for
    ``"pallas"``), and ``engine``'s launches beside the format kernels
    (``_engine_launches``) as more ``launches`` series; ``gather`` even at 0,
    so a reader can tell a call that gathered nothing from a program that does
    not count its gathers; ``compact`` as ``compact_elems{format=panel}``, even
    at 0, where given. With a plan carrying a
    ``structure_hash`` an SpMV also records the ``repro.autotune.exec.*``
    measured-vs-predicted pair: both sides accumulate once per call, so their
    ratio is the cost model's per-call fidelity.
    """
    batch = obs.Batch().inc(f"repro.ops.{entry}.calls", impl=impl)
    if impl != "cuda":
        return batch
    for fmt, n in stats["steps"].items():
        if n:
            batch.inc(f"repro.ops.{entry}.launches", stats["launches"][fmt], format=fmt)
            batch.inc(f"repro.ops.{entry}.steps", n, format=fmt)
            batch.inc(f"repro.ops.{entry}.padded_elems", stats["padded"][fmt], format=fmt)
    for kind, n in (engine or {}).items():
        if n or kind == "gather":
            batch.inc(f"repro.ops.{entry}.launches", n, format=kind)
    if compact is not None:
        batch.inc(f"repro.ops.{entry}.compact_elems", compact, format="panel")
    label = getattr(plan, "structure_hash", None)
    if label is not None and entry in ("spmv", "spmv_into"):
        label = label[:12]
        batch.inc("repro.autotune.exec.calls", plan=label)
        for what, measured, predicted in (
                ("padded_elems", stats["padded_total"], plan.predicted_padded_elems),
                ("steps", stats["steps_total"], plan.predicted_steps)):
            batch.inc(f"repro.autotune.exec.{what}", measured, plan=label, kind="measured")
            batch.inc(f"repro.autotune.exec.{what}", predicted, plan=label, kind="predicted")
    return batch


def _record_call(entry: str, stats: dict | None, impl: str, plan,
                 cache: dict | None = None, engine: dict | None = None,
                 compact: int | None = None) -> None:
    """Emit one call's launch accounting (``_call_batch``) to the default registry.

    Runs on the host after a successful dispatch and reads shape metadata
    only (``stats`` is ``spmv_launch_stats`` / ``spmm_launch_stats``). The
    batch depends on the stream's shapes and the plan's predictions alone,
    so ``cb_spmv`` keeps it in the stream's prepared state (``cache``) and a
    call pays one locked update of its series, not a lookup and a label sort
    per instrument.
    """
    if cache is None:
        _call_batch(entry, stats, impl, plan, engine, compact).record()
        return
    key = (entry, impl, getattr(plan, "structure_hash", None),
           getattr(plan, "predicted_padded_elems", None), getattr(plan, "predicted_steps", None),
           compact)
    batch = cache.get(key)
    if batch is None:
        batch = cache[key] = _call_batch(entry, stats, impl, plan, engine, compact)
    batch.record()


def _enter(streams, x, impl, group_size, plan, device):
    """Validate a call; return (x on the call's device, effective group size)."""
    group_size = _resolve_plan(streams, plan, group_size)
    _check_group_size(streams, group_size)
    _check_impl_device(streams, impl, device)
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

    The regrouped layout, the combine's fixed summation order and the
    launch accounting are derived on the first call and cached on the
    stream object. Two calls with the same inputs return the same bits.
    """
    with obs.span("cb_spmv"):
        x, group_size = _enter(streams, x, impl, group_size, plan, device)
        if impl == "reference":
            sub = ref.super_spmv if isinstance(streams, SuperBlockStreams) else ref.cb_spmv
            y, stats, cache, engine, compact = sub(streams, x), None, None, None, None
        else:
            prep = _prepare(streams, group_size)
            y = _accumulate(torch.zeros(streams.m, dtype=torch.float32, device=x.device),
                            prep, x)
            stats, cache, engine = prep.stats, prep.records, prep.engine["spmv"]
            compact = _compact_elems(prep)
        if obs.is_enabled():
            _record_call("spmv", stats, impl, plan, cache, engine, compact)
        return y


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
    with obs.span("cb_spmv_into"):
        x, group_size = _enter(streams, x, impl, group_size, plan, device)
        if y_acc.shape != (streams.m,) or y_acc.device != x.device:
            raise errors.InvalidArgError(
                f"y_acc must be ({streams.m},) on {x.device}, got "
                f"{tuple(y_acc.shape)} on {y_acc.device}")
        if impl == "reference":
            sub = ref.super_spmv if isinstance(streams, SuperBlockStreams) else ref.cb_spmv
            y_acc.add_(sub(streams, x))
            stats, cache, engine, compact = None, None, None, None
        else:
            if y_acc.dtype != torch.float32 or not y_acc.is_contiguous():
                raise errors.InvalidArgError(
                    "y_acc must be a contiguous float32 tensor for impl='cuda'")
            prep = _prepare(streams, group_size)
            _accumulate(y_acc, prep, x)
            stats, cache, engine = prep.stats, prep.records, prep.engine["spmv_into"]
            compact = _compact_elems(prep)
        if obs.is_enabled():
            _record_call("spmv_into", stats, impl, plan, cache, engine, compact)
        return y_acc


# ---------------------------------------------------------------------------
# CB-SpMM: X blocks -> one kernel for every slot's partial -> one combine.
# ---------------------------------------------------------------------------

def _check_tile_group_size(stream, group_size) -> None:
    """``cb_spmm``'s group-size contract (mirrors ``_check_group_size``)."""
    if group_size is not None and group_size < 1:
        raise errors.InvalidArgError(f"group_size must be >= 1, got {group_size}")
    if isinstance(stream, SuperTileStream):
        if group_size is not None and group_size != stream.group_size:
            raise errors.InvalidArgError(
                f"tile stream was packed with group_size={stream.group_size};"
                f" cannot re-batch to {group_size} post hoc")


def group_slots(t: torch.Tensor, G: int) -> torch.Tensor:
    """``(nt, ...) -> (gt, Gt, ...)``: the super-tile layout of ``nt`` slots
    at group size ``G`` (``even_group``'s geometry), zero rows padding a
    ragged tail. A view when ``nt`` is already ``gt * Gt``."""
    gt, Gt = even_group(t.shape[0], G)
    if gt * Gt != t.shape[0]:
        t = _pad_rows(t, gt * Gt)
    return t.reshape(gt, Gt, *t.shape[1:])


def _regroup_tiles(ts: TileStream, G: int) -> SuperTileStream:
    """Fuse G one-tile rows per super-tile row with pure reshapes.

    Padding rows appended to ragged tails carry a zero tile and brow/bcol
    0, so they multiply X block 0 and add exact zeros into block row 0.
    """
    B = ts.block_size
    tiles = group_slots(ts.tiles, G)
    return SuperTileStream(
        block_size=B, m=ts.m, n=ts.n, mb=ts.mb, nb=ts.nb, group_size=G,
        tiles=tiles.reshape(tiles.shape[0], -1, B),
        brow=group_slots(ts.brow, G), bcol=group_slots(ts.bcol, G),
    )


def spmm_launch_stats(stream: TileStream | SuperTileStream, group_size: int | None = None,
                      *, n_cols: int | None = None, block_n: int = LANE) -> dict:
    """``cb_spmm``'s analogue of :func:`spmv_launch_stats` — the JAX
    package's accounting, number for number.

    ``steps`` is the reference's grid size ``tile_groups * n_tiles_of_X``
    (``spmm_block_n``'s 128-wide tiles) when ``n_cols`` is known, else the
    group count. The CUDA kernel tiles N its own way (``csrc/cb_spmm.cu``)
    but launches once per stream as the Pallas kernel does.
    """
    B = stream.block_size
    if isinstance(stream, SuperTileStream):
        G = stream.group_size
        gt, Gt = stream.num_groups, stream.slots
    else:
        G = int(group_size or 1)
        gt, Gt = even_group(stream.num_tiles, G)
    padded = int(gt * Gt * B * B)
    steps = int(gt)
    if n_cols is not None and gt:
        bn = spmm_block_n(int(n_cols), block_n)
        steps = gt * (-(-int(n_cols) // bn))
    return {
        "group_size": int(G),
        "steps": {"tiles": steps},
        "padded": {"tiles": padded},
        "launches": {"tiles": int(gt > 0)},
        "steps_total": steps,
        "padded_total": padded,
    }


@dataclasses.dataclass
class TileRoute:
    """Where every slot of a super-tile layout reads X and adds its partial.

    Depends on the stream's metadata only, so one route serves every call
    on the same structure, whatever the tile values (the sparse layer keeps
    one per spec and direction).
    """

    group_size: int                             # slots are grouped by group_slots(., G)
    bcol: torch.Tensor                          # (gt, Gt) int32 X block row per slot
    brow: torch.Tensor                          # (gt*Gt,) int32 output block row per slot
    combine: cb_combine.CombinePlan | None      # fixed summation order (CUDA only)


def tile_route(brow: torch.Tensor, bcol: torch.Tensor, group_size: int = 1) -> TileRoute:
    """The route of flat ``(nt,)`` tile metadata grouped at ``group_size``;
    sorts on the host once."""
    flat = group_slots(brow, group_size).reshape(-1).contiguous()
    plan = (cb_combine.plan_combine(flat, flat.device)
            if flat.device.type == "cuda" and flat.numel() else None)
    return TileRoute(group_size=group_size, bcol=group_slots(bcol, group_size).contiguous(),
                     brow=flat, combine=plan)


def x_blocks(X: torch.Tensor, nb: int, block_size: int) -> torch.Tensor:
    """X ``(n, N)`` as a contiguous ``(nb, B, N)`` of zero-padded row blocks.

    float32 and bfloat16 stay as they are; other types become float32.
    At most one copy: a contiguous X of ``nb*B`` rows is only viewed.
    """
    n, N = X.shape
    dt = X.dtype if X.dtype in cb_spmm_kernel.X_DTYPES else torch.float32
    rows = nb * block_size
    if n == rows and X.dtype == dt and X.is_contiguous():
        return X.view(nb, block_size, N)
    Xb = torch.empty((rows, N), dtype=dt, device=X.device)
    Xb[:n].copy_(X)
    Xb[n:].zero_()
    return Xb.view(nb, block_size, N)


def spmm_routed(route: TileRoute, tiles: torch.Tensor, Xb: torch.Tensor, m: int) -> torch.Tensor:
    """Y ``(m, N)`` float32 = the product of the flat ``(nt, B, B)`` tiles
    the route was built for with the X blocks ``Xb``: one kernel launch,
    one combine. The tiles are grouped as the route says (a view unless
    the tail is ragged)."""
    _, B, N = Xb.shape
    Y = torch.zeros((m, N), dtype=torch.float32, device=Xb.device)
    if route.brow.numel() == 0 or N == 0:
        return Y
    grouped = group_slots(tiles, route.group_size)
    parts = cb_spmm_kernel.super_tile_spmm(grouped.reshape(grouped.shape[0], -1, B),
                                           route.bcol, Xb)
    cb_combine.segment_combine(Y.view(-1), parts.view(route.brow.numel(), B * N),
                               route.brow, B * N, route.combine)
    return Y


def _prepare_tiles(stream, group_size) -> tuple[SuperTileStream, TileRoute]:
    """Regroup (flat streams) and fix the combine order, cached on ``stream``."""
    key = None if isinstance(stream, SuperTileStream) else int(group_size or 1)
    cache = stream.__dict__.setdefault("_prepared", {})
    if key not in cache:
        sup = stream if key is None else _regroup_tiles(stream, key)
        cache[key] = (sup, tile_route(sup.brow.reshape(-1), sup.bcol.reshape(-1), sup.slots))
    return cache[key]


def cb_spmm(
    stream: TileStream | SuperTileStream,
    X: torch.Tensor,
    *,
    impl: str = "cuda",
    block_n: int = LANE,
    group_size: int | None = None,
    plan=None,
    device=None,
) -> torch.Tensor:
    """Y = A @ X over the block-dense tile stream. X: (n, N) -> Y: (m, N).

    Mirrors :func:`cb_spmv`'s batched contract: a ``SuperTileStream``
    carries its group size from the host-side nnz-balancing packer; a flat
    ``TileStream`` is regrouped with pure reshapes when ``group_size=G`` is
    passed (``None`` keeps one tile per group). ``plan`` supplies the
    planner's group size, with the same conflict rules. ``device`` is where
    the call runs (``None``: CUDA); the stream must live there.

    ``block_n`` is validated as in the JAX package (a multiple of 128)
    but sets no padding here: the TPU compiler needs 128-lane activation
    tiles, the CUDA kernel takes N as it is and masks the tail, so N = 16
    right-hand sides write 16 columns of partials, not 128. X is copied at
    most once, into contiguous zero-padded ``(nb*B, N)`` blocks.

    ``impl="cuda"`` returns float32. ``impl="reference"`` stays an
    independent oracle on the layout as given (no regrouping) and
    accumulates in the promoted dtype. The regrouped layout and the
    combine's order are derived on the first call and cached on the
    stream object; two calls with the same inputs return the same bits.
    """
    group_size = _resolve_plan(stream, plan, group_size)
    _check_tile_group_size(stream, group_size)
    spmm_block_n(1, block_n)
    _check_impl_device(stream, impl, device)
    X = torch.as_tensor(X, device=stream.device)
    if X.ndim != 2 or X.shape[0] != stream.n:
        raise errors.InvalidArgError(
            f"X has shape {tuple(X.shape)}, expected ({stream.n}, N)")
    if impl == "reference":
        sub = ref.super_spmm if isinstance(stream, SuperTileStream) else ref.cb_spmm
        Y = sub(stream, X)
    else:
        sup, route = _prepare_tiles(stream, group_size)
        B = sup.block_size
        Y = spmm_routed(route, sup.tiles.reshape(-1, B, B), x_blocks(X, sup.nb, B), sup.m)
    if obs.is_enabled():
        _record_call("spmm", None if impl == "reference" else spmm_launch_stats(
            stream, group_size, n_cols=int(X.shape[1]), block_n=block_n), impl, plan)
    return Y
