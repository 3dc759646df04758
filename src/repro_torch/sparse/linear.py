"""CBSparseLinear — block-sparse linear layers backed by the CB-SpMM kernel.

The paper's technique as a model feature: a linear layer whose weight is
magnitude-pruned to B x B blocks and stored as a tile stream. Forward is
CB-SpMM; backward is a ``torch.autograd.Function`` whose dX runs the same
kernel over the *transposed* tile stream and whose dW is the gathered
per-tile product ``dY_blocks[brow] @ X_blocks[bcol]^T`` (a plain
``torch.bmm``, as the JAX package leaves it to XLA outside any kernel).

Weight convention: the layer computes ``y = x @ W`` with ``W: (in, out)``;
the tile stream stores ``A = W^T`` (out, in), so ``y^T = A @ x^T`` is the
kernels' row-major SpMM.

Sparsity metadata is numpy on the spec. Everything the device needs from
it — ``brow``/``bcol`` for dW, the transposed tiles' source index, and the
routes (with their combine plans, sorted on the host) of both products —
is built once per (spec, impl, group size, device) and kept in a
weakref-keyed cache, so a training step does no host sort and reads
nothing back. Specs are bit-equal to the JAX package's
(``src/repro/sparse/linear.py``).

Each product records ``ops.cb_spmm``'s launch accounting in ``obs``
(``repro.ops.spmm.calls`` and, for ``impl="cuda"``, ``launches`` /
``steps`` / ``padded_elems`` per call, steps counting tile groups), from
one cached batch per direction.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import errors, obs
from repro_torch.core.streams import (
    TileStream, _as_tensor, build_tile_stream, resolve_device,
)
from repro_torch.kernels import ops, ref

from .prune import _cover_rows, block_sparsity_pattern


@dataclasses.dataclass(frozen=True, eq=False)
class CBLinearSpec:
    """Static sparsity structure of one CB linear layer.

    ``eq=False`` keeps object-identity hashing, which lets the matmul
    cache key on the spec itself through a ``WeakKeyDictionary``.
    """

    in_features: int
    out_features: int
    block_size: int
    keep_fraction: float
    # A = W^T stream metadata (block-row-major, full row coverage)
    brow: Any          # (nt,) numpy int32
    bcol: Any          # (nt,) numpy int32
    mb: int            # ceil(out / B)
    nb: int            # ceil(in / B)
    # transposed stream: tiles_T[i] = tiles[t_perm[i]]^T at (browT, bcolT)
    t_perm: Any        # (ntT,) numpy int64 into the forward stream; -1 = zero pad
    browT: Any
    bcolT: Any

    @property
    def num_tiles(self) -> int:
        return len(self.brow)

    @property
    def density(self) -> float:
        return self.num_tiles / float(self.mb * self.nb)

    def flops_per_token(self) -> int:
        """Useful MACs per input row (2*nt*B^2) — roofline accounting."""
        return 2 * self.num_tiles * self.block_size * self.block_size


def _transpose_stream(brow: np.ndarray, bcol: np.ndarray, nb: int):
    """Metadata for A^T's stream, with full row coverage over nb."""
    order = np.lexsort((brow, bcol))  # sort by (bcol, then brow)
    browT = bcol[order].astype(np.int32)
    bcolT = brow[order].astype(np.int32)
    perm = order.astype(np.int64)
    pads = np.setdiff1d(np.arange(nb), browT)
    if len(pads):
        browT = np.concatenate([browT, pads.astype(np.int32)])
        bcolT = np.concatenate([bcolT, np.zeros(len(pads), np.int32)])
        perm = np.concatenate([perm, np.full(len(pads), -1, np.int64)])
        reorder = np.argsort(browT, kind="stable")
        browT, bcolT, perm = browT[reorder], bcolT[reorder], perm[reorder]
    return perm, browT, bcolT


def _spec(in_features, out_features, block_size, keep_fraction, brow, bcol, mb, nb):
    t_perm, browT, bcolT = _transpose_stream(brow, bcol, nb)
    return CBLinearSpec(
        in_features=in_features, out_features=out_features,
        block_size=block_size, keep_fraction=keep_fraction,
        brow=brow, bcol=bcol, mb=mb, nb=nb,
        t_perm=t_perm, browT=browT, bcolT=bcolT,
    )


def cb_spec_random(
    in_features: int,
    out_features: int,
    *,
    block_size: int = 128,
    keep_fraction: float = 0.25,
    seed: int = 0,
) -> CBLinearSpec:
    """Structural spec with a random block pattern (numpy only).

    Draws from ``np.random.default_rng(seed)`` in the JAX package's order,
    so the same seed gives the same spec there and here.
    """
    B = block_size
    mb, nb = -(-out_features // B), -(-in_features // B)
    rng = np.random.default_rng(seed)
    norms = rng.random((mb, nb))
    keep = max(1, int(round(keep_fraction * mb * nb)))
    thresh = np.partition(norms.reshape(-1), -keep)[-keep]
    mask = norms >= thresh
    _cover_rows(mask, norms)
    brow, bcol = np.nonzero(mask)
    order = np.argsort(brow, kind="stable")
    return _spec(in_features, out_features, B, keep_fraction,
                 brow[order].astype(np.int32), bcol[order].astype(np.int32), mb, nb)


def spec_from_mask(
    mask: np.ndarray,
    in_features: int,
    out_features: int,
    *,
    block_size: int,
    keep_fraction: float,
) -> CBLinearSpec:
    """Build a spec straight from a boolean (mb, nb) block mask.

    Tile order is block-row-major, an empty block row gets a coverage
    tile at bcol 0, and the transposed-stream permutation is derived here,
    so ``cb_linear_init`` and ``prune.refreeze_spec`` agree bit for bit.
    """
    B = block_size
    mb, nb = -(-out_features // B), -(-in_features // B)
    mask = np.asarray(mask, bool)
    if mask.shape != (mb, nb):
        raise errors.InvalidArgError(
            f"mask shape {mask.shape} != block grid ({mb}, {nb}) for "
            f"({out_features}, {in_features}) at B={B}"
        )
    uncovered = np.flatnonzero(~mask.any(axis=1))
    if len(uncovered):
        mask = mask.copy()
        mask[uncovered, 0] = True
    brow, bcol = np.nonzero(mask)  # row-major == block-row-major order
    return _spec(in_features, out_features, B, keep_fraction,
                 brow.astype(np.int32), bcol.astype(np.int32), mb, nb)


def spec_block_mask(spec: CBLinearSpec) -> np.ndarray:
    """The spec's boolean (mb, nb) block mask (inverse of spec_from_mask)."""
    mask = np.zeros((spec.mb, spec.nb), bool)
    mask[spec.brow, spec.bcol] = True
    return mask


def gather_tiles(a: np.ndarray, spec: CBLinearSpec) -> np.ndarray:
    """The (nt, B, B) tile stack of dense ``A`` (out, in) at the spec's
    block slots — entries outside the mask are dropped (pruned)."""
    B = spec.block_size
    ap = np.zeros((spec.mb * B, spec.nb * B), a.dtype)
    ap[: a.shape[0], : a.shape[1]] = a
    blocks = ap.reshape(spec.mb, B, spec.nb, B).transpose(0, 2, 1, 3)
    return blocks[spec.brow, spec.bcol]


def cb_tiles_init(generator: torch.Generator | None, spec: CBLinearSpec, dtype=torch.float32,
                  scale: float | None = None, device=None) -> dict:
    """Draw tile values for an existing spec: float32 normals times
    ``scale`` (default ``in_features ** -0.5``), drawn on the generator's
    device, cast to ``dtype`` and placed on ``device`` (default CUDA). On
    the meta device nothing is drawn and ``generator`` may be None."""
    dev = resolve_device(device)
    scale = spec.in_features**-0.5 if scale is None else scale
    B = spec.block_size
    if dev.type == "meta":
        return {"tiles": torch.empty((spec.num_tiles, B, B), dtype=dtype, device=dev)}
    tiles = torch.randn((spec.num_tiles, B, B), generator=generator,
                        dtype=torch.float32, device=generator.device) * scale
    return {"tiles": tiles.to(device=dev, dtype=dtype)}


def cb_linear_init(
    generator: torch.Generator,
    in_features: int,
    out_features: int,
    *,
    block_size: int = 128,
    keep_fraction: float = 0.25,
    dtype=torch.float32,
    init_scale: float | None = None,
    device=None,
) -> tuple[dict, CBLinearSpec]:
    """Draw a dense weight, block-prune it, and build the tile stream."""
    dev = resolve_device(device)
    scale = init_scale if init_scale is not None else in_features**-0.5
    w = torch.randn((in_features, out_features), generator=generator,
                    dtype=torch.float32, device=generator.device) * scale
    w = w.cpu().numpy()  # cblint: disable=CB211 -- init: the host prunes the drawn weight
    a = w.T  # (out, in)
    mask = block_sparsity_pattern(a, block_size, keep_fraction)
    rr, cc = np.nonzero(np.repeat(np.repeat(mask, block_size, 0), block_size, 1)[
        : a.shape[0], : a.shape[1]
    ] & (a != 0))
    stream = build_tile_stream(rr, cc, a[rr, cc], (out_features, in_features), block_size)
    spec = _spec(in_features, out_features, block_size, keep_fraction,
                 stream.brow.numpy(), stream.bcol.numpy(), stream.mb, stream.nb)
    return {"tiles": stream.tiles.to(device=dev, dtype=dtype)}, spec


def from_numpy(params_np: dict, spec_fields, device=None) -> tuple[dict, CBLinearSpec]:
    """A layer's weights and spec from plain numpy: ``params_np`` is
    ``{"tiles": ndarray}`` (bfloat16 arrays included) and ``spec_fields``
    maps every ``CBLinearSpec`` field name to its value. This is how a
    layer built elsewhere (by the JAX package, or read from disk) enters
    the port with the same bits."""
    names = [f.name for f in dataclasses.fields(CBLinearSpec)]
    missing = [k for k in names if k not in spec_fields]
    if missing:
        raise errors.InvalidArgError(f"spec fields missing: {missing}")
    arrays = ("brow", "bcol", "t_perm", "browT", "bcolT")
    spec = CBLinearSpec(**{k: np.asarray(spec_fields[k]) if k in arrays else spec_fields[k]
                           for k in names})
    tiles = _as_tensor(np.asarray(params_np["tiles"])).to(resolve_device(device))
    return {"tiles": tiles}, spec


# ---------------------------------------------------------------------------
# The differentiable product and its per-spec device state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Direction:
    """One of the two products a layer runs: A (forward) or A^T (dX)."""

    brow: torch.Tensor            # (nt,) int32 on the device
    bcol: torch.Tensor
    m: int                        # rows of the product's result
    n: int                        # rows of its right-hand side
    mb: int
    nb: int
    route: ops.TileRoute | None   # impl="cuda" only
    stats: dict | None            # the route's launch accounting (impl="cuda" only)
    obs_cache: dict               # ops._record_call's cached batch


class _Matmul:
    """``(tiles, X) -> A @ X`` for one spec, impl, group size and device.

    Holds the spec's device state: both directions' metadata and, for
    ``impl="cuda"``, their ``ops.TileRoute`` with the combine plans, and
    the transposed tiles' source index and pad mask.
    """

    def __init__(self, spec: CBLinearSpec, impl: str, group_size: int | None, device):
        if impl not in ("cuda", "reference"):
            raise errors.InvalidArgError(f"unknown impl {impl!r}")
        if group_size is not None and group_size < 1:
            raise errors.InvalidArgError(f"group_size must be >= 1, got {group_size}")
        dev = resolve_device(device)
        self.impl, self.B = impl, spec.block_size

        def direction(brow, bcol, m, n, mb, nb):
            brow, bcol = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                          for a in (brow, bcol))
            route = ops.tile_route(brow, bcol, group_size or 1) if impl == "cuda" else None
            stats = None
            if route is not None:
                gt, Gt = route.bcol.shape
                padded = gt * Gt * self.B * self.B
                stats = {"group_size": route.group_size, "steps": {"tiles": gt},
                         "padded": {"tiles": padded}, "launches": {"tiles": int(gt > 0)},
                         "steps_total": gt, "padded_total": padded}
            return _Direction(brow, bcol, m, n, mb, nb, route, stats, {})

        i, o = spec.in_features, spec.out_features
        self.fwd = direction(spec.brow, spec.bcol, o, i, spec.mb, spec.nb)
        self.bwd = direction(spec.browT, spec.bcolT, i, o, spec.nb, spec.mb)
        self.t_src = torch.from_numpy(np.maximum(spec.t_perm, 0)).to(dev)
        pads = spec.t_perm < 0
        self.t_pad = torch.from_numpy(pads).to(dev)[:, None, None] if pads.any() else None

    def _product(self, d: _Direction, tiles, X, Xb) -> torch.Tensor:
        """``A @ X`` in direction ``d``; ``Xb`` is X cut into row blocks."""
        if self.impl == "reference":
            ts = TileStream(block_size=self.B, m=d.m, n=d.n, mb=d.mb, nb=d.nb,
                            tiles=tiles, brow=d.brow, bcol=d.bcol)
            Y = ref.cb_spmm(ts, X)
        else:
            Y = ops.spmm_routed(d.route, tiles, Xb, d.m)
        if obs.is_enabled():
            ops._record_call("spmm", d.stats, self.impl, None, d.obs_cache)
        return Y

    def forward(self, tiles: torch.Tensor, X: torch.Tensor):
        """Y (out, N), and the blocked X that dW reuses."""
        Xb = ops.x_blocks(X, self.fwd.nb, self.B)        # the one copy of X
        return self._product(self.fwd, tiles, X, Xb), Xb

    def transposed_tiles(self, tiles: torch.Tensor) -> torch.Tensor:
        """A^T's tiles, gathered and transposed on the device."""
        tT = torch.index_select(tiles, 0, self.t_src).transpose(1, 2).contiguous()
        if self.t_pad is not None:
            tT.masked_fill_(self.t_pad, 0)
        return tT

    def backward(self, tiles, Xb, dY, x_dtype, need_tiles=True, need_x=True):
        """(d_tiles, dX) for the cotangent ``dY`` (out, N); None where not needed."""
        dY = dY.to(torch.float32)
        dYb = ops.x_blocks(dY, self.bwd.nb, self.B)       # (mb, B, N) float32
        d_tiles = dX = None
        if need_x:
            dX = self._product(self.bwd, self.transposed_tiles(tiles), dY, dYb).to(x_dtype)
        if need_tiles:
            # dA[t] = dY_blocks[brow[t]] @ X_blocks[bcol[t]]^T
            d_tiles = torch.bmm(torch.index_select(dYb, 0, self.fwd.brow),
                                torch.index_select(Xb.to(torch.float32), 0,
                                                   self.fwd.bcol).transpose(1, 2))
            d_tiles = d_tiles.to(tiles.dtype)
        return d_tiles, dX


class _CBMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tiles, X, mm: _Matmul):
        Y, Xb = mm.forward(tiles, X)
        ctx.save_for_backward(tiles, Xb)
        ctx.mm, ctx.x_dtype = mm, X.dtype
        return Y

    @staticmethod
    def backward(ctx, dY):
        tiles, Xb = ctx.saved_tensors
        d_tiles, dX = ctx.mm.backward(tiles, Xb, dY, ctx.x_dtype,
                                      *ctx.needs_input_grad[:2])
        return d_tiles, dX, None


def make_cb_matmul(spec: CBLinearSpec, impl: str = "cuda", group_size: int | None = None,
                   device=None):
    """Build the differentiable ``(tiles, X) -> A @ X`` for this spec.

    X: (in, N) -> Y: (out, N). Forward and dX run ``ops``' SpMM (the CUDA
    kernel for ``impl="cuda"``, the plain oracle for ``"reference"``), dX
    on the transposed stream; dW is the gathered per-tile product. The
    casts are the JAX package's: dY to float32, dX to X's dtype, d_tiles
    to the tiles' dtype. ``group_size`` regroups both streams (a schedule
    change only). The returned function holds the spec's device state,
    not the spec, so the cache below can drop it with the spec.
    """
    mm = _Matmul(spec, impl, group_size, device)

    def matmul(tiles, X):
        return _CBMatmul.apply(tiles, X, mm)

    return matmul


# One matmul per spec per (impl, group size, device); the spec is the weak
# key, so entries die with the spec instead of pinning every spec built.
_MATMUL_CACHE: "weakref.WeakKeyDictionary[CBLinearSpec, dict]" = weakref.WeakKeyDictionary()


def _cached_matmul(spec: CBLinearSpec, impl: str, group_size: int | None = None, device=None):
    dev = resolve_device(device)
    per_spec = _MATMUL_CACHE.setdefault(spec, {})
    key = (impl, group_size, dev.type, dev.index)
    if key not in per_spec:
        per_spec[key] = make_cb_matmul(spec, impl=impl, group_size=group_size, device=dev)
    return per_spec[key]


def cb_linear_apply(
    params: dict,
    spec: CBLinearSpec,
    x: torch.Tensor,
    *,
    impl: str = "cuda",
    group_size: int | None = None,
    plan=None,
    device=None,
) -> torch.Tensor:
    """y = x @ W for x of shape (..., in_features), in x's dtype.

    Runs on ``device`` (``None``: CUDA, raising ``DeviceUnavailableError``
    without one); the tiles must live there. ``impl="cuda"`` (the default
    here; the JAX package defaults to its reference) runs the CUDA kernel
    on CUDA tensors and its plain version on CPU tensors. ``plan`` (an
    autotune ``Plan``, duck-typed) supplies the group size; a conflicting
    explicit ``group_size`` is an error.

    On a mesh ``x`` is a ``DTensor`` of batch rows (its feature dim whole)
    and the tiles are replicated, as the reference's ``mlp_axes`` places
    them: each rank runs the kernels on its local rows, and ``y`` comes back
    with ``x``'s placements (``_on_mesh``).
    """
    if isinstance(x, DTensor):
        return _on_mesh(params, spec, x, impl=impl, group_size=group_size, plan=plan,
                        device=device)
    if plan is not None:
        if group_size is not None and group_size != plan.group_size:
            raise errors.InvalidArgError(
                f"plan chose group_size={plan.group_size}; conflicting "
                f"explicit group_size={group_size}"
            )
        group_size = plan.group_size
    dev = resolve_device(device)
    tiles = params["tiles"]
    if tiles.device.type != dev.type:
        raise errors.InvalidArgError(
            f"tiles live on {tiles.device} but the call runs on {dev}")
    x = torch.as_tensor(x, device=tiles.device)
    matmul = _cached_matmul(spec, impl, group_size, tiles.device)
    lead = x.shape[:-1]
    X = x.reshape(-1, spec.in_features).T  # (in, N)
    Y = matmul(tiles, X)                   # (out, N)
    return Y.T.reshape(*lead, spec.out_features).to(x.dtype)


def _on_mesh(params: dict, spec: CBLinearSpec, x: DTensor, **kw) -> DTensor:
    """``cb_linear_apply`` of a ``DTensor`` x: the rank's rows through the
    product with the replicated tiles, the result placed as x is.

    The tiles' gradient on a rank is its rows' share: it is summed over the
    axes x is split over (the batch's ``data`` / ``pod``), and not over those
    it is replicated on, where every rank computed the same product (``model``)."""
    from repro_torch.models import sharding as S

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    if any(p.is_shard() and p.dim in (x.ndim - 1, -1) for p in x.placements):
        raise errors.InvalidArgError(
            f"x's feature dim is split ({x.placements}): a CB product takes whole rows")
    tiles = params["tiles"]
    if isinstance(tiles, DTensor):
        if any(p.is_shard() for p in tiles.placements):
            raise errors.InvalidArgError(
                f"CB tiles are replicated (mlp_axes), not {tiles.placements}")
        tiles = tiles.to_local()
    split = tuple(n for n, p in zip(names, x.placements) if p.is_shard())
    y = cb_linear_apply({"tiles": S.sum_grad(tiles, mesh, split)}, spec, x.to_local(), **kw)
    return DTensor.from_local(y, mesh, x.placements, run_check=False)


def dense_equivalent(params: dict, spec: CBLinearSpec) -> torch.Tensor:
    """Densified W (in, out) in the tiles' dtype — test/debug utility."""
    tiles = params["tiles"]
    B = spec.block_size
    flat = torch.zeros((spec.mb * spec.nb, B, B), dtype=tiles.dtype, device=tiles.device)
    at = torch.from_numpy(spec.brow.astype(np.int64) * spec.nb + spec.bcol).to(tiles.device)
    flat.index_add_(0, at, tiles)
    A = flat.reshape(spec.mb, spec.nb, B, B).permute(0, 2, 1, 3).reshape(
        spec.mb * B, spec.nb * B)
    return A[: spec.out_features, : spec.in_features].T


class CBSparseLinear(torch.nn.Module):
    """``y = x @ W`` with W block-sparse: ``tiles`` is the parameter, the
    spec is plain data.

    Built from a spec (e.g. ``cb_spec_random``) with tiles from
    ``cb_tiles_init`` and ``generator``; on CUDA unless ``device`` says
    otherwise (``DeviceUnavailableError`` without one).
    """

    def __init__(self, spec: CBLinearSpec, *, generator: torch.Generator | None = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.spec = spec
        self.tiles = torch.nn.Parameter(cb_tiles_init(gen, spec, dtype, device=dev)["tiles"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cb_linear_apply({"tiles": self.tiles}, self.spec, x, device=self.tiles.device)

    def extra_repr(self) -> str:
        s = self.spec
        return (f"in_features={s.in_features}, out_features={s.out_features}, "
                f"block_size={s.block_size}, tiles={s.num_tiles}")
