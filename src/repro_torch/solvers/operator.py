"""CBLinearOperator — the solver subsystem's view of a CB matrix.

Iterative solvers apply the same matrix thousands of times; the whole
point of CB preprocessing (paper §3, fig. 12) is that its cost amortizes
to zero in exactly this regime. The operator therefore does ALL
preprocessing once at construction time (``from_cb``, on the host) and
moves the streams to the device; afterwards it only applies them:

  * ``matvec``  — ``A @ x``  through the batched super-block engine
    (``ops.cb_spmv`` on ``build_super_streams``);
  * ``rmatvec`` — ``A^T @ y`` through a *precomputed transposed* super
    stream (``streams.transpose_cb``): the transpose gets its own CB
    structure with formats/colagg/balance re-decided for A^T's sparsity;
  * ``matmat``  — multi-RHS ``A @ X`` through the batched CB-SpMM
    super-tile stream (``ops.cb_spmm``; subspace eigensolvers).

Every product goes through the port's kernels (``impl="cuda"``, the
default) or their plain oracle (``impl="reference"``) on the operator's
own device. The combine plan of each stream is sorted on the host at its
first product and kept on the stream object, so a solve pays it once.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import errors
from repro_torch.core.cb_matrix import CBMatrix
from repro_torch.core.streams import (
    LANE,
    SuperBlockStreams,
    SuperStreamUpdater,
    SuperTileStream,
    SuperTileUpdater,
    build_super_streams,
    build_transposed_super_streams,
    resolve_device,
    super_stream_updater,
    super_tile_stream_from_cb,
    super_tile_updater,
    transposed_super_stream_updater,
)
from repro_torch.kernels import ops


def _to(obj, dev):
    return None if obj is None else obj.to(dev)


@dataclasses.dataclass(eq=False)
class CBLinearOperator:
    """Preprocessed CB matrix as a linear operator on one device.

    ``streams_T`` / ``tiles`` are optional capabilities: ``None`` when the
    caller asked ``from_cb`` not to pay their preprocessing.
    """

    shape: tuple[int, int]
    block_size: int
    nnz: int
    streams: SuperBlockStreams
    streams_T: SuperBlockStreams | None = None
    tiles: SuperTileStream | None = None
    plan: object | None = None       # the Plan that shaped the streams
    # Value-scatter updaters recorded at build time (``updatable=True``);
    # ``with_values`` copies share them object for object.
    updater: SuperStreamUpdater | None = None
    updater_T: SuperStreamUpdater | None = None
    tile_updater: SuperTileUpdater | None = None

    # ------------------------------------------------------------------
    @classmethod
    def from_cb(
        cls,
        cb: CBMatrix,
        *,
        group_size: int | None = None,
        with_rmatvec: bool = False,
        with_matmat: bool = False,
        plan: object | None = None,
        plan_cache=None,
        plan_settings=None,
        updatable: bool = False,
        device=None,
    ) -> "CBLinearOperator":
        """Build every requested stream once on the host, then move it.

        Capabilities are pay-for-what-you-ask: ``rmatvec`` costs a full
        second CB pipeline on the transposed triplets and ``matmat``
        densifies every block into balanced SpMM super-tiles, so both
        default OFF. ``group_size`` is shared by every stream built here.

        ``updatable=True`` additionally records a value-scatter updater
        per requested stream (``streams.super_stream_updater`` and
        friends), enabling :meth:`with_values` — value churn without
        re-planning. Recording costs one extra shadow build per stream.

        ``device`` is where the operator lives and every product runs:
        ``None`` means CUDA (``errors.DeviceUnavailableError`` where there
        is none), ``"cpu"`` the CPU.

        ``plan`` hooks in the autotune subsystem, and since the operator
        IS the amortization regime (thousands of applications of one
        matrix), construction is where planning pays for itself:

          * ``None`` — keep ``cb``'s configuration as built (default);
          * ``"auto"`` — run ``CBMatrix.plan_for`` on ``cb``'s triplets on
            the operator's ``device`` (consulting ``plan_cache`` when
            given, searching with ``plan_settings`` — e.g.
            ``SearchSettings(mode="heuristic")`` to stay deterministic on
            the card, where ``"auto"`` times the candidates) and rebuild
            the CB structure with the winning configuration;
          * a ``Plan`` — apply that plan's configuration directly.

        A tuned plan owns the group-size decision, so combining ``plan``
        with an explicit ``group_size`` is an error. The plan rides on
        the operator and on every ``matvec``, where ``obs`` records its
        measured-vs-predicted launch accounting.
        """
        dev = resolve_device(device)
        if plan is not None:
            if group_size is not None:
                raise errors.InvalidArgError(
                    "pass either plan= or group_size=, not both — a plan "
                    "carries its own group size")
            rows, cols, vals = cb.to_coo()
            if isinstance(plan, str):
                if plan != "auto":
                    raise errors.InvalidArgError(f"unknown plan mode {plan!r}")
                plan = CBMatrix.plan_for(
                    rows, cols, vals, cb.shape, val_dtype=cb.val_dtype,
                    cache=plan_cache, settings=plan_settings, device=dev)
            cb = CBMatrix.from_plan(rows, cols, vals, cb.shape, plan)
            group_size = plan.group_size
        streams_T = (build_transposed_super_streams(cb, group_size=group_size)
                     if with_rmatvec else None)
        tiles = (super_tile_stream_from_cb(cb, group_size=group_size)
                 if with_matmat else None)
        return cls(
            shape=tuple(cb.shape),
            block_size=cb.block_size,
            nnz=cb.nnz,
            streams=build_super_streams(cb, group_size=group_size).to(dev),
            streams_T=_to(streams_T, dev),
            tiles=_to(tiles, dev),
            plan=plan,
            updater=(super_stream_updater(cb, group_size=group_size).to(dev)
                     if updatable else None),
            updater_T=(transposed_super_stream_updater(cb, group_size=group_size).to(dev)
                       if updatable and with_rmatvec else None),
            tile_updater=(super_tile_updater(cb, group_size=group_size).to(dev)
                          if updatable and with_matmat else None),
        )

    @classmethod
    def from_streams(
        cls,
        shape: tuple[int, int],
        block_size: int,
        nnz: int,
        streams: SuperBlockStreams,
        streams_T: SuperBlockStreams | None = None,
        tiles: SuperTileStream | None = None,
    ) -> "CBLinearOperator":
        """An operator over streams built elsewhere (with
        ``streams.streams_from_numpy``, e.g. the exact bytes of the JAX
        package's operator). The streams must all live on one device;
        the operator runs there."""
        dev = streams.device
        for extra in (streams_T, tiles):
            if extra is not None and extra.device != dev:
                raise errors.InvalidArgError(
                    f"streams live on {dev} but another stream lives on {extra.device}")
        return cls(shape=tuple(shape), block_size=int(block_size), nnz=int(nnz),
                   streams=streams, streams_T=streams_T, tiles=tiles)

    # ------------------------------------------------------------------
    def with_values(self, canonical_vals) -> "CBLinearOperator":
        """The dynamic-sparsity fast path: same structure, fresh values.

        ``canonical_vals`` (numpy, or a tensor) is one value per matrix
        element in the canonical ``CBMatrix.to_coo`` order. Returns an
        operator reusing every structural decision and the updaters
        themselves, with only the stream payloads rewritten — one scatter
        per payload on the operator's device. The new streams share their
        templates' combine plans, so no host sort runs either.
        """
        if self.updater is None:
            raise errors.InvalidArgError(
                "operator was built with updatable=False; rebuild with "
                "CBLinearOperator.from_cb(cb, updatable=True)"
            )
        return dataclasses.replace(
            self,
            streams=self.updater.apply(canonical_vals),
            streams_T=(self.updater_T.apply(canonical_vals)
                       if self.updater_T is not None else self.streams_T),
            tiles=(self.tile_updater.apply(canonical_vals)
                   if self.tile_updater is not None else self.tiles),
        )

    # ------------------------------------------------------------------
    @property
    def group_size(self) -> int:
        return self.streams.group_size

    @property
    def dtype(self) -> torch.dtype:
        return torch.float32  # the kernels' accumulate/output dtype

    @property
    def device(self) -> torch.device:
        return self.streams.device

    def matvec(self, x: torch.Tensor, *, impl: str = "cuda") -> torch.Tensor:
        """``A @ x`` — x: (n,) -> (m,)."""
        return ops.cb_spmv(self.streams, x, impl=impl, plan=self.plan, device=self.device)

    def matvec_into(self, y_acc: torch.Tensor, x: torch.Tensor, *,
                    impl: str = "cuda") -> torch.Tensor:
        """``y_acc += A @ x`` in place (``ops.cb_spmv_into``); returns ``y_acc``."""
        return ops.cb_spmv_into(y_acc, self.streams, x, impl=impl, plan=self.plan,
                                device=self.device)

    def rmatvec(self, y: torch.Tensor, *, impl: str = "cuda") -> torch.Tensor:
        """``A^T @ y`` — y: (m,) -> (n,) via the precomputed transpose."""
        if self.streams_T is None:
            raise errors.InvalidArgError(
                "operator was built with with_rmatvec=False; rebuild with "
                "CBLinearOperator.from_cb(cb, with_rmatvec=True)"
            )
        return ops.cb_spmv(self.streams_T, y, impl=impl, device=self.device)

    def matmat(self, X: torch.Tensor, *, impl: str = "cuda", block_n: int = LANE,
               group_size: int | None = None) -> torch.Tensor:
        """``A @ X`` — X: (n, N) -> (m, N) via the batched SpMM stream.

        ``group_size`` is baked into the super-tile stream at build time;
        passing it here is only a consistency assertion (``ops.cb_spmm``
        rejects a conflicting value), mirroring ``cb_spmv``'s contract.
        """
        if self.tiles is None:
            raise errors.InvalidArgError(
                "operator was built with with_matmat=False; rebuild with "
                "CBLinearOperator.from_cb(cb, with_matmat=True)"
            )
        return ops.cb_spmm(self.tiles, X, impl=impl, block_n=block_n,
                           group_size=group_size, device=self.device)
