"""Checkpointing: one ``.npy`` per leaf + a JSON manifest, async write.

The port of ``repro.checkpoint.checkpointer``, writing the reference's layout:

    <dir>/step_<N>/
        manifest.json   — step, and each leaf's file, shape and dtype
        <i>_<name>.npy  — one file per leaf, in the order and under the names
                          JAX flattens the reference's state with

A ``training.TrainState`` is written as the reference's ``TrainState``
(``train_state_to_numpy``: layers stacked, moments as parameter trees), so
a checkpoint written by ``repro.training.run_training`` restores here and
one written here restores there. Any other state (a dict, a dataclass, a
tensor, a numpy array) is flattened the same way.

Writes go through a temp directory + atomic rename, so a crash mid-write
never corrupts the latest checkpoint (restart scans for the newest COMPLETE
step). ``save`` can run asynchronously (a thread): the state is first
copied to the host, synchronously, and the thread writes that copy. The
train loop updates its state in place, so a thread handed the live tensors
would write a mixture of two steps.

Restore is elastic, as the reference's: it reads logical (unsharded)
arrays, and ``shardings=`` (a tree of ``models.sharding.NamedSharding``
matching the restored state, e.g. ``sanitize_shardings`` of
``logical_to_sharding(model.axes(), mesh)``) places each one onto the
current ``DeviceMesh`` with ``torch.distributed.tensor.distribute_tensor``,
so a checkpoint written on one device (or by ``repro.checkpoint``)
restores onto any mesh. Every rank of the mesh calls ``restore``.

A sharded live ``TrainState`` (a model on a mesh) is saved in the same
layout of whole arrays: every rank calls ``save``, which gathers each
tensor; rank 0 writes, synchronously, and the others wait on a barrier.
``restore`` into a sharded live example gives each rank its part, laid
out like the example.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch import errors
from repro_torch.models.sharding import NamedSharding, param_mesh, param_shardings
from repro_torch.training.train_state import (
    TrainState, _children, from_numpy, layout, layouts_of, leaves_with_names, map_leaves,
    shard_state, to_numpy, train_state_from_numpy, train_state_to_numpy,
)


def _is_live(state) -> bool:
    """A port ``TrainState`` whose params are a model (not the reference layout)."""
    return isinstance(state, TrainState) and isinstance(state.params, torch.nn.Module)


def _mesh_of(state):
    """The mesh of a live state's ``DTensor`` parameters, else None."""
    if not _is_live(state):
        return None
    return param_mesh(next(state.params.parameters()))


def _sharding_leaves(tree) -> list[NamedSharding]:
    """A shardings tree's leaves, in the order ``leaves_with_names`` walks a state."""
    if isinstance(tree, NamedSharding):
        return [tree]
    kids = _children(tree)
    if kids is None:
        raise errors.InvalidArgError(f"shardings holds {tree!r} where a NamedSharding belongs")
    return [leaf for _, child in kids for leaf in _sharding_leaves(child)]


def _distribute(state, shardings):
    """Each leaf of ``state`` placed by its ``NamedSharding`` (a ``DTensor``)."""
    leaves = [a for _, a in leaves_with_names(state)]
    shs = _sharding_leaves(shardings)
    if len(shs) != len(leaves):
        raise errors.InvalidArgError(
            f"shardings holds {len(shs)} leaves, the restored state {len(leaves)}")
    placed = []
    for a, sh in zip(leaves, shs):
        t = a if isinstance(a, torch.Tensor) else from_numpy(a, "cpu")
        placed.append(distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                                        list(sh.placements)))
    return map_leaves(lambda t, _: t, placed, like=state)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ------------------------------------------------------------
    def save(self, state: Any, step: int) -> None:
        host_state = (train_state_to_numpy(state) if _is_live(state)
                      else map_leaves(to_numpy, state))
        if _mesh_of(state) is not None:            # every rank gathered; rank 0 writes
            self.wait()
            if dist.get_rank() == 0:
                self._write(host_state, step)
            dist.barrier()
            return
        if self.async_write:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(host_state, step), daemon=True
            )
            self._thread.start()
        else:
            self._write(host_state, step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, host_state, step: int) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (name, arr) in enumerate(leaves_with_names(host_state)):
            fname = f"{i:05d}_{name[:80]}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for d in sorted(os.listdir(self.directory)):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        example_state: Any,
        step: int | None = None,
        shardings: Any | None = None,
    ) -> Any:
        """Restore into the structure of ``example_state``, a new state (the
        example is not written). A live ``TrainState`` comes back on its
        step's device, and sharded like the example where its parameters are
        ``DTensor``s; elsewhere a tensor leaf comes back as a tensor on its
        example's device, anything else as numpy. With ``shardings`` every
        leaf comes back as a ``DTensor`` on the shardings' mesh; for a live
        ``TrainState`` ``shardings`` is a tree of the parameters' layouts in
        the reference's layout (``sanitize_shardings`` of
        ``logical_to_sharding(model.axes(), mesh)``), or a ``TrainState`` of
        such trees, and the moments follow their parameters."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = [np.load(os.path.join(d, entry["file"])) for entry in manifest["leaves"]]
        like = layout(example_state) if _is_live(example_state) else example_state
        if len(arrays) != len(leaves_with_names(like)):
            raise errors.InvalidArgError(
                f"checkpoint {d} holds {len(arrays)} leaves, the example state "
                f"{len(leaves_with_names(like))}")
        if _is_live(example_state):
            tree = map_leaves(lambda a, _: a, arrays, like=like)
            dev = example_state.step.device
            if shardings is None and _mesh_of(example_state) is None:
                return train_state_from_numpy(tree, dev)
            whole = train_state_from_numpy(tree, "cpu")
            if shardings is None:
                layouts = layouts_of(example_state.params)
            else:
                tree_sh = shardings.params if isinstance(shardings, TrainState) else shardings
                layouts = [(sh.mesh, sh.placements)
                           for sh in param_shardings(whole.params, tree_sh)]
            return shard_state(whole, layouts, dev)

        def leaf(a, like):
            return from_numpy(a, like.device) if isinstance(like, torch.Tensor) else a

        state = map_leaves(leaf, arrays, like=example_state)
        return state if shardings is None else _distribute(state, shardings)
