"""Train-step construction + host-side training loop.

The port of ``repro.training.train_loop`` (``src/repro/training/train_loop.py``).

``build_train_step`` assembles the step: microbatched gradient accumulation
(float32, in the reference's order: ``0 + g1 + g2 ...``, then ``x 1/k``),
the optional simulated int8 EF compression, global-norm clipping, the LR
schedule and the AdamW/Lion update, with the reference's metrics dict. The
reference's step is a pure jitted function that donates its state; here it
runs eagerly and updates the state in place (``training.optimizer`` says
why: the state of a model at cb-paper's size fills most of the card), and
returns that same state.

``run_training`` is the host loop: deterministic data stream (resume ==
replay), periodic async checkpoints, heartbeat + straggler bookkeeping
from runtime/, and crash-consistent restart. It reads device values only
on logging steps (``v.item()``, the sync the reference makes too).

On a mesh (``Model(cfg, mesh=)``) every rank runs the same loop: each batch
is placed split over ``batch -> (pod, data)`` (``sharding.place_batch``),
the state is ``DTensor``s updated shard by shard, and the metrics are the
same on every rank. A microbatch is rows of each rank's shard.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import sharding as S
from repro_torch.models.model import Model, param_tree

from . import optimizer as opt_mod
from .grad_compression import dequantize_int8, ef_quantize_stacked
from .schedule import warmup_cosine
from .train_state import TrainState


def build_train_step(
    model: Model,
    optimizer: opt_mod.Optimizer,
    lr_fn: Callable,
    *,
    microbatches: int = 1,
    clip_norm: float = 1.0,
    compression: str = "none",   # none | int8_ef (simulated pre-psum quant)
):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds tensors on the state's device, and ``state`` is updated in place."""

    def compute_grads(params, batch):
        """(loss, metrics, grads): the grads are the parameters' ``.grad``."""
        for p in params.parameters():
            p.grad = None
        if microbatches == 1:
            loss, metrics = model.loss(params, batch)
            loss.backward()
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
                [p.grad for p in params.parameters()]
        loss_sum = torch.zeros((), dtype=torch.float32, device=params.embed.device)
        for i in range(microbatches):
            mb = {k: _rows(v, i, microbatches) for k, v in batch.items()}
            loss, _ = model.loss(params, mb)
            loss.backward()                 # .grad: g1, then g1 + g2, ... in float32
            loss_sum = loss_sum + loss.detach()
        grads = [p.grad for p in params.parameters()]
        inv = 1.0 / microbatches
        torch._foreach_mul_(opt_mod.local(grads), inv)
        return loss_sum * inv, {"xent": loss_sum * inv}, grads

    def train_step(state: TrainState, batch):
        loss, metrics, grads = compute_grads(state.params, batch)

        if compression == "int8_ef":
            # Simulated compressed cross-pod sum: quantize + EF where the pod
            # psum would run; the numerics of the wire version, one scale per
            # leaf of the reference's tree.
            with torch.no_grad():
                for idx in _leaf_groups(state.params):
                    qs, s, efs = ef_quantize_stacked([grads[i] for i in idx],
                                                     [state.ef_buffers[i] for i in idx])
                    for i, q, e in zip(idx, qs, efs):
                        opt_mod.local([grads[i]])[0].copy_(dequantize_int8(q, s))
                        opt_mod.local([state.ef_buffers[i]])[0].copy_(e)

        grads, gnorm = opt_mod.clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(state.step)
        updates, _ = optimizer.update(grads, state.opt_state, list(state.params.parameters()),
                                      lr)
        opt_mod.apply_updates(state.params.parameters(), updates)
        for p in state.params.parameters():
            p.grad = None                   # the updates' storage, free until the next step
        state.step += 1
        out_metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out_metrics.update(metrics)
        return state, out_metrics

    return train_step


def _rows(v, i: int, k: int):
    """Microbatch ``i`` of ``k``: rows of the batch (of each rank's shard, for
    a ``DTensor``)."""
    if isinstance(v, DTensor):
        return DTensor.from_local(_rows(v.to_local(), i, k), v.device_mesh, v.placements,
                                  run_check=False)
    n = v.shape[0] // k
    return v[i * n:(i + 1) * n]


def _leaf_groups(params) -> list[list[int]]:
    """The indices into ``params.parameters()`` of each leaf of the reference's
    parameter tree (a layer-stacked leaf: one index per layer)."""
    groups = []

    def flat(node) -> list:
        return [i for c in node for i in flat(c)] if isinstance(node, list) else [node]

    def walk(node):
        if isinstance(node, dict):
            for child in node.values():
                walk(child)
        else:
            groups.append(flat(node))

    walk(param_tree(params, range(len(list(params.parameters())))))
    return groups


# ---------------------------------------------------------------------------
# host loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    microbatches: int = 1
    clip_norm: float = 1.0
    optimizer: str = "adamw"
    compression: str = "none"
    step_deadline_s: float | None = None   # straggler mitigation


def run_training(
    model: Model,
    data_stream,
    loop_cfg: TrainLoopConfig,
    *,
    checkpointer=None,
    monitor=None,
    initial_state: TrainState | None = None,
) -> tuple[TrainState, list[dict]]:
    """Deterministic, restartable training loop (single controller).

    Without ``initial_state`` the weights are ``model.init`` of a generator
    seeded 0 on the model's device (the reference's ``PRNGKey(0)``; the two
    draw different numbers). ``initial_state`` is trained in place. The
    reference's ``jit`` switch has no counterpart: the step runs eagerly.
    """
    optimizer = opt_mod.OPTIMIZERS[loop_cfg.optimizer]()
    lr_fn = warmup_cosine(loop_cfg.peak_lr, loop_cfg.warmup_steps,
                          loop_cfg.total_steps)
    step_fn = build_train_step(
        model, optimizer, lr_fn,
        microbatches=loop_cfg.microbatches,
        clip_norm=loop_cfg.clip_norm,
        compression=loop_cfg.compression,
    )

    if initial_state is None:
        params = model.init(torch.Generator(device=model.device).manual_seed(0))
        state = TrainState.create(
            params, optimizer,
            use_compression=loop_cfg.compression != "none",
        )
    else:
        state = initial_state

    history: list[dict] = []
    start = state.step.item()  # cblint: disable=CB211 -- once, before the loop
    for step in range(start, loop_cfg.total_steps):
        t0 = time.monotonic()
        batch = data_stream.batch(step)
        batch = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
        if getattr(model, "mesh", None) is not None:
            batch = S.place_batch(batch, model.mesh)
        state, metrics = step_fn(state, batch)
        if monitor is not None:
            monitor.heartbeat(step)

        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps - 1:
            m = {k: v.item() for k, v in metrics.items()}  # cblint: disable=CB211 -- log steps
            m["step"] = step
            m["step_time_s"] = time.monotonic() - t0
            history.append(m)
        if (
            loop_cfg.step_deadline_s is not None
            and monitor is not None
            and (time.monotonic() - t0) > loop_cfg.step_deadline_s
        ):
            monitor.report_straggler(step, time.monotonic() - t0)

        if checkpointer is not None and (
            (step + 1) % loop_cfg.checkpoint_every == 0
            or step == loop_cfg.total_steps - 1
        ):
            checkpointer.save(state, step + 1)

    return state, history
