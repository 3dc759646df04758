"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

    python -m repro_torch.launch.train --arch cb-paper                  # on the card
    python -m repro_torch.launch.train --arch cb-paper --smoke --device cpu --steps 3
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch cb-paper   # 4 cards

The port of ``python -m repro.launch.train``, with its flags plus
``--device`` (default: CUDA, which raises ``DeviceUnavailableError``
without a card) and ``--init-method``. Runs the training loop (synthetic
token stream, checkpointing, fault monitoring) on the mesh the reference
builds (``plan_mesh(ranks, prefer_model=min(16, ranks), global_batch=)``).
With ``WORLD_SIZE`` > 1 (``torchrun`` sets it, with ``RANK`` and
``LOCAL_RANK``) every rank joins the process group (NCCL for CUDA, gloo
for ``--device cpu``; ``--init-method`` defaults to ``env://``, and a
``file://`` store needs no port), takes card ``LOCAL_RANK``, and trains
its part of the model (``Model(cfg, mesh=)``: FSDP over ``data``, Megatron
and expert parallelism over ``model``); only rank 0 prints ``final:``. The
dense, VLM and MoE families train on a mesh; the others raise
``InvalidArgError`` there (ROADMAP A.10c).
Checkpoints are in the reference's layout, so ``--resume`` also picks up
one that ``repro.launch.train`` wrote. Weights start from a generator
seeded 0 on the device. The encoder-decoder's batches carry stub frame
embeddings (``FramesStream``), which the reference's launcher lacks.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import errors
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.streams import resolve_device
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.models import Model, axis_rules
from repro_torch.runtime import HeartbeatMonitor, plan_mesh
from repro_torch.training import OPTIMIZERS, TrainLoopConfig, TrainState, run_training

from .mesh import backend_for, make_mesh


class FramesStream:
    """A token stream whose batches also hold the encoder's input: stub frame
    embeddings (B, num_frames, d_model), float32 normals seeded by the step
    (the audio frontend is a stub, as in the reference)."""

    def __init__(self, stream, cfg):
        self.stream, self.cfg = stream, cfg

    def batch(self, step: int) -> dict:
        b = self.stream.batch(step)
        rng = np.random.default_rng(step)
        b["frames"] = rng.standard_normal(
            (len(b["tokens"]), self.cfg.num_frames, self.cfg.d_model)).astype(np.float32)
        return b


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "lion"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--init-method", default="env://",
                    help="the process group's rendezvous with WORLD_SIZE > 1 (env://, "
                         "file:///abs/path, tcp://host:port)")
    args = ap.parse_args(argv)

    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    plan = plan_mesh(ranks, prefer_model=min(16, ranks), global_batch=args.global_batch)
    mesh = None
    if ranks > 1:
        mesh = _join(plan, ranks, args.device, args.init_method)
    try:
        _train(args, cfg, plan, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _join(plan, ranks: int, device, init_method: str):
    """Join the process group from the environment and build ``plan``'s mesh."""
    if plan.dropped_devices:
        raise errors.InvalidArgError(
            f"{ranks} ranks: the mesh {plan.shape} leaves {plan.dropped_devices} idle; "
            f"launch {ranks - plan.dropped_devices}")
    dev = resolve_device(device)
    rank = int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend_for(dev.type), init_method=init_method, rank=rank,
                            world_size=ranks)
    return make_mesh(plan.shape, plan.axis_names, device_type=dev.type)


def _train(args, cfg, plan, mesh) -> None:
    lead = mesh is None or dist.get_rank() == 0
    device = args.device
    if mesh is not None and resolve_device(device).type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    model = Model(cfg, device=device, mesh=mesh)
    if lead:
        where = "one rank" if mesh is None else f"{dist.get_world_size()} ranks"
        print(f"mesh: {dict(zip(plan.axis_names, plan.shape))}  arch: {cfg.name}  "
              f"device: {model.device} ({where})")

    stream = SyntheticTokenStream(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                   global_batch=args.global_batch)
    )
    if cfg.family == "encdec":
        stream = FramesStream(stream, cfg)
    ck = Checkpointer(f"{args.ckpt_dir}/{cfg.name}")
    monitor = HeartbeatMonitor(num_hosts=1)
    loop_cfg = TrainLoopConfig(
        total_steps=args.steps,
        microbatches=args.microbatches,
        optimizer=args.optimizer,
        compression=args.compression,
        peak_lr=args.peak_lr,
        checkpoint_every=max(10, args.steps // 4),
        log_every=max(1, args.steps // 20),
    )

    initial_state = None
    if args.resume and ck.latest_step() is not None:
        params = model.init(torch.Generator(device=model.device).manual_seed(0))
        example = TrainState.create(
            params, OPTIMIZERS[args.optimizer](),
            use_compression=args.compression != "none",
        )
        initial_state = ck.restore(example)
        if lead:
            print(f"resumed from step {int(initial_state.step)}")

    with axis_rules(mesh):
        state, history = run_training(
            model, stream, loop_cfg,
            checkpointer=ck, monitor=monitor, initial_state=initial_state,
        )
    ck.wait()
    if lead:
        print("final:", history[-1])
        if monitor.stragglers:
            print(f"stragglers observed: {len(monitor.stragglers)}")


if __name__ == "__main__":
    main()
