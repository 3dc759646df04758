"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

    python -m repro_torch.launch.train --arch cb-paper                  # on the card
    python -m repro_torch.launch.train --arch cb-paper --smoke --device cpu --steps 3

The port of ``python -m repro.launch.train``, with its flags plus
``--device`` (default: CUDA, which raises ``DeviceUnavailableError``
without a card). Runs the training loop (synthetic token stream,
checkpointing, fault monitoring) on one rank and prints ``plan_mesh``'s
mesh for it. More ranks (``torchrun`` with ``WORLD_SIZE`` > 1) would shard
the model over ``model``: tensor parallelism of the port's models is not
ported (ROADMAP A.10b), so they raise ``InvalidArgError``.
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

from repro_torch import errors
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.models import Model
from repro_torch.runtime import HeartbeatMonitor, plan_mesh
from repro_torch.training import OPTIMIZERS, TrainLoopConfig, TrainState, run_training


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
    args = ap.parse_args(argv)

    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if ranks > 1:
        raise errors.InvalidArgError(
            f"WORLD_SIZE={ranks}: training on more than one rank shards the model over "
            "'model', and tensor parallelism of the port's models is not ported "
            "(ROADMAP A.10b); run one rank")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device)
    plan = plan_mesh(ranks, prefer_model=1, global_batch=args.global_batch)
    print(f"mesh: {dict(zip(plan.axis_names, plan.shape))}  arch: {cfg.name}  "
          f"device: {model.device} (one rank)")

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
        print(f"resumed from step {int(initial_state.step)}")

    state, history = run_training(
        model, stream, loop_cfg,
        checkpointer=ck, monitor=monitor, initial_state=initial_state,
    )
    ck.wait()
    print("final:", history[-1])
    if monitor.stragglers:
        print(f"stragglers observed: {len(monitor.stragglers)}")


if __name__ == "__main__":
    main()
