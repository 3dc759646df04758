#!/usr/bin/env python
"""Training-loss curves of cb-paper at full width, the port beside the reference.

    PYTHONPATH=src python scripts/loss_probe.py [--layers 2] [--steps 6]
        [--global-batch 8] [--seq-len 256] [--json out.json]
    PYTHONPATH=src python3 scripts/loss_probe.py --port-only --device cuda --layers 36 \\
        --impl cuda reference                     # on a card, no JAX needed

cb-paper (granite-8b widths: d_model 4096, d_ff 14336, vocab 49152, with
CB-sparse SwiGLU at B = 128, keep 0.25, bfloat16 activations, full remat) cut
to ``--layers`` layers, trained with ``launch/train``'s optimizer and schedule
(AdamW, peak lr 3e-4, warmup 10) over ``SyntheticTokenStream`` batches, every
step logged, so each curve is the loss of every step.

By default both packages train on the CPU from the same arrays: the JAX
package (``repro.training.run_training``) from its ``Model.init`` and
``TrainState.create``, then the port (``repro_torch.training.run_training``)
from that state carried across with ``train_state_from_numpy``; the
reference's state is dropped before the port's run starts. That takes
minutes and about 20 GB of host memory at 2 layers. ``--port-only`` trains
the port alone, from weights drawn by a generator seeded 0 on ``--device``,
once per ``--impl`` (the sparse MLP's products: ``cuda``, the kernels on a
card, or ``reference``, the plain oracle), each run from the same weights.
``--dtype float32`` trains those runs with float32 activations.
``--global-batch`` / ``--seq-len`` cut the tokens a step; the output says
what was run.
"""
from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from repro_torch import configs as tconfigs
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.models import Model
from repro_torch.training import (
    OPTIMIZERS, TrainLoopConfig, TrainState, run_training, train_state_from_numpy,
)


def reference_curve(arch: str, layers: int, loop: dict, data: dict):
    """The JAX package's losses and the numpy state both packages start from."""
    import jax
    import numpy as np

    from repro import configs as jconfigs
    from repro.data.synthetic import DataConfig as JDataConfig
    from repro.data.synthetic import SyntheticTokenStream as JStream
    from repro.models import Model as JModel
    from repro.training import OPTIMIZERS as JOPT, TrainLoopConfig as JLoop
    from repro.training import TrainState as JState, run_training as j_run_training

    jmodel = JModel(jconfigs.get_config(arch).scaled(num_layers=layers))
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    jstate = JState.create(params, JOPT["adamw"]())
    host = jax.tree_util.tree_map(np.asarray, jstate)
    _, hist = j_run_training(jmodel, JStream(JDataConfig(**data)), JLoop(**loop),
                             initial_state=jstate)
    del jmodel, params, jstate
    jax.clear_caches()
    gc.collect()
    return [h["loss"] for h in hist], host


def port_curve(model: Model, state: TrainState, loop: dict, data: dict) -> list[float]:
    _, hist = run_training(model, SyntheticTokenStream(DataConfig(**data)),
                           TrainLoopConfig(**loop), initial_state=state)
    return [h["loss"] for h in hist]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="cb-paper")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--port-only", action="store_true",
                    help="train the port alone (no JAX), once per --impl")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--impl", nargs="+", default=["cuda"], choices=["cuda", "reference"])
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="activations (default: the config's, bfloat16); --port-only")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)

    cfg = tconfigs.get_config(args.arch).scaled(num_layers=args.layers)
    if args.dtype is not None:
        if not args.port_only:
            ap.error("--dtype needs --port-only: both packages train the config as it is")
        cfg = cfg.scaled(dtype=args.dtype)
    loop = dict(total_steps=args.steps, optimizer="adamw", log_every=1,
                checkpoint_every=max(10, args.steps // 4))
    data = dict(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                global_batch=args.global_batch)
    print(f"{cfg.name}: d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{args.layers} layers, remat {cfg.remat}, {cfg.dtype} activations; "
          f"{args.steps} AdamW steps of {args.global_batch} x {args.seq_len} tokens "
          f"on {args.device}", flush=True)

    curves, seconds = {}, {}
    if args.port_only:
        for impl in args.impl:
            t0 = time.perf_counter()
            model = Model(cfg, args.device, impl=impl)
            gen = torch.Generator(device=model.device).manual_seed(0)
            state = TrainState.create(model.init(gen), OPTIMIZERS["adamw"]())
            curves[f"port_{impl}"] = port_curve(model, state, loop, data)
            seconds[f"port_{impl}"] = time.perf_counter() - t0
            del model, state
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    else:
        t0 = time.perf_counter()
        curves["reference"], host = reference_curve(args.arch, args.layers, loop, data)
        seconds["reference"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = train_state_from_numpy(host, device=args.device)
        del host
        gc.collect()
        curves["port"] = port_curve(Model(cfg, args.device), state, loop, data)
        seconds["port"] = time.perf_counter() - t0

    names = list(curves)
    print(f"{'step':>4} " + " ".join(f"{n:>14}" for n in names))
    for i in range(args.steps):
        print(f"{i:4d} " + " ".join(f"{curves[n][i]:14.6f}" for n in names))
    first = curves[names[0]]
    result = dict(arch=args.arch, layers=args.layers, steps=args.steps,
                  global_batch=args.global_batch, seq_len=args.seq_len, device=args.device,
                  losses=curves, seconds=seconds,
                  max_abs_diff={n: max(abs(a - b) for a, b in zip(first, curves[n]))
                                for n in names[1:]})
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
