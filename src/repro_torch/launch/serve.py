"""Serving launcher: batched decode with the continuous-batching engine.

    python -m repro_torch.launch.serve --arch cb-paper             # on the card
    python -m repro_torch.launch.serve --arch cb-paper --smoke --device cpu

The flags and the printout of ``python -m repro.launch.serve``, plus
``--device`` (default: CUDA, which raises without a card). Weights are
random, drawn from a generator seeded 0 on that device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))

    engine = ServingEngine(model, params, slots=args.slots, max_len=args.max_len)
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, rng.integers(2, 12))
        engine.submit(Request(uid=uid, prompt=prompt.astype(np.int32),
                              max_new_tokens=args.max_new))

    t0 = time.monotonic()
    done = engine.run_until_done()
    dt = time.monotonic() - t0
    total_tokens = sum(len(r.generated) for r in done)
    print(f"{len(done)} requests, {total_tokens} tokens, "
          f"{engine.ticks} engine ticks, {dt:.2f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s)")
    for r in done[:4]:
        print(f"  req {r.uid}: {r.generated}")


if __name__ == "__main__":
    main()
