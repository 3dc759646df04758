"""Serve a small LM with batched requests through the continuous-batching
engine — decode is the SpMV-shaped regime the paper targets.

    PYTHONPATH=src python examples_torch/serve_decode.py                # on the card
    PYTHONPATH=src python examples_torch/serve_decode.py --device cpu

The port of ``examples/serve_decode.py``: the same ``serve-demo`` model and
the same 24 requests. Each tick's CB-sparse MLPs run the SpMM and combine
kernels on the card (``--device cpu``: their plain versions). The weights
come from a generator seeded 0 on the device (the reference's
``PRNGKey(0)``; the two draw different numbers). ``main`` returns what it
printed as numbers, with every request's tokens.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine

SLOTS, MAX_LEN, N_REQUESTS = 8, 128, 24


def build_config() -> ModelConfig:
    return ModelConfig(
        name="serve-demo", family="dense",
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=1024, vocab_size=8192, remat="none", attn_chunk=128,
        sparse_mlp=True, sparse_block=32, sparse_keep=0.5,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = build_config()
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    print(f"serving {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"CB-sparse MLPs (keep={cfg.sparse_keep})")

    engine = ServingEngine(model, params, slots=SLOTS, max_len=MAX_LEN)
    rng = np.random.default_rng(0)
    for uid in range(N_REQUESTS):
        plen = int(rng.integers(2, 16))
        engine.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(4, 20)),
        ))

    t0 = time.monotonic()
    done = engine.run_until_done()
    dt = time.monotonic() - t0
    tokens = sum(len(r.generated) for r in done)
    print(f"{len(done)}/{N_REQUESTS} requests served, {tokens} tokens in "
          f"{engine.ticks} ticks, {dt:.1f}s ({tokens / dt:.1f} tok/s, "
          f"continuous batching over {SLOTS} slots)")
    for r in sorted(done, key=lambda r: r.uid)[:3]:
        print(f"  req {r.uid}: {len(r.generated)} tokens -> {r.generated[:8]}...")
    return {"params": cfg.param_count(), "served": len(done), "requests": N_REQUESTS,
            "tokens": tokens, "ticks": engine.ticks, "serve_s": dt,
            "tokens_per_s": tokens / dt, "slots": SLOTS,
            "generated": {r.uid: list(r.generated) for r in done}}


if __name__ == "__main__":
    main()
