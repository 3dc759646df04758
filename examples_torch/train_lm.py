"""End-to-end example: train a ~100M-param LM with CB block-sparse MLPs for
a few hundred steps on the synthetic stream, with checkpointing and fault
monitoring — the paper's technique as a first-class training feature.

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 300]          # on the card
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 3 --batch 2 --seq 32

The port of ``examples/train_lm.py``: the same model, stream, loop and
printout. Every CB-sparse MLP product (forward, and dX in the backward)
runs the SpMM and combine kernels on the card (``--device cpu``: their
plain versions). Weights start from a generator seeded 0 on the device (the
reference's ``PRNGKey(0)``; the two draw different numbers). Checkpoints go
to ``checkpoints/<config name>`` under the working directory. ``main``
returns what it printed as numbers, with the logged history.
"""
import argparse

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.models import Model
from repro_torch.runtime import HeartbeatMonitor
from repro_torch.training import TrainLoopConfig, run_training


def build_config(sparse: bool) -> ModelConfig:
    # ~100M params: 12L x 512d x 2048ff, 32k vocab
    return ModelConfig(
        name="lm100m-cb" if sparse else "lm100m",
        family="dense",
        num_layers=12, d_model=512, num_heads=8, num_kv_heads=4,
        d_ff=2048, vocab_size=32_000,
        sparse_mlp=sparse, sparse_block=64, sparse_keep=0.5,
        remat="none", attn_chunk=256, dtype="float32",
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dense", action="store_true",
                    help="baseline without CB sparsity")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = build_config(sparse=not args.dense)
    model = Model(cfg, device=args.device)
    n_params = cfg.param_count()
    print(f"config: {cfg.name}  ~{n_params / 1e6:.0f}M params "
          f"(sparse_mlp={cfg.sparse_mlp})")

    stream = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
    ))
    ck = Checkpointer(f"checkpoints/{cfg.name}")
    monitor = HeartbeatMonitor(num_hosts=1)
    loop = TrainLoopConfig(
        total_steps=args.steps,
        checkpoint_every=max(50, args.steps // 4),
        log_every=max(10, args.steps // 20),
        peak_lr=6e-4, warmup_steps=30,
    )
    state, history = run_training(model, stream, loop,
                                  checkpointer=ck, monitor=monitor)
    ck.wait()
    print(f"step {history[0]['step']}: loss {history[0]['loss']:.3f}")
    print(f"step {history[-1]['step']}: loss {history[-1]['loss']:.3f}")
    dloss = history[0]["loss"] - history[-1]["loss"]
    print(f"loss improved by {dloss:.3f} over {args.steps} steps "
          f"({'OK' if dloss > 0 else 'NOT LEARNING'})")
    return {"config": cfg.name, "params": n_params, "sparse_mlp": cfg.sparse_mlp,
            "steps": args.steps, "batch": args.batch, "seq": args.seq,
            "losses": {h["step"]: h["loss"] for h in history}, "loss_improved": dloss,
            "learning": dloss > 0, "history": history,
            "checkpoint_step": ck.latest_step(), "stragglers": len(monitor.stragglers)}


if __name__ == "__main__":
    main()
