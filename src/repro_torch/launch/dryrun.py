"""One-rank dry run: every (arch x shape) cell's step on the meta device.

For each cell this builds the model on the meta device
(``Model.abstract_init``'s parameters: shapes and dtypes, no allocation),
runs the real step on stand-in inputs (``configs.input_specs``) — the train
step with its optimizer update, the prefill forward, or one decode step —
and counts, as it runs:

  * FLOPs — ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
    recompute and backward included);
  * bytes, two counts: the floor — each step input (parameters, optimizer
    state, decode state, the batch) read once and each step output written
    once, what a step that kept every intermediate on chip would still move
    (``bytes_per_device``, ``memory_s`` and ``bottleneck``); and the eager
    ceiling — every dispatched op's tensor inputs and outputs, views left out,
    an unfused count (``bytes_unfused_per_device``, ``memory_unfused_s``,
    left out of ``bottleneck``). ``bytes_counted_as`` in the JSON says so;
  * peak bytes per device — ``torch.distributed._tools.mem_tracker.MemTracker``
    over the step, parameters, optimizer state and inputs included: the
    stand-in for XLA's ``memory_analysis()``.

The step is the port's eager one, so a full-depth run counts every layer
(XLA counts a scanned layer once, which is why the reference extrapolates
from 2- and 4-layer probes; ``probe_costs`` does the same here, a cross-check
of the full count). The CB-sparse MLP runs its kernels' plain versions on
meta tensors: nothing is built and no launch counter moves. One rank: the
collective term is 0 (tensor and expert parallelism are not ported).

Results are printed and dumped as JSON under ``experiments/dryrun_torch/``
in the reference's layout, so ``launch.roofline`` reads both packages' cells.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, input_specs, supports_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import Model
from repro_torch.training import build_train_step
from repro_torch.training.optimizer import adamw
from repro_torch.training.schedule import warmup_cosine
from repro_torch.training.train_state import TrainState

# ---------------------------------------------------------------------------
# NVIDIA H100 80GB HBM3 (SXM, 700 W) constants per card, from NVIDIA's data
# sheet — §Roofline
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12         # HBM3 bytes/s
NVLINK_BW = 450e9        # NVLink 4 bytes/s per direction (900 GB/s both); unused at one rank

MESH = "1"               # one rank, one card

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# ops that allocate without reading or writing any element
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


# gathers: of the table (their first argument) they read only the rows they take
_GATHERS = {torch.ops.aten.embedding, torch.ops.aten.index_select, torch.ops.aten.index,
            torch.ops.aten.gather}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(obj) -> list[torch.Tensor]:
    """The tensors of a pytree, modules' parameters and buffers included."""
    if isinstance(obj, torch.nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    return [t for leaf in pytree.tree_leaves(obj) for t in
            (_tensors(leaf) if isinstance(leaf, torch.nn.Module) else [leaf])
            if isinstance(t, torch.Tensor)]


class OpBytes(TorchDispatchMode):
    """The two byte counts of one step.

    ``bytes``: every dispatched op's tensor inputs and outputs, an unfused
    count: views and bare allocations move nothing; an in-place target counts
    as read and written.

    ``floor``: each of the step's inputs (the tensors of ``inputs``) read
    once, each of its outputs written once: the largest view of an input's
    storage that an op reads, of the table of a gather only the rows it takes;
    the largest view of an input's storage that an op writes in place (an
    optimizer's update, a cache write); and, by ``add_outputs``, what the
    step returns that it made itself. Intermediates move nothing."""

    def __init__(self, inputs=()):
        super().__init__()
        self.bytes = 0
        self._inputs = {_storage(t) for t in _tensors(inputs)}
        self._read: dict[int, int] = {}
        self._written: dict[int, int] = {}

    @property
    def floor(self) -> int:
        return sum(self._read.values()) + sum(self._written.values())

    def _touch(self, into: dict, t: torch.Tensor, nbytes: int) -> None:
        key = _storage(t)
        into[key] = max(into.get(key, 0), min(nbytes, t.untyped_storage().nbytes()))

    def add_outputs(self, out) -> None:
        for t in _tensors(out):
            if _storage(t) not in self._inputs:
                self._touch(self._written, t, _nbytes(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.overloadpacket in _NO_TRAFFIC:
            return out
        self.bytes += sum(_nbytes(t) for t in pytree.tree_leaves((args, kwargs, out))
                          if isinstance(t, torch.Tensor))
        schema = func._schema.arguments
        given = [*zip(schema, args),
                 *((a, kwargs[a.name]) for a in schema if a.name in kwargs)]
        for i, (arg, value) in enumerate(given):
            written = arg.alias_info is not None and arg.alias_info.is_write
            for t in _tensors(value):
                if _storage(t) not in self._inputs:
                    continue
                if written:
                    self._touch(self._written, t, _nbytes(t))
                read = _nbytes(t)
                if i == 0 and func.overloadpacket in _GATHERS:
                    read = min(read, sum(_nbytes(o) for o in _tensors(out)))
                self._touch(self._read, t, read)
        return out


# ---------------------------------------------------------------------------
# step construction per shape kind
# ---------------------------------------------------------------------------

def build_cell(cfg: ModelConfig, shape: ShapeConfig, *,
               serve_dtype: torch.dtype | None = torch.bfloat16):
    """``(run, tracked)`` for one dry-run cell on the meta device: ``run()``
    takes the step once and returns what it makes (the metrics, the logits,
    the new decode state; the train step updates its state in place);
    ``tracked`` is what exists before it (parameters, optimizer state, decode
    state, inputs), for ``MemTracker`` and the byte floor. Serving
    cells cast the parameters to ``serve_dtype`` as the reference does
    (``None`` keeps them float32, as the port's engine serves them)."""
    model = Model(cfg, device="meta")
    params = model.init(None)
    batch = input_specs(cfg, shape)

    if shape.kind == "train":
        moments = torch.bfloat16 if cfg.param_count() > 100e9 else torch.float32
        optimizer = adamw(moments_dtype=moments)
        step = build_train_step(model, optimizer, warmup_cosine(3e-4, 100, 10_000))
        state = TrainState.create(params, optimizer)
        tracked = [params, *state.opt_state.mu, *state.opt_state.nu, *batch.values()]
        return (lambda: step(state, batch)[1]), tracked

    if serve_dtype is not None:
        params = params.to(serve_dtype)
    kw = {}
    if cfg.family == "vlm" and shape.kind == "prefill":
        kw["patch_embeds"] = batch["patch_embeds"]
    if cfg.family == "encdec":
        kw["frames"] = batch["frames"]

    if shape.kind == "prefill":
        def fwd():
            with torch.no_grad():
                return model.forward(params, batch["tokens"], last_only=True, **kw).logits

        return fwd, [params, *batch.values()]

    # decode
    state = model.init_decode_state(shape.global_batch, shape.seq_len)

    def decode():
        with torch.no_grad():
            return model.decode_step(params, state, batch["tokens"], batch["pos"])

    return decode, [params, *pytree.tree_leaves(state), *batch.values()]


def count_cell(cfg: ModelConfig, shape: ShapeConfig, *,
               serve_dtype: torch.dtype | None = torch.bfloat16, memory: bool = True) -> dict:
    """FLOPs, the byte floor and the unfused bytes, and (``memory``) the peak
    bytes of one step of the cell."""
    run, tracked = build_cell(cfg, shape, serve_dtype=serve_dtype)
    mt = MemTracker() if memory else None
    if mt is not None:
        mt.track_external(*tracked)
    counter = OpBytes(tracked)
    with FlopCounterMode(display=False) as flops, mt or contextlib.nullcontext(), counter:
        counter.add_outputs(run())
    out = {"flops": float(flops.get_total_flops()), "bytes_floor": float(counter.floor),
           "bytes_unfused": float(counter.bytes)}
    if mt is not None:
        peak = mt.get_tracker_snapshot("peak")[torch.device("meta")]
        out["memory"] = {str(k).rsplit(".", 1)[-1].lower(): int(v) for k, v in peak.items()}
    return out


# ---------------------------------------------------------------------------
# cost probes — the reference's 2- and 4-layer extrapolation, a cross-check
# ---------------------------------------------------------------------------
# The reference compiles small UNROLLED probes because XLA counts a scanned
# layer once; the port's eager step counts every layer, so these probes are
# not needed for the cells, and serve to check that the full-depth count is
# linear in the layers as the reference assumes.

def _probe_cfgs(cfg: ModelConfig) -> list[tuple[ModelConfig, dict]]:
    base = cfg.scaled(scan_layers=False, attn_unroll=True)
    if cfg.family == "hybrid":
        return [
            (base.scaled(num_layers=2, attn_every=1), {"m": 2, "s": 2}),
            (base.scaled(num_layers=4, attn_every=1), {"m": 4, "s": 4}),
            (base.scaled(num_layers=4, attn_every=2), {"m": 4, "s": 2}),
        ]
    if cfg.family == "encdec":
        return [
            (base.scaled(num_layers=2, encoder_layers=2), {"l": 2}),
            (base.scaled(num_layers=4, encoder_layers=4), {"l": 4}),
        ]
    return [
        (base.scaled(num_layers=2), {"l": 2}),
        (base.scaled(num_layers=4), {"l": 4}),
    ]


def _extrapolate(cfg: ModelConfig, samples: list[tuple[dict, float]]) -> float:
    """Solve the per-layer-species linear model and evaluate at full depth."""
    if cfg.family == "hybrid":
        (_, m1), (_, m2), (_, m3) = samples
        bs = (m2 - m3) / 2.0
        bm = (m2 - m1) / 2.0 - bs
        a = m1 - 2 * bm - 2 * bs
        n_shared = cfg.num_layers // cfg.attn_every
        return a + cfg.num_layers * bm + n_shared * bs
    (_, m1), (_, m2) = samples
    l1, l2 = samples[0][0]["l"], samples[1][0]["l"]
    # per-LAYER slope; grouped MoE (llama4) stays linear in layers because
    # each group is a fixed layer bundle (2 layers incl. 1 MoE).
    b = (m2 - m1) / (l2 - l1)
    a = m1 - l1 * b
    return a + cfg.num_layers * b


COUNTS = ("flops", "bytes_floor", "bytes_unfused")


def probe_costs(cfg: ModelConfig, shape: ShapeConfig, *,
                serve_dtype: torch.dtype | None = torch.bfloat16) -> dict:
    """FLOPs and both byte counts extrapolated to full depth from the probes."""
    samples = [(meta, count_cell(pcfg, shape, serve_dtype=serve_dtype, memory=False))
               for pcfg, meta in _probe_cfgs(cfg)]
    return {key: _extrapolate(cfg, [(m, v[key]) for m, v in samples]) for key in COUNTS}


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def analyze(counts: dict, cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The reference's cell keys from one rank's counts."""
    chips = 1
    flops_dev, bytes_dev = counts["flops"], counts["bytes_floor"]
    mem = {"peak_memory_in_bytes": counts["memory"]["total"],
           "by_kind": {k: v for k, v in counts["memory"].items() if k != "total"},
           "source": "MemTracker peak over the meta step"}

    flops_global = flops_dev * chips
    bytes_global = bytes_dev * chips
    t_compute = flops_global / (chips * PEAK_FLOPS)
    t_memory = bytes_global / (chips * HBM_BW)
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": 0.0}
    bottleneck = max(terms, key=terms.get)
    t_unfused = counts["bytes_unfused"] / HBM_BW     # the eager ceiling: not a bound

    # MODEL_FLOPS: 6·N·D for train (fwd+bwd), 2·N·D for single forward.
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2 * n_active * tokens
    else:
        tokens = shape.global_batch
        model_flops = 2 * n_active * tokens

    return {
        "chips": chips,
        "flops_per_device": flops_dev,
        "flops_global": flops_global,
        "bytes_per_device": bytes_dev,
        "bytes_global": bytes_global,
        "bytes_unfused_per_device": counts["bytes_unfused"],
        "bytes_counted_as": {
            "bytes_per_device": "floor: each step input read once, each output written once",
            "bytes_unfused_per_device": "eager ceiling: every op's tensor inputs and outputs, "
                                        "views left out"},
        # the reference's parse_collectives layout, all zero at one rank
        "collectives": {**{k: {"count": 0, "bytes": 0} for k in _COLLECTIVES},
                        "total_bytes": 0},
        "memory": mem,
        "roofline": {
            **terms,
            "memory_unfused_s": t_unfused,
            "bottleneck": bottleneck.replace("_s", ""),
            "model_flops": model_flops,
            "useful_flops_ratio": (
                model_flops / flops_global if flops_global else 0.0
            ),
        },
    }


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, out_dir: str | None = None,
             cfg_override: ModelConfig | None = None) -> dict:
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    cell = {"arch": arch, "shape": shape_name, "mesh": MESH}

    ok, why = supports_shape(cfg, shape)
    if not ok:
        cell["status"] = "skipped"
        cell["reason"] = why
        _dump(cell, out_dir)
        return cell

    t0 = time.time()
    try:
        counts = count_cell(cfg, shape)
        cell.update(analyze(counts, cfg, shape))
        cell["status"] = "ok"
        # the reference's timing keys: no lowering, compile or probes here;
        # compile_s is the counted meta step's host seconds
        cell["lower_s"] = 0.0
        cell["compile_s"] = round(time.time() - t0, 1)
        cell["probe_s"] = 0.0
    except Exception as e:
        cell["status"] = "FAILED"
        cell["error"] = f"{type(e).__name__}: {e}"
        cell["traceback"] = traceback.format_exc()[-2000:]
    _dump(cell, out_dir)
    return cell


def _dump(cell: dict, out_dir: str | None) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{cell['arch']}_{cell['shape']}_{cell['mesh']}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(cell, f, indent=1)


def _fmt_row(c: dict) -> str:
    if c["status"] != "ok":
        return (f"{c['arch']:26s} {c['shape']:12s} {c['mesh']:8s} "
                f"{c['status']}: {c.get('reason', c.get('error', ''))[:80]}")
    r = c["roofline"]
    return (
        f"{c['arch']:26s} {c['shape']:12s} {c['mesh']:8s} ok "
        f"comp={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
        f"coll={r['collective_s']:.3e}s bound={r['bottleneck']:4s} "
        f"useful={r['useful_flops_ratio']:.2f} "
        f"[{c['compile_s']:.0f}s compile]"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS

    archs = ARCH_IDS if args.all or args.arch is None else [args.arch]
    shapes = (
        list(SHAPES) if args.all or args.shape is None else [args.shape]
    )

    results = []
    for arch in archs:
        for shape in shapes:
            c = run_cell(arch, shape, out_dir=args.out)
            print(_fmt_row(c), flush=True)
            results.append(c)
    n_ok = sum(1 for c in results if c["status"] == "ok")
    n_skip = sum(1 for c in results if c["status"] == "skipped")
    n_fail = sum(1 for c in results if c["status"] == "FAILED")
    print(f"\n{n_ok} ok / {n_skip} skipped / {n_fail} FAILED")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
