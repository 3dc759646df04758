#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

What it does, in order (every line it prints is one JSON object, except
the ``nvidia-smi`` line):

1. ``device``  — the card (name and power limit as ``nvidia-smi`` gives
   them), torch / CUDA / nvcc versions.
2. ``build``   — builds the kernel library from ``src/repro_torch/kernels/csrc``
   (seconds it took).
3. edge grid   — every hand-written kernel (dense, panel, coo, combine,
   spmm) against its plain PyTorch version on the card: B in {8, 16, 24}
   (spmm also 64, 100 and 128, its tensor-core kernel); payload float32,
   bfloat16, float64 (spmm's X float32 and bfloat16); one group and many;
   W = 8 and a large odd multiple of 8; spmm over G in {1, 4, 16} and N in
   {1, 16, 20, 33, 100, 129, 512} (B > 32: G in {1, 2}, N in {1, 20, 100,
   127, 128, 129, 512, 1025, 2049}), and X a view one element past an aligned
   base; an all-padding group; the bitmap panel kernel on sparse panels (a lane in
   five holds a value) against its plain version and bit for bit against the
   padded panel kernel;
   the combine over the row-length profiles it meets (block row 0 with
   35,000 slots, rows at exactly one and two chunks, a row longer than a
   chunk squared, the solver's short rows, an inf slot) at R in {8, 16, 24}
   and SpMM's wide rows (R = B*N up to 524288), the last block row ragged,
   parts and y also one float past an aligned base, two runs bit-equal;
   random data within a tolerance and integer data bit for bit.
3b. ``panel_layouts`` — the padded and the bitmap panel kernels at the panel
   shape of the benchmark's ``hpcg160-spmv`` cell (HPCG's 27-point stencil at
   160^3: panels (155601, 16, 256)), the 32^3 stencil's panel groups tiled to
   that count: the encoding's E and fill, its derivation's seconds, both
   kernels' ``ms`` beside their byte floors, partials bit-equal.
4. ``spmv``, one line per matrix — the main path through the entry points a
   user calls: triplets from the port's seeded generators ->
   ``CBMatrix.from_coo`` -> ``build_super_streams`` -> ``.to()`` (CUDA by
   default) -> ``ops.cb_spmv`` (default ``impl``: the CUDA kernels). The
   launch counters are zeroed just before and read just after one
   ``cb_spmv`` call, so ``launches`` is per call. Then ``y`` is held
   against the float64 ``dense_oracle``, against ``impl="reference"`` on
   the card, a second run must be bit-equal, and each kernel is compared with
   its plain version and timed at this matrix's shapes (the panel format's
   padded and bitmap kernels both; ``cb_spmv`` runs the bitmap one). Three
   matrices, one dominated by each format, B = 16, float32, default
   thresholds and group size, each with streams larger than the card's 50 MB
   L2. Then the whole
   call is timed with ``repro_torch.obs`` on (the default) and its launch
   accounting held to the wrappers' counters: after those calls, obs's
   ``repro.ops.spmv.launches`` / ``steps`` per format must equal each
   wrapper's ``.launches`` and ``spmv_launch_stats`` times the calls
   (``obs_accounting``); ``spmv_enqueue_ms_obs`` is the enqueue with obs on
   and off in turns, and their difference.
5. ``dist``, one ``dist_spmv`` line per matrix, rank count and combine —
   distribution (``repro_torch.core.distributed``) on the ``banded`` and
   ``power_law`` matrices of step 4, their host ``CBMatrix`` reused:
   ``shard_streams`` (Alg. 2 over ranks) at D = 1, 2 and 4, then D ranks
   spawned per D, each joining a process group (one NCCL rank; 2 and 4 gloo
   ranks sharing ``cuda:0``, since NCCL refuses two ranks on one card: those
   times are D shards on one card, not D cards) and calling
   ``distributed_spmv`` over a ``make_mesh`` mesh with ``combine="psum_scatter"``
   and ``"psum"``. Each rank's launch counters and obs are zeroed before and
   read after its first call (held equal); its y is held, gathered, against the
   float64 oracle and the single-device ``cb_spmv`` of step 4 (``KERNEL_TOL``:
   the cross-shard sum runs in another order), two calls bit-equal, and rank 0
   holds each kernel and the combine to its plain version at its shard's
   shapes. Printed: ``dist_spmv_ms`` (rank max, CUDA events as ``time_ms``)
   beside the single-device ``spmv_ms``, ``collective_ms`` (the collective
   alone), ``rank_spmv_ms`` (the rank's ``cb_spmv`` alone), the host's time to
   enqueue each (``*_enqueue_ms``), ``device_nnz``, ``load_imbalance``, every
   rank's launches from the wrappers and from obs. A
   rank that fails or outlives ``DIST_TIMEOUT`` fails the run.
6. ``matmat`` — the multi-RHS product on the ``banded`` matrix of step 4:
   ``super_tile_stream_from_cb`` -> ``.to()`` -> ``ops.cb_spmm`` with 16
   float32 right-hand sides, held against scipy's float64 CSR product, against
   ``impl="reference"``, and against itself (bit-equal); ``torch.sparse`` CSR
   ``A @ X`` is the yardstick.
7. ``plan``, one line per search — the autotuner (``repro_torch.autotune``)
   on the ``spmv`` lines' matrices, float32, the same seeds:
   ``CBMatrix.plan_for`` in ``mode="heuristic"`` (shape arithmetic only) and
   ``mode="timed"`` (its shortlist timed through ``cb_spmv(impl="cuda")`` with
   CUDA events) on ``power_law``. Each line: the
   chosen block size, thresholds, colagg and group size, the cost model's
   predicted and the built streams' measured padded elements and steps,
   ``t_spmv`` and ``plan_s`` (the search's host seconds); then the planned path
   ``from_plan`` -> ``build_super_streams(plan.group_size)`` -> ``.to()`` ->
   ``cb_spmv(plan=)``, counted, held to the float64 oracle, ``impl="reference"``
   and itself (bit-equal), each kernel against its plain version at the
   planned shapes, and timed beside the ``spmv`` line's default configuration
   (``default_spmv_ms``). A timed plan also goes through a ``PlanCache`` round
   trip in a temporary directory: a fresh cache must hit, and the rebuilt run
   must be bit-equal (``plan_cache_hit_s``). ``plan_phase`` gives the phase's
   seconds. The ``solve`` phase adds one more ``plan`` line, ``cg planned``:
   ``CBLinearOperator.from_cb(cb, plan="auto")`` on its SPD matrix, CG on it
   converged, within 2 iterations of the unplanned CG, bit-equal over two runs.
8. ``solve``, one line per run — the solver subsystem (``repro_torch.solvers``)
   on the kernels above, every operator built by ``CBLinearOperator.from_cb``
   on its default device (CUDA), float32, B = 16, default thresholds and
   group size: ``cg`` (block-Jacobi, tol 1e-6) on ``spd_banded(2097152,
   bandwidth=9)`` built with ``rmatvec`` and ``matmat``, held converged, at a
   float64 residual of at most ``RESIDUAL_TOL`` (scipy CSR), within 2
   iterations of ``impl="reference"`` on the card, bit-equal over two runs,
   with scipy's float64 CG count beside it, and ``rmatvec`` against scipy's
   float64 ``A.T @ y``; ``power`` (500 iterations) and ``chebyshev`` (16
   columns through ``matmat``, degree 8, 5 rounds, the interval from the
   host's Gershgorin bounds) on the same matrix, held against
   ``impl="reference"``; ``bicgstab``, ``gmres`` (restart 20) and ``robust``
   (``robust_solve``, its attempt ladder printed, obs's
   ``repro.solvers.robust.attempts`` held to it and each attempt's span
   wall time printed) on ``banded(2097152,
   bandwidth=7, fill=0.8) + 8 I``, held converged at the float64 residual;
   ``pagerank`` on the edges of ``power_law(262144, 262144, avg_deg=8)``
   held against scipy's float64 damped power iteration (L1), then
   ``EvolvingPageRank`` over three seeded weight steps, each step's streams
   and result bit-equal to a fresh build's. Each line: ``iterations``,
   ``solve_ms`` (CUDA events around the whole solve, warm, median of 3),
   ``iter_ms``, ``iter_enqueue_ms`` (the host's time to enqueue one
   iteration), ``spmv_ms`` of one ``cb_spmv`` on the same operator,
   ``host_syncs`` (reads of the loop's stop flag) and ``library_iter_ms`` (the
   same solver over ``torch.sparse`` CSR products, a yardstick). The launch
   counters are zeroed before and read after one counted run of each.
9. ``mlp_train`` — one training step of the cb-paper MLP at full width
   (granite-8b's d_model 4096 and d_ff 14336, B = 128, keep 0.25, 4096
   tokens): three ``CBSparseLinear`` layers, ``silu(gate(x)) * up(x)`` ->
   ``down``, mean squared error, ``backward()``, SGD. Held against the same
   step in float64 with dense masked weights, two steps bit-equal; the dense
   ``torch.matmul`` step (TF32 off and on) is the yardstick.
10. ``serve`` — the ``cb-paper`` model (granite-8b at full width: d_model 4096,
   32 heads, 8 KV heads, d_ff 14336, vocab 49152, all 36 layers, CB-sparse
   SwiGLU at B = 128 and keep 0.25, bfloat16 activations, float32 weights from
   a seeded CUDA generator, about 14 GB) built by ``repro_torch.models.Model``
   on the card and served through ``repro_torch.serving.ServingEngine`` with
   ``launch/serve``'s traffic: 8 requests, prompts of 2-11 tokens from
   ``np.random.default_rng(0)``, 16 new tokens each, 4 slots, ``max_len`` 256.
   The launch counters are zeroed before and read after the first run (and
   obs's ``repro.ops.spmm.launches`` held to the wrapper's); a second run must
   generate the same tokens. Each tick runs between CUDA events
   (``tick_ms``, the median); ``tick_enqueue_ms`` is the host's time to enqueue
   one ``decode_step`` and ``device_tick_ms`` the same step captured in a CUDA
   graph and replayed; ``bound_ms`` is the bytes a tick must move (the float32
   weights, the gathered embedding rows, the KV cache) over 3.35 TB/s. Checks:
   one tick's logits on ``impl="cuda"`` against ``impl="reference"``
   (``SERVE_IMPL_TOL``), teacher-forced ``decode_step`` against ``forward`` at
   float32 with two layers (``DECODE_TOL``, the reference's check), and the
   spmm kernel and the combine against their plain versions at the decode
   shape (tiles (896, 128, 128), N = 4, X bfloat16 as the path passes it, gate
   and down). One layer's MLP at that shape is timed through the port and
   through ``torch.matmul`` of its dense weights (float32 and bfloat16), a
   yardstick.
11. ``train`` — the ``cb-paper`` model of step 10 (36 layers, full width, float32
   weights from a seeded CUDA generator, ``remat="full"``) trained by
   ``repro_torch.training.run_training`` with AdamW on ``launch/train``'s
   traffic: ``SyntheticTokenStream``, global batch 8 x 256 tokens, one
   microbatch, no compression, 6 steps, every step logged (so synchronised),
   no checkpointer. The serve phase's weights are freed first: params, grads
   and two moments are 56 GB. The launch counters and obs's
   ``repro.ops.spmm.launches`` are zeroed before and read after the run and
   held to the count the code gives (``train_launches_per_step``: 9 spmm
   launches a layer a step). Then: ``step_ms`` (host clock around each
   synchronised step, median of steps 2-6), ``tokens_per_s``, ``fwd_ms`` /
   ``bwd_ms`` / ``optimizer_ms`` (CUDA events on one more step),
   ``peak_mem_gb`` (``torch.cuda.max_memory_allocated``), the device's idle
   share and its time by kernel group (``torch.profiler`` over one more step),
   and ``bound_ms`` (``train_bound``). Checks: finite losses; two 2-step runs
   from the same init bit-equal (losses and parameters); at full width with 2
   layers, ``impl="cuda"`` against ``"reference"`` (loss within
   ``TRAIN_IMPL_TOL``, ``grad_norm`` within ``TRAIN_GNORM_TOL``) and bfloat16
   against float32 activations (``BF16_F32``); the spmm kernel and the combine
   against their plain versions at the training shapes (N = 2048: forward with
   X bfloat16, dX with dY float32; gate and down). ``train_resume``:
   ``cb-paper-smoke`` 10 steps with a checkpoint at 5 and 10, restored at 5
   and run to 10, parameters bit-equal to the straight run's.
11b. ``mesh`` — the ``train`` line's training on a ``(data, model)``
   ``DeviceMesh`` (``Model(cfg, mesh=)``: DTensor parameters, FSDP over
   ``data``, Megatron and expert parallelism over ``model``, the batch split
   over ``data``), through ``run_training`` under the mesh's ``axis_rules`` as
   ``launch/train`` runs it, the launch counters zeroed just before and read
   just after each run. ``mesh_train`` 1x1: one NCCL rank in this process,
   cb-paper at full depth, 2 steps from the ``train`` phase's weights; the
   losses and every parameter must be bit-equal to that phase's 2-step run (a
   one-rank collective runs nothing), ``step_ms`` beside the ``train`` line's,
   324 spmm and combine launches a step. ``mesh_train`` 2x2: four gloo ranks
   spawned on ``cuda:0`` (NCCL refuses two ranks on one card: four shards on
   one card, not four cards), cb-paper at full width with 2 of its 36 layers,
   2 steps; loss and ``grad_norm`` within ``MESH_TOL`` of one rank from the
   same weights, each rank's spmm and combine launches held to the count, the
   replicated CB tiles bit-equal on every rank after each step (sha256), each
   rank's peak, and rank 0's spmm and combine against their plain versions at
   its forward shapes (N = 1024 local tokens, X bfloat16), timed beside them
   and their library calls (rows of the ``kernels`` line). ``mesh_moe`` 1x2: mixtral-8x7b
   at full width, 2 of 32 layers, float32 activations, two gloo ranks holding
   4 of 8 experts each, one AdamW step after the one-rank run (freed first: its
   state is 54 GB): loss and ``grad_norm`` within ``MESH_TOL``, the routing
   counts of every layer equal. A rank that fails or outlives ``MESH_TIMEOUT``
   fails the run.
11c. ``mesh_families`` (``run_mesh_families``) — every family and decoding on
   a mesh. ``mesh_serve`` 1x1: one NCCL rank, cb-paper at full depth served
   through ``ServingEngine`` with the ``serve`` line's traffic on DTensor
   weights under ``rules_for``'s decode rules: tokens bit-equal to the
   ``serve`` line's, the same launches, ``tick_ms`` beside its. ``mesh_family``
   1x1: mamba2-130m, zamba2-2.7b and whisper-small at full config, 2 AdamW
   steps of the ``train`` traffic (whisper with stub frames) on one NCCL rank:
   losses and every parameter bit-equal to a local run in this process,
   ``step_ms`` and ``peak_mem_gb`` beside its. Then two gloo ranks spawned on
   ``cuda:0`` (1x2: two ranks sharing the card, not two cards), each family at
   2 layers: 2 steps, loss and ``grad_norm`` within ``MESH_TOL`` of one rank,
   the state's bytes a rank; and ``mesh_serve`` 1x2, cb-paper, mamba2 and
   whisper at 2 layers and float32 activations, ``MESH_SERVE_STEPS``
   teacher-forced ``decode_step``s with the KV cache's sequence split over
   the two ranks (mamba2's conv state over them, whisper's cross k / v by
   batch): logits within ``MESH_SERVE_TOL`` of one rank's, the same tokens,
   each rank's spmm and combine launches held to the code's count, and rank
   0's spmm and combine against their plain versions at its shapes (N = 4
   rows; rows of the ``kernels`` line).
12. ``dryrun`` — the one-rank dry run (``repro_torch.launch.dryrun``: the
   step on the meta device, FLOPs from ``FlopCounterMode``, the byte floor
   (each step input read once, each output written once) and the unfused op
   bytes, the peak from ``MemTracker``; no kernel is built or launched, and the
   wrappers' counters are held at 0 across it) against what the card measured.
   ``dryrun train``: cb-paper's training step at the ``train`` line's shape
   (8 x 256, ``remat="full"``): ``flops_counted`` beside ``train_bound``'s
   bf16 and sparse products (outside 0.98-1.02 fails), ``peak_est_gb`` beside
   the measured ``peak_mem_gb`` with their ratio, ``compute_ms`` / ``memory_ms``
   / ``memory_unfused_ms`` (the counts over the H100 data-sheet rates) beside
   ``step_ms``. ``dryrun serve``: one decode step at the ``serve`` line's shape
   (4 slots, ``max_len`` 256, float32 weights as the engine serves them): the
   byte floor beside the line's ``tick_bytes`` plus the new KV cache the step
   writes (outside 1 to 1 + ``DRYRUN_FLOOR_SLACK`` / layers fails: one layer
   uncounted falls below), and all three counts beside the 2- and 4-layer
   probes extrapolated (apart by more than ``DRYRUN_PROBE_TOL`` fails: some
   layers counted differently from others). ``dryrun_mesh``: cb-paper's
   ``train_4k`` and ``decode_32k`` and mixtral's ``train_4k`` (TP-MoE) on the
   16x16 production mesh (a spawned process each, torch.distributed's
   ``"fake"`` backend, ``rules_for``), beside the same cells at one rank:
   per-card FLOPs, byte floor, peak, collectives by kind and axis,
   ``collective_s`` at the NIC's rate, ``bottleneck``, whether the card's
   80 GB hold it; the per-card parameter and optimizer (or decode state) bytes
   must equal the local shard sizes of the sharding tree; 256 x the per-card
   FLOPs over the one-rank count, with the replicated compute listed.
   ``dryrun_sweep``: every (arch x shape) cell of the ten archs and cb-paper
   on the 16x16 mesh, in ``DRYRUN_WORKERS`` spawned processes:
   ok / skipped / FAILED counts (any FAILED fails, and so does a split other
   than ``supports_shape``'s) and seconds.
13. ``families`` — the MoE, SSM, hybrid and encoder-decoder families served
   through ``ServingEngine`` (a ``family`` line each; ``PERF.md`` section 4).
14. ``examples`` — the port's five examples (``examples_torch/``) and two
   tools (``scripts/explain_torch.py``, ``scripts/obs_report_torch.py``), each
   ``main([])`` run in-process at its own size on the card, in a temporary
   working directory (``train_lm``'s checkpoints, ``obs_report``'s trace): the
   launch counters zeroed before it and read after (``distributed_spmv``'s 8
   gloo ranks report theirs), then its checks (``example_<name>``): quickstart
   against the float64 oracle, ``impl="reference"`` and a bit-equal rerun;
   solve_poisson's CG iterations equal to ``impl="reference"``'s and its
   float64 residual; distributed_spmv's ranks, ``device_nnz``, imbalance and
   y; serve_decode's 24 requests, tokens equal over two runs, launches a tick
   held to ``decode_launches_per_step``; train_lm's falling loss, launches a
   step held to ``train_launches_per_step``; obs_report's spans, counters,
   timed plan and float64 residual; explain's schema and its roofline at
   ``F32_FLOPS_PER_S`` / ``HBM_BYTES_PER_S``. Each SpMV kernel and the combine
   at the example's streams, and spmm and the combine at serve_decode's (B 32,
   N 8, X bfloat16) and train_lm's (B 64, N 2048, X float32) shapes, against
   their plain versions (rows of the ``kernels`` line). An ``example`` line
   each, then ``examples_phase`` with its seconds.
15. ``kernels`` — per kernel: launches on the main paths (one ``cb_spmv`` call
   on each matrix, one ``cb_spmm`` call, the planned calls, the counted solver
   runs, one MLP training step, the first served run, the 6 trained steps,
   every rank's first ``distributed_spmv`` call, the mesh runs' every rank, the
   examples' runs, summed;
   ``launches_per_call``
   has them apart, keyed by the counted run, the solver runs per iteration, the
   served run per tick, the training run per step, a dist run over its ranks),
   worst error seen,
   time (and the host's time to enqueue one call, ``enqueue_ms``: where it
   is the larger, the row's time is the host's), plain version's time, the bound (the least time the card could
   take: bytes moved over 3.35 TB/s against flops over the rate of the
   arithmetic the kernel runs — 67 TFLOP/s float32, or 165 TFLOP/s for
   the spmm kernel's 3xTF32 tensor-core products at B > 32; the combine's
   bytes are those of any deterministic combine, ``combine_bytes``), and a
   library call's time where one computes the same function.
16. the ``nvidia-smi`` name and power limit, then the verdict line.

Any failed check, a missing GPU, a build error or a launch error ends the
run with a non-zero exit code and no ``"ok": true`` line. Times are taken
with CUDA events over warm, back-to-back calls (see ``time_ms``).
``torch.sparse``, ``torch.einsum``, ``index_add_`` and the dense
``torch.matmul`` appear here as yardsticks only, and ``torch.bmm`` as one too
except in the sparse layer's dW, which the JAX package also leaves outside
any kernel; the port's CUDA path calls none of the others, but for the
models' dense projections, attention, norms, loss and optimizer
(``torch.einsum`` / ``matmul``, elementwise and ``torch._foreach_*`` ops),
which the JAX package leaves to XLA too. Float32 matrix
products run in full float32 (``allow_tf32`` is set False) unless a line
says otherwise. The sizes
are fixed: the script has no rehearsal mode, so its verdict line always
speaks of the full-size run.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import contextlib
import copy
import dataclasses
import faulthandler
import hashlib
import importlib.util
import inspect
import json
import math
import multiprocessing
import multiprocessing.forkserver
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.sparse
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.core import CBMatrix, dense_oracle  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    ShardedStreams, distributed_spmv, shard_streams,
)
from repro_torch.core.streams import (  # noqa: E402
    _STREAM_FIELDS as STREAM_FIELDS, SpMVStreams, build_super_streams, build_super_tile_stream,
    tile_stream_from_cb,
)
from repro_torch.data import matrices  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, cb_block_dense, cb_colagg, cb_combine, cb_coo, cb_spmm, ops,
)
from repro_torch import obs, solvers  # noqa: E402
from repro_torch.autotune import PlanCache, SearchSettings  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS, SHAPES, ShapeConfig, get_config, get_smoke_config, supports_shape,
)
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh, rules_for  # noqa: E402
from repro_torch.launch.train import FramesStream  # noqa: E402
from repro_torch.models import Model, axis_rules, encdec, moe  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import sharding as model_sharding  # noqa: E402
from repro_torch.models.sharding import full_tensor  # noqa: E402
from repro_torch.serving import Request, ServingEngine, greedy_decode  # noqa: E402
from repro_torch.solvers import _loop as solver_loop  # noqa: E402
from repro_torch.sparse import linear as sparse_linear  # noqa: E402
from repro_torch.training import (  # noqa: E402
    OPTIMIZERS, TrainLoopConfig, TrainState, build_train_step, run_training, warmup_cosine,
)
from repro_torch.training.optimizer import global_norm  # noqa: E402

from examples_torch import ENTRY_POINTS  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 rate outside the tensor cores
TF32X3_FLOPS_PER_S = 495e12 / 3  # H100 SXM dense TF32 tensor-core rate (NVIDIA data
                                 # sheet), three TF32 products per float32-grade
                                 # product: the spmm kernel's rate at B > 32
REPS = 20                      # timed calls per batch (see time_ms)
KERNEL_TOL = 1e-4              # kernel vs plain: f32 sums of <= 24 products (dense) or 8
                               # (panel, coo), <= 128 (spmm), or of a block row's slots
                               # (combine), taken in another order; relative to
                               # max(1, max |plain|)
ORACLE_TOL = 1e-4              # y vs float64 oracle: f32 accumulation over a row's nnz,
                               # relative to (|A| |x|)_row
# the cb-paper MLP (src/repro/configs/__init__.py: granite-8b widths, CB-sparse SwiGLU)
# over one 4096-token sequence of the train_4k shape
MLP = dict(d_model=4096, d_ff=14336, block_size=128, keep_fraction=0.25, tokens=4096)
TRAIN_TOL = 1e-4               # MLP step vs float64 dense: y, dX and d_tiles each within
                               # this fraction of the float64 result's largest magnitude.
                               # f32 sums of 1024 (forward, dX) or 4096 (dW) products
                               # carry ~1e-6 of that; 1e-4 leaves room for the three
                               # chained products and the silu between them
# the solve phase's matrices (fixed; PERF.md section 4 says why these sizes)
SOLVE = dict(spd=2_097_152, nonsym=2_097_152, graph=262_144)
RESIDUAL_TOL = 2e-6            # ||b - A x|| / ||b|| in float64 after a solve to tol 1e-6:
                               # the float32 residual the solver stops on, plus the float32
                               # rounding of A x (~3e-7 of ||b|| at these matrices)
EIG_TOL = 1e-5                 # power iteration's eigenvalue vs impl="reference", relative
RITZ_TOL = 1e-4                # Chebyshev Ritz values vs impl="reference", relative
PAGERANK_L1 = 1e-5             # PageRank vs scipy float64: the port stops on an L1 step of
                               # 1e-7, which leaves ~0.85 / 0.15 * 1e-7 = 6e-7 to the limit


def emit(tag: str, **fields) -> None:
    print(json.dumps({tag: fields}), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args()


DEV = torch.device("cuda")
WRAPPERS = {
    "dense": cb_block_dense.block_dense_spmv_batched,
    "panel": cb_colagg.panel_spmv_batched,
    "panel_bitmap": cb_colagg.panel_spmv_bitmap,
    "coo": cb_coo.coo_spmv_batched,
    "combine": cb_combine.segment_combine,
    "spmm": cb_spmm.super_tile_spmm,
}
# kernels the main path no longer launches, held and timed beside the one that replaced
# them: cb_spmv runs the bitmap panel kernel on CUDA, the padded one is its bit-exact reference
REFERENCE_KERNELS = frozenset({"panel"})
KERNEL_INFO = {
    "dense": ("src/repro_torch/kernels/csrc/cb_block_dense.cu",
              "src/repro/kernels/cb_block_dense.py:53"),
    "panel": ("src/repro_torch/kernels/csrc/cb_colagg.cu",
              "src/repro/kernels/cb_colagg.py:57"),
    "panel_bitmap": ("src/repro_torch/kernels/csrc/cb_colagg.cu",
                     "src/repro/kernels/cb_colagg.py:57"),
    "coo": ("src/repro_torch/kernels/csrc/cb_coo.cu",
            "src/repro/kernels/cb_coo.py:71"),
    # not a TPU kernel: the XLA scatter-add around them, which CUDA must order itself
    "combine": ("src/repro_torch/kernels/csrc/cb_combine.cu",
                "src/repro/kernels/ops.py:367"),
    "spmm": ("src/repro_torch/kernels/csrc/cb_spmm.cu",
             "src/repro/kernels/cb_spmm.py:71"),
}
# every process this script starts is forked from one server that has imported this
# script's modules once, where "spawn" imported them again in every rank and worker
# (15-30 s a group of ranks on an H100 host). The preload is named: the server skips
# "__main__" (Python 3.12 passes the main path under a key it does not read). The
# server touches no card, so each rank starts CUDA on its own
MP = multiprocessing.get_context("forkserver")
MP.set_forkserver_preload(["chip_smoke"])
# on the way out (a failed run's too), stop the server and wait for it: left to
# itself it outlives this process while its imports unwind
atexit.register(multiprocessing.forkserver._forkserver._stop)
worst_err = {k: 0.0 for k in WRAPPERS}       # max abs error vs plain, all comparisons
worst_rel = {k: 0.0 for k in WRAPPERS}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Device time of one ``fn()``: ``reps`` calls enqueued back to back between
    two CUDA events, divided by ``reps``; the median of three such batches.

    Back-to-back calls keep the device's queue full, so the figure is the
    device's time per call as long as the host enqueues faster than the
    device runs (``enqueue_ms`` says whether it does).
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    batches = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        batches.append(a.elapsed_time(b) / reps)
    return statistics.median(batches)


def enqueue_ms(fn, reps: int = REPS) -> float:
    """Host time to enqueue one ``fn()`` (no synchronisation inside the loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def bound(nbytes: int, flops: int, flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def combine_bytes(parts: torch.Tensor, y_len: int) -> int:
    """What any deterministic combine must move, whatever its plan: the
    partials read once, one int32 of permutation per slot, y read and written
    once."""
    return nbytes(parts) + 4 * parts.shape[0] + 2 * 4 * y_len


def compare(name: str, got: torch.Tensor, want: torch.Tensor, where: str, exact=False):
    """Hold a kernel's output against its plain version's; record the error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name} at {where}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    if exact:
        if not torch.equal(got, want):
            fail(f"{name} at {where}: integer data not bit-equal to the plain version")
        return
    err = (got - want).abs().max().item() if got.numel() else 0.0
    scale = max(1.0, want.abs().max().item() if want.numel() else 0.0)
    if name in worst_err:                   # a library yardstick is checked, not recorded
        worst_err[name] = max(worst_err[name], err)
        worst_rel[name] = max(worst_rel[name], err / scale)
    if err > KERNEL_TOL * scale:
        fail(f"{name} at {where}: max abs err {err:.3e} > {KERNEL_TOL} * {scale:.3e}")


# ---------------------------------------------------------------------------
# kernel-level calls: (wrapper call, plain call) on the same device tensors
# ---------------------------------------------------------------------------

def dense_pair(tiles, xg):
    return (lambda: cb_block_dense.block_dense_spmv_batched(tiles, xg),
            lambda: cb_block_dense.block_dense_spmv_plain(tiles, xg))


def panel_pair(panels, xg):
    return (lambda: cb_colagg.panel_spmv_batched(panels, xg),
            lambda: cb_colagg.panel_spmv_plain(panels, xg))


def panel_bitmap_pair(enc, xg):
    return (lambda: cb_colagg.panel_spmv_bitmap(enc.cvals, enc.mask, xg),
            lambda: cb_colagg.panel_spmv_bitmap_plain(enc.cvals, enc.mask, xg))


def format_launches(counted: dict, fmt: str) -> int:
    """A format's kernel launches: the panel format's are the bitmap kernel's on
    the card (and the padded one's where a check runs it)."""
    return counted[fmt] + (counted["panel_bitmap"] if fmt == "panel" else 0)


def coo_pair(codes, vals, xidx, x, B):
    return (lambda: cb_coo.coo_spmv_batched(codes, vals, xidx, x, block_size=B),
            lambda: cb_coo.coo_spmv_plain(codes, vals, xidx, x, block_size=B))


def combine_pair(m, parts, brow, B, plan=None, y=None):
    """Both add into ``y`` in place; without one, each call gets fresh zeros
    (for comparing). For timing pass a buffer: the calls then accumulate into
    it and the figure holds no allocation and no fill."""
    def run(fn, *extra):
        out = torch.zeros(m, dtype=torch.float32, device=DEV) if y is None else y
        return fn(out, parts, brow, B, *extra)
    plan = plan or cb_combine.plan_combine(brow, DEV)
    return (lambda: run(cb_combine.segment_combine, plan),
            lambda: run(cb_combine.combine_plain))


def spmm_flops_per_s(B: int) -> float:
    """The rate of the arithmetic the spmm kernel runs at block size B
    (csrc/cb_spmm.cu: 3xTF32 tensor cores above 32, float32 FMA below)."""
    return TF32X3_FLOPS_PER_S if B > 32 else F32_FLOPS_PER_S


def spmm_pair(tiles, bcol, Xb):
    return (lambda: cb_spmm.super_tile_spmm(tiles, bcol, Xb),
            lambda: cb_spmm.super_tile_spmm_plain(tiles, bcol, Xb))


def panel_library(panels, xg):
    """One PyTorch call for the panel kernel's function: each slot's 8 lanes contracted."""
    gp, B, W = panels.shape
    return torch.einsum("grsk,gsk->gsr", panels.view(gp, B, W // 8, 8), xg.view(gp, W // 8, 8))


def edge_grid(seed: int) -> int:
    """Every kernel vs its plain version over the edge shapes; returns the case count."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cases = 0

    def payload(shape, dtype, integer):
        if integer:
            return torch.randint(-4, 5, shape, generator=gen).to(dtype).to(DEV)
        return torch.randn(shape, generator=gen).to(dtype).to(DEV)

    for B in (8, 16, 24):
        mask_bits = cb_coo.row_mask(B).bit_length()
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            for groups in (1, 37):
                for integer in (False, True):
                    tag = f"B={B} {dtype} groups={groups}"
                    for G in (1, 16):
                        k, p = dense_pair(payload((groups, G * B, B), dtype, integer),
                                          payload((groups, G, B), torch.float32, integer))
                        compare("dense", k(), p(), f"{tag} G={G}", exact=integer)
                    for W in (8, 8 * 129):
                        xg = payload((groups, W), torch.float32, integer)
                        k, p = panel_pair(payload((groups, B, W), dtype, integer), xg)
                        compare("panel", k(), p(), f"{tag} W={W}", exact=integer)
                        sparse = payload((groups, B, W), dtype, integer)
                        sparse *= (torch.rand((groups, B, W), generator=gen) < 0.2).to(DEV)
                        enc = cb_colagg.compact_panels(sparse)
                        k, p = panel_bitmap_pair(enc, xg)
                        compare("panel_bitmap", k(), p(), f"{tag} W={W}", exact=integer)
                        compare("panel_bitmap", k(), panel_pair(sparse, xg)[0](),
                                f"{tag} W={W} against the padded kernel", exact=True)
                        rows = torch.randint(0, B, (groups, W), generator=gen)
                        cols = torch.randint(0, 1 << mask_bits, (groups, W), generator=gen)
                        codes = ((cols << mask_bits) | rows).to(torch.int32).to(DEV)
                        vals = payload((groups, W), dtype, integer)
                        vals[:, W // 2:] *= (torch.rand((groups, W - W // 2), generator=gen)
                                             .to(DEV) < 0.5)       # padding lanes: val == 0
                        x = payload((3 * W,), torch.float32, integer)
                        xidx = torch.randint(0, 3 * W, (groups, W), generator=gen).to(DEV)
                        xidx = xidx.masked_fill(vals == 0, 0).to(torch.int32)  # and xidx == 0
                        k, p = coo_pair(codes, vals, xidx, x, B)
                        compare("coo", k(), p(), f"{tag} W={W}", exact=integer)
                        cases += 4
        # an all-padding group: zero payload, brow 0, code 0
        z = torch.zeros
        compare("dense", *[f() for f in dense_pair(z((2, 4 * B, B), device=DEV),
                                                   payload((2, 4, B), torch.float32, False))],
                "all-padding", exact=True)
        compare("panel", *[f() for f in panel_pair(z((2, B, 24), device=DEV),
                                                   payload((2, 24), torch.float32, False))],
                "all-padding", exact=True)
        compare("panel_bitmap", *[f() for f in panel_bitmap_pair(
            cb_colagg.compact_panels(z((2, B, 24), device=DEV)),
            payload((2, 24), torch.float32, False))], "all-padding", exact=True)
        compare("coo", *[f() for f in coo_pair(z((2, 24), dtype=torch.int32, device=DEV),
                                               z((2, 24), device=DEV),
                                               z((2, 24), dtype=torch.int32, device=DEV),
                                               payload((24,), torch.float32, False), B)],
                "all-padding", exact=True)
    return cases + combine_edge_grid(gen, payload) + spmm_edge_grid(gen, payload)


def run_panel_layouts(seed: int) -> None:
    """The padded and the bitmap panel kernels at ``hpcg160-spmv``'s panel shape:
    the 32^3 stencil's panel groups tiled to the 155,601 of its 160^3 stencil,
    a random x; held bit-equal, each timed beside its byte floor."""
    n, groups = 32, 155601
    rows, cols, vals = matrices.stencil_27(n)
    cb = CBMatrix.from_coo(rows, cols, vals.astype(np.float32), (n ** 3, n ** 3),
                           block_size=16, val_dtype=np.float32)
    small = build_super_streams(cb).to(DEV).panel_vals
    panels = small.repeat(-(-groups // small.shape[0]), 1, 1)[:groups].contiguous()
    del small
    xg = torch.randn((groups, panels.shape[2]), device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = cb_colagg.compact_panels(panels)
    torch.cuda.synchronize()
    derive_s = time.perf_counter() - t0
    out = torch.empty((groups, panels.shape[2] // 8, panels.shape[1]), device=DEV)
    padded = lambda: cb_colagg.panel_spmv_batched(panels, xg, out=out)     # noqa: E731
    bitmap = lambda: cb_colagg.panel_spmv_bitmap(enc.cvals, enc.mask, xg, out=out)  # noqa: E731
    want = padded().clone()
    if not torch.equal(bitmap(), want):
        fail("panel_layouts: the bitmap kernel's partials are not bit-equal to the padded one's")
    nnz = int((panels != 0).sum())
    sizes = {"padded": nbytes(panels, xg, out), "bitmap": enc.nbytes + nbytes(xg, out)}
    ms = {"padded": time_ms(padded), "bitmap": time_ms(bitmap)}
    emit("panel_layouts", at=f"stencil_27({n}) panel groups tiled to {tuple(panels.shape)}",
         E=enc.cvals.shape[2], fill=100 * nnz / panels.numel(), compact_fill=100 * nnz / enc.elems,
         derive_s=derive_s,
         bytes=sizes, ms=ms, bound_ms={k: b / HBM_BYTES_PER_S * 1e3 for k, b in sizes.items()},
         TBps={k: sizes[k] / ms[k] / 1e9 for k in ms}, bit_equal=True)
    del panels, xg, enc, out, want
    torch.cuda.empty_cache()


def at_offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``off`` floats past an aligned base."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    buf[off:].copy_(t.reshape(-1))
    return buf[off:].view(t.shape)


def combine_case(gen, payload, R, lengths, tag, off=0, inf_row=None, chunk=None) -> int:
    """The combine at row width R over block rows of these slot counts (slots
    shuffled, last block row ragged, y not zero): random data within
    KERNEL_TOL and integer data bit-equal to the plain version, two runs
    bit-equal; ``off`` puts parts and y one float past an aligned base;
    ``inf_row`` puts an inf in one slot of that row, which must reach that
    row's element and no other; ``chunk``, the chunk length the plan must have."""
    counts = torch.tensor(lengths)
    brow = torch.repeat_interleave(torch.arange(len(lengths)), counts)
    brow = brow[torch.randperm(len(brow), generator=gen)].to(torch.int32).to(DEV)
    plan = cb_combine.plan_combine(brow, DEV)
    T, m = brow.numel(), len(lengths) * R - min(5, R - 1)
    where = f"{tag} R={R} T={T} offset={off}"
    if len(plan.passes) != 1 + bool(max(lengths) > plan.chunk) or (chunk and plan.chunk != chunk):
        fail(f"combine at {where}: {len(plan.passes)} passes for rows of at most "
             f"{max(lengths)} slots in chunks of {plan.chunk} (meant {chunk})")
    for integer in (False, True):
        parts = at_offset(payload((T, R), torch.float32, integer), off)
        y0 = payload((m,), torch.float32, integer)
        if inf_row is not None and not integer:
            slot = int(torch.nonzero(brow == inf_row)[0])
            parts[slot, R // 2] = float("inf")
        runs = [cb_combine.segment_combine(at_offset(y0, off), parts, brow, R, plan)
                for _ in range(2)]
        want = cb_combine.combine_plain(y0.clone(), parts, brow, R)
        if not torch.equal(runs[0], runs[1]):
            fail(f"combine at {where}: two runs are not bit-equal")
        if inf_row is not None and not integer:
            at = inf_row * R + R // 2
            bad = ~torch.isfinite(runs[0])
            if not (bad[at] and int(bad.sum()) == 1 and torch.equal(bad, ~torch.isfinite(want))):
                fail(f"combine at {where}: the inf of row {inf_row} did not land there alone")
            runs[0][at], want[at] = 0.0, 0.0
        compare("combine", runs[0], want, where, exact=integer)
    return 2


def combine_edge_grid(gen, payload) -> int:
    """The combine over the row-length profiles it meets and their edges:
    block row 0 with 35,000 slots (the packer's padding) beside a spread of
    rows, one row longer than a chunk squared, rows at exactly one and two
    chunks and one slot either side, the solver's short rows, one slot, an inf
    slot in a long row and in a short one; R in {8, 16, 24, 256, 3048 (B = 24,
    N = 127), 3096, 65536, 524288 (the MLP's 128 x 4096)}; parts and y at a
    4-byte offset."""
    c = cb_combine.chunk_length(cb_combine.MAX_POSITIONS, 0)  # the chunk at these slot counts
    spread = torch.randint(1, 600, (299,), generator=gen).tolist()
    cases = 0
    for R in (8, 16, 24):
        cases += combine_case(gen, payload, R, [1], "one slot")
        cases += combine_case(gen, payload, R, [250] + [6] * 39, "row 0 of 250")
        for off in (0, 1):
            cases += combine_case(gen, payload, R, [35000] + spread, "row 0 of 35,000", off)
            cases += combine_case(gen, payload, R, [c - 1, c, c + 1, 2 * c, 2 * c + 1, 3 * c],
                                  "chunk edges", off, chunk=c)
            cases += combine_case(gen, payload, R, [3] * 2000 + [40], "short rows", off)
    cases += combine_case(gen, payload, 16, [c * c + 1] + [5] * 20, "a row over chunk squared")
    cases += combine_case(gen, payload, 16, [35000] + spread, "inf in row 0", inf_row=0)
    cases += combine_case(gen, payload, 16, [35000] + spread, "inf in a short row", inf_row=7)
    for R, lengths in ((256, [3] * 5000 + [3000]), (256, [1700] + [11] * 299),
                       (3048, [3] * 300 + [70]), (24 * 129, [230] + [12] * 39),
                       (128 * 512, [100] + [33] * 6)):
        for off in (0, 1):
            cases += combine_case(gen, payload, R, lengths, "wide rows", off)
    cases += combine_case(gen, payload, 256, [3] * 500 + [8], "inf in a wide row", inf_row=9)
    cases += combine_case(gen, payload, 128 * 4096, [8] * 6 + [40], "the MLP's width", 1)
    cases += combine_case(gen, payload, 128 * 4096, [8] * 6 + [40], "the MLP's width")
    return cases


SPMM_DTYPES = [(t, x) for t in (torch.float32, torch.bfloat16, torch.float64)
               for x in (torch.float32, torch.bfloat16)]


def spmm_edge_grid(gen, payload) -> int:
    """The SpMM kernel over B x G x N, every (tile, X) dtype pair in turn, one
    group and many; an all-empty-slot group; X views one element past an
    aligned base; the combine at R = B*N."""
    cases = 0
    combos = [(B, G, N) for B in (8, 16, 24) for G in (1, 4, 16)
              for N in (1, 16, 20, 33, 100, 129, 512)]
    combos += [(B, G, N) for B in (64, 100, 128) for G in (1, 2)
               for N in (1, 20, 100, 127, 128, 129, 512, 1025, 2049)]
    for i, (B, G, N) in enumerate(combos):
        tdt, xdt = SPMM_DTYPES[i % len(SPMM_DTYPES)]
        groups, nb = (1, 3) if (i // len(SPMM_DTYPES)) % 2 else (13, 29)
        for integer in (False, True):
            bcol = torch.randint(0, nb, (groups, G), generator=gen).to(torch.int32).to(DEV)
            k, p = spmm_pair(payload((groups, G * B, B), tdt, integer), bcol,
                             payload((nb, B, N), xdt, integer))
            compare("spmm", k(), p(), f"B={B} G={G} N={N} {tdt}/{xdt} groups={groups}",
                    exact=integer)
            cases += 1
        if B in (16, 128):                       # an all-empty-slot group: exact zeros
            k, p = spmm_pair(torch.zeros((2, G * B, B), device=DEV),
                             torch.zeros((2, G), dtype=torch.int32, device=DEV),
                             payload((nb, B, N), xdt, False))
            got = k()
            compare("spmm", got, p(), f"B={B} G={G} N={N} empty slots", exact=True)
            if got.any():
                fail(f"spmm: empty slots at B={B} G={G} N={N} are not exact zeros")
            cases += 1
    # X a contiguous view one element past an aligned base: the kernels' 4-byte copies
    for B, G, N in ((16, 4, 20), (128, 2, 20)):
        for integer in (False, True):
            bcol = torch.randint(0, 29, (13, G), generator=gen).to(torch.int32).to(DEV)
            Xb = payload((29 * B * N + 1,), torch.float32, integer)[1:].view(29, B, N)
            k, p = spmm_pair(payload((13, G * B, B), torch.float32, integer), bcol, Xb)
            compare("spmm", k(), p(), f"B={B} G={G} N={N} X at a 4-byte offset", exact=integer)
            cases += 1
    return cases


# ---------------------------------------------------------------------------
# the main path, one matrix at a time
# ---------------------------------------------------------------------------

def oracle_check(tag, rows, cols, vals, shape, x_np, y) -> float:
    """y against the float64 ``dense_oracle``, relative to (|A| |x|) row by row;
    fails beyond ``ORACLE_TOL``. Returns the largest relative error."""
    y64 = dense_oracle(rows, cols, vals.astype(np.float32).astype(np.float64), shape,
                       x_np.astype(np.float64))
    mag = dense_oracle(rows, cols, np.abs(vals.astype(np.float32)).astype(np.float64), shape,
                       np.abs(x_np).astype(np.float64))
    err = np.abs(y.cpu().numpy().astype(np.float64) - y64)
    rel = float((err / np.maximum(mag, 1e-30)).max())
    if not (err <= ORACLE_TOL * mag + 1e-30).all():
        fail(f"{tag}: y differs from the float64 oracle by {rel:.3e} of |A||x|")
    return rel


def check_accounting(tag, s) -> dict:
    """``repro.ops.spmv.*`` in the obs registry against the wrappers' own launch
    counters and ``spmv_launch_stats``, both zeroed before the calls counted
    here; fails on any difference."""
    calls = obs.counter("repro.ops.spmv.calls").value(impl="cuda")
    stats = ops.spmv_launch_stats(s)
    wrapped = {k: w.launches for k, w in WRAPPERS.items()}
    got = {}
    for fmt in ("dense", "panel", "coo"):
        reg_launches = obs.counter("repro.ops.spmv.launches").value(format=fmt)
        reg_steps = obs.counter("repro.ops.spmv.steps").value(format=fmt)
        want = (format_launches(wrapped, fmt), calls * stats["launches"][fmt],
                calls * stats["steps"][fmt])
        if (reg_launches, reg_launches, reg_steps) != want:
            fail(f"{tag}: obs counts {fmt} launches {reg_launches}, steps {reg_steps}; the "
                 f"wrapper launched {want[0]}, spmv_launch_stats x {calls} calls gives "
                 f"{want[1]} launches and {want[2]} steps")
        got[fmt] = dict(launches=reg_launches, steps=reg_steps)
    return dict(calls=calls, per_format=got, held_to="the wrappers' launch counters and "
                "spmv_launch_stats x calls")


def obs_enqueue_ms(fn, pairs: int = 7) -> dict:
    """Host enqueue time of ``fn()`` with obs on (the default) and off, in
    turns (on, off, on, off, ...), medians of the ``pairs`` of each."""
    on, off = [], []
    for _ in range(pairs):
        on.append(enqueue_ms(fn))
        obs.configure(enabled=False)
        off.append(enqueue_ms(fn))
        obs.configure(enabled=True)
    m_on, m_off = statistics.median(on), statistics.median(off)
    return dict(on=m_on, off=m_off, on_minus_off=m_on - m_off, runs_on=on, runs_off=off)


def make_matrices(seed: int):
    big, long_ = 262144, 2097152
    return [
        ("block_clustered", "dense", f"block_clustered({big}, {big})",
         lambda: matrices.block_clustered(big, big, seed=seed), (big, big)),
        ("banded", "panel", f"banded({long_}, {long_}, bandwidth=9)",
         lambda: matrices.banded(long_, long_, bandwidth=9, seed=seed + 1), (long_, long_)),
        ("power_law", "coo", f"power_law({big}, {big}, avg_deg=8)",
         lambda: matrices.power_law(big, big, avg_deg=8, seed=seed + 2), (big, big)),
    ]


def run_matrix(name, heavy, call, make, shape, seed, per_kernel, launches):
    B = 16
    t0 = time.perf_counter()
    rows, cols, vals = make()
    t_gen = time.perf_counter() - t0
    x_np = np.random.default_rng(seed + 7).standard_normal(shape[1]).astype(np.float32)

    # -- the main path, counted: zero the counters, drive it, read them -------
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    cb = CBMatrix.from_coo(rows, cols, vals, shape, block_size=B, val_dtype=np.float32)
    t_cb = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_streams = build_super_streams(cb)
    t_streams = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = host_streams.to()                       # default device: CUDA
    x = torch.from_numpy(x_np).to(DEV)
    torch.cuda.synchronize()
    t_to = time.perf_counter() - t0
    t0 = time.perf_counter()
    y = ops.cb_spmv(s, x)                       # default impl: the CUDA kernels
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0          # includes the combine plan's host sort
    counted = {k: w.launches for k, w in WRAPPERS.items()}      # one cb_spmv call
    for k, n in counted.items():
        launches[k] += n
    y_again = ops.cb_spmv(s, x)                 # outside the counted run
    torch.cuda.synchronize()
    del host_streams

    # -- is y right? -----------------------------------------------------------
    stats = cb.stats()
    for k in present_kernels(s):
        if counted[k] < 1:
            fail(f"{name}: kernel {k} has work but was not launched by cb_spmv")
    if counted["combine"] > 2:
        fail(f"{name}: the combine took {counted['combine']} launches, at most 2 by design")
    if y.shape != (shape[0],) or y.dtype != torch.float32 or not torch.isfinite(y).all():
        fail(f"{name}: y has shape {tuple(y.shape)} dtype {y.dtype} or is not finite")
    if not torch.equal(y, y_again):
        fail(f"{name}: two runs of cb_spmv are not bit-equal")
    oracle_rel = oracle_check(name, rows, cols, vals, shape, x_np, y)
    y_ref = ops.cb_spmv(s, x, impl="reference")
    ref_err = float((y - y_ref).abs().max())
    if ref_err > KERNEL_TOL * max(1.0, float(y_ref.abs().max())):
        fail(f"{name}: impl='cuda' differs from impl='reference' by {ref_err:.3e}")
    del y_ref

    # -- each kernel against its plain version, and timed, at these shapes -----
    xg_d, xg_p = (ops._gather(x, i) for i in (s.dense_xidx, s.panel_xidx))
    prep = ops._prepare(s, None)
    parts = torch.empty((prep.brow.numel(), B), dtype=torch.float32, device=DEV)
    nd, npn = s.dense_brow.numel(), s.panel_brow.numel()
    pairs = {}          # kernel -> ((wrapper, plain), bytes, flops, shape, (library call, its name))
    if s.num_dense_groups:
        pairs["dense"] = (dense_pair(s.dense_tiles, xg_d), nbytes(s.dense_tiles, xg_d) + nd * B * 4,
                          2 * s.dense_tiles.numel(), tuple(s.dense_tiles.shape),
                          (lambda: torch.bmm(s.dense_tiles.view(-1, B, B), xg_d.view(-1, B, 1)),
                           "torch.bmm"))
    if s.num_panel_groups:
        pairs["panel"] = (panel_pair(s.panel_vals, xg_p), nbytes(s.panel_vals, xg_p) + npn * B * 4,
                          2 * s.panel_vals.numel(), tuple(s.panel_vals.shape),
                          (lambda: panel_library(s.panel_vals, xg_p), "torch.einsum"))
        enc = cb_colagg.compact_panels(s.panel_vals)
        pairs["panel_bitmap"] = (panel_bitmap_pair(enc, xg_p),
                                 enc.nbytes + nbytes(xg_p) + npn * B * 4, 2 * enc.elems,
                                 tuple(enc.cvals.shape),
                                 (lambda: panel_library(s.panel_vals, xg_p), "torch.einsum"))
    if s.num_coo_groups:
        nco = s.coo_brow.numel()
        pairs["coo"] = (coo_pair(s.coo_codes, s.coo_vals, s.coo_xidx, x, B),
                        nbytes(s.coo_codes, s.coo_vals, s.coo_xidx, x) + nco * B * 4,
                        2 * s.coo_codes.numel(), tuple(s.coo_codes.shape),
                        (None, None))       # no single call decodes the codes and scatters
    for k, ((kern, plain), nb, fl, shp, lib) in pairs.items():
        got, want = kern(), plain()
        compare(k, got, want, f"{name} {shp}")
        if lib[0] is not None:              # the yardstick computes the same function
            compare(k + " library", lib[0]().reshape(want.shape), want, f"{name} {shp}")
        lo, hi = {"dense": (0, nd), "panel": (nd, nd + npn), "panel_bitmap": (nd, nd + npn),
                  "coo": (nd + npn, None)}[k]
        parts[lo:hi] = got.reshape(-1, B)
        del got, want
    brow64 = prep.brow.long()
    kc, pc = combine_pair(shape[0], parts, prep.brow, B, prep.combine)
    want = pc()
    got = kc()
    compare("combine", got, want, f"{name} T={parts.shape[0]}")
    if not torch.equal(got, kc()):
        fail(f"{name}: two runs of the combine are not bit-equal")
    del got
    y2d = torch.empty((s.mb, B), dtype=torch.float32, device=DEV)

    def combine_library(y):
        """The same (m,) += as the kernel, by ``index_add_``: fill, scatter-add, ragged cut, add."""
        y2d.zero_().index_add_(0, brow64, parts)
        return y.add_(y2d.view(-1)[: y.shape[0]])

    compare("combine library", combine_library(torch.zeros_like(want)), want, name)
    del want
    y_acc = torch.zeros(shape[0], dtype=torch.float32, device=DEV)
    pairs["combine"] = (combine_pair(shape[0], parts, prep.brow, B, prep.combine, y=y_acc),
                        combine_bytes(parts, shape[0]),
                        parts.numel(), tuple(parts.shape),
                        (lambda: combine_library(y_acc), "index_add_"))
    rows_out = {}
    for k, ((kern, plain), nb, fl, shp, lib) in pairs.items():
        b_ms, b_by = bound(nb, fl)
        rows_out[k] = dict(
            matrix=name, run=name, shape=shp, bytes=nb, flops=fl, launches=counted[k],
            ms=time_ms(kern), enqueue_ms=enqueue_ms(kern),
            plain_ms=time_ms(plain, max(3, REPS // 4)), bound_ms=b_ms, bound_by=b_by,
            library_ms=None if lib[0] is None else time_ms(lib[0]), library=lib[1])
        per_kernel[k].append(rows_out[k])
    del pairs, parts, y2d, y_acc, brow64

    # -- the whole call, timed; obs's launch accounting held to the wrappers' --
    def spmv_call():
        return ops.cb_spmv(s, x)

    obs.reset()
    for w in WRAPPERS.values():
        w.launches = 0
    spmv_ms = time_ms(spmv_call)
    spmv_enqueue_ms = enqueue_ms(spmv_call)
    accounting = check_accounting(name, s)
    enqueue_obs = obs_enqueue_ms(spmv_call)
    gather_ms = time_ms(lambda: [ops._gather(x, i) for i in (s.dense_xidx, s.panel_xidx)])
    region = s.region_nbytes()
    crow = torch.from_numpy(np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=shape[0]))]))
    A = torch.sparse_csr_tensor(crow.to(DEV), torch.from_numpy(cols).to(DEV),
                                torch.from_numpy(vals.astype(np.float32)).to(DEV), size=shape)
    y_lib = A @ x
    lib_err = float((y - y_lib).abs().max())
    library_ms = time_ms(lambda: A @ x)
    emit("spmv", matrix=call, dominant_format=heavy, block_size=B,
         dtype="float32", nnz=int(cb.nnz), blocks=stats["num_blocks"],
         blocks_coo=stats["fmt_coo"], blocks_csr=stats["fmt_csr"],
         blocks_dense=stats["fmt_dense"], column_aggregated=stats["column_aggregated"],
         group_size=s.group_size, groups=ops.spmv_launch_stats(s)["steps"],
         padded_elements=s.padded_work(), slots=int(prep.brow.numel()),
         combine_passes=len(prep.combine.passes), combine_chunk=prep.combine.chunk,
         combine_positions=[p.positions for p in prep.combine.passes],
         host_seconds=dict(generate=t_gen, from_coo=t_cb, build_super_streams=t_streams,
                           to_device=t_to, first_call=t_first),
         stream_bytes=sum(region.values()) - region["x"] - region["y"],
         region_bytes=sum(region.values()),
         launches=counted, spmv_ms=spmv_ms, spmv_enqueue_ms=spmv_enqueue_ms,
         spmv_enqueue_ms_obs=enqueue_obs, obs_accounting=accounting, gather_ms=gather_ms,
         kernel_ms={k: v["ms"] for k, v in rows_out.items()},
         effective_GBps=sum(region.values()) / spmv_ms / 1e6,
         bound_ms=sum(region.values()) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
         library_ms=library_ms, library="torch.sparse CSR A @ x",
         err_vs_oracle_rel=oracle_rel, err_vs_reference_abs=ref_err,
         err_vs_library_abs=lib_err, runs_bit_equal=True)
    return cb, (rows, cols, vals), y.cpu(), spmv_ms


# ---------------------------------------------------------------------------
# distribution: distributed_spmv over a torch.distributed mesh
# ---------------------------------------------------------------------------

DIST_MATRICES = ("banded", "power_law")
# (ranks, backend, combines). NCCL refuses two ranks on one card ("Duplicate GPU
# detected"), so D > 1 shares cuda:0 under gloo: those times are D shards on one
# card, not D cards.
DIST_RUNS = ((1, "nccl", ("psum_scatter", "psum")),
             (2, "gloo", ("psum_scatter", "psum")),
             (4, "gloo", ("psum_scatter", "psum")))
DIST_TIMEOUT = 240             # seconds one group of ranks may take, start-up included


def check_shard_kernels(tag, local, x) -> None:
    """Each SpMV kernel and the combine against its plain version at a rank's
    shard shapes (the flat shard regrouped as ``cb_spmv`` runs it)."""
    prep = ops._prepare(local, None)
    s = prep.sup
    check_kernels_at(tag, s, x)
    B = s.block_size
    parts = torch.empty((prep.brow.numel(), B), dtype=torch.float32, device=DEV)
    nd, npn = s.dense_brow.numel(), s.panel_brow.numel()
    if s.num_dense_groups:
        parts[:nd] = dense_pair(s.dense_tiles, ops._gather(x, s.dense_xidx))[0]().reshape(-1, B)
    if s.num_panel_groups:
        parts[nd:nd + npn] = panel_pair(s.panel_vals, ops._gather(x, s.panel_xidx))[0]() \
            .reshape(-1, B)
    if s.num_coo_groups:
        parts[nd + npn:] = coo_pair(s.coo_codes, s.coo_vals, s.coo_xidx, x, B)[0]() \
            .reshape(-1, B)
    kc, pc = combine_pair(s.m, parts, prep.brow, B, prep.combine)
    compare("combine", kc(), pc(), f"{tag} T={parts.shape[0]}")


def dist_rank(rank: int, job: dict) -> None:
    """One rank of a ``dist`` group (a spawned process): joins the group, drives
    ``distributed_spmv`` on each matrix's shard, and saves what it measured."""
    faulthandler.enable()                   # a crash in native code prints its Python stack
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(job["backend"], init_method=f"file://{job['store']}", rank=rank,
                            world_size=job["world"])
    try:
        out = dist_rank_runs(rank, job)
    finally:
        dist.destroy_process_group()
    torch.save(out, pathlib.Path(job["out"]) / f"dist-D{job['world']}-rank{rank}.pt")


def dist_rank_runs(rank: int, job: dict) -> dict:
    D = job["world"]
    mesh = make_mesh((D,), ("model",))           # CUDA, over the group just joined
    group = mesh.get_group("model")
    dev = torch.device("cuda", torch.cuda.current_device())   # distributed_spmv's key
    lines = {}
    for name, path in job["matrices"].items():
        d = torch.load(path, mmap=True, weights_only=True)
        sh = ShardedStreams(D, SpMVStreams(**d["meta"], **d["fields"]),
                            d["device_nnz"].numpy())
        x = d["x"].to(DEV)
        m = sh.streams.m
        for combine in job["combines"]:
            def call():
                return distributed_spmv(sh, x, mesh, combine=combine)

            # -- the main path, counted: zero the counters, one call, read them ----
            for w in WRAPPERS.values():
                w.launches = 0
            obs.reset()
            t0 = time.perf_counter()
            y = call()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counted = {k: w.launches for k, w in WRAPPERS.items()}
            from_obs = {f: obs.counter("repro.ops.spmv.launches").value(format=f)
                        for f in ("dense", "panel", "coo")}
            y_again = call()
            local = (lambda t: t.to_local()) if isinstance(y, DTensor) else (lambda t: t)
            full = y
            if isinstance(y, DTensor):
                # gathered with c10d: DTensor's full_tensor() crashes under gloo on CUDA
                full = torch.empty(y.shape, dtype=y.dtype, device=dev)
                dist.all_gather_into_tensor(full, y.to_local(), group=group)
            m_pad = -(-m // D) * D
            if combine == "psum":
                buf = torch.zeros(m, dtype=torch.float32, device=DEV)

                def coll():
                    dist.all_reduce(buf, group=group)
            else:
                src = torch.zeros(m_pad, dtype=torch.float32, device=DEV)
                dst = torch.empty(m_pad // D, dtype=torch.float32, device=DEV)

                def coll():
                    dist.reduce_scatter_tensor(dst, src, group=group)
            shard = sh.local(rank, dev)
            lines[name, combine] = dict(
                launches=counted, obs_launches=from_obs, first_call_s=first_s,
                present=present_kernels(ops._prepare(shard, None).sup),
                bit_equal=bool(torch.equal(local(y), local(y_again))),
                dtensor=isinstance(y, DTensor),
                placements=[str(p) for p in y.placements] if isinstance(y, DTensor) else None,
                y=full.cpu() if rank == 0 else None,
                dist_spmv_ms=time_ms(call), dist_spmv_enqueue_ms=enqueue_ms(call),
                collective_ms=time_ms(coll), collective_enqueue_ms=enqueue_ms(coll),
                rank_spmv_ms=time_ms(lambda: ops.cb_spmv(shard, x)),
                rank_spmv_enqueue_ms=enqueue_ms(lambda: ops.cb_spmv(shard, x)))
            del y, y_again, full
        if rank == 0:
            check_shard_kernels(f"dist {name} D={D} rank 0", sh.local(0, dev), x)
        del sh, x
        torch.cuda.empty_cache()
    return dict(lines=lines, worst_err=dict(worst_err), worst_rel=dict(worst_rel))


def run_dist(inputs, seed, launches, dist_launches, runs=DIST_RUNS) -> None:
    """``shard_streams`` of the spmv lines' banded and power-law matrices at each D,
    then ``distributed_spmv`` on D spawned ranks, each line checked and timed."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for D, backend, combines in runs:
            meta = {}
            for name in DIST_MATRICES:
                cb = inputs[name][0]
                t0 = time.perf_counter()
                sh = shard_streams(cb, D)
                shard_s = time.perf_counter() - t0
                x_np = np.random.default_rng(seed + 7).standard_normal(cb.shape[1]) \
                    .astype(np.float32)
                torch.save(dict(
                    fields={f: getattr(sh.streams, f) for f in STREAM_FIELDS},
                    meta={k: getattr(sh.streams, k) for k in
                          ("block_size", "m", "n", "mb", "colagg_applied")},
                    device_nnz=torch.from_numpy(sh.device_nnz), x=torch.from_numpy(x_np)),
                    tmp / f"{name}-D{D}.pt")
                meta[name] = dict(device_nnz=sh.device_nnz.tolist(),
                                  load_imbalance=sh.load_imbalance, shard_streams_s=shard_s,
                                  x=x_np, padded_elements=sh.shard(0).padded_work())
                del sh
            job = dict(world=D, backend=backend, combines=list(combines),
                       store=str(tmp / f"store-D{D}"), out=str(tmp),
                       matrices={n: str(tmp / f"{n}-D{D}.pt") for n in DIST_MATRICES})
            procs = [MP.Process(target=dist_rank, args=(r, job)) for r in range(D)]
            t0 = time.perf_counter()
            for p in procs:
                p.start()
            deadline = time.monotonic() + DIST_TIMEOUT
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            if alive:
                fail(f"dist D={D} ({backend}): ranks {alive} still running after {DIST_TIMEOUT} s")
            bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                fail(f"dist D={D} ({backend}): ranks exited with codes {bad}")
            group_s = time.perf_counter() - t0
            res = [torch.load(tmp / f"dist-D{D}-rank{r}.pt", weights_only=False)
                   for r in range(D)]
            for r in res:
                for k in WRAPPERS:
                    worst_err[k] = max(worst_err[k], r["worst_err"][k])
                    worst_rel[k] = max(worst_rel[k], r["worst_rel"][k])
            for name in DIST_MATRICES:
                cb, coo, y_single, spmv_ms, call = inputs[name]
                for combine in combines:
                    lines = [r["lines"][name, combine] for r in res]
                    tag = f"dist {name} D={D} {backend} {combine}"
                    for rank, ln in enumerate(lines):
                        for k in ln["present"]:
                            if ln["launches"][k] < 1:
                                fail(f"{tag}: rank {rank} has {k} work but did not launch it")
                        for f in ("dense", "panel", "coo"):
                            if ln["obs_launches"][f] != format_launches(ln["launches"], f):
                                fail(f"{tag}: rank {rank} obs counts {ln['obs_launches']}, the "
                                     f"wrappers {ln['launches']}")
                        if not ln["bit_equal"]:
                            fail(f"{tag}: rank {rank}'s two runs are not bit-equal")
                        if ln["dtensor"] != (combine == "psum_scatter" and cb.shape[0] % D == 0):
                            fail(f"{tag}: rank {rank} returned a DTensor: {ln['dtensor']}")
                    y = lines[0]["y"]
                    if y.shape != (cb.shape[0],) or not torch.isfinite(y).all():
                        fail(f"{tag}: y has shape {tuple(y.shape)} or is not finite")
                    oracle_rel = oracle_check(tag, *coo, cb.shape, meta[name]["x"], y)
                    single_err = float((y - y_single).abs().max())
                    if single_err > KERNEL_TOL * max(1.0, float(y_single.abs().max())):
                        fail(f"{tag}: y differs from single-device cb_spmv by {single_err:.3e}")
                    run = f"dist_spmv {name} D={D} {combine}"
                    for k in WRAPPERS:
                        n = sum(ln["launches"][k] for ln in lines)
                        launches[k] += n
                        if n:
                            dist_launches.setdefault(k, {})[run] = n
                    emit("dist_spmv", matrix=call, ranks=D, backend=backend, combine=combine,
                         one_card=D > 1, device_nnz=meta[name]["device_nnz"],
                         load_imbalance=meta[name]["load_imbalance"],
                         padded_elements_rank0=meta[name]["padded_elements"],
                         dist_spmv_ms=max(ln["dist_spmv_ms"] for ln in lines),
                         collective_ms=max(ln["collective_ms"] for ln in lines),
                         rank_spmv_ms=max(ln["rank_spmv_ms"] for ln in lines),
                         spmv_ms=spmv_ms,
                         per_rank={k: [ln[k] for ln in lines] for k in (
                             "dist_spmv_ms", "dist_spmv_enqueue_ms", "collective_ms",
                             "collective_enqueue_ms", "rank_spmv_ms", "rank_spmv_enqueue_ms",
                             "first_call_s", "launches", "obs_launches")},
                         placements=lines[0]["placements"],
                         host_seconds=dict(shard_streams=meta[name]["shard_streams_s"],
                                           rank_group=group_s),
                         err_vs_oracle_rel=oracle_rel, err_vs_single_device_abs=single_err,
                         tolerance=KERNEL_TOL, runs_bit_equal=True)
            del res
    emit("dist_phase", seconds=time.perf_counter() - t_phase,
         runs=[(D, b, list(c)) for D, b, c in runs])


# ---------------------------------------------------------------------------
# the SpMM paths: the solver's multi-RHS product and the sparse MLP's step
# ---------------------------------------------------------------------------

def kernel_row(path, run, shape, nb, fl, launched, kern, plain, lib, lib_name,
               flops_per_s=F32_FLOPS_PER_S):
    """One timed row of the ``kernels`` line (kernel, plain, library call);
    ``launched`` is the kernel's launch count in the counted ``run``."""
    b_ms, b_by = bound(nb, fl, flops_per_s)
    return dict(matrix=path, run=run, shape=shape, bytes=nb, flops=fl, launches=launched,
                ms=time_ms(kern), enqueue_ms=enqueue_ms(kern),
                plain_ms=time_ms(plain, max(3, REPS // 4)), bound_ms=b_ms, bound_by=b_by,
                library_ms=None if lib is None else time_ms(lib), library=lib_name)


def spmm_rows(path, run, tiles, bcol, Xb, route, m, launched, per_kernel):
    """spmm and combine at one product's real shapes: checked, then timed.
    ``launched`` holds the launch counts of the counted ``run`` this product
    belongs to (one ``cb_spmm`` call, or a whole training step)."""
    gt, Gt = bcol.shape
    _, B, N = Xb.shape
    T = gt * Gt
    kern, plain = spmm_pair(tiles, bcol, Xb)
    got, want = kern(), plain()
    compare("spmm", got, want, f"{path} {tuple(tiles.shape)} N={N}")
    xg = Xb[bcol.reshape(-1).long()].float()            # pre-gathered for the yardstick
    tiles3 = tiles.view(T, B, B).float()

    def library():
        return torch.bmm(tiles3, xg)

    compare("spmm library", library().view(want.shape), want, path)
    del want
    parts = got.view(T, B * N)
    kc, pc = combine_pair(m * N, parts, route.brow, B * N, route.combine)
    want = pc()
    got = kc()
    compare("combine", got, want, f"{path} R={B}*{N}")
    if not torch.equal(got, kc()):
        fail(f"{path}: two runs of the combine are not bit-equal")
    del want, got
    y2d = torch.empty((-(-m // B), B * N), dtype=torch.float32, device=DEV)
    brow64 = route.brow.long()

    def combine_library(y):
        y2d.zero_().index_add_(0, brow64, parts)
        return y.add_(y2d.view(-1)[: y.shape[0]])

    compare("combine library", combine_library(torch.zeros(m * N, device=DEV)), pc(), path)
    y_acc = torch.zeros(m * N, dtype=torch.float32, device=DEV)
    kc, pc = combine_pair(m * N, parts, route.brow, B * N, route.combine, y=y_acc)
    out = {
        "spmm": kernel_row(path, run, tuple(tiles.shape) + (N,),
                           nbytes(tiles, bcol, Xb) + T * B * N * 4, 2 * T * B * B * N,
                           launched["spmm"], kern, plain, library, "torch.bmm (X pre-gathered)",
                           spmm_flops_per_s(B)),
        "combine": kernel_row(path, run, tuple(parts.shape), combine_bytes(parts, m * N),
                              parts.numel(), launched["combine"], kc, pc,
                              lambda: combine_library(y_acc), "index_add_"),
    }
    for k, row in out.items():
        per_kernel[k].append(row)
    return out


def run_matmat(call, cb, coo, seed, per_kernel, launches):
    """``ops.cb_spmm`` with 16 right-hand sides on an SpMV line's matrix."""
    rows, cols, vals = coo
    m, n = cb.shape
    B, N = cb.block_size, 16
    X_np = np.random.default_rng(seed + 11).standard_normal((n, N)).astype(np.float32)

    # -- the path, counted ----------------------------------------------------
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    tiles_host = tile_stream_from_cb(cb)
    t_tiles = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed_host = build_super_tile_stream(tiles_host)       # default group size
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = packed_host.to()
    X = torch.from_numpy(X_np).to(DEV)
    torch.cuda.synchronize()
    t_to = time.perf_counter() - t0
    t0 = time.perf_counter()
    Y = ops.cb_spmm(s, X)                                    # default impl: the CUDA kernels
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0                      # holds the combine plan's host sort
    counted = {k: w.launches for k, w in WRAPPERS.items()}
    for k, c in counted.items():
        launches[k] += c
    for k in ("spmm", "combine"):
        if counted[k] < 1:
            fail(f"matmat: kernel {k} was not launched by cb_spmm")
    Y_again = ops.cb_spmm(s, X)
    torch.cuda.synchronize()
    num_tiles = tiles_host.num_tiles
    del tiles_host, packed_host

    # -- is Y right? -----------------------------------------------------------
    if Y.shape != (m, N) or Y.dtype != torch.float32 or not torch.isfinite(Y).all():
        fail(f"matmat: Y has shape {tuple(Y.shape)} dtype {Y.dtype} or is not finite")
    if not torch.equal(Y, Y_again):
        fail("matmat: two runs of cb_spmm are not bit-equal")
    A64 = scipy.sparse.csr_matrix((vals.astype(np.float32).astype(np.float64), (rows, cols)),
                                  shape=(m, n))
    Y64 = A64 @ X_np.astype(np.float64)
    mag = abs(A64) @ np.abs(X_np).astype(np.float64)
    err = np.abs(Y.cpu().numpy().astype(np.float64) - Y64)
    oracle_rel = float((err / np.maximum(mag, 1e-30)).max())
    if not (err <= ORACLE_TOL * mag + 1e-30).all():
        fail(f"matmat: Y differs from scipy float64 by {oracle_rel:.3e} of |A||X|")
    Y_ref = ops.cb_spmm(s, X, impl="reference")
    ref_err = float((Y - Y_ref).abs().max())
    if ref_err > KERNEL_TOL * max(1.0, float(Y_ref.abs().max())):
        fail(f"matmat: impl='cuda' differs from impl='reference' by {ref_err:.3e}")
    del Y_ref, A64, Y64, mag, err

    # -- the kernels at these shapes, and the whole call -------------------------
    _, route = ops._prepare_tiles(s, None)
    Xb = ops.x_blocks(X, s.nb, B)
    path = f"matmat {call}"
    rows_out = spmm_rows(path, path, s.tiles, s.bcol, Xb, route, m, counted, per_kernel)
    matmat_ms = time_ms(lambda: ops.cb_spmm(s, X))
    matmat_enqueue_ms = enqueue_ms(lambda: ops.cb_spmm(s, X))
    crow = torch.from_numpy(np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=m))]))
    A = torch.sparse_csr_tensor(crow.to(DEV), torch.from_numpy(cols).to(DEV),
                                torch.from_numpy(vals.astype(np.float32)).to(DEV), size=(m, n))
    lib_err = float((Y - A @ X).abs().max())
    library_ms = time_ms(lambda: A @ X)
    b_ms, b_by = bound(nbytes(s.tiles, s.bcol, s.brow, X) + m * N * 4,
                       2 * s.tiles.numel() * N)
    emit("matmat", matrix=call, block_size=B, n_rhs=N, dtype="float32", tiles=num_tiles,
         group_size=s.group_size, groups=s.num_groups, slots=s.num_groups * s.slots,
         stream_bytes=s.region_nbytes()["tiles"],
         host_seconds=dict(tile_stream_from_cb=t_tiles, build_super_tile_stream=t_pack,
                           to_device=t_to, first_call=t_first),
         launches=counted, spmm_ms=matmat_ms, spmm_enqueue_ms=matmat_enqueue_ms,
         kernel_ms={k: v["ms"] for k, v in rows_out.items()},
         bound_ms=b_ms, bound_by=b_by,
         library_ms=library_ms, library="torch.sparse CSR A @ X",
         err_vs_oracle_rel=oracle_rel, err_vs_reference_abs=ref_err,
         err_vs_library_abs=lib_err, runs_bit_equal=True)


# ---------------------------------------------------------------------------
# the plan phase: the autotuner picks a configuration, the planned path runs it
# ---------------------------------------------------------------------------

# (matrix of the spmv lines, search mode): the heuristic ranks on shape
# arithmetic alone, the timed search times its shortlist through the kernels
# banded's timed search (31-77 s of the phase) was cut when the mesh phase came: the
# timed path stays driven by power_law's search and CG's planned operator (solve phase)
PLAN_RUNS = (("power_law", "heuristic"), ("power_law", "timed"))


def plan_fields(plan) -> dict:
    return dict(block_size=plan.block_size, th0=plan.th0, th1=plan.th1, th2=plan.th2,
                colagg=plan.colagg, group_size=plan.group_size, mode=plan.mode,
                predicted_padded_elems=plan.predicted_padded_elems,
                predicted_steps=plan.predicted_steps,
                measured_padded_elems=plan.measured_padded_elems,
                measured_steps=plan.measured_steps, t_spmv=plan.t_spmv)


def planned_streams(coo, shape, plan):
    """``from_plan`` -> ``build_super_streams(plan.group_size)`` -> ``.to()``."""
    cb = CBMatrix.from_plan(*coo, shape, plan)
    return build_super_streams(cb, group_size=plan.group_size).to()


def check_kernels_at(tag, s, x) -> None:
    """Each present SpMV kernel against its plain version at ``s``'s shapes."""
    B = s.block_size
    for k, groups, pair in (
            ("dense", s.num_dense_groups, lambda: dense_pair(s.dense_tiles, ops._gather(x, s.dense_xidx))),
            ("panel", s.num_panel_groups, lambda: panel_pair(s.panel_vals, ops._gather(x, s.panel_xidx))),
            ("coo", s.num_coo_groups, lambda: coo_pair(s.coo_codes, s.coo_vals, s.coo_xidx,
                                                       x, B))):
        if groups:
            kern, plain = pair()
            compare(k, kern(), plain(), f"{tag} B={B}")


def run_plan(inputs, seed, launches) -> None:
    """``CBMatrix.plan_for`` on the spmv lines' matrices, then the planned path
    counted and checked; the timed plans also through a ``PlanCache`` round trip."""
    t_phase = time.perf_counter()
    chosen = {}
    with tempfile.TemporaryDirectory() as cache_dir:
        for name, mode in PLAN_RUNS:
            coo, shape, call, default_spmv_ms = inputs[name]
            cache = PlanCache(cache_dir) if mode == "timed" else None
            t0 = time.perf_counter()
            plan = CBMatrix.plan_for(*coo, shape, cache=cache, settings=SearchSettings(mode=mode))
            plan_s = time.perf_counter() - t0
            if plan.mode != mode or (mode == "timed") != (plan.t_spmv is not None):
                fail(f"plan {name}: asked for mode {mode}, got {plan.mode} (t_spmv {plan.t_spmv})")
            chosen[name, mode] = plan
            x_np = np.random.default_rng(seed + 7).standard_normal(shape[1]).astype(np.float32)

            # -- the planned path, counted ----------------------------------------
            for w in WRAPPERS.values():
                w.launches = 0
            t0 = time.perf_counter()
            s = planned_streams(coo, shape, plan)
            x = torch.from_numpy(x_np).to(DEV)
            y = ops.cb_spmv(s, x, plan=plan)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            counted = {k: w.launches for k, w in WRAPPERS.items()}
            for k in present_kernels(s):
                if counted[k] < 1:
                    fail(f"plan {name} {mode}: kernel {k} has work but was not launched")
            for k, c in counted.items():
                launches[k] += c
            if not torch.equal(y, ops.cb_spmv(s, x, plan=plan)):
                fail(f"plan {name} {mode}: two planned runs are not bit-equal")
            oracle_rel = oracle_check(f"plan {name} {mode}", *coo, shape, x_np, y)
            y_ref = ops.cb_spmv(s, x, impl="reference")
            ref_err = float((y - y_ref).abs().max())
            if ref_err > KERNEL_TOL * max(1.0, float(y_ref.abs().max())):
                fail(f"plan {name} {mode}: impl='cuda' differs from impl='reference' by "
                     f"{ref_err:.3e}")
            del y_ref
            check_kernels_at(f"plan {name} {mode}", s, x)
            spmv_ms = time_ms(lambda: ops.cb_spmv(s, x, plan=plan))
            spmv_enqueue_ms = enqueue_ms(lambda: ops.cb_spmv(s, x, plan=plan))
            line = dict(matrix=call, **plan_fields(plan), plan_s=plan_s,
                        from_plan_to_first_call_s=t_build, launches=counted,
                        groups=ops.spmv_launch_stats(s)["steps"], spmv_ms=spmv_ms,
                        spmv_enqueue_ms=spmv_enqueue_ms, default_spmv_ms=default_spmv_ms,
                        default="B = 16, default thresholds, colagg auto, group size 16 "
                                "(the spmv line)",
                        err_vs_oracle_rel=oracle_rel, err_vs_reference_abs=ref_err,
                        runs_bit_equal=True)
            del s

            # -- a PlanCache round trip: a fresh cache on the same directory hits -----
            if cache is not None:
                fresh = PlanCache(cache_dir)
                t0 = time.perf_counter()
                hit = fresh.get(plan.structure_hash, shape=shape, nnz=plan.nnz)
                line["plan_cache_hit_s"] = time.perf_counter() - t0
                if hit != plan or (fresh.hits, fresh.misses) != (1, 0):
                    fail(f"plan {name} {mode}: the cache gave {hit} ({fresh.hits} hits, "
                         f"{fresh.misses} misses)")
                s = planned_streams(coo, shape, hit)
                if not torch.equal(ops.cb_spmv(s, x, plan=hit), y):
                    fail(f"plan {name} {mode}: the cached plan's run is not bit-equal")
                line["cache_round_trip_bit_equal"] = True
                del s
            if name == "power_law" and mode == "timed":
                h = chosen["power_law", "heuristic"]
                line["agrees_with_heuristic"] = all(
                    getattr(h, f) == getattr(plan, f)
                    for f in ("block_size", "th0", "th1", "th2", "colagg", "group_size"))
            emit("plan", **line)
            del y, x
            torch.cuda.empty_cache()
    emit("plan_phase", seconds=time.perf_counter() - t_phase, runs=len(PLAN_RUNS))


def block_grads(W_grad, spec):
    """The (nt, B, B) tiles of dA = dW^T at the spec's blocks."""
    B = spec.block_size
    g = W_grad.T.reshape(spec.mb, B, spec.nb, B).permute(0, 2, 1, 3)
    return g[torch.from_numpy(spec.brow).long(), torch.from_numpy(spec.bcol).long()]


def run_mlp_train(seed, per_kernel, launches):
    """One training step of the cb-paper MLP (granite-8b widths) at full size."""
    d, ff, B, keep, T = (MLP[k] for k in ("d_model", "d_ff", "block_size", "keep_fraction",
                                          "tokens"))
    lr = 1e-2
    # the specs of ``repro.models.layers.build_mlp_specs`` (seeds 42, 43, 44)
    specs = {
        "gate": sparse_linear.cb_spec_random(d, ff, block_size=B, keep_fraction=keep, seed=42),
        "up": sparse_linear.cb_spec_random(d, ff, block_size=B, keep_fraction=keep, seed=43),
        "down": sparse_linear.cb_spec_random(ff, d, block_size=B, keep_fraction=keep, seed=44),
    }
    gen = torch.Generator(device=DEV).manual_seed(seed)
    layers = {k: sparse_linear.CBSparseLinear(sp, generator=gen, device=DEV)
              for k, sp in specs.items()}
    x = torch.randn((T, d), generator=gen, device=DEV)
    target = torch.randn((T, d), generator=gen, device=DEV)

    def forward(xx):
        h = torch.nn.functional.silu(layers["gate"](xx)) * layers["up"](xx)
        return layers["down"](h)

    def step(update: bool):
        xx = x.detach().requires_grad_(True)
        for layer in layers.values():
            layer.tiles.grad = None
        y = forward(xx)
        loss = ((y - target) ** 2).mean()
        loss.backward()
        if update:
            with torch.no_grad():
                for layer in layers.values():
                    layer.tiles.sub_(lr * layer.tiles.grad)
        return loss, y.detach(), xx.grad

    # -- the step, counted (no update yet: the checks below use this state) --------
    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, y, dx = step(update=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0                 # holds the routes' host sorts
    counted = {k: w.launches for k, w in WRAPPERS.items()}
    for k, c in counted.items():
        launches[k] += c
    for k in ("spmm", "combine"):
        if counted[k] < 1:
            fail(f"mlp_train: kernel {k} was not launched by the training step")
    grads = {k: layer.tiles.grad.clone() for k, layer in layers.items()}
    _, y2, dx2 = step(update=False)
    torch.cuda.synchronize()
    bit_equal = {"y": torch.equal(y, y2), "dX": torch.equal(dx, dx2),
                 "d_tiles": all(torch.equal(grads[k], layers[k].tiles.grad) for k in layers)}
    if not all(bit_equal.values()):
        fail(f"mlp_train: two steps from the same state differ: {bit_equal}")
    del y2, dx2
    if not all(torch.isfinite(t).all() for t in (y, dx, *grads.values())):
        fail("mlp_train: non-finite y, dX or d_tiles")

    # -- the same step in float64 with dense masked weights ---------------------------
    W64 = {k: sparse_linear.dense_equivalent({"tiles": layer.tiles.detach().double()},
                                             layer.spec).requires_grad_(True)
           for k, layer in layers.items()}
    x64 = x.double().requires_grad_(True)
    y64 = (torch.nn.functional.silu(x64 @ W64["gate"]) * (x64 @ W64["up"])) @ W64["down"]
    ((y64 - target.double()) ** 2).mean().backward()

    def rel(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    err = {"y": rel(y, y64.detach()), "dX": rel(dx, x64.grad),
           "d_tiles": {k: rel(grads[k], block_grads(W64[k].grad, layers[k].spec))
                       for k in layers}}
    worst = max(err["y"], err["dX"], *err["d_tiles"].values())
    if worst > TRAIN_TOL:
        fail(f"mlp_train: differs from the float64 dense step: {err}")
    del W64, x64, y64, y, dx, grads

    # -- timed steps (with the update) ---------------------------------------------
    def timed_step():
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xx = x.detach().requires_grad_(True)
        for layer in layers.values():
            layer.tiles.grad = None
        e0.record()
        loss = ((forward(xx) - target) ** 2).mean()
        e1.record()
        loss.backward()
        e2.record()
        with torch.no_grad():
            for layer in layers.values():
                layer.tiles.sub_(lr * layer.tiles.grad)
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, e0.elapsed_time(e1), e1.elapsed_time(e2), enq * 1e3

    timed_step()                                       # warm
    runs = [timed_step() for _ in range(5)]
    step_ms, forward_ms, backward_ms, step_enqueue_ms = (
        statistics.median(r[i] for r in runs) for i in range(4))

    # -- each part of a layer's products at its real shapes --------------------------
    parts = {}
    for name in ("gate", "down"):
        layer, spec = layers[name], specs[name]
        mm = sparse_linear._Matmul(spec, "cuda", None, DEV)
        tiles = layer.tiles.detach()
        X = (x if name == "gate" else torch.randn((T, ff), generator=gen, device=DEV)).T
        dY = torch.randn((spec.out_features, T), generator=gen, device=DEV)
        Xb = ops.x_blocks(X, spec.nb, B)
        dYb = ops.x_blocks(dY, spec.mb, B)
        tT = mm.transposed_tiles(tiles)
        fwd = spmm_rows(f"mlp_train {name} forward", "mlp_train step", tiles.view(-1, B, B),
                        mm.fwd.route.bcol, Xb, mm.fwd.route, spec.out_features, counted,
                        per_kernel)
        dxr = spmm_rows(f"mlp_train {name} dX", "mlp_train step", tT, mm.bwd.route.bcol, dYb,
                        mm.bwd.route, spec.in_features, counted, per_kernel)
        parts[name] = dict(
            spmm_forward_ms=fwd["spmm"]["ms"], spmm_dX_ms=dxr["spmm"]["ms"],
            combine_forward_ms=fwd["combine"]["ms"], combine_dX_ms=dxr["combine"]["ms"],
            dW_bmm_ms=time_ms(lambda: torch.bmm(
                torch.index_select(dYb, 0, mm.fwd.brow),
                torch.index_select(Xb, 0, mm.fwd.bcol).transpose(1, 2)), 5),
            transposed_tiles_ms=time_ms(lambda: mm.transposed_tiles(tiles)),
            x_copy_ms=time_ms(lambda: ops.x_blocks(X, spec.nb, B)),
            dY_copy_ms=time_ms(lambda: ops.x_blocks(dY, spec.mb, B)))
        del mm, Xb, dYb, tT, X, dY
        torch.cuda.empty_cache()

    # -- the dense yardstick: the same step with dense masked float32 weights ----------
    Wd = {k: sparse_linear.dense_equivalent({"tiles": layer.tiles.detach()},
                                            layer.spec).contiguous().requires_grad_(True)
          for k, layer in layers.items()}

    def dense_step():
        xx = x.detach().requires_grad_(True)
        for w in Wd.values():
            w.grad = None
        h = torch.nn.functional.silu(xx @ Wd["gate"]) * (xx @ Wd["up"])
        ((h @ Wd["down"] - target) ** 2).mean().backward()
        with torch.no_grad():
            for w in Wd.values():
                w.sub_(lr * w.grad)

    dense_ms = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        dense_ms["tf32_on" if tf32 else "tf32_off"] = time_ms(dense_step, 3)
    torch.backends.cuda.matmul.allow_tf32 = False
    del Wd

    flops = sum(3 * 2 * sp.num_tiles * B * B * T for sp in specs.values())
    tile_bytes = sum(layer.tiles.numel() * 4 for layer in layers.values())
    # the step's bound with every product at the spmm kernel's 3xTF32 rate (dW is
    # a float32 cuBLAS bmm today), and the CUDA-core float32 floor beside it
    b_ms, b_by = bound(3 * T * d * 4 + 2 * tile_bytes, flops, TF32X3_FLOPS_PER_S)
    f32_floor_ms, _ = bound(3 * T * d * 4 + 2 * tile_bytes, flops)
    emit("mlp_train", config=f"cb-paper MLP: granite-8b d_model {d}, d_ff {ff}, "
         f"CB-sparse SwiGLU, B={B}, keep {keep}", tokens=T, dtype="float32",
         layers={k: dict(in_features=sp.in_features, out_features=sp.out_features,
                         tiles=sp.num_tiles, tile_bytes=sp.num_tiles * B * B * 4)
                 for k, sp in specs.items()},
         launches=counted, first_step_s=t_first, loss=float(loss.detach()),
         step_ms=step_ms, forward_ms=forward_ms, backward_ms=backward_ms,
         step_enqueue_ms=step_enqueue_ms, step_runs_ms=[r[0] for r in runs],
         parts_ms=parts, flops=flops, achieved_TFLOPs=flops / step_ms / 1e9,
         bound_ms=b_ms, bound_by=b_by, bound_rate="3xTF32, 165 TFLOP/s",
         cuda_core_floor_ms=f32_floor_ms,
         dense_step_ms=dense_ms, dense="torch.matmul, dense masked float32 weights, "
         "4x the flops; tf32_off: allow_tf32 False, tf32_on: allow_tf32 True",
         err_vs_float64_dense=err, tolerance=TRAIN_TOL, runs_bit_equal=bit_equal)


# ---------------------------------------------------------------------------
# the serve phase: the cb-paper model served through the engine, full width
# ---------------------------------------------------------------------------

# launch/serve's traffic (src/repro/launch/serve.py's defaults)
SERVE = dict(arch="cb-paper", requests=8, slots=4, max_new=16, max_len=256)
SERVE_IMPL_TOL = 2.0**-5       # one tick's logits, MLP on impl="cuda" vs "reference", relative
                               # to max |logit|: both products are float32-grade, but the
                               # bfloat16 activations round them, and where the two land on
                               # either side of a rounding step an activation moves by one
                               # bf16 ulp (2^-8); over 36 layers and the unembedding that is
                               # a few ulps of the logits, the bound of the CPU parity tests
DECODE_TOL = 2e-3              # teacher-forced decode vs forward, float32: the reference's
                               # own check (tests/test_models.py, rtol = atol = 2e-3)


def serve_requests(cfg) -> list:
    rng = np.random.default_rng(0)
    return [Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size,
                                                 rng.integers(2, 12)).astype(np.int32),
                    max_new_tokens=SERVE["max_new"])
            for uid in range(SERVE["requests"])]


def serve_once(model, params) -> dict:
    """``launch/serve``'s traffic through a fresh ``ServingEngine``: every tick
    between CUDA events, synchronised (a tick reads its argmax back anyway)."""
    eng = ServingEngine(model, params, slots=SERVE["slots"], max_len=SERVE["max_len"])
    for req in serve_requests(model.cfg):
        eng.submit(req)
    done, tick_ms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or any(eng.active):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        done.extend(eng.tick())
        b.record()
        torch.cuda.synchronize()
        tick_ms.append(a.elapsed_time(b))
    wall = time.perf_counter() - t0
    tokens = sum(len(r.generated) for r in done)
    if len(done) != SERVE["requests"] or tokens != SERVE["requests"] * SERVE["max_new"]:
        fail(f"serve: {len(done)} requests done, {tokens} tokens")
    return dict(engine=eng, generated={r.uid: r.generated for r in done}, tick_ms=tick_ms,
                wall_s=wall, tokens=tokens)


def run_serve(seed, per_kernel, launches):
    """The cb-paper model (granite-8b at full width, CB-sparse SwiGLU) served
    through ``ServingEngine`` on the card, and its checks."""
    t_phase = time.perf_counter()
    cfg = get_config(SERVE["arch"])
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.perf_counter()
    model = Model(cfg)                                   # CUDA by default
    params = model.init(gen)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())

    # -- the main path, counted: launch/serve's traffic --------------------------------
    for w in WRAPPERS.values():
        w.launches = 0
    obs_before = obs.counter("repro.ops.spmm.launches").total()
    run1 = serve_once(model, params)
    counted = {k: w.launches for k, w in WRAPPERS.items()}
    obs_launches = obs.counter("repro.ops.spmm.launches").total() - obs_before
    ticks = run1["engine"].ticks
    for k, c in counted.items():
        launches[k] += c
    for k in ("spmm", "combine"):
        if counted[k] < 1:
            fail(f"serve: kernel {k} was not launched by the served requests")
    if obs_launches != counted["spmm"]:
        fail(f"serve: obs counted {obs_launches} spmm launches, the wrapper {counted['spmm']}")
    per_tick = {k: c / ticks for k, c in counted.items()}
    run2 = serve_once(model, params)
    if run2["generated"] != run1["generated"]:
        fail("serve: two runs of the same requests generated different tokens")

    # -- one tick from a mid-sequence state: enqueue, device time, impl="reference" ----
    B = SERVE["slots"]
    state = model.init_decode_state(B, SERVE["max_len"])
    rng = np.random.default_rng(seed + 41)
    prefill = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)).to(DEV)
    for t in range(prefill.shape[1]):
        _, state = model.decode_step(params, state, prefill[:, t:t + 1],
                                     torch.full((B,), t, dtype=torch.int32, device=DEV))
    tok = prefill[:, -1:]
    pos = torch.full((B,), prefill.shape[1], dtype=torch.int32, device=DEV)

    def one_tick():
        return model.decode_step(params, state, tok, pos)

    enq = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_tick()
        enq.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    device_tick_ms = graph_ms(one_tick)
    logits, _ = one_tick()
    ref_logits, _ = Model(cfg, impl="reference").decode_step(params, state, tok, pos)
    if not (torch.isfinite(logits).all() and logits.shape == (B, cfg.padded_vocab)):
        fail(f"serve: logits {tuple(logits.shape)} or non-finite")
    impl_err = (logits.float() - ref_logits.float()).abs().max().item()
    impl_scale = max(1.0, ref_logits.float().abs().max().item())
    if impl_err > SERVE_IMPL_TOL * impl_scale:
        fail(f"serve: impl='cuda' vs 'reference' logits differ by {impl_err:.3e} > "
             f"{SERVE_IMPL_TOL} * {impl_scale:.3e}")
    argmax_agree = float((logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    del ref_logits

    # -- the kernels at the decode shape: N = slots, X in bfloat16 as the path gives it --
    layer = params.layers[0]
    x = torch.randn((B, cfg.d_model), generator=gen, device=DEV).to(cfg.activation_dtype)
    h = torch.randn((B, cfg.d_ff), generator=gen, device=DEV).to(cfg.activation_dtype)
    for name, inp in (("gate", x), ("down", h)):
        spec = model.specs[name]
        mm = sparse_linear._Matmul(spec, "cuda", None, DEV)
        Xb = ops.x_blocks(inp.T, spec.nb, spec.block_size)
        spmm_rows(f"serve {name}", "serve tick", layer.ffn[name].detach(), mm.fwd.route.bcol,
                  Xb, mm.fwd.route, spec.out_features, per_tick, per_kernel)
        del mm, Xb

    # -- one layer's MLP at the decode shape: the port's, and the dense yardstick ------
    ffn = layer.ffn_params()
    mlp_ms = time_ms(lambda: model_layers.mlp_apply(ffn, cfg, x, specs=model.specs))
    Wd = {k: sparse_linear.dense_equivalent(ffn[k], model.specs[k]).contiguous()
          for k in ("gate", "up", "down")}
    dense_mlp_ms = {}
    for dt in (torch.float32, torch.bfloat16):
        W = {k: w.to(dt) for k, w in Wd.items()}
        xd = x.to(dt)
        dense_mlp_ms[str(dt).replace("torch.", "")] = time_ms(
            lambda: (torch.nn.functional.silu(xd @ W["gate"]) * (xd @ W["up"])) @ W["down"])
        del W
    del Wd

    # -- teacher-forced decode against forward, float32, two layers, full width --------
    cfg2 = cfg.scaled(num_layers=2, dtype="float32")
    model2 = Model(cfg2)
    params2 = model2.init(torch.Generator(device=DEV).manual_seed(seed + 1))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)).to(DEV)
    with torch.no_grad():
        full = model2.forward(params2, toks).logits
    st = model2.init_decode_state(2, 12)
    steps = []
    for t in range(toks.shape[1]):
        lg, st = model2.decode_step(params2, st, toks[:, t:t + 1],
                                    torch.full((2,), t, dtype=torch.int32, device=DEV))
        steps.append(lg)
    dec = torch.stack(steps, dim=1)
    excess = ((dec - full).abs() - (DECODE_TOL + DECODE_TOL * full.abs())).max().item()
    if excess > 0 or not torch.isfinite(dec).all():
        fail(f"serve: teacher-forced decode differs from forward beyond rtol=atol={DECODE_TOL}")
    decode_err = (dec - full).abs().max().item()
    del model2, params2, full, dec, st

    # bytes a tick must move: the float32 weights once (of the embedding only the rows
    # it gathers), the whole KV cache read once; bytes bound it (4 columns)
    kv_bytes = sum(t.numel() * t.element_size() for t in (state["k"], state["v"]))
    embed_bytes = params.embed.numel() * params.embed.element_size()
    tick_bytes = param_bytes - embed_bytes + B * cfg.d_model * 4 + kv_bytes
    b_ms, b_by = bound(tick_bytes, 2 * B * (param_bytes - embed_bytes) // 4)
    tick_med = statistics.median(run2["tick_ms"])
    emit("serve", config=f"{cfg.name}: granite-8b d_model {cfg.d_model}, {cfg.num_heads} heads, "
         f"{cfg.num_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, CB-sparse "
         f"SwiGLU B={cfg.sparse_block} keep {cfg.sparse_keep}, activations {cfg.dtype}, "
         "float32 weights", layers=cfg.num_layers, layers_cut=None,
         param_bytes=param_bytes, init_s=t_init,
         traffic=dict(SERVE, prompts="np.random.default_rng(0), 2-11 tokens"),
         ticks=ticks, tokens=run2["tokens"], wall_s=[run1["wall_s"], run2["wall_s"]],
         tokens_per_s=run2["tokens"] / run2["wall_s"],
         tokens_per_s_first_run=run1["tokens"] / run1["wall_s"],
         tick_ms=tick_med, tick_ms_p90=float(np.percentile(run2["tick_ms"], 90)),
         tick_ms_first_run=statistics.median(run1["tick_ms"]),
         tick_enqueue_ms=statistics.median(enq), device_tick_ms=device_tick_ms,
         host_share=1 - device_tick_ms / tick_med,
         bound_ms=b_ms, bound_by=b_by, tick_bytes=tick_bytes, kv_cache_bytes=kv_bytes,
         launches_per_tick=per_tick, obs_spmm_launches_per_tick=obs_launches / ticks,
         health=run2["engine"].health()["tick_latency_s"],
         runs_bit_equal=True, impl_reference_max_abs_err=impl_err,
         impl_reference_tolerance=SERVE_IMPL_TOL * impl_scale, argmax_agree=argmax_agree,
         decode_vs_forward=dict(layers=2, dtype="float32", max_abs_err=decode_err,
                                rtol=DECODE_TOL, atol=DECODE_TOL),
         mlp_layer_ms=mlp_ms, dense_mlp_layer_ms=dense_mlp_ms,
         dense_mlp="torch.matmul of one layer's dense_equivalent weights, x (4, 4096)",
         nvidia_smi=smi(), phase_s=time.perf_counter() - t_phase)
    del params, model, state
    return dict(tick_bytes=tick_bytes, kv_cache_bytes=kv_bytes, tick_ms=tick_med,
                device_tick_ms=device_tick_ms, generated=run1["generated"], launches=counted)


# ---------------------------------------------------------------------------
# the train phase: the cb-paper model trained through run_training, full width
# ---------------------------------------------------------------------------

# launch/train's traffic (src/repro/launch/train.py's defaults) for 6 steps
TRAIN = dict(arch="cb-paper", steps=6, global_batch=8, seq_len=256, optimizer="adamw",
             microbatches=1, compression="none")
TRAIN_IMPL_TOL = 2.0**-5       # first step's loss, MLP on impl="cuda" vs "reference", relative:
                               # PR 17's bf16 bound (SERVE_IMPL_TOL says why)
TRAIN_GNORM_TOL = 1e-2         # its grad_norm, relative: the same roundings, summed over 0.9 G
                               # gradient elements
# float32 against bfloat16 activations, the same weights and batch (2 layers): the loss
# within the bf16 bound, the gradient of every parameter pointing the same way (cosine)
# and of the same size (norm ratio). On the CPU at widths 512 and 1024 the two agree to
# a cosine of 0.9999 and a norm ratio within 0.15%; a wrong cast or a lost product moves
# them by far more.
BF16_F32 = dict(loss_rel=2.0**-5, min_cosine=0.99, norm_ratio=(0.9, 1.1))
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
ADAMW_BYTES_PER_PARAM = 28     # AdamW reads p, g, m, v and writes p, m, v: 7 float32


def train_launches_per_step(model) -> dict:
    """Kernel launches one training step must make, from the code: every
    sparse product (gate, up, down in each layer) runs the spmm kernel once
    and the combine once per pass of its plan (``ops.spmm_routed``), in the
    forward, again in the recompute of ``remat="full"`` (``transformer._remat``),
    and once more for dX on the transposed tiles (``sparse.linear._Matmul``);
    dW is ``torch.bmm``."""
    cfg = model.cfg
    fwd_runs = 1 + (cfg.remat == "full")
    spmm = combine = 0
    for spec in model.specs.values():
        mm = sparse_linear._Matmul(spec, "cuda", None, DEV)
        spmm += fwd_runs + 1
        combine += fwd_runs * len(mm.fwd.route.combine.passes) + len(mm.bwd.route.combine.passes)
    return {"spmm": cfg.num_layers * spmm, "combine": cfg.num_layers * combine}


def train_bound(cfg, specs, n_params: int) -> dict:
    """The least time the card could take for one training step: the step's
    products over the rate of their arithmetic, plus the optimizer's bytes.

    bound_ms = bf16_flops / 989 TFLOP/s + sparse_flops / 165 TFLOP/s
               + 28 B * n_params / 3.35 TB/s
    bf16_flops: the attention projections (q, k, v, o), QK^T and PV over the
    full S x S (as computed), each layer's forward run 1 + remat times and
    its backward (dX and dW, 2x), and the unembedding (forward and backward).
    The reference's operands are bfloat16 with float32 sums, the tensor
    cores' bf16 rate. sparse_flops: the MLP's three CB products, 2 nt B^2 N
    each, in the forward (1 + remat runs), dX and dW: float32-grade, priced
    at 3xTF32 as PERF.md prices the spmm kernel. Norms, softmax, RoPE and the
    loss are left out, so this is a floor."""
    N = TRAIN["global_batch"] * TRAIN["seq_len"]
    d, H, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    fwd_runs = 1 + (cfg.remat == "full")
    proj = 2 * N * d * dh * (2 * H + 2 * Hkv)
    attn = 2 * 2 * TRAIN["global_batch"] * H * TRAIN["seq_len"] ** 2 * dh
    bf16 = cfg.num_layers * (proj + attn) * (fwd_runs + 2) + 3 * 2 * N * d * cfg.padded_vocab
    sparse = cfg.num_layers * sum(2 * sp.num_tiles * sp.block_size ** 2 * N
                                  for sp in specs.values()) * (fwd_runs + 2)
    opt_bytes = ADAMW_BYTES_PER_PARAM * n_params
    parts = {"bf16_products_ms": bf16 / BF16_FLOPS_PER_S * 1e3,
             "sparse_products_ms": sparse / TF32X3_FLOPS_PER_S * 1e3,
             "optimizer_bytes_ms": opt_bytes / HBM_BYTES_PER_S * 1e3}
    return dict(bound_ms=sum(parts.values()), bound_parts_ms=parts, bf16_flops=bf16,
                sparse_flops=sparse, optimizer_bytes=opt_bytes)


def kernel_group(name: str) -> str:
    """A device kernel's group in the step's time (torch.profiler's names)."""
    n = name.lower()
    if "cb_spmm" in n or "super_tile" in n:
        return "spmm kernel"
    if "segment" in n or "combine" in n:
        return "combine"
    if any(k in n for k in ("gemm", "gemv", "nvjet", "cutlass", "sm90", "bmm")):
        return "gemm (cuBLAS)"
    if "multi_tensor_apply" in n or "foreach" in n:
        return "foreach (optimizer, clip)"
    if "copy" in n or "convert" in n:
        return "casts and copies"
    if any(k in n for k in ("softmax", "reduce", "norm", "logsumexp")):
        return "reductions"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def fresh_state(model, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return TrainState.create(model.init(gen), OPTIMIZERS[TRAIN["optimizer"]]())


def train_loop_config(steps: int) -> TrainLoopConfig:
    """launch/train's loop settings for ``steps`` steps (its default peak lr
    3e-4 and warmup 10), every step logged."""
    return TrainLoopConfig(total_steps=steps, optimizer=TRAIN["optimizer"],
                           microbatches=TRAIN["microbatches"], compression=TRAIN["compression"],
                           checkpoint_every=max(10, steps // 4), log_every=1)


class EventedModel:
    """A model whose ``loss`` is bracketed by two CUDA events (the forward)."""

    def __init__(self, model, events):
        self.model, self.events = model, events

    def loss(self, params, batch):
        self.events[0].record()
        out = self.model.loss(params, batch)
        self.events[1].record()
        return out


def run_train(seed, per_kernel, launches):
    """The cb-paper model (granite-8b at full width, CB-sparse SwiGLU, full
    remat) trained through ``run_training`` on the card, and its checks."""
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN["arch"])
    model = Model(cfg)                                   # CUDA by default
    stream = SyntheticTokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=TRAIN["seq_len"],
                                             global_batch=TRAIN["global_batch"]))
    expected = train_launches_per_step(model)
    t0 = time.perf_counter()
    state = fresh_state(model, seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.parameters())

    # -- the main path, counted: launch/train's traffic for 6 steps --------------------
    loop = train_loop_config(TRAIN["steps"])
    for w in WRAPPERS.values():
        w.launches = 0
    obs_before = obs.counter("repro.ops.spmm.launches").total()
    torch.cuda.reset_peak_memory_stats()
    state, hist = run_training(model, stream, loop, initial_state=state)
    peak_mem_gb = torch.cuda.max_memory_allocated() / 1e9
    counted = {k: w.launches for k, w in WRAPPERS.items()}
    obs_launches = obs.counter("repro.ops.spmm.launches").total() - obs_before
    for k, c in counted.items():
        launches[k] += c
    per_step = {k: c / TRAIN["steps"] for k, c in counted.items()}
    for k in ("spmm", "combine"):
        if per_step[k] != expected[k]:
            fail(f"train: {k} launched {per_step[k]} times a step, the code says {expected[k]}")
    if obs_launches != counted["spmm"]:
        fail(f"train: obs counted {obs_launches} spmm launches, the wrapper {counted['spmm']}")
    losses = [h["loss"] for h in hist]
    if len(losses) != TRAIN["steps"] or not all(map(math.isfinite, losses)):
        fail(f"train: losses {losses}")
    step_ms = [h["step_time_s"] * 1e3 for h in hist]
    step_med = statistics.median(step_ms[1:])

    # -- one more step: forward, backward and optimizer between CUDA events -------------
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    lr_fn = warmup_cosine(loop.peak_lr, loop.warmup_steps, loop.total_steps)
    step_fn = build_train_step(EventedModel(model, ev), OPTIMIZERS[loop.optimizer](), lr_fn,
                               clip_norm=loop.clip_norm)
    hook = state.params.embed.register_post_accumulate_grad_hook(lambda p: ev[2].record())
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in stream.batch(TRAIN["steps"]).items()}
    # the optimizer's state is the state's own: the step goes on from step 6
    step_fn(state, batch)
    ev[3].record()
    torch.cuda.synchronize()
    hook.remove()
    fwd_ms, bwd_ms, opt_ms = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))

    # -- one more step under torch.profiler: device busy time, by kernel group ----------
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, n_ops = collections.Counter(), 0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] += dev / 1e3
        if e.key.startswith("aten::"):
            n_ops += e.count
    by_group = collections.Counter()
    for k, ms in by_kernel.items():
        by_group[kernel_group(k)] += ms
    busy_ms = sum(by_kernel.values())
    del prof, state, hist, batch, step_fn
    torch.cuda.empty_cache()

    # -- two runs from the same init, 2 steps each: bit-equal losses and parameters -----
    runs = []
    for _ in range(2):
        st, h = run_training(model, stream, train_loop_config(2),
                             initial_state=fresh_state(model, seed))
        runs.append(([x["loss"] for x in h], [p.detach().cpu() for p in st.params.parameters()]))
        del st
        torch.cuda.empty_cache()
    runs_bit_equal = runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    if not runs_bit_equal:
        fail(f"train: two runs from the same init differ (losses {runs[0][0]} / {runs[1][0]})")
    two_step = runs[0]                      # the mesh phase's one-rank mesh is held to it
    del runs

    # -- full width, 2 layers: impl="cuda" vs "reference", and float32 vs bfloat16 ------
    cfg2 = cfg.scaled(num_layers=2)
    params2 = Model(cfg2).init(torch.Generator(device=DEV).manual_seed(seed + 1))
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in stream.batch(0).items()}

    def loss_and_grads(m):
        for p in params2.parameters():
            p.grad = None
        loss, _ = m.loss(params2, batch)
        loss.backward()
        return loss.item(), [p.grad for p in params2.parameters()]

    l_cuda, g_cuda = loss_and_grads(Model(cfg2))
    n_cuda = global_norm(g_cuda).item()
    l_ref, g_ref = loss_and_grads(Model(cfg2, impl="reference"))
    n_ref = global_norm(g_ref).item()
    del g_ref
    impl = dict(loss=[l_cuda, l_ref], grad_norm=[n_cuda, n_ref],
                loss_rel_err=abs(l_cuda - l_ref) / abs(l_ref),
                grad_norm_rel_err=abs(n_cuda - n_ref) / n_ref,
                tolerance=dict(loss=TRAIN_IMPL_TOL, grad_norm=TRAIN_GNORM_TOL))
    if impl["loss_rel_err"] > TRAIN_IMPL_TOL or impl["grad_norm_rel_err"] > TRAIN_GNORM_TOL:
        fail(f"train: impl='cuda' vs 'reference' at 2 layers: {impl}")
    l_f32, g_f32 = loss_and_grads(Model(cfg2.scaled(dtype="float32")))
    cosine = [float(torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0))
              for a, b in zip(g_cuda, g_f32)]
    ratio = [float(a.norm() / b.norm()) for a, b in zip(g_cuda, g_f32)]
    lo, hi = BF16_F32["norm_ratio"]
    bf16_f32 = dict(loss=[l_cuda, l_f32], loss_rel_err=abs(l_cuda - l_f32) / abs(l_f32),
                    min_cosine=min(cosine), norm_ratio=[min(ratio), max(ratio)],
                    tolerance=BF16_F32)
    if (bf16_f32["loss_rel_err"] > BF16_F32["loss_rel"] or min(cosine) < BF16_F32["min_cosine"]
            or min(ratio) < lo or max(ratio) > hi):
        fail(f"train: bfloat16 and float32 disagree at 2 layers: {bf16_f32}")
    del params2, g_cuda, g_f32, batch
    torch.cuda.empty_cache()

    # -- the kernels at the training shapes: N = 2048, X bf16 forward, dY float32 for dX --
    N = TRAIN["global_batch"] * TRAIN["seq_len"]
    gen = torch.Generator(device=DEV).manual_seed(seed + 2)
    layer0 = Model(cfg.scaled(num_layers=1)).init(gen).layers[0]
    parts = {}
    for name in ("gate", "down"):
        spec = model.specs[name]
        B = spec.block_size
        mm = sparse_linear._Matmul(spec, "cuda", None, DEV)
        tiles = layer0.ffn[name].detach()
        X = torch.randn((spec.in_features, N), generator=gen, device=DEV).to(cfg.activation_dtype)
        dY = torch.randn((spec.out_features, N), generator=gen, device=DEV)
        fwd = spmm_rows(f"train {name} forward", "train step", tiles, mm.fwd.route.bcol,
                        ops.x_blocks(X, spec.nb, B), mm.fwd.route, spec.out_features, per_step,
                        per_kernel)
        dxr = spmm_rows(f"train {name} dX", "train step", mm.transposed_tiles(tiles),
                        mm.bwd.route.bcol, ops.x_blocks(dY, spec.mb, B), mm.bwd.route,
                        spec.in_features, per_step, per_kernel)
        parts[name] = dict(spmm_forward_ms=fwd["spmm"]["ms"], spmm_dX_ms=dxr["spmm"]["ms"],
                           combine_forward_ms=fwd["combine"]["ms"],
                           combine_dX_ms=dxr["combine"]["ms"])
        del mm, X, dY
    del layer0
    torch.cuda.empty_cache()

    b = train_bound(cfg, model.specs, n_params)
    emit("train", config=f"{cfg.name}: granite-8b d_model {cfg.d_model}, {cfg.num_heads} heads, "
         f"{cfg.num_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, CB-sparse "
         f"SwiGLU B={cfg.sparse_block} keep {cfg.sparse_keep}, activations {cfg.dtype}, "
         f"float32 weights, remat {cfg.remat}", layers=cfg.num_layers, layers_cut=None,
         params=n_params, init_s=t_init,
         traffic=dict(TRAIN, stream="SyntheticTokenStream, seed 1234", peak_lr=loop.peak_lr,
                      warmup_steps=loop.warmup_steps),
         losses=losses, step_ms=step_med, step_runs_ms=step_ms,
         tokens_per_s=N / (step_med / 1e3), fwd_ms=fwd_ms, bwd_ms=bwd_ms, optimizer_ms=opt_ms,
         peak_mem_gb=peak_mem_gb, device_busy_ms=busy_ms, profiled_step_ms=prof_wall_ms,
         idle_share=max(0.0, 1 - busy_ms / prof_wall_ms),
         idle_share_unprofiled=max(0.0, 1 - busy_ms / step_med),
         device_ms_by_group=dict(by_group.most_common()),
         device_ms_by_kernel=dict(by_kernel.most_common(12)), aten_ops_per_step=n_ops,
         launches_per_step=per_step, expected_launches_per_step=expected,
         obs_spmm_launches_per_step=obs_launches / TRAIN["steps"],
         **b, bound_rates="bf16 989 TFLOP/s, sparse 3xTF32 165 TFLOP/s, 3.35 TB/s",
         runs_bit_equal=runs_bit_equal, impl_vs_reference=impl, bfloat16_vs_float32=bf16_f32,
         kernel_parts_ms=parts, nvidia_smi=smi(), phase_s=time.perf_counter() - t_phase)
    del model
    line = dict(step_ms=step_med, peak_mem_gb=peak_mem_gb, two_step=two_step, **b)

    # -- resume on the card at smoke size: a checkpoint at 5, restored, run to 10 -------
    t0 = time.perf_counter()
    small = Model(get_smoke_config(TRAIN["arch"]))
    loop_s = dataclasses.replace(train_loop_config(10), checkpoint_every=5, warmup_steps=2)
    stream_s = SyntheticTokenStream(DataConfig(vocab_size=small.cfg.vocab_size,
                                               seq_len=TRAIN["seq_len"],
                                               global_batch=TRAIN["global_batch"]))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        straight, hist_s = run_training(small, stream_s, loop_s, checkpointer=ck,
                                        initial_state=fresh_state(small, seed))
        ck.wait()
        mid = ck.restore(fresh_state(small, seed + 3), step=5)
        resumed, hist_r = run_training(small, stream_s, loop_s, initial_state=mid)
        steps_saved = ck.list_steps()
    bit_equal = all(torch.equal(a, b) for a, b in zip(straight.params.parameters(),
                                                      resumed.params.parameters()))
    if not bit_equal or steps_saved != [5, 10] or int(mid.step) != 10:
        fail(f"train_resume: resumed parameters bit-equal {bit_equal}, checkpoints {steps_saved}")
    emit("train_resume", config=small.cfg.name, steps=10, checkpoint_steps=steps_saved,
         resumed_from=5, losses=[h["loss"] for h in hist_s],
         resumed_losses=[h["loss"] for h in hist_r], params_bit_equal=bit_equal,
         seconds=time.perf_counter() - t0)
    return line


# ---------------------------------------------------------------------------
# the mesh phase: training on a (data, model) DeviceMesh (Model(cfg, mesh=))
# ---------------------------------------------------------------------------

MESH_STEPS = 2                 # the train line's traffic, 2 steps
MESH_TOL = 2.0**-5             # loss and grad_norm, relative, against one rank from the same
                               # weights: bfloat16 activations summed in another order (the
                               # row-parallel partial sums are added over model, in bf16)
MESH_TIMEOUT = 420             # seconds one group of ranks may take, start-up included
# (tag, arch, mesh shape, layers, steps, dtype): the 2x2 and 1x2 runs are gloo ranks
# sharing cuda:0 (NCCL refuses two ranks on one card), not four or two cards
MESH_RUNS = (("mesh_train 2x2", TRAIN["arch"], (2, 2), 2, MESH_STEPS, None),
             ("mesh_moe 1x2", "mixtral-8x7b", (1, 2), 2, 1, "float32"))


def mesh_config(arch: str, layers: int, dtype):
    cfg = get_config(arch).scaled(num_layers=layers)
    return cfg if dtype is None else cfg.scaled(dtype=dtype)


class TileWatch:
    """A run_training monitor that hashes the rank's CB tiles after every step."""

    def __init__(self, params):
        self.tiles = [(n, p) for n, p in params.named_parameters()
                      if n.split(".")[-1] in ("gate", "up", "down")]
        self.hashes = []

    def heartbeat(self, step):
        self.hashes.append([hashlib.sha256(p.to_local().detach().cpu().numpy().tobytes())
                            .hexdigest() for _, p in self.tiles])

    def report_straggler(self, step, seconds):
        pass


def mesh_train(model, stream, steps: int, seed: int, monitor=None):
    """``steps`` of run_training from the seeded weights, on the model's mesh
    (under its rules, as launch/train runs it) or on one rank, counted: the
    launch counters zeroed just before and read just after. Returns (history,
    launches, peak GB, state, routing counts)."""
    state = fresh_state(model, seed)
    if monitor is not None:
        monitor = monitor(state.params)
    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with axis_rules(model.mesh), moe.record_routing() as routing:
        state, hist = run_training(model, stream, train_loop_config(steps), initial_state=state,
                                   monitor=monitor)
    torch.cuda.synchronize()
    counted = {k: w.launches for k, w in WRAPPERS.items()}
    return hist, counted, torch.cuda.max_memory_allocated() / 1e9, state, \
        [c.cpu() for c in routing], monitor


def train_stream(cfg):
    """The train line's token stream (with ``launch/train``'s stub frames for
    the encoder-decoder family)."""
    stream = SyntheticTokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                                             global_batch=TRAIN["global_batch"]))
    return FramesStream(stream, cfg) if cfg.family == "encdec" else stream


def mesh_rank(rank: int, job: dict) -> None:
    """One rank of a mesh run (a spawned process): joins the gloo group on
    cuda:0, trains its part of the model, and saves what it measured."""
    faulthandler.enable()                   # a crash in native code prints its Python stack
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{job['store']}", rank=rank,
                            world_size=job["world"])
    try:
        mesh = make_mesh(tuple(job["shape"]), ("data", "model"))
        cfg = mesh_config(job["arch"], job["layers"], job["dtype"])
        model = Model(cfg, mesh=mesh)
        t0 = time.perf_counter()
        hist, counted, peak, state, routing, watch = mesh_train(
            model, train_stream(cfg), job["steps"], job["seed"],
            TileWatch if cfg.sparse_mlp else None)
        run_s = time.perf_counter() - t0
        rows = {k: [] for k in WRAPPERS}
        if rank == 0 and cfg.sparse_mlp:        # the kernels at this rank's forward shapes
            N = TRAIN["global_batch"] * TRAIN["seq_len"] // job["shape"][0]
            per_step = {k: c / job["steps"] for k, c in counted.items()}
            gen = torch.Generator(device=DEV).manual_seed(job["seed"] + 9)
            for name in ("gate", "down"):
                spec = model.specs[name]
                route = sparse_linear._Matmul(spec, "cuda", None, DEV).fwd.route
                X = torch.randn((spec.in_features, N), generator=gen, device=DEV) \
                    .to(cfg.activation_dtype)
                spmm_rows(f"{job['tag']} rank 0 {name} forward", f"{job['tag']} step",
                          state.params.layers[0].ffn[name].to_local().detach(), route.bcol,
                          ops.x_blocks(X, spec.nb, spec.block_size), route, spec.out_features,
                          per_step, rows)
        out = dict(losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist],
                   step_ms=[h["step_time_s"] * 1e3 for h in hist], launches=counted,
                   peak_mem_gb=peak, run_s=run_s, routing=routing,
                   tile_hashes=None if watch is None else watch.hashes, kernel_rows=rows,
                   worst_err=dict(worst_err), worst_rel=dict(worst_rel))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, pathlib.Path(job["out"]) / f"mesh-{job['world']}-rank{rank}.pt")


def spawn_ranks(job: dict, tmp: pathlib.Path, target=None, stem=None) -> list[dict]:
    """``job["world"]`` mesh ranks spawned at once, each running ``target``
    (``mesh_rank`` by default) and saving ``tmp/{stem}-rank{r}.pt``; every one
    must end within ``MESH_TIMEOUT`` with exit code 0, or the phase fails."""
    target = mesh_rank if target is None else target
    stem = f"mesh-{job['world']}" if stem is None else stem
    procs = [MP.Process(target=target, args=(r, job)) for r in range(job["world"])]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if alive:
        fail(f"{job['tag']}: ranks {alive} still running after {MESH_TIMEOUT} s")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        fail(f"{job['tag']}: ranks exited with codes {bad}")
    return [torch.load(tmp / f"{stem}-rank{r}.pt", weights_only=False)
            for r in range(job["world"])]


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def run_mesh(seed, train_line, per_kernel, launches, mesh_launches) -> None:
    """The train line's training on a (data, model) mesh: one NCCL rank at full
    depth held bit for bit to the train phase's 2-step run; 2x2 gloo ranks of
    cb-paper at 2 layers and 1x2 of mixtral at 2 layers, sharing the card, held
    to a one-rank run from the same weights."""
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN["arch"])
    stream = train_stream(cfg)
    want_losses, want_params = train_line.pop("two_step")

    # -- 1x1: one NCCL rank, full depth; every collective is the identity ---------------
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            model = Model(cfg, mesh=mesh)
            hist, counted, peak, state, _, _ = mesh_train(model, stream, MESH_STEPS, seed)
            expected = train_launches_per_step(model)
            for k in ("spmm", "combine"):
                if counted[k] != MESH_STEPS * expected[k]:
                    fail(f"mesh_train 1x1: {k} launched {counted[k]} times in {MESH_STEPS} "
                         f"steps, the code says {MESH_STEPS * expected[k]}")
            losses = [h["loss"] for h in hist]
            params_equal = [bool(torch.equal(p.to_local().detach().cpu(), w))
                            for p, w in zip(state.params.parameters(), want_params,
                                            strict=True)]
            dtensor = all(isinstance(p, DTensor) for p in state.params.parameters())
            del state
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    if losses != want_losses or not all(params_equal) or not dtensor:
        fail(f"mesh_train 1x1: losses {losses} against the train phase's {want_losses}, "
             f"{params_equal.count(False)} parameters differ, DTensor parameters {dtensor}")
    for k, c in counted.items():
        launches[k] += c
        if c:
            mesh_launches.setdefault(k, {})["mesh_train 1x1"] = c
    step_ms = [h["step_time_s"] * 1e3 for h in hist]
    emit("mesh_train", mesh="1x1", backend="nccl", ranks=1, config=cfg.name,
         layers=cfg.num_layers, reduced=None, traffic=dict(TRAIN, steps=MESH_STEPS),
         losses=losses, train_losses=want_losses, losses_bit_equal=True,
         params_bit_equal=True, params=len(params_equal), dtensor_params=dtensor,
         step_ms=step_ms[-1], step_runs_ms=step_ms, train_step_ms=train_line["step_ms"],
         peak_mem_gb=peak, train_peak_mem_gb=train_line["peak_mem_gb"],
         launches=counted, expected_launches_per_step=expected)
    del want_params

    # -- 2x2 and 1x2: gloo ranks sharing the card, against one rank --------------------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for tag, arch, shape, layers, steps, dtype in MESH_RUNS:
            mcfg = mesh_config(arch, layers, dtype)
            one = Model(mcfg)
            t0 = time.perf_counter()
            hist, counted1, peak1, state, routing1, _ = mesh_train(one, train_stream(mcfg),
                                                                    steps, seed + 11)
            one_s = time.perf_counter() - t0
            expected = train_launches_per_step(one) if mcfg.sparse_mlp else \
                {"spmm": 0, "combine": 0}
            del state
            torch.cuda.empty_cache()                # the one-rank state, before the ranks'
            world = shape[0] * shape[1]
            job = dict(tag=tag, arch=arch, shape=list(shape), layers=layers, steps=steps,
                       dtype=dtype, seed=seed + 11, world=world, store=str(tmp / f"store{world}"),
                       out=str(tmp))
            t0 = time.perf_counter()
            res = spawn_ranks(job, tmp)
            group_s = time.perf_counter() - t0
            for r in res:
                for k in WRAPPERS:
                    worst_err[k] = max(worst_err[k], r["worst_err"][k])
                    worst_rel[k] = max(worst_rel[k], r["worst_rel"][k])
                    per_kernel[k] += r["kernel_rows"][k]
            one_losses = [h["loss"] for h in hist]
            one_norms = [h["grad_norm"] for h in hist]
            errs = dict(loss=max(rel(a, b) for r in res for a, b in zip(r["losses"], one_losses)),
                        grad_norm=max(rel(a, b) for r in res
                                      for a, b in zip(r["grad_norms"], one_norms)))
            if max(errs.values()) > MESH_TOL:
                fail(f"{tag}: against one rank {errs} > {MESH_TOL} (losses "
                     f"{[r['losses'] for r in res]} / {one_losses})")
            for rank, r in enumerate(res):
                for k in ("spmm", "combine"):
                    if r["launches"][k] != steps * expected[k]:
                        fail(f"{tag}: rank {rank} launched {k} {r['launches'][k]} times, the "
                             f"code says {steps * expected[k]}")
                if r["losses"] != res[0]["losses"]:
                    fail(f"{tag}: rank {rank}'s losses {r['losses']} are not rank 0's")
            tiles_equal = None
            if mcfg.sparse_mlp:
                tiles_equal = all(r["tile_hashes"] == res[0]["tile_hashes"] for r in res)
                if not tiles_equal or len(res[0]["tile_hashes"]) != steps:
                    fail(f"{tag}: the replicated CB tiles differ between ranks")
            routing_equal = None
            if mcfg.family == "moe":
                routing_equal = all(len(r["routing"]) == len(routing1) and all(
                    torch.equal(a, b) for a, b in zip(r["routing"], routing1)) for r in res)
                if not routing_equal:
                    fail(f"{tag}: routing counts differ from the one-rank run's")
            for k in WRAPPERS:
                n = sum(r["launches"][k] for r in res)
                launches[k] += n
                if n:
                    mesh_launches.setdefault(k, {})[f"{tag} ({world} ranks)"] = n
            reduced = [f"depth {get_config(arch).num_layers} -> {layers}"] + \
                ([f"activations {get_config(arch).dtype} -> {dtype}"] if dtype else [])
            emit(tag.split()[0], mesh=f"{shape[0]}x{shape[1]}", backend="gloo", ranks=world,
                 one_card=True, config=mcfg.name, layers=layers, reduced=reduced,
                 traffic={k: v for k, v in TRAIN.items() if k != "arch"} | {"steps": steps},
                 losses=res[0]["losses"],
                 grad_norms=res[0]["grad_norms"], one_rank_losses=one_losses,
                 one_rank_grad_norms=one_norms, rel_err=errs, tolerance=MESH_TOL,
                 step_ms=max(r["step_ms"][-1] for r in res),
                 per_rank={k: [r[k] for r in res] for k in ("step_ms", "peak_mem_gb", "launches",
                                                             "run_s")},
                 one_rank=dict(step_ms=[h["step_time_s"] * 1e3 for h in hist],
                               peak_mem_gb=peak1, launches=counted1, run_s=one_s),
                 expected_launches_per_step=expected, tiles_bit_equal_across_ranks=tiles_equal,
                 routing_equal=routing_equal,
                 routing_assignments=int(sum(int(c.sum()) for c in routing1)) if routing1
                 else None, rank_group_s=group_s)
            del res
    emit("mesh_phase", seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# the mesh_family and mesh_serve lines: every family trained, and cb-paper,
# mamba2 and whisper decoded, on a (data, model) mesh
# ---------------------------------------------------------------------------

MESH_FAMILIES = ("mamba2-130m", "zamba2-2.7b", "whisper-small")
MESH_DECODE = ("cb-paper", "mamba2-130m", "whisper-small")
MESH_SERVE_STEPS = 8           # teacher-forced decode steps of the 1x2 runs
MESH_SERVE_TOL = 1e-4          # their logits against one rank, relative to the real vocab's
                               # largest logit: float32 activations, the softmax combined over
                               # the cache's two halves and the row-parallel sums added in
                               # another order
MESH_SERVE_REDUCED = ("activations bfloat16 -> float32: the top two of 50k logits of random "
                      "weights lie within a bfloat16 rounding of each other often enough "
                      "that another summation order flips a token (seen on whisper)")


def mesh2_config(arch: str, train: bool):
    """The 1x2 runs' config: full width, ``two_layers``' depth; training in the
    config's own activations (bfloat16), decoding in float32
    (``MESH_SERVE_REDUCED``)."""
    cfg = two_layers(get_config(arch))
    return cfg.scaled(dtype=get_config(arch).dtype) if train else cfg


def decode_rules(cfg, mesh):
    """``rules_for``'s rules of the serve line's decode shape on ``mesh``."""
    return rules_for(cfg, ShapeConfig("serve_line", "decode", SERVE["max_len"], SERVE["slots"]),
                     mesh)


def decode_launches_per_step(model) -> dict:
    """Kernel launches one decode step must make, from the code: every sparse
    product (gate, up, down in each layer) runs the spmm kernel once and the
    combine once per pass of its plan (``ops.spmm_routed``)."""
    if not model.cfg.sparse_mlp:
        return {"spmm": 0, "combine": 0}
    spmm = combine = 0
    for spec in model.specs.values():
        spmm += 1
        combine += len(sparse_linear._Matmul(spec, "cuda", None, DEV).fwd.route.combine.passes)
    return {"spmm": model.cfg.num_layers * spmm, "combine": model.cfg.num_layers * combine}


def state_bytes(state) -> int:
    """This rank's bytes of a train state's parameters and moments."""
    ts = [*state.params.parameters(), *state.opt_state.mu, *state.opt_state.nu]
    return sum(t.to_local().nbytes if isinstance(t, DTensor) else t.nbytes for t in ts)


def mesh_decode(cfg, seed: int, mesh=None, rows=None):
    """``MESH_SERVE_STEPS`` teacher-forced ``decode_step``s of seeded weights
    and tokens (whisper over ``precompute_cross`` of seeded frames), on
    ``mesh`` under its decode rules or on one rank; the launch counters zeroed
    just before the steps and read just after. ``rows`` (a kernels-row list)
    gets the spmm and combine at this rank's shapes. Returns (logits (B, T,
    Vpad) float32, launches, expected launches)."""
    B, T = SERVE["slots"], MESH_SERVE_STEPS
    model = Model(cfg, mesh=mesh)
    with axis_rules(mesh, None if mesh is None else decode_rules(cfg, mesh)):
        params = model.init(torch.Generator(device=DEV).manual_seed(seed))
        state = model.init_decode_state(B, SERVE["max_len"])
        if cfg.family == "encdec":
            state["cross"] = encdec.precompute_cross(params, cfg, family_frames(cfg, B, seed + 2))
        rng = np.random.default_rng(seed + 45)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)).to(DEV)
        torch.cuda.synchronize()
        for w in WRAPPERS.values():
            w.launches = 0
        out = []
        for t in range(T):
            lg, state = model.decode_step(params, state, toks[:, t:t + 1],
                                          torch.full((B,), t, dtype=torch.int32, device=DEV))
            out.append(full_tensor(lg).float())
        torch.cuda.synchronize()
        counted = {k: w.launches for k, w in WRAPPERS.items()}
    expected = decode_launches_per_step(model)
    if rows is not None and cfg.sparse_mlp:       # the kernels at this rank's decode shapes
        lay = params.layers[0].ffn
        per_step = {k: c / T for k, c in counted.items()}
        gen = torch.Generator(device=DEV).manual_seed(seed + 9)
        for name in ("gate", "down"):
            spec = model.specs[name]
            route = sparse_linear._Matmul(spec, "cuda", None, DEV).fwd.route
            X = torch.randn((spec.in_features, B), generator=gen, device=DEV) \
                .to(cfg.activation_dtype)
            tiles = lay[name].to_local() if isinstance(lay[name], DTensor) else lay[name]
            spmm_rows(f"mesh_serve 1x2 rank 0 {cfg.name} {name}", "mesh_serve 1x2 step",
                      tiles.detach(), route.bcol, ops.x_blocks(X, spec.nb, spec.block_size),
                      route, spec.out_features, per_step, rows)
    return torch.stack(out, dim=1), counted, expected


def mesh2_rank(rank: int, job: dict) -> None:
    """One of the two gloo ranks (sharing cuda:0) of the 1x2 mesh_family and
    mesh_serve runs: each family's training at 2 layers, then each decode
    case; saves what it measured."""
    faulthandler.enable()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{job['store']}", rank=rank,
                            world_size=2)
    try:
        mesh = make_mesh((1, 2), ("data", "model"))
        out = {"train": {}, "decode": {}, "rows": {k: [] for k in WRAPPERS}}
        for arch in MESH_FAMILIES:
            cfg = mesh2_config(arch, train=True)
            model = Model(cfg, mesh=mesh)
            hist, counted, peak, state, _, _ = mesh_train(model, train_stream(cfg), MESH_STEPS,
                                                          job["seed"])
            out["train"][arch] = dict(losses=[h["loss"] for h in hist],
                                      grad_norms=[h["grad_norm"] for h in hist],
                                      step_ms=[h["step_time_s"] * 1e3 for h in hist],
                                      peak_mem_gb=peak, state_bytes=state_bytes(state))
            del state, model
            torch.cuda.empty_cache()
        for arch in MESH_DECODE:
            cfg = mesh2_config(arch, train=False)
            logits, counted, expected = mesh_decode(cfg, job["seed"], mesh,
                                                    out["rows"] if rank == 0 else None)
            out["decode"][arch] = dict(logits=logits.cpu(), launches=counted, expected=expected)
            torch.cuda.empty_cache()
        out["worst_err"], out["worst_rel"] = dict(worst_err), dict(worst_rel)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, pathlib.Path(job["out"]) / f"mesh2-rank{rank}.pt")


def one_nccl_rank(fn):
    """``fn(mesh)`` on a 1x1 mesh of one NCCL rank in this process."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            return fn(make_mesh((1, 1), ("data", "model")))
        finally:
            dist.destroy_process_group()


def run_mesh_families(seed, serve_line, per_kernel, launches, mesh_launches) -> None:
    """``mesh_serve`` and ``mesh_family``: cb-paper served through
    ``ServingEngine`` on a 1x1 NCCL mesh, tokens bit-equal to the ``serve``
    line's; mamba2, zamba2 and whisper trained 2 steps on a 1x1 NCCL mesh, bit
    for bit a local run's; then two gloo ranks sharing the card (1x2) at 2
    layers, the families' training and the decode of cb-paper, mamba2 and
    whisper (the KV cache's sequence split in two) against one rank."""
    t_phase = time.perf_counter()
    cfg = get_config(SERVE["arch"])

    # -- mesh_serve 1x1: the serve line's traffic through decode_step on DTensor weights --
    def serve_on(mesh):
        model = Model(cfg, mesh=mesh)
        with axis_rules(mesh, decode_rules(cfg, mesh)):
            params = model.init(torch.Generator(device=DEV).manual_seed(seed))
            dtensor = all(isinstance(p, DTensor) for p in params.parameters())
            for w in WRAPPERS.values():
                w.launches = 0
            run = serve_once(model, params)
            counted = {k: w.launches for k, w in WRAPPERS.items()}
        del params, model
        torch.cuda.empty_cache()
        return run, counted, dtensor

    run, counted, dtensor = one_nccl_rank(serve_on)
    same = run["generated"] == serve_line["generated"]
    if not same or counted != serve_line["launches"] or not dtensor:
        fail(f"mesh_serve 1x1: tokens bit-equal {same}, launches {counted} against the serve "
             f"line's {serve_line['launches']}, DTensor weights {dtensor}")
    for k, c in counted.items():
        launches[k] += c
        if c:
            mesh_launches.setdefault(k, {})["mesh_serve 1x1"] = c
    emit("mesh_serve", mesh="1x1", backend="nccl", ranks=1, config=cfg.name,
         layers=cfg.num_layers, reduced=None, traffic=SERVE, tokens_bit_equal=True,
         ticks=run["engine"].ticks, tick_ms=statistics.median(run["tick_ms"]),
         serve_tick_ms=serve_line["tick_ms"], launches=counted, dtensor_params=dtensor)
    del run

    # -- mesh_family 1x1: two steps of the train traffic, bit for bit the local run's ----
    for arch in MESH_FAMILIES:
        fcfg = get_config(arch)
        stream = train_stream(fcfg)
        hist, _, peak_l, state, _, _ = mesh_train(Model(fcfg), stream, MESH_STEPS, seed)
        want = [p.detach().cpu() for p in state.params.parameters()]
        local_ms = [h["step_time_s"] * 1e3 for h in hist]
        local_losses = [h["loss"] for h in hist]
        del state
        torch.cuda.empty_cache()

        def train_on(mesh):
            h, _, peak, st, _, _ = mesh_train(Model(fcfg, mesh=mesh), stream, MESH_STEPS, seed)
            eq = [bool(torch.equal(p.to_local().detach().cpu(), w))
                  for p, w in zip(st.params.parameters(), want, strict=True)]
            nbytes = state_bytes(st)
            del st
            torch.cuda.empty_cache()
            return h, peak, eq, nbytes

        mhist, peak, eq, nbytes = one_nccl_rank(train_on)
        losses = [h["loss"] for h in mhist]
        if losses != local_losses or not all(eq):
            fail(f"mesh_family 1x1 {arch}: losses {losses} against the local run's "
                 f"{local_losses}, {eq.count(False)} of {len(eq)} parameters differ")
        emit("mesh_family", mesh="1x1", backend="nccl", ranks=1, arch=arch, config=fcfg.name,
             layers=fcfg.num_layers, reduced=None,
             traffic={k: v for k, v in TRAIN.items() if k != "arch"} | {"steps": MESH_STEPS},
             losses=losses, local_losses=local_losses, losses_bit_equal=True,
             params_bit_equal=True, params=len(eq),
             step_ms=mhist[-1]["step_time_s"] * 1e3,
             step_runs_ms=[h["step_time_s"] * 1e3 for h in mhist], local_step_ms=local_ms,
             peak_mem_gb=peak, local_peak_mem_gb=peak_l, state_gb=nbytes / 1e9)
        del want
        torch.cuda.empty_cache()

    # -- 1x2: two gloo ranks sharing the card, against one rank -------------------------
    one_train, one_decode = {}, {}
    for arch in MESH_FAMILIES:
        fcfg = mesh2_config(arch, train=True)
        hist, _, peak, state, _, _ = mesh_train(Model(fcfg), train_stream(fcfg), MESH_STEPS,
                                                seed + 11)
        one_train[arch] = dict(losses=[h["loss"] for h in hist],
                               grad_norms=[h["grad_norm"] for h in hist], peak_mem_gb=peak,
                               state_bytes=state_bytes(state))
        del state
        torch.cuda.empty_cache()
    for arch in MESH_DECODE:
        logits, counted, expected = mesh_decode(mesh2_config(arch, train=False), seed + 11)
        one_decode[arch] = dict(logits=logits.cpu(), launches=counted)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        res = spawn_ranks(dict(tag="mesh 1x2", world=2, seed=seed + 11, store=str(tmp / "store"),
                               out=str(tmp)), tmp, mesh2_rank, "mesh2")
        group_s = time.perf_counter() - t0
    for r in res:
        for k in WRAPPERS:
            worst_err[k] = max(worst_err[k], r["worst_err"][k])
            worst_rel[k] = max(worst_rel[k], r["worst_rel"][k])
            per_kernel[k] += r["rows"][k]
    for arch in MESH_FAMILIES:
        one = one_train[arch]
        errs = dict(loss=max(rel(a, b) for r in res
                             for a, b in zip(r["train"][arch]["losses"], one["losses"])),
                    grad_norm=max(rel(a, b) for r in res
                                  for a, b in zip(r["train"][arch]["grad_norms"],
                                                  one["grad_norms"])))
        if max(errs.values()) > MESH_TOL or res[1]["train"][arch]["losses"] != \
                res[0]["train"][arch]["losses"]:
            fail(f"mesh_family 1x2 {arch}: against one rank {errs} > {MESH_TOL}, or the ranks' "
                 "losses differ")
        emit("mesh_family", mesh="1x2", backend="gloo", ranks=2, one_card=True, arch=arch,
             layers=2, reduced=[f"depth {get_config(arch).num_layers} -> 2"],
             losses=res[0]["train"][arch]["losses"], grad_norms=res[0]["train"][arch][
                 "grad_norms"], one_rank_losses=one["losses"],
             one_rank_grad_norms=one["grad_norms"], rel_err=errs, tolerance=MESH_TOL,
             state_bytes_per_rank=[r["train"][arch]["state_bytes"] for r in res],
             one_rank_state_bytes=one["state_bytes"],
             step_ms=max(r["train"][arch]["step_ms"][-1] for r in res),
             peak_mem_gb=[r["train"][arch]["peak_mem_gb"] for r in res],
             rank_group_s=group_s)
    for arch in MESH_DECODE:
        V = get_config(arch).vocab_size                 # the padding columns hold -1e9
        want = one_decode[arch]["logits"][..., :V]
        scale = max(1.0, want.abs().max().item())
        err = max((r["decode"][arch]["logits"][..., :V] - want).abs().max().item() for r in res)
        tokens_equal = all(torch.equal(r["decode"][arch]["logits"].argmax(-1), want.argmax(-1))
                           for r in res)
        for rank, r in enumerate(res):
            d = r["decode"][arch]
            want_l = {k: MESH_SERVE_STEPS * v for k, v in d["expected"].items()}
            if {k: d["launches"][k] for k in want_l} != want_l:
                fail(f"mesh_serve 1x2 {arch}: rank {rank} launched {d['launches']}, the code "
                     f"says {want_l}")
        if err > MESH_SERVE_TOL * scale or not tokens_equal:
            fail(f"mesh_serve 1x2 {arch}: logits {err:.3e} from one rank's (> {MESH_SERVE_TOL}"
                 f" x {scale:.3e}), tokens equal {tokens_equal}")
        for k in WRAPPERS:
            n = sum(r["decode"][arch]["launches"][k] for r in res)
            launches[k] += n
            if n:
                mesh_launches.setdefault(k, {})[f"mesh_serve 1x2 {arch} (2 ranks)"] = n
        emit("mesh_serve", mesh="1x2", backend="gloo", ranks=2, one_card=True, arch=arch,
             layers=2, reduced=[f"depth {get_config(arch).num_layers} -> 2",
                                MESH_SERVE_REDUCED],
             kv_seq_split=2, steps=MESH_SERVE_STEPS, slots=SERVE["slots"],
             max_len=SERVE["max_len"], max_abs_err=err, scale=scale, tolerance=MESH_SERVE_TOL,
             tokens_equal=True, launches_per_rank=[r["decode"][arch]["launches"] for r in res],
             expected_launches_per_step=res[0]["decode"][arch]["expected"],
             one_rank_launches=one_decode[arch]["launches"])
    emit("mesh_families_phase", seconds=time.perf_counter() - t_phase, rank_group_s=group_s)


# ---------------------------------------------------------------------------
# the dryrun phase: the one-rank dry run's counts against what the card measured
# ---------------------------------------------------------------------------

DRYRUN_FLOPS_BAND = (0.98, 1.02)   # counted training FLOPs / train_bound's products: both
                                   # count matrix products alone (FlopCounterMode counts no
                                   # elementwise op), so a product one of them misses, or
                                   # a recompute it doubles, shows as a step outside 2%
DRYRUN_FLOOR_SLACK = 0.5           # the tick's byte floor may exceed the serve line's bytes
                                   # by the logits and positions, far less than half a layer
                                   # (/ num_layers); one layer's weights uncounted falls below
DRYRUN_PROBE_TOL = 1e-9            # full-depth counts / the probes' extrapolation - 1: every
                                   # layer counts alike, so they agree to rounding
DRYRUN_WORKERS = 8                 # sweep processes (host only: the cells run on meta)


DRYRUN_MESH = "16x16"              # the production mesh of the sweep and the dryrun_mesh lines
DRYRUN_MESH_CELLS = (("cb-paper", "train_4k"), ("cb-paper", "decode_32k"),
                     ("mixtral-8x7b", "train_4k"))


def dryrun_cell(job: tuple[str, str, str]) -> dict:
    """One cell on the named mesh ("1": one rank) in a worker process of its
    own (the fake process group is the process's), with its host seconds."""
    arch, shape, mesh = job
    t0 = time.perf_counter()
    cell = dryrun.run_cell(arch, shape) if mesh == "1" else \
        dryrun._sweep_cell(arch, shape, mesh)
    cell["host_s"] = time.perf_counter() - t0
    return cell


def dryrun_cells(jobs: list) -> dict:
    """``jobs`` (arch, shape, mesh) in ``DRYRUN_WORKERS`` spawned processes, the
    costliest first: {job: cell}. A worker counts cell after cell (each mesh
    cell joins and leaves its own fake process group: ``dryrun.mesh_cell``;
    a fresh process a cell spends more in imports than in counting)."""
    order = {"train": 0, "prefill": 1, "decode": 2}
    jobs = sorted(jobs, key=lambda j: order[SHAPES[j[1]].kind])
    with MP.Pool(min(DRYRUN_WORKERS, len(jobs))) as pool:
        return dict(zip(jobs, pool.map(dryrun_cell, jobs, chunksize=1)))


def shard_state_bytes(cfg, shape) -> dict:
    """Per-device bytes of the cell's state on ``DRYRUN_MESH`` from its sharding
    tree alone (``sanitize_shardings(logical_to_sharding(axes, mesh, rules_for))``
    over ``abstract_init``'s shapes and the decode state's): each leaf's local
    shard size, every split dim divided by its axes' width."""
    dims, names = dryrun.mesh_dims(DRYRUN_MESH)
    mesh = type("Mesh", (), {"mesh_dim_names": names, "shape": dims})()
    rules = rules_for(cfg, shape, mesh)
    width = dict(zip(names, dims))
    model = Model(cfg, "meta")

    def local(tree, axes, itemsize=None):
        total = []

        def leaf(t, sh):
            shp = model_sharding._shape(t)
            n = 1
            for d, ax in zip(shp, tuple(sh.spec) + (None,) * len(shp)):
                w = math.prod(width[a] for a in ((ax,) if isinstance(ax, str) else ax or ()))
                n *= d // w
            first = t
            while isinstance(first, list):
                first = first[0]
            total.append(n * (itemsize or first.element_size()))
            return sh

        model_sharding._map_shardings(leaf, tree, model_sharding.sanitize_shardings(
            tree, model_sharding.logical_to_sharding(axes, mesh, rules), mesh))
        return sum(total)

    tree, axes = model.abstract_init()
    if shape.kind == "train":
        moments = 2 if cfg.param_count() > 100e9 else 4
        return {"params": local(tree, axes), "mu": local(tree, axes, moments),
                "nu": local(tree, axes, moments)}
    out = {"params": local(tree, axes, 2)}                 # served in bfloat16
    if shape.kind == "decode":
        st = model.init_decode_state(shape.global_batch, shape.seq_len)
        out["decode_state"] = local(st, model.decode_state_axes())
    return out


def dryrun_mesh_jobs() -> list:
    return [(a, s, m) for m in (DRYRUN_MESH, "1") for a, s in DRYRUN_MESH_CELLS]


def run_dryrun_mesh(cells: dict | None = None) -> None:
    """``dryrun_mesh``: cb-paper's train_4k and decode_32k and mixtral's
    train_4k (TP-MoE) at ``DRYRUN_MESH`` beside the same cells at one rank
    (``cells`` holds them, from the sweep's processes; counted here if not)."""
    t0 = time.perf_counter()
    if cells is None:
        cells = dryrun_cells(dryrun_mesh_jobs())
    chips = math.prod(dryrun.mesh_dims(DRYRUN_MESH)[0])
    for arch, shape in DRYRUN_MESH_CELLS:
        cell, one = cells[(arch, shape, DRYRUN_MESH)], cells[(arch, shape, "1")]
        if cell["status"] != "ok" or one["status"] != "ok":
            fail(f"dryrun_mesh {arch} {shape}: {cell['status']} {cell.get('error')} / one rank "
                 f"{one['status']} {one.get('error')}")
        cfg = get_config(arch)
        want = shard_state_bytes(cfg, SHAPES[shape])
        if cell["state_bytes_per_device"] != want:
            fail(f"dryrun_mesh {arch} {shape}: state bytes per device "
                 f"{cell['state_bytes_per_device']} against the sharding tree's {want}")
        r = cell["roofline"]
        emit("dryrun_mesh", arch=arch, shape=shape, mesh=DRYRUN_MESH, chips=chips,
             rules=cell["rules"], flops_per_device=cell["flops_per_device"],
             bytes_per_device=cell["bytes_per_device"],
             peak_est_gb=cell["memory"]["peak_memory_in_bytes"] / 1e9,
             fits_80gb=cell["memory"]["peak_memory_in_bytes"] <= 80e9,
             collectives=cell["collectives"], collectives_by_axis=cell["collectives_by_axis"],
             links=cell["links"], compute_s=r["compute_s"], memory_s=r["memory_s"],
             collective_s=r["collective_s"], bottleneck=r["bottleneck"],
             state_bytes_per_device=cell["state_bytes_per_device"],
             state_bytes_from_sharding_tree=want, state_bytes_equal=True,
             one_rank_flops=one["flops_per_device"],
             flops_ratio=chips * cell["flops_per_device"] / one["flops_per_device"],
             replicated_compute=cell["replicated"], host_s=cell["host_s"],
             one_rank_host_s=one["host_s"])
    emit("dryrun_mesh_phase", seconds=time.perf_counter() - t0, cells=len(dryrun_mesh_jobs()))


def run_dryrun(train_line: dict, serve_line: dict) -> None:
    """The dry run of cb-paper's training step and serving tick held against the
    ``train`` and ``serve`` lines, then the whole sweep of cells."""
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN["arch"])
    counters = {k: w.launches for k, w in WRAPPERS.items()}
    rates = dict(peak_flops=dryrun.PEAK_FLOPS, hbm_bytes_per_s=dryrun.HBM_BW,
                 nvlink_bytes_per_s=dryrun.NVLINK_BW,
                 source="NVIDIA H100 80GB HBM3 (SXM, 700 W) data sheet")

    # -- the training step at the train line's shape ------------------------------------
    t0 = time.perf_counter()
    shape = ShapeConfig("train_line", "train", TRAIN["seq_len"], TRAIN["global_batch"])
    counts = dryrun.count_cell(cfg, shape)
    roof = dryrun.analyze(counts, cfg, shape)["roofline"]
    products = train_line["bf16_flops"] + train_line["sparse_flops"]
    flops_ratio = counts["flops"] / products
    peak_est_gb = counts["memory"]["total"] / 1e9
    emit("dryrun train", config=cfg.name, shape=dataclasses.asdict(shape),
         flops_counted=counts["flops"], train_bound_flops=products,
         flops_ratio=flops_ratio, flops_band=DRYRUN_FLOPS_BAND,
         bytes_floor=counts["bytes_floor"], bytes_unfused=counts["bytes_unfused"],
         peak_est_gb=peak_est_gb, peak_mem_gb=train_line["peak_mem_gb"],
         peak_ratio=peak_est_gb / train_line["peak_mem_gb"],
         peak_est_by_kind_gb={k: v / 1e9 for k, v in counts["memory"].items()},
         compute_ms=roof["compute_s"] * 1e3, memory_ms=roof["memory_s"] * 1e3,
         memory_unfused_ms=roof["memory_unfused_s"] * 1e3,
         step_ms=train_line["step_ms"], bound_ms=train_line["bound_ms"], rates=rates,
         seconds=time.perf_counter() - t0)
    lo, hi = DRYRUN_FLOPS_BAND
    if not lo <= flops_ratio <= hi:
        fail(f"dryrun train: counted {counts['flops']:.4e} FLOPs against train_bound's "
             f"{products:.4e} (ratio {flops_ratio:.4f})")

    # -- one serving tick at the serve line's shape, float32 weights --------------------
    t0 = time.perf_counter()
    shape = ShapeConfig("serve_line", "decode", SERVE["max_len"], SERVE["slots"])
    counts = dryrun.count_cell(cfg, shape, serve_dtype=None)
    probed = dryrun.probe_costs(cfg, shape, serve_dtype=None)
    roof = dryrun.analyze(counts, cfg, shape)["roofline"]
    # the floor of a tick: the serve line's tick_bytes (weights, the gathered embedding
    # rows, the KV cache read) plus the new cache the step writes (decode_step copies it)
    floor_expected = serve_line["tick_bytes"] + serve_line["kv_cache_bytes"]
    floor_ratio = counts["bytes_floor"] / floor_expected
    # (the collective bytes are 0 at one rank, in the probes too)
    probe_err = {k: abs(probed[k] - counts[k]) / (abs(counts[k]) or 1.0) for k in dryrun.COUNTS}
    emit("dryrun serve", config=cfg.name, shape=dataclasses.asdict(shape),
         bytes_floor=counts["bytes_floor"], tick_bytes=serve_line["tick_bytes"],
         kv_cache_bytes=serve_line["kv_cache_bytes"], floor_expected=floor_expected,
         floor_ratio=floor_ratio, floor_band=(1.0, 1 + DRYRUN_FLOOR_SLACK / cfg.num_layers),
         bytes_unfused=counts["bytes_unfused"],
         unfused_ratio=counts["bytes_unfused"] / serve_line["tick_bytes"],
         probe_rel_err=probe_err, probe_tol=DRYRUN_PROBE_TOL,
         flops_counted=counts["flops"], peak_est_gb=counts["memory"]["total"] / 1e9,
         compute_ms=roof["compute_s"] * 1e3, memory_ms=roof["memory_s"] * 1e3,
         memory_unfused_ms=roof["memory_unfused_s"] * 1e3,
         device_tick_ms=serve_line["device_tick_ms"], tick_ms=serve_line["tick_ms"],
         seconds=time.perf_counter() - t0)
    if not 1.0 <= floor_ratio <= 1 + DRYRUN_FLOOR_SLACK / cfg.num_layers:
        fail(f"dryrun serve: byte floor {counts['bytes_floor']} against the tick's "
             f"{floor_expected} (ratio {floor_ratio:.6f}): a layer's reads went uncounted "
             "or something beyond the tick was counted")
    if max(probe_err.values()) > DRYRUN_PROBE_TOL:
        fail(f"dryrun serve: the full-depth counts are not the 2- and 4-layer probes "
             f"extrapolated: {probe_err}")
    moved = {k: w.launches - counters[k] for k, w in WRAPPERS.items() if w.launches != counters[k]}
    if moved:
        fail(f"dryrun: the meta steps launched kernels: {moved}")

    # -- the sweep: every cell of the ten archs and cb-paper on the production mesh, and
    #    dryrun_mesh's one-rank cells, in the same processes ------------------------------
    t0 = time.perf_counter()
    jobs = [(a, s, DRYRUN_MESH) for a in (*ARCH_IDS, "cb-paper") for s in SHAPES]
    every = dryrun_cells(jobs + [j for j in dryrun_mesh_jobs() if j[2] == "1"])
    cells = [every[j] for j in jobs]
    sweep_s = time.perf_counter() - t0
    run_dryrun_mesh(every)
    count = collections.Counter(c["status"] for c in cells)
    expected_ok = sum(supports_shape(get_config(a), SHAPES[s])[0] for a, s, _ in jobs)
    failed = [c for c in cells if c["status"] == "FAILED"]
    emit("dryrun_sweep", mesh=DRYRUN_MESH, cells=len(cells), ok=count["ok"],
         skipped=count["skipped"],
         failed=count["FAILED"], expected_ok=expected_ok, workers=DRYRUN_WORKERS,
         seconds=sweep_s,
         slowest=sorted(((c["host_s"], c["arch"], c["shape"]) for c in cells),
                        reverse=True)[:5],
         failures=[(c["arch"], c["shape"], c["error"]) for c in failed],
         phase_s=time.perf_counter() - t_phase)
    if failed or count["ok"] != expected_ok:
        fail(f"dryrun_sweep: {count['ok']} ok (expected {expected_ok}), "
             f"{count['FAILED']} FAILED: {[(c['arch'], c['shape']) for c in failed]}")


# ---------------------------------------------------------------------------
# the families phase: the MoE, SSM, hybrid and encoder-decoder families served
# ---------------------------------------------------------------------------

# (arch, config: "full" or the overrides of a cut, what was cut and why, Model options)
LLAMA4_EXPERT_SHARD = (0, 16)  # the experts one of 16 expert-parallel chips holds: 8 of 128
FAMILIES = (
    ("mamba2-130m", "full", None, {}),
    ("zamba2-2.7b", "full", None, {}),
    ("whisper-small", "full", None, {}),
    ("mixtral-8x7b", {"num_layers": 8},
     {"num_layers": "32 -> 8: 46.7 G parameters are 187 GB of float32 weights; 8 layers "
                    "(11.9 G, 47.5 GB) fit one card's 80 GB beside a layer's bf16 casts"}, {}),
    ("llama4-maverick-400b-a17b", {"num_layers": 2},
     {"num_layers": "48 -> 2: one period of the interleave (moe_every=2), a dense layer "
                    "and an MoE layer with the shared expert",
      "experts_held": "128 -> 8 in the MoE layer: the share of one of 16 expert-parallel "
                      "chips (Model(expert_shard=(0, 16))); the router scores all 128, and "
                      "a token routed to an expert held elsewhere adds nothing here (one "
                      "MoE layer's 128 experts are 64 GB of float32 weights)"},
     {"expert_shard": LLAMA4_EXPERT_SHARD}),
)
FAMILY_LOSS_TOKENS = 512       # mamba2 / zamba2: Model.loss on one sequence at ssm_chunk 128
WHISPER_FRAMES_BATCH = 4       # precompute_cross on seeded frames (4, 1500, 768)
SMOKE_TOL = 2.0**-5            # CUDA vs CPU at the smoke config (bfloat16), relative to the
                               # logits' scale: the bfloat16 bound of the CPU parity tests


def family_config(arch: str, how):
    cfg = get_config(arch)
    return cfg if how == "full" else cfg.scaled(**how)


def two_layers(cfg):
    """The config at full width with 2 layers (hybrid: one Mamba2 pair and the
    shared block after it; encdec: 2 + 2), float32 activations."""
    kw = dict(num_layers=2, dtype="float32")
    if cfg.family == "hybrid":
        kw["attn_every"] = 2
    if cfg.family == "encdec":
        kw["encoder_layers"] = 2
    if cfg.family == "moe" and cfg.moe_every > 1:
        kw["num_layers"] = cfg.moe_every
    return cfg.scaled(**kw)


def family_frames(cfg, batch: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn((batch, cfg.num_frames, cfg.d_model), generator=g,
                       device=DEV).to(cfg.activation_dtype)


def teacher_forced(model, params, toks, frames=None) -> torch.Tensor:
    """Every position's logits through ``decode_step`` (whisper over
    ``precompute_cross`` of ``frames``)."""
    B, S = toks.shape
    st = model.init_decode_state(B, S + 4)
    if frames is not None:
        st["cross"] = encdec.precompute_cross(params, model.cfg, frames)
    out = []
    for t in range(S):
        pos = torch.full((B,), t, dtype=torch.int32, device=toks.device)
        lg, st = model.decode_step(params, st, toks[:, t:t + 1], pos)
        out.append(lg)
    return torch.stack(out, dim=1)


def family_decode_vs_forward(cfg, model_kw: dict, seed: int) -> dict:
    """Teacher-forced decode against forward, float32, 2 layers, full width."""
    cfg2 = two_layers(cfg)
    model = Model(cfg2, **model_kw)
    params = model.init(torch.Generator(device=DEV).manual_seed(seed + 1))
    rng = np.random.default_rng(seed + 43)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)).to(DEV)
    frames = family_frames(cfg2, 2, seed + 2) if cfg.family == "encdec" else None
    kw = {"frames": frames} if frames is not None else {}
    with torch.no_grad():
        full = model.forward(params, toks, **kw).logits
    dec = teacher_forced(model, params, toks, frames)
    excess = ((dec - full).abs() - (DECODE_TOL + DECODE_TOL * full.abs())).max().item()
    if excess > 0 or not torch.isfinite(dec).all():
        fail(f"family {cfg.name}: teacher-forced decode differs from forward beyond "
             f"rtol=atol={DECODE_TOL}")
    return dict(layers=cfg2.num_layers, dtype="float32",
                max_abs_err=(dec - full).abs().max().item(), rtol=DECODE_TOL, atol=DECODE_TOL)


def family_cuda_vs_cpu(arch: str, seed: int) -> dict:
    """One ``forward`` and one ``decode_step`` of the smoke config on the card
    against the port on the CPU, the same weights."""
    cfg = get_smoke_config(arch)
    cpu, card = Model(cfg, "cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(seed))
    p_card = copy.deepcopy(p_cpu).to(DEV)
    rng = np.random.default_rng(seed + 44)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))
    frames = None
    if cfg.family == "encdec":
        frames = torch.from_numpy(rng.standard_normal((2, cfg.num_frames, cfg.d_model))
                                  .astype(np.float32)).to(cfg.activation_dtype)
    out = {}
    for what in ("forward", "decode_step"):
        res = []
        for model, params, dev in ((cpu, p_cpu, "cpu"), (card, p_card, DEV)):
            f = None if frames is None else frames.to(dev)
            t = toks.to(dev)
            with torch.no_grad():
                if what == "forward":
                    kw = {"frames": f} if f is not None else {}
                    lg = model.forward(params, t, **kw).logits
                else:
                    lg = teacher_forced(model, params, t[:, :1], f)
            res.append(lg.float().cpu())
        scale = max(1.0, res[0].abs().max().item())
        err = (res[1] - res[0]).abs().max().item()
        if not err <= SMOKE_TOL * scale:
            fail(f"family {arch}: smoke {what} on CUDA vs CPU differs by {err:.3e} > "
                 f"{SMOKE_TOL} * {scale:.3e}")
        out[what] = dict(max_abs_err=err, tolerance=SMOKE_TOL * scale)
    return out


def family_tick_bytes(cfg, params, state, B: int) -> dict:
    """Bytes one tick must read: every float32 weight the decode path casts or
    reads (of the embedding only the gathered rows; the hybrid's shared block
    once per invocation; not the encoder), and the whole decode state."""
    def nb(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def leaves(node):
        return [x for v in node.values() for x in leaves(v)] if isinstance(node, dict) else [node]

    parts = {"embed_rows": B * cfg.d_model * 4, "state": nb(leaves(state))}
    if cfg.family == "encdec":                  # cross k/v come from the state, not wk / wv
        parts["weights"] = nb(params.decoder.parameters()) + nb(
            [params.final_norm, params.unembed]) - nb(
            [lp["cross"][k] for lp in params.decoder for k in ("wk", "wv")])
    else:
        parts["weights"] = nb(params.parameters()) - params.embed.numel() * 4
    if cfg.family == "hybrid":
        G = cfg.num_layers // cfg.attn_every
        parts["shared_block_rereads"] = (G - 1) * nb(params.shared.parameters())
    return parts


def run_family(arch: str, how, reduced, model_kw: dict, seed: int) -> None:
    t_phase = time.perf_counter()
    cfg = family_config(arch, how)
    decode_check = family_decode_vs_forward(cfg, model_kw, seed)
    torch.cuda.empty_cache()
    smoke_check = family_cuda_vs_cpu(arch, seed)

    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.perf_counter()
    model = Model(cfg, **model_kw)                       # CUDA by default
    params = model.init(gen)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())

    # -- the main path, counted: launch/serve's traffic; no CB kernel may launch -------
    for w in WRAPPERS.values():
        w.launches = 0
    run1 = serve_once(model, params)
    counted = {k: w.launches for k, w in WRAPPERS.items()}
    if any(counted.values()):
        fail(f"family {arch}: CB kernels launched on a path that runs none: {counted}")
    run2 = serve_once(model, params)
    if run2["generated"] != run1["generated"]:
        fail(f"family {arch}: two runs of the same requests generated different tokens")

    # -- one tick from a mid-sequence state: enqueue, and the device in a CUDA graph -----
    B = SERVE["slots"]
    state = model.init_decode_state(B, SERVE["max_len"])
    rng = np.random.default_rng(seed + 41)
    prefill = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)).to(DEV)
    for t in range(prefill.shape[1]):
        _, state = model.decode_step(params, state, prefill[:, t:t + 1],
                                     torch.full((B,), t, dtype=torch.int32, device=DEV))
    tok = prefill[:, -1:]
    pos = torch.full((B,), prefill.shape[1], dtype=torch.int32, device=DEV)

    def one_tick():
        return model.decode_step(params, state, tok, pos)

    enq = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_tick()
        enq.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    device_tick_ms = graph_ms(one_tick)                  # a capture failure ends the run
    logits, _ = one_tick()
    if not (torch.isfinite(logits).all() and logits.shape == (B, cfg.padded_vocab)):
        fail(f"family {arch}: logits {tuple(logits.shape)} or non-finite")

    parts = family_tick_bytes(cfg, params, state, B)
    tick_bytes = sum(parts.values())
    b_ms, b_by = bound(tick_bytes, 2 * B * (parts["weights"] // 4))
    extras = {}
    if cfg.family in ("ssm", "hybrid"):
        # -- C.8 at full width: the loss over one sequence at the real chunk ---------------
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, FAMILY_LOSS_TOKENS + 1))
                                .astype(np.int32)).to(DEV)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        loss_ms = []
        for _ in range(2):                      # the first call, then a warm one
            params.zero_grad(set_to_none=True)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            loss, _ = model.loss(params, batch)
            loss.backward()
            b.record()
            torch.cuda.synchronize()
            loss_ms.append(a.elapsed_time(b))
            bad = [n for n, p in params.named_parameters() if not torch.isfinite(p.grad).all()]
            if bad or not torch.isfinite(loss):
                fail(f"family {arch}: loss {loss.item()} or non-finite gradients: {bad[:5]}")
        extras["loss"] = dict(tokens=FAMILY_LOSS_TOKENS, ssm_chunk=cfg.ssm_chunk,
                              loss=loss.item(), loss_ms=loss_ms[1], loss_ms_first=loss_ms[0],
                              grads_finite=True, remat=cfg.remat)
        params.zero_grad(set_to_none=True)
    if cfg.family == "encdec":
        # -- the encoder at full width, then greedy decode over its cross caches ----------
        frames = family_frames(cfg, WHISPER_FRAMES_BATCH, seed + 3)
        encode_ms = solve_ms(lambda: encdec.precompute_cross(params, cfg, frames))
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (WHISPER_FRAMES_BATCH, 4))
                                   .astype(np.int32)).to(DEV)
        outs = [greedy_decode(model, params, prompts, SERVE["max_new"], frames=frames)
                for _ in range(2)]
        if not torch.equal(outs[0], outs[1]) or outs[0].shape != (WHISPER_FRAMES_BATCH,
                                                                  SERVE["max_new"]):
            fail(f"family {arch}: greedy decode over precompute_cross not bit-equal on rerun")
        extras["encoder"] = dict(frames=list(frames.shape), encode_ms=encode_ms,
                                 greedy_tokens=outs[0][0].tolist())

    tick_med = statistics.median(run2["tick_ms"])
    emit("family", arch=arch, family=cfg.family, config=how if isinstance(how, str) else "cut",
         reduced=reduced, model_options=model_kw, layers=cfg.num_layers, d_model=cfg.d_model,
         activations=cfg.dtype, weights="float32", params=n_params,
         params_gb=n_params * 4 / 1e9, init_s=t_init,
         traffic=dict(SERVE, arch=arch, prompts="np.random.default_rng(0), 2-11 tokens"),
         ticks=run2["engine"].ticks, tokens=run2["tokens"],
         wall_s=[run1["wall_s"], run2["wall_s"]], tokens_per_s=run2["tokens"] / run2["wall_s"],
         tick_ms=tick_med, tick_ms_p90=float(np.percentile(run2["tick_ms"], 90)),
         tick_enqueue_ms=statistics.median(enq), device_tick_ms=device_tick_ms,
         host_share=1 - device_tick_ms / tick_med, bound_ms=b_ms, bound_by=b_by,
         tick_bytes=tick_bytes, tick_bytes_parts=parts, cb_launches=counted,
         runs_bit_equal=True, decode_vs_forward=decode_check, smoke_cuda_vs_cpu=smoke_check,
         **extras, nvidia_smi=smi(), phase_s=time.perf_counter() - t_phase)
    del params, model, state
    torch.cuda.empty_cache()


def run_families(seed: int) -> None:
    t_phase = time.perf_counter()
    for arch, how, reduced, model_kw in FAMILIES:
        run_family(arch, how, reduced, model_kw, seed)
    emit("families_phase", seconds=time.perf_counter() - t_phase, configs=len(FAMILIES))


# ---------------------------------------------------------------------------
# the solve phase: the solvers of repro_torch.solvers on the kernels above
# ---------------------------------------------------------------------------

class LibraryOperator:
    """The yardstick operator: ``torch.sparse`` CSR products in place of the CB
    kernels, duck-typed so the port's solvers run over it unchanged."""

    def __init__(self, rows, cols, vals, shape):
        m, n = shape
        crow = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=m))])
        order = np.lexsort((cols, rows))
        self.A = torch.sparse_csr_tensor(
            torch.from_numpy(crow).to(DEV), torch.from_numpy(cols[order]).to(DEV),
            torch.from_numpy(vals[order].astype(np.float32)).to(DEV), size=shape)
        self.shape, self.device = shape, DEV

    def matvec(self, v, impl=None):
        return self.A @ v

    def matvec_into(self, y, v, impl=None):
        return y.add_(self.A @ v)

    def matmat(self, X, impl=None, group_size=None):
        return self.A @ X


def counted_run(tag, fn, present):
    """``fn()`` with every launch counter and host-sync counter zeroed just
    before and read just after; fails if a kernel in ``present`` (the
    kernels the operator's streams give work) was not launched."""
    for w in WRAPPERS.values():
        w.launches = 0
    solver_loop.HOST_SYNCS.clear()
    out = fn()
    torch.cuda.synchronize()
    counted = {k: w.launches for k, w in WRAPPERS.items()}
    syncs = sum(solver_loop.HOST_SYNCS.values())
    for k in present:
        if counted[k] < 1:
            fail(f"solve {tag}: kernel {k} has work but was not launched")
    return out, counted, syncs


def present_kernels(s) -> list[str]:
    """The kernels one ``cb_spmv`` on stream ``s`` launches."""
    return [k for k, g in (("dense", s.num_dense_groups), ("panel_bitmap", s.num_panel_groups),
                           ("coo", s.num_coo_groups), ("combine", 1)) if g]


def solve_ms(fn) -> float:
    """Device time of one whole solve: CUDA events around it, warm, median of 3."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b))
    return statistics.median(runs)


def graph_ms(fn) -> float:
    """Device time of one ``fn()`` with no host in the way: captured in a CUDA
    graph (after one warm call on a side stream), replayed between CUDA events;
    median of 3."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return solve_ms(graph.replay)


def per_iteration(run_n, capture: bool) -> dict:
    """One loop iteration's host enqueue time and, where the loop can be
    captured, its device time. ``run_n(it)`` runs the solver with
    ``maxiter=it`` and ``tol=0`` (so it does not stop early); runs of 1 and of
    ``SYNC_EVERY`` iterations read no stop flag (GMRES reads after each cycle
    and its SVD waits for the device, so its figure is a cycle's host time,
    waits included), and their difference is ``SYNC_EVERY - 1`` iterations: the host clock
    around each call enqueued directly (median of 3), and the device time of
    each captured in a CUDA graph and replayed (``capture``; a CUDA graph over
    the iteration would run at this time)."""
    n = solver_loop.SYNC_EVERY

    def host_ms(it):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_n(it)
            runs.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(runs)

    if n < 2:
        fail("per_iteration needs SYNC_EVERY >= 2: runs of 1 and SYNC_EVERY iterations")
    return dict(iter_enqueue_ms=(host_ms(n) - host_ms(1)) / (n - 1),
                device_iter_ms=((graph_ms(lambda: run_n(n)) - graph_ms(lambda: run_n(1)))
                                / (n - 1)) if capture else None)


def residual64(A64, x, b) -> float:
    """||b - A x|| / ||b|| in float64 (scipy CSR)."""
    x64 = x.double().cpu().numpy()
    return float(np.linalg.norm(b.astype(np.float64) - A64 @ x64) / np.linalg.norm(b))


def scipy_iters(kind, A64, b, M=None, tol=1e-6, maxiter=500) -> int:
    """scipy's float64 iteration count on the same system and stop rule
    (negative where scipy did not converge within ``maxiter``)."""
    fn = {"cg": scipy.sparse.linalg.cg, "bicgstab": scipy.sparse.linalg.bicgstab}[kind]
    key = "rtol" if "rtol" in inspect.signature(fn).parameters else "tol"
    count = [0]
    _, info = fn(A64, b.astype(np.float64), atol=0.0, maxiter=maxiter, M=M,
                 callback=lambda *_: count.__setitem__(0, count[0] + 1), **{key: tol})
    return count[0] if info == 0 else -count[0]


def emit_solve(run, res_iters, counted, syncs, fn, run_n, capture, lib_fn, lib_iters, spmv,
               extra, solver_launches, launches):
    """Time a solver run and print its ``solve`` line: ``fn`` runs it on the
    port, ``run_n(it)`` with ``maxiter=it`` (see ``per_iteration``), ``lib_fn``
    over the library operator; ``res_iters`` and ``counted`` are the counted
    run's iterations and launches. ``host_share`` is the part of an iteration
    the device is not busy: 1 - device_iter_ms / iter_ms."""
    s_ms = solve_ms(fn)
    lib_ms = solve_ms(lib_fn)
    it = per_iteration(run_n, capture)
    iter_ms = s_ms / max(res_iters, 1)
    line = dict(run=run, iterations=res_iters, solve_ms=s_ms, iter_ms=iter_ms, **it,
                host_share=None if it["device_iter_ms"] is None
                else 1.0 - it["device_iter_ms"] / iter_ms,
                spmv_ms=time_ms(spmv), host_syncs=syncs, sync_every=solver_loop.SYNC_EVERY,
                library_iter_ms=lib_ms / max(lib_iters, 1), library_iterations=lib_iters,
                library="the same solver over torch.sparse CSR A @ x",
                launches=counted,
                launches_per_iteration={k: v / max(res_iters, 1) for k, v in counted.items()})
    line.update(extra)
    emit("solve", **line)
    for k, c in counted.items():
        launches[k] += c
        if c:
            solver_launches.setdefault(k, {})[f"solve {run} (per iteration)"] = \
                c / max(res_iters, 1)


def gershgorin(rows, cols, vals, n) -> tuple[float, float]:
    """The host's Gershgorin interval [min_i a_ii - R_i, max_i a_ii + R_i]."""
    v = vals.astype(np.float64)
    on = rows == cols
    diag = np.bincount(rows[on], weights=v[on], minlength=n)
    radius = np.bincount(rows[~on], weights=np.abs(v[~on]), minlength=n)
    return float((diag - radius).min()), float((diag + radius).max())


def run_solve(seed, launches, solver_launches):
    B = 16
    n = SOLVE["spd"]
    # ---- cg, power, chebyshev: the SPD banded matrix -------------------------------
    t0 = time.perf_counter()
    rows, cols, vals = matrices.spd_banded(n, bandwidth=9, seed=seed + 3)
    vals = vals.astype(np.float32)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    cb = CBMatrix.from_coo(rows, cols, vals, (n, n), block_size=B, val_dtype=np.float32)
    t_cb = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = solvers.CBLinearOperator.from_cb(cb, with_rmatvec=True, with_matmat=True)
    M = solvers.block_jacobi(cb)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    A64 = scipy.sparse.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=(n, n))
    lib = LibraryOperator(rows, cols, vals, (n, n))
    rng = np.random.default_rng(seed + 13)
    b = rng.standard_normal(n).astype(np.float32)
    b_dev = torch.from_numpy(b).to(DEV)
    x_dev = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(DEV)
    spd_present = present_kernels(op.streams)
    cg_kw = dict(tol=1e-6, maxiter=500)

    res, counted, syncs = counted_run("cg", lambda: solvers.cg(op, b_dev, M, **cg_kw),
                                      spd_present)
    iters = int(res.iterations)
    again = solvers.cg(op, b_dev, M, **cg_kw)
    ref = solvers.cg(op, b_dev, M, impl="reference", **cg_kw)
    rel = residual64(A64, res.x, b)
    inv = M.inv_blocks.double().cpu().numpy()
    mb = inv.shape[0]

    def bj64(r):
        rp = np.zeros(mb * B)
        rp[:n] = np.asarray(r).reshape(-1)
        return np.einsum("brc,bc->br", inv, rp.reshape(mb, B)).reshape(-1)[:n]

    scipy_cg = scipy_iters("cg", A64, b, scipy.sparse.linalg.LinearOperator((n, n), matvec=bj64))
    if not bool(res.converged):
        fail(f"solve cg: not converged ({res.reason}) after {iters} iterations")
    if rel > RESIDUAL_TOL:
        fail(f"solve cg: float64 residual {rel:.3e} > {RESIDUAL_TOL}")
    if abs(iters - int(ref.iterations)) > 2:
        fail(f"solve cg: {iters} iterations against impl='reference' {int(ref.iterations)}")
    if not (torch.equal(res.x, again.x) and int(again.iterations) == iters):
        fail("solve cg: two runs are not bit-equal")
    # rmatvec through the transposed streams against scipy's float64 A^T y
    yT = op.rmatvec(x_dev).double().cpu().numpy()
    xr = x_dev.double().cpu().numpy()
    errT = np.abs(yT - A64.T @ xr)
    magT = abs(A64).T @ np.abs(xr)
    rmatvec_rel = float((errT / np.maximum(magT, 1e-30)).max())
    if not (errT <= ORACLE_TOL * magT + 1e-30).all():
        fail(f"solve cg: rmatvec differs from scipy float64 A^T y by {rmatvec_rel:.3e}")
    lib_res = solvers.cg(lib, b_dev, M, **cg_kw)
    emit_solve("cg", iters, counted, syncs,
               lambda: solvers.cg(op, b_dev, M, **cg_kw),
               lambda it: solvers.cg(op, b_dev, M, tol=0.0, maxiter=it), True,
               lambda: solvers.cg(lib, b_dev, M, **cg_kw), int(lib_res.iterations),
               lambda: op.matvec(x_dev),
               dict(matrix=f"spd_banded({n}, bandwidth=9)", nnz=int(op.nnz), block_size=B,
                    group_size=op.group_size, preconditioner="block_jacobi", tol=1e-6,
                    converged=True, status=res.reason, residual_f64_rel=rel,
                    reference_iterations=int(ref.iterations), scipy_f64_iterations=scipy_cg,
                    runs_bit_equal=True, rmatvec_err_vs_f64_rel=rmatvec_rel,
                    host_seconds=dict(generate=t_gen, from_coo=t_cb,
                                      operator_and_preconditioner=t_op)),
               solver_launches, launches)
    del res, again, ref, lib_res

    # the planned solver path: from_cb(plan="auto") times its candidates on the card
    t0 = time.perf_counter()
    pop = solvers.CBLinearOperator.from_cb(cb, plan="auto")
    torch.cuda.synchronize()
    t_plan_op = time.perf_counter() - t0
    del cb
    obs.reset()
    pres, counted, syncs = counted_run("cg planned", lambda: solvers.cg(pop, b_dev, M, **cg_kw),
                                       present_kernels(pop.streams))
    for k, c in counted.items():
        launches[k] += c
    label = pop.plan.structure_hash[:12]           # obs's measured-vs-predicted pair
    exec_line = dict(calls=obs.counter("repro.autotune.exec.calls").value(plan=label), **{
        f"{what}_{kind}": obs.counter(f"repro.autotune.exec.{what}").value(plan=label, kind=kind)
        for what in ("padded_elems", "steps") for kind in ("measured", "predicted")})
    p_rel = residual64(A64, pres.x, b)
    if not bool(pres.converged) or p_rel > RESIDUAL_TOL:
        fail(f"plan cg: converged {bool(pres.converged)} ({pres.reason}), float64 residual "
             f"{p_rel:.3e}")
    if abs(int(pres.iterations) - iters) > 2:
        fail(f"plan cg: {int(pres.iterations)} iterations against the unplanned {iters}")
    if not torch.equal(pres.x, solvers.cg(pop, b_dev, M, **cg_kw).x):
        fail("plan cg: two runs are not bit-equal")
    p_ms = solve_ms(lambda: solvers.cg(pop, b_dev, M, **cg_kw))
    emit("plan", run="cg planned", matrix=f"spd_banded({n}, bandwidth=9)",
         **plan_fields(pop.plan), plan_and_operator_s=t_plan_op,
         iterations=int(pres.iterations), unplanned_iterations=iters, converged=True,
         residual_f64_rel=p_rel, solve_ms=p_ms, iter_ms=p_ms / int(pres.iterations),
         spmv_ms=time_ms(lambda: pop.matvec(x_dev)),
         unplanned_spmv_ms=time_ms(lambda: op.matvec(x_dev)), host_syncs=syncs,
         launches=counted, autotune_exec=exec_line, runs_bit_equal=True)
    del pop, pres

    # power iteration: the dominant eigenpair, held against the reference on the card
    v0 = torch.from_numpy(np.random.default_rng(seed + 17).standard_normal(n)
                          .astype(np.float32)).to(DEV)
    pw, counted, syncs = counted_run("power", lambda: solvers.power_iteration(
        op, v0, maxiter=500), spd_present)
    pw_ref = solvers.power_iteration(op, v0, maxiter=500, impl="reference")
    lam, lam_ref = float(pw.eigenvalue), float(pw_ref.eigenvalue)
    if not (math.isfinite(lam) and abs(lam - lam_ref) <= EIG_TOL * abs(lam_ref)):
        fail(f"solve power: eigenvalue {lam} against impl='reference' {lam_ref}")
    wv = op.matvec(pw.eigenvector) - pw.eigenvalue * pw.eigenvector
    lib_pw = solvers.power_iteration(lib, v0, maxiter=500)
    emit_solve("power", int(pw.iterations), counted, syncs,
               lambda: solvers.power_iteration(op, v0, maxiter=500),
               lambda it: solvers.power_iteration(op, v0, tol=0.0, maxiter=it), True,
               lambda: solvers.power_iteration(lib, v0, maxiter=500), int(lib_pw.iterations),
               lambda: op.matvec(x_dev),
               dict(matrix=f"spd_banded({n}, bandwidth=9)", maxiter=500,
                    converged=bool(pw.converged), eigenvalue=lam, reference_eigenvalue=lam_ref,
                    eigenvalue_rel_diff=abs(lam - lam_ref) / abs(lam_ref),
                    residual_rel=float(torch.linalg.vector_norm(wv)) / abs(lam)),
               solver_launches, launches)
    del pw, pw_ref, lib_pw, wv

    # Chebyshev subspace: 16 columns through matmat, the interval from Gershgorin
    g_lo, g_hi = gershgorin(rows, cols, vals, n)
    lb, ub = g_lo, g_lo + 0.5 * (g_hi - g_lo)
    V0 = torch.from_numpy(np.random.default_rng(seed + 19).standard_normal((n, 16))
                          .astype(np.float32)).to(DEV)
    ch_kw = dict(lb=lb, ub=ub, degree=8, iters=5)
    (vals_c, Q), counted, syncs = counted_run(
        "chebyshev", lambda: solvers.chebyshev_subspace(op, V0, **ch_kw), ["spmm", "combine"])
    vals_r, Q_r = solvers.chebyshev_subspace(op, V0, impl="reference", **ch_kw)
    ritz_diff = float(((vals_c - vals_r).abs() / vals_r.abs()).max())
    if not torch.isfinite(vals_c).all() or ritz_diff > RITZ_TOL:
        fail(f"solve chebyshev: Ritz values differ from impl='reference' by {ritz_diff:.3e}")
    subspace = torch.linalg.svdvals((Q_r.T.double() @ Q.double())).cpu().numpy()
    ritz_res = (torch.linalg.vector_norm(op.matmat(Q) - Q * vals_c, dim=0)
                / vals_c.abs()).cpu().numpy()
    matmats = 8 * 5 + 1

    def chebyshev_enqueue():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solvers.chebyshev_subspace(op, V0, **ch_kw)
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / matmats * 1e3

    c_ms, lib_ms = solve_ms(lambda: solvers.chebyshev_subspace(op, V0, **ch_kw)), \
        solve_ms(lambda: solvers.chebyshev_subspace(lib, V0, **ch_kw))
    emit("solve", run="chebyshev", matrix=f"spd_banded({n}, bandwidth=9)", columns=16,
         degree=8, rounds=5, iterations=matmats, solve_ms=c_ms, iter_ms=c_ms / matmats,
         iter_enqueue_ms=chebyshev_enqueue(), device_iter_ms=None, host_share=None,
         spmv_ms=time_ms(lambda: op.matvec(x_dev)), spmm_ms=time_ms(lambda: op.matmat(V0)),
         qr_ms=time_ms(lambda: torch.linalg.qr(V0), 3), host_syncs=syncs,
         library_iter_ms=lib_ms / matmats, library="the same solver over torch.sparse CSR A @ X",
         launches=counted, launches_per_iteration={k: v / matmats for k, v in counted.items()},
         gershgorin=[g_lo, g_hi], lb=lb, ub=ub, ritz_values=vals_c.tolist(),
         reference_ritz_values=vals_r.tolist(), ritz_rel_diff=ritz_diff,
         ritz_residual_rel=ritz_res.tolist(),
         subspace_singular_values_min=float(subspace.min()), tolerance=RITZ_TOL)
    for k, c in counted.items():
        launches[k] += c
        if c:
            solver_launches.setdefault(k, {})["solve chebyshev (per matmat)"] = c / matmats
    del op, M, lib, A64, Q, Q_r, V0, vals_c, vals_r, b_dev, x_dev, rows, cols, vals
    torch.cuda.empty_cache()

    # ---- bicgstab, gmres, robust: the nonsymmetric banded matrix -------------------------
    n = SOLVE["nonsym"]
    rows, cols, vals = matrices.banded(n, n, bandwidth=7, fill=0.8, seed=seed + 5)
    diag = np.arange(n)
    rows, cols = np.concatenate([rows, diag]), np.concatenate([cols, diag])
    vals = np.concatenate([vals, np.full(n, 8.0)]).astype(np.float32)
    t0 = time.perf_counter()
    cb = CBMatrix.from_coo(rows, cols, vals, (n, n), block_size=B, val_dtype=np.float32)
    op = solvers.CBLinearOperator.from_cb(cb)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    del cb
    A64 = scipy.sparse.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=(n, n))
    lib = LibraryOperator(rows, cols, vals, (n, n))
    rng = np.random.default_rng(seed + 23)
    b = rng.standard_normal(n).astype(np.float32)
    b_dev = torch.from_numpy(b).to(DEV)
    x_dev = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(DEV)
    present = present_kernels(op.streams)
    matrix = f"banded({n}, {n}, bandwidth=7, fill=0.8) + 8 I"
    for name, kw in (("bicgstab", dict(tol=1e-6, maxiter=500)),
                     ("gmres", dict(tol=1e-6, restart=20, maxiter=50))):
        solve = getattr(solvers, name)
        res, counted, syncs = counted_run(name, lambda: solve(op, b_dev, **kw), present)
        rel = residual64(A64, res.x, b)
        if not bool(res.converged) or rel > RESIDUAL_TOL:
            fail(f"solve {name}: converged {bool(res.converged)} ({res.reason}), "
                 f"float64 residual {rel:.3e}")
        ref = solve(op, b_dev, impl="reference", **kw)
        lib_res = solve(lib, b_dev, **kw)
        extra = dict(matrix=matrix, nnz=int(op.nnz), block_size=B, group_size=op.group_size,
                     converged=True, status=res.reason, residual_f64_rel=rel,
                     reference_iterations=int(ref.iterations), host_seconds=dict(
                         from_coo_and_operator=t_op))
        if name == "gmres":
            extra.update(restart=20, iterations_are="restart cycles")
        else:
            extra["scipy_f64_iterations"] = scipy_iters("bicgstab", A64, b)
        emit_solve(name, int(res.iterations), counted, syncs,
                   lambda: solve(op, b_dev, **kw),
                   lambda it: solve(op, b_dev, **dict(kw, tol=0.0, maxiter=it)), name != "gmres",
                   lambda: solve(lib, b_dev, **kw), int(lib_res.iterations),
                   lambda: op.matvec(x_dev), extra, solver_launches, launches)
        del res, ref, lib_res

    obs.reset()
    rob, counted, syncs = counted_run(
        "robust", lambda: solvers.robust_solve(op, b_dev, tol=1e-6, maxiter=500), present)
    rel = residual64(A64, rob.x, b)
    if not rob.converged or rel > RESIDUAL_TOL:
        fail(f"solve robust: converged {rob.converged} ({rob.reason}), float64 residual "
             f"{rel:.3e}, attempts {rob.attempts}")
    # the attempt telemetry: obs's counters against the result's own ladder
    attempts_ctr = obs.counter("repro.solvers.robust.attempts")
    ladder = collections.Counter((a.solver, a.reason) for a in rob.attempts)
    if attempts_ctr.total() != len(rob.attempts) or any(
            attempts_ctr.value(solver=sv, reason=rs) != c for (sv, rs), c in ladder.items()):
        fail(f"solve robust: obs counts {attempts_ctr.total()} attempts "
             f"({obs.snapshot().get('repro.solvers.robust.attempts')}), the result "
             f"{len(rob.attempts)}")
    obs_attempts = attempts_ctr.total()
    spans = obs.tracer().records()
    attempt_wall_s = [dict(solver=r.attrs["solver"], status=r.attrs.get("status"),
                           iterations=r.attrs.get("iterations"), wall_s=r.duration)
                      for r in spans if r.name.startswith("solve:")]
    robust_wall_s = next(r.duration for r in spans if r.name == "robust_solve")
    rob_iters = sum(a.iterations for a in rob.attempts)
    lib_rob = solvers.robust_solve(lib, b_dev, tol=1e-6, maxiter=500)
    win = getattr(solvers, rob.solver)
    emit_solve("robust", rob_iters, counted, syncs,
               lambda: solvers.robust_solve(op, b_dev, tol=1e-6, maxiter=500),
               lambda it: win(op, b_dev, tol=0.0, maxiter=it), False,
               lambda: solvers.robust_solve(lib, b_dev, tol=1e-6, maxiter=500),
               sum(a.iterations for a in lib_rob.attempts), lambda: op.matvec(x_dev),
               dict(matrix=matrix, converged=True, status=rob.reason, solver=rob.solver,
                    residual_f64_rel=rel, iterations_are="summed over the attempts",
                    iter_enqueue_ms_of=f"{rob.solver}, the deciding solver",
                    attempts=[dict(solver=a.solver, status=a.reason, iterations=a.iterations,
                                   residual=a.residual) for a in rob.attempts],
                    obs_attempts=obs_attempts, attempt_wall_s=attempt_wall_s,
                    robust_solve_wall_s=robust_wall_s),
               solver_launches, launches)
    del op, lib, A64, rob, lib_rob, b_dev, x_dev, rows, cols, vals
    torch.cuda.empty_cache()

    # ---- pagerank on the power-law graph, then the same graph with evolving weights -------
    n = SOLVE["graph"]
    src, dst, _ = matrices.power_law(n, n, avg_deg=8, seed=seed + 2)
    t0 = time.perf_counter()
    op, dangling = solvers.pagerank_operator(src, dst, n)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    pr_kw = dict(tol=1e-7, maxiter=200)
    pr, counted, syncs = counted_run("pagerank", lambda: solvers.pagerank(op, dangling, **pr_kw),
                                     present_kernels(op.streams))
    p = pr.eigenvector.double().cpu().numpy()
    key = np.unique(src.astype(np.int64) * n + dst.astype(np.int64))
    s_u, d_u = key // n, key % n
    outdeg = np.bincount(s_u, minlength=n).astype(np.float64)
    P64 = scipy.sparse.csr_matrix((1.0 / outdeg[s_u], (d_u, s_u)), shape=(n, n))
    dmask = outdeg == 0
    x = np.full(n, 1.0 / n)
    for _ in range(1000):                   # scipy float64 damped power iteration
        xn = 0.85 * (P64 @ x + x[dmask].sum() / n) + 0.15 / n
        xn /= xn.sum()
        done = np.abs(xn - x).sum() < 1e-14
        x = xn
        if done:
            break
    l1 = float(np.abs(p - x).sum())
    if not bool(pr.converged) or l1 > PAGERANK_L1 or abs(p.sum() - 1.0) > 1e-5:
        fail(f"solve pagerank: converged {bool(pr.converged)}, L1 to scipy float64 {l1:.3e}, "
             f"sum {p.sum()}")
    lib = LibraryOperator(d_u, s_u, (1.0 / outdeg[s_u]).astype(np.float32), (n, n))
    lib_pr = solvers.pagerank(lib, dangling, **pr_kw)
    x_dev = torch.from_numpy(np.random.default_rng(seed + 29).standard_normal(n)
                             .astype(np.float32)).to(DEV)

    # EvolvingPageRank: one build, three weight steps, each against a fresh build
    t0 = time.perf_counter()
    ev = solvers.EvolvingPageRank.build(src, dst, n)
    torch.cuda.synchronize()
    t_ev = time.perf_counter() - t0
    wrng = np.random.default_rng(seed + 31)
    steps = []
    for _ in range(3):
        w = wrng.uniform(0.1, 2.0, len(src))
        t0 = time.perf_counter()
        canon = ev.canonical_values(w)
        t_canon = time.perf_counter() - t0
        canon_dev = torch.from_numpy(canon).to(DEV)
        step_res = ev.step(w, **pr_kw)
        upd_op = ev.op.with_values(canon_dev)
        # the fresh build of the same weights
        w_u = np.zeros(len(ev.edge_src))
        np.add.at(w_u, ev.edge_map, w)
        outsum = np.zeros(n)
        np.add.at(outsum, ev.edge_src, w_u)
        t0 = time.perf_counter()
        fresh_cb = CBMatrix.from_coo(ev.edge_dst, ev.edge_src,
                                     (w_u / outsum[ev.edge_src]).astype(np.float32), (n, n),
                                     block_size=B, val_dtype=np.float32)
        fresh = solvers.CBLinearOperator.from_cb(fresh_cb)
        torch.cuda.synchronize()
        t_fresh = time.perf_counter() - t0
        same = all(torch.equal(getattr(upd_op.streams, f), getattr(fresh.streams, f))
                   for f in STREAM_FIELDS)
        fresh_res = solvers.pagerank(fresh, ev.dangling, **pr_kw)
        if not same or not torch.equal(step_res.eigenvector, fresh_res.eigenvector):
            fail(f"solve pagerank: evolving step {len(steps)}: streams bit-equal {same}, "
                 f"result bit-equal {torch.equal(step_res.eigenvector, fresh_res.eigenvector)}")
        steps.append(dict(iterations=int(step_res.iterations),
                          update_ms=time_ms(lambda: ev.op.with_values(canon_dev)),
                          canonical_values_s=t_canon, fresh_build_s=t_fresh,
                          streams_bit_equal=True, result_bit_equal=True))
        del upd_op, fresh, fresh_cb, step_res, fresh_res
    emit_solve("pagerank", int(pr.iterations), counted, syncs,
               lambda: solvers.pagerank(op, dangling, **pr_kw),
               lambda it: solvers.pagerank(op, dangling, tol=0.0, maxiter=it), True,
               lambda: solvers.pagerank(lib, dangling, **pr_kw), int(lib_pr.iterations),
               lambda: op.matvec(x_dev),
               dict(matrix=f"power_law({n}, {n}, avg_deg=8) edges, P^T", nnz=int(op.nnz),
                    block_size=B, group_size=op.group_size, tol=1e-7, converged=True,
                    l1_to_scipy_f64=l1, sum=float(p.sum()), tolerance=PAGERANK_L1,
                    host_seconds=dict(pagerank_operator=t_op, evolving_build=t_ev),
                    evolving_steps=steps),
               solver_launches, launches)


# ---------------------------------------------------------------------------
# the examples phase: the port's five examples and two tools, at their own sizes
# ---------------------------------------------------------------------------

EXAMPLE_DIST_REDUCED = ("8 host devices -> 8 gloo ranks sharing cuda:0 (NCCL refuses two ranks "
                        "on one card): the shards' time on one card, not 8 cards'")


def load_example(path: str):
    """An example's or tool's module, loaded from its file under its dotted
    path (``examples_torch.distributed_spmv``), the name by which the ranks
    ``distributed_spmv`` starts import their target."""
    name = path.removesuffix(".py").replace("/", ".")
    spec = importlib.util.spec_from_file_location(
        name, pathlib.Path(__file__).resolve().parent / path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_quickstart(mod, out, per_kernel, counted) -> dict:
    s, x = out["streams"], torch.from_numpy(out["x"]).to(DEV)
    rel = oracle_check("example quickstart", *out["coo"], (out["m"], out["n"]), out["x"],
                       out["y"])
    ref = ops.cb_spmv(s, x, impl="reference")
    ref_err = (out["y"] - ref).abs().max().item()
    if ref_err > KERNEL_TOL * max(1.0, ref.abs().max().item()):
        fail(f"example quickstart: impl='cuda' vs 'reference' differ by {ref_err:.3e}")
    if not torch.equal(mod.main([])["y"], out["y"]):
        fail("example quickstart: a rerun is not bit-equal")
    check_shard_kernels("example quickstart", s, x)
    return dict(stats={k: out["stats"][k] for k in ("num_blocks", "fmt_coo", "fmt_csr",
                                                     "fmt_dense", "tb_load_imbalance")},
                err_vs_oracle=out["err_vs_oracle"], err_vs_oracle_rel=rel,
                err_vs_reference=ref_err, rerun_bit_equal=True)


def example_solve_poisson(mod, out, per_kernel, counted) -> dict:
    op, M, b = out["operator"], out["preconditioner"], out["b"]
    ref = solvers.cg(op, b, M, tol=1e-6, maxiter=500, impl="reference")
    if int(ref.iterations) != out["iterations"] or not out["converged"]:
        fail(f"example solve_poisson: {out['iterations']} iterations (converged "
             f"{out['converged']}), impl='reference' {int(ref.iterations)}")
    rows, cols, vals, shape = mod.poisson_2d(out["g"])
    A64 = scipy.sparse.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=shape)
    res64 = residual64(A64, torch.from_numpy(out["x"]), b.cpu().numpy())
    if res64 > RESIDUAL_TOL:
        fail(f"example solve_poisson: float64 residual {res64:.3e} > {RESIDUAL_TOL}")
    check_shard_kernels("example solve_poisson", op.streams, b)
    return dict(iterations=out["iterations"], reference_iterations=int(ref.iterations),
                residual64=res64, relative_error=out["relative_error"],
                preprocess_s=out["preprocess_s"], solve_ms=out["solve_s"] * 1e3,
                iter_us=out["iter_s"] * 1e6,
                amortization={str(k): v for k, v in out["amortization"].items()})


def example_distributed_spmv(mod, out, per_kernel, counted) -> dict:
    for k, c in out["rank_launches"].items():
        counted[k] += c
    (rows, cols, vals), cb, x_np = mod.build_matrix()
    if out["ranks"] != 8 or not out["one_card"] or not out["ranks_agree"]:
        fail(f"example distributed_spmv: ranks {out['ranks']}, one card {out['one_card']}, "
             f"ranks agree {out['ranks_agree']}")
    if sum(out["device_nnz"]) != cb.nnz or out["load_imbalance"] > 1.01:
        fail(f"example distributed_spmv: nnz per rank {out['device_nnz']}, imbalance "
             f"{out['load_imbalance']}")
    for k in ("panel", "coo", "combine"):
        if format_launches(out["rank_launches"], k) < out["ranks"]:
            fail(f"example distributed_spmv: {k} launched {out['rank_launches'][k]} times "
                 f"over {out['ranks']} ranks")
    rel = oracle_check("example distributed_spmv", rows, cols, vals, cb.shape, x_np,
                       torch.from_numpy(out["y"]))
    sh = shard_streams(cb, out["ranks"])
    check_shard_kernels("example distributed_spmv rank 0", sh.local(0, DEV),
                        torch.from_numpy(x_np).to(DEV))
    return dict(ranks=out["ranks"], backend=out["backend"], one_card=True,
                device_nnz=out["device_nnz"], load_imbalance=out["load_imbalance"],
                err_vs_oracle=out["err_vs_oracle"], err_vs_oracle_rel=rel,
                rank_launches=out["rank_launches"])


def example_serve_decode(mod, out, per_kernel, counted) -> dict:
    if out["served"] != out["requests"]:
        fail(f"example serve_decode: {out['served']} of {out['requests']} requests served")
    if mod.main([])["generated"] != out["generated"]:
        fail("example serve_decode: two runs generated different tokens")
    cfg = mod.build_config()
    model = Model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    per_tick = decode_launches_per_step(model)
    for k in ("spmm", "combine"):
        if counted[k] != per_tick[k] * out["ticks"]:
            fail(f"example serve_decode: {counted[k]} {k} launches in {out['ticks']} ticks, "
                 f"the code's count {per_tick[k]} a tick")
    # the kernels at the decode shape: N = slots, X in the activation dtype
    gen = torch.Generator(device=DEV).manual_seed(1)
    N = out["slots"]
    x = torch.randn((N, cfg.d_model), generator=gen, device=DEV).to(cfg.activation_dtype)
    h = torch.randn((N, cfg.d_ff), generator=gen, device=DEV).to(cfg.activation_dtype)
    for name, inp in (("gate", x), ("down", h)):
        spec = model.specs[name]
        mm = sparse_linear._Matmul(spec, "cuda", None, DEV)
        spmm_rows(f"serve_decode {name}", "example serve_decode tick",
                  params.layers[0].ffn[name].detach(), mm.fwd.route.bcol,
                  ops.x_blocks(inp.T, spec.nb, spec.block_size), mm.fwd.route,
                  spec.out_features, per_tick, per_kernel)
    return dict(served=out["served"], requests=out["requests"], tokens=out["tokens"],
                ticks=out["ticks"], tokens_per_s=out["tokens_per_s"], serve_s=out["serve_s"],
                block_size=cfg.sparse_block, slots=N, activations=cfg.dtype,
                launches_per_tick=per_tick, runs_bit_equal=True)


def example_train_lm(mod, out, per_kernel, counted) -> dict:
    if not out["learning"]:
        fail(f"example train_lm: loss {out['losses']} did not fall")
    cfg = mod.build_config(sparse=True)
    model = Model(cfg)
    per_step = train_launches_per_step(model)
    for k in ("spmm", "combine"):
        if counted[k] != per_step[k] * out["steps"]:
            fail(f"example train_lm: {counted[k]} {k} launches in {out['steps']} steps, the "
                 f"code's count {per_step[k]} a step")
    # the kernels at the training forward's shape: N = batch x seq, X float32
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    gen = torch.Generator(device=DEV).manual_seed(1)
    N = out["batch"] * out["seq"]
    x = torch.randn((N, cfg.d_model), generator=gen, device=DEV).to(cfg.activation_dtype)
    h = torch.randn((N, cfg.d_ff), generator=gen, device=DEV).to(cfg.activation_dtype)
    for name, inp in (("gate", x), ("down", h)):
        spec = model.specs[name]
        mm = sparse_linear._Matmul(spec, "cuda", None, DEV)
        spmm_rows(f"train_lm {name}", "example train_lm step",
                  params.layers[0].ffn[name].detach(), mm.fwd.route.bcol,
                  ops.x_blocks(inp.T, spec.nb, spec.block_size), mm.fwd.route,
                  spec.out_features, per_step, per_kernel)
    return dict(params=out["params"], steps=out["steps"], batch=out["batch"], seq=out["seq"],
                losses=out["losses"], loss_improved=out["loss_improved"], learning=True,
                step_s=statistics.median(h["step_time_s"] for h in out["history"][1:]),
                checkpoint_step=out["checkpoint_step"], block_size=cfg.sparse_block,
                launches_per_step=per_step)


def example_obs_report(mod, out, per_kernel, counted) -> dict:
    names = {ev["name"] for ev in out["trace"]["traceEvents"]}
    solver = out["solve"]["solver"]
    if not {"robust_solve", f"solve:{solver}", "serving.tick"} <= names:
        fail(f"example obs_report: spans {sorted(names)}")
    if not all(ev["ph"] == "X" and ev["dur"] >= 0 for ev in out["trace"]["traceEvents"]):
        fail("example obs_report: a trace event is not a complete span")
    snap = out["snapshot"]
    spmv_calls = {tuple(sorted(s["labels"].items())): s["value"]
                  for s in snap["repro.ops.spmv.calls"]["series"]}
    outcome = snap["repro.solvers.robust.outcome"]["series"]
    completed = snap["repro.serving.completed"]["series"][0]["value"]
    if not spmv_calls.get((("impl", "cuda"),)) or outcome[0]["labels"]["outcome"] != "converged" \
            or completed != 2 or not out["solve"]["converged"]:
        fail(f"example obs_report: spmv calls {spmv_calls}, outcome {outcome}, "
             f"completed {completed}")
    op = out["operator"]
    if op.plan.mode != "timed":
        fail(f"example obs_report: plan='auto' on the card searched in mode {op.plan.mode!r}")
    r, c, v = matrices.spd_banded(96, bandwidth=7, seed=3)
    A64 = scipy.sparse.csr_matrix((v.astype(np.float32).astype(np.float64), (r, c)),
                                  shape=(96, 96))
    b = np.random.default_rng(0).standard_normal(96).astype(np.float32)
    res64 = residual64(A64, out["solve"]["x"], b)
    if res64 > RESIDUAL_TOL:
        fail(f"example obs_report: float64 residual {res64:.3e} > {RESIDUAL_TOL}")
    check_shard_kernels("example obs_report", op.streams, torch.from_numpy(b).to(DEV))
    return dict(spans=sorted(names), events=len(out["trace"]["traceEvents"]), solver=solver,
                attempts=out["solve"]["attempts"], residual64=res64, plan_mode=op.plan.mode,
                plan_block_size=op.plan.block_size, spmv_calls=spmv_calls[(("impl", "cuda"),)],
                ticks=out["health"]["ticks"], completed=completed,
                locality_bytes_moved=out["locality"]["bytes_moved"])


def example_explain(mod, out, per_kernel, counted) -> dict:
    roof = out["roofline"]
    if out["schema"] != "cb-explain/v1" or {"cb", "csr", "bsr", "tile"} - set(out["locality"]):
        fail(f"example explain: schema {out['schema']}, locality {sorted(out['locality'])}")
    if roof["machine_balance"] != F32_FLOPS_PER_S / HBM_BYTES_PER_S or roof["bound"] != "memory":
        fail(f"example explain: machine balance {roof['machine_balance']}, bound {roof['bound']}")
    return dict(matrix=out["matrix"], plan_block_size=out["plan"]["block_size"],
                roofline=roof, decision=len(out["decision"]),
                bytes_moved={k: st["bytes_moved"] for k, st in out["locality"].items()})


def run_examples(per_kernel, launches, example_launches) -> None:
    """Each example's and tool's ``main([])`` in-process on the card: the launch
    counters zeroed before it and read after, its output checked, the kernels
    held against their plain versions at its shapes."""
    t_phase = time.perf_counter()
    for name, path in ENTRY_POINTS.items():
        mod = load_example(path)
        check = globals()[f"example_{name}"]
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            for w in WRAPPERS.values():
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mod.main([])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counted = {k: w.launches for k, w in WRAPPERS.items()}
            fields = check(mod, out, per_kernel, counted)
        for k, c in counted.items():
            launches[k] += c
            if c:
                example_launches.setdefault(k, {})[f"example {name}"] = c
        emit("example", name=name, path=path, argv=[], seconds=seconds, launches=counted,
             reduced=EXAMPLE_DIST_REDUCED if name == "distributed_spmv" else None, **fields)
    emit("examples_phase", seconds=time.perf_counter() - t_phase, scripts=len(ENTRY_POINTS),
         nvidia_smi=smi())


def main() -> None:
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False      # yardsticks in full float32
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    nvcc = subprocess.run([_build._find_nvcc(), "--version"], check=True, capture_output=True,
                          text=True).stdout
    release = next((ln.split("release")[1].strip() for ln in nvcc.splitlines()
                    if "release" in ln), "unknown")
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, nvcc_release=release)

    info = _build.build_info()
    emit("build", seconds=info["seconds"], sources=list(_build.SOURCES),
         rebuilt=bool(info["log"]))
    if info["log"]:     # nvcc's report (registers, shared memory), beside the built library
        (_build.BUILD_DIR / "nvcc.log").write_text(info["log"])

    cases = edge_grid(args.seed)
    emit("edge_grid", cases=cases, tolerance=KERNEL_TOL,
         max_abs_err=dict(worst_err), max_rel_err=dict(worst_rel))
    run_panel_layouts(args.seed)

    per_kernel = {k: [] for k in WRAPPERS}
    launches = {k: 0 for k in WRAPPERS}
    plan_inputs = {}                            # the plan phase's matrices, kept from here
    dist_inputs = {}                            # the dist phase's, host CBMatrix included
    for name, heavy, call, make, shape in make_matrices(args.seed):
        cb, coo, y, spmv_ms = run_matrix(name, heavy, call, make, shape, args.seed,
                                         per_kernel, launches)
        if name == "banded":                    # the solver's multi-RHS product, same matrix
            run_matmat(call, cb, coo, args.seed, per_kernel, launches)
        if name in {n for n, _ in PLAN_RUNS}:
            plan_inputs[name] = (coo, shape, call, spmv_ms)
        if name in DIST_MATRICES:
            dist_inputs[name] = (cb, coo, y, spmv_ms, call)
        del cb, coo, y
        torch.cuda.empty_cache()
    dist_launches = {}                          # kernel -> {dist run: launches, all ranks}
    run_dist(dist_inputs, args.seed, launches, dist_launches)
    del dist_inputs
    torch.cuda.empty_cache()
    run_plan(plan_inputs, args.seed, launches)
    del plan_inputs
    torch.cuda.empty_cache()
    solver_launches = {}                        # kernel -> {solve run: launches per iteration}
    run_solve(args.seed, launches, solver_launches)
    torch.cuda.empty_cache()
    run_mlp_train(args.seed, per_kernel, launches)
    torch.cuda.empty_cache()
    serve_line = run_serve(args.seed, per_kernel, launches)
    torch.cuda.empty_cache()                    # the served model's 14 GB, before training's 56
    train_line = run_train(args.seed, per_kernel, launches)
    torch.cuda.empty_cache()
    mesh_launches = {}                          # kernel -> {mesh run: launches, all ranks}
    run_mesh(args.seed, train_line, per_kernel, launches, mesh_launches)
    torch.cuda.empty_cache()
    run_mesh_families(args.seed, serve_line, per_kernel, launches, mesh_launches)
    torch.cuda.empty_cache()
    run_dryrun(train_line, serve_line)
    run_families(args.seed)
    torch.cuda.empty_cache()
    example_launches = {}                       # kernel -> {example: launches}
    run_examples(per_kernel, launches, example_launches)

    kernels = []
    for k in WRAPPERS:
        if not per_kernel[k] or not (launches[k] or k in REFERENCE_KERNELS):
            fail(f"kernel {k} was never launched on the main path")
        head = max(per_kernel[k], key=lambda r: r["bytes"])   # the matrix that loads it most
        source, replaces = KERNEL_INFO[k]
        kernels.append(dict(
            name=k, route="cuda", source=source, replaces=replaces, launches=launches[k],
            max_abs_err=worst_err[k], max_rel_err=worst_rel[k],
            ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], library=head["library"],
            launches_per_call={r["run"]: r["launches"] for r in per_kernel[k]}
            | solver_launches.get(k, {}) | dist_launches.get(k, {})
            | mesh_launches.get(k, {}) | example_launches.get(k, {}),
            at=head["matrix"], shape=head["shape"],
            per_matrix=per_kernel[k]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
