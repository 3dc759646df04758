"""GPipe-style pipeline parallelism over the ``pod`` mesh axis.

The port of ``repro.runtime.pipeline``. For cross-pod scaling where the
inter-pod links are too slow for FSDP-style weight gathering, the pod axis
can instead carry *pipeline stages*: each pod owns a contiguous slice of
layers; microbatches stream through stages with point-to-point hand-offs
(one activation tensor per microbatch per boundary).

Every rank of the axis runs the same schedule of ``T = M + S - 1`` ticks:

    for t in 0 .. (M + S - 2):
        h_in  = receive from stage s-1 (ring), send h_out to stage s+1
        h_out = stage_fn(local_params, microbatch t on stage 0, else h_in)

The reference's ring ``ppermute`` becomes one ``batch_isend_irecv`` a tick
(a send to ``(s+1) % S`` and a receive from ``(s-1) % S`` posted together:
blocking ``send``/``recv`` on a ring deadlocks). The last stage commits its
output for microbatch ``t - (S-1)``; a final ``all_reduce`` of the masked
outputs hands them to every stage. Bubble fraction is the usual
(S-1)/(M+S-1); the launcher picks M >= 4*S.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _stage_slice(tree, s: int):
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_slice(v, s) for v in tree)
    return tree[s]


def pipeline_forward(
    stage_fn: Callable,            # (stage_params, h) -> h
    mesh,
    axis: str = "pod",
):
    """Builds ``run(stacked_stage_params, microbatches) -> outputs``.

    stacked_stage_params: tensors (or a dict / list of them) of leading
    size S — stage s uses slice s, s = ``mesh.get_local_rank(axis)``.
    microbatches: (M, mb, ...) input activations (already embedded), the
    same on every rank of the axis.
    outputs: (M, mb, ...) activations out of the last stage, on every rank.
    """
    S = mesh.size(tuple(mesh.mesh_dim_names).index(axis))
    group = mesh.get_group(axis)

    def run(stage_params, mbs: torch.Tensor) -> torch.Tensor:
        stage = mesh.get_local_rank(axis)
        local_params = _stage_slice(stage_params, stage)
        M = mbs.shape[0]
        nxt = dist.get_global_rank(group, (stage + 1) % S)
        prv = dist.get_global_rank(group, (stage - 1) % S)
        h_out = torch.zeros_like(mbs[0])
        outputs = torch.zeros_like(mbs)
        for t in range(M + S - 1):
            # receive the boundary activation from the previous stage
            if S > 1:
                h_recv = torch.empty_like(h_out)
                for req in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, h_out.contiguous(), nxt, group),
                        dist.P2POp(dist.irecv, h_recv, prv, group)]):
                    req.wait()
            else:
                h_recv = h_out
            # stage 0 feeds fresh microbatches while they last
            h_in = mbs[min(t, M - 1)] if stage == 0 else h_recv
            h_out = stage_fn(local_params, h_in)
            # the last stage commits its result for microbatch t - (S-1)
            if stage == S - 1 and t >= S - 1:
                outputs[t - (S - 1)] = h_out
        # every stage computed an ``outputs``; only the last stage's is real
        if stage != S - 1:
            outputs.zero_()
        dist.all_reduce(outputs, group=group)
        return outputs

    return run


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
