"""Elastic scaling: re-mesh planning when the device pool changes.

The port of ``repro.runtime.elastic`` (``src/repro/runtime/elastic.py``):
host arithmetic only, unchanged. The port runs on one device, so the plan
is printed and checked but nothing is resharded yet (distribution is
queue A.10).

When hosts fail (or capacity arrives), training resumes on a different
device count. Checkpoints store logical (unsharded) arrays, so elasticity
reduces to: pick a new mesh shape, rebuild the placement from the same
logical-axis rules, place the arrays on restore.

``plan_mesh`` chooses the largest usable (data, model) factorization:
model-parallel width is kept if possible (param layouts stay aligned);
otherwise it steps down through divisors. ``global_batch`` divisibility is
preserved by construction (batch shards over data only).
"""
from __future__ import annotations

import dataclasses

from repro_torch import errors


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    dropped_devices: int

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(
    available_devices: int,
    *,
    prefer_model: int = 16,
    global_batch: int | None = None,
    pod_size: int = 256,
) -> MeshPlan:
    """Largest (data, model) grid with model | prefer_model, data maximal.

    When the pool spans >= 2 full pods, a leading ``pod`` axis is split off
    (pure DP across pods: cross-pod traffic rides the slower links).
    """
    if available_devices < 1:
        raise errors.InvalidArgError("no devices")
    model = prefer_model
    while model > 1 and available_devices % model:
        model //= 2
    data = available_devices // model
    if global_batch is not None:
        while data > 1 and global_batch % data:
            data -= 1
    used = data * model
    if used >= 2 * pod_size and used % pod_size == 0:
        pods = used // pod_size
        d = pod_size // model
        return MeshPlan((pods, d, model), ("pod", "data", "model"),
                        available_devices - used)
    return MeshPlan((data, model), ("data", "model"),
                    available_devices - used)


def reshard_instructions(old_plan: MeshPlan, new_plan: MeshPlan) -> dict:
    """Human/log-readable summary of the elastic transition (the reference's
    text, which names its mechanism)."""
    return {
        "old": {"shape": old_plan.shape, "axes": old_plan.axis_names},
        "new": {"shape": new_plan.shape, "axes": new_plan.axis_names},
        "mechanism": "restore logical arrays; device_put with new NamedShardings",
        "data_replay": "stream indexed by (step, host) — replay from restore step",
    }
