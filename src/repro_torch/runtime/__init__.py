"""Runtime: elastic re-mesh planning, fault tolerance and fault injection.

The port of ``repro.runtime`` but ``pipeline`` (GPipe over a ``shard_map``
stage axis), which waits for distribution (queue A.10).
"""
from .elastic import MeshPlan, plan_mesh, reshard_instructions  # noqa: F401
from .fault_tolerance import (  # noqa: F401
    HeartbeatMonitor,
    RestartDecision,
    RestartPolicy,
    run_supervised,
)
from .faults import (  # noqa: F401
    FlakyStepFn,
    corrupt_packed_values,
    flip_file_bytes,
    lose_host,
    poison_vector,
)
