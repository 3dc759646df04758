"""Runtime: elastic re-mesh planning, fault tolerance, fault injection and
GPipe stages over a mesh axis; the port of ``repro.runtime``."""
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
from .pipeline import bubble_fraction, pipeline_forward  # noqa: F401
