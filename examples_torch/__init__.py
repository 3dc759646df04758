"""The port's examples, beside the JAX repo's ``examples/``.

``ENTRY_POINTS`` names the port's user-facing entry points, its five examples
and its two observability tools, each by its path from the repo root. Each
file runs as a script and has ``main(argv=None) -> dict``.
"""

ENTRY_POINTS = {"quickstart": "examples_torch/quickstart.py",
                "solve_poisson": "examples_torch/solve_poisson.py",
                "distributed_spmv": "examples_torch/distributed_spmv.py",
                "serve_decode": "examples_torch/serve_decode.py",
                "train_lm": "examples_torch/train_lm.py",
                "obs_report": "scripts/obs_report_torch.py",
                "explain": "scripts/explain_torch.py"}
