"""Rule modules — importing this package registers every checker.

One module per invariant family; the code blocks are listed in
``registry.py``'s docstring and the catalog in ``analysis/__init__.py``.
"""
from repro_torch.analysis.rules import (  # noqa: F401
    align,
    boundaries,
    errtax,
    host_sync,
    metric_names,
)
