"""cblint for the port — repo-invariant static analysis of ``src/repro_torch``.

The reference's engine (``src/repro/analysis``) re-written into the port,
stdlib ``ast`` only (the optional obs hook uses ``repro_torch.obs``); it
imports nothing of ``repro``. The rules that hold for both packages keep
their codes, and the JAX-only ones give way to the port's counterparts:

  ======  =======================  ==========================================
  code    name                     invariant
  ======  =======================  ==========================================
  CB001   useless-suppression      pragmas must name a rule that fires
  CB002   parse-error              every linted file must parse
  CB111   kernel-library-boundary  ctypes / _build.library() only in
                                   kernels/_build.py and kernels/cb_*.py
                                   (replaces CB101-104, compat-only)
  CB112   port-imports-reference   no jax / jaxlib / flax / optax / repro
                                   import
  CB211   launch-host-sync         no .item() / .tolist() / .cpu() /
                                   float-int-bool of a tensor / synchronize
                                   on a launch path (replaces CB201-203,
                                   trace safety)
  CB301   magic-block-n            block_n spelled via streams.LANE
  CB302   kernel-magic-literal     %128 / %8 arithmetic via LANE/SUBLANE
  CB401   bare-builtin-raise       library raises use repro_torch.errors
  CB501   metric-name              instruments named repro.<subsys>.<name>
  ======  =======================  ==========================================

Entry points: ``python -m repro_torch.analysis`` (CLI, ``__main__.py``),
``tests/test_torch_lint.py`` (pytest gate, ``lint`` marker), and
``lint_paths`` for embedding (``record_lint_health`` publishes a result's
counts onto the obs registry).
"""
from __future__ import annotations

import os

from repro_torch.analysis.baseline import (  # noqa: F401
    load_baseline,
    save_baseline,
    subtract_baseline,
)
from repro_torch.analysis.engine import (  # noqa: F401
    SCHEMA,
    LintResult,
    iter_python_files,
    lint_file,
    lint_paths,
    record_lint_health,
)
from repro_torch.analysis.findings import Finding  # noqa: F401
from repro_torch.analysis.registry import all_rules, known_codes  # noqa: F401

#: The checked-in baseline the port's gate runs against (empty by policy).
DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")
