"""Rule registry: stable ``CBxxx`` codes -> checker callables.

Each rule is registered once at import time (``rules/`` modules run the
decorator) and carries its catalog metadata. Codes are grouped by
invariant family, the reference's blocks where a rule holds for both
packages, and the port's own codes beside the JAX-only ones they replace:

  * ``CB0xx`` — lint hygiene (useless suppressions, parse errors)
  * ``CB1xx`` — boundaries: the kernel's ``ctypes`` only behind its
    wrapper (CB111), no JAX and no reference import (CB112)
  * ``CB2xx`` — no host sync on a launch path (CB211)
  * ``CB3xx`` — lane/sublane alignment (``streams.LANE`` / ``SUBLANE``)
  * ``CB4xx`` — error taxonomy (``repro_torch.errors``)
  * ``CB5xx`` — obs metric naming convention

A checker is ``(FileContext) -> Iterable[Finding]``; the engine invokes
every registered checker on every file and handles suppression /
baseline subtraction itself, so rules stay pure syntax -> findings.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable

from repro_torch import errors

_CODE_RE = re.compile(r"^CB\d{3}$")


@dataclasses.dataclass(frozen=True)
class Rule:
    """Registered rule: stable code, short name, invariant, checker."""

    code: str
    name: str
    invariant: str
    checker: Callable


_RULES: dict[str, Rule] = {}

# Codes that exist but are emitted by the engine itself rather than a
# per-file checker (they still need catalog entries + suppression
# validity).
ENGINE_CODES = ("CB001", "CB002")


def rule(code: str, name: str, invariant: str):
    """Decorator registering ``fn`` as the checker for ``code``."""

    if not _CODE_RE.match(code):
        raise errors.InvalidArgError(f"bad rule code {code!r} (want CBxxx)")

    def register(fn: Callable) -> Callable:
        if code in _RULES:
            raise errors.InvalidArgError(f"duplicate rule code {code}")
        _RULES[code] = Rule(code=code, name=name, invariant=invariant,
                            checker=fn)
        return fn

    return register


def all_rules() -> tuple[Rule, ...]:
    """Every registered rule, sorted by code (deterministic run order)."""
    _ensure_loaded()
    return tuple(_RULES[c] for c in sorted(_RULES))


def known_codes() -> frozenset[str]:
    """Every valid code: checker rules plus the engine-emitted CB0xx."""
    _ensure_loaded()
    return frozenset(_RULES) | frozenset(ENGINE_CODES)


def get(code: str) -> Rule:
    _ensure_loaded()
    return _RULES[code]


def _ensure_loaded() -> None:
    # Import the rule modules lazily so ``registry`` itself never cycles
    # with them (they import ``rule`` from here).
    from repro_torch.analysis import rules  # noqa: F401
