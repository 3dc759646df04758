"""Deterministic fault injection — the test harness for the failure model.

The port of ``repro.runtime.faults`` (``src/repro/runtime/faults.py``):
numpy only and unchanged but for the imports, so the same seed injects the
same fault in both packages.

Every injector is seeded (``np.random.default_rng``) so a fault scenario
replays bit-identically: the same seed corrupts the same bytes, poisons
the same vector entries, and fails the same calls. The acceptance
criterion for the robustness axis is that every injector here is either
*detected with a typed reason* from :mod:`repro_torch.errors` or *tolerated
with a correct result*.

Injectors by layer:

  * :func:`flip_file_bytes`        — artifact byte-flips (npz / plan JSON);
  * :func:`corrupt_packed_values`  — NaN payloads written straight into a
    ``CBMatrix`` packed stream, bypassing the ``from_coo`` policy (what a
    DMA/memory fault looks like);
  * :func:`poison_vector`          — NaN/Inf entries in a solver operand;
  * :class:`FlakyStepFn`           — a callable wrapper that raises
    ``errors.InjectedFault`` on chosen call indices (serving ticks,
    training steps);
  * :func:`lose_host`              — rewind one host's heartbeat so the
    next ``HeartbeatMonitor.check()`` declares it failed.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch import errors


def flip_file_bytes(path, *, n: int = 1, seed: int = 0,
                    start: int = 0, stop: int | None = None):
    """Flip one random bit in each of ``n`` distinct bytes of ``path``.

    ``start``/``stop`` bound the byte range (e.g. to target a JSON value
    region rather than whitespace). Returns ``[(offset, old, new), ...]``
    so a test can assert or undo the damage. In-place, deterministic in
    ``seed``.
    """
    rng = np.random.default_rng(seed)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    stop = len(data) if stop is None else min(stop, len(data))
    if start >= stop:
        raise errors.InvalidArgError(f"empty flip range [{start}, {stop}) for {path}")
    span = stop - start
    offsets = start + rng.choice(span, size=min(n, span), replace=False)
    flips = []
    for off in sorted(int(o) for o in offsets):
        old = data[off]
        new = old ^ (1 << int(rng.integers(8)))
        data[off] = new
        flips.append((off, old, new))
    tmp = f"{path}.flip.tmp"
    with open(tmp, "wb") as f:
        f.write(bytes(data))
    os.replace(tmp, path)
    return flips


def poison_vector(x, *, n: int = 1, seed: int = 0, value=np.nan):
    """Copy of ``x`` with ``n`` random entries overwritten by ``value``."""
    rng = np.random.default_rng(seed)
    out = np.array(x, copy=True)
    flat = out.reshape(-1)
    idx = rng.choice(flat.size, size=min(n, flat.size), replace=False)
    flat[idx] = value
    return out


def corrupt_packed_values(cb, *, n: int = 1, seed: int = 0, value=np.nan):
    """A copy of ``cb`` with ``n`` packed values overwritten by ``value``.

    Writes the raw bytes straight into the packed stream via the value
    layout — deliberately *bypassing* the ``update_values`` non-finite
    policy, the way a memory/DMA fault would. The structure metadata is
    untouched, so ``validate()`` passes but ``validate(check_finite=True)``
    and any SpMV/solve over the matrix see the poison.
    """
    rng = np.random.default_rng(seed)
    layout = cb.value_layout()
    if layout.count == 0:
        raise errors.InvalidArgError("matrix has no stored values to corrupt")
    vsize = cb.val_dtype.itemsize
    idx = rng.choice(layout.count, size=min(n, layout.count), replace=False)
    pos = layout.byte_pos[np.sort(idx)]
    packed = cb.packed.copy()
    bad = np.full(len(pos), value, cb.val_dtype).view(np.uint8)
    packed[pos[:, None] + np.arange(vsize, dtype=np.int64)] = (
        bad.reshape(len(pos), vsize))
    new = dataclasses.replace(cb, packed=packed)
    new._value_layout_cache = layout
    return new


class FlakyStepFn:
    """Wrap a callable; raise ``errors.InjectedFault`` on chosen calls.

    ``fail_on`` is a collection of 0-based call indices. Calls are
    counted across successes *and* failures, so ``fail_on={0, 1}`` means
    "the first two attempts fail, the third succeeds" — exactly the
    shape a bounded-retry loop must absorb.
    """

    def __init__(self, fn, *, fail_on=(0,)):
        self.fn = fn
        self.fail_on = frozenset(int(i) for i in fail_on)
        self.calls = 0
        self.failures = 0

    def __call__(self, *args, **kwargs):
        i = self.calls
        self.calls += 1
        if i in self.fail_on:
            self.failures += 1
            raise errors.InjectedFault(errors.reason(
                errors.INJECTED, f"injected failure on call {i}"))
        return self.fn(*args, **kwargs)


def lose_host(monitor, host_id: int = 0) -> None:
    """Silence one host: rewind its heartbeat past the monitor timeout.

    The next ``monitor.check()`` declares the host failed — without
    having to fast-forward the (possibly shared) injectable clock.
    """
    st = monitor.hosts[host_id]
    st.last_beat = monitor.clock() - monitor.timeout_s - 1.0
