"""Fault tolerance: heartbeats, failure detection, restart policy,
straggler bookkeeping.

The port of ``repro.runtime.fault_tolerance``
(``src/repro/runtime/fault_tolerance.py``): host code, unchanged but for the
imports. ``run_supervised`` drives the port's ``checkpoint.Checkpointer``.

At 1000+ nodes, *something* is always failing; the design is
checkpoint/restart with deterministic replay:

  * every host pushes a heartbeat per step into ``HeartbeatMonitor``;
  * the controller (or an external watchdog) calls ``check()``; a host
    whose last beat is older than ``timeout_s`` is declared failed;
  * ``RestartPolicy`` answers "restore from step X, replay data from X" —
    correct because the data stream is indexed by (step, host)
    (data/synthetic.py) and checkpoints are atomic (checkpoint/).

Stragglers: per-step durations feed an EWMA; a step slower than
``straggler_factor`` x EWMA is recorded. The mitigation at mesh scale is
re-balancing (core/balance device assignment) or evicting the slow host
(elastic.py re-mesh) — both decisions are surfaced, not hidden.

Everything takes an injectable ``clock`` so failure scenarios unit-test
with simulated time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch import errors


@dataclasses.dataclass
class HostStatus:
    host_id: int
    last_beat: float
    last_step: int
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, num_hosts: int = 1, timeout_s: float = 60.0,
                 straggler_factor: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.clock = clock
        now = clock()
        self.hosts = {
            h: HostStatus(host_id=h, last_beat=now, last_step=-1)
            for h in range(num_hosts)
        }
        self.step_ewma: float | None = None
        self.stragglers: list[tuple[int, float]] = []   # (step, duration)
        self._last_step_t: float | None = None

    # -- heartbeats ------------------------------------------------------
    def heartbeat(self, step: int, host_id: int = 0) -> None:
        now = self.clock()
        st = self.hosts[host_id]
        st.last_beat = now
        st.last_step = step
        st.alive = True
        if self._last_step_t is not None:
            dur = now - self._last_step_t
            self.step_ewma = (
                dur if self.step_ewma is None
                else 0.9 * self.step_ewma + 0.1 * dur
            )
            if (
                self.step_ewma is not None
                and dur > self.straggler_factor * self.step_ewma
                and dur > 0
            ):
                self.stragglers.append((step, dur))
        self._last_step_t = now

    def report_straggler(self, step: int, duration_s: float) -> None:
        self.stragglers.append((step, duration_s))

    # -- failure detection --------------------------------------------------
    def check(self) -> list[int]:
        """Returns host ids newly declared failed."""
        now = self.clock()
        failed = []
        for st in self.hosts.values():
            if st.alive and (now - st.last_beat) > self.timeout_s:
                st.alive = False
                failed.append(st.host_id)
        return failed

    @property
    def alive_hosts(self) -> list[int]:
        return [h for h, st in self.hosts.items() if st.alive]


@dataclasses.dataclass
class RestartDecision:
    restore_step: int
    replay_from_step: int
    surviving_hosts: list[int]
    needs_remesh: bool


class RestartPolicy:
    """checkpoint/restart with deterministic replay (single source of truth).

    ``max_restarts`` bounds the budget: once that many ``on_failure``
    decisions have been handed out, further failures raise
    ``errors.RestartBudgetError`` — a crash-looping job must surface to
    the operator rather than burn the fleet replaying forever.
    """

    def __init__(self, checkpointer, monitor: HeartbeatMonitor,
                 *, max_restarts: int | None = None):
        self.checkpointer = checkpointer
        self.monitor = monitor
        self.max_restarts = max_restarts
        self.restarts = 0

    def on_failure(self) -> RestartDecision:
        if self.max_restarts is not None and self.restarts >= self.max_restarts:
            raise errors.RestartBudgetError(errors.reason(
                errors.RESTART_BUDGET_EXHAUSTED,
                f"restart budget of {self.max_restarts} exhausted",
            ))
        self.restarts += 1
        step = self.checkpointer.latest_step() or 0
        surviving = self.monitor.alive_hosts
        return RestartDecision(
            restore_step=step,
            replay_from_step=step,
            surviving_hosts=surviving,
            needs_remesh=len(surviving) < len(self.monitor.hosts),
        )


def run_supervised(step_fn, init_state, *, num_steps: int,
                   checkpointer, policy: RestartPolicy,
                   checkpoint_every: int = 1, host_id: int = 0):
    """Run ``num_steps`` of ``step_fn`` under checkpoint/restart supervision.

    ``step_fn(state, step) -> state`` must be deterministic in its
    arguments — that is the replay contract: after a failure the loop
    restores the newest checkpoint and re-executes from its step, so the
    final state is bit-identical to a fault-free run. The checkpoint at
    step ``s`` holds the state *before* executing step ``s`` (step 0 is
    persisted up front so even a first-step failure has a restore
    point). Each successful step heartbeats ``policy.monitor``; each
    failure consumes one unit of the policy's restart budget
    (``errors.RestartBudgetError`` propagates when it runs out).
    """
    checkpointer.save(init_state, 0)
    checkpointer.wait()
    state = init_state
    step = 0
    while step < num_steps:
        try:
            state = step_fn(state, step)
        except errors.RestartBudgetError:
            raise
        except Exception:
            decision = policy.on_failure()   # raises when budget exhausted
            checkpointer.wait()
            state = checkpointer.restore(init_state, step=decision.restore_step)
            step = decision.replay_from_step
            continue
        policy.monitor.heartbeat(step, host_id)
        step += 1
        if step % checkpoint_every == 0 and step < num_steps:
            checkpointer.save(state, step)
    checkpointer.wait()
    return state
