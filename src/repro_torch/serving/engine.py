"""Continuous-batching serving engine (slot-based, vLLM-style scheduling
at toy scale), the port of ``repro.serving.engine``.

A fixed number of batch slots share one decode cache. Each engine tick
runs ONE decode_step for the whole batch; finished/empty slots are
refilled from the request queue by resetting that slot's cache position
(per-slot ``pos`` makes mixed-depth batches correct: attention masks by
``kv_valid_len``). This is the serving shape the paper's SpMV targets:
weight-bound batched matvec at small per-step batch (on the card the
sparse MLP's products run ``csrc/cb_spmm.cu`` with N = slots).

Degradation model, as in the reference:

  * **backpressure**: ``submit`` rejects with the typed status
    ``errors.QUEUE_FULL`` once the queue holds ``max_queue`` requests;
  * **deadlines**: a request with ``deadline_ticks`` set is expired
    (status ``errors.DEADLINE_EXCEEDED``, slot freed) when that many
    ticks pass after submission without completion;
  * **tick retry**: a failing decode step is retried up to
    ``max_step_retries`` times with ``retry_backoff_s`` backoff. The step
    never writes the state it is given (``self.state`` / ``self.pos`` are
    only assigned on success), so a retried tick is bit-identical to a
    never-failed one. Exhaustion raises ``errors.TickError``;
  * **health**: :meth:`health` snapshots the counters.

Telemetry: every degradation counter also lands on ``repro_torch.obs``
under the reference's names (``repro.serving.*``, labeled per engine),
each tick runs under an ``obs.span("serving.tick")``, and tick latency /
queue depth feed histograms surfaced through :meth:`health`.

A model on a mesh (``Model(cfg, mesh=)``) is served the same way, every
rank running the same ticks: the decode state is ``DTensor``s, a slot's
reset zeroes it on the rank that holds it, and each tick's logits are
gathered whole before the argmax.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from repro_torch import errors, obs
from repro_torch.models.model import Model
from repro_torch.models.sharding import full_tensor, local_index

from .decode import build_decode_fn

# Distinguishes concurrent engines' series on the process-wide registry.
_ENGINE_IDS = itertools.count()


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # degradation bookkeeping
    deadline_ticks: Optional[int] = None   # None = no deadline
    status: str = errors.ACCEPTED
    submitted_tick: Optional[int] = None


class ServingEngine:
    def __init__(self, model: Model, params, *, slots: int = 8,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 max_step_retries: int = 0,
                 retry_backoff_s: float = 0.0,
                 sleep=time.sleep):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.max_queue = max_queue
        self.max_step_retries = max_step_retries
        self.retry_backoff_s = retry_backoff_s
        self._sleep = sleep
        self.queue: deque[Request] = deque()
        self.active: list[Optional[Request]] = [None] * slots
        self._remaining_prompt: list[np.ndarray] = [np.zeros(0, np.int32)] * slots
        self.state = model.init_decode_state(slots, max_len)
        self.pos = torch.zeros((slots,), dtype=torch.int32, device=model.device)
        self.next_token = np.zeros((slots,), np.int32)
        self.step_fn = build_decode_fn(model)
        self.ticks = 0
        self.completed = 0
        self.rejected = 0
        self.retries = 0
        self.deadline_expired = 0
        self.backoff_total_s = 0.0
        self.expired: list[Request] = []
        self.last_error: Optional[str] = None
        self._obs_labels = {"engine": str(next(_ENGINE_IDS))}

    def _count(self, metric: str, value: int = 1) -> None:
        obs.counter(f"repro.serving.{metric}").inc(value, **self._obs_labels)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> str:
        """Enqueue a request; returns its typed admission status.

        ``errors.ACCEPTED`` on success, ``errors.QUEUE_FULL`` when the
        bounded queue is at capacity (the request is *not* enqueued).
        """
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.status = errors.QUEUE_FULL
            self.rejected += 1
            self._count("rejected")
            return req.status
        req.status = errors.ACCEPTED
        req.submitted_tick = self.ticks
        self.queue.append(req)
        return req.status

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self.active[s] = req
                self._remaining_prompt[s] = np.asarray(req.prompt, np.int32)
                self.pos[s] = 0
                self._reset_slot_cache(s)

    def _reset_slot_cache(self, s: int) -> None:
        # state leaves, at any depth of the state's dicts (hybrid: ssm / attn,
        # encdec: self / cross), are (L, B, ...) or (B, ...); zero batch index
        # s. In place: the engine owns these tensors (each came back from a
        # step, which never writes its input), so no step sees the change midway.
        def zero_slot(node):
            if isinstance(node, dict):
                for child in node.values():
                    zero_slot(child)
                return
            dim = 1 if node.ndim >= 2 and node.shape[1] == self.slots else 0
            if node.shape[dim] != self.slots:
                return
            at = local_index(node, dim, s)         # on a mesh: where this rank holds it
            if at is not None:
                local = node.to_local() if isinstance(node, DTensor) else node
                local.select(dim, at).zero_()

        zero_slot(self.state)

    # ------------------------------------------------------------------
    def _expire(self, req: Request) -> None:
        req.status = errors.DEADLINE_EXCEEDED
        self.deadline_expired += 1
        self._count("deadline_expired")
        self.expired.append(req)

    def _expire_deadlines(self) -> None:
        """Drop queued/active requests whose deadline has passed."""
        def overdue(req: Request) -> bool:
            return (req.deadline_ticks is not None
                    and req.submitted_tick is not None
                    and self.ticks - req.submitted_tick >= req.deadline_ticks)

        if any(overdue(r) for r in self.queue):
            keep = deque()
            for req in self.queue:
                self._expire(req) if overdue(req) else keep.append(req)
            self.queue = keep
        for s, req in enumerate(self.active):
            if req is not None and overdue(req):
                self._expire(req)
                self.active[s] = None

    def _step_with_retry(self, tokens: np.ndarray):
        """Run the decode step, retrying injected/transient failures.

        The step is functional (``self.state`` / ``self.pos`` are only
        assigned by the caller on success), so a retry re-runs the exact
        same computation and the surviving tick is bit-identical to one
        that never failed. Raises ``errors.TickError`` when
        ``max_step_retries`` is exhausted.
        """
        tok = torch.from_numpy(tokens).to(self.pos.device)[:, None]
        attempts = self.max_step_retries + 1
        for attempt in range(attempts):
            try:
                return self.step_fn(self.params, self.state, tok, self.pos)
            except Exception as e:  # noqa: BLE001 — injected faults are RuntimeErrors
                self.last_error = f"{type(e).__name__}: {e}"
                if attempt + 1 >= attempts:
                    raise errors.TickError(errors.reason(
                        errors.TICK_FAILED,
                        f"decode step failed {attempts} time(s); "
                        f"last: {self.last_error}",
                    )) from e
                self.retries += 1
                self._count("retries")
                if self.retry_backoff_s:
                    delay = self.retry_backoff_s * (2 ** attempt)
                    self.backoff_total_s += delay
                    self._sleep(delay)

    # ------------------------------------------------------------------
    def tick(self) -> list[Request]:
        """One decode step for the whole batch. Returns finished requests."""
        if not obs.is_enabled():
            return self._tick()
        with obs.span("serving.tick", tick=self.ticks,
                      queue_depth=len(self.queue)) as sp:
            t0 = obs.now()
            finished = self._tick()
            obs.histogram("repro.serving.tick_latency_s").observe(
                obs.now() - t0, **self._obs_labels)
            obs.histogram("repro.serving.queue_depth").observe(
                len(self.queue), **self._obs_labels)
            self._count("ticks")
            if finished:
                self._count("completed", len(finished))
            sp.set(finished=len(finished))
        return finished

    def _tick(self) -> list[Request]:
        self._expire_deadlines()
        self._admit()
        tokens = np.zeros((self.slots,), np.int32)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            if len(self._remaining_prompt[s]):
                tokens[s] = self._remaining_prompt[s][0]
            else:
                tokens[s] = self.next_token[s]

        logits, self.state = self._step_with_retry(tokens)
        logits = full_tensor(logits)                # whole on every rank of a mesh
        self.pos = self.pos + 1
        picked = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()  # cblint: disable=CB211

        finished = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            if len(self._remaining_prompt[s]):
                self._remaining_prompt[s] = self._remaining_prompt[s][1:]
                if len(self._remaining_prompt[s]) == 0:
                    self.next_token[s] = picked[s]   # first generated token
                continue
            req.generated.append(int(self.next_token[s]))
            self.next_token[s] = picked[s]
            hit_eos = self.eos_id is not None and req.generated[-1] == self.eos_id
            if len(req.generated) >= req.max_new_tokens or hit_eos:
                req.done = True
                finished.append(req)
                self.completed += 1
                self.active[s] = None
        self.ticks += 1
        return finished

    def run_until_done(self, max_ticks: int = 10_000) -> list[Request]:
        done: list[Request] = []
        while (self.queue or any(self.active)) and self.ticks < max_ticks:
            done.extend(self.tick())
        return done

    # ------------------------------------------------------------------
    def health(self) -> dict:
        """Counter snapshot for supervisors (cheap, host-only).

        Totals are cumulative over the engine's lifetime; ``tick_latency_s``
        / ``queue_depth_hist`` are histogram summaries (count/sum/min/max/
        p50/p99 from the obs registry), whose counts stay 0 while obs is
        disabled.
        """
        lat = obs.histogram("repro.serving.tick_latency_s").summary(**self._obs_labels)
        depth = obs.histogram("repro.serving.queue_depth").summary(**self._obs_labels)
        return {
            "ticks": self.ticks,
            "queue_depth": len(self.queue),
            "active_slots": sum(r is not None for r in self.active),
            "completed": self.completed,
            "rejected": self.rejected,
            "retries": self.retries,
            "backoff_total_s": self.backoff_total_s,
            "deadline_expired": self.deadline_expired,
            "deadline_miss_count": self.deadline_expired,
            "tick_latency_s": lat,
            "queue_depth_hist": depth,
            "last_error": self.last_error,
        }
