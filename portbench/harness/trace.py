"""The profiler's sub-window: record it, then reduce its Chrome trace.

The traced run profiles a steady stretch of the window with
``torch.profiler`` (CPU ops and CUDA activity), exports the Chrome trace
to ``portbench/out/<cell>.trace.json`` and reduces it here: the device
operations inside the sub-window, the union of their intervals (busy
time), the idle gaps between them, each labelled by the innermost host
operation running at its middle.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import re

import numpy as np
import torch

SUBWINDOW = "portbench.subwindow"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclasses.dataclass
class Trace:
    """The sub-window's device operations (microseconds on the trace's clock)."""

    start_us: float
    window_us: float
    units: int                  # units (calls) completed inside the sub-window
    ops: list                   # (name, kind, start_us, dur_us), clipped to the window
    host: list                  # (name, start_us, dur_us) host events on the launching thread

    @property
    def busy_us(self) -> float:
        return union_us([(s, d) for _, _, s, d in self.ops])

    def kernels(self, pattern: str | None = None) -> list:
        rx = re.compile(pattern) if pattern else None
        return [o for o in self.ops if o[1] == "kernel" and (rx is None or rx.search(o[0]))]

    def idle_gaps(self) -> list:
        """(start_us, dur_us) of every stretch of the sub-window with no device op."""
        iv = sorted((s, s + d) for _, _, s, d in self.ops)
        gaps, t = [], self.start_us
        for s, e in iv:
            if s > t:
                gaps.append((t, s - t))
            t = max(t, e)
        end = self.start_us + self.window_us
        if end > t:
            gaps.append((t, end - t))
        return gaps


def union_us(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, d in sorted(intervals):
        e = s + d
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and template arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:120] or name[:120]


def activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def reduce(path: pathlib.Path, units: int) -> Trace | None:
    """Read an exported Chrome trace; None when it holds no sub-window span."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    span = next((e for e in events if e.get("name") == SUBWINDOW
                 and e.get("cat") == "user_annotation" and e.get("ph") == "X"), None)
    if span is None:
        return None
    w0, w1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    tid = span.get("tid")
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            cs, ce = max(s, w0), min(s + d, w1)
            if ce > cs:
                ops.append((e.get("name", "?"), cat, cs, ce - cs))
        elif cat in HOST_CATS and e.get("tid") == tid and e is not span:
            if s + d >= w0 and s <= w1:
                host.append((e.get("name", "?"), s, d))
    return Trace(start_us=w0, window_us=w1 - w0, units=units, ops=ops, host=host)


def breakdown(tr: Trace, top: int = 10, gaps_considered: int = 5000) -> dict:
    """The device ops that took most time, and idle time by host activity."""
    by_op = collections.Counter()
    for name, _, _, d in tr.ops:
        by_op[short_name(name)] += d * 1e-6
    gaps = sorted(tr.idle_gaps(), key=lambda g: -g[1])[:gaps_considered]
    by_host = collections.Counter()
    if tr.host:
        hs = np.array([h[1] for h in tr.host])
        he = hs + np.array([h[2] for h in tr.host])
        hd = np.array([h[2] for h in tr.host])
        for g0, gd in gaps:
            mid = g0 + gd / 2
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            label = ("host outside any op" if inside.size == 0
                     else tr.host[int(inside[np.argmin(hd[inside])])][0])
            by_host[label] += gd * 1e-6
    else:
        for _, gd in gaps:
            by_host["host outside any op"] += gd * 1e-6
    return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v] for k, v in by_host.most_common(top)]}
