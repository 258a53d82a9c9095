"""The traced run's device timeline: ``torch.profiler`` over a stated
stretch of the window, its Chrome trace read back into device intervals
(kernels, copies, sets), the benchmark's host spans (``bench.*``
annotations) and the host's operators, then reduced to busy and idle time
and a breakdown.

A traced run profiles two stretches after the window: one of the device
alone, read for busy and idle time, rooflines and the top operations, and
one with the host's operators too, read only to label idle gaps. The
stretch's window is the device's own: from its first operation's start
to its last one's end, so the queue the host built before the profiler
started does not count as idle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
BREAKDOWN_ENTRIES = 10

Interval = Tuple[str, float, float]  # name, start µs, end µs


def span(name: str, on: bool):
    """A host span the trace can read (``bench.<name>``), or nothing when
    the run is not traced."""
    return torch.profiler.record_function(SPAN_PREFIX + name) if on else contextlib.nullcontext()


class Profiler:
    """``torch.profiler`` over one stretch of work. ``host=False`` records
    the device alone (kernels, copies, sets: the timeline that busy and
    idle time are read from, with little cost to the host);
    ``host=True`` adds the host's operators and ``bench.*`` spans on every
    thread, which slows the host, so that stretch is read only for what
    the host was doing when the device idled."""

    def __init__(self, out: Path, device: torch.device):
        self.out = out
        self.device = device

    def trace(self, fn, host: bool) -> Dict[str, List[Interval]]:
        from torch.profiler import ProfilerActivity

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        kwargs = {}
        if host and cuda:
            acts.append(ProfilerActivity.CPU)
            try:
                from torch._C._profiler import _ExperimentalConfig

                kwargs["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
            except (ImportError, TypeError):  # a torch without it records the starting thread
                pass
        with torch.profiler.profile(activities=acts, **kwargs) as prof:
            fn()
            if cuda:
                torch.cuda.synchronize(self.device)
        self.out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(self.out))
        with open(self.out) as f:
            return parse(json.load(f))


def parse(trace: dict) -> Dict[str, List[Interval]]:
    """{"device": kernels, copies and sets; "spans": ``bench.*`` host
    annotations; "ops": the host's operators}, each (name, start, end) in µs."""
    out: Dict[str, List[Interval]] = {"device": [], "spans": [], "ops": []}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        iv = (name, float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if cat in DEVICE_CATS:
            out["device"].append(iv)
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            out["spans"].append(iv)
        elif cat == "cpu_op":
            out["ops"].append(iv)
    return out


def merge(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The union of intervals as sorted, disjoint (start, end) pairs."""
    merged: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda iv: iv[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_window(device: List[Interval]) -> Optional[Tuple[float, float]]:
    """(busy seconds, window seconds) of the device timeline, or None
    without a device operation."""
    merged = merge(device)
    if not merged:
        return None
    busy = sum(e - s for s, e in merged)
    return busy * 1e-6, (merged[-1][1] - merged[0][0]) * 1e-6


class _Open:
    """Which interval is open at a time: the one that started last among
    those that hold it (the innermost, where they nest), found by bisection
    and a bounded look back."""

    LOOK_BACK = 4096

    def __init__(self, intervals: List[Interval]):
        self.iv = sorted(intervals, key=lambda iv: iv[1])
        self.starts = [s for _, s, _ in self.iv]

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        stop = max(-1, i - self.LOOK_BACK)
        while i > stop:
            name, _, e = self.iv[i]
            if e > t:
                return name
            i -= 1
        return None


def breakdown(device: Dict[str, List[Interval]], host: Dict[str, List[Interval]]) -> Dict[str, list]:
    """The device operations that took most time (of the device-only
    stretch ``device``), and idle time by what the host was doing when each
    gap began (of the host-traced stretch ``host``: its open ``bench.*``
    span and innermost operator), the largest first, in seconds."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in device["device"]:
        by_name[name[:160]] += (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    merged = merge(host["device"])
    spans, ops_open = _Open(host["spans"]), _Open(host["ops"])
    gaps: Dict[str, float] = defaultdict(float)
    for (_, end), (start, _) in zip(merged, merged[1:]):
        span_name = spans.at(end) or "no bench span"
        op = ops_open.at(end)
        gaps[f"{span_name} > {op}" if op else span_name] += (start - end) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}


def matching(device: List[Interval], patterns: List[str]) -> float:
    """Seconds of the device operations whose name holds any pattern."""
    return sum(e - s for n, s, e in device if any(p in n for p in patterns)) * 1e-6
