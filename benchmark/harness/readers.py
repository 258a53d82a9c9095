"""What the per-layer metric readers share: each reads a run's result
(``readings`` from the host clock and the program's counters, ``trace``
from the device) and returns a number, or None when it finds nothing to
read."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from benchmark.harness import trace as tr

ATTENTION_KERNELS = Path(__file__).resolve().parents[1] / "metrics" / "attention_kernels.json"


def mean(values) -> Optional[float]:
    return float(np.mean(values)) if len(values) else None


def share(part: float, whole: float) -> Optional[float]:
    return 100.0 * part / whole if part > 0 and whole > 0 else None


def mfu(res: dict, seconds_key: str) -> Optional[float]:
    r = res["readings"]
    return share(r["flops"] / r[seconds_key], r["peak_flops"])


def attention_roofline(res: dict) -> Optional[float]:
    """The attention work's least time over the device time of the kernels
    whose names match ``attention_kernels.json``'s patterns."""
    if res["trace"] is None:
        return None
    with open(ATTENTION_KERNELS) as f:
        patterns = json.load(f)["patterns"]
    device = res["trace"]["device"]["device"]
    return share(res["readings"]["attention_least_s"], tr.matching(device, patterns))


def device_idle(res: dict) -> Optional[float]:
    if res["trace"] is None:
        return None
    bw = tr.busy_window(res["trace"]["device"]["device"])
    return None if bw is None else 100.0 * (bw[1] - bw[0]) / bw[1]
