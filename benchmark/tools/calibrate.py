"""Readings that set a cell's limits, on the card at the cell's own size:

    python benchmark/tools/calibrate.py --workload CELL --seeds S1 S2 ... [--seconds 3]
        [--what program control half_batch]

A line a seed and reading: ``program`` (the run's own comparison; for a
serving cell a short window at the cell's rate), ``control`` (the
precision below the configuration's in the program's place) and, for a
training cell, ``half_batch`` (each step fed the first half of its rows,
its mean over those). Limits go between the largest program reading and
the smallest control or fault reading (PERF.md lists them).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def half_rows(to_device):
    """``to_device`` that keeps the first half of every array's rows."""
    def first_half(arrays, device):
        n = next(iter(arrays.values())).shape[0] // 2
        return to_device({k: v[:n] for k, v in arrays.items()}, device)
    return first_half


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--what", nargs="+", default=["program", "control", "half_batch"])
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from benchmark import run as br

    br.fixed_caches()
    import importlib

    import torch

    manifest = br.load_json(REPO / "BENCHMARK.json")
    entry = next(w for w in manifest["workloads"] if w["name"] == args.workload)
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    cell = br.load_json(REPO / "benchmark" / "workloads" / f"{args.workload}.json")
    cfg = br.load_json(REPO / config["file"])["config"]
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    if hasattr(driver, "EXTRA_READINGS"):
        driver.EXTRA_READINGS = True
    dev = torch.device("cuda:0")
    print(f"card {torch.cuda.get_device_name(dev)}", flush=True)
    for seed in args.seeds:
        for what in args.what:
            if what == "half_batch" and cell["driver"] != "train":
                continue
            ctx = br.Ctx(cell, cfg, seed, args.seconds, False, dev, REPO / "benchmark" / "_out",
                         time.perf_counter())
            t = time.perf_counter()
            if what == "control":
                got = driver.reading_control(ctx)
            else:
                saved = driver.__dict__.get("to_device")
                if what == "half_batch":
                    driver.to_device = half_rows(saved)
                try:
                    res = driver.run(ctx)
                finally:
                    if what == "half_batch":
                        driver.to_device = saved
                got = dict(res["checks"], failed=res["failed"], **res["e2e"])
            ctx.free()
            print(json.dumps({"seed": seed, "what": what, "s": time.perf_counter() - t, **got}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
