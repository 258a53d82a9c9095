"""Run one benchmark cell of the PyTorch / CUDA port on the card:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``benchmark/configs/<config>.json``) and its traffic file
(``benchmark/workloads/<traffic>.json``), which names the driver
(``benchmark/drivers/<driver>.py``) that builds and drives the program. With
``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<metric>.py``. Every run checks what the timed path
produced against the plain reference under ``benchmark/reference/`` and
prints each compared number beside its limit, last on standard error and
under ``checks`` in the result line.

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; so it does when JAX, flax or the JAX package was loaded
into the process, or when the program is not beside it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
CACHE = HERE / "_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "ssd_tpu")


def fixed_caches() -> None:
    """Every build and kernel cache in a fixed directory of the checkout,
    so that only a cell's first run there builds."""
    os.environ["SSD_COMPILE_CACHE"] = str(CACHE / "build")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False  # so later runs reuse the bytecode of torch and the port


def forbidden_loaded() -> list:
    """Top-level names in ``sys.modules`` that belong to JAX or its package,
    compared whole (``ssd_tpu_torch`` is not ``ssd_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark by file path (metric readers' names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics, or the
    per-layer metrics that list it (or list no cells and move one of its
    end-to-end metrics)."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


class Ctx:
    """What a driver module gets: the cell, its configuration, the run's flags, the
    device, and the few device calls it needs."""

    def __init__(self, cell: dict, cfg: dict, seed: int, seconds: float, trace: bool, device,
                 out_dir: Path, t_start: float):
        self.cell, self.cfg, self.seed, self.seconds = cell, cfg, seed, seconds
        self.trace, self.device, self.out_dir, self.t_start = trace, device, out_dir, t_start

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def settle(self) -> None:
        """The end of set-up: the device drained, and every object set-up
        made moved out of the collector's reach, so that no full collection
        over them falls into the window."""
        self.sync()
        gc.collect()
        gc.freeze()

    def memory_peak(self) -> int:
        import torch

        self.sync()
        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def free(self) -> None:
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device, manifest: dict,
            root: Path = REPO, t_start: float = T_START, overrides: dict = None,
            with_host: bool = False):
    """Runs a cell and returns its result object (not yet printed), and with
    ``with_host`` the host's readings over the window beside it.
    ``overrides`` replaces keys of the cell and of the configuration (the
    tests' tiny sizes)."""
    entry = next(w for w in manifest["workloads"] if w["name"] == cell_name)
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    cell = dict(load_json(root / "benchmark" / "workloads" / f"{entry['traffic']}.json"))
    cfg = load_json(root / config["file"])["config"]
    if overrides:
        cell.update(overrides.get("cell", {}))
        cfg = overrides.get("config", cfg)
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    ctx = Ctx(cell, cfg, seed, seconds, trace, device, root / "benchmark" / "_out", t_start)
    res = driver.run(ctx)
    checks = {k: (float(res["checks"][k]), float(lim)) for k, lim in cell["limits"].items()}
    correct = all(v <= lim for v, lim in checks.values()) and res["failed"] == 0
    metrics = {}
    for m in cell_metrics(manifest, cell_name, trace):
        if trace:
            reader = load_module(root / "benchmark" / "metrics" / f"{m['name']}.py",
                                 f"benchmark.metrics.{m['name']}")
            value = reader.read(res)
        else:
            value = res["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": device_info(device, res)}
    if trace and res["trace"] is not None:
        from benchmark.harness.trace import breakdown

        out["breakdown"] = breakdown(res["trace"]["device"], res["trace"]["host"])
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return (out, res["host"]) if with_host else out


def device_info(device, res: dict) -> dict:
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if res["trace"] is not None:
        from benchmark.harness.trace import busy_window

        bw = busy_window(res["trace"]["device"]["device"])
        if bw is not None:
            info["busy_s"], info["window_s"] = bw
    return info


def main(argv=None) -> int:
    fixed_caches()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    manifest = load_json(REPO / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    try:
        import ssd_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program (ssd_tpu_torch) is not beside the benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"the cell needs {entry['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    threads = load_json(REPO / "benchmark" / "workloads" / f"{entry['traffic']}.json").get(
        "torch_threads")
    if threads:  # the cell's CPU thread pool, where its traffic file fixes one
        torch.set_num_threads(int(threads))
    out, host = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda:0"), manifest, with_host=True)
    found = forbidden_loaded()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 2
    print("host " + json.dumps(host), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
