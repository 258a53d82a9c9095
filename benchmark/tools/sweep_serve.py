"""Find the serving knee once, on the card: the highest offered rate at
which the backlog does not grow across a window.

    python benchmark/tools/sweep_serve.py --workload large_serve --rates 200 300 400 \
        [--seconds 8] [--seed N]

Builds the cell's engine and batcher once, then offers each rate for
``--seconds`` (open-loop Poisson, as the cell does) and prints, a line a
rate: offered and completed requests/s, p50 and p95 latency, and the
growth of the backlog (mean latency of the window's last quarter of
requests over its first quarter's). The cell's rate is 4/5 of the knee.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="large_serve")
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from benchmark import run as br

    br.fixed_caches()
    import numpy as np
    import torch

    from benchmark.drivers import serve as sv
    from benchmark.harness import traffic, weights
    from benchmark.reference import model as ref_model
    from ssd_tpu_torch.data.vocab import Vocab
    from ssd_tpu_torch.serving.server import MicroBatcher

    manifest = br.load_json(REPO / "BENCHMARK.json")
    entry = next(w for w in manifest["workloads"] if w["name"] == args.workload)
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    cell = br.load_json(REPO / "benchmark" / "workloads" / f"{args.workload}.json")
    cfg = br.load_json(REPO / config["file"])["config"]
    dev = torch.device("cuda:0")
    if cell.get("torch_threads"):
        torch.set_num_threads(int(cell["torch_threads"]))
    v = cfg["vocab"]
    vocab = Vocab(tokens=list(v["tokens"]), pad_id=v["pad_id"], blank_id=v["blank_id"],
                  unk_id=v["unk_id"])
    engine = sv.InferenceEngine(cfg, weights.make(ref_model.param_layout(cfg, len(vocab.tokens)),
                                                  args.seed, dev), vocab,
                                decoder=cell["decoder"], device=dev)
    pool = traffic.serve_pool(cell, args.seed, dev)
    sv.warm_shapes(engine, pool)
    batcher = MicroBatcher(engine, max_batch=cell["max_batch"], max_wait_ms=cell["max_wait_ms"])
    print(f"card {torch.cuda.get_device_name(dev)}", flush=True)
    for rate in args.rates:
        due, picks = traffic.arrivals(rate, args.seconds, len(pool), args.seed)
        before = (batcher.batches_run, batcher.items_run)
        win = sv.Window(batcher, [pool[k][:] for k in picks], due, cell["clients"])
        t0 = time.perf_counter()
        win.dispatch(t0)
        missing = win.finish(t0 + args.seconds + sv.ANSWER_WAIT_S)
        end = np.nanmax(win.done)
        lat = (win.done - (t0 + due)) * 1e3
        q = max(1, len(lat) // 4)
        batches = batcher.batches_run - before[0]
        print(json.dumps({
            "rate": rate, "offered": len(due) / args.seconds,
            "completed_per_s": (len(due) - missing) / (end - t0), "missing": missing,
            "p50_ms": float(np.nanquantile(lat, 0.5)), "p95_ms": float(np.nanquantile(lat, 0.95)),
            "backlog_growth": float(np.nanmean(lat[-q:]) / np.nanmean(lat[:q])),
            "batch_mean": (batcher.items_run - before[1]) / max(batches, 1),
        }), flush=True)
    batcher.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
