"""The device timeline of a traced run, on a synthetic Chrome trace: the
union of device intervals, the idle share, the breakdown and the readers."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from benchmark.harness import readers
from benchmark.harness import trace as tr

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def synthetic() -> dict:
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    return {"traceEvents": [
        x("user_annotation", "bench.to_device", 0, 30),
        x("cpu_op", "aten::copy_", 5, 20),
        x("user_annotation", "bench.train_step", 30, 200),
        x("cpu_op", "aten::mm", 40, 5),
        x("kernel", "attn_fwd_bf16_kernel", 100, 10),
        x("kernel", "nvjet_gemm", 105, 20),  # overlaps the kernel before it
        x("gpu_memcpy", "Memcpy HtoD", 150, 10),
        x("kernel", "attn_bwd_dq_bf16_kernel", 200, 40),
        x("user_annotation", "not.ours", 0, 500),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
    ]}


def test_parse_and_union():
    p = tr.parse(synthetic())
    assert len(p["device"]) == 4 and len(p["spans"]) == 2 and len(p["ops"]) == 2
    assert tr.merge(p["device"]) == [(100.0, 125.0), (150.0, 160.0), (200.0, 240.0)]
    busy, window = tr.busy_window(p["device"])
    assert busy == pytest.approx(75e-6) and window == pytest.approx(140e-6)
    assert tr.busy_window([]) is None


def test_breakdown_labels_gaps_by_host_span_and_operator():
    p = tr.parse(synthetic())
    b = tr.breakdown(p, p)
    assert b["device_ops"][0] == ["attn_bwd_dq_bf16_kernel", pytest.approx(40e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps["bench.train_step"] == pytest.approx(25e-6 + 40e-6)
    assert len(b["device_ops"]) <= tr.BREAKDOWN_ENTRIES


def read(name, res):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(res)


def test_readers_on_a_synthetic_run():
    p = tr.parse(synthetic())
    res = {"trace": {"device": p, "host": p}, "readings": {
        "attention_least_s": 10e-6, "occupancy": (4, 10), "call_ms": [2.0, 4.0],
        "host_ms": [1.0, 3.0], "flops": 67e12, "window_s": 4.0, "call_s": 2.0,
        "peak_flops": 67e12}}
    assert read("attn_roofline.train", res) == pytest.approx(100 * 10 / 50)
    assert read("attn_roofline.serve", res) == read("attn_roofline.train", res)
    assert read("device_idle.train", res) == pytest.approx(100 * 65 / 140)
    assert read("serve_batch_mean", res) == 2.5
    assert read("serve_call_ms", res) == 3.0
    assert read("train_host_ms", res) == 2.0
    assert read("train_mfu", res) == pytest.approx(25.0)
    assert read("serve_mfu", res) == pytest.approx(50.0)


def test_readers_find_nothing_without_a_trace_or_kernels():
    res = {"trace": None, "readings": {"attention_least_s": 1.0}}
    assert read("attn_roofline.train", res) is None
    assert read("device_idle.serve", res) is None
    res = {"trace": {"device": {"device": [("nvjet", 0.0, 5.0)], "spans": [], "ops": []}},
           "readings": {"attention_least_s": 1.0}}
    assert read("attn_roofline.train", res) is None  # no attention kernel ran: no share, not 0
    assert readers.share(0.0, 1.0) is None
