"""Mean wall time of one engine call in the window, from the benchmark's
own span around the engine the batcher calls."""

from benchmark.harness.readers import mean


def read(res):
    return mean(res["readings"]["call_ms"])
