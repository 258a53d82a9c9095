"""Mean host time to enqueue one training step in the window
(``to_device`` and ``train_step``, no sync), from the benchmark's own clock
around each call."""

from benchmark.harness.readers import mean


def read(res):
    return mean(res["readings"]["host_ms"])
