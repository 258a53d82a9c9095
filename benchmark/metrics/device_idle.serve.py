"""Share of the traced serving stretch's device timeline with no operation
on the device: 1 − the union of kernel, copy and set intervals over the
span from the first to the last."""

from benchmark.harness.readers import device_idle


def read(res):
    return device_idle(res)
