"""The served forward's fused attention against its roofline, over the
traced engine calls."""

from benchmark.harness.readers import attention_roofline


def read(res):
    return attention_roofline(res)
