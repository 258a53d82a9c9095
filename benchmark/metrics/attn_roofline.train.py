"""The training step's fused attention (forward and backward in every
block) against its roofline, over the traced steps."""

from benchmark.harness.readers import attention_roofline


def read(res):
    return attention_roofline(res)
