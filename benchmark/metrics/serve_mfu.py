"""Forward operations of the window's engine calls at their padded shapes
over the summed seconds of those calls, against the card's peak in the
configuration's compute dtype."""

from benchmark.harness.readers import mfu


def read(res):
    return mfu(res, "call_s")
