"""Model operations of the window's steps (3 × the forward at padded
shapes) over the window's seconds, against the card's peak in the
configuration's compute dtype."""

from benchmark.harness.readers import mfu


def read(res):
    return mfu(res, "window_s")
