"""Items a micro-batch over the window: the batcher's own counters
(``MicroBatcher.batches_run`` / ``items_run``), read at the window's open and close."""


def read(res):
    batches, items = res["readings"]["occupancy"]
    return items / batches if batches else None
