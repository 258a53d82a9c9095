"""Shared-memory batch transport for the loader's worker processes (the
port's own copy of ``ssd_tpu/data/shm_slots.py``).

Handing finished batches back through ``multiprocessing.Pool``'s result
pipe is a pickle → pipe → unpickle round trip over the whole padded batch.
Here the pipe carries only a descriptor:

* the parent creates N slots as anonymous shared-memory files
  (``memfd_create``: no path in any file system, never written back to a
  disk, freed when the last process holding one closes it) and hands the
  workers their ``/proc/<parent pid>/fd/<n>`` names when the pool starts;
* a worker copies the collated arrays into the slot it was given and
  returns ``(slot, nbytes, {name: (offset, shape, dtype)})``;
* the parent rebuilds the batch as zero-copy numpy views over its own mmap
  of the slot. The views share one buffer-exporting sentinel
  (:class:`_SlotBuffer`); a ``weakref.finalize`` on it returns the slot to
  the free queue when the last view (sub-views and tensors made by
  ``torch.from_numpy`` included) dies, so a slot is never overwritten
  while a step still reads it, and the workers' submissions wait on
  :meth:`SlotPool.acquire` for the consumer to let a batch go.

Slots grow on demand (the worker allocates the new size with
``posix_fallocate``, both sides map again), so no batch size has to be
known ahead, and memory that cannot be had fails the batch with
``ENOSPC`` instead of a ``SIGBUS`` in the copy. (Slot files in a
disk-backed temporary directory were tried first: on an H100 host the
kernel's writeback of the dirty slot pages throttled 2 workers below the
in-process loader.)

The dtypes are numpy's own: the port's bf16 arrays are uint16 bit patterns
(``data/dataset.py:bf16_bits``) and travel as ``<u2``, so nothing here needs
``ml_dtypes``.
"""

from __future__ import annotations

import mmap
import os
import queue
import weakref
from typing import Dict, List, Tuple

import numpy as np

_ALIGN = 64  # array offsets aligned for vectorized copies


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class _SlotBuffer:
    """Buffer exporter that ties the views' lifetime to the slot's.

    ``np.ndarray(buffer=sentinel)`` keeps the sentinel referenced from every
    array built on it (and from any sub-view); when the last one is
    collected the sentinel dies and its finalizer releases the slot."""

    def __init__(self, mm: mmap.mmap) -> None:
        self._mm = mm

    def __buffer__(self, flags: int) -> memoryview:  # PEP 688 (Python 3.12+)
        return memoryview(self._mm)

    def __release_buffer__(self, view: memoryview) -> None:
        view.release()


# (slot index, total bytes, {name: (offset, shape, dtype str)})
Descriptor = Tuple[int, int, Dict[str, Tuple[int, Tuple[int, ...], str]]]


def _layout(arrays: Dict[str, np.ndarray]) -> Tuple[int, Dict]:
    off = 0
    fields: Dict[str, Tuple[int, Tuple[int, ...], str]] = {}
    for name, arr in arrays.items():
        off = _round_up(off, _ALIGN)
        fields[name] = (off, arr.shape, arr.dtype.str)
        off += arr.nbytes
    return off, fields


class SlotPool:
    """Parent side: the slot files, their maps, the free queue, and the
    batches rebuilt as views."""

    def __init__(self, n_slots: int, initial_size: int = 1 << 23) -> None:
        self.paths: List[str] = []
        self._fds: List[int] = []
        self._maps: List[mmap.mmap] = []
        for i in range(n_slots):
            fd = os.memfd_create(f"ssd_loader_slot{i}")
            os.ftruncate(fd, initial_size)
            self.paths.append(f"/proc/{os.getpid()}/fd/{fd}")
            self._fds.append(fd)
            self._maps.append(mmap.mmap(fd, initial_size))
        self._free: "queue.SimpleQueue[int]" = queue.SimpleQueue()
        for i in range(n_slots):
            self._free.put(i)
        self._closed = False

    def acquire(self) -> int:
        """A free slot, waiting for one; raises once :meth:`close` ran, so a
        waiting iterator does not hang across the loader's ``close()``."""
        while not self._closed:
            try:
                return self._free.get(timeout=0.5)
            except queue.Empty:
                pass
        raise RuntimeError("DataLoader.close() was called during iteration")

    def release(self, idx: int) -> None:
        if not self._closed:
            self._free.put(idx)

    def free_slots(self) -> int:
        return self._free.qsize()

    def open_batch(self, desc: Descriptor) -> Dict[str, np.ndarray]:
        """Zero-copy views over the slot; it recycles when the last dies."""
        idx, nbytes, fields = desc
        mm = self._maps[idx]
        if len(mm) < nbytes:
            # the worker grew the file; the old map lives on until views of
            # earlier batches on it are gone (an mmap closes when collected)
            mm = mmap.mmap(self._fds[idx], nbytes)
            self._maps[idx] = mm
        sentinel = _SlotBuffer(mm)
        weakref.finalize(sentinel, self.release, idx)
        return {
            name: np.ndarray(shape, dtype=np.dtype(dtype), buffer=sentinel, offset=off)
            for name, (off, shape, dtype) in fields.items()
        }

    def close(self) -> None:
        self._closed = True
        for fd in self._fds:
            os.close(fd)
        self._fds = []
        # live batches may still export views of a map: those close (and
        # their memory goes) when collected, the others now
        for mm in self._maps:
            try:
                mm.close()
            except (BufferError, ValueError):
                pass


class SlotWriter:
    """Worker side: opens and maps the slots by name when first used, grows
    them on demand."""

    def __init__(self, paths: List[str]) -> None:
        self.paths = paths
        self._maps: Dict[int, mmap.mmap] = {}
        self._files: Dict[int, object] = {}

    def _map(self, idx: int, need: int) -> mmap.mmap:
        if idx not in self._files:
            self._files[idx] = open(self.paths[idx], "r+b")
        f = self._files[idx]
        size = os.fstat(f.fileno()).st_size
        if size < need:
            os.posix_fallocate(f.fileno(), 0, _round_up(need, 1 << 20))
            self._maps.pop(idx, None)
        mm = self._maps.get(idx)
        if mm is None or len(mm) < need:
            self._maps[idx] = mm = mmap.mmap(f.fileno(), os.fstat(f.fileno()).st_size)
        return mm

    def write(self, idx: int, arrays: Dict[str, np.ndarray]) -> Descriptor:
        nbytes, fields = _layout(arrays)
        mm = self._map(idx, nbytes)
        for name, arr in arrays.items():
            dst = np.ndarray(arr.shape, dtype=arr.dtype, buffer=mm, offset=fields[name][0])
            np.copyto(dst, arr)
        return (idx, nbytes, fields)
