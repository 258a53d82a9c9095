"""The JAX package's native library (``native/libssd_native.so``), made
whole for the port's tests that decode FLAC through ``ssd_tpu.data.flac``
or ``ssd_tpu.data.audio``, and the small FLAC encoder those tests write
their files with.

``ssd_tpu.utils.native.load`` builds the library in place with ``make`` and
takes any file that exists for a built one. When several test processes
load it at once, one can open the file while another's linker is still
writing it ("file too short"); the loader then gives ``None`` for the rest
of that process. :func:`jax_native` repairs that process: under a file lock
it builds the library with the Makefile's own compiler and flags into a
temporary file beside it, renames that over the library (a reader sees no
file or a whole one), clears the loader's cached failure and loads again.
A library that loads is never rebuilt. It fails, with the loader's reason,
when it still has no library.

Nothing here imports JAX or torch: the module is also run in fresh
processes on a copy of the loader (``tests/test_torch_jax_native.py``).
"""

from __future__ import annotations

import contextlib
import fcntl
import importlib
import logging
import os
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
LOCK_PATH = REPO / "ssd_tpu_torch" / "_build" / "jax_native.lock"
ATTEMPTS = 3


@contextlib.contextmanager
def _exclusive(path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


class _Reasons(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _build(native_dir: Path, so_path: Path) -> None:
    """``make`` the library into a temporary file, then rename it over
    ``so_path``: the Makefile's ``SO`` names its output."""
    tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["make", "-s", f"SO={tmp.name}"], cwd=native_dir,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            pytest.fail(f"building {so_path} failed (exit {proc.returncode}):\n"
                        f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        tmp.unlink(missing_ok=True)


def jax_native(module=None):
    """The JAX package's native library, loaded in this process.

    ``module`` is the loader module (default ``ssd_tpu.utils.native``)."""
    module = module or importlib.import_module("ssd_tpu.utils.native")
    if module._lib is not None:
        return module._lib
    reasons = _Reasons()
    module.logger.addHandler(reasons)
    try:
        with _exclusive(LOCK_PATH):
            for attempt in range(ATTEMPTS):
                # the first attempt loads an existing file as it is (another
                # process may have finished it); a later one rebuilds
                if attempt or not module._SO_PATH.exists():
                    _build(module._NATIVE_DIR, module._SO_PATH)
                module._lib, module._failed = None, False
                if module.load() is not None:
                    return module._lib
    finally:
        module.logger.removeHandler(reasons)
    pytest.fail(f"the JAX package's native library does not load: {reasons.messages}")


# ------------------------------------------------------------ FLAC encoder


class _BitWriter:
    def __init__(self):
        self.bits = []

    def write(self, value, nbits):
        for i in range(nbits - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def write_signed(self, value, nbits):
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q):
        self.bits.extend([0] * q + [1])

    def write_rice(self, value, k):
        z = (value << 1) if value >= 0 else ((-value) << 1) - 1
        self.write_unary(z >> k)
        if k:
            self.write(z & ((1 << k) - 1), k)

    def align(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def tobytes(self):
        self.align()
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i : i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def encode_flac(channels_data, sample_rate=16000, bps=16, mode="verbatim"):
    """Minimal FLAC encoder: one frame, fixed blocksize (exact sample count);
    verbatim, constant or fixed-order-2 subframes."""
    n = len(channels_data[0])
    ch = len(channels_data)

    w = _BitWriter()
    # STREAMINFO block
    w.write(0x664C6143, 32)  # "fLaC"
    w.write(0x80, 8)  # last metadata block, type 0
    w.write(34, 24)
    w.write(n, 16)  # min blocksize
    w.write(n, 16)  # max blocksize
    w.write(0, 24)  # min frame size
    w.write(0, 24)  # max frame size
    w.write(sample_rate, 20)
    w.write(ch - 1, 3)
    w.write(bps - 1, 5)
    w.write(n, 36)  # total samples
    w.write(0, 128)  # md5

    # frame header
    w.write(0x3FFE, 14)
    w.write(0, 1)  # reserved
    w.write(0, 1)  # fixed blocksize strategy
    w.write(7, 4)  # blocksize code 7: 16-bit value follows
    w.write(0, 4)  # sample rate: from streaminfo
    w.write(ch - 1, 4)  # independent channels
    w.write(4, 3)  # sample size 16-bit
    w.write(0, 1)
    w.write(0, 8)  # frame number 0 (utf8, 1 byte)
    w.write(n - 1, 16)  # blocksize-1
    w.write(0, 8)  # crc8 (not verified)

    for data in channels_data:
        w.write(0, 1)  # padding
        if mode == "verbatim":
            w.write(1, 6)
            w.write(0, 1)  # no wasted bits
            for s in data:
                w.write_signed(int(s), bps)
        elif mode == "constant":
            w.write(0, 6)
            w.write(0, 1)
            w.write_signed(int(data[0]), bps)
        elif mode == "fixed2":
            order = 2
            w.write(8 + order, 6)
            w.write(0, 1)
            for s in data[:order]:
                w.write_signed(int(s), bps)
            # residual: method 0 (4-bit rice), partition order 0
            w.write(0, 2)
            w.write(0, 4)
            k = 6
            w.write(k, 4)
            for i in range(order, n):
                r = int(data[i]) - 2 * int(data[i - 1]) + int(data[i - 2])
                w.write_rice(r, k)
        else:
            raise ValueError(mode)

    w.align()
    w.write(0, 16)  # crc16 (not verified)
    return w.tobytes()
