"""Readings of this process over a measured window, printed on every run's
standard error beside its result: the window's wall seconds, the CPU
seconds of the whole process and of the thread that drives the window, the
host's speed at the window's open and close, and the clock the host's CPU
states. A host-bound cell spends about as many CPU seconds as the window
lasts, so its rate follows the host's speed; these numbers tell that apart
from a wait on the device."""

from __future__ import annotations

import resource
import time
from typing import Dict

PROBE_LOOPS = 200_000


def _process_cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def cpu_probe_ms() -> float:
    """The host's single-thread speed: the least of three timings of a fixed
    pure-Python loop (some 10 ms), the kind of work the host does when it
    dispatches the program's operations."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        s = 0
        for i in range(PROBE_LOOPS):
            s += i * i
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def stated_mhz() -> float:
    """The first ``cpu MHz`` that ``/proc/cpuinfo`` states (0 where none)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("cpu MHz"):
                    return float(line.split(":")[1])
    except OSError:
        pass
    return 0.0


class HostProbe:
    """``start()`` just before a window opens, ``stop()`` just after it
    closes, on the thread that drives the window; the speed probes run
    outside the window."""

    def start(self) -> "HostProbe":
        self._probe = cpu_probe_ms()
        self._t, self._cpu, self._thread = time.perf_counter(), _process_cpu_s(), time.thread_time()
        return self

    def stop(self, close_probe: bool = True) -> Dict[str, float]:
        """Without ``close_probe`` the caller probes once its late work is
        done (``probe_close_ms`` from ``cpu_probe_ms()``)."""
        out = {"wall_s": time.perf_counter() - self._t,
               "proc_cpu_s": _process_cpu_s() - self._cpu,
               "main_cpu_s": time.thread_time() - self._thread,
               "probe_open_ms": self._probe, "mhz": stated_mhz()}
        if close_probe:
            out["probe_close_ms"] = cpu_probe_ms()
        return out
