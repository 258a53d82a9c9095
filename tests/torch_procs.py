"""A guard for the port's tests that start processes (loader worker pools,
gloo ranks, CLI children): after each test, no process the test started is
left — running, or exited and never waited for.

The only exceptions are ``multiprocessing``'s own helpers, one each per
test process and started on first use: the fork server the loaders' pools
fork their workers from, and the resource tracker. They serve every later
test in the process and exit with it; the workers they fork are checked."""

import os
import time

import pytest

_HELPERS = ("multiprocessing.forkserver import main", "multiprocessing.resource_tracker import main")
GRACE_SECONDS = 10.0  # a terminated worker is reaped by its fork server within this


def _table() -> dict:
    """pid → (parent pid, state, command line) of every visible process."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:  # exited while the table was read
            continue
        out[int(name)] = (int(fields[1]), fields[0], cmd)
    return out


def stray_processes(root: int = None) -> list:
    """(pid, state, command line) of every descendant of ``root`` (this
    process) but ``multiprocessing``'s fork server and resource tracker,
    its children; what the fork server forks (pool workers, which share its
    command line) is listed."""
    root = os.getpid() if root is None else root
    table = _table()
    children = {}
    for pid, (ppid, _, _) in table.items():
        children.setdefault(ppid, []).append(pid)
    stray, todo = [], [root]
    while todo:
        parent = todo.pop()
        for pid in children.get(parent, []):
            todo.append(pid)
            _, state, cmd = table[pid]
            if not (parent == root and any(h in cmd for h in _HELPERS)):
                stray.append((pid, state, cmd[:200]))
    return stray


@pytest.fixture
def no_stray_processes():
    """Fail the test if a process it started outlives it."""
    before = {pid for pid, _, _ in stray_processes()}
    yield
    deadline = time.monotonic() + GRACE_SECONDS
    while True:
        stray = [p for p in stray_processes() if p[0] not in before]
        if not stray or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not stray, f"processes outlived the test: {stray}"
