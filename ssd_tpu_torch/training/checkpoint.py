"""The port's checkpoint format.

Orbax needs JAX to read, so the port keeps its own format beside the same
embedded-config contract as ``ssd_tpu/training/checkpoint.py``:

    <run_dir>/last/model.pt    torch.save({"format", "state_dict",
                               ["optimizer", "epoch", "step"]})
    <run_dir>/best/model.pt    (when is_best)
    <run_dir>/config.json      the run's config; eval and serving rebuild
                               the model from it

``state_dict`` holds every parameter and the MaskedBatchNorm running
statistics (buffers ``…bn.mean`` / ``…bn.var``, the JAX ``batch_stats``).
A trainer's save adds the optimizer state (AdamW moments, the update count
and the open accumulation window), the epoch and the micro-step count, which
``--resume`` restores; a weights-only checkpoint still loads. Converting an
orbax directory needs JAX and is a separate tool (ROADMAP.md queue 1 item 12).

``load_params_partial`` reproduces ``load_state_dict(strict=False)`` for warm
starts: intersecting, shape-matching tensors are copied, everything else
keeps its fresh initialization.

:class:`CheckpointWriter` is the trainer's writer: the same files through
the same write, synchronous by default or, with ``logging.async_checkpoints:
true``, on a background thread from a host snapshot taken at ``save``.
"""

from __future__ import annotations

import json
import logging
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import torch

logger = logging.getLogger(__name__)

FORMAT = "ssd_tpu_torch/1"
MODEL_FILE = "model.pt"


def _payload(
    state_dict: Mapping[str, torch.Tensor],
    optimizer: Optional[Dict[str, Any]],
    epoch: Optional[int],
    step: Optional[int],
) -> Dict[str, Any]:
    payload: Dict[str, Any] = {"format": FORMAT, "state_dict": dict(state_dict)}
    if optimizer is not None:
        payload["optimizer"] = optimizer
    if epoch is not None:
        payload["epoch"] = int(epoch)
    if step is not None:
        payload["step"] = int(step)
    return payload


def _write_payload(run_dir: Path, payload: Dict[str, Any], cfg_text: str, is_best: bool) -> None:
    """``last`` (then ``best``) through a temporary file and an atomic
    replace, so a reader never sees a partial ``model.pt``, then
    ``config.json``. A failed write leaves the previous file in place."""
    for name in ("last", "best") if is_best else ("last",):
        (run_dir / name).mkdir(parents=True, exist_ok=True)
        tmp = run_dir / name / f"{MODEL_FILE}.tmp"
        try:
            torch.save(payload, tmp)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        tmp.replace(run_dir / name / MODEL_FILE)
    (run_dir / "config.json").write_text(cfg_text)


def save_checkpoint(
    run_dir: Path,
    state_dict: Mapping[str, torch.Tensor],
    cfg: Dict[str, Any],
    is_best: bool = False,
    optimizer: Optional[Dict[str, Any]] = None,
    epoch: Optional[int] = None,
    step: Optional[int] = None,
) -> None:
    """Write ``last`` (and optionally ``best``) + ``config.json``."""
    payload = _payload({k: v.detach().cpu() for k, v in state_dict.items()}, optimizer, epoch,
                       step)
    _write_payload(Path(run_dir).resolve(), payload, json.dumps(cfg, indent=2), is_best)


class CheckpointWriter:
    """The trainer's per-epoch writer, with optional overlapped saves (the
    JAX package's ``CheckpointWriter``, whose orbax checkpointer writes on a
    background thread).

    ``async_saves=False`` (the default) writes in :meth:`save` on the
    caller's thread, as :func:`save_checkpoint` does. ``async_saves=True``
    (``logging: {async_checkpoints: true}``) copies every tensor of the
    payload to host memory in :meth:`save` and writes the files on one
    background thread while the caller trains on; one write is in flight
    at a time, ``last`` before ``best``. ``wait=True`` (the trainer's save
    on preemption) writes before returning.

    The copy is what makes the overlap safe: ``state_dict()`` and the
    optimizer's state hold the live parameters and AdamW moments (on the
    CPU ``.detach().cpu()`` is the tensor itself), which the next epoch
    updates in place. A CUDA tensor is copied with ``non_blocking=True``
    into a pinned host buffer on the current stream, and the thread waits
    on an event recorded after the copies before it serializes; the
    updates that follow on that stream run after the copies. A CPU tensor
    is copied into a host buffer.

    Order: the port waits for the previous write, then copies (JAX copies,
    then waits). Its host buffers are kept from one save to the next, since
    pinning ~2 GB (tpu_scaled_large with its moments) costs more than the
    copy; a buffer may be overwritten only once the write that reads it has
    ended. An epoch normally outlasts a write, so the wait is then free.

    Over a mesh every rank gathers the full tensors on the training thread
    (collectives) and only rank 0 calls :meth:`save`; the writer's thread
    runs no collective.

    An exception in the writer's thread is raised again by the next
    :meth:`save` or by :meth:`finalize`, which waits for the write in
    flight; call it before reading the files or exiting.
    """

    def __init__(self, async_saves: bool = False) -> None:
        self.async_saves = async_saves
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None
        self._buffers: List[torch.Tensor] = []

    def save(
        self,
        run_dir: Path,
        state_dict: Mapping[str, torch.Tensor],
        cfg: Dict[str, Any],
        is_best: bool = False,
        wait: bool = False,
        optimizer: Optional[Dict[str, Any]] = None,
        epoch: Optional[int] = None,
        step: Optional[int] = None,
    ) -> None:
        self._wait()  # the previous write must land (and its error surface)
        run_dir = Path(run_dir).resolve()
        if wait or not self.async_saves:
            save_checkpoint(run_dir, state_dict, cfg, is_best=is_best, optimizer=optimizer,
                            epoch=epoch, step=step)
            return
        payload, events = self._snapshot(_payload(state_dict, optimizer, epoch, step))
        if self._pool is None:
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="checkpoint-writer")
        self._pending = self._pool.submit(_write_snapshot, run_dir, payload,
                                          json.dumps(cfg, indent=2), is_best, events)

    def finalize(self) -> None:
        """Wait for the write in flight; raise its exception, if any."""
        try:
            self._wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def _wait(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    @torch.no_grad()
    def _snapshot(self, tree: Any) -> tuple:
        """``tree`` with every tensor copied into this writer's host buffers,
        and the CUDA events recorded after the copies."""
        old, self._buffers = self._buffers, []
        devices = set()

        def copy(t: torch.Tensor) -> torch.Tensor:
            i = len(self._buffers)
            buf = old[i] if i < len(old) else None
            if (buf is None or buf.shape != t.shape or buf.dtype != t.dtype
                    or buf.is_pinned() != t.is_cuda):
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            buf.copy_(t, non_blocking=t.is_cuda)
            if t.is_cuda:
                devices.add(t.device)
            self._buffers.append(buf)
            return buf

        def walk(x: Any) -> Any:
            if isinstance(x, torch.Tensor):
                return copy(x)
            if isinstance(x, dict):
                return {k: walk(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(walk(v) for v in x)
            return x

        out = walk(tree)
        events = []
        for dev in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            events.append(event)
        return out, events


def _write_snapshot(run_dir: Path, payload: Dict[str, Any], cfg_text: str, is_best: bool,
                    events: list) -> None:
    for event in events:
        event.synchronize()
    _write_payload(run_dir, payload, cfg_text, is_best)


def load_checkpoint(path: Path) -> Dict[str, Any]:
    """Read a checkpoint directory (``…/last`` or ``…/best``) onto the CPU."""
    f = Path(path).resolve() / MODEL_FILE
    if not f.exists():
        raise FileNotFoundError(f)
    payload = torch.load(f, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{f}: not an {FORMAT} checkpoint (format={payload.get('format')!r})")
    return payload


def load_config_for(path: Path) -> Dict[str, Any]:
    """Config stored next to a checkpoint dir (embedded-config contract)."""
    cfg_path = Path(path).resolve().parent / "config.json"
    if not cfg_path.exists():
        raise FileNotFoundError(cfg_path)
    return json.loads(cfg_path.read_text())


def load_params_partial(
    fresh: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Copy intersecting, shape-matching tensors of ``loaded`` onto ``fresh``."""
    copied = skipped = 0
    merged: Dict[str, torch.Tensor] = {}
    for name, tensor in fresh.items():
        other = loaded.get(name)
        if other is not None and tuple(other.shape) == tuple(tensor.shape):
            merged[name] = other
            copied += 1
        else:
            merged[name] = tensor
            if other is not None:
                skipped += 1
    logger.info("Warm start: copied %d tensors, kept %d fresh", copied, skipped)
    return merged
