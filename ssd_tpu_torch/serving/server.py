"""HTTP serving front-end with micro-batching (PyTorch port of
``ssd_tpu/serving/server.py``).

  python -m ssd_tpu_torch.serving.server --checkpoint results/checkpoints/run/best \
      [--port 8776] [--decoder beam] [--max-batch 8] [--max-wait-ms 10] [--device cuda]
      [--lm-path LM.arpa --alpha A --beta B] [--compile-cache DIR]

Every flag of the JAX server parses. With ``--decoder beam``, ``--lm-path``
fuses an ARPA n-gram LM into the beam search on the engine's device (a path
that does not exist is logged and served without the LM, as the JAX server
does); ``--alpha`` / ``--beta`` weigh it (CLI > the checkpoint's
``decoding`` block > 0.5 / 0.0). ``--compile-cache DIR`` (else
``$SSD_COMPILE_CACHE``, else ``ssd_tpu_torch/_build/``) is where the CUDA
kernels and the host library are built, so a restart reuses them.

Endpoints (same JSON and base64-npy contract as the JAX server):
  POST /transcribe     body: {"emg": <base64 of a float32 .npy (samples, C)>}
                       or    {"emg_list": [<base64 npy>, …]}
                       → {"hypotheses": ["text", …], "latency_ms": …}
  POST /stream/start   body: {} or {"chunk_frames", "left_context_frames",
                       "right_context_frames", "blank_bias"} → {"session": id}
  POST /stream/feed    body: {"session": id, "emg": <base64 npy (n, C)>}
                       → {"hypothesis": "text so far", "final": false}
  POST /stream/finish  body: {"session": id, "beam": false}
                       → {"hypothesis": "text", "final": true}
                       (chunked bounded-recompute streaming,
                       ``serving/streaming.py``; an unknown or expired
                       session is 404, a malformed body 400)
  GET  /healthz        → {"status": "ok"}
  GET  /stats          → per-utterance latency percentiles

Single requests are micro-batched: a collector thread drains the queue up to
``max_batch`` items or ``max_wait_ms``, whichever first, and runs one device
call. Stream sessions idle for 600 s are evicted, never while a feed or
finish holds the session.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import List, Optional

import numpy as np

from ssd_tpu_torch.serving.engine import InferenceEngine
from ssd_tpu_torch.serving.streaming import ChunkedStreamingTranscriber
from ssd_tpu_torch.utils.cuda_build import enable_compile_cache

logger = logging.getLogger(__name__)


def _decode_npy(b64: str) -> np.ndarray:
    raw = base64.b64decode(b64)
    arr = np.load(io.BytesIO(raw), allow_pickle=False)
    if arr.ndim != 2:
        raise ValueError(f"expected (samples, channels), got {arr.shape}")
    return arr.astype(np.float32)


def encode_npy(arr: np.ndarray) -> str:
    """Client-side helper: ndarray → base64 npy string."""
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode("ascii")


class _Request:
    __slots__ = ("emg", "event", "result", "error")

    def __init__(self, emg: np.ndarray):
        self.emg = emg
        self.event = threading.Event()
        self.result: Optional[str] = None
        self.error: Optional[str] = None


class MicroBatcher:
    """Collects requests into device-sized batches."""

    def __init__(self, engine: InferenceEngine, max_batch: int = 8, max_wait_ms: float = 10.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.q: "queue.Queue[_Request]" = queue.Queue()
        # occupancy accounting (mutated only by the collector thread)
        self.batches_run = 0
        self.items_run = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def occupancy(self) -> dict:
        n, items = self.batches_run, self.items_run
        return {
            "batches": n,
            "items": items,
            "mean_batch": round(items / n, 3) if n else None,
            "max_batch": self.max_batch,
        }

    def submit(self, emg: np.ndarray, timeout: float = 60.0) -> str:
        req = _Request(emg)
        self.q.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("transcription timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result  # type: ignore[return-value]

    def shutdown(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch: List[_Request] = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            self.batches_run += 1
            self.items_run += len(batch)
            try:
                hyps = self.engine.transcribe([r.emg for r in batch])
                for r, h in zip(batch, hyps):
                    r.result = h
            except Exception as exc:  # the collector must outlive one bad batch
                logger.exception("batch failed")
                for r in batch:
                    r.error = str(exc)
            for r in batch:
                r.event.set()


class UnknownSession(KeyError):
    """Stream session id is unknown or expired (HTTP 404, not 400)."""


class StreamSessions:
    """Registry of chunked streaming sessions on one engine."""

    def __init__(self, engine: InferenceEngine, idle_ttl_sec: float = 600.0):
        self.engine = engine
        self.idle_ttl = idle_ttl_sec
        self._sessions: dict = {}  # id → [transcriber, its lock, last use]
        self._lock = threading.Lock()
        self._counter = 0

    def start(self, **kwargs) -> str:
        st = ChunkedStreamingTranscriber(self.engine, **kwargs)
        with self._lock:
            self._counter += 1
            sid = f"s{self._counter:08d}"
            self._sessions[sid] = [st, threading.Lock(), time.monotonic()]
            self._evict_idle()
        return sid

    def _evict_idle(self) -> None:
        now = time.monotonic()
        for sid in [
            s for s, v in self._sessions.items()
            # a held session lock is a feed or finish in flight: never evict
            # it, however old its timestamp
            if now - v[2] > self.idle_ttl and not v[1].locked()
        ]:
            del self._sessions[sid]

    def _get(self, sid: str) -> list:
        with self._lock:
            # evict here too: a server that receives no NEW streams still
            # reclaims sessions abandoned without /stream/finish
            self._evict_idle()
            entry = self._sessions.get(sid)
            if entry is None:
                raise UnknownSession(f"unknown or expired session {sid!r}")
            entry[2] = time.monotonic()
            return entry

    def feed(self, sid: str, emg: np.ndarray) -> str:
        entry = self._get(sid)
        st, lock, _ = entry
        with lock:
            st.feed(emg)
            hyp = st.hypothesis
            # the idle clock starts when the feed ENDS, written while the
            # session lock is held: after the release a stale timestamp on
            # an unlocked session is what _evict_idle reclaims
            entry[2] = time.monotonic()
        return hyp

    def finish(self, sid: str, beam: bool = False) -> str:
        st, lock, _ = self._get(sid)
        with lock:
            hyp = st.finish(beam=beam)
        with self._lock:
            self._sessions.pop(sid, None)
        return hyp


_STREAM_INT_KEYS = ("chunk_frames", "left_context_frames", "right_context_frames")


def make_handler(batcher: MicroBatcher, engine: InferenceEngine):
    sessions = StreamSessions(engine)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            logger.debug(fmt, *args)

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/stats":
                self._reply(
                    200,
                    {"latency": engine.stats.summary(), "micro_batch": batcher.occupancy()},
                )
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length)) if length else {}
                t0 = time.perf_counter()
                if self.path == "/transcribe":
                    if "emg_list" in payload:
                        arrays = [_decode_npy(b) for b in payload["emg_list"]]
                        hyps = engine.transcribe(arrays)
                    else:
                        hyps = [batcher.submit(_decode_npy(payload["emg"]))]
                    self._reply(
                        200,
                        {"hypotheses": hyps, "latency_ms": (time.perf_counter() - t0) * 1e3},
                    )
                elif self.path == "/stream/start":
                    kwargs = {k: int(payload[k]) for k in _STREAM_INT_KEYS if k in payload}
                    if "blank_bias" in payload:
                        kwargs["blank_bias"] = float(payload["blank_bias"])
                    self._reply(200, {"session": sessions.start(**kwargs)})
                elif self.path == "/stream/feed":
                    hyp = sessions.feed(payload["session"], _decode_npy(payload["emg"]))
                    self._reply(200, {"hypothesis": hyp, "final": False})
                elif self.path == "/stream/finish":
                    hyp = sessions.finish(payload["session"], beam=bool(payload.get("beam", False)))
                    self._reply(200, {"hypothesis": hyp, "final": True})
                else:
                    self._reply(404, {"error": "not found"})
            except UnknownSession as exc:
                self._reply(404, {"error": str(exc)})
            except (KeyError, ValueError, TypeError) as exc:
                # malformed request body (missing fields, bad base64/npy,
                # wrong types) — the caller's fault
                self._reply(400, {"error": str(exc)})
            except Exception:
                # anything else (engine / device failures) is server-side:
                # log the traceback, reply generically
                logger.exception("Internal error handling %s", self.path)
                self._reply(500, {"error": "internal server error"})

    return Handler


def serve(
    checkpoint: Path,
    port: int = 8776,
    decoder: str = "greedy",
    beam_width: int = 50,
    max_batch: int = 8,
    max_wait_ms: float = 10.0,
    warmup: bool = True,
    warmup_grid: bool = False,
    lm_path: Path | None = None,
    alpha: float | None = None,
    beta: float | None = None,
    data_parallel: bool = False,
    quantize: str | None = None,
    device: str = "cuda",
    host: str = "0.0.0.0",
) -> ThreadingHTTPServer:
    """Load the checkpoint, warm up, and return the (not yet serving)
    HTTP server; ``server.batcher`` is its micro-batcher."""
    engine = InferenceEngine.from_checkpoint(
        checkpoint, decoder=decoder, beam_width=beam_width, lm_path=lm_path,
        alpha=alpha, beta=beta, data_parallel=data_parallel, quantize=quantize, device=device,
    )
    if warmup:
        logger.info("Warming up every batch bucket…")
        engine.warmup(grid=warmup_grid)
    batcher = MicroBatcher(engine, max_batch=max_batch, max_wait_ms=max_wait_ms)
    server = ThreadingHTTPServer((host, port), make_handler(batcher, engine))
    server.batcher = batcher  # type: ignore[attr-defined]
    logger.info("Serving on %s:%d (decoder=%s, device=%s)", host, port, decoder, engine.device)
    return server


def build_parser() -> argparse.ArgumentParser:
    """The server's flags: the JAX server's, plus ``--device``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--port", type=int, default=8776)
    p.add_argument("--decoder", choices=["greedy", "beam"], default="greedy")
    p.add_argument("--beam-width", type=int, default=50)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=10.0)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--warmup-grid", action="store_true",
                   help="Warm up every (batch × length) bucket at startup.")
    p.add_argument("--lm-path", type=Path, help="ARPA LM for on-device fusion (beam only)")
    # None → the checkpoint config's decoding block, then 0.5 / 0.0
    p.add_argument("--alpha", type=float, default=None, help="LM weight (LM fusion only).")
    p.add_argument("--beta", type=float, default=None, help="Word bonus (LM fusion only).")
    p.add_argument("--data-parallel", action="store_true",
                   help="Replicate the model on every visible card and split each batch's "
                   "rows across them (one card: a warning, then one device).")
    p.add_argument("--compile-cache", type=Path, default=None,
                   help="Build the CUDA kernels and the host library into this directory and "
                   "reuse what was built there before (default: $SSD_COMPILE_CACHE, else "
                   "ssd_tpu_torch/_build/).")
    p.add_argument("--quantize", choices=["none", "int8", "int8_prequant"], default=None,
                   help="Inference-time dense quantization: int8 serves any float checkpoint "
                   "with int8 FFN / pointwise products; int8_prequant converts those "
                   "weights once at load. Default: the checkpoint config's encoder.quantize.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu.")
    return p


def main() -> None:
    from ssd_tpu_torch.utils.config import setup_cli_logging

    setup_cli_logging()
    args = build_parser().parse_args()
    # a restart finds the kernels built by the last one (or by another
    # process sharing the cache) instead of running nvcc again
    enable_compile_cache(args.compile_cache)
    server = serve(
        args.checkpoint,
        port=args.port,
        decoder=args.decoder,
        beam_width=args.beam_width,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        warmup=not args.no_warmup,
        warmup_grid=args.warmup_grid,
        lm_path=args.lm_path,
        alpha=args.alpha,
        beta=args.beta,
        data_parallel=args.data_parallel,
        quantize=args.quantize,
        device=args.device,
    )
    try:
        server.serve_forever()
    finally:
        server.batcher.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
