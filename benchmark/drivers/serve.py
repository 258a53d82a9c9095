"""Serving cells: the server's ``MicroBatcher`` in front of an
``InferenceEngine``, in process, under open-loop Poisson arrivals.

Set-up builds the engine with the benchmark's seeded weights and runs every
(batch bucket × length bucket) shape the traffic can form once. In the
window a dispatcher hands each request, at its due time, to a client thread
that calls ``MicroBatcher.submit`` as the HTTP handler does; a request is
timed from its due time until its text is back. The engine the batcher
sees is wrapped to time each call and to keep, for the requests the seed
sampled for the check, the log-probs that the engine's decoder read.
After the window every answer is awaited (a minute past the close at
most). A traced run profiles further stretches of arrivals after the window
(device alone, then with the host's operators).
"""

from __future__ import annotations

import gc
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import flops, traffic, weights
from benchmark.harness.host import HostProbe, cpu_probe_ms
from benchmark.harness.trace import Profiler, span
from benchmark.reference import features as ref_feat
from benchmark.reference import model as ref_model
from ssd_tpu_torch.data.vocab import Vocab
from ssd_tpu_torch.serving.engine import BATCH_BUCKETS, SAMPLE_BUCKET, InferenceEngine
from ssd_tpu_torch.serving.server import MicroBatcher

ANSWER_WAIT_S = 60.0
# The served log-probs' largest gap and the served tokens' gap below the
# reference's best: read for the limits' documentation (the calibration
# tool sets this), compared by no limit.
EXTRA_READINGS = False


class Recorder:
    """What the batcher calls as its engine: the real engine's
    ``transcribe``, timed, with the log-probs of sampled requests kept."""

    def __init__(self, engine: InferenceEngine, request_of: Dict[int, int], sampled: set,
                 trace: bool):
        self.engine = engine
        self.request_of = request_of  # id of a request's array → request number
        self.sampled = sampled
        self.trace = trace
        self.calls: List[tuple] = []  # (start, end, rows, padded samples)
        self.call_cpu: List[float] = []  # the batcher thread's CPU seconds in each call
        self.kept: Dict[int, tuple] = {}  # request → (log-probs row, frames, padded samples, text)
        self._last = None
        decode = engine.decode

        def keeping_decode(log_probs, out_lengths, decoder=None):
            self._last = (log_probs, out_lengths)
            return decode(log_probs, out_lengths, decoder)

        engine.decode = keeping_decode

    def transcribe(self, arrays):
        c0, t0 = time.thread_time(), time.perf_counter()
        with span("engine_call", self.trace):
            hyps = self.engine.transcribe(arrays)
        t1 = time.perf_counter()
        self.call_cpu.append(time.thread_time() - c0)
        padded = traffic.round_up(max(len(a) for a in arrays), SAMPLE_BUCKET)
        self.calls.append((t0, t1, len(arrays), padded))
        lp, lens = self._last
        for row, a in enumerate(arrays):
            req = self.request_of.get(id(a))
            if req in self.sampled:
                self.kept[req] = (lp[row], lens[row], padded, hyps[row])
        return hyps


def warm_shapes(engine: InferenceEngine, pool: List[np.ndarray]) -> None:
    """Every padded shape the traffic can form: each batch bucket at each
    length bucket from the shortest request's to the longest's."""
    lens = [len(a) for a in pool]
    longest = pool[int(np.argmax(lens))]
    lo = traffic.round_up(min(lens), SAMPLE_BUCKET)
    for L in range(lo, traffic.round_up(max(lens), SAMPLE_BUCKET) + 1, SAMPLE_BUCKET):
        a = np.zeros((L, longest.shape[1]), np.float32)
        a[: min(L, len(longest))] = longest[:L]
        for b in BATCH_BUCKETS:
            engine.transcribe([a] * b)


class Window:
    """One stretch of open-loop arrivals: dispatch on schedule, each request
    through ``MicroBatcher.submit`` on a client thread."""

    def __init__(self, batcher: MicroBatcher, arrays: List[np.ndarray], due: np.ndarray,
                 clients: int):
        self.batcher = batcher
        self.arrays = arrays
        self.due = due
        self.done = np.full(len(due), np.nan)
        self.text: List = [None] * len(due)
        self.pool = ThreadPoolExecutor(max_workers=clients)
        self.futures = []

    def _client(self, i: int) -> None:
        text = self.batcher.submit(self.arrays[i], timeout=ANSWER_WAIT_S + 30)
        if not isinstance(text, str):
            raise RuntimeError(f"request {i} was answered with {text!r}")
        self.text[i] = text
        self.done[i] = time.perf_counter()

    def dispatch(self, t0: float) -> None:
        for i, d in enumerate(self.due):
            wait = t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.futures.append(self.pool.submit(self._client, i))

    def finish(self, deadline: float) -> int:
        """Waits for every answer until ``deadline``; returns how many never came."""
        missing = 0
        for f in self.futures:
            try:
                f.result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:  # a timed-out or failed request is one that never came
                missing += 1
        self.pool.shutdown(wait=False, cancel_futures=True)
        return missing


def run(ctx) -> Dict:
    dev, cfg, cell, seed = ctx.device, ctx.cfg, ctx.cell, ctx.seed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    v = cfg["vocab"]
    vocab = Vocab(tokens=list(v["tokens"]), pad_id=v["pad_id"], blank_id=v["blank_id"],
                  unk_id=v["unk_id"])
    layout = ref_model.param_layout(cfg, len(vocab.tokens))
    with torch.device(dev):  # built where it serves, then the seeded weights loaded
        engine = InferenceEngine(cfg, weights.make(layout, seed, dev), vocab,
                                 decoder=cell["decoder"], device=dev)
    pool = traffic.serve_pool(cell, seed, dev)
    due, picks = traffic.arrivals(cell["rate_per_s"], ctx.seconds, len(pool), seed)
    arrays = [pool[k][:] for k in picks]  # one array object a request
    sampled = set(sample_requests(arrays, cell["check_requests"], seed).tolist())
    rec = Recorder(engine, {id(a): i for i, a in enumerate(arrays)}, sampled, ctx.trace)
    warm_shapes(engine, pool)
    batcher = MicroBatcher(rec, max_batch=cell["max_batch"], max_wait_ms=cell["max_wait_ms"])
    ctx.settle()
    setup_s = time.perf_counter() - ctx.t_start

    win = Window(batcher, arrays, due, cell["clients"])
    before = (batcher.batches_run, batcher.items_run)
    probe = HostProbe().start()
    t0 = time.perf_counter()
    win.dispatch(t0)
    t_close = t0 + ctx.seconds
    time.sleep(max(0.0, t_close - time.perf_counter()))
    host = probe.stop(close_probe=False)
    occupancy = (batcher.batches_run - before[0], batcher.items_run - before[1])
    missing = win.finish(t_close + ANSWER_WAIT_S)
    host["probe_close_ms"] = cpu_probe_ms()
    calls = [c for c in rec.calls if c[0] < t_close]
    host.update(engine_wall_s=sum(t1 - t0_ for t0_, t1, _, _ in calls),
                engine_cpu_s=sum(rec.call_cpu[:len(calls)]), engine_calls=float(len(calls)))

    trace, traced_calls = None, []
    if ctx.trace:
        prof = Profiler(ctx.out_dir / "trace.json", dev)

        def stretch(seconds: float, key: int):
            def arrivals():
                d, picks = traffic.arrivals(cell["rate_per_s"], seconds, len(pool), seed, key)
                w = Window(batcher, [pool[k][:] for k in picks], d, cell["clients"])
                t1 = time.perf_counter()
                w.dispatch(t1)
                w.finish(t1 + seconds + ANSWER_WAIT_S)
            return arrivals

        n_before = len(rec.calls)
        trace = {"device": prof.trace(stretch(cell["trace_seconds"], 1), host=False)}
        traced_calls = rec.calls[n_before:]
        trace["host"] = prof.trace(stretch(cell["label_seconds"], 2), host=True)
    batcher.shutdown()
    memory = ctx.memory_peak()

    lat = win.done - (t0 + due)
    lat = np.where(np.isnan(lat), t_close + ANSWER_WAIT_S - (t0 + due), lat) * 1e3
    served = {i: (lp.float().cpu(), int(n), padded, text)
              for i, (lp, n, padded, text) in rec.kept.items()}
    readings = serving_readings(cfg, vocab, calls, traced_calls, occupancy)
    rec = engine = batcher = win = None
    gc.collect()
    ctx.free()
    checks = compare(cfg, vocab, served, arrays, seed, dev)
    checks["unanswered"] = float(missing)
    return {
        "e2e": {"serve_p95_ms": quantile(lat, 0.95), "serve_p50_ms": quantile(lat, 0.5),
                "setup_s": setup_s},
        "attempted": len(due), "failed": int(missing), "checks": checks,
        "memory_peak_bytes": memory, "trace": trace, "readings": readings, "host": host,
    }


def quantile(x: np.ndarray, q: float) -> float:
    return float(np.quantile(np.asarray(x, np.float64), q))


def sample_requests(arrays: List[np.ndarray], n: int, seed: int) -> np.ndarray:
    """The requests the check reads: the longest ones, then a seeded draw."""
    lens = np.asarray([len(a) for a in arrays])
    longest = np.flatnonzero(lens == lens.max())[:4]
    rest = np.setdiff1d(np.arange(len(arrays)), longest)
    drawn = traffic.rng(seed, 12).choice(rest, size=min(n - len(longest), len(rest)),
                                         replace=False)
    return np.concatenate([longest, drawn])


def serving_readings(cfg, vocab, calls, traced_calls, occupancy) -> Dict:
    dims = ref_model.encoder_dims(cfg)
    femg = cfg["features"]["emg"]

    def frames(padded):
        return ref_feat.frame_count(padded, femg["n_fft"], femg["hop_length"])

    def bucket(rows):
        return next((b for b in BATCH_BUCKETS if b >= rows), rows)

    bf16 = dims["dtype"] == torch.bfloat16
    attn = 0.0
    if cfg["model"]["encoder"].get("attention_impl", "flax") == "fused":
        for _, _, rows, padded in traced_calls:
            T = flops.subsampled(frames(padded), dims["sub"])
            attn += dims["layers"] * flops.attention_least_s(
                bucket(rows), dims["heads"], T, dims["d"] // dims["heads"], False, False,
                elem_bytes=2 if bf16 else 4,
                peak=flops.PEAK_FLOPS["bfloat16" if bf16 else "float32"])
    return {
        "occupancy": occupancy,
        "call_ms": [(t1 - t0) * 1e3 for t0, t1, _, _ in calls],
        "flops": sum(flops.forward_flops(dims, bucket(r), frames(p), len(vocab.tokens), False)
                     for _, _, r, p in calls),
        "call_s": sum(t1 - t0 for t0, t1, _, _ in calls),
        "peak_flops": flops.PEAK_FLOPS[cfg["model"]["encoder"].get("compute_dtype", "float32")],
        "attention_least_s": attn,
    }


def reference_log_probs(cfg: Dict, p, arrays: List[np.ndarray], paddeds: List[int], dev,
                        quant=None) -> List[torch.Tensor]:
    """The plain reference's log-probs of each request alone, padded as its
    batch was (padding past a request changes none of its frames)."""
    femg = cfg["features"]["emg"]
    out = []
    with torch.no_grad():
        for a, padded in zip(arrays, paddeds):
            x = np.zeros((1, padded, a.shape[1]), np.float32)
            x[0, :len(a)] = a
            emg = torch.from_numpy(x).to(dev)
            n = torch.tensor([len(a)], device=dev)
            feats, frames = ref_feat.logmel(emg, n, femg["sample_rate"], femg["n_fft"],
                                            femg["hop_length"], femg["n_mels"])
            lp, lens = ref_model.log_probs(cfg, p, feats, frames, quant)
            out.append(lp[0, : int(lens[0])].float().cpu())
    return out


def token_gaps(ref_lp: List[torch.Tensor], tokens: List[torch.Tensor]) -> float:
    """The widest gap by which a served frame's token lies below the
    reference's best at that frame."""
    gap = 0.0
    for lp, tok in zip(ref_lp, tokens):
        best = lp.max(dim=-1).values
        gap = max(gap, float((best - lp.gather(1, tok[:, None].long())[:, 0]).max()))
    return gap


def lp_gaps(ref_lp: List[torch.Tensor], got: List[torch.Tensor]) -> Dict[str, float]:
    """The largest and the mean absolute gap between served and reference
    log-probs over every valid frame and token."""
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(got, ref_lp)])
    return {"lp_max": float(diff.max()), "lp_mean": float(diff.mean())}


def compare(cfg, vocab, served: Dict[int, tuple], arrays, seed, dev) -> Dict[str, float]:
    """``lp_mean``: the mean absolute gap of the served log-probs;
    ``text_mismatch``: requests whose text is not the greedy read-out of the
    tokens the engine served. With ``EXTRA_READINGS``, also ``lp_max`` and
    ``token_gap`` (the served tokens against the reference's log-probs)."""
    order = sorted(served)
    p = weights.make(ref_model.param_layout(cfg, len(vocab.tokens)), seed, dev)
    ref_lp = reference_log_probs(cfg, p, [arrays[i] for i in order],
                                 [served[i][2] for i in order], dev)
    tokens, mismatch = [], 0
    for i in order:
        lp, n, _, text = served[i]
        tok = lp[:n].argmax(dim=-1)
        tokens.append(tok)
        ids = ref_feat.collapse(tok.numpy(), vocab.blank_id)
        mismatch += int(text != "".join(vocab.tokens[t] for t in ids if t != vocab.pad_id))
    gaps = lp_gaps(ref_lp, [served[i][0][: served[i][1]] for i in order])
    out = {"lp_mean": gaps["lp_mean"], "text_mismatch": float(mismatch)}
    if EXTRA_READINGS:
        out.update(lp_max=gaps["lp_max"], token_gap=token_gaps(ref_lp, tokens))
    return out


def reading_control(ctx) -> Dict[str, float]:
    """The control's reading of the cell's sampled requests: the engine
    with the program's own int8 path switched on (the precision below bf16)
    puts its first token at each frame, and the reference says how far
    below its best that token lies. Each request is padded to its own
    length bucket. ``token_gap_fp8`` is the same for the reference in fp8."""
    from benchmark.reference.lowp import fp8

    dev, cfg, cell, seed = ctx.device, ctx.cfg, ctx.cell, ctx.seed
    v = cfg["vocab"]
    vocab = Vocab(tokens=list(v["tokens"]), pad_id=v["pad_id"], blank_id=v["blank_id"],
                  unk_id=v["unk_id"])
    layout = ref_model.param_layout(cfg, len(vocab.tokens))
    pool = traffic.serve_pool(cell, seed, dev)
    due, picks = traffic.arrivals(cell["rate_per_s"], ctx.seconds, len(pool), seed)
    arrays = [pool[k] for k in picks]
    chosen = [arrays[i] for i in sample_requests(arrays, cell["check_requests"], seed)]
    paddeds = [traffic.round_up(len(a), SAMPLE_BUCKET) for a in chosen]
    low = InferenceEngine(cfg, weights.make(layout, seed, dev), vocab, decoder=cell["decoder"],
                          device=dev, quantize="int8")
    tokens, lps = [], []
    for a in chosen:
        lp, lens = low.forward([a])
        lps.append(lp[0, : int(lens[0])].float().cpu())
        tokens.append(lps[-1].argmax(dim=-1))
    low = None
    ctx.free()
    p = weights.make(layout, seed, dev)
    want = reference_log_probs(cfg, p, chosen, paddeds, dev)
    fp8_lp = reference_log_probs(cfg, p, chosen, paddeds, dev, quant=fp8)
    return {"token_gap": token_gaps(want, tokens), **lp_gaps(want, lps),
            "token_gap_fp8": token_gaps(want, [lp.argmax(dim=-1) for lp in fp8_lp]),
            **{k + "_fp8": v for k, v in lp_gaps(want, fp8_lp).items()}}
