"""Training cells: the trainer's own step, fed as its epoch loop feeds it.

Set-up builds one ``TrainState`` (the program's model with the benchmark's
seeded weights, its clip + AdamW + schedule, its dropout generator) and one
step function, ``to_device(batch_to_arrays(batch))`` then ``train_step``,
over a ring of collated batches made from the seed. It runs one pass over
the ring (every shape the window will see), and the first three of those
steps are the ones the reference follows. The window then keeps stepping
the same state along the ring with no sync until ``--seconds`` have passed,
and one ``synchronize`` closes it. A traced run profiles stated numbers of
further steps after the window (device alone, then with the host's
operators), each once two untraced steps have refilled the queue.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import flops, traffic, weights
from benchmark.harness.host import HostProbe
from benchmark.harness.trace import Profiler, span
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.reference.features import pad_batch
from benchmark.reference.lowp import control
from ssd_tpu_torch.data.dataset import collate
from ssd_tpu_torch.data.vocab import Vocab
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.ops.featurizer import FeaturizerConfig
from ssd_tpu_torch.parallel.partition import grad_norm_fn
from ssd_tpu_torch.training.schedules import build_optimizer
from ssd_tpu_torch.training.train import (
    TrainState,
    _augment_cfgs,
    _deterministic_cudnn,
    batch_to_arrays,
    make_train_step,
    to_device,
)

CHECK_STEPS = 3


def time_bucket(cfg: Dict) -> int:
    """The loader's time padding: 128 frames, in samples for raw EMG."""
    raw = cfg["data"].get("train_from_raw", False)
    return 128 * (cfg["features"]["emg"]["hop_length"] if raw else 1)


def host_aug(cfg: Dict):
    """The SpecAugment the loader applies on the host (cached features),
    or None where the step applies it on the device (raw EMG)."""
    spec = cfg.get("augmentation", {}).get("specaugment")
    on_device = cfg["data"].get("train_from_raw", False) or cfg.get("augmentation", {}).get(
        "on_device", False)
    return None if on_device or not spec or spec.get("p", 0) <= 0 else spec


class Setup:
    """The cell's traffic and the program's training state, built from the seed."""

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, cell, dev, seed = ctx.cfg, ctx.cell, ctx.device, ctx.seed
        v = cfg["vocab"]
        self.vocab = Vocab(tokens=list(v["tokens"]), pad_id=v["pad_id"], blank_id=v["blank_id"],
                           unk_id=v["unk_id"])
        self.items = traffic.train_items(cell, cfg, self.vocab.tokens, seed, dev)
        self.bucket = time_bucket(cfg)
        self.groups = traffic.ring_groups([len(it["emg"]) for it in self.items],
                                          cell["batch_size"], self.bucket, traffic.rng(seed, 8))
        spec_cfg, chan_cfg = _augment_cfgs(cfg)
        on_host = host_aug(cfg) is not None
        self.ring = [
            collate([self.items[i] for i in g], self.vocab,
                    spec_augment_cfg=spec_cfg if on_host else None,
                    rng=traffic.rng(seed, 9, k), time_bucket=self.bucket,
                    teacher_dtype=cfg["data"].get("teacher_dtype", "float32"),
                    emg_dtype=cfg["data"].get("emg_dtype", "float32"))
            for k, g in enumerate(self.groups)
        ]
        self.walk = traffic.walk(len(self.ring), traffic.rng(seed, 10))
        self.layout = ref_model.param_layout(cfg, len(self.vocab.tokens))
        w0 = weights.make(self.layout, seed, dev)
        with torch.device(dev):  # built where it trains, then the seeded weights loaded
            model = build_model(cfg, input_dim=cfg["model"]["encoder"]["input_dim"],
                                vocab_size=len(self.vocab.tokens))
        model.load_state_dict(w0)
        self.names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        optimizer, _ = build_optimizer(cfg, params, cell["total_updates"], grad_norm_fn(model))
        self.state = TrainState(model=model, optimizer=optimizer)
        self.generator = torch.Generator(dev).manual_seed(traffic.sub_seed(seed, 11))
        featurize = FeaturizerConfig.from_config(cfg) if cfg["data"].get("train_from_raw") else None
        augment = None
        if featurize is not None and (spec_cfg is not None or chan_cfg is not None):
            augment = (spec_cfg, chan_cfg, int(cfg["features"]["emg"]["n_mels"]))
        self.train_step = make_train_step(self.vocab.blank_id,
                                          bool(cfg["loss"].get("distill_normalize", False)),
                                          augment, featurize, None)
        self.lambdas = list(ref_train.lambdas(cfg))
        self.w0 = w0

    def step(self, k: int) -> torch.Tensor:
        """The window's call: ring batch ``k`` to the device, one train step."""
        on = self.ctx.trace
        with span("to_device", on):
            arrays = to_device(batch_to_arrays(self.ring[k], True), self.ctx.device)
        with span("train_step", on):
            self.state, losses = self.train_step(self.state, arrays, self.lambdas, self.generator)
        return losses["total"]

    def first_pass(self) -> Dict[str, list]:
        """One pass over the ring; the program's readings of its first steps:
        losses, each leaf's first gradient (AdamW's first moment after one
        step over 1 − b1) and each leaf's change after three."""
        opt = self.state.optimizer
        params = opt.params
        read: Dict[str, list] = {"order": [], "loss": []}
        for i in range(len(self.ring)):
            k = next(self.walk)
            read["order"].append(k)
            total = self.step(k)
            if i < CHECK_STEPS:
                read["loss"].append(total)
            if i == 0:  # a moment the optimizer never made reads as no gradient
                m = [opt.adamw.state.get(p, {}).get("exp_avg", torch.zeros_like(p)) for p in params]
                read["grad_norm"] = torch.stack(torch._foreach_norm(m)) / (1 - ref_train.BETAS[0])
            if i == CHECK_STEPS - 1:
                read["change_norm"] = torch.stack(
                    [(p.detach() - self.w0[n]).norm() for n, p in zip(self.names, params)])
                self.w0 = None
        read["loss"] = [float(t) for t in read["loss"]]
        read["grad_norm"] = read["grad_norm"].tolist()
        read["change_norm"] = read["change_norm"].tolist()
        return read


def input_frames(cfg: Dict, emg: np.ndarray) -> int:
    """Feature frames of a padded batch: its time axis, or the log-mel's
    frames of its padded raw samples."""
    if not cfg["data"].get("train_from_raw", False):
        return emg.shape[1]
    femg = cfg["features"]["emg"]
    return 1 + (emg.shape[1] - femg["n_fft"]) // femg["hop_length"]


def step_flops(setup: Setup, k: int) -> int:
    """Model operations of one step on ring batch ``k``: 3 × the forward at
    its padded shapes."""
    cfg, emg = setup.ctx.cfg, setup.ring[k].emg
    return 3 * flops.forward_flops(ref_model.encoder_dims(cfg), emg.shape[0],
                                   input_frames(cfg, emg), len(setup.vocab.tokens), True)


def attention_work(setup: Setup, k: int) -> float:
    """Least seconds of the fused attention calls in one step on ring batch
    ``k`` (forward and backward in every block); 0 where the configuration
    does not run the fused kernels."""
    cfg, emg = setup.ctx.cfg, setup.ring[k].emg
    if cfg["model"]["encoder"].get("attention_impl", "flax") != "fused":
        return 0.0
    dims = ref_model.encoder_dims(cfg)
    T = flops.subsampled(input_frames(cfg, emg), dims["sub"])
    bf16 = dims["dtype"] == torch.bfloat16
    one = flops.attention_least_s(
        emg.shape[0], dims["heads"], T, dims["d"] // dims["heads"], True, dims["dropout"] > 0,
        elem_bytes=2 if bf16 else 4,
        peak=flops.PEAK_FLOPS["bfloat16" if bf16 else "float32"])
    return dims["layers"] * one


def reference_readings(setup: Setup, order: List[int], quant=None) -> Dict[str, list]:
    """The plain reference over the same first steps, from the same seed."""
    ctx = setup.ctx
    cfg, dev = ctx.cfg, ctx.device
    p = {n: t.clone() for n, t in weights.make(setup.layout, ctx.seed, dev).items()}
    gen = torch.Generator(dev).manual_seed(traffic.sub_seed(ctx.seed, 11))
    aug = host_aug(cfg)
    batches = []
    for k in order[:CHECK_STEPS]:
        items = [setup.items[i] for i in setup.groups[k]]
        b = pad_batch(items, setup.vocab.pad_id, setup.bucket, aug, traffic.rng(ctx.seed, 9, k))
        batches.append(ref_train.to_tensors(b, dev, cfg["data"].get("teacher_dtype", "float32")))
    return ref_train.train_steps(cfg, p, batches, setup.vocab.blank_id, gen, quant)


def compare(prog: Dict[str, list], want: Dict[str, list], names: List[str]) -> Dict[str, float]:
    """The numbers ``correct`` compares: the worst step's relative loss gap,
    and the worst leaf's gap of first-gradient norms and of change norms.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of both (rounding alone moves them)."""
    pos = {n: i for i, n in enumerate(names)}
    idx = [pos[n] for n in want["names"]]
    g_p = [prog["grad_norm"][i] for i in idx]
    c_p = [prog["change_norm"][i] for i in idx]
    med = float(np.median(want["grad_norm"]))
    keep = [g >= 1e-3 * med for g in want["grad_norm"]]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], want["loss"]))
    return {"loss_gap": loss,
            "grad_gap": ref_train.leaf_gap(g_p, want["grad_norm"], keep),
            "change_gap": ref_train.leaf_gap(c_p, want["change_norm"], keep)}


def run(ctx) -> Dict:
    dev = ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = ctx.cell
    with _deterministic_cudnn(dev):
        setup = Setup(ctx)
        prog = setup.first_pass()
        ctx.settle()
        setup_s = time.perf_counter() - ctx.t_start

        totals, host_ms, ks = [], [], []
        probe = HostProbe().start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            k = next(setup.walk)
            h = time.perf_counter()
            totals.append(setup.step(k))
            host_ms.append((time.perf_counter() - h) * 1e3)
            ks.append(k)
        ctx.sync()
        window_s = time.perf_counter() - t0
        host = dict(probe.stop(), step_host_ms_p50=float(np.median(host_ms)) if host_ms else 0.0)

        trace, traced = None, []

        def stretch(n: int, keep: list):
            def steps():
                for _ in range(n):
                    keep.append(next(setup.walk))
                    setup.step(keep[-1])
            return steps

        if ctx.trace:
            prof = Profiler(ctx.out_dir / "trace.json", dev)
            for _ in range(2):  # the queue refilled, as in the window
                setup.step(next(setup.walk))
            trace = {"device": prof.trace(stretch(cell["trace_steps"], traced), host=False)}
            for _ in range(2):
                setup.step(next(setup.walk))
            trace["host"] = prof.trace(stretch(cell["label_steps"], []), host=True)
    memory = ctx.memory_peak()
    failed = int((~torch.isfinite(torch.stack(totals))).sum()) if totals else 0
    peak = flops.PEAK_FLOPS[ctx.cfg["model"]["encoder"].get("compute_dtype", "float32")]
    readings = {
        "host_ms": host_ms, "window_s": window_s, "peak_flops": peak,
        "flops": sum(step_flops(setup, k) for k in ks),
        "attention_least_s": sum(attention_work(setup, k) for k in traced),
    }
    setup.state = setup.ring = totals = None
    gc.collect()
    ctx.free()
    want = reference_readings(setup, prog["order"])
    return {
        "e2e": {"train_utt_per_s": len(ks) * cell["batch_size"] / window_s, "setup_s": setup_s},
        "attempted": len(ks), "failed": failed, "checks": compare(prog, want, setup.names),
        "memory_peak_bytes": memory, "trace": trace, "readings": readings, "host": host,
    }


def reading_control(ctx) -> Dict[str, float]:
    """The control's readings (the reference one precision below the
    configuration's, in the program's place) against the reference, over the
    same first steps; no window."""
    setup = Setup(ctx)
    order = [next(setup.walk) for _ in range(CHECK_STEPS)]
    setup.state = setup.ring = None
    ctx.free()
    want = reference_readings(setup, order)
    quant, scope = control(ctx.cfg["model"]["encoder"].get("compute_dtype", "float32"))
    with scope:
        low = reference_readings(setup, order, quant)
    return compare({"loss": low["loss"], "grad_norm": low["grad_norm"],
                    "change_norm": low["change_norm"]}, want, low["names"])
