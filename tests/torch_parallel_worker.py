"""Rank workers for the port's multi-process tests: gloo on the CPU, a
``file://`` store in the test's own directory (no TCP port, so parallel
test workers cannot collide). Imports neither JAX nor ``ssd_tpu``.

:func:`run_group` saves a spec of jobs, starts ``world`` processes of

    python -m tests.torch_parallel_worker WORKDIR

with torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE``, waits for them and returns each rank's results. Every
rank runs the jobs in order, in one process group:

* ``step``: a model from a ``state_dict``, placed by ``shard_model`` on
  the job's ``parallel:`` block (``pipeline_microbatches`` included, each
  data rank's rows padded to a multiple of it; ``foreach``: AdamW's
  multi-tensor path, as on the card), through micro-steps of the trainer's
  ``make_train_step`` on the job's node batches; the losses, the first
  micro-step's synced gradients (taken as the optimizer steps) and the
  final parameters and buffers, all unsharded;
* ``train``: ``train_from_config(..., device="cpu")``; its summary;
* ``writes``: ``train`` with each checkpoint write recorded; its summary
  and, in ``writes``, each write's thread name, epoch and ``is_best``; a
  copy of the n-th write's files in ``<run_dir>/kept/<n>/``;
* ``preempt``: ``train`` with the stop flag raised on rank
  ``job["signalled"]`` alone, after its first train step (past the
  epoch's in-epoch agreement at batch 0: a signal that reaches one rank
  late); its summary, and the epoch, step and update count of the
  ``last`` it left;
* ``halo``: ``collectives.halo`` on this rank's T-shard of a (3, T, 4)
  ramp, and its backward of a ramp of this rank's own;
* ``pipeline_errors``: the GPipe placement of a stack the stages do not
  divide, and a pipelined forward of rows the microbatches do not divide;
  each ``ValueError``'s message.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def run_group(jobs: List[Dict[str, Any]], workdir: Path, world: int = 2,
              timeout: float = 300.0) -> Dict[str, Any]:
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(jobs, workdir / "jobs.pt")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=str(REPO), WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(workdir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", str(workdir)],
            cwd=REPO, env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
            stdout=log, stderr=subprocess.STDOUT), log))
    try:
        codes = [p.wait(timeout=timeout) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if any(codes):
        logs = "\n".join((workdir / f"rank{r}.log").read_text()[-4000:] for r in range(world))
        raise RuntimeError(f"rank exit codes {codes}:\n{logs}")
    return [torch.load(workdir / f"results{r}.pt", weights_only=False) for r in range(world)]


def _step_job(job: Dict[str, Any]) -> Dict[str, Any]:
    from ssd_tpu_torch.models.ssd_model import build_model
    from ssd_tpu_torch.parallel.mesh import ParallelContext, RowSplit, mesh_from_config
    from ssd_tpu_torch.parallel.partition import (
        full_state_dict, gather_for, grad_norm_fn, shard_model)
    from ssd_tpu_torch.training import train as ttrain
    from ssd_tpu_torch.training.schedules import build_optimizer

    cfg, par = job["cfg"], job["parallel"]
    model = build_model(cfg, input_dim=job["input_dim"], vocab_size=job["vocab"])
    model.load_state_dict(job["state_dict"])
    mesh = mesh_from_config({"parallel": par}, device_type="cpu")
    ctx = ParallelContext.from_mesh(mesh, sequence=par.get("sequence", False),
                                    fsdp=par.get("fsdp", False),
                                    pipeline=par.get("pipeline_microbatches", 0))
    shard_model(model, ctx)
    names = [n for n, _ in model.named_parameters()]
    opt, _ = build_optimizer(cfg, [p for _, p in model.named_parameters()], 10,
                             grad_norm_fn(model))
    if job.get("foreach"):  # AdamW's multi-tensor path, its default on the card
        for group in opt.adamw.param_groups:
            group["foreach"] = True
    out: Dict[str, Any] = {"losses": [], "grads": None}
    step_opt = opt.step

    def capture_then_step():
        if out["grads"] is None:
            out["grads"] = {n: gather_for(model, n, p.grad)
                            for n, p in zip(names, model.parameters())}
        return step_opt()

    opt.step = capture_then_step
    state = ttrain.TrainState(model=model, optimizer=opt)
    train_step = ttrain.make_train_step(job["blank"], False, par=ctx)
    split = RowSplit(local_data=ctx.data, local_index=ctx.data_rank,
                     microbatches=max(1, par.get("pipeline_microbatches", 0)))
    for batch in job["batches"]:
        rows = split.take(batch, batch["emg"].shape[0])
        tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in rows.items()}
        state, losses = train_step(state, tb, job["lambdas"], None)
        out["losses"].append({k: float(v) for k, v in losses.items()})
    out["state"] = full_state_dict(model)
    out["mini_step"] = opt.mini_step
    out["update_count"] = opt.update_count
    return out


def _train_job(job: Dict[str, Any]) -> Dict[str, Any]:
    from ssd_tpu_torch.training import train as ttrain

    return ttrain.train_from_config(job["cfg"], Path(job["run_dir"]), device="cpu",
                                    resume=job.get("resume", False),
                                    overfit_batches=job.get("overfit_batches", 0))


def _writes_job(job: Dict[str, Any]) -> Dict[str, Any]:
    import threading
    from unittest import mock

    from ssd_tpu_torch.training import checkpoint as ckpt

    writes = []
    real = ckpt._write_payload

    def write(run_dir, payload, cfg_text, is_best):
        real(run_dir, payload, cfg_text, is_best)
        for name in ("last", "best") if is_best else ("last",):
            kept = run_dir / "kept" / str(len(writes)) / name
            kept.mkdir(parents=True)
            shutil.copy(run_dir / name / ckpt.MODEL_FILE, kept / ckpt.MODEL_FILE)
        writes.append((threading.current_thread().name, payload.get("epoch"), is_best))

    with mock.patch.object(ckpt, "_write_payload", write):
        summary = _train_job(job)
    return dict(summary, writes=writes)


def _preempt_job(job: Dict[str, Any]) -> Dict[str, Any]:
    from unittest import mock

    import torch.distributed as dist

    from ssd_tpu_torch.training import train as ttrain
    from ssd_tpu_torch.training.checkpoint import load_checkpoint

    guards = []

    class Guard(ttrain.PreemptionGuard):
        def __enter__(self):
            guards.append(self)
            return super().__enter__()

    make = ttrain.make_train_step

    def make_signalled(*args, **kwargs):
        step = make(*args, **kwargs)

        def signalled(state, *rest):
            out = step(state, *rest)
            if dist.get_rank() == job["signalled"]:
                guards[-1].requested = True
            return out

        return signalled

    with mock.patch.object(ttrain, "PreemptionGuard", Guard), \
            mock.patch.object(ttrain, "make_train_step", make_signalled):
        summary = _train_job(job)
    last = load_checkpoint(Path(job["run_dir"]) / "last")
    summary["last"] = (last["epoch"], last["step"], last["optimizer"]["update_count"])
    return summary


def _pipeline_errors_job(job: Dict[str, Any]) -> Dict[str, Any]:
    from ssd_tpu_torch.models.ssd_model import build_model
    from ssd_tpu_torch.parallel.mesh import ParallelContext, mesh_from_config
    from ssd_tpu_torch.parallel.partition import shard_model

    par = job["parallel"]
    mesh = mesh_from_config({"parallel": par}, device_type="cpu")
    ctx = ParallelContext.from_mesh(mesh, pipeline=par["pipeline_microbatches"])
    out = {}
    for name, cfg, rows in (("layers", job["cfg_odd_layers"], 4), ("rows", job["cfg"], 3)):
        model = build_model(cfg, input_dim=job["input_dim"], vocab_size=job["vocab"])
        try:
            shard_model(model, ctx)
            model(torch.zeros(rows, 16, job["input_dim"]), torch.full((rows,), 16))
        except ValueError as e:
            out[name] = str(e)
    return out


def _halo_job(job: Dict[str, Any]) -> Dict[str, Any]:
    import torch.distributed as dist

    from ssd_tpu_torch.parallel import collectives as col

    rank, ts, h = dist.get_rank(), job["ts"], job["h"]
    full = torch.arange(3 * ts * dist.get_world_size() * 4, dtype=torch.float32)
    full = full.reshape(3, -1, 4)
    x = full[:, rank * ts:(rank + 1) * ts].clone().requires_grad_(True)
    y = col.halo(x, h, dist.group.WORLD)
    gy = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) + 1000 * rank
    y.backward(gy)
    return {"y": y.detach(), "contiguous": y.is_contiguous(), "gy": gy, "gx": x.grad}


JOBS = {"step": _step_job, "train": _train_job, "writes": _writes_job, "preempt": _preempt_job,
        "halo": _halo_job, "pipeline_errors": _pipeline_errors_job}


def main(workdir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    workdir = Path(workdir)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'store'}", rank=rank,
                            world_size=world)
    try:
        results = {}
        for job in torch.load(workdir / "jobs.pt", weights_only=False):
            results[job["name"]] = JOBS[job["kind"]](job)
        torch.save(results, workdir / f"results{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
