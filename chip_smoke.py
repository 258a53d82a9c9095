#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and evaluation paths on one
CUDA card and check them.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); builds every kernel of the
paths from ``ssd_tpu_torch/csrc`` itself (one nvcc per source, started
together). Imports nothing of JAX or of the JAX package. Phases, each
failing loudly:

1. build   — compile ``csrc/logmel.cu``, ``csrc/ctc.cu``,
             ``csrc/attention.cu`` and ``csrc/depthwise_conv.cu`` (with the
             attention and depthwise kernels' bf16 instances) for sm_90a;
             print the build times, ptxas's registers and spills per kernel,
             the card's name and power limit, and PyTorch's TF32 settings
             (off for matmuls and cuDNN for the whole run: the parity phases
             need fp32; the attention kernels' own products are 3×TF32,
             which keeps fp32 accuracy), and the build directory
             (``--compile-cache`` / ``$SSD_COMPILE_CACHE``, else
             ``ssd_tpu_torch/_build/``). Read ``configs/tpu_fast_plus.yaml``
             through the port's YAML reader, the configuration of every
             phase below.
2. kernel  — the log-mel kernel (a shared-memory FFT) against its plain
             PyTorch version at the serving buckets (B ∈ {1, 8}, 8 channels,
             4 000–12 000 valid samples in a 12 800-sample bucket):
             normalized features within atol = rtol = 1e-4; kernel, plain,
             ``torch.stft`` and whole ``logmel_batch`` times; the bound from
             the FFT plan's operations beside the Pallas cost estimate's
             dense-DFT one; the kernel must be ≥ 2× faster than the
             dense-DFT kernel's recorded times and faster than ``torch.stft``.
3. engine  — the full-width ``configs/tpu_fast_plus.yaml`` model (random
             flax-style weights from a seed) saved in the port's checkpoint
             format, loaded with ``InferenceEngine.from_checkpoint(...,
             device="cuda")``, transcribing batches of 1, 4 and 8 requests
             with greedy and beam-50 decoding.
4. server  — ``ssd_tpu_torch.serving.server`` in-process on a free port:
             three ``/transcribe`` requests, ``/stream/feed`` of an unknown
             session → 404 (phase 14 streams through the server).
   Launch counts are zeroed before phase 3 and read after phase 4: the
   kernel must have launched exactly once per ``transcribe``. Then the
   card's log-probs are held against the same engine on the CPU, and the
   card's greedy / beam text against the CPU decoders on the same log-probs.
5. latency — p50 per-utterance latency at B = 1 and B = 8, greedy and beam-50.
6. ctc kernels — the CTC α and β kernels against their plain versions on
             the card, at the config shape (B = 5, T' = 640, S = 160) and the
             flagship bench shape (B = 32, T' = 384, S = 128), each with an
             empty target, an impossible row and a row of repeated labels:
             α / β where finite within rtol 1e-5, per-sample loss rtol 1e-5,
             logits gradients atol 1e-5; values and logits gradients against
             ``F.ctc_loss`` too; whether α is bit-equal to the plain recursion,
             and β must be. Kernel, plain and ``F.ctc_loss`` times (its
             forward with the timing mode ``cuda_ms_mode`` chose); α and β
             must each be ≥ 1.25× faster than the shared-memory kernels'
             recorded times.
7. train   — a synthetic corpus (20 voiced utterances, cached features from
             the port's featurizer, WavLM-width teacher features, a JSONL
             index, ``configs/tpu_fast_plus.yaml`` with the corpus's data
             paths as the run's JSON config)
             trained by ``train_from_config(..., device="cuda")`` for one
             epoch of 2 overfit batches, from cached features and from raw
             EMG; then resumed for epoch 2; then served. Launch counts are
             zeroed before each run and read after it: α once per train and
             eval step, β once per train step, log-mel once per step in raw
             mode.
8. train parity — one full-width train step at B = 5 on the card and on the
             CPU from the same weights and batch (dropout 0, no
             augmentation): losses, every gradient and the updated batch
             statistics; then 20 steps on one batch must lower the loss.
9. train rate — step time p50 over 5 warm steps, split into forward +
             loss, backward and optimizer, utterances/s, and the CTC
             kernels' share of the step, at B = 5 (config) and B = 32;
             peak memory per shape; the profiler's device-busy share.
10. attention and depthwise kernels — the fused-attention forward and
             backward kernels and the depthwise stencil's forward and
             backward against their plain versions at the path's shapes
             (B = 8 / T' = 625, B = 5 / T' = 640, B = 32 / T' = 384; H 6,
             hd 48, C 288, K 15), random key lengths with one row of length
             1, with and without a dropout multiplier; padded keys' dk and
             dv exactly 0 and two backward runs bit-identical (attention and
             depthwise: dx, dw and db); kernel, plain and library times: SDPA
             pinned to its memory-efficient backend (forward; its backward
             alone, from the raw aten op on one untimed forward's output and
             log-sum-exp) and ``F.conv1d``; the depthwise op's whole backward
             (kernel and the sum of its partials) beside the earlier tree's
             recorded time, which it must beat; the depthwise forward
             bit-equal to its plain version (``torch.equal``), its CTA count
             printed, no slower than the tile kernel's recorded times at the
             serving and config shapes and ≥ 1.25× faster at the flagship.
             Attention bounds at the
             3×TF32 rate (3 × flops / 495 TFLOP/s) beside the fp32 SIMT one;
             each attention kernel must be ≥ 1.25× faster than the previous
             SIMT kernels' recorded times at the config and flagship shapes,
             and the depthwise backward kernel no slower than the tile
             kernel's at the config shape and ≥ 1.25× faster at the flagship.
11. fused/pallas — the same model with ``attention_impl: fused`` and
             ``depthwise_impl: pallas`` through every main path: (a) served
             by the engine (B = 1 and 8, greedy and beam-50) and three
             ``/transcribe`` requests, 6 attention- and 6 depthwise-forward
             launches per transcribe, log-probs against the CPU engine and
             against the default configuration on the same weights; (b)
             trained for one epoch of 2 overfit batches (6 launches of each
             kernel per step, backward kernels per train step only), then
             served; (c) phase 8's card-vs-CPU step and overfit; (d) phase
             9's rate with the four kernels' share of the step. Between (b)
             and (c), reproducible training: ``train_from_config`` twice from
             one seed in each configuration (2 epochs of 2 overfit batches,
             dropout and SpecAugment on; the second run with
             ``logging.async_checkpoints: true``), every logged loss and every
             tensor and counter of ``last`` and ``best`` (weights, AdamW
             moments) equal bit for bit and the cuDNN flags restored after. Phase 9 also prints
             what the trainer's cuDNN settings (deterministic, no autotune)
             cost the default flagship step (host p50 and device busy, off,
             on, on, off).
12. evaluate — ``ssd_tpu_torch.evaluation.evaluate.main`` in-process with
             ``--device cuda`` on phase 7's cached and raw checkpoints and
             phase 11b's fused/pallas one, greedy and beam-50, over the
             corpus's 4 val utterances in 2 batches: the three output files
             (``config_used.json`` equal to the checkpoint's config), launch
             counts zeroed before each run (log-mel once a batch in raw mode,
             attention and depthwise forward once a block and batch in the
             fused/pallas configuration, nothing else), the card's log-probs
             against a CPU forward of the same checkpoint and batches within
             phase 4's tolerance, the texts the decoder returned written to
             ``predictions.jsonl``, and greedy and beam-50 text equal to
             the port's CPU decoder on the card's log-probs (beam-50 gated
             since the beam breaks score ties as the JAX search does and
             adds no atomics: on these flat log-probs scores tie at the
             cut); WER / CER,
             utterances/s and decode p50 printed with the card's name and
             power limit.
13. LM fusion — a 5-gram built by
             ``ssd_tpu_torch.decoding.build_char_lm.main`` from a seeded
             stand-in for the reference's LM corpus (as many sentences as
             its voiced train + val transcripts, Zipf-drawn words) and
             loaded with ``load_packed_lm`` (writing its ``.packed.npz``
             sidecar); the table's lookups (hit, logprob, backoff) on the
             card ``torch.equal`` to the CPU's on every packed key and
             4 096 seeded misses; ``beam_search_lm_device`` at beam 50,
             top-k 16 on decisive log-probs of 8 corpus sentences, on the
             card under ``torch.cuda.set_sync_debug_mode("error")`` (no host
             sync inside it) and on the CPU: the same text, equal to the
             host search's and to the sentences, final scores within 1e-4;
             phase 11's fused/pallas checkpoint served with ``lm_path``:
             ``/transcribe`` at B = 1 and 8 (12 000 samples a request),
             launch counts zeroed before and read after (log-mel once,
             attention and depthwise forward once a block, a transcribe);
             the LM-fused beam-50 time of one ``engine.transcribe`` run
             beside the plain beam-50's at B = 1 and 8, the first LM run
             equal to the served reply (times recorded, not gated); the
             decode alone a frame, the LM search with its specialised
             backoff walk and with the generic one (equal text), and each
             search's profiler busy share; the eval CLI with ``--lm-path``
             on phase 7's cached checkpoint, ``--lm-backend device`` (beam
             50) and ``host`` (beam 8).
14. streaming and export — phase 11b's fused/pallas checkpoint: (a)
             ``ChunkedStreamingTranscriber`` on the card, a 5 000-sample
             stream that fits one window (S 512) with text equal to
             ``engine.transcribe`` and emitted log-probs within 2e-3 of the
             offline forward's; a 12 000-sample stream in 100-sample feeds
             at the default geometry (S 96, W 512, R 32: 640-frame windows,
             T′ 320) with 1 log-mel, 6 attention- and 6 depthwise-forward
             launches a window, held to the same stream on a CPU engine
             (log-probs within 2e-3, text equal), each window timed on the
             host clock after a sync and by CUDA events, each feed on the
             host clock; the same stream through ``/stream/start`` →
             ``/stream/feed`` → ``/stream/finish`` equal to the direct text,
             the finished session → 404; 4 concurrent sessions equal to one
             at a time. (b) ``export_checkpoint`` at buckets (1, 12 800) and
             (8, 12 800): 1 / 6 / 6 custom-op nodes in each graph and
             launches a call of the reloaded ``ExportedTranscriber``, its
             tokens and texts equal to the engine's greedy decode, its call
             p50 beside the eager ``engine.transcribe``'s. (c) each custom
             op's host time a call beside its wrapper's alone. It prints its
             sub-steps' seconds.
15. tpu_scaled_large in bf16 — ``configs/tpu_scaled_large.yaml`` through
             the port's YAML reader (d_model 768, 12 heads of hd 64, ffn
             3 072, ``compute_dtype: bfloat16``, ``remat``,
             ``scan_layers``, raw EMG, bf16 teacher features), cut in its
             ``parallel:`` section (one device: phase 18b runs it as
             shipped when there are two cards) and in depth, 4 of its 12
             blocks (``LARGE_BLOCKS``: the run's time budget; 166 M
             parameters at 12, which phase 21 serves), random seeded
             weights: (a) the
             bf16 instances of the attention and depthwise kernels against
             their plain bf16 versions at B = 32, T′ 384 (dropout
             multiplier) and B = 8, T′ 625 (H 12, hd 64, C 768, K 15): the
             depthwise forward and dx
             bit-equal, dw / db within 1e-4 and attention out / dq / dk /
             dv within 2⁻⁶ of each output's largest, the training forward's
             out its fp32 output (õ, the backward's D) rounded and equal to
             the serving forward's; times (the forward's training call at
             the train shape, with the serving call beside) next to the
             PR 10's recorded times and SDPA's bf16 efficient backend and a bf16 ``F.conv1d``;
             bounds at the dense bf16 tensor-core peak; (b) served in both configurations
             (as shipped, and ``attention_impl: fused`` + ``depthwise_impl:
             pallas``) through phase 3/4's counted run at B = 1 and 8
             (greedy, beam-50, three ``/transcribe``; 1 log-mel and, fused,
             a bf16 attention- and a depthwise-forward launch a block a
             call),
             card log-probs held to the CPU engine's and a one-window
             stream's to the offline forward within a bf16 tolerance with
             greedy tokens equal on decisive frames, an exported call
             (fused) with the engine's tokens, greedy p50; (c) trained by
             ``train_from_config`` on a synthetic raw-EMG corpus (2 steps of
             B = 32 on 768-frame buckets, 1 eval step; with remat the
             forward kernels launch twice a train step; the shipped
             ``logging.async_checkpoints: true`` honoured, as its log shows)
             and the fused checkpoint scored by the eval CLI; (d) step p50, device busy
             and peak memory with remat and without, and (fused) the
             trainer's loss, every gradient and running statistic with
             remat ``full`` and ``dots`` bit-equal to the step without,
             dropout 0.1; (e) a
             card-vs-CPU bf16 step at full width, depth cut to 2 blocks,
             B = 2. It prints its sub-steps' seconds.
16. quantized serving — (a) ``torch._int_mm`` through ``ops/quant.py``'s
             wrapper equal to its exact float64 twin at every eligible shape
             (w1, w2, pw1, pw2) of tpu_fast_plus and tpu_scaled_large at
             B = 1 and 8 (625 token rows a request) and at 5 rows (padded to
             17), timed beside ``torch.matmul`` in fp32 (TF32 off) and bf16;
             (b) tpu_fast_plus as shipped and fused/pallas with ``quantize:
             int8`` and ``int8_prequant``, each through phase 3/4's counted
             run (1 log-mel launch and 36 ``_int_mm`` calls a
             ``transcribe``; fused, 6 attention- and 6 depthwise-forward
             launches): block 0's four int8 Dense layers bit-equal card vs
             CPU on one input, the forward bit-equal with ``_int_mm`` and
             with the exact product, card vs CPU log-probs (mean gap within
             √2 × the CPU's own int8-vs-float gap: fp32 noise flips
             roundings), int8_prequant bit-equal to int8 on the card; (c)
             greedy p50 at B = 1 and 8, float, int8 and int8_prequant; (d) an
             exported int8_prequant call (36 ``aten._int_mm`` nodes, 36 int8
             buffers, the engine's tokens) and a two-window stream; (e)
             tpu_scaled_large in bf16 with int8_prequant at full width and
             depth, B = 8, against the bf16 float engine, p50 beside it.
17. data preparation — a synthetic corpus in the Gaddy & Klein layout (24
             voiced utterances with FLAC audio, one in four at 22.05 kHz, 8
             silent; 2–6 s of 8-channel 1 kHz EMG) through the port's CLIs
             on the card: ``index_dataset --stats --durations``;
             ``preprocessing --mode emg`` (one log-mel launch a batch), its
             caches equal to the same CLI with ``--device cpu`` (atol = rtol
             = 1e-4) and bit-equal with ``--no-double-buffer``;
             ``preprocessing --mode teacher`` with a random full-width WavLM
             Base+ (94 M parameters) written as a local safetensors file,
             the caches held to the CPU teacher and to per-utterance card
             runs (atol 2e-4, rtol 2e-3); utterances a second for each
             mode; then ``train_from_config`` (fused/pallas, 2 overfit
             batches: every fp32 kernel launches) and the eval CLI on the
             result. It prints its sub-steps' seconds.
18. parallelism — ``ssd_tpu_torch/parallel/`` on ``torch.distributed``:
             (a) the trainer CLI (``trainer.main``) under ``python -m
             torch.distributed.run --nproc-per-node 1`` over NCCL, phase
             7's corpus from raw EMG, tpu_fast_plus fused/pallas, 3 overfit
             batches, with ``parallel: {}`` and ``{fsdp: true}`` (one
             after the other in one launch), each
             against one process's ``train_from_config`` from the same
             seed: losses and trained weights bit-equal (else the gap,
             gated at the CPU tests' tolerances), NCCL seen inside the
             step, every fp32 kernel launched by the rank (its counts enter
             the kernels line), the step's device time beside the one
             process's; with N ≥ 2 cards the same CLI again over an even
             number of them, dropout 0, with tpu_scaled_large's block
             (``model: 2, sequence, fsdp``) and with ``{fsdp: true}``, held
             to the tolerances; (b) with two or more cards, the trainer's
             ``make_train_step`` with tpu_scaled_large's ``parallel:``
             block as shipped over 2 cards (and over 4 when there are 4)
             at full width and 2 blocks, fused/pallas: an fp32 dropout-0
             step against one card (loss and gradient tolerances of phase
             8), then 2 bf16 steps that must stay finite — with one card it
             prints ``{"phase": "18b", "skipped": ...}``; (c)
             ``data_parallel`` serving of phase 11b's checkpoint: with one
             card the warning and log-probs equal to the same engine's
             without it, with more the rows split over the cards; text
             equal either way. ``chip_smoke.py --parallel-only`` runs the
             build, phase 18 and phase 19c alone, for a machine with several
             cards.
19. worker pool and GPipe — (a) phase 7's corpus trained from raw EMG,
             fused/pallas, one epoch with the shipped ``num_workers: 4`` and
             with 0: losses and trained weights bit-equal (``torch.equal``),
             the worker processes counted in the process table while it
             trains (the train and val loaders' pools: 8) and none after;
             the training loader alone at tpu_fast_plus B = 32 (256
             utterances of one 768-frame bucket, cached features and raw
             EMG, teacher on, page cache warm) at 0, 4 and 8 workers in
             batches/s and utt/s, beside the fused step's device time
             (profiler) on one of its batches, with ``os.cpu_count()``. (b)
             ``configs/tpu_scaled_large.yaml`` with ``conv_norm: layer`` and
             ``pipeline_microbatches: 16`` (``scan_layers`` off, which the
             pipeline excludes) at full width, ``LARGE_BLOCKS`` deep, bf16,
             fused/pallas,
             remat as shipped, on one card (no stages: the sequential
             stack): trained steps finite, launches counted (the forward
             kernels twice a step under remat), the step's device time
             beside the same config unpipelined; its checkpoint served at
             B = 8 with log-probs ``torch.equal`` to the same weights
             unpipelined (``scan_layers``' fp32 carry, as shipped); phase
             15e's 2-block card-vs-CPU bf16 step with the pipeline's keys;
             ``pipeline.gpipe`` itself at one stage and M = 4 under
             ``torchrun --nproc-per-node 1`` (NCCL), fp32 fused/pallas at
             full width and 2 blocks, against the sequential stack within
             phase 8's tolerances. (c) with two or more cards, the trainer
             CLI under torchrun on tpu_scaled_large (conv_norm layer, fp32,
             fused/pallas, dropout 0) with ``{model: 2,
             pipeline_microbatches: 4}`` and, with four,
             ``{model: 4, pipeline_microbatches: 16}`` and ``{data: 2,
             model: 2, pipeline_microbatches: 4, fsdp: true}``, 4 steps of
             B = 32 each against one card's ``train_from_config`` within
             phase 18's tolerances, the last step's span beside one card's
             and the bubble (M + S − 1)/M; then 2 stages twice with the
             shipped dropout, bit-equal run to run; with one card it prints
             ``{"phase": "19c", "skipped": ...}``.
20. experiment sweep — (a) a working directory with phase 7's 20 voiced
             utterances and 12 silent ones made the same way, the shipped
             voiced and silent base configs at full width read by the
             port's YAML reader and written back by its writer with only
             the data paths, ``attention_impl: fused`` /
             ``depthwise_impl: pallas``, (silent) ``train_from_raw`` and
             ``max_epochs`` (``SWEEP_EPOCHS``: the run's time budget)
             changed, one 1-epoch probe variant a dataset, and slim decoder
             grids (greedy, beam 50, one LM entry); (b) ``python -m
             ssd_tpu_torch.experiments.orchestrate --probe-batches 2
             --probe-batches-silent 2``: the two-stage sweep with every
             trainer and eval CLI a child process on the card (``--device
             cuda``, read back from each child's log), its record count,
             ``summary.csv``'s header, every silent run started from the
             best stage-2 voiced checkpoint, the LM entries skipped; (c) the
             same with ``--resume``: no child started, records unchanged;
             (d) the best stage-2 silent run's ``best`` and ``last``
             averaged by ``average_checkpoints`` (every tensor
             ``torch.equal`` to a float64 mean taken here), evaluated
             in-process through the eval CLI on the card from raw EMG,
             launches counted, log-probs within phase 12's tolerance of a
             CPU forward; (e) ``python -m ssd_tpu_torch.evaluation.visualize``
             on one cached utterance, or ``{"phase": "20e", "skipped":
             "matplotlib not installed"}``. It prints each sub-step's
             seconds.
21. layout conversion — ``configs/tpu_scaled_large.yaml`` at full width
             and full depth (12 blocks, bf16, ``scan_layers`` as shipped,
             fused/pallas; random weights from a seed) saved, converted to
             unrolled and back to scan by ``ssd_tpu_torch.training.
             convert_layout.main``, and each checkpoint served from the same
             raw EMG on the card (``InferenceEngine.forward``, launches
             counted): the round trip's log-probs ``torch.equal`` to the
             original's, the unrolled one's within atol 5e-2 (the fp32
             carry into block_0 that ``scan_layers`` adds; not equal); the
             same with ``configs/tpu_fast_plus.yaml`` in fp32, where the
             three are ``torch.equal``. It prints its seconds, launches and
             largest log-prob gap. (b) The trainer's checkpoint of the
             full-depth tpu_scaled_large state on the card (166.29 M
             parameters with their AdamW moments, ``last`` + ``best``): the
             seconds ``save_checkpoint`` holds the training thread against
             the async ``CheckpointWriter.save`` (pinned buffers new, then
             reused), the write alone (``finalize``), and bf16 forwards (B
             32, 768 frames) timed alone and while a write runs; the async
             ``last`` ``torch.equal`` to the sync one.

Kernel times are CUDA-event means of launches queued behind a device spin
(``cuda_ms``), which checks that the spin outlasted the queuing.

The bf16 instances' entries of the kernels line are phase 15's (at B = 32,
T′ 384), their launches its counted runs'. The fp32 kernels' launches add
phases 16 and 17's counted runs. ``torch._int_mm`` is a library kernel, not
a port of a TPU kernel: it is held to its plain twin and counted, and not
listed in the kernels line.

The last three lines of standard output are the kernel JSON, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``. Any failure
exits non-zero without the last line.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import importlib.util
import json
import logging
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ssd_tpu_torch.data import index_dataset, preprocessing
from ssd_tpu_torch.data.audio import load_audio
from ssd_tpu_torch.data.dataset import bf16_bits
from ssd_tpu_torch.data.index_dataset import save_index
from ssd_tpu_torch.data.vocab import Vocab, default_vocab
from ssd_tpu_torch.decoding import build_char_lm
from ssd_tpu_torch.decoding import ctc as decoding
from ssd_tpu_torch.decoding import device_lm as dl
from ssd_tpu_torch.decoding.host_beam import beam_search_lm_batch
from ssd_tpu_torch.decoding.lm import NGramLM
from ssd_tpu_torch.evaluation import evaluate as ev
from ssd_tpu_torch.models import wavlm
from ssd_tpu_torch.models.conformer import init_flax_style
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.ops import attention as attn
from ssd_tpu_torch.ops import ctc_loss as ctc
from ssd_tpu_torch.ops import depthwise_conv as dwc
from ssd_tpu_torch.ops import featurizer as feat
from ssd_tpu_torch.ops import mel as melmod
from ssd_tpu_torch.ops import quant
from ssd_tpu_torch.ops.ctc_decode import greedy_decode, traceback
from ssd_tpu_torch.serving import streaming
from ssd_tpu_torch.serving.engine import InferenceEngine
from ssd_tpu_torch.serving.export import ExportedTranscriber, export_checkpoint
from ssd_tpu_torch.serving.server import encode_npy, serve
from ssd_tpu_torch.serving.streaming import ChunkedStreamingTranscriber
from ssd_tpu_torch.training import convert_layout
from ssd_tpu_torch.training import train as trainer
from ssd_tpu_torch.training.checkpoint import CheckpointWriter, load_checkpoint, save_checkpoint
from ssd_tpu_torch.training.schedules import build_optimizer
from ssd_tpu_torch.utils import cuda_build
from ssd_tpu_torch.utils.config import load_config
from ssd_tpu_torch.utils.yaml_subset import read_yaml, write_yaml

SEED = 0
CHANNELS = 8
BUCKET = 12800  # largest serving bucket exercised: 5 × SAMPLE_BUCKET
# the full-width configuration every phase runs, read through the port's own
# YAML reader (it needs no pyyaml)
CONFIG_PATH = Path(__file__).resolve().parent / "configs" / "tpu_fast_plus.yaml"
# the other implementation of two ops, on the same parameters
FUSED = {"attention_impl": "fused", "depthwise_impl": "pallas"}

FEAT_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_featurizer.py::test_fused_matches_xla
# card vs CPU log-probs, full fp32 on both (TF32 off): summation order only,
# through 6 blocks and a ×10 CTC head
LOGPROB_TOL = dict(atol=2e-3, rtol=1e-4)
H100_FP32_FLOPS = 67e12  # non-tensor-core fp32, SXM, 700 W
H100_TF32_FLOPS = 495e12  # dense TF32 tensor cores, SXM, 700 W
H100_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


@functools.cache
def shipped_config() -> dict:
    """``configs/tpu_fast_plus.yaml`` through ``load_config``; callers copy
    it before they change it."""
    return load_config(CONFIG_PATH)


def encoder_key(key: str):
    return shipped_config()["model"]["encoder"][key]


@contextlib.contextmanager
def captured_log(name: str, level: int = logging.INFO):
    """The messages of logger ``name`` at ``level`` and above while the
    block runs (the logger's level set to ``level`` meanwhile)."""
    messages = []

    class Seen(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    log, seen = logging.getLogger(name), Seen(level)
    saved = log.level
    log.setLevel(level)
    log.addHandler(seen)
    try:
        yield messages
    finally:
        log.removeHandler(seen)
        log.setLevel(saved)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


SPIN_CYCLES = 20_000_000  # ~10 ms of device spin at the H100's clock
SPIN_DOUBLINGS = 7  # at most 2**7 × that, ~1.3 s, before cuda_ms gives up


def synchronizes(fn) -> bool:
    """Whether ``fn()`` waits for the device — a copy from pageable host
    memory does, and so does a call of more launches than the device's
    launch queue holds: it returns only after a long spin queued before it
    ends."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES << SPIN_DOUBLINGS)
    mark = torch.cuda.Event()
    mark.record()
    fn()
    waited = mark.query()
    torch.cuda.synchronize()
    return waited


def cuda_ms_mode(fn, iters: int = 50, warmup: int = 5) -> tuple:
    """Mean device time of ``fn()`` over ``iters`` warm launches. The stream
    first spins (``torch.cuda._sleep``) while the host queues the launches,
    so a kernel shorter than its host-side launch is timed back to back on
    the device, not at the host's launch rate. If the start event has
    already completed once the launches are queued, the spin ran out while
    the host was still queuing and the device waited on it: the run is
    repeated with twice the spin, at most ``SPIN_DOUBLINGS`` times, and
    then it fails. A function that itself waits for the device (the plain
    log-mel copies its constants from the host; the plain CTC recursions
    queue thousands of launches) cannot be queued behind a spin: it is timed
    without one, host gaps included, and says so. Returns ``(ms, mode)``,
    mode ``"spin"`` or ``"host-paced"``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for attempt in range(SPIN_DOUBLINGS + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        outran = start.query()  # the device reached the start before the last launch was queued
        end.record()
        torch.cuda.synchronize()
        if not outran:
            return start.elapsed_time(end) / iters, "spin"
        if attempt == 0 and synchronizes(fn):
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            where = f"{fn.__code__.co_filename.rsplit('/', 1)[-1]}:{fn.__code__.co_firstlineno}"
            print(f"[time] the function at {where} waits for the device: timed without a spin, "
                  f"host gaps included")
            return start.elapsed_time(end) / iters, "host-paced"
        cycles *= 2
    raise SmokeFailure(f"cuda_ms: {iters} launches took the host longer to queue than a "
                       f"{cycles // 2}-cycle device spin")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """:func:`cuda_ms_mode`'s time alone."""
    return cuda_ms_mode(fn, iters, warmup)[0]


def bound(flops: float, nbytes: float, flops_per_s: float = H100_FP32_FLOPS) -> tuple:
    t_ops, t_bytes = flops / flops_per_s * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def close(a: torch.Tensor, b: torch.Tensor, atol: float, rtol: float) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def requests(rng: np.random.Generator, n: int) -> list:
    lengths = rng.integers(4000, 12001, size=n)
    return [rng.normal(size=(int(k), CHANNELS)).astype(np.float32) for k in lengths]


# ---------------------------------------------------------------- phases


def phase_build() -> str:
    from concurrent.futures import ThreadPoolExecutor

    libs = {"logmel.cu": feat.LOGMEL.library, "ctc.cu": ctc.CTC_ALPHA.library,
            "attention.cu": attn.ATTN_FWD.library, "depthwise_conv.cu": dwc.DW_FWD.library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, together
        list(pool.map(lambda lib: lib.load(), libs.values()))
    print(f"[build] {len(libs)} kernel sources ready in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        how = f"nvcc {lib.build_seconds:.2f} s" if lib.build_log else "reused the built library"
        print(f"[build] {name}: {how} ({lib.library_path().name})")
        kernel = ""
        for line in lib.build_log.splitlines():
            entry = re.search(r"Compiling entry function '\S*?\d([a-z][a-z_]*(?:_bf16)?_kernel)"
                              r"(I(?:f|13__nv_bfloat16|L[bi]\d+E)+E)?", line)
            if entry:
                kernel = entry.group(1)
                args = re.findall(r"(f|13__nv_bfloat16|L[bi]\d+E)", entry.group(2) or "")
                args = [{"f": "float", "13__nv_bfloat16": "bf16"}.get(a) or
                        (a[2:-1] if a[1] == "i" else ("true" if a[2] == "1" else "false"))
                        for a in args]
                if kernel.startswith("attn_") and args:  # <16-byte staging, k-steps>
                    kernel += (f"<{'16' if args[0] == 'true' else '4'}-byte staging, "
                               f"{args[1]} {'16-deep ' if 'bf16' in kernel else ''}k-steps>")
                elif args:  # ctc.cu's <J, β>, depthwise_conv.cu's <type, KMAX, 16-byte copies>
                    kernel += "<" + ", ".join(args) + ">"
            if "registers" in line or "spill" in line:
                print(f"[build] ptxas {name} {kernel}: {line.strip()}")
    card = card_line()
    print(f"[build] card: {card}")
    print(f"[build] build directory (--compile-cache / ${cuda_build.CACHE_ENV}, else the "
          f"package's _build/): {cuda_build.build_dir()}")
    cfg, enc = shipped_config(), shipped_config()["model"]["encoder"]
    check("yaml" not in sys.modules, "reading the config imported pyyaml")
    print(f"[config] {CONFIG_PATH.name} read by load_config without pyyaml (installed here: "
          f"{importlib.util.find_spec('yaml') is not None}; imported: False): d_model {enc['d_model']}, "
          f"{enc['num_layers']} blocks, {enc['num_heads']} heads, ffn {enc['ffn_dim']}, "
          f"K {enc['depthwise_conv_kernel_size']}, input {enc['input_dim']}; optim lr "
          f"{cfg['optim']['lr']!r}, batch {cfg['optim']['batch_size']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[build] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    return card


def stft_logmel(emg: torch.Tensor, cfg: feat.FeaturizerConfig, window, mel_t) -> torch.Tensor:
    """Library yardstick: the same function through ``torch.stft`` (timed
    only; the port never calls it)."""
    B, L, C = emg.shape
    spec = torch.stft(emg.permute(0, 2, 1).reshape(B * C, L), cfg.n_fft, cfg.hop_length,
                      window=window, center=False, return_complex=True)
    power = spec.abs().square().transpose(1, 2)
    return 10.0 * torch.log10(torch.clamp(power @ mel_t, min=1e-10))


# the log-mel kernel's times before its FFT redesign (PERF.md §6, H100 80GB
# HBM3 at 700 W): the FFT kernel must beat each by LOGMEL_GATE, and the
# torch.stft composite timed in the same call
DFT_LOGMEL_MS = {1: 0.1328, 8: 0.6504}
LOGMEL_GATE = 2.0


def logmel_work(cfg: feat.FeaturizerConfig, frames: int) -> tuple:
    """(the FFT kernel's flops, the Pallas cost estimate's dense-DFT flops,
    the floats of the kernel's constants) for ``frames`` frames. The
    kernel's flops: per pair of frames the windowed load (2·n_fft), the
    transform's butterflies over the plan's passes and their twiddle
    products where the twiddle is not 1 (``feat.fft_flops``), the split and
    power (12 a bin); per frame the banded mel (2 a non-zero band weight)
    and the dB (3 a mel). Its
    constants: the radices, the twiddles, the window, the packed bands and
    their first bins."""
    fb = melmod.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    pair = 2 * cfg.n_fft + feat.fft_flops(cfg.n_fft) + 12 * cfg.n_bins
    fft = frames * (pair / 2 + 2 * np.count_nonzero(fb) + 3 * cfg.n_mels)
    dense = frames * (4 * cfg.n_fft * cfg.n_bins + 3 * cfg.n_bins + 2 * cfg.n_bins * cfg.n_mels)
    consts = (len(feat.fft_radices(cfg.n_fft)) + 3 * cfg.n_fft + feat.mel_bands(fb)[1].size
              + cfg.n_mels)
    return fft, dense, consts


def phase_kernel(rng: np.random.Generator) -> dict:
    cfg = feat.FeaturizerConfig(**shipped_config()["features"]["emg"])
    dev = torch.device("cuda")
    window = torch.hann_window(cfg.n_fft, periodic=True, device=dev)
    mel_t = torch.from_numpy(np.ascontiguousarray(
        melmod.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels).T)).to(dev)
    entry = {}
    for B in (1, 8):
        lengths = rng.integers(4000, 12001, size=B)
        emg = np.zeros((B, BUCKET, CHANNELS), np.float32)
        for i, n in enumerate(lengths):
            emg[i, :n] = rng.normal(size=(n, CHANNELS))
        x = torch.from_numpy(emg).to(dev)
        lens = torch.from_numpy(lengths).to(dev)
        got = feat.normalize_logmels(feat.LOGMEL(x, cfg), lens, cfg)[0]
        want = feat.normalize_logmels(feat.logmel_core_plain(x, cfg), lens, cfg)[0]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"kernel features not finite at B={B}")
        check(close(got, want, **FEAT_TOL),
              f"kernel vs plain features at B={B}: max abs err {err} > {FEAT_TOL}")
        ms = cuda_ms(lambda: feat.LOGMEL(x, cfg))
        plain_ms = cuda_ms(lambda: feat.logmel_core_plain(x, cfg))
        library_ms = cuda_ms(lambda: stft_logmel(x, cfg, window, mel_t))
        # ~30 launches a call: 10 calls stay inside the device's launch queue
        batch_ms = cuda_ms(lambda: feat.logmel_batch(x, lens, cfg), iters=10)
        T = cfg.frame_count(BUCKET)
        rows_frames = B * CHANNELS * T
        flops, dense_flops, consts = logmel_work(cfg, rows_frames)
        # input and output once, and the kernel's constants
        nbytes = 4 * (B * BUCKET * CHANNELS + rows_frames * cfg.n_mels + consts)
        bound_ms, by = bound(flops, nbytes)
        dense_ms = bound(dense_flops, nbytes)[0]
        print(f"[kernel] B={B} rows={B * CHANNELS} frames={T}: max_abs_err={err:.3e} "
              f"(tol {FEAT_TOL}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.stft {library_ms:.4f} ms; bound {bound_ms:.5f} ms ({by}; FFT plan "
              f"{feat.fft_radices(cfg.n_fft)}: {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB; "
              f"{flops / ms / 1e9:.2f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s achieved); the "
              f"Pallas cost estimate's dense-DFT bound {dense_ms:.4f} ms "
              f"({dense_flops / 1e9:.3f} GFLOP)")
        print(f"[kernel] B={B}: logmel_batch (kernel + 80 dB clip + z-norm) {batch_ms:.4f} ms; "
              f"the kernel is {100 * ms / batch_ms:.1f} % of it")
        limit = DFT_LOGMEL_MS[B] / LOGMEL_GATE
        print(f"[kernel] B={B}: {DFT_LOGMEL_MS[B] / ms:.2f}x faster than the dense-DFT kernel's "
              f"{DFT_LOGMEL_MS[B]} ms (gate: ≥ {LOGMEL_GATE}x, ≤ {limit:.4f} ms); "
              f"{library_ms / ms:.2f}x torch.stft's time (gate: faster)")
        check(ms <= limit, f"log-mel kernel at B={B}: {ms:.4f} ms > {limit:.4f} ms, less than "
              f"{LOGMEL_GATE}x faster than the dense-DFT kernel")
        check(ms < library_ms, f"log-mel kernel at B={B}: {ms:.4f} ms, not faster than the "
              f"torch.stft composite's {library_ms:.4f} ms")
        entry = {
            "name": "logmel", "route": "cuda", "source": "ssd_tpu_torch/csrc/logmel.cu",
            "replaces": "ssd_tpu/ops/featurizer.py:239",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms,
        }
    return entry  # the B=8 (largest bucket) entry


def model_block(**enc) -> dict:
    """The config's model block with encoder keys overridden."""
    m = copy.deepcopy(shipped_config()["model"])
    m["encoder"].update(enc)
    return m


def build_run_dir(run_dir: Path, **enc) -> Path:
    """The full-width model, random weights from ``SEED`` (the same weights
    whatever ``enc`` selects), saved as a checkpoint under ``run_dir``. The
    weights are float whatever ``quantize`` says: the engine quantizes them."""
    run_dir.mkdir(parents=True, exist_ok=True)
    vocab_path = run_dir / "vocab.json"
    default_vocab().to_json(vocab_path)
    cfg = {"data": {"vocab": str(vocab_path)}, "features": shipped_config()["features"],
           "model": model_block(**enc), "decoding": shipped_config()["decoding"]}
    float_cfg = copy.deepcopy(cfg)
    float_cfg["model"]["encoder"]["quantize"] = "none"
    model = build_model(float_cfg, input_dim=encoder_key("input_dim"), vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        # ×10 CTC head: peaked log-probs, so text comparisons are not decided
        # by fp32 rounding between near-tied tokens
        model.ctc_head.fc.weight.mul_(10.0)
    n_params = sum(p.numel() for p in model.parameters())
    save_checkpoint(run_dir, model.state_dict(), cfg)
    print(f"[engine] tpu_fast_plus model {enc or ''}: {n_params / 1e6:.2f} M params, "
          f"checkpoint {run_dir / 'last'}")
    return run_dir / "last"


def post(port: int, path: str, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def expect_http_error(port: int, path: str, payload: dict, code: int) -> None:
    try:
        post(port, path, payload)
    except urllib.error.HTTPError as e:
        check(e.code == code, f"{path} answered {e.code}, expected {code}")
        return
    raise SmokeFailure(f"{path} answered 200, expected {code}")


def phase_main_path(ckpt: Path, rng: np.random.Generator, sizes=(1, 4, 8), per_call=None):
    """Phases 3 and 4 (and 11a), the counted run of the serving path: every
    ``transcribe`` must move each launch count by ``per_call`` exactly
    (log-mel once; the attention and depthwise kernels once a block when
    the checkpoint selects them) and every other count not at all."""
    per_call = {k: (per_call or {"logmel": 1}).get(k, 0) for k in COUNTERS}
    engines = {d: InferenceEngine.from_checkpoint(ckpt, decoder=d, device="cuda")
               for d in ("greedy", "beam")}
    batches = {B: requests(rng, B) for B in sizes}
    server_reqs = requests(rng, 3)

    reset_counts()
    texts = {}
    for B, reqs in batches.items():
        for d, eng in engines.items():
            before = counts()
            texts[B, d] = eng.transcribe(reqs)
            moved = {k: v - before[k] for k, v in counts().items()}
            check(moved == per_call, f"{d} transcribe at B={B}: launches moved {moved}, "
                  f"expected {per_call}")
            check(len(texts[B, d]) == B, f"{d} B={B}: {len(texts[B, d])} hypotheses")
        print(f"[engine] B={B}: greedy {texts[B, 'greedy'][0][:40]!r} | "
              f"beam-50 {texts[B, 'beam'][0][:40]!r}")

    server = serve(ckpt, port=0, host="127.0.0.1", warmup=False, max_wait_ms=5.0,
                   device="cuda")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            check(json.load(r)["status"] == "ok", "/healthz")
        served = [post(port, "/transcribe", {"emg": encode_npy(a)})["hypotheses"][0]
                  for a in server_reqs]
        expect_http_error(port, "/stream/feed", {"session": "s99999999", "emg": encode_npy(
            server_reqs[0])}, 404)
    finally:
        server.shutdown()
        server.batcher.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    launches = counts()
    n_calls = 2 * len(batches) + len(server_reqs)
    check(launches == {k: v * n_calls for k, v in per_call.items()},
          f"{n_calls} transcribes launched {launches}, expected {per_call} each")
    print(f"[server] 3 /transcribe answered, /stream/feed of an unknown session → 404; main "
          f"path launches in "
          f"{n_calls} transcribe calls: { {k: v for k, v in launches.items() if v} }")
    direct = [engines["greedy"].transcribe([a])[0] for a in server_reqs]
    check(served == direct, f"server {served} != engine {direct}")
    return engines, batches, launches


def phase_parity(ckpt: Path, engines: dict, batches: dict) -> None:
    cpu = InferenceEngine.from_checkpoint(ckpt, device="cpu")
    for B, reqs in batches.items():
        lp, ol = engines["greedy"].forward(reqs)
        lp_cpu, ol_cpu = cpu.forward(reqs)
        check(tuple(lp.shape) == tuple(lp_cpu.shape) and lp.shape[-1] == 48,
              f"log-prob shapes {tuple(lp.shape)} vs {tuple(lp_cpu.shape)}")
        check(bool(torch.isfinite(lp).all()), f"non-finite log-probs at B={B}")
        check(torch.equal(ol.cpu(), ol_cpu), f"out lengths differ at B={B}")
        lp_host = lp.cpu()
        err = float((lp_host - lp_cpu).abs().max())
        check(close(lp_host, lp_cpu, **LOGPROB_TOL),
              f"card vs CPU log-probs at B={B}: max abs err {err} > {LOGPROB_TOL}")
        for d in ("greedy", "beam"):
            card = engines[d].decode(lp, ol)[:B]
            host = cpu.decode(lp_host, ol.cpu(), decoder=d)[:B]
            check(card == host, f"{d} text differs card vs CPU at B={B}: {card} vs {host}")
        print(f"[parity] B={B}: log-probs {tuple(lp.shape)} max abs err card vs CPU {err:.3e} "
              f"(tol {LOGPROB_TOL}); greedy and beam-50 text equal to the CPU decoders")


def phase_latency(engines: dict, rng: np.random.Generator) -> None:
    for d, eng in engines.items():
        for B in (1, 8):
            reqs = [rng.normal(size=(12000, CHANNELS)).astype(np.float32) for _ in range(B)]
            eng.transcribe(reqs)  # warm
            iters = 20 if d == "greedy" else 5
            per_utt = []
            for _ in range(iters):
                t0 = time.perf_counter()
                eng.transcribe(reqs)
                per_utt.append((time.perf_counter() - t0) / B)
            print(f"[latency] {d}{'-50' if d == 'beam' else ''} B={B} 12 000 samples: "
                  f"p50 {np.percentile(per_utt, 50) * 1e3:.3f} ms/utterance "
                  f"({iters} runs, host clock, transcribe end to end)")


# ------------------------------------------------------- training phases

TEACHER_DIM = 768
LAMBDAS = (0.65, 0.35)
BLANK = 1  # default_vocab's blank id
CTC_SHAPES = {"config": (5, 640, 160), "flagship": (32, 384, 128)}  # (B, T', S)
CTC_REC_RTOL = 1e-5  # α / β where finite, and the per-sample loss
CTC_GRAD_ATOL = 1e-5  # logits gradients, kernels vs plain
# against float64 F.ctc_loss: values as tests/test_ctc_loss.py holds the JAX
# loss to torch's; gradients rtol 1e-3 and an atol of 8 fp32 ulps of the
# largest |log-likelihood|, because the posterior exp(α + β − ll) takes the
# rounding of log values that large (at T' = 640 |ll| reaches ~4 600: the
# JAX loss is 2.9e-3 off float64 there, bit for bit like the port, and
# fp32 F.ctc_loss 4.0e-3 — CPU runs of the same inputs)
TORCH_CTC_TOL = dict(rtol=1e-4, atol=1e-4)
TORCH_CTC_GRAD_RTOL, TORCH_CTC_GRAD_ULPS = 1e-3, 8
CTC_OPS_PER_STATE = 12  # per state and step: 10 flops + 2 transcendentals (the Pallas cost estimate)
# the α and β kernels' times before their register-resident redesigns
# (PERF.md §6, H100 80GB HBM3 at 700 W): each must beat its own by CTC_GATE
SMEM_ALPHA_MS = {"config": 0.4429, "flagship": 0.2616}
SMEM_BETA_MS = {"config": 0.4449, "flagship": 0.2621}
CTC_GATE = 1.25
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU, fp32 both, TF32 off
TRAIN_GRAD_REL = 1e-3  # max abs err ≤ this × the tensor's max-abs gradient, or …
TRAIN_GRAD_FLOOR = 1e-6  # … this: the attention key bias and the depthwise-conv bias
# have a true gradient of 0 (softmax shift / batch-mean invariance), so both
# devices return rounding noise for them
TRAIN_STAT_ATOL = 1e-5
RATE_STEPS = 5  # warm steps timed a shape by the train-rate phases (9, 11d)


COUNTERS = {"logmel": feat.LOGMEL, "ctc_alpha": ctc.CTC_ALPHA, "ctc_beta": ctc.CTC_BETA,
            "attention_fwd": attn.ATTN_FWD, "attention_bwd": attn.ATTN_BWD,
            "depthwise_fwd": dwc.DW_FWD, "depthwise_bwd": dwc.DW_BWD,
            "attention_fwd_bf16": attn.ATTN_FWD_BF16, "attention_bwd_bf16": attn.ATTN_BWD_BF16,
            "depthwise_fwd_bf16": dwc.DW_FWD_BF16, "depthwise_bwd_bf16": dwc.DW_BWD_BF16,
            "int_mm": quant.INT_MM}


def reset_counts() -> None:
    for wrapper in COUNTERS.values():
        wrapper.launches = 0


def counts() -> dict:
    return {k: wrapper.launches for k, wrapper in COUNTERS.items()}


@contextlib.contextmanager
def plain_recursions():
    """Route the loss's α / β through the plain versions (the reference run
    on the card); the main path never does this."""
    fa, fb = ctc.forward_alphas, ctc.betas
    ctc.forward_alphas, ctc.betas = ctc.forward_alphas_plain, ctc.betas_plain
    try:
        yield
    finally:
        ctc.forward_alphas, ctc.betas = fa, fb


def ctc_case(rng: np.random.Generator, B: int, T: int, S: int):
    """Logits and targets at (B, T, S): random lengths, plus an empty
    target, an impossible row and a row of one repeated label."""
    logits = rng.normal(size=(B, T, 48)).astype(np.float32) * 3
    ll = rng.integers(T // 2, T + 1, size=B)
    tl = rng.integers(S // 2, S + 1, size=B)
    tg = rng.integers(3, 48, size=(B, S))
    ll[0] = T
    tl[1] = 0
    ll[2], tl[2] = S // 2, S  # fewer frames than labels
    ll[3], tg[3, :] = T, 7
    dev = torch.device("cuda")
    return (torch.from_numpy(logits).to(dev), torch.from_numpy(ll.astype(np.int32)).to(dev),
            torch.from_numpy(tg.astype(np.int32)).to(dev), torch.from_numpy(tl.astype(np.int32)).to(dev))


def loss_and_grad(logits, ll, tg, tl):
    x = logits.detach().requires_grad_(True)
    loss = ctc.ctc_loss(torch.log_softmax(x, -1), ll, tg, tl, BLANK)
    loss.sum().backward()
    return loss.detach(), x.grad


def finite_close(got: torch.Tensor, want: torch.Tensor, rtol: float):
    """(max abs err, ok) over the states the reference holds finite."""
    fin = want > -1e29
    if not torch.equal(got > -1e29, fin):
        return float("inf"), False
    err = (got - want).abs()[fin]
    return float(err.max()), bool((err <= rtol * want.abs()[fin] + 1e-6).all())


def phase_ctc(rng: np.random.Generator) -> dict:
    entries, times = {}, {}
    for label, (B, T, S) in CTC_SHAPES.items():
        logits, ll, tg, tl = ctc_case(rng, B, T, S)
        lp = torch.log_softmax(logits, -1)
        ext, skip = ctc._topology(tg, BLANK)
        lp_ext = ctc._emissions(lp, ext)
        S2 = ext.shape[1]
        skipf = skip.float()
        bfinal = ctc._final_states(tl, S2)
        skip_from = F.pad(skip[:, 2:], (0, 2), value=False)
        skip_from_f, ll32 = skip_from.float(), ll.to(torch.int32)
        got_a, want_a = ctc.CTC_ALPHA(lp_ext, skipf), ctc.forward_alphas_plain(lp_ext, skip)
        a_err, a_ok = finite_close(got_a, want_a, CTC_REC_RTOL)
        a_equal = torch.equal(got_a, want_a)
        got_b, want_b = ctc.CTC_BETA(lp_ext, skip_from_f, bfinal, ll32), ctc.betas_plain(lp_ext, ll, bfinal, skip_from)
        b_err, b_ok = finite_close(got_b, want_b, CTC_REC_RTOL)
        check(a_ok, f"α kernel vs plain at {label}: max abs err {a_err}")
        print(f"[ctc] {label}: α kernel bit-equal to the plain recursion on the card: {a_equal}")
        check(b_ok, f"β kernel vs plain at {label}: max abs err {b_err}")
        check(torch.equal(got_b, want_b), f"β kernel not bit-equal to the plain recursion at {label}: "
              f"max abs err {float((got_b - want_b).abs().max())}")
        print(f"[ctc] {label}: β kernel bit-equal to the plain recursion on the card: True")
        loss, grad = loss_and_grad(logits, ll, tg, tl)
        with plain_recursions():
            loss_p, grad_p = loss_and_grad(logits, ll, tg, tl)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(loss).all() and torch.isfinite(grad).all()), f"non-finite CTC at {label}")
        check(float(loss[2]) == 0.0 and bool((grad[2] == 0).all()), f"impossible row not zeroed at {label}")
        check(close(loss, loss_p, atol=1e-6, rtol=CTC_REC_RTOL),
              f"loss kernels vs plain at {label}: {float((loss - loss_p).abs().max())}")
        g_err = float((grad - grad_p).abs().max())
        check(g_err <= CTC_GRAD_ATOL, f"logits grads kernels vs plain at {label}: {g_err}")
        # F.ctc_loss in float64 is the judge; the fp32 run's own gradient
        # error against it is printed beside
        ref = {}
        for dtype in (torch.float64, torch.float32):
            xt = logits.detach().to(dtype).requires_grad_(True)
            want = F.ctc_loss(torch.log_softmax(xt, -1).transpose(0, 1), tg.long(), ll.long(),
                              tl.long(), blank=BLANK, reduction="none", zero_infinity=True)
            want.sum().backward()
            ref[dtype] = (want.detach().float(), xt.grad.float())
        want, want_grad = ref[torch.float64]
        t_err, tg_err = float((loss - want).abs().max()), float((grad - want_grad).abs().max())
        lib_err = float((ref[torch.float32][1] - want_grad).abs().max())
        check(close(loss, want, **TORCH_CTC_TOL), f"loss vs F.ctc_loss (f64) at {label}: {t_err}")
        grad_atol = max(1e-4, TORCH_CTC_GRAD_ULPS * 2.0**-23 * float(want.abs().max()))
        check(close(grad, want_grad, atol=grad_atol, rtol=TORCH_CTC_GRAD_RTOL),
              f"grads vs F.ctc_loss (f64) at {label}: {tg_err} > atol {grad_atol}")

        lp_t = lp.transpose(0, 1).contiguous()
        # lengths on the host, as F.ctc_loss reads them: a CUDA copy would
        # synchronize inside every timed call
        ll_h, tl_h = ll.cpu(), tl.cpu()

        def torch_fwd_bwd():
            x = lp_t.detach().requires_grad_(True)
            F.ctc_loss(x, tg, ll_h, tl_h, blank=BLANK, reduction="none", zero_infinity=True).sum().backward()

        def port_fwd_bwd():
            x = lp.detach().requires_grad_(True)
            ctc.ctc_loss(x, ll, tg, tl, BLANK).sum().backward()

        torch_fwd_ms, torch_fwd_mode = cuda_ms_mode(
            lambda: F.ctc_loss(lp_t, tg, ll_h, tl_h, blank=BLANK, reduction="none", zero_infinity=True))
        print(f"[ctc] {label}: F.ctc_loss forward {torch_fwd_ms:.4f} ms, timed {torch_fwd_mode} "
              f"(the α kernel's library time)")
        t = {
            "alpha": cuda_ms(lambda: ctc.CTC_ALPHA(lp_ext, skipf)),
            "beta": cuda_ms(lambda: ctc.CTC_BETA(lp_ext, skip_from_f, bfinal, ll32)),
            "alpha_plain": cuda_ms(lambda: ctc.forward_alphas_plain(lp_ext, skip), iters=3, warmup=1),
            "beta_plain": cuda_ms(lambda: ctc.betas_plain(lp_ext, ll, bfinal, skip_from), iters=3, warmup=1),
            "torch_fwd": torch_fwd_ms,
            "torch_fwd_bwd": cuda_ms(torch_fwd_bwd),
            # dozens of launches a call: 5 calls stay inside the device's launch queue
            "port_fwd": cuda_ms(lambda: ctc.ctc_loss(lp, ll, tg, tl, BLANK), iters=5),
            "port_fwd_bwd": cuda_ms(port_fwd_bwd, iters=5),
        }
        times[label] = t
        for name, sign, before in (("alpha", "α", SMEM_ALPHA_MS), ("beta", "β", SMEM_BETA_MS)):
            limit = before[label] / CTC_GATE
            print(f"[ctc] {label}: {sign} {t[name]:.4f} ms, {t[name] * 1e3 / T:.3f} µs a step, "
                  f"{before[label] / t[name]:.2f}x faster than the shared-memory kernel's "
                  f"{before[label]} ms (gate: ≥ {CTC_GATE}x, ≤ {limit:.4f} ms)")
            check(t[name] <= limit, f"{sign} kernel at {label}: {t[name]:.4f} ms > {limit:.4f} ms, less "
                  f"than {CTC_GATE}x faster than the shared-memory kernel")
        n = T * B * S2
        for name, err, extra in (("alpha", a_err, 4 * B * S2), ("beta", b_err, 8 * B * S2 + 4 * B)):
            nbytes = 4 * 2 * n + extra
            t_ops, t_bytes = CTC_OPS_PER_STATE * n / H100_FP32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            ms = t[name]
            print(f"[ctc] {label} B={B} T'={T} S={S} (S2={S2}) {name}: max_abs_err {err:.3e} "
                  f"(rtol {CTC_REC_RTOL} where finite); kernel {ms:.4f} ms, plain {t[name + '_plain']:.4f} ms, "
                  f"bound {bound:.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}; "
                  f"{nbytes / 1e6:.3f} MB), {nbytes / ms / 1e6:.2f} GB/s achieved")
            if label == "config":
                entries[name] = {
                    "name": f"ctc_{name}", "route": "cuda", "source": "ssd_tpu_torch/csrc/ctc.cu",
                    "replaces": "ssd_tpu/ops/ctc_loss.py:159" if name == "alpha"
                    else "ssd_tpu/ops/ctc_loss.py:211",
                    "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": t[name + "_plain"],
                    "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": t["torch_fwd"] if name == "alpha" else t["torch_fwd_bwd"],
                }
        print(f"[ctc] {label}: loss vs plain {float((loss - loss_p).abs().max()):.3e}, logits grads vs "
              f"plain {g_err:.3e} (atol {CTC_GRAD_ATOL}); vs float64 F.ctc_loss loss {t_err:.3e}, grads "
              f"{tg_err:.3e} (atol {grad_atol:.3e}; fp32 F.ctc_loss's grads: {lib_err:.3e}); whole loss fwd {t['port_fwd']:.4f} ms / fwd+bwd {t['port_fwd_bwd']:.4f} ms, "
              f"F.ctc_loss fwd {t['torch_fwd']:.4f} ms / fwd+bwd {t['torch_fwd_bwd']:.4f} ms")
    return {"entries": entries, "times": times}


def utterances(root: Path, rng: np.random.Generator, split: str, n_utts: int,
               n_train: int) -> list:
    """``n_utts`` random raw utterances of ``split`` (the first ``n_train``
    train, the rest val) under ``root``: raw EMG, log-mel features made on
    the card, teacher features, random transcripts; returns their index
    rows."""
    fcfg = feat.FeaturizerConfig(**shipped_config()["features"]["emg"])
    chars = list("abcdefghijklmnopqrstuvwxyz") + [" "] * 6 + list("',.?")
    rows = []
    for i in range(n_utts):
        uid = f"{split}/s1/{i}_0"
        n = int(rng.integers(4000, 12001))
        raw = rng.normal(size=(n, CHANNELS)).astype(np.float32)
        raw_path = root / "raw" / f"{i}_0_emg.npy"
        raw_path.parent.mkdir(parents=True, exist_ok=True)
        np.save(raw_path, raw)
        feats, n_frames, _, _ = feat.logmel_batch(
            torch.from_numpy(raw[None]).cuda(), torch.tensor([n], device="cuda"), fcfg)
        for kind, arr in (("emg", feats[0, : int(n_frames[0])].cpu().numpy()),
                          ("teacher", rng.normal(size=(n // 20, TEACHER_DIM)).astype(np.float32))):
            path = root / "features" / kind / f"{uid}.npy"
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, arr)
        text = "".join(rng.choice(chars, size=int(rng.integers(30, 151))))
        rows.append(dict(utterance_id=uid, split=split,
                         subset="train" if i < n_train else "val", speaker="s1", stem=f"{i}_0",
                         emg_path=str(raw_path), audio_path=None, transcript=text,
                         sentence_index=i, book="", has_audio=False, metadata_json="{}"))
    return rows


def make_corpus(root: Path, rng: np.random.Generator) -> Path:
    """20 voiced utterances (16 train, 4 val) → features, teacher, JSONL
    index, vocab, and the shipped config with the corpus's data paths as the
    run's JSON config; returns its path."""
    vocab_path = root / "vocab.json"
    default_vocab().to_json(vocab_path)
    save_index(utterances(root, rng, "voiced_parallel_data", 20, 16), root / "index.jsonl")
    cfg = copy.deepcopy(shipped_config())
    cfg["data"].update(index=str(root / "index.jsonl"), features_root=str(root / "features"),
                       vocab=str(vocab_path))
    path = root / "config.json"
    path.write_text(json.dumps(cfg, indent=2))
    return path


def check_epoch(h: dict, what: str) -> tuple:
    for part in ("train", "val"):
        for k in ("total", "ctc", "distill"):
            check(np.isfinite(h[part][k]), f"{what}: {part} {k} loss {h[part][k]} not finite")
    return h["train"]["batches"], h["val"]["batches"]


def phase_train(root: Path, rng: np.random.Generator) -> dict:
    base = load_config(make_corpus(root, rng))
    total = {"logmel": 0, "ctc_alpha": 0, "ctc_beta": 0}
    for mode in ("cached", "raw"):
        cfg = copy.deepcopy(base)
        cfg["data"]["train_from_raw"] = mode == "raw"
        cfg["optim"]["max_epochs"] = 1
        t0 = time.perf_counter()
        reset_counts()
        summary = trainer.train_from_config(cfg, root / f"run_{mode}", overfit_batches=2, device="cuda")
        c = counts()
        check(len(summary["history"]) == 1, f"{mode}: {len(summary['history'])} epochs ran")
        n_train, n_eval = check_epoch(summary["history"][0], mode)
        check(n_train == 2 and n_eval == 2, f"{mode}: {n_train} train / {n_eval} eval steps")
        check(c["ctc_alpha"] == n_train + n_eval, f"{mode}: α launched {c['ctc_alpha']} times")
        check(c["ctc_beta"] == n_train, f"{mode}: β launched {c['ctc_beta']} times")
        check(c["logmel"] == (n_train + n_eval if mode == "raw" else 0),
              f"{mode}: log-mel launched {c['logmel']} times")
        check(all(c[k] == 0 for k in ("attention_fwd", "attention_bwd", "depthwise_fwd",
                                      "depthwise_bwd")),
              f"{mode}: the default configuration launched {c}")
        for d in ("last", "best"):
            check((root / f"run_{mode}" / d / "model.pt").exists(), f"{mode}: no {d}/ checkpoint")
        for k in total:
            total[k] += c[k]
        h = summary["history"][0]
        print(f"[train] {mode}: 1 epoch, {n_train} train + {n_eval} eval steps in "
              f"{time.perf_counter() - t0:.2f} s; train total {h['train']['total']:.4f} "
              f"(ctc {h['train']['ctc']:.4f}, distill {h['train']['distill']:.4f}), val total "
              f"{h['val']['total']:.4f}; launches {c}")

    run = root / "run_cached"
    before = load_checkpoint(run / "last")
    cfg = copy.deepcopy(base)
    cfg["optim"]["max_epochs"] = 2
    reset_counts()
    summary = trainer.train_from_config(cfg, run, overfit_batches=2, resume=True, device="cuda")
    c = counts()
    check([h["epoch"] for h in summary["history"]] == [2], f"resume ran epochs {summary['history']}")
    n_train, n_eval = check_epoch(summary["history"][0], "resume")
    after = load_checkpoint(run / "last")
    check(after["epoch"] == 2 and after["step"] == before["step"] + n_train
          and after["optimizer"]["update_count"] == before["optimizer"]["update_count"] + n_train,
          f"resume: epoch {after['epoch']} step {after['step']} (before {before['step']})")
    check(c["ctc_alpha"] == n_train + n_eval and c["ctc_beta"] == n_train, f"resume launches {c}")
    for k in total:
        total[k] += c[k]
    print(f"[train] resumed at epoch 2 from step {before['step']} → {after['step']}; "
          f"val total {summary['history'][0]['val']['total']:.4f}; launches {c}")

    engine = InferenceEngine.from_checkpoint(run / "last", device="cuda")
    hyps = engine.transcribe(requests(rng, 2))
    check(len(hyps) == 2 and all(isinstance(h, str) for h in hyps), f"served {hyps}")
    print(f"[train] trained checkpoint served: {[h[:30] for h in hyps]}; training launches {total}")
    return total


def train_batch(rng: np.random.Generator, B: int, frames: int, S: int) -> dict:
    """A cached-feature batch at the loader's bucketed shapes."""
    lengths = rng.integers(int(frames * 0.6), frames + 1, size=B)
    lengths[0] = frames
    emg = rng.normal(size=(B, frames, encoder_key("input_dim"))).astype(np.float32)
    tok_len = rng.integers(S // 2, S + 1, size=B)
    tokens = np.zeros((B, S), np.int32)
    for i in range(B):
        emg[i, lengths[i]:] = 0.0
        tokens[i, : tok_len[i]] = rng.integers(3, 48, size=tok_len[i])
    return {"emg": emg, "emg_lengths": lengths.astype(np.int32), "tokens": tokens,
            "token_lengths": tok_len.astype(np.int32), "weight": np.ones(B, np.float32),
            "teacher": rng.normal(size=(B, frames // 2, TEACHER_DIM)).astype(np.float32),
            "teacher_lengths": (lengths // 2).astype(np.int32)}


def model_cfg(dropout: float, **enc) -> dict:
    m = model_block(**enc)
    m["encoder"]["dropout"] = m["ctc_dropout"] = dropout
    return {"model": m}


def phase_train_parity(rng: np.random.Generator, **enc) -> None:
    cfg = model_cfg(0.0, **enc)
    cpu_model = build_model(cfg, input_dim=encoder_key("input_dim"), vocab_size=48)
    init_flax_style(cpu_model, torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model).cuda()
    batch = train_batch(rng, 5, 1280, 160)
    out = {}
    for name, model, dev in (("card", gpu_model, torch.device("cuda")), ("cpu", cpu_model, torch.device("cpu"))):
        t0 = time.perf_counter()
        total, losses = trainer._losses(model, trainer.to_device(batch, dev), LAMBDAS, BLANK, False, True, None)
        total.backward()
        out[name] = {k: float(v.detach()) for k, v in losses.items()}
        print(f"[parity-train] {name}{enc or ''}: one full-width step at B=5, 1280 frames in "
              f"{time.perf_counter() - t0:.2f} s (host clock, first call)")
    for k in ("total", "ctc", "distill"):
        check(abs(out["card"][k] - out["cpu"][k]) <= TRAIN_LOSS_RTOL * abs(out["cpu"][k]),
              f"{k} loss card {out['card'][k]} vs CPU {out['cpu'][k]}")
    worst = (0.0, "")
    gpu_params = dict(gpu_model.named_parameters())
    for name, p in cpu_model.named_parameters():
        g_cpu, g_gpu = p.grad, gpu_params[name].grad.cpu()
        err = float((g_gpu - g_cpu).abs().max())
        bound = max(TRAIN_GRAD_REL * float(g_cpu.abs().max()), TRAIN_GRAD_FLOOR)
        check(err <= bound, f"grad {name}: card vs CPU max abs err {err} > {bound}")
        if bound > TRAIN_GRAD_FLOOR:  # the tensors held to the relative limit
            worst = max(worst, (err / float(g_cpu.abs().max()), name))
    gpu_bufs = dict(gpu_model.named_buffers())
    stat_err = max(float((gpu_bufs[n].cpu() - b).abs().max()) for n, b in cpu_model.named_buffers())
    check(stat_err <= TRAIN_STAT_ATOL, f"batch stats card vs CPU max abs err {stat_err}")
    print(f"[parity-train] losses card {out['card']} vs CPU {out['cpu']} (rtol {TRAIN_LOSS_RTOL}); "
          f"worst gradient error {worst[0]:.3e} of the tensor's max ({worst[1]}; limit "
          f"{TRAIN_GRAD_REL}); batch stats max abs err {stat_err:.3e} (atol {TRAIN_STAT_ATOL})")

    overfit = {"optim": {"lr": 1e-3, "weight_decay": 1e-2, "clip_grad_norm": 5.0}}
    model = build_model(cfg, input_dim=encoder_key("input_dim"), vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(SEED))
    model.cuda()
    opt, _ = build_optimizer(overfit, model.parameters(), 20)
    state = trainer.TrainState(model=model, optimizer=opt)
    step = trainer.make_train_step(BLANK, False)
    dbatch = trainer.to_device(batch, torch.device("cuda"))
    totals = [float(step(state, dbatch, LAMBDAS, None)[1]["total"]) for _ in range(20)]
    check(all(np.isfinite(totals)) and totals[-1] < totals[0], f"overfit totals {totals}")
    print(f"[parity-train] {enc or ''} 20 steps at lr 1e-3 on one batch: total {totals[0]:.4f} → "
          f"{totals[-1]:.4f}")


def device_events(step) -> list:
    """``torch.profiler``'s device events of one ``step()``, by kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # the first profiled run pays the tracer's start-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
    # device events only: a user annotation such as ``Optimizer.step#…`` is
    # reported on the device too and would count its span twice
    return [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]


def profile_step(step, step_ms: float, label: str, top: int = 6, tag: str = "rate") -> None:
    """Device time by kernel over one train step (or any ``step()``;
    ``torch.profiler``), and the device's busy share of the unprofiled p50
    step."""
    events = device_events(step)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[{tag}] {label} profiler: device busy {dev_ms:.3f} ms = {100 * dev_ms / step_ms:.1f} % of "
          f"the p50 step; {sum(e.count for e in events)} device events; largest:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:80]}")


def phase_train_rate(rng: np.random.Generator, ctc_times: dict, kernel_times=None, **enc) -> None:
    """Step rate at both shapes; with ``kernel_times`` (phase 10's, the
    fused/pallas configuration) also the four kernels' share of the step."""
    for label, (B, frames, S) in (("config", (5, 1280, 160)), ("flagship", (32, 768, 128))):
        torch.cuda.reset_peak_memory_stats()
        model = build_model(model_cfg(encoder_key("dropout"), **enc),
                            input_dim=encoder_key("input_dim"), vocab_size=48)
        init_flax_style(model, torch.Generator().manual_seed(SEED))
        model.cuda()
        opt, _ = build_optimizer(shipped_config(), model.parameters(), 1000)
        batch = trainer.to_device(train_batch(rng, B, frames, S), torch.device("cuda"))
        gen = torch.Generator("cuda").manual_seed(SEED + 1)

        def timed_step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad()
            total, _ = trainer._losses(model, batch, LAMBDAS, BLANK, False, True, gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            total.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            return t1 - t0, t2 - t1, time.perf_counter() - t2

        for _ in range(3):
            timed_step()
        split = np.asarray([timed_step() for _ in range(RATE_STEPS)]) * 1e3
        step_ms = float(np.percentile(split.sum(axis=1), 50))
        fwd, bwd, upd = (float(np.percentile(split[:, i], 50)) for i in range(3))
        t = ctc_times[label]
        share = (t["alpha"] + t["beta"]) / step_ms
        name = f"{label}{' ' + str(enc) if enc else ''}"
        print(f"[rate] {name} B={B} {frames} frames (T'={frames // 2}, S={S}): step p50 {step_ms:.3f} ms "
              f"(forward + loss {fwd:.3f}, backward {bwd:.3f}, optimizer {upd:.3f}; {RATE_STEPS} warm steps, "
              f"host clock with a sync around each part) = {B / step_ms * 1e3:.2f} utterances/s; "
              f"CTC kernels α {t['alpha']:.4f} + β {t['beta']:.4f} ms = {share * 100:.2f} % of the step "
              f"(CUDA events, same shapes); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (this shape)")
        if kernel_times is not None:
            k = kernel_times[label]
            L = encoder_key("num_layers")
            four = L * (k["attention_fwd"] + k["attention_bwd"] + k["depthwise_fwd"] + k["depthwise_bwd"])
            print(f"[rate] {name}: attention fwd {k['attention_fwd']:.4f} + bwd {k['attention_bwd']:.4f} "
                  f"+ depthwise fwd {k['depthwise_fwd']:.4f} + bwd {k['depthwise_bwd']:.4f} ms, × {L} "
                  f"blocks = {four:.3f} ms = {100 * four / step_ms:.2f} % of the step "
                  f"(phase 10's CUDA-event times at this shape, with the dropout multiplier)")
        profile_step(timed_step, step_ms, name)
        if not enc and label == "flagship":
            cudnn_deterministic_cost(timed_step, name)
        del model, opt, batch
        torch.cuda.empty_cache()


def cudnn_deterministic_cost(timed_step, name: str) -> None:
    """What the trainer's cuDNN settings (deterministic algorithms, no
    autotuning; ``train._deterministic_cudnn``) cost the composite path's
    step: step p50 (host clock) and device busy time (profiler) with the
    flags off and on, in turns off, on, on, off."""
    flags = torch.backends.cudnn
    saved = flags.deterministic, flags.benchmark
    runs = {False: [], True: []}
    try:
        for det in (False, True, True, False):
            flags.deterministic, flags.benchmark = det, False
            for _ in range(2):
                timed_step()
            host = float(np.percentile([sum(timed_step()) for _ in range(5)], 50)) * 1e3
            dev = sum(e.self_device_time_total for e in device_events(timed_step)) / 1e3
            runs[det].append((host, dev))
    finally:
        flags.deterministic, flags.benchmark = saved
    fmt = lambda rs: ", ".join(f"{h:.3f} / {d:.3f}" for h, d in rs)  # noqa: E731
    extra = np.mean([d for _, d in runs[True]]) - np.mean([d for _, d in runs[False]])
    print(f"[rate] {name}: cuDNN deterministic (the trainer's setting) vs off, step p50 host ms / "
          f"device busy ms: on {fmt(runs[True])}; off {fmt(runs[False])}; device time "
          f"{extra:+.3f} ms a step with it on")


# ------------------------------------- attention / depthwise (phases 10, 11)

# (B, T') of the serving bucket, the config's training bucket and the
# flagship bench shape; H 6, hd 48, C 288, K 15 at tpu_fast_plus width
KERNEL_SHAPES = {"serving": (8, 625), "config": (5, 640), "flagship": (32, 384)}
HEADS, HEAD_DIM, CHANNELS_DW, TAPS = 6, 48, 288, 15
# the JAX package's own tolerances (tests/test_fused_attention.py:34,55)
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
ATTN_GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
DW_TOL = dict(atol=1e-5, rtol=1e-5)  # dx (the forward is held bit-equal)
DW_SUM_REL = 1e-4  # dw: sums over B·T terms, within this × the tensor's max-abs
SDPA_BACKEND = SDPBackend.EFFICIENT_ATTENTION  # fp32 SDPA on the card: 3xTF32 tensor cores
# the earlier fp32-SIMT attention kernels' times at the config and flagship
# shapes (PERF.md §6, H100 80GB HBM3 at 700 W): the tensor-core kernels must
# beat each by ATTN_GATE
SIMT_ATTN_MS = {"config": {"attention_fwd": 0.2168, "attention_bwd": 0.8317},
               "flagship": {"attention_fwd": 0.3815, "attention_bwd": 1.4177}}
ATTN_GATE = 1.25
# the depthwise backward before its strip redesign (PERF.md §6, H100 80GB
# HBM3 at 700 W): the kernel alone (then without db), which the strip kernel
# must match at the config shape and beat by 1.25x at the flagship, and the
# op's whole backward (kernel, the partials' sum, g.sum for db), which it
# must beat at both
TILE_DW_BWD_MS = {"config": 0.0121, "flagship": 0.0392}
DW_BWD_GATE = {"config": 1.0, "flagship": 1.25}
TILE_DW_BWD_OP_MS = {"config": 0.0297, "flagship": 0.0753}
# the depthwise forward before its register-window redesign, the tile kernel
# (PERF.md §6, H100 80GB HBM3 at 700 W): the new kernel must be no slower at
# the serving and config shapes and 1.25x faster at the flagship
TILE_DW_FWD_MS = {"serving": 0.0095, "config": 0.0071, "flagship": 0.0191}
DW_FWD_GATE = {"serving": 1.0, "config": 1.0, "flagship": 1.25}


def sdpa_bias(mask: torch.Tensor, heads: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The additive key mask (0 or −1e30) in ``dtype`` as the raw
    efficient-attention ops take it, prepared as SDPA's front end prepares
    it: the key dimension padded to a multiple of 16 and sliced back,
    expanded to (B, H, T, T)."""
    B, T = mask.shape
    additive = torch.where(mask != 0, 0.0, -1e30).to(dtype)
    additive = F.pad(additive, (0, 16 - T % 16))[:, :T]
    return additive[:, None, None, :].expand(B, heads, T, T)


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def attention_case(rng: np.random.Generator, B: int, T: int):
    """q, k, v, g as (B, H, T, hd) views of (B, T, H, hd) tensors (the
    projections' layout), a key mask with random lengths and one row of
    length 1, and a dropout multiplier at the config's rate."""
    dev = torch.device("cuda")
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, T, HEADS, HEAD_DIM)).astype(np.float32))
                  .to(dev).transpose(1, 2) for _ in range(4))
    lengths = rng.integers(T // 2, T + 1, size=B)
    lengths[0], lengths[-1] = T, 1
    mask = torch.from_numpy((np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)).to(dev)
    rate = encoder_key("dropout")
    mult = torch.from_numpy(((rng.random((T, T)) >= rate) / (1 - rate)).astype(np.float32)).to(dev)
    return q, k, v, g, mask, mult


def phase_attention_depthwise(rng: np.random.Generator) -> dict:
    """Phase 10: each new kernel against its plain version at the path's
    shapes, and its times beside the plain version's and a library call's."""
    dev = torch.device("cuda")
    times, entries = {}, {}
    print(f"[kernels] SDPA yardsticks pinned to {SDPA_BACKEND} (torch.nn.attention.sdpa_kernel and "
          f"the raw aten._scaled_dot_product_efficient_attention[_backward] ops)")
    for label, (B, T) in KERNEL_SHAPES.items():
        q, k, v, g, mask, mult = attention_case(rng, B, T)
        errs = {}
        for m in (None, mult):
            out, rmax, rsum = attn.ATTN_FWD(q, k, v, mask, m)
            grads = attn.ATTN_BWD(q, k, v, out, g, rmax, rsum, mask, m)
            again = attn.ATTN_BWD(q, k, v, out, g, rmax, rsum, mask, m)
            want = attn.fused_attention_plain(q, k, v, mask, m)
            want_grads = attn.fused_attention_bwd_plain(q, k, v, mask, m, g)
            torch.cuda.synchronize()
            tag = "mult" if m is not None else "no mult"
            check(bool(torch.isfinite(out).all()), f"attention {label} {tag}: non-finite output")
            check(close(out, want, **ATTN_TOL), f"attention forward {label} {tag}: max abs err "
                  f"{max_err([out], [want])} > {ATTN_TOL}")
            for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
                check(close(a, b, **ATTN_GRAD_TOL), f"attention {name} {label} {tag}: max abs err "
                      f"{max_err([a], [b])} > {ATTN_GRAD_TOL}")
            pad = mask[:, None, :, None] == 0
            check(bool((grads[1].masked_select(pad) == 0).all() and (grads[2].masked_select(pad) == 0).all()),
                  f"attention {label} {tag}: padded keys got a nonzero dk / dv")
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"attention {label} {tag}: two backward runs differ")
            errs[tag] = (max_err([out], [want]), max_err(grads, want_grads))
        # the train step's case (dropout on) is timed; serving runs no multiplier
        m = None if label == "serving" else mult
        out, rmax, rsum = attn.ATTN_FWD(q, k, v, mask, m)
        additive = torch.where(mask[:, None, None, :] != 0, 0.0, -1e30)
        qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        # SDPA's own backward, alone, on the out and log-sum-exp of one
        # untimed forward (no dropout multiplier: SDPA has no such input)
        bias = sdpa_bias(mask, HEADS)
        s_out, s_lse, s_seed, s_off = torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k, v, bias, True, 0.0, False)
        sdpa_err = max_err([s_out], [attn.fused_attention_plain(q, k, v, mask)])

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=additive)
            torch.autograd.grad(o, (qg, kg, vg), g)

        def sdpa_bwd():
            torch.ops.aten._scaled_dot_product_efficient_attention_backward(
                g, q, k, v, bias, s_out, s_lse, s_seed, s_off, 0.0, [True, True, True, False], False)

        with sdpa_kernel(SDPA_BACKEND):
            t = {
                "attention_fwd": cuda_ms(lambda: attn.ATTN_FWD(q, k, v, mask, m)),
                "attention_bwd": cuda_ms(lambda: attn.ATTN_BWD(q, k, v, out, g, rmax, rsum, mask, m)),
                "attention_fwd_plain": cuda_ms(lambda: attn.fused_attention_plain(q, k, v, mask, m), iters=10),
                "attention_bwd_plain": cuda_ms(lambda: attn.fused_attention_bwd_plain(q, k, v, mask, m, g),
                                               iters=10),
                "attention_fwd_library": cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=additive)),
                "attention_bwd_library": cuda_ms(sdpa_bwd),
                "attention_fwd_bwd_library": cuda_ms(sdpa_fwd_bwd),
            }
        n, stats = B * HEADS * T * HEAD_DIM, B * HEADS * T
        extra = B * T + (T * T if m is not None else 0)  # the mask and the multiplier
        fwd_flops, bwd_flops = 4 * B * HEADS * T * T * HEAD_DIM, 10 * B * HEADS * T * T * HEAD_DIM
        fwd_bytes, bwd_bytes = 4 * (4 * n + 2 * stats + extra), 4 * (8 * n + 2 * stats + extra)
        # the kernels' products are 3×TF32: three tensor-core products per fp32 one
        b_fwd = bound(3 * fwd_flops, fwd_bytes, H100_TF32_FLOPS)
        b_bwd = bound(3 * bwd_flops, bwd_bytes, H100_TF32_FLOPS)
        simt = {"attention_fwd": bound(fwd_flops, fwd_bytes)[0], "attention_bwd": bound(bwd_flops, bwd_bytes)[0]}
        print(f"[kernels] {label} B={B} T'={T}: SDPA forward vs the plain version max abs err {sdpa_err:.3e}; "
              f"SDPA forward + backward (autograd) {t['attention_fwd_bwd_library']:.4f} ms; "
              f"attention bounds: fp32 SIMT (67 TFLOP/s) fwd {simt['attention_fwd']:.5f} / bwd "
              f"{simt['attention_bwd']:.5f} ms, 3xTF32 (3 x flops / 495 TFLOP/s) fwd {b_fwd[0]:.5f} / "
              f"bwd {b_bwd[0]:.5f} ms")
        for name in ("attention_fwd", "attention_bwd"):
            if label in SIMT_ATTN_MS:
                limit = SIMT_ATTN_MS[label][name] / ATTN_GATE
                print(f"[kernels] {label} {name}: {t[name]:.4f} ms against the SIMT kernel's {SIMT_ATTN_MS[label][name]} "
                      f"ms: {SIMT_ATTN_MS[label][name] / t[name]:.2f}x faster (gate: ≥ {ATTN_GATE}x, "
                      f"≤ {limit:.4f} ms)")
                check(t[name] <= limit, f"{name} at {label}: {t[name]:.4f} ms > {limit:.4f} ms, "
                      f"less than {ATTN_GATE}x faster than the SIMT kernel")

        x, gx = (torch.from_numpy(rng.normal(size=(B, T, CHANNELS_DW)).astype(np.float32)).to(dev)
                 for _ in range(2))
        w = torch.from_numpy(rng.normal(size=(TAPS, CHANNELS_DW)).astype(np.float32) / 4).to(dev)
        bias = torch.from_numpy(rng.normal(size=(CHANNELS_DW,)).astype(np.float32)).to(dev)
        y = dwc.DW_FWD(x, w, bias)
        dx, part = dwc.DW_BWD(x, w, gx)
        dx_again, part_again = dwc.DW_BWD(x, w, gx)
        want_dx, want_dwp = dwc.depthwise_conv1d_bwd_plain(x, w, gx)
        want_y = dwc.depthwise_conv1d_plain(x, w, bias)
        # the op's whole backward: the kernel, then one sum of its partials
        xr, wr, br = (v.clone().requires_grad_(True) for v in (x, w, bias))
        y_op = dwc.depthwise_conv1d(xr, wr, br)
        op_grads = torch.autograd.grad(y_op, (xr, wr, br), gx, retain_graph=True)
        torch.cuda.synchronize()
        sums = part.sum(dim=(0, 1))
        dw, db = sums[:TAPS], sums[TAPS]
        want_dw, want_db = want_dwp.sum(dim=0), gx.sum(dim=(0, 1))
        check(torch.equal(y, want_y), f"depthwise forward {label}: not bit-equal to the plain "
              f"version (max abs err {max_err([y], [want_y])})")
        check(close(dx, want_dx, **DW_TOL), f"depthwise dx {label}: {max_err([dx], [want_dx])}")
        for name, got, want in (("dw", dw, want_dw), ("db", db, want_db)):
            atol = DW_SUM_REL * float(want.abs().max())
            check(close(got, want, atol=atol, rtol=0),
                  f"depthwise {name} {label}: max abs err {max_err([got], [want])} > {atol}")
        check(torch.equal(dx, dx_again) and torch.equal(part, part_again),
              f"depthwise {label}: two backward runs differ")
        check(all(torch.equal(a, b) for a, b in zip(op_grads, (dx, dw, db))),
              f"depthwise {label}: the op's gradients are not the kernel's")
        strips = part.shape[1]
        fwd_ctas = dwc.DW_FWD.library.load().ssd_dw_fwd_ctas(B, T, CHANNELS_DW)
        pad = TAPS // 2
        xc = x.transpose(1, 2).contiguous()
        wc = w.t().contiguous()[:, None, :]
        xcg, wcg, bcg = (v.clone().requires_grad_(True) for v in (xc, wc, bias))
        gc = gx.transpose(1, 2).contiguous()

        def conv_fwd_bwd():
            o = F.conv1d(xcg, wcg, bcg, padding=pad, groups=CHANNELS_DW)
            torch.autograd.grad(o, (xcg, wcg, bcg), gc)

        t.update({
            "depthwise_fwd": cuda_ms(lambda: dwc.DW_FWD(x, w, bias)),
            "depthwise_bwd": cuda_ms(lambda: dwc.DW_BWD(x, w, gx)),
            "depthwise_bwd_op": cuda_ms(
                lambda: torch.autograd.grad(y_op, (xr, wr, br), gx, retain_graph=True)),
            "depthwise_fwd_plain": cuda_ms(lambda: dwc.depthwise_conv1d_plain(x, w, bias), iters=10),
            "depthwise_bwd_plain": cuda_ms(
                lambda: (dwc.depthwise_conv1d_bwd_plain(x, w, gx), gx.sum(dim=(0, 1))), iters=10),
            "depthwise_fwd_library": cuda_ms(lambda: F.conv1d(xc, wc, bias, padding=pad, groups=CHANNELS_DW)),
            "depthwise_bwd_library": cuda_ms(conv_fwd_bwd),
        })
        nx = B * T * CHANNELS_DW
        b_dwf = bound(2 * nx * TAPS, 4 * (2 * nx + TAPS * CHANNELS_DW + CHANNELS_DW))
        # the function's bytes: x and g read, dx written, w read, dw and db as
        # (B, K + 1, C) per-batch partials — the Pallas kernel's (B, K, C) dw
        # partials and db; the port's per-strip partials are its tiling's
        # cost, not the bound's
        b_dwb = bound(4 * nx * TAPS + nx,
                      4 * (3 * nx + TAPS * CHANNELS_DW + B * (TAPS + 1) * CHANNELS_DW))
        per = -(-(-(-T // 64)) // strips)  # 64-row tiles a strip, the last strip may have fewer
        print(f"[kernels] {label} B={B} T'={T} depthwise backward: {strips} strip(s) of ≤ {per} "
              f"tiles a batch row, {-(-CHANNELS_DW // 32) * strips * B} CTAs; "
              f"the op's whole backward (kernel + one sum of the (B, strips, K + 1, C) partials, "
              f"through autograd) {t['depthwise_bwd_op']:.4f} ms")
        limit = TILE_DW_FWD_MS[label] / DW_FWD_GATE[label]
        print(f"[kernels] {label} B={B} T'={T} depthwise forward: bit-equal to the plain version "
              f"(torch.equal), {fwd_ctas} CTAs; "
              f"{t['depthwise_fwd']:.4f} ms against the tile kernel's {TILE_DW_FWD_MS[label]} ms: "
              f"{TILE_DW_FWD_MS[label] / t['depthwise_fwd']:.2f}x faster (gate: ≥ {DW_FWD_GATE[label]}x, "
              f"≤ {limit:.4f} ms)")
        check(t["depthwise_fwd"] <= limit, f"depthwise_fwd at {label}: {t['depthwise_fwd']:.4f} ms "
              f"> {limit:.4f} ms")
        if label in TILE_DW_BWD_MS:
            limit = TILE_DW_BWD_MS[label] / DW_BWD_GATE[label]
            op_before = TILE_DW_BWD_OP_MS[label]
            print(f"[kernels] {label} depthwise_bwd: {t['depthwise_bwd']:.4f} ms against the tile "
                  f"kernel's {TILE_DW_BWD_MS[label]} ms: {TILE_DW_BWD_MS[label] / t['depthwise_bwd']:.2f}x "
                  f"faster (gate: ≥ {DW_BWD_GATE[label]}x, ≤ {limit:.4f} ms); the op's backward "
                  f"{t['depthwise_bwd_op']:.4f} ms against the tile kernel's op {op_before} ms "
                  f"({op_before / t['depthwise_bwd_op']:.2f}x; gate: faster)")
            check(t["depthwise_bwd"] <= limit, f"depthwise_bwd at {label}: {t['depthwise_bwd']:.4f} ms "
                  f"> {limit:.4f} ms")
            check(t["depthwise_bwd_op"] < op_before, f"the depthwise op's backward at {label}: "
                  f"{t['depthwise_bwd_op']:.4f} ms, not faster than the tile kernel's {op_before} ms")
        times[label] = t
        dw_err = (max_err([y], [want_y]),
                  max(max_err([dx], [want_dx]), max_err([dw], [want_dw]), max_err([db], [want_db])))
        rows = (("attention_fwd", errs["no mult" if m is None else "mult"][0], b_fwd),
                ("attention_bwd", errs["no mult" if m is None else "mult"][1], b_bwd),
                ("depthwise_fwd", dw_err[0], b_dwf), ("depthwise_bwd", dw_err[1], b_dwb))
        for name, err, (bnd, by) in rows:
            print(f"[kernels] {label} B={B} T'={T} {name}{' (dropout mult)' if m is not None and 'attention' in name else ''}: "
                  f"max_abs_err {err:.3e}; kernel {t[name]:.4f} ms, plain {t[name + '_plain']:.4f} ms, "
                  f"library {t[name + '_library']:.4f} ms, bound {bnd:.5f} ms ({by}); "
                  f"{bnd / t[name] * 100:.1f} % of the bound")
            if label == "config":
                entries[name] = {
                    "name": name, "route": "cuda",
                    "source": f"ssd_tpu_torch/csrc/{'attention' if 'attention' in name else 'depthwise_conv'}.cu",
                    "replaces": {"attention_fwd": "ssd_tpu/ops/attention.py:166",
                                 "attention_bwd": "ssd_tpu/ops/attention.py:187",
                                 "depthwise_fwd": "ssd_tpu/ops/depthwise_conv.py:84",
                                 "depthwise_bwd": "ssd_tpu/ops/depthwise_conv.py:107"}[name],
                    "launches": None, "max_abs_err": err, "ms": t[name],
                    "plain_ms": t[name + "_plain"], "bound_ms": bnd, "bound_by": by,
                    "library_ms": t[name + "_library"],
                }
        print(f"[kernels] {label}: attention errors (forward, gradients) {errs}; library = SDPA "
              f"({SDPA_BACKEND.name}) with the additive key mask: its forward, and its backward alone "
              f"beside the backward kernel; F.conv1d(groups=C) on (B, C, T) (forward; forward + "
              f"backward with the bias's gradient); timed only; the depthwise backward's plain time "
              f"includes db's g.sum")
    return {"entries": entries, "times": times}


def phase_fused_serving(run_dir: Path, default_ckpt: Path, rng: np.random.Generator) -> dict:
    """Phase 11a: the fused/pallas checkpoint through the engine and the
    server, then its log-probs against the CPU and the default config."""
    ckpt = build_run_dir(run_dir, **FUSED)
    check(all(torch.equal(a, b) for a, b in zip(load_checkpoint(ckpt)["state_dict"].values(),
                                                 load_checkpoint(default_ckpt)["state_dict"].values())),
          "the fused/pallas checkpoint's weights differ from the default one's")
    L = encoder_key("num_layers")
    engines, batches, launches = phase_main_path(
        ckpt, rng, sizes=(1, 8), per_call={"logmel": 1, "attention_fwd": L, "depthwise_fwd": L})
    phase_parity(ckpt, engines, batches)
    default = InferenceEngine.from_checkpoint(default_ckpt, device="cuda")
    for B, reqs in batches.items():
        lp, ol = engines["greedy"].forward(reqs)
        lp_d, ol_d = default.forward(reqs)
        err = float((lp - lp_d).abs().max())
        check(torch.equal(ol, ol_d), f"out lengths fused vs default at B={B}")
        check(close(lp, lp_d, **LOGPROB_TOL),
              f"fused/pallas vs default log-probs at B={B}: max abs err {err} > {LOGPROB_TOL}")
        fused_text = engines["greedy"].decode(lp, ol)[:B]
        check(fused_text == default.decode(lp_d, ol_d)[:B], f"greedy text fused vs default at B={B}")
        print(f"[fused] B={B}: log-probs vs the default configuration on the same weights, on the "
              f"card: max abs err {err:.3e} (tol {LOGPROB_TOL}); greedy text equal")
    return launches


def payload_differences(a, b, where: str = "") -> list:
    """Where two checkpoint payloads differ: tensors by ``torch.equal``
    (and dtype), containers by keys and length, other leaves by ``==``."""
    if isinstance(a, torch.Tensor):
        same = isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
        return [] if same else [where]
    if isinstance(a, dict):
        if not isinstance(b, dict) or list(a) != list(b):
            return [where]
        return [d for k in a for d in payload_differences(a[k], b[k], f"{where}/{k}")]
    if isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return [where]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in payload_differences(x, y, f"{where}/{i}")]
    return [] if a == b else [where]


def phase_reproducible(root: Path) -> None:
    """``train_from_config`` twice from one seed on the card, tpu_fast_plus as
    shipped and fused/pallas, 2 epochs of 2 overfit batches (dropout and
    SpecAugment drawn from the seeded generator), the second run with
    ``logging.async_checkpoints: true``: every logged loss, and every tensor
    and counter of ``last`` and ``best`` (weights, AdamW moments and steps,
    update count, epoch, step) equal bit for bit (the JAX package's
    contract, ``tests/test_determinism.py``; its writer's,
    ``tests/test_training.py``). The trainer holds cuDNN to its
    deterministic algorithms while it trains and restores the flags."""
    base = load_config(root / "config.json")
    base["optim"]["max_epochs"] = 2
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    for label, enc in (("default", {}), ("fused/pallas", FUSED)):
        t0 = time.perf_counter()
        runs = []
        for i in range(2):
            cfg = copy.deepcopy(base)
            cfg["model"]["encoder"].update(enc)
            cfg["logging"]["async_checkpoints"] = i == 1
            run = root / f"repro_{'fused' if enc else 'default'}_{i}"
            history = trainer.train_from_config(cfg, run, overfit_batches=2,
                                                device="cuda")["history"]
            check(len(history) == 2, f"reproducible {label}: {len(history)} epochs")
            for h in history:
                check_epoch(h, f"reproducible {label}")
            runs.append(([{f"{part} {k}": h[part][k] for part in ("train", "val")
                           for k in ("total", "ctc", "distill")} for h in history],
                         {name: load_checkpoint(run / name) for name in ("last", "best")}))
        check(runs[0][0] == runs[1][0], f"reproducible {label}: losses differ run to run: "
              f"{runs[0][0]} vs {runs[1][0]}")
        for name in ("last", "best"):
            bad = payload_differences(runs[0][1][name], runs[1][1][name])
            check(not bad, f"reproducible {label}: {len(bad)} entries of the async run's {name} "
                  f"differ from the sync run's (first {bad[:3]})")
        last = runs[0][1]["last"]
        check((last["epoch"], last["optimizer"]["update_count"]) == (2, 4),
              f"reproducible {label}: last holds epoch {last['epoch']}, "
              f"{last['optimizer']['update_count']} updates")
        check((torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == flags,
              f"reproducible {label}: the trainer left the cuDNN flags changed")
        print(f"[reproducible] {label}: two train_from_config runs from seed "
              f"{base['logging'].get('seed', 42)} (2 epochs of 2 overfit batches + val; the "
              f"second with async_checkpoints) gave equal losses {runs[0][0]}; last and best "
              f"(epochs {last['epoch']} and {runs[0][1]['best']['epoch']}: "
              f"{len(last['state_dict'])} tensors, AdamW moments and steps, counters) "
              f"torch.equal, in {time.perf_counter() - t0:.2f} s")


def phase_fused_train(root: Path, rng: np.random.Generator) -> dict:
    """Phase 11b: one epoch of 2 overfit batches with the two keys set,
    launch counts per step, then the trained checkpoint served."""
    cfg = load_config(root / "config.json")
    cfg["model"]["encoder"].update(FUSED)
    cfg["optim"]["max_epochs"] = 1
    L = encoder_key("num_layers")
    t0 = time.perf_counter()
    reset_counts()
    summary = trainer.train_from_config(cfg, root / "run_fused", overfit_batches=2, device="cuda")
    c = counts()
    n_train, n_eval = check_epoch(summary["history"][0], "fused")
    check(n_train == 2 and n_eval == 2, f"fused: {n_train} train / {n_eval} eval steps")
    want = dict.fromkeys(COUNTERS, 0)
    want.update(ctc_alpha=n_train + n_eval, ctc_beta=n_train,
                attention_fwd=L * (n_train + n_eval), depthwise_fwd=L * (n_train + n_eval),
                attention_bwd=L * n_train, depthwise_bwd=L * n_train)
    check(c == want, f"fused training launched {c}, expected {want}")
    h = summary["history"][0]
    print(f"[fused-train] 1 epoch, {n_train} train + {n_eval} eval steps in "
          f"{time.perf_counter() - t0:.2f} s; train total {h['train']['total']:.4f}, val total "
          f"{h['val']['total']:.4f}; launches {c}")
    engine = InferenceEngine.from_checkpoint(root / "run_fused" / "last", device="cuda")
    before = counts()
    hyps = engine.transcribe(requests(rng, 2))
    check(len(hyps) == 2 and all(isinstance(x, str) for x in hyps), f"served {hyps}")
    check(counts()["attention_fwd"] == before["attention_fwd"] + L,
          "the trained checkpoint was not served through the fused attention kernel")
    print(f"[fused-train] trained checkpoint served: {[x[:30] for x in hyps]}")
    return c


EVAL_BATCH = 2  # the corpus's 4 val utterances in 2 batches


@contextlib.contextmanager
def captured_decodes(seen: list):
    """Route ``evaluate``'s decoder factory through a wrapper that keeps,
    for each batch, the factory's keyword arguments, the log-probs and
    lengths the decoder was given and the texts it returned; decoding itself
    is unchanged."""
    build = ev.build_decoder

    def capturing(**kwargs):
        decode = build(**kwargs)

        def wrapped(log_probs, lengths):
            texts = decode(log_probs, lengths)
            seen.append((kwargs, log_probs.clone(), lengths.clone(), texts))
            return texts

        return wrapped

    ev.build_decoder = capturing
    try:
        yield seen
    finally:
        ev.build_decoder = build


def cpu_log_probs(ckpt: Path, cfg: dict) -> list:
    """The same checkpoint's log-probs on the CPU, batch by batch, over the
    same loader (no shuffle) as the card's run."""
    data = cfg["data"]
    seen = []

    def keep(log_probs, lengths):
        seen.append((log_probs, lengths))
        return [""] * log_probs.shape[0]

    ev.evaluate_checkpoint(ckpt, copy.deepcopy(cfg), Vocab.from_json(Path(data["vocab"])),
                           data["val_splits"], data["val_subsets"], keep,
                           batch_size=EVAL_BATCH, device="cpu")
    return seen


def phase_evaluate(root: Path, card: str) -> dict:
    """Phase 12: the eval CLI in-process on the card, greedy and beam-50, on
    phase 7's cached and raw checkpoints and phase 11b's fused/pallas one."""
    L = encoder_key("num_layers")
    totals = dict.fromkeys(COUNTERS, 0)
    for name in ("cached", "raw", "fused"):
        run = root / f"run_{name}"
        cfg = load_config(run / "config.json")
        raw = bool(cfg["data"].get("train_from_raw"))
        fused = cfg["model"]["encoder"].get("attention_impl") == "fused"
        reference = cpu_log_probs(run / "last", cfg)
        for decoder in ("greedy", "beam"):
            out = root / "eval" / f"{name}_{decoder}"
            argv = ["--checkpoint", str(run / "last"), "--device", "cuda", "--decoder", decoder,
                    "--batch-size", str(EVAL_BATCH), "--output", str(out)]
            if decoder == "beam":
                argv += ["--beam-width", "50"]
            seen = []
            with captured_decodes(seen):
                reset_counts()
                t0 = time.perf_counter()
                ev.main(argv)
                wall = time.perf_counter() - t0
                c = counts()
            metrics = json.loads((out / "metrics.json").read_text())
            preds = [json.loads(line) for line in (out / "predictions.jsonl").read_text().splitlines()]
            used = json.loads((out / "config_used.json").read_text())
            what = f"eval {name} {decoder}"
            check(used == cfg, f"{what}: config_used.json differs from the checkpoint's config")
            check(set(metrics) >= {"wer", "cer", "error_breakdown", "decode_latency_sec", "decoder",
                                   "data", "run_name"}, f"{what}: metrics.json keys {sorted(metrics)}")
            n = metrics["data"]["num_samples"]
            check(n == len(preds) == 4, f"{what}: {n} utterances scored, {len(preds)} predictions")
            check(metrics["decoder"]["beam_width"] == (50 if decoder == "beam" else None),
                  f"{what}: decoder block {metrics['decoder']}")
            batches = len(seen)
            want = dict.fromkeys(COUNTERS, 0)
            want["logmel"] = batches if raw else 0
            if fused:
                want["attention_fwd"] = want["depthwise_fwd"] = L * batches
            check(batches == len(reference) == 2 and c == want,
                  f"{what}: {batches} batches launched {c}, expected {want}")
            for k in totals:
                totals[k] += c[k]
            errs, texts, agree = [], [], 0
            for (kwargs, lp, ol, decoded), (lp_cpu, ol_cpu) in zip(seen, reference):
                check(lp.is_cuda and torch.equal(ol.cpu(), ol_cpu), f"{what}: out lengths differ")
                check(bool(torch.isfinite(lp).all()), f"{what}: non-finite log-probs")
                lp_host = lp.cpu()
                errs.append(float((lp_host - lp_cpu).abs().max()))
                check(close(lp_host, lp_cpu, **LOGPROB_TOL), f"{what}: card vs CPU log-probs max abs "
                      f"err {errs[-1]} > {LOGPROB_TOL}")
                texts += decoded
                cpu_texts = decoding.build_decoder(**kwargs)(lp_host, ol.cpu())
                agree += sum(a == b for a, b in zip(decoded, cpu_texts))
                # greedy is an argmax; the beam breaks ties as the JAX search
                # does (lower index first, the unsigned hash order) and adds
                # no atomics, so on these flat log-probs of barely trained
                # checkpoints, where scores tie at the beam cut, the card's
                # beam text is the CPU's too (scripts/beam_card_vs_cpu.py)
                check(decoded == cpu_texts, f"{what}: the card's texts {decoded} differ from "
                      f"the CPU decoder's {cpu_texts} on the same log-probs")
            check(texts == [p["hyp"] for p in preds],
                  f"{what}: predictions.jsonl is not what the decoder returned")
            lat = metrics["decode_latency_sec"]
            print(f"[eval] {name} {decoder}{'-50' if decoder == 'beam' else ''}: {n} utterances in "
                  f"{batches} batches, WER {metrics['wer']:.4f} CER {metrics['cer']:.4f}; "
                  f"{n / wall:.2f} utterances/s (the CLI call end to end, host clock: checkpoint "
                  f"load, data, forward, decode, files), decode p50 {lat['p50'] * 1e3:.3f} ms an "
                  f"utterance; log-probs vs the CPU forward max abs err {max(errs):.3e} (tol "
                  f"{LOGPROB_TOL}); {agree} of {n} texts equal to the CPU decoder's on the card's "
                  f"log-probs (gated); "
                  f"launches {({k: v for k, v in c.items() if v})}; {card}")
    return totals


# ------------------------------------------------------ LM fusion (phase 13)

LM_ORDER = 5
# the LM corpus: as many sentences as the reference's voiced train + val
# transcripts (90 % of its 1 588 parallel utterances, the 80/10/10 split),
# 5–20 words each, drawn Zipf (s = 1.1) from seeded random words of 1–10
# letters: a table of the in-domain LM's size, not a 20-line toy
LM_SENTENCES = 1429
LM_WORDS, LM_ZIPF = 20000, 1.1
LM_WEIGHTS = dict(alpha=0.6, beta=0.2)  # the search check's; serving and eval take the config's
LM_SCORE_ATOL = 1e-4  # final scores card vs CPU: the merged runs' log-sum-exp order only
LM_HOST_WIDTH = 8  # the host search is a Python loop: width 8 keeps its eval run short
LM_TIMED_RUNS = 1  # transcribes a search and batch: the p50 is their median, the first run included
LM_WALK_RUNS = 3  # decodes alone a search: their median
LM_PROFILE_FRAMES = 64  # frames of the decodes alone: a trace costs host time with its events


def lm_corpus(root: Path, rng: np.random.Generator) -> Path:
    """The LM's corpus as a voiced train + val JSONL index (``LM_SENTENCES``
    rows); returns its path."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, size=int(k))) for k in rng.integers(1, 11, LM_WORDS)]
    p = 1.0 / np.arange(1, LM_WORDS + 1) ** LM_ZIPF
    rows = []
    for i, n in enumerate(rng.integers(5, 21, LM_SENTENCES)):
        text = " ".join(words[k] for k in rng.choice(LM_WORDS, size=int(n), p=p / p.sum()))
        rows.append(dict(utterance_id=f"voiced_parallel_data/lm/{i}_0",
                         split="voiced_parallel_data",
                         subset="train" if 9 * i < 8 * LM_SENTENCES else "val", transcript=text))
    path = root / "lm" / "index.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    save_index(rows, path)
    return path


def decisive_log_probs(rng: np.random.Generator, vocab: Vocab, texts: list) -> tuple:
    """(B, T, V) log-probs that emit each text as char, blank, char, … 8
    above seeded noise (tests/test_device_lm.py's construction, more
    decisive), and lengths that end with each text."""
    T = 2 * max(len(t) for t in texts)
    logits = rng.normal(size=(len(texts), T, vocab.size)).astype(np.float32) * 0.5
    logits[:, :, vocab.blank_id] += 1.0
    for b, text in enumerate(texts):
        for t, cid in enumerate(vocab.encode(text)):
            logits[b, 2 * t, cid] += 8.0
            logits[b, 2 * t + 1, vocab.blank_id] += 8.0
    return torch.from_numpy(logits).log_softmax(-1), torch.tensor([2 * len(t) for t in texts])


def lm_search_parity(arpa: Path, table, rng: np.random.Generator, texts: list) -> None:
    """Phase 13b and c: the table's lookups on the card against the CPU's;
    the LM search at beam 50, top-k 16 on the card (no host sync inside it)
    against the CPU and the host search."""
    vocab = default_vocab()
    miss = rng.integers(0, 1 << 32, (2, 4096), dtype=np.uint64).astype(np.int64)
    k1 = torch.from_numpy(np.concatenate([table.keys1[table.used].astype(np.int64), miss[0]]))
    k2 = torch.from_numpy(np.concatenate([table.keys2[table.used].astype(np.int64), miss[1]]))
    want = dl._lookup(dl._packed_device_table(table, "cpu"), k1, k2)
    got = dl._lookup(dl._packed_device_table(table, "cuda"), k1.cuda(), k2.cuda())
    for name, g, w in zip(("hit", "logprob", "backoff"), got, want):
        check(torch.equal(g.cpu(), w), f"lookup {name}: the card's differ from the CPU's")
    n_keys = int(table.used.sum())
    check(bool(want[0][:n_keys].all()), "a packed n-gram is missing from the table")
    print(f"[lm] lookups: {n_keys} packed keys + 4096 seeded misses "
          f"({int(((k1 >> 31) | (k2 >> 31)).sum())} with a hash ≥ 2^31): hit, logprob and backoff "
          f"equal card vs CPU (torch.equal); {int(want[0][n_keys:].sum())} misses hit")

    lp, lengths = decisive_log_probs(rng, vocab, texts)
    kw = dict(blank_id=vocab.blank_id, pad_id=vocab.pad_id, space_id=vocab.token_to_id[" "],
              beam_width=50, token_top_k=16, **LM_WEIGHTS)
    lp_c, len_c = lp.cuda(), lengths.cuda()
    dl.beam_search_lm_device(lp_c, len_c, table, **kw)  # warm: allocator, library heuristics
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")  # any host sync inside the search raises
    try:
        card = dl.beam_search_lm_device(lp_c, len_c, table, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = dl.beam_search_lm_device(lp, lengths, table, **kw)

    def texts_of(out):
        chars, parents, _, best = (x.cpu().numpy() for x in out)
        return [vocab.decode(p) for p in traceback(chars, parents, best)]

    card_texts, cpu_texts = texts_of(card), texts_of(cpu)
    host = beam_search_lm_batch(lp.numpy(), lengths.numpy(), vocab, NGramLM.from_arpa(arpa),
                                beam_width=50, **LM_WEIGHTS)
    check(card_texts == cpu_texts == host, f"LM search text: card {card_texts} / CPU {cpu_texts} / "
          f"host {host}")
    check(card_texts == texts, f"LM search on decisive log-probs decoded {card_texts}, not {texts}")
    err = float((card[2].cpu().sort(dim=1).values - cpu[2].sort(dim=1).values).abs().max())
    check(err <= LM_SCORE_ATOL, f"LM search final scores card vs CPU: max abs err {err}")
    print(f"[lm] search B={len(texts)} T={lp.shape[1]} beam 50 top-k 16 α {LM_WEIGHTS['alpha']} "
          f"β {LM_WEIGHTS['beta']}: no host sync inside it (sync debug mode 'error'); text equal on "
          f"the card, the CPU and the host search, and to the emitted sentences; final scores max "
          f"abs err card vs CPU {err:.3e} (tol {LM_SCORE_ATOL}); queued in {queued * 1e3:.1f} ms, "
          f"done in {card_s * 1e3:.1f} ms (host clock)")


def lm_serving(ckpt: Path, arpa: Path, rng: np.random.Generator) -> tuple:
    """Phase 13d, the counted run: the fused/pallas checkpoint served with
    ``lm_path``, ``/transcribe`` at B = 1 and 8. Returns the requests, the
    replies and the launches."""
    L = encoder_key("num_layers")
    server = serve(ckpt, port=0, host="127.0.0.1", decoder="beam", lm_path=arpa, warmup=False,
                   max_wait_ms=5.0, device="cuda")
    check(server.batcher.engine.has_lm, "the server's engine did not load the LM")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    batches = {B: [rng.normal(size=(12000, CHANNELS)).astype(np.float32) for _ in range(B)]
               for B in (1, 8)}
    served = {}
    reset_counts()
    try:
        for B, reqs in batches.items():
            payload = ({"emg": encode_npy(reqs[0])} if B == 1
                       else {"emg_list": [encode_npy(a) for a in reqs]})
            served[B] = post(port, "/transcribe", payload)["hypotheses"]
    finally:
        server.shutdown()
        server.batcher.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = counts()
    check(not thread.is_alive(), "server thread did not stop")
    want = dict.fromkeys(COUNTERS, 0)
    want.update(logmel=len(batches), attention_fwd=L * len(batches),
                depthwise_fwd=L * len(batches))
    check(launches == want, f"{len(batches)} LM transcribes launched {launches}, expected {want}")
    print(f"[lm] served the fused/pallas checkpoint with --lm-path (α {server.batcher.engine.alpha}, β "
          f"{server.batcher.engine.beta}, the config's) at B = 1 and 8; launches: "
          f"{ {k: v for k, v in launches.items() if v} }")
    return batches, served, launches


def lm_latency(ckpt: Path, arpa: Path, table, batches: dict, served: dict,
               rng: np.random.Generator, card: str) -> None:
    """Phase 13e: p50 per utterance of ``engine.transcribe``, LM-fused
    beam-50 beside plain beam-50, on the served requests (the first LM run
    held to the served reply); then each search's decode alone on the first
    ``LM_PROFILE_FRAMES`` frames of one request's log-probs (the time is
    per frame, the trace stays short): the LM search with the table's own
    backoff walk and with the generic one, and each search's device busy
    share."""
    lm_engine = InferenceEngine.from_checkpoint(ckpt, decoder="beam", lm_path=arpa, device="cuda")
    plain = InferenceEngine.from_checkpoint(ckpt, decoder="beam", device="cuda")
    engines = (("beam-50", plain), ("LM beam-50", lm_engine))
    for B, reqs in batches.items():
        per_utt = {name: [] for name, _ in engines}
        texts = []
        for _ in range(LM_TIMED_RUNS):  # the two searches alternate: both see the same host drift
            for name, eng in engines:
                t0 = time.perf_counter()
                out = eng.transcribe(reqs)
                per_utt[name].append((time.perf_counter() - t0) / B * 1e3)
                if eng is lm_engine:
                    texts.append(out)
        check(texts[0] == served[B] and len(texts[0]) == B,
              f"/transcribe with the LM at B={B}: {served[B]} != engine {texts[0]}")
        p50 = {name: float(np.percentile(v, 50)) for name, v in per_utt.items()}
        runs = "; ".join(f"{name} " + ", ".join(f"{v:.3f}" for v in vs) for name, vs in per_utt.items())
        print(f"[lm] latency B={B} 12 000 samples: LM-fused beam-50 p50 {p50['LM beam-50']:.3f} ms/"
              f"utterance beside plain beam-50 {p50['beam-50']:.3f} (median of {LM_TIMED_RUNS} "
              f"alternating runs each, host clock, transcribe end to end; runs: {runs}); the first "
              f"LM run equal to the served reply, {sum(t == texts[0] for t in texts)} of "
              f"{LM_TIMED_RUNS} LM runs alike; {card}")
    vocab = lm_engine.vocab
    lp, ol = lm_engine.forward([batches[1][0]])
    lp, ol = lp[:, :LM_PROFILE_FRAMES].contiguous(), ol.clamp(max=LM_PROFILE_FRAMES)
    kw = dict(beam_width=lm_engine.beam_width, alpha=lm_engine.alpha, beta=lm_engine.beta,
              blank_bias=lm_engine.blank_bias, token_top_k=lm_engine.token_top_k)
    generic = dataclasses.replace(table, unk_tailed=True)  # the same answers, more lookups
    walks = {"beam-50": lambda: plain.decode(lp, ol),
             f"LM beam-50 ({'generic' if table.unk_tailed else 'specialised'} walk)":
                 lambda: dl.beam_decode_lm_device(lp, ol, vocab, table, **kw),
             "LM beam-50 (generic walk)":
                 lambda: dl.beam_decode_lm_device(lp, ol, vocab, generic, **kw)}
    decodes = {}
    for name, fn in walks.items():
        def decode(fn=fn):
            out = fn()
            torch.cuda.synchronize()
            return out

        decodes[name] = decode
    decoded = {name: decode() for name, decode in decodes.items()}  # builds the tables' device copies
    runs = {name: [] for name in decodes}
    for _ in range(LM_WALK_RUNS):  # alternating, as the transcribes
        for name, decode in decodes.items():
            t0 = time.perf_counter()
            decode()
            runs[name].append((time.perf_counter() - t0) * 1e3)
    for name, decode in decodes.items():
        ms = float(np.median(runs[name]))
        print(f"[lm] {name} decode alone B=1 T'={LM_PROFILE_FRAMES}: {ms:.3f} ms = "
              f"{ms / LM_PROFILE_FRAMES:.3f} ms a frame (median of {LM_WALK_RUNS} alternating runs, "
              f"host clock; runs {', '.join(f'{r:.3f}' for r in runs[name])}); {card}")
        profile_step(decode, ms, f"{name} decode B=1 T'={LM_PROFILE_FRAMES}", tag="lm")
    lm_texts = list(decoded.values())[1:]
    check(lm_texts[0] == lm_texts[1], f"the two backoff walks decoded {lm_texts}")


def lm_evaluate(root: Path, arpa: Path, card: str) -> None:
    """Phase 13f: the eval CLI with ``--lm-path`` on the card, the device
    and the host backends, on phase 7's cached checkpoint."""
    run = root / "run_cached"
    alpha, beta = (shipped_config()["decoding"][k] for k in ("alpha", "beta"))
    for backend, width in (("device", 50), ("host", LM_HOST_WIDTH)):
        out = root / "eval" / f"lm_{backend}"
        argv = ["--checkpoint", str(run / "last"), "--device", "cuda", "--decoder", "beam",
                "--beam-width", str(width), "--lm-path", str(arpa), "--lm-backend", backend,
                "--batch-size", str(EVAL_BATCH), "--output", str(out)]
        seen = []
        with captured_decodes(seen):
            reset_counts()
            t0 = time.perf_counter()
            ev.main(argv)
            wall = time.perf_counter() - t0
            c = counts()
        metrics = json.loads((out / "metrics.json").read_text())
        preds = [json.loads(line) for line in (out / "predictions.jsonl").read_text().splitlines()]
        what = f"eval with the LM, {backend} backend"
        block = metrics["decoder"]
        check((block["lm_path"], block["alpha"], block["beta"], block["beam_width"]) ==
              (str(arpa), alpha, beta, width), f"{what}: decoder block {block}")
        check(len(seen) == 2 and all(kw["host_lm"] == (backend == "host") for kw, *_ in seen)
              and all(lp.is_cuda for _, lp, _, _ in seen), f"{what}: decoder calls")
        check(c == dict.fromkeys(COUNTERS, 0), f"{what}: the cached checkpoint launched {c}")
        texts = [t for *_, decoded in seen for t in decoded]
        check(texts == [p["hyp"] for p in preds] and len(preds) == 4,
              f"{what}: predictions.jsonl is not what the decoder returned")
        print(f"[lm] eval {backend} LM beam-{width}: {len(preds)} utterances, WER "
              f"{metrics['wer']:.4f} CER {metrics['cer']:.4f}; decode p50 "
              f"{metrics['decode_latency_sec']['p50'] * 1e3:.3f} ms an utterance; "
              f"{len(preds) / wall:.2f} utterances/s (the CLI call end to end, host clock); {card}")


def phase_lm(root: Path, fused_ckpt: Path, rng: np.random.Generator, card: str) -> dict:
    """Phase 13: LM fusion on the card. Returns the served run's launches."""
    arpa = root / "lm" / "char_5gram.arpa"
    steps = {}
    t0 = time.perf_counter()
    build_char_lm.main(["--index", str(lm_corpus(root, rng)), "--order", str(LM_ORDER),
                        "--output", str(arpa)])
    table = dl.load_packed_lm(arpa, default_vocab())
    sentences = arpa.with_suffix(".txt").read_text().splitlines()
    check(table.order == LM_ORDER and arpa.with_name(arpa.name + ".packed.npz").exists(),
          f"build_char_lm: order {table.order}, sidecar missing?")
    n_words = sum(len(t.split()) for t in sentences)
    steps["build"] = time.perf_counter() - t0
    print(f"[lm] build_char_lm: {len(sentences)} sentences, {n_words} words → {LM_ORDER}-gram "
          f"({len(NGramLM.from_arpa(arpa).logprob)} n-grams; unk_tailed {table.unk_tailed}) → "
          f"{table.size} slots ({table.size * 16 / 2**20:.2f} MiB on the card) in "
          f"{steps['build']:.2f} s")
    t0 = time.perf_counter()
    lm_search_parity(arpa, table, rng, sentences[:8])
    steps["parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches, served, launches = lm_serving(fused_ckpt, arpa, rng)
    steps["serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm_latency(fused_ckpt, arpa, table, batches, served, rng, card)
    steps["latency"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm_evaluate(root, arpa, card)
    steps["eval"] = time.perf_counter() - t0
    print("[lm] phase 13 seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    return launches


# ------------------------------------------ streaming and export (phase 14)

STREAM_SAMPLES = 12000  # the long stream: 13 windows at the default geometry
STREAM_PIECE = 100  # samples a feed: 100 ms of signal at 1 kHz
ONE_WINDOW_SAMPLES, ONE_WINDOW_CHUNK = 5000, 512  # 469 frames, one window with S = 512
CONCURRENT_SAMPLES = 4000  # each of the 4 concurrent sessions: 4 windows
STREAM_TOL = 2e-3  # emitted log-probs vs the offline forward and vs the CPU (as LOGPROB_TOL)
EXPORT_BATCHES = (1, 8)
EXPORT_RUNS = 10  # alternating exported / eager calls timed a batch size
OVERHEAD_CALLS, OVERHEAD_REPS = 200, 5  # host enqueue time of the ops and their wrappers


def stream_pieces(emg: np.ndarray) -> list:
    return [emg[i : i + STREAM_PIECE] for i in range(0, len(emg), STREAM_PIECE)]


def run_stream(engine: InferenceEngine, emg: np.ndarray, **geometry) -> tuple:
    """Feed ``emg`` in 100-sample pieces and finish. Returns the transcriber,
    its text, the emitted log-probs and the host milliseconds of the feeds
    that ran no window and of those that ran one."""
    st = ChunkedStreamingTranscriber(engine, **geometry)
    feed_ms = ([], [])
    for piece in stream_pieces(emg):
        before = st.windows
        t0 = time.perf_counter()
        st.feed(piece)
        feed_ms[st.windows > before].append((time.perf_counter() - t0) * 1e3)
    text = st.finish()
    return st, text, np.concatenate(st._log_probs), feed_ms


@contextlib.contextmanager
def timed_windows(host_ms: list, event_ms: list):
    """Time every streaming window: on the host clock from a synchronize to
    the end of the window's own device→host copy, and by CUDA events
    around it."""
    window = streaming.stream_window

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = window(*args, **kwargs)
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        event_ms.append(start.elapsed_time(end))
        return out

    streaming.stream_window = timed
    try:
        yield
    finally:
        streaming.stream_window = window


class Launches:
    """The launches of a phase's gated runs: each run must move every count
    by ``per_call`` × its calls (and no other count); ``total`` sums them."""

    def __init__(self, per_call: dict):
        self.per_call = {k: per_call.get(k, 0) for k in COUNTERS}
        self.total = dict.fromkeys(COUNTERS, 0)

    def add(self, what: str, before: dict, calls: int) -> None:
        moved = {k: v - before[k] for k, v in counts().items()}
        want = {k: v * calls for k, v in self.per_call.items()}
        check(moved == want, f"{what}: launches moved {moved}, expected {want} ({calls} calls)")
        for k, v in moved.items():
            self.total[k] += v


def stream_on_card(ckpt: Path, rng: np.random.Generator, launches: Launches, card: str,
                   steps: dict) -> None:
    """Phase 14a: chunked streaming on the card."""
    t0 = time.perf_counter()
    engine = InferenceEngine.from_checkpoint(ckpt, device="cuda")
    hop = engine.feat_cfg.hop_length
    emg = rng.normal(size=(ONE_WINDOW_SAMPLES, CHANNELS)).astype(np.float32)
    before = counts()
    st, text, lp, _ = run_stream(engine, emg, chunk_frames=ONE_WINDOW_CHUNK)
    launches.add("the one-window stream", before, st.windows)
    check(st.windows == 1, f"the one-window stream ran {st.windows} windows")
    check(text == engine.transcribe([emg])[0], f"one-window stream {text!r} != offline transcribe")
    off_lp, off_len = engine.forward([emg])
    off_lp = off_lp[0, : int(off_len[0])].cpu()
    check(tuple(off_lp.shape) == lp.shape, f"emitted {lp.shape} vs offline {tuple(off_lp.shape)}")
    err_off = float((off_lp - torch.from_numpy(lp)).abs().max())
    check(err_off <= STREAM_TOL, f"one-window stream vs offline log-probs: {err_off} > {STREAM_TOL}")
    print(f"[stream] one window ({ONE_WINDOW_SAMPLES} samples, S {ONE_WINDOW_CHUNK}): text equal to "
          f"engine.transcribe ({text[:30]!r}); {lp.shape[0]} emitted frames, max abs err vs the "
          f"offline forward {err_off:.3e} (tol {STREAM_TOL})")
    steps["one window"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    emg = rng.normal(size=(STREAM_SAMPLES, CHANNELS)).astype(np.float32)
    host_ms, event_ms = [], []
    before = counts()
    with timed_windows(host_ms, event_ms):
        st, text, lp, (idle_ms, window_ms) = run_stream(engine, emg)
    launches.add("the long stream", before, st.windows)
    check(st.windows == len(host_ms) >= 2, f"the long stream ran {st.windows} windows")
    check(bool(np.isfinite(lp).all()) and lp.shape[1] == engine.vocab.size,
          f"the long stream's log-probs: {lp.shape}, finite {np.isfinite(lp).all()}")
    print(f"[stream] {STREAM_SAMPLES} samples in {STREAM_PIECE}-sample feeds at S {st.S}, W {st.W}, "
          f"R {st.R} (Tw {st.Tw} frames, Lw {st.Lw} samples, T' {st.Tw // st.factor}): "
          f"{st.windows} windows; a window p50 {np.percentile(host_ms, 50):.3f} ms host clock "
          f"(sync, then to its device→host copy), {np.percentile(event_ms, 50):.3f} ms CUDA events; "
          f"a feed p50 {np.percentile(idle_ms + window_ms, 50):.3f} ms over "
          f"{len(idle_ms) + len(window_ms)} feeds ({len(window_ms)} that ran a window: p50 "
          f"{np.percentile(window_ms, 50):.3f} ms; the others {np.percentile(idle_ms, 50):.3f} ms); "
          f"algorithmic latency R·hop = {st.R * hop} ms; {card}")
    steps["long stream"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cpu = InferenceEngine.from_checkpoint(ckpt, device="cpu")
    _, cpu_text, cpu_lp, _ = run_stream(cpu, emg)
    check(cpu_lp.shape == lp.shape, f"card {lp.shape} vs CPU {cpu_lp.shape} emitted frames")
    err_cpu = float(np.abs(cpu_lp - lp).max())
    check(err_cpu <= STREAM_TOL, f"the long stream card vs CPU log-probs: {err_cpu} > {STREAM_TOL}")
    check(text == cpu_text, f"the long stream's text card vs CPU: {text!r} vs {cpu_text!r}")
    print(f"[stream] card vs CPU engine on the same weights: emitted log-probs max abs err "
          f"{err_cpu:.3e} (tol {STREAM_TOL}); greedy text equal ({text[:30]!r})")
    steps["cpu stream"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    server = serve(ckpt, port=0, host="127.0.0.1", warmup=False, device="cuda")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        before = counts()
        sid = post(port, "/stream/start", {})["session"]
        for piece in stream_pieces(emg):
            post(port, "/stream/feed", {"session": sid, "emg": encode_npy(piece)})
        served = post(port, "/stream/finish", {"session": sid})
        launches.add("the stream through /stream/*", before, st.windows)
        expect_http_error(port, "/stream/feed", {"session": sid, "emg": encode_npy(emg[:10])}, 404)
    finally:
        server.shutdown()
        server.batcher.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    check(served == {"hypothesis": text, "final": True},
          f"/stream/finish {served} != the direct transcriber's {text!r}")
    print(f"[stream] /stream/start → {len(stream_pieces(emg))} × /stream/feed → /stream/finish on "
          f"the card: the direct transcriber's text; the finished session → 404")
    steps["http"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    streams = [rng.normal(size=(CONCURRENT_SAMPLES, CHANNELS)).astype(np.float32) for _ in range(4)]
    sequential = [run_stream(engine, e)[1:3] for e in streams]
    results, errors = [None] * 4, []

    def session(i):
        try:
            results[i] = run_stream(engine, streams[i])[1:3]
        except Exception as exc:  # re-raised below, after every thread is joined
            errors.append(exc)

    threads = [threading.Thread(target=session, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    check(not any(t.is_alive() for t in threads), "a concurrent session did not end")
    if errors:
        raise errors[0]
    errs = [float(np.abs(a[1] - b[1]).max()) for a, b in zip(results, sequential)]
    check(all(a[0] == b[0] for a, b in zip(results, sequential)) and max(errs) <= 1e-5,
          f"4 concurrent sessions vs one at a time: texts {[r[0][:20] for r in results]} vs "
          f"{[r[0][:20] for r in sequential]}, log-prob errors {errs}")
    print(f"[stream] 4 concurrent sessions on one engine ({CONCURRENT_SAMPLES} samples each): texts "
          f"equal to one session at a time; log-probs bit-equal: "
          f"{all(np.array_equal(a[1], b[1]) for a, b in zip(results, sequential))} (max abs err "
          f"{max(errs):.3e}, gate 1e-5)")
    steps["concurrent"] = time.perf_counter() - t0


def export_on_card(ckpt: Path, out: Path, rng: np.random.Generator, launches: Launches,
                   card: str, steps: dict) -> None:
    """Phase 14b: the export artifact on the card."""
    t0 = time.perf_counter()
    export_checkpoint(ckpt, out, batch_sizes=EXPORT_BATCHES, sample_lengths=(BUCKET,),
                      device="cuda")
    manifest = json.loads((out / "manifest.json").read_text())
    check(manifest["platforms"] == ["cuda"], f"manifest platforms {manifest['platforms']}")
    L = encoder_key("num_layers")
    for bucket in manifest["buckets"]:
        nodes = [str(n.target) for n in torch.export.load(out / bucket["file"]).graph.nodes]
        ops = {op: nodes.count(f"ssd_tpu_torch.{op}.default")
               for op in ("logmel_core", "attention_fwd", "depthwise_fwd")}
        check(ops == {"logmel_core": 1, "attention_fwd": L, "depthwise_fwd": L},
              f"{bucket['file']}: custom-op nodes {ops}")
        print(f"[export] {bucket['file']} (B {bucket['batch']}, {bucket['samples']} samples): "
              f"exported and saved in {bucket['export_seconds']:.2f} s; custom-op nodes {ops}")
    steps["export"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    artifact = ExportedTranscriber.load(out, device="cuda")
    engine = InferenceEngine.from_checkpoint(ckpt, device="cuda")
    vocab = engine.vocab
    steps["load"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for B in EXPORT_BATCHES:
        # lengths past 4 × SAMPLE_BUCKET: the engine pads to the artifact's bucket
        reqs = [rng.normal(size=(int(n), CHANNELS)).astype(np.float32)
                for n in rng.integers(10300, BUCKET + 1, size=B)]
        before = counts()
        tokens, n_tok = artifact.call(reqs)
        launches.add(f"the exported call at B={B}", before, 1)
        lp, ol = engine.forward(reqs)
        want_tokens, want_n = greedy_decode(lp, ol, blank_id=vocab.blank_id, pad_id=vocab.pad_id)
        check(np.array_equal(n_tok, want_n[:B].cpu().numpy())
              and np.array_equal(tokens, want_tokens[:B].cpu().numpy()),
              f"exported tokens at B={B} differ from the engine's greedy decode")
        texts = [vocab.decode(tokens[i, : n_tok[i]]) for i in range(B)]
        check(texts == engine.transcribe(reqs), f"exported texts at B={B} != engine.transcribe")
        runs = {"exported": [], "eager": []}
        for _ in range(EXPORT_RUNS):  # alternating: both see the same host drift
            for name, fn in (("exported", artifact.transcribe), ("eager", engine.transcribe)):
                t1 = time.perf_counter()
                fn(reqs)
                runs[name].append((time.perf_counter() - t1) * 1e3)
        p50 = {k: float(np.percentile(v, 50)) for k, v in runs.items()}
        print(f"[export] B={B}: tokens and texts equal to the engine's greedy decode; a call p50 "
              f"exported {p50['exported']:.3f} ms vs eager engine.transcribe {p50['eager']:.3f} ms "
              f"({EXPORT_RUNS} alternating runs each, host clock, end to end; "
              f"{p50['exported'] / B:.3f} vs {p50['eager'] / B:.3f} ms an utterance); {card}")
    steps["exported calls"] = time.perf_counter() - t0


def op_overhead(card: str, steps: dict) -> None:
    """Phase 14c: the host time of one call of each custom op beside its
    wrapper called directly, at the serving path's B = 1 shapes: what the
    dispatcher adds to every eager forward."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = feat.FeaturizerConfig(**shipped_config()["features"]["emg"])
    H, D, K = encoder_key("num_heads"), encoder_key("d_model"), encoder_key("depthwise_conv_kernel_size")
    T = (cfg.frame_count(BUCKET) + 1) // 2  # T' of the bucket after the ×2 subsampler
    gen = torch.Generator(device=dev).manual_seed(SEED)
    emg = torch.randn((1, BUCKET, CHANNELS), generator=gen, device=dev)
    qkv = torch.randn((3, 1, T, H, D // H), generator=gen, device=dev).transpose(2, 3)
    mask = torch.ones((1, T), dtype=torch.int32, device=dev)
    x = torch.randn((1, T, D), generator=gen, device=dev)
    w, b = torch.randn((K, D), generator=gen, device=dev), torch.randn((D,), generator=gen, device=dev)
    pairs = {
        "logmel_core": (lambda: feat.LOGMEL(emg, cfg), lambda: feat.logmel_core(emg, cfg)),
        "attention_fwd": (lambda: attn.ATTN_FWD(*qkv, mask, None),
                          lambda: torch.ops.ssd_tpu_torch.attention_fwd(*qkv, mask, None)),
        "depthwise_fwd": (lambda: dwc.DW_FWD(x, w, b),
                          lambda: torch.ops.ssd_tpu_torch.depthwise_fwd(x, w, b)),
    }

    def host_us(fn) -> float:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(OVERHEAD_CALLS):
            fn()
        us = (time.perf_counter() - t1) / OVERHEAD_CALLS * 1e6
        torch.cuda.synchronize()
        return us

    per_forward = 0.0
    for name, (wrapper, op) in pairs.items():
        for fn in (wrapper, op):
            fn()
        runs = {"wrapper": [], "op": []}
        for _ in range(OVERHEAD_REPS):
            runs["wrapper"].append(host_us(wrapper))
            runs["op"].append(host_us(op))
        med = {k: float(np.median(v)) for k, v in runs.items()}
        extra = med["op"] - med["wrapper"]
        per_forward += extra * (1 if name == "logmel_core" else encoder_key("num_layers"))
        print(f"[ops] {name}: host {med['op']:.2f} µs a call through the custom op vs "
              f"{med['wrapper']:.2f} µs through the wrapper alone: {extra:+.2f} µs of dispatch "
              f"(medians of {OVERHEAD_REPS} × {OVERHEAD_CALLS} calls, enqueue only)")
    print(f"[ops] the dispatch added to one fused/pallas forward (1 log-mel, "
          f"{encoder_key('num_layers')} attention, {encoder_key('num_layers')} depthwise): "
          f"{per_forward:+.2f} µs of host time; {card}")
    steps["op overhead"] = time.perf_counter() - t0


def phase_stream_export(root: Path, rng: np.random.Generator, card: str) -> dict:
    """Phase 14: streaming and the export artifact on the card, on phase
    11b's fused/pallas checkpoint. Returns the launches of its gated runs."""
    ckpt = root / "run_fused" / "last"
    L = encoder_key("num_layers")
    launches = Launches({"logmel": 1, "attention_fwd": L, "depthwise_fwd": L})
    steps = {}
    stream_on_card(ckpt, rng, launches, card, steps)
    export_on_card(ckpt, root / "export", rng, launches, card, steps)
    op_overhead(card, steps)
    print("[stream/export] phase 14 seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    print(f"[stream/export] launches of the gated runs: "
          f"{ {k: v for k, v in launches.total.items() if v} }")
    return launches.total


# ------------------------------------- tpu_scaled_large in bf16 (phase 15)

LARGE_PATH = CONFIG_PATH.parent / "tpu_scaled_large.yaml"
# the config's batch on 768-frame buckets (T' 384, raw samples in (6 400,
# 7 680]); serving: the 12 800-sample bucket (T' 625)
LARGE_TRAIN_SHAPE, LARGE_SERVE_SHAPE = (32, 384), (8, 625)
LARGE_SAMPLES = (6401, 7681)  # raw lengths that pad to one 7 680-sample (768-frame) bucket
LARGE_TRAIN, LARGE_VAL = 64, 16  # corpus: 2 overfit batches of 32, 1 val batch of 16
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores, SXM, 700 W
# bf16 kernel tolerances: the attention kernels round p ∘ μ before dividing
# by the row sum (the plain version, as the Pallas kernel, rounds the
# normalised weights) and sum on the tensor cores: within a few bf16
# roundings of each output's largest magnitude. The depthwise forward and
# dx are bit-equal; dw and db are fp32 partials
ATTN_BF16_REL = 2.0**-6
DW_BF16_SUM_REL = 1e-4
# The first bf16 attention and depthwise kernels' times (PERF.md §6, in
# parentheses; H100 80GB HBM3 at 700 W), printed beside this run's:
# (kernel, shape) → ms
PR10_BF16_MS = {("attention_fwd_bf16", "train"): 0.1769, ("attention_bwd_bf16", "train"): 0.7202,
                ("attention_fwd_bf16", "serve"): 0.1056, ("attention_bwd_bf16", "serve"): 0.4842,
                ("depthwise_fwd_bf16", "train"): 0.0488, ("depthwise_bwd_bf16", "train"): 0.0977,
                ("depthwise_fwd_bf16", "serve"): 0.0215, ("depthwise_bwd_bf16", "serve"): 0.0418}
# card vs CPU (and a stream window vs the offline forward), both bf16: a
# rounding flipped anywhere in the blocks moves the encoder's output by a
# fraction of a percent, so the logits — and the log-probs — by that
# fraction of their scale: within 2⁻⁶ of the largest |log-prob|
BF16_LOGPROB_REL = 2.0**-6
BF16_LOSS_RTOL = 1e-2  # card vs CPU train step, both bf16
# bf16 gradients card vs CPU, per tensor as a fraction of its largest fp32
# gradient: within twice the CPU's own bf16-vs-fp32 gap, plus 1 %
BF16_GRAD_NOISE_FACTOR, BF16_GRAD_FLOOR = 2.0, 1e-2
LARGE_RATE_STEPS = 5
# blocks of tpu_scaled_large (12 as shipped) in phases 15, 16 and 19: the run's time budget
# (phase 21 serves all 12); a multiple of 4 keeps phase 19c's 4-stage pipeline whole
LARGE_BLOCKS = 4
LARGE_PARITY_BLOCKS, LARGE_PARITY_B = 2, 2  # card vs CPU step: depth cut for the CPU's sake


@functools.cache
def large_config() -> dict:
    """``configs/tpu_scaled_large.yaml`` through ``load_config``, its
    ``parallel:`` section cut to one device (phase 15 runs on one card;
    phase 18b runs the block as shipped over two) and its depth to
    ``LARGE_BLOCKS``; callers copy it."""
    cfg = load_config(LARGE_PATH)
    cfg["parallel"] = {"data": "auto", "model": 1}
    cfg["model"]["encoder"]["num_layers"] = LARGE_BLOCKS
    return cfg


def large_key(key: str):
    return large_config()["model"]["encoder"][key]


def large_model(**enc) -> "torch.nn.Module":
    """The full-width, full-depth model on the CPU, random weights from
    ``SEED`` (the same whatever ``enc`` selects)."""
    cfg = {"model": copy.deepcopy(large_config()["model"])}
    cfg["model"]["encoder"].update(enc)
    model = build_model(cfg, input_dim=large_key("input_dim"), vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(SEED))
    return model


def large_serving_model() -> "torch.nn.Module":
    """:func:`large_model` with phase 3's ×10 CTC head: peaked log-probs, so
    the greedy tokens compared are not near-ties that a rounding reorders."""
    model = large_model()
    with torch.no_grad():
        model.ctc_head.fc.weight.mul_(10.0)
    return model


def bf16_cases(rng: np.random.Generator, B: int, T: int, drop: bool):
    """Attention and depthwise inputs at the large model's width in bf16:
    q, k, v, g (B, H, T, hd) views of (B, T, H, hd), a key mask with one row
    of length 1, the bf16 multiplier (1/0.9 rounds to 1.109375) or None;
    x, g (B, T, C), taps and bias."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    H, D, K = large_key("num_heads"), large_key("d_model"), large_key("depthwise_conv_kernel_size")
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, T, H, D // H)).astype(np.float32))
                  .to(dev, bf).transpose(1, 2) for _ in range(4))
    lengths = rng.integers(T // 2, T + 1, size=B)
    lengths[0], lengths[-1] = T, 1
    mask = torch.from_numpy((np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)).to(dev)
    rate = large_key("dropout")
    mult = (torch.from_numpy(rng.random((T, T)) >= rate).to(dev, bf) / (1 - rate)) if drop else None
    x, gx = (torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32)).to(dev, bf)
             for _ in range(2))
    w = torch.from_numpy((rng.normal(size=(K, D)) / 4).astype(np.float32)).to(dev, bf)
    b = torch.from_numpy(rng.normal(size=(D,)).astype(np.float32)).to(dev, bf)
    return (q, k, v, g, mask, mult), (x, gx, w, b)


def rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def large_kernels(rng: np.random.Generator, card: str, steps: dict) -> dict:
    """Phase 15a: the four bf16 kernel instances against their plain bf16
    versions at the large model's shapes (each backward run twice: the runs
    bit-equal), timed beside the plain versions, SDPA's bf16 efficient
    backend and a bf16 ``F.conv1d``."""
    t0 = time.perf_counter()
    entries = {}
    H, D, K = large_key("num_heads"), large_key("d_model"), large_key("depthwise_conv_kernel_size")
    hd = D // H
    for label, (B, T) in (("train", LARGE_TRAIN_SHAPE), ("serve", LARGE_SERVE_SHAPE)):
        drop = label == "train"  # the train step's dropout multiplier; serving has none
        (q, k, v, g, mask, mult), (x, gx, w, b) = bf16_cases(rng, B, T, drop)
        # the training call writes the output in fp32 too (õ: the backward's D)
        out, out32, rmax, rsum = attn.ATTN_FWD_BF16(q, k, v, mask, mult, fp32_out=True)
        served = attn.ATTN_FWD_BF16(q, k, v, mask, mult)
        grads = attn.ATTN_BWD_BF16(q, k, v, out32, g, rmax, rsum, mask, mult)
        again = attn.ATTN_BWD_BF16(q, k, v, out32, g, rmax, rsum, mask, mult)
        want = attn.fused_attention_plain(q, k, v, mask, mult)
        want_grads = attn.fused_attention_bwd_plain(q, k, v, mask, mult, g)
        y = dwc.DW_FWD_BF16(x, w, b)
        dx, part = dwc.DW_BWD_BF16(x, w, gx)
        dx_again, part_again = dwc.DW_BWD_BF16(x, w, gx)
        want_y = dwc.depthwise_conv1d_plain(x, w, b)
        want_dx, want_dwp = dwc.depthwise_conv1d_bwd_plain(x, w, gx)
        torch.cuda.synchronize()
        a_err = [rel_err(a, bb) for a, bb in zip((out, *grads), (want, *want_grads))]
        a_abs = [max_err([a.float()], [bb.float()]) for a, bb in zip((out, *grads), (want, *want_grads))]
        for name, e in zip(("out", "dq", "dk", "dv"), a_err):
            check(e <= ATTN_BF16_REL, f"bf16 attention {name} at {label}: {e:.3e} of its largest "
                  f"> {ATTN_BF16_REL}")
        check(all(t.dtype == torch.bfloat16 and bool(torch.isfinite(t).all()) for t in (out, *grads)),
              f"bf16 attention at {label}: outputs not finite bf16")
        check(torch.equal(out, out32.to(torch.bfloat16))
              and all(torch.equal(a, bb) for a, bb in zip((out, rmax, rsum), served)),
              f"bf16 attention at {label}: the training call's out is not its fp32 output rounded, "
              f"or differs from the serving call's")
        pad = mask[:, None, :, None] == 0
        check(bool((grads[1].masked_select(pad) == 0).all() and (grads[2].masked_select(pad) == 0).all()),
              f"bf16 attention at {label}: padded keys got a nonzero dk / dv")
        check(all(torch.equal(a, bb) for a, bb in zip(grads, again)),
              f"bf16 attention at {label}: two backward runs differ")
        check(torch.equal(y, want_y), f"bf16 depthwise forward at {label}: not bit-equal to the plain "
              f"version (max abs err {max_err([y.float()], [want_y.float()])})")
        check(torch.equal(dx, want_dx), f"bf16 depthwise dx at {label}: not bit-equal to the plain "
              f"version (max abs err {max_err([dx.float()], [want_dx.float()])})")
        check(torch.equal(dx, dx_again) and torch.equal(part, part_again),
              f"bf16 depthwise at {label}: two backward runs differ")
        sums = part.sum(dim=(0, 1))
        d_err = [rel_err(sums[:K], want_dwp.sum(dim=0)), rel_err(sums[K], gx.float().sum(dim=(0, 1)))]
        d_abs = max_err([sums[:K], sums[K]], [want_dwp.sum(dim=0), gx.float().sum(dim=(0, 1))])
        check(max(d_err) <= DW_BF16_SUM_REL, f"bf16 depthwise dw / db at {label}: {d_err} of the "
              f"largest > {DW_BF16_SUM_REL}")
        print(f"[large-kernels] {label} B={B} T'={T} H={H} hd={hd} C={D} K={K}"
              f"{' (dropout mult)' if drop else ''}: attention out/dq/dk/dv within "
              f"{', '.join(f'{e:.2e}' for e in a_err)} of their largest (gate {ATTN_BF16_REL:.3e}); "
              f"depthwise forward and dx bit-equal (torch.equal), dw/db within "
              f"{d_err[0]:.2e}/{d_err[1]:.2e} (gate {DW_BF16_SUM_REL}), two backward runs "
              f"bit-equal ({part.shape[1]} strip(s) a batch row)")

        bias = sdpa_bias(mask, H, torch.bfloat16)
        additive = torch.where(mask[:, None, None, :] != 0, 0.0, -1e30).to(torch.bfloat16)
        s_out, s_lse, s_seed, s_off = torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k, v, bias, True, 0.0, False)
        pad_t = K // 2
        xc, wc = x.transpose(1, 2).contiguous(), w.t().contiguous()[:, None, :]
        xcg, wcg, bcg = (t.clone().requires_grad_(True) for t in (xc, wc, b))
        gc = gx.transpose(1, 2).contiguous()

        def conv_fwd_bwd():
            o = F.conv1d(xcg, wcg, bcg, padding=pad_t, groups=D)
            torch.autograd.grad(o, (xcg, wcg, bcg), gc)

        with sdpa_kernel(SDPA_BACKEND):
            t = {
                "attention_fwd_bf16": cuda_ms(
                    lambda: attn.ATTN_FWD_BF16(q, k, v, mask, mult, fp32_out=drop)),
                "attention_fwd_bf16_serving": cuda_ms(lambda: attn.ATTN_FWD_BF16(q, k, v, mask, mult)),
                "attention_bwd_bf16": cuda_ms(
                    lambda: attn.ATTN_BWD_BF16(q, k, v, out32, g, rmax, rsum, mask, mult)),
                "attention_fwd_bf16_plain": cuda_ms(
                    lambda: attn.fused_attention_plain(q, k, v, mask, mult), iters=10),
                "attention_bwd_bf16_plain": cuda_ms(
                    lambda: attn.fused_attention_bwd_plain(q, k, v, mask, mult, g), iters=10),
                "attention_fwd_bf16_library": cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=additive)),
                "attention_bwd_bf16_library": cuda_ms(
                    lambda: torch.ops.aten._scaled_dot_product_efficient_attention_backward(
                        g, q, k, v, bias, s_out, s_lse, s_seed, s_off, 0.0,
                        [True, True, True, False], False)),
                "depthwise_fwd_bf16": cuda_ms(lambda: dwc.DW_FWD_BF16(x, w, b)),
                "depthwise_bwd_bf16": cuda_ms(lambda: dwc.DW_BWD_BF16(x, w, gx)),
                "depthwise_fwd_bf16_plain": cuda_ms(lambda: dwc.depthwise_conv1d_plain(x, w, b),
                                                    iters=10),
                "depthwise_bwd_bf16_plain": cuda_ms(
                    lambda: (dwc.depthwise_conv1d_bwd_plain(x, w, gx), gx.float().sum(dim=(0, 1))),
                    iters=10),
                "depthwise_fwd_bf16_library": cuda_ms(
                    lambda: F.conv1d(xc, wc, b, padding=pad_t, groups=D)),
                "depthwise_bwd_bf16_library": cuda_ms(conv_fwd_bwd),
            }
        n = B * H * T * hd
        extra = 4 * B * T + (2 * T * T if drop else 0)  # the int32 mask and the bf16 multiplier
        nx = B * T * D
        bounds = {
            # the function's own bytes, as the Pallas kernels move them: the
            # forward reads bf16 q, k, v and writes out; the backward reads
            # q, k, v, g and writes dq, dk, dv. The fp32 õ and the row
            # statistics this design keeps between the calls are left out.
            "attention_fwd_bf16": bound(4 * B * H * T * T * hd, 2 * 4 * n + extra, H100_BF16_FLOPS),
            "attention_bwd_bf16": bound(10 * B * H * T * T * hd, 2 * 7 * n + extra, H100_BF16_FLOPS),
            # fp32 arithmetic on upcast values, off the tensor cores
            "depthwise_fwd_bf16": bound(2 * nx * K, 2 * (2 * nx + K * D + D)),
            "depthwise_bwd_bf16": bound(4 * nx * K + nx, 2 * (3 * nx + K * D) + 4 * B * (K + 1) * D),
        }
        # max abs err against the plain version: out; the largest of dq, dk,
        # dv; 0 for the bit-equal depthwise forward; dw / db (dx is bit-equal)
        errs = {"attention_fwd_bf16": a_abs[0], "attention_bwd_bf16": max(a_abs[1:]),
                "depthwise_fwd_bf16": 0.0, "depthwise_bwd_bf16": d_abs}
        sources = {"attention": ("ssd_tpu_torch/csrc/attention.cu", "ssd_tpu/ops/attention.py:166",
                                 "ssd_tpu/ops/attention.py:187"),
                   "depthwise": ("ssd_tpu_torch/csrc/depthwise_conv.cu",
                                 "ssd_tpu/ops/depthwise_conv.py:84",
                                 "ssd_tpu/ops/depthwise_conv.py:107")}
        for name, (bnd, by) in bounds.items():
            before = PR10_BF16_MS.get((name, label))
            print(f"[large-kernels] {label} B={B} T'={T} {name}: kernel {t[name]:.4f} ms"
                  f"{f' (PR 10: {before} ms)' if before else ''}, plain "
                  f"{t[name + '_plain']:.4f} ms, library {t[name + '_library']:.4f} ms, bound "
                  f"{bnd:.5f} ms ({by}); {bnd / t[name] * 100:.1f} % of the bound; max abs err "
                  f"{errs[name]:.3e}; {card}")
            if name == "attention_fwd_bf16":
                print(f"[large-kernels] {label} B={B} T'={T} attention_fwd_bf16 "
                      f"{'training call (writes õ in fp32)' if drop else 'serving call'} above; "
                      f"the serving call alone {t['attention_fwd_bf16_serving']:.4f} ms")
            if label == "train":
                src, fwd, bwd = sources[name.split("_")[0]]
                entries[name] = {
                    "name": name, "route": "cuda", "source": src,
                    "replaces": fwd if "_fwd" in name else bwd,
                    "launches": None, "max_abs_err": errs[name], "ms": t[name],
                    "plain_ms": t[name + "_plain"], "bound_ms": bnd, "bound_by": by,
                    "library_ms": t[name + "_library"],
                }
    print(f"[large-kernels] bounds: bytes at 3.35 TB/s (attention: the function's bf16 q, k, v, out / "
          f"g, dq, dk, dv, the mask and multiplier; depthwise: bf16 tensors, fp32 partials); "
          f"attention operations (4 / 10 · B·H·T'²·hd) at the H100's dense bf16 tensor-core peak "
          f"{H100_BF16_FLOPS / 1e12:.0f} TFLOP/s, the depthwise stencil's at the fp32 SIMT "
          f"{H100_FP32_FLOPS / 1e12:.0f} TFLOP/s (it computes in fp32); library = SDPA ({SDPA_BACKEND.name}, bf16, "
          f"additive mask; backward alone through the raw aten op) and F.conv1d(groups=C) in bf16")
    steps["kernels"] = time.perf_counter() - t0
    return entries


def bf16_agree(what: str, got: torch.Tensor, want: torch.Tensor) -> str:
    """Two bf16 computations of the same (T', V) log-probs: within
    ``BF16_LOGPROB_REL`` of ``want``'s largest magnitude, and the same greedy
    token on every frame whose top-two margin in ``want`` exceeds twice that
    (elsewhere a rounding may reorder near-tied tokens)."""
    got, want = got.float().cpu(), want.float().cpu()
    check(got.shape == want.shape, f"{what}: log-probs {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite log-probs")
    err, tol = float((got - want).abs().max()), BF16_LOGPROB_REL * float(want.abs().max())
    check(err <= tol, f"{what}: log-probs max abs err {err} > {tol}")
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = got.argmax(-1) == want.argmax(-1)
    check(bool(same[decisive].all()), f"{what}: greedy tokens differ on "
          f"{int((~same[decisive]).sum())} decisive frames")
    return (f"log-probs max abs err {err:.3e} (tol {tol:.3e}: {BF16_LOGPROB_REL} of the largest "
            f"|log-prob|) over {len(want)} frames; greedy tokens equal on all {int(decisive.sum())} "
            f"frames whose top-two margin > {2 * tol:.3e} ({int(same.sum())} of {len(want)} equal "
            f"overall)")


def large_run_dir(run_dir: Path, model, **enc) -> Path:
    """``model``'s weights saved with the large config (``enc`` over its
    encoder block) as a checkpoint under ``run_dir``."""
    run_dir.mkdir(parents=True, exist_ok=True)
    default_vocab().to_json(run_dir / "vocab.json")
    cfg = copy.deepcopy(large_config())
    cfg["data"] = {"vocab": str(run_dir / "vocab.json")}
    cfg["model"]["encoder"].update(enc)
    save_checkpoint(run_dir, model.state_dict(), cfg)
    return run_dir / "last"


def large_serving(root: Path, model, rng: np.random.Generator, card: str, steps: dict,
                  fused: bool) -> dict:
    """Phase 15b (a configuration): the engine and the server (phase 3/4's
    counted run), the card's log-probs against the CPU engine, a streaming
    window, an exported call (fused/pallas) and greedy p50."""
    name = "fused" if fused else "shipped"
    enc = FUSED if fused else {}
    L = large_key("num_layers")
    per_call = {"logmel": 1}
    if fused:
        per_call.update(attention_fwd_bf16=L, depthwise_fwd_bf16=L)
    t0 = time.perf_counter()
    ckpt = large_run_dir(root / f"large_{name}", model, **enc)
    engines, batches, launches = phase_main_path(ckpt, rng, sizes=(1, 8), per_call=per_call)
    steps[f"{name} engine+server"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cpu = InferenceEngine.from_checkpoint(ckpt, device="cpu")
    reqs = batches[1]
    lp, ol = engines["greedy"].forward(reqs)
    lp_cpu, ol_cpu = cpu.forward(reqs)
    check(lp.dtype == torch.float32, f"{name}: log-probs reach the decoders as {lp.dtype}")
    check(torch.equal(ol.cpu(), ol_cpu), f"{name}: out lengths card vs CPU")
    n = int(ol_cpu[0])
    print(f"[large-serve] {name}: B=1 card vs CPU engine (both bf16): "
          f"{bf16_agree(f'{name} card vs CPU', lp[0, :n], lp_cpu[0, :n])}")
    del cpu
    steps[f"{name} cpu parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    engine = engines["greedy"]
    counted = Launches(per_call)
    emg = rng.normal(size=(ONE_WINDOW_SAMPLES, CHANNELS)).astype(np.float32)
    before = counts()
    st, text, slp, _ = run_stream(engine, emg, chunk_frames=ONE_WINDOW_CHUNK)
    counted.add(f"{name}: the one-window stream", before, st.windows)
    check(st.windows == 1, f"{name}: the one-window stream ran {st.windows} windows")
    off_lp, off_len = engine.forward([emg])
    # the window's running z-norm and padding differ from the offline
    # forward's at fp32 rounding, which bf16 may round apart
    print(f"[large-serve] {name}: a one-window stream ({ONE_WINDOW_SAMPLES} samples, S "
          f"{ONE_WINDOW_CHUNK}, text {text[:30]!r}) vs the offline forward: "
          f"{bf16_agree(f'{name} stream', torch.from_numpy(slp), off_lp[0, : int(off_len[0])])}")
    if fused:
        out = root / f"large_{name}_export"
        export_checkpoint(ckpt, out, batch_sizes=(1,), sample_lengths=(BUCKET,), device="cuda")
        manifest = json.loads((out / "manifest.json").read_text())
        nodes = [str(nd.target) for nd in
                 torch.export.load(out / manifest["buckets"][0]["file"]).graph.nodes]
        ops = {op: nodes.count(f"ssd_tpu_torch.{op}.default")
               for op in ("logmel_core", "attention_fwd", "depthwise_fwd")}
        check(ops == {"logmel_core": 1, "attention_fwd": L, "depthwise_fwd": L},
              f"{name}: exported custom-op nodes {ops}")
        artifact = ExportedTranscriber.load(out, device="cuda")
        req = [rng.normal(size=(12000, CHANNELS)).astype(np.float32)]
        before = counts()
        tokens, n_tok = artifact.call(req)
        counted.add(f"{name}: the exported call", before, 1)
        elp, eol = engine.forward(req)
        vocab = engine.vocab
        want_tokens, want_n = greedy_decode(elp, eol, blank_id=vocab.blank_id, pad_id=vocab.pad_id)
        check(np.array_equal(n_tok, want_n[:1].cpu().numpy())
              and np.array_equal(tokens, want_tokens[:1].cpu().numpy()),
              f"{name}: exported tokens differ from the engine's greedy decode")
        print(f"[large-serve] {name}: exported (B 1, {BUCKET} samples) in "
              f"{manifest['buckets'][0]['export_seconds']:.2f} s with custom-op nodes {ops}; its "
              f"tokens equal the engine's greedy decode")
    for B in (1, 8):
        req = [rng.normal(size=(12000, CHANNELS)).astype(np.float32) for _ in range(B)]
        engine.transcribe(req)
        per_utt = []
        for _ in range(5):
            t1 = time.perf_counter()
            engine.transcribe(req)
            per_utt.append((time.perf_counter() - t1) / B)
        print(f"[large-serve] {name}: greedy B={B} 12 000 samples p50 "
              f"{np.percentile(per_utt, 50) * 1e3:.3f} ms an utterance (5 runs, host clock, "
              f"transcribe end to end); {card}")
    steps[f"{name} stream/export/latency"] = time.perf_counter() - t0
    return {k: launches[k] + counted.total[k] for k in COUNTERS}


def large_corpus(root: Path, rng: np.random.Generator, n_train: int = LARGE_TRAIN) -> Path:
    """``n_train`` (64) train + 16 val raw-EMG utterances of one 768-frame bucket with
    WavLM-width teacher features, and the large config (parallel cut) with
    the corpus's paths as the run's JSON config; returns its path."""
    root.mkdir(parents=True, exist_ok=True)
    vocab_path = root / "vocab.json"
    default_vocab().to_json(vocab_path)
    chars = list("abcdefghijklmnopqrstuvwxyz") + [" "] * 6 + list("',.?")
    rows = []
    for i in range(n_train + LARGE_VAL):
        uid = f"voiced_parallel_data/s1/{i}_0"
        n = int(rng.integers(*LARGE_SAMPLES))
        raw_path = root / "raw" / f"{i}_0_emg.npy"
        raw_path.parent.mkdir(parents=True, exist_ok=True)
        np.save(raw_path, rng.normal(size=(n, CHANNELS)).astype(np.float32))
        tpath = root / "features" / "teacher" / f"{uid}.npy"
        tpath.parent.mkdir(parents=True, exist_ok=True)
        np.save(tpath, rng.normal(size=(n // 20, TEACHER_DIM)).astype(np.float32))
        text = "".join(rng.choice(chars, size=int(rng.integers(30, 101))))
        rows.append(dict(utterance_id=uid, split="voiced_parallel_data",
                         subset="train" if i < n_train else "val", speaker="s1", stem=f"{i}_0",
                         emg_path=str(raw_path), audio_path=None, transcript=text,
                         sentence_index=i, book="", has_audio=False, metadata_json="{}"))
    save_index(rows, root / "index.jsonl")
    cfg = copy.deepcopy(large_config())
    cfg["data"].update(index=str(root / "index.jsonl"), features_root=str(root / "features"),
                       vocab=str(vocab_path))
    path = root / "config.json"
    path.write_text(json.dumps(cfg, indent=2))
    return path


def large_train(root: Path, cfg_path: Path, card: str, steps: dict, fused: bool) -> dict:
    """Phase 15c (a configuration): ``train_from_config`` on the card for one
    epoch of 2 overfit batches of 32 from raw EMG, bf16 teacher features,
    remat on; launches counted; the trained checkpoint evaluated by the
    eval CLI."""
    name = "fused" if fused else "shipped"
    L = large_key("num_layers")
    t0 = time.perf_counter()
    cfg = load_config(cfg_path)
    if fused:
        cfg["model"]["encoder"].update(FUSED)
    cfg["optim"]["max_epochs"] = 1
    enc, data = cfg["model"]["encoder"], cfg["data"]
    check(enc["compute_dtype"] == "bfloat16" and enc["remat"] and enc["scan_layers"]
          and data["train_from_raw"] and data["teacher_dtype"] == "bfloat16",
          f"{name}: the config is not the shipped bf16 / remat / raw recipe: {enc}, {data}")
    reset_counts()
    with captured_log(trainer.logger.name) as said:
        summary = trainer.train_from_config(cfg, root / f"run_{name}", overfit_batches=2,
                                            device="cuda")
    c = counts()
    # the shipped logging.async_checkpoints: true is honoured, not logged away
    check(cfg["logging"]["async_checkpoints"] is True
          and any("written on a background thread" in m for m in said)
          and not any("not honoured" in m for m in said),
          f"large {name}: the trainer's log {said} does not show async checkpoints honoured")
    n_train, n_eval = check_epoch(summary["history"][0], f"large {name}")
    check(n_train == 2 and n_eval == 1, f"large {name}: {n_train} train / {n_eval} eval steps")
    want = dict.fromkeys(COUNTERS, 0)
    want.update(logmel=n_train + n_eval, ctc_alpha=n_train + n_eval, ctc_beta=n_train)
    if fused:
        # remat recomputes every block's forward in the backward: twice a train step
        want.update(attention_fwd_bf16=L * (2 * n_train + n_eval),
                    depthwise_fwd_bf16=L * (2 * n_train + n_eval),
                    attention_bwd_bf16=L * n_train, depthwise_bwd_bf16=L * n_train)
    check(c == want, f"large {name} training launched {c}, expected {want}")
    h = summary["history"][0]
    print(f"[large-train] {name}: 1 epoch of {n_train} train steps (B {cfg['optim']['batch_size']}, "
          f"768-frame buckets from raw EMG, bf16, remat, bf16 teacher) + {n_eval} eval step in "
          f"{time.perf_counter() - t0:.2f} s (checkpoints included); train total "
          f"{h['train']['total']:.4f}, val total {h['val']['total']:.4f}; launches "
          f"{ {k: v for k, v in c.items() if v} }; checkpoint written on the writer's thread "
          f"(logging.async_checkpoints as shipped)")
    steps[f"{name} train"] = time.perf_counter() - t0
    totals = dict(c)
    if fused:
        t0 = time.perf_counter()
        out = root / "eval_fused"
        reset_counts()
        ev.main(["--checkpoint", str(root / f"run_{name}" / "last"), "--device", "cuda",
                 "--decoder", "greedy", "--batch-size", "8", "--output", str(out)])
        c = counts()
        metrics = json.loads((out / "metrics.json").read_text())
        n = metrics["data"]["num_samples"]
        batches = -(-n // 8)
        want = dict.fromkeys(COUNTERS, 0)
        want.update(logmel=batches, attention_fwd_bf16=L * batches, depthwise_fwd_bf16=L * batches)
        check(n == LARGE_VAL and c == want, f"large eval: {n} utterances, launches {c}, expected {want}")
        print(f"[large-eval] the eval CLI on the trained fused/pallas checkpoint: {n} utterances in "
              f"{batches} batches, WER {metrics['wer']:.4f} CER {metrics['cer']:.4f}; launches "
              f"{ {k: v for k, v in c.items() if v} }")
        for k in totals:
            totals[k] += c[k]
        steps["eval"] = time.perf_counter() - t0
    return totals


def large_batch(rng: np.random.Generator, B: int) -> dict:
    """A raw-EMG batch of one 7 680-sample bucket with bf16 teacher bits."""
    lengths = rng.integers(*LARGE_SAMPLES, size=B)
    lengths[0] = LARGE_SAMPLES[1] - 1
    emg = np.zeros((B, LARGE_SAMPLES[1] - 1, CHANNELS), np.float32)
    S = 128
    tok_len = rng.integers(S // 2, S + 1, size=B)
    tokens = np.zeros((B, S), np.int32)
    for i, n in enumerate(lengths):
        emg[i, :n] = rng.normal(size=(n, CHANNELS))
        tokens[i, : tok_len[i]] = rng.integers(3, 48, size=tok_len[i])
    teacher = rng.normal(size=(B, 384, TEACHER_DIM)).astype(np.float32)
    return {"emg": emg, "emg_lengths": lengths.astype(np.int32), "tokens": tokens,
            "token_lengths": tok_len.astype(np.int32), "weight": np.ones(B, np.float32),
            "teacher": bf16_bits(teacher), "teacher_lengths": (lengths // 20).astype(np.int32)}


def large_rate(rng: np.random.Generator, card: str, steps: dict, fused: bool) -> None:
    """Phase 15d (a configuration): step p50 at B = 32, T' 384 from raw EMG
    (the trainer's step: log-mel, encoder, heads, CTC, distillation,
    backward, AdamW) with remat and without, peak memory of each, and the
    profiler's device-busy time with remat."""
    name = "fused" if fused else "shipped"
    t0 = time.perf_counter()
    model = large_model(**(FUSED if fused else {})).cuda()
    opt, _ = build_optimizer(large_config(), model.parameters(), 1000)
    featurize = feat.FeaturizerConfig.from_config(large_config())
    batch = trainer.to_device(large_batch(rng, LARGE_TRAIN_SHAPE[0]), torch.device("cuda"))
    gen = torch.Generator("cuda").manual_seed(SEED + 1)

    def timed_step():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.zero_grad()
        total, _ = trainer._losses(model, batch, LAMBDAS, BLANK, False, True, gen, None, featurize)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        total.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        return t2 - t1, t3 - t2, time.perf_counter() - t3

    results = {}
    for remat in (True, False):
        model.encoder.cfg = dataclasses.replace(model.encoder.cfg, remat=remat)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            timed_step()
        split = np.asarray([timed_step() for _ in range(LARGE_RATE_STEPS)]) * 1e3
        step_ms = float(np.percentile(split.sum(axis=1), 50))
        results[remat] = (step_ms, torch.cuda.max_memory_allocated() / 2**30)
        fwd, bwd, upd = (float(np.percentile(split[:, i], 50)) for i in range(3))
        print(f"[large-rate] {name} remat={remat} B={LARGE_TRAIN_SHAPE[0]} 768 frames (T' "
              f"{LARGE_TRAIN_SHAPE[1]}) from raw EMG, bf16: step p50 {step_ms:.3f} ms (forward + "
              f"loss {fwd:.3f}, backward {bwd:.3f}, optimizer {upd:.3f}; {LARGE_RATE_STEPS} warm "
              f"steps, host clock with a sync around each part) = "
              f"{LARGE_TRAIN_SHAPE[0] / step_ms * 1e3:.2f} utterances/s; peak memory "
              f"{results[remat][1]:.2f} GiB; {card}")
        if remat:
            profile_step(timed_step, step_ms, f"{name} bf16 remat", tag="large-rate")
    print(f"[large-rate] {name}: remat saves {results[False][1] - results[True][1]:.2f} GiB of peak "
          f"memory ({results[True][1]:.2f} vs {results[False][1]:.2f}) for "
          f"{results[True][0] / results[False][0]:.3f}x the step time")
    model.encoder.cfg = dataclasses.replace(model.encoder.cfg, remat=True)
    if fused:
        large_remat_equal(model, rng)
    del model, opt, batch
    torch.cuda.empty_cache()
    steps[f"{name} rate"] = time.perf_counter() - t0


def large_remat_equal(model, rng: np.random.Generator) -> None:
    """Gradients of a dropout-0.1 train step (the trainer's loss: CTC +
    distillation, from raw EMG) with remat ``full`` and ``dots`` equal, bit
    for bit, to the step without remat on the card (the same generator seed;
    the running statistics equal too), under the trainer's cuDNN settings.
    The CTC gradient adds without atomics, so the real loss repeats itself."""
    batch = trainer.to_device(large_batch(rng, 4), torch.device("cuda"))
    featurize = feat.FeaturizerConfig.from_config(large_config())
    stats = {k: v.clone() for k, v in model.named_buffers()}
    runs = {}
    with trainer._deterministic_cudnn(torch.device("cuda")):
        for label, remat, policy in (("none", False, "full"), ("full", True, "full"),
                                     ("dots", True, "dots")):
            model.encoder.cfg = dataclasses.replace(model.encoder.cfg, remat=remat,
                                                    remat_policy=policy)
            model.load_state_dict(stats, strict=False)
            model.zero_grad(set_to_none=True)
            gen = torch.Generator("cuda").manual_seed(SEED + 7)
            total, _ = trainer._losses(model, batch, LAMBDAS, BLANK, False, True, gen, None,
                                       featurize)
            total.backward()
            runs[label] = ({n: p.grad.clone() for n, p in model.named_parameters()},
                           {n: b.clone() for n, b in model.named_buffers()}, float(total.detach()))
    model.encoder.cfg = dataclasses.replace(model.encoder.cfg, remat=True, remat_policy="full")
    for label in ("full", "dots"):
        check(runs[label][2] == runs["none"][2],
              f"remat {label}: loss {runs[label][2]} vs {runs['none'][2]} without remat")
        for i, what in enumerate(("gradient", "running statistic")):
            bad = [n for n, t in runs["none"][i].items() if not torch.equal(runs[label][i][n], t)]
            check(not bad, f"remat {label}: {len(bad)} {what}s differ from the step without remat "
                  f"(first: {bad[:3]})")
    print(f"[large-remat] fused/pallas, dropout {large_key('dropout')}, B=4, the trainer's loss "
          f"({runs['none'][2]:.6f}): the loss, every gradient and running statistic with remat full "
          f"and dots bit-equal (torch.equal) to the step without remat on the card")


def large_train_parity(rng: np.random.Generator, enc=None, configs=(False, True),
                       tag: str = "large-parity") -> None:
    """Phase 15e: one bf16 train step at full width (depth cut to
    ``LARGE_PARITY_BLOCKS`` blocks for the CPU) at B = 2 on the card and on
    the CPU from the same weights and batch (dropout 0): losses, and each
    gradient within twice the CPU's own bf16-vs-fp32 gap (+ 1 %) of its
    largest fp32 value; both configurations (``configs``: fused or not),
    with ``enc`` over the encoder block (phase 19b: the pipeline's keys)."""
    for fused in configs:
        name = "fused" if fused else "shipped"
        cfg = {"model": copy.deepcopy(large_config()["model"])}
        cfg["model"]["encoder"].update(num_layers=LARGE_PARITY_BLOCKS, dropout=0.0,
                                       **(FUSED if fused else {}), **(enc or {}))
        cfg["model"]["ctc_dropout"] = 0.0
        cpu_model = build_model(cfg, input_dim=large_key("input_dim"), vocab_size=48)
        init_flax_style(cpu_model, torch.Generator().manual_seed(SEED))
        cfg32 = copy.deepcopy(cfg)
        cfg32["model"]["encoder"]["compute_dtype"] = "float32"
        ref_model = build_model(cfg32, input_dim=large_key("input_dim"), vocab_size=48)
        ref_model.load_state_dict(cpu_model.state_dict())
        gpu_model = copy.deepcopy(cpu_model).cuda()
        batch = large_batch(rng, LARGE_PARITY_B)
        m = int(cfg["model"]["encoder"].get("pipeline_microbatches", 0))
        if m:  # each data rank's rows a multiple of the microbatches, as the trainer pads
            from ssd_tpu_torch.parallel.mesh import RowSplit

            batch = RowSplit(microbatches=m).take(batch, LARGE_PARITY_B)
        featurize = feat.FeaturizerConfig.from_config(large_config())
        out = {}
        for label, model, dev in (("card", gpu_model, torch.device("cuda")),
                                  ("cpu", cpu_model, torch.device("cpu")),
                                  ("cpu fp32", ref_model, torch.device("cpu"))):
            total, losses = trainer._losses(model, trainer.to_device(batch, dev), LAMBDAS, BLANK,
                                            False, True, None, None, featurize)
            total.backward()
            out[label] = {k: float(v.detach()) for k, v in losses.items()}
        for k in ("total", "ctc", "distill"):
            check(abs(out["card"][k] - out["cpu"][k]) <= BF16_LOSS_RTOL * abs(out["cpu"][k]),
                  f"large {name} {k} loss card {out['card'][k]} vs CPU {out['cpu'][k]}")
        worst = (0.0, 0.0, "")
        gpu, ref = dict(gpu_model.named_parameters()), dict(ref_model.named_parameters())
        for pname, p in cpu_model.named_parameters():
            if pname.endswith((".attn.mha.key.bias", ".conv.dw.bias")):  # true gradient 0: noise
                continue
            g32 = ref[pname].grad
            scale = float(g32.abs().max())
            cpu_gap = float((p.grad - g32).abs().max()) / scale
            gap = float((gpu[pname].grad.cpu() - p.grad).abs().max()) / scale
            check(gap <= BF16_GRAD_NOISE_FACTOR * cpu_gap + BF16_GRAD_FLOOR,
                  f"large {name} grad {pname}: card vs CPU {gap:.3e} of the largest, the CPU's "
                  f"bf16-vs-fp32 gap {cpu_gap:.3e}")
            worst = max(worst, (gap, cpu_gap, pname))
        print(f"[{tag}] {name}{' ' + str(enc) if enc else ''}: one bf16 step at full width, "
              f"{LARGE_PARITY_BLOCKS} blocks, "
              f"B={LARGE_PARITY_B}, raw EMG: losses card {out['card']} vs CPU {out['cpu']} (rtol "
              f"{BF16_LOSS_RTOL}; CPU fp32 {out['cpu fp32']}); worst gradient gap card vs CPU "
              f"{worst[0]:.3e} of the largest ({worst[2]}; the CPU's bf16-vs-fp32 gap there "
              f"{worst[1]:.3e}; gate {BF16_GRAD_NOISE_FACTOR} x it + {BF16_GRAD_FLOOR})")


def phase_large(root: Path, rng: np.random.Generator, card: str) -> dict:
    """Phase 15: ``configs/tpu_scaled_large.yaml`` in bf16 on the card, at
    full width and ``LARGE_BLOCKS`` deep, served and trained in both
    configurations.
    Returns the bf16 kernels' entries with the launches of its counted runs."""
    steps = {}
    cfg, enc = large_config(), large_config()["model"]["encoder"]
    print(f"[large] {LARGE_PATH.name} read by load_config: d_model {enc['d_model']}, "
          f"{enc['num_layers']} blocks, {enc['num_heads']} heads of hd "
          f"{enc['d_model'] // enc['num_heads']}, ffn {enc['ffn_dim']}, K "
          f"{enc['depthwise_conv_kernel_size']}, compute_dtype {enc['compute_dtype']}, remat "
          f"{enc['remat']}, scan_layers {enc['scan_layers']}; data train_from_raw "
          f"{cfg['data']['train_from_raw']}, teacher_dtype {cfg['data']['teacher_dtype']}; batch "
          f"{cfg['optim']['batch_size']}")
    print(f"[large] cuts: parallel: → {cfg['parallel']} (one device: model 1, fsdp and sequence "
          f"off — ROADMAP Q1.10); random weights from seed {SEED}; a synthetic raw-EMG corpus "
          f"({LARGE_TRAIN} train + {LARGE_VAL} val utterances of {LARGE_SAMPLES[0]}–"
          f"{LARGE_SAMPLES[1] - 1} samples); depth {LARGE_BLOCKS} of its 12 blocks (phase 21 "
          f"serves all 12)")
    entries = large_kernels(rng, card, steps)
    t0 = time.perf_counter()
    model = large_serving_model()
    print(f"[large] {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters "
          f"(built and initialised on the CPU in {time.perf_counter() - t0:.2f} s)")
    launches = dict.fromkeys(COUNTERS, 0)
    for fused in (False, True):
        served = large_serving(root, model, rng, card, steps, fused)
        for k in launches:
            launches[k] += served[k]
    del model
    cfg_path = large_corpus(root / "corpus", rng)
    for fused in (False, True):
        trained = large_train(root / "corpus", cfg_path, card, steps, fused)
        for k in launches:
            launches[k] += trained[k]
    for fused in (False, True):
        large_rate(rng, card, steps, fused)
    t0 = time.perf_counter()
    large_train_parity(rng)
    steps["parity"] = time.perf_counter() - t0
    print("[large] phase 15 seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    print(f"[large] launches of the counted runs: { {k: v for k, v in launches.items() if v} }")
    for name, e in entries.items():
        e["launches"] = launches[name]
        check(e["launches"] > 0, f"{name} was never launched on the main path")
    return entries


# ------------------------------------------ quantized serving (phase 16)

H100_INT8_OPS = 1979e12  # dense int8 tensor cores, SXM, 700 W
QUANT_MODES = ("int8", "int8_prequant")
# quantized log-probs, card vs the CPU engine: the card's inputs differ
# from the CPU's by fp32 rounding (the log-mel kernel, the float layers'
# summation order), that noise flips roundings at .5 boundaries, and each
# flip moves an activation a whole int8 step, which the following blocks
# spread to every frame. So the card and the CPU carry two draws of the
# quantization's noise: their mean gap is held to √2 × the mean gap between
# int8 and float on the CPU (what two independent draws of that noise would
# give); the share of values over 1e-3 is printed
QUANT_NOISE = 2 ** 0.5
QUANT_TOL = 1e-3
PREQUANT_TOL = dict(rtol=1e-5, atol=1e-6)  # int8_prequant vs int8 (tests/test_quant.py's bound)
QUANT_RUNS = 3  # alternating transcribes a configuration and batch: the p50 is their median
TWO_WINDOW_SAMPLES = 8000  # 769 frames: two windows with S = 512
T_SERVE = 625  # T' of the 12 800-sample bucket after both models' ×2 subsampler


def eligible_shapes() -> dict:
    """(K, N) of each Dense product the int8 path covers, for both models."""
    out = {}
    for name, enc in (("tpu_fast_plus", shipped_config()["model"]["encoder"]),
                      ("tpu_scaled_large", large_config()["model"]["encoder"])):
        d, f = enc["d_model"], enc["ffn_dim"]
        out[name] = {"w1": (d, f), "w2": (f, d), "pw1": (d, 2 * d), "pw2": (d, d)}
    return out


def int_mm_check(rng: np.random.Generator, card: str) -> None:
    """``torch._int_mm`` (through ``ops/quant.py``'s wrapper) equal to its
    exact float64 twin at every eligible shape of both models at B = 1 and 8
    (M = B × 625 token rows), and at 5 rows (the wrapper pads to 17); its
    time beside ``torch.matmul`` at fp32 (TF32 off) and bf16."""
    for model, shapes in eligible_shapes().items():
        for name, (K, N) in shapes.items():
            for B in (1, 8):
                M = B * T_SERVE
                a = torch.from_numpy(rng.integers(-127, 128, size=(M, K), dtype=np.int8)).cuda()
                b = torch.from_numpy(rng.integers(-127, 128, size=(N, K), dtype=np.int8)).cuda()
                got = quant.int8_matmul(a, b)
                check(torch.equal(got, quant.int8_matmul_plain(a, b)),
                      f"_int_mm {model} {name} B={B}: differs from the exact product")
                af, bf = a.float(), b.float().t().contiguous()
                ms = cuda_ms(lambda: quant.int8_matmul(a, b))
                ms32 = cuda_ms(lambda: torch.matmul(af, bf))
                ms16 = cuda_ms(functools.partial(torch.matmul, af.bfloat16(), bf.bfloat16()))
                bound_ms, _ = bound(2 * M * K * N, M * K + N * K + 4 * M * N, H100_INT8_OPS)
                print(f"[quant] _int_mm {model} {name} (M {M}, K {K}, N {N}; B={B}): equal to the "
                      f"exact product; {ms:.4f} ms (bound {bound_ms:.4f} ms at 1 979 TOP/s int8) vs "
                      f"torch.matmul fp32 {ms32:.4f} ms, bf16 {ms16:.4f} ms (CUDA events)")
    a = torch.from_numpy(rng.integers(-127, 128, size=(5, 288), dtype=np.int8)).cuda()
    b = torch.from_numpy(rng.integers(-127, 128, size=(1152, 288), dtype=np.int8)).cuda()
    check(torch.equal(quant.int8_matmul(a, b), quant.int8_matmul_plain(a, b)),
          "_int_mm at 5 rows (padded to 17) differs from the exact product")
    print(f"[quant] _int_mm at 5 rows (padded to 17 inside the wrapper): equal; {card}")


@contextlib.contextmanager
def plain_int8():
    """Route the int8 products through their exact float64 twin on the card
    (the reference run); the main path never does this."""
    mm = quant.int8_matmul
    quant.int8_matmul = quant.int8_matmul_plain
    try:
        yield
    finally:
        quant.int8_matmul = mm


def valid_abs(a: torch.Tensor, b: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """|a − b| on the valid frames of (B, T', V) log-probs, flattened."""
    valid = torch.arange(a.shape[1])[None, :] < lengths[:, None]
    return (a - b).abs()[valid]


def quant_parity(ckpt: Path, float_ckpt: Path, engines: dict, batches: dict, mode: str) -> dict:
    """The quantized forward on the card: each eligible Dense layer of block 0
    equal bit for bit to the CPU's on the same input; the whole forward
    bit-equal to the same forward with the exact plain product in place of
    ``_int_mm``; against the CPU engine, whose inputs differ from the card's
    by fp32 rounding, the mean gap within ``QUANT_NOISE`` × the
    quantization's own (CPU int8 vs CPU float). Returns the card's log-probs
    a batch size."""
    cpu = InferenceEngine.from_checkpoint(ckpt, device="cpu")
    cpu_float = InferenceEngine.from_checkpoint(float_ckpt, device="cpu")
    card_block = engines["greedy"].model.encoder.blocks[0]
    cpu_block = cpu.model.encoder.blocks[0]
    gen = torch.Generator().manual_seed(SEED)
    for path in ("ffn1.w1", "ffn1.w2", "conv.pw1", "conv.pw2"):
        card_dense, cpu_dense = card_block.get_submodule(path), cpu_block.get_submodule(path)
        x = torch.randn((2, T_SERVE, cpu_dense.weight.shape[1]), generator=gen)
        with torch.inference_mode():
            got, want = card_dense(x.cuda()).cpu(), cpu_dense(x)
        check(torch.equal(got, want), f"{mode}: block 0's {path} on the card differs from the "
              f"CPU's on the same input (max abs {float((got - want).abs().max())})")
    out = {}
    for B, reqs in batches.items():
        lp, ol = engines["greedy"].forward(reqs)
        with plain_int8():
            lp_plain, _ = engines["greedy"].forward(reqs)
        check(torch.equal(lp, lp_plain), f"{mode} B={B}: the card's forward with _int_mm differs "
              f"from the same forward with the exact product (max abs "
              f"{float((lp - lp_plain).abs().max())})")
        lp_cpu, ol_cpu = cpu.forward(reqs)
        lp_float, _ = cpu_float.forward(reqs)
        check(torch.equal(ol.cpu(), ol_cpu), f"{mode} B={B}: out lengths differ card vs CPU")
        check(bool(torch.isfinite(lp).all()), f"{mode} B={B}: non-finite log-probs")
        lp_host = lp.cpu()
        err, q_gap = valid_abs(lp_host, lp_cpu, ol_cpu), valid_abs(lp_cpu, lp_float, ol_cpu)
        check(float(err.mean()) <= QUANT_NOISE * float(q_gap.mean()), f"{mode} B={B}: card vs "
              f"CPU log-probs mean abs err {float(err.mean())} > {QUANT_NOISE:.3f} × the "
              f"quantization's own {float(q_gap.mean())}")
        valid = torch.arange(lp.shape[1])[None, :] < ol_cpu[:, None]
        same = (lp_host.argmax(-1) == lp_cpu.argmax(-1))[valid].float().mean()
        same_q = (lp_float.argmax(-1) == lp_cpu.argmax(-1))[valid].float().mean()
        print(f"[quant] {mode} B={B}: block 0's four int8 Dense layers bit-equal card vs CPU on one "
              f"input; the forward bit-equal with _int_mm and with the exact product; card vs CPU "
              f"engine log-probs mean abs err {float(err.mean()):.3e} (max {float(err.max()):.3e}; "
              f"{float((err > QUANT_TOL).float().mean()):.4f} of the values over {QUANT_TOL}) "
              f"against the quantization's own gap, CPU int8 vs float, mean "
              f"{float(q_gap.mean()):.3e} (max {float(q_gap.max()):.3e}; ratio of the means "
              f"{float(err.mean()) / float(q_gap.mean()):.3f}, gate {QUANT_NOISE:.3f}); greedy "
              f"tokens equal card "
              f"vs CPU on {float(same):.4f} of the valid frames, int8 vs float on the CPU on "
              f"{float(same_q):.4f}")
        out[B] = lp
    return out


def quant_latency(ckpts: dict, rng: np.random.Generator, card: str) -> None:
    """Greedy p50 an utterance at B = 1 and 8, float, int8 and int8_prequant
    engines on one checkpoint's weights, in alternating runs."""
    engines = {name: InferenceEngine.from_checkpoint(ck, device="cuda") for name, ck in ckpts.items()}
    for B in (1, 8):
        reqs = [rng.normal(size=(12000, CHANNELS)).astype(np.float32) for _ in range(B)]
        runs = {name: [] for name in engines}
        for eng in engines.values():
            eng.transcribe(reqs)  # warm
        for _ in range(QUANT_RUNS):
            for name, eng in engines.items():
                t0 = time.perf_counter()
                eng.transcribe(reqs)
                runs[name].append((time.perf_counter() - t0) / B * 1e3)
        print(f"[quant] greedy B={B} 12 000 samples p50 an utterance: " + ", ".join(
            f"{name} {np.percentile(v, 50):.3f} ms" for name, v in runs.items())
            + f" ({QUANT_RUNS} alternating runs, host clock, transcribe end to end); {card}")


def quant_export_stream(ckpt: Path, engine: InferenceEngine, out: Path, rng: np.random.Generator,
                        launches: Launches) -> None:
    """An exported ``int8_prequant`` call (its graph holds ``aten._int_mm``
    and int8 buffers) with the engine's tokens, and a two-window stream."""
    L = encoder_key("num_layers")
    export_checkpoint(ckpt, out, batch_sizes=(8,), sample_lengths=(BUCKET,),
                      quantize="int8_prequant", device="cuda")
    manifest = json.loads((out / "manifest.json").read_text())
    check(manifest["quantize"] == "int8_prequant", f"manifest quantize {manifest['quantize']}")
    exported = torch.export.load(out / manifest["buckets"][0]["file"])
    nodes = [str(n.target) for n in exported.graph.nodes]
    n_int_mm = nodes.count("aten._int_mm.default")
    int8_bufs = sum(t.dtype == torch.int8 for t in exported.state_dict.values())
    check(n_int_mm == 6 * L and int8_bufs == 6 * L,
          f"exported graph: {n_int_mm} aten._int_mm nodes, {int8_bufs} int8 buffers")
    artifact = ExportedTranscriber.load(out, device="cuda")
    reqs = requests(rng, 8)
    before = counts()
    tokens, n_tok = artifact.call(reqs)
    moved = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    lp, ol = engine.forward(reqs)
    vocab = engine.vocab
    want_tokens, want_n = greedy_decode(lp, ol, blank_id=vocab.blank_id, pad_id=vocab.pad_id)
    check(np.array_equal(n_tok, want_n.cpu().numpy()) and np.array_equal(tokens, want_tokens.cpu().numpy()),
          "the exported int8_prequant call's tokens differ from the engine's greedy decode")
    print(f"[quant] exported int8_prequant (B 8, {BUCKET} samples) in "
          f"{manifest['buckets'][0]['export_seconds']:.2f} s: {n_int_mm} aten._int_mm nodes, "
          f"{int8_bufs} int8 weight buffers; its tokens equal the engine's greedy decode; launches "
          f"of the call {moved}")
    emg = rng.normal(size=(TWO_WINDOW_SAMPLES, CHANNELS)).astype(np.float32)
    before = counts()
    st, text, slp, _ = run_stream(engine, emg, chunk_frames=ONE_WINDOW_CHUNK)
    check(st.windows == 2, f"the int8_prequant stream ran {st.windows} windows")
    launches.add("the int8_prequant two-window stream", before, st.windows)
    check(np.isfinite(slp).all() and slp.shape[0] > 0, "the stream's log-probs")
    print(f"[quant] int8_prequant two-window stream ({TWO_WINDOW_SAMPLES} samples, S "
          f"{ONE_WINDOW_CHUNK}): {st.windows} windows, {slp.shape[0]} frames emitted, text "
          f"{text[:30]!r}")


def phase_quant(root: Path, rng: np.random.Generator, card: str) -> dict:
    """Phase 16: int8 quantized serving. Returns the launches of its counted
    runs."""
    steps = {}
    t0 = time.perf_counter()
    int_mm_check(rng, card)
    steps["_int_mm"] = time.perf_counter() - t0
    L = encoder_key("num_layers")
    totals = dict.fromkeys(COUNTERS, 0)
    for fused in (False, True):
        name = "fused" if fused else "shipped"
        enc = FUSED if fused else {}
        float_ckpt = build_run_dir(root / f"{name}_float", **enc)
        for mode in QUANT_MODES:
            t0 = time.perf_counter()
            ckpt = build_run_dir(root / f"{name}_{mode}", quantize=mode, **enc)
            per_call = {"logmel": 1, "int_mm": 6 * L}
            if fused:
                per_call.update(attention_fwd=L, depthwise_fwd=L)
            engines, batches, launches = phase_main_path(ckpt, rng, sizes=(1, 8), per_call=per_call)
            for k in totals:
                totals[k] += launches[k]
            lps = quant_parity(ckpt, float_ckpt, engines, batches, f"{name} {mode}")
            if mode == "int8_prequant":
                w1 = engines["greedy"].model.encoder.blocks[0].ffn1.w1
                check(isinstance(w1, quant.QuantDense) and w1.weight.dtype == torch.int8,
                      f"{name}: the int8_prequant engine holds {type(w1).__name__}")
                dynamic = InferenceEngine.from_checkpoint(root / f"{name}_int8" / "last",
                                                          device="cuda")
                for B, reqs in batches.items():
                    lp_int8 = dynamic.forward(reqs)[0]
                    err = float((lps[B] - lp_int8).abs().max())
                    check(close(lps[B], lp_int8, **PREQUANT_TOL),
                          f"{name} B={B}: int8_prequant vs int8 on the card max abs err {err}")
                    print(f"[quant] {name} B={B}: int8_prequant vs int8 on the card max abs err "
                          f"{err:.3e} (tol {PREQUANT_TOL})")
                if not fused:
                    counted = Launches({"logmel": 1, "int_mm": 6 * L})
                    quant_export_stream(ckpt, engines["greedy"], root / "export", rng, counted)
                    for k in totals:
                        totals[k] += counted.total[k]
                    quant_latency({"float": float_ckpt, "int8": root / "shipped_int8" / "last",
                                   "int8_prequant": ckpt}, rng, card)
            del engines
            steps[f"{name} {mode}"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = large_serving_model()
    ckpt = large_run_dir(root / "large", model, quantize="int8_prequant")
    fckpt = large_run_dir(root / "large_float", model)
    del model
    engine = InferenceEngine.from_checkpoint(ckpt, device="cuda")
    fengine = InferenceEngine.from_checkpoint(fckpt, device="cuda")
    reqs = [rng.normal(size=(12000, CHANNELS)).astype(np.float32) for _ in range(8)]
    LL = large_key("num_layers")
    before = counts()
    hyps = engine.transcribe(reqs)
    moved = {k: v - before[k] for k, v in counts().items()}
    want = dict.fromkeys(COUNTERS, 0)
    want.update(logmel=1, int_mm=6 * LL)
    check(moved == want, f"tpu_scaled_large int8_prequant B=8 launched {moved}, expected {want}")
    for k in totals:
        totals[k] += moved[k]
    lp, ol = engine.forward(reqs)
    flp, fol = fengine.forward(reqs)
    check(torch.equal(ol, fol) and bool(torch.isfinite(lp).all()), "large int8_prequant log-probs")
    valid = (torch.arange(lp.shape[1], device=lp.device)[None, :] < ol[:, None])[..., None]
    gap = float(((lp - flp) * valid).abs().max())
    same = ((lp.argmax(-1) == flp.argmax(-1)) & valid[..., 0]).sum() / valid.sum()
    runs = {"bf16": [], "bf16 + int8_prequant": []}
    for _ in range(QUANT_RUNS):
        for name, eng in (("bf16", fengine), ("bf16 + int8_prequant", engine)):
            t1 = time.perf_counter()
            eng.transcribe(reqs)
            runs[name].append((time.perf_counter() - t1) / 8 * 1e3)
    print(f"[quant] tpu_scaled_large bf16 int8_prequant at full width, {LARGE_BLOCKS} blocks, B=8: "
          f"{len(hyps)} hypotheses, launches a transcribe {({k: v for k, v in moved.items() if v})}; "
          f"log-probs vs the bf16 float engine max abs {gap:.3e}, greedy tokens equal on "
          f"{float(same):.4f} of the valid frames; greedy p50 an utterance " + ", ".join(
              f"{k} {np.percentile(v, 50):.3f} ms" for k, v in runs.items())
          + f" ({QUANT_RUNS} alternating runs, host clock); {card}")
    del engine, fengine
    steps["tpu_scaled_large"] = time.perf_counter() - t0
    print("[quant] phase 16 seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    return totals


# ----------------------------------------------- data preparation (phase 17)

PREP_VOICED, PREP_SILENT = 24, 8
PREP_SECONDS = (2.0, 6.0)
AUDIO_SR, RESAMPLED_SR = 16000, 22050
PREP_BATCH = 8
TEACHER_TOL = dict(atol=2e-4, rtol=2e-3)  # tests/test_wavlm.py's bound
FLAC_BLOCK = 4096


def flac_bytes(pcm: np.ndarray, sample_rate: int) -> bytes:
    """Mono 16-bit PCM as a FLAC stream of verbatim subframes (byte-aligned:
    an 8-bit subframe header, then big-endian samples), 4 096 samples a
    frame; the CRCs are left zero (the port's decoder does not check them)."""
    n = len(pcm)
    info = bytearray(34)
    info[0:2] = info[2:4] = FLAC_BLOCK.to_bytes(2, "big")
    info[10:18] = ((sample_rate << 44) | (15 << 36) | n).to_bytes(8, "big")  # 1 channel, 16 bits
    out = [b"fLaC", bytes([0x80, 0, 0, 34]), bytes(info)]
    for f, start in enumerate(range(0, n, FLAC_BLOCK)):
        chunk = pcm[start: start + FLAC_BLOCK]
        out.append(bytes([0xFF, 0xF8, 0x70, 0x08, f]) + (len(chunk) - 1).to_bytes(2, "big") + b"\0")
        out.append(b"\x02" + chunk.astype(">i2").tobytes() + b"\0\0")
    return b"".join(out)


def gaddy_tree(root: Path, rng: np.random.Generator) -> tuple:
    """A synthetic corpus in the Gaddy & Klein layout: voiced utterances with
    8-channel 1 kHz EMG and FLAC audio (at 16 kHz, one in four at 22.05 kHz),
    silent ones with EMG only. Returns (root, {utterance stem: seconds})."""
    chars = list("abcdefghijklmnopqrstuvwxyz") + [" "] * 6
    seconds = {}
    for split, count in (("voiced_parallel_data", PREP_VOICED), ("silent_parallel_data", PREP_SILENT)):
        for i in range(count):
            d = root / split / f"5-{i % 3}"
            d.mkdir(parents=True, exist_ok=True)
            sec = float(rng.uniform(*PREP_SECONDS))
            stem = f"{i}"
            seconds[f"{split}/{d.name}/{stem}"] = sec
            np.save(d / f"{stem}_emg.npy",
                    (rng.normal(size=(int(sec * 1000), CHANNELS)) * 30).astype(np.float32))
            text = "".join(rng.choice(chars, size=int(rng.integers(20, 60)))).strip() or "a"
            (d / f"{stem}_info.json").write_text(json.dumps(
                {"text": text, "sentence_index": i, "book": "synthetic"}))
            if split == "voiced_parallel_data":
                sr = RESAMPLED_SR if i % 4 == 3 else AUDIO_SR
                t = np.arange(int(sec * sr)) / sr
                wave_ = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) + \
                    0.05 * rng.normal(size=t.shape)
                pcm = np.clip(wave_ * 32767, -32768, 32767).astype(np.int16)
                (d / f"{stem}_audio_clean.flac").write_bytes(flac_bytes(pcm, sr))
    return root, seconds


def random_wavlm(path: Path) -> None:
    """A full-width WavLM Base+ (94 M parameters) with seeded random weights,
    written with the port's safetensors writer in the HF layout (weight-normed
    positional conv, ``wavlm.`` prefix)."""
    torch.manual_seed(SEED)
    model = wavlm.WavLMModel(wavlm.WavLMConfig())
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gru_rel_pos_const"):
                continue
            if p.dim() > 1:
                p.normal_(0.0, 0.02 if "rel_attn_embed" not in name else 1.0)
    state = {f"wavlm.{k}": v.numpy() for k, v in model.state_dict().items()}
    w = state.pop("wavlm.encoder.pos_conv_embed.conv.weight")
    norm = np.sqrt((w ** 2).sum(axis=(0, 1), keepdims=True))
    state["wavlm.encoder.pos_conv_embed.conv.weight_g"] = norm
    state["wavlm.encoder.pos_conv_embed.conv.weight_v"] = w
    wavlm.save_safetensors(state, path)
    n = sum(p.numel() for p in model.parameters())
    print(f"[prep] random WavLM Base+ ({n / 1e6:.2f} M parameters) written to {path.name} "
          f"({path.stat().st_size / 2**20:.1f} MiB)")


def caches(out: Path) -> dict:
    return {str(p.relative_to(out)): np.load(p) for p in sorted(out.rglob("*.npy"))}


def phase_prepare(root: Path, rng: np.random.Generator, card: str) -> dict:
    """Phase 17: raw corpus → index → EMG and teacher caches → train →
    evaluate, through the port's CLIs on the card. Returns the launches."""
    steps = {}
    totals = dict.fromkeys(COUNTERS, 0)
    t0 = time.perf_counter()
    data, seconds = gaddy_tree(root / "emg_data", rng)
    weights = root / "wavlm-base-plus.safetensors"
    random_wavlm(weights)
    steps["corpus"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    index = root / "index.jsonl"
    index_dataset.main(["--root", str(data), "--out", str(index), "--stats", "--durations"])
    rows = index_dataset.load_index(index)
    voiced = [r for r in rows if r["split"] == "voiced_parallel_data"]
    check(len(rows) == PREP_VOICED + PREP_SILENT and all(r["has_audio"] for r in voiced),
          f"the index holds {len(rows)} rows, {sum(r['has_audio'] for r in rows)} with audio")
    subsets = {s: sum(r["subset"] == s for r in voiced) for s in ("train", "val", "test")}
    print(f"[prep] index: {len(rows)} rows ({len(voiced)} voiced), voiced subsets {subsets}")
    steps["index"] = time.perf_counter() - t0

    emg_argv = ["--mode", "emg", "--index", str(index), "--root", str(data), "--emg-n-fft", "320",
                "--emg-hop-length", "10", "--batch-size", str(PREP_BATCH)]
    outs = {}
    for name, extra in (("card", ["--device", "cuda"]),
                        ("card_single", ["--device", "cuda", "--no-double-buffer"]),
                        ("cpu", ["--device", "cpu"])):
        outs[name] = root / "features" / "emg" if name == "card" else root / f"emg_{name}"
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preprocessing.main(emg_argv + ["--out", str(outs[name])] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        batches = -(-len(rows) // PREP_BATCH)
        want = dict.fromkeys(COUNTERS, 0)
        if name != "cpu":
            want["logmel"] = batches
        check(c == want, f"preprocessing --mode emg ({name}) launched {c}, expected {want}")
        if name == "card":
            for k in totals:
                totals[k] += c[k]
        print(f"[prep] --mode emg ({name}): {len(rows)} utterances in {wall:.2f} s, "
              f"{len(rows) / wall:.2f} utterances/s (the CLI call, host clock); launches "
              f"{({k: v for k, v in c.items() if v})}; {card}")
        steps[f"emg {name}"] = wall
    card_c, single_c, cpu_c = (caches(outs[k]) for k in ("card", "card_single", "cpu"))
    check(card_c.keys() == cpu_c.keys() == single_c.keys() and len(card_c) == len(rows),
          f"EMG caches: {len(card_c)} card, {len(cpu_c)} CPU")
    err = max(float(np.abs(card_c[k] - cpu_c[k]).max()) for k in card_c)
    for k in card_c:
        check(np.allclose(card_c[k], cpu_c[k], **FEAT_TOL), f"EMG cache {k}: card vs CPU")
        check(np.array_equal(card_c[k], single_c[k]), f"EMG cache {k}: double vs single buffered")
    print(f"[prep] EMG caches: card vs CPU max abs err {err:.3e} (tol {FEAT_TOL}); double-buffered "
          f"equal bit for bit to single-buffered")

    t0 = time.perf_counter()
    teacher_out = root / "features" / "teacher"
    teacher_argv = ["--mode", "teacher", "--index", str(index), "--root", str(data), "--out",
                    str(teacher_out), "--teacher-model", str(weights), "--batch-size",
                    str(PREP_BATCH), "--device", "cuda"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preprocessing.main(teacher_argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tcache = caches(teacher_out)
    check(len(tcache) == len(voiced), f"{len(tcache)} teacher caches for {len(voiced)} voiced rows")
    print(f"[prep] --mode teacher (random full-width WavLM Base+, layer 9): {len(voiced)} "
          f"utterances in {wall:.2f} s, {len(voiced) / wall:.2f} utterances/s (the CLI call, host "
          f"clock, the {weights.stat().st_size / 2**20:.0f} MiB weights' load included); {card}")
    steps["teacher card"] = wall

    t0 = time.perf_counter()
    shortest = sorted(voiced, key=lambda r: seconds[r["utterance_id"]])[:2]
    resampled = next(r for r in sorted(voiced, key=lambda r: seconds[r["utterance_id"]])
                     if int(r["stem"]) % 4 == 3)
    cpu_t = wavlm.WavLMTeacher.from_pretrained(str(weights), layer=9, device="cpu")
    card_t = wavlm.WavLMTeacher.from_pretrained(str(weights), layer=9, device="cuda")
    errs = []
    for r in shortest + [resampled]:
        audio = load_audio(data / r["audio_path"], 16000)
        cached = tcache[f"{r['utterance_id']}.npy"]
        single = card_t.extract(audio)
        for what, want in (("the CPU teacher", cpu_t.extract(audio) if r in shortest else None),
                           ("the card's per-utterance run", single)):
            if want is None:
                continue
            check(cached.shape == want.shape and np.allclose(cached, want, **TEACHER_TOL),
                  f"teacher cache {r['utterance_id']} vs {what}: max abs err "
                  f"{float(np.abs(cached - want).max()) if cached.shape == want.shape else 'shape'}")
            errs.append(float(np.abs(cached - want).max()))
    print(f"[prep] teacher caches (batched on the card) vs the CPU teacher on the two shortest "
          f"utterances and vs per-utterance card runs (one resampled from 22.05 kHz): max abs err "
          f"{max(errs):.3e} (tol {TEACHER_TOL}); features {next(iter(tcache.values())).shape[1]}-d")
    del cpu_t, card_t
    steps["teacher checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    vocab_path = root / "vocab.json"
    default_vocab().to_json(vocab_path)
    cfg = copy.deepcopy(shipped_config())
    cfg["data"].update(index=str(index), features_root=str(root / "features"), vocab=str(vocab_path),
                       val_subsets=["val", "test"])
    cfg["model"]["encoder"].update(FUSED)
    cfg["optim"]["max_epochs"] = 1
    L = encoder_key("num_layers")
    reset_counts()
    summary = trainer.train_from_config(cfg, root / "run", overfit_batches=2, device="cuda")
    c = counts()
    n_train, n_eval = check_epoch(summary["history"][0], "prepared")
    want = dict.fromkeys(COUNTERS, 0)
    want.update(ctc_alpha=n_train + n_eval, ctc_beta=n_train,
                attention_fwd=L * (n_train + n_eval), depthwise_fwd=L * (n_train + n_eval),
                attention_bwd=L * n_train, depthwise_bwd=L * n_train)
    check(n_train == 2 and c == want, f"training from the prepared caches launched {c} in "
          f"{n_train} steps, expected {want}")
    for k in totals:
        totals[k] += c[k]
    h = summary["history"][0]
    print(f"[prep] trained from the caches (fused/pallas): {n_train} train + {n_eval} eval steps, "
          f"train total {h['train']['total']:.4f} (distill {h['train']['distill']:.4f}), val total "
          f"{h['val']['total']:.4f}; launches {({k: v for k, v in c.items() if v})}")
    steps["train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = root / "eval"
    reset_counts()
    ev.main(["--checkpoint", str(root / "run" / "last"), "--device", "cuda", "--output", str(out),
             "--batch-size", "4"])
    c = counts()
    metrics = json.loads((out / "metrics.json").read_text())
    check(np.isfinite(metrics["wer"]) and np.isfinite(metrics["cer"]), f"eval metrics {metrics}")
    check(c["attention_fwd"] > 0 and c["attention_fwd"] == c["depthwise_fwd"],
          f"the eval CLI launched {c}")
    for k in totals:
        totals[k] += c[k]
    print(f"[prep] eval CLI on the trained checkpoint: {metrics['data']['num_samples']} utterances, "
          f"WER {metrics['wer']:.4f} CER {metrics['cer']:.4f}; launches "
          f"{({k: v for k, v in c.items() if v})}")
    steps["evaluate"] = time.perf_counter() - t0
    print("[prep] phase 17 seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    return totals



# ---------------------------------------------------------------- phase 18

MULTI_PATH = Path(__file__).resolve()


class StepRecorder:
    """Wraps ``trainer.make_train_step`` while a run trains: each train step
    bracketed by CUDA events (its span on the device stream, host waits
    included) and its losses kept, the second step profiled (its device
    busy time: ``device_events``), and the process group's backend seen
    from inside the step."""

    def __init__(self) -> None:
        self.events, self.losses, self.backend, self.busy_ms = [], [], None, None

    @contextlib.contextmanager
    def patch(self):
        orig = trainer.make_train_step

        def patched(*args, **kwargs):
            step = orig(*args, **kwargs)

            def recorded(state, batch, lambdas, generator):
                if len(self.losses) == 1:
                    from torch.profiler import ProfilerActivity, profile

                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        state, losses = step(state, batch, lambdas, generator)
                        torch.cuda.synchronize()
                    self.busy_ms = sum(
                        e.self_device_time_total for e in prof.key_averages()
                        if e.device_type.name == "CUDA"
                        and not getattr(e, "is_user_annotation", False)) / 1e3
                    self.losses.append(losses)
                    return state, losses
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                state, losses = step(state, batch, lambdas, generator)
                end.record()
                self.events.append((start, end))
                self.losses.append(losses)
                if torch.distributed.is_initialized():
                    self.backend = torch.distributed.get_backend()
                return state, losses

            return recorded

        trainer.make_train_step = patched
        try:
            yield self
        finally:
            trainer.make_train_step = orig

    def result(self) -> dict:
        torch.cuda.synchronize()
        return {"losses": [{k: float(v) for k, v in l.items()} for l in self.losses],
                "step_ms": [s.elapsed_time(e) for s, e in self.events], "backend": self.backend,
                "busy_ms": self.busy_ms}


def rank_train(spec_path: str) -> int:
    """One rank of phases 18a and 19c under ``torch.distributed.run``: the
    trainer CLI (``trainer.main``) with the launch counts and the steps
    recorded, once for each of the spec's ``runs``, in one process group:
    a launch costs the card's host ~30–40 s."""
    from ssd_tpu_torch.parallel.mesh import maybe_initialize_distributed

    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False  # as phase 1 sets them
    torch.backends.cudnn.allow_tf32 = False
    created = maybe_initialize_distributed()  # NCCL: the ranks train on the card
    try:
        for run in spec["runs"]:
            rec = StepRecorder()
            reset_counts()
            with rec.patch():
                trainer.main(run["argv"])
            out = dict(rec.result(), counts=counts(), rank=int(os.environ["RANK"]),
                       world=int(os.environ["WORLD_SIZE"]))
            Path(f"{run['out']}.rank{out['rank']}.json").write_text(json.dumps(out))
    finally:
        if created:
            torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun(nproc: int, *args: str, timeout: float = 600) -> float:
    """``python -m torch.distributed.run --nproc-per-node N chip_smoke.py
    ARGS``, waited for; its seconds."""
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()), str(MULTI_PATH), *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        print(proc.stdout[-6000:])
        print(proc.stderr[-6000:], file=sys.stderr)
        raise SmokeFailure(f"torchrun {args[:1]} exited {proc.returncode}")
    return time.perf_counter() - t0


def weights_gap(got: dict, want: dict) -> tuple:
    """(names not bit-equal, worst abs gap off the noise-only tensors and
    the running means, worst on the running means)."""
    bad = [n for n, w in want.items() if not torch.equal(got[n], w)]
    noise = (".attn.mha.key.bias", ".conv.dw.bias")
    gap = max([float((got[n] - want[n]).abs().max()) for n in bad
               if not n.endswith(noise + (".bn.mean",))] or [0.0])
    means = max([float((got[n] - want[n]).abs().max()) for n in bad if n.endswith(".bn.mean")]
                or [0.0])
    return bad, gap, means


# a torchrun rank vs one process that are not bit-equal: held to the port's
# CPU tests' tolerances after a few Adam steps (tests/test_torch_training.py:
# weights 5e-5, running means 5e-4 — they average the noise-driven steps of
# the depthwise bias) and to the card-vs-CPU loss tolerance
MULTI_WEIGHT_ATOL, MULTI_MEAN_ATOL = 5e-5, 5e-4


def multi_train(root: Path, card: str, nproc: int = 1) -> dict:
    """Phase 18a: the trainer CLI under ``torch.distributed.run
    --nproc-per-node N``, tpu_fast_plus fused/pallas from raw EMG, against
    one process's ``train_from_config`` from the same seed. N = 1 (NCCL, a
    1×1 mesh): ``parallel: {}`` and ``{fsdp: true}``, bit-equal expected.
    N ≥ 2 cards: tpu_scaled_large's block (``model: 2, sequence, fsdp``)
    and ``{fsdp: true}``, dropout and augmentation off (each rank draws
    masks of its own), held to the tolerances."""
    base = load_config(root / "config.json")
    base["model"]["encoder"].update(FUSED)
    base["data"]["train_from_raw"] = True
    base["optim"]["max_epochs"] = 1
    if nproc == 1:
        blocks = (("dp", {}), ("fsdp", {"fsdp": True}))
    else:
        base["model"]["encoder"]["dropout"] = base["model"]["ctc_dropout"] = 0.0
        base["augmentation"] = {}
        blocks = (("tp_sp_fsdp", {"model": 2, "sequence": True, "fsdp": True}),
                  ("fsdp", {"fsdp": True}))
    t0 = time.perf_counter()
    single = root / f"multi_single_{nproc}"
    rec = StepRecorder()
    with rec.patch():
        summary = trainer.train_from_config(copy.deepcopy(base), single, overfit_batches=3,
                                            device="cuda")
    want = rec.result()
    check_epoch(summary["history"][0], f"18a single for {nproc}")
    w_want = load_checkpoint(single / "last")
    single_s = time.perf_counter() - t0
    total = dict.fromkeys(COUNTERS, 0)
    runs, specs = [], []
    for label, par in blocks:
        label = f"{label}_{nproc}"
        cfg = copy.deepcopy(base)
        cfg["parallel"] = par
        cfg_path = root / f"multi_{label}.json"
        cfg_path.write_text(json.dumps(cfg))
        ranked, out = root / f"multi_{label}_torchrun", root / f"multi_{label}"
        runs.append((label, par, ranked, out))
        specs.append({"out": str(out), "argv": [
            "--config", str(cfg_path), "--run-dir", str(ranked), "--overfit-batches", "3"]})
    spec = root / f"multi_{nproc}_spec.json"
    spec.write_text(json.dumps({"runs": specs}))
    # both trainings in one launch (one process group a rank, one after the other)
    launch_s = torchrun(nproc, "--rank-train", str(spec))
    for label, par, ranked, out in runs:
        t0 = time.perf_counter()
        ranks = [json.loads(Path(f"{out}.rank{r}.json").read_text()) for r in range(nproc)]
        got = ranks[0]
        check(all(r["backend"] == "nccl" and r["world"] == nproc for r in ranks),
              f"18a {label}: the ranks trained over {[r['backend'] for r in ranks]} at world "
              f"{got['world']}")
        n = len(want["losses"])
        check(n == 3 and all(len(r["losses"]) == 3 for r in ranks),
              f"18a {label}: {len(got['losses'])} vs {n} steps")
        check(all(r["losses"] == got["losses"] for r in ranks),
              f"18a {label}: the ranks report different (global) losses")
        counts_all = {k: sum(r["counts"][k] for r in ranks) for k in COUNTERS}
        missing = [(r["rank"], k) for r in ranks
                   for k in ("logmel", "ctc_alpha", "ctc_beta", "attention_fwd",
                             "attention_bwd", "depthwise_fwd", "depthwise_bwd")
                   if r["counts"][k] == 0]
        check(not missing, f"18a {label}: the distributed trainer never launched {missing}")
        for k in total:
            total[k] += counts_all[k]
        w_got = load_checkpoint(ranked / "last")
        check(w_got["step"] == w_want["step"] and w_got["epoch"] == w_want["epoch"],
              f"18a {label}: checkpoint step {w_got['step']} vs {w_want['step']}")
        bad, gap, means = weights_gap(w_got["state_dict"], w_want["state_dict"])
        loss_equal = got["losses"] == want["losses"]
        if loss_equal and not bad:
            verdict = "losses and all trained weights bit-equal (torch.equal)"
        else:
            for a, b in zip(got["losses"], want["losses"]):
                for k in ("total", "ctc", "distill"):
                    check(abs(a[k] - b[k]) <= TRAIN_LOSS_RTOL * abs(b[k]),
                          f"18a {label}: {k} loss {a[k]} vs one process {b[k]}")
            check(gap <= MULTI_WEIGHT_ATOL and means <= MULTI_MEAN_ATOL,
                  f"18a {label}: weights off by {gap} (running means {means})")
            worst_loss = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got["losses"],
                             want["losses"]) for k in ("total", "ctc", "distill") if b[k])
            verdict = (f"NOT bit-equal: losses equal {loss_equal} (worst rel {worst_loss:.3e}, "
                       f"rtol {TRAIN_LOSS_RTOL}), {len(bad)} tensors differ, worst "
                       f"{gap:.3e} (running means {means:.3e}; atol {MULTI_WEIGHT_ATOL} / "
                       f"{MULTI_MEAN_ATOL})")
        print(f"[multi] 18a {label}: torchrun --nproc-per-node {nproc} over {got['backend']}, "
              f"parallel {par}, vs one process, {n} train steps of B=5 (3 overfit batches, "
              f"raw EMG, fused/pallas{', dropout 0' if nproc > 1 else ''}): {verdict}; "
              f"losses {[round(l['total'], 6) for l in got['losses']]}; step 2's device busy "
              f"time (profiler) by rank {[round(r['busy_ms'], 3) for r in ranks]} ms vs "
              f"{want['busy_ms']:.3f} ms one process (rank 0 x{got['busy_ms'] / want['busy_ms']:.3f}); "
              f"step 3's span on the device stream (CUDA events, host waits included) by rank "
              f"{[round(r['step_ms'][-1], 3) for r in ranks]} ms vs {want['step_ms'][-1]:.3f} ms; "
              f"launches, all ranks {counts_all}; torchrun call {launch_s:.2f} s for the "
              f"{len(runs)} trainings, checks {time.perf_counter() - t0:.2f} s (the one-process "
              f"run {single_s:.2f} s); card {card}")
    return total


MULTI_BLOCKS = 2  # phase 18b's depth: tpu_scaled_large's width, 2 blocks
MULTI_B = 2


def multi_large_cfg(dtype: str) -> dict:
    cfg = {"model": copy.deepcopy(load_config(LARGE_PATH)["model"]),
           "parallel": load_config(LARGE_PATH)["parallel"],
           "optim": copy.deepcopy(load_config(LARGE_PATH)["optim"])}
    cfg["model"]["encoder"].update(num_layers=MULTI_BLOCKS, dropout=0.0, compute_dtype=dtype,
                                   **FUSED)
    cfg["model"]["ctc_dropout"] = 0.0
    cfg["optim"]["grad_accum"] = 1
    return cfg


def multi_large_step(cfg: dict, dev: torch.device, ctx=None, steps: int = 1) -> dict:
    """``steps`` steps of the trainer's ``make_train_step`` on
    :func:`multi_large_cfg` from ``SEED``'s weights and a seeded raw batch,
    the model placed by ``shard_model`` when ``ctx`` is given (each data
    rank its block of rows); the losses and the first step's synced,
    unsharded gradients, taken as the optimizer steps."""
    from ssd_tpu_torch.parallel.mesh import RowSplit
    from ssd_tpu_torch.parallel.partition import gather_for, grad_norm_fn, shard_model

    model = build_model(cfg, input_dim=large_key("input_dim"), vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(SEED))
    model.to(dev)
    shard_model(model, ctx)
    names = [n for n, _ in model.named_parameters()]
    opt, _ = build_optimizer(cfg, [p for _, p in model.named_parameters()], 10,
                             grad_norm_fn(model))
    out = {"losses": [], "grads": None}
    step_opt = opt.step

    def capture_then_step():
        if out["grads"] is None:
            out["grads"] = {n: gather_for(model, n, p.grad)
                            for n, p in zip(names, model.parameters())}
        return step_opt()

    opt.step = capture_then_step
    batch = large_batch(np.random.default_rng(SEED), MULTI_B)
    if ctx is not None:
        batch = RowSplit(local_data=ctx.data, local_index=ctx.data_rank).take(batch, MULTI_B)
    batch = trainer.to_device(batch, dev)
    featurize = feat.FeaturizerConfig.from_config(large_config())
    train_step = trainer.make_train_step(BLANK, False, None, featurize, ctx)
    state = trainer.TrainState(model=model, optimizer=opt)
    for _ in range(steps):
        state, losses = train_step(state, batch, LAMBDAS, None)
        out["losses"].append({k: float(v) for k, v in losses.items()})
    return out


def rank_step(spec_path: str) -> int:
    """One rank of phase 18b: tpu_scaled_large's ``parallel:`` block (model
    2, sequence, fsdp) over the ranks, an fp32 step and two bf16 steps."""
    import torch.distributed as dist

    from ssd_tpu_torch.parallel.mesh import (
        ParallelContext, maybe_initialize_distributed, mesh_from_config, rank_device)

    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = spec.get("device", "cuda")
    maybe_initialize_distributed(device=device)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
        for dtype, steps in (("float32", 1), ("bfloat16", 2)):
            cfg = multi_large_cfg(dtype)
            par = cfg["parallel"]
            ctx = ParallelContext.from_mesh(mesh_from_config(cfg, device_type=dev.type),
                                            sequence=par["sequence"], fsdp=par["fsdp"])
            reset_counts()
            res = multi_large_step(cfg, dev, ctx, steps)
            if dtype != "float32":
                res.pop("grads")  # only the fp32 step is held to one card
            out[dtype] = dict(res, counts=counts(), mesh=[ctx.data, ctx.model])
        if dist.get_rank() == 0:
            torch.save(out, spec["out"])
    finally:
        dist.destroy_process_group()
    return 0


def multi_large(root: Path, card: str, nproc: int = 2) -> dict:
    """Phase 18b: over ``nproc`` cards when there are as many, else a skip
    line."""
    n = torch.cuda.device_count()
    if n < nproc:
        print(json.dumps({"phase": "18b", "skipped": f"{n} CUDA device visible"}))
        return dict.fromkeys(COUNTERS, 0)
    t0 = time.perf_counter()
    spec = root / "multi_large_spec.json"
    spec.write_text(json.dumps({"out": str(root / "multi_large.pt")}))
    torchrun(nproc, "--rank-step", str(spec))
    got = torch.load(root / "multi_large.pt", weights_only=False)
    check(got["backend"] == "nccl" and got["world"] == nproc,
          f"18b: {got['backend']} {got['world']}")
    want = multi_large_step(multi_large_cfg("float32"), torch.device("cuda"))
    g32 = got["float32"]
    for k in ("total", "ctc", "distill"):
        a, b = g32["losses"][0][k], want["losses"][0][k]
        check(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b), f"18b {k} loss 2 cards {a} vs one {b}")
    worst = (0.0, "")
    for name, w in want["grads"].items():
        err = float((g32["grads"][name] - w).abs().max())
        bound = max(TRAIN_GRAD_REL * float(w.abs().max()), TRAIN_GRAD_FLOOR)
        check(err <= bound, f"18b grad {name}: {nproc} cards vs one {err} > {bound}")
        if bound > TRAIN_GRAD_FLOOR:  # the tensors held to the relative limit
            worst = max(worst, (err / float(w.abs().max()), name))
    bf = got["bfloat16"]["losses"]
    check(all(np.isfinite(l[k]) for l in bf for k in l), f"18b bf16 losses {bf}")
    for dtype, names in (("float32", ("attention_fwd", "depthwise_fwd")),
                         ("bfloat16", ("attention_fwd_bf16", "depthwise_fwd_bf16"))):
        check(all(got[dtype]["counts"][k] > 0 for k in names),
              f"18b {dtype}: rank 0 launched {got[dtype]['counts']}")
    print(f"[multi] 18b tpu_scaled_large parallel {multi_large_cfg('float32')['parallel']} over "
          f"{nproc} cards (mesh {g32['mesh']}), {MULTI_BLOCKS} blocks, fused/pallas, B={MULTI_B}: fp32 "
          f"losses {g32['losses'][0]} vs one card {want['losses'][0]} (rtol {TRAIN_LOSS_RTOL}); "
          f"worst gradient {worst[0]:.3e} of its largest ({worst[1]}; limit {TRAIN_GRAD_REL}); "
          f"bf16 losses {bf}; rank 0 launches fp32 {got['float32']['counts']}, bf16 "
          f"{got['bfloat16']['counts']}; {time.perf_counter() - t0:.2f} s; card {card}")
    return {k: got["float32"]["counts"][k] + got["bfloat16"]["counts"][k] for k in COUNTERS}


def multi_serving(ckpt: Path, rng: np.random.Generator, card: str) -> dict:
    """Phase 18c: ``data_parallel`` serving. One card: the warning, and the
    reply of the same engine without it; more: rows split across the cards
    and the same text."""
    with captured_log("ssd_tpu_torch.parallel.replicas", logging.WARNING) as messages:
        reset_counts()
        dp = InferenceEngine.from_checkpoint(ckpt, device="cuda", data_parallel=True)
    plain = InferenceEngine.from_checkpoint(ckpt, device="cuda")
    reqs = requests(rng, 5)
    n = torch.cuda.device_count()
    lp_dp, ol_dp = dp.forward(reqs)
    c = counts()
    hyps_dp = dp.transcribe(reqs)
    lp, ol = plain.forward(reqs)
    hyps = plain.transcribe(reqs)
    check(hyps_dp == hyps, f"18c: data_parallel text {hyps_dp} vs {hyps}")
    check(torch.equal(ol_dp, ol), "18c: output lengths differ")
    if n < 2:
        check(dp.replicas is None and any("only 1 device is visible" in m for m in messages),
              f"18c: one card but replicas {dp.replicas} and warnings {messages}")
        check(torch.equal(lp_dp, lp), "18c: one card, yet the log-probs differ")
        how = "the warning logged, log-probs torch.equal to the engine without it"
    else:
        check(len(dp.replicas.models) == n, f"18c: {len(dp.replicas.models)} replicas on {n} cards")
        check(close(lp_dp, lp, **LOGPROB_TOL), "18c: log-probs across cards differ")
        how = f"rows split over {n} cards, log-probs within {LOGPROB_TOL}"
    print(f"[multi] 18c data_parallel serving on {n} card(s): {how}; text equal "
          f"{[h[:20] for h in hyps]}; launches of the forward {c}; card {card}")
    return c


def phase_multi(root: Path, fused_ckpt: Path, rng: np.random.Generator, card: str) -> dict:
    """Phase 18: data, tensor and sequence parallelism with FSDP on
    ``torch.distributed``: the trainer CLI at one rank and, with 2 or more
    cards, on an even number of them; tpu_scaled_large's step on 2 cards
    and on 4 when there are as many; ``data_parallel`` serving."""
    root.mkdir(parents=True, exist_ok=True)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    n = torch.cuda.device_count()
    parts = [multi_train(root, card)]
    if n >= 2:
        parts.append(multi_train(root, card, nproc=n - n % 2))
    parts.append(multi_large(root, card))
    if n >= 4:
        parts.append(multi_large(root, card, nproc=4))
    parts.append(multi_serving(fused_ckpt, rng, card))
    return {k: sum(part[k] for part in parts) for k in COUNTERS}


# ---------------------------------------- worker pool and GPipe (phase 19)

LOADER_UTTS = 256  # 8 batches of 32: every worker count up to 8 has a batch to build
LOADER_FRAMES = (640, 769)  # cached lengths of one 768-frame bucket (raw: × hop 10)
LOADER_WORKERS = (0, 4, 8)
LOADER_EPOCHS = 1  # steady epochs timed at each worker count, after a first one
PIPE_M = 16  # tpu_scaled_large's documented pipeline block: {model: 4, pipeline_microbatches: 16}
PIPE_ENC = {"conv_norm": "layer", "scan_layers": False, "pipeline_microbatches": PIPE_M}


def loader_corpus(root: Path, rng: np.random.Generator) -> Path:
    """``LOADER_UTTS`` voiced utterances of one 768-frame bucket: cached
    log-mel features (T, 8, 80), WavLM-width teacher features (T / 2, 768)
    and the raw EMG (10 T, 8) they stand for, all fp32; the shipped
    tpu_fast_plus config at B = 32 with the corpus's paths. The values are
    windows of one seeded normal draw (the loader's cost does not depend on
    them)."""
    root.mkdir(parents=True, exist_ok=True)
    vocab_path = root / "vocab.json"
    default_vocab().to_json(vocab_path)
    base = rng.standard_normal(2 * LOADER_FRAMES[1] * 640 * 2, dtype=np.float32)
    chars = list("abcdefghijklmnopqrstuvwxyz") + [" "] * 6
    rows = []
    for i in range(LOADER_UTTS):
        uid = f"voiced_parallel_data/s1/{i}_0"
        t = int(rng.integers(*LOADER_FRAMES))
        off = int(rng.integers(0, base.size // 2))
        arrays = {"emg": base[off:off + t * 640].reshape(t, CHANNELS, 80),
                  "teacher": base[off:off + (t // 2) * TEACHER_DIM].reshape(t // 2, TEACHER_DIM)}
        for kind, arr in arrays.items():
            path = root / "features" / kind / f"{uid}.npy"
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, arr)
        raw_path = root / "raw" / f"{i}_0_emg.npy"
        raw_path.parent.mkdir(parents=True, exist_ok=True)
        np.save(raw_path, base[off:off + 10 * t * CHANNELS].reshape(10 * t, CHANNELS))
        rows.append(dict(utterance_id=uid, split="voiced_parallel_data", subset="train",
                         speaker="s1", stem=f"{i}_0", emg_path=str(raw_path), audio_path=None,
                         transcript="".join(rng.choice(chars, size=int(rng.integers(30, 120)))),
                         sentence_index=i, book="", has_audio=False, metadata_json="{}"))
    save_index(rows, root / "index.jsonl")
    cfg = copy.deepcopy(shipped_config())
    cfg["data"].update(index=str(root / "index.jsonl"), features_root=str(root / "features"),
                       vocab=str(vocab_path))
    cfg["optim"]["batch_size"] = 32
    path = root / "config.json"
    path.write_text(json.dumps(cfg, indent=2))
    return path


def train_loader(cfg: dict, raw: bool, num_workers: int):
    """The trainer's training loader for ``cfg`` (its augmentation split
    between host and device as ``train_from_config`` splits it)."""
    from ssd_tpu_torch.data.dataset import make_dataloader

    spec_cfg, chan_cfg = trainer._augment_cfgs(cfg)
    host_aug = not raw and not cfg.get("augmentation", {}).get("on_device", False)
    fcfg = feat.FeaturizerConfig.from_config(cfg)
    return make_dataloader(
        index_path=Path(cfg["data"]["index"]), features_root=Path(cfg["data"]["features_root"]),
        splits=cfg["data"]["train_splits"], subsets=cfg["data"].get("train_subsets"),
        vocab=Vocab.from_json(Path(cfg["data"]["vocab"])), batch_size=cfg["optim"]["batch_size"],
        seed=SEED, spec_augment_cfg=spec_cfg if host_aug else None,
        channel_dropout_cfg=chan_cfg if host_aug else None, raw=raw,
        raw_hop_length=fcfg.hop_length, num_workers=num_workers)


def loader_rates(cfg: dict, raw: bool) -> tuple:
    """Batches/s of the training loader alone through the trainer's
    ``prefetch`` thread, at each worker count: a first epoch (the page
    cache warmed, the pool started, its slots grown) and then
    ``LOADER_EPOCHS`` steady ones. Returns {workers: (first, steady)} and
    one batch (for the step)."""
    from ssd_tpu_torch.data.dataset import prefetch

    rates, first = {}, None
    for n in LOADER_WORKERS:
        loader = train_loader(cfg, raw, n)
        try:
            t0 = time.perf_counter()
            for b in prefetch(loader):
                first = first or {k: np.array(v)
                                  for k, v in trainer.batch_to_arrays(b, True).items()}
            cold = len(loader) / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            batches = sum(1 for _ in range(LOADER_EPOCHS) for _ in prefetch(loader))
            rates[n] = (cold, batches / (time.perf_counter() - t0))
        finally:
            loader.close()
    return rates, first


def fused_step_ms(cfg: dict, arrays: dict, raw: bool) -> float:
    """The profiler's device time of one fused/pallas train step of
    tpu_fast_plus on the loader's batch (B = 32, 768 frames)."""
    model = build_model(model_cfg(encoder_key("dropout"), **FUSED),
                        input_dim=encoder_key("input_dim"), vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(SEED))
    model.cuda()
    opt, _ = build_optimizer(cfg, model.parameters(), 1000)
    featurize = feat.FeaturizerConfig.from_config(cfg) if raw else None
    step = trainer.make_train_step(BLANK, False, None, featurize)
    state = trainer.TrainState(model=model, optimizer=opt)
    batch = trainer.to_device(arrays, torch.device("cuda"))
    gen = torch.Generator("cuda").manual_seed(SEED + 1)

    def run():
        step(state, batch, LAMBDAS, gen)
        torch.cuda.synchronize()

    for _ in range(3):
        run()
    ms = sum(e.self_device_time_total for e in device_events(run)) / 1e3
    del model, opt, state, batch
    torch.cuda.empty_cache()
    return ms


class PoolWatch:
    """Samples the process table while a run trains: the loader's workers,
    forked by the fork server this process started (its grandchildren)."""

    def __init__(self, every: float = 0.05) -> None:
        self.me, self.every, self.most = os.getpid(), every, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def workers(self) -> int:
        parent, cmd = {}, {}
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                stat = Path(f"/proc/{pid}/stat").read_text()
                parent[int(pid)] = int(stat[stat.rindex(")") + 2:].split()[1])
                cmd[int(pid)] = Path(f"/proc/{pid}/cmdline").read_bytes()
            except (OSError, ValueError, IndexError):
                continue
        servers = {p for p, pp in parent.items() if pp == self.me and b"forkserver" in cmd[p]}
        return sum(1 for pp in parent.values() if pp in servers)

    def _watch(self) -> None:
        while not self._stop.is_set():
            self.most = max(self.most, self.workers())
            time.sleep(self.every)

    def __enter__(self) -> "PoolWatch":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> bool:
        self._stop.set()
        self._thread.join()
        return False


def workers_train(root: Path, card: str) -> dict:
    """Phase 19a: phase 7's corpus trained from raw EMG, fused/pallas, one
    epoch with the shipped ``data.num_workers: 4`` and with 0: every logged
    loss and trained weight bit-equal, the workers seen in the process
    table while it trains, none after."""
    base = load_config(root / "config.json")
    base["model"]["encoder"].update(FUSED)
    base["data"]["train_from_raw"] = True
    base["optim"]["max_epochs"] = 1
    shipped = int(base["optim"]["num_workers"])
    runs, watch = {}, None
    total = dict.fromkeys(COUNTERS, 0)
    for n in (shipped, 0):
        cfg = copy.deepcopy(base)
        cfg["data"]["num_workers"] = n
        t0 = time.perf_counter()
        reset_counts()
        with PoolWatch() as w:
            summary = trainer.train_from_config(cfg, root / f"workers_{n}", device="cuda")
        c = counts()
        for k in total:
            total[k] += c[k]
        h = summary["history"][0]
        h["train"].pop("utterances_per_sec_per_chip")
        runs[n] = (summary["history"], load_checkpoint(root / f"workers_{n}" / "last"),
                   time.perf_counter() - t0, w.most, c)
        if n:
            watch = w
    hist_w, ck_w, s_w, most, c_w = runs[shipped]
    hist_0, ck_0, s_0, most_0, _ = runs[0]
    check(hist_w == hist_0, f"19a: losses with {shipped} workers {hist_w} vs in-process {hist_0}")
    bad = [k for k, v in ck_0["state_dict"].items() if not torch.equal(ck_w["state_dict"][k], v)]
    check(not bad, f"19a: {len(bad)} trained weights differ with workers, e.g. {bad[:3]}")
    check(most == 2 * shipped and most_0 == 0,
          f"19a: {most} workers seen with num_workers {shipped} (train + val loaders: "
          f"{2 * shipped} expected), {most_0} at 0")
    check(watch.workers() == 0, "19a: worker processes outlived the trainer")
    n_train, n_eval = hist_w[0]["train"]["batches"], hist_w[0]["val"]["batches"]
    check(all(c_w[k] > 0 for k in ("logmel", "ctc_alpha", "ctc_beta", "attention_fwd",
                                   "attention_bwd", "depthwise_fwd", "depthwise_bwd")),
          f"19a: the worker-fed run launched {c_w}")
    print(f"[workers] 19a phase 7's corpus from raw EMG, fused/pallas, 1 epoch ({n_train} train "
          f"+ {n_eval} eval steps of B={base['optim']['batch_size']}): data.num_workers "
          f"{shipped} vs 0: losses and all trained weights bit-equal (torch.equal); {most} worker "
          f"processes seen in the process table while it trained (train + val loaders, "
          f"os.cpu_count() {os.cpu_count()}), 0 after; {s_w:.2f} s vs {s_0:.2f} s; launches "
          f"{ {k: v for k, v in c_w.items() if v} }; card {card}")
    return total


def workers_rates(root: Path, rng: np.random.Generator, card: str) -> None:
    """Phase 19a: the loader alone at B = 32 (cached features of 768
    frames, and raw EMG) at 0, 4 and 8 workers, beside the fused
    tpu_fast_plus step's device time on the same batch."""
    t0 = time.perf_counter()
    cfg = load_config(loader_corpus(root, rng))
    made = time.perf_counter() - t0
    B = cfg["optim"]["batch_size"]
    for raw in (False, True):
        mode = "raw EMG" if raw else "cached features"
        rates, arrays = loader_rates(cfg, raw)
        step_ms = fused_step_ms(cfg, arrays, raw)
        step_rate = 1e3 / step_ms
        best = max(r for _, r in rates.values())
        pace = "the loader" if best < step_rate else "the step"
        print(f"[workers] 19a loader alone, tpu_fast_plus B={B}, {mode} (768-frame bucket, "
              f"{LOADER_UTTS} utterances, fp32, teacher on, page cache warm), through the "
              f"trainer's prefetch thread, {LOADER_EPOCHS} steady epochs after a first one "
              f"(first in brackets): "
              + ", ".join(f"{n} workers {r:.3f} batches/s = {r * B:.1f} utt/s ({c:.3f})"
                          for n, (c, r) in rates.items())
              + f"; the fused step's device time on its batch {step_ms:.3f} ms = "
              f"{step_rate:.3f} steps/s = {step_rate * B:.1f} utt/s: {pace} sets the pace "
              f"(host os.cpu_count() {os.cpu_count()}); card {card}")
    print(f"[workers] 19a corpus written in {made:.2f} s")


def pipe_cfg(dtype: str = "bfloat16", **enc) -> dict:
    """tpu_scaled_large (full width, ``LARGE_BLOCKS`` deep unless ``enc`` cuts it),
    fused/pallas, with ``conv_norm: layer`` and the pipeline block's
    microbatches (``scan_layers`` off: the pipeline excludes it)."""
    cfg = copy.deepcopy(large_config())
    cfg["model"]["encoder"].update(compute_dtype=dtype, **FUSED, **PIPE_ENC)
    cfg["model"]["encoder"].update(enc)
    return cfg


def pipe_step(cfg: dict, batch: dict, steps: int = 1) -> tuple:
    """``steps`` of the trainer's step on one card for ``cfg`` (each data
    rank's rows padded to the microbatches as the trainer pads them): the
    losses and the profiler's device time of the last step."""
    from ssd_tpu_torch.parallel.mesh import RowSplit

    model = build_model(cfg, input_dim=large_key("input_dim"), vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(SEED))
    model.cuda()
    opt, _ = build_optimizer(cfg, model.parameters(), 1000)
    m = int(cfg["model"]["encoder"].get("pipeline_microbatches", 0))
    rows = RowSplit(microbatches=max(1, m)).take(batch, batch["emg"].shape[0])
    dev_batch = trainer.to_device(rows, torch.device("cuda"))
    featurize = feat.FeaturizerConfig.from_config(cfg)
    step = trainer.make_train_step(BLANK, False, None, featurize)
    state = trainer.TrainState(model=model, optimizer=opt)
    gen = torch.Generator("cuda").manual_seed(SEED + 1)
    losses = []

    def run():
        _, out = step(state, dev_batch, LAMBDAS, gen)
        losses.append({k: float(v) for k, v in out.items()})

    for _ in range(steps):
        run()
    ms = sum(e.self_device_time_total for e in device_events(run)) / 1e3
    del model, opt, state, dev_batch
    torch.cuda.empty_cache()
    return losses, ms


def pipe_large(root: Path, rng: np.random.Generator, card: str) -> dict:
    """Phase 19b: tpu_scaled_large with ``conv_norm: layer`` and
    ``pipeline_microbatches: 16`` on one card (no stages: the sequential
    stack), full width, ``LARGE_BLOCKS`` deep, bf16, fused/pallas, remat as shipped:
    trained steps that are finite, launches counted, the step's device time
    beside the same config unpipelined; served log-probs equal to the same
    weights unpipelined (``scan_layers``' fp32 carry, as shipped); the
    2-block card-vs-CPU step of phase 15e with the pipeline's keys."""
    L = large_key("num_layers")
    t0 = time.perf_counter()
    cfg = pipe_cfg()
    batch = large_batch(rng, LARGE_TRAIN_SHAPE[0])
    reset_counts()
    losses, ms = pipe_step(cfg, batch, steps=2)
    c = counts()
    check(all(np.isfinite(v) for l in losses for v in l.values()), f"19b losses {losses}")
    # remat recomputes each block's forward in the backward; 4 steps ran
    # (2, warm-up and profiled)
    n = len(losses)
    want = {"attention_fwd_bf16": 2 * L * n, "depthwise_fwd_bf16": 2 * L * n,
            "attention_bwd_bf16": L * n, "depthwise_bwd_bf16": L * n, "logmel": n,
            "ctc_alpha": n, "ctc_beta": n}
    check(all(c[k] == v for k, v in want.items()), f"19b launched {c}, expected {want}")
    plain = pipe_cfg(conv_norm="layer", scan_layers=True, pipeline_microbatches=0)
    plain_losses, plain_ms = pipe_step(plain, batch, steps=2)
    print(f"[pipeline] 19b tpu_scaled_large, conv_norm layer, pipeline_microbatches {PIPE_M}, "
          f"{L} blocks, d_model {large_key('d_model')}, bf16, fused/pallas, remat, B="
          f"{LARGE_TRAIN_SHAPE[0]} raw EMG, one card (the sequential stack): losses {losses}; "
          f"step device time (profiler) {ms:.3f} ms vs {plain_ms:.3f} ms unpipelined "
          f"(scan_layers, losses {plain_losses}); launches {c}; "
          f"{time.perf_counter() - t0:.2f} s; card {card}")
    totals = dict(c)

    t0 = time.perf_counter()
    model = large_model(**{k: v for k, v in PIPE_ENC.items()}, **FUSED)
    with torch.no_grad():
        model.ctc_head.fc.weight.mul_(10.0)
    served = {}
    for label, enc in (("pipelined", dict(PIPE_ENC, **FUSED)),
                       ("unpipelined", dict(conv_norm="layer", **FUSED))):
        ckpt = large_run_dir(root / f"pipe_{label}", model, **enc)
        engine = InferenceEngine.from_checkpoint(ckpt, device="cuda")
        reset_counts()
        served[label] = engine.forward(requests(np.random.default_rng(SEED), 8))
        c = counts()
        if label == "pipelined":
            for k in totals:
                totals[k] += c[k]
        del engine
    (lp, ol), (lp0, ol0) = served["pipelined"], served["unpipelined"]
    check(torch.equal(ol, ol0) and torch.equal(lp, lp0),
          "19b: served log-probs pipelined vs unpipelined differ")
    print(f"[pipeline] 19b the pipelined checkpoint served (B=8): log-probs torch.equal to the "
          f"same weights unpipelined (scan_layers' fp32 carry); launches {c}; "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    large_train_parity(rng, enc=dict(PIPE_ENC, pipeline_microbatches=LARGE_PARITY_B),
                       configs=(True,), tag="19b pipelined")
    print(f"[pipeline] 19b card-vs-CPU step {time.perf_counter() - t0:.2f} s")
    return totals


PIPE_SCHED = dict(blocks=2, B=4, M=4, T=384)  # the world-1 schedule check


def rank_pipe(spec_path: str) -> int:
    """Phase 19b's world-1 rank: ``pipeline.gpipe`` at one stage and M = 4
    over an NCCL group of one, against ``sequential_stack`` on the same
    blocks, input and output gradient (fp32, fused/pallas, full width, 2
    blocks): outputs, input and parameter gradients."""
    import torch.distributed as dist

    from ssd_tpu_torch.parallel import pipeline as pp
    from ssd_tpu_torch.parallel.mesh import maybe_initialize_distributed

    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize_distributed(device="cuda")
    try:
        cfg = pipe_cfg("float32", num_layers=PIPE_SCHED["blocks"], dropout=0.0,
                       pipeline_microbatches=PIPE_SCHED["M"])
        model = build_model(cfg, input_dim=large_key("input_dim"), vocab_size=48)
        init_flax_style(model, torch.Generator().manual_seed(SEED))
        model.cuda()
        enc = model.encoder
        g = torch.Generator().manual_seed(SEED)
        B, T, D = PIPE_SCHED["B"], PIPE_SCHED["T"], large_key("d_model")
        x = torch.randn(B, T, D, generator=g).cuda()
        gy = torch.randn(B, T, D, generator=g).cuda()
        lengths = torch.tensor([T, T - 50, T - 120, 40])
        mask = (torch.arange(T)[None] < lengths[:, None]).cuda()
        out = {}
        reset_counts()
        for label in ("sequential", "gpipe"):
            model.zero_grad()
            xi = x.clone().requires_grad_(True)
            if label == "gpipe":
                y = pp.gpipe(enc.cfg, enc.blocks, xi, mask, True, None, PIPE_SCHED["M"],
                             dist.group.WORLD)
            else:
                y = pp.sequential_stack(enc.cfg, enc.blocks, xi, mask, True, None)
            y.backward(gy)
            out[label] = {"y": y.detach().cpu(), "gx": xi.grad.cpu(),
                          "grads": {n: p.grad.cpu() for n, p in enc.blocks.named_parameters()}}
        out.update(backend=dist.get_backend(), world=dist.get_world_size(), counts=counts())
        torch.save(out, spec["out"])
    finally:
        dist.destroy_process_group()
    return 0


def pipe_schedule(root: Path, card: str) -> dict:
    """Phase 19b: the schedule's own function under ``torchrun
    --nproc-per-node 1`` (NCCL), at one stage and M = 4, against the
    sequential stack within phase 8's fp32 tolerances."""
    t0 = time.perf_counter()
    spec = root / "pipe_rank_spec.json"
    spec.write_text(json.dumps({"out": str(root / "pipe_rank.pt")}))
    torchrun(1, "--rank-pipe", str(spec))
    got = torch.load(root / "pipe_rank.pt", weights_only=False)
    check(got["backend"] == "nccl" and got["world"] == 1, f"19b: {got['backend']} {got['world']}")
    a, b = got["gpipe"], got["sequential"]
    scale = float(b["y"].abs().max())
    err = float((a["y"] - b["y"]).abs().max())
    check(err <= TRAIN_LOSS_RTOL * scale, f"19b gpipe output {err} vs {scale}")
    worst = (float((a["gx"] - b["gx"]).abs().max()) / float(b["gx"].abs().max()), "input")
    check(worst[0] <= TRAIN_GRAD_REL, f"19b gpipe input gradient {worst}")
    noise = 0.0  # the key bias: its true gradient is 0 (softmax is shift invariant)
    for n, w in b["grads"].items():
        e = float((a["grads"][n] - w).abs().max())
        if n.endswith(".attn.mha.key.bias"):
            noise = max(noise, e)
            continue
        bound = max(TRAIN_GRAD_REL * float(w.abs().max()), TRAIN_GRAD_FLOOR)
        check(e <= bound, f"19b gpipe grad {n}: {e} > {bound}")
        if bound > TRAIN_GRAD_FLOOR:
            worst = max(worst, (e / float(w.abs().max()), n))
    c = got["counts"]
    check(all(c[k] > 0 for k in ("attention_fwd", "attention_bwd", "depthwise_fwd",
                                 "depthwise_bwd")), f"19b: the schedule's rank launched {c}")
    print(f"[pipeline] 19b pipeline.gpipe at 1 stage, M={PIPE_SCHED['M']}, under torchrun "
          f"--nproc-per-node 1 over {got['backend']}, fp32 fused/pallas, d_model "
          f"{large_key('d_model')}, {PIPE_SCHED['blocks']} blocks, B={PIPE_SCHED['B']}, "
          f"T'={PIPE_SCHED['T']}: output within {err / scale:.3e} of its largest (rtol "
          f"{TRAIN_LOSS_RTOL}), worst gradient {worst[0]:.3e} of its largest ({worst[1]}; limit "
          f"{TRAIN_GRAD_REL}) vs the sequential stack, the key bias's rounding noise {noise:.3e}; "
          f"launches {c}; "
          f"{time.perf_counter() - t0:.2f} s; card {card}")
    return c


PIPE_STEPS = 4  # 19c's train steps: step 1 cold, step 2 profiled, the last timed warm
PIPE_MULTI = (  # (cards needed, parallel: block)
    (2, {"model": 2, "pipeline_microbatches": 4}),
    (4, {"model": 4, "pipeline_microbatches": PIPE_M}),
    (4, {"data": 2, "model": 2, "pipeline_microbatches": 4, "fsdp": True}),
)


def pipe_multi(root: Path, rng: np.random.Generator, card: str) -> dict:
    """Phase 19c: with two or more cards, the trainer CLI under torchrun on
    tpu_scaled_large (conv_norm layer, fp32, fused/pallas, dropout 0,
    augmentation off) with each ``parallel:`` block of ``PIPE_MULTI`` the
    cards allow, against one card's ``train_from_config`` from the same
    seed within phase 18's tolerances; with one card a skip line."""
    n = torch.cuda.device_count()
    total = dict.fromkeys(COUNTERS, 0)
    if n < 2:
        print(json.dumps({"phase": "19c", "skipped": f"{n} CUDA device visible"}))
        return total
    cfg_path = large_corpus(root / "pipe_corpus", rng, n_train=PIPE_STEPS * 32)
    base = load_config(cfg_path)
    base["model"]["encoder"].update(compute_dtype="float32", dropout=0.0, **FUSED, **PIPE_ENC)
    base["model"]["ctc_dropout"] = 0.0
    base["data"].update(teacher_dtype="float32")
    base["augmentation"] = {}
    base["optim"]["max_epochs"] = 1
    L = large_key("num_layers")
    # one card runs the blocks in order whatever M is (B = 32 needs no
    # padding for any block below): one reference serves every block
    t0 = time.perf_counter()
    rec = StepRecorder()
    with rec.patch():
        trainer.train_from_config(copy.deepcopy(base), root / "pipe_one",
                                  overfit_batches=PIPE_STEPS,
                                  device="cuda")
    want = rec.result()
    w_want = load_checkpoint(root / "pipe_one" / "last")
    print(f"[pipeline] 19c one card: {time.perf_counter() - t0:.2f} s")
    for need, par in PIPE_MULTI:
        if n < need:
            continue
        t0 = time.perf_counter()
        label = "_".join(f"{k}{v}" for k, v in par.items())
        cfg = copy.deepcopy(base)
        cfg["parallel"] = dict(par)
        cfg_file = root / f"pipe_{label}.json"
        cfg_file.write_text(json.dumps(cfg))
        out = root / f"pipe_{label}"
        spec = root / f"pipe_{label}_spec.json"
        spec.write_text(json.dumps({"runs": [{"out": str(out), "argv": [
            "--config", str(cfg_file), "--run-dir", str(root / f"pipe_ranks_{label}"),
            "--overfit-batches", str(PIPE_STEPS)]}]}))
        torchrun(need, "--rank-train", str(spec))
        ranks = [json.loads(Path(f"{out}.rank{r}.json").read_text()) for r in range(need)]
        got = ranks[0]
        check(all(r["backend"] == "nccl" and r["world"] == need for r in ranks),
              f"19c {label}: {[r['backend'] for r in ranks]}")
        check(all(r["losses"] == got["losses"] for r in ranks),
              f"19c {label}: the ranks report different losses")
        for a, b in zip(got["losses"], want["losses"]):
            for k in ("total", "ctc", "distill"):
                check(abs(a[k] - b[k]) <= TRAIN_LOSS_RTOL * abs(b[k]),
                      f"19c {label}: {k} loss {a[k]} vs one card {b[k]}")
        w_got = load_checkpoint(root / f"pipe_ranks_{label}" / "last")
        bad, gap, means = weights_gap(w_got["state_dict"], w_want["state_dict"])
        check(gap <= MULTI_WEIGHT_ATOL, f"19c {label}: weights off by {gap}")
        stages = par["model"]
        missing = [(r["rank"], k) for r in ranks for k in ("attention_fwd", "attention_bwd",
                                                           "depthwise_fwd", "depthwise_bwd")
                   if r["counts"][k] == 0]
        check(not missing, f"19c {label}: a stage never launched {missing}")
        per_stage = [r["counts"]["attention_bwd"] for r in ranks]
        for k in total:
            total[k] += sum(r["counts"][k] for r in ranks)
        m = par["pipeline_microbatches"]
        print(f"[pipeline] 19c trainer CLI, torchrun --nproc-per-node {need}, parallel {par}: "
              f"tpu_scaled_large fp32 fused/pallas, {L} blocks over {stages} stages, dropout 0, "
              f"{PIPE_STEPS} steps of B={base['optim']['batch_size']}: losses "
              f"{[round(l['total'], 6) for l in got['losses']]} vs one card "
              f"{[round(l['total'], 6) for l in want['losses']]} (rtol {TRAIN_LOSS_RTOL}); "
              f"{len(bad)} tensors not bit-equal, worst {gap:.3e} (atol {MULTI_WEIGHT_ATOL}); "
              f"step {PIPE_STEPS}'s span (CUDA events) by rank "
              f"{[round(r['step_ms'][-1], 3) for r in ranks]} "
              f"ms vs {want['step_ms'][-1]:.3f} ms one card (x"
              f"{got['step_ms'][-1] / want['step_ms'][-1]:.3f}; the GPipe bubble alone "
              f"(M+S-1)/M = {(m + stages - 1) / m:.4f}); device busy by rank "
              f"{[round(r['busy_ms'], 3) for r in ranks]} ms vs {want['busy_ms']:.3f} ms; "
              f"attention backward launches by rank {per_stage}; "
              f"{time.perf_counter() - t0:.2f} s; card {card}")
    # dropout on (the shipped rates), twice from one seed over 2 stages
    t0 = time.perf_counter()
    need, par = PIPE_MULTI[0]
    runs = []
    for run in ("a", "b"):
        cfg = copy.deepcopy(base)
        cfg["model"]["encoder"]["dropout"] = large_key("dropout")
        cfg["model"]["ctc_dropout"] = large_config()["model"]["ctc_dropout"]
        cfg["parallel"] = dict(par)
        cfg_file = root / f"pipe_dropout_{run}.json"
        cfg_file.write_text(json.dumps(cfg))
        out = root / f"pipe_dropout_{run}"
        spec = root / f"pipe_dropout_{run}_spec.json"
        spec.write_text(json.dumps({"runs": [{"out": str(out), "argv": [
            "--config", str(cfg_file), "--run-dir", str(root / f"pipe_dropout_ranks_{run}"),
            "--overfit-batches", str(PIPE_STEPS)]}]}))
        torchrun(need, "--rank-train", str(spec))
        rank0 = json.loads(Path(f"{out}.rank0.json").read_text())
        runs.append((rank0["losses"],
                     load_checkpoint(root / f"pipe_dropout_ranks_{run}" / "last")["state_dict"]))
    (la, wa), (lb, wb) = runs
    check(la == lb and all(np.isfinite(l[k]) for l in la for k in l),
          f"19c dropout: losses {la} vs {lb}")
    bad = [k for k in wa if not torch.equal(wa[k], wb[k])]
    check(not bad, f"19c dropout: {len(bad)} trained weights differ run to run, e.g. {bad[:3]}")
    print(f"[pipeline] 19c trainer CLI over {need} cards, parallel {par}, dropout "
          f"{large_key('dropout')}: two runs from one seed bit-equal (losses "
          f"{[round(l['total'], 6) for l in la]}, every trained weight torch.equal); "
          f"{time.perf_counter() - t0:.2f} s")
    return total


def phase_pipeline_workers(root: Path, train_dir: Path, rng: np.random.Generator,
                           card: str) -> dict:
    """Phase 19: the loader's worker pool (a) and the GPipe schedule (b, c)."""
    root.mkdir(parents=True, exist_ok=True)
    steps, total = {}, dict.fromkeys(COUNTERS, 0)

    def add(part):
        for k in total:
            total[k] += part[k]

    for name, fn, args in (("19a train", workers_train, (train_dir, card)),
                           ("19a rates", workers_rates, (root / "loader", rng, card)),
                           ("19b large", pipe_large, (root, rng, card)),
                           ("19b schedule", pipe_schedule, (root, card)),
                           ("19c", pipe_multi, (root, rng, card))):
        t0 = time.perf_counter()
        part = fn(*args)
        steps[name] = time.perf_counter() - t0
        if part:
            add(part)
    print("[pipeline] phase 19 seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    return total


# ------------------------------------------------- the experiment sweep (phase 20)

SWEEP_SILENT = (12, 8)  # silent utterances beside phase 7's 20 voiced: (all, train)
SWEEP_PROBE_BATCHES = 2  # --probe-batches and --probe-batches-silent
SWEEP_TIMEOUT = 600  # seconds for the sweep's orchestrator and all its children
SWEEP_EPOCHS = 3  # stage 2's max_epochs (50 as shipped, early stopping after 13–30): the run's time
LM_ENTRY = {"name": "beam50_lm", "method": "beam", "beam_width": 50, "alpha": 0.5,
            "use_lm": True, "lm_path": "results/lm/char_5gram.arpa"}
BEAM50 = {"name": "beam50", "method": "beam", "beam_width": 50, "alpha": 0.45}
GREEDY = {"name": "greedy", "method": "greedy"}
# the slim decoder grids: greedy and beam 50, and one LM entry, skipped for
# want of an ARPA file
SWEEP_GRIDS = {"probe_voiced": [BEAM50], "probe_silent": [GREEDY],
               "full_voiced": [GREEDY, LM_ENTRY], "full_silent": [BEAM50]}
REPO_ROOT = Path(__file__).resolve().parent


def sweep_workdir(wd: Path, train_dir: Path, rng: np.random.Generator) -> None:
    """Phase 20a: the sweep's working directory. Phase 7's voiced corpus (its
    index rows and, linked, its feature directories) and 12 silent
    utterances made the same way; the shipped voiced and silent base configs
    read by the port's YAML reader, full width, with only the data paths,
    the fused/pallas keys, (silent) ``train_from_raw`` and stage 2's
    ``max_epochs`` (``SWEEP_EPOCHS``) changed, written
    back by its YAML writer; one probe variant a dataset (1 epoch) and the
    slim decoder grids."""
    data = wd / "data"
    for kind in ("emg", "teacher"):
        link = data / "features" / kind / "voiced_parallel_data"
        link.parent.mkdir(parents=True, exist_ok=True)
        link.symlink_to(train_dir / "features" / kind / "voiced_parallel_data",
                        target_is_directory=True)
    rows = index_dataset.load_index(train_dir / "index.jsonl")
    rows += utterances(data, rng, "silent_parallel_data", *SWEEP_SILENT)
    save_index(rows, data / "index.jsonl")
    paths = dict(index=str(data / "index.jsonl"), features_root=str(data / "features"),
                 vocab=str(train_dir / "vocab.json"))
    (wd / "configs" / "experiments").mkdir(parents=True)
    for name, raw in (("tpu_fast_plus.yaml", False), ("tpu_silent_finetune_plus.yaml", True)):
        cfg = read_yaml((CONFIG_PATH.parent / name).read_text(), name)
        cfg["data"].update(paths)
        if raw:
            cfg["data"]["train_from_raw"] = True
        cfg["optim"]["max_epochs"] = SWEEP_EPOCHS
        cfg["model"]["encoder"].update(FUSED)
        (wd / "configs" / name).write_text(write_yaml(cfg))
    for dataset in ("voiced", "silent"):
        probes = {"base_overrides": {"optim": {"max_epochs": 1}},
                  "variants": [{"name": f"probe_{dataset[0]}_base", "overrides": {},
                                "tags": ["baseline"], "description": f"one {dataset} probe"}]}
        (wd / "configs" / "experiments" / f"{dataset}_probes.yaml").write_text(write_yaml(probes))
    (wd / "configs" / "experiments" / "decoder_grids.yaml").write_text(write_yaml(SWEEP_GRIDS))


def orchestrate(wd: Path, *extra: str) -> list:
    """``python -m ssd_tpu_torch.experiments.orchestrate`` in ``wd`` (the
    default ``--device cuda`` for every child), waited for; its log, the
    children's included, as (seconds since the start, line) pairs."""
    cmd = [sys.executable, "-m", "ssd_tpu_torch.experiments.orchestrate",
           "--probe-batches", str(SWEEP_PROBE_BATCHES),
           "--probe-batches-silent", str(SWEEP_PROBE_BATCHES), *extra]
    t0 = time.perf_counter()
    # its own session, so that the watchdog stops the running child with it
    proc = subprocess.Popen(cmd, cwd=wd, env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    watchdog = threading.Timer(SWEEP_TIMEOUT, os.killpg, (proc.pid, signal.SIGKILL))
    watchdog.start()
    try:
        lines = [(time.perf_counter() - t0, line.rstrip("\n")) for line in proc.stdout]
        rc = proc.wait()
    finally:
        watchdog.cancel()
    if rc:
        print("\n".join(line for _, line in lines[-150:]))
        raise SmokeFailure(f"the sweep {' '.join(extra)} exited {rc}")
    return lines


def children(lines: list) -> list:
    """Each child the orchestrator started, in order (the children write into
    the orchestrator's own stream): its command line, output, seconds, and
    the seconds to its first line (start-up: the interpreter, torch, CUDA)."""
    starts = [i for i, (_, line) in enumerate(lines) if "Running: " in line]
    out = []
    for k, i in enumerate(starts):
        end = starts[k + 1] if k + 1 < len(starts) else len(lines) - 1
        body = lines[i + 1:end]
        out.append({"cmd": lines[i][1].split("Running: ", 1)[1],
                    "out": "\n".join(line for _, line in body),
                    "seconds": lines[end][0] - lines[i][0],
                    "first": (body[0][0] if body else lines[end][0]) - lines[i][0],
                    "epochs": [t - lines[i][0] for t, line in body
                               if re.search(r"Epoch \d+ done", line)]})
    return out


def sweep_check(wd: Path, lines: list, card: str) -> dict:
    """Phase 20b: the sweep's records, summary files, init-checkpoint chain,
    skipped LM entries and the children's device; where its time went."""
    from ssd_tpu_torch.experiments.orchestrate import CSV_FIELDS, pick_best

    log = "\n".join(line for _, line in lines)
    records = json.loads((wd / "results/experiments/summary.json").read_text())
    g = {k: [e for e in v if not e.get("use_lm")] for k, v in SWEEP_GRIDS.items()}
    want = (len(g["probe_voiced"]) + 2 * len(g["full_voiced"]) + len(g["probe_silent"])
            + 2 * len(g["full_silent"]))
    check(len(records) == want, f"sweep: {len(records)} records, expected {want}")
    header = (wd / "results/experiments/summary.csv").read_text().splitlines()[0]
    check(header.split(",") == CSV_FIELDS, f"sweep: summary.csv header {header}")
    cells = {(r["stage"], r["dataset"]) for r in records}
    check(cells == {("stage1", "voiced"), ("stage2", "voiced"), ("stage1", "silent"),
                    ("stage2", "silent")}, f"sweep: cells {cells}")
    for r in records:
        check(r["cer"] is not None and np.isfinite(r["cer"]) and r["wer"] is not None,
              f"sweep: {r['train_run']} {r['decoder_name']} CER {r['cer']} WER {r['wer']}")
    seed = pick_best(records, "voiced", "stage2")["checkpoint_path"]
    runs = children(lines)
    trains = [r for r in runs if "ssd_tpu_torch.training.train" in r["cmd"]]
    evals = [r for r in runs if "ssd_tpu_torch.evaluation.evaluate" in r["cmd"]]
    silent = [r["cmd"] for r in trains if "probe_s_" in r["cmd"] or "stage2_silent" in r["cmd"]]
    check(len(trains) == 6 and len(evals) == want and len(silent) == 3,
          f"sweep: {len(trains)} trainings ({len(silent)} silent), {len(evals)} evals")
    check(all(f"--init-checkpoint {seed} " in c + " " for c in silent)
          and all(r["init_checkpoint"] == seed for r in records if r["dataset"] == "silent"),
          f"sweep: the silent runs did not all start from the best stage-2 voiced {seed}")
    check("LM unavailable" in log and not any(r["decoder_name"] == LM_ENTRY["name"]
                                              for r in records),
          "sweep: the LM entry was not skipped")
    off_card = [r["cmd"] for r in trains
                if not re.search(r"Train batches: .* device cuda:\d", r["out"])]
    off_card += [r["cmd"] for r in evals if not re.search(r"Decoder: .* device cuda:\d", r["out"])]
    check(all(r["cmd"].endswith("--device cuda") or "--device cuda " in r["cmd"] for r in runs)
          and not off_card, f"sweep: children whose log does not name the card: {off_card}")
    best = {d: pick_best(records, d) for d in ("voiced", "silent")}
    print(f"[sweep] 20b {len(trains)} trainings ({len(silent)} from {seed}), {len(evals)} evals "
          f"(LM entries skipped), every child on {card.split(',')[0]} (--device cuda; each "
          f"trainer's and eval's log names cuda); {len(records)} records; best voiced "
          f"{best['voiced']['train_run']} {best['voiced']['decoder_name']} CER "
          f"{best['voiced']['cer']:.4f}, best silent {best['silent']['train_run']} "
          f"{best['silent']['decoder_name']} CER {best['silent']['cer']:.4f} (random data)")
    for r in trains:
        gaps = np.diff([r["first"], *r["epochs"]]) if r["epochs"] else []
        print(f"[sweep] 20b {r['cmd'].split('--run-dir ')[1].split()[0].split('/')[-1]}: "
              f"{r['seconds']:.2f} s, first log line after {r['first']:.2f} s, "
              f"{len(r['epochs'])} epochs, an epoch's wall (train, val, checkpoint) "
              f"p50 {np.median(gaps) if len(gaps) else float('nan'):.2f} s")
    secs = ", ".join(f"{r['seconds']:.2f}" for r in evals)
    firsts = ", ".join(f"{r['first']:.2f}" for r in evals)
    print(f"[sweep] 20b evals {secs} s (first log line after {firsts} s); all children "
          f"{sum(r['seconds'] for r in runs):.2f} s, start-up to the first log line "
          f"{sum(r['first'] for r in runs):.2f} s; host clock; {card}")
    return {"records": records, "children": len(runs)}


def sweep_average(wd: Path, records: list, card: str) -> dict:
    """Phase 20d: the best stage-2 silent run's ``best`` and ``last``
    averaged by the CLI, bit-equal to a float64 mean taken here, then
    evaluated in-process on the card from raw EMG (launches counted),
    log-probs held to a CPU forward of the same weights."""
    from ssd_tpu_torch.experiments.orchestrate import pick_best

    run = wd / Path(pick_best(records, "silent", "stage2")["checkpoint_path"]).parent
    out = wd / "results/checkpoints/silent_average"
    cmd = [sys.executable, "-m", "ssd_tpu_torch.training.average_checkpoints",
           "--checkpoints", str(run / "best"), str(run / "last"), "--output", str(out)]
    proc = subprocess.run(cmd, cwd=wd, env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)),
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        print(proc.stderr[-4000:])
        raise SmokeFailure(f"average_checkpoints exited {proc.returncode}")
    parts = [load_checkpoint(run / d) for d in ("best", "last")]
    avg = load_checkpoint(out / "last")
    bad = [k for k, t in avg["state_dict"].items() if not torch.equal(
        t, ((parts[0]["state_dict"][k].double() + parts[1]["state_dict"][k].double()) / 2)
        .to(t.dtype))]
    check(not bad and set(avg["state_dict"]) == set(parts[0]["state_dict"]),
          f"average: {len(bad)} tensors differ from the float64 mean, e.g. {bad[:3]}")
    check("optimizer" not in avg and avg["epoch"] == max(p["epoch"] for p in parts)
          and avg["step"] == max(p["step"] for p in parts),
          f"average: epoch {avg.get('epoch')} step {avg.get('step')} keys {sorted(avg)}")
    cfg = load_config(out / "config.json")
    check(cfg == load_config(run / "config.json"), "average: config.json is not the run's")
    check(cfg["data"].get("train_from_raw") is True and cfg["model"]["encoder"].get(
        "attention_impl") == "fused", "average: not a raw-EMG fused/pallas checkpoint")

    L = cfg["model"]["encoder"]["num_layers"]
    reference = cpu_log_probs(out / "last", cfg)
    seen = []
    with captured_decodes(seen):
        reset_counts()
        ev.main(["--checkpoint", str(out / "last"), "--device", "cuda", "--decoder", "greedy",
                 "--batch-size", str(EVAL_BATCH), "--output", str(wd / "results/eval/average")])
        c = counts()
    batches = len(seen)
    want = dict.fromkeys(COUNTERS, 0)
    want.update(logmel=batches, attention_fwd=L * batches, depthwise_fwd=L * batches)
    check(batches == len(reference) == 2 and c == want,
          f"average eval: {batches} batches launched {c}, expected {want}")
    errs = []
    for (kwargs, lp, ol, decoded), (lp_cpu, ol_cpu) in zip(seen, reference):
        check(lp.is_cuda and torch.equal(ol.cpu(), ol_cpu), "average eval: out lengths differ")
        errs.append(float((lp.cpu() - lp_cpu).abs().max()))
        check(close(lp.cpu(), lp_cpu, **LOGPROB_TOL),
              f"average eval: card vs CPU log-probs max abs err {errs[-1]} > {LOGPROB_TOL}")
        check(decoded == decoding.build_decoder(**kwargs)(lp.cpu(), ol.cpu()),
              "average eval: the card's greedy texts differ from the CPU decoder's")
    metrics = json.loads((wd / "results/eval/average/metrics.json").read_text())
    print(f"[sweep] 20d {run.name} best (epoch {parts[0].get('epoch')}) + last (epoch "
          f"{parts[1].get('epoch')}) averaged: {len(avg['state_dict'])} tensors torch.equal to "
          f"the float64 mean, epoch {avg['epoch']} step {avg['step']}, no optimizer; evaluated "
          f"in-process on the card from raw EMG, {metrics['data']['num_samples']} utterances in "
          f"{batches} batches, CER {metrics['cer']:.4f}; log-probs vs the CPU forward max abs err "
          f"{max(errs):.3e} (tol {LOGPROB_TOL}); launches {({k: v for k, v in c.items() if v})}; "
          f"{card}")
    return c


def sweep_visualize(wd: Path) -> None:
    """Phase 20e: the feature visualizer on one cached utterance (host only),
    or a skip line where matplotlib is not installed."""
    if importlib.util.find_spec("matplotlib") is None:
        print(json.dumps({"phase": "20e", "skipped": "matplotlib not installed"}))
        return
    utt = "voiced_parallel_data/s1/0_0"
    cmd = [sys.executable, "-m", "ssd_tpu_torch.evaluation.visualize", "--features-root",
           str(wd / "data/features"), "--utterance-id", utt, "--out-dir", str(wd / "plots"),
           "--umap"]
    proc = subprocess.run(cmd, cwd=wd, env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)),
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"visualize exited {proc.returncode}: {proc.stderr[-2000:]}")
    sizes = {s: (wd / "plots" / f"{utt.replace('/', '_')}_{s}.png").stat().st_size
             for s in ("emg", "emg_teacher", "teacher_umap")}
    check(all(sizes.values()), f"visualize: empty plots {sizes}")
    print(f"[sweep] 20e visualize on {utt}: PNG bytes {sizes}")


def phase_sweep(root: Path, train_dir: Path, rng: np.random.Generator, card: str) -> dict:
    """Phase 20: the two-stage experiment sweep on the card (setup, sweep,
    resume, average, visualize); returns the in-process eval's launches."""
    steps = {}
    t0 = time.perf_counter()
    sweep_workdir(root, train_dir, rng)
    steps["20a setup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines = orchestrate(root)
    steps["20b sweep"] = time.perf_counter() - t0
    swept = sweep_check(root, lines, card)
    t0 = time.perf_counter()
    again = orchestrate(root, "--resume")
    steps["20c resume"] = time.perf_counter() - t0
    records = json.loads((root / "results/experiments/summary.json").read_text())
    check(children(again) == [] and any("skipping" in line for _, line in again)
          and records == swept["records"],
          f"resume: {len(children(again))} children started, records "
          f"{'unchanged' if records == swept['records'] else 'changed'}")
    print(f"[sweep] 20c --resume: no child started, {len(records)} records unchanged, "
          f"{steps['20c resume']:.2f} s")
    t0 = time.perf_counter()
    c = sweep_average(root, records, card)
    steps["20d average+eval"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep_visualize(root)
    steps["20e visualize"] = time.perf_counter() - t0
    print(f"[sweep] 20b {swept['children']} child processes in {steps['20b sweep']:.2f} s")
    print("[sweep] phase 20 seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    return c


def cache_children_bytecode(run_dir: Path) -> None:
    """Let the Python processes this run starts (torchrun ranks, the sweep's
    children) write and reuse compiled bytecode under ``run_dir``: where the
    environment forbids writing it (``PYTHONDONTWRITEBYTECODE``) and the
    installed packages ship none, every child compiles torch's sources
    again, ~3 s of its start-up on the card machine."""
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(run_dir / "pycache")


# ------------------------------------------ layout conversion (phase 21)

CONVERT_B = 8  # raw requests a checkpoint is served: one 12 800-sample bucket
CONVERT_BF16_ATOL = 5e-2  # unrolled vs scan bf16 log-probs (tests/test_torch_convert_layout.py)


def convert_forward(ckpt: Path, reqs: list, counted: Launches, what: str) -> tuple:
    """``ckpt`` served on the card: the log-probs and lengths of ``reqs``,
    and the seconds the engine took to load and to run them."""
    t0 = time.perf_counter()
    engine = InferenceEngine.from_checkpoint(ckpt, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = counts()
    lp, ol = engine.forward(reqs)
    torch.cuda.synchronize()
    counted.add(what, before, 1)
    return lp, ol, (t1 - t0, time.perf_counter() - t1)


def convert_round_trip(root: Path, cfg: dict, input_dim: int, reqs: list, name: str) -> tuple:
    """``cfg``'s model (a ``scan_layers`` source) saved, converted to
    unrolled and back to scan with the CLI, and each checkpoint served:
    (log-probs of source, unrolled, round trip; lengths; launches)."""
    enc = cfg["model"]["encoder"]
    check(enc["scan_layers"], f"{name}: the source must scan")
    L = enc["num_layers"]
    suffix = "_bf16" if enc.get("compute_dtype") == "bfloat16" else ""
    counted = Launches({"logmel": 1, f"attention_fwd{suffix}": L, f"depthwise_fwd{suffix}": L})
    t0 = time.perf_counter()
    model = build_model(cfg, input_dim=input_dim, vocab_size=48)
    init_flax_style(model, torch.Generator().manual_seed(SEED))
    root.mkdir(parents=True, exist_ok=True)
    default_vocab().to_json(root / "vocab.json")
    cfg = dict(cfg, data={"vocab": str(root / "vocab.json")})
    save_checkpoint(root / "scan", model.state_dict(), cfg, epoch=1, step=2)
    del model
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_layout.main(["--checkpoint", str(root / "scan" / "last"), "--to", "unrolled",
                         "--output", str(root / "unrolled")])
    convert_layout.main(["--checkpoint", str(root / "unrolled" / "last"), "--to", "scan",
                         "--output", str(root / "back")])
    converted = time.perf_counter() - t0
    for layout, want in (("unrolled", False), ("back", True)):
        saved = json.loads((root / layout / "config.json").read_text())["model"]["encoder"]
        check(saved["scan_layers"] is want,
              f"{name}: {layout}'s scan_layers {saved['scan_layers']}")
        payload = load_checkpoint(root / layout / "last")
        check((payload["epoch"], payload["step"]) == (1, 2), f"{name}: {layout}'s counters")
    out = [convert_forward(root / layout / "last", reqs, counted, f"{name} {layout}")
           for layout in ("scan", "unrolled", "back")]
    lengths = out[0][1]
    check(all(torch.equal(o[1], lengths) for o in out), f"{name}: out lengths differ")
    served = ", ".join(f"{load:.2f} + {fwd:.2f}" for _, _, (load, fwd) in out)
    print(f"[convert] {name}: model built and saved {made:.2f} s, two conversions "
          f"{converted:.2f} s, three checkpoints served (engine load + forward) {served} s")
    return [o[0] for o in out], lengths, counted.total


# the forwards that run while a checkpoint is written: the training batch
# (B 32, 768 frames), bf16, fused/pallas, without gradients
STALL_B, STALL_FRAMES = 32, 768


def checkpoint_stall(root: Path, card: str) -> None:
    """Phase 21b: how long one epoch's checkpoint holds the training thread
    for the full-depth tpu_scaled_large state (12 blocks, 166.29 M
    parameters with their AdamW moments, ``last`` + ``best``):
    ``save_checkpoint`` (synchronous) against the trainer's
    ``CheckpointWriter(async_saves=True).save`` (the host snapshot: its
    return, then its copies landed), the write itself (``finalize`` right
    after a save), and whether bf16 forwards keep the card busy while the
    write runs (their time beside the same forwards alone, over about half
    the write's length). The async ``last`` must be ``torch.equal`` to the
    sync one (phase 11c holds ``best`` too)."""
    t_start = time.perf_counter()
    full = load_config(LARGE_PATH)
    cfg = {k: full[k] for k in ("model", "features", "optim", "logging")}
    cfg["model"]["encoder"].update(FUSED)
    L, input_dim = cfg["model"]["encoder"]["num_layers"], cfg["model"]["encoder"]["input_dim"]
    check(L == 12, f"{LARGE_PATH.name}: expected 12 blocks, got {L}")
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        model = build_model(cfg, input_dim=input_dim, vocab_size=48)
    params = list(model.parameters())
    optimizer, _ = build_optimizer(cfg, params, total_updates=10)
    for p_ in params:  # one AdamW update, so that both moments exist
        p_.grad = torch.randn_like(p_) * 1e-3
    optimizer.step()
    optimizer.zero_grad()
    n_params = sum(p_.numel() for p_ in params)
    nbytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    nbytes += sum(t.numel() * t.element_size() for st in optimizer.adamw.state.values()
                  for t in st.values())
    built_s = time.perf_counter() - t_start

    def save(fn, run: str) -> tuple:
        """(seconds until ``fn`` returned, until the card had finished too)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(root / run, model.state_dict(), cfg, is_best=True,
           optimizer=optimizer.state_dict(), epoch=1, step=1)
        returned = time.perf_counter() - t0
        torch.cuda.synchronize()
        return returned, time.perf_counter() - t0

    sync_s, _ = save(save_checkpoint, "sync")
    writer = CheckpointWriter(async_saves=True)
    cold = save(writer.save, "async")  # allocates the pinned buffers
    t0 = time.perf_counter()
    writer.finalize()
    write_s = time.perf_counter() - t0

    model.eval()
    x = torch.randn(STALL_B, STALL_FRAMES, input_dim, device="cuda")
    lengths = torch.full((STALL_B,), STALL_FRAMES, device="cuda")

    def forwards(n: int) -> float:
        """Seconds for ``n`` forwards, the card's work included."""
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(n):
                model(x, lengths)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    forwards(3)  # warm
    n = max(5, int(write_s / 2 / (forwards(3) / 3)))  # about half the write's length
    alone_s = forwards(n)
    warm = save(writer.save, "async")  # the buffers reused
    during_s = forwards(n)
    t0 = time.perf_counter()
    writer.finalize()
    waited_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    got, want = load_checkpoint(root / "async" / "last"), load_checkpoint(root / "sync" / "last")
    bad = payload_differences(got, want)
    check(not bad, f"21b: the async last differs from the sync one at {bad[:3]}")
    compared_s = time.perf_counter() - t0
    print(f"[checkpoint] tpu_scaled_large 12 blocks ({n_params / 1e6:.2f} M parameters + AdamW "
          f"moments, {nbytes / 1e9:.3f} GB a file), last + best: save_checkpoint held the "
          f"training thread {sync_s:.3f} s; the async writer's save returned in {cold[0]:.3f} s "
          f"with its pinned buffers allocated ({cold[1]:.3f} s until its copies landed), "
          f"{warm[0]:.3f} s reusing them ({warm[1]:.3f} s); the write alone {write_s:.3f} s "
          f"(finalize); async last torch.equal to sync")
    print(f"[checkpoint] overlap: {n} bf16 forwards (B {STALL_B}, {STALL_FRAMES} frames, "
          f"fused/pallas, no grad) {alone_s * 1e3 / n:.3f} ms each alone, "
          f"{during_s * 1e3 / n:.3f} ms each while the write ran (x{during_s / alone_s:.3f}); "
          f"finalize then waited {waited_s:.3f} s for the rest of the write; {card}")
    del writer, model, optimizer, params, got, want
    for run in ("sync", "async"):
        shutil.rmtree(root / run)
    print(f"[checkpoint] 21b seconds: model and moments on the card {built_s:.2f}, the two "
          f"files loaded and compared {compared_s:.2f}, all {time.perf_counter() - t_start:.2f}")


def valid_gap(a: torch.Tensor, b: torch.Tensor, lengths: torch.Tensor) -> float:
    return max(float((a[i, :n] - b[i, :n]).abs().max()) for i, n in enumerate(lengths.tolist()))


def phase_convert(root: Path, rng: np.random.Generator, card: str) -> dict:
    """Phase 21: the layout converter on tpu_scaled_large (bf16, full depth)
    and tpu_fast_plus (fp32), each checkpoint served on the card.
    Returns the launches of its counted runs."""
    reqs = [rng.normal(size=(int(n), CHANNELS)).astype(np.float32)
            for n in rng.integers(9000, 12001, size=CONVERT_B)]
    large = load_config(LARGE_PATH)
    large = {"model": large["model"], "features": large["features"]}
    large["model"]["encoder"].update(FUSED)
    enc = large["model"]["encoder"]
    check(enc["num_layers"] == 12 and enc["compute_dtype"] == "bfloat16" and enc["scan_layers"],
          f"{LARGE_PATH.name}: expected 12 bf16 blocks under scan_layers")
    (scan, unrolled, back), lengths, launches = convert_round_trip(
        root / "large", large, enc["input_dim"], reqs, "tpu_scaled_large")
    check(torch.equal(back, scan), "tpu_scaled_large: the round trip's log-probs differ")
    gap = valid_gap(unrolled, scan, lengths)
    check(0 < gap < CONVERT_BF16_ATOL,
          f"tpu_scaled_large: unrolled vs scan log-prob gap {gap} not in (0, {CONVERT_BF16_ATOL})")
    print(f"[convert] tpu_scaled_large (12 blocks, bf16, fused/pallas, B {CONVERT_B}): round trip "
          f"torch.equal to the source; unrolled vs scan largest log-prob gap {gap:.6f} "
          f"(atol {CONVERT_BF16_ATOL}; log-probs in [{float(scan.min()):.3f}, "
          f"{float(scan.max()):.3f}]); {card}")

    fast = {"model": model_block(scan_layers=True, **FUSED),
            "features": shipped_config()["features"]}
    (scan, unrolled, back), _, fast_launches = convert_round_trip(
        root / "fast", fast, encoder_key("input_dim"), reqs, "tpu_fast_plus")
    check(torch.equal(unrolled, scan) and torch.equal(back, scan),
          "tpu_fast_plus (fp32): the three checkpoints' log-probs differ")
    print(f"[convert] tpu_fast_plus ({fast['model']['encoder']['num_layers']} blocks, fp32, "
          f"fused/pallas, B {CONVERT_B}): source, unrolled and round trip torch.equal")
    for k, v in fast_launches.items():
        launches[k] += v
    print(f"[convert] launches: { {k: v for k, v in launches.items() if v} }")
    checkpoint_stall(root / "stall", card)
    return launches


def parallel_only() -> int:
    """``chip_smoke.py --parallel-only``: the kernels' build, phase 18 and
    phase 19c alone (the corpora and checkpoint made as phases 7, 11 and 15
    make them), for a machine with several cards."""
    card = phase_build()
    rng = np.random.default_rng(SEED)
    root = Path(tempfile.mkdtemp(prefix="ssd_chip_smoke_parallel_"))
    cache_children_bytecode(root)
    try:
        t0 = time.perf_counter()
        train_dir = root / "train"
        train_dir.mkdir()
        make_corpus(train_dir, rng)
        ckpt = build_run_dir(root / "fused", **FUSED)
        multi = phase_multi(train_dir, ckpt, rng, card)
        print(f"[time] parallelism {time.perf_counter() - t0:.2f} s; launches {multi}")
        t0 = time.perf_counter()
        piped = pipe_multi(root / "pipe", rng, card)
        print(f"[time] pipeline over cards {time.perf_counter() - t0:.2f} s; launches {piped}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ranks = {"--rank-train": rank_train, "--rank-step": rank_step, "--rank-pipe": rank_pipe}
    if len(sys.argv) == 3 and sys.argv[1] in ranks:
        # a rank of phase 18 or 19, started by torch.distributed.run
        return ranks[sys.argv[1]](sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--parallel-only"]:
        return parallel_only()
    rng = np.random.default_rng(SEED)
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        print(f"[time] {name}: {seconds[name]:.2f} s")
        return out

    card = timed("build", phase_build)
    entry = timed("kernel", phase_kernel, rng)
    run_dir = Path(tempfile.mkdtemp(prefix="ssd_chip_smoke_"))
    cache_children_bytecode(run_dir)
    try:
        ckpt = build_run_dir(run_dir)
        engines, batches, launches = timed("engine+server", phase_main_path, ckpt, rng)
        entry["launches"] = launches["logmel"]
        timed("parity", phase_parity, ckpt, engines, batches)
        timed("latency", phase_latency, engines, rng)
        del engines
        ctc_out = timed("ctc kernels", phase_ctc, rng)
        train_dir = run_dir / "train"
        train_dir.mkdir()
        train_counts = timed("train", phase_train, train_dir, rng)
        timed("train parity", phase_train_parity, rng)
        timed("train rate", phase_train_rate, rng, ctc_out["times"])
        new_out = timed("attention+depthwise kernels", phase_attention_depthwise, rng)
        served = timed("fused serving", phase_fused_serving, run_dir / "fused", ckpt, rng)
        trained = timed("fused train", phase_fused_train, train_dir, rng)
        timed("reproducible training", phase_reproducible, train_dir)
        timed("fused train parity", phase_train_parity, rng, **FUSED)
        timed("fused train rate", phase_train_rate, rng, ctc_out["times"], new_out["times"], **FUSED)
        evaluated = timed("evaluate", phase_evaluate, train_dir, card)
        lm_served = timed("lm fusion", phase_lm, train_dir, run_dir / "fused" / "last", rng, card)
        streamed = timed("streaming+export", phase_stream_export, train_dir, rng, card)
        large = timed("tpu_scaled_large bf16", phase_large, run_dir / "large", rng, card)
        quantized = timed("quantized serving", phase_quant, run_dir / "quant", rng, card)
        prepared = timed("data preparation", phase_prepare, run_dir / "prep", rng, card)
        multi = timed("parallelism", phase_multi, train_dir, run_dir / "fused" / "last", rng,
                      card)
        piped = timed("workers+pipeline", phase_pipeline_workers, run_dir / "pipe", train_dir,
                      rng, card)
        swept = timed("experiment sweep", phase_sweep, run_dir / "sweep", train_dir, rng, card)
        converted = timed("layout conversion", phase_convert, run_dir / "convert", rng, card)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    entry["launches"] += (evaluated["logmel"] + lm_served["logmel"] + streamed["logmel"]
                          + quantized["logmel"] + prepared["logmel"] + multi["logmel"]
                          + piped["logmel"] + swept["logmel"] + converted["logmel"])
    kernels = [entry]
    for name in ("alpha", "beta"):
        e = ctc_out["entries"][name]
        e["launches"] = (train_counts[f"ctc_{name}"] + prepared[f"ctc_{name}"]
                         + multi[f"ctc_{name}"] + piped[f"ctc_{name}"])
        kernels.append(e)
    for name in ("attention_fwd", "attention_bwd", "depthwise_fwd", "depthwise_bwd"):
        e = new_out["entries"][name]
        # phase 11's two counted runs, phase 12's, 13's, 14's, 16's, 17's,
        # 18's (every rank of its distributed trainer), 19's, 20's
        # in-process evaluation (the sweep's children count their own) and 21's
        e["launches"] = (served[name] + trained[name] + evaluated[name] + lm_served[name]
                         + streamed[name] + quantized[name] + prepared[name] + multi[name]
                         + piped[name] + swept[name] + converted[name])
        check(e["launches"] > 0, f"{name} was never launched on the main path")
        kernels.append(e)
    check(quantized["int_mm"] > 0, "torch._int_mm was never launched on the quantized path")
    for name, e in large.items():
        e["launches"] += piped[name] + converted[name]  # phase 19b's pipelined and 21's bf16 runs
    kernels += list(large.values())
    print(f"[time] total {sum(seconds.values()):.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
