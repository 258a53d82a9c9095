"""Host-side dataset + bucketed static-shape batching (the port's own copy of
``ssd_tpu/data/dataset.py``).

* split/subset selection, transcript normalization with empty-row dropping
  at construction, strict vs lenient teacher loading;
* per item: cached EMG ``(T, C, M)`` flattened to ``(T, C·M)`` — or, in raw
  mode, the original ``(samples, channels)`` signal from the index's
  ``emg_path`` — optional teacher ``(T_t, D)``, tokenized transcript;
* length-bucketed, statically padded batches (``TIME_BUCKET``,
  ``TOKEN_BUCKET``, ``TEACHER_BUCKET``);
* deterministic per-epoch shuffles and per-batch augmentation RNG;
* ``teacher_dtype`` / ``emg_dtype`` ``"bfloat16"`` (``data.teacher_dtype``,
  ``data.emg_dtype``): the batch's teacher or cached EMG features as bf16,
  rounded to nearest even from fp32 as the JAX loader's ``ml_dtypes`` cast
  rounds, carried as uint16 bit patterns (:func:`bf16_bits`; the card has
  no ``ml_dtypes``) — half the host copy and host→device bytes.

Given the same index and seed, the batches equal the JAX loader's bit for
bit (``tests/test_torch_data.py``). With ``num_workers`` 0 the loader runs
in-process, fed to the step by the :func:`prefetch` thread. With
``num_workers > 0`` a pool of that many worker processes builds the batches
(the JAX loader's pool). The parent may hold a CUDA context, and CUDA is
not fork-safe, so the workers are never forked from it: the
``forkserver`` context forks them from a server process started fresh
(once per parent; it never touches CUDA). A worker needs only this module,
so the pool starts with the parent's ``__main__`` hidden
(:func:`_main_hidden`): otherwise each worker would import ``__main__``
again, as ``spawn`` does — a trainer's pulls in torch and every model, ~3 s
of CPU a worker on an 8-core H100 host. Each worker copies its batch into
a shared-memory slot (``data/shm_slots.py``) and the parent reads it as
zero-copy views. Batches arrive in order and equal the in-process loader's
bit for bit (the augmentation RNG is derived per (seed, epoch, batch));
at most ``num_workers + 2`` are in flight; an abandoned iteration recycles
its slots; ``close()`` during an iteration raises instead of hanging. The
module imports numpy only (``data/augment.py`` imports torch inside the
functions that use it), so a worker holds torch only where the parent's
``__main__`` imports it, never JAX, and never starts CUDA.

``num_shards`` / ``shard_index`` are the JAX loader's multi-host contract:
global batches of ``batch_size × num_shards`` rows cut from one seeded
permutation, each shard its contiguous ``batch_size`` rows padded to the
global batch's bucket shapes and to exactly ``batch_size`` rows, an empty
shard an all-padding batch — every shard steps the same number of times
with the same shapes. The trainer shards over nodes (``batch_size`` is per
host, as in the JAX package) and splits a node's batch over its ranks.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import sys
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ssd_tpu_torch.data.augment import (
    ChannelDropoutConfig,
    SpecAugmentConfig,
    channel_dropout_np,
    spec_augment_np,
)
from ssd_tpu_torch.data.index_dataset import load_index
from ssd_tpu_torch.data.text_normalizer import normalize_transcript
from ssd_tpu_torch.data.vocab import Vocab

logger = logging.getLogger(__name__)

TIME_BUCKET = 128
TOKEN_BUCKET = 32
TEACHER_BUCKET = 64


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """fp32 → bf16, as uint16 bit patterns: rounded to nearest, ties to even
    (``ml_dtypes``' cast, subnormals and overflow to ±inf included); a NaN
    becomes the quiet NaN ``sign | 0x7FC0``, as there."""
    x = np.ascontiguousarray(x, np.float32)
    bits = x.view(np.uint32)
    out = ((bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) >> 16).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        out[nan] = ((bits[nan] >> 16) & 0x8000) | 0x7FC0
    return out


def _transfer(x: np.ndarray, dtype: str) -> np.ndarray:
    """A collated fp32 array in the transfer dtype: itself, or its bf16 bits."""
    if dtype == "bfloat16":
        return bf16_bits(x)
    if dtype != "float32":
        raise ValueError(f"transfer dtype must be float32|bfloat16, got {dtype}")
    return x


@dataclass
class Batch:
    """One padded batch; all arrays numpy, ready to feed the device."""

    utterance_ids: List[str]
    transcripts: List[str]
    emg: np.ndarray  # (B, T, C·M) float32 (or bf16 bits), or raw (B, samples, C)
    emg_lengths: np.ndarray  # (B,) int32
    tokens: np.ndarray  # (B, S) int32
    token_lengths: np.ndarray  # (B,) int32
    teacher: Optional[np.ndarray]  # (B, T_t, D) float32 (or bf16 bits) | None
    teacher_lengths: Optional[np.ndarray]  # (B,) int32 | None

    @property
    def size(self) -> int:
        return len(self.utterance_ids)


class EMGFeatureDataset:
    """Loads cached EMG/teacher features + tokenized transcripts."""

    def __init__(
        self,
        index_path: Path,
        features_root: Path,
        splits: Sequence[str],
        vocab: Vocab,
        subsets: Optional[Sequence[str]] = None,
        include_teacher: bool = True,
        strict: bool = True,
        channel_dropout_cfg: Optional[ChannelDropoutConfig] = None,
        raw: bool = False,
    ) -> None:
        rows = [r for r in load_index(Path(index_path)) if r["split"] in set(splits)]
        if subsets:
            if any("subset" not in r for r in rows):
                raise KeyError("Index missing 'subset' column; re-run indexing.")
            rows = [r for r in rows if r["subset"] in set(subsets)]
        for r in rows:
            r["transcript_norm"] = normalize_transcript(r["transcript"])
        self._rows = [r for r in rows if r["transcript_norm"]]
        self.features_root = Path(features_root)
        self.vocab = vocab
        self.include_teacher = include_teacher
        self.strict = strict
        self.raw = raw
        self.channel_dropout_cfg = channel_dropout_cfg or ChannelDropoutConfig()
        self._lengths_cache: Dict[int, int] = {}
        self._teacher_lengths_cache: Dict[int, int] = {}
        self._token_lengths_cache: Dict[int, int] = {}
        self._teacher_dim: Optional[int] = None

    def __len__(self) -> int:
        return len(self._rows)

    # ------------------------------------------------------------ loading
    def _emg_path(self, utterance_id: str) -> Path:
        return self.features_root / "emg" / f"{utterance_id}.npy"

    def _teacher_path(self, utterance_id: str) -> Path:
        return self.features_root / "teacher" / f"{utterance_id}.npy"

    def feature_length(self, idx: int) -> int:
        """Time length of item ``idx`` — feature frames, or raw samples in
        raw mode (mmap header read only; cached)."""
        if idx not in self._lengths_cache:
            row = self._rows[idx]
            path = Path(row["emg_path"]) if self.raw else self._emg_path(row["utterance_id"])
            if not path.exists():
                raise FileNotFoundError(path)
            self._lengths_cache[idx] = int(np.load(path, mmap_mode="r").shape[0])
        return self._lengths_cache[idx]

    def teacher_length(self, idx: int) -> int:
        """Teacher frame count of item ``idx`` (0 when absent; header only)."""
        if idx not in self._teacher_lengths_cache:
            path = self._teacher_path(self._rows[idx]["utterance_id"])
            if not path.exists():
                self._teacher_lengths_cache[idx] = 0
            else:
                arr = np.load(path, mmap_mode="r")
                self._teacher_lengths_cache[idx] = int(arr.shape[0])
                self._teacher_dim = int(arr.shape[1])
        return self._teacher_lengths_cache[idx]

    def teacher_dim(self) -> Optional[int]:
        """Teacher feature dim, from the first existing teacher file."""
        if self._teacher_dim is None:
            for i in range(len(self._rows)):
                if self.teacher_length(i) > 0:
                    break
        return self._teacher_dim

    def token_length(self, idx: int) -> int:
        if idx not in self._token_lengths_cache:
            transcript = self._rows[idx]["transcript_norm"]
            self._token_lengths_cache[idx] = len(self.vocab.encode(transcript))
        return self._token_lengths_cache[idx]

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        row = self._rows[idx]
        uid = row["utterance_id"]
        if self.raw:
            path = Path(row["emg_path"])
            if not path.exists():
                raise FileNotFoundError(path)
            # (samples, channels) — augmentation happens on device in raw mode
            emg = np.load(path, mmap_mode="r").astype(np.float32, copy=False)
        else:
            path = self._emg_path(uid)
            if not path.exists():
                raise FileNotFoundError(path)
            feat = np.load(path, mmap_mode="r").astype(np.float32, copy=False)
            if rng is not None:
                feat = channel_dropout_np(feat, self.channel_dropout_cfg, rng)
            t, c, m = feat.shape
            emg = feat.reshape(t, c * m)

        teacher = None
        if self.include_teacher:
            tp = self._teacher_path(uid)
            if tp.exists():
                teacher = np.load(tp, mmap_mode="r").astype(np.float32, copy=False)
            elif self.strict:
                raise FileNotFoundError(tp)

        transcript = row["transcript_norm"]
        tokens = np.asarray(self.vocab.encode(transcript), dtype=np.int32)
        return {
            "utterance_id": uid,
            "transcript": transcript,
            "emg": emg,
            "teacher": teacher,
            "tokens": tokens,
        }


def collate(
    items: List[Dict],
    vocab: Vocab,
    spec_augment_cfg: Optional[SpecAugmentConfig] = None,
    rng: Optional[np.random.Generator] = None,
    time_bucket: int = TIME_BUCKET,
    teacher_dtype: str = "float32",
    emg_dtype: str = "float32",
    pad_time_to: Optional[int] = None,
    pad_tokens_to: Optional[int] = None,
    pad_teacher_to: Optional[int] = None,
    pad_rows_to: Optional[int] = None,
    teacher_dim: Optional[int] = None,
) -> Batch:
    """Right-pad items to bucket-rounded static shapes; EMG and teacher in
    their transfer dtypes (``"bfloat16"``: uint16 bit patterns).

    The ``pad_*_to`` targets force larger paddings (a shard takes its
    global batch's shapes); ``pad_rows_to`` appends all-zero rows of length
    0; ``pad_teacher_to`` + ``teacher_dim`` make the teacher arrays exist
    when no item carries teacher features."""
    emg_lengths = np.asarray([it["emg"].shape[0] for it in items], np.int32)
    token_lengths = np.asarray([len(it["tokens"]) for it in items], np.int32)
    T = max(_round_up(int(emg_lengths.max()), time_bucket), pad_time_to or 0)
    S = max(_round_up(int(token_lengths.max()), TOKEN_BUCKET), pad_tokens_to or 0)
    F = items[0]["emg"].shape[1]
    B = max(len(items), pad_rows_to or 0)

    emg = np.zeros((B, T, F), np.float32)
    tokens = np.full((B, S), vocab.pad_id, np.int32)
    for i, it in enumerate(items):
        x = it["emg"]
        if spec_augment_cfg is not None and rng is not None:
            x = spec_augment_np(x, spec_augment_cfg, rng)
        emg[i, : x.shape[0]] = x
        tokens[i, : len(it["tokens"])] = it["tokens"]
    if B > len(items):
        emg_lengths = np.pad(emg_lengths, (0, B - len(items)))
        token_lengths = np.pad(token_lengths, (0, B - len(items)))

    teacher = None
    teacher_lengths = None
    if any(it["teacher"] is not None for it in items) or pad_teacher_to:
        t_lens = np.asarray(
            [0 if it["teacher"] is None else it["teacher"].shape[0] for it in items], np.int32
        )
        Tt = max(_round_up(int(t_lens.max()), TEACHER_BUCKET), pad_teacher_to or 0)
        D = next((it["teacher"].shape[1] for it in items if it["teacher"] is not None),
                 teacher_dim)
        teacher = np.zeros((B, Tt, D), np.float32)
        for i, it in enumerate(items):
            if it["teacher"] is not None:
                teacher[i, : it["teacher"].shape[0]] = it["teacher"]
        teacher_lengths = np.pad(t_lens, (0, B - len(t_lens)))

    return Batch(
        utterance_ids=[it["utterance_id"] for it in items],
        transcripts=[it["transcript"] for it in items],
        emg=_transfer(emg, emg_dtype),
        emg_lengths=emg_lengths,
        tokens=tokens,
        token_lengths=token_lengths,
        teacher=None if teacher is None else _transfer(teacher, teacher_dtype),
        teacher_lengths=teacher_lengths,
    )


class DataLoader:
    """Bucketed batch iterator over an :class:`EMGFeatureDataset`.

    Each epoch, items are shuffled, stably sorted by bucketed length, cut
    into batches, and the batch order shuffled again — randomness with
    near-uniform batch shapes. Without shuffling (eval), items keep index
    order and batches are cut sequentially. ``num_workers > 0`` builds the
    batches in that many worker processes (module docstring); call
    :meth:`close` to stop them (garbage collection does too).
    """

    def __init__(
        self,
        dataset: EMGFeatureDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        spec_augment_cfg: Optional[SpecAugmentConfig] = None,
        max_items: Optional[int] = None,
        time_bucket: int = TIME_BUCKET,
        teacher_dtype: str = "float32",
        emg_dtype: str = "float32",
        num_shards: int = 1,
        shard_index: int = 0,
        num_workers: int = 0,
    ) -> None:
        self.dataset = dataset
        self.num_shards = int(num_shards)
        self.shard_index = int(shard_index)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.spec_augment_cfg = spec_augment_cfg
        # time-axis padding granularity: feature frames normally, raw samples
        # (frames × hop) when the dataset is in raw mode
        self.time_bucket = time_bucket
        self.teacher_dtype = teacher_dtype
        self.emg_dtype = emg_dtype
        self.num_workers = int(num_workers)
        self._pool = None
        self._slots = None  # the shared-memory transport, made with the pool
        self.epoch = 0
        indices = list(range(len(dataset)))
        if max_items is not None:
            indices = indices[: min(max_items, len(indices))]
        self._indices = indices

    def __len__(self) -> int:
        bg = self.batch_size * self.num_shards
        return (len(self._indices) + bg - 1) // bg

    def _epoch_batches(self, rng: np.random.Generator) -> List[List[int]]:
        """Global batch index lists, the same in every shard (same seed)."""
        indices = list(self._indices)
        if self.shuffle:
            rng.shuffle(indices)
            # stable sort by bucketed length keeps shuffle randomness within
            # equal-bucket groups while minimizing padding waste
            indices.sort(key=lambda i: _round_up(self.dataset.feature_length(i), self.time_bucket))
        bs = self.batch_size * self.num_shards
        batches = [indices[i : i + bs] for i in range(0, len(indices), bs)]
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def _batch_rng(self, epoch: int, batch_idx: int) -> np.random.Generator:
        """Per-batch augmentation RNG, derived from (seed, epoch, batch index)
        rather than drawn from one sequential stream: a batch's augmentation
        does not depend on how many draws earlier batches consumed."""
        return np.random.default_rng((self.seed, epoch, batch_idx))

    def _shard_pad_kwargs(self, global_batch: List[int]) -> Dict:
        """Bucket shapes of the global batch, which every shard pads to."""
        ds = self.dataset
        kwargs: Dict = dict(
            pad_time_to=_round_up(max(ds.feature_length(i) for i in global_batch),
                                  self.time_bucket),
            pad_tokens_to=_round_up(max(ds.token_length(i) for i in global_batch), TOKEN_BUCKET),
            pad_rows_to=self.batch_size,
        )
        if ds.include_teacher:
            tt_max = max(ds.teacher_length(i) for i in global_batch)
            if tt_max > 0:
                kwargs["pad_teacher_to"] = _round_up(tt_max, TEACHER_BUCKET)
                kwargs["teacher_dim"] = ds.teacher_dim()
        return kwargs

    def _build_batch(self, epoch: int, batch_idx: int, global_batch: List[int]) -> Batch:
        """This shard's padded batch of one global batch."""
        rng = self._batch_rng(epoch, batch_idx) if self.shuffle else None
        pad_kwargs: Dict = {}
        batch_indices = global_batch
        if self.num_shards > 1:
            lo = self.shard_index * self.batch_size
            batch_indices = global_batch[lo : lo + self.batch_size]
            pad_kwargs = self._shard_pad_kwargs(global_batch)
        common = dict(time_bucket=self.time_bucket, teacher_dtype=self.teacher_dtype,
                      emg_dtype=self.emg_dtype, **pad_kwargs)
        if batch_indices:
            items = [self.dataset.get(i, rng) for i in batch_indices]
            return collate(
                items,
                self.dataset.vocab,
                spec_augment_cfg=self.spec_augment_cfg if self.shuffle else None,
                rng=rng,
                **common,
            )
        # a small last global batch can leave this shard empty: it still
        # steps, with a batch of padding
        batch = collate([self.dataset.get(global_batch[0])], self.dataset.vocab, **common)
        batch.emg[:] = 0
        batch.emg_lengths[:] = 0
        batch.tokens[:] = self.dataset.vocab.pad_id
        batch.token_lengths[:] = 0
        if batch.teacher is not None:
            batch.teacher[:] = 0
            batch.teacher_lengths[:] = 0
        batch.utterance_ids = []
        batch.transcripts = []
        return batch

    # --------------------------------------------------- worker processes
    def __getstate__(self):
        d = self.__dict__.copy()
        d["_pool"] = None  # a pool does not pickle; workers start no pool
        d["_slots"] = None  # the parent's maps; workers get the slot paths
        return d

    def _ensure_pool(self):
        if self._pool is None:
            import multiprocessing as mp

            from ssd_tpu_torch.data.shm_slots import SlotPool

            # the in-flight bound (num_workers + 2, _iter_workers) and room
            # for yielded batches the consumer still holds (the prefetch
            # queue, the step's batch)
            self._slots = SlotPool(self.num_workers + 6)
            with _main_hidden():
                self._pool = mp.get_context("forkserver").Pool(
                    self.num_workers, initializer=_worker_init,
                    initargs=(self, self._slots.paths))
        return self._pool

    def close(self) -> None:
        """Stop the worker processes and remove the slots (idempotent)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        if self._slots is not None:
            self._slots.close()
            self._slots = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def _await(self, async_result):
        """``AsyncResult.get`` that raises, instead of blocking for ever, once
        :meth:`close` has terminated the pool."""
        import multiprocessing as mp

        while True:
            try:
                return async_result.get(0.5)
            except mp.TimeoutError:
                if self._pool is None:
                    raise RuntimeError("DataLoader.close() was called during iteration") from None

    def _iter_workers(self, epoch: int, batches: List[List[int]]) -> Iterator[Batch]:
        """The epoch's batches from the pool, in order, at most
        ``num_workers + 2`` in flight. Submitting waits for a free slot, so
        the workers run ahead of the consumer by the slots it has let go.
        An abandoned iteration waits out its submitted builds and recycles
        their slots."""
        from collections import deque

        pool = self._ensure_pool()
        slots = self._slots  # close() drops the loader's reference, not this one
        pending: "deque" = deque()  # (slot, AsyncResult)
        try:
            for bi, global_batch in enumerate(batches):
                slot = slots.acquire()
                pending.append((slot, pool.apply_async(
                    _worker_build, ((epoch, bi, global_batch), slot))))
                if len(pending) < self.num_workers + 2:
                    continue
                yield self._open_result(slots, self._await(pending.popleft()[1]))
            while pending:
                yield self._open_result(slots, self._await(pending.popleft()[1]))
        finally:
            while pending:
                slot, result = pending.popleft()
                try:
                    self._await(result)
                except RuntimeError:  # close() during the teardown
                    pass
                slots.release(slot)

    @staticmethod
    def _open_result(slots, result) -> Batch:
        """A worker's (descriptor, metadata) as a Batch of views of its slot."""
        desc, meta = result
        arrays = slots.open_batch(desc)
        return Batch(
            utterance_ids=meta["utterance_ids"],
            transcripts=meta["transcripts"],
            emg=arrays["emg"],
            emg_lengths=arrays["emg_lengths"],
            tokens=arrays["tokens"],
            token_lengths=arrays["token_lengths"],
            teacher=arrays.get("teacher"),
            teacher_lengths=arrays.get("teacher_lengths"),
        )

    def __iter__(self) -> Iterator[Batch]:
        epoch = self.epoch
        self.epoch += 1
        rng = np.random.default_rng((self.seed, epoch))
        batches = self._epoch_batches(rng)
        if self.num_workers > 0:
            yield from self._iter_workers(epoch, batches)
            return
        for bi, batch_indices in enumerate(batches):
            yield self._build_batch(epoch, bi, batch_indices)


@contextlib.contextmanager
def _main_hidden():
    """While processes start: ``__main__`` without the ``__spec__`` and
    ``__file__`` that ``multiprocessing`` reads to import it again in each
    child (the fork server's own preload of it never takes effect on
    Python 3.12: it looks for a ``main_path`` key its preparation data does
    not have)."""
    main = sys.modules.get("__main__")
    if main is None:
        yield
        return
    spec, file = getattr(main, "__spec__", None), main.__dict__.pop("__file__", None)
    main.__spec__ = None
    try:
        yield
    finally:
        main.__spec__ = spec
        if file is not None:
            main.__file__ = file


# A worker's state: its own copy of the loader (unpickled from the
# parent's, without the pool) and the slot writer. A task is
# ((epoch, batch index, global batch), slot); its result the slot's
# descriptor and the batch's strings: the arrays go through the slot.
_WORKER_LOADER: Optional[DataLoader] = None
_WORKER_SLOTS = None


def _worker_init(loader: DataLoader, slot_paths) -> None:
    global _WORKER_LOADER, _WORKER_SLOTS
    from ssd_tpu_torch.data.shm_slots import SlotWriter

    _WORKER_LOADER = loader
    _WORKER_SLOTS = SlotWriter(slot_paths)


def _worker_build(task, slot: int):
    epoch, batch_idx, global_batch = task
    batch = _WORKER_LOADER._build_batch(epoch, batch_idx, global_batch)
    arrays = {
        "emg": batch.emg,
        "emg_lengths": batch.emg_lengths,
        "tokens": batch.tokens,
        "token_lengths": batch.token_lengths,
    }
    if batch.teacher is not None:
        arrays["teacher"] = batch.teacher
        arrays["teacher_lengths"] = batch.teacher_lengths
    desc = _WORKER_SLOTS.write(slot, arrays)
    return desc, {"utterance_ids": batch.utterance_ids, "transcripts": batch.transcripts}


def prefetch(loader: DataLoader, size: int = 2) -> Iterator[Batch]:
    """Background-thread prefetch: the next batches load while the device
    steps. Closing or abandoning the returned generator stops the producer
    thread instead of leaving it blocked on the bounded queue."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for batch in loader:
                if not _put(batch):
                    return
        except BaseException as e:  # handed to the consumer, re-raised there
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def make_dataloader(
    index_path: Path,
    features_root: Path,
    splits: Sequence[str],
    subsets: Optional[Sequence[str]],
    vocab: Vocab,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    spec_augment_cfg: Optional[SpecAugmentConfig] = None,
    include_teacher: bool = True,
    strict: bool = True,
    max_items: Optional[int] = None,
    channel_dropout_cfg: Optional[ChannelDropoutConfig] = None,
    raw: bool = False,
    raw_hop_length: int = 10,
    teacher_dtype: str = "float32",
    emg_dtype: str = "float32",
    num_shards: int = 1,
    shard_index: int = 0,
    num_workers: int = 0,
) -> DataLoader:
    """Factory with the JAX package's surface (``dataset.py:make_dataloader``).

    ``raw=True`` loads the ORIGINAL (samples, channels) EMG from the index's
    ``emg_path``; featurization then happens on device inside the train
    step, so host augmentation is refused in this mode.
    """
    if raw and (spec_augment_cfg is not None or channel_dropout_cfg is not None):
        raise ValueError(
            "raw mode featurizes on device; host augmentation configs must be "
            "moved on device (augmentation.on_device: true)"
        )
    if raw and emg_dtype != "float32":
        raise ValueError(
            "emg_dtype applies to cached features only: the on-device "
            "featurizer needs float32 raw samples for librosa parity"
        )
    dataset = EMGFeatureDataset(
        index_path=index_path,
        features_root=features_root,
        splits=splits,
        vocab=vocab,
        subsets=subsets,
        include_teacher=include_teacher,
        strict=strict,
        channel_dropout_cfg=channel_dropout_cfg,
        raw=raw,
    )
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=shuffle,
        seed=seed,
        spec_augment_cfg=spec_augment_cfg,
        max_items=max_items,
        # same frame granularity as feature mode, expressed in samples
        time_bucket=TIME_BUCKET * raw_hop_length if raw else TIME_BUCKET,
        teacher_dtype=teacher_dtype,
        emg_dtype=emg_dtype,
        num_shards=num_shards,
        shard_index=shard_index,
        num_workers=num_workers,
    )
