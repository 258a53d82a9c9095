"""LM-fused CTC prefix beam search on the tensors' device (PyTorch port of
``ssd_tpu/decoding/device_lm.py``, same semantics and the same packed table).

* The backoff n-gram LM is packed into a bucketized **open-addressing hash
  table** (two independent 32-bit key streams ≈ one 64-bit key; each key's
  bucket of ``_BUCKET`` slots is one row, fetched by one gather).
* Every beam carries its **word-history hashes** beside its prefix hashes:
  rolling char hashes of the partial word, rolling word-sequence hashes of
  the last 1..order−1 completed words.
* When a beam proposes a space, the completed word is scored with the
  standard backoff recursion (longest context first, accumulated backoff
  penalties, ``<unk>`` substitution), a statically unrolled walk over one
  batch of table lookups, vectorized over (batch, beam).
* Fusion follows pyctcdecode / :mod:`ssd_tpu_torch.decoding.host_beam`: the
  fused score ``α·ln10·log10 P + β`` is added to the beam's ranking and
  pruning score (not its acoustic mass), and the trailing partial word is
  scored once after the last frame.

Hashes. A 32-bit hash is an int64 tensor in [0, 2³²) wherever it is
computed and carried (the JAX package's ``uint32`` with wraparound): each
product is masked to 32 bits, and a multiplier ≥ 2³¹ is applied in two
16-bit halves (:func:`_mul32`), so no product leaves int64. The table holds
the same bits as int32 rows; a query key becomes int32 only where it is
compared with them (:func:`_as_i32`).

The search is one Python loop over frames of tensor ops with static shapes;
nothing in it waits for the device, so it can be captured in a CUDA graph.
Only :func:`beam_decode_lm_device` copies the backpointers to the host.

The host half (hashing, packing and the ``<arpa>.packed.npz`` sidecar) is
numpy and writes and reads the JAX package's sidecar format: an LM packed by
either package loads in the other.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ssd_tpu_torch.data.vocab import Vocab
from ssd_tpu_torch.decoding.lm import UNK, NGramLM
from ssd_tpu_torch.ops.ctc_decode import (NEG_INF, _run_logsumexp, frame_candidates, merge_key,
                                          top_k, traceback)

logger = logging.getLogger(__name__)

LN10 = math.log(10.0)
_MASK32 = 0xFFFFFFFF

# char-stream multipliers (same family as the prefix hashes) and
# word-sequence-stream multipliers — two independent 32-bit streams
_W1 = np.uint32(1000003)
_W2 = np.uint32(65599)
_S1 = np.uint32(2654435761)
_S2 = np.uint32(334214467)
_PHI = np.uint32(0x9E3779B9)

# reserved word hashes for special LM tokens (never produced by char rolling)
_UNK_H = (np.uint32(0xFFFF1234), np.uint32(0xFFFF5678))
_BOS_H = (np.uint32(0xFFFFB050), np.uint32(0xFFFFB051))
_EOS_H = (np.uint32(0xFFFFE050), np.uint32(0xFFFFE051))

# Bucketized open addressing: each hash maps to ONE bucket of `_BUCKET`
# contiguous slots, fetched as a single 128-byte row, so a key costs one
# gather offset. The packer keeps load ≤ 1 entry/bucket on average and
# doubles the bucket count when any bucket overflows.
_BUCKET = 8  # slots per bucket


@dataclass(frozen=True)
class DeviceLMTable:
    """Hashed n-gram table as flat host arrays (numpy); moved to a device
    once per device by :func:`_packed_device_table`.

    Flat slot ``j`` lives in bucket ``j // _BUCKET``; ``size`` is the total
    slot count (``nbuckets · _BUCKET``, nbuckets a power of two).
    """

    keys1: np.ndarray  # (size,) uint32
    keys2: np.ndarray  # (size,) uint32
    used: np.ndarray  # (size,) bool
    logprob: np.ndarray  # (size,) float32, log10
    backoff: np.ndarray  # (size,) float32, log10 (0 when absent)
    order: int
    size: int
    # Does any n-gram of order ≥ 2 END in <unk>? KN/lmplz LMs carry <unk>
    # only as a unigram, in which case the scorer drops the speculative
    # <unk>-substituted n-gram keys from the backoff walk (L: 3·order−1 →
    # 2·order−1 lookups) — see _score_word.
    unk_tailed: bool = True
    unk_uni_lp: Optional[float] = None  # log10 P(<unk>), None when absent


# --------------------------------------------------------------------------
# Host side: hashing and packing (numpy uint32, the JAX package's arithmetic)
# --------------------------------------------------------------------------


def _word_hash(word: str, vocab: Vocab) -> Tuple[np.uint32, np.uint32]:
    if word == UNK:
        return _UNK_H
    if word == "<s>":
        return _BOS_H
    if word == "</s>":
        return _EOS_H
    with np.errstate(over="ignore"):  # uint32 wraparound is the hash
        h1 = np.uint32(0)
        h2 = np.uint32(0)
        for cid in vocab.encode(word):
            h1 = h1 * _W1 + np.uint32(cid + 1)
            h2 = h2 * _W2 + np.uint32(cid + 1)
    return h1, h2


def _seq_hash(word_hashes) -> Tuple[np.uint32, np.uint32]:
    with np.errstate(over="ignore"):
        k1 = np.uint32(0)
        k2 = np.uint32(0)
        for h1, h2 in word_hashes:
            k1 = k1 * _S1 + h1
            k2 = k2 * _S2 + h2
    return k1, k2


def pack_lm(lm: NGramLM, vocab: Vocab) -> DeviceLMTable:
    """Pack an :class:`NGramLM` into the hash table."""
    unk_tailed = any(len(ng) >= 2 and ng[-1] == UNK for ng in lm.logprob)
    unk_uni_lp = lm.logprob.get((UNK,))
    entries = []
    for ngram, lp in lm.logprob.items():
        k1, k2 = _seq_hash([_word_hash(w, vocab) for w in ngram])
        bo = lm.backoff.get(ngram, 0.0)
        entries.append((np.uint32(k1), np.uint32(k2), np.float32(lp), np.float32(bo)))

    nbuckets = 1
    while nbuckets < max(len(entries), 1):  # load factor ≤ 1 entry/bucket
        nbuckets *= 2
    while True:
        size = nbuckets * _BUCKET
        keys1 = np.zeros((size,), np.uint32)
        keys2 = np.zeros((size,), np.uint32)
        used = np.zeros((size,), bool)
        lp_t = np.zeros((size,), np.float32)
        bo_t = np.zeros((size,), np.float32)
        ok = True
        for k1, k2, lp, bo in entries:
            with np.errstate(over="ignore"):
                bidx = int((k1 ^ np.uint32(k2 * _PHI)) & np.uint32(nbuckets - 1))
            for p in range(_BUCKET):
                j = bidx * _BUCKET + p
                if not used[j]:
                    keys1[j], keys2[j], used[j] = k1, k2, True
                    lp_t[j], bo_t[j] = lp, bo
                    break
                if keys1[j] == k1 and keys2[j] == k2:
                    break  # duplicate n-gram (hash collision in source): keep first
            else:
                ok = False  # bucket overflow: double the bucket count
                break
        if ok:
            return DeviceLMTable(
                keys1=keys1, keys2=keys2, used=used, logprob=lp_t, backoff=bo_t,
                order=lm.order, size=size,
                unk_tailed=unk_tailed, unk_uni_lp=unk_uni_lp,
            )
        nbuckets *= 2


# ----------------------------------------------------------- packed cache
_PACK_FORMAT = 2  # the JAX package's format number: the two share sidecars


def _vocab_digest(vocab: Vocab) -> str:
    return hashlib.md5(json.dumps(list(vocab.tokens)).encode()).hexdigest()


def load_packed_lm(path, vocab: Vocab) -> DeviceLMTable:
    """ARPA → :class:`DeviceLMTable`, with a sidecar ``.packed.npz`` cache.

    Parsing + hashing + bucket packing is host work that scales with the LM;
    the packed table is five flat arrays, so serving / eval cold starts pay
    it once per (file, vocab, format) and then ``np.load`` in milliseconds.
    Staleness is keyed on the ARPA's size + mtime and the vocab digest; a
    write failure (read-only model dir) degrades to pack-every-time with a
    warning. The file is the JAX package's: either package reads the
    other's.
    """
    path = Path(path)
    cache_path = path.with_name(path.name + ".packed.npz")
    stat = path.stat()
    meta = np.asarray([_PACK_FORMAT, int(_BUCKET), stat.st_size, stat.st_mtime_ns], np.int64)
    digest = _vocab_digest(vocab)
    if cache_path.exists():
        try:
            z = np.load(cache_path, allow_pickle=False)
            if np.array_equal(z["meta"], meta) and str(z["vocab_digest"]) == digest:
                unk_uni = float(z["unk_uni_lp"])
                return DeviceLMTable(
                    keys1=z["keys1"], keys2=z["keys2"], used=z["used"],
                    logprob=z["logprob"], backoff=z["backoff"],
                    order=int(z["order"]), size=int(z["size"]),
                    unk_tailed=bool(z["unk_tailed"]),
                    unk_uni_lp=None if np.isnan(unk_uni) else unk_uni,
                )
            logger.info("stale packed-LM cache %s — repacking", cache_path)
        except Exception as exc:  # corrupt cache: repack
            logger.warning("unreadable packed-LM cache %s (%s) — repacking", cache_path, exc)
    table = pack_lm(NGramLM.from_arpa(path), vocab)
    try:
        # tmp + atomic rename: concurrent cold starts or a kill
        # mid-write never leave a torn cache
        fd, tmp = tempfile.mkstemp(dir=str(cache_path.parent), suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    meta=meta, vocab_digest=np.asarray(digest),
                    keys1=table.keys1, keys2=table.keys2, used=table.used,
                    logprob=table.logprob, backoff=table.backoff,
                    order=np.asarray(table.order),
                    size=np.asarray(table.size),
                    unk_tailed=np.asarray(table.unk_tailed),
                    unk_uni_lp=np.asarray(
                        np.nan if table.unk_uni_lp is None else table.unk_uni_lp,
                        np.float64,
                    ),
                )
            os.replace(tmp, cache_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError as exc:
        logger.warning("cannot write packed-LM cache %s (%s)", cache_path, exc)
    return table


# --------------------------------------------------------------------------
# Device side: the table, its lookups and the backoff walk
# --------------------------------------------------------------------------

_EMPTY_SENTINEL = np.uint32(0xFFFFFFFF)  # key pair of unused slots

# (rows (nbuckets, _BUCKET·4) int32, nbuckets) on one device
PackedTable = Tuple[torch.Tensor, int]


def _packed_device_table(table: DeviceLMTable, device) -> PackedTable:
    """The table as ``(rows, nbuckets)`` on ``device``, cached per device.

    Each bucket row holds its ``_BUCKET`` slots slot-major as ``[k1, k2,
    lp_bits, bo_bits] × _BUCKET`` — the JAX package's uint32 rows, as int32
    bits; the float32 values are bit-cast in — so ONE gather fetches a key's
    whole probe set. Unused slots get a sentinel key pair that never equals a
    real key (the same ~2⁻⁶⁴ collision class as the two-stream hashes), which
    removes the separate ``used`` check. The copy is cached on the (frozen)
    table instance, keyed by device, so repeated decode calls reuse it.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cache: Dict[torch.device, PackedTable] = table.__dict__.get("_packed_device")
    if cache is None:
        cache = {}
        object.__setattr__(table, "_packed_device", cache)
    if device not in cache:
        slots = np.empty((table.size, 4), np.uint32)
        slots[:, 0] = table.keys1
        slots[:, 1] = table.keys2
        slots[~table.used, :2] = _EMPTY_SENTINEL
        slots[:, 2] = table.logprob.astype(np.float32).view(np.uint32)
        slots[:, 3] = table.backoff.astype(np.float32).view(np.uint32)
        nbuckets = table.size // _BUCKET
        rows = torch.from_numpy(slots.view(np.int32).reshape(nbuckets, _BUCKET * 4).copy())
        cache[device] = (rows.to(device), nbuckets)
    return cache[device]


def _mul32(h: torch.Tensor, m) -> torch.Tensor:
    """``h · m mod 2³²`` for ``h`` in [0, 2³²): a multiplier below 2³¹ keeps
    the product under 2⁶³; a larger one is applied in 16-bit halves, each
    product under 2⁴⁸."""
    m = int(m)
    if m < 1 << 31:
        return (h * m) & _MASK32
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK32


def _as_i32(k: torch.Tensor) -> torch.Tensor:
    """A hash in [0, 2³²) as the int32 of the same bits (the table's)."""
    return (k - ((k >> 31) << 32)).to(torch.int32)


def _lookup(table: PackedTable, k1: torch.Tensor, k2: torch.Tensor):
    """Bucketized hash probe over a trailing lookup axis.

    ``k1/k2``: (..., L) int64 hashes in [0, 2³²). Returns ``(hit, logprob,
    backoff)``, each (..., L): ALL keys' buckets come from ONE gather of
    (..., L, _BUCKET·4) rows; the first matching slot wins; a miss reads 0.
    """
    rows_t, nbuckets = table
    bidx = (k1 ^ _mul32(k2, _PHI)) & (nbuckets - 1)  # (..., L)
    rows = rows_t[bidx]  # (..., L, _BUCKET·4): the single gather
    slots = rows.reshape(rows.shape[:-1] + (_BUCKET, 4))
    hit_p = (slots[..., 0] == _as_i32(k1)[..., None]) & (slots[..., 1] == _as_i32(k2)[..., None])
    first = torch.argmax(hit_p.to(torch.int32), dim=-1, keepdim=True)  # first matching slot
    lp = slots[..., 2].gather(-1, first)[..., 0].view(torch.float32)
    bo = slots[..., 3].gather(-1, first)[..., 0].view(torch.float32)
    found = hit_p.any(dim=-1)
    return found, torch.where(found, lp, 0.0), torch.where(found, bo, 0.0)


def _score_word(table: PackedTable, order: int, cx1, cx2, nw, w1, w2,
                unk_tailed: bool = True, unk_uni: Optional[float] = None) -> torch.Tensor:
    """Backoff recursion, vectorized: log10 P(word | last ``nw`` words).

    ``cx1/cx2``: (..., order−1) rolling hashes of the last j+1 words at slot
    j. Mirrors ``NGramLM.score_word``: longest context first, accumulate the
    skipped contexts' backoffs, ``<unk>`` substitution when the word's
    unigram is absent, −99 when even that misses. One table lookup batch per
    call: the real word's n-gram keys, (``unk_tailed``) the speculative
    ``<unk>``-substituted ones, and the context-backoff keys.

    ``unk_tailed=False`` (static; detected at pack time — KN/lmplz LMs carry
    ``<unk>`` only as a unigram) drops the ``<unk>`` n-gram keys: they can
    never hit, so the OOV fallback is "sum of the valid context backoffs +
    the <unk> unigram" (``unk_uni``, log10; None → −99).
    """
    O = order - 1
    c1s = [cx1[..., j - 1] for j in range(O, 0, -1)]
    c2s = [cx2[..., j - 1] for j in range(O, 0, -1)]
    kmax = torch.clamp(nw, max=O)
    found = torch.zeros(w1.shape, dtype=torch.bool, device=w1.device)
    score = torch.full(w1.shape, -99.0, dtype=torch.float32, device=w1.device)
    penalty = torch.zeros(w1.shape, dtype=torch.float32, device=w1.device)

    if not unk_tailed:
        # layout: [ng_real j=O..1 | uni_real | ctx j=O..1]
        all1 = torch.stack([(_mul32(c, _S1) + w1) & _MASK32 for c in c1s] + [w1] + c1s, dim=-1)
        all2 = torch.stack([(_mul32(c, _S2) + w2) & _MASK32 for c in c2s] + [w2] + c2s, dim=-1)
        hit_all, lp_all, bo_all = _lookup(table, all1, all2)
        uni_hit = hit_all[..., O]
        pen_full = torch.zeros_like(penalty)  # the OOV path: found never
        for i, j in enumerate(range(O, -1, -1)):  # longest context → unigram
            valid = kmax >= j
            take = valid & hit_all[..., i] & ~found
            score = torch.where(take, penalty + lp_all[..., i], score)
            found = found | (valid & hit_all[..., i])
            if j > 0:
                bo = bo_all[..., O + 1 + i]  # backoff of the skipped context
                penalty = penalty + torch.where(valid & ~found, bo, 0.0)
                pen_full = pen_full + torch.where(valid, bo, 0.0)
        if unk_uni is None:
            unk_score = torch.full_like(score, -99.0)
        else:
            unk_score = pen_full + float(np.float32(unk_uni))
        return torch.where(uni_hit, score, unk_score)

    u1, u2 = int(_UNK_H[0]), int(_UNK_H[1])
    # layout: [ng_real j=O..1 | uni_real | ng_unk j=O..1 | uni_unk | ctx j=O..1]
    all1 = torch.stack(
        [(_mul32(c, _S1) + w1) & _MASK32 for c in c1s] + [w1]
        + [(_mul32(c, _S1) + u1) & _MASK32 for c in c1s] + [torch.full_like(w1, u1)] + c1s,
        dim=-1,
    )
    all2 = torch.stack(
        [(_mul32(c, _S2) + w2) & _MASK32 for c in c2s] + [w2]
        + [(_mul32(c, _S2) + u2) & _MASK32 for c in c2s] + [torch.full_like(w2, u2)] + c2s,
        dim=-1,
    )
    hit_all, lp_all, bo_all = _lookup(table, all1, all2)
    uni_hit = hit_all[..., O]  # the real word's unigram present?

    def sel(arr, i):  # level i: the real variant when uni_hit, else the <unk> one
        return torch.where(uni_hit, arr[..., i], arr[..., O + 1 + i])

    for i, j in enumerate(range(O, -1, -1)):  # longest context → unigram
        valid = kmax >= j
        hit = sel(hit_all, i)
        take = valid & hit & ~found
        score = torch.where(take, penalty + sel(lp_all, i), score)
        found = found | (valid & hit)
        if j > 0:
            bo = bo_all[..., 2 * O + 2 + i]  # backoff of the skipped context
            penalty = penalty + torch.where(valid & ~found, bo, 0.0)
    return score


# --------------------------------------------------------------------------
# The fused beam search
# --------------------------------------------------------------------------


def beam_search_lm_device(
    log_probs: torch.Tensor,
    lengths: torch.Tensor,
    table: DeviceLMTable,
    blank_id: int,
    pad_id: int,
    space_id: int,
    beam_width: int,
    alpha: float = 0.5,
    beta: float = 0.0,
    beam_prune_logp: float = -10.0,
    token_min_logp: float = -5.0,
    blank_bias: float = 0.0,
    token_top_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched prefix beam search with in-search word-LM fusion, on the
    log-probs' device.

    ``token_top_k`` restricts each frame's extension candidates to its top-k
    tokens (the same preselection as ``ops.ctc_decode.beam_search``); exact
    whenever ≤ k tokens pass the ``token_min_logp`` admission.

    Returns ``(chars (T,B,K) int32, parents (T,B,K) int32, final_scores
    (B,K), best_beam (B,) int32)`` on the device — feed ``best_beam`` to
    :func:`traceback`.
    """
    B, T, V = log_probs.shape
    K = beam_width
    O = table.order - 1
    dev = log_probs.device
    packed = _packed_device_table(table, dev)
    unk_tailed = table.unk_tailed
    unk_uni = None if unk_tailed or table.unk_uni_lp is None else float(table.unk_uni_lp)
    alpha_ln10, beta = float(alpha) * LN10, float(beta)

    def word_delta(cx1, cx2, nw, pw1, pw2):
        """Fused LM score of completing each beam's partial word (0 if none)."""
        score10 = _score_word(packed, table.order, cx1, cx2, nw, pw1, pw2,
                              unk_tailed=unk_tailed, unk_uni=unk_uni)
        return torch.where((pw1 != 0) | (pw2 != 0), alpha_ln10 * score10 + beta, 0.0)

    lp_adm_all, ext_ids_all, lp_ext_all = frame_candidates(
        log_probs, blank_id, pad_id, token_min_logp, blank_bias, token_top_k)
    E = ext_ids_all.shape[2]
    is_space_all = ext_ids_all == space_id  # (B, T, E)

    def zeros(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    p_b = torch.full((B, K), NEG_INF, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((B, K), NEG_INF, device=dev)
    h1, h2 = zeros(B, K), zeros(B, K)  # prefix hashes
    last = torch.full((B, K), -1, dtype=torch.int64, device=dev)
    lm = zeros(B, K, dtype=torch.float32)  # fused LM score of the completed words
    pw1, pw2 = zeros(B, K), zeros(B, K)  # hashes of the partial word
    nw = zeros(B, K)  # completed words
    cx1, cx2 = zeros(B, K, O), zeros(B, K, O)  # hashes of the last 1..O words

    N = K + K * E
    beams = torch.arange(K, dtype=torch.int64, device=dev)
    parent = torch.cat([beams, beams[:, None].expand(K, E).reshape(K * E)]).expand(B, N)
    ext_pb = torch.full((B, K * E), NEG_INF, device=dev)
    no_char = torch.full((B, K), -1, dtype=torch.int64, device=dev)
    first = torch.ones((B, 1), dtype=torch.bool, device=dev)
    active_all = torch.arange(T, device=dev)[:, None] < lengths[None, :].to(dev)  # (T, B)
    chars_out = torch.empty((T, B, K), dtype=torch.int32, device=dev)
    parents_out = torch.empty((T, B, K), dtype=torch.int32, device=dev)

    for t in range(T):
        lp_adm = lp_adm_all[:, t]  # (B, V)
        lp_ext = lp_ext_all[:, t][:, None, :]  # (B, 1, E)
        ext_ids = ext_ids_all[:, t]  # (B, E)

        p_tot = torch.logaddexp(p_b, p_nb)  # (B, K)
        lm_sp = lm + word_delta(cx1, cx2, nw, pw1, pw2)  # the fused lm IF the next char is a space

        # ---- stay candidates (one per beam): prefix unchanged
        stay_pb = p_tot + lp_adm[:, blank_id : blank_id + 1]
        lp_last = lp_adm.gather(1, last.clamp(0, V - 1))
        stay_pnb = torch.where(last >= 0, p_nb + lp_last, NEG_INF)

        # ---- extension candidates (per beam × extension token)
        same_as_last = ext_ids[:, None, :] == last[:, :, None]  # (B, K, E)
        base = torch.where(same_as_last, p_b[:, :, None], p_tot[:, :, None])
        ext_pnb = (base + lp_ext).reshape(B, K * E)
        vv = ext_ids[:, None, :] + 1  # (B, 1, E)
        ext_h1 = ((h1[:, :, None] * int(_W1) + vv) & _MASK32).reshape(B, K * E)
        ext_h2 = ((h2[:, :, None] * int(_W2) + vv) & _MASK32).reshape(B, K * E)
        ext_char = ext_ids[:, None, :].expand(B, K, E).reshape(B, K * E)
        # a candidate's lm: its parent's, with the word completed by a space
        ext_lm = torch.where(is_space_all[:, t][:, None, :], lm_sp[:, :, None],
                             lm[:, :, None]).reshape(B, K * E)

        # ---- flatten candidates: [stay (K), ext (K·E)]
        cand_pb = torch.cat([stay_pb, ext_pb], dim=1)
        cand_pnb = torch.cat([stay_pnb, ext_pnb], dim=1)
        cand_h1 = torch.cat([h1, ext_h1], dim=1)
        cand_h2 = torch.cat([h2, ext_h2], dim=1)
        cand_lm = torch.cat([lm, ext_lm], dim=1)
        cand_char = torch.cat([no_char, ext_char], dim=1)

        # ---- merge duplicates: a stable sort by the unsigned (h1, h2) pair
        # (order-preserving in int64), then a log-sum-exp over each run
        s_key, order = torch.sort(merge_key(cand_h1, cand_h2), dim=1, stable=True)
        new_seg = torch.cat([first, s_key[:, 1:] != s_key[:, :-1]], dim=1)
        run_id = torch.cumsum(new_seg.to(torch.int64), dim=1) - 1
        cand = torch.stack([cand_pb, cand_pnb]).gather(2, order.expand(2, B, N))
        m_pb, m_pnb = _run_logsumexp(cand, run_id, K)
        s_lm = cand_lm.gather(1, order)
        run_last = torch.cat([new_seg[:, 1:], first], dim=1)
        score = torch.where(run_last, torch.logaddexp(m_pb, m_pnb) + s_lm, NEG_INF)

        top_score, top_idx = top_k(score, K)
        src = order.gather(1, top_idx)  # candidate index of each survivor
        n_pb = m_pb.gather(1, top_idx)
        n_pnb = m_pnb.gather(1, top_idx)
        n_lm = s_lm.gather(1, top_idx)
        n_char = cand_char.gather(1, src)
        n_parent = parent.gather(1, src)

        # ---- the survivors' word state, rebuilt from (parent, char): the
        # members of a merged run share the prefix, so any one rebuilds it
        p_pw1, p_pw2 = pw1.gather(1, n_parent), pw2.gather(1, n_parent)
        is_ext = n_char >= 0
        is_sp = is_ext & (n_char == space_id)
        completes = is_sp & ((p_pw1 != 0) | (p_pw2 != 0))
        v_n = n_char + 1  # masked by is_ext
        n_last = torch.where(is_ext, n_char, last.gather(1, n_parent))
        n_pw1 = torch.where(is_ext, torch.where(is_sp, 0, (p_pw1 * int(_W1) + v_n) & _MASK32), p_pw1)
        n_pw2 = torch.where(is_ext, torch.where(is_sp, 0, (p_pw2 * int(_W2) + v_n) & _MASK32), p_pw2)
        n_nw = nw.gather(1, n_parent) + completes.to(torch.int64)
        if O > 0:
            idx = n_parent[:, :, None].expand(B, K, O)
            p_cx1, p_cx2 = cx1.gather(1, idx), cx2.gather(1, idx)
            # the word-context hashes shift only when a word completes
            shift_cx1 = torch.cat(
                [p_pw1[:, :, None], (_mul32(p_cx1[:, :, :-1], _S1) + p_pw1[:, :, None]) & _MASK32],
                dim=2)
            shift_cx2 = torch.cat(
                [p_pw2[:, :, None], (_mul32(p_cx2[:, :, :-1], _S2) + p_pw2[:, :, None]) & _MASK32],
                dim=2)
            n_cx1 = torch.where(completes[:, :, None], shift_cx1, p_cx1)
            n_cx2 = torch.where(completes[:, :, None], shift_cx2, p_cx2)
        else:  # unigram LM: no word context to carry
            n_cx1, n_cx2 = cx1, cx2

        # beam pruning relative to the best beam
        dead = top_score < top_score[:, :1] + beam_prune_logp
        n_pb = n_pb.masked_fill(dead, NEG_INF)
        n_pnb = n_pnb.masked_fill(dead, NEG_INF)

        # frames beyond a sample's length leave its beams untouched
        active = active_all[t][:, None]  # (B, 1)
        p_b = torch.where(active, n_pb, p_b)
        p_nb = torch.where(active, n_pnb, p_nb)
        h1 = torch.where(active, cand_h1.gather(1, src), h1)
        h2 = torch.where(active, cand_h2.gather(1, src), h2)
        last = torch.where(active, n_last, last)
        lm = torch.where(active, n_lm, lm)
        pw1 = torch.where(active, n_pw1, pw1)
        pw2 = torch.where(active, n_pw2, pw2)
        nw = torch.where(active, n_nw, nw)
        cx1 = torch.where(active[:, :, None], n_cx1, cx1)
        cx2 = torch.where(active[:, :, None], n_cx2, cx2)
        # backpointers: identity transition for frozen samples
        parents_out[t] = torch.where(active, n_parent, beams[None, :])
        chars_out[t] = torch.where(active, n_char, -1)

    # finalization: score the trailing partial word (host_beam's final_score)
    final_scores = torch.logaddexp(p_b, p_nb) + lm + word_delta(cx1, cx2, nw, pw1, pw2)
    best_beam = torch.argmax(final_scores, dim=1).to(torch.int32)
    return chars_out, parents_out, final_scores, best_beam


def beam_decode_lm_device(
    log_probs,
    lengths,
    vocab: Vocab,
    table: DeviceLMTable,
    beam_width: int = 50,
    alpha: float = 0.5,
    beta: float = 0.0,
    beam_prune_logp: float = -10.0,
    token_min_logp: float = -5.0,
    blank_bias: float = 0.0,
    token_top_k: Optional[int] = None,
) -> List[str]:
    """The fused search → best-beam texts; log-probs and lengths (tensors or
    numpy arrays, which go to the CPU) are searched on the log-probs'
    device, and only the backpointers come to the host."""
    log_probs = torch.as_tensor(log_probs)
    lengths = torch.as_tensor(lengths, device=log_probs.device)
    with torch.inference_mode():
        chars, parents, _, best = beam_search_lm_device(
            log_probs,
            lengths,
            table,
            blank_id=vocab.blank_id,
            pad_id=vocab.pad_id,
            space_id=int(vocab.token_to_id[" "]),
            beam_width=beam_width,
            alpha=alpha,
            beta=beta,
            beam_prune_logp=beam_prune_logp,
            token_min_logp=token_min_logp,
            blank_bias=blank_bias,
            token_top_k=token_top_k,
        )
    prefixes = traceback(chars.cpu().numpy(), parents.cpu().numpy(), best.cpu().numpy())
    return [vocab.decode(p) for p in prefixes]
