"""Batched CTC decoding on the tensors' device: greedy and prefix beam search
(PyTorch port of ``ssd_tpu/ops/ctc_decode.py``, same semantics).

* pad probability mass is log-add-merged into blank before decoding and the
  pad symbol never extends a prefix;
* additive ``blank_bias`` on the blank log-prob;
* per-frame token admission: tokens below ``token_min_logp`` are not
  considered unless they are the frame argmax;
* ``token_top_k``: only the per-frame top-k tokens are extension candidates;
* per-step beam pruning: beams below ``best + beam_prune_logp`` die;
* frames past a sample's length leave its beams untouched;
* duplicate prefixes merge by log-sum-exp of their (blank, non-blank) path
  probabilities. Prefix identity is two 32-bit rolling hashes, computed in
  int64 and masked to 32 bits; candidates are sorted (stably) by the packed
  hash pair in the order ``jax.lax.sort`` gives the unsigned pair
  (:func:`merge_key`), so equal prefixes sit together, and each run is
  reduced by :func:`_run_logsumexp` (a masked window sum) in place of the
  JAX associative scan.

Ties break as in the JAX package on every device: the beam cut and the
token top-k keep the lower index first among equal scores (``jax.lax.top_k``'s
order; :func:`top_k`), and no step adds atomically, so the card repeats
itself and gives the CPU's sums.

The search emits per-step backpointers ``(parent_beam, emitted_char)``;
:func:`traceback` rebuilds the prefixes on the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1.0e30

# rolling-hash multipliers (two independent streams)
_H1_MULT = 1000003
_H2_MULT = 65599
_MASK32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# Greedy
# --------------------------------------------------------------------------


def greedy_decode(
    log_probs: torch.Tensor,
    lengths: torch.Tensor,
    blank_id: int,
    pad_id: int = 0,
    blank_bias: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized argmax–collapse–dedup decode.

    Returns ``(tokens (B, T) int32 padded with pad_id, counts (B,))``.
    """
    B, T, V = log_probs.shape
    dev = log_probs.device
    lp = log_probs.clone()
    lp[:, :, blank_id] += blank_bias
    preds = lp.argmax(dim=-1).to(torch.int32)  # (B, T)

    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    prev = torch.nn.functional.pad(preds[:, :-1], (1, 0), value=-1)
    keep = valid & (preds != blank_id) & (preds != prev)

    # stable compaction: position of each kept token in the output row
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    out = torch.full((B, T + 1), pad_id, dtype=torch.int32, device=dev)
    out.scatter_(1, torch.where(keep, pos, T), torch.where(keep, preds, pad_id))
    counts = keep.sum(dim=1).to(torch.int32)
    return out[:, :T], counts


# --------------------------------------------------------------------------
# Prefix beam search
# --------------------------------------------------------------------------


def merge_key(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """The 32-bit hash pair ``(h1, h2)`` (int64 tensors in [0, 2³²)) packed
    into one int64 that sorts as the unsigned pair does under
    ``jax.lax.sort``: ``h1`` shifted down by 2³¹ into the signed range, so a
    prefix with ``h1 ≥ 2³¹`` sorts after those below it."""
    return (h1 - (1 << 31)) * (1 << 32) + h2


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of ``x`` along its last axis and their
    indices, in descending order, equal values lower index first — the order
    of ``jax.lax.top_k``. ``torch.topk`` leaves the order of ties open, and
    at the beam cut a tie decides which prefix survives."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _run_logsumexp(values: torch.Tensor, run_id: torch.Tensor, max_run: int) -> torch.Tensor:
    """Log-sum-exp of ``values`` (..., B, N) over each run of equal
    ``run_id`` (B, N; every run contiguous, at most ``max_run`` long), held
    at the run's last position; an earlier position holds the run's sum up
    to it, as the JAX package's segmented scan leaves it. Leading axes share
    the runs.

    The run's max (an exact reduction) is subtracted; then each position
    sums the exponentials of the ``max_run`` positions ending at it that
    share its run — a window view, a mask and one reduction, no atomics, so
    every device makes the same additions. In a prefix search each beam puts
    at most one candidate into a run (its stay, or its extension by the run's
    last char), so the beam width bounds a run. A run holds at most two
    finite terms (the stay of the one live beam with the prefix, the
    extension of the one live beam one char shorter), and fp32 addition of
    two terms and zeros gives the same bits in any order: the sums equal the
    CPU's left-to-right ones."""
    idx = run_id.expand(values.shape)
    vmax = torch.full(values.shape, NEG_INF, dtype=values.dtype, device=values.device)
    vmax = vmax.scatter_reduce(-1, idx, values, reduce="amax", include_self=True)
    m = vmax.gather(-1, idx)
    pad = (max_run - 1, 0)
    window = F.pad(torch.exp(values - m), pad).unfold(-1, max_run, 1)  # (..., B, N, max_run)
    same = F.pad(run_id, pad, value=-1).unfold(-1, max_run, 1) == run_id[..., None]
    return m + torch.log(torch.where(same, window, 0.0).sum(dim=-1))


def frame_candidates(
    log_probs: torch.Tensor,
    blank_id: int,
    pad_id: int,
    token_min_logp: float,
    blank_bias: float,
    token_top_k: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every frame's admitted tokens, for a prefix search.

    The pad mass is merged into blank (pad can then never be emitted) after
    ``blank_bias``; a token is admitted at or above ``token_min_logp`` or as
    the frame's argmax. Returns ``(lp_adm (B, T, V): the admitted log-probs,
    NEG_INF elsewhere; ext_ids (B, T, E): each frame's extension tokens, all
    but blank and pad or the top ``token_top_k`` of them; lp_ext (B, T, E):
    their admitted log-probs)``.
    """
    B, T, V = log_probs.shape
    lp = log_probs.to(torch.float32).clone()
    lp[:, :, blank_id] += blank_bias
    if pad_id != blank_id:
        lp[:, :, blank_id] = torch.logaddexp(lp[:, :, blank_id], lp[:, :, pad_id])

    token_ids = torch.arange(V, dtype=torch.int64, device=log_probs.device)
    ext_invalid = (token_ids == blank_id) | (token_ids == pad_id)  # (V,)
    masked_lp = lp.masked_fill(ext_invalid[None, None, :], NEG_INF)
    if token_top_k is not None and token_top_k < V:
        ext_vals_all, ext_ids_all = top_k(masked_lp, token_top_k)
    else:
        ext_vals_all = masked_lp
        ext_ids_all = token_ids.expand(B, T, V)
    argmax_all = lp.argmax(dim=-1)  # (B, T)
    admitted_all = (lp >= token_min_logp) | (token_ids[None, None, :] == argmax_all[..., None])
    lp_adm_all = torch.where(admitted_all, lp, NEG_INF)
    ext_adm_all = (ext_vals_all >= token_min_logp) | (ext_ids_all == argmax_all[..., None])
    return lp_adm_all, ext_ids_all, torch.where(ext_adm_all, ext_vals_all, NEG_INF)


def beam_search(
    log_probs: torch.Tensor,
    lengths: torch.Tensor,
    blank_id: int,
    pad_id: int,
    beam_width: int,
    beam_prune_logp: float = -10.0,
    token_min_logp: float = -5.0,
    blank_bias: float = 0.0,
    token_top_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched CTC prefix beam search.

    Args:
      log_probs: ``(B, T, V)`` log-softmax outputs.
      lengths: ``(B,)`` valid frame counts.
      token_top_k: when set, only the top-k tokens per frame are candidate
        extensions (blank handled separately).

    Returns:
      ``(chars (T, B, K) int32, parents (T, B, K) int32, final_scores
      (B, K))`` — per-step backpointers (char −1 ⇒ no emission) plus final
      beam scores, for :func:`traceback`. Beam 0 of the final step is the
      best hypothesis.
    """
    B, T, V = log_probs.shape
    K = beam_width
    dev = log_probs.device
    lp_adm_all, ext_ids_all, lp_ext_all = frame_candidates(
        log_probs, blank_id, pad_id, token_min_logp, blank_bias, token_top_k)
    E = ext_ids_all.shape[2]

    p_b = torch.full((B, K), NEG_INF, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((B, K), NEG_INF, device=dev)
    h1 = torch.zeros((B, K), dtype=torch.int64, device=dev)
    h2 = torch.zeros((B, K), dtype=torch.int64, device=dev)
    last = torch.full((B, K), -1, dtype=torch.int64, device=dev)

    N = K + K * E
    beams = torch.arange(K, dtype=torch.int64, device=dev)
    parent = torch.cat([beams, beams.repeat_interleave(E)]).expand(B, N)
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
        # ---- stay candidates (one per beam): prefix unchanged
        stay_pb = p_tot + lp_adm[:, blank_id : blank_id + 1]
        lp_last = lp_adm.gather(1, last.clamp(0, V - 1))
        stay_pnb = torch.where(last >= 0, p_nb + lp_last, NEG_INF)

        # ---- extension candidates (per beam × extension token)
        same_as_last = ext_ids[:, None, :] == last[:, :, None]  # (B, K, E)
        base = torch.where(same_as_last, p_b[:, :, None], p_tot[:, :, None])
        ext_pnb = (base + lp_ext).reshape(B, K * E)
        vv = ext_ids[:, None, :] + 1  # (B, 1, E)
        ext_h1 = ((h1[:, :, None] * _H1_MULT + vv) & _MASK32).reshape(B, K * E)
        ext_h2 = ((h2[:, :, None] * _H2_MULT + vv) & _MASK32).reshape(B, K * E)
        ext_char = ext_ids[:, None, :].expand(B, K, E).reshape(B, K * E)

        # ---- flatten candidates: [stay (K), ext (K·E)]
        cand_pb = torch.cat([stay_pb, ext_pb], dim=1)
        cand_pnb = torch.cat([stay_pnb, ext_pnb], dim=1)
        cand_h1 = torch.cat([h1, ext_h1], dim=1)
        cand_h2 = torch.cat([h2, ext_h2], dim=1)
        cand_char = torch.cat([no_char, ext_char], dim=1)
        cand_last = torch.cat([last, ext_char], dim=1)

        # ---- merge duplicates: sort by the packed hash pair, run log-sum-exp
        s_key, order = torch.sort(merge_key(cand_h1, cand_h2), dim=1, stable=True)
        new_seg = torch.cat([first, s_key[:, 1:] != s_key[:, :-1]], dim=1)
        run_id = torch.cumsum(new_seg.to(torch.int64), dim=1) - 1
        cand = torch.stack([cand_pb, cand_pnb]).gather(2, order.expand(2, B, N))
        m_pb, m_pnb = _run_logsumexp(cand, run_id, K)
        run_last = torch.cat([new_seg[:, 1:], first], dim=1)
        score = torch.where(run_last, torch.logaddexp(m_pb, m_pnb), NEG_INF)

        top_score, top_idx = top_k(score, K)
        src = order.gather(1, top_idx)  # candidate index of each survivor
        n_pb = m_pb.gather(1, top_idx)
        n_pnb = m_pnb.gather(1, top_idx)

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
        last = torch.where(active, cand_last.gather(1, src), last)
        # backpointers: identity transition for frozen samples
        parents_out[t] = torch.where(active, parent.gather(1, src), beams[None, :])
        chars_out[t] = torch.where(active, cand_char.gather(1, src), -1)

    final_scores = torch.logaddexp(p_b, p_nb)  # (B, K) — beams ranked desc
    return chars_out, parents_out, final_scores


def traceback(
    chars: np.ndarray, parents: np.ndarray, beam: np.ndarray | int = 0
) -> List[List[int]]:
    """Reconstruct prefixes from backpointers.

    Args:
      chars/parents: ``(T, B, K)`` arrays from :func:`beam_search`.
      beam: final beam index (int or per-batch array).

    Returns: list of token-id lists, one per batch element.
    """
    chars = np.asarray(chars)
    parents = np.asarray(parents)
    T, B, _ = chars.shape
    beams = np.full((B,), beam) if np.isscalar(beam) else np.asarray(beam)
    out: List[List[int]] = []
    for b in range(B):
        k = int(beams[b])
        rev: List[int] = []
        for t in range(T - 1, -1, -1):
            c = int(chars[t, b, k])
            if c >= 0:
                rev.append(c)
            k = int(parents[t, b, k])
        out.append(rev[::-1])
    return out
