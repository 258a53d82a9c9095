"""Connectionist Temporal Classification loss (PyTorch port of
``ssd_tpu/ops/ctc_loss.py``).

Numerics follow the JAX package, which follows ``torch.nn.CTCLoss``:

* extended label sequence ``blank t1 blank t2 … blank`` (2S+1 states);
* self-loop + advance + skip (skip only between distinct non-blank labels);
* ``zero_infinity``: impossible alignments (T < S + repeats) give 0 loss and
  0 gradient;
* ``reduction='mean'`` divides each loss by ``max(target_length, 1)``, then
  averages over the batch.

The α and β recursions dispatch on the device of their input: a CUDA tensor
goes to the hand-written kernels of ``csrc/ctc.cu`` (:data:`CTC_ALPHA`,
:data:`CTC_BETA`), a CPU tensor to the plain recursions
:func:`forward_alphas_plain` / :func:`betas_plain`. There is no fall back and
no size gate: a CUDA tensor of any T ≥ 1 and S2 ≥ 1 reaches the kernels or
raises. The emission gather, the log-likelihood, the posterior and its
scatter back to the vocabulary stay plain torch, as they were XLA around the
Pallas calls.

Gradient convention: torch's CTC backward returns ``exp(log_probs) − γ`` (it
folds the log-softmax backward in). This loss returns the true gradient with
respect to the log-probs, ``−γ`` (row sums −1), as the JAX package does.
Composed through a real log-softmax the two give the same logits gradients.
"""

from __future__ import annotations

import ctypes

import torch

from ssd_tpu_torch.utils.cuda_build import CudaLibrary

NEG_INF = -1.0e30  # safe -inf surrogate: logaddexp stays finite


def _extend_targets(targets: torch.Tensor, blank_id: int) -> torch.Tensor:
    """(B, S) → (B, 2S+1) interleaved with blanks: b t1 b t2 … b."""
    B, S = targets.shape
    ext = torch.full((B, 2 * S + 1), blank_id, dtype=torch.int64, device=targets.device)
    ext[:, 1::2] = targets.to(torch.int64)
    return ext


def _topology(targets: torch.Tensor, blank_id: int):
    """Extended labels and the skip mask (skip INTO state s allowed)."""
    ext = _extend_targets(targets, blank_id)  # (B, S2)
    S2 = ext.shape[1]
    is_label = (torch.arange(S2, device=ext.device) % 2 == 1)[None, :]
    prev2_label = torch.nn.functional.pad(ext[:, :-2], (2, 0), value=-1)
    return ext, is_label & (ext != prev2_label)


def _emissions(log_probs: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """(B,T,V) gathered at (B,S2) labels → (T,B,S2) per-state log-probs.

    A gather: the JAX package's one-hot einsum exists only because gathers
    are slow on a TPU; both select single fp32 values exactly.
    """
    B, T, _ = log_probs.shape
    idx = ext[:, None, :].expand(B, T, ext.shape[1])
    return torch.gather(log_probs, 2, idx).permute(1, 0, 2).contiguous()


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max + log1p(exp(−|a − b|))`` — jnp.logaddexp's (and the kernels')
    order of operations."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


# --------------------------------------------------------------------------
# Plain recursions (CPU path; the card's reference for the kernels)
# --------------------------------------------------------------------------


def forward_alphas_plain(lp_ext: torch.Tensor, allow_skip: torch.Tensor) -> torch.Tensor:
    """α recursion (``ssd_tpu/ops/ctc_loss.py:_forward_alphas``); all α (T, B, S2)."""
    T, B, S2 = lp_ext.shape
    neg = lp_ext.new_full((B, 1), NEG_INF)
    alpha = lp_ext.new_full((B, S2), NEG_INF)
    alpha[:, : min(S2, 2)] = lp_ext[0, :, : min(S2, 2)]
    out = [alpha]
    for t in range(1, T):
        advance = torch.cat([neg, alpha[:, :-1]], dim=1)
        skip = torch.cat([neg, neg, alpha[:, :-2]], dim=1)[:, :S2]
        skip = torch.where(allow_skip, skip, NEG_INF)
        merged = _logaddexp(_logaddexp(alpha, advance), skip)
        alpha = torch.clamp(lp_ext[t] + merged, min=NEG_INF)
        out.append(alpha)
    return torch.stack(out)


def betas_plain(
    lp_ext: torch.Tensor,
    logit_lengths: torch.Tensor,
    beta_final: torch.Tensor,
    skip_from: torch.Tensor,
) -> torch.Tensor:
    """Reverse β recursion (``_ctc_bwd``'s scan); all β (T, B, S2)."""
    T, B, S2 = lp_ext.shape
    neg = lp_ext.new_full((B, 1), NEG_INF)
    last = (logit_lengths.to(torch.int64) - 1)[:, None]  # (B, 1)
    beta = torch.where(last == T - 1, beta_final, NEG_INF)
    out = [beta]
    for t in range(T - 2, -1, -1):
        u = beta + lp_ext[t + 1]
        advance = torch.cat([u[:, 1:], neg], dim=1)
        skip = torch.cat([u[:, 2:], neg, neg], dim=1)[:, :S2]
        skip = torch.where(skip_from, skip, NEG_INF)
        merged = torch.clamp(_logaddexp(_logaddexp(u, advance), skip), min=NEG_INF)
        beta = torch.where(last == t, beta_final, merged)
        out.append(beta)
    return torch.stack(out[::-1])


# --------------------------------------------------------------------------
# CUDA kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int

_CTC_LIBRARY = CudaLibrary(
    "ssd_ctc",
    "ctc.cu",
    {
        "ssd_ctc_alpha_launch": ([_P, _P, _P, _I, _I, _I, _P], _I),
        "ssd_ctc_beta_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
        "ssd_ctc_error_string": ([_I], ctypes.c_char_p),
    },
)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class _CTCKernel:
    """Shared checks, launch and count of the two wrappers.

    ``launches`` is a plain integer, incremented once per kernel launch and
    nowhere else, so a run can show that the main path reached the kernel.
    """

    library = _CTC_LIBRARY

    def __init__(self) -> None:
        self.launches = 0

    def _lp_shape(self, lp_ext: torch.Tensor) -> tuple:
        if lp_ext.dim() != 3 or min(lp_ext.shape) < 1:
            raise ValueError(f"lp_ext must be a non-empty (T, B, S2) tensor, got {tuple(lp_ext.shape)}")
        _check("lp_ext", lp_ext, tuple(lp_ext.shape), torch.float32)
        return tuple(lp_ext.shape)

    def _launch(self, fn: str, device: torch.device, *args) -> None:
        lib = self.library.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{fn} failed: {lib.ssd_ctc_error_string(err).decode()}")
        self.launches += 1


class CTCAlphaKernel(_CTCKernel):
    """α of ``csrc/ctc.cu`` (replaces ``_alpha_kernel``): (T,B,S2) lp_ext and
    a (B,S2) float skip mask → all α (T,B,S2)."""

    def __call__(self, lp_ext: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        T, B, S2 = self._lp_shape(lp_ext)
        _check("skip", skip, (B, S2), torch.float32)
        if skip.device != lp_ext.device:
            raise ValueError("skip and lp_ext must be on the same device")
        out = torch.empty_like(lp_ext)
        self._launch(
            "ssd_ctc_alpha_launch", lp_ext.device,
            lp_ext.data_ptr(), skip.data_ptr(), out.data_ptr(), T, B, S2,
        )
        return out


class CTCBetaKernel(_CTCKernel):
    """β of ``csrc/ctc.cu`` (replaces ``_beta_kernel``): lp_ext, the (B,S2)
    float skip-from mask, β_final (B,S2) and int32 lengths (B,) → all β."""

    def __call__(
        self,
        lp_ext: torch.Tensor,
        skip_from: torch.Tensor,
        beta_final: torch.Tensor,
        lengths: torch.Tensor,
    ) -> torch.Tensor:
        T, B, S2 = self._lp_shape(lp_ext)
        _check("skip_from", skip_from, (B, S2), torch.float32)
        _check("beta_final", beta_final, (B, S2), torch.float32)
        _check("lengths", lengths, (B,), torch.int32)
        if any(t.device != lp_ext.device for t in (skip_from, beta_final, lengths)):
            raise ValueError("skip_from, beta_final, lengths and lp_ext must be on one device")
        out = torch.empty_like(lp_ext)
        self._launch(
            "ssd_ctc_beta_launch", lp_ext.device,
            lp_ext.data_ptr(), skip_from.data_ptr(), beta_final.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), T, B, S2,
        )
        return out


CTC_ALPHA = CTCAlphaKernel()
CTC_BETA = CTCBetaKernel()


def forward_alphas(lp_ext: torch.Tensor, allow_skip: torch.Tensor) -> torch.Tensor:
    """CUDA tensor → :data:`CTC_ALPHA`; CPU tensor → :func:`forward_alphas_plain`."""
    if lp_ext.device.type == "cpu":
        return forward_alphas_plain(lp_ext, allow_skip)
    return CTC_ALPHA(lp_ext, allow_skip.to(torch.float32).contiguous())


def betas(lp_ext, logit_lengths, beta_final, skip_from) -> torch.Tensor:
    """CUDA tensor → :data:`CTC_BETA`; CPU tensor → :func:`betas_plain`."""
    if lp_ext.device.type == "cpu":
        return betas_plain(lp_ext, logit_lengths, beta_final, skip_from)
    return CTC_BETA(
        lp_ext,
        skip_from.to(torch.float32).contiguous(),
        beta_final.contiguous(),
        logit_lengths.to(torch.int32).contiguous(),
    )


# --------------------------------------------------------------------------
# The loss
# --------------------------------------------------------------------------


def _loglik(alphas, logit_lengths, target_lengths):
    """Log-likelihood from α at each sample's final frame / states."""
    T, B, S2 = alphas.shape
    rows = torch.arange(B, device=alphas.device)
    t_last = torch.clamp(logit_lengths.to(torch.int64) - 1, 0, T - 1)
    alpha_last = alphas[t_last, rows]  # (B, S2)
    tl = target_lengths.to(torch.int64)
    end_blank = alpha_last[rows, torch.clamp(2 * tl, 0, S2 - 1)]
    end_label = torch.where(
        tl > 0, alpha_last[rows, torch.clamp(2 * tl - 1, 0, S2 - 1)], NEG_INF
    )
    return _logaddexp(end_blank, end_label)


def _final_states(target_lengths: torch.Tensor, S2: int) -> torch.Tensor:
    """β at each sample's last frame: 0 in the two accepting states."""
    tl = target_lengths.to(torch.int64)[:, None]
    s_idx = torch.arange(S2, device=tl.device)[None, :]
    final = (s_idx == torch.clamp(2 * tl, 0, S2 - 1)) | (
        (s_idx == torch.clamp(2 * tl - 1, 0, S2 - 1)) & (tl > 0)
    )
    return torch.where(final, 0.0, NEG_INF).to(torch.float32)


class _CTCLoss(torch.autograd.Function):
    """Forward ``_ctc_fwd_impl``; backward ``_ctc_bwd``'s analytic α–β posterior."""

    @staticmethod
    def forward(ctx, log_probs, logit_lengths, targets, target_lengths, blank_id):
        log_probs = log_probs.to(torch.float32)
        ext, allow_skip = _topology(targets, blank_id)
        lp_ext = _emissions(log_probs, ext)
        alphas = forward_alphas(lp_ext, allow_skip)
        ll = _loglik(alphas, logit_lengths, target_lengths)
        impossible = ll <= NEG_INF / 2
        ctx.save_for_backward(lp_ext, alphas, allow_skip, ext, ll, impossible,
                              logit_lengths, target_lengths)
        ctx.vocab = log_probs.shape[2]
        return torch.where(impossible, 0.0, -ll)

    @staticmethod
    def backward(ctx, g):
        lp_ext, alphas, allow_skip, ext, ll, impossible, logit_lengths, target_lengths = (
            ctx.saved_tensors
        )
        T, B, S2 = lp_ext.shape
        beta_final = _final_states(target_lengths, S2)
        # skip FROM state s jumps into s+2: allow_skip shifted left
        skip_from = torch.nn.functional.pad(allow_skip[:, 2:], (0, 2), value=False)
        bet = betas(lp_ext, logit_lengths, beta_final, skip_from)

        t_idx = torch.arange(T, device=lp_ext.device)[:, None, None]
        valid = t_idx < logit_lengths.to(torch.int64)[None, :, None]
        posterior = torch.exp(torch.clamp(alphas + bet - ll[None, :, None], NEG_INF, 0.0))
        posterior = torch.where(valid & ~impossible[None, :, None], posterior, 0.0)
        grad_ext = (-posterior * g.to(torch.float32)[None, :, None]).permute(1, 0, 2)
        grad_lp = torch.zeros((B, T, ctx.vocab), dtype=torch.float32, device=lp_ext.device)
        grad_lp.scatter_add_(2, ext[:, None, :].expand(B, T, S2), grad_ext)
        return grad_lp, None, None, None, None


def ctc_loss(
    log_probs: torch.Tensor,
    logit_lengths: torch.Tensor,
    targets: torch.Tensor,
    target_lengths: torch.Tensor,
    blank_id: int = 0,
) -> torch.Tensor:
    """Per-sample CTC negative log-likelihood, ``(B,)`` float32.

    ``log_probs`` is ``(B, T, V)`` log-softmax output; ``targets`` ``(B, S)``
    padded label ids (padding value irrelevant); impossible alignments give 0.
    """
    return _CTCLoss.apply(log_probs, logit_lengths, targets, target_lengths, blank_id)


def ctc_loss_reduced(
    log_probs: torch.Tensor,
    logit_lengths: torch.Tensor,
    targets: torch.Tensor,
    target_lengths: torch.Tensor,
    blank_id: int = 0,
    reduction: str = "mean",
) -> torch.Tensor:
    """CTC loss with torch-style reduction (``mean`` | ``sum`` | ``none``)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    per_sample = ctc_loss(log_probs, logit_lengths, targets, target_lengths, blank_id)
    if reduction == "none":
        return per_sample
    if reduction == "sum":
        return per_sample.sum()
    denom = torch.clamp(target_lengths, min=1).to(torch.float32)
    return (per_sample / denom).mean()
