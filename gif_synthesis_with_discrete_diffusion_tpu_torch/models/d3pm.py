"""D3PM core: absorbing+uniform discrete diffusion in log space.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/d3pm.py``:

* sampling: the linear schedule (computed in float64 numpy, stored as
  float32 tensors), the analytic posterior of a one-hot ``x_t``, the
  classifier-free-guidance combine, and ``sample_fused``, the plain
  full-loop oracle every sampler route must be posterior-equivalent to;
* the log-onehot samplers: ``q_pred_one_timestep``, ``q_sample``,
  ``cf_predict_start``, ``p_pred``, and the three reverse loops that carry
  the (B, K, L) log-onehot state, ``sample`` (from ``filter_ratio`` of the
  way in), ``sample_fast`` (strided) and ``sample_with_token_budget`` (the
  host loop with per-step token budgets); their random draws come from a
  :class:`Draws`;
* training: ``q_pred``, ``q_posterior``, the token-space
  ``true_q_posterior`` and ``q_sample_from_indices``, importance-sampled
  timesteps over the Lt buffers (:class:`LtState`, :func:`sample_time`),
  ``train_loss`` and the per-timestep telemetry.

The reference's quirks are kept, not fixed: the ``-70`` clamp, the
``1e-30`` one-hot floor, the ``(t - 1 + (T + 1)) % (T + 1)`` wrap that
makes index ``T`` of the cumulative buffers the identity transition, and
the ``bt`` leakage of ``q_pred_one_timestep`` (corrected inside
``q_posterior`` by the mask-row substitution, as there).

Every random draw of the training loss can be handed in (``t`` with ``pt``,
and the (B, K, L) uniforms of the noising Gumbel-max), so the tests feed
the port the JAX draws; otherwise they come from the ``torch.Generator``
given, on its own device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["LOG_CLAMP", "D3PMSchedule", "LtState", "alpha_schedule",
           "make_schedule", "log_add_exp", "index_to_log_onehot",
           "log_onehot_to_index", "q_pred", "q_posterior", "true_q_posterior",
           "log_sample_categorical", "q_sample_from_indices",
           "predict_start_from_logits", "predict_start", "importance_probs",
           "sample_time", "multinomial_kl", "train_loss",
           "update_diffusion_telemetry", "sample_fused",
           "q_pred_one_timestep", "q_sample", "cf_predict_start", "p_pred",
           "default_n_sample", "token_budget", "Draws", "sample",
           "sample_fast", "sample_with_token_budget"]

LOG_CLAMP = -70.0
_LOG_EPS_ONEHOT = math.log(1.0e-30)

# denoise_fn(tokens (N, L) int64, cond (N, S, D) | None, t (N,)) -> logits
# (N, K-1, L)
DenoiseFn = Callable[[torch.Tensor, Optional[torch.Tensor], torch.Tensor],
                     torch.Tensor]


def alpha_schedule(time_step: int, N: int, att_1: float = 0.99999,
                   att_T: float = 0.000009, ctt_1: float = 0.000009,
                   ctt_T: float = 0.99999):
    """Linear absorbing/uniform schedule, float64 numpy."""
    att = np.arange(0, time_step, dtype=np.float64) / (time_step - 1) \
        * (att_T - att_1) + att_1
    att = np.concatenate(([1.0], att))
    at = att[1:] / att[:-1]
    ctt = np.arange(0, time_step, dtype=np.float64) / (time_step - 1) \
        * (ctt_T - ctt_1) + ctt_1
    ctt = np.concatenate(([0.0], ctt))
    one_minus_ctt = 1 - ctt
    one_minus_ct = one_minus_ctt[1:] / one_minus_ctt[:-1]
    ct = 1 - one_minus_ct
    bt = (1 - at - ct) / N
    att = np.concatenate((att[1:], [1.0]))
    ctt = np.concatenate((ctt[1:], [0.0]))
    btt = (1 - att - ctt) / N
    return at, bt, ct, att, btt, ctt


@dataclass(frozen=True)
class D3PMSchedule:
    """Log-space schedule tensors. Cumulative tensors have length ``T + 1``
    so that index ``T`` encodes the identity transition."""
    num_timesteps: int
    num_classes: int  # incl. the MASK token
    log_at: torch.Tensor
    log_bt: torch.Tensor
    log_ct: torch.Tensor
    log_cumprod_at: torch.Tensor
    log_cumprod_bt: torch.Tensor
    log_cumprod_ct: torch.Tensor
    log_1_min_ct: torch.Tensor
    log_1_min_cumprod_ct: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.log_at.device


def make_schedule(num_timesteps: int, num_classes: int,
                  att_1: float = 0.99999, att_T: float = 0.000009,
                  ctt_1: float = 0.000009, ctt_T: float = 0.99999,
                  device: torch.device | str | None = None) -> D3PMSchedule:
    at, bt, ct, att, btt, ctt = alpha_schedule(
        num_timesteps, N=num_classes - 1, att_1=att_1, att_T=att_T,
        ctt_1=ctt_1, ctt_T=ctt_T)
    with np.errstate(divide="ignore"):
        arrays = dict(
            log_at=np.log(at), log_bt=np.log(bt), log_ct=np.log(ct),
            log_cumprod_at=np.log(att), log_cumprod_bt=np.log(btt),
            log_cumprod_ct=np.log(ctt))
        arrays["log_1_min_ct"] = np.log(1 - np.exp(arrays["log_ct"]) + 1e-40)
        arrays["log_1_min_cumprod_ct"] = np.log(
            1 - np.exp(arrays["log_cumprod_ct"]) + 1e-40)
    tensors = {k: torch.from_numpy(v.astype(np.float32)).to(device)
               for k, v in arrays.items()}
    return D3PMSchedule(num_timesteps=num_timesteps,
                        num_classes=num_classes, **tensors)


# ---------------------------------------------------------------------------
# log-space helpers and the forward process
# ---------------------------------------------------------------------------

def log_add_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max + log(exp(a - max) + exp(b - max))``, as the JAX package writes
    it (not ``torch.logaddexp``), so both round alike."""
    maximum = torch.maximum(a, b)
    return maximum + torch.log(torch.exp(a - maximum) + torch.exp(b - maximum))


def index_to_log_onehot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, L) int -> (B, K, L) log-onehot with the log(1e-30) floor."""
    onehot = F.one_hot(x.long(), num_classes).permute(0, 2, 1)
    return torch.log(onehot.to(torch.float32).clamp(min=1e-30))


def log_onehot_to_index(log_x: torch.Tensor) -> torch.Tensor:
    """(B, K, L) -> (B, L) int64; the first maximum on ties."""
    return torch.argmax(log_x, dim=1)


def _extract(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a[t] -> (B, 1, 1) for broadcasting over (B, K, L)."""
    return a[t][:, None, None]


def _row(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a[t] -> (B, 1) for broadcasting over (B, L)."""
    return a[t][:, None]


def q_pred(sched: D3PMSchedule, log_x_start: torch.Tensor, t: torch.Tensor
           ) -> torch.Tensor:
    """log q(x_t | x_0); t = -1 wraps to the identity row T."""
    t = (t + (sched.num_timesteps + 1)) % (sched.num_timesteps + 1)
    return torch.cat([
        log_add_exp(log_x_start[:, :-1, :] + _extract(sched.log_cumprod_at, t),
                    _extract(sched.log_cumprod_bt, t)),
        log_add_exp(log_x_start[:, -1:, :]
                    + _extract(sched.log_1_min_cumprod_ct, t),
                    _extract(sched.log_cumprod_ct, t)),
    ], dim=1)


def q_pred_one_timestep(sched: D3PMSchedule, log_x_t: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """log q(x_t | x_{t-1}) applied to a log distribution; the last row
    keeps the reference's ``log_1_min_ct`` (the ``bt`` leakage that
    ``q_posterior`` corrects)."""
    return torch.cat([
        log_add_exp(log_x_t[:, :-1, :] + _extract(sched.log_at, t),
                    _extract(sched.log_bt, t)),
        log_add_exp(log_x_t[:, -1:, :] + _extract(sched.log_1_min_ct, t),
                    _extract(sched.log_ct, t)),
    ], dim=1)


def _q_posterior_index(sched: D3PMSchedule, log_x_start: torch.Tensor,
                       x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """:func:`q_posterior` for an index ``x_t`` (B, L): the one-hot's
    q_pred / q_pred_one_timestep rows take one value on the x_t row and one
    elsewhere, built from per-(b, l) scalars as the JAX package does."""
    b, _, L = log_x_start.shape
    K = sched.num_classes
    fl = _LOG_EPS_ONEHOT
    mask = (x_t == K - 1)[:, None, :]                           # (B, 1, L)
    log_zero_vector = torch.full((b, 1, L), fl, dtype=log_x_start.dtype,
                                 device=log_x_start.device)
    kk = torch.arange(K - 1, device=x_t.device)[None, :, None]
    is_xt = kk == x_t[:, None, :]                                # (B, K-1, L)

    A, B = _row(sched.log_cumprod_at, t), _row(sched.log_cumprod_bt, t)
    C = _row(sched.log_cumprod_ct, t)
    sv = log_add_exp(A, B)                                       # k == x_t
    snv = log_add_exp(fl + A, B)                                 # k != x_t
    log_qt = torch.where(mask, C[:, None, :],
                         torch.where(is_xt, sv[:, None, :], snv[:, None, :]))

    a_, b_ = _row(sched.log_at, t), _row(sched.log_bt, t)
    c_ = _row(sched.log_ct, t)
    tv = log_add_exp(a_, b_)
    tnv = log_add_exp(fl + a_, b_)
    lqots = torch.where(mask, c_[:, None, :],
                        torch.where(is_xt, tv[:, None, :], tnv[:, None, :]))
    last = torch.where(mask, torch.zeros_like(log_zero_vector),
                       log_zero_vector)
    log_qt_one_timestep = torch.cat([lqots, last], dim=1)

    q = log_x_start[:, :-1, :] - log_qt
    q = torch.cat([q, log_zero_vector], dim=1)
    q_log_sum_exp = torch.logsumexp(q, dim=1, keepdim=True)
    q = q - q_log_sum_exp
    log_ev = q_pred(sched, q, t - 1) + log_qt_one_timestep + q_log_sum_exp
    return torch.clamp(log_ev, LOG_CLAMP, 0.0)


def q_posterior(sched: D3PMSchedule, log_x_start: torch.Tensor,
                log_x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """log q(x_{t-1} | x_t, x_0-distribution), with the reference's mask-row
    corrections; ``log_x_t`` must be a log-onehot."""
    return _q_posterior_index(sched, log_x_start,
                              log_onehot_to_index(log_x_t), t)


def true_q_posterior(sched: D3PMSchedule, x_start: torch.Tensor,
                     x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """q(x_{t-1} | x_t, x_0) for INDEX x_start and x_t: every row of the
    dense computation takes one of four values per (b, l) (k == x_start,
    k == x_t, other non-mask rows, the mask row)."""
    K = sched.num_classes
    T = sched.num_timesteps
    fl = _LOG_EPS_ONEHOT
    tm1 = torch.where(t > 0, t - 1, T)     # q_pred's t-1 wrap (row T = id)

    A, B = _row(sched.log_cumprod_at, t), _row(sched.log_cumprod_bt, t)
    C = _row(sched.log_cumprod_ct, t)
    a_, b_, c_ = (_row(sched.log_at, t), _row(sched.log_bt, t),
                  _row(sched.log_ct, t))
    A2, B2 = _row(sched.log_cumprod_at, tm1), _row(sched.log_cumprod_bt, tm1)
    C2 = _row(sched.log_cumprod_ct, tm1)
    C1m2 = _row(sched.log_1_min_cumprod_ct, tm1)

    sv, snv = log_add_exp(A, B), log_add_exp(fl + A, B)
    tv, tnv = log_add_exp(a_, b_), log_add_exp(fl + a_, b_)

    mask_t = x_t == K - 1                                         # (B, L)
    same = (x_t == x_start) & ~mask_t
    has_xt = ~mask_t & ~same

    q_x0 = -torch.where(mask_t, C, torch.where(same, sv, snv))
    q_xt = fl - sv
    q_o = fl - torch.where(mask_t, C, snv)
    n_o = torch.where(has_xt, float(K - 3), float(K - 2))

    # logsumexp over [q_x0, q_xt?, n_o x q_o, floor]
    neg_inf = torch.full_like(q_x0, -math.inf)
    qxt_eff = torch.where(has_xt, q_xt, neg_inf)
    m = torch.maximum(torch.maximum(q_x0, qxt_eff),
                      torch.clamp(q_o, min=fl))
    lse = m + torch.log(
        torch.exp(q_x0 - m)
        + torch.where(has_xt, torch.exp(qxt_eff - m), 0.0)
        + n_o * torch.exp(q_o - m)
        + torch.exp(fl - m))

    lq_x0 = torch.where(mask_t, c_, torch.where(same, tv, tnv))
    lq_xt = tv
    lq_o = torch.where(mask_t, c_, tnv)
    lq_last = torch.where(mask_t, 0.0, fl)

    def post_row(q_val, lq_val):
        return torch.clamp(log_add_exp(q_val - lse + A2, B2) + lq_val + lse,
                           LOG_CLAMP, 0.0)

    v_x0 = post_row(q_x0, lq_x0)
    v_xt = torch.where(has_xt, post_row(q_xt, lq_xt), 0.0)
    v_o = post_row(q_o, lq_o)
    v_mask = torch.clamp(log_add_exp(fl - lse + C1m2, C2) + lq_last + lse,
                         LOG_CLAMP, 0.0)

    kk = torch.arange(K, device=x_t.device)[None, :, None]
    return torch.where(
        kk == K - 1, v_mask[:, None, :],
        torch.where(kk == x_start[:, None, :], v_x0[:, None, :],
                    torch.where(kk == x_t[:, None, :], v_xt[:, None, :],
                                v_o[:, None, :])))


def _gumbel_argmax(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Gumbel-max over axis 1 from the (B, K, L) uniforms ``noise``."""
    return torch.argmax(gumbel(noise.to(logits.device)) + logits, dim=1)


def log_sample_categorical(noise: torch.Tensor, logits: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """Gumbel-max sample over axis 1 -> log-onehot; ``noise`` holds the
    uniforms, shaped like ``logits``."""
    return index_to_log_onehot(_gumbel_argmax(logits, noise), num_classes)


def q_sample(noise: torch.Tensor, sched: D3PMSchedule,
             log_x_start: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """log-onehot x_t ~ q(x_t | x_0) for a log distribution ``x_0``;
    ``noise`` holds the (B, K, L) uniforms of the Gumbel-max draw."""
    return log_sample_categorical(noise, q_pred(sched, log_x_start, t),
                                  sched.num_classes)


def _q_sample_index(sched: D3PMSchedule, x_start: torch.Tensor,
                    t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x_t ~ q(x_t | x_0) for INDEX x_start, as (B, L) indices: the logits
    of a one-hot take three values per (b, l) (the x_start row, the other
    non-mask rows, the mask row)."""
    K = sched.num_classes
    fl = _LOG_EPS_ONEHOT
    A, B = _row(sched.log_cumprod_at, t), _row(sched.log_cumprod_bt, t)
    C = _row(sched.log_cumprod_ct, t)
    C1m = _row(sched.log_1_min_cumprod_ct, t)
    sv = log_add_exp(A, B)[:, None, :]          # k == x_start
    snv = log_add_exp(fl + A, B)[:, None, :]    # other non-mask rows
    mv = log_add_exp(fl + C1m, C)[:, None, :]   # mask row (x0 never mask)
    kk = torch.arange(K, device=x_start.device)[None, :, None]
    logits = torch.where(kk == K - 1, mv,
                         torch.where(kk == x_start[:, None, :], sv, snv))
    return _gumbel_argmax(logits, noise)


def q_sample_from_indices(noise: torch.Tensor, sched: D3PMSchedule,
                          x_start: torch.Tensor, t: torch.Tensor
                          ) -> torch.Tensor:
    """log-onehot x_t ~ q(x_t | x_0) for INDEX x_start; ``noise`` holds the
    (B, K, L) uniforms of the Gumbel-max draw."""
    return index_to_log_onehot(_q_sample_index(sched, x_start, t, noise),
                               sched.num_classes)


def predict_start_from_logits(logits: torch.Tensor, content_seq_len: int
                              ) -> torch.Tensor:
    """Denoiser logits (B, K-1, L) -> clamped log p(x0 | xt) with the -70
    MASK row; f32 log_softmax."""
    b = logits.shape[0]
    log_pred = torch.log_softmax(logits.float(), dim=1)
    zero_vector = torch.full((b, 1, content_seq_len), LOG_CLAMP,
                             dtype=torch.float32, device=logits.device)
    return torch.clamp(torch.cat([log_pred, zero_vector], dim=1),
                       LOG_CLAMP, 0.0)


def predict_start(sched: D3PMSchedule, denoise_fn: DenoiseFn,
                  log_x_t: torch.Tensor, cond_emb: Optional[torch.Tensor],
                  t: torch.Tensor) -> torch.Tensor:
    logits = denoise_fn(log_onehot_to_index(log_x_t), cond_emb, t)
    return predict_start_from_logits(logits, log_x_t.shape[-1])


def cf_predict_start(sched: D3PMSchedule, denoise_fn: DenoiseFn,
                     log_x_t: torch.Tensor, cond_emb: Optional[torch.Tensor],
                     cf_cond_emb: Optional[torch.Tensor], t: torch.Tensor,
                     guidance_scale: float) -> torch.Tensor:
    """Classifier-free guidance as one batched (2B) denoiser call: the
    guided log p(x0 | xt), renormalised and clamped, with the -70 MASK
    row."""
    b, _, L = log_x_t.shape
    if abs(guidance_scale - 1.0) < 1e-3:
        return predict_start(sched, denoise_fn, log_x_t, cond_emb, t)
    x_t = log_onehot_to_index(log_x_t)
    logits2 = denoise_fn(torch.cat([x_t, x_t], dim=0),
                         _cfg_batch(cond_emb, cf_cond_emb, True),
                         torch.cat([t, t], dim=0))
    log_pred = predict_start_from_logits(logits2, L)
    c, cf = log_pred[:b, :-1], log_pred[b:, :-1]
    log_new = cf + guidance_scale * (c - cf)
    log_new = log_new - torch.logsumexp(log_new, dim=1, keepdim=True)
    log_new = torch.clamp(log_new, LOG_CLAMP, 0.0)
    zero_vector = torch.full((b, 1, L), LOG_CLAMP, dtype=torch.float32,
                             device=log_new.device)
    return torch.cat([log_new, zero_vector], dim=1)


def p_pred(sched: D3PMSchedule, denoise_fn: DenoiseFn, log_x: torch.Tensor,
           cond_emb: Optional[torch.Tensor],
           cf_cond_emb: Optional[torch.Tensor], t: torch.Tensor,
           guidance_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """p(x_{t-1} | x_t) by the x0 parametrisation: (log posterior,
    guided log p(x0 | xt))."""
    log_x_recon = cf_predict_start(sched, denoise_fn, log_x, cond_emb,
                                   cf_cond_emb, t, guidance_scale)
    return q_posterior(sched, log_x_recon, log_x, t), log_x_recon


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------

@dataclass
class LtState:
    """Importance-sampling buffers: the EMA of each timestep's squared loss
    and how often it was drawn, (T,) f32 each."""
    history: torch.Tensor
    count: torch.Tensor

    @classmethod
    def zeros(cls, num_timesteps: int,
              device: torch.device | str | None = None) -> "LtState":
        return cls(history=torch.zeros(num_timesteps, device=device),
                   count=torch.zeros(num_timesteps, device=device))


def importance_probs(history: torch.Tensor) -> torch.Tensor:
    """p(t) proportional to sqrt(Lt history), with t = 0 given t = 1's."""
    lt_sqrt = torch.sqrt(history + 1e-10) + 0.0001
    lt_sqrt = torch.cat([lt_sqrt[1:2], lt_sqrt[1:]])
    return lt_sqrt / lt_sqrt.sum()


def sample_time(generator: torch.Generator, lt: LtState, b: int,
                num_timesteps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Importance-weighted t with a uniform warm-up: uniform until every
    timestep has been drawn more than 10 times. Both draws are made and one
    is kept on the device, so the choice costs no host sync. Returns
    (t (B,) int64, pt (B,) f32)."""
    device = lt.history.device
    pt_all = importance_probs(lt.history)
    t_imp = torch.multinomial(pt_all.to(generator.device), b,
                              replacement=True, generator=generator
                              ).to(device)
    t_uni = torch.randint(0, num_timesteps, (b,), generator=generator,
                          device=generator.device).to(device)
    use_importance = (lt.count > 10).all()
    t = torch.where(use_importance, t_imp, t_uni)
    pt = torch.where(use_importance, pt_all[t_imp],
                     torch.full((b,), 1.0 / num_timesteps, device=device))
    return t, pt


def multinomial_kl(log_prob1: torch.Tensor, log_prob2: torch.Tensor
                   ) -> torch.Tensor:
    return torch.sum(torch.exp(log_prob1) * (log_prob1 - log_prob2), dim=1)


def _set_last(buf: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor
              ) -> torch.Tensor:
    """``buf.at[idx].set(vals)`` with the last write winning on duplicate
    indices, resolved explicitly (a CUDA index_put leaves their order
    open)."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full(buf.shape, -1, dtype=torch.long, device=idx.device)
    last = last.scatter_reduce(0, idx, pos, reduce="amax")
    return torch.where(last >= 0, vals[last.clamp(min=0)], buf)


def train_loss(generator: Optional[torch.Generator], sched: D3PMSchedule,
               denoise_fn: DenoiseFn, x_start: torch.Tensor,
               cond_emb: Optional[torch.Tensor], lt: LtState, *,
               auxiliary_loss_weight: float = 0.0,
               adaptive_auxiliary_loss: bool = False,
               mask_weight: tuple[float, float] = (1.0, 1.0),
               is_train: bool = True, t: Optional[torch.Tensor] = None,
               pt: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None):
    """The reference's ``_train_loss`` (the JAX ``train_loss``).

    ``x_start`` (B, L) holds data tokens only (every value < K - 1). The
    draws ``t`` with ``pt`` and the (B, K, L) uniforms ``noise`` are taken
    from ``generator`` unless given. Returns (per-sample vb loss (B,), aux
    dict, new :class:`LtState`); the caller averages over B * L. The
    (B, K, L) log-onehot of x_start is never made: noising, the true
    posterior, the decoder NLL and the auxiliary KL work in token space."""
    b, L = x_start.shape
    K = sched.num_classes
    if (t is None) != (pt is None):
        raise ValueError("train_loss: give both t and pt, or neither")
    if t is None:
        t, pt = sample_time(generator, lt, b, sched.num_timesteps)
    t = t.to(x_start.device).long()
    pt = pt.to(x_start.device)
    x_start = x_start.long()
    if noise is None:
        noise = torch.rand((b, K, L), generator=generator,
                           device=generator.device)

    xt = _q_sample_index(sched, x_start, t, noise)
    log_x0_recon = predict_start_from_logits(denoise_fn(xt, cond_emb, t), L)
    log_model_prob = _q_posterior_index(sched, log_x0_recon, xt, t)

    x0_recon = log_onehot_to_index(log_x0_recon)
    xt_1_recon = log_onehot_to_index(log_model_prob)

    log_true_prob = true_q_posterior(sched, x_start, xt, t)
    kl = multinomial_kl(log_true_prob, log_model_prob)             # (B, L)
    mask_region = (xt == K - 1).to(torch.float32)
    mw = mask_region * mask_weight[0] + (1.0 - mask_region) * mask_weight[1]
    kl = torch.sum(kl * mw, dim=-1)                                 # (B,)

    # exp(log-onehot) is the one-hot: the contraction is a gather
    x_index = x_start[:, None, :]
    decoder_nll = -log_model_prob.gather(1, x_index)[:, 0, :].sum(dim=-1)

    is_t0 = (t == 0).to(torch.float32)
    kl_loss = is_t0 * decoder_nll + (1.0 - is_t0) * kl

    # Lt EMA buffers; duplicate t: the last write wins
    lt2 = torch.square(kl_loss.detach())
    new_hist = _set_last(lt.history, t, 0.1 * lt2 + 0.9 * lt.history[t])
    new_count = lt.count.index_add(0, t, torch.ones_like(lt2))
    new_lt = LtState(history=new_hist, count=new_count)

    vb_loss = kl_loss / pt
    if auxiliary_loss_weight != 0 and is_train:
        kl_aux = -log_x0_recon.gather(1, x_index)[:, 0, :]
        kl_aux = torch.sum(kl_aux * mw, dim=-1)
        kl_aux_loss = is_t0 * decoder_nll + (1.0 - is_t0) * kl_aux
        if adaptive_auxiliary_loss:
            addition_loss_weight = (1.0 - t.to(torch.float32)
                                    / sched.num_timesteps) + 1.0
        else:
            addition_loss_weight = 1.0
        vb_loss = vb_loss + (addition_loss_weight * auxiliary_loss_weight
                             * kl_aux_loss / pt)

    aux = dict(t=t, x0_recon=x0_recon, xt=xt, xt_1_recon=xt_1_recon,
               log_model_prob=log_model_prob)
    return vb_loss, aux, new_lt


@torch.no_grad()
def update_diffusion_telemetry(acc: torch.Tensor, keep: torch.Tensor,
                               t: torch.Tensor, x0_recon: torch.Tensor,
                               x_start: torch.Tensor, xt: torch.Tensor,
                               xt_1_recon: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-timestep EMA (decay 0.9) of the x0-argmax accuracy and of the
    posterior-argmax keep rate, updated sample by sample in batch order
    (duplicate t compound, as in the reference). Returns (acc, keep)."""
    same_acc = (x0_recon == x_start).to(torch.float32).mean(dim=1)
    same_keep = (xt_1_recon == xt).to(torch.float32).mean(dim=1)
    a, k = acc.clone(), keep.clone()
    for i in range(x_start.shape[0]):
        ti = t[i:i + 1]
        a.index_put_((ti,), same_acc[i:i + 1] * 0.1 + a[ti] * 0.9)
        k.index_put_((ti,), same_keep[i:i + 1] * 0.1 + k[ti] * 0.9)
    return a, k


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _analytic_posterior(sched: D3PMSchedule, log_x_recon: torch.Tensor,
                        tokens: torch.Tensor, t: int) -> torch.Tensor:
    """Exact q_posterior for a one-hot x_t given log p(x0|xt).

    log_x_recon: (B, K-1, L) guided log-probs; tokens: (B, L) current x_t;
    t: the step (Python int). Returns (B, K, L) clamped posterior log-probs.
    """
    K = sched.num_classes
    T = sched.num_timesteps
    b, _, L = log_x_recon.shape
    tp = (t + (T + 1)) % (T + 1)
    tm = (t - 1 + (T + 1)) % (T + 1)

    log_ct_at = sched.log_cumprod_at[tp]
    log_ct_bt = sched.log_cumprod_bt[tp]
    log_ct_ct = sched.log_cumprod_ct[tp]
    log_at, log_bt, log_ct = sched.log_at[t], sched.log_bt[t], sched.log_ct[t]
    log_ct_at_p = sched.log_cumprod_at[tm]   # t-1 (wraps to identity at t=0)
    log_ct_bt_p = sched.log_cumprod_bt[tm]
    log_ct_ct_p = sched.log_cumprod_ct[tm]
    log_1m_ct_ct_p = sched.log_1_min_cumprod_ct[tm]

    mask = (tokens == K - 1)[:, None, :]                       # (B, 1, L)
    cls = torch.arange(K - 1, device=tokens.device)[None, :, None]
    is_v = cls == tokens[:, None, :]                            # (B, K-1, L)

    # log q(x_t | x_0=j) at the observed x_t  (q_pred of the one-hot)
    log_qt = torch.where(
        mask, log_ct_ct,
        torch.where(is_v, torch.logaddexp(log_ct_at, log_ct_bt), log_ct_bt))
    # log q(x_t | x_{t-1}=j)   (q_pred_one_timestep of the one-hot)
    log_qt1 = torch.where(
        mask, log_ct,
        torch.where(is_v, torch.logaddexp(log_at, log_bt), log_bt))
    log_qt1_mask_row = torch.where(
        mask[:, 0, :], torch.zeros((), device=tokens.device),
        torch.full((), _LOG_EPS_ONEHOT, device=tokens.device))

    q = log_x_recon - log_qt                                    # (B, K-1, L)
    q_mask_row = torch.full((b, 1, L), _LOG_EPS_ONEHOT, dtype=q.dtype,
                            device=q.device)
    lse = torch.logsumexp(torch.cat([q, q_mask_row], dim=1), dim=1,
                          keepdim=True)                         # (B, 1, L)
    qn = q - lse
    post = torch.logaddexp(qn + log_ct_at_p, log_ct_bt_p) + log_qt1 + lse
    post_mask = (torch.logaddexp(q_mask_row - lse + log_1m_ct_ct_p,
                                 log_ct_ct_p)
                 + log_qt1_mask_row[:, None, :] + lse)
    post = torch.cat([post, post_mask], dim=1)                  # (B, K, L)
    return torch.clamp(post, LOG_CLAMP, 0.0)


def _guided_log_x_recon(logits2: torch.Tensor, guidance_scale: float,
                        batch_size: int) -> torch.Tensor:
    """CFG combine from the batched-2B denoiser logits -> (B, K-1, L)."""
    log_pred = torch.log_softmax(logits2.float(), dim=1)
    log_pred = torch.clamp(log_pred, LOG_CLAMP, 0.0)
    if logits2.shape[0] == batch_size:       # guidance ~ 1: single branch
        return log_pred
    c, cf = log_pred[:batch_size], log_pred[batch_size:]
    log_new = cf + guidance_scale * (c - cf)
    log_new = log_new - torch.logsumexp(log_new, dim=1, keepdim=True)
    return torch.clamp(log_new, LOG_CLAMP, 0.0)


def _cfg_batch(cond_emb: Optional[torch.Tensor],
               cf_cond_emb: Optional[torch.Tensor], use_cfg: bool
               ) -> Optional[torch.Tensor]:
    """[cond; cf] stacked along the batch for one 2B denoiser call."""
    if not use_cfg or cond_emb is None:
        return cond_emb
    cf = cf_cond_emb.to(cond_emb.dtype).expand_as(cond_emb)
    return torch.cat([cond_emb, cf], dim=0)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms, with the reference's 1e-30 guards."""
    return -torch.log(-torch.log(u + 1e-30) + 1e-30)


@torch.no_grad()
def sample_fused(generator: torch.Generator, sched: D3PMSchedule,
                 denoise_fn: DenoiseFn, cond_emb: Optional[torch.Tensor],
                 cf_cond_emb: Optional[torch.Tensor], batch_size: int,
                 seq_len: int, guidance_scale: float = 2.0,
                 sample: bool = True) -> torch.Tensor:
    """Token-space reverse process with the analytic posterior: the plain
    oracle every sampler route is posterior-equivalent to. ``sample=False``
    takes the posterior's argmax in place of the Gumbel-max draw. The
    uniforms come from ``generator`` on its own device. Returns (B, L)."""
    K = sched.num_classes
    T = sched.num_timesteps
    device = sched.device
    tokens = torch.full((batch_size, seq_len), K - 1, dtype=torch.long,
                        device=device)                           # all MASK
    use_cfg = abs(guidance_scale - 1.0) >= 1e-3
    cond2 = _cfg_batch(cond_emb, cf_cond_emb, use_cfg)
    nb = 2 * batch_size if use_cfg else batch_size
    for t in range(T - 1, -1, -1):
        x2 = torch.cat([tokens, tokens], dim=0) if use_cfg else tokens
        t2 = torch.full((nb,), t, dtype=torch.long, device=device)
        logits2 = denoise_fn(x2, cond2, t2)
        log_x_recon = _guided_log_x_recon(logits2, guidance_scale,
                                          batch_size)
        post = _analytic_posterior(sched, log_x_recon, tokens, t)
        if sample:
            u = torch.rand(post.shape, generator=generator,
                           device=generator.device).to(device)
            post = post + gumbel(u)
        tokens = torch.argmax(post, dim=1)
    return tokens


# ---------------------------------------------------------------------------
# the log-onehot samplers
# ---------------------------------------------------------------------------

class Draws:
    """The random draws of the log-onehot samplers, from ``generator`` on
    its own device: (B, K, L) uniforms for each Gumbel-max draw, and the
    seed of each host-side position choice of the token-budget sampler
    (numpy's ``default_rng``, as the JAX package seeds it). A test hands
    the samplers another source (the JAX package's draws) by overriding
    both methods."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape: tuple, device: torch.device) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device).to(device)

    def seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.generator,
                                 device=self.generator.device))


def _categorical(draws: Draws, logits: torch.Tensor, num_classes: int,
                 sample: bool) -> torch.Tensor:
    """Gumbel-max over axis 1 with ``draws``' uniforms, or with ``sample``
    off the argmax; -> log-onehot."""
    if not sample:
        return index_to_log_onehot(torch.argmax(logits, dim=1), num_classes)
    return log_sample_categorical(draws.uniform(logits.shape, logits.device),
                                  logits, num_classes)


def default_n_sample(num_timesteps: int, prior_ps: int = 1024) -> list[int]:
    """The reference's token budgets a step (sized for 1024-token grids)."""
    if num_timesteps == 100:
        if prior_ps <= 10:
            return [1, 6] + [11, 10, 10] * 32 + [11, 15]
        return [1, 10] + [11, 10, 10] * 32 + [11, 11]
    if num_timesteps == 50:
        return [10] + [21, 20] * 24 + [30]
    if num_timesteps == 25:
        return [21] + [41] * 23 + [60]
    if num_timesteps == 10:
        return [69] + [102] * 8 + [139]
    if num_timesteps == 200:
        return [1, 3] + [6, 6, 4, 4] * 49 + [6, 9]
    return [prior_ps] * num_timesteps


def token_budget(num_timesteps: int, seq_len: int, prior_ps: int = 1024
                 ) -> list[int]:
    """:func:`default_n_sample` rescaled so that the budgets sum to about
    ``seq_len`` (each at least 1), as the JAX package's
    ``sample_with_token_budget`` rescales it."""
    table = default_n_sample(num_timesteps, prior_ps)
    scale = seq_len / float(sum(table))
    return [max(1, round(n * scale)) for n in table]


def _mask_start_state(batch_size: int, num_classes: int, seq_len: int,
                      device: torch.device) -> torch.Tensor:
    """The all-MASK log-onehot start, log([0, ..., 0, 1])."""
    state = torch.zeros((batch_size, num_classes, seq_len), device=device)
    state[:, -1] = 1.0
    return torch.log(state)


@torch.no_grad()
def sample(generator: Optional[torch.Generator], sched: D3PMSchedule,
           denoise_fn: DenoiseFn, cond_emb: Optional[torch.Tensor],
           cf_cond_emb: Optional[torch.Tensor], batch_size: int,
           seq_len: int, guidance_scale: float = 2.0,
           filter_ratio: float = 0.0,
           content_token: Optional[torch.Tensor] = None, sample: bool = True,
           draws: Optional[Draws] = None) -> torch.Tensor:
    """The reference's reverse process with the (B, K, L) log-onehot carry:
    p_pred then one Gumbel-max draw a step. With ``filter_ratio`` the loop
    starts at step ``int(T * filter_ratio) - 1`` from ``content_token``
    (B, L) noised to it. The draws come from ``draws`` (default
    ``Draws(generator)``); ``sample=False`` takes the argmax. Returns (B, L)
    int64."""
    draws = draws or Draws(generator)
    T, K = sched.num_timesteps, sched.num_classes
    device = sched.device
    start_step = int(T * filter_ratio)
    if start_step == 0:
        log_z = _mask_start_state(batch_size, K, seq_len, device)
        start_step = T
    else:
        if content_token is None:
            raise ValueError("sample: filter_ratio needs content_token")
        t0 = torch.full((batch_size,), start_step - 1, dtype=torch.long,
                        device=device)
        log_x_start = index_to_log_onehot(content_token.to(device), K)
        log_z = _categorical(draws, q_pred(sched, log_x_start, t0), K,
                             sample)
    for step in range(start_step - 1, -1, -1):
        t = torch.full((batch_size,), step, dtype=torch.long, device=device)
        model_log_prob, _ = p_pred(sched, denoise_fn, log_z, cond_emb,
                                   cf_cond_emb, t, guidance_scale)
        log_z = _categorical(draws, model_log_prob, K, sample)
    return log_onehot_to_index(log_z)


@torch.no_grad()
def sample_fast(generator: Optional[torch.Generator], sched: D3PMSchedule,
                denoise_fn: DenoiseFn, cond_emb: Optional[torch.Tensor],
                cf_cond_emb: Optional[torch.Tensor], batch_size: int,
                seq_len: int, guidance_scale: float = 2.0,
                skip_step: int = 1, sample: bool = True,
                draws: Optional[Draws] = None) -> torch.Tensor:
    """The strided reverse process: steps T-1, T-2-skip_step, ... and 0;
    the posterior of each step above ``skip_step`` is taken at
    ``t - skip_step``. Returns (B, L) int64."""
    draws = draws or Draws(generator)
    T, K = sched.num_timesteps, sched.num_classes
    device = sched.device
    steps = list(range(T - 1, -1, -1 - skip_step))
    if steps[-1] != 0:
        steps.append(0)
    log_z = _mask_start_state(batch_size, K, seq_len, device)
    for step in steps:
        t = torch.full((batch_size,), step, dtype=torch.long, device=device)
        log_x_recon = cf_predict_start(sched, denoise_fn, log_z, cond_emb,
                                       cf_cond_emb, t, guidance_scale)
        t_post = t - skip_step if step > skip_step else t
        model_log_prob = q_posterior(sched, log_x_recon, log_z, t_post)
        log_z = _categorical(draws, model_log_prob, K, sample)
    return log_onehot_to_index(log_z)


@torch.no_grad()
def sample_with_token_budget(generator: Optional[torch.Generator],
                             sched: D3PMSchedule, denoise_fn: DenoiseFn,
                             cond_emb: Optional[torch.Tensor],
                             cf_cond_emb: Optional[torch.Tensor],
                             batch_size: int, seq_len: int,
                             guidance_scale: float = 2.0,
                             prior_rule: int = 2, prior_weight: float = 0.0,
                             prior_ps: int = 1024, sample: bool = True,
                             draws: Optional[Draws] = None) -> torch.Tensor:
    """The reference's data-dependent sampler (Improved VQ-Diffusion's
    token budgets), a host loop: at each step it draws until every row has
    unmasked its budget (:func:`token_budget`), choosing the positions on
    the host with numpy, weighted by the model's confidence
    (``prior_rule`` 2) or uniformly (1); ``prior_rule`` 0 and the last step
    draw every position from the posterior. Returns (B, L) int64."""
    draws = draws or Draws(generator)
    T, K = sched.num_timesteps, sched.num_classes
    device = sched.device
    n_sample = token_budget(T, seq_len, prior_ps)
    log_z = _mask_start_state(batch_size, K, seq_len, device)
    mask_id = K - 1
    for step in range(T - 1, -1, -1):
        sampled = np.zeros((batch_size,), np.int64)
        fuse = 4 * T   # hang guard (a budget that cannot be reached)
        while sampled.min() < n_sample[step] and fuse > 0:
            fuse -= 1
            t = torch.full((batch_size,), step, dtype=torch.long,
                           device=device)
            model_log_prob, log_x_recon = p_pred(
                sched, denoise_fn, log_z, cond_emb, cf_cond_emb, t,
                guidance_scale)
            if step == 0 or prior_rule == 0:
                log_z = _categorical(draws, model_log_prob, K, sample)
                sampled = np.full((batch_size,), seq_len, np.int64)
                continue
            log_x_idx = log_onehot_to_index(log_z).cpu().numpy()
            if prior_rule == 1:
                score = np.ones((batch_size, seq_len), np.float32)
            else:
                s = torch.clamp(torch.exp(log_x_recon).amax(dim=1), 0.0,
                                1.0).cpu().numpy()
                score = s / (s.max(axis=1, keepdims=True) + 1e-10)
            if prior_rule != 1 and prior_weight > 0:
                w = torch.from_numpy(score).to(device)[:, None, :]
                prob = torch.softmax((1 + w * prior_weight) * log_x_recon,
                                     dim=1)
                prob = torch.clamp(torch.log(prob), LOG_CLAMP, 0.0)
            else:
                prob = log_x_recon
            out_idx = log_onehot_to_index(
                _categorical(draws, prob, K, sample)).cpu().numpy()
            out2_idx = log_x_idx.copy()
            _score = score.copy()
            if _score.sum() < 1e-6:
                _score += 1
            _score[log_x_idx != mask_id] = 0
            host_rng = np.random.default_rng(draws.seed())
            for i in range(batch_size):
                n_s = min(int(n_sample[step] - sampled[i]), prior_ps)
                if n_sample[step] - sampled[i] - n_s == 1:
                    n_s = int(n_sample[step] - sampled[i])
                if n_s <= 0:
                    continue
                p = (_score[i] / _score[i].sum() if _score[i].sum() > 0
                     else np.ones(seq_len) / seq_len)
                sel = host_rng.choice(seq_len, size=n_s, replace=False, p=p)
                out2_idx[i][sel] = out_idx[i][sel]
                sampled[i] += int((out2_idx[i] != mask_id).sum()
                                  - (log_x_idx[i] != mask_id).sum())
            log_z = index_to_log_onehot(
                torch.from_numpy(out2_idx).to(device), K)
    return log_onehot_to_index(log_z)
