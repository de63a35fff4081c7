"""D3PM core: absorbing+uniform discrete diffusion in log space (sampling).

Port of the sampling part of ``gif_synthesis_with_discrete_diffusion_tpu/
models/d3pm.py``: the linear schedule (computed in float64 numpy, stored as
float32 tensors), the analytic posterior of a one-hot ``x_t``, the
classifier-free-guidance combine, and ``sample_fused``, the plain full-loop
oracle every sampler route must be posterior-equivalent to.

The reference's quirks are kept, not fixed: the ``-70`` clamp, the
``1e-30`` one-hot floor and the ``(t - 1 + (T + 1)) % (T + 1)`` wrap that
makes index ``T`` of the cumulative buffers the identity transition.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["LOG_CLAMP", "D3PMSchedule", "alpha_schedule", "make_schedule",
           "sample_fused"]

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
