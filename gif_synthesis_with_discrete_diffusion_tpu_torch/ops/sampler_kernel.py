"""One D3PM reverse-sampling step as a CUDA kernel, and the 100-step loop.

``fused_sample_step`` replaces the TPU kernel ``gif_synthesis_with_
discrete_diffusion_tpu/ops/sampler_kernel.py: _kernel`` (via
``fused_sample_step``). Per (batch row, position): log_softmax of the cond
and uncond logits over the K-1 classes, clamped at -70 -> classifier-free
guidance ``lcf + s * (lc - lcf)``, renormalised and clamped -> the analytic
absorbing-state posterior from the 10-scalar schedule row, with the MASK row
handled apart -> Gumbel-max over all K classes (the MASK row wins only if
strictly greater). For CUDA tensors it launches ``csrc/sample_step.cu``
(nvcc for ``sm_90a`` at first use, bound through ctypes), which reads the
logits from device memory once: a block holds one position's two class rows
in registers up to :data:`REGISTER_CLASSES` classes, and above that in
shared memory, or re-reads them from device memory where they do not fit
(the designs and their arithmetic: the source's header). Any K-1 runs. For
CPU tensors it runs :func:`fused_sample_step_reference`.

The wrapper takes the denoiser's ``(2B, L, K-1)`` output through its
transposed ``(2B, K-1, L)`` view with strides: the kernel needs the class
axis contiguous (any batch-row and position strides, a batch stride of 0
included) and raises on any other layout, never copying the logits.

Gumbel noise comes from Philox4x32-10 keyed by the seed, one counter per
(4 classes, position, batch row) and the MASK class on its own counter, so
that no counter wraps at any batch size: tokens match the TPU kernel and the
plain version in distribution, not bit for bit. ``sample=False`` takes the
argmax of the posterior; that is what the tests compare exactly.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from . import cuda_build
from ..models.d3pm import (LOG_CLAMP, D3PMSchedule, DenoiseFn, _cfg_batch,
                           gumbel)

__all__ = ["fused_sample_step", "fused_sample_step_reference",
           "fused_sample_step_kernel_arithmetic", "sample_tokens",
           "sample_step_design",
           "schedule_rows", "REGISTER_CLASSES", "K1_DESIGNS"]

_NEG30 = -69.07755278982137  # log(1e-30)
# the largest K-1 of the register design, 256 threads x 8 float4 a branch
# (csrc/sample_step.cu: sample_step_register_classes); above it the wide
# kernel
REGISTER_CLASSES = 8192
# where a launch keeps its rows (csrc/sample_step.cu: sample_step_design)
K1_DESIGNS = ("registers", "shared memory", "device memory")


def schedule_rows(sched: D3PMSchedule) -> torch.Tensor:
    """The (T, 10) table of per-step scalars: [ct_at, ct_bt, ct_ct, at, bt,
    ct, ct_at', ct_bt', ct_ct', 1m_ct_ct'] (primes at t-1, wrapped)."""
    T = sched.num_timesteps
    t = torch.arange(T, device=sched.device)
    tm = (t - 1 + (T + 1)) % (T + 1)
    return torch.stack([
        sched.log_cumprod_at[t], sched.log_cumprod_bt[t],
        sched.log_cumprod_ct[t], sched.log_at, sched.log_bt, sched.log_ct,
        sched.log_cumprod_at[tm], sched.log_cumprod_bt[tm],
        sched.log_cumprod_ct[tm], sched.log_1_min_cumprod_ct[tm],
    ], dim=1)


def _laddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mx = torch.maximum(a, b)
    return mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx))


def _lse(z: torch.Tensor) -> torch.Tensor:
    """log-sum-exp over the class axis: the maximum first, then the sum."""
    m = z.amax(dim=1, keepdim=True)
    return torch.log(torch.exp(z - m).sum(dim=1, keepdim=True)) + m


def _step(logits2, tokens, sched_row, seed, *, guidance, num_classes,
          sample, return_posterior, guided_from_pass0):
    """The step in the TPU kernel's order of clamps. ``guided_from_pass0``:
    the kernel's rule for the guided normaliser (from the log-sum-exp of the
    guided logits where no class reaches the clamp). Returns the step's
    result and, per (row, position), whether that rule held."""
    b, L = tokens.shape
    K = num_classes
    use_cfg = logits2.shape[0] == 2 * b
    x = logits2.float()
    zc = x[:b]
    lse_c = _lse(zc)
    lc = torch.clamp_min(zc - lse_c, LOG_CLAMP)
    free = torch.ones((b, 1, L), dtype=torch.bool, device=x.device)
    if use_cfg:
        zu = x[b:]
        lse_u = _lse(zu)
        lcf = torch.clamp_min(zu - lse_u, LOG_CLAMP)
        ln = lcf + guidance * (lc - lcf)
        lse = _lse(ln)
        if guided_from_pass0:
            free = ((zc.amin(dim=1, keepdim=True) - lse_c >= LOG_CLAMP)
                    & (zu.amin(dim=1, keepdim=True) - lse_u >= LOG_CLAMP))
            from_sums = (_lse(zu + guidance * (zc - zu))
                         - (lse_u + guidance * (lse_c - lse_u)))
            lse = torch.where(free, from_sums, lse)
        r = torch.clamp_min(ln - lse, LOG_CLAMP)
    else:
        r = lc

    (log_ct_at, log_ct_bt, log_ct_ct, log_at, log_bt, log_ct, log_ct_at_p,
     log_ct_bt_p, log_ct_ct_p, log_1m_ct_ct_p) = sched_row.float().unbind(0)
    tok = tokens[:, None, :]
    is_mask = tok == K - 1                                      # (B, 1, L)
    cls = torch.arange(x.shape[1], device=tokens.device)[None, :, None]
    is_v = cls == tok                                           # (B, K-1, L)
    log_qt = torch.where(is_mask, log_ct_ct, torch.where(
        is_v, _laddexp(log_ct_at, log_ct_bt), log_ct_bt))
    log_qt1 = torch.where(is_mask, log_ct, torch.where(
        is_v, _laddexp(log_at, log_bt), log_bt))

    q = r - log_qt
    mq = torch.clamp_min(q.amax(dim=1, keepdim=True), _NEG30)
    lse = torch.log(torch.exp(q - mq).sum(dim=1, keepdim=True)
                    + torch.exp(_NEG30 - mq)) + mq              # (B, 1, L)
    post = _laddexp(q - lse + log_ct_at_p, log_ct_bt_p) + log_qt1 + lse
    post = torch.clamp(post, LOG_CLAMP, 0.0)
    post_mask = (_laddexp(_NEG30 - lse + log_1m_ct_ct_p, log_ct_ct_p)
                 + torch.where(is_mask, 0.0, _NEG30) + lse)
    post_mask = torch.clamp(post_mask, LOG_CLAMP, 0.0)          # (B, 1, L)

    score, score_mask = post, post_mask
    if sample:
        gen = torch.Generator(device=post.device).manual_seed(int(seed))
        g = gumbel(torch.rand((b, K, L), generator=gen, device=post.device))
        score, score_mask = post + g[:, :K - 1], post_mask + g[:, K - 1:]
    best_val, best = score.max(dim=1)        # first index on ties
    new_tokens = torch.where(score_mask[:, 0] > best_val, K - 1, best)
    out = ((new_tokens, torch.cat([post, post_mask], dim=1))
           if return_posterior else new_tokens)
    return out, free[:, 0]


def fused_sample_step_reference(
        logits2: torch.Tensor, tokens: torch.Tensor, sched_row: torch.Tensor,
        seed: int, *, guidance: float, num_classes: int, sample: bool = True,
        return_posterior: bool = False):
    """Plain PyTorch version of the kernel, in the TPU kernel's order of
    clamps. Same signature as :func:`fused_sample_step`; the Gumbel noise
    comes from a ``torch.Generator`` on the logits' device seeded by
    ``seed``."""
    return _step(logits2, tokens, sched_row, seed, guidance=guidance,
                 num_classes=num_classes, sample=sample,
                 return_posterior=return_posterior,
                 guided_from_pass0=False)[0]


def fused_sample_step_kernel_arithmetic(
        logits2: torch.Tensor, tokens: torch.Tensor, sched_row: torch.Tensor,
        seed: int, *, guidance: float, num_classes: int, sample: bool = True,
        return_posterior: bool = False):
    """:func:`fused_sample_step_reference` with the guided normaliser taken
    as the kernel takes it: under guidance, where neither branch has a class
    under the -70 clamp (pass 0's minima), from the log-sum-exp of the
    guided logits ``zu + g (zc - zu)`` less ``lse_u + g (lse_c - lse_u)``;
    elsewhere by the full pass. Every log-sum-exp is a maximum, then a sum.
    The noise is the plain version's. Returns the step's result and the
    (B, L) mask of the positions where the rule held. For the tests; no path
    of the port runs it."""
    return _step(logits2, tokens, sched_row, seed, guidance=guidance,
                 num_classes=num_classes, sample=sample,
                 return_posterior=return_posterior, guided_from_pass0=True)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("sample_step.cu")
    lib.fused_sample_step.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p])
    lib.fused_sample_step.restype = ctypes.c_int
    lib.sample_step_register_classes.argtypes = []
    lib.sample_step_register_classes.restype = ctypes.c_int
    lib.sample_step_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.sample_step_blocks_per_sm.restype = ctypes.c_int
    lib.sample_step_design.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sample_step_design.restype = ctypes.c_int
    if lib.sample_step_register_classes() != REGISTER_CLASSES:
        raise RuntimeError("csrc/sample_step.cu holds another K-1 in "
                           "registers than REGISTER_CLASSES")
    return lib


def sample_step_design(kv: int, guided: bool) -> str:
    """Where the card's kernel keeps rows of ``kv`` = K-1 classes: one of
    :data:`K1_DESIGNS` (the wide kernel's choice depends on the card's
    shared memory, so the library answers)."""
    design = _library().sample_step_design(int(kv), int(bool(guided)))
    if design < 0:
        raise RuntimeError("sample_step_design failed")
    return K1_DESIGNS[design]


def fused_sample_step(logits2: torch.Tensor, tokens: torch.Tensor,
                      sched_row: torch.Tensor, seed: int, *,
                      guidance: float, num_classes: int, sample: bool = True,
                      return_posterior: bool = False):
    """One fused reverse step.

    logits2: (B or 2B, K-1, L) f32 denoiser logits ([cond; uncond] when 2B),
    the class axis contiguous, any batch-row and position strides (the
    denoiser hands over a transposed view); tokens: (B, L) int64 current
    x_t; sched_row: (10,) f32 row of :func:`schedule_rows`; seed: int.
    Returns new tokens (B, L) int64 (+ the (B, K, L) posterior if asked).
    CPU tensors take the plain version; CUDA tensors launch the kernel and
    count the launch in ``fused_sample_step.launches`` and in
    ``fused_sample_step.by_classes[K-1]``, and raise on a layout or size the
    kernel does not take (a class axis that is not contiguous, B above
    65535). Any K-1 runs."""
    if logits2.device.type == "cpu":
        return fused_sample_step_reference(
            logits2, tokens, sched_row, seed, guidance=guidance,
            num_classes=num_classes, sample=sample,
            return_posterior=return_posterior)
    b, L = tokens.shape
    nb, kv, lg = logits2.shape
    if (logits2.device.type != "cuda"
            or logits2.device.index != torch.cuda.current_device()):
        raise ValueError(f"fused_sample_step: no kernel for {logits2.device}"
                         f" (the current device is "
                         f"cuda:{torch.cuda.current_device()})")
    if (tokens.device != logits2.device or sched_row.device != logits2.device):
        raise ValueError("fused_sample_step: tensors on different devices")
    if logits2.dtype != torch.float32 or sched_row.dtype != torch.float32:
        raise TypeError("fused_sample_step: logits2 and sched_row must be f32")
    if tokens.dtype != torch.int64 or not tokens.is_contiguous():
        raise TypeError("fused_sample_step: tokens must be contiguous int64")
    if not sched_row.is_contiguous() or sched_row.numel() != 10:
        raise ValueError("fused_sample_step: sched_row must be 10 contiguous")
    if kv != num_classes - 1 or lg != L or nb not in (b, 2 * b):
        raise ValueError(f"fused_sample_step: logits2 {tuple(logits2.shape)}"
                         f" does not fit tokens {tuple(tokens.shape)} and "
                         f"K={num_classes}")
    if logits2.stride(1) != 1:
        raise ValueError(f"fused_sample_step: the class axis of logits2 must "
                         f"be contiguous (strides {logits2.stride()})")
    if b > 65535:
        raise ValueError(f"fused_sample_step: B = {b} (at most 65535) is "
                         f"beyond the kernel")
    out = torch.empty((b, L), dtype=torch.int64, device=logits2.device)
    post = (torch.empty((b, num_classes, L), dtype=torch.float32,
                        device=logits2.device) if return_posterior else None)
    # 16-byte loads where every row starts on 16 bytes
    vec = (logits2.data_ptr() % 16 == 0 and logits2.stride(0) % 4 == 0
           and logits2.stride(2) % 4 == 0)
    seed = int(seed)
    err = _library().fused_sample_step(
        logits2.data_ptr(), logits2.stride(0), logits2.stride(2),
        tokens.data_ptr(), sched_row.data_ptr(), out.data_ptr(),
        None if post is None else post.data_ptr(), b, L, kv, int(nb == 2 * b),
        int(bool(sample)), int(vec), seed & 0xFFFFFFFF,
        (seed >> 32) & 0xFFFFFFFF, float(guidance),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_sample_step launch failed: cudaError "
                           f"{err}")
    fused_sample_step.launches += 1
    fused_sample_step.by_classes[kv] += 1
    return (out, post) if return_posterior else out


fused_sample_step.launches = 0
fused_sample_step.by_classes = collections.Counter()


@torch.no_grad()
def sample_tokens(generator: torch.Generator, sched: D3PMSchedule,
                  denoise_fn: DenoiseFn, cond_emb: Optional[torch.Tensor],
                  cf_cond_emb: Optional[torch.Tensor], batch_size: int,
                  seq_len: int, guidance_scale: float = 2.0,
                  sample: bool = True) -> torch.Tensor:
    """Full reverse process, each step's posterior and draw in one
    :func:`fused_sample_step`. The per-step seeds are drawn up front from
    ``generator`` (a CPU generator), so the loop never waits on the device.
    ``sample=False`` takes argmax in place of Gumbel-max. Returns (B, L)."""
    K = sched.num_classes
    T = sched.num_timesteps
    device = sched.device
    tokens = torch.full((batch_size, seq_len), K - 1, dtype=torch.int64,
                        device=device)
    rows = schedule_rows(sched)
    seeds = torch.randint(0, 2 ** 31 - 1, (T,), generator=generator).tolist()
    use_cfg = abs(guidance_scale - 1.0) >= 1e-3
    cond2 = _cfg_batch(cond_emb, cf_cond_emb, use_cfg)
    nb = 2 * batch_size if use_cfg else batch_size
    for seed, t in zip(seeds, range(T - 1, -1, -1)):
        x2 = torch.cat([tokens, tokens], dim=0) if use_cfg else tokens
        t2 = torch.full((nb,), t, dtype=torch.int64, device=device)
        logits2 = denoise_fn(x2, cond2, t2)
        tokens = fused_sample_step(logits2, tokens, rows[t], seed,
                                   guidance=guidance_scale, num_classes=K,
                                   sample=sample)
    return tokens
