"""One D3PM reverse-sampling step as a Triton kernel, and the 100-step loop.

Replaces the TPU kernel ``gif_synthesis_with_discrete_diffusion_tpu/ops/
sampler_kernel.py: _kernel`` (via ``fused_sample_step``). Per (batch row,
position): log_softmax of the cond and uncond logits over the K-1 classes,
clamped at -70 -> classifier-free guidance ``lcf + s * (lc - lcf)``,
renormalised and clamped -> the analytic absorbing-state posterior from the
10-scalar schedule row, with the MASK row handled apart -> Gumbel-max over
all K classes (the MASK row wins only if strictly greater).

What bounds it on Hopper: bytes. There is no matrix product; at the honest
shape one step reads the (2B, K-1, L) = (64, 4096, 1024) f32 logits, 1 GiB.
The design: one program per (batch row, block of ``_BLOCK_L`` positions)
loops over the class axis in masked chunks of ``_BLOCK_K`` (K = 4097 is not a
power of two, and the MASK row is index K-1 with no logit). It makes four
passes over its slab: (1) both log-softmax normalisers, (2) the CFG
renormaliser, (3) the posterior normaliser, (4) the posterior and a running
argmax that keeps the first index on ties. Each is an online log-sum-exp, so
nothing of size K is held on chip; the price is reading the logits up to
four times. The wrapper takes the denoiser's ``(2B, L, K-1)`` output through
its transposed ``(2B, K-1, L)`` view with strides, so the kernel reads along
the contiguous class axis and no 1 GiB copy is made per step.

Gumbel noise comes from Triton's Philox (``tl.rand``) with one counter per
(class, l) of a row, the MASK row included, under a key per row (the seed
in its low 32 bits, the row in its high 32 bits), so that no counter
overflows at any batch size: tokens match the TPU kernel and the plain
version in distribution, not bit for bit. ``sample=False`` takes the
argmax of the posterior; that is what the tests compare exactly.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..models.d3pm import (LOG_CLAMP, D3PMSchedule, DenoiseFn, _cfg_batch,
                           gumbel)

__all__ = ["fused_sample_step", "fused_sample_step_reference",
           "sample_tokens", "schedule_rows"]

_NEG30 = -69.07755278982137  # log(1e-30)
_BLOCK_L = 16
_BLOCK_K = 128
_NUM_WARPS = 4

# triton.language, bound by _build_kernel() at the first launch: this module
# must import where Triton is absent (the CPU runs the plain version).
tl = None


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


def fused_sample_step_reference(
        logits2: torch.Tensor, tokens: torch.Tensor, sched_row: torch.Tensor,
        seed: int, *, guidance: float, num_classes: int, sample: bool = True,
        return_posterior: bool = False):
    """Plain PyTorch version of the kernel, in the TPU kernel's order of
    clamps. Same signature as :func:`fused_sample_step`; the Gumbel noise
    comes from a ``torch.Generator`` on the logits' device seeded by
    ``seed``."""
    b, L = tokens.shape
    K = num_classes
    use_cfg = logits2.shape[0] == 2 * b
    x = logits2.float()

    def log_softmax(z):
        m = z.amax(dim=1, keepdim=True)
        lse = torch.log(torch.exp(z - m).sum(dim=1, keepdim=True)) + m
        return torch.clamp_min(z - lse, LOG_CLAMP)

    lc = log_softmax(x[:b])
    if use_cfg:
        lcf = log_softmax(x[b:])
        ln = lcf + guidance * (lc - lcf)
        m = ln.amax(dim=1, keepdim=True)
        lse = torch.log(torch.exp(ln - m).sum(dim=1, keepdim=True)) + m
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
    if return_posterior:
        return new_tokens, torch.cat([post, post_mask], dim=1)
    return new_tokens


def _sample_step_kernel(
        logits_ptr, stride_b, stride_k, stride_l, tok_ptr, sched_ptr, out_ptr,
        post_ptr, B, L, KV, seed, guidance,
        USE_CFG: "tl.constexpr", SAMPLE: "tl.constexpr",
        WRITE_POST: "tl.constexpr", BLOCK_L: "tl.constexpr",
        BLOCK_K: "tl.constexpr"):
    # Triton source: compiled by _build_kernel(); KV = K-1 valid classes,
    # the MASK class is index KV.
    pid_b = tl.program_id(0)
    offs_l = tl.program_id(1) * BLOCK_L + tl.arange(0, BLOCK_L)
    l_ok = offs_l < L
    ar_k = tl.arange(0, BLOCK_K)
    b64 = pid_b.to(tl.int64)
    # the row's Philox key: the seed's low 32 bits, the row in the high 32
    key = (b64 << 32) | (seed.to(tl.int64) & 0xFFFFFFFF)
    base_c = logits_ptr + b64 * stride_b
    base_u = logits_ptr + (b64 + B) * stride_b
    row_off = offs_l.to(tl.int64) * stride_l

    # pass 1: log-softmax normalisers of the cond / uncond logits
    m_c = tl.full((BLOCK_L,), float("-inf"), tl.float32)
    s_c = tl.zeros((BLOCK_L,), tl.float32)
    m_u = tl.full((BLOCK_L,), float("-inf"), tl.float32)
    s_u = tl.zeros((BLOCK_L,), tl.float32)
    for k0 in range(0, KV, BLOCK_K):
        offs_k = k0 + ar_k
        k_ok = offs_k < KV
        offs = row_off[:, None] + offs_k[None, :].to(tl.int64) * stride_k
        ld = l_ok[:, None] & k_ok[None, :]
        x = tl.load(base_c + offs, mask=ld, other=0.0).to(tl.float32)
        x = tl.where(k_ok[None, :], x, float("-inf"))
        m_new = tl.maximum(m_c, tl.max(x, axis=1))
        s_c = s_c * tl.exp(m_c - m_new) + tl.sum(
            tl.exp(x - m_new[:, None]), axis=1)
        m_c = m_new
        if USE_CFG:
            x = tl.load(base_u + offs, mask=ld, other=0.0).to(tl.float32)
            x = tl.where(k_ok[None, :], x, float("-inf"))
            m_new = tl.maximum(m_u, tl.max(x, axis=1))
            s_u = s_u * tl.exp(m_u - m_new) + tl.sum(
                tl.exp(x - m_new[:, None]), axis=1)
            m_u = m_new
    lse_c = tl.log(s_c) + m_c
    lse_u = tl.log(s_u) + m_u

    # pass 2: normaliser of the guided log-probs
    lse_n = tl.zeros((BLOCK_L,), tl.float32)
    if USE_CFG:
        m_n = tl.full((BLOCK_L,), float("-inf"), tl.float32)
        s_n = tl.zeros((BLOCK_L,), tl.float32)
        for k0 in range(0, KV, BLOCK_K):
            offs_k = k0 + ar_k
            k_ok = offs_k < KV
            offs = row_off[:, None] + offs_k[None, :].to(tl.int64) * stride_k
            ld = l_ok[:, None] & k_ok[None, :]
            lc = tl.maximum(
                tl.load(base_c + offs, mask=ld, other=0.0).to(tl.float32)
                - lse_c[:, None], -70.0)
            lu = tl.maximum(
                tl.load(base_u + offs, mask=ld, other=0.0).to(tl.float32)
                - lse_u[:, None], -70.0)
            ln = tl.where(k_ok[None, :], lu + guidance * (lc - lu),
                          float("-inf"))
            m_new = tl.maximum(m_n, tl.max(ln, axis=1))
            s_n = s_n * tl.exp(m_n - m_new) + tl.sum(
                tl.exp(ln - m_new[:, None]), axis=1)
            m_n = m_new
        lse_n = tl.log(s_n) + m_n

    # the schedule row and the one-hot x_t
    s0 = tl.load(sched_ptr + 0)
    s1 = tl.load(sched_ptr + 1)
    s2 = tl.load(sched_ptr + 2)
    s3 = tl.load(sched_ptr + 3)
    s4 = tl.load(sched_ptr + 4)
    s5 = tl.load(sched_ptr + 5)
    s6 = tl.load(sched_ptr + 6)
    s7 = tl.load(sched_ptr + 7)
    s8 = tl.load(sched_ptr + 8)
    s9 = tl.load(sched_ptr + 9)
    mx = tl.maximum(s0, s1)
    qt_v = mx + tl.log(tl.exp(s0 - mx) + tl.exp(s1 - mx))
    mx = tl.maximum(s3, s4)
    qt1_v = mx + tl.log(tl.exp(s3 - mx) + tl.exp(s4 - mx))
    tok = tl.load(tok_ptr + b64 * L + offs_l, mask=l_ok, other=0)
    is_mask = tok == KV

    # pass 3: normaliser of q = r - log q(x_t | x_0), with the MASK row's
    # log(1e-30) term folded in as the starting value
    m_q = tl.full((BLOCK_L,), -69.07755278982137, tl.float32)
    s_q = tl.full((BLOCK_L,), 1.0, tl.float32)
    for k0 in range(0, KV, BLOCK_K):
        offs_k = k0 + ar_k
        k_ok = offs_k < KV
        offs = row_off[:, None] + offs_k[None, :].to(tl.int64) * stride_k
        ld = l_ok[:, None] & k_ok[None, :]
        r = tl.maximum(
            tl.load(base_c + offs, mask=ld, other=0.0).to(tl.float32)
            - lse_c[:, None], -70.0)
        if USE_CFG:
            lu = tl.maximum(
                tl.load(base_u + offs, mask=ld, other=0.0).to(tl.float32)
                - lse_u[:, None], -70.0)
            r = tl.maximum(lu + guidance * (r - lu) - lse_n[:, None], -70.0)
        is_v = offs_k[None, :] == tok[:, None]
        log_qt = tl.where(is_mask[:, None], s2, tl.where(is_v, qt_v, s1))
        q = tl.where(k_ok[None, :], r - log_qt, float("-inf"))
        m_new = tl.maximum(m_q, tl.max(q, axis=1))
        s_q = s_q * tl.exp(m_q - m_new) + tl.sum(
            tl.exp(q - m_new[:, None]), axis=1)
        m_q = m_new
    lse_q = tl.log(s_q) + m_q

    # pass 4: posterior over the K-1 classes and a running (Gumbel-)argmax
    best_val = tl.full((BLOCK_L,), float("-inf"), tl.float32)
    best_idx = tl.zeros((BLOCK_L,), tl.int32)
    for k0 in range(0, KV, BLOCK_K):
        offs_k = k0 + ar_k
        k_ok = offs_k < KV
        offs = row_off[:, None] + offs_k[None, :].to(tl.int64) * stride_k
        ld = l_ok[:, None] & k_ok[None, :]
        r = tl.maximum(
            tl.load(base_c + offs, mask=ld, other=0.0).to(tl.float32)
            - lse_c[:, None], -70.0)
        if USE_CFG:
            lu = tl.maximum(
                tl.load(base_u + offs, mask=ld, other=0.0).to(tl.float32)
                - lse_u[:, None], -70.0)
            r = tl.maximum(lu + guidance * (r - lu) - lse_n[:, None], -70.0)
        is_v = offs_k[None, :] == tok[:, None]
        log_qt = tl.where(is_mask[:, None], s2, tl.where(is_v, qt_v, s1))
        log_qt1 = tl.where(is_mask[:, None], s5, tl.where(is_v, qt1_v, s4))
        a = r - log_qt - lse_q[:, None] + s6
        ma = tl.maximum(a, s7)
        post = (ma + tl.log(tl.exp(a - ma) + tl.exp(s7 - ma)) + log_qt1
                + lse_q[:, None])
        post = tl.minimum(tl.maximum(post, -70.0), 0.0)
        if WRITE_POST:
            p_offs = ((b64 * (KV + 1) + offs_k[None, :]) * L
                      + offs_l[:, None])
            tl.store(post_ptr + p_offs, post, mask=ld)
        score = post
        if SAMPLE:
            u = tl.rand(key, offs_k[None, :] * L + offs_l[:, None])
            score = post - tl.log(-tl.log(u + 1e-30) + 1e-30)
        score = tl.where(k_ok[None, :], score, float("-inf"))
        c_best = tl.max(score, axis=1)
        c_idx = tl.min(tl.where(score == c_best[:, None], offs_k[None, :],
                                2147483647), axis=1)
        upd = c_best > best_val
        best_idx = tl.where(upd, c_idx, best_idx)
        best_val = tl.where(upd, c_best, best_val)

    # the MASK row
    a = -69.07755278982137 - lse_q + s9
    mx = tl.maximum(a, s8)
    pm = (mx + tl.log(tl.exp(a - mx) + tl.exp(s8 - mx))
          + tl.where(is_mask, 0.0, -69.07755278982137) + lse_q)
    pm = tl.minimum(tl.maximum(pm, -70.0), 0.0)
    if WRITE_POST:
        tl.store(post_ptr + (b64 * (KV + 1) + KV) * L + offs_l, pm,
                 mask=l_ok)
    if SAMPLE:
        u = tl.rand(key, KV * L + offs_l)
        pm = pm - tl.log(-tl.log(u + 1e-30) + 1e-30)
    new = tl.where(pm > best_val, KV, best_idx)
    tl.store(out_ptr + b64 * L + offs_l, new.to(tl.int64), mask=l_ok)


@functools.cache
def _build_kernel():
    global tl
    import triton
    import triton.language

    tl = triton.language
    # an int argument is specialised on its value (== 1, % 16): the batch
    # and the per-step seed would otherwise compile new variants mid-run
    return triton.jit(_sample_step_kernel,
                      do_not_specialize=["seed", "B"])


def fused_sample_step(logits2: torch.Tensor, tokens: torch.Tensor,
                      sched_row: torch.Tensor, seed: int, *,
                      guidance: float, num_classes: int, sample: bool = True,
                      return_posterior: bool = False):
    """One fused reverse step.

    logits2: (B or 2B, K-1, L) f32 denoiser logits ([cond; uncond] when 2B),
    any strides (the denoiser hands over a transposed view); tokens: (B, L)
    int64 current x_t; sched_row: (10,) f32 row of :func:`schedule_rows`;
    seed: int. Returns new tokens (B, L) int64 (+ the (B, K, L) posterior if
    asked). CPU tensors take the plain version; CUDA tensors launch the
    Triton kernel and count the launch in ``fused_sample_step.launches``.
    """
    if logits2.device.type == "cpu":
        return fused_sample_step_reference(
            logits2, tokens, sched_row, seed, guidance=guidance,
            num_classes=num_classes, sample=sample,
            return_posterior=return_posterior)
    b, L = tokens.shape
    nb, kv, lg = logits2.shape
    if logits2.device.type != "cuda":
        raise ValueError(f"fused_sample_step: no kernel for {logits2.device}")
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
    if num_classes * L >= 2 ** 31:
        raise ValueError("fused_sample_step: K*L exceeds the int32 "
                         "Philox counter of a row")
    kernel = _build_kernel()
    out = torch.empty((b, L), dtype=torch.int64, device=logits2.device)
    post = (torch.empty((b, num_classes, L), dtype=torch.float32,
                        device=logits2.device) if return_posterior else out)
    grid = (b, (L + _BLOCK_L - 1) // _BLOCK_L)
    kernel[grid](
        logits2, logits2.stride(0), logits2.stride(1), logits2.stride(2),
        tokens, sched_row, out, post, b, L, kv, int(seed), float(guidance),
        USE_CFG=nb == 2 * b, SAMPLE=bool(sample),
        WRITE_POST=bool(return_posterior), BLOCK_L=_BLOCK_L,
        BLOCK_K=_BLOCK_K, num_warps=_NUM_WARPS)
    fused_sample_step.launches += 1
    return (out, post) if return_posterior else out


fused_sample_step.launches = 0


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
