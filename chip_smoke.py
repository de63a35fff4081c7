#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

    python3 chip_smoke.py --profile   # and a torch.profiler table of
                                      # one training step

Phases:
  1. the card (nvidia-smi name and power limit), the torch / CUDA / Triton
     versions, TF32 off, and the builds of the three CUDA sources under
     ``csrc/`` (one nvcc each, started together);
  2. the Triton sampler-step kernel (K1) against its plain version, then
     both timed at the main path's shape;
  3. the CUDA attention kernel (K2) against its plain version, then both
     timed at the main path's shapes;
  4. the serving slice at ``HONEST``: a small argmax run held against the
     same run on the CPU, a B=4 warm-up, then the bench's B=32 batch (label
     conditioning, 100 steps, CFG 2, sampled) and its decode, with the
     launch counts of K1 and K2;
  5. the CUDA attention backward (K5) against its plain version through
     the autograd Function, then both timed at the training step's shapes;
  6. the CUDA codebook lookup (K6) against its plain version, then both
     timed at the frozen encode's shape;
  7. the training slice at ``TRAIN_STEP2``: a small step held against the
     same step on the CPU, then B=16 steps (2 warm-up, 5 timed) on a fixed
     synthetic batch, with the launch counts of K2, K5 and K6 per step.
Then one JSON line of the kernels (``launches``: K1 from the serving run,
K2 from the serving and the timed training runs, K5 and K6 from the timed
training run), and the last line ``{"ok": true, "device": {...}}``. Any
failure raises: there is no CPU run.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "gif_synthesis_with_discrete_diffusion_tpu_torch"

# the posterior tolerance of tests/test_sampler_kernel.py (the TPU kernel
# against its jnp oracle); the argmax token must agree wherever the plain
# posterior's top-two margin exceeds it
K1_TOL = 1e-4
# f32 attention: the rtol = atol of tests/test_attention_kernel.py
K2_TOL = 2e-4
# the small slice against the CPU run: f32 decode, cuDNN without TF32
VIDEO_TOL = 2e-4
# f32 attention gradients: the rtol = atol of tests/test_attention_kernel.py
K5_TOL = 5e-4
# K6: indices must equal the plain version's wherever its top-two distance
# margin exceeds K6_MARGIN (f32 sums in another order); the statistics must
# match the plain ones recomputed from the kernel's own indices (atomics add
# in no fixed order)
K6_MARGIN = 1e-3
K6_TOL = 1e-4
# the small training step on the card against the CPU: loss (relative) and
# each gradient against its tensor's max-abs, floored at 1e-4 of the largest
# gradient (a key bias's gradient is zero analytically)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3


def _time_ms(fn, iters: int) -> float:
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _ab_ms(plain, kernel, iters: int) -> tuple[float, float]:
    """Plain, kernel, kernel, plain in one process: (kernel_ms, plain_ms)."""
    p1 = _time_ms(plain, iters)
    k1 = _time_ms(kernel, iters)
    k2 = _time_ms(kernel, iters)
    p2 = _time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_environment(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    import triton
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"triton {triton.__version__}, python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 1: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        attention, codebook_kernel)
    builds = {"fused_mha_fwd.cu": attention._library,
              "fused_mha_bwd.cu": attention._bwd_library,
              "nearest_code_stats.cu": codebook_kernel._library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(lambda f: f(), builds.values())))
    print(f"phase 1: built {len(libs)} CUDA sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"phase 1: csrc/{name}: nvcc {lib.build_seconds:.2f} s; "
              + " | ".join(x.strip() for x in lib.build_log.splitlines()
                           if "registers" in x or "spill" in x))
    return smi


def phase_k1(torch, smi: str) -> tuple[float, float, float]:
    """K1 against its plain version; returns (max-abs err, ms, plain ms)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.d3pm import (
        make_schedule)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import fused_sample_step, fused_sample_step_reference, schedule_rows

    K = 4097
    rows = schedule_rows(make_schedule(100, K, device="cuda"))
    worst = 0.0
    for B, L, guidance, t in ((4, 1024, 2.0, 99), (4, 1024, 2.0, 0),
                              (4, 1024, 1.0, 50), (4, 2304, 2.0, 50)):
        g = torch.Generator(device="cuda").manual_seed(1000 + L + t)
        nb = 2 * B if guidance != 1.0 else B
        # (nb, L, K-1) as the denoiser emits it, handed over transposed
        logits2 = (3.0 * torch.randn((nb, L, K - 1), generator=g,
                                     device="cuda")).transpose(1, 2)
        tokens = torch.randint(0, K - 1, (B, L), generator=g, device="cuda")
        masked = torch.rand((B, L), generator=g, device="cuda") < 0.5
        tokens = torch.where(masked, K - 1, tokens)
        args = (logits2, tokens, rows[t], 7)
        kw = dict(guidance=guidance, num_classes=K, return_posterior=True)
        tok_k, post_k = fused_sample_step(*args, sample=False, **kw)
        tok_p, post_p = fused_sample_step_reference(*args, sample=False, **kw)
        err = (post_k - post_p).abs().max().item()
        top2 = post_p.topk(2, dim=1).values
        decided = (top2[:, 0] - top2[:, 1]) > K1_TOL
        wrong = ((tok_k != tok_p) & decided).sum().item()
        # sampled mode: Philox and torch's generator draw other numbers, so
        # compare how often each draw lands on the posterior's argmax
        hit_k = (fused_sample_step(*args, sample=True, **kw)[0] == tok_p)
        hit_p = (fused_sample_step_reference(*args, sample=True, **kw)[0]
                 == tok_p)
        rate_k = hit_k.float().mean().item()
        rate_p = hit_p.float().mean().item()
        print(f"phase 2: K1 B={B} L={L} K={K} guidance={guidance} t={t}: "
              f"posterior max-abs {err:.3e} (tol {K1_TOL}), {wrong} token "
              f"mismatches of {int(decided.sum())} decided positions; "
              f"sampled = argmax at {rate_k:.4f} (kernel) vs {rate_p:.4f} "
              f"(plain)")
        if not err <= K1_TOL or wrong or not abs(rate_k - rate_p) < 0.05:
            raise AssertionError("K1 disagrees with its plain version")
        worst = max(worst, err)

    # timed at the main path: B=32 (2B=64 logits rows), K=4097, L=1024,
    # guidance 2, sampled
    g = torch.Generator(device="cuda").manual_seed(5)
    B, L = 32, 1024
    logits2 = torch.randn((2 * B, L, K - 1), generator=g,
                          device="cuda").transpose(1, 2)
    tokens = torch.full((B, L), K - 1, dtype=torch.int64, device="cuda")
    kw = dict(guidance=2.0, num_classes=K, sample=True)
    ms, plain_ms = _ab_ms(
        lambda: fused_sample_step_reference(logits2, tokens, rows[50], 3,
                                            **kw),
        lambda: fused_sample_step(logits2, tokens, rows[50], 3, **kw), 10)
    print(f"phase 2: K1 (2B=64, K=4097, L=1024) kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms ({smi})")
    return worst, ms, plain_ms


def phase_k2(torch, smi: str) -> tuple[float, float, float]:
    """K2 against its plain version; returns (max-abs err, ms, plain ms) with
    the times of the self-attention at the main path's shape."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        fused_mha, sdpa_reference)

    worst = 0.0
    for B, Lq, Lk, C, H in ((8, 1024, 1024, 64, 16), (8, 1024, 1, 64, 16),
                            (8, 1024, 77, 64, 16), (2, 2304, 2304, 64, 16)):
        g = torch.Generator(device="cuda").manual_seed(Lq + Lk)
        q, k, v = (torch.randn((B, L, C), generator=g, device="cuda")
                   for L in (Lq, Lk, Lk))
        got = fused_mha(q, k, v, n_head=H)
        want = sdpa_reference(q, k, v, H)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"phase 3: K2 B={B} Lq={Lq} Lk={Lk} C={C} H={H}: max-abs "
              f"{err:.3e}")
        torch.testing.assert_close(got, want, rtol=K2_TOL, atol=K2_TOL)
        worst = max(worst, err)

    # timed at the main path: 2B=64 rows of 1024 tokens, 16 heads of dim 4;
    # self-attention, and cross-attention over the single label token
    g = torch.Generator(device="cuda").manual_seed(6)
    times = {}
    for name, lk in (("self", 1024), ("cross", 1)):
        q = torch.randn((64, 1024, 64), generator=g, device="cuda")
        k, v = (torch.randn((64, lk, 64), generator=g, device="cuda")
                for _ in range(2))
        times[name] = _ab_ms(lambda: sdpa_reference(q, k, v, 16),
                             lambda: fused_mha(q, k, v, n_head=16), 10)
        print(f"phase 3: K2 {name} (B=64, Lq=1024, Lk={lk}) kernel "
              f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms "
              f"({smi})")
    return (worst, *times["self"])


def phase_slice(torch, smi: str) -> dict:
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        HONEST, build_models, sample_token_grid, sample_videos)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        fused_mha)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import fused_sample_step

    # a small argmax run on the card against the same run on the CPU (the
    # plain versions), from the same seeded weights
    small = {
        "vqvae": dict(HONEST["vqvae"], n_codes=16, n_hiddens=32,
                      embedding_dim=16, n_res_layers=1, downsample=(1, 2, 2),
                      sequence_length=2, resolution=8),
        "generator": {
            "diffusion_model": {"diffusion_step": 8, "guidance_scale": 2.0,
                                "transformer": {"n_layer": 2, "n_embd": 64,
                                                "n_head": 16,
                                                "condition_dim": 32}},
            "textencoder": {"mode": "label", "n_classes": 5, "dim": 32}},
    }
    out = {}
    for dev in ("cuda", "cpu"):
        models = build_models(small, dev, torch.Generator().manual_seed(11))
        batch = {"label": torch.tensor([0, 3, 4])}
        tok = sample_token_grid(models, batch, torch.Generator().manual_seed(
            12), sample=False)
        out[dev] = (tok.cpu(), models.vqvae.decode(tok).cpu())
    same = torch.equal(out["cuda"][0], out["cpu"][0])
    verr = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    print(f"phase 4: small slice (T=8, K=17, L=32) argmax on the card vs the "
          f"CPU: tokens equal {same}, video max-abs {verr:.3e} (tol "
          f"{VIDEO_TOL})")
    if not same or not verr <= VIDEO_TOL:
        raise AssertionError("the slice on the card disagrees with the CPU")

    g = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    models = build_models(HONEST, "cuda", g)
    torch.cuda.synchronize()
    print(f"phase 4: built HONEST models in {time.perf_counter() - t0:.2f} s")
    n_classes = HONEST["generator"]["textencoder"]["n_classes"]
    steps = HONEST["generator"]["diffusion_model"]["diffusion_step"]
    n_layer = HONEST["generator"]["diffusion_model"]["transformer"]["n_layer"]
    mask_id = HONEST["vqvae"]["n_codes"]
    for b in (4, 32):
        batch = {"label": torch.randint(0, n_classes, (b,), generator=g)}
        if b == 4:   # warm-up: Triton's compile and cuDNN's choices
            fused_sample_step.launches = fused_mha.launches = 0
            t0 = time.perf_counter()
            video = sample_videos(models, batch, g)
            torch.cuda.synchronize()
            print(f"phase 4: warm-up B=4 in {time.perf_counter() - t0:.2f} s")
            launches = (fused_sample_step.launches, fused_mha.launches)
        else:
            fused_sample_step.launches = fused_mha.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = sample_token_grid(models, batch, g)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            video = models.vqvae.decode(tokens)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = (fused_sample_step.launches, fused_mha.launches)
            if not bool((tokens != mask_id).all()):
                raise AssertionError("MASK tokens left in the final grid")
            print(f"phase 4: B=32 slice {t2 - t0:.3f} s = "
                  f"{b / (t2 - t0):.3f} clips/s (sampling {t1 - t0:.3f} s, "
                  f"{(t1 - t0) / steps * 1e3:.2f} ms/step; decode "
                  f"{t2 - t1:.3f} s) on {smi}")
        expect = (steps, steps * n_layer * 2)
        print(f"phase 4: B={b} launches K1 {launches[0]}, K2 {launches[1]} "
              f"(expected {expect[0]}, {expect[1]})")
        if launches != expect:
            raise AssertionError("a kernel of the path was not launched as "
                                 "expected")
        shape = (b, 16, 64, 64, 3)
        if tuple(video.shape) != shape or not bool(video.isfinite().all()):
            raise AssertionError(f"video {tuple(video.shape)} is not a finite"
                                 f" {shape}")
    return {"K1": launches[0], "K2": launches[1]}


def phase_k5(torch, smi: str) -> tuple[float, float, float]:
    """K5 against its plain version; returns (max-abs err, ms, plain ms) with
    the times of the self-attention backward at the training step's shape."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        _fwd_kernel, fused_mha, fused_mha_bwd, fused_mha_bwd_reference)

    worst = 0.0
    for B, Lq, Lk, C, H in ((8, 1024, 1024, 64, 16), (8, 1024, 1, 64, 16),
                            (8, 1024, 77, 64, 16), (2, 2304, 2304, 64, 16)):
        g = torch.Generator(device="cuda").manual_seed(Lq + 7 * Lk)
        q, k, v = (torch.randn((B, n, C), generator=g, device="cuda")
                   .requires_grad_() for n in (Lq, Lk, Lk))
        do = torch.randn((B, Lq, C), generator=g, device="cuda")
        (fused_mha(q, k, v, n_head=H) * do).sum().backward()
        want = fused_mha_bwd_reference(q.detach(), k.detach(), v.detach(),
                                       do, H)
        torch.cuda.synchronize()
        errs = [(x.grad - w).abs().max().item()
                for x, w in zip((q, k, v), want)]
        print(f"phase 5: K5 B={B} Lq={Lq} Lk={Lk} C={C} H={H}: max-abs dq "
              f"{errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} (tol "
              f"{K5_TOL})")
        for x, w in zip((q, k, v), want):
            torch.testing.assert_close(x.grad, w, rtol=K5_TOL, atol=K5_TOL)
        worst = max(worst, *errs)

    # timed at the training step: B=16 rows of 1024 tokens, 16 heads of 4;
    # self-attention, and cross-attention over the single label token
    g = torch.Generator(device="cuda").manual_seed(8)
    times = {}
    for name, lk in (("self", 1024), ("cross", 1)):
        q, do = (torch.randn((16, 1024, 64), generator=g, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn((16, lk, 64), generator=g, device="cuda")
                for _ in range(2))
        o, lse = _fwd_kernel(q, k, v, 16, with_lse=True)
        times[name] = _ab_ms(
            lambda: fused_mha_bwd_reference(q, k, v, do, 16),
            lambda: fused_mha_bwd(q, k, v, o, lse, do, n_head=16), 10)
        print(f"phase 5: K5 {name} (B=16, Lq=1024, Lk={lk}) kernel "
              f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms "
              f"({smi})")
    return (worst, *times["self"])


def phase_k6(torch, smi: str) -> tuple[float, float, float]:
    """K6 against its plain version; returns (max-abs err of the statistics,
    ms, plain ms) at the frozen encode's shape."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
        import (code_stats_reference, nearest_code_stats,
                nearest_code_stats_reference)

    worst = 0.0
    for n, k, d in ((16384, 4096, 128), (10007, 3001, 128)):
        g = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((n, d), generator=g, device="cuda")
        emb = torch.randn((k, d), generator=g, device="cuda")
        idx, n_total, encode_sum = nearest_code_stats(x, emb)
        ref_idx = nearest_code_stats_reference(x, emb)[0]
        dist = -2.0 * (x @ emb.t()) + (emb * emb).sum(dim=-1)[None, :]
        top2 = (-dist).topk(2, dim=1).values
        decided = (top2[:, 0] - top2[:, 1]) > K6_MARGIN
        want_n, want_sum = code_stats_reference(x, idx, k)
        torch.cuda.synchronize()
        wrong = int(((idx != ref_idx) & decided).sum())
        err = max((n_total - want_n).abs().max().item(),
                  (encode_sum - want_sum).abs().max().item())
        print(f"phase 6: K6 N={n} K={k} D={d}: {wrong} index mismatches of "
              f"{int(decided.sum())} decided rows ({int((idx != ref_idx).sum())}"
              f" in all), statistics max-abs {err:.3e} (tol {K6_TOL})")
        if wrong:
            raise AssertionError("K6 disagrees with its plain version")
        torch.testing.assert_close(n_total, want_n, rtol=0, atol=0)
        torch.testing.assert_close(encode_sum, want_sum, rtol=K6_TOL,
                                   atol=K6_TOL)
        worst = max(worst, err)

    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((16384, 128), generator=g, device="cuda")
    emb = torch.randn((4096, 128), generator=g, device="cuda")
    ms, plain_ms = _ab_ms(lambda: nearest_code_stats_reference(x, emb),
                          lambda: nearest_code_stats(x, emb), 10)
    print(f"phase 6: K6 (N=16384, K=4096, D=128) kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms ({smi})")
    return worst, ms, plain_ms


def _small_train_config() -> dict:
    return {
        "vqvae": {"embedding_dim": 16, "n_codes": 16, "n_hiddens": 32,
                  "n_res_layers": 1, "downsample": (1, 2, 2),
                  "sequence_length": 2, "resolution": 8},
        "generator": {
            "diffusion_model": {"diffusion_step": 8,
                                "transformer": {"n_layer": 2, "n_embd": 64,
                                                "n_head": 16,
                                                "condition_dim": 32}},
            "textencoder": {"mode": "label", "n_classes": 5, "dim": 32}},
    }


def _counts() -> tuple[int, int, int]:
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        attention, codebook_kernel)
    return (attention.fused_mha.launches, attention.fused_mha_bwd.launches,
            codebook_kernel.nearest_code_stats.launches)


def _reset_counts() -> None:
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        attention, codebook_kernel)
    attention.fused_mha.launches = attention.fused_mha_bwd.launches = 0
    codebook_kernel.nearest_code_stats.launches = 0


def phase_train(torch, smi: str, profile: bool) -> dict:
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
        TRAIN_STEP2, TRAIN_STEP2_BATCH, build_stage2, synthetic_batch,
        train_step)

    # a small step on the card against the same step on the CPU (the plain
    # versions), from the same seeded weights and the same draws
    small = _small_train_config()
    batch = synthetic_batch(small, 3, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    draws = dict(t=torch.tensor([0, 5, 5]), pt=torch.full((3,), 0.125),
                 noise=torch.rand((3, 17, 32), generator=g))
    out = {}
    for dev in ("cuda", "cpu"):
        state = build_stage2(small, dev, torch.Generator().manual_seed(0))
        loss = float(train_step(state, batch, **draws)["total"])
        out[dev] = (loss, {n: p.grad.cpu() for n, p in
                           state.generator.named_parameters()
                           if p.grad is not None})
    floor = 1e-4 * max(float(w.abs().max()) for w in out["cpu"][1].values())
    gerr = max(float((out["cuda"][1][n] - w).abs().max())
               / max(float(w.abs().max()), floor)
               for n, w in out["cpu"][1].items())
    lerr = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    print(f"phase 7: small training step (T=8, K=17, L=32, B=3) on the card "
          f"vs the CPU: loss {out['cuda'][0]:.6f} vs {out['cpu'][0]:.6f} "
          f"(relative {lerr:.3e}, tol {TRAIN_LOSS_RTOL}); gradients within "
          f"{gerr:.3e} of their max-abs (tol {TRAIN_GRAD_TOL})")
    if not lerr <= TRAIN_LOSS_RTOL or not gerr <= TRAIN_GRAD_TOL:
        raise AssertionError("the training step on the card disagrees with "
                             "the CPU")

    t0 = time.perf_counter()
    state = build_stage2(TRAIN_STEP2, "cuda", torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    n_layer = TRAIN_STEP2["generator"]["diffusion_model"]["transformer"][
        "n_layer"]
    b = TRAIN_STEP2_BATCH
    print(f"phase 7: built TRAIN_STEP2 in {time.perf_counter() - t0:.2f} s; "
          f"{sum(p.numel() for p in state.generator.parameters())} trained "
          f"parameters")
    batch = synthetic_batch(TRAIN_STEP2, b, torch.Generator().manual_seed(1))
    batch = {k: v.to("cuda") for k, v in batch.items()}
    frozen = {k: v.clone() for k, v in state.vqvae.state_dict().items()}
    g = torch.Generator(device="cuda").manual_seed(2)
    expect = (2 * n_layer, 2 * n_layer, 1)
    losses, seconds, total = [], [], (0, 0, 0)
    torch.cuda.reset_peak_memory_stats()
    for i in range(7):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        values = train_step(state, batch, g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _counts()
        if counts != expect:
            raise AssertionError(f"step {i}: launches K2, K5, K6 {counts}, "
                                 f"expected {expect}")
        loss = float(values["total"])
        print(f"phase 7: TRAIN_STEP2 B={b} step {i} "
              f"({'warm-up' if i < 2 else 'timed'}): {dt:.4f} s, loss "
              f"{loss:.6f}, acc {float(values['diffusion_acc']):.4f}, "
              f"launches K2 {counts[0]}, K5 {counts[1]}, K6 {counts[2]}")
        if not math.isfinite(loss):
            raise AssertionError("the training loss is not finite")
        if i >= 2:
            losses.append(loss)
            seconds.append(dt)
            total = tuple(a + c for a, c in zip(total, counts))
    per_step = sum(seconds) / len(seconds)
    print(f"phase 7: TRAIN_STEP2 B={b}: {per_step:.4f} s/step = "
          f"{1 / per_step:.3f} steps/s over {len(seconds)} timed steps "
          f"(min {min(seconds):.4f}, max {max(seconds):.4f}); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{smi}")
    for k, v in state.vqvae.state_dict().items():
        if not torch.equal(v, frozen[k]):
            raise AssertionError(f"the frozen VQ-VAE changed: {k}")
    drawn = float(state.generator.diffusion.lt_count.sum())
    print(f"phase 7: frozen VQ-VAE bitwise unchanged; Lt count sums to "
          f"{drawn:.0f} = {b} x {state.step} steps")
    if drawn != b * state.step:
        raise AssertionError("the Lt count does not add up to the steps")
    if profile:
        _profile_step(torch, state, batch, g)
    return {"K2": total[0], "K5": total[1], "K6": total[2]}


def _profile_step(torch, state, batch, generator) -> None:
    """Where a training step's time goes. First CUDA events between the
    parts of ``train_step``'s body (unprofiled, 3 steps): the device time of
    the frozen encode, the forward with the loss, the backward and Adam.
    Then torch.profiler over 2 steps: device time by kernel, and the
    device's busy share of the (profiled) wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage2
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.metrics import (
        weighted_losses)

    parts = ("encode", "forward + loss", "backward", "adam")
    steps = 3
    part_ms = dict.fromkeys(parts, 0.0)
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        flat = stage2.encode_tokens(state, batch["video"])
        ev[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        out = state.generator(batch, flat, generator=generator, train=True)
        total = weighted_losses(state.loss_dict, {"losses": out["loss"]})[0]
        ev[2].record()
        total.backward()
        ev[3].record()
        state.optimizer.step()
        ev[4].record()
        torch.cuda.synchronize()
        for i, name in enumerate(parts):
            part_ms[name] += ev[i].elapsed_time(ev[i + 1]) / steps
    print("phase 7 profile: device ms/step by part (CUDA events, mean of "
          f"{steps} steps): " + ", ".join(
              f"{n} {t:.2f}" for n, t in part_ms.items())
          + f"; sum {sum(part_ms.values()):.2f}")

    steps = 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            stage2.train_step(state, batch, generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.device_time_total
            k[1] += 1
    device_us = sum(k[0] for k in kernels.values())
    print(f"phase 7 profile: {steps} steps, wall {wall * 1e3 / steps:.2f} "
          f"ms/step (profiled), device kernels {device_us / 1e3 / steps:.2f} "
          f"ms/step = {100 * device_us / 1e6 / wall:.1f} % busy")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]
                                )[:25]:
        print(f"phase 7 profile: {us / 1e3 / steps:8.3f} ms/step "
              f"{100 * us / device_us:5.1f} % {n // steps:5d} calls/step  "
              f"{name[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / PKG / "_build" / "triton"))
    smi = phase_environment(torch)
    err_k1, ms_k1, plain_ms_k1 = phase_k1(torch, smi)
    err_k2, ms_k2, plain_ms_k2 = phase_k2(torch, smi)
    launches = phase_slice(torch, smi)
    err_k5, ms_k5, plain_ms_k5 = phase_k5(torch, smi)
    err_k6, ms_k6, plain_ms_k6 = phase_k6(torch, smi)
    train = phase_train(torch, smi, "--profile" in sys.argv[1:])
    kernels = [
        {"name": "fused_sample_step", "route": "triton",
         "source": f"{PKG}/ops/sampler_kernel.py",
         "replaces": "gif_synthesis_with_discrete_diffusion_tpu/ops/"
                     "sampler_kernel.py:33",
         "launches": launches["K1"], "max_abs_err": err_k1,
         "ms": ms_k1, "plain_ms": plain_ms_k1},
        {"name": "fused_mha_fwd", "route": "cuda",
         "source": f"{PKG}/csrc/fused_mha_fwd.cu",
         "replaces": "gif_synthesis_with_discrete_diffusion_tpu/ops/"
                     "attention.py:70",
         "launches": launches["K2"] + train["K2"], "max_abs_err": err_k2,
         "ms": ms_k2, "plain_ms": plain_ms_k2},
        {"name": "fused_mha_bwd", "route": "cuda",
         "source": f"{PKG}/csrc/fused_mha_bwd.cu",
         "replaces": "gif_synthesis_with_discrete_diffusion_tpu/ops/"
                     "attention.py:114",
         "launches": train["K5"], "max_abs_err": err_k5,
         "ms": ms_k5, "plain_ms": plain_ms_k5},
        {"name": "nearest_code_stats", "route": "cuda",
         "source": f"{PKG}/csrc/nearest_code_stats.cu",
         "replaces": "gif_synthesis_with_discrete_diffusion_tpu/ops/"
                     "codebook_kernel.py:56",
         "launches": train["K6"], "max_abs_err": err_k6,
         "ms": ms_k6, "plain_ms": plain_ms_k6},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
