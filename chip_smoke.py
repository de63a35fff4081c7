#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one line each:
  1. the card (nvidia-smi name and power limit), the torch / CUDA / Triton
     versions, TF32 off, and the build of the CUDA kernel from ``csrc/``;
  2. the Triton sampler-step kernel (K1) against its plain version, then
     both timed at the main path's shape;
  3. the CUDA attention kernel (K2) against its plain version, then both
     timed at the main path's shapes;
  4. the slice at ``HONEST``: a small argmax run held against the same run
     on the CPU, a B=4 warm-up, then the bench's B=32 batch (label
     conditioning, 100 steps, CFG 2, sampled) and its decode, with the
     launch counts of both kernels.
Then one JSON line of the kernels, and the last line
``{"ok": true, "device": {...}}``. Any failure raises: there is no CPU run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
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
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import attention
    t0 = time.perf_counter()
    lib = attention._library()
    print(f"phase 1: built csrc/fused_mha_fwd.cu in {lib.build_seconds:.2f} "
          f"s (load {time.perf_counter() - t0:.2f} s); nvcc: "
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
         "launches": launches["K2"], "max_abs_err": err_k2,
         "ms": ms_k2, "plain_ms": plain_ms_k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
