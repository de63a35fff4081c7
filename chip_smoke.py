#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

    python3 chip_smoke.py --profile   # and a torch.profiler table of a
                                      # training step of each stage and
                                      # of the text step
    python3 chip_smoke.py --parent ROOT   # and K1, K6, P1, P2 and P3 timed
                                          # in turns with the checkout at
                                          # ROOT

Phases:
  1. the card (nvidia-smi name and power limit), the torch / CUDA
     versions, TF32 off, and the builds of the seven CUDA sources under
     ``csrc/`` (one nvcc each, started together), with each kernel's
     registers and spills and the blocks of K1 an SM holds;
  2. the CUDA sampler-step kernel (K1) against its plain version (K = 4097,
     2049, 4094, 10, 2501 and 5001, logits wide enough to put classes under the -70
     clamp; also at B=228 on the 2304-token grid, past 2^31 Philox
     counters, and its draws over 512 rows, past 2^32, against a noise that
     repeats), its refusals, then both timed at the main path's shape, with
     the bound, the exponential floor and, with ``--parent ROOT``, the
     kernel of the checkout at ROOT in turns
     (``probes/sampler_codebook_variants.py``);
  3. the CUDA attention kernel (K2) against its plain version in f32 and
     bf16 (the paths' shapes and lengths no multiple of a tile), then both
     timed at the main path's shapes, with the library call, the bound and
     the exponential floor (the card's exponentials a second, measured);
  4. the serving slice at ``HONEST`` on the ``model`` route: a small argmax
     run held against the same run on the CPU, a B=4 warm-up, then the
     bench's B=32 batch (label conditioning, 100 steps, CFG 2, sampled) and
     its decode, with the launch counts of K1 and K2;
  5. the CUDA attention backward (K5) against its plain version through
     the autograd Function in f32 and bf16, two launches bitwise equal,
     then both timed at the training step's shapes;
  6. the CUDA codebook lookup (K6) against its plain version (the frozen
     encode's shape, a ragged one, D no multiple of 8, codes repeated in
     another E tile), then both timed at the frozen encode's shape, with
     the bound of its split-TF32 products and, with ``--parent ROOT``,
     the parent in turns as K1's;
  7. the training slice at ``TRAIN_STEP2``: a small step held against the
     same step on the CPU with an f32 and with a bf16 denoiser, then B=16
     steps of ``TRAIN_STEP2`` (bf16 denoiser compute, the bench's setting;
     2 warm-up, 5 timed) on a fixed synthetic batch, with the launch counts
     of K2, K5 (their bf16 entry points) and K6 per step; then the same
     with an f32 denoiser (the f32 entry points);
  8. the CFG-packed whole-step kernel (K3) against its plain version: one
     argmax step at the serving width (f32 and bf16 weights at B=2, and at
     the main path's own B=32, where every block of the persistent grid
     takes several work items) and at small general-cross shapes, the
     sampled classes against the plain posterior, then both timed at the
     honest B=32, and where a step's time goes;
  9. the branch-grid whole-step kernel (K4) against its plain version
     (guidance 1 at L=1024, CFG at L=2304, at B=2 and at the main path's
     B=8, L=2304), against K3 at B=32, and timed at B=8, L=2304;
 10. the serving slice on the ``megakernel`` route: a small argmax run
     against the CPU, ``HONEST`` at B=32 (a B=4 warm-up first) through K3,
     and ``MSRVTT_GRID`` (2304 tokens) at B=8 through K4, 100 steps each.
 11. the probe product (P1) against its plain version (n = 1 to 520, sizes
     no multiple of its 32 x 16 tile or of 4 among them), timed, then 25
     launches of it and of ``torch.addmm`` each captured in a CUDA graph
     and the replays timed in turns over 12 rounds (with ``--parent ROOT``,
     ROOT's P1 in turns, ``probes/probe_kernel_variants.py``); and the
     build-cache probe: two child processes in turn on one fresh build
     directory, each building and running P1 and K1; their first-call times
     and the verdict on one line;
 12. the chain kernels (P2, P3) against their plain versions at ``iters``
     <= 4 (where sum(x) is far from 0), checksums included, at the QK shape
     and at the depth-curve and packed shapes, each with its design (the
     local design, x kept in every block, or the exchange through L2); P2's
     final x bitwise the same in the first and the last block at the QK and
     packed shapes, P3's (both chains) at the QK shape; P3's design and its
     kernel's registers and spills (none allowed); both timed at the QK
     shape, with a loop of the library's products eager and replayed from a
     CUDA graph; with ``--parent ROOT``, ROOT's P2 and P3 in turns; then
     the depth / packing
     probe's three measurements, each with the share of the loop without
     products and of its synchronisation alone;
 13. stage-1 training: a small step held against the same step on the CPU
     in f32 and in bf16 compute (loss, every gradient, the codebook's new
     buffers, the running statistics), then ``TRAIN_STEP1`` (64 px, f32)
     and ``TRAIN_STEP128`` (128 px, bf16) at B=64 on a fixed synthetic
     batch: the first step (data-dependent init), 2 warm-up, 5 timed, the
     K6 launches per step, (``TRAIN_STEP1``) one more step with host
     synchronisation forbidden, and where a step's time goes (CUDA events);
 14. the log-onehot samplers (reference, with filter_ratio, fast, token
     budget) at a small size on the card against the CPU in argmax mode;
     then each of the nine rows of the package's bench entry as a child
     process (``python -m ..._torch.bench``: sampling honest / msrvtt /
     half, vqvae, train_step, train_step128, train_step2 honest and msrvtt
     (text conditioning), fvd_pipeline), its JSON line parsed and printed;
 15. text conditioning: the CLIP text tower (512 wide, 12 layers) on the
     card against the CPU; ``HONEST`` with text conditioning sampled at
     B=4 in argmax mode on the route ``auto`` takes (K3 a step, counted),
     three of its steps held against the plain whole step; then
     ``TRAIN_STEP2_MSRVTT`` (the tower inside each step, 2304 tokens, bf16
     denoiser; 2 warm-up, 3 timed) with the launches of K2, K5 and K6 per
     step (``--profile``: by part, the tower apart, and by kernel);
 16. FVD: the I3D and ResNet-50 on the card against the CPU at a small
     input and at one 224 px batch of 2, the Fréchet distance of both
     sides' I3D embeddings, then the bench's FVD pipeline (honest) in this
     process with its K3 launches counted, and one more pass timed by part
     (sampling, decode, I3D, Fréchet);
 17. the harness, in this process through ``tasks.train`` /
     ``tasks.evaluate`` on configs from the port's ``compose`` (synthetic
     datamodule, 16 frames of 64 px, CSV logging, a fresh
     ``paths.output_dir`` each): stage 1 at ``scripts/tpu/vqvae_ucf.sh``'s
     override line (full width, B=64; 2 steps, validation, the
     reconstruction FVD, the renders), stage 2 at ``ddiff_ucf.sh``'s line
     (full width, B=16, f32 denoiser) over run 1's checkpoint (its frozen
     VQ-VAE bitwise run 1's; 4 steps, steps 2-3 and the loop between them
     under ``torch.cuda.set_sync_debug_mode("error")``, validation, FVD on
     the val split through the route ``auto`` takes, the three renders),
     its resume into a second epoch (4 -> 8 steps, the restored state
     bitwise the saved one before the first new step, the Lt counts
     grown), ``tasks.evaluate`` on that run (the test split's losses and
     ``Metrics/fvd-test``), then ``python -m ..._torch.tasks train`` and
     ``python -m ..._torch.generate`` as child processes (exit 0); each
     run's wall, the step times (CUDA events against the host clock), its
     launches of every kernel and the GIFs written (none where ``imageio``
     is absent, which the phase prints);
 18. more than one GPU and activation checkpointing: (a) ``TRAIN_STEP2``
     (B=16, 1024 tokens) with ``transformer.checkpoint`` in f32 and bf16,
     its first step's loss and gradients bitwise the plain step's, K2 76
     and K5 38 a step (38 and 38 without), the step's own peak memory and
     the steps timed in turns with the plain ones; (b) two ranks on
     ``cuda:0`` over gloo (NCCL refuses two ranks on one device) against
     one rank on the same global batch (``probes/ddp_parity.py``): K6 on
     each rank's rows with its all-reduce, stage-1 steps at
     ``vqvae_ucf.sh``'s widths (B=64), stage-2 steps at ``ddiff_ucf.sh``'s
     (B=16), each with its timed steps, and argmax sampling through K3
     with the batch split, the tokens bitwise one rank's; (c) ``python -m
     ..._torch.tasks train`` (stage 1, 2 steps) as a child under
     ``torchrun``'s variables, one rank over NCCL; (d) ``python -m
     ..._torch.sweep``, a 2-trial grid of one step each at ``vqvae_ucf.sh``'s
     widths; (e) BatchNorm's training statistics (``models/vqvae.py:
     _split_free_sum``, f32 over runs of rows within a sample, then f64):
     a batch's sums equal those of its two halves added (what makes two
     ranks' statistics one rank's), within 1e-5 relative of the plain f32
     means, and their cost against those f32 means (the formula before
     data parallelism), one BatchNorm's forward and backward at the stage-1
     configurations' shapes and whole ``TRAIN_STEP1`` and ``TRAIN_STEP128``
     steps, in turns.
Then the run's wall time, one JSON line of the kernels (``launches``: K1
from the ``model`` serving run and the build-cache probe's children, K2
from that serving run and the f32 stage-2 steps, K5 from those steps, K2
and K5 in bf16 from the timed bf16 ``TRAIN_STEP2`` and
``TRAIN_STEP2_MSRVTT`` steps, K6 from the timed steps of both stages and
of the text step, K3 from the ``megakernel`` serving run, the text-
conditioned sampling and the FVD pipeline, K4 from the ``megakernel``
serving run at 2304 tokens, P1 from the build-cache probe's children, P2
and P3 from the depth / packing probe, and each kernel's launches in
phase 17's runs (K2, K5 and K6 there, K3 or K1, whichever ``auto`` took,
at least once); phase 18's checkpointed steps (K2, K5) and rank 0's launches of K2, K5,
K6 and K3 there; ``launches_by_path`` splits the
count by the run it came from, each run's counts set to 0 just before it
and read just after), and the last line ``{"ok": true, "device": {...}}``.
Any failure raises: there is no CPU run.
"""
from __future__ import annotations

import argparse
import copy
import functools
import importlib
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from gif_synthesis_with_discrete_diffusion_tpu_torch.roofline import (
    PEAK_BF16, PEAK_BYTES, PEAK_F32, PEAK_TF32, bound as _bound, card,
    megakernel_work as _megakernel_work)

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
# the small stage-1 step on the card against the CPU: the loss and the
# gradients as the stage-2 step above; the codebook's new buffers and the
# BatchNorm running statistics against each tensor's max-abs
STAGE1_STATE_TOL = 1e-4
# the small bf16 step of each stage on the card against the CPU: the bound
# the CPU tests hold the port's bf16 steps to against the JAX package's
# (one fifth of the 0.05 bf16-vs-f32 drift of tests/test_denoiser.py); the
# loss relative to its size, each gradient against the largest gradient,
# each buffer against its tensor's max-abs
BF16_TRAIN_TOL = 0.05 / 5
# ... but the stage-1 step's gradients pass five BatchNorms on the batch
# statistics of a B=2 clip, which magnify every rounding: bf16 moves them
# 0.098 of the largest gradient from the f32 step (the stage-2 step's
# 0.0027), so there the card's bf16 gradients are held to this share of
# the bf16-vs-f32 drift of the same step, measured on the CPU in the run
BF16_STAGE1_GRAD_SHARE = 0.5
# K3 / K4: the final hidden state against the plain version's, relative to
# its max-abs (f32 sums in another order; a value that lands on the other
# side of a bf16 rounding boundary moves by one bf16 ulp), and the argmax
# tokens wherever the plain log-posterior's top-two margin exceeds MK_MARGIN
MK_HIDDEN_TOL = 2e-3
MK_MARGIN = 1e-2
# sampled classes against the plain posterior at K = 17: total variation of
# 25600 draws (sampling noise ~0.01)
MK_TV_TOL = 0.03
# the two builds of the whole-step kernels (scores shifted by their bound
# where it may be; by the exact row maximum everywhere) against each other.
# The same function, but the shifted scores round differently in f32, and a
# probability that lands on the other side of a bf16 rounding boundary moves
# by one bf16 ulp: MK_HIDDEN_TOL where every warp takes the bound at
# ordinary scores; where only some do (queries x 10: softmax rows one key
# wide, a flip moves a whole value) MK_SHIFT_MIXED_TOL; where none does the
# two builds run the same instructions: 0. Argmax tokens may differ at a
# near-tie: at most MK_SHIFT_TOKENS of them.
MK_SHIFT_MIXED_TOL = 1e-2
MK_SHIFT_TOKENS = 0.01

# P1: f32 FMA sums of 256 terms in another order than the library's
P1_TOL = 1e-4
# P2 / P3 at iters <= 4 (later x is 0 in bf16 on both sides). The products
# of bf16 values are exact; the tensor cores add them in another order than
# the plain f32 product, so a sum can land on the other side of a bf16
# rounding boundary (one ulp = 2^-8 of the element) and the flip feeds the
# next iterations. Final x: each element within 2^-6 of the plain max-abs;
# sum(x): within 2^-8 of the plain sum of |x|; each checksum entry (f32
# sums of exact products, dominated by the first iteration, which no flip
# touches) within 1e-3 of the plain checksum's max-abs.
CHAIN_X_TOL = 2.0 ** -6
CHAIN_SUM_TOL = 2.0 ** -8
CHAIN_CHECK_TOL = 1e-3

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


def _demangled(names: list[str]) -> list[str]:
    """Kernel names through the toolkit's ``cu++filt``, without their
    parameters; the mangled names where it does not run."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.cuda_build import (
        find_nvcc)
    try:
        filt = Path(find_nvcc()).with_name("cu++filt")
        out = subprocess.run([str(filt), "-p"], input="\n".join(names),
                             capture_output=True, text=True, check=True,
                             timeout=30).stdout.splitlines()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return names
    return out if len(out) == len(names) else names


def _ptxas_by_kernel(log: str) -> list[str]:
    """``-Xptxas -v``'s registers and spills of each kernel of a build."""
    rows, name, stores = [], "?", "?"
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            stores = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            rows.append((name, f"{regs.group(1)} registers, {stores} B "
                               f"spilled"))
    names = _demangled([name for name, _ in rows])
    return [f"{name} {what}" for name, (_, what) in zip(names, rows)]


def _reference_precision(torch) -> None:
    """The JAX package's arithmetic on the card: f32 products in f32 (no
    TF32, in matmuls or in cuDNN's convs), bf16 products summed in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def phase_environment(torch) -> str:
    smi = card()
    print(smi)
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    _reference_precision(torch)
    print("phase 1: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False, torch.backends.cuda."
          "matmul.allow_bf16_reduced_precision_reduction = False")
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        attention, codebook_kernel, cuda_build, megakernel, probe_kernels,
        sampler_kernel)
    builds = {"sample_step.cu": sampler_kernel._library,
              "fused_mha_fwd.cu": attention._library,
              "fused_mha_bwd.cu": attention._bwd_library,
              "nearest_code_stats.cu": codebook_kernel._library,
              "megakernel_step.cu": megakernel._library,
              "megakernel_step.cu (exact row maxima)":
                  lambda: megakernel._library(megakernel.EXACT_MAX),
              "probe_kernels.cu": probe_kernels._library,
              "exp_probe.cu": lambda: cuda_build.load("exp_probe.cu")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(lambda f: f(), builds.values())))
    print(f"phase 1: built {len(libs)} CUDA sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"phase 1: csrc/{name}: nvcc {lib.build_seconds:.2f} s; "
              + "; ".join(_ptxas_by_kernel(lib.build_log)))
    lib = libs["megakernel_step.cu"]
    print(f"phase 1: the whole-step kernels' persistent grid: "
          f"{lib.megakernel_grid_blocks(1)} blocks (K3), "
          f"{lib.megakernel_grid_blocks(0)} (K4)")
    lib = libs["sample_step.cu"]
    print("phase 1: K1 (guided, 16-byte loads) holds "
          + ", ".join(f"{lib.sample_step_blocks_per_sm(kv)} blocks an SM at "
                      f"K-1 = {kv}" for kv in (1024, 2048, 4096, 8192))
          + " (256 threads a block, one position each)")
    return smi


# K1's noise past 2^32 counters at K=4097, L=2304. One 32-bit counter over
# the flattened (b, class, l), as the kernel had before its counter was
# widened, would give (b + 455, class, l + 256) the noise of (b, class, l):
# 2^32 = 455 K L + 256
K1_WRAP_ROWS, K1_WRAP_SHIFT = divmod(2 ** 32, 4097 * 2304)
K1_RATE_TOL = 0.01


def _check_k1_noise_past_wrap(torch, seed: int = 7) -> dict:
    """K1's draws over 512 rows (B K L = 4.8e9), every row the same logits
    (a batch stride of 0) with a period of K1_WRAP_SHIFT tokens, all tokens
    masked, t = 0. Position (b, l) and (b + K1_WRAP_ROWS, l + K1_WRAP_SHIFT)
    then have the same posterior: with independent noise they agree as
    often as two independent draws, sum_k p_k^2; with noise that repeats
    after 2^32 counters, always. The rows past 2^32 counters draw the
    posterior's argmax as often as it has mass. Returns the rates and
    their expectations; raises if either misses by more than
    K1_RATE_TOL."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.d3pm import (
        make_schedule)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import fused_sample_step, fused_sample_step_reference, schedule_rows

    K, L, B = 4097, 2304, 512
    row = schedule_rows(make_schedule(100, K, device="cuda"))[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    period = 3.0 * torch.randn((1, K1_WRAP_SHIFT, K - 1), generator=g,
                               device="cuda")
    one = period.repeat(1, L // K1_WRAP_SHIFT, 1)            # (1, L, K-1)
    tokens = torch.full((B, L), K - 1, dtype=torch.int64, device="cuda")
    kw = dict(guidance=1.0, num_classes=K)
    drawn = fused_sample_step(one.expand(B, L, K - 1).transpose(1, 2),
                              tokens, row, seed, sample=True, **kw)
    _, post = fused_sample_step_reference(
        one.transpose(1, 2), tokens[:1], row, seed, sample=False,
        return_posterior=True, **kw)
    prob = post[0].double().exp()                            # (K, L)
    d, s = K1_WRAP_ROWS, K1_WRAP_SHIFT
    pair = (drawn[:B - d, :L - s] == drawn[d:, s:]).double().mean().item()
    pair_want = (prob ** 2).sum(0).mean().item()
    past = -(-2 ** 32 // (K * L))                            # first row
    hit = (drawn[past:] == prob.argmax(0)).double().mean().item()
    hit_want = prob.max(0).values.mean().item()
    out = dict(pair=pair, pair_want=pair_want, hit=hit, hit_want=hit_want,
               in_range=bool(((drawn >= 0) & (drawn < K)).all()))
    if not (out["in_range"] and abs(pair - pair_want) <= K1_RATE_TOL
            and abs(hit - hit_want) <= K1_RATE_TOL):
        raise AssertionError(f"K1's noise past 2^32 counters: {out}")
    return out


def phase_k1(torch, smi: str, parent: str | None = None) -> dict:
    """K1 against its plain version; returns its numbers for the kernels'
    line."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.d3pm import (
        make_schedule)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import (MAX_CLASSES, fused_sample_step, fused_sample_step_reference,
                fused_sample_step_kernel_arithmetic, schedule_rows)

    worst = 0.0
    # K = 2049: the half config's codebook; K-1 = 4093: no multiple of 4
    # (element loads); K = 10: under a float4 a thread; K-1 = 2500 and 5000:
    # 3 and 5 chunks of 1024 classes, rounded up to 4 and 8 (chunks of
    # padding before the last); logits of scale 30 put classes under the
    # -70 clamp (the full guided pass)
    for K, B, L, guidance, t, scale in (
            (4097, 4, 1024, 2.0, 99, 3.0), (4097, 4, 1024, 2.0, 0, 3.0),
            (4097, 4, 1024, 1.0, 50, 3.0), (4097, 4, 2304, 2.0, 50, 3.0),
            (2049, 4, 1024, 2.0, 50, 3.0), (4094, 4, 1024, 2.0, 50, 3.0),
            (10, 4, 1024, 2.0, 50, 3.0), (2501, 4, 1024, 2.0, 50, 3.0),
            (5001, 4, 1024, 2.0, 50, 3.0), (4097, 4, 1024, 2.0, 50, 30.0)):
        rows = schedule_rows(make_schedule(100, K, device="cuda"))
        g = torch.Generator(device="cuda").manual_seed(1000 + L + t + K)
        nb = 2 * B if guidance != 1.0 else B
        # (nb, L, K-1) as the denoiser emits it, handed over transposed
        logits2 = (scale * torch.randn((nb, L, K - 1), generator=g,
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
        full = int((~fused_sample_step_kernel_arithmetic(
            *args, sample=False, **kw)[1]).sum()) if nb == 2 * B else 0
        print(f"phase 2: K1 B={B} L={L} K={K} guidance={guidance} t={t} "
              f"logits x {scale}: posterior max-abs {err:.3e} (tol "
              f"{K1_TOL}), {wrong} token mismatches of {int(decided.sum())} "
              f"decided positions; sampled = argmax at {rate_k:.4f} "
              f"(kernel) vs {rate_p:.4f} (plain); {full} of {B * L} "
              f"positions take the full guided pass")
        if not err <= K1_TOL or wrong or not abs(rate_k - rate_p) < 0.05:
            raise AssertionError("K1 disagrees with its plain version")
        worst = max(worst, err)
    del logits2, post_k, post_p
    # what the kernel does not take raises, with no copy of the logits
    K = 4097
    rows = schedule_rows(make_schedule(100, K, device="cuda"))
    refused = []
    for name, logits2, k in (
            ("a class axis that is not contiguous",
             torch.zeros((8, K - 1, 64), device="cuda"), K),
            (f"K-1 = {MAX_CLASSES + 1}",
             torch.zeros((8, 64, MAX_CLASSES + 1),
                         device="cuda").transpose(1, 2), MAX_CLASSES + 2)):
        try:
            fused_sample_step(logits2, torch.zeros((4, 64), dtype=torch.int64,
                                                   device="cuda"), rows[3], 1,
                              guidance=2.0, num_classes=k)
        except ValueError:
            refused.append(name)
    print(f"phase 2: K1 refuses {'; '.join(refused)}")
    if len(refused) != 2:
        raise AssertionError("K1 took a layout or size it does not hold")

    # past 2^31 (B K L) Philox counters: B=228 at the 2304-token grid,
    # guidance 1; the plain version row by row in chunks (its temporaries
    # are (B, K, L) f32 several times over)
    B, L = 228, 2304
    g = torch.Generator(device="cuda").manual_seed(11)
    logits = torch.randn((B, L, K - 1), generator=g,
                         device="cuda").transpose(1, 2)
    tokens = torch.full((B, L), K - 1, dtype=torch.int64, device="cuda")
    kw = dict(guidance=1.0, num_classes=K)
    tok_k = fused_sample_step(logits, tokens, rows[50], 7, sample=False, **kw)
    drawn = fused_sample_step(logits, tokens, rows[50], 7, sample=True, **kw)
    wrong = decided = 0
    for r0 in range(0, B, 19):
        sl = slice(r0, r0 + 19)
        tok_p, post_p = fused_sample_step_reference(
            logits[sl], tokens[sl], rows[50], 7, sample=False,
            return_posterior=True, **kw)
        top2 = post_p.topk(2, dim=1).values
        sure = (top2[:, 0] - top2[:, 1]) > K1_TOL
        decided += int(sure.sum())
        wrong += int(((tok_k[sl] != tok_p) & sure).sum())
        del tok_p, post_p, top2, sure
    in_range = bool(((drawn >= 0) & (drawn < K)).all())
    print(f"phase 2: K1 B={B} L={L} K={K} (B K L = {B * K * L} >= 2^31): "
          f"{wrong} token mismatches of {decided} decided positions "
          f"(argmax); sampled tokens in [0, K): {in_range}")
    if wrong or not in_range:
        raise AssertionError("K1 past 2^31 counters disagrees")
    del logits, tokens, tok_k, drawn
    torch.cuda.empty_cache()
    r = _check_k1_noise_past_wrap(torch)
    print(f"phase 2: K1 B=512 L={L} K={K} (B K L = {512 * K * L} >= 2^32), "
          f"one row's logits in every row: draws at (b, l) and (b + "
          f"{K1_WRAP_ROWS}, l + {K1_WRAP_SHIFT}) agree at {r['pair']:.4f} "
          f"(independent draws: {r['pair_want']:.4f}; noise repeating after "
          f"2^32 counters: 1), rows past 2^32 draw the argmax at "
          f"{r['hit']:.4f} (its mass {r['hit_want']:.4f}); tol "
          f"{K1_RATE_TOL}")

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
    # bound: the logits read once, the tokens read and written once; no
    # matrix product (~60 f32 operations a logit for the reductions). The
    # exponential floor: 8 transcendentals a (row, class, position) at the
    # card's rate, measured now (csrc/sample_step.cu's header)
    nbytes = logits2.numel() * 4 + 2 * tokens.numel() * 8
    bound_ms, bound_by = _bound(nbytes, 60.0 * logits2.numel())
    floor_ms = 8.0 * B * (K - 1) * L / _exp_rate(torch) * 1e3
    print(f"phase 2: K1 (2B=64, K=4097, L=1024) kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB at {PEAK_BYTES / 1e12} TB/s); exponential "
          f"floor {floor_ms:.4f} ms; no single library call ({smi})")
    _print_parent_turns("phase 2", "K1", parent)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


# the probe that times each kernel in turns with another checkout's
_TURN_PROBES = {"K1": "sampler_codebook_variants",
                "K6": "sampler_codebook_variants",
                "P1": "probe_kernel_variants", "P2": "probe_kernel_variants",
                "P3": "probe_kernel_variants"}


@functools.cache
def _parent_turns(parent: str, probe: str) -> dict:
    """The times of ``probe``'s kernels against those of the checkout at
    ``parent``, in turns (``probes/<probe>.py``)."""
    module = importlib.import_module(f"{PKG}.probes.{probe}")
    return module.compare(parent, rounds=1, log=lambda line: None)


def _print_parent_turns(phase: str, kernel: str, parent: str | None) -> None:
    """With ``--parent ROOT``, the kernel's times in turns with ROOT's."""
    if parent is None:
        return
    res = _parent_turns(parent, _TURN_PROBES[kernel])
    read = {side: " ".join(f"{x[kernel]:.4f}" for x in res["ms"][side])
            for side in ("change", "parent")}
    print(f"{phase}: {kernel} in turns with {parent} ({res['card']}): this "
          f"checkout {read['change']} ms, {parent} {read['parent']} ms")


# the attention kernels' cases: the paths' shapes (self-attention over
# 1024 and 2304 tokens, cross-attention over 1 and 77 condition tokens) and
# lengths that are no multiple of a tile, head dims 4 and 8
ATTN_CASES = ((8, 1024, 1024, 64, 16), (8, 1024, 1, 64, 16),
              (8, 1024, 77, 64, 16), (2, 2304, 2304, 64, 16),
              (2, 300, 300, 64, 16), (3, 257, 77, 64, 16),
              (2, 100, 33, 64, 16), (1, 100, 2304, 64, 16),
              (1, 24, 77, 64, 8), (2, 300, 300, 64, 8))


@functools.cache
def _exp_rate(torch) -> float:
    """Base-2 exponentials a second in f32 on this card, measured now
    (``probes/exp_probe.py``): the attention kernels' exponential floor."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        exp_probe)
    return exp_probe.probe()["modes"]["ex2_f32"]["exps_per_s"]


def _sdpa_backend(torch, *args) -> str:
    """The backend F.scaled_dot_product_attention takes for these inputs:
    the first of its priority order that accepts them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(*args)
            return backend.name.lower()
        except RuntimeError:
            continue
    return "none"


def _attention_bound(dtype, flops: float, nbytes_f32: float
                     ) -> tuple[float, str]:
    """The least time of an attention call: its products at the peak of
    the operands' type (f32: the CUDA cores' 67 TFLOP/s; bf16: the tensor
    cores' 989), its tensors at their element size."""
    if str(dtype) == "torch.float32":
        return _bound(nbytes_f32, flops)
    return _bound(nbytes_f32 / 2, 0.0, flops)


def _bf16_attention_case(torch, B, Lq, Lk, C, H) -> dict:
    """K2 and K5 with bf16 inputs at one case, against the plain versions
    in f32 of the same inputs. ``o32``: K2's f32 output's largest error and
    whether it lies within K2_TOL; ``o``, ``dq``, ``dk``, ``dv``: the bf16
    outputs' excess beyond their rounding (``bf16_excess``; the gradients'
    scale floored at 1e-3 of the largest, as dq and dk vanish over one
    key); ``control``: the same of the plain versions with P and dS rounded
    to bf16, which must miss BF16_EXCESS_TOL wherever there is more than one
    key; ``abs``: the bf16 outputs' largest absolute error; ``same``:
    whether two backward launches gave the same bits."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        _fwd_kernel, bf16_excess, bf16_rounded_p_reference, fused_mha,
        fused_mha_bwd, fused_mha_bwd_reference, sdpa_reference)

    g = torch.Generator(device="cuda").manual_seed(Lq + 7 * Lk)
    q, k, v, do = (torch.randn((B, n, C), generator=g, device="cuda")
                   .to(torch.bfloat16) for n in (Lq, Lk, Lk, Lq))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    o = fused_mha(qg, kg, vg, n_head=H)
    o.backward(do)
    _, lse, o32 = _fwd_kernel(q, k, v, H, with_lse=True)
    again = fused_mha_bwd(q, k, v, o32, lse, do, n_head=H)
    got = (o.detach(), qg.grad, kg.grad, vg.grad)
    if any(x.dtype != torch.bfloat16 for x in got):
        raise AssertionError("the bf16 kernels' outputs are not bf16")
    x32 = [x.float() for x in (q, k, v, do)]
    want = (sdpa_reference(*x32[:3], H), *fused_mha_bwd_reference(*x32, H))
    control = bf16_rounded_p_reference(q, k, v, do, H)
    big = max(w.abs().max().item() for w in want[1:])
    scales = [None] + [max(w.abs().max().item(), 1e-3 * big)
                       for w in want[1:]]
    names = ("o", "dq", "dk", "dv")
    out = {n: bf16_excess(x, w, sc)
           for n, x, w, sc in zip(names, got, want, scales)}
    out["control"] = {n: bf16_excess(x.bfloat16(), w, sc)
                      for n, x, w, sc in zip(names, control, want, scales)}
    out["abs"] = {n: (x.float() - w).abs().max().item()
                  for n, x, w in zip(names, got, want)}
    d32 = (o32 - want[0]).abs()
    out["o32"] = d32.max().item()
    out["o32_ok"] = bool((d32 <= K2_TOL + K2_TOL * want[0].abs()).all())
    out["same"] = all(torch.equal(x, y) for x, y in zip(got[1:], again))
    return out


def phase_k2(torch, smi: str) -> dict:
    """K2 against its plain version in f32 and bf16; returns the numbers of
    each dtype for the kernels' line, the times those of the self-attention
    at the main path's shape."""
    import torch.nn.functional as F
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        BF16_EXCESS_TOL, fused_mha, sdpa_reference)

    exp_rate = _exp_rate(torch)
    print(f"phase 3: the card takes {exp_rate:.4e} base-2 exponentials / s "
          f"in f32 (probes/exp_probe.py, this run)")
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        worst = 0.0
        for B, Lq, Lk, C, H in ATTN_CASES:
            case = f"phase 3: K2 {name} B={B} Lq={Lq} Lk={Lk} C={C} H={H}"
            if dtype == torch.bfloat16:
                r = _bf16_attention_case(torch, B, Lq, Lk, C, H)
                ctl = r["control"]["o"]
                print(f"{case}: o32 (f32) max-abs {r['o32']:.3e} (tol "
                      f"{K2_TOL} + {K2_TOL} |x|); o (bf16) beyond its "
                      f"rounding {r['o']:.3e} of its magnitude, P rounded to "
                      f"bf16 {ctl:.3e} (tol {BF16_EXCESS_TOL})")
                if not (r["o32_ok"] and r["o"] <= BF16_EXCESS_TOL) or (
                        Lk > 1 and not ctl > BF16_EXCESS_TOL):
                    raise AssertionError("K2 bf16 disagrees with its plain "
                                         "version, or the check cannot tell")
                worst = max(worst, r["abs"]["o"])
                continue
            g = torch.Generator(device="cuda").manual_seed(Lq + Lk)
            q, k, v = (torch.randn((B, L, C), generator=g, device="cuda")
                       for L in (Lq, Lk, Lk))
            got = fused_mha(q, k, v, n_head=H)
            want = sdpa_reference(q, k, v, H)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, rtol=K2_TOL, atol=K2_TOL)
            print(f"{case}: max-abs {err:.3e} (tol {K2_TOL} + {K2_TOL} |x|)")
            worst = max(worst, err)

        # timed at the main path: 2B=64 rows of 1024 tokens, 16 heads of
        # dim 4; self-attention, and cross-attention over the label token
        g = torch.Generator(device="cuda").manual_seed(6)
        times = {}
        for shape, lk in (("self", 1024), ("cross", 1)):
            q = torch.randn((64, 1024, 64), generator=g,
                            device="cuda").to(dtype)
            k, v = (torch.randn((64, lk, 64), generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            ms, plain_ms = _ab_ms(lambda: sdpa_reference(q, k, v, 16),
                                  lambda: fused_mha(q, k, v, n_head=16), 10)
            # the one library call that computes the same function
            qh, kh, vh = (x.reshape(64, -1, 16, 4).transpose(1, 2)
                          .contiguous() for x in (q, k, v))
            lib_ms = _time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh), 10)
            backend = _sdpa_backend(torch, qh, kh, vh)
            # bound: 4 B H Lq Lk d operations (QK^T and PV) against q, k, v
            # read and o written once; beside it the exponentials, one a
            # (query, key, head)
            flops = 4.0 * 64 * 16 * 1024 * lk * 4
            nbytes = 4.0 * (2 * q.numel() + 2 * k.numel())
            bound_ms, bound_by = _attention_bound(dtype, flops, nbytes)
            exp_ms = 64 * 16 * 1024 * lk / exp_rate * 1e3
            times[shape] = (ms, plain_ms, lib_ms, bound_ms, bound_by,
                            exp_ms)
            print(f"phase 3: K2 {name} {shape} (B=64, Lq=1024, Lk={lk}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"F.scaled_dot_product_attention ({backend}) "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                  f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB in "
                  f"f32), exponential floor {exp_ms:.4f} ms ({smi})")
        ms, plain_ms, lib_ms, bound_ms, bound_by, exp_ms = times["self"]
        rows[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms, exp_floor_ms=exp_ms)
    return rows


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
            12), sample=False, sampler="model")
        with torch.no_grad():
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
        if b == 4:   # warm-up: cuDNN's choices
            fused_sample_step.launches = fused_mha.launches = 0
            t0 = time.perf_counter()
            video = sample_videos(models, batch, g, sampler="model")
            torch.cuda.synchronize()
            print(f"phase 4: warm-up B=4 in {time.perf_counter() - t0:.2f} s")
            launches = (fused_sample_step.launches, fused_mha.launches)
        else:
            fused_sample_step.launches = fused_mha.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = sample_token_grid(models, batch, g, sampler="model")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.no_grad():
                video = models.vqvae.decode(tokens)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = (fused_sample_step.launches, fused_mha.launches)
            if not bool((tokens != mask_id).all()):
                raise AssertionError("MASK tokens left in the final grid")
            print(f"phase 4: B=32 slice (model route) {t2 - t0:.3f} s = "
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


def phase_k5(torch, smi: str) -> dict:
    """K5 against its plain version in f32 and bf16, and bitwise equal
    across two launches; returns the numbers of each dtype for the kernels'
    line, the times those of the self-attention backward at the training
    step's shape."""
    import torch.nn.functional as F
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        BF16_EXCESS_TOL, _fwd_kernel, fused_mha, fused_mha_bwd,
        fused_mha_bwd_reference)

    exp_rate = _exp_rate(torch)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        worst = 0.0
        for B, Lq, Lk, C, H in ATTN_CASES:
            case = f"phase 5: K5 {name} B={B} Lq={Lq} Lk={Lk} C={C} H={H}"
            if dtype == torch.bfloat16:
                r = _bf16_attention_case(torch, B, Lq, Lk, C, H)
                grads = ("dq", "dk", "dv")
                ctl = [r["control"][n] for n in grads]
                print(f"{case}: beyond their rounding dq {r['dq']:.3e}, dk "
                      f"{r['dk']:.3e}, dv {r['dv']:.3e} of their magnitude, "
                      f"P and dS rounded to bf16 " + ", ".join(
                          f"{x:.3e}" for x in ctl) + f" (tol "
                      f"{BF16_EXCESS_TOL}); two launches bitwise equal: "
                      f"{r['same']}")
                if not all(r[n] <= BF16_EXCESS_TOL for n in grads) or (
                        Lk > 1 and not min(ctl) > BF16_EXCESS_TOL):
                    raise AssertionError("K5 bf16 disagrees with its plain "
                                         "version, or the check cannot tell")
                if not r["same"]:
                    raise AssertionError("K5 is not deterministic")
                worst = max(worst, *(r["abs"][n] for n in grads))
                continue
            g = torch.Generator(device="cuda").manual_seed(Lq + 7 * Lk)
            q, k, v = (torch.randn((B, n, C), generator=g, device="cuda")
                       .requires_grad_() for n in (Lq, Lk, Lk))
            do = torch.randn((B, Lq, C), generator=g, device="cuda")
            (fused_mha(q, k, v, n_head=H) * do).sum().backward()
            want = fused_mha_bwd_reference(q.detach(), k.detach(),
                                           v.detach(), do, H)
            # a second launch on the same inputs gives the same bits
            o, lse, o32 = _fwd_kernel(q.detach(), k.detach(), v.detach(), H,
                                      with_lse=True)
            again = fused_mha_bwd(q.detach(), k.detach(), v.detach(), o32,
                                  lse, do, n_head=H)
            torch.cuda.synchronize()
            got = (q.grad, k.grad, v.grad)
            errs = [(x - w).abs().max().item() for x, w in zip(got, want)]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            for x, w in zip(got, want):
                torch.testing.assert_close(x, w, rtol=K5_TOL, atol=K5_TOL)
            print(f"{case}: max-abs dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv "
                  f"{errs[2]:.3e} (tol {K5_TOL} + {K5_TOL} |x|); two "
                  f"launches bitwise equal: {same}")
            if not same:
                raise AssertionError("K5 is not deterministic")
            worst = max(worst, *errs)

        # timed at the training step: B=16 rows of 1024 tokens, 16 heads of
        # 4; self-attention, and cross-attention over the label token
        g = torch.Generator(device="cuda").manual_seed(8)
        times = {}
        for shape, lk in (("self", 1024), ("cross", 1)):
            q, do = (torch.randn((16, 1024, 64), generator=g, device="cuda")
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn((16, lk, 64), generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            o, lse, o32 = _fwd_kernel(q, k, v, 16, with_lse=True)
            ms, plain_ms = _ab_ms(
                lambda: fused_mha_bwd_reference(q, k, v, do, 16),
                lambda: fused_mha_bwd(q, k, v, o32, lse, do, n_head=16), 10)
            # the one library call: the autograd backward of PyTorch's fused
            # attention (its forward runs outside the timed region)
            qh, kh, vh = (x.reshape(16, -1, 16, 4).transpose(1, 2)
                          .contiguous().requires_grad_() for x in (q, k, v))
            doh = do.reshape(16, -1, 16, 4).transpose(1, 2).contiguous()
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            lib_ms = _time_ms(lambda: torch.autograd.grad(
                oh, (qh, kh, vh), doh, retain_graph=True), 10)
            backend = _sdpa_backend(torch, qh.detach(), kh.detach(),
                                    vh.detach())
            # bound: five products of 2 B H Lq Lk d operations (S, dV, dP,
            # dQ, dK) against q, k, v, o, do read and dq, dk, dv written
            # once; beside it the exponentials, one a (query, key, head) in
            # each of the two kernels
            flops = 10.0 * 16 * 16 * 1024 * lk * 4
            nbytes = 4.0 * (4 * q.numel() + 4 * k.numel())
            bound_ms, bound_by = _attention_bound(dtype, flops, nbytes)
            exp_ms = 2 * 16 * 16 * 1024 * lk / exp_rate * 1e3
            times[shape] = (ms, plain_ms, lib_ms, bound_ms, bound_by,
                            exp_ms)
            print(f"phase 5: K5 {name} {shape} (B=16, Lq=1024, Lk={lk}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                  f"({backend}) autograd backward {lib_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} "
                  f"GFLOP, {nbytes / 1e6:.1f} MB in f32), exponential floor "
                  f"{exp_ms:.4f} ms ({smi})")
        ms, plain_ms, lib_ms, bound_ms, bound_by, exp_ms = times["self"]
        rows[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms, exp_floor_ms=exp_ms)
    return rows


def _check_k6_duplicates(torch, n: int, k: int, d: int) -> dict:
    """K6 where codes repeat in another E tile: codes 0-99 again at
    131-230 and codes 400-449 again at 700-749 (a tile is 128 or 256
    codes), rows drawn near codes of either set and at random. No row may
    take a second copy (the first code wins a tie, as ``jnp.argmin``), and
    every row whose top-two margin exceeds K6_MARGIN agrees with the plain
    version. Returns the counts; raises on a disagreement."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
        import nearest_code_stats, nearest_code_stats_reference

    g = torch.Generator(device="cuda").manual_seed(k + d)
    emb = torch.randn((k, d), generator=g, device="cuda")
    emb[131:231] = emb[0:100]
    emb[700:750] = emb[400:450]
    near = torch.cat([torch.arange(100), torch.arange(400, 450)]).cuda()
    pick = near[torch.randint(0, len(near), (n // 2,), generator=g,
                              device="cuda")]
    x = torch.cat([emb[pick] + 0.01 * torch.randn(
        (n // 2, d), generator=g, device="cuda"),
        torch.randn((n - n // 2, d), generator=g, device="cuda")])
    idx = nearest_code_stats(x, emb)[0].long()
    ref = nearest_code_stats_reference(x, emb)[0].long()
    dist = -2.0 * (x @ emb.t()) + (emb * emb).sum(dim=-1)[None, :]
    top2 = (-dist).topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > K6_MARGIN
    second = ((idx >= 131) & (idx < 231)) | ((idx >= 700) & (idx < 750))
    out = dict(second_copies=int(second.sum()),
               wrong=int(((idx != ref) & decided).sum()),
               first_copies=int(((idx < 100) | ((idx >= 400) & (idx < 450)))
                                .sum()))
    if out["second_copies"] or out["wrong"]:
        raise AssertionError(f"K6 with repeated codes, D={d}: {out}")
    return out


def phase_k6(torch, smi: str, parent: str | None = None) -> dict:
    """K6 against its plain version; returns its numbers for the kernels'
    line (the error is the statistics') at the frozen encode's shape."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
        import (code_stats_reference, nearest_code_stats,
                nearest_code_stats_reference)

    worst = 0.0
    # the frozen encode's shape, a ragged one, D no multiple of 8 (and of
    # 4: element copies of E), D at its limit
    for n, k, d in ((16384, 4096, 128), (10007, 3001, 128), (5000, 600, 20),
                    (3000, 700, 30), (2000, 300, 384)):
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
    for d in (128, 130):
        r = _check_k6_duplicates(torch, 3000, 1000, d)
        print(f"phase 6: K6 N=3000 K=1000 D={d}, codes repeated 131 and 300 "
              f"codes on: {r['first_copies']} rows take a repeated code's "
              f"first copy, {r['second_copies']} its second; {r['wrong']} "
              f"mismatches at decided rows")

    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((16384, 128), generator=g, device="cuda")
    emb = torch.randn((4096, 128), generator=g, device="cuda")
    ms, plain_ms = _ab_ms(lambda: nearest_code_stats_reference(x, emb),
                          lambda: nearest_code_stats(x, emb), 10)
    # bound: the distances' products as the kernel does them, three TF32
    # products a split f32 product (3 x 2 N K D at the TF32 tensor-core
    # rate), against x and E read and the indices and statistics written
    # once; beside it the f32 bound of 2 N K D outside the tensor cores
    flops = 2.0 * 16384 * 4096 * 128
    nbytes = 4.0 * (x.numel() + 2 * emb.numel() + 4096) + 8.0 * 16384
    bound_ms, bound_by = _bound(nbytes, 0.0, flops_tf32=3.0 * flops)
    f32_ms = _bound(nbytes, flops)[0]
    print(f"phase 6: K6 (N=16384, K=4096, D=128) kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} (3 x "
          f"{flops / 1e9:.2f} GFLOP at {PEAK_TF32 / 1e12} TFLOP/s TF32, "
          f"{nbytes / 1e6:.1f} MB; {f32_ms:.4f} ms for {flops / 1e9:.2f} "
          f"GFLOP at {PEAK_F32 / 1e12} TFLOP/s f32); no single library call "
          f"({smi})")
    _print_parent_turns("phase 6", "K6", parent)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _small_train_config(dtype: str = "float32") -> dict:
    return {
        "vqvae": {"embedding_dim": 16, "n_codes": 16, "n_hiddens": 32,
                  "n_res_layers": 1, "downsample": (1, 2, 2),
                  "sequence_length": 2, "resolution": 8},
        "generator": {
            "diffusion_model": {"diffusion_step": 8,
                                "transformer": {"n_layer": 2, "n_embd": 64,
                                                "n_head": 16,
                                                "condition_dim": 32,
                                                "dtype": dtype}},
            "textencoder": {"mode": "label", "n_classes": 5, "dim": 32}},
    }


def _small_train_step(torch, device, dtype: str = "float32"
                      ) -> tuple[float, dict]:
    """One stage-2 step (T=8, K=17, L=32, B=3) at the denoiser's compute
    ``dtype`` on ``device``, from seeded weights and injected draws: (loss,
    every gradient on the CPU). (The card's tests run it too.)"""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage2
    config = _small_train_config(dtype)
    batch = stage2.synthetic_batch(config, 3, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    draws = dict(t=torch.tensor([0, 5, 5]), pt=torch.full((3,), 0.125),
                 noise=torch.rand((3, 17, 32), generator=g))
    state = stage2.build_stage2(config, device,
                                torch.Generator().manual_seed(0))
    loss = float(stage2.train_step(state, batch, **draws)["total"])
    return loss, {n: p.grad.cpu() for n, p in
                  state.generator.named_parameters() if p.grad is not None}


def _compare_train_steps(got: tuple, want: tuple, bf16: bool
                         ) -> tuple[float, float]:
    """(loss, gradient) errors of a step against another: the loss
    relative; each gradient against its tensor's max-abs floored at 1e-4 of
    the largest gradient (a key bias's gradient is zero analytically) in
    f32, against the largest gradient in bf16."""
    top = max(float(w.abs().max()) for w in want[1].values())
    lerr = abs(got[0] - want[0]) / abs(want[0])
    gerr = max(float((got[1][n] - w).abs().max())
               / (top if bf16 else max(float(w.abs().max()), 1e-4 * top))
               for n, w in want[1].items())
    return lerr, gerr


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
    # versions), from the same seeded weights and the same draws, at each
    # compute dtype of the denoiser
    for dtype, ltol, gtol in (("float32", TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL),
                              ("bfloat16", BF16_TRAIN_TOL, BF16_TRAIN_TOL)):
        got = _small_train_step(torch, "cuda", dtype)
        want = _small_train_step(torch, "cpu", dtype)
        lerr, gerr = _compare_train_steps(got, want, dtype == "bfloat16")
        print(f"phase 7: small training step (T=8, K=17, L=32, B=3, {dtype} "
              f"denoiser) on the card vs the CPU: loss {got[0]:.6f} vs "
              f"{want[0]:.6f} (relative {lerr:.3e}, tol {ltol}); gradients "
              f"within {gerr:.3e} (tol {gtol})")
        if not lerr <= ltol or not gerr <= gtol:
            raise AssertionError(f"the {dtype} training step on the card "
                                 f"disagrees with the CPU")

    state, batch, g, bf16 = _timed_train2(torch, smi, TRAIN_STEP2,
                                          TRAIN_STEP2_BATCH, 7, 2)
    b = TRAIN_STEP2_BATCH
    # what D3PM.forward's "logits" (the JAX key) adds to a step: the exp of
    # the (B, K, L) log posterior, outside the autograd graph
    d3pm = state.generator.diffusion
    lp = torch.randn((b, d3pm.num_classes, d3pm.content_seq_len),
                     device="cuda")
    print(f"phase 7: D3PM.forward's logits, exp of the {tuple(lp.shape)} log "
          f"posterior: {_time_ms(lambda: lp.exp(), 10):.4f} ms a step")
    del lp
    if profile:
        _profile_step(torch, state, batch, g)
    del state
    # f32 denoiser compute stays a path of the configuration: its steps
    # launch the f32 entry points of K2 and K5
    f32_config = copy.deepcopy(TRAIN_STEP2)
    f32_config["generator"]["diffusion_model"]["transformer"]["dtype"] = \
        "float32"
    f32 = _timed_train2(torch, smi, f32_config, TRAIN_STEP2_BATCH, 7, 2)[3]
    return {"bf16": bf16, "f32": f32}


def _timed_train2(torch, smi: str, config: dict, b: int, steps: int,
                  warmup: int, phase: str = "phase 7",
                  name: str = "TRAIN_STEP2"):
    """``steps`` stage-2 steps of ``config`` at batch ``b`` on a fixed
    synthetic batch (text captions tokenized once, before the steps), the
    first ``warmup`` untimed, with the launches of K2, K5 and K6 read per
    step (38, 38, 1 at 19 layers); the frozen VQ-VAE must come out bitwise
    unchanged and the Lt counts add up. Returns (state, batch, generator,
    launches of the timed steps)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
        build_stage2, on_device, prepare_batch, synthetic_batch, train_step)
    tcfg = config["generator"]["diffusion_model"]["transformer"]
    label = f"{name} ({tcfg['dtype']} denoiser)"
    t0 = time.perf_counter()
    state = build_stage2(config, "cuda", torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    trained = sum(p.numel() for p in state.generator.parameters()
                  if p.requires_grad)
    frozen_n = sum(p.numel() for p in state.generator.parameters()
                   if not p.requires_grad)
    print(f"{phase}: built {label} in {time.perf_counter() - t0:.2f} s; "
          f"{trained} trained parameters, {frozen_n} frozen in the "
          f"generator")
    host = prepare_batch(synthetic_batch(config, b,
                                         torch.Generator().manual_seed(1)),
                         state.tokenizer, state.learnable_cf)
    batch = on_device({k: v for k, v in host.items() if k != "text"},
                      torch.device("cuda"))
    frozen = {k: v.clone() for k, v in state.vqvae.state_dict().items()}
    g = torch.Generator(device="cuda").manual_seed(2)
    expect = (2 * tcfg["n_layer"], 2 * tcfg["n_layer"], 1)
    seconds, total = [], (0, 0, 0)
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
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
        print(f"{phase}: {label} B={b} step {i} "
              f"({'warm-up' if i < warmup else 'timed'}): {dt:.4f} s, loss "
              f"{loss:.6f}, acc {float(values['diffusion_acc']):.4f}, "
              f"launches K2 {counts[0]}, K5 {counts[1]}, K6 {counts[2]}")
        if not math.isfinite(loss):
            raise AssertionError("the training loss is not finite")
        if i >= warmup:
            seconds.append(dt)
            total = tuple(a + c for a, c in zip(total, counts))
    per_step = sum(seconds) / len(seconds)
    print(f"{phase}: {label} B={b}: {per_step:.4f} s/step = "
          f"{1 / per_step:.3f} steps/s over {len(seconds)} timed steps "
          f"(min {min(seconds):.4f}, max {max(seconds):.4f}); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{smi}")
    for k, v in state.vqvae.state_dict().items():
        if not torch.equal(v, frozen[k]):
            raise AssertionError(f"the frozen VQ-VAE changed: {k}")
    drawn = float(state.generator.diffusion.lt_count.sum())
    print(f"{phase}: frozen VQ-VAE bitwise unchanged; Lt count sums to "
          f"{drawn:.0f} = {b} x {state.step} steps")
    if drawn != b * state.step:
        raise AssertionError("the Lt count does not add up to the steps")
    return state, batch, g, dict(zip(("K2", "K5", "K6"), total))


def _profile_step(torch, state, batch, generator,
                  phase: str = "phase 7") -> None:
    """Where a training step's time goes. First CUDA events between the
    parts of ``train_step``'s body (unprofiled, 3 steps): the device time of
    the frozen encode, the conditioner (the CLIP tower in text mode), the
    D3PM forward with the loss, the backward and Adam. Then torch.profiler
    over 2 steps: device time by kernel, and the device's busy share of the
    (profiled) wall time."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage2
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.metrics import (
        weighted_losses)

    parts = ("encode", "conditioner", "forward + loss", "backward", "adam")
    steps = 3
    part_ms = dict.fromkeys(parts, 0.0)
    gen = state.generator
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        flat = stage2.encode_tokens(state, batch["video"])
        ev[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        cond, _ = gen.conditioner(batch, flat.shape[0], with_cf=False)
        ev[2].record()
        out = gen.diffusion(flat, cond, generator=generator, train=True,
                            empty_mask=batch.get("empty_text_mask"))
        total = weighted_losses(state.loss_dict, {"losses": out["loss"]})[0]
        ev[3].record()
        total.backward()
        ev[4].record()
        state.optimizer.step()
        ev[5].record()
        torch.cuda.synchronize()
        for i, name in enumerate(parts):
            part_ms[name] += ev[i].elapsed_time(ev[i + 1]) / steps
    print(f"{phase} profile: device ms/step by part (CUDA events, mean of "
          f"{steps} steps): " + ", ".join(
              f"{n} {t:.2f}" for n, t in part_ms.items())
          + f"; sum {sum(part_ms.values()):.2f}")

    _profile_kernels(torch, phase,
                     lambda: stage2.train_step(state, batch, generator))


def _profile_kernels(torch, phase: str, step, steps: int = 2) -> None:
    """torch.profiler over ``steps`` calls of ``step``: device time by
    kernel, and the device's busy share of the (profiled) wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.device_time_total
            k[1] += 1
    device_us = sum(k[0] for k in kernels.values())
    print(f"{phase} profile: {steps} steps, wall {wall * 1e3 / steps:.2f} "
          f"ms/step (profiled), device kernels {device_us / 1e3 / steps:.2f} "
          f"ms/step = {100 * device_us / 1e6 / wall:.1f} % busy")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]
                                )[:25]:
        print(f"{phase} profile: {us / 1e3 / steps:8.3f} ms/step "
              f"{100 * us / device_us:5.1f} % {n // steps:5d} calls/step  "
              f"{name[:90]}")


def _megakernel_case(torch, *, L, spatial, k, n_layer, s_len, B, use_cfg,
                     dtype, seed, t=50, force_general=False,
                     logit_scale=1.0, score_scale=1.0):
    """A denoiser at the kernels' width (n_embd 64, 16 heads) with every
    parameter drawn from N(0, 0.1) (LayerNorm scales around 1), and one
    step's arguments on the card: tokens half MASK, half data.
    ``force_general`` sends a one-token condition through the general
    cross-attention instead of the per-layer bias; ``logit_scale`` multiplies
    the output projection, so that log-probabilities fall under the step's
    clamp at -70; ``score_scale`` multiplies the self-attention's query
    projections, so that scores spread far below the bound the kernels
    shift them by and the exact row maximum is taken. (The card's tests,
    ``tests/test_torch_gpu_kernels.py``, build their cases here too.)"""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.d3pm import (
        make_schedule)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.denoiser \
        import DenoiserTransformer
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import schedule_rows

    g = torch.Generator().manual_seed(seed)
    tr = DenoiserTransformer(num_embed=k - 1, spatial_size=spatial,
                             n_layer=n_layer, n_embd=64, n_head=16,
                             condition_dim=32, diffusion_step=100)
    with torch.no_grad():
        for name, p in tr.named_parameters():
            p.normal_(0.0, 0.1, generator=g)
            if "ln" in name and name.endswith("weight") and p.ndim == 1:
                p.add_(1.0)
        tr.to_logits.weight.mul_(logit_scale)
        for i in range(n_layer):
            getattr(tr, f"block{i}").attn1.query.weight.mul_(score_scale)
    tr = tr.to("cuda").eval()
    packed = mk.pack_denoiser_params(tr, dtype)
    cond = torch.randn((B, s_len, 32), generator=g).to("cuda")
    cf = torch.randn((1, s_len, 32), generator=g).to("cuda")
    as_bias = s_len == 1 and not force_general
    kc, vc = mk.cross_tables(packed, cond, cf, use_cfg, as_bias)
    tokens = torch.randint(0, k - 1, (B, L), generator=g)
    tokens = torch.where(torch.rand((B, L), generator=g) < 0.5, k - 1,
                         tokens).to("cuda")
    row = schedule_rows(make_schedule(100, k, device="cuda"))[t]
    args = (packed, tokens, mk._adaln_table(packed, torch.tensor(t), 100, 64),
            kc, vc, mk.positions(packed, L), row, 11)
    kw = dict(n_layer=n_layer, n_head=16, n_embd=64, num_classes=k,
              guidance=2.0 if use_cfg else 1.0, use_cfg=use_cfg,
              s_valid=s_len, cross_as_bias=as_bias)
    return args, kw


def _check_megakernel(torch, phase: str, label: str, args, kw,
                      pack_cfg: bool):
    """One argmax step of K3 / K4 against the plain version on the card: the
    final hidden state the kernel leaves in its scratch, then the tokens
    (int64, in range, equal wherever the plain log-posterior's top-two
    margin exceeds MK_MARGIN), and one launch counted for the kernel asked
    for. Returns (tokens, hidden max-abs error)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)

    tokens = args[1]
    b, L = tokens.shape
    scratch = mk.alloc_scratch(b, 2 if kw["use_cfg"] else 1, L,
                               tokens.device)
    before = _megakernel_counts()
    got = mk.megakernel_step(*args, sample=False, pack_cfg=pack_cfg,
                             scratch=scratch, **kw)
    torch.cuda.synchronize()
    counted = tuple(a - b for a, b in zip(_megakernel_counts(), before))
    hidden_kw = {n: v for n, v in kw.items()
                 if n not in ("num_classes", "guidance")}
    want_x = mk.megakernel_hidden_reference(*args[:6], **hidden_kw)
    err = (scratch["x"] - want_x).abs().max().item()
    scale = want_x.abs().max().item()
    del want_x
    want, post = mk.megakernel_step_reference(
        *args, sample=False, return_posterior=True, **kw)
    top2 = post.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > MK_MARGIN
    wrong = int(((got != want) & decided).sum())
    print(f"{phase}: {label}: hidden state max-abs {err:.3e} of {scale:.3e} "
          f"(tol {MK_HIDDEN_TOL} relative); {int((~decided).sum())} of "
          f"{got.numel()} positions under the margin {MK_MARGIN}, {wrong} "
          f"real token mismatches, {int((got != want).sum())} in all")
    if counted != (int(pack_cfg), int(not pack_cfg)):
        raise AssertionError(f"{label}: launches counted {counted}")
    if got.dtype != torch.int64 or int(got.min()) < 0 or \
            int(got.max()) >= kw["num_classes"]:
        raise AssertionError(f"{label}: tokens out of range")
    if not err <= MK_HIDDEN_TOL * scale or wrong:
        raise AssertionError(f"{label} disagrees with its plain version")
    return got, err


def _check_softmax_shift(torch, phase: str, pack_cfg: bool) -> float:
    """Phase S shifts a query's scores by an upper bound of them wherever
    the bound provably lies near the row maximum, and by the exact maximum
    elsewhere, a warp of 32 queries at a time. With the query projections
    scaled up (x 1: every warp takes the bound; x 10: some; x 100: none) the
    plain build is held against the build that takes the exact maximum
    everywhere: the same softmax, f32 rounding of the shifted scores apart
    (the tolerances: MK_SHIFT_MIXED_TOL above; the plain version itself is
    no yardstick at the larger scales: a bf16 rounding of q or k that falls
    the other way moves such peaked rows more). Returns the worst
    hidden-state error."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)

    worst, failed = 0.0, False
    for scale, tol in ((1.0, MK_HIDDEN_TOL), (10.0, MK_SHIFT_MIXED_TOL),
                       (100.0, 0.0)):
        args, kw = _megakernel_case(
            torch, L=200, spatial=(20, 10), k=17, n_layer=2, s_len=3, B=3,
            use_cfg=pack_cfg, dtype=torch.bfloat16, seed=31,
            score_scale=scale)
        out = []
        for defines in ((), mk.EXACT_MAX):
            scratch = mk.alloc_scratch(3, 2 if pack_cfg else 1, 200, "cuda")
            tok = mk.megakernel_step(*args, sample=False, pack_cfg=pack_cfg,
                                     scratch=scratch, defines=defines, **kw)
            torch.cuda.synchronize()
            out.append((tok, scratch["x"]))
        err = (out[0][1] - out[1][1]).abs().max().item()
        ref = out[1][1].abs().max().item()
        differ = int((out[0][0] != out[1][0]).sum())
        print(f"{phase}: {'K3' if pack_cfg else 'K4'} B=3 L=200 K=17 2 layers "
              f"S=3, queries x {scale:g}: shifted by the bound where it may "
              f"be against the exact row maximum everywhere: hidden state "
              f"max-abs {err:.3e} of {ref:.3e} (tol {tol} relative), "
              f"{differ} of {out[0][0].numel()} argmax tokens differ")
        failed = failed or not err <= tol * ref or \
            differ > MK_SHIFT_TOKENS * out[0][0].numel() or \
            not bool(out[0][1].isfinite().all())
        worst = max(worst, err)
    if failed:
        raise AssertionError("the softmax shift changes the step")
    return worst


def _time_megakernel(torch, phase, smi, label, models, b, pack_cfg,
                     defines=()):
    """Plain, kernel, kernel, plain at a serving configuration: one sampled
    step from all-MASK tokens with the models' own weights and a label
    condition. Returns (ms, plain ms, bound ms, bound by, tables, kw)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)

    d3pm = models.generator.diffusion
    g = torch.Generator().manual_seed(3)
    batch = {"label": torch.randint(0, 101, (b,), generator=g)}
    cond, cf = models.generator.conditioner_embeddings(batch, b)
    L = d3pm.content_seq_len
    tab, kw = mk.prepare_sampling(d3pm.schedule(), d3pm.transformer, cond,
                                  cf, b, L,
                                  guidance_scale=d3pm.guidance_scale,
                                  pack_cfg=pack_cfg)
    tokens = torch.full((b, L), d3pm.num_classes - 1, dtype=torch.int64,
                        device="cuda")
    args = (tab["packed"], tokens, tab["adaln_all"][0], tab["kc"], tab["vc"],
            tab["pos"], tab["rows"][99], 5)
    ref_kw = {n: v for n, v in kw.items() if n != "pack_cfg"}
    ms, plain_ms = _ab_ms(
        lambda: mk.megakernel_step_reference(*args, **ref_kw),
        lambda: mk.megakernel_step(*args, scratch=tab["scratch"],
                                   defines=defines, **kw), 10)
    n_br = 2 if kw["use_cfg"] else 1
    nbytes, f32, bf16 = _megakernel_work(
        b, n_br, L, kw["n_layer"], tab["packed"]["wfc"].shape[2],
        kw["num_classes"] - 1, kw["s_valid"], kw["cross_as_bias"])
    bound_ms, bound_by = _bound(nbytes, f32, bf16)
    print(f"{phase}: {label} (B={b}, L={L}, {kw['n_layer']} layers, K="
          f"{kw['num_classes']}, bf16 weights, sampled) kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({f32 / 1e9:.1f} GFLOP at {PEAK_F32 / 1e12} TFLOP/s f32 + "
          f"{bf16 / 1e9:.1f} GFLOP of bf16 operands at {PEAK_BF16 / 1e12} "
          f"TFLOP/s; {nbytes / 1e6:.1f} MB); no single library call ({smi})")
    return ms, plain_ms, bound_ms, bound_by, (args, tab, kw)


def _phase_times(torch, phase, label, args, tab, kw) -> None:
    """Where one step's time goes: the device's ns clock at every grid
    barrier, read by block 0 (3 warm launches, then the mean of 5)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)

    n_layer = kw["n_layer"]
    stamps = torch.zeros(mk.stamp_count(n_layer), dtype=torch.int64,
                         device="cuda")
    parts = dict.fromkeys(("A: AdaLN-LN + QKV", "S: self-attention",
                           "B: proj + cross + MLP", "tail"), 0.0)
    names = list(parts)
    runs = 5
    for i in range(3 + runs):
        mk.megakernel_step(*args, scratch=tab["scratch"], stamps=stamps,
                           **kw)
        torch.cuda.synchronize()
        if i < 3:
            continue
        d = (stamps[1:] - stamps[:-1]).double().cpu() / 1e6 / runs
        for j in range(3):
            parts[names[j]] += float(d[j:3 * n_layer:3].sum())
        parts["tail"] += float(d[3 * n_layer])
    print(f"{phase}: {label} ms/step by phase (device clock at the grid "
          f"barriers, mean of {runs}): "
          + ", ".join(f"{n} {t:.3f}" for n, t in parts.items())
          + f"; sum {sum(parts.values()):.3f}")


def phase_k3(torch, smi: str, honest) -> dict:
    """K3 against its plain version, then timed at the honest B=32."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)

    worst = 0.0
    # the last case is the main path's own shape: 1024 tile items and 2048
    # attention items on a persistent grid of a few hundred blocks, so every
    # block loops over several work items and reuses its shared memory
    for label, dtype, L, spatial, k, n_layer, s_len, b in (
            ("K3 f32 weights B=2 L=1024 K=4097 19 layers S=1", torch.float32,
             1024, (32, 32), 4097, 19, 1, 2),
            ("K3 bf16 weights B=2 L=1024 K=4097 19 layers S=1",
             torch.bfloat16, 1024, (32, 32), 4097, 19, 1, 2),
            ("K3 bf16 weights B=2 L=96 K=200 3 layers S=3 (general cross)",
             torch.bfloat16, 96, (12, 8), 200, 3, 3, 2),
            ("K3 bf16 weights B=2 L=64 K=17 2 layers S=77 (general cross)",
             torch.bfloat16, 64, (8, 8), 17, 2, 77, 2),
            ("K3 bf16 weights B=48 L=200 K=17 2 layers S=3 (ragged tiles, "
             "several work items a block)", torch.bfloat16, 200, (20, 10), 17,
             2, 3, 48),
            ("K3 bf16 weights B=3 L=96 K=200 2 layers S=1, logits x 60 "
             "(log-probabilities under the clamp: the tail's extra pass)",
             torch.bfloat16, 96, (12, 8), 200, 2, 1, 3),
            ("K3 bf16 weights B=32 L=1024 K=4097 19 layers S=1 (the main "
             "path's shape)", torch.bfloat16, 1024, (32, 32), 4097, 19, 1,
             32)):
        args, kw = _megakernel_case(
            torch, L=L, spatial=spatial, k=k, n_layer=n_layer, s_len=s_len,
            B=b, use_cfg=True, dtype=dtype, seed=L + k,
            logit_scale=60.0 if "logits x 60" in label else 1.0)
        worst = max(worst, _check_megakernel(torch, "phase 8", label, args,
                                             kw, True)[1])
        del args
        torch.cuda.empty_cache()

    worst = max(worst, _check_softmax_shift(torch, "phase 8", True))

    # sampled mode at K = 17: in range, repeatable by seed, and the classes
    # drawn over 200 seeds against the plain posterior
    k, n = 17, 200
    args, kw = _megakernel_case(torch, L=64, spatial=(8, 8), k=k, n_layer=2,
                                s_len=1, B=2, use_cfg=True,
                                dtype=torch.bfloat16, seed=9, t=30)
    post = mk.megakernel_step_reference(*args, sample=False,
                                        return_posterior=True, **kw)[1]
    want = post.exp().sum(dim=(0, 2))
    want = want / want.sum()
    counts = torch.zeros(k, device="cuda")
    draws = []
    for seed in [1000] + list(range(1000, 1000 + n)):
        tok = mk.megakernel_step(*args[:7], seed, pack_cfg=True, **kw)
        draws.append(tok)
        if len(draws) > 1:
            counts += torch.bincount(tok.flatten(), minlength=k)
    tv = 0.5 * (counts / counts.sum() - want).abs().sum().item()
    in_range = all(int(t.min()) >= 0 and int(t.max()) < k for t in draws)
    by_seed = torch.equal(draws[0], draws[1]) and \
        not torch.equal(draws[1], draws[2])
    print(f"phase 8: K3 sampled, K={k}: {int(counts.sum())} draws in range "
          f"{in_range}, repeatable by seed {by_seed}, total variation "
          f"against the plain posterior {tv:.4f} (tol {MK_TV_TOL})")
    if not in_range or not by_seed or not tv < MK_TV_TOL:
        raise AssertionError("K3's sampled tokens do not follow the plain "
                             "posterior")

    ms, plain_ms, bound_ms, bound_by, step = _time_megakernel(
        torch, "phase 8", smi, "K3", honest, 32, True)
    _phase_times(torch, "phase 8", "K3 B=32 L=1024", *step)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_k4(torch, smi: str, msrvtt) -> dict:
    """K4 against its plain version and against K3, then timed at B=8,
    L=2304."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)

    worst = 0.0
    # the last two cases give every block several work items: the main
    # path's own shape (576 tile items, 2304 attention items), and guidance 1
    # at the same load
    for label, L, spatial, s_len, use_cfg, n_layer, b in (
            ("K4 guidance 1 B=2 L=1024 K=4097 19 layers S=1", 1024, (32, 32),
             1, False, 19, 2),
            ("K4 CFG B=2 L=2304 K=4097 19 layers S=1", 2304, (48, 48), 1,
             True, 19, 2),
            ("K4 CFG B=1 L=2304 K=4097 4 layers S=77 (general cross)", 2304,
             (48, 48), 77, True, 4, 1),
            ("K4 guidance 1 B=32 L=1024 K=4097 19 layers S=1 (several work "
             "items a block)", 1024, (32, 32), 1, False, 19, 32),
            ("K4 CFG B=8 L=2304 K=4097 19 layers S=1 (the main path's "
             "shape)", 2304, (48, 48), 1, True, 19, 8)):
        args, kw = _megakernel_case(
            torch, L=L, spatial=spatial, k=4097, n_layer=n_layer,
            s_len=s_len, B=b, use_cfg=use_cfg, dtype=torch.bfloat16,
            seed=L + s_len)
        worst = max(worst, _check_megakernel(torch, "phase 9", label, args,
                                             kw, False)[1])
        del args
        torch.cuda.empty_cache()
    worst = max(worst, _check_softmax_shift(torch, "phase 9", False))
    args, kw = _megakernel_case(torch, L=1024, spatial=(32, 32), k=4097,
                                n_layer=19, s_len=1, B=32, use_cfg=True,
                                dtype=torch.bfloat16, seed=5)
    k3 = mk.megakernel_step(*args, sample=False, pack_cfg=True, **kw)
    k4 = mk.megakernel_step(*args, sample=False, pack_cfg=False, **kw)
    same = torch.equal(k3, k4)
    print(f"phase 9: K4 (pack_cfg=False) against K3 at B=32 L=1024 K=4097 19 "
          f"layers, argmax: tokens equal {same}")
    if not same:
        raise AssertionError("K4 and K3 disagree")
    ms, plain_ms, bound_ms, bound_by, step = _time_megakernel(
        torch, "phase 9", smi, "K4", msrvtt, 8, None)
    _phase_times(torch, "phase 9", "K4 B=8 L=2304", *step)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _chain_inputs(torch, m: int, k: int, n: int, seed: int, ones: bool):
    """x (m, k) and two w (k, n) ~ N(0, 1) / k, bf16 on the card; ``ones``
    gives the probe's own x (all ones), else x ~ N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.ones((m, k)) if ones else torch.randn((m, k), generator=g)
    w1, w2 = (torch.randn((k, n), generator=g) / k for _ in range(2))
    return tuple(t.to(torch.bfloat16).to("cuda") for t in (x, w1, w2))


def _check_chain(torch, phase: str, m: int, k: int, n: int, iters: int,
                 pair: bool, ones: bool = False) -> float:
    """One launch of P2 (or P3) against its plain version on the card at
    ``iters`` <= 4: the final x, sum(x) and the checksum, and one launch
    counted. Returns the error of sum(x)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        probe_kernels as pk)

    x, w1, w2 = _chain_inputs(torch, m, k, n, m + k + n + iters, ones)
    design = pk.device_chain_design(m, k, n, 2 if pair else 1)
    if design != pk.chain_design(m, k, n, 2 if pair else 1,
                                 _multiprocessors(torch)):
        raise AssertionError(f"the launcher's design {design} is not "
                             f"chain_design's")
    before = (pk.chain_matmul.launches, pk.pair_matmul.launches)
    if pair:
        got = pk.pair_matmul(x, w1, w2, iters, return_x=True)
        want = pk.pair_reference(x, w1, w2, iters, return_x=True)
    else:
        got = pk.chain_matmul(x, w1, iters, return_x=True)
        want = pk.chain_reference(x, w1, iters, return_x=True)
    torch.cuda.synchronize()
    counted = (pk.chain_matmul.launches - before[0],
               pk.pair_matmul.launches - before[1])
    xw = want[2].float()
    x_err = (got[2].float() - xw).abs().max().item()
    s_err = (got[0] - want[0]).abs().item()
    c_err = (got[1] - want[1]).abs().max().item()
    x_scale, l1 = xw.abs().max().item(), xw.abs().sum().item()
    c_scale = want[1].abs().max().item()
    name = "P3 pair" if pair else "P2 chain"
    print(f"{phase}: {name} ({m}, {k}) x ({k}, {n}), iters {iters}, x "
          f"{'ones' if ones else 'N(0, 1)'}, the {design.design} design "
          f"({design.blocks} blocks of {design.slab} columns, "
          f"{design.smem} B of shared memory a block): sum(x) "
          f"{got[0].item():.6g} vs "
          f"plain {want[0].item():.6g} (error {s_err:.3e}, tol "
          f"{CHAIN_SUM_TOL * l1:.3e} = 2^-8 of sum |x|); final x max-abs "
          f"error {x_err:.3e} of {x_scale:.3e} (tol 2^-6 relative); checksum "
          f"max-abs error {c_err:.3e} of {c_scale:.3e} (tol "
          f"{CHAIN_CHECK_TOL} relative)")
    if counted != (int(not pair), int(pair)):
        raise AssertionError(f"{name}: launches counted {counted}")
    if iters and (want[0].item() == 0.0 or l1 == 0.0 or c_scale == 0.0):
        raise AssertionError(f"{name}: the plain sum is 0: nothing compared")
    if not x_err <= CHAIN_X_TOL * x_scale or \
            not s_err <= CHAIN_SUM_TOL * l1 or \
            not c_err <= CHAIN_CHECK_TOL * c_scale:
        raise AssertionError(f"{name} disagrees with its plain version")
    return s_err


def _multiprocessors(torch) -> int:
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def _check_chain_blocks(torch, phase: str, m: int, k: int, n: int,
                        iters: int = 3, pair: bool = False) -> None:
    """P2 (or P3) in the local design: the final x of the first and of the
    last block, bitwise equal (for the pair, both chains' and each chain's
    nonzero)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        probe_kernels as pk)

    name = "P3" if pair else "P2"
    design = pk.device_chain_design(m, k, n, 2 if pair else 1)
    x, w1, w2 = _chain_inputs(torch, m, k, n, 2 * m + k + n, False)
    if pair:
        _, _, first, last = pk.pair_matmul(x, w1, w2, iters, return_x=True,
                                           last_block_x=True)
    else:
        _, _, first, last = pk.chain_matmul(x, w1, iters, return_x=True,
                                            last_block_x=True)
    torch.cuda.synchronize()
    bits = (first.view(torch.int16), last.view(torch.int16))
    differ = int((bits[0] != bits[1]).sum())
    chains = first.reshape(2 if pair else 1, -1)
    print(f"{phase}: {name} ({m}, {k}) x ({k}, {n}), iters {iters}, the "
          f"{design.design} design over {design.blocks} blocks: the final x "
          f"of block 0 and of block {design.blocks - 1} differ in {differ} "
          f"of {first.numel()} elements (bitwise); nonzero "
          + ", ".join(str(int((c != 0).sum())) for c in chains))
    if design.design != "local":
        raise AssertionError(f"{name} at ({m}, {k}) x ({k}, {n}) does not "
                             f"take the local design")
    if differ or not all(c.any() for c in chains):
        raise AssertionError(f"{name}'s blocks hold different final x")


def _chain_kernel_name(design, k: int, chains: int) -> str:
    """The design and the CUDA kernel a chain launch takes."""
    if design.design == "exchange":
        return f"exchange: chain_kernel<{chains}>"
    return f"local: chain_local_kernel<{k}, {chains}>"


def _pair_ptxas(k: int) -> str:
    """nvcc's registers and spills of the pair's local instantiation at
    depth k; raises where it spills."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        probe_kernels as pk)

    rows = [r for r in _ptxas_by_kernel(pk._library().build_log)
            if re.search(rf"chain_local_kernel(<(\(int\))?{k}, (\(int\))?2>"
                         rf"|ILi{k}ELi2E)", r)]
    if len(rows) != 1:
        raise AssertionError(f"no ptxas line of the pair at k = {k}: {rows}")
    if not rows[0].endswith(" 0 B spilled"):
        raise AssertionError(f"the pair's kernel spills: {rows[0]}")
    return rows[0]


def _check_probe_matmul(torch, phase: str, n: int) -> float:
    """P1 against its plain version on the card."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        probe_kernels as pk)

    g = torch.Generator(device="cuda").manual_seed(n)
    a = torch.randn((n, n), generator=g, device="cuda")
    before = pk.probe_matmul.launches
    got = pk.probe_matmul(a)
    want = pk.probe_matmul_reference(a)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"{phase}: P1 ({n}, {n}) f32: max-abs error {err:.3e} of "
          f"{scale:.3e} (tol {P1_TOL} relative)")
    if pk.probe_matmul.launches != before + 1:
        raise AssertionError("P1: the launch was not counted")
    if not err <= P1_TOL * scale:
        raise AssertionError("P1 disagrees with its plain version")
    return err


def _megakernel_counts() -> tuple[int, int]:
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)
    return mk.megakernel_step.launches_k3, mk.megakernel_step.launches_k4


def _reset_megakernel_counts() -> None:
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)
    mk.megakernel_step.launches_k3 = mk.megakernel_step.launches_k4 = 0


def phase_megakernel_route(torch, smi: str, honest, msrvtt) -> dict:
    """The serving slice through ``sampler="megakernel"``."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        HONEST, build_models, sample_token_grid, sample_videos)

    small = _small_train_config()
    small["generator"]["diffusion_model"]["guidance_scale"] = 2.0
    out = {}
    for dev in ("cuda", "cpu"):
        models = build_models(small, dev, torch.Generator().manual_seed(11))
        batch = {"label": torch.tensor([0, 3, 4])}
        tok = sample_token_grid(models, batch, torch.Generator().manual_seed(
            12), sample=False, sampler="megakernel")
        with torch.no_grad():
            out[dev] = (tok.cpu(), models.vqvae.decode(tok).cpu())
    same = torch.equal(out["cuda"][0], out["cpu"][0])
    verr = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    print(f"phase 10: small slice (T=8, K=17, L=32) on the megakernel route, "
          f"argmax, on the card vs the CPU's plain run: tokens equal {same}, "
          f"video max-abs {verr:.3e} (tol {VIDEO_TOL})")
    if not same or not verr <= VIDEO_TOL:
        raise AssertionError("the megakernel route on the card disagrees "
                             "with the CPU")

    steps = HONEST["generator"]["diffusion_model"]["diffusion_step"]
    mask_id = HONEST["vqvae"]["n_codes"]
    launches = {}
    g = torch.Generator().manual_seed(0)
    for label, models, b, res, expect in (
            ("HONEST warm-up", honest, 4, 64, (steps, 0)),
            ("HONEST", honest, 32, 64, (steps, 0)),
            ("MSRVTT_GRID", msrvtt, 8, 96, (0, steps))):
        batch = {"label": torch.randint(0, 101, (b,), generator=g)}
        if "warm-up" in label:
            t0 = time.perf_counter()
            sample_videos(models, batch, g, sampler="megakernel")
            torch.cuda.synchronize()
            print(f"phase 10: {label} B={b} in "
                  f"{time.perf_counter() - t0:.2f} s")
            continue
        _reset_megakernel_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = sample_token_grid(models, batch, g, sampler="megakernel")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            video = models.vqvae.decode(tokens)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = _megakernel_counts()
        L = tokens[0].numel()
        print(f"phase 10: {label} B={b} L={L} on the megakernel route "
              f"{t2 - t0:.3f} s = {b / (t2 - t0):.3f} clips/s (sampling "
              f"{t1 - t0:.3f} s, {(t1 - t0) / steps * 1e3:.2f} ms/step over "
              f"{steps} steps; decode {t2 - t1:.3f} s); launches K3 "
              f"{counts[0]}, K4 {counts[1]} = {sum(counts) / steps:.0f} per "
              f"step (expected {expect}); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
        if counts != expect:
            raise AssertionError("a kernel of the path was not launched as "
                                 "expected")
        if not bool((tokens != mask_id).all()) or int(tokens.min()) < 0:
            raise AssertionError("MASK tokens left in the final grid")
        shape = (b, 16, res, res, 3)
        if tuple(video.shape) != shape or not bool(video.isfinite().all()):
            raise AssertionError(f"video {tuple(video.shape)} is not a finite"
                                 f" {shape}")
        launches["K3" if counts[0] else "K4"] = sum(counts)
    return launches


# P1's checked sizes: one element, sizes no multiple of its 32 x 16 tile
# or of 4 (element copies), the path's 256, and more chunks than its stages
P1_SIZES = (1, 100, 255, 256, 300, 520)


def phase_p1(torch, smi: str, parent: str | None = None) -> tuple[dict, dict]:
    """P1 against its plain version, timed; then the build-cache probe.
    Returns P1's numbers for the kernels' line and the launches its
    children counted ({"P1": n, "K1": n})."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        probe_kernels as pk)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        build_cache_probe)

    worst = max(_check_probe_matmul(torch, "phase 11", n) for n in P1_SIZES)
    a = torch.ones((256, 256), device="cuda")
    zero = torch.zeros_like(a)
    ms, plain_ms = _ab_ms(lambda: pk.probe_matmul_reference(a),
                          lambda: pk.probe_matmul(a), 20)
    # P1 against the one PyTorch call for the same function, in turns: 12
    # rounds of 25 launches each, so that the spread of either shows
    rounds = {"kernel": [], "library": []}
    for _ in range(12):
        rounds["kernel"].append(_time_ms(lambda: pk.probe_matmul(a), 25))
        rounds["library"].append(_time_ms(
            lambda: torch.addmm(zero, a, a, beta=0.0, alpha=2.0), 25))
    ms = sum(rounds["kernel"]) / 12
    lib_ms = sum(rounds["library"]) / 12
    k_lo, k_hi = min(rounds["kernel"]), max(rounds["kernel"])
    l_lo, l_hi = min(rounds["library"]), max(rounds["library"])
    verdict = ("faster in every round" if k_hi < l_lo else
               "slower in every round" if k_lo > l_hi else
               "within the rounds' spread of it")
    flops, nbytes = 2.0 * 256 ** 3, 2.0 * 4 * 256 * 256
    bound_ms, bound_by = _bound(nbytes, flops)
    print(f"phase 11: P1 (256, 256) f32 kernel {ms:.4f} ms (12 rounds of 25 "
          f"launches in turns with the library call: {k_lo:.4f}-{k_hi:.4f}), "
          f"plain {plain_ms:.4f} ms, torch.addmm(beta=0, alpha=2) "
          f"{lib_ms:.4f} ms ({l_lo:.4f}-{l_hi:.4f}): P1 is {verdict}, "
          f"{ms / lib_ms:.3f} x its time; bound {bound_ms:.5f} ms by "
          f"{bound_by} ({flops / 1e6:.1f} MFLOP at {PEAK_F32 / 1e12} TFLOP/s "
          f"f32, {nbytes / 1e6:.2f} MB) ({smi})")
    g_ms, g_lib = _graph_turns(
        torch, lambda: pk.probe_matmul(a),
        lambda: torch.addmm(zero, a, a, beta=0.0, alpha=2.0))
    g_verdict = ("faster in every round" if max(g_ms) < min(g_lib) else
                 "slower in every round" if min(g_ms) > max(g_lib) else
                 "within the rounds' spread of it")
    print(f"phase 11: under a CUDA graph (25 launches a graph, 12 rounds in "
          f"turns): P1 {sum(g_ms) / 12:.4f} ms a launch ({min(g_ms):.4f}-"
          f"{max(g_ms):.4f}), torch.addmm {sum(g_lib) / 12:.4f} "
          f"({min(g_lib):.4f}-{max(g_lib):.4f}): P1 is {g_verdict}, "
          f"{sum(g_ms) / sum(g_lib):.3f} x its time ({smi})")
    _print_parent_turns("phase 11", "P1", parent)

    res = build_cache_probe.probe(timeout=300.0, hang_dump_s=240,
                                  log=lambda line: None)
    pa, pb = res["a"], res["b"]
    for name, ph in (("A", pa), ("B", pb)):
        if not ph.get("ok"):
            raise AssertionError(f"build-cache probe, phase {name}: "
                                 f"{ph.get('tail')}")
    print("phase 11: build-cache probe: "
          + "; ".join(
              f"phase {name} nvcc {ph['nvcc_build_s']:.2f} s, P1 first call "
              f"{ph['p1_first_call_s']:.2f} s, K1 nvcc "
              f"{ph['k1_nvcc_build_s']:.2f} s, first call "
              f"{ph['k1_first_call_s']:.2f} s, second calls "
              f"{ph['second_calls_s']:.4f} s, {ph['build_files']} build "
              f"files, process {ph['wall_s']:.1f} s"
              for name, ph in (("A", pa), ("B", pb)))
          + f": {res['verdict']} ({smi})")
    if not all(ph["p1_right"] and ph["k1_right"] for ph in (pa, pb)):
        raise AssertionError("build-cache probe: wrong values")
    launches = {"P1": pa["p1_launches"] + pb["p1_launches"],
                "K1": pa["k1_launches"] + pb["k1_launches"]}
    return (dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms),
            launches)


def _graph_turns(torch, kernel, library, launches: int = 25,
                 rounds: int = 12) -> tuple[list, list]:
    """``launches`` calls of each function captured in a CUDA graph of its
    own; the replays timed in turns (CUDA events), ``rounds`` times. Returns
    the ms a launch of each round, kernel's and library's: the host's launch
    cost is gone from both."""
    graphs = []
    for fn in (kernel, library):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
        graph.replay()
        graphs.append(graph)
    torch.cuda.synchronize()
    out = ([], [])
    for r in range(rounds):
        order = (0, 1) if r % 2 == 0 else (1, 0)
        for i in order:
            out[i].append(_time_ms(graphs[i].replay, 4) / launches)
    return out


def phase_chains(torch, smi: str, parent: str | None = None
                 ) -> tuple[dict, dict, dict]:
    """P2 and P3 against their plain versions, timed at the QK shape, then
    the depth / packing probe. Returns (P2's numbers, P3's numbers, the
    probe's launches {"P2": n, "P3": n})."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        probe_kernels as pk)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        depth_pack_probe)

    worst = {False: 0.0, True: 0.0}
    for m, k, n, iters, ones in ((256, 64, 16384, 4, True),
                                 (256, 64, 16384, 3, False),
                                 (256, 64, 2048, 4, False),
                                 (256, 128, 2048, 4, False),
                                 (256, 256, 2048, 2, False),
                                 (256, 512, 2048, 2, False),
                                 (256, 128, 32768, 2, False)):
        for pair in (False, True):
            worst[pair] = max(worst[pair], _check_chain(
                torch, "phase 12", m, k, n, iters, pair, ones))
    for m, k, n in ((256, 64, 16384), (256, 128, 32768)):
        _check_chain_blocks(torch, "phase 12", m, k, n)
    _check_chain_blocks(torch, "phase 12", 256, 64, 16384, pair=True)
    print(f"phase 12: P3 at the QK shape: "
          f"{pk.device_chain_design(256, 64, 16384, 2)}; "
          f"{_pair_ptxas(64)}")

    # timed at the QK shape with the probe's own operands and iterations
    m, k, n, iters = 256, 64, 16384, depth_pack_probe.ITERS
    x, w1, w2 = (torch.from_numpy(a).to(torch.bfloat16).to("cuda")
                 for a in depth_pack_probe.probe_inputs(m, k, n))

    def library(ws):
        # the yardstick: a loop of the library's bf16 product (its output
        # rounded to bf16 before the scale), one chain after the other
        for w in ws:
            y = x
            for _ in range(iters):
                y = torch.matmul(y, w)[:, :k] * 0.01
        return y

    def library_graph_ms(ws, chunk: int = 200) -> float:
        # the same loop, ``chunk`` iterations of each chain captured in one
        # CUDA graph and replayed: the device's time, without the host's
        def loop():
            for w in ws:
                y = x
                for _ in range(chunk):
                    y = torch.matmul(y, w)[:, :k] * 0.01
        loop()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            loop()
        graph.replay()
        ms = _time_ms(graph.replay, 5) * iters / chunk
        del graph
        return ms

    numbers = {}
    for name, ws, kernel, plain in (
            ("P2", (w1,), lambda: pk.chain_matmul(x, w1, iters),
             lambda: pk.chain_reference(x, w1, iters)),
            ("P3", (w1, w2), lambda: pk.pair_matmul(x, w1, w2, iters),
             lambda: pk.pair_reference(x, w1, w2, iters))):
        ms, plain_ms = _ab_ms(plain, kernel, 2)
        lib_ms = _time_ms(lambda: library(ws), 2)
        graph_ms = library_graph_ms(ws)
        flops = 2.0 * m * k * n * iters * len(ws)
        nbytes = 2.0 * (m * k + len(ws) * k * n) + 4.0 * (
            1 + len(ws) * n // pk.CHECKSUM_GROUP)
        bound_ms, bound_by = _bound(nbytes, 0.0, flops)
        d = pk.device_chain_design(m, k, n, len(ws))
        print(f"phase 12: {name} ({m}, {k}) x ({k}, {n}), {iters} "
              f"iterations, {len(ws)} chain(s): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, a loop of torch.matmul (bf16) "
              f"{lib_ms:.4f} ms eager, {graph_ms:.4f} ms replayed from a "
              f"CUDA graph of 200 iterations (the kernel "
              f"{'faster' if ms < graph_ms else 'slower'}, "
              f"{ms / graph_ms:.3f} x its time), bound {bound_ms:.4f} ms by "
              f"{bound_by} ({flops / 1e9:.1f} GFLOP of bf16 operands at "
              f"{PEAK_BF16 / 1e12} TFLOP/s, {nbytes / 1e6:.2f} MB), the "
              f"kernel at {100 * bound_ms / ms:.1f} % of it; the {d.design} "
              f"design ({smi})")
        numbers[name] = dict(max_abs_err=worst[name == "P3"], ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms,
                             library_graph_ms=graph_ms,
                             design=_chain_kernel_name(d, k, len(ws)))
    _print_parent_turns("phase 12", "P2", parent)
    _print_parent_turns("phase 12", "P3", parent)

    pk.chain_matmul.launches = pk.pair_matmul.launches = 0
    results = depth_pack_probe.measure(
        log=lambda line: print(f"phase 12: probe: {line}"))
    launches = {"P2": pk.chain_matmul.launches,
                "P3": pk.pair_matmul.launches}
    print("phase 12: probe result: " + json.dumps(results))
    print(f"phase 12: the probe launched P2 {launches['P2']} and P3 "
          f"{launches['P3']} times ({smi})")
    return numbers["P2"], numbers["P3"], launches


def _small_stage1_config(dtype: str = "float32") -> dict:
    return {"generator": {"embedding_dim": 16, "n_codes": 32,
                          "n_hiddens": 32, "n_res_layers": 1,
                          "downsample": (1, 2, 2), "sequence_length": 4,
                          "resolution": 8, "dtype": dtype},
            "losses": {"loss_dict": {"l_dummy": 1.0}},
            "lr_args": {"gen_lr": 4e-4}}


def _small_stage1_step(torch, device, dtype: str = "float32") -> dict:
    """One stage-1 step (the codebook's first: init, EMA update, restarts
    of the unused codes) at a small width and the compute ``dtype`` on
    ``device`` with injected candidate rows: the loss, every gradient, the
    VQ-VAE's buffers after the step. (The card's tests run it too.)"""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage1

    config = _small_stage1_config(dtype)
    state = stage1.build_stage1(config, device,
                                torch.Generator().manual_seed(0))
    batch = stage1.synthetic_batch(config, 2)
    g = torch.Generator().manual_seed(3)
    draws = dict(init_rows=torch.randn((32, 16), generator=g),
                 restart_rows=torch.randn((32, 16), generator=g))
    values = stage1.train_step(state, batch, **draws)
    return dict(
        loss=float(values["total"]),
        grads={n: p.grad.cpu() for n, p in state.vqvae.named_parameters()},
        buffers={n: b.cpu() for n, b in state.vqvae.named_buffers()})


def _compare_stage1_steps(torch, got: dict, want: dict, bf16: bool = False
                          ) -> tuple[float, float, float]:
    """(loss, gradient, buffer) errors of a step against another: relative;
    each gradient and buffer against its tensor's max-abs, the gradients'
    scale floored at 1e-2 of the largest gradient (a bias in front of a
    training-mode BatchNorm has a zero gradient analytically: what comes
    back is the rounding noise of cancelling sums of large terms); in bf16
    each gradient against the largest gradient."""
    lerr = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    top = max(float(w.abs().max()) for w in want["grads"].values())
    gerr = max(float((got["grads"][n] - w).abs().max())
               / (top if bf16 else max(float(w.abs().max()), 1e-2 * top))
               for n, w in want["grads"].items())
    berr = 0.0
    for n, w in want["buffers"].items():
        b = got["buffers"][n]
        if w.dtype == torch.bool:
            if not torch.equal(b, w):
                raise AssertionError(f"buffer {n} differs")
            continue
        berr = max(berr, float((b - w).abs().max())
                   / max(float(w.abs().max()), 1e-6))
    return lerr, gerr, berr


def phase_stage1(torch, smi: str, profile: bool) -> dict:
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage1

    cpu = {dt: _small_stage1_step(torch, "cpu", dt)
           for dt in ("float32", "bfloat16")}
    drift = _compare_stage1_steps(torch, cpu["bfloat16"], cpu["float32"],
                                  True)[1]
    print(f"phase 13: the small stage-1 step's bf16 gradients lie {drift:.3e} "
          f"of the largest gradient from its f32 ones (CPU)")
    for dtype, ltol, gtol, btol in (
            ("float32", TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, STAGE1_STATE_TOL),
            ("bfloat16", BF16_TRAIN_TOL, BF16_STAGE1_GRAD_SHARE * drift,
             BF16_TRAIN_TOL)):
        lerr, gerr, berr = _compare_stage1_steps(
            torch, _small_stage1_step(torch, "cuda", dtype), cpu[dtype],
            dtype == "bfloat16")
        print(f"phase 13: small stage-1 step (B=2, 4 x 8 x 8 px, 32 codes "
              f"of dim 16; init, EMA update and restarts; {dtype} compute) "
              f"on the card vs the CPU: loss relative {lerr:.3e} (tol "
              f"{ltol}); gradients within {gerr:.3e} (tol {gtol:.3e}); "
              f"codebook buffers and running statistics within {berr:.3e} "
              f"(tol {btol})")
        if not lerr <= ltol or not gerr <= gtol or not berr <= btol:
            raise AssertionError(f"the {dtype} stage-1 step on the card "
                                 f"disagrees with the CPU")
    k6 = _timed_train1(torch, smi, "TRAIN_STEP1", stage1.TRAIN_STEP1,
                       stage1.TRAIN_STEP1_BATCH, profile, sync_check=True)
    k6 += _timed_train1(torch, smi, "TRAIN_STEP128", stage1.TRAIN_STEP128,
                        stage1.TRAIN_STEP128_BATCH, profile)
    return {"K6": k6}


def _timed_train1(torch, smi: str, label: str, config: dict, b: int,
                  profile: bool, sync_check: bool = False) -> int:
    """8 stage-1 steps of ``config`` at batch ``b`` on a fixed synthetic
    batch: the first (data-dependent init), 2 warm-up, 5 timed, one K6
    launch each; the loss must fall. With ``sync_check`` one more step with
    host synchronisation forbidden. Then where a step's time goes (CUDA
    events between its parts; with ``profile`` by kernel). Returns the K6
    launches of the timed steps."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
        import nearest_code_stats
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage1
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.metrics import (
        weighted_losses)

    t0 = time.perf_counter()
    state = stage1.build_stage1(config, "cuda",
                                torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    dtype = config["generator"]["dtype"]
    label = f"{label} ({config['generator']['resolution']} px, {dtype})"
    print(f"phase 13: built {label} in {time.perf_counter() - t0:.2f} s; "
          f"{sum(p.numel() for p in state.vqvae.parameters())} trained "
          f"parameters")
    batch = {"video": torch.from_numpy(
        stage1.synthetic_batch(config, b)["video"]).to("cuda")}
    g = torch.Generator(device="cuda").manual_seed(2)
    cb = state.vqvae.codebook
    # the perplexity rides along as a monitor of weight 0
    state.loss_dict = dict(state.loss_dict, l_perplexity=0.0)
    losses, seconds, k6 = [], [], 0
    torch.cuda.reset_peak_memory_stats()
    for i in range(8):
        nearest_code_stats.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        values = stage1.train_step(state, batch, g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        count = nearest_code_stats.launches
        restarted = int((cb.ema_count < 1.0).sum())
        kind = ("init" if i == 0 else "warm-up" if i < 3 else "timed")
        loss = float(values["total"])
        print(f"phase 13: {label} B={b} step {i} ({kind}): {dt:.4f} s, "
              f"loss {loss:.6f}, perplexity "
              f"{float(values['l_perplexity']):.2f}, {restarted} codes "
              f"restarted; K6 launches {count}")
        if count != 1:
            raise AssertionError(f"step {i}: K6 launched {count} times, "
                                 f"expected 1")
        if not math.isfinite(loss):
            raise AssertionError("the stage-1 loss is not finite")
        losses.append(loss)
        if i >= 3:
            seconds.append(dt)
            k6 += count
    per_step = sum(seconds) / len(seconds)
    print(f"phase 13: {label} B={b}: {per_step * 1e3:.2f} ms/step = "
          f"{1 / per_step:.3f} steps/s over {len(seconds)} timed steps (min "
          f"{min(seconds) * 1e3:.2f}, max {max(seconds) * 1e3:.2f}); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; loss on the fixed batch {losses[0]:.4f} at the first "
          f"step, {losses[-1]:.4f} at the last; {smi}")
    if not losses[-1] < losses[0] or not bool(cb.initialized):
        raise AssertionError("the stage-1 loss did not fall")

    if sync_check:   # one more step with host synchronisation forbidden
        torch.cuda.set_sync_debug_mode("error")
        try:
            values = stage1.train_step(state, batch, g)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"phase 13: a step under torch.cuda.set_sync_debug_mode("
              f"'error') ran through: no host synchronisation inside the "
              f"step (loss {float(values['total']):.6f})")

    # where a step's time goes: CUDA events between its parts
    parts = ("preprocess", "encoder", "codebook (K6, EMA, restarts)",
             "decoder + losses", "backward", "adam")
    steps = 3
    part_ms = dict.fromkeys(parts, 0.0)
    vq = state.vqvae
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        video = stage1._video(state, batch)
        state.optimizer.zero_grad(set_to_none=True)
        ev[1].record()
        z = vq.pre_vq_conv(vq.encoder(video, True))
        ev[2].record()
        q = vq.codebook(z, train=True, generator=g)
        ev[3].record()
        recon = vq.decoder(vq.post_vq_conv(q["embeddings"]), True)
        total = weighted_losses({"l_dummy": 1.0}, {"losses": {
            "recon_loss": torch.mean(torch.square(recon.float() - video))
            * vq.recon_loss_scale,
            "commitment_loss": q["commitment_loss"]}})[0]
        ev[4].record()
        total.backward()
        ev[5].record()
        state.optimizer.step()
        ev[6].record()
        torch.cuda.synchronize()
        for i, name in enumerate(parts):
            part_ms[name] += ev[i].elapsed_time(ev[i + 1]) / steps
    print(f"phase 13: {label} device ms/step by part (CUDA events, mean of "
          f"{steps} steps): " + ", ".join(f"{n} {t:.2f}" for n, t in
                                          part_ms.items())
          + f"; sum {sum(part_ms.values()):.2f}")
    if profile:
        _profile_kernels(torch, f"phase 13 {label}",
                         lambda: stage1.train_step(state, batch, g))
    return k6


# the text tower and the FVD networks on the card against the same modules
# on the CPU (f32, TF32 off: sums in other orders only), relative to the
# output's max-abs; the Fréchet distance of the two sides' embeddings,
# relative (a float64 SVD of near-singular covariances on the host)
TEXT_TOWER_TOL = 1e-4
FVD_NET_TOL = 1e-4
FVD_TOL = 1e-3
TEXT_CAPTIONS = ("a man is singing on stage", "BreastStroke", "",
                 "a dog doesn't want to fetch the ball", "BaseballPitch",
                 "cartoon characters are fighting, it's intense!",
                 "someone's driving a car at 100 mph", "archery")


def _text_tokens(b: int):
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.clip_text \
        import HashTokenizer
    return HashTokenizer()([TEXT_CAPTIONS[i % len(TEXT_CAPTIONS)]
                            for i in range(b)])


def _on_card_and_cpu(torch, build, run, seed: int):
    """``run(module, device)`` of the module ``build()`` makes and
    initialises from ``seed`` on the CPU, first on the CPU, then on the card
    (the same weights): (card output on the CPU, CPU output, relative
    max-abs error)."""
    module = build(torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():
        want = run(module, "cpu")
        got = run(module.to("cuda"), "cuda").cpu()
    return got, want, float((got - want).abs().max() / want.abs().max())


def _clip_tower(generator):
    import torch
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.clip_text \
        import ClipTextModel, init_clip_text_
    with torch.device("meta"):
        tower = ClipTextModel()
    tower = tower.to_empty(device="cpu")
    init_clip_text_(tower, generator)
    return tower


def _i3d(generator):
    import torch
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.i3d import (
        InceptionI3d, init_i3d_)
    with torch.device("meta"):
        net = InceptionI3d(num_classes=400)
    net = net.to_empty(device="cpu")
    init_i3d_(net, generator)
    return net


def _resnet50(generator):
    """ResNet-50 with flax's init laws for its kernels and seeded BatchNorm
    statistics (the JAX package's module has no init law of its own)."""
    import torch
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.resnet import (
        ResNet50)
    net = ResNet50()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.ndim > 1:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
            else:
                p.normal_(1.0 if name.endswith("weight") and "bn" in name
                          else 0.0, 0.1, generator=generator)
        for name, buf in net.named_buffers():
            buf.normal_(0.0, 0.1, generator=generator)
            if name.endswith("running_var"):
                buf.abs_().add_(0.5)
    return net


def _check_tower(torch, phase: str, b: int) -> tuple[float, float]:
    """The full CLIP text tower (width 512, 12 layers) at batch ``b`` on the
    card against the CPU; returns (relative error, card ms per call)."""
    tokens = torch.from_numpy(_text_tokens(b)).long()
    got, want, err = _on_card_and_cpu(
        torch, _clip_tower, lambda m, dev: m(tokens.to(dev)), 21)
    print(f"{phase}: CLIP text tower (512 wide, 8 heads, 12 layers) B={b} "
          f"on the card vs the CPU: pooled features {tuple(got.shape)} "
          f"within {err:.3e} of their max-abs {float(want.abs().max()):.3e} "
          f"(tol {TEXT_TOWER_TOL})")
    if not err <= TEXT_TOWER_TOL:
        raise AssertionError("the CLIP tower on the card disagrees with the "
                             "CPU")
    tower = _clip_tower(torch.Generator().manual_seed(21)).to("cuda")
    tok = tokens.to("cuda")
    with torch.no_grad():
        ms = _time_ms(lambda: tower(tok), 10)
    return err, ms


def phase_text(torch, smi: str, profile: bool) -> dict:
    """Text conditioning: the CLIP tower on the card against the CPU; text-
    conditioned sampling at the honest width on the route 'auto' takes (K3),
    each of three of its steps held against the plain whole step; then
    ``TRAIN_STEP2_MSRVTT`` steps (the tower inside each, 2304 tokens, bf16
    denoiser) with the launches of K2, K5 and K6 read per step."""
    import copy as _copy

    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        HONEST, build_models)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.\
        discrete_diffusion import resolve_sampler
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
        TRAIN_STEP2_BATCH, TRAIN_STEP2_MSRVTT)

    _, tower_ms = _check_tower(torch, "phase 15", 16)
    print(f"phase 15: CLIP text tower B=16 forward on the card "
          f"{tower_ms:.4f} ms; {smi}")

    config = _copy.deepcopy(HONEST)
    config["generator"]["textencoder"] = {"mode": "text", "dim": 512}
    t0 = time.perf_counter()
    models = build_models(config, "cuda", torch.Generator().manual_seed(5))
    gen, b = models.generator, 4
    d3pm, tr = gen.diffusion, gen.diffusion.transformer
    batch = {"text_tokens": _text_tokens(b)}
    cond, cf = gen.conditioner_embeddings(batch, b)
    L = d3pm.content_seq_len
    route = resolve_sampler("auto", torch.device("cuda"), L, tr, True)
    print(f"phase 15: built HONEST with text conditioning in "
          f"{time.perf_counter() - t0:.2f} s; the CF branch is the tower's "
          f"embedding of the empty caption (max-abs "
          f"{float(cf.abs().max()):.3e}); 'auto' takes the {route} route")
    if route != "megakernel":
        raise AssertionError("text-conditioned sampling should take the "
                             "whole-step kernels")
    tab, kw = mk.prepare_sampling(d3pm.schedule(), tr, cond, cf, b, L,
                                  guidance_scale=d3pm.guidance_scale)
    pack_cfg = kw.pop("pack_cfg")
    T = d3pm.diffusion_step
    tokens = torch.full((b, L), d3pm.num_classes - 1, dtype=torch.int64,
                        device="cuda")
    for i in range(T):
        args = (tab["packed"], tokens, tab["adaln_all"][i], tab["kc"],
                tab["vc"], tab["pos"], tab["rows"][T - 1 - i], 11 + i)
        if i in (0, T // 2, T - 1):
            tokens, _ = _check_megakernel(
                torch, "phase 15", f"K3 text-conditioned step t={T - 1 - i} "
                f"(B={b}, L={L}, 19 layers)", args, kw, pack_cfg)
        else:
            tokens = mk.megakernel_step(*args, sample=False,
                                        pack_cfg=pack_cfg,
                                        scratch=tab["scratch"], **kw)
    _reset_megakernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampled = gen.sample(batch, b, generator=torch.Generator().manual_seed(3),
                         sample=False, mode="auto")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k3, k4 = _megakernel_counts()
    print(f"phase 15: DiscreteDiffusionModel.sample(mode='auto') with text "
          f"conditioning, B={b}, argmax: {dt:.3f} s, launches K3 {k3}, K4 "
          f"{k4}; MASK left {int((sampled == d3pm.num_classes - 1).sum())}; "
          f"the manual loop's tokens equal {torch.equal(sampled, tokens)}")
    if (k3, k4) != (T, 0):
        raise AssertionError("text-conditioned sampling did not launch K3 "
                             "once a step")
    if bool((sampled == d3pm.num_classes - 1).any()) or \
            int(sampled.min()) < 0:
        raise AssertionError("text-conditioned sampling left MASK tokens")
    del models, gen, tab, tokens, sampled
    torch.cuda.empty_cache()

    state, tbatch, g, launches = _timed_train2(
        torch, smi, TRAIN_STEP2_MSRVTT, TRAIN_STEP2_BATCH, 5, 2,
        phase="phase 15", name="TRAIN_STEP2_MSRVTT (text, 2304 tokens)")
    if profile:
        _profile_step(torch, state, tbatch, g, phase="phase 15")
    return {"K2": launches["K2"], "K5": launches["K5"], "K6": launches["K6"],
            "K3": k3}


def phase_fvd(torch, smi: str) -> dict:
    """FVD: the I3D and ResNet-50 on the card against the CPU at a small
    input and at one 224 px batch of 2, the Fréchet distance of both sides'
    I3D embeddings, then the bench's FVD pipeline in this process (honest:
    100 K3 launches a pass, a warm-up pass and a timed one) with its K3
    launches counted, and one more pass timed by part."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch import bench
    from gif_synthesis_with_discrete_diffusion_tpu_torch.eval.evaluator \
        import frechet_distance

    g = torch.Generator().manual_seed(31)
    for label, shape in (("small clips", (16, 16, 32, 32, 3)),
                         ("224 px", (2, 16, 224, 224, 3))):
        x = torch.randn(shape, generator=g)
        got, want, err = _on_card_and_cpu(
            torch, _i3d, lambda m, dev: m(x.to(dev)), 32)
        print(f"phase 16: I3D {label} {shape} on the card vs the CPU: "
              f"logits within {err:.3e} of their max-abs (tol "
              f"{FVD_NET_TOL})")
        if not err <= FVD_NET_TOL:
            raise AssertionError("the I3D on the card disagrees with the "
                                 "CPU")
        if label == "small clips":
            n = shape[0] // 2
            fvd_card = frechet_distance(got[:n].numpy(), got[n:].numpy())
            fvd_cpu = frechet_distance(want[:n].numpy(), want[n:].numpy())
            ferr = abs(fvd_card - fvd_cpu) / abs(fvd_cpu)
            print(f"phase 16: Fréchet distance of {n} vs {n} clips' I3D "
                  f"logits: card {fvd_card:.6f}, CPU {fvd_cpu:.6f} "
                  f"(relative {ferr:.3e}, tol {FVD_TOL})")
            if not ferr <= FVD_TOL:
                raise AssertionError("the Fréchet distance of the card's "
                                     "embeddings disagrees with the CPU's")
    for label, shape in (("64 px", (4, 64, 64, 3)),
                         ("224 px", (2, 224, 224, 3))):
        x = torch.randn(shape, generator=g)
        for features_only in (False, True):
            _, _, err = _on_card_and_cpu(
                torch, _resnet50,
                lambda m, dev: m(x.to(dev), features_only=features_only), 33)
            what = "features" if features_only else "logits"
            print(f"phase 16: ResNet-50 {label} {shape} on the card vs the "
                  f"CPU: {what} within {err:.3e} of their max-abs (tol "
                  f"{FVD_NET_TOL})")
            if not err <= FVD_NET_TOL:
                raise AssertionError("the ResNet-50 on the card disagrees "
                                     "with the CPU")
    torch.cuda.empty_cache()

    _reset_megakernel_counts()
    torch.cuda.reset_peak_memory_stats()
    row = bench.bench_fvd_pipeline("cuda", bench.CONFIGS["honest"])
    k3, k4 = _megakernel_counts()
    steps = 100
    print(f"phase 16: FVD pipeline (honest, B=32: sample on the megakernel "
          f"route, decode, I3D at 224 px, Fréchet) in this process: "
          f"{json.dumps(row)}; launches K3 {k3}, K4 {k4} (two passes); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; {smi}")
    if (k3, k4) != (2 * steps, 0) or not math.isfinite(row["fvd"]):
        raise AssertionError("the FVD path did not run K3 once a step or "
                             "gave no finite FVD")
    _fvd_pass_split(torch, smi)
    return {"K3": k3}


def _fvd_pass_split(torch, smi: str) -> None:
    """Where one pass of the FVD pipeline's time goes (honest, B=32, after
    the bench's passes have warmed cuDNN up; host clock, each part ending
    in ``synchronize()``): sampling (K3), the decode, the I3D embedding of
    both sets (``prepare_fvd_clip`` included), the Fréchet distance on the
    host."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch import bench
    from gif_synthesis_with_discrete_diffusion_tpu_torch.eval.evaluator \
        import FVDEvaluator, frechet_distance
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        build_models)

    cfg = bench.CONFIGS["honest"]
    models = build_models(cfg.models, "cuda",
                          torch.Generator().manual_seed(0))
    d3pm, b = models.generator.diffusion, cfg.batch
    cond = torch.zeros((b, 1, 512), device="cuda")
    gt = (torch.randn((b, 16, 64, 64, 3),
                      generator=torch.Generator().manual_seed(7))
          * 0.3).to("cuda")
    ev = FVDEvaluator(generator=torch.Generator().manual_seed(3),
                      device="cuda")
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    with torch.no_grad():
        tokens = d3pm.sample(cond, torch.zeros_like(cond), b,
                             generator=torch.Generator().manual_seed(11),
                             mode="megakernel")
        mark()
        video = models.vqvae.decode(tokens.reshape(b, *models.latent_shape))
        mark()
        want, got = ev.embed(gt), ev.embed(video)
        mark()
    fvd = frechet_distance(got.cpu().numpy(), want.cpu().numpy())
    marks.append(time.perf_counter())
    parts = dict(zip(("sampling (K3)", "decode", "I3D, both sets",
                      "Fréchet on the host"),
                     (t1 - t0 for t0, t1 in zip(marks, marks[1:]))))
    total = marks[-1] - marks[0]
    print(f"phase 16: one FVD pass (honest, B=32) by part: " + ", ".join(
        f"{n} {t:.3f} s ({100 * t / total:.1f} %)" for n, t in parts.items())
        + f"; {total:.3f} s = {b / total:.3f} clips/s; FVD {fvd:.6g}; {smi}")


# the bench rows of phase 14, in the order of the JAX bench's table: all
# nine of its rows
BENCH_ROWS = (("sampling", "honest"), ("sampling", "msrvtt"),
              ("sampling", "half"), ("vqvae", "honest"),
              ("train_step", "honest"), ("train_step128", "honest"),
              ("train_step2", "honest"), ("train_step2", "msrvtt"),
              ("fvd_pipeline", "honest"))
BENCH_ROW_TIMEOUT = 300


def phase_samplers(torch) -> None:
    """The log-onehot samplers (reference with and without filter_ratio,
    fast, token budget) at a small size on the card against the same runs on
    the CPU, in argmax mode (the token budget's host seeds from the same CPU
    generator): the tokens must be equal."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        build_models)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import d3pm

    out = {}
    for dev in ("cuda", "cpu"):
        models = build_models(_small_train_config(), dev,
                              torch.Generator().manual_seed(11))
        gen = models.generator
        batch = {"label": torch.tensor([0, 3, 4])}
        cond, cf = gen.conditioner_embeddings(batch, 3)
        dm = gen.diffusion
        content = torch.randint(0, 16, (3, 32),
                                generator=torch.Generator().manual_seed(5))
        runs = {
            "reference": lambda: dm.sample(
                cond, cf, 3, generator=torch.Generator().manual_seed(1),
                mode="reference", sample=False),
            "reference, filter_ratio 0.5": lambda: dm.sample(
                cond, cf, 3, generator=torch.Generator().manual_seed(1),
                filter_ratio=0.5, content_token=content, sample=False),
            "fast, skip_step 2": lambda: dm.sample_fast(
                cond, cf, 3, 2, generator=torch.Generator().manual_seed(1),
                sample=False),
            "token budget": lambda: d3pm.sample_with_token_budget(
                torch.Generator().manual_seed(1), dm.schedule(),
                dm.transformer, cond, cf, 3, 32, guidance_scale=2.0,
                prior_ps=32, sample=False),
        }
        with torch.no_grad():
            out[dev] = {name: run().cpu() for name, run in runs.items()}
    for name, tokens in out["cuda"].items():
        same = torch.equal(tokens, out["cpu"][name])
        print(f"phase 14: {name} sampler (T=8, K=17, L=32, B=3, argmax) on "
              f"the card vs the CPU: tokens equal {same}, MASK left "
              f"{int((tokens == 16).sum())}")
        if not same or bool((tokens == 16).any()):
            raise AssertionError(f"the {name} sampler on the card disagrees "
                                 f"with the CPU")


def phase_bench(torch) -> dict:
    """Each bench row as a child process of the package's bench entry, its
    one JSON line parsed and printed."""
    rows = {}
    for metric, config in BENCH_ROWS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.bench", "--metric", metric,
             "--config", config], cwd=ROOT, capture_output=True, text=True,
            timeout=BENCH_ROW_TIMEOUT)
        lines = proc.stdout.strip().splitlines()
        row = json.loads(lines[-1]) if lines else {}
        print(f"phase 14: bench --metric {metric} --config {config} (exit "
              f"{proc.returncode}, {time.perf_counter() - t0:.1f} s): "
              + json.dumps(row))
        if proc.returncode != 0 or len(lines) != 1:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"bench row {metric} --config {config} "
                                 f"failed")
        need = {"value", "spread", "device", "vs_baseline", "metric"}
        if metric == "sampling":
            need |= {"ms_per_step", "bound_ms", "mfu"}
        if metric == "fvd_pipeline":
            need |= {"fvd", "route"}
        if not need <= set(row) or not row["value"] > 0:
            raise AssertionError(f"bench row {metric} --config {config} "
                                 f"lacks {need - set(row)}")
        if metric == "sampling" and not (
                row["mfu"] <= 1.0 and row["bound_ms"] <= row["ms_per_step"]):
            raise AssertionError("a share of the bound above 100 %")
        if metric == "fvd_pipeline" and not math.isfinite(row["fvd"]):
            raise AssertionError("the FVD pipeline gave no finite FVD")
        rows[(metric, config)] = row
    return rows


# phase 17: the harness (tasks.train / tasks.evaluate, the trainer loop, the
# checkpoints, the CLIs) at the job scripts' full widths on the synthetic
# datamodule, 16-frame 64 px clips, CSV logging
HARNESS_BASE = ("datamodule=synthetic", "datamodule.sequence_length=16",
                "datamodule.resolution=64", "logger=csv")
HARNESS_CLI_TIMEOUT = 300


def _job_overrides(script: str) -> list[str]:
    """The override line of ``scripts/tpu/<script>`` (as
    ``tests/test_job_scripts.py`` extracts it)."""
    import shlex
    text = (ROOT / "scripts" / "tpu" / script).read_text()
    m = re.search(r"python scripts/train\.py(.*?)(?:\n\n|\Z)", text,
                  re.DOTALL)
    args = shlex.split(m.group(1).replace("\\\n", " "))
    return [a for a in args if a != '"$@"' and "=" in a]


def _harness_counts() -> dict:
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import fused_sample_step
    k2, k5, k6 = _counts()
    k3, k4 = _megakernel_counts()
    return {"K1": fused_sample_step.launches, "K2": k2, "K5": k5, "K6": k6,
            "K3": k3, "K4": k4}


def _reset_harness_counts() -> None:
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import fused_sample_step
    _reset_counts()
    _reset_megakernel_counts()
    fused_sample_step.launches = 0


class _StepProbe:
    """Wraps a trainer class's ``train_step`` for one run: host clock and
    CUDA events at each step's entry and exit, the trainer itself, a
    callback before the first step, and host synchronisation forbidden
    from the end of step ``guard[0] - 1`` to the end of step ``guard[1]``
    (the loop between them included: the batch's copy, the accumulator)."""

    def __init__(self, torch, cls, guard: tuple[int, int] | None = None,
                 before_first=None):
        self.torch, self.cls, self.guard = torch, cls, guard
        self.before_first = before_first
        self.trainer = None
        self.host: list[tuple[float, float]] = []
        self.events: list[tuple] = []
        self.guarded = 0

    def __enter__(self):
        torch, orig = self.torch, self.cls.train_step

        def wrapped(trainer, state, batch, rng):
            k = len(self.host) + 1
            if k == 1:
                self.trainer = trainer
                if self.before_first is not None:
                    self.before_first(trainer)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = orig(trainer, state, batch, rng)
            end.record()
            self.host.append((t0, time.perf_counter()))
            self.events.append((start, end))
            if self.guard and k == self.guard[0] - 1:
                torch.cuda.synchronize()
                self.host[-1] = (t0, time.perf_counter())
                torch.cuda.set_sync_debug_mode("error")
            elif self.guard and k == self.guard[1]:
                torch.cuda.set_sync_debug_mode("default")
                self.guarded = self.guard[1] - self.guard[0] + 1
            return out

        self.cls.train_step = wrapped
        self._orig = orig
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode("default")
        self.cls.train_step = self._orig
        return False

    def timing(self, first: int) -> tuple[float, float, float, float]:
        """Steps ``first``.. (1-based, ``first`` >= 2), on the device's
        timeline: the mean step (from the end event of step ``first - 1`` to
        the end event of the last), the mean of the steps' own spans (entry
        to exit event), the share of the loop's time outside those spans
        (the device without work of a step while the host takes the next
        batch, copies it and adds up the values), and on the host clock the
        mean time to issue a step."""
        self.torch.cuda.synchronize()
        steps = self.events[first - 1:]
        total = self.events[first - 2][1].elapsed_time(steps[-1][1]) / 1e3
        spans = sum(s.elapsed_time(e) for s, e in steps) / 1e3
        issue = sum(t1 - t0 for t0, t1 in self.host[first - 1:])
        n = len(steps)
        return (total / n, spans / n, max(0.0, 1.0 - spans / total),
                issue / n)


def _run_dir(out: Path) -> Path:
    dirs = [p for p in out.iterdir() if p.is_dir()]
    if len(dirs) != 1:
        raise AssertionError(f"expected one run directory under {out}, "
                             f"found {len(dirs)}")
    return dirs[0]


def _newest_state(torch, ckpt_dir: Path) -> tuple[int, dict]:
    step = max(int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit())
    return step, torch.load(ckpt_dir / str(step) / "state.pt",
                            map_location="cpu", weights_only=True)


def _tensors(tree, prefix: str = ""):
    """(name, tensor) leaves of a nested state dict."""
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}[{i}]")
    elif hasattr(tree, "dtype") and hasattr(tree, "shape"):
        yield prefix, tree


def _bitwise_equal(torch, got, want, what: str) -> int:
    """Every tensor of ``want`` present in ``got`` with the same bits."""
    got = dict(_tensors(got))
    n = 0
    for name, w in _tensors(want):
        g = got.get(name)
        if g is None or g.dtype != w.dtype or not torch.equal(
                g.detach().cpu(), w.cpu()):
            raise AssertionError(f"{what}: {name} differs")
        n += 1
    return n


def phase_harness(torch, smi: str) -> dict:
    """The harness on the card: stage 1 and stage 2 through ``tasks.train``
    at the job scripts' full widths, stage 2 reading stage 1's checkpoint,
    resume, ``tasks.evaluate``, and the two entries as child processes.
    Returns each run's launches of every kernel."""
    import shutil

    from gif_synthesis_with_discrete_diffusion_tpu_torch import tasks
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage1 import (
        Stage1Trainer)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
        Stage2Trainer)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.utils.config import (
        compose)

    torch.cuda.empty_cache()
    try:
        importlib.import_module("imageio")
        imageio = "present"
    except ImportError:
        imageio = "absent (renders are logged as failed, no GIF written)"
    print(f"phase 17: imageio {imageio}")
    base = ROOT / "logs" / "chip_smoke_harness" / f"{time.time_ns()}"
    out = {name: base / name for name in
           ("stage1", "stage2", "resume", "eval", "cli_train", "generate")}
    runs: dict[str, dict] = {}

    def run(name: str, task: str, overrides: list[str], probe=None):
        cfg = compose(task, overrides + [f"paths.output_dir={out[name]}"])
        _reset_harness_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if probe is None:
            metrics = (tasks.train if task == "train" else tasks.evaluate)(cfg)
        else:
            with probe:
                metrics = (tasks.train if task == "train"
                           else tasks.evaluate)(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _harness_counts()
        run_dir = _run_dir(out[name])
        gifs = len(list(run_dir.glob("*.gif")))
        runs[name] = counts
        bad = {k: v for k, v in metrics.items()
               if isinstance(v, float) and not math.isfinite(v)}
        print(f"phase 17: {name} ({task}): wall {wall:.2f} s; launches "
              + ", ".join(f"{k} {v}" for k, v in counts.items())
              + f"; {gifs} GIFs; metrics "
              + json.dumps({k: round(v, 6) for k, v in sorted(
                  metrics.items())}))
        if bad:
            raise AssertionError(f"{name}: non-finite metrics {bad}")
        return cfg, metrics, run_dir

    # 1. stage 1 at vqvae_ucf.sh's line: 2 steps of B=64, validation, the
    # reconstruction FVD, the renders
    s1 = _job_overrides("vqvae_ucf.sh") + list(HARNESS_BASE) + [
        "trainer.max_epochs=1", "trainer.max_steps=2",
        "datamodule.num_train=128", "datamodule.num_val=64"]
    probe1 = _StepProbe(torch, Stage1Trainer)
    cfg1, m1, run1 = run("stage1", "train", s1, probe1)
    g = cfg1["model"]["generator"]
    step, span, share, issue = probe1.timing(2)
    print(f"phase 17: stage 1 (n_codes {g['n_codes']}, n_hiddens "
          f"{g['n_hiddens']}, {g['n_res_layers']} residual layers, "
          f"downsample {g['downsample']}, B={cfg1['batch_size']}, "
          f"{g['sequence_length']} f {g['resolution']} px, {g['dtype']}): "
          f"{len(probe1.host)} steps; step 2 (the first after the codebook's "
          f"init) {step:.4f} s in the loop, {span:.4f} s inside the step, "
          f"{100 * share:.2f} % of the loop outside the step (CUDA events); "
          f"{issue:.4f} s to issue it (host clock); {smi}")
    if (probe1.trainer.global_step != 2 or "Metrics/fvd-val" not in m1
            or runs["stage1"]["K6"] < 2):
        raise AssertionError("stage 1 did not take 2 steps with K6, or "
                             "gave no FVD")

    # 2. stage 2 at ddiff_ucf.sh's line over run 1's checkpoint: 4 steps,
    # steps 2-3 (and the loop between them) with host synchronisation
    # forbidden, validation, FVD on the val split, the three renders
    ck1 = run1 / "checkpoints"
    step1, saved1 = _newest_state(torch, ck1)
    s2 = _job_overrides("ddiff_ucf.sh") + list(HARNESS_BASE) + [
        f"model.checkpoint_paths.autoencoder={ck1}"]
    checked = {}

    def vqvae_is_run1s(trainer):
        checked["vqvae"] = _bitwise_equal(
            torch, trainer.state.vqvae.state_dict(), saved1["vqvae"],
            "the frozen VQ-VAE against run 1's checkpoint")
    probe2 = _StepProbe(torch, Stage2Trainer, guard=(2, 3),
                        before_first=vqvae_is_run1s)
    cfg2, m2, run2 = run("stage2", "train", s2 + ["trainer.max_epochs=1"],
                         probe2)
    t2 = probe2.trainer
    _bitwise_equal(torch, t2.state.vqvae.state_dict(), saved1["vqvae"],
                   "the frozen VQ-VAE after run 2")
    tr = cfg2["model"]["generator"]["diffusion_model"]["transformer"]
    step, span, share, issue = probe2.timing(2)
    lt2 = float(t2.state.generator.diffusion.lt_count.sum())
    print(f"phase 17: stage 2 ({tr['n_layer']} layers, n_embd "
          f"{tr['n_embd']}, {tr['n_head']} heads, "
          f"{t2.state.generator.diffusion.content_seq_len} tokens over "
          f"{cfg2['model']['autoencoder']['n_codes']} codes, "
          f"{cfg2['model']['generator']['diffusion_model']['diffusion_step']}"
          f" steps, B={cfg2['batch_size']}, {tr['dtype']} denoiser, sampler "
          f"route {t2.sampler}): the frozen VQ-VAE equals run 1's step-"
          f"{step1} checkpoint bitwise ({checked['vqvae']} tensors) before "
          f"the first step and after the run; {len(probe2.host)} steps; "
          f"steps 2-4 {step:.4f} s a step in the loop, {span:.4f} s inside "
          f"each step, {100 * share:.2f} % of the loop outside the steps "
          f"(CUDA events); {issue:.4f} s to issue a step (host clock); "
          f"steps {probe2.guard[0]}-"
          f"{probe2.guard[1]} under set_sync_debug_mode('error'): "
          f"{probe2.guarded} steps ran through; Lt count {lt2:.0f}; {smi}")
    c2 = runs["stage2"]
    sampled = c2["K3"] if t2.sampler == "megakernel" else c2["K1"]
    if (t2.global_step != 4 or probe2.guarded != 2
            or c2["K5"] != 4 * 2 * tr["n_layer"] or c2["K2"] < c2["K5"]
            or c2["K6"] < 4 or sampled < 100 or "Metrics/fvd-val" not in m2):
        raise AssertionError(f"stage 2 did not run its kernels as expected "
                             f"or gave no FVD: {c2}")

    # 3. resume run 2 into a second epoch: 4 -> 8 steps, the restored state
    # bitwise the saved one before the first new step, the Lt counts grown
    ck2 = run2 / "checkpoints"
    step2, saved2 = _newest_state(torch, ck2)

    def restored_is_saved(trainer):
        checked["resume"] = _bitwise_equal(
            torch, trainer.state_dict(), saved2,
            "the restored state against run 2's checkpoint")
        checked["resume_step"] = trainer.global_step
    probe3 = _StepProbe(torch, Stage2Trainer, before_first=restored_is_saved)
    run("resume", "train", s2 + [f"ckpt_path={ck2}", "trainer.max_epochs=2"],
        probe3)
    t3 = probe3.trainer
    lt3 = float(t3.state.generator.diffusion.lt_count.sum())
    print(f"phase 17: resume from run 2's step {step2}: global_step "
          f"{checked['resume_step']} -> {t3.global_step}; the restored state "
          f"equals the checkpoint bitwise ({checked['resume']} tensors) "
          f"before the first new step; Lt count {lt2:.0f} -> {lt3:.0f}")
    if not (checked["resume_step"] == 4 and t3.global_step == 8
            and lt3 > lt2):
        raise AssertionError("the resumed run did not go on from step 4 to "
                             "8 with its Lt counts grown")

    # 4. tasks.evaluate on run 3's checkpoints: the test split's losses and
    # its FVD
    _, m4, _ = run("eval", "eval", s2 + [
        f"ckpt_path={_run_dir(out['resume']) / 'checkpoints'}"])
    if "Metrics/fvd-test" not in m4 or "total/test" not in m4:
        raise AssertionError("evaluate gave no test losses or FVD")

    # 5. the two entries as child processes
    ck3 = _run_dir(out["resume"]) / "checkpoints"
    for name, argv in (
            ("cli_train", ["-m", f"{PKG}.tasks", "train", *s2,
                           "trainer.max_epochs=1", "trainer.max_steps=1",
                           "model.do_evaluation=false",
                           f"paths.output_dir={out['cli_train']}"]),
            ("generate", ["-m", f"{PKG}.generate", *s2,
                          "model.do_evaluation=false", f"ckpt_path={ck3}",
                          "+num_samples=4", f"+out_dir={out['generate']}"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=ROOT,
                              capture_output=True, text=True,
                              timeout=HARNESS_CLI_TIMEOUT)
        lines = proc.stdout.strip().splitlines()
        print(f"phase 17: python {' '.join(argv[:3])} ... (exit "
              f"{proc.returncode}, {time.perf_counter() - t0:.1f} s): "
              f"{lines[-1] if lines else ''}")
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"the {name} entry failed")
    if not re.search(r"generated 4 clips; \d+ GIFs written", lines[-1]):
        raise AssertionError("the generate entry did not report its clips")
    shutil.rmtree(base, ignore_errors=True)
    return runs


REMAT_ROUNDS = 5       # rounds of plain, checkpointed, checkpointed, plain
BN_ROUNDS = 10         # rounds of f32 means, port, port, f32 means
BN_STEP_ROUNDS = 3     # the same with whole stage-1 steps
# (B, T, H, W, C) of the stage-1 configurations' BatchNorms at B=64: the
# latent grid at n_hiddens channels
BN_SHAPES = {"TRAIN_STEP1": (64, 4, 8, 8, 256),
             "TRAIN_STEP128": (64, 4, 16, 16, 256),
             "vqvae_ucf": (64, 16, 8, 8, 256)}
DDP_TIMEOUT = 300      # each child process of phase 18


def _phase18_remat(torch, smi: str) -> dict:
    """(a) ``transformer.checkpoint: true`` at ``TRAIN_STEP2``'s widths (B=16,
    1024 tokens, 19 layers) in f32 and bf16: a first step on fixed draws
    with the same loss and gradients as the plain step (bit for bit) and
    twice its K2 launches; the step's own peak device memory (its peak less
    what was allocated before it); then steps timed in turns (plain,
    checkpointed, checkpointed, plain; CUDA events). Returns the
    checkpointed steps' launches of K2 and K5 by dtype."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
        TRAIN_STEP2, TRAIN_STEP2_BATCH, build_stage2, on_device,
        synthetic_batch, train_step)
    b = TRAIN_STEP2_BATCH
    n_layer = TRAIN_STEP2["generator"]["diffusion_model"]["transformer"][
        "n_layer"]
    host = synthetic_batch(TRAIN_STEP2, b, torch.Generator().manual_seed(1))
    batch = on_device(host, torch.device("cuda"))
    gd = torch.Generator(device="cuda").manual_seed(3)
    draws = {"t": torch.randint(0, 100, (b,), device="cuda", generator=gd),
             "pt": torch.full((b,), 0.01, device="cuda"),
             "noise": torch.rand((b, 4097, 1024), device="cuda",
                                 generator=gd)}
    want = {False: (2 * n_layer, 2 * n_layer, 1),
            True: (4 * n_layer, 2 * n_layer, 1)}
    out = {}
    for dtype in ("float32", "bfloat16"):
        states, first, gens = {}, {}, {}
        launched = {"K2": 0, "K5": 0}

        def step(ck, **kw):
            _reset_counts()
            values = train_step(states[ck], batch, **kw)
            counts = _counts()
            if counts != want[ck]:
                raise AssertionError(f"phase 18: {dtype} checkpoint={ck}: "
                                     f"launches K2, K5, K6 {counts}, "
                                     f"expected {want[ck]}")
            if ck:
                launched["K2"] += counts[0]
                launched["K5"] += counts[1]
            return values

        for ck in (False, True):
            config = copy.deepcopy(TRAIN_STEP2)
            config["generator"]["diffusion_model"]["transformer"].update(
                dtype=dtype, checkpoint=ck)
            states[ck] = build_stage2(config, "cuda",
                                      torch.Generator().manual_seed(0))
            values = step(ck, **draws)
            first[ck] = (float(values["total"]), {
                n: p.grad.clone() for n, p in
                states[ck].generator.named_parameters()
                if p.grad is not None})
            gens[ck] = torch.Generator(device="cuda").manual_seed(2)
            step(ck, generator=gens[ck])                    # warm-up
        (loss0, g0), (loss1, g1) = first[False], first[True]
        differ = [n for n in g0 if not torch.equal(g0[n], g1[n])]
        if loss0 != loss1 or set(g0) != set(g1) or differ:
            largest = max(float(g.abs().max()) for g in g0.values())
            dev = max(float((g0[n] - g1[n]).abs().max()) for n in g0)
            raise AssertionError(
                f"phase 18: {dtype}: the checkpointed step's loss {loss1!r} "
                f"or gradients differ from the plain step's ({loss0!r}; "
                f"{len(differ)} tensors, largest deviation "
                f"{dev / largest:.3g} of the largest gradient)")
        own, peak = {}, {}
        for ck in (False, True):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(ck, generator=gens[ck])
            torch.cuda.synchronize()
            peak[ck] = torch.cuda.max_memory_allocated()
            own[ck] = peak[ck] - base
        ms = {False: [], True: []}
        for _ in range(REMAT_ROUNDS):
            for ck in (False, True, True, False):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                step(ck, generator=gens[ck])
                ev[1].record()
                torch.cuda.synchronize()
                ms[ck].append(ev[0].elapsed_time(ev[1]))
        med = {ck: sorted(v)[len(v) // 2] for ck, v in ms.items()}
        gib = 2.0 ** 30
        print(f"phase 18: checkpointing, TRAIN_STEP2 ({dtype} denoiser, "
              f"{n_layer} layers, B={b}, 1024 tokens): the first step's loss "
              f"and {len(g0)} gradients bitwise equal to the plain step's; "
              f"launches a step K2 {want[False][0]} -> {want[True][0]}, K5 "
              f"{want[False][1]} -> {want[True][1]}, K6 1; step "
              f"{med[False]:.3f} -> {med[True]:.3f} ms "
              f"({100 * (med[True] / med[False] - 1):+.1f} %; medians of "
              f"{2 * REMAT_ROUNDS} each, in turns, CUDA events; ranges "
              f"{min(ms[False]):.3f}-{max(ms[False]):.3f} and "
              f"{min(ms[True]):.3f}-{max(ms[True]):.3f}); the step's own "
              f"peak device memory {own[False] / gib:.3f} -> "
              f"{own[True] / gib:.3f} GiB ({100 * (1 - own[True] / own[False]):.1f}"
              f" % less; peak {peak[False] / gib:.3f} / {peak[True] / gib:.3f}"
              f" GiB with both states resident); {smi}")
        out[dtype] = launched
        del states
        torch.cuda.empty_cache()
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _phase18_ranks(torch, smi: str) -> dict:
    """(b) two ranks on ``cuda:0`` over gloo against one rank on the same
    global batch (``probes/ddp_parity.py``): K6 with its all-reduce at the
    stage-1 step's rows, stage 1 at ``vqvae_ucf.sh``'s widths (B=64, 16
    frames of 64 px; its first step held, the codebook's init and restarts;
    ``ddp_parity``'s docstring says why not the second) and stage 2 at
    ``ddiff_ucf.sh``'s (B=16, 1024 tokens; 2 steps held), 3 more steps
    timed each, and argmax sampling through K3 with the batch split. The
    one-rank run goes twice, and the second against the first, every step,
    is printed as the floor. Returns rank 0's launches by case."""
    import tempfile

    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        HONEST)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.parallel \
        .distributed import run_ranks
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        ddp_parity)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
        stage2_config)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.utils.config import (
        compose)
    cfg1 = compose("train", _job_overrides("vqvae_ucf.sh")
                   + list(HARNESS_BASE))
    cfg2 = compose("train", _job_overrides("ddiff_ucf.sh")
                   + list(HARNESS_BASE))
    g = cfg1["model"]["generator"]
    rows = 64 * int(g["sequence_length"]) * (int(g["resolution"]) // 8) ** 2
    spec = {"device": "cuda", "cases": {
        "codebook_stats": {"n": rows, "k": int(g["n_codes"]),
                           "d": int(g["embedding_dim"])},
        "stage1": {"config": cfg1["model"], "b": 64, "steps": 2,
                   "held": 1, "timed": 3},
        "stage2": {"config": stage2_config(cfg2["model"]), "b": 16,
                   "steps": 2, "timed": 3},
        "sampling": {"config": HONEST, "b": 4, "sampler": "megakernel"},
    }}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rank0 = run_ranks(ddp_parity.run_cases, 2, "cuda", spec, out,
                          backend="gloo", one_device=True)
        wall = time.perf_counter() - t0
        rank1 = torch.load(Path(out) / "rank1.pt", weights_only=False)
    torch.cuda.empty_cache()
    one = ddp_parity.one_rank(spec)
    torch.cuda.empty_cache()
    again = ddp_parity.one_rank(
        {"device": "cuda", "cases": {c: {**spec["cases"][c], "timed": 0}
                                     for c in ("stage1", "stage2")}})
    torch.cuda.empty_cache()
    floor = ddp_parity.compare(again, {c: one[c] for c in again},
                               strict=False, every_step=True)
    print("phase 18: one rank against itself, every step (the floor): "
          + json.dumps(floor))
    report = ddp_parity.compare(rank0, one, strict=False)
    print(f"phase 18: two ranks on cuda:0 over gloo against one rank "
          f"({wall:.1f} s with the processes' start; gloo took the CUDA "
          f"tensors of every collective: all-reduce, all-gather, broadcast, "
          f"barrier): " + json.dumps(report))
    ddp_parity.compare(rank0, one)
    ddp_parity.compare(rank1, rank0)
    for case in ("stage1", "stage2"):
        print(f"phase 18: {case} step at B={spec['cases'][case]['b']} "
              f"(global): one rank {one[case]['step_ms']:.2f} ms, two "
              f"ranks on one card over gloo {rank0[case]['step_ms']:.2f} ms "
              f"(medians of 3; a correctness path, not a speed path: both "
              f"ranks share the card and gloo stages its collectives "
              f"through the host); {smi}")
    print("phase 18: rank 0's launches by case: " + json.dumps(
        {c: r["launches"] for c, r in rank0.items()}))
    k6, k3 = rank0["codebook_stats"]["launches"]["K6"], \
        rank0["sampling"]["launches"]["K3"]
    if not (k6 == 1 and k3 == 100 and rank0["stage1"]["launches"]["K6"] >= 2
            and rank0["stage2"]["launches"]["K5"] > 0):
        raise AssertionError("phase 18: a rank did not launch its kernels")
    return {c: r["launches"] for c, r in rank0.items()}


def _phase18_child(name: str, argv: list[str], env=None) -> str:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=DDP_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    print(f"phase 18: {name}: python {' '.join(argv[:2])} ... (exit "
          f"{proc.returncode}, {time.perf_counter() - t0:.1f} s): "
          f"{lines[-1] if lines else ''}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"phase 18: {name} failed")
    return proc.stderr


def _phase18_children() -> None:
    """(c) one rank over NCCL through ``tasks.train`` under ``torchrun``'s
    variables, and (d) the sweep entry, each as a child process."""
    import os
    import shutil
    base = ROOT / "logs" / "chip_smoke_ddp" / f"{time.time_ns()}"
    s1 = _job_overrides("vqvae_ucf.sh") + list(HARNESS_BASE) + [
        "trainer.max_epochs=1", "datamodule.num_train=128",
        "datamodule.num_val=64", "model.do_evaluation=false"]
    # (c) one rank over NCCL through the real launch path: torchrun's
    # environment, tasks.train joining the group it describes
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    err = _phase18_child("one rank over NCCL", [
        "-m", f"{PKG}.tasks", "train", *s1, "trainer.max_steps=2",
        f"paths.output_dir={base / 'nccl'}"], env)
    if "backend nccl, 1 rank(s)" not in err:
        raise AssertionError("phase 18: tasks.train did not join the NCCL "
                             "group")
    # (d) the sweep entry: a 2-trial grid, one step each
    err = _phase18_child("sweep", [
        "-m", f"{PKG}.sweep", *s1, "trainer.max_steps=1", "seed=0,1",
        f"paths.output_dir={base / 'sweep'}"])
    if "trial 1 ->" not in err or re.search(r"trial \d failed", err):
        raise AssertionError("phase 18: the sweep did not run both trials")
    shutil.rmtree(base, ignore_errors=True)


def _bn_f32_means(self, x, train: bool = False):
    """``models/vqvae.py: BatchNorm.forward`` with the plain f32 means it took
    before data parallelism (``xf.mean``, ``(xf * xf).mean``)."""
    import torch
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import vqvae
    if train:
        dims = tuple(range(x.ndim - 1))
        xf = x.float()
        mean, sq = xf.mean(dim=dims), (xf * xf).mean(dim=dims)
        var = (sq - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            for running, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                running.mul_(vqvae._BN_MOMENTUM).add_(
                    batch, alpha=1.0 - vqvae._BN_MOMENTUM)
    else:
        mean, var = self.running_mean, self.running_var
    scale = self.weight * (var + vqvae._BN_EPS).rsqrt()
    return ((x - mean) * scale + self.bias).to(x.dtype)


def _bn_in_turns(torch, run, rounds: int) -> dict:
    """Medians and ranges of ``run`` (CUDA events) with the f32 means and
    with the port's statistics, in turns: f32, port, port, f32."""
    import statistics

    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import vqvae
    port = vqvae.BatchNorm.forward
    forwards = {"f32": _bn_f32_means, "port": port}
    ms = {"f32": [], "port": []}
    try:
        for kind in forwards:               # a warm-up of each
            vqvae.BatchNorm.forward = forwards[kind]
            run()
        for _ in range(rounds):
            for kind in ("f32", "port", "port", "f32"):
                vqvae.BatchNorm.forward = forwards[kind]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                torch.cuda.synchronize()
                ms[kind].append(start.elapsed_time(end))
    finally:
        vqvae.BatchNorm.forward = port
    med = {k: statistics.median(v) for k, v in ms.items()}
    return {"f32_ms": med["f32"], "port_ms": med["port"],
            "port_over_f32": med["port"] / med["f32"],
            "f32_range": [min(ms["f32"]), max(ms["f32"])],
            "port_range": [min(ms["port"]), max(ms["port"])]}


def _phase18_batchnorm(torch, smi: str) -> dict:
    """(e) BatchNorm's training statistics on the card: split-free sums and
    their cost against the plain f32 means (module docstring)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import vqvae
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage1
    out = {"batchnorm": {}, "steps": {}}
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, shape in BN_SHAPES.items():
        x = (3.0 * torch.randn(shape, device="cuda", generator=g) + 1.0)
        half = shape[0] // 2
        for v in (x, x * x):
            whole = vqvae._split_free_sum(v).float()
            halves = (vqvae._split_free_sum(v[:half])
                      + vqvae._split_free_sum(v[half:])).float()
            plain = v.sum(dim=tuple(range(v.ndim - 1)))
            if not torch.equal(whole, halves):
                raise AssertionError(f"phase 18: BatchNorm sums at {name}: "
                                     f"the two halves' differ from the "
                                     f"batch's")
            rel = float(((whole - plain).abs() / plain.abs()).max())
            if not rel <= 1e-5:
                raise AssertionError(f"phase 18: BatchNorm sums at {name} "
                                     f"{rel:.3g} from the f32 sums")
        bn = vqvae.BatchNorm(shape[-1]).cuda()
        with torch.no_grad():
            bn.weight.fill_(1.0)
            bn.bias.zero_()
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
        xg = x.requires_grad_()

        def fwd_bwd():
            bn(xg, True).square().sum().backward()
        out["batchnorm"][name] = {"shape": list(shape),
                                  **_bn_in_turns(torch, fwd_bwd, BN_ROUNDS)}
    for name in ("TRAIN_STEP1", "TRAIN_STEP128"):
        config = getattr(stage1, name)
        state = stage1.build_stage1(config, "cuda",
                                    torch.Generator().manual_seed(0))
        batch = stage1.synthetic_batch(config, 64)
        gen = torch.Generator(device="cuda").manual_seed(1)
        out["steps"][name] = _bn_in_turns(
            torch, lambda: stage1.train_step(state, batch, gen),
            BN_STEP_ROUNDS)
        del state
        torch.cuda.empty_cache()
    print("phase 18: BatchNorm's statistics: every batch's sums equal its "
          "two halves' added; one BatchNorm forward and backward, and "
          "TRAIN_STEP1 / TRAIN_STEP128 steps (B=64), the port's against the "
          f"plain f32 means, in turns (medians of {4 * BN_ROUNDS // 2} / "
          f"{4 * BN_STEP_ROUNDS // 2}): " + json.dumps(out) + f"; {smi}")
    return out


def phase_ddp(torch, smi: str) -> dict:
    """Phase 18: activation checkpointing, two ranks on one card, one rank
    over NCCL through ``tasks.train``, the sweep entry, and BatchNorm's
    statistics. Returns the launches of (a) and (b)."""
    launches = {"remat": _phase18_remat(torch, smi),
                "ranks": _phase18_ranks(torch, smi)}
    _phase18_children()
    _phase18_batchnorm(torch, smi)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the port's main path on "
                                 "one CUDA card.")
    ap.add_argument("--profile", action="store_true",
                    help="time each training step by kernel")
    ap.add_argument("--parent", metavar="ROOT",
                    help="also time K1, K6, P1, P2 and P3 in turns with the "
                         "checkout at ROOT")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    smi = phase_environment(torch)
    k1 = phase_k1(torch, smi, args.parent)
    k2 = phase_k2(torch, smi)
    launches = phase_slice(torch, smi)
    k5 = phase_k5(torch, smi)
    k6 = phase_k6(torch, smi, args.parent)
    profile = args.profile
    train = phase_train(torch, smi, profile)

    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        HONEST, MSRVTT_GRID, build_models)
    t0 = time.perf_counter()
    honest = build_models(HONEST, "cuda", torch.Generator().manual_seed(0))
    msrvtt = build_models(MSRVTT_GRID, "cuda",
                          torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    print(f"phase 8: built HONEST and MSRVTT_GRID models in "
          f"{time.perf_counter() - t0:.2f} s")
    k3 = phase_k3(torch, smi, honest)
    k4 = phase_k4(torch, smi, msrvtt)
    route = phase_megakernel_route(torch, smi, honest, msrvtt)
    del honest, msrvtt
    torch.cuda.empty_cache()
    p1, probe_children = phase_p1(torch, smi, args.parent)
    p2, p3, probe_chains = phase_chains(torch, smi, args.parent)
    stage1_run = phase_stage1(torch, smi, profile)
    t_phase14 = time.perf_counter()
    phase_samplers(torch)
    phase_bench(torch)
    t_phase15 = time.perf_counter()
    text = phase_text(torch, smi, profile)
    fvd = phase_fvd(torch, smi)
    t_phase17 = time.perf_counter()
    harness = phase_harness(torch, smi)
    t_phase18 = time.perf_counter()
    ddp = phase_ddp(torch, smi)
    t_end = time.perf_counter()
    tpu = "gif_synthesis_with_discrete_diffusion_tpu/"
    serve_model = "serving, model route, B=32, 100 steps"
    serve_mk = "serving, megakernel route, 100 steps"
    training = "TRAIN_STEP2 (bf16 denoiser), B=16, timed steps"
    training_f32 = "TRAIN_STEP2 with an f32 denoiser, B=16, timed steps"
    training1 = "stage-1 training (TRAIN_STEP1, TRAIN_STEP128), B=64, timed"
    training_text = ("TRAIN_STEP2_MSRVTT (text conditioning, 2304 tokens, "
                     "bf16 denoiser), B=16, timed steps")
    serve_text = "text-conditioned sampling, auto route, B=4, 100 steps"
    fvd_path = ("FVD pipeline (honest, B=32), megakernel route, warm-up and "
                "timed pass")
    cache_probe = "build-cache probe, both child processes"
    depth_probe = "depth / packing probe"
    kernels = [
        dict(name="fused_sample_step", route="cuda",
             source=f"{PKG}/csrc/sample_step.cu",
             replaces=tpu + "ops/sampler_kernel.py:33",
             launches=launches["K1"] + probe_children["K1"],
             launches_by_path={serve_model: launches["K1"],
                               cache_probe: probe_children["K1"]}, **k1),
        dict(name="fused_mha_fwd", route="cuda",
             source=f"{PKG}/csrc/fused_mha_fwd.cu",
             replaces=tpu + "ops/attention.py:70",
             launches=launches["K2"] + train["f32"]["K2"],
             launches_by_path={serve_model: launches["K2"],
                               training_f32: train["f32"]["K2"]},
             **k2["float32"]),
        dict(name="fused_mha_fwd_bf16", route="cuda",
             source=f"{PKG}/csrc/fused_mha_fwd.cu",
             replaces=tpu + "ops/attention.py:70",
             launches=train["bf16"]["K2"] + text["K2"],
             launches_by_path={training: train["bf16"]["K2"],
                               training_text: text["K2"]},
             **k2["bfloat16"]),
        dict(name="megakernel_step_packed", route="cuda",
             source=f"{PKG}/csrc/megakernel_step.cu",
             replaces=tpu + "ops/megakernel.py:683",
             launches=route["K3"] + text["K3"] + fvd["K3"],
             launches_by_path={serve_mk + ", B=32, L=1024": route["K3"],
                               serve_text: text["K3"], fvd_path: fvd["K3"]},
             **k3),
        dict(name="megakernel_step_branch", route="cuda",
             source=f"{PKG}/csrc/megakernel_step.cu",
             replaces=tpu + "ops/megakernel.py:298",
             launches=route["K4"],
             launches_by_path={serve_mk + ", B=8, L=2304": route["K4"]},
             **k4),
        dict(name="fused_mha_bwd", route="cuda",
             source=f"{PKG}/csrc/fused_mha_bwd.cu",
             replaces=tpu + "ops/attention.py:114",
             launches=train["f32"]["K5"],
             launches_by_path={training_f32: train["f32"]["K5"]},
             **k5["float32"]),
        dict(name="fused_mha_bwd_bf16", route="cuda",
             source=f"{PKG}/csrc/fused_mha_bwd.cu",
             replaces=tpu + "ops/attention.py:114",
             launches=train["bf16"]["K5"] + text["K5"],
             launches_by_path={training: train["bf16"]["K5"],
                               training_text: text["K5"]},
             **k5["bfloat16"]),
        dict(name="nearest_code_stats", route="cuda",
             source=f"{PKG}/csrc/nearest_code_stats.cu",
             replaces=tpu + "ops/codebook_kernel.py:56",
             launches=(train["bf16"]["K6"] + train["f32"]["K6"]
                       + stage1_run["K6"] + text["K6"]),
             launches_by_path={training: train["bf16"]["K6"],
                               training_f32: train["f32"]["K6"],
                               training1: stage1_run["K6"],
                               training_text: text["K6"]}, **k6),
        dict(name="probe_matmul", route="cuda",
             source=f"{PKG}/csrc/probe_kernels.cu",
             replaces="scripts/compile_cache_probe.py:59",
             launches=probe_children["P1"],
             launches_by_path={cache_probe: probe_children["P1"]}, **p1),
        dict(name="chain_matmul", route="cuda",
             source=f"{PKG}/csrc/probe_kernels.cu",
             replaces="scripts/depth_pack_probe.py:48",
             launches=probe_chains["P2"],
             launches_by_path={depth_probe: probe_chains["P2"]}, **p2),
        dict(name="pair_matmul", route="cuda",
             source=f"{PKG}/csrc/probe_kernels.cu",
             replaces="scripts/depth_pack_probe.py:95",
             launches=probe_chains["P3"],
             launches_by_path={depth_probe: probe_chains["P3"]}, **p3),
    ]
    # phase 17's runs: each kernel's launches by run, where it launched
    harness_paths = {
        "stage1": "harness: tasks.train stage 1 (vqvae_ucf.sh, B=64)",
        "stage2": "harness: tasks.train stage 2 (ddiff_ucf.sh, B=16, f32 "
                  "denoiser)",
        "resume": "harness: tasks.train stage 2 resumed, second epoch",
        "eval": "harness: tasks.evaluate stage 2, test split"}
    by_kernel = {"fused_sample_step": "K1", "fused_mha_fwd": "K2",
                 "fused_mha_bwd": "K5", "nearest_code_stats": "K6",
                 "megakernel_step_packed": "K3",
                 "megakernel_step_branch": "K4"}
    for kernel in kernels:
        kid = by_kernel.get(kernel["name"])
        if kid is None:
            continue
        for run, path in harness_paths.items():
            if harness[run][kid]:
                kernel["launches_by_path"][path] = harness[run][kid]
                kernel["launches"] += harness[run][kid]
    # phase 18's paths: the checkpointed TRAIN_STEP2 steps, and rank 0 of
    # the two ranks on one card
    remat_path = ("phase 18: TRAIN_STEP2 with transformer.checkpoint, B=16, "
                  "{} denoiser")
    rank_paths = {
        "codebook_stats": "phase 18: rank 0 of 2 on cuda:0, K6 on its rows "
                          "of a stage-1 step, then the all-reduce",
        "stage1": "phase 18: rank 0 of 2, stage-1 steps (vqvae_ucf.sh, B=64 "
                  "global)",
        "stage2": "phase 18: rank 0 of 2, stage-2 steps (ddiff_ucf.sh, B=16 "
                  "global)",
        "sampling": "phase 18: rank 0 of 2, argmax sampling through K3 "
                    "(HONEST, B=4 global)"}
    for kernel in kernels:
        name = kernel["name"]
        for dtype, suffix in (("float32", ""), ("bfloat16", "_bf16")):
            for kid, base in (("K2", "fused_mha_fwd"), ("K5", "fused_mha_bwd")):
                if name == base + suffix:
                    n = ddp["remat"][dtype][kid]
                    kernel["launches_by_path"][remat_path.format(dtype)] = n
                    kernel["launches"] += n
        kid = by_kernel.get(name)
        if kid is None or name.endswith("_bf16"):
            continue
        for case, path in rank_paths.items():
            n = ddp["ranks"][case].get(kid, 0)
            if n:
                kernel["launches_by_path"][path] = n
                kernel["launches"] += n
    on_harness = {kid: sum(r[kid] for r in harness.values())
                  for kid in by_kernel.values()}
    if not (on_harness["K2"] and on_harness["K5"] and on_harness["K6"]
            and (on_harness["K3"] or on_harness["K1"])):
        raise AssertionError(f"a kernel of the harness's path was not "
                             f"launched there: {on_harness}")
    for kernel in kernels:
        if kernel["launches"] < 1:
            raise AssertionError(f"{kernel['name']} was not launched on its "
                                 f"path")
    print(f"chip_smoke: wall {t_end - t_start:.1f} s in all; phases 1-13 "
          f"{t_phase14 - t_start:.1f} s, phase 14 (the samplers and the nine "
          f"bench rows) {t_phase15 - t_phase14:.1f} s, phases 15-16 (text "
          f"conditioning, FVD) {t_phase17 - t_phase15:.1f} s, phase 17 (the "
          f"harness) {t_phase18 - t_phase17:.1f} s, phase 18 (checkpointing,"
          f" two ranks, NCCL, the sweep) {t_end - t_phase18:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
