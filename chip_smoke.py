#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

    python3 chip_smoke.py --profile   # and a torch.profiler table of a
                                      # training step of each stage, of
                                      # the text step, and of phase 20's
                                      # sampling and steps
    python3 chip_smoke.py --parent ROOT   # and K1, K6, P1, P2, P3 (and K2,
                                          # K5 at head dim 4) timed in
                                          # turns with the checkout at ROOT

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
     then each of the nine rows of the package's bench entry (sampling
     honest / msrvtt / half, vqvae, train_step, train_step128, train_step2
     honest and msrvtt (text conditioning), fvd_pipeline): the first as a
     child process (``python -m ..._torch.bench``), the rest through the
     same ``main`` in this process, each JSON line parsed and printed;
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
     steps, in turns;
 19. the reference's checkpoints and tensor parallelism: (a) reference-
     named state dicts of the VQ-VAE at ``vqvae_ucf.sh``'s widths, the
     19-layer denoiser, the 400-class I3D, ResNet-50 and the 12 x 512 CLIP
     tower written as the reference's files (Lightning checkpoints whose
     hyper-parameters no loader can import, bare state dicts), read back
     through ``convert/torch_*.py`` bitwise, on the card against the CPU,
     and ``probes/parity_fvd.py`` at its defaults with ``--vqvae --d3pm
     --i3d`` as a child process; K6's two entries for a codebook sharded
     by codes (``nearest_code_dist``, ``code_stats``) against their plain
     versions at the frozen encode's shape (N = 16384, K = 4096 in two
     shards; the nearest over the shards equals the unsharded K6's indices
     exactly, repeated codes across the boundary too), each timed at one
     shard's shape; (b) two ranks on ``cuda:0`` over gloo at
     ``trainer.mesh.model=2`` against one rank (``probes/ddp_parity.py``):
     K6's sharded lookup, a stage-1 step at ``vqvae_ucf.sh``'s widths
     (B=64), ``TRAIN_STEP2`` at ``ddiff_ucf.sh``'s (B=16) with an f32 and a
     bf16 denoiser, argmax sampling through K3 on the gathered weights
     (tokens bitwise), with the step times, the launches of K6's entries
     and the bytes a rank holds;
 20. K2 and K5 at every head width the JAX kernels take (the wg design,
     ``csrc/mha_wg.cuh``: wgmma fed by TMA): (a) d = 12, 16, 32, 64, 128 in
     f32 and bf16 against their plain versions (self-attention at B=64,
     L=1024 in 16 heads, 8 at d = 128; cross-attention over 1 and 77 keys)
     under K2_TOL, K5_TOL and BF16_EXCESS_TOL, then timed there (self,
     one key, 77 keys) with the bound, the exponential floor and
     ``F.scaled_dot_product_attention`` (the ratio to it), and with
     ``--parent`` in turns with the parent's kernels at the same shapes
     (``probes/attention_variants.py: compare_widths``); (b) the
     denoiser at VQ-Diffusion-B's published width (``generate.VQD_B``:
     n_embd 1024 in 16 heads of 64, 387.4 M parameters): its logits at one
     timestep through K2 against the plain attention on the card; ``auto``
     takes the megakernel route there, as JAX's rule does; K3 at that
     sampling shape (B=4 under CFG, 19 layers, bf16 weights) against the
     plain version; then ``sample_videos`` for 4 clips over 100 steps on
     ``sampler="auto"`` (the megakernel route, a K3 a step) and on
     ``sampler="model"`` (38 K2 and 1 K1 a step), in turns, with each
     route's ms a step; (c) one
     ``TRAIN_STEP2_VQD_B`` step (f32, B=4) through K2 / K5 against the plain
     attention, then ``tasks.train`` on ``ddiff_ucf.sh``'s line with the two
     overrides at B=16, 4 steps in bf16 and 2 in f32 (38 K2, 38 K5 and 1 K6
     a step), each with its s a step, peak memory and launches by head
     dim (all at 64); (d) K2 and K5 at d = 4 timed again, in turns with
     ``--parent ROOT`` where given (three rounds); (e) with ``--profile``, (b)'s sampling
     and the training step at B=16 in bf16 and f32 under torch.profiler;
 21. K3 and K4 at every width the JAX megakernel takes (n_embd 24-2048 in
     heads of 1-1024: ``csrc/megakernel_step.cu``, one library per width,
     built in the background from phase 1 on; with bf16 weights phases A
     and B's products on wgmma, the activations in device memory, at
     every width but the serving one, and so with f32 weights above 512;
     each library's nvcc seconds on one line, the widths of
     MK_WGMMA_WIDTHS held to hold wgmma in their SASS, the serving width
     none (with ``--parent``, its SASS the parent's)): (a) against their plain
     versions at ``MK_WIDTHS`` (2 layers, 1 above n_embd 512; general and
     one-token conditions, f32 and bf16 weights, ragged tiles) and where a head's
     keys are streamed (heads of 32 at 2304 tokens, 64 and 128 at 1024,
     1024 at 1024 in tiles of 16) or
     only just staged whole (heads of 16 at 2304), each with the plain
     version's own distances its tolerance is read against; (b) the
     honest configuration (K3, B=32) and the MSRVTT grid (K4, B=8) at
     n_embd 64 in heads of 8, 256 in heads of 16, 512 in heads of 256 and
     VQ-Diffusion-B's 1024 in heads of 64, against the plain
     version at that shape, then timed against it, with the bound and by
     phase (with ``--parent ROOT``, each by phase in turns with ROOT's
     kernels); (c) ``auto`` at n_embd 64 in heads of 8: the small config
     against the CPU's plain run, the honest configuration for 4 clips
     over 100 steps (100 K3 launches); (d) with ``--parent ROOT``, K3 and
     K4 at the serving width in turns with ROOT's kernels and with the
     general code built at that width (``MK_GENERAL=1``, first checked
     against the plain version);
 22. the rest of K1, K2, K5 and K6's domain: (a) K1 at K-1 = 8193-32769
     (rows in shared memory, and at 32768 classes under guidance from
     device memory), K6 at D = 385-1024 and K = 512-16384 through its three
     entries (against the f64 distances, rows decided by ``k6_margin(D)``;
     two shards' nearest equal to the unsharded index), K2 / K5 at head
     dims 144-512 (the stream design) in f32 and bf16, self-attention at
     B=16, L=1024 in 2 heads and cross-attention over 1 and 77 keys,
     against their plain versions; (b) each timed there beside its plain
     version, its bound (the function's work: the scores the stream design
     computes again past d = 256 are not counted; ``stream_products``
     counts them) and the library call (sdpa; for K6 ``torch.cdist`` +
     ``argmin``, two calls), and with ``--parent ROOT`` K2 / K5 there in
     turns with ROOT's kernels; (c) ``WIDE_DOMAIN``:
     ``tasks.train`` for stage 1 at ``vqvae_ucf.sh``'s widths over 16384
     codes of dim 512 and stage 2 over its checkpoint (n_embd 512 in heads
     of 256, bf16, B=16), ``generate`` over stage 2's checkpoint (8 clips,
     100 steps on ``auto``: the model route, exactly 100 K1 launches at
     K-1 = 16384 and 3800 K2 at d = 256; its ms a step and K2's share of
     it from (b)'s times; with ``--profile`` the same call again under
     torch.profiler: the device's busy share of a step and K2's traced
     device time a step), then K3 at the honest width with
     K = 16385 against its plain version and the honest configuration over
     those codes on ``auto`` (exactly 100 K3 launches); (d) with ``--parent
     ROOT``, K1's register design bitwise against ROOT's and K2 / K5 at
     d = 64 in turns (three rounds).
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
K6 and K3 there; phase 20's ``VQD_B`` runs (K1 and K2 sampling, K2, K5
and K6 in both ``tasks.train`` runs, K3 in its megakernel sampling), and
for K2 and K5 the launches of
this process by head dim, as the wrappers counted them
(``launches_by_head_dim``: every phase, the checks included; summed by
the design each head dim takes in ``launches_by_design``: ``tiles`` at 4
and 8, ``wg`` up to 128, ``stream`` above; K5's entries name the
second translation unit of their library, ``units``), and phase 20
(a)'s numbers at
each head dim of the wg design (``by_head_dim``); for K3 and K4
the launches of this process by width (``launches_by_width``), phase 21
(b)'s numbers at each full width (``by_width``) and the route run of (c);
phase 22's ``WIDE_DOMAIN`` runs (K6 in both stages, K2 and K5 in bf16 in
stage 2, K1 and K2 in its sampling, K3 over the large codebook), K1's
launches by K-1 (``launches_by_classes``) and its new shapes' numbers
(``by_classes``), K6's entries' launches by D (``launches_by_dim``) and
its new shapes' numbers (``by_shape``), and phase 22 (b)'s rows in K2 and
K5's ``by_head_dim``;
``launches_by_path`` splits the
count by the run it came from, each run's counts set to 0 just before it
and read just after), and the last line ``{"ok": true, "device": {...}}``.
Any failure raises: there is no CPU run.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
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
    PEAK_BF16, PEAK_BYTES, PEAK_F32, PEAK_TF32, attention_work,
    bound as _bound, card, codebook_work, megakernel_bound as
    _megakernel_bound, megakernel_work as _megakernel_work, sample_step_work)

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
# K3 / K4's precision. Their f32 products take two TF32 products each (the
# activations' hi and lo halves); a kernel that took one (hi only) is the
# control. The max-abs above cannot tell them apart at these sizes (a bf16
# flip of q, k, v or a probability moves single elements more than the lo
# half does: PERF.md), the root mean square of the whole state can: the
# kernels' RMS distance from the plain version must stay under this share
# of the one-TF32 control's in the same case (two products, not one: the
# dropped half is all of the control's error and none of the kernels')
MK_RMS_SHARE = 0.5
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
        import (fused_sample_step, fused_sample_step_reference,
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
    # what the kernel does not take raises, with no copy of the logits (any
    # K-1 is taken: above 8192 phase 22 checks it)
    K = 4097
    rows = schedule_rows(make_schedule(100, K, device="cuda"))
    refused = []
    for name, logits2, k in (
            ("a class axis that is not contiguous",
             torch.zeros((8, K - 1, 64), device="cuda"), K),):
        try:
            fused_sample_step(logits2, torch.zeros((4, 64), dtype=torch.int64,
                                                   device="cuda"), rows[3], 1,
                              guidance=2.0, num_classes=k)
        except ValueError:
            refused.append(name)
    print(f"phase 2: K1 refuses {'; '.join(refused)}")
    if len(refused) != 1:
        raise AssertionError("K1 took a layout it does not hold")

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
    """The least time of an attention call: its products at the tensor
    cores' peak for the operands' type (f32: three TF32 products a product,
    hi hi + hi lo + lo hi, at 495 TFLOP/s, as the kernels compute them and
    as K6 is bounded; bf16: 989 TFLOP/s), its tensors at their element
    size."""
    if str(dtype) == "torch.float32":
        return _bound(nbytes_f32, 0.0, flops_tf32=3.0 * flops)
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
            # bound: QK^T and PV against q, k, v read and o written once;
            # beside it the exponentials, one a (query, key, head)
            nbytes, flops, exps = attention_work(64, 1024, lk, 16, 4)
            bound_ms, bound_by = _attention_bound(dtype, flops, nbytes)
            exp_ms = exps / exp_rate * 1e3
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
            # bound: five products (S, dV, dP, dQ, dK) against q, k, v, o,
            # do read and dq, dk, dv written once; beside it the
            # exponentials, one a (query, key, head) in each of the two
            # kernels
            nbytes, flops, exps = attention_work(16, 1024, lk, 16, 4,
                                                 backward=True)
            bound_ms, bound_by = _attention_bound(dtype, flops, nbytes)
            exp_ms = exps / exp_rate * 1e3
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
    _f11_cost(torch, smi, state, batch, g)
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


@contextlib.contextmanager
def _f11_roundings(torch, model, before: bool):
    """Inside the block, with ``before``, the bf16 denoiser rounds as it did
    before F11's repair: every op's output to bf16 (GELU2 as x *
    sigmoid(1.702 x) on the bf16 tensor, the AdaLN's 1 + scale in bf16,
    every Dense's bias added in bf16, its gradient summed in bf16); else as
    it does now."""
    import torch.nn.functional as F
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
        denoiser, layers)
    saved = []

    def patch(m, name, value):
        saved.append((m, name, m.__dict__.get(name)))
        setattr(m, name, value)

    if before:
        for m in model.modules():
            if isinstance(m, layers.Dense):
                patch(m, "add_bias", lambda y, m=m: y if m.bias is None else
                      y + m.bias.to(m.compute_dtype))
            elif isinstance(m, denoiser.Block):
                patch(m, "act", lambda x: x * torch.sigmoid(1.702 * x))
            elif isinstance(m, denoiser.AdaLayerNorm):
                def forward(x, timestep, m=m):
                    emb = m.linear(F.silu(m.emb(timestep)))[:, None, :]
                    scale, shift = emb.chunk(2, dim=2)
                    return m.norm(x) * (1 + scale) + shift
                patch(m, "forward", forward)
    try:
        yield
    finally:
        for m, name, old in reversed(saved):
            if old is None:
                delattr(m, name)
            else:
                setattr(m, name, old)


def _f11_cost(torch, smi: str, state, batch, g) -> None:
    """What F11's repair costs the host-bound bf16 ``TRAIN_STEP2`` step:
    the device kernels a step launches (torch.profiler over one step) and
    the step's time (host clock ending in ``synchronize()``, 3 steps), the
    denoiser rounding as before the repair and as now, in turns (before,
    now, now, before)."""
    from torch.profiler import ProfilerActivity, profile
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
        train_step)
    model = state.generator.diffusion.transformer
    read = {True: [], False: []}
    for before in (True, False, False, True):
        with _f11_roundings(torch, model, before):
            train_step(state, batch, g)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                train_step(state, batch, g)
                torch.cuda.synchronize()
            kernels = sum(e.count for e in prof.key_averages()
                          if e.device_time_total > 0)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(state, batch, g)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        read[before].append((kernels, min(times)))
    for before, label in ((True, "as before F11's repair"),
                          (False, "now")):
        print(f"phase 7: TRAIN_STEP2 (bfloat16 denoiser) rounding {label}: "
              + "; ".join(f"{k} device operations, {t:.4f} s a step"
                          for k, t in read[before]) + f" ({smi})")


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


def _profile_kernels(torch, phase: str, step, steps: int = 2,
                     cpu: bool = True) -> dict:
    """torch.profiler over ``steps`` calls of ``step``: device time by
    kernel, and the device's busy share of the (profiled) wall time.
    ``cpu=False`` traces the device alone (a long call's host ops would
    cost the trace more than the call). Returns ``wall`` (s),
    ``device_us`` and ``kernels`` ({name: [us, calls]}) over the steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu
                                            else [])
    with profile(activities=activities) as prof:
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
    return dict(wall=wall, device_us=device_us, kernels=kernels)


def _megakernel_case(torch, *, L, spatial, k, n_layer, s_len, B, use_cfg,
                     dtype, seed, t=50, force_general=False,
                     logit_scale=1.0, score_scale=1.0, n_embd=64, n_head=16,
                     mlp=4):
    """A denoiser at ``n_embd`` in ``n_head`` heads (the serving width, 64
    in 16, by default; MLP ``mlp`` n_embd) with every
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
                             n_layer=n_layer, n_embd=n_embd, n_head=n_head,
                             condition_dim=32, diffusion_step=100,
                             mlp_hidden_times=mlp)
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
    args = (packed, tokens,
            mk._adaln_table(packed, torch.tensor(t), 100, n_embd), kc, vc,
            mk.positions(packed, L), row, 11)
    kw = dict(n_layer=n_layer, n_head=n_head, n_embd=n_embd, num_classes=k,
              guidance=2.0 if use_cfg else 1.0, use_cfg=use_cfg,
              s_valid=s_len, cross_as_bias=as_bias)
    return args, kw


def _distance(x, want_x) -> tuple[float, float]:
    """(max-abs, root mean square) of ``x - want_x``, each relative to the
    same statistic of ``want_x``."""
    d = x - want_x
    return ((d.abs().max() / want_x.abs().max()).item(),
            (d.square().mean().sqrt()
             / want_x.square().mean().sqrt()).item())


def _hidden_witness(torch, args, hidden_kw, want_x) -> dict:
    """What the hidden state's tolerances are read against: the plain
    version with its products summed in f64 (how far its own f32 sums move
    it) and with the kernels' arithmetic (split products as the width
    takes them, ``mk.kernel_matmul``; phase S's exponentials and shift:
    what K3 and K4 compute up to the order of their sums), the witnesses;
    and two kernels of lower precision, the
    controls: each product's activations taken as their high TF32 half
    only (one TF32 product where the kernels take two), and rounded to
    bf16. Returns {name: :func:`_distance` from the plain version's state
    ``want_x``}."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)

    def f64_sums(a, w):
        return (a.double() @ w.double()).float()

    def hi_only(a, w):
        return mk.split_tf32(a)[0] @ w.to(torch.float32)

    def bf16_acts(a, w):
        return mk._bf16(a) @ w.to(torch.float32)

    out = {}
    for name, mm, attention in (
            ("f64 sums", f64_sums, mk._attention_reference),
            ("kernel arithmetic",
             mk.kernel_matmul(hidden_kw["n_embd"],
                              hidden_kw["n_embd"] // hidden_kw["n_head"]),
             mk._attention_kernel_arithmetic),
            ("one TF32", hi_only, mk._attention_reference),
            ("bf16", bf16_acts, mk._attention_reference)):
        x = mk._hidden(*args[:6], **hidden_kw, mm=mm,
                       self_attention=attention)
        out[name] = _distance(x, want_x)
        del x
    return out


def _check_megakernel(torch, phase: str, label: str, args, kw,
                      pack_cfg: bool, tol: float = MK_HIDDEN_TOL,
                      witness: bool = False):
    """One argmax step of K3 / K4 against the plain version on the card: the
    final hidden state the kernel leaves in its scratch (within ``tol`` of
    its max-abs), then the tokens (int64, in range, equal wherever the plain
    log-posterior's top-two margin exceeds MK_MARGIN), and one launch
    counted for the kernel asked for. With ``witness``, also the distances
    of the plain version's other forms (:func:`_hidden_witness`), and the
    kernel's RMS distance within MK_RMS_SHARE of the one-TF32 control's.
    Returns (tokens, hidden max-abs error, {name: (max-abs, RMS)} relative
    distances with the kernel's, or None)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)

    tokens = args[1]
    b, L = tokens.shape
    scratch = mk.alloc_scratch(b, 2 if kw["use_cfg"] else 1, L,
                               tokens.device, n_embd=kw["n_embd"],
                               n_head=kw["n_head"])
    before = _megakernel_counts()
    got = mk.megakernel_step(*args, sample=False, pack_cfg=pack_cfg,
                             scratch=scratch, **kw)
    torch.cuda.synchronize()
    counted = tuple(a - b for a, b in zip(_megakernel_counts(), before))
    hidden_kw = {n: v for n, v in kw.items()
                 if n not in ("num_classes", "guidance")}
    want_x = mk.megakernel_hidden_reference(*args[:6], **hidden_kw)
    # the state in the storage layout, whose padding past n_embd every
    # phase must leave exactly zero
    x = scratch["x"]
    if bool(x[..., kw["n_embd"]:].ne(0).any()):
        raise AssertionError(f"{label}: the padding columns past n_embd "
                             f"are not zero")
    err = (x - want_x).abs().max().item()
    scale = want_x.abs().max().item()
    rel = None
    if witness:
        rel = {"kernel": _distance(x, want_x),
               **_hidden_witness(torch, args, hidden_kw, want_x)}
        print(f"{phase}: {label}: (max-abs, RMS) relative: " + "; ".join(
            f"{name} {m:.3e}, {r:.3e}" for name, (m, r) in rel.items())
            + f"; max-abs tol {tol:.3g}, RMS tol {MK_RMS_SHARE} x one "
            f"TF32's")
    del want_x
    want, post = mk.megakernel_step_reference(
        *args, sample=False, return_posterior=True, **kw)
    top2 = post.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > MK_MARGIN
    wrong = int(((got != want) & decided).sum())
    print(f"{phase}: {label}: hidden state max-abs {err:.3e} of {scale:.3e} "
          f"(tol {tol:.3g} relative); {int((~decided).sum())} of "
          f"{got.numel()} positions under the margin {MK_MARGIN}, {wrong} "
          f"real token mismatches, {int((got != want).sum())} in all")
    if counted != (int(pack_cfg), int(not pack_cfg)):
        raise AssertionError(f"{label}: launches counted {counted}")
    if got.dtype != torch.int64 or int(got.min()) < 0 or \
            int(got.max()) >= kw["num_classes"]:
        raise AssertionError(f"{label}: tokens out of range")
    if not err <= tol * scale or wrong:
        raise AssertionError(f"{label} disagrees with its plain version")
    if rel is not None and \
            not rel["kernel"][1] <= MK_RMS_SHARE * rel["one TF32"][1]:
        raise AssertionError(f"{label}: the hidden state's RMS distance "
                             f"{rel['kernel'][1]:.3e} is not within "
                             f"{MK_RMS_SHARE} of one TF32 product's")
    return got, err, rel


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
            scratch = mk.alloc_scratch(3, 2 if pack_cfg else 1, 200, "cuda",
                                       n_embd=64, n_head=16)
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


def _serving_step(torch, models, b, pack_cfg):
    """One sampling step's arguments for K3 / K4 at a serving configuration:
    the models' own weights packed as the megakernel route packs them, a
    label condition, all-MASK tokens, the first reverse step. Returns
    (args, tables, kw, the plain version's kw)."""
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
    return args, tab, kw, ref_kw


def _time_megakernel(torch, phase, smi, label, models, b, pack_cfg,
                     defines=(), iters: int = 10, tol: float | None = None):
    """Plain, kernel, kernel, plain at a serving configuration (``iters``
    launches each): one sampled step from all-MASK tokens with the models'
    own weights and a label condition; with ``tol``, first the same step in
    argmax mode against the plain version (:func:`_check_megakernel`).
    Returns (ms, plain ms, bound ms, bound by, tables, kw)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)

    d3pm = models.generator.diffusion
    L = d3pm.content_seq_len
    args, tab, kw, ref_kw = _serving_step(torch, models, b, pack_cfg)
    if tol is not None:
        _check_megakernel(torch, phase, f"{label} B={b} L={L} "
                          f"{kw['n_layer']} layers K={kw['num_classes']} "
                          f"(the timed step, argmax)", args, ref_kw,
                          kw["pack_cfg"], tol)
        torch.cuda.empty_cache()
    ms, plain_ms = _ab_ms(
        lambda: mk.megakernel_step_reference(*args, **ref_kw),
        lambda: mk.megakernel_step(*args, scratch=tab["scratch"],
                                   defines=defines, **kw), iters)
    n_br = 2 if kw["use_cfg"] else 1
    nbytes, f32, bf16 = _megakernel_work(
        b, n_br, L, kw["n_layer"],
        d3pm.transformer.block0.mlp_fc.out_features,
        kw["num_classes"] - 1, kw["s_valid"], kw["cross_as_bias"],
        n_embd=kw["n_embd"], n_head=kw["n_head"])
    w_bf16 = tab["packed"]["wfc"].dtype == torch.bfloat16
    wname, route = (("bf16", f"3 bf16 products each at {PEAK_BF16 / 1e12} "
                     f"TFLOP/s, the cheaper exact route (2 TF32 at "
                     f"{PEAK_TF32 / 1e12})") if w_bf16 else
                    ("f32", f"3 TF32 products each at {PEAK_TF32 / 1e12} "
                     f"TFLOP/s"))
    bound_ms, bound_by = _megakernel_bound(nbytes, f32, bf16,
                                           weights_bf16=w_bf16)
    cuda_cores_ms = _bound(nbytes, f32, bf16)[0]
    print(f"{phase}: {label} (n_embd {kw['n_embd']} in {kw['n_head']} "
          f"heads, B={b}, L={L}, {kw['n_layer']} layers, K="
          f"{kw['num_classes']}, {wname} weights, sampled) kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"by {bound_by} ({f32 / 1e9:.1f} GFLOP of f32 products as "
          f"{route} + {bf16 / 1e9:.1f} GFLOP of bf16 "
          f"operands at {PEAK_BF16 / 1e12} TFLOP/s; {nbytes / 1e6:.1f} MB): "
          f"{bound_ms / ms:.1%} of it (against the f32 products at "
          f"{PEAK_F32 / 1e12} TFLOP/s, the CUDA cores' rate: "
          f"{cuda_cores_ms:.4f} ms, {cuda_cores_ms / ms:.1%});"
          f" no single library call ({smi})")
    return ms, plain_ms, bound_ms, bound_by, (args, tab, kw)


def _phase_parts(torch, args, tab, kw, warm: int = 3,
                 runs: int = 5) -> dict:
    """Where one step's time goes: the device's ns clock at every grid
    barrier, read by block 0 (``warm`` launches, then the mean of
    ``runs``): {phase: ms}."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)

    n_layer = kw["n_layer"]
    stamps = torch.zeros(mk.stamp_count(n_layer), dtype=torch.int64,
                         device="cuda")
    parts = dict.fromkeys(("A: AdaLN-LN + QKV", "S: self-attention",
                           "B: proj + cross + MLP", "tail"), 0.0)
    names = list(parts)
    for i in range(warm + runs):
        mk.megakernel_step(*args, scratch=tab["scratch"], stamps=stamps,
                           **kw)
        torch.cuda.synchronize()
        if i < warm:
            continue
        d = (stamps[1:] - stamps[:-1]).double().cpu() / 1e6 / runs
        for j in range(3):
            parts[names[j]] += float(d[j:3 * n_layer:3].sum())
        parts["tail"] += float(d[3 * n_layer])
    return parts


def _phase_times(torch, phase, label, args, tab, kw) -> None:
    """Prints :func:`_phase_parts` of one step (3 warm launches, then the
    mean of 5)."""
    parts = _phase_parts(torch, args, tab, kw)
    print(f"{phase}: {label} ms/step by phase (device clock at the grid "
          f"barriers, mean of 5): "
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


def _reference_keyed(kind: str, sd: dict) -> dict:
    """A port state dict under the reference checkpoint's names (what
    ``convert/torch_<kind>.py`` reads back to ``sd``): every layout the
    port keeps is torch's own, so only the names change, and the CLIP
    tower's q / k / v stack into ``in_proj``. ``kind``: vqvae, d3pm (the
    generator's ``diffusion.`` part), i3d, resnet, clip."""
    import torch
    out = {}
    # the reference's residual stack ends in its BatchNorm: the port's
    # bn_out is the stack's entry n_res_layers
    n_res = len({m.group(1) for k in sd
                 for m in [re.match(r"^encoder\.res(\d+)\.", k)] if m})
    for k, v in sd.items():
        if kind == "vqvae":
            if k == "codebook.initialized":
                continue
            k = re.sub(r"^(encoder|decoder)\.bn_out\.",
                       rf"\1.res_stack.{n_res}.", k)
            k = (k.replace("codebook.ema_count", "codebook.N")
                 .replace("codebook.ema_sum", "codebook.z_avg"))
            k = re.sub(r"^(encoder|decoder)\.conv(\d+)\.",
                       r"\1.convs.\2.conv.", k)
            k = re.sub(r"^decoder\.convt(\d+)\.", r"decoder.convts.\1.convt.",
                       k)
            k = re.sub(r"^(encoder\.conv_last|pre_vq_conv|post_vq_conv)\.",
                       r"\1.conv.", k)
            k = re.sub(r"\.res(\d+)\.", r".res_stack.\1.", k)
            for port, ref in (("bn1", "block.0"), ("conv1", "block.2.conv"),
                              ("bn2", "block.3"), ("conv2", "block.5.conv"),
                              ("bn3", "block.6"), ("axial", "block.8")):
                k = re.sub(rf"(res_stack\.\d+)\.{port}\.", rf"\1.{ref}.", k)
            k = re.sub(r"\.w([qkv])\.", r".w_\1s.", k)
        elif kind == "d3pm":
            if not k.startswith("diffusion.") or k.endswith(
                    ("diffusion_acc", "diffusion_keep")):
                continue
            k = (k[len("diffusion."):].replace("lt_history", "Lt_history")
                 .replace("lt_count", "Lt_count")
                 .replace("mlp_fc.", "mlp.0.").replace("mlp_proj.", "mlp.2.")
                 .replace("transformer.ln_out.", "transformer.to_logits.0.")
                 .replace("transformer.to_logits.", "transformer.to_logits.1.")
                 .replace("to_logits.1.0.", "to_logits.0."))
            k = re.sub(r"transformer\.block(\d+)\.", r"transformer.blocks.\1.",
                       k)
        elif kind == "i3d":
            k = re.sub(r"^((?:[^.]+\.)*?[^.]+)\.(weight|bias)$",
                       lambda m: (m.group(0) if m.group(1).endswith(".bn")
                                  else f"{m.group(1)}.conv3d.{m.group(2)}"),
                       k)
        elif kind == "resnet":
            k = re.sub(r"^layer(\d)_(\d+)\.", r"layer\1.\2.", k)
            k = (k.replace("downsample_conv.", "downsample.0.")
                 .replace("downsample_bn.", "downsample.1."))
        elif kind == "clip":
            m = re.match(r"^resblock(\d+)\.attn\.(query|key|value)\.(\w+)$",
                         k)
            if m:
                i, leaf = m.group(1), m.group(3)
                name = f"transformer.resblocks.{i}.attn.in_proj_{leaf}"
                if name not in out:
                    out[name] = torch.cat([
                        sd[f"resblock{i}.attn.{p}.{leaf}"]
                        for p in ("query", "key", "value")])
                continue
            k = re.sub(r"^resblock(\d+)\.", r"transformer.resblocks.\1.", k)
            k = (k.replace("attn.out.", "attn.out_proj.")
                 .replace("mlp_fc.", "mlp.c_fc.")
                 .replace("mlp_proj.", "mlp.c_proj."))
        else:
            raise ValueError(f"unknown kind {kind!r}")
        out[k] = v
    return out


def save_reference_file(path, sd: dict, prefix: str = "",
                        lightning: bool = False) -> None:
    """``sd`` (reference-named tensors) saved as the reference's file: bare,
    as ``i3d_pretrained_400.pt`` or torchvision's weights, or
    (``lightning``) as Lightning saves a checkpoint, under ``state_dict``
    with its module's ``prefix`` beside ``hyper_parameters`` that hold an
    object of a class in a module no loader can import."""
    import types

    import torch
    if not lightning:
        torch.save({prefix + k: v for k, v in sd.items()}, path)
        return
    fake = types.ModuleType("lightning_fixture_hparams")

    class AttributeDict(dict):
        pass
    AttributeDict.__module__ = fake.__name__
    AttributeDict.__qualname__ = "AttributeDict"
    fake.AttributeDict = AttributeDict
    sys.modules[fake.__name__] = fake
    try:
        hp = AttributeDict(lr=1e-4, note="x")
        hp.extra = [AttributeDict(a=1)]
        torch.save({"epoch": 3, "global_step": 7,
                    "pytorch-lightning_version": "1.6.0",
                    "state_dict": {prefix + k: v for k, v in sd.items()},
                    "hyper_parameters": hp}, path)
    finally:
        del sys.modules[fake.__name__]


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
            tokens = _check_megakernel(
                torch, "phase 15", f"K3 text-conditioned step t={T - 1 - i} "
                f"(B={b}, L={L}, 19 layers)", args, kw, pack_cfg)[0]
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


def _bench_row(torch, argv: list[str], child: bool
               ) -> tuple[int, str, str]:
    """One row of the package's bench entry: as ``python -m ..._torch.bench``
    in a child process, or through its ``main`` in this one (a child's
    start, imports and CUDA context cost ~15 s a row on the H100 machine's
    host). (exit code, stdout, stderr)."""
    import io

    from gif_synthesis_with_discrete_diffusion_tpu_torch import bench
    if child:
        proc = subprocess.run([sys.executable, "-m", f"{PKG}.bench", *argv],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=BENCH_ROW_TIMEOUT)
        return proc.returncode, proc.stdout, proc.stderr
    torch.cuda.empty_cache()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(argv)
    torch.cuda.empty_cache()
    return rc, out.getvalue(), err.getvalue()


def phase_bench(torch) -> dict:
    """Each bench row through the package's bench entry, the first in a
    child process and the rest in this one, its one JSON line parsed and
    printed."""
    rows = {}
    for i, (metric, config) in enumerate(BENCH_ROWS):
        t0 = time.perf_counter()
        rc, stdout, stderr = _bench_row(
            torch, ["--metric", metric, "--config", config], child=i == 0)
        lines = stdout.strip().splitlines()
        row = json.loads(lines[-1]) if lines else {}
        print(f"phase 14: bench --metric {metric} --config {config} (exit "
              f"{rc}, {'a child process' if i == 0 else 'in this process'}, "
              f"{time.perf_counter() - t0:.1f} s): " + json.dumps(row))
        if rc != 0 or len(lines) != 1:
            print(stderr[-4000:], file=sys.stderr)
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


# phase 19: the converted weights on the card against the CPU. The
# denoiser's logits pass 19 layers of f32 attention (K2, each within K2_TOL
# of its plain version): held to five times K2's bound, relative to their
# max-abs
DENOISER_TOL = 5 * K2_TOL
PHASE19_TIMEOUT = 600   # the parity_fvd child of phase 19 (a)


def _phase19_converters(torch, smi: str) -> None:
    """(a) [1] at full width: reference-named state dicts of the VQ-VAE at
    ``vqvae_ucf.sh``'s widths, the 19-layer denoiser (``HONEST``'s widths
    on ``parity_fvd``'s default grid), the 400-class I3D, ResNet-50 and the
    12 x 512 CLIP tower, written as the reference's files (Lightning
    checkpoints under their prefixes for the two stages, bare state dicts
    for the others); each read back through its ``_file`` function bitwise
    to the weights it came from, onto the card, its output held against the
    same weights on the CPU; then ``probes/parity_fvd.py`` at its defaults
    with the three files, as a child process."""
    import tempfile

    from gif_synthesis_with_discrete_diffusion_tpu_torch.convert import (
        torch_clip, torch_d3pm, torch_i3d, torch_resnet, torch_vqvae)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        build_models)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        parity_fvd)
    args = parity_fvd.parser().parse_args([])
    models = build_models(parity_fvd._config(args), "cpu",
                          torch.Generator().manual_seed(41))
    models.vqvae.codebook.initialized.fill_(True)
    gen = torch.Generator().manual_seed(42)
    sources = {"vqvae": models.vqvae, "d3pm": models.generator,
               "i3d": _i3d(gen), "resnet": _resnet50(gen),
               "clip": _clip_tower(gen)}
    reads = {
        "vqvae": lambda f: torch_vqvae.convert_vqvae_file(
            f, n_res_layers=args.res_layers),
        "d3pm": torch_d3pm.convert_d3pm_file,
        "i3d": torch_i3d.convert_i3d_file,
        "resnet": torch_resnet.convert_resnet50_file,
        "clip": torch_clip.convert_clip_text_file}
    files = {"vqvae": ("vqvae_ucf.ckpt", "generator.", True),
             "d3pm": ("ddiff_ucf.ckpt", "generator.diffusion_model.", True),
             "i3d": ("i3d_pretrained_400.pt", "", False),
             "resnet": ("resnet50.pth", "", False),
             "clip": ("clip_vit_b32_text.pt", "", False)}
    latent = models.vqvae.latent_shape
    g = torch.Generator().manual_seed(43)
    tokens = torch.randint(0, args.codes, (2, *latent), generator=g)
    runs = {
        "vqvae": (lambda m, dev: m.decode(tokens.to(dev)), VIDEO_TOL),
        "d3pm": (lambda m, dev: m.diffusion.transformer(
            tokens.reshape(2, -1).to(dev),
            torch.zeros((2, 1, args.cond_dim), device=dev),
            torch.tensor([3, 77], device=dev)), DENOISER_TOL),
        "i3d": (lambda m, dev: m(torch.randn(
            (2, 16, 32, 32, 3), generator=torch.Generator().manual_seed(
                44)).to(dev)), FVD_NET_TOL),
        "resnet": (lambda m, dev: m(torch.randn(
            (2, 64, 64, 3), generator=torch.Generator().manual_seed(
                45)).to(dev)), FVD_NET_TOL),
        "clip": (lambda m, dev: m(torch.from_numpy(_text_tokens(2)).long()
                                  .to(dev)), TEXT_TOWER_TOL)}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for kind, module in sources.items():
            name, prefix, lightning = files[kind]
            paths[kind] = str(Path(tmp) / name)
            sd = module.state_dict()
            save_reference_file(paths[kind], _reference_keyed(kind, sd),
                                prefix, lightning)
            t0 = time.perf_counter()
            read = reads[kind](paths[kind])
            read_s = time.perf_counter() - t0
            want = {k: v for k, v in sd.items() if k in read}
            same = (set(read) == set(want) and all(
                torch.equal(read[k], v) for k, v in want.items()))
            if not same or (kind != "d3pm" and set(read) != set(sd)):
                raise AssertionError(f"phase 19: the {kind} file read back "
                                     f"is not the weights written")
            module.load_state_dict(read, strict=kind != "d3pm")
            run, tol = runs[kind]
            module.eval()
            with torch.no_grad():
                cpu = run(module, "cpu").float()
                card = run(module.to("cuda"), "cuda").float().cpu()
            module.to("cpu")
            err = float((card - cpu).abs().max() / cpu.abs().max())
            print(f"phase 19: {kind}: {Path(paths[kind]).name} "
                  f"({Path(paths[kind]).stat().st_size / 1e6:.1f} MB, "
                  f"{len(read)} tensors) read in {read_s:.2f} s, bitwise "
                  f"the weights written; on the card vs the CPU "
                  f"{tuple(card.shape)} within {err:.3e} of its max-abs "
                  f"(tol {tol})")
            if not err <= tol:
                raise AssertionError(f"phase 19: the converted {kind} on the "
                                     f"card disagrees with the CPU")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.probes.parity_fvd",
             "--vqvae", paths["vqvae"], "--d3pm", paths["d3pm"],
             "--i3d", paths["i3d"]], cwd=ROOT, capture_output=True,
            text=True, timeout=PHASE19_TIMEOUT)
        wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError("phase 19: parity_fvd with the three files "
                             "failed")
    out = json.loads(lines[-1])
    print(f"phase 19: parity_fvd at its defaults with --vqvae --d3pm --i3d "
          f"({wall:.1f} s, a child process): {json.dumps(out)} ({smi})")
    if not (out["pretrained_weights"] and math.isfinite(out["fvd"])
            and out["num_clips"] == args.num_clips):
        raise AssertionError("phase 19: parity_fvd did not read the three "
                             "files")


def _k6_entries(torch, smi: str) -> dict:
    """K6's two entries for a codebook sharded by codes against their plain
    versions at the frozen encode's shape (N = 16384 rows, K = 4096 codes in
    two shards of 2048, D = 128): the nearest over the shards equals the
    unsharded K6's indices exactly (also with every code of one shard
    repeated in the other, where the lower copy must win); then each timed
    at one shard's shape against its plain version and a library call.
    Returns the kernels line's numbers of each."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
        import (code_stats, code_stats_range_reference, nearest_code_dist,
                nearest_code_dist_reference, nearest_code_stats)
    n, k, d, shards = 16384, 4096, 128, 2
    per = k // shards
    g = torch.Generator(device="cuda").manual_seed(51)
    x = torch.randn((n, d), generator=g, device="cuda")
    errs = {"dist": 0.0, "stats": 0.0}
    e = torch.randn((k, d), generator=g, device="cuda")
    for label, e in (("random codes", e), ("shard 1 repeating shard 0",
                                           torch.cat([e[:per], e[:per]]))):
        whole = nearest_code_stats(x, e)[0]
        parts = [nearest_code_dist(x, e[r * per:(r + 1) * per].contiguous())
                 for r in range(shards)]
        shard = torch.argmin(torch.stack([p[1] for p in parts]), dim=0)
        idx = torch.stack([p[0] + r * per for r, p in enumerate(parts)]
                          ).gather(0, shard[None])[0]
        wrong = int((idx != whole).sum())
        for r, (li, dist) in enumerate(parts):
            ref_i, ref_d = nearest_code_dist_reference(
                x, e[r * per:(r + 1) * per])
            errs["dist"] = max(errs["dist"], float(
                (dist - ref_d).abs().max() / ref_d.abs().max()))
            ref_full = -2.0 * (x @ e[r * per:(r + 1) * per].t()) + (
                e[r * per:(r + 1) * per] ** 2).sum(-1)[None]
            top2 = (-ref_full).topk(2, dim=1).values
            decided = (top2[:, 0] - top2[:, 1]) > K6_MARGIN
            if int(((li != ref_i) & decided).sum()):
                raise AssertionError("phase 19: nearest_code_dist disagrees "
                                     "with its plain version")
        for r in range(shards):
            got_n, got_s = code_stats(x, idx, r * per, per)
            want_n, want_s = code_stats_range_reference(x, idx, r * per, per)
            torch.testing.assert_close(got_n, want_n, rtol=0, atol=0)
            errs["stats"] = max(errs["stats"], float(
                (got_s - want_s).abs().max()))
            torch.testing.assert_close(got_s, want_s, rtol=K6_TOL,
                                       atol=K6_TOL)
        print(f"phase 19: K6's sharded lookup, N={n} K={k} D={d} in "
              f"{shards} shards ({label}): {wrong} indices differ from the "
              f"unsharded K6's; distances within {errs['dist']:.3e} of the "
              f"plain ones (relative), statistics max-abs "
              f"{errs['stats']:.3e} (rtol = atol = {K6_TOL}), counts exact")
        if wrong:
            raise AssertionError("phase 19: the sharded lookup's indices are "
                                 "not the unsharded K6's")
        if label != "random codes" and int(idx.max()) >= per:
            raise AssertionError("phase 19: a repeated code's upper copy won")
    e = torch.randn((per, d), generator=g, device="cuda")
    ms, plain_ms = _ab_ms(lambda: nearest_code_dist_reference(x, e),
                          lambda: nearest_code_dist(x, e), 10)
    flops = 2.0 * n * per * d
    nbytes = 4.0 * (x.numel() + e.numel()) + 8.0 * n
    bound_ms, bound_by = _bound(nbytes, 0.0, flops_tf32=3.0 * flops)
    dist = {"max_abs_err": errs["dist"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    print(f"phase 19: nearest_code_dist (N={n}, K={per} a shard, D={d}) "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by}; no single library call ({smi})")
    idx = torch.randint(0, k, (n,), generator=g, device="cuda",
                        dtype=torch.int32)
    ms, plain_ms = _ab_ms(
        lambda: code_stats_range_reference(x, idx, 0, per),
        lambda: code_stats(x, idx, 0, per), 10)
    inside = (idx < per)
    rows = int(inside.sum())
    lib_idx = idx.long().clamp(max=per)
    lib = torch.zeros((per + 1, d), device="cuda")
    library_ms = _time_ms(lambda: lib.zero_().index_add_(0, lib_idx, x), 10)
    # the rows of this shard's codes read once, every index read, the
    # counts and sums written; one add an element of those rows
    nbytes = 4.0 * rows * d + 4.0 * n + 4.0 * per * (d + 1)
    bound_ms, bound_by = _bound(nbytes, float(rows * d))
    stats = {"max_abs_err": errs["stats"], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms}
    print(f"phase 19: code_stats (N={n} rows, {rows} of them in the "
          f"shard's {per} codes, D={d}) kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, index_add_ of the sums {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({smi})")
    return {"nearest_code_dist": dist, "code_stats": stats}


def _phase19_ranks(torch, smi: str) -> dict:
    """(b) [16b] on ``cuda:0``: two ranks over gloo at ``model=2`` against
    one rank on the same global batch (``probes/ddp_parity.py``): K6's
    sharded lookup at the frozen encode's shape, a stage-1 step at
    ``vqvae_ucf.sh``'s widths (B=64), ``TRAIN_STEP2`` at ``ddiff_ucf.sh``'s
    (B=16) with an f32 and with a bf16 denoiser, and argmax sampling through
    K3 on the gathered weights (tokens bitwise one rank's). Prints the step
    times, each case's launches of K6's entries and the bytes of parameters
    and Adam state a rank holds. Returns rank 0's launches by case."""
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
    s2 = stage2_config(cfg2["model"])
    s2_bf16 = copy.deepcopy(s2)
    s2_bf16["generator"]["diffusion_model"]["transformer"]["dtype"] = \
        "bfloat16"
    g = cfg1["model"]["generator"]
    spec = {"device": "cuda", "mesh": {"model": 2}, "cases": {
        "codebook_stats": {"n": 16384, "k": int(g["n_codes"]),
                           "d": int(g["embedding_dim"])},
        "stage1": {"config": cfg1["model"], "b": 64, "steps": 1,
                   "timed": 3},
        "stage2": {"config": s2, "b": 16, "steps": 2, "timed": 3},
        "stage2_bf16": {"kind": "stage2", "config": s2_bf16, "b": 16,
                        "steps": 1, "timed": 3},
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
    f32 = [c for c in spec["cases"] if c != "stage2_bf16"]
    report = ddp_parity.compare({c: rank0[c] for c in f32},
                                {c: one[c] for c in f32}, strict=False)
    print(f"phase 19: two ranks on cuda:0 over gloo at model=2 against one "
          f"rank ({wall:.1f} s with the processes' start): "
          + json.dumps(report))
    ddp_parity.compare({c: rank0[c] for c in f32}, {c: one[c] for c in f32})
    ddp_parity.compare({c: rank1[c] for c in f32},
                       {c: rank0[c] for c in f32})
    got, want = rank0["stage2_bf16"]["steps"][0], one["stage2_bf16"][
        "steps"][0]
    largest = max(float(v.abs().max()) for v in want["grads"].values())
    loss_err = abs(got["values"]["total"] / want["values"]["total"] - 1)
    grad_err = max(float((got["grads"][n] - v).abs().max()) / largest
                   for n, v in want["grads"].items())
    print(f"phase 19: TRAIN_STEP2 bf16 denoiser at model=2 against one rank: "
          f"loss within {loss_err:.3e} (relative), gradients within "
          f"{grad_err:.3e} of the largest (tol {BF16_TRAIN_TOL})")
    if not (loss_err <= BF16_TRAIN_TOL and grad_err <= BF16_TRAIN_TOL):
        raise AssertionError("phase 19: the bf16 step at model=2 disagrees "
                             "with one rank")
    for case in ("stage1", "stage2", "stage2_bf16"):
        print(f"phase 19: {case} step at B={spec['cases'][case]['b']}: one "
              f"rank {one[case]['step_ms']:.2f} ms, two ranks at model=2 on "
              f"one card over gloo {rank0[case]['step_ms']:.2f} ms (medians "
              f"of 3, each run in its own processes); parameters, buffers "
              f"and Adam state a rank holds: {rank0[case]['bytes'] / 1e6:.3f}"
              f" MB against {one[case]['bytes'] / 1e6:.3f} MB on one rank "
              f"({smi})")
    launches = {c: r["launches"] for c, r in rank0.items()}
    print("phase 19: rank 0's launches by case: " + json.dumps(launches))
    for case in ("codebook_stats", "stage1", "stage2", "stage2_bf16"):
        r = launches[case]
        if not (r["K6 dist"] >= 1 and r["K6 stats"] >= 1 and r["K6"] == 0):
            raise AssertionError(f"phase 19: {case} did not take K6's "
                                 f"sharded entries: {r}")
    if launches["sampling"]["K3"] != 100:
        raise AssertionError("phase 19: sampling did not run K3")
    return launches


def phase_tp(torch, smi: str) -> dict:
    """Phase 19: the reference's checkpoints ([1]) and tensor parallelism
    over ``trainer.mesh.model`` ([16b]). Returns K6's new entries' numbers
    and rank 0's launches."""
    _phase19_converters(torch, smi)
    entries = _k6_entries(torch, smi)
    return {"entries": entries, "ranks": _phase19_ranks(torch, smi)}


# phase 20: K2 and K5 at every head width the JAX kernels take, and the
# denoiser at VQ-Diffusion-B's published width (generate.VQD_B: n_embd 1024
# in 16 heads of 64) sampled and trained through the port's entries
WIDE_HEAD_DIMS = (12, 16, 32, 64, 128)
WIDE_B, WIDE_L = 64, 1024        # 2B=64 rows of 1024 tokens, as phase 3
WIDE_ITERS = 5
VQD_B_CLIPS = 4
# the training step held against the plain attention: B=4 (the plain
# attention keeps 19 layers' (B, 16, 1024, 1024) f32 probabilities)
VQD_B_CMP_BATCH = 4
VQD_B_STEPS = {"bfloat16": 4, "float32": 2}


def _by_head_dim(counts: dict) -> str:
    """``{(head dim, dtype): launches}`` as text."""
    return ", ".join(f"d={d} {str(t)[6:]} {n}"
                     for (d, t), n in sorted(counts.items(), key=str))


def _head_dim_launches(counts: dict, dtype: str, name: str) -> dict:
    """``{str(head dim): launches}`` of one dtype (``"float32"``,
    ``"bfloat16"``) in a wrapper's ``by_head_dim``; raises where a head dim
    the phases run (4 and 8 in phases 3 and 5, phase 20's) has none."""
    by_d = {d: n for (d, t), n in counts.items() if str(t) == f"torch.{dtype}"}
    missing = {4, 8, *WIDE_HEAD_DIMS} - set(by_d)
    if missing:
        raise AssertionError(f"{name} launched at no head dim "
                             f"{sorted(missing)}")
    return {str(d): by_d[d] for d in sorted(by_d)}


def _design_launches(by_head_dim: dict) -> dict:
    """``{design: launches}`` of a kernel's ``launches_by_head_dim``: the
    design the kernels take each head dim in (``ops/attention.py:
    design``; the launchers dispatch on the head dim alone)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        design)
    out = collections.Counter()
    for d, n in by_head_dim.items():
        out[design(int(d))] += n
    return dict(sorted(out.items()))


@contextlib.contextmanager
def _plain_attention():
    """The denoiser's attention as the plain version (``sdpa_reference``,
    differentiated by autograd) on the same tensors inside the block."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
        denoiser)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        sdpa_reference)
    saved = denoiser.fused_mha
    denoiser.fused_mha = lambda q, k, v, *, n_head: sdpa_reference(
        q, k, v, n_head)
    try:
        yield
    finally:
        denoiser.fused_mha = saved


def _f32_attention_case(torch, B, Lq, Lk, C, H) -> dict:
    """K2 and K5 in f32 at one case against their plain versions: the
    largest errors, whether each lies within K2_TOL / K5_TOL (rtol = atol),
    and whether two backward launches gave the same bits."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        _fwd_kernel, fused_mha, fused_mha_bwd, fused_mha_bwd_reference,
        sdpa_reference)
    g = torch.Generator(device="cuda").manual_seed(Lq + 7 * Lk + C)
    q, k, v, do = (torch.randn((B, n, C), generator=g, device="cuda")
                   for n in (Lq, Lk, Lk, Lq))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    o = fused_mha(qg, kg, vg, n_head=H)
    o.backward(do)
    _, lse, o32 = _fwd_kernel(q, k, v, H, with_lse=True)
    again = fused_mha_bwd(q, k, v, o32, lse, do, n_head=H)
    got = (o.detach(), qg.grad, kg.grad, vg.grad)
    want = (sdpa_reference(q, k, v, H), *fused_mha_bwd_reference(q, k, v,
                                                                 do, H))
    out = {n: (x - w).abs().max().item()
           for n, x, w in zip(("o", "dq", "dk", "dv"), got, want)}
    out["ok"] = all(bool(((x - w).abs() <= t + t * w.abs()).all())
                    for x, w, t in zip(got, want,
                                       (K2_TOL, K5_TOL, K5_TOL, K5_TOL)))
    out["same"] = all(torch.equal(x, y) for x, y in zip(got[1:], again))
    return out


def _phase20_kernels(torch, smi: str, parent: str | None = None) -> dict:
    """(a) K2 and K5 at every listed head width, f32 and bf16, against
    their plain versions (self-attention at B=64, L=1024, 16 heads or 8 at
    d = 128; cross-attention over 1 and 77 keys), then timed there with
    the bound, the exponential floor and the library call; with ``parent``
    (a checkout's root), the same shapes timed in turns with that
    checkout's kernels (``probes/attention_variants.py``:
    compare_widths). Returns the numbers by (d, dtype)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        attention_variants)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        tma_refused)
    rows = _attention_widths(torch, smi, "phase 20", WIDE_HEAD_DIMS, WIDE_B,
                             attention_variants.heads)
    print("phase 20: the wg design's launches that copied by cp.async for a "
          "tensor map cuTensorMapEncodeTiled refused, (launches, last CUresult): "
          + ", ".join(f"{k} {v}" for k, v in tma_refused().items()))
    if parent is None:
        return rows
    res = attention_variants.compare_widths(parent, WIDE_HEAD_DIMS,
                                            log=lambda line: None)
    for d in WIDE_HEAD_DIMS:
        for dtype in ("float32", "bfloat16"):
            for kind in ("K2", "K5"):
                for shape in ("self", "cross", "cross77"):
                    key = f"{d} {kind} {shape} {dtype}"
                    read = {side: [r[key] for r in runs]
                            for side, runs in res["ms"].items()}
                    best = {side: min(v) for side, v in read.items()}
                    rows[(d, dtype)][f"{kind} {shape}"]["parent_ms"] = (
                        best["parent"])
                    print(f"phase 20: {kind} d={d} {dtype} {shape} in turns "
                          f"with {parent}: this checkout "
                          + " ".join(f"{x:.4f}" for x in read["change"])
                          + f" ms, {parent} "
                          + " ".join(f"{x:.4f}" for x in read["parent"])
                          + f" ms; {best['change'] / best['parent']:.3f} of "
                          f"its time ({res['card']})")
    return rows


def _attention_widths(torch, smi: str, phase: str, dims, b: int,
                      heads) -> dict:
    """K2 and K5 at head dims ``dims`` in ``heads(d)`` heads, f32 and bf16,
    against their plain versions (self-attention at B=``b``, L=1024;
    cross-attention over 1 and 77 keys), then timed there with the bound
    (the function's work), the exponential floor and the library call.
    Returns the numbers by (d, dtype)."""
    import torch.nn.functional as F
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        BF16_EXCESS_TOL, _fwd_kernel, design, fused_mha, fused_mha_bwd,
        fused_mha_bwd_reference, kernel_head_dim, sdpa_reference)

    exp_rate = _exp_rate(torch)
    rows = {}
    for d in dims:
        H = heads(d)
        C = H * d
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            worst = 0.0
            for lk in (WIDE_L, 1, 77):
                case = (f"{phase}: d={d} (instantiation "
                        f"{kernel_head_dim(d)}) {name} B={b} "
                        f"Lq={WIDE_L} Lk={lk} H={H}")
                if dtype == torch.float32:
                    r = _f32_attention_case(torch, b, WIDE_L, lk, C, H)
                    print(f"{case}: max-abs o {r['o']:.3e} (tol {K2_TOL} + "
                          f"{K2_TOL} |x|), dq {r['dq']:.3e}, dk {r['dk']:.3e},"
                          f" dv {r['dv']:.3e} (tol {K5_TOL} + {K5_TOL} |x|); "
                          f"two K5 launches bitwise equal: {r['same']}")
                    if not (r["ok"] and r["same"]):
                        raise AssertionError("K2 / K5 f32 disagree with their "
                                             "plain versions")
                    worst = max(worst, *(r[n] for n in ("o", "dq", "dk",
                                                        "dv")))
                    continue
                r = _bf16_attention_case(torch, b, WIDE_L, lk, C, H)
                names = ("o", "dq", "dk", "dv")
                ctl = [r["control"][n] for n in names]
                print(f"{case}: o32 (f32) max-abs {r['o32']:.3e} (tol "
                      f"{K2_TOL} + {K2_TOL} |x|); beyond their rounding "
                      + ", ".join(f"{n} {r[n]:.3e}" for n in names)
                      + " of their magnitude, P and dS rounded to bf16 "
                      + ", ".join(f"{x:.3e}" for x in ctl)
                      + f" (tol {BF16_EXCESS_TOL}); two K5 launches bitwise "
                      f"equal: {r['same']}")
                if not (r["o32_ok"] and r["same"] and all(
                        r[n] <= BF16_EXCESS_TOL for n in names)) or (
                        lk > 1 and not min(ctl) > BF16_EXCESS_TOL):
                    raise AssertionError("K2 / K5 bf16 disagree with their "
                                         "plain versions, or the check "
                                         "cannot tell")
                worst = max(worst, *(r["abs"][n] for n in names))
            torch.cuda.empty_cache()

            # timed at B=64 rows of 1024 queries: self-attention, and
            # cross-attention over one key
            g = torch.Generator(device="cuda").manual_seed(d)
            out = {"max_abs_err": worst}
            for shape, lk in (("self", WIDE_L), ("cross", 1),
                              ("cross77", 77)):
                q, do = (torch.randn((b, WIDE_L, C), generator=g,
                                     device="cuda").to(dtype)
                         for _ in range(2))
                k, v = (torch.randn((b, lk, C), generator=g,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                ms, plain_ms = _ab_ms(lambda: sdpa_reference(q, k, v, H),
                                      lambda: fused_mha(q, k, v, n_head=H),
                                      WIDE_ITERS)
                _, lse, o32 = _fwd_kernel(q, k, v, H, with_lse=True)
                bms, bplain_ms = _ab_ms(
                    lambda: fused_mha_bwd_reference(q, k, v, do, H),
                    lambda: fused_mha_bwd(q, k, v, o32, lse, do, n_head=H),
                    WIDE_ITERS)
                qh, kh, vh = (x.reshape(b, -1, H, d).transpose(1, 2)
                              .contiguous().requires_grad_()
                              for x in (q, k, v))
                doh = do.reshape(b, -1, H, d).transpose(1, 2).contiguous()
                with torch.no_grad():
                    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                        qh, kh, vh), WIDE_ITERS)
                oh = F.scaled_dot_product_attention(qh, kh, vh)
                blib_ms = _time_ms(lambda: torch.autograd.grad(
                    oh, (qh, kh, vh), doh, retain_graph=True), WIDE_ITERS)
                backend = _sdpa_backend(torch, qh.detach(), kh.detach(),
                                        vh.detach())
                del oh
                for kernel, t, p, lib, bwd in (("K2", ms, plain_ms, lib_ms,
                                                False),
                                               ("K5", bms, bplain_ms,
                                                blib_ms, True)):
                    nbytes, flops, exps = attention_work(
                        b, WIDE_L, lk, H, d, backward=bwd)
                    bound_ms, bound_by = _attention_bound(dtype, flops,
                                                          nbytes)
                    exp_ms = exps / exp_rate * 1e3
                    out[f"{kernel} {shape}"] = dict(
                        ms=t, plain_ms=p, library_ms=lib, bound_ms=bound_ms,
                        bound_by=bound_by, share=bound_ms / t,
                        library_ratio=t / lib, exp_floor_ms=exp_ms,
                        design=design(d))
                    print(f"{phase}: {kernel} d={d} {name} {shape} "
                          f"(B={b}, Lq={WIDE_L}, Lk={lk}, H={H}; the "
                          f"{design(d)} design) kernel "
                          f"{t:.4f} ms, plain {p:.4f} ms, sdpa ({backend}) "
                          f"{'autograd backward ' if bwd else ''}{lib:.4f} "
                          f"ms ({t / lib:.3f} of it), bound {bound_ms:.4f} "
                          f"ms by {bound_by} "
                          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB "
                          f"in f32; {bound_ms / t:.3f} of it), exponential "
                          f"floor {exp_ms:.4f} ms ({smi})")
                del q, k, v, do, qh, kh, vh, doh, lse, o32
                torch.cuda.empty_cache()
            rows[(d, name)] = out
    return rows


def _phase20_sampling(torch, smi: str) -> dict:
    """(b) ``VQD_B``: the denoiser's logits at one timestep (B=4 under CFG,
    8 rows) through K2 against the plain attention on the same card
    tensors; ``auto`` takes the megakernel route there (n_embd 1024 lies in
    the whole-step kernels' domain, as in JAX's rule); K3 at that sampling
    shape against the plain version (:func:`_phase20_vqd_b_k3`); then
    ``sample_videos`` for the same 4 clips over 100 steps on
    ``sampler="auto"`` (the megakernel route, a K3 launch a step) and on an
    explicit ``sampler="model"`` (38 K2 and 1 K1 a step), in turns: auto,
    model, model, auto; the launches of each route's first run."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        VQD_B, build_models, sample_videos)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.d3pm import (
        _cfg_batch)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
        discrete_diffusion)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        fused_mha)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import fused_sample_step

    t0 = time.perf_counter()
    models = build_models(VQD_B, "cuda", torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    diff = models.generator.diffusion
    tr = diff.transformer
    n_params = sum(p.numel() for p in tr.parameters())
    cfg = VQD_B["generator"]["diffusion_model"]
    n_layer = cfg["transformer"]["n_layer"]
    steps = cfg["diffusion_step"]
    route = discrete_diffusion.resolve_sampler(
        "auto", diff.lt_history.device, diff.content_seq_len, tr, True)
    print(f"phase 20: VQD_B built in {time.perf_counter() - t0:.2f} s: "
          f"{n_layer} layers, n_embd {cfg['transformer']['n_embd']}, "
          f"{cfg['transformer']['n_head']} heads of "
          f"{cfg['transformer']['n_embd'] // cfg['transformer']['n_head']}, "
          f"{n_params} denoiser parameters, {diff.content_seq_len} tokens "
          f"over {diff.num_classes - 1} codes; route auto -> {route}")
    if route != "megakernel":
        raise AssertionError("auto does not take the megakernel route at "
                             "VQD_B")

    g = torch.Generator().manual_seed(20)
    n_classes = VQD_B["generator"]["textencoder"]["n_classes"]
    batch = {"label": torch.randint(0, n_classes, (VQD_B_CLIPS,),
                                    generator=g)}
    with torch.no_grad():
        cond, cf = models.generator.conditioner_embeddings(batch,
                                                           VQD_B_CLIPS)
        cond2 = _cfg_batch(cond, cf, True)
        tokens = torch.randint(0, diff.num_classes,
                               (VQD_B_CLIPS, diff.content_seq_len),
                               generator=g).cuda()
        x2 = torch.cat([tokens, tokens])
        t2 = torch.full((2 * VQD_B_CLIPS,), steps // 2, device="cuda")
        fused_mha.launches = 0
        got = tr(x2, cond2, t2)
        k2 = fused_mha.launches
        with _plain_attention():
            want = tr(x2, cond2, t2)
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"phase 20: VQD_B logits (B={VQD_B_CLIPS} under CFG, t="
          f"{steps // 2}) through K2 ({k2} launches) against the plain "
          f"attention on the card: max-abs {err:.3e} of their magnitude "
          f"(tol {DENOISER_TOL})")
    if k2 != 2 * n_layer or not err <= DENOISER_TOL:
        raise AssertionError("VQD_B's logits through K2 disagree with the "
                             "plain attention")
    del got, want

    k3_err = _phase20_vqd_b_k3(torch, models)
    batch = {"label": torch.randint(0, n_classes, (VQD_B_CLIPS,),
                                    generator=g)}
    shape = (VQD_B_CLIPS, 16, 64, 64, 3)
    launches, ms = {}, {"megakernel": [], "model": []}
    for sampler in ("auto", "model", "model", "auto"):
        route = "megakernel" if sampler == "auto" else "model"
        fused_sample_step.launches = fused_mha.launches = 0
        _reset_megakernel_counts()
        widths = fused_mha.by_head_dim.copy()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video = sample_videos(models, batch,
                              torch.Generator().manual_seed(202),
                              sampler=sampler)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = {"K1": fused_sample_step.launches,
                  "K2": fused_mha.launches,
                  "K3": _megakernel_counts()[0],
                  "K4": _megakernel_counts()[1]}
        widths = dict(fused_mha.by_head_dim - widths)
        ms[route].append(wall / steps * 1e3)
        print(f"phase 20: VQD_B sample_videos, {VQD_B_CLIPS} clips, {steps} "
              f"steps, sampler {sampler!r} ({route} route): {wall:.3f} s = "
              f"{VQD_B_CLIPS / wall:.3f} clips/s, {wall / steps * 1e3:.2f} "
              f"ms a step (the decode included); launches K1 "
              f"{counts['K1']}, K2 {counts['K2']} (by (head dim, dtype) "
              f"{_by_head_dim(widths)}), K3 {counts['K3']}, K4 "
              f"{counts['K4']}; peak memory {peak:.2f} GiB ({smi})")
        want = ({"K1": 0, "K2": 0, "K3": steps, "K4": 0}
                if route == "megakernel" else
                {"K1": steps, "K2": 2 * n_layer * steps, "K3": 0, "K4": 0})
        if counts != want or (route == "model" and widths != {
                (64, torch.float32): counts["K2"]}):
            raise AssertionError(f"VQD_B sampling on {sampler!r} did not "
                                 f"launch its kernels as expected")
        if tuple(video.shape) != shape or not bool(video.isfinite().all()):
            raise AssertionError(f"video {tuple(video.shape)} is not a "
                                 f"finite {shape}")
        launches.setdefault(route, counts)
        del video
    print(f"phase 20: VQD_B in turns, ms a step (the decode included): "
          + "; ".join(f"{'auto (megakernel)' if k == 'megakernel' else k} "
                      + ", ".join(f"{v:.2f}" for v in vals)
                      for k, vals in ms.items())
          + f"; megakernel / model "
          f"{min(ms['megakernel']) / min(ms['model']):.3f} ({smi})")
    del models
    torch.cuda.empty_cache()
    return {"K1": launches["model"]["K1"], "K2": launches["model"]["K2"],
            "K3": launches["megakernel"]["K3"], "K3 max-abs": k3_err,
            "ms": ms}


def _phase20_vqd_b_k3(torch, models) -> float:
    """K3 at ``VQD_B``'s own sampling step (its models' weights packed as
    the megakernel route packs them, bf16; n_embd 1024 in 16 heads of 64,
    19 layers, 1024 tokens, K = 4097, a label condition, VQD_B_CLIPS rows
    under CFG: fewer packed tiles than blocks, one work item a block)
    against the plain version, its hidden state under mk_hidden_tol and
    MK_RMS_SHARE, before the route is timed. Returns the hidden state's
    max-abs error."""
    args, tab, kw, ref_kw = _serving_step(torch, models, VQD_B_CLIPS, None)
    if not kw["pack_cfg"]:
        raise AssertionError("VQD_B's sampling step does not pack into K3")
    err = _check_megakernel(
        torch, "phase 20", f"K3 n_embd {kw['n_embd']} in {kw['n_head']} "
        f"heads, bf16 weights B={VQD_B_CLIPS} L={args[1].shape[1]} "
        f"K={kw['num_classes']} {kw['n_layer']} layers (VQD_B's own "
        f"sampling step, argmax)", args, ref_kw, True,
        mk_hidden_tol(kw["n_embd"], kw["n_embd"] // kw["n_head"],
                      4 * kw["n_embd"]), witness=True)[1]
    del args, tab
    torch.cuda.empty_cache()
    return err


def _phase20_step_compare(torch, smi: str) -> None:
    """(c) one ``TRAIN_STEP2_VQD_B`` step in f32 (B=4, injected draws)
    through K2 and K5 against the same step with the plain attention on
    the card, from the same weights: the loss relative and every gradient
    against the largest gradient."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage2

    config = copy.deepcopy(stage2.TRAIN_STEP2_VQD_B)
    config["generator"]["diffusion_model"]["transformer"]["dtype"] = "float32"
    state = stage2.build_stage2(config, "cuda",
                                torch.Generator().manual_seed(0))
    b = VQD_B_CMP_BATCH
    batch = stage2.synthetic_batch(config, b,
                                   torch.Generator().manual_seed(1))
    gen = state.generator
    k = gen.diffusion.num_classes
    L = gen.diffusion.content_seq_len
    g = torch.Generator().manual_seed(2)
    draws = dict(t=torch.tensor([3, 40, 71, 99][:b]),
                 pt=torch.full((b,), 0.01),
                 noise=torch.rand((b, k, L), generator=g))
    saved = {n: x.detach().clone() for n, x in gen.state_dict().items()}

    def step():
        with torch.no_grad():
            for n, x in gen.state_dict().items():
                x.copy_(saved[n])
        _reset_counts()
        loss = float(stage2.train_step(state, batch, **draws)["total"])
        grads = {n: p.grad.detach().clone()
                 for n, p in gen.named_parameters() if p.grad is not None}
        return loss, grads, _counts()

    loss, grads, counts = step()
    with _plain_attention():
        loss_p, grads_p, counts_p = step()
    top = max(float(w.abs().max()) for w in grads_p.values())
    lerr = abs(loss - loss_p) / abs(loss_p)
    gerr = max(float((grads[n] - w).abs().max())
               for n, w in grads_p.items()) / top
    print(f"phase 20: a TRAIN_STEP2_VQD_B step (f32, B={b}) through K2 / K5 "
          f"({counts[0]} / {counts[1]} launches) against the plain attention"
          f" on the card ({counts_p[0]} / {counts_p[1]}): loss {loss:.6f} vs "
          f"{loss_p:.6f}, relative {lerr:.3e} (tol {TRAIN_LOSS_RTOL}); "
          f"gradients {gerr:.3e} of the largest (tol {TRAIN_GRAD_TOL})")
    if counts[:2] != (38, 38) or counts_p[:2] != (0, 0) or not (
            lerr <= TRAIN_LOSS_RTOL and gerr <= TRAIN_GRAD_TOL):
        raise AssertionError("the VQD_B step through K2 / K5 disagrees with "
                             "the plain attention")
    del state, grads, grads_p, saved
    torch.cuda.empty_cache()


def _phase20_train(torch, smi: str) -> dict:
    """(c) ``python -m ..._torch.tasks train``'s function on
    ``ddiff_ucf.sh``'s line with the synthetic datamodule, CSV logging and
    ``VQD_B_OVERRIDES``, at B=16, in bf16 and f32 compute, no validation:
    the s a step, the launches a step, the peak memory. Returns the
    launches by dtype."""
    import shutil

    from gif_synthesis_with_discrete_diffusion_tpu_torch import tasks
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        VQD_B_OVERRIDES)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        fused_mha, fused_mha_bwd)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
        Stage2Trainer)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.utils.config import (
        compose)

    out = {}
    for dtype, steps in VQD_B_STEPS.items():
        run_dir = ROOT / "logs" / "chip_smoke_vqd_b" / f"{time.time_ns()}"
        overrides = (_job_overrides("ddiff_ucf.sh") + list(HARNESS_BASE)
                     + list(VQD_B_OVERRIDES) + [
                         f"model.generator.diffusion_model.transformer."
                         f"dtype={dtype}", "model.do_evaluation=false",
                         "trainer.max_epochs=1", f"trainer.max_steps={steps}",
                         "trainer.check_val_every_n_epoch=2",
                         f"datamodule.num_train={16 * steps}",
                         f"paths.output_dir={run_dir}"])
        cfg = compose("train", overrides)
        tr = cfg["model"]["generator"]["diffusion_model"]["transformer"]
        checkpointed = bool(tr.get("checkpoint", False))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_harness_counts()
        widths = [f.by_head_dim.copy() for f in (fused_mha, fused_mha_bwd)]
        probe = _StepProbe(torch, Stage2Trainer)
        t0 = time.perf_counter()
        with probe:
            tasks.train(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = _harness_counts()
        widths = [dict(f.by_head_dim - w)
                  for f, w in zip((fused_mha, fused_mha_bwd), widths)]
        step, span, _, issue = probe.timing(2)
        per = {kid: counts[kid] / steps for kid in ("K2", "K5", "K6")}
        print(f"phase 20: tasks.train, ddiff_ucf.sh + VQD_B (n_embd "
              f"{tr['n_embd']}, {tr['n_head']} heads, {tr['n_layer']} "
              f"layers), {dtype} denoiser, B={cfg['batch_size']}, {steps} "
              f"steps, transformer.checkpoint {checkpointed}: wall "
              f"{wall:.2f} s; steps 2-{steps} {step:.4f} s a step in the "
              f"loop, {span:.4f} s inside each step (CUDA events), "
              f"{issue:.4f} s to issue one (host clock); launches a step K2 "
              f"{per['K2']:.0f}, K5 {per['K5']:.0f}, K6 {per['K6']:.0f}; "
              f"K2 / K5 by (head dim, dtype) {_by_head_dim(widths[0])} / "
              f"{_by_head_dim(widths[1])}; peak memory {peak:.2f} GiB "
              f"({smi})")
        at_64 = {(64, getattr(torch, dtype)): counts["K5"]}
        if (probe.trainer.global_step != steps
                or counts["K5"] != steps * 2 * tr["n_layer"]
                or counts["K2"] != counts["K5"] or counts["K6"] != steps
                or widths != [at_64, at_64]):
            raise AssertionError(f"the VQD_B training run did not launch its "
                                 f"kernels as expected: {counts}")
        out[dtype] = counts
        del probe
        shutil.rmtree(run_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def _phase20_profile(torch, smi: str) -> None:
    """(e) with ``--profile``: torch.profiler over (b)'s sampling (one
    ``sample_videos`` call, 4 clips, 100 steps, f32 denoiser, the route
    ``auto`` takes) and over two ``TRAIN_STEP2_VQD_B`` steps at B=16 in
    bf16 and in f32 (after three steps, one untimed, timed on the host
    clock): device time by kernel, and the device's busy share of the
    profiled wall time."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        VQD_B, build_models, sample_videos)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
        TRAIN_STEP2_VQD_B)

    models = build_models(VQD_B, "cuda", torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(21)
    n_classes = VQD_B["generator"]["textencoder"]["n_classes"]
    batch = {"label": torch.randint(0, n_classes, (VQD_B_CLIPS,),
                                    generator=g)}
    _profile_kernels(torch, "phase 20 profile, VQD_B sample_videos (4 "
                     "clips, 100 steps: a 'step' below is the call)",
                     lambda: sample_videos(models, batch, g, sampler="auto"),
                     steps=1)
    del models
    torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        config = copy.deepcopy(TRAIN_STEP2_VQD_B)
        config["generator"]["diffusion_model"]["transformer"]["dtype"] = dtype
        state, batch, g, _ = _timed_train2(torch, smi, config, 16, 3, 1,
                                           "phase 20", "TRAIN_STEP2_VQD_B")
        _profile_step(torch, state, batch, g,
                      phase=f"phase 20 profile, TRAIN_STEP2_VQD_B {dtype}")
        del state, batch
        torch.cuda.empty_cache()


def _phase20_old_widths(torch, smi: str, parent: str | None) -> None:
    """(d) K2 and K5 at d = 4 (the main path's shapes of phases 3 and 5),
    f32, in turns with ``--parent ROOT`` where given
    (``probes/attention_variants.py``: compare)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        attention_variants)
    if parent is None:
        from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
            attention)
        ms = attention_variants.time_build(attention, (torch.float32,
                                                       torch.bfloat16))
        print("phase 20: d = 4, this checkout: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()) + f" ({smi})")
        return
    res = attention_variants.compare(parent, rounds=3, log=lambda line: None)
    for side, runs in res["ms"].items():
        print(f"phase 20: d = 4 in turns, {side}: " + "; ".join(
            ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) for ms in runs)
            + f" ms ({res['card']})")


def phase_widths(torch, smi: str, parent: str | None = None,
                 profile: bool = False) -> dict:
    """Phase 20: (a) the kernels at every head width, (b) VQD_B sampled,
    (c) VQD_B trained, (d) the old widths' times, (e) with ``profile`` (b)
    and (c) by kernel."""
    t0 = time.perf_counter()
    kernels = _phase20_kernels(torch, smi, parent)
    t1 = time.perf_counter()
    sampling = _phase20_sampling(torch, smi)
    t2 = time.perf_counter()
    _phase20_step_compare(torch, smi)
    train = _phase20_train(torch, smi)
    t3 = time.perf_counter()
    _phase20_old_widths(torch, smi, parent)
    t4 = time.perf_counter()
    if profile:
        _phase20_profile(torch, smi)
    print(f"phase 20: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{t3 - t2:.1f} s, (d) {t4 - t3:.1f} s, (e) "
          f"{time.perf_counter() - t4:.1f} s")
    return {"kernels": kernels, "sampling": sampling, "train": train}


# phase 21: K3 and K4 at every width the JAX megakernel takes (the CUDA
# kernels take every n_embd up to 2048 in any heads that divide it, one
# library per (n_embd, head dim); with bf16 weights a tile's activations
# live in device memory at every width but the serving one, with f32
# weights above 512): the widths of the CPU tests (head dims 4, 16, 32, 64,
# 128; n_embd 24, 48, 80 and 100 in heads of 3, 12, 5 and 25, heads of 144,
# 256 and 512), the full-width configurations (heads of 8 and of 16), n_embd
# 96 (a half-padded last chunk of 64 columns; heads of 12 and of 24: a
# 16-deep and an 8-deep QK^T step, an odd count of 8-dim PV tiles), the top
# of the first domain, and above it: n_embd 520 (a last chunk of 8
# columns), 640 in heads of 128, 768 in heads of 256, 1000 in heads of 125
# (no multiple of 64 or 8), VQ-Diffusion-B's 1024 in heads of 64, 1536 in
# heads of 128 and the top, 2048, in heads of 1024 (keys streamed 16 at a
# time)
MK_WIDTHS = ((32, 8), (64, 4), (64, 2), (128, 2), (128, 1), (64, 8), (96, 8),
             (96, 4), (256, 16), (512, 8), (24, 8), (48, 4), (80, 16),
             (100, 4), (144, 1), (512, 2), (512, 1), (520, 4), (640, 5),
             (768, 3), (1000, 8), (1024, 16), (1536, 12), (2048, 2))
# the honest configuration and the MSRVTT grid at these widths, timed
MK_FULL_WIDTHS = ((64, 8), (256, 16), (512, 2), (1024, 16))
MK_WIDTH_ITERS = 3
# the serving widths' runs of phase 21 (c): clips and steps of the honest
# configuration at n_embd 64 in heads of 8 on the route auto takes
MK_ROUTE_CLIPS = 4


def mk_hidden_tol(n_embd: int, head_dim: int, hidden: int) -> float:
    """K3 / K4's hidden-state tolerance at a width. MK_HIDDEN_TOL holds at
    n_embd 64 in heads of 4 with an MLP of 256: sums of 64 terms in the
    products, 4 in the scores, 256 in the MLP's projection. The error is
    that of values that land on the other side of a bf16 rounding boundary
    (q, k, v, the probabilities) where the f32 sums before them differ, by
    their order or by the kernels' TF32 split and exponentials: in a sum of
    n such rounded terms the flips number n times their chance, and that
    chance grows as sqrt(n) (a sum's f32 error against the bf16 spacing);
    flips of one sign move the sum by n sqrt(n) bf16 steps of a term, n
    times the share they move it at n = 1 against the sum's sqrt(n) scale.
    So the tolerance scales with the longest of the three lengths against
    256 (never below MK_HIDDEN_TOL). It bounds the flips, not the
    precision: the one-TF32 control reads under it at every width, so
    precision is held by the RMS check (MK_RMS_SHARE; readings of both at
    every width in PERF.md)."""
    return MK_HIDDEN_TOL * max(1.0, max(n_embd, head_dim, hidden) / 256)


# the serving width built from the code of every other width (phase 21 (d),
# with --parent: checked, then timed beside the serving width's own code)
GENERAL_SERVING = "the general code at 64x16"
MK_GENERAL = ("MK_GENERAL=1",)


def _tile_padding(n_embd: int, hidden: int) -> float:
    """The share of a layer's f32 multiply-adds (QKV, proj, the general
    cross-attention's query and proj, the MLP) that the kernels' 64 x 64
    tiles spend on padding: n_embd and the MLP width rounded up to 64."""
    def macs(c, h):
        return 6 * c * c + 2 * c * h
    cp, hp = -(-n_embd // 64) * 64, -(-hidden // 64) * 64
    return 1 - macs(n_embd, hidden) / macs(cp, hp)


# nvcc runs building phase 21's libraries at once: the H100 machine's host
# has 8 cores, and seventeen builds at once slowed phases 1-14's host work
# there (the bench rows' child processes among it) by ~100 s
MK_BUILD_WORKERS = 4
# the niceness of the background builds' nvcc: the phases before 21 (host
# work, the plain versions' CPU threads) come first on the 8 cores
MK_BUILD_NICE = 10


def _nice_thread() -> None:
    """This pool thread, and the nvcc it starts, at MK_BUILD_NICE (on Linux
    a thread's own nice value; the main thread keeps its own)."""
    import os
    os.nice(MK_BUILD_NICE)


def start_width_builds(general: bool = False) -> dict:
    """Phase 21's libraries, one a width of MK_WIDTHS (and with ``general``
    the serving width built from the general code), one nvcc each,
    MK_BUILD_WORKERS at a time (each at MK_BUILD_NICE), the widest first,
    in the background, so that they build while the earlier phases run:
    {(n_embd, n_head) or GENERAL_SERVING: future}."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)
    pool = ThreadPoolExecutor(MK_BUILD_WORKERS, initializer=_nice_thread)
    futures = {w: pool.submit(mk._library, (), (w[0], w[0] // w[1]))
               for w in sorted(MK_WIDTHS, key=lambda w: -w[0])}
    futures = {w: futures[w] for w in MK_WIDTHS}
    if general:
        futures[GENERAL_SERVING] = pool.submit(mk._library, MK_GENERAL,
                                               (64, 4))
    pool.shutdown(wait=False)
    return futures


@contextlib.contextmanager
def _megakernel_library(lib):
    """Every launch of ``megakernel_step`` goes to ``lib`` (the C interface
    is the same at every width, and in a parent's)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)
    own = mk._library
    mk._library = lambda defines=(), widths=(64, 4): lib
    try:
        yield
    finally:
        mk._library = own


def _phase21_builds(futures: dict, parent_builds=None) -> dict:
    """Waits for the width libraries; prints each one's nvcc seconds, its
    registers and spills, the query scale it multiplies by, and whether a
    head's keys are staged whole at 1024 and 2304 tokens; then the nvcc
    seconds of every width on one line. Fails if a width of MK_WGMMA_WIDTHS
    has no ``HGMMA`` in its SASS, or the serving width any; with
    ``parent_builds`` (:func:`start_parent_build`), if the serving width's
    SASS differs from the parent's but for the anonymous namespace's hash.
    Returns {"CxH": nvcc seconds}."""
    import numpy as np
    t0 = time.perf_counter()
    nvcc = {}
    for key, fut in futures.items():
        lib = fut.result()
        n_embd, d = lib.megakernel_width(0), lib.megakernel_width(1)
        label = (key if key == GENERAL_SERVING else
                 f"n_embd {n_embd} in {key[1]} heads of {d}")
        scale = lib.megakernel_qscale()
        want = float(np.float32(1.0 / math.sqrt(d)))
        whole = {L: bool(lib.megakernel_keys_whole(L)) for L in (1024, 2304)}
        print(f"phase 21: {label}: nvcc {lib.build_seconds:.2f} s; "
              + "; ".join(_ptxas_by_kernel(lib.build_log))
              + f"; q scale {scale!r} (fl32(1/sqrt({d})) {want!r}); keys "
              + ", ".join(f"{'whole' if w else 'streamed'} at L={L}"
                          for L, w in whole.items())
              + f"; {lib.megakernel_grid_blocks(1)} blocks (K3)")
        if scale != want:
            raise AssertionError(f"the kernels at head dim {d} scale the "
                                 f"queries by {scale!r}, not {want!r}")
        if key != GENERAL_SERVING:
            nvcc[f"{key[0]}x{key[1]}"] = round(lib.build_seconds, 2)
        if key in MK_WGMMA_WIDTHS:
            counts = _sass_counts(lib._name, ("HGMMA", "HMMA"))
            print(f"phase 21: {label}: the library's SASS holds "
                  + ", ".join(f"{n} {op}" for op, n in counts.items())
                  + " instructions (the products of phases A and B on wgmma "
                  "with bf16 weights, mma.sync with f32 weights, phase S and "
                  "the tail)")
            if not counts["HGMMA"]:
                raise AssertionError(f"{label}: no wgmma in the library")
    print(f"phase 21: waited {time.perf_counter() - t0:.2f} s for the width "
          f"libraries (built in the background since phase 1)")
    print(f"phase 21: nvcc seconds by width (n_embd x heads, built "
          f"{MK_BUILD_WORKERS} at a time at nice {MK_BUILD_NICE}): "
          + json.dumps(nvcc))
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)
    serving = mk._library()
    counts = _sass_counts(serving._name, ("HGMMA", "HMMA"))
    print(f"phase 21: the serving width (n_embd 64 in heads of 4): its SASS "
          f"holds " + ", ".join(f"{n} {op}" for op, n in counts.items())
          + " instructions (its own code: mma.sync only)")
    if counts["HGMMA"]:
        raise AssertionError("wgmma in the serving width's library")
    if parent_builds is not None:
        lines = [_sass_lines(lib._name) for lib in (
            parent_builds[64, 4].result(), serving)]
        differ = [(x, y) for x, y in zip(*lines)
                  if x != y and not ("_GLOBAL__N__" in x
                                     and "_GLOBAL__N__" in y)]
        print(f"phase 21: the serving width's SASS against the parent's: "
              f"{len(lines[0])} / {len(lines[1])} lines, {len(differ)} "
              f"differ other than by the anonymous namespace's hash"
              + (f": {differ[:4]}" if differ else ""))
        if differ or len(lines[0]) != len(lines[1]):
            raise AssertionError("the serving width's SASS differs from the "
                                 "parent's")
    return nvcc


def _sass_lines(lib_path: str) -> list[str]:
    """``cuobjdump -sass`` of a library, line by line."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        cuda_build)
    find_nvcc = cuda_build.find_nvcc
    return subprocess.run(
        [str(Path(find_nvcc()).parent / "cuobjdump"), "-sass", lib_path],
        capture_output=True, text=True, check=True,
        timeout=300).stdout.splitlines()


def _sass_counts(lib_path: str, ops: tuple[str, ...]) -> dict:
    """The lines of ``cuobjdump -sass`` of a library that issue each of
    ``ops`` (an opcode, its suffixes aside)."""
    sass = "\n".join(_sass_lines(lib_path))
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}


def _mk_width_cases(torch) -> tuple:
    """Phase 21 (a)'s cases at every width: (label, pack_cfg, case)."""
    bf16, f32 = torch.bfloat16, torch.float32
    return (
        ("K3 bf16 weights B=2 L=96 K=200 2 layers S=3 (general cross)", True,
         dict(L=96, spatial=(12, 8), k=200, n_layer=2, s_len=3, B=2,
              use_cfg=True, dtype=bf16)),
        ("K3 f32 weights B=2 L=64 K=17 2 layers S=1", True,
         dict(L=64, spatial=(8, 8), k=17, n_layer=2, s_len=1, B=2,
              use_cfg=True, dtype=f32)),
        ("K4 guidance 1 B=2 L=96 K=200 2 layers S=3 (general cross)", False,
         dict(L=96, spatial=(12, 8), k=200, n_layer=2, s_len=3, B=2,
              use_cfg=False, dtype=bf16)),
        ("K4 CFG B=3 L=200 K=17 2 layers S=1 (ragged tiles)", False,
         dict(L=200, spatial=(20, 10), k=17, n_layer=2, s_len=1, B=3,
              use_cfg=True, dtype=bf16)))


def _phase21_kernels(torch, smi: str) -> tuple[float, dict]:
    """(a) K3 and K4 against the plain version at every width of MK_WIDTHS
    at small depth, and where a head's keys cannot be staged whole (4 d L
    bytes over a block's 227 KB: head dim 32 at 2304 tokens, 64 and 128 at
    1024, 1024 at 1024 in tiles of 16 keys) or only just can (heads of 16
    at 2304 tokens); each case with the
    plain version's own distances (:func:`_hidden_witness`). Returns the
    worst hidden-state max-abs error and, by width, the largest relative
    distance of the kernel and of the witness and the smallest of each
    control."""
    bf16 = torch.bfloat16
    long_grid = {
        (64, 2): ("K4 CFG B=1 L=2304 K=17 2 layers S=1 (keys streamed)",
                  False, dict(L=2304, spatial=(48, 48), k=17, n_layer=2,
                              s_len=1, B=1, use_cfg=True, dtype=bf16)),
        (128, 2): ("K3 B=1 L=1024 K=17 2 layers S=3 (keys streamed)", True,
                   dict(L=1024, spatial=(32, 32), k=17, n_layer=2, s_len=3,
                        B=1, use_cfg=True, dtype=bf16)),
        (128, 1): ("K3 B=1 L=1024 K=17 2 layers S=1 (keys streamed)", True,
                   dict(L=1024, spatial=(32, 32), k=17, n_layer=2, s_len=1,
                        B=1, use_cfg=True, dtype=bf16)),
        (256, 16): ("K4 CFG B=1 L=2304 K=17 2 layers S=1 (keys whole, 221 "
                    "KB)", False, dict(L=2304, spatial=(48, 48), k=17,
                                       n_layer=2, s_len=1, B=1, use_cfg=True,
                                       dtype=bf16)),
        (512, 2): ("K3 B=1 L=1024 K=17 2 layers S=3 (keys streamed, two "
                   "output chunks)", True,
                   dict(L=1024, spatial=(32, 32), k=17, n_layer=2, s_len=3,
                        B=1, use_cfg=True, dtype=bf16)),
        (512, 1): ("K4 CFG B=1 L=2304 K=17 2 layers S=1 (keys streamed in "
                   "tiles of 32, four output chunks)", False,
                   dict(L=2304, spatial=(48, 48), k=17, n_layer=2, s_len=1,
                        B=1, use_cfg=True, dtype=bf16)),
        (2048, 2): ("K3 B=1 L=1024 K=17 2 layers S=3 (keys streamed in "
                    "tiles of 16, eight output chunks)", True,
                    dict(L=1024, spatial=(32, 32), k=17, n_layer=2, s_len=3,
                         B=1, use_cfg=True, dtype=bf16))}
    # an MLP width of 16 mod 32 (3 x 80 = 240), and one that is no multiple
    # of 8 beside an n_embd that is none (3 x 100 = 300: 304 and 104 wide
    # in the tables)
    mlp_case = {(80, 16): ("K3 MLP 240 B=2 L=96 K=200 2 layers S=3 (general "
                           "cross)", True,
                           dict(L=96, spatial=(12, 8), k=200, n_layer=2,
                                s_len=3, B=2, use_cfg=True, dtype=bf16,
                                mlp=3)),
                (100, 4): ("K3 MLP 300 B=2 L=96 K=200 2 layers S=3 (general "
                           "cross; n_embd and MLP padded)", True,
                           dict(L=96, spatial=(12, 8), k=200, n_layer=2,
                                s_len=3, B=2, use_cfg=True, dtype=bf16,
                                mlp=3))}
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)
    worst, readings = 0.0, {}
    for n_embd, n_head in MK_WIDTHS:
        d = n_embd // n_head
        ps = mk.phase_s_products(d)
        print(f"phase 21: n_embd {n_embd} in heads of {d}: phase S runs "
              f"{ps['kernel']} FLOP a (query, key, head) where the function "
              f"needs {ps['function']} ({ps['chunks']} output chunks): "
              f"{ps['recompute']:.3f} of them recompute scores for the "
              f"chunks after the first, {ps['padding']:.3f} of the head's "
              f"dims are padding; the f32 products' 64 x 64 tiles hold "
              f"{_tile_padding(n_embd, 4 * n_embd):.3f} padding")
        cases = list(_mk_width_cases(torch))
        if n_embd > 512:   # one layer there: the run's 1200 s
            cases = [(label.replace("2 layers", "1 layer"), pack,
                      dict(case, n_layer=1)) for label, pack, case in cases]
        for extra in (long_grid, mlp_case):
            if (n_embd, n_head) in extra:
                cases.append(extra[n_embd, n_head])
        rels = []
        for label, pack_cfg, case in cases:
            tol = mk_hidden_tol(n_embd, d, case.get("mlp", 4) * n_embd)
            args, kw = _megakernel_case(torch, **case, seed=n_embd + d,
                                        n_embd=n_embd, n_head=n_head)
            _, err, rel = _check_megakernel(
                torch, "phase 21", f"n_embd {n_embd} in {n_head} heads of "
                f"{d}: {label}", args, kw, pack_cfg, tol, witness=True)
            worst = max(worst, err)
            rels.append(rel)
            del args
            torch.cuda.empty_cache()
        row = {"max-abs tol": mk_hidden_tol(n_embd, d, 4 * n_embd),
               **{f"{name} max-abs": max(r[name][0] for r in rels)
                  for name in ("kernel", "f64 sums", "kernel arithmetic")},
               **{f"{name} RMS": max(r[name][1] for r in rels)
                  for name in ("kernel", "f64 sums", "kernel arithmetic")},
               **{f"{name} {stat}": min(r[name][i] for r in rels)
                  for name in ("one TF32", "bf16")
                  for i, stat in enumerate(("max-abs", "RMS"))},
               "RMS share": max(r["kernel"][1] / r["one TF32"][1]
                                for r in rels)}
        readings[f"{n_embd}x{n_head}"] = row
        print(f"phase 21: n_embd {n_embd} in heads of {d} over {len(rels)} "
              f"cases, relative (largest of the kernel and the witnesses, "
              f"smallest of the controls): " + "; ".join(
                  f"{name} {v:.3e}" for name, v in row.items()))
    return worst, readings


# the whole-step kernels' designs by width (the kernels line names them)
MK_DESIGNS = {
    "n_embd 64 in heads of 4": "the serving width's own units (MK_SERVING): "
                               "mma.sync, f32 activations as TF32 hi + lo",
    "n_embd 1-64 (but 64 in heads of 4), bf16 weights":
        "activations as three bf16 planes, a tile's in shared memory, the "
        "MLP's hidden units in a per-block slab; phases A and B's products "
        "on wgmma.mma_async (m64n64k16, two warpgroups, 128 columns a pass: "
        "two blocks an SM), the weights (and the hidden units) by TMA "
        "through a 2-stage mbarrier ring, a product's weights copied while "
        "its activations are written; phase S and the tail's logits on "
        "mma.sync",
    "n_embd 65-2048, bf16 weights":
        "activations in per-block slabs as three bf16 planes, phases A and "
        "B's products on wgmma.mma_async m64n128k16, 256 columns a pass, "
        "operands by TMA through a 4-stage ring (one block an SM)",
    "n_embd up to 512, f32 weights": "the general code: the tile's "
                                     "activations in shared memory, "
                                     "mma.sync, TF32 hi + lo",
    "n_embd 513-2048, f32 weights": "activations in per-block f32 slabs, "
                                    "64-column chunks staged by cp.async, "
                                    "mma.sync, TF32 hi + lo"}
# the widths whose libraries must hold wgmma (phase 21 fails otherwise)
MK_WGMMA_WIDTHS = ((64, 8), (256, 16), (512, 2), (1024, 16))
# the widths whose K3 / K4 phase 21 (b) times by phase in turns with a
# parent checkout's (--parent): VQ-Diffusion-B's, WIDE_DOMAIN's and the
# full-width configurations at 256 and 64
MK_PARENT_WIDTHS = ((1024, 16), (512, 2), (256, 16), (64, 8))


def _wide_parent_turns(torch, phase, smi, label, parent_lib,
                       step) -> dict:
    """K3 or K4 at one configuration in turns with a parent's library (its
    megakernel_step.cu built at the same width, launched through this
    wrapper: the C interface is the same): parent, change, change, parent,
    each one warm launch and the mean of two by phase (:func:`_phase_parts`).
    Returns {"parent": [parts, ...], "change": [...]}."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)
    change = mk._library((), (step[2]["n_embd"],
                              step[2]["n_embd"] // step[2]["n_head"]))
    out = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        with _megakernel_library(parent_lib if side == "parent" else change):
            parts = _phase_parts(torch, *step, warm=1, runs=2)
        out[side].append(parts)
        print(f"{phase}: {label} in turns with the parent, {side}: "
              + ", ".join(f"{n} {t:.3f}" for n, t in parts.items())
              + f"; sum {sum(parts.values()):.3f} ms ({smi})")
    return out


def _phase21_full(torch, smi: str, parent_builds=None) -> dict:
    """(b) The honest configuration (K3, B=32, L=1024) and the MSRVTT grid
    (K4, B=8, L=2304) at MK_FULL_WIDTHS: the step against the plain version
    at that shape (every block loops over several work items), then kernel
    and plain timed in turns, the bound and the share, where a step's time
    goes; with ``parent_builds`` (:func:`start_parent_build`), K3 and K4 at
    MK_PARENT_WIDTHS by phase in turns with the parent's
    (:func:`_wide_parent_turns`). {"CxH": {"K3": ..., "K4":
    ...}}."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        HONEST, MSRVTT_GRID, at_width, build_models)
    out = {}
    for n_embd, n_head in MK_FULL_WIDTHS:
        key = f"{n_embd}x{n_head}"
        out[key] = {}
        for kid, grid, b, pack in (("K3", HONEST, 32, True),
                                   ("K4", MSRVTT_GRID, 8, None)):
            models = build_models(at_width(grid, n_embd, n_head), "cuda",
                                  torch.Generator().manual_seed(0))
            label = f"{kid} n_embd {n_embd} in {n_head} heads"
            ms, plain_ms, bound_ms, bound_by, step = _time_megakernel(
                torch, "phase 21", smi, label, models, b, pack,
                iters=MK_WIDTH_ITERS,
                tol=mk_hidden_tol(n_embd, n_embd // n_head, 4 * n_embd))
            _phase_times(torch, "phase 21", f"{label} B={b}", *step)
            out[key][kid] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, share=bound_ms / ms)
            if parent_builds is not None and \
                    (n_embd, n_head) in MK_PARENT_WIDTHS:
                out[key][kid]["parent_turns"] = _wide_parent_turns(
                    torch, "phase 21", smi, f"{label} B={b}",
                    parent_builds[n_embd, n_embd // n_head].result(), step)
            del models, step
            torch.cuda.empty_cache()
    return out


def _phase21_route(torch, smi: str) -> dict:
    """(c) The route at n_embd 64 in heads of 8: phase 10's small config on
    ``auto`` (the megakernel route on the card, a K3 launch a step) in argmax
    mode against the CPU's plain run of the same route; then
    ``sample_token_grid`` on ``auto`` at the honest configuration, 4 clips,
    100 steps: 100 K3 launches, tokens in range, no MASK left."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        HONEST, at_width, build_models, sample_token_grid)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.\
        discrete_diffusion import resolve_sampler

    small = at_width(_small_train_config(), 64, 8)
    small["generator"]["diffusion_model"]["guidance_scale"] = 2.0
    out = {}
    for dev, sampler in (("cuda", "auto"), ("cpu", "megakernel")):
        models = build_models(small, dev, torch.Generator().manual_seed(11))
        d3pm = models.generator.diffusion
        route = resolve_sampler("auto", torch.device(dev),
                                d3pm.content_seq_len, d3pm.transformer, True)
        batch = {"label": torch.tensor([0, 3, 4])}
        _reset_megakernel_counts()
        tok = sample_token_grid(models, batch, torch.Generator().manual_seed(
            12), sample=False, sampler=sampler)
        with torch.no_grad():
            out[dev] = (tok.cpu(), models.vqvae.decode(tok).cpu(), route,
                        _megakernel_counts())
    same = torch.equal(out["cuda"][0], out["cpu"][0])
    verr = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    steps_small = small["generator"]["diffusion_model"]["diffusion_step"]
    print(f"phase 21: small slice (T=8, K=17, L=32) at n_embd 64 in heads of "
          f"8: 'auto' on the card takes {out['cuda'][2]!r} (launches K3 "
          f"{out['cuda'][3][0]}, K4 {out['cuda'][3][1]}), argmax, against "
          f"the CPU's plain run of that route: tokens equal {same}, video "
          f"max-abs {verr:.3e} (tol {VIDEO_TOL})")
    if out["cuda"][2] != "megakernel" or \
            out["cuda"][3] != (steps_small, 0) or not same or \
            not verr <= VIDEO_TOL:
        raise AssertionError("the megakernel route at n_embd 64 in heads of "
                             "8 disagrees with the CPU")
    models = build_models(at_width(HONEST, 64, 8), "cuda",
                          torch.Generator().manual_seed(0))
    steps = HONEST["generator"]["diffusion_model"]["diffusion_step"]
    mask_id = HONEST["vqvae"]["n_codes"]
    g = torch.Generator().manual_seed(21)
    batch = {"label": torch.randint(0, 101, (MK_ROUTE_CLIPS,), generator=g)}
    _reset_megakernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = sample_token_grid(models, batch, g, sampler="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _megakernel_counts()
    print(f"phase 21: HONEST at n_embd 64 in heads of 8, {MK_ROUTE_CLIPS} "
          f"clips, {steps} steps on 'auto': {wall:.3f} s, launches K3 "
          f"{counts[0]}, K4 {counts[1]} (expected {steps}, 0); tokens in "
          f"[{int(tokens.min())}, {int(tokens.max())}], MASK left "
          f"{int((tokens == mask_id).sum())}; {smi}")
    if counts != (steps, 0) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= mask_id:
        raise AssertionError("the honest configuration at n_embd 64 in "
                             "heads of 8 did not sample through K3")
    return {"K3": counts[0]}


def _phase21_parent_turns(torch, smi: str, parent: str, parent_builds,
                          builds: dict) -> None:
    """(d) K3 (HONEST, B=32) and K4 (MSRVTT_GRID, B=8) at n_embd 64 in heads
    of 4: ROOT's kernels (its megakernel_step.cu, built in the background,
    launched through this checkout's wrapper: the C interface is the same),
    this checkout's (``change``) and the general code built at the same
    width (``general``, first held to the plain version on phase 21 (a)'s
    cases) in turns: parent, change, general, general, change, parent, 10
    launches each."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        HONEST, MSRVTT_GRID, build_models)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        megakernel as mk)

    parent_lib = parent_builds[64, 4].result()
    general = builds[GENERAL_SERVING].result()
    for label, pack_cfg, case in _mk_width_cases(torch):
        args, kw = _megakernel_case(torch, **case, seed=68)
        with _megakernel_library(general):
            _check_megakernel(torch, "phase 21", f"{GENERAL_SERVING}: "
                              f"{label}", args, kw, pack_cfg)
        del args
    libs = {"parent": parent_lib, "change": mk._library(),
            "general": general}
    for kid, grid, b, pack in (("K3", HONEST, 32, True),
                               ("K4", MSRVTT_GRID, 8, None)):
        models = build_models(grid, "cuda", torch.Generator().manual_seed(0))
        args, tab, kw = _time_megakernel(torch, "phase 21", smi,
                                         f"{kid} warm-up", models, b, pack,
                                         iters=2)[4]
        readings = {side: [] for side in libs}
        for side in ("parent", "change", "general", "general", "change",
                     "parent"):
            with _megakernel_library(libs[side]):
                readings[side].append(_time_ms(
                    lambda: mk.megakernel_step(*args, scratch=tab["scratch"],
                                               **kw), 10))
        slowest = max(readings["parent"])
        print(f"phase 21: {kid} n_embd 64 in heads of 4 (B={b}) in turns "
              f"with {parent}: " + "; ".join(
                  f"{side} " + ", ".join(f"{v:.4f}" for v in ms)
                  for side, ms in readings.items())
              + f" ms; the change no slower than the parent's slowest "
              f"reading: {max(readings['change']) <= slowest} ({smi})")
        del models, args, tab
        torch.cuda.empty_cache()


def start_parent_build(parent: str) -> dict:
    """ROOT's megakernel_step.cu built in the background at the serving
    width (phase 21 (d)) and at MK_PARENT_WIDTHS (phase 21 (b)), one nvcc
    each: {(n_embd, head dim): future of the library, its C entry bound}."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        cuda_build)
    src = Path(parent).resolve() / PKG / "csrc" / "megakernel_step.cu"

    def build(n_embd, d):
        lib = cuda_build.load(str(src), cuda_build.BUILD_DIR / "parent",
                              defines=(f"MK_C={n_embd}", f"MK_D={d}"))
        lib.megakernel_step.argtypes = [ctypes.c_void_p] * 4
        lib.megakernel_step.restype = ctypes.c_int
        return lib

    widths = [(64, 4)] + [(c, c // h) for c, h in MK_PARENT_WIDTHS]
    pool = ThreadPoolExecutor(len(widths))
    futs = {w: pool.submit(build, *w) for w in widths}
    pool.shutdown(wait=False)
    return futs


def phase_mk_widths(torch, smi: str, builds: dict,
                    parent: str | None = None, parent_build=None) -> dict:
    """Phase 21: the width libraries, (a) the kernels at every width, (b)
    the full-width configurations timed, (c) the route at n_embd 64 in
    heads of 8, (d) with ``parent``, the serving width in turns."""
    t0 = time.perf_counter()
    nvcc = _phase21_builds(builds, parent_build)
    worst, tolerance = _phase21_kernels(torch, smi)
    t1 = time.perf_counter()
    full = _phase21_full(torch, smi, parent_build)
    t2 = time.perf_counter()
    route = _phase21_route(torch, smi)
    t3 = time.perf_counter()
    if parent is not None:
        _phase21_parent_turns(torch, smi, parent, parent_build, builds)
    print(f"phase 21: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{t3 - t2:.1f} s, (d) {time.perf_counter() - t3:.1f} s")
    return {"worst": worst, "tolerance": tolerance, "full": full,
            "route": route, "nvcc": nvcc}


# phase 22: the rest of K1, K2, K5 and K6's domain. K1 above the register
# design's 8192 classes (in shared memory, and past it from device memory:
# 32768 classes under guidance), K6 above code dim 384 (x streamed beside E)
# through its three entries, K2 / K5 above head dim 128 (the stream design),
# then WIDE_DOMAIN, a configuration that needs all four, through the
# entries users run
P22_K1_CASES = ((8193, 2.0, 3.0), (10240, 2.0, 3.0), (10241, 2.0, 3.0),
                (16384, 2.0, 3.0), (16384, 1.0, 3.0), (16384, 2.0, 30.0),
                (32768, 2.0, 3.0), (32768, 1.0, 3.0), (32769, 2.0, 3.0))
P22_K1_TIMED = (8193, 10240, 16384, 32768)
P22_K6_DIMS = (385, 512, 768, 1024)
P22_K6_CODES = (512, 4096, 16384)
P22_HEAD_DIMS = (144, 192, 256, 512)
P22_B, P22_L = 16, 1024    # WIDE_DOMAIN's training batch, 1024 tokens
P22_ITERS = 3


def _phase22_k1(torch, smi: str) -> dict:
    """K1 at K-1 = 8193-32769 (B=4 under guidance and without, L=1024)
    against its plain version: posterior within K1_TOL, argmax tokens equal
    at decided positions, sampled tokens in [0, K) and as often on the
    posterior's argmax as the plain version's draws; then timed at 2B=16
    (WIDE_DOMAIN's sampling batch) at each of P22_K1_TIMED."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.d3pm import (
        make_schedule)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import (fused_sample_step, fused_sample_step_reference,
                sample_step_design, schedule_rows)

    worst = 0.0
    B, L = 4, 1024
    for kv, guidance, scale in P22_K1_CASES:
        K = kv + 1
        rows = schedule_rows(make_schedule(100, K, device="cuda"))
        g = torch.Generator(device="cuda").manual_seed(kv + int(scale))
        nb = 2 * B if guidance != 1.0 else B
        logits2 = (scale * torch.randn((nb, L, kv), generator=g,
                                       device="cuda")).transpose(1, 2)
        tokens = torch.randint(0, kv, (B, L), generator=g, device="cuda")
        tokens = torch.where(torch.rand((B, L), generator=g, device="cuda")
                             < 0.5, kv, tokens)
        args = (logits2, tokens, rows[50], 7)
        kw = dict(guidance=guidance, num_classes=K, return_posterior=True)
        tok_k, post_k = fused_sample_step(*args, sample=False, **kw)
        tok_p, post_p = fused_sample_step_reference(*args, sample=False, **kw)
        err = (post_k - post_p).abs().max().item()
        top2 = post_p.topk(2, dim=1).values
        decided = (top2[:, 0] - top2[:, 1]) > K1_TOL
        wrong = ((tok_k != tok_p) & decided).sum().item()
        del post_k, post_p, top2
        drawn = fused_sample_step(*args, sample=True, **kw)[0]
        in_range = bool(((drawn >= 0) & (drawn < K)).all())
        rate_k = (drawn == tok_p).float().mean().item()
        rate_p = (fused_sample_step_reference(*args, sample=True, **kw)[0]
                  == tok_p).float().mean().item()
        design = sample_step_design(kv, nb == 2 * B)
        print(f"phase 22: K1 B={B} L={L} K-1={kv} guidance={guidance} "
              f"logits x {scale} (rows in {design}): posterior max-abs "
              f"{err:.3e} (tol {K1_TOL}), {wrong} token mismatches of "
              f"{int(decided.sum())} decided positions; sampled tokens in "
              f"[0, K): {in_range}, = argmax at {rate_k:.4f} (kernel) vs "
              f"{rate_p:.4f} (plain)")
        if not err <= K1_TOL or wrong or not in_range or \
                not abs(rate_k - rate_p) < 0.05:
            raise AssertionError("K1 disagrees with its plain version")
        worst = max(worst, err)
        del logits2, tokens, drawn, tok_k, tok_p
        torch.cuda.empty_cache()

    timed = {}
    B = 8
    for kv in P22_K1_TIMED:
        K = kv + 1
        rows = schedule_rows(make_schedule(100, K, device="cuda"))
        g = torch.Generator(device="cuda").manual_seed(5 + kv)
        logits2 = torch.randn((2 * B, L, kv), generator=g,
                              device="cuda").transpose(1, 2)
        tokens = torch.full((B, L), kv, dtype=torch.int64, device="cuda")
        kw = dict(guidance=2.0, num_classes=K, sample=True)
        ms, plain_ms = _ab_ms(
            lambda: fused_sample_step_reference(logits2, tokens, rows[50], 3,
                                                **kw),
            lambda: fused_sample_step(logits2, tokens, rows[50], 3, **kw),
            P22_ITERS)
        nbytes, flops = sample_step_work(B, 2 * B, kv, L)
        bound_ms, bound_by = _bound(nbytes, flops)
        timed[str(kv)] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                              bound_ms=bound_ms, bound_by=bound_by,
                              rows_in=sample_step_design(kv, True))
        print(f"phase 22: K1 (2B={2 * B}, K-1={kv}, L={L}, rows in "
              f"{timed[str(kv)]['rows_in']}) kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({nbytes / 1e9:.3f} GB at {PEAK_BYTES / 1e12} TB/s), "
              f"{bound_ms / ms:.3f} of it; no single library call ({smi})")
        del logits2, tokens
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "by_classes": timed}


def k6_margin(d: int) -> float:
    """K6_MARGIN (set at D <= 128) at code dim ``d``: the f32 sums of a
    distance (||e||^2, of size ~D, and x.e) err by ~sqrt(D) roundings of
    an ulp that grows with D, so the margin that decides a row grows as
    (D / 128)^1.5 above 128."""
    return K6_MARGIN * max(1.0, d / 128) ** 1.5


def _phase22_k6(torch, smi: str) -> dict:
    """K6 at D = 385-1024 and K = 512, 4096, 16384 (N = 4096 rows, 16384
    at WIDE_DOMAIN's K = 16384, D = 512) through its three entries against
    the distances in f64: the statistics entry's indices at the rows whose
    top-two margin exceeds ``k6_margin(D)``, its statistics from its own
    indices; the distance entry's indices equal to the statistics entry's,
    its distances within ``k6_margin(D) / 4`` of the f64 ones at those
    indices; the statistics entry over a range of codes equal to the plain
    one; and the codebook cut into two shards, the nearest over the shards
    (ties to the lower) equal to the unsharded index. Then timed at
    N=16384, K=4096 at each D and at WIDE_DOMAIN's shape, with torch.cdist
    + argmin (two library calls) beside it."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
        import (code_stats, code_stats_range_reference, code_stats_reference,
                nearest_code_dist, nearest_code_stats,
                nearest_code_stats_reference)

    worst = 0.0
    for d in P22_K6_DIMS:
        for k in P22_K6_CODES:
            n = 16384 if (k, d) == (16384, 512) else 4096
            g = torch.Generator(device="cuda").manual_seed(n + k + d)
            x = torch.randn((n, d), generator=g, device="cuda")
            emb = torch.randn((k, d), generator=g, device="cuda")
            margin = k6_margin(d)
            idx, n_total, encode_sum = nearest_code_stats(x, emb)
            xd, ed = x.double(), emb.double()
            dist = -2.0 * (xd @ ed.t()) + (ed * ed).sum(dim=-1)[None, :]
            ref_idx = dist.argmin(dim=1).to(torch.int32)
            top2 = (-dist).topk(2, dim=1).values
            decided = (top2[:, 0] - top2[:, 1]) > margin
            want_n, want_sum = code_stats_reference(x, idx, k)
            wrong = int(((idx != ref_idx) & decided).sum())
            err = max((n_total - want_n).abs().max().item(),
                      (encode_sum - want_sum).abs().max().item())
            d_idx, d_dist = nearest_code_dist(x, emb)
            want_dist = dist.gather(1, d_idx.long()[:, None])[:, 0]
            dist_err = (d_dist - want_dist).abs().max().item()
            half = k // 2
            lo_i, lo_d = nearest_code_dist(x, emb[:half].contiguous())
            hi_i, hi_d = nearest_code_dist(x, emb[half:].contiguous())
            sharded = torch.where(hi_d < lo_d, hi_i + half, lo_i)
            lo = k // 4
            r_n, r_sum = code_stats(x, idx, lo, half)
            w_n, w_sum = code_stats_range_reference(x, idx, lo, half)
            stats_err = max((r_n - w_n).abs().max().item(),
                            (r_sum - w_sum).abs().max().item())
            ok = (not wrong and err <= K6_TOL and torch.equal(d_idx, idx)
                  and dist_err <= margin / 4 and torch.equal(sharded, idx)
                  and stats_err <= K6_TOL and torch.equal(n_total, want_n))
            print(f"phase 22: K6 N={n} K={k} D={d}: {wrong} index mismatches "
                  f"with the f64 argmin of {int(decided.sum())} rows decided "
                  f"by {margin:.4f}, statistics max-abs "
                  f"{err:.3e} (tol {K6_TOL}); nearest_code_dist: indices "
                  f"equal {torch.equal(d_idx, idx)}, distances max-abs "
                  f"{dist_err:.3e} (tol {margin / 4:.3e}), two shards' nearest"
                  f" = unsharded {torch.equal(sharded, idx)}; code_stats "
                  f"[{lo}, {lo + half}) max-abs {stats_err:.3e}")
            if not ok:
                raise AssertionError("K6 disagrees with its plain version")
            worst = max(worst, err, stats_err)
            del x, emb, xd, ed, dist, top2
            torch.cuda.empty_cache()

    timed = {}
    for n, k, d in [(16384, 4096, dd) for dd in P22_K6_DIMS] + [
            (16384, 16384, 512)]:
        g = torch.Generator(device="cuda").manual_seed(9 + d)
        x = torch.randn((n, d), generator=g, device="cuda")
        emb = torch.randn((k, d), generator=g, device="cuda")
        ms, plain_ms = _ab_ms(lambda: nearest_code_stats_reference(x, emb),
                              lambda: nearest_code_stats(x, emb), P22_ITERS)
        lib_ms = _time_ms(lambda: torch.cdist(x, emb).argmin(dim=1),
                          P22_ITERS)
        nbytes, flops = codebook_work(n, k, d)
        bound_ms, bound_by = _bound(nbytes, 0.0, flops_tf32=3.0 * flops)
        timed[f"{n}x{k}x{d}"] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            library="torch.cdist + argmin (two calls, no statistics)",
            bound_ms=bound_ms, bound_by=bound_by)
        print(f"phase 22: K6 (N={n}, K={k}, D={d}) kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.cdist + argmin (two calls, no "
              f"statistics) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} (3 x {flops / 1e9:.1f} GFLOP at "
              f"{PEAK_TF32 / 1e12} TFLOP/s TF32), {bound_ms / ms:.3f} of it "
              f"({smi})")
        del x, emb
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "by_shape": timed}


def _phase22_attention(torch, smi: str, parent: str | None = None) -> dict:
    """(a, b) K2 and K5 at head dims 144-512 in 2 heads, f32 and bf16,
    against the plain versions (self at B=16, L=1024; cross over 1 and 77
    keys), timed at B=16 with sdpa beside them; the products the stream
    design runs and the share of them that recompute the scores; with
    ``parent`` (a checkout's root), the same shapes timed in turns with
    that checkout's kernels (``probes/attention_variants.py:
    compare_widths``)."""
    rows = _attention_widths(torch, smi, "phase 22", P22_HEAD_DIMS, P22_B,
                             lambda d: 2)
    for d in P22_HEAD_DIMS:
        w = stream_products(d)
        print(f"phase 22: d={d}: {w['chunks']} column chunk(s) of "
              f"{w['out']}; a (query, key) pair costs K2 {w['fwd']} FLOP "
              f"({w['fwd_function']} the function's; {w['fwd_recompute']:.3f}"
              f" of them recompute the scores) and K5 {w['bwd']} "
              f"({w['bwd_function']}; {w['bwd_recompute']:.3f}); the bound "
              f"counts the function's")
        for (dd, name), row in rows.items():
            if dd == d:
                row["stream_products"] = w
    if parent is None:
        return rows
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        attention_variants)
    res = attention_variants.compare_widths(parent, P22_HEAD_DIMS,
                                            log=lambda line: None,
                                            batch=P22_B, n_head=2)
    for d in P22_HEAD_DIMS:
        for dtype in ("float32", "bfloat16"):
            for kind in ("K2", "K5"):
                for shape in ("self", "cross", "cross77"):
                    key = f"{d} {kind} {shape} {dtype}"
                    read = {side: [r[key] for r in runs]
                            for side, runs in res["ms"].items()}
                    best = {side: min(v) for side, v in read.items()}
                    rows[(d, dtype)][f"{kind} {shape}"]["parent_ms"] = (
                        best["parent"])
                    print(f"phase 22: {kind} d={d} {dtype} {shape} (B="
                          f"{P22_B}, 2 heads) in turns with {parent}: this "
                          f"checkout " + " ".join(f"{x:.4f}" for x in
                                                  read["change"])
                          + f" ms, {parent} " + " ".join(
                              f"{x:.4f}" for x in read["parent"])
                          + f" ms; {best['change'] / best['parent']:.3f} of "
                          f"its time ({res['card']})")
    return rows


def stream_products(d: int) -> dict:
    """FLOP a (query, key, head) pair of the stream design (head dim ``d``
    above 128) runs: each of its ``chunks`` column chunks of ``out``
    columns (``ops/attention.py: stream_out``; one chunk up to
    STREAM_ONE_PASS) computes the scores over d padded to STREAM_CHUNK and
    K2's P V over its columns; K5's dq kernel S and dP and its dk/dv kernel
    S^T and dP^T, each once a chunk, and dQ, dK, dV over its columns.
    Beside them the function's work (K2 4 d, K5 10 d, as
    ``roofline.attention_work``) and the share of the kernels' products that
    the column chunks recompute (0 up to STREAM_ONE_PASS)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        kernel_head_dim, stream_out)
    out, chunks = stream_out(d)
    dp = kernel_head_dim(d)
    fwd = chunks * (2 * dp + 2 * out)
    bwd = chunks * (2 * 4 * dp + 6 * out)
    return dict(out=out, chunks=chunks, fwd=fwd, bwd=bwd,
                fwd_function=4 * d, bwd_function=10 * d,
                fwd_recompute=(chunks - 1) * 2 * dp / fwd,
                bwd_recompute=(chunks - 1) * 2 * 4 * dp / bwd)


# WIDE_DOMAIN: a configuration that needs all four kernels past their old
# domain, through the existing overrides. Stage 1 at vqvae_ucf.sh's widths
# with the 16384 codes of TATS' 3D VQGAN (Ge et al., ECCV 2022) at code dim
# 512 (K6 at K = 16384, D = 512); stage 2 at ddiff_ucf.sh's honest
# configuration (19 layers, 1024 tokens, CFG 2, a label condition) over
# that codebook, the denoiser at n_embd 512 in 2 heads of 256 (K2 / K5 at
# d = 256, K1 at K - 1 = 16384), bf16 compute
WIDE_DOMAIN = {
    "stage1": ("model.generator.n_codes=16384",
               "model.generator.embedding_dim=512"),
    "stage2": ("model.autoencoder.n_codes=16384",
               "model.autoencoder.embedding_dim=512",
               "model.generator.diffusion_model.transformer.n_embd=512",
               "model.generator.diffusion_model.transformer.n_head=2",
               "model.generator.diffusion_model.transformer.dtype=bfloat16"),
}
WIDE_DOMAIN_STEPS = {"stage1": 2, "stage2": 3}
WIDE_DOMAIN_CLIPS = 8           # sampled on auto: 2B = 16 logits rows
WIDE_DOMAIN_K3_CLIPS = 32       # the honest width over the 16384 codes


def _phase22_train(torch, smi: str, base: Path) -> dict:
    """(c) WIDE_DOMAIN trained: stage 1 (2 steps of B=64, then its
    checkpoint) and stage 2 over that checkpoint (3 bf16 steps of B=16)
    through ``tasks.train``'s function in this process (phase 17's way, so
    that the launches are counted here). Returns each stage's launches and
    run directory."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch import tasks
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        fused_mha, fused_mha_bwd)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
        import nearest_code_stats
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage1 import (
        Stage1Trainer)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
        Stage2Trainer)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.utils.config import (
        compose)

    out = {}
    quiet = ["model.do_evaluation=false", "trainer.max_epochs=1",
             "trainer.check_val_every_n_epoch=2", "extras.print_config=false"]
    for stage, script, trainer_cls, b in (
            ("stage1", "vqvae_ucf.sh", Stage1Trainer, 64),
            ("stage2", "ddiff_ucf.sh", Stage2Trainer, 16)):
        steps = WIDE_DOMAIN_STEPS[stage]
        extra = ([] if stage == "stage1" else [
            f"model.checkpoint_paths.autoencoder="
            f"{out['stage1']['run'] / 'checkpoints'}"])
        cfg = compose("train", _job_overrides(script) + list(HARNESS_BASE)
                      + list(WIDE_DOMAIN[stage]) + quiet + extra + [
                          f"trainer.max_steps={steps}",
                          f"datamodule.num_train={b * steps}",
                          f"paths.output_dir={base / stage}"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_harness_counts()
        widths = [f.by_head_dim.copy() for f in (fused_mha, fused_mha_bwd)]
        dims = nearest_code_stats.by_dim.copy()
        probe = _StepProbe(torch, trainer_cls)
        t0 = time.perf_counter()
        with probe:
            tasks.train(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = _harness_counts()
        widths = [dict(f.by_head_dim - w)
                  for f, w in zip((fused_mha, fused_mha_bwd), widths)]
        dims = dict(nearest_code_stats.by_dim - dims)
        step, span, _, issue = probe.timing(2)
        model = cfg["model"]
        if stage == "stage1":
            g = model["generator"]
            what = (f"stage 1 at vqvae_ucf.sh's widths, {g['n_codes']} codes "
                    f"of dim {g['embedding_dim']}")
            ok = counts["K6"] >= steps and set(dims) == {g["embedding_dim"]}
        else:
            tr = model["generator"]["diffusion_model"]["transformer"]
            ae = model["autoencoder"]
            what = (f"stage 2 at ddiff_ucf.sh, {tr['n_layer']} layers, n_embd "
                    f"{tr['n_embd']} in {tr['n_head']} heads of "
                    f"{tr['n_embd'] // tr['n_head']}, {tr['dtype']}, over "
                    f"{ae['n_codes']} codes of dim {ae['embedding_dim']}")
            at_256 = {(256, torch.bfloat16): steps * 2 * tr["n_layer"]}
            ok = (counts["K5"] == steps * 2 * tr["n_layer"]
                  and counts["K2"] == counts["K5"] and counts["K6"] == steps
                  and widths == [at_256, at_256]
                  and set(dims) == {ae["embedding_dim"]})
        print(f"phase 22: WIDE_DOMAIN {what}: tasks.train, B={cfg['batch_size']}"
              f", {steps} steps: wall {wall:.2f} s; steps 2-{steps} "
              f"{step:.4f} s a step in the loop, {span:.4f} s inside each "
              f"step (CUDA events), {issue:.4f} s to issue one (host clock); "
              f"launches " + ", ".join(f"{k} {v}" for k, v in counts.items())
              + f"; K2 / K5 by (head dim, dtype) {_by_head_dim(widths[0])} / "
              f"{_by_head_dim(widths[1])}; K6 by D {dims}; peak memory "
              f"{peak:.2f} GiB ({smi})")
        if probe.trainer.global_step != steps or not ok:
            raise AssertionError(f"WIDE_DOMAIN {stage} did not launch its "
                                 f"kernels as expected: {counts}")
        out[stage] = dict(counts, run=_run_dir(base / stage), s_step=step)
        del probe
        torch.cuda.empty_cache()
    return out




def _generate_wide(torch, argv: list[str]) -> dict:
    """``python -m ..._torch.generate``'s function over WIDE_DOMAIN's stage
    2 checkpoint: the sampling call's wall time, videos, route and the call
    itself (for the turns), and the launches of the run."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch import generate
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        fused_mha)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.megakernel import (
        megakernel_step)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import fused_sample_step
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
        Stage2Trainer)

    seen = {}
    saved = Stage2Trainer.sample_videos

    def sample_videos(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        videos = saved(self, *args, **kw)
        torch.cuda.synchronize()
        seen.update(wall=time.perf_counter() - t0, shape=tuple(videos.shape),
                    finite=bool(torch.isfinite(videos).all()),
                    route=self.sampler, call=(self, args, kw))
        return videos

    _reset_harness_counts()
    counters = (fused_sample_step.by_classes, fused_mha.by_head_dim,
                megakernel_step.launches_by_width)
    before = [c.copy() for c in counters]
    Stage2Trainer.sample_videos = sample_videos
    try:
        rc = generate.main(argv)
    finally:
        Stage2Trainer.sample_videos = saved
    torch.cuda.synchronize()
    k1, k2, mk = (dict(c - b) for c, b in zip(counters, before))
    return dict(seen, rc=rc, counts=_harness_counts(), k1=k1, k2=k2, mk=mk,
                saved=saved)


def _phase22_sample(torch, smi: str, base: Path, ckpt: Path,
                    profile: bool = False) -> dict:
    """(c) WIDE_DOMAIN sampled through ``python -m ..._torch.generate``'s
    function over stage 2's checkpoint, 8 clips, 100 steps, then the
    decode: on ``auto`` (the megakernel route, as JAX's rule: K3 at n_embd
    512 in heads of 256 each step) and with ``trainer.sampler=model`` (K2 at
    d = 256 and K1 at K-1 = 16384 each step); then both routes on that
    trainer's models and batch in argmax mode, in turns (megakernel, model,
    model, megakernel; the token grids, without the decode): their ms a
    step and how many tokens agree; with ``profile``, the model route's
    sampling call again under torch.profiler (``traced``). Returns each
    route's launches and ms a step."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        GenerationModels, sample_token_grid)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train.loop import (
        device_batch)

    argv = (_job_overrides("ddiff_ucf.sh") + list(HARNESS_BASE)
            + list(WIDE_DOMAIN["stage2"]) + [
                "extras.print_config=false", f"ckpt_path={ckpt}",
                f"+num_samples={WIDE_DOMAIN_CLIPS}",
                f"+out_dir={base / 'samples'}"])
    steps = 100
    runs = {"megakernel": _generate_wide(torch, argv),
            "model": _generate_wide(torch, argv + ["+trainer.sampler=model"])}
    out = {}
    for route, r in runs.items():
        ms = 1e3 * r["wall"] / steps
        counts = r["counts"]
        print(f"phase 22: WIDE_DOMAIN sampled through generate over stage "
              f"2's checkpoint: {r['shape'][0]} clips, {steps} steps (route "
              f"{r['route']!r}) and the decode: {r['wall']:.3f} s, {ms:.3f} "
              f"ms a step with the decode; launches K1 {counts['K1']} (by "
              f"K-1 {r['k1']}), K2 {counts['K2']} (by (head dim, dtype) "
              f"{_by_head_dim(r['k2'])}), K3 {counts['K3']} (by (n_embd, "
              f"head dim) {r['mk']}); videos {r['shape']}, finite "
              f"{r['finite']} ({smi})")
        n2 = sum(n for (d, _), n in r["k2"].items() if d == 256)
        if route == "megakernel":
            ok = (r["mk"] == {(512, 256, "K3"): steps}
                  and counts["K3"] == steps and not counts["K1"]
                  and not counts["K2"])
        else:
            ok = (r["k1"] == {16384: steps} and counts["K1"] == steps
                  and n2 == 38 * steps and counts["K2"] == n2
                  and not counts["K3"])
        if (r["rc"] != 0 or r["route"] != route or not ok or not r["finite"]
                or r["shape"][0] != WIDE_DOMAIN_CLIPS):
            raise AssertionError(f"WIDE_DOMAIN's sampling did not take the "
                                 f"{route} route with its launches: {counts}")
        out[route] = dict(counts, ms_step=ms, traced=None)
    # both routes on the same trainer, models and batch, argmax, in turns
    me, args, kw = runs["model"]["call"]
    models = GenerationModels(me.state.generator, me.state.vqvae)
    db = device_batch(me._prepare_batch(args[0]), me.device)
    readings, tokens = {route: [] for route in runs}, {}
    for route in ("megakernel", "model", "model", "megakernel"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens[route] = sample_token_grid(
            models, db, torch.Generator().manual_seed(5), sample=False,
            sampler=route)
        torch.cuda.synchronize()
        readings[route].append(1e3 * (time.perf_counter() - t0) / steps)
    for route, ms in readings.items():
        out[route]["turns_ms_step"] = ms
    agree = float((tokens["megakernel"] == tokens["model"]).double().mean())
    out["argmax_agreement"] = agree
    print(f"phase 22: WIDE_DOMAIN's two routes on one trainer and batch, "
          f"argmax: tokens agree at {agree:.4f} of "
          f"{tokens['model'].numel()} positions; ms a step of the token "
          f"grid in turns: " + "; ".join(
              f"{route} " + ", ".join(f"{v:.3f}" for v in ms)
              for route, ms in readings.items()) + f" ({smi})")
    del tokens
    if not profile:
        return out
    # the model route's call again under torch.profiler (after the counts):
    # the device's busy share of a step and K2's device time a step
    saved = runs["model"]["saved"]
    prof = _profile_kernels(
        torch, "phase 22: WIDE_DOMAIN sample_videos on the model route (8 "
        "clips, 100 steps; a 'step' below is the call)",
        lambda: saved(me, *args, **kw), steps=1, cpu=False)
    k2_us = sum(us for name, (us, _) in prof["kernels"].items()
                if "fused_mha_fwd" in name)
    traced = dict(busy=prof["device_us"] / 1e6 / prof["wall"],
                  device_ms_step=prof["device_us"] / 1e3 / steps,
                  wall_ms_step=prof["wall"] * 1e3 / steps,
                  k2_ms_step=k2_us / 1e3 / steps)
    print(f"phase 22: WIDE_DOMAIN sampling traced: {traced['wall_ms_step']:.3f}"
          f" ms a step on the host's clock (profiled), the device busy "
          f"{traced['device_ms_step']:.3f} ms of it ({traced['busy']:.3f}), "
          f"K2 {traced['k2_ms_step']:.3f} ms a step ({smi})")
    out["model"]["traced"] = traced
    return out


def _phase22_wide_k3(torch) -> float:
    """(c) K3 at WIDE_DOMAIN's sampling shape (n_embd 512 in 2 heads of
    256, 19 layers, 1024 tokens, K = 16385, a label's one-token condition,
    bf16 weights, WIDE_DOMAIN_CLIPS rows) against the plain version, its
    hidden state under mk_hidden_tol and MK_RMS_SHARE, before the route is
    timed. Returns the hidden state's max-abs error."""
    k = 16385
    args, kw = _megakernel_case(
        torch, L=1024, spatial=(32, 32), k=k, n_layer=19, s_len=1,
        B=WIDE_DOMAIN_CLIPS, use_cfg=True, dtype=torch.bfloat16, seed=k + 1,
        n_embd=512, n_head=2)
    err = _check_megakernel(
        torch, "phase 22", f"K3 n_embd 512 in 2 heads of 256, bf16 weights "
        f"B={WIDE_DOMAIN_CLIPS} L=1024 K={k} 19 layers S=1 (WIDE_DOMAIN's "
        f"sampling step)", args, kw, True, mk_hidden_tol(512, 256, 2048),
        witness=True)[1]
    del args
    torch.cuda.empty_cache()
    return err


def _phase22_k3(torch, smi: str) -> dict:
    """(c) The main path over the large codebook: K3 at the honest width
    (n_embd 64 in heads of 4, 19 layers, 1024 tokens) with K = 16385,
    against the plain version (B=2, bf16 weights); then HONEST over 16384
    codes on ``auto``: 32 clips, 100 steps, 100 K3 launches, tokens in
    range, no MASK left."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        HONEST, build_models, sample_token_grid)

    k = 16385
    args, kw = _megakernel_case(
        torch, L=1024, spatial=(32, 32), k=k, n_layer=19, s_len=1, B=2,
        use_cfg=True, dtype=torch.bfloat16, seed=k)
    err = _check_megakernel(torch, "phase 22", "K3 bf16 weights B=2 L=1024 "
                            "K=16385 19 layers S=1 (the honest width over "
                            "16384 codes)", args, kw, True)[1]
    del args
    torch.cuda.empty_cache()
    config = dict(HONEST, vqvae=dict(HONEST["vqvae"], n_codes=k - 1,
                                     embedding_dim=512))
    models = build_models(config, "cuda", torch.Generator().manual_seed(0))
    steps = config["generator"]["diffusion_model"]["diffusion_step"]
    g = torch.Generator().manual_seed(22)
    batch = {"label": torch.randint(0, 101, (WIDE_DOMAIN_K3_CLIPS,),
                                    generator=g)}
    _reset_megakernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = sample_token_grid(models, batch, g, sampler="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _megakernel_counts()
    print(f"phase 22: HONEST over {k - 1} codes of dim 512, "
          f"{WIDE_DOMAIN_K3_CLIPS} clips, {steps} steps on 'auto': "
          f"{wall:.3f} s ({1e3 * wall / steps:.3f} ms a step), launches K3 "
          f"{counts[0]}, K4 {counts[1]} (expected {steps}, 0); tokens in "
          f"[{int(tokens.min())}, {int(tokens.max())}], MASK left "
          f"{int((tokens == k - 1).sum())} ({smi})")
    if counts != (steps, 0) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= k - 1:
        raise AssertionError("HONEST over 16384 codes did not sample "
                             "through K3")
    del models
    torch.cuda.empty_cache()
    return {"K3": counts[0], "max_abs_err": err,
            "ms_step": 1e3 * wall / steps}


def _phase22_parent_k1(torch, parent: str) -> None:
    """(d) K1 at K-1 = 4096 and 8192 (the register design, whose code the
    wide kernel left as it was), sampled: ROOT's kernel (its ``sample_step.cu``
    built into ``_build/parent`` and launched through this wrapper) and this
    checkout's give the same tokens bit for bit."""
    import ctypes

    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.d3pm import (
        make_schedule)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        cuda_build, sampler_kernel)
    lib = cuda_build.load(
        str(Path(parent).resolve() / PKG / "csrc" / "sample_step.cu"),
        cuda_build.BUILD_DIR / "parent")
    lib.fused_sample_step.argtypes = (
        sampler_kernel._library().fused_sample_step.argtypes)
    lib.fused_sample_step.restype = ctypes.c_int
    B, L = 8, 1024
    for kv in (4096, 8192):
        rows = sampler_kernel.schedule_rows(make_schedule(100, kv + 1,
                                                          device="cuda"))
        g = torch.Generator(device="cuda").manual_seed(kv)
        logits2 = torch.randn((2 * B, L, kv), generator=g,
                              device="cuda").transpose(1, 2)
        tokens = torch.full((B, L), kv, dtype=torch.int64, device="cuda")
        args = (logits2, tokens, rows[50], 3)
        kw = dict(guidance=2.0, num_classes=kv + 1, sample=True)
        own = sampler_kernel.fused_sample_step(*args, **kw)
        saved = sampler_kernel._library
        sampler_kernel._library = lambda: lib
        try:
            theirs = sampler_kernel.fused_sample_step(*args, **kw)
        finally:
            sampler_kernel._library = saved
        same = torch.equal(own, theirs)
        print(f"phase 22: K1 2B={2 * B} K-1={kv} L={L}, sampled: this "
              f"checkout's tokens and {parent}'s bitwise equal: {same}")
        if not same:
            raise AssertionError("K1's register design moved from the "
                                 "parent's")


def _phase22_parent_turns(torch, smi: str, parent: str | None) -> None:
    """(d) With ``--parent ROOT``: K1's register design against ROOT's bit
    for bit, and K2 and K5 at d = 64 (VQ-Diffusion-B's heads), f32, in
    turns (``probes/attention_variants.py``: compare); K1 and K6 at today's
    shapes are timed in turns in phases 2 and 6, and K2 / K5 at d = 4 in
    phase 20 (d)."""
    if parent is None:
        return
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        attention_variants)
    _phase22_parent_k1(torch, parent)
    res = attention_variants.compare(parent, rounds=3, head_dim=64,
                                     log=lambda line: None)
    for side, runs in res["ms"].items():
        print(f"phase 22: d = 64 in turns, {side}: " + "; ".join(
            ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) for ms in runs)
            + f" ms ({res['card']})")


def phase_wide_domain(torch, smi: str, parent: str | None = None,
                      profile: bool = False) -> dict:
    """Phase 22: (a) K1, K6, K2 / K5 at their new shapes against the plain
    versions, (b) timed there (with ``--parent``, K2 / K5 in turns with the
    parent's kernels), (c) WIDE_DOMAIN through the entries, its sampling
    step and K2's share of it, and the honest width over its codebook
    through K3, (d) with ``--parent``, today's d = 64 in turns."""
    import shutil

    t0 = time.perf_counter()
    k1 = _phase22_k1(torch, smi)
    k6 = _phase22_k6(torch, smi)
    attention = _phase22_attention(torch, smi, parent)
    t1 = time.perf_counter()
    base = ROOT / "logs" / "chip_smoke_wide_domain" / f"{time.time_ns()}"
    try:
        train = _phase22_train(torch, smi, base)
        wide_k3_err = _phase22_wide_k3(torch)
        sampling = _phase22_sample(torch, smi, base,
                                   train["stage2"]["run"] / "checkpoints",
                                   profile)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    # K2's share of a sampling step: (b)'s times at the same shape (2B = 16
    # rows of 1024 queries, 2 heads of 256, bf16: 19 launches over the 1024
    # tokens and 19 over the label's one key a step), and with --profile
    # its traced device time a step
    row = attention[(256, "bfloat16")]
    k2_ms = 19 * (row["K2 self"]["ms"] + row["K2 cross"]["ms"])
    model = sampling["model"]
    traced = model["traced"]
    k2_step = traced["k2_ms_step"] if traced else k2_ms
    model["k2_share"] = k2_step / model["ms_step"]
    print(f"phase 22: WIDE_DOMAIN sampling on the model route "
          f"{model['ms_step']:.3f} ms a step; K2 {k2_step:.3f} ms of it "
          + (f"traced ({model['k2_share']:.3f}; (b)'s times give "
             f"{k2_ms:.3f}" if traced else
             f"from (b)'s times ({model['k2_share']:.3f}")
          + f": 19 x {row['K2 self']['ms']:.4f} + 19 x "
          f"{row['K2 cross']['ms']:.4f})"
          + (f"; the device busy {traced['busy']:.3f} of the traced step"
             if traced else "; --profile traces it") + f" ({smi})")
    k3 = _phase22_k3(torch, smi)
    t2 = time.perf_counter()
    _phase22_parent_turns(torch, smi, parent)
    print(f"phase 22: (a, b) {t1 - t0:.1f} s, (c) {t2 - t1:.1f} s, (d) "
          f"{time.perf_counter() - t2:.1f} s")
    return {"k1": k1, "k6": k6, "attention": attention, "train": train,
            "sampling": sampling, "k3": k3, "wide_k3_err": wide_k3_err}


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the port's main path on "
                                 "one CUDA card.")
    ap.add_argument("--profile", action="store_true",
                    help="time each training step by kernel")
    ap.add_argument("--parent", metavar="ROOT",
                    help="also time K1, K6, P1, P2, P3, K2 and K5 at head "
                         "dims 4 and 64, and K3 and K4 at n_embd 64 in heads "
                         "of 4 and (by phase) at 1024 in heads of 16, in "
                         "turns with the checkout at ROOT")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    smi = phase_environment(torch)
    width_builds = start_width_builds(general=args.parent is not None)
    parent_build = (start_parent_build(args.parent)
                    if args.parent is not None else None)
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
    t_phase19 = time.perf_counter()
    tp = phase_tp(torch, smi)
    t_phase20 = time.perf_counter()
    widths = phase_widths(torch, smi, args.parent, profile)
    t_phase21 = time.perf_counter()
    mk_widths = phase_mk_widths(torch, smi, width_builds, args.parent,
                                parent_build)
    t_phase22 = time.perf_counter()
    wide = phase_wide_domain(torch, smi, args.parent, profile)
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
             designs=MK_DESIGNS, **k3),
        dict(name="megakernel_step_branch", route="cuda",
             source=f"{PKG}/csrc/megakernel_step.cu",
             replaces=tpu + "ops/megakernel.py:298",
             launches=route["K4"],
             launches_by_path={serve_mk + ", B=8, L=2304": route["K4"]},
             designs=MK_DESIGNS, **k4),
        dict(name="fused_mha_bwd", route="cuda",
             source=f"{PKG}/csrc/fused_mha_bwd.cu",
             units=[f"{PKG}/csrc/fused_mha_bwd_stream.cu"],
             replaces=tpu + "ops/attention.py:114",
             launches=train["f32"]["K5"],
             launches_by_path={training_f32: train["f32"]["K5"]},
             **k5["float32"]),
        dict(name="fused_mha_bwd_bf16", route="cuda",
             source=f"{PKG}/csrc/fused_mha_bwd.cu",
             units=[f"{PKG}/csrc/fused_mha_bwd_stream.cu"],
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
    # phase 19's paths: rank 0 of the two ranks at model=2 on one card; K6's
    # two entries for a sharded codebook launch only there
    tp_paths = {
        "codebook_stats": "phase 19: rank 0 of 2 at model=2 on cuda:0, K6's "
                          "sharded lookup (N=16384, 2048 codes a rank)",
        "stage1": "phase 19: rank 0 of 2 at model=2, a stage-1 step "
                  "(vqvae_ucf.sh, B=64) and 3 timed",
        "stage2": "phase 19: rank 0 of 2 at model=2, TRAIN_STEP2 steps "
                  "(ddiff_ucf.sh, B=16, f32 denoiser)",
        "stage2_bf16": "phase 19: rank 0 of 2 at model=2, TRAIN_STEP2 steps "
                       "(bf16 denoiser)"}
    for name, kid in (("nearest_code_dist", "K6 dist"),
                      ("code_stats", "K6 stats")):
        by_path = {path: tp["ranks"][case][kid]
                   for case, path in tp_paths.items()
                   if tp["ranks"][case][kid]}
        kernels.append(dict(
            name=name, route="cuda",
            source=f"{PKG}/csrc/nearest_code_stats.cu",
            replaces=tpu + "ops/codebook_kernel.py:95",
            launches=sum(by_path.values()), launches_by_path=by_path,
            **tp["entries"][name]))
    # phase 20's paths: VQ-Diffusion-B's width sampled (f32 denoiser) and
    # trained through tasks.train (bf16 and f32); and the head widths each
    # attention kernel took at its launches in this process (every phase,
    # the checks against the plain versions included)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        fused_mha, fused_mha_bwd)
    vqd_sample = ("phase 20: VQD_B (n_embd 1024, heads of 64) sampled, "
                  "model route, 4 clips, 100 steps")
    vqd_sample_mk = ("phase 20: VQD_B (n_embd 1024, heads of 64) sampled "
                     "on auto (the megakernel route), 4 clips, 100 steps")
    vqd_train = ("phase 20: tasks.train at ddiff_ucf.sh + VQD_B, B=16, {} "
                 "denoiser")
    vqd_runs = {
        "fused_sample_step": [(vqd_sample, widths["sampling"]["K1"])],
        "fused_mha_fwd": [(vqd_sample, widths["sampling"]["K2"]),
                          (vqd_train.format("f32"),
                           widths["train"]["float32"]["K2"])],
        "fused_mha_fwd_bf16": [(vqd_train.format("bf16"),
                                widths["train"]["bfloat16"]["K2"])],
        "fused_mha_bwd": [(vqd_train.format("f32"),
                           widths["train"]["float32"]["K5"])],
        "fused_mha_bwd_bf16": [(vqd_train.format("bf16"),
                                widths["train"]["bfloat16"]["K5"])],
        "nearest_code_stats": [
            (vqd_train.format(n), widths["train"][dt]["K6"])
            for n, dt in (("f32", "float32"), ("bf16", "bfloat16"))],
        "megakernel_step_packed": [(vqd_sample_mk,
                                    widths["sampling"]["K3"])]}
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        tma_refused)
    for kernel in kernels:
        for path, n in vqd_runs.get(kernel["name"], ()):
            kernel["launches_by_path"][path] = n
            kernel["launches"] += n
        for kid, base in (("K2", "fused_mha_fwd"), ("K5", "fused_mha_bwd")):
            for dt in ("float32", "bfloat16"):
                suffix = "" if dt == "float32" else "_bf16"
                if kernel["name"] != base + suffix:
                    continue
                kernel["launches_by_head_dim"] = _head_dim_launches(
                    (fused_mha_bwd if kid == "K5" else fused_mha)
                    .by_head_dim, dt, kernel["name"])
                kernel["launches_by_design"] = _design_launches(
                    kernel["launches_by_head_dim"])
                kernel["tma_refused"] = tma_refused()[kid][0]
                kernel["by_head_dim"] = {
                    str(d): dict(row[f"{kid} self"],
                                 max_abs_err=row["max_abs_err"],
                                 cross_ms=row[f"{kid} cross"]["ms"],
                                 cross77_ms=row[f"{kid} cross77"]["ms"])
                    for rows in (widths["kernels"], wide["attention"])
                    for (d, name), row in rows.items() if name == dt}
                missing = {str(d) for d in P22_HEAD_DIMS} - set(
                    kernel["launches_by_head_dim"])
                if missing:
                    raise AssertionError(f"{kernel['name']} launched at no "
                                         f"head dim {sorted(missing)}")
    # phase 21's paths: the honest configuration at n_embd 64 in heads of 8
    # on the route auto takes; the launches of this process by width (every
    # phase, the checks included); phase 21 (b)'s numbers at each
    # full-width configuration
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.megakernel import (
        megakernel_step)
    d8_route = ("phase 21: HONEST at n_embd 64 in heads of 8, auto route, "
                f"{MK_ROUTE_CLIPS} clips, 100 steps")
    for kernel in kernels:
        kid = by_kernel.get(kernel["name"])
        if kid not in ("K3", "K4"):
            continue
        if kid == "K3":
            kernel["launches_by_path"][d8_route] = mk_widths["route"]["K3"]
            kernel["launches"] += mk_widths["route"]["K3"]
        kernel["launches_by_width"] = {
            f"{c}x{c // d}": n for (c, d, k), n in sorted(
                megakernel_step.launches_by_width.items()) if k == kid}
        kernel["by_width"] = {w: row[kid]
                              for w, row in mk_widths["full"].items()}
        missing = {f"{c}x{h}" for c, h in MK_WIDTHS} - set(
            kernel["launches_by_width"])
        if missing:
            raise AssertionError(f"{kid} launched at no width "
                                 f"{sorted(missing)}")
    # phase 22's paths: WIDE_DOMAIN trained and sampled, the honest width
    # over its 16384 codes; each kernel's launches by its new shape axis in
    # this process (every phase, the checks included) and phase 22 (b)'s
    # numbers at the new shapes
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
        import code_stats, nearest_code_dist, nearest_code_stats
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import fused_sample_step
    wd_train = ("phase 22: WIDE_DOMAIN {} through tasks.train ({} at B={}, "
                "16384 codes of dim 512)")
    wd1 = wd_train.format("stage 1", "vqvae_ucf.sh", 64)
    wd2 = wd_train.format("stage 2", "ddiff_ucf.sh, n_embd 512 in heads of "
                          "256, bf16", 16)
    wd_sample = ("phase 22: WIDE_DOMAIN sampled through generate, "
                 "trainer.sampler=model, 8 clips, 100 steps")
    wd_auto = ("phase 22: WIDE_DOMAIN sampled through generate, auto "
               "(megakernel route, n_embd 512 in heads of 256), 8 clips, "
               "100 steps")
    wd_k3 = ("phase 22: HONEST over 16384 codes, auto route, "
             f"{WIDE_DOMAIN_K3_CLIPS} clips, 100 steps")
    tw = wide["train"]
    wide_runs = {
        "fused_sample_step": [(wd_sample, wide["sampling"]["model"]["K1"])],
        "fused_mha_fwd_bf16": [(wd2, tw["stage2"]["K2"]),
                               (wd_sample, wide["sampling"]["model"]["K2"])],
        "fused_mha_bwd_bf16": [(wd2, tw["stage2"]["K5"])],
        "nearest_code_stats": [(wd1, tw["stage1"]["K6"]),
                               (wd2, tw["stage2"]["K6"])],
        "megakernel_step_packed": [
            (wd_k3, wide["k3"]["K3"]),
            (wd_auto, wide["sampling"]["megakernel"]["K3"])]}
    for kernel in kernels:
        name = kernel["name"]
        for path, n in wide_runs.get(name, ()):
            kernel["launches_by_path"][path] = n
            kernel["launches"] += n
        if name == "fused_sample_step":
            kernel["launches_by_classes"] = {
                str(kv): n for kv, n in sorted(
                    fused_sample_step.by_classes.items())}
            kernel["by_classes"] = wide["k1"]["by_classes"]
        for fn in (nearest_code_stats, nearest_code_dist, code_stats):
            if name == fn.__name__:
                kernel["launches_by_dim"] = {
                    str(d): n for d, n in sorted(fn.by_dim.items())}
        if name == "nearest_code_stats":
            kernel["by_shape"] = wide["k6"]["by_shape"]
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
          f" two ranks, NCCL, the sweep) {t_phase19 - t_phase18:.1f} s, "
          f"phase 19 (the reference's checkpoints, tensor parallelism) "
          f"{t_phase20 - t_phase19:.1f} s, phase 20 (every head width, "
          f"VQ-Diffusion-B's width) {t_phase21 - t_phase20:.1f} s, phase 21 "
          f"(the whole-step kernels at every width) "
          f"{t_phase22 - t_phase21:.1f} s, phase 22 (the rest of K1, K2, K5 "
          f"and K6's domain) {t_end - t_phase22:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
