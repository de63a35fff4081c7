"""The bf16-weight drift of the whole-step sampler against the true-f32
posterior, per reverse step, coupled: the protocol of the JAX package's
``scripts/measure_drift.py`` (its ``coupled_per_step`` section), on the
port.

At every reverse step both sides see the same tokens and the same uniforms:

* side A: ``models/d3pm.py: sample_fused``'s posterior in f32 (the denoiser
  with f32 weights, TF32 off; on a CUDA device its attention is K2 in f32,
  whose products split f32 into TF32 hi + lo and are never rounded);
* side B: ``ops/megakernel.py: megakernel_step_reference`` with the weights
  packed in bf16 (the whole-step kernels' numerics);

both draw their token by Gumbel-max with the shared noise, and the
trajectory follows side A. Per step: the token flip rate, |delta log p|
and the total variation of the two posteriors; over the steps run, the
five statistics that ``tests/test_drift_bounds.py`` bounds. On a CUDA
device the kernel (K3 up to 1024 tokens, K4 beyond) also takes each step's
tokens in argmax mode, and its tokens are held against side B's argmax
wherever side B's top-two margin exceeds ``chip_smoke.MK_MARGIN``.

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.drift_probe \\
        --config honest --batch 8 [--steps N] [--seed S] [--out FILE.json]

``--steps N`` runs the first N of the 100 reverse steps; ``--out`` merges
the run into FILE.json under ``sections[<config>_seed<S>]``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Any, Mapping

import torch

from ..generate import HONEST, MSRVTT_GRID, build_models
from ..models.d3pm import (_analytic_posterior, _cfg_batch,
                           _guided_log_x_recon, gumbel)
from ..ops.megakernel import (megakernel_step, megakernel_step_reference,
                              prepare_sampling)

CONFIGS = {"honest": HONEST, "msrvtt": MSRVTT_GRID}
# the kernel's tokens are compared where side B's top-two margin exceeds
# this (chip_smoke.MK_MARGIN: f32 sums in another order)
KERNEL_MARGIN = 1e-2


@torch.no_grad()
def coupled_drift(config: Mapping[str, Any], *, batch: int, steps: int,
                  seed: int, device: str) -> dict:
    """Run ``steps`` coupled reverse steps of ``config``'s model (weights
    from seed 0, labels and uniforms from ``seed``) on ``device``; return
    the statistics and, on a CUDA device, the kernel's agreement."""
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    models = build_models(config, device, torch.Generator().manual_seed(0))
    gen = models.generator
    d = gen.diffusion
    sched = d.schedule()
    T, K, L = sched.num_timesteps, sched.num_classes, d.content_seq_len
    steps = min(steps, T)
    g = torch.Generator().manual_seed(seed)
    g_dev = torch.Generator(device=device).manual_seed(seed)
    n_classes = int(config["generator"]["textencoder"]["n_classes"])
    labels = torch.randint(0, n_classes, (batch,), generator=g)
    cond, cf_cond = gen.conditioner_embeddings({"label": labels.to(device)},
                                               batch)
    guidance = d.guidance_scale
    use_cfg = abs(guidance - 1.0) >= 1e-3
    cond2 = _cfg_batch(cond, cf_cond, use_cfg)
    tab, kw = prepare_sampling(sched, d.transformer, cond, cf_cond, batch, L,
                               guidance_scale=guidance,
                               weights_dtype=torch.bfloat16)
    ref_kw = {k: v for k, v in kw.items() if k != "pack_cfg"}
    tokens = torch.full((batch, L), K - 1, dtype=torch.long, device=device)
    rows, decided, wrong = [], 0, 0
    t0 = time.perf_counter()
    for i, t in enumerate(range(T - 1, T - 1 - steps, -1)):
        nb = cond2.shape[0]
        x2 = torch.cat([tokens, tokens]) if use_cfg else tokens
        t2 = torch.full((nb,), t, dtype=torch.long, device=device)
        logits2 = d.transformer(x2, cond2, t2)
        post_a = _analytic_posterior(
            sched, _guided_log_x_recon(logits2, guidance, batch), tokens, t)
        args = (tab["packed"], tokens, tab["adaln_all"][i], tab["kc"],
                tab["vc"], tab["pos"], tab["rows"][t], 0)
        post_b = megakernel_step_reference(*args, sample=False,
                                           return_posterior=True,
                                           **ref_kw)[1]
        if device == "cuda":
            tok_k = megakernel_step(*args, sample=False,
                                    scratch=tab["scratch"], **kw)
            top2 = post_b.topk(2, dim=1).values
            sure = (top2[:, 0] - top2[:, 1]) > KERNEL_MARGIN
            decided += int(sure.sum())
            wrong += int(((tok_k != post_b.argmax(dim=1)) & sure).sum())
        noise = gumbel(torch.rand((batch, K, L), generator=g_dev,
                                  device=device))
        tok_a = torch.argmax(post_a + noise, dim=1)
        tok_b = torch.argmax(post_b + noise, dim=1)
        pa, pb = post_a.double(), post_b.double()
        diff = (pa - pb).abs()
        tv = 0.5 * (pa.exp() - pb.exp()).abs().sum(dim=1)
        rows.append([float((tok_a != tok_b).double().mean()),
                     float(diff.max()), float(diff.mean()),
                     float(tv.mean()), float(tv.max())])
        tokens = tok_a
    seconds = time.perf_counter() - t0
    flip, dmax, dmean, tv_mean, tv_max = (torch.tensor(c, dtype=torch.float64)
                                          for c in zip(*rows))
    out = {
        "config": {"tokens": L, "classes": K, "steps_run": steps,
                   "steps": T, "layers": d.transformer.n_layer,
                   "guidance": guidance, "batch": batch, "seed": seed,
                   "device": (torch.cuda.get_device_name(0)
                              if device == "cuda" else "cpu"),
                   "kernel": ("K3" if kw["pack_cfg"] else "K4")
                   if device == "cuda" else None},
        "coupled_per_step": {
            "token_flip_rate_mean": float(flip.mean()),
            "token_flip_rate_max": float(flip.max()),
            "abs_dlogp_max": float(dmax.max()),
            "abs_dlogp_mean": float(dmean.mean()),
            "tv_mean": float(tv_mean.mean()),
            "tv_max": float(tv_max.max()),
        },
        "seconds": seconds,
    }
    if device == "cuda":
        out["kernel_vs_side_b"] = {"decided_positions": decided,
                                   "token_mismatches": wrong,
                                   "margin": KERNEL_MARGIN}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="honest")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("drift_probe measures on a CUDA device")
    result = coupled_drift(CONFIGS[args.config], batch=args.batch,
                           steps=args.steps, seed=args.seed, device="cuda")
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    name = f"{args.config}_seed{args.seed}"
    print(json.dumps({name: result}))
    if args.out:
        artifact = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                artifact = json.load(f)
        artifact.setdefault("sections", {})[name] = result
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
