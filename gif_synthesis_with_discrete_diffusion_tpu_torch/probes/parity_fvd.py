"""The FVD pipeline end to end on random weights: the port's counterpart of
``scripts/parity_fvd.py``'s smoke (sample -> decode -> I3D -> Fréchet).

Every model is seeded random init: the reference's pretrained VQ-VAE,
D3PM and Kinetics-400 I3D are not in the repository, so the number is a
pipeline smoke, not comparable to a published FVD, and the JSON says so.
The clips come from the synthetic datamodule (its validation split), the
condition is zero (the committed reference's), the sampler route is
``auto`` (on the card the whole-step kernels where the denoiser fits them).

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.parity_fvd \\
        [--num-clips 64] [--batch 16] [--frames 16] [--resolution 64] \\
        [--codes 4096] ... [--device cuda|cpu]

Prints progress on stderr and one JSON line on stdout: ``fvd``,
``num_clips``, ``pretrained_weights`` (false), ``note``, ``device``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from ..data.preprocess import preprocess_clip
from ..data.synthetic import SyntheticVideoDataModule
from ..eval.evaluator import FVDEvaluator
from ..generate import build_models

__all__ = ["main"]


def _config(args) -> dict:
    """The model configuration of the arguments, shaped like
    :data:`..generate.HONEST`, with the zero (``null``) condition."""
    return {
        "vqvae": {"embedding_dim": args.embedding_dim,
                  "n_codes": args.codes, "n_hiddens": args.hiddens,
                  "n_res_layers": args.res_layers,
                  "downsample": tuple(args.downsample),
                  "sequence_length": args.frames,
                  "resolution": args.resolution},
        "generator": {
            "diffusion_model": {
                "diffusion_step": args.steps,
                "guidance_scale": args.guidance,
                "transformer": {"n_layer": args.layers, "n_embd": args.embd,
                                "n_head": args.heads,
                                "condition_dim": args.cond_dim}},
            "textencoder": {"mode": "null", "dim": args.cond_dim}},
    }


def main(argv: Optional[list[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num-clips", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--codes", type=int, default=4096)
    p.add_argument("--embedding-dim", type=int, default=128)
    p.add_argument("--hiddens", type=int, default=256)
    p.add_argument("--res-layers", type=int, default=3)
    p.add_argument("--downsample", type=int, nargs=3, default=[1, 8, 8])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--guidance", type=float, default=2.0)
    p.add_argument("--layers", type=int, default=19)
    p.add_argument("--embd", type=int, default=64)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--cond-dim", type=int, default=512)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device: "
                           "torch.cuda.is_available() is False")

    models = build_models(_config(args), device,
                          torch.Generator().manual_seed(0))
    evaluator = FVDEvaluator(generator=torch.Generator().manual_seed(1),
                             device=device)
    dm = SyntheticVideoDataModule(
        batch_size=args.batch, sequence_length=args.frames,
        resolution=args.resolution, num_train=args.batch,
        num_val=max(args.num_clips, args.batch))
    g = torch.Generator().manual_seed(100)
    done = 0
    for batch in dm.val_batches(0):
        if done >= args.num_clips:
            break
        b = min(len(batch["video"]), args.num_clips - done)
        gt = preprocess_clip(torch.from_numpy(batch["video"][:b]).to(device),
                             args.resolution)
        with torch.no_grad():   # the null conditioner: a zero condition
            tokens = models.generator.sample({}, b, generator=g)
            videos = models.vqvae.decode(
                tokens.reshape(b, *models.latent_shape))
        evaluator.push_vals(gt, videos)
        done += b
        print(f"sampled {done}/{args.num_clips}", file=sys.stderr,
              flush=True)
    out = {"fvd": float(evaluator.evaluate_metrics()["fvd"]),
           "num_clips": done, "pretrained_weights": False,
           "note": "random-init weights on every model: a pipeline smoke "
                   "only, NOT comparable to a reference FVD",
           "device": str(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
