"""The FVD pipeline end to end from the reference's checkpoints: the port's
counterpart of ``scripts/parity_fvd.py`` (sample -> decode -> I3D ->
Fréchet).

``--vqvae`` (the stage-1 Lightning ``.ckpt``), ``--d3pm`` (the stage-2
``.ckpt``) and ``--i3d`` (``i3d_pretrained_400.pt``) are read through the
converters (:mod:`..convert.torch_vqvae`, :mod:`..convert.torch_d3pm`,
:mod:`..convert.torch_i3d`); a model whose path is missing is seeded random
init, and then the number is a pipeline smoke, not comparable to a
published FVD, and the JSON says so. The public checkpoints are not in the
repository. The ground-truth clips come from UCF-101 under ``--data-root``
(its validation split), else from the synthetic datamodule; the condition
is zero (the committed reference's); the sampler route is ``auto`` (on the
card the whole-step kernels where the denoiser fits them).

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.parity_fvd \\
        [--vqvae v.ckpt] [--d3pm d.ckpt] [--i3d i3d.pt] [--data-root DIR] \\
        [--num-clips 64] [--batch 16] [--frames 16] [--resolution 64] \\
        [--codes 4096] ... [--device cuda|cpu]

Prints progress on stderr and one JSON line on stdout: ``fvd``,
``num_clips``, ``pretrained_weights``, ``note``, ``device``.
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

__all__ = ["main", "parser"]


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


def _gt_batches(args):
    """The ground-truth clips (uint8 batches): UCF-101's validation split
    under ``--data-root``, else the synthetic datamodule's."""
    if args.data_root:
        from ..data.video_dataset import UCF101DataModule
        dm = UCF101DataModule(data_folder=args.data_root,
                              batch_size=args.batch,
                              sequence_length=args.frames,
                              resolution=args.resolution,
                              platform=args.device)
    else:
        dm = SyntheticVideoDataModule(
            batch_size=args.batch, sequence_length=args.frames,
            resolution=args.resolution, num_train=args.batch,
            num_val=max(args.num_clips, args.batch))
    for batch in dm.val_batches(0):
        yield batch["video"]


def parser() -> argparse.ArgumentParser:
    """The arguments of :func:`main`, with their defaults."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--vqvae", default=None, help="stage-1 torch .ckpt")
    p.add_argument("--d3pm", default=None, help="stage-2 torch .ckpt")
    p.add_argument("--i3d", default=None, help="i3d_pretrained_400.pt")
    p.add_argument("--data-root", default=None, help="UCF101 root (GT "
                   "clips); synthetic clips when unset")
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
    return p


def main(argv: Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device: "
                           "torch.cuda.is_available() is False")

    models = build_models(_config(args), device,
                          torch.Generator().manual_seed(0))
    if args.vqvae:
        from ..convert.torch_vqvae import convert_vqvae_file
        models.vqvae.load_state_dict(convert_vqvae_file(
            args.vqvae, n_res_layers=args.res_layers))
    if args.d3pm:
        from ..convert.torch_d3pm import convert_d3pm_file
        sd = convert_d3pm_file(args.d3pm)
        missing, unexpected = models.generator.load_state_dict(
            sd, strict=False)
        missing = [k for k in missing if not k.startswith("conditioner.")
                   and not k.endswith(("diffusion_acc", "diffusion_keep",
                                       "lt_history", "lt_count"))]
        if missing or unexpected:
            raise ValueError(f"--d3pm {args.d3pm}: does not fit the model "
                             f"of the arguments (missing {missing}, "
                             f"unexpected {unexpected})")
    i3d_state = None
    if args.i3d:
        from ..convert.torch_i3d import convert_i3d_file
        i3d_state = convert_i3d_file(args.i3d)
    pretrained = bool(args.vqvae and args.d3pm and args.i3d)
    evaluator = FVDEvaluator(i3d_state=i3d_state,
                             generator=torch.Generator().manual_seed(1),
                             device=device)
    g = torch.Generator().manual_seed(100)
    done = 0
    for video in _gt_batches(args):
        if done >= args.num_clips:
            break
        b = min(len(video), args.num_clips - done)
        gt = preprocess_clip(torch.as_tensor(video[:b]).to(device),
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
           "num_clips": done, "pretrained_weights": pretrained,
           "note": (None if pretrained else
                    "random-init weights on one or more models: a pipeline "
                    "smoke only, NOT comparable to a reference FVD"),
           "device": str(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
