"""Serving entry: conditioner -> 100-step D3PM sampling -> VQ-VAE decode.

The counterpart of the JAX package's stage-2 ``_sample_step`` and of
``bench.py: _build_models``. ``sampler`` picks the route, as the JAX
trainer's ``trainer.sampler`` does: ``"megakernel"`` (one whole-step kernel
launch per reverse step), ``"model"`` (the denoiser with fused attention,
then the fused sampler step) or ``"auto"`` (the megakernel on a CUDA device
for grids of at most 2304 tokens, a denoiser of the kernels' width and a
condition sequence; else the model route).

    models = build_models(HONEST, "cuda", torch.Generator().manual_seed(0))
    video = sample_videos(models, {"label": labels}, generator)  # (B,T,H,W,3)

As an entry, the counterpart of ``scripts/generate.py``: compose ``train``
with the given overrides, build the stage's trainer, load ``ckpt_path`` (a
run's ``checkpoints/`` directory), sample ``num_samples`` clips for the
first validation batch and write one GIF each into ``out_dir``:

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.generate \
        model=discrete_diffusion datamodule=synthetic \
        ckpt_path=<run>/checkpoints +num_samples=4 +out_dir=./samples

On more than one rank (``trainer.mesh.data``, as :mod:`.tasks`) each rank
samples its share of the ``num_samples`` clips and rank 0 writes them all.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping

import torch

from .models.discrete_diffusion import (DiscreteDiffusionModel,
                                        init_discrete_diffusion_,
                                        make_discrete_diffusion)
from .models.vqvae import VQVAE, init_vqvae_, make_vqvae
from .parallel.distributed import all_gather_rows, is_distributed
from .parallel.mesh import rank_generator

__all__ = ["HONEST", "MSRVTT_GRID", "GenerationModels", "build_models",
           "sample_token_grid", "sample_videos", "main"]

# bench.py's honest configuration: 16-frame 64px clips -> a (16, 8, 8) grid
# of 1024 tokens over 4096 codes (K = 4097 with the MASK class), a 19-layer
# n_embd-64 denoiser with 16 heads of dim 4, 100 steps at guidance 2, and
# UCF101's 101 action labels as the condition.
HONEST: dict[str, Any] = {
    "vqvae": {
        "embedding_dim": 128, "n_codes": 4096, "n_hiddens": 256,
        "n_res_layers": 2, "downsample": (1, 8, 8), "sequence_length": 16,
        "resolution": 64,
    },
    "generator": {
        "diffusion_model": {
            "diffusion_step": 100, "guidance_scale": 2.0,
            "transformer": {
                "n_layer": 19, "n_embd": 64, "n_head": 16,
                "condition_dim": 512, "content_spatial_size": (32, 32),
            },
        },
        "textencoder": {"mode": "label", "n_classes": 101, "dim": 512},
    },
}


# bench.py's ``msrvtt`` grid with the honest model: 16-frame 96px clips -> a
# (16, 12, 12) grid of 2304 tokens on a 48 x 48 positional grid (the largest
# grid the megakernel route serves; its batch is 8)
MSRVTT_GRID: dict[str, Any] = {
    "vqvae": dict(HONEST["vqvae"], resolution=96),
    "generator": {
        "diffusion_model": {
            "diffusion_step": 100, "guidance_scale": 2.0,
            "transformer": dict(
                HONEST["generator"]["diffusion_model"]["transformer"],
                content_spatial_size=(48, 48)),
        },
        "textencoder": HONEST["generator"]["textencoder"],
    },
}


@dataclass
class GenerationModels:
    generator: DiscreteDiffusionModel
    vqvae: VQVAE

    @property
    def latent_shape(self) -> tuple[int, int, int]:
        return self.vqvae.latent_shape


def build_models(config: Mapping[str, Any], device: torch.device | str,
                 generator: torch.Generator) -> GenerationModels:
    """Build the conditioner, D3PM and VQ-VAE from ``config`` (shaped like
    :data:`HONEST`), initialise them on the CPU from the CPU ``generator``
    with the JAX package's init laws, and move them to ``device`` in eval
    mode. The modules are made on the meta device first, so nothing draws
    from the global RNG."""
    with torch.device("meta"):
        vqvae = make_vqvae(config["vqvae"])
        gen = make_discrete_diffusion(config, int(config["vqvae"]["n_codes"]),
                                      vqvae.latent_shape)
    vqvae = vqvae.to_empty(device="cpu")
    gen = gen.to_empty(device="cpu")
    init_discrete_diffusion_(gen, generator)
    init_vqvae_(vqvae, generator)
    return GenerationModels(generator=gen.to(device).eval(),
                            vqvae=vqvae.to(device).eval())


def _batch_size(batch: Mapping[str, Any]) -> int:
    if not batch:
        raise ValueError("the batch needs at least one per-clip entry "
                         "(e.g. 'label') to give its size")
    return len(next(iter(batch.values())))


@torch.no_grad()
def sample_token_grid(models: GenerationModels, batch: Mapping[str, Any],
                      generator: torch.Generator, sample: bool = True,
                      sampler: str = "auto") -> torch.Tensor:
    """Conditioner -> D3PM reverse process on the route ``sampler``.
    Returns (B, t, h, w) int64. In a process group ``batch`` holds this
    rank's rows: each rank samples them on its own stream
    (:func:`..parallel.mesh.rank_generator`, JAX's ``fold_in`` of the shard
    index), and the tokens of every rank are gathered in rank order, so
    every rank returns the global batch's grids (in argmax mode the
    one-rank run's, bit for bit)."""
    b = _batch_size(batch)
    if is_distributed():
        generator = rank_generator(generator)
    tokens = models.generator.sample(batch, b, generator=generator,
                                     sample=sample, mode=sampler)
    return all_gather_rows(tokens.reshape(b, *models.latent_shape))


@torch.no_grad()
def sample_videos(models: GenerationModels, batch: Mapping[str, Any],
                  generator: torch.Generator, sample: bool = True,
                  sampler: str = "auto") -> torch.Tensor:
    """Generate clips for a batch: returns (B, T, H, W, 3) f32."""
    return models.vqvae.decode(
        sample_token_grid(models, batch, generator, sample, sampler))


def main(argv: list[str] | None = None) -> int:
    """Checkpoint -> ``num_samples`` clips -> GIFs (module docstring)."""
    from .tasks import run_on_ranks
    from .utils.config import compose
    cfg = compose("train", sys.argv[1:] if argv is None else list(argv))
    return run_on_ranks(_generate, cfg)


def _generate(cfg: Mapping[str, Any]) -> int:
    import tempfile

    from .parallel.distributed import is_main_process
    from .parallel.mesh import shard_batch
    from .tasks import build_datamodule, build_trainer
    from .utils.checkpoint import CheckpointManager
    from .utils.logging import get_logger
    from .utils.renderer import render_animation

    log = get_logger("generate")
    num_samples = int(cfg.get("num_samples", 4))
    out_dir = Path(cfg.get("out_dir", "samples"))
    out_dir.mkdir(parents=True, exist_ok=True)

    dm = build_datamodule(cfg)
    batch = next(iter(dm.val_batches(0)))
    batch = {k: (v[:num_samples] if hasattr(v, "__getitem__") else v)
             for k, v in batch.items()}
    # the stage's trainer only builds, restores and samples: no metric
    # loggers, no FVD evaluator, and its run directory (the checkpoint
    # manager's) is a temporary one, so out_dir holds only the GIFs
    cfg = {**cfg, "logger": None,
           "model": {**cfg.get("model", {}), "do_evaluation": False}}
    with tempfile.TemporaryDirectory() as run_dir:
        trainer = build_trainer(cfg, dm, run_dir)
        trainer.build(batch)
    if is_distributed():
        batch = shard_batch(batch, trainer.mesh)
    if cfg.get("ckpt_path"):
        mgr = CheckpointManager(Path(str(cfg["ckpt_path"])), monitor=None)
        trainer.load_state_dict(mgr.restore(trainer.state_dict()))
        log.info("restored step %s from %s", mgr.latest_step(),
                 cfg["ckpt_path"])

    videos = trainer.sample_videos(
        batch, torch.Generator().manual_seed(int(cfg.get("seed") or 0)))
    if not is_main_process():
        return 0
    written = 0
    for i in range(videos.shape[0]):
        path = render_animation(videos[i], out_dir / f"sample_{i}.gif", fps=2)
        written += path is not None
        print(f"wrote {path}")
    print(f"generated {videos.shape[0]} clips; {written} GIFs written to "
          f"{out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
