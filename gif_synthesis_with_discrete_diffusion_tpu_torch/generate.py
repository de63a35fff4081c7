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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch

from .models.discrete_diffusion import (DiscreteDiffusionModel,
                                        init_discrete_diffusion_,
                                        make_discrete_diffusion)
from .models.vqvae import VQVAE, init_vqvae_

__all__ = ["HONEST", "MSRVTT_GRID", "GenerationModels", "build_models",
           "sample_token_grid", "sample_videos"]

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
        vqvae = VQVAE(**dict(config["vqvae"]))
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
    Returns (B, t, h, w) int64."""
    b = _batch_size(batch)
    tokens = models.generator.sample(batch, b, generator=generator,
                                     sample=sample, mode=sampler)
    return tokens.reshape(b, *models.latent_shape)


@torch.no_grad()
def sample_videos(models: GenerationModels, batch: Mapping[str, Any],
                  generator: torch.Generator, sample: bool = True,
                  sampler: str = "auto") -> torch.Tensor:
    """Generate clips for a batch: returns (B, T, H, W, 3) f32."""
    return models.vqvae.decode(
        sample_token_grid(models, batch, generator, sample, sampler))
