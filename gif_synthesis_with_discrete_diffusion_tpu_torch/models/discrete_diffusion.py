"""Stage-2 model: D3PM over VQ tokens with switchable conditioning.

Port of the sampling surface of ``gif_synthesis_with_discrete_diffusion_tpu/
models/discrete_diffusion.py``: :class:`D3PM` owns the denoiser transformer
and the schedule, :class:`DiscreteDiffusionModel` adds the conditioner, and
:func:`make_discrete_diffusion` builds both from the same nested dict as the
JAX package's YAML. Training (the loss, the Lt buffers) is not ported yet.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.sampler_kernel import sample_tokens
from . import d3pm
from .conditioning import build_conditioner, init_conditioner_
from .denoiser import DenoiserTransformer, init_denoiser_

__all__ = ["D3PM", "DiscreteDiffusionModel", "make_discrete_diffusion",
           "init_discrete_diffusion_"]


class D3PM(nn.Module):
    """Discrete diffusion over a token grid (sampling)."""

    def __init__(self, num_embed: int, content_seq_len: int = 1024,
                 spatial_size: Sequence[int] = (32, 32),
                 diffusion_step: int = 100, guidance_scale: float = 2.0,
                 n_layer: int = 19, n_embd: int = 64, n_head: int = 16,
                 condition_dim: int = 512, mlp_hidden_times: int = 4,
                 block_activate: str = "GELU2"):
        super().__init__()
        self.num_embed = num_embed            # codebook size WITHOUT mask
        self.content_seq_len = content_seq_len
        self.diffusion_step = diffusion_step
        self.guidance_scale = guidance_scale
        self.transformer = DenoiserTransformer(
            num_embed=num_embed, spatial_size=spatial_size, n_layer=n_layer,
            n_embd=n_embd, n_head=n_head, condition_dim=condition_dim,
            diffusion_step=diffusion_step, mlp_hidden_times=mlp_hidden_times,
            block_activate=block_activate)

    @property
    def num_classes(self) -> int:
        return self.num_embed + 1

    def schedule(self) -> d3pm.D3PMSchedule:
        return d3pm.make_schedule(self.diffusion_step, self.num_classes,
                                  device=self.transformer.to_logits.weight
                                  .device)

    @torch.no_grad()
    def sample(self, cond_emb: Optional[torch.Tensor],
               cf_cond_emb: Optional[torch.Tensor], batch_size: int, *,
               generator: torch.Generator, mode: str = "auto",
               sample: bool = True, filter_ratio: float = 0.0
               ) -> torch.Tensor:
        """(B, L) int64 tokens from the 100-step reverse process.

        mode 'auto': :func:`..ops.sampler_kernel.sample_tokens`, whose step
        launches the Triton kernel for CUDA tensors and runs its plain
        version for CPU tensors (:func:`.d3pm.sample_fused` is the plain
        oracle the tests hold it to). ``sample=False`` takes argmax in place
        of Gumbel-max. ``generator`` is a CPU generator (the per-step
        seeds)."""
        if mode == "reference" or filter_ratio != 0.0:
            raise NotImplementedError(
                "the log-onehot reference sampler and filter_ratio are not "
                "ported yet: ROADMAP queue 1, item 7")
        if mode != "auto":
            raise ValueError(f"unknown sampler mode {mode!r}")
        return sample_tokens(generator, self.schedule(), self.transformer,
                             cond_emb, cf_cond_emb, batch_size,
                             self.content_seq_len,
                             guidance_scale=self.guidance_scale,
                             sample=sample)


class DiscreteDiffusionModel(nn.Module):
    """Conditioner + D3PM."""

    def __init__(self, d3pm_cfg: Mapping[str, Any],
                 conditioner_cfg: Mapping[str, Any] | None = None):
        super().__init__()
        self.d3pm_cfg = dict(d3pm_cfg)
        self.conditioner = build_conditioner(conditioner_cfg)
        self.diffusion = D3PM(**self.d3pm_cfg)

    def conditioner_embeddings(self, batch: Mapping[str, Any],
                               batch_size: int):
        """(cond, cf_cond): the entry point for external samplers."""
        return self.conditioner(batch, batch_size)

    @torch.no_grad()
    def sample(self, batch: Mapping[str, Any], batch_size: int, *,
               generator: torch.Generator, sample: bool = True
               ) -> torch.Tensor:
        cond_emb, cf_cond_emb = self.conditioner_embeddings(batch,
                                                            batch_size)
        return self.diffusion.sample(cond_emb, cf_cond_emb, batch_size,
                                     generator=generator, sample=sample)


def make_discrete_diffusion(model_cfg: Mapping[str, Any], num_embed: int,
                            latent_shape: Sequence[int]
                            ) -> DiscreteDiffusionModel:
    """Build from a plain nested dict mirroring the JAX package's YAML
    (``generator.diffusion_model.transformer[.dalle]`` and
    ``generator.textencoder``)."""
    g = dict(model_cfg.get("generator", {}))
    dcfg = dict(g.get("diffusion_model", {}))
    tcfg = dict(dcfg.pop("transformer", {}))
    dalle = dict(tcfg.pop("dalle", {}))
    if dcfg.get("learnable_cf"):
        raise NotImplementedError(
            "the learnable CF embedding comes with stage-2 training: "
            "ROADMAP queue 1, item 10")
    t, h, w = latent_shape
    seq_len = int(tcfg.get("content_seq_len") or np.prod(latent_shape))
    spatial = (tcfg.get("content_spatial_size")
               or dalle.get("spatial_size") or [h * t, w])
    d3pm_cfg = dict(
        num_embed=int(dalle.get("num_embed") or num_embed),
        content_seq_len=seq_len,
        spatial_size=tuple(spatial),
        diffusion_step=int(dcfg.get("diffusion_step", 100)),
        guidance_scale=float(dcfg.get("guidance_scale", 2.0)),
        n_layer=int(tcfg.get("n_layer", 19)),
        n_embd=int(tcfg.get("n_embd", 64)),
        n_head=int(tcfg.get("n_head", 16)),
        condition_dim=int(tcfg.get("condition_dim", 512)),
        mlp_hidden_times=int(tcfg.get("mlp_hidden_times", 4)),
        block_activate=str(tcfg.get("block_activate", "GELU2")),
    )
    return DiscreteDiffusionModel(d3pm_cfg=d3pm_cfg,
                                  conditioner_cfg=g.get("textencoder"))


@torch.no_grad()
def init_discrete_diffusion_(model: DiscreteDiffusionModel,
                             generator: torch.Generator) -> None:
    """The JAX package's init laws (see :func:`.denoiser.init_denoiser_`,
    :func:`.conditioning.init_conditioner_`)."""
    init_conditioner_(model.conditioner, generator)
    init_denoiser_(model.diffusion.transformer, generator)
