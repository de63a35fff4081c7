"""Conditioning encoders for the D3PM stage.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/conditioning.py``
for the ``null``, ``label`` and ``frame`` modes. Each conditioner takes the
batch dict and the batch size and returns ``(cond_emb, cf_cond_emb)``, the
conditional and classifier-free embeddings, each (B, 1, dim).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

__all__ = ["NullConditioner", "LabelConditioner", "FrameConditioner",
           "build_conditioner", "init_conditioner_"]


class NullConditioner(nn.Module):
    """Zeros: the committed reference behaviour."""

    def __init__(self, dim: int = 512):
        super().__init__()
        self.dim = dim
        # no parameters: this empty buffer carries the module's device
        self.register_buffer("_anchor", torch.empty(0), persistent=False)

    def forward(self, batch: Mapping[str, Any], batch_size: int):
        z = torch.zeros((batch_size, 1, self.dim), device=self._anchor.device)
        return z, z


class LabelConditioner(nn.Module):
    """Action-label embedding; index ``n_classes`` is the CF-null row."""

    def __init__(self, n_classes: int, dim: int = 512):
        super().__init__()
        self.n_classes = n_classes
        self.label_emb = nn.Embedding(n_classes + 1, dim)

    def forward(self, batch: Mapping[str, Any], batch_size: int):
        w = self.label_emb.weight
        labels = torch.as_tensor(batch["label"]).to(w.device, torch.int64)
        cond = self.label_emb(labels)[:, None, :]
        null = w[self.n_classes].expand(batch_size, 1, -1)
        return cond, null


class FrameConditioner(nn.Module):
    """Start-frame feature (e.g. 2048-d ResNet features) -> condition."""

    def __init__(self, feature_dim: int, dim: int = 512):
        super().__init__()
        self.frame_proj = nn.Linear(feature_dim, dim)
        self.null_embed = nn.Parameter(torch.empty(1, 1, dim))

    def forward(self, batch: Mapping[str, Any], batch_size: int):
        w = self.frame_proj.weight
        feats = torch.as_tensor(batch["frame"]).to(w.device, torch.float32)
        cond = self.frame_proj(feats)[:, None, :]
        return cond, self.null_embed.expand_as(cond)


def build_conditioner(cfg: Mapping[str, Any] | None) -> nn.Module:
    """From a plain dict: ``mode`` (null | label | frame), ``dim``, and
    ``n_classes`` (label) or ``feature_dim`` (frame; flax infers it from the
    first batch, a torch module needs it up front)."""
    cfg = dict(cfg or {})
    mode = cfg.pop("mode", "null")
    dim = int(cfg.pop("dim", 512))
    if mode == "null":
        return NullConditioner(dim=dim)
    if mode == "label":
        return LabelConditioner(n_classes=int(cfg.get("n_classes", 2)),
                                dim=dim)
    if mode == "frame":
        return FrameConditioner(int(cfg.get("feature_dim", 2048)), dim=dim)
    if mode == "text":
        raise NotImplementedError(
            "text conditioning (CLIP) is not ported yet: ROADMAP queue 1, "
            "item 12 (CLIP text conditioning)")
    raise ValueError(f"unknown conditioning mode {mode!r}")


@torch.no_grad()
def init_conditioner_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init laws: N(0, 0.02) for the label table, the frame
    projection and the null embedding; zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Embedding, nn.Linear)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        if isinstance(m, FrameConditioner):
            m.null_embed.normal_(0.0, 0.02, generator=generator)
