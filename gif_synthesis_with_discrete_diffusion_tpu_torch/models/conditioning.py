"""Conditioning encoders for the D3PM stage.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/conditioning.py``:
the ``null``, ``label``, ``frame`` and ``text`` (the frozen CLIP text tower,
:mod:`.clip_text`) modes. Each conditioner takes the batch dict and the
batch size and returns ``(cond_emb, cf_cond_emb)``, the conditional and
classifier-free embeddings, each (B, 1, dim); with ``with_cf=False`` (the
training loss reads only the first) the second is None and not computed.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from .clip_text import ClipTextConditioner, init_clip_text_

__all__ = ["NullConditioner", "LabelConditioner", "FrameConditioner",
           "build_conditioner", "init_conditioner_"]


class NullConditioner(nn.Module):
    """Zeros: the committed reference behaviour."""

    def __init__(self, dim: int = 512):
        super().__init__()
        self.dim = dim
        # no parameters: this empty buffer carries the module's device
        self.register_buffer("_anchor", torch.empty(0), persistent=False)

    def forward(self, batch: Mapping[str, Any], batch_size: int, *,
                with_cf: bool = True):
        z = torch.zeros((batch_size, 1, self.dim), device=self._anchor.device)
        return z, (z if with_cf else None)


class LabelConditioner(nn.Module):
    """Action-label embedding; index ``n_classes`` is the CF-null row."""

    def __init__(self, n_classes: int, dim: int = 512):
        super().__init__()
        self.n_classes = n_classes
        self.label_emb = nn.Embedding(n_classes + 1, dim)

    def forward(self, batch: Mapping[str, Any], batch_size: int, *,
                with_cf: bool = True):
        w = self.label_emb.weight
        labels = torch.as_tensor(batch["label"]).to(w.device, torch.int64)
        cond = self.label_emb(labels)[:, None, :]
        if not with_cf:
            return cond, None
        return cond, w[self.n_classes].expand(batch_size, 1, -1)


class FrameConditioner(nn.Module):
    """Start-frame feature (e.g. 2048-d ResNet features) -> condition."""

    def __init__(self, feature_dim: int, dim: int = 512):
        super().__init__()
        self.frame_proj = nn.Linear(feature_dim, dim)
        self.null_embed = nn.Parameter(torch.empty(1, 1, dim))

    def forward(self, batch: Mapping[str, Any], batch_size: int, *,
                with_cf: bool = True):
        w = self.frame_proj.weight
        feats = torch.as_tensor(batch["frame"]).to(w.device, torch.float32)
        cond = self.frame_proj(feats)[:, None, :]
        return cond, (self.null_embed.expand_as(cond) if with_cf else None)


def build_conditioner(cfg: Mapping[str, Any] | None) -> nn.Module:
    """From a plain dict: ``mode`` (null | label | frame | text), ``dim``,
    and ``n_classes`` (label), ``feature_dim`` (frame; flax infers it from
    the first batch, a torch module needs it up front) or the text tower's
    ``cf_tokens`` / ``freeze`` / ``width`` / ``heads`` / ``layers`` (text;
    ``bpe_path``, ``allow_hash_tokenizer`` and ``clip_ckpt`` belong to the
    trainer and are dropped here, as in the JAX package)."""
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
        for key in ("bpe_path", "allow_hash_tokenizer", "clip_ckpt"):
            cfg.pop(key, None)
        return ClipTextConditioner(dim=dim, **cfg)
    raise ValueError(f"unknown conditioning mode {mode!r}")


@torch.no_grad()
def init_conditioner_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init laws: N(0, 0.02) for the label table, the frame
    projection and the null embedding; zero biases; the CLIP tower's own
    (:func:`.clip_text.init_clip_text_`)."""
    if isinstance(module, ClipTextConditioner):
        init_clip_text_(module.clip, generator)
        return
    for m in module.modules():
        if isinstance(m, (nn.Embedding, nn.Linear)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        if isinstance(m, FrameConditioner):
            m.null_embed.normal_(0.0, 0.02, generator=generator)
