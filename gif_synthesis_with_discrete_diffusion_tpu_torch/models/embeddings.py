"""Token-grid content embedding for the D3PM denoiser.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/embeddings.py``:
a ``(num_embed + 1)``-row table (+1 = the absorbing MASK token) plus
factorised height/width positional embeddings over a ``spatial_size`` grid,
sliced to the actual sequence length.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

__all__ = ["TokenGridEmbedding"]


class TokenGridEmbedding(nn.Module):
    """``trainable=False`` stops the gradient at the output, as the JAX
    module's ``stop_gradient``: the tables get none."""

    def __init__(self, num_embed: int, spatial_size: Sequence[int] = (32, 32),
                 embed_dim: int = 64, trainable: bool = True):
        super().__init__()
        self.trainable = trainable
        self.spatial_size = (int(spatial_size[0]), int(spatial_size[1]))
        h, w = self.spatial_size
        # num_embed is the codebook size; +1 row for the MASK token
        self.emb = nn.Embedding(num_embed + 1, embed_dim)
        self.height_emb = nn.Embedding(h, embed_dim)
        self.width_emb = nn.Embedding(w, embed_dim)

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        """index: (B, L) int -> (B, L, D)."""
        h, w = self.spatial_size
        if index.ndim != 2 or index.shape[1] > h * w:
            raise ValueError(
                f"token grid {tuple(index.shape)} exceeds the positional grid "
                f"{h}x{w}={h * w}; set spatial_size to cover the flattened "
                f"(T*H, W) latent grid")
        emb = self.emb(index.clamp_min(0))  # the reference clamps negatives
        pos = (self.height_emb.weight[:, None, :]
               + self.width_emb.weight[None, :, :]).reshape(1, h * w, -1)
        out = emb + pos[:, :index.shape[1], :]
        return out if self.trainable else out.detach()
