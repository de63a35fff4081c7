"""Token-grid content embedding for the D3PM denoiser.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/embeddings.py``:
a ``(num_embed + 1)``-row table (+1 = the absorbing MASK token) plus
factorised height/width positional embeddings over a ``spatial_size`` grid,
sliced to the actual sequence length.

With its token table sharded by rows over the model group
(:func:`..parallel.mesh.shard_module_`, where the rows divide) each rank
looks up the tokens in its rows, zeros for the others, and the rows are
summed over the group: the one-rank lookup exactly.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.distributed import group_rank, model_group, reduce_from_group

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
        # the reference clamps negatives
        emb = self._lookup(index.clamp_min(0))
        pos = (self.height_emb.weight[:, None, :]
               + self.width_emb.weight[None, :, :]).reshape(1, h * w, -1)
        out = emb + pos[:, :index.shape[1], :]
        return out if self.trainable else out.detach()

    def _lookup(self, index: torch.Tensor) -> torch.Tensor:
        w = self.emb.weight
        if getattr(w, "tp_dim", None) is None:
            return self.emb(index)
        group = model_group()
        per = w.shape[0]
        local = index - group_rank(group) * per
        outside = (local < 0) | (local >= per)
        rows = F.embedding(local.clamp(0, per - 1), w)
        return reduce_from_group(rows.masked_fill(outside[..., None], 0.0),
                                 group)
