"""D3PM denoiser transformer (the reference's ``Text2ImageTransformer``).

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/denoiser.py``:
``n_layer`` blocks of AdaLayerNorm(timestep) -> self-attention ->
AdaLayerNorm -> cross-attention over the condition sequence -> LayerNorm ->
GELU2 MLP, then LayerNorm + Linear to ``num_embed`` logits (the MASK class
has none). Submodules carry the flax scope names (``content_emb``,
``block{i}.ln1.linear``, ``block{i}.attn1.query``, ``ln_out``,
``to_logits``), so the weight bridge is a mechanical map.

Both attentions go through :func:`..ops.attention.fused_mha`, which picks
the CUDA kernel or the plain version by the tensors' device. LayerNorms use
flax's epsilon 1e-6; the non-GELU2 activation is the tanh-approximated GELU
of ``jax.nn.gelu``. No dropout (ROADMAP finding F10: the JAX package
cannot train with it; :mod:`.discrete_diffusion` raises at a training step).

``checkpoint=True`` is the JAX package's ``remat`` (``nn.remat(Block)``):
under autograd each block runs inside
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, which keeps
only the block's inputs and runs its forward again in the backward, so the
attention kernel K2 launches twice for each K5. The forward and the
gradients are those without it.

``dtype`` is the JAX module's compute dtype: every dense layer of the blocks
(the AdaLN projections, Q / K / V / proj, the MLP) computes in it on f32
parameters (:class:`.layers.Dense`), so under bf16 both attentions get bf16
q, k and v (the bf16 entry points of K2 and K5). The token embedding, the
condition, every LayerNorm and ``to_logits`` stay f32, and each residual
add ``x + a`` promotes the stream back to f32, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import fused_mha
from .embeddings import TokenGridEmbedding
from .layers import Dense

__all__ = ["DenoiserTransformer", "Block", "AdaLayerNorm", "SinusoidalPosEmb",
           "gelu2", "init_denoiser_"]

_LN_EPS = 1e-6  # flax nn.LayerNorm's default


def gelu2(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) (the reference's GELU2)."""
    return x * torch.sigmoid(1.702 * x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class SinusoidalPosEmb(nn.Module):
    """Timestep embedding."""

    def __init__(self, num_steps: int, dim: int, rescale_steps: int = 4000):
        super().__init__()
        self.num_steps = num_steps
        self.dim = dim
        self.rescale_steps = rescale_steps

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = t.float() / self.num_steps * self.rescale_steps
        half_dim = self.dim // 2
        emb = math.log(10000) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                     device=t.device) * -emb)
        emb = x[:, None] * emb[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class AdaLayerNorm(nn.Module):
    """LayerNorm modulated by the diffusion timestep ('adalayernorm_abs')."""

    def __init__(self, n_embd: int, diffusion_step: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.emb = SinusoidalPosEmb(diffusion_step, n_embd)
        self.linear = Dense(n_embd, 2 * n_embd, dtype=dtype)
        self.norm = nn.LayerNorm(n_embd, eps=_LN_EPS,
                                 elementwise_affine=False)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor) -> torch.Tensor:
        emb = self.linear(F.silu(self.emb(timestep)))[:, None, :]
        scale, shift = emb.chunk(2, dim=2)
        return self.norm(x) * (1 + scale) + shift


class SelfAttention(nn.Module):
    """Non-causal multi-head self-attention."""

    def __init__(self, n_embd: int, n_head: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head = n_head
        self.key = Dense(n_embd, n_embd, dtype=dtype)
        self.query = Dense(n_embd, n_embd, dtype=dtype)
        self.value = Dense(n_embd, n_embd, dtype=dtype)
        self.proj = Dense(n_embd, n_embd, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = fused_mha(self.query(x), self.key(x), self.value(x),
                      n_head=self.n_head)
        return self.proj(y)


class CrossAttention(nn.Module):
    """Queries from the content, keys/values from the condition sequence."""

    def __init__(self, n_embd: int, n_head: int, condition_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head = n_head
        self.key = Dense(condition_dim, n_embd, dtype=dtype)
        self.value = Dense(condition_dim, n_embd, dtype=dtype)
        self.query = Dense(n_embd, n_embd, dtype=dtype)
        self.proj = Dense(n_embd, n_embd, dtype=dtype)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        y = fused_mha(self.query(x), self.key(cond), self.value(cond),
                      n_head=self.n_head)
        return self.proj(y)


class Block(nn.Module):
    """selfcross transformer block."""

    def __init__(self, n_embd: int, n_head: int, diffusion_step: int,
                 condition_dim: int, mlp_hidden_times: int = 4,
                 activate: str = "GELU2",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = AdaLayerNorm(n_embd, diffusion_step, dtype)
        self.attn1 = SelfAttention(n_embd, n_head, dtype)
        self.ln1_1 = AdaLayerNorm(n_embd, diffusion_step, dtype)
        self.attn2 = CrossAttention(n_embd, n_head, condition_dim, dtype)
        self.ln2 = nn.LayerNorm(n_embd, eps=_LN_EPS)
        self.mlp_fc = Dense(n_embd, mlp_hidden_times * n_embd, dtype=dtype)
        self.mlp_proj = Dense(mlp_hidden_times * n_embd, n_embd, dtype=dtype)
        self.act = gelu2 if activate == "GELU2" else _gelu_tanh

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                timestep: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.ln1(x, timestep))
        x = x + self.attn2(self.ln1_1(x, timestep), cond)
        h = self.mlp_proj(self.act(self.mlp_fc(self.ln2(x))))
        return x + h


class DenoiserTransformer(nn.Module):
    """Condition -> token-grid denoiser.

    ``forward(tokens (B, L), cond (B, S, condition_dim) | None, t (B,))``
    returns f32 logits (B, num_embed, L), whatever the compute ``dtype``: a
    transposed view of the (B, L, num_embed) product, which the sampler
    kernel reads with its strides.
    """

    def __init__(self, num_embed: int, spatial_size: Sequence[int] = (32, 32),
                 n_layer: int = 19, n_embd: int = 64, n_head: int = 16,
                 condition_dim: int = 512, diffusion_step: int = 100,
                 mlp_hidden_times: int = 4, block_activate: str = "GELU2",
                 dtype: torch.dtype = torch.float32,
                 checkpoint: bool = False):
        super().__init__()
        self.n_layer = n_layer
        self.checkpoint = checkpoint
        self.condition_dim = condition_dim
        self.compute_dtype = dtype
        self.content_emb = TokenGridEmbedding(num_embed, spatial_size, n_embd)
        for i in range(n_layer):
            self.add_module(f"block{i}", Block(
                n_embd, n_head, diffusion_step, condition_dim,
                mlp_hidden_times, block_activate, dtype))
        self.ln_out = nn.LayerNorm(n_embd, eps=_LN_EPS)
        self.to_logits = nn.Linear(n_embd, num_embed)

    def forward(self, tokens: torch.Tensor, cond: Optional[torch.Tensor],
                t: torch.Tensor) -> torch.Tensor:
        emb = self.content_emb(tokens)
        if cond is None:
            cond = emb.new_zeros((tokens.shape[0], 1, self.condition_dim))
        cond = cond.to(emb.dtype)
        remat = self.checkpoint and torch.is_grad_enabled()
        for i in range(self.n_layer):
            block = getattr(self, f"block{i}")
            if remat:
                emb = torch.utils.checkpoint.checkpoint(
                    block, emb, cond, t, use_reentrant=False)
            else:
                emb = block(emb, cond, t)
        logits = self.to_logits(self.ln_out(emb))   # (B, L, K-1)
        return logits.transpose(1, 2)               # (B, K-1, L) view


@torch.no_grad()
def init_denoiser_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init laws: N(0, 0.02) for every Linear and
    Embedding weight, zero biases, unit LayerNorm scales."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm) and m.elementwise_affine:
            m.weight.fill_(1.0)
            m.bias.zero_()
