"""VideoGPT-style 3D-conv VQ-VAE: encode and decode, with a frozen codebook.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/vqvae.py`` with
BatchNorm in eval mode:

* encode: encoder (strided convs, attention residual blocks) ->
  ``pre_vq_conv`` -> codebook lookup (kernel K6,
  :func:`..ops.codebook_kernel.nearest_code_stats`) -> token grid;
* decode: codebook lookup -> ``post_vq_conv`` -> decoder (attention residual
  blocks, then transposed convs).

Tensors stay channels-last (B, T, H, W, C) as in the JAX package. The
codebook's training path (data-dependent init, EMA update, restarts) belongs
to stage-1 training and is not ported yet: ``train=True`` raises.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.codebook_kernel import nearest_code_stats
from ..ops.conv3d import SamePadConv3d, SamePadConvTranspose3d

__all__ = ["VQVAE", "Encoder", "Decoder", "Codebook", "AxialBlock",
           "AttentionResidualBlock", "AxialSelfAttention", "init_vqvae_"]

_STAGE1 = ("the codebook's training path (EMA update, init, restarts) comes "
           "with stage-1 training: ROADMAP queue 1, item 11")

_BN_EPS = 1e-5  # flax nn.BatchNorm's default, as torch's


class BatchNorm(nn.Module):
    """Channels-last BatchNorm with running statistics (eval mode only)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + _BN_EPS)
        return (x - self.running_mean) * scale + self.bias


class AxialSelfAttention(nn.Module):
    """Multi-head self-attention along ONE axis of (T, H, W): bias-free
    Q/K/V projections, then an output projection with bias."""

    def __init__(self, channels: int, n_head: int, axis: int):
        super().__init__()
        self.n_head = n_head
        self.axis = axis  # 1=T, 2=H, 3=W in (B, T, H, W, C)
        self.wq = nn.Linear(channels, channels, bias=False)
        self.wk = nn.Linear(channels, channels, bias=False)
        self.wv = nn.Linear(channels, channels, bias=False)
        self.fc = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        d_k = c // self.n_head

        def split(t):  # (B, T, H, W, C) -> (B, ..., L, nh, dk)
            t = torch.movedim(t, self.axis, -2)
            return t.reshape(*t.shape[:-1], self.n_head, d_k)

        qh, kh, vh = split(self.wq(x)), split(self.wk(x)), split(self.wv(x))
        scores = torch.einsum("...lhd,...mhd->...hlm", qh, kh) / math.sqrt(d_k)
        probs = torch.softmax(scores.float(), dim=-1).to(vh.dtype)
        out = torch.einsum("...hlm,...mhd->...lhd", probs, vh)
        out = torch.movedim(out.reshape(*out.shape[:-2], c), -2, self.axis)
        return self.fc(out)


class AxialBlock(nn.Module):
    """Sum of axial attentions along W, H, T."""

    def __init__(self, channels: int, n_head: int = 2):
        super().__init__()
        self.attn_w = AxialSelfAttention(channels, n_head, 3)
        self.attn_h = AxialSelfAttention(channels, n_head, 2)
        self.attn_t = AxialSelfAttention(channels, n_head, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attn_w(x) + self.attn_h(x) + self.attn_t(x)


class AttentionResidualBlock(nn.Module):
    """BN-ReLU conv bottleneck + axial attention, residual."""

    def __init__(self, n_hiddens: int):
        super().__init__()
        self.bn1 = BatchNorm(n_hiddens)
        self.conv1 = SamePadConv3d(n_hiddens, n_hiddens // 2, 3,
                                   use_bias=False)
        self.bn2 = BatchNorm(n_hiddens // 2)
        self.conv2 = SamePadConv3d(n_hiddens // 2, n_hiddens, 1,
                                   use_bias=False)
        self.bn3 = BatchNorm(n_hiddens)
        self.axial = AxialBlock(n_hiddens, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        return x + self.axial(F.relu(self.bn3(h)))


def _downsample_steps(downsample: Sequence[int]) -> list[tuple[int, int, int]]:
    """Per-layer strides for log2-factorised down/upsampling."""
    n = [int(math.log2(d)) for d in downsample]
    if any(2 ** k != d for k, d in zip(n, downsample)):
        raise ValueError(f"downsample must be powers of 2, got {downsample}")
    steps = []
    for _ in range(max(n)):
        steps.append(tuple(2 if k > 0 else 1 for k in n))
        n = [k - 1 for k in n]
    return steps


class Encoder(nn.Module):
    """Strided convs -> ``conv_last`` -> attention residual blocks ->
    BatchNorm -> ReLU; returns (B, t, h, w, n_hiddens)."""

    def __init__(self, n_hiddens: int, n_res_layers: int,
                 downsample: Sequence[int], in_channels: int = 3):
        super().__init__()
        self.n_res_layers = n_res_layers
        steps = _downsample_steps(downsample)
        self.n_down = len(steps)
        for i, stride in enumerate(steps):
            self.add_module(f"conv{i}", SamePadConv3d(
                in_channels if i == 0 else n_hiddens, n_hiddens, 4, stride))
        self.conv_last = SamePadConv3d(n_hiddens, n_hiddens, 3)
        for i in range(n_res_layers):
            self.add_module(f"res{i}", AttentionResidualBlock(n_hiddens))
        self.bn_out = BatchNorm(n_hiddens)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_down):
            h = F.relu(getattr(self, f"conv{i}")(h))
        h = self.conv_last(h)
        for i in range(self.n_res_layers):
            h = getattr(self, f"res{i}")(h)
        return F.relu(self.bn_out(h))


class Decoder(nn.Module):
    def __init__(self, n_hiddens: int, n_res_layers: int,
                 upsample: Sequence[int], out_channels: int = 3):
        super().__init__()
        self.n_res_layers = n_res_layers
        for i in range(n_res_layers):
            self.add_module(f"res{i}", AttentionResidualBlock(n_hiddens))
        self.bn_out = BatchNorm(n_hiddens)
        steps = _downsample_steps(upsample)
        self.n_up = len(steps)
        for i, stride in enumerate(steps):
            out_ch = out_channels if i == len(steps) - 1 else n_hiddens
            self.add_module(f"convt{i}", SamePadConvTranspose3d(
                n_hiddens, out_ch, 4, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_res_layers):
            h = getattr(self, f"res{i}")(h)
        h = F.relu(self.bn_out(h))
        for i in range(self.n_up):
            h = getattr(self, f"convt{i}")(h)
            if i < self.n_up - 1:
                h = F.relu(h)
        return h


class Codebook(nn.Module):
    """EMA vector-quantisation codebook; buffers named after the flax
    ``codebook`` collection: ``embeddings`` (K, D), ``ema_count`` (K,),
    ``ema_sum`` (K, D)."""

    def __init__(self, n_codes: int, embedding_dim: int,
                 commitment_cost: float = 0.25):
        super().__init__()
        self.n_codes = n_codes
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        self.register_buffer("embeddings",
                             torch.empty(n_codes, embedding_dim))
        self.register_buffer("ema_count", torch.empty(n_codes))
        self.register_buffer("ema_sum", torch.empty(n_codes, embedding_dim))

    def forward(self, z: torch.Tensor, *, train: bool = False) -> dict:
        """z: (B, t, h, w, D). Nearest-code lookup (kernel K6), the
        straight-through output and the codebook metrics; the JAX package's
        ``Codebook.__call__`` with ``train=False``."""
        if train:
            raise NotImplementedError(_STAGE1)
        d = self.embedding_dim
        if z.shape[-1] != d:
            raise ValueError(f"codebook: last dim {z.shape[-1]} != {d}")
        flat = z.reshape(-1, d).float().contiguous()
        indices, n_total, _ = nearest_code_stats(flat, self.embeddings)
        encodings = indices.reshape(z.shape[:-1])
        quantized = F.embedding(indices, self.embeddings).reshape(
            z.shape).to(z.dtype)
        commitment_loss = self.commitment_cost * torch.mean(
            torch.square(z - quantized.detach()))
        embeddings_st = z + (quantized - z).detach()   # straight-through
        avg_probs = n_total / torch.clamp(n_total.sum(), min=1.0)
        entropy = -torch.sum(avg_probs * torch.log(avg_probs + 1e-10))
        codebook_loss = torch.mean(torch.square(
            z.detach().float() - quantized.float()))
        return dict(embeddings=embeddings_st, encodings=encodings,
                    commitment_loss=commitment_loss,
                    perplexity=torch.exp(entropy), entropy=entropy,
                    codebook_loss=codebook_loss)

    def lookup(self, encodings: torch.Tensor) -> torch.Tensor:
        """Token ids -> embedding vectors."""
        return F.embedding(encodings, self.embeddings)


class VQVAE(nn.Module):
    """Two-sided VQ-VAE: video -> token grid -> video."""

    def __init__(self, embedding_dim: int = 128, n_codes: int = 4096,
                 n_hiddens: int = 256, n_res_layers: int = 3,
                 downsample: Sequence[int] = (1, 16, 16),
                 sequence_length: int = 4, resolution: int = 128):
        super().__init__()
        self.downsample = tuple(downsample)
        self.sequence_length = sequence_length
        self.resolution = resolution
        self.n_codes = n_codes
        self.encoder = Encoder(n_hiddens, n_res_layers, downsample)
        self.pre_vq_conv = SamePadConv3d(n_hiddens, embedding_dim, 1)
        self.decoder = Decoder(n_hiddens, n_res_layers, downsample, 3)
        self.post_vq_conv = SamePadConv3d(embedding_dim, n_hiddens, 1)
        self.codebook = Codebook(n_codes, embedding_dim)

    @property
    def latent_shape(self) -> tuple[int, int, int]:
        shape = (self.sequence_length, self.resolution, self.resolution)
        return tuple(s // d for s, d in zip(shape, self.downsample))

    def encode(self, x: torch.Tensor, *, include_embeddings: bool = False,
               train: bool = False):
        """video (B, T, H, W, 3) f32 -> encodings (B, t, h, w) int32, and
        with ``include_embeddings`` the straight-through embeddings too."""
        if train:
            raise NotImplementedError(_STAGE1)
        vq = self.codebook(self.pre_vq_conv(self.encoder(x)))
        if include_embeddings:
            return vq["encodings"], vq["embeddings"]
        return vq["encodings"]

    @torch.no_grad()
    def decode(self, encodings: torch.Tensor) -> torch.Tensor:
        """encodings: (B, t, h, w) int -> video (B, T, H, W, 3)."""
        h = self.codebook.lookup(encodings)
        return self.decoder(self.post_vq_conv(h))


@torch.no_grad()
def init_vqvae_(model: VQVAE, generator: torch.Generator) -> None:
    """The JAX package's init laws: fan-in uniform convs with zero biases,
    N(0, 1/sqrt(c)) axial projections with a zero output bias, unit
    BatchNorm (mean 0, var 1), an N(0, 1) codebook with zero EMA counts and
    its EMA sums equal to the embeddings."""
    for m in model.modules():
        if isinstance(m, (SamePadConv3d, SamePadConvTranspose3d)):
            lim = math.sqrt(3.0 / m.fan_in())
            m.weight.uniform_(-lim, lim, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, AxialSelfAttention):
            std = 1.0 / math.sqrt(m.wq.in_features)
            for lin in (m.wq, m.wk, m.wv, m.fc):
                lin.weight.normal_(0.0, std, generator=generator)
            m.fc.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, Codebook):
            m.embeddings.normal_(0.0, 1.0, generator=generator)
            m.ema_count.zero_()
            m.ema_sum.copy_(m.embeddings)
