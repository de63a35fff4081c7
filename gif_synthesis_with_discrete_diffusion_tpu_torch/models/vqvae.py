"""VideoGPT-style 3D-conv VQ-VAE: encode, decode and the training forward.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/vqvae.py``:

* encode: encoder (strided convs, attention residual blocks) ->
  ``pre_vq_conv`` -> codebook lookup (kernel K6,
  :func:`..ops.codebook_kernel.nearest_code_stats`) -> token grid;
* decode: codebook lookup -> ``post_vq_conv`` -> decoder (attention residual
  blocks, then transposed convs);
* ``forward(batch, train=)``: encode -> straight-through -> decode with the
  reconstruction and commitment losses. With ``train=True`` BatchNorm
  normalises by the batch statistics and the codebook runs its training
  path (data-dependent init, EMA update, usage-gated restarts), both
  updating their buffers in place under ``torch.no_grad()`` and without a
  host synchronisation.

Tensors stay channels-last (B, T, H, W, C) as in the JAX package.

``dtype`` is the JAX ``VQVAE.dtype``: every conv, dense layer and BatchNorm
of the encoder, decoder and the two 1x1 convs computes in it on f32
parameters (BatchNorm's statistics and running averages in f32, its output
cast to the dtype; the axial attention's scores rounded to it before an f32
softmax). The codebook reads its input in f32 (K6 keeps f32 inputs), its
commitment loss and straight-through output are in the dtype, and the
codebook-fit and reconstruction losses in f32, as in the JAX package.

In a data-parallel run (a process group, :mod:`..parallel.distributed`)
each rank holds its rows of the global batch, and the model computes what
the JAX package computes on the global array under ``pjit``: BatchNorm in
training normalises by the global batch's statistics (its two sums
all-reduced, the all-reduce inside the autograd graph); the codebook's
statistics are summed over the ranks (:func:`..ops.codebook_kernel.
nearest_code_stats_sharded`), so the EMA update and the perplexity read the
global usage; and the data-dependent init and the restarts draw their
candidate rows from the global rows (gathered in rank order) with the same
generator on every rank, which leaves every rank with the same codebook.
Those collectives run over the data group
(:func:`..parallel.distributed.data_group`): under tensor parallelism the
model ranks of one replica hold the same rows.

Under tensor parallelism (:func:`..parallel.mesh.shard_module_`) the
codebook holds K / model codes: ``embeddings``, ``ema_sum`` and
``ema_count`` are this rank's rows. The init and the restarts draw the same
K candidates on every rank and keep this rank's; the lookup is K6 on the
local codes and the nearest over the model group
(:func:`..ops.codebook_kernel.nearest_code_stats_tp`); the statistics and
the EMA update are the local codes'; the straight-through output, the
perplexity and the EMA's total read the whole table and counts, gathered
over the model group.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.codebook_kernel import (nearest_code_stats,
                                   nearest_code_stats_reference,
                                   nearest_code_stats_sharded,
                                   nearest_code_stats_tp)
from ..ops.conv3d import SamePadConv3d, SamePadConvTranspose3d
from ..parallel.distributed import (all_gather, all_gather_rows,
                                    all_reduce_sum_grad, data_group,
                                    group_rank, group_size, model_group)
from .layers import Dense, compute_dtype

__all__ = ["VQVAE", "make_vqvae", "Encoder", "Decoder", "Codebook", "AxialBlock",
           "AttentionResidualBlock", "AxialSelfAttention", "init_vqvae_"]

_BN_EPS = 1e-5  # flax nn.BatchNorm's default, as torch's
_BN_MOMENTUM = 0.9


class _SplitFreeSum(torch.autograd.Function):
    """The f64 sum over every row of channels-last f32 ``x`` (..., C), the
    same whichever whole samples the batch holds. Each run of ``r`` rows
    (the largest power of two up to 16 that divides a sample's rows) is
    summed in f32 by one reduction whose order depends on ``r`` alone, not
    on the batch size, so a sample's runs sum alike in any batch; the runs,
    1/r of the data, are summed in f64, which rounds to the same f32
    statistics in any order. The backward is the sum's: the gradient,
    in f32, broadcast to every row."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.shape = x.shape
        c = x.shape[-1]
        r = 16
        while (x[0].numel() // c) % r:
            r //= 2
        return x.reshape(-1, r, c).sum(dim=1).sum(dim=0, dtype=torch.float64)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad.float().expand(ctx.shape)


_split_free_sum = _SplitFreeSum.apply


class BatchNorm(nn.Module):
    """Channels-last BatchNorm by flax's rule (``nn.BatchNorm(momentum=0.9)``).
    With ``train`` it normalises by the batch's mean and *biased* variance
    (f32, ``mean(x^2) - mean(x)^2``) and moves the running statistics towards
    them, ``running = 0.9 * running + 0.1 * batch``, the variance biased
    too (``torch.nn.BatchNorm3d`` would store the unbiased one). The two
    sums are taken in f32 over runs of a few rows within one sample, then
    in f64 over the runs, and round to f32 once (:class:`_SplitFreeSum`):
    the statistics then come out the same however the batch is split. In a
    process group the sums are all-reduced first, so every rank normalises
    by the global batch's statistics, the one-rank step's, and keeps the
    same running ones (``nn.SyncBatchNorm`` takes another variance and
    update)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Normalised in f32, the output in ``x``'s dtype."""
        if not train:
            scale = self.weight * torch.rsqrt(self.running_var + _BN_EPS)
            return ((x - self.running_mean) * scale + self.bias).to(x.dtype)
        xf = x.float()
        group = data_group()
        n = xf.numel() // xf.shape[-1] * group_size(group)
        sums = all_reduce_sum_grad(torch.stack(
            [_split_free_sum(xf), _split_free_sum(xf * xf)]), group)
        mean, sq = (sums[0] / n).float(), (sums[1] / n).float()
        var = torch.clamp(sq - mean * mean, min=0.0)
        with torch.no_grad():
            for running, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                running.mul_(_BN_MOMENTUM).add_(batch,
                                                alpha=1.0 - _BN_MOMENTUM)
        scale = self.weight * torch.rsqrt(var + _BN_EPS)
        return ((x - mean) * scale + self.bias).to(x.dtype)


class AxialSelfAttention(nn.Module):
    """Multi-head self-attention along ONE axis of (T, H, W): bias-free
    Q/K/V projections, then an output projection with bias."""

    def __init__(self, channels: int, n_head: int, axis: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head = n_head
        self.axis = axis  # 1=T, 2=H, 3=W in (B, T, H, W, C)
        self.wq = Dense(channels, channels, bias=False, dtype=dtype)
        self.wk = Dense(channels, channels, bias=False, dtype=dtype)
        self.wv = Dense(channels, channels, bias=False, dtype=dtype)
        self.fc = Dense(channels, channels, dtype=dtype)

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

    def __init__(self, channels: int, n_head: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn_w = AxialSelfAttention(channels, n_head, 3, dtype)
        self.attn_h = AxialSelfAttention(channels, n_head, 2, dtype)
        self.attn_t = AxialSelfAttention(channels, n_head, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attn_w(x) + self.attn_h(x) + self.attn_t(x)


class AttentionResidualBlock(nn.Module):
    """BN-ReLU conv bottleneck + axial attention, residual."""

    def __init__(self, n_hiddens: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn1 = BatchNorm(n_hiddens)
        self.conv1 = SamePadConv3d(n_hiddens, n_hiddens // 2, 3,
                                   use_bias=False, dtype=dtype)
        self.bn2 = BatchNorm(n_hiddens // 2)
        self.conv2 = SamePadConv3d(n_hiddens // 2, n_hiddens, 1,
                                   use_bias=False, dtype=dtype)
        self.bn3 = BatchNorm(n_hiddens)
        self.axial = AxialBlock(n_hiddens, 2, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.conv1(F.relu(self.bn1(x, train)))
        h = self.conv2(F.relu(self.bn2(h, train)))
        return x + self.axial(F.relu(self.bn3(h, train)))


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
                 downsample: Sequence[int], in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_res_layers = n_res_layers
        steps = _downsample_steps(downsample)
        self.n_down = len(steps)
        for i, stride in enumerate(steps):
            self.add_module(f"conv{i}", SamePadConv3d(
                in_channels if i == 0 else n_hiddens, n_hiddens, 4, stride,
                dtype=dtype))
        self.conv_last = SamePadConv3d(n_hiddens, n_hiddens, 3, dtype=dtype)
        for i in range(n_res_layers):
            self.add_module(f"res{i}",
                            AttentionResidualBlock(n_hiddens, dtype))
        self.bn_out = BatchNorm(n_hiddens)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        for i in range(self.n_down):
            h = F.relu(getattr(self, f"conv{i}")(h))
        h = self.conv_last(h)
        for i in range(self.n_res_layers):
            h = getattr(self, f"res{i}")(h, train)
        return F.relu(self.bn_out(h, train))


class Decoder(nn.Module):
    def __init__(self, n_hiddens: int, n_res_layers: int,
                 upsample: Sequence[int], out_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_res_layers = n_res_layers
        for i in range(n_res_layers):
            self.add_module(f"res{i}",
                            AttentionResidualBlock(n_hiddens, dtype))
        self.bn_out = BatchNorm(n_hiddens)
        steps = _downsample_steps(upsample)
        self.n_up = len(steps)
        for i, stride in enumerate(steps):
            out_ch = out_channels if i == len(steps) - 1 else n_hiddens
            self.add_module(f"convt{i}", SamePadConvTranspose3d(
                n_hiddens, out_ch, 4, stride, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        for i in range(self.n_res_layers):
            h = getattr(self, f"res{i}")(h, train)
        h = F.relu(self.bn_out(h, train))
        for i in range(self.n_up):
            h = getattr(self, f"convt{i}")(h)
            if i < self.n_up - 1:
                h = F.relu(h)
        return h


class Codebook(nn.Module):
    """EMA vector-quantisation codebook; buffers named after the flax
    ``codebook`` collection: ``embeddings`` (K, D), ``ema_count`` (K,),
    ``ema_sum`` (K, D), ``initialized`` () bool.

    Training (``train=True``), in the JAX package's order: data-dependent
    init on the first step -> lookup on the *current* embeddings ->
    commitment loss and straight-through output -> EMA update with Laplace
    smoothing -> usage-gated random restart.

    ``kernel_mode`` as the JAX package's: ``"xla"`` takes the plain lookup
    on every device; ``"auto"`` and ``"pallas"`` take the kernel (K6) on a
    CUDA device, the plain lookup on the CPU."""

    def __init__(self, n_codes: int, embedding_dim: int,
                 commitment_cost: float = 0.25, decay: float = 0.99,
                 kernel_mode: str = "auto"):
        super().__init__()
        if kernel_mode not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown kernel_mode {kernel_mode!r}")
        self.kernel_mode = kernel_mode
        self.n_codes = n_codes
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        self.decay = decay
        self.register_buffer("embeddings",
                             torch.empty(n_codes, embedding_dim))
        self.register_buffer("ema_count", torch.empty(n_codes))
        self.register_buffer("ema_sum", torch.empty(n_codes, embedding_dim))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool))

    def tile_rows(self, flat: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """``n_codes`` random candidate rows of ``flat`` (N, D) for the init
        and the restarts: with fewer rows than codes, ``flat`` is tiled and
        given noise of std ``0.01 / sqrt(D)`` first. ``generator`` lies on
        ``flat``'s device."""
        n, d = flat.shape
        if n < self.n_codes:
            flat = flat.repeat(-(-self.n_codes // n), 1)
            flat = flat + (0.01 / math.sqrt(d)) * torch.randn(
                flat.shape, generator=generator, device=flat.device,
                dtype=flat.dtype)
        perm = torch.randperm(flat.shape[0], generator=generator,
                              device=flat.device)
        return flat[perm[:self.n_codes]]

    def forward(self, z: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                init_rows: Optional[torch.Tensor] = None,
                restart_rows: Optional[torch.Tensor] = None) -> dict:
        """z: (B, t, h, w, D). Nearest-code lookup (kernel K6), the
        straight-through output and the codebook metrics; the JAX package's
        ``Codebook.__call__``. With ``train`` the buffers are updated in
        place from K6's ``n_total`` and ``encode_sum``; ``init_rows`` and
        ``restart_rows`` (K, D) replace the candidate rows that
        ``generator`` would draw (:meth:`tile_rows`)."""
        d, k = self.embedding_dim, self.n_codes
        if z.shape[-1] != d:
            raise ValueError(f"codebook: last dim {z.shape[-1]} != {d}")
        flat = z.reshape(-1, d).float().contiguous()
        sharded = getattr(self.embeddings, "tp_dim", None) is not None
        # this rank's codes (all of them unless sharded)
        kl = self.embeddings.shape[0]
        lo = group_rank(model_group()) * kl if sharded else 0
        mine = slice(lo, lo + kl)
        embeddings = self.embeddings
        if train:
            with torch.no_grad():
                # no host sync: every step draws the init's candidates and
                # torch.where picks by the flag on the device; in a group
                # from the global rows, as the JAX package's global array
                rows = all_gather_rows(flat.detach(), data_group())
                k_init = (self.tile_rows(rows, generator) if init_rows is None
                          else init_rows.to(rows))[mine]
                inited = self.initialized
                embeddings = torch.where(inited, self.embeddings, k_init)
                n_now = torch.where(inited, self.ema_count,
                                    torch.ones_like(self.ema_count))
                zavg_now = torch.where(inited, self.ema_sum, k_init)
        if sharded:
            indices, n_total, encode_sum = nearest_code_stats_tp(
                flat, embeddings, plain=self.kernel_mode == "xla")
        else:
            lookup = (nearest_code_stats_reference
                      if self.kernel_mode == "xla" else nearest_code_stats)
            indices, n_total, encode_sum = nearest_code_stats_sharded(
                flat, embeddings, lookup)
        encodings = indices.reshape(z.shape[:-1])
        quantized = F.embedding(indices, self._whole(embeddings)).reshape(
            z.shape).to(z.dtype)
        commitment_loss = self.commitment_cost * torch.mean(
            torch.square(z - quantized.detach()))
        embeddings_st = z + (quantized - z).detach()   # straight-through
        every_n = self._whole(n_total)
        avg_probs = every_n / torch.clamp(every_n.sum(), min=1.0)
        entropy = -torch.sum(avg_probs * torch.log(avg_probs + 1e-10))
        codebook_loss = torch.mean(torch.square(
            z.detach().float() - quantized.float()))
        if train:
            with torch.no_grad():
                new_n = self.decay * n_now + (1.0 - self.decay) * n_total
                new_zavg = (self.decay * zavg_now
                            + (1.0 - self.decay) * encode_sum)
                total = self._whole(new_n).sum()
                weights = (new_n + 1e-7) / (total + k * 1e-7) * total
                new_emb = new_zavg / weights[:, None]
                k_rand = (self.tile_rows(rows, generator)
                          if restart_rows is None
                          else restart_rows.to(rows))[mine]
                usage = (new_n[:, None] >= 1.0).float()
                self.embeddings.copy_(usage * new_emb
                                      + (1.0 - usage) * k_rand)
                self.ema_count.copy_(new_n)
                self.ema_sum.copy_(new_zavg)
                self.initialized.fill_(True)
        return dict(embeddings=embeddings_st, encodings=encodings,
                    commitment_loss=commitment_loss,
                    perplexity=torch.exp(entropy), entropy=entropy,
                    codebook_loss=codebook_loss)

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` over this rank's codes -> over all codes (gathered over the
        model group where the codebook is sharded)."""
        if getattr(self.embeddings, "tp_dim", None) is None:
            return t
        return all_gather(t, 0, model_group())

    def lookup(self, encodings: torch.Tensor) -> torch.Tensor:
        """Token ids -> embedding vectors."""
        return F.embedding(encodings, self._whole(self.embeddings))


class VQVAE(nn.Module):
    """Two-sided VQ-VAE: video -> token grid -> video."""

    def __init__(self, embedding_dim: int = 128, n_codes: int = 4096,
                 n_hiddens: int = 256, n_res_layers: int = 3,
                 downsample: Sequence[int] = (1, 16, 16),
                 sequence_length: int = 4, resolution: int = 128,
                 recon_loss_scale: float = 1.0 / 0.06,
                 kernel_mode: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.recon_loss_scale = recon_loss_scale
        self.downsample = tuple(downsample)
        self.sequence_length = sequence_length
        self.resolution = resolution
        self.n_codes = n_codes
        self.encoder = Encoder(n_hiddens, n_res_layers, downsample,
                               dtype=dtype)
        self.pre_vq_conv = SamePadConv3d(n_hiddens, embedding_dim, 1,
                                         dtype=dtype)
        self.decoder = Decoder(n_hiddens, n_res_layers, downsample, 3, dtype)
        self.post_vq_conv = SamePadConv3d(embedding_dim, n_hiddens, 1,
                                          dtype=dtype)
        self.codebook = Codebook(n_codes, embedding_dim,
                                 kernel_mode=kernel_mode)

    @property
    def latent_shape(self) -> tuple[int, int, int]:
        shape = (self.sequence_length, self.resolution, self.resolution)
        return tuple(s // d for s, d in zip(shape, self.downsample))

    def encode(self, x: torch.Tensor, *, include_embeddings: bool = False,
               train: bool = False, **codebook_kw):
        """video (B, T, H, W, 3) f32 -> encodings (B, t, h, w) int32, and
        with ``include_embeddings`` the straight-through embeddings too.
        ``codebook_kw``: the codebook's ``generator``, ``init_rows``,
        ``restart_rows`` (read with ``train``)."""
        vq = self.codebook(self.pre_vq_conv(self.encoder(x, train)),
                           train=train, **codebook_kw)
        if include_embeddings:
            return vq["encodings"], vq["embeddings"]
        return vq["encodings"]

    def decode(self, encodings: torch.Tensor, *,
               train: bool = False) -> torch.Tensor:
        """encodings: (B, t, h, w) int -> video (B, T, H, W, 3) in the
        compute dtype, the JAX
        package's ``VQVAE.decode``: ``train`` puts the decoder's BatchNorm
        on batch statistics. Differentiable in the decoder's parameters
        when grad mode is on; the serving path
        (:func:`..generate.sample_videos`) calls it under no_grad."""
        h = self.codebook.lookup(encodings)
        return self.decoder(self.post_vq_conv(h), train)

    def forward(self, batch: dict, *, train: bool = False,
                **codebook_kw) -> dict:
        """``batch["video"]`` (B, T, H, W, 3) f32 -> the reconstruction with
        its losses: the JAX package's ``VQVAE.__call__``. The decoder reads
        the straight-through embeddings, so the encoder's gradient flows
        (``decode`` is the route from tokens)."""
        x = batch["video"]
        z = self.pre_vq_conv(self.encoder(x, train))
        vq = self.codebook(z, train=train, **codebook_kw)
        x_recon = self.decoder(self.post_vq_conv(vq["embeddings"]), train)
        recon_loss = torch.mean(torch.square(
            x_recon.float() - x.float())) * self.recon_loss_scale
        return {
            "pred_data": x_recon,
            "gt_data": x,
            "losses": {"recon_loss": recon_loss,
                       "commitment_loss": vq["commitment_loss"]},
            "metrics": {"perplexity": vq["perplexity"]},
            "codebook_loss": vq["codebook_loss"],
            "entropy": vq["entropy"],
            "encodings": vq["encodings"],
        }


def make_vqvae(cfg: Mapping[str, Any]) -> VQVAE:
    """The VQ-VAE of a configuration node (a model config's ``generator``
    entry, or the mapping itself: the autoencoder's keys), with the JAX
    package's defaults. ``kernel_mode``: ``"xla"`` keeps the codebook on its
    plain lookup on every device; ``dtype``: ``bfloat16`` computes in bf16
    on f32 parameters."""
    g = dict(cfg.get("generator", cfg))
    return VQVAE(
        embedding_dim=int(g.get("embedding_dim", 128)),
        n_codes=int(g.get("n_codes", 4096)),
        n_hiddens=int(g.get("n_hiddens", 256)),
        n_res_layers=int(g.get("n_res_layers", 3)),
        downsample=tuple(g.get("downsample", (1, 16, 16))),
        sequence_length=int(g.get("sequence_length", 4)),
        resolution=int(g.get("resolution", 128)),
        kernel_mode=str(g.get("kernel_mode", "auto")),
        dtype=compute_dtype(g.get("dtype", "float32")))


@torch.no_grad()
def init_vqvae_(model: VQVAE, generator: torch.Generator) -> None:
    """The JAX package's init laws: fan-in uniform convs with zero biases,
    N(0, 1/sqrt(c)) axial projections with a zero output bias, unit
    BatchNorm (mean 0, var 1), an N(0, 1) codebook with zero EMA counts, its
    EMA sums equal to the embeddings, and not yet initialised from data."""
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
            m.initialized.fill_(False)
