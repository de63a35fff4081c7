"""Inception-I3D video encoder: the FVD backbone.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/i3d.py``:
Inception-v1 inflated to 3D, endpoints ``Conv3d_1a_7x7`` ... ``Mixed_5c``
-> logits, with TF-style dynamic SAME padding (front gets the floor: the
opposite split of the VQ-VAE's same-pad convs) and max pools that pad with
-inf. Clips are channels-last (B, T, H, W, C) at the boundary; inside, the
NCDHW view goes to cuDNN. BatchNorm is inference-only with eps 1e-5.

Two quirks of the JAX module are kept: the final average pool takes
``min(kernel, size)`` per axis, and the logits read only spatial position
``[0, 0]`` before the mean over time.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FrozenBatchNorm

__all__ = ["InceptionI3d", "Unit3D", "InceptionModule", "tf_same_pad"]


def tf_same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """TF SAME padding: front = floor, back = ceil."""
    p = max(k - s, 0) if size % s == 0 else max(k - size % s, 0)
    return (p // 2, p - p // 2)


def _f_pads(x: torch.Tensor, ks: Sequence[int], st: Sequence[int]
            ) -> list[int]:
    """F.pad's list (W first) for the (D, H, W) axes of an NCDHW tensor."""
    pads = [tf_same_pad(x.shape[2 + i], ks[i], st[i]) for i in range(3)]
    return [p for pair in reversed(pads) for p in pair]


class Unit3D(nn.Module):
    """Conv3d (TF-SAME) + BatchNorm + ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_shape: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1),
                 use_batch_norm: bool = True, use_bias: bool = False,
                 activation: bool = True):
        super().__init__()
        self.kernel_shape = tuple(kernel_shape)
        self.stride = tuple(stride)
        self.activation = activation
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               *self.kernel_shape))
        self.bias = (nn.Parameter(torch.empty(out_channels)) if use_bias
                     else None)
        self.bn = FrozenBatchNorm(out_channels) if use_batch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, _f_pads(x, self.kernel_shape, self.stride))
        y = F.conv3d(x, self.weight, self.bias, self.stride)
        if self.bn is not None:
            y = self.bn(y)
        return F.relu(y) if self.activation else y


def _max_pool_same(x: torch.Tensor, ks: Sequence[int], st: Sequence[int]
                   ) -> torch.Tensor:
    x = F.pad(x, _f_pads(x, ks, st), value=float("-inf"))
    return F.max_pool3d(x, tuple(ks), tuple(st))


class InceptionModule(nn.Module):
    """Four-branch inception block, concatenated over channels."""

    def __init__(self, in_channels: int, oc: Sequence[int]):
        super().__init__()
        self.out_channels = oc[0] + oc[2] + oc[4] + oc[5]
        self.b0 = Unit3D(in_channels, oc[0])
        self.b1a = Unit3D(in_channels, oc[1])
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, oc[3])
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, oc[5])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
            self.b3b(_max_pool_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


_MIXED = {
    "Mixed_3b": [64, 96, 128, 16, 32, 32],
    "Mixed_3c": [128, 128, 192, 32, 96, 64],
    "Mixed_4b": [192, 96, 208, 16, 48, 64],
    "Mixed_4c": [160, 112, 224, 24, 64, 64],
    "Mixed_4d": [128, 128, 256, 24, 64, 64],
    "Mixed_4e": [112, 144, 288, 32, 64, 64],
    "Mixed_4f": [256, 160, 320, 32, 128, 128],
    "Mixed_5b": [256, 160, 320, 32, 128, 128],
    "Mixed_5c": [384, 192, 384, 48, 128, 128],
}
# the max pools that precede a stage of mixed blocks: (kernel, stride)
_POOL_BEFORE = {"Mixed_3b": ((1, 3, 3), (1, 2, 2)),
                "Mixed_4b": ((3, 3, 3), (2, 2, 2)),
                "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class InceptionI3d(nn.Module):
    """(B, T, H, W, 3) -> logits (B, num_classes), averaged over time."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        channels = 192
        for name, oc in _MIXED.items():
            block = InceptionModule(channels, oc)
            self.add_module(name, block)
            channels = block.out_channels
        self.logits = Unit3D(channels, num_classes, use_batch_norm=False,
                             use_bias=True, activation=False)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv3d_1a_7x7(x)
        x = _max_pool_same(x, (1, 3, 3), (1, 2, 2))        # MaxPool3d_2a
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        for name in _MIXED:
            if name in _POOL_BEFORE:
                x = _max_pool_same(x, *_POOL_BEFORE[name])
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor, features_only: bool = False
                ) -> torch.Tensor:
        """x: (B, T, H, W, 3). ``features_only``: the average-pooled
        ``Mixed_5c`` activations, channels-last (B, T', H', W', 1024)."""
        x = self._trunk(x.permute(0, 4, 1, 2, 3))
        # AvgPool3d((2, 7, 7), stride 1), VALID, each axis capped at its size
        k = (min(2, x.shape[2]), min(7, x.shape[3]), min(7, x.shape[4]))
        x = F.avg_pool3d(x, k, stride=1)
        if features_only:
            return x.permute(0, 2, 3, 4, 1)
        x = self.logits(x)
        return x[:, :, :, 0, 0].mean(dim=2)


@torch.no_grad()
def init_i3d_(model: InceptionI3d, generator: torch.Generator) -> None:
    """The flax init laws: conv kernels lecun-normal (N(0, 1 / fan_in)
    truncated at two standard deviations), zero biases, BatchNorm scale 1,
    bias 0, running mean 0 and variance 1."""
    for m in model.modules():
        if isinstance(m, Unit3D):
            fan_in = m.weight[0].numel()
            std = fan_in ** -0.5 / 0.87962566103423978
            w = torch.empty_like(m.weight, device="cpu")
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
