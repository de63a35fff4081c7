"""ResNet-50 (torchvision's layout) and its IMAGENET1K_V2 preprocessing.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/resnet.py``: the
network the reference uses for its start-frame features, returning the
(B, 2048) global-average-pooled activations (``features_only``) or the
(B, num_classes) logits. Images are NHWC at the boundary, as in the JAX
package; inside, the NCHW view of that channels-last tensor goes to cuDNN.
BatchNorm runs in inference with eps 1e-5; the max pool pads with -inf, as
the JAX module's explicit pad does. Submodules carry the flax scope names
(``conv1``, ``bn1``, ``layer{i}_{j}`` with ``downsample_conv`` /
``downsample_bn``, ``fc``), so the weight bridge is a re-layout.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FrozenBatchNorm

__all__ = ["ResNet50", "Bottleneck", "IMAGENET_MEAN", "IMAGENET_STD",
           "preprocess_imagenet_v2", "init_resnet50_"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), residual; NCHW inside."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        if downsample:
            self.downsample_conv = _conv(inplanes, planes * 4, 1, stride)
            self.downsample_bn = FrozenBatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """torchvision-compatible ResNet-50 over NHWC images."""

    def __init__(self, num_classes: int = 1000,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.blocks: list[str] = []
        inplanes, planes = 64, 64
        for li, n_blocks in enumerate(stage_sizes):
            for bi in range(n_blocks):
                name = f"layer{li + 1}_{bi}"
                stride = (1 if li == 0 else 2) if bi == 0 else 1
                self.add_module(name, Bottleneck(inplanes, planes, stride,
                                                 downsample=bi == 0))
                self.blocks.append(name)
                inplanes = planes * 4
            planes *= 2
        self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x: torch.Tensor, features_only: bool = False
                ) -> torch.Tensor:
        """x: (B, H, W, 3) normalised -> (B, 2048) features with
        ``features_only``, else (B, num_classes) logits; f32."""
        h = x.permute(0, 3, 1, 2)
        h = F.relu(self.bn1(self.conv1(h)))
        h = F.max_pool2d(h, 3, 2, padding=1)   # implicit -inf padding
        for name in self.blocks:
            h = getattr(self, name)(h)
        feats = h.mean(dim=(2, 3))
        if features_only:
            return feats.float()
        return self.fc(feats).float()


def preprocess_imagenet_v2(frame_u8: torch.Tensor, resize: int = 232,
                           crop: int = 224) -> torch.Tensor:
    """``ResNet50_Weights.IMAGENET1K_V2.transforms()``: bilinear
    (antialiased) resize of the shorter side to ``resize``, centre crop
    ``crop``, scale to [0, 1], ImageNet normalisation. (..., H, W, 3) uint8
    -> (..., crop, crop, 3) f32 on the frame's device."""
    x = frame_u8.to(torch.float32) / 255.0
    *lead, h, w, c = x.shape
    scale = resize / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    y = F.interpolate(x.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                      size=(nh, nw), mode="bilinear", antialias=True,
                      align_corners=False)
    y = y.permute(0, 2, 3, 1).reshape(*lead, nh, nw, c)
    top, left = (nh - crop) // 2, (nw - crop) // 2
    y = y[..., top:top + crop, left:left + crop, :]
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=y.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=y.device)
    return (y - mean) / std


@torch.no_grad()
def init_resnet50_(model: ResNet50, generator: torch.Generator) -> None:
    """The flax init laws: conv and dense kernels lecun-normal (N(0,
    1 / fan_in) truncated at two standard deviations), zero biases,
    BatchNorm scale 1, bias 0, running mean 0 and variance 1."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
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
