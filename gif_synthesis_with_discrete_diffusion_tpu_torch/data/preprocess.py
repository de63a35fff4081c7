"""Video preprocessing on the device.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/data/preprocess.py``:
the host hands over uint8 clips; scaling to [0, 1], a bilinear shorter-side
resize with a centre crop, and ImageNet normalisation run on the clip's
device. ``jax.image.resize(..., "bilinear")`` antialiases when it
downscales, as ``F.interpolate(mode="bilinear", antialias=True,
align_corners=False)`` does.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "preprocess_clip",
           "unnormalize", "resize_shorter_side_and_crop"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_shorter_side_and_crop(video: torch.Tensor, resolution: int
                                 ) -> torch.Tensor:
    """Bilinear shorter-side resize then centre crop, (..., H, W, C)."""
    *lead, h, w, c = video.shape
    scale = resolution / min(h, w)
    nh = max(int(round(h * scale)), resolution)
    nw = max(int(round(w * scale)), resolution)
    if (nh, nw) != (h, w):
        x = video.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(nh, nw), mode="bilinear",
                          antialias=True, align_corners=False)
        video = x.permute(0, 2, 3, 1).reshape(*lead, nh, nw, c)
    top, left = (nh - resolution) // 2, (nw - resolution) // 2
    return video[..., top:top + resolution, left:left + resolution, :]


@functools.cache
def _stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The normalisation constants on ``device``, copied there once: a
    training step then waits on no transfer from the host."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def preprocess_clip(video_u8: torch.Tensor, resolution: int) -> torch.Tensor:
    """uint8 (B, T, H, W, 3) -> normalised f32 at the target resolution."""
    v = video_u8.to(torch.float32) / 255.0
    v = resize_shorter_side_and_crop(v, resolution)
    mean, std = _stats(v.device)
    return (v - mean) / std


def unnormalize(video: torch.Tensor) -> torch.Tensor:
    """Invert the ImageNet normalisation -> [0, 1] floats (clipped)."""
    mean, std = _stats(video.device)
    return torch.clamp(video * std + mean, 0.0, 1.0)
