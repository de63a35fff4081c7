"""Video rendering: normalised model clips -> GIF (or mp4) files.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/utils/renderer.py``:
un-normalise the ImageNet statistics, quantise to uint8 and write the clip
with ``imageio``, imported when a clip is written. Rendering must never
stop training: where ``imageio`` is absent or a write fails, the failure is
logged and ``None`` returned. (This is no device fallback: the clip is
already on the host.) In a data-parallel run only rank 0 writes; the other
ranks return ``None``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from ..parallel.distributed import is_main_process
from .logging import get_logger

__all__ = ["render_animation"]

log = get_logger(__name__)


def render_animation(video, output_path: str | Path,
                     fps: int = 1) -> Path | None:
    """video: (T, H, W, 3) ImageNet-normalised clip (a numpy array or a
    tensor on any device; a tensor is copied to the host as f32)."""
    if not is_main_process():
        return None
    if hasattr(video, "detach"):
        video = video.detach().float().cpu().numpy()
    video = np.asarray(video)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    frames = np.clip(video * std + mean, 0.0, 1.0)
    frames_u8 = (frames * 255.0 + 0.5).astype(np.uint8)

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import imageio.v3 as iio
        if output_path.suffix == ".mp4":
            try:
                iio.imwrite(output_path, frames_u8, fps=fps)
            except Exception:
                output_path = output_path.with_suffix(".gif")
                iio.imwrite(output_path, frames_u8,
                            duration=1000.0 / fps, loop=0)
        else:
            iio.imwrite(output_path, frames_u8, duration=1000.0 / fps, loop=0)
        return output_path
    except Exception as e:  # rendering must never kill training
        log.warning("render_animation failed: %s", e)
        return None
