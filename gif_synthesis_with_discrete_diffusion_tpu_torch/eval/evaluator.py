"""FVD evaluation: I3D embeddings and the Fréchet distance.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/eval/evaluator.py``,
with the reference's quirks kept: :func:`prepare_fvd_clip` un-normalises
the ImageNet statistics, quantises to uint8, preprocesses again at
:data:`FVD_RESOLUTION` (an upscale from the model's 64 px), multiplies by 2
and repeats 4 / 8 / fewer than 16 frames up to 16; the embeddings are the
I3D's per-class logits; :func:`frechet_distance` takes the SVD-based matrix
square root, leaving singular values under ``eps`` un-rooted, in float64
numpy on the host. Everything before the Fréchet distance runs on the
clips' device (cuDNN convolutions on the card; no hand-written kernel, as
the JAX package has none here).

In a data-parallel run every rank samples its rows of each batch
(:meth:`FVDEvaluator.evaluate` through the trainer, whose clips come back
gathered in rank order) and gathers the ground-truth clips; rank 0 alone
embeds them and takes the distance, and its result is broadcast, which
holds the other ranks until it is there.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..data.preprocess import preprocess_clip, unnormalize
from ..parallel.distributed import (all_gather_rows, broadcast_object,
                                    data_group, is_main_process)
from ..models.i3d import InceptionI3d, init_i3d_
from ..utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["FVDEvaluator", "frechet_distance", "prepare_fvd_clip",
           "FVD_RESOLUTION"]

# read by prepare_fvd_clip at call time (the tests set it smaller)
FVD_RESOLUTION = 224


def prepare_fvd_clip(video: torch.Tensor) -> torch.Tensor:
    """Normalised model-space video (B, T, H, W, 3) -> the I3D's input:
    un-normalise -> uint8 -> preprocess at :data:`FVD_RESOLUTION` -> x2 ->
    temporal repeat to 16 frames."""
    u8 = torch.round(unnormalize(video.float()) * 255.0).to(torch.uint8)
    x = preprocess_clip(u8, FVD_RESOLUTION) * 2.0
    t = x.shape[1]
    if t == 8:
        x = torch.repeat_interleave(x, 2, dim=1)
    elif t == 4:
        x = torch.repeat_interleave(x, 4, dim=1)
    elif t < 16:
        x = torch.repeat_interleave(x, -(-16 // t), dim=1)[:, :16]
    return x


def _cov(m: np.ndarray) -> np.ndarray:
    """Unbiased covariance, observations in rows."""
    m = m - m.mean(axis=0, keepdims=True)
    return m.T @ m / (m.shape[0] - 1)


def _symmetric_matrix_square_root(mat: np.ndarray,
                                  eps: float = 1e-10) -> np.ndarray:
    u, s, vt = np.linalg.svd(mat)
    # the reference's quirk: singular values under eps stay un-rooted
    si = np.where(s < eps, s, np.sqrt(s))
    return u @ np.diag(si) @ vt


def _trace_sqrt_product(sigma: np.ndarray, sigma_v: np.ndarray) -> float:
    sqrt_sigma = _symmetric_matrix_square_root(sigma)
    sqrt_a = sqrt_sigma @ sigma_v @ sqrt_sigma
    return float(np.trace(_symmetric_matrix_square_root(sqrt_a)))


def frechet_distance(x1: np.ndarray, x2: np.ndarray) -> float:
    """FVD between two activation sets (N, D), in float64 on the host."""
    x1 = np.asarray(x1, np.float64).reshape(x1.shape[0], -1)
    x2 = np.asarray(x2, np.float64).reshape(x2.shape[0], -1)
    m, m_w = x1.mean(axis=0), x2.mean(axis=0)
    sigma, sigma_w = _cov(x1), _cov(x2)
    trace = float(np.trace(sigma + sigma_w)) \
        - 2.0 * _trace_sqrt_product(sigma, sigma_w)
    return trace + float(np.sum((m - m_w) ** 2))


class FVDEvaluator:
    """Accumulates I3D embeddings of ground-truth and generated clips and
    computes the FVD. Without ``i3d_state`` (a state dict of
    :class:`..models.i3d.InceptionI3d`, e.g. from
    :func:`..convert.from_flax.flax_to_state_dict`) the I3D takes the flax init
    laws from ``generator``: a relative FVD only."""

    def __init__(self, i3d_state: Optional[Mapping[str, Any]] = None,
                 num_classes: int = 400,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        with torch.device("meta"):
            model = InceptionI3d(num_classes=num_classes)
        model = model.to_empty(device="cpu")
        if i3d_state is None:
            init_i3d_(model, generator or torch.Generator().manual_seed(0))
        else:
            model.load_state_dict(i3d_state)
        self.model = model.to(device).eval().requires_grad_(False)
        self.reset()

    @property
    def device(self) -> torch.device:
        return self.model.logits.weight.device

    def reset(self) -> None:
        self.gen_embeds: list[np.ndarray] = []
        self.gt_embeds: list[np.ndarray] = []

    @torch.no_grad()
    def embed(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) normalised clips -> (B, num_classes) logits on
        the evaluator's device."""
        return self.model(prepare_fvd_clip(
            torch.as_tensor(video).to(self.device)))

    def push_vals(self, gt_video: torch.Tensor,
                  generated_video: torch.Tensor) -> None:
        """Both (B, T, H, W, 3) in normalised model space."""
        self.gt_embeds.append(self.embed(gt_video).cpu().numpy())
        self.gen_embeds.append(self.embed(generated_video).cpu().numpy())

    def evaluate_metrics(self) -> dict[str, float]:
        gen = np.concatenate(self.gen_embeds, axis=0)
        gt = np.concatenate(self.gt_embeds, axis=0)
        return {"fvd": frechet_distance(gen, gt)}

    # ---- the trainer's hook -----------------------------------------------
    def evaluate(self, trainer, split: str, epoch: int) -> dict[str, float]:
        """Sample clips for the whole split through
        ``trainer.sample_videos`` and return ``{"Metrics/fvd-<split>": x}``
        (nothing for a split without batches). In a process group every
        rank calls it; rank 0 computes the metric and every rank returns
        it."""
        self.reset()
        batches = (trainer.datamodule.val_batches(epoch) if split == "val"
                   else trainer.datamodule.test_batches(epoch))
        main = is_main_process()
        for batch in batches:
            videos = trainer.sample_videos(batch, trainer.next_sample_rng())
            gt_u8 = all_gather_rows(torch.as_tensor(batch["video"]).to(
                self.device), data_group())
            if main:
                self.push_vals(preprocess_clip(gt_u8, trainer.resolution),
                               videos)
        out = {}
        if self.gen_embeds:
            metrics = self.evaluate_metrics()
            out = {f"Metrics/{k}-{split}": v for k, v in metrics.items()}
            log.info("FVD (%s, epoch %d): %.3f", split, epoch,
                     metrics["fvd"])
        return broadcast_object(out)
