"""torchvision ResNet-50 weights -> the port's ``ResNet50`` state dict.

The port's copy of ``gif_synthesis_with_discrete_diffusion_tpu/convert/
torch_resnet.py``: the torchvision state_dict (``conv1.weight``,
``layer{1-4}.{i}.conv{1-3}``, ``downsample.{0,1}``, ``fc``) onto the flax
tree of ``models/resnet.py``, then onto the port's names
(:func:`.from_flax.flax_to_state_dict`). The reference takes these weights
for its start-frame features.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .common import bn_params, linear_kernel, load_torch_state_dict
from .from_flax import flax_to_state_dict

__all__ = ["convert_resnet50", "convert_resnet50_file"]

_STAGE_SIZES = (3, 4, 6, 3)


def _conv2d_kernel(w: np.ndarray) -> np.ndarray:
    """torch (O, I, kH, kW) -> flax HWIO (kH, kW, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def _block(sd: Mapping[str, np.ndarray], t: str, has_downsample: bool):
    params: dict = {}
    stats: dict = {}
    for i in (1, 2, 3):
        params[f"conv{i}"] = {"kernel": _conv2d_kernel(sd[f"{t}.conv{i}.weight"])}
        p, s = bn_params(sd, f"{t}.bn{i}")
        params[f"bn{i}"], stats[f"bn{i}"] = p, s
    if has_downsample:
        params["downsample_conv"] = {
            "kernel": _conv2d_kernel(sd[f"{t}.downsample.0.weight"])}
        p, s = bn_params(sd, f"{t}.downsample.1")
        params["downsample_bn"], stats["downsample_bn"] = p, s
    return params, stats


def _resnet50_tree(sd: Mapping[str, np.ndarray]) -> dict:
    """-> {'params': ..., 'batch_stats': ...}: the JAX converter's tree."""
    params: dict = {"conv1": {"kernel": _conv2d_kernel(sd["conv1.weight"])}}
    stats: dict = {}
    params["bn1"], stats["bn1"] = bn_params(sd, "bn1")
    for li, n_blocks in enumerate(_STAGE_SIZES):
        for bi in range(n_blocks):
            name = f"layer{li + 1}_{bi}"
            params[name], stats[name] = _block(
                sd, f"layer{li + 1}.{bi}", has_downsample=bi == 0)
    if "fc.weight" in sd:
        params["fc"] = {"kernel": linear_kernel(sd["fc.weight"]),
                        "bias": sd["fc.bias"]}
    return {"params": params, "batch_stats": stats}


def convert_resnet50(sd: Mapping[str, np.ndarray]
                     ) -> dict[str, torch.Tensor]:
    """A torchvision-keyed state dict -> the port's ResNet-50 state dict."""
    t = _resnet50_tree(sd)
    return flax_to_state_dict(t["params"], t["batch_stats"])


def convert_resnet50_file(path: str) -> dict[str, torch.Tensor]:
    return convert_resnet50(load_torch_state_dict(path))
