"""A pytorch-i3d Kinetics checkpoint (``i3d_pretrained_400.pt``, a bare
state dict) -> the port's ``InceptionI3d`` state dict.

The port's copy of ``gif_synthesis_with_discrete_diffusion_tpu/convert/
torch_i3d.py``, bridged by :func:`.from_flax.flax_to_state_dict`. The file
is read with :func:`.common.load_torch_state_dict`'s ``"auto"`` key: a bare
state dict as it is (what the JAX package's ``key=None`` reads), a
Lightning checkpoint's ``state_dict`` entry too.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .common import bn_params, conv3d_kernel, load_torch_state_dict
from .from_flax import flax_to_state_dict

__all__ = ["convert_i3d", "convert_i3d_file"]

_MIXED_BRANCHES = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")
_MIXED_NAMES = ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d",
                "Mixed_4e", "Mixed_4f", "Mixed_5b", "Mixed_5c")
_CONV_UNITS = ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3")


def _unit(sd: Mapping[str, np.ndarray], tname: str, use_bn: bool = True,
          use_bias: bool = False):
    params = {"kernel": conv3d_kernel(sd[f"{tname}.conv3d.weight"])}
    stats = {}
    if use_bias:
        params["bias"] = sd[f"{tname}.conv3d.bias"]
    if use_bn:
        bn_p, bn_s = bn_params(sd, f"{tname}.bn")
        params["bn"] = bn_p
        stats["bn"] = bn_s
    return params, stats


def _i3d_tree(sd: Mapping[str, np.ndarray]) -> dict:
    """-> {'params': ..., 'batch_stats': ...}: the JAX converter's tree."""
    params: dict = {}
    stats: dict = {}
    for name in _CONV_UNITS:
        params[name], s = _unit(sd, name)
        if s:
            stats[name] = s
    for name in _MIXED_NAMES:
        params[name], stats[name] = {}, {}
        for br in _MIXED_BRANCHES:
            params[name][br], s = _unit(sd, f"{name}.{br}")
            if s:
                stats[name][br] = s
    params["logits"], _ = _unit(sd, "logits", use_bn=False, use_bias=True)
    return {"params": params, "batch_stats": stats}


def convert_i3d(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A reference-keyed state dict -> the port's I3D state dict."""
    t = _i3d_tree(sd)
    return flax_to_state_dict(t["params"], t["batch_stats"])


def convert_i3d_file(path: str) -> dict[str, torch.Tensor]:
    return convert_i3d(load_torch_state_dict(path))
