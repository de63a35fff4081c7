"""Flax variable trees -> the port's PyTorch state dicts.

The inverse of the conventions ``gif_synthesis_with_discrete_diffusion_tpu/
convert/common.py`` targets; one map serves the VQ-VAE, the generator, the
CLIP text tower (``flax_to_state_dict(params)``), ResNet-50 and the I3D
(``flax_to_state_dict(params, batch_stats)``). The trees come in as nested
dicts of numpy arrays (``jax.device_get`` output, or any checkpoint read as
numpy); no jax is imported here. The port names its submodules after the flax scopes, so
the map is per leaf:

* Dense ``kernel`` (in, out)          -> Linear ``weight`` (out, in)
* Conv ``kernel`` DHWIO               -> ``weight`` (O, I, kD, kH, kW)
* ConvTranspose ``kernel`` DHWIO, forward orientation (scopes ``convt*``)
                                      -> ``weight`` (I, O, kD, kH, kW), the
  layout of ``ops/conv3d.same_pad_conv_transpose3d``
* Conv ``kernel`` HWIO (2-D)          -> ``weight`` (O, I, kH, kW)
* MultiHeadDotProductAttention ``query`` / ``key`` / ``value`` ``kernel``
  (D, H, hd) and ``bias`` (H, hd), ``out`` ``kernel`` (H, hd, D)
                                      -> Linear ``weight`` (H * hd, D) /
  (D, H * hd) and ``bias`` (H * hd,)
* Embed ``embedding``                 -> ``weight``
* LayerNorm / BatchNorm ``scale``     -> ``weight``; ``bias`` as it is
* batch_stats ``mean`` / ``var``      -> ``running_mean`` / ``running_var``
* other params (``null_embed``, ``empty_text_embed``,
  ``positional_embedding``, ``text_projection``) as they are
* other variable collections (the generator's ``diffusion`` collection:
  ``lt_history``, ``lt_count``, ``diffusion_acc``, ``diffusion_keep``)
  -> buffers of the same dotted name
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "vqvae_state_dict", "linear_weight",
           "conv2d_weight", "conv3d_weight", "conv_transpose3d_weight"]


def linear_weight(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (1, 0))


def conv2d_weight(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (3, 2, 0, 1))


def conv3d_weight(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (4, 3, 0, 1, 2))


def conv_transpose3d_weight(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (3, 4, 0, 1, 2))


def _leaves(tree: Mapping[str, Any], prefix: tuple = ()
            ) -> Iterator[tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _map_param(path: tuple, leaf: np.ndarray) -> tuple[tuple, np.ndarray]:
    *scope, name = path
    if scope and scope[-1] in _MHA_IN and leaf.ndim == 3 - (name == "bias"):
        # an attention projection (D, H, hd) / (H, hd): heads flattened
        if name == "bias":
            return path, leaf.reshape(-1)
        return (*scope, "weight"), linear_weight(
            leaf.reshape(leaf.shape[0], -1))
    if scope and scope[-1] == "out" and name == "kernel" and leaf.ndim == 3:
        return (*scope, "weight"), linear_weight(
            leaf.reshape(-1, leaf.shape[-1]))
    if name == "kernel":
        if leaf.ndim == 2:
            return (*scope, "weight"), linear_weight(leaf)
        if leaf.ndim == 4:
            return (*scope, "weight"), conv2d_weight(leaf)
        if leaf.ndim == 5 and scope and scope[-1].startswith("convt"):
            return (*scope, "weight"), conv_transpose3d_weight(leaf)
        if leaf.ndim == 5:
            return (*scope, "weight"), conv3d_weight(leaf)
        raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
    if name in ("embedding", "scale"):
        return (*scope, "weight"), leaf
    return path, leaf


_MHA_IN = ("query", "key", "value")
_STATS = {"mean": "running_mean", "var": "running_var"}


def flax_to_state_dict(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any] | None = None,
                       buffers: Mapping[str, Any] | None = None
                       ) -> dict[str, torch.Tensor]:
    """Map a flax ``params`` tree (with its ``batch_stats``, and other
    collections in ``buffers`` whose leaves keep their names) to a state
    dict with dotted keys."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        key, value = _map_param(path, leaf)
        out[".".join(key)] = torch.from_numpy(np.array(value))
    for path, leaf in _leaves(batch_stats or {}):
        *scope, name = path
        out[".".join((*scope, _STATS[name]))] = torch.from_numpy(
            np.array(leaf))
    for path, leaf in _leaves(buffers or {}):
        out[".".join(path)] = torch.from_numpy(np.array(leaf))
    return out


def vqvae_state_dict(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any],
                     codebook: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax ``VQVAE``'s params / batch_stats / codebook collections -> the
    port's ``VQVAE`` state dict: encoder, ``pre_vq_conv``, ``post_vq_conv``
    and decoder, and the codebook's ``embeddings``, ``ema_count``,
    ``ema_sum`` and ``initialized`` flag."""
    sd = flax_to_state_dict(params, batch_stats)
    for name in ("embeddings", "ema_count", "ema_sum"):
        sd[f"codebook.{name}"] = torch.from_numpy(
            np.array(codebook["codebook"][name], np.float32))
    sd["codebook.initialized"] = torch.from_numpy(
        np.array(codebook["codebook"]["initialized"], np.bool_))
    return sd
