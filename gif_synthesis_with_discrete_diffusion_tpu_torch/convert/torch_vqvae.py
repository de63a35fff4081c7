"""A reference VQ-VAE checkpoint -> the port's ``VQVAE`` state dict.

The port's copy of ``gif_synthesis_with_discrete_diffusion_tpu/convert/
torch_vqvae.py``: a raw VQVAE state_dict or a Lightning TextMotionModel
checkpoint (keys prefixed ``generator.``) mapped onto the flax tree, then
onto the port's names (:func:`.from_flax.vqvae_state_dict`): the encoder,
the decoder, ``pre_vq_conv`` / ``post_vq_conv``, BatchNorm's running
statistics, and the codebook's buffers (``embeddings``, ``ema_count`` from
``N``, ``ema_sum`` from ``z_avg``, ``initialized`` True).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .common import (bn_params, conv3d_kernel, conv_transpose3d_kernel,
                     linear_kernel, load_torch_state_dict, strip_prefix)

from .from_flax import vqvae_state_dict

__all__ = ["convert_vqvae", "convert_vqvae_file"]


def _same_pad_conv(sd, tname):
    p = {"kernel": conv3d_kernel(sd[f"{tname}.conv.weight"])}
    if f"{tname}.conv.bias" in sd:
        p["bias"] = sd[f"{tname}.conv.bias"]
    return p


def _axial_attention(sd, tname):
    """MultiHeadAttention(axial): w_qs/w_ks/w_vs (no bias) + fc."""
    return {
        "wq": {"kernel": linear_kernel(sd[f"{tname}.w_qs.weight"])},
        "wk": {"kernel": linear_kernel(sd[f"{tname}.w_ks.weight"])},
        "wv": {"kernel": linear_kernel(sd[f"{tname}.w_vs.weight"])},
        "fc": {"kernel": linear_kernel(sd[f"{tname}.fc.weight"]),
               "bias": sd[f"{tname}.fc.bias"]},
    }


def _res_block(sd, tname):
    """AttentionResidualBlock: Sequential(BN, ReLU, conv3, BN, ReLU, conv1,
    BN, ReLU, AxialBlock) (videogpt_vq_vae.py:122-138)."""
    params, stats = {}, {}
    for flax_name, idx in (("bn1", 0), ("bn2", 3), ("bn3", 6)):
        p, s = bn_params(sd, f"{tname}.block.{idx}")
        params[flax_name], stats[flax_name] = p, s
    params["conv1"] = _same_pad_conv(sd, f"{tname}.block.2")
    params["conv2"] = _same_pad_conv(sd, f"{tname}.block.5")
    params["axial"] = {
        a: _axial_attention(sd, f"{tname}.block.8.{a}")
        for a in ("attn_w", "attn_h", "attn_t")}
    return params, stats


def _coder(sd, prefix, n_res_layers, transpose: bool):
    params, stats = {}, {}
    i = 0
    key = "convts" if transpose else "convs"
    while f"{prefix}.{key}.{i}." + ("convt" if transpose else "conv") \
            + ".weight" in sd:
        tname = f"{prefix}.{key}.{i}." + ("convt" if transpose else "conv")
        kern = (conv_transpose3d_kernel if transpose else conv3d_kernel)(
            sd[f"{tname}.weight"])
        p = {"kernel": kern}
        if f"{tname}.bias" in sd:
            p["bias"] = sd[f"{tname}.bias"]
        params[("convt" if transpose else "conv") + str(i)] = p
        i += 1
    if not transpose:
        params["conv_last"] = _same_pad_conv(sd, f"{prefix}.conv_last")
    for r in range(n_res_layers):
        params[f"res{r}"], stats[f"res{r}"] = _res_block(
            sd, f"{prefix}.res_stack.{r}")
    p, s = bn_params(sd, f"{prefix}.res_stack.{n_res_layers}")
    params["bn_out"], stats["bn_out"] = p, s
    return params, stats


def _vqvae_tree(sd: Mapping[str, np.ndarray], n_res_layers: int) -> dict:
    """-> {'params', 'batch_stats', 'codebook'}: the JAX converter's tree."""
    sd = strip_prefix(dict(sd), "generator.")
    enc_p, enc_s = _coder(sd, "encoder", n_res_layers, transpose=False)
    dec_p, dec_s = _coder(sd, "decoder", n_res_layers, transpose=True)
    params = {
        "encoder": enc_p,
        "decoder": dec_p,
        "pre_vq_conv": _same_pad_conv(sd, "pre_vq_conv"),
        "post_vq_conv": _same_pad_conv(sd, "post_vq_conv"),
    }
    stats = {"encoder": enc_s, "decoder": dec_s}
    codebook = {"codebook": {
        "embeddings": np.asarray(sd["codebook.embeddings"], np.float32),
        "ema_count": np.asarray(sd["codebook.N"], np.float32),
        "ema_sum": np.asarray(sd["codebook.z_avg"], np.float32),
        "initialized": np.asarray(True),
    }}
    return {"params": params, "batch_stats": stats, "codebook": codebook}


def convert_vqvae(sd: Mapping[str, np.ndarray], n_res_layers: int
                  ) -> dict[str, torch.Tensor]:
    """A reference-keyed state dict -> the port's ``VQVAE`` state dict."""
    t = _vqvae_tree(sd, n_res_layers)
    return vqvae_state_dict(t["params"], t["batch_stats"], t["codebook"])


def convert_vqvae_file(path: str, n_res_layers: int
                       ) -> dict[str, torch.Tensor]:
    return convert_vqvae(load_torch_state_dict(path), n_res_layers)
