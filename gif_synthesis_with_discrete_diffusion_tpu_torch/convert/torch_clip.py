"""An OpenAI CLIP checkpoint's text tower -> the port's ``ClipTextModel``
state dict.

The port's copy of ``gif_synthesis_with_discrete_diffusion_tpu/convert/
torch_clip.py`` (the reference loads the frozen ViT-B/32 through the
``clip`` package), bridged by :func:`.from_flax.flax_to_state_dict`. A
library function, as in the JAX package: no entry reads it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .common import linear_kernel, load_torch_state_dict
from .from_flax import flax_to_state_dict

__all__ = ["convert_clip_text", "convert_clip_text_file"]


def _layer_norm(sd, tname):
    return {"scale": np.asarray(sd[f"{tname}.weight"], np.float32),
            "bias": np.asarray(sd[f"{tname}.bias"], np.float32)}


def _resblock(sd, tname, width: int, heads: int):
    hd = width // heads
    in_w = np.asarray(sd[f"{tname}.attn.in_proj_weight"], np.float32)
    in_b = np.asarray(sd[f"{tname}.attn.in_proj_bias"], np.float32)
    qw, kw, vw = np.split(in_w, 3, axis=0)
    qb, kb, vb = np.split(in_b, 3, axis=0)

    def qkv(w, b):
        return {"kernel": w.T.reshape(width, heads, hd),
                "bias": b.reshape(heads, hd)}

    out_w = np.asarray(sd[f"{tname}.attn.out_proj.weight"], np.float32)
    out_b = np.asarray(sd[f"{tname}.attn.out_proj.bias"], np.float32)
    return {
        "ln_1": _layer_norm(sd, f"{tname}.ln_1"),
        "ln_2": _layer_norm(sd, f"{tname}.ln_2"),
        "attn": {
            "query": qkv(qw, qb), "key": qkv(kw, kb), "value": qkv(vw, vb),
            "out": {"kernel": out_w.T.reshape(heads, hd, width),
                    "bias": out_b},
        },
        "mlp_fc": {"kernel": linear_kernel(
            np.asarray(sd[f"{tname}.mlp.c_fc.weight"], np.float32)),
            "bias": np.asarray(sd[f"{tname}.mlp.c_fc.bias"], np.float32)},
        "mlp_proj": {"kernel": linear_kernel(
            np.asarray(sd[f"{tname}.mlp.c_proj.weight"], np.float32)),
            "bias": np.asarray(sd[f"{tname}.mlp.c_proj.bias"], np.float32)},
    }


def _clip_text_tree(sd: Mapping[str, np.ndarray], width: int = 512,
                   heads: int = 8, layers: int = 12) -> dict:
    """-> the flax params of ClipTextModel: the JAX converter's tree."""
    params: dict = {
        "token_embedding": {"embedding": np.asarray(
            sd["token_embedding.weight"], np.float32)},
        "positional_embedding": np.asarray(
            sd["positional_embedding"], np.float32),
        "ln_final": _layer_norm(sd, "ln_final"),
        "text_projection": np.asarray(sd["text_projection"], np.float32),
    }
    for i in range(layers):
        params[f"resblock{i}"] = _resblock(
            sd, f"transformer.resblocks.{i}", width, heads)
    return params


def convert_clip_text(sd: Mapping[str, np.ndarray], width: int = 512,
                      heads: int = 8, layers: int = 12
                      ) -> dict[str, torch.Tensor]:
    """A reference-keyed state dict -> the port's CLIP text tower's."""
    return flax_to_state_dict(_clip_text_tree(sd, width, heads, layers))


def convert_clip_text_file(path: str, width: int = 512, heads: int = 8,
                           layers: int = 12) -> dict[str, torch.Tensor]:
    return convert_clip_text(load_torch_state_dict(path), width,
                             heads, layers)
