"""A reference stage-2 checkpoint (DiffusionTransformer +
Text2ImageTransformer) -> the port's generator state dict, its ``diffusion``
part.

The port's copy of ``gif_synthesis_with_discrete_diffusion_tpu/convert/
torch_d3pm.py``. The reference tree (prefix ``generator.diffusion_model.``):
``transformer.blocks.{i}.*`` selfcross blocks, ``transformer.content_emb.*``
the Dalle embedding, ``transformer.to_logits.{0,1}`` the head,
``empty_text_embed``, and the ``Lt_history`` / ``Lt_count`` buffers. The
schedule's buffers (log_at...) are recomputed, not loaded. The result's
names are those of :class:`..models.discrete_diffusion.
DiscreteDiffusionModel` (``diffusion.transformer.block0...``,
``diffusion.lt_history``); the conditioner and the telemetry buffers are
not in the reference's checkpoint, so it loads with ``strict=False``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .common import linear_kernel, load_torch_state_dict, strip_prefix
from .from_flax import flax_to_state_dict

__all__ = ["convert_d3pm", "convert_d3pm_file"]


def _dense(sd, tname):
    return {"kernel": linear_kernel(sd[f"{tname}.weight"]),
            "bias": sd[f"{tname}.bias"]}


def _ada_ln(sd, tname):
    return {"linear": _dense(sd, f"{tname}.linear")}


def _attn(sd, tname):
    return {n: _dense(sd, f"{tname}.{n}")
            for n in ("key", "query", "value", "proj")}


def _layer_norm(sd, tname):
    return {"scale": sd[f"{tname}.weight"], "bias": sd[f"{tname}.bias"]}


def _block(sd, tname):
    return {
        "ln1": _ada_ln(sd, f"{tname}.ln1"),
        "ln1_1": _ada_ln(sd, f"{tname}.ln1_1"),
        "ln2": _layer_norm(sd, f"{tname}.ln2"),
        "attn1": _attn(sd, f"{tname}.attn1"),
        "attn2": _attn(sd, f"{tname}.attn2"),
        "mlp_fc": _dense(sd, f"{tname}.mlp.0"),
        "mlp_proj": _dense(sd, f"{tname}.mlp.2"),
    }


def _d3pm_tree(sd: Mapping[str, np.ndarray]) -> dict:
    """-> {'params': {'diffusion': ...}, 'diffusion': Lt buffers}: the JAX
    converter's tree."""
    sd = strip_prefix(dict(sd), "generator.")
    sd = strip_prefix(sd, "diffusion_model.")
    t = "transformer"
    n_layer = 0
    while f"{t}.blocks.{n_layer}.ln2.weight" in sd:
        n_layer += 1
    tr = {f"block{i}": _block(sd, f"{t}.blocks.{i}")
          for i in range(n_layer)}
    tr["content_emb"] = {
        "emb": {"embedding": sd[f"{t}.content_emb.emb.weight"]},
        "height_emb": {"embedding": sd[f"{t}.content_emb.height_emb.weight"]},
        "width_emb": {"embedding": sd[f"{t}.content_emb.width_emb.weight"]},
    }
    tr["ln_out"] = _layer_norm(sd, f"{t}.to_logits.0")
    tr["to_logits"] = _dense(sd, f"{t}.to_logits.1")

    d3pm_params: dict = {"transformer": tr}
    if "empty_text_embed" in sd:
        d3pm_params["empty_text_embed"] = np.asarray(
            sd["empty_text_embed"], np.float32)

    diffusion_state = {"diffusion": {
        "lt_history": np.asarray(sd.get("Lt_history"), np.float32),
        "lt_count": np.asarray(sd.get("Lt_count"), np.float32),
    }} if "Lt_history" in sd else {}

    out = {"params": {"diffusion": d3pm_params}}
    if diffusion_state:
        out["diffusion"] = diffusion_state
    return out


def convert_d3pm(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A reference-keyed state dict -> the port's generator state dict."""
    t = _d3pm_tree(sd)
    return flax_to_state_dict(t["params"], buffers=t.get("diffusion"))


def convert_d3pm_file(path: str) -> dict[str, torch.Tensor]:
    return convert_d3pm(load_torch_state_dict(path))
