"""Weighted loss computation over a registry of named losses.

Port of the loss half of ``gif_synthesis_with_discrete_diffusion_tpu/train/
metrics.py``: the registry (``l_dummy``: the VQ-VAE's reconstruction plus
commitment loss over a mapping of losses, else the diffusion loss;
``l_codebook``, ``l_entropy``, ``l_perplexity``: the VQ-VAE's monitors) and
:func:`weighted_losses`, the weighted differentiable total. The cross-step
accumulator and the log names belong to the trainer loop (ROADMAP queue 1,
item 15).
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

__all__ = ["LOSS_REGISTRY", "weighted_losses"]


def _l_dummy(output: Mapping[str, Any]) -> torch.Tensor:
    """Reconstruction plus commitment loss for the VQ-VAE, else the
    diffusion loss."""
    losses = output["losses"]
    if isinstance(losses, Mapping):
        return torch.mean(losses["recon_loss"] + losses["commitment_loss"])
    return torch.mean(losses)


def _l_codebook(output: Mapping[str, Any]) -> torch.Tensor:
    return torch.sum(output["codebook_loss"])


def _l_entropy(output: Mapping[str, Any]) -> torch.Tensor:
    return torch.sum(output["entropy"])


def _l_perplexity(output: Mapping[str, Any]) -> torch.Tensor:
    return torch.sum(output["metrics"]["perplexity"])


LOSS_REGISTRY: dict[str, Callable[[Mapping[str, Any]], torch.Tensor]] = {
    "l_dummy": _l_dummy,
    "l_codebook": _l_codebook,
    "l_entropy": _l_entropy,
    "l_perplexity": _l_perplexity,
}


def weighted_losses(loss_dict: Mapping[str, float],
                    output: Mapping[str, Any]
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Compute every configured loss; return (weighted total, values), with
    the total under ``values["total"]`` too."""
    values: dict[str, torch.Tensor] = {}
    # a 0-d CPU tensor adds to a tensor on any device
    total = torch.zeros((), dtype=torch.float32)
    for name, weight in loss_dict.items():
        if name == "total":
            continue
        val = LOSS_REGISTRY[name](output)
        values[name] = val
        total = total + float(weight) * val
    values["total"] = total
    return total, values
