"""Weighted loss computation over a registry of named losses.

Port of the loss half of ``gif_synthesis_with_discrete_diffusion_tpu/train/
metrics.py`` as stage 2 reads it: the ``l_dummy`` entry (the diffusion
loss) and :func:`weighted_losses`, the weighted differentiable total. The
VQ-VAE's entries belong to stage-1 training (ROADMAP queue 1, item 11); the
cross-step accumulator and the log names to the trainer loop (item 15).
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

__all__ = ["LOSS_REGISTRY", "weighted_losses"]


def _l_dummy(output: Mapping[str, Any]) -> torch.Tensor:
    """The diffusion loss."""
    return torch.mean(output["losses"])


LOSS_REGISTRY: dict[str, Callable[[Mapping[str, Any]], torch.Tensor]] = {
    "l_dummy": _l_dummy,
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
