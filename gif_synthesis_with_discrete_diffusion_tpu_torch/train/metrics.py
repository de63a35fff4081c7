"""Weighted loss computation and cross-step metric accumulation.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/train/metrics.py``: the
registry (``l_dummy``: the VQ-VAE's reconstruction plus commitment loss
over a mapping of losses, else the diffusion loss; ``l_codebook``,
``l_entropy``, ``l_perplexity``: the VQ-VAE's monitors),
:func:`register_loss`, :func:`weighted_losses` (the weighted differentiable
total), :func:`loss_log_name` and :class:`MetricAccumulator`, which sums
the steps' device tensors on the device and reads them to the host once, in
:meth:`MetricAccumulator.compute`. In a data-parallel run each rank's step
values are its rows' means; :meth:`MetricAccumulator.compute` averages the
sums over the ranks first (one all-reduce), which gives the global batch's
means that the JAX package's global arrays give.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from ..parallel.distributed import all_reduce_sum, data_group, group_size

__all__ = ["LOSS_REGISTRY", "register_loss", "weighted_losses",
           "MetricAccumulator", "loss_log_name"]


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


def register_loss(name: str,
                  fn: Callable[[Mapping[str, Any]], torch.Tensor]):
    LOSS_REGISTRY[name] = fn
    return fn


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


def loss_log_name(loss: str, split: str) -> str:
    """'l_dummy', 'train' -> 'l/dummy/train'; 'total' -> 'total/train'."""
    if loss == "total":
        return f"{loss}/{split}"
    loss_type, _, name = loss.partition("_")
    return f"{loss_type}/{name}/{split}"


class MetricAccumulator:
    """Running sums of named scalars and a step count. :meth:`update` adds
    a step's values (0-d tensors on any one device, or numbers) without
    reading them; :meth:`compute` returns the means as floats, one host
    read for all of them, after the sums are averaged over the ranks of a
    process group (every rank has the same count)."""

    def __init__(self, names):
        self.names = list(names)
        self.sums: dict[str, torch.Tensor | float] = dict.fromkeys(
            self.names, 0.0)
        self.count = 0

    def update(self, values: Mapping[str, Any]) -> "MetricAccumulator":
        for n in self.names:
            v = values[n]
            if isinstance(v, torch.Tensor):
                v = v.detach().to(torch.float32)
            self.sums[n] = self.sums[n] + v
        self.count += 1
        return self

    def compute(self) -> dict[str, float]:
        c = float(max(self.count, 1))
        sums = [torch.as_tensor(self.sums[n], dtype=torch.float32)
                for n in self.names]
        if not sums:
            return {}
        device = next((s.device for s in sums if s.device.type != "cpu"),
                      torch.device("cpu"))
        group = data_group()
        stacked = all_reduce_sum(torch.stack([s.to(device) for s in sums]),
                                 group)
        means = (stacked / (c * group_size(group))).tolist()
        return dict(zip(self.names, means))
