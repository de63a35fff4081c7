"""A dense layer with flax ``nn.Dense``'s compute dtype, the dtype names of
the configurations, and the inference BatchNorm of the frozen networks.

The JAX package's models take a compute ``dtype`` (``bfloat16`` in the
bench's training rows): the parameters stay f32, and every ``nn.Dense``
built with ``dtype=bf16`` casts its input, kernel and bias to bf16, rounds
the product to bf16 and adds the bias in bf16. :class:`Dense` does the same
in front of ``F.linear``; in f32 it is ``nn.Linear``. Its parameters keep
``nn.Linear``'s names, so the weight bridge maps a flax ``Dense`` onto it.

:func:`parallel_mlp` is a two-layer MLP in Megatron's tensor-parallel form
where its weights are sharded over the model group
(:func:`..parallel.mesh.shard_module_`).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.distributed import (copy_to_group, model_group,
                                    reduce_from_group)

__all__ = ["Dense", "FrozenBatchNorm", "compute_dtype", "parallel_mlp"]


def compute_dtype(name) -> torch.dtype:
    """A configuration's ``dtype`` entry -> the torch compute dtype, by the
    JAX package's rule: ``bfloat16`` / ``bf16`` is bf16, anything else
    f32."""
    return torch.bfloat16 if str(name) in ("bfloat16", "bf16") \
        else torch.float32


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` on f32 parameters, as flax's
    ``nn.Dense(dtype=...)``: the output is in ``dtype``; gradients reach the
    f32 parameters through the casts.

    The bias add runs as XLA runs flax's under ``jit`` (:meth:`add_bias`):
    the product rounded to ``dtype``, the bias added in f32 and the sum
    rounded to ``dtype`` once; ``rounded=False``, for a layer whose output
    goes straight into an f32 residual add, leaves the sum in f32, as XLA
    fuses that bias add into the residual add's f32 chain. Backward, the
    bias's gradient sums the ``dtype`` cotangents in f32."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 rounded: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.rounded = rounded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        return self.add_bias(F.linear(x.to(dt), self.weight.to(dt)))

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` (the product in the compute dtype) plus the bias: rounded
        to the compute dtype, or left in f32 where not ``rounded``. The bias
        is expanded to ``y``'s shape before its casts, so that autograd
        takes each cotangent element to the compute dtype first and sums
        the bias's gradient in f32 after, as XLA does (and no Python-level
        Function adds to the host's time a step)."""
        if self.bias is None:
            return y
        b = self.bias.expand_as(y).to(self.compute_dtype)
        # a 16-bit add computes in f32 and rounds once
        return y + b if self.rounded else y.float() + b.float()


class FrozenBatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)`` over the channel axis
    1 of an NC... tensor: ``(x - mean) / sqrt(var + eps) * scale + bias``,
    the running statistics as buffers (the bridge's names), no
    ``num_batches_tracked``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def parallel_mlp(x: torch.Tensor, fc: nn.Linear, proj: nn.Linear,
                 act: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``proj(act(fc(x)))``. Where ``fc``'s weight is sharded by its output
    columns (``tp_dim``, with its bias and ``proj``'s weight by its input
    rows), Megatron's form over the model group: ``fc`` and ``act`` run on
    this rank's columns (its input's gradient summed over the group),
    ``proj``'s partial products are summed over the group in f32 and
    rounded once to the compute dtype, and ``proj``'s whole bias is added
    once, after the sum: the one-rank layer's arithmetic up to the order of
    an f32 sum."""
    if getattr(fc.weight, "tp_dim", None) is None:
        return proj(act(fc(x)))
    group = model_group()
    h = act(fc(copy_to_group(x, group)))
    dt = getattr(proj, "compute_dtype", torch.float32)
    part = F.linear(h.to(dt).float(), proj.weight.to(dt).float())
    y = reduce_from_group(part, group).to(dt)
    if isinstance(proj, Dense):
        return proj.add_bias(y)
    return y if proj.bias is None else y + proj.bias.to(dt)
