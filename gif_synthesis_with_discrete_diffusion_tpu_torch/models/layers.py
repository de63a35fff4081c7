"""A dense layer with flax ``nn.Dense``'s compute dtype, the dtype names of
the configurations, and the inference BatchNorm of the frozen networks.

The JAX package's models take a compute ``dtype`` (``bfloat16`` in the
bench's training rows): the parameters stay f32, and every ``nn.Dense``
built with ``dtype=bf16`` casts its input, kernel and bias to bf16, rounds
the product to bf16 and adds the bias in bf16. :class:`Dense` does the same
in front of ``F.linear``; in f32 it is ``nn.Linear``. Its parameters keep
``nn.Linear``'s names, so the weight bridge maps a flax ``Dense`` onto it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Dense", "FrozenBatchNorm", "compute_dtype"]


def compute_dtype(name) -> torch.dtype:
    """A configuration's ``dtype`` entry -> the torch compute dtype, by the
    JAX package's rule: ``bfloat16`` / ``bf16`` is bf16, anything else
    f32."""
    return torch.bfloat16 if str(name) in ("bfloat16", "bf16") \
        else torch.float32


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` on f32 parameters, as flax's
    ``nn.Dense(dtype=...)``: the output is in ``dtype``; gradients reach the
    f32 parameters through the casts."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


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
