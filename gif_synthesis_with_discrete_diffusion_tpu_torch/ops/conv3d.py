"""Same-pad 3D convolutions on channels-last (B, D, H, W, C) tensors.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/ops/conv3d.py``, which
has no Pallas kernel (XLA ran these convolutions), so cuDNN runs them here.
For kernel ``k`` and stride ``s`` the total padding per dim is ``k - s``,
split ``(ceil(p/2), floor(p/2))``: the extra pad goes in front.

Activations keep the JAX package's channels-last layout at these functions;
inside, the (B, C, D, H, W) view of a channels-last tensor is what cuDNN
gets, so no layout copy is made. Weights are in PyTorch's layouts:

* conv: ``(O, I, kD, kH, kW)`` (flax DHWIO transposed by the bridge);
* transposed conv: ``(I, O, kD, kH, kW)``, the ``F.conv_transpose3d`` layout
  of the reference formulation (pre-pad, then ``padding = k - 1``). The flax
  kernel is in forward orientation DHWIO; the bridge permutes it
  ``(3, 4, 0, 1, 2)``.

The modules take the JAX modules' compute ``dtype``: the parameters stay
f32; under bf16 the input and the kernel are cast to bf16, the convolution
gives bf16 (cuDNN accumulates in f32), and the bias is added in bf16.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["same_pad", "same_pad_conv3d", "same_pad_conv_transpose3d",
           "SamePadConv3d", "SamePadConvTranspose3d"]


def _triple(v: int | Sequence[int]) -> tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"expected 3 spatial dims, got {t}")
    return t  # type: ignore[return-value]


def same_pad(kernel_size, stride) -> list[tuple[int, int]]:
    """Per-dim (before, after) padding with total ``k - s``, extra in front."""
    pads = []
    for k, s in zip(_triple(kernel_size), _triple(stride)):
        p = k - s
        if p < 0:
            raise ValueError(f"kernel {k} < stride {s} unsupported")
        pads.append((p // 2 + p % 2, p // 2))
    return pads


def _f_pad(pads: list[tuple[int, int]]) -> list[int]:
    """(D, H, W) pads -> F.pad's last-dim-first flat list."""
    return [p for pair in reversed(pads) for p in pair]


def same_pad_conv3d(x: torch.Tensor, w: torch.Tensor, stride=1,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, D, H, W, Cin); w: (Cout, Cin, kD, kH, kW)."""
    st = _triple(stride)
    pads = same_pad(w.shape[2:], st)
    xc = x.permute(0, 4, 1, 2, 3)
    if all(a == b for a, b in pads):
        y = F.conv3d(xc, w, bias, st, padding=tuple(a for a, _ in pads))
    else:
        y = F.conv3d(F.pad(xc, _f_pad(pads)), w, bias, st)
    return y.permute(0, 2, 3, 4, 1)


def same_pad_conv_transpose3d(x: torch.Tensor, w: torch.Tensor, stride=1,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """x: (B, D, H, W, Cin); w: (Cin, Cout, kD, kH, kW). Pre-pads by
    ``same_pad`` then runs ``conv_transpose3d(padding=k-1)``: on a stride-1
    axis with k = 4 that pad is (2, 1), which no symmetric padding gives."""
    st = _triple(stride)
    ks = tuple(w.shape[2:])
    xc = F.pad(x.permute(0, 4, 1, 2, 3), _f_pad(same_pad(ks, st)))
    y = F.conv_transpose3d(xc, w, bias, st, padding=tuple(k - 1 for k in ks))
    return y.permute(0, 2, 3, 4, 1)


def _conv_in(conv, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` of a module's input in its compute dtype: f32 as it is
    (the bias inside the convolution), else input and kernel cast to the
    dtype and the bias added in it, as the flax module does."""
    dt = module.compute_dtype
    if dt == torch.float32:
        return conv(x, module.weight, module.stride, module.bias)
    y = conv(x.to(dt), module.weight.to(dt), module.stride)
    return y if module.bias is None else y + module.bias.to(dt)


class SamePadConv3d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | Sequence[int], stride=1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.stride = _triple(stride)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, *_triple(kernel_size)))
        self.bias = (nn.Parameter(torch.empty(out_channels)) if use_bias
                     else None)

    def fan_in(self) -> int:
        return self.weight[0].numel()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_in(same_pad_conv3d, self, x)


class SamePadConvTranspose3d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | Sequence[int], stride=1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.stride = _triple(stride)
        self.weight = nn.Parameter(torch.empty(
            in_channels, out_channels, *_triple(kernel_size)))
        self.bias = (nn.Parameter(torch.empty(out_channels)) if use_bias
                     else None)

    def fan_in(self) -> int:
        """flax's fan-in of the DHWIO kernel: kD*kH*kW*Cin."""
        return self.weight[:, 0].numel()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_in(same_pad_conv_transpose3d, self, x)
