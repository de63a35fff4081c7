"""Multi-head attention for the D3PM denoiser: a CUDA kernel and its plain
version.

``fused_mha`` replaces the TPU kernel ``gif_synthesis_with_discrete_
diffusion_tpu/ops/attention.py: _kernel`` (the forward of ``fused_mha``).
For CUDA tensors it launches ``csrc/fused_mha_fwd.cu`` (built by nvcc for
``sm_90a`` at first use, bound through ctypes); for CPU tensors it runs
:func:`sdpa_reference`. The source file says what bounds the kernel on
Hopper and how its design answers that. There is no backward yet: the
training path (the TPU's ``_bwd_kernel``) is not ported.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build

__all__ = ["fused_mha", "sdpa_reference"]

_HEAD_DIMS = (4, 8)   # the kernel's instantiations (csrc/fused_mha_fwd.cu)


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   n_head: int) -> torch.Tensor:
    """Plain version. q: (B, Lq, C); k/v: (B, Lk, C). Returns (B, Lq, C)."""
    B, Lq, C = q.shape
    Lk = k.shape[1]
    d = C // n_head
    qh = q.reshape(B, Lq, n_head, d)
    kh = k.reshape(B, Lk, n_head, d)
    vh = v.reshape(B, Lk, n_head, d)
    att = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(d)
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", att, vh)
    return out.reshape(B, Lq, C)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_mha_fwd.cu")
    lib.fused_mha_fwd.argtypes = ([ctypes.c_void_p] * 4
                                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.fused_mha_fwd.restype = ctypes.c_int
    return lib


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              n_head: int) -> torch.Tensor:
    """q: (B, Lq, C); k/v: (B, Lk, C) -> (B, Lq, C), softmax(QK^T/sqrt(d))V.

    CPU tensors take :func:`sdpa_reference`. CUDA tensors must be f32,
    contiguous, on the current device, with head dim C // n_head of 4 or 8;
    each launch adds one to ``fused_mha.launches``."""
    if q.device.type == "cpu":
        return sdpa_reference(q, k, v, n_head)
    B, Lq, C = q.shape
    if q.device.type != "cuda" or \
            q.device.index != torch.cuda.current_device():
        raise ValueError(f"fused_mha: no kernel for {q.device} (the current "
                         f"device is cuda:{torch.cuda.current_device()})")
    if k.device != q.device or v.device != q.device:
        raise ValueError("fused_mha: q, k and v on different devices")
    if k.shape != v.shape or k.ndim != 3 or k.shape[0] != B or \
            k.shape[2] != C or k.shape[1] < 1:
        raise ValueError(f"fused_mha: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if C % n_head or C // n_head not in _HEAD_DIMS:
        raise ValueError(f"fused_mha: head dim {C}/{n_head} not in "
                         f"{_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32 or not x.is_contiguous() or \
                x.data_ptr() % 16:
            raise TypeError(f"fused_mha: {name} must be f32, contiguous and "
                            f"16-byte aligned")
    o = torch.empty_like(q)
    err = _library().fused_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Lq,
        k.shape[1], C, n_head, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_mha_fwd launch failed: cudaError {err}")
    fused_mha.launches += 1
    return o


fused_mha.launches = 0
