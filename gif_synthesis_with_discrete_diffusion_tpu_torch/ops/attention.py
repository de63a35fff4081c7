"""Multi-head attention for the D3PM denoiser: CUDA kernels for the forward
and the backward, and their plain versions.

``fused_mha`` replaces the TPU's differentiable ``gif_synthesis_with_
discrete_diffusion_tpu/ops/attention.py: fused_mha``. Its forward is
``csrc/fused_mha_fwd.cu`` (the TPU's ``_kernel``); its backward, through a
``torch.autograd.Function``, is ``csrc/fused_mha_bwd.cu`` (the TPU's
``_bwd_kernel``), reached by :func:`fused_mha_bwd`. Both are built by nvcc
for ``sm_90a`` at first use and bound through ctypes. CPU tensors take the
same Function with the plain versions, :func:`sdpa_reference` forward and
:func:`fused_mha_bwd_reference` backward. The source files say what bounds
each kernel on Hopper and how its design answers that.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build

__all__ = ["fused_mha", "fused_mha_bwd", "fused_mha_bwd_reference",
           "sdpa_reference", "kv_splits"]

_HEAD_DIMS = (4, 8)   # the kernels' instantiations (csrc/fused_mha_*.cu)
# the dK/dV kernel cuts the queries into chunks of this many rows when there
# are too few keys to fill the card (csrc/fused_mha_bwd.cu)
_KV_SPLIT_ROWS = 64
_KV_SPLIT_MIN_KEYS = 256


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


def fused_mha_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor, n_head: int
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the backward, the TPU kernel's formulas written out:
    recompute P; dV = P^T dO; dP = dO V^T; dS = P (dP - rowsum(dP P));
    dQ = scale dS K; dK = dS^T (scale q). Returns (dq, dk, dv) like q, k, v.
    """
    B, Lq, C = q.shape
    Lk = k.shape[1]
    d = C // n_head
    scale = 1.0 / math.sqrt(d)
    qh = q.reshape(B, Lq, n_head, d).float() * scale
    kh = k.reshape(B, Lk, n_head, d).float()
    vh = v.reshape(B, Lk, n_head, d).float()
    doh = do.reshape(B, Lq, n_head, d).float()
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh), dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, doh)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    return (dq.reshape(B, Lq, C).to(q.dtype), dk.reshape(B, Lk, C).to(k.dtype),
            dv.reshape(B, Lk, C).to(v.dtype))


def kv_splits(lq: int, lk: int) -> int:
    """How many query chunks the dK/dV kernel sums apart: 1 with enough
    keys to fill the card, else one chunk per 64 queries (cross-attention
    over 1 or 77 condition tokens)."""
    if lk >= _KV_SPLIT_MIN_KEYS:
        return 1
    return max(1, -(-lq // _KV_SPLIT_ROWS))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_mha_fwd.cu")
    lib.fused_mha_fwd.argtypes = ([ctypes.c_void_p] * 5
                                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.fused_mha_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_mha_bwd.cu")
    lib.fused_mha_bwd.argtypes = ([ctypes.c_void_p] * 10
                                  + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fused_mha_bwd.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, q: torch.Tensor, kvs: tuple, n_head: int
                ) -> None:
    """The kernels' contract: f32, contiguous, 16-byte aligned tensors on the
    current device, head dim C // n_head of 4 or 8."""
    if q.device.type != "cuda" or \
            q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: no kernel for {q.device} (the current "
                         f"device is cuda:{torch.cuda.current_device()})")
    B, Lq, C = q.shape
    k = kvs[0]
    if k.ndim != 3 or k.shape[0] != B or k.shape[2] != C or k.shape[1] < 1:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if C % n_head or C // n_head not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {C}/{n_head} not in "
                         f"{_HEAD_DIMS}")
    for i, x in enumerate((q, *kvs)):
        if x.device != q.device:
            raise ValueError(f"{name}: inputs on different devices")
        if x.dtype != torch.float32 or not x.is_contiguous() or \
                x.data_ptr() % 16:
            raise TypeError(f"{name}: input {i} must be f32, contiguous and "
                            f"16-byte aligned")


def _fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                n_head: int, with_lse: bool
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One launch of K2: (o, lse (B, H, Lq) base-2 log-sum-exp or None)."""
    if k.shape != v.shape:
        raise ValueError(f"fused_mha: shapes k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    _check_cuda("fused_mha", q, (k, v), n_head)
    B, Lq, C = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((B, n_head, Lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = _library().fused_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None, B, Lq, k.shape[1], C,
        n_head, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_mha_fwd launch failed: cudaError {err}")
    fused_mha.launches += 1
    return o, lse


def fused_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor | None,
                  do: torch.Tensor, *, n_head: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``o = fused_mha(q, k, v)`` for the output
    gradient ``do``.

    CPU tensors take :func:`fused_mha_bwd_reference` (``o`` and ``lse`` are
    not read). CUDA tensors launch ``csrc/fused_mha_bwd.cu`` with ``o`` and
    the forward's ``lse``; they must meet the forward's contract. Each
    launch adds one to ``fused_mha_bwd.launches``."""
    if q.device.type == "cpu":
        return fused_mha_bwd_reference(q, k, v, do, n_head)
    if lse is None:
        raise ValueError("fused_mha_bwd: the kernel needs the forward's lse")
    B, Lq, C = q.shape
    Lk = k.shape[1]
    if k.shape != v.shape or o.shape != q.shape or do.shape != q.shape or \
            tuple(lse.shape) != (B, n_head, Lq):
        raise ValueError("fused_mha_bwd: shapes of q, k, v, o, lse, do")
    _check_cuda("fused_mha_bwd", q, (k, v, o, lse, do), n_head)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    splits = kv_splits(Lq, Lk)
    scratch = (torch.empty((2, splits, B, Lk, C), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    err = _bwd_library().fused_mha_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        B, Lq, Lk, C, n_head, splits,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_mha_bwd launch failed: cudaError {err}")
    fused_mha_bwd.launches += 1
    return dq, dk, dv


fused_mha_bwd.launches = 0


class _FusedMHA(torch.autograd.Function):
    """Forward K2 (keeping its log-sum-exp), backward K5; on CPU tensors the
    plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, n_head):
        if q.device.type == "cpu":
            o, lse = sdpa_reference(q, k, v, n_head), None
        else:
            o, lse = _fwd_kernel(q, k, v, n_head, with_lse=True)
        ctx.n_head = n_head
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # the output gradient may arrive strided; the kernel reads it dense
        dq, dk, dv = fused_mha_bwd(q, k, v, o, lse, do.contiguous(),
                                   n_head=ctx.n_head)
        return dq, dk, dv, None


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              n_head: int) -> torch.Tensor:
    """q: (B, Lq, C); k/v: (B, Lk, C) -> (B, Lq, C), softmax(QK^T/sqrt(d))V.

    Differentiable: with gradients on, the backward is K5 (or its plain
    version on the CPU). CUDA tensors must be f32, contiguous, on the current
    device, with head dim C // n_head of 4 or 8; each forward launch adds one
    to ``fused_mha.launches``."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        return _FusedMHA.apply(q, k, v, n_head)
    if q.device.type == "cpu":
        return sdpa_reference(q, k, v, n_head)
    return _fwd_kernel(q, k, v, n_head, with_lse=False)[0]


fused_mha.launches = 0
