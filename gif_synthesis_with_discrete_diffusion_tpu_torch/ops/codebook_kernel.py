"""VQ codebook lookup with its usage statistics: a CUDA kernel and its plain
version.

``nearest_code_stats`` replaces the TPU kernel ``gif_synthesis_with_
discrete_diffusion_tpu/ops/codebook_kernel.py: _kernel`` (via
``nearest_code_stats``). For CUDA tensors it launches
``csrc/nearest_code_stats.cu`` (nvcc for ``sm_90a`` at first use, bound
through ctypes), whose distances run on the tensor cores in split TF32
(:func:`nearest_code_stats_kernel_arithmetic` states that arithmetic); for
CPU tensors it runs :func:`nearest_code_stats_reference`.
Both return

* ``indices``    (N,)   int32 — the nearest code of each row (the first on
  ties, as ``jnp.argmin``);
* ``n_total``    (K,)   f32   — how many rows chose each code;
* ``encode_sum`` (K, D) f32   — the sum of the rows that chose each code.

The inputs are detached: the indices are discrete and the statistics feed
no-grad buffer updates, as the JAX side's ``stop_gradient`` says.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build
from .megakernel import split_tf32

__all__ = ["nearest_code_stats", "nearest_code_stats_reference",
           "nearest_code_stats_kernel_arithmetic", "kernel_distances",
           "code_stats_reference"]

_MAX_DIM = 384   # csrc/nearest_code_stats.cu: kMaxD


def code_stats_reference(x: torch.Tensor, indices: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_total, encode_sum) of rows ``x`` (N, D) assigned to ``indices``."""
    onehot = F.one_hot(indices.long(), k).to(torch.float32)
    return onehot.sum(dim=0), onehot.t() @ x.float()


def nearest_code_stats_reference(x: torch.Tensor, embeddings: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain version. x: (N, D); embeddings: (K, D)."""
    x = x.detach().float()
    e = embeddings.detach().float()
    dist = -2.0 * (x @ e.t()) + (e * e).sum(dim=-1)[None, :]
    indices = torch.argmin(dist, dim=1).to(torch.int32)
    return (indices, *code_stats_reference(x, indices, e.shape[0]))


def kernel_distances(x: torch.Tensor, embeddings: torch.Tensor
                     ) -> torch.Tensor:
    """(N, K) distances ``||e||^2 - 2 x.e`` as the kernel takes them: each
    f32 value split into TF32 hi + lo (``split_tf32``), the product summed as
    hi.lo + lo.hi + hi.hi in f32 (lo.lo, ~2^-22 of it, dropped)."""
    xh, xl = split_tf32(x.detach().float())
    eh, el = split_tf32(embeddings.detach().float())
    prod = xh @ el.t() + xl @ eh.t() + xh @ eh.t()
    e = embeddings.detach().float()
    return -2.0 * prod + (e * e).sum(dim=-1)[None, :]


def nearest_code_stats_kernel_arithmetic(
        x: torch.Tensor, embeddings: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`nearest_code_stats_reference` with the distances of
    :func:`kernel_distances`: what the kernel computes up to the order of
    its sums. For the tests; no path of the port runs it."""
    indices = torch.argmin(kernel_distances(x, embeddings),
                           dim=1).to(torch.int32)
    return (indices, *code_stats_reference(x.detach(), indices,
                                           embeddings.shape[0]))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("nearest_code_stats.cu")
    lib.nearest_code_stats.argtypes = ([ctypes.c_void_p] * 2
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p] * 4)
    lib.nearest_code_stats.restype = ctypes.c_int
    return lib


def nearest_code_stats(x: torch.Tensor, embeddings: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest code per row of ``x`` (N, D) among ``embeddings`` (K, D), with
    the usage statistics. CPU tensors take the plain version. CUDA tensors
    must be f32, contiguous, on the current device, D <= 384; each launch
    adds one to ``nearest_code_stats.launches``."""
    x = x.detach()
    embeddings = embeddings.detach()
    if x.device.type == "cpu":
        return nearest_code_stats_reference(x, embeddings)
    if x.device.type != "cuda" or \
            x.device.index != torch.cuda.current_device() or \
            embeddings.device != x.device:
        raise ValueError(f"nearest_code_stats: no kernel for {x.device} and "
                         f"{embeddings.device} (the current device is "
                         f"cuda:{torch.cuda.current_device()})")
    n, d = x.shape
    k, d2 = embeddings.shape
    if d != d2 or not 0 < d <= _MAX_DIM or n < 1 or k < 1:
        raise ValueError(f"nearest_code_stats: shapes x {tuple(x.shape)}, "
                         f"embeddings {tuple(embeddings.shape)}")
    for name, t in (("x", x), ("embeddings", embeddings)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"nearest_code_stats: {name} must be f32 and "
                            f"contiguous")
    indices = torch.empty((n,), dtype=torch.int32, device=x.device)
    n_total = torch.zeros((k,), dtype=torch.float32, device=x.device)
    encode_sum = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    # 16-byte copies of E where its rows start on 16 bytes
    vec = embeddings.data_ptr() % 16 == 0 and d % 4 == 0
    err = _library().nearest_code_stats(
        x.data_ptr(), embeddings.data_ptr(), n, k, d, int(vec),
        indices.data_ptr(),
        n_total.data_ptr(), encode_sum.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"nearest_code_stats launch failed: cudaError "
                           f"{err}")
    nearest_code_stats.launches += 1
    return indices, n_total, encode_sum


nearest_code_stats.launches = 0
