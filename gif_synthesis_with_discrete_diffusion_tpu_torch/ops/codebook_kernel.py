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

:func:`nearest_code_stats_sharded` is the data-parallel form (JAX's
``nearest_code_stats_sharded``): each rank looks up its own rows, then
``n_total`` and ``encode_sum`` are summed over the data group; the indices
stay with their rows.

:func:`nearest_code_stats_tp` is the form for a codebook sharded by codes
over the model group (tensor parallelism): K6's second entry
(:func:`nearest_code_dist`) gives each row's nearest local code and its
distance, the group takes the nearest over the shards (ties to the lower
shard, the lower global index, as ``jnp.argmin``), and K6's third entry
(:func:`code_stats`) counts this rank's codes from those global winners.
JAX takes its XLA reference under a ``model`` axis; the port keeps the
kernel. Each entry has its plain version beside it, which CPU tensors take.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from ..parallel.distributed import (all_gather, all_reduce_sum, data_group,
                                    group_rank, model_group)
from . import cuda_build
from .megakernel import split_tf32

__all__ = ["nearest_code_stats", "nearest_code_stats_sharded",
           "nearest_code_stats_reference", "nearest_code_dist",
           "nearest_code_dist_reference", "code_stats",
           "code_stats_range_reference", "nearest_code_stats_tp",
           "nearest_code_stats_kernel_arithmetic", "kernel_distances",
           "code_stats_reference"]



def code_stats_range_reference(x: torch.Tensor, indices: torch.Tensor,
                               lo: int, k: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`code_stats`: (n_total, encode_sum) of the
    codes ``[lo, lo + k)`` from rows ``x`` (N, D) of global ``indices``."""
    local = indices.long() - lo
    inside = (local >= 0) & (local < k)
    onehot = F.one_hot(local.clamp(0, k - 1), k).to(torch.float32)
    onehot = onehot * inside[:, None].to(torch.float32)
    return onehot.sum(dim=0), onehot.t() @ x.detach().float()


def code_stats_reference(x: torch.Tensor, indices: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_total, encode_sum) of rows ``x`` (N, D) assigned to ``indices``."""
    return code_stats_range_reference(x, indices, 0, k)


def _distances(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return -2.0 * (x @ e.t()) + (e * e).sum(dim=-1)[None, :]


def nearest_code_stats_reference(x: torch.Tensor, embeddings: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain version. x: (N, D); embeddings: (K, D)."""
    x = x.detach().float()
    e = embeddings.detach().float()
    indices = torch.argmin(_distances(x, e), dim=1).to(torch.int32)
    return (indices, *code_stats_reference(x, indices, e.shape[0]))


def nearest_code_dist_reference(x: torch.Tensor, embeddings: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`nearest_code_dist`: each row's nearest code
    (int32, the first on ties) and its distance ``||e||^2 - 2 x.e``, the
    distances of :func:`nearest_code_stats_reference`."""
    dist = _distances(x.detach().float(), embeddings.detach().float())
    indices = torch.argmin(dist, dim=1)
    return indices.to(torch.int32), dist.gather(1, indices[:, None])[:, 0]


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
    lib.nearest_code_dist.argtypes = ([ctypes.c_void_p] * 2
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p] * 3)
    lib.code_stats.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p] * 3)
    for fn in (lib.nearest_code_stats, lib.nearest_code_dist,
               lib.code_stats):
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on the current CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device() or \
            any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: no kernel for "
                         f"{', '.join(str(t.device) for t in tensors)} (the "
                         f"current device is "
                         f"cuda:{torch.cuda.current_device()})")


def _check_lookup(name: str, x: torch.Tensor, embeddings: torch.Tensor
                  ) -> None:
    n, d = x.shape
    k, d2 = embeddings.shape
    if d != d2 or d < 1 or n < 1 or k < 1:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, "
                         f"embeddings {tuple(embeddings.shape)}")
    for what, t in (("x", x), ("embeddings", embeddings)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name}: {what} must be f32 and contiguous")


def _vec(x: torch.Tensor, embeddings: torch.Tensor) -> int:
    """The kernel's copy widths: bit 0, E's rows start on 16 bytes (16-byte
    copies of E); bit 1, x's do (16-byte copies of x where it streams)."""
    d = x.shape[1]
    return (int(embeddings.data_ptr() % 16 == 0 and d % 4 == 0)
            | 2 * int(x.data_ptr() % 16 == 0 and d % 4 == 0))


def nearest_code_stats(x: torch.Tensor, embeddings: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest code per row of ``x`` (N, D) among ``embeddings`` (K, D), with
    the usage statistics. CPU tensors take the plain version. CUDA tensors
    must be f32, contiguous, on the current device (any D); each launch adds
    one to ``nearest_code_stats.launches`` and to
    ``nearest_code_stats.by_dim[D]``."""
    x = x.detach()
    embeddings = embeddings.detach()
    if x.device.type == "cpu":
        return nearest_code_stats_reference(x, embeddings)
    _check_cuda("nearest_code_stats", x, embeddings)
    _check_lookup("nearest_code_stats", x, embeddings)
    n, d = x.shape
    k = embeddings.shape[0]
    indices = torch.empty((n,), dtype=torch.int32, device=x.device)
    n_total = torch.zeros((k,), dtype=torch.float32, device=x.device)
    encode_sum = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    err = _library().nearest_code_stats(
        x.data_ptr(), embeddings.data_ptr(), n, k, d, _vec(x, embeddings),
        indices.data_ptr(),
        n_total.data_ptr(), encode_sum.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"nearest_code_stats launch failed: cudaError "
                           f"{err}")
    nearest_code_stats.launches += 1
    nearest_code_stats.by_dim[d] += 1
    return indices, n_total, encode_sum


nearest_code_stats.launches = 0
nearest_code_stats.by_dim = collections.Counter()


def nearest_code_dist(x: torch.Tensor, embeddings: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's lookup without its statistics: each row's nearest code among
    ``embeddings`` (int32, the first on ties) and its distance (f32, the
    kernel's split-TF32 ``||e||^2 - 2 x.e``). CPU tensors take
    :func:`nearest_code_dist_reference`; CUDA tensors as
    :func:`nearest_code_stats`'s; each launch adds one to
    ``nearest_code_dist.launches`` and to ``nearest_code_dist.by_dim[D]``."""
    x = x.detach()
    embeddings = embeddings.detach()
    if x.device.type == "cpu":
        return nearest_code_dist_reference(x, embeddings)
    _check_cuda("nearest_code_dist", x, embeddings)
    _check_lookup("nearest_code_dist", x, embeddings)
    n, d = x.shape
    k = embeddings.shape[0]
    indices = torch.empty((n,), dtype=torch.int32, device=x.device)
    dist = torch.empty((n,), dtype=torch.float32, device=x.device)
    err = _library().nearest_code_dist(
        x.data_ptr(), embeddings.data_ptr(), n, k, d, _vec(x, embeddings),
        indices.data_ptr(), dist.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"nearest_code_dist launch failed: cudaError "
                           f"{err}")
    nearest_code_dist.launches += 1
    nearest_code_dist.by_dim[d] += 1
    return indices, dist


nearest_code_dist.launches = 0
nearest_code_dist.by_dim = collections.Counter()


def code_stats(x: torch.Tensor, indices: torch.Tensor, lo: int, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_total (k,), encode_sum (k, D)) of the codes ``[lo, lo + k)`` from
    rows ``x`` (N, D) f32 and their global ``indices`` (N,) int32; rows of
    other codes count nowhere. CPU tensors take
    :func:`code_stats_range_reference`; CUDA tensors launch K6's statistics
    entry (each launch adds one to ``code_stats.launches`` and to
    ``code_stats.by_dim[D]``)."""
    x = x.detach()
    if x.device.type == "cpu":
        return code_stats_range_reference(x, indices, lo, k)
    _check_cuda("code_stats", x, indices)
    n, d = x.shape
    if indices.shape != (n,) or indices.dtype != torch.int32 or \
            x.dtype != torch.float32 or not x.is_contiguous() or \
            not indices.is_contiguous() or n < 1 or d < 1 or k < 1:
        raise ValueError(f"code_stats: x {tuple(x.shape)} {x.dtype}, "
                         f"indices {tuple(indices.shape)} {indices.dtype}")
    n_total = torch.zeros((k,), dtype=torch.float32, device=x.device)
    encode_sum = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    err = _library().code_stats(
        x.data_ptr(), indices.data_ptr(), n, d, int(lo), k,
        n_total.data_ptr(), encode_sum.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"code_stats launch failed: cudaError {err}")
    code_stats.launches += 1
    code_stats.by_dim[d] += 1
    return n_total, encode_sum


code_stats.launches = 0
code_stats.by_dim = collections.Counter()


def nearest_code_stats_sharded(x: torch.Tensor, embeddings: torch.Tensor,
                               lookup=nearest_code_stats
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """``lookup`` (K6 on CUDA tensors) on this rank's rows ``x``, then
    ``n_total`` and ``encode_sum`` summed over the data group (unchanged
    without one); the indices are this rank's."""
    indices, n_total, encode_sum = lookup(x, embeddings)
    group = data_group()
    return (indices, all_reduce_sum(n_total, group),
            all_reduce_sum(encode_sum, group))


def nearest_code_stats_tp(x: torch.Tensor, embeddings: torch.Tensor,
                          plain: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The lookup of a codebook whose codes are sharded over the model
    group, this rank holding ``embeddings`` (K / model, D), the codes from
    ``model index * K / model``: the global nearest code of each row of
    ``x`` (int32, as one rank's lookup over all K codes), and ``n_total`` /
    ``encode_sum`` of this rank's codes summed over the data group.
    ``plain`` takes the plain versions on every device (``kernel_mode:
    xla``)."""
    group = model_group()
    k = embeddings.shape[0]
    lo = group_rank(group) * k
    lookup, stats = ((nearest_code_dist_reference, code_stats_range_reference)
                     if plain else (nearest_code_dist, code_stats))
    local, dist = lookup(x, embeddings)
    every_idx = all_gather((local + lo)[None], 0, group)     # (model, N)
    every_dist = all_gather(dist[None], 0, group)
    # the first shard of the smallest distance: ties to the lower index
    shard = torch.argmin(every_dist, dim=0)
    indices = every_idx.gather(0, shard[None])[0].contiguous()
    n_total, encode_sum = stats(x.detach().float().contiguous(), indices,
                                lo, k)
    dgroup = data_group()
    return (indices, all_reduce_sum(n_total, dgroup),
            all_reduce_sum(encode_sum, dgroup))
