"""The measurement probes' kernels: CUDA kernels and their plain versions.

Three kernels of ``csrc/probe_kernels.cu`` (nvcc for ``sm_90a`` at first
use, bound through ctypes), each replacing a TPU kernel of the JAX package's
scripts:

* :func:`probe_matmul` — ``scripts/compile_cache_probe.py: kern``:
  ``o = (a @ a) * 2`` for a square f32 ``a``; the kernel the build-cache
  probe builds and runs.
* :func:`chain_matmul` — ``scripts/depth_pack_probe.py: _chain_kernel``:
  ``iters`` dependent products ``x <- bf16(0.01 * (x @ w)[:, :k])`` with f32
  accumulation, then ``sum(x)``; x (m, k) bf16, w (k, n) bf16.
* :func:`pair_matmul` — ``scripts/depth_pack_probe.py: _pair_kernel``: two
  independent such chains (w1, w2, both from the same x) advanced inside
  each iteration of one launch, ``sum(x1) + sum(x2)``.

The chains return ``(total (1,) f32, checksum f32)``. Only the first k of n
columns feed a chain, so the kernel also sums every iteration's full product
over the rows and each group of 16 columns into ``checksum`` ((n / 16,), for
the pair (2, n / 16)): no column's product is dead work, and the plain
versions compute the same sums. With ``return_x`` the final x comes back too
((m, k) bf16, for the pair (2, m, k)).

A launch takes one of two designs (:func:`chain_design`, the rule the
launcher applies): ``local`` (one chain or the pair, k <= 128, where each
chain's x, head w[:, :k] and the block's slab of w fit its shared memory)
keeps x in every block, each warp advancing the chain of its own 32 rows
with no barrier wider than the warp (the pair: 16 warps, 8 a chain);
``exchange`` (the deeper chains, and the pair where two local copies do not
fit) passes x between the blocks through L2 behind a grid barrier.

CPU tensors take the plain versions (:func:`probe_matmul_reference`,
:func:`chain_reference`, :func:`pair_reference`); CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from . import cuda_build

__all__ = ["probe_matmul", "probe_matmul_reference", "chain_matmul",
           "chain_reference", "pair_matmul", "pair_reference",
           "chain_design", "device_chain_design", "ChainDesign",
           "CHECKSUM_GROUP", "MODES", "SHARED_BYTES"]

CHECKSUM_GROUP = 16     # csrc/probe_kernels.cu: kGroup
_MAX_ROWS = 256         # kMaxRows
_MAX_CHUNK = 256        # kMaxChunk
_PAD = 8                # kPad: bf16 of padding a shared row
_THREADS = 256          # kThreads
_LOCAL_MAX_K = 128      # kLocalMaxK
_LOCAL_MAX_SLAB = 256   # kLocalSubs * kSub
# shared memory a block may use on the card (kMaxSmem): 227 KB
SHARED_BYTES = 232448
# what a launch of a chain runs: the probe itself; its loop with the
# products skipped (local: the head's rounding, the next x's writes, the
# checksum's partial sums and the warp barriers stay; exchange: the staging
# of x, the epilogue and the grid barriers stay); the loop's own
# synchronisation alone (local: two warp barriers an iteration; exchange:
# one grid barrier)
MODES = {"full": 0, "no_products": 1, "barrier_only": 2}
_DESIGNS = ("local", "exchange")


class ChainDesign(NamedTuple):
    """How a chain launches: ``design`` ("local" or "exchange"), the
    columns of w a block owns (``slab``), the grid (``blocks``), x's
    staging depth (``kc``; k in the local design) and the dynamic shared
    memory a block (``smem``, bytes)."""
    design: str
    slab: int
    blocks: int
    kc: int
    smem: int


def chain_design(m: int, k: int, n: int, chains: int = 1,
                 sms: int = 132) -> ChainDesign:
    """The design a launch of ``chains`` chains of (m, k) x (k, n) takes on
    a card of ``sms`` SMs (an H100 has 132): the rule of
    ``csrc/probe_kernels.cu: plan_chain``, stated here so that it can be
    read and tested without a card.

    A block owns a slab of w, the narrowest multiple of 16 columns that
    covers n with at most one block an SM. One chain or two with k <= 128
    and a slab of at most 256 columns (a thread's checksum partials in
    registers) take the local design where each chain's x (m, k), head
    w[:, :k] (k, k) and slab (k, slab), rows padded by 8 bf16, and
    per-thread checksum partials fit beside the kernel's 1 KB reduction
    buffer; else the exchange design, x staged ``kc`` deep: k (at most
    256), halved until the chains' x chunks, slabs and partials fit. Raises
    ValueError for a shape the kernels do not take."""
    if m % 32 or not 32 <= m <= _MAX_ROWS or k % 16 or k < 16 or k > n or \
            (k > _MAX_CHUNK and k % _MAX_CHUNK) or n % CHECKSUM_GROUP or \
            chains not in (1, 2) or sms < 1:
        raise ValueError(f"no chain design for m={m}, k={k}, n={n}, "
                         f"chains={chains}")
    slab = -(-n // sms)
    slab = -(-slab // CHECKSUM_GROUP) * CHECKSUM_GROUP
    blocks = -(-n // slab)
    checks = slab // CHECKSUM_GROUP * _THREADS * 4
    local = 2 * (m * (k + _PAD) + k * (k + _PAD) + k * (slab + _PAD)) + checks
    if k <= _LOCAL_MAX_K and slab <= _LOCAL_MAX_SLAB and \
            chains * local <= SHARED_BYTES - _THREADS * 4:
        return ChainDesign("local", slab, blocks, k, chains * local)
    kc = min(k, _MAX_CHUNK)
    while True:
        smem = chains * (2 * (m * (kc + _PAD) + k * (slab + _PAD)) + checks)
        if smem <= SHARED_BYTES:
            return ChainDesign("exchange", slab, blocks, kc, smem)
        if kc % 32:
            raise ValueError(f"no chain design for m={m}, k={k}, n={n}, "
                             f"chains={chains}: x does not fit beside w")
        kc //= 2


def probe_matmul_reference(a: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: ``(a @ a) * 2``."""
    return (a @ a) * 2.0


def _chain_step(x: torch.Tensor, w: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One iteration: (next x bf16, this product's checksum (n / 16,)). The
    product of bf16 values is exact in f32; the sum is f32; the scale is one
    f32 multiply, then one rounding to bf16."""
    k = x.shape[1]
    s = x.float() @ w.float()
    check = s.reshape(s.shape[0], -1, CHECKSUM_GROUP).sum(dim=(0, 2))
    return (s[:, :k] * 0.01).to(torch.bfloat16), check


def chain_reference(x: torch.Tensor, w: torch.Tensor, iters: int,
                    return_x: bool = False):
    """Plain version of P2. x: (m, k) bf16; w: (k, n) bf16."""
    check = torch.zeros((w.shape[1] // CHECKSUM_GROUP,), dtype=torch.float32,
                        device=x.device)
    for _ in range(iters):
        x, c = _chain_step(x, w)
        check = check + c
    total = x.float().sum().reshape(1)
    return (total, check, x) if return_x else (total, check)


def pair_reference(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   iters: int, return_x: bool = False):
    """Plain version of P3: two chains from the same x, summed."""
    t1, c1, x1 = chain_reference(x, w1, iters, return_x=True)
    t2, c2, x2 = chain_reference(x, w2, iters, return_x=True)
    out = (t1 + t2, torch.stack((c1, c2)))
    return (*out, torch.stack((x1, x2))) if return_x else out


@functools.cache
def _library(build_dir: str | None = None) -> ctypes.CDLL:
    lib = cuda_build.load("probe_kernels.cu", build_dir)
    lib.probe_matmul.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p]
    lib.probe_matmul.restype = ctypes.c_int
    lib.probe_chain_design.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.probe_chain_design.restype = ctypes.c_int
    lib.probe_chain.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                + [ctypes.POINTER(ctypes.c_int),
                                   ctypes.c_void_p])
    lib.probe_chain.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, tensors: dict[str, torch.Tensor],
                dtype: torch.dtype) -> None:
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {first.device}")
    if first.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: no kernel for {first.device} (the current "
                         f"device is cuda:{torch.cuda.current_device()})")
    for label, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
            raise TypeError(f"{name}: {label} must be {dtype}, contiguous "
                            f"and 16-byte aligned")


def probe_matmul(a: torch.Tensor, *,
                 build_dir: str | os.PathLike | None = None) -> torch.Tensor:
    """``(a @ a) * 2`` for a square f32 ``a``. A CPU tensor takes the plain
    version; a CUDA tensor (f32, contiguous, on the current device) launches
    the kernel, built into ``build_dir`` (default: the package's), and adds
    one to ``probe_matmul.launches``."""
    if a.device.type == "cpu":
        return probe_matmul_reference(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1] or a.shape[0] < 1:
        raise ValueError(f"probe_matmul: shape {tuple(a.shape)}")
    _check_cuda("probe_matmul", {"a": a}, torch.float32)
    out = torch.empty_like(a)
    lib = _library(None if build_dir is None else os.fspath(build_dir))
    err = lib.probe_matmul(a.data_ptr(), out.data_ptr(), a.shape[0],
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"probe_matmul launch failed: cudaError {err}")
    probe_matmul.launches += 1
    return out


probe_matmul.launches = 0


def device_chain_design(m: int, k: int, n: int,
                        chains: int = 1) -> ChainDesign:
    """The design the launcher takes on the current CUDA device (its own
    rule, ``plan_chain``; :func:`chain_design` states it)."""
    info = (ctypes.c_int * 4)()
    got = _library().probe_chain_design(int(m), int(k), int(n), int(chains),
                                        info)
    if got < 0:
        raise RuntimeError(f"probe_chain_design failed: cudaError {-got}")
    return ChainDesign(_DESIGNS[got], *info)


def _launch_chain(name: str, x: torch.Tensor, ws: tuple[torch.Tensor, ...],
                  iters: int, mode: str, return_x: bool,
                  last_x: bool = False):
    m, k = x.shape
    n = ws[0].shape[1]
    nc = len(ws)
    if any(w.ndim != 2 or tuple(w.shape) != (k, n) for w in ws):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w "
                         f"{[tuple(w.shape) for w in ws]}")
    if m % 32 or not 32 <= m <= _MAX_ROWS or k % 16 or k < 16 or k > n or \
            (k > _MAX_CHUNK and k % _MAX_CHUNK) or n % CHECKSUM_GROUP or \
            iters < 0:
        raise ValueError(f"{name}: the kernel takes m a multiple of 32 up to "
                         f"{_MAX_ROWS}, k a multiple of 16 (of {_MAX_CHUNK} "
                         f"above {_MAX_CHUNK}) up to n, n a multiple of "
                         f"{CHECKSUM_GROUP}; got m={m}, k={k}, n={n}")
    if mode not in MODES:
        raise ValueError(f"{name}: mode {mode!r} not in {sorted(MODES)}")
    _check_cuda(name, {"x": x, **{f"w{i + 1}": w for i, w in enumerate(ws)}},
                torch.bfloat16)
    xbuf = torch.empty((2, nc, m, k), dtype=torch.bfloat16, device=x.device)
    check = torch.zeros((nc, n // CHECKSUM_GROUP), dtype=torch.float32,
                        device=x.device)
    total = torch.zeros((1,), dtype=torch.float32, device=x.device)
    design = ctypes.c_int(-1)
    err = _library().probe_chain(
        x.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr() if nc == 2 else None,
        xbuf.data_ptr(), check.data_ptr(), total.data_ptr(), m, k, n,
        int(iters), MODES[mode], ctypes.byref(design),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    if nc == 1:
        check = check[0]
    if not return_x:
        return total, check
    if _DESIGNS[design.value] == "local":     # the first block's, the last's
        final, last = xbuf[0], xbuf[1]
    else:                                     # one copy, in L2
        final = xbuf[iters & 1] if iters else x.expand(nc, m, k)
        last = final
    if nc == 1:
        final, last = final[0], last[0]
    return (total, check, final, last) if last_x else (total, check, final)


def chain_matmul(x: torch.Tensor, w: torch.Tensor, iters: int, *,
                 mode: str = "full", return_x: bool = False,
                 last_block_x: bool = False):
    """P2: ``iters`` dependent products ``x <- bf16(0.01 * (x @ w)[:, :k])``.
    Returns ``(sum(x) (1,), checksum (n / 16,))`` and, with ``return_x``, the
    final x. CPU tensors take :func:`chain_reference`. CUDA tensors (bf16,
    contiguous, on the current device; m a multiple of 32 up to 256, k a
    multiple of 16 up to n, n a multiple of 16) launch the kernel once, in
    the design of :func:`chain_design`; ``mode`` (see :data:`MODES`) strips
    the launch for timing its parts. With ``return_x`` and ``last_block_x``
    on a CUDA tensor the last block's final x comes back as a fourth output
    (the local design keeps a copy of x in every block; the exchange design
    one copy, returned twice). Each launch adds one to
    ``chain_matmul.launches``."""
    if x.device.type == "cpu":
        return chain_reference(x, w, iters, return_x)
    out = _launch_chain("chain_matmul", x, (w,), iters, mode, return_x,
                        last_block_x)
    chain_matmul.launches += 1
    return out


chain_matmul.launches = 0


def pair_matmul(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                iters: int, *, mode: str = "full", return_x: bool = False,
                last_block_x: bool = False):
    """P3: two independent chains (w1, w2) from the same x, both advanced
    inside each iteration of ONE launch. Returns ``(sum(x1) + sum(x2) (1,),
    checksum (2, n / 16))`` and, with ``return_x``, the final (2, m, k).
    Devices, shapes, ``mode`` and ``last_block_x`` (the last block's final
    (2, m, k)) as :func:`chain_matmul`. Each launch adds one to
    ``pair_matmul.launches``."""
    if x.device.type == "cpu":
        return pair_reference(x, w1, w2, iters, return_x)
    out = _launch_chain("pair_matmul", x, (w1, w2), iters, mode, return_x,
                        last_block_x)
    pair_matmul.launches += 1
    return out


pair_matmul.launches = 0
