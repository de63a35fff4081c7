"""Multi-head attention for the D3PM denoiser: CUDA kernels for the forward
and the backward, and their plain versions.

``fused_mha`` replaces the TPU's differentiable ``gif_synthesis_with_
discrete_diffusion_tpu/ops/attention.py: fused_mha``. Its forward is
``csrc/fused_mha_fwd.cu`` (the TPU's ``_kernel``); its backward, through a
``torch.autograd.Function``, is ``csrc/fused_mha_bwd.cu`` and, above head
dim 128, ``csrc/fused_mha_bwd_stream.cu`` (the TPU's ``_bwd_kernel``),
reached by :func:`fused_mha_bwd`. Both run on the tensor
cores for f32 or bf16 inputs at any head dim (heads of 4 and 8 in their
own design, ``csrc/mha_tiles.cuh``; every other width up to 128 in the wg
design, ``csrc/mha_wg.cuh``, wgmma fed by TMA, at the next of
:data:`WIDE_HEAD_DIMS`, the columns beyond the head masked; wider heads in
the stream design, the same wgmma and TMA with every operand streamed
through a ring, :func:`stream_out` output columns a block), are built by
nvcc for ``sm_90a`` at first use and bound through ctypes. CPU tensors take
the same Function with the plain versions, :func:`sdpa_reference` forward and
:func:`fused_mha_bwd_reference` backward. Like the TPU kernels, both compute
in f32 whatever the input type and round only their outputs to it. The
source files say what bounds each kernel on Hopper and how its design
answers that.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from . import cuda_build

__all__ = ["fused_mha", "fused_mha_bwd", "fused_mha_bwd_reference",
           "sdpa_reference", "kv_splits", "bf16_step", "bf16_excess",
           "BF16_EXCESS_TOL", "bf16_rounded_p_reference",
           "attention_kernel_arithmetic",
           "attention_bwd_kernel_arithmetic", "bf16_hi_lo", "split_fed_back",
           "PAIR_SLOTS", "TILE_HEAD_DIMS", "WIDE_HEAD_DIMS", "STREAM_CHUNK",
           "STREAM_OUT", "STREAM_ONE_PASS", "kernel_head_dim",
           "check_head_dim", "design", "wg_tiles", "stream_out",
           "stream_tiles", "stream_prep_floats", "wg_operand", "wg_fed_back",
           "tma_refused"]

# the kernels' instantiations (csrc/fused_mha_*.cu): heads of 4 and 8 in
# the first design (csrc/mha_tiles.cuh: Tf32, Bf16), every other head dim d
# up to WIDE_HEAD_DIMS[-1] in the wg design (csrc/mha_wg.cuh) at the
# smallest of WIDE_HEAD_DIMS that holds it, its columns d .. D - 1 read as
# zero, and wider heads in the stream design (csrc/mha_wg.cuh: Stream):
# blocks of one of STREAM_OUT output columns, the scores' contraction
# streamed 128 bytes of each row at a time (columns past d zero; counted
# here as d padded to STREAM_CHUNK)
TILE_HEAD_DIMS = (4, 8)
WIDE_HEAD_DIMS = (16, 32, 64, 128)
STREAM_CHUNK = 64
STREAM_OUT = (192, 256)
# the widest head the stream design computes every score of once: wider
# heads run in column chunks of STREAM_OUT, each computing the scores again
STREAM_ONE_PASS = STREAM_OUT[-1]
# the dK/dV kernel cuts the queries into chunks of this many rows when there
# are too few keys to fill the card (csrc/fused_mha_bwd.cu); the wg and
# stream designs stream a block's queries through a ring of tiles, and split
# only past 1024 and 256 queries (over 1 and 77 keys at d = 144-512, 256
# measured within 0-15 % of the best of 64-1024 at each shape, 1024 up to
# 2.6 x slower in f32)
_KV_SPLIT_ROWS = {"tiles": 64, "wg": 1024, "stream": 256}
_KV_SPLIT_MIN_KEYS = 256


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   n_head: int) -> torch.Tensor:
    """Plain version of K2, what the TPU kernel's ``_kernel`` computes:
    q, k, v taken to f32, q scaled, the softmax and P V in f32, only the
    output rounded to the input type. q: (B, Lq, C); k/v: (B, Lk, C).
    Returns (B, Lq, C)."""
    B, Lq, C = q.shape
    Lk = k.shape[1]
    d = C // n_head
    qh = q.reshape(B, Lq, n_head, d).float() * (1.0 / math.sqrt(d))
    kh = k.reshape(B, Lk, n_head, d).float()
    vh = v.reshape(B, Lk, n_head, d).float()
    att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, vh)
    return out.reshape(B, Lq, C).to(q.dtype)


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


def bf16_step(magnitude: float) -> float:
    """One bf16 step at ``magnitude``: the spacing of bf16 numbers there.
    The plain versions' bf16 outputs are held to one step at their tensor's
    largest magnitude of the Pallas kernel's (both compute in f32 and round
    once, so an element may land one rounding boundary apart)."""
    return 2.0 ** (math.floor(math.log2(magnitude)) - 7)


# a bf16 output's error beyond the rounding of the exact result to bf16, as
# a share of the tensor's largest magnitude: the kernels (f32 inside, P and
# dS fed to the tensor cores as a bf16 hi + lo pair) stay ~30x under it, P
# and dS rounded to bf16 (bf16_rounded_p_reference) miss it by ~7x or more
BF16_EXCESS_TOL = 1e-4


def bf16_excess(got: torch.Tensor, want: torch.Tensor,
                scale: float | None = None) -> float:
    """How far the bf16 ``got`` lies from ``want`` (the same function of the
    same inputs in f32) beyond half a bf16 step at each element of ``want``:
    the largest such excess over the elements, over ``scale`` (by default
    ``want``'s largest magnitude). A computation in f32 rounded once to bf16
    scores its f32 error; one that rounds an intermediate to bf16 scores
    that rounding's error too, which a bound of one step would hide."""
    w = want.double()
    _, e = torch.frexp(w)   # |w| in [2^(e-1), 2^e): a bf16 step is 2^(e-8)
    half = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), e - 9))
    excess = ((got.double() - w).abs() - half).clamp_min(0).max().item()
    scale = w.abs().max().item() if scale is None else scale
    return excess / scale if scale > 0 else excess


def check_head_dim(c: int, n_head: int) -> int:
    """The kernels' contract on the width: C a multiple of n_head (any head
    dim C // n_head). Returns the head dim; raises ``ValueError`` on
    anything else."""
    if n_head <= 0 or c % n_head:
        raise ValueError(f"fused_mha: C = {c} is no multiple of n_head = "
                         f"{n_head}")
    return c // n_head


def kernel_head_dim(d: int) -> int:
    """The width the kernels compute head dim ``d`` at: d itself for 4 and
    8, the smallest of :data:`WIDE_HEAD_DIMS` at least d up to 128 (the wg
    design), and above 128 d rounded up to a multiple of
    :data:`STREAM_CHUNK` (the stream design's contraction; its columns past
    d are zero)."""
    if d < 1:
        raise ValueError(f"fused_mha: head dim {d}")
    if d in TILE_HEAD_DIMS:
        return d
    for w in WIDE_HEAD_DIMS:
        if d <= w:
            return w
    return -(-d // STREAM_CHUNK) * STREAM_CHUNK


def design(d: int) -> str:
    """Which design the kernels take head dim ``d`` in: ``"tiles"`` (4 and
    8), ``"wg"`` (every other d up to 128) or ``"stream"`` (above)."""
    if d in TILE_HEAD_DIMS:
        return "tiles"
    return "wg" if d <= WIDE_HEAD_DIMS[-1] else "stream"


def wg_tiles(width: int, dtype: torch.dtype) -> dict:
    """The wg design's sizes at instantiation ``width`` (csrc/mha_wg.cuh:
    Cfg): for K2 (``fwd``), K5's dq kernel (``dq``) and its dk/dv kernel
    (``kv``), the consumer warpgroups of 64 own rows each and the other
    side's rows a tile (``(warpgroups, rows)``). f32 tiles take their split
    copies beside them in shared memory, so the widest f32 heads take one
    warpgroup and shorter tiles."""
    f32 = dtype == torch.float32
    return {"fwd": (1, 32) if f32 and width == 128 else (2, 64),
            "dq": (1 if f32 and width == 128 else 2,
                   32 if (width >= 64 if f32 else width == 128) else 64),
            "kv": (1 if width == 128 else 2,
                   (16 if f32 else 32) if width == 128
                   else 32 if width == 64 and f32 else 64)}


def stream_out(d: int) -> tuple[int, int]:
    """The stream design's output columns a block at head dim ``d`` (above
    128) and the column chunks of the head (csrc/mha_wg.cuh: stream_out):
    192 up to 192, 256 up to :data:`STREAM_ONE_PASS`, one chunk; wider heads
    in chunks of whichever of :data:`STREAM_OUT` pads d the least (256 on a
    tie), each chunk's blocks computing the scores again."""
    if d <= STREAM_ONE_PASS:
        oc = next(w for w in STREAM_OUT if d <= w)
    else:
        oc = min(STREAM_OUT[::-1], key=lambda w: -(-d // w) * w)
    return oc, -(-d // oc)


def stream_tiles(d: int, dtype: torch.dtype) -> dict:
    """The stream design's sizes at head dim ``d`` (csrc/mha_wg.cuh:
    Stream, at the output columns :func:`stream_out` gives): for K2
    (``fwd``), K5's dq kernel (``dq``) and its dk/dv kernel (``kv``), the
    consumer warpgroups, the other side's rows a tile, the ring's slots and
    the shared memory in bytes (``(warpgroups, rows, slots, smem)``). bf16
    heads up to 256 keep a block's own rows resident and a score stage holds
    the other side's whole tile (the dq and dk/dv kernels' fed-back products
    read it again); else a score stage holds 128 bytes of each row of both
    sides (f32: hi and lo of 16 dims, bf16 64 dims) and a value stage a tile
    at some of the block's columns. f32 rounds the block's shared memory
    up to 1024 bytes first (its swizzled tiles)."""
    f32 = dtype == torch.float32
    oc, _ = stream_out(d)
    res = not f32 and d <= STREAM_ONE_PASS
    size, parts = (4, 2) if f32 else (2, 1)
    sc = oc if res else 128 // size // parts
    kt = {"fwd": 64, "dq": 64 if f32 else 32, "kv": 64 if f32 else 32}
    vc = {"fwd": 64 if f32 else oc, "dq": 64 if f32 else oc,
          "kv": 32 if f32 else oc}
    slots = ({"fwd": 4, "dq": 3, "kv": 4} if res
             else {"fwd": 6, "dq": 4 if f32 else 5, "kv": 6})
    rows = {"fwd": 128, "dq": 128, "kv": 64}       # a block's own rows
    n_own = {"fwd": 1, "dq": 2, "kv": 2}           # (q; q, dO; k, v)
    out = {}
    for name in ("fwd", "dq", "kv"):
        n_other = 1 if name == "fwd" else 2
        own = n_own[name] * rows[name] * oc if res else 0
        score = n_other * kt[name] * sc + (
            0 if res else n_own[name] * rows[name] * sc)
        values = (0 if res and name != "fwd" else
                  (2 if name == "kv" else 1) * kt[name] * vc[name])
        slot = parts * max(score, values)
        pbuf = 2 * 64 * kt[name] if name == "kv" else 0
        smem = ((1024 if f32 else 0) + (own + slots[name] * slot) * size
                + pbuf * 4 + 256)
        out[name] = (2, kt[name], slots[name], smem)
    return out


def kv_splits(lq: int, lk: int, d: int = 4) -> int:
    """How many query chunks the dK/dV kernel sums apart at head dim ``d``:
    1 with enough keys to fill the card, else (cross-attention over 1 or 77
    condition tokens) one chunk per 64 queries in the first design, per
    1024 in the wg design and per 256 in the stream design (both stream a
    block's queries through a ring of tiles: fewer, longer blocks measured
    faster there)."""
    if lk >= _KV_SPLIT_MIN_KEYS:
        return 1
    return max(1, -(-lq // _KV_SPLIT_ROWS[design(d)]))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_mha_fwd.cu")
    lib.fused_mha_fwd.argtypes = ([ctypes.c_void_p] * 6
                                  + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    lib.fused_mha_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    # the stream design (above head dim 128) a translation unit of its own,
    # compiled in parallel and linked in; the C entry chooses by head dim
    lib = cuda_build.load("fused_mha_bwd.cu",
                          units=("fused_mha_bwd_stream.cu",))
    lib.fused_mha_bwd.argtypes = ([ctypes.c_void_p] * 11
                                  + [ctypes.c_int] * 7
                                  + [ctypes.c_void_p] * 2)
    lib.fused_mha_bwd.restype = ctypes.c_int
    return lib


def tma_refused() -> dict:
    """``{"K2": (launches, last CUresult), "K5": ...}``: the wg and stream
    designs' launches of this process that copied their tiles by cp.async
    because cuTensorMapEncodeTiled refused a tensor map (``csrc/mha_wg.cuh:
    make_map``, ``make_map5``; an f32 stream launch raises instead), and the
    last refusal's CUresult; (0, 0) for a library not loaded."""
    out = {}
    for name, lib, fn in (("K2", _library, "fused_mha_tma_refused"),
                          ("K5", _bwd_library, "fused_mha_bwd_tma_refused")):
        if not lib.cache_info().currsize:
            out[name] = (0, 0)
            continue
        f = getattr(lib(), fn)
        f.argtypes = [ctypes.c_void_p]
        err = ctypes.c_int(0)
        out[name] = (f(ctypes.byref(err)), err.value)
    return out


_DTYPES = (torch.float32, torch.bfloat16)   # the kernels' input types


def stream_prep_floats(B: int, lq: int, lk: int, n_head: int, d: int,
                       backward: bool) -> int:
    """The floats of the f32 stream design's prepared operands
    (csrc/mha_wg.cuh: stream_prep_kernel; the layouts the launchers carve
    out of the wrapper's scratch): each operand split once into TF32 hi and
    lo, head-major (B, H, L, d padded to 16) and, for the operands a
    product contracts over their rows, transposed (B, H, d, L padded to 8).
    K2: q and k head-major, v transposed; K5: q, dO, k, v head-major, k, q
    and dO transposed."""
    dp = -(-d // 16) * 16
    nq, nk = B * n_head * lq * dp, B * n_head * lk * dp
    l8q, l8k = -(-lq // 8) * 8, -(-lk // 8) * 8
    tq, tk = B * n_head * d * l8q, B * n_head * d * l8k
    if not backward:
        return 2 * nq + 2 * nk + 2 * tk
    return 4 * nq + 4 * nk + 2 * tk + 4 * tq


def _prep(q: torch.Tensor, B: int, lq: int, lk: int, n_head: int, d: int,
          backward: bool) -> torch.Tensor | None:
    """Scratch for the f32 stream design's prepared operands; None at any
    other head dim or type."""
    if d <= WIDE_HEAD_DIMS[-1] or q.dtype != torch.float32:
        return None
    return torch.empty(stream_prep_floats(B, lq, lk, n_head, d, backward),
                       dtype=torch.float32, device=q.device)


def _check_cuda(name: str, q: torch.Tensor, kvs: tuple, n_head: int
                ) -> None:
    """The kernels' contract: contiguous, 16-byte aligned tensors of one
    type, f32 or bf16, on the current device, C a multiple of n_head
    (:func:`check_head_dim`). Heads need not start on 16 bytes: a head of 12
    bf16 values takes 8-byte copies."""
    if q.device.type != "cuda" or \
            q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: no kernel for {q.device} (the current "
                         f"device is cuda:{torch.cuda.current_device()})")
    B, Lq, C = q.shape
    k = kvs[0]
    if k.ndim != 3 or k.shape[0] != B or k.shape[2] != C or k.shape[1] < 1:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    check_head_dim(C, n_head)
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: no kernel for {q.dtype}")
    for i, x in enumerate((q, *kvs)):
        if x.device != q.device:
            raise ValueError(f"{name}: inputs on different devices")
        if x.dtype != q.dtype or not x.is_contiguous() or x.data_ptr() % 16:
            raise TypeError(f"{name}: input {i} must be {q.dtype}, contiguous"
                            f" and 16-byte aligned")


def _fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                n_head: int, with_lse: bool
                ) -> tuple[torch.Tensor, torch.Tensor | None,
                           torch.Tensor | None]:
    """One launch of K2: (o, lse, o32).
    With ``with_lse``: lse (B, H, Lq), the base-2 log-sum-exp, and o32, o
    in f32 (o itself for f32 inputs), what the backward reads; else both
    None."""
    if k.shape != v.shape:
        raise ValueError(f"fused_mha: shapes k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    _check_cuda("fused_mha", q, (k, v), n_head)
    B, Lq, C = q.shape
    o = torch.empty_like(q)
    lse = o32 = None
    if with_lse:
        lse = torch.empty((B, n_head, Lq), dtype=torch.float32,
                          device=q.device)
        o32 = (o if q.dtype == torch.float32 else
               torch.empty(q.shape, dtype=torch.float32, device=q.device))
    prep = _prep(q, B, Lq, k.shape[1], n_head, C // n_head, False)
    err = _library().fused_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        o32.data_ptr() if o32 is not None and o32 is not o else None,
        lse.data_ptr() if lse is not None else None, B, Lq, k.shape[1], C,
        n_head, int(q.dtype == torch.bfloat16),
        prep.data_ptr() if prep is not None else None,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_mha_fwd launch failed: cudaError {err}")
    fused_mha.launches += 1
    fused_mha.by_head_dim[C // n_head, q.dtype] += 1
    return o, lse, o32


def fused_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor | None,
                  do: torch.Tensor, *, n_head: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``o = fused_mha(q, k, v)`` for the output
    gradient ``do``.

    CPU tensors take :func:`fused_mha_bwd_reference` (``o`` and ``lse`` are
    not read). CUDA tensors launch ``csrc/fused_mha_bwd.cu`` (above head
    dim 128 its second unit, ``csrc/fused_mha_bwd_stream.cu``) with the
    forward's output in f32 as ``o`` and its ``lse`` (``_fwd_kernel``'s o32
    and lse); q, k, v, do must meet the forward's contract. Each launch adds
    one to ``fused_mha_bwd.launches`` and to
    ``fused_mha_bwd.by_head_dim[(head dim, dtype)]``."""
    if q.device.type == "cpu":
        return fused_mha_bwd_reference(q, k, v, do, n_head)
    return _bwd_kernel(q, k, v, o, lse, do, n_head)


def _bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, lse: torch.Tensor | None, do: torch.Tensor,
                n_head: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of K5."""
    if lse is None:
        raise ValueError("fused_mha_bwd: the kernel needs the forward's lse")
    B, Lq, C = q.shape
    Lk = k.shape[1]
    if k.shape != v.shape or o.shape != q.shape or do.shape != q.shape or \
            tuple(lse.shape) != (B, n_head, Lq):
        raise ValueError("fused_mha_bwd: shapes of q, k, v, o, lse, do")
    _check_cuda("fused_mha_bwd", q, (k, v, do), n_head)
    for x in (o, lse):
        if x.device != q.device or x.dtype != torch.float32 or \
                not x.is_contiguous() or x.data_ptr() % 16:
            raise TypeError("fused_mha_bwd: o and lse must be f32, "
                            "contiguous, 16-byte aligned, on q's device")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    splits = kv_splits(Lq, Lk, C // n_head)
    scratch = (torch.empty((2, splits, B, Lk, C), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    # the wg and stream designs' dq kernel writes each row's Dr for the dk/dv
    # kernel
    dr = (None if C // n_head in TILE_HEAD_DIMS else
          torch.empty((B, n_head, Lq), dtype=torch.float32, device=q.device))
    prep = _prep(q, B, Lq, Lk, n_head, C // n_head, True)
    err = _bwd_library().fused_mha_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        dr.data_ptr() if dr is not None else None,
        B, Lq, Lk, C, n_head, splits, int(q.dtype == torch.bfloat16),
        prep.data_ptr() if prep is not None else None,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_mha_bwd launch failed: cudaError {err}")
    fused_mha_bwd.launches += 1
    fused_mha_bwd.by_head_dim[C // n_head, q.dtype] += 1
    return dq, dk, dv


fused_mha_bwd.launches = 0
fused_mha_bwd.by_head_dim = collections.Counter()


class _FusedMHA(torch.autograd.Function):
    """Forward K2 (keeping its log-sum-exp), backward K5; on CPU tensors the
    plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, n_head):
        if q.device.type == "cpu":
            o, lse, o32 = sdpa_reference(q, k, v, n_head), None, None
        else:
            o, lse, o32 = _fwd_kernel(q, k, v, n_head, with_lse=True)
        ctx.n_head = n_head
        ctx.save_for_backward(q, k, v, o32, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        # the output gradient may arrive strided; the kernel reads it dense
        dq, dk, dv = fused_mha_bwd(q, k, v, o32, lse, do.contiguous(),
                                   n_head=ctx.n_head)
        return dq, dk, dv, None


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              n_head: int) -> torch.Tensor:
    """q: (B, Lq, C); k/v: (B, Lk, C) -> (B, Lq, C), softmax(QK^T/sqrt(d))V.

    Differentiable: with gradients on, the backward is K5 (or its plain
    version on the CPU). CUDA tensors must be all f32 or all bf16,
    contiguous, 16-byte aligned, on the current device, with C a multiple of
    n_head (:func:`check_head_dim`; heads of 4 and 8 in their own design, up
    to 128 in the wg one, wider in the stream one); any other CUDA input
    raises
    (nothing falls back). Each forward launch adds one to
    ``fused_mha.launches`` and to ``fused_mha.by_head_dim[(head dim,
    dtype)]``."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        return _FusedMHA.apply(q, k, v, n_head)
    if q.device.type == "cpu":
        return sdpa_reference(q, k, v, n_head)
    return _fwd_kernel(q, k, v, n_head, with_lse=False)[0]


fused_mha.launches = 0
fused_mha.by_head_dim = collections.Counter()


# ---------------------------------------------------------------------------
# the kernels' arithmetic where it departs from the plain versions' by more
# than the order of a sum, as plain functions (the CPU tests bound each)
# ---------------------------------------------------------------------------

# keys a staged tile of the first design (csrc/mha_tiles.cuh: kTile)
KERNEL_TILE = 64
# the k-slots of an 8-column block in the TF32 pair product: slot t holds
# column PAIR_SLOTS[t], the accumulator's columns 2t (slots 0-3) and 2t + 1
# (slots 4-7) that lane t holds (csrc/mha_tiles.cuh: Tf32::mma_pair)
PAIR_SLOTS = (0, 2, 4, 6, 1, 3, 5, 7)
_LOG2E = 1.4426950408889634


def bf16_rounded_p_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, n_head: int
                             ) -> tuple[torch.Tensor, ...]:
    """The plain versions with P and dS rounded to bf16 before their
    products (everything else in f32): the fault the bf16 checks must catch.
    Returns (o, dq, dk, dv) in f32."""
    B, Lq, C = q.shape
    d = C // n_head
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, doh = (_heads(x, n_head).float() for x in (q, k, v, do))
    qh = qh * scale
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh), dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).bfloat16().float()
    p = p.bfloat16().float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, doh)
    return tuple(x.reshape(y.shape) for x, y in ((o, q), (dq, q), (dk, k),
                                                 (dv, v)))


def bf16_hi_lo(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An f32 intermediate (P, dS) as the bf16 kernels feed it to the tensor
    cores: hi = p cut to bf16, lo = p - hi (exact) rounded to bf16; hi + lo
    lies within 2^-16 |p| of p."""
    hi = (p.float().contiguous().view(torch.int32) & ~0xFFFF).view(
        torch.float32)
    return hi, (p - hi).to(torch.bfloat16).float()


def split_fed_back(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An f32 intermediate as the f32 kernels feed it to the TF32 tensor
    cores: hi = p cut to TF32, lo = p - hi (exact) as TF32 reads it (cut);
    hi + lo lies within 2^-20 |p| of p."""
    def cut(x):
        return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
            torch.float32)
    hi = cut(p)
    return hi, cut(p - hi)


def _operands(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The parts of an input the kernels multiply: f32 split into TF32 hi +
    lo, bf16 as it is."""
    if x.dtype == torch.float32:
        from .megakernel import split_tf32
        return split_tf32(x)
    return (x.float(),)


def _mm(eq: str, a: tuple, b: tuple) -> torch.Tensor:
    """The sum of the products of every part of ``a`` with every part of
    ``b`` (each exact in f32 on the tensor cores)."""
    return sum(torch.einsum(eq, x, y) for x in a for y in b)


def _mm3(eq: str, a: tuple, b: tuple) -> torch.Tensor:
    """The wg and stream designs' products: hi hi + hi lo + lo hi of two split
    operands (the lo lo term left out); with a one-part operand (bf16) every
    product, as :func:`_mm`."""
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(a)
               for j, y in enumerate(b) if i + j < 2)


def _fed_back(p: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor,
                                                            ...]:
    return split_fed_back(p) if dtype == torch.float32 else bf16_hi_lo(p)


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    B, L, C = x.shape
    return x.reshape(B, L, n_head, C // n_head)


class _Design:
    """How the kernels take a head dim ``d``: the instantiation ``width``
    (the heads read with columns d .. width - 1 zero; above 128 the stream
    design's contraction, :func:`kernel_head_dim`), the products (``mm``),
    whether q is scaled in f32 before them (every f32 design but the first,
    as the JAX kernel), the base-2 factor ``c`` of the products' scores, the
    factors of dQ and dK, K2's tile of keys for the online softmax
    (``tile``: the wg or stream design's, :func:`wg_tiles`,
    :func:`stream_tiles`; 64 in the first design) and up to how many keys
    the dq kernel holds every score at once (``one_group_keys``: 0 in the
    first design; the wg or stream design's dq tile)."""

    def __init__(self, d: int, dtype: torch.dtype):
        self.d = d
        self.scale = 1.0 / math.sqrt(d)
        wide = d not in TILE_HEAD_DIMS
        self.width = kernel_head_dim(d) if wide else d
        self.mm = _mm3 if wide else _mm
        self.tile = KERNEL_TILE
        self.one_group_keys = 0
        if wide:
            tiles = (wg_tiles(self.width, dtype) if design(d) == "wg"
                     else stream_tiles(d, dtype))
            self.tile = tiles["fwd"][1]
            self.one_group_keys = tiles["dq"][1]
        self.scaled_q = wide and dtype == torch.float32
        self.c = _LOG2E if self.scaled_q else _LOG2E / math.sqrt(d)
        if not wide:       # the first design: dQ, dK divided by sqrt(d)
            self.dq = self.dk = lambda x: x / math.sqrt(d)
        else:
            self.dq = lambda x: x * self.scale
            self.dk = (lambda x: x) if self.scaled_q else self.dq

    def heads(self, x: torch.Tensor, n_head: int) -> torch.Tensor:
        h = _heads(x, n_head)
        return torch.nn.functional.pad(h, (0, self.width - self.d))

    def q_heads(self, q: torch.Tensor, n_head: int) -> torch.Tensor:
        h = self.heads(q, n_head)
        return h.float() * self.scale if self.scaled_q else h


def attention_kernel_arithmetic(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, n_head: int
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """K2's tensor-core designs as a plain function: QK^T and P V on the
    split (f32) or exact (bf16) operands, an online softmax over tiles of
    the design's keys (``_Design.tile``: the tile's maximum, one
    exponential a score), P fed back split, the row sum divided once; o
    rounded to the input type. Heads of 4 and 8 (the first design): every
    partial product of the split operands, the scale on the scores. Any
    other head dim d (the wg design up to 128 and the stream design above,
    at the instantiation :func:`kernel_head_dim` gives, columns d .. D - 1
    zero): three partial products (:func:`_mm3`), and in f32 q times
    1/sqrt(d) before them. Returns (o, lse (B, H, Lq) in base 2, o in
    f32)."""
    d = q.shape[2] // n_head
    dz = _Design(d, q.dtype)
    qs = _operands(dz.q_heads(q, n_head))
    ks, vs = (_operands(dz.heads(x, n_head)) for x in (k, v))
    s = dz.mm("bqhd,bkhd->bhqk", qs, ks)
    B, H, Lq, Lk = s.shape
    c = dz.c
    m = torch.full((B, H, Lq, 1), -math.inf)
    l = torch.zeros((B, H, Lq, 1))
    acc = torch.zeros((B, H, Lq, dz.width))
    for k0 in range(0, Lk, dz.tile):
        st = s[..., k0:k0 + dz.tile]
        mn = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        corr = torch.exp2((m - mn) * c)
        p = torch.exp2(st * c - mn * c)
        vt = tuple(x[:, k0:k0 + dz.tile] for x in vs)
        acc = acc * corr + dz.mm("bhqk,bkhd->bhqd", _fed_back(p, q.dtype),
                                 vt)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = mn
    o32 = (acc / l)[..., :d].permute(0, 2, 1, 3).reshape(q.shape)
    return o32.to(q.dtype), (m * c + torch.log2(l))[..., 0], o32


def attention_bwd_kernel_arithmetic(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, o32: torch.Tensor,
                                    lse: torch.Tensor, do: torch.Tensor,
                                    n_head: int
                                    ) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """K5 as a plain function: P recomputed from the split (f32) or exact
    (bf16) operands and the forward's base-2 ``lse``; Dr = rowsum(dO O)
    from the f32 output ``o32``; the four products S, dP, and dQ, dK, dV
    with P or dS fed back split; the gradients rounded to the input type.
    The designs by head dim as :func:`attention_kernel_arithmetic`'s (the
    f32 dK of the wg and stream designs from the scaled q, as the JAX
    kernel's). Over at most ``one_group_keys`` keys the dq kernel takes the
    TPU kernel's Dr = rowsum(dP P) with P divided by its row sum (its dS
    from that P); the dk/dv kernel reads that Dr beside its own P."""
    d = q.shape[2] // n_head
    dz = _Design(d, q.dtype)
    qs = _operands(dz.q_heads(q, n_head))
    ks, vs, dos = (_operands(dz.heads(x, n_head)) for x in (k, v, do))
    p = torch.exp2(dz.mm("bqhd,bkhd->bhqk", qs, ks) * dz.c - lse[..., None])
    dp = dz.mm("bqhd,bkhd->bhqk", dos, vs)
    if k.shape[1] <= dz.one_group_keys:
        pn = p / p.sum(dim=-1, keepdim=True)
        dr = (pn * dp).sum(dim=-1, keepdim=True)
        ds_q = pn * (dp - dr)
    else:
        dr = (_heads(do, n_head).float() * _heads(o32, n_head)).sum(-1)
        dr = dr.permute(0, 2, 1)[..., None]
        ds_q = p * (dp - dr)
    ds = p * (dp - dr)
    dq = dz.dq(dz.mm("bhqk,bkhd->bqhd", _fed_back(ds_q, q.dtype), ks))
    dk = dz.dk(dz.mm("bhqk,bqhd->bkhd", _fed_back(ds, q.dtype), qs))
    dv = dz.mm("bhqk,bqhd->bkhd", _fed_back(p, q.dtype), dos)
    return tuple(x[..., :d].reshape(y.shape).to(y.dtype)
                 for x, y in ((dq, q), (dk, k), (dv, v)))


# floats after each 4-row chunk of a transposed f32 tile in shared memory
# (csrc/mha_wg.cuh: kTPad; never written, zero here)
WG_TPAD = 4


def wg_operand(x: torch.Tensor, transposed: bool = False, f: float = 1.0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """An f32 tile (R rows, D) as the wg design's f32 kernels hold it in
    shared memory once it has landed (csrc/mha_wg.cuh: split_tile): x times
    ``f`` split into hi (rounded to TF32) and lo (the rest, cut), each laid
    out flat as [16-byte chunk][row][4]; ``transposed``: as
    [4-row chunk][column][4 rows] with :data:`WG_TPAD` floats after each
    chunk, the rows of each 8 in :data:`PAIR_SLOTS` order (what a product
    contracted over the rows reads). Returns (hi, lo), flat."""
    from .megakernel import split_tf32
    R, D = x.shape
    hi, lo = split_tf32(x.float() * f)

    def lay(t):
        if not transposed:
            return t.reshape(R, D // 4, 4).permute(1, 0, 2).reshape(-1)
        rows = [8 * (k // 8) + PAIR_SLOTS[k % 8] for k in range(R)]
        t = t[rows].reshape(R // 4, 4, D).permute(0, 2, 1).reshape(R // 4, -1)
        return torch.nn.functional.pad(t, (0, WG_TPAD)).reshape(-1)
    return lay(hi), lay(lo)


def wg_fed_back(p: torch.Tensor, dtype: torch.dtype
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """A tile of scores (64 rows, N columns) fed back as the wg design's A
    operand (csrc/mha_wg.cuh: feed_tf32, feed_bf16), as the values of each
    contraction step's slots: f32, steps of 8 columns with slot t holding
    column PAIR_SLOTS[t] (hi cut to TF32, lo the rest as TF32 reads it);
    bf16, steps of 16 columns in their own order (a bf16 hi + lo pair).
    Returns (hi, lo), each (64, N) in slot order."""
    hi, lo = _fed_back(p, dtype)
    if dtype != torch.float32:
        return hi, lo
    cols = [8 * (k // 8) + PAIR_SLOTS[k % 8] for k in range(p.shape[1])]
    return hi[:, cols], lo[:, cols]
