"""The card's peak rates, the least time a piece of work can take on it, and
the work of one whole reverse step: one count for ``chip_smoke.py`` and the
bench entry (``bench.py`` of this package), so that the two never count
differently.

The peaks are NVIDIA's H100 SXM data sheet, dense, at the card's full power
limit of 700 W: 3.35 TB/s of device memory, 67 TFLOP/s f32 outside the
tensor cores, 989 TFLOP/s for bf16 operands and 495 TFLOP/s TF32 on the
tensor cores. A card set below 700 W runs slower under load, so every time
stands beside :func:`card`'s name and power limit.
"""
from __future__ import annotations

import subprocess

__all__ = ["PEAK_BYTES", "PEAK_F32", "PEAK_BF16", "PEAK_TF32", "bound",
           "attention_work", "sample_step_work", "codebook_work",
           "megakernel_work", "megakernel_bound", "card"]

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12


def bound(nbytes: float, flops_f32: float, flops_bf16: float = 0.0,
          flops_tf32: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    (each input read once, each output written once) over the memory rate
    and the operations over the peak rate of their operands' type. Returns
    (ms, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (flops_f32 / PEAK_F32 + flops_bf16 / PEAK_BF16
             + flops_tf32 / PEAK_TF32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_work(b: int, lq: int, lk: int, n_head: int, d: int,
                   backward: bool = False) -> tuple[float, float, float]:
    """(bytes in f32, FLOP, exponentials) of one attention call at any head
    dim ``d``: K2 (``backward`` False) reads q, k, v and writes o once, and
    does QK^T and PV, 4 b H Lq Lk d operations, with one exponential a
    (query, key, head); K5 reads q, k, v, o, dO and writes dq, dk, dv once,
    and does five products (S, dP, dV, dQ, dK), 10 b H Lq Lk d operations,
    with one exponential a pair in each of its two kernels. Bytes halve for
    bf16 tensors."""
    c = n_head * d
    pairs = float(b) * n_head * lq * lk
    if backward:
        return 4.0 * 4 * b * (lq + lk) * c, 10.0 * pairs * d, 2.0 * pairs
    return 4.0 * 2 * b * (lq + lk) * c, 4.0 * pairs * d, pairs


def sample_step_work(b: int, nb: int, kv: int, L: int
                     ) -> tuple[float, float]:
    """(bytes, f32 operations) of one sampler step (K1) at any class count:
    ``nb`` rows of logits (2 ``b`` under CFG) of ``kv`` = K - 1 classes at
    ``L`` positions read once in f32, ``b`` x ``L`` int64 tokens read and
    written once; no matrix product, ~60 f32 operations a logit (the
    reductions and the posterior)."""
    return 4.0 * nb * kv * L + 16.0 * b * L, 60.0 * nb * kv * L


def codebook_work(n: int, k: int, d: int) -> tuple[float, float]:
    """(bytes, FLOP) of one codebook lookup with its statistics (K6) at any
    code dim: x (``n``, ``d``) and the codebook (``k``, ``d``) read once,
    ``encode_sum`` (k, d), ``n_total`` (k) and the indices written once; the
    distances' product 2 n k d (K6 computes it as three TF32 products, so
    its bound is :func:`bound` with ``flops_tf32`` three times this)."""
    return 4.0 * (n * d + 2 * k * d + k) + 8.0 * n, 2.0 * n * k * d


def megakernel_work(b: int, n_br: int, L: int, n_layer: int, hidden: int,
                    kv: int, s_len: int, as_bias: bool, n_embd: int = 64,
                    n_head: int = 16) -> tuple[float, float, float]:
    """(bytes, f32 FLOP, bf16 FLOP) one reverse step needs at ``n_embd`` in
    ``n_head`` heads (the serving width, 64 in 16, by default): ``b`` rows,
    ``n_br`` branches (2 under CFG), ``L`` tokens, an MLP of ``hidden``,
    ``kv`` = K - 1 logits, a condition of ``s_len`` tokens (``as_bias``: one
    token, a per-layer bias). QK^T and PV take operands rounded to bf16
    (tensor-core rate), 2 d multiply-adds each per (query, key, head); the
    other products f32 activations (QKV, proj, the MLP, the
    cross-attention's query and proj when it is not a bias, the logits,
    each once). Bytes: the bf16 weights, the f32 tables and the tokens in
    and out."""
    c, rows = n_embd, b * n_br * L
    d = n_embd // n_head
    per_layer = 2 * c * 3 * c + 2 * c * c + 4 * c * hidden
    f_bf16 = 4.0 * L * n_head * d * rows * n_layer
    if not as_bias:
        per_layer += 4 * c * c
        f_bf16 += 4.0 * s_len * n_head * d * rows * n_layer
    f_f32 = float(per_layer) * rows * n_layer + 2.0 * c * kv * rows
    sp = 8 if as_bias else -(-s_len // 8) * 8
    nbytes = (2.0 * n_layer * (4 * c * c + c * 3 * c + 2 * c * hidden)
              + 2.0 * c * kv + 4.0 * (kv + 1) * c + 4.0 * L * c
              + 4.0 * 2 * b * n_br * n_layer * sp * c + 16.0 * b * L)
    return nbytes, f_f32, f_bf16


def megakernel_bound(nbytes: float, flops_f32: float, flops_bf16: float, *,
                     weights_bf16: bool) -> tuple[float, str]:
    """:func:`bound` of a whole step (:func:`megakernel_work`) with each f32
    product on the tensor cores by its cheapest exact route: with bf16
    weights the lesser of two TF32 products at 495 TFLOP/s (the
    activations split in TF32 halves, hi and lo; a bf16 weight is a TF32
    value) and three bf16 products at 989 (the activations in three bf16
    planes: 3 / 989 < 2 / 495), at every width, since the bound is the
    work's and not a kernel's; with f32 weights three TF32 products (the
    weight split too: hi hi + hi lo + lo hi). The bf16 products at 989
    TFLOP/s."""
    if weights_bf16:
        return min(bound(nbytes, 0.0, flops_bf16, flops_tf32=2.0 * flops_f32),
                   bound(nbytes, 0.0, flops_bf16 + 3.0 * flops_f32))
    return bound(nbytes, 0.0, flops_bf16, flops_tf32=3.0 * flops_f32)


def card() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
