"""The whole-step sampler route: one D3PM reverse step per kernel launch.

Replaces the TPU kernels ``gif_synthesis_with_discrete_diffusion_tpu/ops/
megakernel.py: _kernel_packed`` (K3: both classifier-free-guidance branches
of a batch row in one program) and ``_kernel`` (K4: one program per (row,
branch); guidance 1, and CFG on grids over 1024 tokens), both reached through
``_megakernel_step`` with the sampler tail ``_sample_block``. One step is

  token embedding + positions -> n_layer x [AdaLN -> self-attention ->
  cross-attention (or a per-layer bias for a one-token condition) -> LN ->
  GELU2 MLP] -> LN -> logits -> log_softmax -> CFG combine -> analytic
  posterior -> Gumbel-max

and reads the packed weights, the tables and the (B, L) tokens and writes
the (B, L) tokens: the (2B, K-1, L) logits and the (B, K, L) posterior never
reach device memory. The CUDA source is ``csrc/megakernel_step.cu`` (its
header says what bounds it on Hopper, how it is laid out, and which of its
code is the serving width's own: n_embd 64 in heads of 4); nvcc builds one
library per n_embd and head dim from it at the first launch, bound through
ctypes. What the TPU package
computes outside its kernel stays plain torch here too:
:func:`pack_denoiser_params`, the AdaLN tables, the cross-attention K/V (or
bias) of the condition, the positions.

:func:`megakernel_step_reference` is the plain version of one step. It
rounds where the kernels round (``q / sqrt(d)``, ``k``, ``v`` and the
softmax probabilities, after the division by their row sum, go through
bf16; every sum is f32), so K3, K4 and the TPU kernels all compute its
function. CPU tensors take it; CUDA tensors launch K3 or K4 or raise.

The kernels take every n_embd up to 2048 in any number of heads that
divides it, with any MLP width (:func:`widths_fit`: the JAX kernels' whole
domain, whose one layer of bf16 weights, 28 n_embd^2 bytes, no longer fits
their 100 MiB of VMEM past n_embd ~1935). With bf16 weights, at every
width but the serving one (:func:`takes_wgmma`), a tile's activations live
in per-block slabs in device memory (the scratch's ``act`` and ``hact``,
allocated at the first such launch) as three bf16 planes
(:func:`split3_bf16`, :func:`slab_plane_offset`) that TMA copies land for
``wgmma`` (the C entry encodes the tensor maps and the wrapper raises if one
is refused); up to n_embd 64 the tile's own planes stay in the block's
shared memory. With f32 weights they stay in shared memory up to n_embd 512;
above it they no longer fit a block beside the weight tiles and go to the
slabs too, streamed beside the weight tiles. The
tables are made in the kernels' layout: every
n_embd-wide or MLP-wide axis padded with zero columns to a multiple of 8
(:func:`storage_width`; a no-op at every configuration of the repo), once,
by :func:`pack_denoiser_params` (and so by :func:`positions`,
:func:`cross_tables` and the AdaLN table). The plain version reads the same
layout: its LayerNorm takes the true n_embd and its attention each head's
true columns, and every padded column stays zero.

Where the kernels' arithmetic departs from the plain version's by more than
the order of a sum, it is stated here as a plain function that the CPU
tests bound: the TF32 split of the f32 products (:func:`split_matmul`;
with bf16 weights the three bf16 planes, :func:`planes_matmul`, at every
width but the serving one; :func:`kernel_matmul` says which), the
polynomial share of the exponentials (:func:`exp2_poly`), the shift of the
scores (:func:`softmax_shift`); :func:`megakernel_step_kernel_arithmetic`
is the step computed with all three.

Gumbel noise comes from Philox keyed by (seed, row, position, class): the
sampled tokens agree with the TPU kernels and the plain version in
distribution only; ``sample=False`` (argmax) is what is compared exactly.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.d3pm import D3PMSchedule
from ..models.denoiser import SinusoidalPosEmb
from . import cuda_build
from .sampler_kernel import fused_sample_step_reference, schedule_rows

__all__ = ["MEGAKERNEL_MAX_SEQ", "pack_denoiser_params", "cross_tables",
           "positions", "megakernel_step", "megakernel_step_reference",
           "megakernel_hidden_reference", "kernels_fit",
           "megakernel_sample_tokens", "prepare_sampling", "alloc_scratch",
           "scratch_head_dim", "storage_width", "phase_s_products",
           "stamp_count", "split_tf32", "split_matmul", "split3_bf16",
           "planes_matmul", "kernel_matmul", "takes_wgmma",
           "slab_plane_offset", "exp2_poly",
           "poly_exp_mask", "softmax_shift", "widths_fit",
           "megakernel_step_kernel_arithmetic", "KERNEL_POLY_SHARE",
           "KERNEL_SHIFT_SLACK", "EXACT_MAX"]

# the largest grid the route serves (the MSRVTT 48 x 48 latent grid)
MEGAKERNEL_MAX_SEQ = 2304
# CFG runs in the packed kernel up to this many tokens, else on the
# (row, branch) grid
_PACK_CFG_MAX_SEQ = 1024
_LN_EPS = 1e-6
# the widths the CUDA kernels take (one library per n_embd and head dim):
# every n_embd up to 2048 (the JAX kernels' reach: one layer's bf16 weights
# fill their 100 MiB of VMEM at ~1935), any head dim that divides it, any
# MLP width
_KERNEL_EMBD_MAX = 2048
# above this n_embd the 64-row activation tile no longer fits a block's
# 227 KB beside the weight tiles: the kernels keep it in slabs in device
# memory at either weight type (csrc: MK_WIDE)
_SLAB_EMBD = 512
# the serving width (n_embd, head dim), whose own code (csrc: MK_SERVING)
# keeps every product on mma.sync; MK_GENERAL=1 builds it from the general
# code instead
_SERVING_WIDTHS = (64, 4)
_GENERAL = "MK_GENERAL=1"
_KERNEL_DOMAIN = (f"n_embd from 1 to {_KERNEL_EMBD_MAX} in heads that divide "
                  f"it, any MLP width")
# a row's padding in device memory (csrc: kC) and phase S's widest chunk of
# P V output dims (csrc: kNOC, 16 tiles of 8)
_STORAGE_STEP = 8
_OUTPUT_CHUNK = 128

_WEIGHT_NAMES = ("wqkv", "wproj", "wq_c", "wproj_c", "wfc", "wpj", "wlog")
# the order of the pointer table handed to the launcher (csrc: enum Ptr)
_PTR_NAMES = ("sched", "tokens", "out", "adaln", "kc", "vc", "emb", "pos",
              "wqkv", "bqkv", "wproj", "bproj", "wq_c", "bq_c", "wproj_c",
              "bproj_c", "ln2_s", "ln2_b", "wfc", "bfc", "wpj", "bpj",
              "lno_s", "lno_b", "wlog", "blog", "x", "q", "k", "v", "o",
              "kmax", "stamps", "act", "hact")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def widths_fit(n_embd: int, n_head: int, hidden: int) -> bool:
    """Whether the CUDA kernels take these widths: every n_embd from 1 to
    2048, in any number of heads that divides it (head dims 1 to 2048),
    with any MLP width; the JAX megakernel's whole domain."""
    return (0 < n_embd <= _KERNEL_EMBD_MAX and n_head > 0
            and n_embd % n_head == 0 and hidden > 0)


def storage_width(n: int) -> int:
    """An n_embd- or MLP-wide row as the kernels lay it out in device
    memory: padded with zero columns to a multiple of 8 (csrc: kC)."""
    return _round_up(n, _STORAGE_STEP)


def kernels_fit(transformer: nn.Module) -> bool:
    """Whether the CUDA kernels take this denoiser's widths
    (:func:`widths_fit`): what 'auto' route selection reads.
    :func:`megakernel_step` raises for the rest."""
    block = transformer.block0
    return widths_fit(transformer.ln_out.normalized_shape[0],
                      block.attn1.n_head, block.mlp_fc.out_features)


# ---------------------------------------------------------------------------
# what stays outside the kernel: packing, tables, the condition's K/V
# ---------------------------------------------------------------------------

def _pad(x: torch.Tensor, groups: int = 1, axis: int = -1) -> torch.Tensor:
    """``x`` with ``axis`` cut in ``groups`` equal runs of n, each padded
    with zeros to :func:`storage_width` (n)."""
    x = x.movedim(axis, -1)
    n = x.shape[-1] // groups
    ns = storage_width(n)
    if ns != n:
        x = F.pad(x.reshape(*x.shape[:-1], groups, n), (0, ns - n)).reshape(
            *x.shape[:-1], groups * ns)
    return x.movedim(-1, axis)


def pack_denoiser_params(transformer: nn.Module,
                         weights_dtype: torch.dtype = torch.bfloat16
                         ) -> dict[str, torch.Tensor]:
    """Stack the denoiser's per-layer weights along a leading layer axis, in
    the (in, out) layout (``nn.Linear`` holds (out, in)). The matrices the
    kernel multiplies by (``wqkv``, ``wproj``, ``wq_c``, ``wproj_c``,
    ``wfc``, ``wpj``, ``wlog``) take ``weights_dtype``; biases, LayerNorm
    and AdaLN parameters, the condition's K/V projections and the embedding
    tables stay f32. Every n_embd-wide and MLP-wide axis is padded with zero
    columns to :func:`storage_width` (each of q | k | v and scale | shift on
    its own); the AdaLN linears' input (the timestep's sinusoid), the
    condition's width and the classes are not."""
    blocks = [getattr(transformer, f"block{i}")
              for i in range(transformer.n_layer)]
    f32 = torch.float32

    def stack(fn, dtype=f32):
        return torch.stack([fn(b).detach() for b in blocks]).to(
            dtype).contiguous()

    def w(lin, groups=1, rows=True, cols=True):   # (out, in) -> (in, out)
        x = _pad(lin.weight.t(), groups) if cols else lin.weight.t()
        return _pad(x, axis=0) if rows else x

    def table(x, groups=1):
        return _pad(x.detach().to(f32), groups).contiguous()

    wd = weights_dtype
    ce = transformer.content_emb
    return {
        "wqkv": stack(lambda b: torch.cat(
            [w(b.attn1.query), w(b.attn1.key), w(b.attn1.value)], dim=1), wd),
        "bqkv": stack(lambda b: _pad(torch.cat(
            [b.attn1.query.bias, b.attn1.key.bias, b.attn1.value.bias]), 3)),
        "wproj": stack(lambda b: w(b.attn1.proj), wd),
        "bproj": stack(lambda b: _pad(b.attn1.proj.bias)),
        "wq_c": stack(lambda b: w(b.attn2.query), wd),
        "bq_c": stack(lambda b: _pad(b.attn2.query.bias)),
        "wproj_c": stack(lambda b: w(b.attn2.proj), wd),
        "bproj_c": stack(lambda b: _pad(b.attn2.proj.bias)),
        "ln2_s": stack(lambda b: _pad(b.ln2.weight)),
        "ln2_b": stack(lambda b: _pad(b.ln2.bias)),
        "wfc": stack(lambda b: w(b.mlp_fc), wd),
        "bfc": stack(lambda b: _pad(b.mlp_fc.bias)),
        "wpj": stack(lambda b: w(b.mlp_proj), wd),
        "bpj": stack(lambda b: _pad(b.mlp_proj.bias)),
        # AdaLN linears, applied per timestep outside the kernel
        "ada_w": stack(lambda b: torch.stack(
            [w(b.ln1.linear, 2, rows=False),
             w(b.ln1_1.linear, 2, rows=False)])),
        "ada_b": stack(lambda b: torch.stack(
            [_pad(b.ln1.linear.bias, 2), _pad(b.ln1_1.linear.bias, 2)])),
        # the condition's K/V projections, applied once per sampling call
        "wk_c": stack(lambda b: w(b.attn2.key, rows=False)),
        "bk_c": stack(lambda b: _pad(b.attn2.key.bias)),
        "wv_c": stack(lambda b: w(b.attn2.value, rows=False)),
        "bv_c": stack(lambda b: _pad(b.attn2.value.bias)),
        "emb": table(ce.emb.weight),
        "height": table(ce.height_emb.weight),
        "width": table(ce.width_emb.weight),
        "lno_s": table(transformer.ln_out.weight),
        "lno_b": table(transformer.ln_out.bias),
        "wlog": w(transformer.to_logits, cols=False).detach().to(
            wd).contiguous(),
        "blog": transformer.to_logits.bias.detach().to(f32).contiguous(),
    }


def _adaln_table(packed: dict, t: torch.Tensor, num_steps: int,
                 n_embd: int) -> torch.Tensor:
    """AdaLN scale||shift rows for timestep(s) ``t``: () -> (n_layer, 2,
    2Cs), (T,) -> (T, n_layer, 2, 2Cs) with Cs = storage_width(n_embd);
    [..., :Cs] scales, [..., Cs:] shifts."""
    t = torch.as_tensor(t, device=packed["ada_w"].device)
    emb = F.silu(SinusoidalPosEmb(num_steps, n_embd)(t.reshape(-1)))
    out = torch.einsum("td,lade->tlae", emb, packed["ada_w"]) \
        + packed["ada_b"]
    return out[0] if t.ndim == 0 else out


def positions(packed: dict, seq_len: int) -> torch.Tensor:
    """(seq_len, Cs) factorised height + width position embeddings."""
    pos = packed["height"][:, None, :] + packed["width"][None, :, :]
    return pos.reshape(-1, pos.shape[-1])[:seq_len].contiguous()


def cross_tables(packed: dict, cond_emb: torch.Tensor,
                 cf_cond_emb: Optional[torch.Tensor], use_cfg: bool,
                 cross_as_bias: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The condition's side of cross-attention, per row, branch and layer:
    (kc, vc), each (B, n_br, n_layer, sp, Cs) f32 with the condition length
    padded to a multiple of 8. With ``cross_as_bias`` (a one-token
    condition: softmax over one key is 1) row 0 of ``kc`` holds the whole
    cross-attention output ``v @ wproj_c + bproj_c`` and ``vc`` is ``kc``.
    """
    def cross_kv(c):
        c = c.to(torch.float32)
        k = torch.einsum("bsd,lde->blse", c, packed["wk_c"]) \
            + packed["bk_c"][None, :, None, :]
        v = torch.einsum("bsd,lde->blse", c, packed["wv_c"]) \
            + packed["bv_c"][None, :, None, :]
        return k, v

    def cross_bias(c):
        # v goes through bf16 first, as the general path's V operand does
        v = cross_kv(c)[1][:, :, 0].to(torch.bfloat16).to(torch.float32)
        return (torch.einsum("blc,lce->ble", v,
                             packed["wproj_c"].to(torch.float32))
                + packed["bproj_c"][None])

    branches = [cond_emb]
    if use_cfg:
        branches.append(cf_cond_emb.expand(cond_emb.shape))
    if cross_as_bias:
        kc = torch.stack([cross_bias(c) for c in branches], dim=1)
        kc = F.pad(kc[:, :, :, None, :], (0, 0, 0, 7)).contiguous()
        return kc, kc
    kvs = [cross_kv(c) for c in branches]
    kc = torch.stack([k for k, _ in kvs], dim=1)     # (B, n_br, n_layer, S, C)
    vc = torch.stack([v for _, v in kvs], dim=1)
    pad = _round_up(kc.shape[3], 8) - kc.shape[3]
    return (F.pad(kc, (0, 0, 0, pad)).contiguous(),
            F.pad(vc, (0, 0, 0, pad)).contiguous())


# ---------------------------------------------------------------------------
# the plain version of one step
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _ln(x: torch.Tensor, n: int) -> torch.Tensor:
    """LayerNorm's normalisation of x's first ``n`` columns (the true
    n_embd), the columns past them zero."""
    t = x[..., :n]
    mu = t.mean(dim=-1, keepdim=True)
    var = (t - mu).square().mean(dim=-1, keepdim=True)
    return F.pad((t - mu) * torch.rsqrt(var + _LN_EPS), (0, x.shape[-1] - n))


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w.to(torch.float32)


def _scale_queries(q: torch.Tensor, d: int) -> torch.Tensor:
    """q / sqrt(d) through bf16 as the TPU kernels and K3 / K4 take it: q
    times fl32(1 / sqrt(d)) (1 / sqrt(d) in double, rounded once to f32) in
    f32, then rounded to bf16. Not a division: at d = 8 or 12 the two land
    on different bf16 values for a few q in a million."""
    return _bf16(q * (1.0 / math.sqrt(d)))


def _attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_head: int, valid: int) -> torch.Tensor:
    """q: (R, Lq, C); k, v: (R, Lk, C), the first ``valid`` keys real.
    Operands through bf16, sums in f32, the probabilities through bf16 after
    the division by their row sum."""
    R, Lq, C = q.shape
    d = C // n_head
    qs = _scale_queries(q, d).reshape(R, Lq, n_head, d)
    kb = _bf16(k[:, :valid]).reshape(R, valid, n_head, d)
    vb = _bf16(v[:, :valid]).reshape(R, valid, n_head, d)
    s = torch.einsum("rqhd,rkhd->rhqk", qs, kb)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = _bf16(e / e.sum(dim=-1, keepdim=True))
    return torch.einsum("rhqk,rkhd->rqhd", p, vb).reshape(R, Lq, C)


def _hidden(packed, tokens, adaln, kc, vc, pos, *, n_layer, n_head, n_embd,
            use_cfg, s_valid, cross_as_bias, mm, self_attention):
    """The denoiser's part of a step over a product ``mm(a, w)`` and a
    self-attention ``self_attention(q, k, v, n_head, valid)``, on the tables'
    layout: rows of Cs = storage_width(n_embd), the padding zero."""
    b, L = tokens.shape
    n_br = 2 if use_cfg else 1
    C, Cs = n_embd, storage_width(n_embd)

    def heads(fn, q, k, v, valid):      # the true columns, then the padding
        return F.pad(fn(q[..., :C], k[..., :C], v[..., :C], n_head, valid),
                     (0, Cs - C))

    x = packed["emb"][tokens] + pos                        # (B, L, Cs)
    x = x[:, None].expand(b, n_br, L, Cs).reshape(b * n_br, L, Cs)
    kc = kc.reshape(b * n_br, n_layer, -1, Cs)
    vc = vc.reshape(b * n_br, n_layer, -1, Cs)
    for i in range(n_layer):
        ada = adaln[i]
        h = _ln(x, C) * (1.0 + ada[0, :Cs]) + ada[0, Cs:]
        qkv = mm(h, packed["wqkv"][i]) + packed["bqkv"][i]
        o = heads(self_attention, qkv[..., :Cs], qkv[..., Cs:2 * Cs],
                  qkv[..., 2 * Cs:], L)
        x = x + mm(o, packed["wproj"][i]) + packed["bproj"][i]
        if cross_as_bias:
            x = x + kc[:, i, 0:1, :]
        else:
            h = _ln(x, C) * (1.0 + ada[1, :Cs]) + ada[1, Cs:]
            qc = mm(h, packed["wq_c"][i]) + packed["bq_c"][i]
            oc = heads(_attention_reference, qc, kc[:, i], vc[:, i], s_valid)
            x = x + mm(oc, packed["wproj_c"][i]) + packed["bproj_c"][i]
        h = _ln(x, C) * packed["ln2_s"][i] + packed["ln2_b"][i]
        h = mm(h, packed["wfc"][i]) + packed["bfc"][i]
        h = h * torch.sigmoid(1.702 * h)                   # GELU2
        x = x + mm(h, packed["wpj"][i]) + packed["bpj"][i]
    return x


def megakernel_hidden_reference(
        packed: dict, tokens: torch.Tensor, adaln: torch.Tensor,
        kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor, *,
        n_layer: int, n_head: int, n_embd: int, use_cfg: bool, s_valid: int,
        cross_as_bias: bool = False) -> torch.Tensor:
    """The denoiser's part of the plain step: the final hidden state before
    the output LayerNorm, (B * n_br, L, storage_width(C)) with rows ordered
    (row, branch), zero past C, which the kernels leave in their ``x``
    scratch."""
    return _hidden(packed, tokens, adaln, kc, vc, pos, n_layer=n_layer,
                   n_head=n_head, n_embd=n_embd, use_cfg=use_cfg,
                   s_valid=s_valid, cross_as_bias=cross_as_bias, mm=_mm,
                   self_attention=_attention_reference)


def megakernel_step_reference(
        packed: dict, tokens: torch.Tensor, adaln: torch.Tensor,
        kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
        sched_row: torch.Tensor, seed: int, *, n_layer: int, n_head: int,
        n_embd: int, num_classes: int, guidance: float, use_cfg: bool,
        s_valid: int, sample: bool = True, cross_as_bias: bool = False,
        return_posterior: bool = False):
    """Plain PyTorch version of one whole reverse step (K3 and K4 compute
    the same function). Same arguments as :func:`megakernel_step`; with
    ``return_posterior`` also the (B, K, L) log-posterior. The Gumbel noise
    comes from a ``torch.Generator`` seeded by ``seed``."""
    return _step(packed, tokens, adaln, kc, vc, pos, sched_row, seed,
                 n_layer=n_layer, n_head=n_head, n_embd=n_embd,
                 num_classes=num_classes, guidance=guidance, use_cfg=use_cfg,
                 s_valid=s_valid, sample=sample, cross_as_bias=cross_as_bias,
                 return_posterior=return_posterior, mm=_mm,
                 self_attention=_attention_reference)


def _step(packed, tokens, adaln, kc, vc, pos, sched_row, seed, *, n_layer,
          n_head, n_embd, num_classes, guidance, use_cfg, s_valid, sample,
          cross_as_bias, return_posterior, mm, self_attention,
          mm_logits=None):
    """The step over ``mm`` for the denoiser's products and ``mm_logits``
    (default ``mm``) for the logits'."""
    b, L = tokens.shape
    n_br = 2 if use_cfg else 1
    x = _hidden(packed, tokens, adaln, kc, vc, pos, n_layer=n_layer,
                n_head=n_head, n_embd=n_embd, use_cfg=use_cfg,
                s_valid=s_valid, cross_as_bias=cross_as_bias, mm=mm,
                self_attention=self_attention)
    h = _ln(x, n_embd) * packed["lno_s"] + packed["lno_b"]
    z = ((mm_logits or mm)(h, packed["wlog"]) + packed["blog"]).reshape(
        b, n_br, L, -1)
    logits2 = torch.cat([z[:, j] for j in range(n_br)], dim=0)
    return fused_sample_step_reference(
        logits2.transpose(1, 2), tokens, sched_row, seed, guidance=guidance,
        num_classes=num_classes, sample=sample,
        return_posterior=return_posterior)


# ---------------------------------------------------------------------------
# where the kernels' arithmetic departs from the plain version's by more
# than the order of a sum, as plain functions (the CPU tests bound each)
# ---------------------------------------------------------------------------

# of every 16 exponentials a thread of phase S takes, how many go to the
# polynomial, in the row-sum sweep and in the probabilities' sweep
# (csrc/megakernel_step.cu: MK_POLY1, MK_POLY2)
KERNEL_POLY_SHARE = (4, 0)
# how far above the row maximum the softmax shift may provably lie (nats;
# csrc: kShiftSlack), and the queries that decide together (a warp's)
KERNEL_SHIFT_SLACK = 40.0
_SHIFT_GROUP = 32
_LOG2E = 1.4426950408889634
_EXP2_COEFFS = {
    # minimax on [-1/2, 1/2], relative error 2^-13.7: the row sum only
    3: (5.5171665e-2, 2.4261112e-1, 6.9326099e-1, 0.99992807),
    # Taylor to degree 6, relative error ~1.2e-7: f32's last bits
    6: (1.5403530393e-4, 1.3333558146e-3, 9.6181291076e-3, 5.5504108665e-2,
        2.4022650696e-1, 6.9314718056e-1, 1.0),
}


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (11 significant bits), round to nearest, ties away from
    zero, for finite values (``cvt.rna.tf32.f32``)."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a = hi + lo`` to within 2^-21 |a|, both TF32 values: ``hi`` is
    ``a`` rounded to TF32, ``a - hi`` is exact in f32 and ``lo`` is that
    difference cut to TF32's 11 bits."""
    hi = _tf32(a)
    lo = (a - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def split_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` as the kernels' tile product takes it on the tensor cores:
    the f32 activations split in two TF32 halves, both multiplied by the
    weights and summed in f32. A bf16 weight is a TF32 value; an f32 weight
    is split too and ``lo_a @ lo_w`` (2^-21 of the product) is dropped."""
    hi, lo = split_tf32(a)
    w32 = w.to(torch.float32)
    if w.dtype == torch.bfloat16:
        return lo @ w32 + hi @ w32
    wh, wl = split_tf32(w32)
    return hi @ wl + lo @ wh + hi @ wh


def split3_bf16(a: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``a = hi + mid + lo``, three bf16 values (as f32 tensors), each the
    bf16 rounding (to nearest) of what the ones before leave: ``hi`` of
    ``a``, ``mid`` of ``a - hi``, ``lo`` of ``a - hi - mid`` (each
    difference exact in f32). They hold an f32 ``a`` exactly wherever
    |a| >= 2^-109 (every bit of ``a`` then lies at or above bf16's
    smallest spacing, 2^-133; below, to within 2^-134) and ``hi`` is
    finite (|a| < 2^128 (1 - 2^-9), bf16's largest): what the wide kernels
    write where an activation slab is written (csrc: split3)."""
    a = a.to(torch.float32)
    hi = _bf16(a)
    r = a - hi
    mid = _bf16(r)
    return hi, mid, _bf16(r - mid)


def planes_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` as the kernels take it with bf16 weights wherever
    :func:`takes_wgmma` (csrc: wg_product): the f32 activations as their
    three bf16 planes (:func:`split3_bf16`), each multiplied by the bf16
    weights (a product of two bf16 values is exact in f32) and summed in
    f32, lo first."""
    hi, mid, lo = split3_bf16(a)
    w32 = w.to(torch.float32)
    return lo @ w32 + mid @ w32 + hi @ w32


def takes_wgmma(n_embd: int, head_dim: int, weights_dtype: torch.dtype,
                defines: tuple[str, ...] = ()) -> bool:
    """Whether K3 / K4 at n_embd in heads of ``head_dim`` run phases A and
    B's products on ``wgmma``, their activations as three bf16 planes in
    the per-block slabs (csrc: MK_WG): with bf16 weights at every width but
    the serving one (n_embd 64 in heads of 4, whose own code keeps
    ``mma.sync``; the ``MK_GENERAL=1`` build of it takes ``wgmma`` too)."""
    return weights_dtype == torch.bfloat16 and (
        (n_embd, head_dim) != _SERVING_WIDTHS or _GENERAL in defines)


def kernel_matmul(n_embd: int, head_dim: int,
                  defines: tuple[str, ...] = ()):
    """The product K3 / K4 take for the denoiser's layers at n_embd in
    heads of ``head_dim``, as ``mm(a, w)``: :func:`planes_matmul` wherever
    :func:`takes_wgmma` with ``w``'s dtype (bf16 weights at every width but
    the serving one), else :func:`split_matmul`. The logits' product is
    :func:`split_matmul` at every width."""
    def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if takes_wgmma(n_embd, head_dim, w.dtype, defines):
            return planes_matmul(a, w)
        return split_matmul(a, w)
    return mm


def slab_plane_offset(row, col, cols: int, plane=0):
    """Where element (``row``, ``col``) of a 64-row tile lies in bf16
    plane ``plane`` (0 hi, 1 mid, 2 lo) of a slab of ``cols`` columns (a
    multiple of 8) wherever :func:`takes_wgmma` (csrc: store_planes; up to
    n_embd 64 the tile's planes in shared memory, 64 columns), an element
    index: the planes one after another, 64 ``cols`` elements each, each
    ``[col // 8][row][col % 8]``. A plane's 64-deep chunk (columns 64 i ..)
    is the 8 KB from ``slab_plane_offset(0, 64 i, cols, plane)`` on: in
    that order wgmma's K-major core matrices (8 rows x 8 columns, 128
    bytes), 128 bytes apart along the rows and 1024 along the columns, as
    one TMA box copies them."""
    return plane * 64 * cols + ((col // 8) * 64 + row) * 8 + col % 8


def exp2_poly(x: torch.Tensor, degree: int) -> torch.Tensor:
    """2^x for x <= 0 without the special function unit: x clamped at -126,
    split as n + f with |f| <= 1/2, a polynomial for 2^f evaluated in f32
    by Horner's rule, times 2^n."""
    x = x.to(torch.float32).clamp_min(-126.0)
    n = torch.round(x)          # ties to even, as the magic-number add
    f = x - n
    c = _EXP2_COEFFS[degree]
    p = torch.full_like(f, c[0])
    for ck in c[1:]:
        p = p * f + ck
    return torch.ldexp(p, n.to(torch.int32))


def poly_exp_mask(lq: int, lk: int, share: int,
                  device=None) -> torch.Tensor:
    """(lq, lk) bool: the (query, key) pairs whose exponential phase S takes
    by polynomial when ``share`` of every 16 do. A thread's 16 per block of
    16 keys are indexed by (query tile of 16, key half, row half, key
    parity); the chosen ones are spread evenly over that index."""
    q = torch.arange(lq, device=device)[:, None]
    k = torch.arange(lk, device=device)[None, :]
    idx = ((q >> 4) & 1) * 8 + ((k >> 3) & 1) * 4 + ((q >> 3) & 1) * 2 \
        + (k & 1)
    return (idx * share) % 16 + share > 15


def softmax_shift(s: torch.Tensor, qs: torch.Tensor, kb: torch.Tensor
                  ) -> torch.Tensor:
    """The shift phase S subtracts from the scores before the exponentials.
    s: (R, H, Lq, Lk) scores; qs: (R, Lq, H, d) and kb: (R, Lk, H, d), the
    rounded operands. Softmax does not change under a shift, so the exact
    row maximum is taken only where it has to be: ``sum_d |q_d| max_keys
    |k_d|`` bounds a query's scores from above, and serves as the shift
    wherever it lies within :data:`KERNEL_SHIFT_SLACK` of the maximum over
    the first 16 keys (a lower bound of the row maximum) for all of a
    group of 32 consecutive queries; else the group takes the exact row
    maxima. Returns (R, H, Lq, 1)."""
    bound = torch.einsum("rqhd,rhd->rhq", qs.abs(),
                         kb.abs().amax(dim=1))[..., None]
    exact = s.amax(dim=-1, keepdim=True)
    safe = bound - s[..., :16].amax(dim=-1, keepdim=True) \
        <= KERNEL_SHIFT_SLACK
    lq = s.shape[2]
    pad = -lq % _SHIFT_GROUP
    grouped = F.pad(safe, (0, 0, 0, pad), value=True).reshape(
        *safe.shape[:2], -1, _SHIFT_GROUP).all(dim=-1)
    safe = grouped.repeat_interleave(_SHIFT_GROUP, dim=-1)[..., :lq, None]
    return torch.where(safe, bound, exact)


def _attention_kernel_arithmetic(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, n_head: int, valid: int
                                 ) -> torch.Tensor:
    """:func:`_attention_reference` with phase S's exponentials: base 2 on
    ``s * log2(e) - shift * log2(e)`` with the shift of
    :func:`softmax_shift`, :data:`KERNEL_POLY_SHARE` of them by
    :func:`exp2_poly` (degree 3 for the row sum, 6 for the probabilities);
    the roundings to bf16 are where the plain version has them."""
    R, Lq, C = q.shape
    d = C // n_head
    qs = _scale_queries(q, d).reshape(R, Lq, n_head, d)
    kb = _bf16(k[:, :valid]).reshape(R, valid, n_head, d)
    vb = _bf16(v[:, :valid]).reshape(R, valid, n_head, d)
    s = torch.einsum("rqhd,rkhd->rhqk", qs, kb)
    x = s * _LOG2E - softmax_shift(s, qs, kb) * _LOG2E
    exact = torch.exp2(x)
    e1 = torch.where(poly_exp_mask(Lq, valid, KERNEL_POLY_SHARE[0], q.device),
                     exp2_poly(x, 3), exact)
    e2 = torch.where(poly_exp_mask(Lq, valid, KERNEL_POLY_SHARE[1], q.device),
                     exp2_poly(x, 6), exact)
    p = _bf16(e2 * (1.0 / e1.sum(dim=-1, keepdim=True)))
    return torch.einsum("rhqk,rkhd->rqhd", p, vb).reshape(R, Lq, C)


def megakernel_step_kernel_arithmetic(
        packed: dict, tokens: torch.Tensor, adaln: torch.Tensor,
        kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
        sched_row: torch.Tensor, seed: int, *, n_layer: int, n_head: int,
        n_embd: int, num_classes: int, guidance: float, use_cfg: bool,
        s_valid: int, sample: bool = True, cross_as_bias: bool = False,
        return_posterior: bool = False):
    """:func:`megakernel_step_reference` with the denoiser's products taken
    as the kernels take them at this width (:func:`kernel_matmul`: with
    bf16 weights the three bf16 planes at every width but the serving one,
    else the TF32 split), the logits' by :func:`split_matmul` and
    self-attention by the kernels' exponentials: what K3 and K4 compute up
    to the order of their sums. For the tests; no path of the port runs
    it."""
    return _step(packed, tokens, adaln, kc, vc, pos, sched_row, seed,
                 n_layer=n_layer, n_head=n_head, n_embd=n_embd,
                 num_classes=num_classes, guidance=guidance, use_cfg=use_cfg,
                 s_valid=s_valid, sample=sample, cross_as_bias=cross_as_bias,
                 return_posterior=return_posterior,
                 mm=kernel_matmul(n_embd, n_embd // n_head),
                 mm_logits=split_matmul,
                 self_attention=_attention_kernel_arithmetic)


# ---------------------------------------------------------------------------
# the kernels' wrapper
# ---------------------------------------------------------------------------

# the build that takes the exact row maximum for every query of phase S (the
# plain build shifts the scores by a bound wherever it provably may): what
# the card's checks hold the plain build against
EXACT_MAX = ("MK_ABLATE=8",)


@functools.cache
def _library(defines: tuple[str, ...] = (),
             widths: tuple[int, int] = (64, 4)) -> ctypes.CDLL:
    """The kernels at ``widths`` (n_embd, head dim) with ``defines``: one
    nvcc run of ``csrc/megakernel_step.cu`` (``MK_C``, ``MK_D``) and one
    library for each, at first use. ``MK_GENERAL=1`` builds the serving
    width (n_embd 64 in heads of 4) from the code of every other width
    (``chip_smoke.py --parent`` times it)."""
    lib = cuda_build.load(
        "megakernel_step.cu",
        defines=(f"MK_C={widths[0]}", f"MK_D={widths[1]}") + tuple(defines))
    lib.megakernel_step.argtypes = [ctypes.c_void_p] * 4
    lib.megakernel_step.restype = ctypes.c_int
    lib.megakernel_grid_blocks.argtypes = [ctypes.c_int]
    lib.megakernel_grid_blocks.restype = ctypes.c_int
    lib.megakernel_qscale.restype = ctypes.c_float
    built = (lib.megakernel_width(0), lib.megakernel_width(1))
    if built != tuple(widths):
        raise RuntimeError(f"megakernel_step: the library built for "
                           f"{widths} reports widths {built}")
    return lib


def stamp_count(n_layer: int) -> int:
    """Length of the int64 ``stamps`` tensor: one device timestamp (ns) at
    the start and after each of the step's 3 * n_layer + 1 phases."""
    return 3 * n_layer + 2


def scratch_head_dim(head_dim: int) -> int:
    """A head's dims in the kernels' q/k/v scratch: the head dim padded with
    zeros to a multiple of 8 (heads of 1 to 4 dims to 4; csrc: kDS)."""
    return 4 if head_dim <= 4 else _round_up(head_dim, 8)


def phase_s_products(head_dim: int) -> dict:
    """FLOP phase S runs per (query, key, head) against the function's 4 d
    (QK^T and P V once each): QK^T once for the row sum and once for each
    output chunk of the probabilities' sweep (``chunks``: heads wider than
    128 take P V's output 128 dims or fewer at a time, each chunk from a
    sweep of its own over the keys; csrc: kNOC), P V once, all over the
    head's dims as the tensor cores take them (the scratch's padding; the
    mma is 8 deep at least). Not counted: the first 16 keys' scores of the
    shift's check, and the exact maxima's sweep where a warp needs it (the
    data decides). ``recompute``: the share of the kernel's FLOP that the
    chunks after the first add; ``padding``: the share of zero dims."""
    ds = max(scratch_head_dim(head_dim), 8)
    chunks = -(-ds // _OUTPUT_CHUNK)
    kernel = 2 * ds * (2 + chunks)
    return dict(chunks=chunks, function=4 * head_dim, kernel=kernel,
                recompute=(chunks - 1) * 2 * ds / kernel,
                padding=1 - head_dim / ds)


def alloc_scratch(batch: int, n_br: int, seq_len: int,
                  device: torch.device, *, n_embd: int, n_head: int
                  ) -> dict[str, torch.Tensor]:
    """The kernels' scratch in device memory: the hidden state, the
    rounded q/k/v (head-major, (R, H, L, DS) with DS =
    :func:`scratch_head_dim`; the padding stays zero), the attention
    output, and per (row-branch, head, dim) the largest |k| over the keys
    (zero between launches: a step clears what it has used). The hidden
    state and the attention output are :func:`storage_width` wide, their
    padding zero (the output's from here on, the state's from a step's
    first phase; x[..., :n_embd] is the state). The first launch that needs
    them (bf16 weights wherever :func:`takes_wgmma`; above n_embd 512 at
    either weight type) adds the kernels' per-block slabs (``act``,
    ``hact``).
    Allocated once per sampling call."""
    r = batch * n_br
    cs, d = storage_width(n_embd), n_embd // n_head
    bf = dict(dtype=torch.bfloat16, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    qkv = (r, n_head, seq_len, scratch_head_dim(d))
    return {"x": torch.empty((r, seq_len, cs), **f32),
            "q": torch.zeros(qkv, **bf), "k": torch.zeros(qkv, **bf),
            "v": torch.zeros(qkv, **bf),
            "o": torch.zeros((r, seq_len, cs), **f32),
            "kmax": torch.zeros((r, n_head, d), **f32)}


def _alloc_slabs(scratch: dict, lib: ctypes.CDLL, hidden: int,
                 device: torch.device) -> None:
    """The kernels' per-block slabs into ``scratch``
    (``act``: a tile's activations; ``hact``: its MLP hidden units), each
    ``megakernel_slab_floats`` floats for every block the card holds at
    once; made at the first launch that needs them, kept for the next."""
    lib.megakernel_slab_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.megakernel_slab_floats.restype = ctypes.c_longlong
    blocks = max(lib.megakernel_grid_blocks(0), lib.megakernel_grid_blocks(1))
    if blocks < 1:
        raise RuntimeError(f"megakernel_step: the card holds no grid "
                           f"(cudaError {-blocks})")
    for which, name in enumerate(("act", "hact")):
        n = blocks * lib.megakernel_slab_floats(which, hidden)
        have = scratch.get(name)
        if have is None or have.numel() < n or have.device != device:
            scratch[name] = torch.empty(n, dtype=torch.float32,
                                        device=device)


def _launch(packed, tokens, adaln, kc, vc, pos, sched_row, seed, *, n_layer,
            n_head, n_embd, num_classes, guidance, use_cfg, s_valid, sample,
            cross_as_bias, pack_cfg, scratch, stamps, grid_blocks,
            defines) -> torch.Tensor:
    dev = tokens.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"megakernel_step: tokens on {dev}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    b, L = tokens.shape
    n_br = 2 if use_cfg else 1
    if pack_cfg and not use_cfg:
        raise ValueError("megakernel_step: pack_cfg is the CFG kernel")
    hidden = packed["wfc"].shape[2]        # the MLP's storage width
    if not widths_fit(n_embd, n_head, hidden):
        raise ValueError(
            f"megakernel_step: the kernels take {_KERNEL_DOMAIN}; not "
            f"n_embd {n_embd} in {n_head} heads, MLP width {hidden}")
    head_dim = n_embd // n_head
    kv = num_classes - 1
    sp = kc.shape[3]
    if tokens.dtype != torch.int64 or not tokens.is_contiguous():
        raise TypeError("megakernel_step: tokens must be contiguous int64")
    wd = packed["wqkv"].dtype
    if wd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"megakernel_step: weights of {wd}")
    cs = storage_width(n_embd)
    if tuple(packed["wlog"].shape) != (cs, kv) or \
            packed["emb"].shape[0] != num_classes or \
            tuple(pos.shape) != (L, cs) or \
            tuple(adaln.shape) != (n_layer, 2, 2 * cs) or \
            tuple(kc.shape) != (b, n_br, n_layer, sp, cs) or \
            hidden != storage_width(hidden) or \
            kc.shape != vc.shape or sched_row.numel() != 10 or \
            not 1 <= s_valid <= sp:
        raise ValueError("megakernel_step: shapes of the tables do not fit "
                         f"tokens {tuple(tokens.shape)}, K={num_classes}")
    if scratch is None:
        scratch = alloc_scratch(b, n_br, L, dev, n_embd=n_embd,
                                n_head=n_head)
    if scratch["x"].shape != (b * n_br, L, cs) or \
            "kmax" not in scratch or scratch["q"].shape != (
                b * n_br, n_head, L, scratch_head_dim(head_dim)):
        raise ValueError("megakernel_step: scratch of another shape (take "
                         "it from alloc_scratch)")
    lib = _library(tuple(defines), (n_embd, head_dim))
    max_seq = lib.megakernel_max_seq()
    if L > max_seq:
        raise ValueError(f"megakernel_step: {L} tokens, the kernels take "
                         f"at most {max_seq} at head dim {head_dim}")
    # the library says whether it runs the products on wgmma: it has the
    # slabs' entry exactly where it does (csrc: MK_WG; takes_wgmma's rule,
    # the MK_GENERAL=1 build at the serving width too), and an older build
    # of the source, which chip_smoke.py launches in turns with this one,
    # only above 512
    wgmma = wd == torch.bfloat16 and hasattr(lib, "megakernel_slab_floats")
    slabs = wgmma or n_embd > _SLAB_EMBD
    if slabs:
        _alloc_slabs(scratch, lib, hidden, dev)
    out = torch.empty_like(tokens)
    tensors = dict(packed, sched=sched_row, tokens=tokens, out=out,
                   adaln=adaln, kc=kc, vc=vc, pos=pos, **scratch)
    ptrs = []
    for name in _PTR_NAMES:
        if name in ("act", "hact") and not slabs:
            ptrs.append(None)     # (f32 weights up to 512: no slabs)
            continue
        if name == "stamps":
            if stamps is not None and (
                    stamps.dtype != torch.int64 or stamps.device != dev
                    or stamps.numel() < stamp_count(n_layer)):
                raise ValueError("megakernel_step: stamps must be int64 on "
                                 "the tokens' device, stamp_count long")
            ptrs.append(stamps.data_ptr() if stamps is not None else None)
            continue
        x = tensors[name]
        if x.device != dev:
            raise ValueError(f"megakernel_step: {name} on {x.device}, "
                             f"tokens on {dev}")
        # the schedule row is read scalar by scalar, the rest as float4
        if not x.is_contiguous() or \
                x.data_ptr() % (4 if name == "sched" else 16):
            raise TypeError(f"megakernel_step: {name} must be contiguous "
                            f"and 16-byte aligned")
        want = wd if name in _WEIGHT_NAMES else (
            torch.int64 if name in ("tokens", "out") else
            torch.bfloat16 if name in ("q", "k", "v") else torch.float32)
        if x.dtype != want:
            raise TypeError(f"megakernel_step: {name} is {x.dtype}, the "
                            f"kernel reads {want}")
        ptrs.append(x.data_ptr())
    seed = int(seed)
    ints = [b, L, n_br, n_layer, kv, sp, s_valid, hidden,
            int(wd == torch.bfloat16), int(bool(sample)),
            int(bool(cross_as_bias)), int(bool(pack_cfg)),
            seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
            max(int(grid_blocks or 0), 0)]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_uint32 * len(ints))(*ints)
    c_floats = (ctypes.c_float * 1)(float(guidance))
    err = lib.megakernel_step(
        c_ptrs, c_ints, c_floats, torch.cuda.current_stream().cuda_stream)
    if err:
        # the wgmma products' operands come by TMA: a refused tensor map
        # fails the launch (no other path)
        refused = lib.megakernel_tma_error() if wgmma else 0
        if refused:
            raise RuntimeError(
                f"megakernel_step: cuTensorMapEncodeTiled refused a tensor "
                f"map of the wgmma products (CUresult {refused})")
        raise RuntimeError(f"megakernel_step launch failed: cudaError {err}")
    if pack_cfg:
        megakernel_step.launches_k3 += 1
    else:
        megakernel_step.launches_k4 += 1
    megakernel_step.launches_by_width[
        n_embd, head_dim, "K3" if pack_cfg else "K4"] += 1
    return out


def megakernel_step(
        packed: dict, tokens: torch.Tensor, adaln: torch.Tensor,
        kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
        sched_row: torch.Tensor, seed: int, *, n_layer: int, n_head: int,
        n_embd: int, num_classes: int, guidance: float, use_cfg: bool,
        s_valid: int, sample: bool = True, cross_as_bias: bool = False,
        pack_cfg: bool = False, scratch: Optional[dict] = None,
        stamps: Optional[torch.Tensor] = None,
        grid_blocks: Optional[int] = None,
        defines: tuple[str, ...] = ()) -> torch.Tensor:
    """One whole reverse step: tokens (B, L) int64 -> tokens (B, L) int64.

    packed: :func:`pack_denoiser_params`; adaln: (n_layer, 2, 2C) for this
    timestep; kc, vc: :func:`cross_tables`; pos: :func:`positions`;
    sched_row: (10,) row of ``schedule_rows``; seed: int. CPU tensors take
    :func:`megakernel_step_reference`. CUDA tensors launch one cooperative
    kernel on the current stream: K3 (``pack_cfg``: a work item owns a tile
    of a row for both CFG branches) or K4 (a work item owns a tile of one
    (row, branch)); each launch adds one to ``megakernel_step.launches_k3``
    or ``.launches_k4``, and to ``megakernel_step.launches_by_width[(n_embd,
    head dim, "K3" or "K4")]`` (never reset). The kernels take the widths of
    :func:`widths_fit` and raise for the rest; each (n_embd, head dim) is
    built at its first launch. The hidden state the kernels leave in
    ``scratch["x"]`` is :func:`storage_width` wide, zero past n_embd.
    ``scratch`` (:func:`alloc_scratch`) is allocated per call unless given;
    ``stamps`` (int64, :func:`stamp_count` long)
    receives the device's ns clock at each phase boundary; ``grid_blocks``
    caps the persistent grid below what the card holds (the result does not
    depend on it); ``defines`` launches a variant of the source built with
    these preprocessor defines (:data:`EXACT_MAX`; the probes' timing
    variants)."""
    kw = dict(n_layer=n_layer, n_head=n_head, n_embd=n_embd,
              num_classes=num_classes, guidance=guidance, use_cfg=use_cfg,
              s_valid=s_valid, sample=sample, cross_as_bias=cross_as_bias)
    if tokens.device.type == "cpu":
        return megakernel_step_reference(packed, tokens, adaln, kc, vc, pos,
                                         sched_row, seed, **kw)
    if tokens.device.type != "cuda":
        raise ValueError(f"megakernel_step: no kernel for {tokens.device}")
    return _launch(packed, tokens, adaln, kc, vc, pos, sched_row, seed,
                   pack_cfg=pack_cfg, scratch=scratch, stamps=stamps,
                   grid_blocks=grid_blocks, defines=defines, **kw)


megakernel_step.launches_k3 = 0
megakernel_step.launches_k4 = 0
megakernel_step.launches_by_width = collections.Counter()


# ---------------------------------------------------------------------------
# the full reverse process
# ---------------------------------------------------------------------------

@torch.no_grad()
def prepare_sampling(sched: D3PMSchedule, transformer: nn.Module,
                     cond_emb: torch.Tensor,
                     cf_cond_emb: Optional[torch.Tensor], batch_size: int,
                     seq_len: int, *, guidance_scale: float = 2.0,
                     weights_dtype: torch.dtype = torch.bfloat16,
                     pack_cfg: Optional[bool] = None,
                     _force_general_cross: bool = False
                     ) -> tuple[dict, dict]:
    """Everything of a sampling call that does not depend on the step:
    ``(tables, kw)``. ``tables`` holds the packed weights (``packed``), the
    positions (``pos``), the condition's cross-attention tables (``kc``,
    ``vc``), the AdaLN tables of all T timesteps in sampling order
    (``adaln_all``: row i is timestep T - 1 - i), the schedule rows
    (``rows``) and, on a CUDA device, the kernels' ``scratch``; ``kw`` the
    keyword arguments of :func:`megakernel_step` that stay fixed."""
    if cond_emb is None:
        raise ValueError("the megakernel route needs a condition sequence "
                         "(B, S, D)")
    T = sched.num_timesteps
    device = sched.device
    n_embd = transformer.ln_out.normalized_shape[0]
    n_head = transformer.block0.attn1.n_head
    packed = pack_denoiser_params(transformer, weights_dtype)
    use_cfg = abs(guidance_scale - 1.0) >= 1e-3
    s_valid = cond_emb.shape[1]
    if pack_cfg is None:
        pack_cfg = use_cfg and seq_len <= _PACK_CFG_MAX_SEQ
    cross_as_bias = s_valid == 1 and not _force_general_cross
    kc, vc = cross_tables(packed, cond_emb, cf_cond_emb, use_cfg,
                          cross_as_bias)
    timesteps = torch.arange(T - 1, -1, -1, device=device)
    tables = dict(
        packed=packed, pos=positions(packed, seq_len), kc=kc, vc=vc,
        adaln_all=_adaln_table(packed, timesteps,
                               transformer.block0.ln1.emb.num_steps, n_embd),
        rows=schedule_rows(sched),
        scratch=(alloc_scratch(batch_size, 2 if use_cfg else 1, seq_len,
                               device, n_embd=n_embd, n_head=n_head)
                 if device.type == "cuda" else None))
    kw = dict(n_layer=transformer.n_layer, n_head=n_head, n_embd=n_embd,
              num_classes=sched.num_classes, guidance=guidance_scale,
              use_cfg=use_cfg, s_valid=s_valid, cross_as_bias=cross_as_bias,
              pack_cfg=bool(pack_cfg) and use_cfg)
    return tables, kw


@torch.no_grad()
def megakernel_sample_tokens(
        generator: torch.Generator, sched: D3PMSchedule,
        transformer: nn.Module, cond_emb: torch.Tensor,
        cf_cond_emb: Optional[torch.Tensor], batch_size: int, seq_len: int,
        *, guidance_scale: float = 2.0,
        weights_dtype: torch.dtype = torch.bfloat16, sample: bool = True,
        pack_cfg: Optional[bool] = None,
        _force_general_cross: bool = False) -> torch.Tensor:
    """Full reverse process, one :func:`megakernel_step` per timestep.

    The weights are packed, the AdaLN tables of all T timesteps and the
    condition's cross-attention tables made (:func:`prepare_sampling`), and
    the per-step seeds drawn from ``generator`` (a CPU generator), all
    before the loop: the loop itself never waits on the device.
    ``pack_cfg=None`` takes K3 when CFG is on and the grid has at most 1024
    tokens, else K4. ``_force_general_cross`` (tests) sends a one-token
    condition through the general cross-attention. Returns (B, L) int64."""
    tab, kw = prepare_sampling(
        sched, transformer, cond_emb, cf_cond_emb, batch_size, seq_len,
        guidance_scale=guidance_scale, weights_dtype=weights_dtype,
        pack_cfg=pack_cfg, _force_general_cross=_force_general_cross)
    T = sched.num_timesteps
    seeds = torch.randint(0, 2 ** 31 - 1, (T,), generator=generator).tolist()
    tokens = torch.full((batch_size, seq_len), sched.num_classes - 1,
                        dtype=torch.int64, device=sched.device)
    for i, seed in enumerate(seeds):
        tokens = megakernel_step(
            tab["packed"], tokens, tab["adaln_all"][i], tab["kc"], tab["vc"],
            tab["pos"], tab["rows"][T - 1 - i], seed, sample=sample,
            scratch=tab["scratch"], **kw)
    return tokens
