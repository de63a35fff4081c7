"""The wg design of K2 / K5 (``csrc/mha_wg.cuh``: wgmma fed by TMA, every
head dim up to 128 other than 4 and 8) against the JAX package (CPU).

The kernels run on the card only (``tests/test_torch_gpu_kernels.py``,
``chip_smoke.py`` phase 20). Here their arithmetic, as plain functions in
``ops/attention.py``, is held to the Pallas kernel and its VJP in interpret
mode: ``attention_kernel_arithmetic`` / ``attention_bwd_kernel_arithmetic``
at the design's tiles of keys (:func:`wg_tiles`: the online softmax over
K2's tile, the dq kernel's one-tile Dr), f32 operands split into TF32 hi +
lo with q scaled first, P and dS fed back split. And the operands as the
kernels hold them in shared memory: :func:`wg_operand` (an f32 tile split,
laid out by 16-byte chunks, or transposed with its rows in PAIR_SLOTS
order) and :func:`wg_fed_back` (the scores as the A operand of a
contraction step) against the split and the transpose they stand for.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.ops.attention import (
    fused_mha as jax_fused_mha)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    attention as attn)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.megakernel import (
    split_tf32)

H = 2
LQ = 40
# the rtol = atol of tests/test_attention_kernel.py
TOL = 2e-4
# head dims of every instantiation (6 and 20 off it; f32 heads of 6 and bf16
# heads of 12 and 20 copied by cp.async, the rest by TMA) and keys: one (the
# label), 77 (the text condition) and 200 (several tiles of every design)
WG_DIMS = (6, 12, 16, 20, 64, 128)
WG_KEYS = (1, 77, 200)


def _inputs(seed, Lk, C):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, n, C)).astype(np.float32)
                 for n in (LQ, Lk, Lk, LQ))


def _pallas(q, k, v, w, dtype):
    jq, jk, jv, jw = (jnp.asarray(x, dtype) for x in (q, k, v, w))

    def loss(q, k, v):
        o = jax_fused_mha(q, k, v, n_head=H, interpret=True)
        return jnp.sum((o * jw).astype(jnp.float32)), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(jq, jk, jv)
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lk", WG_KEYS)
@pytest.mark.parametrize("d", WG_DIMS)
def test_wg_arithmetic_matches_pallas(d, lk, dtype):
    """The wg design's arithmetic against the Pallas kernel and its VJP in
    interpret mode on the same inputs: f32 within TOL (rtol = atol); bf16
    (both f32 inside, every output rounded once) within one bf16 step at
    each output's largest magnitude, and over one key dq and dk exactly 0,
    as the JAX kernel's."""
    assert attn.design(d) == "wg"
    q, k, v, w = _inputs(d + 3 * lk, lk, H * d)
    want = _pallas(q, k, v, w, jnp.dtype(dtype))
    dt = getattr(torch, dtype)
    tq, tk, tv, tw = (torch.from_numpy(x).to(dt) for x in (q, k, v, w))
    o, lse, o32 = attn.attention_kernel_arithmetic(tq, tk, tv, H)
    grads = attn.attention_bwd_kernel_arithmetic(tq, tk, tv, o32, lse, tw, H)
    for name, x, y in zip(("o", "dq", "dk", "dv"), (o, *grads), want):
        assert x.dtype == dt, name
        x = x.float().numpy()
        if dt == torch.float32:
            np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL, err_msg=name)
            continue
        big = float(np.abs(y).max())
        if big == 0.0:              # dq, dk over one key
            assert not x.any(), name
            continue
        err = float(np.abs(x - y).max())
        assert err <= attn.bf16_step(big), (name, err, big)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WG_DIMS)
def test_wg_softmax_tile_is_the_designs(d, dtype):
    """The arithmetic's online softmax runs over K2's tile of the wg design
    at the head dim's instantiation, and the dq kernel's one-tile Dr over
    its own tile (csrc/mha_wg.cuh: Cfg, which the card's
    fused_mha_wg_tiles reports)."""
    width = attn.kernel_head_dim(d)
    tiles = attn.wg_tiles(width, dtype)
    dz = attn._Design(d, dtype)
    assert (dz.width, dz.tile, dz.one_group_keys) == (
        width, tiles["fwd"][1], tiles["dq"][1])
    for warpgroups, rows in tiles.values():
        assert warpgroups in (1, 2) and rows in (16, 32, 64)


@pytest.mark.parametrize("d,want", [(1, "wg"), (3, "wg"), (4, "tiles"),
                                    (8, "tiles"), (12, "wg"), (128, "wg"),
                                    (129, "stream"), (256, "stream")])
def test_design_by_head_dim(d, want):
    """Heads of 4 and 8 keep their own design, every other head dim up to
    128 takes the wg design, wider heads the stream design."""
    assert attn.design(d) == want


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("D", attn.WIDE_HEAD_DIMS)
def test_wg_operand_is_the_split_laid_out(D, transposed):
    """An f32 tile as the kernels write it after it lands: hi and lo are
    the TF32 split of x times f (hi rounded, lo the rest cut; hi + lo
    within 2^-21 of it), laid out by 16-byte chunks ([chunk][row][4]), or
    transposed ([4-row chunk][column][4 rows]) with each 8 rows in
    PAIR_SLOTS order and WG_TPAD floats after each chunk."""
    R, f = 32, 0.125
    x = torch.from_numpy(np.random.default_rng(D).standard_normal(
        (R, D)).astype(np.float32))
    hi, lo = attn.wg_operand(x, transposed, f)
    want_hi, want_lo = split_tf32(x * f)
    assert ((want_hi + want_lo - x * f).abs()
            <= 2.0 ** -21 * (x * f).abs()).all()
    for got, want in ((hi, want_hi), (lo, want_lo)):
        flat = got.reshape(-1)
        for r in range(R):
            for c in range(D):
                if transposed:
                    k = next(s for s in range(R) if
                             8 * (s // 8) + attn.PAIR_SLOTS[s % 8] == r)
                    at = (k // 4) * (D * 4 + attn.WG_TPAD) + c * 4 + k % 4
                else:
                    at = (c // 4) * R * 4 + r * 4 + c % 4
                assert flat[at] == want[r, c], (r, c)


@pytest.mark.parametrize("n", [8, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wg_fed_back_is_split_fed_back_in_slot_order(dtype, n):
    """The scores fed back as a contraction's A operand: in f32
    split_fed_back (hi cut to TF32, lo the rest as TF32 reads it) with step
    j's slot t holding column 8 j + PAIR_SLOTS[t], the accumulator's
    columns 2 t and 2 t + 1 at slots t and t + 4; in bf16 the bf16 hi + lo
    pair in the columns' own order."""
    p = torch.from_numpy(np.random.default_rng(n).random(
        (64, n)).astype(np.float32))
    hi, lo = attn.wg_fed_back(p, dtype)
    want = (attn.split_fed_back(p) if dtype == torch.float32
            else attn.bf16_hi_lo(p))
    for got, full in zip((hi, lo), want):
        for col in range(n):
            slot = col if dtype == torch.bfloat16 else \
                8 * (col // 8) + attn.PAIR_SLOTS.index(col % 8)
            assert torch.equal(got[:, slot], full[:, col])
    perm = (list(range(n)) if dtype == torch.bfloat16 else
            [8 * (k // 8) + attn.PAIR_SLOTS[k % 8] for k in range(n)])
    bound = 2.0 ** (-20 if dtype == torch.float32 else -16)
    assert ((hi + lo - p[:, perm]).abs() <= bound * p[:, perm].abs()).all()
    if dtype == torch.float32:
        # slots t and t + 4 of each step hold the accumulator's columns 2 t
        # and 2 t + 1, the pair a lane holds
        assert all(perm[8 * j + t] == 8 * j + 2 * t and
                   perm[8 * j + t + 4] == 8 * j + 2 * t + 1
                   for j in range(n // 8) for t in range(4))


def test_kernels_line_counts_the_launches_by_design():
    """``chip_smoke.py``'s kernels line counts each K2 / K5 launch under the
    design its head dim takes: 4 and 8 the first design, every other head
    dim up to 128 the wg design, wider heads the stream design."""
    import chip_smoke
    by_d = {"4": 3, "8": 5, "12": 7, "64": 11, "128": 13, "256": 17}
    assert chip_smoke._design_launches(by_d) == {"stream": 17, "tiles": 8,
                                                 "wg": 31}


@pytest.mark.parametrize("lq,lk,d,splits", [
    (1024, 1, 64, 1), (1024, 77, 12, 1), (2304, 77, 64, 3),
    (1024, 256, 64, 1), (1024, 1, 4, 16), (1024, 77, 256, 4)])
def test_kv_splits_by_design(lq, lk, d, splits):
    """The dK/dV kernel's query chunks over a few keys: one per 1024
    queries in the wg design, per 256 in the stream design, per 64 in the
    first (its code as it was); none with 256 keys or more."""
    assert attn.kv_splits(lq, lk, d) == splits
