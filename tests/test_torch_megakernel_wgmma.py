"""The whole-step kernels' products with bf16 weights (CPU).

With bf16 weights K3 / K4 take every product of phases A and B on
``wgmma`` at every width but the serving one (n_embd 64 in heads of 4): the f32 activations are written once as three bf16
planes (``csrc/megakernel_step.cu: split3``, ``store_planes``), which TMA
copies land as wgmma's K-major core matrices. Here the plain statements of
that arithmetic and layout in ``ops/megakernel.py``: the split holds every
f32 value it is given (near 0, subnormal, large), the slab's index map is
a bijection whose 64-deep chunks are the TMA boxes the kernels copy, laid
out as the core matrices their descriptors read, and the product is the
f32 product up to its sums' rounding. The step with this arithmetic is
held to JAX's interpret-mode kernels token for token in
``tests/test_torch_megakernel_wide.py`` (its bf16 cases at 640 to 2048)
and ``tests/test_torch_megakernel.py`` (at 24 to 512), both on
:func:`kernel_matmul`'s planes.
"""
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    megakernel as mk)

# the smallest bf16 spacing (bf16's subnormals: 7 bits below 2^-126), and
# the largest finite bf16 value: past it hi rounds to infinity
BF16_TINY = 2.0 ** -133
BF16_MAX = float(torch.finfo(torch.bfloat16).max)


def _values() -> torch.Tensor:
    """f32 values over the whole range the split takes: random significands
    at every binade from 2^-149 to 2^127, each sign, values a rounding tie
    away from a bf16 value, near 0 and at the largest finite bf16."""
    rng = np.random.default_rng(22)
    sig = rng.uniform(1.0, 2.0, 4000)
    exps = rng.integers(-149, 128, 4000)
    v = np.ldexp(sig, exps) * rng.choice([-1.0, 1.0], 4000)
    ties = np.ldexp(1.0 + (2 * rng.integers(0, 128, 200) + 1) / 256.0,
                    rng.integers(-60, 60, 200))
    special = [0.0, -0.0, 1e-45, -1e-45, 1e-44, 1e-40, -1e-39, 1.1754942e-38,
               1.1754944e-38, 3e-38, 1e-30, 1.0, -1.0, 1e30, 1e38, -1e38,
               3.38e38, -3.38e38, BF16_MAX, -BF16_MAX]
    return torch.tensor(np.concatenate([v, ties, special]),
                        dtype=torch.float32)


def test_three_planes_recompose_every_f32_value():
    """hi + mid + lo is the f32 value exactly wherever |a| >= 2^-109 (to
    the largest finite bf16), and within 2^-134 (half bf16's smallest
    spacing) below; each part a bf16 value, each below the one before by
    2^-8 of it or more."""
    a = _values()
    hi, mid, lo = mk.split3_bf16(a)
    for part in (hi, mid, lo):
        assert torch.equal(part, part.to(torch.bfloat16).to(torch.float32))
    back = hi.double() + mid.double() + lo.double()
    err = (back - a.double()).abs()
    normal = a.double().abs() >= 2.0 ** -109
    assert torch.all(err[normal] == 0), a[normal][err[normal] != 0]
    assert torch.all(err <= 2.0 ** -134), a[err > 2.0 ** -134]
    assert torch.all(mid.abs() <= hi.abs() * 2.0 ** -8)
    assert torch.all(lo.abs() <= mid.abs() * 2.0 ** -8)
    assert torch.isfinite(back).all()


def test_three_planes_of_the_same_value_on_both_sides_of_zero():
    """The split is odd: -a splits into -hi, -mid, -lo (round to nearest
    even is symmetric), so the products of x and -x cancel exactly."""
    a = _values()
    for p, q in zip(mk.split3_bf16(a), mk.split3_bf16(-a)):
        assert torch.equal(p, -q)


@pytest.mark.parametrize("cols", [24, 104, 256, 400, 512, 1000, 1024, 1536,
                                  4096, 8192])
def test_slab_planes_are_tma_boxes_of_core_matrices(cols):
    """The three planes of a slab of ``cols`` columns (n_embd 24, 100 (104
    wide), 256, 512, 1000, 1024, 1536, an MLP of 4 x 100 and of 4096 and
    8192; the narrow slabs' only chunk, or their last, part zero fill):
    every (plane, row, column) of the
    64-row tile has its own element, all 3 x 64 ``cols`` of them used; the
    slab as the kernels' tensor map reads it (128-byte lines: 64
    elements, line, plane; a line 8 rows of 8 columns) addresses each
    element where the index map puts it; and a 64-deep chunk of a plane,
    64 lines of one TMA box, lands its elements as wgmma's K-major core
    matrices: 8 rows x 16 bytes, 128 bytes apart along the rows, 1024
    along the columns (the descriptor's strides)."""
    r = torch.arange(64)[:, None].expand(64, cols)
    c = torch.arange(cols)[None, :].expand(64, cols)
    offs = [mk.slab_plane_offset(r, c, cols, pl) for pl in range(3)]
    assert torch.equal(torch.cat([o.flatten() for o in offs]).sort().values,
                       torch.arange(3 * 64 * cols))
    off = offs[0]
    # the tensor map: element e of line (8 (column / 8) + row / 8) of plane
    # p at 2 e + 128 line + 128 cols p bytes
    line = 8 * (c // 8) + r // 8
    elem = 8 * (r % 8) + c % 8
    for pl in range(3):
        assert torch.equal(2 * offs[pl], 2 * elem + 128 * line
                           + 128 * cols * pl)
    for i in range(-(-cols // 64)):
        cc, rr = c[:, 64 * i:64 * i + 64], r[:, 64 * i:64 * i + 64]
        box = 2 * (mk.slab_plane_offset(rr, cc, cols)
                   - mk.slab_plane_offset(0, 64 * i, cols))
        k = cc % 64
        core = 128 * (rr // 8) + 1024 * (k // 8)
        assert torch.equal(box, core + 16 * (rr % 8) + 2 * (k % 8))
        assert int(box.max()) < 64 * 64 * 2       # inside the 8 KB box


@pytest.mark.parametrize("k", [64, 1000, 1024, 4096])
def test_planes_product_is_the_f32_product(k):
    """:func:`planes_matmul` against the f64 product of the same f32
    activations and bf16 weights: within the f32 sums' own rounding bound
    (k 2^-23 of sum |a| |w|; the planes lose nothing of a), where the TF32
    split (:func:`split_matmul`) and the control with one TF32 half miss
    by more at the largest element."""
    g = torch.Generator().manual_seed(k)
    a = torch.randn(64, k, generator=g) * torch.exp(
        torch.randn(64, k, generator=g))
    w = (torch.randn(k, 96, generator=g) / k ** 0.5).to(torch.bfloat16)
    exact = a.double() @ w.double()
    scale = a.double().abs() @ w.double().abs()
    err = (mk.planes_matmul(a, w).double() - exact).abs()
    assert torch.all(err <= k * 2.0 ** -23 * scale)
    one_tf32 = (mk.split_tf32(a)[0].double() @ w.double() - exact).abs()
    assert float(err.max()) < float(one_tf32.max())


# (n_embd, head dim, weights, defines, whether the kernels take the planes):
# bf16 weights at every width but the serving one (n_embd 64 in heads of
# 4, unless built from the general code), f32 weights nowhere
KERNEL_MATMUL_CASES = [
    (1024, 64, "bfloat16", (), True), (513, 27, "bfloat16", (), True),
    (512, 256, "bfloat16", (), True), (256, 16, "bfloat16", (), True),
    (64, 8, "bfloat16", (), True), (24, 3, "bfloat16", (), True),
    (64, 4, "bfloat16", (), False),
    (64, 4, "bfloat16", ("MK_GENERAL=1",), True),
    (1024, 64, "float32", (), False), (512, 256, "float32", (), False),
    (64, 4, "float32", (), False)]


@pytest.mark.parametrize("n_embd,head_dim,wdtype,defines,planes",
                         KERNEL_MATMUL_CASES,
                         ids=[f"{c}x{d}-{w}{'-general' if f else ''}"
                              for c, d, w, f, _ in KERNEL_MATMUL_CASES])
def test_kernel_matmul_takes_the_planes_above_512_with_bf16_weights(
        n_embd, head_dim, wdtype, defines, planes):
    """What the kernels' arithmetic multiplies by: the three planes with
    bf16 weights at every width (above n_embd 512 and below), but the
    serving width's own code, which keeps the TF32 split, as f32 weights do
    at every width; :func:`takes_wgmma` says the same."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(8, 640, generator=g)
    w = torch.randn(640, 24, generator=g).to(getattr(torch, wdtype))
    want = (mk.planes_matmul if planes else mk.split_matmul)(a, w)
    assert torch.equal(mk.kernel_matmul(n_embd, head_dim, defines)(a, w),
                       want)
    assert mk.takes_wgmma(n_embd, head_dim, w.dtype, defines) == planes
    if wdtype == "bfloat16":
        assert not torch.equal(mk.planes_matmul(a, w), mk.split_matmul(a, w))
