"""PyTorch port's attention (plain versions of kernels K2 and K5) vs the JAX
package's Pallas ``fused_mha`` and its custom VJP in interpret mode (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.ops.attention import (
    fused_mha as jax_fused_mha)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    attention as attn)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
    fused_mha, fused_mha_bwd, fused_mha_bwd_reference, kv_splits,
    sdpa_reference)

# the shapes and tolerance of tests/test_attention_kernel.py
SHAPES = [
    (2, 16, 16, 64, 16),   # denoiser self-attention shape (tiny heads)
    (2, 16, 1, 64, 16),    # cross-attention over a single condition token
    (1, 24, 77, 64, 8),    # CLIP-length condition (kv padding path)
    (2, 16, 16, 32, 4),
]
TOL = 2e-4


def _qkv(seed, B, Lq, Lk, C):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, n, C)).astype(np.float32)
                 for n in (Lq, Lk, Lk))


@pytest.mark.parametrize("B,Lq,Lk,C,H", SHAPES)
def test_plain_attention_matches_pallas_kernel(B, Lq, Lk, C, H):
    q, k, v = _qkv(0, B, Lq, Lk, C)
    want = jax_fused_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         n_head=H, interpret=True)
    before = fused_mha.launches
    got = fused_mha(*(torch.from_numpy(x) for x in (q, k, v)), n_head=H)
    assert fused_mha.launches == before       # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("B,Lq,Lk,C,H", SHAPES[:2])
def test_wrapper_on_cpu_is_sdpa_reference(B, Lq, Lk, C, H):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, B, Lq, Lk, C))
    torch.testing.assert_close(fused_mha(q, k, v, n_head=H),
                               sdpa_reference(q, k, v, H), rtol=0, atol=0)


# gradients: self, cross over 1 and 77 keys, an unaligned L; the rtol = atol
# of tests/test_attention_kernel.py's gradient test
GRAD_SHAPES = [
    (2, 16, 16, 64, 16),
    (2, 16, 1, 64, 16),
    (2, 16, 77, 64, 16),
    (2, 13, 13, 64, 16),
    (1, 24, 77, 64, 8),
]
GRAD_TOL = 5e-4


@pytest.mark.parametrize("B,Lq,Lk,C,H", GRAD_SHAPES)
def test_backward_matches_pallas_vjp(B, Lq, Lk, C, H):
    q, k, v = _qkv(2, B, Lq, Lk, C)
    w = np.random.default_rng(3).standard_normal((B, Lq, C)).astype(
        np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(jax_fused_mha(
        q, k, v, n_head=H, interpret=True) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tw = torch.from_numpy(w)
    plain = fused_mha_bwd_reference(tq.detach(), tk.detach(), tv.detach(),
                                    tw, H)
    before = (fused_mha.launches, fused_mha_bwd.launches)
    (fused_mha(tq, tk, tv, n_head=H) * tw).sum().backward()
    assert (fused_mha.launches, fused_mha_bwd.launches) == before  # CPU
    for name, got_plain, got_fn, wnt in zip(
            "qkv", plain, (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got_plain.numpy(), np.asarray(wnt),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name} plain")
        torch.testing.assert_close(got_fn, got_plain, rtol=0, atol=0,
                                   msg=f"d{name} through the Function")


def test_backward_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 2, 16, 77, 64))
    do = torch.ones_like(q)
    got = fused_mha_bwd(q, k, v, None, None, do, n_head=16)
    for a, b in zip(got, fused_mha_bwd_reference(q, k, v, do, 16)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_no_grad_path_keeps_the_plain_forward():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(5, 2, 16, 16, 64))
    with torch.no_grad():
        out = fused_mha(q, k, v, n_head=16)
    assert out.grad_fn is None
    torch.testing.assert_close(out, sdpa_reference(q, k, v, 16).detach(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("lq,lk,splits", [
    (1024, 1024, 1), (2304, 2304, 1), (1024, 256, 1), (1024, 1, 16),
    (1024, 77, 16), (100, 33, 2), (16, 1, 1)])
def test_kv_splits(lq, lk, splits):
    assert kv_splits(lq, lk) == splits


def _bf16_step(x) -> float:
    """One bf16 step at the largest magnitude of ``x``."""
    return attn.bf16_step(float(np.abs(np.asarray(x, np.float32)).max()))


def _bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def test_bf16_inputs_match_the_pallas_kernel_within_a_bf16_step():
    """The Pallas kernel takes bf16 inputs to f32, keeps P in f32 and rounds
    only its output (and its VJP's gradients): so does the port's plain
    version, every element within one bf16 step of the kernel's."""
    B, L, C, H = 2, 64, 64, 16
    rng = np.random.default_rng(0)
    q, k, v = (_bf16(2.0 * rng.standard_normal((B, L, C))) for _ in range(3))
    w = _bf16(np.random.default_rng(1).standard_normal((B, L, C)))
    qj, kj, vj, wj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, w))

    def loss(q, k, v):
        return jnp.sum(jax_fused_mha(q, k, v, n_head=H, interpret=True)
                       .astype(jnp.float32) * wj.astype(jnp.float32))

    want = jax_fused_mha(qj, kj, vj, n_head=H, interpret=True)
    want_grads = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in (q, k, v))
    got = fused_mha(tq, tk, tv, n_head=H)
    assert got.dtype == torch.bfloat16
    (got.float() * torch.from_numpy(w)).sum().backward()
    pairs = [("o", got, want)] + list(zip(
        ("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want_grads))
    for name, a, b in pairs:
        b = np.asarray(b, np.float32)
        err = np.abs(a.detach().float().numpy() - b).max()
        assert err <= _bf16_step(b), (name, err, _bf16_step(b))


# the kernels' arithmetic (ops/attention.py) against the plain versions:
# f32 within K2's / K5's tolerances, bf16 within BF16_EXCESS_TOL of the
# plain versions in f32 of the same inputs beyond the rounding to bf16
ARITH_SHAPES = [(2, 16, 16, 64, 16), (2, 100, 300, 64, 16),
                (2, 13, 1, 64, 16), (1, 24, 77, 64, 8)]


def _bf16_excesses(outs, q, k, v, do, H) -> list:
    """``bf16_excess`` of (o, dq, dk, dv) against the plain versions in f32
    of the same inputs, the gradients' scale floored at 1e-3 of the largest
    (dq and dk vanish over one key)."""
    x32 = [x.float() for x in (q, k, v, do)]
    want = (sdpa_reference(*x32[:3], H), *fused_mha_bwd_reference(*x32, H))
    big = max(float(w.abs().max()) for w in want[1:])
    scales = [None] + [max(float(w.abs().max()), 1e-3 * big)
                       for w in want[1:]]
    return [attn.bf16_excess(a, w, sc) for a, w, sc in zip(outs, want, scales)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Lq,Lk,C,H", ARITH_SHAPES)
def test_kernel_arithmetic_matches_the_plain_versions(B, Lq, Lk, C, H,
                                                      dtype):
    rng = np.random.default_rng(Lq + Lk)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, n, C)).astype(
        np.float32)).to(dtype) for n in (Lq, Lk, Lk, Lq))
    o, lse, o32 = attn.attention_kernel_arithmetic(q, k, v, H)
    grads = attn.attention_bwd_kernel_arithmetic(q, k, v, o32, lse, do, H)
    for a in (o, *grads):
        assert a.dtype == dtype
    if dtype == torch.bfloat16:
        excess = _bf16_excesses((o, *grads), q, k, v, do, H)
        assert max(excess) <= attn.BF16_EXCESS_TOL, excess
        return
    want = (sdpa_reference(q, k, v, H),
            *fused_mha_bwd_reference(q, k, v, do, H))
    for name, a, w, tol in zip(("o", "dq", "dk", "dv"), (o, *grads), want,
                               (TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        torch.testing.assert_close(a, w, rtol=tol, atol=tol, msg=name)


@pytest.mark.parametrize("B,Lq,Lk,C,H",
                         [s for s in ARITH_SHAPES if s[2] > 1])
def test_bf16_bound_catches_p_rounded_to_bf16(B, Lq, Lk, C, H):
    """The bf16 bound has teeth: the plain versions with P and dS rounded to
    bf16 before their products miss it in every output."""
    rng = np.random.default_rng(Lq + Lk)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, n, C)).astype(
        np.float32)).to(torch.bfloat16) for n in (Lq, Lk, Lk, Lq))
    control = [x.to(torch.bfloat16) for x in
               attn.bf16_rounded_p_reference(q, k, v, do, H)]
    excess = _bf16_excesses(control, q, k, v, do, H)
    assert min(excess) > attn.BF16_EXCESS_TOL, excess


def test_pair_slots_permuted_sum_equals_the_ordered_sum():
    """P V over an 8-key block with the keys in the pair product's slot
    order (the accumulator's columns, V staged to match) is the ordered
    sum: the same products, added in another order."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.standard_normal((16, 8)))
    v = torch.from_numpy(rng.standard_normal((8, 4)))
    slots = list(attn.PAIR_SLOTS)
    assert sorted(slots) == list(range(8))
    torch.testing.assert_close(p[:, slots] @ v[slots], p @ v, rtol=1e-15,
                               atol=1e-15)


def test_split_products_hold_f32_to_the_error_they_claim():
    """The f32 kernels' products (operands split into TF32 hi + lo, all
    four partial products; the fed-back P split with its lo cut to TF32)
    against f64: within 2^-20 of the sum of |terms| (f32 sums of 8 terms
    add a few 2^-24)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    got = attn._mm("qd,dk->qk", attn._operands(a), attn._operands(b))
    want = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    assert float(((got.double() - want).abs() / scale).max()) < 2.0 ** -20
    p = torch.from_numpy(rng.random((64, 8)).astype(np.float32))
    hi, lo = attn.split_fed_back(p)
    assert float(((hi.double() + lo.double() - p.double()).abs()
                  / p.double()).max()) <= 2.0 ** -20


def test_bf16_hi_lo_holds_p_to_two_to_minus_16():
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.random(4096).astype(np.float32) ** 8)
    hi, lo = attn.bf16_hi_lo(p)
    for x in (hi, lo):   # bf16 values, exactly
        assert torch.equal(x.to(torch.bfloat16).float(), x)
    rel = (hi.double() + lo.double() - p.double()).abs() / p.double()
    assert float(rel.max()) <= 2.0 ** -16
