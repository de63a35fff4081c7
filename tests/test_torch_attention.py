"""PyTorch port's attention (plain versions of kernels K2 and K5) vs the JAX
package's Pallas ``fused_mha`` and its custom VJP in interpret mode (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.ops.attention import (
    fused_mha as jax_fused_mha)
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
