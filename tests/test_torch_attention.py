"""PyTorch port's attention (plain version of kernel K2) vs the JAX
package's Pallas ``fused_mha`` in interpret mode (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.ops.attention import (
    fused_mha as jax_fused_mha)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
    fused_mha, sdpa_reference)

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
