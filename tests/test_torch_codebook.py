"""PyTorch port's codebook lookup (plain version of kernel K6) vs the JAX
package's Pallas ``nearest_code_stats`` in interpret mode (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.ops.codebook_kernel import (
    nearest_code_stats as jax_nearest_code_stats)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
    import (code_stats_reference, nearest_code_stats,
            nearest_code_stats_reference)

# the shapes of tests/test_codebook_kernel.py's kernel test; indices and
# counts exact, encode_sum to 1e-4 (f32 sums in two orders)
SHAPES = [(512, 128, 128), (1000, 100, 64), (64, 257, 130)]
TOL = 1e-4


def _inputs(seed, n, k, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((k, d)).astype(np.float32))


@pytest.mark.parametrize("n,k,d", SHAPES)
def test_plain_lookup_matches_pallas_kernel(n, k, d):
    x, emb = _inputs(3, n, k, d)
    want = jax_nearest_code_stats(jnp.asarray(x), jnp.asarray(emb),
                                  interpret=True)
    before = nearest_code_stats.launches
    idx, n_total, encode_sum = nearest_code_stats(torch.from_numpy(x),
                                                  torch.from_numpy(emb))
    assert nearest_code_stats.launches == before     # CPU: the plain version
    assert idx.dtype == torch.int32 and tuple(encode_sum.shape) == (k, d)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(n_total.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(encode_sum.numpy(), np.asarray(want[2]),
                               rtol=TOL, atol=TOL)


def test_wrapper_detaches_and_on_cpu_is_the_reference():
    x, emb = (torch.from_numpy(a) for a in _inputs(4, 96, 16, 16))
    x.requires_grad_()
    got = nearest_code_stats(x, emb)
    assert not any(t.requires_grad for t in got)
    for a, b in zip(got, nearest_code_stats_reference(x, emb)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_code_stats_reference_counts_and_sums():
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    n_total, encode_sum = code_stats_reference(
        x, torch.tensor([2, 0, 2], dtype=torch.int32), 3)
    torch.testing.assert_close(n_total, torch.tensor([1.0, 0.0, 2.0]))
    torch.testing.assert_close(encode_sum, torch.tensor(
        [[3.0, 4.0], [0.0, 0.0], [6.0, 8.0]]))


def test_ties_keep_the_first_code():
    emb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    x = torch.tensor([[2.0, 0.0], [0.5, 0.5]])
    idx = nearest_code_stats(x, emb)[0]
    assert idx.tolist() == [0, 0]
