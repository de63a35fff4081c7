"""PyTorch port's codebook lookup (plain version of kernel K6) vs the JAX
package's Pallas ``nearest_code_stats`` in interpret mode (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.ops.codebook_kernel import (
    nearest_code_stats as jax_nearest_code_stats)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
    import (code_stats_reference, kernel_distances, nearest_code_stats,
            nearest_code_stats_kernel_arithmetic,
            nearest_code_stats_reference)

# the shapes of tests/test_codebook_kernel.py's kernel test; indices and
# counts exact, encode_sum to 1e-4 (f32 sums in two orders)
SHAPES = [(512, 128, 128), (1000, 100, 64), (64, 257, 130)]
TOL = 1e-4
# chip_smoke.py's K6_MARGIN: the card's kernel must give the plain index
# wherever the top-two distance margin exceeds it
K6_MARGIN = 1e-3


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


def _decided(x, emb):
    """Rows whose top-two distance margin (in f64) exceeds K6_MARGIN."""
    xd, ed = x.double(), emb.double()
    dist = -2.0 * (xd @ ed.t()) + (ed * ed).sum(dim=-1)[None, :]
    top2 = (-dist).topk(2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) > K6_MARGIN


@pytest.mark.parametrize("n,k,d", SHAPES)
def test_kernel_arithmetic_matches_pallas_kernel(n, k, d):
    """The CUDA kernel's split-TF32 distances against the Pallas kernel:
    indices equal at decided rows, the statistics of its own indices."""
    x, emb = _inputs(7, n, k, d)
    want = jax_nearest_code_stats(jnp.asarray(x), jnp.asarray(emb),
                                  interpret=True)
    xt, et = torch.from_numpy(x), torch.from_numpy(emb)
    idx, n_total, encode_sum = nearest_code_stats_kernel_arithmetic(xt, et)
    decided = _decided(xt, et)
    assert int(decided.sum()) > 0.9 * n
    np.testing.assert_array_equal(idx.numpy()[decided.numpy()],
                                  np.asarray(want[0])[decided.numpy()])
    want_n, want_sum = code_stats_reference(xt, idx, k)
    np.testing.assert_array_equal(n_total.numpy(), want_n.numpy())
    np.testing.assert_allclose(encode_sum.numpy(), want_sum.numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [128, 130])
def test_kernel_arithmetic_ties_keep_the_first_code(d):
    """Codes repeated 131 and 300 codes on (in another E tile of either of
    the kernel's block shapes): rows near a repeated code take its first
    copy, as the Pallas kernel does."""
    rng = np.random.default_rng(d)
    emb = rng.standard_normal((1000, d)).astype(np.float32)
    emb[131:231] = emb[0:100]
    emb[700:750] = emb[400:450]
    near = np.concatenate([np.arange(100), np.arange(400, 450)])
    x = (emb[rng.choice(near, 400)]
         + 0.01 * rng.standard_normal((400, d))).astype(np.float32)
    want = np.asarray(jax_nearest_code_stats(jnp.asarray(x), jnp.asarray(emb),
                                             interpret=True)[0])
    idx = nearest_code_stats_kernel_arithmetic(torch.from_numpy(x),
                                               torch.from_numpy(emb))[0]
    assert set(idx.tolist()) <= set(near.tolist())
    np.testing.assert_array_equal(idx.numpy(), want)


def test_split_tf32_distances_err_under_a_quarter_of_the_margin():
    """The kernel's distances (split TF32, lo.lo dropped) against f64 at
    the path's D = 128 and K = 4096 over 3000 rows: the worst error is under
    K6_MARGIN / 4, so a margin of K6_MARGIN decides the kernel's argmin."""
    x, emb = (torch.from_numpy(a) for a in _inputs(11, 3000, 4096, 128))
    got = kernel_distances(x, emb).double()
    xd, ed = x.double(), emb.double()
    want = -2.0 * (xd @ ed.t()) + (ed * ed).sum(dim=-1)[None, :]
    assert float((got - want).abs().max()) < K6_MARGIN / 4
