"""PyTorch port's on-device video preprocessing vs the JAX package (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.data import (
    preprocess as jpre)
from gif_synthesis_with_discrete_diffusion_tpu_torch.data import (
    preprocess as tpre)

# f32 resize weights computed in two frameworks
TOL = 1e-5


@pytest.mark.parametrize("shape,resolution", [
    ((2, 3, 16, 16, 3), 16),       # the bench's case: already at size
    ((2, 3, 20, 30, 3), 8),        # antialiased downscale, then a crop
    ((1, 2, 30, 22, 3), 13),       # portrait, odd target
    ((1, 2, 16, 16, 3), 56),       # upscale (x3.5: FVD's 64 px -> 224)
])
def test_preprocess_clip_matches(shape, resolution):
    video = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    want = jpre.preprocess_clip(jnp.asarray(video), resolution)
    got = tpre.preprocess_clip(torch.from_numpy(video), resolution)
    assert tuple(got.shape) == want.shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_unnormalize_matches():
    x = np.random.default_rng(1).standard_normal((2, 4, 4, 3)).astype(
        np.float32) * 3
    np.testing.assert_allclose(
        tpre.unnormalize(torch.from_numpy(x)).numpy(),
        np.asarray(jpre.unnormalize(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
