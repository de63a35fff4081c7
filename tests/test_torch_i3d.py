"""The PyTorch port's Inception-I3D vs the JAX package (CPU):
``InceptionI3d(num_classes=10)`` at (1, 8, 32, 32, 3) on random flax
weights carried over by ``convert/from_flax.py``, the logits and the pooled
features within 1e-4 of their max-abs (f32 3-D convolutions summed in other
orders), and the TF-SAME padding table."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models import i3d as ji3d
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import i3d
from tests.test_torch_resnet import redraw_batchnorms

TOL = 1e-4


@pytest.mark.parametrize("size,k,s", [
    (224, 7, 2), (16, 1, 1), (56, 3, 1), (15, 3, 2), (8, 7, 2), (4, 3, 2),
    (3, 2, 2), (1, 3, 1), (7, 1, 2), (2, 3, 2)])
def test_tf_same_pad_table(size, k, s):
    assert i3d.tf_same_pad(size, k, s) == ji3d.tf_same_pad(size, k, s)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    model = ji3d.InceptionI3d(num_classes=10)
    x = rng.standard_normal((1, 8, 32, 32, 3)).astype(np.float32)
    variables = redraw_batchnorms(rng, model.init(jax.random.key(0),
                                                  jnp.asarray(x)))
    port = i3d.InceptionI3d(num_classes=10).eval()
    port.load_state_dict(flax_to_state_dict(variables["params"],
                                            variables["batch_stats"]),
                         strict=True)
    return model, variables, port, x


@pytest.mark.parametrize("features_only", [False, True],
                         ids=["logits", "features"])
def test_inception_i3d_matches_flax(pair, features_only):
    model, variables, port, x = pair
    want = np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, features_only=features_only))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), features_only=features_only)
    assert tuple(got.shape) == want.shape
    assert want.shape == ((1, 1, 1, 1, 1024) if features_only else (1, 10))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
