"""The PyTorch port's ResNet-50 and its IMAGENET1K_V2 preprocessing vs the
JAX package (CPU): full widths, one 64 x 64 image, random flax weights
carried over by ``convert/from_flax.py``; the logits and the 2048-d
features within 1e-4 of their max-abs (f32 convolutions summed in other
orders through 53 layers), the preprocessing within 1e-5 (f32 resize
weights computed in two frameworks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models import resnet as jres
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import resnet

TOL = 1e-4
PRE_TOL = 1e-5


def redraw_batchnorms(rng, variables):
    """Kernels as flax drew them; every BatchNorm's scale, bias and running
    statistics redrawn (a positive variance), every bias redrawn."""
    variables = jax.device_get(variables)

    def draw(path, a):
        name = path[-1].key
        v = rng.standard_normal(a.shape)
        if name == "kernel":
            return np.asarray(a)
        if name == "scale":
            return (1.0 + 0.1 * v).astype(np.float32)
        if name == "var":
            return (0.5 + 0.5 * np.abs(v)).astype(np.float32)
        return (0.1 * v).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    model = jres.ResNet50(num_classes=1000)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    variables = redraw_batchnorms(rng, model.init(jax.random.key(0),
                                                  jnp.asarray(x)))
    port = resnet.ResNet50(num_classes=1000).eval()
    port.load_state_dict(flax_to_state_dict(variables["params"],
                                            variables["batch_stats"]),
                         strict=True)
    return model, variables, port, x


@pytest.mark.parametrize("features_only", [False, True],
                         ids=["logits", "features"])
def test_resnet50_matches_flax(pair, features_only):
    model, variables, port, x = pair
    want = np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, features_only=features_only))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), features_only=features_only)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == ((1, 2048) if features_only
                                              else (1, 1000))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_preprocess_imagenet_v2_matches_flax():
    frame = np.random.default_rng(1).integers(
        0, 256, (2, 240, 320, 3)).astype(np.uint8)
    want = np.asarray(jres.preprocess_imagenet_v2(jnp.asarray(frame)))
    got = resnet.preprocess_imagenet_v2(torch.from_numpy(frame))
    assert tuple(got.shape) == want.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=PRE_TOL,
                               atol=PRE_TOL)
