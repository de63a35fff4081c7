"""PyTorch port's D3PM math vs the JAX package (CPU).

The same numpy-seeded inputs go through the JAX functions and their
counterparts in ``gif_synthesis_with_discrete_diffusion_tpu_torch``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu.ops import (
    sampler_kernel as jsampler)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
    d3pm as td3pm)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    sampler_kernel as tsampler)

T, K, L, B = 8, 10, 12, 2
# f32 log-space math in two frameworks: the ops match one to one but XLA
# and ATen reduce in different orders
TOL = 1e-5

_FIELDS = ["log_at", "log_bt", "log_ct", "log_cumprod_at", "log_cumprod_bt",
           "log_cumprod_ct", "log_1_min_ct", "log_1_min_cumprod_ct"]


@pytest.mark.parametrize("steps,classes", [(T, K), (100, 4097)])
def test_schedule_tensors_equal_make_schedule(steps, classes):
    want = jd3pm.make_schedule(steps, classes)
    got = td3pm.make_schedule(steps, classes)
    assert (got.num_timesteps, got.num_classes) == (steps, classes)
    for name in _FIELDS:
        g = getattr(got, name)
        assert g.dtype == torch.float32, name
        # both are the same f64 numpy rounded to f32: exact, -inf included
        np.testing.assert_array_equal(g.numpy(), np.asarray(
            getattr(want, name)), err_msg=name)


def test_schedule_field_names_match():
    port = {f.name for f in dataclasses.fields(td3pm.D3PMSchedule)}
    assert port == {f.name for f in dataclasses.fields(jd3pm.D3PMSchedule)}


def test_schedule_rows_match():
    got = tsampler.schedule_rows(td3pm.make_schedule(T, K))
    want = jsampler.schedule_rows(jd3pm.make_schedule(T, K))
    assert tuple(got.shape) == (T, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _inputs(seed, guidance):
    rng = np.random.default_rng(seed)
    nb = 2 * B if abs(guidance - 1.0) >= 1e-3 else B
    logits2 = (2.0 * rng.standard_normal((nb, K - 1, L))).astype(np.float32)
    tokens = rng.integers(0, K, (B, L)).astype(np.int64)
    tokens[:, ::3] = K - 1                       # plenty of MASK positions
    return logits2, tokens


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_guided_log_x_recon_matches(guidance):
    logits2, _ = _inputs(0, guidance)
    got = td3pm._guided_log_x_recon(torch.from_numpy(logits2), guidance, B)
    want = jd3pm._guided_log_x_recon(jnp.asarray(logits2), guidance, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("t", [0, 3, T - 1])
@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_analytic_posterior_matches(t, guidance):
    logits2, tokens = _inputs(1 + t, guidance)
    js, ts = jd3pm.make_schedule(T, K), td3pm.make_schedule(T, K)
    want = jd3pm._analytic_posterior(
        js, jd3pm._guided_log_x_recon(jnp.asarray(logits2), guidance, B),
        jnp.asarray(tokens, jnp.int32), jnp.asarray(t))
    got = td3pm._analytic_posterior(
        ts, td3pm._guided_log_x_recon(torch.from_numpy(logits2), guidance,
                                      B),
        torch.from_numpy(tokens), t)
    assert tuple(got.shape) == (B, K, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
