"""The PyTorch port's FVD evaluator vs the JAX package (CPU): the Fréchet
distance in float64 on the host (rtol 1e-9: the same numpy operations), the
I3D input preparation for 4, 8 and 16 frames (the ImageNet round trip to
uint8, the upscale, the x2 quirk, the temporal repeats) and the evaluator
end to end on the same I3D weights, with ``FVD_RESOLUTION`` set to 32 on
both sides (the JAX module reads it at call time, the port's too)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.eval import evaluator as jev
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.eval import evaluator

RES = 32
# the preparation: f32 resize weights in two frameworks, after a uint8
# round trip that both sides round the same way
PREP_TOL = 1e-5
# the I3D logits: f32 convolutions summed in other orders
EMBED_TOL = 1e-4


@pytest.fixture
def small_fvd(monkeypatch):
    monkeypatch.setattr(jev, "FVD_RESOLUTION", RES)
    monkeypatch.setattr(evaluator, "FVD_RESOLUTION", RES)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((64, 16))
    x2 = rng.standard_normal((64, 16)) * 1.5 + 0.3
    got = evaluator.frechet_distance(x1, x2)
    np.testing.assert_allclose(got, jev.frechet_distance(x1, x2), rtol=1e-9)
    assert abs(evaluator.frechet_distance(x1, x1.copy())) < 1e-6
    # rank-deficient sets (fewer clips than classes): the un-rooted tiny
    # singular values of the reference's quirk
    y1, y2 = rng.standard_normal((6, 16)), rng.standard_normal((6, 16))
    np.testing.assert_allclose(evaluator.frechet_distance(y1, y2),
                               jev.frechet_distance(y1, y2), rtol=1e-9)


@pytest.mark.parametrize("frames", [4, 8, 16])
def test_prepare_fvd_clip_matches_jax(small_fvd, frames):
    video = (np.random.default_rng(frames).standard_normal(
        (2, frames, 16, 16, 3)) * 1.2).astype(np.float32)
    want = np.asarray(jev.prepare_fvd_clip(jnp.asarray(video)))
    got = evaluator.prepare_fvd_clip(torch.from_numpy(video))
    assert tuple(got.shape) == want.shape == (2, 16, RES, RES, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=PREP_TOL,
                               atol=PREP_TOL)


def test_fvd_evaluator_end_to_end_matches_jax(small_fvd):
    rng = np.random.default_rng(3)
    want_ev = jev.FVDEvaluator(i3d_params=None, num_classes=8, rng_seed=1)
    got_ev = evaluator.FVDEvaluator(
        i3d_state=flax_to_state_dict(
            *jax.device_get((want_ev.variables["params"],
                             want_ev.variables["batch_stats"]))),
        num_classes=8, device="cpu")
    for _ in range(2):
        gt = (rng.standard_normal((6, 4, 16, 16, 3)) * 0.3).astype(
            np.float32)
        gen = (rng.standard_normal((6, 4, 16, 16, 3)) * 0.5).astype(
            np.float32)
        want_ev.push_vals(jnp.asarray(gt), jnp.asarray(gen))
        got_ev.push_vals(torch.from_numpy(gt), torch.from_numpy(gen))
    for got, want in ((got_ev.gt_embeds, want_ev.gt_embeds),
                      (got_ev.gen_embeds, want_ev.gen_embeds)):
        got, want = np.concatenate(got), np.concatenate(want)
        assert got.shape == want.shape == (12, 8)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=EMBED_TOL * np.abs(want).max())
    fvd = got_ev.evaluate_metrics()["fvd"]
    want_fvd = want_ev.evaluate_metrics()["fvd"]
    # the Fréchet distance of embeddings that agree to EMBED_TOL
    assert np.isfinite(fvd) and fvd > 0
    np.testing.assert_allclose(fvd, want_fvd, rtol=1e-3)
    got_ev.reset()
    assert got_ev.gt_embeds == got_ev.gen_embeds == []


def test_random_init_evaluator_is_seeded():
    a = evaluator.FVDEvaluator(num_classes=8, device="cpu",
                               generator=torch.Generator().manual_seed(4))
    b = evaluator.FVDEvaluator(num_classes=8, device="cpu",
                               generator=torch.Generator().manual_seed(4))
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name
    assert float(a.model.Conv3d_1a_7x7.weight.std()) > 0
