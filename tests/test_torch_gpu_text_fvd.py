"""Text conditioning and FVD on a CUDA card against the same modules on the
CPU: ``python -m pytest --noconftest -m gpu tests/test_torch_gpu_text_fvd.py``.

The CLIP text tower, the I3D and ResNet-50 have no hand-written kernel (the
JAX package runs them on XLA's convolutions and matmuls, the port on
cuDNN / cuBLAS); these tests hold their card runs to the CPU's, and the
text-conditioned training step, whose denoiser runs K2 and K5 on the card,
to the same step on the CPU. The checks and tolerances are
``chip_smoke.py``'s. Each test skips where there is no card.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from gif_synthesis_with_discrete_diffusion_tpu_torch.eval.evaluator import (
    frechet_distance)
from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage2

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's run against the CPU's)")
    chip_smoke._reference_precision(torch)
    return torch.device("cuda")


@pytest.mark.parametrize("b", [1, 8])
def test_clip_tower_on_the_card_matches_the_cpu(cuda, b):
    err, ms = chip_smoke._check_tower(torch, "test", b)
    assert err <= chip_smoke.TEXT_TOWER_TOL and ms > 0


@pytest.mark.parametrize("shape", [(4, 8, 32, 32, 3), (4, 16, 64, 64, 3)])
def test_i3d_on_the_card_matches_the_cpu(cuda, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    got, want, err = chip_smoke._on_card_and_cpu(
        torch, chip_smoke._i3d, lambda m, dev: m(x.to(dev)), 2)
    assert got.shape == (shape[0], 400)
    assert err <= chip_smoke.FVD_NET_TOL
    n = shape[0] // 2
    a = frechet_distance(got[:n].numpy(), got[n:].numpy())
    w = frechet_distance(want[:n].numpy(), want[n:].numpy())
    assert np.isfinite(a) and abs(a - w) <= chip_smoke.FVD_TOL * abs(w)


@pytest.mark.parametrize("features_only", [False, True])
def test_resnet50_on_the_card_matches_the_cpu(cuda, features_only):
    x = torch.randn((3, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    got, _, err = chip_smoke._on_card_and_cpu(
        torch, chip_smoke._resnet50,
        lambda m, dev: m(x.to(dev), features_only=features_only), 4)
    assert got.shape == (3, 2048 if features_only else 1000)
    assert err <= chip_smoke.FVD_NET_TOL


def _small_text_step(device, dtype):
    config = chip_smoke._small_train_config(dtype)
    config["generator"]["textencoder"] = {
        "mode": "text", "dim": 32, "width": 64, "heads": 4, "layers": 2,
        "allow_hash_tokenizer": True}
    state = stage2.build_stage2(config, device,
                                torch.Generator().manual_seed(0))
    batch = stage2.prepare_batch(
        {"video": stage2.synthetic_batch(
            config, 3, torch.Generator().manual_seed(1))["video"],
         "text": ["a man is singing", "", "archery"]}, state.tokenizer)
    g = torch.Generator().manual_seed(2)
    draws = dict(t=torch.tensor([0, 5, 5]), pt=torch.full((3,), 0.125),
                 noise=torch.rand((3, 17, 32), generator=g))
    loss = float(stage2.train_step(state, batch, **draws)["total"])
    return loss, {n: p.grad.cpu() for n, p in
                  state.generator.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_train_step_on_the_card_matches_the_cpu(cuda, dtype):
    got, want = _small_text_step("cuda", dtype), _small_text_step("cpu",
                                                                 dtype)
    assert set(got[1]) == set(want[1])
    assert not any(n.startswith("conditioner.") for n in got[1])
    lerr, gerr = chip_smoke._compare_train_steps(got, want,
                                                 dtype == "bfloat16")
    if dtype == "float32":
        assert lerr <= chip_smoke.TRAIN_LOSS_RTOL
        assert gerr <= chip_smoke.TRAIN_GRAD_TOL
    else:
        assert lerr <= chip_smoke.BF16_TRAIN_TOL
        assert gerr <= chip_smoke.BF16_TRAIN_TOL
