"""The harness on a CUDA card against the same run on the CPU:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu_harness.py``.

A small stage-2 ``tasks.train`` run (two layers, T=8, K=17, L=32, B=3; one
step, then validation, the renders and the checkpoint) on the card and on
the CPU, its step's draws handed in from the host so both take the same
step: the step's loss within ``chip_smoke.TRAIN_LOSS_RTOL`` (relative),
every gradient within ``chip_smoke.TRAIN_GRAD_TOL`` of its tensor's
max-abs (floored at 1e-4 of the largest), Adam's first moment within
(1 - b1) times that, the Lt and telemetry buffers within
``chip_smoke.TRAIN_LOSS_RTOL`` of their max-abs, each parameter within
lr / 100 of the CPU's wherever the gradient's sign is settled (its
magnitude past twice the gradient tolerance and 100 eps) and within one
Adam step (2 lr) where it is not, the frozen VQ-VAE bit for bit;
then the card's checkpoint restores onto the card bit for bit. These are
phase 7's tolerances. Skips where there is no card.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from gif_synthesis_with_discrete_diffusion_tpu_torch import tasks  # noqa: E402
from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage2  # noqa: E402
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointManager)
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils.config import (  # noqa: E402
    compose)

pytestmark = pytest.mark.gpu

LR = 1e-3
SMALL = [
    "model=discrete_diffusion", "datamodule=synthetic", "batch_size=3",
    "datamodule.resolution=8", "datamodule.sequence_length=2",
    "datamodule.num_train=3", "datamodule.num_val=3",
    "model.autoencoder.embedding_dim=16", "model.autoencoder.n_codes=16",
    "model.autoencoder.n_hiddens=32", "model.autoencoder.n_res_layers=1",
    "model.autoencoder.downsample=[1,2,2]",
    "model.generator.diffusion_model.diffusion_step=8",
    "model.generator.diffusion_model.transformer.n_layer=2",
    "model.generator.diffusion_model.transformer.condition_dim=32",
    "model.generator.diffusion_model.transformer.content_spatial_size=[4,8]",
    "model/textencoder=label", "model.generator.textencoder.dim=32",
    "model.generator.textencoder.n_classes=5", f"model.lr_args.gen_lr={LR}",
    "model.do_evaluation=false", "trainer.max_epochs=1", "seed=0",
    "logger=csv", "extras.print_config=false",
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's run against the CPU's)")
    chip_smoke._reference_precision(torch)
    return torch.device("cuda")


def _run(device: str, out: Path):
    """One ``tasks.train`` run; its trainer and the step's values."""
    seen = {}
    orig = stage2.Stage2Trainer.train_step
    g = torch.Generator().manual_seed(2)
    draws = dict(t=torch.tensor([0, 5, 5]), pt=torch.full((3,), 0.125),
                 noise=torch.rand((3, 17, 32), generator=g))

    def step(self, state, batch, rng):
        seen["trainer"] = self
        values = stage2.train_step(state, batch, rng, **draws)
        seen["values"] = {k: float(v) for k, v in values.items()}
        return state, values

    stage2.Stage2Trainer.train_step = step
    try:
        tasks.train(compose("train", SMALL + [
            f"trainer.platform={device}", f"paths.output_dir={out}"]))
    finally:
        stage2.Stage2Trainer.train_step = orig
    return seen["trainer"], seen["values"]


def test_harness_on_the_card_matches_the_cpu(cuda, tmp_path):
    card, got = _run("cuda", tmp_path / "cuda")
    cpu, want = _run("cpu", tmp_path / "cpu")
    assert card.device.type == "cuda" and card.sampler == "megakernel"
    assert abs(got["total"] - want["total"]) <= \
        chip_smoke.TRAIN_LOSS_RTOL * abs(want["total"])
    gen_card = dict(card.state.generator.named_parameters())
    gen_cpu = dict(cpu.state.generator.named_parameters())
    group = cpu.state.optimizer.param_groups[0]
    b1, eps = group["betas"][0], group["eps"]
    top = max(float(p.grad.abs().max()) for p in gen_cpu.values()
              if p.grad is not None)
    for name, p in gen_cpu.items():
        q = gen_card[name]
        diff = (q.detach().cpu() - p.detach()).abs()
        assert float(diff.max()) <= 2 * LR * (1 + 1e-3), name
        if p.grad is None:
            continue
        scale = max(float(p.grad.abs().max()), 1e-4 * top)
        tol = chip_smoke.TRAIN_GRAD_TOL * scale
        assert float((q.grad.cpu() - p.grad).abs().max()) <= tol, name
        m_card = card.state.optimizer.state[q]["exp_avg"].cpu()
        m_cpu = cpu.state.optimizer.state[p]["exp_avg"]
        assert float((m_card - m_cpu).abs().max()) <= (1 - b1) * tol, name
        # one Adam step moves each entry by lr * g / (|g| + eps): where
        # the sign of g is settled the two devices' steps agree to well
        # under lr (a step of the wrong sign is 2 lr off)
        settled = p.grad.abs() > max(2 * tol, tol + 100 * eps)
        if settled.any():
            assert float(diff[settled].max()) <= LR / 100, name
    for name, b in cpu.state.generator.named_buffers():
        c = dict(card.state.generator.named_buffers())[name].cpu()
        assert float((c - b).abs().max()) <= chip_smoke.TRAIN_LOSS_RTOL * max(
            float(b.abs().max()), 1e-6), name
    for name, b in cpu.state.vqvae.state_dict().items():
        assert torch.equal(card.state.vqvae.state_dict()[name].cpu(), b), name

    saved = card.state_dict()
    mgr = CheckpointManager(card.run_dir / "checkpoints", monitor=None)
    restored = mgr.restore(card.state_dict())
    for key in ("generator", "vqvae"):
        for name, t in restored[key].items():
            assert t.device.type == "cuda"
            assert torch.equal(t, saved[key][name]), (key, name)
