"""Stage 1: VQ-VAE training.

Port of the step functions of ``gif_synthesis_with_discrete_diffusion_tpu/
train/stage1.py`` (``make_vqvae``, ``init_vqvae_state``, ``_train_step``,
``_eval_step``): one ``Adam(gen_lr, betas=(0.5, 0.999))`` over the VQ-VAE,
loss = the weighted registry total (``l_dummy`` = reconstruction / 0.06 +
0.25 * commitment). A step is uint8 clips -> ``preprocess_clip`` -> encoder
(BatchNorm on batch statistics) -> ``pre_vq_conv`` -> codebook in training
mode (kernel K6 once: the lookup, and the statistics its EMA update reads)
-> straight-through -> ``post_vq_conv`` -> decoder -> losses -> backward ->
Adam, as one stream of launches with no host synchronisation.

    state = build_stage1(TRAIN_STEP1, "cuda", torch.Generator().manual_seed(0))
    values = train_step(state, batch, torch.Generator("cuda").manual_seed(1))

:class:`Stage1Trainer` runs these steps under the trainer loop
(:mod:`.loop`): the JAX ``Stage1Trainer``'s build, steps, checkpointed
state, reconstructions for FVD (``sample_videos``), the FVD hook and the
two renders a render epoch. In a process group the step is one rank's
share of the global step: its rows through the model (BatchNorm and the
codebook on global statistics, :mod:`..models.vqvae`), the gradients
averaged over the ranks before Adam, so every rank keeps the same weights.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..data.preprocess import preprocess_clip
from ..data.synthetic import SyntheticVideoDataModule
from ..models.vqvae import VQVAE, init_vqvae_, make_vqvae
from ..parallel.distributed import all_gather_rows, average_gradients
from ..utils.logging import get_logger
from ..utils.renderer import render_animation
from .loop import Trainer
from .metrics import weighted_losses

__all__ = ["TRAIN_STEP1", "TRAIN_STEP1_BATCH", "TRAIN_STEP128",
           "TRAIN_STEP128_BATCH", "Stage1State", "make_vqvae",
           "build_stage1", "train_step", "eval_step", "synthetic_batch",
           "Stage1Trainer"]

log = get_logger(__name__)

# bench.py's train_step configuration (the 64 px variant, f32): 4-frame
# 64 px clips -> a (4, 8, 8) grid over 4096 codes of dim 128, 256 hidden
# channels, 3 residual layers, Adam at 4e-4. At its batch of 64 the codebook
# sees 64 * 4 * 8 * 8 = 16384 rows a step.
TRAIN_STEP1: dict[str, Any] = {
    "generator": {"embedding_dim": 128, "n_codes": 4096, "n_hiddens": 256,
                  "n_res_layers": 3, "downsample": (1, 8, 8),
                  "sequence_length": 4, "resolution": 64,
                  "dtype": "float32"},
    "losses": {"loss_dict": {"l_dummy": 1.0}},
    "lr_args": {"gen_lr": 4e-4},
}
TRAIN_STEP1_BATCH = 64

# bench.py's train_step128 row: the same model at the reference job's 128 px
# clips (a (4, 16, 16) grid, 65536 codebook rows a step at B=64), with bf16
# conv compute as the bench sets it from 128 px up.
TRAIN_STEP128: dict[str, Any] = {
    **TRAIN_STEP1,
    "generator": dict(TRAIN_STEP1["generator"], resolution=128,
                      dtype="bfloat16"),
}
TRAIN_STEP128_BATCH = 64


@dataclass
class Stage1State:
    vqvae: VQVAE
    optimizer: torch.optim.Optimizer
    resolution: int
    loss_dict: dict[str, float] = field(
        default_factory=lambda: {"l_dummy": 1.0})
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.vqvae.codebook.embeddings.device


def build_stage1(config: Mapping[str, Any], device: torch.device | str,
                 generator: torch.Generator) -> Stage1State:
    """Build the VQ-VAE from ``config`` (shaped like :data:`TRAIN_STEP1`),
    initialise it on the CPU from the CPU ``generator`` with the JAX
    package's init laws (the codebook not yet initialised from data), move
    it to ``device``, and put Adam over its parameters, as optax's
    ``adam(lr, b1=0.5, b2=0.999)``."""
    with torch.device("meta"):
        vqvae = make_vqvae(config)
    vqvae = vqvae.to_empty(device="cpu")
    init_vqvae_(vqvae, generator)
    vqvae = vqvae.to(device)
    lr = float((config.get("lr_args") or {}).get("gen_lr", 4e-4))
    optimizer = torch.optim.Adam(vqvae.parameters(), lr=lr,
                                 betas=(0.5, 0.999), eps=1e-8)
    loss_dict = dict((config.get("losses") or {}).get(
        "loss_dict", {"l_dummy": 1.0}))
    return Stage1State(vqvae=vqvae, optimizer=optimizer,
                       resolution=vqvae.resolution, loss_dict=loss_dict)


def _video(state: Stage1State, batch: Mapping[str, Any]) -> torch.Tensor:
    video = torch.as_tensor(batch["video"]).to(state.device)
    return preprocess_clip(video, state.resolution)


def train_step(state: Stage1State, batch: Mapping[str, Any],
               generator: Optional[torch.Generator] = None, **draws
               ) -> dict[str, torch.Tensor]:
    """One optimisation step on a batch (``video`` uint8, a tensor or a
    numpy array). Returns the loss values as device tensors (no host sync);
    the gradients stay on the parameters until the next step. ``draws``
    (``init_rows``, ``restart_rows``, each (n_codes, embedding_dim)) replace
    the codebook's candidate rows, else ``generator`` (on the model's
    device) draws them."""
    video = _video(state, batch)
    state.optimizer.zero_grad(set_to_none=True)
    out = state.vqvae({"video": video}, train=True, generator=generator,
                      **draws)
    total, values = weighted_losses(state.loss_dict, out)
    total.backward()
    average_gradients(state.vqvae.parameters())
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in values.items()}


@torch.no_grad()
def eval_step(state: Stage1State, batch: Mapping[str, Any]
              ) -> dict[str, torch.Tensor]:
    """The loss values on a batch without training: BatchNorm on its running
    statistics, and no update of the weights or of any buffer."""
    out = state.vqvae({"video": _video(state, batch)}, train=False)
    return weighted_losses(state.loss_dict, out)[1]


def synthetic_batch(config: Mapping[str, Any], batch_size: int,
                    seed: int = 0) -> dict[str, np.ndarray]:
    """The first training batch of the synthetic datamodule at the
    configuration's clip size (numpy, uint8 video): structured clips whose
    loss can fall, for smoke runs and timing."""
    g = dict(config.get("generator", config))
    dm = SyntheticVideoDataModule(
        batch_size=batch_size, sequence_length=int(g["sequence_length"]),
        resolution=int(g["resolution"]), num_train=batch_size,
        num_val=batch_size, seed=seed)
    return next(iter(dm.train_batches(0)))


class Stage1Trainer(Trainer):
    """The VQ-VAE under the trainer loop, as the JAX ``Stage1Trainer``."""

    def __init__(self, cfg, datamodule, run_dir):
        super().__init__(cfg, datamodule, run_dir)
        self.model_cfg = cfg.get("model", {})
        self.loss_dict = dict(
            self.model_cfg.get("losses", {}).get("loss_dict", {"l_dummy": 1.0}))
        g = self.model_cfg.get("generator", self.model_cfg)
        self.resolution = int(g.get("resolution", 128))
        self._names = [n for n in self.loss_dict] + ["total"]
        self.evaluator = None  # optional FVD evaluator (reconstruction FVD)

    def loss_names(self):
        return self._names

    def build(self, example_batch):
        self.state = build_stage1(self.model_cfg, self.device,
                                  torch.Generator().manual_seed(self.seed))
        n_params = sum(p.numel() for p in self.state.vqvae.parameters())
        log.info("VQ-VAE params: %.2fM", n_params / 1e6)

    def train_step(self, state, batch, rng):
        return state, train_step(state, batch, rng)

    def eval_step(self, state, batch, rng):
        return eval_step(state, batch)

    def state_dict(self) -> dict:
        return {"step": self.state.step,
                "vqvae": self.state.vqvae.state_dict(),
                "optimizer": self.state.optimizer.state_dict()}

    def load_state_dict(self, state) -> None:
        self.state.vqvae.load_state_dict(state["vqvae"])
        self.state.optimizer.load_state_dict(state["optimizer"])
        self.state.step = int(state["step"])

    @torch.no_grad()
    def sample_videos(self, batch, rng=None) -> torch.Tensor:
        """Reconstructions (the stage-1 'generated' clips for FVD); in a
        process group every rank's, gathered in rank order."""
        out = self.state.vqvae({"video": _video(self.state, batch)},
                               train=False)
        return all_gather_rows(out["pred_data"])

    def extra_eval_metrics(self, split: str, epoch: int) -> dict:
        if self.evaluator is None:
            return {}
        every = int(self.cfg.get("trainer", {}).get("fvd_every_n_epochs", 5))
        if split == "val" and epoch % every != 0:
            return {}
        return self.evaluator.evaluate(self, split, epoch)

    @torch.no_grad()
    def render_samples(self, epoch: int) -> None:
        try:
            batch = next(iter(self.datamodule.val_batches(epoch)))
        except StopIteration:
            return
        video = _video(self.state, {"video": batch["video"][:1]})
        out = self.state.vqvae({"video": video}, train=False)
        render_animation(out["pred_data"][0],
                         self.run_dir / f"epoch{epoch}_synthesis.gif")
        render_animation(video[0], self.run_dir / f"epoch{epoch}_original.gif")
