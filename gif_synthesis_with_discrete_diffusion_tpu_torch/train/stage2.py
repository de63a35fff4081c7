"""Stage 2: discrete-diffusion training over frozen VQ-VAE tokens.

Port of the step functions of ``gif_synthesis_with_discrete_diffusion_tpu/
train/stage2.py`` (``_encode_tokens``, ``_train_step``, ``_eval_step``): a
trainable generator (conditioner + D3PM denoiser) under
``Adam(gen_lr, betas=(0.5, 0.999))``, and a frozen VQ-VAE that turns each
uint8 clip into its token grid under ``torch.no_grad()``. On CUDA tensors
one step runs kernel K6 once (the codebook lookup), and K2 forward and K5
backward once per attention call (38 each for 19 layers), in the
denoiser's compute dtype.

    state = build_stage2(TRAIN_STEP2, "cuda", torch.Generator().manual_seed(0))
    values = train_step(state, batch, torch.Generator("cuda").manual_seed(1))

In text mode (``textencoder.mode: text``, :data:`TRAIN_STEP2_MSRVTT`) the
conditioner is the frozen CLIP text tower: :func:`prepare_batch` tokenizes
the batch's captions on the host (``state.tokenizer``), and the step runs
the tower forward on them (no CLIP gradient exists).

The trainer loop, checkpoints and logging are not ported yet (ROADMAP queue
1, item 15).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..data.preprocess import preprocess_clip
from ..data.synthetic import CLASS_NAMES
from ..generate import HONEST, build_models
from ..models.clip_text import make_tokenizer
from ..models.discrete_diffusion import DiscreteDiffusionModel
from ..models.vqvae import VQVAE
from .metrics import weighted_losses

__all__ = ["TRAIN_STEP2", "TRAIN_STEP2_BATCH", "TRAIN_STEP2_MSRVTT",
           "Stage2State", "build_stage2", "prepare_batch", "on_device",
           "encode_tokens", "train_step", "eval_step", "synthetic_batch"]

# bench.py's train_step2 configuration (label conditioning): 16-frame 64 px
# clips -> a (16, 8, 8) grid of 1024 tokens over 4096 codes (K = 4097), a
# 19-layer n_embd-64 denoiser with 16 heads of dim 4 over 100 steps in bf16
# compute on f32 parameters (the bench's setting; f32 compute with
# "dtype": "float32"), auxiliary loss 5e-4 (adaptive), Adam at 1e-4. As in
# the bench, no content_spatial_size: the positional grid is the latent's
# (t * h, w) = (128, 8).
TRAIN_STEP2: dict[str, Any] = {
    "vqvae": dict(HONEST["vqvae"]),
    "generator": {
        "diffusion_model": {
            "diffusion_step": 100,
            "transformer": {"n_layer": 19, "n_embd": 64, "n_head": 16,
                            "condition_dim": 512, "dtype": "bfloat16"},
        },
        "textencoder": {"mode": "label", "n_classes": 101, "dim": 512},
    },
    "generator_losses": {"loss_dict": {"l_dummy": 1.0}},
    "lr_args": {"gen_lr": 1e-4},
}
TRAIN_STEP2_BATCH = 16

# bench.py's train_step2 --config msrvtt (the MSRVTT job's text conditioning):
# 16-frame 96 px clips -> a (16, 12, 12) grid of 2304 tokens over 4096 codes
# on the job's 48 x 48 positional grid (the bench's own dict leaves
# content_spatial_size out, a (192, 12) grid: the same work but for the
# positional table), the TRAIN_STEP2 denoiser in bf16, and the frozen
# ViT-B/32 CLIP text tower as the conditioner, allowed the hash tokenizer
# (the BPE merges file is not in the repository). Batch 16.
TRAIN_STEP2_MSRVTT: dict[str, Any] = {
    **TRAIN_STEP2,
    "vqvae": dict(HONEST["vqvae"], resolution=96),
    "generator": {
        "diffusion_model": {
            "diffusion_step": 100,
            "transformer": dict(
                TRAIN_STEP2["generator"]["diffusion_model"]["transformer"],
                content_spatial_size=(48, 48)),
        },
        "textencoder": {"mode": "text", "dim": 512,
                        "allow_hash_tokenizer": True},
    },
}


@dataclass
class Stage2State:
    generator: DiscreteDiffusionModel   # trained
    vqvae: VQVAE                        # frozen: eval mode, no gradients
    optimizer: torch.optim.Optimizer
    resolution: int
    loss_dict: dict[str, float] = field(
        default_factory=lambda: {"l_dummy": 1.0})
    step: int = 0
    tokenizer: Any = None         # text mode only
    learnable_cf: bool = False

    @property
    def device(self) -> torch.device:
        return self.vqvae.codebook.embeddings.device


def build_stage2(config: Mapping[str, Any], device: torch.device | str,
                 generator: torch.Generator) -> Stage2State:
    """Build the generator and the frozen VQ-VAE from ``config`` (shaped like
    :data:`TRAIN_STEP2`) with :func:`..generate.build_models` (seeded init
    laws on the CPU, then moved to ``device``), and Adam over the
    generator's parameters, as optax's ``adam(lr, b1=0.5, b2=0.999)``. In
    text mode the tokenizer comes from ``textencoder.bpe_path`` /
    ``allow_hash_tokenizer`` (:func:`..models.clip_text.make_tokenizer`)."""
    gcfg = config["generator"]
    tenc = dict(gcfg.get("textencoder") or {})
    tokenizer = (make_tokenizer(
        tenc.get("bpe_path"),
        allow_hash=bool(tenc.get("allow_hash_tokenizer", False)))
        if tenc.get("mode") == "text" else None)
    models = build_models(config, device, generator)
    vqvae = models.vqvae.eval().requires_grad_(False)
    lr = float((config.get("lr_args") or {}).get("gen_lr", 1e-4))
    optimizer = torch.optim.Adam(models.generator.parameters(), lr=lr,
                                 betas=(0.5, 0.999), eps=1e-8)
    loss_dict = dict((config.get("generator_losses") or {}).get(
        "loss_dict", {"l_dummy": 1.0}))
    learnable_cf = bool(gcfg.get("diffusion_model", {}).get("learnable_cf",
                                                            False))
    return Stage2State(generator=models.generator, vqvae=vqvae,
                       optimizer=optimizer,
                       resolution=int(config["vqvae"]["resolution"]),
                       loss_dict=loss_dict, tokenizer=tokenizer,
                       learnable_cf=learnable_cf)


def prepare_batch(batch: Mapping[str, Any], tokenizer,
                  learnable_cf: bool = False) -> dict:
    """The JAX trainer's ``_prepare_batch``: with a ``tokenizer`` (text
    mode) and captions under ``text``, add ``text_tokens`` (B, 77) int32,
    and under ``learnable_cf`` ``empty_text_mask`` (B,) bool, True where a
    caption is empty (those rows train the learnable CF embedding)."""
    batch = dict(batch)
    if tokenizer is not None and "text" in batch:
        batch["text_tokens"] = tokenizer(batch["text"])
        if learnable_cf:
            batch["empty_text_mask"] = np.array(
                [not str(t).strip() for t in batch["text"]], bool)
    return batch


def on_device(batch: Mapping[str, Any], device: torch.device) -> dict:
    """Tensors of the batch on ``device`` (token ids as int64); host-only
    entries (text) stay."""
    out = {}
    for k, v in batch.items():
        if k == "text":
            out[k] = v
        elif k == "text_tokens":
            out[k] = torch.as_tensor(v).to(device, torch.int64)
        else:
            out[k] = torch.as_tensor(v).to(device)
    return out


@torch.no_grad()
def encode_tokens(state: Stage2State, video_u8: torch.Tensor
                  ) -> torch.Tensor:
    """uint8 clips (B, T, H, W, 3) -> flat token grids (B, L) int64."""
    tokens = state.vqvae.encode(preprocess_clip(video_u8, state.resolution))
    return tokens.reshape(tokens.shape[0], -1).long()


def _values(state: Stage2State, out: dict) -> tuple[torch.Tensor, dict]:
    total, values = weighted_losses(state.loss_dict, {"losses": out["loss"]})
    values["diffusion_acc"] = out["diffusion_acc"]
    values["diffusion_keep"] = out["diffusion_keep"]
    return total, values


def train_step(state: Stage2State, batch: Mapping[str, Any],
               generator: Optional[torch.Generator] = None, **draws
               ) -> dict[str, torch.Tensor]:
    """One optimisation step on a batch (``video`` uint8 and the
    conditioner's keys). Returns the loss values and this batch's telemetry
    as device tensors (no host sync); the gradients stay on the parameters
    until the next step. ``draws`` (``t``, ``pt``, ``noise``) replace the
    loss's random draws, else ``generator`` (on the model's device) gives
    them."""
    batch = on_device(batch, state.device)
    flat = encode_tokens(state, batch["video"])
    state.optimizer.zero_grad(set_to_none=True)
    out = state.generator(batch, flat, generator=generator, train=True,
                          **draws)
    total, values = _values(state, out)
    total.backward()
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in values.items()}


@torch.no_grad()
def eval_step(state: Stage2State, batch: Mapping[str, Any],
              generator: Optional[torch.Generator] = None, **draws
              ) -> dict[str, torch.Tensor]:
    """The loss values on a batch without training: no update of the
    weights or of the Lt and telemetry buffers."""
    batch = on_device(batch, state.device)
    flat = encode_tokens(state, batch["video"])
    out = state.generator(batch, flat, generator=generator, train=False,
                          **draws)
    return _values(state, out)[1]


def synthetic_batch(config: Mapping[str, Any], batch_size: int,
                    generator: torch.Generator) -> dict[str, Any]:
    """A seeded batch of uniform-noise uint8 clips at the configuration's
    size, with labels, for smoke runs and timing; in text mode also their
    class names as captions (``text``), as the synthetic datamodule gives
    them."""
    vq = config["vqvae"]
    t, r = int(vq["sequence_length"]), int(vq["resolution"])
    video = torch.randint(0, 256, (batch_size, t, r, r, 3),
                          generator=generator, dtype=torch.uint8)
    n_classes = int((config["generator"].get("textencoder") or {}).get(
        "n_classes", 2))
    label = torch.randint(0, n_classes, (batch_size,), generator=generator)
    batch: dict[str, Any] = {"video": video, "label": label}
    if (config["generator"].get("textencoder") or {}).get("mode") == "text":
        batch["text"] = [CLASS_NAMES[int(i) % len(CLASS_NAMES)]
                         for i in label]
    return batch
