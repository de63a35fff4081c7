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

:class:`Stage2Trainer` runs these steps under the trainer loop
(:mod:`.loop`), as the JAX ``Stage2Trainer``: the composed config's
``model`` node mapped once onto :func:`build_stage2`'s layout
(:func:`stage2_config`), the frozen VQ-VAE read from a stage-1 run's
checkpoints (:func:`load_stage1_checkpoint`), sampling on the route
``trainer.sampler`` (default ``auto``) for FVD and the renders, and the
three render artefacts (the reverse process, the one-step x0 prediction,
the original). In a process group the step is one rank's share of the
global step (the loss's draws made for the global batch, :mod:`..models.
discrete_diffusion`; the gradients averaged over the ranks before Adam),
and sampling splits the batch over the ranks (:func:`..generate.
sample_token_grid`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..data.preprocess import preprocess_clip
from ..data.synthetic import CLASS_NAMES
from ..generate import HONEST, GenerationModels, build_models, sample_videos
from ..models.clip_text import make_tokenizer
from ..models.discrete_diffusion import DiscreteDiffusionModel, resolve_sampler
from ..models.vqvae import VQVAE
from ..parallel.distributed import average_gradients
from ..utils.checkpoint import CheckpointManager
from ..utils.logging import get_logger
from ..utils.renderer import render_animation
from .loop import Trainer, device_batch
from .metrics import weighted_losses

__all__ = ["TRAIN_STEP2", "TRAIN_STEP2_BATCH", "TRAIN_STEP2_MSRVTT",
           "Stage2State", "build_stage2", "prepare_batch", "on_device",
           "encode_tokens", "train_step", "eval_step", "synthetic_batch",
           "stage2_config", "load_stage1_checkpoint", "Stage2Trainer"]

log = get_logger(__name__)

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
    average_gradients(state.generator.parameters())
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


def stage2_config(model_cfg: Mapping[str, Any]) -> dict:
    """A composed config's ``model`` node (``autoencoder``, ``generator``,
    ``generator_losses``, ``lr_args``) in :func:`build_stage2`'s layout."""
    return {"vqvae": dict(model_cfg.get("autoencoder", {})),
            "generator": dict(model_cfg.get("generator", {})),
            "generator_losses": dict(model_cfg.get("generator_losses")
                                     or {"loss_dict": {"l_dummy": 1.0}}),
            "lr_args": dict(model_cfg.get("lr_args") or {})}


def load_stage1_checkpoint(ckpt_dir: str, vqvae: VQVAE) -> int:
    """Load the newest checkpoint of a stage-1 run of the port (its
    ``checkpoints/`` directory) into ``vqvae``, bit for bit; returns its
    step. A reference ``.ckpt`` file is ROADMAP item [1]."""
    path = Path(str(ckpt_dir))
    if path.is_file() or path.suffix == ".ckpt":
        raise NotImplementedError(
            f"checkpoint_paths.autoencoder={ckpt_dir!r}: reading a "
            f"reference .ckpt file is ROADMAP item [1], not ported yet; "
            f"give a stage-1 run's checkpoints/ directory")
    if not path.is_dir():
        raise FileNotFoundError(f"no stage-1 checkpoints at {ckpt_dir!r}")
    mgr = CheckpointManager(path, monitor=None)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no stage-1 checkpoint in {ckpt_dir!r}")
    vqvae.load_state_dict(mgr.restore()["vqvae"])
    mgr.close()
    return step


class Stage2Trainer(Trainer):
    """The generator under the trainer loop over the frozen VQ-VAE, as the
    JAX ``Stage2Trainer``."""

    def __init__(self, cfg, datamodule, run_dir):
        super().__init__(cfg, datamodule, run_dir)
        # stage 2 renders every 10 validated epochs; an explicit
        # trainer.render_every_n_epochs still wins
        if (cfg.get("trainer", {}) or {}).get("render_every_n_epochs") is None:
            self.render_every_n_epochs = 10
        self.model_cfg = cfg.get("model", {})
        self.build_cfg = stage2_config(self.model_cfg)
        self.loss_dict = dict(self.build_cfg["generator_losses"].get(
            "loss_dict", {"l_dummy": 1.0}))
        self.resolution = int(self.build_cfg["vqvae"].get("resolution", 128))
        self._names = ([n for n in self.loss_dict] + ["total"]
                       + ["diffusion_acc", "diffusion_keep"])
        tenc = self.build_cfg["generator"].get("textencoder") or {}
        tenc = tenc if isinstance(tenc, Mapping) else {}
        self._text_mode = tenc.get("mode") == "text"
        self.tokenizer = (make_tokenizer(
            tenc.get("bpe_path"),
            allow_hash=bool(tenc.get("allow_hash_tokenizer", False)))
            if self._text_mode else None)
        self._learnable_cf = bool(
            self.build_cfg["generator"].get("diffusion_model", {})
            .get("learnable_cf", False))
        self.sampler = None   # the route sampling takes, fixed by build()
        self.evaluator = None  # set externally or via cfg (FVD)

    def loss_names(self):
        return self._names

    def _prepare_batch(self, batch: Mapping[str, Any]) -> dict:
        return prepare_batch(batch, self.tokenizer, self._learnable_cf)

    def build(self, example_batch):
        self.state = build_stage2(self.build_cfg, self.device,
                                  torch.Generator().manual_seed(self.seed))
        self.state.tokenizer = self.tokenizer
        ckpt_paths = self.model_cfg.get("checkpoint_paths") or {}
        if isinstance(ckpt_paths, Mapping) and ckpt_paths.get("autoencoder"):
            step = load_stage1_checkpoint(ckpt_paths["autoencoder"],
                                          self.state.vqvae)
            log.info("loaded stage-1 autoencoder (step %d) from %s", step,
                     ckpt_paths["autoencoder"])
        d3pm = self.state.generator.diffusion
        self.sampler = resolve_sampler(
            str(self.cfg.get("trainer", {}).get("sampler") or "auto"),
            self.device, d3pm.content_seq_len, d3pm.transformer, True)
        n_params = sum(p.numel() for p in self.state.generator.parameters())
        log.info("D3PM generator params: %.2fM; sampler route %s",
                 n_params / 1e6, self.sampler)

    def train_step(self, state, batch, rng):
        return state, train_step(state, batch, rng)

    def eval_step(self, state, batch, rng):
        return eval_step(state, batch, rng)

    def state_dict(self) -> dict:
        return {"step": self.state.step,
                "generator": self.state.generator.state_dict(),
                "vqvae": self.state.vqvae.state_dict(),
                "optimizer": self.state.optimizer.state_dict()}

    def load_state_dict(self, state) -> None:
        self.state.generator.load_state_dict(state["generator"])
        self.state.vqvae.load_state_dict(state["vqvae"])
        self.state.optimizer.load_state_dict(state["optimizer"])
        self.state.step = int(state["step"])

    def sample_videos(self, batch, rng: torch.Generator) -> torch.Tensor:
        """Generate clips for a (host) batch on the trainer's sampler route:
        (B, T, H, W, 3). ``rng`` is a CPU generator (the per-step seeds).
        In a process group ``batch`` is this rank's rows and the clips are
        every rank's, in rank order."""
        db = device_batch(self._prepare_batch(batch), self.device)
        models = GenerationModels(self.state.generator, self.state.vqvae)
        return sample_videos(models, db, rng, sampler=self.sampler)

    @torch.no_grad()
    def _single_step_pred(self, db: Mapping[str, Any],
                          rng: torch.Generator) -> torch.Tensor:
        """Decode the model's one-shot x0 prediction for a batch: noise a
        grid to x_t, predict x0 (argmax), decode."""
        flat = encode_tokens(self.state, db["video"])
        out = self.state.generator(db, flat, generator=rng, train=False)
        tokens = out["pred_data"].reshape(flat.shape[0],
                                          *self.state.vqvae.latent_shape)
        return self.state.vqvae.decode(tokens)

    def _run_epoch(self, split, epoch):
        # host-side tokenization before the base loop ships batches
        orig = self.datamodule
        if self._text_mode:
            self.datamodule = _TokenizingDM(orig, self._prepare_batch)
        try:
            return super()._run_epoch(split, epoch)
        finally:
            self.datamodule = orig

    def render_samples(self, epoch: int) -> None:
        """The three render artefacts of a render epoch: the reverse
        process's synthesis, the decoded one-step x0 prediction, and the
        original."""
        try:
            batch = next(iter(self.datamodule.val_batches(epoch)))
        except StopIteration:
            return
        small = {k: (v[:1] if hasattr(v, "__getitem__") else v)
                 for k, v in batch.items()}
        videos = self.sample_videos(small, self.next_sample_rng())
        render_animation(videos[0],
                         self.run_dir / f"epoch{epoch}_synthesis.gif")
        db = device_batch(self._prepare_batch(small), self.device)
        single = self._single_step_pred(db, self.next_rng())
        render_animation(single[0],
                         self.run_dir / f"epoch{epoch}_single_step.gif")
        gt = preprocess_clip(db["video"], self.resolution)
        render_animation(gt[0], self.run_dir / f"epoch{epoch}_original.gif")

    def extra_eval_metrics(self, split: str, epoch: int) -> dict:
        if self.evaluator is None:
            return {}
        every = int(self.cfg.get("trainer", {}).get("fvd_every_n_epochs", 5))
        if split == "val" and epoch % every != 0:
            return {}
        return self.evaluator.evaluate(self, split, epoch)


class _TokenizingDM:
    """Wraps a datamodule so every batch carries text_tokens."""

    def __init__(self, dm, prepare):
        self._dm = dm
        self._prepare = prepare

    def __getattr__(self, name):
        attr = getattr(self._dm, name)
        if name.endswith("_batches"):
            def wrapped(*a, **k):
                for b in attr(*a, **k):
                    yield self._prepare(b)
            return wrapped
        return attr
