"""Stage-2 model: D3PM over VQ tokens with switchable conditioning.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/
discrete_diffusion.py``: :class:`D3PM` owns the denoiser transformer, the
schedule, the importance-sampling and telemetry buffers (the flax
``diffusion`` collection, here registered buffers) and the optional
learnable classifier-free embedding; its ``forward`` is the training loss.
:class:`DiscreteDiffusionModel` adds the conditioner, and
:func:`make_discrete_diffusion` builds both from the same nested dict as the
JAX package's YAML. ``transformer.dtype: bfloat16`` gives the denoiser bf16
compute on f32 parameters, as the JAX package's ``transformer_dtype``;
``transformer.checkpoint: true`` recomputes each block's forward in the
backward (the JAX package's ``remat``).

Dropout (``attn_pdrop`` / ``resid_pdrop`` above 0) is ROADMAP finding F10,
a fault of the reference that the port keeps: the JAX package builds,
samples and evaluates such a model (with dropout off, as every evaluation
is deterministic), but its training step asks flax's ``Dropout`` for a
``"dropout"`` PRNG stream it is never given and raises ``InvalidRngError``.
The port builds and samples the same, and its training step raises too; it
draws no dropout mask that the JAX package lacks.

In a data-parallel run (a process group) the training loss's draws (t with
pt, the q-sample noise) are made for the global batch from the generator,
the same on every rank, and each rank takes its rows; the Lt and telemetry
buffers take the global batch's update (the values gathered in rank
order). So an N-rank step is the one-rank step on the global batch.

Sampler routes (``D3PM.sample(mode=)``): ``megakernel`` and ``model`` carry
the token grid; ``reference`` carries the (B, K, L) log-onehot through
:func:`.d3pm.sample` (with ``filter_ratio`` and ``content_token``), as
does :meth:`D3PM.sample_fast`. All are posterior-equivalent to
:func:`.d3pm.sample_fused`.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.megakernel import (MEGAKERNEL_MAX_SEQ, kernels_fit,
                              megakernel_sample_tokens)
from ..ops.sampler_kernel import sample_tokens
from ..parallel.distributed import all_gather_rows, rank, world_size
from . import d3pm
from .conditioning import build_conditioner, init_conditioner_
from .denoiser import DenoiserTransformer, init_denoiser_
from .layers import compute_dtype

__all__ = ["D3PM", "DiscreteDiffusionModel", "make_discrete_diffusion",
           "init_discrete_diffusion_", "resolve_sampler", "F10_MESSAGE"]

F10_MESSAGE = (
    "ROADMAP finding F10: a training step with dropout (attn_pdrop / "
    "resid_pdrop > 0) raises, as the JAX package's does: its train path runs "
    "the denoiser with deterministic=False but passes only the 'diffusion' "
    "PRNG, so flax's Dropout raises InvalidRngError ('needs PRNG for "
    "\"dropout\"'). Building, sampling and evaluation work; set both to 0 "
    "to train")


def resolve_sampler(mode: str, device: torch.device, seq_len: int,
                    transformer: nn.Module, has_condition: bool) -> str:
    """'auto' -> the sampler route for a model on ``device``: the whole-step
    kernels ('megakernel') on a CUDA device for grids of at most
    ``MEGAKERNEL_MAX_SEQ`` tokens, else the denoiser followed by the fused
    sampler step ('model'). The JAX package's rule with the card in the
    TPU's place, and, since the CUDA kernels are built for one width and
    cross-attend to a condition, only for a denoiser they fit
    (:func:`..ops.megakernel.kernels_fit`) that is given a condition
    sequence. A rule over the configuration, decided before anything is
    launched; an explicit 'megakernel' on another model raises. Other modes
    pass through."""
    if mode != "auto":
        return mode
    return ("megakernel" if device.type == "cuda"
            and seq_len <= MEGAKERNEL_MAX_SEQ and has_condition
            and kernels_fit(transformer) else "model")


class D3PM(nn.Module):
    """Discrete diffusion over a token grid."""

    def __init__(self, num_embed: int, content_seq_len: int = 1024,
                 spatial_size: Sequence[int] = (32, 32),
                 diffusion_step: int = 100,
                 auxiliary_loss_weight: float = 5.0e-4,
                 adaptive_auxiliary_loss: bool = True,
                 mask_weight: Sequence[float] = (1.0, 1.0),
                 guidance_scale: float = 2.0, learnable_cf: bool = False,
                 n_layer: int = 19, n_embd: int = 64, n_head: int = 16,
                 condition_seq_len: int = 77, condition_dim: int = 512,
                 mlp_hidden_times: int = 4, block_activate: str = "GELU2",
                 transformer_dtype: torch.dtype = torch.float32,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 checkpoint: bool = False):
        super().__init__()
        self.num_embed = num_embed            # codebook size WITHOUT mask
        self.attn_pdrop = attn_pdrop          # F10: building and sampling
        self.resid_pdrop = resid_pdrop        # only (module docstring)
        self.content_seq_len = content_seq_len
        self.diffusion_step = diffusion_step
        self.auxiliary_loss_weight = auxiliary_loss_weight
        self.adaptive_auxiliary_loss = adaptive_auxiliary_loss
        self.mask_weight = tuple(mask_weight)
        self.guidance_scale = guidance_scale
        self.learnable_cf = learnable_cf
        self.condition_dim = condition_dim
        self.transformer = DenoiserTransformer(
            num_embed=num_embed, spatial_size=spatial_size, n_layer=n_layer,
            n_embd=n_embd, n_head=n_head, condition_dim=condition_dim,
            diffusion_step=diffusion_step, mlp_hidden_times=mlp_hidden_times,
            block_activate=block_activate, dtype=transformer_dtype,
            checkpoint=checkpoint)
        # the flax ``diffusion`` collection: Lt importance-sampling buffers
        # and the per-timestep acc / keep telemetry
        for name in ("lt_history", "lt_count", "diffusion_acc",
                     "diffusion_keep"):
            self.register_buffer(name, torch.zeros(diffusion_step))
        if learnable_cf:
            self.empty_text_embed = nn.Parameter(
                torch.empty(condition_seq_len, condition_dim))
        self._schedule: Optional[d3pm.D3PMSchedule] = None

    @property
    def num_classes(self) -> int:
        return self.num_embed + 1

    def schedule(self) -> d3pm.D3PMSchedule:
        """The schedule's tensors on the module's device (made once per
        device)."""
        device = self.lt_history.device
        if self._schedule is None or self._schedule.device != device:
            self._schedule = d3pm.make_schedule(
                self.diffusion_step, self.num_classes, device=device)
        return self._schedule

    def empty_cond_embed(self, batch_size: int, seq_len: int
                         ) -> torch.Tensor:
        """The learnable empty-text embedding, broadcast to (B, S, D).
        Requires ``learnable_cf``."""
        e = self.empty_text_embed[None, :seq_len, :]
        return e.expand(batch_size, seq_len, self.condition_dim)

    def apply_learnable_cf(self, cond_emb: Optional[torch.Tensor],
                           empty_mask: Optional[torch.Tensor]
                           ) -> Optional[torch.Tensor]:
        """Replace the condition rows flagged empty with the learnable CF
        embedding. No-op unless ``learnable_cf``."""
        if not self.learnable_cf or cond_emb is None or empty_mask is None:
            return cond_emb
        b, s, _ = cond_emb.shape
        m = torch.as_tensor(empty_mask, device=cond_emb.device).reshape(
            -1, 1, 1).to(torch.bool)
        return torch.where(m, self.empty_cond_embed(b, s), cond_emb)

    def forward(self, content_token: torch.Tensor,
                cond_emb: Optional[torch.Tensor], *,
                generator: Optional[torch.Generator] = None,
                train: bool = True,
                empty_mask: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None,
                pt: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> dict:
        """Training loss over the (B, L) data tokens: the mean vb loss, the
        x0 prediction, the model posterior's probabilities (B, K, L) under
        the JAX ``__call__``'s key ``logits`` (outside the autograd graph)
        and their logarithm under ``log_model_prob``, and this batch's
        telemetry scalars. With ``train`` the Lt and telemetry
        buffers are updated in place. The draws (``t`` with ``pt``, the
        (B, K, L) uniforms ``noise``) come from ``generator`` unless
        given; in a process group they are drawn for the global batch and
        this rank's rows kept (module docstring). With dropout configured
        a training step raises (F10)."""
        if train and (self.attn_pdrop > 0 or self.resid_pdrop > 0):
            raise RuntimeError(F10_MESSAGE)
        cond_emb = self.apply_learnable_cf(cond_emb, empty_mask)
        lt = d3pm.LtState(history=self.lt_history, count=self.lt_count)
        t, pt, noise = self._global_draws(generator, lt, content_token, t,
                                          pt, noise)
        vb_loss, aux, new_lt = d3pm.train_loss(
            generator, self.schedule(), self.transformer, content_token,
            cond_emb, lt, auxiliary_loss_weight=self.auxiliary_loss_weight,
            adaptive_auxiliary_loss=self.adaptive_auxiliary_loss,
            mask_weight=self.mask_weight, is_train=train, t=t, pt=pt,
            noise=noise, gather_rows=all_gather_rows)
        if train:
            acc, keep = d3pm.update_diffusion_telemetry(
                self.diffusion_acc, self.diffusion_keep,
                *(all_gather_rows(x) for x in (
                    aux["t"], aux["x0_recon"], content_token, aux["xt"],
                    aux["xt_1_recon"])))
            with torch.no_grad():
                self.lt_history.copy_(new_lt.history)
                self.lt_count.copy_(new_lt.count)
                self.diffusion_acc.copy_(acc)
                self.diffusion_keep.copy_(keep)
        b, L = content_token.shape
        loss = torch.sum(vb_loss) / (b * L)
        acc = torch.mean((aux["x0_recon"] == content_token).to(torch.float32))
        keep = torch.mean((aux["xt_1_recon"] == aux["xt"]).to(torch.float32))
        return {"loss": loss, "pred_data": aux["x0_recon"],
                "logits": aux["log_model_prob"].detach().exp(),
                "log_model_prob": aux["log_model_prob"],
                "diffusion_acc": acc, "diffusion_keep": keep}

    def _global_draws(self, generator, lt, content_token, t, pt, noise):
        """The loss's draws not given, made for the global batch (every
        rank's rows; without a group this process's) in
        :func:`.d3pm.train_loss`'s order, then this rank's rows of each."""
        b, L = content_token.shape
        n, r = world_size(), rank()
        rows = slice(r * b, (r + 1) * b)
        if (t is None) != (pt is None):
            raise ValueError("give both t and pt, or neither")
        if t is None:
            t, pt = d3pm.sample_time(generator, lt, n * b,
                                     self.diffusion_step)
            t, pt = t[rows], pt[rows]
        if noise is None:
            noise = torch.rand((n * b, self.num_classes, L),
                               generator=generator,
                               device=generator.device)[rows]
        return t, pt, noise

    @torch.no_grad()
    def sample(self, cond_emb: Optional[torch.Tensor],
               cf_cond_emb: Optional[torch.Tensor], batch_size: int, *,
               generator: torch.Generator, mode: str = "auto",
               sample: bool = True, filter_ratio: float = 0.0,
               content_token: Optional[torch.Tensor] = None,
               weights_dtype: torch.dtype = torch.bfloat16,
               draws: Optional[d3pm.Draws] = None) -> torch.Tensor:
        """(B, L) int64 tokens from the 100-step reverse process.

        mode 'model': :func:`..ops.sampler_kernel.sample_tokens`, the
        denoiser (attention kernel K2 on CUDA tensors) then the fused
        sampler step (K1) per reverse step. mode 'megakernel':
        :func:`..ops.megakernel.megakernel_sample_tokens`, one whole-step
        kernel launch (K3 or K4) per reverse step, the packed matrices in
        ``weights_dtype``. mode 'reference': :func:`.d3pm.sample`, the
        log-onehot carry over the denoiser, from ``filter_ratio`` of the
        way in (the noised ``content_token`` then starts it). mode 'auto':
        'reference' when ``filter_ratio`` is set, else
        :func:`resolve_sampler`. On CPU tensors every route runs its plain
        version (:func:`.d3pm.sample_fused` is the oracle the tests hold
        them to). ``sample=False`` takes argmax in place of Gumbel-max.
        ``generator`` is a CPU generator (the per-step seeds); the
        'reference' route takes its uniforms from ``draws`` when given."""
        if mode == "auto" and filter_ratio != 0.0:
            mode = "reference"
        mode = resolve_sampler(mode, self.lt_history.device,
                               self.content_seq_len, self.transformer,
                               cond_emb is not None)
        if mode not in ("model", "megakernel", "reference"):
            raise ValueError(f"unknown sampler mode {mode!r}")
        if filter_ratio != 0.0 and mode != "reference":
            raise ValueError(f"filter_ratio needs the 'reference' route, "
                             f"not {mode!r}")
        if self.learnable_cf and cond_emb is not None:
            # the trained empty-text embedding is the CF branch's input
            cf_cond_emb = self.empty_cond_embed(cond_emb.shape[0],
                                                cond_emb.shape[1])
        if mode == "reference":
            return d3pm.sample(
                generator, self.schedule(), self.transformer, cond_emb,
                cf_cond_emb, batch_size, self.content_seq_len,
                guidance_scale=self.guidance_scale,
                filter_ratio=filter_ratio, content_token=content_token,
                sample=sample, draws=draws)
        if mode == "megakernel":
            return megakernel_sample_tokens(
                generator, self.schedule(), self.transformer, cond_emb,
                cf_cond_emb, batch_size, self.content_seq_len,
                guidance_scale=self.guidance_scale,
                weights_dtype=weights_dtype, sample=sample)
        return sample_tokens(generator, self.schedule(), self.transformer,
                             cond_emb, cf_cond_emb, batch_size,
                             self.content_seq_len,
                             guidance_scale=self.guidance_scale,
                             sample=sample)

    @torch.no_grad()
    def sample_fast(self, cond_emb: Optional[torch.Tensor],
                    cf_cond_emb: Optional[torch.Tensor], batch_size: int,
                    skip_step: int = 1, *, generator: torch.Generator,
                    sample: bool = True,
                    draws: Optional[d3pm.Draws] = None) -> torch.Tensor:
        """(B, L) int64 tokens from the strided reverse process
        (:func:`.d3pm.sample_fast`: every ``skip_step + 1``-th step, the
        posterior taken ``skip_step`` steps down). As the JAX package's,
        it takes ``cf_cond_emb`` as given, also under ``learnable_cf``."""
        return d3pm.sample_fast(
            generator, self.schedule(), self.transformer, cond_emb,
            cf_cond_emb, batch_size, self.content_seq_len,
            guidance_scale=self.guidance_scale, skip_step=skip_step,
            sample=sample, draws=draws)


class DiscreteDiffusionModel(nn.Module):
    """Conditioner + D3PM."""

    def __init__(self, d3pm_cfg: Mapping[str, Any],
                 conditioner_cfg: Mapping[str, Any] | None = None):
        super().__init__()
        self.d3pm_cfg = dict(d3pm_cfg)
        self.conditioner = build_conditioner(conditioner_cfg)
        self.diffusion = D3PM(**self.d3pm_cfg)

    def forward(self, batch: Mapping[str, Any], content_token: torch.Tensor,
                *, generator: Optional[torch.Generator] = None,
                train: bool = True, **draws) -> dict:
        """Conditioner -> :meth:`D3PM.forward` (the training loss); ``draws``
        (``t``, ``pt``, ``noise``) pass through. The classifier-free
        embedding is not computed: the loss does not read it (XLA drops it
        from the JAX step too)."""
        cond_emb, _ = self.conditioner(batch, content_token.shape[0],
                                       with_cf=False)
        return self.diffusion(content_token, cond_emb, generator=generator,
                              train=train,
                              empty_mask=batch.get("empty_text_mask"),
                              **draws)

    def conditioner_embeddings(self, batch: Mapping[str, Any],
                               batch_size: int):
        """(cond, cf_cond) with the learnable-CF override applied: the entry
        point for external samplers."""
        cond_emb, cf_cond_emb = self.conditioner(batch, batch_size)
        if self.diffusion.learnable_cf and cond_emb is not None:
            cf_cond_emb = self.diffusion.empty_cond_embed(cond_emb.shape[0],
                                                          cond_emb.shape[1])
        return cond_emb, cf_cond_emb

    @torch.no_grad()
    def sample(self, batch: Mapping[str, Any], batch_size: int, *,
               generator: torch.Generator, sample: bool = True,
               mode: str = "auto") -> torch.Tensor:
        """Conditioner -> :meth:`D3PM.sample` on the route ``mode``."""
        cond_emb, cf_cond_emb = self.conditioner_embeddings(batch,
                                                            batch_size)
        return self.diffusion.sample(cond_emb, cf_cond_emb, batch_size,
                                     generator=generator, sample=sample,
                                     mode=mode)

    @torch.no_grad()
    def sample_fast(self, batch: Mapping[str, Any], batch_size: int,
                    skip_step: int = 1, *, generator: torch.Generator,
                    sample: bool = True) -> torch.Tensor:
        """Conditioner -> :meth:`D3PM.sample_fast`."""
        cond_emb, cf_cond_emb = self.conditioner(batch, batch_size)
        return self.diffusion.sample_fast(cond_emb, cf_cond_emb, batch_size,
                                          skip_step, generator=generator,
                                          sample=sample)


def make_discrete_diffusion(model_cfg: Mapping[str, Any], num_embed: int,
                            latent_shape: Sequence[int]
                            ) -> DiscreteDiffusionModel:
    """Build from a plain nested dict mirroring the JAX package's YAML
    (``generator.diffusion_model.transformer[.dalle]`` and
    ``generator.textencoder``)."""
    g = dict(model_cfg.get("generator", {}))
    dcfg = dict(g.get("diffusion_model", {}))
    tcfg = dict(dcfg.pop("transformer", {}))
    dalle = dict(tcfg.pop("dalle", {}))
    t, h, w = latent_shape
    seq_len = int(tcfg.get("content_seq_len") or np.prod(latent_shape))
    spatial = (tcfg.get("content_spatial_size")
               or dalle.get("spatial_size") or [h * t, w])
    d3pm_cfg = dict(
        num_embed=int(dalle.get("num_embed") or num_embed),
        content_seq_len=seq_len,
        spatial_size=tuple(spatial),
        diffusion_step=int(dcfg.get("diffusion_step", 100)),
        auxiliary_loss_weight=float(dcfg.get("auxiliary_loss_weight", 5e-4)),
        adaptive_auxiliary_loss=bool(
            dcfg.get("adaptive_auxiliary_loss", True)),
        mask_weight=tuple(dcfg.get("mask_weight", (1.0, 1.0))),
        guidance_scale=float(dcfg.get("guidance_scale", 2.0)),
        learnable_cf=bool(dcfg.get("learnable_cf", False)),
        n_layer=int(tcfg.get("n_layer", 19)),
        n_embd=int(tcfg.get("n_embd", 64)),
        n_head=int(tcfg.get("n_head", 16)),
        condition_seq_len=int(tcfg.get("condition_seq_len", 77)),
        condition_dim=int(tcfg.get("condition_dim", 512)),
        mlp_hidden_times=int(tcfg.get("mlp_hidden_times", 4)),
        block_activate=str(tcfg.get("block_activate", "GELU2")),
        transformer_dtype=compute_dtype(tcfg.get("dtype", "float32")),
        attn_pdrop=float(tcfg.get("attn_pdrop", 0.0)),
        resid_pdrop=float(tcfg.get("resid_pdrop", 0.0)),
        checkpoint=bool(tcfg.get("checkpoint", False)),
    )
    return DiscreteDiffusionModel(d3pm_cfg=d3pm_cfg,
                                  conditioner_cfg=g.get("textencoder"))


@torch.no_grad()
def init_discrete_diffusion_(model: DiscreteDiffusionModel,
                             generator: torch.Generator) -> None:
    """The JAX package's init laws (see :func:`.denoiser.init_denoiser_`,
    :func:`.conditioning.init_conditioner_`), N(0, 1) for the learnable CF
    embedding, and zero Lt and telemetry buffers."""
    init_conditioner_(model.conditioner, generator)
    init_denoiser_(model.diffusion.transformer, generator)
    diffusion = model.diffusion
    for buf in (diffusion.lt_history, diffusion.lt_count,
                diffusion.diffusion_acc, diffusion.diffusion_keep):
        buf.zero_()
    if diffusion.learnable_cf:
        diffusion.empty_text_embed.normal_(0.0, 1.0, generator=generator)
