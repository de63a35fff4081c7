"""Generic training loop: epochs, validation, checkpoints, early stopping.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/train/loop.py:
Trainer``, the same control flow step for step: per-epoch loss means
(:class:`..train.metrics.MetricAccumulator`, logged as ``total/val``-style
names), the ``model_checkpoint`` manager saving after every validation and
at the end of :meth:`Trainer.fit` (Orbax's rules: the end's save at the
validation's step does nothing), a second manager monitoring
``Metrics/fvd-val`` when ``callbacks.fid_checkpoint`` is present, early
stopping (a non-finite monitored value stops at once), rendering every
``render_every_n_epochs`` validated epochs (by default 5, stage 2: 10),
``max_steps``, and resume from the run's own checkpoints or another run's.

The device is the config's request: ``trainer.platform`` null (or
``cuda`` / ``gpu``) is the CUDA card, and the trainer raises where there is
none; ``cpu`` is the CPU. There is no fallback from one to the other.
Batches stay numpy on the host until a step: each array goes to the device
through pinned memory without a host synchronisation; captions (``text``)
stay on the host. The steps' values stay on the device and are read once an
epoch, and at every ``log_every_n_steps``-th step.

Randomness: one ``torch.Generator`` on the device for the steps' draws and
one on the CPU for the samplers' per-step seeds, both seeded from ``seed``;
as in the JAX package, a resumed run starts them from ``seed`` again.

Data parallelism (ROADMAP item [16]): inside a process group
(:mod:`..parallel.distributed`; the entries in :mod:`..tasks` start one
process per rank) the trainer is one replica of the JAX package's
``pjit`` program. ``trainer.mesh.data`` (null: every rank) must be the
group's size, and on the CPU ``trainer.host_device_count`` is the count of
ranks; ``mesh.model > 1`` is ROADMAP item [16b] and raises. Rank 0's
initial state is broadcast to every rank; each rank reads its rows of each
global batch (the datamodule's ``set_mesh``, which every datamodule
must have in a group, slices the sample indices before the clips are
decoded), and a global batch that does not divide over the ranks raises; the steps average their gradients over the ranks
(:func:`..parallel.distributed.average_gradients`) and the model takes
global statistics where the JAX package's global arrays do; the metrics
are averaged over the ranks. Only rank 0 writes checkpoints, logs and
renders; every rank runs the same loop, so every collective has its
partners. Without a group (one device, ``mesh.data`` null) none of this
runs: no collective is launched.

The JAX package's process-wide cache of jitted steps (``shared_jit``,
``shared_module_init``) has no counterpart: eager PyTorch compiles nothing
that a second trainer could share.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from ..parallel.distributed import is_distributed, local_rank
from ..parallel.mesh import Mesh, create_mesh, replicate
from ..train.metrics import MetricAccumulator, loss_log_name
from ..utils.checkpoint import CheckpointManager
from ..utils.logging import MetricLogger, build_metric_loggers, get_logger

log = get_logger(__name__)

__all__ = ["Trainer", "resolve_device", "device_batch", "mesh_ranks"]

_NON_ARRAY_KEYS = ("text",)  # host-side only; never shipped to the device


def resolve_device(platform: str | None) -> torch.device:
    """``trainer.platform`` -> the device: null, ``cuda`` or ``gpu`` is the
    CUDA card (raises without one; in a process group this rank's
    ``cuda:LOCAL_RANK``), ``cpu`` the CPU."""
    name = "cuda" if platform in (None, "cuda", "gpu") else str(platform)
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the "
                "config asks for the CPU (trainer.platform=cpu)")
        if is_distributed():
            return torch.device("cuda", local_rank())
        return torch.device("cuda")
    if name != "cpu":
        raise ValueError(f"trainer.platform={platform!r}: the port runs on "
                         f"'cuda' (the default) or 'cpu'")
    return torch.device("cpu")


def mesh_ranks(trainer_cfg: Mapping[str, Any], device_type: str) -> int:
    """How many ranks a run of ``trainer_cfg`` asks for: ``mesh.data``, or
    with it null every device (on the CPU ``host_device_count``, default 1;
    on CUDA the visible GPUs). ``mesh.model > 1`` raises (ROADMAP item
    [16b]), as do more ranks than devices and ``host_device_count`` on
    CUDA."""
    mesh_cfg = trainer_cfg.get("mesh", {}) or {}
    model = int(mesh_cfg.get("model") or 1)
    if model > 1:
        create_mesh(None, model)            # raises, naming [16b]
    hdc = trainer_cfg.get("host_device_count")
    if device_type == "cpu":
        devices = int(hdc or 1)
    else:
        if hdc is not None and int(hdc) > 1:
            raise ValueError(
                "trainer.host_device_count is the count of CPU ranks "
                "(trainer.platform=cpu); on the card the ranks are the GPUs "
                "(trainer.mesh.data)")
        devices = torch.cuda.device_count()
    data = mesh_cfg.get("data")
    data = devices if data is None else int(data)
    if not 0 < data <= devices:
        raise ValueError(f"trainer.mesh.data={data}: {devices} device(s)")
    return data


def device_batch(batch: Mapping[str, Any], device: torch.device) -> dict:
    """The batch's arrays as tensors on ``device`` (host-to-device copies
    from pinned memory, queued without waiting), host-only keys left out."""
    out = {}
    for k, v in batch.items():
        if k in _NON_ARRAY_KEYS:
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


class Trainer:
    """Base trainer; subclasses implement build / steps / state."""

    def __init__(self, cfg: Mapping[str, Any], datamodule, run_dir: str | Path):
        self.cfg = cfg
        self.datamodule = datamodule
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        tcfg = cfg.get("trainer", {}) or {}
        self.device = resolve_device(tcfg.get("platform"))
        mesh_cfg = tcfg.get("mesh", {}) or {}
        data = mesh_cfg.get("data")
        if data is None and self.device.type == "cpu":
            data = tcfg.get("host_device_count")
        self.mesh: Mesh = create_mesh(data, int(mesh_cfg.get("model") or 1))
        if is_distributed():
            datamodule.set_mesh(self.mesh)
        self.max_epochs = int(tcfg.get("max_epochs", 1))
        self.max_steps = tcfg.get("max_steps")
        self.check_val_every_n_epoch = int(
            tcfg.get("check_val_every_n_epoch", 1))
        self.log_every_n_steps = int(tcfg.get("log_every_n_steps", 50))
        # null = per-stage default: 5 for stage 1, 10 for stage 2
        _rev = tcfg.get("render_every_n_epochs")
        self.render_every_n_epochs = 5 if _rev is None else int(_rev)
        self.seed = int(cfg.get("seed") or 0)

        cb = cfg.get("callbacks", {}) or {}
        ck = cb.get("model_checkpoint", {}) or {}
        self.ckpt = CheckpointManager(
            self.run_dir / "checkpoints",
            monitor=ck.get("monitor", "total/val"),
            mode=ck.get("mode", "min"),
            max_to_keep=int(ck.get("save_top_k", 3)))
        # the best-FVD checkpoints, saved only on epochs where FVD was
        # computed; enabled by the PRESENCE of callbacks.fid_checkpoint (an
        # empty node means the defaults), disabled by absence or null
        fk = cb.get("fid_checkpoint")
        self.fid_ckpt = None
        if fk is not None and "fid_checkpoint" in cb:
            fk = fk or {}
            self.fid_ckpt = CheckpointManager(
                self.run_dir / "checkpoints_fvd",
                monitor=fk.get("monitor", "Metrics/fvd-val"),
                mode=fk.get("mode", "min"),
                max_to_keep=int(fk.get("save_top_k", 1)))
        es = cb.get("early_stopping", {}) or {}
        self.es_monitor = es.get("monitor", "total/val")
        self.es_patience = int(es.get("patience", 5000))
        self.es_mode = es.get("mode", "min")
        self._es_best = np.inf if self.es_mode == "min" else -np.inf
        self._es_bad_epochs = 0

        self.loggers: list[MetricLogger] = build_metric_loggers(
            cfg.get("logger"), self.run_dir)
        self.state = None  # set by subclass build()
        self.global_step = 0
        self.current_epoch = 0
        self._rng = torch.Generator(device=self.device).manual_seed(self.seed)
        self._host_rng = torch.Generator().manual_seed(self.seed)

    # ---- subclass API ----------------------------------------------------
    def build(self, example_batch: Mapping[str, Any]) -> None:
        raise NotImplementedError

    def train_step(self, state, batch, rng):
        """-> (state, {loss_name: 0-d tensor})"""
        raise NotImplementedError

    def eval_step(self, state, batch, rng):
        """-> {loss_name: 0-d tensor}"""
        raise NotImplementedError

    def loss_names(self) -> list[str]:
        raise NotImplementedError

    def state_dict(self) -> dict:
        """What a checkpoint holds: ``step`` and the state's tensors."""
        return self.state

    def _replicate(self) -> None:
        """Every tensor of the state (the modules' parameters and buffers,
        the optimizer's moments) set to rank 0's."""
        if not is_distributed():
            return
        tensors = []

        def walk(x):
            if isinstance(x, torch.Tensor):
                tensors.append(x)
            elif isinstance(x, Mapping):
                for v in x.values():
                    walk(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)
        walk(self.state_dict())
        replicate(tensors)

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.state = state

    def render_samples(self, epoch: int) -> None:
        pass

    def extra_eval_metrics(self, split: str, epoch: int) -> dict[str, float]:
        """e.g. FVD every N epochs (stage-specific)."""
        return {}

    # ---- loop ------------------------------------------------------------
    def next_rng(self) -> torch.Generator:
        """The generator of the steps' draws (on the trainer's device)."""
        return self._rng

    def next_sample_rng(self) -> torch.Generator:
        """The CPU generator the samplers draw their per-step seeds from."""
        return self._host_rng

    def _log(self, metrics: Mapping[str, float], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def _restore(self, mgr: CheckpointManager) -> None:
        self.load_state_dict(mgr.restore(self.state_dict()))

    def fit(self, resume: bool = False,
            restore_from: str | None = None) -> dict[str, float]:
        example = next(iter(self.datamodule.train_batches(0)))
        self.build(example)
        self._replicate()
        restored = False
        if restore_from:
            # resume from another run's checkpoints (train ckpt_path=...)
            mgr = CheckpointManager(restore_from, monitor=None)
            self._restore(mgr)
            mgr.close()
            restored = True
        elif resume and self.ckpt.latest_step() is not None:
            self._restore(self.ckpt)
            restored = True
        if restored:
            self.global_step = int(self.state_dict()["step"])
            steps_per_epoch = max(self.datamodule.steps_per_epoch(), 1)
            self.current_epoch = self.global_step // steps_per_epoch
            log.info("resumed from step %d (epoch %d)", self.global_step,
                     self.current_epoch)

        final_metrics: dict[str, float] = {}
        start_epoch = self.current_epoch
        for epoch in range(start_epoch, self.max_epochs):
            self.current_epoch = epoch
            t0 = time.time()
            train_metrics = self._run_epoch("train", epoch)
            final_metrics.update(train_metrics)

            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                val_metrics = self._run_epoch("val", epoch)
                extra = self.extra_eval_metrics("val", epoch)
                if extra:
                    val_metrics.update(extra)
                    self._log(extra, self.global_step)
                final_metrics.update(val_metrics)
                self.ckpt.save(self.global_step, self.state_dict(),
                               val_metrics)
                if (self.fid_ckpt is not None
                        and self.fid_ckpt.monitor in val_metrics):
                    self.fid_ckpt.save(self.global_step, self.state_dict(),
                                       val_metrics)
                if self._early_stop(val_metrics):
                    log.info("early stopping at epoch %d", epoch)
                    break
                if (epoch % max(self.render_every_n_epochs, 1)) == 0:
                    self.render_samples(epoch)

            log.info("epoch %d done in %.1fs step=%d", epoch,
                     time.time() - t0, self.global_step)
            if self.max_steps and self.global_step >= int(self.max_steps):
                break

        self.ckpt.save(self.global_step, self.state_dict(), final_metrics)
        for lg in self.loggers:
            lg.finalize()
        return final_metrics

    def test(self) -> dict[str, float]:
        if self.state is None:
            example = next(iter(self.datamodule.test_batches(0)))
            self.build(example)
            self._replicate()
            if self.ckpt.latest_step() is not None:
                self._restore(self.ckpt)
        metrics = self._run_epoch("test", self.current_epoch)
        metrics.update(self.extra_eval_metrics("test", self.current_epoch))
        self._log(metrics, self.global_step)
        return metrics

    def _batches(self, split: str, epoch: int) -> Iterator:
        fn = {"train": self.datamodule.train_batches,
              "val": self.datamodule.val_batches,
              "test": self.datamodule.test_batches}[split]
        return fn(epoch)

    def _run_epoch(self, split: str, epoch: int) -> dict[str, float]:
        acc = MetricAccumulator(self.loss_names())
        train = split == "train"
        saw_batch = False
        for batch in self._batches(split, epoch):
            saw_batch = True
            db = device_batch(batch, self.device)
            rng = self.next_rng()
            if train:
                self.state, values = self.train_step(self.state, db, rng)
                self.global_step += 1
                if self.global_step % self.log_every_n_steps == 0:
                    # one host read (and, in a group, one all-reduce)
                    means = MetricAccumulator(values).update(values)
                    self._log({f"{k}/step": v
                               for k, v in means.compute().items()},
                              self.global_step)
                if self.max_steps and self.global_step >= int(self.max_steps):
                    acc = acc.update(values)
                    break
            else:
                values = self.eval_step(self.state, db, rng)
            acc = acc.update(values)
        if not saw_batch:
            # a dataset smaller than the batch yields zero batches: all-zero
            # metrics would look like a perfect run (and feed the monitors)
            log.warning(
                "%s epoch %d saw ZERO batches (dataset smaller than "
                "batch_size?); its metrics are meaningless", split, epoch)
        means = acc.compute()
        out = {loss_log_name(k, split): float(v) for k, v in means.items()}
        out["epoch"] = float(epoch)
        self._log(out, self.global_step)
        return out

    def _early_stop(self, metrics: Mapping[str, float]) -> bool:
        if self.es_monitor not in metrics:
            return False
        val = metrics[self.es_monitor]
        if not np.isfinite(val):
            log.error("monitored metric %s is %s; stopping",
                      self.es_monitor, val)
            return True
        better = val < self._es_best if self.es_mode == "min" \
            else val > self._es_best
        if better:
            self._es_best = val
            self._es_bad_epochs = 0
        else:
            self._es_bad_epochs += 1
        return self._es_bad_epochs > self.es_patience

