"""Task layer: config -> datamodule / trainer -> fit / test, and the entry.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/tasks.py``: seed,
build everything from the composed config, run, return the metrics. A run
directory is stamped to the second under ``paths.output_dir`` (with
``exist_ok``: two runs in the same second share it), and holds the
composed config (``config_tree.log``), the wall time (``exec_time.log``)
and, after a failure, the traceback (``exception.log``).

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.tasks train \\
        model=videogpt_vq_vae datamodule=synthetic logger=csv
    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.tasks eval \\
        model=discrete_diffusion ckpt_path=<run>/checkpoints

compose ``train`` or ``eval`` from the JAX package's config tree with the
given overrides, as ``scripts/train.py`` / ``scripts/eval.py`` do, and
print the metrics one per line. The run is on the CUDA card unless the
config says ``trainer.platform=cpu``.

More than one device (ROADMAP items [16], [16b]): with
``trainer.mesh.data`` x ``trainer.mesh.model`` above 1, or ``data`` null
with more than one visible GPU, :func:`train` and :func:`evaluate` start
one process per rank themselves
(:func:`..parallel.distributed.run_ranks`, NCCL on the GPUs) and return
rank 0's metrics; on the CPU ``trainer.platform=cpu
trainer.host_device_count=N`` starts N gloo processes, the counterpart of
the JAX package's N virtual CPU devices. Under ``torchrun
--nproc_per_node=N -m ..._torch.tasks train ...`` each process joins the
group ``torchrun`` describes. Rank 0 makes the run directory and writes
``config_tree.log`` and the logs; the other ranks use its directory. With
``mesh.data`` null on one GPU nothing of this runs.

Counterparts of the JAX package's debug switches: ``debug_nans`` turns on
``torch.autograd.set_detect_anomaly`` (the nearest torch check for a NaN
made in a step), and ``profiler`` records a ``torch.profiler`` trace of the
run into ``<run dir>/torch_trace.json`` (the JAX package writes a
``jax.profiler`` trace there).
"""
from __future__ import annotations

import datetime
import functools
import random
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .parallel.distributed import (broadcast_object, initialize_distributed,
                                   is_distributed, is_main_process, rank,
                                   run_ranks, world_size)
from .train.loop import mesh_ranks, resolve_device
from .utils.config import compose, to_yaml
from .utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["train", "evaluate", "build_datamodule", "build_trainer",
           "make_run_dir", "run_on_ranks", "main"]


def build_datamodule(cfg: Mapping[str, Any]):
    d = dict(cfg.get("datamodule", {}))
    name = d.get("dataname", "synthetic")
    if name == "synthetic":
        from .data.synthetic import SyntheticVideoDataModule
        return SyntheticVideoDataModule(
            batch_size=int(d.get("batch_size", 4)),
            sequence_length=int(d.get("sequence_length", 4)),
            resolution=int(d.get("resolution", 64)),
            num_train=int(d.get("num_train", 64)),
            num_val=int(d.get("num_val", 16)),
            num_test=int(d.get("num_test", 16)),
            seed=int(cfg.get("seed") or 0))
    if name in ("ucf101", "msrvtt"):
        from .data.prefetch import PrefetchingDataModule
        from .data.video_dataset import MSRVTTDataModule, UCF101DataModule
        cls = UCF101DataModule if name == "ucf101" else MSRVTTDataModule
        # the ResNet-50 frame features run where the trainer runs
        platform = (cfg.get("trainer", {}) or {}).get("platform")
        dm = cls(**{**d, "batch_size": int(d.get("batch_size", 32)),
                    "platform": platform})
        workers = int(d.get("num_workers", 0))
        return PrefetchingDataModule(dm, workers) if workers > 0 else dm
    raise ValueError(f"unknown datamodule {name!r}")


def _build_fvd_evaluator(cfg: Mapping[str, Any], device: torch.device):
    from .eval.evaluator import FVDEvaluator
    eval_ckpt = cfg.get("eval_ckpt")
    if eval_ckpt and Path(str(eval_ckpt)).exists():
        from .convert.torch_i3d import convert_i3d_file
        log.info("FVDEvaluator: I3D weights from %s", eval_ckpt)
        return FVDEvaluator(i3d_state=convert_i3d_file(str(eval_ckpt)),
                            device=device)
    log.warning("FVDEvaluator: no pretrained I3D; random init (relative "
                "FVD only)")
    return FVDEvaluator(generator=torch.Generator().manual_seed(0),
                        device=device)


def build_trainer(cfg: Mapping[str, Any], datamodule, run_dir):
    stage = int(cfg.get("model", {}).get("stage", 1))
    if stage == 1:
        from .train.stage1 import Stage1Trainer
        trainer = Stage1Trainer(cfg, datamodule, run_dir)
    else:
        from .train.stage2 import Stage2Trainer
        trainer = Stage2Trainer(cfg, datamodule, run_dir)
    if cfg.get("model", {}).get("do_evaluation", False):
        trainer.evaluator = _build_fvd_evaluator(cfg, trainer.device)
    return trainer


def make_run_dir(cfg: Mapping[str, Any]) -> Path:
    base = cfg.get("paths", {}).get("output_dir", "logs/runs")
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_dir = Path(base) / stamp
    run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir


def _start_profiler(run_dir: Path, device: torch.device) -> None:
    """``profiler: true`` -> a torch.profiler trace of the whole run,
    written to ``torch_trace.json`` when the process exits."""
    import atexit
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()

    def stop():
        prof.stop()
        prof.export_chrome_trace(str(run_dir / "torch_trace.json"))
    atexit.register(stop)


def _setup(cfg: Mapping[str, Any]) -> Path:
    trainer_cfg = cfg.get("trainer", {}) or {}
    device = resolve_device(trainer_cfg.get("platform"))
    seed = cfg.get("seed")
    if seed is not None:
        random.seed(int(seed))
        np.random.seed(int(seed))
        torch.manual_seed(int(seed))
    if cfg.get("debug_nans"):
        torch.autograd.set_detect_anomaly(True)
    main = is_main_process()
    run_dir = Path(broadcast_object(str(make_run_dir(cfg)) if main
                                    else None))
    if cfg.get("profiler") and main:
        _start_profiler(run_dir, device)
    if main:
        (run_dir / "config_tree.log").write_text(to_yaml(cfg))
    if cfg.get("extras", {}).get("print_config", False):
        log.info("config:\n%s", to_yaml(cfg))
    return run_dir


def task_wrapper(task_fn):
    """Writes the traceback of a failure to ``exception.log`` (and raises
    it again) and the wall time to ``exec_time.log`` in the run dir (rank
    r > 0 of a group: ``exception_rank<r>.log`` only)."""

    @functools.wraps(task_fn)
    def wrap(cfg, run_dir, *args, **kwargs):
        t0 = time.time()
        try:
            return task_fn(cfg, run_dir, *args, **kwargs)
        except Exception:
            name = ("exception.log" if is_main_process()
                    else f"exception_rank{rank()}.log")
            (Path(run_dir) / name).write_text(traceback.format_exc())
            raise
        finally:
            if is_main_process():
                (Path(run_dir) / "exec_time.log").write_text(
                    f"'{cfg.get('task_name', 'task')}' execution time: "
                    f"{time.time() - t0:.2f} (s)\n")
    return wrap


@task_wrapper
def _train_impl(cfg, run_dir) -> dict[str, float]:
    dm = build_datamodule(cfg)
    trainer = build_trainer(cfg, dm, run_dir)
    metrics: dict[str, float] = {}
    if cfg.get("train", True):
        metrics = trainer.fit(
            resume=bool(cfg.get("resume")),
            restore_from=(str(cfg["ckpt_path"])
                          if cfg.get("ckpt_path") else None))
    if cfg.get("test", False):
        metrics.update(trainer.test())
    return metrics


@task_wrapper
def _evaluate_impl(cfg, run_dir) -> dict[str, float]:
    from .utils.checkpoint import CheckpointManager
    dm = build_datamodule(cfg)
    trainer = build_trainer(cfg, dm, run_dir)
    if cfg.get("ckpt_path"):
        trainer.ckpt.close()
        trainer.ckpt = CheckpointManager(
            Path(str(cfg["ckpt_path"])), monitor=trainer.ckpt.monitor,
            mode=trainer.ckpt.mode)
    return trainer.test()


def run_on_ranks(fn, cfg: Mapping[str, Any], *args):
    """``fn(cfg, *args)`` on the ranks ``cfg`` asks for: in this process
    inside a process group (or one that ``torchrun``'s environment
    describes) and for one rank, else in one new process per rank
    (rank 0's result returned)."""
    tcfg = cfg.get("trainer", {}) or {}
    device = resolve_device(tcfg.get("platform"))
    if not is_distributed():
        if initialize_distributed(device.type):
            import torch.distributed as dist
            log.info("joined the process group of the environment: backend "
                     "%s, %d rank(s)", dist.get_backend(), world_size())
        else:
            n = mesh_ranks(tcfg, device.type)
            if n > 1:
                return run_ranks(fn, n, device.type, dict(cfg), *args)
    return fn(cfg, *args)


def _train(cfg: Mapping[str, Any]) -> dict[str, float]:
    run_dir = _setup(cfg)
    metrics = _train_impl(cfg, run_dir)
    log.info("run dir: %s", run_dir)
    return metrics


def _evaluate(cfg: Mapping[str, Any]) -> dict[str, float]:
    run_dir = _setup(cfg)
    metrics = _evaluate_impl(cfg, run_dir)
    log.info("run dir: %s", run_dir)
    return metrics


def train(cfg: Mapping[str, Any]) -> dict[str, float]:
    """Fit (and with ``test: true`` test) the configured stage on every rank
    the config asks for; returns rank 0's metrics."""
    return run_on_ranks(_train, cfg)


def evaluate(cfg: Mapping[str, Any]) -> dict[str, float]:
    """Test the configured stage from ``ckpt_path`` on every rank the config
    asks for; returns rank 0's metrics."""
    return run_on_ranks(_evaluate, cfg)


def main(argv: list[str] | None = None) -> int:
    """``train|eval <overrides>``: compose, run, print the metrics."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("train", "eval"):
        print("usage: python -m gif_synthesis_with_discrete_diffusion_tpu_"
              "torch.tasks train|eval [overrides ...]", file=sys.stderr)
        return 2
    task, overrides = argv[0], argv[1:]
    cfg = compose(task, overrides)
    metrics = (train if task == "train" else evaluate)(cfg)
    if is_main_process():
        for k, v in sorted(metrics.items()):
            print(f"{k}: {v:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
