"""Process-0 logging and the experiment loggers (CSV, TensorBoard, W&B,
MLflow, Neptune, Comet).

Port of ``gif_synthesis_with_discrete_diffusion_tpu/utils/logging.py``:
:func:`get_logger` emits only on process 0 (the rank of the initialised
``torch.distributed`` group, else 0), and scalar metrics fan out to the
backends a config's ``logger`` node names. :class:`CsvLogger` writes the
JAX package's file byte for byte. The other backends import their package
when they are built and raise :class:`ImportError` naming it where it is
absent (the JAX package warns and logs nothing instead); ``logger=csv``
needs nothing beyond the standard library.
"""
from __future__ import annotations

import csv
import logging
import sys
import time
from pathlib import Path
from typing import Any, Mapping

__all__ = ["get_logger", "MetricLogger", "CsvLogger", "TensorBoardLogger",
           "WandbLogger", "MlflowLogger", "NeptuneLogger", "CometLogger",
           "build_metric_loggers"]


def _is_main_process() -> bool:
    from ..parallel.distributed import is_main_process
    return is_main_process()


class _Process0Filter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        return _is_main_process()


def get_logger(name: str = __name__) -> logging.Logger:
    """A logger that only emits on process 0."""
    logger = logging.getLogger(name)
    if not any(isinstance(f, _Process0Filter) for f in logger.filters):
        logger.addFilter(_Process0Filter())
    if not logging.getLogger().handlers and not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s][%(name)s][%(levelname)s] - %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


class MetricLogger:
    """Base class: scalar metric sink."""

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        raise NotImplementedError

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        pass

    def finalize(self) -> None:
        pass


class CsvLogger(MetricLogger):
    """Append-only CSV metrics file: one row per call, the header and the
    earlier rows rewritten only when a new metric key appears."""

    def __init__(self, save_dir: str | Path, name: str = "metrics.csv"):
        self.path = Path(save_dir) / name
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fields: list[str] = ["step", "time"]
        self._rows: list[dict] = []
        self._written = 0   # rows already on disk under the current header

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        if not _is_main_process():
            return
        row = {"step": step, "time": time.time()}
        grew = False
        for k, v in metrics.items():
            row[k] = float(v)
            if k not in self._fields:
                self._fields.append(k)
                grew = True
        self._rows.append(row)
        if grew or self._written == 0:
            self._rewrite()
        else:
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fields).writerow(row)
        self._written = len(self._rows)

    def _rewrite(self) -> None:
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields)
            w.writeheader()
            w.writerows(self._rows)


def _require(module: str, backend: str):
    """Import ``module`` for the ``backend`` logger, or raise naming it."""
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"logger '{backend}' needs the '{module.split('.')[0]}' package, "
            f"which is not installed; use logger=csv") from e


class TensorBoardLogger(MetricLogger):
    """TensorBoard event files, through ``torch.utils.tensorboard``."""

    def __init__(self, save_dir: str | Path):
        self._writer = None
        if not _is_main_process():
            return
        _require("tensorboard", "tensorboard")
        tb = _require("torch.utils.tensorboard", "tensorboard")
        self._writer = tb.SummaryWriter(log_dir=str(save_dir))

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        if self._writer is None:
            return
        for k, v in metrics.items():
            self._writer.add_scalar(k, float(v), step)

    def finalize(self) -> None:
        if self._writer is not None:
            self._writer.close()


class WandbLogger(MetricLogger):
    """Weights & Biases."""

    def __init__(self, project: str, save_dir: str | Path, **kwargs: Any):
        self._run = None
        if not _is_main_process():
            return
        wandb = _require("wandb", "wandb")
        self._run = wandb.init(project=project, dir=str(save_dir), **kwargs)

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        if self._run is not None:
            self._run.log(dict(metrics), step=step)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        if self._run is not None:
            self._run.config.update(dict(params), allow_val_change=True)

    def finalize(self) -> None:
        if self._run is not None:
            self._run.finish()


class MlflowLogger(MetricLogger):
    """MLflow, by default into ``file:<run_dir>/mlruns``."""

    def __init__(self, save_dir: str | Path, tracking_uri: str | None = None,
                 experiment_name: str = "gsdd-tpu", run_name: str | None = None):
        self._mlflow = None
        if not _is_main_process():
            return
        mlflow = _require("mlflow", "mlflow")
        mlflow.set_tracking_uri(
            tracking_uri or f"file:{Path(save_dir) / 'mlruns'}")
        mlflow.set_experiment(experiment_name)
        self._run = mlflow.start_run(run_name=run_name)
        self._mlflow = mlflow

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        if self._mlflow is not None:
            self._mlflow.log_metrics(
                {k: float(v) for k, v in metrics.items()}, step=step)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        if self._mlflow is not None:
            self._mlflow.log_params(dict(params))

    def finalize(self) -> None:
        if self._mlflow is not None:
            self._mlflow.end_run()


class NeptuneLogger(MetricLogger):
    """Neptune; the API key from ``NEPTUNE_API_TOKEN``."""

    def __init__(self, project: str | None = None, **kwargs: Any):
        self._run = None
        if not _is_main_process():
            return
        neptune = _require("neptune", "neptune")
        self._run = neptune.init_run(project=project, **kwargs)

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        if self._run is not None:
            for k, v in metrics.items():
                self._run[k].append(float(v), step=step)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        if self._run is not None:
            self._run["parameters"] = dict(params)

    def finalize(self) -> None:
        if self._run is not None:
            self._run.stop()


class CometLogger(MetricLogger):
    """Comet; the API key from ``COMET_API_TOKEN``."""

    def __init__(self, save_dir: str | Path,
                 project_name: str = "gsdd-tpu", offline: bool = False,
                 **kwargs: Any):
        self._exp = None
        if not _is_main_process():
            return
        comet_ml = _require("comet_ml", "comet")
        cls = comet_ml.OfflineExperiment if offline else comet_ml.Experiment
        extra = {"offline_directory": str(save_dir)} if offline else {}
        self._exp = cls(project_name=project_name, **extra, **kwargs)

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        if self._exp is not None:
            self._exp.log_metrics(
                {k: float(v) for k, v in metrics.items()}, step=step)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        if self._exp is not None:
            self._exp.log_parameters(dict(params))

    def finalize(self) -> None:
        if self._exp is not None:
            self._exp.end()


_BACKENDS = {
    "csv": lambda run_dir, cfg: CsvLogger(run_dir),
    "tensorboard": lambda run_dir, cfg: TensorBoardLogger(Path(run_dir) / "tb"),
    "wandb": lambda run_dir, cfg: WandbLogger(
        cfg.get("project", "gsdd-tpu"), run_dir),
    "mlflow": lambda run_dir, cfg: MlflowLogger(
        run_dir, tracking_uri=cfg.get("tracking_uri"),
        experiment_name=cfg.get("experiment_name", "gsdd-tpu"),
        run_name=cfg.get("run_name")),
    "neptune": lambda run_dir, cfg: NeptuneLogger(
        project=cfg.get("project")),
    "comet": lambda run_dir, cfg: CometLogger(
        run_dir, project_name=cfg.get("project_name", "gsdd-tpu"),
        offline=bool(cfg.get("offline", False))),
}


def build_metric_loggers(cfg: Mapping[str, Any] | None,
                         run_dir: str | Path) -> list[MetricLogger]:
    """Build loggers from a config node like ``{csv: {}, tensorboard: {}}``."""
    loggers: list[MetricLogger] = []
    for name, sub in (cfg or {}).items():
        if name in _BACKENDS and (sub is None or sub.get("enabled", True)):
            loggers.append(_BACKENDS[name](run_dir, sub or {}))
    return loggers
