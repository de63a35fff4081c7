"""Checkpoints on ``torch.save``: the best by a monitored metric, and resume.

The counterpart of ``gif_synthesis_with_discrete_diffusion_tpu/utils/
checkpoint.py`` (Orbax), with Orbax's retention rules kept as they are:

* a step per subdirectory, ``<directory>/<step>/``, holding ``state.pt``
  (the trainer's state: module and optimizer ``state_dict``s and ``step``)
  and ``metrics.json``; a save writes a temporary directory and renames it;
* a save of a step not above the newest kept step does nothing (Orbax's
  ``should_save``), so the trainer's last save at the step its validation
  already saved keeps the validation-time state;
* with a ``monitor`` the ``max_to_keep`` best steps by the metric stay (a
  save without the metric ranks as the worst value); the ranking is
  Python's stable sort of the kept steps in step order, reversed for
  ``min``, of which the last ``max_to_keep`` stay, so among equal metrics
  the newer steps win; without a monitor the newest ``max_to_keep`` stay;
* ``latest_step`` is the newest step kept, ``best_step`` the last of that
  ranking (without a monitor, the newest).

:meth:`CheckpointManager.restore` loads a step and puts each tensor on the
device of the tensor at the same place in a template, as Orbax restores
onto a template's shardings.

In a data-parallel run every rank keeps the same list of steps, but only
rank 0 writes and deletes; a save that writes ends at a barrier, so every
rank can read the step once it returns (and every rank restores).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Mapping

import torch

from ..parallel.distributed import barrier, is_main_process
from .logging import get_logger

__all__ = ["CheckpointManager"]

log = get_logger(__name__)

_STATE = "state.pt"
_METRICS = "metrics.json"


def _onto(loaded: Any, template: Any, where: str = "state") -> Any:
    """``loaded`` with every tensor on the device of ``template``'s tensor
    at the same place (every key of the template must be there, each
    tensor of its shape)."""
    if isinstance(template, torch.Tensor):
        if not isinstance(loaded, torch.Tensor):
            raise ValueError(f"checkpoint holds no tensor at {where}")
        if loaded.shape != template.shape:
            raise ValueError(f"checkpoint shape {tuple(loaded.shape)} at "
                             f"{where}, the template's "
                             f"{tuple(template.shape)}")
        return loaded.to(template.device)
    if isinstance(template, Mapping):
        missing = set(template) - set(loaded if isinstance(loaded, Mapping)
                                      else ())
        if not isinstance(loaded, Mapping) or missing:
            raise ValueError(f"checkpoint lacks {sorted(map(str, missing))} "
                             f"at {where}")
        # entries the template lacks (an optimizer's state before its first
        # step) stay on the CPU: their owner's load_state_dict places them
        return type(loaded)((k, _onto(v, template[k], f"{where}.{k}")
                             if k in template else v)
                            for k, v in loaded.items())
    if isinstance(template, (list, tuple)):
        return type(loaded)(_onto(a, b, f"{where}[{i}]")
                            for i, (a, b) in enumerate(zip(loaded, template)))
    return loaded


class CheckpointManager:
    """Keeps ``max_to_keep`` checkpoints under ``directory`` by Orbax's
    rules (module docstring)."""

    def __init__(self, directory: str | Path, monitor: str | None = None,
                 mode: str = "min", max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        assert mode in ("min", "max")
        self.max_to_keep = max_to_keep
        # (step, metrics or None) in step order, read from the directory
        self._steps: list[tuple[int, dict | None]] = []
        for p in sorted((p for p in self.directory.iterdir()
                         if p.is_dir() and p.name.isdigit()
                         and (p / _STATE).exists()),
                        key=lambda p: int(p.name)):
            metrics = None
            if (p / _METRICS).exists():
                metrics = json.loads((p / _METRICS).read_text())
            self._steps.append((int(p.name), metrics))

    def _metric_key(self) -> str:
        return self.monitor.replace("/", "_") if self.monitor else ""

    def _best_fn(self, metrics: Mapping[str, float]) -> float:
        return metrics.get(self._metric_key(), 0.0)

    def _ranked(self) -> list[tuple[int, dict | None]]:
        """Kept steps with metrics, worst first (Orbax's BestN order)."""
        return sorted((s for s in self._steps if s[1] is not None),
                      key=lambda s: self._best_fn(s[1]),
                      reverse=(self.mode == "min"))

    def save(self, step: int, state: Any,
             metrics: Mapping[str, float] | None = None) -> bool:
        """Write ``state`` as ``step`` unless a kept step is at or above it;
        then drop the checkpoints the retention rules do not keep. Returns
        whether it wrote."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        m = None
        if self.monitor and metrics and self.monitor in metrics:
            m = {self._metric_key(): float(metrics[self.monitor])}
        elif self.monitor:
            worst = float("inf") if self.mode == "min" else float("-inf")
            m = {self._metric_key(): worst}
        if is_main_process():
            tmp = self.directory / f".{step}.tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            torch.save(state, tmp / _STATE)
            if m is not None:
                (tmp / _METRICS).write_text(json.dumps(m))
            tmp.rename(self.directory / str(step))
        self._steps.append((step, m))
        self._remove_old()
        barrier()
        return True

    def _remove_old(self) -> None:
        n = self.max_to_keep
        if n is None or len(self._steps) <= n:
            return
        if self.monitor:
            keep = {s for s, _ in self._ranked()[-n:]} if n else set()
            keep |= {s for s, m in self._steps if m is None}
        else:
            keep = {s for s, _ in self._steps[-n:]} if n else set()
        for step, _ in self._steps:
            if step not in keep and is_main_process():
                shutil.rmtree(self.directory / str(step))
        self._steps = [s for s in self._steps if s[0] in keep]

    def restore(self, template: Any = None, step: int | None = None) -> Any:
        """The state saved at ``step`` (default: the newest kept), its
        tensors on the devices of ``template``'s (on the CPU without
        one)."""
        step = step if step is not None else self.latest_step()
        assert step is not None, f"no checkpoint found in {self.directory}"
        state = torch.load(self.directory / str(step) / _STATE,
                           map_location="cpu", weights_only=True)
        return state if template is None else _onto(state, template)

    def latest_step(self) -> int | None:
        return max((s for s, _ in self._steps), default=None)

    def best_step(self) -> int | None:
        if not self.monitor:
            return self.latest_step()
        ranked = self._ranked()
        return ranked[-1][0] if ranked else None

    def all_steps(self) -> list[int]:
        return [s for s, _ in self._steps]

    def close(self) -> None:
        pass
