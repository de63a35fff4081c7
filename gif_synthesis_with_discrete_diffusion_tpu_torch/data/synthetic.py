"""Synthetic in-memory video dataset.

The port's own copy of ``gif_synthesis_with_discrete_diffusion_tpu/data/
synthetic.py`` (numpy only; the same seeds give the same clips): a
datamodule of deterministic procedural clips (a colored square orbiting with
a class-dependent trajectory), so that training steps, smoke runs and tests
have structured data whose loss can fall. It yields numpy batches with the
collate schema video/text/label/length/orig_length/frame; the training step
moves them to its device. After :meth:`SyntheticVideoDataModule.set_mesh`
each batch holds only this rank's rows of the global batch of
``batch_size`` (:func:`..parallel.mesh.shard_rows`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..parallel.mesh import Mesh, shard_rows

__all__ = ["SyntheticVideoDataModule", "CLASS_NAMES"]

CLASS_NAMES = ("BreastStroke", "BaseballPitch")


def _render_clip(rng: np.random.Generator, label: int, t: int, res: int
                 ) -> np.ndarray:
    """(T, H, W, 3) uint8: a moving square, trajectory depends on label."""
    video = np.zeros((t, res, res, 3), np.uint8)
    video[...] = rng.integers(0, 40, size=(1, 1, 1, 3), dtype=np.uint8)
    size = max(res // 4, 2)
    color = rng.integers(128, 255, size=(3,), dtype=np.uint8)
    phase = rng.uniform(0, 2 * math.pi)
    for i in range(t):
        ang = phase + (i / max(t, 1)) * 2 * math.pi * (1 if label == 0 else -1)
        cy = int((res - size) * (0.5 + 0.35 * math.sin(ang)))
        cx = int((res - size) * (0.5 + 0.35 * math.cos(ang)))
        video[i, cy:cy + size, cx:cx + size] = color
    return video


@dataclass
class SyntheticVideoDataModule:
    """Deterministic fake video data. Yields numpy batches; videos uint8
    (preprocessing happens on the device, inside the step)."""
    batch_size: int = 4
    sequence_length: int = 4
    resolution: int = 64
    num_train: int = 32
    num_val: int = 8
    num_test: int = 8
    seed: int = 0
    dataname: str = "synthetic"
    class_names: tuple = CLASS_NAMES
    # when > 0, items carry a deterministic random `frame` feature vector of
    # this size (e.g. 2048 to mimic ResNet50 start-frame conditioning)
    frame_dim: int = 0

    _cache: dict = field(default_factory=dict, repr=False)
    _mesh: Mesh | None = field(default=None, repr=False)

    def set_mesh(self, mesh: Mesh | None) -> None:
        """From now on yield this rank's rows of each global batch."""
        self._mesh = mesh

    @property
    def nclasses(self) -> int:
        return len(self.class_names)

    def _split(self, name: str, n: int) -> list[dict]:
        if name not in self._cache:
            rng = np.random.default_rng(
                self.seed + {"train": 0, "val": 1, "test": 2}[name])
            items = []
            for i in range(n):
                label = int(rng.integers(0, self.nclasses))
                video = _render_clip(rng, label, self.sequence_length,
                                     self.resolution)
                item = dict(
                    video=video, label=label,
                    text=self.class_names[label],
                    length=self.sequence_length,
                    orig_length=self.sequence_length)
                if self.frame_dim > 0:
                    item["frame"] = rng.standard_normal(
                        self.frame_dim).astype(np.float32)
                items.append(item)
            self._cache[name] = items
        return self._cache[name]

    def _batches(self, split: str, n: int, shuffle: bool, epoch: int):
        items = self._split(split, n)
        order = np.arange(len(items))
        if shuffle:
            np.random.default_rng(self.seed + 100 + epoch).shuffle(order)
        bs = self.batch_size
        rows = slice(0, bs) if self._mesh is None else shard_rows(bs,
                                                                  self._mesh)
        for start in range(0, len(order) - bs + 1, bs):
            chunk = [items[j] for j in
                     order[start + rows.start:start + rows.stop]]
            yield collate(chunk)

    def train_batches(self, epoch: int = 0):
        return self._batches("train", self.num_train, True, epoch)

    def val_batches(self, epoch: int = 0):
        return self._batches("val", self.num_val, False, epoch)

    def test_batches(self, epoch: int = 0):
        return self._batches("test", self.num_test, False, epoch)

    def steps_per_epoch(self) -> int:
        return self.num_train // self.batch_size


def collate(items: list[dict]) -> dict:
    """Stack item dicts into a batch."""
    batch = {
        "video": np.stack([it["video"] for it in items]),
        "label": np.asarray([it["label"] for it in items], np.int32),
        "length": np.asarray([it["length"] for it in items], np.int32),
        "orig_length": np.asarray([it["orig_length"] for it in items],
                                  np.int32),
        "text": [it["text"] for it in items],
    }
    if "frame" in items[0]:
        batch["frame"] = np.stack([it["frame"] for it in items])
    return batch
