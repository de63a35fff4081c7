"""UCF101 / MSRVTT clip datasets with host-side decode.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/data/video_dataset.py``
(numpy and cv2 on the host, the same batches): the UCF101 layout
``{root}/{split}/ClassName/*.{avi,mp4,webm}`` over a class subset, clips of
``sequence_length`` frames every ``frames_between_clips`` frames
(:class:`VideoClipIndex`, with a pickled metadata cache), decoded on demand
by cv2, resized (bilinear, shorter side) and centre-cropped as uint8, and
repeated in time where a clip is short; MSRVTT with a random caption per
item from ``train_val_videodatainfo.json``. Batches are numpy arrays; the
float conversion and normalisation run on the device inside the step.
``cv2`` is imported where a video is read, so the module imports without
it.

Frame conditioning: ``frame_features="thumbnail"`` (an 8 x 8 RGB thumbnail
of the first frame, 192 values) or ``"resnet50"`` (:class:`ResNetFrameFeatures`,
the port's ResNet-50).
"""
from __future__ import annotations

import json
import pickle
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from ..parallel.mesh import shard_rows
from ..utils.logging import get_logger
from .synthetic import collate

log = get_logger(__name__)

__all__ = ["VideoClipIndex", "UCF101DataModule", "MSRVTTDataModule",
           "UCF_CLASS_SUBSET", "ResNetFrameFeatures",
           "make_frame_features_fn"]

# reference ucf101_dataset.py:50-53 (full 50-class list is commented there)
UCF_CLASS_SUBSET = ("BreastStroke", "BaseballPitch")
VIDEO_EXTS = (".avi", ".mp4", ".webm")


def _probe_frames(path: Path) -> int:
    import cv2
    cap = cv2.VideoCapture(str(path))
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def _decode_clip(path: Path, start: int, num_frames: int) -> np.ndarray:
    """-> (T, H, W, 3) RGB uint8 (may return fewer frames near EOF)."""
    import cv2
    cap = cv2.VideoCapture(str(path))
    try:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        frames = []
        for _ in range(num_frames):
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if not frames:
            raise IOError(f"failed to decode {path} @ frame {start}")
        return np.stack(frames)
    finally:
        cap.release()


def _resize_center_crop_u8(video: np.ndarray, resolution: int) -> np.ndarray:
    import cv2
    t, h, w, _ = video.shape
    scale = resolution / min(h, w)
    nh, nw = max(int(round(h * scale)), resolution), \
        max(int(round(w * scale)), resolution)
    out = np.empty((t, nh, nw, 3), np.uint8)
    for i in range(t):
        out[i] = cv2.resize(video[i], (nw, nh),
                            interpolation=cv2.INTER_LINEAR)
    top, left = (nh - resolution) // 2, (nw - resolution) // 2
    return out[:, top:top + resolution, left:left + resolution]


@dataclass
class VideoClipIndex:
    """torchvision-VideoClips equivalent: (file, start_frame) clip table with
    an on-disk metadata cache (ucf101_dataset.py:61-69)."""
    files: Sequence[Path]
    sequence_length: int
    frames_between_clips: int = 100
    cache_path: Path | None = None

    clips: list[tuple[int, int]] = field(default_factory=list)

    def __post_init__(self):
        meta = None
        if self.cache_path and Path(self.cache_path).exists():
            try:
                with open(self.cache_path, "rb") as f:
                    meta = pickle.load(f)
                if meta.get("files") != [str(f) for f in self.files] or \
                        meta.get("seq") != self.sequence_length:
                    meta = None
            except Exception:
                meta = None
        if meta is None:
            counts = [_probe_frames(f) for f in self.files]
            meta = {"files": [str(f) for f in self.files],
                    "seq": self.sequence_length, "counts": counts}
            if self.cache_path:
                Path(self.cache_path).parent.mkdir(parents=True,
                                                   exist_ok=True)
                with open(self.cache_path, "wb") as f:
                    pickle.dump(meta, f)
        for fi, count in enumerate(meta["counts"]):
            if count <= 0:
                continue
            starts = range(0, max(count - self.sequence_length, 0) + 1,
                           self.frames_between_clips)
            for s in starts:
                self.clips.append((fi, s))

    def __len__(self) -> int:
        return len(self.clips)

    def get_clip(self, idx: int) -> tuple[np.ndarray, Path]:
        fi, start = self.clips[idx]
        path = Path(self.files[fi])
        return _decode_clip(path, start, self.sequence_length), path


def _default_frame_features(first_frame: np.ndarray) -> np.ndarray:
    """8x8 mean-pooled RGB thumbnail of the first frame -> (192,) float32."""
    import cv2
    thumb = cv2.resize(first_frame, (8, 8), interpolation=cv2.INTER_AREA)
    return (thumb.astype(np.float32) / 255.0).reshape(-1)


class ResNetFrameFeatures:
    """Start-frame features: the port's ResNet-50 over the first frame ->
    (2048,) float32, on the device that ``platform`` names, as
    ``trainer.platform`` does: null is the CUDA card (raises without one),
    ``cpu`` the CPU.

    ``state_dict`` (e.g. from :func:`..convert.from_flax.flax_to_state_dict`)
    gives the weights; without it the network takes the flax init laws from
    a generator seeded with ``seed`` (relative features only). A
    torchvision ``weights_path`` is not read yet (ROADMAP item [1]).
    """

    def __init__(self, weights_path: str | None = None,
                 state_dict: dict | None = None, seed: int = 0,
                 platform: str | None = None):
        import torch

        from ..models.resnet import (ResNet50, init_resnet50_,
                                     preprocess_imagenet_v2)
        from ..train.loop import resolve_device
        device = resolve_device(platform)
        if weights_path:
            raise NotImplementedError(
                f"resnet50_weights={weights_path!r}: reading torchvision "
                f"weights is ROADMAP item [1], not ported yet")
        with torch.device("meta"):
            model = ResNet50()
        model = model.to_empty(device="cpu")
        if state_dict is None:
            log.warning("ResNetFrameFeatures: no weights; random ResNet50 "
                        "init (relative features only)")
            init_resnet50_(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(device).eval().requires_grad_(False)
        self._torch = torch
        self._preprocess = preprocess_imagenet_v2

    def __call__(self, first_frame: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> (2048,) float32."""
        torch = self._torch
        device = self.model.fc.weight.device
        with torch.no_grad():
            x = self._preprocess(torch.from_numpy(
                np.ascontiguousarray(first_frame))[None].to(device))
            return self.model(x, features_only=True)[0].cpu().numpy()


def make_frame_features_fn(kind: str = "thumbnail",
                           weights_path: str | None = None,
                           platform: str | None = None) -> Callable:
    """``platform`` places the ResNet-50 as ``trainer.platform`` does."""
    if kind == "thumbnail":
        return _default_frame_features
    if kind == "resnet50":
        return ResNetFrameFeatures(weights_path=weights_path,
                                   platform=platform)
    raise ValueError(f"unknown frame_features kind {kind!r}")


class _BaseVideoDataModule:
    """Shared batching for file-backed video datasets. After
    :meth:`set_mesh` each batch holds only this rank's rows of the global
    batch, and only those clips are decoded."""

    def __init__(self, batch_size: int, seed: int = 0):
        self.batch_size = batch_size
        self.seed = seed
        self._mesh = None

    def set_mesh(self, mesh) -> None:
        self._mesh = mesh

    def batch_rows(self) -> slice:
        """This rank's rows of a global batch (all of them without a
        mesh)."""
        bs = self.batch_size
        return slice(0, bs) if self._mesh is None else shard_rows(
            bs, self._mesh)

    def _items(self, split: str) -> list:
        raise NotImplementedError

    def _get(self, split: str, idx: int) -> dict:
        raise NotImplementedError

    def _batches(self, split: str, shuffle: bool, epoch: int):
        n = len(self._items(split))
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(self.seed + 1000 + epoch).shuffle(order)
        bs, rows = self.batch_size, self.batch_rows()
        for s in range(0, n - bs + 1, bs):
            yield collate([self._get(split, int(j))
                           for j in order[s + rows.start:s + rows.stop]])

    def train_batches(self, epoch: int = 0):
        return self._batches("train", True, epoch)

    def val_batches(self, epoch: int = 0):
        return self._batches("val", False, epoch)

    def test_batches(self, epoch: int = 0):
        # the reference has no separate test dir; val doubles as test
        return self._batches("test" if self._has_split("test") else "val",
                             False, epoch)

    def _has_split(self, split: str) -> bool:
        try:
            return len(self._items(split)) > 0
        except Exception:
            return False

    def steps_per_epoch(self) -> int:
        return len(self._items("train")) // self.batch_size


class UCF101DataModule(_BaseVideoDataModule):
    def __init__(self, data_folder: str, sequence_length: int = 4,
                 resolution: int = 128, batch_size: int = 32,
                 classes: Sequence[str] = UCF_CLASS_SUBSET,
                 frames_between_clips: int = 100, tiny: bool = False,
                 frame_features_fn: Callable | None = None,
                 frame_features: str = "thumbnail",
                 resnet50_weights: str | None = None,
                 platform: str | None = None, seed: int = 0, **_):
        super().__init__(batch_size, seed)
        self.root = Path(data_folder)
        self.sequence_length = sequence_length
        self.resolution = resolution
        self.classes = tuple(classes)
        self.class_to_label = {c: i for i, c in enumerate(self.classes)}
        self.frames_between_clips = frames_between_clips
        self.tiny = tiny
        self.frame_features_fn = frame_features_fn or make_frame_features_fn(
            frame_features, resnet50_weights, platform)
        self._indices: dict[str, VideoClipIndex] = {}
        self._files: dict[str, list[Path]] = {}

    @property
    def nclasses(self) -> int:
        return len(self.classes)

    def _index(self, split: str) -> VideoClipIndex:
        if split not in self._indices:
            files = []
            for cls in self.classes:
                d = self.root / split / cls
                if d.is_dir():
                    files += sorted(p for p in d.iterdir()
                                    if p.suffix.lower() in VIDEO_EXTS)
            if self.tiny:
                files = files[:4]
            if not files:
                raise FileNotFoundError(
                    f"no videos for classes {self.classes} under "
                    f"{self.root / split}")
            self._files[split] = files
            self._indices[split] = VideoClipIndex(
                files, self.sequence_length, self.frames_between_clips,
                cache_path=self.root / f".clip_cache_{split}.pkl")
        return self._indices[split]

    def _items(self, split: str):
        return self._index(split).clips

    def _get(self, split: str, idx: int) -> dict:
        clip, path = self._index(split).get_clip(idx)
        orig_len = clip.shape[0]
        clip = _resize_center_crop_u8(clip, self.resolution)
        # temporal repeat to sequence_length (intended behavior of
        # ucf101_dataset.py:93-96, which checks shape[2] — a latent bug)
        if clip.shape[0] < self.sequence_length:
            reps = -(-self.sequence_length // clip.shape[0])
            clip = np.repeat(clip, reps, axis=0)[: self.sequence_length]
        cls = path.parent.name
        return dict(video=clip, label=self.class_to_label.get(cls, 0),
                    text=cls, length=self.sequence_length,
                    orig_length=orig_len,
                    frame=self.frame_features_fn(clip[0]))


class MSRVTTDataModule(_BaseVideoDataModule):
    def __init__(self, data_folder: str, sequence_length: int = 4,
                 resolution: int = 128, batch_size: int = 32,
                 frames_between_clips: int = 100, tiny: bool = False,
                 fraction: float = 0.25, seed: int = 0, **_):
        super().__init__(batch_size, seed)
        self.root = Path(data_folder)
        self.sequence_length = sequence_length
        self.resolution = resolution
        self.frames_between_clips = frames_between_clips
        self.tiny = tiny
        self.fraction = fraction  # first 1/4 of videos (msrvtt_dataset.py:70)
        self._indices: dict[str, VideoClipIndex] = {}
        self._captions: dict[str, list[str]] | None = None

    nclasses = 1

    def _load_captions(self) -> dict[str, list[str]]:
        if self._captions is None:
            ann = self.root / "train_val_videodatainfo.json"
            with open(ann) as f:
                data = json.load(f)
            caps: dict[str, list[str]] = {}
            for s in data.get("sentences", []):
                caps.setdefault(s["video_id"], []).append(s["caption"])
            self._captions = caps
        return self._captions

    def _index(self, split: str) -> VideoClipIndex:
        if split not in self._indices:
            d = self.root / ("TrainValVideo" if (self.root /
                             "TrainValVideo").is_dir() else split)
            files = sorted(p for p in d.iterdir()
                           if p.suffix.lower() in VIDEO_EXTS)
            files = files[: max(int(len(files) * self.fraction), 1)]
            if self.tiny:
                files = files[:4]
            if split == "val":
                files = files[-max(len(files) // 10, 1):]
            elif split == "train":
                files = files[: -max(len(files) // 10, 1)] or files
            self._indices[split] = VideoClipIndex(
                files, self.sequence_length, self.frames_between_clips,
                cache_path=self.root / f".clip_cache_{split}.pkl")
        return self._indices[split]

    def _items(self, split: str):
        return self._index(split).clips

    def _get(self, split: str, idx: int) -> dict:
        clip, path = self._index(split).get_clip(idx)
        orig_len = clip.shape[0]
        clip = _resize_center_crop_u8(clip, self.resolution)
        if clip.shape[0] < self.sequence_length:
            reps = -(-self.sequence_length // clip.shape[0])
            clip = np.repeat(clip, reps, axis=0)[: self.sequence_length]
        caps = self._load_captions().get(path.stem, ["a video"])
        rng = random.Random(self.seed * 100003 + idx)
        return dict(video=clip, label=0, text=rng.choice(caps),
                    length=self.sequence_length, orig_length=orig_len)
