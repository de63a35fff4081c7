"""The port's UCF101 / MSRVTT datamodules, frame features and prefetching vs
the JAX package's (CPU), on small clips written by cv2 as
``tests/test_video_dataset.py`` writes them.

The batches (video, labels, lengths, captions, thumbnail frame features)
are bitwise equal to JAX's for every split and epoch; the ResNet-50 frame
features, on the same flax weights bridged by ``convert/from_flax.py``,
agree within 1e-4 of the output's max-abs (f32 convolutions summed in other
orders, as ``tests/test_torch_resnet.py`` holds them); the prefetching
datamodule keeps JAX's batch order.
"""
import json

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from gif_synthesis_with_discrete_diffusion_tpu.data import prefetch as jpf  # noqa: E402
from gif_synthesis_with_discrete_diffusion_tpu.data import (  # noqa: E402
    video_dataset as jvd)
from gif_synthesis_with_discrete_diffusion_tpu.data.synthetic import (  # noqa: E402
    SyntheticVideoDataModule as JaxDM)
from gif_synthesis_with_discrete_diffusion_tpu_torch.data import (  # noqa: E402
    prefetch as ppf)
from gif_synthesis_with_discrete_diffusion_tpu_torch.data import (  # noqa: E402
    video_dataset as pvd)
from gif_synthesis_with_discrete_diffusion_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticVideoDataModule)
from tests.test_video_dataset import _write_video  # noqa: E402

RESNET_TOL = 1e-4


@pytest.fixture(scope="module")
def ucf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ucf")
    for split in ("train", "val"):
        for ci, cls in enumerate(("BreastStroke", "BaseballPitch")):
            for vi in range(2):
                _write_video(root / split / cls / f"v{vi}.mp4",
                             n_frames=12 + 3 * vi, size=24 + 8 * ci,
                             seed=ci * 10 + vi)
    return root


@pytest.fixture(scope="module")
def msrvtt_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("msrvtt")
    for i in range(12):
        _write_video(root / "TrainValVideo" / f"video{i}.mp4", seed=i)
    ann = {"sentences": [
        {"video_id": f"video{i}", "caption": f"clip {i} take {j}"}
        for i in range(12) for j in range(3)]}
    (root / "train_val_videodatainfo.json").write_text(json.dumps(ann))
    return root


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
            else:
                assert g[k] == w[k]


@pytest.mark.parametrize("seq,res,stride", [(4, 16, 4), (16, 20, 100),
                                            (3, 16, 5)])
def test_ucf101_batches_equal_jax(tmp_path, ucf_root, seq, res, stride):
    kw = dict(sequence_length=seq, resolution=res, batch_size=2,
              frames_between_clips=stride)
    jdm = jvd.UCF101DataModule(str(ucf_root), **kw)
    pdm = pvd.UCF101DataModule(str(ucf_root), **kw)
    for epoch in (0, 1):
        _assert_batches_equal(pdm.train_batches(epoch),
                              jdm.train_batches(epoch))
    _assert_batches_equal(pdm.val_batches(0), jdm.val_batches(0))
    _assert_batches_equal(pdm.test_batches(0), jdm.test_batches(0))
    assert pdm.steps_per_epoch() == jdm.steps_per_epoch()
    b = next(iter(pdm.train_batches(0)))
    assert b["video"].shape == (2, seq, res, res, 3)
    assert b["frame"].shape == (2, 192)


def test_msrvtt_batches_equal_jax(msrvtt_root):
    kw = dict(sequence_length=4, resolution=16, batch_size=2,
              frames_between_clips=4, fraction=1.0)
    jdm = jvd.MSRVTTDataModule(str(msrvtt_root), **kw)
    pdm = pvd.MSRVTTDataModule(str(msrvtt_root), **kw)
    for epoch in (0, 3):
        _assert_batches_equal(pdm.train_batches(epoch),
                              jdm.train_batches(epoch))
    _assert_batches_equal(pdm.val_batches(0), jdm.val_batches(0))
    b = next(iter(pdm.train_batches(0)))
    assert all(t.startswith("clip ") for t in b["text"])


def test_clip_index_and_helpers_equal_jax(ucf_root):
    files = sorted((ucf_root / "train" / "BreastStroke").glob("*.mp4"))
    for stride in (1, 4, 100):
        assert pvd.VideoClipIndex(files, 4, stride).clips == \
            jvd.VideoClipIndex(files, 4, stride).clips
    clip, _ = pvd.VideoClipIndex(files, 4, 4).get_clip(1)
    want, _ = jvd.VideoClipIndex(files, 4, 4).get_clip(1)
    assert np.array_equal(clip, want)
    for res in (8, 16, 23):
        assert np.array_equal(pvd._resize_center_crop_u8(clip, res),
                              jvd._resize_center_crop_u8(clip, res))
    assert np.array_equal(pvd._default_frame_features(clip[0]),
                          jvd._default_frame_features(clip[0]))


def test_resnet_frame_features_match_jax(ucf_root):
    """The port's ResNet-50 features of a first frame, on the flax weights
    (BatchNorms redrawn) bridged by ``convert/from_flax.py``."""
    import jax
    import jax.numpy as jnp

    from gif_synthesis_with_discrete_diffusion_tpu.models.resnet import (
        ResNet50)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax \
        import flax_to_state_dict
    from tests.test_torch_resnet import redraw_batchnorms

    rng = np.random.default_rng(0)
    variables = redraw_batchnorms(rng, ResNet50().init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    frame = next(iter(jvd.UCF101DataModule(
        str(ucf_root), sequence_length=4, resolution=40, batch_size=1,
        frames_between_clips=100).train_batches(0)))["video"][0, 0]
    want = jvd.ResNetFrameFeatures(variables=variables)(frame)
    got = pvd.ResNetFrameFeatures(state_dict=flax_to_state_dict(
        variables["params"], variables["batch_stats"]), platform="cpu")(frame)
    assert got.shape == want.shape == (2048,) and got.dtype == np.float32
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= RESNET_TOL * scale


def test_resnet_frame_features_without_weights(tmp_path):
    feats = pvd.make_frame_features_fn("resnet50", platform="cpu")
    out = feats(np.zeros((32, 32, 3), np.uint8))
    assert out.shape == (2048,) and np.isfinite(out).all()
    with pytest.raises(NotImplementedError, match=r"\[1\]"):
        pvd.make_frame_features_fn("resnet50", str(tmp_path / "r50.pth"),
                                   platform="cpu")
    with pytest.raises(ValueError):
        pvd.make_frame_features_fn("clip")


def test_prefetch_iterator_order_and_exceptions():
    assert list(ppf.prefetch_iterator(iter(range(10)), depth=3)) == \
        list(jpf.prefetch_iterator(iter(range(10)), depth=3))

    def boom():
        yield 1
        raise RuntimeError("decode failed")

    it = ppf.prefetch_iterator(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


@pytest.mark.parametrize("workers", [0, 3])
def test_prefetching_dm_keeps_jax_order(ucf_root, workers):
    kw = dict(sequence_length=4, resolution=16, batch_size=2,
              frames_between_clips=4)
    jdm = jpf.PrefetchingDataModule(jvd.UCF101DataModule(str(ucf_root), **kw),
                                    num_workers=workers, depth=2)
    pdm = ppf.PrefetchingDataModule(pvd.UCF101DataModule(str(ucf_root), **kw),
                                    num_workers=workers, depth=2)
    for epoch in (0, 2):
        _assert_batches_equal(pdm.train_batches(epoch),
                              jdm.train_batches(epoch))
    _assert_batches_equal(pdm.test_batches(0), jdm.test_batches(0))


def test_prefetching_synthetic_dm_keeps_jax_order():
    kw = dict(batch_size=4, sequence_length=2, resolution=16, num_train=16,
              num_val=8)
    jdm = jpf.PrefetchingDataModule(JaxDM(**kw), num_workers=2)
    pdm = ppf.PrefetchingDataModule(SyntheticVideoDataModule(**kw),
                                    num_workers=2)
    _assert_batches_equal(pdm.train_batches(3), jdm.train_batches(3))
    _assert_batches_equal(pdm.val_batches(0), jdm.val_batches(0))


@pytest.mark.parametrize("platform", ["cpu", None])
def test_resnet_frame_features_follow_the_trainer_platform(
        ucf_root, platform, monkeypatch):
    """``build_datamodule`` places the ResNet-50 where ``trainer.platform``
    puts the trainer: ``cpu`` on the CPU; null on the card, which raises
    where there is no card."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch import tasks
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    cfg = {"seed": 0, "trainer": {"platform": platform},
           "datamodule": {"dataname": "ucf101", "data_folder": str(ucf_root),
                          "batch_size": 1, "sequence_length": 4,
                          "resolution": 32, "num_workers": 0,
                          "frame_features": "resnet50"}}
    if platform is None:
        with pytest.raises(RuntimeError, match="trainer.platform=cpu"):
            tasks.build_datamodule(cfg)
        return
    dm = tasks.build_datamodule(cfg)
    assert dm.frame_features_fn.model.fc.weight.device.type == "cpu"
    batch = next(iter(dm.train_batches(0)))
    assert batch["frame"].shape == (1, 2048)
    assert np.isfinite(batch["frame"]).all()
