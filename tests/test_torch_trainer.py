"""The port's trainer loop vs the JAX package's (CPU).

Control flow: stub subclasses of both ``Trainer`` classes get the same
scripted step values; the logged rows, the checkpoints kept (both managers),
the early-stop epoch (the non-finite stop included), the render epochs, and
the resumed ``global_step`` and epoch must be equal. The values are exact
(f32 sums of the same f32 numbers in the same order on both sides).

The real trainers at a small size on the CPU (``trainer.platform: cpu``):
the stage-1 loss falls (as ``tests/test_stage1_train.py``), stage 2 trains
and logs its telemetry (as ``tests/test_stage2_train.py``), a stage-2 run
resumes with its state restored bit for bit and its Lt counts growing (as
``tests/test_stage2_resume.py``), stage 2 reads a stage-1 run's VQ-VAE bit
for bit, and the learnable-CF empty-text mask is JAX's
(``tests/test_learnable_cf.py``).
"""
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from gif_synthesis_with_discrete_diffusion_tpu.data.synthetic import (
    SyntheticVideoDataModule as JaxDM)
from gif_synthesis_with_discrete_diffusion_tpu.train.loop import (
    Trainer as JaxTrainer)
from gif_synthesis_with_discrete_diffusion_tpu.utils.logging import (
    MetricLogger as JaxMetricLogger)
from gif_synthesis_with_discrete_diffusion_tpu_torch.data.synthetic import (
    SyntheticVideoDataModule)
from gif_synthesis_with_discrete_diffusion_tpu_torch.train.loop import Trainer
from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage1 import (
    Stage1Trainer)
from gif_synthesis_with_discrete_diffusion_tpu_torch.train.stage2 import (
    Stage2Trainer)
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils.logging import (
    MetricLogger)


@struct.dataclass
class _JaxState:
    step: jax.Array
    w: jax.Array


class _Rows(JaxMetricLogger, MetricLogger):
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((step, {k: float(v) for k, v in metrics.items()}))


def _stub(base, framework):
    """A trainer of ``base`` whose steps return scripted values: the
    ``i``-th train call gives ``train[i]``, the ``i``-th eval call
    ``val[i]``, the FVD of validated epoch ``e`` ``fvd[e]`` (where set)."""

    class Stub(base):
        def __init__(self, cfg, dm, run_dir, script):
            super().__init__(cfg, dm, run_dir)
            self.script = script
            self.calls = {"train": 0, "eval": 0}
            self.renders = []
            self.first_step_at = None
            self.rows = _Rows()
            self.loggers.append(self.rows)

        def build(self, example_batch):
            if framework == "jax":
                self.state = _JaxState(step=jnp.zeros((), jnp.int32),
                                       w=jnp.zeros((), jnp.float32))
            else:
                self.state = {"step": torch.tensor(0),
                              "w": torch.tensor(0.0)}

        def loss_names(self):
            return ["l_dummy", "total"]

        def _values(self, kind):
            v = self.script[kind][self.calls[kind]
                                  % len(self.script[kind])]
            self.calls[kind] += 1
            if framework == "jax":
                return {"l_dummy": jnp.float32(v), "total": jnp.float32(3 * v)}
            return {"l_dummy": torch.tensor(v, dtype=torch.float32),
                    "total": torch.tensor(3 * v, dtype=torch.float32)}

        def train_step(self, state, batch, rng):
            if self.first_step_at is None:
                self.first_step_at = (self.global_step, self.current_epoch)
            values = self._values("train")
            if framework == "jax":
                return state.replace(step=state.step + 1,
                                     w=state.w + values["l_dummy"]), values
            return {"step": state["step"] + 1,
                    "w": state["w"] + values["l_dummy"]}, values

        def eval_step(self, state, batch, rng):
            return self._values("eval")

        def render_samples(self, epoch):
            self.renders.append(epoch)

        def extra_eval_metrics(self, split, epoch):
            fvd = self.script.get("fvd", {})
            return {"Metrics/fvd-val": fvd[epoch]} if epoch in fvd else {}

    return Stub


JaxStub = _stub(JaxTrainer, "jax")
PortStub = _stub(Trainer, "port")


def _cfg(**trainer):
    cb = trainer.pop("callbacks", None)
    cfg = {"seed": 0,
           "trainer": dict({"max_epochs": 4, "check_val_every_n_epoch": 1,
                            "log_every_n_steps": 3, "mesh": {"data": None}},
                           **trainer),
           "logger": {"csv": {}},
           "callbacks": cb or {
               "model_checkpoint": {"monitor": "total/val", "mode": "min",
                                    "save_top_k": 2},
               "early_stopping": {"monitor": "total/val", "patience": 1,
                                  "mode": "min"}}}
    return cfg


def _dms(num_train=16, num_val=8):
    kw = dict(batch_size=8, sequence_length=1, resolution=4,
              num_train=num_train, num_val=num_val, num_test=8)
    return JaxDM(**kw), SyntheticVideoDataModule(**kw)


def _pair(tmp_path, cfg, script, dms=None, **fit):
    """Fit a JAX and a port stub on the same script; both trainers."""
    jdm, pdm = dms or _dms()
    jt = JaxStub(cfg, jdm, tmp_path / "jax", script)
    pcfg = copy.deepcopy(cfg)
    pcfg["trainer"]["platform"] = "cpu"
    pt = PortStub(pcfg, pdm, tmp_path / "port", script)
    jm, pm = jt.fit(**fit), pt.fit(**fit)
    return jt, pt, jm, pm


def _same_floats(a, b) -> bool:
    return a == b or (math.isnan(a) and math.isnan(b))


def _assert_same(jt, pt, jm, pm):
    assert len(pt.rows.rows) == len(jt.rows.rows)
    for (ps, pr), (js, jr) in zip(pt.rows.rows, jt.rows.rows):
        assert ps == js and list(pr) == list(jr)
        assert all(_same_floats(pr[k], jr[k]) for k in jr), (pr, jr)
    assert list(pm) == list(jm)
    assert all(_same_floats(pm[k], jm[k]) for k in jm)
    for name in ("ckpt", "fid_ckpt"):
        jmgr, pmgr = getattr(jt, name), getattr(pt, name)
        assert (jmgr is None) == (pmgr is None)
        if jmgr is not None:
            assert pmgr.all_steps() == jmgr.all_steps()
            assert pmgr.latest_step() == jmgr.latest_step()
            assert pmgr.best_step() == jmgr.best_step()
    assert pt.renders == jt.renders
    assert (pt.global_step, pt.current_epoch) == (jt.global_step,
                                                  jt.current_epoch)
    assert pt.first_step_at == jt.first_step_at
    assert pt.calls == jt.calls


NAN = float("nan")
CASES = {
    # val total 9, 6, 7.5, 7.8: patience 1 stops after epoch 3
    "early stop": (dict(max_epochs=6, render_every_n_epochs=2),
                   {"train": [5.0, 4.5, 4.25, 4.0], "eval": [3.0, 2.0, 2.5,
                                                              2.6, 1.0]}),
    "non-finite stop": (dict(max_epochs=5),
                        {"train": [5.0, 4.0], "eval": [3.0, NAN]}),
    "max_steps mid-epoch": (dict(max_epochs=5, max_steps=3,
                                 log_every_n_steps=1),
                            {"train": [1.0, 0.75, 0.5], "eval": [2.0]}),
    "validation every 2 epochs, FVD checkpoints": (
        dict(max_epochs=6, check_val_every_n_epoch=2,
             callbacks={"model_checkpoint": {"save_top_k": 1},
                        "fid_checkpoint": {"monitor": "Metrics/fvd-val"},
                        "early_stopping": {"patience": 9}}),
        {"train": [1.0, 2.0, 3.0], "eval": [4.0, 3.5, 3.75],
         "fvd": {1: 40.0, 5: 30.0}}),
}


# what each case must show: (global_step, current_epoch, renders, steps kept
# by the FVD manager or None)
EXPECT = {"early stop": (8, 3, [0, 2], []),
          "non-finite stop": (4, 1, [0], []),
          "max_steps mid-epoch": (3, 1, [0], []),
          "validation every 2 epochs, FVD checkpoints": (12, 5, [5],
                                                         [12])}


@pytest.mark.parametrize("name", list(CASES))
def test_control_flow_equals_jax(tmp_path, name):
    trainer, script = CASES[name]
    jt, pt, jm, pm = _pair(tmp_path, _cfg(**trainer), script)
    _assert_same(jt, pt, jm, pm)
    step, epoch, renders, fvd_kept = EXPECT[name]
    assert (pt.global_step, pt.current_epoch, pt.renders) == (step, epoch,
                                                              renders)
    assert (pt.fid_ckpt.all_steps() if pt.fid_ckpt else []) == fvd_kept


def test_zero_batch_epochs_equal_jax(tmp_path, caplog):
    jt, pt, jm, pm = _pair(tmp_path, _cfg(max_epochs=2),
                           {"train": [1.0], "eval": [2.0]},
                           dms=_dms(num_val=4))
    _assert_same(jt, pt, jm, pm)
    assert pt.calls["eval"] == 0
    assert "saw ZERO batches" in caplog.text


@pytest.mark.parametrize("how", ["resume", "restore_from"])
def test_resume_equals_jax(tmp_path, how):
    """A second run of 4 epochs over a 2-epoch run's checkpoints (its own
    run dir with ``resume``, another one with ``restore_from``)."""
    script = {"train": [2.0, 1.5, 1.25], "eval": [3.0, 2.0, 1.0, 0.5]}
    _pair(tmp_path / "first", _cfg(max_epochs=2), script)
    if how == "resume":
        for side in ("jax", "port"):
            (tmp_path / side).symlink_to(tmp_path / "first" / side)
        fit = {"resume": True}
    else:
        fit = {"restore_from": "../first/SIDE/checkpoints"}
    jdm, pdm = _dms()
    cfg = _cfg(max_epochs=4)
    jt = JaxStub(cfg, jdm, tmp_path / "jax", script)
    pcfg = copy.deepcopy(cfg)
    pcfg["trainer"]["platform"] = "cpu"
    pt = PortStub(pcfg, pdm, tmp_path / "port", script)
    side = {k: (str(tmp_path / "first" / "{}" / "checkpoints")
                if k == "restore_from" else v) for k, v in fit.items()}
    jm = jt.fit(**{k: v.format("jax") if isinstance(v, str) else v
                   for k, v in side.items()})
    pm = pt.fit(**{k: v.format("port") if isinstance(v, str) else v
                   for k, v in side.items()})
    _assert_same(jt, pt, jm, pm)
    assert pt.first_step_at == (4, 2)
    assert int(pt.state["step"]) == 8
    assert float(pt.state["w"]) == float(jax.device_get(jt.state.w))


# ---------------------------------------------------------------------------
# the real trainers, small, on the CPU
# ---------------------------------------------------------------------------

AE = {"embedding_dim": 8, "n_codes": 16, "n_hiddens": 16, "n_res_layers": 1,
      "downsample": [1, 4, 4], "sequence_length": 2, "resolution": 16,
      "kernel_mode": "xla"}


def _stage1_cfg(max_epochs=1):
    return {"seed": 0,
            "trainer": {"max_epochs": max_epochs, "log_every_n_steps": 1,
                        "platform": "cpu"},
            "model": {"generator": dict(AE),
                      "losses": {"loss_dict": {"l_dummy": 1.0}},
                      "lr_args": {"gen_lr": "4e-4"}},
            "logger": {"csv": {}},
            "callbacks": {"model_checkpoint": {"monitor": "total/val",
                                               "save_top_k": 2}}}


def _stage2_cfg(max_epochs=1, conditioner=None, ae_ckpt=None):
    return {"seed": 0,
            "trainer": {"max_epochs": max_epochs, "log_every_n_steps": 1,
                        "platform": "cpu"},
            "model": {
                "generator": {
                    "textencoder": conditioner,
                    "diffusion_model": {
                        "diffusion_step": 4, "auxiliary_loss_weight": 5e-4,
                        "adaptive_auxiliary_loss": True,
                        "guidance_scale": 2.0,
                        "transformer": {"n_layer": 2, "n_embd": 16,
                                        "n_head": 4, "condition_dim": 32,
                                        "dalle": {"spatial_size": [8, 4]}}}},
                "autoencoder": dict(AE),
                "generator_losses": {"loss_dict": {"l_dummy": 1.0}},
                "checkpoint_paths": ({"autoencoder": ae_ckpt}
                                     if ae_ckpt else {}),
                "lr_args": {"gen_lr": "1e-3"}},
            "logger": {"csv": {}}}


def _dm():
    return SyntheticVideoDataModule(batch_size=8, sequence_length=2,
                                    resolution=16, num_train=16, num_val=8)


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _bitwise(a, b) -> bool:
    da, db = dict(_tensors(a)), dict(_tensors(b))
    return set(da) == set(db) and all(
        da[k].dtype == db[k].dtype and torch.equal(da[k], db[k]) for k in da)


def test_stage1_loss_falls_and_its_checkpoint_feeds_stage2(tmp_path):
    t1 = Stage1Trainer(_stage1_cfg(max_epochs=8), _dm(), tmp_path / "s1")
    first = []
    t1.loggers.append(type("L", (MetricLogger,), {
        "log_metrics": lambda self, m, s: first.append(m)})())
    metrics = t1.fit()
    trains = [m["total/train"] for m in first if "total/train" in m]
    assert t1.global_step == 16 and len(trains) == 8
    assert trains[-1] < trains[0] and metrics["total/train"] < 60.0
    assert (tmp_path / "s1" / "metrics.csv").exists()
    assert float(t1.state.vqvae.codebook.ema_count.sum()) > 0
    saved = t1.ckpt.restore()
    assert saved["step"] == t1.ckpt.latest_step() == 16

    t2 = Stage2Trainer(_stage2_cfg(ae_ckpt=str(tmp_path / "s1"
                                               / "checkpoints")),
                       _dm(), tmp_path / "s2")
    t2.build(next(iter(t2.datamodule.train_batches(0))))
    assert _bitwise(t2.state.vqvae.state_dict(), saved["vqvae"])
    with pytest.raises(NotImplementedError, match="parity_fvd.py --vqvae"):
        Stage2Trainer(_stage2_cfg(ae_ckpt=str(tmp_path / "ref.ckpt")),
                      _dm(), tmp_path / "s3").build({})


def test_stage2_trains_resumes_bitwise_and_grows_lt(tmp_path):
    run = tmp_path / "run"
    t1 = Stage2Trainer(_stage2_cfg(conditioner={"mode": "label",
                                                "n_classes": 2, "dim": 32}),
                       _dm(), run)
    metrics = t1.fit()
    assert np.isfinite(metrics["total/train"])
    assert np.isfinite(metrics["total/val"])
    for key in ("diffusion/acc/train", "diffusion/keep/train",
                "diffusion/acc/val", "diffusion/keep/val"):
        assert 0.0 <= metrics[key] <= 1.0, key
    d = t1.state.generator.diffusion
    assert float(d.lt_count.sum()) == 2 * 8
    assert float(d.diffusion_acc.sum()) > 0
    saved = copy.deepcopy(t1.state_dict())

    t2 = Stage2Trainer(_stage2_cfg(max_epochs=2,
                                   conditioner={"mode": "label",
                                                "n_classes": 2, "dim": 32}),
                       _dm(), run)
    seen = {}
    orig = Stage2Trainer.train_step

    def first(self, state, batch, rng):
        if not seen:
            seen["state"] = copy.deepcopy(self.state_dict())
            seen["at"] = (self.global_step, self.current_epoch)
        return orig(self, state, batch, rng)
    Stage2Trainer.train_step = first
    try:
        t2.fit(resume=True)
    finally:
        Stage2Trainer.train_step = orig
    assert seen["at"] == (2, 1) and t2.global_step == 4
    assert _bitwise(seen["state"], saved)
    assert float(t2.state.generator.diffusion.lt_count.sum()) > \
        float(d.lt_count.sum()) > 0


def test_learnable_cf_empty_text_mask_equals_jax(tmp_path):
    from gif_synthesis_with_discrete_diffusion_tpu.train.stage2 import (
        Stage2Trainer as JaxStage2Trainer)
    cond = {"mode": "text", "dim": 32, "width": 16, "heads": 2, "layers": 1,
            "allow_hash_tokenizer": True}
    batch = {"text": ["a dog", "", "   ", "cat"],
             "video": np.zeros((4, 2, 16, 16, 3), np.uint8)}
    for learnable in (True, False):
        cfg = _stage2_cfg(conditioner=cond)
        cfg["model"]["generator"]["diffusion_model"]["learnable_cf"] = \
            learnable
        jcfg = copy.deepcopy(cfg)
        del jcfg["trainer"]["platform"]
        got = Stage2Trainer(cfg, _dm(), tmp_path / f"p{learnable}"
                            )._prepare_batch(batch)
        want = JaxStage2Trainer(jcfg, _dm(), tmp_path / f"j{learnable}"
                                )._prepare_batch(batch)
        assert set(got) == set(want)
        assert np.array_equal(np.asarray(got["text_tokens"]),
                              np.asarray(want["text_tokens"]))
        if learnable:
            assert got["empty_text_mask"].tolist() == \
                want["empty_text_mask"].tolist() == [False, True, True,
                                                     False]
