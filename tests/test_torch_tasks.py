"""The port's task layer and entries on the CPU (``trainer.platform=cpu``):
``python -m ..._torch.tasks train|eval`` and ``python -m ..._torch.generate``
as child processes, at a small size. Each run writes ``config_tree.log``
(read back by the port's reader to the composed dict) and
``exec_time.log``, and ``exception.log`` on a failure; without CUDA and
without ``trainer.platform=cpu`` a run raises; an existing ``eval_ckpt``
raises rather than being ignored."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu_torch import tasks
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils import yaml_lite
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils.config import (
    compose)

ROOT = Path(__file__).resolve().parent.parent
PKG = "gif_synthesis_with_discrete_diffusion_tpu_torch"

STAGE1 = [
    "datamodule=synthetic", "batch_size=8", "datamodule.resolution=16",
    "datamodule.sequence_length=2", "datamodule.num_train=16",
    "datamodule.num_val=8", "datamodule.num_test=8",
    "model.generator.n_codes=16", "model.generator.n_hiddens=16",
    "model.generator.n_res_layers=1", "model.generator.downsample=[1,4,4]",
    "model.generator.embedding_dim=8", "model.do_evaluation=false",
    "seed=0", "trainer.platform=cpu", "logger=csv", "extras.print_config=false",
]
STAGE2 = [
    "model=discrete_diffusion", "datamodule=synthetic", "batch_size=4",
    "datamodule.resolution=16", "datamodule.sequence_length=2",
    "datamodule.num_train=8", "datamodule.num_val=4", "datamodule.num_test=4",
    "model.autoencoder.embedding_dim=8", "model.autoencoder.n_codes=16",
    "model.autoencoder.n_hiddens=16", "model.autoencoder.n_res_layers=1",
    "model.autoencoder.downsample=[1,4,4]",
    "model.generator.diffusion_model.diffusion_step=4",
    "model.generator.diffusion_model.transformer.n_layer=1",
    "model.generator.diffusion_model.transformer.n_embd=16",
    "model.generator.diffusion_model.transformer.n_head=4",
    "model.generator.diffusion_model.transformer.condition_dim=32",
    "model.generator.diffusion_model.transformer.dalle.spatial_size=[8,4]",
    "model/textencoder=label", "model.generator.textencoder.dim=32",
    "model.generator.textencoder.n_classes=2", "model.do_evaluation=false",
    "seed=0", "trainer.platform=cpu", "logger=csv",
    "extras.print_config=false",
]


def _run(module: str, *args: str, env=None) -> subprocess.CompletedProcess:
    e = dict(os.environ if env is None else env)
    e["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), e.get("PYTHONPATH", "")) if p)
    return subprocess.run([sys.executable, "-m", f"{PKG}.{module}", *args],
                          cwd=ROOT, env=e, capture_output=True, text=True,
                          timeout=300)


def _one_run(out: Path) -> Path:
    (run,) = [p for p in out.iterdir() if p.is_dir()]
    return run


def _check_run_dir(run: Path, task: str, overrides: list[str]) -> None:
    written = yaml_lite.safe_load((run / "config_tree.log").read_text())
    assert written == compose(task, overrides)
    assert (run / "exec_time.log").read_text().startswith(f"'{task}'")
    assert not (run / "exception.log").exists()


def test_train_eval_and_generate_entries(tmp_path):
    s1 = STAGE1 + ["trainer.max_epochs=2",
                   f"paths.output_dir={tmp_path / 's1'}"]
    proc = _run("tasks", "train", *s1)
    assert proc.returncode == 0, proc.stderr
    printed = dict(line.split(": ") for line in proc.stdout.splitlines())
    assert {"total/train", "total/val", "l/dummy/val", "epoch"} <= set(
        printed)
    run1 = _one_run(tmp_path / "s1")
    _check_run_dir(run1, "train", s1)
    assert (run1 / "metrics.csv").exists()
    assert sorted(p.name for p in (run1 / "checkpoints").iterdir()) == [
        "2", "4"]

    # stage 2 over the stage-1 run, then eval and generate on its
    # checkpoints
    s2 = STAGE2 + [f"model.checkpoint_paths.autoencoder={run1}/checkpoints",
                   "trainer.max_epochs=1",
                   f"paths.output_dir={tmp_path / 's2'}"]
    proc = _run("tasks", "train", *s2)
    assert proc.returncode == 0, proc.stderr
    run2 = _one_run(tmp_path / "s2")
    _check_run_dir(run2, "train", s2)
    assert (run2 / "epoch0_synthesis.gif").exists()

    ev = STAGE2 + [f"ckpt_path={run2}/checkpoints",
                   f"paths.output_dir={tmp_path / 'eval'}"]
    proc = _run("tasks", "eval", *ev)
    assert proc.returncode == 0, proc.stderr
    assert "total/test: " in proc.stdout
    _check_run_dir(_one_run(tmp_path / "eval"), "eval", ev)

    proc = _run("generate", *STAGE2, f"ckpt_path={run2}/checkpoints",
                "+num_samples=2", f"+out_dir={tmp_path / 'samples'}")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith(
        "generated 2 clips; 2 GIFs written")
    for i in range(2):
        gif = tmp_path / "samples" / f"sample_{i}.gif"
        assert gif.exists() and gif.stat().st_size > 0
    assert sorted(p.name for p in (tmp_path / "samples").iterdir()) == [
        "sample_0.gif", "sample_1.gif"]


def test_a_failure_writes_exception_log(tmp_path):
    cfg = compose("train", [
        "trainer.platform=cpu", "extras.print_config=false",
        f"datamodule.data_folder={tmp_path / 'none'}",
        "datamodule.num_workers=0", f"paths.output_dir={tmp_path / 'out'}"])
    with pytest.raises(FileNotFoundError):
        tasks.train(cfg)
    run = _one_run(tmp_path / "out")
    assert "FileNotFoundError" in (run / "exception.log").read_text()
    assert (run / "exec_time.log").exists()
    assert (run / "config_tree.log").exists()


def test_no_cuda_and_no_cpu_request_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ovr = [o for o in STAGE1 if o != "trainer.platform=cpu"]
    with pytest.raises(RuntimeError, match="trainer.platform=cpu"):
        tasks.train(compose("train", ovr + [
            f"paths.output_dir={tmp_path / 'out'}"]))
    assert not (tmp_path / "out").exists()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run("tasks", "train", *ovr,
                f"paths.output_dir={tmp_path / 'cli'}", env=env)
    assert proc.returncode != 0 and "trainer.platform=cpu" in proc.stderr
    proc = _run("tasks", "fit", env=env)
    assert proc.returncode == 2 and "usage" in proc.stderr


def test_an_existing_eval_ckpt_is_not_ignored(tmp_path):
    i3d = tmp_path / "i3d.pt"
    i3d.write_bytes(b"weights")
    cfg = compose("train", STAGE1 + ["model.do_evaluation=true",
                                     f"eval_ckpt={i3d}",
                                     f"paths.output_dir={tmp_path / 'out'}"])
    with pytest.raises(NotImplementedError, match=r"\[1\]"):
        tasks.train(cfg)


def test_debug_switches_map_to_torch(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(torch.autograd, "set_detect_anomaly",
                        lambda on: seen.setdefault("anomaly", on))
    monkeypatch.setattr(tasks, "_start_profiler",
                        lambda run_dir, device: seen.setdefault(
                            "profiler", (run_dir.parent, device.type)))
    run_dir = tasks._setup(compose("train", STAGE1 + [
        "debug=profiler", "+debug_nans=true",
        f"paths.output_dir={tmp_path}"]))
    assert seen == {"anomaly": True, "profiler": (tmp_path, "cpu")}
    assert run_dir.parent == tmp_path
