"""The port's checkpoint manager vs the JAX package's Orbax manager (CPU):
the same (step, metrics) sequence -- saves without the monitored metric,
a step saved twice, ties, NaN, a step saved again after it was dropped --
keeps the same steps, with the same latest and best, after every save and
after reopening the directory; a trainer's state round-trips bit for bit
onto the trainer's devices."""
import math

import jax.numpy as jnp
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.utils.checkpoint import (
    CheckpointManager as OrbaxManager)
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils.checkpoint import (
    CheckpointManager)

NAN = math.nan
SEQUENCES = {
    "min, repeats, no metric": (
        dict(monitor="total/val", mode="min", max_to_keep=2),
        [(1, {"total/val": 5.0}), (2, {"total/val": 3.0}),
         (2, {"total/train": 1.0}), (3, {}), (4, {"total/val": 4.0}),
         (5, {"total/val": 1.0}), (5, {"x": 1.0}),
         (6, {"total/val": 9.0})]),
    "ties": (dict(monitor="v", max_to_keep=2),
             [(1, {"v": 2.0}), (2, {"v": 2.0}), (3, {"v": 2.0}),
              (4, {"v": 1.0})]),
    "max": (dict(monitor="v", mode="max", max_to_keep=2),
            [(1, {"v": 2.0}), (2, {"v": 5.0}), (3, {}), (4, {"v": 1.0}),
             (5, {"v": 7.0})]),
    "no monitor": (dict(monitor=None, max_to_keep=3),
                   [(1, {"v": 2.0}), (2, {"v": 5.0}), (3, {}),
                    (4, {"v": 1.0}), (5, {"v": 7.0}), (5, {})]),
    "nan": (dict(monitor="v", max_to_keep=2),
            [(1, {"v": 2.0}), (2, {"v": NAN}), (3, {"v": 1.0}),
             (4, {"v": NAN}), (5, {"v": 3.0})]),
    "dropped, saved again": (
        dict(monitor="v", max_to_keep=2),
        [(1, {"v": 2.0}), (2, {"v": 1.0}), (3, {"v": 9.0}),
         (3, {"v": 0.5}), (2, {"v": 0.1}), (4, {"v": 0.2})]),
    "all without metric": (dict(monitor="v", max_to_keep=2),
                           [(1, {}), (2, {}), (3, {}), (4, {"v": 1.0}),
                            (5, {})]),
    "keep one": (dict(monitor="v", max_to_keep=1),
                 [(1, {"v": 3.0}), (2, {"v": 1.0}), (3, {"v": 2.0})]),
    "fvd monitor": (dict(monitor="Metrics/fvd-val", max_to_keep=1),
                    [(2, {"Metrics/fvd-val": 40.0, "total/val": 1.0}),
                     (4, {"Metrics/fvd-val": 30.0}),
                     (6, {"Metrics/fvd-val": 35.0})]),
}


def _view(mgr):
    return mgr.all_steps(), mgr.latest_step(), mgr.best_step()


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_retention_equals_orbax(tmp_path, name):
    kwargs, seq = SEQUENCES[name]
    orbax = OrbaxManager(tmp_path / "orbax", **kwargs)
    port = CheckpointManager(tmp_path / "port", **kwargs)
    for step, metrics in seq:
        orbax.save(step, {"a": jnp.full((2,), float(step))}, metrics)
        port.save(step, {"a": torch.full((2,), float(step))}, metrics)
        assert _view(port) == _view(orbax), (step, metrics)
    orbax.close()
    for monitor in (kwargs.get("monitor"), None):
        again = dict(kwargs, monitor=monitor)
        assert _view(CheckpointManager(tmp_path / "port", **again)) == \
            _view(OrbaxManager(tmp_path / "orbax", **again))
    # the state kept at each step is the first one saved there
    for step in port.all_steps():
        first = next(float(s) for s, _ in seq if s == step)
        assert port.restore(step=step)["a"].tolist() == [first, first]


def test_restore_puts_tensors_on_the_template_and_checks_it(tmp_path):
    mgr = CheckpointManager(tmp_path, monitor=None)
    state = {"step": 3, "w": torch.arange(4.0),
             "opt": {"state": {0: {"exp_avg": torch.ones(4)}},
                     "param_groups": [{"lr": 1e-3, "params": [0]}]}}
    assert mgr.save(3, state)
    assert not mgr.save(3, {"step": 4})
    template = {"step": 0, "w": torch.zeros(4, dtype=torch.float32),
                "opt": {"state": {}, "param_groups": [{"lr": 0.0,
                                                       "params": [0]}]}}
    got = mgr.restore(template)
    assert got["step"] == 3 and torch.equal(got["w"], state["w"])
    assert torch.equal(got["opt"]["state"][0]["exp_avg"], torch.ones(4))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(5)})
    with pytest.raises(ValueError, match="lacks"):
        mgr.restore({"missing": torch.zeros(1)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3"]
    assert sorted(p.name for p in (tmp_path / "3").iterdir()) == [
        "state.pt"]
