"""The port's sweep entry (``..._torch/sweep.py``) against the JAX
package's ``scripts/sweep.py``, loaded by path: the same grid, random and
TPE trial lists for the same arguments and seeds, the same TPE proposals
from the same history, TPE's convergence cases of ``tests/test_sweep.py``,
and two trials end to end on the CPU."""
import math
import runpy
from pathlib import Path

import pytest

from gif_synthesis_with_discrete_diffusion_tpu_torch import sweep

_SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "sweep.py"
_jax = runpy.run_path(str(_SCRIPT), run_name="_sweep_module")


@pytest.mark.parametrize("val", ["1e-4,4e-4", "[1,4,4]", "[1,4,4],[2,8,8]",
                                 "{a:1,b:2},x", "(1,2),3", "plain", ""])
def test_split_grid_equals_jax(val):
    assert sweep._split_grid(val) == _jax["_split_grid"](val)


def test_grid_and_random_trials_equal_jax():
    grid = ["a=1,2", "b=x", "c=3,4", "d=[1,4,4],[2,8,8]"]
    assert list(sweep._grid_trials(grid)) == list(_jax["_grid_trials"](grid))
    assert list(sweep._grid_trials(["k=v"])) == [["k=v"]]
    ranges = ["lr=1e-5:1e-2:log", "fixed=7", "w=0:1"]
    for seed in (0, 3):
        assert (list(sweep._random_trials(ranges, 16, seed=seed))
                == list(_jax["_random_trials"](ranges, 16, seed=seed)))
    assert (sweep._parse_tpe_space(ranges + ["bs=16,32"])
            == _jax["_parse_tpe_space"](ranges + ["bs=16,32"]))


def _objective(p):
    return (math.log10(p["lr"]) + 3) ** 2 + (p["opt"] != "good") \
        + (p["w"] - 0.3) ** 2


def test_tpe_proposals_equal_jax_from_the_same_history():
    specs = [("lr", "num", (1e-5, 1e-1, True)), ("w", "num", (0.0, 1.0,
                                                             False)),
             ("opt", "cat", ["good", "bad", "worse"])]
    ours, theirs = sweep._TPESampler(specs, seed=2), \
        _jax["_TPESampler"](specs, seed=2)
    for _ in range(30):
        p, q = ours.suggest(), theirs.suggest()
        assert p == q
        ours.tell(p, _objective(p))
        theirs.tell(q, _objective(q))
    # a NaN trial (a failed one) is dropped by both
    ours.tell(ours.suggest(), float("nan"))
    theirs.tell(theirs.suggest(), float("nan"))
    assert ours.suggest() == theirs.suggest()


def test_tpe_converges_on_quadratic():
    """tests/test_sweep.py's case: near the optimum of (x - 0.7)^2 within
    40 trials, late suggestions closer than the startup's."""
    tpe = sweep._TPESampler([("x", "num", (0.0, 1.0, False))], seed=0)
    for _ in range(40):
        p = tpe.suggest()
        tpe.tell(p, (p["x"] - 0.7) ** 2)
    xs = [h[1]["x"] for h in tpe.history]
    assert min(h[0] for h in tpe.history) < 1e-3
    assert sum(abs(x - 0.7) for x in xs[-10:]) < \
        sum(abs(x - 0.7) for x in xs[:10]) / 2


def test_tpe_log_and_categorical():
    """tests/test_sweep.py's case: the best lr near 1e-3 across decades and
    the good category dominating late suggestions."""
    specs = [("lr", "num", (1e-5, 1e-1, True)),
             ("opt", "cat", ["good", "bad"])]
    tpe = sweep._TPESampler(specs, seed=1)
    for _ in range(40):
        p = tpe.suggest()
        tpe.tell(p, abs(math.log10(p["lr"]) + 3)
                 + (0.0 if p["opt"] == "good" else 1.0))
    assert sum(1 for h in tpe.history[-10:] if h[1]["opt"] == "good") >= 7
    best_lr = min(tpe.history, key=lambda h: h[0])[1]["lr"]
    assert 2e-4 < best_lr < 5e-3


TINY = [
    "datamodule=synthetic", "batch_size=8", "datamodule.resolution=16",
    "datamodule.sequence_length=2", "datamodule.num_train=16",
    "datamodule.num_val=8", "trainer.max_epochs=1", "trainer.platform=cpu",
    "model.generator.n_codes=16", "model.generator.n_hiddens=16",
    "model.generator.n_res_layers=1", "model.generator.downsample=[1,4,4]",
    "model.generator.embedding_dim=8", "model.do_evaluation=false",
    "extras.print_config=false",
]


def test_sweep_two_trials_end_to_end(tmp_path, capsys):
    """A grid over the seed and max_steps: four trials in this process, of
    which the two with ``max_steps=bad`` fail; the sweep goes on and prints
    the best trial last."""
    rc = sweep.main(TINY + [f"paths.output_dir={tmp_path}", "seed=0,1",
                            "trainer.max_steps=1,bad"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("best trial ")
    assert "total/val=" in lines[-1]
    assert len([p for p in tmp_path.iterdir() if p.is_dir()]) >= 1
    best = int(lines[-1].split()[2].rstrip(":"))
    assert best in (0, 2)   # the trials with max_steps=bad fail
