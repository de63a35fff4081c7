"""The port's FVD pipeline smoke (``probes/parity_fvd.py``) on the CPU with
the arguments of ``tests/test_parity_fvd.py``: sample -> decode -> I3D at
224 px -> Fréchet on random weights, one JSON line on stdout."""
import json

import numpy as np

from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import parity_fvd

ARGS = ["--num-clips", "4", "--batch", "4", "--frames", "2",
        "--resolution", "16", "--codes", "16", "--embedding-dim", "8",
        "--hiddens", "16", "--res-layers", "1", "--downsample", "1", "4",
        "4", "--steps", "4", "--layers", "1", "--embd", "16", "--heads",
        "4", "--cond-dim", "32"]


def test_parity_fvd_random_init_smoke(capsys):
    out = parity_fvd.main(ARGS + ["--device", "cpu"])
    assert out["num_clips"] == 4 and out["device"] == "cpu"
    assert not out["pretrained_weights"] and "NOT comparable" in out["note"]
    assert np.isfinite(out["fvd"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == out
    # seeded: the same run gives the same number
    assert parity_fvd.main(ARGS + ["--device", "cpu"])["fvd"] == out["fvd"]
