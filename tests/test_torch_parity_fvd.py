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


def test_parity_fvd_reads_the_three_checkpoints(tmp_path):
    """``--vqvae`` and ``--d3pm`` as Lightning checkpoints under the
    reference's prefixes, ``--i3d`` a bare state dict, all of the models of
    the arguments but with other weights than the random init: the run
    says the weights are pretrained, and its FVD moves."""
    import argparse

    import torch

    import chip_smoke
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        build_models)
    # the model of ARGS
    args = argparse.Namespace(
        embedding_dim=8, codes=16, hiddens=16, res_layers=1,
        downsample=(1, 4, 4), frames=2, resolution=16, steps=4,
        guidance=2.0, layers=1, embd=16, heads=4, cond_dim=32)
    models = build_models(parity_fvd._config(args), "cpu",
                          torch.Generator().manual_seed(7))
    files = {"vqvae": tmp_path / "v.ckpt", "d3pm": tmp_path / "d.ckpt",
             "i3d": tmp_path / "i3d.pt"}
    chip_smoke.save_reference_file(
        files["vqvae"], chip_smoke._reference_keyed(
            "vqvae", models.vqvae.state_dict()), "generator.", True)
    chip_smoke.save_reference_file(
        files["d3pm"], chip_smoke._reference_keyed(
            "d3pm", models.generator.state_dict()),
        "generator.diffusion_model.", True)
    chip_smoke.save_reference_file(files["i3d"], chip_smoke._reference_keyed(
        "i3d", chip_smoke._i3d(torch.Generator().manual_seed(8))
        .state_dict()))
    flags = [x for k, f in files.items() for x in (f"--{k}", str(f))]
    out = parity_fvd.main(ARGS + flags + ["--device", "cpu"])
    assert out["pretrained_weights"] and out["note"] is None
    assert np.isfinite(out["fvd"])
    assert out["fvd"] != parity_fvd.main(ARGS + ["--device", "cpu"])["fvd"]
    # one file alone: random init elsewhere, and said so
    one = parity_fvd.main(ARGS + flags[:2] + ["--device", "cpu"])
    assert not one["pretrained_weights"] and "NOT comparable" in one["note"]
