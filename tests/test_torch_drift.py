"""The port's coupled bf16-weight drift protocol (``probes/drift_probe.py``,
after the JAX package's ``scripts/measure_drift.py``) against the bounds of
``tests/test_drift_bounds.py``: a small run on the CPU, and the committed
H100 measurement ``PARITY_DRIFT_H100.json``."""
import json
import os

from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
    drift_probe)
from tests.test_drift_bounds import BOUNDS
from tests.test_torch_slice import CONFIG

_ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "PARITY_DRIFT_H100.json")


def _within_bounds(coupled: dict) -> None:
    for key, bound in BOUNDS.items():
        assert coupled[key] <= bound, (key, coupled[key], bound)


def test_coupled_drift_on_the_cpu_within_bounds():
    """Every step of a small model's reverse process: side A (f32) and side
    B (bf16 weights, the whole-step kernels' plain version) see the same
    tokens and noise; the five statistics stay within the bounds."""
    out = drift_probe.coupled_drift(CONFIG, batch=3, steps=8, seed=1,
                                    device="cpu")
    assert out["config"]["steps_run"] == 8 == out["config"]["steps"]
    assert set(BOUNDS) <= set(out["coupled_per_step"])
    _within_bounds(out["coupled_per_step"])
    assert "kernel_vs_side_b" not in out          # no kernel on the CPU


def test_committed_h100_measurement_within_bounds():
    """The honest grid and the 2304-token grid, measured on an H100: within
    the bounds, and the whole-step kernels' argmax tokens equal side B's
    wherever decided."""
    with open(_ARTIFACT) as f:
        sections = json.load(f)["sections"]
    tokens = {s["config"]["tokens"] for s in sections.values()}
    assert {1024, 2304} <= tokens
    for name, section in sections.items():
        assert "H100" in section["config"]["device"], name
        _within_bounds(section["coupled_per_step"])
        assert section["kernel_vs_side_b"]["token_mismatches"] == 0, name
