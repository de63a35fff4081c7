"""Measurement probes of the card, run as modules:

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.depth_pack_probe
    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.build_cache_probe

Each prints its findings and one JSON object, and with ``--out PATH`` writes
the object there. Both need a CUDA device.
"""
from __future__ import annotations

import subprocess

__all__ = ["card_line", "require_cuda"]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def require_cuda(what: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures a CUDA device: "
                           "torch.cuda.is_available() is False")
