"""The whole-step kernels' phases of ``chip_smoke.py`` alone (8: K3, 9: K4,
10: the serving slice on the megakernel route), from the checkout given: for
timing two trees in turns on one card.

    python <this file> <root of a checkout> [<root> ...]

Each root's ``chip_smoke.py`` and package are loaded in a process of their
own, so every tree builds and runs its own kernels. Needs a CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time


def run(root: str) -> None:
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    pkg = "gif_synthesis_with_discrete_diffusion_tpu_torch"
    t0 = time.perf_counter()
    smi = cs.phase_environment(torch)
    generate = __import__(pkg + ".generate", fromlist=["generate"])
    honest = generate.build_models(generate.HONEST, "cuda",
                                   torch.Generator().manual_seed(0))
    msrvtt = generate.build_models(generate.MSRVTT_GRID, "cuda",
                                   torch.Generator().manual_seed(0))
    cs.phase_k3(torch, smi, honest)
    cs.phase_k4(torch, smi, msrvtt)
    cs.phase_megakernel_route(torch, smi, honest, msrvtt)
    print(f"{root}: phases 8-10 in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    roots = sys.argv[1:]
    if not roots:
        print(__doc__)
        return 2
    if len(roots) == 1:
        run(roots[0])
        return 0
    for root in roots:
        print(f"=== {root}", flush=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             root]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
