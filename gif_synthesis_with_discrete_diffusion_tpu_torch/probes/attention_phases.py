"""The phases of ``chip_smoke.py`` whose paths run the attention kernels K2
and K5 (4: the serving slice on the ``model`` route; 7: the stage-2
training step at ``TRAIN_STEP2``), from the checkout given: for timing two
trees in turns on one card.

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
    t0 = time.perf_counter()
    smi = cs.phase_environment(torch)
    cs.phase_slice(torch, smi)
    cs.phase_train(torch, smi, profile=False)
    print(f"{root}: phases 4 and 7 in {time.perf_counter() - t0:.1f} s")


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
