"""Variants of ``csrc/megakernel_step.cu`` built beside the real one and
timed by phase at the serving shapes: how the redesign's choices (the share
of phase S's exponentials taken by polynomial) and its ablations (a sweep
left out, the exponentials replaced by an add) move a step's time.

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.\\
megakernel_variants [DEFINES ...]

Each argument is a comma-separated list of preprocessor defines of one
variant (``MK_POLY1=6``, ``MK_ABLATE=1``, ``MK_POLY1=4,MK_POLY2=2``; ``-``
is the source as it stands). With none, the set that ``PERF.md`` quotes.
Run from the root of the checkout (it drives ``chip_smoke.py``'s timing
functions); needs a CUDA device. A variant with bits 0-2 of ``MK_ABLATE``
computes wrong tokens: it is timed, never checked.
"""
from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..generate import HONEST, MSRVTT_GRID, build_models
from ..ops import megakernel as mk

DEFAULT = ("-", "MK_POLY1=0", "MK_POLY1=2", "MK_POLY1=6",
           "MK_POLY1=4,MK_POLY2=2", "MK_ABLATE=8", "MK_ABLATE=1",
           "MK_ABLATE=2", "MK_ABLATE=3", "MK_ABLATE=4")


def _defines(arg: str) -> tuple[str, ...]:
    return tuple(d for d in arg.split(",") if d not in ("", "-"))


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("megakernel_variants needs a CUDA device")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    variants = tuple(sys.argv[1:]) or DEFAULT
    with ThreadPoolExecutor(8) as pool:       # one nvcc a variant, together
        list(pool.map(lambda v: mk._library(_defines(v)), variants))
    smi = cs.phase_environment(torch)
    honest = build_models(HONEST, "cuda", torch.Generator().manual_seed(0))
    msrvtt = build_models(MSRVTT_GRID, "cuda",
                          torch.Generator().manual_seed(0))
    # the first timing of a process reads high (the card's clocks): spend it
    cs._time_megakernel(torch, "variant", smi, "K3 warm-up", honest, 32, True,
                        defines=_defines(variants[0]))
    for variant in variants:
        for name, models, b, pack in (("K3", honest, 32, True),
                                      ("K4", msrvtt, 8, None)):
            args, tab, kw = cs._time_megakernel(
                torch, "variant", smi, f"{name} [{variant}]", models, b,
                pack, defines=_defines(variant))[4]
            cs._phase_times(torch, "variant", f"{name} [{variant}]", args,
                            tab, dict(kw, defines=_defines(variant)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
