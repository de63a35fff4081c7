"""How many base-2 exponentials a second the card takes, by the way they are
issued (``csrc/exp_probe.cu``): one a special-function slot in f32, two
packed f16 an instruction, a polynomial on the FMA pipe, and half and half.
The self-attention phase of ``csrc/megakernel_step.cu`` is planned from it.

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.exp_probe \
        [--out FILE.json]

Needs a CUDA device; prints one JSON object (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..ops import cuda_build

MODES = {"ex2_f32": 0, "ex2_f16x2": 1, "poly_fma": 2, "half_sfu_half_poly": 3}
_ITERS = 4096
_PER_ROUND = 8


def probe() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("exp_probe needs a CUDA device")
    lib = cuda_build.load("exp_probe.cu")
    lib.exp_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]
    lib.exp_probe.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * 8
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for name, mode in MODES.items():
        times = []
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = lib.exp_probe(out.data_ptr(), mode, blocks, _ITERS, stream)
            end.record()
            if err:
                raise RuntimeError(f"exp_probe launch failed: cudaError {err}")
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = min(times[1:])
        n = blocks * 256 * _ITERS * _PER_ROUND
        res[name] = {"ms": ms, "exps_per_s": n / (ms * 1e-3),
                     "exps_per_s_per_sm": n / (ms * 1e-3) / sms}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.strip(),
            "sms": sms, "blocks": blocks, "iters": _ITERS, "modes": res}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out")
    args = ap.parse_args()
    res = probe()
    text = json.dumps(res, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
