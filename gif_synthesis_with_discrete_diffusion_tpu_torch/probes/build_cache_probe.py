"""Does a second process reuse the kernels' builds?

The counterpart of ``scripts/compile_cache_probe.py`` for an NVIDIA card.
The port builds its CUDA sources with nvcc at first use (``ops/cuda_build
.py``: a shared library named by a hash of source and flags). This probe
runs two child processes in turn on one fresh build directory:

* phase A: builds ``csrc/probe_kernels.cu`` and runs the probe product
  (P1), then builds ``csrc/sample_step.cu`` and launches the sampler-step
  kernel (K1) once; records the builds' and first calls' times;
* phase B: the same, in a new process on the same directory.

The verdict says whether B ran no nvcc for either library and still
computed the right values (each kernel against its plain version, in both
phases). A child that hangs is a failure with its traceback
(``faulthandler``), not something to wait out.

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.build_cache_probe [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import card_line, require_cuda

__all__ = ["run_child", "verdict", "probe", "main"]

_ROOT = Path(__file__).resolve().parents[2]
_PKG = Path(__file__).resolve().parents[1].name

_CHILD = r"""
import faulthandler, json, os, sys, time
from pathlib import Path
faulthandler.dump_traceback_later(int(os.environ["PROBE_HANG_DUMP_S"]),
                                  exit=True)
sys.path.insert(0, os.environ["PROBE_ROOT"])
import torch
from PKG.models.d3pm import make_schedule
from PKG.ops import cuda_build
from PKG.ops import probe_kernels as pk
from PKG.ops import sampler_kernel as sk

build_dir = os.environ["PROBE_BUILD_DIR"]
# every build of this process goes to the probe's directory
cuda_build.BUILD_DIR = Path(build_dir)
count = lambda d: sum(len(f) for _, _, f in os.walk(d))
torch.backends.cuda.matmul.allow_tf32 = False
out = {"device": torch.cuda.get_device_name(0)}
torch.cuda.init()
torch.zeros(1, device="cuda")

# P1: the nvcc build and the first launch
a = torch.ones((256, 256), device="cuda")
t0 = time.perf_counter()
o = pk.probe_matmul(a, build_dir=build_dir)
value = float(o.sum())
out["p1_first_call_s"] = time.perf_counter() - t0
out["nvcc_build_s"] = pk._library(build_dir).build_seconds
out["p1_sum"] = value
out["p1_right"] = bool(torch.equal(o, pk.probe_matmul_reference(a)))

# K1: the nvcc build and the first launch (argmax mode, a small shape)
k, b, length = 4097, 2, 256
g = torch.Generator(device="cuda").manual_seed(0)
logits2 = (3.0 * torch.randn((2 * b, length, k - 1), generator=g,
                             device="cuda")).transpose(1, 2)
tokens = torch.randint(0, k, (b, length), generator=g, device="cuda")
row = sk.schedule_rows(make_schedule(100, k, device="cuda"))[50]
kw = dict(guidance=2.0, num_classes=k, sample=False, return_posterior=True)
t0 = time.perf_counter()
tok, post = sk.fused_sample_step(logits2, tokens, row, 5, **kw)
torch.cuda.synchronize()
out["k1_first_call_s"] = time.perf_counter() - t0
out["k1_nvcc_build_s"] = sk._library().build_seconds
tok_p, post_p = sk.fused_sample_step_reference(logits2, tokens, row, 5, **kw)
top2 = post_p.topk(2, dim=1).values
decided = (top2[:, 0] - top2[:, 1]) > 1e-4
out["k1_token_sum"] = int(tok.sum())
out["k1_right"] = bool(((post - post_p).abs().max() <= 1e-4)
                       and not ((tok != tok_p) & decided).any())

# both again: free either way
t0 = time.perf_counter()
float(pk.probe_matmul(a, build_dir=build_dir).sum())
sk.fused_sample_step(logits2, tokens, row, 5, **kw)
torch.cuda.synchronize()
out["second_calls_s"] = time.perf_counter() - t0
out["p1_launches"] = pk.probe_matmul.launches
out["k1_launches"] = sk.fused_sample_step.launches
out["build_files"] = count(build_dir)
print("PROBE_RESULT " + json.dumps(out))
""".replace("PKG", _PKG)


def run_child(build_dir: str, timeout: float, hang_dump_s: int) -> dict:
    """One phase: a new Python process on the build directory. Returns its
    readings, or ``ok: False`` with the tail of its output (``hung: True``
    when it had to be killed at ``timeout``)."""
    env = dict(os.environ, PROBE_BUILD_DIR=build_dir, PROBE_ROOT=str(_ROOT),
               PROBE_HANG_DUMP_S=str(hang_dump_s))
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        tail = e.stderr or e.stdout or b""
        tail = tail.decode(errors="replace") if isinstance(tail, bytes) \
            else str(tail)
        return {"ok": False, "hung": True,
                "wall_s": time.perf_counter() - t0, "tail": tail[-2000:]}
    res = {"ok": r.returncode == 0, "hung": False,
           "wall_s": time.perf_counter() - t0}
    for line in r.stdout.splitlines():
        if line.startswith("PROBE_RESULT "):
            res.update(json.loads(line[len("PROBE_RESULT "):]))
    if r.returncode != 0:
        res["tail"] = (r.stdout[-800:] + "\n--- stderr ---\n"
                       + r.stderr[-2000:])
    return res


def verdict(a: dict, b: dict) -> tuple[bool, str]:
    """(reused, sentence) from the two phases' readings."""
    if a.get("hung") or b.get("hung"):
        return False, ("HANG: phase " + ("A" if a.get("hung") else "B")
                       + " stalled; see its tail")
    if not (a.get("ok") and b.get("ok")):
        return False, "probe error: see the tails"
    right = all(p.get("p1_right") and p.get("k1_right") for p in (a, b)) \
        and a["p1_sum"] == b["p1_sum"] \
        and a["k1_token_sum"] == b["k1_token_sum"]
    if not right:
        return False, "WRONG VALUES: a kernel disagrees with its plain version"
    rebuilt = [name for name, key in (("the probe kernels", "nvcc_build_s"),
                                      ("the sampler kernel",
                                       "k1_nvcc_build_s"))
               if not (a[key] > 0 and b[key] == 0)]
    if not rebuilt:
        return True, ("BUILDS REUSED: phase B ran no nvcc for either "
                      "library, and computed the same, right values")
    return False, "right values, but phase B rebuilt " + " and ".join(rebuilt)


def probe(timeout: float = 300.0, hang_dump_s: int = 240, log=print) -> dict:
    """Run both phases on fresh directories and return
    ``{a, b, reused, verdict, card}``."""
    require_cuda("the build-cache probe")
    with tempfile.TemporaryDirectory(prefix="buildprobe_") as top:
        build = os.path.join(top, "build")
        os.makedirs(build)
        log("phase A (a fresh directory)...")
        a = run_child(build, timeout, hang_dump_s)
        log(json.dumps(a))
        log("phase B (the same directory, a new process)...")
        b = run_child(build, timeout, hang_dump_s)
        log(json.dumps(b))
    reused, sentence = verdict(a, b)
    log(sentence)
    return {"a": a, "b": b, "reused": reused, "verdict": sentence,
            "card": card_line()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="write the JSON object to this path")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--hang-dump-s", type=int, default=240)
    args = p.parse_args(argv)
    out = probe(args.timeout, args.hang_dump_s)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if out["a"].get("ok") and out["b"].get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
