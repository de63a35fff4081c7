"""The sampler step K1 (``csrc/sample_step.cu``) and the codebook lookup K6
(``csrc/nearest_code_stats.cu``) timed at the paths' shapes against the
kernels of another checkout and against design variants of either, in
turns on one card.

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.sampler_codebook_variants \\
        [--parent ROOT] [--variant NAME ...] [--rounds N] [--out FILE.json]

K1 at 2B=64, K=4097, L=1024, guidance 2, sampled (one reverse step of the
``model`` route at B=32); K6 at N=16384, K=4096, D=128 (the frozen encode of
a training step). ``--parent ROOT`` adds the kernels of the checkout at ROOT,
run in a child process of their own started there (this file loaded by its
path), on the same inputs (made on the card from fixed seeds). A variant
(``VARIANTS``: the designs that were tried and lost) is a copy of its
kernel's source with the variant's text replacements, built beside the
shipped build and first held against the plain version; the shipped source
carries no switch for it. A round is parent, this checkout, the
variants, this checkout, parent. CUDA events over ``ITERS`` launches after a
warm-up. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

PKG = "gif_synthesis_with_discrete_diffusion_tpu_torch"
_ROOT = Path(__file__).resolve().parents[2]
ITERS = 20
# the paths' shapes
SHAPES = {"K1": (64, 4097, 1024), "K6": (16384, 4096, 128)}
# each kernel's source, wrapper module and exported launcher
SOURCES = {"K1": ("sample_step.cu", "sampler_kernel",
                  ("fused_sample_step", "sample_step_blocks_per_sm")),
           "K6": ("nearest_code_stats.cu", "codebook_kernel",
                  ("nearest_code_stats",))}
_BOUNDS = "__launch_bounds__(kThreads, C <= 4 ? 4 : 2)"
# name -> (kernel, ((old text, new text), ...)): each old text occurs once
VARIANTS = {
    # K1 at most 80 registers a thread up to K-1 = 4096: three blocks an SM
    "k1_blocks3": ("K1", ((_BOUNDS, "__launch_bounds__(kThreads, C <= 2 ? 4 "
                                    ": (C == 4 ? 3 : 2))"),)),
    # K1 with 512 threads a block (8 + 8 floats a thread), two an SM
    "k1_threads512": ("K1", (("constexpr int kThreads = 256;",
                              "constexpr int kThreads = 512;"),
                             (_BOUNDS, "__launch_bounds__(kThreads, 2)"))),
    # K6 at D <= 128 with 64 rows a block and a warp on 32 rows x 64 codes
    # (fewer shared-memory bytes an mma, 256 codes a tile)
    "k6_rows64": ("K6", (("constexpr int kNt = 4; ",
                          "constexpr int kNt = 8; "),
                         ("? launch<4, 2, 64, 2>", "? launch<2, 2, 64, 2>"))),
    # K6 at D <= 128 staging E 32 dims at a time in a ring of three or four
    # (twice the block barriers)
    "k6_chunk32": ("K6", (("? launch<4, 2, 64, 2>",
                           "? launch<4, 2, 32, 3>"),)),
    "k6_chunk32x4": ("K6", (("? launch<4, 2, 64, 2>",
                             "? launch<4, 2, 32, 4>"),)),
}


def _ms(torch, fn, iters: int = ITERS) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _k1_inputs(torch, sk, d3pm):
    nb, k, length = SHAPES["K1"]
    g = torch.Generator(device="cuda").manual_seed(5)
    logits2 = torch.randn((nb, length, k - 1), generator=g,
                          device="cuda").transpose(1, 2)
    tokens = torch.full((nb // 2, length), k - 1, dtype=torch.int64,
                        device="cuda")
    row = sk.schedule_rows(d3pm.make_schedule(100, k, device="cuda"))[50]
    return logits2, tokens, row


def time_kernels(kernels=("K1", "K6")) -> dict:
    """{kernel: ms} of the kernels of the checkout whose package is first on
    ``sys.path``."""
    import torch
    d3pm = __import__(PKG + ".models.d3pm", fromlist=["d3pm"])
    sk = __import__(PKG + ".ops.sampler_kernel", fromlist=["sampler_kernel"])
    ck = __import__(PKG + ".ops.codebook_kernel", fromlist=["codebook"])
    out = {}
    if "K1" in kernels:
        logits2, tokens, row = _k1_inputs(torch, sk, d3pm)
        out["K1"] = _ms(torch, lambda: sk.fused_sample_step(
            logits2, tokens, row, 3, guidance=2.0,
            num_classes=SHAPES["K1"][1], sample=True))
        del logits2
    if "K6" in kernels:
        n, k, d = SHAPES["K6"]
        g = torch.Generator(device="cuda").manual_seed(9)
        x = torch.randn((n, d), generator=g, device="cuda")
        emb = torch.randn((k, d), generator=g, device="cuda")
        out["K6"] = _ms(torch, lambda: ck.nearest_code_stats(x, emb))
    return out


def _child() -> None:
    sys.path.insert(0, os.getcwd())
    print(json.dumps(time_kernels()))


def run_in(root: str) -> dict:
    """:func:`time_kernels` in a child process started in ``root``."""
    env = dict(os.environ)
    # a checkout whose K1 is a Triton kernel keeps its cache in its build
    env.setdefault("TRITON_CACHE_DIR",
                   str(Path(root).resolve() / PKG / "_build" / "triton"))
    run = subprocess.run(
        [sys.executable, "-c",
         "import importlib.util as u; s = u.spec_from_file_location('probe', "
         f"{os.path.abspath(__file__)!r}); m = u.module_from_spec(s); "
         "s.loader.exec_module(m); m._child()"],
        cwd=root, env=env, capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"the child in {root} failed:\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def _module(kernel: str):
    return __import__(f"{PKG}.ops.{SOURCES[kernel][1]}", fromlist=["ops"])


def build_variant(name: str) -> ctypes.CDLL:
    """The variant's kernel built from a copy of its source with the
    variant's replacements, the shipped build's argument types bound to
    it."""
    from ..ops import cuda_build
    kernel, edits = VARIANTS[name]
    source, _, fns = SOURCES[kernel]
    text = (cuda_build.CSRC / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: the text to replace is not "
                               f"once in {source}")
        text = text.replace(old, new)
    out = cuda_build.BUILD_DIR / f"variant_{name}"
    out.mkdir(parents=True, exist_ok=True)
    (out / source).write_text(text)
    so = out / (source[:-3] + ".so")
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-o", str(so), str(out / source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    shipped = _module(kernel)._library()
    for fn in fns:
        getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.build_log = proc.stdout + proc.stderr
    return lib


def _check_k6(torch, ck) -> float:
    """The rows of the loaded K6 whose index differs from the plain
    version's at the path's shape (the inputs of :func:`time_kernels`)."""
    n, k, d = SHAPES["K6"]
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((n, d), generator=g, device="cuda")
    emb = torch.randn((k, d), generator=g, device="cuda")
    got = ck.nearest_code_stats(x, emb)[0]
    return float((got != ck.nearest_code_stats_reference(x, emb)[0]).sum())


def _check_k1(torch, sk, d3pm) -> float:
    """The largest posterior error of the loaded K1 against the plain
    version at one guided case."""
    k = SHAPES["K1"][1]
    g = torch.Generator(device="cuda").manual_seed(1)
    logits2 = (3.0 * torch.randn((8, 512, k - 1), generator=g,
                                 device="cuda")).transpose(1, 2)
    tokens = torch.randint(0, k, (4, 512), generator=g, device="cuda")
    row = sk.schedule_rows(d3pm.make_schedule(100, k, device="cuda"))[30]
    kw = dict(guidance=2.0, num_classes=k, sample=False,
              return_posterior=True)
    got = sk.fused_sample_step(logits2, tokens, row, 3, **kw)[1]
    want = sk.fused_sample_step_reference(logits2, tokens, row, 3, **kw)[1]
    return float((got - want).abs().max())


@contextlib.contextmanager
def _launching(kernel: str, lib):
    """The kernel's wrapper launches from ``lib`` inside the block."""
    mod = _module(kernel)
    shipped = mod._library
    mod._library = lambda: lib
    try:
        yield mod
    finally:
        mod._library = shipped


def compare(parent: str | None = None, variants=(), rounds: int = 2,
            log=print) -> dict:
    """The rounds in turns; returns each side's readings, their means, the
    card and, for the variants, their registers and errors."""
    import torch
    from . import card_line, require_cuda
    from ..models import d3pm
    require_cuda("sampler_codebook_variants")
    result = {"card": card_line(), "shapes": SHAPES, "ms": {},
              "variants": {}}
    libs = {}
    for name in variants:
        libs[name] = build_variant(name)
        kernel = VARIANTS[name][0]
        with _launching(kernel, libs[name]) as mod:
            check = (
                {"max_abs_err": _check_k1(torch, mod, d3pm),
                 "blocks_per_sm": libs[name].sample_step_blocks_per_sm(4096)}
                if kernel == "K1" else
                {"index_mismatches": _check_k6(torch, mod)})
        result["variants"][name] = dict(
            check, ptxas=[x.strip() for x in libs[name].build_log.splitlines()
                          if "registers" in x or "spill" in x])
        log(f"{name}: {json.dumps(result['variants'][name])}")
    result["blocks_per_sm"] = \
        _module("K1")._library().sample_step_blocks_per_sm(4096)
    here = ["change", *variants, "change"]
    for r in range(rounds):
        sides = ([parent] if parent else []) + here + (
            [parent] if parent else [])
        for side in sides:
            if side == parent:
                name, ms = "parent", run_in(parent)
            elif side == "change":
                name, ms = "change", time_kernels()
            else:
                name = side
                kernel = VARIANTS[side][0]
                with _launching(kernel, libs[side]):
                    ms = time_kernels((kernel,))
            result["ms"].setdefault(name, []).append(ms)
            log(f"round {r} {name}: " + " ".join(
                f"{k} {v:.4f} ms" for k, v in ms.items()))
    result["mean_ms"] = {
        side: {k: sum(x[k] for x in v) / len(v) for k in v[0]}
        for side, v in result["ms"].items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", default=None, metavar="ROOT")
    p.add_argument("--variant", action="append", default=[],
                   choices=sorted(VARIANTS))
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    result = compare(args.parent, args.variant, args.rounds)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
