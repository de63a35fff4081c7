"""The probe product P1 and the chain P2 (``csrc/probe_kernels.cu``) timed
against the kernels of another checkout and against design variants, in
turns on one card; P3 beside them.

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.probe_kernel_variants \\
        [--parent ROOT] [--variant NAME ...] [--rounds N] [--out FILE.json]

P1 at (256, 256) f32 under a CUDA graph (25 launches a graph, the replays
timed by CUDA events, as ``chip_smoke._graph_turns``), with
``torch.addmm(beta=0, alpha=2)`` graphed the same way beside it; P2 at the
QK shape (256, 64) x (64, 16384) and at the depth / packing probe's other
one-chain shapes, and P3 at the QK shape, each one launch of the probe's
2000 iterations on the probe's own operands (the least of 2 after a warm
one). ``--parent ROOT`` adds the kernels of the checkout at ROOT, run in a
child process of their own started there (this file loaded by its path),
on the same inputs. A variant (``VARIANTS``: the designs that were tried
and lost) is a copy of the source with the variant's text replacements,
built beside the shipped build and first held against the plain versions;
the shipped source carries no switch for it. A round is parent, this
checkout, the variants, this checkout, parent. Needs a CUDA device.
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
SOURCE = "probe_kernels.cu"
# the launchers a variant's library must export
FUNCTIONS = ("probe_matmul", "probe_chain_design", "probe_chain")
ITERS = 2000          # scripts/depth_pack_probe.py's iterations a launch
P1_N = 256
GRAPH_LAUNCHES = 25
# name -> (m, k, n) of a one-chain reading; "P2" is the QK shape
CHAINS = {"P2": (256, 64, 16384),
          "P2 k=64 n=2048": (256, 64, 2048),
          "P2 k=128 n=2048": (256, 128, 2048),
          "P2 k=256 n=2048": (256, 256, 2048),
          "P2 k=512 n=2048": (256, 512, 2048),
          "P2 k=128 n=32768": (256, 128, 32768)}
PAIR = ("P3", (256, 64, 16384))
# the product of the first local design: x's fragments from shared memory
_X_FROM_SHARED = """template <int K>
__device__ __forceinline__ void warp_product_x(
    float (&acc)[2][8][4], const __nv_bfloat16* xs, int row0,
    const __nv_bfloat16* ws, int ws_ld, int ct, int width, int lane) {
  zero_acc(acc);
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], xs + (row0 + mt * 16 + (lane & 15)) * (K + kPad) +
                             kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (ct + np * 16 < width) {
        unsigned b[4];
        ldmatrix_x4_trans(b, ws + (kk + (lane & 15)) * ws_ld + ct + np * 16 +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

"""
# name -> ((old text, new text), ...): each old text occurs once
VARIANTS = {
    # P1 with a ring of two stages: half the loads in flight at n = 256
    "p1_stages2": (("constexpr int kP1Stages = 4; ",
                    "constexpr int kP1Stages = 2; "),),
    # P1 with four warps a block splitting each chunk's depth (128 threads)
    "p1_splits4": (("constexpr int kP1Splits = 8; ",
                    "constexpr int kP1Splits = 4; "),),
    # P2's local design with a block barrier closing each iteration, where
    # the shipped loop has warp barriers only
    "p2_block_barrier": (("      __syncwarp();  // the next x is whole\n",
                          "      __syncthreads();  // the next x is whole\n"),),
    # P2's local design reading x's fragments from shared memory for every
    # product (head and each slab sub-tile), where the shipped loop reads
    # them into registers once an iteration
    "p2_x_from_shared": (
        ("template <int K>\n__global__ void __launch_bounds__(kThreads, 1)\n"
         "chain_local_kernel(LocalParams p) {",
         _X_FROM_SHARED + "template <int K>\n__global__ void "
         "__launch_bounds__(kThreads, 1)\nchain_local_kernel(LocalParams p) {"),
        ("warp_product<K>(acc, a, hs, x_ld, hp * kSub, K, lane);",
         "warp_product_x<K>(acc, xs, row0, hs, x_ld, hp * kSub, K, lane);"),
        ("warp_product<K>(acc, a, ws, ws_ld, ct, width, lane);",
         "warp_product_x<K>(acc, xs, row0, ws, ws_ld, ct, width, lane);")),
}


def _ms(torch, fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graphed(torch, fn, launches: int = GRAPH_LAUNCHES):
    """``launches`` calls of fn captured in one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def time_kernels() -> dict:
    """{reading: ms} of the kernels of the checkout whose package is first
    on ``sys.path``: P1 and ``torch.addmm`` a launch under a CUDA graph
    (mean of 6 readings of 4 replays each, in turns), every chain a launch
    of :data:`ITERS` iterations."""
    import torch
    pk = __import__(PKG + ".ops.probe_kernels", fromlist=["probe_kernels"])
    dp = __import__(PKG + ".probes.depth_pack_probe", fromlist=["probe"])
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    a = torch.ones((P1_N, P1_N), device="cuda")
    zero = torch.zeros_like(a)
    graphs = {"P1": _graphed(torch, lambda: pk.probe_matmul(a)),
              "addmm": _graphed(torch, lambda: torch.addmm(
                  zero, a, a, beta=0.0, alpha=2.0))}
    readings = {name: [] for name in graphs}
    for r in range(6):
        for name in (("P1", "addmm") if r % 2 == 0 else ("addmm", "P1")):
            readings[name].append(
                _ms(torch, graphs[name].replay, 4) / GRAPH_LAUNCHES)
    for name, vals in readings.items():
        out[name] = sum(vals) / len(vals)
    del graphs

    def chain_ms(launch) -> float:
        launch()
        return min(_ms(torch, launch, 1) for _ in range(2))

    for name, (m, k, n) in (*CHAINS.items(), PAIR):
        x, w1, w2 = (torch.from_numpy(v).to(torch.bfloat16).to("cuda")
                     for v in dp.probe_inputs(m, k, n))
        if name == PAIR[0]:
            out[name] = chain_ms(lambda: pk.pair_matmul(x, w1, w2, ITERS))
        else:
            out[name] = chain_ms(lambda: pk.chain_matmul(x, w1, ITERS))
    return out


def _child() -> None:
    sys.path.insert(0, os.getcwd())
    print(json.dumps(time_kernels()))


def run_in(root: str) -> dict:
    """:func:`time_kernels` in a child process started in ``root``."""
    run = subprocess.run(
        [sys.executable, "-c",
         "import importlib.util as u; s = u.spec_from_file_location('probe', "
         f"{os.path.abspath(__file__)!r}); m = u.module_from_spec(s); "
         "s.loader.exec_module(m); m._child()"],
        cwd=root, capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"the child in {root} failed:\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def variant_text(name: str, text: str) -> str:
    """The source ``text`` with the variant's replacements; raises where an
    old text does not occur exactly once."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: the text to replace is not "
                               f"once in {SOURCE}")
        text = text.replace(old, new)
    return text


def build_variant(name: str) -> ctypes.CDLL:
    """The variant built from a copy of the source, the shipped build's
    argument types bound to it."""
    from ..ops import cuda_build, probe_kernels as pk
    text = variant_text(name, (cuda_build.CSRC / SOURCE).read_text())
    out = cuda_build.BUILD_DIR / f"variant_{name}"
    out.mkdir(parents=True, exist_ok=True)
    (out / SOURCE).write_text(text)
    so = out / (SOURCE[:-3] + ".so")
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-o", str(so), str(out / SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    shipped = pk._library()
    for fn in FUNCTIONS:
        getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.build_log = proc.stdout + proc.stderr
    return lib


@contextlib.contextmanager
def _launching(lib):
    """The wrappers launch from ``lib`` inside the block."""
    from ..ops import probe_kernels as pk
    shipped = pk._library
    pk._library = lambda *args: lib
    try:
        yield pk
    finally:
        pk._library = shipped


def check_loaded(torch, pk) -> dict:
    """The loaded kernels against their plain versions: P1's max-abs error
    relative to the plain max-abs at n = 256 and 300, and P2's final x and
    sum at the QK shape and a depth-curve shape, 3 iterations from an x of
    N(0, 1) (later x is 0 in bf16)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    p1 = 0.0
    for n in (256, 300):
        a = torch.randn((n, n), generator=g, device="cuda")
        want = pk.probe_matmul_reference(a)
        p1 = max(p1, float((pk.probe_matmul(a) - want).abs().max()
                           / want.abs().max()))
    x_err = sum_err = 0.0
    for m, k, n in ((256, 64, 16384), (256, 128, 2048)):
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device="cuda") / k).to(
            torch.bfloat16)
        got = pk.chain_matmul(x, w, 3, return_x=True)
        want = pk.chain_reference(x, w, 3, return_x=True)
        xw = want[2].float()
        x_err = max(x_err, float((got[2].float() - xw).abs().max()
                                 / xw.abs().max()))
        sum_err = max(sum_err, float((got[0] - want[0]).abs()
                                     / xw.abs().sum()))
    return {"p1_rel_err": p1, "p2_x_rel_err": x_err,
            "p2_sum_err_of_l1": sum_err}


def compare(parent: str | None = None, variants=(), rounds: int = 2,
            log=print) -> dict:
    """The rounds in turns; returns each side's readings, their means, the
    card and, for the variants, their registers and errors."""
    import torch
    from . import card_line, require_cuda
    require_cuda("probe_kernel_variants")
    result = {"card": card_line(), "iters": ITERS, "p1_n": P1_N,
              "graph_launches": GRAPH_LAUNCHES,
              "chains": {**CHAINS, PAIR[0]: PAIR[1]}, "ms": {},
              "variants": {}}
    libs = {}
    for name in variants:
        libs[name] = build_variant(name)
        with _launching(libs[name]) as pk:
            check = check_loaded(torch, pk)
        result["variants"][name] = dict(
            check, ptxas=[x.strip() for x in libs[name].build_log.splitlines()
                          if "registers" in x or "spill" in x])
        log(f"{name}: {json.dumps(result['variants'][name])}")
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
                with _launching(libs[side]):
                    ms = time_kernels()
            result["ms"].setdefault(name, []).append(ms)
            log(f"round {r} {name}: " + "; ".join(
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
