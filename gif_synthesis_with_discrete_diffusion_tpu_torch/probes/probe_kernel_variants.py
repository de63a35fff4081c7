"""The probe product P1 and the chains P2 and P3 (``csrc/probe_kernels.cu``)
timed against the kernels of another checkout and against design variants,
in turns on one card.

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
built beside the shipped build (one nvcc a variant, all at once) and
first held against the plain versions; the shipped source carries no
switch for it. A round is parent, this checkout, the variants, this
checkout, parent. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
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
# the local kernel on 8 warps in all, where the shipped one gives each
# chain 8
_EIGHT_WARPS = (
    ("__launch_bounds__(NC * kThreads, 1)", "__launch_bounds__(kThreads, 1)"),
    ("  constexpr int threads = NC * kThreads;\n",
     "  constexpr int threads = kThreads;\n"),
    ("<<<blocks, NC * kThreads, smem, s>>>", "<<<blocks, kThreads, smem, s>>>"))
# the local kernel's loop: each warp its rows of one chain
_LOOP = """  const int c = warp / kRowWarps, row0 = warp % kRowWarps * kLocalRows;
  __nv_bfloat16* x = xs + c * chain;
  float part[kLocalGroups] = {};
  if (row0 < p.m) {
    for (int it = 0; it < p.iters; ++it)
      local_iteration<K, NC>(x, x + hs, x + ws, ws_ld, row0, width, lane,
                             p.mode == 0, part);
  }
#pragma unroll
  for (int gi = 0; gi < kLocalGroups; ++gi)
    if (gi < groups)
      cs[(c * groups + gi) * kThreads + tid % kThreads] = part[gi];
"""
# the checksum partials of every chain of a warp's rows, written once
_PARTS_OF_EVERY_CHAIN = """#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int gi = 0; gi < kLocalGroups; ++gi)
      if (gi < groups) cs[(c * groups + gi) * kThreads + tid] = part[c][gi];
"""
# each warp its rows of every chain, one chain after the other
_LOOP_IN_TURN = """  const int row0 = warp * kLocalRows;
  float part[NC][kLocalGroups] = {};
  if (row0 < p.m) {
    for (int it = 0; it < p.iters; ++it)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        local_iteration<K, NC>(xs + c * chain, xs + c * chain + hs,
                               xs + c * chain + ws, ws_ld, row0, width, lane,
                               p.mode == 0, part[c]);
  }
""" + _PARTS_OF_EVERY_CHAIN
# each warp its rows of every chain, their products interleaved
_LOOP_BOTH = """  const int row0 = warp * kLocalRows;
  float part[NC][kLocalGroups] = {};
  if (row0 < p.m) {
    for (int it = 0; it < p.iters; ++it)
      local_iteration_all<K, NC>(xs, chain, hs, ws, ws_ld, row0, width, lane,
                                 p.mode == 0, part);
  }
""" + _PARTS_OF_EVERY_CHAIN
# the local kernel's opening comment: a variant adds a function before it
_KERNEL = "// NC chains (1 or 2) of depth K on 8 warps each"
# one iteration of every chain over a warp's rows, sub-tile by sub-tile
_ITERATION_ALL = """// One iteration of the NC chains over this warp's rows: chain j's x, head
// and slab at xs + j * chain, + hs and + ws, its partials in part[j]; the
// chains' products interleave sub-tile by sub-tile
template <int K, int NC>
__device__ __forceinline__ void local_iteration_all(
    __nv_bfloat16* xs, int chain, int hs, int ws, int ws_ld, int row0,
    int width, int lane, bool products, float (&part)[NC][kLocalGroups]) {
  constexpr int x_ld = K + kPad;
  constexpr int sub = kHeadSub<K, NC>, slab_sub = kSlabSub<K, NC>;
  unsigned a[NC][K / 16][kLocalTiles][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int kk = 0; kk < K; kk += 16)
#pragma unroll
      for (int mt = 0; mt < kLocalTiles; ++mt)
        ldmatrix_x4(a[j][kk / 16][mt],
                    xs + j * chain + (row0 + mt * 16 + (lane & 15)) * x_ld +
                        kk + (lane >> 4) * 8);
  __syncwarp();  // every lane holds its fragments of this x
#pragma unroll
  for (int hp = 0; hp < K; hp += sub)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      float acc[kLocalTiles][sub / 8][4] = {};
      if (products)
        local_product<K, sub>(acc, a[j], xs + j * chain + hs, x_ld, hp, K,
                              lane);
#pragma unroll
      for (int q = 0; q < sub / 16; ++q) {
        if (hp + q * 16 < K) {
#pragma unroll
          for (int mt = 0; mt < kLocalTiles; ++mt) {
            const float(&lo)[4] = acc[mt][2 * q];
            const float(&hi)[4] = acc[mt][2 * q + 1];
            unsigned* f = reinterpret_cast<unsigned*>(
                xs + j * chain + (row0 + mt * 16 + (lane >> 2)) * x_ld + hp +
                q * 16 + 2 * (lane & 3));
            f[0] = scaled_pair(lo[0], lo[1]);
            f[4 * x_ld] = scaled_pair(lo[2], lo[3]);
            f[4] = scaled_pair(hi[0], hi[1]);
            f[4 * x_ld + 4] = scaled_pair(hi[2], hi[3]);
          }
        }
      }
    }
#pragma unroll
  for (int ct = 0; ct < kLocalGroups * kGroup; ct += slab_sub) {
    if (ct < width) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float acc[slab_sub / 8][4] = {};
        if (products)
          local_rows_product<K, slab_sub>(acc, a[j], xs + j * chain + ws,
                                          ws_ld, ct, width, lane);
#pragma unroll
        for (int np = 0; np < slab_sub / 16; ++np) {
          if (ct + np * 16 < width) {
            const float(&lo)[4] = acc[2 * np];
            const float(&hi)[4] = acc[2 * np + 1];
            part[j][ct / kGroup + np] += ((lo[0] + hi[0]) + (lo[1] + hi[1])) +
                                         ((lo[2] + hi[2]) + (lo[3] + hi[3]));
          }
        }
      }
    }
  }
  __syncwarp();  // the next x is whole
}

"""
# the end of an iteration of the local kernel
_ITERATION_END = """  __syncwarp();  // the next x is whole: the next iteration may read it
}"""
# the local kernel's head: the next x written over x in shared memory
_HEAD_STORE = """          unsigned* f = reinterpret_cast<unsigned*>(
              xs + (row0 + mt * 16 + (lane >> 2)) * x_ld + hp + q * 16 +
              2 * (lane & 3));
          f[0] = scaled_pair(lo[0], lo[1]);
          f[4 * x_ld] = scaled_pair(lo[2], lo[3]);
          f[4] = scaled_pair(hi[0], hi[1]);
          f[4 * x_ld + 4] = scaled_pair(hi[2], hi[3]);"""
# x's fragments read at the start of an iteration of the local kernel
_X_LOAD = """  unsigned a[K / 16][kLocalTiles][4];
#pragma unroll
  for (int kk = 0; kk < K; kk += 16)
#pragma unroll
    for (int mt = 0; mt < kLocalTiles; ++mt)
      ldmatrix_x4(a[kk / 16][mt], xs + (row0 + mt * 16 + (lane & 15)) * x_ld +
                                      kk + (lane >> 4) * 8);
  __syncwarp();  // every lane holds its fragments of this x
"""
# the local kernel's slab products and their sums into the partials
_SLAB_SUM = """      float acc[slab_sub / 8][4] = {};
      if (products)
        local_rows_product<K, slab_sub>(acc, a, ws, ws_ld, ct, width, lane);
#pragma unroll
      for (int np = 0; np < slab_sub / 16; ++np) {
        if (ct + np * 16 < width) {
          const float(&lo)[4] = acc[2 * np];
          const float(&hi)[4] = acc[2 * np + 1];
          part[ct / kGroup + np] += ((lo[0] + hi[0]) + (lo[1] + hi[1])) +
                                    ((lo[2] + hi[2]) + (lo[3] + hi[3]));
        }
      }"""
_SLAB_SUM_BY_TILE = """      float acc[kLocalTiles][slab_sub / 8][4] = {};
      if (products)
        local_product<K, slab_sub>(acc, a, ws, ws_ld, ct, width, lane);
#pragma unroll
      for (int np = 0; np < slab_sub / 16; ++np) {
        if (ct + np * 16 < width) {
          float v = 0.f;
#pragma unroll
          for (int mt = 0; mt < kLocalTiles; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) v += acc[mt][2 * np + h][e];
          part[ct / kGroup + np] += v;
        }
      }"""
# the first sum of the local kernel's final x: the first 256 threads
_FINAL_SUM = """    if (tid < kThreads)
      for (int cc = 0; cc < NC; ++cc)
        for (int i = tid; i < state; i += kThreads)
          s += __bfloat162float(xs[cc * chain + i / K * x_ld + i % K]);
    if (tid < kThreads) red[tid] = s;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride /= 2) {"""
# name -> ((old text, new text), ...): each old text occurs once
VARIANTS = {
    # P1 with a ring of two stages: half the loads in flight at n = 256
    "p1_stages2": (("constexpr int kP1Stages = 4; ",
                    "constexpr int kP1Stages = 2; "),),
    # P1 with four warps a block splitting each chunk's depth (128 threads)
    "p1_splits4": (("constexpr int kP1Splits = 8; ",
                    "constexpr int kP1Splits = 4; "),),
    # the local design with a block barrier closing each iteration, where
    # the shipped loop has warp barriers only
    "p2_block_barrier": ((_ITERATION_END, """  __syncthreads();  // the next x is whole
}"""),),
    # one chain on the pair's sub-tiles: the head 32 columns (16 above
    # k = 64) and the slab 64 (16), where the shipped kernel gives one
    # chain's 255 registers a thread 64-column sub-tiles
    "p2_pair_subs": (
        ("constexpr int kHeadSub = NC == 1 ? 64 : K > 64 ? 16 : 32;",
         "constexpr int kHeadSub = K > 64 ? 16 : 32;"),
        ("constexpr int kSlabSub = NC == 1 || K <= 64 ? 64 : 16;",
         "constexpr int kSlabSub = K <= 64 ? 64 : 16;")),
    # the pair on 8 warps of 64 rows, 4 a chain (255 registers a thread),
    # where the shipped kernel gives a warp 32 rows: each B fragment read
    # for 64 rows, one warp of each chain a sub-partition
    "p3_rows64": (
        ("constexpr int kLocalRows = 32; ", "constexpr int kLocalRows = 64; "),
        ("__launch_bounds__(NC * kThreads, 1)",
         "__launch_bounds__(NC * kRowWarps * 32, 1)"),
        ("  constexpr int threads = NC * kThreads;\n",
         "  constexpr int threads = NC * kRowWarps * 32;\n"),
        ("<<<blocks, NC * kThreads, smem, s>>>",
         "<<<blocks, NC * kRowWarps * 32, smem, s>>>"),
        ("* kThreads + tid % kThreads] = part[gi];",
         "* kThreads + tid % (kRowWarps * 32)] = part[gi];"),
        ("    for (int j = 0; j < kThreads; ++j)\n      s += cs[",
         "    for (int j = 0; j < kRowWarps * 32; ++j)\n      s += cs["),
        (_FINAL_SUM, """    for (int cc = 0; cc < NC; ++cc)
      for (int i = tid; i < state; i += threads)
        s += __bfloat162float(xs[cc * chain + i / K * x_ld + i % K]);
    red[tid] = s;
    __syncthreads();
    for (int stride = threads / 2; stride > 0; stride /= 2) {""")),
    # the pair on 8 warps of 32 rows, each advancing both chains of its
    # rows with their products interleaved sub-tile by sub-tile
    "p3_two_chains_a_warp": (*_EIGHT_WARPS, (_LOOP, _LOOP_BOTH),
                             (_KERNEL, _ITERATION_ALL + _KERNEL)),
    # the pair on 8 warps of 32 rows, each advancing its rows of one chain,
    # then of the other, within every iteration
    "p3_chains_in_turn": (*_EIGHT_WARPS, (_LOOP, _LOOP_IN_TURN)),
    # x kept in registers for the whole loop, the head's product packed
    # into the next iteration's fragments, where the shipped kernel writes
    # the next x over x in shared memory and reads it back as fragments
    # each iteration
    "p3_x_in_registers": (
        ("    float (&part)[kLocalGroups]) {",
         "    float (&part)[kLocalGroups],\n"
         "    unsigned (&a)[K / 16][kLocalTiles][4]) {"),
        (_X_LOAD, "  unsigned next[K / 16][kLocalTiles][4];\n"),
        (_HEAD_STORE, """          unsigned* f = next[hp / 16 + q][mt];
          f[0] = scaled_pair(lo[0], lo[1]);
          f[1] = scaled_pair(lo[2], lo[3]);
          f[2] = scaled_pair(hi[0], hi[1]);
          f[3] = scaled_pair(hi[2], hi[3]);"""),
        (_ITERATION_END, """#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int mt = 0; mt < kLocalTiles; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kk][mt][e] = next[kk][mt][e];
}"""),
        ("""    for (int it = 0; it < p.iters; ++it)
      local_iteration<K, NC>(x, x + hs, x + ws, ws_ld, row0, width, lane,
                             p.mode == 0, part);
""", """    unsigned a[K / 16][kLocalTiles][4];
#pragma unroll
    for (int kk = 0; kk < K; kk += 16)
#pragma unroll
      for (int mt = 0; mt < kLocalTiles; ++mt)
        ldmatrix_x4(a[kk / 16][mt], x + (row0 + mt * 16 + (lane & 15)) *
                                            x_ld + kk + (lane >> 4) * 8);
    for (int it = 0; it < p.iters; ++it)
      local_iteration<K, NC>(x, x + hs, x + ws, ws_ld, row0, width, lane,
                             p.mode == 0, part, a);
    __syncwarp();  // every lane has read the first x
#pragma unroll
    for (int kk = 0; kk < K; kk += 16)
#pragma unroll
      for (int mt = 0; mt < kLocalTiles; ++mt) {
        unsigned* f = reinterpret_cast<unsigned*>(
            x + (row0 + mt * 16 + (lane >> 2)) * x_ld + kk + 2 * (lane & 3));
        f[0] = a[kk / 16][mt][0];
        f[4 * x_ld] = a[kk / 16][mt][1];
        f[4] = a[kk / 16][mt][2];
        f[4 * x_ld + 4] = a[kk / 16][mt][3];
      }
""")),
    # the slab's products in one accumulator tile a row tile, each summed
    # by the CUDA cores into the checksum partials, where the shipped kernel
    # accumulates a warp's row tiles into one tile in the tensor cores
    "p3_sums_by_row_tile": ((_SLAB_SUM, _SLAB_SUM_BY_TILE),),
    # the pair's sub-tiles of the slab 32 columns wide up to k = 64, where
    # the shipped kernel takes 64
    "p3_slab_sub32": (
        ("constexpr int kSlabSub = NC == 1 || K <= 64 ? 64 : 16;",
         "constexpr int kSlabSub = NC == 1 ? 64 : K <= 64 ? 32 : 16;"),),
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
    relative to the plain max-abs at n = 256 and 300, and P2's and P3's
    final x and sum at the QK shape and a depth-curve shape, 3 iterations
    from an x of N(0, 1) (later x is 0 in bf16)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    p1 = 0.0
    for n in (256, 300):
        a = torch.randn((n, n), generator=g, device="cuda")
        want = pk.probe_matmul_reference(a)
        p1 = max(p1, float((pk.probe_matmul(a) - want).abs().max()
                           / want.abs().max()))
    out = {"p1_rel_err": p1}
    for name, launch, plain in (
            ("p2", lambda x, w1, w2: pk.chain_matmul(x, w1, 3, return_x=True),
             lambda x, w1, w2: pk.chain_reference(x, w1, 3, return_x=True)),
            ("p3", lambda x, w1, w2: pk.pair_matmul(x, w1, w2, 3,
                                                    return_x=True),
             lambda x, w1, w2: pk.pair_reference(x, w1, w2, 3,
                                                 return_x=True))):
        x_err = sum_err = 0.0
        for m, k, n in ((256, 64, 16384), (256, 128, 2048)):
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            w1, w2 = ((torch.randn((k, n), generator=g, device="cuda")
                       / k).to(torch.bfloat16) for _ in range(2))
            got, want = launch(x, w1, w2), plain(x, w1, w2)
            xw = want[2].float()
            x_err = max(x_err, float((got[2].float() - xw).abs().max()
                                     / xw.abs().max()))
            sum_err = max(sum_err, float((got[0] - want[0]).abs()
                                         / xw.abs().sum()))
        out.update({f"{name}_x_rel_err": x_err,
                    f"{name}_sum_err_of_l1": sum_err})
    return out


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
    from ..ops import probe_kernels
    probe_kernels._library()  # the shipped build, whose types they take
    with ThreadPoolExecutor(max(1, len(variants))) as pool:
        libs = dict(zip(variants, pool.map(build_variant, variants)))
    for name in variants:
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
