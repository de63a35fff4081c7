"""The attention kernels K2 and K5 (``csrc/fused_mha_fwd.cu``,
``csrc/fused_mha_bwd.cu``) timed at the paths' shapes, design variant by
design variant, and against the kernels of other checkouts, in turns on one
card.

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.attention_variants \\
        [--variant NAME ...] [--parent ROOT] [--rounds N] [--head-dim D] \\
        [--out FILE.json]

The shipped build is ``plain``. A variant (``VARIANTS``: the designs that
were tried and lost) is a copy of the three sources with the variant's text
replacements, built by nvcc beside the plain build; the shipped sources
carry no switch for it. Each build is first held against the plain versions
(``sdpa_reference``, ``fused_mha_bwd_reference``) in f32 and bf16 at
``CASES``: the largest error of each. Then every build is timed in turns,
``rounds`` times over (each round the builds and the same in reverse,
:func:`turn_order`):
K2 at (64, 1024, 1024) and (64, 1024, 1), K5 at (16, 1024, 1024) and (16,
1024, 1), 16 heads of ``--head-dim`` (default 4; 8 heads at 128), each
dtype. ``--parent ROOT`` adds the kernels of the checkout at ROOT (f32
only: its ``ops/attention.py`` loaded in a child process, first and last
in each round; a checkout without the wide design takes head dims 4 and
8 only). :func:`compare_widths` times chip_smoke.py phase 20 (a)'s shapes
(``WIDTH_SHAPES``; phase 22 (b)'s at B=16 in 2 heads) at every head dim
against another checkout's, f32 and bf16.
:func:`compare` is the same for this checkout alone, for ``chip_smoke.py``.
Needs a CUDA device.
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

import torch

PKG = "gif_synthesis_with_discrete_diffusion_tpu_torch"
# (B, Lq, Lk, C, H): the phases' cases of chip_smoke.py and odd lengths
CASES = ((8, 1024, 1024, 64, 16), (8, 1024, 1, 64, 16),
         (8, 1024, 77, 64, 16), (2, 2304, 2304, 64, 16),
         (2, 300, 300, 64, 16), (3, 257, 77, 64, 16), (1, 24, 77, 64, 8))
# (name, kernel, B, Lk): the paths' shapes, 1024 queries of 16 heads of 4
SHAPES = (("K2 self", "fwd", 64, 1024), ("K2 cross", "fwd", 64, 1),
          ("K5 self", "bwd", 16, 1024), ("K5 cross", "bwd", 16, 1))
_ITERS = 20

_P_IN = """p in the
  // accumulator layout of mma_dot
  static __device__ __forceinline__ void mma_pair(Acc& acc,
                                                  const float (&p)[kMT][4],"""
_P_SPLIT = """      unsigned hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = p[mt][order[i]];
        hi[i] = __float_as_uint(v) & 0xffffe000u;
        lo[i] = __float_as_uint(v - __uint_as_float(hi[i]));
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        mma_tf32(acc.c[mt][c], hi, x[c].x, x[c].y);
        mma_tf32(acc.c[mt][c], lo, x[c].x, x[c].y);
      }
"""
# P rounded to TF32 in place (so that K2's row sum sees what was multiplied)
_P_ROUNDED = """      unsigned hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = (__float_as_uint(p[mt][order[i]]) + 0x1000u) & 0xffffe000u;
        p[mt][order[i]] = __uint_as_float(hi[i]);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) mma_tf32(acc.c[mt][c], hi, x[c].x, x[c].y);
"""
_TILES = "mha_tiles.cuh"
_WG = "mha_wg.cuh"
# name -> ((file, old text, new text), ...): each old text occurs once
VARIANTS = {
    # the f32 pair products' fed-back operand (P, dS) rounded to TF32
    "nosplit": ((_TILES, _P_IN, _P_IN.replace("const float", "float")),
                (_TILES, _P_SPLIT, _P_ROUNDED)),
    # tiles of 32 keys
    "tile32": ((_TILES, "constexpr int kTile = 64; ",
                "constexpr int kTile = 32; "),),
    # K2 bf16 at one block an SM (the f32 choice)
    "minblk1": ((_TILES, "static constexpr int kMinBlocks = 4;",
                 "static constexpr int kMinBlocks = 1;"),),
    # K2 f32 at four blocks an SM (the bf16 choice)
    "minblk4": ((_TILES, "static constexpr int kMinBlocks = 1;",
                 "static constexpr int kMinBlocks = 4;"),),
    # K2's tensor-core design at every key count
    "tc_all": (("fused_mha_fwd.cu", "constexpr int kFewKeys = 256;",
                "constexpr int kFewKeys = 0;"),),
}
_SOURCES = ("fused_mha_fwd.cu", "fused_mha_bwd.cu", "fused_mha_bwd_stream.cu",
            _TILES, _WG)
# chip_smoke.py phase 20 (a)'s timed shapes at every head dim: 64 rows of
# 1024 queries over 1024 keys (self-attention), one key and 77 keys
WIDTH_SHAPES = (("K2 self", "fwd", 64, 1024), ("K2 cross", "fwd", 64, 1),
                ("K2 cross77", "fwd", 64, 77), ("K5 self", "bwd", 64, 1024),
                ("K5 cross", "bwd", 64, 1), ("K5 cross77", "bwd", 64, 77))


def build_variant(name: str) -> tuple:
    """Copy the sources with the variant's replacements into the build
    directory and build K2's and K5's libraries from the copy."""
    from ..ops import cuda_build
    out = cuda_build.BUILD_DIR / f"variant_{name}"
    out.mkdir(parents=True, exist_ok=True)
    text = {f: (cuda_build.CSRC / f).read_text() for f in _SOURCES}
    for f, old, new in VARIANTS[name]:
        if text[f].count(old) != 1:
            raise RuntimeError(f"variant {name}: the text to replace is not "
                               f"once in {f}")
        text[f] = text[f].replace(old, new)
    for f, t in text.items():
        (out / f).write_text(t)
    libs = []
    # K2's source; K5's two units, linked as ops/attention.py links them
    for srcs in (_SOURCES[:1], _SOURCES[1:3]):
        so = out / (srcs[0][:-3] + ".so")
        try:
            log = cuda_build.build([out / f for f in srcs], so)
        except RuntimeError as err:
            raise RuntimeError(f"variant {name}: {err}") from None
        lib = ctypes.CDLL(str(so))
        lib.build_log = log
        libs.append(lib)
    return tuple(libs)


@contextlib.contextmanager
def launching(attn, libs):
    """K2 and K5 launch from ``libs`` (fwd, bwd) inside the block, the
    shipped builds' argument types bound to them."""
    saved = attn._library, attn._bwd_library
    for lib, plain, fn in zip(libs, saved, ("fused_mha_fwd", "fused_mha_bwd")):
        getattr(lib, fn).argtypes = getattr(plain(), fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    attn._library, attn._bwd_library = (lambda: libs[0]), (lambda: libs[1])
    try:
        yield
    finally:
        attn._library, attn._bwd_library = saved


def _ms(fn) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(_ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / _ITERS


def heads(head_dim: int) -> int:
    """The timed shapes' heads: 16, or 8 at a head dim of 128."""
    return 8 if head_dim >= 128 else 16


def _inputs(kind: str, b: int, lk: int, dtype: torch.dtype, attn,
            head_dim: int = 4, n_head: int | None = None) -> tuple:
    g = torch.Generator(device="cuda").manual_seed(6 + lk)
    n_head = heads(head_dim) if n_head is None else n_head
    c = n_head * head_dim
    q = torch.randn((b, 1024, c), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((b, lk, c), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    if kind == "fwd":
        return q, k, v
    do = torch.randn((b, 1024, c), generator=g, device="cuda").to(dtype)
    out = attn._fwd_kernel(q, k, v, n_head, True)
    # a checkout before the bf16 entry points returns (o, lse)
    o32, lse = (out[2], out[1]) if len(out) == 3 else (out[0], out[1])
    return q, k, v, o32, lse, do


def time_build(attn, dtypes, head_dim: int = 4) -> dict:
    """{shape name + dtype: ms} of the kernels ``attn`` launches (through
    the calls every checkout has)."""
    out = {}
    h = heads(head_dim)
    for dtype in dtypes:
        for name, kind, b, lk in SHAPES:
            x = _inputs(kind, b, lk, dtype, attn, head_dim)
            if kind == "fwd":
                fn = lambda: attn._fwd_kernel(*x, h, False)  # noqa
            else:
                fn = lambda: attn.fused_mha_bwd(*x, n_head=h)  # noqa
            out[f"{name} {str(dtype)[6:]}"] = _ms(fn)
    return out


def time_widths(attn, dims, dtypes=(torch.float32, torch.bfloat16),
                batch: int | None = None, n_head: int | None = None) -> dict:
    """{"d shape dtype": ms} of the kernels ``attn`` launches at
    WIDTH_SHAPES (or at ``batch`` rows), for each head dim of ``dims`` in
    ``heads(d)`` heads (or ``n_head``)."""
    out = {}
    for d in dims:
        h = heads(d) if n_head is None else n_head
        for dtype in dtypes:
            for name, kind, b, lk in WIDTH_SHAPES:
                b = b if batch is None else batch
                x = _inputs(kind, b, lk, dtype, attn, d, h)
                if kind == "fwd":
                    fn = lambda: attn._fwd_kernel(*x, h, False)  # noqa
                else:
                    fn = lambda: attn.fused_mha_bwd(*x, n_head=h)  # noqa
                out[f"{d} {name} {str(dtype)[6:]}"] = _ms(fn)
                del x
            torch.cuda.empty_cache()
    return out


def check_build(attn) -> dict:
    """The largest error against the plain versions over CASES: f32
    absolute; bf16 against the plain versions in f32 of the same inputs,
    beyond the rounding to bf16, as a share of each tensor's magnitude
    (``bf16_excess``, the gradients' floored at 1e-3 of the largest)."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, Lq, Lk, C, H in CASES:
            g = torch.Generator(device="cuda").manual_seed(Lq + 7 * Lk)
            q, k, v, do = (torch.randn((B, n, C), generator=g, device="cuda")
                           .to(dtype) for n in (Lq, Lk, Lk, Lq))
            o, lse, o32 = attn._fwd_kernel(q, k, v, H, True)
            got = (o, *attn._bwd_kernel(q, k, v, o32, lse, do, H))
            x32 = [x.float() for x in (q, k, v, do)]
            want = (attn.sdpa_reference(*x32[:3], H),
                    *attn.fused_mha_bwd_reference(*x32, H))
            big = max(float(w.abs().max()) for w in want[1:])
            for name, a, w in zip(("K2", "K5 dq", "K5 dk", "K5 dv"), got,
                                  want):
                if dtype == torch.float32:
                    err = float((a - w).abs().max())
                else:
                    scale = float(w.abs().max())
                    err = attn.bf16_excess(
                        a, w, scale if name == "K2" else max(scale,
                                                             1e-3 * big))
                key = f"{name} {str(dtype)[6:]}"
                worst[key] = max(worst.get(key, 0.0), err)
    return worst


def _child(head_dim: int = 4) -> None:
    """Time the f32 kernels of the checkout in the working directory (run
    there by main, this file loaded by path); print JSON."""
    sys.path.insert(0, os.getcwd())
    attn = __import__(PKG + ".ops.attention", fromlist=["attention"])
    print(json.dumps(time_build(attn, (torch.float32,), head_dim)))


def _child_widths(dims, batch: int | None = None,
                  n_head: int | None = None) -> None:
    """:func:`time_widths` for the checkout in the working directory (run
    there by :func:`compare_widths`); print JSON."""
    sys.path.insert(0, os.getcwd())
    attn = __import__(PKG + ".ops.attention", fromlist=["attention"])
    print(json.dumps(time_widths(attn, dims, batch=batch, n_head=n_head)))


def _run_child(root: str, call: str) -> dict:
    run = subprocess.run(
        [sys.executable, "-c",
         "import importlib.util as u; s = u.spec_from_file_"
         f"location('probe', {os.path.abspath(__file__)!r}); "
         "m = u.module_from_spec(s); s.loader.exec_module(m); "
         f"m.{call}"], cwd=root, capture_output=True, text=True, check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


def run_in(root: str, head_dim: int = 4) -> dict:
    """The f32 times of the kernels of the checkout at ``root``, measured in
    a child process there."""
    return _run_child(root, f"_child({int(head_dim)})")


def compare_widths(parent: str, dims, rounds: int = 1, log=print,
                   batch: int | None = None,
                   n_head: int | None = None) -> dict:
    """The kernels of this checkout (``change``) and of ``parent`` at
    WIDTH_SHAPES (or at ``batch`` rows in ``n_head`` heads) for each head
    dim of ``dims``, f32 and bf16, in turns (:func:`turn_order`: parent,
    change, change, parent; the parent's in a child process there): each
    side's readings and the card."""
    from ..ops import attention as attn
    out: dict[str, list] = {}
    call = f"_child_widths({list(dims)!r}, {batch!r}, {n_head!r})"
    for r in range(rounds):
        for name in turn_order(["change"], True):
            ms = (_run_child(parent, call) if name == "parent" else
                  time_widths(attn, dims, batch=batch, n_head=n_head))
            out.setdefault(name, []).append(ms)
            log(f"round {r} {name}: " + " ".join(
                f"{k} {v:.4f}" for k, v in ms.items()))
    return {"card": _card(), "dims": list(dims), "ms": out}


def turn_order(names: list[str], parent: bool) -> list[str]:
    """One round's timed runs: the builds, then the same in reverse, between
    two runs of the parent's kernels where there is one (parent, change,
    change, parent for a single build)."""
    ends = ["parent"] if parent else []
    return ends + list(names) + list(names)[::-1] + ends


def in_turns(builds: dict, rounds: int, parent: str | None = None,
             head_dim: int = 4, dtypes=(torch.float32,), log=print) -> dict:
    """{name: [ms of each run]}: every build (name -> (fwd, bwd) libraries)
    at ``dtypes`` and, with ``parent``, the f32 kernels of the checkout at
    that root, timed ``rounds`` times in :func:`turn_order`."""
    from ..ops import attention as attn
    out: dict[str, list] = {}
    for r in range(rounds):
        for name in turn_order(list(builds), parent is not None):
            if name == "parent":
                ms = run_in(parent, head_dim)
            else:
                with launching(attn, builds[name]):
                    ms = time_build(attn, dtypes, head_dim)
            out.setdefault(name, []).append(ms)
            log(f"round {r} {name}: " + " ".join(
                f"{k} {v:.4f}" for k, v in ms.items()))
    return out


def compare(parent: str, rounds: int = 1, head_dim: int = 4,
            log=print) -> dict:
    """The f32 kernels of this checkout (``change``) and of ``parent`` in
    turns at ``head_dim``: each side's readings and the card."""
    from ..ops import attention as attn
    change = {"change": (attn._library(), attn._bwd_library())}
    return {"card": _card(), "head_dim": head_dim,
            "ms": in_turns(change, rounds, parent, head_dim, log=log)}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", action="append", default=[],
                   choices=sorted(VARIANTS))
    p.add_argument("--parent", default=None, metavar="ROOT")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--head-dim", type=int, default=4)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("attention_variants measures on a CUDA device")
    from ..ops import attention as attn
    plain = attn._library(), attn._bwd_library()
    with ThreadPoolExecutor(len(args.variant) or 1) as pool:
        builds = {"plain": plain,
                  **dict(zip(args.variant, pool.map(build_variant,
                                                    args.variant)))}
    result = {"card": _card(), "head_dim": args.head_dim, "errors": {},
              "ms": {}}
    for name, libs in builds.items():
        with launching(attn, libs):
            result["errors"][name] = check_build(attn)
        print(f"{name}: " + " | ".join(
            x.strip() for so in libs for x in so.build_log.splitlines()
            if "registers" in x), flush=True)
        print(f"{name} errors: " + json.dumps(result["errors"][name]),
              flush=True)
    result["ms"] = in_turns(builds, args.rounds, args.parent, args.head_dim,
                            (torch.float32, torch.bfloat16),
                            log=lambda line: print(line, flush=True))
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
