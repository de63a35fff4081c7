"""What a bf16 tensor-core product with its operands on chip reaches at
contraction depth 64, 128, 256 and 512, and whether packing two depth-64
products into one depth-128 pass wins.

The counterpart of ``scripts/depth_pack_probe.py`` for an NVIDIA card, with
the same result keys. Each measurement is one launch of a chain kernel
(``ops/probe_kernels.py``: ``chain_matmul``, ``pair_matmul``): ``iters``
dependent products ``x <- bf16(0.01 * (x @ w)[:, :k])`` with w resident in
the SMs' shared memory for the whole launch. Every chain at k <= 128 (the
QK and packed shapes, the depth curve at 64 and 128, the pair at the QK
shape) takes the local design: every block keeps x and the head w[:, :k]
of each chain and computes the next x itself, each warp the chain of its
own 32 rows, as the TPU kernel keeps x in one core; the deeper chains take
the exchange design, the next x passed through L2 behind a grid barrier
(``chain_design``; each shape's design is in the result).

* ``depth_curve``: useful TFLOP/s of (256, K) x (K, 2048) for K in 64, 128,
  256, 512;
* ``qk_shape``: (256, 64) x (64, 16384), the whole-step kernels' head-stacked
  score shape;
* ``pack_ab``: two chained and two independent depth-64 products against one
  block-diagonal depth-128 pass (256, 128) x (128, 32768) that computes the
  same two score blocks (and twice the operations).

Every shape is also run with the products skipped and with the loop's
synchronisation alone (``MODES``), so each iteration's time splits into the
products and the rest: ``us_products_skipped`` / ``exchange_share`` is the
loop without its products (local: the head's rounding, the next x's
writes, the checksum's partial sums, the warp barriers; exchange: also the
staging of x from L2 and the grid barrier), ``us_barrier_only`` /
``barrier_share`` the synchronisation alone (local: two warp barriers an
iteration; exchange: one grid barrier). The pair at the QK shape against
the packed pass answers the probe's question: two independent depth-64
chains, each on its own warps, or one block-diagonal depth-128 pass.

After a few dozen iterations x is zero in bf16 (each iteration scales by
0.01 and w ~ N(0, 1) / k); the tensor cores take the same time for zeros, so
the timed launches run the script's 2000 iterations all the same. The
kernels are held against their plain versions at ``iters`` <= 4, where
sum(x) is far from zero (``chip_smoke.py``, ``tests/test_torch_gpu_kernels
.py``).

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.depth_pack_probe [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..ops import probe_kernels as pk
from . import card_line, require_cuda

__all__ = ["ITERS", "probe_inputs", "time_chain", "measure", "main"]

ITERS = 2000
M = 256
DEPTHS = (64, 128, 256, 512)


def probe_inputs(m: int, k: int, n: int):
    """The script's operands as numpy f32: x of ones, and w1, w2 drawn in
    turn from ``default_rng(0)`` as N(0, 1) / k (the chain uses w1)."""
    rng = np.random.default_rng(0)
    w1 = (rng.standard_normal((k, n)) / k).astype(np.float32)
    w2 = (rng.standard_normal((k, n)) / k).astype(np.float32)
    return np.ones((m, k), np.float32), w1, w2


def time_chain(m: int, k: int, n: int, iters: int = ITERS, *,
               pair: bool = False) -> dict:
    """Seconds per iteration of an (m, k) x (k, n) chain (``pair``: of two
    independent chains) on the current CUDA device, by CUDA events, the
    least of 2 launches after a warm one, in each of the kernel's modes."""
    import torch
    x, w1, w2 = (torch.from_numpy(a).to(torch.bfloat16).to("cuda")
                 for a in probe_inputs(m, k, n))
    out = {}
    for mode in pk.MODES:
        def launch():
            if pair:
                return pk.pair_matmul(x, w1, w2, iters, mode=mode)
            return pk.chain_matmul(x, w1, iters, mode=mode)
        launch()
        times = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        out[mode] = min(times) / iters
    return out


def _row(m: int, k: int, n: int, t: dict, products: int = 1,
         design: str | None = None) -> dict:
    """One shape's readings: microseconds an iteration in each mode, the
    useful TFLOP/s of the whole iteration and of the products alone (the
    iteration less the same loop with the products skipped), and the
    design the launch took."""
    flops = 2.0 * m * k * n * products
    alone = t["full"] - t["no_products"]
    return {
        "design": design,
        "us": t["full"] * 1e6,
        "us_products_skipped": t["no_products"] * 1e6,
        "us_barrier_only": t["barrier_only"] * 1e6,
        "tflops": flops / t["full"] / 1e12,
        "products_alone_tflops": flops / alone / 1e12 if alone > 0 else None,
        "exchange_share": t["no_products"] / t["full"],
        "barrier_share": t["barrier_only"] / t["full"],
    }


def measure(iters: int = ITERS, log=print) -> dict:
    """Run the three measurements on the current CUDA device."""
    require_cuda("the depth / packing probe")
    import torch
    grid = {n: pk.device_chain_design(M, 64, n)
            for n in (2048, 16384, 32768)}
    results = {"device": f"gpu:{torch.cuda.get_device_name(0)}",
               "card": card_line(), "iters": iters,
               "grid": {str(n): {"slab_columns": d.slab, "blocks": d.blocks}
                        for n, d in grid.items()},
               "shapes": {}}
    log(f"probing {results['card']}; a chain's grid: "
        + ", ".join(f"n={n}: {d.blocks} blocks of {d.slab} columns"
                    for n, d in grid.items()))

    def run(label, m, k, n, pair=False):
        t = time_chain(m, k, n, iters, pair=pair)
        design = pk.device_chain_design(m, k, n, 2 if pair else 1).design
        row = _row(m, k, n, t, 2 if pair else 1, design)
        results["shapes"][label] = row
        log(f"{label}, the {design} design: {row['us']:.3f} us/iteration = "
            f"{row['tflops']:.2f} TFLOP/s; products skipped "
            f"{row['us_products_skipped']:.3f} us "
            f"({100 * row['exchange_share']:.1f} %), synchronisation alone "
            f"{row['us_barrier_only']:.3f} us "
            f"({100 * row['barrier_share']:.1f} %); the products alone "
            + (f"{row['products_alone_tflops']:.2f} TFLOP/s"
               if row["products_alone_tflops"] else "not resolved"))
        return t["full"], row

    # --- depth curve at fixed output (256, 2048) ---
    curve, alone = {}, {}
    for k in DEPTHS:
        _, row = run(f"depth_curve (256, {k}) x ({k}, 2048)", M, k, 2048)
        curve[str(k)] = row["tflops"]
        alone[str(k)] = row["products_alone_tflops"]
    results["depth_curve_tflops"] = curve
    results["depth_curve_products_alone_tflops"] = alone
    results["d64_over_d128_rate"] = curve["64"] / curve["128"]

    # --- the whole-step kernels' QK shape ---
    dt64, row = run("qk_shape (256, 64) x (64, 16384)", M, 64, 16384)
    results["qk_shape_tflops"] = row["tflops"]
    results["qk_shape_us"] = row["us"]

    # --- pack A/B: two depth-64 passes against one block-diagonal depth-128
    # pass; the packed side executes twice the (zero-padded) operations ---
    dt128, _ = run("pack_ab packed (256, 128) x (128, 32768)", M, 128, 32768)
    results["pack_two_d64_chained_us"] = 2 * dt64 * 1e6
    results["pack_one_d128_blockdiag_us"] = dt128 * 1e6
    results["pack_speedup_vs_chained"] = 2 * dt64 / dt128
    # the fair comparison: two INDEPENDENT depth-64 products an iteration,
    # at equal chain depth and equal useful work
    dt_pair, _ = run("pack_ab pair 2 x (256, 64) x (64, 16384)", M, 64, 16384,
                     pair=True)
    results["pack_two_d64_independent_us"] = dt_pair * 1e6
    results["pack_speedup_vs_independent"] = dt_pair / dt128
    log(f"two CHAINED d64 {results['pack_two_d64_chained_us']:.3f} us, two "
        f"INDEPENDENT d64 {results['pack_two_d64_independent_us']:.3f} us, "
        f"packed d128 {results['pack_one_d128_blockdiag_us']:.3f} us: "
        f"packing gives {results['pack_speedup_vs_chained']:.3f}x against "
        f"chained (confounded: double the dependency-chain depth), "
        f"{results['pack_speedup_vs_independent']:.3f}x against independent")
    log("x is zero in bf16 after a few dozen iterations; the tensor cores "
        "take the same time for zeros")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="write the JSON object to this path")
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    results = measure(args.iters)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
