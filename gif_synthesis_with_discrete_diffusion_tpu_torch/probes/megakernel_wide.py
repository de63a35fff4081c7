"""K3 / K4 above n_embd 512 (``csrc/megakernel_step.cu``, the units under
``MK_WIDE``): the final hidden state's distance from the plain version,
beside the witnesses and controls its tolerance is read against, for
builds of the source with other defines; where a single head's error comes
from; and the step's time at VQ-Diffusion-B's width.

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.probes.\\
megakernel_wide [--widths 2048x2,1024x16] [--variants=-,DEFINE=1]
        [--localise 2048x1] [--sass 512x2 --parent ROOT] [--out FILE]

``--widths``: (n_embd x n_head) each checked on ``chip_smoke.py``'s phase 21
(a) cases (its seed, n_embd + head dim, and a second, n_embd + n_head) in
every variant; ``--variants``: comma-separated lists of defines joined by
``+`` (``-`` is the source as it stands); ``--localise``: widths at which
the last layer's q, k, v the kernels leave in their scratch are held to
the plain version's (given the plain state before that layer) and phase S
alone is held to the plain attention of the kernels' own q, k, v (the bias
path: the attention output stays in the ``o`` scratch), at 1 and 2
layers; ``--sass W --parent ROOT``: ``cuobjdump -sass`` of ROOT's library
and this checkout's at W, compared line by line, with each side's count
of wgmma (``HGMMA``) and mma.sync (``HMMA``) lines. Then K3 at
VQ-Diffusion-B's width (B=4 under CFG, L=1024, 19 layers, K=4097) timed in
each variant, in turns. Run from the root of the checkout (it drives
``chip_smoke.py``'s case builder and checks); needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops import cuda_build
from ..ops import megakernel as mk


def _width(arg: str) -> tuple[int, int]:
    n_embd, n_head = (int(v) for v in arg.split("x"))
    return n_embd, n_head


def _defines(arg: str) -> tuple[str, ...]:
    return tuple(d for d in arg.split("+") if d not in ("", "-"))


def _distances(cs, libs, variants, n_embd, n_head) -> list:
    """Phase 21 (a)'s cases at two seeds: the witnesses' and controls'
    (max-abs, RMS) relative distances and each variant's."""
    d = n_embd // n_head
    rows = []
    for label, pack_cfg, case in cs._mk_width_cases(torch):
        for seed in (n_embd + d, n_embd + n_head):
            args, kw = cs._megakernel_case(torch, **case, seed=seed,
                                           n_embd=n_embd, n_head=n_head)
            hidden_kw = {n: v for n, v in kw.items()
                         if n not in ("num_classes", "guidance")}
            want = mk.megakernel_hidden_reference(*args[:6], **hidden_kw)
            row = {"case": label, "seed": seed,
                   "tol": cs.mk_hidden_tol(n_embd, d, 4 * n_embd),
                   **cs._hidden_witness(torch, args, hidden_kw, want)}
            b, L = args[1].shape
            for v in variants:
                scratch = mk.alloc_scratch(b, 2 if kw["use_cfg"] else 1, L,
                                           "cuda", n_embd=n_embd,
                                           n_head=n_head)
                with cs._megakernel_library(libs[(n_embd, n_head), v]):
                    mk.megakernel_step(*args, sample=False,
                                       pack_cfg=pack_cfg, scratch=scratch,
                                       **kw)
                torch.cuda.synchronize()
                row[v] = cs._distance(scratch["x"], want)
                del scratch
            dist = {k: v for k, v in row.items()
                    if k not in ("case", "seed", "tol")}
            print(f"{n_embd}x{n_head} {label} seed {seed}: tol "
                  f"{row['tol']:.3g}; " + "; ".join(
                      f"{k} {m:.3e} / {r:.3e}"
                      + (f" (RMS share {r / row['one TF32'][1]:.3f})"
                         if k in variants else "")
                      for k, (m, r) in dist.items()), flush=True)
            rows.append(row)
            del args, want
            torch.cuda.empty_cache()
    return rows


def _localise(cs, lib, n_embd, n_head) -> list:
    """The last layer's q, k, v and phase S alone against the plain
    version, at 1 and 2 layers (K4 under CFG, a one-token condition)."""
    d = n_embd // n_head
    out = []
    for n_layer in (1, 2):
        for L, B, spatial in ((200, 3, (20, 10)), (64, 2, (8, 8))):
            args, kw = cs._megakernel_case(
                torch, L=L, spatial=spatial, k=17, n_layer=n_layer, s_len=1,
                B=B, use_cfg=True, dtype=torch.bfloat16, seed=n_embd + d,
                n_embd=n_embd, n_head=n_head)
            R = 2 * B
            scratch = mk.alloc_scratch(B, 2, L, "cuda", n_embd=n_embd,
                                       n_head=n_head)
            with cs._megakernel_library(lib):
                mk.megakernel_step(*args, sample=False, pack_cfg=False,
                                   scratch=scratch, **kw)
            torch.cuda.synchronize()
            hidden_kw = {n: v for n, v in kw.items()
                         if n not in ("num_classes", "guidance")}
            packed, tokens, adaln, kc, vc, pos = args[:6]
            if n_layer > 1:
                x = mk._hidden(packed, tokens, adaln, kc, vc, pos,
                               **dict(hidden_kw, n_layer=n_layer - 1),
                               mm=mk._mm,
                               self_attention=mk._attention_reference)
            else:
                x = (packed["emb"][tokens] + pos)[:, None].expand(
                    B, 2, L, -1).reshape(R, L, -1)
            i, cs_ = n_layer - 1, mk.storage_width(n_embd)
            h = mk._ln(x, n_embd) * (1.0 + adaln[i][0, :cs_]) \
                + adaln[i][0, cs_:]
            qkv = mk._mm(h, packed["wqkv"][i]) + packed["bqkv"][i]
            plain = {
                "q": mk._scale_queries(qkv[..., :cs_], d),
                "k": mk._bf16(qkv[..., cs_:2 * cs_]),
                "v": mk._bf16(qkv[..., 2 * cs_:])}
            kern = {n: scratch[n][..., :d].float().permute(0, 2, 1, 3)
                    for n in ("q", "k", "v")}

            def rel(a, b):
                return ((a - b).abs().max() / b.abs().max()).item()

            row = {"n_layer": n_layer, "L": L, **{
                n: rel(kern[n], plain[n][..., :n_embd].reshape(
                    R, L, n_head, d)) for n in ("q", "k", "v")}}
            s = torch.einsum("rqhd,rkhd->rhqk", kern["q"], kern["k"])
            e = torch.exp(s - s.amax(dim=-1, keepdim=True))
            p = mk._bf16(e / e.sum(dim=-1, keepdim=True))
            o = torch.einsum("rhqk,rkhd->rqhd", p, kern["v"]).reshape(
                R, L, n_embd)
            top2 = s.topk(2, dim=-1).values
            row.update(phase_s=rel(scratch["o"][..., :n_embd], o),
                       score_max=s.abs().max().item(),
                       min_gap=(top2[..., 0] - top2[..., 1]).min().item(),
                       hidden=rel(scratch["x"], mk.megakernel_hidden_reference(
                           *args[:6], **hidden_kw)))
            print(f"{n_embd}x{n_head} localised: " + ", ".join(
                f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
            out.append(row)
            del args, scratch
            torch.cuda.empty_cache()
    return out


def _sass(lib_path: str) -> list[str]:
    tool = Path(cuda_build.find_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", lib_path],
                          capture_output=True, text=True,
                          check=True).stdout.splitlines()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="2048x2,1024x16")
    ap.add_argument("--variants", default="-")
    ap.add_argument("--localise", default="")
    ap.add_argument("--sass", default="")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("megakernel_wide needs a CUDA device")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    smi = cs.card()
    print(smi, flush=True)
    cs._reference_precision(torch)
    widths = [_width(w) for w in a.widths.split(",") if w]
    local = [_width(w) for w in a.localise.split(",") if w]
    variants = a.variants.split(",")
    builds = {(w, v) for w in set(widths + [(1024, 16)]) for v in variants}
    builds |= {(w, variants[0]) for w in local}
    jobs = {(w, v): (lambda w=w, v=v: mk._library(
        _defines(v), (w[0], w[0] // w[1]))) for w, v in builds}
    sass = [_width(w) for w in a.sass.split(",") if w]
    src = Path(a.parent or ".").resolve() / cs.PKG / "csrc" / \
        "megakernel_step.cu"
    for w in sass:
        jobs[w, "this"] = (lambda w=w: mk._library((), (w[0], w[0] // w[1])))
        jobs[w, "parent"] = (lambda w=w: cuda_build.load(
            str(src), cuda_build.BUILD_DIR / "parent",
            defines=(f"MK_C={w[0]}", f"MK_D={w[0] // w[1]}")))
    with ThreadPoolExecutor(8) as pool:       # one nvcc a build, together
        libs = dict(zip(jobs, pool.map(lambda f: f(), jobs.values())))
    for k, lib in libs.items():
        print(f"{k}: nvcc {lib.build_seconds:.1f} s; "
              + "; ".join(cs._ptxas_by_kernel(lib.build_log)), flush=True)
    result = {"device": smi, "sass": {}, "distances": {}, "localised": {},
              "vqd_b_k3_ms": {v: [] for v in variants}}
    for w in sass:
        lines = [_sass(libs[w, side]._name) for side in ("parent", "this")]
        differ = [(x, y) for x, y in zip(*lines) if x != y]
        ops = {op: [sum(f" {op}." in x or f" {op} " in x for x in side)
                    for side in lines] for op in ("HGMMA", "HMMA")}
        result["sass"][f"{w[0]}x{w[1]}"] = {
            "lines": [len(x) for x in lines], "differing": len(differ),
            "first": differ[:4], **ops}
        print(f"SASS {w}: {len(lines[0])} / {len(lines[1])} lines, "
              f"{len(differ)} differ: {differ[:4]}; parent / this: "
              + ", ".join(f"{op} {a} / {b}" for op, (a, b) in ops.items()),
              flush=True)
    for w in widths:
        result["distances"][f"{w[0]}x{w[1]}"] = _distances(
            cs, libs, variants, *w)
    for w in local:
        result["localised"][f"{w[0]}x{w[1]}"] = _localise(
            cs, libs[w, variants[0]], *w)
    args, kw = cs._megakernel_case(
        torch, L=1024, spatial=(32, 32), k=4097, n_layer=19, s_len=1, B=4,
        use_cfg=True, dtype=torch.bfloat16, seed=5, n_embd=1024, n_head=16)
    scratch = mk.alloc_scratch(4, 2, 1024, "cuda", n_embd=1024, n_head=16)
    for _ in range(2):
        for v in variants + variants[::-1]:
            with cs._megakernel_library(libs[(1024, 16), v]):
                ms = cs._time_ms(lambda: mk.megakernel_step(
                    *args, pack_cfg=True, scratch=scratch, **kw), 5)
            result["vqd_b_k3_ms"][v].append(ms)
    print("K3 at n_embd 1024 in heads of 64, B=4 under CFG, L=1024, 19 "
          "layers, K=4097, in turns: " + "; ".join(
              f"{v} " + ", ".join(f"{t:.3f}" for t in ms)
              for v, ms in result["vqd_b_k3_ms"].items()) + f" ms ({smi})",
          flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
