"""The port's bench entry: the rows of the JAX package's ``bench.py`` on one
CUDA card.

    python -m gif_synthesis_with_discrete_diffusion_tpu_torch.bench \\
        --metric sampling --config honest [--batch N]

Prints one JSON line on stdout. Rows (``--metric``; ``--config`` picks the
problem size of the sampling, vqvae and train_step2 rows, as there):

* ``sampling``: 100-step D3PM sampling with CFG 2 from a zero (B, 1, 512)
  condition, then the VQ-VAE decode and a sum of the video, on the route
  that ``sampler="auto"`` takes (``honest``: 1024 tokens, B=32, K3;
  ``msrvtt``: 2304 tokens, B=8, K4; ``half``: 512 tokens, K=2049, B=32);
  with the step's ``ms_per_step``, ``bound_ms`` (:mod:`.roofline`) and
  ``mfu`` (its operations over its time and 989 TFLOP/s);
* ``vqvae``: encode and decode of 16-frame clips (64 px, B=32);
* ``train_step``: ``TRAIN_STEP1`` (64 px, f32, B=64); ``train_step128``:
  ``TRAIN_STEP128`` (128 px, bf16, B=64);
* ``train_step2``: ``TRAIN_STEP2`` (bf16 denoiser, label conditioning,
  B=16); ``--config msrvtt``: ``TRAIN_STEP2_MSRVTT`` (text conditioning:
  the frozen CLIP text tower's forward inside each step, 2304 tokens,
  B=16; the captions tokenized once, outside the timed steps);
* ``fvd_pipeline``: 100-step sampling on the ``megakernel`` route (K3 at
  honest, K4 at msrvtt) from a zero condition, the VQ-VAE decode, the I3D
  at 224 px (random init, seeded) on the generated clips and on seeded
  ``normal * 0.3`` ground truth, and the Fréchet distance on the host; one
  warm-up pass, one timed pass, its ``fvd`` in the row.

Each row warms up, then times its repeats (sampling 5, fvd_pipeline 1, the
others 10) on the host clock, each ending in ``torch.cuda.synchronize()``.
``value`` is the rate at the median time and ``spread`` the rates at the
slowest and the fastest repeat. ``vs_baseline`` divides by the measured
torch-CPU artifacts at the root of the repo (``BASELINE_MEASURED*.json``,
matched by config as the JAX bench matches them; 0.0 where none matches).
``device`` is the card's name and power limit. Without a card the CLI
prints the error line and exits 1: there is no CPU run. The row functions
take a ``device`` and a configuration, so the tests run them on the CPU at
a toy size.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Callable, Mapping, Optional

import torch

from .eval.evaluator import FVDEvaluator
from .generate import HONEST, MSRVTT_GRID, build_models
from .models.discrete_diffusion import resolve_sampler
from .models.vqvae import init_vqvae_
from .roofline import (PEAK_BF16, bound, card, megakernel_bound,
                       megakernel_work)
from .train import stage1, stage2

__all__ = ["BenchConfig", "CONFIGS", "measured_lookup", "bench_sampling",
           "bench_vqvae", "bench_train_step", "bench_train_step2",
           "bench_fvd_pipeline", "run_row", "main"]

ARTIFACTS = Path(__file__).resolve().parent.parent
SAMPLING_REPEATS = 5
REPEATS = 10


@dataclass(frozen=True)
class BenchConfig:
    """A problem size of the JAX bench's ``--config``: the models (shaped
    like :data:`..generate.HONEST`) and the sampling / vqvae batch."""
    name: str
    models: Mapping[str, Any]
    batch: int


_HALF = {   # bench.py's 'half' row: 2048 codes, downsample (2, 8, 8)
    "vqvae": dict(HONEST["vqvae"], n_codes=2048, downsample=(2, 8, 8)),
    "generator": {
        "diffusion_model": {
            "diffusion_step": 100, "guidance_scale": 2.0,
            # no content_spatial_size: the latent's (t * h, w) = (64, 8)
            "transformer": {
                k: v for k, v in
                HONEST["generator"]["diffusion_model"]["transformer"].items()
                if k != "content_spatial_size"},
        },
        "textencoder": HONEST["generator"]["textencoder"],
    },
}
CONFIGS = {"honest": BenchConfig("honest", HONEST, 32),
           "half": BenchConfig("half", _HALF, 32),
           "msrvtt": BenchConfig("msrvtt", MSRVTT_GRID, 8)}


def measured_lookup(kind: str, match: Mapping[str, Any],
                    root: Path = ARTIFACTS
                    ) -> tuple[Optional[float], Optional[str]]:
    """The measured torch-CPU denominator of ``kind`` whose recorded config
    matches ``match``: the first of ``root``'s ``BASELINE_MEASURED*.json``
    in sorted order, by the JAX bench's rule (an artifact without a 'kind'
    is a sampler's; each key of ``match`` compared as a string). Returns
    (value, source) or (None, None)."""
    for path in sorted(root.glob("BASELINE_MEASURED*.json")):
        try:
            measured = json.loads(path.read_text())
            if measured.get("kind", "sampler") != kind:
                continue
            mcfg = measured.get("config") or {}
            if any(str(mcfg.get(k)) != str(v) for k, v in match.items()):
                continue
            value = float(measured.get(
                "torch_cpu_value", measured.get("torch_cpu_clips_per_sec")))
            return value, (f"measured torch CPU {value}, config {mcfg} "
                           f"({path.name})")
        except (OSError, KeyError, ValueError, TypeError):
            continue
    return None, None


def _vs_measured(kind: str, value: float, match: Mapping[str, Any]) -> dict:
    base, source = measured_lookup(kind, match)
    if base:
        return {"vs_baseline": round(value / base, 3),
                "baseline_source": source}
    return {"vs_baseline": 0.0,
            "baseline_source": f"no measured {kind} artifact at this config"}


def _device_name(device: torch.device) -> str:
    return card() if device.type == "cuda" else str(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(run: Callable[[], Any], device: torch.device, repeats: int,
          warmup: int) -> list[float]:
    """Seconds of each of ``repeats`` calls of ``run`` after ``warmup``
    calls, each on the host clock from a synchronised device to the end of
    ``torch.cuda.synchronize()``."""
    for _ in range(warmup):
        run()
    _sync(device)
    seconds = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        _sync(device)
        seconds.append(time.perf_counter() - t0)
    return seconds


def _row(metric: str, work: float, seconds: list[float], unit: str,
         batch: int, device: torch.device) -> dict:
    """The common keys: ``value`` = ``work`` over the median time,
    ``spread`` = [slowest, fastest] repeat in the same unit."""
    return {"metric": metric,
            "value": round(work / statistics.median(seconds), 4),
            "unit": unit,
            "spread": [round(work / max(seconds), 4),
                       round(work / min(seconds), 4)],
            "repeats": len(seconds), "batch": batch,
            "device": _device_name(device)}


def bench_sampling(device: torch.device | str, config: BenchConfig,
                   repeats: int = SAMPLING_REPEATS, warmup: int = 1) -> dict:
    """Sampled clips per second: ``config.batch`` clips from a zero
    condition at guidance 2 on the 'auto' route, decode and sum included."""
    device = torch.device(device)
    models = build_models(config.models, device,
                          torch.Generator().manual_seed(0))
    d3pm = models.generator.diffusion
    tr = d3pm.transformer
    b, L = config.batch, d3pm.content_seq_len
    cond = torch.zeros((b, 1, tr.condition_dim), device=device)
    route = resolve_sampler("auto", device, L, tr, True)
    g = torch.Generator().manual_seed(10)

    @torch.no_grad()
    def run():
        tokens = d3pm.sample(cond, torch.zeros_like(cond), b, generator=g,
                             mode=route)
        video = models.vqvae.decode(tokens.reshape(b, *models.latent_shape))
        return float(video.float().sum())

    seconds = _time(run, device, repeats, warmup)
    steps = d3pm.diffusion_step
    use_cfg = abs(d3pm.guidance_scale - 1.0) >= 1e-3
    nbytes, f32, bf16 = megakernel_work(
        b, 2 if use_cfg else 1, L, tr.n_layer, tr.block0.mlp_fc.out_features,
        d3pm.num_embed, 1, True, n_embd=tr.ln_out.normalized_shape[0],
        n_head=tr.block0.attn1.n_head)
    ms_per_step = statistics.median(seconds) * 1e3 / steps
    # the megakernel route packs bf16 weights: each f32 product by its
    # cheapest exact route (three bf16 products)
    bound_ms, bound_by = (
        megakernel_bound(nbytes, f32, bf16, weights_bf16=True)
        if route == "megakernel" else bound(nbytes, f32, bf16))
    vq = config.models["vqvae"]
    compute = ("bf16 weights" if route == "megakernel" else
               f"{str(tr.compute_dtype).removeprefix('torch.')} compute")
    row = _row(f"sampled clips/sec/chip ({steps}-step D3PM, "
               f"{vq['sequence_length']}f {vq['resolution']}px, {L} tok, "
               f"K={d3pm.num_classes}, CFG {d3pm.guidance_scale:g}, "
               f"{route} route, {compute})", b, seconds, "clips/sec/chip", b,
               device)
    row.update(_vs_measured("sampler", row["value"],
                            {"tokens": L, "codes": d3pm.num_embed}))
    row.update(route=route, ms_per_step=round(ms_per_step, 4),
               bound_ms=round(bound_ms, 4), bound_by=bound_by,
               mfu=(f32 + bf16) / (ms_per_step * 1e-3) / PEAK_BF16)
    return row


def bench_vqvae(device: torch.device | str, config: BenchConfig,
                repeats: int = REPEATS, warmup: int = 1) -> dict:
    """VQ-VAE frames per second: encode then decode ``config.batch`` zero
    clips, in eval mode, and a sum of the video."""
    device = torch.device(device)
    vq = dict(config.models["vqvae"])
    with torch.device("meta"):
        vqvae = stage1.make_vqvae(vq)
    vqvae = vqvae.to_empty(device="cpu")
    init_vqvae_(vqvae, torch.Generator().manual_seed(0))
    vqvae = vqvae.to(device).eval()
    b, t, res = config.batch, vq["sequence_length"], vq["resolution"]
    x = torch.zeros((b, t, res, res, 3), device=device)

    @torch.no_grad()
    def run():
        return float(vqvae.decode(vqvae.encode(x)).float().sum())

    seconds = _time(run, device, repeats, warmup)
    row = _row(f"VQ-VAE enc/dec frames/sec ({t}f {res}px, b{b}, "
               f"{str(vqvae.compute_dtype).removeprefix('torch.')} compute)",
               b * t, seconds, "frames/sec/chip", b, device)
    row.update(_vs_measured("vqvae_encdec", row["value"], {
        "batch": b, "resolution": res, "codes": vq["n_codes"],
        "seq_len": t}))
    return row


def bench_train_step(device: torch.device | str,
                     config: Mapping[str, Any] = stage1.TRAIN_STEP1,
                     batch: int = stage1.TRAIN_STEP1_BATCH,
                     repeats: int = REPEATS, warmup: int = 2) -> dict:
    """VQ-VAE training steps per second at ``config`` (``TRAIN_STEP1`` or
    ``TRAIN_STEP128``); the warm-up's first step initialises the codebook
    from data."""
    device = torch.device(device)
    state = stage1.build_stage1(config, device,
                                torch.Generator().manual_seed(0))
    batch_ = {"video": torch.from_numpy(
        stage1.synthetic_batch(config, batch)["video"]).to(device)}
    g = torch.Generator(device=device).manual_seed(1)

    def run():
        return float(stage1.train_step(state, batch_, g)["total"])

    seconds = _time(run, device, repeats, warmup)
    gcfg = config["generator"]
    res = gcfg["resolution"]
    row = _row(f"VQ-VAE train steps/sec (batch {batch}, EMA codebook, "
               f"{res}px, {gcfg.get('dtype', 'float32')} compute)", 1.0,
               seconds, "steps/sec/chip", batch, device)
    row.update(_vs_measured("vqvae_train", row["value"], {
        "batch": batch, "resolution": res, "codes": gcfg["n_codes"],
        "seq_len": gcfg["sequence_length"],
        "res_layers": gcfg["n_res_layers"]}))
    return row


def bench_train_step2(device: torch.device | str,
                      config: Mapping[str, Any] = stage2.TRAIN_STEP2,
                      batch: int = stage2.TRAIN_STEP2_BATCH,
                      repeats: int = REPEATS, warmup: int = 2) -> dict:
    """Stage-2 training steps per second at ``config``: the frozen encode,
    the conditioner (in text mode the frozen CLIP tower's forward), the D3PM
    loss over the denoiser (K2 forward, K5 backward on the card), the
    backward and Adam. Text captions are tokenized once, before the timed
    steps, and only their ids go to the device (the JAX bench drops
    ``text`` from its device batch too)."""
    device = torch.device(device)
    state = stage2.build_stage2(config, device,
                                torch.Generator().manual_seed(0))
    host = stage2.prepare_batch(stage2.synthetic_batch(
        config, batch, torch.Generator().manual_seed(1)), state.tokenizer,
        state.learnable_cf)
    batch_ = stage2.on_device({k: v for k, v in host.items() if k != "text"},
                              device)
    g = torch.Generator(device=device).manual_seed(2)

    def run():
        return float(stage2.train_step(state, batch_, g)["total"])

    seconds = _time(run, device, repeats, warmup)
    d3pm = state.generator.diffusion
    dtype = str(d3pm.transformer.compute_dtype).removeprefix("torch.")
    mode = "text" if state.tokenizer is not None else "label"
    row = _row(f"stage-2 D3PM train steps/sec (batch {batch}, {mode} cond, "
               f"{d3pm.content_seq_len} tok, K={d3pm.num_classes}, {dtype} "
               f"compute, fused-VJP attention)", 1.0, seconds,
               "steps/sec/chip", batch, device)
    row.update(_vs_measured("train_step2", row["value"], {
        "batch": batch, "tokens": d3pm.content_seq_len,
        "codes": d3pm.num_embed, "mode": mode}))
    return row


def bench_fvd_pipeline(device: torch.device | str, config: BenchConfig,
                       repeats: int = 1, warmup: int = 1) -> dict:
    """Clips per second of the whole evaluation pipeline: ``config.batch``
    clips sampled on the ``megakernel`` route from a zero condition at
    guidance 2 (one whole-step launch a reverse step), decoded, embedded by
    the I3D at 224 px with the ground truth, and the Fréchet distance of
    the two sets on the host."""
    device = torch.device(device)
    models = build_models(config.models, device,
                          torch.Generator().manual_seed(0))
    d3pm = models.generator.diffusion
    b, L = config.batch, d3pm.content_seq_len
    cond = torch.zeros((b, 1, d3pm.transformer.condition_dim), device=device)
    vq = config.models["vqvae"]
    t, res = vq["sequence_length"], vq["resolution"]
    gt = (torch.randn((b, t, res, res, 3),
                      generator=torch.Generator().manual_seed(7))
          * 0.3).to(device)
    ev = FVDEvaluator(generator=torch.Generator().manual_seed(3),
                      device=device)
    g = torch.Generator().manual_seed(10)
    fvds = []

    @torch.no_grad()
    def run():
        tokens = d3pm.sample(cond, torch.zeros_like(cond), b, generator=g,
                             mode="megakernel")
        video = models.vqvae.decode(tokens.reshape(b, *models.latent_shape))
        ev.reset()
        ev.push_vals(gt, video)
        fvds.append(ev.evaluate_metrics()["fvd"])

    seconds = _time(run, device, repeats, warmup)
    fvd = fvds[-1]
    if not math.isfinite(fvd):
        raise FloatingPointError(f"FVD is not finite: {fvd}")
    row = _row("full pipeline clips/sec (sample+decode+I3D+FVD)", b,
               seconds, "clips/sec/chip", b, device)
    row.update(_vs_measured("fvd_pipeline", row["value"], {
        "tokens": L, "codes": d3pm.num_embed, "resolution": res}))
    row.update(route="megakernel", fvd=fvd)
    return row


def run_row(metric: str, config_name: str, device: torch.device | str,
            batch: Optional[int] = None) -> dict:
    """The row ``metric`` at ``--config config_name`` (``batch`` overrides
    the sampling, vqvae and fvd_pipeline batch, as the JAX bench's
    ``--batch``). Raises ``RuntimeError`` for a CUDA ``device`` without a
    card. On the card it computes as the JAX package does: no TF32, bf16
    products summed in f32."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: torch.cuda.is_available() "
                               "is False (the bench has no CPU run)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = CONFIGS[config_name]
    if batch is not None:
        cfg = replace(cfg, batch=batch)
    if metric == "sampling":
        return bench_sampling(device, cfg)
    if metric == "vqvae":
        return bench_vqvae(device, cfg)
    if metric == "train_step":
        return bench_train_step(device)
    if metric == "train_step128":
        return bench_train_step(device, stage1.TRAIN_STEP128,
                                stage1.TRAIN_STEP128_BATCH)
    if metric == "train_step2":
        if config_name == "msrvtt":   # the MSRVTT job: text conditioning
            return bench_train_step2(device, stage2.TRAIN_STEP2_MSRVTT)
        return bench_train_step2(device, dict(stage2.TRAIN_STEP2,
                                              vqvae=cfg.models["vqvae"]))
    if metric == "fvd_pipeline":
        return bench_fvd_pipeline(device, cfg)
    raise ValueError(f"unknown metric {metric!r}")


def _error_line(msg: str) -> str:
    return json.dumps({"metric": "error", "value": 0.0, "unit": "error",
                       "vs_baseline": 0.0, "error": msg})


def _positive_int(s: str) -> int:
    v = int(s)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"batch must be > 0, got {v}")
    return v


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="The port's bench rows on one "
                                 "CUDA card; one JSON line on stdout.")
    ap.add_argument("--metric", default="sampling",
                    choices=["sampling", "vqvae", "train_step",
                             "train_step128", "train_step2", "fvd_pipeline"])
    ap.add_argument("--config", default="honest",
                    choices=["honest", "half", "msrvtt"])
    ap.add_argument("--batch", type=_positive_int, default=None,
                    help="override the config's sampling / vqvae / "
                         "fvd_pipeline batch")
    args = ap.parse_args(argv)
    try:
        result = run_row(args.metric, args.config, "cuda", args.batch)
    except Exception as exc:  # one parseable line whatever failed
        import traceback
        traceback.print_exc()
        print(_error_line(f"{type(exc).__name__}: {exc}"), flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
