"""The port's bench entry (``gif_synthesis_with_discrete_diffusion_tpu_torch.
bench``) on the CPU at a toy size: the JSON contract of each row, the error
line of a run without a card, the artifact lookup
against the JAX bench's own, and the work count shared with
``chip_smoke.py``. No number measured here is a device number: the rows run
on the CPU only to hold their keys and strings."""
import json
import math

import pytest
import torch

import bench as jax_bench
from gif_synthesis_with_discrete_diffusion_tpu_torch import bench, roofline
from tests.test_torch_slice import CONFIG as SLICE_CONFIG
from tests.test_torch_stage1 import CONFIG as STAGE1_CONFIG

KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_source", "batch",
        "spread", "repeats", "device"}
TOY = bench.BenchConfig("toy", {
    "vqvae": dict(SLICE_CONFIG["vqvae"], sequence_length=2),
    "generator": {
        "diffusion_model": dict(SLICE_CONFIG["generator"]["diffusion_model"],
                                diffusion_step=3),
        "textencoder": SLICE_CONFIG["generator"]["textencoder"]}}, 2)


def _check_row(row, unit):
    assert KEYS <= set(row)
    json.dumps(row)                   # one JSON line
    assert row["unit"] == unit and row["device"] == "cpu"
    lo, hi = row["spread"]
    assert 0 < lo <= row["value"] <= hi
    assert row["repeats"] == 2


def test_sampling_row_keys_and_roofline_fields():
    row = bench.bench_sampling("cpu", TOY, repeats=2, warmup=0)
    _check_row(row, "clips/sec/chip")
    # the route that 'auto' takes on the CPU, named with its compute dtype
    assert row["route"] == "model"
    assert row["metric"] == ("sampled clips/sec/chip (3-step D3PM, 2f 8px, "
                             "32 tok, K=17, CFG 2, model route, float32 "
                             "compute)")
    assert row["batch"] == 2
    assert row["bound_by"] in ("bytes", "operations")
    assert row["ms_per_step"] > 0 and row["bound_ms"] > 0
    assert 0 < row["mfu"] < 1
    # no artifact at 32 tokens: no denominator, said so
    assert row["vs_baseline"] == 0.0
    assert "no measured sampler artifact" in row["baseline_source"]


def test_vqvae_and_training_rows_keys_and_metric_strings():
    row = bench.bench_vqvae("cpu", TOY, repeats=2, warmup=0)
    _check_row(row, "frames/sec/chip")
    assert row["metric"] == ("VQ-VAE enc/dec frames/sec (2f 8px, b2, "
                             "float32 compute)")
    config1 = dict(STAGE1_CONFIG, generator=dict(STAGE1_CONFIG["generator"],
                                                 dtype="bfloat16"))
    row = bench.bench_train_step("cpu", config1, 2, repeats=2, warmup=1)
    _check_row(row, "steps/sec/chip")
    assert row["metric"] == ("VQ-VAE train steps/sec (batch 2, EMA "
                             "codebook, 8px, bfloat16 compute)")
    config2 = json.loads(json.dumps(SLICE_CONFIG))
    config2["generator"]["diffusion_model"]["transformer"]["dtype"] = \
        "bfloat16"
    row = bench.bench_train_step2("cpu", config2, 2, repeats=2, warmup=1)
    _check_row(row, "steps/sec/chip")
    assert row["metric"] == ("stage-2 D3PM train steps/sec (batch 2, label "
                             "cond, 32 tok, K=17, bfloat16 compute, "
                             "fused-VJP attention)")


TEXT_CONFIG = json.loads(json.dumps(SLICE_CONFIG))
TEXT_CONFIG["generator"]["textencoder"] = {
    "mode": "text", "dim": 32, "width": 16, "heads": 2, "layers": 1,
    "allow_hash_tokenizer": True}


def test_text_train_step2_row_keys_and_metric_string():
    row = bench.bench_train_step2("cpu", TEXT_CONFIG, 2, repeats=2, warmup=1)
    _check_row(row, "steps/sec/chip")
    assert row["metric"] == ("stage-2 D3PM train steps/sec (batch 2, text "
                             "cond, 32 tok, K=17, float32 compute, "
                             "fused-VJP attention)")
    assert row["vs_baseline"] == 0.0
    assert "no measured train_step2 artifact" in row["baseline_source"]


def test_fvd_pipeline_row_keys_route_and_a_finite_fvd(monkeypatch):
    from gif_synthesis_with_discrete_diffusion_tpu_torch.eval import (
        evaluator)
    monkeypatch.setattr(evaluator, "FVD_RESOLUTION", 32)
    row = bench.bench_fvd_pipeline("cpu", TOY, repeats=2, warmup=0)
    _check_row(row, "clips/sec/chip")
    assert row["metric"] == "full pipeline clips/sec (sample+decode+I3D+FVD)"
    assert row["route"] == "megakernel" and row["batch"] == 2
    assert math.isfinite(row["fvd"])
    assert "no measured fvd_pipeline artifact" in row["baseline_source"]


def test_run_row_takes_the_text_config_and_the_fvd_row(monkeypatch):
    """``train_step2 --config msrvtt`` is the text-conditioned
    ``TRAIN_STEP2_MSRVTT`` (bench.py's mode 'text'), the other configs keep
    label conditioning; ``fvd_pipeline`` takes every --config with its
    batch, and ``--batch`` overrides it."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage2
    calls = []
    monkeypatch.setattr(bench, "bench_train_step2",
                        lambda device, config: calls.append(config))
    monkeypatch.setattr(bench, "bench_fvd_pipeline",
                        lambda device, cfg: calls.append(cfg))
    bench.run_row("train_step2", "msrvtt", "cpu")
    bench.run_row("train_step2", "honest", "cpu")
    assert calls[0] is stage2.TRAIN_STEP2_MSRVTT
    assert calls[0]["generator"]["textencoder"]["mode"] == "text"
    assert calls[1]["generator"]["textencoder"]["mode"] == "label"
    for name in ("honest", "msrvtt", "half"):
        bench.run_row("fvd_pipeline", name, "cpu")
        assert calls[-1] == bench.CONFIGS[name]
    bench.run_row("fvd_pipeline", "honest", "cpu", batch=4)
    assert calls[-1].batch == 4
    with pytest.raises(ValueError, match="unknown metric"):
        bench.run_row("nothing", "honest", "cpu")


@pytest.mark.parametrize("metric,config", [
    ("fvd_pipeline", "honest"), ("fvd_pipeline", "msrvtt"),
    ("train_step2", "msrvtt")])
def test_former_waiting_rows_need_the_card(capsys, metric, config):
    """The two rows the port lacked until text conditioning and FVD came
    run on the card only, as every row: the error line and exit 1 here."""
    assert bench.main(["--metric", metric, "--config", config]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    err = json.loads(lines[0])
    assert {k: err[k] for k in ("metric", "value", "unit", "vs_baseline")} \
        == {"metric": "error", "value": 0.0, "unit": "error",
            "vs_baseline": 0.0}
    assert "CUDA" in err["error"] and "ROADMAP" not in err["error"]


def test_no_card_prints_the_error_line_and_exits_1(capsys):
    assert not torch.cuda.is_available()
    for metric in ("sampling", "vqvae", "train_step", "train_step128",
                   "train_step2"):
        assert bench.main(["--metric", metric]) == 1
        err = json.loads(capsys.readouterr().out.strip())
        assert err["metric"] == "error" and "CUDA" in err["error"]


@pytest.mark.parametrize("kind,match", [
    ("sampler", {"tokens": 1024, "codes": 4096}),
    ("sampler", {"tokens": 2304, "codes": 4096}),
    ("sampler", {"tokens": 512, "codes": 2048}),
    ("vqvae_encdec", {"batch": 32, "resolution": 64, "codes": 4096,
                      "seq_len": 16}),
    ("vqvae_train", {"batch": 64, "resolution": 64, "codes": 4096,
                     "seq_len": 4, "res_layers": 3}),
    ("vqvae_train", {"batch": 64, "resolution": 128, "codes": 4096,
                     "seq_len": 4, "res_layers": 3}),
    ("train_step2", {"batch": 16, "tokens": 1024, "codes": 4096,
                     "mode": "label"}),
    ("train_step2", {"batch": 16, "tokens": 2304, "codes": 4096,
                     "mode": "text"}),
    ("fvd_pipeline", {"tokens": 1024, "codes": 4096, "resolution": 64}),
])
def test_artifact_lookup_matches_the_jax_bench(kind, match):
    assert bench.measured_lookup(kind, match) == \
        jax_bench._measured_lookup(kind, match)


def test_rows_match_the_jax_bench_configurations():
    """The problem sizes of bench.py's --config, and its row batches."""
    for name in ("honest", "half", "msrvtt"):
        jax_bench.apply_config(name)
        cfg = bench.CONFIGS[name]
        vq = cfg.models["vqvae"]
        assert (vq["n_codes"], tuple(vq["downsample"]), vq["resolution"],
                cfg.batch) == (jax_bench.N_CODES, jax_bench.DOWNSAMPLE,
                               jax_bench.RES, jax_bench.BATCH), name
        with torch.device("meta"):
            models = bench.build_models(cfg.models, "meta",
                                        torch.Generator())
        assert models.generator.diffusion.content_seq_len == \
            jax_bench._seq_len()
        spatial = models.generator.diffusion.transformer.content_emb
        assert tuple(spatial.spatial_size) == {
            "honest": (32, 32), "half": (64, 8), "msrvtt": (48, 48)}[name]
    jax_bench.apply_config("honest")


def test_work_count_gives_the_kernel_tables_numbers():
    """``roofline.megakernel_work`` (the count chip_smoke.py and the bench
    share) at the whole-step kernels' main shapes: PERF.md's 156.8 + 326.4
    GFLOP for K3 (B=32, L=1024) and 88.2 + 413.1 for K4 (B=8, L=2304)."""
    import chip_smoke
    assert chip_smoke._megakernel_work is roofline.megakernel_work
    assert chip_smoke._bound is roofline.bound
    for args, f32, bf16 in (((32, 2, 1024), 156.8, 326.4),
                            ((8, 2, 2304), 88.2, 413.1)):
        _, got32, got16 = roofline.megakernel_work(*args, 19, 256, 4096, 1,
                                                   True)
        assert round(got32 / 1e9, 1) == f32 and round(got16 / 1e9, 1) == bf16
    ms, by = roofline.bound(0.0, 156.8e9, 326.4e9)
    assert by == "operations" and math.isclose(
        ms, (156.8e9 / 67e12 + 326.4e9 / 989e12) * 1e3)


def test_work_count_scales_with_the_width():
    """``megakernel_work`` at another width: 156.8 + 326.4 GFLOP at n_embd
    64 (in heads of 4 or of 8: the head split moves no operation), and at
    n_embd 256 in heads of 16 with an MLP of 1024 the f32 products as
    written (QKV 6 C^2, proj 2 C^2, MLP 4 C hidden a row and layer, the
    logits 2 C (K - 1) a row) and QK^T + PV at 4 L C a row and layer; the
    bound takes each f32 product by its cheapest exact route on the tensor
    cores: with bf16 weights three bf16 products at 989 TFLOP/s (the
    activations in three bf16 planes; two TF32 products at 495 would take
    longer), 0.81 ms at n_embd 64, 7.68 ms at 256; with f32 weights three
    TF32 products (1.28 ms, 14.0 ms)."""
    rows, L, layers, kv = 32 * 2 * 1024, 1024, 19, 4096
    for n_head in (16, 8):
        nbytes, f32, bf16 = roofline.megakernel_work(
            32, 2, L, layers, 256, kv, 1, True, n_embd=64, n_head=n_head)
        assert (round(f32 / 1e9, 1), round(bf16 / 1e9, 1)) == (156.8, 326.4)
        for w_bf16, want in ((True, 0.81), (False, 1.28)):
            ms, by = roofline.megakernel_bound(nbytes, f32, bf16,
                                               weights_bf16=w_bf16)
            assert by == "operations" and round(ms, 2) == want
    c, hidden = 256, 1024
    nbytes, f32, bf16 = roofline.megakernel_work(
        32, 2, L, layers, hidden, kv, 1, True, n_embd=c, n_head=16)
    assert f32 == float(6 * c * c + 2 * c * c + 4 * c * hidden) * rows * \
        layers + 2.0 * c * kv * rows
    assert bf16 == 4.0 * L * c * rows * layers
    for w_bf16, want_ms, want in (
            (True, (3 * f32 + bf16) / 989e12 * 1e3, 7.68),
            (False, (3 * f32 / 495e12 + bf16 / 989e12) * 1e3, 14.02)):
        ms, by = roofline.megakernel_bound(nbytes, f32, bf16,
                                           weights_bf16=w_bf16)
        assert by == "operations" and math.isclose(ms, want_ms)
        assert round(ms, 2) == want
    # the two TF32 halves would be the dearer route with bf16 weights
    assert 2 / 495e12 > 3 / 989e12
