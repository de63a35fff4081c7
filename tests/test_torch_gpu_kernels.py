"""The port's hand-written kernels against their plain versions, on a CUDA
card: ``python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py``
(``tests/conftest.py`` imports jax, which a machine for the port may lack).

Each test asks the ``cuda`` fixture for the device, and the fixture skips
where there is none: the decision is made while the tests run, never while
the module is imported, so every worker collects the same tests.

The whole-step kernels' case builder, their check against the plain version
and its tolerances are ``chip_smoke.py``'s, one copy for both.
"""
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from gif_synthesis_with_discrete_diffusion_tpu_torch.models.d3pm import (
    make_schedule)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
    BF16_EXCESS_TOL, fused_mha, fused_mha_bwd, fused_mha_bwd_reference,
    sdpa_reference)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
    import code_stats_reference, nearest_code_stats, \
    nearest_code_stats_reference
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    megakernel as mk)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
    import (fused_sample_step, fused_sample_step_reference, schedule_rows)

pytestmark = pytest.mark.gpu

# the posterior tolerance of tests/test_sampler_kernel.py
K1_TOL = 1e-4
# the rtol = atol of tests/test_attention_kernel.py
K2_TOL = 2e-4
# the gradients' rtol = atol of tests/test_attention_kernel.py
K5_TOL = 5e-4
# K6: indices where the plain top-two distance margin exceeds this (f32
# sums in another order), statistics against the kernel's own indices
K6_MARGIN = 1e-3
K6_TOL = 1e-4
MK_MARGIN = chip_smoke.MK_MARGIN

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    chip_smoke._reference_precision(torch)
    return torch.device("cuda")


@pytest.mark.parametrize("k,L,guidance,t,scale", [
    (17, 40, 2.0, 7, 3.0), (17, 40, 1.0, 0, 3.0), (4097, 256, 2.0, 99, 3.0),
    (4097, 256, 2.0, 0, 3.0), (4097, 200, 1.0, 50, 3.0),
    # the half config's codebook; K-1 no multiple of 4 (element loads); K-1
    # below a float4 a thread
    (2049, 300, 2.0, 30, 3.0), (4094, 200, 2.0, 60, 3.0),
    (10, 40, 2.0, 3, 3.0),
    # 3, 5 and 7 chunks of 1024 classes a row, rounded up to 4 and 8: chunks
    # of padding before the last
    (2501, 200, 2.0, 30, 3.0), (5001, 100, 2.0, 40, 3.0),
    (7001, 64, 1.0, 20, 3.0),
    # logits this wide put classes under the -70 clamp: the guided
    # normaliser takes the full pass
    (4097, 128, 2.0, 40, 30.0), (17, 40, 2.0, 5, 30.0)])
def test_sampler_step_kernel_matches_plain(cuda, k, L, guidance, t, scale):
    B = 2
    g = torch.Generator(device=cuda).manual_seed(k + L + t)
    nb = 2 * B if guidance != 1.0 else B
    logits2 = (scale * torch.randn((nb, L, k - 1), generator=g,
                                   device=cuda)).transpose(1, 2)
    tokens = torch.randint(0, k, (B, L), generator=g, device=cuda)
    row = schedule_rows(make_schedule(100, k, device=cuda))[t]
    kw = dict(guidance=guidance, num_classes=k, sample=False,
              return_posterior=True)
    before = fused_sample_step.launches
    tok_k, post_k = fused_sample_step(logits2, tokens, row, 5, **kw)
    assert fused_sample_step.launches == before + 1
    tok_p, post_p = fused_sample_step_reference(logits2, tokens, row, 5, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(post_k, post_p, rtol=0, atol=K1_TOL)
    top2 = post_p.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > K1_TOL
    assert not ((tok_k != tok_p) & decided).any()


def test_sampler_step_kernel_refuses_what_it_does_not_take(cuda):
    """A class axis that is not contiguous raises: the wrapper never copies
    the logits. K-1 above the rows the kernel holds in registers no longer
    does: it takes the wide kernel and equals the plain version."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
        import REGISTER_CLASSES
    row = schedule_rows(make_schedule(100, 17, device=cuda))[3]
    tokens = torch.zeros((2, 8), dtype=torch.int64, device=cuda)
    strided = torch.randn((4, 16, 8), device=cuda)   # (nb, K-1, L) contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fused_sample_step(strided, tokens, row, 1, guidance=2.0,
                          num_classes=17)
    k = REGISTER_CLASSES + 2
    row = schedule_rows(make_schedule(100, k, device=cuda))[3]
    big = torch.randn((2, 8, k - 1), device=cuda).transpose(1, 2)
    tokens = torch.full((2, 8), k - 1, dtype=torch.int64, device=cuda)
    kw = dict(guidance=1.0, num_classes=k, sample=False,
              return_posterior=True)
    before = fused_sample_step.launches
    tok_k, post_k = fused_sample_step(big, tokens, row, 1, **kw)
    assert fused_sample_step.launches == before + 1
    tok_p, post_p = fused_sample_step_reference(big, tokens, row, 1, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(post_k, post_p, rtol=0, atol=K1_TOL)
    top2 = post_p.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > K1_TOL
    assert not ((tok_k != tok_p) & decided).any()


@pytest.mark.parametrize("kv,guidance", [
    (8193, 2.0), (10241, 2.0), (16384, 2.0), (16384, 1.0), (32768, 2.0),
    (32769, 1.0)])
def test_sampler_step_kernel_matches_plain_past_8192_classes(cuda, kv,
                                                             guidance):
    """The wide kernel (rows in shared memory, and at 32768 classes under
    guidance from device memory; 10241: element loads) against the plain
    version: the posterior within K1_TOL, argmax tokens equal where
    decided, sampled tokens in range and repeatable by seed."""
    k, B, L = kv + 1, 2, 96
    g = torch.Generator(device=cuda).manual_seed(kv)
    nb = 2 * B if guidance != 1.0 else B
    logits2 = (3.0 * torch.randn((nb, L, kv), generator=g, device=cuda)
               ).transpose(1, 2)
    tokens = torch.randint(0, k, (B, L), generator=g, device=cuda)
    row = schedule_rows(make_schedule(100, k, device=cuda))[40]
    kw = dict(guidance=guidance, num_classes=k)
    tok_k, post_k = fused_sample_step(logits2, tokens, row, 5, sample=False,
                                      return_posterior=True, **kw)
    tok_p, post_p = fused_sample_step_reference(
        logits2, tokens, row, 5, sample=False, return_posterior=True, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(post_k, post_p, rtol=0, atol=K1_TOL)
    top2 = post_p.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > K1_TOL
    assert not ((tok_k != tok_p) & decided).any()
    draw = [fused_sample_step(logits2, tokens, row, s, **kw)
            for s in (1, 1, 2)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    assert draw[0].min() >= 0 and draw[0].max() < k


def test_sampler_step_kernel_samples_in_range_and_by_seed(cuda):
    k, B, L = 4097, 2, 256
    g = torch.Generator(device=cuda).manual_seed(0)
    logits2 = torch.randn((2 * B, L, k - 1), generator=g,
                          device=cuda).transpose(1, 2)
    tokens = torch.full((B, L), k - 1, dtype=torch.int64, device=cuda)
    row = schedule_rows(make_schedule(100, k, device=cuda))[60]
    draw = [fused_sample_step(logits2, tokens, row, s, guidance=2.0,
                              num_classes=k) for s in (1, 1, 2)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    assert draw[0].min() >= 0 and draw[0].max() < k


# the wg design's cases: each head width of chip_smoke.py's phase 20 (12
# in the instantiation 16, heads of 12 bf16 starting on 8 bytes: copied by
# cp.async, not TMA), widths no instantiation's (6, 20, 100; 3 and 5: bf16
# rows on 2 bytes), over lengths no multiple of a tile, one key, 33 and 77
# keys (one tile of the dq kernel or two) and a long self-attention
WIDE_CASES = [(2, 300, 300, 2 * d, 2) for d in (12, 16, 32, 64, 128)] + [
    (2, 257, 77, 4 * d, 4) for d in (12, 64, 128)] + [
    (3, 100, 1, 2 * d, 2) for d in (12, 64, 128)] + [
    (2, 100, 33, 2 * d, 2) for d in (20, 64, 128)] + [
    (1, 130, 1100, 16 * 64, 16), (2, 64, 70, 3 * 6, 3),
    (2, 90, 90, 2 * 100, 2), (2, 50, 50, 3 * 3, 3), (1, 40, 9, 5 * 5, 5)]


@pytest.mark.parametrize("B,Lq,Lk,C,H", [
    (2, 16, 16, 64, 16), (2, 16, 1, 64, 16), (1, 24, 77, 64, 8),
    (2, 16, 16, 32, 4), (2, 300, 300, 64, 16), (3, 257, 77, 64, 16),
    (2, 100, 33, 64, 16), (1, 100, 2304, 64, 16), (2, 300, 300, 64, 8),
    *WIDE_CASES])
def test_attention_kernel_matches_plain(cuda, B, Lq, Lk, C, H):
    g = torch.Generator(device=cuda).manual_seed(Lq * Lk)
    q, k, v = (torch.randn((B, n, C), generator=g, device=cuda)
               for n in (Lq, Lk, Lk))
    before = fused_mha.launches
    at_d = fused_mha.by_head_dim[C // H, q.dtype]
    got = fused_mha(q, k, v, n_head=H)
    assert fused_mha.launches == before + 1
    assert fused_mha.by_head_dim[C // H, q.dtype] == at_d + 1
    torch.testing.assert_close(got, sdpa_reference(q, k, v, H), rtol=K2_TOL,
                               atol=K2_TOL)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wg_tiles_are_the_kernels(cuda, dtype, D):
    """The wg design's sizes the plain arithmetic mirrors
    (``ops/attention.py: wg_tiles``) are those the kernels were built with
    (``csrc/mha_wg.cuh: Cfg``, reported by ``fused_mha_wg_tiles``)."""
    import ctypes
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import attention
    lib = attention._library()
    lib.fused_mha_wg_tiles.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    out = (ctypes.c_int * 6)()
    assert lib.fused_mha_wg_tiles(D, int(dtype == torch.bfloat16), out) == 0
    assert {"fwd": tuple(out[0:2]), "dq": tuple(out[2:4]),
            "kv": tuple(out[4:6])} == attention.wg_tiles(D, dtype)


@pytest.mark.parametrize("D", [144, 200, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_tiles_are_the_kernels(cuda, dtype, D):
    """The stream design's sizes the plain arithmetic and the shared-memory
    test mirror (``ops/attention.py: stream_tiles``) are those the kernels
    were built with (``csrc/mha_wg.cuh: Stream``, reported by
    ``fused_mha_stream_tiles``)."""
    import ctypes
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import attention
    lib = attention._library()
    lib.fused_mha_stream_tiles.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    out = (ctypes.c_int * 12)()
    assert lib.fused_mha_stream_tiles(D, int(dtype == torch.bfloat16),
                                      out) == 0
    assert {"fwd": tuple(out[0:4]), "dq": tuple(out[4:8]),
            "kv": tuple(out[8:12])} == attention.stream_tiles(D, dtype)


@pytest.mark.parametrize("d", [129, 256, 641])
def test_attention_kernel_refuses_other_head_dims(cuda, d):
    """Every head dim is taken: above 128 the stream design (at 641 in
    three column chunks), forward and backward equal to the plain versions;
    widths no multiple of the heads still raise."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v, do = (torch.randn((2, n, 2 * d), generator=g, device=cuda)
                   for n in (70, 90, 90, 70))
    before = fused_mha.by_head_dim[d, q.dtype], fused_mha_bwd.launches
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    got = fused_mha(qg, kg, vg, n_head=2)
    got.backward(do)
    assert (fused_mha.by_head_dim[d, q.dtype], fused_mha_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, sdpa_reference(q, k, v, 2), rtol=K2_TOL,
                               atol=K2_TOL)
    for x, w in zip((qg.grad, kg.grad, vg.grad),
                    fused_mha_bwd_reference(q, k, v, do, 2)):
        torch.testing.assert_close(x, w, rtol=K5_TOL, atol=K5_TOL)
    with pytest.raises(ValueError):
        fused_mha(q, q, q, n_head=5)       # 2 d is no multiple of 5


@pytest.mark.parametrize("d", [129, 130, 200, 640])
def test_stream_bf16_at_every_copy_mode(cuda, d):
    """The stream design in bf16 where a head's row is no multiple of 16
    bytes (129, 130: the producer copies by cp.async, 2 and 4 bytes a
    copy), where the head is no multiple of 64 (200) and in three column
    chunks (640): K2 and K5 against the plain versions in f32 of the same
    inputs within BF16_EXCESS_TOL beyond the rounding, o32 within K2_TOL,
    two K5 launches bitwise equal."""
    r = chip_smoke._bf16_attention_case(torch, 2, 70, 90, 2 * d, 2)
    assert r["o32_ok"] and r["same"], r
    assert max(r[n] for n in ("o", "dq", "dk", "dv")) <= BF16_EXCESS_TOL, r


def test_small_slice_on_the_card_matches_the_cpu(cuda):
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        build_models, sample_token_grid)
    config = {
        "vqvae": {"embedding_dim": 16, "n_codes": 16, "n_hiddens": 32,
                  "n_res_layers": 1, "downsample": (1, 2, 2),
                  "sequence_length": 2, "resolution": 8},
        "generator": {
            "diffusion_model": {"diffusion_step": 8, "guidance_scale": 2.0,
                                "transformer": {"n_layer": 2, "n_embd": 64,
                                                "n_head": 16,
                                                "condition_dim": 32}},
            "textencoder": {"mode": "label", "n_classes": 5, "dim": 32}},
    }
    for sampler in ("model", "megakernel"):
        out = {}
        for dev in (cuda, torch.device("cpu")):
            models = build_models(config, dev,
                                  torch.Generator().manual_seed(3))
            tok = sample_token_grid(models, {"label": torch.tensor([1, 2])},
                                    torch.Generator().manual_seed(4),
                                    sample=False, sampler=sampler)
            with torch.no_grad():
                out[dev.type] = (tok.cpu(), models.vqvae.decode(tok).cpu())
        assert torch.equal(out["cuda"][0], out["cpu"][0]), sampler
        torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("B,Lq,Lk,C,H", [
    (2, 16, 16, 64, 16), (2, 300, 300, 64, 16), (3, 257, 77, 64, 16),
    (1, 24, 77, 64, 8), (8, 1024, 1024, 64, 16), (8, 1024, 1, 64, 16),
    (8, 1024, 77, 64, 16), (2, 2304, 2304, 64, 16), (2, 100, 33, 64, 16),
    (1, 100, 2304, 64, 16), (2, 300, 300, 64, 8), *WIDE_CASES])
def test_attention_backward_kernel_matches_plain(cuda, B, Lq, Lk, C, H):
    g = torch.Generator(device=cuda).manual_seed(Lq + 7 * Lk)
    q, k, v = (torch.randn((B, n, C), generator=g, device=cuda)
               .requires_grad_() for n in (Lq, Lk, Lk))
    do = torch.randn((B, Lq, C), generator=g, device=cuda)
    before = (fused_mha.launches, fused_mha_bwd.launches)
    at_d = fused_mha_bwd.by_head_dim[C // H, q.dtype]
    (fused_mha(q, k, v, n_head=H) * do).sum().backward()
    assert (fused_mha.launches, fused_mha_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert fused_mha_bwd.by_head_dim[C // H, q.dtype] == at_d + 1
    want = fused_mha_bwd_reference(q.detach(), k.detach(), v.detach(), do, H)
    torch.cuda.synchronize()
    for name, got, wnt in zip("qkv", (q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, wnt, rtol=K5_TOL, atol=K5_TOL,
                                   msg=f"d{name}")


@pytest.mark.parametrize("B,Lq,Lk,C,H", [*chip_smoke.ATTN_CASES,
                                         *WIDE_CASES])
def test_attention_kernels_bf16_within_a_bf16_step(cuda, B, Lq, Lk, C, H):
    """K2 and K5 with bf16 inputs: f32 inside, outputs rounded once. K2's
    f32 output within K2_TOL of the plain version in f32 of the same
    inputs; every bf16 output within BF16_EXCESS_TOL of its magnitude
    beyond its rounding, which P and dS rounded to bf16 miss."""
    before = (fused_mha.launches, fused_mha_bwd.launches)
    r = chip_smoke._bf16_attention_case(torch, B, Lq, Lk, C, H)
    assert (fused_mha.launches, fused_mha_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    assert r["o32_ok"], r["o32"]
    for name in ("o", "dq", "dk", "dv"):
        assert r[name] <= BF16_EXCESS_TOL, (name, r)
        if Lk > 1:
            assert r["control"][name] > BF16_EXCESS_TOL, (name, r)
    assert r["same"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Lk", [1, 77, 1024])
@pytest.mark.parametrize("d", [4, 64])
def test_attention_backward_is_deterministic(cuda, dtype, Lk, d):
    """No float atomics: two launches on the same inputs give the same
    bits, in both designs."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention \
        import _fwd_kernel
    g = torch.Generator(device=cuda).manual_seed(Lk)
    q, k, v, do = (torch.randn((4, n, 16 * d), generator=g, device=cuda)
                   .to(dtype) for n in (1024, Lk, Lk, 1024))
    o, lse, o32 = _fwd_kernel(q, k, v, 16, with_lse=True)
    first = fused_mha_bwd(q, k, v, o32, lse, do, n_head=16)
    second = fused_mha_bwd(q, k, v, o32, lse, do, n_head=16)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_kernels_refuse_mixed_types(cuda):
    q = torch.randn((1, 8, 64), device=cuda)
    with pytest.raises(TypeError):
        fused_mha(q, q.to(torch.bfloat16), q, n_head=16)
    with pytest.raises(TypeError):
        fused_mha(q.half(), q.half(), q.half(), n_head=16)


def test_sampler_step_kernel_past_two_to_31_counters(cuda):
    """B K L >= 2^31 (B=228 at the 2304-token grid): the argmax equals the
    plain version's where decided, sampled tokens lie in range. Past 2^32
    (512 rows of one row's logits) the noise does not repeat and the draws
    follow the posterior (``chip_smoke._check_k1_noise_past_wrap``)."""
    k, B, L = 4097, 228, 2304
    g = torch.Generator(device=cuda).manual_seed(3)
    logits = torch.randn((B, L, k - 1), generator=g,
                         device=cuda).transpose(1, 2)
    tokens = torch.full((B, L), k - 1, dtype=torch.int64, device=cuda)
    row = schedule_rows(make_schedule(100, k, device=cuda))[40]
    kw = dict(guidance=1.0, num_classes=k)
    tok_k = fused_sample_step(logits, tokens, row, 9, sample=False, **kw)
    drawn = fused_sample_step(logits, tokens, row, 9, sample=True, **kw)
    assert int(drawn.min()) >= 0 and int(drawn.max()) < k
    for r0 in range(0, B, 19):
        sl = slice(r0, r0 + 19)
        tok_p, post_p = fused_sample_step_reference(
            logits[sl], tokens[sl], row, 9, sample=False,
            return_posterior=True, **kw)
        top2 = post_p.topk(2, dim=1).values
        decided = (top2[:, 0] - top2[:, 1]) > K1_TOL
        assert not ((tok_k[sl] != tok_p) & decided).any()
    del logits, tok_k, drawn, tok_p, post_p
    torch.cuda.empty_cache()
    chip_smoke._check_k1_noise_past_wrap(torch, seed=9)


def test_codebook_kernel_mode_xla_takes_the_plain_lookup(cuda):
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.vqvae import (
        Codebook)
    z = torch.randn((2, 4, 4, 4, 16), device=cuda)
    got = {}
    for mode in ("xla", "auto"):
        cb = Codebook(32, 16, kernel_mode=mode).to(cuda)
        cb.embeddings.copy_(torch.randn((32, 16),
                                        generator=torch.Generator()
                                        .manual_seed(0)).to(cuda))
        before = nearest_code_stats.launches
        got[mode] = cb(z)["encodings"]
        assert nearest_code_stats.launches - before == (mode == "auto")
    assert torch.equal(got["xla"], got["auto"])


def test_drift_bounds_hold_on_the_card(cuda):
    """The coupled bf16-weight drift (probes/drift_probe.py) over the first
    reverse steps at the honest grid within tests/test_drift_bounds.py's
    five bounds, and the whole-step kernel's tokens equal side B's argmax
    where decided."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        HONEST)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        drift_probe)
    # tests/test_drift_bounds.py by its path (without the repo's conftest,
    # ``tests`` may name another package)
    spec = importlib.util.spec_from_file_location(
        "drift_bounds", Path(__file__).with_name("test_drift_bounds.py"))
    bounds = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bounds)
    out = drift_probe.coupled_drift(HONEST, batch=2, steps=4, seed=3,
                                    device="cuda")
    for key, bound in bounds.BOUNDS.items():
        assert out["coupled_per_step"][key] <= bound, key
    assert out["kernel_vs_side_b"]["token_mismatches"] == 0


@pytest.mark.parametrize("n,k,d", [
    (96, 16, 16), (1000, 300, 128), (64, 257, 130), (16384, 4096, 128),
    # D no multiple of 8 (and of 4: element copies of E), D at its limit
    (500, 600, 20), (300, 700, 30), (200, 300, 384)])
def test_codebook_kernel_matches_plain(cuda, n, k, d):
    g = torch.Generator(device=cuda).manual_seed(n + k)
    x = torch.randn((n, d), generator=g, device=cuda)
    emb = torch.randn((k, d), generator=g, device=cuda)
    before = nearest_code_stats.launches
    idx, n_total, encode_sum = nearest_code_stats(x, emb)
    assert nearest_code_stats.launches == before + 1
    ref_idx = nearest_code_stats_reference(x, emb)[0]
    dist = -2.0 * (x @ emb.t()) + (emb * emb).sum(dim=-1)[None, :]
    top2 = (-dist).topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > K6_MARGIN
    torch.cuda.synchronize()
    assert not ((idx != ref_idx) & decided).any()
    want_n, want_sum = code_stats_reference(x, idx, k)
    torch.testing.assert_close(n_total, want_n, rtol=0, atol=0)
    torch.testing.assert_close(encode_sum, want_sum, rtol=K6_TOL, atol=K6_TOL)


@pytest.mark.parametrize("n,k,d", [
    (500, 512, 385), (4096, 4096, 512), (300, 700, 1024),
    (16384, 16384, 512)])
def test_codebook_kernel_matches_plain_past_dim_384(cuda, n, k, d):
    """x streamed beside E (D above 384) through K6's three entries: the
    indices equal to the f64 argmin wherever its top-two margin exceeds
    ``chip_smoke.k6_margin(D)``, the statistics of its own indices, the
    distance entry's indices the same and its distances within a quarter
    of that margin, and two shards' nearest the unsharded index."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
        import nearest_code_dist
    g = torch.Generator(device=cuda).manual_seed(n + k + d)
    x = torch.randn((n, d), generator=g, device=cuda)
    emb = torch.randn((k, d), generator=g, device=cuda)
    margin = chip_smoke.k6_margin(d)
    before = nearest_code_stats.by_dim[d]
    idx, n_total, encode_sum = nearest_code_stats(x, emb)
    assert nearest_code_stats.by_dim[d] == before + 1
    xd, ed = x.double(), emb.double()
    dist = -2.0 * (xd @ ed.t()) + (ed * ed).sum(dim=-1)[None, :]
    top2 = (-dist).topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > margin
    assert not ((idx != dist.argmin(dim=1)) & decided).any()
    want_n, want_sum = code_stats_reference(x, idx, k)
    torch.testing.assert_close(n_total, want_n, rtol=0, atol=0)
    torch.testing.assert_close(encode_sum, want_sum, rtol=K6_TOL, atol=K6_TOL)
    d_idx, d_dist = nearest_code_dist(x, emb)
    assert torch.equal(d_idx, idx)
    want_dist = dist.gather(1, idx.long()[:, None])[:, 0]
    assert float((d_dist.double() - want_dist).abs().max()) <= margin / 4
    half = k // 2
    lo_i, lo_d = nearest_code_dist(x, emb[:half].contiguous())
    hi_i, hi_d = nearest_code_dist(x, emb[half:].contiguous())
    assert torch.equal(torch.where(hi_d < lo_d, hi_i + half, lo_i), idx)


@pytest.mark.parametrize("d", [128, 130])
def test_codebook_kernel_ties_keep_the_first_code(cuda, d):
    """Codes repeated in another E tile (131 and 300 codes on): the rows
    whose nearest code is repeated take its first copy, and every decided
    row agrees with the plain version."""
    chip_smoke._check_k6_duplicates(torch, 3000, 1000, d)


def test_small_training_step_on_the_card_matches_the_cpu(cuda):
    got = chip_smoke._small_train_step(torch, "cuda")
    want = chip_smoke._small_train_step(torch, "cpu")
    # a key bias's gradient is zero analytically: scales are floored at
    # 1e-4 of the largest gradient
    lerr, gerr = chip_smoke._compare_train_steps(got, want, False)
    assert lerr <= chip_smoke.TRAIN_LOSS_RTOL
    assert gerr <= chip_smoke.TRAIN_GRAD_TOL


def _megakernel_case(device, **case):
    """A denoiser with every parameter drawn, and one step's arguments."""
    assert device.type == "cuda"
    return chip_smoke._megakernel_case(torch, **case)


def _check_megakernel(args, kw, pack_cfg, witness=False):
    """One argmax step of the kernel against the plain version: the hidden
    state it leaves in its scratch (within the width's tolerance,
    ``chip_smoke.mk_hidden_tol``: MK_HIDDEN_TOL at n_embd 64), then the
    tokens; with ``witness``, the tolerance must also fail the plain
    version's one-TF32 form. Raises AssertionError where they disagree."""
    n_embd, n_head = kw["n_embd"], kw["n_head"]
    tol = chip_smoke.mk_hidden_tol(n_embd, n_embd // n_head, 4 * n_embd)
    return chip_smoke._check_megakernel(torch, "test", "case", args, kw,
                                        pack_cfg, tol, witness)[0]


# the widths of the streamed-key cases below, beside chip_smoke.MK_WIDTHS
STREAM_WIDTHS = ((64, 2), (128, 2), (128, 1), (256, 16), (512, 2), (512, 1),
                 (2048, 2))


@pytest.fixture(scope="session")
def mk_libraries():
    """Every whole-step library the width tests launch, built before the
    first of them, chip_smoke.MK_BUILD_WORKERS nvcc at a time, the widest
    first (one after another, a cold run of ``-k megakernel`` spent its time
    limit building); {(n_embd, head dim): library}."""
    from concurrent.futures import ThreadPoolExecutor
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    widths = sorted({(c, c // h) for c, h in
                     chip_smoke.MK_WIDTHS + STREAM_WIDTHS},
                    key=lambda w: -w[0])
    with ThreadPoolExecutor(chip_smoke.MK_BUILD_WORKERS) as pool:
        libs = list(pool.map(lambda w: mk._library((), w), widths))
    return dict(zip(widths, libs))


# K3 and K4 at every width of chip_smoke.MK_WIDTHS (n_embd, n_head): head
# dims 3 to 1024, n_embd 24 to 2048; small depth, a general and a one-token
# condition, f32 and bf16 weights, ragged tiles
WIDTH_CASES = [
    ("K3-general", True, dict(L=96, spatial=(12, 8), k=200, n_layer=2,
                              s_len=3, B=2, use_cfg=True,
                              dtype=torch.bfloat16)),
    ("K3-bias-f32", True, dict(L=64, spatial=(8, 8), k=17, n_layer=2,
                               s_len=1, B=2, use_cfg=True,
                               dtype=torch.float32)),
    ("K4-guidance1-general", False, dict(L=96, spatial=(12, 8), k=200,
                                         n_layer=2, s_len=3, B=2,
                                         use_cfg=False,
                                         dtype=torch.bfloat16)),
    ("K4-cfg-ragged", False, dict(L=200, spatial=(20, 10), k=17, n_layer=2,
                                  s_len=1, B=3, use_cfg=True,
                                  dtype=torch.bfloat16)),
]


@pytest.mark.parametrize("name,pack_cfg,case", WIDTH_CASES,
                         ids=[c[0] for c in WIDTH_CASES])
@pytest.mark.parametrize("n_embd,n_head", chip_smoke.MK_WIDTHS,
                         ids=[f"{c}x{h}" for c, h in chip_smoke.MK_WIDTHS])
def test_megakernels_match_plain_at_every_width(cuda, mk_libraries, n_embd,
                                                n_head, name, pack_cfg, case):
    """K3 / K4 against the plain version: the hidden state's max-abs within
    the width's tolerance, its RMS within MK_RMS_SHARE of the one-TF32
    control's, the tokens, and the launch counted at this width."""
    args, kw = _megakernel_case(cuda, **case, seed=n_embd + n_head,
                                n_embd=n_embd, n_head=n_head)
    _check_megakernel(args, kw, pack_cfg=pack_cfg, witness=True)
    width = (n_embd, n_embd // n_head, "K3" if pack_cfg else "K4")
    assert mk.megakernel_step.launches_by_width[width] > 0


@pytest.mark.parametrize("n_embd,n_head,L,spatial,pack_cfg,whole", [
    (64, 2, 2304, (48, 48), False, False),     # heads of 32: 295 KB a head
    (128, 2, 1024, (32, 32), True, False),     # heads of 64: 262 KB
    (128, 1, 1024, (32, 32), True, False),     # heads of 128: 524 KB
    (256, 16, 2304, (48, 48), False, True),    # heads of 16: 221 KB, whole
    (512, 2, 1024, (32, 32), True, False),     # heads of 256: 1 MB
    (512, 1, 2304, (48, 48), False, False),    # heads of 512: 4.7 MB
    (512, 1, 96, (12, 8), True, True),         # heads of 512: 195 KB, whole
    (2048, 2, 1024, (32, 32), True, False),    # heads of 1024: 4 MB
    (2048, 2, 48, (8, 6), False, True),        # heads of 1024: 198 KB, whole
], ids=["d32-L2304", "d64-L1024", "d128-L1024", "d16-L2304", "d256-L1024",
        "d512-L2304", "d512-L96", "d1024-L1024", "d1024-L48"])
def test_megakernels_stream_keys_that_do_not_fit(cuda, mk_libraries, n_embd,
                                                 n_head, L, spatial, pack_cfg,
                                                 whole):
    """Where a head's keys and values (4 d L bytes) exceed a block's 227 KB,
    phase S streams them through two buffers of 64 keys (32 at heads of
    512, 16 at heads of 1024); where they just fit, it stages them whole.
    Heads wider than 128 take their output in chunks of 128 dims, each a
    sweep of its own. All against the plain version."""
    lib = mk._library((), (n_embd, n_embd // n_head))
    assert bool(lib.megakernel_keys_whole(L)) == whole
    args, kw = _megakernel_case(cuda, L=L, spatial=spatial, k=17, n_layer=2,
                                s_len=3 if pack_cfg else 1, B=1,
                                use_cfg=True, dtype=torch.bfloat16,
                                seed=L + n_embd, n_embd=n_embd,
                                n_head=n_head)
    _check_megakernel(args, kw, pack_cfg=pack_cfg)


def test_megakernels_at_one_head_of_2048(cuda):
    """A single head of 2048 dims (keys through one buffer of 16 keys,
    sixteen output chunks) against the plain version in every width case.
    Its scores reach ~700 with top-two gaps of ~1e-3: where the products
    were one chain of mma the truncated sums moved queries to other keys,
    0.98 of the one-TF32 control's RMS distance (PERF.md)."""
    for name, pack_cfg, case in WIDTH_CASES:
        args, kw = _megakernel_case(cuda, **case, seed=4096, n_embd=2048,
                                    n_head=1)
        _check_megakernel(args, kw, pack_cfg=pack_cfg, witness=True)


@pytest.mark.parametrize("n_embd,d", [(64, 4), (64, 8), (256, 16),
                                       (512, 256), (520, 130), (1000, 125),
                                       (1024, 64)])
def test_wide_megakernel_products_run_on_wgmma(cuda, n_embd, d):
    """At every width but the serving one (n_embd 64 in heads of 4) the
    library's SASS issues wgmma (``HGMMA``: the bf16-weight products of
    phases A and B) beside ``mma.sync`` (``HMMA``: f32 weights, phase S,
    the tail); the serving width's own code only ``mma.sync``."""
    lib = mk._library((), (n_embd, d))
    counts = chip_smoke._sass_counts(lib._name, ("HGMMA", "HMMA"))
    assert counts["HMMA"] > 0, counts
    assert (counts["HGMMA"] > 0) == ((n_embd, d) != (64, 4)), counts


@pytest.mark.parametrize("n_embd,n_head", chip_smoke.MK_WIDTHS,
                         ids=[f"{c}x{h}" for c, h in chip_smoke.MK_WIDTHS])
def test_megakernels_scale_queries_as_jax(cuda, mk_libraries, n_embd,
                                          n_head):
    """Every width's kernels multiply the queries by fl32(1 / sqrt(d)), the
    factor of the JAX kernels and of the plain version (where q times it and
    q / sqrt(d) round to different bf16 values, the CPU tests show the plain
    version on JAX's side: tests/test_torch_megakernel.py)."""
    import math

    import numpy as np
    d = n_embd // n_head
    lib = mk._library((), (n_embd, d))
    assert (lib.megakernel_width(0), lib.megakernel_width(1)) == (n_embd, d)
    assert lib.megakernel_qscale() == float(np.float32(1.0 / math.sqrt(d)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("L,spatial,k,n_layer,s_len,B", [
    (40, (8, 8), 17, 2, 1, 3),            # ragged tiles, one class chunk
    (96, (12, 8), 200, 3, 3, 2),          # general cross-attention
    (64, (8, 8), 17, 2, 77, 2),           # a text-length condition
    (35, (7, 5), 133, 2, 77, 3),          # ... on a grid that is no multiple
                                          # of 8, of 16 keys or of a row tile
    (1024, (32, 32), 4097, 19, 1, 2),     # the serving width
    # more work items than blocks of the persistent grid: every block loops
    (200, (20, 10), 17, 2, 3, 48),        # ... over ragged tiles
    (1024, (32, 32), 4097, 19, 1, 32),    # ... at the serving batch
])
def test_packed_megakernel_matches_plain(cuda, L, spatial, k, n_layer, s_len,
                                         B, dtype):
    args, kw = _megakernel_case(cuda, L=L, spatial=spatial, k=k,
                                n_layer=n_layer, s_len=s_len, B=B,
                                use_cfg=True, dtype=dtype, seed=L + k)
    _check_megakernel(args, kw, pack_cfg=True)


@pytest.mark.parametrize("L,spatial,k,n_layer,s_len,B,use_cfg", [
    (40, (8, 8), 17, 2, 1, 3, False),
    (40, (8, 8), 17, 2, 1, 3, True),
    (96, (12, 8), 200, 3, 3, 2, True),
    (64, (8, 8), 17, 2, 77, 2, False),
    (1024, (32, 32), 4097, 19, 1, 2, False),     # guidance 1
    (2304, (48, 48), 4097, 19, 1, 2, True),      # the MSRVTT grid
    (2304, (48, 48), 4097, 4, 77, 1, True),      # ... with a text condition
    # more work items than blocks of the persistent grid: every block loops
    (200, (20, 10), 17, 2, 3, 48, True),
    (1024, (32, 32), 4097, 19, 1, 32, False),
    (2304, (48, 48), 4097, 19, 1, 8, True),      # the MSRVTT serving batch
])
def test_branch_megakernel_matches_plain(cuda, L, spatial, k, n_layer, s_len,
                                         B, use_cfg):
    args, kw = _megakernel_case(cuda, L=L, spatial=spatial, k=k,
                                n_layer=n_layer, s_len=s_len, B=B,
                                use_cfg=use_cfg, dtype=torch.bfloat16,
                                seed=L + k + s_len)
    _check_megakernel(args, kw, pack_cfg=False)


@pytest.mark.parametrize("L,spatial,k,n_layer,s_len,B,use_cfg", [
    (35, (7, 5), 133, 2, 2, 3, False),
    (96, (12, 8), 200, 3, 3, 2, True),
    (1024, (32, 32), 4097, 19, 1, 2, True),
])
def test_branch_megakernel_matches_plain_f32_weights(cuda, L, spatial, k,
                                                     n_layer, s_len, B,
                                                     use_cfg):
    """f32 weights are split into TF32 halves like the activations."""
    args, kw = _megakernel_case(cuda, L=L, spatial=spatial, k=k,
                                n_layer=n_layer, s_len=s_len, B=B,
                                use_cfg=use_cfg, dtype=torch.float32,
                                seed=L + k + s_len)
    _check_megakernel(args, kw, pack_cfg=False)


@pytest.mark.parametrize("pack_cfg", [True, False], ids=["K3", "K4"])
def test_softmax_shift_against_exact_row_maxima(cuda, pack_cfg):
    """The build that shifts the scores by their bound where it may against
    the build that takes the exact row maximum everywhere, at query scales
    where every, some and no warp takes the bound."""
    chip_smoke._check_softmax_shift(torch, "test", pack_cfg)


@pytest.mark.parametrize("pack_cfg", [True, False], ids=["K3", "K4"])
@pytest.mark.parametrize("scale", [15.0, 60.0, 400.0])
def test_log_probabilities_under_the_clamp(cuda, pack_cfg, scale):
    """With the output projection scaled up, classes fall under the step's
    clamp at -70 in one or both branches: the tail then takes its extra pass
    for the guided normaliser instead of deriving it from the first pass."""
    args, kw = _megakernel_case(cuda, L=96, spatial=(12, 8), k=200, n_layer=2,
                                s_len=1, B=3, use_cfg=True,
                                dtype=torch.bfloat16, seed=21,
                                logit_scale=scale)
    _check_megakernel(args, kw, pack_cfg=pack_cfg)


@pytest.mark.parametrize("pack_cfg", [True, False], ids=["K3", "K4"])
def test_sampled_tokens_do_not_depend_on_the_grid_size(cuda, pack_cfg):
    """The noise of a class comes from the Philox counter (class / 4,
    position, batch row), not from the block or thread that draws it: one
    seed gives the same tokens on the full persistent grid and on a grid of
    37 or of 5 blocks (every block then loops over many work items)."""
    args, kw = _megakernel_case(cuda, L=200, spatial=(20, 10), k=4097,
                                n_layer=2, s_len=1, B=6, use_cfg=True,
                                dtype=torch.bfloat16, seed=12)
    want = mk.megakernel_step(*args[:7], 77, pack_cfg=pack_cfg, **kw)
    for blocks in (37, 5):
        got = mk.megakernel_step(*args[:7], 77, pack_cfg=pack_cfg,
                                 grid_blocks=blocks, **kw)
        assert torch.equal(got, want)
    other = mk.megakernel_step(*args[:7], 78, pack_cfg=pack_cfg, **kw)
    assert not torch.equal(other, want)


@pytest.mark.parametrize("B", [2, 32])
def test_branch_megakernel_equals_packed(cuda, B):
    args, kw = _megakernel_case(cuda, L=1024, spatial=(32, 32), k=4097,
                                n_layer=4, s_len=1, B=B, use_cfg=True,
                                dtype=torch.bfloat16, seed=5)
    k3 = mk.megakernel_step(*args, sample=False, pack_cfg=True, **kw)
    k4 = mk.megakernel_step(*args, sample=False, pack_cfg=False, **kw)
    assert torch.equal(k3, k4)


def test_one_token_condition_as_bias_equals_general_cross(cuda):
    a, kw = _megakernel_case(cuda, L=96, spatial=(12, 8), k=200, n_layer=3,
                             s_len=1, B=2, use_cfg=True, dtype=torch.float32,
                             seed=6)
    b, kwg = _megakernel_case(cuda, L=96, spatial=(12, 8), k=200, n_layer=3,
                              s_len=1, B=2, use_cfg=True, dtype=torch.float32,
                              seed=6, force_general=True)
    fast = _check_megakernel(a, kw, pack_cfg=True)
    general = _check_megakernel(b, kwg, pack_cfg=True)
    post = mk.megakernel_step_reference(*a, sample=False,
                                        return_posterior=True, **kw)[1]
    top2 = post.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > MK_MARGIN
    assert not ((fast != general) & decided).any()


def test_megakernel_samples_in_range_and_by_seed(cuda):
    args, kw = _megakernel_case(cuda, L=256, spatial=(16, 16), k=4097,
                                n_layer=2, s_len=1, B=2, use_cfg=True,
                                dtype=torch.bfloat16, seed=8)
    for pack_cfg in (True, False):
        draw = [mk.megakernel_step(*args[:7], s, pack_cfg=pack_cfg, **kw)
                for s in (1, 1, 2)]
        assert torch.equal(draw[0], draw[1])
        assert not torch.equal(draw[0], draw[2])
        assert draw[0].min() >= 0 and draw[0].max() < 4097


def test_megakernel_sampled_histogram_follows_the_posterior(cuda):
    """At K = 17 the classes drawn over many seeds follow the plain
    posterior: the total variation between the empirical class frequencies
    (over all positions and seeds) and the mean posterior stays under 0.03
    (25600 draws over 17 classes: sampling noise is ~0.01)."""
    k, L, B, n = 17, 64, 2, 200
    args, kw = _megakernel_case(cuda, L=L, spatial=(8, 8), k=k, n_layer=2,
                                s_len=1, B=B, use_cfg=True,
                                dtype=torch.bfloat16, seed=9, t=30)
    post = mk.megakernel_step_reference(*args, sample=False,
                                        return_posterior=True, **kw)[1]
    want = post.exp().sum(dim=(0, 2))
    want = want / want.sum()
    for pack_cfg in (True, False):
        counts = torch.zeros(k, device=cuda)
        for s in range(n):
            tok = mk.megakernel_step(*args[:7], 1000 + s, pack_cfg=pack_cfg,
                                     **kw)
            counts += torch.bincount(tok.flatten(), minlength=k)
        tv = 0.5 * (counts / counts.sum() - want).abs().sum().item()
        print(f"pack_cfg={pack_cfg}: total variation {tv:.4f}")
        assert tv < 0.03


def test_more_work_items_than_blocks(cuda):
    """The cases above marked so do exceed the persistent grid."""
    for packed in (0, 1):
        cap = mk._library().megakernel_grid_blocks(packed)
        assert 0 < cap < 48 * 7                     # B=48, L=200 in tiles
        assert cap < 8 * 2 * (2304 // 64)           # B=8, L=2304 tile items
        assert cap < 32 * (1024 // 64)              # B=32, L=1024, one branch


def test_auto_serves_a_width_the_kernels_are_not_built_for(cuda):
    """The default route of the entry point on the card at a width outside
    the source's own (n_embd 32 in heads of 4): ``auto`` takes the
    megakernel route (a K3 launch a step) and, in argmax mode, gives the
    tokens of the same route's plain version on the CPU (as phase 21 (c)
    of chip_smoke.py holds heads of 8). The model route (K2 then K1) is no
    yardstick for tokens: it rounds q, k, v and the probabilities nowhere,
    so its argmax may differ at near-ties."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        build_models, sample_token_grid)
    cfg = chip_smoke._small_train_config()
    cfg["generator"]["diffusion_model"]["transformer"].update(
        n_embd=32, n_head=8)
    batch = {"label": torch.tensor([0, 3, 4])}
    steps = cfg["generator"]["diffusion_model"]["diffusion_step"]
    got = {}
    for dev, sampler in (("cuda", "auto"), ("cpu", "megakernel")):
        models = build_models(cfg, dev, torch.Generator().manual_seed(11))
        before = mk.megakernel_step.launches_k3
        got[dev] = sample_token_grid(
            models, batch, torch.Generator().manual_seed(12), sample=False,
            sampler=sampler).cpu()
        assert mk.megakernel_step.launches_k3 - before == (
            steps if dev == "cuda" else 0)
    assert torch.equal(got["cuda"], got["cpu"])


def test_explicit_megakernel_refuses_heads_of_64(cuda):
    """Heads of 64 (n_embd 128 in 2 heads) are inside the whole-step
    kernels' domain: ``auto`` and an explicit 'megakernel' both launch K3 a
    step and give the same tokens. (The model route computes the same
    function with q, k, v and the probabilities unrounded: its argmax may
    differ at near-ties, so it is no yardstick here; the whole-step kernels
    are held to their plain version in test_megakernels_match_plain_at_every_
    width.)"""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        build_models, sample_token_grid)
    cfg = chip_smoke._small_train_config()
    cfg["generator"]["diffusion_model"]["transformer"].update(
        n_embd=128, n_head=2)
    models = build_models(cfg, "cuda", torch.Generator().manual_seed(11))
    batch = {"label": torch.tensor([0, 3, 4])}
    steps = cfg["generator"]["diffusion_model"]["diffusion_step"]
    got = {}
    for sampler in ("auto", "megakernel"):
        before = mk.megakernel_step.launches_k3
        got[sampler] = sample_token_grid(
            models, batch, torch.Generator().manual_seed(12), sample=False,
            sampler=sampler)
        assert mk.megakernel_step.launches_k3 - before == steps
    assert torch.equal(got["auto"], got["megakernel"])


@pytest.mark.parametrize("n_embd,n_head", [(2056, 8), (2304, 16), (4096, 1)],
                         ids=["n_embd2056", "n_embd2304", "heads_of_4096"])
def test_megakernel_refuses_other_widths(cuda, n_embd, n_head):
    """Outside the domain (n_embd above 2048, whatever its heads) the
    kernels raise: no library is built, nothing is launched, no route is
    taken in their place."""
    args, kw = _megakernel_case(cuda, L=40, spatial=(8, 8), k=17, n_layer=1,
                                s_len=1, B=2, use_cfg=True,
                                dtype=torch.bfloat16, seed=1, n_embd=n_embd,
                                n_head=n_head)
    before = (mk.megakernel_step.launches_k3, mk.megakernel_step.launches_k4)
    for pack_cfg in (True, False):
        with pytest.raises(ValueError, match="the kernels take"):
            mk.megakernel_step(*args, pack_cfg=pack_cfg, **kw)
    assert (mk.megakernel_step.launches_k3,
            mk.megakernel_step.launches_k4) == before
    args, kw = _megakernel_case(cuda, L=40, spatial=(8, 8), k=17, n_layer=2,
                                s_len=1, B=2, use_cfg=True,
                                dtype=torch.bfloat16, seed=1)
    with pytest.raises(ValueError):     # the packed kernel is the CFG kernel
        mk.megakernel_step(*args, pack_cfg=True, **dict(kw, use_cfg=False))


# one element; sizes no multiple of P1's 32 x 16 tile, or of 4 (element
# copies: 255, 333); more 64-deep chunks than its four stages (300, 520)
@pytest.mark.parametrize("n", [1, 16, 100, 255, 256, 300, 333, 520])
def test_probe_matmul_kernel_matches_plain(cuda, n):
    chip_smoke._check_probe_matmul(torch, "test", n)


@pytest.mark.parametrize("pair", [False, True], ids=["chain", "pair"])
@pytest.mark.parametrize("m,k,n,iters,ones", [
    (32, 16, 48, 1, False),          # one warp, a ragged grid of 3 blocks
    (64, 32, 2128, 3, False),        # slabs of 32 with a last one of 16
    (256, 64, 2048, 4, False),       # the depth curve's first shape
    (256, 512, 2048, 2, False),      # ... its last: x staged 256 deep twice
    (256, 64, 16384, 4, True),       # the QK shape, the probe's own x
    (256, 128, 32768, 2, False),     # the packed shape: four sub-tiles
    (256, 64, 16384, 0, False),      # no iteration: sum(x) of the input
])
def test_chain_kernels_match_plain(cuda, m, k, n, iters, ones, pair):
    chip_smoke._check_chain(torch, "test", m, k, n, iters, pair, ones)


@pytest.mark.parametrize("m,k,n,pair", [(256, 64, 16384, False),
                                        (256, 128, 32768, False),
                                        (256, 64, 16384, True)],
                         ids=["qk", "packed", "pair-qk"])
def test_chain_blocks_hold_the_same_x(cuda, m, k, n, pair):
    """The local design: every block computes the chain's x itself (the
    pair's, both chains'), and the first and the last block end with the
    same bits."""
    chip_smoke._check_chain_blocks(torch, "test", m, k, n, pair=pair)


@pytest.mark.parametrize("m,k,n,chains", [
    (256, 64, 2048, 1), (256, 128, 2048, 1), (256, 256, 2048, 1),
    (256, 512, 2048, 1), (256, 64, 16384, 1), (256, 128, 32768, 1),
    (256, 64, 16384, 2), (32, 16, 48, 1), (64, 32, 2128, 2),
    (256, 128, 32768, 2)])
def test_chain_design_is_the_launchers(cuda, m, k, n, chains):
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        probe_kernels as pk)
    assert pk.device_chain_design(m, k, n, chains) == pk.chain_design(
        m, k, n, chains, chip_smoke._multiprocessors(torch))


def test_chain_kernel_modes_and_refusals(cuda):
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        probe_kernels as pk)
    x, w1, w2 = chip_smoke._chain_inputs(torch, 256, 64, 2048, 1, True)
    d = pk.device_chain_design(256, 64, 2048)
    assert d.slab % 16 == 0 and (d.blocks - 1) * d.slab < 2048 <= \
        d.blocks * d.slab
    # the local design (P2 and P3 at k = 64), the exchange design (P2 and
    # P3 at k = 256): with the products skipped x is 0 after one iteration,
    # and the synchronisation alone writes nothing
    xd, wd, wd2 = chip_smoke._chain_inputs(torch, 256, 256, 2048, 1, True)
    assert pk.device_chain_design(256, 64, 2048).design == "local"
    assert pk.device_chain_design(256, 256, 2048).design == "exchange"
    assert pk.device_chain_design(256, 64, 2048, 2).design == "local"
    assert pk.device_chain_design(256, 256, 2048, 2).design == "exchange"
    for mode in ("no_products", "barrier_only"):
        for total, check in (pk.chain_matmul(x, w1, 3, mode=mode),
                             pk.chain_matmul(xd, wd, 3, mode=mode),
                             pk.pair_matmul(x, w1, w2, 3, mode=mode),
                             pk.pair_matmul(xd, wd, wd2, 3, mode=mode)):
            torch.cuda.synchronize()
            assert float(total) == 0.0 and not check.any()
    with pytest.raises(ValueError):
        pk.chain_matmul(x[:, :24].contiguous(), w1[:24].contiguous(), 1)
    with pytest.raises(TypeError):
        pk.chain_matmul(x.float(), w1, 1)
    with pytest.raises(ValueError):
        pk.pair_matmul(x, w1, w2[:, :1024].contiguous(), 1)
    with pytest.raises(ValueError):
        pk.chain_matmul(x, w1.cpu(), 1)


def test_small_stage1_step_on_the_card_matches_the_cpu(cuda):
    """The codebook's first step (init, K6's statistics into the EMA update,
    restarts) with BatchNorm on batch statistics: loss, every gradient, the
    buffers after the step."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
        import nearest_code_stats
    before = nearest_code_stats.launches
    got = chip_smoke._small_stage1_step(torch, "cuda")
    assert nearest_code_stats.launches == before + 1
    want = chip_smoke._small_stage1_step(torch, "cpu")
    assert 0 < int((want["buffers"]["codebook.ema_count"] < 1).sum()) < 32
    lerr, gerr, berr = chip_smoke._compare_stage1_steps(torch, got, want)
    assert lerr <= chip_smoke.TRAIN_LOSS_RTOL
    assert gerr <= chip_smoke.TRAIN_GRAD_TOL
    assert berr <= chip_smoke.STAGE1_STATE_TOL


def test_stage1_step_makes_no_host_sync(cuda):
    from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage1
    config = chip_smoke._small_stage1_config()
    state = stage1.build_stage1(config, "cuda",
                                torch.Generator().manual_seed(0))
    batch = {"video": torch.from_numpy(
        stage1.synthetic_batch(config, 2)["video"]).to("cuda")}
    g = torch.Generator(device="cuda").manual_seed(1)
    stage1.train_step(state, batch, g)          # warm: constants, cuDNN
    torch.cuda.set_sync_debug_mode("error")
    try:
        values = stage1.train_step(state, batch, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(values["total"]))
    assert bool(state.vqvae.codebook.initialized)


def test_small_bf16_training_step_on_the_card_matches_the_cpu(cuda):
    """The stage-2 step with a bf16 denoiser (the bf16 entry points of K2
    and K5 on every attention call) against the same step on the CPU."""
    before = (fused_mha.launches, fused_mha_bwd.launches)
    got = chip_smoke._small_train_step(torch, "cuda", "bfloat16")
    assert (fused_mha.launches, fused_mha_bwd.launches) == (
        before[0] + 4, before[1] + 4)       # 2 layers x (self, cross)
    want = chip_smoke._small_train_step(torch, "cpu", "bfloat16")
    lerr, gerr = chip_smoke._compare_train_steps(got, want, True)
    assert lerr <= chip_smoke.BF16_TRAIN_TOL
    assert gerr <= chip_smoke.BF16_TRAIN_TOL


def test_small_bf16_stage1_step_on_the_card_matches_the_cpu(cuda):
    """The stage-1 step in bf16 conv compute (cuDNN) against the CPU's; the
    gradients against a share of what bf16 moves them from f32."""
    got = chip_smoke._small_stage1_step(torch, "cuda", "bfloat16")
    want = chip_smoke._small_stage1_step(torch, "cpu", "bfloat16")
    drift = chip_smoke._compare_stage1_steps(
        torch, want, chip_smoke._small_stage1_step(torch, "cpu"), True)[1]
    lerr, gerr, berr = chip_smoke._compare_stage1_steps(torch, got, want,
                                                        True)
    assert lerr <= chip_smoke.BF16_TRAIN_TOL
    assert gerr <= chip_smoke.BF16_STAGE1_GRAD_SHARE * drift
    assert berr <= chip_smoke.BF16_TRAIN_TOL


def test_reference_sampler_on_the_card_matches_the_cpu(cuda):
    """The log-onehot samplers (reference, with filter_ratio, fast, token
    budget) on the card against the CPU in argmax mode."""
    chip_smoke.phase_samplers(torch)
