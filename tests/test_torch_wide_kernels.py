"""K1 past 8192 classes and K6 past code dim 384 against the JAX package
(CPU), and the bounds of the new shapes.

The JAX kernels take any class count (K1) and any code dim (K6); the
port's kernels now do too: K1 above 8192 classes keeps its two class rows
in shared memory, or re-reads them from device memory where they do not
fit, and K6 above code dim 384 streams x beside the codebook. The kernels
run on the card only (``tests/test_torch_gpu_kernels.py``,
``chip_smoke.py`` phase 22); here their plain versions and their
arithmetic are held to the Pallas kernels in interpret mode (K6 also to its
jnp reference), the margin that decides K6's rows on the card to the
kernel's own sums, and roofline's counts to WIDE_DOMAIN's figures.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu.ops.codebook_kernel import (
    _nearest_code_stats_pallas, nearest_code_stats as jax_nearest_code_stats)
from gif_synthesis_with_discrete_diffusion_tpu.ops.sampler_kernel import (
    fused_sample_step as jax_fused_sample_step, schedule_rows as jax_rows)
from gif_synthesis_with_discrete_diffusion_tpu_torch import roofline
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
    d3pm as td3pm)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.codebook_kernel \
    import (code_stats_reference, nearest_code_dist_reference,
            nearest_code_stats_kernel_arithmetic,
            nearest_code_stats_reference)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
    import (REGISTER_CLASSES, fused_sample_step,
            fused_sample_step_kernel_arithmetic, fused_sample_step_reference,
            schedule_rows)
from tests.test_torch_codebook import _decided

# the posterior tolerance of tests/test_sampler_kernel.py
K1_TOL = 1e-4
# K6's statistics: f32 sums in two orders (tests/test_torch_codebook.py)
K6_TOL = 1e-4


# ---------------------------------------------------------------------------
# K1 past the register design's 8192 classes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("guidance", [1.0, 2.0])
@pytest.mark.parametrize("kv", [8193, 10240, 16384])
def test_sampler_step_matches_pallas_past_8192_classes(kv, guidance):
    """The port's plain step and the kernel's arithmetic against the Pallas
    kernel at K-1 = ``kv`` (B=2, L=16): the posterior within K1_TOL, the
    argmax tokens equal."""
    assert kv > REGISTER_CLASSES or kv == 8193
    T, B, L, t, k = 8, 2, 16, 3, kv + 1
    rng = np.random.default_rng(kv + int(guidance))
    nb = 2 * B if guidance != 1.0 else B
    logits = (2.0 * rng.standard_normal((nb, L, kv))).astype(np.float32)
    tokens = rng.integers(0, k, (B, L)).astype(np.int64)
    tokens[:, ::4] = kv
    want_tok, want_post = jax_fused_sample_step(
        jnp.asarray(logits.transpose(0, 2, 1)), jnp.asarray(tokens, jnp.int32),
        jax_rows(jd3pm.make_schedule(T, k))[t], jnp.int32(0),
        guidance=guidance, num_classes=k, sample=False,
        return_posterior=True, interpret=True)
    args = (torch.from_numpy(logits).transpose(1, 2),
            torch.from_numpy(tokens), schedule_rows(
                td3pm.make_schedule(T, k))[t], 0)
    kw = dict(guidance=guidance, num_classes=k, sample=False,
              return_posterior=True)
    before = fused_sample_step.launches
    got = fused_sample_step(*args, **kw)
    assert fused_sample_step.launches == before     # CPU: the plain version
    plain = fused_sample_step_reference(*args, **kw)
    arith, free = fused_sample_step_kernel_arithmetic(*args, **kw)
    assert bool(free.all())         # logits of scale 2: no class clamped
    for name, (tok, post) in (("wrapper", got), ("plain", plain),
                              ("arithmetic", arith)):
        assert tuple(post.shape) == (B, k, L)
        np.testing.assert_allclose(post.numpy(), np.asarray(want_post),
                                   rtol=K1_TOL, atol=K1_TOL, err_msg=name)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# K6 past code dim 384
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [512, 4096])
@pytest.mark.parametrize("d", [385, 512, 768])
def test_codebook_lookup_matches_pallas_past_dim_384(d, k):
    """The Pallas kernel in interpret mode and the jnp reference against
    the port's plain lookup (indices equal, statistics within K6_TOL) and
    the kernel's split-TF32 arithmetic (indices equal at decided rows, the
    statistics of its own indices)."""
    rng = np.random.default_rng(d + k)
    n = 256
    x = rng.standard_normal((n, d)).astype(np.float32)
    emb = rng.standard_normal((k, d)).astype(np.float32)
    pallas = _nearest_code_stats_pallas(jnp.asarray(x), jnp.asarray(emb),
                                        interpret=True)
    plain_jax = jax_nearest_code_stats(jnp.asarray(x), jnp.asarray(emb),
                                       use_pallas=False)
    xt, et = torch.from_numpy(x), torch.from_numpy(emb)
    idx, n_total, encode_sum = nearest_code_stats_reference(xt, et)
    for want in (pallas, plain_jax):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(n_total.numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(encode_sum.numpy(), np.asarray(want[2]),
                                   rtol=K6_TOL, atol=K6_TOL)
    a_idx, a_n, a_sum = nearest_code_stats_kernel_arithmetic(xt, et)
    decided = _decided(xt, et).numpy()
    assert decided.sum() > 0.9 * n
    np.testing.assert_array_equal(a_idx.numpy()[decided],
                                  np.asarray(pallas[0])[decided])
    want_n, want_sum = code_stats_reference(xt, a_idx, k)
    np.testing.assert_array_equal(a_n.numpy(), want_n.numpy())
    np.testing.assert_allclose(a_sum.numpy(), want_sum.numpy(), rtol=K6_TOL,
                               atol=K6_TOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_lookup_equals_unsharded_at_dim_512(shards):
    """A codebook cut by codes into ``shards`` (the tensor-parallel
    lookup): each shard's nearest code and distance, the nearest over the
    shards with ties to the lower shard, is the unsharded index exactly."""
    rng = np.random.default_rng(shards)
    n, k, d = 512, 4096, 512
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    want = nearest_code_stats_reference(x, emb)[0]
    per = k // shards
    idx = [nearest_code_dist_reference(x, emb[s * per:(s + 1) * per])
           for s in range(shards)]
    every_idx = torch.stack([i.long() + s * per
                             for s, (i, _) in enumerate(idx)])
    every_dist = torch.stack([dist for _, dist in idx])
    shard = torch.argmin(every_dist, dim=0)
    got = every_idx.gather(0, shard[None])[0]
    torch.testing.assert_close(got.to(torch.int32), want, rtol=0, atol=0)


@pytest.mark.parametrize("d", [128, 1024])
def test_k6_margin_covers_the_kernels_sequential_f32_sums(d):
    """chip_smoke.py's ``k6_margin(D)``, the margin that decides a row on
    the card above D = 128: the kernel's distances (||e||^2 summed one dim
    at a time in f32, x.e summed in 8-deep split-TF32 steps into an f32
    accumulator) err from f64 by less than a quarter of it, as K6_MARGIN
    bounds them at D = 128 (tests/test_torch_codebook.py)."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.megakernel \
        import split_tf32
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((512, d)).astype(np.float32))
    ss = torch.zeros(512)
    for j in range(d):                       # fmaf, one dim at a time
        ss = (ss.double() + emb[:, j].double() ** 2).float()
    xh, xl = split_tf32(x)
    eh, el = split_tf32(emb)
    acc = torch.zeros((64, 512))
    for j in range(0, d, 8):                 # one mma step: 8 dims
        sl = slice(j, j + 8)
        for a, b in ((xh, el), (xl, eh), (xh, eh)):
            acc = (acc.double() + a[:, sl].double() @ b[:, sl].double().t()
                   ).float()
    got = (ss[None, :].double() - 2.0 * acc.double())
    xd, ed = x.double(), emb.double()
    want = -2.0 * (xd @ ed.t()) + (ed * ed).sum(dim=-1)[None, :]
    assert float((got - want).abs().max()) < chip_smoke.k6_margin(d) / 4


# ---------------------------------------------------------------------------
# the bounds
# ---------------------------------------------------------------------------
def test_bounds_count_the_functions_work_at_wide_domain():
    """roofline's counts at WIDE_DOMAIN's shapes: K2 self-attention at
    B=16 under CFG-free training rows (16 rows of 1024 tokens, 2 heads of
    256) does 34.4 GFLOP, its bf16 bound at 989 TFLOP/s and its f32 bound
    as three TF32 products; K6 at N = K = 16384, D = 512 does 825 GFLOP as
    the kernel counts it (three TF32 products); K1 at 2B = 16, K-1 = 16384,
    L = 1024 reads 1.07 GB of logits. The scores the stream design
    computes again past d = 256 are not in them (stream_products counts
    them: none at d = 256, a third of K2's products at d = 512)."""
    nbytes, flops, _ = roofline.attention_work(16, 1024, 1024, 2, 256)
    assert flops == pytest.approx(34.36e9, rel=1e-3)
    ms, by = chip_smoke._attention_bound(torch.bfloat16, flops, nbytes)
    assert (ms, by) == (pytest.approx(flops / roofline.PEAK_BF16 * 1e3),
                        "operations")
    ms32, _ = chip_smoke._attention_bound(torch.float32, flops, nbytes)
    assert ms32 == pytest.approx(3 * flops / roofline.PEAK_TF32 * 1e3)
    assert 0.20 < ms32 < 0.22 and 0.034 < ms < 0.036
    w = chip_smoke.stream_products(256)
    assert (w["fwd_function"], w["bwd_function"]) == (4 * 256, 10 * 256)
    assert (w["chunks"], w["fwd_recompute"], w["bwd_recompute"]) == (1, 0, 0)
    # K2 runs the function's products; K5's two kernels each compute S and
    # dP (no float atomics), at every width
    assert (w["fwd"], w["bwd"]) == (4 * 256, 14 * 256)
    w = chip_smoke.stream_products(512)
    assert (w["out"], w["chunks"]) == (256, 2)
    assert w["fwd_recompute"] == pytest.approx(1 / 3)
    assert w["bwd_recompute"] == pytest.approx(4096 / (2 * 8 * 512 + 6 * 512))

    nbytes, flops = roofline.codebook_work(16384, 16384, 512)
    ms, by = roofline.bound(nbytes, 0.0, flops_tf32=3.0 * flops)
    assert 3.0 * flops == pytest.approx(824.6e9, rel=1e-3)
    assert by == "operations" and ms == pytest.approx(1.666, rel=1e-3)

    nbytes, flops = roofline.sample_step_work(8, 16, 16384, 1024)
    assert nbytes == pytest.approx(1.074e9, rel=1e-3)
    ms, by = roofline.bound(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(0.3205, rel=1e-3)
