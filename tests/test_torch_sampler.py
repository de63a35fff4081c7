"""PyTorch port's sampler step (plain version of kernel K1) vs the JAX
package's Pallas ``fused_sample_step`` in interpret mode (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu.ops.sampler_kernel import (
    fused_sample_step as jax_fused_sample_step, schedule_rows as jax_rows)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
    d3pm as td3pm)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
    import (fused_sample_step, fused_sample_step_kernel_arithmetic,
            fused_sample_step_reference, sample_tokens, schedule_rows)

T, L, B = 8, 12, 2
# the posterior tolerance of tests/test_sampler_kernel.py
TOL = 1e-4


def _inputs(seed, k, guidance):
    rng = np.random.default_rng(seed)
    nb = 2 * B if abs(guidance - 1.0) >= 1e-3 else B
    # (nb, L, K-1) as the port's denoiser emits it; both sides see the
    # (nb, K-1, L) layout
    logits = (2.0 * rng.standard_normal((nb, L, k - 1))).astype(np.float32)
    tokens = rng.integers(0, k, (B, L)).astype(np.int64)
    tokens[:, ::4] = k - 1
    return logits, tokens


@pytest.mark.parametrize("t", [0, 3, T - 1])
@pytest.mark.parametrize("guidance", [1.0, 2.0])
@pytest.mark.parametrize("k", [10, 17])   # 17: K = 1 (mod 8)
def test_plain_step_matches_pallas_kernel(k, guidance, t):
    logits, tokens = _inputs(10 * k + t, k, guidance)
    want_tok, want_post = jax_fused_sample_step(
        jnp.asarray(logits.transpose(0, 2, 1)),
        jnp.asarray(tokens, jnp.int32), jax_rows(jd3pm.make_schedule(T, k))[t],
        jnp.int32(0), guidance=guidance, num_classes=k, sample=False,
        return_posterior=True, interpret=True)
    # the port takes the transposed view with its strides
    got_tok, got_post = fused_sample_step(
        torch.from_numpy(logits).transpose(1, 2), torch.from_numpy(tokens),
        schedule_rows(td3pm.make_schedule(T, k))[t], 0, guidance=guidance,
        num_classes=k, sample=False, return_posterior=True)
    np.testing.assert_allclose(got_post.numpy(), np.asarray(want_post),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))


@pytest.mark.parametrize("t", [0, 5])
def test_plain_step_is_the_analytic_posterior(t):
    """Posterior-equivalence inside the port: the kernel's plain version
    against d3pm._analytic_posterior of the guided log-probs."""
    k, guidance = 17, 2.0
    logits, tokens = _inputs(t, k, guidance)
    sched = td3pm.make_schedule(T, k)
    lg = torch.from_numpy(logits).transpose(1, 2)
    tok, post = fused_sample_step_reference(
        lg, torch.from_numpy(tokens), schedule_rows(sched)[t], 0,
        guidance=guidance, num_classes=k, sample=False,
        return_posterior=True)
    want = td3pm._analytic_posterior(
        sched, td3pm._guided_log_x_recon(lg, guidance, B),
        torch.from_numpy(tokens), t)
    torch.testing.assert_close(post, want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(tok, want.argmax(dim=1))


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    logits, tokens = _inputs(3, 17, 2.0)
    row = schedule_rows(td3pm.make_schedule(T, 17))[2]
    args = (torch.from_numpy(logits).transpose(1, 2),
            torch.from_numpy(tokens), row, 11)
    before = fused_sample_step.launches
    got = fused_sample_step(*args, guidance=2.0, num_classes=17)
    want = fused_sample_step_reference(*args, guidance=2.0, num_classes=17)
    assert fused_sample_step.launches == before
    torch.testing.assert_close(got, want)        # same seed, same draw
    assert got.dtype == torch.int64 and got.min() >= 0 and got.max() < 17


def test_sample_tokens_matches_sample_fused_in_argmax_mode():
    """The port's two routes (the per-step kernel loop and the plain
    full-loop oracle) take the same argmax path on a fixed random
    denoiser."""
    k, nb_cond = 17, 3
    gen = torch.Generator().manual_seed(0)
    proj = torch.randn((8, k - 1), generator=gen)
    emb = torch.randn((k, 8), generator=gen)

    def denoise(x, cond, t):                   # (N, L) -> (N, K-1, L)
        h = emb[x] + cond.mean(dim=(1, 2))[:, None, None] + 0.1 * t[
            :, None, None]
        return (h @ proj).transpose(1, 2)

    sched = td3pm.make_schedule(T, k)
    cond = torch.randn((nb_cond, 1, 4), generator=gen)
    cf = torch.zeros((nb_cond, 1, 4))
    a = sample_tokens(torch.Generator().manual_seed(1), sched, denoise, cond,
                      cf, nb_cond, L, guidance_scale=2.0, sample=False)
    b = td3pm.sample_fused(torch.Generator().manual_seed(1), sched, denoise,
                           cond, cf, nb_cond, L, guidance_scale=2.0,
                           sample=False)
    torch.testing.assert_close(a, b)
    assert (a != k - 1).all()                  # no MASK left after t=0


@pytest.mark.parametrize("t", [0, T - 1])
@pytest.mark.parametrize("guidance", [1.0, 2.0])
@pytest.mark.parametrize("k", [10, 17])
def test_kernel_arithmetic_matches_pallas_kernel(k, guidance, t):
    """The CUDA kernel's arithmetic (every log-sum-exp a maximum, then a
    sum; the guided normaliser from pass 0's sums where no class reaches the
    clamp) against the Pallas kernel."""
    logits, tokens = _inputs(20 * k + t, k, guidance)
    want_tok, want_post = jax_fused_sample_step(
        jnp.asarray(logits.transpose(0, 2, 1)),
        jnp.asarray(tokens, jnp.int32), jax_rows(jd3pm.make_schedule(T, k))[t],
        jnp.int32(0), guidance=guidance, num_classes=k, sample=False,
        return_posterior=True, interpret=True)
    (got_tok, got_post), free = fused_sample_step_kernel_arithmetic(
        torch.from_numpy(logits).transpose(1, 2), torch.from_numpy(tokens),
        schedule_rows(td3pm.make_schedule(T, k))[t], 0, guidance=guidance,
        num_classes=k, sample=False, return_posterior=True)
    assert bool(free.all())          # logits of scale 2: no class clamped
    np.testing.assert_allclose(got_post.numpy(), np.asarray(want_post),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))


def test_kernel_arithmetic_takes_the_full_pass_where_a_class_is_clamped():
    """Positions where some class's log-probability reaches -70 in either
    branch take the full guided pass, and the posterior still agrees with
    the Pallas kernel; there the guided normaliser from pass 0's sums would
    be wrong."""
    k, guidance, t = 17, 2.0, 3
    logits, tokens = _inputs(5, k, guidance)
    logits[0, 1, 3] = -150.0         # cond branch, row 0, position 1
    logits[B + 1, 5, 0] = -150.0     # uncond branch, row 1, position 5
    want_tok, want_post = jax_fused_sample_step(
        jnp.asarray(logits.transpose(0, 2, 1)),
        jnp.asarray(tokens, jnp.int32), jax_rows(jd3pm.make_schedule(T, k))[t],
        jnp.int32(0), guidance=guidance, num_classes=k, sample=False,
        return_posterior=True, interpret=True)
    lg = torch.from_numpy(logits).transpose(1, 2)
    (got_tok, got_post), free = fused_sample_step_kernel_arithmetic(
        lg, torch.from_numpy(tokens), schedule_rows(td3pm.make_schedule(T, k))[t],
        0, guidance=guidance, num_classes=k, sample=False,
        return_posterior=True)
    clamped = torch.zeros((B, L), dtype=torch.bool)
    clamped[0, 1] = clamped[1, 5] = True
    assert torch.equal(free, ~clamped)
    np.testing.assert_allclose(got_post.numpy(), np.asarray(want_post),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    # the rule's normaliser against the true one: wrong where the uncond
    # branch is clamped (its clamped class dominates lcf + g (lc - lcf)),
    # right wherever no class is (the guard is conservative: a clamped cond
    # class stays negligible at g = 2)
    zc, zu = lg[:B].double(), lg[B:].double()
    lse = lambda z: torch.logsumexp(z, dim=1)  # noqa: E731
    lc = (zc - lse(zc)[:, None]).clamp_min(-70.0)
    lu = (zu - lse(zu)[:, None]).clamp_min(-70.0)
    true_n = lse(lu + guidance * (lc - lu))
    rule_n = lse(zu + guidance * (zc - zu)) - (
        lse(zu) + guidance * (lse(zc) - lse(zu)))
    assert float((rule_n - true_n)[1, 5].abs()) > 100 * TOL
    assert float((rule_n - true_n)[~clamped].abs().max()) < TOL
