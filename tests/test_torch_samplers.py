"""The PyTorch port's log-onehot D3PM samplers vs the JAX package (CPU).

Each piece (``q_pred_one_timestep``, ``q_sample``, ``cf_predict_start``,
``p_pred``, the token budgets, the all-MASK start) is held against its JAX
function on the same numpy-seeded inputs, on log-probabilities. The whole
samplers (``sample`` with and without ``filter_ratio``, ``sample_fast``,
``sample_with_token_budget``) run on both sides with the same draws: the
port's :class:`Draws` replays the JAX package's key splits (the uniforms of
each Gumbel-max and the token-budget sampler's host seeds), so the tokens
must agree wherever the two posteriors' top-two margin clears their f32
disagreement (1e-5: every token here). ``D3PM.sample(mode="reference")`` and
``D3PM.sample_fast`` run over the port's denoiser with the flax weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
    build_models)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
    d3pm as td3pm)
from tests.test_torch_slice import CONFIG, _denoiser, _flax_weights

T, K, L, B = 8, 10, 12, 2
# f32 log-space math in two frameworks (tests/test_torch_d3pm.py)
TOL = 1e-5
S = 3   # condition tokens


class JaxDraws(td3pm.Draws):
    """The JAX samplers' draws from ``key``: each Gumbel-max splits the
    carried key and draws its uniforms from the new half; the token-budget
    sampler's host seed comes from that same half."""

    def __init__(self, key):
        super().__init__(None)
        self.key, self.last = key, None

    def uniform(self, shape, device):
        self.key, self.last = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(
            self.last, shape, jnp.float32))).to(device)

    def seed(self):
        return int(jax.random.randint(self.last, (), 0, 2 ** 31 - 1))


def _denoise_pair(scale=1.0):
    """One denoiser written in both frameworks: logits from the tokens, the
    step and the condition's mean (so that CFG's two branches differ)."""
    base = np.linspace(-1.5, 1.5, K - 1, dtype=np.float32)[None, :, None]

    def jax_fn(x, cond, t):
        c = 0.0 if cond is None else jnp.mean(cond, axis=(1, 2))
        h = jnp.cos(1.3 * x.astype(jnp.float32) + t[:, None].astype(
            jnp.float32))
        return scale * (base + 0.4 * h[:, None, :]
                        + 0.5 * jnp.reshape(c, (-1, 1, 1)) * base)

    def torch_fn(x, cond, t):
        c = 0.0 if cond is None else cond.mean(dim=(1, 2))
        h = torch.cos(1.3 * x.float() + t[:, None].float())
        return scale * (torch.from_numpy(base) + 0.4 * h[:, None, :]
                        + 0.5 * torch.as_tensor(c).reshape(-1, 1, 1)
                        * torch.from_numpy(base))

    return jax_fn, torch_fn


def _conds(rng):
    cond = rng.standard_normal((B, S, 4)).astype(np.float32)
    cf = np.zeros((1, S, 4), np.float32)
    return cond, cf


def _scheds():
    return jd3pm.make_schedule(T, K), td3pm.make_schedule(T, K)


def _log_onehot(rng):
    tokens = rng.integers(0, K, (B, L))
    tokens[:, ::3] = K - 1
    return tokens, td3pm.index_to_log_onehot(torch.from_numpy(tokens), K)


@pytest.mark.parametrize("t", [0, 3, T - 1])
def test_q_pred_one_timestep_matches(t):
    rng = np.random.default_rng(t)
    js, ts = _scheds()
    log_x = np.log(rng.dirichlet(np.ones(K), (B, L)).transpose(0, 2, 1)
                   ).astype(np.float32)
    tt = np.full((B,), t, np.int32)
    want = jd3pm.q_pred_one_timestep(js, jnp.asarray(log_x), jnp.asarray(tt))
    got = td3pm.q_pred_one_timestep(ts, torch.from_numpy(log_x),
                                    torch.from_numpy(tt).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_q_sample_and_mask_start_match():
    rng = np.random.default_rng(1)
    js, ts = _scheds()
    tokens, log_x = _log_onehot(rng)
    t = np.array([2, 6], np.int32)
    key = jax.random.key(4)
    want = jd3pm.q_sample(key, js, jnp.asarray(log_x.numpy()), jnp.asarray(t))
    noise = torch.from_numpy(np.array(jax.random.uniform(
        key, (B, K, L), jnp.float32)))
    got = td3pm.q_sample(noise, ts, log_x, torch.from_numpy(t).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        td3pm._mask_start_state(B, K, L, torch.device("cpu")).numpy(),
        np.asarray(jd3pm._mask_start_state(B, K, L)))
    lt = td3pm.LtState.zeros(T)
    want_lt = jd3pm.LtState.zeros(T)
    assert lt.history.dtype == torch.float32
    np.testing.assert_array_equal(lt.history.numpy(), want_lt.history)
    np.testing.assert_array_equal(lt.count.numpy(), want_lt.count)


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_cf_predict_start_and_p_pred_match(guidance):
    rng = np.random.default_rng(2)
    js, ts = _scheds()
    jfn, tfn = _denoise_pair()
    tokens, log_x = _log_onehot(rng)
    cond, cf = _conds(rng)
    t = np.array([0, 5], np.int32)
    want_post, want_recon = jd3pm.p_pred(
        js, jfn, jnp.asarray(log_x.numpy()), jnp.asarray(cond),
        jnp.asarray(cf), jnp.asarray(t), guidance)
    got_post, got_recon = td3pm.p_pred(
        ts, tfn, log_x, torch.from_numpy(cond), torch.from_numpy(cf),
        torch.from_numpy(t).long(), guidance)
    np.testing.assert_allclose(got_recon.numpy(), np.asarray(want_recon),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_post.numpy(), np.asarray(want_post),
                               rtol=TOL, atol=TOL)
    direct = td3pm.cf_predict_start(ts, tfn, log_x, torch.from_numpy(cond),
                                    torch.from_numpy(cf),
                                    torch.from_numpy(t).long(), guidance)
    torch.testing.assert_close(direct, got_recon, rtol=0, atol=0)


@pytest.mark.parametrize("t", [0, 4, T - 1])
def test_p_pred_is_posterior_equivalent_to_sample_fused(t):
    """One step of the log-onehot route takes the posterior that
    ``sample_fused`` takes analytically from the same logits."""
    rng = np.random.default_rng(3 + t)
    _, ts = _scheds()
    _, tfn = _denoise_pair()
    tokens, log_x = _log_onehot(rng)
    cond, cf = (torch.from_numpy(a) for a in _conds(rng))
    tt = torch.full((B,), t, dtype=torch.long)
    post, _ = td3pm.p_pred(ts, tfn, log_x, cond, cf, tt, 2.0)
    logits2 = tfn(torch.cat([torch.from_numpy(tokens)] * 2), td3pm._cfg_batch(
        cond, cf, True), torch.cat([tt, tt]))
    want = td3pm._analytic_posterior(
        ts, td3pm._guided_log_x_recon(logits2, 2.0, B),
        torch.from_numpy(tokens), t)
    torch.testing.assert_close(post, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("steps", [10, 25, 50, 100, 200, 7])
@pytest.mark.parametrize("prior_ps", [5, 1024])
def test_token_budget_table_matches(steps, prior_ps):
    assert td3pm.default_n_sample(steps, prior_ps) == jd3pm.default_n_sample(
        steps, prior_ps)
    table = jd3pm.default_n_sample(steps, prior_ps)
    # the rescaling of sample_with_token_budget, for the grids of the
    # shipped configurations and a small one
    for seq_len in (16, 512, 1024, 2304):
        assert td3pm.token_budget(steps, seq_len, prior_ps) == [
            max(1, round(n * seq_len / float(sum(table)))) for n in table]


def _run_both(name, jfn, tfn, cond, cf, key, **kw):
    js, ts = _scheds()
    jc = None if cond is None else jnp.asarray(cond)
    jcf = None if cf is None else jnp.asarray(cf)
    tc = None if cond is None else torch.from_numpy(cond)
    tcf = None if cf is None else torch.from_numpy(cf)
    want = getattr(jd3pm, name)(key, js, jfn, jc, jcf, B, L, **{
        k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
        for k, v in kw.items()})
    got = getattr(td3pm, name)(None, ts, tfn, tc, tcf, B, L,
                               draws=JaxDraws(key), **kw)
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("filter_ratio", [0.0, 0.5])
@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_sample_matches_jax_with_its_draws(filter_ratio, guidance):
    rng = np.random.default_rng(5)
    jfn, tfn = _denoise_pair()
    cond, cf = _conds(rng)
    kw = dict(guidance_scale=guidance, filter_ratio=filter_ratio)
    if filter_ratio:
        kw["content_token"] = torch.from_numpy(
            rng.integers(0, K - 1, (B, L)))
    got, want = _run_both("sample", jfn, tfn, cond, cf, jax.random.key(6),
                          **kw)
    assert got.shape == (B, L) and (got != K - 1).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("skip_step", [1, 2, 6])
def test_sample_fast_matches_jax_with_its_draws(skip_step):
    rng = np.random.default_rng(7)
    jfn, tfn = _denoise_pair()
    cond, cf = _conds(rng)
    got, want = _run_both("sample_fast", jfn, tfn, cond, cf,
                          jax.random.key(8), guidance_scale=2.0,
                          skip_step=skip_step)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prior_rule,prior_weight", [(1, 0.0), (2, 0.0),
                                                     (2, 0.5), (0, 0.0)])
def test_token_budget_sampler_matches_jax_with_its_draws(prior_rule,
                                                         prior_weight):
    rng = np.random.default_rng(9)
    jfn, tfn = _denoise_pair(scale=3.0)
    cond, cf = _conds(rng)
    got, want = _run_both("sample_with_token_budget", jfn, tfn, cond, cf,
                          jax.random.key(10), guidance_scale=2.0,
                          prior_rule=prior_rule, prior_weight=prior_weight,
                          prior_ps=L)
    assert (got != K - 1).all()
    np.testing.assert_array_equal(got, want)


def test_samplers_in_argmax_mode_unmask_every_token_without_draws():
    """``sample=False`` takes the argmax of each posterior: no uniform and
    no seed is drawn, and the same call gives the same tokens."""

    class NoDraws(td3pm.Draws):
        def uniform(self, shape, device):
            raise AssertionError("argmax mode drew uniforms")

    _, ts = _scheds()
    _, tfn = _denoise_pair()
    cond = torch.from_numpy(_conds(np.random.default_rng(11))[0])
    for name, kw in (("sample", {}), ("sample_fast", {"skip_step": 2}),
                     ("sample_with_token_budget", {"prior_rule": 0})):
        runs = [getattr(td3pm, name)(None, ts, tfn, cond, torch.zeros_like(
            cond), B, L, sample=False, draws=NoDraws(None), **kw)
            for _ in range(2)]
        torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
        assert (runs[0] != K - 1).all(), name


def _port_generator(gparams):
    models = build_models(CONFIG, "cpu", torch.Generator().manual_seed(0))
    diffusion = {"diffusion": {name: np.zeros(8, np.float32) for name in (
        "lt_history", "lt_count", "diffusion_acc", "diffusion_keep")}}
    models.generator.load_state_dict(flax_to_state_dict(gparams,
                                                        buffers=diffusion))
    return models.generator


@pytest.mark.parametrize("route", ["reference", "filter", "fast"])
def test_d3pm_log_onehot_routes_match_jax_over_the_denoiser(route):
    """``D3PM.sample(mode="reference")`` (also from ``filter_ratio`` 0.5 of
    the way in, the 'auto' route then) and ``D3PM.sample_fast`` over the
    port's denoiser with the flax weights, against the JAX functions over
    the flax denoiser, with the same draws."""
    rng = np.random.default_rng(12)
    labels = np.array([0, 3], np.int32)
    gen, gparams, _, _ = _flax_weights(rng, jnp.asarray(labels))
    generator = _port_generator(gparams)
    d3pm = generator.diffusion
    batch = {"label": torch.from_numpy(labels)}
    cond, cf = generator.conditioner_embeddings(batch, 2)
    den = _denoiser()
    tparams = gparams["diffusion"]["transformer"]
    jfn = jax.jit(lambda x, c, t: den.apply({"params": tparams}, x, c, t,
                                            fused_attention=False))
    js = jd3pm.make_schedule(8, 17)
    key = jax.random.key(13)
    jc, jcf = jnp.asarray(cond.detach().numpy()), jnp.asarray(
        cf.detach().numpy())
    content = rng.integers(0, 16, (2, 32))
    if route == "fast":
        want = jd3pm.sample_fast(key, js, jfn, jc, jcf, 2, 32,
                                 guidance_scale=2.0, skip_step=2)
        got = d3pm.sample_fast(cond, cf, 2, 2, generator=None,
                               draws=JaxDraws(key))
    else:
        ratio = 0.5 if route == "filter" else 0.0
        want = jd3pm.sample(key, js, jfn, jc, jcf, 2, 32, guidance_scale=2.0,
                            filter_ratio=ratio,
                            content_token=jnp.asarray(content, jnp.int32))
        got = d3pm.sample(cond, cf, 2, generator=None,
                          mode="auto" if ratio else "reference",
                          filter_ratio=ratio,
                          content_token=torch.from_numpy(content),
                          draws=JaxDraws(key))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got != 16).all()
    out = generator.sample_fast(batch, 2, 3,
                                generator=torch.Generator().manual_seed(1))
    assert tuple(out.shape) == (2, 32) and bool((out < 16).all())


def test_sample_fast_takes_the_cf_condition_as_given_under_learnable_cf():
    """The JAX package's ``D3PM.sample_fast`` passes its CF condition on as
    given, where ``D3PM.sample`` puts the learnable empty-text embedding in
    its place: the port keeps both."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.\
        discrete_diffusion import D3PM

    model = D3PM(num_embed=K - 1, content_seq_len=L, spatial_size=(3, 4),
                 diffusion_step=T, learnable_cf=True, n_layer=1,
                 condition_seq_len=S, condition_dim=8)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.3,
                              generator=torch.Generator().manual_seed(0))
    cond = torch.randn((B, S, 8), generator=torch.Generator().manual_seed(1))
    cf = torch.zeros_like(cond)
    seen = []
    model.transformer.register_forward_pre_hook(
        lambda module, args: seen.append(args[1][B:].clone()))
    model.sample_fast(cond, cf, B, 3, generator=None, sample=False)
    assert all(torch.equal(c, cf) for c in seen)
    seen.clear()
    model.sample(cond, cf, B, generator=None, mode="reference",
                 sample=False)
    empty = model.empty_cond_embed(B, S)
    assert seen and all(torch.equal(c, empty) for c in seen)
