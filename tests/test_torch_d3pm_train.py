"""PyTorch port's D3PM training half vs the JAX package (CPU).

The JAX draws (timesteps with their probabilities, and the (B, K, L)
uniforms of the noising Gumbel-max) are made with the same
``jax.random.split`` calls as ``train_loss`` and handed to the port; the two
frameworks' generators are never compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
    d3pm as td3pm)

T, K, L, B = 6, 11, 10, 8
# f32 log-space math in two frameworks (XLA and ATen reduce in other orders)
TOL = 1e-5
# the Lt and telemetry buffers
BUF_TOL = 1e-6


def _scheds():
    return jd3pm.make_schedule(T, K), td3pm.make_schedule(T, K)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_log_helpers_match():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(np.float32) * 30
    b = rng.standard_normal((3, 5)).astype(np.float32)
    a[0, 0] = -np.inf
    np.testing.assert_allclose(
        td3pm.log_add_exp(_t(a), _t(b)).numpy(),
        np.asarray(jd3pm.log_add_exp(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)
    x = rng.integers(0, K, (2, L))
    lo = td3pm.index_to_log_onehot(_t(x), K)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(
        jd3pm.index_to_log_onehot(jnp.asarray(x), K)))
    np.testing.assert_array_equal(td3pm.log_onehot_to_index(lo).numpy(), x)
    logits = rng.standard_normal((2, K - 1, L)).astype(np.float32) * 20
    got = td3pm.predict_start_from_logits(_t(logits), L)
    want = jd3pm.predict_start_from_logits(jnp.asarray(logits), L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    p2 = np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((2, K, L)).astype(np.float32)), axis=1))
    np.testing.assert_allclose(
        td3pm.multinomial_kl(got, _t(p2)).numpy(),
        np.asarray(jd3pm.multinomial_kl(want, jnp.asarray(p2))),
        rtol=TOL, atol=TOL)


def _tokens(rng, mask_every=3):
    x_start = rng.integers(0, K - 1, (B, L))
    x_t = rng.integers(0, K, (B, L))
    x_t[:, ::mask_every] = K - 1
    x_t[:, 1::4] = x_start[:, 1::4]                # x_t == x_start cases
    return x_start, x_t


@pytest.mark.parametrize("ts", [[0] * B, [T - 1] * B,
                                [0, 1, 2, 3, 4, 5, 2, 0]])
def test_q_posterior_and_true_q_posterior_match(ts):
    js, tsch = _scheds()
    rng = np.random.default_rng(sum(ts))
    x_start, x_t = _tokens(rng)
    t = np.asarray(ts, np.int32)
    log_x0 = np.asarray(jax.nn.log_softmax(jnp.asarray(
        3 * rng.standard_normal((B, K, L)).astype(np.float32)), axis=1))
    want = jd3pm.q_posterior(js, jnp.asarray(log_x0), jd3pm.index_to_log_onehot(
        jnp.asarray(x_t), K), jnp.asarray(t))
    got = td3pm.q_posterior(tsch, _t(log_x0), td3pm.index_to_log_onehot(
        _t(x_t), K), _t(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    want = jd3pm.true_q_posterior(js, jnp.asarray(x_start), jnp.asarray(x_t),
                                  jnp.asarray(t))
    got = td3pm.true_q_posterior(tsch, _t(x_start), _t(x_t), _t(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_q_pred_and_q_sample_from_indices_match():
    js, tsch = _scheds()
    rng = np.random.default_rng(1)
    t = np.array([0, 5, 3, -1, 2, 1, 4, 5], np.int32)
    log_x = np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((B, K, L)).astype(np.float32)), axis=1))
    np.testing.assert_allclose(
        td3pm.q_pred(tsch, _t(log_x), _t(t).long()).numpy(),
        np.asarray(jd3pm.q_pred(js, jnp.asarray(log_x), jnp.asarray(t))),
        rtol=TOL, atol=TOL)
    x_start = rng.integers(0, K - 1, (B, L))
    t = np.clip(t, 0, T - 1)
    key = jax.random.key(3)
    u = jax.random.uniform(key, (B, K, L), jnp.float32)
    want = jd3pm.q_sample_from_indices(key, js, jnp.asarray(x_start),
                                       jnp.asarray(t))
    got = td3pm.q_sample_from_indices(_t(u), tsch, _t(x_start), _t(t).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_importance_probs_and_sample_time():
    rng = np.random.default_rng(2)
    hist = rng.random(T).astype(np.float32)
    lt = jd3pm.LtState(history=jnp.asarray(hist),
                       count=jnp.full((T,), 11.0, jnp.float32))
    t_j, pt_j = jd3pm.sample_time(jax.random.key(0), lt, 64, T)
    probs = td3pm.importance_probs(_t(hist))
    np.testing.assert_allclose(probs[_t(t_j).long()].numpy(),
                               np.asarray(pt_j), rtol=1e-6, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    warm = td3pm.LtState(history=_t(hist), count=torch.full((T,), 10.0))
    t, pt = td3pm.sample_time(g, warm, 64, T)            # uniform warm-up
    assert t.dtype == torch.int64 and 0 <= t.min() and t.max() < T
    torch.testing.assert_close(pt, torch.full((64,), 1.0 / T))
    ready = td3pm.LtState(history=_t(hist), count=torch.full((T,), 11.0))
    t, pt = td3pm.sample_time(g, ready, 64, T)           # importance
    torch.testing.assert_close(pt, probs[t])


def _denoisers(rng):
    """The same toy denoiser in both frameworks: a per-token logit table
    plus a per-timestep bias, (B, L) tokens -> (B, K-1, L) logits."""
    table = (rng.standard_normal((K, K - 1)) * 2).astype(np.float32)
    tbias = rng.standard_normal((T, K - 1)).astype(np.float32)

    def jax_fn(tab):
        return lambda x, c, t: jnp.transpose(
            tab[x] + jnp.asarray(tbias)[t][:, None, :], (0, 2, 1))

    def torch_fn(tab):
        return lambda x, c, t: (tab[x] + _t(tbias)[t][:, None, :]
                                ).transpose(1, 2)
    return table, jax_fn, torch_fn


@pytest.mark.parametrize("importance", [False, True])
def test_train_loss_matches_with_injected_draws(importance):
    js, tsch = _scheds()
    rng = np.random.default_rng(4)
    table, jax_fn, torch_fn = _denoisers(rng)
    x_start = rng.integers(0, K - 1, (B, L))
    hist = (rng.random(T) * 5).astype(np.float32)
    count = np.full((T,), 11.0 if importance else 3.0, np.float32)
    lt = jd3pm.LtState(history=jnp.asarray(hist), count=jnp.asarray(count))
    kw = dict(auxiliary_loss_weight=5e-4, adaptive_auxiliary_loss=True,
              mask_weight=(1.0, 0.5))
    key = jax.random.key(7)
    t_rng, q_rng = jax.random.split(key)            # as train_loss splits
    t, pt = jd3pm.sample_time(t_rng, lt, B, T)
    noise = jax.random.uniform(q_rng, (B, K, L), jnp.float32)
    assert len(set(np.asarray(t).tolist())) < B     # duplicate timesteps

    def jloss(tab):
        vb, aux, new_lt = jd3pm.train_loss(key, js, jax_fn(tab),
                                           jnp.asarray(x_start), None, lt,
                                           **kw)
        return jnp.sum(vb), (vb, aux, new_lt)
    (_, (vb_j, aux_j, lt_j)), g_j = jax.value_and_grad(
        jloss, has_aux=True)(jnp.asarray(table))

    tab = _t(table).requires_grad_()
    vb, aux, new_lt = td3pm.train_loss(
        None, tsch, torch_fn(tab), _t(x_start),
        None, td3pm.LtState(history=_t(hist), count=_t(count)), **kw,
        t=_t(t), pt=_t(pt), noise=_t(noise))
    vb.sum().backward()
    np.testing.assert_allclose(vb.detach().numpy(), np.asarray(vb_j),
                               rtol=TOL, atol=0)
    for name in ("t", "xt", "x0_recon", "xt_1_recon"):
        np.testing.assert_array_equal(aux[name].numpy(),
                                      np.asarray(aux_j[name]), err_msg=name)
    np.testing.assert_allclose(aux["log_model_prob"].detach().numpy(),
                               np.asarray(aux_j["log_model_prob"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(new_lt.history.numpy(),
                               np.asarray(lt_j.history), rtol=BUF_TOL,
                               atol=BUF_TOL)
    np.testing.assert_array_equal(new_lt.count.numpy(),
                                  np.asarray(lt_j.count))
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(tab.grad.numpy(), g_j, rtol=0,
                               atol=5e-4 * np.abs(g_j).max())


def test_diffusion_telemetry_matches_with_duplicate_t():
    rng = np.random.default_rng(5)
    t = np.array([2, 2, 0, 5, 2, 0, 1, 2], np.int32)
    x0, xs, xt, xt1 = (rng.integers(0, 3, (B, L)) for _ in range(4))
    acc, keep = (rng.random(T).astype(np.float32) for _ in range(2))
    want = jd3pm.update_diffusion_telemetry(
        jnp.asarray(acc), jnp.asarray(keep), jnp.asarray(t),
        *(jnp.asarray(a) for a in (x0, xs, xt, xt1)))
    got = td3pm.update_diffusion_telemetry(
        _t(acc), _t(keep), _t(t).long(), *(_t(a) for a in (x0, xs, xt, xt1)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BUF_TOL,
                                   atol=BUF_TOL)
