"""The PyTorch port's BatchNorm in training mode and the codebook's training
path vs the JAX package (CPU).

flax ``nn.BatchNorm(use_running_average=False, momentum=0.9)`` and the JAX
``Codebook`` (``kernel_mode="xla"``: the plain lookup) run on the same numpy
inputs as the port's modules. The candidate rows of the codebook's init and
restarts are drawn by the JAX module (``_tile_rows`` under the same rngs, read
out through ``apply(..., method=...)``) and handed to the port as
``init_rows`` / ``restart_rows``: ``jax.random.permutation`` and a
``torch.Generator`` never agree.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models.vqvae import (
    Codebook as JaxCodebook)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models.vqvae import (
    BatchNorm, Codebook)

# f32 in two frameworks: elementwise ops and sums of a few hundred terms
TOL = 1e-5
# the codebook's new state: sums over the rows of a code in other orders
STATE_TOL = 1e-5


@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 8), (4, 2, 2, 2, 5)])
def test_batchnorm_training_matches_flax(shape):
    rng = np.random.default_rng(shape[-1])
    c = shape[-1]
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    scale, bias, mean = (rng.standard_normal(c).astype(np.float32)
                         for _ in range(3))
    var = (np.abs(rng.standard_normal(c)) + 0.5).astype(np.float32)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}

    def loss(params, x):
        y, mutated = flax_bn.apply({"params": params,
                                    "batch_stats": variables["batch_stats"]},
                                   x, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mutated)

    (_, (want, mutated)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))

    bn = BatchNorm(c)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    tx = torch.from_numpy(x).requires_grad_()
    got = bn(tx, train=True)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=TOL, atol=TOL)
    # the running variance moved towards the BIASED batch variance
    biased = x.reshape(-1, c).var(axis=0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 * var + 0.1 * biased, rtol=1e-5, atol=1e-5)
    for got_g, want_g in ((tx.grad, gx), (bn.weight.grad, gp["scale"]),
                          (bn.bias.grad, gp["bias"])):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   rtol=1e-4, atol=1e-4)
    # eval mode reads the running statistics and moves nothing
    before = bn.running_mean.clone()
    with torch.no_grad():
        y = bn(tx)
    assert torch.equal(bn.running_mean, before)
    want_eval = flax_bn.clone(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": {
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}},
        jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_eval), rtol=TOL,
                               atol=TOL)


def _port_codebook(k, d, state):
    cb = Codebook(k, d)
    cb.load_state_dict({n: torch.from_numpy(np.array(v))
                        for n, v in state.items()})
    return cb


def _compare(vq, want, cb, new_state):
    np.testing.assert_array_equal(vq["encodings"].numpy(),
                                  np.asarray(want["encodings"]))
    for name in ("embeddings", "commitment_loss", "perplexity", "entropy",
                 "codebook_loss"):
        np.testing.assert_allclose(vq[name].detach().numpy(),
                                   np.asarray(want[name]), rtol=TOL, atol=TOL,
                                   err_msg=name)
    for name in ("embeddings", "ema_count", "ema_sum"):
        np.testing.assert_allclose(getattr(cb, name).numpy(),
                                   np.asarray(new_state[name]),
                                   rtol=STATE_TOL, atol=STATE_TOL,
                                   err_msg=name)
    assert bool(cb.initialized) == bool(new_state["initialized"])


def test_initialised_codebook_ema_update_matches_jax():
    """Counts high enough that nothing restarts: the update is the EMA with
    Laplace smoothing alone, and needs no draw."""
    rng = np.random.default_rng(0)
    k, d = 12, 8
    z = rng.standard_normal((2, 2, 4, 4, d)).astype(np.float32)
    emb = rng.standard_normal((k, d)).astype(np.float32)
    count = (5.0 + 3.0 * rng.random(k)).astype(np.float32)
    state = {"embeddings": emb, "ema_count": count,
             "ema_sum": emb * count[:, None],
             "initialized": np.ones((), np.bool_)}
    flax_cb = JaxCodebook(k, d, kernel_mode="xla")
    want, mutated = flax_cb.apply(
        {"codebook": state}, jnp.asarray(z), train=True,
        rngs={"codebook": jax.random.key(1)}, mutable=["codebook"])
    new_state = mutated["codebook"]
    assert float(jnp.min(new_state["ema_count"])) >= 1.0    # no restart

    cb = _port_codebook(k, d, state)
    tz = torch.from_numpy(z).requires_grad_()
    vq = cb(tz, train=True, generator=torch.Generator().manual_seed(0))
    _compare(vq, want, cb, new_state)
    # the lookup ran on the embeddings before the update
    torch.testing.assert_close(
        vq["embeddings"].detach(),
        torch.from_numpy(emb)[vq["encodings"].long()], rtol=1e-6, atol=1e-6)
    # straight-through: the output's gradient reaches z unchanged; the
    # commitment loss pulls z towards its code
    (vq["embeddings"].sum() + vq["commitment_loss"]).backward()
    want_grad = jax.grad(lambda z: (lambda o: jnp.sum(o["embeddings"])
                                    + o["commitment_loss"])(
        flax_cb.apply({"codebook": state}, z, train=False)))(jnp.asarray(z))
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(want_grad),
                               rtol=TOL, atol=TOL)


def _jax_rows(flax_cb, state, z, key):
    """The rows the JAX module draws inside ``__call__`` under these rngs."""
    flat = jnp.asarray(z).reshape(-1, z.shape[-1])

    def rows(m, flat):
        rng = m.make_rng("codebook")
        return (m._tile_rows(flat, jax.random.fold_in(rng, 0)),
                m._tile_rows(flat, jax.random.fold_in(rng, 2)))

    return flax_cb.apply({"codebook": state}, flat, method=rows,
                         rngs={"codebook": key})


@pytest.mark.parametrize("rows,k", [(64, 12), (16, 40)],
                         ids=["more rows than codes", "fewer: tiled + noise"])
def test_first_step_init_and_restart_match_jax(rows, k):
    rng = np.random.default_rng(rows)
    d = 8
    z = rng.standard_normal((rows // 16, 1, 4, 4, d)).astype(np.float32)
    # half the rows are one vector: init rows drawn from them coincide, only
    # the first of them is ever the nearest, and the others restart
    z[:, 0, :2] = z[0, 0, 0, 0]
    emb = rng.standard_normal((k, d)).astype(np.float32)
    state = {"embeddings": emb, "ema_count": np.zeros(k, np.float32),
             "ema_sum": emb.copy(), "initialized": np.zeros((), np.bool_)}
    flax_cb = JaxCodebook(k, d, kernel_mode="xla")
    key = jax.random.key(5)
    k_init, k_rand = _jax_rows(flax_cb, state, z, key)
    want, mutated = flax_cb.apply(
        {"codebook": state}, jnp.asarray(z), train=True,
        rngs={"codebook": key}, mutable=["codebook"])
    new_state = jax.device_get(mutated["codebook"])
    # the init took the drawn rows: the lookup ran on them
    np.testing.assert_allclose(
        np.asarray(want["embeddings"]).reshape(-1, d),
        np.asarray(k_init)[np.asarray(want["encodings"]).reshape(-1)],
        rtol=1e-6, atol=1e-6)
    restarted = new_state["ema_count"] < 1.0
    assert 0 < restarted.sum() < k
    np.testing.assert_allclose(new_state["embeddings"][restarted],
                               np.asarray(k_rand)[restarted], rtol=1e-6,
                               atol=1e-6)

    cb = _port_codebook(k, d, state)
    vq = cb(torch.from_numpy(z), train=True,
            init_rows=torch.from_numpy(np.array(k_init)),
            restart_rows=torch.from_numpy(np.array(k_rand)))
    _compare(vq, want, cb, new_state)
    assert bool(cb.initialized)

    # the second step keeps the embeddings it has (no init), and restarts
    # by the same rule written out in numpy
    z2 = rng.standard_normal(z.shape).astype(np.float32)
    rows2 = rng.standard_normal((k, d)).astype(np.float32)
    emb1, n1, s1 = (getattr(cb, n).numpy().copy()
                    for n in ("embeddings", "ema_count", "ema_sum"))
    vq2 = cb(torch.from_numpy(z2), train=True,
             init_rows=torch.full((k, d), 99.0),
             restart_rows=torch.from_numpy(rows2))
    flat2 = z2.reshape(-1, d)
    idx = vq2["encodings"].numpy().reshape(-1)
    dist = ((flat2[:, None, :] - emb1[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx, dist.argmin(1))
    onehot = np.eye(k, dtype=np.float32)[idx]
    new_n = 0.99 * n1 + 0.01 * onehot.sum(0)
    new_s = 0.99 * s1 + 0.01 * onehot.T @ flat2
    total = new_n.sum()
    weights = (new_n + 1e-7) / (total + k * 1e-7) * total
    new_e = np.where(new_n[:, None] >= 1.0, new_s / weights[:, None], rows2)
    np.testing.assert_allclose(cb.ema_count.numpy(), new_n, rtol=STATE_TOL,
                               atol=STATE_TOL)
    np.testing.assert_allclose(cb.ema_sum.numpy(), new_s, rtol=STATE_TOL,
                               atol=STATE_TOL)
    np.testing.assert_allclose(cb.embeddings.numpy(), new_e, rtol=STATE_TOL,
                               atol=STATE_TOL)


def test_eval_forward_changes_no_buffer():
    rng = np.random.default_rng(3)
    k, d = 12, 8
    emb = rng.standard_normal((k, d)).astype(np.float32)
    state = {"embeddings": emb, "ema_count": np.zeros(k, np.float32),
             "ema_sum": emb.copy(), "initialized": np.zeros((), np.bool_)}
    cb = _port_codebook(k, d, state)
    before = {n: b.clone() for n, b in cb.named_buffers()}
    cb(torch.from_numpy(rng.standard_normal((1, 2, 4, 4, d)).astype(
        np.float32)))
    for n, b in cb.named_buffers():
        assert torch.equal(b, before[n]), n
    assert set(before) == {"embeddings", "ema_count", "ema_sum",
                           "initialized"}


@pytest.mark.parametrize("rows", [64, 10])
def test_tile_rows_draws_candidate_rows(rows):
    """The port's own draw: n_codes rows of flat without repeats when there
    are enough, else rows of the tiled flat with noise of std 0.01/sqrt(D);
    repeatable by the generator's seed."""
    k, d = 24, 8
    cb = Codebook(k, d)
    flat = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (rows, d)).astype(np.float32))
    a = cb.tile_rows(flat, torch.Generator().manual_seed(1))
    b = cb.tile_rows(flat, torch.Generator().manual_seed(1))
    c = cb.tile_rows(flat, torch.Generator().manual_seed(2))
    assert tuple(a.shape) == (k, d)
    assert torch.equal(a, b) and not torch.equal(a, c)
    nearest = torch.cdist(a, flat).min(dim=1)
    if rows >= k:
        assert bool((a == flat[nearest.indices]).all())     # rows of flat
        assert len(set(nearest.indices.tolist())) == k      # no repeats
    else:
        # noise of std 0.01 / sqrt(8) per coordinate: far under the spacing
        assert 0.0 < float(nearest.values.max()) < 0.05
        assert len(set(nearest.indices.tolist())) == rows   # every row used
