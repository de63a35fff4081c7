"""Activation checkpointing (``transformer.checkpoint: true``) and dropout
(ROADMAP finding F10) in the port, against the JAX package (CPU).

* checkpointing recomputes each denoiser block in the backward: the same
  loss and the same gradients as without it, bit for bit on the CPU, in
  f32 and with bf16 compute; and within 1e-5 of the largest gradient of
  the flax denoiser under ``remat=True`` on bridged weights;
* F10: with ``attn_pdrop = resid_pdrop = 0.1`` the port builds, samples
  the same tokens as at 0 and evaluates the same loss, and its training
  step raises, where the JAX package's training step raises flax's
  ``InvalidRngError`` on the same configuration (and its sampling works).
"""
import flax.errors
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models import (
    denoiser as jden)
from gif_synthesis_with_discrete_diffusion_tpu.models.discrete_diffusion \
    import D3PM as JaxD3PM
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
    denoiser as tden)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
    discrete_diffusion as tdd)

NUM_EMBED, L, SPATIAL, COND_DIM, STEPS = 16, 16, (4, 4), 24, 10  # K = 17
KW = dict(num_embed=NUM_EMBED, spatial_size=SPATIAL, n_layer=2, n_embd=64,
          n_head=16, condition_dim=COND_DIM, diffusion_step=STEPS)
REMAT_TOL = 1e-5   # of the largest JAX remat gradient


def _inputs(rng):
    tokens = rng.integers(0, NUM_EMBED + 1, (3, L)).astype(np.int32)
    cond = rng.standard_normal((3, 2, COND_DIM)).astype(np.float32)
    t = np.array([0, 4, STEPS - 1], np.int32)
    weight = rng.standard_normal((3, NUM_EMBED, L)).astype(np.float32)
    return tokens, cond, t, weight


def _port_grads(state, checkpoint, dtype, tokens, cond, t, weight):
    model = tden.DenoiserTransformer(dtype=dtype, checkpoint=checkpoint,
                                     **KW)
    model.load_state_dict(state)
    out = model(torch.from_numpy(tokens).long(), torch.from_numpy(cond),
                torch.from_numpy(t).long())
    loss = (out * torch.from_numpy(weight)).sum()
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_checkpointed_denoiser_equals_plain_bitwise(dtype):
    rng = np.random.default_rng(0)
    state = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32) * 0.2) for n, p in
        tden.DenoiserTransformer(**KW).state_dict().items()}
    args = _inputs(rng)
    loss0, g0 = _port_grads(state, False, dtype, *args)
    loss1, g1 = _port_grads(state, True, dtype, *args)
    assert torch.equal(loss0, loss1)
    assert set(g0) == set(g1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    # no gradient needed: the forward runs once, as without checkpointing
    model = tden.DenoiserTransformer(dtype=dtype, checkpoint=True, **KW)
    model.load_state_dict(state)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a).long() if a.dtype == np.int32
                      else torch.from_numpy(a) for a in args[:3]))
    assert not out.requires_grad


def test_checkpointed_denoiser_matches_flax_remat_gradients():
    rng = np.random.default_rng(1)
    tokens, cond, t, weight = _inputs(rng)
    flax_model = jden.DenoiserTransformer(content_seq_len=L, remat=True,
                                          **KW)
    args = (jnp.asarray(tokens), jnp.asarray(cond), jnp.asarray(t))
    params = jax.jit(flax_model.init)(jax.random.key(0), *args)["params"]
    params = jax.tree.map(lambda x: (0.2 * rng.standard_normal(
        x.shape)).astype(np.float32), jax.device_get(params))

    def loss(p):
        y = flax_model.apply({"params": p}, *args, deterministic=True,
                             fused_attention=False)
        return jnp.sum(y * jnp.asarray(weight))

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(params)
    want = flax_to_state_dict(jax.device_get(grads))
    got_loss, got = _port_grads(flax_to_state_dict(params), True,
                                torch.float32, tokens, cond, t, weight)
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=1e-4)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in got.items():
        err = float((g - want[name]).abs().max())
        assert err <= REMAT_TOL * scale, (name, err / scale)


def _port_d3pm(**tkw):
    cfg = {"generator": {
        "diffusion_model": {"diffusion_step": STEPS, "guidance_scale": 2.0,
                            "transformer": dict(
                                n_layer=1, n_embd=64, n_head=16,
                                condition_dim=COND_DIM,
                                content_spatial_size=list(SPATIAL), **tkw)},
        "textencoder": {"mode": "label", "n_classes": 3,
                        "dim": COND_DIM}}}
    model = tdd.make_discrete_diffusion(cfg, NUM_EMBED, (1, 4, 4))
    tdd.init_discrete_diffusion_(model, torch.Generator().manual_seed(0))
    return model


def test_checkpointed_d3pm_train_step_equals_plain():
    """The whole training loss with checkpointing: the same loss and
    gradients (bit for bit) and the same Lt buffers."""
    rng = np.random.default_rng(2)
    content = torch.from_numpy(rng.integers(0, NUM_EMBED, (3, L)))
    batch = {"label": torch.tensor([0, 2, 1])}
    draws = dict(t=torch.tensor([0, 3, 9]), pt=torch.full((3,), 0.1),
                 noise=torch.rand((3, NUM_EMBED + 1, L),
                                  generator=torch.Generator().manual_seed(3)))
    outs = []
    for checkpoint in (False, True):
        model = _port_d3pm(checkpoint=checkpoint)
        out = model(batch, content, train=True, **draws)
        out["loss"].backward()
        outs.append((out["loss"].detach(),
                     {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None},
                     model.diffusion.lt_history.clone()))
    (l0, g0, h0), (l1, g1, h1) = outs
    assert torch.equal(l0, l1) and torch.equal(h0, h1)
    assert set(g0) == set(g1) and g0
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_f10_dropout_builds_samples_and_raises_at_training_as_jax():
    # the port: builds, samples the tokens of pdrop 0, evaluates the same
    # loss, and raises at a training step
    plain = _port_d3pm()
    drop = _port_d3pm(attn_pdrop=0.1, resid_pdrop=0.1)
    drop.load_state_dict(plain.state_dict())
    batch = {"label": torch.tensor([0, 2])}
    tokens = [m.sample(batch, 2, generator=torch.Generator().manual_seed(4),
                       sample=True, mode="model") for m in (plain, drop)]
    assert torch.equal(tokens[0], tokens[1])
    content = torch.randint(0, NUM_EMBED, (2, L),
                            generator=torch.Generator().manual_seed(5))
    evals = [m(batch, content, train=False,
               generator=torch.Generator().manual_seed(6))["loss"]
             for m in (plain, drop)]
    assert torch.equal(evals[0], evals[1])
    with pytest.raises(RuntimeError, match="F10.*InvalidRngError"):
        drop(batch, content, train=True,
             generator=torch.Generator().manual_seed(6))
    assert float(drop.diffusion.lt_count.sum()) == 0.0   # nothing updated

    # the JAX package on the same configuration: sampling works, the
    # training step raises InvalidRngError
    jm = JaxD3PM(num_embed=NUM_EMBED, content_seq_len=L,
                 spatial_size=SPATIAL, diffusion_step=STEPS, n_layer=1,
                 n_embd=64, n_head=16, condition_dim=COND_DIM,
                 attn_pdrop=0.1, resid_pdrop=0.1)
    cond = jnp.asarray(np.random.default_rng(7).standard_normal(
        (2, 1, COND_DIM)).astype(np.float32))
    x = jnp.asarray(content.numpy().astype(np.int32))
    key = jax.random.key(0)
    variables = jm.init({"params": key, "diffusion": key}, x, cond,
                        train=False)
    jt = jm.apply(variables, cond, cond, 2, rngs={"diffusion": key},
                  method=JaxD3PM.sample)
    assert jt.shape == (2, L)
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        jm.apply(variables, x, cond, train=True, rngs={"diffusion": key},
                 mutable=["diffusion"])
