"""PyTorch port's denoiser vs the flax ``DenoiserTransformer`` (CPU), with
the flax weights carried over by ``convert/from_flax.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models import (
    denoiser as jden)
from gif_synthesis_with_discrete_diffusion_tpu.models.embeddings import (
    TokenGridEmbedding as JaxTokenGridEmbedding)
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
    denoiser as tden)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models.embeddings import (
    TokenGridEmbedding)

NUM_EMBED, L, SPATIAL, COND_DIM, STEPS = 16, 16, (4, 4), 24, 10  # K = 17
# f32 transformer in two frameworks; flax's LayerNorm takes the variance as
# E[x^2] - E[x]^2, torch in two passes
TOL = 1e-4


def _randomize(tree, rng, scale):
    """Every leaf redrawn N(0, scale^2), so no weight is the init's 0 or 1."""
    return jax.tree.map(lambda x: (scale * rng.standard_normal(
        x.shape)).astype(np.float32), jax.device_get(tree))


@pytest.mark.parametrize("activate", ["GELU2", "GELU"])
def test_denoiser_logits_match_flax(activate):
    rng = np.random.default_rng(0)
    kw = dict(num_embed=NUM_EMBED, spatial_size=SPATIAL, n_layer=2,
              n_embd=64, n_head=16, condition_dim=COND_DIM,
              diffusion_step=STEPS, block_activate=activate)
    flax_model = jden.DenoiserTransformer(content_seq_len=L, **kw)
    tokens = rng.integers(0, NUM_EMBED + 1, (3, L)).astype(np.int32)
    cond = rng.standard_normal((3, 2, COND_DIM)).astype(np.float32)
    t = np.array([0, 4, STEPS - 1], np.int32)
    args = (jnp.asarray(tokens), jnp.asarray(cond), jnp.asarray(t))
    params = jax.jit(flax_model.init)(jax.random.key(0), *args)["params"]
    params = _randomize(params, rng, 0.2)
    want = jax.jit(lambda p: flax_model.apply(
        {"params": p}, *args, fused_attention=False))(params)

    model = tden.DenoiserTransformer(**kw).eval()
    model.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(), torch.from_numpy(cond),
                    torch.from_numpy(t).long())
    assert tuple(got.shape) == (3, NUM_EMBED, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_token_grid_embedding_clamps_and_slices_positions():
    """Negative ids clamp to 0, and a sequence shorter than the positional
    grid takes its first positions (a 4x6 grid, 10 tokens)."""
    rng = np.random.default_rng(1)
    idx = rng.integers(-2, NUM_EMBED + 1, (2, 10)).astype(np.int32)
    flax_emb = JaxTokenGridEmbedding(NUM_EMBED, (4, 6), 8)
    params = _randomize(flax_emb.init(jax.random.key(0), jnp.asarray(idx))[
        "params"], rng, 1.0)
    want = flax_emb.apply({"params": params}, jnp.asarray(idx))
    emb = TokenGridEmbedding(NUM_EMBED, (4, 6), 8)
    emb.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = emb(torch.from_numpy(idx).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_gelu2_and_timestep_embedding_match():
    x = np.linspace(-4, 4, 41).astype(np.float32)
    np.testing.assert_allclose(tden.gelu2(torch.from_numpy(x)).numpy(),
                               np.asarray(jden.gelu2(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    t = np.array([0, 7, 99], np.int32)
    want = jden.SinusoidalPosEmb(100, 64).apply({}, jnp.asarray(t))
    got = tden.SinusoidalPosEmb(100, 64)(torch.from_numpy(t).long())
    # sin/cos of f32 arguments up to 99/100*4000 = 3960 rad, where one ulp
    # of the argument is 2.4e-4: XLA and ATen reduce the range differently
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-4)


def test_token_grid_embedding_trainable_flag_stops_the_gradient():
    """``trainable=False`` as the flax module's stop_gradient: the same
    output, no gradient to the tables."""
    idx = torch.tensor([[0, 3, 16, 2]])
    emb = TokenGridEmbedding(16, (2, 2), 8)
    for p in emb.parameters():
        torch.nn.init.normal_(p)
    frozen = TokenGridEmbedding(16, (2, 2), 8, trainable=False)
    frozen.load_state_dict(emb.state_dict())
    out, out_frozen = emb(idx), frozen(idx)
    torch.testing.assert_close(out_frozen, out, rtol=0, atol=0)
    assert out.requires_grad and not out_frozen.requires_grad
    out.sum().backward()
    assert emb.emb.weight.grad is not None
