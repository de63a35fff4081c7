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


# bf16 compute against the JAX bf16 denoiser: one fifth of the bf16-vs-f32
# drift that tests/test_denoiser.py allows (0.05). Both round the dense
# layers' outputs to bf16 but in other places (XLA keeps fused elementwise
# chains in f32), so the two differ by rounding noise that grows over the
# layers: measured 0.0070 on the logits (scale 1.53) and 0.0071 of the
# largest gradient, where the JAX bf16 logits lie 0.0077 from its f32 ones.
BF16_TOL = 0.05 / 5


def test_bf16_denoiser_matches_flax_bf16_logits_and_gradients(monkeypatch):
    """``dtype=bfloat16`` as the flax module's: f32 parameters and logits,
    bf16 dense layers, both attentions on bf16 q / k / v (the Pallas kernel
    in interpret mode on the JAX side), every parameter gradient back in
    f32."""
    import functools

    from gif_synthesis_with_discrete_diffusion_tpu.ops.attention import (
        fused_mha as jax_fused_mha)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
        attention)

    monkeypatch.setattr(jden, "fused_mha",
                        functools.partial(jax_fused_mha, interpret=True))
    seen = []
    real = attention.fused_mha

    def spy(q, k, v, *, n_head):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, n_head=n_head)

    monkeypatch.setattr(tden, "fused_mha", spy)
    rng = np.random.default_rng(0)
    kw = dict(num_embed=NUM_EMBED, spatial_size=SPATIAL, n_layer=2,
              n_embd=64, n_head=16, condition_dim=COND_DIM,
              diffusion_step=STEPS)
    flax_model = jden.DenoiserTransformer(content_seq_len=L,
                                          dtype=jnp.bfloat16, **kw)
    tokens = rng.integers(0, NUM_EMBED + 1, (3, L)).astype(np.int32)
    cond = rng.standard_normal((3, 2, COND_DIM)).astype(np.float32)
    t = np.array([0, 4, STEPS - 1], np.int32)
    args = (jnp.asarray(tokens), jnp.asarray(cond), jnp.asarray(t))
    params = jax.jit(flax_model.init)(jax.random.key(0), *args)["params"]
    params = _randomize(params, rng, 0.2)

    def loss(p):
        y = flax_model.apply({"params": p}, *args, fused_attention=True)
        return jnp.mean(y ** 2), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    assert want.dtype == jnp.float32

    model = tden.DenoiserTransformer(dtype=torch.bfloat16, **kw)
    model.load_state_dict(flax_to_state_dict(params))
    got = model(torch.from_numpy(tokens).long(), torch.from_numpy(cond),
                torch.from_numpy(t).long())
    assert got.dtype == torch.float32
    assert seen == [(torch.bfloat16,) * 3] * 4   # 2 layers x self, cross
    assert float((got.detach() - torch.from_numpy(np.asarray(want))).abs()
                 .max()) <= BF16_TOL
    (got ** 2).mean().backward()
    want_grads = flax_to_state_dict(jax.device_get(grads))
    scale = max(float(w.abs().max()) for w in want_grads.values())
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        err = float((p.grad - want_grads[name]).abs().max())
        assert err <= BF16_TOL * scale, (name, err / scale)
