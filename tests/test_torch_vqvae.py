"""PyTorch port's same-pad convs and VQ-VAE decode vs the JAX package (CPU),
with the flax params, batch_stats and codebook carried over by
``convert/from_flax.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models.vqvae import (
    VQVAE as JaxVQVAE)
from gif_synthesis_with_discrete_diffusion_tpu.ops import conv3d as jconv
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    conv3d_weight, conv_transpose3d_weight, vqvae_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models.vqvae import VQVAE
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import conv3d as tconv

# the tolerance of tests/test_conv3d.py (f32 convs in two frameworks)
TOL = 2e-4


@pytest.mark.parametrize("k,s,shape", [     # tests/test_conv3d.py:53-57
    (4, (2, 2, 2), (2, 2, 4, 4, 3)),
    (4, (1, 2, 2), (1, 4, 8, 8, 5)),
    (4, (2, 1, 1), (1, 2, 3, 3, 2)),
])
def test_same_pad_conv_transpose3d_matches(k, s, shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, k, k, shape[-1], 4))).astype(
        np.float32)                                 # DHWIO, forward
    bias = rng.standard_normal((4,)).astype(np.float32)
    want = jconv.same_pad_conv_transpose3d(jnp.asarray(x), jnp.asarray(w), s,
                                           jnp.asarray(bias))
    got = tconv.same_pad_conv_transpose3d(
        torch.from_numpy(x), torch.from_numpy(conv_transpose3d_weight(w)), s,
        torch.from_numpy(bias))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("k,s,shape", [     # tests/test_conv3d.py:27-32
    (4, (2, 2, 2), (2, 4, 8, 8, 3)),
    (4, (1, 2, 2), (1, 4, 16, 16, 5)),
    (3, (1, 1, 1), (2, 3, 6, 6, 4)),
    (1, (1, 1, 1), (1, 2, 4, 4, 7)),
])
def test_same_pad_conv3d_matches(k, s, shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, k, k, shape[-1], 6))).astype(
        np.float32)
    bias = rng.standard_normal((6,)).astype(np.float32)
    want = jconv.same_pad_conv3d(jnp.asarray(x), jnp.asarray(w), s,
                                 jnp.asarray(bias))
    got = tconv.same_pad_conv3d(torch.from_numpy(x),
                                torch.from_numpy(conv3d_weight(w)), s,
                                torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _flax_vqvae(rng, **kw):
    """A flax VQVAE with every param, batch statistic and code redrawn."""
    model = JaxVQVAE(kernel_mode="xla", **kw)
    x = jnp.zeros((1, kw["sequence_length"], kw["resolution"],
                   kw["resolution"], 3))
    v = jax.device_get(jax.jit(lambda r: model.init(r, {"video": x},
                                                   train=True))(
        {"params": jax.random.key(1), "codebook": jax.random.key(2)}))
    draw = lambda a, s: (s * rng.standard_normal(a.shape)).astype(  # noqa
        np.float32)
    params = jax.tree.map(lambda a: draw(a, 0.2), v["params"])
    stats = jax.tree.map(lambda a: draw(a, 0.3), v["batch_stats"])
    for bn in jax.tree_util.tree_leaves(
            stats, is_leaf=lambda n: isinstance(n, dict) and "var" in n):
        bn["var"] = np.abs(bn["var"]) + 0.5       # a variance is positive
    codebook = {"codebook": dict(v["codebook"]["codebook"],
                                 embeddings=draw(v["codebook"]["codebook"][
                                     "embeddings"], 1.0))}
    return model, {"params": params, "batch_stats": stats,
                   "codebook": codebook}


def test_vqvae_decode_matches_flax():
    rng = np.random.default_rng(2)
    kw = dict(embedding_dim=16, n_codes=32, n_hiddens=32, n_res_layers=1,
              downsample=(1, 2, 2), sequence_length=4, resolution=8)
    flax_model, variables = _flax_vqvae(rng, **kw)
    codes = rng.integers(0, 32, (2, 4, 4, 4)).astype(np.int32)
    want = jax.jit(lambda v, c: flax_model.apply(
        v, c, method=JaxVQVAE.decode))(variables, jnp.asarray(codes))

    model = VQVAE(**kw).eval()
    model.load_state_dict(vqvae_state_dict(
        variables["params"], variables["batch_stats"],
        variables["codebook"]))
    with torch.no_grad():
        got = model.decode(torch.from_numpy(codes).long())
    assert tuple(got.shape) == (2, 4, 8, 8, 3) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


ENCODE_KW = dict(embedding_dim=16, n_codes=32, n_hiddens=32, n_res_layers=1,
                 downsample=(1, 2, 2), sequence_length=4, resolution=8)


def _encode_pair(seed):
    """A flax VQVAE with redrawn variables, the port's VQVAE with the same
    state, and a normalised-looking input clip."""
    rng = np.random.default_rng(seed)
    flax_model, variables = _flax_vqvae(rng, **ENCODE_KW)
    model = VQVAE(**ENCODE_KW).eval()
    model.load_state_dict(vqvae_state_dict(
        variables["params"], variables["batch_stats"],
        variables["codebook"]))
    x = rng.standard_normal((2, 4, 8, 8, 3)).astype(np.float32)
    return flax_model, variables, model, x


def test_encoder_features_and_tokens_match_flax():
    flax_model, variables, model, x = _encode_pair(3)
    want_h = jax.jit(lambda v, x: flax_model.apply(
        v, x, method=lambda m, x: m.pre_vq_conv(m.encoder(
            x, train=False))))(variables, jnp.asarray(x))
    want_tok = jax.jit(lambda v, x: flax_model.apply(
        v, x, method=JaxVQVAE.encode))(variables, jnp.asarray(x))
    with torch.no_grad():
        h = model.pre_vq_conv(model.encoder(torch.from_numpy(x)))
        tok = model.encode(torch.from_numpy(x))
    assert tuple(h.shape) == want_h.shape == (2, 4, 4, 4, 16)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=TOL,
                               atol=TOL)
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))


def test_codebook_outputs_match_flax_eval_call():
    flax_model, variables, model, x = _encode_pair(4)
    want = jax.jit(lambda v, x: flax_model.apply(
        v, {"video": x}, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        z = model.pre_vq_conv(model.encoder(torch.from_numpy(x)))
        vq = model.codebook(z)
        codes, st = model.encode(torch.from_numpy(x),
                                 include_embeddings=True)
    np.testing.assert_array_equal(vq["encodings"].numpy(),
                                  np.asarray(want["encodings"]))
    torch.testing.assert_close(codes, vq["encodings"], rtol=0, atol=0)
    # the straight-through output's value is the quantised vector
    torch.testing.assert_close(st, model.codebook.lookup(codes.long()),
                               rtol=1e-6, atol=1e-6)
    for name, got, wnt in (
            ("commitment", vq["commitment_loss"],
             want["losses"]["commitment_loss"]),
            ("perplexity", vq["perplexity"], want["metrics"]["perplexity"]),
            ("entropy", vq["entropy"], want["entropy"]),
            ("codebook", vq["codebook_loss"], want["codebook_loss"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(wnt), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_codebook_state_and_training_path():
    _, variables, model, x = _encode_pair(5)
    cb = variables["codebook"]["codebook"]
    for name in ("embeddings", "ema_count", "ema_sum"):
        np.testing.assert_array_equal(
            getattr(model.codebook, name).numpy(), np.asarray(cb[name]))
    assert not bool(model.codebook.initialized)
    # the training path: the first step initialises the codebook from data
    rows = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 32, 16)).astype(np.float32))
    tok = model.encode(torch.from_numpy(x), train=True, init_rows=rows[0],
                       restart_rows=rows[1])
    assert tuple(tok.shape) == (2, 4, 4, 4) and tok.dtype == torch.int32
    assert bool(model.codebook.initialized)
    assert not np.array_equal(model.codebook.embeddings.numpy(),
                              np.asarray(cb["embeddings"]))


def test_vqvae_decode_in_training_mode_matches_flax_with_gradients():
    """``decode(train=True)`` (BatchNorm on batch statistics) against the
    flax ``VQVAE.decode(train=True)``, and the decoder's gradient from
    tokens against jax.grad: the decode is differentiable when grad mode is
    on; under no_grad (the serving path) it builds no graph."""
    rng = np.random.default_rng(6)
    kw = dict(embedding_dim=16, n_codes=32, n_hiddens=32, n_res_layers=1,
              downsample=(1, 2, 2), sequence_length=4, resolution=8)
    flax_model, variables = _flax_vqvae(rng, **kw)
    codes = rng.integers(0, 32, (2, 4, 4, 4)).astype(np.int32)
    w = rng.standard_normal((2, 4, 8, 8, 3)).astype(np.float32)

    def loss(params):
        out, _ = flax_model.apply(
            {**variables, "params": params}, jnp.asarray(codes),
            method=JaxVQVAE.decode, train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    model = VQVAE(**kw)
    model.load_state_dict(vqvae_state_dict(
        variables["params"], variables["batch_stats"],
        variables["codebook"]))
    got = model.decode(torch.from_numpy(codes).long(), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    (got * torch.from_numpy(w)).sum().backward()
    want_grads = vqvae_state_dict(jax.device_get(grads),
                                  variables["batch_stats"],
                                  variables["codebook"])
    decoder = [(n, p) for n, p in model.named_parameters()
               if n.startswith(("decoder.", "post_vq_conv."))]
    assert decoder and all(p.grad is not None for _, p in decoder)
    # each gradient against its max-abs, floored at 1e-4 of the largest (a
    # bias that BatchNorm follows has a zero gradient analytically: the
    # two frameworks' rounding noise), as the stage-2 gradient test does
    floor = 1e-4 * max(float(want_grads[n].abs().max()) for n, _ in decoder)
    for name, p in decoder:
        scale = max(float(want_grads[name].abs().max()), floor)
        torch.testing.assert_close(p.grad, want_grads[name], rtol=0,
                                   atol=1e-3 * scale, msg=name)
    with torch.no_grad():
        assert model.decode(torch.from_numpy(codes).long()).grad_fn is None


@pytest.mark.parametrize("transpose", [False, True])
def test_bf16_conv_modules_match_flax(transpose):
    """The conv modules at ``dtype=bfloat16``: f32 parameters, bf16 input
    and kernel, a bf16 output and the bias added in bf16, as the flax
    modules. Both sum in f32 and round once: within one bf16 step of the
    output's largest magnitude."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        bf16_step)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 8, 8, 5)).astype(np.float32)
    flax_cls = (jconv.SamePadConvTranspose3d if transpose
                else jconv.SamePadConv3d)
    flax_conv = flax_cls(6, 4, (1, 2, 2), dtype=jnp.bfloat16)
    params = jax.tree.map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(flax_conv.init(jax.random.key(0), jnp.asarray(x))))
    want = np.asarray(flax_conv.apply(params, jnp.asarray(x)))
    kernel = params["params"]["kernel"]
    cls, weight = ((tconv.SamePadConvTranspose3d, conv_transpose3d_weight)
                   if transpose else (tconv.SamePadConv3d, conv3d_weight))
    conv = cls(5, 6, 4, (1, 2, 2), dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(weight(kernel)))
        conv.bias.copy_(torch.from_numpy(params["params"]["bias"]))
    got = conv(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    want = want.astype(np.float32)
    assert float(np.abs(got.float().detach().numpy() - want).max()) <= \
        bf16_step(float(np.abs(want).max()))
