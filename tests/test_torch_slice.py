"""The PyTorch port's whole serving slice vs a loop over the JAX pieces (CPU).

Conditioner (label) -> 8-step D3PM reverse process with CFG 2 in argmax
mode -> VQ-VAE decode. The JAX side is the flax denoiser with einsum
attention, the Pallas ``fused_sample_step`` in interpret mode, and
``VQVAE.decode``; the port runs ``generate.sample_videos`` with the same
weights carried over by ``convert/from_flax.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu.models.denoiser import (
    DenoiserTransformer as JaxDenoiser)
from gif_synthesis_with_discrete_diffusion_tpu.models.discrete_diffusion \
    import DiscreteDiffusionModel as JaxModel
from gif_synthesis_with_discrete_diffusion_tpu.models.discrete_diffusion \
    import make_discrete_diffusion as jax_make_discrete_diffusion
from gif_synthesis_with_discrete_diffusion_tpu.models.vqvae import (
    VQVAE as JaxVQVAE)
from gif_synthesis_with_discrete_diffusion_tpu.ops.sampler_kernel import (
    fused_sample_step as jax_fused_sample_step, schedule_rows as jax_rows)
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict, vqvae_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
    build_models, sample_token_grid, sample_videos)

T, B = 8, 3
CONFIG = {   # shaped like generate.HONEST, cut to a (2, 4, 4) grid
    "vqvae": {"embedding_dim": 16, "n_codes": 16, "n_hiddens": 32,
              "n_res_layers": 1, "downsample": (1, 2, 2),
              "sequence_length": 2, "resolution": 8},
    "generator": {
        "diffusion_model": {
            "diffusion_step": T, "guidance_scale": 2.0,
            "transformer": {"n_layer": 2, "n_embd": 64, "n_head": 16,
                            "condition_dim": 32}},
        "textencoder": {"mode": "label", "n_classes": 5, "dim": 32}},
}
LATENT = (2, 4, 4)
K = 17
# the decode's tolerance (tests/test_conv3d.py, f32 convs)
VIDEO_TOL = 2e-4


def _draw(rng, tree, scale):
    return jax.tree.map(lambda a: (scale * rng.standard_normal(
        a.shape)).astype(np.float32), jax.device_get(tree))


def _denoiser():
    return JaxDenoiser(num_embed=16, spatial_size=(8, 4), n_layer=2,
                       n_embd=64, n_head=16, content_seq_len=32,
                       condition_dim=32, diffusion_step=T)


def _flax_weights(rng, labels):
    gen = jax_make_discrete_diffusion(CONFIG, CONFIG["vqvae"]["n_codes"],
                                      LATENT)
    # the generator's tree is {conditioner, diffusion/transformer}; init the
    # two parts apart (the generator's own init traces the training loss)
    cparams = gen.init(jax.random.key(0), {"label": labels}, B,
                       method=JaxModel.conditioner_embeddings)["params"]
    tparams = jax.jit(_denoiser().init)(
        jax.random.key(1), jnp.zeros((B, 32), jnp.int32),
        jnp.zeros((B, 1, 32)), jnp.zeros((B,), jnp.int32))["params"]
    gparams = _draw(rng, {"conditioner": cparams["conditioner"],
                          "diffusion": {"transformer": tparams}}, 0.1)
    ae = JaxVQVAE(kernel_mode="xla", **CONFIG["vqvae"])
    x = jnp.zeros((1, 2, 8, 8, 3))
    avars = jax.device_get(jax.jit(lambda r: ae.init(r, {"video": x},
                                                     train=True))(
        {"params": jax.random.key(2), "codebook": jax.random.key(3)}))
    stats = _draw(rng, avars["batch_stats"], 0.3)
    for bn in jax.tree_util.tree_leaves(
            stats, is_leaf=lambda n: isinstance(n, dict) and "var" in n):
        bn["var"] = np.abs(bn["var"]) + 0.5
    codebook = {"codebook": dict(avars["codebook"]["codebook"], embeddings=(
        rng.standard_normal((16, 16)).astype(np.float32)))}
    avars = {"params": _draw(rng, avars["params"], 0.2),
             "batch_stats": stats, "codebook": codebook}
    return gen, gparams, ae, avars


def _jax_slice(gen, gparams, ae, avars, labels):
    cond, cf = jax.jit(lambda p: gen.apply(
        {"params": p}, {"label": labels}, B,
        method=JaxModel.conditioner_embeddings))(gparams)
    cond2 = jnp.concatenate([cond, jnp.broadcast_to(cf, cond.shape)], 0)
    den = _denoiser()
    denoise = jax.jit(lambda p, x, t: den.apply(
        {"params": p}, x, cond2, t, fused_attention=False))
    rows = jax_rows(jd3pm.make_schedule(T, K))
    tokens = jnp.full((B, 32), K - 1, jnp.int32)
    for t in range(T - 1, -1, -1):
        logits2 = denoise(gparams["diffusion"]["transformer"],
                          jnp.concatenate([tokens, tokens], 0),
                          jnp.full((2 * B,), t, jnp.int32))
        tokens = jax_fused_sample_step(
            logits2, tokens, rows[t], jnp.int32(0), guidance=2.0,
            num_classes=K, sample=False, interpret=True)
    grid = tokens.reshape(B, *LATENT)
    video = jax.jit(lambda v, g: ae.apply(v, g, method=JaxVQVAE.decode))(
        avars, grid)
    return np.asarray(grid), np.asarray(video)


def test_slice_matches_jax_pieces_in_argmax_mode():
    rng = np.random.default_rng(0)
    labels = np.array([0, 3, 4], np.int32)
    gen, gparams, ae, avars = _flax_weights(rng, jnp.asarray(labels))
    want_tok, want_video = _jax_slice(gen, gparams, ae, avars,
                                      jnp.asarray(labels))

    models = build_models(CONFIG, "cpu", torch.Generator().manual_seed(0))
    # the generator's diffusion collection (Lt and telemetry buffers) as a
    # fresh flax init has it: zeros
    diffusion = {"diffusion": {name: np.zeros(T, np.float32) for name in (
        "lt_history", "lt_count", "diffusion_acc", "diffusion_keep")}}
    models.generator.load_state_dict(flax_to_state_dict(gparams,
                                                        buffers=diffusion))
    models.vqvae.load_state_dict(vqvae_state_dict(
        avars["params"], avars["batch_stats"], avars["codebook"]))
    batch = {"label": torch.from_numpy(labels)}
    tok = sample_token_grid(models, batch, torch.Generator().manual_seed(1),
                            sample=False)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    assert (tok != K - 1).all()
    video = sample_videos(models, batch, torch.Generator().manual_seed(1),
                          sample=False)
    assert tuple(video.shape) == (B, 2, 8, 8, 3)
    np.testing.assert_allclose(video.numpy(), want_video, rtol=VIDEO_TOL,
                               atol=VIDEO_TOL)


def test_build_models_is_seeded_and_follows_the_init_laws():
    a = build_models(CONFIG, "cpu", torch.Generator().manual_seed(5))
    b = build_models(CONFIG, "cpu", torch.Generator().manual_seed(5))
    for (name, x), (_, y) in zip(a.generator.state_dict().items(),
                                 b.generator.state_dict().items()):
        torch.testing.assert_close(x, y, msg=name)
    sd = a.generator.state_dict()
    w = sd["diffusion.transformer.block0.attn1.query.weight"]
    assert abs(w.std().item() - 0.02) < 0.005            # N(0, 0.02)
    assert sd["diffusion.transformer.block0.attn1.query.bias"].eq(0).all()
    vq = a.vqvae.state_dict()
    assert abs(vq["codebook.embeddings"].std().item() - 1.0) < 0.2
    assert vq["decoder.bn_out.running_var"].eq(1).all()
    lim = (3.0 / (32 * 4 ** 3)) ** 0.5                    # fan-in uniform
    assert vq["decoder.convt0.weight"].abs().max() <= lim
