"""The PyTorch port's text-conditioned stage-2 step vs the JAX package (CPU).

The conditioner is the frozen CLIP text tower (2 layers, width 16) over the
hash tokenizer's ids of the batch's captions; the denoiser 2 layers of
n_embd 16 in heads of 4. JAX side, as ``tests/test_torch_stage2.py``:
``preprocess_clip`` -> flax ``VQVAE.encode`` -> the text conditioner
(``stop_gradient``: no CLIP gradient) -> under ``learnable_cf`` the flax
``apply_learnable_cf`` -> ``d3pm.train_loss`` over the flax denoiser ->
``weighted_losses``, under ``jax.value_and_grad``. The port runs
``train/stage2.prepare_batch`` and ``train_step`` on the same weights with
the JAX draws handed in. The loss within 1e-5 of its size and each
gradient within 5e-4 of its tensor's max-abs (the f32 bounds of
``tests/test_torch_stage2.py``); the CLIP tower's gradients are zero on the
JAX side and absent in the port.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.data.preprocess import (
    preprocess_clip as jax_preprocess_clip)
from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu.models.clip_text import (
    HashTokenizer as JaxHashTokenizer)
from gif_synthesis_with_discrete_diffusion_tpu.models.denoiser import (
    DenoiserTransformer as JaxDenoiser)
from gif_synthesis_with_discrete_diffusion_tpu.models.discrete_diffusion \
    import DiscreteDiffusionModel as JaxModel
from gif_synthesis_with_discrete_diffusion_tpu.models.discrete_diffusion \
    import make_discrete_diffusion as jax_make_discrete_diffusion
from gif_synthesis_with_discrete_diffusion_tpu.models.vqvae import (
    VQVAE as JaxVQVAE)
from gif_synthesis_with_discrete_diffusion_tpu.train.metrics import (
    weighted_losses as jax_weighted_losses)
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict, vqvae_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models.clip_text import (
    HashTokenizer)
from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage2
from tests.test_torch_slice import CONFIG as SLICE_CONFIG, LATENT, T, _draw
from tests.test_torch_stage2 import GRAD_TOL, LOSS_RTOL

B, L, K = 4, 32, 17
CF_TOKENS = tuple(int(i) for i in HashTokenizer()([""])[0])
CAPTIONS = ["a man is singing on stage", "BreastStroke", "",
            "someone's driving a car"]


def _config(learnable_cf: bool) -> dict:
    return {
        "vqvae": dict(SLICE_CONFIG["vqvae"]),
        "generator": {
            "diffusion_model": {
                "diffusion_step": T, "learnable_cf": learnable_cf,
                "transformer": {"n_layer": 2, "n_embd": 16, "n_head": 4,
                                "condition_dim": 32}},
            "textencoder": {"mode": "text", "dim": 32, "width": 16,
                            "heads": 2, "layers": 2, "cf_tokens": CF_TOKENS,
                            "allow_hash_tokenizer": True}},
        "generator_losses": {"loss_dict": {"l_dummy": 1.0}},
        "lr_args": {"gen_lr": 1e-4},
    }


def _denoiser():
    return JaxDenoiser(num_embed=16, spatial_size=(8, 4), n_layer=2,
                       n_embd=16, n_head=4, content_seq_len=L,
                       condition_dim=32, diffusion_step=T)


def _flax_weights(rng, config, tokens):
    jcfg = copy.deepcopy(config)
    jcfg["generator"]["textencoder"].pop("allow_hash_tokenizer")
    gen = jax_make_discrete_diffusion(jcfg, 16, LATENT)
    cparams = jax.device_get(gen.init(
        jax.random.key(0), {"text_tokens": jnp.asarray(tokens)}, B,
        method=JaxModel.conditioner_embeddings)["params"])
    tparams = jax.jit(_denoiser().init)(
        jax.random.key(1), jnp.zeros((B, L), jnp.int32),
        jnp.zeros((B, 1, 32)), jnp.zeros((B,), jnp.int32))["params"]
    diffusion = {k: v for k, v in cparams.get("diffusion", {}).items()}
    diffusion["transformer"] = tparams
    gparams = _draw(rng, {"conditioner": cparams["conditioner"],
                          "diffusion": diffusion}, 0.1)
    ae = JaxVQVAE(kernel_mode="xla", **SLICE_CONFIG["vqvae"])
    x = jnp.zeros((1, 2, 8, 8, 3))
    avars = jax.device_get(jax.jit(lambda r: ae.init(r, {"video": x},
                                                     train=True))(
        {"params": jax.random.key(2), "codebook": jax.random.key(3)}))
    avars["codebook"]["codebook"]["embeddings"] = rng.standard_normal(
        (16, 16)).astype(np.float32)
    avars["params"] = _draw(rng, avars["params"], 0.2)
    return gen, gparams, ae, avars


@pytest.mark.parametrize("learnable_cf", [False, True],
                         ids=["text", "text, learnable CF"])
def test_text_train_step_matches_jax_loss_and_grads(learnable_cf):
    rng = np.random.default_rng(int(learnable_cf))
    config = _config(learnable_cf)
    tokens = JaxHashTokenizer()(CAPTIONS)
    gen, gparams, ae, avars = _flax_weights(rng, config, tokens)
    video = rng.integers(0, 256, (B, 2, 8, 8, 3)).astype(np.uint8)
    hist = np.full((T,), 1e-4, np.float32)
    hist[[1, 5]] = 50.0
    count = np.full((T,), 11.0, np.float32)
    lt = jd3pm.LtState(history=jnp.asarray(hist), count=jnp.asarray(count))
    key = jax.random.key(3)
    t_rng, q_rng = jax.random.split(key)            # as train_loss splits
    t, pt = jd3pm.sample_time(t_rng, lt, B, T)
    noise = jax.random.uniform(q_rng, (B, K, L), jnp.float32)
    mask = jnp.asarray([not c.strip() for c in CAPTIONS])

    sched = jd3pm.make_schedule(T, K)
    den = _denoiser()
    x = jax_preprocess_clip(jnp.asarray(video), 8)
    flat = ae.apply(avars, x, method=JaxVQVAE.encode).reshape(B, -1)
    batch = {"text_tokens": jnp.asarray(tokens)}
    zeros = jnp.zeros((T,), jnp.float32)
    dstate = {"diffusion": {"lt_history": zeros, "lt_count": zeros,
                            "diffusion_acc": zeros, "diffusion_keep": zeros}}

    def loss_fn(params):
        cond, _ = gen.apply({"params": params, "diffusion": dstate}, batch, B,
                            method=JaxModel.conditioner_embeddings)
        if learnable_cf:
            cond = gen.apply({"params": params, "diffusion": dstate}, cond,
                             mask,
                             method=lambda m, c, e:
                             m.diffusion.apply_learnable_cf(c, e))
        vb, _, _ = jd3pm.train_loss(
            key, sched, lambda x, c, t: den.apply(
                {"params": params["diffusion"]["transformer"]}, x, c, t,
                deterministic=False, fused_attention=False),
            flat, cond, lt, auxiliary_loss_weight=5e-4,
            adaptive_auxiliary_loss=True)
        return jax_weighted_losses({"l_dummy": 1.0},
                                   {"losses": jnp.sum(vb) / (B * L)})[0]

    want_total, grads = jax.jit(jax.value_and_grad(loss_fn))(gparams)

    state = stage2.build_stage2(config, "cpu",
                                torch.Generator().manual_seed(0))
    assert isinstance(state.tokenizer, HashTokenizer)
    assert state.learnable_cf == learnable_cf
    buffers = {"diffusion": {"lt_history": hist, "lt_count": count,
                             "diffusion_acc": np.zeros(T, np.float32),
                             "diffusion_keep": np.zeros(T, np.float32)}}
    state.generator.load_state_dict(flax_to_state_dict(gparams,
                                                       buffers=buffers))
    state.vqvae.load_state_dict(vqvae_state_dict(
        avars["params"], avars["batch_stats"], avars["codebook"]))
    prepared = stage2.prepare_batch({"video": video, "text": CAPTIONS},
                                    state.tokenizer, state.learnable_cf)
    np.testing.assert_array_equal(prepared["text_tokens"], tokens)
    assert prepared["text_tokens"].dtype == np.int32
    if learnable_cf:
        np.testing.assert_array_equal(prepared["empty_text_mask"],
                                      np.asarray(mask))
    else:
        assert "empty_text_mask" not in prepared
    values = stage2.train_step(
        state, prepared, t=torch.from_numpy(np.array(t)),
        pt=torch.from_numpy(np.array(pt)),
        noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(float(values["total"]), float(want_total),
                               rtol=LOSS_RTOL)

    params = dict(state.generator.named_parameters())
    want_grads = flax_to_state_dict(jax.device_get(grads))
    assert set(want_grads) == set(params)
    floor = 1e-4 * max(float(w.abs().max()) for w in want_grads.values())
    for name, want in want_grads.items():
        got = params[name].grad
        if name.startswith("conditioner.clip."):
            assert got is None and not params[name].requires_grad, name
            assert float(want.abs().max()) == 0.0, name
            continue
        scale = max(float(want.abs().max()), floor)
        torch.testing.assert_close(got, want, rtol=0, atol=GRAD_TOL * scale,
                                   msg=name)
    if learnable_cf:
        assert float(params["diffusion.empty_text_embed"].grad.abs().max()) \
            > 0


def test_synthetic_text_batch_and_msrvtt_configuration():
    batch = stage2.synthetic_batch(_config(False), 3,
                                   torch.Generator().manual_seed(2))
    assert batch["text"] == [("BreastStroke", "BaseballPitch")[int(i)]
                             for i in batch["label"]]
    assert "text" not in stage2.synthetic_batch(
        SLICE_CONFIG, 3, torch.Generator().manual_seed(2))
    cfg = stage2.TRAIN_STEP2_MSRVTT
    assert cfg["generator"]["textencoder"] == {
        "mode": "text", "dim": 512, "allow_hash_tokenizer": True}
    tr = cfg["generator"]["diffusion_model"]["transformer"]
    assert (tr["dtype"], tuple(tr["content_spatial_size"])) == \
        ("bfloat16", (48, 48))
    with torch.device("meta"):
        models = stage2.build_models(cfg, "meta", torch.Generator())
    d3pm = models.generator.diffusion
    assert (d3pm.content_seq_len, d3pm.num_classes) == (2304, 4097)
    clip = models.generator.conditioner.clip
    assert (clip.layers, clip.text_projection.shape[1]) == (12, 512)
