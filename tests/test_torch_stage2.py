"""The PyTorch port's stage-2 training step vs the JAX package's pieces (CPU).

JAX side: ``preprocess_clip`` -> flax ``VQVAE.encode`` (the codebook's plain
route on the CPU) -> the label conditioner -> ``d3pm.train_loss`` over the
flax denoiser with einsum attention -> ``weighted_losses``, under
``jax.value_and_grad`` (what ``train/stage2.py: _train_step`` runs), then
``update_diffusion_telemetry``. The port runs ``train/stage2.train_step`` on
the same weights (carried over by ``convert/from_flax.py``) with the JAX
draws handed in. Adam is checked apart: the same gradients through
``torch.optim.Adam`` and ``optax.adam``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.data.preprocess import (
    preprocess_clip as jax_preprocess_clip)
from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu.models.discrete_diffusion \
    import D3PM as JaxD3PM
from gif_synthesis_with_discrete_diffusion_tpu.models.discrete_diffusion \
    import DiscreteDiffusionModel as JaxModel
from gif_synthesis_with_discrete_diffusion_tpu.models.vqvae import (
    VQVAE as JaxVQVAE)
from gif_synthesis_with_discrete_diffusion_tpu.train.metrics import (
    weighted_losses as jax_weighted_losses)
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict, vqvae_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models.discrete_diffusion \
    import D3PM, make_discrete_diffusion
from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage2
from gif_synthesis_with_discrete_diffusion_tpu_torch.train.metrics import (
    weighted_losses)
from gif_synthesis_with_discrete_diffusion_tpu.models.denoiser import (
    DenoiserTransformer as JaxDenoiser)
from tests.test_torch_slice import CONFIG, LATENT, T, _denoiser, _flax_weights

B, L, K = 4, 32, 17
# the loss: f32 in two frameworks; the gradients: against each tensor's
# max-abs (the attention and the (B, K, L) posterior reduce in other orders)
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-4
BUF_TOL = 1e-6
_BUFFERS = ("lt_history", "lt_count", "diffusion_acc", "diffusion_keep")


def _jax_step(gen, gparams, ae, avars, video, labels, lt, key,
              den=None, fused=False):
    """value_and_grad of the JAX stage-2 loss and the new buffers."""
    sched = jd3pm.make_schedule(T, K)
    den = den or _denoiser()
    x = jax_preprocess_clip(jnp.asarray(video), CONFIG["vqvae"]["resolution"])
    flat = ae.apply(avars, x, method=JaxVQVAE.encode).reshape(B, -1)
    batch = {"label": jnp.asarray(labels)}

    def loss_fn(params):
        cond, _ = gen.apply({"params": params}, batch, B,
                            method=JaxModel.conditioner_embeddings)
        tparams = params["diffusion"]["transformer"]
        vb, aux, new_lt = jd3pm.train_loss(
            key, sched, lambda x, c, t: den.apply(
                {"params": tparams}, x, c, t, deterministic=False,
                fused_attention=fused),
            flat, cond, lt, auxiliary_loss_weight=5e-4,
            adaptive_auxiliary_loss=True)
        total, _ = jax_weighted_losses({"l_dummy": 1.0},
                                       {"losses": jnp.sum(vb) / (B * L)})
        return total, (aux, new_lt)

    (total, (aux, new_lt)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(gparams)
    zeros = jnp.zeros((T,), jnp.float32)
    acc, keep = jd3pm.update_diffusion_telemetry(
        zeros, zeros, aux["t"], aux["x0_recon"], flat, aux["xt"],
        aux["xt_1_recon"])
    return float(total), grads, new_lt, acc, keep


def _port_state(gparams, avars, hist, count, config=CONFIG):
    state = stage2.build_stage2(config, "cpu",
                                torch.Generator().manual_seed(0))
    buffers = {"diffusion": {"lt_history": hist, "lt_count": count,
                             "diffusion_acc": np.zeros(T, np.float32),
                             "diffusion_keep": np.zeros(T, np.float32)}}
    state.generator.load_state_dict(flax_to_state_dict(gparams,
                                                       buffers=buffers))
    state.vqvae.load_state_dict(vqvae_state_dict(
        avars["params"], avars["batch_stats"], avars["codebook"]))
    return state


def test_train_step_matches_jax_loss_grads_and_buffers():
    rng = np.random.default_rng(0)
    labels = np.array([0, 3, 4, 1], np.int32)
    gen, gparams, ae, avars = _flax_weights(rng, jnp.asarray(labels[:3]))
    video = rng.integers(0, 256, (B, 2, 8, 8, 3)).astype(np.uint8)
    # importance sampling on, with three favoured timesteps (t = 0 shares
    # t = 1's weight and takes the decoder-NLL branch): the draws repeat one
    hist = np.full((T,), 1e-4, np.float32)
    hist[[1, 5]] = 50.0
    count = np.full((T,), 11.0, np.float32)
    lt = jd3pm.LtState(history=jnp.asarray(hist), count=jnp.asarray(count))
    key = jax.random.key(3)
    t_rng, q_rng = jax.random.split(key)            # as train_loss splits
    t, pt = jd3pm.sample_time(t_rng, lt, B, T)
    noise = jax.random.uniform(q_rng, (B, K, L), jnp.float32)
    assert len(set(np.asarray(t).tolist())) < B and 0 in np.asarray(t)
    want_total, grads, want_lt, want_acc, want_keep = _jax_step(
        gen, gparams, ae, avars, video, labels, lt, key)

    state = _port_state(gparams, avars, hist, count)
    frozen = {k: v.clone() for k, v in state.vqvae.state_dict().items()}
    values = stage2.train_step(
        state, {"video": torch.from_numpy(video),
                "label": torch.from_numpy(labels)},
        t=torch.from_numpy(np.array(t)), pt=torch.from_numpy(np.array(pt)),
        noise=torch.from_numpy(np.array(noise)))
    assert state.step == 1
    np.testing.assert_allclose(float(values["total"]), want_total,
                               rtol=LOSS_RTOL)
    assert float(values["l_dummy"]) == float(values["total"])

    params = dict(state.generator.named_parameters())
    want_grads = flax_to_state_dict(jax.device_get(grads))
    assert set(want_grads) == set(params)
    # a key bias's gradient is zero analytically (a shift of every key
    # cancels in the softmax), so its max-abs is rounding noise: each
    # tensor's scale is floored at 1e-4 of the largest gradient
    floor = 1e-4 * max(float(w.abs().max()) for w in want_grads.values())
    for name, want in want_grads.items():
        got = params[name].grad
        got = torch.zeros_like(want) if got is None else got
        scale = max(float(want.abs().max()), floor)
        torch.testing.assert_close(got, want, rtol=0, atol=GRAD_TOL * scale,
                                   msg=name)

    for name, tensor in state.vqvae.state_dict().items():
        assert torch.equal(tensor, frozen[name]), name
    d = state.generator.diffusion
    for got, want in ((d.lt_history, want_lt.history),
                      (d.lt_count, want_lt.count),
                      (d.diffusion_acc, want_acc),
                      (d.diffusion_keep, want_keep)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=BUF_TOL, atol=BUF_TOL)


def test_adam_update_matches_optax():
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 10 ** -i
              for k, s in shapes.items()} for i in range(3)]
    tx = optax.adam(1e-4, b1=0.5, b2=0.999)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.Adam(tp.values(), lr=1e-4, betas=(0.5, 0.999),
                           eps=1e-8)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6)


def test_eval_step_changes_nothing_and_steps_draw_their_own_noise():
    state = stage2.build_stage2(CONFIG, "cpu",
                                torch.Generator().manual_seed(1))
    batch = stage2.synthetic_batch(CONFIG, 3,
                                   torch.Generator().manual_seed(2))
    assert tuple(batch["video"].shape) == (3, 2, 8, 8, 3)
    before = {k: v.clone() for k, v in state.generator.state_dict().items()}
    values = stage2.eval_step(state, batch, torch.Generator().manual_seed(3))
    assert set(values) == {"l_dummy", "total", "diffusion_acc",
                           "diffusion_keep"}
    assert all(bool(torch.isfinite(v)) for v in values.values())
    for k, v in state.generator.state_dict().items():
        assert torch.equal(v, before[k]), k
    g = torch.Generator().manual_seed(4)
    for _ in range(2):
        values = stage2.train_step(state, batch, g)
        assert bool(torch.isfinite(values["total"]))
    assert float(state.generator.diffusion.lt_count.sum()) == 6.0
    assert not torch.equal(
        state.generator.diffusion.transformer.to_logits.weight,
        before["diffusion.transformer.to_logits.weight"])


def test_learnable_cf_matches_flax():
    rng = np.random.default_rng(5)
    flax_d3pm = JaxD3PM(num_embed=16, content_seq_len=32, spatial_size=(8, 4),
                        diffusion_step=T, learnable_cf=True, n_layer=1,
                        condition_seq_len=3, condition_dim=8)
    variables = jax.device_get(flax_d3pm.init(
        jax.random.key(0), 2, 3, method=JaxD3PM.empty_cond_embed))
    params = variables["params"]
    params["empty_text_embed"] = rng.standard_normal((3, 8)).astype(
        np.float32)
    cond = rng.standard_normal((4, 3, 8)).astype(np.float32)
    mask = np.array([True, False, True, False])
    want = flax_d3pm.apply(variables, jnp.asarray(cond),
                           jnp.asarray(mask),
                           method=JaxD3PM.apply_learnable_cf)
    model = D3PM(num_embed=16, content_seq_len=32, spatial_size=(8, 4),
                 diffusion_step=T, learnable_cf=True, n_layer=1,
                 condition_seq_len=3, condition_dim=8)
    with torch.no_grad():
        model.empty_text_embed.copy_(torch.from_numpy(
            params["empty_text_embed"]))
        got = model.apply_learnable_cf(torch.from_numpy(cond),
                                       torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert model.apply_learnable_cf(None, torch.from_numpy(mask)) is None


def test_make_discrete_diffusion_training_keys():
    cfg = {"generator": {
        "diffusion_model": {"diffusion_step": T, "learnable_cf": True,
                            "auxiliary_loss_weight": 1e-3,
                            "adaptive_auxiliary_loss": False,
                            "mask_weight": [1.0, 0.5],
                            "transformer": {"n_layer": 1, "n_embd": 64,
                                            "n_head": 16, "condition_dim": 32,
                                            "condition_seq_len": 5}},
        "textencoder": {"mode": "label", "n_classes": 5, "dim": 32}}}
    with torch.device("meta"):
        model = make_discrete_diffusion(cfg, 16, LATENT)
    d = model.diffusion
    assert (d.auxiliary_loss_weight, d.adaptive_auxiliary_loss,
            d.mask_weight) == (1e-3, False, (1.0, 0.5))
    assert tuple(d.empty_text_embed.shape) == (5, 32)
    assert set(_BUFFERS) <= set(dict(d.named_buffers()))
    # bf16 compute builds (the dtype names of the JAX package's rule; any
    # other name is f32 there too); dropout and checkpointing still raise
    for name, want in (("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
                       ("float32", torch.float32)):
        cfg = {"generator": {"diffusion_model": {"transformer": {
            "dtype": name, "n_layer": 1}}}}
        with torch.device("meta"):
            built = make_discrete_diffusion(cfg, 16, LATENT)
        tr = built.diffusion.transformer
        assert tr.compute_dtype == want, name
        assert tr.block0.attn1.query.compute_dtype == want
        assert tr.to_logits.weight.dtype == torch.float32
    for key, value in (("attn_pdrop", 0.1), ("checkpoint", True)):
        bad = {"generator": {"diffusion_model": {"transformer": {
            key: value}}}}
        with pytest.raises(NotImplementedError):
            make_discrete_diffusion(bad, 16, LATENT)


def test_weighted_losses_match():
    losses = np.array([1.0, 3.0, 0.5], np.float32)
    loss_dict = {"l_dummy": 2.0, "total": 9.0}
    total, values = weighted_losses(loss_dict,
                                    {"losses": torch.from_numpy(losses)})
    want_total, want = jax_weighted_losses(loss_dict,
                                           {"losses": jnp.asarray(losses)})
    assert set(values) == set(want) == {"l_dummy", "total"}
    assert float(total) == float(values["total"]) == float(want_total)
    assert float(values["l_dummy"]) == float(want["l_dummy"])


def test_forward_returns_the_keys_of_the_jax_call():
    """``D3PM.forward`` returns every key of the JAX ``D3PM.__call__``, the
    posterior's probabilities under ``logits`` among them, beside their
    logarithm ``log_model_prob``."""
    import inspect
    import re
    src = inspect.getsource(JaxD3PM.__call__)
    jax_keys = set(re.findall(r'"(\w+)":', src[src.rindex("return {"):]))
    assert "logits" in jax_keys
    state = stage2.build_stage2(CONFIG, "cpu",
                                torch.Generator().manual_seed(0))
    tokens = torch.randint(0, K - 1, (B, L),
                           generator=torch.Generator().manual_seed(1))
    out = state.generator({"label": torch.tensor([0, 3, 4, 1])}, tokens,
                          generator=torch.Generator().manual_seed(2),
                          train=False)
    assert jax_keys <= set(out)
    assert out["logits"].shape == (B, K, L)
    torch.testing.assert_close(out["logits"], out["log_model_prob"].exp(),
                               rtol=0, atol=0)
    assert out["log_model_prob"].grad_fn is not None
    assert out["logits"].grad_fn is None   # no graph node keeps it


def test_text_conditioning_points_at_its_roadmap_item():
    """Text conditioning, ROADMAP item [12], is ported: the text mode builds
    the frozen CLIP conditioner and drops the trainer's keys, as the JAX
    ``build_conditioner`` does."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.clip_text \
        import ClipTextConditioner
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.conditioning \
        import build_conditioner
    cond = build_conditioner({"mode": "text", "dim": 32, "width": 16,
                              "heads": 2, "layers": 1, "bpe_path": None,
                              "allow_hash_tokenizer": True,
                              "clip_ckpt": None})
    assert isinstance(cond, ClipTextConditioner)
    assert cond.clip.text_projection.shape == (16, 32)
    with pytest.raises(TypeError):
        build_conditioner({"mode": "text", "dim": 32, "n_classes": 3})


# the bf16 step against the JAX bf16 step: the bound of
# tests/test_torch_denoiser.py (one fifth of the 0.05 bf16-vs-f32 drift that
# tests/test_denoiser.py allows), on the loss relative to its size and on
# each gradient relative to the largest gradient (measured: the loss 2.8e-5
# of its size, the gradients 0.0015 of the largest)
BF16_TOL = 0.05 / 5


def test_bf16_train_step_matches_jax_bf16_loss_and_grads(monkeypatch):
    """``transformer.dtype: bfloat16`` (the bench's setting) through the
    whole step: the JAX side with the Pallas attention in interpret mode,
    whose f32-inside arithmetic the port's bf16 plain versions share."""
    import functools

    from gif_synthesis_with_discrete_diffusion_tpu.models import (
        denoiser as jden)
    from gif_synthesis_with_discrete_diffusion_tpu.ops.attention import (
        fused_mha as jax_fused_mha)

    monkeypatch.setattr(jden, "fused_mha",
                        functools.partial(jax_fused_mha, interpret=True))
    rng = np.random.default_rng(0)
    labels = np.array([0, 3, 4, 1], np.int32)
    gen, gparams, ae, avars = _flax_weights(rng, jnp.asarray(labels[:3]))
    video = rng.integers(0, 256, (B, 2, 8, 8, 3)).astype(np.uint8)
    hist = np.full((T,), 1e-4, np.float32)
    hist[[1, 5]] = 50.0
    count = np.full((T,), 11.0, np.float32)
    lt = jd3pm.LtState(history=jnp.asarray(hist), count=jnp.asarray(count))
    key = jax.random.key(3)
    t_rng, q_rng = jax.random.split(key)
    t, pt = jd3pm.sample_time(t_rng, lt, B, T)
    noise = jax.random.uniform(q_rng, (B, K, L), jnp.float32)
    den = JaxDenoiser(num_embed=16, spatial_size=(8, 4), n_layer=2,
                      n_embd=64, n_head=16, content_seq_len=32,
                      condition_dim=32, diffusion_step=T,
                      dtype=jnp.bfloat16)
    want_total, grads, _, _, _ = _jax_step(
        gen, gparams, ae, avars, video, labels, lt, key, den=den,
        fused=True)

    config = copy.deepcopy(CONFIG)
    config["generator"]["diffusion_model"]["transformer"]["dtype"] = \
        "bfloat16"
    state = _port_state(gparams, avars, hist, count, config)
    assert state.generator.diffusion.transformer.compute_dtype == \
        torch.bfloat16
    values = stage2.train_step(
        state, {"video": torch.from_numpy(video),
                "label": torch.from_numpy(labels)},
        t=torch.from_numpy(np.array(t)), pt=torch.from_numpy(np.array(pt)),
        noise=torch.from_numpy(np.array(noise)))
    assert values["total"].dtype == torch.float32
    assert abs(float(values["total"]) - want_total) <= \
        BF16_TOL * abs(want_total)
    params = dict(state.generator.named_parameters())
    want_grads = flax_to_state_dict(jax.device_get(grads))
    scale = max(float(w.abs().max()) for w in want_grads.values())
    for name, want in want_grads.items():
        got = params[name].grad
        assert got is not None and got.dtype == torch.float32, name
        err = float((got - want).abs().max())
        assert err <= BF16_TOL * scale, (name, err / scale)
