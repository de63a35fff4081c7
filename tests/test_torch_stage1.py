"""The PyTorch port's stage-1 (VQ-VAE) training step vs the JAX package (CPU).

JAX side: ``train/stage1.py: _train_step`` (``preprocess_clip`` -> flax
``VQVAE.__call__`` with ``train=True`` and the codebook's plain lookup ->
``weighted_losses`` -> ``optax.adam``), jitted, and ``jax.grad`` of the same
loss for the gradients. The port runs ``train/stage1.train_step`` on the
same weights (carried over by ``convert/from_flax.py``) and the same uint8
clips, with the candidate rows the JAX codebook drew handed in as
``init_rows`` / ``restart_rows``. The state after the step (running
statistics, codebook) goes through the same bridge, so no reverse map is
needed. Adam is checked apart, as ``tests/test_torch_stage2.py`` does: the
same gradients through ``torch.optim.Adam`` and ``optax.adam``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.data import (
    synthetic as jax_synthetic)
from gif_synthesis_with_discrete_diffusion_tpu.data.preprocess import (
    preprocess_clip as jax_preprocess_clip)
from gif_synthesis_with_discrete_diffusion_tpu.train import (
    stage1 as jax_stage1)
from gif_synthesis_with_discrete_diffusion_tpu.train.metrics import (
    weighted_losses as jax_weighted_losses)
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict, vqvae_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.data import synthetic
from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage1
from gif_synthesis_with_discrete_diffusion_tpu_torch.train.metrics import (
    weighted_losses)
from tests.test_torch_vqvae import _flax_vqvae

KW = dict(embedding_dim=16, n_codes=32, n_hiddens=32, n_res_layers=1,
          downsample=(1, 2, 2), sequence_length=4, resolution=8)
CONFIG = {"generator": dict(KW, kernel_mode="xla"),
          "losses": {"loss_dict": {"l_dummy": 1.0, "l_codebook": 0.0,
                                   "l_entropy": 0.0, "l_perplexity": 0.0}},
          "lr_args": {"gen_lr": 4e-4}}
B = 4
# the loss: f32 in two frameworks; the gradients: against each tensor's
# max-abs (BatchNorm's batch statistics and the convs reduce in other
# orders); running statistics and codebook buffers: elementwise
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-4
STATE_TOL = 1e-5
LR = 4e-4


def _variables(rng, initialised):
    """A flax VQVAE with redrawn variables; ``initialised``: a codebook
    past its first step, with counts around 1 so that some codes restart."""
    model, variables = _flax_vqvae(rng, **KW)
    cb = dict(variables["codebook"]["codebook"])
    if initialised:
        count = (0.4 + 2.0 * rng.random(KW["n_codes"])).astype(np.float32)
        cb.update(ema_count=count,
                  ema_sum=cb["embeddings"] * count[:, None],
                  initialized=np.ones((), np.bool_))
    else:
        cb.update(initialized=np.zeros((), np.bool_))
    variables["codebook"] = {"codebook": cb}
    return model, variables


def _jax_rows(model, variables, video, key):
    """The candidate rows the JAX codebook draws inside the step."""
    def rows(m, x):
        z = m.pre_vq_conv(m.encoder(x, train=True))
        flat = z.reshape(-1, z.shape[-1]).astype(jnp.float32)
        rng = m.codebook.make_rng("codebook")
        return (m.codebook._tile_rows(flat, jax.random.fold_in(rng, 0)),
                m.codebook._tile_rows(flat, jax.random.fold_in(rng, 2)))

    out, _ = model.apply(variables, video, method=rows,
                         rngs={"codebook": key}, mutable=["batch_stats"])
    return tuple(torch.from_numpy(np.array(r)) for r in out)


def _port_state(variables):
    state = stage1.build_stage1(CONFIG, "cpu",
                                torch.Generator().manual_seed(0))
    state.vqvae.load_state_dict(vqvae_state_dict(
        variables["params"], variables["batch_stats"],
        variables["codebook"]))
    return state


@pytest.mark.parametrize("initialised", [False, True],
                         ids=["first step", "later step"])
def test_train_step_matches_jax_loss_grads_and_state(initialised):
    rng = np.random.default_rng(int(initialised))
    model, variables = _variables(rng, initialised)
    video_u8 = rng.integers(0, 256, (B, 4, 8, 8, 3)).astype(np.uint8)
    if not initialised:
        # the same clip four times: init rows drawn from equal rows coincide,
        # only the first of them is ever the nearest, the others restart
        video_u8[1:] = video_u8[0]
    key = jax.random.key(7)
    loss_dict = CONFIG["losses"]["loss_dict"]
    tx = optax.adam(LR, b1=0.5, b2=0.999)
    jstate = jax_stage1.VQVAEState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], codebook=variables["codebook"],
        opt_state=tx.init(variables["params"]))
    new_state, want = jax.jit(functools.partial(
        jax_stage1._train_step, model=model, tx=tx, loss_dict=loss_dict,
        resolution=KW["resolution"]))(jstate, {"video": video_u8}, key)
    video = jax_preprocess_clip(jnp.asarray(video_u8), KW["resolution"])

    def loss_fn(params):
        out, _ = jax_stage1._forward(model, params, variables["batch_stats"],
                                     variables["codebook"], video, key, True)
        return jax_weighted_losses(loss_dict, out)[0]

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    init_rows, restart_rows = _jax_rows(model, variables, video, key)

    state = _port_state(variables)
    old = {n: p.detach().clone() for n, p in state.vqvae.named_parameters()}
    values = stage1.train_step(state, {"video": video_u8},
                               init_rows=init_rows, restart_rows=restart_rows)
    assert state.step == 1 and set(values) == set(want)
    for name in want:
        np.testing.assert_allclose(float(values[name]), float(want[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    assert float(values["l_dummy"]) == float(values["total"])

    params = dict(state.vqvae.named_parameters())
    want_grads = flax_to_state_dict(jax.device_get(grads))
    assert set(want_grads) == set(params)
    # a bias in front of a training-mode BatchNorm (the attentions' output
    # biases, post_vq_conv's, the reconstruction's share of pre_vq_conv's)
    # has a zero gradient analytically: what comes back is the rounding
    # noise of cancelling sums of terms as large as the largest gradient,
    # so each tensor's scale is floored at 1e-2 of that
    floor = 1e-2 * max(float(w.abs().max()) for w in want_grads.values())
    for name, w in want_grads.items():
        scale = max(float(w.abs().max()), floor)
        torch.testing.assert_close(params[name].grad, w, rtol=0,
                                   atol=GRAD_TOL * scale, msg=name)

    # the state after the step, through the same bridge
    after = vqvae_state_dict(*(jax.device_get(t) for t in (
        new_state.params, new_state.batch_stats, new_state.codebook)))
    buffers = dict(state.vqvae.named_buffers())
    assert bool(buffers["codebook.initialized"]) and \
        bool(after["codebook.initialized"])
    restarted = after["codebook.ema_count"] < 1.0
    assert 0 < int(restarted.sum()) < KW["n_codes"]
    torch.testing.assert_close(buffers["codebook.embeddings"][restarted],
                               restart_rows[restarted], rtol=0, atol=1e-6)
    for name, got in buffers.items():
        if got.dtype != torch.bool:
            torch.testing.assert_close(got, after[name], rtol=STATE_TOL,
                                       atol=STATE_TOL, msg=name)
    # Adam's first step moves every weight by about lr against its
    # gradient's sign, whatever the gradient's size: where a gradient is
    # rounding noise the sign may differ, so the new weights are held to
    # 2.5 lr here and the update itself in the test below
    for name, p in params.items():
        assert float((p.detach() - after[name]).abs().max()) <= 2.5 * LR
        moved = (p.detach() - old[name]).abs().max()
        assert 0.0 < float(moved) <= 1.01 * LR, name


def test_adam_update_matches_optax_at_stage1_settings():
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tx = optax.adam(LR, b1=0.5, b2=0.999)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.Adam(tp.values(), lr=LR, betas=(0.5, 0.999), eps=1e-8)
    for i in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) * 10.0 ** -i
             for k, s in shapes.items()}
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


@pytest.mark.parametrize("train", [False, True])
def test_vqvae_forward_matches_flax(train):
    rng = np.random.default_rng(2)
    model, variables = _variables(rng, initialised=True)
    x = rng.standard_normal((B, 4, 8, 8, 3)).astype(np.float32)
    key = jax.random.key(3)
    if train:
        want, _ = model.apply(variables, {"video": jnp.asarray(x)},
                              train=True, rngs={"codebook": key},
                              mutable=["batch_stats", "codebook"])
        rows = _jax_rows(model, variables, jnp.asarray(x), key)
        kw = dict(init_rows=rows[0], restart_rows=rows[1])
    else:
        want = model.apply(variables, {"video": jnp.asarray(x)}, train=False)
        kw = {}
    vqvae = _port_state(variables).vqvae
    got = vqvae({"video": torch.from_numpy(x)}, train=train, **kw)
    assert set(got) == set(want) == {
        "pred_data", "gt_data", "losses", "metrics", "codebook_loss",
        "entropy", "encodings"}
    np.testing.assert_array_equal(got["encodings"].numpy(),
                                  np.asarray(want["encodings"]))
    assert tuple(got["pred_data"].shape) == (B, 4, 8, 8, 3)
    assert got["gt_data"] is not None and got["pred_data"].requires_grad
    for g, w, name in (
            (got["pred_data"], want["pred_data"], "pred_data"),
            (got["losses"]["recon_loss"], want["losses"]["recon_loss"],
             "recon"),
            (got["losses"]["commitment_loss"],
             want["losses"]["commitment_loss"], "commitment"),
            (got["metrics"]["perplexity"], want["metrics"]["perplexity"],
             "perplexity"),
            (got["codebook_loss"], want["codebook_loss"], "codebook_loss"),
            (got["entropy"], want["entropy"], "entropy")):
        # f32 convs in two frameworks (tests/test_torch_vqvae.py: 2e-4). In
        # training mode the clip passes five BatchNorms on batch
        # statistics, whose variance mean(x^2) - mean(x)^2 cancels in f32:
        # the two frameworks' rounding noise is divided by a small batch
        # standard deviation, so single pixels move by up to ~1e-3
        tol = 2e-3 if train and name == "pred_data" else 2e-4
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=tol, atol=tol, err_msg=name)


def test_eval_step_matches_jax_and_changes_no_buffer():
    rng = np.random.default_rng(4)
    model, variables = _variables(rng, initialised=True)
    video_u8 = rng.integers(0, 256, (B, 4, 8, 8, 3)).astype(np.uint8)
    loss_dict = CONFIG["losses"]["loss_dict"]
    jstate = jax_stage1.VQVAEState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], codebook=variables["codebook"],
        opt_state=None)
    want = jax_stage1._eval_step(jstate, {"video": video_u8},
                                 jax.random.key(0), model=model,
                                 loss_dict=loss_dict,
                                 resolution=KW["resolution"])
    state = _port_state(variables)
    before = {k: v.clone() for k, v in state.vqvae.state_dict().items()}
    values = stage1.eval_step(state, {"video": torch.from_numpy(video_u8)})
    assert set(values) == set(want) == {"l_dummy", "l_codebook", "l_entropy",
                                        "l_perplexity", "total"}
    for name in want:
        np.testing.assert_allclose(float(values[name]), float(want[name]),
                                   rtol=1e-4, err_msg=name)
    assert state.step == 0
    for k, v in state.vqvae.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_loss_falls_on_the_synthetic_clips():
    config = {"generator": KW, "lr_args": {"gen_lr": 4e-4}}
    state = stage1.build_stage1(config, "cpu",
                                torch.Generator().manual_seed(0))
    batch = stage1.synthetic_batch(config, 4)
    assert batch["video"].dtype == np.uint8
    assert batch["video"].shape == (4, 4, 8, 8, 3)
    g = torch.Generator().manual_seed(1)
    assert not bool(state.vqvae.codebook.initialized)
    losses = [float(stage1.train_step(state, batch, g)["total"])
              for _ in range(8)]
    assert bool(state.vqvae.codebook.initialized) and state.step == 8
    assert all(np.isfinite(losses)) and losses[-1] < 0.9 * losses[0]
    # the generator decides the draws: the same seed, the same run
    again = stage1.build_stage1(config, "cpu",
                                torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    assert [float(stage1.train_step(again, batch, g)["total"])
            for _ in range(2)] == losses[:2]


def test_build_stage1_configuration():
    assert stage1.TRAIN_STEP1_BATCH == 64
    with torch.device("meta"):
        model = stage1.make_vqvae(stage1.TRAIN_STEP1)
        default = stage1.make_vqvae({})
    ref = jax_stage1.make_vqvae(stage1.TRAIN_STEP1)       # bench.py:356-363
    for name in ("embedding_dim", "n_codes", "n_hiddens", "n_res_layers",
                 "downsample", "sequence_length", "resolution"):
        want = getattr(ref, name)
        got = (getattr(model, name) if hasattr(model, name)
               else {"embedding_dim": model.codebook.embedding_dim,
                     "n_hiddens": model.pre_vq_conv.weight.shape[1],
                     "n_res_layers": model.encoder.n_res_layers}[name])
        assert got == want, name
    assert model.latent_shape == (4, 8, 8) == ref.latent_shape
    jdefault = jax_stage1.make_vqvae({})
    assert (default.downsample, default.resolution, default.n_codes) == (
        tuple(jdefault.downsample), jdefault.resolution, jdefault.n_codes)
    state = stage1.build_stage1(
        {"generator": KW, "lr_args": {"gen_lr": 1e-3},
         "losses": {"loss_dict": {"l_dummy": 2.0}}}, "cpu",
        torch.Generator().manual_seed(0))
    group = state.optimizer.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (
        1e-3, (0.5, 0.999), 1e-8)
    assert state.loss_dict == {"l_dummy": 2.0} and state.resolution == 8
    assert state.device.type == "cpu"
    # bf16 conv compute builds on f32 parameters (TRAIN_STEP128's setting)
    for dtype in ("bfloat16", "bf16"):
        state = stage1.build_stage1({"generator": dict(KW, dtype=dtype)},
                                    "cpu", torch.Generator().manual_seed(0))
        vq = state.vqvae
        assert vq.compute_dtype == vq.encoder.conv0.compute_dtype == \
            vq.decoder.convt0.compute_dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in vq.parameters())
    ref128 = jax_stage1.make_vqvae(stage1.TRAIN_STEP128)   # bench.py:350-363
    assert ref128.dtype == jnp.bfloat16 and ref128.resolution == 128
    with torch.device("meta"):
        model128 = stage1.make_vqvae(stage1.TRAIN_STEP128)
    assert model128.compute_dtype == torch.bfloat16
    assert model128.latent_shape == tuple(ref128.latent_shape) == (4, 16, 16)
    assert stage1.TRAIN_STEP128_BATCH == 64


def test_synthetic_copy_yields_the_jax_packages_clips():
    kw = dict(batch_size=3, sequence_length=4, resolution=16, num_train=6,
              num_val=3, seed=5, frame_dim=7)
    ours = synthetic.SyntheticVideoDataModule(**kw)
    theirs = jax_synthetic.SyntheticVideoDataModule(**kw)
    assert ours.nclasses == theirs.nclasses and \
        ours.steps_per_epoch() == theirs.steps_per_epoch() == 2
    for split in ("train_batches", "val_batches", "test_batches"):
        a, b = list(getattr(ours, split)(1)), list(getattr(theirs, split)(1))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert set(x) == set(y)
            for key in x:
                if key == "text":
                    assert x[key] == y[key]
                else:
                    np.testing.assert_array_equal(x[key], y[key])


def test_vqvae_registry_entries_match():
    rng = np.random.default_rng(6)
    vals = {k: np.float32(abs(rng.standard_normal()) + 0.1)
            for k in ("recon", "commit", "cb", "ent", "perp")}

    def output(wrap):
        return {"losses": {"recon_loss": wrap(vals["recon"]),
                           "commitment_loss": wrap(vals["commit"])},
                "metrics": {"perplexity": wrap(vals["perp"])},
                "codebook_loss": wrap(vals["cb"]), "entropy": wrap(vals["ent"])}

    loss_dict = {"l_dummy": 1.0, "l_codebook": 0.5, "l_entropy": 0.25,
                 "l_perplexity": 0.0, "total": 3.0}
    total, values = weighted_losses(loss_dict, output(torch.tensor))
    want_total, want = jax_weighted_losses(loss_dict, output(jnp.asarray))
    assert set(values) == set(want)
    for name in want:
        np.testing.assert_allclose(float(values[name]), float(want[name]),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)


def test_make_vqvae_honours_kernel_mode(monkeypatch):
    """``kernel_mode: xla`` keeps the codebook on its plain lookup (the JAX
    Codebook's ``_lookup``); ``auto`` goes through the kernel's wrapper."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import vqvae
    calls = []
    real = vqvae.nearest_code_stats
    monkeypatch.setattr(vqvae, "nearest_code_stats",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(5, KW["embedding_dim"])
    for mode, n_calls in (("xla", 0), ("auto", 1)):
        model = stage1.make_vqvae(dict(KW, kernel_mode=mode))
        assert model.codebook.kernel_mode == mode
        model.codebook.embeddings.normal_()
        calls.clear()
        z = x.reshape(1, 5, 1, 1, -1)
        model.codebook(z)
        assert len(calls) == n_calls, mode
    with pytest.raises(ValueError, match="kernel_mode"):
        stage1.make_vqvae(dict(KW, kernel_mode="tpu"))


# bf16 compute against the JAX bf16 VQ-VAE (the size of
# tests/test_vqvae.py::test_vqvae_bf16_train_grad): both convolve bf16
# operands with f32 sums and round the output once, so a reconstruction
# may land one bf16 step apart (measured: bitwise equal); the losses and
# the new buffers are f32 reductions of those (measured: 2.2e-7)
BF16_KW = dict(embedding_dim=16, n_codes=32, n_hiddens=16, n_res_layers=2,
               downsample=(1, 4, 4), sequence_length=2, resolution=16)
BF16_STATE_TOL = 1e-5


def test_bf16_vqvae_training_forward_matches_flax_bf16():
    """``dtype: bfloat16`` in training mode (BatchNorm on batch statistics,
    the codebook's init, EMA and restarts): the reconstruction, every loss
    and metric, the encodings and the buffers after the step, against the
    flax module at ``dtype=jnp.bfloat16``; then the port's gradients reach
    every f32 parameter. (The JAX bf16 gradient is the slow-marked
    ~45 s compile of tests/test_vqvae.py, so it is not compared here.)"""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
        bf16_step)
    rng = np.random.default_rng(4)
    model, variables = _flax_vqvae(rng, dtype=jnp.bfloat16, **BF16_KW)
    x = rng.standard_normal((2, 2, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(3)
    want, new_state = model.apply(
        variables, {"video": jnp.asarray(x)}, train=True,
        rngs={"codebook": key}, mutable=["batch_stats", "codebook"])
    rows = _jax_rows(model, variables, jnp.asarray(x), key)
    vqvae = stage1.make_vqvae(dict(BF16_KW, kernel_mode="xla",
                                   dtype="bfloat16"))
    vqvae.load_state_dict(vqvae_state_dict(
        variables["params"], variables["batch_stats"],
        variables["codebook"]))
    got = vqvae({"video": torch.from_numpy(x)}, train=True,
                init_rows=torch.from_numpy(np.asarray(rows[0])),
                restart_rows=torch.from_numpy(np.asarray(rows[1])))
    assert got["pred_data"].dtype == torch.bfloat16 == \
        got["losses"]["commitment_loss"].dtype
    assert got["losses"]["recon_loss"].dtype == torch.float32
    np.testing.assert_array_equal(got["encodings"].numpy(),
                                  np.asarray(want["encodings"]))
    pred = np.asarray(want["pred_data"]).astype(np.float32)
    step = bf16_step(float(np.abs(pred).max()))
    assert float(np.abs(got["pred_data"].detach().float().numpy()
                        - pred).max()) <= step
    for g, w in ((got["losses"]["recon_loss"], want["losses"]["recon_loss"]),
                 (got["losses"]["commitment_loss"],
                  want["losses"]["commitment_loss"]),
                 (got["metrics"]["perplexity"], want["metrics"]["perplexity"]),
                 (got["codebook_loss"], want["codebook_loss"]),
                 (got["entropy"], want["entropy"])):
        np.testing.assert_allclose(float(g.detach()), float(w),
                                   rtol=BF16_STATE_TOL)
    want_state = vqvae_state_dict(variables["params"],
                                  new_state["batch_stats"],
                                  new_state["codebook"])
    for name, buf in vqvae.named_buffers():
        if buf.dtype == torch.bool:
            assert torch.equal(buf, want_state[name]), name
            continue
        torch.testing.assert_close(buf, want_state[name], rtol=0,
                                   atol=BF16_STATE_TOL * max(float(
                                       want_state[name].abs().max()), 1.0),
                                   msg=name)
    total, _ = weighted_losses({"l_dummy": 1.0}, got)
    assert total.dtype == torch.float32
    total.backward()
    for name, p in vqvae.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert bool(p.grad.isfinite().all()), name
    assert any(float(p.grad.abs().max()) > 0 for p in vqvae.parameters())
