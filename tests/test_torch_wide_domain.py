"""WIDE_DOMAIN, the configuration that needs K1, K2, K5 and K6 past their
old domains, against the JAX package (CPU), and the bf16 denoiser at wide
heads against JAX's jitted bf16 step.

WIDE_DOMAIN (``chip_smoke.py``) is stage 1 at ``vqvae_ucf.sh``'s widths
over 16,384 codes of dim 512 and stage 2 at the honest configuration with
the denoiser at n_embd 512 in 2 heads of 256 (16,385 classes). Here it runs
at small depth (2 layers, 32 tokens) but at those heads, classes and
codebook: its stage-2 step (loss and gradients, the frozen encode over the
16,384 codes) and its model-route reverse steps against the flax modules,
with the Pallas sampler step in interpret mode. Last, the bf16 denoiser at
heads of 64 and of 256 against JAX's jitted bf16 step, within JAX's own
bf16-vs-f32 drift (tests/test_torch_stage1_bf16_grad.py's method).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gif_synthesis_with_discrete_diffusion_tpu.data.preprocess import (
    preprocess_clip as jax_preprocess_clip)
from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu.models import (
    denoiser as jden)
from gif_synthesis_with_discrete_diffusion_tpu.models.denoiser import (
    DenoiserTransformer as JaxDenoiser)
from gif_synthesis_with_discrete_diffusion_tpu.models.discrete_diffusion \
    import DiscreteDiffusionModel as JaxModel
from gif_synthesis_with_discrete_diffusion_tpu.models.discrete_diffusion \
    import make_discrete_diffusion as jax_make_discrete_diffusion
from gif_synthesis_with_discrete_diffusion_tpu.models.vqvae import (
    VQVAE as JaxVQVAE)
from gif_synthesis_with_discrete_diffusion_tpu.ops.attention import (
    fused_mha as jax_fused_mha)
from gif_synthesis_with_discrete_diffusion_tpu.ops.sampler_kernel import (
    fused_sample_step as jax_fused_sample_step, schedule_rows as jax_rows)
from gif_synthesis_with_discrete_diffusion_tpu.train.metrics import (
    weighted_losses as jax_weighted_losses)
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict, vqvae_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
    build_models, sample_token_grid)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
    denoiser as tden)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    attention as attn)
from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage2
from tests.test_torch_stage2 import GRAD_TOL, LOSS_RTOL


# ---------------------------------------------------------------------------
# WIDE_DOMAIN at small depth: heads of 256, 16385 classes, 16384 codes of
# dim 512
# ---------------------------------------------------------------------------
T, B, L, N_CODES, CODE_DIM = 4, 4, 32, 16384, 512
K = N_CODES + 1
LATENT = (2, 4, 4)
WIDE_CONFIG = {
    "vqvae": {"embedding_dim": CODE_DIM, "n_codes": N_CODES, "n_hiddens": 32,
              "n_res_layers": 1, "downsample": (1, 2, 2),
              "sequence_length": 2, "resolution": 8},
    "generator": {
        "diffusion_model": {
            "diffusion_step": T, "guidance_scale": 2.0,
            "transformer": {"n_layer": 2, "n_embd": 512, "n_head": 2,
                            "condition_dim": 32}},
        "textencoder": {"mode": "label", "n_classes": 5, "dim": 32}},
}


def _wide_denoiser():
    return JaxDenoiser(num_embed=N_CODES, spatial_size=(8, 4), n_layer=2,
                       n_embd=512, n_head=2, content_seq_len=L,
                       condition_dim=32, diffusion_step=T)


def _draw(rng, tree, scale):
    return jax.tree.map(lambda a: (scale * rng.standard_normal(
        a.shape)).astype(np.float32), jax.device_get(tree))


@functools.cache
def _wide_weights():
    """The flax generator (conditioner and denoiser) and VQ-VAE at
    WIDE_CONFIG, every weight redrawn from a seed: the generator's N(0,
    0.1^2) (tests/test_torch_slice.py's), the VQ-VAE's at 0.2, its codebook
    N(0, 1)."""
    rng = np.random.default_rng(17)
    labels = jnp.asarray([0, 3, 4], jnp.int32)
    gen = jax_make_discrete_diffusion(WIDE_CONFIG, N_CODES, LATENT)
    cparams = gen.init(jax.random.key(0), {"label": labels}, 3,
                       method=JaxModel.conditioner_embeddings)["params"]
    tparams = jax.jit(_wide_denoiser().init)(
        jax.random.key(1), jnp.zeros((3, L), jnp.int32),
        jnp.zeros((3, 1, 32)), jnp.zeros((3,), jnp.int32))["params"]
    gparams = _draw(rng, {"conditioner": cparams["conditioner"],
                          "diffusion": {"transformer": tparams}},
                    0.1)
    ae = JaxVQVAE(kernel_mode="xla", **WIDE_CONFIG["vqvae"])
    avars = jax.device_get(jax.jit(lambda r: ae.init(
        r, {"video": jnp.zeros((1, 2, 8, 8, 3))}, train=True))(
        {"params": jax.random.key(2), "codebook": jax.random.key(3)}))
    stats = _draw(rng, avars["batch_stats"], 0.3)
    for bn in jax.tree_util.tree_leaves(
            stats, is_leaf=lambda n: isinstance(n, dict) and "var" in n):
        bn["var"] = np.abs(bn["var"]) + 0.5
    codebook = {"codebook": dict(avars["codebook"]["codebook"], embeddings=(
        rng.standard_normal((N_CODES, CODE_DIM)).astype(np.float32)))}
    avars = {"params": _draw(rng, avars["params"], 0.2),
             "batch_stats": stats, "codebook": codebook}
    return gen, gparams, ae, avars


def test_wide_domain_stage2_step_matches_jax():
    """WIDE_DOMAIN's stage-2 step: the frozen encode over 16384 codes of dim
    512 (K6's shape), the denoiser in 2 heads of 256 (K2 / K5's) over
    16385 classes, with JAX's draws: the loss within LOSS_RTOL and every
    gradient within GRAD_TOL of its tensor's max-abs (floored at 1e-4 of
    the largest), as tests/test_torch_stage2.py holds the serving width."""
    gen, gparams, ae, avars = _wide_weights()
    rng = np.random.default_rng(5)
    labels = np.array([0, 3, 4, 1], np.int32)
    video = rng.integers(0, 256, (B, 2, 8, 8, 3)).astype(np.uint8)
    hist = np.full((T,), 1e-4, np.float32)
    hist[[1, 3]] = 50.0
    count = np.full((T,), 11.0, np.float32)
    lt = jd3pm.LtState(history=jnp.asarray(hist), count=jnp.asarray(count))
    key = jax.random.key(3)
    t_rng, q_rng = jax.random.split(key)            # as train_loss splits
    t, pt = jd3pm.sample_time(t_rng, lt, B, T)
    noise = jax.random.uniform(q_rng, (B, K, L), jnp.float32)

    sched = jd3pm.make_schedule(T, K)
    den = _wide_denoiser()
    x = jax_preprocess_clip(jnp.asarray(video),
                            WIDE_CONFIG["vqvae"]["resolution"])
    flat = ae.apply(avars, x, method=JaxVQVAE.encode).reshape(B, -1)
    batch = {"label": jnp.asarray(labels)}

    def loss_fn(params):
        cond, _ = gen.apply({"params": params}, batch, B,
                            method=JaxModel.conditioner_embeddings)
        tparams = params["diffusion"]["transformer"]
        vb, _, _ = jd3pm.train_loss(
            key, sched, lambda x, c, t: den.apply(
                {"params": tparams}, x, c, t, deterministic=False,
                fused_attention=False),
            flat, cond, lt, auxiliary_loss_weight=5e-4,
            adaptive_auxiliary_loss=True)
        total, _ = jax_weighted_losses({"l_dummy": 1.0},
                                       {"losses": jnp.sum(vb) / (B * L)})
        return total

    want_total, grads = jax.jit(jax.value_and_grad(loss_fn))(gparams)
    assert len(set(np.asarray(flat).ravel().tolist())) > 16

    state = stage2.build_stage2(WIDE_CONFIG, "cpu",
                                torch.Generator().manual_seed(0))
    buffers = {"diffusion": {"lt_history": hist, "lt_count": count,
                             "diffusion_acc": np.zeros(T, np.float32),
                             "diffusion_keep": np.zeros(T, np.float32)}}
    state.generator.load_state_dict(flax_to_state_dict(gparams,
                                                       buffers=buffers))
    state.vqvae.load_state_dict(vqvae_state_dict(
        avars["params"], avars["batch_stats"], avars["codebook"]))
    tr = state.generator.diffusion.transformer
    assert tr.block0.attn1.n_head == 2
    assert tr.to_logits.out_features == N_CODES
    values = stage2.train_step(
        state, {"video": torch.from_numpy(video),
                "label": torch.from_numpy(labels)},
        t=torch.from_numpy(np.array(t)), pt=torch.from_numpy(np.array(pt)),
        noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(float(values["total"]), float(want_total),
                               rtol=LOSS_RTOL)
    params = dict(state.generator.named_parameters())
    want_grads = flax_to_state_dict(jax.device_get(grads))
    assert set(want_grads) == set(params)
    floor = 1e-4 * max(float(w.abs().max()) for w in want_grads.values())
    for name, want in want_grads.items():
        got = params[name].grad
        got = torch.zeros_like(want) if got is None else got
        scale = max(float(want.abs().max()), floor)
        torch.testing.assert_close(got, want, rtol=0, atol=GRAD_TOL * scale,
                                   msg=name)


def test_wide_domain_reverse_steps_match_jax_in_argmax_mode():
    """WIDE_DOMAIN's model route: the label conditioner, T = 4 reverse
    steps with CFG 2 through the denoiser in heads of 256 and the sampler
    step over 16385 classes (K1's wide shape), in argmax mode, against the
    flax denoiser and the Pallas ``fused_sample_step`` in interpret mode:
    the same tokens, and no MASK left."""
    gen, gparams, ae, avars = _wide_weights()
    labels = np.array([0, 3, 4], np.int32)
    nb = len(labels)
    cond, cf = jax.jit(lambda p: gen.apply(
        {"params": p}, {"label": jnp.asarray(labels)}, nb,
        method=JaxModel.conditioner_embeddings))(gparams)
    cond2 = jnp.concatenate([cond, jnp.broadcast_to(cf, cond.shape)], 0)
    den = _wide_denoiser()
    denoise = jax.jit(lambda p, x, t: den.apply(
        {"params": p}, x, cond2, t, fused_attention=False))
    rows = jax_rows(jd3pm.make_schedule(T, K))
    tokens = jnp.full((nb, L), K - 1, jnp.int32)
    for t in range(T - 1, -1, -1):
        logits2 = denoise(gparams["diffusion"]["transformer"],
                          jnp.concatenate([tokens, tokens], 0),
                          jnp.full((2 * nb,), t, jnp.int32))
        tokens = jax_fused_sample_step(
            logits2, tokens, rows[t], jnp.int32(0), guidance=2.0,
            num_classes=K, sample=False, interpret=True)
    want = np.asarray(tokens.reshape(nb, *LATENT))

    models = build_models(WIDE_CONFIG, "cpu", torch.Generator().manual_seed(0))
    diffusion = {"diffusion": {name: np.zeros(T, np.float32) for name in (
        "lt_history", "lt_count", "diffusion_acc", "diffusion_keep")}}
    models.generator.load_state_dict(flax_to_state_dict(gparams,
                                                        buffers=diffusion))
    models.vqvae.load_state_dict(vqvae_state_dict(
        avars["params"], avars["batch_stats"], avars["codebook"]))
    got = sample_token_grid(models, {"label": torch.from_numpy(labels)},
                            torch.Generator().manual_seed(1), sample=False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got != K - 1).all()


# ---------------------------------------------------------------------------
# the bf16 denoiser at wide heads against JAX's jitted bf16 step
# ---------------------------------------------------------------------------
# the port's error, as a share of JAX's own bf16-vs-f32 drift on the same
# weights (tests/test_torch_stage1_bf16_grad.py's method)
DRIFT_SHARE = 1.0
DRIFT_WIDTHS = [(128, 2), (512, 2)]     # heads of 64 and of 256
D_L, D_EMBED, D_COND, D_STEPS = 16, 16, 24, 10


def _share(got: dict, want: dict, scale: float) -> tuple[float, str]:
    """The largest max error of a tensor over ``scale``, and its name."""
    return max((float((got[n] - w).abs().max()) / scale, n)
               for n, w in want.items())


@pytest.mark.parametrize("n_embd,n_head", DRIFT_WIDTHS)
def test_bf16_denoiser_within_jax_jitted_bf16_drift(monkeypatch, n_embd,
                                                    n_head):
    """The port's bf16 denoiser (2 layers, the flax init's own weights: the
    family's init scale, N(0, 0.02) linears) against JAX's bf16 step under
    ``jit`` (the Pallas attention in interpret mode, as the module's jit
    runs it), logits and every gradient of mean(y^2): the port's largest
    error over the largest JAX value, as a share of JAX's own bf16-vs-f32
    drift (the f32 step under ``jit`` on the same weights and inputs), at
    most DRIFT_SHARE for both. The port rounds to bf16 where the jitted
    step's compiled HLO rounds (``models/denoiser.py``: GELU2 op by op with
    1.702 in bf16, the AdaLN's 1 + scale and the bias add before a
    residual add in f32, the bias gradients summed in f32); rounding every
    op's output instead, the logits' share was 1.113 (heads of 64) and
    1.183 (heads of 256), the fault recorded as F11."""
    monkeypatch.setattr(jden, "fused_mha", functools.partial(
        jax_fused_mha, interpret=True))
    kw = dict(num_embed=D_EMBED, spatial_size=(4, 4), n_layer=2,
              n_embd=n_embd, n_head=n_head, condition_dim=D_COND,
              diffusion_step=D_STEPS)
    rng = np.random.default_rng(n_embd)
    tokens = rng.integers(0, D_EMBED + 1, (3, D_L)).astype(np.int32)
    cond = rng.standard_normal((3, 2, D_COND)).astype(np.float32)
    t = np.array([0, 4, D_STEPS - 1], np.int32)
    args = (jnp.asarray(tokens), jnp.asarray(cond), jnp.asarray(t))
    params = jax.device_get(jax.jit(jden.DenoiserTransformer(
        content_seq_len=D_L, **kw).init)(jax.random.key(0), *args)["params"])

    def step(dtype):
        model = jden.DenoiserTransformer(content_seq_len=D_L, dtype=dtype,
                                         **kw)

        def loss(p):
            y = model.apply({"params": p}, *args, fused_attention=True)
            y = y.astype(jnp.float32)
            return jnp.mean(y ** 2), y

        (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        return {"logits": torch.from_numpy(np.array(y)),
                **flax_to_state_dict(jax.device_get(g))}

    want, want32 = step(jnp.bfloat16), step(jnp.float32)
    model = tden.DenoiserTransformer(dtype=torch.bfloat16, **kw)
    model.load_state_dict(flax_to_state_dict(params))
    y = model(torch.from_numpy(tokens).long(), torch.from_numpy(cond),
              torch.from_numpy(t).long())
    (y.float() ** 2).mean().backward()
    got = {"logits": y.detach().float(),
           **{n: p.grad for n, p in model.named_parameters()}}
    assert set(got) == set(want) == set(want32)
    for part, names in (("logits", ["logits"]),
                        ("gradients", [n for n in want if n != "logits"])):
        scale = max(float(want[n].abs().max()) for n in names)
        w = {n: want[n] for n in names}
        drift, drift_at = _share({n: want32[n] for n in names}, w, scale)
        err, err_at = _share({n: got[n] for n in names}, w, scale)
        print(f"heads of {n_embd // n_head}, bf16 {part}: port vs JAX jit "
              f"{err:.4e} ({err_at}), JAX bf16 vs f32 {drift:.4e} "
              f"({drift_at}), share {err / drift:.3f}")
        assert drift > 0
        assert err <= DRIFT_SHARE * drift, (part, err / drift, err_at,
                                            drift_at)


def test_wide_domain_composes_to_the_jax_tree_and_takes_its_routes():
    """chip_smoke.py's WIDE_DOMAIN overrides on the job scripts' lines
    compose to the JAX package's tree: stage 1 over 16384 codes of dim 512,
    stage 2 (19 layers, n_embd 512 in 2 heads of 256, bf16, 100 steps at
    guidance 2) over the same codebook. That width lies in the whole-step
    kernels' domain (every n_embd up to 2048), so ``auto`` takes the
    megakernel route on the card, as JAX's rule does, and so does the
    honest width (n_embd 64 in heads of 4) over the same 16385 classes."""
    from gif_synthesis_with_discrete_diffusion_tpu.utils import config as jcfg
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        HONEST, at_width)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
        discrete_diffusion as tdd)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.megakernel \
        import kernels_fit
    from gif_synthesis_with_discrete_diffusion_tpu_torch.utils import config
    from tests.test_torch_config import _same

    trees = {}
    for stage, script in (("stage1", "vqvae_ucf.sh"),
                          ("stage2", "ddiff_ucf.sh")):
        ovr = (chip_smoke._job_overrides(script)
               + list(chip_smoke.HARNESS_BASE)
               + list(chip_smoke.WIDE_DOMAIN[stage]))
        trees[stage] = config.compose("train", ovr)
        assert _same(trees[stage], jcfg.compose("train", ovr))
    g1 = trees["stage1"]["model"]["generator"]
    ae = trees["stage2"]["model"]["autoencoder"]
    assert (g1["n_codes"], g1["embedding_dim"]) == (16384, 512)
    assert (ae["n_codes"], ae["embedding_dim"]) == (16384, 512)
    dm = trees["stage2"]["model"]["generator"]["diffusion_model"]
    tr = dm["transformer"]
    assert (tr["n_layer"], tr["n_embd"], tr["n_head"], tr["dtype"]) == (
        19, 512, 2, "bfloat16")
    assert (dm["diffusion_step"], dm["guidance_scale"]) == (100, 2)

    cuda = torch.device("cuda")
    for (n_embd, n_head), route in (((512, 2), "megakernel"),
                                    ((64, 16), "megakernel")):
        cfg = at_width(dict(HONEST, vqvae=dict(HONEST["vqvae"],
                                               n_codes=16384,
                                               embedding_dim=512)),
                       n_embd, n_head)
        with torch.device("meta"):
            gen = tdd.make_discrete_diffusion(cfg, 16384, (16, 8, 8))
        den = gen.diffusion.transformer
        assert den.to_logits.out_features == 16384
        assert kernels_fit(den) == (route == "megakernel")
        assert tdd.resolve_sampler("auto", cuda, 1024, den, True) == route
