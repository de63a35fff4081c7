"""The PyTorch port's whole-step sampler route vs the JAX megakernel (CPU).

The same flax denoiser tree, drawn with numpy from a seed, goes through the
JAX package (``ops/megakernel.py``, its Pallas kernels in interpret mode with
``sample_mode=False``, as ``tests/test_megakernel.py`` runs them) and,
carried over by ``convert/from_flax.py``, through the port's
``ops/megakernel.py``, whose CPU tensors take the plain version of the step.
Sizes are those of ``tests/test_megakernel.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu.models.denoiser import (
    DenoiserTransformer as JaxDenoiser)
from gif_synthesis_with_discrete_diffusion_tpu.ops import megakernel as jmk
from gif_synthesis_with_discrete_diffusion_tpu.ops.sampler_kernel import (
    schedule_rows as jax_rows)
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import d3pm
from gif_synthesis_with_discrete_diffusion_tpu_torch.models.denoiser import (
    DenoiserTransformer)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models.\
    discrete_diffusion import D3PM
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    megakernel as mk)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
    import schedule_rows

T, K_CODES, L, B = 6, 24, 16, 2    # num_classes = K_CODES + 1
N_LAYER, N_EMBD, N_HEAD, COND_DIM = 2, 32, 4, 16
SPATIAL = (4, 4)
K = K_CODES + 1
# the cross tables and the positions: f32 sums in another order
TABLE_TOL = 1e-6
# the AdaLN table: the two frameworks' f32 exp differ by one ulp in the
# sinusoid's frequencies, and a phase of up to 4000 rad multiplies that to
# 5e-5 in sin / cos at T = 6 (the denoiser's own tests carry the same term)
ADALN_TOL = 1e-4
# bf16 weights: the port and the JAX kernel may pick different tokens only
# where the plain log-posterior's top two classes are closer than this
BF16_MARGIN = 1e-3


@pytest.fixture(scope="module")
def setup():
    """One flax tree with every leaf drawn (biases and LayerNorm parameters
    included), the same weights in the port's module, and the JAX and torch
    schedules."""
    rng = np.random.default_rng(0)
    model = JaxDenoiser(num_embed=K_CODES, spatial_size=SPATIAL,
                        n_layer=N_LAYER, n_embd=N_EMBD, n_head=N_HEAD,
                        content_seq_len=L, condition_dim=COND_DIM,
                        diffusion_step=T)
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((B, L), jnp.int32),
        jnp.zeros((B, 1, COND_DIM)), jnp.zeros((B,), jnp.int32))["params"]
    params = jax.tree.map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(params))
    transformer = DenoiserTransformer(
        num_embed=K_CODES, spatial_size=SPATIAL, n_layer=N_LAYER,
        n_embd=N_EMBD, n_head=N_HEAD, condition_dim=COND_DIM,
        diffusion_step=T)
    transformer.load_state_dict(flax_to_state_dict(params))
    return dict(params=params, transformer=transformer.eval(),
                jsched=jd3pm.make_schedule(T, K),
                sched=d3pm.make_schedule(T, K))


def _jax_kw(**extra):
    return dict(spatial_size=SPATIAL, n_layer=N_LAYER, n_head=N_HEAD,
                n_embd=N_EMBD, diffusion_step=T, guidance_scale=2.0,
                sample_mode=False, interpret=True, **extra)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_equals_jax_key_by_key(setup, dtype):
    want = jmk.pack_denoiser_params(setup["params"], N_LAYER,
                                    weights_dtype=getattr(jnp, dtype))
    got = mk.pack_denoiser_params(setup["transformer"],
                                  getattr(torch, dtype))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert str(g.dtype) == f"torch.{w.dtype}", name
        assert g.is_contiguous(), name
        np.testing.assert_array_equal(
            g.to(torch.float32).numpy(),
            np.asarray(w.astype(jnp.float32)), err_msg=name)
    low = {n for n, g in got.items() if g.dtype == torch.bfloat16}
    assert low == (set(mk._WEIGHT_NAMES) if dtype == "bfloat16" else set())


def test_adaln_table_matches_jax(setup):
    jpacked = jmk.pack_denoiser_params(setup["params"], N_LAYER)
    packed = mk.pack_denoiser_params(setup["transformer"])
    for t in (0, 3, T - 1):
        want = jmk._adaln_table(jpacked, jnp.asarray(t), T, N_EMBD)
        got = mk._adaln_table(packed, torch.tensor(t), T, N_EMBD)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=ADALN_TOL)
    every = mk._adaln_table(packed, torch.arange(T - 1, -1, -1), T, N_EMBD)
    assert tuple(every.shape) == (T, N_LAYER, 2, 2 * N_EMBD)
    torch.testing.assert_close(
        every[0], mk._adaln_table(packed, torch.tensor(T - 1), T, N_EMBD))


def _step_inputs(setup, rng, s_len, use_cfg, force_general, dtype, t):
    """The arguments of one step on both sides, from the same numpy draws.
    The JAX tables follow ``megakernel_sample_tokens``'s own preparation."""
    params = setup["params"]
    tokens = rng.integers(0, K, (B, L))
    cond = rng.standard_normal((B, s_len, COND_DIM)).astype(np.float32)
    cf = rng.standard_normal((1, s_len, COND_DIM)).astype(np.float32)
    as_bias = s_len == 1 and not force_general

    jp = jmk.pack_denoiser_params(params, N_LAYER,
                                  weights_dtype=getattr(jnp, dtype))
    jc = jnp.asarray(cond)
    jcf = jnp.broadcast_to(jnp.asarray(cf), cond.shape)

    def jkv(c):
        k = jnp.einsum("bsd,lde->blse", c, jp["wk_c"]) \
            + jp["bk_c"][None, :, None, :]
        v = jnp.einsum("bsd,lde->blse", c, jp["wv_c"]) \
            + jp["bv_c"][None, :, None, :]
        return k, v

    def jbias(c):
        vb = jkv(c)[1][:, :, 0].astype(jnp.bfloat16).astype(jnp.float32)
        return jnp.einsum("blc,lce->ble", vb,
                          jp["wproj_c"].astype(jnp.float32)) \
            + jp["bproj_c"][None]

    branches = [jc, jcf] if use_cfg else [jc]
    if as_bias:
        jkc = jnp.stack([jbias(c) for c in branches], axis=1)
        jkc = jnp.pad(jkc[:, :, :, None, :],
                      [(0, 0), (0, 0), (0, 0), (0, 7), (0, 0)])
        jvc = jkc
    else:
        kvs = [jkv(c) for c in branches]
        pad = [(0, 0), (0, 0), (0, 0), (0, 8 - s_len), (0, 0)]
        jkc = jnp.pad(jnp.stack([k for k, _ in kvs], axis=1), pad)
        jvc = jnp.pad(jnp.stack([v for _, v in kvs], axis=1), pad)
    jpos = (jp["height"][:, None, :] + jp["width"][None, :, :]).reshape(
        SPATIAL[0] * SPATIAL[1], N_EMBD)[:L]
    jax_args = (jp, jnp.asarray(tokens, jnp.int32),
                jmk._adaln_table(jp, jnp.asarray(t), T, N_EMBD), jkc, jvc,
                jpos, jax_rows(setup["jsched"])[t], jnp.int32(0))

    packed = mk.pack_denoiser_params(setup["transformer"],
                                     getattr(torch, dtype))
    kc, vc = mk.cross_tables(packed, torch.from_numpy(cond),
                             torch.from_numpy(cf), use_cfg, as_bias)
    args = (packed, torch.from_numpy(tokens),
            mk._adaln_table(packed, torch.tensor(t), T, N_EMBD), kc, vc,
            mk.positions(packed, L), schedule_rows(setup["sched"])[t], 0)
    kw = dict(n_layer=N_LAYER, n_head=N_HEAD, n_embd=N_EMBD, num_classes=K,
              guidance=2.0 if use_cfg else 1.0, use_cfg=use_cfg,
              s_valid=s_len, cross_as_bias=as_bias)
    return jax_args, args, kw


@pytest.mark.parametrize("s_len,force_general", [(3, False), (1, False),
                                                 (1, True)],
                         ids=["general", "bias", "bias_forced_general"])
def test_cross_tables_match_jax(setup, s_len, force_general):
    rng = np.random.default_rng(3)
    jax_args, args, _ = _step_inputs(setup, rng, s_len, True, force_general,
                                     "float32", 0)
    for got, want in ((args[3], jax_args[3]), (args[4], jax_args[4]),
                      (args[5], jax_args[5])):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TABLE_TOL)


@pytest.mark.parametrize("t", [0, T - 1])
@pytest.mark.parametrize("s_len,force_general", [(3, False), (1, False),
                                                 (1, True)],
                         ids=["general", "bias", "bias_forced_general"])
@pytest.mark.parametrize("use_cfg,pack_cfg", [(True, True), (True, False),
                                              (False, False)],
                         ids=["packed", "two_branch", "no_cfg"])
def test_step_tokens_equal_jax_kernels_f32(setup, use_cfg, pack_cfg, s_len,
                                           force_general, t):
    rng = np.random.default_rng(100 + 7 * s_len + t)
    jax_args, args, kw = _step_inputs(setup, rng, s_len, use_cfg,
                                      force_general, "float32", t)
    want = jmk._megakernel_step(
        *jax_args, n_layer=N_LAYER, n_head=N_HEAD, n_embd=N_EMBD,
        num_classes=K, guidance=kw["guidance"], use_cfg=use_cfg,
        s_valid=s_len, sample_mode=False, interpret=True,
        cross_as_bias=kw["cross_as_bias"], pack_cfg=pack_cfg)
    got = mk.megakernel_step(*args, sample=False, pack_cfg=pack_cfg, **kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s_len", [3, 1], ids=["general", "bias"])
def test_step_tokens_bf16_weights(setup, s_len):
    rng = np.random.default_rng(31 + s_len)
    jax_args, args, kw = _step_inputs(setup, rng, s_len, True, False,
                                      "bfloat16", T - 2)
    want = np.asarray(jmk._megakernel_step(
        *jax_args, n_layer=N_LAYER, n_head=N_HEAD, n_embd=N_EMBD,
        num_classes=K, guidance=2.0, use_cfg=True, s_valid=s_len,
        sample_mode=False, interpret=True,
        cross_as_bias=kw["cross_as_bias"], pack_cfg=True))
    got, post = mk.megakernel_step_reference(
        *args, sample=False, return_posterior=True, **kw)
    top2 = post.topk(2, dim=1).values
    decided = ((top2[:, 0] - top2[:, 1]) > BF16_MARGIN).numpy()
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[decided], want[decided])


def test_reference_rounds_where_the_kernel_rounds():
    """q / sqrt(d), k, v and the normalised probabilities go through bf16."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 5, 8), generator=g) for _ in range(3))
    got = mk._attention_reference(q, k, v, 2, 5)
    bf = mk._bf16
    qs, kb, vb = bf(q * 0.5).reshape(5, 2, 4), bf(k).reshape(5, 2, 4), \
        bf(v).reshape(5, 2, 4)
    want = torch.zeros(5, 2, 4)
    for h in range(2):
        s = qs[:, h] @ kb[:, h].t()
        e = torch.exp(s - s.amax(dim=1, keepdim=True))
        want[:, h] = bf(e / e.sum(dim=1, keepdim=True)) @ vb[:, h]
    torch.testing.assert_close(got[0], want.reshape(5, 8), rtol=0, atol=1e-6)
    # padded keys beyond `valid` are not read
    torch.testing.assert_close(
        mk._attention_reference(q, k, v, 2, 3),
        mk._attention_reference(q, k[:, :3], v[:, :3], 2, 3))


@pytest.mark.parametrize("s_len,pack_cfg", [(1, None), (1, False), (3, None)],
                         ids=["bias_packed", "bias_two_branch",
                              "general_packed"])
def test_full_loop_equals_jax(setup, s_len, pack_cfg):
    rng = np.random.default_rng(40 + s_len)
    cond = rng.standard_normal((B, s_len, COND_DIM)).astype(np.float32)
    cf = rng.standard_normal((1, s_len, COND_DIM)).astype(np.float32)
    want = np.asarray(jmk.megakernel_sample_tokens(
        jax.random.key(0), setup["jsched"], setup["params"],
        jnp.asarray(cond), jnp.asarray(cf), B, L,
        **_jax_kw(weights_dtype=jnp.float32, pack_cfg=pack_cfg)))
    got = mk.megakernel_sample_tokens(
        torch.Generator().manual_seed(0), setup["sched"],
        setup["transformer"], torch.from_numpy(cond), torch.from_numpy(cf),
        B, L, guidance_scale=2.0, weights_dtype=torch.float32, sample=False,
        pack_cfg=pack_cfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (B, L) and got.min() >= 0 and got.max() < K_CODES


def test_full_loop_sampled_is_valid_and_seeded(setup):
    cond = torch.randn((B, 1, COND_DIM),
                       generator=torch.Generator().manual_seed(1))
    cf = torch.zeros((1, 1, COND_DIM))

    def run(seed, guidance):
        return mk.megakernel_sample_tokens(
            torch.Generator().manual_seed(seed), setup["sched"],
            setup["transformer"], cond, cf, B, L, guidance_scale=guidance)

    a, b, c = run(5, 2.0), run(5, 2.0), run(6, 2.0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    for tok in (a, run(5, 1.0)):
        assert tok.min() >= 0 and tok.max() < K_CODES    # no MASK left


def _d3pm(setup):
    model = D3PM(num_embed=K_CODES, content_seq_len=L, spatial_size=SPATIAL,
                 diffusion_step=T, guidance_scale=2.0, n_layer=N_LAYER,
                 n_embd=N_EMBD, n_head=N_HEAD, condition_dim=COND_DIM)
    model.transformer.load_state_dict(setup["transformer"].state_dict())
    return model.eval()


def test_d3pm_sample_megakernel_equals_model_route(setup):
    # at the init laws' weights (N(0, 0.02), as the JAX package's own test
    # of its kernel against flax): the megakernel's bf16 rounding of q, k, v
    # and the probabilities then moves no argmax at these sizes
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.denoiser \
        import init_denoiser_
    model = _d3pm(setup)
    init_denoiser_(model.transformer, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(2)
    cond = torch.randn((B, 1, COND_DIM), generator=g)
    cf = torch.randn((1, 1, COND_DIM), generator=g)
    kw = dict(generator=torch.Generator().manual_seed(0), sample=False)
    want = model.sample(cond, cf, B, mode="model", **kw)
    got = model.sample(cond, cf, B, mode="megakernel",
                       weights_dtype=torch.float32, **kw)
    assert torch.equal(got, want)


def test_d3pm_sample_modes(setup, monkeypatch):
    model = _d3pm(setup)
    cond = torch.zeros((B, 1, COND_DIM))
    cf = torch.zeros((1, 1, COND_DIM))
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
        discrete_diffusion as dd)
    tr = model.transformer
    assert dd.resolve_sampler("auto", torch.device("cpu"), L, tr,
                              True) == "model"
    assert dd.resolve_sampler("model", torch.device("cuda"), L, tr,
                              True) == "model"
    called = []
    monkeypatch.setattr(dd, "megakernel_sample_tokens",
                        lambda *a, **k: called.append("megakernel"))
    monkeypatch.setattr(dd, "sample_tokens",
                        lambda *a, **k: called.append("model"))
    g = torch.Generator().manual_seed(0)
    model.sample(cond, cf, B, generator=g)                  # auto, on the CPU
    model.sample(cond, cf, B, generator=g, mode="megakernel")
    assert called == ["model", "megakernel"]
    with pytest.raises(ValueError):
        model.sample(cond, cf, B, generator=g, mode="fast")
    with pytest.raises(NotImplementedError):
        model.sample(cond, cf, B, generator=g, mode="reference")
    with pytest.raises(NotImplementedError):
        model.sample(cond, cf, B, generator=g, filter_ratio=0.5)


@pytest.mark.parametrize("n_embd,n_head,mlp,seq,cond,device,want", [
    (64, 16, 4, 1024, True, "cuda", "megakernel"),
    (64, 16, 4, mk.MEGAKERNEL_MAX_SEQ, True, "cuda", "megakernel"),
    (64, 16, 4, mk.MEGAKERNEL_MAX_SEQ + 1, True, "cuda", "model"),
    (64, 16, 4, 1024, True, "cpu", "model"),
    (64, 16, 4, 1024, False, "cuda", "model"),      # no condition sequence
    (32, 4, 4, 1024, True, "cuda", "model"),        # another width
    (64, 8, 4, 1024, True, "cuda", "model"),        # another head dim
    (64, 16, 2, 1024, True, "cuda", "megakernel"),  # MLP width 128
], ids=str)
def test_auto_route_is_a_rule_over_the_configuration(n_embd, n_head, mlp, seq,
                                                     cond, device, want):
    """'auto' takes the whole-step kernels only for a model they are built
    for, so the default entry point serves every width and no condition."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
        discrete_diffusion as dd)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.denoiser \
        import DenoiserTransformer
    tr = DenoiserTransformer(num_embed=K_CODES, spatial_size=(2, 2),
                             n_layer=1, n_embd=n_embd, n_head=n_head,
                             condition_dim=COND_DIM, diffusion_step=T,
                             mlp_hidden_times=mlp)
    fits = n_embd == 64 and n_head == 16 and (mlp * n_embd) % 64 == 0
    assert mk.kernels_fit(tr) == fits
    assert dd.resolve_sampler("auto", torch.device(device), seq, tr,
                              cond) == want


def test_cuda_tensors_never_take_the_plain_version(setup, monkeypatch):
    """A tensor that is neither on the CPU nor on a CUDA device raises, and
    only the tokens' device decides: nothing falls back."""
    packed = mk.pack_denoiser_params(setup["transformer"])
    tokens = torch.zeros((B, L), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        mk.megakernel_step(
            packed, tokens, None, None, None, None, None, 0, n_layer=N_LAYER,
            n_head=N_HEAD, n_embd=N_EMBD, num_classes=K, guidance=2.0,
            use_cfg=True, s_valid=1)
    assert mk.megakernel_step.launches_k3 == 0
    assert mk.megakernel_step.launches_k4 == 0
