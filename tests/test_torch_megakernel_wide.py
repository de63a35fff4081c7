"""The whole-step sampler route above n_embd 512 vs the JAX megakernel (CPU).

K3 and K4 take every n_embd up to 2048, the JAX kernels' whole reach; above
512 the CUDA kernels keep a tile's activations in device memory (csrc:
MK_WIDE). On the CPU their plain versions are what tensors take: here both,
:func:`megakernel_step_reference` and
:func:`megakernel_step_kernel_arithmetic`, are held to JAX's
``_megakernel_step`` in interpret mode (``sample_mode=False``), token for
token, at five widths above 512, each in f32 and bf16 weights, K3 and K4,
with a one-token condition (the bias path) and a general one; and the
kernel arithmetic's hidden state to the plain version's within
``chip_smoke.mk_hidden_tol`` and ``MK_RMS_SHARE``, as the card's width
checks hold the kernels. The same flax tree, drawn with numpy from a seed,
reaches the port through ``convert/from_flax.py``. Every leaf is drawn from
N(0, 0.3 sqrt(32 / n_embd)): the existing width tests' 0.3 at n_embd 32,
scaled as a layer's sums grow, so that the scores stay as spread as theirs.
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
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    megakernel as mk)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
    import schedule_rows

T, K_CODES, COND_DIM = 6, 16, 16    # K = 17
K = K_CODES + 1
SPATIAL, L, B = (5, 8), 40, 2
# (n_embd, n_head): heads of 128, 256, 125, 64 (VQ-Diffusion-B's width) and
# 1024; n_embd 1000 is no multiple of 64, nor its heads of 8
WIDE = [(640, 5), (768, 3), (1000, 8), (1024, 16), (2048, 2)]
# the step with the kernels' arithmetic may pick another token only where
# the plain log-posterior's top two classes are closer than this: at these
# widths its split products (1024-term sums) and exponentials move the
# log-posterior by up to ~1e-3, and two f32 tokens of 1024 x 16 lie 4.2e-5
# and 2.3e-4 from a tie (the bf16 rule of the narrower widths' tests)
MARGIN = 1e-3
# (weights, kernel, condition length, CFG): f32 and bf16 each through K3
# and K4, each with the bias path and the general cross-attention; K4 once
# under CFG (the two-branch grid), once at guidance 1
CASES = [("float32", True, 3, True), ("float32", False, 1, True),
         ("bfloat16", True, 1, True), ("bfloat16", False, 3, False)]
CASE_IDS = ["f32-K3-general", "f32-K4-bias", "bf16-K3-bias",
            "bf16-K4-general-no_cfg"]


def _layers(n_embd: int) -> int:
    """Two layers; one at 2048, whose two layers of f32 weights alone would
    hold ~0.5 GB a test worker."""
    return 1 if n_embd >= 2048 else 2


@pytest.fixture(scope="module", params=WIDE, ids=lambda w: f"{w[0]}x{w[1]}")
def wide(request):
    """One flax tree at the width, the same weights in the port's module."""
    n_embd, n_head = request.param
    n_layer = _layers(n_embd)
    rng = np.random.default_rng(n_embd + n_head)
    std = 0.3 * (32 / n_embd) ** 0.5
    kw = dict(num_embed=K_CODES, spatial_size=SPATIAL, n_layer=n_layer,
              n_embd=n_embd, n_head=n_head, condition_dim=COND_DIM,
              diffusion_step=T)
    params = jax.eval_shape(
        JaxDenoiser(content_seq_len=L, **kw).init, jax.random.key(0),
        jnp.zeros((B, L), jnp.int32), jnp.zeros((B, 1, COND_DIM)),
        jnp.zeros((B,), jnp.int32))["params"]
    params = jax.tree.map(
        lambda a: (std * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    transformer = DenoiserTransformer(**kw)
    transformer.load_state_dict(flax_to_state_dict(params))
    return dict(params=params, transformer=transformer.eval(),
                n_embd=n_embd, n_head=n_head, n_layer=n_layer,
                jsched=jd3pm.make_schedule(T, K), sched=d3pm.make_schedule(
                    T, K), jax_tokens={})


def _inputs(w, dtype, s_len, use_cfg):
    """The arguments of one step at the last timestep on both sides, from
    the same numpy draws; the JAX tables as its ``megakernel_sample_tokens``
    makes them."""
    n_embd, n_layer, t = w["n_embd"], w["n_layer"], T - 1
    rng = np.random.default_rng(7 * s_len + int(use_cfg))
    tokens = rng.integers(0, K, (B, L))
    cond = rng.standard_normal((B, s_len, COND_DIM)).astype(np.float32)
    cf = rng.standard_normal((1, s_len, COND_DIM)).astype(np.float32)
    as_bias = s_len == 1
    jp = jmk.pack_denoiser_params(w["params"], n_layer,
                                  weights_dtype=getattr(jnp, dtype))

    def jkv(c):
        k = jnp.einsum("bsd,lde->blse", c, jp["wk_c"]) \
            + jp["bk_c"][None, :, None, :]
        v = jnp.einsum("bsd,lde->blse", c, jp["wv_c"]) \
            + jp["bv_c"][None, :, None, :]
        return k, v

    branches = [jnp.asarray(cond)]
    if use_cfg:
        branches.append(jnp.broadcast_to(jnp.asarray(cf), cond.shape))
    if as_bias:
        def jbias(c):
            vb = jkv(c)[1][:, :, 0].astype(jnp.bfloat16).astype(jnp.float32)
            return jnp.einsum("blc,lce->ble", vb,
                              jp["wproj_c"].astype(jnp.float32)) \
                + jp["bproj_c"][None]
        jkc = jnp.pad(jnp.stack([jbias(c) for c in branches], axis=1)[
            :, :, :, None, :], [(0, 0)] * 3 + [(0, 7), (0, 0)])
        jvc = jkc
    else:
        kvs = [jkv(c) for c in branches]
        pad = [(0, 0)] * 3 + [(0, 8 - s_len), (0, 0)]
        jkc = jnp.pad(jnp.stack([k for k, _ in kvs], axis=1), pad)
        jvc = jnp.pad(jnp.stack([v for _, v in kvs], axis=1), pad)
    jpos = (jp["height"][:, None, :] + jp["width"][None, :, :]).reshape(
        SPATIAL[0] * SPATIAL[1], n_embd)[:L]
    jax_args = (jp, jnp.asarray(tokens, jnp.int32),
                jmk._adaln_table(jp, jnp.asarray(t), T, n_embd), jkc, jvc,
                jpos, jax_rows(w["jsched"])[t], jnp.int32(0))

    packed = mk.pack_denoiser_params(w["transformer"], getattr(torch, dtype))
    kc, vc = mk.cross_tables(packed, torch.from_numpy(cond),
                             torch.from_numpy(cf), use_cfg, as_bias)
    args = (packed, torch.from_numpy(tokens),
            mk._adaln_table(packed, torch.tensor(t), T, n_embd), kc, vc,
            mk.positions(packed, L), schedule_rows(w["sched"])[t], 0)
    kw = dict(n_layer=n_layer, n_head=w["n_head"], n_embd=n_embd,
              num_classes=K, guidance=2.0 if use_cfg else 1.0,
              use_cfg=use_cfg, s_valid=s_len, cross_as_bias=as_bias)
    return jax_args, args, kw


def _case(w, dtype, pack_cfg, s_len, use_cfg):
    """JAX's argmax tokens (computed once a case) and the port's arguments."""
    jax_args, args, kw = _inputs(w, dtype, s_len, use_cfg)
    key = (dtype, pack_cfg, s_len, use_cfg)
    if key not in w["jax_tokens"]:
        w["jax_tokens"][key] = np.asarray(jmk._megakernel_step(
            *jax_args, sample_mode=False, interpret=True, pack_cfg=pack_cfg,
            **kw))
    return w["jax_tokens"][key], args, kw


@pytest.mark.parametrize("dtype,pack_cfg,s_len,use_cfg", CASES, ids=CASE_IDS)
def test_wide_step_tokens_equal_jax_kernels(wide, dtype, pack_cfg, s_len,
                                            use_cfg):
    """The plain step equals the JAX kernels token for token (argmax)."""
    want, args, kw = _case(wide, dtype, pack_cfg, s_len, use_cfg)
    got = mk.megakernel_step(*args, sample=False, pack_cfg=pack_cfg, **kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,pack_cfg,s_len,use_cfg", CASES, ids=CASE_IDS)
def test_wide_kernel_arithmetic_tokens_equal_jax_kernels(
        wide, dtype, pack_cfg, s_len, use_cfg):
    """The step with the kernels' arithmetic (split TF32 products, phase S's
    exponentials and shift) equals the JAX kernels token for token wherever
    the plain log-posterior's top two classes lie MARGIN apart, at nine
    tokens of ten at least."""
    want, args, kw = _case(wide, dtype, pack_cfg, s_len, use_cfg)
    got = mk.megakernel_step_kernel_arithmetic(*args, sample=False, **kw)
    post = mk.megakernel_step_reference(*args, sample=False,
                                        return_posterior=True, **kw)[1]
    top2 = post.topk(2, dim=1).values
    decided = ((top2[:, 0] - top2[:, 1]) > MARGIN).numpy()
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[decided], want[decided])


@pytest.mark.parametrize("dtype,pack_cfg,s_len,use_cfg", CASES, ids=CASE_IDS)
def test_wide_hidden_state_within_the_kernels_tolerance(
        wide, dtype, pack_cfg, s_len, use_cfg):
    """The final hidden state with the kernels' arithmetic against the
    plain version's: max-abs within ``mk_hidden_tol`` at the width, RMS
    within ``MK_RMS_SHARE`` of the one-TF32 control's (chip_smoke's
    ``_hidden_witness``, the yardsticks of the card's width checks); the
    state's padding past n_embd zero."""
    import chip_smoke
    _, args, kw = _inputs(wide, dtype, s_len, use_cfg)
    hidden_kw = {n: v for n, v in kw.items()
                 if n not in ("num_classes", "guidance")}
    want = mk.megakernel_hidden_reference(*args[:6], **hidden_kw)
    n = wide["n_embd"]
    assert want.shape[-1] == mk.storage_width(n)
    assert not bool(want[..., n:].ne(0).any())
    rel = chip_smoke._hidden_witness(torch, args, hidden_kw, want)
    tol = chip_smoke.mk_hidden_tol(n, n // wide["n_head"], 4 * n)
    assert rel["kernel arithmetic"][0] <= tol, rel
    assert rel["kernel arithmetic"][1] <= \
        chip_smoke.MK_RMS_SHARE * rel["one TF32"][1], rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_carries_a_flax_tree_at_n_embd_1000(dtype):
    """``convert/from_flax.py`` and ``pack_denoiser_params`` carry a flax
    tree at n_embd 1000 (no multiple of 64; a multiple of 8, so the storage
    layout is JAX's own arrays) in 8 heads unchanged: the port's packing
    equals JAX's key by key."""
    rng = np.random.default_rng(1000)
    kw = dict(num_embed=K_CODES, spatial_size=SPATIAL, n_layer=1,
              n_embd=1000, n_head=8, condition_dim=COND_DIM,
              diffusion_step=T)
    params = jax.eval_shape(
        JaxDenoiser(content_seq_len=L, **kw).init, jax.random.key(0),
        jnp.zeros((B, L), jnp.int32), jnp.zeros((B, 1, COND_DIM)),
        jnp.zeros((B,), jnp.int32))["params"]
    params = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    tr = DenoiserTransformer(**kw)
    tr.load_state_dict(flax_to_state_dict(params))
    assert mk.storage_width(1000) == 1000
    want = jmk.pack_denoiser_params(params, 1,
                                    weights_dtype=getattr(jnp, dtype))
    got = mk.pack_denoiser_params(tr, getattr(torch, dtype))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].is_contiguous(), name
        np.testing.assert_array_equal(got[name].to(torch.float32).numpy(),
                                      np.asarray(w.astype(jnp.float32)),
                                      err_msg=name)


def test_widths_fit_every_n_embd_up_to_2048():
    """The kernels' domain: every n_embd from 1 to 2048 in any number of
    heads that divides it, any MLP width; nothing above 2048."""
    for n in range(1, 2049):
        heads = [h for h in range(1, n + 1) if n % h == 0]
        assert all(mk.widths_fit(n, h, 4 * n) for h in heads), n
        assert mk.widths_fit(n, n, 8) and not mk.widths_fit(n, n + 1, 8)
    for n in (2049, 2056, 2304, 4096):
        assert not any(mk.widths_fit(n, h, 4 * n) for h in (1, 2, 8))
