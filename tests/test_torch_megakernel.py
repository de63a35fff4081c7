"""The PyTorch port's whole-step sampler route vs the JAX megakernel (CPU).

The same flax denoiser tree, drawn with numpy from a seed, goes through the
JAX package (``ops/megakernel.py``, its Pallas kernels in interpret mode with
``sample_mode=False``, as ``tests/test_megakernel.py`` runs them) and,
carried over by ``convert/from_flax.py``, through the port's
``ops/megakernel.py``, whose CPU tensors take the plain version of the step.
Sizes are those of ``tests/test_megakernel.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def _make_setup(n_embd, n_head, std=0.3, mlp=4):
    """One flax tree with every leaf drawn from N(0, std) (biases and
    LayerNorm parameters included), the same weights in the port's module,
    and the JAX and torch schedules; an MLP of ``mlp`` n_embd."""
    rng = np.random.default_rng(0)
    model = JaxDenoiser(num_embed=K_CODES, spatial_size=SPATIAL,
                        n_layer=N_LAYER, n_embd=n_embd, n_head=n_head,
                        content_seq_len=L, condition_dim=COND_DIM,
                        diffusion_step=T, mlp_hidden_times=mlp)
    # only the tree's shapes: every leaf is drawn below
    params = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((B, L), jnp.int32),
        jnp.zeros((B, 1, COND_DIM)), jnp.zeros((B,), jnp.int32))["params"]
    params = jax.tree.map(
        lambda a: (std * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    transformer = DenoiserTransformer(
        num_embed=K_CODES, spatial_size=SPATIAL, n_layer=N_LAYER,
        n_embd=n_embd, n_head=n_head, condition_dim=COND_DIM,
        diffusion_step=T, mlp_hidden_times=mlp)
    transformer.load_state_dict(flax_to_state_dict(params))
    return dict(params=params, transformer=transformer.eval(),
                jsched=jd3pm.make_schedule(T, K),
                sched=d3pm.make_schedule(T, K), n_embd=n_embd,
                n_head=n_head)


@pytest.fixture(scope="module")
def setup():
    """The tree at N_EMBD in N_HEAD heads (heads of 8)."""
    return _make_setup(N_EMBD, N_HEAD)


# (n_embd, n_head[, MLP multiple]) across the whole-step kernels' domain:
# head dims 4, 16, 32, 64 and 128 (the setup above is head dim 8); n_embd
# below 32 and not a multiple of 32 or of 8, head dims under 4, odd and
# above 128, and an MLP width of 16 mod 32 (80 x 3)
WIDTHS = [(32, 8), (64, 4), (64, 2), (128, 2), (128, 1), (24, 8), (48, 4),
          (80, 16, 3), (100, 4), (144, 1), (512, 2), (512, 1)]
# the widths the kernels took first (n_embd a multiple of 32, heads of a
# multiple of 4 up to 128); the rest are checked in bf16 weights as well
OLD_WIDTHS = WIDTHS[:5]


def _width_id(w):
    return f"{w[0]}x{w[1]}" + (f"-mlp{w[2]}" if len(w) > 2 else "")


@pytest.fixture(scope="module", params=WIDTHS, ids=_width_id)
def wsetup(request):
    n_embd, n_head, *mlp = request.param
    return dict(_make_setup(n_embd, n_head, mlp=mlp[0] if mlp else 4),
                width=request.param)


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


def _to_storage(a: np.ndarray, axis: int, groups: int, n: int) -> np.ndarray:
    """``a``'s ``axis``, ``groups`` runs of n, each padded with zeros to the
    kernels' storage width (a multiple of 8)."""
    ns = mk.storage_width(n)
    a = np.moveaxis(a, axis, -1)
    a = a.reshape(*a.shape[:-1], groups, n)
    a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, ns - n)])
    return np.moveaxis(a.reshape(*a.shape[:-2], groups * ns), -1, axis)


# the tables' storage layout, stated apart from the code that makes it:
# per packed key, (axis, runs, "c" for n_embd or "h" for the MLP width)
STORAGE_AXES = {
    "wqkv": ((-2, 1, "c"), (-1, 3, "c")), "bqkv": ((-1, 3, "c"),),
    "wproj": ((-2, 1, "c"), (-1, 1, "c")), "bproj": ((-1, 1, "c"),),
    "wq_c": ((-2, 1, "c"), (-1, 1, "c")), "bq_c": ((-1, 1, "c"),),
    "wproj_c": ((-2, 1, "c"), (-1, 1, "c")), "bproj_c": ((-1, 1, "c"),),
    "ln2_s": ((-1, 1, "c"),), "ln2_b": ((-1, 1, "c"),),
    "wfc": ((-2, 1, "c"), (-1, 1, "h")), "bfc": ((-1, 1, "h"),),
    "wpj": ((-2, 1, "h"), (-1, 1, "c")), "bpj": ((-1, 1, "c"),),
    "ada_w": ((-1, 2, "c"),), "ada_b": ((-1, 2, "c"),),
    "wk_c": ((-1, 1, "c"),), "bk_c": ((-1, 1, "c"),),
    "wv_c": ((-1, 1, "c"),), "bv_c": ((-1, 1, "c"),),
    "emb": ((-1, 1, "c"),), "height": ((-1, 1, "c"),),
    "width": ((-1, 1, "c"),), "lno_s": ((-1, 1, "c"),),
    "lno_b": ((-1, 1, "c"),), "wlog": ((-2, 1, "c"),), "blog": ()}


def _jax_pack_in_storage(jpacked: dict, n_embd: int, hidden: int) -> dict:
    """JAX's packing (as f32 numpy) laid out as the port's tables are."""
    out = {}
    for name, w in jpacked.items():
        a = np.asarray(w.astype(jnp.float32))
        for axis, groups, which in STORAGE_AXES[name]:
            a = _to_storage(a, axis, groups,
                            n_embd if which == "c" else hidden)
        out[name] = a
    return out


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
    n_embd, n_head = setup["n_embd"], setup["n_head"]
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
        SPATIAL[0] * SPATIAL[1], n_embd)[:L]
    jax_args = (jp, jnp.asarray(tokens, jnp.int32),
                jmk._adaln_table(jp, jnp.asarray(t), T, n_embd), jkc, jvc,
                jpos, jax_rows(setup["jsched"])[t], jnp.int32(0))

    packed = mk.pack_denoiser_params(setup["transformer"],
                                     getattr(torch, dtype))
    kc, vc = mk.cross_tables(packed, torch.from_numpy(cond),
                             torch.from_numpy(cf), use_cfg, as_bias)
    args = (packed, torch.from_numpy(tokens),
            mk._adaln_table(packed, torch.tensor(t), T, n_embd), kc, vc,
            mk.positions(packed, L), schedule_rows(setup["sched"])[t], 0)
    kw = dict(n_layer=N_LAYER, n_head=n_head, n_embd=n_embd, num_classes=K,
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


# at every width: K3 (packed) and K4 (the (row, branch) grid) under CFG,
# with a general and a one-token condition, at the last timestep
WIDTH_CASES = pytest.mark.parametrize(
    "pack_cfg,s_len", [(True, 3), (True, 1), (False, 3), (False, 1)],
    ids=["packed-general", "packed-bias", "two_branch-general",
         "two_branch-bias"])
_JAX_TOKENS = {}


# the widths where the port's step takes JAX's AdaLN table (in the storage
# layout) in the comparison of tokens: there the two frameworks' tables lie
# 1.07e-4 and 2.16e-4 apart (within _adaln_bound, which the test of the
# tables at every width holds), and with the port's own table one argmax
# token of 32 moves in two of the four WIDTH_CASES; at every other width
# the port takes its own table
JAX_ADALN_WIDTHS = ((144, 1), (512, 2))


def _jax_width_step(wsetup, pack_cfg, s_len, dtype="float32"):
    """The JAX kernels' argmax tokens at a width (interpret mode), and the
    port's arguments of the same step; the JAX side computed once a case.
    At JAX_ADALN_WIDTHS the port's step takes JAX's AdaLN table."""
    rng = np.random.default_rng(200 + 7 * s_len)
    jax_args, args, kw = _step_inputs(wsetup, rng, s_len, True, False,
                                      dtype, T - 1)
    if tuple(wsetup["width"][:2]) in JAX_ADALN_WIDTHS:
        n = wsetup["n_embd"]
        table = _to_storage(np.asarray(jax_args[2]), -1, 2, n)
        args = args[:2] + (torch.from_numpy(table),) + args[3:]
    key = (wsetup["width"], pack_cfg, s_len, dtype)
    if key not in _JAX_TOKENS:
        _JAX_TOKENS[key] = np.asarray(jmk._megakernel_step(
            *jax_args, n_layer=N_LAYER, n_head=wsetup["n_head"],
            n_embd=wsetup["n_embd"], num_classes=K, guidance=2.0,
            use_cfg=True, s_valid=s_len, sample_mode=False, interpret=True,
            cross_as_bias=kw["cross_as_bias"], pack_cfg=pack_cfg))
    return _JAX_TOKENS[key], args, kw


@WIDTH_CASES
def test_step_tokens_equal_jax_kernels_at_every_width(wsetup, pack_cfg,
                                                       s_len):
    """The plain step against the JAX kernels across the kernels' domain
    (n_embd 24 to 512, head dims 3 to 512), token for token in argmax
    mode."""
    want, args, kw = _jax_width_step(wsetup, pack_cfg, s_len)
    got = mk.megakernel_step(*args, sample=False, pack_cfg=pack_cfg, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@WIDTH_CASES
def test_kernel_arithmetic_tokens_equal_jax_kernels_at_every_width(
        wsetup, pack_cfg, s_len):
    """The step with the kernels' arithmetic (split products, the
    polynomial share of the exponentials, the softmax shift) against the
    JAX kernels at every head dim of the domain: the same tokens."""
    want, args, kw = _jax_width_step(wsetup, pack_cfg, s_len)
    got = mk.megakernel_step_kernel_arithmetic(*args, sample=False, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module", params=WIDTHS[len(OLD_WIDTHS):],
                ids=_width_id)
def new_wsetup(request):
    n_embd, n_head, *mlp = request.param
    return dict(_make_setup(n_embd, n_head, mlp=mlp[0] if mlp else 4),
                width=request.param)


@pytest.mark.parametrize("pack_cfg,s_len", [(True, 3), (False, 1)],
                         ids=["packed-general", "two_branch-bias"])
def test_step_tokens_bf16_weights_at_every_width(new_wsetup, pack_cfg, s_len):
    """bf16 weights at the widths past the first domain: K3 with a general
    condition and K4 with a one-token one. The plain step equals the JAX
    kernels token for token; the step with the kernels' arithmetic (the
    three bf16 planes of the wgmma products; its polynomial row sums move a
    bf16 probability now and then) wherever the plain log-posterior's top
    two classes lie BF16_MARGIN apart."""
    want, args, kw = _jax_width_step(new_wsetup, pack_cfg, s_len, "bfloat16")
    got, post = mk.megakernel_step_reference(*args, sample=False,
                                             return_posterior=True, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    top2 = post.topk(2, dim=1).values
    decided = ((top2[:, 0] - top2[:, 1]) > BF16_MARGIN).numpy()
    assert decided.mean() > 0.9
    got = mk.megakernel_step_kernel_arithmetic(*args, sample=False, **kw)
    np.testing.assert_array_equal(got.numpy()[decided], want[decided])


@pytest.fixture(scope="module", params=OLD_WIDTHS, ids=_width_id)
def old_wsetup(request):
    n_embd, n_head = request.param
    return dict(_make_setup(n_embd, n_head), width=request.param)


@pytest.mark.parametrize("pack_cfg,s_len", [(True, 3), (False, 1)],
                         ids=["packed-general", "two_branch-bias"])
def test_step_tokens_bf16_weights_at_the_first_widths(old_wsetup, pack_cfg,
                                                      s_len):
    """bf16 weights at the widths the kernels took first (none of them the
    serving width, so the kernels take the three bf16 planes of the wgmma
    products there too): K3 with a general condition and K4 with a
    one-token one. The plain step and the step with the kernels' arithmetic
    equal the JAX kernels wherever the plain log-posterior's top two
    classes lie BF16_MARGIN apart, at least 0.9 of the tokens, as in
    test_step_tokens_bf16_weights (at n_embd 32 in heads of 4 one token of
    32 lies 4.4e-4 from its runner-up, and XLA's bf16 sums and torch's
    take either)."""
    want, args, kw = _jax_width_step(old_wsetup, pack_cfg, s_len,
                                     "bfloat16")
    got, post = mk.megakernel_step_reference(*args, sample=False,
                                             return_posterior=True, **kw)
    top2 = post.topk(2, dim=1).values
    decided = ((top2[:, 0] - top2[:, 1]) > BF16_MARGIN).numpy()
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[decided], want[decided])
    got = mk.megakernel_step_kernel_arithmetic(*args, sample=False, **kw)
    np.testing.assert_array_equal(got.numpy()[decided], want[decided])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_equals_jax_key_by_key_at_every_width(wsetup, dtype):
    """The packing at every width of the domain, as at the setup's, in the
    kernels' storage layout (JAX's packing padded by STORAGE_AXES; the same
    arrays wherever n_embd and the MLP width are multiples of 8)."""
    want = jmk.pack_denoiser_params(wsetup["params"], N_LAYER,
                                    weights_dtype=getattr(jnp, dtype))
    got = mk.pack_denoiser_params(wsetup["transformer"],
                                  getattr(torch, dtype))
    assert set(got) == set(want) == set(STORAGE_AXES)
    hidden = wsetup["transformer"].block0.mlp_fc.out_features
    for name, w in _jax_pack_in_storage(want, wsetup["n_embd"],
                                        hidden).items():
        assert got[name].is_contiguous(), name
        np.testing.assert_array_equal(got[name].to(torch.float32).numpy(),
                                      w, err_msg=name)


def _frequencies(n_embd: int):
    """The timestep sinusoid's f32 frequencies as each framework's
    SinusoidalPosEmb computes them: (JAX's, the port's)."""
    half = n_embd // 2
    e = math.log(10000) / (half - 1)
    return (np.asarray(jnp.exp(jnp.arange(half, dtype=jnp.float32) * -e)),
            torch.exp(torch.arange(half, dtype=torch.float32) * -e).numpy())


def _adaln_bound(packed: dict, t: int, n_embd: int) -> float:
    """How far the two frameworks' AdaLN tables may lie apart at timestep t,
    given that their sinusoid frequencies lie at most one ulp apart: a
    frequency f one ulp off moves the phase x f (x = 4000 t / T) by x
    ulp(f), its f32 rounding by one ulp of the phase more; sin and cos of
    one phase may differ by 2^-23 (two ulps below 1); silu's slope is at
    most 1.1; each entry's move is multiplied by its weight and summed over
    the width. The two f32 sums over n_embd terms (each |silu| <= 1 times a
    weight) and the bias's addition differ by at most 2 n_embd 2^-24 of the
    weights' magnitudes and 2^-22 of the result."""
    f = _frequencies(n_embd)[1]
    x = np.float32(np.float32(t) / np.float32(T) * np.float32(4000))
    move = x * np.spacing(f) + np.spacing(np.abs(x * f)) + 2.0 ** -23
    move = np.concatenate([move, move])                     # sin | cos
    w = np.abs(packed["ada_w"].numpy())                     # (l, 2, n, 2Cs)
    per_entry = 1.1 * move + 2 * n_embd * 2.0 ** -24
    table = np.abs(mk._adaln_table(packed, torch.tensor(t), T,
                                   n_embd).numpy())
    return float((np.einsum("j,lajk->lak", per_entry, w)
                  + 2.0 ** -22 * table).max())


def test_adaln_table_matches_jax_at_every_width(wsetup):
    """The AdaLN table at every width of the domain, against JAX's, within
    the bound its sinusoid's one-ulp frequencies give (:func:`_adaln_bound`:
    2.4e-5 to 1.9e-2 over these widths and timesteps, where the tables lie
    2.4e-7 to 2.2e-4 apart, at most 0.084 of the bound); the padding past
    n_embd zero."""
    n = wsetup["n_embd"]
    fj, ft = _frequencies(n)
    assert bool((np.abs(fj - ft) <= np.spacing(ft)).all())
    jpacked = jmk.pack_denoiser_params(wsetup["params"], N_LAYER)
    packed = mk.pack_denoiser_params(wsetup["transformer"])
    for t in (0, 3, T - 1):
        want = _to_storage(np.asarray(jmk._adaln_table(
            jpacked, jnp.asarray(t), T, n)), -1, 2, n)
        got = mk._adaln_table(packed, torch.tensor(t), T, n).numpy()
        assert got.shape == (N_LAYER, 2, 2 * mk.storage_width(n))
        assert not got[..., _to_storage(np.ones(2 * n), -1, 2, n) == 0].any()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_adaln_bound(packed, t, n))


def _queries_that_round_apart(d, n):
    """n f32 values q (the few found among 400 000 draws, repeated) whose q
    * fl32(1 / sqrt(d)) and q / sqrt(d) (f32 division) land on different
    bf16 values."""
    rng = np.random.default_rng(61)
    q = torch.from_numpy(rng.standard_normal(400_000).astype(np.float32))
    by_product = (q * np.float32(1.0 / math.sqrt(d))).to(torch.bfloat16)
    by_division = (q / np.float32(math.sqrt(d))).to(torch.bfloat16)
    apart = q[by_product != by_division]
    assert apart.numel() > 0
    return apart[torch.arange(n) % apart.numel()]


@pytest.mark.parametrize("d", [8, 12])
def test_query_scale_rounds_where_jax_rounds(d, monkeypatch):
    """q is scaled by fl32(1 / sqrt(d)) before its rounding to bf16, as the
    JAX kernels do (``(q * scale).astype(bf16)``), not divided by sqrt(d):
    on queries where the two round apart, the port's rounding equals JAX's
    bit for bit and not the division's, and both the plain self-attention
    and the kernels' arithmetic take their queries from it. (K3 / K4 take
    the same factor: ``megakernel_qscale``, held to fl32(1 / sqrt(d)) on the
    card.)"""
    n_head = 2
    q = _queries_that_round_apart(d, 3 * n_head * d).reshape(1, 3,
                                                             n_head * d)
    want = np.asarray((jnp.asarray(q.numpy()) * (1.0 / math.sqrt(d))
                       ).astype(jnp.bfloat16).astype(jnp.float32))
    got = mk._scale_queries(q, d)
    np.testing.assert_array_equal(got.numpy(), want)
    division = mk._bf16(q / math.sqrt(d))
    assert bool((got != division).all())
    seen = []
    real = mk._scale_queries
    monkeypatch.setattr(mk, "_scale_queries",
                        lambda x, dd: seen.append(dd) or real(x, dd))
    g = torch.Generator().manual_seed(3)
    k, v = (torch.randn((1, 5, n_head * d), generator=g) for _ in range(2))
    for fn in (mk._attention_reference, mk._attention_kernel_arithmetic):
        fn(q, k, v, n_head, 5)
    assert seen == [d, d]


def test_plain_step_keeps_the_storage_padding_zero_at_n_embd_100_mlp_300():
    """n_embd 100 in heads of 25 with an MLP of 300, which the tables store
    padded with zero columns to 104 and 304 (:func:`storage_width`): the
    packing is JAX's in that layout, the AdaLN, cross and position tables
    are zero past n_embd, the plain step's hidden state keeps its padding
    exactly zero through both layers, its LayerNorm normalises the true 100
    columns (over all 104 it would land elsewhere), and its argmax tokens
    equal the JAX kernels' (K3, a general condition). The kernels' own
    padded path (csrc ln_row at kCT != kC, the MLP's last chunk) is held to
    this plain version on the card: chip_smoke.py phase 21 (a), n_embd 100
    with an MLP of 300."""
    s = _make_setup(100, 4, mlp=3)
    jax_args, args, kw = _step_inputs(s, np.random.default_rng(8), 3, True,
                                      False, "float32", T - 1)
    packed, tokens, adaln, kc, vc, pos = args[:6]
    c, cs = 100, mk.storage_width(100)
    assert (cs, mk.storage_width(300)) == (104, 304)
    want = _jax_pack_in_storage(
        jmk.pack_denoiser_params(s["params"], N_LAYER,
                                 weights_dtype=jnp.float32), c, 300)
    for name, w in want.items():
        np.testing.assert_array_equal(packed[name].numpy(), w, err_msg=name)
    for table in (adaln[..., :cs], adaln[..., cs:], kc, vc, pos):
        assert table.shape[-1] == cs and not bool(table[..., c:].any())
    hidden_kw = dict(n_layer=N_LAYER, n_head=4, n_embd=c, use_cfg=True,
                     s_valid=3, cross_as_bias=False)
    x = mk.megakernel_hidden_reference(*args[:6], **hidden_kw)
    assert x.shape[-1] == cs and not bool(x[..., c:].any())
    true = x[..., :c]
    mu = true.mean(dim=-1, keepdim=True)
    var = (true - mu).square().mean(dim=-1, keepdim=True)
    ln = mk._ln(x, c)
    torch.testing.assert_close(ln[..., :c], (true - mu) / torch.sqrt(
        var + 1e-6), rtol=1e-5, atol=1e-5)
    assert not bool(ln[..., c:].any())
    assert float((mk._ln(x, cs)[..., :c] - ln[..., :c]).abs().max()) > 1e-2
    want = np.asarray(jmk._megakernel_step(
        *jax_args, n_layer=N_LAYER, n_head=4, n_embd=c, num_classes=K,
        guidance=2.0, use_cfg=True, s_valid=3, sample_mode=False,
        interpret=True, cross_as_bias=False, pack_cfg=True))
    got = mk.megakernel_step(*args, sample=False, pack_cfg=True, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


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
    monkeypatch.setattr(dd.d3pm, "sample", lambda *a, **k: called.append(
        ("reference", k["filter_ratio"])))
    g = torch.Generator().manual_seed(0)
    model.sample(cond, cf, B, generator=g)                  # auto, on the CPU
    model.sample(cond, cf, B, generator=g, mode="megakernel")
    # the log-onehot route: asked for, or what 'auto' takes with a
    # filter_ratio (the JAX package's rule)
    model.sample(cond, cf, B, generator=g, mode="reference")
    model.sample(cond, cf, B, generator=g, filter_ratio=0.5)
    assert called == ["model", "megakernel", ("reference", 0.0),
                      ("reference", 0.5)]
    with pytest.raises(ValueError):
        model.sample(cond, cf, B, generator=g, mode="fast")
    with pytest.raises(ValueError, match="filter_ratio"):
        model.sample(cond, cf, B, generator=g, mode="model",
                     filter_ratio=0.5)


@pytest.mark.parametrize("n_embd,n_head,mlp,seq,cond,device,want", [
    (64, 16, 4, 1024, True, "cuda", "megakernel"),
    (64, 16, 4, mk.MEGAKERNEL_MAX_SEQ, True, "cuda", "megakernel"),
    (64, 16, 4, mk.MEGAKERNEL_MAX_SEQ + 1, True, "cuda", "model"),
    (64, 16, 4, 1024, True, "cpu", "model"),
    (64, 16, 4, 1024, False, "cuda", "model"),      # no condition sequence
    (32, 4, 4, 1024, True, "cuda", "megakernel"),   # another width
    (64, 8, 4, 1024, True, "cuda", "megakernel"),   # another head dim
    (64, 16, 2, 1024, True, "cuda", "megakernel"),  # MLP width 128
    (128, 2, 4, 1024, True, "cuda", "megakernel"),  # heads of 64
    (512, 8, 4, mk.MEGAKERNEL_MAX_SEQ, True, "cuda", "megakernel"),
    (48, 4, 4, 1024, True, "cuda", "megakernel"),   # n_embd = 16 mod 32
    (1024, 16, 4, 1024, True, "cuda", "megakernel"),  # VQ-Diffusion-B's
    (2056, 8, 4, 1024, True, "cuda", "model"),      # n_embd above 2048
    (64, 32, 4, 1024, True, "cuda", "megakernel"),  # heads of 2
    (256, 1, 4, 1024, True, "cuda", "megakernel"),  # heads of 256
    (96, 16, 4, 1024, True, "cuda", "megakernel"),  # heads of 6
], ids=str)
def test_auto_route_is_a_rule_over_the_configuration(n_embd, n_head, mlp, seq,
                                                     cond, device, want):
    """'auto' takes the whole-step kernels for every model in their domain
    (every n_embd up to 2048 in heads that divide it, any MLP width: JAX's
    rule) on the card, up to 2304 tokens and with a condition;
    the model route for the rest, so the default entry point serves every
    width and no condition."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
        discrete_diffusion as dd)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.models.denoiser \
        import DenoiserTransformer
    tr = DenoiserTransformer(num_embed=K_CODES, spatial_size=(2, 2),
                             n_layer=1, n_embd=n_embd, n_head=n_head,
                             condition_dim=COND_DIM, diffusion_step=T,
                             mlp_hidden_times=mlp)
    fits = n_embd <= 2048 and n_embd % n_head == 0
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


# ---------------------------------------------------------------------------
# the kernels' own arithmetic, where it departs from the plain version's by
# more than the order of a sum (ops/megakernel.py states each departure as a
# plain function)
# ---------------------------------------------------------------------------

def _adversarial_activations(rng, rows, cols):
    """Random rows, then rows of large, tiny and mixed magnitudes, a row with
    one dominant entry, and a row of values that cancel in a sum."""
    a = rng.standard_normal((rows, cols)).astype(np.float32)
    a[0] *= 1e15
    a[1] *= 1e-15
    a[2] *= np.float32(10.0) ** rng.integers(-8, 8, cols).astype(np.float32)
    a[3, 1:] *= 1e-6
    a[3, 0] = 7e4
    a[4, 1::2] = -a[4, 0::2] * np.float32(1 + 2.0 ** -12)
    return torch.from_numpy(a)


def test_split_tf32_holds_an_f32_to_two_to_minus_21():
    """hi + lo misses a by at most 2^-21 |a| (a rounding to 11 bits, then a
    cut to 11 bits of the exact difference), and both halves are TF32
    values."""
    a = _adversarial_activations(np.random.default_rng(50), 16, 256)
    hi, lo = mk.split_tf32(a)
    err = (hi.double() + lo.double() - a.double()).abs()
    assert bool((err <= 2.0 ** -21 * a.abs().double()).all())
    for half in (hi, lo):       # 13 low bits of the significand are zero
        assert int((half.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # a bf16 value is a TF32 value: nothing to split
    b = a[5:].to(torch.bfloat16).to(torch.float32)
    assert torch.equal(mk.split_tf32(b)[0], b)
    assert int(mk.split_tf32(b)[1].abs().max()) == 0


@pytest.mark.parametrize("wdtype", ["bfloat16", "float32"])
def test_split_matmul_equals_the_exact_product(wdtype):
    """Against the f64 product of the same f32 activations and weights: the
    split leaves 2^-21 |a| |w| a term (bf16 weights; 2^-20 with the f32
    weights' own split and the dropped lo x lo), and an f32 sum of 64 terms
    in any order adds at most 64 x 2^-24: 2^-17 of sum |a| |w| bounds both.
    Rounding the activations to bf16, the alternative, would miss by 2^-9."""
    rng = np.random.default_rng(51)
    a = _adversarial_activations(rng, 64, 64)
    w = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    w[:, 0] *= 1e10
    w[:, 1] *= 1e-10
    w = w.to(getattr(torch, wdtype))
    want = a.double() @ w.double()
    scale = a.abs().double() @ w.abs().double()
    got = mk.split_matmul(a, w).double()
    assert bool(((got - want).abs() <= 2.0 ** -17 * scale).all())
    rounded = (a.to(torch.bfloat16).double() @ w.double() - want).abs()
    assert float((rounded / scale).max()) > 2.0 ** -12


@pytest.mark.parametrize("degree,bound", [(3, 2.0 ** -13), (6, 2.0 ** -21)])
def test_exp2_poly_error(degree, bound):
    """The polynomial exponentials of phase S against 2^x in f64, over the
    whole range the sweeps see (scores up to 126 / log2(e) = 87 under the
    row maximum; below that the result is clamped at 2^-126, where the
    special function unit gives 0: both vanish against a row sum >= 1)."""
    x = torch.cat([torch.linspace(-126.0, 0.0, 100001),
                   torch.tensor([-80.0 * 1.4426950408889634, -1e-7, -0.5,
                                 -1.5, -125.5])])
    got = mk.exp2_poly(x, degree).double()
    want = torch.exp2(x.double())
    assert float((got / want - 1).abs().max()) <= bound
    low = mk.exp2_poly(torch.tensor([-200.0, -float("inf")]), degree)
    assert bool((low <= 2.0 ** -125).all()) and bool((low >= 0).all())


def _adversarial_scores(rng, lq, lk):
    """(1, lq, lk) scores in units of log2: random rows, a row with one
    dominant score, rows whose scores lie 80 apart, equal scores, and a row
    whose scores sit at the polynomial's worst argument."""
    s = (4.0 * rng.standard_normal((lq, lk))).astype(np.float32)
    s[0] = -40.0
    s[0, 3] = 25.0
    s[1, ::2] += 80.0
    s[2] = 1.25
    s[3] = -0.5 * np.arange(lk, dtype=np.float32)
    s[4] = np.float32(-0.47)
    s[4, 0] = 0.0
    return torch.from_numpy(s)


def test_row_sum_with_polynomial_share_is_within_two_to_minus_13():
    """The row sum of sweep 1 with a share of its exponentials taken by the
    degree-3 polynomial: each such term is off by at most 2^-13.7, so the
    sum is (all terms positive); the rounding of the probabilities to bf16
    that follows is 2^-9."""
    s = _adversarial_scores(np.random.default_rng(52), 64, 80)
    x = s - s.amax(dim=-1, keepdim=True)
    exact = torch.exp2(x.double()).sum(dim=-1)
    for share in (mk.KERNEL_POLY_SHARE[0], 16):
        mask = mk.poly_exp_mask(64, 80, share)
        assert int(mask[:32, :16].sum()) == 32 * share
        e = torch.where(mask, mk.exp2_poly(x, 3), torch.exp2(x))
        got = e.double().sum(dim=-1)
        assert float((got / exact - 1).abs().max()) <= 2.0 ** -13


def test_attention_with_kernel_exponentials_against_plain():
    """Self-attention with the kernels' exponentials against the plain
    version on the same q, k, v: a row sum off by 2^-13 moves a probability
    across a bf16 rounding boundary in about 2^-13 / 2^-9 of the cases, each
    by one bf16 step (at most 2^-8 of it); the output, a mean of v under
    those probabilities, stays within 2^-8 of max |v| (reached when one key
    holds nearly all of a row's weight, as in the first row here)."""
    rng = np.random.default_rng(53)
    q, k, v = (torch.from_numpy(
        (2.0 * rng.standard_normal((2, 48, 16))).astype(np.float32))
        for _ in range(3))
    q[0, 0] *= 40.0            # one dominant score, others 80 and more below
    got = mk._attention_kernel_arithmetic(q, k, v, 4, 48)
    want = mk._attention_reference(q, k, v, 4, 48)
    bound = 2.0 ** -8 * float(v.abs().max())
    assert float((got - want).abs().max()) <= bound
    assert not torch.equal(got, want) or mk.KERNEL_POLY_SHARE == (0, 0)


@pytest.mark.parametrize("t", [0, T - 1])
@pytest.mark.parametrize("use_cfg,pack_cfg,s_len",
                         [(True, True, 1), (True, False, 3), (False, False, 1)],
                         ids=["packed_bias", "two_branch_general",
                              "no_cfg_bias"])
def test_kernel_arithmetic_tokens_equal_jax_kernels_f32(setup, use_cfg,
                                                        pack_cfg, s_len, t):
    """One argmax step computed with the kernels' arithmetic (split products
    with f32 weights, the polynomial share of the exponentials) against the
    JAX kernels in interpret mode: the same tokens."""
    rng = np.random.default_rng(100 + 7 * s_len + t)
    jax_args, args, kw = _step_inputs(setup, rng, s_len, use_cfg, False,
                                      "float32", t)
    want = jmk._megakernel_step(
        *jax_args, n_layer=N_LAYER, n_head=N_HEAD, n_embd=N_EMBD,
        num_classes=K, guidance=kw["guidance"], use_cfg=use_cfg,
        s_valid=s_len, sample_mode=False, interpret=True,
        cross_as_bias=kw["cross_as_bias"], pack_cfg=pack_cfg)
    got = mk.megakernel_step_kernel_arithmetic(*args, sample=False, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = mk.megakernel_step_reference(*args, sample=False, **kw)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("d", [3, 4, 5, 8, 16, 32, 64, 128, 144, 256, 512])
def test_softmax_shift_is_safe_for_any_scores(d):
    """The shift of phase S against the exact row maximum, for small scores,
    scores 80 and more apart, a dominant key inside and outside the first 16,
    and large and tiny operands, at every head dim of the kernels: it never
    lies under the maximum by more than the rounding of a d-term f32 sum,
    never more than KERNEL_SHIFT_SLACK above it (so the largest exponential
    of a row is at least exp(-40), far inside f32's range, and a row sum
    cannot vanish), and both branches (the bound, the exact maximum) are
    taken."""
    rng = np.random.default_rng(54)
    R, Lq, Lk, H = 2, 96, 80, 4
    q = rng.standard_normal((R, Lq, H, d)).astype(np.float32)
    k = rng.standard_normal((R, Lk, H, d)).astype(np.float32)
    # scores of unit spread at every d (the bound grows as d, the maximum
    # as sqrt(d): at d = 128 ordinary queries are not all within the slack)
    q /= np.float32(math.sqrt(d / 4))
    q[0, :32] *= 0.05          # small scores: the bound serves
    q[0, 32:64] *= 60.0        # scores far apart: the exact maximum
    k[1, 40, 0] *= 30.0        # a dominant key outside the first 16
    k[1, 3, 1] *= 30.0         # ... and inside
    q[1, 64:, 2] *= 1e-12
    k[1, :, 3] *= 1e6
    qs, kb = mk._bf16(torch.from_numpy(q)), mk._bf16(torch.from_numpy(k))
    s = torch.einsum("rqhd,rkhd->rhqk", qs, kb)
    shift = mk.softmax_shift(s, qs, kb)
    exact = s.amax(dim=-1, keepdim=True)
    assert tuple(shift.shape) == (R, H, Lq, 1)
    scale = torch.einsum("rqhd,rhd->rhq", qs.abs(),
                         kb.abs().amax(dim=1))[..., None]
    assert bool((shift >= exact - d * 2.0 ** -24 * scale).all())
    assert bool((shift - exact <= mk.KERNEL_SHIFT_SLACK).all())
    took_exact = shift == exact
    assert bool(took_exact[0, :, 32:64].all())      # the scaled queries
    assert not bool(took_exact[0, :, :32].any())    # the small ones
    # the softmax is the same under either shift, up to f32 rounding
    e = torch.exp(s - shift)
    p = e / e.sum(dim=-1, keepdim=True)
    want = torch.softmax(s.double(), dim=-1)
    assert bool(torch.isfinite(p).all())
    assert float((p.double() - want).abs().max()) <= 1e-5


def test_hidden_witness_sits_below_its_control(setup):
    """The yardsticks chip_smoke.py reads the kernels' hidden state against,
    on the CPU: the plain version with the kernels' arithmetic (split TF32
    products, phase S's exponentials), which K3 / K4 compute up to the
    order of their sums, stays within MK_RMS_SHARE of the RMS distance of
    the one-TF32 control, and both controls (one TF32 product, bf16
    activations) lie further off than the f64-summed witness."""
    import chip_smoke
    _, args, kw = _step_inputs(setup, np.random.default_rng(5), 3, True,
                               False, "bfloat16", 3)
    hidden_kw = {n: v for n, v in kw.items()
                 if n not in ("num_classes", "guidance")}
    want = mk.megakernel_hidden_reference(*args[:6], **hidden_kw)
    got = chip_smoke._hidden_witness(torch, args, hidden_kw, want)
    assert got["kernel arithmetic"][1] <= \
        chip_smoke.MK_RMS_SHARE * got["one TF32"][1]
    for control in ("one TF32", "bf16"):
        assert got["f64 sums"][1] < got[control][1] / 4
