"""The attention kernels' plain versions at every head width the JAX kernels
take, and the denoiser and the stage-2 step at heads of 64 and 12, against
the JAX package (CPU).

The JAX attention (``ops/attention.py: fused_mha``) takes any head dim
d = C // n_head; the port's kernels take d up to 128 (heads of 4 and 8 in
their own design, every other width in the wg design, ``csrc/
mha_wg.cuh``). Here the port's plain versions and the wg
design's arithmetic (``attention_kernel_arithmetic``,
``attention_bwd_kernel_arithmetic``) are held to the Pallas kernel in
interpret mode and its ``jax.grad``; the denoiser at n_embd 128 in 2 heads
of 64 (VQ-Diffusion-B's head width) and at n_embd 48 in 4 heads of 12, and
a stage-2 step at n_embd 128, to the flax modules; and the configuration at
VQ-Diffusion-B's published width (``generate.VQD_B``) to the JAX package's
tree. The kernels themselves run on the card only
(``tests/test_torch_gpu_kernels.py``, ``chip_smoke.py`` phase 20).
"""
import collections
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gif_synthesis_with_discrete_diffusion_tpu.models import d3pm as jd3pm
from gif_synthesis_with_discrete_diffusion_tpu.models import (
    denoiser as jden)
from gif_synthesis_with_discrete_diffusion_tpu.ops.attention import (
    fused_mha as jax_fused_mha)
from gif_synthesis_with_discrete_diffusion_tpu.utils import config as jcfg
from gif_synthesis_with_discrete_diffusion_tpu_torch import roofline
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
    VQD_B, VQD_B_OVERRIDES)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
    denoiser as tden)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models.discrete_diffusion \
    import make_discrete_diffusion, resolve_sampler
from gif_synthesis_with_discrete_diffusion_tpu_torch.models.vqvae import (
    make_vqvae)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    attention as attn)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.megakernel import (
    kernels_fit)
from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage2
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils import config
from tests import test_torch_slice
from tests.test_job_scripts import _TPU_DIR, _overrides
from tests.test_torch_config import _same
from tests.test_torch_denoiser import (BF16_TOL, COND_DIM, L, NUM_EMBED,
                                       STEPS, TOL as DENOISER_TOL,
                                       _randomize)
from tests.test_torch_stage2 import (B as STEP_B, GRAD_TOL, K as STEP_K,
                                     LOSS_RTOL, _jax_step, _port_state)

HEAD_DIMS = (12, 16, 32, 64, 128)
H = 2
# the rtol = atol of tests/test_attention_kernel.py
TOL = 2e-4
# (B, Lq, Lk): self-attention, cross-attention over one key, and over 77
# keys (the JAX kernel pads them to 80)
CASES = {"self": (2, 16, 16), "cross1": (2, 16, 1), "cross77": (1, 24, 77)}
STEPS_STAGE2 = test_torch_slice.T    # the stage-2 step's diffusion steps


def _inputs(seed, B, Lq, Lk, C):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, n, C)).astype(np.float32)
                 for n in (Lq, Lk, Lk, Lq))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_attention_and_gradients_match_pallas(d, case):
    """The port's plain forward (through the autograd Function), its plain
    backward and the kernels' arithmetic at head dim ``d`` (the wg
    design: ``d`` in the instantiation ``kernel_head_dim(d)``, its columns
    beyond d zero; f32 q scaled before its three TF32 partial products)
    against the Pallas kernel and its VJP in interpret mode, within TOL."""
    check_plain_attention(d, case)


def check_plain_attention(d, case):
    """:func:`test_plain_attention_and_gradients_match_pallas` at head dim
    ``d`` (tests/test_torch_wide_domain.py runs it above 128)."""
    B, Lq, Lk = CASES[case]
    q, k, v, w = _inputs(d + Lk, B, Lq, Lk, H * d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))

    def loss(q, k, v):
        o = jax_fused_mha(q, k, v, n_head=H, interpret=True)
        return jnp.sum(o * w), o

    (_, want), want_grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tw = torch.from_numpy(w)
    before = (attn.fused_mha.launches, attn.fused_mha_bwd.launches)
    got = attn.fused_mha(tq, tk, tv, n_head=H)
    (got * tw).sum().backward()
    assert (attn.fused_mha.launches, attn.fused_mha_bwd.launches) == before
    plain = attn.fused_mha_bwd_reference(tq.detach(), tk.detach(),
                                         tv.detach(), tw, H)
    o, lse, o32 = attn.attention_kernel_arithmetic(
        tq.detach(), tk.detach(), tv.detach(), H)
    arith = attn.attention_bwd_kernel_arithmetic(
        tq.detach(), tk.detach(), tv.detach(), o32, lse, tw, H)
    for name, x in (("o", got.detach()), ("o arithmetic", o)):
        np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=name)
    for i, name in enumerate(("dq", "dk", "dv")):
        wnt = np.asarray(want_grads[i])
        fn = (tq, tk, tv)[i].grad
        torch.testing.assert_close(fn, plain[i], rtol=0, atol=0, msg=name)
        for label, x in (("plain", plain[i]), ("arithmetic", arith[i])):
            np.testing.assert_allclose(x.numpy(), wnt, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {label}")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bf16_kernel_arithmetic_within_the_bf16_bound(d, case):
    """The wg design's bf16 arithmetic (one bf16 product of the inputs,
    P and dS fed back as a bf16 hi + lo pair, the scale on the f32 scores,
    over one key the TPU kernel's Dr) against the plain versions in f32 of
    the same inputs: every output within BF16_EXCESS_TOL of its magnitude
    beyond its rounding (the gradients' scale floored at 1e-3 of the
    largest, as dq and dk vanish over one key)."""
    check_bf16_arithmetic(d, case)


def check_bf16_arithmetic(d, case):
    """:func:`test_bf16_kernel_arithmetic_within_the_bf16_bound` at head
    dim ``d``."""
    B, Lq, Lk = CASES[case]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(d + 7 * Lk, B, Lq, Lk, H * d))
    o, lse, o32 = attn.attention_kernel_arithmetic(q, k, v, H)
    grads = attn.attention_bwd_kernel_arithmetic(q, k, v, o32, lse, do, H)
    x32 = [x.float() for x in (q, k, v, do)]
    want = (attn.sdpa_reference(*x32[:3], H),
            *attn.fused_mha_bwd_reference(*x32, H))
    big = max(float(w.abs().max()) for w in want[1:])
    scales = [None] + [max(float(w.abs().max()), 1e-3 * big)
                       for w in want[1:]]
    excess = [attn.bf16_excess(a, w, s)
              for a, w, s in zip((o, *grads), want, scales)]
    assert all(a.dtype == torch.bfloat16 for a in (o, *grads))
    assert max(excess) <= attn.BF16_EXCESS_TOL, excess


def test_one_key_gives_zero_dq_and_dk_in_the_arithmetic():
    """Over one key the wg design's Dr is the TPU kernel's rowsum(dP P)
    with P divided by its row sum: P = 1, so dS and with it dq and dk are
    exactly 0, as the JAX kernel's."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(5, 2, 40, 1, H * 64))
    o, lse, o32 = attn.attention_kernel_arithmetic(q, k, v, H)
    dq, dk, dv = attn.attention_bwd_kernel_arithmetic(q, k, v, o32, lse,
                                                      do, H)
    assert not dq.any() and not dk.any() and dv.abs().max() > 0


@pytest.mark.parametrize("d,width", [
    (1, 16), (3, 16), (4, 4), (6, 16), (8, 8), (12, 16), (16, 16), (17, 32),
    (32, 32), (48, 64), (64, 64), (65, 128), (100, 128), (128, 128),
    (129, 192), (144, 192), (192, 192), (193, 256), (256, 256), (512, 512),
    (1000, 1024)])
def test_kernel_head_dim_takes_the_next_instantiation(d, width):
    """The wg design's next D up to 128; above it the stream design, its
    contraction padded to a multiple of STREAM_CHUNK."""
    assert attn.kernel_head_dim(d) == width
    assert attn.check_head_dim(3 * d, 3) == d


@pytest.mark.parametrize("c,n_head", [(2 * 129, 2), (256, 1), (1024, 4)])
def test_head_dims_above_128_are_refused_by_the_contract(c, n_head):
    """Head dims above 128 are no longer refused: the contract takes them
    (the stream design, at the instantiation ``kernel_head_dim`` gives), and
    what it still refuses is a width that is no multiple of n_head."""
    d = attn.check_head_dim(c, n_head)
    assert d == c // n_head > 128
    assert attn.kernel_head_dim(d) == -(-d // attn.STREAM_CHUNK) * \
        attn.STREAM_CHUNK
    with pytest.raises(ValueError, match="multiple"):
        attn.check_head_dim(130, 4)
    with pytest.raises(ValueError, match="multiple"):
        attn.check_head_dim(c + 1, n_head if n_head > 1 else 3)


@pytest.mark.parametrize("d", [12, 64])
def test_cpu_tensors_add_no_launch_at_any_head_dim(d):
    """The wrappers count launches by (head dim, dtype) where they launch a
    kernel; CPU tensors take the plain versions and count nothing."""
    q, k, v = (torch.randn((1, 8, 2 * d), requires_grad=True)
               for _ in range(3))
    before = (dict(attn.fused_mha.by_head_dim),
              dict(attn.fused_mha_bwd.by_head_dim))
    attn.fused_mha(q, k, v, n_head=2).sum().backward()
    assert (dict(attn.fused_mha.by_head_dim),
            dict(attn.fused_mha_bwd.by_head_dim)) == before


@pytest.mark.parametrize("names,parent,order", [
    (["change"], True, ["parent", "change", "change", "parent"]),
    (["plain", "v"], False, ["plain", "v", "v", "plain"]),
    (["plain", "v"], True, ["parent", "plain", "v", "v", "plain",
                            "parent"])])
def test_one_round_of_turns_is_symmetric(names, parent, order):
    """``probes/attention_variants.py``: every timing in turns (its main and
    ``compare``, which ``chip_smoke.py`` phase 20 (d) calls) runs each round
    in this order."""
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        attention_variants)
    assert attention_variants.turn_order(names, parent) == order


def test_f32_attention_bound_counts_three_tf32_products():
    """``chip_smoke.py`` bounds f32 attention as the kernels compute it, each
    product three TF32 products on the tensor cores (as K6), not at the
    CUDA cores' f32 rate; bf16 at the bf16 tensor-core rate."""
    nbytes, flops, _ = roofline.attention_work(64, 1024, 1024, 16, 64)
    f32 = chip_smoke._attention_bound(torch.float32, flops, nbytes)
    assert f32 == roofline.bound(nbytes, 0.0, flops_tf32=3.0 * flops)
    assert f32[0] == pytest.approx(3e3 * flops / roofline.PEAK_TF32,
                                   rel=1e-12)
    assert f32[1] == "operations"
    assert f32[0] < roofline.bound(nbytes, flops)[0]
    assert chip_smoke._attention_bound(torch.bfloat16, flops, nbytes) == (
        roofline.bound(nbytes / 2, 0.0, flops))


def test_kernels_line_reads_the_launches_by_head_dim():
    """``chip_smoke.py``'s kernels line takes each dtype's launches by head
    dim from the wrappers' counts and fails where a phase's width has
    none."""
    counts = collections.Counter({(d, torch.float32): 2 * d for d in (
        128, 4, 8, 12, 16, 32, 64)})
    counts[64, torch.bfloat16] = 7
    assert chip_smoke._head_dim_launches(counts, "float32", "K2") == {
        "4": 8, "8": 16, "12": 24, "16": 32, "32": 64, "64": 128,
        "128": 256}
    assert list(chip_smoke._head_dim_launches(counts, "float32", "K2")) == [
        "4", "8", "12", "16", "32", "64", "128"]
    with pytest.raises(AssertionError, match=r"\[4, 8, 12, 16, 32, 128\]"):
        chip_smoke._head_dim_launches(counts, "bfloat16", "K2 bf16")


# (n_embd, n_head): VQ-Diffusion-B's heads of 64, and heads of 12
WIDTHS = [(128, 2), (48, 4)]


@functools.cache
def _flax_params(n_embd, n_head):
    """The case's inputs and weights (one init a width, shared by its f32
    and bf16 cases: the parameters are f32 in both)."""
    rng = np.random.default_rng(n_embd)
    flax_model = jden.DenoiserTransformer(
        content_seq_len=L, num_embed=NUM_EMBED, spatial_size=(4, 4),
        n_layer=2, n_embd=n_embd, n_head=n_head, condition_dim=COND_DIM,
        diffusion_step=STEPS)
    tokens = rng.integers(0, NUM_EMBED + 1, (3, L)).astype(np.int32)
    cond = rng.standard_normal((3, 2, COND_DIM)).astype(np.float32)
    t = np.array([0, 4, STEPS - 1], np.int32)
    args = (jnp.asarray(tokens), jnp.asarray(cond), jnp.asarray(t))
    params = jax.jit(flax_model.init)(jax.random.key(0), *args)["params"]
    params = _randomize(params, rng, 0.2 * (64 / n_embd) ** 0.5)
    return args, params, (tokens, cond, t)


def _denoiser_case(n_embd, n_head, dtype):
    """The flax denoiser at ``n_embd`` in ``n_head`` heads, 2 layers, every
    weight redrawn N(0, (0.2 sqrt(64 / n_embd))^2): the activations' scale
    of tests/test_torch_denoiser.py's 64-wide model, at which its bf16 bound
    was set (at 0.2 for n_embd 128 the bf16-vs-f32 drift of either
    framework grows to 0.025 and 0.039 in heads of 4 as in heads of 64)."""
    kw = dict(num_embed=NUM_EMBED, spatial_size=(4, 4), n_layer=2,
              n_embd=n_embd, n_head=n_head, condition_dim=COND_DIM,
              diffusion_step=STEPS)
    flax_model = jden.DenoiserTransformer(content_seq_len=L, dtype=dtype,
                                          **kw)
    args, params, inputs = _flax_params(n_embd, n_head)
    return kw, flax_model, args, params, inputs


@pytest.mark.parametrize("n_embd,n_head", WIDTHS)
def test_denoiser_logits_match_flax_at_wide_heads(n_embd, n_head):
    """f32, the flax side's einsum attention: within the tolerance of
    tests/test_torch_denoiser.py."""
    kw, flax_model, args, params, (tokens, cond, t) = _denoiser_case(
        n_embd, n_head, jnp.float32)
    want = jax.jit(lambda p: flax_model.apply(
        {"params": p}, *args, fused_attention=False))(params)
    model = tden.DenoiserTransformer(**kw).eval()
    model.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(), torch.from_numpy(cond),
                    torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DENOISER_TOL, atol=DENOISER_TOL)


@pytest.mark.parametrize("n_embd,n_head", WIDTHS)
def test_bf16_denoiser_matches_flax_bf16_at_wide_heads(monkeypatch, n_embd,
                                                       n_head):
    """bf16 compute, the flax side's attention the Pallas kernel in
    interpret mode: logits and every gradient within the bound of
    tests/test_torch_denoiser.py's bf16 test. The JAX side is its step
    under ``jit``, whose roundings to bf16 the port follows
    (``models/denoiser.py``; op by op JAX rounds every op's output and
    moves its logits by up to 0.015 at n_embd 48)."""
    monkeypatch.setattr(jden, "fused_mha", functools.partial(
        jax_fused_mha, interpret=True))
    kw, flax_model, args, params, (tokens, cond, t) = _denoiser_case(
        n_embd, n_head, jnp.bfloat16)

    def loss(p):
        y = flax_model.apply({"params": p}, *args, fused_attention=True)
        return jnp.mean(y ** 2), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    model = tden.DenoiserTransformer(dtype=torch.bfloat16, **kw)
    model.load_state_dict(flax_to_state_dict(params))
    got = model(torch.from_numpy(tokens).long(), torch.from_numpy(cond),
                torch.from_numpy(t).long())
    assert float((got.detach() - torch.tensor(np.asarray(want))).abs()
                 .max()) <= BF16_TOL
    (got ** 2).mean().backward()
    want_grads = flax_to_state_dict(jax.device_get(grads))
    scale = max(float(w.abs().max()) for w in want_grads.values())
    for name, p in model.named_parameters():
        err = float((p.grad - want_grads[name]).abs().max())
        assert err <= BF16_TOL * scale, (name, err / scale)


def test_train_step_at_heads_of_64_matches_jax(monkeypatch):
    """tests/test_torch_stage2.py's step with the denoiser at n_embd 128 in
    2 heads of 64: the loss, every gradient and the buffers against the
    JAX package's with its draws."""
    wide = copy.deepcopy(test_torch_slice.CONFIG)
    wide["generator"]["diffusion_model"]["transformer"].update(
        n_embd=128, n_head=2)
    den = jden.DenoiserTransformer(
        num_embed=16, spatial_size=(8, 4), n_layer=2, n_embd=128, n_head=2,
        content_seq_len=32, condition_dim=32, diffusion_step=STEPS_STAGE2)
    monkeypatch.setattr(test_torch_slice, "_denoiser", lambda: den)
    rng = np.random.default_rng(0)
    labels = np.array([0, 3, 4, 1], np.int32)
    gen, gparams, ae, avars = test_torch_slice._flax_weights(
        rng, jnp.asarray(labels[:3]))
    video = rng.integers(0, 256, (STEP_B, 2, 8, 8, 3)).astype(np.uint8)
    hist = np.full((STEPS_STAGE2,), 1e-4, np.float32)
    hist[[1, 5]] = 50.0
    count = np.full((STEPS_STAGE2,), 11.0, np.float32)
    lt = jd3pm.LtState(history=jnp.asarray(hist), count=jnp.asarray(count))
    key = jax.random.key(3)
    t_rng, q_rng = jax.random.split(key)
    t, pt = jd3pm.sample_time(t_rng, lt, STEP_B, STEPS_STAGE2)
    noise = jax.random.uniform(q_rng, (STEP_B, STEP_K, 32), jnp.float32)
    want_total, grads, want_lt, _, _ = _jax_step(
        gen, gparams, ae, avars, video, labels, lt, key, den=den)

    state = _port_state(gparams, avars, hist, count, config=wide)
    assert state.generator.diffusion.transformer.block0.attn1.n_head == 2
    values = stage2.train_step(
        state, {"video": torch.from_numpy(video),
                "label": torch.from_numpy(labels)},
        t=torch.from_numpy(np.array(t)), pt=torch.from_numpy(np.array(pt)),
        noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(float(values["total"]), want_total,
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
    d = state.generator.diffusion
    np.testing.assert_allclose(d.lt_history.numpy(),
                               np.asarray(want_lt.history), rtol=1e-6,
                               atol=1e-6)



def test_compose_with_the_vqd_b_overrides_equals_jax():
    """ddiff_ucf.sh's line with the two overrides composes to the JAX
    package's tree, and that tree's denoiser is ``VQD_B``'s: VQ-Diffusion's
    19 layers, condition_dim 512, mlp_hidden_times 4, GELU2 and AdaLN at
    n_embd 1024 in 16 heads of 64."""
    ovr = _overrides(_TPU_DIR / "ddiff_ucf.sh") + list(VQD_B_OVERRIDES)
    got = config.compose("train", ovr)
    assert _same(got, jcfg.compose("train", ovr))
    tr = got["model"]["generator"]["diffusion_model"]["transformer"]
    want = VQD_B["generator"]["diffusion_model"]["transformer"]
    for key in ("n_layer", "n_embd", "n_head", "condition_dim"):
        assert tr[key] == want[key], key
    assert (tr["n_embd"], tr["n_head"]) == (1024, 16)
    assert (tr["mlp_hidden_times"], tr["block_activate"],
            tr["timestep_type"]) == (4, "GELU2", "adalayernorm")
    dm = got["model"]["generator"]["diffusion_model"]
    assert (dm["diffusion_step"], dm["guidance_scale"]) == (100, 2)


def _meta_generator(n_embd, n_head):
    cfg = copy.deepcopy(VQD_B)
    cfg["generator"]["diffusion_model"]["transformer"].update(
        n_embd=n_embd, n_head=n_head)
    with torch.device("meta"):
        vq = make_vqvae(cfg["vqvae"])
        return make_discrete_diffusion(cfg, cfg["vqvae"]["n_codes"],
                                       vq.latent_shape)


@pytest.mark.parametrize("n_embd,n_head", [(1024, 16), (128, 2), (48, 4),
                                           (2304, 16)])
def test_auto_takes_the_megakernel_route_up_to_n_embd_2048(n_embd, n_head):
    """The whole-step kernels take every n_embd up to 2048 in any heads
    that divide it: VQ-Diffusion-B's n_embd 1024 in heads of 64 lies inside,
    so ``kernels_fit`` is true there and ``auto`` takes the megakernel route
    on the card, as JAX's rule does, and so do heads of 64 at n_embd 128
    and heads of 12 at n_embd 48; n_embd 2304 lies outside, and ``auto``
    takes the model route. An explicit 'megakernel' is never turned into
    another route (``megakernel_step`` refuses a width outside on the card:
    tests/test_torch_gpu_kernels.py)."""
    gen = _meta_generator(n_embd, n_head)
    tr = gen.diffusion.transformer
    inside = n_embd <= 2048
    assert kernels_fit(tr) == inside
    cuda = torch.device("cuda")
    assert resolve_sampler("auto", cuda, 1024, tr, True) == (
        "megakernel" if inside else "model")
    assert resolve_sampler("megakernel", cuda, 1024, tr, True) == \
        "megakernel"


def test_vqd_b_counts_its_parameters():
    """387.4 M denoiser parameters at VQ-Diffusion-B's width on the honest
    grid (K = 4097, 1024 tokens)."""
    tr = _meta_generator(1024, 16).diffusion.transformer
    assert sum(p.numel() for p in tr.parameters()) == 387_366_912
    step = stage2.TRAIN_STEP2_VQD_B["generator"]["diffusion_model"]
    assert (step["transformer"]["n_embd"], step["transformer"]["n_head"],
            step["transformer"]["dtype"]) == (1024, 16, "bfloat16")
