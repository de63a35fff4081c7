"""The port's bf16 stage-1 gradients against ``jax.grad`` of the flax bf16
VQ-VAE (CPU).

The JAX side takes the gradient of recon + commitment (the ``l_dummy``
total of ``train/stage1.py``) through the flax VQ-VAE at ``dtype=bfloat16``
in training mode, as ``tests/test_vqvae.py::test_vqvae_bf16_train_grad``
does, and again at f32 on the same variables: the second gives JAX's own
bf16-vs-f32 drift at this step. The port runs ``train/stage1.train_step``
at ``dtype: bfloat16`` on the same bridged weights, the same uint8 clips
and the candidate rows the JAX codebook drew.

One place rounds differently and the port keeps its own: the gradient of a
bias added in bf16 is the transpose of its broadcast, a ``reduce_sum`` over
bf16 values, which XLA:CPU accumulates in bf16 (at the decoder's last
transposed conv, 1024 positions, JAX's bf16 gradient lies 0.099 of the
largest gradient from its f32 one); torch accumulates it in f32 and rounds
once. So the reference here is JAX's bf16 gradient with each bf16
``reduce_sum`` of its jaxpr accumulated in f32 (:func:`_f32_sums`; the JAX
package is not touched). Against it the port's gradients must lie within
``DRIFT_SHARE`` of JAX's own bf16-vs-f32 drift (each tensor's max error
over the largest JAX gradient): the rest is where the two frameworks round
inside the step (XLA keeps fused elementwise chains in f32, eager torch
rounds each op), which five BatchNorms on the batch statistics of two clips
magnify to the size of the drift itself. The three JAX gradients are ~20 s
of compile each, so this file stands alone and ``--dist loadfile`` gives it
a worker of its own.
"""
import jax
import jax.numpy as jnp
from jax.extend import core as jex_core
import numpy as np
import torch

from gif_synthesis_with_discrete_diffusion_tpu.data.preprocess import (
    preprocess_clip as jax_preprocess_clip)
from gif_synthesis_with_discrete_diffusion_tpu.models.vqvae import (
    VQVAE as JaxVQVAE)
from gif_synthesis_with_discrete_diffusion_tpu.train import (
    stage1 as jax_stage1)
from gif_synthesis_with_discrete_diffusion_tpu.train.metrics import (
    weighted_losses as jax_weighted_losses)
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict, vqvae_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.train import stage1
from tests.test_torch_stage1 import BF16_KW, _jax_rows
from tests.test_torch_vqvae import _flax_vqvae

# the port's error, as a share of JAX's own bf16-vs-f32 gradient drift: no
# farther from JAX's bf16 gradients than those lie from JAX's f32 ones
DRIFT_SHARE = 1.0
LOSS_DICT = {"l_dummy": 1.0}


def _f32_sums(jaxpr, consts, *args):
    """Evaluate ``jaxpr`` with every bf16 ``reduce_sum`` accumulated in f32
    and rounded once (nested jits included)."""
    env = {}

    def read(v):
        return v.val if isinstance(v, jex_core.Literal) else env[v]

    env.update(zip(jaxpr.constvars, consts))
    env.update(zip(jaxpr.invars, args))
    for eqn in jaxpr.eqns:
        ins = [read(v) for v in eqn.invars]
        name = eqn.primitive.name
        if name == "reduce_sum" and ins[0].dtype == jnp.bfloat16:
            outs = [eqn.primitive.bind(ins[0].astype(jnp.float32),
                                       **eqn.params).astype(jnp.bfloat16)]
        elif name in ("pjit", "jit"):
            inner = eqn.params["jaxpr"]
            outs = _f32_sums(inner.jaxpr, inner.consts, *ins)
        else:
            subfuns, params = eqn.primitive.get_bind_params(eqn.params)
            outs = eqn.primitive.bind(*subfuns, *ins, **params)
            outs = outs if eqn.primitive.multiple_results else [outs]
        env.update(zip(eqn.outvars, outs))
    return [read(v) for v in jaxpr.outvars]


def _jax_grads(model, variables, video, key, f32_sums=False):
    """``jax.grad`` of recon + commitment; with ``f32_sums`` the gradient's
    bf16 reductions (a bias's gradient: the transpose of its broadcast,
    which XLA:CPU accumulates in bf16) are accumulated in f32, as torch
    accumulates them."""
    def loss_fn(params):
        out, _ = jax_stage1._forward(model, params, variables["batch_stats"],
                                     variables["codebook"], video, key, True)
        return jax_weighted_losses(LOSS_DICT, out)[0]

    grad = jax.grad(loss_fn)
    if f32_sums:
        params = variables["params"]
        closed = jax.make_jaxpr(grad)(params)
        leaves = jax.tree.leaves(params)
        grad = lambda p: jax.tree.unflatten(  # noqa: E731
            jax.tree.structure(params),
            _f32_sums(closed.jaxpr, closed.consts, *jax.tree.leaves(p)))
        assert len(closed.jaxpr.invars) == len(leaves)
    return flax_to_state_dict(jax.device_get(
        jax.jit(grad)(variables["params"])))


def _share(got: dict, want: dict, scale: float) -> tuple[float, str]:
    """The largest max error of a tensor over ``scale``, and its name."""
    return max((float((got[n] - w).abs().max()) / scale, n)
               for n, w in want.items())


def test_bf16_stage1_grads_match_jax_bf16_within_its_drift():
    rng = np.random.default_rng(4)
    model, variables = _flax_vqvae(rng, dtype=jnp.bfloat16, **BF16_KW)
    model32 = JaxVQVAE(kernel_mode="xla", **BF16_KW)
    video_u8 = rng.integers(0, 256, (2, 2, 16, 16, 3)).astype(np.uint8)
    video = jax_preprocess_clip(jnp.asarray(video_u8), BF16_KW["resolution"])
    key = jax.random.key(3)
    raw = _jax_grads(model, variables, video, key)
    want = _jax_grads(model, variables, video, key, f32_sums=True)
    want32 = _jax_grads(model32, variables, video, key)
    rows = _jax_rows(model, variables, video, key)

    config = {"generator": dict(BF16_KW, kernel_mode="xla",
                                dtype="bfloat16"),
              "losses": {"loss_dict": LOSS_DICT}}
    state = stage1.build_stage1(config, "cpu",
                                torch.Generator().manual_seed(0))
    state.vqvae.load_state_dict(vqvae_state_dict(
        variables["params"], variables["batch_stats"],
        variables["codebook"]))
    stage1.train_step(state, {"video": video_u8}, init_rows=rows[0],
                      restart_rows=rows[1])
    got = {n: p.grad for n, p in state.vqvae.named_parameters()}
    assert set(got) == set(want) == set(want32) == set(raw)
    assert all(g is not None and g.dtype == torch.float32
               for g in got.values())

    scale = max(float(w.abs().max()) for w in want.values())
    drift, drift_at = _share(want32, want, scale)
    err, err_at = _share(got, want, scale)
    raw_drift, raw_drift_at = _share(want32, raw, scale)
    raw_err, raw_err_at = _share(got, raw, scale)
    at = raw_err_at
    port_f32 = float((got[at] - want32[at]).abs().max()) / scale
    print(f"bf16 stage-1 gradients, of the largest gradient {scale:.4e}: "
          f"port vs JAX bf16 (f32 sums) {err:.4e} ({err_at}), JAX bf16 (f32 "
          f"sums) vs JAX f32 {drift:.4e} ({drift_at}), share "
          f"{err / drift:.3f}; as XLA:CPU sums: port vs JAX bf16 "
          f"{raw_err:.4e} ({at}), JAX bf16 vs f32 {raw_drift:.4e} "
          f"({raw_drift_at}), port vs JAX f32 there {port_f32:.4e}")
    # the bf16 sum of the last bias's gradient is what the f32 sums change:
    # there JAX's bf16 gradient is far from its f32 one, the port's is not
    assert raw_drift_at == at == "decoder.convt1.bias"
    assert port_f32 < 0.1 * raw_drift
    assert drift > 0
    assert err <= DRIFT_SHARE * drift, (err, err_at, drift, drift_at)
