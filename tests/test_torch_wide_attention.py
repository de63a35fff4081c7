"""K2 / K5 past head dim 128 against the JAX package (CPU).

The JAX attention takes any head dim; the port's kernels now do too: above
128 the split design (``csrc/mha_tiles.cuh``: blocks of 128 output columns,
the scores' contraction staged 64 dims at a time), whose products are the
mma.sync wide tiles' (``WTf32``, ``WBf16``). Here tests/test_torch_head_dims.py's checks run at head dims
144, 192, 256 and 512 (the plain versions and the kernels' arithmetic
against the Pallas kernel and its VJP in interpret mode, the bf16
arithmetic within its bound), and the bf16 plain versions against the
Pallas kernel with bf16 inputs. The kernels run on the card only
(``tests/test_torch_gpu_kernels.py``, ``chip_smoke.py`` phase 22).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.ops.attention import (
    fused_mha as jax_fused_mha)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops import (
    attention as attn)
from tests.test_torch_head_dims import (CASES, check_bf16_arithmetic,
                                        check_plain_attention)

# head dims above 128: the split design
SPLIT_HEAD_DIMS = (144, 192, 256, 512)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", SPLIT_HEAD_DIMS)
def test_plain_attention_and_gradients_match_pallas_above_128(d, case):
    """tests/test_torch_head_dims.py's check at head dims above 128: the
    plain forward and backward and the split design's arithmetic (that of
    the wide tiles, whose products it runs) against the Pallas kernel and its VJP
    in interpret mode."""
    check_plain_attention(d, case)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", SPLIT_HEAD_DIMS)
def test_bf16_kernel_arithmetic_within_the_bf16_bound_above_128(d, case):
    """The split design's bf16 arithmetic against the plain versions in f32
    of the same inputs, within BF16_EXCESS_TOL beyond the rounding."""
    check_bf16_arithmetic(d, case)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", SPLIT_HEAD_DIMS)
def test_bf16_plain_attention_matches_pallas_above_128(d, case):
    """bf16 inputs: the Pallas kernel and its VJP in interpret mode, and the
    port's plain versions, both f32 inside with their outputs rounded once
    to bf16: every output within one bf16 step at its largest magnitude."""
    B, Lq, Lk = CASES[case]
    H = 2
    rng = np.random.default_rng(3 * d + Lk)
    q, k, v, w = (rng.standard_normal((B, n, H * d)).astype(np.float32)
                  for n in (Lq, Lk, Lk, Lq))
    jq, jk, jv, jw = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, w))

    def loss(q, k, v):
        o = jax_fused_mha(q, k, v, n_head=H, interpret=True)
        return jnp.sum((o * jw).astype(jnp.float32)), o

    (_, want), want_grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    tq, tk, tv, tw = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (q, k, v, w))
    got = attn.sdpa_reference(tq, tk, tv, H)
    grads = attn.fused_mha_bwd_reference(tq, tk, tv, tw, H)
    for name, x, y in (("o", got, want),
                       *zip(("dq", "dk", "dv"), grads, want_grads)):
        assert x.dtype == torch.bfloat16
        y = np.asarray(y.astype(jnp.float32))
        big = float(np.abs(y).max())
        if big == 0.0:              # dq, dk over one key
            assert not x.float().any(), name
            continue
        err = float(np.abs(x.float().numpy() - y).max())
        assert err <= attn.bf16_step(big), (name, err, big)
