"""K2 / K5 past head dim 128 against the JAX package (CPU).

The JAX attention takes any head dim; the port's kernels do too: above
128 the stream design (``csrc/mha_wg.cuh``: Stream; blocks of 192 or 256
output columns, every operand streamed through a ring, the scores of a
tile computed once and summed in increasing order of the dims). Here
tests/test_torch_head_dims.py's checks run at head dims 144, 192, 200 (no
multiple of 64), 256 and 512 (the plain versions and the stream design's
arithmetic, its tiles of keys from ``stream_tiles``, against the Pallas
kernel and its VJP in interpret mode, the bf16 arithmetic within its
bound), and the bf16 plain versions against the Pallas kernel with bf16
inputs; each over the self-attention case and over 1 and 77 keys. The
kernels run on the card only (``tests/test_torch_gpu_kernels.py``,
``chip_smoke.py`` phase 22).
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

# head dims above 128: the stream design (200: a contraction no multiple
# of its 64-dim stages; 512: two column chunks of 256)
STREAM_HEAD_DIMS = (144, 192, 200, 256, 512)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", STREAM_HEAD_DIMS)
def test_plain_attention_and_gradients_match_pallas_above_128(d, case):
    """tests/test_torch_head_dims.py's check at head dims above 128: the
    plain forward and backward and the stream design's arithmetic (its
    online softmax over K2's tile of keys, its dq kernel's one-tile Dr over
    its own tile) against the Pallas kernel and its VJP in interpret
    mode, within TOL."""
    check_plain_attention(d, case)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", STREAM_HEAD_DIMS)
def test_bf16_kernel_arithmetic_within_the_bf16_bound_above_128(d, case):
    """The stream design's bf16 arithmetic against the plain versions in
    f32 of the same inputs, within BF16_EXCESS_TOL beyond the rounding."""
    check_bf16_arithmetic(d, case)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", STREAM_HEAD_DIMS)
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


# ---------------------------------------------------------------------------
# the stream design's sizes and choices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_tiles_fit_shared_memory_at_every_head_dim(dtype):
    """Every head dim the stream design takes (129 up, here to 2048) gets
    a block whose shared memory (the resident own rows of bf16 heads up to
    256, the ring's slots, the dk/dv kernel's P^T buffers, the barriers)
    fits the 232,448 bytes a block can use, in two consumer warpgroups,
    with tiles of 32 or 64 rows of the other side and a ring of 3-6
    slots."""
    for d in range(129, 2049):
        tiles = attn.stream_tiles(d, dtype)
        assert set(tiles) == {"fwd", "dq", "kv"}
        for name, (warpgroups, rows, slots, smem) in tiles.items():
            assert warpgroups == 2 and rows in (32, 64) and 3 <= slots <= 6
            assert 0 < smem <= 232448, (d, name, smem)


@pytest.mark.parametrize("d,out,chunks", [
    (129, 192, 1), (144, 192, 1), (192, 192, 1), (193, 256, 1),
    (200, 256, 1), (256, 256, 1), (257, 192, 2), (320, 192, 2),
    (384, 192, 2), (448, 256, 2), (512, 256, 2), (576, 192, 3),
    (768, 256, 3), (1000, 256, 4)])
def test_stream_out_computes_every_score_once_up_to_256(d, out, chunks):
    """The stream design's block owns 192 output columns up to d = 192 and
    256 up to STREAM_ONE_PASS (one chunk: no score computed twice); wider
    heads take column chunks of whichever of 192 and 256 pads d the least
    (256 on a tie), every chunk covering the head."""
    assert attn.design(d) == "stream"
    assert attn.stream_out(d) == (out, chunks)
    assert (chunks == 1) == (d <= attn.STREAM_ONE_PASS == 256)
    assert out * chunks >= d > out * (chunks - 1)
    assert attn.kernel_head_dim(d) % attn.STREAM_CHUNK == 0


@pytest.mark.parametrize("d", [144, 200, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_arithmetic_takes_the_designs_tiles(d, dtype):
    """The kernels' arithmetic above 128 runs K2's online softmax over the
    stream design's tile of keys (64) and the dq kernel's one-tile Dr up to
    its tile (64 keys in f32, 32 in bf16), at the contraction
    kernel_head_dim gives."""
    tiles = attn.stream_tiles(d, dtype)
    dz = attn._Design(d, dtype)
    assert (dz.width, dz.tile, dz.one_group_keys) == (
        attn.kernel_head_dim(d), tiles["fwd"][1], tiles["dq"][1])
    assert dz.tile == 64
    assert dz.one_group_keys == (64 if dtype == torch.float32 else 32)


@pytest.mark.parametrize("lq,lk,d,splits", [
    (1024, 1, 144, 4), (1024, 77, 256, 4), (2304, 77, 512, 9),
    (1024, 256, 256, 1), (1024, 1024, 512, 1), (100, 33, 200, 1)])
def test_kv_splits_in_the_stream_design(lq, lk, d, splits):
    """The stream design's dK/dV kernel sums one chunk per 256 queries over
    a few keys (cross-attention over 1 or 77 tokens), none with 256 keys or
    more."""
    assert attn.kv_splits(lq, lk, d) == splits
