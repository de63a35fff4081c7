"""The port's hand-written kernels against their plain versions, on a CUDA
card: ``python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py``
(``tests/conftest.py`` imports jax, which a machine for the port may lack).

Each test asks the ``cuda`` fixture for the device, and the fixture skips
where there is none: the decision is made while the tests run, never while
the module is imported, so every worker collects the same tests.
"""
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu_torch.models.d3pm import (
    make_schedule)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.attention import (
    fused_mha, sdpa_reference)
from gif_synthesis_with_discrete_diffusion_tpu_torch.ops.sampler_kernel \
    import (fused_sample_step, fused_sample_step_reference, schedule_rows)

pytestmark = pytest.mark.gpu

# the posterior tolerance of tests/test_sampler_kernel.py
K1_TOL = 1e-4
# the rtol = atol of tests/test_attention_kernel.py
K2_TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("k,L,guidance,t", [
    (17, 40, 2.0, 7), (17, 40, 1.0, 0), (4097, 256, 2.0, 99),
    (4097, 256, 2.0, 0), (4097, 200, 1.0, 50)])
def test_sampler_step_kernel_matches_plain(cuda, k, L, guidance, t):
    B = 2
    g = torch.Generator(device=cuda).manual_seed(k + L + t)
    nb = 2 * B if guidance != 1.0 else B
    logits2 = (3.0 * torch.randn((nb, L, k - 1), generator=g,
                                 device=cuda)).transpose(1, 2)
    tokens = torch.randint(0, k, (B, L), generator=g, device=cuda)
    row = schedule_rows(make_schedule(100, k, device=cuda))[t]
    kw = dict(guidance=guidance, num_classes=k, sample=False,
              return_posterior=True)
    before = fused_sample_step.launches
    tok_k, post_k = fused_sample_step(logits2, tokens, row, 5, **kw)
    assert fused_sample_step.launches == before + 1
    tok_p, post_p = fused_sample_step_reference(logits2, tokens, row, 5, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(post_k, post_p, rtol=0, atol=K1_TOL)
    top2 = post_p.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > K1_TOL
    assert not ((tok_k != tok_p) & decided).any()


def test_sampler_step_kernel_samples_in_range_and_by_seed(cuda):
    k, B, L = 4097, 2, 256
    g = torch.Generator(device=cuda).manual_seed(0)
    logits2 = torch.randn((2 * B, L, k - 1), generator=g,
                          device=cuda).transpose(1, 2)
    tokens = torch.full((B, L), k - 1, dtype=torch.int64, device=cuda)
    row = schedule_rows(make_schedule(100, k, device=cuda))[60]
    draw = [fused_sample_step(logits2, tokens, row, s, guidance=2.0,
                              num_classes=k) for s in (1, 1, 2)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    assert draw[0].min() >= 0 and draw[0].max() < k


@pytest.mark.parametrize("B,Lq,Lk,C,H", [
    (2, 16, 16, 64, 16), (2, 16, 1, 64, 16), (1, 24, 77, 64, 8),
    (2, 16, 16, 32, 4), (2, 300, 300, 64, 16), (3, 257, 77, 64, 16)])
def test_attention_kernel_matches_plain(cuda, B, Lq, Lk, C, H):
    g = torch.Generator(device=cuda).manual_seed(Lq * Lk)
    q, k, v = (torch.randn((B, n, C), generator=g, device=cuda)
               for n in (Lq, Lk, Lk))
    before = fused_mha.launches
    got = fused_mha(q, k, v, n_head=H)
    assert fused_mha.launches == before + 1
    torch.testing.assert_close(got, sdpa_reference(q, k, v, H), rtol=K2_TOL,
                               atol=K2_TOL)


def test_attention_kernel_refuses_other_head_dims(cuda):
    q = torch.randn((1, 8, 64), device=cuda)
    with pytest.raises(ValueError):
        fused_mha(q, q, q, n_head=4)                 # head dim 16


def test_small_slice_on_the_card_matches_the_cpu(cuda):
    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        build_models, sample_token_grid)
    config = {
        "vqvae": {"embedding_dim": 16, "n_codes": 16, "n_hiddens": 32,
                  "n_res_layers": 1, "downsample": (1, 2, 2),
                  "sequence_length": 2, "resolution": 8},
        "generator": {
            "diffusion_model": {"diffusion_step": 8, "guidance_scale": 2.0,
                                "transformer": {"n_layer": 2, "n_embd": 64,
                                                "n_head": 16,
                                                "condition_dim": 32}},
            "textencoder": {"mode": "label", "n_classes": 5, "dim": 32}},
    }
    out = {}
    for dev in (cuda, torch.device("cpu")):
        models = build_models(config, dev, torch.Generator().manual_seed(3))
        tok = sample_token_grid(models, {"label": torch.tensor([1, 2])},
                                torch.Generator().manual_seed(4),
                                sample=False)
        out[dev.type] = (tok.cpu(), models.vqvae.decode(tok).cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=2e-4,
                               atol=2e-4)
