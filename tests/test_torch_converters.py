"""The port's converters of the reference's torch checkpoints (ROADMAP item
[1]) against the JAX package's, on the reference-keyed state dicts the JAX
converter tests build from their torch twins.

For each of the five: the port's state dict equals the JAX converter's
tree through the flax bridge (``from_flax``) bit for bit, key for key,
with no key left over; the port's module on it matches the twin's
eval-mode forward (the twins of ``tests/test_{vqvae,d3pm,resnet}_converter.py``
and ``tests/test_clip_text.py``; their LayerNorms take the port's epsilon,
flax's 1e-6, so that the comparison is of the mapping; the pytorch-i3d
twin is not in the repository, so the I3D is held to the flax I3D on the
JAX converter's weights, at ``tests/test_torch_i3d.py``'s bound); each
``_file`` function reads a checkpoint written as Lightning writes one, its
hyper-parameters objects of a class no loader can import; and a file with
no state dict of tensors raises, naming where it looked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from gif_synthesis_with_discrete_diffusion_tpu.convert import (
    torch_clip as jclip, torch_d3pm as jd3pm, torch_i3d as ji3d_conv,
    torch_resnet as jresnet, torch_vqvae as jvqvae)
from gif_synthesis_with_discrete_diffusion_tpu.models import i3d as ji3d
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert import (
    common, torch_clip, torch_d3pm, torch_i3d, torch_resnet, torch_vqvae)
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict, vqvae_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import (
    clip_text, denoiser, i3d, resnet, vqvae)
from tests import test_clip_text as clip_twin
from tests import test_d3pm_converter as d3pm_twin
from tests import test_resnet_converter as resnet_twin
from tests import test_vqvae_converter as vqvae_twin
from tests.test_torch_i3d import TOL as I3D_TOL

import chip_smoke

FWD_TOL = 1e-5


def _numpy(module: nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _flax_eps(module: nn.Module) -> nn.Module:
    for m in module.modules():
        if isinstance(m, nn.LayerNorm):
            m.eps = 1e-6
    return module


def _bitwise(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def _close(got: torch.Tensor, want: torch.Tensor, tol: float) -> None:
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale


@pytest.fixture(scope="module")
def sds():
    """{name: (twin, reference-keyed numpy state dict)}."""
    torch.manual_seed(0)
    out = {}
    vq = vqvae_twin._TorchVQVAE().eval()
    for m in vq.modules():
        if isinstance(m, nn.BatchNorm3d):
            m.running_mean.normal_(0, 0.05)
            m.running_var.uniform_(0.8, 1.2)
    out["vqvae"] = (vq, _numpy(vq))
    d3 = _flax_eps(d3pm_twin._Twin().eval())
    sd = _numpy(d3)
    sd["Lt_history"] = np.random.default_rng(0).random(
        d3pm_twin.T).astype(np.float32)
    sd["Lt_count"] = np.arange(d3pm_twin.T, dtype=np.float32)
    out["d3pm"] = (d3, sd)
    rn = resnet_twin._TorchResNet50().eval()
    with torch.no_grad():
        for m in rn.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.02)
                m.running_var.uniform_(0.5, 1.5)
    out["resnet"] = (rn, _numpy(rn))
    out["i3d"] = (None, _i3d_reference_sd(np.random.default_rng(1)))
    cl = _flax_eps(clip_twin._TorchTextTower().eval())
    out["clip"] = (cl, _clip_reference_sd(cl))
    return out


def _i3d_reference_sd(rng) -> dict:
    """pytorch-i3d's key layout (``<unit>.conv3d.weight``, ``<unit>.bn.*``,
    ``logits.conv3d.{weight,bias}``) at the shapes of a 10-class I3D."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  i3d.InceptionI3d(num_classes=10).state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        unit, leaf = k.rsplit(".", 1)
        if not unit.endswith(".bn") and leaf in ("weight", "bias"):
            k = f"{unit}.conv3d.{leaf}"
        v = rng.standard_normal(shape).astype(np.float32)
        if leaf == "running_var":
            v = (0.75 + 0.5 * rng.random(shape)).astype(np.float32)
        elif leaf == "weight" and len(shape) == 5:
            v *= np.float32(1.0 / np.sqrt(np.prod(shape[1:])))
        elif leaf in ("running_mean", "bias"):
            v *= np.float32(0.1)
        elif leaf == "weight":
            v = (1.0 + 0.1 * v).astype(np.float32)
        sd[k] = v
    return sd


def _clip_reference_sd(ref) -> dict:
    sd = {"token_embedding.weight": ref.token_embedding.weight,
          "positional_embedding": ref.positional_embedding,
          "ln_final.weight": ref.ln_final.weight,
          "ln_final.bias": ref.ln_final.bias,
          "text_projection": ref.text_projection}
    for i, blk in enumerate(ref.resblocks):
        p = f"transformer.resblocks.{i}"
        sd.update({
            f"{p}.attn.in_proj_weight": blk.attn.in_proj_weight,
            f"{p}.attn.in_proj_bias": blk.attn.in_proj_bias,
            f"{p}.attn.out_proj.weight": blk.attn.out_proj.weight,
            f"{p}.attn.out_proj.bias": blk.attn.out_proj.bias,
            f"{p}.mlp.c_fc.weight": blk.mlp.c_fc.weight,
            f"{p}.mlp.c_fc.bias": blk.mlp.c_fc.bias,
            f"{p}.mlp.c_proj.weight": blk.mlp.c_proj.weight,
            f"{p}.mlp.c_proj.bias": blk.mlp.c_proj.bias})
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"] = getattr(blk, ln).weight
            sd[f"{p}.{ln}.bias"] = getattr(blk, ln).bias
    return {k: v.detach().numpy() for k, v in sd.items()}


def _clip_kw():
    return dict(width=clip_twin.W, heads=clip_twin.HEADS,
                layers=clip_twin.LAYERS)


def _jax_vqvae(sd):
    return vqvae_state_dict(**jvqvae.convert_vqvae(sd, vqvae_twin.NRES))


def _jax_d3pm(sd):
    t = jd3pm.convert_d3pm(sd)
    return flax_to_state_dict(t["params"], buffers=t["diffusion"])


# the port's converter, and the JAX converter's tree through the bridge
PAIRS = {
    "vqvae": (lambda sd: torch_vqvae.convert_vqvae(sd, vqvae_twin.NRES),
              _jax_vqvae),
    "d3pm": (torch_d3pm.convert_d3pm, _jax_d3pm),
    "resnet": (torch_resnet.convert_resnet50,
               lambda sd: flax_to_state_dict(
                   **jresnet.convert_resnet50(sd))),
    "i3d": (torch_i3d.convert_i3d,
            lambda sd: flax_to_state_dict(**ji3d_conv.convert_i3d(sd))),
    "clip": (lambda sd: torch_clip.convert_clip_text(sd, **_clip_kw()),
             lambda sd: flax_to_state_dict(
                 jclip.convert_clip_text(sd, **_clip_kw()))),
}
FILES = {
    "vqvae": lambda p: torch_vqvae.convert_vqvae_file(p, vqvae_twin.NRES),
    "d3pm": torch_d3pm.convert_d3pm_file,
    "resnet": torch_resnet.convert_resnet50_file,
    "i3d": torch_i3d.convert_i3d_file,
    "clip": lambda p: torch_clip.convert_clip_text_file(p, **_clip_kw()),
}
# the prefix each reference checkpoint carries its state dict under
PREFIX = {"vqvae": "generator.", "d3pm": "generator.diffusion_model.",
          "resnet": "", "i3d": "", "clip": ""}


@pytest.mark.parametrize("name", list(PAIRS))
def test_converter_equals_jax_converter_through_the_bridge(sds, name):
    sd = sds[name][1]
    port, jax_bridged = PAIRS[name]
    _bitwise(port(sd), jax_bridged(sd))


def _lightning_ckpt(path, state_dict: dict, prefix: str) -> None:
    chip_smoke.save_reference_file(
        path, {k: torch.from_numpy(v) for k, v in state_dict.items()},
        prefix, lightning=True)


@pytest.mark.parametrize("name", list(PAIRS))
def test_file_reads_a_lightning_checkpoint(sds, name, tmp_path):
    sd = sds[name][1]
    path = tmp_path / f"{name}.ckpt"
    _lightning_ckpt(path, sd, PREFIX[name])
    _bitwise(FILES[name](str(path)), PAIRS[name][0](sd))


def test_a_file_without_tensors_raises(tmp_path):
    empty = tmp_path / "empty.ckpt"
    _lightning_ckpt(empty, {}, "")
    with pytest.raises(ValueError, match="'state_dict'"):
        common.load_torch_state_dict(empty)
    scalars = tmp_path / "scalars.pt"
    torch.save({"epoch": 3, "lr": 0.1}, scalars)
    with pytest.raises(ValueError, match="no state_dict of tensors"):
        torch_i3d.convert_i3d_file(str(scalars))
    mixed = tmp_path / "mixed.pt"
    torch.save({"state_dict": {"w": torch.ones(2), "cfg": "adam"}}, mixed)
    with pytest.raises(ValueError, match="'cfg'"):
        common.load_torch_state_dict(mixed)
    junk = tmp_path / "junk.pt"
    junk.write_bytes(b"weights")
    with pytest.raises(ValueError, match="not a torch checkpoint"):
        common.load_torch_state_dict(junk)


def test_vqvae_on_converted_weights_matches_the_twin(sds):
    twin, sd = sds["vqvae"]
    model = vqvae.VQVAE(embedding_dim=vqvae_twin.EMB,
                        n_codes=vqvae_twin.CODES, n_hiddens=vqvae_twin.H,
                        n_res_layers=vqvae_twin.NRES,
                        downsample=vqvae_twin.DOWNSAMPLE,
                        sequence_length=vqvae_twin.SEQ,
                        resolution=vqvae_twin.RES, kernel_mode="xla").eval()
    model.load_state_dict(torch_vqvae.convert_vqvae(sd, vqvae_twin.NRES))
    x = np.random.default_rng(1).standard_normal(
        (2, vqvae_twin.SEQ, vqvae_twin.RES, vqvae_twin.RES, 3)).astype(
        np.float32)
    with torch.no_grad():
        idx, recon = twin(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        codes = model.encode(torch.from_numpy(x))
        got = model.decode(codes)
    assert torch.equal(codes.long(), idx)
    _close(got, recon.permute(0, 2, 3, 4, 1), FWD_TOL)


def test_denoiser_on_converted_weights_matches_the_twin(sds):
    twin, sd = sds["d3pm"]
    t = d3pm_twin
    model = denoiser.DenoiserTransformer(
        num_embed=t.KCODES, spatial_size=t.SPATIAL, n_layer=t.NL, n_embd=t.C,
        n_head=t.NH, condition_dim=t.CD, diffusion_step=t.T).eval()
    conv = torch_d3pm.convert_d3pm(sd)
    prefix = "diffusion.transformer."
    model.load_state_dict({k[len(prefix):]: v for k, v in conv.items()
                           if k.startswith(prefix)})
    assert torch.equal(conv["diffusion.lt_count"],
                       torch.from_numpy(sd["Lt_count"]))
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, t.KCODES + 1, (2, t.L)))
    cond = torch.from_numpy(rng.standard_normal((2, 3, t.CD)).astype(
        np.float32))
    steps = torch.tensor([1, 7])
    with torch.no_grad():
        _close(model(tokens, cond, steps), twin(tokens, cond, steps),
               FWD_TOL)


def test_resnet_on_converted_weights_matches_the_twin(sds):
    twin, sd = sds["resnet"]
    model = resnet.ResNet50().eval()
    model.load_state_dict(torch_resnet.convert_resnet50(sd), strict=True)
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        want = twin(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got, want, FWD_TOL)


def test_clip_tower_on_converted_weights_matches_the_twin(sds):
    twin, sd = sds["clip"]
    c = clip_twin
    model = clip_text.ClipTextModel(vocab_size=c.VOCAB, context_length=c.CTX,
                                    width=c.W, heads=c.HEADS,
                                    layers=c.LAYERS, embed_dim=c.W).eval()
    model.load_state_dict(torch_clip.convert_clip_text(sd, **_clip_kw()))
    tokens = np.random.default_rng(4).integers(1, c.VOCAB - 1, (3, c.CTX))
    tokens[:, -1] = c.VOCAB - 1
    with torch.no_grad():
        _close(model(torch.from_numpy(tokens)),
               twin(torch.from_numpy(tokens)), FWD_TOL)


def test_i3d_on_converted_weights_matches_flax_on_jax_converted(sds):
    sd = sds["i3d"][1]
    model = i3d.InceptionI3d(num_classes=10).eval()
    model.load_state_dict(torch_i3d.convert_i3d(sd), strict=True)
    x = np.random.default_rng(5).standard_normal((1, 8, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(ji3d.InceptionI3d(num_classes=10).apply)(
        ji3d_conv.convert_i3d(sd), jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=I3D_TOL * np.abs(want).max())


def _port_models():
    """Port modules at small widths with seeded weights, each kind's."""
    import argparse

    from gif_synthesis_with_discrete_diffusion_tpu_torch.generate import (
        build_models)
    from gif_synthesis_with_discrete_diffusion_tpu_torch.probes import (
        parity_fvd)
    args = argparse.Namespace(
        embedding_dim=8, codes=16, hiddens=16, res_layers=2,
        downsample=(1, 4, 4), frames=2, resolution=16, steps=4,
        guidance=2.0, layers=2, embd=16, heads=4, cond_dim=32)
    m = build_models(parity_fvd._config(args), "cpu",
                     torch.Generator().manual_seed(3))
    m.vqvae.codebook.initialized.fill_(True)   # as a converted codebook
    tower = clip_text.ClipTextModel(width=32, heads=4, layers=2,
                                    embed_dim=32)
    with torch.no_grad():
        for p in tower.parameters():
            p.normal_(generator=torch.Generator().manual_seed(p.numel()))
    gen = torch.Generator().manual_seed(1)
    return {"vqvae": m.vqvae.state_dict(), "d3pm": m.generator.state_dict(),
            "i3d": chip_smoke._i3d(gen).state_dict(),
            "resnet": chip_smoke._resnet50(gen).state_dict(),
            "clip": tower.state_dict()}


@pytest.mark.parametrize("kind", list(PAIRS))
def test_reference_names_of_port_weights_convert_back_bitwise(kind):
    """``chip_smoke._reference_keyed`` (the reference-named files of phase
    19 and of the parity_fvd test) inverts each converter exactly."""
    sd = _port_models()[kind]
    ref = {k: v.numpy() for k, v in
           chip_smoke._reference_keyed(kind, sd).items()}
    convert = {"vqvae": lambda d: torch_vqvae.convert_vqvae(d, 2),
               "d3pm": torch_d3pm.convert_d3pm,
               "i3d": torch_i3d.convert_i3d,
               "resnet": torch_resnet.convert_resnet50,
               "clip": lambda d: torch_clip.convert_clip_text(
                   d, width=32, heads=4, layers=2)}[kind]
    want = {k: v for k, v in sd.items()
            if kind != "d3pm" or (k.startswith("diffusion.") and not
                                  k.endswith(("diffusion_acc",
                                              "diffusion_keep")))}
    _bitwise(convert(ref), want)
