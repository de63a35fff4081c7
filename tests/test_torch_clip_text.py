"""The PyTorch port's CLIP text tower and tokenizers vs the JAX package (CPU).

The tokenizers are held id for id (the toy merges file of
``tests/test_clip_text.py``, the hash tokenizer, both word patterns on the
caption corpora); ``ClipTextModel`` and ``ClipTextConditioner`` on random
flax weights carried over by ``convert/from_flax.py``, within 1e-5 of the
output's max-abs (f32 in two frameworks: the attention and the LayerNorms
reduce in other orders). No test here touches the network.
"""
import socket
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_synthesis_with_discrete_diffusion_tpu.models import (
    clip_text as jclip)
from gif_synthesis_with_discrete_diffusion_tpu_torch.convert.from_flax import (
    flax_to_state_dict)
from gif_synthesis_with_discrete_diffusion_tpu_torch.models import clip_text
from gif_synthesis_with_discrete_diffusion_tpu_torch.models.conditioning \
    import build_conditioner
from tests.test_clip_text import (MSRVTT_CAPTIONS, UCF_CAPTIONS,
                                  _write_toy_merges)

TOL = 1e-5
W, HEADS, LAYERS, DIM = 64, 4, 2, 32
CAPTIONS = UCF_CAPTIONS + MSRVTT_CAPTIONS + [
    "", "  the   dog  ", "café über &amp; naïve", "The player's 3 dogs!"]


def _redraw(rng, tree, scale=0.1):
    """Every leaf redrawn N(0, scale), LayerNorm scales around 1."""
    def draw(path, a):
        v = scale * rng.standard_normal(a.shape)
        if path[-1].key == "scale":
            v = 1.0 + v
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(tree))


def _tokens(rng, b):
    """Ids below the EOT id with EOT (the largest) at a different length
    per row, zero-padded after it, as the tokenizers give them."""
    tokens = np.zeros((b, clip_text.CONTEXT_LENGTH), np.int32)
    for i, n in enumerate(rng.integers(2, 22, b)):
        tokens[i, :n] = rng.integers(1, clip_text.VOCAB_SIZE - 2, n)
        tokens[i, n] = clip_text.VOCAB_SIZE - 1
    return tokens


def test_toy_merges_give_the_golden_and_the_jax_tokens(tmp_path):
    path = tmp_path / "merges.txt.gz"
    _write_toy_merges(path)
    tok, want = clip_text.ClipTokenizer(path), jclip.ClipTokenizer(path)
    # tests/test_clip_text.py::test_bpe_algorithm_golden's ids
    assert tok.encode("the") == [513] and tok.encode("dog") == [515]
    assert tok.encode("cat") == [ord("c") - 33, ord("a") - 33,
                                 256 + ord("t") - 33]
    assert (tok.sot, tok.eot) == (516, 517) == (want.sot, want.eot)
    for text in CAPTIONS:
        assert tok.encode(text) == want.encode(text), text
    got = tok(CAPTIONS)
    assert got.dtype == np.int32 and got.shape == (len(CAPTIONS), 77)
    np.testing.assert_array_equal(got, want(CAPTIONS))
    assert (got[:, 22:] == 0).all()


def test_hash_tokenizer_equals_jax():
    tok, want = clip_text.HashTokenizer(), jclip.HashTokenizer()
    np.testing.assert_array_equal(tok(CAPTIONS), want(CAPTIONS))
    np.testing.assert_array_equal(tok(CAPTIONS, 5, 9), want(CAPTIONS, 5, 9))


def test_both_word_patterns_split_as_jax_on_the_corpora():
    pat = clip_text.word_pattern()
    assert pat.pattern == jclip._WORD_PAT.pattern
    assert pat.findall("café über") == ["café", "über"]
    for caption in CAPTIONS:
        text = clip_text._basic_clean(caption)
        assert text == jclip._basic_clean(caption)
        assert pat.findall(text) == jclip._WORD_PAT.findall(text), caption
        assert clip_text._ASCII_PAT.findall(text) == \
            jclip._ASCII_PAT.findall(text), caption
    for caption in UCF_CAPTIONS + MSRVTT_CAPTIONS:
        text = clip_text._basic_clean(caption)
        assert clip_text._ASCII_PAT.findall(text) == pat.findall(text)


def test_make_tokenizer_order_and_strict_error(tmp_path, monkeypatch):
    missing = tmp_path / "absent.txt.gz"
    monkeypatch.setattr(clip_text, "DEFAULT_BPE_PATH", missing)
    with pytest.raises(RuntimeError, match="allow_hash_tokenizer"):
        clip_text.make_tokenizer(None, allow_hash=False)
    with pytest.raises(RuntimeError, match="allow_hash_tokenizer"):
        clip_text.make_tokenizer(missing, allow_hash=False)
    assert isinstance(clip_text.make_tokenizer(None),
                      clip_text.HashTokenizer)
    given = tmp_path / "given.txt.gz"
    _write_toy_merges(given)
    assert isinstance(clip_text.make_tokenizer(given, allow_hash=False),
                      clip_text.ClipTokenizer)
    # the cache path is read when it exists, and only then
    monkeypatch.setattr(clip_text, "DEFAULT_BPE_PATH", given)
    assert isinstance(clip_text.make_tokenizer(None, allow_hash=False),
                      clip_text.ClipTokenizer)


def test_no_network_is_touched(tmp_path, monkeypatch):
    calls = []

    def refuse(*a, **k):
        calls.append(a)
        raise OSError("network refused in this test")

    monkeypatch.setattr(socket, "socket", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setattr(clip_text, "DEFAULT_BPE_PATH",
                        tmp_path / "absent.txt.gz")
    assert isinstance(clip_text.make_tokenizer(None),
                      clip_text.HashTokenizer)
    with pytest.raises(RuntimeError):
        clip_text.make_tokenizer(tmp_path / "x.gz", allow_hash=False)
    cond = build_conditioner({"mode": "text", "dim": DIM, "width": W,
                              "heads": HEADS, "layers": 1,
                              "bpe_path": str(tmp_path / "x.gz"),
                              "allow_hash_tokenizer": False,
                              "clip_ckpt": None})
    np.testing.assert_array_equal(cond.cf_tokens,
                                  clip_text.HashTokenizer()([""]))
    assert not calls
    assert not hasattr(clip_text, "download_bpe_vocab")


def test_clip_text_model_matches_flax():
    rng = np.random.default_rng(0)
    model = jclip.ClipTextModel(width=W, heads=HEADS, layers=LAYERS,
                                embed_dim=DIM)
    tokens = _tokens(rng, 3)
    params = _redraw(rng, model.init(jax.random.key(0),
                                     jnp.asarray(tokens))["params"])
    want = np.asarray(jax.jit(lambda p, t: model.apply({"params": p}, t))(
        params, jnp.asarray(tokens)))
    port = clip_text.ClipTextModel(width=W, heads=HEADS, layers=LAYERS,
                                   embed_dim=DIM)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    assert port.ln_final.eps == 1e-6            # flax's, not OpenAI's 1e-5
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long()).numpy()
    assert got.shape == want.shape == (3, DIM)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_clip_text_conditioner_matches_flax():
    rng = np.random.default_rng(1)
    cf_tokens = tuple(int(i) for i in jclip.HashTokenizer()([""])[0])
    flax_cond = jclip.ClipTextConditioner(dim=DIM, cf_tokens=cf_tokens,
                                          width=W, heads=HEADS,
                                          layers=LAYERS)
    tokens = clip_text.HashTokenizer()(["a man is singing", "archery",
                                        "", "BreastStroke"])
    batch = {"text_tokens": jnp.asarray(tokens)}
    params = _redraw(rng, flax_cond.init(jax.random.key(0), batch,
                                         4)["params"])
    want_cond, want_cf = jax.jit(
        lambda p: flax_cond.apply({"params": p}, batch, 4))(params)
    port = build_conditioner({"mode": "text", "dim": DIM,
                              "cf_tokens": cf_tokens, "width": W,
                              "heads": HEADS, "layers": LAYERS})
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    assert not any(p.requires_grad for p in port.parameters())
    cond, cf = port({"text_tokens": tokens}, 4)
    for got, want in ((cond, want_cond), (cf, want_cf)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == (4, 1, DIM)
        assert got.grad_fn is None
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())
    # the training step's call: the tower once, no CF branch
    only, none = port({"text_tokens": torch.from_numpy(tokens)}, 4,
                      with_cf=False)
    assert none is None and torch.equal(only, cond)
