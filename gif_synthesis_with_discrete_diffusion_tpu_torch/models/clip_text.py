"""CLIP ViT-B/32 text encoder and its BPE tokenizer.

Port of ``gif_synthesis_with_discrete_diffusion_tpu/models/clip_text.py``:
tokenize with context length 22 zero-padded to 77, run the causal text
transformer, take the EOT-position feature through the text projection ->
(B, 512). The architecture is the public ViT-B/32 text tower: vocab 49408,
context 77, width 512, 8 heads, 12 pre-LN residual blocks with QuickGELU
(``h * sigmoid(1.702 h)``), ``ln_final`` and a 512 x 512 projection.

Two details follow the flax module, not OpenAI's: every LayerNorm takes
flax's default epsilon 1e-6 (OpenAI's is 1e-5), and the attention is flax's
``MultiHeadDotProductAttention`` in plain ops and in its order (q scaled by
1/sqrt(head dim), masked scores set to the dtype's minimum, the softmax in
f32). The JAX package has no kernel here; neither has the port.

Tokenizers: :class:`ClipTokenizer` reads CLIP's merges file
(``bpe_simple_vocab_16e6.txt.gz``); :class:`HashTokenizer` is the
deterministic stand-in without one. :func:`make_tokenizer` never fetches
anything: it reads the given path, then the JAX package's cache path if the
file is already there, else falls back to the hash tokenizer (or raises
under ``allow_hash=False``). ``regex`` and ``ftfy`` are imported when a
caption is first split or cleaned, each with the JAX package's fallback.
"""
from __future__ import annotations

import functools
import gzip
import hashlib
import html
import math
import re
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from .layers import parallel_mlp

__all__ = ["ClipTextModel", "ClipTextConditioner", "ClipTokenizer",
           "HashTokenizer", "make_tokenizer", "DEFAULT_BPE_PATH",
           "init_clip_text_"]

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
REF_CONTEXT_LENGTH = 22  # the reference tokenizes to 22, then pads to 77
_LN_EPS = 1e-6           # flax nn.LayerNorm's default

# where the JAX package caches the merges file; read only if it is there
DEFAULT_BPE_PATH = (Path.home() / ".cache" / "gsdd_tpu"
                    / "bpe_simple_vocab_16e6.txt.gz")


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------

def _bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    """ftfy's repair where the package is there, a double html unescape,
    whitespace collapsed, lower case (openai/CLIP's simple_tokenizer)."""
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


# CLIP's exact word pattern needs the \p{L} / \p{N} classes of the `regex`
# package; stdlib `re` takes ASCII classes, which split the UCF101 / MSRVTT
# caption corpora the same way
_CLIP_PAT_SRC = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")
_ASCII_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""")


@functools.cache
def word_pattern():
    """CLIP's word pattern under ``regex``, else :data:`_ASCII_PAT`."""
    try:
        import regex
    except ImportError:
        return _ASCII_PAT
    return regex.compile(_CLIP_PAT_SRC, regex.IGNORECASE)


def _pad_batch(encode, sot: int, eot: int, texts: Sequence[str],
               context_length: int, pad_to: int) -> np.ndarray:
    """[sot] + ids[:context_length - 2] + [eot], zero-padded, int32."""
    out = np.zeros((len(texts), pad_to), np.int32)
    for i, text in enumerate(texts):
        ids = [sot] + encode(text)[: context_length - 2] + [eot]
        out[i, : len(ids)] = ids
    return out


class ClipTokenizer:
    """CLIP's byte-level BPE over the standard merges file."""

    def __init__(self, bpe_path: str | Path):
        self.byte_encoder = _bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._bpe = functools.lru_cache(maxsize=16384)(self._bpe_word)

    def _bpe_word(self, token: str) -> tuple[str, ...]:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        return word

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for tok in word_pattern().findall(_basic_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok))
        return ids

    def __call__(self, texts: Sequence[str],
                 context_length: int = REF_CONTEXT_LENGTH,
                 pad_to: int = CONTEXT_LENGTH) -> np.ndarray:
        """Tokenize as the reference does: context 22, zero-padded to 77."""
        return _pad_batch(self.encode, self.sot, self.eot, texts,
                          context_length, pad_to)


class HashTokenizer:
    """Deterministic stand-in when no BPE merges file is present."""

    sot = VOCAB_SIZE - 2
    eot = VOCAB_SIZE - 1

    def encode(self, text: str) -> list[int]:
        ids = []
        for word in _basic_clean(text).split():
            h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4],
                               "little")
            ids.append(h % (VOCAB_SIZE - 2))
        return ids

    def __call__(self, texts: Sequence[str],
                 context_length: int = REF_CONTEXT_LENGTH,
                 pad_to: int = CONTEXT_LENGTH) -> np.ndarray:
        return _pad_batch(self.encode, self.sot, self.eot, texts,
                          context_length, pad_to)


def make_tokenizer(bpe_path: str | Path | None = None, *,
                   allow_hash: bool = True):
    """The exact CLIP tokenizer when a merges file is on disk: ``bpe_path``,
    else :data:`DEFAULT_BPE_PATH` if it exists. Otherwise
    :class:`HashTokenizer`, or, with ``allow_hash=False`` (text conditioning
    must not train on non-CLIP ids unasked), a ``RuntimeError``. Nothing is
    downloaded."""
    if bpe_path and Path(bpe_path).exists():
        return ClipTokenizer(bpe_path)
    if DEFAULT_BPE_PATH.exists():
        return ClipTokenizer(DEFAULT_BPE_PATH)
    if not allow_hash:
        raise RuntimeError(
            "No CLIP BPE merges file found (textencoder.bpe_path unset and "
            "no cached vocab). Text conditioning would fall back to the "
            "non-CLIP HashTokenizer; set textencoder.allow_hash_tokenizer: "
            "true to allow that, or provide textencoder.bpe_path.")
    return HashTokenizer()


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, biases on
    q / k / v / out): its ``(D, H, hd)`` kernels are the port's (H * hd, D)
    ``Linear`` weights."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)
        self.out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.heads
        q, k, v = (lin(x).reshape(b, s, self.heads, hd)
                   for lin in (self.query, self.key, self.value))
        q = q / math.sqrt(hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(o.reshape(b, s, d))


class ResBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=_LN_EPS)
        self.attn = MultiHeadAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=_LN_EPS)
        self.mlp_fc = nn.Linear(width, width * 4)
        self.mlp_proj = nn.Linear(width * 4, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        # QuickGELU; Megatron's form where the MLP is sharded
        return x + parallel_mlp(self.ln_2(x), self.mlp_fc, self.mlp_proj,
                                lambda h: h * torch.sigmoid(1.702 * h))


class ClipTextModel(nn.Module):
    """(B, 77) token ids -> pooled text features (B, embed_dim)."""

    def __init__(self, vocab_size: int = VOCAB_SIZE,
                 context_length: int = CONTEXT_LENGTH, width: int = 512,
                 heads: int = 8, layers: int = 12, embed_dim: int = 512):
        super().__init__()
        self.layers = layers
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        for i in range(layers):
            self.add_module(f"resblock{i}", ResBlock(width, heads))
        self.ln_final = nn.LayerNorm(width, eps=_LN_EPS)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        s = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[None, :s]
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=tokens.device).tril()
        for i in range(self.layers):
            x = getattr(self, f"resblock{i}")(x, causal)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)  # EOT has the largest id
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection


class ClipTextConditioner(nn.Module):
    """Frozen CLIP text tower -> (B, 1, dim) condition; the classifier-free
    branch embeds the tokenized empty caption ``cf_tokens`` (the hash
    tokenizer's when none are given, as the JAX package's offline
    fallback)."""

    def __init__(self, dim: int = 512, cf_tokens: Sequence[int] = (),
                 freeze: bool = True, width: int = 512, heads: int = 8,
                 layers: int = 12):
        super().__init__()
        self.freeze = freeze
        self.clip = ClipTextModel(embed_dim=dim, width=width, heads=heads,
                                  layers=layers)
        # (1, 77) ids on the host: a module built on the meta device and
        # materialised by ``to_empty`` keeps them
        self.cf_tokens = (np.array(cf_tokens, np.int64)[None]
                          if len(cf_tokens)
                          else make_tokenizer()([""]).astype(np.int64))
        if freeze:
            self.requires_grad_(False)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze):
            return self.clip(tokens)[:, None, :].float()

    def forward(self, batch: Mapping[str, Any], batch_size: int, *,
                with_cf: bool = True):
        """``batch["text_tokens"]`` (B, 77), numpy int32 or a tensor, moved to
        the module's device as int64 -> (cond, cf), each (B, 1, dim) f32;
        cf is None unless ``with_cf`` (a training step reads only cond, so
        the tower runs once)."""
        dev = self.clip.positional_embedding.device
        tokens = torch.as_tensor(batch["text_tokens"]).to(dev, torch.int64)
        cond = self._embed(tokens)
        if not with_cf:
            return cond, None
        cf = torch.from_numpy(self.cf_tokens).to(dev)
        return cond, self._embed(cf.expand(tokens.shape[0], -1))


@torch.no_grad()
def init_clip_text_(model: ClipTextModel, generator: torch.Generator
                    ) -> None:
    """The flax init laws: token embedding N(0, 1 / width) (``nn.Embed``'s
    default), positional embedding N(0, 0.01), projection N(0, 0.02); dense
    kernels lecun-normal (flax's ``nn.Dense`` default: N(0, 1 / fan_in),
    truncated at two standard deviations), zero biases; LayerNorm 1, 0."""
    width = model.token_embedding.embedding_dim
    model.token_embedding.weight.normal_(0.0, width ** -0.5,
                                         generator=generator)
    model.positional_embedding.normal_(0.0, 0.01, generator=generator)
    model.text_projection.normal_(0.0, 0.02, generator=generator)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            std = 1.0 / math.sqrt(m.in_features) / 0.87962566103423978
            w = torch.empty_like(m.weight, device="cpu")
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.weight.copy_(w)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
