"""CLIP ViT-B/32's text tower and its BPE tokenizer (edgeyolo_tpu/nn/clip_text.py).

YOLO-World's `set_classes` encodes class-name strings with OpenAI CLIP's text
transformer. Neither CLIP's weights nor its BPE vocabulary ship with the
package: `load_clip_text` takes a torch-keyed npz of the text tower and
`ClipBPETokenizer` the merges file (bpe_simple_vocab_16e6.txt.gz) by path.

Tower: token_embedding (49408, 512) + positional_embedding (77, 512), 12
pre-LayerNorm blocks (8 heads, causal mask, a 4x MLP with QuickGELU), the
final LayerNorm, the features at the EOT token (the largest id of each
row), text_projection (512 x 512), L2-normalised. Parameter names are CLIP's
own state_dict keys (`transformer.resblocks.{i}.attn.in_proj_weight`, ...).
Attention is plain matmuls and a softmax: queries scaled by 1/sqrt(64)
before the product, masked positions at the dtype's lowest value, as flax's
SelfAttention computes it.

The tokenizer is CLIP's byte-level BPE. CLIP splits words with the `regex`
module's pattern (letters `\\p{L}+`, one digit `\\p{N}`, runs of anything
else but whitespace, and the contractions 's 't 're 've 'm 'll 'd); this
copy splits by Unicode categories (unicodedata) with the same alternatives
in the same order, and needs no `regex`.
"""

from __future__ import annotations

import gzip
import html
import unicodedata
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.transformer import layer_norm
from edgeyolo_tpu_torch.utils import select_device

CONTEXT = 77
VOCAB = 49408
WIDTH = 512
HEADS = 8
LAYERS = 12
_SPECIAL = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return {(a, b) for a, b in zip(word, word[1:])}


def _kind(ch: str) -> str:
    """'L' for a letter, 'N' for a number, ' ' for whitespace, else 'P'."""
    if ch.isspace():
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "P"


def split_words(text: str) -> list[str]:
    """CLIP's pre-tokenizer pattern, matched left to right (re.findall's
    order of alternatives): a special token, a contraction, a run of
    letters, one number character, or a run of characters that are neither
    letters, numbers nor whitespace; whitespace separates."""
    out, i, n = [], 0, len(text)
    while i < n:
        sp = next((s for s in _SPECIAL if text.startswith(s, i)), None)
        if sp is None:
            sp = next((c for c in _CONTRACTIONS if text[i:i + len(c)].lower() == c), None)
        if sp is not None:
            out.append(text[i:i + len(sp)])
            i += len(sp)
            continue
        k = _kind(text[i])
        if k == " ":
            i += 1
            continue
        j = i + 1
        if k != "N":
            while j < n and _kind(text[j]) == k:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class ClipBPETokenizer:
    """CLIP's byte-level BPE over a merges file (bpe_simple_vocab_16e6.txt.gz;
    not shipped: pass its path)."""

    def __init__(self, bpe_path: str | Path):
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(_bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(_SPECIAL)
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.cache = {s: s for s in _SPECIAL}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        """Token ids of one string: html-unescaped twice, whitespace
        collapsed, lower-cased (CLIP also runs ftfy, which only changes
        non-ASCII mojibake; JAX's copy skips it too)."""
        text = html.unescape(html.unescape(text))
        text = " ".join(text.split()).strip().lower()
        ids = []
        for token in split_words(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def tokenize(self, texts: list[str], context: int = CONTEXT) -> np.ndarray:
        """(len(texts), context) int32: SOT, the ids (cut to context - 2), EOT, zeros."""
        sot, eot = self.encoder[_SPECIAL[0]], self.encoder[_SPECIAL[1]]
        out = np.zeros((len(texts), context), np.int32)
        for i, t in enumerate(texts):
            ids = [sot] + self.encode(t)[: context - 2] + [eot]
            out[i, : len(ids)] = ids
        return out


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj, out_proj)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).view(
            b, n, 3, self.heads, hd).unbind(2)
        a = torch.einsum("bnhd,bmhd->bhnm", q / hd ** 0.5, k)
        a = a.masked_fill(~mask, torch.finfo(a.dtype).min).softmax(dim=-1)
        return self.out_proj(torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(b, n, c))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x, mask):
        x = x + self.attn(layer_norm(self.ln_1, x), mask)
        return x + self.mlp(layer_norm(self.ln_2, x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(layers))


class ClipTextModel(nn.Module):
    """CLIP's text encoder: tokens (B, 77) int -> (B, 512) L2-normalised f32."""

    def __init__(self, width: int = WIDTH, heads: int = HEADS, layers: int = LAYERS,
                 vocab: int = VOCAB, context: int = CONTEXT, seed: int = 0):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, width)
        self.positional_embedding = nn.Parameter(torch.empty(context, width))
        self.transformer = _Transformer(width, heads, layers)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, width))
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():  # JAX's initialisers: normal(0.02), (0.01), (width^-0.5)
            self.token_embedding.weight.normal_(0, 0.02, generator=g)
            self.positional_embedding.normal_(0, 0.01, generator=g)
            self.text_projection.normal_(0, width ** -0.5, generator=g)
            for blk in self.transformer.resblocks:
                for w in (blk.attn.in_proj_weight, blk.attn.out_proj.weight,
                          blk.mlp.c_fc.weight, blk.mlp.c_proj.weight):
                    w.uniform_(-w.shape[1] ** -0.5, w.shape[1] ** -0.5, generator=g)
                for bias in (blk.attn.out_proj.bias, blk.mlp.c_fc.bias, blk.mlp.c_proj.bias):
                    bias.zero_()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        n = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:n]
        causal = torch.ones(n, n, dtype=torch.bool, device=tokens.device).tril()
        for blk in self.transformer.resblocks:
            x = blk(x, causal)
        x = layer_norm(self.ln_final, x)
        eot = tokens.argmax(dim=-1)  # the first of the row's largest id
        feats = x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection
        feats = feats.float()
        return feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-12)


def convert_clip_text_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """A CLIP state_dict (the whole model's, `transformer.resblocks.N...`,
    or a text-only dump whose embeddings may lack their `.weight`) -> the
    text tower's state_dict; the image tower's keys are left out."""
    def g(*names):
        for name in names:
            if name in sd:
                return torch.as_tensor(np.asarray(sd[name], np.float32))
        raise KeyError(names)

    out = {"token_embedding.weight": g("token_embedding.weight", "token_embedding"),
           "positional_embedding": g("positional_embedding"),
           "text_projection": g("text_projection"),
           "ln_final.weight": g("ln_final.weight"), "ln_final.bias": g("ln_final.bias")}
    for i in range(LAYERS):
        pre = f"transformer.resblocks.{i}."
        for name in ("ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias",
                     "attn.in_proj_weight", "attn.in_proj_bias", "attn.out_proj.weight",
                     "attn.out_proj.bias", "mlp.c_fc.weight", "mlp.c_fc.bias",
                     "mlp.c_proj.weight", "mlp.c_proj.bias"):
            out[pre + name] = g(pre + name)
    return out


def load_clip_text(npz_path: str | Path, device: str | torch.device | None = None) -> ClipTextModel:
    """The text tower with the weights of a torch-keyed npz, in eval mode, on
    CUDA unless `device` names another device."""
    m = ClipTextModel()
    m.load_state_dict(convert_clip_text_state_dict(dict(np.load(npz_path))))
    return m.to(select_device(device)).eval()
