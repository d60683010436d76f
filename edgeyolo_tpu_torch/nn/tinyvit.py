"""TinyViT, MobileSAM's image encoder (edgeyolo_tpu/nn/tinyvit.py), NCHW.

Conv2dBN (a bias-free conv and BatchNorm), a stride-4 patch embedding, a
stage of MBConv blocks, PatchMerging between stages (its depthwise conv at
stride 1 for 320, 448 and 576 channels), then window-attention stages with a
learned bias per (|dy|, |dx|) offset inside a window (TVAttention; windows
padded with zeros to whole windows), a depthwise local conv and an MLP per
block, and the 256-channel neck (1x1, LayerNorm2d, 3x3, LayerNorm2d).
MobileSAM's configuration: embed dims (64, 128, 160, 320), depths
(2, 2, 6, 2), heads (2, 4, 5, 10), windows (7, 7, 14, 7): 5,743,892
parameters. (B, 3, S, S) -> (B, 256, S/16, S/16).

Names are the reference's state_dict keys under `image_encoder.`
(`patch_embed.seq.{0,2}`, `layers.{i}.blocks.{j}`, `layers.{i}.downsample`,
`neck.{0..3}`), so the reference's own TinyViT state_dict loads strictly;
each attention's offset-index table is a buffer kept out of the state_dict.
BatchNorms take torch's defaults (eps 1e-5), as the reference and JAX's.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.transformer import layer_norm
from edgeyolo_tpu_torch.nn.sam import LayerNorm2d


class Conv2dBN(nn.Module):
    """conv (no bias) -> BatchNorm."""

    def __init__(self, a: int, b: int, ks: int = 1, stride: int = 1, pad: int = 0,
                 groups: int = 1):
        super().__init__()
        self.c = nn.Conv2d(a, b, ks, stride, pad, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(b)

    def forward(self, x):
        return self.bn(self.c(x))


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, dim: int):
        super().__init__()
        self.seq = nn.Sequential(Conv2dBN(in_chans, dim // 2, 3, 2, 1), nn.GELU(),
                                 Conv2dBN(dim // 2, dim, 3, 2, 1))

    def forward(self, x):
        return self.seq(x)


class MBConv(nn.Module):
    """1x1 expand, depthwise 3x3, 1x1 project; GELU between, residual, GELU after."""

    def __init__(self, c: int, out_chans: int, expand_ratio: float = 4.0):
        super().__init__()
        h = int(c * expand_ratio)
        self.conv1 = Conv2dBN(c, h, 1)
        self.conv2 = Conv2dBN(h, h, 3, 1, 1, groups=h)
        self.conv3 = Conv2dBN(h, out_chans, 1)

    def forward(self, x):
        y = F.gelu(self.conv2(F.gelu(self.conv1(x))))
        return F.gelu(self.conv3(y) + x)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        stride = 1 if out_dim in (320, 448, 576) else 2
        self.conv1 = Conv2dBN(dim, out_dim, 1)
        self.conv2 = Conv2dBN(out_dim, out_dim, 3, stride, 1, groups=out_dim)
        self.conv3 = Conv2dBN(out_dim, out_dim, 1)

    def forward(self, x):
        return self.conv3(F.gelu(self.conv2(F.gelu(self.conv1(x)))))


@lru_cache(maxsize=8)
def bias_idxs(res: int) -> np.ndarray:
    """(N, N) index of each (query, key) pair of a res x res window into the
    per-offset bias bank, offsets numbered in first-seen order."""
    points = list(itertools.product(range(res), range(res)))
    offsets: dict = {}
    idxs = []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            idxs.append(offsets.setdefault(off, len(offsets)))
    return np.asarray(idxs, np.int64).reshape(len(points), len(points))


class TVAttention(nn.Module):
    """Multi-head attention over window tokens (B, N, C) with learned biases."""

    def __init__(self, dim: int, key_dim: int, num_heads: int, resolution: int):
        super().__init__()
        self.nh, self.kd = num_heads, key_dim
        table = torch.from_numpy(bias_idxs(resolution))
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, num_heads * 3 * key_dim)
        self.proj = nn.Linear(num_heads * key_dim, dim)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, int(table.max()) + 1))
        self.register_buffer("attention_bias_idxs", table, persistent=False)

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = self.qkv(layer_norm(self.norm, x)).view(b, n, self.nh, 3 * self.kd).split(
            self.kd, dim=-1)
        ab = self.attention_biases[:, self.attention_bias_idxs]  # (nh, N, N)
        attn = torch.einsum("bnhk,bmhk->bhnm", q, k) * self.kd ** -0.5 + ab[None]
        out = torch.einsum("bhnm,bmhd->bnhd", attn.softmax(dim=-1), v)
        return self.proj(out.reshape(b, n, self.nh * self.kd))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(layer_norm(self.norm, x))))


class TinyViTBlock(nn.Module):
    """Window attention, a depthwise local conv and an MLP over NCHW maps."""

    def __init__(self, dim: int, num_heads: int, window_size: int, mlp_ratio: float = 4.0,
                 local_conv_size: int = 3):
        super().__init__()
        self.ws = window_size
        self.attn = TVAttention(dim, dim // num_heads, num_heads, window_size)
        self.local_conv = Conv2dBN(dim, dim, local_conv_size, 1, local_conv_size // 2,
                                   groups=dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, c, h, w = x.shape
        ws = self.ws
        t = x.permute(0, 2, 3, 1)  # (B, H, W, C)
        if h == ws and w == ws:
            a = self.attn(t.reshape(b, h * w, c)).view(b, h, w, c)
        else:
            pb, pr = (-h) % ws, (-w) % ws
            tp = F.pad(t, (0, 0, 0, pr, 0, pb))
            nh, nw = (h + pb) // ws, (w + pr) // ws
            wins = tp.view(b, nh, ws, nw, ws, c).transpose(2, 3).reshape(-1, ws * ws, c)
            a = self.attn(wins).view(b, nh, nw, ws, ws, c).transpose(2, 3)
            a = a.reshape(b, nh * ws, nw * ws, c)[:, :h, :w]
        x = self.local_conv((t + a).permute(0, 3, 1, 2))
        t = x.permute(0, 2, 3, 1)
        return (t + self.mlp(t)).permute(0, 3, 1, 2)


class _Layer(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module], downsample: nn.Module | None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x) if self.downsample is not None else x


class TinyViT(nn.Module):
    """MobileSAM's image encoder."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 160, 320),
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (2, 4, 5, 10),
                 window_sizes: Sequence[int] = (7, 7, 14, 7), mbconv_expand_ratio: float = 4.0):
        super().__init__()
        ed = embed_dims
        self.patch_embed = PatchEmbed(3, ed[0])
        layers = [_Layer([MBConv(ed[0], ed[0], mbconv_expand_ratio) for _ in range(depths[0])],
                         PatchMerging(ed[0], ed[1]))]
        for i in (1, 2, 3):
            layers.append(_Layer(
                [TinyViTBlock(ed[i], num_heads[i], window_sizes[i]) for _ in range(depths[i])],
                PatchMerging(ed[i], ed[i + 1]) if i < 3 else None))
        self.layers = nn.ModuleList(layers)
        self.neck = nn.Sequential(nn.Conv2d(ed[3], 256, 1, bias=False), LayerNorm2d(256, eps=1e-6),
                                  nn.Conv2d(256, 256, 3, padding=1, bias=False),
                                  LayerNorm2d(256, eps=1e-6))

    def forward(self, x):
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x)
        return self.neck(x)
