"""Multi-scale linear attention and its DSC3K2 block, NCHW
(edgeyolo_tpu/nn/modules/msla_lgl.py).

MSLA splits the channels into four quarters, runs a 3/5/7/9 depthwise conv
on each, one LinearAttention shared by the four (its kernel on the card),
scales each result by a learned weight and fuses them with a 1x1 conv.
The four quarters go through the attention as one batch (concatenated on the
batch axis, the weights shared), so an MSLA is one qkv conv, one kernel
launch and one projection: the same per-sample arithmetic as four calls.

DSC3K2_MSLA adds out + tanh(gamma) * MSLA(out) to a DSC3K2 when c2 % 4 == 0;
gamma starts at 0, so a fresh block is a DSC3K2.
"""

from __future__ import annotations

import torch
from torch import nn

from edgeyolo_tpu_torch.nn.modules.conv import ConvBN
from edgeyolo_tpu_torch.nn.modules.edgeline import DSC3K2, LinearAttention

_KERNELS = (3, 5, 7, 9)


class MSLA(nn.Module):
    """Multi-scale linear attention over four channel quarters."""

    def __init__(self, dim: int, num_heads: int = 2):
        super().__init__()
        c4 = dim // 4
        for k in _KERNELS:
            setattr(self, f"dw_{k}x{k}", ConvBN(c4, c4, k, g=c4, act=False))
        self.linear_attention = LinearAttention(c4, max(1, min(num_heads, c4)))
        self.scale_weights = nn.Parameter(torch.ones(4))
        self.final_conv = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        b = x.shape[0]
        parts = [getattr(self, f"dw_{k}x{k}")(p) for k, p in zip(_KERNELS, x.chunk(4, dim=1))]
        outs = self.linear_attention(torch.cat(parts, dim=0)).split(b, dim=0)
        scale = self.scale_weights.to(x.dtype)
        return self.final_conv(torch.cat([o * scale[i] for i, o in enumerate(outs)], dim=1))


class DSC3K2_MSLA(DSC3K2):
    """DSC3K2 with a zero-init gated MSLA residual on its output."""

    def __init__(self, c1: int, c2: int, n: int = 1, dsc3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True, k1: int = 3, k2: int = 7, d2: int = 1,
                 num_heads: int = 2):
        super().__init__(c1, c2, n, dsc3k, e, g, shortcut, k1, k2, d2)
        self.msla = MSLA(c2, num_heads) if c2 % 4 == 0 else None
        self.gamma = nn.Parameter(torch.zeros(())) if self.msla is not None else None

    def forward(self, x):
        out = super().forward(x)
        if self.msla is None:
            return out
        return out + torch.tanh(self.gamma).to(out.dtype) * self.msla(out)
