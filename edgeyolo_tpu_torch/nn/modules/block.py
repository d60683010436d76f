"""CSP blocks, SPP and SPPF, SCDown, the PSA attention and the DFL decode,
NCHW (edgeyolo_tpu/nn/modules/block.py).

C1 is a plain CSP row no bundled YAML uses; JAX's C3x is C3 itself (its
bottlenecks 1 x 1, then 3 x 3), so the parser builds C3 for it.

The C2f and C3 skeletons take a `block` factory for their inner blocks, which
is how C3k2, DSC3k and the wavelet variants swap the block family.

Attention (in C2PSA, YOLO11's S32 stage, and PSA, YOLOv10's) is softmax attention over the H*W
tokens in plain PyTorch matmuls, as the JAX package leaves its einsums to
XLA: no TPU kernel stands behind it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.conv import ConvBN, ConvTranspose2d


class Bottleneck(nn.Module):
    """Two convs with an optional residual."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: Sequence[int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, k[0], 1)
        self.cv2 = ConvBN(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2(nn.Module):
    """CSP with 2 convs: split at cv1, a bottleneck stack on the first half."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * c, 1)
        self.cv2 = ConvBN(2 * c, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c, c, shortcut, g, (3, 3), 1.0) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        return self.cv2(torch.cat([self.m(a), b], dim=1))


class C2f(nn.Module):
    """Fast CSP: split, chain blocks on the running list, fuse.

    `block(c)` builds one inner block of width c; the default is a plain
    Bottleneck. `enhance_b` is the hook the wavelet variants override.
    """

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5, block: Callable[[int], nn.Module] | None = None):
        super().__init__()
        c = max(1, int(c2 * e))
        block = block or (lambda c_: Bottleneck(c_, c_, shortcut, g, (3, 3), 1.0))
        self.cv1 = ConvBN(c1, 2 * c, 1)
        self.cv2 = ConvBN((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(block(c) for _ in range(n))

    def enhance_b(self, b):
        return b

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        ys = [a, self.enhance_b(b)]
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, dim=1))


class C3(nn.Module):
    """CSP with 3 convs; `block(c_)` builds one inner block."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, block: Callable[[int], nn.Module] | None = None):
        super().__init__()
        c_ = int(c2 * e)
        block = block or (lambda c: Bottleneck(c, c, shortcut, g, (1, 3), 1.0))
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c1, c_, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1)
        self.m = nn.Sequential(*(block(c_) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class C1(nn.Module):
    """CSP with 1 conv: cv1, then n 3 x 3 ConvBNs, plus cv1's output."""

    def __init__(self, c1: int, c2: int, n: int = 1):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1)
        self.m = nn.Sequential(*(ConvBN(c2, c2, 3) for _ in range(n)))

    def forward(self, x):
        y = self.cv1(x)
        return self.m(y) + y


class C3k(C3):
    """C3 with k x k kernels in its bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: int = 3):
        super().__init__(c1, c2, n, shortcut, g, e,
                         block=lambda c: Bottleneck(c, c, shortcut, g, (k, k), 1.0))


class C3k2(C2f):
    """C2f whose blocks are C3k stacks or bottlenecks (shortcut defaults to True)."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True):
        block = ((lambda c: C3k(c, c, 2, shortcut, g)) if c3k
                 else (lambda c: Bottleneck(c, c, shortcut, g, (3, 3), 0.5)))
        super().__init__(c1, c2, n, shortcut, g, e, block=block)


class SPPF(nn.Module):
    """Fast SPP: three chained k x k stride-1 max pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c_ * 4, c2, 1)
        self.k = k

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, dim=1))


class SPP(nn.Module):
    """Spatial pyramid pooling: stride-1 max pools of the kernel sizes `k` in
    parallel."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c_ * (len(k) + 1), c2, 1)
        self.k = tuple(k)

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [F.max_pool2d(y, k, 1, k // 2) for k in self.k], dim=1))


class SCDown(nn.Module):
    """Separable downsample (YOLOv10): a 1x1 conv, then a k x k depthwise conv
    of stride s without activation."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1, 1)
        self.cv2 = ConvBN(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class Attention(nn.Module):
    """Self-attention over H*W tokens with a depthwise positional encoding.

    The qkv conv emits, per head, [q (key_dim) | k (key_dim) | v (head_dim)]
    channels; attention is softmax(q^T k / sqrt(key_dim)) over the keys, and
    a 3x3 depthwise conv of v is added before the projection.
    """

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = ConvBN(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv(x).view(b, self.num_heads, 2 * self.key_dim + self.head_dim, h * w)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = ((q.transpose(-2, -1) @ k) * self.scale).softmax(dim=-1)  # (b, heads, n, n)
        out = (v @ attn.transpose(-2, -1)).view(b, c, h, w)
        return self.proj(out + self.pe(v.reshape(b, c, h, w)))


class PSABlock(nn.Module):
    """x = x + Attention(x); x = x + FFN(x)."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int | None = None,
                 mlp_ratio: float = 2.0):
        super().__init__()
        heads = max(1, c // 64 if num_heads is None else int(num_heads))
        self.attn = Attention(c, heads, attn_ratio)
        hidden = int(c * mlp_ratio)
        self.ffn = nn.Sequential(ConvBN(c, hidden, 1), ConvBN(hidden, c, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    """CSP split with a stack of PSABlocks on one branch; c1 must equal c2."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError("C2PSA requires c1 == c2")
        c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * c, 1)
        self.m = nn.Sequential(*(PSABlock(c, 0.5, max(1, c // 64)) for _ in range(n)))
        self.cv2 = ConvBN(2 * c, c2, 1)

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        return self.cv2(torch.cat([a, self.m(b)], dim=1))


class PSA(nn.Module):
    """Position-sensitive attention (YOLOv10): a CSP split whose second half
    takes one attention and one FFN residual; c1 must equal c2."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError("PSA requires c1 == c2")
        c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * c, 1)
        self.cv2 = ConvBN(2 * c, c2, 1)
        self.attn = Attention(c, max(1, c // 64), 0.5)
        self.ffn = nn.Sequential(ConvBN(c, 2 * c, 1), ConvBN(2 * c, c, 1, act=False))

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat([a, b], dim=1))


class C2fPSA(C2f):
    """C2f whose inner blocks are PSABlocks."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, e=e, block=lambda c: PSABlock(c, 0.5, max(1, c // 64)))


class Proto(nn.Module):
    """The segment head's mask prototypes: a 3x3 conv, a 2 x 2 stride-2
    transposed conv (the reference's raw ConvTranspose2d: bias, no BatchNorm,
    no activation), a 3x3 conv and a 1x1 conv to the c2 prototypes."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = ConvBN(c1, c_, 3)
        self.upsample = ConvTranspose2d(c_, c_, 2, 2, 0)
        self.cv2 = ConvBN(c_, c_, 3)
        self.cv3 = ConvBN(c_, c2, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def dfl_decode(box_logits: torch.Tensor, bins: torch.Tensor | int = 16) -> torch.Tensor:
    """Distribution Focal integral: (..., 4*reg_max) logits -> expected ltrb (..., 4).

    `bins` is the bin-value vector (the head's frozen DFL weights) or reg_max,
    for the arange 0..reg_max-1 that the loss decodes with (JAX's dfl_decode).
    """
    if isinstance(bins, int):
        bins = torch.arange(bins, dtype=torch.float32, device=box_logits.device)
    reg_max = bins.numel()
    p = box_logits.unflatten(-1, (4, reg_max)).softmax(dim=-1)
    return p @ bins.to(p.dtype)


class DFL(nn.Module):
    """The reference's frozen DFL: a 1x1 conv whose weights are the bins 0..reg_max-1."""

    def __init__(self, reg_max: int = 16):
        super().__init__()
        self.conv = nn.Conv2d(reg_max, 1, 1, bias=False).requires_grad_(False)
        with torch.no_grad():
            self.conv.weight.copy_(torch.arange(reg_max, dtype=torch.float32).view(1, reg_max, 1, 1))

    def forward(self, box_logits):
        return dfl_decode(box_logits, self.conv.weight.view(-1))
