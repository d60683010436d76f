"""CSP blocks, SPPF and the DFL decode, NCHW (edgeyolo_tpu/nn/modules/block.py).

The C2f and C3 skeletons take a `block` factory for their inner blocks, which
is how C3k2, DSC3k and the wavelet variants swap the block family.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.conv import ConvBN


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
