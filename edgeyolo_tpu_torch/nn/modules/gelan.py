"""The YOLOv9 (GELAN) blocks, NCHW (edgeyolo_tpu/nn/modules/extra.py, v9 family).

- RepConv / RepNBottleneck / RepNCSP: the training form of the
  re-parameterisable 3x3 + 1x1 pair (no fuse: JAX has none), its bottleneck
  and the C3 built from it.
- RepNCSPELAN4 / ELAN1: the GELAN aggregation blocks.
- AConv / ADown: downsampling after a 2 x 2 stride-1 average pool padded by
  one zero row and column at the bottom and right, the padded zeros counted
  in the mean (flax `avg_pool`'s count_include_pad), as JAX pads it (the
  reference's pool is unpadded).
- SPPELAN: a 1x1 conv, three chained stride-1 max pools, fused.
- CBLinear / CBFuse: yolov9e's auxiliary branch. CBLinear emits a tuple of
  channel groups (the parser's channel list holds the tuple); CBFuse sums the
  selected groups, resized to its last input by JAX's nearest rule
  (`nearest_resize`), which equals torch's "nearest" only at integer factors.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.block import C3
from edgeyolo_tpu_torch.nn.modules.conv import ConvBN, activation, autopad, batch_norm, norm_f32
from edgeyolo_tpu_torch.ops.resize import nearest_resize


def avg_pool_pad_br(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 stride-1 average pool over x padded with one zero row and column
    at the bottom and right, the zeros counted: the output keeps x's size."""
    return F.avg_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)


class RepConv(nn.Module):
    """3x3 and 1x1 convs (each + BN, no act) summed, plus an identity
    BatchNorm when `bn`, c1 == c2 and s == 1, then the activation."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 act: bool | str = True, bn: bool = False):
        super().__init__()
        self.conv1 = ConvBN(c1, c2, k, s, None, g, act=False)
        self.conv2 = ConvBN(c1, c2, 1, s, None, g, act=False)
        self.bn = batch_norm(c1) if bn and c1 == c2 and s == 1 else None
        self.act = activation(act)

    def forward(self, x):
        out = self.conv1(x) + self.conv2(x)
        if self.bn is not None:
            out = out + norm_f32(self.bn, x)
        return self.act(out) if self.act else out


class RepNBottleneck(nn.Module):
    """RepConv then a 3x3 conv, with a residual when `shortcut` and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = RepConv(c1, c_, 3, 1)
        self.cv2 = ConvBN(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepNCSP(C3):
    """C3 whose inner blocks are RepNBottlenecks (expansion 1)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e,
                         block=lambda c: RepNBottleneck(c, c, shortcut, g, 1.0))


class _Elan(nn.Module):
    """Split cv1's output in two, append cv2 of the last piece and cv3 of
    that, fuse all four with cv4."""

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, dim=1))
        y.append(self.cv2(y[-1]))
        y.append(self.cv3(y[-1]))
        return self.cv4(torch.cat(y, dim=1))


class RepNCSPELAN4(_Elan):
    """GELAN: the two appended chains are RepNCSP + 3x3 conv."""

    def __init__(self, c1: int, c2: int, c3: int = 0, c4: int = 0, n: int = 1):
        super().__init__()
        self.cv1 = ConvBN(c1, c3, 1)
        self.cv2 = nn.Sequential(RepNCSP(c3 // 2, c4, n), ConvBN(c4, c4, 3, 1))
        self.cv3 = nn.Sequential(RepNCSP(c4, c4, n), ConvBN(c4, c4, 3, 1))
        self.cv4 = ConvBN(c3 + 2 * c4, c2, 1)


class ELAN1(_Elan):
    """Light ELAN: the two appended chains are single 3x3 convs."""

    def __init__(self, c1: int, c2: int, c3: int = 0, c4: int = 0):
        super().__init__()
        self.cv1 = ConvBN(c1, c3, 1)
        self.cv2 = ConvBN(c3 // 2, c4, 3, 1)
        self.cv3 = ConvBN(c4, c4, 3, 1)
        self.cv4 = ConvBN(c3 + 2 * c4, c2, 1)


class AConv(nn.Module):
    """Padded 2 x 2 average pool, then a 3x3 stride-2 conv."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 3, 2, 1)

    def forward(self, x):
        return self.cv1(avg_pool_pad_br(x))


class ADown(nn.Module):
    """Padded 2 x 2 average pool; one half through a 3x3 stride-2 conv, the
    other through a 3 x 3 stride-2 max pool and a 1x1 conv; concatenated."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        c = c2 // 2
        self.cv1 = ConvBN(c1 // 2, c, 3, 2, 1)
        self.cv2 = ConvBN(c1 // 2, c, 1, 1, 0)

    def forward(self, x):
        x1, x2 = avg_pool_pad_br(x).chunk(2, dim=1)
        return torch.cat([self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))], dim=1)


class SPPELAN(nn.Module):
    """A 1x1 conv to c3 channels, three chained k x k stride-1 max pools,
    all four concatenated and fused by a 1x1 conv."""

    def __init__(self, c1: int, c2: int, c3: int = 0, k: int = 5):
        super().__init__()
        self.cv1 = ConvBN(c1, c3, 1)
        self.cv5 = ConvBN(4 * c3, c2, 1)
        self.k = k

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv5(torch.cat(y, dim=1))


class CBLinear(nn.Module):
    """A k x k conv (with bias) to sum(c2s) channels, split into a tuple of
    groups of the sizes c2s."""

    def __init__(self, c1: int, c2s: Sequence[int], k: int = 1, s: int = 1):
        super().__init__()
        self.c2s = tuple(c2s)
        self.conv = nn.Conv2d(c1, sum(self.c2s), k, s, autopad(k), bias=True)

    def forward(self, x):
        return self.conv(x).split(self.c2s, dim=1)


class CBFuse(nn.Module):
    """The last input plus group idx[i] of each earlier (CBLinear) input,
    each nearest-resized to the last input's size."""

    def __init__(self, idx: Sequence[int] = ()):
        super().__init__()
        self.idx = tuple(idx)

    def forward(self, xs):
        target = xs[-1]
        acc = target
        for i, x in enumerate(xs[:-1]):
            sel = x[self.idx[i]] if isinstance(x, (tuple, list)) else x
            acc = acc + nearest_resize(sel, target.shape[-2:])
        return acc
