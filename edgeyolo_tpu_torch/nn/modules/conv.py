"""Convolution modules, NCHW (edgeyolo_tpu/nn/modules/conv.py): ConvBN and
its depthwise and separable forms, LightConv (RT-DETR's HGBlock), GhostConv,
Focus (space-to-depth, then a ConvBN), ConvTranspose (a transposed conv with
BatchNorm and activation), Index, CBAM (channel, then spatial attention),
and the raw torch layers a model YAML names (transposed conv, max pool, zero
pad).

Parameter names are the reference's torch state_dict keys (`conv`, `bn`,
`dw`, `pw`), so weights carried over from the JAX package land by name.

BatchNorm runs in f32 and casts back to the compute dtype, as the JAX
ConvBN does, so a bf16 model keeps f32 norm statistics. Every BatchNorm of a
detection model uses the reference's model-level override eps 1e-3 and
momentum 0.03 (torch convention; flax 0.97), not the torch defaults, and
updates its running variance in train mode as flax does (`BatchNorm2d`).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.activation import telu

MODEL_BN_EPS = 1e-3
MODEL_BN_MOMENTUM = 0.03

def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """'same' padding for stride 1 (floor behaviour for stride 2)."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


class BatchNorm2d(nn.BatchNorm2d):
    """torch BatchNorm2d whose train mode updates the running statistics as
    flax's BatchNorm does: with the biased batch variance (torch's update
    uses the unbiased one, n/(n-1) larger), as ra = 0.97 ra + 0.03 stat.
    It normalises with the batch statistics; eval mode is torch's.

    One statistics pass: torch's own train-mode update runs, on a copy of the
    running variance (autograd keeps that copy for the backward), and its
    variance increment is then scaled by (n-1)/n, in C-sized ops."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        rv = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, rv, self.weight, self.bias, True,
                         self.momentum, self.eps)
        with torch.no_grad():
            kept = self.running_var.mul_(1.0 - self.momentum)
            kept.add_((rv - kept) * ((n - 1) / n))
        return y


def batch_norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=MODEL_BN_EPS, momentum=MODEL_BN_MOMENTUM)


def norm_f32(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in f32, then back to the compute dtype; nothing for a
    BatchNorm that `fuse` folded into its conv (an nn.Identity)."""
    if isinstance(bn, nn.Identity):
        return x
    return bn(x.float()).to(x.dtype)


ACTIVATIONS = {"silu": F.silu, "relu": F.relu, "relu6": F.relu6, "sigmoid": torch.sigmoid,
               "tanh": torch.tanh, "telu": telu}
_DEFAULT_ACT = ["silu"]


@contextlib.contextmanager
def default_act(name: str):
    """The activation that `act=True` builds to inside the block: a model
    YAML's `activation:` override (ReLU in yolov6), which reaches every
    nested conv (SPPF's, the head's towers), as the reference's
    `Conv.default_act` and JAX's `default_act` scope do."""
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; known: {sorted(ACTIVATIONS)}")
    prev, _DEFAULT_ACT[0] = _DEFAULT_ACT[0], name
    try:
        yield
    finally:
        _DEFAULT_ACT[0] = prev


def activation(act: bool | str | None):
    """The model's default (SiLU unless `default_act` says otherwise) for
    True, none for False or None, or one of ACTIVATIONS by name."""
    if act is True:
        act = _DEFAULT_ACT[0]
    if act is False or act is None:
        return None
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be True, False, None or one of {sorted(ACTIVATIONS)}, "
                         f"got {act!r}")
    return ACTIVATIONS[act]


class ConvBN(nn.Module):
    """conv (no bias) -> BatchNorm -> activation."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act: bool | str = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = batch_norm(c2)
        self.act = activation(act)

    def forward(self, x):
        x = norm_f32(self.bn, self.conv(x))
        return self.act(x) if self.act else x


class DWConv(ConvBN):
    """Depthwise conv (+BN+act), groups = gcd(c1, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1,
                 act: bool | str = True):
        super().__init__(c1, c2, k, s, None, math.gcd(c1, c2), d, act)


class LightConv(nn.Module):
    """A 1x1 ConvBN without activation, then a k x k depthwise ConvBN with ReLU."""

    def __init__(self, c1: int, c2: int, k: int = 1):
        super().__init__()
        self.conv1 = ConvBN(c1, c2, 1, act=False)
        self.conv2 = DWConv(c2, c2, k, act="relu")

    def forward(self, x):
        return self.conv2(self.conv1(x))


class GhostConv(nn.Module):
    """Ghost convolution: a primary k x k conv to c2 / 2 channels, then a cheap
    5 x 5 depthwise conv of it, concatenated."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool | str = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBN(c1, c_, k, s, None, g, 1, act)
        self.cv2 = ConvBN(c_, c_, 5, 1, None, c_, 1, act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """The YAML's raw `nn.ConvTranspose2d` (with bias; no BatchNorm, no
    activation): weights `model.{i}.weight`, (c1, c2, k, k) as torch keeps
    them. JAX pads k == s, p == 0 to 'SAME', which is torch's output size
    in * s: the only case the model YAMLs use."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0):
        super().__init__(c1, c2, k, s, p, bias=True)


class ConvTranspose(nn.Module):
    """Transposed conv (bias only without BatchNorm) -> BatchNorm -> activation.

    JAX pads 'SAME' when p == 0 and k == s (output in * s, torch's padding
    0) and else pads the dilated input by p on each side, which is torch's
    padding k - 1 - p."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0, bn: bool = True,
                 act: bool | str = True):
        super().__init__()
        pad = 0 if (p == 0 and k == s) else k - 1 - p
        if pad < 0:
            raise ValueError(f"ConvTranspose: padding {p} > k - 1 = {k - 1} has no torch form")
        self.conv_transpose = nn.ConvTranspose2d(c1, c2, k, s, pad, bias=not bn)
        self.bn = batch_norm(c2) if bn else nn.Identity()
        self.act = activation(act)

    def forward(self, x):
        x = norm_f32(self.bn, self.conv_transpose(x))
        return self.act(x) if self.act else x


class Focus(nn.Module):
    """Space-to-depth by 2 (pixels (0, 0), (1, 0), (0, 1), (1, 1) of each 2 x 2
    cell as (row, column), stacked on channels), then a ConvBN (YOLOv5's stem)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, act: bool | str = True):
        super().__init__()
        self.conv = ConvBN(4 * c1, c2, k, s, p, g, 1, act)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                                    x[..., 1::2, 1::2]], dim=1))


class Index(nn.Module):
    """One tensor of a list input."""

    def __init__(self, c2: int = 0, index: int = 0):
        super().__init__()
        self.index = index

    def forward(self, xs):
        return xs[self.index]


class ChannelAttention(nn.Module):
    """x * sigmoid(fc(global mean of x)), fc a biased 1x1 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1, bias=True)

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x.mean(dim=(2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """x * sigmoid(cv1([mean, max] over channels)), cv1 a k x k conv without bias."""

    def __init__(self, k: int = 7):
        super().__init__()
        self.cv1 = nn.Conv2d(2, 1, k, padding=k // 2, bias=False)

    def forward(self, x):
        pooled = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.cv1(pooled))


class CBAM(nn.Module):
    """Channel attention, then spatial attention, over c1 channels."""

    def __init__(self, c1: int, k: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(k)

    def forward(self, x):
        return self.spatial_attention(self.channel_attention(x))


class MaxPool2d(nn.MaxPool2d):
    """nn.MaxPool2d(k, s, p) of a model YAML (yolov3-tiny)."""

    def __init__(self, k: int = 2, s: int = 2, p: int = 0):
        super().__init__(k, s, p)


class ZeroPad2d(nn.ZeroPad2d):
    """nn.ZeroPad2d of a model YAML: (left, right, top, bottom)."""

    def __init__(self, pad=(0, 1, 0, 1)):
        super().__init__(tuple(pad))


class DSConv(nn.Module):
    """Depthwise-separable conv: DW (no norm) -> PW 1x1 -> BN -> SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p: int | None = None,
                 d: int = 1):
        super().__init__()
        pad = p if p is not None else (d * (k - 1)) // 2
        self.dw = nn.Conv2d(c1, c1, k, s, pad, dilation=d, groups=c1, bias=False)
        self.pw = nn.Conv2d(c1, c2, 1, bias=False)
        self.bn = batch_norm(c2)

    def forward(self, x):
        return F.silu(norm_f32(self.bn, self.pw(self.dw(x))))


class Concat(nn.Module):
    """Concatenate along channels."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, xs):
        return torch.cat(xs, dim=self.dim)


class Upsample(nn.Module):
    """Nearest or bilinear upsample (torch nn.Upsample semantics)."""

    def __init__(self, size=None, scale_factor: float = 2.0, mode: str = "nearest"):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode

    def forward(self, x):
        if self.size is not None:
            return F.interpolate(x, size=tuple(self.size), mode=self.mode)
        return F.interpolate(x, scale_factor=float(self.scale_factor), mode=self.mode)
