"""EdgeLine-YOLO blocks, NCHW (edgeyolo_tpu/nn/modules/edgeline.py).

- LinearAttention / PSABlockLinearAttention / C2PSA_LinearAttention: the S32
  stage; the attention itself is ops/linear_attention.py (the CUDA kernel on
  the card).
- DWT2D / WaveletEnhancer / DSBottleneck / DSC3k / DSC3K2 / DSC3K2_Wavelet:
  the wavelet neck, and DSC3K2 without the enhancer (YOLOv13).
- The thesis's ablation blocks, which no bundled YAML uses: C3k2_Wavelet
  (C3k2_TWavelet is the same class under a second name), SPPF_Wavelet (the
  DWT's bands unpacked as ll, hl, lh, hh, as the reference's HaarDWT2D
  names them, one f_h conv for the three high bands), MulGate (a DSConv,
  relu6(f1) * f2, the zero-init `mix` conv and zero-scale BatchNorm, a
  per-channel `gamma` residual from 1e-2) and RHJM (ECA-style 1-D convs over
  the adaptively pooled map flattened position-major with the channel
  fastest, and over the pooled channels; k = odd(|log2 C + b| / gamma)).

In a bf16 model the wavelet branch stays in bf16: the softplus-normalised
band weights and tanh(gamma) are computed from their f32 parameters and cast
to the activation dtype before they scale it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.block import C2f, C3, Bottleneck, C3k
from edgeyolo_tpu_torch.nn.modules.conv import ConvBN, DSConv, batch_norm, norm_f32
from edgeyolo_tpu_torch.ops.linear_attention import linear_attention
from edgeyolo_tpu_torch.ops.wavelets import dwt2d_kernel, dwt_pad_each_side


class LinearAttention(nn.Module):
    """y = softmax_N(q) (softmax_d(k)^T v), O(N d^2), over NCHW input.

    q, k and v are strided views of the qkv conv output (channel order
    [3][heads][head_dim]).
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 proj_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Conv2d(dim, 3 * dim, 1, bias=qkv_bias)
        self.proj = nn.Conv2d(dim, dim, 1, bias=proj_bias)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv(x).reshape(b, 3, self.num_heads, c // self.num_heads, h * w)
        q, k, v = (qkv[:, i].permute(0, 3, 1, 2) for i in range(3))  # (b, n, heads, hd)
        y = linear_attention(q, k, v).permute(0, 2, 3, 1).reshape(b, c, h, w)
        return self.proj(y)


class PSABlockLinearAttention(nn.Module):
    """x = x + LinearAttention(x); x = x + FFN(x) (qkv_bias=True, proj_bias=False)."""

    def __init__(self, dim: int, attn_ratio: float = 0.5, num_heads: int | None = None,
                 mlp_ratio: float = 2.0):
        super().__init__()
        heads = max(1, dim // 64 if num_heads is None else int(num_heads))
        self.attn = LinearAttention(dim, heads, qkv_bias=True, proj_bias=False)
        hidden = int(dim * mlp_ratio)
        self.ffn = nn.Sequential(ConvBN(dim, hidden, 1), ConvBN(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA_LinearAttention(nn.Module):
    """CSP split around stacked linear-attention PSA blocks (the S32 stage)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5, attn_ratio: float = 0.5,
                 num_heads: int | None = None, mlp_ratio: float = 2.0):
        super().__init__()
        if c1 != c2:
            raise ValueError("C2PSA_LinearAttention requires c1 == c2")
        c = int(c2 * e)
        heads = max(1, c // 64 if num_heads is None else int(num_heads))
        self.cv1 = ConvBN(c1, 2 * c, 1)
        self.m = nn.Sequential(*(PSABlockLinearAttention(c, attn_ratio, heads, mlp_ratio)
                                 for _ in range(n)))
        self.cv2 = ConvBN(2 * c, c2, 1)

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        return self.cv2(torch.cat([a, self.m(b)], dim=1))


class DWT2D(nn.Module):
    """One-level 2D DWT as a fixed depthwise stride-2 filter bank.

    Returns (LL, LH, HL, HH), each (B, C, H', W'). Haar on even sizes takes the
    2x2 space-to-depth + (4, 4) mix; every other case pads by reflection and
    runs the grouped stride-2 conv.
    """

    def __init__(self, wave: str = "haar"):
        super().__init__()
        self.wave = wave
        self.register_buffer("kern", torch.from_numpy(dwt2d_kernel(wave)), persistent=False)

    def forward(self, x):
        b, c, h, w = x.shape
        kern = self.kern.to(x.dtype)  # (k, k, 1, 4)
        k = kern.shape[0]
        if k == 2 and h % 2 == 0 and w % 2 == 0:
            xr = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
            xr = xr.reshape(b, c, h // 2, w // 2, 4)  # taps (0,0) (0,1) (1,0) (1,1)
            y = xr @ kern.reshape(4, 4)  # (tap, subband)
            return y.unbind(dim=-1)
        pad = dwt_pad_each_side(self.wave)
        if pad > 0:
            x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
        weight = kern.permute(3, 2, 0, 1).repeat(c, 1, 1, 1)  # (4c, 1, k, k), [channel][subband]
        y = F.conv2d(x, weight, stride=2, groups=c)
        y = y.unflatten(1, (c, 4))
        return y.unbind(dim=2)


def _up2(z: torch.Tensor, dim: int) -> torch.Tensor:
    """Half-pixel 2x bilinear along one axis with zero edges:
    even[i] = .75 z[i] + .25 z[i-1], odd[i] = .75 z[i] + .25 z[i+1]."""
    n = z.shape[dim]
    zero = torch.zeros_like(z.narrow(dim, 0, 1))
    prev = torch.cat([zero, z.narrow(dim, 0, n - 1)], dim=dim)
    nxt = torch.cat([z.narrow(dim, 1, n - 1), zero], dim=dim)
    even = 0.75 * z + 0.25 * prev
    odd = 0.75 * z + 0.25 * nxt
    return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)


def _bilinear_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize; the exact-2x case pads with zeros like the JAX fast path
    (only its 1 px border differs from an edge-clamped resize)."""
    h, w = x.shape[-2:]
    if tuple(size) == (2 * h, 2 * w):
        return _up2(_up2(x, 2), 3)
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


class WaveletEnhancer(nn.Module):
    """DWT -> per-band convs -> softplus-normalised band weights -> 2x upsample
    -> 1x1 fuse -> tanh(gamma)-scaled residual (gamma starts at 0)."""

    def __init__(self, c: int, use_ds: bool = False,
                 alpha0: Sequence[float] = (0.5, 0.2, 0.2, 0.1), wave: str = "haar"):
        super().__init__()
        half = c // 2
        self.dwt = DWT2D(wave)
        self.f_ll = ConvBN(c, half, 1)
        self.f_h = DSConv(c, half, 3) if use_ds else ConvBN(c, half, 3)
        self.alpha = nn.Parameter(torch.tensor(alpha0, dtype=torch.float32))
        self.gamma = nn.Parameter(torch.zeros((), dtype=torch.float32))
        self.fuse = ConvBN(c + 4 * half, c, 1)

    def forward(self, x):
        h, w = x.shape[-2:]
        ll, lh, hl, hh = self.dwt(x)
        llp = self.f_ll(ll)
        # the three high bands share f_h: one conv over the stacked batch (unstacked
        # by a reshape, which a symbolic batch traces without a guard)
        lhp, hlp, hhp = self.f_h(torch.cat([lh, hl, hh], dim=0)).unflatten(0, (3, -1)).unbind(0)
        wgt = F.softplus(self.alpha)
        wgt = (wgt / (wgt.sum() + 1e-6)).to(x.dtype)
        subs = [_bilinear_resize(p, (h, w)) * wgt[i] for i, p in enumerate((llp, lhp, hlp, hhp))]
        y = self.fuse(torch.cat([x, *subs], dim=1))
        return x + torch.tanh(self.gamma).to(x.dtype) * y


class DSBottleneck(nn.Module):
    """Two DSConvs (k1, then k2 dilated by d2) with an optional residual."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, k1: int = 3,
                 k2: int = 5, d2: int = 1):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = DSConv(c1, c_, k1, 1)
        self.cv2 = DSConv(c_, c2, k2, 1, d=d2)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class DSC3k(C3):
    """C3 whose inner blocks are DSBottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k1: int = 3, k2: int = 5, d2: int = 1):
        super().__init__(c1, c2, n, shortcut, g, e,
                         block=lambda c: DSBottleneck(c, c, shortcut, 1.0, k1, k2, d2))


class DSC3K2(C2f):
    """C2f whose inner blocks are DSC3k stacks (e = 1.0, the outer k1/k2/d2)
    or DSBottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, dsc3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True, k1: int = 3, k2: int = 7, d2: int = 1):
        block = ((lambda c: DSC3k(c, c, 2, shortcut, g, 1.0, k1, k2, d2)) if dsc3k
                 else (lambda c: DSBottleneck(c, c, shortcut, 1.0, k1, k2, d2)))
        super().__init__(c1, c2, n, shortcut, g, e, block=block)


class DSC3K2_Wavelet(C2f):
    """The EdgeLine neck block: DSC3K2 with the b-branch wavelet enhancer.

    Reference quirk kept: with dsc3k=True the inner DSC3k takes its own
    defaults e=0.5, k1=3, k2=5, d2=1, not the outer k1/k2/d2.
    """

    def __init__(self, c1: int, c2: int, n: int = 1, dsc3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True, k1: int = 3, k2: int = 7, d2: int = 1,
                 wave: str = "haar", use_ds: bool = False):
        block = ((lambda c: DSC3k(c, c, 2, shortcut, g, 0.5, 3, 5, 1)) if dsc3k
                 else (lambda c: DSBottleneck(c, c, shortcut, 1.0, k1, k2, d2)))
        super().__init__(c1, c2, n, shortcut, g, e, block=block)
        self.wave = WaveletEnhancer(int(c2 * e), use_ds, wave=wave)

    def enhance_b(self, b):
        return self.wave(b)


class C3k2_Wavelet(C2f):
    """C3k2 (C3k stacks, or bottlenecks at e = 1.0) with the b branch
    wavelet-enhanced before the chain."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True, wave: str = "haar", use_ds: bool = False):
        block = ((lambda c: C3k(c, c, 2, shortcut, g)) if c3k
                 else (lambda c: Bottleneck(c, c, shortcut, g, (3, 3), 1.0)))
        super().__init__(c1, c2, n, shortcut, g, e, block=block)
        self.wave = WaveletEnhancer(max(1, int(c2 * e)), use_ds, wave=wave)

    def enhance_b(self, b):
        return self.wave(b)


class SPPF_Wavelet(nn.Module):
    """SPPF with the max pools replaced by the sub-bands of cv1's output: f_ll
    of LL and the shared f_h of each high band at half size, each resized back
    (`_bilinear_resize`), concatenated with cv1's output, then cv2."""

    def __init__(self, c1: int, c2: int, k: int = 5, wave: str = "haar"):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBN(c1, c_, 1)
        self.dwt = DWT2D(wave)
        self.f_ll = ConvBN(c_, c_ // 2, 1)
        self.f_h = ConvBN(c_, c_ // 2, 3)
        self.cv2 = ConvBN(c_ + 4 * (c_ // 2), c2, 1)

    def forward(self, x):
        y0 = self.cv1(x)
        ll, hl, lh, hh = self.dwt(y0)
        size = y0.shape[-2:]
        parts = [self.f_ll(ll), self.f_h(lh), self.f_h(hl), self.f_h(hh)]
        return self.cv2(torch.cat([y0, *(_bilinear_resize(p, size) for p in parts)], dim=1))


class MulGate(nn.Module):
    """x + gamma * bn(mix(relu6(f1(y)) * f2(y))), y = pre(x); its output at
    init equals its input (mix and the BatchNorm's scale start at zero)."""

    def __init__(self, c1: int, c2: int, e: float = 3.0, k: int = 7, d: int = 1,
                 gamma0: float = 1e-2):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"MulGate keeps its channels: c1 {c1} != c2 {c2}")
        hidden = int(c1 * e)
        self.pre = DSConv(c1, c1, k, d=d)
        self.f1 = nn.Conv2d(c1, hidden, 1, bias=True)
        self.f2 = nn.Conv2d(c1, hidden, 1, bias=True)
        self.mix = nn.Conv2d(hidden, c1, 1, bias=False)
        self.bn = batch_norm(c1)
        nn.init.zeros_(self.bn.weight)
        self.gamma = nn.Parameter(torch.full((c1,), float(gamma0)))

    def seeded_init(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.mix.weight.zero_()

    def forward(self, x):
        y = self.pre(x)
        z = norm_f32(self.bn, self.mix(F.relu6(self.f1(y)) * self.f2(y)))
        return x + self.gamma.to(x.dtype)[:, None, None] * z


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Adaptive average pool to `out_hw`, down or up: out[i] is the mean of
    in[floor(i I / O) : ceil((i + 1) I / O)] on each axis, as JAX's pooling
    matrices compute it."""
    return F.adaptive_avg_pool2d(x, tuple(out_hw))


class RHJM(nn.Module):
    """ECA-style dual 1-D conv channel attention: a local branch over the
    `local_size` x `local_size` pooled map and a global one over the pooled
    channels, their sigmoids blended by `local_weight`, pooled back to H x W
    and multiplied in."""

    def __init__(self, c1: int, c2: int, local_size: int = 5, gamma: int = 2, b: int = 1,
                 local_weight: float = 0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"RHJM keeps its channels: c1 {c1} != c2 {c2}")
        t = int(abs(math.log2(c1) + b) / gamma)
        k = max(t if t % 2 else t + 1, 1)
        self.local_size, self.local_weight = local_size, local_weight
        self.conv_local = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)
        self.conv_global = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.local_size
        seq = adaptive_avg_pool2d(x, (s, s)).permute(0, 2, 3, 1).reshape(b, 1, s * s * c)
        att_local = torch.sigmoid(self.conv_local(seq)).view(b, s, s, c).permute(0, 3, 1, 2)
        att_global = torch.sigmoid(self.conv_global(x.mean(dim=(2, 3))[:, None]))  # (b, 1, c)
        att = (att_global.view(b, c, 1, 1) * (1.0 - self.local_weight)
               + att_local * self.local_weight)
        return x * adaptive_avg_pool2d(att, (h, w))
