"""Multi-scale linear attention, the LGL blocks and the multi-level wavelet
mixer, NCHW (edgeyolo_tpu/nn/modules/msla_lgl.py).

MSLA splits the channels into four quarters, runs a 3/5/7/9 depthwise conv
on each, one LinearAttention shared by the four (its kernel on the card),
scales each result by a learned weight and fuses them with a 1x1 conv.
The four quarters go through the attention as one batch (concatenated on the
batch axis, the weights shared), so an MSLA is one qkv conv, one kernel
launch and one projection: the same per-sample arithmetic as four calls.

DSC3K2_MSLA adds out + tanh(gamma) * MSLA(out) to a DSC3K2 when c2 % 4 == 0;
gamma starts at 0, so a fresh block is a DSC3K2.

LGL (DSC3K2_LGL's inner block): LocalAgg's gated convolutions, then full
softmax attention on a 2x average-pooled grid (GlobalSparseAttn, plain
matmuls as in JAX).

The wavelet HyperACE (yolov13-test): two C3AW_MLM branches, each a
WaveletMixerMultiLevel whose coarsest LL band goes through LinearAttention,
the kernel, at head dim c / 2 (32 at scale n, 64 at s, 128 at l, 192 at x)
over 100 tokens at 640 px and 1 at 64 px; and LocalSS2DContext's four 1-D
scans on the chain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.block import C2f
from edgeyolo_tpu_torch.nn.modules.conv import ConvBN
from edgeyolo_tpu_torch.nn.modules.edgeline import DSC3K2, DWT2D, LinearAttention
from edgeyolo_tpu_torch.nn.modules.extra import HyperACE
from edgeyolo_tpu_torch.ops.wavelets import idwt2d_kernel

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


def layer_norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW map, its statistics and affine
    in f32 (flax's LayerNorm), back to the input dtype."""
    y = F.layer_norm(x.permute(0, 2, 3, 1).float(), norm.normalized_shape,
                     norm.weight.float(), norm.bias.float(), norm.eps)
    return y.permute(0, 3, 1, 2).to(x.dtype)


class LocalAgg(nn.Module):
    """Sigmoid-gated local aggregation: a 9x9 depthwise position embedding, a
    1x1 / 9x9 depthwise / 1x1 conv attention and a 1x1 conv MLP, each added
    as x += x * (sigmoid(f(x)) - 0.5)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.pos_embed = ConvBN(dim, dim, 9, 1, 4, g=dim, act=False)
        self.conv1 = ConvBN(dim, dim, 1, act=False)
        self.attn = ConvBN(dim, dim, 9, 1, 4, g=dim, act=False)
        self.conv2 = ConvBN(dim, dim, 1, act=False)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(ConvBN(dim, hidden, 1), ConvBN(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + x * (torch.sigmoid(self.pos_embed(x)) - 0.5)
        x = x + x * (torch.sigmoid(self.conv2(self.attn(self.conv1(x)))) - 0.5)
        return x + x * (torch.sigmoid(self.mlp(x)) - 0.5)


class GlobalSparseAttn(nn.Module):
    """Full softmax attention on the sr x sr average-pooled grid (sr 1 when a
    side does not divide), then back to full resolution by repeating each
    token sr x sr times, a depthwise 3x3 and a LayerNorm (eps 1e-6, f32).

    Plain matmuls, as JAX leaves its einsums to XLA: the (B, heads, n, n)
    scores are materialised (yolov13-dsc3k2-lgl-n's layer 2 at 640 px: n =
    6,400 tokens, one head)."""

    def __init__(self, dim: int, num_heads: int = 8, sr_ratio: int = 2):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.local_prop = ConvBN(dim, dim, 3, 1, 1, g=dim, act=False)
            self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        b, c, h, w = x.shape
        sr = self.sr_ratio if h % self.sr_ratio == 0 and w % self.sr_ratio == 0 else 1
        z = F.avg_pool2d(x, sr) if sr > 1 else x
        hs, ws = z.shape[-2:]
        n, heads = hs * ws, self.num_heads
        hd = c // heads
        qkv = self.qkv(z.flatten(2).transpose(1, 2)).view(b, n, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (b, heads, n, hd)
        attn = ((q * hd ** -0.5) @ k.transpose(-2, -1)).softmax(dim=-1)
        out = self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))
        out = out.transpose(1, 2).reshape(b, c, hs, ws)
        if sr > 1:
            out = out.repeat_interleave(sr, dim=2).repeat_interleave(sr, dim=3)
            out = layer_norm_f32(self.norm, self.local_prop(out))
        return out


class LGLBlock(nn.Module):
    """LocalAgg, then a residual GlobalSparseAttn with max(1, min(4, dim / 16))
    heads; `global` is the state_dict name of the second, as in JAX."""

    def __init__(self, dim: int, num_heads: int = 4, sr_ratio: int = 2):
        super().__init__()
        self.local = LocalAgg(dim)
        setattr(self, "global", GlobalSparseAttn(dim, max(1, min(num_heads, dim // 16)),
                                                 sr_ratio))

    def forward(self, x):
        x = self.local(x)
        return x + getattr(self, "global")(x)


class DSC3K2_LGL(C2f):
    """DSC3K2-shaped CSP whose inner blocks are LGLBlocks (dsc3k, k1, k2 and d2
    are accepted and unused, as in JAX)."""

    def __init__(self, c1: int, c2: int, n: int = 1, dsc3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True, k1: int = 3, k2: int = 7, d2: int = 1):
        super().__init__(c1, c2, n, shortcut, g, e, block=LGLBlock)


class IHaarDWT2D(nn.Module):
    """One-level inverse Haar: (LL, LH, HL, HH), each (B, C, h, w) -> (B, C, 2h, 2w),
    each 2 x 2 output block the (4, 4) synthesis taps times the four bands."""

    def __init__(self):
        super().__init__()
        self.register_buffer("kern", torch.from_numpy(idwt2d_kernel("haar")), persistent=False)

    def forward(self, subbands):
        b, c, h, w = subbands[0].shape
        taps = self.kern.to(subbands[0].dtype).reshape(4, 4)  # (tap (di, dj), band)
        quad = torch.stack(subbands, dim=-1) @ taps.t()  # (b, c, h, w, tap)
        quad = quad.view(b, c, h, w, 2, 2).permute(0, 1, 2, 4, 3, 5)
        return quad.reshape(b, c, 2 * h, 2 * w)


class WaveletMixerMultiLevel(nn.Module):
    """`levels` Haar analyses (stopping early once a side is below 2), each
    level's three detail bands mixed by their own depthwise 3x3; a residual
    LinearAttention (its kernel on the card) on the coarsest LL; the inverse
    Haar back up, the running map cropped to each level's band size first and
    to the input size last; a tanh(gamma)-gated 1x1 fuse added to the input
    (gamma starts at 0).

    As in JAX, each analysis halves a side exactly only when it is even: an
    odd side above 1 leaves the inverse a band short and the sum fails, in
    both packages. A level the early stop skips keeps its (unused) mixers
    here; JAX creates no variables for it."""

    def __init__(self, dim: int, levels: int = 2, num_heads: int = 2):
        super().__init__()
        self.dwt = DWT2D("haar")
        self.mix = nn.ModuleList(
            nn.ModuleList(ConvBN(dim, dim, 3, g=dim, act=False) for _ in range(3))
            for _ in range(levels))
        self.ll_attention = LinearAttention(dim, max(1, min(num_heads, dim)))
        self.idwt = IHaarDWT2D()
        self.gamma = nn.Parameter(torch.zeros(()))
        self.fuse = ConvBN(dim, dim, 1, act=False)

    def forward(self, x):
        h, w = x.shape[-2:]
        details = []
        cur = x
        for mix in self.mix:
            if cur.shape[2] < 2 or cur.shape[3] < 2:
                break
            ll, *bands = self.dwt(cur)
            details.append([m(s) for m, s in zip(mix, bands)])
            cur = ll
        cur = cur + self.ll_attention(cur)
        for lh, hl, hh in reversed(details):
            cur = self.idwt((cur[:, :, :lh.shape[2], :lh.shape[3]], lh, hl, hh))
        cur = cur[:, :, :h, :w]
        return x + torch.tanh(self.gamma).to(x.dtype) * self.fuse(cur)


class C3AW_MLM(nn.Module):
    """CSP split around the multi-level wavelet mixer (C3-shaped)."""

    def __init__(self, c1: int, c2: int, e: float = 1.0, levels: int = 2):
        super().__init__()
        c_ = max(4, int(c2 * e))
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c1, c_, 1)
        self.m = WaveletMixerMultiLevel(c_, levels)
        self.cv3 = ConvBN(2 * c_, c2, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class SeqMixer1D(nn.Module):
    """Sequence mixer over (B, C, L): seq + dwconv1d_k(seq) * sigmoid(W seq + b),
    the depthwise conv 'SAME' padded (k // 2 each side); `gate` is a dense
    layer over the channels."""

    def __init__(self, dim: int, k: int = 7):
        super().__init__()
        self.mix = nn.Conv1d(dim, dim, k, padding=k // 2, groups=dim)
        self.gate = nn.Linear(dim, dim)

    def forward(self, seq):
        gate = torch.sigmoid(F.conv1d(seq, self.gate.weight[..., None], self.gate.bias))
        return seq + self.mix(seq) * gate


class LocalSS2DContext(nn.Module):
    """Four scans of the map (rows and columns, each both ways) through one
    SeqMixer1D, batched into one call; their mean, tanh(gamma)-gated, added to
    the input (gamma starts at 0)."""

    def __init__(self, dim: int):
        super().__init__()
        self.mixer = SeqMixer1D(dim)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        b, c, h, w = x.shape
        rows = x.flatten(2)  # row-major tokens
        cols = x.transpose(2, 3).flatten(2)  # column-major tokens
        fwd_r, bwd_r, fwd_c, bwd_c = self.mixer(
            torch.cat([rows, rows.flip(-1), cols, cols.flip(-1)], dim=0)).split(b, dim=0)
        ctx = (fwd_r.view(b, c, h, w) + bwd_r.flip(-1).view(b, c, h, w)
               + fwd_c.view(b, c, w, h).transpose(2, 3)
               + bwd_c.flip(-1).view(b, c, w, h).transpose(2, 3)) / 4.0
        return x + torch.tanh(self.gamma).to(x.dtype) * ctx


class HyperACE_Wavelet(HyperACE):
    """HyperACE whose two branches are C3AW_MLM wavelet mixers (both reading
    the middle chunk, each with its own weights) and whose chain's last output
    passes through LocalSS2DContext; `num_hyperedges` and `context` are
    accepted and unused, as in JAX."""

    def __init__(self, c1: int, c2: int, n: int = 1, num_hyperedges: int = 8,
                 dsc3k: bool = True, shortcut: bool = False, e1: float = 0.5, e2: float = 1.0,
                 context: str = "both", channel_adjust: bool = True):
        super().__init__(c1, c2, n, num_hyperedges, dsc3k, shortcut, e1, e2, context,
                         channel_adjust)
        self.ss2d = LocalSS2DContext(int(c2 * e1))

    def make_branch(self, c: int, e2: float, num_hyperedges: int, context: str) -> nn.Module:
        return C3AW_MLM(c, c, e2)

    def enhance_last(self, x):
        return self.ss2d(x)


class Wavelet_SS2D(HyperACE_Wavelet):
    """HyperACE_Wavelet under the name the reference gives its SS2D variant."""
