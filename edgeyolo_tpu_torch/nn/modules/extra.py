"""YOLOv12 area attention, the YOLOv13 hypergraph modules, the YOLOv10
blocks and the Ghost blocks, NCHW (edgeyolo_tpu/nn/modules/extra.py).

- AAttn / ABlock / A2C2f: attention within `area` bands of the token axis
  (the R-ELAN stack), in plain PyTorch matmuls as the JAX package leaves its
  einsums to XLA.
- AdaHyperedgeGen / AdaHGConv / AdaHGComputation / C3AH / FuseModule /
  HyperACE / DownsampleConv / FullPAD_Tunnel: adaptive hypergraph
  correlation over three fused scales, and the gated tunnels that hand it
  back to the neck.
- RepVGGDW / CIB / C2fCIB: YOLOv10's large-kernel depthwise pair and its
  conditional identity block (training form: JAX has no re-parameterised
  fuse).
- GhostBottleneck / C3Ghost: the Ghost sandwich and its C3 (yolov8-ghost).
- ResNetBlock / ResNetLayer: the bottleneck block (1x1, 3x3 at the stride,
  1x1 to e x c2 without activation, plus the input or its 1x1 projection,
  then ReLU) and a stage of them, or the stem (7x7/2 ConvBN with ReLU, then
  a 3x3/2 max pool padded 1): the cls-resnet YAMLs and rtdetr-resnet50/101.
- BottleneckCSP: YOLOv5's CSP (cv1 and its bottlenecks, then the plain
  1x1 cv3 beside the plain 1x1 cv2 of the input, one BatchNorm over their
  concatenation in f32, SiLU, cv4).
- DySample: a learned sub-pixel offset per output pixel (offset channels
  [xy][group][s^2], placed in pixel-shuffle order, times 0.25) on the base
  grid (I + 0.5) / s - 0.5, then a bilinear gather per channel group whose
  taps clamp to the edge. Coordinates and bilinear weights are f32 whatever
  the activation dtype, and the result is cast back to it.
- WTConv2d: a k x k depthwise conv scaled per channel (`base_scale`, 1.0),
  plus a wavelet branch: per level a stride-2 DWT (zero padding kw // 2 - 1,
  odd sides padded by one zero row or column first; bands in the order
  [0, 2, 1, 3] of the DWT bank), a k x k depthwise conv of the 4 C band
  channels ([C][4]) scaled by `wavelet_scale.{i}` (0.1), and bottom-up the
  inverse DWT as a transposed conv, cropped to the level's size, with each
  level's LL adding the coarser level's reconstruction; a stride is
  subsampling.
- HGStem / HGBlock: PP-HGNet's stem (2x2 convs padded at the bottom and
  right only, beside a 2x2 stride-1 max pool padded the same way) and its
  block (n ConvBNs or LightConvs chained and all concatenated, squeezed by
  two 1x1 ConvBNs, with a residual when `shortcut` and c1 == c2): the
  backbones of rtdetr-l and rtdetr-x, ReLU throughout.

As in JAX: the participation softmax runs over the nodes after the mean over
heads; GELU is exact; no dropout runs, in training either (the JAX module
applies its dropout deterministically). In a bf16 model the scalar and
per-channel gates (`gate`, A2C2f's `gamma`) are cast to the activation
dtype, so activations stay bf16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.block import C2f, C3, Bottleneck, C3k
from edgeyolo_tpu_torch.nn.modules.conv import (ConvBN, DWConv, GhostConv, LightConv, batch_norm,
                                                norm_f32)
from edgeyolo_tpu_torch.nn.modules.edgeline import DSBottleneck, DSC3k
from edgeyolo_tpu_torch.ops.wavelets import dwt2d_kernel, idwt2d_kernel


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 average pool, stride 2, no padding (flax's VALID avg_pool)."""
    return F.avg_pool2d(x, 2)


class AAttn(nn.Module):
    """Area attention: full attention within `area` consecutive chunks of the
    H*W tokens (1 when the tokens do not split evenly), positional encoding
    by a 5x5 depthwise conv of v."""

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.num_heads, self.area = num_heads, area
        self.head_dim = dim // num_heads
        self.qk = ConvBN(dim, 2 * dim, 1, act=False)
        self.v = ConvBN(dim, dim, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 5, 1, 2, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        n, heads, hd = h * w, self.num_heads, self.head_dim
        v = self.v(x)
        pp = self.pe(v)
        a = self.area if self.area > 1 and n % self.area == 0 else 1
        # channels [2][heads][head_dim]; tokens split into a chunks of n / a
        qk = self.qk(x).view(b, 2, heads, hd, a, n // a).permute(0, 4, 1, 2, 3, 5)
        qk = qk.reshape(b * a, 2, heads, hd, n // a)
        q, k = qk.unbind(1)  # (b*a, heads, hd, n/a)
        vt = v.view(b, heads, hd, a, n // a).permute(0, 3, 1, 2, 4).reshape(b * a, heads, hd, -1)
        attn = ((q.transpose(-2, -1) @ k) * hd ** -0.5).softmax(dim=-1)
        out = (vt @ attn.transpose(-2, -1)).view(b, a, heads, hd, n // a)
        out = out.permute(0, 2, 3, 1, 4).reshape(b, c, h, w)
        return self.proj(out + pp)


class ABlock(nn.Module):
    """x = x + AAttn(x); x = x + MLP(x) (1x1 conv MLP)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2, area: int = 1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(ConvBN(dim, hidden, 1), ConvBN(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """R-ELAN: cv1 -> n stages of (two ABlocks | C3k), each appended -> cv2,
    with a layer-scaled residual (gamma starts at 0.01) when `residual`."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True, area: int = 1,
                 residual: bool = False, mlp_ratio: float = 2.0, e: float = 0.5, g: int = 1,
                 shortcut: bool = True):
        super().__init__()
        c_ = int(c2 * e)
        heads = max(1, c_ // 32)
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN((1 + n) * c_, c2, 1)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, heads, mlp_ratio, area) for _ in range(2))) if a2
            else C3k(c_, c_, 2, shortcut, g) for _ in range(n))
        self.gamma = (nn.Parameter(torch.full((c2,), 0.01)) if a2 and residual else None)

    def forward(self, x):
        ys = [self.cv1(x)]
        for m in self.m:
            ys.append(m(ys[-1]))
        out = self.cv2(torch.cat(ys, dim=1))
        if self.gamma is None:
            return out
        return x + self.gamma.to(out.dtype).view(1, -1, 1, 1) * out


class AdaHyperedgeGen(nn.Module):
    """Participation matrix (B, N, E): the multi-head similarity of the nodes
    to context-conditioned hyperedge prototypes, averaged over the heads,
    softmax over the nodes."""

    def __init__(self, node_dim: int, num_hyperedges: int, num_heads: int = 4,
                 context: str = "both"):
        super().__init__()
        self.num_heads, self.num_hyperedges, self.context = num_heads, num_hyperedges, context
        self.prototype_base = nn.Parameter(torch.empty(num_hyperedges, node_dim))
        bound = math.sqrt(6.0 / (num_hyperedges + node_dim))  # xavier uniform
        nn.init.uniform_(self.prototype_base, -bound, bound)
        ctx_dim = 2 * node_dim if context == "both" else node_dim
        self.context_net = nn.Linear(ctx_dim, num_hyperedges * node_dim)
        self.pre_head_proj = nn.Linear(node_dim, node_dim)

    def forward(self, x):  # (B, N, D)
        b, n, d = x.shape
        e, h = self.num_hyperedges, self.num_heads
        hd = d // h
        if self.context == "mean":
            ctx = x.mean(dim=1)
        elif self.context == "max":
            ctx = x.amax(dim=1)
        else:
            ctx = torch.cat([x.mean(dim=1), x.amax(dim=1)], dim=-1)
        protos = self.prototype_base.to(x.dtype)[None] + self.context_net(ctx).view(b, e, d)
        xh = self.pre_head_proj(x).view(b, n, h, hd).transpose(1, 2)  # (B, H, N, hd)
        ph = protos.view(b, e, h, hd).permute(0, 2, 3, 1)  # (B, H, hd, E)
        logits = (xh @ ph).mean(dim=1) / math.sqrt(hd)  # (B, N, E)
        return logits.softmax(dim=1)


class AdaHGConv(nn.Module):
    """Two-stage hypergraph message passing (nodes -> hyperedges -> nodes)
    with a residual."""

    def __init__(self, embed_dim: int, num_hyperedges: int = 16, num_heads: int = 4,
                 context: str = "both"):
        super().__init__()
        self.edge_generator = AdaHyperedgeGen(embed_dim, num_hyperedges, num_heads, context)
        self.edge_proj = nn.Sequential(nn.Linear(embed_dim, embed_dim), nn.GELU())
        self.node_proj = nn.Sequential(nn.Linear(embed_dim, embed_dim), nn.GELU())

    def forward(self, x):  # (B, N, D)
        a = self.edge_generator(x)
        he = self.edge_proj(a.transpose(1, 2) @ x)  # (B, E, D)
        return self.node_proj(a @ he) + x


class AdaHGComputation(nn.Module):
    """AdaHGConv over the H*W tokens of an NCHW map."""

    def __init__(self, embed_dim: int, num_hyperedges: int = 16, num_heads: int = 8,
                 context: str = "both"):
        super().__init__()
        self.hgnn = AdaHGConv(embed_dim, num_hyperedges, num_heads, context)

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = self.hgnn(x.flatten(2).transpose(1, 2))
        return tokens.transpose(1, 2).reshape(b, c, h, w)


class C3AH(nn.Module):
    """CSP split around AdaHGComputation."""

    def __init__(self, c1: int, c2: int, e: float = 1.0, num_hyperedges: int = 8,
                 context: str = "both"):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c1, c_, 1)
        self.m = AdaHGComputation(c_, num_hyperedges, max(1, c_ // 16), context)
        self.cv3 = ConvBN(2 * c_, c2, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class FuseModule(nn.Module):
    """Three scales brought to the middle one (2x average pool, 2x nearest
    upsample), concatenated, 1x1 fused to c_in channels. The inputs hold
    4 c_in channels in all with `channel_adjust`, else 3 c_in (the
    reference's rule)."""

    def __init__(self, c_in: int, channel_adjust: bool = True):
        super().__init__()
        self.conv_out = ConvBN((4 if channel_adjust else 3) * c_in, c_in, 1)

    def forward(self, xs):
        x3 = F.interpolate(xs[2], scale_factor=2.0, mode="nearest")
        return self.conv_out(torch.cat([avg_pool_2x(xs[0]), xs[1], x3], dim=1))


class HyperACE(nn.Module):
    """YOLOv13's hypergraph correlation enhancement over three fused scales;
    c1 is the channel count of the middle input. `make_branch` builds the two
    branches on the middle chunk and `enhance_last` transforms the chain's
    last output: the hooks the wavelet variant (msla_lgl.HyperACE_Wavelet)
    overrides."""

    def __init__(self, c1: int, c2: int, n: int = 1, num_hyperedges: int = 8,
                 dsc3k: bool = True, shortcut: bool = False, e1: float = 0.5, e2: float = 1.0,
                 context: str = "both", channel_adjust: bool = True):
        super().__init__()
        c = int(c2 * e1)
        self.fuse = FuseModule(c1, channel_adjust)
        self.cv1 = ConvBN(c1, 3 * c, 1)
        self.branch1 = self.make_branch(c, e2, num_hyperedges, context)
        self.branch2 = self.make_branch(c, e2, num_hyperedges, context)
        self.m = nn.ModuleList(DSC3k(c, c, 2, shortcut, 1, 0.5, 3, 7) if dsc3k
                               else DSBottleneck(c, c, shortcut) for _ in range(n))
        self.cv2 = ConvBN((4 + n) * c, c2, 1)

    def make_branch(self, c: int, e2: float, num_hyperedges: int, context: str) -> nn.Module:
        return C3AH(c, c, e2, num_hyperedges, context)

    def enhance_last(self, x):
        return x

    def forward(self, xs):
        y = list(self.cv1(self.fuse(xs)).chunk(3, dim=1))
        out1, out2 = self.branch1(y[1]), self.branch2(y[1])
        for m in self.m:
            y.append(m(y[-1]))
        y[-1] = self.enhance_last(y[-1])
        y[1] = out1
        y.append(out2)
        return self.cv2(torch.cat(y, dim=1))


class DownsampleConv(nn.Module):
    """2x average-pool downsample, then a 1x1 conv to 2 c1 channels with
    `channel_adjust`."""

    def __init__(self, c1: int, channel_adjust: bool = True):
        super().__init__()
        self.channel_adjust = ConvBN(c1, 2 * c1, 1) if channel_adjust else nn.Identity()

    def forward(self, x):
        return self.channel_adjust(avg_pool_2x(x))


class FullPAD_Tunnel(nn.Module):
    """Gated fusion: xs[0] + gate * xs[1], the gate starting at 0."""

    def __init__(self):
        super().__init__()
        self.gate = nn.Parameter(torch.zeros(()))

    def forward(self, xs):
        return xs[0] + self.gate.to(xs[0].dtype) * xs[1]


class RepVGGDW(nn.Module):
    """SiLU of a 7x7 and a 3x3 depthwise conv (+BN) summed."""

    def __init__(self, ed: int):
        super().__init__()
        self.conv = ConvBN(ed, ed, 7, 1, 3, g=ed, act=False)
        self.conv1 = ConvBN(ed, ed, 3, 1, 1, g=ed, act=False)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """Conditional identity block: dw3 -> pw -> (RepVGGDW with `lk`, else dw3)
    -> pw -> dw3, with a residual when `shortcut` and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(
            ConvBN(c1, c1, 3, g=c1), ConvBN(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else ConvBN(2 * c_, 2 * c_, 3, g=2 * c_),
            ConvBN(2 * c_, c2, 1), ConvBN(c2, c2, 3, g=c2))
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f whose inner blocks are CIBs (expansion 1)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False,
                 g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, block=lambda c: CIB(c, c, shortcut, 1.0, lk))


class GhostBottleneck(nn.Module):
    """Ghost sandwich: GhostConv -> (k x k depthwise stride s at s = 2) ->
    GhostConv without activation, plus the shortcut: at s = 2 a depthwise and
    a 1x1 conv, else the identity, or a 1x1 conv where c1 != c2 (JAX's
    `short_pw`, kept at `shortcut.1`)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(GhostConv(c1, c_, 1, 1),
                                  DWConv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
                                  GhostConv(c_, c2, 1, 1, act=False))
        if s == 2:
            self.shortcut = nn.Sequential(DWConv(c1, c1, k, s, act=False),
                                          ConvBN(c1, c2, 1, 1, act=False))
        elif c1 != c2:
            self.shortcut = nn.Sequential(nn.Identity(), ConvBN(c1, c2, 1, 1, act=False))
        else:
            self.shortcut = nn.Identity()

    def forward(self, x):
        return self.conv(x) + self.shortcut(x)


class C3Ghost(C3):
    """C3 whose inner blocks are GhostBottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, block=lambda c: GhostBottleneck(c, c))


class ResNetBlock(nn.Module):
    """ResNet bottleneck: cv1 1x1 -> cv2 3x3 at stride s -> cv3 1x1 to e * c2
    (no activation), plus the input, projected by a 1x1 ConvBN at stride s
    (no activation) where the stride or the width changes; then ReLU."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: int = 4):
        super().__init__()
        c3 = e * c2
        self.cv1 = ConvBN(c1, c2, 1, 1)
        self.cv2 = ConvBN(c2, c2, 3, s, 1)
        self.cv3 = ConvBN(c2, c3, 1, act=False)
        self.shortcut = ConvBN(c1, c3, 1, s, act=False) if s != 1 or c1 != c3 else None

    def forward(self, x):
        y = self.cv3(self.cv2(self.cv1(x)))
        return F.relu(y + (x if self.shortcut is None else self.shortcut(x)))


class ResNetLayer(nn.Module):
    """A ResNet stage: with `is_first` the stem (7x7/2 ConvBN with ReLU, then a
    3x3/2 max pool padded 1) to c2 channels, else n ResNetBlocks (the first
    at stride s) to e * c2."""

    def __init__(self, c1: int, c2: int, s: int = 1, is_first: bool = False, n: int = 1,
                 e: int = 4):
        super().__init__()
        self.is_first = is_first
        if is_first:
            self.stem = ConvBN(c1, c2, 7, 2, 3, act="relu")
        else:
            self.block = nn.Sequential(ResNetBlock(c1, c2, s, e),
                                       *(ResNetBlock(e * c2, c2, 1, e) for _ in range(n - 1)))

    def forward(self, x):
        if self.is_first:
            return F.max_pool2d(self.stem(x), 3, 2, 1)
        return self.block(x)


class HGStem(nn.Module):
    """PP-HGNet stem to c2 channels at a quarter of the input size."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = ConvBN(c1, cm, 3, 2, act="relu")
        self.stem2a = ConvBN(cm, cm // 2, 2, 1, 0, act="relu")
        self.stem2b = ConvBN(cm // 2, cm, 2, 1, 0, act="relu")
        self.stem3 = ConvBN(cm * 2, cm, 3, 2, act="relu")
        self.stem4 = ConvBN(cm, c2, 1, act="relu")

    def forward(self, x):
        x = self.stem1(x)
        x2 = self.stem2b(F.pad(self.stem2a(F.pad(x, (0, 1, 0, 1))), (0, 1, 0, 1)))
        x1 = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=-math.inf), 2, 1)
        return self.stem4(self.stem3(torch.cat([x1, x2], dim=1)))


class HGBlock(nn.Module):
    """PP-HGNet block: n convs (LightConvs with `lightconv`) chained, the
    input and every output concatenated, then 1x1 ConvBNs to c2 / 2 and c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6,
                 lightconv: bool = False, shortcut: bool = False, act: str = "relu"):
        super().__init__()
        self.m = nn.ModuleList(
            LightConv(c1 if i == 0 else cm, cm, k) if lightconv
            else ConvBN(c1 if i == 0 else cm, cm, k, act=act) for i in range(n))
        self.sc = ConvBN(c1 + n * cm, c2 // 2, 1, act=act)
        self.ec = ConvBN(c2 // 2, c2, 1, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = [x]
        for m in self.m:
            y.append(m(y[-1]))
        z = self.ec(self.sc(torch.cat(y, dim=1)))
        return z + x if self.add else z


class BottleneckCSP(nn.Module):
    """YOLOv5's CSP bottleneck (see the module docstring)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = nn.Conv2d(c1, c_, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv4 = ConvBN(2 * c_, c2, 1)
        self.bn = batch_norm(2 * c_)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, (3, 3), 1.0) for _ in range(n)))

    def forward(self, x):
        y = torch.cat([self.cv3(self.m(self.cv1(x))), self.cv2(x)], dim=1)
        return self.cv4(F.silu(norm_f32(self.bn, y)))


class DySample(nn.Module):
    """Dynamic upsampler by `scale` (see the module docstring); the offset
    conv starts at zero, where DySample is a bilinear upsample."""

    def __init__(self, c1: int, scale: int = 2, style: str = "lp", groups: int = 4):
        super().__init__()
        self.scale, self.groups = int(scale), int(groups)
        self.offset = nn.Conv2d(c1, 2 * self.groups * self.scale ** 2, 1, bias=True)

    def seeded_init(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.offset.weight.zero_()
            self.offset.bias.zero_()

    def sample_points(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The input coordinates (rows, columns) each output pixel samples,
        (B, groups, H s, W s) each, in f32."""
        b, _, h, w = x.shape
        s, g = self.scale, self.groups
        off = self.offset(x).float().view(b, 2, g, s, s, h, w) * 0.25  # (b, xy, g, p, q, i, j)
        off = off.permute(0, 2, 5, 3, 6, 4, 1).reshape(b, g, h * s, w * s, 2)
        oy = (torch.arange(h * s, device=x.device, dtype=torch.float32) + 0.5) / s - 0.5
        ox = (torch.arange(w * s, device=x.device, dtype=torch.float32) + 0.5) / s - 0.5
        return oy[:, None] + off[..., 1], ox[None, :] + off[..., 0]

    def forward(self, x):
        b, c, h, w = x.shape
        s, g = self.scale, self.groups
        sy, sx = self.sample_points(x)
        y0, x0 = sy.floor(), sx.floor()
        fy, fx = (sy - y0)[:, :, None], (sx - x0)[:, :, None]  # (b, g, 1, H', W')
        y0, x0 = y0.long(), x0.long()
        xg = x.view(b, g, c // g, h * w)

        def tap(yi, xi):
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).view(b, g, 1, -1)
            return xg.gather(3, idx.expand(b, g, c // g, idx.shape[-1])).view(
                b, g, c // g, h * s, w * s).float()

        out = (tap(y0, x0) * (1 - fy) * (1 - fx) + tap(y0, x0 + 1) * (1 - fy) * fx
               + tap(y0 + 1, x0) * fy * (1 - fx) + tap(y0 + 1, x0 + 1) * fy * fx)
        return out.reshape(b, c, h * s, w * s).to(x.dtype)


class _Scale(nn.Module):
    """A learned per-channel scale, weight (1, C, 1, 1) as the reference's."""

    def __init__(self, ch: int, init: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1, ch, 1, 1), float(init)))

    def forward(self, x):
        return x * self.weight.to(x.dtype)


class WTConv2d(nn.Module):
    """Wavelet-enhanced depthwise conv (see the module docstring); c2 must
    equal the input channels."""

    ORDER = (0, 2, 1, 3)

    def __init__(self, c1: int, c2: int, k: int = 5, s: int = 1, bias: bool = True,
                 levels: int = 1, wave: str = "db1"):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"WTConv2d keeps its channels: c1 {c1} != c2 {c2}")
        self.s, self.levels = s, levels
        dec = torch.from_numpy(dwt2d_kernel(wave)[:, :, 0, list(self.ORDER)])  # (kw, kw, 4)
        rec = torch.from_numpy(idwt2d_kernel(wave)[..., list(self.ORDER)])
        # (4c, 1, kw, kw), channel 4 i + band: the bank for each channel in [C][4] order
        self.register_buffer("dec", dec.permute(2, 0, 1)[:, None].repeat(c1, 1, 1, 1),
                             persistent=False)
        self.register_buffer("rec", rec.permute(2, 0, 1)[:, None].repeat(c1, 1, 1, 1),
                             persistent=False)
        self.pad = dec.shape[0] // 2 - 1
        self.base_conv = nn.Conv2d(c1, c1, k, padding="same", groups=c1, bias=bias)
        self.base_scale = _Scale(c1, 1.0)
        self.wavelet_convs = nn.ModuleList(
            nn.Conv2d(4 * c1, 4 * c1, k, padding="same", groups=4 * c1, bias=False)
            for _ in range(levels))
        self.wavelet_scale = nn.ModuleList(_Scale(4 * c1, 0.1) for _ in range(levels))

    def forward(self, x):
        c = x.shape[1]
        out = self.base_scale(self.base_conv(x))
        dec, rec = self.dec.to(x.dtype), self.rec.to(x.dtype)
        lls, highs, sizes = [], [], []
        cur = x
        for conv, scale in zip(self.wavelet_convs, self.wavelet_scale):
            h, w = cur.shape[-2:]
            sizes.append((h, w))
            cur = F.pad(cur, (0, w % 2, 0, h % 2))
            sub = F.conv2d(cur, dec, stride=2, padding=self.pad, groups=c)  # (b, 4c, h/2, w/2)
            cur = sub[:, 0::4]  # the next level's input: LL
            sub = scale(conv(sub)).unflatten(1, (c, 4))
            lls.append(sub[:, :, 0])
            highs.append(sub[:, :, 1:])
        nxt = 0.0
        for lv in reversed(range(self.levels)):
            bands = torch.cat([(lls[lv] + nxt)[:, :, None], highs[lv]], dim=2).flatten(1, 2)
            h, w = sizes[lv]
            nxt = F.conv_transpose2d(bands, rec, stride=2, padding=self.pad, groups=c)[..., :h, :w]
        out = out + nxt
        return out[..., ::self.s, ::self.s] if self.s > 1 else out
