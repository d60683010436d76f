"""YOLO-World's text-guided blocks and head, NCHW (edgeyolo_tpu/nn/modules/world.py).

The text embeddings arrive as a (B, K, gc) side input that the graph walk
threads through the model (nn/tasks.py): C2fAttn reads it, ImagePoolingAttn
refreshes it with pooled image context, and WorldDetect classifies each
anchor by its similarity to the original embeddings.

- MaxSigmoidAttnBlock gates a 3x3 projection of the features per head by the
  sigmoid of the best (max over the K texts) dot product of the embedded
  features with the projected texts, scaled by 1/sqrt(head channels).
- C2fAttn is C2f with that block appended to the running list before the
  fusing conv ((3 + n) x c channels).
- ImagePoolingAttn max-pools a 1x1 projection of each level to k x k bins
  (torch's adaptive bins, as JAX computes them), attends from the
  LayerNorm'ed texts to those patches (nh heads) and adds the projection
  back to the texts.
- ContrastiveHead and BNContrastiveHead are the logits of the cosine (or
  BatchNorm'ed features against unit texts) similarity, times exp of a
  learned logit scale, plus a learned bias.
- WorldDetect is Detect with the legacy 3x3 towers, its class tower ending
  in `embed` channels, and a contrastive head per level; Detect's f32 DFL
  decode reads the class count (the texts') off the feats.

The similarity heads, the sigmoid gate and the attention's softmax compute
in f32 and hand back the compute dtype, so a bf16 model stays bf16. JAX's
`scale` option of the attention blocks is not reached by any registry row
and is not ported. Parameter names are the reference's state_dict keys.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edgeyolo_tpu_torch.nn.modules.block import DFL, Bottleneck
from edgeyolo_tpu_torch.nn.modules.conv import ConvBN, batch_norm, norm_f32
from edgeyolo_tpu_torch.nn.modules.head import Detect, _tower_lists
from edgeyolo_tpu_torch.nn.modules.transformer import layer_norm


def _linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A linear layer on x cast to the layer's dtype (texts arrive in f32)."""
    return m(x.to(m.weight.dtype))


class MaxSigmoidAttnBlock(nn.Module):
    """Text-max sigmoid gating of a 3x3 projection."""

    def __init__(self, c1: int, c2: int, nh: int = 1, ec: int = 128, gc: int = 512):
        super().__init__()
        self.nh, self.hc, self.ec_dim = nh, c2 // nh, ec
        self.ec = ConvBN(c1, ec, 1, act=False) if c1 != ec else None
        self.gl = nn.Linear(gc, ec)
        self.bias = nn.Parameter(torch.zeros(nh))
        self.proj_conv = ConvBN(c1, c2, 3, act=False)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        g = _linear(self.gl, guide).view(b, -1, self.nh, self.ec_dim // self.nh)
        embed = self.ec(x) if self.ec is not None else x
        embed = embed.view(b, self.nh, self.ec_dim // self.nh, h, w)
        aw = torch.einsum("bmchw,bnmc->bmhwn", embed, g.to(embed.dtype)).amax(dim=-1)
        aw = torch.sigmoid(aw.float() / self.hc ** 0.5 + self.bias.float().view(1, -1, 1, 1))
        y = self.proj_conv(x)
        return (y.view(b, self.nh, self.hc, h, w) * aw.to(y.dtype).unsqueeze(2)).view(b, -1, h, w)


class C2fAttn(nn.Module):
    """C2f with a text-guided attention branch appended before the fusing conv."""

    def __init__(self, c1: int, c2: int, n: int = 1, ec: int = 128, nh: int = 1, gc: int = 512,
                 shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__()
        c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * c, 1)
        self.cv2 = ConvBN((3 + n) * c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(c, c, shortcut, g, (3, 3), 1.0) for _ in range(n))
        self.attn = MaxSigmoidAttnBlock(c, c, nh, ec, gc)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, dim=1))
        for m in self.m:
            ys.append(m(ys[-1]))
        ys.append(self.attn(ys[-1], guide))
        return self.cv2(torch.cat(ys, dim=1))


class ImagePoolingAttn(nn.Module):
    """Texts refreshed by attention over max-pooled multi-level image patches."""

    def __init__(self, ec: int = 256, ch: Sequence[int] = (), ct: int = 512, nh: int = 8,
                 k: int = 3):
        super().__init__()
        self.ec, self.nh, self.k = ec, nh, k
        self.projections = nn.ModuleList(nn.Conv2d(c, ec, 1) for c in ch)
        # flax's LayerNorm default eps (1e-6), as JAX builds them
        self.query = nn.Sequential(nn.LayerNorm(ct, eps=1e-6), nn.Linear(ct, ec))
        self.key = nn.Sequential(nn.LayerNorm(ec, eps=1e-6), nn.Linear(ec, ec))
        self.value = nn.Sequential(nn.LayerNorm(ec, eps=1e-6), nn.Linear(ec, ec))
        self.proj = nn.Linear(ec, ct)

    def forward(self, xs: Sequence[torch.Tensor], text: torch.Tensor) -> torch.Tensor:
        bs = xs[0].shape[0]
        kv = torch.cat([F.adaptive_max_pool2d(p(x), self.k).flatten(2)
                        for p, x in zip(self.projections, xs)], dim=2).transpose(1, 2)

        def seq(s: nn.Sequential, t: torch.Tensor) -> torch.Tensor:
            return _linear(s[1], layer_norm(s[0], t))

        hc = self.ec // self.nh
        q = seq(self.query, text).view(bs, -1, self.nh, hc)
        kk = seq(self.key, kv).view(bs, -1, self.nh, hc)
        vv = seq(self.value, kv).view(bs, -1, self.nh, hc)
        aw = torch.einsum("bnmc,bkmc->bmnk", q, kk).float() / hc ** 0.5
        aw = aw.softmax(dim=-1).to(vv.dtype)
        out = torch.einsum("bmnk,bkmc->bnmc", aw, vv).reshape(bs, -1, self.ec)
        return _linear(self.proj, out) + text.to(self.proj.weight.dtype)


def _unit(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t / (torch.linalg.vector_norm(t, dim=dim, keepdim=True) + 1e-12)


class ContrastiveHead(nn.Module):
    """Region-text cosine similarity logits, learned logit scale and bias."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.tensor([-10.0]))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        sim = torch.einsum("bchw,bkc->bkhw", _unit(x.float(), 1), _unit(w.float(), -1))
        return (sim * self.logit_scale.float().exp() + self.bias.float()).to(x.dtype)


class BNContrastiveHead(nn.Module):
    """The contrastive head over BatchNorm'ed features (the texts still unit)."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.norm = batch_norm(embed_dims)
        self.bias = nn.Parameter(torch.tensor([-10.0]))
        self.logit_scale = nn.Parameter(torch.tensor(-1.0))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xn = norm_f32(self.norm, x).float()
        sim = torch.einsum("bchw,bkc->bkhw", xn, _unit(w.float(), -1))
        return (sim * self.logit_scale.float().exp() + self.bias.float()).to(x.dtype)


class WorldDetect(Detect):
    """Detect whose classes are the texts: per level the box tower, an
    embedding tower and a contrastive head against the (B, K, embed) texts."""

    def __init__(self, nc: int = 80, embed: int = 512, with_bn: bool = False,
                 ch: Sequence[int] = (), stride: Sequence[int] = (8, 16, 32), reg_max: int = 16,
                 legacy: bool = True, max_det: int = 300):
        nn.Module.__init__(self)
        self.nc, self.reg_max, self.stride, self.max_det = nc, reg_max, tuple(stride), max_det
        # JAX's towers: always the legacy 3x3 pairs, the class ones ending in `embed` channels
        self.cv2, self.cv3 = _tower_lists(ch, nc, reg_max, True, embed)
        self.cv4 = nn.ModuleList(BNContrastiveHead(embed) if with_bn else ContrastiveHead()
                                 for _ in ch)
        self.dfl = DFL(reg_max)

    @torch.no_grad()
    def bias_init(self):
        """Box logits start at 1; the embedding convs keep a zero bias (JAX's)."""
        for seq in self.cv2:
            seq[-1].bias.fill_(1.0)

    def forward(self, xs, text: torch.Tensor):
        feats = [torch.cat([b(x), h(e(x), text)], dim=1)
                 for b, e, h, x in zip(self.cv2, self.cv3, self.cv4, xs)]
        out = {"feats": feats}
        if not self.training:
            out["pred"] = self.decode(feats)
        return out
