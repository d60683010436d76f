"""Detection heads, NCHW (edgeyolo_tpu/nn/modules/head.py).

Detect is the anchor-free head: per level a reg tower (cv2) of DFL logits
and a cls tower (cv3), the legacy 3x3 pair or the DWConv + 1x1 pairs. The
decode concatenates the levels and runs in f32 whatever the tower dtype:
box coordinates span [0, imgsz] and bf16 would round them to about 2 px.
Output (B, A, 4 + nc): xywh boxes in input pixels, class probabilities.

GFLHeadv2_uniH is GF2Detect: Detect plus the DGQP quality mini-head
(reg_conf) over the top-k statistics of each side's DFL distribution,
whose quality multiplies the class probabilities.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from edgeyolo_tpu_torch.nn.modules.block import DFL
from edgeyolo_tpu_torch.nn.modules.conv import ConvBN, DWConv
from edgeyolo_tpu_torch.ops.boxes import dist2bbox, make_anchors


def topk_small(x: torch.Tensor, k: int, dim: int = -1) -> torch.Tensor:
    """Top-k values over a small axis by k masked max sweeps, largest first.

    +iota*1e-7 makes the values distinct, so each sweep removes exactly one
    element and duplicates keep their multiplicity (GF2Detect._topk_small);
    a plain torch.topk breaks ties differently.
    """
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    cur = x + (torch.arange(n, dtype=x.dtype, device=x.device) * 1e-7).view(shape)
    vals = []
    for _ in range(k):
        m = cur.amax(dim=dim, keepdim=True)
        vals.append(m)
        cur = torch.where(cur == m, -torch.inf, cur)
    return torch.cat(vals, dim=dim)


class Detect(nn.Module):
    """Anchor-free decoupled detection head over the pyramid levels."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), stride: Sequence[int] = (8, 16, 32),
                 reg_max: int = 16, legacy: bool = False):
        super().__init__()
        self.nc, self.reg_max, self.stride = nc, reg_max, tuple(stride)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(ConvBN(x, c2, 3), ConvBN(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))
            for x in ch)
        if legacy:
            self.cv3 = nn.ModuleList(
                nn.Sequential(ConvBN(x, c3, 3), ConvBN(c3, c3, 3), nn.Conv2d(c3, nc, 1))
                for x in ch)
        else:
            self.cv3 = nn.ModuleList(
                nn.Sequential(nn.Sequential(DWConv(x, x, 3), ConvBN(x, c3, 1)),
                              nn.Sequential(DWConv(c3, c3, 3), ConvBN(c3, c3, 1)),
                              nn.Conv2d(c3, nc, 1))
                for x in ch)
        self.dfl = DFL(reg_max)

    @torch.no_grad()
    def bias_init(self):
        """Box logits start at 1, class logits at the 5-objects-per-640px-image prior."""
        for seq in self.cv2:
            seq[-1].bias.fill_(1.0)
        for seq, s in zip(self.cv3, self.stride):
            seq[-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    def decode(self, feats, quality=None):
        """Levels -> (B, A, 4 + nc) in f32: DFL integral boxes, sigmoid cls
        (times the clipped quality when there is one)."""
        b = feats[0].shape[0]
        flat = torch.cat([f.flatten(2) for f in feats], dim=2).float().transpose(1, 2)
        box_logits, cls_logits = flat.split((4 * self.reg_max, self.nc), dim=-1)
        anchors, strides = make_anchors([f.shape[-2:] for f in feats], self.stride,
                                        device=flat.device)
        dbox = dist2bbox(self.dfl(box_logits), anchors[None], xywh=True) * strides[None]
        cls_prob = torch.sigmoid(cls_logits)
        if quality is not None:
            q = torch.cat([qi.reshape(b, -1, 1) for qi in quality], dim=1)
            cls_prob = cls_prob * q.clamp(1e-6, 1 - 1e-6)
        return torch.cat([dbox, cls_prob], dim=-1)

    def towers(self, xs):
        """(box logits per level, feats per level)."""
        boxes = [cv2(x) for cv2, x in zip(self.cv2, xs)]
        return boxes, [torch.cat([bx, cv3(x)], dim=1) for bx, cv3, x in zip(boxes, self.cv3, xs)]

    def forward(self, xs):
        _, feats = self.towers(xs)
        out = {"feats": feats}
        if not self.training:
            out["pred"] = self.decode(feats)
        return out


class GFLHeadv2_uniH(Detect):
    """Detect + DGQP quality head (the working semantics of GF2Detect)."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), stride: Sequence[int] = (8, 16, 32),
                 reg_max: int = 16, legacy: bool = False, reg_topk: int = 4,
                 add_mean: bool = True, reg_channels: int = 64):
        super().__init__(nc, ch, stride, reg_max, legacy)
        self.reg_topk, self.add_mean = reg_topk, add_mean
        stat_ch = 4 * (min(reg_topk, reg_max) + int(add_mean))
        self.reg_conf = nn.ModuleList(
            nn.Sequential(nn.Conv2d(stat_ch, reg_channels, 1), nn.ReLU(),
                          nn.Conv2d(reg_channels, 1, 1), nn.Sigmoid())
            for _ in ch)

    def quality(self, box_logits: torch.Tensor, i: int) -> torch.Tensor:
        """DGQP: top-k and mean of each side's DFL distribution -> (B, 1, H, W) in [0, 1].

        Runs in f32 (the 1e-7 tie-break is below bf16 resolution), autocast or not."""
        b, _, h, w = box_logits.shape
        with torch.autocast(box_logits.device.type, enabled=False):
            prob = box_logits.float().view(b, 4, self.reg_max, h, w).softmax(dim=2)
            parts = [topk_small(prob, min(self.reg_topk, self.reg_max), dim=2)]
            if self.add_mean:
                parts.append(prob.mean(dim=2, keepdim=True))
            stat = torch.cat(parts, dim=2).flatten(1, 2)  # side-major, (B, 4*(k+1), H, W)
            return self.reg_conf[i](stat)

    def forward(self, xs):
        boxes, feats = self.towers(xs)
        quality = [self.quality(bx, i) for i, bx in enumerate(boxes)]
        out = {"feats": feats, "quality": quality}
        if not self.training:
            out["pred"] = self.decode(feats, quality)
        return out
