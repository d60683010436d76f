"""Box math the heads, NMS, the losses and the validators need
(edgeyolo_tpu/ops/boxes.py): axis-aligned boxes, and the rotated (xywhr,
angle in radians) and keypoint ones of the obb and pose tasks."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

EPS = 1e-7


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    xy, wh = x[..., :2], x[..., 2:4] / 2
    return torch.cat([xy - wh, xy + wh], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([(x[..., :2] + x[..., 2:4]) / 2, x[..., 2:4] - x[..., :2]], dim=-1)


def make_anchors(feat_shapes: Sequence[tuple[int, int]], strides: Sequence[int], device=None):
    """Cell-centre anchors in grid units (A, 2) and per-anchor strides (A, 1), row-major per level."""
    points, strds = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + 0.5
        sy = torch.arange(h, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        strds.append(torch.full((h * w, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(points), torch.cat(strds)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True) -> torch.Tensor:
    """(l, t, r, b) distances around anchor centres -> xywh or xyxy boxes."""
    lt, rb = distance.chunk(2, dim=-1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True,
             CIoU: bool = False, GIoU: bool = False) -> torch.Tensor:
    """Elementwise IoU, CIoU or GIoU of broadcastable box tensors -> (..., 1).

    As JAX's: EPS goes into the heights of the xyxy branch only, and CIoU's
    alpha carries no gradient (stop_gradient there, detach here).
    """
    if xywh:
        x1, y1, w1, h1 = box1.chunk(4, dim=-1)
        x2, y2, w2, h2 = box2.chunk(4, dim=-1)
        b1x1, b1x2, b1y1, b1y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2x1, b2x2, b2y1, b2y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        b1x1, b1y1, b1x2, b1y2 = box1.chunk(4, dim=-1)
        b2x1, b2y1, b2x2, b2y2 = box2.chunk(4, dim=-1)
        w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + EPS
        w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + EPS
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + EPS
    iou = inter / union
    if not (CIoU or GIoU):
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    if not CIoU:  # GIoU: less the share of the enclosing box the union leaves empty
        c_area = cw * ch + EPS
        return iou - (c_area - union) / c_area
    c2 = cw ** 2 + ch ** 2 + EPS
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + EPS))).detach()
    return iou - (rho2 / c2 + v * alpha)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float) -> torch.Tensor:
    """xyxy boxes -> (l, t, r, b) distances from the anchors, clipped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1).clamp(0, reg_max - 0.01)


def box_iou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy sets, batched: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    a1, a2 = box1[..., :, None, :2], box1[..., :, None, 2:]
    b1, b2 = box2[..., None, :, :2], box2[..., None, :, 2:]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    area2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    return inter / (area1[..., :, None] + area2[..., None, :] - inter + EPS)


def dist2rbox(distance: torch.Tensor, angle: torch.Tensor, anchor_points: torch.Tensor
              ) -> torch.Tensor:
    """Rotated decode: (l, t, r, b) distances and angle (..., 1) around the
    anchors -> (cx, cy, w, h), the centre offset rotated by the angle."""
    lt, rb = distance.chunk(2, dim=-1)
    cos, sin = torch.cos(angle), torch.sin(angle)
    xf, yf = ((rb - lt) / 2).chunk(2, dim=-1)
    xy = torch.cat([xf * cos - yf * sin, xf * sin + yf * cos], dim=-1) + anchor_points
    return torch.cat([xy, lt + rb], dim=-1)


def _covariance(boxes: torch.Tensor):
    """Gaussian covariance terms (a, b, c) of xywhr boxes, each (..., 1)."""
    a = boxes[..., 2:3] ** 2 / 12.0
    b = boxes[..., 3:4] ** 2 / 12.0
    r = boxes[..., 4:5]
    cos, sin = torch.cos(r), torch.sin(r)
    cos2, sin2 = cos ** 2, sin ** 2
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, CIoU: bool = False,
            eps: float = EPS) -> torch.Tensor:
    """Probabilistic IoU (1 - Hellinger distance of the boxes' Gaussians) of
    broadcastable xywhr box tensors -> (..., 1). The clips and eps sit where
    JAX's do: sqrt(det1 * det2) has an infinite derivative at 0."""
    x1, y1 = obb1[..., 0:1], obb1[..., 1:2]
    x2, y2 = obb2[..., 0:1], obb2[..., 1:2]
    a1, b1, c1 = _covariance(obb1)
    a2, b2, c2 = _covariance(obb2)
    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom * 0.5
    det1 = (a1 * b1 - c1 ** 2).clamp(min=0)
    det2 = (a2 * b2 - c2 ** 2).clamp(min=0)
    t3 = torch.log(((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2)
                   / (4 * torch.sqrt(det1 * det2) + eps) + eps) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    iou = 1.0 - torch.sqrt(1.0 - torch.exp(-bd) + eps)
    if not CIoU:
        return iou
    w1, h1 = obb1[..., 2:3], obb1[..., 3:4]
    w2, h2 = obb2[..., 2:3], obb2[..., 3:4]
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - v * alpha


def kpt_iou(kpt1: torch.Tensor, kpt2: torch.Tensor, area: torch.Tensor, sigma,
            eps: float = EPS) -> torch.Tensor:
    """OKS of gt keypoints kpt1 (N, K, 3) against predictions kpt2 (M, K, 2+),
    with area (N,) the gt boxes' areas -> (N, M)."""
    d = ((kpt1[:, None, :, 0] - kpt2[None, :, :, 0]) ** 2
         + (kpt1[:, None, :, 1] - kpt2[None, :, :, 1]) ** 2)
    sigma = torch.as_tensor(sigma, dtype=kpt1.dtype, device=kpt1.device)
    kpt_mask = kpt1[..., 2] != 0
    e = d / ((2 * sigma) ** 2) / (area[:, None, None] + eps) / 2
    return (torch.exp(-e) * kpt_mask[:, None]).sum(-1) / (kpt_mask.sum(-1)[:, None] + eps)


def xywhr2xyxyxyxy(rbox):
    """(..., 5) [cx, cy, w, h, angle (rad)] -> (..., 4, 2) corners, going
    along the width first: a torch tensor for a tensor, else numpy f32."""
    if isinstance(rbox, torch.Tensor):
        cx, cy, w, h, r = rbox.unbind(-1)
        cos, sin, stack = torch.cos(r), torch.sin(r), torch.stack
    else:
        rbox = np.asarray(rbox, np.float32)
        cx, cy, w, h, r = (rbox[..., i] for i in range(5))
        cos, sin, stack = np.cos(r), np.sin(r), np.stack
    dx = stack([w / 2 * cos, w / 2 * sin], -1)
    dy = stack([-h / 2 * sin, h / 2 * cos], -1)
    c = stack([cx, cy], -1)
    return stack([c - dx - dy, c + dx - dy, c + dx + dy, c - dx + dy], -2)
