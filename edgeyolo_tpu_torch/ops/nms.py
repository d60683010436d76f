"""Batched, fixed-shape, class-aware NMS (edgeyolo_tpu/ops/nms.py).

Per image: the best class of each anchor is gated at `conf_thres` (masked,
not filtered), the `max_nms` best candidates are kept, boxes are shifted by
class * MAX_WH so one agnostic pass is class-aware, and greedy suppression
runs by one of two methods:

- "matrix": the greedy fixed point on the full IoU matrix,
  alive_i <- valid_i and not any(alive_j and iou[j, i] > thres, j < i),
  iterated until nothing changes (a Python loop; a handful of sweeps in
  practice, at most n). This is the serving path.
- "scan": max_det sequential greedy picks, torchvision's semantics; kept as
  the oracle the tests hold the matrix method against.

Output: (B, max_det, 6) [x1, y1, x2, y2, conf, cls], zero rows past the
count, and the count (B,) int32. Rankings use a stable descending sort, so
ties go to the lower index as in jax.lax.top_k.
"""

from __future__ import annotations

from typing import Sequence

import torch

from edgeyolo_tpu_torch.ops.boxes import xywh2xyxy

MAX_WH = 7680.0  # class offset: boxes of different classes never overlap


def _top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, ...) indexed by idx (B, k) along dim 1."""
    if x.ndim == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(B, n, 4) xyxy -> (B, n, n)."""
    x1 = torch.maximum(boxes[:, :, None, 0], boxes[:, None, :, 0])
    y1 = torch.maximum(boxes[:, :, None, 1], boxes[:, None, :, 1])
    x2 = torch.minimum(boxes[:, :, None, 2], boxes[:, None, :, 2])
    y2 = torch.minimum(boxes[:, :, None, 3], boxes[:, None, :, 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    return inter / (area[:, :, None] + area[:, None, :] - inter + 1e-7)


def _iou_1_vs_all(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(B, 4) against (B, n, 4) -> (B, n)."""
    x1 = torch.maximum(box[:, None, 0], boxes[..., 0])
    y1 = torch.maximum(box[:, None, 1], boxes[..., 1])
    x2 = torch.minimum(box[:, None, 2], boxes[..., 2])
    y2 = torch.minimum(box[:, None, 3], boxes[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    a1 = (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])
    a2 = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    return inter / (a1[:, None] + a2 - inter + 1e-7)


def greedy_nms_matrix(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int):
    """Greedy NMS as the fixed point of the IoU matrix; candidates sorted by score."""
    n = boxes.shape[1]
    iou = _pairwise_iou(boxes)
    higher = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)  # [j, i]: j < i
    sup_edge = higher & (iou > iou_thres)
    valid0 = scores > 0.0
    alive = valid0
    for _ in range(n):
        suppressed = (sup_edge & alive[:, :, None]).any(dim=1)
        new_alive = valid0 & ~suppressed
        if torch.equal(new_alive, alive):
            break
        alive = new_alive
    kept = torch.where(alive, scores, 0.0)
    top, idx = _top_k(kept, min(max_det, n))
    return idx, top > 0.0


def greedy_nms_scan(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int):
    """Sequential greedy NMS: max_det picks of the best box still alive."""
    alive = scores.clone()
    ar = torch.arange(boxes.shape[1], device=boxes.device)
    picks, valids = [], []
    for _ in range(max_det):
        best, idx = alive.max(dim=1)
        valid = best > 0.0
        iou = _iou_1_vs_all(_gather(boxes, idx[:, None])[:, 0], boxes)
        suppress = (iou > iou_thres) | (ar[None] == idx[:, None])
        alive = torch.where(valid[:, None] & suppress, 0.0, alive)
        picks.append(idx)
        valids.append(valid)
    return torch.stack(picks, dim=1), torch.stack(valids, dim=1)


def non_max_suppression(pred: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                        max_det: int = 300, max_nms: int = 4096, agnostic: bool = False,
                        method: str = "matrix", classes: Sequence[int] | None = None):
    """pred (B, A, 4 + nc): xywh pixels and class scores -> (dets, n_valid).

    One label per anchor (its best class). `classes` keeps only those class
    ids (the others' scores are zeroed before the gate).
    """
    if method not in ("matrix", "scan"):
        raise ValueError(f"unknown NMS method '{method}'")
    a, nc = pred.shape[1], pred.shape[2] - 4
    boxes = xywh2xyxy(pred[..., :4])
    scores = pred[..., 4:]
    if classes is not None:
        keep = torch.zeros(nc, dtype=scores.dtype, device=scores.device)
        keep[list(classes)] = 1.0
        scores = scores * keep
    best, cls_all = scores.max(dim=-1)
    top_sc, anchor_ix = _top_k(best, min(max_nms, a))
    cand_boxes = _gather(boxes, anchor_ix)
    cls_ix = cls_all.gather(1, anchor_ix).to(pred.dtype)
    cand_sc = torch.where(top_sc > conf_thres, top_sc, 0.0)
    offset = torch.zeros_like(cls_ix) if agnostic else cls_ix * MAX_WH
    nms = greedy_nms_matrix if method == "matrix" else greedy_nms_scan
    keep_idx, keep_valid = nms(cand_boxes + offset[..., None], cand_sc, iou_thres, max_det)
    det = torch.cat([_gather(cand_boxes, keep_idx),
                     (cand_sc.gather(1, keep_idx) * keep_valid)[..., None],
                     cls_ix.gather(1, keep_idx)[..., None]], dim=-1)
    det = torch.where(keep_valid[..., None], det, 0.0)
    return det, keep_valid.sum(dim=1).to(torch.int32)
