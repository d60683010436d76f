"""Task-aligned assigner over padded targets (edgeyolo_tpu/train/tal.py).

Dense masked algebra over the (B, M, A) lattice, as the JAX package does:
  align = score^alpha * CIoU^beta over anchor-centre-in-gt and real gts;
  the top-k anchors per gt, lowest index first among ties;
  an anchor claimed by several gts goes to the gt it overlaps most;
  target scores = one-hot x (align / max align) x max IoU of the gt.

`rotated_task_aligned_assign` (the obb task's) is the same over xywhr boxes:
probiou for the overlap, and an anchor is a candidate when its centre lies
strictly inside the gt's rotated rectangle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from edgeyolo_tpu_torch.ops.boxes import bbox_iou, probiou


def _topk_mask(align: torch.Tensor, k: int) -> torch.Tensor:
    """0/1 mask of the k largest entries along the last axis, by k argmax-and-mask
    passes. torch.argmax returns the first maximal index, so ties go to the
    lowest index, as in JAX; torch.topk promises no tie order."""
    x = align
    iota = torch.arange(align.shape[-1], device=align.device)
    mask = torch.zeros(align.shape, dtype=torch.float32, device=align.device)
    for _ in range(k):
        hit = iota == x.argmax(dim=-1, keepdim=True)
        mask = mask + hit
        x = x.masked_fill(hit, -torch.inf)
    return mask


@torch.no_grad()
def task_aligned_assign(pd_scores: torch.Tensor, pd_bboxes: torch.Tensor,
                        anc_points: torch.Tensor, gt_labels: torch.Tensor,
                        gt_bboxes: torch.Tensor, mask_gt: torch.Tensor, topk: int = 10,
                        num_classes: int = 80, alpha: float = 0.5, beta: float = 6.0,
                        eps: float = 1e-9):
    """pd_scores (B, A, nc) sigmoid probabilities, pd_bboxes (B, A, 4) xyxy and
    anc_points (A, 2) in image units; gt_labels (B, M), gt_bboxes (B, M, 4)
    xyxy, mask_gt (B, M) 1 for real gts.

    Returns (target_labels (B, A), target_bboxes (B, A, 4), target_scores
    (B, A, nc), fg_mask (B, A) bool, target_gt_idx (B, A)).
    """
    mask_gt_f = mask_gt.float()[..., None]  # (B, M, 1)

    # candidates: anchor centres strictly inside each gt box
    lt, rb = gt_bboxes[:, :, None, :2], gt_bboxes[:, :, None, 2:]
    deltas = torch.cat([anc_points[None, None] - lt, rb - anc_points[None, None]], dim=-1)
    mask_in_gts = (deltas.amin(dim=-1) > eps).float()  # (B, M, A)

    ious = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False, CIoU=True)
    return _assign(pd_scores, gt_labels, gt_bboxes, mask_in_gts, mask_gt_f,
                   ious.squeeze(-1), topk, alpha, beta, eps)


def _assign(pd_scores, gt_labels, gt_boxes, mask_in_gts, mask_gt_f, ious, topk, alpha, beta,
            eps):
    """The assignment from the candidates mask_in_gts (B, M, A) and the
    overlaps ious (B, M, A) of every gt with every predicted box."""
    b, a, nc = pd_scores.shape
    m, nb = gt_boxes.shape[1], gt_boxes.shape[-1]
    gate = mask_in_gts * mask_gt_f

    # alignment metric
    labels = gt_labels.clamp(0, nc - 1).long()
    bbox_scores = pd_scores.transpose(1, 2).gather(
        1, labels[:, :, None].expand(b, m, a)) * gate  # (B, M, A)
    overlaps = ious.clamp(min=0.0) * gate
    align = bbox_scores.pow(alpha) * overlaps.pow(beta)

    # top-k anchors per gt
    mask_topk = _topk_mask(align, min(topk, a)) * mask_gt_f
    mask_topk = torch.where(mask_topk > 1, 0.0, mask_topk)
    mask_pos = mask_topk * mask_in_gts * mask_gt_f  # (B, M, A)

    # anchors claimed by several gts: the most-overlapping gt wins
    multi = mask_pos.sum(dim=1, keepdim=True) > 1.0
    is_max = F.one_hot(overlaps.argmax(dim=1), m).float().transpose(1, 2)  # (B, M, A)
    mask_pos = torch.where(multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(dim=1) > 0
    target_gt_idx = mask_pos.argmax(dim=1)  # an all-zero column gives index 0, as in JAX

    # gather targets
    target_labels = labels.gather(1, target_gt_idx)
    target_bboxes = gt_boxes.gather(1, target_gt_idx[..., None].expand(b, a, nb))
    target_scores = F.one_hot(target_labels, nc).float() * fg_mask[..., None]

    # per-gt normalisation
    align_pos = align * mask_pos
    pos_align = align_pos.amax(dim=-1, keepdim=True)
    pos_overlap = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
    norm = (align_pos * pos_overlap / (pos_align + eps)).amax(dim=1)  # (B, A)
    target_scores = target_scores * norm[..., None]
    return target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx


@torch.no_grad()
def rotated_task_aligned_assign(pd_scores: torch.Tensor, pd_rboxes: torch.Tensor,
                                anc_points: torch.Tensor, gt_labels: torch.Tensor,
                                gt_rboxes: torch.Tensor, mask_gt: torch.Tensor, topk: int = 10,
                                num_classes: int = 80, alpha: float = 0.5, beta: float = 6.0,
                                eps: float = 1e-9):
    """`task_aligned_assign` over xywhr boxes (B, A, 5) and (B, M, 5) in image
    units: probiou overlaps, candidates the anchors strictly inside the
    rotated gt. Returns the same five tensors, target boxes (B, A, 5)."""
    mask_gt_f = mask_gt.float()[..., None]
    cx, cy = gt_rboxes[..., 0:1], gt_rboxes[..., 1:2]  # (B, M, 1)
    w, h, r = gt_rboxes[..., 2:3], gt_rboxes[..., 3:4], gt_rboxes[..., 4:5]
    dx = anc_points[None, None, :, 0] - cx  # (B, M, A)
    dy = anc_points[None, None, :, 1] - cy
    cos, sin = torch.cos(r), torch.sin(r)
    lx, ly = dx * cos + dy * sin, -dx * sin + dy * cos  # into the box's frame
    mask_in = ((lx.abs() < w / 2) & (ly.abs() < h / 2)).float()
    ious = probiou(gt_rboxes[:, :, None, :], pd_rboxes[:, None, :, :])[..., 0]
    return _assign(pd_scores, gt_labels, gt_rboxes, mask_in, mask_gt_f, ious, topk, alpha, beta,
                   eps)
