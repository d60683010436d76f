"""The detection criteria (edgeyolo_tpu/train/loss.py): TAL assignment, the
quality-joint BCE, CIoU and DFL, over fixed-shape padded targets; and
E2EDetectLoss for the NMS-free heads, the sum of that criterion over the
one2many branch (TAL top-10) and over the one2one branch (top-1), each
branch with its own quality.

SegmentationLoss adds the mask term: each foreground anchor's mask logits
(its coefficients against its image's prototypes), BCE against the mask of
the gt it was assigned, cropped to that gt's box on the prototype grid,
averaged over the grid and divided by the box's normalised area (clipped at
1e-3); summed with the per-image weights, divided by their sum over the
foreground (the positive count, not target_scores_sum) and scaled by the box
gain. JAX forms the logits and the BCE densely over every anchor, (B, A, ph,
pw), and weighs the background by 0; the port computes the same sum over the
foreground anchors alone, image by image, so no (B, A, ph, pw) tensor exists
(at batch 32 x 640 px that one would hold 6.9e9 elements).

PoseLoss adds the keypoint terms: each foreground anchor's keypoints,
decoded to pixels as (raw * 2 + anchor - 0.5) * stride, against those of
the gt it was assigned, by OKS (1 - exp(-d^2 / (2 sigma)^2 / area / 2) on the
visible keypoints; COCO's sigmas for 17 keypoints, else 1/K; the area the
assigned box's, clipped at 1e-3), and a BCE of the visibility logit against
the gt's visibility; the `pose` and `kobj` gains. OBBLoss is the rotated
criterion: the rotated assigner over probiou, 1 - probiou for the box term
(a dummy unit box on the background anchors, masked by a where, keeps
probiou's infinite derivative at a degenerate box out of the gradient) and
DFL on the axis-aligned ltrb of the unrotated target.

ClassificationLoss is softmax cross-entropy over the (B, nc) logits, the
per-image weights leaving padded duplicates out of the mean.

The head hands in NCHW maps; `DetectionLoss` flattens them to (B, A, no) in
row-major anchor order per level, the order of JAX's NHWC reshape and of
`make_anchors`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from edgeyolo_tpu_torch.nn.modules.block import dfl_decode
from edgeyolo_tpu_torch.ops.boxes import (bbox2dist, bbox_iou, dist2bbox, dist2rbox, make_anchors,
                                          probiou, xywh2xyxy)
from edgeyolo_tpu_torch.ops.segments import crop_mask
from edgeyolo_tpu_torch.train.tal import rotated_task_aligned_assign, task_aligned_assign


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, JAX's stable form."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def df_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution Focal Loss: pred_dist (..., 4, reg_max) logits, target (..., 4)
    in bin units -> (...), the mean over the 4 sides. The two bins' weights
    come from an iota compare, with no gather, as in JAX."""
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = pred_dist.log_softmax(dim=-1)
    bins = torch.arange(reg_max, device=pred_dist.device)
    w = (wl[..., None] * (bins == tl[..., None])
         + wr[..., None] * (bins == tr.clamp(0, reg_max - 1)[..., None]))
    return (-(logp * w).sum(dim=-1)).mean(dim=-1)


class DetectionLoss:
    """v8-style detection criterion bound to the head's geometry.

    Call with the head's per-level NCHW feats (B, 4*reg_max + nc, H, W), the
    per-level qualities (B, 1, H, W) or None, and a padded target batch
    {"cls": (B, M), "bboxes": (B, M, 4) normalised xywh, "mask_gt": (B, M),
    optional "img_weight": (B,)}. Returns (total, {"box", "cls", "dfl"}).
    """

    def __init__(self, nc: int = 80, reg_max: int = 16, stride: Sequence[int] = (8, 16, 32),
                 hyp: dict | None = None, tal_topk: int = 10):
        hyp = hyp or {}
        self.nc, self.reg_max, self.stride, self.tal_topk = nc, reg_max, tuple(stride), tal_topk
        self.box_gain = float(hyp.get("box", 7.5))
        self.cls_gain = float(hyp.get("cls", 0.5))
        self.dfl_gain = float(hyp.get("dfl", 1.5))

    @classmethod
    def for_model(cls, model, hyp: dict | None = None) -> "DetectionLoss":
        head = model.model[-1]
        return cls(nc=head.nc, reg_max=head.reg_max, stride=head.stride, hyp=hyp)

    def __call__(self, feats: Sequence[torch.Tensor], batch: dict,
                 quality: Sequence[torch.Tensor] | None = None):
        return self._terms(feats, batch, quality)[:2]

    def _terms(self, feats: Sequence[torch.Tensor], batch: dict,
               quality: Sequence[torch.Tensor] | None = None):
        """(total, items, the assignment: target boxes in pixels, foreground,
        assigned gt index, per-image weight, input size)."""
        nc, reg_max = self.nc, self.reg_max
        b = feats[0].shape[0]
        device = feats[0].device
        flat = torch.cat([f.flatten(2) for f in feats], dim=2).transpose(1, 2)  # (B, A, no)
        pred_dist, pred_scores = flat.split((4 * reg_max, nc), dim=-1)
        a = flat.shape[1]
        anchor_points, stride_tensor = make_anchors([f.shape[-2:] for f in feats], self.stride,
                                                    device=device)
        img_h = feats[0].shape[2] * self.stride[0]
        img_w = feats[0].shape[3] * self.stride[0]

        # targets: normalised xywh -> pixel xyxy
        gt_cls = batch["cls"].long()
        scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=device)
        gt_bboxes = xywh2xyxy(batch["bboxes"] * scale)
        mask_gt = batch.get("mask_gt")
        if mask_gt is None:
            mask_gt = (batch["bboxes"].sum(dim=-1) > 0).float()

        pred_bboxes = dist2bbox(dfl_decode(pred_dist, reg_max), anchor_points[None], xywh=False)
        _, target_bboxes, target_scores, fg_mask, target_gt_idx = task_aligned_assign(
            pred_scores.detach().sigmoid(), pred_bboxes.detach() * stride_tensor[None],
            anchor_points * stride_tensor, gt_cls, gt_bboxes, mask_gt,
            topk=self.tal_topk, num_classes=nc, alpha=0.5, beta=6.0)

        # per-image weight: 0 for the padded duplicates of a fixed-shape batch
        wimg = batch.get("img_weight")
        if wimg is not None:
            target_scores = target_scores * wimg[:, None, None]
        target_scores_sum = target_scores.sum().clamp(min=1.0)
        wb = wimg[:, None, None] if wimg is not None else 1.0  # no cls negatives either

        # classification: BCE on the joint sigmoid(cls) x quality when the head emits it
        if quality is not None:
            q = torch.cat([qi.reshape(b, -1, 1) for qi in quality], dim=1)
            j = (pred_scores.sigmoid() * q).clamp(1e-6, 1 - 1e-6)
            loss_cls = (bce_logits(torch.log(j / (1 - j)), target_scores) * wb).sum()
        else:
            loss_cls = (bce_logits(pred_scores, target_scores) * wb).sum()
        loss_cls = loss_cls / target_scores_sum

        # box: CIoU weighted by the target score, DFL to the ltrb bins
        fg = fg_mask.float()
        weight = target_scores.sum(dim=-1) * fg
        tb_grid = target_bboxes / stride_tensor[None]
        # a zero-gt image puts (0, 0, 0, 0) targets on every anchor, whose CIoU
        # is 0/0; a safe dummy box under a where keeps the NaN out of the grads
        dummy = torch.tensor([0.0, 0.0, 1.0, 1.0], device=device)
        safe_tb = torch.where(fg[..., None] > 0, tb_grid, dummy)
        iou = bbox_iou(pred_bboxes, safe_tb, xywh=False, CIoU=True)[..., 0]
        loss_iou = torch.where(fg > 0, (1.0 - iou) * weight, 0.0).sum() / target_scores_sum

        target_ltrb = bbox2dist(anchor_points[None], tb_grid, reg_max - 1)
        dl = df_loss(pred_dist.reshape(b, a, 4, reg_max), target_ltrb, reg_max)
        loss_dfl = (dl * weight).sum() / target_scores_sum

        loss_box = loss_iou * self.box_gain
        loss_cls = loss_cls * self.cls_gain
        loss_dfl = loss_dfl * self.dfl_gain
        # the reference's total is the sum times the batch's real-image count
        n_img = wimg.sum() if wimg is not None else b
        total = (loss_box + loss_cls + loss_dfl) * n_img
        items = {"box": loss_box.detach(), "cls": loss_cls.detach(), "dfl": loss_dfl.detach()}
        assign = {"target_bboxes": target_bboxes, "fg_mask": fg_mask,
                  "target_gt_idx": target_gt_idx, "img_weight": wimg, "imgsz": (img_h, img_w),
                  "anchors": anchor_points, "strides": stride_tensor}
        return total, items, assign


class SegmentationLoss(DetectionLoss):
    """The detection criterion plus the mask term; called with the Segment
    head's training dict {"feats", "mask_coefs" (B, A, nm), "proto" (B, nm,
    ph, pw)} and a batch whose "masks" (B, M, ph, pw) are 0/1 instance masks
    at the prototype resolution. Returns (total, {"box", "cls", "dfl", "seg"})."""

    def __call__(self, out: dict, batch: dict):
        total, items, assign = self._terms(out["feats"], batch, out.get("quality"))
        masks = batch.get("masks")
        if masks is None:
            return total, items
        loss_seg = self.mask_term(out, masks, assign)
        items = {**items, "seg": loss_seg.detach()}
        wimg = assign["img_weight"]
        n_img = wimg.sum() if wimg is not None else masks.shape[0]
        return total + loss_seg * n_img, items

    def mask_term(self, out: dict, masks: torch.Tensor, assign: dict) -> torch.Tensor:
        """The mask loss (before the image count) over the foreground anchors."""
        mc, proto = out["mask_coefs"].float(), out["proto"].float()
        b, nm, ph, pw = proto.shape
        img_h, img_w = assign["imgsz"]
        fg, wimg = assign["fg_mask"], assign["img_weight"]
        norm = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=mc.device)
        grid = torch.tensor([pw, ph, pw, ph], dtype=torch.float32, device=mc.device)
        seg_sum = mc.new_zeros(())
        for i in range(b):  # the foreground anchors of one image at a time
            ai = fg[i].nonzero()[:, 0]
            if not len(ai):
                continue
            xyxyn = assign["target_bboxes"][i, ai] / norm
            area = ((xyxyn[:, 2] - xyxyn[:, 0]) * (xyxyn[:, 3] - xyxyn[:, 1])).clamp(min=1e-3)
            logits = (mc[i, ai] @ proto[i].reshape(nm, ph * pw)).view(-1, ph, pw)
            tgt = masks[i][assign["target_gt_idx"][i, ai]].to(logits.dtype)
            bce = crop_mask(bce_logits(logits, tgt), xyxyn * grid)
            per_anchor = bce.flatten(1).mean(-1) / area
            seg_sum = seg_sum + per_anchor.sum() * (wimg[i] if wimg is not None else 1.0)
        w_sum = (fg.float() * (wimg[:, None] if wimg is not None else 1.0)).sum()
        return seg_sum / w_sum.clamp(min=1.0) * self.box_gain


class E2EDetectLoss:
    """one2many (TAL topk 10) + one2one (topk 1), each with its own quality;
    called with the head's whole output dict and a padded target batch."""

    def __init__(self, nc: int = 80, reg_max: int = 16, stride: Sequence[int] = (8, 16, 32),
                 hyp: dict | None = None):
        self.one2many = DetectionLoss(nc, reg_max, stride, hyp, tal_topk=10)
        self.one2one = DetectionLoss(nc, reg_max, stride, hyp, tal_topk=1)

    @classmethod
    def for_model(cls, model, hyp: dict | None = None) -> "E2EDetectLoss":
        head = model.model[-1]
        return cls(nc=head.nc, reg_max=head.reg_max, stride=head.stride, hyp=hyp)

    def __call__(self, out: dict, batch: dict):
        l1, i1 = self.one2many(out["feats"], batch, out.get("quality"))
        l2, i2 = self.one2one(out["one2one_feats"], batch, out.get("one2one_quality"))
        return l1 + l2, {k: i1[k] + i2[k] for k in i1}


# COCO's 17 keypoint sigmas
COCO_SIGMAS = (0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072, 0.062, 0.062,
               0.107, 0.107, 0.087, 0.087, 0.089, 0.089)


class PoseLoss(DetectionLoss):
    """The detection criterion plus the keypoint location and visibility
    terms; called with the Pose head's training dict {"feats", "kpts_raw"
    (B, A, K * D)} and a batch whose "keypoints" (B, M, K, 3) are in input
    pixels. Returns (total, {"box", "cls", "dfl", "kpt"})."""

    def __init__(self, nc: int = 80, reg_max: int = 16, stride: Sequence[int] = (8, 16, 32),
                 hyp: dict | None = None, tal_topk: int = 10,
                 kpt_shape: Sequence[int] = (17, 3)):
        super().__init__(nc, reg_max, stride, hyp, tal_topk)
        hyp = hyp or {}
        self.kpt_shape = tuple(int(k) for k in kpt_shape)
        self.pose_gain = float(hyp.get("pose", 12.0))
        self.kobj_gain = float(hyp.get("kobj", 1.0))

    @classmethod
    def for_model(cls, model, hyp: dict | None = None) -> "PoseLoss":
        head = model.model[-1]
        return cls(nc=head.nc, reg_max=head.reg_max, stride=head.stride, hyp=hyp,
                   kpt_shape=head.kpt_shape)

    def __call__(self, out: dict, batch: dict):
        total, items, assign = self._terms(out["feats"], batch, out.get("quality"))
        gt_kpts = batch.get("keypoints")
        if gt_kpts is None:
            return total, items
        k, d = self.kpt_shape
        fg, wimg = assign["fg_mask"], assign["img_weight"]
        b, a = fg.shape
        anchors, strides = assign["anchors"], assign["strides"]
        y = out["kpts_raw"].float().view(b, a, k, d)
        pk_xy = (y[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * strides[None, :, None, :]
        idx = assign["target_gt_idx"][:, :, None, None].expand(b, a, k, gt_kpts.shape[-1])
        tgt = gt_kpts.gather(1, idx)  # (B, A, K, 3)
        vis = (tgt[..., 2] > 0).float()
        tb = assign["target_bboxes"]
        area = ((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1])).clamp(min=1e-3)[..., None]
        d2 = (pk_xy - tgt[..., :2]).square().sum(dim=-1)  # (B, A, K)
        sigmas = (torch.tensor(COCO_SIGMAS, device=y.device) if k == 17
                  else torch.full((k,), 1.0 / k, device=y.device))
        e = d2 / (2 * sigmas) ** 2 / (area + 1e-9) / 2
        w = fg.float()[..., None]
        if wimg is not None:
            w = w * wimg[:, None, None]
        loss_kpt = ((1 - torch.exp(-e)) * vis * w).sum() / (vis * w).sum().clamp(min=1.0) \
            * self.pose_gain
        loss_kobj = 0.0
        if d == 3:
            loss_kobj = (bce_logits(y[..., 2], vis) * w).sum() / (w.sum() * k).clamp(min=1.0) \
                * self.kobj_gain
        n_img = wimg.sum() if wimg is not None else b
        return total + (loss_kpt + loss_kobj) * n_img, {**items, "kpt": loss_kpt.detach()}


class OBBLoss(DetectionLoss):
    """The rotated criterion; called with the OBB head's training dict
    {"feats", "angle" (B, A, 1)} and a batch whose "bboxes" (B, M, 5) are
    normalised cx, cy, w, h and the angle. Returns (total, {"box", "cls", "dfl"})."""

    def __call__(self, out: dict, batch: dict):
        feats, angle = out["feats"], out["angle"].float()
        nc, reg_max = self.nc, self.reg_max
        device = feats[0].device
        flat = torch.cat([f.flatten(2) for f in feats], dim=2).transpose(1, 2)
        pred_dist, pred_scores = flat.split((4 * reg_max, nc), dim=-1)
        b, a = flat.shape[:2]
        anchors, strides = make_anchors([f.shape[-2:] for f in feats], self.stride, device=device)
        img_h = feats[0].shape[2] * self.stride[0]
        img_w = feats[0].shape[3] * self.stride[0]

        gtb = batch["bboxes"]
        scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=device)
        gt_rboxes = torch.cat([gtb[..., :4] * scale, gtb[..., 4:5]], dim=-1)
        mask_gt = batch.get("mask_gt")
        if mask_gt is None:
            mask_gt = (gtb[..., :4].sum(dim=-1) > 0).float()
        pred_g = torch.cat([dist2rbox(dfl_decode(pred_dist, reg_max), angle, anchors[None]),
                            angle], dim=-1)  # grid units and the angle
        pred_px = torch.cat([pred_g[..., :4] * strides[None], angle], dim=-1)
        _, target_rboxes, target_scores, fg_mask, _ = rotated_task_aligned_assign(
            pred_scores.detach().sigmoid(), pred_px.detach(), anchors * strides,
            batch["cls"].long(), gt_rboxes, mask_gt, topk=self.tal_topk, num_classes=nc)
        wimg = batch.get("img_weight")
        if wimg is not None:
            target_scores = target_scores * wimg[:, None, None]
        target_scores_sum = target_scores.sum().clamp(min=1.0)
        wb = wimg[:, None, None] if wimg is not None else 1.0
        loss_cls = (bce_logits(pred_scores, target_scores) * wb).sum() / target_scores_sum

        fg = fg_mask.float()
        weight = target_scores.sum(dim=-1) * fg
        tb_grid = torch.cat([target_rboxes[..., :4] / strides[None], target_rboxes[..., 4:5]],
                            dim=-1)
        # a background anchor's target is a padded (0, 0, 0, 0, 0) box, where
        # probiou's derivative is infinite; a unit box under the where keeps it out
        dummy = torch.tensor([0.0, 0.0, 1.0, 1.0, 0.0], device=device)
        safe_tb = torch.where(fg[..., None] > 0, tb_grid, dummy)
        iou = probiou(pred_g, safe_tb)[..., 0]
        loss_iou = torch.where(fg > 0, (1.0 - iou) * weight, 0.0).sum() / target_scores_sum

        txy, twh = tb_grid[..., :2], tb_grid[..., 2:4]
        target_ltrb = bbox2dist(anchors[None], torch.cat([txy - twh / 2, txy + twh / 2], -1),
                                reg_max - 1)
        dl = df_loss(pred_dist.reshape(b, a, 4, reg_max), target_ltrb, reg_max)
        loss_dfl = (dl * weight).sum() / target_scores_sum

        loss_box = loss_iou * self.box_gain
        loss_cls = loss_cls * self.cls_gain
        loss_dfl = loss_dfl * self.dfl_gain
        n_img = wimg.sum() if wimg is not None else b
        total = (loss_box + loss_cls + loss_dfl) * n_img
        return total, {"box": loss_box.detach(), "cls": loss_cls.detach(),
                       "dfl": loss_dfl.detach()}


class ClassificationLoss:
    """Softmax cross-entropy; with batch["img_weight"] the weighted mean, so a
    padded duplicate (weight 0) counts nowhere. Returns (loss, {"cls": loss})."""

    def __call__(self, logits: torch.Tensor, batch: dict):
        labels = batch["cls"].long().reshape(-1)
        nll = -logits.float().log_softmax(-1).gather(1, labels[:, None])[:, 0]
        w = batch.get("img_weight")
        loss = nll.mean() if w is None else (nll * w).sum() / w.sum().clamp(min=1.0)
        return loss, {"cls": loss.detach()}
