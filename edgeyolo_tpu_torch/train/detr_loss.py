"""RT-DETR's training criterion (edgeyolo_tpu/train/detr_loss.py):
contrastive-denoising query groups, an auction matcher, and the varifocal,
L1 and GIoU terms over the matched pairs.

- `make_cdn_group`: JAX's static layout. The padded gt set of M slots is
  repeated 2g times (g = max(1, 100 // M)), D = 2gM queries; in each pair of
  copies the first is positive (box noise rand in [0, 1) times half the
  size at the centre and the size at the corners), the second negative
  (rand in [1, 2)); a label flips to a random class with probability
  cls_noise_ratio / 2; padding slots stay inert at 0.5. Its four draws
  (`cdn_draws`: flip, rnd_cls, sign, rand_part) come from an explicit
  generator, or are handed in (a test replays JAX's: its jax.random stream
  cannot be reproduced).
- `auction_assign`: the fixed-round parallel auction (Bertsekas) of JAX,
  64 rounds, every unassigned row bidding at once, eps = (max |cost| + 1) /
  (4 N) + 1e-6 (as XLA computes it: times the f32 reciprocal of 4N, fused
  with the add), ties to the first index, -1 for rows left unassigned or
  masked. It runs batched over every leading axis: one loop of 64 rounds
  matches every image of every matched output of a step (the decoder
  layers and the encoder proposals), where JAX vmaps per image and loops
  over the layers.
- `RTDETRDetectionLoss`: the matcher's cost is 2 (-p of the gt class) + 5 L1
  + 2 (1 - GIoU) on normalised cxcywh, rows of padding at 1e6; the class
  term is varifocal BCE against the matched IoU (weighted by that IoU on
  positives, 0.75 p^2 elsewhere) over the matched count; L1 and 1 - GIoU
  over the matched pairs; summed over the final layer, the other decoder
  layers and the encoder's proposals, and over the denoising queries of
  every layer (matched by construction), with gains 1 / 5 / 2 and the mean
  over images; the total times the batch size. As in JAX, the IoU target
  and the 0.75 p^2 weight carry gradient; the matching does not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from edgeyolo_tpu_torch.ops.boxes import bbox_iou, xywh2xyxy, xyxy2xywh
from edgeyolo_tpu_torch.train.loss import bce_logits

AUCTION_ROUNDS = 64


def cdn_draws(b: int, d: int, nc: int, generator: torch.Generator | None, device=None,
              cls_noise_ratio: float = 0.5) -> dict:
    """make_cdn_group's draws: flip (B, D) bool (a label flips), rnd_cls (B, D)
    its new class, sign (B, D, 4) +-1 and rand_part (B, D, 4) in [0, 1) of
    the box noise. Drawn on the CPU from `generator`, then moved to `device`."""
    flip = torch.rand(b, d, generator=generator) < cls_noise_ratio * 0.5
    rnd_cls = torch.randint(0, nc, (b, d), generator=generator)
    sign = torch.where(torch.rand(b, d, 4, generator=generator) < 0.5, 1.0, -1.0)
    rand_part = torch.rand(b, d, 4, generator=generator)
    return {k: v.to(device) for k, v in (("flip", flip), ("rnd_cls", rnd_cls), ("sign", sign),
                                           ("rand_part", rand_part))}


def make_cdn_group(gt_cls: torch.Tensor, gt_boxes: torch.Tensor, mask_gt: torch.Tensor, nc: int,
                   generator: torch.Generator | None = None, draws: dict | None = None,
                   num_dn: int = 100, cls_noise_ratio: float = 0.5,
                   box_noise_scale: float = 1.0) -> dict:
    """The denoising queries of one batch: gt_cls (B, M), gt_boxes (B, M, 4)
    normalised cxcywh, mask_gt (B, M). Returns {"cls" (B, D) int64, "bbox"
    (B, D, 4) normalised cxcywh, "valid" (B, D) f32, "neg" (D,) bool,
    "group_size" 2M, "num_groups" g}."""
    b = gt_boxes.shape[0]
    gt_cls = gt_cls.reshape(b, -1).long()
    m = gt_cls.shape[1]
    g = max(1, num_dn // max(m, 1))
    d = 2 * g * m
    device = gt_boxes.device
    neg = torch.cat([torch.zeros(m, dtype=torch.bool), torch.ones(m, dtype=torch.bool)]
                    ).repeat(g).to(device)
    cls_t = gt_cls.repeat(1, 2 * g)
    box_t = gt_boxes.float().repeat(1, 2 * g, 1)
    valid = (mask_gt.reshape(b, m) > 0).repeat(1, 2 * g)
    if draws is None:
        draws = cdn_draws(b, d, nc, generator, device, cls_noise_ratio)
    dn_cls = torch.where(draws["flip"] & valid, draws["rnd_cls"].long(), cls_t)
    wh = box_t[..., 2:]
    diff = torch.cat([wh * 0.5, wh], dim=-1)
    rand_part = draws["rand_part"] + neg.float()[None, :, None]
    xyxy = (xywh2xyxy(box_t) + draws["sign"] * rand_part * diff * box_noise_scale).clamp(0.0, 1.0)
    # noise per coordinate can swap corners: re-sort so the boxes stay valid
    lo = torch.minimum(xyxy[..., :2], xyxy[..., 2:])
    hi = torch.maximum(xyxy[..., :2], xyxy[..., 2:])
    dn_bbox = torch.where(valid[..., None], xyxy2xywh(torch.cat([lo, hi], dim=-1)), 0.5)
    return {"cls": dn_cls.clamp(0, nc - 1), "bbox": dn_bbox, "valid": valid.float(), "neg": neg,
            "group_size": 2 * m, "num_groups": g}


@torch.no_grad()
def auction_assign(cost: torch.Tensor, row_mask: torch.Tensor,
                   iters: int = AUCTION_ROUNDS) -> torch.Tensor:
    """eps-optimal assignment of rows (gts) to columns (queries), lower cost
    better: cost (..., M, N), row_mask (..., M) -> the column of each row
    (..., M), int64, -1 where unassigned or masked."""
    m, n = cost.shape[-2:]
    value = -cost
    # JAX's eps as XLA compiles it: the division by the constant 4N becomes a
    # product with its f32 reciprocal, fused with the + 1e-6 into one rounding
    # (f64 here is exact up to that rounding); bids that tie to the bit tell
    # the two apart
    recip, tiny = (torch.tensor(v, dtype=torch.float32).item() for v in (1.0 / (n * 4.0), 1e-6))
    eps = ((value.abs().flatten(-2).amax(-1) + 1.0).double() * recip + tiny).to(cost.dtype)
    prices = torch.zeros(cost.shape[:-2] + (n,), dtype=cost.dtype, device=cost.device)
    owner = torch.full(cost.shape[:-2] + (n,), -1, dtype=torch.long, device=cost.device)
    rows = torch.arange(m, device=cost.device)[:, None]
    cols = torch.arange(n, device=cost.device)
    neg_inf = torch.tensor(-torch.inf, dtype=cost.dtype, device=cost.device)
    eps = eps[..., None]
    for _ in range(iters):
        bidding = row_mask & (owner[..., None, :] != rows).all(dim=-1)  # valid and unassigned
        net = value - prices[..., None, :]
        best_val, best_col = net.max(dim=-1)
        best = cols == best_col[..., None]
        bid = best_val - torch.where(best, neg_inf, net).amax(dim=-1) + eps
        top_bid, top_row = torch.where(bidding[..., None] & best, bid[..., None],
                                       neg_inf).max(dim=-2)
        won = top_bid > -torch.inf
        prices = torch.where(won, prices + top_bid, prices)
        owner = torch.where(won, top_row, owner)
    has = owner[..., None, :] == rows
    return torch.where(row_mask & has.any(dim=-1), has.int().argmax(dim=-1), -1)


def _giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return bbox_iou(a, b, xywh=True, GIoU=True)[..., 0]


class RTDETRDetectionLoss:
    """Called with the head's training dict (f32) and a padded target batch
    {"cls" (B, M), "bboxes" (B, M, 4) normalised cxcywh, "mask_gt" (B, M),
    optional "dn" (make_cdn_group's)}; returns (total * B, {"cls", "l1",
    "giou"} of the final layer, and "dn"). `last_match` keeps the step's
    matched columns, (layers, B, M)."""

    def __init__(self, nc: int = 80, cls_gain: float = 1.0, bbox_gain: float = 5.0,
                 giou_gain: float = 2.0, cost_class: float = 2.0, cost_bbox: float = 5.0,
                 cost_giou: float = 2.0):
        self.nc = nc
        self.g = (cls_gain, bbox_gain, giou_gain)
        self.c = (cost_class, cost_bbox, cost_giou)
        self.last_match = None

    @classmethod
    def for_model(cls, model, hyp: dict | None = None) -> "RTDETRDetectionLoss":
        return cls(nc=model.model[-1].nc)

    def match_cost(self, scores, boxes, gt_cls, gt_boxes, mask_gt) -> torch.Tensor:
        """scores (..., nq, nc) logits, boxes (..., nq, 4) against gt_cls
        (..., M), gt_boxes (..., M, 4), mask_gt (..., M) -> (..., M, nq)."""
        cc, cb, cg = self.c
        nc, m = scores.shape[-1], gt_cls.shape[-1]
        prob = scores.sigmoid()
        gc = gt_cls.long().clamp(0, nc - 1)[..., None, :].expand(*prob.shape[:-1], m)
        cls_cost = -prob.gather(-1, gc)  # (..., nq, M)
        l1 = (boxes[..., :, None, :] - gt_boxes[..., None, :, :]).abs().sum(dim=-1)
        giou = _giou(boxes[..., :, None, :], gt_boxes[..., None, :, :])
        cost = (cc * cls_cost + cb * l1 + cg * (1 - giou)).transpose(-1, -2)
        return torch.where(mask_gt[..., :, None] > 0, cost, 1e6)

    def _matched_terms(self, scores, boxes, col, gt_cls, gt_boxes):
        """Per layer and image: (cls, l1, giou), each (L, B)."""
        nq, nc = scores.shape[-2:]
        matched = col >= 0
        colc = col.clamp(0, nq - 1)
        pred_at = boxes.gather(-2, colc[..., None].expand(*colc.shape, 4))  # (L, B, M, 4)
        gb = gt_boxes.expand_as(pred_at)
        iou = bbox_iou(pred_at, gb, xywh=True)[..., 0].clamp(0, 1) * matched
        onehot = F.one_hot(colc, nq).float() * matched[..., None]  # (L, B, M, nq)
        cls_onehot = F.one_hot(gt_cls.long().clamp(0, nc - 1), nc).float()  # (B, M, nc)
        tgt = torch.einsum("lbmq,bmc->lbqc", onehot * iou[..., None], cls_onehot)
        pos = torch.einsum("lbmq,bmc->lbqc", onehot, cls_onehot) > 0
        w = torch.where(pos, tgt, 0.75 * scores.sigmoid() ** 2.0)
        n = matched.sum(dim=-1).clamp(min=1)
        lc = (bce_logits(scores, tgt) * w).sum(dim=(-2, -1)) / n
        lb = ((pred_at - gb).abs().sum(dim=-1) * matched).sum(dim=-1) / n
        lg = ((1 - _giou(pred_at, gb)) * matched).sum(dim=-1) / n
        return lc, lb, lg

    def _dn_terms(self, scores, boxes, dn: dict, gt_cls, gt_boxes) -> torch.Tensor:
        """The denoising loss of each layer, (L,): slot i targets the gt it was
        made from; negatives count in the class term only."""
        b, m = gt_cls.shape
        nc, d = scores.shape[-1], scores.shape[-2]
        tgt_cls = gt_cls.long().repeat(1, d // m)
        tgt_box = gt_boxes.repeat(1, d // m, 1)
        pos = (dn["valid"] > 0) & ~dn["neg"][None]
        iou = bbox_iou(boxes, tgt_box, xywh=True)[..., 0].clamp(0, 1) * pos
        onehot = F.one_hot(tgt_cls.clamp(0, nc - 1), nc).float()
        tgt = onehot * iou[..., None]
        w = torch.where(onehot * pos[..., None] > 0, tgt, 0.75 * scores.sigmoid() ** 2.0)
        denom = pos.sum(dim=1).clamp(min=1)[:, None, None]
        lc = (bce_logits(scores, tgt) * w / denom).sum(dim=(-2, -1))
        lb = ((boxes - tgt_box).abs().sum(dim=-1) * pos / denom[..., 0]).sum(dim=-1)
        lg = ((1 - _giou(boxes, tgt_box)) * pos / denom[..., 0]).sum(dim=-1)
        gc, gb, gg = self.g
        return gc * lc.mean(-1) + gb * lb.mean(-1) + gg * lg.mean(-1)

    def __call__(self, out: dict, batch: dict):
        gt_boxes = batch["bboxes"].float()
        b, m = gt_boxes.shape[:2]
        gt_cls = batch["cls"].reshape(b, m)
        mask_gt = batch.get("mask_gt")
        if mask_gt is None:
            mask_gt = (gt_boxes.sum(dim=-1) > 0).float()
        mask_gt = mask_gt.reshape(b, m)
        (dec_b, dec_s), (aux_b, aux_s) = out["feats"], out.get("aux", ([], []))
        layers_b, layers_s = [dec_b, *aux_b[:-1]], [dec_s, *aux_s[:-1]]
        if "enc_scores" in out:
            layers_b.append(out["enc_bboxes"])
            layers_s.append(out["enc_scores"])
        scores, boxes = torch.stack(layers_s), torch.stack(layers_b)
        with torch.no_grad():
            cost = self.match_cost(scores, boxes, gt_cls, gt_boxes, mask_gt)
            col = auction_assign(cost, (mask_gt > 0).expand(len(layers_b), b, m))
        self.last_match = col
        lc, lb, lg = self._matched_terms(scores, boxes, col, gt_cls, gt_boxes)
        gc, gb, gg = self.g
        total = (gc * lc.mean(-1) + gb * lb.mean(-1) + gg * lg.mean(-1)).sum()
        items = {"cls": lc[0].mean().detach(), "l1": lb[0].mean().detach(),
                 "giou": lg[0].mean().detach()}
        dn = batch.get("dn")
        if dn is not None and "dn_feats" in out:
            (db, ds), (dab, das) = out["dn_feats"], out.get("dn_aux", ([], []))
            dn_total = self._dn_terms(torch.stack([ds, *das[:-1]]), torch.stack([db, *dab[:-1]]),
                                      dn, gt_cls, gt_boxes).sum()
            total = total + dn_total
            items["dn"] = dn_total.detach()
        return total * b, items
