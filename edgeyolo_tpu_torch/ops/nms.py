"""Batched, fixed-shape, class-aware NMS (edgeyolo_tpu/ops/nms.py).

Per image: the best class of each anchor is gated at `conf_thres` (masked,
not filtered), the `max_nms` best candidates are kept, boxes are shifted by
class * MAX_WH so one agnostic pass is class-aware, and greedy suppression
runs by one of three methods:

- "matrix": the greedy fixed point on the full IoU matrix,
  alive_i <- valid_i and not any(alive_j and iou[j, i] > thres, j < i),
  iterated until nothing changes (a Python loop; a handful of sweeps in
  practice, at most n). This is the serving path.
- "scan": max_det sequential greedy picks, torchvision's semantics; kept as
  the oracle the tests hold the matrix method against.
- "tiled": the validator's path, one image at a time, for candidate counts
  (max_nms = 30000) whose n x n matrix would not fit: the score-sorted
  candidates above the gate are taken in blocks of NMS_TILE; each block is
  first suppressed by the boxes kept so far, then resolved by the matrix
  fixed point within the block (exact greedy, by induction over blocks),
  and the loop stops once max_det boxes are kept or no candidate is left.
  Peak memory per image: the n candidates, one tile x tile IoU block and one
  tile x max_det block against the kept boxes, O(n + tile^2 + tile*max_det)
  floats (4 MiB for the 1024 x 1024 block) whatever n is.

`multi_label` ranks the A*nc (anchor, class) scores instead of one best
class per anchor, as the JAX validator does: top-k over the flattened
scores, anchor = ix // nc, cls = ix % nc.

Output: (B, max_det, 6) [x1, y1, x2, y2, conf, cls], zero rows past the
count, and the count (B,) int32; with `return_idx` also the anchor index
(B, max_det) int32 of each kept row (0 past the count, as in JAX), which
gathers per-anchor extras such as the segment head's mask coefficients
or the pose head's keypoints. `nc` names the class columns when pred
carries such extras after them. Rankings use a stable descending sort, so
ties go to the lower index as in jax.lax.top_k.

`nms_rotated` (the obb task's) is JAX's single-pass matrix rule over
probiou, not greedy: a candidate is dropped when any higher-ranked
candidate of its class overlaps it above iou_thres, even one that was
itself dropped. Such a rule is a column-wise `any` over the rows of the
upper triangle, so it is computed exactly in blocks of rows, each against
the columns after it: the memory of a block is bounded by ROT_NMS_ELEMS
(image, row, column) triples whatever max_nms is (a dense (n, n) probiou at
n = 8192 for batch 32 would hold 2.1e9 pairs per temporary). Only the
candidates past the gate take part: a candidate at score 0 ranks after
every positive one and is never kept, so it suppresses nothing that
counts. `rotated_suppressed_dense` is the plain (B, n, n) version the
tests hold the blocks against.
"""

from __future__ import annotations

from typing import Sequence

import torch

from edgeyolo_tpu_torch.ops.boxes import box_iou, probiou, xywh2xyxy

MAX_WH = 7680.0  # class offset: boxes of different classes never overlap
NMS_TILE = 1024  # candidates per block of the tiled method
ROT_NMS_ELEMS = 1 << 24  # (image, row, column) triples per block of the rotated NMS


def _top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, ...) indexed by idx (B, k) along dim 1."""
    if x.ndim == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _greedy_alive(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """The candidates (B, n) that greedy NMS keeps, as the fixed point of the
    IoU matrix; candidates sorted by score, those at score 0 never kept."""
    n = boxes.shape[1]
    iou = box_iou(boxes, boxes)
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
    return alive


def greedy_nms_matrix(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int):
    """Greedy NMS as the fixed point of the IoU matrix; candidates sorted by score."""
    n = boxes.shape[1]
    kept = torch.where(_greedy_alive(boxes, scores, iou_thres), scores, 0.0)
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
        iou = box_iou(_gather(boxes, idx[:, None]), boxes)[:, 0]
        suppress = (iou > iou_thres) | (ar[None] == idx[:, None])
        alive = torch.where(valid[:, None] & suppress, 0.0, alive)
        picks.append(idx)
        valids.append(valid)
    return torch.stack(picks, dim=1), torch.stack(valids, dim=1)


def greedy_nms_tiled(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                     max_det: int):
    """Greedy NMS of one image's score-sorted candidates (n, 4), (n,), block by
    block; returns the kept indices in score order (at most max_det)."""
    n_valid = int((scores > 0.0).sum())
    kept = boxes.new_zeros((0, 4))
    kept_idx = []
    for start in range(0, n_valid, NMS_TILE):
        if len(kept) >= max_det:
            break
        end = min(start + NMS_TILE, n_valid)
        blk, sc = boxes[start:end], scores[start:end]
        if len(kept):
            sc = torch.where((box_iou(kept, blk) > iou_thres).any(dim=0), 0.0, sc)
        idx = _greedy_alive(blk[None], sc[None], iou_thres)[0].nonzero()[:, 0]
        kept = torch.cat([kept, blk[idx]])
        kept_idx.append(idx + start)
    if not kept_idx:
        return torch.zeros(0, dtype=torch.long, device=boxes.device)
    return torch.cat(kept_idx)[:max_det]


def _candidates(pred: torch.Tensor, conf_thres: float, max_nms: int, multi_label: bool,
                classes: Sequence[int] | None, nc: int):
    """The top max_nms (box, score, class, anchor) candidates of each image,
    by score; scores at or under conf_thres zeroed."""
    a = pred.shape[1]
    boxes = xywh2xyxy(pred[..., :4])
    scores = pred[..., 4:4 + nc]
    scores = _class_filter(scores, classes)
    if multi_label and nc > 1:
        top_sc, top_ix = _top_k(scores.reshape(scores.shape[0], -1), min(max_nms, a * nc))
        anchor_ix, cls_ix = top_ix // nc, (top_ix % nc).to(pred.dtype)
    else:
        best, cls_all = scores.max(dim=-1)
        top_sc, anchor_ix = _top_k(best, min(max_nms, a))
        cls_ix = cls_all.gather(1, anchor_ix).to(pred.dtype)
    cand_sc = torch.where(top_sc > conf_thres, top_sc, 0.0)
    return _gather(boxes, anchor_ix), cand_sc, cls_ix, anchor_ix


def non_max_suppression(pred: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                        max_det: int = 300, max_nms: int = 4096, agnostic: bool = False,
                        method: str = "matrix", classes: Sequence[int] | None = None,
                        multi_label: bool = False, nc: int | None = None,
                        return_idx: bool = False):
    """pred (B, A, 4 + nc [+ extras]): xywh pixels and class scores ->
    (dets, n_valid), and with `return_idx` the kept anchors' indices.

    One label per anchor (its best class) unless `multi_label`. `classes`
    keeps only those class ids (the others' scores are zeroed before the gate).
    """
    if method not in ("matrix", "scan", "tiled"):
        raise ValueError(f"unknown NMS method '{method}'")
    nc = nc or pred.shape[2] - 4
    cand_boxes, cand_sc, cls_ix, anchor_ix = _candidates(pred, conf_thres, max_nms, multi_label,
                                                         classes, nc)
    offset = torch.zeros_like(cls_ix) if agnostic else cls_ix * MAX_WH
    shifted = cand_boxes + offset[..., None]
    if method == "tiled":
        b, k = pred.shape[0], min(max_det, cand_sc.shape[1])
        keep_idx = torch.zeros(b, k, dtype=torch.long, device=pred.device)
        keep_valid = torch.zeros(b, k, dtype=torch.bool, device=pred.device)
        for i in range(b):
            idx = greedy_nms_tiled(shifted[i], cand_sc[i], iou_thres, max_det)
            keep_idx[i, :len(idx)] = idx
            keep_valid[i, :len(idx)] = True
    else:
        nms = greedy_nms_matrix if method == "matrix" else greedy_nms_scan
        keep_idx, keep_valid = nms(shifted, cand_sc, iou_thres, max_det)
    det = torch.cat([_gather(cand_boxes, keep_idx),
                     (cand_sc.gather(1, keep_idx) * keep_valid)[..., None],
                     cls_ix.gather(1, keep_idx)[..., None]], dim=-1)
    det = torch.where(keep_valid[..., None], det, 0.0)
    n = keep_valid.sum(dim=1).to(torch.int32)
    if return_idx:
        return det, n, torch.where(keep_valid, anchor_ix.gather(1, keep_idx), 0).to(torch.int32)
    return det, n


def _class_filter(scores: torch.Tensor, classes: Sequence[int] | None) -> torch.Tensor:
    if classes is None:
        return scores
    keep = torch.zeros(scores.shape[-1], dtype=scores.dtype, device=scores.device)
    keep[list(classes)] = 1.0
    return scores * keep


def rotated_suppressed_dense(cand: torch.Tensor, cls_ix: torch.Tensor,
                             iou_thres: float) -> torch.Tensor:
    """(B, n) bool: candidates (B, n, 5) xywhr, score-sorted, that a
    higher-ranked candidate of the same class overlaps above iou_thres."""
    n = cand.shape[1]
    iou = probiou(cand[:, :, None], cand[:, None, :])[..., 0]
    same = cls_ix[:, :, None] == cls_ix[:, None, :]
    higher = torch.ones(n, n, dtype=torch.bool, device=cand.device).triu(1)
    return (higher & (iou > iou_thres) & same).any(dim=1)


def rotated_suppressed_blocked(cand: torch.Tensor, cls_ix: torch.Tensor, iou_thres: float,
                               n_live: int | None = None) -> torch.Tensor:
    """`rotated_suppressed_dense` of the first n_live candidates (the rest
    left False), computed in blocks of rows against the columns after each
    block, at most ROT_NMS_ELEMS triples at a time."""
    b, n = cand.shape[:2]
    n_live = n if n_live is None else n_live
    sup = torch.zeros(b, n, dtype=torch.bool, device=cand.device)
    rows = max(1, ROT_NMS_ELEMS // max(b * n_live, 1))
    for s in range(0, max(n_live - 1, 0), rows):
        e = min(s + rows, n_live - 1)
        iou = probiou(cand[:, s:e, None], cand[:, None, s + 1:n_live])[..., 0]  # (B, r, cols)
        same = cls_ix[:, s:e, None] == cls_ix[:, None, s + 1:n_live]
        higher = (torch.arange(s, e, device=cand.device)[:, None]
                  < torch.arange(s + 1, n_live, device=cand.device)[None])
        sup[:, s + 1:n_live] |= (higher & (iou > iou_thres) & same).any(dim=1)
    return sup


def nms_rotated(pred: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                max_det: int = 300, max_nms: int = 2048, classes: Sequence[int] | None = None,
                multi_label: bool = False):
    """pred (B, A, 4 + nc + 1): xywh of the rotated extents in pixels, class
    scores, angle (rad) -> (dets (B, max_det, 7) [cx, cy, w, h, angle, conf,
    cls], n_valid (B,) int32).

    `multi_label` ranks every (anchor, class) pair by its own score (the
    validator's candidates), else each anchor's best class (the
    predictor's). The suppression runs in blocks of rows
    (`rotated_suppressed_blocked`); `rotated_suppressed_dense` is its plain
    version."""
    b, a, no = pred.shape
    nc = no - 5
    scores = _class_filter(pred[..., 4:4 + nc], classes)
    if multi_label:
        top_sc, top_fi = _top_k(scores.reshape(b, -1), min(max_nms, a * nc))
        top_ix, cls_ix = top_fi // nc, (top_fi % nc).to(pred.dtype)
    else:
        best, cls_all = scores.max(dim=-1)
        top_sc, top_ix = _top_k(best, min(max_nms, a))
        cls_ix = cls_all.gather(1, top_ix).to(pred.dtype)
    cand = torch.cat([_gather(pred[..., :4], top_ix), _gather(pred[..., -1:], top_ix)], dim=-1)
    cand_sc = torch.where(top_sc > conf_thres, top_sc, 0.0)
    sup = rotated_suppressed_blocked(cand, cls_ix, iou_thres, int((cand_sc > 0).sum(dim=1).max()))
    kept = torch.where((cand_sc > 0.0) & ~sup, cand_sc, 0.0)
    ksc, kidx = _top_k(kept, min(max_det, cand.shape[1]))
    det = torch.cat([_gather(cand, kidx), ksc[..., None], cls_ix.gather(1, kidx)[..., None]],
                    dim=-1)
    det = torch.where((ksc > 0)[..., None], det, 0.0)
    return det, (ksc > 0).sum(dim=1).to(torch.int32)
