"""COCO-protocol bbox evaluation without pycocotools (edgeyolo_tpu/metrics/coco_eval.py).

`evaluate_coco(gt_json, pred_json)`: per-class greedy matching honouring
crowd and ignore, 101-point precision interpolation, the area ranges
all/small/medium/large and maxDets 100, reported as the standard
AP/AP50/AP75/APs/APm/APl line. Host numpy; the validator calls it on its
predictions.json when the data YAML names a GT json.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.utils import LOGGER

AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU between ltwh boxes; crowd GTs use intersection-over-det area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.clip(np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None)
    iy = np.clip(np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = ix * iy
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-9)


def evaluate_coco(gt_json: str | Path, pred_json: str | Path, max_dets: int = 100,
                  verbose: bool = True) -> dict:
    """Run the COCO bbox protocol. Returns the standard metric dict."""
    gt = json.loads(Path(gt_json).read_text())
    preds = json.loads(Path(pred_json).read_text())

    gts_by_img_cat = defaultdict(list)
    for ann in gt["annotations"]:
        gts_by_img_cat[(ann["image_id"], ann["category_id"])].append(ann)
    preds_by_img_cat = defaultdict(list)
    for p in preds:
        preds_by_img_cat[(p["image_id"], p["category_id"])].append(p)
    cat_ids = sorted({ann["category_id"] for ann in gt["annotations"]})
    img_ids = sorted({im["id"] for im in gt["images"]})

    # eval per (image, category): matches over IoU thresholds
    results = {}
    for (area_name, (a_lo, a_hi)) in AREA_RNG.items():
        tps, scores_all, n_gt_total = [], [], defaultdict(int)
        per_cat_records = defaultdict(lambda: ([], []))  # cat -> (tp rows, scores)
        for img_id in img_ids:
            for cat in cat_ids:
                g = gts_by_img_cat.get((img_id, cat), [])
                d = sorted(preds_by_img_cat.get((img_id, cat), []),
                           key=lambda p: -p["score"])[:max_dets]
                if not g and not d:
                    continue
                g_boxes = np.asarray([x["bbox"] for x in g], np.float64).reshape(-1, 4)
                g_area = np.asarray([x.get("area", x["bbox"][2] * x["bbox"][3]) for x in g])
                g_crowd = np.asarray([x.get("iscrowd", 0) for x in g])
                g_ignore = g_crowd.astype(bool) | (g_area < a_lo) | (g_area >= a_hi)
                order = np.argsort(g_ignore, kind="stable")  # real gts first
                g_boxes, g_ignore, g_crowd = g_boxes[order], g_ignore[order], g_crowd[order]
                d_boxes = np.asarray([x["bbox"] for x in d], np.float64).reshape(-1, 4)
                d_scores = np.asarray([x["score"] for x in d])
                ious = _iou_xywh(d_boxes, g_boxes, g_crowd)

                T = len(IOU_THRS)
                tp = np.zeros((len(d), T), bool)
                d_ign = np.zeros((len(d), T), bool)
                for ti, thr in enumerate(IOU_THRS):
                    taken = np.zeros(len(g), bool)
                    for di in range(len(d)):
                        best, bi = thr, -1
                        for gi in range(len(g)):
                            if taken[gi] and not g_crowd[gi]:
                                continue
                            if bi > -1 and not g_ignore[bi] and g_ignore[gi]:
                                break  # can't improve: remaining are ignores
                            if ious[di, gi] >= best:
                                best = ious[di, gi]
                                bi = gi
                        if bi > -1:
                            taken[bi] = True
                            if g_ignore[bi]:
                                d_ign[di, ti] = True
                            else:
                                tp[di, ti] = True
                    # unmatched dets outside the area range are ignored
                    d_area = d_boxes[:, 2] * d_boxes[:, 3]
                    out_rng = (d_area < a_lo) | (d_area >= a_hi)
                    d_ign[:, ti] |= (~tp[:, ti]) & out_rng
                keep = ~d_ign.all(axis=1)
                rec_tp, rec_sc = per_cat_records[cat]
                for di in range(len(d)):
                    rec_tp.append(tp[di])
                    rec_sc.append((d_scores[di], d_ign[di]))
                n_gt_total[cat] += int((~g_ignore).sum())

        # precision-recall per category
        ap_per_cat = np.full((len(cat_ids), len(IOU_THRS)), np.nan)
        for ci, cat in enumerate(cat_ids):
            rec_tp, rec_sc = per_cat_records[cat]
            n_gt = n_gt_total[cat]
            if n_gt == 0 or not rec_tp:
                continue
            scores = np.asarray([s for s, _ in rec_sc])
            order = np.argsort(-scores, kind="mergesort")
            tp_m = np.asarray(rec_tp)[order]  # (N, T)
            ig_m = np.asarray([ig for _, ig in rec_sc])[order]
            for ti in range(len(IOU_THRS)):
                t = tp_m[:, ti] & ~ig_m[:, ti]
                f = ~tp_m[:, ti] & ~ig_m[:, ti]
                tp_c = np.cumsum(t)
                fp_c = np.cumsum(f)
                rc = tp_c / n_gt
                pr = tp_c / np.maximum(tp_c + fp_c, 1e-9)
                # precision envelope + 101-pt interpolation
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                idx = np.searchsorted(rc, RECALL_THRS, side="left")
                q = np.where(idx < len(pr), pr[np.minimum(idx, max(len(pr) - 1, 0))], 0.0)
                ap_per_cat[ci, ti] = q.mean() if len(pr) else 0.0
        results[area_name] = ap_per_cat

    def mean_ap(area, thr_idx=None):
        a = results[area]
        a = a if thr_idx is None else a[:, thr_idx : thr_idx + 1]
        valid = ~np.isnan(a)
        return float(a[valid].mean()) if valid.any() else 0.0

    out = {
        "AP": mean_ap("all"),
        "AP50": mean_ap("all", 0),
        "AP75": mean_ap("all", 5),
        "APs": mean_ap("small"),
        "APm": mean_ap("medium"),
        "APl": mean_ap("large"),
    }
    if verbose:
        LOGGER.info(
            "COCO eval: AP {AP:.4f}  AP50 {AP50:.4f}  AP75 {AP75:.4f}  "
            "APs {APs:.4f}  APm {APm:.4f}  APl {APl:.4f}".format(**out)
        )
    return out
