"""Detection metrics (edgeyolo_tpu/metrics/metrics.py): 101-point AP, per-class
PR, TP matching, confusion matrix, in numpy.

Behavioral spec: ultralytics/utils/metrics.py (compute_ap:505, ap_per_class:537,
Metric/DetMetrics:640/808, ConfusionMatrix:294) and
ultralytics/engine/validator.py:222-262 (greedy unique matching over 10 IoU
thresholds). Fork deltas preserved: fitness = pure mAP50-95
(metrics.py:758-761) and the extra mAP75 column (detect/val.py:90).

Host-side numpy (detections are <=300/image); `match_predictions_device`
is the torch twin that matches a whole batch where the detections are.
"""

from __future__ import annotations

import numpy as np
import torch

IOUV = np.linspace(0.5, 0.95, 10)

# numpy < 2.0 has no np.trapezoid (the reference's np.trapz is deprecated in 2.x)
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing with edge padding (fraction f of curve length)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate([p * y[0], y, p * y[-1]])
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall, precision):
    """COCO 101-point interpolated AP from one PR curve."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def match_predictions(pred_classes: np.ndarray, true_classes: np.ndarray, iou: np.ndarray) -> np.ndarray:
    """Greedy unique TP matching for 10 IoU thresholds.

    pred_classes (N,), true_classes (M,), iou (M, N) -> correct (N, 10) bool.
    """
    correct = np.zeros((pred_classes.shape[0], IOUV.shape[0]), dtype=bool)
    if pred_classes.shape[0] == 0 or true_classes.shape[0] == 0:
        return correct
    correct_class = true_classes[:, None] == pred_classes[None, :]
    iou = iou * correct_class
    for i, threshold in enumerate(IOUV):
        matches = np.nonzero(iou >= threshold)
        matches = np.array(matches).T  # (K, 2) [label, detection]
        if matches.shape[0]:
            if matches.shape[0] > 1:
                matches = matches[iou[matches[:, 0], matches[:, 1]].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


def match_predictions_device(pred_classes: torch.Tensor, true_classes: torch.Tensor,
                             gt_valid: torch.Tensor, det_valid: torch.Tensor,
                             iou: torch.Tensor) -> torch.Tensor:
    """Torch twin of `match_predictions` for batched matching on the device
    (edgeyolo_tpu/metrics/metrics.py::match_predictions_device).

    The host heuristic (sort candidate pairs by IoU descending, np.unique by
    detection, np.unique by label) vectorises, absent exact IoU ties, into
    two chained selections:
      s1: each detection keeps its best-IoU gt among the >= thr class-matched
          pairs (the first np.unique keeps the highest-IoU pair per detection);
      s2: each gt keeps the SMALLEST-DETECTION-INDEX pair among the s1
          survivors: after the first np.unique the pairs are sorted by
          detection, so the second np.unique's first-occurrence rule picks by
          detection index, not IoU. The reference's re-sort line is commented
          out; the quirk is kept on purpose, for parity.
    pred_classes (..., D), true_classes (..., M), gt_valid (..., M),
    det_valid (..., D), iou (..., M, D) -> (..., D, 10) bool.
    """
    ioum = torch.where((true_classes[..., :, None] == pred_classes[..., None, :])
                       & gt_valid[..., :, None] & det_valid[..., None, :], iou, 0.0)
    m, d = ioum.shape[-2:]
    thr = torch.as_tensor(IOUV, dtype=ioum.dtype, device=ioum.device)
    hit = ioum[..., None] >= thr  # (..., M, D, 10)
    g_best = ioum.argmax(dim=-2)  # (..., D): the first of equal maxima, as jnp.argmax
    s1 = hit & (torch.arange(m, device=ioum.device)[:, None] == g_best[..., None, :])[..., None]
    d_first = s1.to(torch.uint8).argmax(dim=-2)  # (..., M, 10): the first True
    s2 = s1 & (torch.arange(d, device=ioum.device)[:, None] == d_first[..., :, None, :])
    return s2.any(dim=-3)


def ap_per_class(tp, conf, pred_cls, target_cls, eps: float = 1e-16):
    """Per-class P/R/F1/AP from pooled detections.

    tp (N, 10) bool, conf (N,), pred_cls (N,), target_cls (L,).
    Returns dict with p, r, f1 (at max-F1 threshold), ap (nc, 10),
    unique_classes, and nt (labels per class).
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    x = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l, n_p = nt[ci], sel.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-x, -conf[sel], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-x, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax() if nc else 0
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    return {
        "p": p, "r": r, "f1": f1, "ap": ap,
        "unique_classes": unique_classes.astype(int), "nt": nt,
    }


class Metric:
    """Per-task metric bundle (box or mask): wraps ap_per_class results."""

    def __init__(self):
        self.p = np.asarray([])
        self.r = np.asarray([])
        self.f1 = np.asarray([])
        self.all_ap = np.zeros((0, 10))
        self.ap_class_index = np.asarray([], dtype=int)
        self.nt_per_class = np.asarray([], dtype=int)
        self.nc = 0

    def update(self, res: dict):
        self.p, self.r, self.f1 = res["p"], res["r"], res["f1"]
        self.all_ap = res["ap"]
        self.ap_class_index = res["unique_classes"]
        self.nt_per_class = res["nt"]

    @property
    def ap50(self):
        return self.all_ap[:, 0] if len(self.all_ap) else []

    @property
    def ap75(self):
        return self.all_ap[:, 5] if len(self.all_ap) else []

    @property
    def ap(self):
        return self.all_ap.mean(1) if len(self.all_ap) else []

    @property
    def mp(self):
        return float(self.p.mean()) if len(self.p) else 0.0

    @property
    def mr(self):
        return float(self.r.mean()) if len(self.r) else 0.0

    @property
    def map50(self):
        return float(self.all_ap[:, 0].mean()) if len(self.all_ap) else 0.0

    @property
    def map75(self):
        return float(self.all_ap[:, 5].mean()) if len(self.all_ap) else 0.0

    @property
    def map(self):
        return float(self.all_ap.mean()) if len(self.all_ap) else 0.0

    def mean_results(self):
        return [self.mp, self.mr, self.map50, self.map]

    def class_result(self, i: int):
        return self.p[i], self.r[i], self.all_ap[i, 0], self.all_ap[i].mean()

    @property
    def fitness(self) -> float:
        """Fork behavior: fitness is pure mAP50-95 (metrics.py:758-761)."""
        return self.map


class DetMetrics:
    """Accumulates (tp, conf, pred_cls, target_cls) across batches, then
    computes the detection metric table."""

    def __init__(self, names: dict | None = None):
        self.names = names or {}
        self.box = Metric()
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0, "postprocess": 0.0}
        self._tp, self._conf, self._pcls, self._tcls = [], [], [], []

    def update_batch(self, tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: np.ndarray):
        self._tp.append(tp)
        self._conf.append(conf)
        self._pcls.append(pred_cls)
        self._tcls.append(target_cls)

    def process(self):
        if not self._tp:
            return self
        tp = np.concatenate(self._tp, 0)
        conf = np.concatenate(self._conf, 0)
        pcls = np.concatenate(self._pcls, 0)
        tcls = np.concatenate(self._tcls, 0)
        if len(tcls):
            self.box.update(ap_per_class(tp, conf, pcls, tcls))
        return self

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)"]

    def mean_results(self):
        return self.box.mean_results()

    @property
    def fitness(self):
        return self.box.fitness

    @property
    def results_dict(self):
        d = dict(zip(self.keys, self.mean_results()))
        d["fitness"] = self.fitness
        d["metrics/mAP75(B)"] = self.box.map75  # fork extra column
        return d


class ConfusionMatrix:
    """Confusion matrix over nc classes + background row/col."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), dtype=np.int64)

    def process_batch(self, detections: np.ndarray | None, gt_boxes: np.ndarray, gt_cls: np.ndarray):
        """detections (N,6) xyxy/conf/cls; gt_boxes (M,4) xyxy; gt_cls (M,)."""
        if gt_cls.size == 0:
            if detections is not None:
                for dc in detections[detections[:, 4] > self.conf][:, 5].astype(int):
                    self.matrix[dc, self.nc] += 1  # false positive
            return
        if detections is None or len(detections) == 0:
            for gc in gt_cls.astype(int):
                self.matrix[self.nc, gc] += 1  # false negative
            return
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = gt_cls.astype(int)
        det_classes = detections[:, 5].astype(int)
        iou = _box_iou_np(gt_boxes, detections[:, :4])
        matches = np.nonzero(iou > self.iou_thres)
        matches = np.array(matches).T
        if matches.shape[0]:
            if matches.shape[0] > 1:
                matches = matches[iou[matches[:, 0], matches[:, 1]].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        m0, m1 = matches.transpose().astype(int) if matches.shape[0] else (np.empty(0, int), np.empty(0, int))
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if matches.shape[0] and j.sum() == 1:
                self.matrix[det_classes[m1[j]][0], gc] += 1  # correct or class-confused
            else:
                self.matrix[self.nc, gc] += 1  # missed
        for i, dc in enumerate(det_classes):
            if not (matches.shape[0] and (m1 == i).any()):
                self.matrix[dc, self.nc] += 1  # false positive


def _box_iou_np(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy IoU on host."""
    a1, a2 = np.split(box1[:, None], 2, axis=2)
    b1, b2 = np.split(box2[None], 2, axis=2)
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(2)
    area1 = np.prod(box1[:, 2:] - box1[:, :2], 1)
    area2 = np.prod(box2[:, 2:] - box2[:, :2], 1)
    return inter / (area1[:, None] + area2[None] - inter + 1e-7)


def fitness(results_dict: dict) -> float:
    """Fork behavior: pure mAP50-95."""
    return float(results_dict.get("metrics/mAP50-95(B)", 0.0))
