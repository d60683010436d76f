"""FastSAM (edgeyolo_tpu/engine/fastsam.py): segment everything with a
YOLOv8-seg model (fastsam.yaml), then keep the proposals a prompt selects.

- `bbox_prompt`: for each prompt box, the proposal of highest box IoU with
  it, if that IoU passes `iou_thres`; the selected indices, unique and sorted.
- `point_prompt`: for each point, the smallest proposal box that contains
  it; a positive point adds it, a negative one removes it.
- `text_prompt` raises, as JAX's does: text prompts need CLIP's image and
  text towers with their weights, which do not ship with the package.

`FastSAM(model)(source, bboxes=..., points=..., labels=...)` predicts with
imgsz 640 and conf 0.25 unless told otherwise and returns each image's
Results, or with a prompt each image's selected Results. Runs on CUDA
unless `device` names another device.
"""

from __future__ import annotations

import numpy as np


def bbox_prompt(results, bboxes: np.ndarray, iou_thres: float = 0.0) -> list[np.ndarray]:
    """Per result, the indices of the proposals that best overlap the prompt boxes."""
    out = []
    for res in results:
        if res.boxes is None or len(res.boxes) == 0:
            out.append(np.zeros((0,), int))
            continue
        det = res.boxes.xyxy
        keep = []
        for pb in np.asarray(bboxes, np.float32).reshape(-1, 4):
            x1 = np.maximum(det[:, 0], pb[0])
            y1 = np.maximum(det[:, 1], pb[1])
            x2 = np.minimum(det[:, 2], pb[2])
            y2 = np.minimum(det[:, 3], pb[3])
            inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
            a_det = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
            a_pb = (pb[2] - pb[0]) * (pb[3] - pb[1])
            iou = inter / (a_det + a_pb - inter + 1e-7)
            if iou.max() > iou_thres:
                keep.append(int(iou.argmax()))
        out.append(np.unique(np.asarray(keep, int)))
    return out


def point_prompt(results, points: np.ndarray, labels: np.ndarray | None = None
                 ) -> list[np.ndarray]:
    """Per result, the smallest proposals containing the positive points."""
    points = np.asarray(points, np.float32).reshape(-1, 2)
    labels = np.ones(len(points)) if labels is None else np.asarray(labels)
    out = []
    for res in results:
        if res.boxes is None or len(res.boxes) == 0:
            out.append(np.zeros((0,), int))
            continue
        det = res.boxes.xyxy
        keep: set[int] = set()
        for (px, py), lab in zip(points, labels):
            inside = (det[:, 0] <= px) & (px <= det[:, 2]) & (det[:, 1] <= py) & (py <= det[:, 3])
            idxs = np.where(inside)[0]
            if len(idxs) == 0:
                continue
            areas = (det[idxs, 2] - det[idxs, 0]) * (det[idxs, 3] - det[idxs, 1])
            chosen = int(idxs[areas.argmin()])
            if lab > 0:
                keep.add(chosen)
            else:
                keep.discard(chosen)
        out.append(np.asarray(sorted(keep), int))
    return out


def text_prompt(results, text: str):
    """Raises: CLIP's towers and weights do not ship with the package."""
    raise NotImplementedError(
        "text prompts need CLIP embeddings; no pretrained weights ship with the package "
        "(bbox/point prompts are supported)")


class FastSAM:
    """Everything-mode proposals of a segment model, and prompt filtering."""

    def __init__(self, model: str = "fastsam.yaml", device=None):
        from edgeyolo_tpu_torch.engine.model import YOLO

        self.yolo = YOLO(model, task="segment", device=device)

    def __call__(self, source, bboxes=None, points=None, labels=None, texts=None, **kw):
        kw.setdefault("imgsz", 640)
        kw.setdefault("conf", 0.25)
        results = self.yolo.predict(source, **kw)
        if texts is not None:
            text_prompt(results, texts)
        if bboxes is not None:
            sel = bbox_prompt(results, bboxes)
        elif points is not None:
            sel = point_prompt(results, points, labels)
        else:
            return results  # everything mode
        return [r[idx] for r, idx in zip(results, sel)]
