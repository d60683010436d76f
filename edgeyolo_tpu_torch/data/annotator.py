"""Auto-annotation (edgeyolo_tpu/data/annotator.py): a detector's boxes prompt
SAM, and each mask becomes a polygon label.

`auto_annotate(data, det_model, sam_model)` predicts every image under
`data`, prompts SAM with each kept box on that image, and writes one
`<image stem>.txt` per image with a detection: a line `cls x1 y1 x2 y2 ...`
of the mask's outline (ops/segments.py's `masks2segments`, at least three
points) normalised by the image's width and height, to
`<data>_auto_annotate_labels` beside `data` unless `output_dir` says where.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.utils import LOGGER


def auto_annotate(data, det_model="yolo11n.yaml", sam_model="vit_b", conf: float = 0.25,
                  iou: float = 0.45, imgsz: int = 640, max_det: int = 300,
                  classes: list[int] | None = None, output_dir: str | Path | None = None,
                  sam_img_size: int = 1024, device=None) -> Path:
    """Label every image under `data` with SAM masks seeded by the detector's
    boxes. `det_model` and `sam_model` are names (a YAML or checkpoint, a SAM
    variant) or built YOLO / SAM handles. Returns the label directory."""
    from edgeyolo_tpu_torch.engine.model import YOLO
    from edgeyolo_tpu_torch.engine.sam import SAM
    from edgeyolo_tpu_torch.ops.segments import masks2segments

    det = det_model if not isinstance(det_model, str) else YOLO(det_model, device=device)
    sam = (sam_model if not isinstance(sam_model, str)
           else SAM(sam_model, img_size=sam_img_size, device=device))
    data = Path(data)
    out = Path(output_dir) if output_dir else data.parent / f"{data.stem}_auto_annotate_labels"
    out.mkdir(parents=True, exist_ok=True)

    n_img = 0
    for r in det.predict(data, stream=True, conf=conf, iou=iou, imgsz=imgsz, max_det=max_det,
                         verbose=False, save=False):
        n_img += 1
        if r.boxes is None or len(r.boxes) == 0:
            continue
        cls_ids = r.boxes.cls.astype(int)
        keep = np.ones(len(cls_ids), bool) if classes is None else np.isin(cls_ids, classes)
        if not keep.any():
            continue
        h, w = r.orig_shape
        sam.set_image(r.orig_img)
        lines = []
        for c, box in zip(cls_ids[keep], r.boxes.xyxy[keep]):
            masks, _ = sam(bboxes=box)
            for seg in masks2segments(masks):
                if len(seg) < 3:
                    continue
                pts = (seg / np.asarray([w, h], np.float32)).reshape(-1)
                lines.append(f"{int(c)} " + " ".join(f"{v:.6g}" for v in pts))
        if lines:
            (out / (Path(r.path).stem + ".txt")).write_text("\n".join(lines) + "\n")
    LOGGER.info(f"auto_annotate: {n_img} images -> {out}")
    return out
