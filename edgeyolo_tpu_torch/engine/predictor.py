"""Prediction (edgeyolo_tpu/engine/predictor.py): the serving step, and
batched streaming over still-image sources into Results.

The serving step, `predictor(images)` on a uint8 (B, H, W, 3) batch, is the
device part of the JAX predictor's `_build_infer` after bench.py's
normalisation: uint8 NHWC -> model dtype / 255 -> NCHW forward -> f32 DFL
decode with the DGQP quality product -> class-aware matrix NMS, boxes
clipped to the image. An end-to-end model (`model.end2end`) needs no NMS:
its pred is already the score-sorted (B, max_det, 6) top-k, and
`e2e_detections` keeps the rows past `conf` (and of `classes`), valid rows
first, up to `max_det`.

`stream(source)` is JAX's `DetectionPredictor.stream`: each frame of a file,
directory, glob, list or array source is letterboxed (scaleup) to `imgsz`,
`batch` frames ride one serving step (a short last batch repeats its last
frame, whose outputs are not read), and each frame's boxes are taken back
out of the letterbox into a `Results`, with the `speed` dict and, with
`save_txt`, a label file per frame. `predict(source)` is its list.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from edgeyolo_tpu_torch.data.letterbox import letterbox
from edgeyolo_tpu_torch.data.loaders import load_inference_source
from edgeyolo_tpu_torch.engine.results import Results
from edgeyolo_tpu_torch.ops.nms import non_max_suppression
from edgeyolo_tpu_torch.utils import LOGGER, select_device


def e2e_detections(pred: torch.Tensor, conf: float, max_det: int, classes=None):
    """The NMS-free passthrough (JAX predictor's infer_e2e): pred (B, K, 6)
    score-sorted -> (det (B, min(max_det, K), 6), n (B,)). Rows at or under
    `conf`, or of a class not in `classes`, are zeroed; a class filter can
    punch holes in the sorted prefix, so a stable sort moves the kept rows to
    the front in their order."""
    keep = pred[..., 4] > conf
    if classes is not None:
        keep &= torch.isin(pred[..., 5], torch.tensor(classes, dtype=pred.dtype,
                                                      device=pred.device))
    k = min(int(max_det), pred.shape[1])
    keep = keep[:, :k]
    det = torch.where(keep[..., None], pred[:, :k], 0.0)
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    det = det.gather(1, order[..., None].expand(-1, -1, det.shape[-1]))
    return det, keep.sum(dim=1, dtype=torch.int32)


def unletterbox_boxes(det: np.ndarray, r: float, pw: float, ph: float,
                      orig_shape: tuple[int, int]) -> np.ndarray:
    """Letterbox-space detection rows, in place, into the original image's
    pixels, clipped to it."""
    h0, w0 = orig_shape
    det[:, [0, 2]] = ((det[:, [0, 2]] - pw) / r).clip(0, w0)
    det[:, [1, 3]] = ((det[:, [1, 3]] - ph) / r).clip(0, h0)
    return det


class DetectionPredictor:
    """`predictor(images)` -> (det (B, max_det, 6) [x1, y1, x2, y2, conf, cls], n (B,));
    `predictor.predict(source)` -> [Results]."""

    def __init__(self, model, conf: float = 0.25, iou: float = 0.7, max_det: int = 300,
                 max_nms: int = 8192, device=None, imgsz: int = 640, batch: int = 1,
                 classes=None, agnostic: bool = False, save_txt: bool = False,
                 save_conf: bool = False, save_dir: str | Path = "runs/predict",
                 verbose: bool = False):
        self.device = select_device(device)
        self.model = model.to(self.device).eval()
        self.conf, self.iou, self.max_det, self.max_nms = conf, iou, max_det, max_nms
        self.imgsz, self.batch = int(imgsz), max(1, int(batch or 1))
        self.classes = None if classes is None else tuple(
            int(c) for c in (classes if isinstance(classes, (list, tuple)) else [classes]))
        self.agnostic = agnostic
        self.save_txt, self.save_conf, self.verbose = save_txt, save_conf, verbose
        self.save_dir = Path(save_dir)

    @torch.inference_mode()
    def __call__(self, images_u8_nhwc: np.ndarray | torch.Tensor):
        x = torch.as_tensor(images_u8_nhwc)
        if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected uint8 (B, H, W, 3) images, got {x.dtype} {tuple(x.shape)}")
        h, w = x.shape[1:3]
        x = x.to(self.device).permute(0, 3, 1, 2).contiguous()
        x = x.to(self.model.dtype) / 255
        pred = self.model(x)["pred"]
        if getattr(self.model, "end2end", False):
            det, n = e2e_detections(pred, self.conf, self.max_det, self.classes)
        else:
            det, n = non_max_suppression(pred, conf_thres=self.conf, iou_thres=self.iou,
                                         max_det=self.max_det, max_nms=self.max_nms,
                                         agnostic=self.agnostic, classes=self.classes)
        det[..., 0:4:2] = det[..., 0:4:2].clamp(0, w)
        det[..., 1:4:2] = det[..., 1:4:2].clamp(0, h)
        return det, n

    def _run_batch(self, frames, names):
        n_real = len(frames)
        imgs = [f[2] for f in frames] + [frames[-1][2]] * (self.batch - n_real)
        t1 = time.perf_counter()
        dets, nvalid = self(np.stack(imgs))
        dets, nvalid = dets.cpu().numpy(), nvalid.cpu().numpy()
        infer_ms = (time.perf_counter() - t1) * 1e3 / n_real
        for i, (path, img0, _img, r, pads, pre_ms) in enumerate(frames):
            t2 = time.perf_counter()
            det = dets[i, :int(nvalid[i])].copy()
            if len(det):
                det = unletterbox_boxes(det, r, *pads, img0.shape[:2])
            res = Results(img0, path, names, boxes=det,
                          speed={"preprocess": pre_ms, "inference": infer_ms, "postprocess": 0.0})
            if self.save_txt:
                res.save_txt(self.save_dir / "labels" / (Path(path).stem + ".txt"),
                             save_conf=self.save_conf)
            res.speed["postprocess"] = (time.perf_counter() - t2) * 1e3
            if self.verbose:
                LOGGER.info(f"{path}: {res.verbose_str} ({infer_ms:.1f}ms inference)")
            yield res

    def stream(self, source):
        """Results, one per frame of `source`."""
        names = getattr(self.model, "names", None) or {i: str(i) for i in range(self.model.nc)}
        loader = load_inference_source(source)
        buf = []
        for path, img0 in loader:
            t0 = time.perf_counter()
            img, r, pads = letterbox(img0, self.imgsz, scaleup=True)
            buf.append((path, img0, img, r, pads, (time.perf_counter() - t0) * 1e3))
            if len(buf) == self.batch:
                yield from self._run_batch(buf, names)
                buf = []
        if buf:
            yield from self._run_batch(buf, names)

    def predict(self, source) -> list[Results]:
        return list(self.stream(source))
