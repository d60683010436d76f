"""Prediction (edgeyolo_tpu/engine/predictor.py): the serving step, and
batched streaming over still-image sources into Results.

The serving step, `predictor(images)` on a uint8 (B, H, W, 3) batch, is the
device part of the JAX predictor's `_build_infer` after bench.py's
normalisation: uint8 NHWC -> model dtype / 255 -> NCHW forward -> f32 DFL
decode with the DGQP quality product -> class-aware matrix NMS, boxes
clipped to the image. An end-to-end model (`model.end2end`) needs no NMS:
its pred is already the score-sorted (B, max_det, 6) top-k, and
`e2e_detections` keeps the rows past `conf` (and of `classes`), valid rows
first, up to `max_det`. An RT-DETR model needs none either: `detr_detections`
takes its (B, 300, 4 + nc) queries (normalised cxcywh, sigmoid scores) to
pixel xyxy, each query's best class, the `max_det` best queries by that
score in jax.lax.top_k's order, then `e2e_detections`' keep. This is the
JAX validator's query path; JAX's own predictor has no RT-DETR branch and
puts the normalised pred through NMS, so its boxes come out in normalised
units (ROADMAP C.18).

`stream(source)` is JAX's `DetectionPredictor.stream`: each frame of a
source of data/loaders.py (images, directories, globs, arrays, video files,
MJPEG streams, frame iterables) is letterboxed (scaleup) to `imgsz`, `batch`
frames ride one serving step (a short last batch repeats its last frame,
whose outputs are not read), and each frame's boxes are taken back out of
the letterbox into a `Results` carrying the frame's path and the `speed`
dict. `predict(source)` is its list. Per frame, as JAX's predictor does:
- `augment`: test-time augmentation (JAX `_build_infer_tta`, reference
  `_predict_augment`): the batch at scales 1, 0.83 and 0.67, the second
  flipped left-right, each resized as `jax.image.resize` (bilinear, a
  triangle filter widened by the downscale, weights in the compute dtype)
  and padded to the stride with 0.447; the predictions de-scaled and
  de-flipped, the full scale's P5 and the smallest scale's P3 anchors
  dropped, then one NMS. An NMS-free head, and RT-DETR's query head, serve
  single-scale with a warning: their pred is already a selection (ROADMAP
  C.13, C.18).
- `visualize`: a second forward capturing every layer but the head, each
  4-D output saved as a feature-map grid (utils/plotting.py) under
  save_dir/<frame name>/.
- `save`: the annotated frame (`Results.plot`) as save_dir/<frame name>.jpg;
  `save_txt`: save_dir/labels/<frame name>.txt. A still image's name is its
  file's stem, as in JAX; a video or stream frame `path:i` is
  `<stem>_<i>`, one file per frame (JAX names every frame of a video
  `<stem>`, so each overwrites the last; ROADMAP C.13).
- `show`: `Results.show`, which displays nothing on the port (no viewer).

SegmentationPredictor (JAX's): the serving step adds the masks, (B,
max_det, h, w) at the prototype grid: the kept anchors' coefficients
against the prototypes, sigmoid, cropped to the boxes (ops/segments.py);
each frame's masks are taken out of the letterbox by the pad scaled to the
grid and resized bilinearly to the frame, then cut at 0.5, into
`Results.masks`.

PosePredictor (JAX's): the kept anchors' keypoints, gathered after the NMS,
(B, max_det, K * D) in input pixels; each frame's taken back out of the
letterbox into `Results.keypoints`. OBBPredictor (JAX's): the blocked
rotated NMS (ops/nms.py::nms_rotated) over the argmax class, (B, max_det,
7) [cx, cy, w, h, angle, conf, cls]; each frame's centres and sizes taken
back out of the letterbox (not clipped) into `Results.obb`.

Test-time augmentation is for a detect model only: the segment, pose and
obb predictors warn and serve single-scale, as JAX's do.

`int8=True` serves the int8 forward (nn/quant.py): the model is calibrated
on the first request's batch, in its dtype, unless it holds or has stashed a
calibration; `int8=False` stashes an active one, so the call runs full
precision (JAX's per-call semantics). A bf16 copy (`for_precision`) is
quantized from its f32 master's weights and keeps the state on the master.
"""

from __future__ import annotations

import math
import re
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from edgeyolo_tpu_torch.data.letterbox import letterbox
from edgeyolo_tpu_torch.data.loaders import load_inference_source
from edgeyolo_tpu_torch.engine.results import Keypoints, Masks, Results
from edgeyolo_tpu_torch.nn.modules.head import topk_stable
from edgeyolo_tpu_torch.nn.quant import set_int8
from edgeyolo_tpu_torch.nn.tasks import is_rtdetr
from edgeyolo_tpu_torch.ops.boxes import xywh2xyxy
from edgeyolo_tpu_torch.ops.nms import nms_rotated, non_max_suppression
from edgeyolo_tpu_torch.ops.resize import resize_bilinear, resize_weights  # noqa: F401
from edgeyolo_tpu_torch.ops.segments import proto_masks, unletterbox_masks
from edgeyolo_tpu_torch.utils import LOGGER, select_device
from edgeyolo_tpu_torch.utils.plotting import feature_visualization

TTA = ((1.0, False), (0.83, True), (0.67, False))  # (scale, flipped left-right)
TTA_PAD = 0.447  # the pad of a down-scaled canvas (ImageNet mean)


def frame_name(path: str) -> str:
    """The file name (no suffix) a frame's outputs are saved under: a still
    image's stem, or `<stem>_<i>` for frame i of a video or stream (`path:i`)."""
    m = re.fullmatch(r"(.*):(\d+)", str(path))
    if m:
        return f"{Path(m.group(1)).stem or 'stream'}_{m.group(2)}"
    return Path(str(path)).stem


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


def detr_detections(pred: torch.Tensor, size: tuple[int, int], conf: float, max_det: int,
                    classes=None):
    """RT-DETR's selection (the JAX validator's query path): pred (B, nq, 4 + nc)
    with normalised cxcywh boxes, an image of `size` (h, w) -> (det (B,
    min(max_det, nq), 6) [x1, y1, x2, y2, score, cls] by descending best-class
    score, n (B,)), as `e2e_detections` keeps rows."""
    h, w = size
    boxes = xywh2xyxy(pred[..., :4] * pred.new_tensor([w, h, w, h]))
    best, cls = pred[..., 4:].max(dim=-1)
    top, ix = topk_stable(best, min(int(max_det), pred.shape[1]))
    det = torch.cat([boxes.gather(1, ix[..., None].expand(-1, -1, 4)), top[..., None],
                     cls.gather(1, ix)[..., None].to(pred.dtype)], dim=-1)
    return e2e_detections(det, conf, max_det, classes)


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
                 verbose: bool = False, save: bool = False, augment: bool = False,
                 visualize: bool = False, vid_stride: int = 1, stream_buffer: bool = False,
                 line_width: int | None = None, show_labels: bool = True,
                 show_conf: bool = True, show: bool = False, int8: bool = False):
        self.device = select_device(device)
        self.model = model.to(self.device).eval()
        self.int8 = bool(int8)
        self.conf, self.iou, self.max_det, self.max_nms = conf, iou, max_det, max_nms
        self.imgsz, self.batch = int(imgsz), max(1, int(batch or 1))
        self.classes = None if classes is None else tuple(
            int(c) for c in (classes if isinstance(classes, (list, tuple)) else [classes]))
        self.agnostic = agnostic
        self.save_txt, self.save_conf, self.verbose = save_txt, save_conf, verbose
        self.save_dir = Path(save_dir)
        self.save, self.visualize, self.show = save, visualize, show
        self.vid_stride, self.stream_buffer = max(1, int(vid_stride or 1)), stream_buffer
        self.plot_args = {"line_width": line_width, "labels": show_labels, "conf": show_conf}
        self.augment = augment
        if augment and (getattr(self.model, "end2end", False) or is_rtdetr(self.model)):
            LOGGER.warning("augment=True needs a head with NMS; this NMS-free head's pred is "
                           "already a selection, so prediction stays single-scale")
            self.augment = False
        if augment and type(self) is not DetectionPredictor:
            LOGGER.warning(f"augment=True is available for a detect model only, not for a "
                           f"{getattr(self.model, 'task', 'detect')} one; predicting "
                           f"single-scale")
            self.augment = False

    def _nms(self, pred: torch.Tensor):
        return non_max_suppression(pred, conf_thres=self.conf, iou_thres=self.iou,
                                   max_det=self.max_det, max_nms=self.max_nms,
                                   agnostic=self.agnostic, classes=self.classes)

    def _tta_pred(self, x: torch.Tensor) -> torch.Tensor:
        """JAX `_build_infer_tta` before its NMS: the three scales' de-scaled,
        de-flipped predictions with the tails clipped, concatenated."""
        _, _, h, w = x.shape
        stride = self.model.model[-1].stride
        gs = int(max(stride))
        nl = len(stride)
        g = sum(4 ** i for i in range(nl))
        preds = []
        for si, flip in TTA:
            xi = x.flip(-1) if flip else x
            if si != 1.0:
                nh, nw = int(h * si), int(w * si)
                xi = resize_bilinear(xi, (nh, nw))
                ph, pw = math.ceil(h * si / gs) * gs, math.ceil(w * si / gs) * gs
                xi = F.pad(xi, (0, pw - nw, 0, ph - nh), value=TTA_PAD)
            p = self.model(xi)["pred"]
            box = p[..., :4] / si
            cx = (w - box[..., 0:1]) if flip else box[..., 0:1]
            preds.append(torch.cat([cx, box[..., 1:4], p[..., 4:]], dim=-1))
        preds[0] = preds[0][:, :-(preds[0].shape[1] // g)]
        preds[-1] = preds[-1][:, (preds[-1].shape[1] // g) * 4 ** (nl - 1):]
        return torch.cat(preds, dim=1)

    def _input(self, images_u8_nhwc) -> torch.Tensor:
        x = torch.as_tensor(images_u8_nhwc)
        if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected uint8 (B, H, W, 3) images, got {x.dtype} {tuple(x.shape)}")
        x = x.to(self.device).permute(0, 3, 1, 2).contiguous()
        x = x.to(self.model.dtype) / 255
        # the per-call int8 flag (JAX's predictor): calibrate on the first chunk,
        # in the request's dtype, or reuse a stashed calibration
        set_int8(self.model, self.int8, lambda: x)
        return x

    @torch.inference_mode()
    def __call__(self, images_u8_nhwc: np.ndarray | torch.Tensor):
        x = self._input(images_u8_nhwc)
        h, w = x.shape[2:]
        if self.augment:
            det, n = self._nms(self._tta_pred(x))
        else:
            pred = self.model(x)["pred"]
            if getattr(self.model, "end2end", False):
                det, n = e2e_detections(pred, self.conf, self.max_det, self.classes)
            elif is_rtdetr(self.model):
                det, n = detr_detections(pred, (h, w), self.conf, self.max_det, self.classes)
            else:
                det, n = self._nms(pred)
        det[..., 0:4:2] = det[..., 0:4:2].clamp(0, w)
        det[..., 1:4:2] = det[..., 1:4:2].clamp(0, h)
        return det, n

    @torch.inference_mode()
    def _visualize(self, img_u8: np.ndarray, name: str) -> None:
        """Feature maps of every layer but the head (JAX `_visualize`): list
        outputs are skipped."""
        layers = self.model.layers[:-1]
        _, feats = self.model(self._input(img_u8[None]), capture=[sp.i for sp in layers])
        out_dir = self.save_dir / name
        for sp in layers:
            f = feats.get(sp.i)
            if isinstance(f, torch.Tensor):
                feature_visualization(f, sp.name, sp.i, out_dir)
        LOGGER.info(f"saved feature maps to {out_dir}")

    def _run_batch(self, frames, names):
        n_real = len(frames)
        imgs = [f[2] for f in frames] + [frames[-1][2]] * (self.batch - n_real)
        t1 = time.perf_counter()
        outs = self(np.stack(imgs))
        dets, nvalid = outs[0].cpu().numpy(), outs[1].cpu().numpy()
        infer_ms = (time.perf_counter() - t1) * 1e3 / n_real
        for i, (path, img0, img, r, pads, pre_ms) in enumerate(frames):
            name = frame_name(path)
            if self.visualize:
                self._visualize(img, name)
            t2 = time.perf_counter()
            det = dets[i, :int(nvalid[i])].copy()
            res = self._to_results(outs, i, det, img0, path, names, r, pads)
            res.speed = {"preprocess": pre_ms, "inference": infer_ms,
                         "postprocess": (time.perf_counter() - t2) * 1e3}
            if self.save:
                self.save_dir.mkdir(parents=True, exist_ok=True)
                res.save(self.save_dir / f"{name}.jpg", **self.plot_args)
            if self.save_txt:
                res.save_txt(self.save_dir / "labels" / f"{name}.txt", save_conf=self.save_conf)
            if self.show:
                res.show(**self.plot_args)
            if self.verbose:
                LOGGER.info(f"{path}: {res.verbose_str} ({infer_ms:.1f}ms inference)")
            yield res

    def _to_results(self, outs, i: int, det: np.ndarray, img0: np.ndarray, path: str,
                    names: dict, r: float, pads) -> Results:
        """Frame i's Results from the batch's outputs and its kept rows det,
        taken back out of the letterbox."""
        if len(det):
            det = unletterbox_boxes(det, r, *pads, img0.shape[:2])
        return Results(img0, path, names, boxes=det)

    def stream(self, source):
        """Results, one per frame of `source`."""
        names = getattr(self.model, "names", None) or {i: str(i) for i in range(self.model.nc)}
        loader, _ = load_inference_source(source, vid_stride=self.vid_stride,
                                          stream_buffer=self.stream_buffer)
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


class SegmentationPredictor(DetectionPredictor):
    """`predictor(images)` -> (det, n, masks (B, max_det, h, w) in [0, 1] at
    the prototype grid); `predict(source)` -> [Results] with `masks`."""

    @torch.inference_mode()
    def __call__(self, images_u8_nhwc: np.ndarray | torch.Tensor):
        x = self._input(images_u8_nhwc)
        h, w = x.shape[2:]
        out = self.model(x)
        pred, nc = out["pred"], self.model.nc
        det, n, aidx = non_max_suppression(
            pred[..., :4 + nc], conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
            max_nms=self.max_nms, agnostic=self.agnostic, classes=self.classes, nc=nc,
            return_idx=True)
        nm = pred.shape[-1] - 4 - nc
        coefs = pred[..., 4 + nc:].gather(1, aidx.long()[..., None].expand(-1, -1, nm))
        masks = proto_masks(out["proto"], coefs, det[..., :4], h)
        det[..., 0:4:2] = det[..., 0:4:2].clamp(0, w)
        det[..., 1:4:2] = det[..., 1:4:2].clamp(0, h)
        return det, n, masks

    def _to_results(self, outs, i: int, det: np.ndarray, img0: np.ndarray, path: str,
                    names: dict, r: float, pads) -> Results:
        res = super()._to_results(outs, i, det, img0, path, names, r, pads)
        n = len(det)
        if n:
            pw, ph = pads
            pm = outs[2][i, :n]
            s = pm.shape[1] / (img0.shape[0] * r + 2 * ph)  # the grid's share of the canvas
            res.masks = Masks((unletterbox_masks(pm, (pw * s, ph * s), img0.shape[:2]) > 0.5)
                              .cpu().numpy(), res.orig_shape)
        return res


class PosePredictor(DetectionPredictor):
    """`predictor(images)` -> (det, n, keypoints (B, max_det, K * D) in input
    pixels); `predict(source)` -> [Results] with `keypoints`."""

    @torch.inference_mode()
    def __call__(self, images_u8_nhwc: np.ndarray | torch.Tensor):
        x = self._input(images_u8_nhwc)
        h, w = x.shape[2:]
        pred, nc = self.model(x)["pred"], self.model.nc
        det, n, aidx = non_max_suppression(
            pred[..., :4 + nc], conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
            max_nms=self.max_nms, agnostic=self.agnostic, classes=self.classes, nc=nc,
            return_idx=True)
        nk = pred.shape[-1] - 4 - nc
        kpts = pred[..., 4 + nc:].gather(1, aidx.long()[..., None].expand(-1, -1, nk))
        det[..., 0:4:2] = det[..., 0:4:2].clamp(0, w)
        det[..., 1:4:2] = det[..., 1:4:2].clamp(0, h)
        return det, n, kpts

    def _to_results(self, outs, i: int, det: np.ndarray, img0: np.ndarray, path: str,
                    names: dict, r: float, pads) -> Results:
        res = super()._to_results(outs, i, det, img0, path, names, r, pads)
        n = len(det)
        if n:
            pw, ph = pads
            pk = outs[2][i, :n].cpu().numpy().reshape(n, *self.model.kpt_shape).copy()
            pk[..., 0] = (pk[..., 0] - pw) / r
            pk[..., 1] = (pk[..., 1] - ph) / r
            res.keypoints = Keypoints(pk, res.orig_shape)
        return res


class OBBPredictor(DetectionPredictor):
    """`predictor(images)` -> (det (B, max_det, 7) [cx, cy, w, h, angle, conf,
    cls], n (B,)); `predict(source)` -> [Results] with `obb`."""

    @torch.inference_mode()
    def __call__(self, images_u8_nhwc: np.ndarray | torch.Tensor):
        return nms_rotated(self.model(self._input(images_u8_nhwc))["pred"], conf_thres=self.conf,
                           iou_thres=self.iou, max_det=self.max_det, max_nms=self.max_nms,
                           classes=self.classes)

    def _to_results(self, outs, i: int, det: np.ndarray, img0: np.ndarray, path: str,
                    names: dict, r: float, pads) -> Results:
        if len(det):
            pw, ph = pads
            det[:, 0] = (det[:, 0] - pw) / r
            det[:, 1] = (det[:, 1] - ph) / r
            det[:, 2:4] = det[:, 2:4] / r
        return Results(img0, path, names, obb=det)
