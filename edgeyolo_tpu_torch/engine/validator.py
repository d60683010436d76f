"""Detection validator (edgeyolo_tpu/engine/validator.py, the plain-detection branch).

Per batch of the val loader: upload the uint8 images, /255 in f32 (or bf16
with `half`), forward, multi-label NMS at conf 0.001, iou 0.7, max_det 300
(the per-image tiled path, whose memory does not grow with max_nms = 30000),
or for an end-to-end model the passthrough of its score-sorted top-k (rows
past conf, up to max_det), or for an RT-DETR model its query selection (no
NMS: `detr_detections`, pixels from normalised cxcywh, each query's best
class, the max_det best, rows under conf zeroed); then, still on the
device, undo the letterbox and clip to the original image, pad the ground
truth (`_gt_arrays`) and match detections to it over the ten IoU
thresholds. Only (det, n, tp) come back to the host, into
`DetMetrics` (101-point AP, the fork's mAP75 column). With `half` a model
whose convolutions are f32 is validated through a bf16 copy (convolutions
bf16, BatchNorm, quality head and decode f32, as in serving).
With `save_json` each image's detections, in native pixels as COCO's
top-left xywh, go to `save_dir/predictions.json` (category ids through the
COCO 80 -> 91 map when the split is COCO's 80 classes), and when the data
YAML names `annotations` or `gt_json` the COCO protocol scores them
(metrics/coco_eval.py) into `metrics.speed["coco/AP"]` and the rest.
Plots, int8 and multi-device validation are not ported yet. The model may
also be a backend adapter that gives only `pred` (`adapter(x)["pred"]`, its
`nc`, `names` and `end2end`; utils/benchmarks.py wraps an exported artifact
so, as JAX's `eager_only` adapters): the network runs through it and the NMS,
scaling and matching are the validator's own.

SegmentationValidator (JAX's): box metrics on the shared matching, plus the
mask table `metrics/mAP50(M)` and `metrics/mAP50-95(M)`. On the device, per
batch: multi-label NMS with the kept anchors' indices, their mask
coefficients against the prototypes, sigmoid, cropped to the boxes on the
prototype grid; per image the gt masks made exclusive (a pixel shared by
instances stays with the smallest, as the dataset's overlap merge draws
them) when `overlap_mask`, then with `mask_iou_res="native"` (the default)
both sides resized bilinearly to the input size (the predictions 64 slots
at a time, so the (D, S, S) temporary stays bounded) before the 0.5
threshold, or compared at the prototype grid with "proto"; only the (gt,
det) mask IoU matrix comes back, and the host's `match_predictions` turns
it and the box IoUs (boxes back in native pixels, unclipped, as JAX's
segment path leaves them) into TP rows.

PoseValidator (JAX's): box metrics as the segment validator's, plus the
pose table `metrics/mAP50(P)` and `metrics/mAP50-95(P)` matched by OKS: the
kept anchors' keypoints (gathered on the device after the multi-label NMS)
and the gt's taken back out of the letterbox, the area 0.53 x the gt box's
in original pixels, COCO's sigmas for 17 keypoints, else 1/K.

OBBValidator (JAX's): the multi-label blocked rotated NMS
(ops/nms.py::nms_rotated), each kept box's centre and size taken back out
of the letterbox, matched to `rboxes_ori` (the dataset's rectangles in
original pixels) by probiou. With `save_json` it writes predictions.json
(rbox and 8-value polygon per detection, 1-based category ids) and DOTA's
Task1 files per class; for images named as DOTA's split tiles
(`name__scale__x___y`) also the merged files: each tile's boxes moved by
its window origin, then greedy class-offset rotated NMS at IoU 0.3 per
source image.
"""

from __future__ import annotations

import json
import re
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch import nn

from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.data.converter import coco80_to_coco91_class
from edgeyolo_tpu_torch.data.dataset import YOLODataset, build_dataloader, check_det_dataset
from edgeyolo_tpu_torch.engine.predictor import (detr_detections, e2e_detections,
                                                 unletterbox_boxes)
from edgeyolo_tpu_torch.metrics.coco_eval import evaluate_coco
from edgeyolo_tpu_torch.metrics.metrics import (DetMetrics, _box_iou_np, match_predictions,
                                                match_predictions_device)
from edgeyolo_tpu_torch.nn.tasks import for_precision, is_rtdetr
from edgeyolo_tpu_torch.ops.boxes import box_iou, probiou, xywhr2xyxyxyxy
from edgeyolo_tpu_torch.ops.nms import nms_rotated, non_max_suppression
from edgeyolo_tpu_torch.ops.resize import resize_bilinear
from edgeyolo_tpu_torch.ops.segments import proto_masks
from edgeyolo_tpu_torch.utils import LOGGER, select_device


class DetectionValidator:
    """Runs the eval loop and computes detection metrics; `validator(model)`
    returns `results_dict`."""

    def __init__(self, args=None, save_dir: str | Path = "runs/val", device=None):
        self.args = args if args is not None else get_cfg(overrides={"mode": "val"})
        self.save_dir = Path(save_dir)
        self.device = select_device(device if device is not None else self.args.device)
        self.metrics = None
        self.jdict: list[dict] = []  # this call's predictions.json rows
        self.class_map = None  # contiguous class -> json category_id, set per call
        self._loader = None  # kept across calls (the trainer validates every epoch)

    def _dataloader(self, data_cfg: dict, bs: int):
        if self._loader is None:
            split = data_cfg.get(self.args.split or "val") or data_cfg["val"]
            dataset = YOLODataset(split, imgsz=int(self.args.imgsz), augment=False,
                                  names=data_cfg["names"],
                                  single_cls=bool(getattr(self.args, "single_cls", False)))
            if bool(getattr(self.args, "rect", False)):
                dataset.set_rectangle(bs)
            self._loader = build_dataloader(dataset, bs, shuffle=False)
        return self._loader

    @torch.inference_mode()
    def infer(self, model, img: torch.Tensor, gt: tuple, max_nms: int):
        """One batch on the device: forward, NMS, native-space boxes and the TP
        matrix. img (B, H, W, 3) uint8; gt = (boxes, cls, valid, geom) from
        `_gt_arrays`, on the device. Returns det (B, max_det, 6) in letterbox
        space, n (B,) and tp (B, max_det, 10)."""
        args = self.args
        x = img.permute(0, 3, 1, 2).contiguous().to(getattr(model, "dtype", torch.float32)) / 255
        pred = model(x)["pred"]
        if getattr(model, "end2end", False):
            det, n = e2e_detections(pred, self.conf, int(args.max_det))
        elif is_rtdetr(model):
            det, n = detr_detections(pred, x.shape[2:], self.conf, int(args.max_det))
        else:
            det, n = non_max_suppression(
                pred, conf_thres=self.conf, iou_thres=float(args.iou),
                max_det=int(args.max_det), max_nms=max_nms, multi_label=True,
                agnostic=bool(args.single_cls), method="tiled")
        gtb, gtc, gtv, geom = gt
        r, pw, ph, w0, h0 = geom.unbind(-1)
        shift = torch.stack([pw, ph, pw, ph], -1)[:, None, :]
        lim = torch.stack([w0, h0, w0, h0], -1)[:, None, :]
        bx = torch.minimum(((det[..., :4] - shift) / r[:, None, None]).clamp(min=0.0), lim)
        dvalid = torch.arange(det.shape[1], device=det.device)[None] < n[:, None]
        tp = match_predictions_device(det[..., 5], gtc, gtv > 0, dvalid, box_iou(gtb, bx))
        return det, n, tp

    def __call__(self, model, data=None, batch_size: int | None = None, max_nms: int = 30000):
        args = self.args
        self.conf = args.conf if args.conf is not None else 0.001
        data_cfg = check_det_dataset(data or args.data)
        names = data_cfg["names"]
        bs = int(batch_size or args.batch or 16)
        save_json = bool(getattr(args, "save_json", False))
        split = data_cfg.get(args.split or "val") or data_cfg["val"]
        # COCO GT jsons use the sparse 1-90 category ids (reference pred_to_json)
        self.class_map = (coco80_to_coco91_class() if save_json and len(names) == 80
                          and "coco" in str(split).lower() else None)
        self.jdict = []
        loader = self._dataloader(data_cfg, bs)
        net = for_precision(model, bool(args.half)) if isinstance(model, nn.Module) else model
        was_training = getattr(net, "training", False)
        if hasattr(net, "eval"):
            net.eval()
        metrics = DetMetrics(names)
        seen = 0
        t_pre = t_inf = t_post = 0.0
        try:
            for batch in loader:
                t0 = time.perf_counter()
                img = torch.from_numpy(batch["img"]).to(self.device, non_blocking=True)
                gt = tuple(torch.from_numpy(a).to(self.device) for a in self._gt_arrays(batch))
                t1 = time.perf_counter()
                det, n, tp = (t.cpu().numpy() for t in self.infer(net, img, gt, max_nms))
                t2 = time.perf_counter()
                for i in range(batch["n_real"]):
                    seen += 1
                    k = int(n[i])
                    meta = batch["meta"][i]
                    metrics.update_batch(tp[i, :k], det[i, :k, 4], det[i, :k, 5],
                                         meta["ori_cls"])
                    if save_json:
                        r, pads = meta["ratio_pad"]
                        native = unletterbox_boxes(det[i, :k].copy(), r, *pads, meta["ori_shape"])
                        self._to_json(native, meta["im_file"])
                t_pre += t1 - t0
                t_inf += t2 - t1
                t_post += time.perf_counter() - t2
        finally:
            if was_training:
                net.train()
        metrics.process()
        metrics.speed = {"preprocess": t_pre / max(seen, 1) * 1000,
                         "inference": t_inf / max(seen, 1) * 1000,
                         "postprocess": t_post / max(seen, 1) * 1000, "loss": 0.0}
        self.metrics = metrics
        self.seen = seen
        LOGGER.info(self.results_line())
        if save_json and self.jdict:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            pred_path = self.save_dir / "predictions.json"
            pred_path.write_text(json.dumps(self.jdict))
            gt_json = data_cfg.get("annotations") or data_cfg.get("gt_json")
            if gt_json and Path(gt_json).exists():
                for k, v in evaluate_coco(gt_json, pred_path).items():
                    metrics.speed[f"coco/{k}"] = v
        return metrics.results_dict

    def results_line(self) -> str:
        """The results row: images, P, R, mAP50, mAP75 (the fork's column), mAP50-95."""
        mp, mr, map50, map_ = self.metrics.mean_results()
        return (f"{'all':>10}{self.seen:>8}{mp:>11.3g}{mr:>11.3g}{map50:>11.3g}"
                f"{self.metrics.box.map75:>11.3g}{map_:>11.3g}")

    def _to_json(self, det: np.ndarray, im_file: str):
        """COCO result rows: image_id from a numeric stem, top-left xywh rounded to 3 places."""
        stem = Path(im_file).stem
        image_id = int(stem) if stem.isnumeric() else stem
        box = det[:, :4].copy()
        box[:, 2:] -= box[:, :2]
        for b, d in zip(box.tolist(), det.tolist()):
            ci = int(d[5])
            self.jdict.append({"image_id": image_id,
                               "category_id": self.class_map[ci] if self.class_map else ci,
                               "bbox": [round(x, 3) for x in b], "score": round(d[4], 5)})

    @staticmethod
    def _gt_arrays(batch):
        """Each image's native-space gt padded to Mp (a multiple of 32, at least
        32) slots: xyxy boxes, classes (-1 in padding, never matching), a
        validity mask and the letterbox geometry (r, pw, ph, w0, h0)."""
        metas = batch["meta"]
        B = len(metas)
        mx = max((len(m["ori_cls"]) for m in metas), default=0)
        Mp = max(32, ((mx + 31) // 32) * 32)
        gtb = np.zeros((B, Mp, 4), np.float32)
        gtc = np.full((B, Mp), -1.0, np.float32)
        gtv = np.zeros((B, Mp), np.float32)
        geom = np.zeros((B, 5), np.float32)
        for i, m in enumerate(metas):
            h0, w0 = m["ori_shape"]
            r, (pw, ph) = m["ratio_pad"]
            geom[i] = (r, pw, ph, w0, h0)
            cls = m["ori_cls"]
            n = len(cls)
            if n:
                b = m["ori_bboxes"] * np.array([w0, h0, w0, h0], np.float32)
                gtb[i, :n] = np.concatenate([b[:, :2] - b[:, 2:] / 2, b[:, :2] + b[:, 2:] / 2], 1)
                gtc[i, :n] = cls
                gtv[i, :n] = 1.0
        return gtb, gtc, gtv, geom


def mask_iou_matrix(pm: torch.Tensor, gm: torch.Tensor, size: int | None, overlap: bool,
                    chunk: int = 64) -> torch.Tensor:
    """(G, D) IoU of one image's gt masks gm (G, h, w) and predicted masks pm
    (D, h', w') in [0, 1]: gt made exclusive with `overlap`; with `size` both
    sides resized bilinearly to (size, size) first; cut at 0.5."""
    gm = gm.float()
    if overlap:  # a shared pixel stays with the smallest instance
        areas = gm.sum((1, 2))
        a = torch.where(gm > 0.5, areas[:, None, None], torch.inf)
        gm = gm * (a <= a.amin(0, keepdim=True))
    if size:
        gm = resize_bilinear(gm[None], (size, size))[0]
    gmb = (gm > 0.5).float()
    inter, psum = [], []
    for start in range(0, pm.shape[0], chunk):
        pc = pm[start:start + chunk].float()
        if size:
            pc = resize_bilinear(pc[None], (size, size))[0]
        pcb = (pc > 0.5).float()
        inter.append(torch.einsum("ghw,dhw->gd", gmb, pcb))
        psum.append(pcb.sum((1, 2)))
    inter, psum = torch.cat(inter, 1), torch.cat(psum)
    return inter / (gmb.sum((1, 2))[:, None] + psum[None, :] - inter + 1e-7)


class SegmentationValidator(DetectionValidator):
    """Box and mask metrics of a segment model; `validator(model)` returns
    the box `results_dict` plus the mask mAP50 and mAP50-95."""

    def __init__(self, args=None, save_dir: str | Path = "runs/val", device=None,
                 mask_iou_res: str = "native"):
        super().__init__(args, save_dir, device)
        if mask_iou_res not in ("native", "proto"):
            raise ValueError(f"mask_iou_res must be 'native' or 'proto', got {mask_iou_res!r}")
        self.mask_iou_res = mask_iou_res

    def _dataloader(self, data_cfg: dict, bs: int):
        if self._loader is None:
            split = data_cfg.get(self.args.split or "val") or data_cfg["val"]
            dataset = YOLODataset(split, imgsz=int(self.args.imgsz), augment=False,
                                  names=data_cfg["names"], task="segment", mask_ratio=4,
                                  single_cls=bool(getattr(self.args, "single_cls", False)))
            self._loader = build_dataloader(dataset, bs, shuffle=False)
        return self._loader

    @torch.inference_mode()
    def infer_masks(self, model, img: torch.Tensor, gt_masks: torch.Tensor, max_nms: int):
        """One batch on the device: det (B, max_det, 6) in letterbox pixels,
        n (B,) and the (B, G, max_det) mask IoUs against the gt masks."""
        args = self.args
        x = img.permute(0, 3, 1, 2).contiguous().to(getattr(model, "dtype", torch.float32)) / 255
        out = model(x)
        pred, nc = out["pred"], model.nc
        det, n, aidx = non_max_suppression(
            pred[..., :4 + nc], conf_thres=self.conf, iou_thres=float(args.iou),
            max_det=int(args.max_det), max_nms=max_nms, multi_label=True, nc=nc,
            return_idx=True, method="tiled")
        coefs = pred[..., 4 + nc:].gather(1, aidx.long()[..., None].expand(-1, -1, pred.shape[-1]
                                                                           - 4 - nc))
        size = x.shape[2]
        masks = proto_masks(out["proto"], coefs, det[..., :4], size)
        native = size if self.mask_iou_res == "native" else None
        overlap = bool(getattr(args, "overlap_mask", True))
        iou = torch.stack([mask_iou_matrix(pm, gm, native, overlap)
                           for pm, gm in zip(masks, gt_masks)])
        return det, n, iou

    def __call__(self, model, data=None, batch_size: int | None = None, max_nms: int = 30000):
        args = self.args
        self.conf = args.conf if args.conf is not None else 0.001
        data_cfg = check_det_dataset(data or args.data)
        names = data_cfg["names"]
        bs = int(batch_size or args.batch or 16)
        loader = self._dataloader(data_cfg, bs)
        net = for_precision(model, bool(args.half)) if isinstance(model, nn.Module) else model
        was_training = getattr(net, "training", False)
        if hasattr(net, "eval"):
            net.eval()
        box_m, mask_m = DetMetrics(names), DetMetrics(names)
        seen = 0
        try:
            for batch in loader:
                img = torch.from_numpy(batch["img"]).to(self.device, non_blocking=True)
                gtm = torch.from_numpy(batch["masks"]).to(self.device)
                det_b, n_b, iou_b = (t.cpu().numpy() for t in self.infer_masks(net, img, gtm,
                                                                               max_nms))
                for i in range(batch["n_real"]):
                    meta = batch["meta"][i]
                    seen += 1
                    n = int(n_b[i])
                    det = det_b[i, :n].copy()
                    h0, w0 = meta["ori_shape"]
                    r, (pw, ph) = meta["ratio_pad"]
                    if n:
                        det[:, [0, 2]] = (det[:, [0, 2]] - pw) / r
                        det[:, [1, 3]] = (det[:, [1, 3]] - ph) / r
                    gt_cls = meta["ori_cls"]
                    gtb = meta["ori_bboxes"] * np.array([w0, h0, w0, h0], np.float32)
                    gtb = np.concatenate([gtb[:, :2] - gtb[:, 2:] / 2,
                                          gtb[:, :2] + gtb[:, 2:] / 2], 1)
                    iou_box = (_box_iou_np(gtb, det[:, :4]) if (n and len(gtb))
                               else np.zeros((len(gtb), n)))
                    box_m.update_batch(match_predictions(det[:, 5], gt_cls, iou_box), det[:, 4],
                                       det[:, 5], gt_cls)
                    ngt = int(meta["mask_gt"].sum())
                    if ngt:
                        mask_m.update_batch(
                            match_predictions(det[:, 5], gt_cls[:ngt], iou_b[i, :ngt, :n]),
                            det[:, 4], det[:, 5], gt_cls[:ngt])
        finally:
            if was_training:
                net.train()
        box_m.process()
        mask_m.process()
        self.metrics, self.mask_metrics, self.seen = box_m, mask_m, seen
        res = box_m.results_dict
        res.update({"metrics/mAP50(M)": mask_m.box.map50, "metrics/mAP50-95(M)": mask_m.box.map})
        LOGGER.info(f"seg val: box mAP50-95 {box_m.box.map:.4f}  mask mAP50-95 "
                    f"{mask_m.box.map:.4f}")
        return res


# COCO's 17 keypoint sigmas, as the validators use them
OKS_SIGMAS = np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87,
                       .89, .89]) / 10.0


def _native_xyxy(meta) -> np.ndarray:
    """An image's gt boxes (all of them) as native-pixel xyxy."""
    h0, w0 = meta["ori_shape"]
    gtb = meta["ori_bboxes"] * np.array([w0, h0, w0, h0], np.float32)
    return np.concatenate([gtb[:, :2] - gtb[:, 2:] / 2, gtb[:, :2] + gtb[:, 2:] / 2], 1)


class _TaskValidator(DetectionValidator):
    """The shared loop of the pose and obb validators: `begin(names)`, then
    per batch one device call (`infer_batch`) and per real image `update`
    on the host."""

    task = "detect"

    def _dataloader(self, data_cfg: dict, bs: int, **kw):
        if self._loader is None:
            split = data_cfg.get(self.args.split or "val") or data_cfg["val"]
            dataset = YOLODataset(split, imgsz=int(self.args.imgsz), augment=False,
                                  names=data_cfg["names"], task=self.task,
                                  single_cls=bool(getattr(self.args, "single_cls", False)), **kw)
            self._loader = build_dataloader(dataset, bs, shuffle=False)
        return self._loader

    def _images(self, model, img: torch.Tensor) -> torch.Tensor:
        return img.permute(0, 3, 1, 2).contiguous().to(getattr(model, "dtype", torch.float32)) / 255

    def _run(self, model, data, batch_size, max_nms, **loader_kw):
        args = self.args
        self.conf = args.conf if args.conf is not None else 0.001
        data_cfg = check_det_dataset(data or args.data)
        self.names = data_cfg["names"]
        self.begin(self.names)
        bs = int(batch_size or args.batch or 16)
        loader = self._dataloader(data_cfg, bs, **loader_kw)
        net = for_precision(model, bool(args.half)) if isinstance(model, nn.Module) else model
        was_training = getattr(net, "training", False)
        if hasattr(net, "eval"):
            net.eval()
        self.jdict, self.seen = [], 0
        try:
            for batch in loader:
                img = torch.from_numpy(batch["img"]).to(self.device, non_blocking=True)
                outs = [t.cpu().numpy() for t in self.infer_batch(net, img, max_nms)]
                for i in range(batch["n_real"]):
                    self.seen += 1
                    self.update(batch["meta"][i], *(o[i] for o in outs))
        finally:
            if was_training:
                net.train()


class PoseValidator(_TaskValidator):
    """Box and pose (OKS) metrics of a pose model; `validator(model)` returns
    the box `results_dict` plus the pose mAP50 and mAP50-95."""

    task = "pose"

    @torch.inference_mode()
    def infer_batch(self, model, img: torch.Tensor, max_nms: int):
        """det (B, max_det, 6) and keypoints (B, max_det, K * D) in letterbox
        pixels, n (B,)."""
        args = self.args
        pred, nc = model(self._images(model, img))["pred"], model.nc
        det, n, aidx = non_max_suppression(
            pred[..., :4 + nc], conf_thres=self.conf, iou_thres=float(args.iou),
            max_det=int(args.max_det), max_nms=max_nms, multi_label=True, nc=nc,
            return_idx=True, method="tiled")
        nk = pred.shape[-1] - 4 - nc
        return det, n, pred[..., 4 + nc:].gather(1, aidx.long()[..., None].expand(-1, -1, nk))

    def update(self, meta: dict, det_b, n, kpts_b):
        n = int(n)
        k, d = self.kpt_shape
        det, pk = det_b[:n].copy(), kpts_b[:n].reshape(n, k, d).copy()
        r, (pw, ph) = meta["ratio_pad"]
        if n:
            det[:, [0, 2]] = (det[:, [0, 2]] - pw) / r
            det[:, [1, 3]] = (det[:, [1, 3]] - ph) / r
            pk[..., 0] = (pk[..., 0] - pw) / r
            pk[..., 1] = (pk[..., 1] - ph) / r
        gt_cls, gtb = meta["ori_cls"], _native_xyxy(meta)
        iou_box = _box_iou_np(gtb, det[:, :4]) if (n and len(gtb)) else np.zeros((len(gtb), n))
        self.box_m.update_batch(match_predictions(det[:, 5], gt_cls, iou_box), det[:, 4],
                                det[:, 5], gt_cls)
        ngt = int(meta["mask_gt"].sum())
        if ngt and n:  # OKS against the gt keypoints in original pixels
            gk = meta["keypoints"][:ngt].copy()
            gk[..., 0] = (gk[..., 0] - pw) / r
            gk[..., 1] = (gk[..., 1] - ph) / r
            area = (gtb[:ngt, 2] - gtb[:ngt, 0]) * (gtb[:ngt, 3] - gtb[:ngt, 1]) * 0.53
            sigmas = OKS_SIGMAS if k == 17 else np.full(k, 1.0 / k)
            d2 = ((gk[:, None, :, 0] - pk[None, :, :, 0]) ** 2
                  + (gk[:, None, :, 1] - pk[None, :, :, 1]) ** 2)
            vis = gk[..., 2] > 0
            e = d2 / (2 * sigmas[None, None]) ** 2 / (area[:, None, None] + 1e-7) / 2
            oks = (np.exp(-e) * vis[:, None]).sum(-1) / (vis.sum(-1)[:, None] + 1e-7)
            self.pose_m.update_batch(match_predictions(det[:, 5], gt_cls[:ngt], oks), det[:, 4],
                                     det[:, 5], gt_cls[:ngt])

    def begin(self, names: dict) -> None:
        self.box_m, self.pose_m = DetMetrics(names), DetMetrics(names)

    def __call__(self, model, data=None, batch_size: int | None = None, max_nms: int = 30000):
        self.kpt_shape = tuple(getattr(model, "kpt_shape", None) or (17, 3))
        self._run(model, data, batch_size, max_nms, kpt_shape=self.kpt_shape)
        self.box_m.process()
        self.pose_m.process()
        self.metrics, self.pose_metrics = self.box_m, self.pose_m
        res = self.box_m.results_dict
        res.update({"metrics/mAP50(P)": self.pose_m.box.map50,
                    "metrics/mAP50-95(P)": self.pose_m.box.map})
        LOGGER.info(f"pose val: box mAP50-95 {self.box_m.box.map:.4f}  pose mAP50-95 "
                    f"{self.pose_m.box.map:.4f}")
        return res


class OBBValidator(_TaskValidator):
    """Rotated-box metrics (probiou matching) of an obb model; `validator(model)`
    returns its `results_dict`."""

    task = "obb"

    @torch.inference_mode()
    def infer_batch(self, model, img: torch.Tensor, max_nms: int):
        """det (B, max_det, 7) [cx, cy, w, h, angle, conf, cls] in letterbox
        pixels, n (B,)."""
        args = self.args
        return nms_rotated(model(self._images(model, img))["pred"], conf_thres=self.conf,
                           iou_thres=float(args.iou), max_det=int(args.max_det),
                           max_nms=max_nms, multi_label=True)

    def update(self, meta: dict, det_b, n):
        n = int(n)
        det = det_b[:n].copy()
        r, (pw, ph) = meta["ratio_pad"]
        pred_r = (np.stack([(det[:, 0] - pw) / r, (det[:, 1] - ph) / r, det[:, 2] / r,
                            det[:, 3] / r, det[:, 4]], 1) if n else np.zeros((0, 5), np.float32))
        if self.save_json and n:
            self.pred_to_json(self.jdict, pred_r, det[:, 5], det[:, 6], meta["im_file"])
        gt_cls, ngt = meta["ori_cls"], int(meta["mask_gt"].sum())
        gr = meta["rboxes_ori"][:ngt]
        iou = (probiou(torch.from_numpy(gr)[:, None], torch.from_numpy(pred_r)[None])[..., 0].numpy()
               if n and ngt else np.zeros((ngt, n)))
        self.obb_m.update_batch(match_predictions(det[:, 6], gt_cls[:ngt], iou), det[:, 5],
                                det[:, 6], gt_cls[:ngt])

    def begin(self, names: dict) -> None:
        self.obb_m = DetMetrics(names)

    def __call__(self, model, data=None, batch_size: int | None = None, max_nms: int = 30000):
        self.save_json = bool(getattr(self.args, "save_json", False))
        self._run(model, data, batch_size, max_nms)
        self.obb_m.process()
        self.metrics = self.obb_m
        LOGGER.info(f"obb val: probiou mAP50-95 {self.obb_m.box.map:.4f}")
        if self.save_json and self.jdict:
            self.eval_json_dota(self.jdict, self.names)
        return self.obb_m.results_dict

    @staticmethod
    def pred_to_json(jdict: list, rboxes: np.ndarray, conf, cls, im_file: str) -> None:
        """Rotated rows in original pixels: image_id from the file's stem (a
        number where it is one), 1-based category_id, score to 5 places, rbox
        and its 8-value polygon to 3."""
        stem = Path(im_file).stem
        image_id = int(stem) if stem.isnumeric() else stem
        polys = xywhr2xyxyxyxy(rboxes).reshape(-1, 8)
        for rb, p, sc, c in zip(rboxes, polys, conf, cls):
            jdict.append({"image_id": image_id, "category_id": int(c) + 1,
                          "score": round(float(sc), 5),
                          "rbox": [round(float(x), 3) for x in rb],
                          "poly": [round(float(x), 3) for x in p]})

    def eval_json_dota(self, jdict: list, names: dict) -> None:
        """predictions.json, DOTA Task1 files per class, and for split tiles
        the merged Task1 files."""
        self.save_dir.mkdir(parents=True, exist_ok=True)
        (self.save_dir / "predictions.json").write_text(json.dumps(jdict))
        pred_txt = self.save_dir / "predictions_txt"
        pred_txt.mkdir(parents=True, exist_ok=True)
        LOGGER.info(f"saving DOTA-format predictions to {pred_txt}")
        for d in jdict:
            cname = str(names[d["category_id"] - 1]).replace(" ", "-")
            with open(pred_txt / f"Task1_{cname}.txt", "a") as f:
                f.write(f"{d['image_id']} {d['score']} " + " ".join(str(x) for x in d["poly"][:8])
                        + "\n")
        tile = re.compile(r"\d+___\d+")  # a DOTA split tile: name__scale__x___y
        if not any(tile.search(str(d["image_id"])) for d in jdict):
            return
        merged = defaultdict(list)
        for d in jdict:
            x, y = (int(c) for c in tile.findall(str(d["image_id"]))[0].split("___"))
            rb = list(d["rbox"])
            rb[0] += x
            rb[1] += y
            merged[str(d["image_id"]).split("__")[0]].append(rb + [d["score"],
                                                                   d["category_id"] - 1])
        out_dir = self.save_dir / "predictions_merged_txt"
        out_dir.mkdir(parents=True, exist_ok=True)
        for image_id, rows in merged.items():
            arr = np.asarray(rows, np.float32)  # (n, 7)
            shifted = arr[:, :5].copy()
            shifted[:, :2] += arr[:, 6:7] * float(arr[:, :2].max()) * 2  # the class offset
            boxes = torch.from_numpy(shifted)
            keep: list[int] = []
            for j in np.argsort(-arr[:, 5]):  # greedy rotated NMS at IoU 0.3
                if not keep or bool((probiou(boxes[j][None], boxes[keep])[:, 0] < 0.3).all()):
                    keep.append(int(j))
            kept = arr[keep]
            for row, p in zip(kept, xywhr2xyxyxyxy(kept[:, :5]).reshape(-1, 8)):
                cname = str(names[int(row[6])]).replace(" ", "-")
                with open(out_dir / f"Task1_{cname}.txt", "a") as f:
                    f.write(f"{image_id} {round(float(row[5]), 3)} "
                            + " ".join(str(round(float(x), 3)) for x in p) + "\n")
