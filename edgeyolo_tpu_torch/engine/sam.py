"""The SAM facade (edgeyolo_tpu/engine/sam.py): encode once, prompt many times.

    sam = SAM("vit_b")                  # or "vit_l", "vit_h", "mobile_sam"; seeded weights
    sam.set_image(img)                  # HWC uint8 (or gray HW)
    masks, ious = sam(points=[[100, 200]], labels=[1])
    masks, ious = sam(bboxes=[50, 60, 180, 220], multimask_output=True)
    anns = sam.generate(img)            # segment everything (grid_generate)

`set_image` resizes the image to img_size x img_size by jax.image.resize's
bilinear rule (ops/resize.py; antialiased when it shrinks), normalises it
by ImageNet's mean and std in 0-255 units, and caches one encoding. A call
prompts the cached embedding with points (labels 1 foreground, 0
background) and boxes (two corner points, labels 2 and 3) in the original
image's pixels, and returns the mask (or with `multimask_output` the best
of the three multimask outputs by predicted IoU) resized back to the
original size by the same rule and cut at logit 0, with its predicted IoU.
Everything computes in f32, as JAX's facade does. A `.pt` / `.pth` name
raises, as JAX's: no SAM checkpoint ships with the package.

`grid_generate` is segment-everything: a regular point grid prompted in
batches, each point's three multimask outputs filtered by predicted IoU and
stability score, boxes of the low-resolution masks, a greedy NMS by
predicted IoU, and optionally `remove_small_regions`. Runs on CUDA unless
`device` names another device.
"""

from __future__ import annotations

import numpy as np
import torch

from edgeyolo_tpu_torch.nn.sam import build_sam
from edgeyolo_tpu_torch.ops.resize import resize_bilinear
from edgeyolo_tpu_torch.utils import LOGGER, select_device

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def preprocess(img: np.ndarray, size: int, device: torch.device) -> torch.Tensor:
    """One HWC (or HW) image -> (1, 3, size, size) on `device`: the pixels
    go up as they are and become f32 there, then jax.image.resize's bilinear
    rule and ImageNet's mean and std in 0-255 units."""
    h, w = img.shape[:2]
    x = torch.as_tensor(np.asarray(img), device=device).float()
    x = x[..., None].expand(h, w, 3) if x.ndim == 2 else x
    x = resize_bilinear(x.permute(2, 0, 1)[None], (size, size))
    mean = torch.tensor(MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=device).view(1, 3, 1, 1)
    return (x - mean) / std


class SAM:
    """Promptable segmentation handle."""

    def __init__(self, model: str = "vit_b", img_size: int = 1024, seed: int = 0,
                 device: str | torch.device | None = None):
        if str(model).endswith((".pt", ".pth")):
            raise NotImplementedError("SAM .pt weight conversion is not supported; pass a "
                                      "variant name")
        self.device = select_device(device)
        self.img_size = int(img_size)
        self.net = build_sam(str(model), img_size=self.img_size, seed=seed).to(self.device)
        self._embed = None
        self._hw = None
        LOGGER.info(f"SAM {model} ready (img_size={self.img_size})")

    @torch.inference_mode()
    def set_image(self, img: np.ndarray) -> "SAM":
        """Resize and normalise one HWC image and cache its embedding."""
        self._hw = img.shape[:2]
        self._embed = self.net.encode(preprocess(img, self.img_size, self.device))
        return self

    @torch.inference_mode()
    def __call__(self, points=None, labels=None, bboxes=None, multimask_output: bool = False):
        """One prompt against the cached embedding: points (N, 2) in the
        original image's pixels with labels (N,), and/or bboxes (4,) or (K, 4)
        xyxy. Returns (masks (1, H, W) bool at the original size, iou (1,))."""
        if self._embed is None:
            raise RuntimeError("call set_image() first")
        h, w = self._hw
        pts, labs = [], []
        if points is not None:
            p = np.atleast_2d(np.asarray(points, np.float32))
            pts.append(p / [w, h])
            labs.append(np.asarray(labels if labels is not None else np.ones(len(p)), np.int32))
        if bboxes is not None:
            for x1, y1, x2, y2 in np.atleast_2d(np.asarray(bboxes, np.float32)):
                pts.append(np.asarray([[x1 / w, y1 / h], [x2 / w, y2 / h]], np.float32))
                labs.append(np.asarray([2, 3], np.int32))
        if not pts:
            raise ValueError("provide points and/or bboxes")
        p = torch.from_numpy(np.concatenate(pts, 0).astype(np.float32))[None].to(self.device)
        lab = torch.from_numpy(np.concatenate(labs, 0))[None].to(self.device)
        masks, iou = self.net.prompt(self._embed, p, lab)
        if multimask_output:
            masks, iou = masks[:, 1:], iou[:, 1:]
            best = int(iou[0].argmax())
        else:
            best = 0
        m = resize_bilinear(masks[:, best:best + 1], (h, w))[0]
        return (m > 0.0).cpu().numpy(), iou[0, best:best + 1].cpu().numpy()

    @torch.inference_mode()
    def _prompt_batch(self, pts01: np.ndarray):
        """Single-point prompts (B, 2) xy in [0, 1] against the cached
        embedding: (multimask logits (B, 3, h, w), iou (B, 3)), on the device."""
        if self._embed is None:
            raise RuntimeError("call set_image() first")
        b = len(pts01)
        e = self._embed.expand(b, -1, -1, -1)
        p = torch.as_tensor(np.asarray(pts01, np.float32), device=self.device)[:, None]
        lab = torch.ones(b, 1, dtype=torch.int32, device=self.device)
        masks, iou = self.net.prompt(e, p, lab)
        return masks[:, 1:], iou[:, 1:]

    def generate(self, img, **kw):
        """Segment everything (`grid_generate`)."""
        return grid_generate(self, img, **kw)

    def info(self) -> int:
        n = sum(p.numel() for p in self.net.parameters())
        LOGGER.info(f"SAM: {n:,} params, encoder img_size {self.img_size}")
        return n


def _greedy_nms(boxes: np.ndarray, order, thresh: float) -> list[int]:
    """Indices in `order` kept by a greedy box-IoU suppression above `thresh`."""
    kept: list[int] = []
    for i in order:
        bi = boxes[i]
        dup = False
        for j in kept:
            bj = boxes[j]
            iw = max(0.0, min(bi[2], bj[2]) - max(bi[0], bj[0]))
            ih = max(0.0, min(bi[3], bj[3]) - max(bi[1], bj[1]))
            inter = iw * ih
            ua = ((bi[2] - bi[0]) * (bi[3] - bi[1]) + (bj[2] - bj[0]) * (bj[3] - bj[1]) - inter)
            if ua > 0 and inter / ua > thresh:
                dup = True
                break
        if not dup:
            kept.append(int(i))
    return kept


def grid_generate(fac, img, points_per_side: int = 16, points_per_batch: int = 64,
                  pred_iou_thresh: float = 0.88, stability_thresh: float = 0.95,
                  stability_offset: float = 1.0, nms_iou: float = 0.7, min_area: int = 0):
    """Segment everything by a point-grid sweep (JAX's grid_generate, the
    reference's crop_n_layers=0 path): a list of {"segmentation" (H, W)
    bool, "bbox" xyxy, "predicted_iou", "stability_score"}. `fac` is any
    facade with set_image() and _prompt_batch()."""
    fac.set_image(img)
    h, w = img.shape[:2]
    side = points_per_side
    xs = (np.arange(side) + 0.5) / side
    grid = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2).astype(np.float32)  # (P, 2) xy

    cand_masks, cand_iou, cand_stab = [], [], []
    for i in range(0, len(grid), points_per_batch):
        logits, ious = fac._prompt_batch(grid[i:i + points_per_batch])
        b, k = ious.shape
        flat = logits.reshape(b * k, *logits.shape[2:])
        area_i = (flat > stability_offset).sum((1, 2)).double()
        area_u = (flat > -stability_offset).sum((1, 2)).double()
        stab = torch.where(area_u > 0, area_i / area_u.clamp_min(1), 1.0)
        fi = ious.reshape(b * k)
        keep = (fi > pred_iou_thresh) & (stab > stability_thresh)
        if keep.any():
            cand_masks.append((flat[keep] > 0.0).cpu().numpy())
            cand_iou.append(fi[keep].float().cpu().numpy())
            cand_stab.append(stab[keep].cpu().numpy())
    if not cand_masks:
        return []
    masks = np.concatenate(cand_masks, 0)
    ious = np.concatenate(cand_iou, 0)
    stabs = np.concatenate(cand_stab, 0)

    # boxes of the low-resolution masks; masks of min_area pixels or fewer dropped
    boxes = np.zeros((len(masks), 4), np.float32)
    ok = np.zeros(len(masks), bool)
    for i, m in enumerate(masks):
        ys, xs_ = np.nonzero(m)
        if len(ys) <= min_area:
            continue
        boxes[i] = [xs_.min(), ys.min(), xs_.max() + 1, ys.max() + 1]
        ok[i] = True
    masks, boxes, ious, stabs = masks[ok], boxes[ok], ious[ok], stabs[ok]
    if not len(masks):
        return []
    kept = _greedy_nms(boxes, np.argsort(-ious), nms_iou)
    if min_area > 0 and kept:
        sub, keep2 = remove_small_regions(masks[kept], min_area, nms_thresh=nms_iou)
        kept = [kept[j] for j in keep2]
        masks[kept] = sub  # the repaired masks replace the originals

    out = []
    lh, lw = masks.shape[1:]
    dev = getattr(fac, "device", "cpu")
    for i in kept:
        low = torch.as_tensor(masks[i], dtype=torch.float32, device=dev)
        big = resize_bilinear(low[None, None], (h, w))[0, 0]
        sx, sy = w / lw, h / lh
        out.append({"segmentation": (big > 0.5).cpu().numpy(),
                    "bbox": [float(boxes[i][0] * sx), float(boxes[i][1] * sy),
                             float(boxes[i][2] * sx), float(boxes[i][3] * sy)],
                    "predicted_iou": float(ious[i]), "stability_score": float(stabs[i])})
    return out


def remove_small_regions(masks, min_area: int = 0, nms_thresh: float = 0.7):
    """Fill holes and drop islands smaller than `min_area` (scipy's connected
    components), then a greedy NMS of the repaired masks' boxes in which
    untouched masks (score 1) come before repaired ones (score 0), stable
    among equals (the reference's remove_small_regions). masks (N, H, W) ->
    (new masks (M, H, W) bool, kept indices, ascending)."""
    from scipy import ndimage

    masks = np.asarray(masks).astype(bool)
    if len(masks) == 0:
        return masks, []
    new_masks, scores = [], []
    for m in masks:
        changed = False
        for mode in ("holes", "islands"):
            work = ~m if mode == "holes" else m
            lab, n = ndimage.label(work)
            if n:
                sizes = ndimage.sum(work, lab, index=np.arange(1, n + 1))
                small = np.flatnonzero(sizes < min_area) + 1
                if len(small):
                    changed = True
                    fill = np.isin(lab, small)
                    m = (m | fill) if mode == "holes" else (m & ~fill)
        new_masks.append(m)
        scores.append(0.0 if changed else 1.0)
    boxes = np.zeros((len(new_masks), 4), np.float32)
    for i, m in enumerate(new_masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    keep = sorted(_greedy_nms(boxes, np.argsort(-np.asarray(scores), kind="stable"),
                              nms_thresh))
    return np.stack([new_masks[i] for i in keep]), keep
