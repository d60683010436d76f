"""The serving step: uint8 images in, detections out (edgeyolo_tpu/engine/predictor.py).

The device part of the JAX predictor's `_build_infer` after bench.py's
normalisation: uint8 NHWC -> model dtype / 255 -> NCHW forward -> f32 DFL
decode with the DGQP quality product -> class-aware matrix NMS. Boxes are
clipped to the image, as the JAX predictor's postprocess does for an input
that was not letterboxed. File I/O, letterboxing and Results come later.
"""

from __future__ import annotations

import numpy as np
import torch

from edgeyolo_tpu_torch.ops.nms import non_max_suppression
from edgeyolo_tpu_torch.utils import select_device


class DetectionPredictor:
    """`predictor(images)` -> (det (B, max_det, 6) [x1, y1, x2, y2, conf, cls], n (B,))."""

    def __init__(self, model, conf: float = 0.25, iou: float = 0.7, max_det: int = 300,
                 max_nms: int = 8192, device=None):
        self.device = select_device(device)
        self.model = model.to(self.device).eval()
        self.conf, self.iou, self.max_det, self.max_nms = conf, iou, max_det, max_nms

    @torch.inference_mode()
    def __call__(self, images_u8_nhwc: np.ndarray | torch.Tensor):
        x = torch.as_tensor(images_u8_nhwc)
        if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected uint8 (B, H, W, 3) images, got {x.dtype} {tuple(x.shape)}")
        h, w = x.shape[1:3]
        x = x.to(self.device).permute(0, 3, 1, 2).contiguous()
        x = x.to(self.model.dtype) / 255
        pred = self.model(x)["pred"]
        det, n = non_max_suppression(pred, conf_thres=self.conf, iou_thres=self.iou,
                                     max_det=self.max_det, max_nms=self.max_nms)
        det[..., 0:4:2] = det[..., 0:4:2].clamp(0, w)
        det[..., 1:4:2] = det[..., 1:4:2].clamp(0, h)
        return det, n
