"""The YOLO-NAS facade (edgeyolo_tpu/engine/nas.py): an inference-only family.

The reference loads YOLO-NAS only as a pickled super-gradients model, never
from a YAML. The same gates hold here: a YAML name fails an assertion, and a
checkpoint name raises ImportError naming `super_gradients` (not installed,
and the port needs no such package). The part with behaviour, the NAS
postprocess, runs on the output of any `backend=` callable: decoded xyxy
boxes (B, A, 4) and per-class scores (B, A, nc), concatenated as xywh plus
scores and put through the port's class-aware NMS (ops/nms.py, JAX's
defaults: max_nms 4096, the matrix fixed point) on `device` (CUDA unless
named).

    nas = NAS("yolo_nas_s.pt", backend=my_callable, device="cuda")
    det, n = nas.predict(images, conf=0.25)     # (B, max_det, 6) xyxy, conf, cls
"""

from __future__ import annotations

from pathlib import Path

import torch

from edgeyolo_tpu_torch.ops.boxes import xyxy2xywh
from edgeyolo_tpu_torch.ops.nms import non_max_suppression
from edgeyolo_tpu_torch.utils import LOGGER, select_device


class NAS:
    """YOLO-NAS handle: pretrained checkpoints only."""

    def __init__(self, model: str = "yolo_nas_s.pt", backend=None, nc: int = 80,
                 device: str | torch.device | None = None):
        assert Path(model).suffix not in {".yaml", ".yml"}, \
            "YOLO-NAS models only support pre-trained weights, not YAML specs"
        self.model_name = str(model)
        self.nc = nc
        self.device = select_device(device)
        self.backend = backend  # callable: images -> (boxes (B, A, 4) xyxy, scores (B, A, nc))
        if backend is None:
            self._load(self.model_name)

    def _load(self, weights: str):
        try:
            import super_gradients  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "YOLO-NAS weights are super-gradients pickles; the super_gradients "
                "package is not available in this environment. Pass `backend=` with "
                "a callable producing (boxes_xyxy, scores) to run NAS inference.") from e
        raise ConnectionError(f"cannot download {weights}: offline environment")

    @torch.inference_mode()
    def postprocess(self, boxes, scores, conf: float = 0.25, iou: float = 0.45,
                    max_det: int = 300):
        """NAS raw output (arrays or tensors) -> (detections (B, max_det, 6),
        n_valid (B,)) on the facade's device."""
        boxes = torch.as_tensor(boxes, dtype=torch.float32, device=self.device)
        scores = torch.as_tensor(scores, dtype=torch.float32, device=self.device)
        pred = torch.cat([xyxy2xywh(boxes), scores], dim=-1)
        return non_max_suppression(pred, conf_thres=conf, iou_thres=iou, max_det=max_det)

    def predict(self, images, conf: float = 0.25, iou: float = 0.45, max_det: int = 300):
        """The backend on a batch, then the NAS postprocess."""
        if self.backend is None:
            raise RuntimeError("no backend loaded (see _load error above)")
        boxes, scores = self.backend(images)
        return self.postprocess(boxes, scores, conf, iou, max_det)

    __call__ = predict

    def info(self):
        LOGGER.info(f"NAS {self.model_name}: inference-only family, nc={self.nc}")
