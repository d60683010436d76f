"""Classification validation and prediction (edgeyolo_tpu/engine/classify.py).

ClassificationValidator: the val split (data/classify.py: resize and centre
crop on the host) in batches, uint8 up to the device, /255 in the model's
dtype (a bf16 copy with `half`), logits, and the top-k (k = min(5, nc))
indices in jax.lax.top_k's order (largest first, equal logits lower index
first); only the (B, k) indices come back. top1 and top5 are the shares of
real images whose label is the first index or among the k, and fitness is
their mean.

ClassificationPredictor: `predictor(images)` on a uint8 (B, S, S, 3) batch
is the serving step, softmax probabilities (B, nc) in f32; `stream(source)`
resizes and centre-crops each frame of a data/loaders.py source on the
host, runs `batch` frames a step (a short last batch repeats its last
frame, whose output is not read) and yields a `Results` with `probs` and
the per-image preprocess, inference and postprocess ms.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.data.classify import (ClassificationDataset, ClassifyLoader,
                                              check_cls_dataset, resize_center_crop)
from edgeyolo_tpu_torch.data.loaders import load_inference_source
from edgeyolo_tpu_torch.engine.results import Results
from edgeyolo_tpu_torch.nn.modules.head import topk_stable
from edgeyolo_tpu_torch.nn.tasks import for_precision
from edgeyolo_tpu_torch.utils import LOGGER, select_device


def _to_input(model, images_u8_nhwc, device) -> torch.Tensor:
    x = torch.as_tensor(images_u8_nhwc)
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"expected uint8 (B, H, W, 3) images, got {x.dtype} {tuple(x.shape)}")
    x = x.to(device, non_blocking=True).permute(0, 3, 1, 2).contiguous()
    return x.to(getattr(model, "dtype", torch.float32)) / 255


class ClassificationValidator:
    """Top-1 and top-5 accuracy over a folder-per-class val split;
    `validator(model)` returns the metrics dict."""

    def __init__(self, args=None, save_dir: str | Path = "runs/val", device=None):
        self.args = args if args is not None else get_cfg(overrides={"mode": "val",
                                                                     "task": "classify"})
        self.save_dir = Path(save_dir)
        self.device = select_device(device if device is not None else self.args.device)
        self.metrics: dict | None = None
        self.speed: dict = {}
        self.seen = 0
        self._loader = None  # kept across calls (the trainer validates every epoch)

    @torch.inference_mode()
    def infer(self, model, img: torch.Tensor) -> torch.Tensor:
        """(B, k) top-k class indices of uint8 (B, S, S, 3) images on the device."""
        logits = model(_to_input(model, img, self.device)).float()
        return topk_stable(logits, min(5, logits.shape[-1]))[1]

    def __call__(self, model, data=None, batch_size: int | None = None) -> dict:
        args = self.args
        data_cfg = data if isinstance(data, dict) else check_cls_dataset(data or args.data)
        bs = int(batch_size or args.batch or 16)
        if self._loader is None:
            split = data_cfg.get(args.split or "val") or data_cfg["val"]
            ds = ClassificationDataset(split, imgsz=int(args.imgsz), names=data_cfg["names"],
                                       cache=getattr(args, "cache", False))
            self._loader = ClassifyLoader(ds, bs, shuffle=False)
        net = for_precision(model, bool(args.half))
        was_training = net.training
        net.eval()
        correct1 = correct5 = seen = 0
        t_pre = t_inf = 0.0
        try:
            for batch in self._loader:
                t0 = time.perf_counter()
                img = torch.from_numpy(batch["img"])
                t1 = time.perf_counter()
                topk = self.infer(net, img).cpu().numpy()
                t_pre, t_inf = t_pre + t1 - t0, t_inf + time.perf_counter() - t1
                labels = batch["cls"]
                for i in range(batch["n_real"]):
                    seen += 1
                    correct1 += int(topk[i, 0] == labels[i])
                    correct5 += int(labels[i] in topk[i])
        finally:
            if was_training:
                net.train()
        top1, top5 = correct1 / max(seen, 1), correct5 / max(seen, 1)
        self.seen = seen
        self.speed = {"preprocess": t_pre / max(seen, 1) * 1e3,
                      "inference": t_inf / max(seen, 1) * 1e3, "postprocess": 0.0}
        self.metrics = {"metrics/accuracy_top1": top1, "metrics/accuracy_top5": top5,
                        "fitness": (top1 + top5) / 2}
        LOGGER.info(self.results_line())
        return self.metrics

    def results_line(self) -> str:
        m = self.metrics
        return (f"{'all':>10}{self.seen:>8}{m['metrics/accuracy_top1']:>11.3g}"
                f"{m['metrics/accuracy_top5']:>11.3g}")


class ClassificationPredictor:
    """`predictor(images)` -> probs (B, nc) f32; `predictor.predict(source)` -> [Results]."""

    def __init__(self, model, device=None, imgsz: int = 224, batch: int = 1,
                 verbose: bool = False, vid_stride: int = 1, stream_buffer: bool = False):
        self.device = select_device(device)
        self.model = model.to(self.device).eval()
        self.imgsz, self.batch = int(imgsz), max(1, int(batch or 1))
        self.verbose = verbose
        self.vid_stride, self.stream_buffer = max(1, int(vid_stride or 1)), stream_buffer

    @torch.inference_mode()
    def __call__(self, images_u8_nhwc) -> torch.Tensor:
        return self.model(_to_input(self.model, images_u8_nhwc, self.device)).float().softmax(-1)

    def _run_batch(self, frames, names: dict):
        n_real = len(frames)
        imgs = [f[2] for f in frames] + [frames[-1][2]] * (self.batch - n_real)
        t1 = time.perf_counter()
        probs = self(np.stack(imgs)).cpu().numpy()
        infer_ms = (time.perf_counter() - t1) * 1e3 / n_real
        for i, (path, img0, _img, pre_ms) in enumerate(frames):
            res = Results(img0, path, names, probs=probs[i],
                          speed={"preprocess": pre_ms, "inference": infer_ms,
                                 "postprocess": 0.0})
            if self.verbose:
                top = res.probs.top1
                LOGGER.info(f"{path}: {names.get(top, top)} {probs[i, top]:.3f}")
            yield res

    def stream(self, source):
        """Results with probs, one per frame of `source`."""
        names = getattr(self.model, "names", None) or {i: str(i) for i in range(self.model.nc)}
        loader, _ = load_inference_source(source, vid_stride=self.vid_stride,
                                          stream_buffer=self.stream_buffer)
        buf = []
        for path, img0 in loader:
            t0 = time.perf_counter()
            img = resize_center_crop(img0, self.imgsz)
            buf.append((path, img0, img, (time.perf_counter() - t0) * 1e3))
            if len(buf) == self.batch:
                yield from self._run_batch(buf, names)
                buf = []
        if buf:
            yield from self._run_batch(buf, names)

    def predict(self, source) -> list[Results]:
        return list(self.stream(source))
