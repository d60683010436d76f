"""Format x (latency, imgs/s [, mAP50-95]) table and per-layer timing
(edgeyolo_tpu/utils/benchmarks.py).

`benchmark` exports the model to each format, reloads it through
AutoBackend and times the end-to-end pipeline on one batch of random uint8
images (upload, /255 in f32, forward, NMS; on CUDA synchronised around the
timed calls); with `data=` it validates each artifact too, the batch then
at least 8, through a backend adapter that gives the validator only `pred`
(the network runs through the artifact, the NMS and matching are the
validator's own). Rows: `native` (the model as it is), `native-int8` (the
model's int8 forward, nn/quant.py, calibrated on up to 8 real val images
when `data` is given, else on the timed batch; validated with int8 on, and
the model back in full precision after the row) and every format of
EXPORT_FORMATS; a format that cannot run here reports `gated ...`, a
failure `error: ...`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from edgeyolo_tpu_torch.utils import LOGGER


class _BackendAdapter:
    """An AutoBackend artifact through the surface the validator drives:
    `adapter(x)["pred"]`, `nc`, `names`, `end2end`."""

    def __init__(self, backend, nc: int, names: dict):
        self._b = backend
        self.nc = nc
        self.names = names
        self.end2end = backend.end2end

    def __call__(self, x: torch.Tensor) -> dict:
        return {"pred": self._b(x)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, img, iters: int, device: torch.device) -> tuple[float, float]:
    """(first call s, mean s of `iters` calls after it)."""
    t0 = time.perf_counter()
    fn(img)
    _sync(device)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(img)
    _sync(device)
    return first, (time.perf_counter() - t0) / iters


def benchmark(model, imgsz: int = 640, batch: int = 1, iters: int = 30, data=None,
              verbose: bool = True, formats=None, out_dir="runs/export_bench") -> list[dict]:
    """The table for a YOLO facade `model`, on its device: one row a format."""
    from edgeyolo_tpu_torch.cfg import get_cfg
    from edgeyolo_tpu_torch.engine.model import task_class
    from edgeyolo_tpu_torch.engine.predictor import e2e_detections
    from edgeyolo_tpu_torch.export.exporter import EXPORT_FORMATS, Exporter, format_available
    from edgeyolo_tpu_torch.nn.autobackend import AutoBackend
    from edgeyolo_tpu_torch.ops.nms import non_max_suppression

    handle, task, device = model.model.eval(), model.task, model.device
    nc = handle.nc
    # one batch for everything (latency, the static-shape ONNX export, val at >= 8)
    if data is not None:
        batch = max(batch, 8)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randint(0, 255, (batch, imgsz, imgsz, 3), dtype=np.uint8))

    def post(pred):
        if handle.end2end:
            return e2e_detections(pred, 0.25, 300)
        # seg/pose preds append mask-coefficient / keypoint channels after the classes
        return non_max_suppression(pred[..., :4 + nc].float(), conf_thres=0.25, iou_thres=0.7,
                                   max_det=300, max_nms=4096, multi_label=False)

    def make_pipeline(apply_fn):
        @torch.inference_mode()
        def pipeline(img_u8):
            x = img_u8.to(device).permute(0, 3, 1, 2).float() / 255.0
            return post(apply_fn(x))

        return pipeline

    def val_map(m_handle, int8: bool = False):
        # the model validates through its task's validator; an adapter gives only
        # pred, the detect surface. The validator's int8 flag decides for its call
        # (it stashes an active calibration otherwise), so the int8 row says so.
        vcls = task_class(task if m_handle is handle else "detect", 0)
        vargs = get_cfg(overrides={"mode": "val", "data": data, "imgsz": imgsz,
                                   "batch": max(batch, 8), "plots": False, "task": task,
                                   "int8": int8})
        res = vcls(vargs, save_dir=f"{out_dir}/val", device=device)(m_handle, data=data)
        return round(res.get("metrics/mAP50-95(B)", 0.0), 4)

    fmts = formats or ["native", "native-int8", *EXPORT_FORMATS]
    rows = []
    for fmt in fmts:
        if fmt not in ("native", "native-int8") and not format_available(fmt):
            rows.append({"format": fmt, "status": "gated (backend not in image)"})
            continue
        try:
            if fmt in ("native", "native-int8"):
                if fmt == "native-int8":
                    handle.quantize(calibration_batch(handle, img, data, imgsz, device))
                apply_fn, m_for_val = (lambda x: handle(x.to(handle.dtype))["pred"]), handle
            else:
                ex = Exporter(get_cfg(overrides={"mode": "export", "imgsz": imgsz,
                                                 "format": fmt}))
                ex.trace_batch = batch  # the static-shape ONNX graph serves the val batch
                ab = AutoBackend(ex(handle, out_dir=out_dir), task=task, device=device)
                apply_fn, m_for_val = ab, _BackendAdapter(ab, nc, handle.names)
            first, dt = _time_fn(make_pipeline(apply_fn), img, iters, device)
            ms = dt / batch * 1000
            row = {"format": fmt, "status": "ok", "compile_s": round(first, 1),
                   "ms/img": round(ms, 3), "imgs/s": round(1000 / ms, 1)}
            if data is not None:
                row["mAP50-95"] = (val_map(m_for_val, int8=fmt == "native-int8")
                                   if task == "detect" or fmt.startswith("native")
                                   else "n/a (task)")  # adapters give the validator pred only
            rows.append(row)
        except Exception as e:
            rows.append({"format": fmt, "status": f"error: {str(e)[:60]}"})
        finally:
            if fmt == "native-int8":
                handle.quant = None  # later rows run full precision

    if verbose:
        hdr = f"{'format':<14}{'status':<28}{'ms/img':>10}{'imgs/s':>10}" + (
            f"{'mAP50-95':>10}" if data is not None else "")
        LOGGER.info(f"benchmarks: imgsz={imgsz} batch={batch}\n" + hdr)
        for r in rows:
            LOGGER.info(f"{r['format']:<14}{r['status']:<28}{r.get('ms/img', ''):>10}"
                        f"{r.get('imgs/s', ''):>10}"
                        + (f"{r.get('mAP50-95', ''):>10}" if data is not None else ""))
    return rows


def calibration_batch(handle, img: torch.Tensor, data, imgsz: int,
                      device: torch.device) -> torch.Tensor:
    """The int8 row's calibration input, model-space NCHW on `device`: up to 8
    real val images when `data` is given (random images misrange the
    activation scales), else the timed batch `img`."""
    if data is not None:
        from edgeyolo_tpu_torch.data.dataset import (YOLODataset, build_dataloader,
                                                     check_det_dataset)

        cfg = check_det_dataset(str(data))
        val = YOLODataset(cfg["val"], imgsz=imgsz, augment=False, names=cfg["names"])
        img = torch.from_numpy(build_dataloader(val, min(8, len(val)), shuffle=False,
                                                seed=0).first_batch()["img"])
    return (img.to(device).permute(0, 3, 1, 2).float() / 255.0).to(handle.dtype)


def profile_layers(model, imgsz: int = 640, iters: int = 10) -> list[dict]:
    """Each layer's ms in one forward of a (1, 3, imgsz, imgsz) zero image,
    averaged over `iters` forwards (a forward hook pair around each layer,
    synchronised on CUDA), and the running sum: rows {layer, i, cum_ms,
    delta_ms}, as JAX's truncated-graph rows."""
    handle = model.model if hasattr(model, "model") and not isinstance(
        model, torch.nn.Module) else model
    device = next(handle.parameters()).device
    x = torch.zeros(1, 3, imgsz, imgsz, device=device, dtype=handle.dtype)
    spent = [0.0] * len(handle.model)
    starts = {}

    def pre(i):
        def hook(_m, _inp):
            _sync(device)
            starts[i] = time.perf_counter()
        return hook

    def post(i):
        def hook(_m, _inp, _out):
            _sync(device)
            spent[i] += time.perf_counter() - starts[i]
        return hook

    handles = [h for i, m in enumerate(handle.model)
               for h in (m.register_forward_pre_hook(pre(i)), m.register_forward_hook(post(i)))]
    try:
        with torch.inference_mode():
            handle(x)  # warm-up, not counted
            spent[:] = [0.0] * len(spent)
            for _ in range(iters):
                handle(x)
    finally:
        for h in handles:
            h.remove()
    rows, cum = [], 0.0
    for i, sp in enumerate(handle.layers):
        delta = spent[i] / iters * 1000
        cum += delta
        rows.append({"layer": sp.name, "i": i, "cum_ms": round(cum, 3), "delta_ms": round(delta, 3)})
    return rows
