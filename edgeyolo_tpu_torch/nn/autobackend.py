"""AutoBackend: one `__call__(images) -> pred` over every artifact the port
exports or loads (edgeyolo_tpu/nn/autobackend.py).

    - a live model (nn/tasks.py::DetectionModel)
    - a port checkpoint            .pt   (train/trainer.py, YOLO.save)
    - a torch.export program       .pt2  (export/exporter.py; `.aten` is its
                                          printed graph, run through its .pt2 twin)
    - weights                      .npz  the port's own (state_dict keys), or
                                          JAX's (flax paths `coll/a/b/...`,
                                          through utils/convert.py)
    - ONNX                         .onnx run by the in-tree numpy executor
                                          (export/onnx_runtime.py)

Metadata (names, stride, imgsz, the model to rebuild for an npz) comes from
the `.json` sidecar, or for ONNX from its doc_string when the sidecar is
gone. Images are NCHW floats in [0, 1]; an exported program or ONNX file is
dtype-exact, so they are cast to the f32 it was traced at. The backend runs
on CUDA unless `device` names another device. A `.pt2` holds the registered
linear-attention op: this module imports it, so on the card the loaded
program launches the CUDA kernel. TF-family artifacts need tensorflow,
which is probed, never assumed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from edgeyolo_tpu_torch.ops import linear_attention  # noqa: F401  (registers the op)
from edgeyolo_tpu_torch.utils import LOGGER, select_device

_TASK_NAMES = {"detect", "segment", "pose", "obb", "classify"}


def _refuse_tf(fmt: str):
    """TF-family artifacts: tensorflow is probed, never assumed, and the port
    has no torch -> TF bridge to run them with."""
    import importlib.util

    why = ("tensorflow is not importable" if importlib.util.find_spec("tensorflow") is None
           else "the port has no torch -> TF bridge")
    raise NotImplementedError(f"{fmt} inference requires tensorflow: {why}")


def build_from_meta(meta: dict, task: str | None, device) -> nn.Module:
    """The model an npz's metadata describes (its YAML or spec, scale, nc and
    keypoints), seeded, on `device`; its task is its head's. A JAX sidecar
    names JAX's YAML file: the port's byte-identical copy of that name is built."""
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel

    if meta.get("model_cfg"):
        cfg = dict(meta["model_cfg"])
    else:
        cfg = Path(meta.get("model_yaml") or "yolo11n.yaml").name
    model = DetectionModel(cfg, scale=meta.get("scale") or None, nc=meta.get("nc"),
                           kpt_shape=meta.get("kpt_shape"), device=device)
    if task not in (None, model.task):
        raise ValueError(f"the npz holds a {model.task} model, not a {task} one")
    return model


def load_npz(model: nn.Module, path: Path) -> nn.Module:
    """Weights of an npz into `model`. The port's own (state_dict keys of a
    fused model) load into the model fused first, every tensor. JAX's (flax
    `coll/path` keys, through `from_jax_variables`) are its fused variables:
    each folded BatchNorm kept as an affine of mean 0 and var 1 - eps beside its
    conv, which is the unfused model's form; they load into it as they are,
    every tensor but the DFL bins, which JAX computes instead of storing."""
    from edgeyolo_tpu_torch.utils.convert import from_jax_variables

    blobs = dict(np.load(path))
    if any("/" in k for k in blobs):
        sd = from_jax_variables({tuple(k.split("/")): v for k, v in blobs.items()})
    else:
        model.fuse()
        sd = {k: torch.from_numpy(v) for k, v in blobs.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith(("dfl.conv.weight", "num_batches_tracked"))]
    if missing or unexpected:
        raise KeyError(f"npz {path}: missing {missing[:8]}, unexpected {unexpected[:8]}")
    return model.eval()


class AutoBackend:
    """Load any supported artifact and expose `__call__(images) -> pred`."""

    def __init__(self, weights, task: str | None = None, device=None):
        self.task = task or "detect"
        self.kind = None
        self.names = {}
        self.stride = (8, 16, 32)
        self.imgsz = 640
        self.end2end = False

        if isinstance(weights, nn.Module):
            self.kind = "module"
            self.model = weights
            self.device = next(weights.parameters()).device
            self.names = getattr(weights, "names", {})
            self.stride = tuple(getattr(weights.model[-1], "stride", self.stride))
            self.task = getattr(weights, "task", self.task)
            self.end2end = bool(getattr(weights, "end2end", False))
            return

        self.device = select_device(device)
        p = Path(str(weights))
        suffix = p.suffix.lower()
        meta_p = p.with_suffix(".json")
        meta = json.loads(meta_p.read_text()) if meta_p.exists() else {}

        if suffix == ".pt":
            from edgeyolo_tpu_torch.engine.model import YOLO

            self.kind = "checkpoint"
            y = YOLO(str(p), task=task, device=self.device)
            self.model = y.model.eval()
            meta = {"names": self.model.names,
                    "stride": list(getattr(self.model.model[-1], "stride", self.stride)),
                    "task": y.task, **{k: v for k, v in meta.items() if k == "imgsz"}}
        elif suffix in (".pt2", ".aten"):
            from edgeyolo_tpu_torch.export.exporter import load_exported

            twin = p.with_suffix(".pt2")
            if not twin.exists():
                raise FileNotFoundError(f"the ATen graph is for inspection; run its twin {twin}")
            self.kind = "torch_export"
            self._program = load_exported(twin, self.device)
        elif suffix == ".npz":
            self.kind = "npz"
            self.model = load_npz(build_from_meta(meta, task, self.device), p)
        elif suffix == ".onnx":
            from edgeyolo_tpu_torch.export.onnx_runtime import OnnxModel

            self.kind = "onnx"
            self._onnx = OnnxModel(p.read_bytes())
            if not meta and self._onnx.doc:  # the metadata rides the doc_string
                try:
                    meta = json.loads(self._onnx.doc)
                except ValueError:
                    meta = {}
        elif suffix == ".tflite" or (p.is_dir() and (p / "saved_model.pb").exists()):
            _refuse_tf("tflite" if suffix == ".tflite" else "saved_model")
        else:
            raise ValueError(f"unsupported weights format: {weights}")

        self.names = {int(k): v for k, v in (meta.get("names") or {}).items()}
        self.imgsz = int(meta.get("imgsz", 640))
        if meta.get("stride"):
            self.stride = tuple(meta["stride"])
        if meta.get("task") in _TASK_NAMES:
            self.task = task or meta["task"]
        if hasattr(self, "model"):
            self.end2end = bool(getattr(self.model, "end2end", False))

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, 3, H, W) floats in [0, 1]. Returns the raw pred tensor."""
        if self.kind == "onnx":
            out = self._onnx(np.ascontiguousarray(images.float().cpu().numpy()))
            return torch.from_numpy(out[0] if isinstance(out, list) else out).to(self.device)
        if self.kind == "torch_export":
            return self._program(images.to(self.device, torch.float32))
        x = images.to(self.device, getattr(self.model, "dtype", torch.float32))
        out = self.model(x)
        return out["pred"] if isinstance(out, dict) else out

    def warmup(self, imgsz: int | None = None, batch: int = 1):
        s = imgsz or self.imgsz
        self(torch.zeros(batch, 3, s, s, device=self.device))
        LOGGER.info(f"AutoBackend({self.kind}) warmed at {s}px")
        return self
