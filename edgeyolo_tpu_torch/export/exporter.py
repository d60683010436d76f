"""Model export: a torch.export program, npz weights and ONNX (edgeyolo_tpu/export/exporter.py).

JAX's native formats are StableHLO text and a serialized `jax.export`
program. The port's native format is a `torch.export` program saved with
`torch.export.save` (`<name>.pt2`), with a symbolic batch dimension, or a
static batch of 1 where an op refuses it. `torch_export` writes it; the
JAX format names `stablehlo` (the cfg default) and `jax_export` write the
same artifact, and `stablehlo` also writes the printed ATen graph beside it
(`<name>.aten`, for inspection; AutoBackend runs its `.pt2` twin), as JAX
writes StableHLO text beside its executable twin. The program carries the
registered linear-attention op (ops/linear_attention.py): a process that
loads it must `import edgeyolo_tpu_torch` first, and on the card it launches
the CUDA kernel.

`npz` writes the fused model's state_dict; `onnx` goes through the in-tree
ATen -> ModelProto bridge (torch2onnx.py: no onnx package) at a static
batch. The TF-family formats need tensorflow and a torch -> TF bridge that
the port does not have; `pb`, `tfjs` and `edgetpu` toolchains neither.

Every format folds conv and BatchNorm pairs in f32 on a deep copy first
(the caller's model stays unfused), exports in f32 at a square `imgsz` (a
list's long side) and batch `trace_batch` (default 1, never `args.batch`),
and writes the metadata JAX writes (NCHW layout) into a `.json` sidecar,
and for ONNX also into `metadata_props` and the graph's doc_string.
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from edgeyolo_tpu_torch.utils import LOGGER

_TF_FORMATS = ("saved_model", "tflite")
EXPORT_FORMATS = {
    # name: (suffix, available)
    "torch_export": (".pt2", True),
    "stablehlo": (".aten", True),  # the .pt2 and its printed ATen graph
    "jax_export": (".pt2", True),
    "npz": (".npz", True),
    "saved_model": ("_saved_model", False),  # no torch -> TF bridge in the port
    "tflite": (".tflite", False),
    "onnx": (".onnx", True),  # in-tree ATen -> ModelProto bridge (torch2onnx.py)
}


def format_available(fmt: str) -> bool:
    return bool(EXPORT_FORMATS.get(fmt, (None, False))[1])


def try_export(fn):
    """Log a format's export seconds (kept on `Exporter.seconds`), or its failure."""

    def wrapper(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            out = fn(self, *args, **kwargs)
        except Exception as e:
            LOGGER.warning(f"export: {fn.__name__} FAILED: {e}")
            raise
        self.seconds = time.perf_counter() - t
        LOGGER.info(f"export: {fn.__name__} done in {self.seconds:.1f}s -> {out}")
        return out

    return wrapper


class _Pred(nn.Module):
    """The exported function: the model's `pred` for NCHW f32 images."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images):
        out = self.model(images)
        if not isinstance(out, dict):  # JAX's exporter fails on it too: no "pred" to take
            raise TypeError(f"a {self.model.task} model's forward returns no 'pred' to export")
        return out["pred"]


def export_meta(model, imgsz: int) -> dict:
    """The sidecar's metadata (JAX's keys, NCHW layout, and the pose head's kpt_shape)."""
    meta = {
        "description": "edgeyolo_tpu_torch export",
        "imgsz": imgsz,
        "nc": model.nc,
        "names": model.names,
        "stride": [int(s) for s in getattr(model.model[-1], "stride", (32,))],
        "layout": "NCHW",
        "pred": "(B, A, 4+nc) xywh pixels + class probs",
        "model_yaml": str(model.cfg) if isinstance(model.cfg, (str, Path)) else "",
        "scale": model.scale,
        "task": model.task,
        "kpt_shape": list(model.kpt_shape) if model.kpt_shape else None,
    }
    if not meta["model_yaml"]:  # dict-built: embed the spec
        meta["model_cfg"] = {k: v for k, v in model.cfg.items()
                             if isinstance(v, (int, float, str, bool, list, dict, type(None)))}
    return meta


class Exporter:
    """`Exporter(args)(model, out_dir)` -> the artifact's path; `args.format`
    names the format (EXPORT_FORMATS), `args.imgsz` the size."""

    def __init__(self, args):
        self.args = args
        self.trace_batch = 1
        self.seconds = None

    def __call__(self, model, out_dir: str | Path = "runs/export"):
        fmt = str(self.args.format or "stablehlo").lower()
        if fmt in ("pb", "tfjs", "edgetpu"):
            raise NotImplementedError(
                f"'{fmt}' requires toolchains absent from this image (tfjs converter / "
                "edgetpu compiler); export 'saved_model' or 'tflite' and convert externally")
        if fmt in _TF_FORMATS:
            raise NotImplementedError(
                f"'{fmt}' export requires tensorflow and a torch -> TF bridge, which the port "
                "does not have")
        if fmt not in EXPORT_FORMATS and fmt != "jaxexp":
            raise ValueError(f"unknown export format '{fmt}'; supported: {list(EXPORT_FORMATS)}")
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        raw = self.args.imgsz
        imgsz = int(max(raw)) if isinstance(raw, (list, tuple)) else int(raw)
        batch = max(1, int(self.trace_batch or 1))
        name = Path(model.cfg).stem if isinstance(model.cfg, (str, Path)) else "model"
        meta = export_meta(model, imgsz)
        # fold in f32 on a copy; the caller's model stays as it is
        fused = copy.deepcopy(model).set_dtype(torch.float32).fuse().eval()
        if fmt == "npz":
            return self.export_npz(fused, out_dir / f"{name}.npz", meta)
        if fmt == "onnx":
            return self.export_onnx(fused.cpu(), batch, imgsz, out_dir / f"{name}.onnx", meta)
        return self.export_native(fused, batch, imgsz, out_dir / name, meta,
                                  text=fmt == "stablehlo")

    @staticmethod
    def _export_program(fused, batch: int, imgsz: int):
        """torch.export with a symbolic batch dimension, so the program serves
        any batch; a static batch of 1 if some op refuses it."""
        fn = _Pred(fused)
        x = torch.zeros(max(2, batch), 3, imgsz, imgsz,  # a batch of 1 would specialise
                        device=next(fused.parameters()).device)
        try:
            return torch.export.export(fn, (x,), dynamic_shapes={
                "images": {0: torch.export.Dim("batch", min=1, max=4096)}})
        except TypeError:
            raise
        except Exception as e:
            LOGGER.warning(f"export: symbolic-batch export failed ({e}); falling back to "
                           "static batch=1")
            return torch.export.export(fn, (x[:1],))

    @try_export
    def export_native(self, fused, batch: int, imgsz: int, stem: Path, meta: dict,
                      text: bool = False):
        ep = self._export_program(fused, batch, imgsz)
        path = stem.with_suffix(".pt2")
        torch.export.save(ep, path)
        path.with_suffix(".json").write_text(json.dumps(meta, default=str))
        if not text:
            return str(path)
        aten = stem.with_suffix(".aten")
        aten.write_text(str(ep))
        return str(aten)

    @try_export
    def export_onnx(self, fused, batch: int, imgsz: int, path: Path, meta: dict):
        """Standard ONNX ModelProto (opset 17) through torch2onnx.py at a static
        batch; the metadata in `metadata_props`, the doc_string and the sidecar."""
        from edgeyolo_tpu_torch.export.torch2onnx import export_onnx_bytes

        x = torch.zeros(batch, 3, imgsz, imgsz)
        ep = torch.export.export(_Pred(fused), (x,))
        doc = json.dumps(meta, default=str)
        blob = export_onnx_bytes(ep, input_names=["images"], output_prefix="output",
                                 graph_name=path.stem, doc=doc,
                                 metadata={k: json.dumps(v, default=str) for k, v in meta.items()})
        path.write_bytes(blob)
        path.with_suffix(".json").write_text(doc)
        return str(path)

    @try_export
    def export_npz(self, fused, path: Path, meta: dict):
        """The fused model's state_dict (the port's keys) as numpy arrays."""
        np.savez(path, **{k: v.detach().cpu().numpy() for k, v in fused.state_dict().items()})
        path.with_suffix(".json").write_text(json.dumps({**meta, "fused": True}, default=str))
        return str(path)


def load_exported(path: str | Path, device: str | torch.device | None = None):
    """A saved .pt2 program as a callable module on `device` (its own by default)."""
    import edgeyolo_tpu_torch.ops.linear_attention  # noqa: F401  (registers the op)

    ep = torch.export.load(str(path))
    if device is not None:
        ep = _to_device(ep, torch.device(device))
    return ep.module()


def _to_device(ep, device: torch.device):
    params = list(ep.state_dict.values())
    if params and params[0].device != device:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, device)
    return ep
