"""edgeyolo_tpu_torch: the PyTorch/CUDA port of edgeyolo_tpu for one NVIDIA H100.

The JAX package `edgeyolo_tpu` is the reference this port is held against;
the port imports nothing of it and no JAX. Hand-written CUDA kernels live in
`csrc/` and are built with nvcc on first use (ops/_build.py).
"""

__version__ = "0.1.0"


def __getattr__(name: str):
    """The facades, imported on first use: YOLO; RTDETR and YOLOWorld (JAX's
    names for YOLO over an RT-DETR model, rtdetr-l by default, and over a
    YOLO-World model, yolov8-worldv2 by default); SAM, FastSAM and NAS (SAM2 and
    SAM2VideoPredictor come from engine/sam2.py, as JAX's do)."""
    if name in ("YOLO", "RTDETR", "YOLOWorld"):
        from edgeyolo_tpu_torch.engine import model

        return getattr(model, name)
    if name == "SAM":
        from edgeyolo_tpu_torch.engine.sam import SAM

        return SAM
    if name == "NAS":
        from edgeyolo_tpu_torch.engine.nas import NAS

        return NAS
    if name == "FastSAM":
        from edgeyolo_tpu_torch.engine.fastsam import FastSAM

        return FastSAM
    raise AttributeError(f"module 'edgeyolo_tpu_torch' has no attribute '{name}'")
