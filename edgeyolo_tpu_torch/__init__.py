"""edgeyolo_tpu_torch: the PyTorch/CUDA port of edgeyolo_tpu for one NVIDIA H100.

The JAX package `edgeyolo_tpu` is the reference this port is held against;
the port imports nothing of it and no JAX. Hand-written CUDA kernels live in
`csrc/` and are built with nvcc on first use (ops/_build.py).
"""

__version__ = "0.1.0"


def __getattr__(name: str):
    """The facades, imported on first use: YOLO, and RTDETR (JAX's name for
    YOLO over an RT-DETR model, rtdetr-l by default)."""
    if name in ("YOLO", "RTDETR"):
        from edgeyolo_tpu_torch.engine import model

        return getattr(model, name)
    raise AttributeError(f"module 'edgeyolo_tpu_torch' has no attribute '{name}'")
