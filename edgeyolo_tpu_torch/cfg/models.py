"""Model specs as Python literals, so the port needs no YAML reader.

EDGELINE_YOLO is edgeyolo_tpu/cfg/models/edgeline-yolo.yaml transcribed:
[from, repeats, module, args] rows, compound scales [depth, width,
max_channels]. The reference fork's scale n has 2,678,699 parameters.
"""

from __future__ import annotations

import copy
import re

EDGELINE_YOLO = {
    "nc": 80,
    "scales": {  # [depth, width, max_channels]
        "n": (0.50, 0.25, 1024),
        "s": (0.50, 0.50, 1024),
        "m": (0.50, 1.00, 512),
        "l": (1.00, 1.00, 512),
        "x": (1.00, 1.50, 512),
    },
    "backbone": [
        [-1, 1, "Conv", [64, 3, 2]],  # 0 P1/2
        [-1, 1, "Conv", [128, 3, 2]],  # 1 P2/4
        [-1, 2, "DSC3K2_Wavelet", [256, False, 0.25]],
        [-1, 1, "Conv", [256, 3, 2]],  # 3 P3/8
        [-1, 2, "DSC3K2_Wavelet", [512, False, 0.25]],
        [-1, 1, "Conv", [512, 3, 2]],  # 5 P4/16
        [-1, 2, "DSC3K2_Wavelet", [512, True]],
        [-1, 1, "Conv", [1024, 3, 2]],  # 7 P5/32
        [-1, 2, "DSC3K2_Wavelet", [1024, True]],
        [-1, 1, "SPPF", [1024, 5]],  # 9
        [-1, 2, "C2PSA_LinearAttention", [1024]],  # 10
    ],
    "head": [
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 2, "DSC3K2_Wavelet", [512, False]],  # 13
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 2, "DSC3K2_Wavelet", [256, False]],  # 16 P3/8 out
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 13], 1, "Concat", [1]],
        [-1, 2, "DSC3K2_Wavelet", [512, False]],  # 19 P4/16 out
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 2, "DSC3K2_Wavelet", [1024, True]],  # 22 P5/32 out
        [[16, 19, 22], 1, "GFLHeadv2_uniH", ["nc"]],  # 23
    ],
}

MODELS = {"edgeline-yolo": EDGELINE_YOLO}


def model_cfg(name: str, scale: str | None = None) -> dict:
    """The spec for a model name, with its scale resolved.

    "edgeline-yolo-n", "edgeline-yolon.yaml" or "edgeline-yolo.yaml" with
    scale="n" all give scale n; with no scale anywhere the first entry of the
    scales table is used, as the JAX package does.
    """
    stem = re.sub(r"\.ya?ml$", "", str(name).rsplit("/", 1)[-1])
    base, named = stem, ""
    if stem not in MODELS:
        m = re.match(r"^(.*?)-?([nslmx])$", stem)
        if not m or m.group(1) not in MODELS:
            raise KeyError(f"unknown model '{name}'; known: {sorted(MODELS)}")
        base, named = m.groups()
    if scale and named and scale != named:
        raise ValueError(f"model '{name}' names scale {named}, but scale={scale!r} was passed")
    d = copy.deepcopy(MODELS[base])
    d["scale"] = scale or named or next(iter(d["scales"]))
    if d["scale"] not in d["scales"]:
        raise KeyError(f"unknown scale '{d['scale']}' for {base}; known: {sorted(d['scales'])}")
    return d
