"""The registry test graph: every registry row that no bundled YAML uses, in
one detector (nc 80, scale n), for tests/test_torch_registry_graph.py and
chip_smoke.py's `registry` phase.

At scale n it has 29 layers, strides (8, 16, 32) and 3,204,396 parameters
in JAX (the port stores 16 more: the frozen DFL bins). At 640 px its layer
13 runs the linear-attention kernel at (32, 400, 2, 64) for a batch of 32,
and its MSLA row (layer 9, head dim 16, 1,600 tokens) at (128, 1600, 2, 16):
the four channel quarters go through as one batch.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SPEC = {
    "nc": 80,
    "scales": {"n": [0.50, 0.25, 1024]},
    "backbone": [
        [-1, 1, "Focus", [64, 3]],  # 0
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 2, "C3k2_Wavelet", [256, False, 0.25]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 2, "C3k2_TWavelet", [512, False, 0.25]],
        [-1, 1, "MulGate", [512]],  # 5
        [-1, 1, "Conv", [512, 3, 2]],
        [-1, 2, "C3x", [512, True]],
        [-1, 1, "RHJM", [512]],
        [-1, 1, "MSLA", [128, 2]],
        [-1, 1, "Conv", [1024, 3, 2]],  # 10
        [-1, 2, "BottleneckCSP", [1024, True]],
        [-1, 1, "SPPF_Wavelet", [1024, 5]],
        [-1, 2, "C2PSA_LinearAttention", [1024]],
    ],
    "head": [
        [-1, 1, "DySample", [2, "lp", 4]],  # 14
        [[-1, 9], 1, "Concat", [1]],
        [-1, 2, "C1", [512]],
        [-1, 1, "ConvTranspose", [256, 2, 2]],
        [[-1, 5], 1, "Concat", [1]],
        [-1, 1, "CBAM", [192, 7]],
        [-1, 2, "C3k2_Wavelet", [256, False]],  # 20
        [-1, 1, "WTConv2d", [64, 5, 1, True, 2, "db1"]],
        [-1, 1, "Conv", [256, 3, 2, None, 1, 1, "telu"]],
        [[-1, 16], 1, "Concat", [1]],
        [-1, 2, "DSC3K2_Wavelet", [512, False]],
        [-1, 1, "Conv", [512, 3, 2]],  # 25
        [[-1, 13], 1, "Concat", [1]],
        [-1, 2, "DSC3K2_Wavelet", [1024, True]],
        [[21, 24, 27], 1, "GFLHeadv2_uniH", ["nc"]],
    ],
}
JAX_PARAMS = 3_204_396


def random_leaf(rs: np.random.RandomState, path: tuple, shape: tuple, scale: float) -> np.ndarray:
    """A JAX variable at random for the port-against-JAX tests: kernels
    U(+-1/sqrt(fan_in)) times `scale`, the zero-init gates opened and AGLU's
    scalars in (0.3, 0.8), the wavelet band weights moved, BatchNorm
    statistics, scales, shifts and learned scales away from their init."""
    leaf = path[-1]
    if leaf == "kernel":  # conv HWIO or dense (in, out): fan_in is all but the last axis
        bound = float(np.prod(shape[:-1])) ** -0.5
        return rs.uniform(-bound, bound, shape) * scale
    if leaf in ("gamma", "gate", "lambd", "kappa"):
        return rs.uniform(0.3, 0.8, shape)
    if leaf == "alpha":
        return np.array([0.5, 0.2, 0.2, 0.1]) + rs.uniform(-0.3, 0.3, shape)
    if leaf == "var":
        return rs.uniform(0.5, 1.5, shape)
    if leaf in ("scale", "weight", "scale_weights"):  # BatchNorm scales, learned scales
        return 1.0 + rs.randn(*shape) * 0.1
    if leaf in ("bias", "mean"):
        return rs.randn(*shape) * 0.1
    raise KeyError(f"no fill for {'/'.join(path)}")


def _yaml_value(v) -> str:
    if isinstance(v, list):
        return "[" + ", ".join(_yaml_value(a) for a in v) + "]"
    return "None" if v is None else str(v)


def write_yaml(path: str | Path) -> Path:
    """SPEC as a model YAML file, which both packages' facades read."""
    lines = [f"nc: {SPEC['nc']}", "scales:"]
    lines += [f"  {k}: {_yaml_value(v)}" for k, v in SPEC["scales"].items()]
    for part in ("backbone", "head"):
        lines.append(f"{part}:")
        lines += [f"  - {_yaml_value(row)}" for row in SPEC[part]]
    path = Path(path)
    path.write_text("\n".join(lines) + "\n")
    return path
