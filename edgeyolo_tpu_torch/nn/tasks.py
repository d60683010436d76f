"""Model spec -> PyTorch graph, and the detection model (edgeyolo_tpu/nn/tasks.py).

`parse_spec` applies the reference parse_model's compound scaling to a spec
dict (depth n' = max(round(n*depth), 1) for n > 1; width c2' =
make_divisible(min(c2, max_channels)*width, 8) unless c2 == nc; the CSP
family takes its repeats as an argument; the C3k2 family forces c3k at
scales l and x, A2C2f its residual and mlp_ratio 1.5; HyperACE and its
wavelet variants take c1 from their second input and scale their hyperedges
by 0.5 at n and 1.5 at x; DownsampleConv doubles its channels below l; heads
get the per-level input channels, and an end-to-end head always the DWConv
cls tower) into a tuple of `LayerSpec`s. `GraphNet` builds one module per
spec under `model.{i}`, the reference state_dict layout, and walks them in
order.

A module with n > 1 outside the CSP set that takes its repeats as an
argument is built as n copies in an nn.Sequential (`model.{i}.{j}`), as the
reference and JAX's `l{i}_{Type}_{j}` do. A YAML's `activation:` (yolov6's
ReLU) becomes the `act` of its Conv lines and the activation every `act=True`
conv of the model builds to (`default_act`), as in JAX.

The modules of EdgeLine-YOLO, the YOLO11 ablation family, the YOLOv13
family (MSLA, LGL, the wavelet HyperACE and the NMS-free E2E quality head),
YOLOv10 (SCDown, PSA, C2fCIB, v10Detect), YOLOv12, YOLOv3/5/6/8 and their
P2/P6/Ghost variants (C2, SPP, Ghost blocks, pooling, padding and
transposed convs), YOLOv9's GELAN blocks (CBLinear's output is a tuple of
channel groups in the channel list, which CBFuse indexes) and the Segment
head (its prototype width npr scaled as a channel count), the Pose head
(its kpt_shape the spec's, which a dataset's kpt_shape replaces), the
OBB head, and the Classify head and ResNetLayer of the cls YAMLs (a
ResNetLayer row takes no width scale: c2 is its base width for the stem,
else base x e; the reference's [c1, c2, s, is_first, n, e] layout is told
by the bool at index 3), and RT-DETR's HGStem, HGBlock (its repeats at
args index 3, no width scale), LightConv, AIFI (c1 first), RepC3 and the
RTDETRDecoder head are registered, and so are the rows no bundled YAML
uses: Focus (its stride doubled), ConvTranspose (with BatchNorm; 1/s),
Index (c2 its first argument), CBAM, C1, C3x, BottleneckCSP, the EdgeLine
ablation blocks C3k2_Wavelet / C3k2_TWavelet, SPPF_Wavelet, MulGate and
RHJM, DySample (c1 put first; 1/scale), WTConv2d, MSLA as a row of its own
and `Upsample`, and YOLO-World's C2fAttn (its embed width and heads scaled
as the reference's, then its repeats), ImagePoolingAttn (the channels of
its inputs) and WorldDetect: every row of JAX's registry. An unknown
module name raises.
A World model's forward threads its text bank through the walk: C2fAttn
reads the text stream, ImagePoolingAttn refreshes it (the feature stream
passes through), and WorldDetect sees the original texts (`WorldModel`).
An RT-DETR model's forward hands `dn`, the contrastive-denoising queries
of a training step, to its head.
`guess_model_task` names a spec's task by its head, as JAX does;
SegmentationModel, PoseModel, OBBModel and ClassificationModel are the
DetectionModel of their tasks. A classify model's BatchNorms keep torch's
constructor defaults (eps 1e-5, momentum 0.1), as JAX's ClassificationModel
does; every other task takes the model-level 1e-3 and 0.03.
`fuse_conv_bn` folds BatchNorms into their convs for inference (the
model's `fuse`), and the forward's `embed` returns pooled features of the
layers it taps, as JAX's do.
"""

from __future__ import annotations

import ast
import copy
from dataclasses import dataclass
from typing import Any, Sequence

import torch
from torch import nn

from edgeyolo_tpu_torch.cfg.models import model_cfg
from edgeyolo_tpu_torch.nn.modules.block import (C1, C2, C2f, C2fPSA, C2PSA, C3, C3k, C3k2, PSA,
                                                 SPP, SPPF, Bottleneck, SCDown)
from edgeyolo_tpu_torch.nn.modules.conv import (CBAM, BatchNorm2d, Concat, ConvBN, ConvTranspose,
                                                ConvTranspose2d, DSConv, DWConv, Focus, GhostConv,
                                                Index, LightConv, MaxPool2d, Upsample, ZeroPad2d,
                                                default_act)
from edgeyolo_tpu_torch.nn.modules.edgeline import (RHJM, C2PSA_LinearAttention, C3k2_Wavelet,
                                                    DSC3K2, DSC3K2_Wavelet, MulGate, SPPF_Wavelet)
from edgeyolo_tpu_torch.nn.modules.extra import (CIB, A2C2f, AdaHyperedgeGen, BottleneckCSP,
                                                 C2fCIB, C3Ghost, DownsampleConv, DySample,
                                                 FullPAD_Tunnel, GhostBottleneck, HGBlock, HGStem,
                                                 HyperACE, RepVGGDW, ResNetLayer, WTConv2d)
from edgeyolo_tpu_torch.nn.modules.gelan import (ADown, AConv, CBFuse, CBLinear, ELAN1, SPPELAN,
                                                 RepConv, RepNCSPELAN4)
from edgeyolo_tpu_torch.nn.modules.head import (OBB, Classify, Detect, E2EDetect, GFLHeadv2_uniH,
                                                Pose, RTDETRDecoder, Segment, v10Detect)
from edgeyolo_tpu_torch.nn.modules.msla_lgl import (MSLA, C3AW_MLM, DSC3K2_LGL, DSC3K2_MSLA,
                                                    HyperACE_Wavelet, Wavelet_SS2D)
from edgeyolo_tpu_torch.nn.modules.transformer import AIFI, MultiheadAttention, RepC3
from edgeyolo_tpu_torch.nn.modules.world import C2fAttn, ImagePoolingAttn, WorldDetect
from edgeyolo_tpu_torch.utils import make_divisible, select_device, uniform_

_HYPERACE_ARGS = ["c2", "n", "num_hyperedges", "dsc3k", "shortcut", "e1", "e2", "context",
                  "channel_adjust"]
# name -> (module class, argument names after c1, i.e. as args stand after parsing)
_REG: dict[str, tuple[type, list[str]]] = {
    "Conv": (ConvBN, ["c2", "k", "s", "p", "g", "d", "act"]),
    "ConvBN": (ConvBN, ["c2", "k", "s", "p", "g", "d", "act"]),
    "DWConv": (DWConv, ["c2", "k", "s", "d", "act"]),
    "DSConv": (DSConv, ["c2", "k", "s", "p", "d"]),
    "GhostConv": (GhostConv, ["c2", "k", "s", "g", "act"]),
    "LightConv": (LightConv, ["c2", "k"]),
    "nn.ConvTranspose2d": (ConvTranspose2d, ["c2", "k", "s", "p"]),
    "Focus": (Focus, ["c2", "k", "s", "p", "g", "act"]),
    "ConvTranspose": (ConvTranspose, ["c2", "k", "s", "p", "bn", "act"]),
    "Index": (Index, ["c2", "index"]),
    "CBAM": (CBAM, ["c1", "k"]),
    "Bottleneck": (Bottleneck, ["c2", "shortcut", "g", "k", "e"]),
    "C1": (C1, ["c2", "n"]),
    "C2": (C2, ["c2", "n", "shortcut", "g", "e"]),
    "C2f": (C2f, ["c2", "n", "shortcut", "g", "e"]),
    "C3": (C3, ["c2", "n", "shortcut", "g", "e"]),
    "C3x": (C3, ["c2", "n", "shortcut", "g", "e"]),  # JAX's C3x is C3
    "C3k": (C3k, ["c2", "n", "shortcut", "g", "e", "k"]),
    "C3k2": (C3k2, ["c2", "n", "c3k", "e", "g", "shortcut"]),
    "SPP": (SPP, ["c2", "k"]),
    "SPPF": (SPPF, ["c2", "k"]),
    "C2PSA": (C2PSA, ["c2", "n", "e"]),
    "C2fPSA": (C2fPSA, ["c2", "n", "e"]),
    "PSA": (PSA, ["c2", "e"]),
    "SCDown": (SCDown, ["c2", "k", "s"]),
    "CIB": (CIB, ["c2", "shortcut", "e", "lk"]),
    "C2fCIB": (C2fCIB, ["c2", "n", "shortcut", "lk", "g", "e"]),
    "RepVGGDW": (RepVGGDW, ["ed"]),
    "GhostBottleneck": (GhostBottleneck, ["c2", "k", "s"]),
    "C3Ghost": (C3Ghost, ["c2", "n", "shortcut", "g", "e"]),
    "BottleneckCSP": (BottleneckCSP, ["c2", "n", "shortcut", "g", "e"]),
    "C2PSA_LinearAttention": (C2PSA_LinearAttention,
                              ["c2", "n", "e", "attn_ratio", "num_heads", "mlp_ratio"]),
    "C3k2_Wavelet": (C3k2_Wavelet, ["c2", "n", "c3k", "e", "g", "shortcut"]),
    "C3k2_TWavelet": (C3k2_Wavelet, ["c2", "n", "c3k", "e", "g", "shortcut"]),
    "SPPF_Wavelet": (SPPF_Wavelet, ["c2", "k"]),
    "MulGate": (MulGate, ["c2", "e", "k", "d", "gamma0"]),
    "RHJM": (RHJM, ["c2", "local_size", "gamma", "b", "local_weight"]),
    "DSC3K2": (DSC3K2, ["c2", "n", "dsc3k", "e", "g", "shortcut", "k1", "k2", "d2"]),
    "DSC3K2_Wavelet": (DSC3K2_Wavelet, ["c2", "n", "dsc3k", "e", "g", "shortcut", "k1", "k2", "d2"]),
    "DSC3K2_MSLA": (DSC3K2_MSLA, ["c2", "n", "dsc3k", "e", "g", "shortcut", "k1", "k2", "d2"]),
    "DSC3K2_LGL": (DSC3K2_LGL, ["c2", "n", "dsc3k", "e", "g", "shortcut", "k1", "k2", "d2"]),
    "C3AW_MLM": (C3AW_MLM, ["c2", "e", "levels"]),
    "MSLA": (MSLA, ["dim", "num_heads"]),
    "A2C2f": (A2C2f, ["c2", "n", "a2", "area", "residual", "mlp_ratio", "e", "g", "shortcut"]),
    "HyperACE": (HyperACE, _HYPERACE_ARGS),
    "HyperACE_Wavelet": (HyperACE_Wavelet, _HYPERACE_ARGS),
    "Wavelet_SS2D": (Wavelet_SS2D, _HYPERACE_ARGS),
    "DownsampleConv": (DownsampleConv, ["c1", "channel_adjust"]),
    "FullPAD_Tunnel": (FullPAD_Tunnel, []),
    "RepConv": (RepConv, ["c2", "k", "s"]),
    "RepNCSPELAN4": (RepNCSPELAN4, ["c2", "c3", "c4", "n"]),
    "ELAN1": (ELAN1, ["c2", "c3", "c4"]),
    "AConv": (AConv, ["c2"]),
    "ADown": (ADown, ["c2"]),
    "SPPELAN": (SPPELAN, ["c2", "c3", "k"]),
    "CBLinear": (CBLinear, ["c2s", "k", "s"]),
    "CBFuse": (CBFuse, ["idx"]),
    "ResNetLayer": (ResNetLayer, ["c2", "s", "is_first", "n", "e"]),
    "DySample": (DySample, ["c1", "scale", "style", "groups"]),
    "WTConv2d": (WTConv2d, ["c2", "k", "s", "bias", "levels", "wave"]),
    "Classify": (Classify, ["c2", "k", "s", "p", "g"]),
    "HGStem": (HGStem, ["cm", "c2"]),
    "HGBlock": (HGBlock, ["cm", "c2", "k", "n", "lightconv", "shortcut", "act"]),
    "AIFI": (AIFI, ["c1", "cm", "num_heads"]),
    "RepC3": (RepC3, ["c2", "n", "e"]),
    "nn.Identity": (nn.Identity, []),
    "Concat": (Concat, ["dim"]),
    "nn.Upsample": (Upsample, ["size", "scale_factor", "mode"]),
    "Upsample": (Upsample, ["size", "scale_factor", "mode"]),
    "nn.MaxPool2d": (MaxPool2d, ["k", "s", "p"]),
    "nn.ZeroPad2d": (ZeroPad2d, ["pad"]),
    "Detect": (Detect, ["nc"]),
    "v10Detect": (v10Detect, ["nc"]),
    "GFLHeadv2_uniH": (GFLHeadv2_uniH, ["nc"]),
    "GF2Detect": (GFLHeadv2_uniH, ["nc"]),
    "E2EDetect": (E2EDetect, ["nc"]),
    "GFLHeadv2_E2E": (E2EDetect, ["nc"]),
    "Segment": (Segment, ["nc", "nm", "npr"]),
    "Pose": (Pose, ["nc", "kpt_shape"]),
    "OBB": (OBB, ["nc", "ne"]),
    "RTDETRDecoder": (RTDETRDecoder, ["nc"]),
    "C2fAttn": (C2fAttn, ["c2", "n", "ec", "nh", "gc", "shortcut", "g", "e"]),
    "ImagePoolingAttn": (ImagePoolingAttn, ["ec"]),
    "WorldDetect": (WorldDetect, ["nc", "embed", "with_bn"]),
}
_CONV_LIKE = {"Conv", "ConvBN", "DWConv", "DSConv", "GhostConv", "nn.ConvTranspose2d",
              "Focus", "ConvTranspose", "Bottleneck", "C1", "C2", "C2f", "C3", "C3x", "C3k",
              "C3k2", "SPP", "SPPF", "C2PSA", "C2fPSA", "PSA", "SCDown", "CIB", "C2fCIB",
              "GhostBottleneck", "C3Ghost", "BottleneckCSP", "C2PSA_LinearAttention",
              "C3k2_Wavelet", "C3k2_TWavelet", "SPPF_Wavelet", "MulGate", "RHJM", "DSC3K2",
              "DSC3K2_Wavelet", "DSC3K2_MSLA", "DSC3K2_LGL", "C3AW_MLM", "A2C2f", "RepConv",
              "RepNCSPELAN4", "ELAN1", "AConv", "ADown", "SPPELAN", "Classify", "LightConv",
              "RepC3", "C2fAttn"}
# CSP modules that take the repeats as their argument; any other module with n > 1 is
# built as n copies in sequence
_REPEAT_INSERT = {"C1", "C2", "C2f", "C3", "C3x", "C3k2", "C2PSA", "C2fPSA", "C2fCIB", "C3Ghost",
                  "BottleneckCSP", "C2PSA_LinearAttention", "C3k2_Wavelet", "C3k2_TWavelet",
                  "DSC3K2", "DSC3K2_Wavelet", "DSC3K2_MSLA", "DSC3K2_LGL", "A2C2f", "RepC3",
                  "C2fAttn"}
_C3K2_FAMILY = {"C3k2", "C3k2_Wavelet", "C3k2_TWavelet", "DSC3K2", "DSC3K2_Wavelet",
                "DSC3K2_MSLA", "DSC3K2_LGL"}
_HYPERACE = {"HyperACE", "HyperACE_Wavelet", "Wavelet_SS2D"}
_HEADS = {"Detect", "v10Detect", "GFLHeadv2_uniH", "GF2Detect", "E2EDetect", "GFLHeadv2_E2E",
          "Segment", "Pose", "OBB", "RTDETRDecoder", "WorldDetect"}
_TEXT = {"C2fAttn", "ImagePoolingAttn", "WorldDetect"}  # the modules that take the texts
_STRIDE_ARG = {"Conv", "ConvBN", "DWConv", "DSConv", "GhostConv", "Focus", "SCDown", "RepConv",
               "nn.MaxPool2d"}
_STRIDE_FIXED = {"AConv": 2.0, "ADown": 2.0, "DownsampleConv": 2.0, "HGStem": 4.0}
# built from c1 (the channels of their input, the second one for HyperACE) and the args
_TAKES_C1 = _CONV_LIKE | _HYPERACE | {"CBLinear", "ResNetLayer", "HGStem", "HGBlock", "WTConv2d"}
# convs that a YAML's `activation:` override reaches by argument (JAX tasks.py)
_ACT_ARG = {"Conv", "ConvBN", "DWConv"}
_ACT_NAMES = ("relu6", "relu", "silu", "sigmoid", "tanh")


def _literal(v):
    """A YAML string that is a Python literal ("None", "True") -> its value."""
    if isinstance(v, str):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


@dataclass(frozen=True)
class LayerSpec:
    """One graph node: inputs f (-1 = previous), repeats n (n copies in
    sequence when n > 1), input and output channels."""

    i: int
    f: tuple[int, ...]
    n: int
    name: str
    args: tuple
    kwargs: tuple[tuple[str, Any], ...]
    c1: int
    c2: int | tuple[int, ...]


def guess_model_task(spec: dict) -> str:
    """The task a spec's head serves (JAX guess_model_task): "classify",
    "segment", "pose" or "obb" for a Classify, Segment, Pose or OBB head,
    "detect" for a detect head."""
    head = spec["head"][-1][2] if "head" in spec else ""
    for word, task in (("Classify", "classify"), ("Segment", "segment"), ("Pose", "pose"),
                       ("OBB", "obb")):
        if word in head:
            return task
    return "detect"


def parse_spec(d: dict, ch: int = 3) -> tuple[tuple[LayerSpec, ...], tuple[int, ...], dict]:
    """Compile a spec dict into (layers, save, info)."""
    nc = d.get("nc", 80)
    scales = d.get("scales")
    scale = d.get("scale") or (next(iter(scales)) if scales else "")
    act = str(d.get("activation") or "").lower()  # e.g. "nn.ReLU()" in yolov6
    act_override = next((a for a in _ACT_NAMES if a in act), None)
    depth, width, max_channels = (scales[scale] if scales and scale in scales else (
        d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0), float("inf")))
    legacy = True
    ch_list = [ch]
    layers: list[LayerSpec] = []
    save: set[int] = set()
    for i, (f, n, name, args) in enumerate(d["backbone"] + d["head"]):
        if name not in _REG:
            raise KeyError(f"module '{name}' is not ported yet")
        # yaml-level names resolve as the reference parse_model's: "nc" and "kpt_shape"
        args = [nc if a == "nc" else list(d.get("kpt_shape", [17, 3])) if a == "kpt_shape"
                else _literal(a) for a in args]
        n_scaled = max(round(n * depth), 1) if n > 1 else n
        kwargs: dict[str, Any] = {}
        f_list = [f] if isinstance(f, int) else list(f)
        c1 = ch_list[f_list[0]]
        if name == "Classify":  # several inputs are concatenated on channels
            c1 = sum(ch_list[x] for x in f_list)
        if name in _CONV_LIKE:
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c2, *args[1:]]
            if act_override and name in _ACT_ARG and len(args) < 7:
                kwargs["act"] = act_override
            if name == "C2fAttn":  # the embed width and the heads, as the reference scales them
                args[1] = make_divisible(min(args[1], max_channels // 2) * width, 8)
                args[2] = (int(max(round(min(args[2], max_channels // 2 // 32) * width), 1))
                           if args[2] > 1 else args[2])
            if name in _REPEAT_INSERT:
                args.insert(1, n_scaled)
                n_scaled = 1
            if name in _C3K2_FAMILY:
                legacy = False
                if scale and scale in "lx":
                    if len(args) > 2:
                        args[2] = True
                    else:
                        args.append(True)
            if name == "A2C2f":
                legacy = False
                if scale and scale in "lx":  # residual=True, mlp_ratio=1.5
                    while len(args) < 6:
                        args.append({2: True, 3: 1, 4: False, 5: 2.0}.get(len(args)))
                    args[4] = True
                    args[5] = 1.5
        elif name in _HYPERACE:  # c1 from the second input; hyperedges scaled by size
            legacy = False
            c1 = ch_list[f_list[1]]
            c2 = make_divisible(min(args[0], max_channels) * width, 8)
            he = args[1]
            if scale == "n":
                he = int(he * 0.5)
            elif scale == "x":
                he = int(he * 1.5)
            args = [c2, n_scaled, he, *args[2:]]
            n_scaled = 1
            if scale and scale in "lx":
                args.append(False)  # channel_adjust
        elif name == "DownsampleConv":
            c2 = 2 * c1
            args = [c1]
            if scale and scale in "lx":
                args.append(False)
                c2 = c1
        elif name == "CBLinear":  # a tuple of channel groups
            c2 = tuple(args[0])
            args = [c2, *args[1:]]
        elif name == "CBFuse":
            c2 = ch_list[f_list[-1]]
            args = [tuple(args[0])] if args else [()]
        elif name == "ResNetLayer":  # no width scale; [c1, c2, s, is_first, n, e] drops c1
            if len(args) >= 4 and isinstance(args[3], bool):
                args = args[1:]
            c2 = args[0] if len(args) > 2 and args[2] else args[0] * (args[4] if len(args) > 4
                                                                       else 4)
        elif name in ("HGStem", "HGBlock"):  # no width scale; HGBlock's repeats at index 3
            c2 = args[1]
            if name == "HGBlock":
                args.insert(3, n_scaled)
                n_scaled = 1
        elif name in ("AIFI", "DySample"):  # c1 put first
            args = [c1, *args]
            c2 = c1
        elif name == "Index":
            c2 = args[0]
        elif name == "ImagePoolingAttn":  # the texts' refresh; the features pass through
            kwargs["ch"] = tuple(ch_list[x] for x in f_list)
            c2 = c1
        elif name == "RTDETRDecoder":
            kwargs["ch"] = tuple(ch_list[x] for x in f_list)
            c2 = sum(kwargs["ch"])
        elif name == "Concat":
            c2 = sum(ch_list[x] for x in f_list)
        elif name in _HEADS:
            kwargs["ch"] = tuple(ch_list[x] for x in f_list)
            kwargs["legacy"] = legacy and not _REG[name][0].end2end
            if name == "Segment" and len(args) > 2:  # npr
                args[2] = make_divisible(min(args[2], max_channels) * width, 8)
            if name == "Pose" and len(args) > 1 and isinstance(args[1], (list, tuple)):
                args[1] = tuple(d.get("kpt_shape", args[1]))  # a data-level kpt_shape wins
            c2 = sum(kwargs["ch"])
        else:  # (nn.)Upsample, nn.MaxPool2d, nn.ZeroPad2d, nn.Identity, RepVGGDW, FullPAD_Tunnel,
            c2 = c1  # CBAM, WTConv2d, MSLA
        args = tuple(tuple(a) if isinstance(a, list) else a for a in args)
        layers.append(LayerSpec(i=i, f=tuple(x if x == -1 else x % i for x in f_list),
                                n=n_scaled, name=name, args=args,
                                kwargs=tuple(sorted(kwargs.items())), c1=c1, c2=c2))
        save.update(x % i for x in f_list if x != -1)
        if i == 0:
            ch_list = []
        ch_list.append(c2)
    return tuple(layers), tuple(sorted(save)), {"nc": nc, "scale": scale,
                                                "act": act_override or "silu"}


def derive_strides(layers: Sequence[LayerSpec]) -> list[float]:
    """Output stride of each layer (the image has stride 1)."""
    strides: list[float] = []
    for sp in layers:
        src = sp.f[0]
        s_in = 1.0 if sp.i == 0 else strides[src if src >= 0 else sp.i - 1]
        factor = 1.0
        fields = _REG[sp.name][1]
        if sp.name in _STRIDE_ARG:
            factor = float(sp.args[fields.index("s")]) if fields.index("s") < len(sp.args) else 1.0
            if sp.name == "Focus":  # space-to-depth halves the map first
                factor *= 2.0
        elif sp.name in _STRIDE_FIXED:
            factor = _STRIDE_FIXED[sp.name]
        elif sp.name == "ResNetLayer":  # the stem: conv /2 and pool /2
            factor = 4.0 if len(sp.args) > 2 and sp.args[2] else float(
                sp.args[1] if len(sp.args) > 1 else 1)
        elif sp.name in ("nn.Upsample", "Upsample"):
            sf = sp.args[1] if len(sp.args) > 1 else 2
            factor = 1.0 / float(sf or 2)
        elif sp.name == "DySample":
            factor = 1.0 / float(sp.args[1] if len(sp.args) > 1 else 2)
        elif sp.name in ("nn.ConvTranspose2d", "ConvTranspose"):
            factor = 1.0 / float(sp.args[fields.index("s")] if fields.index("s") < len(sp.args)
                                 else 2)
        strides.append(s_in * factor)
    return strides


def build_module(sp: LayerSpec, head_stride: Sequence[int]) -> nn.Module:
    cls, fields = _REG[sp.name]
    kw = {**dict(zip(fields, sp.args)), **dict(sp.kwargs)}
    if sp.name in _HEADS:
        return cls(stride=tuple(head_stride), **kw)

    def one(c1: int) -> nn.Module:
        return cls(c1, **kw) if sp.name in _TAKES_C1 else cls(**kw)

    if sp.n > 1:  # a repeated plain module: model.{i}.{j}, each copy taking the last's output
        return nn.Sequential(*(one(sp.c1 if j == 0 else sp.c2) for j in range(sp.n)))
    return one(sp.c1)


class GraphNet(nn.Module):
    """Runs a compiled LayerSpec graph; layer i is `model.{i}`."""

    def __init__(self, layers: tuple[LayerSpec, ...], save: tuple[int, ...],
                 head_stride: Sequence[int]):
        super().__init__()
        self.layers = layers
        self.save = frozenset(save)
        self.model = nn.ModuleList(build_module(sp, head_stride) for sp in layers)

    def forward(self, x, capture: Sequence[int] | None = None, dn: dict | None = None,
                embed: Sequence[int] | None = None, text: torch.Tensor | None = None):
        """The head's output; with `capture`, (output, {i: layer i's raw
        output}) for the listed layers (JAX's `capture`, feature maps). `dn`
        goes to an RTDETRDecoder head (training's denoising queries). With
        `embed`, the walk stops at the largest listed layer and returns the
        global average pool of each listed layer's output, in f32,
        concatenated in layer order (B, sum of their channels): JAX's embed.
        `text` (B, K, 512) is a World graph's text stream."""
        ori_text = text  # WorldDetect sees the texts before any refresh
        y: dict[int, torch.Tensor] = {}
        want = frozenset(capture or ())
        taps = frozenset(embed or ())
        captured: dict[int, torch.Tensor] = {}
        feats: list[torch.Tensor] = []
        out = x
        for sp, m in zip(self.layers, self.model):
            if len(sp.f) == 1:
                inp = out if sp.f[0] == -1 else y[sp.f[0]]
            else:
                inp = [out if j == -1 else y[j] for j in sp.f]
            if sp.name in _TEXT:
                if sp.name == "ImagePoolingAttn":  # refreshes the texts; `out` passes through
                    text = m(inp, text)
                else:
                    out = m(inp, ori_text if sp.name == "WorldDetect" else text)
            else:
                out = m(inp) if dn is None or sp.name != "RTDETRDecoder" else m(inp, dn=dn)
            if sp.i in self.save:
                y[sp.i] = out
            if sp.i in want:
                captured[sp.i] = out
            if sp.i in taps:
                feats.append(out.float().mean(dim=(2, 3)))
                if sp.i == max(taps):
                    return torch.cat(feats, dim=1)
        return (out, captured) if capture else out


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation: every trainable conv (transposed too) and linear
    weight ~ U(+-1/sqrt(fan_in)) (torch's default, the JAX KERNEL_INIT), their biases
    0; hyperedge prototypes xavier-uniform, as flax initialises them.
    BatchNorm, LayerNorm, the gates, the wavelet, WTConv2d and MSLA scale
    weights, MulGate's gamma and the frozen DFL bins keep their constructor
    values. A module with its own rule (`seeded_init`: RT-DETR's packed
    attention, deformable attention and denoising embedding; DySample's
    zero offset conv, MulGate's zero `mix`, AGLU's U(0, 1) draws) then
    applies it, drawing from `generator`."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) and \
                    m.weight.requires_grad:
                # fan_in: (in, out, kh, kw) for a transposed conv, else (out, in/g, ...)
                fan_in = (m.weight[:, 0].numel() if isinstance(m, nn.ConvTranspose2d)
                          else m.weight[0].numel())
                uniform_(m.weight, fan_in ** -0.5, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, AdaHyperedgeGen):
                e, d = m.prototype_base.shape
                uniform_(m.prototype_base, (6.0 / (e + d)) ** 0.5, generator)
        for m in model.modules():
            if hasattr(m, "seeded_init"):
                m.seeded_init(generator)


FUSE_CONVS = ("conv", "pw", "conv_transpose")


def fuse_conv_bn(model: nn.Module) -> list[str]:
    """Fold each BatchNorm into the conv that feeds it, in place; returns the
    folded BatchNorms' names.

    The pairs are JAX's `fuse_conv_bn`'s: a module's `bn` (a BatchNorm2d)
    with a sibling `conv`, `pw` or `conv_transpose` (the first of them that
    is a 2-D conv or transposed conv with as many outputs as the BatchNorm
    has channels). The conv's weight is scaled per output channel by
    weight / sqrt(running_var + eps), with each BatchNorm's own eps (dim 1
    of a transposed conv's (in, out / groups, kh, kw) weight), it gets the
    bias bias + (conv bias - running_mean) * that scale, and the BatchNorm
    leaves the forward (an nn.Identity, which `norm_f32` passes through).
    Unpaired BatchNorms stay: RepConv's identity branch, BottleneckCSP's
    joint one, MulGate's (its sibling is `mix`). The fold runs in f32 from
    the convs' weights as they are, and casts back to their dtype: fold an
    f32 model before a bf16 copy is made of it, not after."""
    folded = []
    with torch.no_grad():
        for name, m in model.named_modules():
            bn = getattr(m, "bn", None)
            if not isinstance(bn, nn.BatchNorm2d):
                continue
            for key in FUSE_CONVS:
                conv = getattr(m, key, None)
                if isinstance(conv, (nn.Conv2d, nn.ConvTranspose2d)) and \
                        conv.out_channels == bn.num_features:
                    break
            else:
                continue
            g = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
            w = conv.weight.float()
            if isinstance(conv, nn.ConvTranspose2d):  # (in, out / groups, kh, kw)
                w = (w.unflatten(0, (conv.groups, -1))
                     * g.view(conv.groups, 1, -1, 1, 1)).flatten(0, 1)
            else:
                w = w * g.view(-1, 1, 1, 1)
            b0 = conv.bias.float() if conv.bias is not None else torch.zeros_like(g)
            bias = bn.bias.float() + (b0 - bn.running_mean.float()) * g
            conv.weight.copy_(w.to(conv.weight.dtype))
            conv.bias = nn.Parameter(bias.to(conv.weight.dtype))
            m.bn = nn.Identity()
            folded.append(f"{name}.bn" if name else "bn")
    return folded


def num_params(model: nn.Module) -> int:
    """Parameter count as the reference reports it (the frozen DFL bins included)."""
    return sum(p.numel() for p in model.parameters())


def num_trainable(model: nn.Module) -> int:
    """Parameters the optimizer updates: JAX's count (the DFL bins are frozen)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 and back to its own dtype: differentiable, and its
    gradient arrives rounded to bf16, as through JAX's cast."""
    return t.to(torch.bfloat16).to(t.dtype)


def amp_params(model: nn.Module) -> dict[str, torch.Tensor]:
    """Every floating parameter of `model` rounded to bf16, by name, as JAX's
    `amp_cast` rounds the f32 masters (BatchNorm's scale and shift, the
    wavelet band weights and the quality head included). Rounded as one
    concatenated vector (one cast each way, not one per tensor) and returned
    as views of it, differentiable back to the masters."""
    named = [(n, p) for n, p in model.named_parameters() if p.is_floating_point()]
    flat = round_bf16(torch.cat([p.reshape(-1) for _, p in named]))
    return {n: v.view_as(p) for (n, p), v in zip(named, flat.split([p.numel() for _, p in named]))}


def _f32(v):
    """Every tensor of a nested list, tuple or dict in f32."""
    if isinstance(v, torch.Tensor):
        return v.float()
    if isinstance(v, dict):
        return {k: _f32(t) for k, t in v.items()}
    return type(v)(_f32(t) for t in v)


def train_forward(model: nn.Module, x: torch.Tensor, amp: bool = True,
                  dn: dict | None = None) -> dict:
    """The training forward: {"feats", "quality", "one2one_feats",
    "one2one_quality"} per level, in f32; a key the head does not emit
    (the quality of Detect, the one2one branch of a head that is not end to
    end) is None. A segment head adds "mask_coefs" and "proto", in f32.
    An RT-DETR head's whole output dict comes back in f32, its denoising
    queries built from `dn`.

    With `amp`, as JAX's `amp_cast` of the f32 masters: the forward sees
    `amp_params(model)` through `torch.func.functional_call`, so gradients
    flow back into the f32 masters, and runs under bf16 autocast, so
    convolutions and the attention compute in bf16 while BatchNorm, the
    wavelet band weights and the quality head compute in f32 on the rounded
    values, as in serving.
    """
    kw = {} if dn is None else {"dn": dn}
    if not amp:
        out = model(x, **kw)
    else:
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            out = torch.func.functional_call(model, amp_params(model), (x.to(torch.bfloat16),),
                                             kw)
    if "enc_scores" in out:
        return _f32(out)
    res = {k: None if out.get(k) is None else [f.float() for f in out[k]]
           for k in ("feats", "quality", "one2one_feats", "one2one_quality")}
    for k in ("mask_coefs", "proto", "kpts_raw", "angle"):  # the task heads' extras
        if k in out:
            res[k] = out[k].float()
    return res


def for_precision(model: nn.Module, half: bool) -> nn.Module:
    """The model an inference runs: `model`, or with `half` a bf16 copy of it
    (convolutions bf16; BatchNorm, the quality head and the decode f32). The
    copy's `master` is `model`: int8 quantizes its full-precision weights and
    keeps its QuantState there (nn/quant.py)."""
    if not half or model.dtype == torch.bfloat16:
        return model
    net = copy.deepcopy(model).set_dtype(torch.bfloat16)
    net.__dict__["master"] = model  # a plain attribute, not a submodule
    return net


class DetectionModel(GraphNet):
    """The detector: spec by name (or a spec dict), seeded weights, explicit
    device and dtype.

    `dtype` is the compute dtype of every convolution and linear layer but
    the quality head's;
    BatchNorm, LayerNorm, the wavelet band weights, the quality head and the
    box decode stay f32. `nc` replaces the spec's class count (a head for a
    dataset). `end2end` is the head's: an NMS-free head's pred is its
    (B, max_det, 6) selection. `task` is the spec's (`guess_model_task`):
    a Segment, Pose or OBB head makes a segment, pose or obb model.
    `kpt_shape` replaces the spec's (a pose head for a dataset's keypoints).
    A Classify head makes a classify model: its forward returns the
    (B, nc) logits, and its BatchNorms take torch's defaults (eps 1e-5,
    momentum 0.1), not the detection models' 1e-3 and 0.03.
    The model lands on CUDA unless `device` names another device.
    """

    def __init__(self, cfg: str | dict = "edgeline-yolo.yaml", scale: str | None = None,
                 device: str | torch.device | None = None, dtype: torch.dtype = torch.float32,
                 seed: int = 0, nc: int | None = None, kpt_shape: Sequence[int] | None = None):
        spec = model_cfg(cfg, scale)
        if nc:
            spec["nc"] = int(nc)
        if kpt_shape:
            spec["kpt_shape"] = [int(k) for k in kpt_shape]
        self.task = guess_model_task(spec)
        layers, save, info = parse_spec(spec)
        strides = derive_strides(layers)
        head = layers[-1]
        stride = tuple(int(strides[j]) for j in head.f)
        device = select_device(device)
        # module constructors draw from the global RNG; act=True builds to the YAML's activation
        with torch.random.fork_rng(devices=[]), default_act(info["act"]):
            super().__init__(layers, save, stride)
        self.nc = info["nc"]
        self.names = {i: str(i) for i in range(self.nc)}
        self.cfg, self.scale = cfg, info["scale"]
        self.end2end = bool(getattr(self.model[-1], "end2end", False))
        self.kpt_shape = getattr(self.model[-1], "kpt_shape", None)
        self.fused = False
        init_weights(self, torch.Generator().manual_seed(seed))
        if self.task == "classify":
            for m in self.modules():
                if isinstance(m, BatchNorm2d):
                    m.eps, m.momentum = 1e-5, 0.1
        else:
            self.model[-1].bias_init()
        self.set_dtype(dtype)
        self.to(device).eval()
        self._quant = self._quant_stash = None

    @property
    def quant(self):
        """The active QuantState (nn/quant.py), or None: setting one swaps its
        convs for int8 ones (eval only; training stays full precision), None
        swaps them back."""
        return self.__dict__.get("_quant")

    @quant.setter
    def quant(self, qs) -> None:
        from edgeyolo_tpu_torch.nn.quant import install, uninstall

        if qs is None:
            uninstall(self)
        else:
            install(self, qs)
        self.__dict__["_quant"] = qs

    def quantize(self, calib_images, skip=()):
        """Calibrate on `calib_images` (a model-space NCHW batch on the
        model's device, or a list of them) in full precision, then enable the
        int8 forward; returns the QuantState. The engines' per-call `int8`
        flag decides for their calls (int8=False stashes the state in
        `_quant_stash`, a later int8=True reuses it)."""
        from edgeyolo_tpu_torch.nn.quant import calibrate, quantize

        self.quant = None
        batches = [calib_images] if isinstance(calib_images, torch.Tensor) else calib_images
        self.quant = quantize(self, calibrate(self, batches), skip=skip)
        return self.quant

    def fuse(self) -> "DetectionModel":
        """Fold conv and BatchNorm pairs for inference, in place
        (`fuse_conv_bn`, JAX's BaseModel.fuse); a second call folds nothing.
        `fused_bns` lists the folded BatchNorms."""
        folded = fuse_conv_bn(self)
        self.fused_bns = [*getattr(self, "fused_bns", []), *folded]
        self.fused = True
        return self

    def set_dtype(self, dtype: torch.dtype) -> "DetectionModel":
        """Cast every convolution and linear layer but the quality head's to
        `dtype`, in place."""
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                m.to(dtype)
            elif isinstance(m, MultiheadAttention):  # its packed q, k, v projection
                m.in_proj_weight.data = m.in_proj_weight.data.to(dtype)
                m.in_proj_bias.data = m.in_proj_bias.data.to(dtype)
        for q in getattr(self.model[-1], "quality_heads", list)():
            q.float()  # the quality heads are an f32 island, as in JAX
        self.dtype = dtype
        return self


class SegmentationModel(DetectionModel):
    """The segment task's model: a spec whose head is Segment."""

    def __init__(self, cfg: str = "yolo11n-seg.yaml", *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        if self.task != "segment":
            raise ValueError(f"{cfg} has no Segment head (its task is {self.task})")


class PoseModel(DetectionModel):
    """The pose task's model: a spec whose head is Pose."""

    def __init__(self, cfg: str = "yolo11n-pose.yaml", *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        if self.task != "pose":
            raise ValueError(f"{cfg} has no Pose head (its task is {self.task})")


class OBBModel(DetectionModel):
    """The obb task's model: a spec whose head is OBB."""

    def __init__(self, cfg: str = "yolo11n-obb.yaml", *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        if self.task != "obb":
            raise ValueError(f"{cfg} has no OBB head (its task is {self.task})")


class RTDETRDetectionModel(DetectionModel):
    """RT-DETR's query-based detector: a spec whose head is RTDETRDecoder
    (no NMS; trained through train/detr_loss.py's RTDETRDetectionLoss with
    contrastive denoising)."""

    def __init__(self, cfg: str = "rtdetr-l.yaml", *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        if not is_rtdetr(self):
            raise ValueError(f"{cfg} has no RTDETRDecoder head")


def is_rtdetr(model) -> bool:
    """Whether a model's head is RT-DETR's query decoder."""
    return isinstance(getattr(model, "model", [None])[-1], RTDETRDecoder)


class ClassificationModel(DetectionModel):
    """The classify task's model: a spec whose head is Classify; its forward
    returns the (B, nc) logits."""

    def __init__(self, cfg: str = "yolo11n-cls.yaml", *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        if self.task != "classify":
            raise ValueError(f"{cfg} has no Classify head (its task is {self.task})")


class WorldModel(DetectionModel):
    """YOLO-World's open-vocabulary detector: a spec whose head is
    WorldDetect, classifying by similarity to a bank of text embeddings
    (JAX's WorldModel). The bank starts as zeros of the spec's nc classes
    (JAX's init); `set_classes` replaces it, and `nc` and `names` with it.
    The forward broadcasts the bank over the batch, in the compute dtype. The
    bank is a non-persistent f32 buffer: it lives on the model's device and
    moves with `.to()`, and a checkpoint carries no bank, as JAX's does not."""

    def __init__(self, cfg: str | dict = "yolov8-worldv2.yaml", *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        if not is_world(self):
            raise ValueError(f"{cfg} has no WorldDetect head")
        self.register_buffer("text", torch.zeros(1, self.nc, 512, device=self.device),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def set_classes(self, embeddings, names: Sequence[str] | None = None,
                    clip_npz: str | None = None, bpe_path: str | None = None) -> "WorldModel":
        """embeddings: a (K, 512) array, or K class-name strings, which the
        CLIP text tower encodes given `clip_npz` (the ViT-B/32 text tower's
        torch-keyed npz) and `bpe_path` (CLIP's BPE merges file); without
        them strings raise, as JAX's do."""
        import numpy as np

        if isinstance(embeddings, (list, tuple)) and embeddings and isinstance(embeddings[0], str):
            texts = list(embeddings)
            if not (clip_npz and bpe_path):
                raise ValueError(
                    "set_classes(strings) needs clip_npz= (ViT-B/32 text npz) and "
                    "bpe_path= (bpe_simple_vocab_16e6.txt.gz); neither ships with the "
                    "package: pass precomputed (K, 512) embeddings instead")
            from edgeyolo_tpu_torch.nn.clip_text import ClipBPETokenizer, load_clip_text

            tower = load_clip_text(clip_npz, device=self.device)
            tokens = torch.from_numpy(ClipBPETokenizer(bpe_path).tokenize(texts))
            with torch.no_grad():
                embeddings = tower(tokens.to(self.device))
            names = names or texts
        t = embeddings if isinstance(embeddings, torch.Tensor) else torch.from_numpy(
            np.asarray(embeddings, np.float32))
        self.text = t.detach().to(self.device, torch.float32)[None]
        if names:
            self.names = dict(enumerate(names))
        self.nc = self.model[-1].nc = self.text.shape[1]
        return self

    def forward(self, x, **kwargs):
        text = self.text.to(self.dtype).expand(x.shape[0], -1, -1)
        return super().forward(x, text=text, **kwargs)


def is_world(model) -> bool:
    """Whether a model's head is YOLO-World's WorldDetect."""
    return isinstance(getattr(model, "model", [None])[-1], WorldDetect)


def build_model(cfg: str | dict, scale: str | None = None, **kwargs) -> DetectionModel:
    """The model of a spec: a WorldModel when its head is WorldDetect (JAX's
    facade probes the head's name for "World"), else a DetectionModel."""
    head = str(model_cfg(cfg, scale)["head"][-1][2])
    return (WorldModel if "World" in head else DetectionModel)(cfg, scale=scale, **kwargs)
