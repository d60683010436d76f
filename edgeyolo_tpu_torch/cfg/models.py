"""Model specs: the port's own copies of the JAX package's model YAMLs.

`cfg/models/*.yaml` are byte-identical copies of the files of the same name
in edgeyolo_tpu/cfg/models/ for the families the port builds (EdgeLine-YOLO
and its variants, the YOLO11 ablation family, YOLOv13 and its MSLA, LGL,
wavelet and NMS-free variants, YOLOv10, YOLOv12, YOLOv3/5/6/8 with their
P2, P6, SPP, tiny and Ghost variants, YOLOv9, and the segment, pose and obb
YAMLs), read with the port's YAML subset
reader: [from, repeats, module, args] rows, compound scales [depth, width,
max_channels]. A per-size file (yolov10s.yaml, yolov12x.yaml) is what its
own name resolves to. The reference fork's EdgeLine-YOLO-n has 2,678,699
parameters.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path

from edgeyolo_tpu_torch.utils.yamlfile import yaml_load

MODELS_DIR = Path(__file__).resolve().parent / "models"
MODELS = tuple(sorted(p.stem for p in MODELS_DIR.glob("*.yaml")))


def _file_scale(stem: str) -> str:
    """The scale a model file's name carries, as the JAX package guesses it
    (yolo11n -> n); "" when it names none."""
    m = re.search(r"yolo[v]?\d+([nslmx])", stem)
    return m.group(1) if m else ""


def model_cfg(name: str | Path | dict, scale: str | None = None) -> dict:
    """The spec for a model name or a model YAML file, with its scale resolved.

    Names resolve against the bundled copies: "yolo11n", "yolo11n.yaml",
    "yolov13-dsc3k2-msla-n" or "yolo11.yaml" with scale="n" all give scale n,
    "yolo11n-seg" is yolo11-seg.yaml at scale n, and a file without a scales
    table takes the scale its name carries (yolov9s: s), as JAX names it;
    with no scale anywhere the first entry of the scales table is used, as
    the JAX package does. An existing file is read as it is, its scale from
    `scale`, its own `scale` key or its name. A spec dict (what a YAML file
    reads to) is taken as it is, copied, its scale from `scale` or its own
    `scale` key.
    """
    if isinstance(name, dict):
        return _with_scale(copy.deepcopy(name), "spec", "spec", name.get("scale") or "", scale)
    path = Path(str(name))
    stem = re.sub(r"\.ya?ml$", "", path.name)
    if path.suffix in (".yaml", ".yml") and path.is_file():
        d = yaml_load(path)
        base, named = stem, d.get("scale") or _file_scale(stem)
    else:
        base, named = stem, ""
        if stem not in MODELS:
            m = re.match(r"^(.*yolov?\d+)([nslmx])([-_].+)?$", stem)  # yolo11n-seg: yolo11-seg, n
            if m and m.group(1) + (m.group(3) or "") in MODELS:
                base, named = m.group(1) + (m.group(3) or ""), m.group(2)
            else:
                m = re.match(r"^(.*?)-?([nslmx])$", stem)
                if not m or m.group(1) not in MODELS:
                    raise KeyError(f"unknown model '{name}'; known: {list(MODELS)}")
                base, named = m.groups()
        d = yaml_load(MODELS_DIR / f"{base}.yaml")
        if not d.get("scales"):  # a file of one size (yolov9s): the scale its name carries
            named = named or _file_scale(base)
    return _with_scale(d, name, base, named, scale)


def _with_scale(d: dict, name, base: str, named: str, scale: str | None) -> dict:
    """Spec `d` with its scale resolved: `scale`, else the one its name or
    file names, else the first of its scales table."""
    if scale and named and scale != named:
        raise ValueError(f"model '{name}' names scale {named}, but scale={scale!r} was passed")
    d["scale"] = scale or named or next(iter(d.get("scales") or {""}))
    if d.get("scales") and d["scale"] not in d["scales"]:
        raise KeyError(f"unknown scale '{d['scale']}' for {base}; known: {sorted(d['scales'])}")
    return d
