"""Run configuration (edgeyolo_tpu/cfg/__init__.py and cfg/default.yaml).

`DEFAULT_CFG_DICT` is edgeyolo_tpu/cfg/default.yaml transcribed as a Python
literal (the port reads no YAML for its own defaults); a test holds it
equal to that file key by key. `get_cfg` merges defaults < cfg < overrides,
rejects unknown keys with did-you-mean suggestions and checks the types of
the typed keys; `get_save_dir` picks {project}/{name}, incremented.
"""

from __future__ import annotations

import difflib
import os
from pathlib import Path
from types import SimpleNamespace
from typing import Any

from edgeyolo_tpu_torch.utils.yamlfile import yaml_load

TASKS = frozenset({"detect", "segment", "classify", "pose", "obb"})
MODES = frozenset({"train", "val", "predict", "export", "track", "benchmark", "tune"})

DEFAULT_CFG_DICT: dict[str, Any] = {
    'task': 'detect', 'mode': 'train', 'model': None, 'data': None, 'epochs': 100, 'time': None,
    'patience': 100, 'batch': 16, 'imgsz': 640, 'save': True, 'save_period': -1, 'cache': False,
    'device': None, 'fsdp': 0, 'workers': 8, 'project': None, 'name': None, 'exist_ok': False,
    'pretrained': True, 'optimizer': 'auto', 'verbose': True, 'seed': 0, 'deterministic': True,
    'single_cls': False, 'rect': False, 'cos_lr': False, 'close_mosaic': 10, 'resume': False,
    'amp': True, 'fraction': 1.0, 'profile': False, 'freeze': None, 'multi_scale': False,
    'overlap_mask': True, 'mask_ratio': 4, 'dropout': 0.0, 'val': True, 'split': 'val',
    'save_json': False, 'save_hybrid': False, 'conf': None, 'iou': 0.7, 'max_det': 300,
    'half': False, 'dnn': False, 'plots': True, 'source': None, 'vid_stride': 1,
    'stream_buffer': False, 'visualize': False, 'augment': False, 'agnostic_nms': False,
    'classes': None, 'retina_masks': False, 'embed': None, 'show': False, 'save_frames': False,
    'save_txt': False, 'save_conf': False, 'save_crop': False, 'show_labels': True,
    'show_conf': True, 'show_boxes': True, 'line_width': None, 'format': 'stablehlo',
    'keras': False, 'optimize': False, 'int8': False, 'dynamic': False, 'simplify': True,
    'opset': None, 'workspace': None, 'nms': False, 'lr0': 0.01, 'lrf': 0.01, 'momentum': 0.937,
    'weight_decay': 0.0005, 'warmup_epochs': 3.0, 'warmup_momentum': 0.8, 'warmup_bias_lr': 0.0,
    'box': 7.5, 'cls': 0.5, 'dfl': 1.5, 'pose': 12.0, 'kobj': 1.0, 'nbs': 64, 'hsv_h': 0.015,
    'hsv_s': 0.7, 'hsv_v': 0.4, 'degrees': 0.0, 'translate': 0.1, 'scale': 0.5, 'shear': 0.0,
    'perspective': 0.0, 'flipud': 0.0, 'fliplr': 0.5, 'bgr': 0.0, 'photometric': 1.0,
    'mosaic': 1.0, 'mixup': 0.0, 'copy_paste': 0.0, 'copy_paste_mode': 'flip',
    'auto_augment': 'randaugment', 'erasing': 0.4, 'crop_fraction': 1.0, 'cfg': None,
    'tracker': 'botsort.yaml',
}

# type contracts of config keys (check_cfg)
CFG_FLOAT_KEYS = frozenset({"warmup_epochs", "box", "cls", "dfl", "degrees", "shear", "time",
                            "workspace", "batch"})
CFG_FRACTION_KEYS = frozenset({
    "dropout", "lr0", "lrf", "momentum", "weight_decay", "warmup_momentum", "warmup_bias_lr",
    "hsv_h", "hsv_s", "hsv_v", "translate", "scale", "perspective", "flipud", "fliplr", "bgr",
    "mosaic", "mixup", "copy_paste", "conf", "iou", "fraction", "erasing", "crop_fraction",
    "photometric",
})
CFG_INT_KEYS = frozenset({
    "epochs", "patience", "workers", "seed", "close_mosaic", "mask_ratio", "max_det",
    "vid_stride", "line_width", "nbs", "save_period", "opset", "fsdp",
})
CFG_BOOL_KEYS = frozenset({
    "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect", "cos_lr",
    "overlap_mask", "val", "save_json", "save_hybrid", "half", "dnn", "plots", "show",
    "save_txt", "save_conf", "save_crop", "save_frames", "show_labels", "show_conf",
    "visualize", "augment", "agnostic_nms", "retina_masks", "show_boxes", "keras",
    "optimize", "int8", "dynamic", "simplify", "nms", "profile", "multi_scale", "amp",
})


class IterableSimpleNamespace(SimpleNamespace):
    """A SimpleNamespace that iterates over its items and has `.get`."""

    def __iter__(self):
        return iter(vars(self).items())

    def get(self, key, default=None):
        return getattr(self, key, default)


def cfg2dict(cfg: str | Path | dict | SimpleNamespace) -> dict:
    if isinstance(cfg, (str, Path)):
        return yaml_load(cfg)
    if isinstance(cfg, SimpleNamespace):
        return vars(cfg)
    return dict(cfg)


def check_dict_alignment(base: dict, custom: dict) -> None:
    """Raise SyntaxError with did-you-mean suggestions for keys of `custom` not in `base`."""
    mismatched = [k for k in custom if k not in base]
    if mismatched:
        msgs = []
        for k in mismatched:
            matches = difflib.get_close_matches(k, list(base), n=3, cutoff=0.5)
            matches = [f"{m}={base[m]}" if base.get(m) is not None else m for m in matches]
            hint = f"Similar arguments: {matches}. " if matches else ""
            msgs.append(f"'{k}' is not a valid argument. {hint}")
        raise SyntaxError("\n".join(msgs))


def check_cfg(cfg: dict) -> None:
    """Check the types and ranges of the typed keys."""
    for k, v in cfg.items():
        if v is None:
            continue
        if (k in CFG_FLOAT_KEYS or k in CFG_FRACTION_KEYS) and not isinstance(v, (int, float)):
            raise TypeError(f"'{k}={v}' must be a number (got {type(v).__name__})")
        if k in CFG_FRACTION_KEYS and not 0.0 <= v <= 1.0:
            raise ValueError(f"'{k}={v}' must be in [0, 1]")
        if k in CFG_INT_KEYS and not isinstance(v, int):
            raise TypeError(f"'{k}={v}' must be an int (got {type(v).__name__})")
        if k in CFG_BOOL_KEYS and not isinstance(v, bool):
            raise TypeError(f"'{k}={v}' must be a bool (got {type(v).__name__})")


def get_cfg(cfg: str | Path | dict | SimpleNamespace | None = None,
            overrides: dict | None = None) -> IterableSimpleNamespace:
    """Defaults < cfg < overrides, as a namespace; unknown override keys raise."""
    cfg = cfg2dict(cfg) if cfg is not None else dict(DEFAULT_CFG_DICT)
    merged = {**DEFAULT_CFG_DICT, **cfg}
    if overrides:
        overrides = cfg2dict(overrides)
        overrides.pop("save_dir", None)
        check_dict_alignment(merged, overrides)
        merged = {**merged, **overrides}
    for k in ("project", "name"):
        if k in merged and isinstance(merged[k], (int, float)):
            merged[k] = str(merged[k])
    if merged.get("name") == "model" and merged.get("model"):
        merged["name"] = str(merged["model"]).rpartition(".")[0]
    check_cfg(merged)
    return IterableSimpleNamespace(**merged)


def increment_path(path: str | Path, exist_ok: bool = False) -> Path:
    """runs/exp -> runs/exp2, runs/exp3, ... unless it is free or `exist_ok`."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{n}{suffix}"
            if not os.path.exists(p):
                return Path(p)
    return path


def get_save_dir(args: SimpleNamespace, name: str | None = None) -> Path:
    """The run's output directory: {project}/{name}, incremented if it exists."""
    project = args.project or Path("runs") / args.task
    name = name or args.name or f"{args.mode}"
    return increment_path(Path(project) / name, exist_ok=getattr(args, "exist_ok", False))
