"""Command line: `edgeyolo-torch [TASK] MODE k=v ...` (edgeyolo_tpu/cfg/cli.py).

    edgeyolo-torch detect train data=dataset.yaml model=edgeline-yolo.yaml epochs=10
    edgeyolo-torch detect val model=runs/detect/train/best.pt data=dataset.yaml device=cpu
    edgeyolo-torch detect predict model=runs/detect/train/best.pt source=images/
    edgeyolo-torch detect track model=runs/detect/train/best.pt source=line.avi tracker=botsort.yaml
    edgeyolo-torch pose train data=pose.yaml model=yolo11n-pose.yaml epochs=10
    edgeyolo-torch obb val model=runs/obb/train/best.pt data=dota.yaml
    edgeyolo-torch classify train data=path/to/class_folders model=yolo11n-cls.yaml imgsz=224
    edgeyolo-torch detect export model=runs/detect/train/best.pt format=onnx imgsz=640
    edgeyolo-torch detect benchmark model=runs/detect/train/best.pt data=dataset.yaml imgsz=640
    edgeyolo-torch detect tune model=yolo11n.yaml data=dataset.yaml epochs=10 iterations=30

Also `help`, `version` and `cfg` (the defaults as JSON). Values are parsed
as Python literals where they are one (`epochs=10`, `half=True`), else kept
as strings; unknown keys raise with suggestions. `export` writes the
artifact (`format`: torch_export, stablehlo, jax_export, npz or onnx) and
prints its path; `benchmark` prints the format table (`imgsz`, `data`),
one JSON row a format. `tune` runs `iterations` (default 10) evolutionary
fits (engine/tuner.py) and prints the best hyperparameters and fitness.
"""

from __future__ import annotations

import ast
import json
import sys

from edgeyolo_tpu_torch.cfg import DEFAULT_CFG_DICT, MODES, TASKS, check_dict_alignment
from edgeyolo_tpu_torch.utils import LOGGER

CLI_HELP = f"""
    Usage: edgeyolo-torch TASK MODE ARGS

        TASK (optional): one of {sorted(TASKS)}
        MODE (required): one of ['benchmark', 'export', 'predict', 'track', 'train', 'tune', 'val']
        ARGS (optional): any number of 'arg=value' pairs overriding defaults.

    Examples:
        edgeyolo-torch detect train data=dataset.yaml model=edgeline-yolo.yaml epochs=10
        edgeyolo-torch detect val model=runs/detect/train/best.pt data=dataset.yaml
        edgeyolo-torch detect predict model=runs/detect/train/best.pt source=images/
        edgeyolo-torch detect track model=runs/detect/train/best.pt source=line.avi
        edgeyolo-torch detect export model=runs/detect/train/best.pt format=onnx
        edgeyolo-torch detect benchmark model=runs/detect/train/best.pt data=dataset.yaml
"""


def parse_key_value(pair: str) -> tuple[str, object]:
    """'k=v' with the value parsed as a literal where it is one."""
    k, v = pair.split("=", 1)
    k, v = k.strip(), v.strip()
    if v.lower() == "none":
        return k, None
    if v.lower() in ("true", "false"):
        return k, v.lower() == "true"
    try:
        return k, ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return k, v


def _say(text: str) -> None:
    print(text, flush=True)


def entrypoint(argv: list[str] | None = None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    if not args or args[0] in {"help", "-h", "--help"}:
        _say(CLI_HELP)
        return 0
    if args[0] in {"version", "-v", "--version"}:
        from edgeyolo_tpu_torch import __version__

        _say(__version__)
        return 0
    if args[0] == "cfg":
        _say(json.dumps(DEFAULT_CFG_DICT, indent=2, default=str))
        return 0
    task = mode = None
    overrides: dict = {}
    for a in args:
        if "=" in a:
            k, v = parse_key_value(a)
            if k != "iterations":  # the tune mode's own key, no cfg key
                check_dict_alignment(DEFAULT_CFG_DICT, {k: v})
            overrides[k] = v
        elif a in TASKS:
            task = a
        elif a in MODES:
            mode = a
        else:
            raise SyntaxError(f"'{a}' is not a valid task, mode or k=v pair.\n{CLI_HELP}")
    if mode is None:
        raise SyntaxError(f"a MODE is required: {sorted(MODES)}\n{CLI_HELP}")

    from edgeyolo_tpu_torch.engine.model import YOLO

    model = YOLO(overrides.pop("model", None) or "edgeline-yolo.yaml", task=task,
                 device=overrides.pop("device", None))
    if mode == "train":
        model.train(**overrides)
        _say(f"best fitness {model.trainer.best_fitness:.5g}, results in {model.trainer.save_dir}")
    elif mode == "val":
        metrics = model.val(**overrides)
        if model.task == "classify":
            _say(f"{'':>10}{'images':>8}{'top1':>11}{'top5':>11}")
        else:
            _say(f"{'':>10}{'images':>8}{'P':>11}{'R':>11}{'mAP50':>11}{'mAP75':>11}"
                 f"{'mAP50-95':>11}")
        _say(model.validator.results_line())
        for tag, row in (("M", "masks"), ("P", "pose")):  # a segment or a pose model's table
            if f"metrics/mAP50-95({tag})" in metrics:
                _say(f"{row:>10}{'':>30}{metrics[f'metrics/mAP50({tag})']:>11.3g}{'':>11}"
                     f"{metrics[f'metrics/mAP50-95({tag})']:>11.3g}")
        LOGGER.info(json.dumps(metrics))
    elif mode == "predict":
        source = overrides.pop("source", None)
        if source is None:
            raise SyntaxError("predict requires source=<path>")
        results = model.predict(source, **overrides)
        for r in results:
            if r.probs is not None:  # a classify result: its top-1 class and probability
                _say(f"{r.path}: {r.names.get(r.probs.top1, r.probs.top1)} "
                     f"{r.probs.top1conf:.3f}")
            else:
                _say(f"{r.path}: {r.verbose_str}")
        _say(f"{len(results)} images processed")
    elif mode == "export":
        _say(f"exported -> {model.export(**overrides)}")
    elif mode == "tune":
        best, fitness = model.tune(iterations=int(overrides.pop("iterations", 10)), **overrides)
        _say(f"best fitness {fitness:.5g}: {json.dumps(best)}")
    elif mode == "benchmark":
        for row in model.benchmark(**{k: v for k, v in overrides.items() if k in {"imgsz", "data"}}):
            _say(json.dumps(row))
    else:
        source = overrides.pop("source", None)
        if source is None:
            raise SyntaxError("track requires source=<path>")
        n = 0
        for r in model.track(source, **overrides):
            _say(f"{r.path}: ids {r.track_ids.tolist()}")
            n += 1
        _say(f"{n} frames tracked")
    return 0


if __name__ == "__main__":
    raise SystemExit(entrypoint())
