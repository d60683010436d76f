"""The YOLO facade (edgeyolo_tpu/engine/model.py): the detect, segment, pose,
obb and classify tasks.

    YOLO("edgeline-yolo.yaml")        # a model name (cfg/models.py), seeded weights
    YOLO("yolo11n-seg.yaml")          # a segment model (its head names the task)
    YOLO("yolo11n-pose.yaml")         # a pose model; "yolo11n-obb.yaml" an obb one
    YOLO("yolo11n-cls.yaml")          # a classify model (data: a folder-per-class root)
    RTDETR("rtdetr-l")                # an RT-DETR model (YOLO over it; no NMS)
    YOLOWorld("yolov8-worldv2.yaml")  # a YOLO-World model (its classes: set_classes)
    YOLO("runs/detect/train/best.pt") # a port checkpoint (train/trainer.py)

The task is the model's (a Segment, Pose, OBB or Classify head makes
"segment", "pose", "obb" or "classify"); `task=` may name it, and must
agree. Each task has its trainer, validator and predictor (`TASK_MAP`;
classify's are train/classify.py and engine/classify.py).

`train`, `val`, `predict` and `track` take the keys of cfg/__init__.py's
defaults (method kwargs > the handle's overrides > defaults). `train` on a
model with no trained weights rebuilds its head for the dataset's class
count (a classify dataset's class folders), and a pose head for the
dataset's `kpt_shape`. `add_callback` registers a hook for a trainer event
(utils/callbacks.py), which the next `train` runs; `reset_callbacks`
clears them. `fuse` folds the model's conv and BatchNorm pairs in place
(inference only; a saved fused model reloads fused), and `embed` returns
one pooled feature vector per image of the layers it taps. `export` writes
the model as a torch.export program, npz weights or ONNX (nn/autobackend.py
loads each), and `benchmark` times and validates each format. `predict` keeps
its predictor (and so its save directory) while the arguments stay the
same, as JAX's facade does; `track` runs it with a ByteTrack or BoT-SORT
tracker over the frames. Every mode runs on CUDA unless `device` names
another device ("cpu").
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from edgeyolo_tpu_torch.cfg import get_cfg, get_save_dir
from edgeyolo_tpu_torch.data.dataset import check_det_dataset
from edgeyolo_tpu_torch.data.letterbox import letterbox
from edgeyolo_tpu_torch.data.loaders import load_inference_source
from edgeyolo_tpu_torch.nn.tasks import build_model, for_precision, num_params, num_trainable
from edgeyolo_tpu_torch.utils import LOGGER, select_device
from edgeyolo_tpu_torch.utils.callbacks import EVENTS, get_default_callbacks

# task -> (validator, predictor) class names in engine/validator.py and engine/predictor.py,
# or in engine/classify.py for classify
TASK_MAP = {"detect": ("DetectionValidator", "DetectionPredictor"),
            "segment": ("SegmentationValidator", "SegmentationPredictor"),
            "pose": ("PoseValidator", "PosePredictor"),
            "obb": ("OBBValidator", "OBBPredictor"),
            "classify": ("ClassificationValidator", "ClassificationPredictor")}


def task_class(task: str, role: int):
    """TASK_MAP[task][role] (0: validator, 1: predictor) as a class."""
    if task == "classify":
        from edgeyolo_tpu_torch.engine import classify as module
    elif role == 0:
        from edgeyolo_tpu_torch.engine import validator as module
    else:
        from edgeyolo_tpu_torch.engine import predictor as module
    return getattr(module, TASK_MAP[task][role])


class YOLO:
    """User-facing handle over a DetectionModel (f32 parameters)."""

    def __init__(self, model: str | Path = "edgeline-yolo.yaml", task: str | None = None,
                 device: str | torch.device | None = None):
        if task not in (None, *TASK_MAP):
            raise ValueError(f"unknown task '{task}'; known: {sorted(TASK_MAP)}")
        self.overrides: dict = {}
        self.callbacks = get_default_callbacks()
        self.device = select_device(device)
        self.ckpt_path = None
        self.trained = False  # weights from training or a checkpoint, not a seeded init
        self.predictor, self._predictor_key, self._tracker = None, None, None
        model = str(model)
        if model.endswith(".pt"):
            self._load_checkpoint(model)
        else:
            self.model = build_model(model, device=self.device)
            self.model_name = model
        self.task = self.model.task
        if task not in (None, self.task):
            raise ValueError(f"{model} is a {self.task} model, not a {task} one")

    def _load_checkpoint(self, path: str):
        from edgeyolo_tpu_torch.train.trainer import load_checkpoint

        ck = torch.load(path, map_location="cpu", weights_only=True)
        meta = ck.get("meta") or {}
        side = Path(path).with_suffix(".json")
        if not meta and side.exists():
            meta = json.loads(side.read_text())
        self.model_name = meta.get("model_yaml") or "edgeline-yolo.yaml"
        self.model = build_model(self.model_name, scale=meta.get("scale") or None,
                                 nc=meta.get("nc"), kpt_shape=meta.get("kpt_shape"),
                                 device="cpu")
        if meta.get("fused"):
            self.model.fuse()
        load_checkpoint(self.model, path)
        self.model.to(self.device)
        self.ckpt_path, self.trained = path, True
        self.overrides.update({k: v for k, v in (meta.get("train_args") or {}).items()
                               if k in ("imgsz", "single_cls")})

    def _args(self, mode: str, kwargs: dict):
        kwargs = dict(kwargs)
        if "device" in kwargs:
            dev = kwargs.pop("device")
            if dev is not None and select_device(dev) != self.device:
                self.device = select_device(dev)
                self.model.to(self.device)
        return get_cfg(overrides={**self.overrides, "mode": mode, "task": self.task,
                                  "model": self.model_name, **kwargs})

    @property
    def names(self) -> dict:
        return self.model.names

    def info(self) -> dict:
        d = {"model": self.model_name, "scale": self.model.scale, "nc": self.model.nc,
             "params": num_params(self.model), "trained_params": num_trainable(self.model),
             "device": str(self.device)}
        LOGGER.info(", ".join(f"{k} {v}" for k, v in d.items()))
        return d

    def add_callback(self, event: str, fn) -> None:
        """Run fn(trainer) at `event` (one of utils/callbacks.py's EVENTS) in `train`."""
        if event not in EVENTS:
            raise KeyError(f"unknown callback event '{event}'; valid: {EVENTS}")
        self.callbacks[event].append(fn)

    def reset_callbacks(self) -> None:
        self.callbacks = get_default_callbacks()

    def train(self, **kwargs) -> float:
        """Train on `data` (a dataset YAML, or a classify dataset's root); the
        handle then holds the EMA weights."""
        from edgeyolo_tpu_torch.train.classify import ClassificationTrainer
        from edgeyolo_tpu_torch.train.trainer import DetectionTrainer

        args = self._args("train", kwargs)
        if not args.data:
            raise ValueError("train() requires data=<dataset.yaml>")
        if self.task == "classify":
            from edgeyolo_tpu_torch.data.classify import check_cls_dataset

            data_cfg = check_cls_dataset(args.data)
        else:
            data_cfg = check_det_dataset(args.data)
        nc = int(data_cfg["nc"])
        # a pose dataset's kpt_shape replaces the spec's (the reference PoseTrainer's)
        kpt = data_cfg.get("kpt_shape") if self.task == "pose" else None
        kpt = tuple(int(k) for k in kpt) if kpt else self.model.kpt_shape
        if not self.trained and (nc != self.model.nc or kpt != self.model.kpt_shape):
            LOGGER.info(f"rebuilding the model head for dataset nc={nc} (was {self.model.nc})"
                        + (f", kpt_shape={list(kpt)} (was {list(self.model.kpt_shape)})"
                           if kpt != self.model.kpt_shape else ""))
            self.model = build_model(self.model_name, scale=self.model.scale, nc=nc,
                                     kpt_shape=kpt, seed=int(args.seed), device=self.device)
        if args.resume is True:  # continue in the run's own directory, from its last.pt
            save_dir = Path(args.project or Path("runs") / args.task) / (args.name or "train")
        else:
            save_dir = get_save_dir(args, name=args.name or "train")
        trainer_cls = ClassificationTrainer if self.task == "classify" else DetectionTrainer
        self.trainer = trainer_cls(self.model, args, device=self.device, save_dir=save_dir,
                                   callbacks=self.callbacks)
        best = self.trainer.fit()
        self.model.eval()
        self.trained = True
        self.predictor = None  # its model may be a bf16 copy of the old weights
        self.overrides["imgsz"] = args.imgsz
        return best

    def val(self, **kwargs) -> dict:
        """Validate on `data`'s val split; returns the metrics dict."""
        args = self._args("val", kwargs)
        if not args.data:
            raise ValueError("val() requires data=<dataset.yaml>")
        self.validator = task_class(self.task, 0)(args, save_dir=get_save_dir(args, name=args.name or "val"),
                              device=self.device)
        return self.validator(self.model)

    def predict(self, source, stream: bool = False, **kwargs):
        """Results for each frame of `source` (a generator with `stream`)."""
        args = self._args("predict", kwargs)
        key = (repr(sorted(vars(args).items())), id(self.model), str(self.device))
        if self.predictor is None or key != self._predictor_key:
            model = for_precision(self.model.eval(), bool(args.half))
            common = {"device": self.device, "imgsz": int(args.imgsz), "batch": int(args.batch),
                      "verbose": bool(args.verbose), "vid_stride": int(args.vid_stride),
                      "stream_buffer": bool(args.stream_buffer)}
            if self.task == "classify":  # probabilities: no NMS, boxes or drawings
                self.predictor = task_class(self.task, 1)(model, **common)
            else:
                self.predictor = task_class(self.task, 1)(
                    model, conf=args.conf if args.conf is not None else 0.25,
                    iou=float(args.iou), max_det=int(args.max_det), classes=args.classes,
                    agnostic=bool(args.agnostic_nms), save_txt=bool(args.save_txt),
                    save_conf=bool(args.save_conf),
                    save_dir=get_save_dir(args, name=args.name or "predict"),
                    save=bool(args.save), augment=bool(args.augment),
                    visualize=bool(args.visualize), line_width=args.line_width,
                    show_labels=bool(args.show_labels), show_conf=bool(args.show_conf),
                    show=bool(args.show), **common)
            self._predictor_key = key
        predictor = self.predictor
        return predictor.stream(source) if stream else predictor.predict(source)

    def track(self, source, persist: bool = False, **kwargs):
        """Tracked Results for each frame of `source` (a generator): `predict`
        with conf 0.1 unless given, through a tracker from `tracker`
        ("bytetrack", "botsort" or a tracker YAML; default "bytetrack").
        persist=True keeps the tracker, and its ids, across calls (the
        frame-by-frame `for f in frames: model.track(f, persist=True)`)."""
        from edgeyolo_tpu_torch.trackers.track import make_tracker, track_stream

        kwargs.setdefault("conf", 0.1)
        cfg = kwargs.pop("tracker", "bytetrack")
        if not persist or self._tracker is None:
            self._tracker = make_tracker(cfg)
        results = self.predict(source, stream=True, **kwargs)
        return track_stream(results, tracker=self._tracker)

    def __call__(self, source, **kwargs):
        return self.predict(source, **kwargs)

    def fuse(self) -> "YOLO":
        """Fold every conv and BatchNorm pair of the f32 model in place
        (DetectionModel.fuse), before any bf16 copy is made of it."""
        self.model.fuse()
        self.predictor = None  # it may hold a copy of the unfused weights
        return self

    def embed(self, source, stream: bool = False, **kwargs):
        """One f32 feature vector per frame of `source` (a generator with
        `stream`), on the model's device: the global average pool of each
        layer in `embed` (default: the second to last), concatenated in layer
        order, of the f32 model on the frame letterboxed to `imgsz` (scaleup)."""
        args = self._args("predict", kwargs)
        layers = tuple(args.embed or [len(self.model.layers) - 2])
        model = self.model.eval()
        loader, _ = load_inference_source(source, vid_stride=int(args.vid_stride),
                                          stream_buffer=bool(args.stream_buffer))

        def gen():
            for _path, img0 in loader:
                img, _r, _pads = letterbox(img0, int(args.imgsz), scaleup=True)
                x = torch.from_numpy(img).to(self.device).permute(2, 0, 1)[None].float() / 255
                with torch.inference_mode():
                    vec = model(x, embed=layers)[0]
                yield vec

        return gen() if stream else list(gen())

    def export(self, **kwargs) -> str:
        """Export the model (`format`: export/exporter.py's EXPORT_FORMATS, default
        stablehlo, the .pt2 program and its printed graph) into
        `project`/`name` (default `name` "export"), or runs/export without a
        project; returns the artifact's path."""
        from edgeyolo_tpu_torch.export.exporter import Exporter

        args = self._args("export", kwargs)
        out_dir = (Path(args.project) / (args.name or "export") if args.project
                   else Path("runs/export"))
        return Exporter(args)(self.model, out_dir=out_dir)

    def benchmark(self, **kwargs) -> list[dict]:
        """The format x (ms, imgs/s [, mAP50-95]) table (utils/benchmarks.py)."""
        from edgeyolo_tpu_torch.utils.benchmarks import benchmark

        return benchmark(self, **kwargs)

    def save(self, filename: str | Path = "model.pt") -> Path:
        """A standalone checkpoint that YOLO(<path>) reloads."""
        dst = Path(filename)
        dst.parent.mkdir(parents=True, exist_ok=True)
        sd = {k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()}
        kpt = self.model.kpt_shape
        meta = {"epoch": -1, "best_fitness": 0.0, "model_yaml": self.model_name, "task": self.task,
                "scale": self.model.scale, "nc": self.model.nc, "names": dict(self.model.names),
                "kpt_shape": list(kpt) if kpt else None, "train_args": {},
                "fused": bool(getattr(self.model, "fused", False))}
        torch.save({"model": sd, "ema": sd, "meta": meta}, dst)
        dst.with_suffix(".json").write_text(json.dumps(meta, default=str))
        return dst

    def load(self, weights: str | Path) -> "YOLO":
        """Load a port checkpoint's weights into the current architecture,
        keeping only the tensors whose name and shape match."""
        ck = torch.load(weights, map_location="cpu", weights_only=True)
        donor = ck.get("ema") or ck["model"]
        if (ck.get("meta") or {}).get("fused") and not self.model.fused:
            self.model.fuse()  # the donor's convs carry its BatchNorms
        cur = self.model.state_dict()
        keep = {k: v for k, v in donor.items() if k in cur and cur[k].shape == v.shape}
        self.model.load_state_dict(keep, strict=False)
        LOGGER.info(f"load: transferred {len(keep)} tensors, kept {len(cur) - len(keep)}")
        self.trained = True
        self.predictor = None
        return self


def RTDETR(model: str | Path = "rtdetr-l", **kwargs) -> YOLO:
    """YOLO over an RT-DETR model (JAX's `edgeyolo_tpu.RTDETR`)."""
    return YOLO(model, **kwargs)


def YOLOWorld(model: str | Path = "yolov8-worldv2.yaml", **kwargs) -> YOLO:
    """YOLO over a YOLO-World model (JAX's `edgeyolo_tpu.YOLOWorld`): set its
    classes with `.model.set_classes(embeddings, names=...)`."""
    return YOLO(model, **kwargs)
