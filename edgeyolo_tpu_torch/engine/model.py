"""The YOLO facade (edgeyolo_tpu/engine/model.py): the detect, segment, pose,
obb and classify tasks.

    YOLO("edgeline-yolo.yaml")        # a model name (cfg/models.py), seeded weights
    YOLO("yolo11n-seg.yaml")          # a segment model (its head names the task)
    YOLO("yolo11n-pose.yaml")         # a pose model; "yolo11n-obb.yaml" an obb one
    YOLO("yolo11n-cls.yaml")          # a classify model (data: a folder-per-class root)
    RTDETR("rtdetr-l")                # an RT-DETR model (YOLO over it; no NMS)
    YOLOWorld("yolov8-worldv2.yaml")  # a YOLO-World model (its classes: set_classes)
    YOLO("runs/detect/train/best.pt") # a port checkpoint (train/trainer.py)
    YOLO("runs/detect/train/last.msgpack")  # a JAX checkpoint (its .json sidecar beside it)

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

A JAX checkpoint (`.msgpack`, from JAX's trainer or `YOLO.save`) is read by
the port's own decoder (utils/msgpack.py): the sidecar names the model
(`model_yaml` or an embedded `model_cfg`, `scale`, `nc`, `task`, `names`),
the EMA weights and BatchNorm statistics load through `from_jax_variables`.
`load` takes a `.pt` or a `.msgpack` donor (the tensors whose name and shape
match). `save_pretrained(dir)` writes `model.pt`, `model.json`,
`config.json` and a README card; `from_pretrained(dir)` reads such a
directory, or a JAX `save_pretrained` one (`model.msgpack`); a Hub repo id
needs `huggingface_hub`. `tune` runs the evolutionary hyperparameter search
(engine/tuner.py) over fresh models of the same spec. `int8=True` in `val`
and `predict` runs the int8 forward (nn/quant.py).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from edgeyolo_tpu_torch.cfg import get_cfg, get_save_dir
from edgeyolo_tpu_torch.cfg.models import MODELS_DIR
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
        elif model.endswith(".msgpack"):
            self._load_msgpack(model, task)
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
        self.model = build_model(meta.get("model_cfg") or self.model_name,
                                 scale=meta.get("scale") or None,
                                 nc=meta.get("nc"), kpt_shape=meta.get("kpt_shape"),
                                 device="cpu")
        if meta.get("fused"):
            self.model.fuse()
        load_checkpoint(self.model, path)
        self.model.to(self.device)
        self.ckpt_path, self.trained = path, True
        self.overrides.update({k: v for k, v in (meta.get("train_args") or {}).items()
                               if k in ("imgsz", "single_cls")})

    def _load_msgpack(self, path: str, task: str | None):
        """A JAX trainer checkpoint or `YOLO.save` file and its .json sidecar."""
        side = Path(path).with_suffix(".json")
        if not side.exists():
            raise FileNotFoundError(f"checkpoint metadata {side} not found")
        meta = json.loads(side.read_text())
        name = meta.get("model_yaml") or "yolo11n.yaml"
        # JAX records its own YAML's path: a bundled model reads the port's copy
        self.model_name = Path(name).name if (MODELS_DIR / Path(name).name).is_file() else name
        self.model = build_model(meta.get("model_cfg") or self.model_name,
                                 scale=meta.get("scale") or None, nc=meta.get("nc"),
                                 device="cpu")
        want = task or meta.get("task") or (meta.get("train_args") or {}).get("task")
        if want not in (None, self.model.task):
            raise ValueError(f"{path} holds a {self.model.task} model, not a {want} one")
        missing, unexpected = self.model.load_state_dict(msgpack_state_dict(path), strict=False)
        frozen = {n for n, p in self.model.named_parameters() if not p.requires_grad}
        left = [k for k in missing if k not in frozen and not k.endswith("num_batches_tracked")]
        if unexpected or left:  # JAX computes the frozen DFL bins; nothing else may be absent
            raise KeyError(f"{path} does not fit {self.model_name}: missing {left[:5]}, "
                           f"unexpected {unexpected[:5]}")
        if meta.get("names"):
            self.model.names = {int(k): v for k, v in meta["names"].items()}
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
        handle then holds the EMA weights. `pretrained=<path>` (a .pt or a JAX
        .msgpack) first loads that checkpoint's matching tensors, as JAX's does."""
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
        pre = args.pretrained  # a path seeds the model with its weights (shape-intersected)
        if isinstance(pre, (str, Path)) and str(pre) not in ("True", "False", ""):
            LOGGER.info(f"loading pretrained weights from {pre}")
            self.load(pre)
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
                    show=bool(args.show), int8=bool(args.int8), **common)
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
        cfg = self.model.cfg if isinstance(self.model.cfg, dict) else None
        meta = {"epoch": -1, "best_fitness": 0.0, "model_yaml": "" if cfg else self.model_name,
                "model_cfg": cfg, "task": self.task,
                "scale": self.model.scale, "nc": self.model.nc, "names": dict(self.model.names),
                "kpt_shape": list(kpt) if kpt else None, "train_args": {},
                "fused": bool(getattr(self.model, "fused", False))}
        torch.save({"model": sd, "ema": sd, "meta": meta}, dst)
        dst.with_suffix(".json").write_text(json.dumps(meta, default=str))
        return dst

    def load(self, weights: str | Path) -> "YOLO":
        """Load a port checkpoint's weights (or a JAX `.msgpack`'s EMA weights
        and BatchNorm statistics) into the current architecture, keeping only
        the tensors whose name and shape match."""
        if str(weights).endswith(".msgpack"):
            donor = msgpack_state_dict(weights)
        else:
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


    # -- the local halves of the Hub interop ------------------------------------
    def save_pretrained(self, save_directory: str | Path, card: bool = True) -> Path:
        """A Hub-layout snapshot in a local directory: model.pt with its
        model.json sidecar, config.json and a README model card."""
        save_dir = Path(save_directory)
        save_dir.mkdir(parents=True, exist_ok=True)
        self.save(save_dir / "model.pt")
        meta = json.loads((save_dir / "model.json").read_text())
        (save_dir / "config.json").write_text(
            json.dumps({"library_name": "edgeyolo_tpu_torch", **meta}, default=str))
        if card and not (save_dir / "README.md").exists():
            (save_dir / "README.md").write_text(
                f"---\nlibrary_name: edgeyolo_tpu_torch\npipeline_tag: object-detection\n"
                f"tags:\n- {self.task}\n- pytorch\n---\n\n"
                f"# {Path(str(self.model_name)).stem}\n\n"
                f"edgeyolo_tpu_torch {self.task} model ({self.model.nc} classes). Load with\n"
                f"`YOLO.from_pretrained(\"<dir>\")`.\n")
        return save_dir

    @classmethod
    def from_pretrained(cls, repo_id: str | Path, task: str | None = None,
                        device: str | torch.device | None = None, revision: str | None = None,
                        **download_kwargs) -> "YOLO":
        """A local `save_pretrained` directory, the port's (model.pt) or JAX's
        (model.msgpack), or a Hub repo id through huggingface_hub."""
        p = Path(repo_id)
        if not p.is_dir():
            try:
                from huggingface_hub import snapshot_download
            except ImportError as e:
                raise ImportError(
                    "from_pretrained with a repo id requires the huggingface_hub "
                    "package (probed, not importable); pass a local directory instead"
                ) from e
            p = Path(snapshot_download(str(repo_id), revision=revision, **download_kwargs))
        cfg_p = p / "config.json"
        cfg = json.loads(cfg_p.read_text()) if cfg_p.exists() else {}
        weights = p / "model.pt" if (p / "model.pt").exists() else p / "model.msgpack"
        return cls(weights, task=task or cfg.get("task"), device=device)

    def tune(self, iterations: int = 10, rng=None, **kwargs):
        """Evolutionary hyperparameter search (engine/tuner.py): `iterations`
        fits of fresh models of this spec with mutated hyperparameters, each
        `train(**kwargs, **hyp)`, the first with the call's own values of the
        searched keys (their defaults where the call names none); results under
        `project`/tune (runs/<task>/tune without a project). `rng` is the
        mutations' np.random.Generator.
        Returns (best hyperparameters, best fitness)."""
        from edgeyolo_tpu_torch.engine.tuner import Tuner

        model, device = self.model, self.device

        def factory() -> YOLO:
            y = YOLO.__new__(YOLO)
            y.overrides, y.callbacks, y.device = dict(self.overrides), self.callbacks, device
            y.ckpt_path, y.trained, y.model_name, y.task = None, False, self.model_name, self.task
            y.predictor, y._predictor_key, y._tracker = None, None, None
            y.model = build_model(model.cfg, scale=model.scale, nc=model.nc,
                                  kpt_shape=model.kpt_shape, device=device)
            y.model.names = dict(model.names)
            return y

        args = get_cfg(overrides={**kwargs, "mode": "train", "task": self.task})
        # the search starts from this call's hyperparameters, as the reference's
        # Tuner does (JAX's starts from the defaults)
        return Tuner(vars(args), save_dir=get_save_dir(args, name="tune"), rng=rng)(
            factory, iterations=iterations, **kwargs)


def msgpack_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """A JAX checkpoint's EMA weights and BatchNorm statistics as the port's
    state_dict (no DFL bins: JAX computes them)."""
    from edgeyolo_tpu_torch.utils.convert import from_jax_variables
    from edgeyolo_tpu_torch.utils.msgpack import flatten, restore

    ck = restore(Path(path).read_bytes())
    flat = flatten({"params": ck["ema"], "batch_stats": ck.get("batch_stats") or {}})
    return from_jax_variables({k: v.float().numpy() if isinstance(v, torch.Tensor) else v
                               for k, v in flat.items()})


def RTDETR(model: str | Path = "rtdetr-l", **kwargs) -> YOLO:
    """YOLO over an RT-DETR model (JAX's `edgeyolo_tpu.RTDETR`)."""
    return YOLO(model, **kwargs)


def YOLOWorld(model: str | Path = "yolov8-worldv2.yaml", **kwargs) -> YOLO:
    """YOLO over a YOLO-World model (JAX's `edgeyolo_tpu.YOLOWorld`): set its
    classes with `.model.set_classes(embeddings, names=...)`."""
    return YOLO(model, **kwargs)
