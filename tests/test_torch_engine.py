"""The trainer's dataset loop, checkpoints, the run configuration, the YOLO
facade and the CLI of the PyTorch port, on the CPU (its AMP forward is
tests/test_torch_amp.py).

- Configuration: DEFAULT_CFG_DICT equal to yaml.safe_load of
  edgeyolo_tpu/cfg/default.yaml, key by key; get_cfg equal to JAX's.
- The facade, one training run: EdgeLine-YOLO-n with a 3-class head,
  2 epochs on 4 synthetic 64 px images at batch 2 and nbs 6 (three
  micro-steps per update, two per epoch), augmentation off, validation
  each epoch, a checkpoint every epoch. Then:
  - best.pt reloads to the trainer's best-epoch metrics (1e-6);
  - best.pt's EMA state_dict through edgeyolo_tpu/utils/torch_convert.py's
    convert_state_dict into the JAX flagship, validated by JAX's
    DetectionValidator on the same PNG dataset: metrics equal to the port's
    validator's (1e-6);
  - a run resumed from epoch0.pt, which ends mid-accumulation: the same
    epoch-1 losses and final params, EMA, BatchNorm statistics and
    accumulated gradient as the unbroken run (1e-6);
  - `edgeyolo-torch detect val ...` from the command line prints the
    results line with the mAP75 column; predict gives Results per image.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from edgeyolo_tpu.cfg import get_cfg as jget_cfg
from edgeyolo_tpu.engine.validator import DetectionValidator as JValidator
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.utils.torch_convert import convert_state_dict
from edgeyolo_tpu_torch.cfg import DEFAULT_CFG_DICT, get_cfg, get_save_dir
from edgeyolo_tpu_torch.cfg.cli import entrypoint, parse_key_value
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.nn.modules.edgeline import WaveletEnhancer
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

REPO = Path(__file__).resolve().parents[1]
DEFAULT_YAML = yaml.safe_load((REPO / "edgeyolo_tpu" / "cfg" / "default.yaml").read_text())
S = 64
AUG_OFF = {"mosaic": 0.0, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "degrees": 0.0,
           "translate": 0.0, "scale": 0.0, "shear": 0.0, "perspective": 0.0, "flipud": 0.0,
           "fliplr": 0.0, "bgr": 0.0, "photometric": 0.0, "mixup": 0.0}


def _exercised(nc=3, seed=0):
    """A model whose every branch counts: wavelet gates open, class logits at
    0 (scores above the val gate), BatchNorm affine parameters moved off 1/0."""
    m = DetectionModel("edgeline-yolo.yaml", device="cpu", seed=seed,
                       **({"nc": nc} if nc != 80 else {}))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, WaveletEnhancer):
                mod.gamma.fill_(0.5)
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.add_(torch.randn(mod.weight.shape, generator=g) * 0.1)
                mod.bias.add_(torch.randn(mod.bias.shape, generator=g) * 0.1)
        for seq in m.model[-1].cv3:
            seq[-1].bias.zero_()
    return m


def _jax_variables(sd: dict, nc: int):
    """The JAX flagship for a port state_dict: spec, abstract init (no
    compile) as the template, then convert_state_dict."""
    d = dict(jtasks.yaml_model_load("edgeline-yolo.yaml"))
    d["nc"] = nc
    jm = jtasks.DetectionModel(d)
    shapes = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, rep = convert_state_dict({k: v.numpy() for k, v in sd.items()}, template,
                                        strict=True)
    assert rep["unused"] == ["model.23.dfl.conv.weight"]
    jm.variables = jax.tree.map(jnp.asarray, variables)
    return jm


# -- configuration --------------------------------------------------------------------
@pytest.mark.parametrize("key", list(DEFAULT_YAML))
def test_default_cfg_literal_equals_the_jax_yaml(key):
    assert key in DEFAULT_CFG_DICT and DEFAULT_CFG_DICT[key] == DEFAULT_YAML[key]
    assert type(DEFAULT_CFG_DICT[key]) is type(DEFAULT_YAML[key])


def test_default_cfg_has_no_extra_keys():
    assert list(DEFAULT_CFG_DICT) == list(DEFAULT_YAML)


@pytest.mark.parametrize("overrides", [
    {"epochs": 3, "lr0": 0.02, "name": 5}, {"mode": "val", "conf": 0.001, "half": True},
    {"model": "edgeline-yolo.yaml", "name": "model"},
])
def test_get_cfg_equals_jax(overrides):
    assert vars(get_cfg(overrides=overrides)) == vars(jget_cfg(overrides=overrides))


def test_get_cfg_checks(tmp_path):
    with pytest.raises(SyntaxError, match="lr0"):
        get_cfg(overrides={"lr00": 0.1})
    with pytest.raises(TypeError):
        get_cfg(overrides={"epochs": "ten"})
    with pytest.raises(ValueError):
        get_cfg(overrides={"iou": 1.5})
    args = get_cfg(overrides={"project": str(tmp_path), "name": "run"})
    first = get_save_dir(args)
    first.mkdir()
    assert first == tmp_path / "run" and get_save_dir(args) == tmp_path / "run2"
    assert parse_key_value("a=1e-3") == ("a", 1e-3) and parse_key_value("b=x.yaml") == ("b", "x.yaml")
    assert parse_key_value("c=none") == ("c", None) and parse_key_value("d=True") == ("d", True)


def test_cli_help_version_and_cfg(capsys):
    assert entrypoint(["help"]) == 0 and "edgeyolo-torch" in capsys.readouterr().out
    assert entrypoint(["version"]) == 0 and capsys.readouterr().out.strip()
    assert entrypoint(["cfg"]) == 0 and '"lr0": 0.01' in capsys.readouterr().out
    with pytest.raises(SyntaxError):
        entrypoint(["detect", "val", "epoch=3"])
    with pytest.raises(SyntaxError):
        entrypoint(["detect", "epochs=3"])


def test_entry_points_run_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        YOLO("edgeline-yolo.yaml")


# -- the facade: one training run -----------------------------------------------------
# batch 2 and nbs 6: three micro-steps per update over two per epoch, so epoch 0 ends
# mid-accumulation and the one update falls in epoch 1
TRAIN = {"epochs": 2, "batch": 2, "nbs": 6, "imgsz": S, "optimizer": "SGD", "lr0": 0.01, "val": True,
         "save_period": 1, "seed": 0, **AUG_OFF}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("facade")
    data = generate_dataset(root / "ds", n_train=4, n_val=4, imgsz=S, nc=3, min_objs=1,
                            max_objs=1, min_size=0.7, max_size=0.9, seed=0)
    model = YOLO("edgeline-yolo.yaml", device="cpu")
    model.model = _exercised()  # a 3-class head whose scores pass the val gate
    best = model.train(data=str(data), project=str(root / "runs"), name="a", **TRAIN)
    return root, data, model, best


def test_training_writes_results_and_checkpoints(run):
    root, _, model, best = run
    d = model.trainer.save_dir
    assert d == root / "runs" / "a"
    for f in ("best.pt", "last.pt", "epoch0.pt", "epoch1.pt", "best.json", "args.yaml"):
        assert (d / f).exists(), f
    rows = (d / "results.csv").read_text().splitlines()
    assert rows[0].split(",") == [
        "epoch", "time", "train/box_loss", "train/cls_loss", "train/dfl_loss",
        "metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)",
        "fitness", "metrics/mAP75(B)", "lr/pg0"]
    assert len(rows) == 3
    ck = torch.load(d / "last.pt", map_location="cpu", weights_only=True)
    assert ck["epoch"] == 1 and ck["updates"] == 1 and ck["optimizer"]["count"] == 1
    assert model.trainer.accumulate == 3 and ck["optimizer"]["mini_step"] == 1
    assert ck["meta"]["nc"] == 3 and ck["meta"]["names"] == {0: "rectangle", 1: "ellipse", 2: "cross"}
    print(f"best fitness {best}; best-epoch metrics {model.trainer.best_metrics}")
    assert best == model.trainer.best_fitness > 0.05


def test_fit_is_deterministic_for_its_duration_only(monkeypatch):
    """`deterministic` (on by default, as in the JAX package's cfg) holds
    PyTorch and cuDNN to deterministic algorithms while `fit` runs and gives
    the process its own settings back after; off, it changes nothing."""
    from edgeyolo_tpu_torch.train.trainer import TRAIN_DEFAULTS, DetectionTrainer

    def flags():
        return (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled(),
                torch.backends.cudnn.deterministic)

    seen = []
    monkeypatch.setattr(DetectionTrainer, "_fit", lambda self: seen.append(flags()) or 0.0)
    before = flags()
    trainer = DetectionTrainer.__new__(DetectionTrainer)
    for det in (True, False):
        trainer.args = {**TRAIN_DEFAULTS, "deterministic": det}
        trainer.fit()
    assert TRAIN_DEFAULTS["deterministic"] is DEFAULT_CFG_DICT["deterministic"] is True
    assert seen == [(True, True, True), before]
    assert flags() == before


def test_best_checkpoint_reloads_to_the_best_epoch_metrics(run):
    root, data, model, _ = run
    again = YOLO(model.trainer.save_dir / "best.pt", device="cpu")
    got = again.val(data=str(data), batch=4, project=str(root / "runs"))
    for k, v in model.trainer.best_metrics.items():
        assert abs(got[k] - v) <= 1e-6, k
    assert again.names == {0: "rectangle", 1: "ellipse", 2: "cross"}


def test_jax_validator_on_the_converted_checkpoint_equals_the_port(run):
    root, data, model, _ = run
    ck = torch.load(model.trainer.save_dir / "best.pt", map_location="cpu", weights_only=True)
    jm = _jax_variables(ck["ema"], nc=3)
    overrides = {"mode": "val", "data": str(data), "imgsz": S, "batch": 4, "conf": 0.001,
                 "iou": 0.7, "max_det": 300, "plots": False}
    ref = JValidator(jget_cfg(overrides=overrides))(jm)
    got = YOLO(model.trainer.save_dir / "best.pt", device="cpu").val(
        data=str(data), batch=4, project=str(root / "runs"))
    print(f"port {got}\nJAX  {ref}")
    assert ref["metrics/mAP50-95(B)"] > 0.05
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k


def test_resume_continues_as_the_unbroken_run(run):
    root, data, model, _ = run
    first = model.trainer.save_dir
    ck0 = torch.load(first / "epoch0.pt", map_location="cpu", weights_only=True)
    assert ck0["optimizer"]["mini_step"] == 2 and ck0["optimizer"]["count"] == 0
    again = YOLO("edgeline-yolo.yaml", device="cpu")
    again.model = DetectionModel("edgeline-yolo.yaml", nc=3, device="cpu", seed=1)
    again.train(data=str(data), project=str(root / "runs"), name="b",
                resume=str(first / "epoch0.pt"), **TRAIN)
    assert again.trainer.epoch_losses == [model.trainer.epoch_losses[1]]
    a = torch.load(first / "last.pt", map_location="cpu", weights_only=True)
    b = torch.load(again.trainer.save_dir / "last.pt", map_location="cpu", weights_only=True)
    for part in ("model", "ema"):
        worst = max((a[part][k].float() - v.float()).abs().max().item() for k, v in b[part].items())
        assert worst <= 1e-6, part
    assert (a["optimizer"]["acc"] - b["optimizer"]["acc"]).abs().max().item() <= 1e-6
    for k in ("count", "mini_step"):
        assert a["optimizer"][k] == b["optimizer"][k], k
    assert a["updates"] == b["updates"] and a["epoch"] == b["epoch"]
    # resume=True continues in the run's own directory, from its last.pt (nothing left to run)
    again.train(data=str(data), project=str(root / "runs"), name="b", resume=True, **TRAIN)
    assert again.trainer.save_dir == root / "runs" / "b" and not (root / "runs" / "b2").exists()
    assert again.trainer.epoch_losses == [] and again.trainer.ema.updates == b["updates"]


def test_cli_val_prints_the_results_line(run):
    root, data, model, _ = run
    best = model.trainer.save_dir / "best.pt"
    r = subprocess.run([sys.executable, "-m", "edgeyolo_tpu_torch.cfg.cli", "detect", "val",
                        f"model={best}", f"data={data}", "device=cpu", "batch=4",
                        f"project={root / 'runs'}"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    header, line = r.stdout.strip().splitlines()[-2:]
    assert header.split() == ["images", "P", "R", "mAP50", "mAP75", "mAP50-95"]
    vals = line.split()
    m = model.trainer.best_metrics
    assert vals[:2] == ["all", "4"]
    assert abs(float(vals[5]) - m["metrics/mAP75(B)"]) < 1e-3
    assert abs(float(vals[6]) - m["metrics/mAP50-95(B)"]) < 1e-3


def test_predict_and_save_load(run):
    root, data, model, _ = run
    results = model(str(data.parent / "images" / "val"), conf=0.01, batch=4,
                    project=str(root / "runs"))
    assert len(results) == 4 and all(len(r) > 0 for r in results)
    for r in results:
        assert ((r.boxes.xyxy >= 0) & (r.boxes.xyxy <= [S, S, S, S])).all()
    path = model.save(root / "saved.pt")
    other = YOLO("edgeline-yolo.yaml", device="cpu")
    other.model = DetectionModel("edgeline-yolo.yaml", nc=3, device="cpu", seed=5)
    other.load(path)
    for k, v in model.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    assert YOLO(path, device="cpu").info()["trained_params"] == 2_645_028  # the 3-class head
