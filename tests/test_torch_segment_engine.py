"""The segment task's facade, validator, predictor and results in the PyTorch
port against the JAX package, on the CPU in f32.

One facade run: yolo11n-seg with a 3-class head (class logits at 0, so
scores pass the gates), 2 epochs on 4 synthetic 64 px segment images (each
one large shape: its box-corner polygon) at batch 2, augmentation off,
validation each epoch. Then:
- the checkpoint says task "segment" and reloads as a segment model, to the
  trainer's best-epoch box and mask metrics (1e-6);
- its EMA weights through convert_state_dict into JAX's yolo11n-seg,
  validated by JAX's SegmentationValidator on the same dataset: every box
  and mask metric equal to the port's validator's (1e-6);
- prediction on the val images against JAX's SegmentationPredictor: the
  boxes (1e-3 px, scores 1e-4) and the masks at the original size, equal
  except at pixels whose probability lies within 1e-4 of the 0.5 cut;
- `Results.plot` with masks equal to JAX's pixels outside both packages'
  label bands (tests/test_torch_predict_extras.py's rule), and `save_txt`
  and `to_json` equal to JAX's on its no-cv2 outline (ROADMAP C.14);
- the CLI's `segment val` prints the box and the mask rows; the facade's
  task checks.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_predict_extras import _bands

from edgeyolo_tpu.cfg import get_cfg as jget_cfg
from edgeyolo_tpu.engine.predictor import SegmentationPredictor as JSegmentationPredictor
from edgeyolo_tpu.engine.results import Results as JResults
from edgeyolo_tpu.engine.validator import SegmentationValidator as JSegmentationValidator
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.ops import segments as jsegments
from edgeyolo_tpu.utils.torch_convert import convert_state_dict
from edgeyolo_tpu_torch.cfg.cli import entrypoint
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.engine.predictor import SegmentationPredictor
from edgeyolo_tpu_torch.engine.results import Results
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.ops.segments import unletterbox_masks
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

S = 64
AUG_OFF = {"mosaic": 0.0, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "degrees": 0.0,
           "translate": 0.0, "scale": 0.0, "shear": 0.0, "perspective": 0.0, "flipud": 0.0,
           "fliplr": 0.0, "bgr": 0.0, "photometric": 0.0, "mixup": 0.0}
TRAIN = {"epochs": 2, "batch": 2, "nbs": 2, "imgsz": S, "optimizer": "SGD", "lr0": 0.01,
         "val": True, "seed": 0, **AUG_OFF}


def _exercised(nc=3):
    m = DetectionModel("yolo11n-seg.yaml", device="cpu", nc=nc)
    with torch.no_grad():
        for seq in m.model[-1].cv3:
            seq[-1].bias.zero_()
    return m


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("segfacade")
    data = generate_dataset(root / "ds", n_train=4, n_val=4, imgsz=S, nc=3, min_objs=1,
                            max_objs=1, min_size=0.7, max_size=0.9, seed=0, task="segment")
    model = YOLO("yolo11n-seg.yaml", device="cpu")
    model.model = _exercised()
    model.train(data=str(data), project=str(root / "runs"), name="a", **TRAIN)
    return root, data, model


def _jax_model(sd: dict, nc: int = 3):
    d = dict(jtasks.yaml_model_load("yolo11n-seg.yaml"))
    d["nc"] = nc
    jm = jtasks.SegmentationModel(d)
    shapes = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, rep = convert_state_dict({k: v.numpy() for k, v in sd.items()}, template,
                                        strict=True)
    assert rep["unused"] == ["model.23.dfl.conv.weight"]
    jm.variables = jax.tree.map(jnp.asarray, variables)
    return jm


def test_checkpoint_keeps_the_task_and_reloads_to_the_best_metrics(run):
    root, data, model = run
    d = model.trainer.save_dir
    ck = torch.load(d / "best.pt", map_location="cpu", weights_only=True)
    assert ck["meta"]["task"] == "segment"
    rows = (d / "results.csv").read_text().splitlines()
    assert "metrics/mAP50-95(M)" in rows[0].split(",")
    again = YOLO(d / "best.pt", device="cpu")
    assert again.task == again.model.task == "segment"
    got = again.val(data=str(data), batch=4, project=str(root / "runs"))
    best = model.trainer.best_metrics
    print(f"best-epoch metrics {best}")
    assert set(best) >= {"metrics/mAP50-95(B)", "metrics/mAP50-95(M)"}
    for k, v in best.items():
        assert abs(got[k] - v) <= 1e-6, k


def test_jax_seg_validator_on_the_converted_checkpoint_equals_the_port(run):
    root, data, model = run
    ck = torch.load(model.trainer.save_dir / "best.pt", map_location="cpu", weights_only=True)
    jm = _jax_model(ck["ema"])
    overrides = {"mode": "val", "data": str(data), "imgsz": S, "batch": 4, "conf": 0.001,
                 "iou": 0.7, "max_det": 300, "plots": False}
    ref = JSegmentationValidator(jget_cfg(overrides=overrides))(jm)
    got = YOLO(model.trainer.save_dir / "best.pt", device="cpu").val(
        data=str(data), batch=4, project=str(root / "runs"))
    print(f"port {got}\nJAX  {ref}")
    assert ref["metrics/mAP50(M)"] > 0.01  # (the untrained boxes spill far past the images)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k


def test_predicted_masks_match_jax(run):
    root, data, model = run
    ck = torch.load(model.trainer.save_dir / "best.pt", map_location="cpu", weights_only=True)
    jm = _jax_model(ck["ema"])
    src = str(data.parent / "images" / "val")
    jp = JSegmentationPredictor(jget_cfg(overrides={"mode": "predict", "imgsz": S, "conf": 0.25,
                                                   "save": False}))
    want = list(jp.stream(jm, src))
    pm = YOLO(model.trainer.save_dir / "best.pt", device="cpu")
    got = pm.predict(src, conf=0.25, imgsz=S, save=False)
    assert isinstance(pm.predictor, SegmentationPredictor)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert len(g) == len(w)
        if not len(w):
            assert g.masks is None and w.masks is None
            continue
        np.testing.assert_allclose(g.boxes.data[:, :4], w.boxes.data[:, :4], atol=1e-3)
        np.testing.assert_allclose(g.boxes.data[:, 4:], w.boxes.data[:, 4:], atol=1e-4)
        assert g.masks.data.shape == w.masks.data.shape == (len(w), *g.orig_shape)
        assert g.masks.data.dtype == bool
        off = g.masks.data != w.masks.data
        if off.any():  # only where the probability sits on the cut
            img = g.orig_img
            from edgeyolo_tpu_torch.data.letterbox import letterbox

            lb, r, (pw, ph) = letterbox(img, S, scaleup=True)
            det, n, masks = pm.predictor(lb[None])
            s = masks.shape[2] / (img.shape[0] * r + 2 * ph)
            prob = unletterbox_masks(masks[0, :len(w)], (pw * s, ph * s), img.shape[:2]).numpy()
            assert np.abs(prob[off] - 0.5).max() < 1e-4
        assert g.masks.data.any()


def test_plot_overlays_masks_as_jax(run):
    rs = np.random.RandomState(4)
    h, w = 120, 200
    img = rs.randint(0, 255, (h, w, 3)).astype(np.uint8)
    rows = np.array([[10, 20, 120, 100, 0.9, 1], [60, 5, 190, 80, 0.55, 2]], np.float32)
    masks = np.zeros((2, h, w), bool)
    masks[0, 30:90, 20:110] = True
    masks[1, 10:70, 100:180] = True
    names = {0: "rectangle", 1: "ellipse", 2: "cross"}
    got = Results(img, "x", names, boxes=rows, masks=masks).plot()
    want = JResults(img, "x", names, boxes=rows, masks=masks).plot()
    band, _ = _bands(rows, names, h, w, False)
    np.testing.assert_array_equal(got[~band], want[~band])
    inside = masks[0] & ~band
    assert (got[inside] != img[inside]).all(-1).any()  # the overlay is drawn


def test_save_txt_and_to_json_equal_jax(run, tmp_path, monkeypatch):
    monkeypatch.setattr(jsegments, "_HAS_CV2", False)  # JAX's no-cv2 outline, the port's
    rs = np.random.RandomState(5)
    h, w = 48, 64
    img = rs.randint(0, 255, (h, w, 3)).astype(np.uint8)
    rows = np.array([[4, 6, 40, 30, 0.8, 0], [20, 10, 60, 44, 0.4, 2],
                     [0, 0, 1, 1, 0.3, 1]], np.float32)
    masks = np.zeros((3, h, w), bool)
    masks[0, 8:28, 6:38] = True
    yy, xx = np.mgrid[:h, :w]
    masks[1] = (yy - 27) ** 2 + (xx - 40) ** 2 < 150  # masks[2]: empty, no polygon line
    names = {0: "rectangle", 1: "ellipse", 2: "cross"}
    g, j = Results(img, "x", names, boxes=rows, masks=masks), \
        JResults(img, "x", names, boxes=rows, masks=masks)
    for conf in (False, True):
        g.save_txt(tmp_path / f"p{conf}.txt", save_conf=conf)
        j.save_txt(tmp_path / f"j{conf}.txt", save_conf=conf)
        assert (tmp_path / f"p{conf}.txt").read_text() == (tmp_path / f"j{conf}.txt").read_text()
    assert len((tmp_path / "pFalse.txt").read_text().splitlines()) == 2
    for norm in (False, True):
        assert json.loads(g.to_json(normalize=norm)) == json.loads(j.to_json(normalize=norm))
    assert [len(s) for s in g.masks.xy] == [len(s) for s in j.masks.xy]
    assert len(g[0].masks) == 1 and g[1:].masks.data.shape == (2, h, w)


def test_cli_segment_val_prints_box_and_mask_rows(run, capsys):
    root, data, model = run
    entrypoint(["segment", "val", f"model={model.trainer.save_dir / 'best.pt'}",
                f"data={data}", "device=cpu", "batch=4", f"project={root / 'runs'}"])
    out = capsys.readouterr().out
    assert "mAP50-95" in out and "masks" in out


def test_facade_task_checks():
    assert YOLO("yolo11n-seg.yaml", task="segment", device="cpu").task == "segment"
    assert YOLO("yolov9t.yaml", device="cpu").task == "detect"
    with pytest.raises(ValueError):
        YOLO("yolo11n-seg.yaml", task="detect", device="cpu")
    with pytest.raises(ValueError, match="not a classify one"):
        YOLO("yolo11n.yaml", task="classify", device="cpu")
    for task in ("pose", "obb"):  # ported tasks: a detect model is not one of theirs
        with pytest.raises(ValueError, match=f"not a {task} one"):
            YOLO("yolo11n.yaml", task=task, device="cpu")
