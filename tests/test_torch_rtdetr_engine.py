"""RT-DETR's facade, validator, predictor and CLI in the PyTorch port against
the JAX package, on the CPU in f32.

One facade run: yolov8-rtdetr-n with a 3-class head at perturbed weights
(tests/test_torch_rtdetr.py's `rt_perturbed`: score biases spread around
0, so queries pass the gates; `_landing`: boxes of about 0.6 of the image
at the anchors), 2 epochs on 4 synthetic 64 px images (one
large shape each) at batch 2, augmentation off, validation each epoch.
Then:
- the checkpoint keeps the RT-DETR head and reloads to the trainer's
  best-epoch metrics (1e-6);
- its EMA weights through convert_rtdetr_state_dict into JAX's model,
  validated by JAX's DetectionValidator (its query path: no NMS) on the same
  dataset: every metric equal to the port's validator on the same model's
  predictions (1e-6), and to the port's own model within f32 rounding; and
  both validators on the same fixed predictions (stub models), with
  metrics high enough that the matching counts (1e-6);
- JAX's own predictor has no RT-DETR branch: it puts the normalised
  (B, nq, 4 + nc) pred through NMS, so its boxes come out in normalised
  units, a pixel or less across on a 64 px image (ROADMAP C.18). The port's
  predictor takes the validator's query path: its boxes equal JAX's model
  through that path (1e-3 px, scores 1e-4, classes exact), in pixels;
  `augment=True` warns and predicts single-scale;
- the `RTDETR` facade name, and the CLI's `detect train`, `val` and
  `predict` with model=rtdetr-l.yaml.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rtdetr import jax_template, rt_perturbed
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

import edgeyolo_tpu_torch
from edgeyolo_tpu.cfg import get_cfg as jget_cfg
from edgeyolo_tpu.engine import predictor as jpredictor
from edgeyolo_tpu.engine import validator as jvalidator
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.utils.torch_convert import convert_rtdetr_state_dict
from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.cfg.cli import entrypoint
from edgeyolo_tpu_torch.data.imageio import load_image_rgb
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor, detr_detections
from edgeyolo_tpu_torch.engine.validator import DetectionValidator
from edgeyolo_tpu_torch.nn.modules.head import RTDETRDecoder
from edgeyolo_tpu_torch.nn.tasks import DetectionModel, is_rtdetr

S, NC = 64, 3
AUG_OFF = {"mosaic": 0.0, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "degrees": 0.0,
           "translate": 0.0, "scale": 0.0, "shear": 0.0, "perspective": 0.0, "flipud": 0.0,
           "fliplr": 0.0, "bgr": 0.0, "photometric": 0.0, "mixup": 0.0}
TRAIN = {"epochs": 2, "batch": 2, "nbs": 2, "imgsz": S, "optimizer": "SGD", "lr0": 0.01,
         "val": True, "seed": 0, **AUG_OFF}
VAL = {"mode": "val", "imgsz": S, "batch": 4, "conf": 0.001, "iou": 0.7, "max_det": 300,
       "plots": False}


def _landing(pm: DetectionModel) -> DetectionModel:
    """rt_perturbed weights whose queries keep their encoder boxes: each an
    anchor's centre with a side of about 0.6 of the image or more (the box
    heads' last layers at 0, the encoder's biased to widen its anchors), so
    that untrained queries overlap the large shapes and the metrics move."""
    pm.load_state_dict(rt_perturbed(pm.state_dict()))
    head = pm.model[-1]
    with torch.no_grad():
        for mlp in (head.enc_bbox_head, *head.dec_bbox_head):
            mlp.layers[-1].weight.zero_()
            mlp.layers[-1].bias.zero_()
        head.enc_bbox_head.layers[-1].bias[2:] = 3.35  # logit(0.05) + 3.35 = logit(0.6)
    return pm


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("rtdetr_facade")
    data = generate_dataset(root / "ds", n_train=4, n_val=4, imgsz=S, nc=NC, min_objs=1,
                            max_objs=1, min_size=0.5, max_size=0.66, seed=0)
    model = edgeyolo_tpu_torch.RTDETR("yolov8-rtdetr-n", device="cpu")
    model.model = _landing(DetectionModel("yolov8-rtdetr-n", device="cpu", nc=NC))
    model.train(data=str(data), project=str(root / "runs"), name="a", **TRAIN)
    return root, data, model


def _best(model):
    return model.trainer.save_dir / "best.pt"


def _jax_model(sd: dict):
    d = dict(jtasks.yaml_model_load("yolov8-rtdetr.yaml"))
    d["nc"], d["scale"] = NC, "n"
    jm = jtasks.DetectionModel(d)
    template = jax_template(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))
    variables, rep = convert_rtdetr_state_dict({k: v.numpy() for k, v in sd.items()}, template,
                                               strict=True)
    assert not rep["unused"] and not rep["missing"]
    jm.variables = jax.tree.map(jnp.asarray, variables)
    assert jm.head_name == "RTDETRDecoder"
    return jm


def test_checkpoint_keeps_the_head_and_reloads_to_the_best_metrics(run):
    root, data, model = run
    again = YOLO(_best(model), device="cpu")
    assert is_rtdetr(again.model) and again.model.nc == NC and again.task == "detect"
    got = again.val(data=str(data), batch=4, project=str(root / "runs"))
    best = model.trainer.best_metrics
    assert best and set(got) >= set(best)
    for k, v in best.items():
        assert abs(got[k] - v) <= 1e-6, k
    saved = again.save(root / "again.pt")  # the facade's own checkpoint round trip
    back = YOLO(saved, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.model.state_dict().values(),
                                                 again.model.state_dict().values()))


class _PortStub(torch.nn.Module):
    """An RT-DETR model for the port's validator whose pred comes from
    `pred_fn(x)`: fixed predictions, or JAX's model on the same input."""

    def __init__(self, pred_fn):
        super().__init__()
        self.model = torch.nn.ModuleList([RTDETRDecoder(NC, ch=(8,), hd=8, nh=1, ndl=1,
                                                        d_ffn=8)])
        self.pred_fn, self.nc, self.dtype = pred_fn, NC, torch.float32

    def forward(self, x):
        return {"pred": self.pred_fn(x)}


class _FixedJax:
    """Fixed predictions for JAX's validator (its query path keys on `head_name`)."""

    head_name = "RTDETRDecoder"

    def __init__(self, pred):
        self.pred, self.nc, self.variables = jnp.asarray(pred), NC, {}

    def apply(self, variables, img, train=False):
        return {"pred": self.pred[:img.shape[0]]}


def _jax_preds(jm, data):
    """JAX's model (compiled) on the val split's images, in the loader's order."""
    from edgeyolo_tpu_torch.data.dataset import YOLODataset

    ds = YOLODataset(str(data.parent / "images" / "val"), imgsz=S)
    imgs = np.stack([ds.get_item(i)["img"] for i in range(len(ds))])
    apply = jax.jit(lambda v, x: jm.net.apply(v, x, train=False)["pred"])
    return np.array(apply(jm.variables, jnp.asarray(imgs, jnp.float32) / 255.0))


def _val_pair(root, data, jmodel, port_model, name):
    ref = jvalidator.DetectionValidator(jget_cfg(overrides={**VAL, "data": str(data)}),
                                        save_dir=root / f"j{name}")(jmodel)
    got = DetectionValidator(get_cfg(overrides={**VAL, "data": str(data)}),
                             save_dir=root / f"p{name}", device="cpu")(port_model)
    print(f"{name}: port {got}\n{name}: JAX  {ref}")
    assert set(got) == set(ref)
    return got, ref


def test_jax_validator_on_the_converted_checkpoint_equals_the_port(run):
    """Both validators on the converted checkpoint's predictions (JAX's model,
    compiled, on the val images: one array into both), every metric at 1e-6;
    then JAX's validator on JAX's model against the port's on its own model.
    There the two models' preds part by f32 rounding (1e-5 px; and XLA's
    compiled model alone already differs from the same model compiled with
    the validator's selection), which moves a detection across one of the
    ten IoU cuts or reorders a score tie: within 1e-3."""
    root, data, model = run
    ck = torch.load(_best(model), map_location="cpu", weights_only=True)
    jm = _jax_model(ck["ema"])
    pred = _jax_preds(jm, data)
    got, ref = _val_pair(root, data, _FixedJax(pred),
                         _PortStub(lambda x: torch.from_numpy(pred[:x.shape[0]])), "model")
    assert ref["metrics/recall(B)"] > 0.2  # queries land on the shapes
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k
    ref = jvalidator.DetectionValidator(jget_cfg(overrides={**VAL, "data": str(data)}),
                                        save_dir=root / "jown")(jm)
    own = YOLO(_best(model), device="cpu").val(data=str(data), batch=4,
                                               project=str(root / "runs"))
    print(f"own: port {own}\nown: JAX  {ref}")
    assert ref["metrics/recall(B)"] > 0.2
    for k in ref:
        assert abs(own[k] - ref[k]) <= 1e-3, k


def _fixed_pred(data):
    """Per val image 300 queries: 20 noisy copies of its shape's box (normalised
    cxcywh) scored 0.3-0.95 for its class, and 280 random boxes scored under
    0.3, with tied best scores among them."""
    from edgeyolo_tpu_torch.data.dataset import YOLODataset

    ds = YOLODataset(str(data.parent / "images" / "val"), imgsz=S)
    rs = np.random.RandomState(7)
    preds = []
    for i in range(len(ds)):
        it = ds.get_item(i)
        c = int(it["cls"][0])
        near = np.tile(it["bboxes"][0], (20, 1)) + rs.randn(20, 4) * 0.04
        far = np.concatenate([rs.uniform(0, 1, (280, 2)), rs.uniform(0.05, 0.5, (280, 2))], 1)
        sc = np.zeros((300, NC))
        sc[:20, c] = rs.uniform(0.3, 0.95, 20)
        sc[20:] = np.round(rs.uniform(0, 0.3, (280, NC)) * 50) / 50
        rows = np.concatenate([near, far])
        preds.append(np.concatenate([rows, sc], 1)[rs.permutation(300)])
    return np.stack(preds).astype(np.float32)


def test_validators_match_jax_on_fixed_predictions(run):
    root, data, _ = run
    pred = _fixed_pred(data)
    got, ref = _val_pair(root, data, _FixedJax(pred),
                         _PortStub(lambda x: torch.from_numpy(pred[:x.shape[0]])), "fixed")
    assert ref["metrics/mAP50(B)"] > 0.3 and ref["metrics/mAP50-95(B)"] < 0.95
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k


def _jax_query_path(jm, imgs, conf):
    """JAX's model through its validator's query path (pixels from normalised
    cxcywh, argmax class, the top max_det by best score, rows under conf out),
    the boxes clipped to the image as a predictor clips them."""
    pred = np.asarray(jax.jit(lambda v, x: jm.net.apply(v, x, train=False)["pred"])(
        jm.variables, jnp.asarray(imgs, jnp.float32) / 255.0))
    h, w = imgs.shape[1:3]
    out = []
    for p in pred:
        xy, wh = p[:, :2] * [w, h], p[:, 2:4] * [w, h]
        best, cls = p[:, 4:].max(-1), p[:, 4:].argmax(-1)
        order = np.argsort(-best, kind="stable")
        box = np.clip(np.concatenate([xy - wh / 2, xy + wh / 2], 1), 0, [w, h, w, h])
        rows = np.concatenate([box, best[:, None], cls[:, None]], 1)[order]
        out.append(rows[rows[:, 4] > conf])
    return out


def test_jax_predictor_gives_normalised_boxes_and_the_port_the_query_path(run, caplog):
    root, data, model = run
    ck = torch.load(_best(model), map_location="cpu", weights_only=True)
    jm = _jax_model(ck["ema"])
    src = data.parent / "images" / "val"
    cfg = jget_cfg(overrides={"mode": "predict", "imgsz": S, "conf": 0.25, "save": False})
    jres = list(jpredictor.DetectionPredictor(cfg).stream(jm, str(src)))
    jboxes = np.concatenate([r.boxes.data for r in jres if len(r)])
    assert len(jboxes) and jboxes[:, :4].max() <= 1.5  # normalised units: under 2 px of 64
    pm = YOLO(_best(model), device="cpu")
    got = pm.predict(str(src), conf=0.25, imgsz=S, save=False, project=str(root / "runs"))
    assert isinstance(pm.predictor, DetectionPredictor)
    imgs = np.stack([load_image_rgb(p) for p in sorted(src.iterdir())])
    want = _jax_query_path(jm, imgs, 0.25)
    assert [g.path for g in got] == [str(p) for p in sorted(src.iterdir())]
    assert sum(len(w) for w in want) > 4
    for g, w in zip(got, want):
        d = g.boxes.data
        assert d.shape == w.shape
        np.testing.assert_allclose(d[:, :4], w[:, :4], atol=1e-3)
        np.testing.assert_allclose(d[:, 4], w[:, 4], atol=1e-4)
        np.testing.assert_array_equal(d[:, 5], w[:, 5])
    assert max(g.boxes.data[:, 2:4].max() for g in got if len(g)) > 10  # pixels
    with caplog.at_level(logging.WARNING):
        tta = pm.predict(str(src), conf=0.25, imgsz=S, save=False, augment=True,
                         project=str(root / "runs"))
    assert "single-scale" in caplog.text
    for a, b in zip(tta, got):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)


def test_detr_detections_keep_rows_as_the_validator_does():
    rs = np.random.RandomState(3)
    pred = np.concatenate([rs.uniform(0.2, 0.8, (2, 50, 2)), rs.uniform(0.05, 0.3, (2, 50, 2)),
                           np.round(rs.uniform(0, 1, (2, 50, NC)) * 8) / 8], -1)
    det, n = detr_detections(torch.from_numpy(pred).float(), (48, 80), 0.5, 30, classes=(0, 2))
    assert det.shape == (2, 30, 6)
    for b in range(2):
        rows = det[b, :int(n[b])].numpy()
        assert (rows[:, 4] > 0.5).all() and np.isin(rows[:, 5], (0, 2)).all()
        assert (np.diff(rows[:, 4]) <= 0).all() and not det[b, int(n[b]):].any()
        best = pred[b, :, 4:].max(-1)
        keep = [i for i in np.argsort(-best, kind="stable")[:30]
                if best[i] > 0.5 and pred[b, i, 4:].argmax() in (0, 2)]
        np.testing.assert_allclose(rows[:, 0], (pred[b, keep, 0] - pred[b, keep, 2] / 2) * 80,
                                   rtol=1e-6)


def test_cli_trains_validates_and_predicts_rtdetr_l(run, capsys):
    root, data, _ = run
    project = root / "cli"
    entrypoint(["detect", "train", "model=rtdetr-l.yaml", f"data={data}", "device=cpu",
                "epochs=1", "batch=2", "nbs=2", "imgsz=64", f"project={project}", "name=t",
                "optimizer=SGD", *(f"{k}={v}" for k, v in AUG_OFF.items())])
    best = project / "t" / "best.pt"
    assert best.exists() and "best fitness" in capsys.readouterr().out
    m = YOLO(best, device="cpu")
    assert m.model.cfg == "rtdetr-l.yaml" and is_rtdetr(m.model)
    entrypoint(["detect", "val", f"model={best}", f"data={data}", "device=cpu", "batch=4",
                f"project={project}"])
    out = capsys.readouterr().out
    assert "mAP50-95" in out and "all" in out
    entrypoint(["detect", "predict", f"model={best}", f"source={data.parent / 'images' / 'val'}",
                "device=cpu", "save=False", "conf=0.001", f"project={project}"])
    assert "4 images processed" in capsys.readouterr().out
