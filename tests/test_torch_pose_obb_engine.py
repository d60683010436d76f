"""The pose and obb tasks' facade, validators, predictors, results and CLI in
the PyTorch port against the JAX package, on the CPU in f32.

One facade run per task: yolo11n-pose (5 x 3 keypoints: the synthetic
pose set's corners and centre) and yolo11n-obb with 3-class heads (class
logits at 0, so scores pass the gates), 2 epochs on 4 synthetic 64 px
images (each one large shape) at batch 2, augmentation off, validation
each epoch. Then:
- the checkpoint keeps the task (and the kpt_shape) and reloads to the
  trainer's best-epoch metrics (1e-6);
- its EMA weights through convert_state_dict into JAX's model, validated by
  JAX's PoseValidator or OBBValidator on the same dataset: every box, pose
  (OKS) and probiou metric equal to the port's (1e-6);
- prediction on the val images against JAX's PosePredictor and
  OBBPredictor: boxes and keypoints 1e-3 px, scores and visibilities 1e-4;
  rotated boxes the same by corners at 1e-3 px, scores 1e-4, classes exact;
- `Results.plot` with keypoints and with rotated boxes equal to JAX's
  pixels outside both packages' label bands (tests/test_torch_predict_extras.py's
  rule), `save_txt` and `to_json` text equal to JAX's, and save_crop
  writing nothing for rotated boxes;
- the obb validator's save_json on DOTA-named tiles: predictions.json, the
  Task1 files and the merged Task1 files as JAX's: the same rows, ids and
  files, each number within 2e-3 (rounded to 3 places, an f32 value a few
  ulp from JAX's can land one unit apart in the last place, ROADMAP C.15);
- the CLI's `pose val` (box and pose rows) and `obb val`; a pose dataset's
  kpt_shape rebuilding the facade's 17 x 3 head, and the facade's task checks.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_predict_extras import _bands

from edgeyolo_tpu.cfg import get_cfg as jget_cfg
from edgeyolo_tpu.engine import predictor as jpredictor
from edgeyolo_tpu.engine import validator as jvalidator
from edgeyolo_tpu.engine.results import Results as JResults
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.ops import boxes as jboxes
from edgeyolo_tpu.utils.torch_convert import convert_state_dict
from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.cfg.cli import entrypoint
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.engine.predictor import OBBPredictor, PosePredictor
from edgeyolo_tpu_torch.engine.results import Results
from edgeyolo_tpu_torch.engine.validator import OBBValidator, PoseValidator
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

S, NC = 64, 3
AUG_OFF = {"mosaic": 0.0, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "degrees": 0.0,
           "translate": 0.0, "scale": 0.0, "shear": 0.0, "perspective": 0.0, "flipud": 0.0,
           "fliplr": 0.0, "bgr": 0.0, "photometric": 0.0, "mixup": 0.0}
TRAIN = {"epochs": 2, "batch": 2, "nbs": 2, "imgsz": S, "optimizer": "SGD", "lr0": 0.01,
         "val": True, "seed": 0, **AUG_OFF}
YAML = {"pose": "yolo11n-pose.yaml", "obb": "yolo11n-obb.yaml"}
KPT = {"pose": (5, 3), "obb": None}
NAMES = {0: "rectangle", 1: "ellipse", 2: "cross"}


def _exercised(task):
    """Class logits at 0, and each side's DFL distribution peaked at bin 1
    (expectation 1.25 bins: boxes of 20, 40 and 80 px at the three levels),
    so that untrained boxes overlap the large shapes and the metrics move."""
    m = DetectionModel(YAML[task], device="cpu", nc=NC, kpt_shape=KPT[task])
    with torch.no_grad():
        for seq in m.model[-1].cv3:
            seq[-1].bias.zero_()
        for seq in m.model[-1].cv2:
            seq[-1].bias.copy_(torch.tensor([0.0, 6.0] + [0.0] * 14).repeat(4))
    return m


@pytest.fixture(scope="module", params=["pose", "obb"])
def run(request, tmp_path_factory):
    task = request.param
    root = tmp_path_factory.mktemp(f"{task}facade")
    data = generate_dataset(root / "ds", n_train=4, n_val=4, imgsz=S, nc=NC, min_objs=1,
                            max_objs=1, min_size=0.6, max_size=0.66, seed=0, task=task)
    model = YOLO(YAML[task], device="cpu")
    model.model = _exercised(task)
    model.train(data=str(data), project=str(root / "runs"), name="a", **TRAIN)
    return task, root, data, model


def _jax_model(task, sd: dict):
    d = dict(jtasks.yaml_model_load(YAML[task]))
    d["nc"] = NC
    if KPT[task]:
        d["kpt_shape"] = list(KPT[task])
    jm = (jtasks.PoseModel if task == "pose" else jtasks.OBBModel)(d)
    shapes = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, rep = convert_state_dict({k: v.numpy() for k, v in sd.items()}, template,
                                        strict=True)
    assert rep["unused"] == ["model.23.dfl.conv.weight"]
    jm.variables = jax.tree.map(jnp.asarray, variables)
    return jm


def _best(model):
    return model.trainer.save_dir / "best.pt"


def test_checkpoint_keeps_the_task_and_reloads_to_the_best_metrics(run):
    task, root, data, model = run
    ck = torch.load(_best(model), map_location="cpu", weights_only=True)
    assert ck["meta"]["task"] == task
    assert ck["meta"]["kpt_shape"] == (list(KPT[task]) if KPT[task] else None)
    again = YOLO(_best(model), device="cpu")
    assert again.task == again.model.task == task and again.model.kpt_shape == KPT[task]
    got = again.val(data=str(data), batch=4, project=str(root / "runs"))
    best = model.trainer.best_metrics
    print(f"{task} best-epoch metrics {best}")
    if task == "pose":
        assert set(best) >= {"metrics/mAP50-95(B)", "metrics/mAP50-95(P)"}
    for k, v in best.items():
        assert abs(got[k] - v) <= 1e-6, k


def test_jax_validator_on_the_converted_checkpoint_equals_the_port(run):
    task, root, data, model = run
    ck = torch.load(_best(model), map_location="cpu", weights_only=True)
    jm = _jax_model(task, ck["ema"])
    overrides = {"mode": "val", "data": str(data), "imgsz": S, "batch": 4, "conf": 0.001,
                 "iou": 0.7, "max_det": 300, "plots": False}
    vcls = jvalidator.PoseValidator if task == "pose" else jvalidator.OBBValidator
    ref = vcls(jget_cfg(overrides=overrides), save_dir=root / "jval")(jm)
    got = YOLO(_best(model), device="cpu").val(data=str(data), batch=4,
                                               project=str(root / "runs"))
    print(f"{task} port {got}\n{task} JAX  {ref}")
    assert ref["metrics/mAP50(B)"] > 0  # (2 epochs: the pose mAP stays 0 here; see below)
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k


class _FixedPort(torch.nn.Module):
    """A model whose pred is a fixed (B, A, C) array, for the port's validators."""

    def __init__(self, pred, task):
        super().__init__()
        self.pred, self.task, self.nc, self.dtype = torch.from_numpy(pred), task, NC, torch.float32
        self.kpt_shape = KPT[task]

    def forward(self, x):
        return {"pred": self.pred[:x.shape[0]]}


class _FixedJax:
    """The same for JAX's validators."""

    def __init__(self, pred, task):
        self.pred, self.nc, self.variables = jnp.asarray(pred), NC, {}
        self.yaml = {"kpt_shape": list(KPT[task])} if KPT[task] else {}

    def apply(self, variables, img, train=False):
        return {"pred": self.pred[:img.shape[0]]}


def _fixed_pred(task, data):
    """Per val image 20 noisy copies of its shape's box (keypoints, angle)
    scored 0.3-0.95 for its class, and 80 random boxes scored under 0.3."""
    from edgeyolo_tpu_torch.data.dataset import YOLODataset

    ds = YOLODataset(str(data.parent / "images" / "val"), imgsz=S, task=task,
                     kpt_shape=KPT[task] or (17, 3))
    rs = np.random.RandomState(7)
    preds = []
    for i in range(len(ds)):
        it = ds.get_item(i)
        c = int(it["cls"][0])
        box = it["rboxes"][0] * [S, S, S, S, 1] if task == "obb" else it["bboxes"][0] * S
        near = np.tile(box, (20, 1)) + rs.randn(20, len(box)) * ([3, 3, 4, 4, 0.1][:len(box)])
        far = np.concatenate([rs.uniform(0, S, (80, 2)), rs.uniform(4, 30, (80, 2)),
                              rs.uniform(0, np.pi / 2, (80, 1))], 1)[:, :len(box)]
        sc = np.zeros((100, NC))
        sc[:20, c] = rs.uniform(0.3, 0.95, 20)
        sc[20:] = rs.uniform(0, 0.3, (80, NC))
        rows = np.concatenate([near, far])
        if task == "obb":
            preds.append(np.concatenate([rows[:, :4], sc, rows[:, 4:]], 1))
        else:
            kp = np.tile(it["keypoints"][0], (100, 1, 1))
            kp[..., :2] += rs.randn(100, 5, 2) * 6
            kp[..., 2] = rs.uniform(0.2, 1, (100, 5))
            preds.append(np.concatenate([rows, sc, kp.reshape(100, -1)], 1))
    return np.stack(preds).astype(np.float32)


def test_validators_match_jax_on_fixed_predictions(run):
    """Both validators on the same fixed predictions: every box, pose (OKS)
    and probiou metric equal, and high enough that the matching counts."""
    task, root, data, model = run
    pred = _fixed_pred(task, data)
    overrides = {"mode": "val", "data": str(data), "imgsz": S, "batch": 4, "conf": 0.001,
                 "iou": 0.7, "max_det": 300, "plots": False}
    vcls = jvalidator.PoseValidator if task == "pose" else jvalidator.OBBValidator
    ref = vcls(jget_cfg(overrides=overrides), save_dir=root / "jfixed")(_FixedJax(pred, task))
    pcls = PoseValidator if task == "pose" else OBBValidator
    got = pcls(get_cfg(overrides=overrides), save_dir=root / "pfixed", device="cpu")(
        _FixedPort(pred, task))
    print(f"{task} port {got}\n{task} JAX  {ref}")
    assert ref["metrics/mAP50(B)"] > 0.3 and ref["metrics/mAP50-95(B)"] < 0.9
    if task == "pose":
        assert 0.1 < ref["metrics/mAP50-95(P)"] < 0.95
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k


def _corners_close(g, w, atol):
    gc, wc = jboxes.xywhr2xyxyxyxy(g), jboxes.xywhr2xyxyxyxy(w)
    d = np.abs(gc[:, :, None] - wc[:, None]).max(-1).min(-1)  # each corner to the nearest
    assert d.max() < atol, d.max()


def _pairing(g, w):
    """The port's row for each of JAX's, by the nearest box: rows whose scores
    tie to f32 rounding (logits at 0) may come out of the two NMSs in either
    order. Each row pairs with a distinct one."""
    order = np.abs(g[None, :, :4] - w[:, None, :4]).max(-1).argmin(1)
    assert len(set(order.tolist())) == len(order)
    return order


def test_predictions_match_jax(run):
    task, root, data, model = run
    jm = _jax_model(task, torch.load(_best(model), map_location="cpu", weights_only=True)["ema"])
    src = str(data.parent / "images" / "val")
    cfg = jget_cfg(overrides={"mode": "predict", "imgsz": S, "conf": 0.25, "save": False})
    jp = (jpredictor.PosePredictor(cfg, kpt_shape=KPT[task]) if task == "pose"
          else jpredictor.OBBPredictor(cfg))
    want = list(jp.stream(jm, src))
    pm = YOLO(_best(model), device="cpu")
    got = pm.predict(src, conf=0.25, imgsz=S, save=False, project=str(root / "runs"))
    assert isinstance(pm.predictor, PosePredictor if task == "pose" else OBBPredictor)
    assert len(got) == len(want) == 4 and sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        if not len(w):
            continue
        if task == "pose":
            order = _pairing(g.boxes.data[:, :4], w.boxes.data[:, :4])
            np.testing.assert_allclose(g.boxes.data[order, :4], w.boxes.data[:, :4], atol=1e-3)
            np.testing.assert_allclose(g.boxes.data[order, 4:], w.boxes.data[:, 4:], atol=1e-4)
            gk, wk = g.keypoints.data[order], w.keypoints.data
            assert gk.shape == wk.shape == (len(w), 5, 3)
            np.testing.assert_allclose(gk[..., :2], wk[..., :2], atol=1e-3)
            np.testing.assert_allclose(gk[..., 2], wk[..., 2], atol=1e-4)
        else:
            assert g.boxes is None and g.obb.data.shape == w.obb.data.shape == (len(w), 7)
            order = _pairing(g.obb.xyxy, w.obb.xyxy)
            _corners_close(g.obb.xywhr[order], w.obb.xywhr, 1e-3)
            np.testing.assert_allclose(g.obb.conf[order], w.obb.conf, atol=1e-4)
            np.testing.assert_array_equal(g.obb.cls[order], w.obb.cls)


def _pose_rows(rs, h, w):
    rows = np.array([[10, 20, 120, 100, 0.9, 1], [60, 5, 190, 80, 0.55, 2]], np.float32)
    kp = np.concatenate([rs.uniform(0, [w, h], (2, 5, 2)), rs.rand(2, 5, 1)], -1)
    return rows, kp.astype(np.float32)


def _obb_rows():
    return np.array([[60, 50, 80, 30, 0.3, 0.9, 1], [150, 70, 60, 20, 1.2, 0.55, 2],
                     [100, 100, 40, 40, 0.0, 0.7, 0]], np.float32)


@pytest.mark.parametrize("hw", [(120, 200), (720, 1280)], ids=str)
def test_plot_draws_keypoints_and_rotated_boxes_as_jax(hw):
    h, w = hw
    rs = np.random.RandomState(h)
    img = rs.randint(0, 255, (h, w, 3)).astype(np.uint8)
    rows, kp = _pose_rows(rs, h, w)
    got = Results(img, "x", NAMES, boxes=rows, keypoints=kp).plot()
    want = JResults(img, "x", NAMES, boxes=rows, keypoints=kp).plot()
    band, _ = _bands(rows, NAMES, h, w, False)
    np.testing.assert_array_equal(got[~band], want[~band])
    assert (got != img).any(-1)[~band].sum() > 100
    obb = _obb_rows()
    got = Results(img, "x", NAMES, obb=obb).plot()
    want = JResults(img, "x", NAMES, obb=obb).plot()
    corners = jboxes.xywhr2xyxyxyxy(obb[:, :5])
    anchors = np.array([[c[0][0], c[0][1], 0, 0, r[5], r[6]] for c, r in zip(corners, obb)])
    band, _ = _bands(anchors, NAMES, h, w, False)  # each label at its first corner
    np.testing.assert_array_equal(got[~band], want[~band])
    assert (got != img).any(-1)[~band].sum() > 100  # the rings are drawn


def test_save_txt_to_json_and_save_crop_equal_jax(tmp_path, caplog):
    rs = np.random.RandomState(5)
    h, w = 48, 64
    img = rs.randint(0, 255, (h, w, 3)).astype(np.uint8)
    rows, kp = _pose_rows(rs, h, w)
    kp2 = kp[..., :2].copy()
    obb = _obb_rows()
    cases = [dict(boxes=rows, keypoints=kp), dict(boxes=rows, keypoints=kp2), dict(obb=obb)]
    for i, kw in enumerate(cases):
        g, j = Results(img, "x", NAMES, **kw), JResults(img, "x", NAMES, **kw)
        for conf in (False, True):
            g.save_txt(tmp_path / f"p{i}{conf}.txt", save_conf=conf)
            j.save_txt(tmp_path / f"j{i}{conf}.txt", save_conf=conf)
            assert (tmp_path / f"p{i}{conf}.txt").read_text() == \
                (tmp_path / f"j{i}{conf}.txt").read_text()
        for norm in (False, True):
            assert json.loads(g.to_json(normalize=norm)) == json.loads(j.to_json(normalize=norm))
        assert g.verbose_str == j.verbose_str and len(g) == len(j)
        assert len(g[0]) == 1 and len(g[1:]) == len(g) - 1
    g = Results(img, "x", NAMES, obb=obb)
    np.testing.assert_allclose(g.obb.xyxyxyxyn, JResults(img, "x", NAMES, obb=obb).obb.xyxyxyxyn)
    g.save_crop(tmp_path / "crops")
    assert not (tmp_path / "crops").exists() and "not supported for obb" in caplog.text


@pytest.mark.parametrize("run", ["obb"], indirect=True)
def test_obb_save_json_on_dota_tiles_equals_jax(run, tmp_path):
    task, root, data, model = run
    tiles = tmp_path / "tiles"
    for split in ("images", "labels"):
        (tiles / split / "val").mkdir(parents=True)
    src = sorted((data.parent / "images" / "val").iterdir())
    for k, f in enumerate(src):  # two tiles of each of two source images
        stem = f"P{k // 2:04d}__1024__{(k % 2) * 824}___{(k % 2) * 500}"
        shutil.copy(f, tiles / "images" / "val" / f"{stem}{f.suffix}")
        shutil.copy(data.parent / "labels" / "val" / f"{f.stem}.txt",
                    tiles / "labels" / "val" / f"{stem}.txt")
    yaml = tiles / "dataset.yaml"
    yaml.write_text(data.read_text().replace(str(data.parent.resolve()), str(tiles.resolve())))
    ck = torch.load(_best(model), map_location="cpu", weights_only=True)
    # 10 rows an image: JAX's merge runs one eager probiou per pair of rows
    over = {"mode": "val", "data": str(yaml), "imgsz": S, "batch": 4, "conf": 0.25,
            "max_det": 10, "plots": False, "save_json": True}
    ref = jvalidator.OBBValidator(jget_cfg(overrides=over), save_dir=tmp_path / "j")(
        _jax_model(task, ck["ema"]))
    got = YOLO(_best(model), device="cpu").val(data=str(yaml), batch=4, conf=0.25, max_det=10,
                                               save_json=True, project=str(tmp_path), name="p")
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k
    pj, jj = tmp_path / "p", tmp_path / "j"
    gj, wj = (json.loads((d / "predictions.json").read_text()) for d in (pj, jj))
    assert len(gj) == len(wj) > 0
    for g, w in zip(gj, wj):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose([g["score"], *g["rbox"], *g["poly"]],
                                   [w["score"], *w["rbox"], *w["poly"]], atol=2e-3, rtol=0)
    for sub in ("predictions_txt", "predictions_merged_txt"):
        names = sorted(p.name for p in (jj / sub).iterdir())
        assert names and names == sorted(p.name for p in (pj / sub).iterdir())
        for n in names:
            gl, wl = ((d / sub / n).read_text().splitlines() for d in (pj, jj))
            assert len(gl) == len(wl)
            for a, b in zip(gl, wl):
                assert a.split()[0] == b.split()[0]
                np.testing.assert_allclose([float(v) for v in a.split()[1:]],
                                           [float(v) for v in b.split()[1:]], atol=2e-3, rtol=0)


def test_cli_val_prints_the_task_rows(run, capsys):
    task, root, data, model = run
    entrypoint([task, "val", f"model={_best(model)}", f"data={data}", "device=cpu", "batch=4",
                f"project={root / 'runs'}"])
    out = capsys.readouterr().out
    assert "mAP50-95" in out and (task == "obb" or "pose" in out)


def test_pose_dataset_kpt_shape_rebuilds_the_head(tmp_path):
    data = generate_dataset(tmp_path / "ds", n_train=2, n_val=2, imgsz=S, nc=NC, seed=1,
                            task="pose")
    m = YOLO("yolo11n-pose.yaml", device="cpu")
    assert m.model.kpt_shape == (17, 3) and m.model.nc == 80
    m.train(data=str(data), project=str(tmp_path / "runs"), name="k", epochs=1, batch=2, nbs=2,
            imgsz=S, val=False, **AUG_OFF)
    assert m.model.kpt_shape == (5, 3) and m.model.nc == NC and m.model.model[-1].nk == 15
    again = YOLO(m.trainer.save_dir / "last.pt", device="cpu")
    assert again.model.kpt_shape == (5, 3)


def test_facade_task_checks():
    assert YOLO("yolo11n-pose.yaml", task="pose", device="cpu").task == "pose"
    assert YOLO("yolov8n-obb.yaml", task="obb", device="cpu").task == "obb"
    with pytest.raises(ValueError):
        YOLO("yolo11n-obb.yaml", task="pose", device="cpu")
    with pytest.raises(ValueError, match="not a classify one"):
        YOLO("yolo11n.yaml", task="classify", device="cpu")


def test_discs_and_wide_lines_equal_pil_draws():
    """utils/plotting.py's ellipse (a keypoint disc) and wide line (an OBB
    ring) against PIL's ImageDraw on random, partly off-canvas geometry:
    pixel for pixel."""
    from PIL import Image, ImageDraw

    from edgeyolo_tpu_torch.utils.plotting import ellipse, line

    rs = np.random.RandomState(0)
    for _ in range(300):
        im = np.zeros((60, 70, 3), np.uint8)
        x, y, r = rs.uniform(-5, 75), rs.uniform(-5, 65), rs.randint(1, 6)
        box = [x - r, y - r, x + r * rs.uniform(0.5, 2), y + r * rs.uniform(0.5, 2)]
        want = Image.fromarray(im.copy())
        ImageDraw.Draw(want).ellipse(box, fill=(0, 255, 0))
        got = im.copy()
        ellipse(got, box, (0, 255, 0))
        np.testing.assert_array_equal(got, np.asarray(want))
        pts = [tuple(rs.uniform(-10, 80, 2)) for _ in range(5)]
        width = int(rs.randint(2, 6))
        want = Image.fromarray(im.copy())
        ImageDraw.Draw(want).line(pts, fill=(255, 0, 0), width=width)
        got = im.copy()
        line(got, pts, (255, 0, 0), width)
        np.testing.assert_array_equal(got, np.asarray(want))
