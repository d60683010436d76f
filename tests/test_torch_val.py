"""NMS, metrics, the validator, Results and the streaming predictor of the
PyTorch port against the JAX package, on the CPU.

- NMS `multi_label` (and one label per anchor) by the matrix, scan and tiled
  methods: detections exactly equal to JAX's at small n; the tiled path
  exactly equal to the scan oracle at n = 12000 candidates in 40 clusters of
  near-duplicates (long suppression chains), whose last kept box ranks past
  the first two tiles of NMS_TILE.
- Metrics (smooth, compute_ap, ap_per_class, match_predictions, DetMetrics
  with mAP75, ConfusionMatrix, fitness) on seeded arrays: exactly JAX's. The
  torch twin of match_predictions_device: equal to JAX's twin and to the
  host matcher.
- The validator: a stub model on each side returns, for each val batch, the
  same `pred` made in advance (the letterboxed ground truth with seeded
  jitter and scores, plus duplicates and false positives), so both run the
  whole pipeline (loader, NMS, native-space boxes, matching, AP) on one
  input: results_dict equal to 1e-6.
- Results: Boxes' views, save_txt, to_json and verbose_str equal to JAX's.
- The streaming predictor: frames of three sizes in batches of 2 (the last
  repeated) through a stub model with a fixed `pred`: each frame's boxes
  equal to JAX's predictor's to 1e-4 px.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgeyolo_tpu.cfg import get_cfg as jget_cfg
from edgeyolo_tpu.engine.predictor import DetectionPredictor as JPredictor
from edgeyolo_tpu.engine.results import Results as JResults
from edgeyolo_tpu.engine.validator import DetectionValidator as JValidator
from edgeyolo_tpu.metrics import metrics as jmetrics
from edgeyolo_tpu.ops.nms import non_max_suppression as jnms
from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.data.dataset import build_dataloader, check_det_dataset, YOLODataset
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor
from edgeyolo_tpu_torch.engine.results import Results
from edgeyolo_tpu_torch.engine.validator import DetectionValidator
from edgeyolo_tpu_torch.metrics import metrics
from edgeyolo_tpu_torch.ops.nms import NMS_TILE, non_max_suppression
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

NC = 3


# -- NMS ----------------------------------------------------------------------------
def _pred(b, a, nc, seed, spread=100.0):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, spread, (b, a, 2))
    wh = rs.uniform(5, 30, (b, a, 2))
    sc = rs.rand(b, a, nc) ** 3
    return np.concatenate([xy, wh, sc], -1).astype(np.float32)


def _crowded_pred(b, n_obj, per_obj, nc, seed):
    """n_obj objects in a 640 px image, each predicted per_obj times with a
    few px of jitter in place and 15% in size."""
    rs = np.random.RandomState(seed)
    centre, size = rs.uniform(0, 640, (b, n_obj, 1, 2)), rs.uniform(16, 64, (b, n_obj, 1, 2))
    xy = centre + rs.normal(0, 3.0, (b, n_obj, per_obj, 2))
    wh = size * rs.uniform(0.85, 1.15, (b, n_obj, per_obj, 2))
    sc = rs.rand(b, n_obj * per_obj, nc) ** 3
    return np.concatenate([xy.reshape(b, -1, 2), wh.reshape(b, -1, 2), sc], -1).astype(np.float32)


@pytest.mark.parametrize("method", ["matrix", "scan", "tiled"])
@pytest.mark.parametrize("multi_label", [True, False])
@pytest.mark.parametrize("max_nms", [200, 3000])
def test_nms_matches_jax(method, multi_label, max_nms):
    pred = _pred(2, 300, 5, seed=0)
    kw = dict(conf_thres=0.05, iou_thres=0.5, max_det=100, max_nms=max_nms)
    jdet, jn = jnms(jnp.asarray(pred), multi_label=multi_label, nc=5, **kw)
    det, n = non_max_suppression(torch.from_numpy(pred), multi_label=multi_label, method=method,
                                 **kw)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert int(n.min()) > 10
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet)[:, :det.shape[1]])


@pytest.mark.parametrize("agnostic,classes", [(False, None), (True, None), (False, (0, 2))])
def test_tiled_nms_matches_the_scan_oracle_at_3000_candidates(agnostic, classes):
    """Crowded boxes (long suppression chains): the kept boxes reach past the
    first tiles; the tiled path's memory does not depend on max_nms."""
    pred = _crowded_pred(2, 40, 100, 3, seed=1)
    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=30000, multi_label=True,
              agnostic=agnostic, classes=classes)
    det_s, n_s = non_max_suppression(torch.from_numpy(pred), method="scan", **kw)
    det_t, n_t = non_max_suppression(torch.from_numpy(pred), method="tiled", **kw)
    assert torch.equal(n_t, n_s) and int(n_s.min()) > 100
    assert torch.equal(det_t, det_s[:, :det_t.shape[1]])
    # rank of the last kept candidate among the candidates: past the second tile
    scores = torch.from_numpy(pred[..., 4:])
    if classes is not None:
        scores = scores[..., list(classes)]
    last = torch.where(det_s[..., 4] > 0, det_s[..., 4], np.inf).amin(1)
    ranks = (scores.flatten(1) >= last[:, None]).sum(1)
    assert int(ranks.min()) > 2 * NMS_TILE, ranks


# -- metrics ------------------------------------------------------------------------
def _det_arrays(seed, n=400, nl=60):
    rs = np.random.RandomState(seed)
    tp = rs.rand(n, 10) < np.linspace(0.8, 0.2, 10)
    conf = rs.rand(n).astype(np.float32)
    pred_cls = rs.randint(0, 4, n).astype(np.float32)
    target_cls = rs.randint(0, 5, nl).astype(np.float32)
    return tp, conf, pred_cls, target_cls


def test_ap_per_class_and_helpers_equal_jax():
    tp, conf, pcls, tcls = _det_arrays(0)
    got, ref = metrics.ap_per_class(tp, conf, pcls, tcls), jmetrics.ap_per_class(tp, conf, pcls, tcls)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    y = np.random.RandomState(1).rand(333)
    np.testing.assert_array_equal(metrics.smooth(y, 0.1), jmetrics.smooth(y, 0.1))
    r, p = np.sort(np.random.RandomState(2).rand(50)), np.random.RandomState(3).rand(50)
    for a, b in zip(metrics.compute_ap(r, p), jmetrics.compute_ap(r, p)):
        np.testing.assert_array_equal(a, b)


def test_det_metrics_and_fitness_equal_jax():
    pm, jm = metrics.DetMetrics({0: "a"}), jmetrics.DetMetrics({0: "a"})
    for seed in range(3):
        tp, conf, pcls, tcls = _det_arrays(seed, n=100, nl=20)
        pm.update_batch(tp, conf, pcls, tcls)
        jm.update_batch(tp, conf, pcls, tcls)
    got, ref = pm.process().results_dict, jm.process().results_dict
    assert got == ref and 0.1 < got["metrics/mAP50-95(B)"] < 0.9
    assert "metrics/mAP75(B)" in got
    assert metrics.fitness(got) == jmetrics.fitness(ref) == got["metrics/mAP50-95(B)"]


def _match_case(seed, b=3, m=12, d=40):
    rs = np.random.RandomState(seed)
    iou = rs.rand(b, m, d).astype(np.float32)
    iou[:, :, ::7] = iou[:, :, 3:4]  # exact IoU ties across detections
    return (rs.randint(0, 3, (b, d)).astype(np.float32), rs.randint(0, 3, (b, m)).astype(np.float32),
            rs.rand(b, m) < 0.8, rs.rand(b, d) < 0.9, iou)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_predictions_host_and_torch_twin_equal_jax(seed):
    pc, tc, gv, dv, iou = _match_case(seed)
    ref = np.asarray(jax.vmap(jmetrics.match_predictions_device)(
        *(jnp.asarray(a) for a in (pc, tc, gv, dv, iou))))
    got = metrics.match_predictions_device(*(torch.from_numpy(a) for a in (pc, tc, gv, dv, iou)))
    np.testing.assert_array_equal(got.numpy(), ref)
    for i in range(len(pc)):
        args = (pc[i][dv[i]], tc[i][gv[i]], iou[i][gv[i]][:, dv[i]])
        np.testing.assert_array_equal(metrics.match_predictions(*args),
                                      jmetrics.match_predictions(*args))
        np.testing.assert_array_equal(metrics.match_predictions(*args), got[i][dv[i]].numpy())


def test_confusion_matrix_equals_jax():
    rs = np.random.RandomState(4)
    pm, jm = metrics.ConfusionMatrix(nc=3), jmetrics.ConfusionMatrix(nc=3)
    for _ in range(5):
        gt = np.sort(rs.uniform(0, 50, (6, 4)).reshape(6, 2, 2), axis=1).reshape(6, 4)
        det = np.concatenate([gt + rs.normal(0, 3, gt.shape), rs.rand(6, 1),
                              rs.randint(0, 3, (6, 1))], 1).astype(np.float32)
        gc = rs.randint(0, 3, 6).astype(np.float32)
        pm.process_batch(det, gt, gc)
        jm.process_batch(det, gt, gc)
    pm.process_batch(None, gt, gc)
    jm.process_batch(None, gt, gc)
    np.testing.assert_array_equal(pm.matrix, jm.matrix)
    assert pm.matrix.sum() > 20


# -- the validator ------------------------------------------------------------------
@pytest.fixture(scope="module")
def val_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("valdata")
    y = generate_dataset(root / "ds", n_train=1, n_val=6, imgsz=64, nc=NC, seed=5)
    cfg = check_det_dataset(y)
    loader = build_dataloader(YOLODataset(cfg["val"], imgsz=64), 4, shuffle=False)
    rs = np.random.RandomState(0)
    preds = []
    for batch in loader:
        pred = np.zeros((4, 60, 4 + NC), np.float32)
        for i, m in enumerate(batch["meta"]):
            h0, w0 = m["ori_shape"]
            r, (pw, ph) = m["ratio_pad"]
            rows = []
            for c, (x, y_, w, h) in zip(m["ori_cls"], m["ori_bboxes"]):
                box = np.array([x * w0 * r + pw, y_ * h0 * r + ph, w * w0 * r, h * h0 * r])
                for dup in range(3):  # one good detection and two looser duplicates
                    jit = box + rs.normal(0, 1.0 + 2 * dup, 4) * [1, 1, 0.5, 0.5]
                    sc = rs.uniform(0, 0.1, NC)
                    sc[int(c)] = rs.uniform(0.4, 0.95) * (0.6 ** dup)
                    rows.append(np.concatenate([jit, sc]))
            while len(rows) < 60:  # false positives
                rows.append(np.concatenate([rs.uniform(5, 60, 2), rs.uniform(4, 30, 2),
                                            rs.uniform(0, 0.3, NC) ** 2]))
            pred[i] = np.asarray(rows[:60], np.float32)
        preds.append(pred)
    return y, preds


class _Feed:
    """Returns the prepared preds, one per call, in order."""

    def __init__(self, preds):
        self.preds, self.i = preds, 0

    def next(self):
        p = self.preds[self.i % len(self.preds)]
        self.i += 1
        return p


def test_validator_results_equal_jax_on_the_same_pred(val_data):
    y, preds = val_data
    overrides = {"mode": "val", "data": str(y), "imgsz": 64, "batch": 4, "conf": 0.001,
                 "iou": 0.7, "max_det": 300, "plots": False}
    jfeed, pfeed = _Feed(preds), _Feed(preds)
    jmodel = SimpleNamespace(nc=NC, variables={}, eager_only=True, quant=None,
                             apply=lambda v, img, train=False: {"pred": jfeed.next()})
    ref = JValidator(jget_cfg(overrides=overrides))(jmodel)
    validator = DetectionValidator(get_cfg(overrides=overrides), device="cpu")
    got = validator(lambda x: {"pred": torch.from_numpy(pfeed.next())})
    print(f"port {got}\nJAX  {ref}")
    assert jfeed.i == pfeed.i == 2 and validator.seen == 6
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k
    assert 0.3 < got["metrics/mAP50-95(B)"] < 0.95 and got["metrics/mAP75(B)"] > 0.3
    assert "mAP" not in validator.results_line() and len(validator.results_line().split()) == 7


# -- Results and the predictor ------------------------------------------------------
def _dets(seed, n=5, h=50, w=70):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, [w, h], (n, 2))
    wh = rs.uniform(2, 20, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, [w, h]), rs.rand(n, 1),
                           rs.randint(0, NC, (n, 1))], 1).astype(np.float32)


def test_results_equal_jax(tmp_path):
    img = np.zeros((50, 70, 3), np.uint8)
    names = {0: "rectangle", 1: "ellipse", 2: "cross"}
    det = _dets(0)
    pr, jr = Results(img, "a.png", names, boxes=det), JResults(img, "a.png", names, boxes=det)
    for attr in ("xyxy", "xywh", "xyxyn", "xywhn", "conf", "cls"):
        np.testing.assert_array_equal(getattr(pr.boxes, attr), getattr(jr.boxes, attr), attr)
    assert pr.verbose_str == jr.verbose_str and len(pr) == len(jr) == 5
    assert pr.to_json() == jr.to_json() and pr.to_json(normalize=True) == jr.to_json(normalize=True)
    for save_conf in (False, True):
        pr.save_txt(tmp_path / f"p{save_conf}.txt", save_conf=save_conf)
        jr.save_txt(tmp_path / f"j{save_conf}.txt", save_conf=save_conf)
        assert (tmp_path / f"p{save_conf}.txt").read_text() == \
            (tmp_path / f"j{save_conf}.txt").read_text()
    empty = Results(img, "b.png", names, boxes=np.zeros((0, 6)))
    assert empty.verbose_str == "(no detections)" and len(empty[0:0]) == 0


class _Stub(torch.nn.Module):
    def __init__(self, pred):
        super().__init__()
        self.pred, self.nc, self.dtype = torch.from_numpy(pred), NC, torch.float32
        self.names = {0: "rectangle", 1: "ellipse", 2: "cross"}

    def forward(self, x):
        return {"pred": self.pred.expand(x.shape[0], *self.pred.shape)}


def test_predictor_stream_equals_jax(tmp_path):
    pred = _pred(1, 84, NC, seed=7, spread=64.0)[0]
    frames = [np.random.RandomState(i).randint(0, 256, s).astype(np.uint8)
              for i, s in enumerate([(50, 70, 3), (64, 64, 3), (90, 40, 3)])]
    jargs = jget_cfg(overrides={"mode": "predict", "imgsz": 64, "batch": 2, "conf": 0.25,
                                "save": False, "verbose": False})
    jmodel = SimpleNamespace(nc=NC, variables={}, quant=None, names=_Stub(pred).names,
                             apply=lambda v, img, train=False: {
                                 "pred": jnp.broadcast_to(jnp.asarray(pred), (img.shape[0],) + pred.shape)})
    ref = JPredictor(jargs, save_dir=tmp_path / "j")(jmodel, frames)
    predictor = DetectionPredictor(_Stub(pred), conf=0.25, device="cpu", imgsz=64, batch=2,
                                   save_txt=True, save_dir=tmp_path / "p")
    got = predictor.predict(frames)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.path == r.path and g.orig_shape == r.orig_shape and len(g) == len(r) > 0
        np.testing.assert_allclose(g.boxes.data, r.boxes.data, atol=1e-4, rtol=0)
        assert set(g.speed) == {"preprocess", "inference", "postprocess"}
        assert ((g.boxes.xyxy >= 0) & (g.boxes.xyxy <= [r.orig_shape[1], r.orig_shape[0]] * 2)).all()
    assert len(list((tmp_path / "p" / "labels").glob("*.txt"))) == 3
    det, n = predictor(np.stack([frames[1]]))  # the serving step on a uint8 batch
    assert det.shape == (1, 84, 6) and int(n[0]) == len(got[1])  # max_det capped at 84 anchors
