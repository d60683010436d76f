"""The classify task's data, trainer, validator, predictor, results, facade,
CLI and the callback bus in the PyTorch port against the JAX package, on the
CPU in f32. The dataset files are written by JAX's
`generate_classify_dataset` (gratings under noise, JPEG q92), so both
packages read the same files.

- check_cls_dataset on the train/val, train/validation, train/test and flat
  layouts, ClassificationDataset's samples and items (each image byte for
  byte, greyscale and RGBA files included), `fraction`, and ClassifyLoader's
  batches over two shuffled epochs with and without drop_last: equal to
  JAX's.
- Three train steps of yolo11n-cls (nc 3, 96 px, batch 4) from the same
  variables against JAX's train_step math (its classify_augment_batch on the
  step's key, whose draws the port replays; HSV and RandAugment off, as the
  detect steps run): losses rel 1e-4, params and EMA 1e-5, BatchNorm
  statistics 1e-5.
- The validator's top-1 and top-5 equal JAX's on the same weights, and on
  logits that all tie (jax.lax.top_k's order: the lower index first); the
  predictor's probabilities 1e-5; Probs and the Results outputs for probs
  as JAX's.
- The facade rebuilds the head for the dataset's classes (JAX's parameter
  count), trains with its callbacks, validates, predicts and reloads its
  checkpoints (best.pt and last.pt the same bytes after an improving
  epoch); the CLI's classify val and predict; the detect trainer fires the
  same events.
"""

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from PIL import Image
from test_torch_classify import _filled, jax_classify_params
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.data import augment_device as jaug
from edgeyolo_tpu.data import classify as jcls
from edgeyolo_tpu.data.synthetic import generate_classify_dataset
from edgeyolo_tpu.engine import classify as jengine
from edgeyolo_tpu.engine.results import Results as JResults
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.train import trainer as jtrainer
from edgeyolo_tpu.utils import callbacks as jcallbacks
from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.cfg.cli import entrypoint
from edgeyolo_tpu_torch.data import augment_device as aug
from edgeyolo_tpu_torch.data import classify as pcls
from edgeyolo_tpu_torch.engine.classify import ClassificationPredictor, ClassificationValidator
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.engine.results import Results
from edgeyolo_tpu_torch.nn.tasks import ClassificationModel, num_params
from edgeyolo_tpu_torch.train import classify as tclassify
from edgeyolo_tpu_torch.train.classify import ClassificationTrainer
from edgeyolo_tpu_torch.train.trainer import batch_to_device
from edgeyolo_tpu_torch.utils import callbacks
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

NC, S = 3, 64
S_TRAIN = 96  # the train steps' side: the last maps 3 x 3, so BatchNorm's batch statistics
# over 4 images are well conditioned (at 2 x 2 JAX's E[x^2] - E[x]^2 variance parts by 2e-4)
TRAIN_EVENTS = ["on_train_start", "on_train_epoch_start", "on_train_epoch_end",
                "on_fit_epoch_end", "on_model_save"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cls") / "data"
    return generate_classify_dataset(root, nc=NC, n_train_per_class=4, n_val_per_class=3,
                                     seed=0)


@pytest.fixture(scope="module")
def weights():
    """yolo11n-cls (nc 3) variables from a numpy seed (kernels x 2.5: the
    logits depend on the image), as JAX's handle and the port's model."""
    jm = jtasks.ClassificationModel("yolo11n-cls.yaml", nc=NC)
    x = jnp.zeros((1, S, S, 3))
    flat = _filled(jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), x, train=False)),
                   2.5)
    jm.variables = jax.tree.map(jnp.asarray, traverse_util.unflatten_dict(flat))
    pm = ClassificationModel("yolo11n-cls.yaml", nc=NC, device="cpu")
    pm.load_state_dict(from_jax_variables(flat), strict=False)
    return jm, pm, flat


# ---------------------------------------------------------------------------------------------
# data
@pytest.mark.parametrize("layout", ["train-val", "train-validation", "train-test", "flat"])
def test_check_cls_dataset_matches_jax(tmp_path, layout):
    splits = {"train-val": ("train", "val"), "train-validation": ("train", "validation"),
              "train-test": ("train", "test"), "flat": ("",)}[layout]
    for split in splits:
        for c in ("b_cls", "a_cls"):
            (tmp_path / split / c).mkdir(parents=True)
    assert pcls.check_cls_dataset(tmp_path) == jcls.check_cls_dataset(tmp_path)
    with pytest.raises(FileNotFoundError):
        pcls.check_cls_dataset(tmp_path / "missing")


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_dataset_items_equal_jax(data, fraction):
    names = jcls.check_cls_dataset(data)["names"]
    j = jcls.ClassificationDataset(data / "train", imgsz=S, fraction=fraction, names=names)
    p = pcls.ClassificationDataset(data / "train", imgsz=S, fraction=fraction, names=names)
    assert p.samples == j.samples and len(p) == len(j) and p.names == j.names
    for i in range(len(j)):
        a, b = j.get_item(i), p.get_item(i)
        np.testing.assert_array_equal(b["img"], a["img"])
        assert b["cls"] == a["cls"] and b["im_file"] == a["im_file"]


def test_grey_and_rgba_files_become_rgb_as_pil(tmp_path):
    rs = np.random.RandomState(1)
    d = tmp_path / "c0"
    d.mkdir()
    Image.fromarray(rs.randint(0, 256, (50, 70), np.uint8)).save(d / "grey.png")
    Image.fromarray(rs.randint(0, 256, (70, 50), np.uint8)).save(d / "grey.jpg", quality=90)
    Image.fromarray(rs.randint(0, 256, (40, 60, 4), np.uint8), "RGBA").save(d / "rgba.png")
    j, p = jcls.ClassificationDataset(tmp_path, imgsz=S), pcls.ClassificationDataset(tmp_path, S)
    for i in range(3):
        np.testing.assert_array_equal(p.get_item(i)["img"], j.get_item(i)["img"])
    (d / "x.webp").write_bytes(b"RIFF\x00\x00\x00\x00WEBPVP8 ")
    with pytest.raises(ValueError):
        pcls.ClassificationDataset(tmp_path, imgsz=S).get_item(3)


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_equal_jax(data, drop_last):
    names = jcls.check_cls_dataset(data)["names"]
    jl = jcls.ClassifyLoader(jcls.ClassificationDataset(data / "train", S, names=names), 5,
                             shuffle=True, seed=3, drop_last=drop_last)
    pl = pcls.ClassifyLoader(pcls.ClassificationDataset(data / "train", S, names=names), 5,
                             shuffle=True, seed=3, drop_last=drop_last)
    assert len(pl) == len(jl) == (2 if drop_last else 3)
    for _ in range(2):  # two epochs: the shuffle advances with the epoch
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) == len(pl)
        for a, b in zip(jb, pb):
            np.testing.assert_array_equal(b["img"], a["img"])
            np.testing.assert_array_equal(b["cls"], a["cls"])
            assert b["n_real"] == a["n_real"]
            assert [m["im_file"] for m in b["meta"]] == [m["im_file"] for m in a["meta"]]
    assert drop_last or pb[-1]["n_real"] == 2


# ---------------------------------------------------------------------------------------------
# the trainer
def _jax_steps(jm, flat, batches, keys, hyp, nb):
    """JAX's ClassificationTrainer.train_step (edgeyolo_tpu/train/classify.py) over the
    batches: SGD nesterov, accumulate 1, no warmup, decay scaled as there."""
    net = jm.net
    variables = traverse_util.unflatten_dict(flat)
    params = jax.tree.map(jnp.asarray, variables["params"])
    batch_stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    lr0, lrf, momentum, epochs, bs = 0.01, 0.01, 0.937, 1, 4
    decay = 0.0005 * bs * 1 / bs

    def lr_at(step):
        e = step * 1 / nb
        return lr0 * (jnp.maximum(1 - e / epochs, 0.0) * (1.0 - lrf) + lrf)

    tx = optax.MultiSteps(jtrainer.build_optimizer(params, "SGD", lr0, momentum, decay, lr_at),
                          every_k_schedule=1)

    @jax.jit
    def train_step(state, images, labels, key):
        params, batch_stats, opt_state, ema, step = state
        x = jaug.classify_augment_batch(images, key, hyp)

        def loss_fn(p):
            logits, mut = net.apply({"params": p, "batch_stats": batch_stats}, x, train=True,
                                    mutable=["batch_stats"])
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            return -jnp.take_along_axis(logp, labels[:, None], axis=-1).mean(), mut["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        did = (new_opt.mini_step == 0).astype(jnp.int32)
        upd = step + did
        d = jnp.where(did == 1, 0.9999 * (1 - jnp.exp(-upd / 2000.0)), 1.0)
        new_ema = jax.tree.map(lambda e, p: e * d + (1 - d) * p, ema, new_params)
        return (new_params, new_bs, new_opt, new_ema, upd), loss

    state = (params, batch_stats, tx.init(params), jax.tree.map(jnp.copy, params),
             jnp.asarray(0, jnp.int32))
    losses = []
    for (img, cls), key in zip(batches, keys):
        state, loss = train_step(state, jnp.asarray(img), jnp.asarray(cls, jnp.int32), key)
        losses.append(float(loss))
    return losses, state


def test_three_train_steps_match_jax(weights):
    jm, _, flat = weights
    hyp = {"hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "fliplr": 0.5, "scale": 0.5,
           "auto_augment": "", "erasing": 0.4}
    rs = np.random.RandomState(7)
    batches = [(rs.randint(0, 256, (4, S_TRAIN, S_TRAIN, 3)).astype(np.uint8),
                rs.randint(0, NC, 4)) for _ in range(3)]
    keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
    j_losses, j_state = _jax_steps(jm, flat, batches, keys, hyp, nb=3)

    pm = ClassificationModel("yolo11n-cls.yaml", nc=NC, device="cpu")
    pm.load_state_dict(from_jax_variables(flat), strict=False)
    trainer = ClassificationTrainer(pm, {"batch": 4, "nbs": 4, "epochs": 1, "optimizer": "SGD",
                                         "warmup_epochs": 0.0, "amp": False, **hyp}, device="cpu")
    trainer.setup(nb=3)
    draws = iter(jax_classify_params(k, 4, S_TRAIN, hyp) for k in keys)
    replay = lambda images, gen, a: aug.classify_apply(images, next(draws))  # noqa: E731
    p_losses = []
    with mock.patch.object(tclassify, "classify_augment_batch", replay):
        for img, cls in batches:
            loss, _, updated = trainer.train_step(batch_to_device(
                {"img": img, "cls": cls, "n_real": 4}, torch.device("cpu")))
            assert updated
            p_losses.append(loss.item())
    print(f"losses port {p_losses} JAX {j_losses}")
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4)
    params, stats, _, ema, upd = j_state
    assert int(upd) == trainer.ema.updates == 3
    sd = dict(pm.state_dict())
    want = from_jax_variables({("params", *k): np.asarray(v) for k, v in
                               traverse_util.flatten_dict(params).items()})
    want_ema = from_jax_variables({("params", *k): np.asarray(v) for k, v in
                                   traverse_util.flatten_dict(ema).items()})
    got_ema = trainer.ema_state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(got_ema[k].numpy(), want_ema[k].numpy(), atol=1e-5, rtol=0)
    for k, v in from_jax_variables({("batch_stats", *k): np.asarray(v) for k, v in
                                    traverse_util.flatten_dict(stats).items()}).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------------------------
# the validator, the predictor and the results
def test_validator_matches_jax(data, weights):
    jm, pm, _ = weights
    cfg = jcls.check_cls_dataset(data)
    from edgeyolo_tpu.cfg import get_cfg as jget_cfg

    jm.names = cfg["names"]
    jv = jengine.ClassificationValidator(jget_cfg(overrides={"mode": "val", "imgsz": S,
                                                             "task": "classify"}))
    want = jv(jm, data=cfg, batch_size=4)
    pv = ClassificationValidator(get_cfg(overrides={"mode": "val", "imgsz": S,
                                                    "task": "classify"}), device="cpu")
    got = pv(pm, data=cfg, batch_size=4)
    assert got == want and pv.seen == 9 and got["metrics/accuracy_top5"] == 1.0


def test_validator_ties_take_the_lower_index_as_jax(data):
    cfg = jcls.check_cls_dataset(data)
    jstub = mock.Mock(apply=lambda v, x, train=False: jnp.zeros((x.shape[0], NC)), variables={})
    from edgeyolo_tpu.cfg import get_cfg as jget_cfg

    want = jengine.ClassificationValidator(jget_cfg(overrides={"mode": "val", "imgsz": S}))(
        jstub, data=cfg, batch_size=4)

    class Tied(torch.nn.Module):
        def forward(self, x):
            return torch.zeros(x.shape[0], NC)

    got = ClassificationValidator(get_cfg(overrides={"mode": "val", "imgsz": S}),
                                  device="cpu")(Tied(), data=cfg, batch_size=4)
    assert got == want and abs(got["metrics/accuracy_top1"] - 1 / 3) < 1e-9


def test_predictor_probs_match_jax(data, weights):
    jm, pm, _ = weights
    from edgeyolo_tpu.cfg import get_cfg as jget_cfg

    src = str(data / "val" / "grating_1")
    jp = jengine.ClassificationPredictor(jget_cfg(overrides={"mode": "predict", "imgsz": S,
                                                             "batch": 2, "verbose": False}))
    want = jp(jm, src)
    got = ClassificationPredictor(pm, device="cpu", imgsz=S, batch=2).predict(src)
    assert [r.path for r in got] == [r.path for r in want] and len(got) == 3
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.probs.data, a.probs.data, atol=1e-5, rtol=0)
        assert b.probs.top1 == a.probs.top1 and b.probs.top5 == a.probs.top5
        assert abs(b.probs.top1conf - a.probs.top1conf) < 1e-5
        assert set(b.speed) == {"preprocess", "inference", "postprocess"}


def test_probs_and_results_outputs_as_jax(tmp_path):
    rs = np.random.RandomState(2)
    probs = rs.dirichlet(np.ones(8)).astype(np.float32)
    img = rs.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    names = {i: f"c{i}" for i in range(8)}
    j, p = JResults(img, "a.jpg", names, probs=probs), Results(img, "a.jpg", names, probs=probs)
    assert (p.probs.top1, p.probs.top5, p.probs.top1conf) == (j.probs.top1, j.probs.top5,
                                                              j.probs.top1conf)
    np.testing.assert_array_equal(p.probs.top5conf, probs[j.probs.top5])
    assert p.to_json() == j.to_json() and json.loads(p.to_json()) == []
    assert p.verbose_str == j.verbose_str and len(p) == len(j) == 0
    np.testing.assert_array_equal(p.plot(), j.plot())
    p.save_txt(tmp_path / "labels" / "a.txt")
    p.save_crop(tmp_path / "crops")
    assert not (tmp_path / "labels").exists() and not (tmp_path / "crops").exists()


# ---------------------------------------------------------------------------------------------
# the facade, the CLI and the callbacks
@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    runs = tmp_path_factory.mktemp("runs")
    m = YOLO("yolo11n-cls.yaml", device="cpu")
    events = []
    for e in callbacks.EVENTS:
        m.add_callback(e, lambda t, e=e: events.append((e, t.epoch)))
    saved = []
    m.add_callback("on_model_save", lambda t: saved.append(
        ((t.save_dir / "best.pt").read_bytes(), (t.save_dir / "last.pt").read_bytes(),
         t.best_fitness, dict(t.last_metrics))))
    log = runs / "events.jsonl"
    callbacks.JSONLLogger(log).register(m)
    m.train(data=str(data), epochs=2, batch=4, nbs=4, imgsz=S, project=str(runs), name="cls",
            optimizer="SGD", warmup_epochs=0.0, amp=False)
    return m, runs, events, saved, log


def test_facade_rebuilds_the_head_for_the_dataset(trained):
    m = trained[0]
    assert m.task == "classify" and m.model.nc == NC and m.names == {0: "grating_0",
                                                                     1: "grating_1",
                                                                     2: "grating_2"}
    assert num_params(m.model) == jtasks.ClassificationModel("yolo11n-cls.yaml",
                                                             nc=NC).count_params(S)
    with pytest.raises(ValueError, match="not a detect one"):
        YOLO("yolo11n-cls.yaml", task="detect", device="cpu")


def test_facade_trains_validates_predicts_and_reloads(trained, data):
    m, runs, _, saved, _ = trained
    run = m.trainer.save_dir
    csv = (run / "results.csv").read_text().splitlines()
    assert csv[0].split(",")[:3] == ["epoch", "time", "train/loss"] and len(csv) == 3
    meta = json.loads((run / "last.json").read_text())
    assert meta["task"] == "classify" and meta["nc"] == NC and meta["model_yaml"].startswith(
        "yolo11n-cls")
    for best, last, fitness, metrics in saved:  # an improving epoch writes one checkpoint twice
        if metrics["fitness"] >= fitness - 1e-12 and best == last:
            break
    else:
        raise AssertionError("no epoch wrote best.pt and last.pt from one buffer")
    again = YOLO(run / "best.pt", device="cpu")
    assert again.task == "classify" and again.model.nc == NC
    got = again.val(data=str(data), batch=4, project=str(runs))
    assert got == m.trainer.best_metrics
    res = again.predict(str(data / "val" / "grating_0"), project=str(runs))
    assert len(res) == 3 and all(r.probs is not None and r.probs.data.shape == (NC,) for r in res)


def test_callbacks_fire_as_jax(trained):
    _, _, events, _, log = trained
    assert callbacks.EVENTS == jcallbacks.EVENTS
    per_epoch = [e for e in TRAIN_EVENTS if e != "on_train_start"]
    assert [e for e, _ in events] == (["on_train_start"] + per_epoch * 2
                                      + ["on_train_end", "teardown"])
    assert [ep for e, ep in events if e == "on_train_epoch_start"] == [0, 1]
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["event"] for x in lines] == ["on_train_epoch_end", "on_model_save"] * 2 + [
        "on_train_end"]
    assert all("epoch" in x and "best_fitness" in x for x in lines)
    m = YOLO("yolo11n-cls.yaml", device="cpu")
    with pytest.raises(KeyError):
        m.add_callback("on_no_such_event", print)
    m.add_callback("on_train_end", print)
    m.reset_callbacks()
    assert not any(m.callbacks.values())


def test_detect_trainer_fires_the_same_events(tmp_path):
    from edgeyolo_tpu_torch.data.synthetic import generate_dataset

    yaml = generate_dataset(tmp_path / "det", n_train=2, n_val=2, imgsz=64, seed=0)
    m = YOLO("yolo11n.yaml", device="cpu")
    events = []
    for e in callbacks.EVENTS:
        m.add_callback(e, lambda t, e=e: events.append(e))
    m.train(data=str(yaml), epochs=1, batch=2, nbs=2, imgsz=64, project=str(tmp_path),
            name="det", warmup_epochs=0.0, amp=False, mosaic=0.0, photometric=0.0)
    assert events == TRAIN_EVENTS + ["on_train_end", "teardown"]
    run = m.trainer.save_dir
    assert (run / "best.pt").read_bytes() == (run / "last.pt").read_bytes()


def test_cli_classify_val_and_predict(trained, data, capsys):
    m, runs = trained[0], trained[1]
    best = m.trainer.save_dir / "best.pt"
    entrypoint(["classify", "val", f"model={best}", f"data={data}", "device=cpu", "batch=4",
                f"project={runs}"])
    out = capsys.readouterr().out
    assert "top1" in out and "top5" in out and "all" in out
    entrypoint(["classify", "predict", f"model={best}", f"source={data / 'val' / 'grating_2'}",
                "device=cpu", f"project={runs}"])
    out = capsys.readouterr().out
    assert "3 images processed" in out and "grating_" in out
