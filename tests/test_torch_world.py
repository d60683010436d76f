"""YOLO-World in the PyTorch port against the JAX package, on the CPU in f32.

- Each World block (MaxSigmoidAttnBlock with and without its embedding conv,
  C2fAttn, ImagePoolingAttn over three levels, one of them smaller than its
  3 x 3 bins, ContrastiveHead, BNContrastiveHead, WorldDetect with either
  head): JAX's variables from `jax.eval_shape`, filled from a seeded numpy
  generator (kernels U(+-1/sqrt(fan_in)) x 1.5, the similarity heads' bias
  spread around 0 so their scores straddle 0.5, their logit scale moved),
  carried in by `from_jax_variables`, the same NHWC / NCHW inputs and texts:
  within 1e-5 of the output's largest magnitude.
- Both YAMLs at scale n: byte-identical copies; their layer specs, save
  lists and strides as JAX parses them (ImagePoolingAttn's input channels
  ride in its kwargs in the port, where flax infers them); JAX's parameter
  count plus the 16 frozen DFL bins; the seeded weights perturbed as the
  family tests perturb them (x2.5, yolov8n's SCALE) with the similarity biases spread,
  carried onto JAX's tree (strict), back by `from_jax_variables` equal
  tensor for tensor; the 64 px pred of two images with a 4-text bank:
  boxes 5e-3 px, scores 1e-4 (the family tolerances).
- The facade: `YOLOWorld` builds a WorldModel, `set_classes` swaps the bank,
  `nc` (the head's too) and `names`; strings without CLIP's files raise as
  JAX's; `predict` and `val` run on a synthetic set; on the same
  predictions (JAX's World model, compiled, with the port's weights and
  bank) JAX's validator and the port's give every metric within 1e-6.
- One f32 SGD step of yolov8-worldv2-n (batch 2, augmentation off) against
  JAX's train-step math on JAX's WorldModel.apply: the loss at rel 1e-4,
  params and BatchNorm statistics at 1e-5 abs + 1e-4 rel.
- A checkpoint reloads as JAX's does (no bank), and export works where
  JAX's exporter works and raises where it raises.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.flatten_util import ravel_pytree
from test_torch_families import _imgs, _perturb
from torch_family_checks import check_copy, jax_spec, to_jax
from jax_host import flat_decay_mask, unravel_host
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

import edgeyolo_tpu_torch
from edgeyolo_tpu.cfg import get_cfg as jget_cfg
from edgeyolo_tpu.engine import validator as jvalidator
from edgeyolo_tpu.export.exporter import Exporter as JaxExporter
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import world as jworld
from edgeyolo_tpu.train import trainer as jtrainer
from edgeyolo_tpu.train.loss import DetectionLoss as JDetectionLoss
from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.cfg.models import model_cfg
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine.validator import DetectionValidator
from edgeyolo_tpu_torch.export.exporter import Exporter
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.modules import world
from edgeyolo_tpu_torch.nn.tasks import WorldModel, num_params
from edgeyolo_tpu_torch.train import trainer
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

S, K = 64, 4
RTOL = 1e-5
YAMLS = ("yolov8-world.yaml", "yolov8-worldv2.yaml")


def _fill(rs, path, shape):
    leaf = path[-1]
    if leaf == "kernel":
        bound = float(np.prod(shape[:-1])) ** -0.5
        return rs.uniform(-bound, bound, shape) * 1.5
    if leaf == "var":
        return rs.uniform(0.5, 1.5, shape)
    if leaf == "scale":
        return 1.0 + rs.randn(*shape) * 0.1
    if leaf == "logit_scale":
        return np.float32(rs.uniform(-0.5, 1.0))
    if leaf == "bias" and path[-2].startswith("cv4") or leaf == "bias" and len(path) == 2:
        return rs.randn(*shape) * 0.5  # the similarity heads' bias, spread around 0
    if leaf in ("bias", "mean"):
        return rs.randn(*shape) * 0.1
    raise KeyError(path)


def _variables(jmod, *args, seed=0):
    with jconv.bn_config():
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    rs = np.random.RandomState(seed)
    return {k: np.asarray(_fill(rs, k, s.shape), np.float32)
            for k, s in traverse_util.flatten_dict(shapes).items()}


def _randn(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (err, scale)


TEXT = _randn(2, 5, 48, seed=2)
BLOCKS = {  # id: (JAX module, port module, NHWC input(s), texts, how the port's output reads)
    "max_sigmoid_attn": (jworld.MaxSigmoidAttnBlock(32, 32, nh=4, ec=64, gc=48),
                         world.MaxSigmoidAttnBlock(32, 32, 4, 64, 48), _randn(2, 9, 11, 32),
                         TEXT, "nchw"),
    "max_sigmoid_attn_c1_is_ec": (jworld.MaxSigmoidAttnBlock(64, 32, nh=2, ec=64, gc=48),
                                  world.MaxSigmoidAttnBlock(64, 32, 2, 64, 48),
                                  _randn(2, 7, 5, 64), TEXT, "nchw"),
    "c2f_attn": (jworld.C2fAttn(48, n=2, ec=32, nh=2, gc=48, shortcut=True),
                 world.C2fAttn(40, 48, 2, 32, 2, 48, True), _randn(2, 9, 11, 40), TEXT, "nchw"),
    "image_pooling_attn": (jworld.ImagePoolingAttn(ec=32, ct=48, nh=4),
                           world.ImagePoolingAttn(32, (24, 40, 56), 48, 4),
                           [_randn(2, 16, 16, 24), _randn(2, 8, 8, 40, seed=3),
                            _randn(2, 2, 3, 56, seed=4)], TEXT, "text"),
    "contrastive_head": (jworld.ContrastiveHead(), world.ContrastiveHead(), _randn(2, 9, 11, 48),
                         TEXT, "nchw"),
    "bn_contrastive_head": (jworld.BNContrastiveHead(48), world.BNContrastiveHead(48),
                            _randn(2, 9, 11, 48), TEXT, "nchw"),
}
for _bn in (False, True):
    BLOCKS[f"world_detect{'_bn' if _bn else ''}"] = (
        jworld.WorldDetect(nc=5, ch=(16, 32, 64), stride=(8, 16, 32), embed=48, with_bn=_bn),
        world.WorldDetect(5, 48, _bn, ch=(16, 32, 64), stride=(8, 16, 32)),
        [_randn(2, 8, 8, 16), _randn(2, 4, 4, 32, seed=3), _randn(2, 2, 2, 64, seed=4)],
        TEXT, "pred")


@pytest.mark.parametrize("case", list(BLOCKS))
def test_world_block_matches_jax(case):
    jmod, tmod, x, text, kind = BLOCKS[case]
    xj = [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)
    flat = _variables(jmod, xj, jnp.asarray(text)) if kind != "pred" else None
    if kind == "pred":  # WorldDetect takes the texts by keyword
        with jconv.bn_config():
            shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), xj, text=text))
        rs = np.random.RandomState(0)
        flat = {k: np.asarray(_fill(rs, k, s.shape), np.float32)
                for k, s in traverse_util.flatten_dict(shapes).items()}
        with jconv.bn_config():
            want = jax.jit(lambda v, a, t: jmod.apply(v, a, text=t)["pred"])(
                traverse_util.unflatten_dict(flat), xj, jnp.asarray(text))
    else:
        with jconv.bn_config():
            want = jax.jit(jmod.apply)(traverse_util.unflatten_dict(flat), xj, jnp.asarray(text))
    missing, unexpected = tmod.load_state_dict(from_jax_variables(flat), strict=False)
    assert not unexpected and missing == (["dfl.conv.weight"] if kind == "pred" else [])
    xt = [_nchw(a) for a in x] if isinstance(x, list) else _nchw(x)
    with torch.no_grad():
        got = tmod.eval()(xt, torch.from_numpy(text))
    if kind == "pred":
        got = got["pred"].numpy()
    elif kind == "nchw":
        got = got.numpy().transpose(0, 2, 3, 1)
    else:
        got = got.numpy()
    assert_close(got, want)
    if kind == "pred":
        assert (got[..., 4:] > 0.25).any() and (got[..., 4:] < 0.25).any()


def _bank(k=K, seed=5):
    e = np.random.RandomState(seed).randn(k, 512).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def _world_perturbed(sd):
    out = _perturb(sd, 2.5)
    rs = np.random.RandomState(1)
    for k, v in out.items():
        if ".cv4." in k and k.endswith(".bias"):
            out[k] = torch.from_numpy((rs.randn(*v.shape) * 0.5 - 1.5).astype(np.float32))
    return out


def _jax_world(yaml, scale="n"):
    jm = jtasks.WorldModel(jax_spec(yaml, scale))
    jm.set_classes(_bank(), names=[f"c{i}" for i in range(K)])
    t = jnp.zeros((1, K, 512), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False, text=t))
    return jm, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


_FAMILY = {}


def _family(yaml):
    if yaml not in _FAMILY:
        pm = WorldModel(yaml, scale="n", device="cpu")
        pm.set_classes(_bank(), names=[f"c{i}" for i in range(K)])
        sd = _world_perturbed(pm.state_dict())
        pm.load_state_dict(sd)
        jm, template = _jax_world(yaml)
        variables, rep = to_jax(pm, sd, template)
        jm.variables = jax.tree.map(jnp.asarray, variables)
        imgs = _imgs()
        japply = jax.jit(lambda v, x: jm.apply(v, x)["pred"])  # on 2 images of S px
        jpred = np.asarray(japply(jm.variables, jnp.asarray(imgs, jnp.float32) / 255.0))
        with torch.no_grad():
            pred = pm(torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255)["pred"].numpy()
        _FAMILY[yaml] = {"yaml": yaml, "pm": pm, "sd": sd, "jm": jm, "template": template,
                         "variables": variables, "report": rep, "pred": pred, "jpred": jpred,
                         "japply": japply}
    return _FAMILY[yaml]


@pytest.fixture(scope="module", params=YAMLS)
def family(request):
    return _family(request.param)


@pytest.fixture(scope="module")
def v2():
    """The v2 model, which the facade, train and checkpoint tests take."""
    return _family("yolov8-worldv2.yaml")


def test_yaml_copies_specs_and_counts_match_jax(family):
    yaml = family["yaml"]
    check_copy(yaml)
    jlayers, jsave, _ = jtasks.parse_spec(jax_spec(yaml, "n"))
    layers, save, info = tasks.parse_spec(model_cfg(yaml, "n"))
    assert save == jsave and info["scale"] == "n"
    for s, j in zip(layers, jlayers, strict=True):
        kw = {k: v for k, v in s.kwargs if not (s.name == "ImagePoolingAttn" and k == "ch")}
        assert (s.i, s.f, s.n, s.name, s.args, kw, s.c2) == \
            (j.i, j.f, j.n, j.name, j.args, dict(j.kwargs), j.c2)
    assert tasks.derive_strides(layers) == jtasks.derive_strides(jlayers)
    counts = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(family["template"]["params"]))
    assert num_params(family["pm"]) == counts + 16
    assert family["jm"].count_params(S) == counts


def test_weights_bridge_both_ways(family):
    sd, rep, pm = family["sd"], family["report"], family["pm"]
    head = len(pm.model) - 1
    assert rep["unused"] == [f"model.{head}.dfl.conv.weight"] and not rep["missing"]
    back = from_jax_variables(traverse_util.flatten_dict(family["variables"]))
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")} - set(
        rep["unused"])
    assert all(torch.equal(back[k], sd[k]) for k in back)


def test_pred_matches_jax(family):
    pred, jpred = family["pred"], family["jpred"]
    anchors = sum((S // s) ** 2 for s in (8, 16, 32))
    assert pred.shape == jpred.shape == (2, anchors, 4 + K)
    d = np.abs(pred - jpred)
    assert d[..., :4].max() < 5e-3, d[..., :4].max()
    assert d[..., 4:].max() < 1e-4, d[..., 4:].max()
    assert (pred[..., 4:] > 0.25).any() and (pred[..., 4:] < 0.25).any()
    assert np.abs(pred[0, :, :4] - pred[1, :, :4]).max() > 1.0


def test_set_classes_and_the_facade_name():
    m = edgeyolo_tpu_torch.YOLOWorld(device="cpu")
    assert isinstance(m.model, WorldModel) and m.model_name == "yolov8-worldv2.yaml"
    assert m.model.nc == 80 and m.model.text.shape == (1, 80, 512) and not m.model.text.any()
    m.model.set_classes(np.eye(3, 512, dtype=np.float32), names=["a", "b", "c"])
    assert m.model.nc == m.model.model[-1].nc == 3 and m.model.names == {0: "a", 1: "b", 2: "c"}
    # the bank is a non-persistent f32 buffer on the model's device: it moves with the model
    # and stays out of the state_dict, as JAX's checkpoint holds no bank
    assert dict(m.model.named_buffers())["text"] is m.model.text
    assert "text" not in m.model.state_dict() and m.model.text.dtype == torch.float32
    assert m.model.text.device == next(m.model.parameters()).device
    jm = jtasks.WorldModel("yolov8-worldv2.yaml")
    for mod in (m.model, jm):  # strings need CLIP's weights and vocabulary
        with pytest.raises(ValueError, match="clip_npz"):
            mod.set_classes(["person", "bus"])
    with pytest.raises(ValueError, match="WorldDetect"):
        WorldModel("yolov8n.yaml", device="cpu")


class _PortStub(torch.nn.Module):
    def __init__(self, pred):
        super().__init__()
        self.pred, self.nc, self.dtype = torch.from_numpy(pred), K, torch.float32

    def forward(self, x):
        return {"pred": self.pred[:x.shape[0]]}


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    root = tmp_path_factory.mktemp("world")
    return root, generate_dataset(root / "ds", n_train=2, n_val=4, imgsz=S, nc=K)


def _fixed_pred(ds):
    """Per val image (B, 84, 4 + K): 10 noisy copies of its first shape's box
    (xywh pixels) scored 0.3-0.95 for its class, the rest random and low."""
    rs = np.random.RandomState(7)
    preds = []
    for i in range(len(ds)):
        it = ds.get_item(i)
        c = int(it["cls"][0])
        near = np.tile(it["bboxes"][0] * S, (10, 1)) + rs.randn(10, 4)
        far = np.concatenate([rs.uniform(0, S, (74, 2)), rs.uniform(3, 30, (74, 2))], 1)
        sc = np.zeros((84, K))
        sc[:10, c] = rs.uniform(0.3, 0.95, 10)
        sc[10:] = rs.uniform(0, 0.3, (74, K))
        preds.append(np.concatenate([np.concatenate([near, far]), sc], 1)[rs.permutation(84)])
    return np.stack(preds).astype(np.float32)


def test_predict_and_val_run_and_validators_agree_on_the_same_predictions(v2, shapes):
    """The facade's predict and val on the World model; then JAX's validator
    and the port's on the same predictions: JAX's World model's (compiled,
    the port's weights and bank; untrained, so its metrics are 0), and fixed
    predictions near the shapes, where the matching counts."""
    root, data = shapes
    from edgeyolo_tpu_torch.data.dataset import YOLODataset
    from edgeyolo_tpu_torch.engine.model import YOLO

    y = YOLO("yolov8-worldv2.yaml", device="cpu")
    y.model = v2["pm"]
    res = y.predict(str(data.parent / "images" / "val"), imgsz=S, conf=0.01, save=False)
    assert len(res) == 4 and sum(len(r) for r in res) > 0
    assert set(int(c) for r in res for c in r.boxes.cls) <= set(range(K))
    own = y.val(data=str(data), batch=4, imgsz=S, project=str(root / "runs"))
    assert "metrics/mAP50-95(B)" in own
    ds = YOLODataset(str(data.parent / "images" / "val"), imgsz=S)
    imgs = np.stack([ds.get_item(i)["img"] for i in range(len(ds))])
    jm = v2["jm"]
    model_pred = np.concatenate([  # two by two: the fixture's compiled forward
        v2["japply"](jm.variables, jnp.asarray(pair, jnp.float32) / 255.0)
        for pair in (imgs[:2], imgs[2:])])
    val = {"mode": "val", "imgsz": S, "batch": 4, "conf": 0.001, "iou": 0.7, "data": str(data)}
    for name, pred in (("model", model_pred), ("fixed", _fixed_pred(ds))):
        jstub = SimpleNamespace(nc=K, variables={}, quant=None,
                                apply=lambda v, img, train=False, p=pred: {"pred": jnp.asarray(
                                    p[:img.shape[0]])})
        ref = jvalidator.DetectionValidator(jget_cfg(overrides=val), save_dir=root / f"j{name}")(
            jstub)
        got = DetectionValidator(get_cfg(overrides=val), save_dir=root / f"p{name}",
                                 device="cpu")(_PortStub(pred))
        assert set(got) == set(ref)
        assert name == "model" or ref["metrics/mAP50(B)"] > 0.1
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-6, (name, k)


TRAIN_HYP = {"mosaic": 0.0, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "degrees": 0.0,
             "translate": 0.0, "scale": 0.0, "shear": 0.0, "perspective": 0.0, "flipud": 0.0,
             "fliplr": 0.0, "bgr": 0.0, "photometric": 0.0, "mixup": 0.0, "optimizer": "SGD",
             "lr0": 0.01, "momentum": 0.937, "weight_decay": 5e-4, "batch": 2, "nbs": 2,
             "epochs": 1, "warmup_epochs": 0.0, "amp": False}


def test_one_world_train_step_matches_jax(v2):
    """JAX's train-step math (its DetectionLoss on WorldModel.apply in train
    mode, the optax SGD chain at the port's step-0 learning rate and
    momentum) against the port's DetectionTrainer.train_step."""
    import copy

    pm = copy.deepcopy(v2["pm"])
    sd = {k: v.clone() for k, v in v2["sd"].items()}
    rs = np.random.RandomState(3)
    m = 6
    mask = (np.arange(m)[None] < np.array([[3], [5]])).astype(np.float32)
    boxes = np.concatenate([rs.uniform(0.3, 0.7, (2, m, 2)), rs.uniform(0.2, 0.5, (2, m, 2))], -1)
    batch = {"img": rs.randint(0, 256, (2, S, S, 3)).astype(np.uint8),
             "cls": rs.randint(0, K, (2, m)).astype(np.float32),
             "bboxes": (boxes * mask[..., None]).astype(np.float32), "mask_gt": mask,
             "n_real": 2}
    t = trainer.DetectionTrainer(pm, TRAIN_HYP, device="cpu")
    t.setup(nb=1)
    lr, mom = t.schedule.lr_at(0), t.schedule.momentum_at(0)
    loss, _items, updated = t.train_step(trainer.batch_to_device(batch, torch.device("cpu")),
                                         mosaic=False)
    assert updated

    jm = v2["jm"]
    variables = jax.tree.map(jnp.asarray, v2["variables"])
    params, bstats = variables["params"], variables["batch_stats"]
    p_flat, unravel = ravel_pytree(params)
    mask_flat = flat_decay_mask(params, jtrainer._decay_mask(params))
    tx = jtrainer.build_optimizer(p_flat, "SGD", lr, TRAIN_HYP["momentum"],
                                  TRAIN_HYP["weight_decay"], lambda s: lr,
                                  momentum_schedule=lambda s: mom, flat_mask=mask_flat)
    crit = JDetectionLoss(jm, hyp=TRAIN_HYP)
    img01 = jnp.asarray(batch["img"], jnp.float32) / 255.0
    tgt = {"cls": jnp.asarray(batch["cls"]), "bboxes": jnp.asarray(batch["bboxes"]),
           "mask_gt": jnp.asarray(mask), "img_weight": jnp.ones(2)}

    def loss_fn(pf):
        out, mut = jm.apply({"params": unravel(pf), "batch_stats": bstats}, img01, train=True)
        return crit(out["feats"], tgt, None)[0], mut["batch_stats"]

    (jloss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p_flat)
    updates, _ = tx.update(grads, tx.init(p_flat), p_flat)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    stepped = unravel_host(params, p_flat + updates)
    want = {**from_jax_variables({("params", *k): np.asarray(v) for k, v in
                                  traverse_util.flatten_dict(stepped).items()}),
            **from_jax_variables({("batch_stats", *k): np.asarray(v) for k, v in
                                  traverse_util.flatten_dict(new_bs).items()})}
    now = pm.state_dict()
    for n, ref in want.items():
        np.testing.assert_allclose(now[n].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4, err_msg=n)
    moved = [n for n, r in want.items() if not torch.equal(r, sd[n])]
    assert any(".attn.gl." in n for n in moved) and any(".cv4." in n for n in moved)


def test_checkpoint_reloads_as_jax_and_export_as_jax(v2, tmp_path):
    """A checkpoint keeps no bank, as JAX's (its msgpack holds the variables,
    its json nc and names): reloaded, a World model holds a zero bank of the
    saved nc and the saved names. The head's class towers are
    max(ch[0], min(nc, 100)) wide when the model is built, so a model built
    for 80 classes and then given 4 does not reload: the port raises at the
    load (a size mismatch), JAX at its first forward (ScopeParamShapeError).
    The npz export of a World model works in both packages; the traced
    formats raise in both (JAX's exporter traces the graph without its texts
    and fails with an IndexError; the port refuses with NotImplementedError)."""
    from edgeyolo_tpu_torch.engine.model import YOLO

    y = YOLO("yolov8-worldv2.yaml", device="cpu")
    y.model.set_classes(_bank(80), names=[f"c{i}" for i in range(80)])
    again = YOLO(y.save(tmp_path / "w80.pt"), device="cpu")
    assert isinstance(again.model, WorldModel) and again.model.nc == 80
    assert again.model.names[79] == "c79" and not again.model.text.any()
    assert all(torch.equal(a, b) for a, b in zip(again.model.state_dict().values(),
                                                 y.model.state_dict().values()))
    y.model = v2["pm"]
    path = y.save(tmp_path / "w.pt")
    meta = json.loads(path.with_suffix(".json").read_text())
    assert meta["nc"] == K and "text" not in meta
    with pytest.raises(RuntimeError, match="size mismatch"):
        YOLO(path, device="cpu")
    jm = v2["jm"]
    args = {"mode": "export", "imgsz": S}
    for fmt, want in (("npz", None), ("onnx", True), ("torch_export", True)):
        if want is None:
            JaxExporter(jget_cfg(overrides={**args, "format": fmt}))(jm, out_dir=tmp_path / "j")
            Exporter(get_cfg(overrides={**args, "format": fmt}))(v2["pm"],
                                                                 out_dir=tmp_path / "p")
        else:
            jfmt = "jax_export" if fmt == "torch_export" else fmt
            with pytest.raises(IndexError):
                JaxExporter(jget_cfg(overrides={**args, "format": jfmt}))(
                    jm, out_dir=tmp_path / "j")
            with pytest.raises(NotImplementedError):
                Exporter(get_cfg(overrides={**args, "format": fmt}))(
                    v2["pm"], out_dir=tmp_path / "p")
