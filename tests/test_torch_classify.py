"""The classify task's modules, models and device augmentation in the PyTorch
port against the JAX package, on the CPU in f32.

- ResNetBlock (stride 1 and 2, projected and identity shortcuts), ResNetLayer
  (the stem and a stage of blocks) and the Classify head (one input and a
  list concatenated on channels) at narrow widths, as
  tests/test_torch_v13_modules.py runs modules (variables filled from a numpy
  seed, BatchNorm at the detection convention on both sides): 1e-5.
- The five cls YAMLs (byte-identical copies) at scale n, each built with
  JAX's parameter count and the classify BatchNorm convention (eps 1e-5,
  momentum 0.1), with JAX's variables (kernels x SCALE, so the logits depend
  on the image) carried over by `from_jax_variables`: logits at 64 px within
  1e-4 of their largest magnitude.
- `resize_center_crop` against JAX's PIL path over up- and down-scales in
  both orientations, and `resize_bilinear` against PIL's Image.resize:
  tolerance 0.
- Each RandAugment op at magnitude 9 with both signs: 1e-5 (posterize,
  solarize and equalize exactly); `rand_augment_apply` with the draws of
  JAX's `rand_augment_batch` (1e-5), and `classify_apply` with the draws JAX's
  `classify_augment_batch` makes from its key (`jax_classify_params`: its
  fold_in 11, 13, 17, 19, 23 and 29 keys replayed): 1e-4.
- ClassificationLoss, all images real and with padded duplicates: rel 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image
from test_torch_v13_modules import _leaf, _run_pair, _x
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.data import augment_device as jaug
from edgeyolo_tpu.data import classify as jcls
from edgeyolo_tpu.data import randaugment as jra
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.nn.modules import extra as jextra
from edgeyolo_tpu.nn.modules import head as jhead
from edgeyolo_tpu.train.loss import ClassificationLoss as JClassificationLoss
from edgeyolo_tpu_torch.cfg.models import MODELS_DIR
from edgeyolo_tpu_torch.data import augment_device as aug
from edgeyolo_tpu_torch.data import randaugment as ra
from edgeyolo_tpu_torch.data.classify import resize_bilinear, resize_center_crop
from edgeyolo_tpu_torch.nn.modules import extra, head
from edgeyolo_tpu_torch.nn.modules.conv import BatchNorm2d
from edgeyolo_tpu_torch.nn.tasks import ClassificationModel, num_params
from edgeyolo_tpu_torch.train.loss import ClassificationLoss
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

JAX_MODELS = MODELS_DIR.parents[2] / "edgeyolo_tpu" / "cfg" / "models"
S = 32  # the augmentation tests' image side

# ---------------------------------------------------------------------------------------------
# modules
MODULE_CASES = [
    ("ResNetBlock", jextra.ResNetBlock(16), extra.ResNetBlock(16, 16), (2, 8, 8, 16)),
    ("ResNetBlock_s2", jextra.ResNetBlock(8, 2), extra.ResNetBlock(16, 8, 2), (2, 8, 8, 16)),
    ("ResNetBlock_identity", jextra.ResNetBlock(8), extra.ResNetBlock(32, 8), (2, 6, 6, 32)),
    ("ResNetBlock_e1", jextra.ResNetBlock(16, 1, 1), extra.ResNetBlock(16, 16, 1, 1),
     (2, 6, 6, 16)),
    ("ResNetLayer_stem", jextra.ResNetLayer(16, 1, True, 1), extra.ResNetLayer(3, 16, 1, True, 1),
     (2, 17, 17, 3)),
    ("ResNetLayer_stage", jextra.ResNetLayer(8, 2, False, 3), extra.ResNetLayer(16, 8, 2, False, 3),
     (2, 8, 8, 16)),
    ("Classify", jhead.Classify(7), head.Classify(16, 7), (2, 5, 5, 16)),
]


@pytest.mark.parametrize("jmod,tmod,shape", [c[1:] for c in MODULE_CASES],
                         ids=[c[0] for c in MODULE_CASES])
def test_module_matches_jax(jmod, tmod, shape):
    flat, yj, yt = _run_pair(jmod, tmod, _x(shape), "nhwc")
    yt = yt.detach().numpy()
    if yt.ndim == 4:
        yt = yt.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(yt, np.asarray(yj), atol=1e-5, rtol=0)
    assert {k for k in tmod.state_dict() if not k.endswith("num_batches_tracked")} == set(
        from_jax_variables(flat))


def test_classify_concatenates_a_list_on_channels():
    xs = [_x((2, 4, 4, 8), seed=1), _x((2, 4, 4, 8), seed=2)]
    flat, yj, yt = _run_pair(jhead.Classify(5), head.Classify(16, 5), xs, "list")
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=1e-5, rtol=0)


def test_classify_dropout_runs_in_training_only():
    h = head.Classify(8, 3, dropout=0.5)
    x = torch.randn(4, 8, 3, 3)
    h.eval()
    assert torch.equal(h(x), h(x))
    h.train()
    torch.manual_seed(0)
    assert not torch.equal(h(x), h(x))


# ---------------------------------------------------------------------------------------------
# the five cls YAMLs
YAMLS = {"yolov8-cls.yaml": 2.5, "yolov8-cls-resnet50.yaml": 1.5,
         "yolov8-cls-resnet101.yaml": 1.5, "yolo11-cls.yaml": 2.5,
         "yolo11-cls-resnet18.yaml": 1.5}  # YAML: kernel scale of the test weights


def _filled(template: dict, scale: float, seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    out = {}
    for k, s in traverse_util.flatten_dict(template).items():
        a = _leaf(rs, k, s.shape)
        out[k] = (a * scale if k[-1] == "kernel" else a).astype(np.float32)
    return out


@pytest.mark.parametrize("yaml", list(YAMLS))
def test_cls_yaml_matches_jax(yaml):
    assert (MODELS_DIR / yaml).read_bytes() == (JAX_MODELS / yaml).read_bytes()
    pm = ClassificationModel(yaml, device="cpu")
    assert pm.task == "classify" and pm.nc == (10 if "resnet18" in yaml else 1000)
    bns = [m for m in pm.modules() if isinstance(m, BatchNorm2d)]
    assert bns and all(m.eps == 1e-5 and m.momentum == 0.1 for m in bns)
    jm = jtasks.ClassificationModel(yaml)
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    template = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                  train=False))
    flat = _filled(template, YAMLS[yaml])
    assert num_params(pm) == sum(int(np.prod(v.shape)) for k, v in flat.items()
                                 if k[0] == "params")
    missing, unexpected = pm.load_state_dict(from_jax_variables(flat), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    yj = np.asarray(jax.jit(lambda v, a: jm.net.apply(v, a, train=False))(
        traverse_util.unflatten_dict(flat), jnp.asarray(x)))
    with torch.no_grad():
        yt = pm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert yt.shape == yj.shape == (2, pm.nc)
    scale = np.abs(yj).max()
    print(f"{yaml}: logits scale {scale:.3e}, max abs diff {np.abs(yt - yj).max():.3e}")
    np.testing.assert_allclose(yt, yj, atol=1e-4 * scale, rtol=0)
    assert np.abs(yj[0] - yj[1]).max() > 1e-2 * scale  # the logits depend on the image


# ---------------------------------------------------------------------------------------------
# the eval transform
SIZES = [(375, 500), (500, 375), (60, 140), (140, 60), (97, 131), (224, 224), (40, 50),
         (50, 40), (224, 300), (1, 7), (333, 64)]


@pytest.mark.parametrize("size", [64, 128, 224])
def test_resize_center_crop_equals_jax(size):
    rs = np.random.RandomState(size)
    for h, w in SIZES:
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = jcls._resize_center_crop(img, size)
        got = resize_center_crop(img, size)
        assert got.shape == (size, size, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_resize_bilinear_equals_pil():
    rs = np.random.RandomState(0)
    for _ in range(120):
        h, w = rs.randint(1, 260, 2)
        nh, nw = rs.randint(1, 260, 2)
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((int(nw), int(nh)), Image.BILINEAR))
        np.testing.assert_array_equal(resize_bilinear(img, int(nw), int(nh)), want)


# ---------------------------------------------------------------------------------------------
# RandAugment
def _jax_op(name, im, s, m):
    """JAX's branch `name` of rand_augment at the magnitudes m, sign s."""
    return {
        "identity": lambda: im,
        "shear_x": lambda: jra.shear_x(im, s * m["shear_deg"]),
        "shear_y": lambda: jra.shear_y(im, s * m["shear_deg"]),
        "translate_x": lambda: jra.translate_x(im, s * m["translate"]),
        "translate_y": lambda: jra.translate_y(im, s * m["translate"]),
        "rotate": lambda: jra.rotate(im, s * m["rotate"]),
        "brightness": lambda: jra.adjust_brightness(im, 1.0 + s * m["color"]),
        "color": lambda: jra.adjust_saturation(im, 1.0 + s * m["color"]),
        "contrast": lambda: jra.adjust_contrast(im, 1.0 + s * m["color"]),
        "sharpness": lambda: jra.adjust_sharpness(im, 1.0 + s * m["color"]),
        "posterize": lambda: jra.posterize(im, jnp.asarray(float(m["posterize"]))),
        "solarize": lambda: jra.solarize(im, m["solarize"]),
        "autocontrast": lambda: jra.autocontrast(im),
        "equalize": lambda: jra.equalize(im),
    }[name]()


@pytest.mark.parametrize("name", ra.OPS)
def test_rand_augment_op_matches_jax(name):
    imgs = np.random.RandomState(5).rand(4, S, S, 3).astype(np.float32)
    imgs[1, :, :, 2] = imgs[1, :, :, 2] * 0.3 + 0.2  # a narrow channel: autocontrast stretches
    signs = np.float32([1, -1, 1, -1])
    m = ra._op_magnitudes(S, 9)
    want = np.stack([np.asarray(_jax_op(name, jnp.asarray(im), jnp.float32(s), m))
                     for im, s in zip(imgs, signs)])
    got = ra._op(torch.from_numpy(imgs), ra.OPS.index(name), torch.from_numpy(signs), m).numpy()
    if name in ("posterize", "solarize", "equalize"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if name != "identity":
        assert not np.array_equal(got, imgs)


def _jax_ra_draws(key, b, num_ops=2):
    ops, signs = [], []
    for k in jax.random.split(key, b):
        ops.append([int(jax.random.randint(jax.random.fold_in(k, 2 * i), (), 0, 14))
                    for i in range(num_ops)])
        signs.append([float(jnp.where(jax.random.uniform(jax.random.fold_in(k, 2 * i + 1), ())
                                      < 0.5, -1.0, 1.0)) for i in range(num_ops)])
    return torch.tensor(ops), torch.tensor(signs)


def test_rand_augment_batch_matches_jax():
    b = 16
    imgs = np.random.RandomState(6).rand(b, S, S, 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jra.rand_augment_batch(jnp.asarray(imgs), key))
    ops, signs = _jax_ra_draws(key, b)
    got = ra.rand_augment_apply(torch.from_numpy(imgs), ops, signs).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert len(torch.unique(ops)) > 6


def jax_classify_params(key, b, s, hyp) -> aug.ClassifyParams:
    """The values JAX's classify_augment_batch draws from `key`, as ClassifyParams."""
    smin = max(1.0 - float(hyp.get("scale", 0.5)), 0.05)
    crop = []
    for k in jax.random.split(jax.random.fold_in(key, 11), b):
        k1, k2, k3 = jax.random.split(k, 3)
        area = jax.random.uniform(k1, (), minval=smin, maxval=1.0)
        ratio = jnp.exp(jax.random.uniform(k2, (), minval=jnp.log(3 / 4), maxval=jnp.log(4 / 3)))
        cw = jnp.minimum(s * jnp.sqrt(area * ratio), s)
        ch = jnp.minimum(s * jnp.sqrt(area / ratio), s)
        off = jax.random.uniform(k3, (2,))
        crop.append([off[0] * (s - ch), off[1] * (s - cw), ch, cw])

    def gate(salt, p):
        u = jax.random.uniform(jax.random.fold_in(key, salt), (b,))
        return torch.from_numpy(np.array(u < p)) if p > 0 else None

    gains = np.float32([hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4)])
    hsv = None
    if gains.any():
        hsv = torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(k, (3,), minval=-1.0, maxval=1.0) * jnp.asarray(gains)
                       + 1.0) for k in jax.random.split(jax.random.fold_in(key, 19), b)]))
    ops = signs = None
    if hyp.get("auto_augment") == "randaugment":
        ops, signs = _jax_ra_draws(jax.random.fold_in(key, 29), b)
    per = float(hyp.get("erasing", 0.0))
    erase = box = None
    if per > 0:
        erase, box = [], []
        for k in jax.random.split(jax.random.fold_in(key, 23), b):
            ka, kb, kc, kd = jax.random.split(k, 4)
            erase.append(bool(jax.random.uniform(ka, ()) < per))
            area = jax.random.uniform(kb, (), minval=0.02, maxval=0.33) * s * s
            r = jnp.exp(jax.random.uniform(kc, (), minval=jnp.log(0.3), maxval=jnp.log(3.3)))
            eh, ew = jnp.minimum(jnp.sqrt(area * r), s), jnp.minimum(jnp.sqrt(area / r), s)
            off = jax.random.uniform(kd, (2,))
            box.append([off[0] * (s - eh), off[1] * (s - ew), eh, ew])
        erase, box = torch.tensor(erase), torch.tensor(np.asarray(box, np.float32))
    return aug.ClassifyParams(torch.tensor(np.asarray(crop, np.float32)),
                              gate(13, hyp.get("fliplr", 0.5)), gate(17, hyp.get("flipud", 0.0)),
                              hsv, ops, signs, erase, box)


AUG_HYPS = {
    "crop-flip": {"hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "fliplr": 0.5, "scale": 0.5},
    "crop-flips-hsv": {"fliplr": 0.5, "flipud": 0.5, "scale": 0.9},
    "default": {"scale": 0.5, "fliplr": 0.5, "auto_augment": "randaugment", "erasing": 0.4},
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(AUG_HYPS))
def test_classify_augment_batch_matches_jax(case, seed):
    """classify_apply with the values JAX draws, against JAX's own function
    run op by op (ROADMAP C.16: the fused program can part from its own ops);
    every tap reads inside the image except where the crop's first or last
    row or column lands outside, which reads GRAY (114) on the [0, 1] image
    in both."""
    hyp = AUG_HYPS[case]
    b = 8
    imgs = np.random.RandomState(seed).randint(0, 256, (b, S, S, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.classify_augment_batch(jnp.asarray(imgs), key, hyp))
    prm = jax_classify_params(key, b, S, hyp)
    got = aug.classify_apply(torch.from_numpy(imgs), prm).numpy()
    assert got.shape == (b, S, S, 3) and got.dtype == np.float32
    print(f"{case}: max abs diff {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if prm.fliplr is not None:
        assert bool(prm.fliplr.any()) and not bool(prm.fliplr.all())


def test_classify_sampling_is_seeded_and_on_the_host():
    hyp = {**AUG_HYPS["default"], "flipud": 0.5}
    a = aug.sample_classify_params(64, S, hyp, torch.Generator().manual_seed(0))
    b = aug.sample_classify_params(64, S, hyp, torch.Generator().manual_seed(0))
    for name in ("crop", "fliplr", "flipud", "hsv_gain", "ra_ops", "ra_signs", "erase",
                 "erase_box"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert getattr(a, name).device.type == "cpu"
    oy, ox, ch, cw = a.crop.unbind(1)
    area = ch * cw / S ** 2
    assert bool(((area > 0.5 - 1e-4) | (ch == S) | (cw == S)).all())
    assert bool(((oy >= 0) & (oy + ch <= S + 1e-4) & (ox >= 0) & (ox + cw <= S + 1e-4)).all())
    assert set(a.ra_ops.flatten().tolist()) <= set(range(len(ra.OPS)))
    assert set(a.ra_signs.flatten().tolist()) == {-1.0, 1.0}
    assert 0 < int(a.erase.sum()) < 64
    eh, ew = a.erase_box[:, 2], a.erase_box[:, 3]
    assert bool(((eh * ew >= 0.02 * S * S - 1e-3) | (eh == S) | (ew == S)).all())
    none = aug.sample_classify_params(4, S, {"fliplr": 0.0, "hsv_h": 0.0, "hsv_s": 0.0,
                                             "hsv_v": 0.0}, torch.Generator())
    assert none.fliplr is none.hsv_gain is none.ra_ops is none.erase is None


# ---------------------------------------------------------------------------------------------
# the loss
@pytest.mark.parametrize("n_real", [6, 4])
def test_classification_loss_matches_jax(n_real):
    rs = np.random.RandomState(n_real)
    logits = (rs.randn(6, 10) * 3).astype(np.float32)
    labels = rs.randint(0, 10, 6)
    w = (np.arange(6) < n_real).astype(np.float32)
    jl, jitems = JClassificationLoss()(jnp.asarray(logits), {"cls": jnp.asarray(labels),
                                                             "img_weight": jnp.asarray(w)})
    pl, items = ClassificationLoss()(torch.from_numpy(logits), {
        "cls": torch.from_numpy(labels).float(), "img_weight": torch.from_numpy(w)})
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(items["cls"].item(), float(jitems["cls"]), rtol=1e-6)
    lse = logits.max(1) + np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1))
    nll = lse - logits[np.arange(6), labels]
    assert math.isclose(pl.item(), float((nll * w).sum() / w.sum()), rel_tol=1e-5)
