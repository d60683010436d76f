"""The YOLOv13 family's remaining YAMLs in the PyTorch port against the JAX
package, on the CPU in f32: yolov13-test (wavelet HyperACE, E2E quality head),
yolov13-gf2-unihead (E2E quality head) and yolov13-dsc3k2-lgl (LGL blocks,
Detect).

- Every scale of each YAML: the layer specs parse as JAX's, the model builds,
  and its parameter count is JAX's (plus the 16 frozen DFL bins JAX does not
  store).
- At scale n, from the port's seeded weights perturbed as in
  tests/test_torch_families.py (BatchNorm statistics, scales and shifts moved,
  every zero-initialised gate opened, conv and linear weights times SCALE,
  class logits spread around 0): the state_dict carried onto the JAX tree with
  `convert_state_dict` (strict) and back with `from_jax_variables`; the 64 px
  pred against JAX's. E2E preds, (B, 84, 6) at 64 px, are compared as
  tests/test_torch_e2e.py compares selections.
- One f32 train step of yolov13-test-n at 64 px (E2EDetectLoss, both
  branches) against JAX's, as tests/test_torch_v13_train.py does for
  yolov13-dsc3k2-msla-n.

Tolerances: pred boxes 5e-3 px and scores 1e-4 (the flagship's); the train
step's loss at rel 1e-4 and its params and BatchNorm statistics at 1e-5 abs
plus 1e-4 rel (tests/test_torch_v13_train.py's).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.flatten_util import ravel_pytree
from test_torch_e2e import assert_e2e_close
from test_torch_families import REPO, S, _imgs, _jax_template, _perturb
from test_torch_v13_train import HYP, _opened, _train_batch

from edgeyolo_tpu.data.augment_device import augment_batch as jaugment
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.train import trainer as jtrainer
from edgeyolo_tpu.train.loss import E2EDetectLoss as JE2EDetectLoss
from edgeyolo_tpu.utils.torch_convert import convert_state_dict
from edgeyolo_tpu_torch.cfg.models import MODELS_DIR, model_cfg
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.modules.edgeline import LinearAttention
from edgeyolo_tpu_torch.nn.tasks import DetectionModel, num_params
from edgeyolo_tpu_torch.train import trainer
from edgeyolo_tpu_torch.utils.convert import from_jax_variables
from jax_host import flat_decay_mask, unravel_host
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

# port name at scale n: (JAX YAML, weight SCALE, end to end)
CONFIGS = {
    "yolov13-test-n": ("yolov13-test.yaml", 1.8, True),
    "yolov13-gf2-unihead-n": ("yolov13-gf2-unihead.yaml", 1.8, True),
    "yolov13-dsc3k2-lgl-n": ("yolov13-dsc3k2-lgl.yaml", 1.8, False),
}
SCALES = "nslx"


def _to_jax(sd: dict, template: dict):
    """convert_state_dict of the port's state_dict onto the JAX tree. JAX's
    converter has no rule for 1-D conv kernels (SeqMixer1D's `mix`): it would
    reshape (C, 1, k) into flax's (k, 1, C), so they are handed over already
    transposed."""
    arrays = {k: v.numpy().transpose(2, 1, 0) if v.ndim == 3 else v.numpy()
              for k, v in sd.items()}
    return convert_state_dict(arrays, template, strict=True)


def _perturbed(sd: dict, scale: float) -> dict:
    """tests/test_torch_families.py's perturbation, with the one2one branch's
    class logits spread around 0 as well (N(0, 0.5)), so that its scores, the
    E2E pred's, straddle the confidence gate."""
    out = _perturb(sd, scale)
    rs = np.random.RandomState(1)
    for k, v in out.items():
        if re.search(r"\.one2one_cv3\.\d+\.2\.bias$", k):
            out[k] = torch.from_numpy((rs.randn(*v.shape) * 0.5).astype(np.float32))
    return out


@pytest.mark.parametrize("yaml", [c[0] for c in CONFIGS.values()])
def test_yaml_copy_is_byte_identical_to_jax(yaml):
    assert (MODELS_DIR / yaml).read_bytes() == (
        REPO / "edgeyolo_tpu" / "cfg" / "models" / yaml).read_bytes()


@pytest.mark.parametrize("yaml,scale", [(c[0], s) for c in CONFIGS.values() for s in SCALES],
                         ids=lambda v: v.replace(".yaml", ""))
def test_every_scale_parses_builds_and_counts_as_jax(yaml, scale):
    """The wavelet HyperACE's c1 from its second input, DSC3K2_LGL in the C3k2
    family (c3k at l and x) and the repeat-insert set, the E2E head's DWConv
    cls tower; the parameter count of the built model."""
    jd = jtasks.yaml_model_load(yaml)
    jd["scale"] = scale
    jlayers, jsave, _ = jtasks.parse_spec(jd)
    layers, save, info = tasks.parse_spec(model_cfg(yaml, scale))
    assert info["scale"] == scale and save == jsave
    assert [(s.i, s.f, s.name, s.args, s.kwargs, s.c2) for s in layers] == \
        [(s.i, s.f, s.name, s.args, s.kwargs, s.c2) for s in jlayers]
    jm = jtasks.DetectionModel(jd)
    params = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))["params"]
    pm = DetectionModel(yaml, scale=scale, device="cpu")
    assert num_params(pm) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params)) + 16
    assert pm.end2end == jm.end2end == (layers[-1].name == "GFLHeadv2_E2E")


@pytest.fixture(scope="module", params=list(CONFIGS))
def family(request):
    name = request.param
    yaml, scale, e2e = CONFIGS[name]
    pm = DetectionModel(name, device="cpu")
    sd = _perturbed(pm.state_dict(), scale)
    pm.load_state_dict(sd)
    jm = jtasks.DetectionModel(yaml)
    template = _jax_template(jm)
    variables, rep = _to_jax(sd, template)
    imgs = _imgs()
    apply = jax.jit(lambda v, x: jm.net.apply(v, x, train=False)["pred"])
    jpred = np.asarray(apply(jax.tree.map(jnp.asarray, variables),
                             jnp.asarray(imgs, jnp.float32) / 255.0))
    with torch.no_grad():
        pred = pm(torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255)["pred"].numpy()
    return {"name": name, "e2e": e2e, "pm": pm, "sd": sd, "template": template,
            "variables": variables, "report": rep, "pred": pred, "jpred": jpred}


def test_state_dict_bridges_both_ways(family):
    sd, rep = family["sd"], family["report"]
    head = len(family["pm"].model) - 1
    assert rep["unused"] == [f"model.{head}.dfl.conv.weight"]
    assert rep["matched"] == len(jax.tree.leaves(family["template"]))
    back = from_jax_variables(traverse_util.flatten_dict(family["variables"]))
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")} - set(
        rep["unused"])
    assert all(torch.equal(back[k], sd[k]) for k in back)
    missing, unexpected = DetectionModel(family["name"], device="cpu").load_state_dict(
        back, strict=False)
    assert missing == rep["unused"] and not unexpected


def test_pred_matches_jax(family):
    pred, jpred = family["pred"], family["jpred"]
    if family["e2e"]:
        assert pred.shape == jpred.shape == (2, 84, 6)  # the top-k of 84 anchors
        assert_e2e_close(pred, jpred, box_atol=5e-3, score_atol=1e-4)
        # the top 84 of 84 x 80 (anchor, class) pairs: unsaturated, of several classes
        assert 0.01 < pred[..., 4].min() and pred[..., 4].max() < 0.99
        assert len(np.unique(pred[..., 5])) > 1
    else:
        assert pred.shape == jpred.shape == (2, 84, 84)
        d = np.abs(pred - jpred)
        assert d[..., :4].max() < 5e-3 and d[..., 4:].max() < 1e-4, d.max()
        # scores straddle the confidence gate
        assert (pred[..., 4:] > 0.25).any() and (pred[..., 4:] < 0.25).any()
    # the output depends on the image
    assert np.abs(pred[0, :, :4] - pred[1, :, :4]).max() > 1.0


def test_facade_builds_them():
    for name in CONFIGS:
        m = YOLO(f"{name.rsplit('-', 1)[0]}.yaml", device="cpu")
        assert m.model.scale == "n" and m.model.end2end == CONFIGS[name][2]


def test_attention_kernel_dims_on_the_wavelet_path():
    """yolov13-test: the kernel runs in the two wavelet branches only, at head
    dim c / 2 with c = int(make_divisible(512 * width) * 0.5): 32 at n, 64 at
    s, 128 at l and 192 at x; yolov13-dsc3k2-lgl runs it nowhere."""
    dims = {}
    for scale in SCALES:
        spec = tasks.parse_spec(model_cfg("yolov13-test.yaml", scale))[0]
        c = int(spec[9].args[0] * 0.5)
        dims[scale] = c // 2
    assert dims == {"n": 32, "s": 64, "l": 128, "x": 192}
    m = DetectionModel("yolov13-test-n", device="cpu")
    attn = [(n, mod.num_heads, mod.qkv.in_channels // mod.num_heads)
            for n, mod in m.named_modules() if isinstance(mod, LinearAttention)]
    assert attn == [("model.9.branch1.m.ll_attention", 2, 32),
                    ("model.9.branch2.m.ll_attention", 2, 32)]
    assert not any(isinstance(mod, LinearAttention)
                   for mod in DetectionModel("yolov13-dsc3k2-lgl-n", device="cpu").modules())


def _jax_e2e_step(jm, variables, batch):
    """One step of JAX's train_step math with its E2EDetectLoss on the whole
    output dict: f32, accumulate 1, no warmup (tests/test_torch_v13_train.py)."""
    params, bstats = variables["params"], variables["batch_stats"]
    p_flat, unravel = ravel_pytree(params)
    mask_flat = flat_decay_mask(params, jtrainer._decay_mask(params))
    tx = jtrainer.build_optimizer(p_flat, "SGD", HYP["lr0"], HYP["momentum"],
                                  HYP["weight_decay"], lambda s: HYP["lr0"], flat_mask=mask_flat)
    crit = JE2EDetectLoss(jm, hyp=HYP)
    hyp = {k: float(v) for k, v in HYP.items() if isinstance(v, (int, float))}
    b = {k: jnp.asarray(v) for k, v in batch.items() if k != "n_real"}
    img01, acls, aboxes, amask = jaugment(b["img"], b["cls"], b["bboxes"], b["mask_gt"],
                                          jax.random.PRNGKey(0), S, hyp, mosaic=False)
    tgt = {"cls": acls, "bboxes": aboxes, "mask_gt": amask, "img_weight": jnp.ones(2)}

    def loss_fn(pf):
        out, mut = jm.net.apply({"params": unravel(pf), "batch_stats": bstats}, img01, train=True,
                                mutable=["batch_stats"])
        return crit(out, tgt)[0], mut["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p_flat)
    updates, _ = tx.update(grads, tx.init(p_flat), p_flat)

    def as_port(tree, coll):
        return from_jax_variables({(coll, *k): np.asarray(v) for k, v in
                                   traverse_util.flatten_dict(tree).items()})

    return (float(loss), as_port(unravel_host(params, p_flat + updates), "params"),
            as_port(new_bs, "batch_stats"))


def test_e2e_train_step_matches_jax():
    """yolov13-test-n at 64 px, batch 2, augmentation off: one SGD step through
    E2EDetectLoss from the same weights (gates open); the loss, the params and
    the BatchNorm statistics after it. The one2one towers train on detached
    inputs: the backbone's gradient comes from the one2many branch alone."""
    pm = DetectionModel("yolov13-test-n", device="cpu")
    sd = _opened(pm.state_dict())
    jm = jtasks.DetectionModel("yolov13-test.yaml")
    variables, _ = _to_jax(sd, _jax_template(jm))
    batch = _train_batch()
    j_loss, j_params, j_stats = _jax_e2e_step(jm, jax.tree.map(jnp.asarray, variables), batch)

    pm.load_state_dict(sd)
    t = trainer.DetectionTrainer(pm, HYP, device="cpu")
    assert t.end2end and type(t.criterion).__name__ == "E2EDetectLoss"
    t.setup(nb=1)
    loss, items, updated = t.train_step(trainer.batch_to_device(batch, torch.device("cpu")),
                                        mosaic=False)
    assert updated and all(np.isfinite(float(v)) for v in items.values())
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-4)
    now = pm.state_dict()
    for n, ref in {**j_params, **j_stats}.items():
        np.testing.assert_allclose(now[n].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4, err_msg=n)
    moved = [n for n, r in j_params.items() if not torch.equal(r, sd[n])]
    assert any(".one2one_reg_conf." in n for n in moved)
    assert any(".ll_attention." in n for n in moved) and any(".ss2d." in n for n in moved)
