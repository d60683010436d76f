"""Training the YOLO11 and YOLOv13 families in the PyTorch port, against
the JAX package, on the CPU in f32 at 64 px.

- The criterion on a plain Detect head (yolo11n, no quality), which takes
  the plain BCE branch in both: the loss and its gradients with respect to
  the feats, at rel 1e-4 and 1e-4 of their max (tests/test_torch_loss.py's).
- One train step of yolov13-dsc3k2-msla-n at full width and depth from the
  same seeded weights, with the zero-initialised gates open (the FullPAD
  `gate`s and MSLA's `gamma`) and BatchNorm statistics moved off their init,
  augmentation off, accumulate 1: the loss at rel 1e-4, the params and
  BatchNorm statistics after it at 1e-5 abs plus 1e-4 rel, the tolerances
  of tests/test_torch_train.py's flagship step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util
from jax.flatten_util import ravel_pytree

from edgeyolo_tpu.data.augment_device import augment_batch as jaugment
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.train import trainer as jtrainer
from edgeyolo_tpu.train.loss import DetectionLoss as JDetectionLoss
from edgeyolo_tpu.utils.torch_convert import convert_state_dict
from edgeyolo_tpu_torch.nn.modules.conv import BatchNorm2d
from edgeyolo_tpu_torch.nn.tasks import DetectionModel, train_forward
from edgeyolo_tpu_torch.train import trainer
from edgeyolo_tpu_torch.train.loss import DetectionLoss
from edgeyolo_tpu_torch.utils.convert import from_jax_variables, jax_path_to_torch_key
from jax_host import flat_decay_mask, unravel_host
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

S = 64


def _imgs(seed):
    return np.random.RandomState(seed).randint(0, 256, (2, S, S, 3)).astype(np.uint8)


def test_plain_detect_loss_and_feat_grads_match_jax():
    """yolo11n's feats (a Detect head: no quality) through the port's
    criterion and JAX's DetectionLoss with quality None, which takes the
    plain BCE branch: the loss and its gradients with respect to the feats."""
    pm = DetectionModel("yolo11n", device="cpu")
    assert not hasattr(pm.model[-1], "reg_conf")
    x = torch.from_numpy(_imgs(2)).permute(0, 3, 1, 2).float() / 255
    out = train_forward(pm.train(), x, amp=False)
    assert out["quality"] is None
    feats = [f.detach().requires_grad_() for f in out["feats"]]
    rs = np.random.RandomState(5)
    m = 6
    mask = (np.arange(m)[None] < np.array([[3], [5]])).astype(np.float32)
    batch = {"cls": rs.randint(0, 80, (2, m)).astype(np.float32), "mask_gt": mask,
             "bboxes": np.concatenate([rs.uniform(0.3, 0.7, (2, m, 2)),
                                       rs.uniform(0.2, 0.5, (2, m, 2))], -1).astype(np.float32)
             * mask[..., None]}
    crit = DetectionLoss.for_model(pm)
    assert (crit.nc, crit.reg_max, crit.stride) == (80, 16, (8, 16, 32))
    total, items = crit(feats, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    jcrit = JDetectionLoss(nc=80, reg_max=16, stride=(8, 16, 32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(fs):
        return jcrit([a.transpose(0, 2, 3, 1) for a in fs], jb, None)

    (jt, jitems), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        [jnp.asarray(t.detach().numpy()) for t in feats])
    assert float(jt) > 0 and float(jitems["cls"]) > 0
    np.testing.assert_allclose(total.item(), float(jt), rtol=1e-4)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(items[k]), float(jitems[k]), rtol=1e-4, atol=1e-7)
    for p, j in zip(feats, jg):
        j = np.asarray(j)
        np.testing.assert_allclose(p.grad.numpy(), j, atol=1e-4 * np.abs(j).max(), rtol=0)


AUG_OFF = {"mosaic": 0.0, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "degrees": 0.0,
           "translate": 0.0, "scale": 0.0, "shear": 0.0, "perspective": 0.0, "flipud": 0.0,
           "fliplr": 0.0, "bgr": 0.0, "photometric": 0.0, "mixup": 0.0}
HYP = {**AUG_OFF, "optimizer": "SGD", "lr0": 0.01, "momentum": 0.937, "weight_decay": 5e-4,
       "batch": 2, "nbs": 2, "epochs": 1, "warmup_epochs": 0.0, "amp": False}


def _train_batch():
    rs = np.random.RandomState(3)
    m = 8
    mask = (np.arange(m)[None] < np.array([[4], [6]])).astype(np.float32)
    boxes = np.concatenate([rs.uniform(0.3, 0.7, (2, m, 2)), rs.uniform(0.2, 0.5, (2, m, 2))], -1)
    return {"img": rs.randint(0, 256, (2, S, S, 3)).astype(np.uint8),
            "cls": rs.randint(0, 80, (2, m)).astype(np.float32),
            "bboxes": (boxes * mask[..., None]).astype(np.float32), "mask_gt": mask, "n_real": 2}


def _jax_step(jm, variables, batch):
    """One step of JAX's DetectionTrainer.train_step math, f32, accumulate 1,
    no warmup (the learning rate of step 0 is lr0)."""
    params, bstats = variables["params"], variables["batch_stats"]
    p_flat, unravel = ravel_pytree(params)
    mask_flat = flat_decay_mask(params, jtrainer._decay_mask(params))
    tx = jtrainer.build_optimizer(p_flat, "SGD", HYP["lr0"], HYP["momentum"],
                                  HYP["weight_decay"], lambda s: HYP["lr0"], flat_mask=mask_flat)
    crit = JDetectionLoss(jm, hyp=HYP)
    hyp = {k: float(v) for k, v in HYP.items() if isinstance(v, (int, float))}
    b = {k: jnp.asarray(v) for k, v in batch.items() if k != "n_real"}
    img01, acls, aboxes, amask = jaugment(b["img"], b["cls"], b["bboxes"], b["mask_gt"],
                                          jax.random.PRNGKey(0), S, hyp, mosaic=False)
    tgt = {"cls": acls, "bboxes": aboxes, "mask_gt": amask, "img_weight": jnp.ones(2)}

    def loss_fn(pf):
        out, mut = jm.net.apply({"params": unravel(pf), "batch_stats": bstats}, img01, train=True,
                                mutable=["batch_stats"])
        return crit(out["feats"], tgt, out.get("quality"))[0], mut["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p_flat)
    updates, _ = tx.update(grads, tx.init(p_flat), p_flat)

    def as_port(tree, coll):
        return from_jax_variables({(coll, *k): np.asarray(v) for k, v in
                                   traverse_util.flatten_dict(tree).items()})

    return (float(loss), as_port(unravel_host(params, p_flat + updates), "params"),
            as_port(new_bs, "batch_stats"))


def _opened(sd: dict, seed: int = 0) -> dict:
    """The seeded weights with the gates open and BatchNorm statistics moved."""
    rs = np.random.RandomState(seed)
    out = dict(sd)
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("gamma", "gate"):
            out[k] = torch.tensor(rs.uniform(0.3, 0.8), dtype=torch.float32)
        elif leaf == "running_mean":
            out[k] = torch.from_numpy((rs.randn(*v.shape) * 0.1).astype(np.float32))
        elif leaf == "running_var":
            out[k] = torch.from_numpy(rs.uniform(0.5, 1.5, v.shape).astype(np.float32))
    return out


def test_decay_mask_matches_jax():
    """Weight decay on conv and dense kernels only, as JAX's _decay_mask: the
    hypergraph's linear layers take it, its prototypes and the gates not."""
    pm = DetectionModel("yolov13-dsc3k2-msla-n", device="cpu")
    jm = jtasks.DetectionModel("yolov13-dsc3k2-msla.yaml")
    params = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))["params"]
    jmask = traverse_util.flatten_dict(jtrainer._decay_mask(params))
    mask = trainer._decay_mask(pm)
    assert mask == {jax_path_to_torch_key(k): bool(v) for k, v in jmask.items()}
    assert mask["model.9.branch1.m.hgnn.edge_proj.0.weight"]
    assert not mask["model.9.branch1.m.hgnn.edge_generator.prototype_base"]
    assert not mask["model.12.gate"] and not mask["model.2.gamma"]


def test_msla_train_step_matches_jax():
    """yolov13-dsc3k2-msla-n at 64 px, batch 2, augmentation off: one SGD step
    from the same weights, the loss, the params and the BatchNorm statistics
    after it."""
    pm = DetectionModel("yolov13-dsc3k2-msla-n", device="cpu")
    sd = _opened(pm.state_dict())
    jm = jtasks.DetectionModel("yolov13-dsc3k2-msla.yaml")
    shapes = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, _ = convert_state_dict({k: v.numpy() for k, v in sd.items()}, template,
                                      strict=True)
    batch = _train_batch()
    j_loss, j_params, j_stats = _jax_step(jm, jax.tree.map(jnp.asarray, variables), batch)

    pm.load_state_dict(sd)
    t = trainer.DetectionTrainer(pm, HYP, device="cpu")
    t.setup(nb=1)
    assert t.accumulate == 1 and t.schedule.warmup_steps == 0 and t.schedule.lr_at(0) == 0.01
    loss, items, updated = t.train_step(trainer.batch_to_device(batch, torch.device("cpu")),
                                        mosaic=False)
    assert updated and all(np.isfinite(float(v)) for v in items.values())
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-4)
    now = pm.state_dict()
    for n, ref in {**j_params, **j_stats}.items():
        np.testing.assert_allclose(now[n].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4, err_msg=n)
    moved = [n for n, r in j_params.items() if not torch.equal(r, sd[n])]
    assert any(".msla." in n for n in moved) and any(n.endswith(".gate") for n in moved)
    bn = [m for m in pm.modules() if isinstance(m, BatchNorm2d)]
    assert len(bn) > 100 and not torch.equal(bn[0].running_var, sd["model.0.bn.running_var"])
