"""The training step of the PyTorch port against the JAX package, on the CPU in f32.

- BatchNorm in train mode: the running statistics after one forward match
  flax's (biased batch variance) at rel 1e-5; torch's stock update (unbiased)
  is 1/7 larger in the variance at n = 8 values per channel and fails it.
- The optimizer chain over 4 micro-steps of fixed gradients with clip,
  decay mask, warmup momentum and accumulation 2, against optax: 1e-6.
- The schedules, decay and accumulation against the closures that JAX's own
  DetectionTrainer.train builds (captured by stopping it at build_optimizer),
  and the EMA formula: 1e-7.
- The step: EdgeLine-YOLO-n (full width and depth) at 64 px, batch 2, from
  the same JAX weights, 3 micro-steps (accumulation 2, so one real update)
  with augmentation off (mosaic 0 and every probability 0) on one fixed
  batch: the losses at rel 1e-4, then params, batch_stats and EMA at abs
  1e-5 plus rel 1e-4, against JAX's train_step math.
"""

from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from jax.flatten_util import ravel_pytree

from edgeyolo_tpu.cfg import get_cfg
from edgeyolo_tpu.data.augment_device import augment_batch as jaugment
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.train import trainer as jtrainer
from edgeyolo_tpu.train.loss import DetectionLoss as JDetectionLoss
from edgeyolo_tpu_torch.nn.modules import conv
from edgeyolo_tpu_torch.nn.tasks import DetectionModel, num_trainable
from edgeyolo_tpu_torch.train import trainer
from edgeyolo_tpu_torch.utils.convert import from_jax_variables, jax_path_to_torch_key
from jax_host import flat_decay_mask, unravel_host
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

S, B, M = 64, 2, 8
build_optimizer = jtrainer.build_optimizer  # the chain itself, before any test patches it
AUG_OFF = {"mosaic": 0.0, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "degrees": 0.0,
           "translate": 0.0, "scale": 0.0, "shear": 0.0, "perspective": 0.0, "flipud": 0.0,
           "fliplr": 0.0, "bgr": 0.0, "photometric": 0.0, "mixup": 0.0}


# -- BatchNorm ------------------------------------------------------------------
def _bn_case():
    x = np.random.RandomState(0).randn(2, 16, 2, 2).astype(np.float32) * 3 + 1  # n = 8 per channel
    bn = fnn.BatchNorm(use_running_average=False, momentum=jconv.MODEL_BN_MOMENTUM,
                       epsilon=jconv.MODEL_BN_EPS)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    v = bn.init(jax.random.PRNGKey(0), xj)
    yj, mut = bn.apply(v, xj, mutable=["batch_stats"])
    return x, np.asarray(yj).transpose(0, 3, 1, 2), mut["batch_stats"]


def test_bn_train_mode_updates_running_stats_as_flax():
    x, yj, stats = _bn_case()
    bn = conv.batch_norm(16).train()
    y = bn(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), yj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5)


def test_stock_torch_bn_update_is_what_the_check_catches():
    """The discriminating power of the test above: torch's own update differs."""
    x, _, stats = _bn_case()
    stock = torch.nn.BatchNorm2d(16, eps=conv.MODEL_BN_EPS, momentum=conv.MODEL_BN_MOMENTUM).train()
    stock(torch.from_numpy(x))
    rel = np.abs(stock.running_var.numpy() / np.asarray(stats["var"]) - 1)
    assert rel.max() > 1e-3


# -- optimizer -----------------------------------------------------------------
def _lr(s):
    return 0.01 / (1 + s)


def _mom(s):
    return 0.8 + 0.05 * s


@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW", "RMSProp"])
def test_optimizer_matches_the_optax_chain(name):
    rs = np.random.RandomState(1)
    n = 300
    p0 = rs.randn(n).astype(np.float32)
    mask = (rs.rand(n) < 0.6).astype(np.float32)
    grads = [rs.randn(n).astype(np.float32) * s for s in (0.1, 3.0, 0.2, 2.0)]  # norm ~1.7 and ~52
    decay = 5e-4 * 2 * 2 / 4
    tx = optax.MultiSteps(build_optimizer(
        jnp.asarray(p0), name, 0.01, 0.9, decay, _lr, momentum_schedule=_mom,
        flat_mask=jnp.asarray(mask)), every_k_schedule=2)
    state, pj = tx.init(jnp.asarray(p0)), jnp.asarray(p0)
    opt = trainer.FlatOptimizer(name, _lr, 0.9, decay, torch.from_numpy(mask), _mom)
    ms, pt = trainer.MultiSteps(opt, 2), torch.from_numpy(p0.copy())
    for i, g in enumerate(grads):
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = pj + upd
        assert ms.step(pt, torch.from_numpy(g)) == (i % 2 == 1)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    assert opt.count == 2 and not np.allclose(pt.numpy(), p0)


def test_clip_is_exact_at_the_flagship_size():
    """The global-norm clip over the flagship's 2,678,683 trained parameters,
    against the f64 clip at rtol 1e-6 (an f32 vector_norm on the CPU drifts
    by 3e-5 relative here, and by 4e-4 on real gradients)."""
    g = torch.rand(2678683, generator=torch.Generator().manual_seed(0))
    p = torch.zeros_like(g)
    trainer.FlatOptimizer("SGD", lambda _: 1.0, 0.0, 0.0, torch.zeros_like(g)).update(p, g)
    exact = -g.double() * trainer.CLIP_NORM / torch.linalg.vector_norm(g.double())
    np.testing.assert_allclose(p.numpy(), exact.numpy(), rtol=1e-6, atol=0)


# -- schedules -------------------------------------------------------------------
class _Captured(Exception):
    pass


def _jax_trainer_build(tmp_path, monkeypatch, nb, **overrides):
    """Run JAX's DetectionTrainer.train up to build_optimizer and return what
    it passes there (schedule closures, decay, name) and the MultiSteps k."""
    got = {}

    def build(p_flat, name, lr0, momentum, decay, schedule, momentum_schedule=None, flat_mask=None):
        got.update(name=name, lr0=lr0, momentum=momentum, decay=decay, lr_at=schedule,
                   momentum_at=momentum_schedule)
        raise _Captured

    monkeypatch.setattr(jtrainer, "build_optimizer", build)
    monkeypatch.setattr(jtrainer, "check_det_dataset",
                        lambda d: {"names": {i: str(i) for i in range(80)}, "nc": 80, "train": "x"})
    monkeypatch.setattr(jtrainer, "YOLODataset", lambda *a, **k: None)
    monkeypatch.setattr(jtrainer, "build_dataloader", lambda *a, **k: [None] * nb)
    args = get_cfg(overrides={"data": "synthetic.yaml", "val": False, "plots": False, **overrides})
    params = {"l0_Conv": {"conv": {"kernel": jnp.ones((3, 3, 3, 4))}, "bn": {"scale": jnp.ones(4)}}}
    model = SimpleNamespace(nc=80, yaml={}, head_name="GFLHeadv2_uniH", names={},
                            variables={"params": params, "batch_stats": {}})
    with pytest.raises(_Captured):
        jtrainer.DetectionTrainer(model, args, save_dir=tmp_path).train()
    return got


SCHEDULES = {
    "sgd-warmup": dict(nb=40, epochs=5, batch=16, optimizer="SGD", warmup_epochs=3.0),
    "cos-lr": dict(nb=7, epochs=4, batch=8, optimizer="SGD", cos_lr=True, lrf=0.1),
    "one-epoch": dict(nb=3, epochs=1, batch=32, optimizer="SGD"),
    "auto": dict(nb=5, epochs=3, batch=16, optimizer="auto"),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedules_match_the_jax_trainer(case, tmp_path, monkeypatch):
    cfg = dict(SCHEDULES[case])
    nb = cfg.pop("nb")
    got = _jax_trainer_build(tmp_path, monkeypatch, nb, **cfg)
    model = SimpleNamespace(nc=80)
    t = trainer.DetectionTrainer.__new__(trainer.DetectionTrainer)
    t.args, t.model = {**trainer.TRAIN_DEFAULTS, **cfg}, model
    a = t.args
    accumulate = max(round(a["nbs"] / a["batch"]), 1)
    name, lr0, momentum = (
        (a["optimizer"], a["lr0"], a["momentum"]) if a["optimizer"] != "auto"
        else trainer.auto_optimizer(80, a["lr0"], a["momentum"], a["epochs"] * nb))
    assert (name, lr0, momentum) == (got["name"], got["lr0"], got["momentum"])
    sched = trainer.Schedule(lr0, a["lrf"], a["epochs"], nb, accumulate,
                             trainer.warmup_steps_for(a["warmup_epochs"], a["epochs"], nb),
                             a["cos_lr"], momentum, a["warmup_momentum"])
    np.testing.assert_allclose(a["weight_decay"] * a["batch"] * accumulate / a["nbs"],
                               got["decay"], rtol=1e-12)
    for step in range(0, a["epochs"] * nb // accumulate + 3):
        assert abs(sched.lr_at(step) - float(got["lr_at"](jnp.int32(step)))) < 1e-7
        if got["momentum_at"] is not None:
            assert abs(sched.momentum_at(step) - float(got["momentum_at"](jnp.int32(step)))) < 1e-7
    assert (got["momentum_at"] is None) == (sched.warmup_steps == 0)


def test_ema_decay_follows_the_jax_formula():
    for t in (1, 2, 10, 1000, 20000):
        jd = float(0.9999 * (1 - jnp.exp(-jnp.int32(t) / 2000.0)))
        assert abs(trainer.ModelEMA.decay(t) - jd) < 1e-7
    ema = trainer.ModelEMA(torch.zeros(3))
    ema.update(torch.ones(3))
    np.testing.assert_allclose(ema.ema.numpy(), 1 - trainer.ModelEMA.decay(1), rtol=1e-6)


def test_early_stopping():
    stop = trainer.EarlyStopping(patience=2)
    assert not stop(0, 0.5) and not stop(1, 0.4) and stop(2, 0.3)
    assert not trainer.EarlyStopping(2)(5, None)
    assert not stop(3, 0.5) and stop.best_epoch == 3  # a tie advances the best epoch


# -- the step --------------------------------------------------------------------
@pytest.fixture(scope="module")
def flagship():
    jm = jtasks.DetectionModel("edgeline-yolo.yaml")
    jm.init(0, imgsz=S)
    rs = np.random.RandomState(0)
    flat = {}
    for k, a in traverse_util.flatten_dict(jax.device_get(jm.variables)).items():
        a = np.asarray(a)
        if k[-1] == "gamma":  # open the wavelet branch, which init leaves shut
            a = np.float32(rs.uniform(0.3, 0.8))
        elif k[-1] == "mean":
            a = (rs.randn(*a.shape) * 0.1).astype(np.float32)
        elif k[-1] == "var":
            a = rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        flat[k] = a
    return jm, flat


def test_decay_mask_and_trained_params_match_jax(flagship):
    jm, flat = flagship
    pm = DetectionModel("edgeline-yolo.yaml", device="cpu")
    assert num_trainable(pm) == jm.num_params() == 2_678_683
    jmask = traverse_util.flatten_dict(jtrainer._decay_mask(jm.variables["params"]))
    mask = trainer._decay_mask(pm)
    assert mask == {jax_path_to_torch_key(k): bool(v) for k, v in jmask.items()}
    assert sum(mask.values()) > 0 and not all(mask.values())


def _batch():
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (B, S, S, 3)).astype(np.uint8)
    cls = rs.randint(0, 80, (B, M)).astype(np.float32)
    xy, wh = rs.uniform(0.3, 0.7, (B, M, 2)), rs.uniform(0.2, 0.5, (B, M, 2))
    mask = (np.arange(M)[None] < np.array([[4], [6]])).astype(np.float32)
    boxes = np.concatenate([xy, wh], -1).astype(np.float32) * mask[..., None]
    return {"img": img, "cls": cls, "bboxes": boxes, "mask_gt": mask, "n_real": B}


HYP = {**AUG_OFF, "optimizer": "SGD", "lr0": 0.01, "momentum": 0.937, "weight_decay": 5e-4,
       "batch": B, "nbs": 4, "epochs": 3, "warmup_epochs": 3.0, "amp": False}
STEPS = 3


def _jax_steps(jm, flat, batch, sched):
    """JAX's DetectionTrainer.train_step math, f32, one device."""
    variables = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()})
    params, bstats = variables["params"], variables["batch_stats"]
    p_flat, unravel = ravel_pytree(params)
    mask_flat = flat_decay_mask(params, jtrainer._decay_mask(params))
    accumulate = max(round(HYP["nbs"] / B), 1)
    decay = HYP["weight_decay"] * B * accumulate / HYP["nbs"]
    tx = optax.MultiSteps(build_optimizer(
        p_flat, "SGD", HYP["lr0"], HYP["momentum"], decay, sched["lr_at"],
        momentum_schedule=sched["momentum_at"], flat_mask=mask_flat), every_k_schedule=accumulate)
    crit = JDetectionLoss(jm, hyp=HYP)
    hyp = {k: float(v) for k, v in HYP.items() if isinstance(v, (int, float))}
    b = {k: jnp.asarray(v) for k, v in batch.items() if k != "n_real"}

    @jax.jit
    def step(state, key):
        p_flat, bstats, opt_state, ema, upd_count = state
        img01, acls, aboxes, amask = jaugment(b["img"], b["cls"], b["bboxes"], b["mask_gt"], key,
                                              S, hyp, mosaic=False)
        tgt = {"cls": acls, "bboxes": aboxes, "mask_gt": amask, "img_weight": jnp.ones(B)}

        def loss_fn(pf):
            out, mut = jm.apply({"params": unravel(pf), "batch_stats": bstats}, img01, train=True,
                                mutable=["batch_stats"])
            loss, items = crit(out["feats"], tgt, out["quality"])
            return loss, mut["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(p_flat)
        updates, new_opt = tx.update(grads, opt_state, p_flat)
        new_p = p_flat + updates
        did = (new_opt.mini_step == 0).astype(jnp.int32)
        upd = upd_count + did
        d = jnp.where(did == 1, 0.9999 * (1 - jnp.exp(-upd / 2000.0)), 1.0)
        return (new_p, new_bs, new_opt, ema * d + (1 - d) * new_p, upd), loss

    state = (p_flat, bstats, tx.init(p_flat), jnp.copy(p_flat), jnp.int32(0))
    losses = []
    for i in range(STEPS):
        state, loss = step(state, jax.random.PRNGKey(i))
        losses.append(float(loss))
    p_flat, bstats, _, ema, upd = state

    def as_port(tree, coll):
        return from_jax_variables({(coll, *k): np.asarray(v) for k, v in
                                   traverse_util.flatten_dict(tree).items()})

    return (losses, as_port(unravel_host(params, p_flat), "params"), as_port(bstats, "batch_stats"),
            as_port(unravel_host(params, ema), "params"), int(upd))


def test_three_train_steps_match_jax(flagship, tmp_path, monkeypatch):
    jm, flat = flagship
    batch = _batch()
    sched = _jax_trainer_build(tmp_path, monkeypatch, 1, **{k: HYP[k] for k in (
        "optimizer", "lr0", "momentum", "weight_decay", "epochs", "batch", "nbs", "warmup_epochs")})
    j_losses, j_params, j_stats, j_ema, j_updates = _jax_steps(jm, flat, batch, sched)

    pm = DetectionModel("edgeline-yolo.yaml", device="cpu")
    pm.load_state_dict(from_jax_variables(flat), strict=False)
    t = trainer.DetectionTrainer(pm, HYP, device="cpu")
    t.setup(nb=1)
    assert t.accumulate == 2 and t.schedule.warmup_steps == 100
    dev_batch = trainer.batch_to_device(batch, torch.device("cpu"))
    losses, updated = [], []
    for _ in range(STEPS):
        loss, items, did = t.train_step(dev_batch, mosaic=False)
        losses.append(float(loss))
        updated.append(did)
        assert all(np.isfinite(float(v)) for v in items.values())
    assert updated == [False, True, False] and j_updates == t.ema.updates == 1

    sd, ema = pm.state_dict(), t.ema_state_dict()
    for what, port, ref in (("params", sd, j_params), ("batch_stats", sd, j_stats),
                            ("ema", ema, j_ema)):
        worst = max((port[n] - r).abs().max().item() for n, r in ref.items())
        print(f"{what}: max abs diff {worst:.3e} over {len(ref)} tensors")
    print(f"losses {losses} vs JAX {j_losses}")
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    for name, ref in {**j_params, **j_stats}.items():
        np.testing.assert_allclose(sd[name].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    for name, ref in j_ema.items():
        np.testing.assert_allclose(ema[name].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    start = from_jax_variables(flat)
    moved = [n for n, r in j_params.items() if not torch.equal(r, start[n])]
    assert len(moved) > 100  # the update moved the parameters
    assert all(not torch.equal(r, start[n]) for n, r in j_stats.items()
               if n.endswith("running_var"))


def test_trainer_runs_epochs_over_batches():
    """The loop: epochs over a re-iterable of collated batches, mosaic closed
    for the last close_mosaic epochs, loss items per epoch, the EMA on real
    updates only, and early stopping on the fitness it is handed."""
    pm = DetectionModel("edgeline-yolo.yaml", device="cpu")
    t = trainer.DetectionTrainer(pm, {"batch": B, "nbs": 4, "epochs": 4, "close_mosaic": 2,
                                      "patience": 2, "amp": False, "optimizer": "SGD"},
                                 device="cpu")
    seen = []
    step = t.train_step
    t.train_step = lambda batch, mosaic: (seen.append(mosaic), step(batch, mosaic))[1]
    batches = [_batch(), {**_batch(), "n_real": 1}]
    losses = t.train(batches, fitness=lambda tr: [0.5, 0.4, 0.3, 0.2][tr.epoch])
    assert seen == [True, True, True, True, False, False]  # stopped after epoch 2 of 4
    assert len(losses) == 3 and all(np.isfinite(v) for row in losses for v in row)
    assert t.ema.updates == 3 and t.optimizer.opt.count == 3
