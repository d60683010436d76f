"""Training YOLOv10-n in the PyTorch port against the JAX package, on the CPU
in f32 at 64 px.

Three SGD steps of yolov10n at full width and depth, batch 4, augmentation
off, accumulate 1 (three updates, the momentum carried between them) on the
learning rate and momentum closures that JAX's own DetectionTrainer.train
builds for the same hyps (tests/test_torch_train.py's capture), from the
same seeded weights with BatchNorm statistics moved off their init, through
E2EDetectLoss on the whole output: the one2many branch (TAL top 10) and the
one2one branch (top 1) on detached inputs, neither with quality. The losses
at rel 1e-4, the params, BatchNorm statistics and EMA after them at 1e-5 abs
plus 1e-4 rel: the tolerances of tests/test_torch_v13_train.py.

The steps run in the warmup, as tests/test_torch_train.py's flagship steps
do (learning rate 1e-4 to 3e-4), on four images. Three full-rate steps
(lr 0.01) are ill-conditioned at 64 px: the loss rises from step to step,
and the port's own second-step loss moves by 2.5e-5 relative when its
parameters after the first are perturbed by 1e-6 relative, so the two
frameworks' f32 rounding (1e-5 relative in the first step's early conv
weights) parts them by 7e-4 at step 2. At two images the deep head's
2 x 2 level normalises over 8 values per channel, and its BatchNorm
statistics part by 2.2e-5 after three warmup steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import traverse_util
from jax.flatten_util import ravel_pytree
from test_torch_families import _jax_template
from test_torch_train import _jax_trainer_build
from test_torch_v13_e2e_families import _to_jax
from test_torch_v13_train import HYP, S, _opened

from edgeyolo_tpu.data.augment_device import augment_batch as jaugment
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.train import trainer as jtrainer
from edgeyolo_tpu.train.loss import E2EDetectLoss as JE2EDetectLoss
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.train import trainer
from edgeyolo_tpu_torch.utils.convert import from_jax_variables
from jax_host import flat_decay_mask, unravel_host
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

STEPS, B = 3, 4
build_optimizer = jtrainer.build_optimizer  # the chain itself, before the capture patches it
V10_HYP = {**HYP, "batch": B, "nbs": B, "epochs": STEPS, "warmup_epochs": 3.0}


def _train_batch():
    """tests/test_torch_v13_train.py's batch at four images: 3 to 6 boxes each."""
    rs = np.random.RandomState(3)
    m = 8
    mask = (np.arange(m)[None] < rs.randint(3, 7, (B, 1))).astype(np.float32)
    boxes = np.concatenate([rs.uniform(0.3, 0.7, (B, m, 2)), rs.uniform(0.2, 0.5, (B, m, 2))], -1)
    return {"img": rs.randint(0, 256, (B, S, S, 3)).astype(np.uint8),
            "cls": rs.randint(0, 80, (B, m)).astype(np.float32),
            "bboxes": (boxes * mask[..., None]).astype(np.float32), "mask_gt": mask, "n_real": B}


def _jax_e2e_steps(jm, variables, batch, sched):
    """JAX's train_step math over STEPS steps with its E2EDetectLoss: f32,
    accumulate 1, the optimizer state and the EMA carried."""
    params, bstats = variables["params"], variables["batch_stats"]
    p_flat, unravel = ravel_pytree(params)
    mask_flat = flat_decay_mask(params, jtrainer._decay_mask(params))
    tx = optax.MultiSteps(build_optimizer(
        p_flat, "SGD", V10_HYP["lr0"], V10_HYP["momentum"], V10_HYP["weight_decay"],
        sched["lr_at"], momentum_schedule=sched["momentum_at"], flat_mask=mask_flat),
        every_k_schedule=1)
    crit = JE2EDetectLoss(jm, hyp=V10_HYP)
    hyp = {k: float(v) for k, v in V10_HYP.items() if isinstance(v, (int, float))}
    b = {k: jnp.asarray(v) for k, v in batch.items() if k != "n_real"}

    @jax.jit
    def step(state, key):
        p_flat, bstats, opt_state, ema, upd = state
        img01, acls, aboxes, amask = jaugment(b["img"], b["cls"], b["bboxes"], b["mask_gt"],
                                              key, S, hyp, mosaic=False)
        tgt = {"cls": acls, "bboxes": aboxes, "mask_gt": amask, "img_weight": jnp.ones(B)}

        def loss_fn(pf):
            out, mut = jm.net.apply({"params": unravel(pf), "batch_stats": bstats}, img01,
                                    train=True, mutable=["batch_stats"])
            return crit(out, tgt)[0], mut["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(p_flat)
        updates, new_opt = tx.update(grads, opt_state, p_flat)
        new_p = p_flat + updates
        upd = upd + 1
        d = 0.9999 * (1 - jnp.exp(-upd / 2000.0))
        return (new_p, new_bs, new_opt, ema * d + (1 - d) * new_p, upd), loss

    state = (p_flat, bstats, tx.init(p_flat), jnp.copy(p_flat), jnp.int32(0))
    losses = []
    for i in range(STEPS):
        state, loss = step(state, jax.random.PRNGKey(i))
        losses.append(float(loss))
    p_flat, bstats, _, ema, _ = state

    def as_port(tree, coll):
        return from_jax_variables({(coll, *k): np.asarray(v) for k, v in
                                   traverse_util.flatten_dict(tree).items()})

    return (losses, as_port(unravel_host(params, p_flat), "params"), as_port(bstats, "batch_stats"),
            as_port(unravel_host(params, ema), "params"))


def test_three_v10_train_steps_match_jax(tmp_path, monkeypatch):
    pm = DetectionModel("yolov10n", device="cpu")
    sd = _opened(pm.state_dict())
    jm = jtasks.DetectionModel("yolov10n.yaml")
    variables, _ = _to_jax(sd, _jax_template(jm))
    batch = _train_batch()
    sched = _jax_trainer_build(tmp_path, monkeypatch, 1, **{k: V10_HYP[k] for k in (
        "optimizer", "lr0", "momentum", "weight_decay", "epochs", "batch", "nbs",
        "warmup_epochs")})
    j_losses, j_params, j_stats, j_ema = _jax_e2e_steps(
        jm, jax.tree.map(jnp.asarray, variables), batch, sched)

    pm.load_state_dict(sd)
    t = trainer.DetectionTrainer(pm, V10_HYP, device="cpu")
    assert t.end2end and type(t.criterion).__name__ == "E2EDetectLoss"
    t.setup(nb=1)
    assert t.accumulate == 1 and t.schedule.warmup_steps == 100
    lrs = [t.schedule.lr_at(i) for i in range(STEPS)]
    np.testing.assert_allclose(lrs, [float(sched["lr_at"](i)) for i in range(STEPS)], rtol=1e-6)
    assert len(set(lrs)) == STEPS  # warmup: a new learning rate and momentum each update
    dev_batch = trainer.batch_to_device(batch, torch.device("cpu"))
    losses = []
    for _ in range(STEPS):
        loss, items, updated = t.train_step(dev_batch, mosaic=False)
        assert updated and all(np.isfinite(float(v)) for v in items.values())
        losses.append(float(loss))
    assert t.ema.updates == STEPS
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    now, ema = pm.state_dict(), t.ema_state_dict()
    for n, ref in {**j_params, **j_stats}.items():
        np.testing.assert_allclose(now[n].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4, err_msg=n)
    for n, ref in j_ema.items():
        np.testing.assert_allclose(ema[n].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4, err_msg=n)
    moved = [n for n, r in j_params.items() if not torch.equal(r, sd[n])]
    assert any(".one2one_cv3." in n for n in moved) and any(".cv3." in n for n in moved)
    assert any(n.startswith("model.22.m.0.cv1.2.conv.") for n in moved)  # RepVGGDW (lk)
    assert any(n.startswith("model.10.attn.") for n in moved)  # PSA
