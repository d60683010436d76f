"""The segment task's training in the PyTorch port against the JAX package, on
the CPU in f32.

- SegmentationLoss: the value, its items and the gradients with respect to
  the head's feats, the mask coefficients and the prototypes against JAX's
  dense loss (value rel 1e-5, each gradient 1e-5 of its largest magnitude),
  with every image real and with a padded duplicate (img_weight 0); and the
  port's foreground-only sum against a dense torch form of JAX's definition
  (every anchor's (ph, pw) logits, background weighted by 0): rel 1e-6.
- The step: yolo11n-seg at 64 px, batch 2, from the same JAX weights, 3
  micro-steps (accumulation 2, one real update) with augmentation off on
  one fixed batch with instance masks: the losses at rel 1e-4, then params,
  batch_stats and EMA at abs 1e-5 plus rel 1e-4 (tests/test_torch_train.py's
  tolerances), against JAX's train_step math with its SegmentationLoss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from jax.flatten_util import ravel_pytree
from test_torch_train import AUG_OFF, _jax_trainer_build, build_optimizer
from jax_host import flat_decay_mask, unravel_host
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.data.augment_device import augment_batch as jaugment
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.train import trainer as jtrainer
from edgeyolo_tpu.train.loss import SegmentationLoss as JSegmentationLoss
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.ops.boxes import xywh2xyxy
from edgeyolo_tpu_torch.ops.segments import crop_mask
from edgeyolo_tpu_torch.train import trainer
from edgeyolo_tpu_torch.train.loss import SegmentationLoss, bce_logits
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

S, B, M, NC, NM = 64, 2, 6, 3, 8
LEVELS = (8, 4, 2)


def _loss_inputs(seed=0):
    rs = np.random.RandomState(seed)
    feats = [rs.randn(B, s, s, 64 + NC).astype(np.float32) for s in LEVELS]
    mc = rs.randn(B, sum(s * s for s in LEVELS), NM).astype(np.float32)
    proto = rs.randn(B, 16, 16, NM).astype(np.float32)
    cls = rs.randint(0, NC, (B, M)).astype(np.float32)
    xy, wh = rs.uniform(0.3, 0.7, (B, M, 2)), rs.uniform(0.2, 0.5, (B, M, 2))
    mask = (np.arange(M)[None] < np.array([[3], [5]])).astype(np.float32)
    boxes = (np.concatenate([xy, wh], -1) * mask[..., None]).astype(np.float32)
    masks = (rs.rand(B, M, 16, 16) > 0.5).astype(np.float32) * mask[..., None, None]
    return feats, mc, proto, {"cls": cls, "bboxes": boxes, "mask_gt": mask, "masks": masks}


def _port_loss(feats, mc, proto, batch, wimg, crit=None):
    ft = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous().requires_grad_() for f in feats]
    mt = torch.from_numpy(mc).requires_grad_()
    pt = torch.from_numpy(proto).permute(0, 3, 1, 2).contiguous().requires_grad_()
    tgt = {k: torch.from_numpy(v) for k, v in batch.items()}
    tgt["img_weight"] = torch.tensor(wimg)
    crit = crit or SegmentationLoss(nc=NC, hyp={})
    loss, items = crit({"feats": ft, "mask_coefs": mt, "proto": pt}, tgt)
    loss.backward()
    grads = [g.permute(0, 2, 3, 1).numpy() for g in (*(f.grad for f in ft), pt.grad)]
    return loss.item(), items, grads[:3], mt.grad.numpy(), grads[3]


@pytest.mark.parametrize("wimg", [[1.0, 1.0], [1.0, 0.0]], ids=["real", "padded_duplicate"])
def test_seg_loss_and_grads_match_jax(wimg):
    feats, mc, proto, batch = _loss_inputs()
    crit = JSegmentationLoss(None, nc=NC, hyp={})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["img_weight"] = jnp.asarray(wimg, jnp.float32)

    def f(fs, m, p):
        return crit({"feats": fs, "mask_coefs": m, "proto": p}, jb)

    (lj, ij), gj = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        [jnp.asarray(x) for x in feats], jnp.asarray(mc), jnp.asarray(proto))
    lt, it, gf, gm, gp = _port_loss(feats, mc, proto, batch, wimg)
    assert float(ij["seg"]) > 0
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
    for k in ("box", "cls", "dfl", "seg"):
        np.testing.assert_allclose(float(it[k]), float(ij[k]), rtol=1e-5, err_msg=k)
    for got, want in ((gm, gj[1]), (gp, gj[2]), *zip(gf, gj[0])):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    if wimg[1] == 0:  # the duplicate's coefficients and prototypes take no gradient
        assert np.abs(gm[1]).max() == 0 and np.abs(gp[1]).max() == 0


def _dense_seg_term(crit, out, tgt):
    """JAX's dense definition in torch: every anchor's logits and BCE, the
    background weighted by 0."""
    _, _, assign = crit._terms(out["feats"], tgt)
    mc, proto = out["mask_coefs"], out["proto"]
    b, nm, ph, pw = proto.shape
    tgt_masks = tgt["masks"][torch.arange(b)[:, None], assign["target_gt_idx"]]  # (B, A, ph, pw)
    logits = torch.einsum("bnhw,ban->bahw", proto, mc)
    xyxyn = assign["target_bboxes"] / S
    box_p = xyxyn * torch.tensor([pw, ph, pw, ph], dtype=torch.float32)
    area = ((xyxyn[..., 2] - xyxyn[..., 0]) * (xyxyn[..., 3] - xyxyn[..., 1])).clamp(min=1e-3)
    cropped = crop_mask(bce_logits(logits, tgt_masks), box_p)
    per_anchor = cropped.flatten(2).mean(-1) / area
    w = assign["fg_mask"].float() * tgt["img_weight"][:, None]
    return (per_anchor * w).sum() / w.sum().clamp(min=1.0) * crit.box_gain


def test_foreground_only_sum_equals_the_dense_form():
    feats, mc, proto, batch = _loss_inputs(seed=1)
    crit = SegmentationLoss(nc=NC, hyp={})
    res = []
    for dense in (False, True):
        ft = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous() for f in feats]
        mt = torch.from_numpy(mc).requires_grad_()
        pt = torch.from_numpy(proto).permute(0, 3, 1, 2).contiguous().requires_grad_()
        tgt = {k: torch.from_numpy(v) for k, v in batch.items()}
        tgt["img_weight"] = torch.ones(B)
        out = {"feats": ft, "mask_coefs": mt, "proto": pt}
        seg = (_dense_seg_term(crit, out, tgt) if dense
               else crit.mask_term(out, tgt["masks"], crit._terms(ft, tgt)[2]))
        seg.backward()
        res.append((seg.item(), mt.grad.clone(), pt.grad.clone()))
    (v0, m0, p0), (v1, m1, p1) = res
    np.testing.assert_allclose(v0, v1, rtol=1e-6)
    torch.testing.assert_close(m0, m1, rtol=1e-6, atol=1e-6 * m1.abs().max().item())
    torch.testing.assert_close(p0, p1, rtol=1e-6, atol=1e-6 * p1.abs().max().item())


# -- the step -------------------------------------------------------------------------------
HYP = {**AUG_OFF, "optimizer": "SGD", "lr0": 0.01, "momentum": 0.937, "weight_decay": 5e-4,
       "batch": B, "nbs": 4, "epochs": 3, "warmup_epochs": 3.0, "amp": False, "copy_paste": 0.0}
STEPS = 3


@pytest.fixture(scope="module")
def seg_model():
    jm = jtasks.DetectionModel(jtasks.yaml_model_load("yolo11n-seg.yaml"))
    jm.init(0, imgsz=S)
    rs = np.random.RandomState(0)
    flat = {}
    for k, a in traverse_util.flatten_dict(jax.device_get(jm.variables)).items():
        a = np.asarray(a)
        if k[-1] == "mean":
            a = (rs.randn(*a.shape) * 0.1).astype(np.float32)
        elif k[-1] == "var":
            a = rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        flat[k] = a
    return jm, flat


def _batch():
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (B, S, S, 3)).astype(np.uint8)
    cls = rs.randint(0, 80, (B, M)).astype(np.float32)
    xy, wh = rs.uniform(0.3, 0.7, (B, M, 2)), rs.uniform(0.2, 0.5, (B, M, 2))
    mask = (np.arange(M)[None] < np.array([[4], [6]])).astype(np.float32)
    boxes = np.concatenate([xy, wh], -1).astype(np.float32) * mask[..., None]
    masks = np.zeros((B, M, S // 4, S // 4), np.float32)
    xyxy = xywh2xyxy(torch.from_numpy(boxes)).numpy() * S / 4
    for i in range(B):
        for j in range(M):
            if mask[i, j]:
                x1, y1, x2, y2 = np.round(xyxy[i, j]).astype(int)
                masks[i, j, y1:y2, x1:x2] = 1.0
                masks[i, j, y1:(y1 + y2) // 2, x1:(x1 + x2) // 2] = 0.0  # not its box: an L
    return {"img": img, "cls": cls, "bboxes": boxes, "mask_gt": mask, "masks": masks,
            "n_real": B}


def _jax_steps(jm, flat, batch, sched):
    """JAX's DetectionTrainer.train_step math for a segment model, f32."""
    variables = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()})
    params, bstats = variables["params"], variables["batch_stats"]
    p_flat, unravel = ravel_pytree(params)
    mask_flat = flat_decay_mask(params, jtrainer._decay_mask(params))
    accumulate = max(round(HYP["nbs"] / B), 1)
    decay = HYP["weight_decay"] * B * accumulate / HYP["nbs"]
    tx = optax.MultiSteps(build_optimizer(
        p_flat, "SGD", HYP["lr0"], HYP["momentum"], decay, sched["lr_at"],
        momentum_schedule=sched["momentum_at"], flat_mask=mask_flat), every_k_schedule=accumulate)
    crit = JSegmentationLoss(jm, hyp=HYP)
    hyp = {k: float(v) for k, v in HYP.items() if isinstance(v, (int, float))}
    b = {k: jnp.asarray(v) for k, v in batch.items() if k != "n_real"}

    @jax.jit
    def step(state, key):
        p_flat, bstats, opt_state, ema, upd_count = state
        img01, acls, aboxes, amask, ex = jaugment(b["img"], b["cls"], b["bboxes"], b["mask_gt"],
                                                  key, S, hyp, mosaic=False, masks=b["masks"])
        tgt = {"cls": acls, "bboxes": aboxes, "mask_gt": amask, "masks": ex["masks"],
               "img_weight": jnp.ones(B)}

        def loss_fn(pf):
            out, mut = jm.apply({"params": unravel(pf), "batch_stats": bstats}, img01, train=True,
                                mutable=["batch_stats"])
            loss, items = crit(out, tgt)
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


def test_three_seg_train_steps_match_jax(seg_model, tmp_path, monkeypatch):
    jm, flat = seg_model
    batch = _batch()
    sched = _jax_trainer_build(tmp_path, monkeypatch, 1, **{k: HYP[k] for k in (
        "optimizer", "lr0", "momentum", "weight_decay", "epochs", "batch", "nbs", "warmup_epochs")})
    j_losses, j_params, j_stats, j_ema, j_updates = _jax_steps(jm, flat, batch, sched)

    pm = DetectionModel("yolo11n-seg.yaml", device="cpu")
    pm.load_state_dict(from_jax_variables(flat), strict=False)
    t = trainer.DetectionTrainer(pm, HYP, device="cpu")
    assert isinstance(t.criterion, SegmentationLoss)
    t.setup(nb=1)
    dev_batch = trainer.batch_to_device(batch, torch.device("cpu"))
    assert dev_batch["masks"].shape == (B, M, S // 4, S // 4)
    losses, updated = [], []
    for _ in range(STEPS):
        loss, items, did = t.train_step(dev_batch, mosaic=False)
        losses.append(float(loss))
        updated.append(did)
        assert float(items["seg"]) > 0
    assert updated == [False, True, False] and j_updates == t.ema.updates == 1
    print(f"losses {losses} vs JAX {j_losses}")
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    sd, ema = pm.state_dict(), t.ema_state_dict()
    for name, ref in {**j_params, **j_stats}.items():
        np.testing.assert_allclose(sd[name].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    for name, ref in j_ema.items():
        np.testing.assert_allclose(ema[name].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    start = from_jax_variables(flat)
    assert not torch.equal(j_params["model.23.proto.upsample.weight"],
                           start["model.23.proto.upsample.weight"])  # the mask term trained
