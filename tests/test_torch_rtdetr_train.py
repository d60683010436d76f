"""RT-DETR's training in the PyTorch port against the JAX package, on the CPU
in f32.

- `make_cdn_group` handed JAX's four draws (the same key splits as JAX's
  generator): classes exact, boxes 1e-6, and the head's CDN attention mask
  equal to the one JAX's head builds (captured from it).
- `auction_assign`: equal to JAX's, -1s included, on seeded cost matrices
  with and without masked rows (and with near-equal columns), and batched
  over images and layers equal to one problem at a time.
- `RTDETRDetectionLoss` on seeded head outputs: value 1e-5 relative, every
  gradient 1e-5 of its largest, with and without denoising queries.
- The weight decay mask equal to JAX's `_decay_mask`, leaf for leaf.
- Three SGD steps of yolov8-rtdetr-n at full width, 64 px, batch 4,
  augmentation off, accumulate 1, in the warmup (tests/test_torch_v10_train.py's
  protocol), against JAX's train-step math with its criterion and
  `make_cdn_group` drawn from fold_in(key, 7) as JAX's trainer draws it; the
  port's trainer replays those draws. Losses rel 1e-4; params, BatchNorm
  statistics and EMA at 1e-5 abs plus 1e-4 rel; the port's auction on JAX's
  cost matrices of each step equal to JAX's assignment, and the port
  trainer's own matched pairs equal to JAX's in the first two steps. From
  the third, the two frameworks' outputs part by f32 rounding, and JAX's
  auction resolves bids coarsely: its eps, (max |cost| + 1) / (4 nq), takes
  in the padded rows' 1e6 cost (3,000 here, ROADMAP C.18), so a row may go
  to another of two near-identical queries (6 of 126 rows there; the loss
  still agrees to 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from jax.flatten_util import ravel_pytree
from test_torch_rtdetr import jax_template, rt_perturbed
from test_torch_train import _jax_trainer_build
from test_torch_v13_train import HYP, S
from jax_host import flat_decay_mask, unravel_host
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.data.augment_device import augment_batch as jaugment
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.nn.modules import head as jhead
from edgeyolo_tpu.train import detr_loss as jdetr
from edgeyolo_tpu.train import trainer as jtrainer
from edgeyolo_tpu.utils.torch_convert import convert_rtdetr_state_dict
from edgeyolo_tpu_torch.nn.modules.head import RTDETRDecoder, cdn_attention_mask
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.train import detr_loss, trainer
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

STEPS, B, NC = 3, 4, 80
build_optimizer = jtrainer.build_optimizer  # the chain itself, before the capture patches it
RT_HYP = {**HYP, "batch": B, "nbs": B, "epochs": STEPS, "warmup_epochs": 3.0}


def jax_draws(key, b: int, d: int, nc: int) -> dict:
    """The draws JAX's make_cdn_group takes from `key`, as the port's."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {"flip": torch.from_numpy(np.array(jax.random.uniform(k1, (b, d)) < 0.25)),
            "rnd_cls": torch.from_numpy(np.array(jax.random.randint(k2, (b, d), 0, nc))),
            "sign": torch.from_numpy(np.array(jnp.where(jax.random.bernoulli(k3, 0.5, (b, d, 4)),
                                                        1.0, -1.0))),
            "rand_part": torch.from_numpy(np.array(jax.random.uniform(k4, (b, d, 4))))}


def _targets(seed: int, b: int, m: int, nc: int, counts):
    rs = np.random.RandomState(seed)
    mask = (np.arange(m)[None] < np.asarray(counts)[:, None]).astype(np.float32)
    boxes = np.concatenate([rs.uniform(0.2, 0.8, (b, m, 2)), rs.uniform(0.05, 0.5, (b, m, 2))],
                           -1)
    return (rs.randint(0, nc, (b, m)).astype(np.float32),
            (boxes * mask[..., None]).astype(np.float32), mask)


class _MaskRecorder:
    """jax.numpy for JAX's head module, recording the (T, T) bool masks it builds."""

    def __init__(self):
        self.masks = []

    def asarray(self, a, *args, **kwargs):
        if isinstance(a, np.ndarray) and a.dtype == bool and a.ndim == 2:
            self.masks.append(a.copy())
        return jnp.asarray(a, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("m,counts", [(4, (2, 4, 0)), (7, (7, 1, 3)), (30, (12, 30, 5))])
def test_cdn_group_with_jax_draws_matches_jax(m, counts, monkeypatch):
    cls, boxes, mask = _targets(m, 3, m, NC, counts)
    key = jax.random.PRNGKey(m)
    jdn = jdetr.make_cdn_group(jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask), NC, key)
    d = jdn["cls"].shape[1]
    assert d == 2 * max(1, 100 // m) * m
    dn = detr_loss.make_cdn_group(torch.from_numpy(cls), torch.from_numpy(boxes),
                                  torch.from_numpy(mask), NC, draws=jax_draws(key, 3, d, NC))
    assert (dn["cls"].numpy() == np.asarray(jdn["cls"])).all()
    np.testing.assert_allclose(dn["bbox"].numpy(), np.asarray(jdn["bbox"]), atol=1e-6, rtol=0)
    assert (dn["valid"].numpy() == np.asarray(jdn["valid"])).all()
    assert (dn["neg"].numpy() == jdn["neg"]).all()
    assert (dn["group_size"], dn["num_groups"]) == (jdn["group_size"], jdn["num_groups"])
    # the attention mask JAX's head builds for this group, against the port's
    rec = _MaskRecorder()
    monkeypatch.setattr(jhead, "jnp", rec)
    jmod = jhead.RTDETRDecoder(nc=NC, ch=(8, 8, 8), hd=16, nq=5, nh=2, ndl=1, d_ffn=16)
    xs = [jnp.zeros((3, s, s, 8)) for s in (4, 2, 1)]
    jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), xs, train=True, dn=jdn))
    (jmask,) = rec.masks
    assert (cdn_attention_mask(d, 5, dn["group_size"]).numpy() == jmask).all()


def test_cdn_group_draws_from_the_generator():
    cls, boxes, mask = _targets(1, 2, 5, NC, (3, 5))
    args = (torch.from_numpy(cls), torch.from_numpy(boxes), torch.from_numpy(mask), NC)
    a = detr_loss.make_cdn_group(*args, torch.Generator().manual_seed(0))
    b = detr_loss.make_cdn_group(*args, torch.Generator().manual_seed(0))
    c = detr_loss.make_cdn_group(*args, torch.Generator().manual_seed(1))
    assert torch.equal(a["bbox"], b["bbox"]) and not torch.equal(a["bbox"], c["bbox"])
    pos = (a["valid"] > 0) & ~a["neg"][None]
    assert a["bbox"].shape == (2, 200, 4) and (a["bbox"][a["valid"] == 0] == 0.5).all()
    assert pos.sum() == 8 * 20


def _costs(seed: int, lead: tuple, m: int, n: int, masked: int, ties: bool):
    rs = np.random.RandomState(seed)
    cost = (rs.rand(*lead, m, n) * 4).astype(np.float32)
    if ties:  # columns of equal cost: the first index must win, as in JAX
        cost[..., 1::3] = cost[..., 0:-1:3][..., :cost[..., 1::3].shape[-1]]
    row_mask = np.ones(lead + (m,), bool)
    if masked:
        row_mask[..., m - masked:] = False
        cost = np.where(row_mask[..., None], cost, 1e6).astype(np.float32)
    return cost, row_mask


@pytest.mark.parametrize("m,n,masked,ties", [(6, 300, 0, False), (8, 300, 3, False),
                                             (12, 20, 4, True), (20, 24, 0, True)])
def test_auction_matches_jax_and_batches(m, n, masked, ties):
    cost, row_mask = _costs(m + n, (3, 2), m, n, masked, ties)
    j = np.stack([np.stack([np.asarray(jdetr.auction_assign(jnp.asarray(c), jnp.asarray(r)))
                            for c, r in zip(cl, rl)]) for cl, rl in zip(cost, row_mask)])
    batched = detr_loss.auction_assign(torch.from_numpy(cost), torch.from_numpy(row_mask))
    assert batched.shape == (3, 2, m) and (batched.numpy() == j).all()
    one = detr_loss.auction_assign(torch.from_numpy(cost[1, 0]), torch.from_numpy(row_mask[1, 0]))
    assert torch.equal(one, batched[1, 0])
    got = batched.numpy()
    assert (got[~row_mask] == -1).all()
    for a in got.reshape(-1, m):  # each column taken once
        assert len(set(a[a >= 0].tolist())) == (a >= 0).sum()


L, NQ, M = 6, 40, 6


def _head_outputs(seed: int, d: int):
    rs = np.random.RandomState(seed)

    def boxes(*shape):
        xy, wh = rs.uniform(0.15, 0.85, shape + (2,)), rs.uniform(0.05, 0.35, shape + (2,))
        return np.concatenate([xy, wh], -1).astype(np.float32)

    return [rs.randn(L, B, NQ, NC).astype(np.float32), boxes(L, B, NQ),
            rs.randn(B, NQ, NC).astype(np.float32), boxes(B, NQ),
            rs.randn(L, B, d, NC).astype(np.float32), boxes(L, B, d)]


def _as_out(x, with_dn: bool):
    s, b, es, eb, ds, db = x
    out = {"feats": [b[-1], s[-1]], "aux": ([b[i] for i in range(L)], [s[i] for i in range(L)]),
           "enc_scores": es, "enc_bboxes": eb}
    if with_dn:
        out["dn_feats"] = [db[-1], ds[-1]]
        out["dn_aux"] = ([db[i] for i in range(L)], [ds[i] for i in range(L)])
    return out


@pytest.mark.parametrize("with_dn", [False, True])
def test_detr_loss_and_gradients_match_jax(with_dn):
    cls, boxes, mask = _targets(5, B, M, NC, (3, 6, 0, 1))
    key = jax.random.PRNGKey(5)
    jdn = jdetr.make_cdn_group(jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask), NC, key)
    d = jdn["cls"].shape[1]
    x = _head_outputs(6, d)
    jbatch = {"cls": jnp.asarray(cls), "bboxes": jnp.asarray(boxes), "mask_gt": jnp.asarray(mask)}
    if with_dn:
        jbatch["dn"] = jdn
    jcrit = jdetr.RTDETRDetectionLoss(nc=NC)
    (jl, jitems), jg = jax.value_and_grad(lambda a: jcrit(_as_out(a, with_dn), jbatch),
                                          has_aux=True)([jnp.asarray(a) for a in x])
    t = [torch.tensor(a, requires_grad=True) for a in x]
    batch = {"cls": torch.from_numpy(cls), "bboxes": torch.from_numpy(boxes),
             "mask_gt": torch.from_numpy(mask)}
    if with_dn:
        batch["dn"] = detr_loss.make_cdn_group(batch["cls"], batch["bboxes"], batch["mask_gt"],
                                               NC, draws=jax_draws(key, B, d, NC))
    crit = detr_loss.RTDETRDetectionLoss(nc=NC)
    loss, items = crit(_as_out(t, with_dn), batch)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(items) == set(jitems)
    for k in items:
        np.testing.assert_allclose(float(items[k]), float(jitems[k]), rtol=1e-5)
    for tt, g in zip(t[:4] if not with_dn else t, jg):
        g = np.asarray(g)
        np.testing.assert_allclose(tt.grad.numpy(), g, atol=1e-5 * np.abs(g).max(), rtol=0)
    assert crit.last_match.shape == (L + 1, B, M)
    assert (crit.last_match[:, 2] == -1).all() and (crit.last_match[:, 0, 3:] == -1).all()


@pytest.fixture(scope="module")
def v8_rtdetr():
    pm = DetectionModel("yolov8-rtdetr-n", device="cpu")
    sd = rt_perturbed(pm.state_dict(), 1.0)
    jm = jtasks.DetectionModel("yolov8-rtdetr.yaml")
    template = jax_template(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))
    variables, _ = convert_rtdetr_state_dict({k: v.numpy() for k, v in sd.items()}, template,
                                             strict=True)
    return pm, sd, jm, jax.tree.map(jnp.asarray, variables)


def test_decay_mask_is_jax_mask(v8_rtdetr):
    pm, _, _, variables = v8_rtdetr
    jmask = jax.tree.map(lambda p, mb: np.full(p.shape, 1.0 if mb else 0.0, np.float32),
                         variables["params"], jtrainer._decay_mask(variables["params"]))
    as_port = from_jax_variables({("params", *k): v for k, v in
                                  traverse_util.flatten_dict(jmask).items()})
    mine = trainer._decay_mask(pm)
    assert set(as_port) == set(mine)
    for name, want in as_port.items():
        assert (want == float(mine[name])).all(), name
    assert mine["model.22.decoder.layers.0.self_attn.in_proj_weight"]
    assert not mine["model.22.denoising_class_embed.weight"]


def _train_batch():
    rs = np.random.RandomState(3)
    m = 8
    mask = (np.arange(m)[None] < rs.randint(3, 7, (B, 1))).astype(np.float32)
    boxes = np.concatenate([rs.uniform(0.3, 0.7, (B, m, 2)), rs.uniform(0.2, 0.5, (B, m, 2))], -1)
    return {"img": rs.randint(0, 256, (B, S, S, 3)).astype(np.uint8),
            "cls": rs.randint(0, NC, (B, m)).astype(np.float32),
            "bboxes": (boxes * mask[..., None]).astype(np.float32), "mask_gt": mask, "n_real": B}


def _jax_rtdetr_steps(jm, variables, batch, sched):
    """JAX's train_step math over STEPS steps for an RT-DETR model: f32,
    accumulate 1, the CDN group from fold_in(key, 7), the optimizer state and
    the EMA carried. Returns the losses, the params, statistics and EMA as
    port state_dicts, each step's dn draws and matched columns."""
    params, bstats = variables["params"], variables["batch_stats"]
    p_flat, unravel = ravel_pytree(params)
    mask_flat = flat_decay_mask(params, jtrainer._decay_mask(params))
    tx = optax.MultiSteps(build_optimizer(
        p_flat, "SGD", RT_HYP["lr0"], RT_HYP["momentum"], RT_HYP["weight_decay"],
        sched["lr_at"], momentum_schedule=sched["momentum_at"], flat_mask=mask_flat),
        every_k_schedule=1)
    crit = jdetr.RTDETRDetectionLoss(jm)
    hyp = {k: float(v) for k, v in RT_HYP.items() if isinstance(v, (int, float))}
    b = {k: jnp.asarray(v) for k, v in batch.items() if k != "n_real"}

    def forward(pf, bstats, key):
        img01, acls, aboxes, amask = jaugment(b["img"], b["cls"], b["bboxes"], b["mask_gt"],
                                              key, S, hyp, mosaic=False)
        tgt = {"cls": acls, "bboxes": aboxes, "mask_gt": amask, "img_weight": jnp.ones(B)}
        tgt["dn"] = jdetr.make_cdn_group(acls, aboxes, amask, NC, jax.random.fold_in(key, 7))
        out, mut = jm.net.apply({"params": unravel(pf), "batch_stats": bstats}, img01,
                                train=True, mutable=["batch_stats"], dn=tgt["dn"])
        return out, tgt, mut["batch_stats"]

    def matches(out, tgt):
        """JAX's cost matrices and matches on JAX's outputs of this step:
        final, aux, encoder."""
        out = jax.lax.stop_gradient(out)
        layers = ([(out["feats"][1], out["feats"][0])]
                  + list(zip(out["aux"][1][:-1], out["aux"][0][:-1]))
                  + [(out["enc_scores"], out["enc_bboxes"])])
        gc, gb, mg = tgt["cls"].astype(jnp.int32).reshape(B, -1), tgt["bboxes"], tgt["mask_gt"]
        costs = jnp.stack([jax.vmap(crit.match_cost)(sc, bx, gc, gb, mg) for sc, bx in layers])
        return costs, jax.vmap(jax.vmap(jdetr.auction_assign))(costs, jnp.broadcast_to(
            mg > 0, costs.shape[:-1]))

    @jax.jit
    def step(state, key):
        """One step, and the matches of its forward (one compiled program)."""
        p_flat, bstats, opt_state, ema, upd = state

        def loss_fn(pf):
            out, tgt, new_bs = forward(pf, bstats, key)
            return crit(out, tgt)[0], (new_bs, matches(out, tgt))

        (loss, (new_bs, match)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p_flat)
        updates, new_opt = tx.update(grads, opt_state, p_flat)
        new_p = p_flat + updates
        upd = upd + 1
        d = 0.9999 * (1 - jnp.exp(-upd / 2000.0))
        return (new_p, new_bs, new_opt, ema * d + (1 - d) * new_p, upd), loss, match

    state = (p_flat, bstats, tx.init(p_flat), jnp.copy(p_flat), jnp.int32(0))
    losses, draws, cols = [], [], []
    for i in range(STEPS):
        key = jax.random.PRNGKey(i)
        m = batch["cls"].shape[1]
        draws.append(jax_draws(jax.random.fold_in(key, 7), B, 2 * max(1, 100 // m) * m, NC))
        state, loss, match = step(state, key)
        cols.append(tuple(np.asarray(a) for a in match))
        losses.append(float(loss))
    p_flat, bstats, _, ema, _ = state

    def as_port(tree, coll):
        return from_jax_variables({(coll, *k): np.asarray(v) for k, v in
                                   traverse_util.flatten_dict(tree).items()})

    return (losses, as_port(unravel_host(params, p_flat), "params"), as_port(bstats, "batch_stats"),
            as_port(unravel_host(params, ema), "params"), draws, cols)


def test_three_rtdetr_train_steps_match_jax(v8_rtdetr, tmp_path, monkeypatch):
    pm, sd, jm, variables = v8_rtdetr
    batch = _train_batch()
    sched = _jax_trainer_build(tmp_path, monkeypatch, 1, **{k: RT_HYP[k] for k in (
        "optimizer", "lr0", "momentum", "weight_decay", "epochs", "batch", "nbs",
        "warmup_epochs")})
    j_losses, j_params, j_stats, j_ema, draws, j_cols = _jax_rtdetr_steps(jm, variables, batch,
                                                                          sched)
    pm.load_state_dict(sd)
    t = trainer.DetectionTrainer(pm, RT_HYP, device="cpu")
    assert t.rtdetr and isinstance(t.criterion, detr_loss.RTDETRDetectionLoss)
    assert isinstance(pm.model[-1], RTDETRDecoder)
    t.setup(nb=1)
    replay = iter(draws)
    monkeypatch.setattr(detr_loss, "cdn_draws", lambda *a, **k: next(replay))
    dev_batch = trainer.batch_to_device(batch, torch.device("cpu"))
    losses, cols = [], []
    for _ in range(STEPS):
        loss, items, updated = t.train_step(dev_batch, mosaic=False)
        assert updated and set(items) >= {"box", "cls", "dfl", "l1", "giou", "dn"}
        assert all(np.isfinite(float(v)) for v in items.values())
        losses.append(float(loss))
        cols.append(t.criterion.last_match.numpy())
    assert t.ema.updates == STEPS
    for (cost, jc), c in zip(j_cols, cols):
        mask = np.broadcast_to(batch["mask_gt"] > 0, cost.shape[:-1])
        assert (detr_loss.auction_assign(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
                == jc).all()
    for (_, jc), c in zip(j_cols[:2], cols[:2]):
        assert (c == jc).all()  # the same matched pairs in every layer
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    now, ema = pm.state_dict(), t.ema_state_dict()
    for n, ref in {**j_params, **j_stats}.items():
        np.testing.assert_allclose(now[n].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4, err_msg=n)
    for n, ref in j_ema.items():
        np.testing.assert_allclose(ema[n].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4, err_msg=n)
    moved = [n for n, r in j_params.items() if not torch.equal(r, sd[n])]
    for part in ("denoising_class_embed", "decoder.layers.0.cross_attn.sampling_offsets",
                 "decoder.layers.5.self_attn.in_proj_weight", "enc_score_head", "model.0."):
        assert any(part in n for n in moved), part
