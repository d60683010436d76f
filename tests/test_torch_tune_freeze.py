"""Training with `freeze`, AutoBatch, profiling and the tuner of the port
against the JAX package, on the CPU.

- `freeze=4`: two yolo11n steps at 64 px (SGD, accumulation 1, so two real
  updates) from the same weights, augmentation off, against JAX's step math
  with its freeze mask (edgeyolo_tpu/train/trainer.py: the gradient and the
  update of every `l{i}_*` leaf, i < 4, times 0): losses at rel 1e-4, params
  and BatchNorm statistics at abs 1e-5 plus rel 1e-4 (the step tolerances of
  tests/test_torch_train.py); the frozen params equal to the start to the
  bit on both sides, their BatchNorm statistics moved, the port's EMA of
  them equal to the start to the bit.
- AutoBatch: the port's choice equals JAX's for the same scripted peaks
  (both `memory_analysis` functions replaced), an out-of-memory stop and
  none fitting included; the trainer resolves batch=-1 and batch=0.7, and
  on the CPU batch=-1 raises naming `batch=`.
- The tuner: `_mutate` equals JAX's from the same seeded generator; the CSV
  rows (but their times), a resume and the best hyperparameters equal JAX's
  under one stub model factory; the facade's `tune` runs end to end.
- `cost_analysis` equals the analytic count for one conv and one linear.
"""

import csv
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
import yaml
from flax import traverse_util
from jax.flatten_util import ravel_pytree

from edgeyolo_tpu.data.augment_device import augment_batch as jaugment
from edgeyolo_tpu.engine import tuner as jtuner
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.train import trainer as jtrainer
from edgeyolo_tpu.train.loss import DetectionLoss as JDetectionLoss
from edgeyolo_tpu.utils import profiling as jprof
from edgeyolo_tpu_torch.cfg import DEFAULT_CFG_DICT
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine import tuner
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.train import trainer
from edgeyolo_tpu_torch.utils import profiling
from edgeyolo_tpu_torch.utils.convert import from_jax_variables
from edgeyolo_tpu_torch.utils.yamlfile import yaml_load
from jax_host import flat_decay_mask, unravel_host
from test_torch_families import _jax_template
from test_torch_train import AUG_OFF, _batch, _jax_trainer_build, build_optimizer
from torch_family_checks import to_jax
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

S, B = 64, 2
FROZEN = 4
HYP = {**AUG_OFF, "optimizer": "SGD", "lr0": 0.01, "momentum": 0.937, "weight_decay": 5e-4,
       "batch": B, "nbs": 2, "epochs": 3, "warmup_epochs": 3.0, "amp": False}
STEPS = 2


def _start():
    """yolo11n's seeded weights with its BatchNorm statistics spread, as both
    packages' variables."""
    pm = DetectionModel("yolo11n.yaml", device="cpu")
    rs = np.random.RandomState(0)
    sd = {k: (torch.from_numpy((rs.randn(*v.shape) * 0.1).astype(np.float32))
              if k.endswith("running_mean") else
              torch.from_numpy(rs.uniform(0.5, 1.5, v.shape).astype(np.float32))
              if k.endswith("running_var") else v) for k, v in pm.state_dict().items()}
    jm = jtasks.DetectionModel("yolo11n.yaml")
    variables, _ = to_jax(pm, sd, _jax_template(jm))
    return jm, sd, variables


def _jax_freeze_steps(jm, variables, batch, sched):
    """JAX's train step with its freeze mask, f32, one device."""
    params, bstats = variables["params"], variables["batch_stats"]
    params = jax.tree.map(jnp.asarray, params)
    bstats = jax.tree.map(jnp.asarray, bstats)
    p_flat, unravel = ravel_pytree(params)
    mask_flat = flat_decay_mask(params, jtrainer._decay_mask(params))
    # the trainer's freeze_flat: 0 on every leaf under a top scope l{i}_ with i < FROZEN
    freeze_flat = jnp.asarray(np.concatenate([
        np.full(np.size(leaf), 0.0 if int(path[0].key[1:].split("_")[0]) < FROZEN else 1.0,
                np.float32)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]]))
    decay = HYP["weight_decay"] * B / HYP["nbs"]
    tx = optax.MultiSteps(build_optimizer(
        p_flat, "SGD", HYP["lr0"], HYP["momentum"], decay, sched["lr_at"],
        momentum_schedule=sched["momentum_at"], flat_mask=mask_flat), every_k_schedule=1)
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
            loss, _ = crit(out["feats"], tgt, out.get("quality"))
            return loss, mut["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(p_flat)
        grads = grads * freeze_flat
        updates, new_opt = tx.update(grads, opt_state, p_flat)
        new_p = p_flat + updates * freeze_flat
        upd = upd_count + 1
        d = 0.9999 * (1 - jnp.exp(-upd / 2000.0))
        return (new_p, new_bs, new_opt, ema * d + (1 - d) * new_p, upd), loss

    state = (p_flat, bstats, tx.init(p_flat), jnp.copy(p_flat), jnp.int32(0))
    losses = []
    for i in range(STEPS):
        state, loss = step(state, jax.random.PRNGKey(i))
        losses.append(float(loss))
    p_flat, bstats = state[0], state[1]

    def as_port(tree, coll):
        return from_jax_variables({(coll, *k): np.asarray(v) for k, v in
                                   traverse_util.flatten_dict(tree).items()})

    return losses, as_port(unravel_host(params, p_flat), "params"), as_port(bstats, "batch_stats")


def _frozen(name: str) -> bool:
    return int(name.split(".")[1]) < FROZEN


def test_freeze_steps_match_jax(tmp_path, monkeypatch):
    """`freeze` was ignored before: every layer trained."""
    jm, sd, variables = _start()
    batch = _batch()
    sched = _jax_trainer_build(tmp_path, monkeypatch, 1, freeze=FROZEN, **{k: HYP[k] for k in (
        "optimizer", "lr0", "momentum", "weight_decay", "epochs", "batch", "nbs",
        "warmup_epochs")})
    j_losses, j_params, j_stats = _jax_freeze_steps(jm, variables, batch, sched)

    pm = DetectionModel("yolo11n.yaml", device="cpu")
    pm.load_state_dict(sd)
    t = trainer.DetectionTrainer(pm, {**HYP, "freeze": FROZEN}, device="cpu")
    t.setup(nb=1)
    assert t.accumulate == 1
    held = [n for n in t.flat.slices if _frozen(n)]
    assert int((t.keep == 0).sum()) == sum(t.flat.slices[n].stop - t.flat.slices[n].start
                                           for n in held) > 0
    dev_batch = trainer.batch_to_device(batch, torch.device("cpu"))
    losses = [float(t.train_step(dev_batch, mosaic=False)[0]) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    now, ema = pm.state_dict(), t.ema_state_dict()
    for name, ref in {**j_params, **j_stats}.items():
        np.testing.assert_allclose(now[name].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    for name in held:
        assert torch.equal(now[name], sd[name]) and torch.equal(j_params[name], sd[name]), name
        assert torch.equal(ema[name], sd[name]), name
    stats = [n for n in j_stats if _frozen(n) and n.endswith("running_var")]
    assert stats and all(not torch.equal(now[n], sd[n]) for n in stats)
    moved = [n for n in j_params if not _frozen(n) and not torch.equal(now[n], sd[n])]
    assert len(moved) > 100


def test_a_list_freezes_those_layers():
    t = trainer.DetectionTrainer(DetectionModel("yolo11n.yaml", device="cpu"),
                                 {"freeze": [0, 2], "batch": 2}, device="cpu")
    t.setup(nb=1)
    for name, sl in t.flat.slices.items():
        assert bool((t.keep[sl] == 0).all()) == (name.split(".")[1] in ("0", "2")), name


# (candidate peaks in units of 1e9 bytes, total bytes, fraction): scripted measurements
PEAK_CASES = {
    "fits-to-8": ({1: 1.0, 2: 2.0, 4: 4.0, 8: 8.0, 16: 16.0, 32: 32.0, 64: 64.0}, 20e9, 0.6),
    "half-fraction": ({1: 1.0, 2: 2.0, 4: 4.0, 8: 8.0, 16: 16.0, 32: 32.0, 64: 64.0}, 20e9, 0.3),
    "oom-at-8": ({1: 1.0, 2: 2.0, 4: 4.0, 8: "oom", 16: 16.0, 32: 32.0, 64: 64.0}, 80e9, 0.6),
    "all-fit": ({b: 0.1 * b for b in (1, 2, 4, 8, 16, 32, 64)}, 80e9, 0.6),
    "none-fits": ({b: 5.0 * b for b in (1, 2, 4, 8, 16, 32, 64)}, 4e9, 0.6),
    "no-analysis": ({b: 0.0 for b in (1, 2, 4, 8, 16, 32, 64)}, 80e9, 0.6),
}


def _scripted(peaks, oom):
    def memory_analysis(fn, *args):
        p = peaks[int(args[-1].shape[0])]
        if p == "oom":
            raise oom("CUDA out of memory. Tried to allocate 2.00 GiB")
        return {"peak_bytes": int(p * 1e9)} if p else {}
    return memory_analysis


def _choice(fn):
    try:
        return fn()
    except RuntimeError as e:
        assert "batch=" in str(e)
        return "raised"


@pytest.mark.parametrize("case", list(PEAK_CASES))
def test_autobatch_chooses_as_jax(case, monkeypatch):
    peaks, total, fraction = PEAK_CASES[case]
    monkeypatch.setattr(jprof, "memory_analysis", _scripted(peaks, RuntimeError))
    monkeypatch.setattr(profiling, "memory_analysis", _scripted(peaks, torch.cuda.OutOfMemoryError))
    jm = SimpleNamespace(variables={"params": {"w": jnp.zeros(2)}}, net=None)
    pm = DetectionModel("yolo11n.yaml", device="cpu")
    seen = {}
    ours = _choice(lambda: profiling.autobatch(pm, imgsz=S, fraction=fraction, total_bytes=total,
                                               train=True, peaks=seen))
    theirs = _choice(lambda: jprof.autobatch(jm, imgsz=S, fraction=fraction, hbm_bytes=total,
                                             train=True))
    assert ours == theirs
    assert set(seen) <= set(peaks)


@pytest.mark.parametrize("batch,want", [(-1, 4), (0.7, 8)])
def test_trainer_resolves_autobatch(batch, want, monkeypatch):
    """batch=-1 gave a negative weight decay and batch=0.7 divided by zero."""
    peaks = {b: 1.6 * b for b in (1, 2, 4, 8, 16, 32, 64)}  # budget 12e9 at 0.6, 14e9 at 0.7
    monkeypatch.setattr(profiling, "memory_analysis", _scripted(peaks, None))
    real = profiling.autobatch
    monkeypatch.setattr(profiling, "autobatch",
                        lambda *a, **k: real(*a, **k, total_bytes=int(20e9)))
    t = trainer.DetectionTrainer(DetectionModel("yolo11n.yaml", device="cpu"),
                                 {"batch": batch, "imgsz": S, "nbs": 64}, device="cpu")
    t.setup(nb=1)
    assert t.args["batch"] == want and t.accumulate == round(64 / want)
    assert t.decay == pytest.approx(5e-4 * want * t.accumulate / 64) and t.decay > 0


def test_autobatch_on_the_cpu_asks_for_a_batch():
    t = trainer.DetectionTrainer(DetectionModel("yolo11n.yaml", device="cpu"),
                                 {"batch": -1, "imgsz": S}, device="cpu")
    with pytest.raises(RuntimeError, match="batch="):
        t.setup(nb=1)


def test_mutate_matches_jax(tmp_path, monkeypatch):
    g = np.random.default_rng(7)
    monkeypatch.setattr(np.random, "default_rng", lambda *a, **k: g)
    jt = jtuner.Tuner(dict(DEFAULT_CFG_DICT), save_dir=tmp_path / "j")
    ours = tuner.Tuner(dict(DEFAULT_CFG_DICT), save_dir=tmp_path / "p",
                       rng=np.random.Generator(np.random.PCG64(7)))
    assert list(ours.space) == list(jt.space) and len(ours.space) == 23
    parent = {k: float(DEFAULT_CFG_DICT.get(k, (b[0] + b[1]) / 2)) for k, b in ours.space.items()}
    for _ in range(5):
        a, b = ours._mutate(parent), jt._mutate(parent)
        assert a == b
        parent = a


class _Stub:
    """A model handle whose fit scores its hyperparameters."""

    def train(self, **kw):
        assert kw["epochs"] == 1
        return kw["lr0"] * 10 + kw["box"] / 20 - kw["mosaic"] / 7


def _run(cls, save_dir, iterations, **kw):
    return cls(dict(DEFAULT_CFG_DICT), save_dir=save_dir, **kw)(_Stub, iterations=iterations,
                                                                epochs=1)


def _rows(path):
    with open(path, newline="") as f:
        return [{k: v for k, v in r.items() if k != "time_s"} for r in csv.DictReader(f)]


def test_tuner_rows_resume_and_best_match_jax(tmp_path, monkeypatch):
    g = np.random.default_rng(3)  # JAX draws a new default_rng per mutation: hand it one stream
    monkeypatch.setattr(np.random, "default_rng", lambda *a, **k: g)
    rng = np.random.Generator(np.random.PCG64(3))
    for n in (2, 4):  # two iterations, then a resume to four
        assert _run(tuner.Tuner, tmp_path / "p", n, rng=rng) == _run(jtuner.Tuner,
                                                                     tmp_path / "j", n)
        rows = _rows(tmp_path / "p" / "tune_results.csv")
        assert rows == _rows(tmp_path / "j" / "tune_results.csv") and len(rows) == n
    ours = (tmp_path / "p" / "best_hyperparameters.yaml").read_text()
    theirs = (tmp_path / "j" / "best_hyperparameters.yaml").read_text()
    assert ours.splitlines()[0] == theirs.splitlines()[0]
    assert yaml_load(tmp_path / "p" / "best_hyperparameters.yaml") == yaml.safe_load(theirs)


def test_facade_tune_runs_fresh_fits(tmp_path):
    data = generate_dataset(tmp_path / "ds", n_train=2, n_val=2, imgsz=S, seed=0)
    y = YOLO("yolo11n.yaml", device="cpu")
    best, fitness = y.tune(iterations=2, rng=np.random.default_rng(0), data=str(data), epochs=1,
                           imgsz=S, batch=2, nbs=2, project=str(tmp_path / "r"), plots=False,
                           amp=False)
    rows = _rows(tmp_path / "r" / "tune" / "tune_results.csv")
    assert len(rows) == 2 and set(best) == set(tuner.DEFAULT_SPACE)
    assert (tmp_path / "r" / "tune" / "best_hyperparameters.yaml").exists()
    assert not y.trained and y.model.nc == 80  # the handle's own model is not trained


def test_cost_analysis_counts_a_conv_and_a_linear():
    x = torch.randn(2, 8, 10, 12)
    w, b = torch.randn(16, 4, 3, 3), torch.randn(16)
    c = profiling.cost_analysis(lambda a: F.conv2d(a, w, b, 2, 1, 1, 2), x)
    assert c["flops"] == 2 * (2 * 16 * 5 * 6) * (4 * 3 * 3)
    assert c["bytes_accessed"] >= 4 * (x.numel() + w.numel() + b.numel() + 2 * 16 * 5 * 6)
    lw, lb = torch.randn(3, 5), torch.randn(3)
    c = profiling.cost_analysis(lambda a: torch.sigmoid(F.linear(a, lw, lb)), torch.randn(7, 5))
    assert c["flops"] == 2 * 7 * 5 * 3 and c["transcendentals"] == 7 * 3


def test_memory_analysis_trace_and_stage_timer_on_the_cpu(tmp_path):
    assert profiling.memory_analysis(lambda a: a * 2, torch.ones(3)) == {}
    with profiling.trace(tmp_path / "prof"):
        torch.ones(4).exp()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    timer = profiling.StageTimer("cpu")
    for _ in range(2):
        with timer("step"):
            torch.ones(4).sum()
    assert timer.counts == {"step": 2} and timer.speeds_ms()["step"] >= 0
