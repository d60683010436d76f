"""The AMP training forward of the PyTorch port against the JAX package's
amp_cast, on the CPU (moved unchanged from tests/test_torch_engine.py).

- AMP: the bf16 training forward sees every floating parameter rounded to
  bf16, as JAX's amp_cast makes it: train_forward(p) is bitwise
  train_forward(round_bf16(p)). (Before the repair autocast left BatchNorm's
  affine parameters, the wavelet band weights and the quality head
  unrounded, and the two differed.) The bf16 training loss of EdgeLine-YOLO
  at 64 px against JAX's amp_cast forward and DetectionLoss on the same
  weights and targets: rel 2e-2 (two bf16 forwards, each rounding its
  activations to bf16 in its own order). That gap is rounding-order noise
  amplified by train-mode BatchNorm on 2x2 maps, and it cannot see the
  repair: over seeds 0-2 the repaired forward reads 4.1e-3, 4.0e-3, 2.1e-2,
  the autocast-only forward 8.2e-3, 1.9e-3, 2.1e-2 and the f32 forward
  6.4e-3, 3.3e-5, 2.0e-2. What sees it is the same comparison in f32
  compute: the port's `amp_params` against JAX's amp_cast leaves cast back
  to f32, on the same bf16-rounded input. Over seeds 0-3, all parameters
  rounded (amp_params) read loss rel <= 2.7e-6 and output rms <= 4.6e-5;
  the conv weights alone rounded (what autocast rounded before the repair)
  read >= 1.0e-4 and >= 4.3e-2; nothing rounded >= 2.5e-4 and >= 5.4e-2.
  Limits 2e-5 and 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_engine import S, _exercised, _jax_variables

from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.train.loss import DetectionLoss as JDetectionLoss
from edgeyolo_tpu_torch.nn.tasks import amp_params, train_forward
from edgeyolo_tpu_torch.train.loss import DetectionLoss
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)


def _round_bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _targets(b=2, m=6, seed=3):
    rs = np.random.RandomState(seed)
    xy, wh = rs.uniform(0.3, 0.7, (b, m, 2)), rs.uniform(0.2, 0.5, (b, m, 2))
    mask = (np.arange(m)[None] < np.array([[3], [5]])).astype(np.float32)
    return {"cls": rs.randint(0, 3, (b, m)).astype(np.float32),
            "bboxes": (np.concatenate([xy, wh], -1) * mask[..., None]).astype(np.float32),
            "mask_gt": mask}


# -- AMP (ROADMAP C.2) ----------------------------------------------------------------
def test_amp_forward_sees_parameters_rounded_to_bf16():
    m = _exercised(nc=80).train()
    x = torch.rand(2, 3, S, S, generator=torch.Generator().manual_seed(1))
    start = {k: v.clone() for k, v in m.state_dict().items()}
    out = train_forward(m, x, amp=True)
    m.load_state_dict(start)  # the same BatchNorm statistics for the second forward
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(_round_bf16(p))
    again = train_forward(m, x, amp=True)
    for k in ("feats", "quality"):
        for a, b in zip(out[k], again[k]):
            assert a.dtype == torch.float32 and torch.equal(a, b), k


def test_amp_gradients_reach_the_f32_masters():
    m = _exercised().train()
    out = train_forward(m, torch.rand(2, 3, S, S), amp=True)
    sum(f.float().mean() for f in out["feats"] + out["quality"]).backward()
    bn = m.model[0].bn
    assert bn.weight.dtype == torch.float32 and bn.weight.grad is not None
    assert torch.equal(bn.weight.grad, _round_bf16(bn.weight.grad))  # arrives rounded, as in JAX
    assert m.model[-1].reg_conf[0][0].weight.grad.abs().sum() > 0


def test_amp_loss_matches_jax_amp_cast():
    m = _exercised().train()
    jm = _jax_variables(m.state_dict(), nc=3)
    x = np.random.RandomState(2).rand(2, S, S, 3).astype(np.float32)
    tgt = _targets()
    hyp = {"box": 7.5, "cls": 0.5, "dfl": 1.5}

    @jax.jit
    def jloss(v, x, tgt):
        out, _ = jm.apply({"params": jtasks.amp_cast(v["params"]),
                           "batch_stats": v["batch_stats"]}, x.astype(jnp.bfloat16), train=True,
                          mutable=["batch_stats"])
        return JDetectionLoss(jm, hyp=hyp)([f.astype(jnp.float32) for f in out["feats"]],
                                           tgt, [q.astype(jnp.float32) for q in out["quality"]])

    ref, ref_items = jloss(jm.variables, jnp.asarray(x), {k: jnp.asarray(v) for k, v in tgt.items()})
    out = train_forward(m, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), amp=True)
    ptgt = {k: torch.from_numpy(v) for k, v in tgt.items()} | {"img_weight": torch.ones(2)}
    loss, items = DetectionLoss.for_model(m, hyp)(out["feats"], ptgt, out["quality"])
    loss = float(loss.detach())
    rel = abs(loss - float(ref)) / abs(float(ref))
    print(f"bf16 loss port {loss:.6f} JAX {float(ref):.6f} rel {rel:.2e}; items "
          + ", ".join(f"{k} {float(items[k]):.5f}/{float(ref_items[k]):.5f}" for k in items))
    assert rel < 2e-2


def test_amp_parameters_match_jax_amp_cast():
    """f32 compute on each side's AMP parameters, so that only the rounding
    of the parameters differs: amp_params against amp_cast's leaves."""
    m = _exercised().train()
    jm = _jax_variables(m.state_dict(), nc=3)
    x = jnp.asarray(np.random.RandomState(2).rand(2, S, S, 3), jnp.float32)
    x = x.astype(jnp.bfloat16).astype(jnp.float32)  # both forwards take the bf16 input
    tgt = _targets()
    hyp = {"box": 7.5, "cls": 0.5, "dfl": 1.5}

    @jax.jit
    def jrun(v, x, tgt):
        params = jax.tree.map(lambda a: a.astype(jnp.float32), jtasks.amp_cast(v["params"]))
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=True,
                          mutable=["batch_stats"])
        return JDetectionLoss(jm, hyp=hyp)(out["feats"], tgt, out["quality"])[0], out

    ref, ref_out = jrun(jm.variables, x, {k: jnp.asarray(v) for k, v in tgt.items()})
    out = torch.func.functional_call(m, amp_params(m),
                                     (torch.from_numpy(np.array(x)).permute(0, 3, 1, 2),))
    ptgt = {k: torch.from_numpy(v) for k, v in tgt.items()} | {"img_weight": torch.ones(2)}
    loss = float(DetectionLoss.for_model(m, hyp)(out["feats"], ptgt, out["quality"])[0].detach())
    rel = abs(loss - float(ref)) / abs(float(ref))
    got = [f.detach().permute(0, 2, 3, 1).numpy() for f in out["feats"] + out["quality"]]
    want = [np.asarray(a) for a in ref_out["feats"] + ref_out["quality"]]
    rms = np.sqrt(sum(((g - w) ** 2).sum() for g, w in zip(got, want))
                  / sum((w ** 2).sum() for w in want))
    print(f"f32 compute on AMP parameters: loss rel {rel:.2e}, outputs rms rel {rms:.2e}")
    assert rel < 2e-5 and rms < 1e-3
