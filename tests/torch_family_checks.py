"""Checks that the port's model-family test files share: a model YAML of the
PyTorch port held against the JAX package on the CPU in f32.

- `check_copy`: the port's YAML is a byte-identical copy of JAX's.
- `check_scale`: at one scale, the layer specs (with their repeats and a YAML
  `activation:` override), the save list, the strides and the activation
  parse as JAX's; the model builds (through `YOLO(...)` where the scaled name
  resolves to this YAML, else `DetectionModel(yaml, scale=...)`) and counts
  the reference's parameters where tests/test_parse_and_parity.py lists
  them (JAX's own count is held to that list there).
- `build_family`: at scale n or the file's own size, the port model from its
  seeded weights perturbed as in
  tests/test_torch_v13_e2e_families.py (BatchNorm statistics, scales and
  shifts moved, gates opened, conv and linear weights times the model's
  weight SCALE, class logits of both branches spread around 0), carried onto
  the JAX tree with `convert_state_dict` (strict; variables template from
  `jax.eval_shape`) and both models' 64 px preds of two images.
- `check_bridge`: the parameter count is JAX's plus the 16 frozen DFL bins
  JAX does not store; the state_dict back from JAX with `from_jax_variables`,
  equal tensor for tensor, and loading strictly (but for the bins).
- `check_pred`: boxes 5e-3 px and scores 1e-4 (the flagship's tolerances),
  E2E selections matched row by row (`assert_e2e_close`); the output depends
  on the image, and scores are neither saturated nor all on one side of the
  confidence gate.

A weight SCALE is chosen per model as in tests/test_torch_families.py, by a
scan against JAX on the CPU: the largest, in steps of 0.1 or finer, under
which the boxes of the two images differ by more than 1 px and the scores
neither saturate nor leave the tolerance, with the port on one thread and on
eight. The port's side runs on one thread here (`one_torch_thread`).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_parse_and_parity import PARITY
from test_torch_e2e import assert_e2e_close
from test_torch_families import _imgs, _jax_template
from test_torch_v13_e2e_families import _perturbed
from torch_threads import one_torch_thread  # noqa: F401  (its importers' fixture)

from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.utils.torch_convert import convert_state_dict
from edgeyolo_tpu_torch.cfg.models import MODELS_DIR, model_cfg
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.tasks import DetectionModel, num_params
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

REPO = Path(__file__).resolve().parents[1]
S = 64


def scales_of(yaml: str) -> str:
    """Every scale the YAML declares ("" for one without a scales table)."""
    return "".join(model_cfg(yaml).get("scales") or {"": 0})


def jax_spec(yaml: str, scale: str) -> dict:
    d = jtasks.yaml_model_load(yaml)
    if scale:
        d["scale"] = scale
    return d


def check_copy(yaml: str) -> None:
    assert (MODELS_DIR / yaml).read_bytes() == (
        REPO / "edgeyolo_tpu" / "cfg" / "models" / yaml).read_bytes()


def _built(yaml: str, scale: str) -> DetectionModel:
    stem = yaml.removesuffix(".yaml")
    named = f"{stem}{scale}" if scale and not stem.endswith(scale) else stem
    try:
        resolves = model_cfg(named)["scale"] == scale and (
            (MODELS_DIR / f"{named}.yaml").is_file() == (named == stem))
    except KeyError:
        resolves = False
    if resolves:  # the name a user types, through the facade
        return YOLO(named, device="cpu").model
    return DetectionModel(yaml, scale=scale or None, device="cpu")


def check_scale(yaml: str, scale: str) -> DetectionModel:
    jd = jax_spec(yaml, scale)
    jlayers, jsave, jinfo = jtasks.parse_spec(jd)
    layers, save, info = tasks.parse_spec(model_cfg(yaml, scale or None))
    assert info["scale"] == jinfo["scale"] and save == jsave and info["act"] == jinfo["act"]
    assert [(s.i, s.f, s.n, s.name, s.args, s.kwargs, s.c2) for s in layers] == \
        [(s.i, s.f, s.n, s.name, s.args, s.kwargs, s.c2) for s in jlayers]
    assert tasks.derive_strides(layers) == jtasks.derive_strides(jlayers)
    pm = _built(yaml, scale)
    assert (pm.cfg, pm.scale) in ((yaml, scale), (yaml.removesuffix(".yaml") + scale, scale),
                                  (yaml.removesuffix(".yaml"), scale))
    listed = PARITY.get((yaml.removesuffix(".yaml"), scale))
    assert listed is None or num_params(pm) == listed
    assert pm.end2end == (jlayers[-1].name in {"v10Detect", "E2EDetect", "GFLHeadv2_E2E"})
    return pm


def to_jax(pm: DetectionModel, sd: dict, template: dict):
    """convert_state_dict of the port's state_dict onto the JAX tree (strict),
    1-D conv kernels handed over transposed (ROADMAP section C.7: JAX's
    converter would reshape them)."""
    conv1d = {f"{n}.weight" for n, m in pm.named_modules() if isinstance(m, torch.nn.Conv1d)}
    arrays = {k: v.numpy().transpose(2, 1, 0) if k in conv1d else v.numpy()
              for k, v in sd.items()}
    return convert_state_dict(arrays, template, strict=True)


def build_family(yaml: str, scale: str, weight_scale: float) -> dict:
    pm = DetectionModel(yaml, scale=scale or None, device="cpu")
    sd = _perturbed(pm.state_dict(), weight_scale)
    pm.load_state_dict(sd)
    jm = jtasks.DetectionModel(jax_spec(yaml, scale))
    template = _jax_template(jm)
    variables, rep = to_jax(pm, sd, template)
    imgs = _imgs()
    apply = jax.jit(lambda v, x: jm.net.apply(v, x, train=False)["pred"])
    jpred = np.asarray(apply(jax.tree.map(jnp.asarray, variables),
                             jnp.asarray(imgs, jnp.float32) / 255.0))
    with torch.no_grad():
        pred = pm(torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255)["pred"].numpy()
    return {"yaml": yaml, "scale": scale, "pm": pm, "sd": sd, "template": template,
            "variables": variables, "report": rep, "pred": pred, "jpred": jpred}


def check_bridge(fam: dict) -> None:
    sd, rep, pm = fam["sd"], fam["report"], fam["pm"]
    assert num_params(pm) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(fam["template"]["params"])) + 16
    head = len(pm.model) - 1
    assert rep["unused"] == [f"model.{head}.dfl.conv.weight"] and not rep["missing"]
    assert rep["matched"] == len(jax.tree.leaves(fam["template"]))
    back = from_jax_variables(traverse_util.flatten_dict(fam["variables"]))
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")} - set(
        rep["unused"])
    assert all(torch.equal(back[k], sd[k]) for k in back)
    missing, unexpected = pm.load_state_dict(back, strict=False)  # the same tensors again
    assert missing == rep["unused"] and not unexpected


def check_pred(fam: dict, min_spread: float = 1.0) -> None:
    """The 64 px preds match; the boxes of the two images differ by more than
    `min_spread` px somewhere (the output depends on the image)."""
    pred, jpred, pm = fam["pred"], fam["jpred"], fam["pm"]
    anchors = sum((S // s) ** 2 for s in pm.model[-1].stride)
    if pm.end2end:
        assert pred.shape == jpred.shape == (2, min(300, anchors), 6)
        assert_e2e_close(pred, jpred, box_atol=5e-3, score_atol=1e-4)
        assert 0.01 < pred[..., 4].min() and pred[..., 4].max() < 0.99
        assert len(np.unique(pred[..., 5])) > 1
    else:
        assert pred.shape == jpred.shape == (2, anchors, 4 + pm.nc)
        d = np.abs(pred - jpred)
        assert d[..., :4].max() < 5e-3, d[..., :4].max()
        assert d[..., 4:].max() < 1e-4, d[..., 4:].max()
        assert (pred[..., 4:] > 0.25).any() and (pred[..., 4:] < 0.25).any()
    assert np.abs(pred[0, :, :4] - pred[1, :, :4]).max() > min_spread
