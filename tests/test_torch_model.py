"""The PyTorch port's flagship model and serving step against the JAX package.

EdgeLine-YOLO-n (edgeline-yolo.yaml, scale n) at 64 px, batch 2, f32 on the
CPU. The JAX variables are perturbed so that every branch counts (BatchNorm
statistics, the wavelet gammas, conv kernels scaled so activations stay O(1)
through the depth and the output depends on the image, class logits around 0
so scores straddle the confidence gate) and carried into the port with
`from_jax_variables`.

Tolerances: `pred` boxes 5e-3 px and scores 1e-4, the flagship tolerance of
tests/test_torch_parity.py (f32 on both sides; 24 layers of convolutions
summed in different orders). Detections after NMS of one prediction: 1e-5.

Also here: the spec literal against the JAX YAML parse at every scale, the
rule that entry points run on CUDA unless told otherwise, and the rule that
the port imports neither JAX nor the JAX package.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.ops.nms import non_max_suppression as jax_nms
from edgeyolo_tpu.utils.torch_convert import convert_state_dict
from edgeyolo_tpu_torch.cfg.models import model_cfg
from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.tasks import DetectionModel, num_params
from edgeyolo_tpu_torch.ops.nms import non_max_suppression
from edgeyolo_tpu_torch.utils.convert import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "edgeyolo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "yaml", "PIL", "cv2", "edgeyolo_tpu", "onnx",
             "onnxscript")
IMGSZ = 64
DFL_KEY = "model.23.dfl.conv.weight"  # the reference's frozen DFL bins; JAX computes them


def _perturb(flat, seed=0):
    rs = np.random.RandomState(seed)
    out = {}
    for k, a in flat.items():
        a = np.asarray(a)
        if k[-1] == "gamma":
            a = np.float32(rs.uniform(0.3, 0.8))
        elif k[-1] == "mean":
            a = (rs.randn(*a.shape) * 0.1).astype(np.float32)
        elif k[-1] == "var":
            a = rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k[1].endswith("GFLHeadv2_uniH") and k[2] in ("cv3_0_2", "cv3_1_2", "cv3_2_2"):
            a = (rs.randn(*a.shape) * 0.5).astype(np.float32)  # class logits spread around 0
        elif k[0] == "params" and k[-1] in ("scale", "bias"):
            a = (a + rs.randn(*a.shape) * 0.1).astype(np.float32)
        elif k[-1] == "kernel":  # keep activations O(1) through the depth
            a = a * np.float32(2.5)
        out[k] = a
    return out


@pytest.fixture(scope="module")
def flagship():
    jm = jtasks.DetectionModel("edgeline-yolo.yaml")
    jm.init(0, imgsz=IMGSZ)
    flat = _perturb(traverse_util.flatten_dict(jax.device_get(jm.variables)))
    variables = traverse_util.unflatten_dict(flat)
    pm = DetectionModel("edgeline-yolo.yaml", device="cpu")
    missing, unexpected = pm.load_state_dict(from_jax_variables(flat), strict=False)
    assert missing == [DFL_KEY] and unexpected == []
    imgs = np.random.RandomState(1).randint(0, 256, (2, IMGSZ, IMGSZ, 3)).astype(np.uint8)
    jpred = np.array(jax.jit(lambda v, x: jm.apply(v, x, train=False)["pred"])(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(imgs, jnp.float32) / 255.0))
    return jm, variables, pm, imgs, jpred


def test_param_count_is_the_reference_count(flagship):
    jm, _, pm, _, _ = flagship
    assert num_params(pm) == 2_678_699
    assert num_params(pm) == jm.num_params() + 16  # JAX stores no frozen DFL bins


def test_pred_matches_jax(flagship):
    _, _, pm, imgs, jpred = flagship
    with torch.no_grad():
        x = torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255
        pred = pm(x)["pred"].numpy()
    assert pred.shape == jpred.shape == (2, 84, 84)
    d = np.abs(pred - jpred)
    assert d[..., :4].max() < 5e-3, d[..., :4].max()
    assert d[..., 4:].max() < 1e-4, d[..., 4:].max()


def test_state_dict_bridges_to_jax_tree(flagship):
    _, variables, pm, _, _ = flagship
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    _, rep = convert_state_dict(sd, variables, strict=True)
    assert rep["unused"] == [DFL_KEY]
    assert rep["matched"] == len(jax.tree.leaves(variables))


def _jax_serve_nms(pred, max_det=300, max_nms=1024, imgsz=IMGSZ):
    det, n = jax_nms(jnp.asarray(pred), conf_thres=0.25, iou_thres=0.7, max_det=max_det,
                     max_nms=max_nms, multi_label=False)
    det = np.asarray(det).copy()
    det[..., 0:4] = np.clip(det[..., 0:4], 0, imgsz)  # the JAX postprocess clip
    return det, np.asarray(n)


def test_predictor_matches_jax_nms(flagship):
    """The served (det, n) equal the JAX NMS (plus its postprocess clip) of the
    same prediction. NMS is discontinuous in its input: random weights leave
    score gaps of ~1e-5 between candidates, inside the pred tolerance, so the
    two frameworks' preds are compared above and their NMS on one pred here."""
    _, _, pm, imgs, jpred = flagship
    det, n = DetectionPredictor(pm, device="cpu")(imgs)
    with torch.no_grad():
        x = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous().float() / 255
        pred = pm(x)["pred"].numpy()
    jdet, jn = _jax_serve_nms(pred)
    np.testing.assert_array_equal(n.numpy(), jn)
    assert int(n.min()) > 0
    np.testing.assert_allclose(det.numpy(), jdet, atol=1e-5)


def test_predictor_default_max_nms_keeps_what_jax_keeps(flagship):
    """At 320 px all 2100 anchors pass the gate. With max_det above the
    survivor count, the served (det, n) at the predictor's default max_nms
    equal the JAX NMS at its predictor default (max_nms=8192); a cap of 1024
    would drop survivors that JAX keeps."""
    _, _, pm, _, _ = flagship
    imgsz, anchors = 320, 2100
    imgs = np.random.RandomState(3).randint(0, 256, (1, imgsz, imgsz, 3)).astype(np.uint8)
    det, n = DetectionPredictor(pm, max_det=anchors, device="cpu")(imgs)
    with torch.no_grad():
        x = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous().float() / 255
        pred = pm(x)["pred"].numpy()
    assert pred.shape[1] == anchors and int((pred[..., 4:].max(-1) > 0.25).sum()) > 1024
    jdet, jn = _jax_serve_nms(pred, max_det=anchors, max_nms=8192, imgsz=imgsz)
    _, n_capped = non_max_suppression(torch.from_numpy(pred), conf_thres=0.25, iou_thres=0.7,
                                      max_det=anchors, max_nms=1024)
    assert not np.array_equal(n_capped.numpy(), jn)  # a cap of 1024 keeps fewer
    np.testing.assert_array_equal(n.numpy(), jn)
    np.testing.assert_allclose(det.numpy(), jdet, atol=1e-5)


def test_nms_on_the_jax_pred_matches_jax(flagship):
    *_, jpred = flagship
    det, n = non_max_suppression(torch.from_numpy(jpred), conf_thres=0.25, iou_thres=0.7,
                                 max_det=300, max_nms=1024)
    det[..., 0:4] = det[..., 0:4].clamp(0, IMGSZ)
    jdet, jn = _jax_serve_nms(jpred)
    np.testing.assert_array_equal(n.numpy(), jn)
    np.testing.assert_allclose(det.numpy(), jdet, atol=1e-5)


def test_bf16_model_keeps_bf16_activations(flagship):
    _, _, pm, imgs, _ = flagship
    m = DetectionModel("edgeline-yolo.yaml", device="cpu", dtype=torch.bfloat16)
    m.load_state_dict(pm.state_dict())
    dtypes = []
    hooks = [c.register_forward_hook(lambda _m, _i, o: dtypes.append(o.dtype))
             for c in m.modules() if isinstance(c, torch.nn.Conv2d)]
    det, n = DetectionPredictor(m, device="cpu")(imgs)
    for h in hooks:
        h.remove()
    # every conv but the quality head's two per level (an f32 island, as in JAX)
    assert dtypes.count(torch.float32) == 6 and dtypes.count(torch.bfloat16) == len(dtypes) - 6
    assert det.dtype == torch.float32 and bool(torch.isfinite(det).all())
    assert bool(((n >= 0) & (n <= 300)).all())


@pytest.mark.parametrize("scale", list("nslmx"))
def test_spec_literal_parses_like_the_jax_yaml(scale):
    jd = jtasks.yaml_model_load("edgeline-yolo.yaml")
    jd["scale"] = scale
    jlayers, jsave, _ = jtasks.parse_spec(jd)
    layers, save, info = tasks.parse_spec(model_cfg("edgeline-yolo.yaml", scale))
    assert info["scale"] == scale and save == jsave
    assert [(s.i, s.f, s.name, s.args, s.kwargs, s.c2) for s in layers] == \
        [(s.i, s.f, s.name, s.args, s.kwargs, s.c2) for s in jlayers]
    assert tasks.derive_strides(layers) == jtasks.derive_strides(jlayers)


def test_model_names_resolve_the_scale():
    assert model_cfg("edgeline-yolo.yaml")["scale"] == "n"
    assert model_cfg("edgeline-yolo-s")["scale"] == "s"
    assert model_cfg("edgeline-yolom.yaml")["scale"] == "m"
    assert model_cfg("edgeline-yolo.yaml", scale="x")["scale"] == "x"
    with pytest.raises(ValueError):
        model_cfg("edgeline-yolo-n", scale="s")
    assert model_cfg("yolov8s-worldv2")["scale"] == "s"  # the last family the port took in
    with pytest.raises(KeyError):
        model_cfg("yolov8-nonexistent.yaml")  # a name no YAML of the package has


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionModel("edgeline-yolo-n")
    m = DetectionModel("edgeline-yolo-n", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionPredictor(m)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax_or_reference():
    code = ("import pkgutil, sys, edgeyolo_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'edgeyolo_tpu_torch.'):\n"
            "    __import__(m.name)\n"
            f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run in full")
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0 and '"ok"' not in r.stdout
