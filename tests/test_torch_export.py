"""Export and AutoBackend of the PyTorch port against the JAX package.

For each model the export slice holds (the flagship EdgeLine-YOLO-n, yolov8n,
yolo11n, yolov13-dsc3k2-msla-n, yolov10n and yolo11n-seg, -pose, -obb and
-cls), at 64 px on the CPU, with the port's seeded weights perturbed as the
family tests perturb them (tests/torch_family_checks.py; the cls model's
kernels x1.5 as in tests/test_torch_classify.py) and carried onto JAX's tree:

- the `.pt2` (torch.export, symbolic batch) reloads through AutoBackend and
  serves batch 1 and batch 3 equal to the live fused model within 1e-6 of the
  box scale (the same ATen ops on the same weights; only where the compiler
  of the eager and the exported graph orders a sum apart); the flagship's and
  MSLA-n's programs hold the registered linear-attention op;
- JAX's own npz (its Exporter, JAX's fused variables under flax paths) loads
  through the port's AutoBackend and serves equal to JAX's live pred: boxes
  5e-3 px and scores 1e-4 (the family tolerances);
- where JAX's exporter raises for a model and format, the port raises too
  (the cls model's forward has no `pred`: both raise TypeError for the native
  and ONNX formats; yolov10n's top-k selection and MSLA's average pool have no
  ONNX lowering in either bridge);
- the register_fake output strides equal the kernel plan's for both layouts;
- the TF family, pb, tfjs, edgetpu and unknown formats raise as JAX's do; the
  caller's model stays unfused.
"""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_classify import _filled
from test_torch_e2e import assert_e2e_close
from test_torch_families import _imgs, _jax_template
from test_torch_v13_e2e_families import _perturbed
from torch_family_checks import jax_spec, to_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

from edgeyolo_tpu.cfg import get_cfg as jax_get_cfg
from edgeyolo_tpu.export.exporter import Exporter as JaxExporter
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.export.exporter import Exporter, format_available
from edgeyolo_tpu_torch.nn.autobackend import AutoBackend
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.ops import linear_attention as la
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

S = 64
# port name: (JAX YAML, scale, weight SCALE of its family tests)
MODELS = {"edgeline-yolo-n": ("edgeline-yolo.yaml", "n", 2.4),
          "yolov8n": ("yolov8.yaml", "n", 2.5),
          "yolo11n": ("yolo11.yaml", "n", 2.5),
          "yolov13-dsc3k2-msla-n": ("yolov13-dsc3k2-msla.yaml", "n", 1.8),
          "yolov10n": ("yolov10n.yaml", "", 2.0),
          "yolo11n-seg": ("yolo11-seg.yaml", "n", 2.0),
          "yolo11n-pose": ("yolo11-pose.yaml", "n", 2.0),
          "yolo11n-obb": ("yolo11-obb.yaml", "n", 2.0),
          "yolo11n-cls": ("yolo11-cls.yaml", "n", 1.5)}
ATTENTION = {"edgeline-yolo-n", "yolov13-dsc3k2-msla-n"}
# (model, format) -> the exception both exporters raise
RAISES = {("yolo11n-cls", "torch_export"): TypeError, ("yolo11n-cls", "onnx"): TypeError,
          ("yolov10n", "onnx"): NotImplementedError,
          ("yolov13-dsc3k2-msla-n", "onnx"): NotImplementedError}
JAX_FORMAT = {"torch_export": "jax_export", "onnx": "onnx"}
NATIVE_FORMATS = ("torch_export", "stablehlo", "jax_export")  # one .pt2 under three names
JAX_MODEL = {"detect": jtasks.DetectionModel, "segment": jtasks.SegmentationModel,
             "pose": jtasks.PoseModel, "obb": jtasks.OBBModel}


def _args(fmt, **kw):
    return get_cfg(overrides={"mode": "export", "format": fmt, "imgsz": S, **kw})


def _jax_args(fmt):
    return jax_get_cfg(overrides={"mode": "export", "format": fmt, "imgsz": S})


_HELD = {}


@pytest.fixture
def held(request, tmp_path_factory):
    """The port model (perturbed, unfused), JAX's model of its task carrying
    its weights, and JAX's live pred of two 64 px images: built once a model
    for the module (the tests take them in different subsets)."""
    name = request.param
    if name not in _HELD:
        _HELD[name] = _build(name, tmp_path_factory.mktemp(name))
    return _HELD[name]


def _build(name, out):
    yaml, scale, weight_scale = MODELS[name]
    pm = DetectionModel(yaml, scale=scale or None, device="cpu")
    imgs = _imgs()
    x = jnp.asarray(imgs, jnp.float32) / 255.0
    if pm.task == "classify":
        jm = jtasks.ClassificationModel(jax_spec(yaml, scale))
        template = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), x, train=False))
        flat = _filled(template, weight_scale)
        pm.load_state_dict(from_jax_variables(flat), strict=False)
        variables = traverse_util.unflatten_dict(flat)
        jpred = np.asarray(jax.jit(lambda v, a: jm.net.apply(v, a, train=False))(variables, x))
    else:
        sd = _perturbed(pm.state_dict(), weight_scale)
        pm.load_state_dict(sd)
        jm = JAX_MODEL[pm.task](jax_spec(yaml, scale))
        variables, _ = to_jax(pm, sd, _jax_template(jm))
        variables = jax.tree.map(jnp.asarray, variables)
        jpred = np.asarray(jax.jit(lambda v, a: jm.net.apply(v, a, train=False)["pred"])(
            variables, x))
    jm.variables = variables
    return {"name": name, "pm": pm, "jm": jm, "imgs": imgs, "jpred": jpred, "out": out}


@pytest.mark.parametrize("held", [m for m in MODELS if (m, "torch_export") not in RAISES],
                         indirect=True)
def test_pt2_reloads_and_serves_any_batch(held):
    """The three names of the native format take turns over the models."""
    name, pm, out = held["name"], held["pm"], held["out"]
    fmt = NATIVE_FORMATS[list(MODELS).index(name) % 3]
    path = Exporter(_args(fmt))(pm, out_dir=out / "pt2")
    assert path.endswith(".aten" if fmt == "stablehlo" else ".pt2")
    if fmt == "stablehlo":  # the printed ATen graph beside its .pt2 twin
        assert open(path).read().startswith("ExportedProgram")
    assert not pm.fused  # the caller's model stays unfused
    ab = AutoBackend(path, device="cpu")
    assert ab.kind == "torch_export" and ab.imgsz == S and ab.task == pm.task
    live = copy.deepcopy(pm).fuse().eval()
    x = torch.from_numpy(np.random.RandomState(2).rand(3, 3, S, S).astype(np.float32))
    for b in (1, 3):
        with torch.no_grad():
            want = live(x[:b])["pred"]
        got = ab(x[:b])
        assert got.shape == want.shape and got.shape[0] == b
        scale = want[..., :4].abs().max().item()
        assert (got - want).abs().max().item() <= 1e-6 * scale, name
    ops = {str(n.target) for n in ab._program.graph.nodes}
    assert ("edgeyolo_tpu_torch.linear_attention.default" in ops) == (name in ATTENTION)


@pytest.mark.parametrize("held", list(MODELS), indirect=True)
def test_jax_npz_serves_as_jax(held):
    name, pm, jm, out = held["name"], held["pm"], held["jm"], held["out"]
    path = JaxExporter(_jax_args("npz"))(jm, out_dir=out / "jax_npz")
    ab = AutoBackend(path, device="cpu")
    assert ab.kind == "npz" and ab.task == pm.task
    x = torch.from_numpy(held["imgs"]).permute(0, 3, 1, 2).float() / 255
    got, jpred = ab(x).numpy(), held["jpred"]
    assert got.shape == jpred.shape
    if pm.task == "classify":  # probabilities
        np.testing.assert_allclose(got, jpred, atol=1e-4, rtol=0)
        return
    if pm.end2end:  # (B, 300, 6) selections, near-tied rows matched within their group
        assert_e2e_close(got, jpred, box_atol=5e-3, score_atol=1e-4)
        return
    d = np.abs(got - jpred)
    nc = pm.nc
    assert d[..., :4].max() < 5e-3 and d[..., 4:4 + nc].max() < 1e-4, name
    extra, jextra = got[..., 4 + nc:], jpred[..., 4 + nc:]
    if pm.task == "segment":  # mask coefficients: of their scale
        assert np.abs(extra - jextra).max() < 1e-4 * np.abs(jextra).max()
    elif pm.task == "pose":  # (x, y, visibility) per keypoint
        kd = np.abs(extra - jextra).reshape(*extra.shape[:2], -1, 3)
        assert kd[..., :2].max() < 5e-3 and kd[..., 2].max() < 1e-4
    elif pm.task == "obb":  # the angle
        assert np.abs(extra - jextra).max() < 1e-4


@pytest.mark.parametrize("held,fmt", list(RAISES), indirect=["held"])
def test_port_raises_where_jax_raises(held, fmt):
    want = RAISES[(held["name"], fmt)]
    with pytest.raises(want):
        JaxExporter(_jax_args(JAX_FORMAT[fmt]))(held["jm"], out_dir=held["out"] / "jax_raise")
    with pytest.raises(want):
        Exporter(_args(fmt))(held["pm"], out_dir=held["out"] / "raise")


@pytest.mark.parametrize("layout", ["qkv", "contiguous"])
def test_fake_strides_equal_the_kernel_plan(layout):
    if layout == "qkv":
        qkv = torch.zeros(2, 3, 2, 64, 400)
        q, k, v = (qkv[:, i].permute(0, 3, 1, 2) for i in range(3))
        want = (2 * 64 * 400, 1, 64 * 400, 400)
    else:
        q = k = v = torch.zeros(2, 400, 2, 64)
        want = (400 * 2 * 64, 2 * 64, 64, 1)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        y = la.linear_attention(fq, fk, fv)
    assert y.shape == q.shape and y.stride() == want == la._y_strides(q.shape, q.stride())
    assert la.linear_attention(q, k, v).stride() == want  # the CPU's plain version too


@functools.lru_cache(maxsize=1)
def _yolo11n_pair():
    """yolo11n in both packages at its seeded (port) and zero (JAX) weights,
    built once for the format tests, which read no weight."""
    jm = jtasks.DetectionModel("yolo11n.yaml")
    jm.variables = jax.tree.map(jnp.asarray, _jax_template(jm))
    return DetectionModel("yolo11n.yaml", device="cpu"), jm


@pytest.mark.parametrize("fmt", ["pb", "tfjs", "edgetpu", "nope"])
def test_unported_and_unknown_formats_raise_as_jax(fmt):
    pm, jm = _yolo11n_pair()
    want = ValueError if fmt == "nope" else NotImplementedError
    with pytest.raises(want):
        JaxExporter(_jax_args(fmt))(jm, out_dir="/nonexistent/never-written")
    with pytest.raises(want):
        Exporter(_args(fmt))(pm, out_dir="/nonexistent/never-written")


@pytest.mark.parametrize("fmt", ["saved_model", "tflite"])
def test_tf_formats_raise_and_are_gated(fmt):
    """JAX writes them through jax2tf where tensorflow imports (ROADMAP §C.20);
    the port has no torch -> TF bridge: gated in the table, raising on export."""
    pm = _yolo11n_pair()[0]
    assert not format_available(fmt)
    with pytest.raises(NotImplementedError, match="tensorflow"):
        Exporter(_args(fmt))(pm, out_dir="/nonexistent/never-written")


def test_port_npz_round_trips_to_the_bit(tmp_path):
    """The port's own npz: the fused state_dict and its metadata (NCHW)."""
    pm = DetectionModel("yolo11n.yaml", device="cpu")
    fused = copy.deepcopy(pm).fuse().eval()
    npz = Exporter(_args("npz"))(pm, out_dir=tmp_path)
    meta = json.loads(open(npz.replace(".npz", ".json")).read())
    assert meta["layout"] == "NCHW" and meta["imgsz"] == S and meta["model_yaml"] == "yolo11n.yaml"
    ab = AutoBackend(npz, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(ab.model.state_dict().values(),
                                                 fused.state_dict().values()))
    x = torch.rand(2, 3, S, S)
    with torch.no_grad():
        assert torch.equal(ab(x), fused(x)["pred"])
