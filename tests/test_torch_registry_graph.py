"""The registry test graph (tests/torch_registry_spec.py) and the facade's
`fuse` and `embed`: the PyTorch port against the JAX package on the CPU in f32.

The graph's JAX variables come from `jax.eval_shape` of its init (an eager
init costs ~26 s) filled from a seeded numpy generator: every BatchNorm
statistic, scale and shift, every gate, band weight and learned scale at
random, and the kernels U(+-1/sqrt(fan_in)) times SCALE, the largest in
steps of 0.1 under which the 64 px boxes of two images differ by more than
1 px and the port stays within the families' tolerances on one thread and on
eight (at 2.6 the graph turns chaotic: boxes 0.26 px apart, scores 1e-3).
They reach the port through `from_jax_variables`, with no key left over or
missing but the 16 frozen DFL bins the port stores. One `jax.jit` of the
graph's apply runs the unfused and the fused variables.

Tolerances: the pred 5e-3 px and 1e-4 (the families'); the fused pred against
JAX's `fuse_conv_bn` 1e-5 of the largest box coordinate and 1e-5 in score;
`embed` 1e-5 of each vector's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_registry_spec import JAX_PARAMS, SPEC, random_leaf, write_yaml
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.engine.model import YOLO as JYOLO
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu_torch.data.imageio import encode_png
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.tasks import DetectionModel, num_params
from edgeyolo_tpu_torch.utils.convert import from_jax_variables, jax_path_to_torch_key

S = 64
SCALE = 2.5
FLAGSHIP_SCALE = 2.0  # tests/test_torch_predict_extras.py's: at 2.5 its C2PSA stage saturates
WORLD = {"C2fAttn", "ImagePoolingAttn", "WorldDetect"}


def filled(jm, scale: float, seed: int = 0) -> dict:
    """{(collection, *path): array}: jm's variables at random (see the docstring)."""
    shapes = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))
    rs = np.random.RandomState(seed)
    return {k: random_leaf(rs, k[1:], s.shape, scale).astype(np.float32)
            for k, s in traverse_util.flatten_dict(shapes).items()}


def imgs(seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (2, S, S, 3)).astype(np.uint8)


def port_pred(model, x_u8) -> np.ndarray:
    with torch.no_grad():
        return model(torch.from_numpy(x_u8).permute(0, 3, 1, 2).float() / 255)["pred"].numpy()


@pytest.fixture(scope="module")
def graph():
    jm = jtasks.DetectionModel(dict(SPEC, scale="n"))
    flat = filled(jm, SCALE)
    variables = traverse_util.unflatten_dict(flat)
    apply = jax.jit(lambda v, x: jm.net.apply(v, x, train=False)["pred"])
    x = jnp.asarray(imgs(), jnp.float32) / 255
    fused = jax.tree.map(np.asarray, jtasks.fuse_conv_bn(variables, eps=jm.bn_eps))
    pm = DetectionModel(SPEC, device="cpu")
    missing, unexpected = pm.load_state_dict(from_jax_variables(flat), strict=False)
    assert missing == ["model.28.dfl.conv.weight"] and not unexpected
    return {"jm": jm, "flat": flat, "variables": variables, "fused": fused, "pm": pm,
            "jpred": np.asarray(apply(variables, x)), "jpred_fused": np.asarray(apply(fused, x))}


def test_registry_rows_match_jax():
    """Every row the JAX registry has, the port's has (YOLO-World's, WORLD,
    among them), with the same argument names; the parse-time sets agree."""
    assert set(jtasks._REG) - set(tasks._REG) == set() and WORLD <= set(tasks._REG)
    assert all(tasks._REG[k][1] == jtasks._REG[k][1] for k in jtasks._REG)
    for name in ("_CONV_LIKE", "_REPEAT_INSERT", "_C3K2_FAMILY", "_HEADS"):
        assert getattr(jtasks, name) - getattr(tasks, name) == set(), name
    assert tasks._STRIDE_ARG == jtasks._STRIDE_ARG


@pytest.mark.parametrize("source", ["dict", "yaml"])
def test_graph_parses_as_jax(source, tmp_path):
    spec = SPEC if source == "dict" else tasks.model_cfg(str(write_yaml(tmp_path / "g.yaml")))
    layers, save, info = tasks.parse_spec(tasks.model_cfg(spec))
    jlayers, jsave, jinfo = jtasks.parse_spec(dict(SPEC, scale="n"))
    assert info["scale"] == jinfo["scale"] == "n" and save == jsave
    assert [(s.i, s.f, s.n, s.name, s.args, s.c2) for s in layers] == \
        [(s.i, s.f, s.n, s.name, s.args, s.c2) for s in jlayers]
    assert len(layers) == 29 and layers[22].args[-1] == "telu"
    strides = tasks.derive_strides(layers)
    assert strides == jtasks.derive_strides(jlayers)
    assert [strides[i] for i in layers[-1].f] == [8.0, 16.0, 32.0]


def test_parameters_and_bridge(graph):
    """JAX's 3,204,396 parameters plus the port's 16 DFL bins; the JAX tree
    converts with no key left over and none missing."""
    flat, pm = graph["flat"], graph["pm"]
    assert sum(v.size for k, v in flat.items() if k[0] == "params") == JAX_PARAMS
    assert num_params(pm) == JAX_PARAMS + 16
    sd = from_jax_variables(flat)
    assert set(sd) == {k for k in pm.state_dict()
                       if not k.endswith("num_batches_tracked") and ".dfl." not in k}
    assert all(torch.equal(pm.state_dict()[k], v) for k, v in sd.items())


def test_pred_matches_jax(graph):
    pred, jpred = port_pred(graph["pm"], imgs()), graph["jpred"]
    assert pred.shape == jpred.shape == (2, 84, 84)  # (B, anchors, 4 + nc): 84 of each
    d = np.abs(pred - jpred)
    assert d[..., :4].max() < 5e-3 and d[..., 4:].max() < 1e-4, (d[..., :4].max(), d[..., 4:].max())
    assert np.abs(pred[0, :, :4] - pred[1, :, :4]).max() > 1.0  # the output depends on the image
    assert (pred[..., 4:] > 0.25).any() and (pred[..., 4:] < 0.25).any()


def test_fuse_matches_jax(graph):
    """The fused port against JAX's fuse_conv_bn of the same variables, with the
    same pairs folded (by converted key); the fold keeps the function."""
    pm = DetectionModel(SPEC, device="cpu")
    pm.load_state_dict(graph["pm"].state_dict())
    unfused = port_pred(pm, imgs())
    pm.fuse()
    got, want = port_pred(pm, imgs()), graph["jpred_fused"]
    box = np.abs(want[..., :4]).max()
    for other in (want, unfused):
        d = np.abs(got - other)
        assert d[..., :4].max() <= 1e-5 * box and d[..., 4:].max() <= 1e-5, (
            d[..., :4].max(), d[..., 4:].max())
    after = traverse_util.flatten_dict(graph["fused"])
    folded = {jax_path_to_torch_key(k[1:-1] + ("mean",)).removesuffix(".running_mean")
              for k in after if k[0] == "batch_stats" and k[-1] == "mean"
              and not np.array_equal(after[k], graph["flat"][k])}
    assert sorted(pm.fused_bns) == sorted(folded) and len(folded) == 90
    kept = {n for n, m in pm.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    # BottleneckCSP's joint BatchNorm and MulGate's (beside `mix`) stay
    assert kept == {"model.5.bn", "model.11.bn"}


def test_fuse_is_idempotent_and_survives_save_load(graph, tmp_path):
    y = YOLO(str(write_yaml(tmp_path / "registry-graph.yaml")), device="cpu")
    y.model.load_state_dict(graph["pm"].state_dict())
    y.fuse()
    first = port_pred(y.model, imgs())
    n_folded = len(y.model.fused_bns)
    y.fuse()
    assert len(y.model.fused_bns) == n_folded == 90
    np.testing.assert_array_equal(port_pred(y.model, imgs()), first)
    path = y.save(tmp_path / "fused.pt")
    again = YOLO(str(path), device="cpu")
    assert again.model.fused
    np.testing.assert_array_equal(port_pred(again.model, imgs()), first)
    into = YOLO(str(tmp_path / "registry-graph.yaml"), device="cpu").load(path)
    assert into.model.fused
    np.testing.assert_array_equal(port_pred(into.model, imgs()), first)


def _image_dir(tmp_path):
    """A folder of PNG files at the letterbox's own scale (only gray padding,
    no resize), so both facades see the same pixels. A folder: JAX's loader
    reads a list of path strings as an array of strings."""
    rs = np.random.RandomState(3)
    folder = tmp_path / "images"
    folder.mkdir()
    for i, (h, w) in enumerate([(S, S), (48, S), (S, 40)]):
        (folder / f"im{i}.png").write_bytes(
            encode_png(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)))
    return str(folder)


@pytest.fixture(scope="module")
def flagship():
    jy = JYOLO("edgeline-yolo.yaml")
    flat = filled(jy.model, FLAGSHIP_SCALE, seed=2)
    jy.model.variables = traverse_util.unflatten_dict(flat)
    py = YOLO("edgeline-yolo.yaml", device="cpu")
    py.model.load_state_dict(from_jax_variables(flat), strict=False)
    return jy, py


@pytest.mark.parametrize("model,taps", [("graph", None), ("graph", [22, 9]),
                                        ("flagship", None), ("flagship", [10, 22])])
def test_embed_matches_jax(model, taps, graph, flagship, tmp_path):
    """Both facades' embed on the same image files: one vector per image, the
    taps pooled and concatenated in layer order (not the caller's), stopping
    at the largest; default tap len(layers) - 2."""
    if model == "graph":
        yaml = str(write_yaml(tmp_path / "registry-graph.yaml"))
        jy, py = JYOLO(yaml), YOLO(yaml, device="cpu")
        jy.model.variables = graph["variables"]
        py.model.load_state_dict(graph["pm"].state_dict())
    else:
        jy, py = flagship
    folder = _image_dir(tmp_path)
    kw = {"imgsz": S} if taps is None else {"imgsz": S, "embed": taps}
    want = jy.embed(folder, **kw)
    got = py.embed(folder, **kw)
    stream = list(py.embed(folder, stream=True, **kw))
    layers = py.model.layers
    width = sum(layers[i].c2 for i in (taps or [len(layers) - 2]))
    assert len(got) == len(want) == len(stream) == 3
    for g, s, w in zip(got, stream, want):
        assert g.dtype == torch.float32 and g.shape == (width,) == w.shape
        torch.testing.assert_close(s, g, rtol=0, atol=0)
        err, scale = np.abs(g.numpy() - w).max(), np.abs(w).max()
        assert err <= 1e-5 * scale, (err, scale)
    # the vectors of two images differ by more than ten times the tolerance
    assert np.abs(got[0].numpy() - got[1].numpy()).max() > 1e-4 * np.abs(want[0]).max()
