"""The port's ONNX path against the JAX package: the protobuf layer
(export/onnx_proto.py), the numpy executor (export/onnx_runtime.py) and the
ATen -> ModelProto bridge (export/torch2onnx.py).

- The port's protobuf writer writes the same bytes as JAX's for the same
  nodes, tensors, attributes, value infos, graph and model (tolerance 0), and
  both readers parse them back alike.
- Each ATen lowering, exported with torch.export and run through the port's
  executor, matches eager torch within 1e-6 of the output's scale (f32; the
  executor sums in another order, and its Erf is a polynomial good to 1.5e-7).
- JAX's exported flagship .onnx runs through the port's executor as through
  JAX's (1e-6 of the output scale: the same numpy code).
- The port's flagship .onnx runs through JAX's own OnnxModel: against the
  port's live forward at JAX's ONNX tolerance (atol 5e-4, rtol 1e-3,
  tests/test_onnx.py), the gap printed; against JAX's live forward on the same
  weights at the family tolerances (boxes 5e-3 px, scores 1e-4).
- The bridge emits no op outside JAX's executor set.
The flagship's weights are the family tests' (x2.4, tests/torch_family_checks.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_families import _imgs
from torch_family_checks import build_family, jax_spec
from torch_threads import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

from edgeyolo_tpu.cfg import get_cfg as jax_get_cfg
from edgeyolo_tpu.export import onnx_proto as JP
from edgeyolo_tpu.export import onnx_runtime as jrt
from edgeyolo_tpu.export.exporter import Exporter as JaxExporter
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.export import onnx_proto as P
from edgeyolo_tpu_torch.export.exporter import Exporter
from edgeyolo_tpu_torch.export.onnx_runtime import OnnxModel
from edgeyolo_tpu_torch.export.torch2onnx import export_onnx_bytes
from edgeyolo_tpu_torch.nn.autobackend import AutoBackend
from edgeyolo_tpu_torch.ops import linear_attention as la

S = 64
# every op JAX's executor runs (edgeyolo_tpu/export/onnx_runtime.py::OnnxModel._exec)
JAX_EXECUTOR_OPS = {"Conv", "MaxPool", "Transpose", "Reshape", "Expand", "Concat", "Split",
                    "Slice", "Pad", "MatMul", "Where", "Cast", "Identity", "Clip", "ReduceMax",
                    "ReduceMin", "ReduceProd", "ReduceSum", "ArgMax", "ArgMin", "CumSum",
                    "Mod"} | set(jrt._EW1) | set(jrt._EW2)


def test_proto_writes_jaxs_bytes_and_parses_back():
    rs = np.random.RandomState(0)
    tensors = [("w", rs.randn(3, 4).astype(np.float32)), ("i", np.arange(5, dtype=np.int64)),
               ("b", np.array([True, False])), ("h", rs.randn(2).astype(np.float16))]
    for name, arr in tensors:
        assert P.tensor_proto(name, arr) == JP.tensor_proto(name, arr)
        n1, a1 = P.parse_tensor(P.tensor_proto(name, arr))
        n2, a2 = JP.parse_tensor(JP.tensor_proto(name, arr))
        assert n1 == n2 == name and np.array_equal(a1, arr) and np.array_equal(a2, arr)
    attrs = {"f": 0.5, "i": -3, "s": "constant", "t": np.ones((2, 2), np.float32),
             "fs": [1.0, 2.5], "is": [0, -1, 1 << 40], "flag": True}
    nodes = [P.node_proto("Conv", ["x", "w"], ["y"], **attrs),
             P.node_proto("Split", ["y", "s"], ["a", "b"], name="split", axis=1)]
    assert nodes == [JP.node_proto("Conv", ["x", "w"], ["y"], **attrs),
                     JP.node_proto("Split", ["y", "s"], ["a", "b"], name="split", axis=1)]
    for a, b in zip((P.parse_node(n) for n in nodes), (JP.parse_node(n) for n in nodes)):
        assert a.keys() == b.keys() and a["attrs"].keys() == b["attrs"].keys()
        assert all(np.array_equal(a["attrs"][k], b["attrs"][k]) for k in a["attrs"])
    vi = P.value_info_proto("images", np.float32, (1, 3, S, S))
    assert vi == JP.value_info_proto("images", np.float32, (1, 3, S, S))
    graph = P.graph_proto(nodes, "g", [P.tensor_proto(*tensors[0])], [vi], [vi])
    assert graph == JP.graph_proto(nodes, "g", [JP.tensor_proto(*tensors[0])], [vi], [vi])
    meta = {"stride": "[8, 16, 32]", "names": "{0: 'a'}"}
    model = P.model_proto(graph, doc="doc", metadata=meta, producer="edgeyolo_tpu")
    assert model == JP.model_proto(graph, doc="doc", metadata=meta)
    ours = P.parse_model(P.model_proto(graph, doc="doc", metadata=meta))
    assert ours["producer"] == "edgeyolo_tpu_torch" and ours["metadata_props"] == meta
    theirs = JP.parse_model(model)
    assert (ours["doc"], ours["opsets"], ours["inputs"]) == (
        theirs["doc"], theirs["opsets"], theirs["inputs"])


class _Fn(torch.nn.Module):
    def __init__(self, fn, *params):
        super().__init__()
        self.fn = fn
        self.p = torch.nn.ParameterList(torch.nn.Parameter(p, requires_grad=False)
                                        for p in params)

    def forward(self, *xs):
        return self.fn(*xs, *self.p)


_R = np.random.RandomState(1)


def _t(*shape, scale=1.0):
    return torch.from_numpy((_R.randn(*shape) * scale).astype(np.float32))


def _qkv_views(qkv):
    return [qkv[:, i].permute(0, 3, 1, 2) for i in range(3)]


# name: (fn, inputs, parameters)
LOWERINGS = {
    "conv_bias_stride_groups_dilation": (
        lambda x, w, b: F.conv2d(x, w, b, stride=2, padding=2, dilation=2, groups=2),
        [_t(2, 4, 9, 9)], [_t(6, 2, 3, 3), _t(6)]),
    "conv_transpose": (lambda x, w, b: F.conv_transpose2d(x, w, b, stride=2, padding=1,
                                                          output_padding=1),
                       [_t(2, 4, 5, 5)], [_t(4, 3, 3, 3), _t(3)]),
    "conv_transpose_groups": (lambda x, w: F.conv_transpose2d(x, w, stride=2, groups=2),
                              [_t(1, 4, 3, 3)], [_t(4, 2, 2, 2)]),
    "linear": (lambda x, w, b: F.linear(x, w, b), [_t(2, 5, 7)], [_t(3, 7), _t(3)]),
    "matmul_einsum": (lambda a, b: torch.einsum("bnhd,bhde->bnhe", a, b) + a @ a.transpose(-1, -2)
                      .sum(-1, keepdim=True), [_t(2, 5, 3, 4), _t(2, 3, 4, 4)], []),
    "silu_relu_sigmoid_tanh": (lambda x: F.silu(x) + F.relu(x) * torch.sigmoid(x) - torch.tanh(x),
                               [_t(2, 3, 4)], []),
    "softplus_gelu": (lambda x: F.softplus(x * 10) + F.softplus(x, beta=2.0, threshold=5.0)
                      + F.gelu(x) + F.gelu(x, approximate="tanh"), [_t(2, 3, 8, scale=3)], []),
    "softmax": (lambda x: x.softmax(dim=1) + x.softmax(dim=-1), [_t(2, 5, 6, scale=4)], []),
    "upsample_nearest_bilinear": (
        lambda x: F.interpolate(x, scale_factor=2, mode="nearest")[..., :5, :7]
        + F.interpolate(x, size=(5, 7), mode="bilinear", align_corners=False),
        [_t(1, 2, 3, 4)], []),
    "max_pool": (lambda x: F.max_pool2d(x, 5, 1, 2) + F.max_pool2d(x, 2, 2).sum(),
                 [_t(2, 3, 8, 8)], []),
    "cat_split_chunk_unbind_stack": (
        lambda x: torch.cat(x.split([1, 3], dim=1)[::-1], dim=1)
        + torch.cat(x.chunk(2, dim=-1)[::-1], dim=-1) + torch.stack(x.unbind(2)[::-1], dim=2),
        [_t(2, 4, 3, 6)], []),
    "shape_ops": (lambda x: x.permute(0, 2, 1, 3).flatten(2).unflatten(-1, (3, 4)).transpose(1, 2)
                  .unsqueeze(0).reshape(2, -1).expand(3, 2, 72).contiguous().view(6, 72),
                  [_t(2, 3, 6, 4)], []),
    "slice_select_narrow_flip_pad": (
        lambda x: F.pad(x[:, 1:, ::2], (1, 2, 0, 1), value=0.5)[..., 0, :]
        + x.narrow(1, 0, 3).select(2, -1).flip(-1).sum(), [_t(2, 4, 5, 6)], []),
    "reductions": (lambda x: x.mean((1, 2), keepdim=True) + x.sum(-1, keepdim=True)
                   + x.amax(1, keepdim=True) - x.sum(), [_t(2, 3, 4)], []),
    "clamp_where_eq_cast": (
        lambda x: torch.where(x.clamp(-0.5, 0.7) == 0.7, x, 2.0) + (x > 0).to(torch.float32)
        + torch.where(x < 0, 0.0, x), [_t(3, 5)], []),
    "batch_norm_eval": (lambda x, w, b, m, v: F.batch_norm(x, m, v, w, b, False, 0.1, 1e-3),
                        [_t(2, 3, 4, 4)], [_t(3), _t(3), _t(3), _t(3).abs() + 0.5]),
    "constants_folded": (lambda x: x + torch.stack(torch.meshgrid(
        torch.arange(4.0) + 0.5, torch.arange(5.0), indexing="ij"), -1).sum(-1)
        * torch.ones_like(x), [_t(2, 4, 5)], []),
    "linear_attention_op": (lambda qkv: la.linear_attention(*_qkv_views(qkv)),
                            [_t(2, 3, 2, 8, 25)], []),
}


@pytest.mark.parametrize("name", list(LOWERINGS))
def test_each_lowering_matches_eager(name):
    fn, inputs, params = LOWERINGS[name]
    module = _Fn(fn, *params).eval()
    ep = torch.export.export(module, tuple(inputs))
    blob = export_onnx_bytes(ep, input_names=[f"x{i}" for i in range(len(inputs))])
    got = OnnxModel(blob)(*(x.numpy() for x in inputs))
    with torch.no_grad():
        want = module(*inputs).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 1e-6 * scale, (name, np.abs(got - want).max())
    ops = {n["op"] for n in P.parse_model(blob)["nodes"]}
    assert ops <= JAX_EXECUTOR_OPS, ops - JAX_EXECUTOR_OPS


def test_unlowered_op_names_its_target():
    ep = torch.export.export(_Fn(lambda x: x.sort(dim=-1).values), (_t(2, 5),))
    with pytest.raises(NotImplementedError, match=r"aten\.sort.*\(2, 5\)"):
        export_onnx_bytes(ep)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The flagship at the family tests' weights on both sides, JAX's live pred
    of two 64 px images, and each package's .onnx of it."""
    fam = build_family("edgeline-yolo.yaml", "n", 2.4)
    out = tmp_path_factory.mktemp("onnx")
    ex = Exporter(get_cfg(overrides={"mode": "export", "format": "onnx", "imgsz": S}))
    ex.trace_batch = 2
    port_path = ex(fam["pm"], out_dir=out / "port")
    jm = jtasks.DetectionModel(jax_spec("edgeline-yolo.yaml", "n"))
    jm.variables = jax.tree.map(jnp.asarray, fam["variables"])
    jax_path = JaxExporter(jax_get_cfg(overrides={"mode": "export", "format": "onnx",
                                                   "imgsz": S}))(jm, out_dir=out / "jax")
    return {**fam, "port_path": port_path, "jax_path": jax_path, "ex_seconds": ex.seconds}


def test_jax_flagship_onnx_runs_in_the_port_executor(flagship):
    blob = open(flagship["jax_path"], "rb").read()
    x = np.random.RandomState(5).rand(1, S, S, 3).astype(np.float32)  # JAX's NHWC input
    ours, theirs = OnnxModel(blob)(x), jrt.OnnxModel(blob)(x)
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= 1e-6 * np.abs(theirs).max()


def test_port_flagship_onnx_runs_in_jaxs_executor(flagship):
    blob = open(flagship["port_path"], "rb").read()
    model = jrt.OnnxModel(blob)
    assert {n["op"] for n in model.m["nodes"]} <= JAX_EXECUTOR_OPS
    x = _imgs().transpose(0, 3, 1, 2).astype(np.float32) / 255.0
    got = model(x)
    live = flagship["pred"]  # the port's live (unfused) forward of the same images
    gap = np.abs(got - live).max()
    print(f"port flagship .onnx (JAX's executor) against the port's live forward: max |gap| "
          f"{gap:.3e} (box scale {np.abs(live[..., :4]).max():.1f}); export "
          f"{flagship['ex_seconds']:.1f} s")
    np.testing.assert_allclose(got, live, atol=5e-4, rtol=1e-3)
    d = np.abs(got - flagship["jpred"])
    assert d[..., :4].max() < 5e-3 and d[..., 4:].max() < 1e-4, (d[..., :4].max(), d[..., 4:].max())
    # metadata from the doc_string alone, once the sidecar is gone
    os.remove(flagship["port_path"].replace(".onnx", ".json"))
    ab = AutoBackend(flagship["port_path"], device="cpu")
    assert ab.kind == "onnx" and ab.imgsz == S and ab.stride == (8, 16, 32) and len(ab.names) == 80
    np.testing.assert_array_equal(ab(torch.from_numpy(x)).numpy(), got)
