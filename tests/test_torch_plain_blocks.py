"""The plain-conv detect families in the PyTorch port against the JAX package,
on the CPU in f32: yolov8-ghost{,-p2,-p6}, yolov8-p6, yolov3-spp, yolov3-tiny
and yolov6{,x}.

- Their new modules one by one at narrow widths, as
  tests/test_torch_v13_modules.py runs them (tolerance 1e-4): GhostConv,
  GhostBottleneck at stride 1 and 2 (and at c1 != c2, JAX's 1x1 shortcut),
  C3Ghost, C2, SPP, the transposed conv (torch's (in, out, k, k) kernel,
  flipped against flax's), yolov3-tiny's zero pad and stride-1 max pool
  (exactly), and a ReLU Conv and SPPF under a YAML's `activation:` override.
- A repeated plain module (yolov6's `[-1, 6, Conv, ...]`, yolov3's
  Bottleneck repeats) is n copies in an nn.Sequential with the reference's
  `model.{i}.{j}` keys, which JAX's `l{i}_{Type}_{j}` scopes bridge to.
- Each YAML (tests/torch_family_checks.py): the byte-identical copy; every
  scale parsed as JAX parses it and built, counting the reference's
  parameters where tests/test_parse_and_parity.py lists them; at scale n or
  its own size JAX's parameter count, the strict bridge both ways and the
  64 px pred against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_v13_modules import ATOL, _from_port, _run_pair, _to_port, _variables, _x
from torch_family_checks import (build_family, check_bridge, check_copy, check_pred,  # noqa: F401
                                 check_scale, one_torch_thread, scales_of)

from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.nn.modules import block as jblock
from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import extra as jextra
from edgeyolo_tpu_torch.cfg.models import model_cfg
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.modules import block, conv, extra
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.utils.convert import from_jax_variables, jax_path_to_torch_key

# YAML: weight SCALE (tests/torch_family_checks.py)
CONFIGS = {"yolov8-ghost.yaml": 2.5, "yolov8-ghost-p2.yaml": 2.5, "yolov8-ghost-p6.yaml": 2.5,
           "yolov8-p6.yaml": 2.5, "yolov3-spp.yaml": 2.1, "yolov3-tiny.yaml": 2.5,
           "yolov6.yaml": 2.5, "yolov6x.yaml": 2.5}

CASES = [
    ("GhostConv", jconv.GhostConv(32, 3, 2), conv.GhostConv(16, 32, 3, 2), (2, 8, 8, 16)),
    ("GhostConv_1x1", jconv.GhostConv(16), conv.GhostConv(16, 16), (2, 6, 6, 16)),
    ("GhostBottleneck", jextra.GhostBottleneck(32), extra.GhostBottleneck(32, 32),
     (2, 6, 6, 32)),
    ("GhostBottleneck_s2", jextra.GhostBottleneck(32, 3, 2), extra.GhostBottleneck(16, 32, 3, 2),
     (2, 8, 8, 16)),
    ("GhostBottleneck_c1_ne_c2", jextra.GhostBottleneck(32), extra.GhostBottleneck(16, 32),
     (2, 6, 6, 16)),
    ("C3Ghost", jextra.C3Ghost(64, 2), extra.C3Ghost(32, 64, 2), (2, 6, 6, 32)),
    ("C2", jblock.C2(64, 2, False), block.C2(32, 64, 2, False), (2, 6, 6, 32)),
    ("C2_shortcut", jblock.C2(32, 1, True), block.C2(32, 32, 1, True), (2, 6, 6, 32)),
    ("SPP", jblock.SPP(32, (5, 9, 13)), block.SPP(32, 32, (5, 9, 13)), (2, 13, 13, 32)),
]


@pytest.mark.parametrize("jmod,tmod,shape", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_module_matches_jax(jmod, tmod, shape):
    flat, yj, yt = _run_pair(jmod, tmod, _x(shape), "nhwc")
    np.testing.assert_allclose(_from_port(yt, "nhwc"), np.asarray(yj), atol=ATOL)
    assert {k for k in tmod.state_dict() if not k.endswith("num_batches_tracked")} == set(
        from_jax_variables(flat))


def test_pad_then_stride1_pool_match_jax_exactly():
    """yolov3-tiny layers 11-12 (ZeroPad2d (0, 1, 0, 1), MaxPool2d(2, 1, 0)): the
    side kept, the pad's zeros taking part in the max; and its stride-2 pools."""
    x = _x((2, 5, 5, 8)) - 0.5  # negative values, so a padded zero can win the max
    xj = jnp.asarray(x)
    pad, pool = jconv.ZeroPad2d((0, 1, 0, 1)), jconv.MaxPool2d(2, 1, 0)
    yj = pool.apply({}, pad.apply({}, xj))
    tpad, tpool = conv.ZeroPad2d((0, 1, 0, 1)), conv.MaxPool2d(2, 1, 0)
    yt = tpool(tpad(_to_port(x, "nhwc")))
    assert yt.shape == (2, 8, 5, 5)
    np.testing.assert_array_equal(_from_port(yt, "nhwc"), np.asarray(yj))
    xp = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))  # and numpy's 2 x 2 windows
    want = np.maximum.reduce([xp[:, :-1, :-1], xp[:, 1:, :-1], xp[:, :-1, 1:], xp[:, 1:, 1:]])
    np.testing.assert_array_equal(np.asarray(yj), want)
    assert (want[:, -1] == 0).any()  # a padded zero won
    y2 = conv.MaxPool2d(2, 2, 0)(_to_port(x, "nhwc"))
    np.testing.assert_array_equal(_from_port(y2, "nhwc"),
                                  np.asarray(jconv.MaxPool2d(2, 2, 0).apply({}, xj)))


def test_transposed_conv_matches_jax():
    """yolov6's raw nn.ConvTranspose2d(k=2, s=2, p=0), bias, no norm: JAX's
    flax ConvTranspose ('SAME' at k == s) against torch's, the kernel carried
    by from_jax_variables under the layer's own key."""
    jmod = jconv.ConvTranspose(16, 2, 2, 0, bn=False, act=False)
    x = _x((2, 5, 6, 32))
    flat = _variables(jmod, jnp.asarray(x))
    yj = jmod.apply(traverse_util.unflatten_dict(flat), jnp.asarray(x))
    sd = from_jax_variables({(c, "l11_nn_ConvTranspose2d", *p): v for (c, *p), v in flat.items()})
    assert set(sd) == {"model.11.weight", "model.11.bias"}
    tmod = conv.ConvTranspose2d(32, 16, 2, 2, 0)
    tmod.load_state_dict({k.removeprefix("model.11."): v for k, v in sd.items()})
    with torch.no_grad():
        yt = tmod(_to_port(x, "nhwc"))
    assert yt.shape == (2, 16, 10, 12)
    np.testing.assert_allclose(_from_port(yt, "nhwc"), np.asarray(yj), atol=ATOL)


def test_relu_override_matches_jax():
    """A Conv line given act "relu" by the override, and an SPPF built under
    it, whose nested act=True convs take ReLU too (JAX's default_act scope)."""
    x = _x((2, 6, 6, 16))
    for jmod, make in ((jconv.ConvBN(32, 3, 1, act="relu"),
                        lambda: conv.ConvBN(16, 32, 3, 1, act="relu")),
                       (jblock.SPPF(32, 5), lambda: block.SPPF(16, 32, 5))):
        with conv.default_act("relu"):
            tmod = make()
        xj = jnp.asarray(x)
        flat = _variables(jmod, xj)
        with jconv.bn_config(), jconv.default_act("relu"):
            yj = jax.jit(jmod.apply)(traverse_util.unflatten_dict(flat), xj)
        tmod.load_state_dict(from_jax_variables(flat))
        with torch.no_grad():
            yt = tmod.eval()(_to_port(x, "nhwc"))
        np.testing.assert_allclose(_from_port(yt, "nhwc"), np.asarray(yj), atol=ATOL)
        assert (yt >= 0).all() and (yt == 0).any()  # ReLU, not SiLU
    assert conv.ConvBN(16, 32).act is torch.nn.functional.silu  # the default outside
    with pytest.raises(ValueError):
        conv.activation("gelu")


def test_yolov6_activation_reaches_every_conv():
    spec = model_cfg("yolov6n")
    assert spec["activation"] == "nn.ReLU()"
    layers, _, info = tasks.parse_spec(spec)
    assert info["act"] == "relu"
    assert [dict(s.kwargs).get("act") for s in layers if s.name == "Conv"] == ["relu"] * 21
    m = DetectionModel("yolov6n", device="cpu")
    acts = {mod.act for mod in m.modules() if isinstance(mod, conv.ConvBN)}
    assert acts == {torch.nn.functional.relu}  # SPPF's and the head's towers too


def test_repeated_plain_modules_are_sequential():
    """yolov6n layer 2 ([-1, 6, Conv, [128, 3, 1]] at depth 0.33: 2 copies) and
    yolov3 layer 6 (8 Bottlenecks): model.{i}.{j} as in the reference, the
    JAX scopes l{i}_{Type}_{j} mapping to them."""
    m = DetectionModel("yolov6n", device="cpu")
    assert isinstance(m.model[2], torch.nn.Sequential) and len(m.model[2]) == 2
    keys = [k for k in m.state_dict() if k.startswith("model.2.")]
    assert "model.2.0.conv.weight" in keys and "model.2.1.bn.running_var" in keys
    layers = tasks.parse_spec(model_cfg("yolov3"))[0]
    assert [(s.i, s.n) for s in layers if s.n > 1] == [(4, 2), (6, 8), (8, 8), (10, 4), (27, 2)]
    assert jax_path_to_torch_key(("l6_Bottleneck_7", "cv2", "bn", "scale")) == \
        "model.6.7.cv2.bn.weight"
    assert jax_path_to_torch_key(("l11_nn_ConvTranspose2d", "conv_transpose", "bias")) == \
        "model.11.bias"
    assert jax_path_to_torch_key(("l2_C3Ghost", "m_0", "short_pw", "conv", "kernel")) == \
        "model.2.m.0.shortcut.1.conv.weight"
    jd = jtasks.yaml_model_load("yolov3.yaml")
    assert [(s.i, s.n) for s in jtasks.parse_spec(jd)[0] if s.n > 1] == \
        [(s.i, s.n) for s in layers if s.n > 1]


@pytest.mark.parametrize("yaml", list(CONFIGS))
def test_yaml_copy_is_byte_identical_to_jax(yaml):
    check_copy(yaml)


@pytest.mark.parametrize("yaml,scale", [(y, s) for y in CONFIGS for s in scales_of(y)],
                         ids=lambda v: v.replace(".yaml", ""))
def test_every_scale_parses_as_jax_and_builds(yaml, scale):
    check_scale(yaml, scale)


@pytest.fixture(scope="module", params=[(y, scales_of(y)[:1]) for y in CONFIGS],
                ids=lambda v: f"{v[0].removesuffix('.yaml')}@{v[1]}")
def family(request):
    yaml, scale = request.param
    return build_family(yaml, scale, CONFIGS[yaml])


def test_state_dict_bridges_both_ways(family):
    check_bridge(family)


def test_pred_matches_jax(family):
    check_pred(family)
