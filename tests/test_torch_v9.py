"""The YOLOv9 family in the PyTorch port against the JAX package, on the CPU
in f32.

The GELAN blocks one by one at narrow widths (tests/test_torch_v13_modules.py's
`_run_pair`: JAX variables filled from a seeded generator, carried across
with `from_jax_variables`), at tolerance 1e-5: RepConv with and without its
identity BatchNorm, RepNBottleneck, RepNCSP, RepNCSPELAN4, ELAN1, AConv and
ADown at odd and even sides (the pool padded at the bottom and right, its
zeros counted), SPPELAN, CBLinear's tuple and CBFuse at integer and
non-integer factors (JAX's nearest rule, which torch's "nearest" misses).

The six v9 YAMLs through tests/torch_family_checks.py: the byte-identical
copy, the parse (CBLinear's tuple channels, CBFuse's indices), the
reference's parameter count where tests/test_parse_and_parity.py lists it,
JAX's count, the strict bridge both ways and the 64 px pred (boxes 5e-3 px,
scores 1e-4) at a weight SCALE scanned as tests/test_torch_families.py
scans it, the two images' boxes apart by MIN_SPREAD.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_parse_and_parity import PARITY
from test_torch_v13_modules import _from_port, _inputs, _run_pair, _variables
from torch_family_checks import (build_family, check_bridge, check_copy, check_pred,  # noqa: F401
                                 check_scale, one_torch_thread)

from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import extra as jextra
from edgeyolo_tpu_torch.cfg.models import model_cfg
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.modules import gelan
from edgeyolo_tpu_torch.ops.resize import nearest_resize
from edgeyolo_tpu_torch.nn.tasks import num_params
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

ATOL = 1e-5

CASES = [
    ("RepConv", jextra.RepConv(16), gelan.RepConv(8, 16), (2, 6, 6, 8)),
    ("RepConv_identity_bn", jextra.RepConv(16, bn=True), gelan.RepConv(16, 16, bn=True),
     (2, 6, 6, 16)),
    ("RepConv_s2", jextra.RepConv(16, 3, 2, bn=True), gelan.RepConv(16, 16, 3, 2, bn=True),
     (2, 7, 7, 16)),
    ("RepNBottleneck", jextra.RepNBottleneck(16), gelan.RepNBottleneck(16, 16), (2, 6, 6, 16)),
    ("RepNCSP", jextra.RepNCSP(16, 2), gelan.RepNCSP(8, 16, 2), (2, 6, 6, 8)),
    ("RepNCSPELAN4", jextra.RepNCSPELAN4(32, 32, 16, 2), gelan.RepNCSPELAN4(16, 32, 32, 16, 2),
     (2, 6, 6, 16)),
    ("ELAN1", jextra.ELAN1(32, 32, 16), gelan.ELAN1(16, 32, 32, 16), (2, 6, 6, 16)),
    ("AConv_even", jextra.AConv(16), gelan.AConv(8, 16), (2, 8, 8, 8)),
    ("AConv_odd", jextra.AConv(16), gelan.AConv(8, 16), (2, 7, 9, 8)),
    ("ADown_even", jextra.ADown(32), gelan.ADown(16, 32), (2, 8, 8, 16)),
    ("ADown_odd", jextra.ADown(32), gelan.ADown(16, 32), (2, 9, 7, 16)),
    ("SPPELAN", jextra.SPPELAN(32, 16), gelan.SPPELAN(24, 32, 16), (2, 6, 6, 24)),
]


@pytest.mark.parametrize("jmod,tmod,shape", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_block_matches_jax(jmod, tmod, shape):
    x = _inputs(shape)
    flat, yj, yt = _run_pair(jmod, tmod, x, "nhwc")
    np.testing.assert_allclose(_from_port(yt, "nhwc"), np.asarray(yj), atol=ATOL)
    assert {k for k in tmod.state_dict() if not k.endswith("num_batches_tracked")} == set(
        from_jax_variables(flat))


def test_repconv_identity_bn_only_where_jax_adds_it():
    assert gelan.RepConv(16, 16, bn=True).bn is not None
    assert gelan.RepConv(8, 16, bn=True).bn is None
    assert gelan.RepConv(16, 16, 3, 2, bn=True).bn is None
    assert gelan.RepConv(16, 16).bn is None


@pytest.mark.parametrize("h,w", [(6, 6), (7, 5)])
def test_padded_pool_counts_its_zeros(h, w):
    """The bottom-right pixel of the padded pool is a quarter of the input's
    (three of the four taps are padding), as flax's avg_pool gives."""
    x = torch.rand(1, 2, h, w) + 1
    y = gelan.avg_pool_pad_br(x)
    assert y.shape == x.shape
    torch.testing.assert_close(y[..., -1, -1], x[..., -1, -1] / 4)
    torch.testing.assert_close(y[..., 0, 0], x[..., :2, :2].mean(dim=(-1, -2)))


@pytest.mark.parametrize("src,dst", [((4, 4), (8, 8)), ((3, 5), (7, 7)), ((5, 7), (3, 4)),
                                     ((6, 4), (10, 9))])
def test_nearest_resize_is_jax_nearest(src, dst):
    """Non-integer factors, up and down: torch's "nearest" differs from JAX's
    half-pixel rule there; the port's index arithmetic equals it."""
    x = np.random.RandomState(0).randn(2, 3, *src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                       (2, *dst, 3), "nearest")).transpose(0, 3, 1, 2)
    got = nearest_resize(torch.from_numpy(x), dst).numpy()
    np.testing.assert_array_equal(got, want)


def test_cblinear_and_cbfuse_match_jax():
    """yolov9e's auxiliary path: two CBLinear tuples and a plain map fused at
    non-integer factors onto the last input."""
    xa, xb, xt = _inputs(((2, 5, 5, 8), (2, 3, 4, 8), (2, 7, 7, 16)))
    ja, jb = jextra.CBLinear((16, 8)), jextra.CBLinear((8, 16, 4))
    va, vb = _variables(ja, jnp.asarray(xa)), _variables(jb, jnp.asarray(xb), seed=1)
    with jconv.bn_config():
        ta = ja.apply(traverse_util.unflatten_dict(va), jnp.asarray(xa))
        tb = jb.apply(traverse_util.unflatten_dict(vb), jnp.asarray(xb))
        yj = jextra.CBFuse((0, 1)).apply({}, [ta, tb, jnp.asarray(xt)])
    pa, pb = gelan.CBLinear(8, (16, 8)), gelan.CBLinear(8, (8, 16, 4))
    for m, v in ((pa, va), (pb, vb)):
        m.load_state_dict(from_jax_variables(v))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    with torch.no_grad():
        outa, outb = pa(to(xa)), pb(to(xb))
        assert [t.shape[1] for t in outb] == [8, 16, 4]
        for t, tj in zip(outb, tb):
            np.testing.assert_allclose(_from_port(t, "nhwc"), np.asarray(tj), atol=ATOL)
        yt = gelan.CBFuse((0, 1))([outa, outb, to(xt)])
    np.testing.assert_allclose(_from_port(yt, "nhwc"), np.asarray(yj), atol=ATOL)


# YAML: weight SCALE. The v9 graphs sit at a cliff: at 2.13 the two images'
# boxes differ by 0.02-0.08 px, at 2.16 the deepest stacks overflow to NaN or
# saturate (scanned on one thread), so MIN_SPREAD holds them to 0.02 px
# (ROADMAP C.14).
CONFIGS = {"yolov9t.yaml": 2.13, "yolov9s.yaml": 2.13, "yolov9m.yaml": 2.13,
           "yolov9c.yaml": 2.13, "yolov9e.yaml": 2.13, "yolov9x.yaml": 2.13}
MIN_SPREAD = 0.02


@pytest.mark.parametrize("yaml", list(CONFIGS))
def test_yaml_copy_is_byte_identical_to_jax(yaml):
    check_copy(yaml)


@pytest.mark.parametrize("yaml", list(CONFIGS))
def test_parses_as_jax_and_counts_the_reference(yaml):
    """The file's one size (the scale its name carries, as JAX guesses it:
    yolov9s is s, yolov9c none) parses as JAX's and builds with the
    reference's parameter count where it is listed."""
    scale = model_cfg(yaml)["scale"]
    pm = check_scale(yaml, scale)
    listed = PARITY.get((yaml.removesuffix(".yaml"), ""))
    assert listed is None or num_params(pm) == listed


def test_cblinear_channels_are_a_tuple_that_cbfuse_indexes():
    layers = tasks.parse_spec(model_cfg("yolov9e"))[0]
    assert layers[14].name == "CBLinear" and layers[14].c2 == (64, 128, 256, 512, 1024)
    assert layers[16].name == "CBFuse" and layers[16].args == ((0, 0, 0, 0, 0),)
    assert layers[16].c2 == 64


@pytest.fixture(scope="module", params=list(CONFIGS), ids=lambda y: y.removesuffix(".yaml"))
def family(request):
    yaml = request.param
    return build_family(yaml, model_cfg(yaml)["scale"], CONFIGS[yaml])


def test_state_dict_bridges_both_ways(family):
    check_bridge(family)


def test_pred_matches_jax(family):
    check_pred(family, min_spread=MIN_SPREAD)
