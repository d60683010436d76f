"""The registry rows no bundled YAML uses, module by module: the PyTorch port
against the JAX package on the CPU in f32, at 16-128 channels and 9-33 px.

As tests/test_torch_v13_modules.py: each JAX module's variable shapes come
from `jax.eval_shape` of its init, filled from a seeded numpy generator with
every parameter and BatchNorm statistic at random (kernels U(+-1/sqrt(fan_in))
times SCALE, the gates and learned scales away from their init), carried into
the port module by `from_jax_variables`, and both modules get the same input
(NHWC to JAX, NCHW to the port). JAX modules run under `bn_config()`, the
detection models' BatchNorm eps.

Tolerance: 1e-5 of the output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.nn.modules import activation as jact
from edgeyolo_tpu.nn.modules import block as jblock
from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import edgeline as jedge
from edgeyolo_tpu.nn.modules import extra as jextra
from edgeyolo_tpu.ops import wavelets as jwave
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.modules import activation, block, conv, edgeline, extra
from edgeyolo_tpu_torch.ops import wavelets
from edgeyolo_tpu_torch.utils.convert import from_jax_variables
from torch_registry_spec import random_leaf
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

RTOL = 1e-5
SCALE = 1.5  # kernels above their init draw, so each block's output depends on its input


def _variables(jmod, xj, seed=0):
    with jconv.bn_config():
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), xj))
    rs = np.random.RandomState(seed)
    return {k: random_leaf(rs, k, s.shape, SCALE).astype(np.float32)
            for k, s in traverse_util.flatten_dict(shapes).items()}


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= RTOL * scale, (err, scale)


def run_pair(jmod, tmod, x):
    """(port output as NHWC numpy, JAX output, the carried variables)."""
    xs = x if isinstance(x, list) else [x]
    xj = [jnp.asarray(a) for a in xs] if isinstance(x, list) else jnp.asarray(x)
    flat = _variables(jmod, xj) if jmod is not None else {}
    with jconv.bn_config():
        yj = jax.jit(jmod.apply)(traverse_util.unflatten_dict(flat), xj)
    if flat:
        missing, unexpected = tmod.load_state_dict(from_jax_variables(flat), strict=True)
        assert not missing and not unexpected
    with torch.no_grad():
        xt = [_nchw(a) for a in xs] if isinstance(x, list) else _nchw(x)
        yt = tmod.eval()(xt)
    return yt.numpy().transpose(0, 2, 3, 1), yj, flat


# (id, JAX module, port module, NHWC input shape)
CASES = [
    ("Focus", jconv.Focus(32, 3), conv.Focus(16, 32, 3), (2, 16, 18, 16)),
    ("Focus_s2", jconv.Focus(24, 3, 2), conv.Focus(16, 24, 3, 2), (2, 20, 16, 16)),
    ("ConvTranspose", jconv.ConvTranspose(16, 2, 2), conv.ConvTranspose(32, 16, 2, 2),
     (2, 9, 11, 32)),
    # p = 1, k = 3: JAX pads the dilated input by 1, torch's padding k - 1 - p
    ("ConvTranspose_p1", jconv.ConvTranspose(16, 3, 2, 1), conv.ConvTranspose(32, 16, 3, 2, 1),
     (2, 9, 11, 32)),
    ("ConvTranspose_nobn", jconv.ConvTranspose(16, 2, 2, bn=False, act=False),
     conv.ConvTranspose(32, 16, 2, 2, bn=False, act=False), (2, 9, 11, 32)),
    ("CBAM", jconv.CBAM(32, 7), conv.CBAM(32, 7), (2, 17, 19, 32)),
    ("CBAM_k3", jconv.CBAM(16, 3), conv.CBAM(16, 3), (2, 16, 16, 16)),
    ("C1", jblock.C1(32, 2), block.C1(16, 32, 2), (2, 16, 16, 16)),
    ("C3x", jblock.C3x(32, 2, True), tasks._REG["C3x"][0](16, 32, 2, True), (2, 16, 16, 16)),
    ("BottleneckCSP", jextra.BottleneckCSP(32, 2, True), extra.BottleneckCSP(16, 32, 2, True),
     (2, 16, 16, 16)),
    ("BottleneckCSP_noshortcut", jextra.BottleneckCSP(32, 1, False),
     extra.BottleneckCSP(32, 32, 1, False), (2, 9, 9, 32)),
    # two levels on odd sides, stride 2: each level pads its odd side by one zero row
    ("WTConv2d", jextra.WTConv2d(16, 5, 2, True, 2, "db1"),
     extra.WTConv2d(16, 16, 5, 2, True, 2, "db1"), (2, 17, 15, 16)),
    ("WTConv2d_db2", jextra.WTConv2d(16, 3, 1, False, 1, "db2"),
     extra.WTConv2d(16, 16, 3, 1, False, 1, "db2"), (2, 16, 20, 16)),
    ("DySample", jextra.DySample(32, 2, "lp", 4), extra.DySample(32, 2, "lp", 4),
     (2, 9, 11, 32)),
    ("DySample_x3", jextra.DySample(16, 3, "lp", 2), extra.DySample(16, 3, "lp", 2),
     (2, 6, 5, 16)),
    ("C3k2_Wavelet", jedge.C3k2_Wavelet(c2=32, n=2, e=0.5),
     edgeline.C3k2_Wavelet(16, 32, 2, e=0.5), (2, 16, 16, 16)),
    ("C3k2_Wavelet_c3k", jedge.C3k2_Wavelet(c2=32, n=1, c3k=True),
     edgeline.C3k2_Wavelet(32, 32, 1, True), (2, 12, 12, 32)),
    ("SPPF_Wavelet", jedge.SPPF_Wavelet(32, 5), edgeline.SPPF_Wavelet(32, 32, 5),
     (2, 16, 16, 32)),
    ("SPPF_Wavelet_odd", jedge.SPPF_Wavelet(16, 5), edgeline.SPPF_Wavelet(32, 16, 5),
     (2, 11, 9, 32)),
    ("MulGate", jedge.MulGate(32), edgeline.MulGate(32, 32), (2, 17, 15, 32)),
    # C = 128: the ECA rule gives a 5-tap 1-D kernel
    ("RHJM", jedge.RHJM(128), edgeline.RHJM(128, 128), (2, 9, 11, 128)),
    ("RHJM_c32", jedge.RHJM(32, local_size=3, local_weight=0.3),
     edgeline.RHJM(32, 32, local_size=3, local_weight=0.3), (2, 16, 16, 32)),
    ("AGLU", jact.AGLU(), activation.AGLU(), (2, 9, 9, 16)),
]


@pytest.mark.parametrize("jmod,tmod,shape", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_module_matches_jax(jmod, tmod, shape):
    yt, yj, flat = run_pair(jmod, tmod, _x(shape))
    assert_close(yt, yj)
    assert {k for k in tmod.state_dict() if not k.endswith("num_batches_tracked")} == set(
        from_jax_variables(flat))


def test_msla_row_matches_jax():
    """MSLA as a registry row: built from the row's arguments [dim, num_heads]."""
    (jcls, _), (tcls, _) = jtasks._REG["MSLA"], tasks._REG["MSLA"]
    yt, yj, _ = run_pair(jcls(64, 2), tcls(64, 2), _x((2, 10, 9, 64)))
    assert_close(yt, yj)


def test_index_selects_one_input():
    xs = [_x((2, 5, 5, 8), seed=s) for s in (1, 2, 3)]
    yj = jconv.Index(8, 1).apply({}, [jnp.asarray(a) for a in xs])
    yt = conv.Index(8, 1)([_nchw(a) for a in xs])
    np.testing.assert_array_equal(yt.numpy().transpose(0, 2, 3, 1), np.asarray(yj))


def test_telu_matches_jax():
    """Both sides of the cutoff (20), where exp overflows in f32 past 88."""
    x = np.concatenate([_x((4000,)) * 5, np.linspace(-100, 100, 401, dtype=np.float32)])
    want = np.asarray(jact.telu(jnp.asarray(x)))
    got = activation.telu(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    assert_close(got, want)
    assert_close(activation.TeLU()(torch.from_numpy(x)).numpy(), want)
    assert_close(conv.activation("telu")(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("hw,out", [((17, 13), (5, 5)), ((5, 5), (17, 13)), ((9, 11), (4, 7))],
                         ids=["down", "up", "mixed"])
def test_adaptive_avg_pool2d_matches_jax(hw, out):
    x = _x((2, *hw, 8))
    want = jedge.adaptive_avg_pool2d(jnp.asarray(x), out)
    got = edgeline.adaptive_avg_pool2d(_nchw(x), out).numpy().transpose(0, 2, 3, 1)
    assert_close(got, want)


def test_available_wavelets_match_jax():
    assert wavelets.available_wavelets() == jwave.available_wavelets()


FRESH = {"MulGate": (lambda: edgeline.MulGate(32, 32), (2, 17, 15, 32)),
         "DySample": (lambda: extra.DySample(32), (2, 9, 11, 32)),
         "C3k2_Wavelet": (lambda: edgeline.C3k2_Wavelet(16, 32, 2), (2, 16, 16, 16))}


@pytest.mark.parametrize("case", list(FRESH))
def test_gates_at_init_hide_the_branch(case):
    """At the port's seeded init MulGate is the identity, DySample a fixed
    bilinear 2x upsample and C3k2_Wavelet's enhancer off: why the cases
    above open every gate."""
    make, shape = FRESH[case]
    model = make()
    tasks.init_weights(model, torch.Generator().manual_seed(0))
    x = _nchw(_x(shape))
    with torch.no_grad():
        y = model.eval()(x)
        if case == "MulGate":
            torch.testing.assert_close(y, x, rtol=0, atol=0)
        elif case == "DySample":
            up = torch.nn.functional.interpolate(x, scale_factor=2, mode="bilinear",
                                                 align_corners=False)
            torch.testing.assert_close(y, up, rtol=1e-6, atol=1e-6)
        else:
            assert float(model.wave.gamma) == 0.0
            torch.testing.assert_close(model.wave(x), x, rtol=0, atol=0)


def test_seeded_init_keeps_jax_inits():
    """init_weights draws every conv but DySample's offset and MulGate's mix,
    which start at zero as in JAX; the learned scales keep 1.0 and 0.1, and
    AGLU's scalars are U(0, 1) draws of the generator."""
    m = torch.nn.ModuleDict({"dy": extra.DySample(16), "mg": edgeline.MulGate(16, 16),
                             "wt": extra.WTConv2d(8, 8, 5, 1, True, 2), "ag": activation.AGLU()})
    tasks.init_weights(m, torch.Generator().manual_seed(0))
    assert not m["dy"].offset.weight.any() and not m["dy"].offset.bias.any()
    assert not m["mg"].mix.weight.any() and not m["mg"].bn.weight.any()
    assert m["mg"].f1.weight.abs().max() > 0
    torch.testing.assert_close(m["mg"].gamma, torch.full((16,), 1e-2))
    assert (m["wt"].base_scale.weight == 1.0).all()
    assert all((s.weight == 0.1).all() for s in m["wt"].wavelet_scale)
    one, two = activation.AGLU(), activation.AGLU()
    for a in (one, two):
        tasks.init_weights(a, torch.Generator().manual_seed(0))
    assert 0 < float(one.lambd.detach()) < 1 and 0 < float(one.kappa.detach()) < 1
    assert torch.equal(one.kappa, two.kappa) and not torch.equal(one.kappa, one.lambd)


def test_wtconv_and_channel_keepers_refuse_other_widths():
    for make in (lambda: extra.WTConv2d(8, 16), lambda: edgeline.MulGate(8, 16),
                 lambda: edgeline.RHJM(8, 16)):
        with pytest.raises(ValueError, match="keeps its channels"):
            make()
