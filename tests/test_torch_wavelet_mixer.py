"""The wavelet HyperACE of yolov13-test in the PyTorch port against the JAX
package, module by module, on the CPU in f32 at narrow widths: IHaarDWT2D,
WaveletMixerMultiLevel, C3AW_MLM, SeqMixer1D, LocalSS2DContext and
HyperACE_Wavelet (JAX edgeyolo_tpu/nn/modules/msla_lgl.py).

Variables come from `jax.eval_shape` of the JAX module's init, filled from a
seeded numpy generator with every zero-initialised gate opened
(tests/test_torch_v13_modules.py's `_variables`), and are carried into the
port with `from_jax_variables` (1-D conv kernels (k, 1, C) -> (C, 1, k)).

Tolerance: 1e-4, tests/test_torch_v13_modules.py's for learned conv stacks;
the inverse Haar alone, one (4, 4) product, 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_v13_modules import ATOL, _from_port, _inputs, _to_port, _variables, _x

from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import msla_lgl as jmsla
from edgeyolo_tpu.ops.wavelets import idwt2d_kernel as jidwt2d_kernel
from edgeyolo_tpu_torch.nn.modules import edgeline, msla_lgl
from edgeyolo_tpu_torch.ops import linear_attention as la
from edgeyolo_tpu_torch.ops.wavelets import idwt2d_kernel
from edgeyolo_tpu_torch.utils.convert import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

# (id, JAX module, port module, input shape(s), layout), as test_torch_v13_modules.CASES.
# The mixer's sides: 8 x 8 runs both levels down to a 2 x 2 LL band; 4 x 2 and
# 2 x 8 stop after one level (a side below 2), so JAX creates no level-1
# mixers; 16 x 8 runs three levels.
CASES = [
    ("WaveletMixer_8x8", jmsla.WaveletMixerMultiLevel(16), msla_lgl.WaveletMixerMultiLevel(16),
     (2, 8, 8, 16), "nhwc"),
    ("WaveletMixer_4x2_stops", jmsla.WaveletMixerMultiLevel(16),
     msla_lgl.WaveletMixerMultiLevel(16), (2, 4, 2, 16), "nhwc"),
    ("WaveletMixer_2x8_stops", jmsla.WaveletMixerMultiLevel(8, 2, 1),
     msla_lgl.WaveletMixerMultiLevel(8, 2, 1), (2, 2, 8, 8), "nhwc"),
    ("WaveletMixer_3levels", jmsla.WaveletMixerMultiLevel(16, 3),
     msla_lgl.WaveletMixerMultiLevel(16, 3), (2, 16, 8, 16), "nhwc"),
    ("C3AW_MLM", jmsla.C3AW_MLM(32, 1.0), msla_lgl.C3AW_MLM(24, 32, 1.0), (2, 8, 8, 24), "nhwc"),
    ("C3AW_MLM_e05", jmsla.C3AW_MLM(32, 0.5), msla_lgl.C3AW_MLM(32, 32, 0.5), (2, 4, 4, 32),
     "nhwc"),
    ("LocalSS2DContext", jmsla.LocalSS2DContext(16), msla_lgl.LocalSS2DContext(16),
     (2, 6, 5, 16), "nhwc"),
    ("HyperACE_Wavelet", jmsla.HyperACE_Wavelet(32, 1, 4, True, True, 0.5, 1.0, "both"),
     msla_lgl.HyperACE_Wavelet(16, 32, 1, 4, True, True, 0.5, 1.0, "both"),
     ((2, 16, 16, 16), (2, 8, 8, 16), (2, 4, 4, 32)), "list"),
    ("HyperACE_Wavelet_dsbottleneck_n2",
     jmsla.HyperACE_Wavelet(32, 2, 4, False, False, 0.5, 1.0, "max", False),
     msla_lgl.HyperACE_Wavelet(16, 32, 2, 4, False, False, 0.5, 1.0, "max", False),
     ((2, 16, 16, 16), (2, 8, 8, 16), (2, 4, 4, 16)), "list"),
    ("Wavelet_SS2D", jmsla.Wavelet_SS2D(32, 1, 4), msla_lgl.Wavelet_SS2D(16, 32, 1, 4),
     ((2, 8, 8, 16), (2, 4, 4, 16), (2, 2, 2, 32)), "list"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_module_matches_jax(case):
    name, jmod, tmod, shape, layout = case
    x = _inputs(shape)
    xj = [jnp.asarray(a) for a in x] if layout == "list" else jnp.asarray(x)
    flat = _variables(jmod, xj)
    with jconv.bn_config():
        yj = jax.jit(jmod.apply)(traverse_util.unflatten_dict(flat), xj)
    missing, unexpected = tmod.load_state_dict(from_jax_variables(flat), strict=False)
    # every parameter came across from JAX, but those of the level-1 mixers
    # where the early stop skips that level (JAX never creates them)
    assert not unexpected and all(k.startswith("mix.1.") for k in missing)
    assert bool(missing) == name.endswith("_stops")
    with torch.no_grad():
        yt = tmod.eval()(_to_port(x, layout))
    np.testing.assert_allclose(_from_port(yt, "nhwc"), np.asarray(yj), atol=ATOL)


def test_seq_mixer_matches_jax():
    """(B, N, C) tokens to JAX, (B, C, N) to the port: the 'SAME' padded
    depthwise 1-D conv (k 7, pad 3) and the dense gate."""
    jm, tm = jmsla.SeqMixer1D(16), msla_lgl.SeqMixer1D(16)
    x = _x((2, 12, 16))
    flat = _variables(jm, jnp.asarray(x))
    assert flat[("params", "mix", "kernel")].shape == (7, 1, 16)
    yj = np.asarray(jax.jit(jm.apply)(traverse_util.unflatten_dict(flat), jnp.asarray(x)))
    tm.load_state_dict(from_jax_variables(flat), strict=True)
    assert tm.mix.padding == (3,) and tm.mix.groups == 16
    with torch.no_grad():
        yt = tm(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))).numpy()
    np.testing.assert_allclose(yt.transpose(0, 2, 1), yj, atol=ATOL)


def test_inverse_haar_matches_jax_and_inverts_the_analysis():
    assert np.array_equal(idwt2d_kernel("haar"), jidwt2d_kernel("haar"))
    bands = [_x((2, 3, 5, 8), seed=s) for s in range(4)]  # NHWC, 3 x 5 bands
    yj = jmsla.IHaarDWT2D().apply({}, tuple(jnp.asarray(b) for b in bands))
    yt = msla_lgl.IHaarDWT2D()(tuple(_to_port(b, "nhwc") for b in bands))
    assert yt.shape == (2, 8, 6, 10)
    np.testing.assert_allclose(_from_port(yt, "nhwc"), np.asarray(yj), atol=1e-6)
    x = torch.from_numpy(_x((2, 4, 6, 10)))
    torch.testing.assert_close(msla_lgl.IHaarDWT2D()(edgeline.DWT2D("haar")(x)), x,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("side", [7, 5, 6])
def test_mixer_raises_where_jax_raises(side):
    """An odd side above 1 leaves the inverse a band short in JAX (7 -> 3 -> 1
    -> 2 against 3; 5 -> 2 -> 4 against 5; 6 -> 3 -> 1 -> 2 against 3): both
    packages raise there."""
    x = _x((1, side, side, 8))
    with pytest.raises((ValueError, TypeError)):
        jax.eval_shape(lambda: jmsla.WaveletMixerMultiLevel(8).init(jax.random.PRNGKey(0),
                                                                   jnp.asarray(x)))
    with pytest.raises(RuntimeError):
        msla_lgl.WaveletMixerMultiLevel(8).eval()(_to_port(x, "nhwc"))


def test_the_two_branches_read_the_middle_chunk_with_their_own_weights():
    m = msla_lgl.HyperACE_Wavelet(16, 32, 1, 4).eval()
    seen = []
    for name in ("branch1", "branch2"):
        getattr(m, name).register_forward_hook(lambda _m, i, _o: seen.append(i[0]))
    xs = [torch.from_numpy(a) for a in (_x((2, 16, 16, 16)), _x((2, 16, 8, 8), 2),
                                        _x((2, 32, 4, 4), 3))]
    with torch.no_grad():
        m(xs)
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    assert isinstance(m.branch1, msla_lgl.C3AW_MLM) and not any(
        a is b for a, b in zip(m.branch1.parameters(), m.branch2.parameters()))


@pytest.mark.parametrize("hw,tokens", [((8, 8), 4), ((4, 4), 1), ((1, 1), 1), ((12, 8), 6)])
def test_ll_attention_runs_once_on_the_coarsest_band(monkeypatch, hw, tokens):
    """One attention call per mixer, on the LL band after the levels that ran:
    at 64 px yolov13-test's mixers see 4 x 4, so the kernel gets N = 1."""
    m = msla_lgl.WaveletMixerMultiLevel(16).eval()
    calls = []
    monkeypatch.setattr(edgeline, "linear_attention",
                        lambda q, k, v: (calls.append(tuple(q.shape)),
                                         la.linear_attention(q, k, v))[1])
    with torch.no_grad():
        m(torch.from_numpy(_x((2, 16, *hw))))
    assert calls == [(2, tokens, 2, 8)]
