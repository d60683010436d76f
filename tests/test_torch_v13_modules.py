"""The YOLO11 and YOLOv13 modules of the PyTorch port against the JAX package,
one by one, on the CPU in f32 at narrow widths.

Each case builds the JAX module, takes its variable shapes from
`jax.eval_shape` of its init (a real init costs seconds per module) and fills
them from a seeded numpy generator: kernels U(+-1/sqrt(fan_in)) as the JAX
KERNEL_INIT draws them, hyperedge prototypes xavier-uniform, and what init
would leave trivial perturbed (BatchNorm statistics, scales and shifts; the
zero-init gates: the FullPAD `gate`, MSLA's `gamma` and A2C2f's layer scale;
MSLA's `scale_weights`). It carries the variables into the port module with
`from_jax_variables` (dense kernels transposed, plain parameters by name),
and feeds both the same numpy input: NHWC to JAX and NCHW to the port, or
(B, N, D) tokens to both. JAX modules run under `bn_config()`, the detection
model's BatchNorm convention that every port BatchNorm uses.

Tolerance: 1e-4, that of tests/test_torch_modules.py for learned conv
stacks (XLA and PyTorch's CPU kernels sum fan-ins in different orders
through several layers); the Detect decode's boxes, up to 64 px, 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from edgeyolo_tpu.nn.modules import block as jblock
from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import edgeline as jedge
from edgeyolo_tpu.nn.modules import extra as jextra
from edgeyolo_tpu.nn.modules import head as jhead
from edgeyolo_tpu.nn.modules import msla_lgl as jmsla
from edgeyolo_tpu_torch.nn.modules import block, edgeline, extra, head, msla_lgl
from edgeyolo_tpu_torch.utils.convert import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

ATOL = 1e-4


def _leaf(rs, path, shape):
    leaf = path[-1]
    if leaf == "kernel":  # conv HWIO or dense (in, out): fan_in is all but the last axis
        bound = float(np.prod(shape[:-1])) ** -0.5
        return rs.uniform(-bound, bound, shape)
    if leaf == "prototype_base":
        bound = (6.0 / sum(shape)) ** 0.5
        return rs.uniform(-bound, bound, shape)
    if leaf in ("gamma", "gate"):  # open the zero-init gates (A2C2f's is per channel)
        return rs.uniform(0.3, 0.8, shape)
    if leaf == "scale_weights":
        return 1.0 + rs.uniform(-0.3, 0.3, shape)
    if leaf == "var":
        return rs.uniform(0.5, 1.5, shape)
    if leaf == "scale":
        return 1.0 + rs.randn(*shape) * 0.1
    if leaf in ("bias", "mean"):
        return rs.randn(*shape) * 0.1
    raise KeyError(f"no fill for {'/'.join(path)}")


def _variables(jmod, xj, seed=0):
    """{(collection, *path): array} for jmod, filled from a seeded generator."""
    with jconv.bn_config():
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), xj))
    rs = np.random.RandomState(seed)
    return {k: _leaf(rs, k, s.shape).astype(np.float32)
            for k, s in traverse_util.flatten_dict(shapes).items()}


def _to_port(x, layout):
    if layout == "tokens":
        return torch.from_numpy(x)
    if layout == "list":
        return [_to_port(a, "nhwc") for a in x]
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _from_port(y, layout):
    y = y.detach().numpy()
    return y if layout == "tokens" else y.transpose(0, 2, 3, 1)


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _inputs(shapes):
    if isinstance(shapes[0], tuple):
        return [_x(s, seed=i + 1) for i, s in enumerate(shapes)]
    return _x(shapes)


# (id, JAX module, port module, input shape(s), layout): "nhwc" maps, "tokens"
# (B, N, D) on both sides, "list" several NHWC maps. Heads are apart (below).
CASES = [
    ("Attention", jblock.Attention(64, 2, 0.5), block.Attention(64, 2, 0.5), (2, 5, 6, 64), "nhwc"),
    ("PSABlock", jblock.PSABlock(64, 0.5, 1), block.PSABlock(64, 0.5, 1), (2, 4, 4, 64), "nhwc"),
    ("C2PSA", jblock.C2PSA(128, 1), block.C2PSA(128, 128, 1), (2, 5, 5, 128), "nhwc"),
    ("DSC3K2", jedge.DSC3K2(c2=32, n=1, dsc3k=False, e=0.25),
     edgeline.DSC3K2(16, 32, 1, False, 0.25), (2, 8, 8, 16), "nhwc"),
    ("DSC3K2_dsc3k", jedge.DSC3K2(c2=32, n=1, dsc3k=True),
     edgeline.DSC3K2(32, 32, 1, True), (2, 8, 8, 32), "nhwc"),
    ("AAttn", jextra.AAttn(64, 2), extra.AAttn(64, 2), (2, 4, 6, 64), "nhwc"),
    ("AAttn_area4", jextra.AAttn(64, 2, 4), extra.AAttn(64, 2, 4), (2, 8, 6, 64), "nhwc"),
    # 25 tokens do not split into 4 areas: one area, as in JAX
    ("AAttn_area_fallback", jextra.AAttn(32, 1, 4), extra.AAttn(32, 1, 4), (2, 5, 5, 32), "nhwc"),
    ("ABlock", jextra.ABlock(64, 2, 1.2, 2), extra.ABlock(64, 2, 1.2, 2), (2, 4, 4, 64), "nhwc"),
    ("A2C2f_area4", jextra.A2C2f(c2=64, n=1, a2=True, area=4),
     extra.A2C2f(32, 64, 1, True, 4), (2, 8, 8, 32), "nhwc"),
    ("A2C2f_residual", jextra.A2C2f(c2=64, n=2, a2=True, area=1, residual=True, mlp_ratio=1.5),
     extra.A2C2f(64, 64, 2, True, 1, True, 1.5), (2, 4, 4, 64), "nhwc"),
    ("A2C2f_c3k", jextra.A2C2f(c2=32, n=1, a2=False), extra.A2C2f(16, 32, 1, False),
     (2, 6, 6, 16), "nhwc"),
    ("AdaHyperedgeGen", jextra.AdaHyperedgeGen(32, 4, 4),
     extra.AdaHyperedgeGen(32, 4, 4), (2, 20, 32), "tokens"),
    ("AdaHGConv", jextra.AdaHGConv(32, 4, 2), extra.AdaHGConv(32, 4, 2), (2, 20, 32), "tokens"),
    ("AdaHGConv_mean", jextra.AdaHGConv(32, 6, 4, context="mean"),
     extra.AdaHGConv(32, 6, 4, context="mean"), (2, 12, 32), "tokens"),
    ("C3AH", jextra.C3AH(32, 1.0, 4), extra.C3AH(24, 32, 1.0, 4), (2, 6, 6, 24), "nhwc"),
    ("FuseModule", jextra.FuseModule(16, True), extra.FuseModule(16, True),
     ((2, 16, 16, 16), (2, 8, 8, 16), (2, 4, 4, 32)), "list"),
    ("HyperACE", jextra.HyperACE(32, 1, 4, True, True, 0.5, 1.0, "both"),
     extra.HyperACE(16, 32, 1, 4, True, True, 0.5, 1.0, "both"),
     ((2, 16, 16, 16), (2, 8, 8, 16), (2, 4, 4, 32)), "list"),
    ("HyperACE_dsbottleneck_max", jextra.HyperACE(32, 2, 4, False, False, 0.5, 1.0, "max", False),
     extra.HyperACE(16, 32, 2, 4, False, False, 0.5, 1.0, "max", False),
     ((2, 16, 16, 16), (2, 8, 8, 16), (2, 4, 4, 16)), "list"),
    ("DownsampleConv", jextra.DownsampleConv(16), extra.DownsampleConv(16), (2, 8, 8, 16), "nhwc"),
    ("DownsampleConv_keep", jextra.DownsampleConv(16, False), extra.DownsampleConv(16, False),
     (2, 7, 7, 16), "nhwc"),
    ("FullPAD_Tunnel", jextra.FullPAD_Tunnel(), extra.FullPAD_Tunnel(),
     ((2, 4, 4, 16), (2, 4, 4, 16)), "list"),
    ("MSLA", jmsla.MSLA(64, 2), msla_lgl.MSLA(64, 2), (2, 8, 8, 64), "nhwc"),
    ("DSC3K2_MSLA", jmsla.DSC3K2_MSLA(c2=64, n=1, e=0.25), msla_lgl.DSC3K2_MSLA(32, 64, 1, e=0.25),
     (2, 8, 8, 32), "nhwc"),
    ("DSC3K2_MSLA_dsc3k", jmsla.DSC3K2_MSLA(c2=32, n=1, dsc3k=True),
     msla_lgl.DSC3K2_MSLA(32, 32, 1, True), (2, 6, 6, 32), "nhwc"),
]


def _run_pair(jmod, tmod, x, layout):
    xj = [jnp.asarray(a) for a in x] if layout == "list" else jnp.asarray(x)
    flat = _variables(jmod, xj)
    with jconv.bn_config():
        yj = jax.jit(jmod.apply)(traverse_util.unflatten_dict(flat), xj)
    missing, unexpected = tmod.load_state_dict(from_jax_variables(flat), strict=False)
    assert not unexpected and not [k for k in missing if "dfl" not in k], (missing, unexpected)
    with torch.no_grad():
        yt = tmod.eval()(_to_port(x, layout))
    return flat, yj, yt


@pytest.mark.parametrize("jmod,tmod,shape,layout", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_module_matches_jax(jmod, tmod, shape, layout):
    x = _inputs(shape)
    flat, yj, yt = _run_pair(jmod, tmod, x, "tokens" if layout == "tokens" else layout)
    out_layout = "tokens" if layout == "tokens" else "nhwc"
    np.testing.assert_allclose(_from_port(yt, out_layout), np.asarray(yj), atol=ATOL)
    # every parameter of the port module was carried across from JAX
    assert {k for k in tmod.state_dict() if not k.endswith("num_batches_tracked")} == set(
        from_jax_variables(flat))


@pytest.mark.parametrize("case", ["MSLA", "FullPAD_Tunnel", "A2C2f_residual"])
def test_opened_gate_reaches_the_output(case):
    """With its gate at the value JAX's init gives (0 for the FullPAD gate and
    MSLA's gamma; for MSLA its scale weights at 0 mute every quarter; A2C2f's
    layer scale at 0), the output differs from the opened one's by more than
    the tolerance, so the cases above see the gated branch."""
    _, jmod, tmod, shape, layout = next(c for c in CASES if c[0] == case)
    x = _inputs(shape)
    _, _, yt = _run_pair(jmod, tmod, x, layout)
    with torch.no_grad():
        for name, p in tmod.named_parameters():
            if name.split(".")[-1] in ("gate", "gamma", "scale_weights"):
                p.zero_()
        shut = tmod(_to_port(x, layout))
    assert float((yt - shut).abs().max()) > 100 * ATOL


def test_participation_is_a_softmax_over_nodes():
    gen = extra.AdaHyperedgeGen(16, 5, 2).eval()
    a = gen(torch.from_numpy(_x((3, 11, 16))))
    assert a.shape == (3, 11, 5)
    torch.testing.assert_close(a.sum(dim=1), torch.ones(3, 5))


def test_hypergraph_runs_no_dropout_in_training():
    """JAX applies its dropout deterministically, so train mode gives the
    eval-mode participation (the port has no dropout to switch)."""
    gen = extra.AdaHyperedgeGen(16, 5, 2)
    x = torch.from_numpy(_x((2, 9, 16)))
    torch.testing.assert_close(gen.train()(x), gen.eval()(x), rtol=0, atol=0)


def test_msla_batches_its_quarters_into_one_attention_call(monkeypatch):
    m = msla_lgl.MSLA(64, 2).eval()
    calls = []
    forward = edgeline.LinearAttention.forward
    monkeypatch.setattr(edgeline.LinearAttention, "forward",
                        lambda self, x: (calls.append(tuple(x.shape)), forward(self, x))[1])
    with torch.no_grad():
        m(torch.from_numpy(_x((2, 64, 8, 8))))
    assert calls == [(8, 16, 8, 8)]  # the four quarters of 2 images, 16 channels each


@pytest.mark.parametrize("legacy", [False, True], ids=["dw_cls_tower", "legacy_cls_tower"])
def test_detect_matches_jax(legacy):
    ch, nc = (16, 32, 64), 5
    xs = [_x((2, s, s, c), seed=i) for i, (s, c) in enumerate(zip((8, 4, 2), ch))]
    jm = jhead.Detect(nc=nc, ch=ch, legacy=legacy)
    tm = head.Detect(nc=nc, ch=ch, legacy=legacy)
    xj = [jnp.asarray(x) for x in xs]
    flat = _variables(jm, xj)
    with jconv.bn_config():
        oj = jax.jit(jm.apply)(traverse_util.unflatten_dict(flat), xj)
    missing, unexpected = tm.load_state_dict(from_jax_variables(flat), strict=False)
    assert missing == ["dfl.conv.weight"] and not unexpected
    with torch.no_grad():
        ot = tm.eval()([_to_port(x, "nhwc") for x in xs])
    assert set(ot) == {"feats", "pred"}  # no quality
    for fj, ft in zip(oj["feats"], ot["feats"]):
        np.testing.assert_allclose(_from_port(ft, "nhwc"), np.asarray(fj), atol=ATOL)
    pj, pt = np.asarray(oj["pred"]), ot["pred"].numpy()
    assert pt.shape == pj.shape == (2, 8 * 8 + 4 * 4 + 2 * 2, 4 + nc)
    np.testing.assert_allclose(pt[..., :4], pj[..., :4], atol=1e-3)
    np.testing.assert_allclose(pt[..., 4:], pj[..., 4:], atol=ATOL)
    assert set(tm.train()([_to_port(x, "nhwc") for x in xs])) == {"feats"}
