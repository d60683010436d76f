"""Blocks of the PyTorch port against the JAX package, one by one, on the CPU in f32.

Each case builds the JAX module, initialises it, perturbs what init leaves
trivial (BatchNorm statistics, scales and shifts; the wavelet gamma, which
starts at 0, and alpha), carries the variables into the port module with
`from_jax_variables`, and feeds both the same numpy input (NHWC to JAX,
NCHW to the port). JAX modules run under `bn_config()`, the detection
model's BatchNorm convention (eps 1e-3) that every port BatchNorm uses.

Tolerances: 1e-5 for single fixed-weight ops (DWT, resize, DFL, top-k,
anchors), where only f32 rounding differs; 1e-4 for learned conv stacks,
where XLA and PyTorch's CPU convolutions sum fan-ins of up to 9 x 128 terms
in different orders through several layers.
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
from edgeyolo_tpu.nn.modules import head as jhead
from edgeyolo_tpu.ops import boxes as jboxes
from edgeyolo_tpu.ops.nms import non_max_suppression as jax_nms
from edgeyolo_tpu_torch.nn.modules import block, conv, edgeline, head
from edgeyolo_tpu_torch.ops import boxes
from edgeyolo_tpu_torch.ops.nms import non_max_suppression
from edgeyolo_tpu_torch.utils.convert import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

OP_ATOL = 1e-5
STACK_ATOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _perturb(flat, seed=0):
    rs = np.random.RandomState(seed)
    out = {}
    for k, a in flat.items():
        a = np.asarray(a)
        if k[-1] == "gamma":
            a = np.float32(rs.uniform(0.3, 0.8))
        elif k[-1] == "alpha":
            a = rs.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        elif k[-1] == "mean":
            a = (rs.randn(*a.shape) * 0.1).astype(np.float32)
        elif k[-1] == "var":
            a = rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k[0] == "params" and k[-1] in ("scale", "bias"):
            a = (a + rs.randn(*a.shape) * 0.1).astype(np.float32)
        out[k] = a
    return out


def _run_pair(jmod, tmod, x, **call_kw):
    """Init + perturb the JAX module, load the port module, run both on x (NHWC numpy)."""
    xj = jnp.asarray(x)
    with jconv.bn_config():  # compiled: one XLA program each, not one per eager op
        v = jax.jit(lambda k, a: jmod.init(k, a, **call_kw))(jax.random.PRNGKey(0), xj)
        flat = _perturb(traverse_util.flatten_dict(jax.device_get(v)))
        yj = jax.jit(lambda w, a: jmod.apply(w, a, **call_kw))(traverse_util.unflatten_dict(flat),
                                                                xj)
    missing, unexpected = tmod.load_state_dict(from_jax_variables(flat), strict=False)
    assert not unexpected and not [k for k in missing if "dfl" not in k]
    with torch.no_grad():
        yt = tmod.eval()(_nchw(x))
    return yj, yt


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (id, JAX module, port module, input NHWC shape)
BLOCKS = [
    ("ConvBN_k3s2", jconv.ConvBN(16, 3, 2), conv.ConvBN(8, 16, 3, 2), (2, 16, 16, 8)),
    ("DWConv", jconv.DWConv(16, 3), conv.DWConv(16, 16, 3), (2, 8, 8, 16)),
    ("DSConv_d2", jconv.DSConv(24, 5, d=2), conv.DSConv(16, 24, 5, d=2), (2, 12, 12, 16)),
    ("Bottleneck", jblock.Bottleneck(16), block.Bottleneck(16, 16), (2, 8, 8, 16)),
    ("C3k2", jblock.C3k2(c2=32, n=1, c3k=False, e=0.25), block.C3k2(16, 32, 1, False, 0.25), (2, 8, 8, 16)),
    ("C3k2_c3k", jblock.C3k2(c2=32, n=1, c3k=True), block.C3k2(16, 32, 1, True), (2, 8, 8, 16)),
    ("SPPF", jblock.SPPF(32, 5), block.SPPF(32, 32, 5), (2, 8, 8, 32)),
    ("WaveletEnhancer", jedge.WaveletEnhancer(16), edgeline.WaveletEnhancer(16), (2, 16, 16, 16)),
    ("WaveletEnhancer_ds", jedge.WaveletEnhancer(16, use_ds=True),
     edgeline.WaveletEnhancer(16, use_ds=True), (2, 16, 16, 16)),
    # odd size: the DWT's general path and the non-2x bilinear resize
    ("WaveletEnhancer_odd", jedge.WaveletEnhancer(16), edgeline.WaveletEnhancer(16), (2, 15, 15, 16)),
    ("DSC3K2_Wavelet", jedge.DSC3K2_Wavelet(c2=32, n=1, dsc3k=False, e=0.25),
     edgeline.DSC3K2_Wavelet(16, 32, 1, False, 0.25), (2, 16, 16, 16)),
    ("DSC3K2_Wavelet_dsc3k", jedge.DSC3K2_Wavelet(c2=32, n=1, dsc3k=True),
     edgeline.DSC3K2_Wavelet(32, 32, 1, True), (2, 8, 8, 32)),
    ("C2PSA_LinearAttention", jedge.C2PSA_LinearAttention(128, 1),
     edgeline.C2PSA_LinearAttention(128, 128, 1), (2, 5, 5, 128)),
    ("C2PSA_LinearAttention_2heads", jedge.C2PSA_LinearAttention(64, 2, num_heads=2),
     edgeline.C2PSA_LinearAttention(64, 64, 2, num_heads=2), (2, 7, 6, 64)),
]


@pytest.mark.parametrize("jmod,tmod,shape", [b[1:] for b in BLOCKS], ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(jmod, tmod, shape):
    x = _x(shape)
    yj, yt = _run_pair(jmod, tmod, x)
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj), atol=STACK_ATOL)


def test_wavelet_branch_is_live():
    """gamma != 0 after _perturb, so the enhancer output differs from its input."""
    x = _x((1, 8, 8, 16))
    _, yt = _run_pair(jedge.WaveletEnhancer(16), edgeline.WaveletEnhancer(16), x)
    assert float((yt - _nchw(x)).abs().max()) > 1e-2


DWT_CASES = [("haar", (2, 8, 8, 3)), ("haar", (2, 9, 7, 3)), ("db2", (2, 12, 12, 3))]


@pytest.mark.parametrize("wave,shape", DWT_CASES, ids=[f"{w}-{s[1]}x{s[2]}" for w, s in DWT_CASES])
def test_dwt_matches_jax(wave, shape):
    x = _x(shape)
    bands_j = jedge.DWT2D(wave).apply({}, jnp.asarray(x))
    bands_t = edgeline.DWT2D(wave)(_nchw(x))
    for bj, bt in zip(bands_j, bands_t):
        np.testing.assert_allclose(_nhwc(bt), np.asarray(bj), atol=OP_ATOL)


@pytest.mark.parametrize("size", [(12, 10), (9, 11)], ids=["exact2x", "general"])
def test_bilinear_resize_matches_jax(size):
    x = _x((2, 6, 5, 3))
    yj = jedge._bilinear_resize(jnp.asarray(x), size)
    yt = edgeline._bilinear_resize(_nchw(x), size)
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj), atol=OP_ATOL)


def test_dfl_decode_matches_jax():
    logits = _x((3, 7, 64)) * 3
    yj = jblock.dfl_decode(jnp.asarray(logits), 16)
    yt = block.DFL(16)(torch.from_numpy(logits))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=OP_ATOL)


def test_anchors_and_dist2bbox_match_jax():
    shapes, strides = [(4, 6), (2, 3)], [8, 16]
    pj, sj = jboxes.make_anchors(shapes, strides)
    pt, st = boxes.make_anchors(shapes, strides)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dist = np.abs(_x((2, pt.shape[0], 4)))
    for xywh in (True, False):
        bj = jboxes.dist2bbox(jnp.asarray(dist), pj[None], xywh=xywh)
        bt = boxes.dist2bbox(torch.from_numpy(dist), pt[None], xywh=xywh)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=OP_ATOL)


def test_topk_small_with_ties_matches_jax():
    rows = np.array([[0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
                     [0.1, 0.3, 0.3, 0.1, 0.1, 0.1],
                     [1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                     [0.2, 0.1, 0.3, 0.15, 0.05, 0.2]], np.float32)
    x = np.concatenate([rows, np.random.RandomState(2).rand(4, 6).astype(np.float32)])
    yj = jhead.GF2Detect._topk_small(jnp.asarray(x), 4)
    yt = head.topk_small(torch.from_numpy(x), 4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=OP_ATOL)
    # duplicates keep their multiplicity: a uniform row gives four equal values
    np.testing.assert_allclose(yt[0].numpy(), 0.25, atol=1e-6)


@pytest.mark.parametrize("legacy", [False, True], ids=["dw_cls_tower", "legacy_cls_tower"])
def test_head_matches_jax(legacy):
    ch, nc = (16, 32, 64), 5
    xs = [_x((2, s, s, c), seed=i) for i, (s, c) in enumerate(zip((8, 4, 2), ch))]
    jm = jhead.GFLHeadv2_uniH(nc=nc, ch=ch, legacy=legacy)
    tm = head.GFLHeadv2_uniH(nc=nc, ch=ch, legacy=legacy)
    xj = [jnp.asarray(x) for x in xs]
    with jconv.bn_config():  # compiled, as _run_pair
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), xj)
        flat = _perturb(traverse_util.flatten_dict(jax.device_get(v)))
        oj = jax.jit(jm.apply)(traverse_util.unflatten_dict(flat), xj)
    missing, unexpected = tm.load_state_dict(from_jax_variables(flat), strict=False)
    assert missing == ["dfl.conv.weight"] and not unexpected
    with torch.no_grad():
        ot = tm.eval()([_nchw(x) for x in xs])
    for fj, ft in zip(oj["feats"], ot["feats"]):
        np.testing.assert_allclose(_nhwc(ft), np.asarray(fj), atol=STACK_ATOL)
    for qj, qt in zip(oj["quality"], ot["quality"]):
        np.testing.assert_allclose(_nhwc(qt), np.asarray(qj), atol=STACK_ATOL)
    pj, pt = np.asarray(oj["pred"]), ot["pred"].numpy()
    assert pt.shape == pj.shape == (2, 8 * 8 + 4 * 4 + 2 * 2, 4 + nc)
    np.testing.assert_allclose(pt[..., :4], pj[..., :4], atol=1e-3)  # px, boxes up to 64
    np.testing.assert_allclose(pt[..., 4:], pj[..., 4:], atol=STACK_ATOL)


def _crafted_pred(seed=0, b=2, a=64, nc=3):
    """Clusters of overlapping boxes with mixed classes and scores around the gate."""
    rs = np.random.RandomState(seed)
    centres = rs.uniform(20, 100, (b, 6, 2))
    pick = rs.randint(0, 6, (b, a))
    xy = np.take_along_axis(centres, pick[..., None].repeat(2, -1), axis=1) + rs.randn(b, a, 2) * 4
    wh = rs.uniform(15, 30, (b, a, 2))
    scores = rs.uniform(0, 1, (b, a, nc)) ** 2
    return np.concatenate([xy, wh, scores], -1).astype(np.float32)


NMS_CASES = [
    dict(method="matrix"),
    dict(method="scan"),
    dict(method="matrix", agnostic=True),
    dict(method="matrix", classes=(0, 2)),
    dict(method="matrix", iou_thres=0.3, max_det=10, max_nms=32),
]


@pytest.mark.parametrize("kw", NMS_CASES, ids=["matrix", "scan", "agnostic", "classes", "tight"])
def test_nms_matches_jax(kw):
    pred = _crafted_pred()
    kw = {"conf_thres": 0.25, "iou_thres": 0.5, "max_det": 40, "max_nms": 64, **kw}
    dj, nj = jax_nms(jnp.asarray(pred), **kw)
    dt, nt = non_max_suppression(torch.from_numpy(pred), **kw)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.min()) > 1  # the clusters leave several boxes per image
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=OP_ATOL)


def test_nms_matrix_equals_scan():
    pred = torch.from_numpy(_crafted_pred(seed=3, a=128))
    kw = dict(conf_thres=0.1, iou_thres=0.45, max_det=50, max_nms=128)
    dm, nm = non_max_suppression(pred, method="matrix", **kw)
    ds, ns = non_max_suppression(pred, method="scan", **kw)
    torch.testing.assert_close(nm, ns)
    torch.testing.assert_close(dm, ds, rtol=0, atol=0)
