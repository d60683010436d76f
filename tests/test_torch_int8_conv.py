"""The int8 convolution (ops/int8_conv.py, csrc/int8_conv.cu): its plain
version against an int64 reference, the dispatch, the wrapper's checks and,
on a card, the kernel against the plain version.

No JAX here, so the file also runs on a machine with a CUDA card:

    python -m pytest --noconftest -m cuda tests/test_torch_int8_conv.py

Tolerance: none. The plain version's float64 conv of int8 codes is exact
(every partial sum is an integer below 2^53), and its epilogue is one
rounded f32 product and one rounded f32 sum, as the kernel's.
"""

import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edgeyolo_tpu_torch.ops import _build
from edgeyolo_tpu_torch.ops import int8_conv as ic
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

# (N, C, H, W, O, k, stride, pad, dilation, groups): the flagship's kinds (the
# 3-channel stem, 1x1 and 3x3 dense, depthwise 3/5/7), yolov13's grouped 3x3,
# a deep 3x3 whose sums pass 2^24, ragged channel quads and output chunks
CASES = [(2, 3, 17, 15, 16, 3, 2, 1, 1, 1), (2, 16, 9, 9, 32, 1, 1, 0, 1, 1),
         (1, 32, 8, 8, 19, 3, 1, 1, 1, 1), (2, 24, 11, 10, 24, 5, 1, 2, 1, 24),
         (1, 16, 12, 12, 16, 7, 2, 3, 1, 16), (1, 32, 10, 10, 16, 3, 1, 2, 2, 4),
         (2, 12, 7, 9, 12, 3, 1, 1, 1, 2), (1, 40, 6, 6, 20, 3, 2, 1, 1, 2),
         (1, 512, 5, 5, 8, 3, 1, 1, 1, 1)]
IDS = ["x".join(map(str, c)) for c in CASES]


def _inputs(case, dtype, bias_dtype, device="cpu", seed=0, saturate=False):
    n, c, h, w, o, k, _s, _p, _d, g = case
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, c, h, w, generator=gen) * 2).to(dtype)
    wq = torch.randint(-127, 128, (o, c // g, k, k), generator=gen, dtype=torch.int8)
    if saturate:  # every code and weight at 127 but a few at -127: the largest sums
        x = torch.where(torch.rand(x.shape, generator=gen) < 0.01, -10.0, 10.0).to(dtype)
        wq = torch.full_like(wq, 127)
    scale = torch.rand(o, generator=gen) * 1e-3
    bias = None if bias_dtype is None else torch.randn(o, generator=gen).to(bias_dtype)
    sx = np.float32(float(x.float().abs().max()) / 127.0)
    rcp = float(np.float32(1.0) / sx)
    return [t if t is None else t.to(device) for t in (x, wq, scale, bias)] + [rcp]


def _int64_sums(xq: torch.Tensor, wq: torch.Tensor, stride, pad, dil, groups) -> torch.Tensor:
    """The conv as int64 sums of int64 products, by unfold."""
    n, c, h, w = xq.shape
    o, cg, kh, kw = wq.shape
    cols = F.unfold(xq.double(), (kh, kw), dilation=dil, padding=pad, stride=stride)
    cols = cols.long().view(n, groups, cg * kh * kw, -1)
    wm = wq.long().view(groups, o // groups, cg * kh * kw)
    acc = torch.einsum("ngkl,gok->ngol", cols, wm).reshape(n, o, -1)
    oh = (h + 2 * pad[0] - dil[0] * (kh - 1) - 1) // stride[0] + 1
    return acc.view(n, o, oh, -1)


@pytest.mark.parametrize("saturate", [False, True], ids=["randn", "saturated"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_version_is_exact(case, saturate):
    x, wq, scale, bias, rcp = _inputs(case, torch.float32, torch.float32, saturate=saturate)
    *_, s, p, d, g = case
    codes = ic.quantize_codes(x, rcp)
    assert codes.abs().max() <= 127 and torch.equal(codes, codes.round())
    acc = _int64_sums(codes.long(), wq, (s, s), (p, p), (d, d), g)
    want = acc.float() * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    y = ic.int8_conv_reference(x, wq, scale, rcp, bias, (s, s), (p, p), (d, d), g)
    assert torch.equal(y, want)
    if saturate and case[1] == 512:
        assert acc.abs().max() > 2 ** 24  # the depth at which f32 sums would round


def test_quantize_codes_multiply_by_the_f32_reciprocal():
    x = torch.tensor([0.5, -0.5, 1.5, 2.5, 1000.0, -1000.0, 0.0])
    assert ic.quantize_codes(x, 1.0).tolist() == [0.0, -0.0, 2.0, 2.0, 127.0, -127.0, 0.0]
    sx = np.float32(3.7 / 127.0)
    rcp = float(np.float32(1.0) / sx)
    x = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(np.float32) * 3)
    assert torch.equal(ic.quantize_codes(x, rcp),
                       torch.from_numpy(np.clip(np.rint(x.numpy() * np.float32(rcp)), -127, 127)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(dtype):
    x, wq, scale, bias, rcp = _inputs(CASES[2], dtype, dtype)
    before = ic.int8_conv_kernel.launches
    y = ic.int8_conv(x, wq, ic.pack_weights(wq), scale, rcp, bias, (1, 1), (1, 1), (1, 1), 1)
    assert y.dtype == dtype and y.shape == (1, 19, 8, 8)
    assert torch.equal(y, ic.int8_conv_reference(x, wq, scale, rcp, bias, (1, 1), (1, 1),
                                                 (1, 1), 1))
    assert ic.int8_conv_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    x, wq, scale, bias, rcp = _inputs(CASES[1], torch.float32, None)
    with pytest.raises(ValueError, match="CUDA"):
        ic.int8_conv_kernel(x, wq, ic.pack_weights(wq), scale, rcp)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ic.plan((1, 8, 4, 4), (8, 8, 1, 1), (1, 1), (0, 0), (1, 1), 1, torch.float16, None, 1.0)
    with pytest.raises(ValueError, match="groups"):
        ic.plan((1, 8, 4, 4), (8, 3, 1, 1), (1, 1), (0, 0), (1, 1), 2, torch.float32, None, 1.0)
    with pytest.raises(ValueError, match="bias"):
        ic.plan((1, 8, 4, 4), (8, 8, 1, 1), (1, 1), (0, 0), (1, 1), 1, torch.float32,
                torch.int32, 1.0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_picks_the_path_and_sizes_the_scratch(case):
    n, c, h, w, o, k, s, p, d, g = case
    args, scratch = ic.plan((n, c, h, w), (o, c // g, k, k), (s, s), (p, p), (d, d), g,
                            torch.float32, None, 1.0)
    ref = F.conv2d(torch.zeros(n, c, h, w), torch.zeros(o, c // g, k, k), None, s, p, d, g)
    assert (args.OH, args.OW) == ref.shape[2:]
    cg = c // g
    assert args.Q == (-(-cg // 4) if cg >= 4 else 0)
    assert scratch == (n * h * w * g * args.Q * 4 if args.Q else n * c * h * w)


def test_pack_weights_groups_channel_quads():
    wq = torch.arange(-60, 60, dtype=torch.int8).view(2, 6, 5, 2)[:, :, :3, :].contiguous()
    packed = ic.pack_weights(wq)
    assert packed.dtype == torch.int32 and packed.shape == (2, 3, 2, 2)
    raw = packed.view(torch.int8).view(2, 3, 2, 8)
    assert torch.equal(raw[..., :6], wq.permute(0, 2, 3, 1))
    assert not raw[..., 6:].any()


def test_shape_struct_matches_the_c_layout():
    # struct I8Shape of csrc/int8_conv.cu: 22 ints, then a float
    assert [name for name, _ in ic._Shape._fields_][:4] == ["N", "C", "H", "W"]
    assert ic._Shape.rcp.offset == 88 and ctypes.sizeof(ic._Shape) == 92
    assert "int8_conv" in _build.SOURCES and (_build.CSRC / "int8_conv.cu").is_file()


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_matches_plain_on_card_to_the_bit(cuda_card, case, dtype):
    x, wq, scale, bias, rcp = _inputs(case, dtype, dtype, device=cuda_card)
    *_, s, p, d, g = case
    before = ic.int8_conv_kernel.launches
    y = ic.int8_conv(x, wq, ic.pack_weights(wq), scale, rcp, bias, (s, s), (p, p), (d, d), g)
    torch.cuda.synchronize()
    assert ic.int8_conv_kernel.launches == before + 1
    ref = ic.int8_conv_reference(x, wq, scale, rcp, bias, (s, s), (p, p), (d, d), g)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(y.view(bits), ref.view(bits))
