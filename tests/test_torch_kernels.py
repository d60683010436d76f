"""The port's CUDA kernels: dispatch, launch accounting and the build.

No JAX here, so the file also runs on a machine with a CUDA card and
without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The `cuda` tests skip without a card. On the card each kernel is held
against its plain PyTorch version, relative to the output scale: 1e-5 in
f32 (summation order only), 2e-2 in bf16 (the tensor-core products round
their operands to bf16 and the output is rounded to bf16 once; about 5 ulp).
"""

import ctypes

import numpy as np
import pytest
import torch

from edgeyolo_tpu_torch.ops import _build
from edgeyolo_tpu_torch.ops import linear_attention as la


def _qkv(shape, seed, scale=0.5):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape) * scale).astype(np.float32) for _ in range(3)]


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 20, 2, 32), 6))
    before = la.linear_attention_kernel.launches
    y = la.linear_attention(q, k, v)
    torch.testing.assert_close(y, la.linear_attention_reference(q, k, v), rtol=0, atol=0)
    assert la.linear_attention_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 20, 2, 32), 7))
    with pytest.raises(ValueError, match="CUDA"):
        la.linear_attention_kernel(q, k, v)


H100_SMS = 132  # the SM count and blocks per SM (4 in bf16, 2 in f32) of the H100


@pytest.mark.parametrize("shape,splits,chunk", [
    ((32, 400, 2, 64), 7, 64),       # the serving shape: 448 blocks, one tile each
    ((128, 400, 2, 64), 2, 256),
    ((128, 1600, 2, 64), 2, 832),
    ((16, 6400, 4, 64), 8, 832),
    ((4, 999, 3, 32), 16, 64),
    ((1, 33, 1, 64), 1, 64),
    ((1024, 400, 2, 64), 1, 448),    # more pairs than one wave holds: no split
], ids=str)
def test_split_plan_fills_one_wave_with_whole_tiles(shape, splits, chunk):
    b, n, h, d = shape
    s, c, ws = la.split_plan(b, n, h, d, H100_SMS, 4)
    assert (s, c) == (splits, chunk)
    assert c % la.TILE_N == 0 and (s - 1) * c < n <= s * c  # no empty chunk
    assert s <= -(-n // la.TILE_N)
    assert ws == b * h * s * (d * d + 2 * d) * 4
    assert s == 1 or b * h * s <= 4 * H100_SMS  # one wave


def test_split_plan_follows_the_occupancy():
    assert la.split_plan(32, 400, 2, 64, H100_SMS, 2)[:2] == (4, 128)  # f32: 264 slots
    assert la.split_plan(32, 400, 2, 64, 1, 1)[0] == 1
    assert la.split_plan(32, 400, 2, 64, 2 * H100_SMS, 4)[0] == 7  # one chunk per tile at most


def test_scratch_is_kept_per_stream_and_grows():
    dev, stream = torch.device("cpu"), -1  # a key no launch uses
    try:
        ws, counters = la._scratch_for(dev, stream, 100, 8)
        assert ws.numel() == 100 and counters.tolist() == [0] * 8
        assert all(a is b for a, b in zip(la._scratch_for(dev, stream, 50, 4), (ws, counters)))
        ws2, counters2 = la._scratch_for(dev, stream, 200, 16)
        assert ws2.numel() == 200 and counters2.numel() == 16 and int(counters2.sum()) == 0
        assert la._scratch_for(dev, stream + 1, 10, 1)[0] is not ws2  # another stream
    finally:
        for key in ((None, stream), (None, stream + 1)):
            la._scratch.pop(key, None)


@pytest.mark.parametrize("case", ["strides", "dtype", "D in"])
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take_before_any_launch(case):
    """Inputs are checked on the host before the card is touched: a mismatch
    of q, k, v in the wrapper, the rest when a shape is first planned."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 16, 2, 64), 8))
    before, plans = la.linear_attention_kernel.launches, len(la._plans)
    with pytest.raises(ValueError, match=case):
        if case == "strides":
            la.linear_attention_kernel(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)
        elif case == "dtype":
            la._plan(q.shape, q.stride(), torch.float16, torch.device("cuda", 0))
        else:
            q48 = q[..., :48]
            la._plan(q48.shape, q48.stride(), q.dtype, torch.device("cuda", 0))
    assert la.linear_attention_kernel.launches == before and len(la._plans) == plans


def test_shape_struct_matches_the_c_layout():
    # struct LaShape of csrc/linear_attention.cu: eight ints, then two long long[4]
    assert [name for name, _ in la._Shape._fields_] == [
        "dtype", "head_dim", "B", "N", "H", "S", "chunk", "device", "in_strides", "out_strides"]
    assert la._Shape.in_strides.offset == 32 and la._Shape.out_strides.offset == 64
    assert ctypes.sizeof(la._Shape) == 96


def test_build_targets_hopper_and_keys_on_the_source():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"{name}-")
        assert (_build.CSRC / f"{name}.cu").is_file()


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison on the card")
    return torch.device("cuda")


# (B, N, H, D, layout): "qkv" = the module's strided views of the conv output.
# N = 1000 and 6400 span several chunks with a ragged last one (16-byte
# loads); N = 250 in the qkv layout and every bnhd case take one element
# per load.
CARD_CASES = [(4, 400, 2, 64, "qkv"), (2, 999, 3, 32, "bnhd"), (1, 33, 1, 64, "bnhd"),
              (2, 1000, 2, 64, "qkv"), (1, 6400, 4, 64, "qkv"), (3, 250, 2, 32, "qkv")]


def _card_qkv(b, n, h, d, layout, dtype, device):
    gen = torch.Generator(device=device).manual_seed(0)
    if layout == "qkv":
        qkv = torch.randn(b, 3, h, d, n, device=device, generator=gen).to(dtype)
        return [qkv[:, i].permute(0, 3, 1, 2) for i in range(3)]
    return [torch.randn(b, n, h, d, device=device, generator=gen).to(dtype) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=[f"{c[0]}x{c[1]}x{c[2]}x{c[3]}-{c[4]}"
                                                  for c in CARD_CASES])
def test_kernel_matches_plain_on_card(cuda_card, case, dtype, rtol):
    q, k, v = _card_qkv(*case, dtype, cuda_card)
    before = la.linear_attention_kernel.launches
    y = la.linear_attention(q, k, v)
    torch.cuda.synchronize()
    assert la.linear_attention_kernel.launches == before + 1
    assert y.shape == q.shape and y.dtype == dtype
    ref = la.linear_attention_reference(q, k, v).float()
    assert (y.float() - ref).abs().max().item() <= rtol * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_is_bit_identical_across_launches_on_card(cuda_card, dtype):
    """The partial contexts are merged in a fixed order, with no float atomics."""
    q, k, v = _card_qkv(2, 1000, 2, 64, "qkv", dtype, cuda_card)
    assert la.split_plan(2, 1000, 2, 64, la._sm_count(0), la.blocks_per_sm(dtype, 64, 0))[0] > 1
    ys = [la.linear_attention_kernel(q, k, v) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(ys[0], y) for y in ys[1:])


@pytest.mark.cuda
def test_kernel_gradient_is_the_plain_gradient_on_card(cuda_card):
    q, k, v = (t.requires_grad_() for t in _card_qkv(2, 50, 2, 32, "bnhd", torch.float32,
                                                       cuda_card))
    g = torch.autograd.grad(torch.sin(la.linear_attention(q, k, v)).sum(), (q, k, v))
    g_ref = torch.autograd.grad(torch.sin(la.linear_attention_reference(q, k, v)).sum(), (q, k, v))
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_card):
    q, k, v = _card_qkv(1, 16, 2, 64, "bnhd", torch.float32, cuda_card)
    with pytest.raises(ValueError, match="dtype"):
        la.linear_attention_kernel(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="strides"):
        la.linear_attention_kernel(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)
    q48, k48, v48 = (t[..., :48] for t in (q, k, v))
    with pytest.raises(ValueError, match="D in"):
        la.linear_attention_kernel(q48, k48, v48)
