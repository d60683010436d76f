"""The port's CUDA kernels: dispatch, launch accounting and the build.

No JAX here, so the file also runs on a machine with a CUDA card and
without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The `cuda` tests skip without a card. On the card each kernel is held
against its plain PyTorch version, relative to the output scale: 1e-5 in
f32 (summation order only), 2e-2 in bf16 (the output is rounded to bf16
once; about 5 ulp).
"""

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


# (B, N, H, D, layout): "qkv" = the module's strided views of the conv output
CARD_CASES = [(4, 400, 2, 64, "qkv"), (2, 999, 3, 32, "bnhd"), (1, 33, 1, 64, "bnhd")]


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
