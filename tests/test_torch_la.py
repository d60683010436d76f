"""Linear attention of the PyTorch port against the JAX package.

The port's plain version (its CPU path and the CUDA kernel's oracle) is held
against `_la_reference` and against the Pallas kernel, which runs in
interpret mode on the CPU as tests/test_pallas_la.py runs it. Inputs come
from numpy and go to both frameworks. Tolerance atol 1e-5: both sides
compute in f32 and differ only in summation order over N <= 400 tokens and
the +1e-9 of the token-softmax sum (JAX `_la_reference` has none).

The kernel's own tests, which need no JAX and so also run on the card, are
in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgeyolo_tpu.ops.pallas.linear_attention import _la_reference
from edgeyolo_tpu.ops.pallas.linear_attention import linear_attention as jax_linear_attention
from edgeyolo_tpu_torch.ops import linear_attention as la

ATOL = 1e-5

# (B, N, H, D): N = 49 and 37 are multiples of no tile size; 400 is the 640 px stage
SHAPES = [(2, 49, 2, 32), (1, 37, 3, 64), (2, 400, 2, 64)]


def _qkv(shape, seed, scale=0.5):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape) * scale).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_matches_jax_reference(shape):
    q, k, v = _qkv(shape, 0)
    y_jax = np.asarray(_la_reference(*map(jnp.asarray, (q, k, v))))
    y = la.linear_attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(y, y_jax, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=[str(s) for s in SHAPES[:2]])
def test_plain_matches_pallas_kernel_interpret(shape):
    q, k, v = _qkv(shape, 1)
    y_pallas = np.asarray(jax_linear_attention(*map(jnp.asarray, (q, k, v))))
    y = la.linear_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(y, y_pallas, atol=ATOL)


def test_grad_matches_jax_grad():
    q, k, v = _qkv((1, 25, 2, 16), 3)

    def loss_jax(q, k, v):
        return jnp.sum(jnp.sin(_la_reference(q, k, v)))

    g_jax = jax.grad(loss_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch.sin(la.linear_attention(*ts)).sum().backward()
    for t, g in zip(ts, g_jax):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL)


def test_strided_views_equal_contiguous():
    """The module hands in views of the NCHW qkv conv output; the values must
    not depend on the strides beyond f32 summation order (atol 1e-6)."""
    b, n, h, d = 2, 30, 2, 32
    qkv = torch.from_numpy(np.random.RandomState(4).randn(b, 3, h, d, n).astype(np.float32))
    views = [qkv[:, i].permute(0, 3, 1, 2) for i in range(3)]
    assert views[0].stride(1) == 1
    y_views = la.linear_attention(*views)
    y_contig = la.linear_attention(*(t.contiguous() for t in views))
    torch.testing.assert_close(y_views, y_contig, rtol=0, atol=1e-6)


def test_bf16_plain_computes_in_f32():
    """bf16 in, bf16 out, f32 inside: equals the f32 result rounded once."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv((2, 40, 2, 32), 5))
    y = la.linear_attention_reference(q, k, v)
    assert y.dtype == torch.bfloat16
    y32 = la.linear_attention_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(y, y32.bfloat16(), rtol=0, atol=0)
