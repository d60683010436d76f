"""EdgeLine linear attention: the CUDA kernel, its plain version and autograd.

    k' = softmax(k, over head_dim); q' = softmax(q, over tokens) (+1e-9 in the sum)
    y = q' (k'^T v)          O(N d^2)

Port of edgeyolo_tpu/ops/pallas/linear_attention.py. The kernel is
`csrc/linear_attention.cu` (nvcc, bound with ctypes); it replaces the Pallas
`_la_kernel`. q, k, v are (B, N, heads, head_dim), the JAX package's layout,
with any strides: the module hands in views of the qkv convolution's NCHW
output and gets y back in the same channel-first layout, so no transpose is
copied on the way in or out.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The backward recomputes through the plain version with autograd, as
`_la_bwd` does with `jax.vjp(_la_reference)`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from edgeyolo_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def linear_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain composition of the kernel: f32 math, output in the input dtype."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    k = k.softmax(dim=-1)
    qe = torch.exp(q - q.amax(dim=1, keepdim=True))
    q = qe / (qe.sum(dim=1, keepdim=True) + 1e-9)
    ctx = torch.einsum("bnhd,bnhe->bhde", k, v)
    return torch.einsum("bnhd,bhde->bnhe", q, ctx).to(dtype)


@functools.cache
def _forward_fn():
    """The bound C entry point, built, loaded and declared once per process."""
    fn = _build.load("linear_attention").edgeyolo_la_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])
    return fn


def linear_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch csrc/linear_attention.cu on CUDA tensors q, k, v of shape (B, N, H, D).

    q, k and v must share shape, strides, dtype (f32 or bf16) and device;
    D must be 32 or 64. y comes back token-minor (B, H, D, N) in memory when q
    is token-minor, else as a contiguous (B, N, H, D).
    """
    if q.device.type != "cuda":
        raise ValueError(f"linear_attention_kernel needs CUDA tensors, got {q.device}")
    if not (q.shape == k.shape == v.shape and q.stride() == k.stride() == v.stride()):
        raise ValueError("q, k, v must share shape and strides")
    if not (q.dtype == k.dtype == v.dtype and q.device == k.device == v.device):
        raise ValueError("q, k, v must share dtype and device")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if q.ndim != 4 or q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"expected (B, N, H, D) with D in {_HEAD_DIMS}, got {tuple(q.shape)}")
    b, n, h, d = q.shape
    if min(b, n, h) <= 0:
        raise ValueError(f"empty input {tuple(q.shape)}")
    if q.stride(1) == 1:
        y = torch.empty((b, h, d, n), dtype=q.dtype, device=q.device).permute(0, 3, 1, 2)
    else:
        y = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _forward_fn()(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(),
            b, n, h, *q.stride(), *y.stride(), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear attention kernel launch failed: cudaError {err}")
    linear_attention_kernel.launches += 1
    return y


linear_attention_kernel.launches = 0


def _forward(q, k, v):
    if q.device.type == "cpu":
        return linear_attention_reference(q, k, v)
    return linear_attention_kernel(q, k, v)


class _LinearAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            y = linear_attention_reference(q, k, v)
        return torch.autograd.grad(y, (q, k, v), g)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused linear attention over (B, N, heads, head_dim), differentiable."""
    return _LinearAttention.apply(q, k, v)
