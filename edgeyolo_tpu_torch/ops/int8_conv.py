"""The int8 convolution of the int8 forward: the CUDA kernel and its plain version.

    xq = clip(rint(x * rcp), -127, 127)              rcp = f32(1 / sx)
    acc = conv(xq, wq)                               int32 sums, exact
    y = f32(acc) * scale[o] (+ bias[o])              scale = f32(sx * ws[o])
    -> x's dtype

The JAX package computes the conv with XLA's int8 convolution
(edgeyolo_tpu/nn/quant.py:143, `preferred_element_type=int32`); it has no
Pallas kernel. The card's kernel is `csrc/int8_conv.cu` (nvcc, ctypes): a
quantize launch, then a dp4a or scalar integer conv with the epilogue above.
The quantize multiplies by the f32 reciprocal of sx because that is what XLA
compiles JAX's `x / sx` to, sx being a constant of the jitted program.

`int8_conv_reference` is the plain version: the same codes, `F.conv2d` in
float64 on them (every product and partial sum is an integer below 2^53, so
the sum is exact in any order), then the same rounded product and sum in
f32. Kernel and plain version agree to the bit.

`int8_conv` takes the plain version for a CPU tensor and launches the
kernel for a CUDA one, or raises; `int8_conv_kernel.launches` counts the
wrapper's calls, each of which makes two launches (quantize, then conv).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from edgeyolo_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
OC_PER_THREAD = 8  # output channels a thread of the dp4a path sums (the .cu's)
MAX_GRID_Y = 65535


def quantize_codes(x: torch.Tensor, rcp: float) -> torch.Tensor:
    """x's int8 codes, as f32 values: clip(rint(x * rcp), -127, 127)."""
    return torch.round(x.float() * rcp).clamp_(-127, 127)


def int8_conv_reference(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, rcp: float,
                        bias: torch.Tensor | None = None, stride=(1, 1), padding=(0, 0),
                        dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """The plain version: x (N, C, H, W) f32 or bf16, wq (O, C / groups, kh, kw)
    int8, scale (O,) f32; returns (N, O, OH, OW) in x's dtype."""
    xq = quantize_codes(x, rcp)
    acc = F.conv2d(xq.double(), wq.double(), None, stride, padding, dilation, groups)
    y = acc.float() * scale.view(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1)
    return y.to(x.dtype)


def pack_weights(wq: torch.Tensor) -> torch.Tensor:
    """(O, CG, kh, kw) int8 -> the dp4a path's (O, kh, kw, Q) int32 words of
    four input-channel codes, zero-padded to whole quads."""
    o, cg, kh, kw = wq.shape
    q = -(-cg // 4)
    w = torch.zeros(o, kh, kw, q * 4, dtype=torch.int8, device=wq.device)
    w[..., :cg] = wq.permute(0, 2, 3, 1)
    return w.view(torch.int32).contiguous()


class _Shape(ctypes.Structure):
    """`I8Shape` of csrc/int8_conv.cu."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "N", "C", "H", "W", "O", "OH", "OW", "KH", "KW", "SH", "SW", "PH", "PW", "DH", "DW", "G",
        "CG", "OG", "Q", "in_bf16", "out_bf16", "bias_kind")] + [("rcp", ctypes.c_float)]


@functools.cache
def _entry():
    fn = _build.load("int8_conv").edgeyolo_i8_conv2d
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8
    return fn


def out_size(size: int, k: int, s: int, p: int, d: int) -> int:
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def plan(x_shape, w_shape, stride, padding, dilation, groups: int, x_dtype: torch.dtype,
         bias_dtype: torch.dtype | None, rcp: float) -> tuple[_Shape, int]:
    """The kernel's `_Shape` for one call and its scratch size in bytes;
    raises for what the kernel does not take."""
    if x_dtype not in _DTYPES:
        raise ValueError(f"int8_conv takes float32 or bfloat16 input, got {x_dtype}")
    if bias_dtype not in (None, *_DTYPES):
        raise ValueError(f"int8_conv takes a float32 or bfloat16 bias, got {bias_dtype}")
    n, c, h, w = x_shape
    o, cg, kh, kw = w_shape
    if c != cg * groups or o % groups:
        raise ValueError(f"weight {tuple(w_shape)} does not fit input {tuple(x_shape)} "
                         f"in {groups} groups")
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    oh, ow = out_size(h, kh, sh, ph, dh), out_size(w, kw, sw, pw, dw)
    if min(n, oh, ow) <= 0:
        raise ValueError(f"empty output for input {tuple(x_shape)}")
    og = o // groups
    q = -(-cg // 4) if cg >= 4 else 0
    if q and groups * -(-og // OC_PER_THREAD) > MAX_GRID_Y:
        raise ValueError(f"{groups} groups of {og} outputs exceed the kernel's grid")
    bias_kind = 0 if bias_dtype is None else (1 if bias_dtype == torch.float32 else 2)
    args = _Shape(n, c, h, w, o, oh, ow, kh, kw, sh, sw, ph, pw, dh, dw, groups, cg, og, q,
                  int(x_dtype == torch.bfloat16), int(x_dtype == torch.bfloat16), bias_kind,
                  rcp)
    scratch = n * h * w * groups * q * 4 if q else n * c * h * w
    return args, scratch


def int8_conv_kernel(x: torch.Tensor, wq: torch.Tensor, wpack: torch.Tensor,
                     scale: torch.Tensor, rcp: float, bias: torch.Tensor | None = None,
                     stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups: int = 1
                     ) -> torch.Tensor:
    """Launch csrc/int8_conv.cu on CUDA tensors. x (N, C, H, W) contiguous f32
    or bf16; wq (O, C / groups, kh, kw) int8 contiguous, which the scalar
    path reads; wpack = `pack_weights(wq)`, which the dp4a path reads; scale
    (O,) f32; bias (O,) f32 or bf16 or None. y is a new contiguous
    (N, O, OH, OW) tensor in x's dtype."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"int8_conv_kernel needs CUDA tensors, got {dev}")
    for name, t in (("wq", wq), ("wpack", wpack), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if wq.dtype != torch.int8 or wq.dim() != 4 or not wq.is_contiguous():
        raise ValueError(f"wq must be a contiguous 4-D int8 tensor, got {wq.dtype} "
                         f"{tuple(wq.shape)}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous NCHW tensor, got {tuple(x.shape)}")
    o = wq.shape[0]
    if scale.dtype != torch.float32 or scale.shape != (o,) or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous f32 ({o},) tensor")
    if bias is not None and (bias.shape != (o,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous ({o},) tensor")
    args, scratch = plan(x.shape, wq.shape, stride, padding, dilation, groups, x.dtype,
                         None if bias is None else bias.dtype, rcp)
    if wpack.dtype != torch.int32 or wpack.shape != (o, args.KH, args.KW, -(-wq.shape[1] // 4)) \
            or not wpack.is_contiguous():
        raise ValueError(f"wpack must be pack_weights(wq), got {wpack.dtype} "
                         f"{tuple(wpack.shape)}")
    xq = torch.empty(scratch, dtype=torch.int8, device=dev)
    y = torch.empty(args.N, o, args.OH, args.OW, dtype=x.dtype, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = _entry()(x.data_ptr(), xq.data_ptr(), (wpack if args.Q else wq).data_ptr(),
                   scale.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
                   ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: cudaError {err}")
    int8_conv_kernel.launches += 1
    return y


int8_conv_kernel.launches = 0


def int8_conv(x: torch.Tensor, wq: torch.Tensor, wpack: torch.Tensor, scale: torch.Tensor,
              rcp: float, bias: torch.Tensor | None = None, stride=(1, 1), padding=(0, 0),
              dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """The int8 conv on x's device: the plain version on the CPU, the kernel
    on CUDA (which raises for what it does not take)."""
    if x.device.type == "cpu":
        return int8_conv_reference(x, wq, scale, rcp, bias, stride, padding, dilation, groups)
    return int8_conv_kernel(x.contiguous(), wq, wpack, scale, rcp, bias, stride, padding,
                            dilation, groups)
