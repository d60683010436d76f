"""EdgeLine linear attention: the CUDA kernel, its plain version and autograd.

    k' = softmax(k, over head_dim); q' = softmax(q, over tokens) (+1e-9 in the sum)
    y = q' (k'^T v)          O(N d^2)

Port of edgeyolo_tpu/ops/pallas/linear_attention.py. The kernel is
`csrc/linear_attention.cu` (nvcc, bound with ctypes); it replaces the Pallas
`_la_kernel`. q, k, v are (B, N, heads, head_dim), the JAX package's layout,
with any strides: the module hands in views of the qkv convolution's NCHW
output and gets y back in the same channel-first layout, so no transpose is
copied on the way in or out.

The kernel splits N into S chunks across thread blocks (`split_plan`) and
merges their partial contexts in a fixed order through an f32 workspace that
the wrapper keeps per stream, so its output is the same bits from run to run.

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
# MSLA's quarters at scales n to x, C2PSA's 64, and the wavelet mixer's LL band (c / 2:
# 32 to 192 at scales n to x)
_HEAD_DIMS = (8, 16, 32, 48, 64, 96, 128, 192)
TILE_N = 64  # tokens per tile of the kernel; chunks are whole tiles


def linear_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain composition of the kernel: f32 math, output in the input dtype."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    k = k.softmax(dim=-1)
    qe = torch.exp(q - q.amax(dim=1, keepdim=True))
    q = qe / (qe.sum(dim=1, keepdim=True) + 1e-9)
    ctx = torch.einsum("bnhd,bnhe->bhde", k, v)
    return torch.einsum("bnhd,bhde->bnhe", q, ctx).to(dtype)


def split_plan(b: int, n: int, h: int, d: int, sms: int,
               blocks_per_sm: int) -> tuple[int, int, int]:
    """(S, chunk, workspace bytes) of the kernel's context phase.

    N is cut into S chunks of `chunk` tokens (whole tiles, the last one
    ragged). S is the most that keeps the (B*H) x S grid within one wave of
    `blocks_per_sm` blocks on each of `sms` SMs (a second wave would double
    the phase), at least 1 and at most one chunk per tile. Each block writes
    a D x D partial context and two D-vectors of column statistics, in f32.
    """
    tiles = -(-n // TILE_N)
    s = max(1, min(tiles, blocks_per_sm * sms // (b * h)))
    chunk_tiles = -(-tiles // s)
    s = -(-tiles // chunk_tiles)  # no empty chunk
    return s, chunk_tiles * TILE_N, b * h * s * (d * d + 2 * d) * 4


class _Shape(ctypes.Structure):
    """`LaShape` of csrc/linear_attention.cu: what stays fixed for one input shape."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("dtype", "head_dim", "B", "N", "H", "S", "chunk", "device")] + [
        ("in_strides", ctypes.c_longlong * 4), ("out_strides", ctypes.c_longlong * 4)]


@functools.cache
def _forward_fn(marked: bool = False):
    """The bound C entry point (with `marked`, the one that also records three
    events), built, loaded and declared once per process."""
    lib = _build.load("linear_attention")
    fn = lib.edgeyolo_la_forward_marked if marked else lib.edgeyolo_la_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (9 if marked else 8)
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def blocks_per_sm(dtype: torch.dtype, d: int, index: int) -> int:
    """Context blocks of the kernel for dtype and head dim d that one SM of
    CUDA device `index` holds at once, by the CUDA occupancy calculator."""
    fn = _build.load("linear_attention").edgeyolo_la_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    n = fn(_DTYPE_CODE[dtype], d, index)
    if n <= 0:
        raise RuntimeError(f"linear attention occupancy query failed: cudaError {-n}")
    return n


# (shape, strides, dtype, device) of q -> (y's strides, workspace floats,
# (batch, head) pairs, _Shape): checked and planned on the first launch at
# that shape, so later launches only look it up.
_plans: dict[tuple, tuple] = {}


def _plan(shape: torch.Size, strides: tuple, dtype: torch.dtype, device: torch.device) -> tuple:
    if device.type != "cuda":
        raise ValueError(f"linear_attention_kernel needs CUDA tensors, got {device}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {dtype}; the kernel takes float32 or bfloat16")
    if len(shape) != 4 or shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"expected (B, N, H, D) with D in {_HEAD_DIMS}, got {tuple(shape)}")
    b, n, h, d = shape
    if min(b, n, h) <= 0:
        raise ValueError(f"empty input {tuple(shape)}")
    if strides[1] == 1:  # (B, H, D, N) in memory: y too
        y_strides = (h * d * n, 1, d * n, n)
    else:
        y_strides = (n * h * d, h * d, d, 1)
    splits, chunk, ws_bytes = split_plan(b, n, h, d, _sm_count(device.index),
                                         blocks_per_sm(dtype, d, device.index))
    args = _Shape(_DTYPE_CODE[dtype], d, b, n, h, splits, chunk, device.index,
                  (ctypes.c_longlong * 4)(*strides), (ctypes.c_longlong * 4)(*y_strides))
    return y_strides, ws_bytes // 4, b * h, args


# (device index, stream) -> (workspace, counters). Launches on one stream run
# in order, so they share one workspace, as a BLAS library keeps one per
# stream; it grows to the largest launch seen. The counters start at zero and
# every launch leaves them at zero (the merging block resets its own).
_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch_for(device: torch.device, stream: int, ws_floats: int, pairs: int):
    ws, counters = _scratch.get((device.index, stream), (None, None))
    if ws is None or ws.numel() < ws_floats:
        ws = torch.empty(ws_floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < pairs:
        counters = torch.zeros(pairs, dtype=torch.int32, device=device)
    _scratch[(device.index, stream)] = ws, counters
    return ws, counters


def _call(fn, q, k, v, y, ws, counters, stream: int, args: _Shape, *extra) -> int:
    """Call fn, the C entry point, on q, k, v, y and the scratch buffers."""
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), ws.data_ptr(),
              counters.data_ptr(), stream, ctypes.addressof(args), *extra)


def linear_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            marks: tuple | None = None) -> torch.Tensor:
    """Launch csrc/linear_attention.cu on CUDA tensors q, k, v of shape (B, N, H, D).

    q, k and v must share shape, strides, dtype (f32 or bf16) and device;
    D must be one of 8, 16, 32, 48, 64, 96, 128 and 192. y comes back token-minor
    (B, H, D, N) in memory when q is token-minor, else as a contiguous
    (B, N, H, D). `marks`, three recorded torch.cuda.Events (timing only), are
    recorded on the stream before the context launch, between the launches
    and after the output launch.
    """
    key = (q.shape, q.stride(), q.dtype, q.device)
    if (k.shape, k.stride(), k.dtype, k.device) != key or (
            v.shape, v.stride(), v.dtype, v.device) != key:
        raise ValueError("q, k, v must share shape, strides, dtype and device")
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _plan(*key)
    y_strides, ws_floats, pairs, args = plan
    y = torch.empty_strided(key[0], y_strides, dtype=key[2], device=key[3])
    # the raw handle of the current stream, without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(args.device)
    ws, counters = _scratch_for(key[3], stream, ws_floats, pairs)
    if marks is None:
        err = _call(_forward_fn(), q, k, v, y, ws, counters, stream, args)
    else:
        events = (ctypes.c_void_p * 3)(*(e.cuda_event for e in marks))
        err = _call(_forward_fn(True), q, k, v, y, ws, counters, stream, args,
                    ctypes.addressof(events))
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
