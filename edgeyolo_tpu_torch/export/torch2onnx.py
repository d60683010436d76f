"""ATen graph -> ONNX converter: walk a torch.export program and emit ModelProto bytes.

The counterpart of edgeyolo_tpu/export/jax2onnx.py, which walks a jaxpr.
Here the graph is an `ExportedProgram`'s (static shapes: every node's
`meta["val"]` gives its shape and dtype). Each ATen op maps to one, or a
short chain of, standard ONNX ops at opset 17, and only to ops that the
numpy executor (export/onnx_runtime.py, JAX's op set) runs, so JAX's own
executor and any standard ONNX runtime run the file too:

- softmax is ReduceMax / Sub / Exp / ReduceSum / Div; nearest upsampling
  Reshape / Expand / Reshape; einsum and linear Transpose / Reshape / MatMul;
  silu, softplus, gelu and relu elementwise ops; BatchNorm (where the
  exporter's fuse left one) Mul / Add; a conv's bias an Add after the Conv;
- the registered linear-attention op (ops/linear_attention.py) is emitted as
  its plain version's decomposition: k' = softmax over D, q' = exp(q - max)
  / (sum over N + 1e-9), context = k'^T v, y = q' context;
- `wrap_with_autocast` and `wrap_with_set_grad_enabled` sub-graphs are
  inlined;
- a node whose inputs are all export-time constants (parameters, buffers,
  `arange`, `meshgrid`, anchor grids and strides) is evaluated with torch at
  export time; constants become initializers, keyed by content so equal
  ones are stored once, only when a graph op consumes them.

An op with no converter raises NotImplementedError naming the ATen target
and its input shapes.
"""

from __future__ import annotations

import hashlib
import math
import operator

import numpy as np
import torch

from edgeyolo_tpu_torch.export import onnx_proto as P

aten = torch.ops.aten
_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 62)  # Slice sentinel for reverse slicing (the spec clamps)
# ops that only check or re-label a value
_PASS = {aten.alias.default, aten.detach.default, aten.clone.default, aten.contiguous.default,
         aten.lift_fresh_copy.default}
_SKIP = {aten._assert_tensor_metadata.default, aten._assert_scalar.default}
_HOPS = ("wrap_with_autocast", "wrap_with_set_grad_enabled")
# ops whose value depends only on their input's shape: a constant of the node's shape
_LIKE = {aten.zeros_like.default: 0, aten.ones_like.default: 1, aten.full_like.default: None}


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


class _Val:
    """A traced value: a graph tensor (name, shape, dtype) or an export-time
    constant (a CPU torch tensor, an initializer only when a graph op consumes it)."""

    __slots__ = ("name", "const", "shape", "dtype")

    def __init__(self, name=None, const=None, shape=None, dtype=None):
        if const is not None:
            shape, dtype = const.shape, const.dtype
        self.name, self.const = name, const
        self.shape, self.dtype = tuple(int(s) for s in shape), dtype

    @property
    def is_const(self) -> bool:
        return self.const is not None


class _Ctx:
    def __init__(self):
        self.nodes: list[bytes] = []
        self.inits: list[bytes] = []
        self._init_cache: dict[tuple, str] = {}
        self._n = 0

    def fresh(self, hint="t"):
        self._n += 1
        return f"{hint}_{self._n}"

    def node(self, op, inputs, n_out=1, hint=None, **attrs):
        outs = [self.fresh(hint or op.lower()) for _ in range(n_out)]
        self.nodes.append(P.node_proto(op, inputs, outs, **attrs))
        return outs if n_out != 1 else outs[0]

    def init(self, arr, hint="c"):
        arr = np.ascontiguousarray(arr)
        # content-keyed dedup (id() is unsafe: freed temporaries recycle ids)
        key = (hashlib.blake2b(arr.tobytes(), digest_size=16).digest(), arr.shape, str(arr.dtype))
        if key not in self._init_cache:
            name = self.fresh(hint)
            self.inits.append(P.tensor_proto(name, arr))
            self._init_cache[key] = name
        return self._init_cache[key]

    def inp(self, v: _Val):
        """Graph-tensor name for a value, materialising constants."""
        return self.init(v.const.detach().cpu().numpy()) if v.is_const else v.name

    def i64(self, seq, hint="shape"):
        return self.init(np.asarray(list(seq), np.int64), hint)

    def scalar(self, x, dtype: torch.dtype, hint="k"):
        return self.init(np.asarray(x, _np_dtype(dtype)), hint)

    def cast(self, v: _Val, dtype: torch.dtype):
        """v's graph name in `dtype`."""
        if v.is_const:
            return self.inp(_Val(const=v.const.to(dtype)))
        if v.dtype == dtype:
            return v.name
        return self.node("Cast", [v.name], to=P.DTYPE_CODE[_np_dtype(dtype)])

    def reshape(self, name, shape):
        return self.node("Reshape", [name, self.i64(shape)])


# ------------------------------------------------------------- handlers ---
# each: h(ctx, node, args, kwargs, out) -> a graph name, or a list of them for a
# multi-output op; args hold _Val for tensors and Python values otherwise;
# out is the node's meta value (a tensor, or a list of them)

_H = {}


def _reg(*targets):
    def deco(fn):
        for t in targets:
            _H[t] = fn
        return fn

    return deco


def _dim(d: int, rank: int) -> int:
    return d % rank if rank else 0


def _operand(ctx, x, dtype):
    """A binary op's operand in the op's dtype: a _Val or a Python number."""
    if isinstance(x, _Val):
        return ctx.cast(x, dtype)
    return ctx.scalar(x, dtype)


_BINARY = {aten.add.Tensor: "Add", aten.sub.Tensor: "Sub", aten.mul.Tensor: "Mul",
           aten.div.Tensor: "Div", aten.pow.Tensor_Scalar: "Pow", aten.pow.Tensor_Tensor: "Pow",
           aten.maximum.default: "Max", aten.minimum.default: "Min",
           aten.add.Scalar: "Add", aten.sub.Scalar: "Sub", aten.mul.Scalar: "Mul",
           aten.div.Scalar: "Div"}
_COMPARE = {aten.eq.Tensor: "Equal", aten.eq.Scalar: "Equal", aten.lt.Tensor: "Less",
            aten.lt.Scalar: "Less", aten.le.Tensor: "LessOrEqual", aten.le.Scalar: "LessOrEqual",
            aten.gt.Tensor: "Greater", aten.gt.Scalar: "Greater",
            aten.ge.Tensor: "GreaterOrEqual", aten.ge.Scalar: "GreaterOrEqual",
            aten.logical_and.default: "And", aten.logical_or.default: "Or"}
_UNARY = {aten.exp.default: "Exp", aten.log.default: "Log", aten.tanh.default: "Tanh",
          aten.sin.default: "Sin", aten.cos.default: "Cos", aten.abs.default: "Abs",
          aten.neg.default: "Neg", aten.floor.default: "Floor", aten.ceil.default: "Ceil",
          aten.sqrt.default: "Sqrt", aten.sigmoid.default: "Sigmoid",
          aten.reciprocal.default: "Reciprocal", aten.erf.default: "Erf",
          aten.logical_not.default: "Not", aten.sign.default: "Sign", aten.atan.default: "Atan"}


def _h_binary(ctx, node, args, kwargs, out):
    a, b = args[:2]
    alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
    if node.target in (aten.div.Tensor, aten.div.Scalar) and kwargs.get("rounding_mode"):
        raise NotImplementedError(f"onnx: {node.target} with rounding_mode")
    dt = out.dtype
    bn = _operand(ctx, b, dt)
    if alpha != 1:
        bn = ctx.node("Mul", [bn, ctx.scalar(alpha, dt)])
    return ctx.node(_BINARY[node.target], [_operand(ctx, a, dt), bn])


def _h_compare(ctx, node, args, kwargs, out):
    a, b = args
    # the operands' common dtype, by torch's promotion (a scalar or a 0-d tensor ranks lower)
    dt = torch.result_type(*(x.const if isinstance(x, _Val) and x.is_const
                             else torch.empty(1, dtype=x.dtype) if isinstance(x, _Val)
                             else x for x in (a, b)))
    return ctx.node(_COMPARE[node.target], [_operand(ctx, a, dt), _operand(ctx, b, dt)])


def _h_unary(ctx, node, args, kwargs, out):
    return ctx.node(_UNARY[node.target], [ctx.inp(args[0])])


for _t in _BINARY:
    _H[_t] = _h_binary
for _t in _COMPARE:
    _H[_t] = _h_compare
for _t in _UNARY:
    _H[_t] = _h_unary


@_reg(aten.silu.default)
def _h_silu(ctx, node, args, kwargs, out):
    x = ctx.inp(args[0])
    return ctx.node("Mul", [x, ctx.node("Sigmoid", [x])])


@_reg(aten.relu.default)
def _h_relu(ctx, node, args, kwargs, out):
    return ctx.node("Max", [ctx.inp(args[0]), ctx.scalar(0, out.dtype)])


@_reg(aten.softplus.default)
def _h_softplus(ctx, node, args, kwargs, out):
    """torch's softplus: log(1 + exp(beta x)) / beta, x itself past beta x > threshold."""
    x, beta, threshold = (list(args) + [1.0, 20.0][len(args) - 1:])[:3]
    dt = out.dtype
    xn = ctx.inp(x)
    bx = xn if beta == 1 else ctx.node("Mul", [xn, ctx.scalar(beta, dt)])
    soft = ctx.node("Log", [ctx.node("Add", [ctx.node("Exp", [bx]), ctx.scalar(1, dt)])])
    if beta != 1:
        soft = ctx.node("Div", [soft, ctx.scalar(beta, dt)])
    return ctx.node("Where", [ctx.node("Greater", [bx, ctx.scalar(threshold, dt)]), xn, soft])


@_reg(aten.gelu.default)
def _h_gelu(ctx, node, args, kwargs, out):
    dt = out.dtype
    x = ctx.inp(args[0])
    if kwargs.get("approximate", args[1] if len(args) > 1 else "none") == "tanh":
        x3 = ctx.node("Mul", [ctx.node("Mul", [x, x]), x])
        inner = ctx.node("Mul", [ctx.node("Add", [x, ctx.node("Mul", [x3, ctx.scalar(0.044715, dt)])]),
                                 ctx.scalar(math.sqrt(2 / math.pi), dt)])
        t = ctx.node("Tanh", [inner])
    else:
        t = ctx.node("Erf", [ctx.node("Mul", [x, ctx.scalar(1 / math.sqrt(2), dt)])])
    half = ctx.node("Mul", [x, ctx.scalar(0.5, dt)])
    return ctx.node("Mul", [half, ctx.node("Add", [t, ctx.scalar(1, dt)])])


@_reg(aten.clamp.default, aten.clamp.Tensor)
def _h_clamp(ctx, node, args, kwargs, out):
    x, lo, hi = (list(args) + [None, None])[:3]
    lo, hi = kwargs.get("min", lo), kwargs.get("max", hi)
    y = ctx.inp(x)
    if lo is not None:
        y = ctx.node("Max", [y, _operand(ctx, lo, out.dtype)])
    if hi is not None:
        y = ctx.node("Min", [y, _operand(ctx, hi, out.dtype)])
    return y


@_reg(aten.where.self, aten.where.ScalarSelf, aten.where.ScalarOther, aten.where.Scalar)
def _h_where(ctx, node, args, kwargs, out):
    c, a, b = args
    return ctx.node("Where", [ctx.inp(c), _operand(ctx, a, out.dtype), _operand(ctx, b, out.dtype)])


@_reg(aten.to.dtype, aten._to_copy.default, aten.to.dtype_layout, aten.type_as.default)
def _h_cast(ctx, node, args, kwargs, out):
    return ctx.cast(args[0], out.dtype)


@_reg(aten.view.default, aten.reshape.default, aten._unsafe_view.default,
      aten.flatten.using_ints, aten.unflatten.int, aten.unsqueeze.default,
      aten.squeeze.dim, aten.squeeze.dims, aten.squeeze.default)
def _h_reshape(ctx, node, args, kwargs, out):
    if tuple(out.shape) == args[0].shape:
        return ctx.inp(args[0])
    return ctx.reshape(ctx.inp(args[0]), out.shape)


@_reg(aten.permute.default)
def _h_permute(ctx, node, args, kwargs, out):
    x = args[0]
    perm = [_dim(d, len(x.shape)) for d in args[1]]
    return ctx.node("Transpose", [ctx.inp(x)], perm=perm)


@_reg(aten.transpose.int)
def _h_transpose(ctx, node, args, kwargs, out):
    x, a, b = args
    perm = list(range(len(x.shape)))
    a, b = _dim(a, len(perm)), _dim(b, len(perm))
    perm[a], perm[b] = perm[b], perm[a]
    return ctx.node("Transpose", [ctx.inp(x)], perm=perm)


@_reg(aten.expand.default)
def _h_expand(ctx, node, args, kwargs, out):
    return ctx.node("Expand", [ctx.inp(args[0]), ctx.i64(out.shape)])


@_reg(aten.cat.default)
def _h_cat(ctx, node, args, kwargs, out):
    xs = [x for x in args[0] if x.shape != (0,)]
    dim = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), len(out.shape))
    return ctx.node("Concat", [ctx.cast(x, out.dtype) for x in xs], axis=dim)


@_reg(aten.stack.default)
def _h_stack(ctx, node, args, kwargs, out):
    dim = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), len(out.shape))
    parts = []
    for x in args[0]:
        shape = list(x.shape)
        shape.insert(dim, 1)
        parts.append(ctx.reshape(ctx.cast(x, out.dtype), shape))
    return ctx.node("Concat", parts, axis=dim)


def _split(ctx, x: _Val, sizes, dim: int):
    outs = ctx.node("Split", [ctx.inp(x), ctx.i64(sizes, "split")], n_out=len(sizes), axis=dim)
    return outs if isinstance(outs, list) else [outs]


@_reg(aten.split_with_sizes.default, aten.split.Tensor, aten.chunk.default,
      aten.unbind.int)
def _h_split(ctx, node, args, kwargs, out):
    x = args[0]
    rank = len(x.shape)
    if node.target == aten.unbind.int:
        dim = _dim(args[1] if len(args) > 1 else 0, rank)
        parts = _split(ctx, x, [1] * x.shape[dim], dim)
        return [ctx.reshape(p, o.shape) for p, o in zip(parts, out)]
    dim = _dim(args[2] if len(args) > 2 else kwargs.get("dim", 0), rank)
    return _split(ctx, x, [o.shape[dim] for o in out], dim)


@_reg(aten.slice.Tensor, aten.narrow.default)
def _h_slice(ctx, node, args, kwargs, out):
    x = args[0]
    rank = len(x.shape)
    if node.target == aten.narrow.default:
        dim, start, length = args[1:4]
        end, step = start + length, 1
    else:
        dim, start, end, step = (list(args[1:]) + [0, None, None, 1][len(args) - 1:])[:4]
        start = 0 if start is None else start
        end = _INT64_MAX if end is None else min(end, _INT64_MAX)
    dim = _dim(dim, rank)
    return ctx.node("Slice", [ctx.inp(x), ctx.i64([start], "starts"), ctx.i64([end], "ends"),
                              ctx.i64([dim], "axes"), ctx.i64([step], "steps")])


@_reg(aten.select.int)
def _h_select(ctx, node, args, kwargs, out):
    x, dim, index = args
    dim = _dim(dim, len(x.shape))
    index = index % x.shape[dim]
    y = ctx.node("Slice", [ctx.inp(x), ctx.i64([index], "starts"), ctx.i64([index + 1], "ends"),
                           ctx.i64([dim], "axes")])
    return ctx.reshape(y, out.shape)


@_reg(aten.flip.default)
def _h_flip(ctx, node, args, kwargs, out):
    x, dims = args
    axes = [_dim(d, len(x.shape)) for d in dims]
    n = len(axes)
    return ctx.node("Slice", [ctx.inp(x), ctx.i64([-1] * n, "starts"),
                              ctx.i64([_INT64_MIN] * n, "ends"), ctx.i64(axes, "axes"),
                              ctx.i64([-1] * n, "steps")])


@_reg(aten.constant_pad_nd.default, aten.pad.default)
def _h_pad(ctx, node, args, kwargs, out):
    x, pad = args[:2]
    if node.target == aten.pad.default:
        mode = args[2] if len(args) > 2 else kwargs.get("mode", "constant")
        if mode != "constant":
            raise NotImplementedError(f"onnx: {mode} padding")
        value = args[3] if len(args) > 3 else kwargs.get("value")
    else:
        value = args[2] if len(args) > 2 else kwargs.get("value")
    value = 0 if value is None else value
    rank = len(x.shape)
    lo, hi = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):  # torch pads the last dims first
        lo[rank - 1 - i], hi[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    if any(p < 0 for p in lo + hi):
        raise NotImplementedError(f"onnx: negative padding {pad}")
    return ctx.node("Pad", [ctx.inp(x), ctx.i64(lo + hi, "pads"), ctx.scalar(value, out.dtype)],
                    mode="constant")


def _pair(v, n=2):
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    return v * n if len(v) == 1 else v


@_reg(aten.conv2d.default, aten.conv1d.default)
def _h_conv(ctx, node, args, kwargs, out):
    x, w, bias, stride, padding, dilation, groups = (
        list(args) + [None, 1, 0, 1, 1][len(args) - 2:])[:7]
    nsp = len(w.shape) - 2
    if isinstance(padding, str):
        raise NotImplementedError(f"onnx: {node.target} with padding='{padding}'")
    y = ctx.node("Conv", [ctx.inp(x), ctx.inp(w)], strides=_pair(stride, nsp),
                 pads=_pair(padding, nsp) * 2, dilations=_pair(dilation, nsp), group=int(groups))
    if bias is not None:
        y = ctx.node("Add", [y, ctx.reshape(ctx.inp(bias), [1, -1] + [1] * nsp)])
    return y


@_reg(aten.conv_transpose2d.input)
def _h_conv_transpose(ctx, node, args, kwargs, out):
    """A transposed conv as a Conv over the zero-inserted input, with the
    kernel flipped and its in / out channels swapped per group (as
    jax2onnx's lhs_dilation chain)."""
    x, w, bias, stride, padding, output_padding, groups, dilation = (
        list(args) + [None, 1, 0, 0, 1, 1][len(args) - 2:])[:8]
    if not w.is_const:
        raise NotImplementedError("onnx: conv_transpose2d with a computed weight")
    stride, padding = _pair(stride), _pair(padding)
    output_padding, dilation = _pair(output_padding), _pair(dilation)
    cin, cout_g, kh, kw = w.shape
    wt = (w.const.unflatten(0, (groups, cin // groups)).transpose(1, 2)
          .flatten(0, 1).flip(-2, -1))  # (out, in / groups, kh, kw)
    name, shape = ctx.inp(x), list(x.shape)
    for ax, s in ((2, stride[0]), (3, stride[1])):
        if s == 1:
            continue
        inter = shape[:ax + 1] + [1] + shape[ax + 1:]
        name = ctx.reshape(name, inter)
        pads = [0] * len(inter) * 2
        pads[len(inter) + ax + 1] = s - 1  # hi-pad the inserted unit dim
        name = ctx.node("Pad", [name, ctx.i64(pads, "pads"), ctx.scalar(0, x.dtype, "zero")],
                        mode="constant")
        shape[ax] *= s
        name = ctx.reshape(name, shape)
        name = ctx.node("Slice", [name, ctx.i64([0], "starts"), ctx.i64([shape[ax] - (s - 1)], "ends"),
                                  ctx.i64([ax], "axes")])
        shape[ax] -= s - 1
    k = (kh, kw)
    lo = [dilation[i] * (k[i] - 1) - padding[i] for i in range(2)]
    hi = [lo[i] + output_padding[i] for i in range(2)]
    if min(lo + hi) < 0:
        raise NotImplementedError(f"onnx: conv_transpose2d padding {padding} past its kernel {k}")
    y = ctx.node("Conv", [name, ctx.inp(_Val(const=wt))], strides=[1, 1], pads=lo + hi,
                 dilations=dilation, group=int(groups))
    if bias is not None:
        y = ctx.node("Add", [y, ctx.reshape(ctx.inp(bias), [1, -1, 1, 1])])
    return y


@_reg(aten.max_pool2d.default)
def _h_maxpool(ctx, node, args, kwargs, out):
    x, kernel, stride, padding, dilation, ceil_mode = (
        list(args) + [[], 0, 1, False][len(args) - 2:])[:6]
    kernel = _pair(kernel)
    stride = _pair(stride) if stride else kernel
    padding = _pair(padding)
    if ceil_mode or any(d != 1 for d in _pair(dilation)):
        raise NotImplementedError("onnx: max_pool2d with ceil_mode or dilation")
    return ctx.node("MaxPool", [ctx.inp(x)], kernel_shape=kernel, strides=stride,
                    pads=padding * 2)


@_reg(aten.upsample_nearest2d.vec, aten.upsample_nearest2d.default)
def _h_upsample(ctx, node, args, kwargs, out):
    """Nearest upsampling by whole factors: Reshape / Expand / Reshape."""
    x = args[0]
    b, c, h, w = x.shape
    ho, wo = out.shape[2:]
    if ho % h or wo % w:
        raise NotImplementedError(f"onnx: nearest upsampling {h}x{w} -> {ho}x{wo}")
    sh, sw = ho // h, wo // w
    y = ctx.reshape(ctx.inp(x), [b, c, h, 1, w, 1])
    y = ctx.node("Expand", [y, ctx.i64([b, c, h, sh, w, sw])])
    return ctx.reshape(y, [b, c, ho, wo])


@_reg(aten.upsample_bilinear2d.vec, aten.upsample_bilinear2d.default)
def _h_bilinear(ctx, node, args, kwargs, out):
    """Bilinear resizing as Wh @ x @ Ww^T: the two interpolation matrices are
    the op itself applied at export time to one-hot rows and columns."""
    x = args[0]
    _, _, h, w = x.shape
    rows = torch.eye(h, dtype=out.dtype)[:, None, :, None].expand(h, 1, h, w).contiguous()
    cols = torch.eye(w, dtype=out.dtype)[:, None, None, :].expand(w, 1, h, w).contiguous()
    rest = _const_args(args[1:])
    wh = node.target(rows, *rest)[:, 0, :, 0].t()  # (Ho, H)
    wwt = node.target(cols, *rest)[:, 0, 0, :]  # (W, Wo)
    y = ctx.node("MatMul", [ctx.inp(x), ctx.inp(_Val(const=wwt.contiguous()))])
    return ctx.node("MatMul", [ctx.inp(_Val(const=wh.contiguous())), y])


def _softmax(ctx, name: str, dim: int, dtype):
    m = ctx.node("ReduceMax", [name], axes=[dim], keepdims=1)
    e = ctx.node("Exp", [ctx.node("Sub", [name, m])])
    return ctx.node("Div", [e, ctx.node("ReduceSum", [e, ctx.i64([dim], "axes")], keepdims=1)])


@_reg(aten.softmax.int, aten._softmax.default)
def _h_softmax(ctx, node, args, kwargs, out):
    x, dim = args[:2]
    return _softmax(ctx, ctx.cast(x, out.dtype), _dim(dim, len(x.shape)), out.dtype)


def _axes(x: _Val, dims):
    rank = len(x.shape)
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return list(range(rank))
    return [_dim(d, rank) for d in ([dims] if isinstance(dims, int) else dims)]


@_reg(aten.mean.dim, aten.mean.default)
def _h_mean(ctx, node, args, kwargs, out):
    x = args[0]
    axes = _axes(x, args[1] if len(args) > 1 else None)
    keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    s = ctx.node("ReduceSum", [ctx.cast(x, out.dtype), ctx.i64(axes, "axes")], keepdims=int(keep))
    return ctx.node("Div", [s, ctx.scalar(math.prod(x.shape[a] for a in axes), out.dtype)])


@_reg(aten.sum.default, aten.sum.dim_IntList)
def _h_sum(ctx, node, args, kwargs, out):
    x = args[0]
    dims = args[1] if len(args) > 1 else None
    keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    return ctx.node("ReduceSum", [ctx.cast(x, out.dtype), ctx.i64(_axes(x, dims), "axes")],
                    keepdims=int(keep))


@_reg(aten.amax.default, aten.amin.default)
def _h_amax(ctx, node, args, kwargs, out):
    x = args[0]
    dims = args[1] if len(args) > 1 else []
    keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    op = "ReduceMax" if node.target == aten.amax.default else "ReduceMin"
    return ctx.node(op, [ctx.inp(x)], axes=_axes(x, dims), keepdims=int(keep))


@_reg(aten.matmul.default, aten.bmm.default, aten.mm.default)
def _h_matmul(ctx, node, args, kwargs, out):
    return ctx.node("MatMul", [ctx.inp(args[0]), ctx.inp(args[1])])


@_reg(aten.linear.default)
def _h_linear(ctx, node, args, kwargs, out):
    x, w = args[:2]
    bias = args[2] if len(args) > 2 else None
    wt = _Val(const=w.const.t()) if w.is_const else None
    y = ctx.node("MatMul", [ctx.inp(x), ctx.inp(wt) if wt is not None
                            else ctx.node("Transpose", [ctx.inp(w)], perm=[1, 0])])
    return y if bias is None else ctx.node("Add", [y, ctx.inp(bias)])


def _einsum(ctx, eq: str, a: _Val, an: str, b: _Val, bn: str):
    """Two-operand einsum as Transpose / Reshape / MatMul / Reshape / Transpose."""
    lhs, res = eq.replace(" ", "").split("->")
    la, lb = lhs.split(",")
    if len(set(la)) != len(la) or len(set(lb)) != len(lb) or any(c not in la + lb for c in res) \
            or any(c not in lb + res for c in la) or any(c not in la + res for c in lb):
        raise NotImplementedError(f"onnx: einsum '{eq}'")
    size = {**dict(zip(la, a.shape)), **dict(zip(lb, b.shape))}
    batch = [c for c in la if c in lb and c in res]
    contract = [c for c in la if c in lb and c not in res]
    af = [c for c in la if c not in lb]
    bf = [c for c in lb if c not in la]

    def prep(name, letters, order, shape):
        perm = [letters.index(c) for c in order]
        if perm != list(range(len(perm))):
            name = ctx.node("Transpose", [name], perm=perm)
        return ctx.reshape(name, shape)

    nb = math.prod(size[c] for c in batch)
    m, k, n = (math.prod(size[c] for c in g) for g in (af, contract, bf))
    x = prep(an, la, batch + af + contract, [nb, m, k])
    y = prep(bn, lb, batch + contract + bf, [nb, k, n])
    z = ctx.reshape(ctx.node("MatMul", [x, y]), [size[c] for c in batch + af + bf])
    order = batch + af + bf
    perm = [order.index(c) for c in res]
    return z if perm == list(range(len(perm))) else ctx.node("Transpose", [z], perm=perm)


@_reg(aten.einsum.default)
def _h_einsum(ctx, node, args, kwargs, out):
    eq, ops = args[:2]
    if len(ops) != 2:
        raise NotImplementedError(f"onnx: einsum over {len(ops)} operands")
    a, b = ops
    return _einsum(ctx, eq, a, ctx.inp(a), b, ctx.inp(b))


@_reg(aten.batch_norm.default, aten._native_batch_norm_legit_no_training.default)
def _h_batch_norm(ctx, node, args, kwargs, out):
    """Inference BatchNorm as x * scale + shift, both folded at export time."""
    if node.target == aten.batch_norm.default:
        x, w, b, mean, var, training, _momentum, eps = args[:8]
        if training:
            raise NotImplementedError("onnx: batch_norm in training mode")
    else:
        x, w, b, mean, var, _momentum, eps = args[:7]
    if not all(t is None or t.is_const for t in (w, b, mean, var)):
        raise NotImplementedError("onnx: batch_norm with computed statistics")
    scale = torch.rsqrt(var.const.float() + eps)
    if w is not None:
        scale = scale * w.const.float()
    shift = -mean.const.float() * scale
    if b is not None:
        shift = shift + b.const.float()
    shape = [1, -1] + [1] * (len(x.shape) - 2)
    y = ctx.node("Mul", [ctx.inp(x), ctx.inp(_Val(const=scale.reshape(shape).to(x.dtype)))])
    y = ctx.node("Add", [y, ctx.inp(_Val(const=shift.reshape(shape).to(x.dtype)))])
    return [y, None, None] if isinstance(out, list) else y


def _la_decomposition(ctx, node, args, kwargs, out):
    """The registered linear-attention op as its plain version
    (ops/linear_attention.py::linear_attention_reference): (B, N, H, D) in and out."""
    q, k, v = (ctx.cast(t, torch.float32) for t in args)
    kp = _softmax(ctx, k, 3, torch.float32)  # softmax over D
    qe = ctx.node("Exp", [ctx.node("Sub", [q, ctx.node("ReduceMax", [q], axes=[1], keepdims=1)])])
    qsum = ctx.node("ReduceSum", [qe, ctx.i64([1], "axes")], keepdims=1)
    qp = ctx.node("Div", [qe, ctx.node("Add", [qsum, ctx.scalar(1e-9, torch.float32)])])
    kt = ctx.node("Transpose", [kp], perm=[0, 2, 3, 1])  # (B, H, D, N)
    vt = ctx.node("Transpose", [v], perm=[0, 2, 1, 3])  # (B, H, N, E)
    context = ctx.node("MatMul", [kt, vt])  # (B, H, D, E)
    y = ctx.node("MatMul", [ctx.node("Transpose", [qp], perm=[0, 2, 1, 3]), context])
    y = ctx.node("Transpose", [y], perm=[0, 2, 1, 3])  # (B, N, H, E)
    return y if out.dtype == torch.float32 else ctx.node(
        "Cast", [y], to=P.DTYPE_CODE[_np_dtype(out.dtype)])


def _custom_handlers():
    from edgeyolo_tpu_torch.ops import linear_attention as la

    return {la.linear_attention_op: _la_decomposition}


# ------------------------------------------------------------ converter ---


def _meta(node):
    val = node.meta.get("val")
    if isinstance(val, (list, tuple)):
        return [v if isinstance(v, torch.Tensor) else None for v in val]
    return val


def _read(env, a):
    """A node's argument with graph nodes replaced by their values."""
    if isinstance(a, torch.fx.Node):
        return env[a]
    if isinstance(a, (list, tuple)):
        return type(a)(_read(env, x) for x in a)
    if isinstance(a, dict):
        return {k: _read(env, x) for k, x in a.items()}
    return a


def _const_args(a):
    """Argument values for evaluating a node at export time (constants only)."""
    if isinstance(a, _Val):
        return a.const
    if isinstance(a, (list, tuple)):
        return type(a)(_const_args(x) for x in a)
    if isinstance(a, dict):
        return {k: _const_args(x) for k, x in a.items()}
    if isinstance(a, torch.device):
        return torch.device("cpu")
    return a


def _all_const(a) -> bool:
    if isinstance(a, _Val):
        return a.is_const
    if isinstance(a, (list, tuple)):
        return all(_all_const(x) for x in a)
    if isinstance(a, dict):
        return all(_all_const(x) for x in a.values())
    return True


def _shapes(a):
    """Arguments as they appear in an error: tensors by their shapes."""
    if isinstance(a, _Val):
        return a.shape
    if isinstance(a, (list, tuple)):
        return type(a)(_shapes(x) for x in a)
    return a


def _wrap(value):
    """An export-time result as _Val(s)."""
    if isinstance(value, torch.Tensor):
        return _Val(const=value.detach().cpu())
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _walk(ctx, gm: torch.fx.GraphModule, env: dict, handlers: dict):
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "output"):
            continue
        if node.op == "get_attr":
            env[node] = _wrap(getattr(gm, node.target)) if isinstance(
                getattr(gm, node.target), torch.Tensor) else getattr(gm, node.target)
            continue
        target = node.target
        args, kwargs = _read(env, node.args), _read(env, node.kwargs)
        if target in _SKIP:
            continue
        if target is operator.getitem:
            env[node] = args[0][args[1]]
            continue
        if target in _PASS or (target in (aten.to.dtype, aten._to_copy.default)
                               and isinstance(args[0], _Val) and not args[0].is_const
                               and args[0].dtype == _meta(node).dtype):
            env[node] = args[0]
            continue
        name = getattr(target, "__name__", str(target))
        if name in _HOPS:  # inline the sub-graph
            i = 4 if name == "wrap_with_autocast" else 1
            sub = args[i]
            sub_env = dict(zip([n for n in sub.graph.nodes if n.op == "placeholder"], args[i + 1:]))
            _walk(ctx, sub, sub_env, handlers)
            (res,) = [n for n in sub.graph.nodes if n.op == "output"]
            env[node] = _read(sub_env, res.args[0])
            continue
        if target in _LIKE:
            out = _meta(node)
            fill = _LIKE[target] if _LIKE[target] is not None else args[1]
            env[node] = _Val(const=torch.full(tuple(out.shape), fill, dtype=out.dtype))
            continue
        if _all_const(args) and _all_const(kwargs):
            env[node] = _wrap(target(*_const_args(args), **_const_args(kwargs)))
            continue
        if target not in handlers:
            raise NotImplementedError(f"onnx: no converter for ATen op '{target}' "
                                      f"(inputs {_shapes(args)})")
        out = _meta(node)
        names = handlers[target](ctx, node, args, kwargs, out)
        if isinstance(names, list):
            env[node] = [None if nm is None else _Val(name=nm, shape=o.shape, dtype=o.dtype)
                         for nm, o in zip(names, out)]
        else:
            env[node] = _Val(name=names, shape=out.shape, dtype=out.dtype)


def export_onnx_bytes(ep, input_names=("images",), output_prefix="output",
                      graph_name="edgeyolo_tpu_torch", doc="", metadata=None) -> bytes:
    """ONNX ModelProto bytes (opset 17) of an ExportedProgram with static shapes.

    Parameters, buffers and lifted constants are export-time constants;
    user inputs are named `input_names`, outputs `{output_prefix}0..N`.
    """
    gm, sig = ep.graph_module, ep.graph_signature
    consts = {**sig.inputs_to_parameters, **sig.inputs_to_buffers,
              **sig.inputs_to_lifted_tensor_constants}
    handlers = {**_H, **_custom_handlers()}
    ctx, env, g_inputs = _Ctx(), {}, []
    users = iter(input_names)
    for node in gm.graph.nodes:
        if node.op != "placeholder":
            continue
        if node.name in consts:
            key = consts[node.name]
            t = ep.state_dict[key] if key in ep.state_dict else ep.constants[key]
            env[node] = _Val(const=t.detach().cpu())
        else:
            val = node.meta["val"]
            if any(not isinstance(s, int) for s in val.shape):
                raise NotImplementedError("onnx: export needs static shapes")
            name = next(users)
            env[node] = _Val(name=name, shape=val.shape, dtype=val.dtype)
            g_inputs.append(P.value_info_proto(name, _np_dtype(val.dtype), val.shape))
    _walk(ctx, gm, env, handlers)
    (out_node,) = [n for n in gm.graph.nodes if n.op == "output"]
    g_outputs = []
    for i, v in enumerate(_read(env, out_node.args[0])):
        nm = f"{output_prefix}{i}"
        ctx.nodes.append(P.node_proto("Identity", [ctx.inp(v)], [nm]))
        g_outputs.append(P.value_info_proto(nm, _np_dtype(v.dtype), v.shape))
    graph = P.graph_proto(ctx.nodes, graph_name, ctx.inits, g_inputs, g_outputs)
    return P.model_proto(graph, opset=17, doc=doc, metadata=metadata)

