"""In-tree ONNX executor: a numpy interpreter for the op subset the exporter
emits (opset 17).

The port's own copy of edgeyolo_tpu/export/onnx_runtime.py, with the same
op set: export/torch2onnx.py lowers every ATen op to it, so JAX's executor
runs the port's files too.

Purpose (mirrors how the reference pairs exporter.py:487 with
autobackend.py:186 onnxruntime loading): this image has no onnxruntime, so
AutoBackend executes exported .onnx artifacts with this interpreter — which
also closes the loop for tests (export -> parse -> run -> compare vs the live
torch forward). Production users run the same file under onnxruntime/TensorRT
outside this image; this module is the correctness oracle, not a speed path.
"""

from __future__ import annotations

import numpy as np

from edgeyolo_tpu_torch.export import onnx_proto as P


def _conv2d(x, w, strides, pads, dilations, group):
    """x (N,C,H,W), w (M, C/g, kH, kW) -> (N,M,Ho,Wo) via windowed einsum."""
    ph0, pw0, ph1, pw1 = pads
    x = np.pad(x, ((0, 0), (0, 0), (ph0, ph1), (pw0, pw1)))
    kh, kw = w.shape[2], w.shape[3]
    dh, dw = dilations
    sh, sw = strides
    ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    win = np.lib.stride_tricks.sliding_window_view(x, (ekh, ekw), axis=(2, 3))
    win = win[:, :, ::sh, ::sw, ::dh, ::dw]  # (N,C,Ho,Wo,kh,kw)
    N, C, Ho, Wo = win.shape[:4]
    M = w.shape[0]
    cg, mg = C // group, M // group
    out = np.empty((N, M, Ho, Wo), np.result_type(x, w))
    for g in range(group):
        out[:, g * mg:(g + 1) * mg] = np.einsum(
            "nchwij,mcij->nmhw",
            win[:, g * cg:(g + 1) * cg], w[g * mg:(g + 1) * mg],
            optimize=True)
    return out


def _maxpool(x, kernel, strides, pads):
    kh, kw = kernel
    ph0, pw0, ph1, pw1 = pads
    if any(pads):
        x = np.pad(x, ((0, 0), (0, 0), (ph0, ph1), (pw0, pw1)),
                   constant_values=-np.inf)
    win = np.lib.stride_tricks.sliding_window_view(x, (kh, kw), axis=(2, 3))
    return win[:, :, ::strides[0], ::strides[1]].max(axis=(-2, -1))


def _slice(x, starts, ends, axes=None, steps=None):
    axes = list(axes) if axes is not None else list(range(len(starts)))
    steps = list(steps) if steps is not None else [1] * len(starts)
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        st, en, ax, sp = int(st), int(en), int(ax), int(sp)
        d = x.shape[ax]
        if sp > 0:
            st = min(max(st + d if st < 0 else st, 0), d)
            en = min(max(en + d if en < 0 else en, 0), d)
            sl[ax] = slice(st, en, sp)
        else:
            st = min(max(st + d if st < -d else st, -d), d - 1)
            if st < 0:
                st += d
            sl[ax] = slice(st, None if en < -d else en, sp)
    return x[tuple(sl)]


class OnnxModel:
    """Parse ModelProto bytes and execute the graph with numpy."""

    def __init__(self, model_bytes: bytes):
        self.m = P.parse_model(bytes(model_bytes))
        self.input_names = [v["name"] for v in self.m["inputs"]]
        self.output_names = [v["name"] for v in self.m["outputs"]]
        self.input_shapes = {v["name"]: v["shape"] for v in self.m["inputs"]}
        self.doc = self.m["doc"]

    def __call__(self, *args):
        env = dict(self.m["initializers"])
        for nm, a in zip(self.input_names, args):
            env[nm] = np.asarray(a)
        for node in self.m["nodes"]:
            self._exec(node, env)
        outs = [env[n] for n in self.output_names]
        return outs[0] if len(outs) == 1 else outs

    def _exec(self, node, env):
        op, at = node["op"], node["attrs"]
        x = [env[i] for i in node["inputs"] if i]
        o = node["outputs"]

        def put(*vals):
            for nm, v in zip(o, vals):
                env[nm] = v

        if op == "Conv":
            put(_conv2d(x[0], x[1], at.get("strides", [1, 1]),
                        at.get("pads", [0, 0, 0, 0]),
                        at.get("dilations", [1, 1]), at.get("group", 1)))
        elif op == "MaxPool":
            put(_maxpool(x[0], at["kernel_shape"], at.get("strides", [1, 1]),
                         at.get("pads", [0, 0, 0, 0])))
        elif op == "Transpose":
            put(np.transpose(x[0], at["perm"]))
        elif op == "Reshape":
            put(x[0].reshape([int(d) for d in x[1]]))
        elif op == "Expand":
            # ONNX Expand = two-way numpy broadcast against the target shape
            put(np.broadcast_to(x[0], np.broadcast_shapes(
                x[0].shape, tuple(int(d) for d in x[1]))))
        elif op == "Concat":
            put(np.concatenate(x, axis=at["axis"]))
        elif op == "Split":
            sizes = [int(s) for s in x[1]]
            put(*np.split(x[0], np.cumsum(sizes)[:-1], axis=at.get("axis", 0)))
        elif op == "Slice":
            put(_slice(x[0], x[1], x[2], x[3] if len(x) > 3 else None,
                       x[4] if len(x) > 4 else None))
        elif op == "Pad":
            pads = [int(p) for p in x[1]]
            n = len(pads) // 2
            cv = x[2].item() if len(x) > 2 else 0
            put(np.pad(x[0], list(zip(pads[:n], pads[n:])),
                       constant_values=cv))
        elif op == "MatMul":
            put(np.matmul(x[0], x[1]))
        elif op == "Where":
            put(np.where(x[0], x[1], x[2]))
        elif op == "Cast":
            put(x[0].astype(P.CODE_DTYPE[at["to"]]))
        elif op == "Identity":
            put(x[0])
        elif op == "Clip":
            lo = x[1] if len(x) > 1 else -np.inf
            hi = x[2] if len(x) > 2 else np.inf
            put(np.clip(x[0], lo, hi))
        elif op in {"ReduceMax", "ReduceMin", "ReduceProd"}:
            fn = {"ReduceMax": np.max, "ReduceMin": np.min,
                  "ReduceProd": np.prod}[op]
            put(fn(x[0], axis=tuple(at["axes"]),
                   keepdims=bool(at.get("keepdims", 1))))
        elif op == "ReduceSum":
            axes = tuple(int(a) for a in x[1]) if len(x) > 1 else None
            put(np.sum(x[0], axis=axes, keepdims=bool(at.get("keepdims", 1)),
                       dtype=x[0].dtype))
        elif op in {"ArgMax", "ArgMin"}:
            fn = np.argmax if op == "ArgMax" else np.argmin
            r = fn(x[0], axis=at.get("axis", 0)).astype(np.int64)
            put(r if not at.get("keepdims", 1)
                else np.expand_dims(r, at.get("axis", 0)))
        elif op == "CumSum":
            r = x[0]
            # axis arrives as a 0-d or 1-element tensor; int(ndarray) is a
            # hard error in newer numpy
            ax = int(np.asarray(x[1]).reshape(-1)[0])
            if at.get("reverse"):
                r = np.flip(np.cumsum(np.flip(r, ax), axis=ax), ax)
            else:
                r = np.cumsum(r, axis=ax)
            put(r.astype(x[0].dtype))
        elif op == "Mod":
            put(np.fmod(x[0], x[1]) if at.get("fmod") else np.mod(x[0], x[1]))
        elif op in _EW2:
            put(_EW2[op](x[0], x[1]).astype(
                np.result_type(x[0], x[1])
                if op not in _CMP else np.bool_, copy=False))
        elif op in _EW1:
            r = _EW1[op](x[0])
            if op not in {"Not", "IsNaN", "IsInf", "Sign"}:
                r = r.astype(x[0].dtype, copy=False)
            put(r)
        else:
            raise NotImplementedError(f"onnx runtime: op {op}")


_CMP = {"Equal", "Less", "LessOrEqual", "Greater", "GreaterOrEqual",
        "And", "Or", "Xor"}
_EW2 = {
    "Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
    "Div": np.divide, "Pow": np.power,
    "Max": np.maximum, "Min": np.minimum,
    "Equal": np.equal, "Less": np.less, "LessOrEqual": np.less_equal,
    "Greater": np.greater, "GreaterOrEqual": np.greater_equal,
    "And": np.logical_and, "Or": np.logical_or, "Xor": np.logical_xor,
    "Atan2": np.arctan2,
}


def _sigmoid(v):
    with np.errstate(over="ignore"):
        return 1.0 / (1.0 + np.exp(-v))


def _erf(v):
    # Abramowitz-Stegun 7.1.26 (no scipy dependency); |err| < 1.5e-7
    a = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
    s = np.sign(v)
    t = 1.0 / (1.0 + 0.3275911 * np.abs(v))
    poly = t * (a[0] + t * (a[1] + t * (a[2] + t * (a[3] + t * a[4]))))
    return s * (1.0 - poly * np.exp(-v * v))


_EW1 = {
    "Exp": np.exp, "Log": np.log, "Tanh": np.tanh, "Sin": np.sin,
    "Cos": np.cos, "Tan": np.tan, "Atan": np.arctan, "Asin": np.arcsin,
    "Acos": np.arccos, "Abs": np.abs, "Neg": np.negative,
    "Floor": np.floor, "Ceil": np.ceil, "Round": np.round,
    "Sign": np.sign, "Sqrt": np.sqrt, "Reciprocal": np.reciprocal,
    "Sigmoid": _sigmoid, "Erf": _erf, "Not": np.logical_not,
    "IsNaN": np.isnan, "IsInf": np.isinf,
}
