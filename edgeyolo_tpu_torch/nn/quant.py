"""Post-training int8 quantization (PTQ) for inference (edgeyolo_tpu/nn/quant.py).

One calibration pass records each conv's input absmax; the int8 forward then
runs every calibrated conv as

    xq = clip(round(x / sx), -127, 127)       per-tensor symmetric input scale
    acc = conv(xq, wq)                        int8 x int8, int32 sums
    y = f32(acc) * (sx * ws[o]) (+ bias)      per-output-channel weight scales

through ops/int8_conv.py (the CUDA kernel on the card, its plain version on
the CPU). BatchNorm, activations, the decode and NMS stay f32 or bf16.

The convs are those JAX's interceptor reaches, flax's `nn.Conv` modules: in
the port every `nn.Conv2d` but the DFL's fixed bins conv (JAX's is no
`nn.Conv`). The Haar DWT, linear layers, 1-D and transposed convs are not
`nn.Conv2d`s. Everything is keyed by the port's module names
(`model.2.cv1.conv`); `skip` takes substrings of them, as JAX's takes
substrings of its paths.

`quantize(model, scales)` makes a `QuantState` from full-precision weights
and biases: those of `model.master` for a bf16 copy (`for_precision`), as
JAX quantizes its f32 params whatever the request's dtype. `install(model,
qs)` swaps each quantized `nn.Conv2d` for a `QConv2d` that shares its
Parameters and holds the int8 pack as non-persistent buffers, so the
state_dict keys stay the same (checkpoints, `.pt2` export and
`from_jax_variables` read them); `uninstall` swaps them back.
`DetectionModel.quant` does both when set. A QConv2d in training mode runs
the conv's own forward: training is full precision.
"""

from __future__ import annotations

import contextlib
from typing import Iterable

import numpy as np
import torch
from torch import nn

from edgeyolo_tpu_torch.nn.modules.block import DFL
from edgeyolo_tpu_torch.ops.int8_conv import int8_conv, pack_weights
from edgeyolo_tpu_torch.utils import LOGGER

__all__ = ["QuantState", "calibrate", "quantize", "quant_ctx", "install", "uninstall",
           "int8_convs", "set_int8", "QConv2d"]


class QuantState:
    """Calibrated activation scales and pre-quantized int8 weights.

    act_scales: {name: float}            per-tensor input absmax
    wq:         {name: int8 (O, I/g, kh, kw)}   quantized weights (CPU)
    ws:         {name: f32 (O,)}         per-output-channel weight scales (CPU)
    bias:       {name: f32 (O,)}         full-precision biases (CPU), one for
                                         each quantized conv that has a bias
    """

    def __init__(self, act_scales: dict, wq: dict, ws: dict, skip=(), bias=None):
        self.act_scales = act_scales
        self.wq = wq
        self.ws = ws
        self.skip = tuple(skip)
        self.bias = bias or {}

    def skipped(self, name: str) -> bool:
        return any(s in name for s in self.skip)

    def __repr__(self):
        return (f"QuantState({len(self.wq)} int8 convs, "
                f"{len(self.act_scales)} calibrated scales, skip={self.skip})")


def int8_convs(model: nn.Module) -> dict[str, nn.Conv2d]:
    """The convs the int8 forward may take: every nn.Conv2d but a DFL's."""
    dfl = {id(m.conv) for m in model.modules() if isinstance(m, DFL)}
    return {name: m for name, m in model.named_modules()
            if isinstance(m, nn.Conv2d) and id(m) not in dfl}


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[torch.Tensor]) -> dict[str, float]:
    """Eval forwards over `batches` (model-space NCHW inputs on the model's
    device); returns {name: running absmax of the conv's input in f32}. The
    running maxima stay on the device and are read once at the end."""
    convs = int8_convs(model)
    stats: dict[str, torch.Tensor] = {}

    def observe(name):
        def hook(_m, args):
            m = args[0].detach().float().abs().amax()
            stats[name] = m if name not in stats else torch.maximum(stats[name], m)
        return hook

    def one2many(m, args):
        m.one2many(args[0])

    was_training = model.training
    handles = [m.register_forward_pre_hook(observe(n)) for n, m in convs.items()]
    # an end-to-end head's eval forward skips its one2many branch; JAX's computes
    # it, so JAX calibrates (and quantizes) those convs too
    handles += [m.register_forward_pre_hook(one2many) for m in model.modules()
                if getattr(m, "end2end", False) and hasattr(m, "one2many")]
    try:
        model.eval()
        for x in batches:
            model(x)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    names = list(stats)
    values = torch.stack([stats[n] for n in names]).cpu().tolist() if names else []
    return dict(zip(names, values))


def quantize(model: nn.Module, act_scales: dict, skip=()) -> QuantState:
    """Every calibrated conv's weight to int8 with per-output-channel scales,
    in f32 numpy as JAX computes them: s = absmax over (in, kh, kw) / 127,
    1 where s < 1e-12, codes clip(rint(w / s), -127, 127). The weights and
    biases are `model.master`'s where a bf16 copy has one (`for_precision`)."""
    convs = int8_convs(model.__dict__.get("master", model))
    wq, ws, bias = {}, {}, {}
    for name in act_scales:
        if any(s in name for s in skip) or name not in convs:
            continue
        kf = convs[name].weight.detach().float().cpu().numpy()
        s = np.abs(kf).max(axis=(1, 2, 3)) / 127.0
        s = np.where(s < 1e-12, 1.0, s).astype(np.float32)
        q = np.clip(np.rint(kf / s[:, None, None, None]), -127, 127).astype(np.int8)
        wq[name] = torch.from_numpy(q)
        ws[name] = torch.from_numpy(s)
        if convs[name].bias is not None:
            bias[name] = convs[name].bias.detach().float().cpu()
    return QuantState(act_scales, wq, ws, skip, bias)


def act_scale(absmax: float) -> np.float32:
    """sx = f32(max(absmax, 1e-12) / 127), divided in Python floats and rounded once."""
    return np.float32(max(absmax, 1e-12) / 127.0)


def _same_padding(conv: nn.Conv2d) -> tuple[int, int]:
    pads = []
    for k, d in zip(conv.kernel_size, conv.dilation):
        total = d * (k - 1)
        if total % 2:
            raise ValueError(f"int8 conv: 'same' padding of kernel {k} at dilation {d} is "
                             f"asymmetric")
        pads.append(total // 2)
    return tuple(pads)


def _retype(conv: nn.Module, cls: type) -> nn.Module:
    """A module of class `cls` sharing conv's Parameters and buffers, with its
    own registries (so buffers added to one do not appear in the other)."""
    m = cls.__new__(cls)
    m.__dict__ = dict(conv.__dict__)
    m._parameters = dict(conv._parameters)
    m._buffers = dict(conv._buffers)
    m._non_persistent_buffers_set = set(conv._non_persistent_buffers_set)
    m._modules = dict(conv._modules)
    return m


class QConv2d(nn.Conv2d):
    """An nn.Conv2d whose eval forward is the int8 conv. Made by `install` from
    a calibrated conv (same Parameters, same state_dict keys); the int8 pack is
    non-persistent buffers: `wq`, its dp4a packing `wpack`, `scale` =
    f32(sx * ws) and the f32 bias `qbias` (None for a conv without one), the
    last two kept f32 when the module is cast."""

    _F32 = ("scale", "qbias")

    @classmethod
    def from_conv(cls, conv: nn.Conv2d, wq: torch.Tensor, ws: torch.Tensor,
                  sx: np.float32, bias: torch.Tensor | None) -> "QConv2d":
        if conv.padding_mode != "zeros":
            raise ValueError(f"int8 conv: padding mode {conv.padding_mode} is not supported")
        m = _retype(conv, cls)
        dev = conv.weight.device
        m.sx = float(sx)
        m.rcp = float(np.float32(1.0) / sx)  # what XLA makes of JAX's x / sx
        m.pad = _same_padding(conv) if isinstance(conv.padding, str) else tuple(conv.padding)
        m.register_buffer("wq", wq.to(dev), persistent=False)
        m.register_buffer("wpack", pack_weights(m.wq), persistent=False)
        m.register_buffer("scale", torch.from_numpy(sx * ws.numpy()).to(dev), persistent=False)
        m.register_buffer("qbias", None if bias is None else bias.float().to(dev),
                          persistent=False)
        return m

    def _apply(self, fn, recurse=True):
        kept = {k: getattr(self, k) for k in self._F32}
        super()._apply(fn, recurse)
        for k, t in kept.items():  # a dtype cast leaves them f32
            if t is not None:
                setattr(self, k, t.to(self.weight.device))
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        return int8_conv(x, self.wq, self.wpack, self.scale, self.rcp, self.qbias, self.stride,
                         self.pad, self.dilation, self.groups)


def _parent(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    parent, _, attr = name.rpartition(".")
    return (model.get_submodule(parent) if parent else model), attr


def install(model: nn.Module, qs: QuantState) -> int:
    """Swap each conv of `qs` (not skipped) for its QConv2d; returns how many."""
    uninstall(model)
    convs = int8_convs(model)
    n = 0
    for name, wq in qs.wq.items():
        if qs.skipped(name):
            continue
        if name not in convs:
            raise KeyError(f"QuantState names {name}, which is no conv of this model")
        parent, attr = _parent(model, name)
        conv, bias = convs[name], qs.bias.get(name)
        if (bias is None) != (conv.bias is None):
            raise KeyError(f"QuantState's bias of {name} does not match the conv's")
        setattr(parent, attr, QConv2d.from_conv(conv, wq, qs.ws[name],
                                                act_scale(qs.act_scales[name]), bias))
        n += 1
    return n


def uninstall(model: nn.Module) -> None:
    """Every QConv2d back to a plain nn.Conv2d over the same Parameters."""
    for name, m in list(model.named_modules()):
        if isinstance(m, QConv2d):
            plain = _retype(m, nn.Conv2d)
            for key in ("wq", "wpack", "scale", "qbias"):
                plain._buffers.pop(key, None)
                plain._non_persistent_buffers_set.discard(key)
            for key in ("sx", "rcp", "pad"):
                plain.__dict__.pop(key, None)
            parent, attr = _parent(model, name)
            setattr(parent, attr, plain)


@contextlib.contextmanager
def quant_ctx(model: nn.Module, qs: QuantState):
    """`with quant_ctx(model, qs): model(x)`: the int8 forward for the block."""
    install(model, qs)
    try:
        yield model
    finally:
        uninstall(model)


def set_int8(net, want: bool, calib) -> None:
    """The engines' per-call int8 flag (JAX's predictor and validator). The
    state lives on `net.master` for a bf16 copy (`for_precision`), else on
    `net`, as JAX's lives on the handle. With `want`, an active QuantState
    stays, else a stashed one comes back, else `net` is calibrated on
    `calib()` and quantized from the full-precision weights; the state is
    then installed on `net` too. Without it an active QuantState is stashed,
    so the call runs full precision and a later int8 call reuses it. A model
    with no `quant` (a backend adapter) is left alone; one in which no conv
    is quantized raises."""
    model = net.__dict__.get("master", net)
    if not hasattr(model, "quant"):
        return
    if want:
        if model.quant is None:
            model.quant = getattr(model, "_quant_stash", None)
        if model.quant is None:
            net.quant = None  # calibrate the full-precision forward
            model.quant = quantize(net, calibrate(net, [calib()]))
            LOGGER.info(f"int8: calibrated {len(model.quant.wq)} convs")
        if not any(not model.quant.skipped(n) for n in model.quant.wq):
            raise ValueError(f"int8=True but no conv of this model is quantized "
                             f"({model.quant})")
        if net.quant is not model.quant:
            net.quant = model.quant
    else:
        if model.quant is not None:
            model._quant_stash, model.quant = model.quant, None
        if net.quant is not None:
            net.quant = None
