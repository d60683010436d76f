"""Tracing and profiling (edgeyolo_tpu/utils/profiling.py): traces, stage
timers, operation counts and AutoBatch.

- `trace(log_dir)`: a torch.profiler trace of the enclosed region (the card's
  kernels too when there is one), written as `log_dir/trace.json` (Chrome's
  trace format).
- `cost_analysis(fn, *args)`: JAX's three keys, counted over the aten ops of
  one call of fn by a TorchDispatchMode: `flops` of the matrix products and
  convolutions (two per multiply-add, by torch's flop registry),
  `bytes_accessed` (every op's tensor inputs read and outputs written once)
  and `transcendentals` (the elements that exp, log, sigmoid, tanh, erf,
  sqrt and their kin produce).
- `memory_analysis(fn, *args)`: one call of fn on the card, its peak of
  allocated bytes above the allocation before the call (`peak_bytes`) and
  its arguments' and outputs' bytes; `{}` for arguments on the CPU, as JAX
  answers when it has no analysis.
- `autobatch(model, ...)`: JAX's rule: the candidates 1, 2, ..., 64 in
  order, each probed by the same program (the eval forward; with `train`,
  also the gradient of the sum of pred squared), measured at run time; the
  largest whose peak fits `fraction` of the card's memory, stopping at the
  first that does not and at an out-of-memory error. None fits, on the CPU
  too: RuntimeError naming `batch=`.
- `StageTimer`: named host-clock timers, the card synchronised at each
  boundary (the reference's Profile).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from edgeyolo_tpu_torch.utils import LOGGER

CANDIDATES = (1, 2, 4, 8, 16, 32, 64)
_TRANSCENDENTAL = frozenset({"exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sigmoid",
                             "tanh", "erf", "erfc", "sqrt", "rsqrt", "sin", "cos", "pow",
                             "_softmax", "_log_softmax", "silu", "gelu", "softplus",
                             "logit", "atan", "atan2"})


@contextlib.contextmanager
def trace(log_dir: str | Path = "runs/profile"):
    """A torch.profiler trace of the block (CPU, and CUDA when a card is
    present), saved as log_dir/trace.json; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))
    LOGGER.info(f"profiler: trace written to {out / 'trace.json'}")


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _CostMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = self.bytes = self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
        self.bytes += _bytes(_tensors((args, kwargs))) + _bytes(_tensors(out))
        name = packet.__name__.rstrip("_")
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        return out


def cost_analysis(fn, *example_args) -> dict:
    """flops, bytes_accessed and transcendentals of one call of fn(*args)."""
    mode = _CostMode()
    with torch.no_grad(), mode:
        fn(*example_args)
    return {"flops": float(mode.flops), "bytes_accessed": float(mode.bytes),
            "transcendentals": float(mode.transcendentals)}


def memory_analysis(fn, *example_args) -> dict:
    """Bytes of one call of fn(*args) on the card: `peak_bytes` above what was
    allocated before it, its arguments' and outputs' bytes, and `temp_bytes`,
    the peak less the outputs. `{}` when the arguments lie on the CPU."""
    args = _tensors(example_args)
    cuda = [t for t in args if t.is_cuda]
    if not cuda:
        return {}
    dev = cuda[0].device
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*example_args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    out_bytes = _bytes(_tensors(out))
    return {"temp_bytes": max(peak - out_bytes, 0), "argument_bytes": _bytes(args),
            "output_bytes": out_bytes, "peak_bytes": peak}


def _probe(model: torch.nn.Module, train: bool):
    """The program AutoBatch measures: the eval forward, or its parameter
    gradient of the sum of pred squared."""
    params = [p for p in model.parameters() if p.requires_grad]

    def probe(img: torch.Tensor):
        if not train:
            with torch.no_grad():
                return model(img)["pred"]
        with torch.enable_grad():
            pred = model(img)["pred"]
            loss = sum(t.float().square().sum() for t in _tensors(pred))
            return torch.autograd.grad(loss, params)

    return probe


def autobatch(model: torch.nn.Module, imgsz: int = 640, fraction: float = 0.60,
              total_bytes: int | None = None, candidates=CANDIDATES, train: bool = False,
              peaks: dict | None = None) -> int:
    """The largest candidate batch whose measured peak fits `fraction` of the
    card's memory (`total_bytes`, default the card's total). `peaks`, when
    given, receives each probed candidate's peak bytes."""
    device = next(model.parameters()).device
    if total_bytes is None:
        total_bytes = (torch.cuda.get_device_properties(device).total_memory
                       if device.type == "cuda" else 0)
    budget = total_bytes * fraction
    probe = _probe(model, train)
    was_training = model.training
    model.eval()
    best, errors = None, []
    peaks = {} if peaks is None else peaks
    try:
        for b in candidates:
            x = torch.zeros(b, 3, imgsz, imgsz, device=device, dtype=getattr(model, "dtype",
                                                                            torch.float32))
            try:
                mem = memory_analysis(probe, x)
            except torch.cuda.OutOfMemoryError as e:
                errors.append(f"b={b}: out of memory ({str(e).splitlines()[0]})")
                break
            finally:
                del x
            peak = mem.get("peak_bytes") or 0
            peaks[b] = peak
            if peak and peak <= budget:
                best = b
            elif peak:
                break
    finally:
        model.train(was_training)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if best is None:
        raise RuntimeError(
            f"autobatch: could not size a batch for imgsz={imgsz} within "
            f"{budget / 1e9:.1f} GB ({'; '.join(errors) or 'no candidate fits'}); "
            f"pass an explicit batch=")
    LOGGER.info(f"autobatch: batch={best} for imgsz={imgsz} (budget {budget / 1e9:.1f} GB of "
                f"{total_bytes / 1e9:.1f} GB, {'train' if train else 'inference'} probe)")
    return best



class StageTimer:
    """Named stage timers producing a speed dict (the Results.speed shape);
    on a CUDA `device` the card is synchronised at each boundary."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = torch.device(device) if device is not None else None
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def speeds_ms(self) -> dict:
        return {k: self.totals[k] / max(self.counts[k], 1) * 1000 for k in self.totals}
