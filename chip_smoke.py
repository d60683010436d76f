#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (edgeyolo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed and each fatal when it fails:
  1. device     card name and power limit, torch and CUDA versions, TF32 switches
  2. build      nvcc builds every CUDA source of edgeyolo_tpu_torch/csrc, all at once
  3. kernels    every kernel's wrapper against its plain PyTorch version, on the card,
                at the shapes the serving path gives it, with times and the bound;
                the attention kernel's split of N and workspace, and two launches
                on the same inputs compared bit for bit
  4. reference  the f32 model on the card (kernel) against the same model on the
                CPU (plain version) at 64 px
  5. serve      EdgeLine-YOLO-n in bf16 at 640 px: 1 warm-up and 3 timed requests
                of 32 images through DetectionPredictor; kernel launch counts, bf16
                activations, output checks, NMS against the scan oracle, the
                prediction against the same model with the plain attention, and
                one profiled request (device time by kernel, device busy share
                of the unprofiled request time)
  6. device     each kernel's device time by torch.profiler at the shapes of phase 3;
     times      after the serve phase, so no profiler session precedes the requests
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout of
the repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FLOP/s by input type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
SERVE_BATCH, SERVE_IMGSZ, SERVE_REQUESTS = 32, 640, 3
# (B, N, H, D, dtype, layout); "qkv" is the module's strided view of the conv output
LA_CASES = [
    (32, 400, 2, 64, "float32", "qkv"),
    (32, 400, 2, 64, "bfloat16", "qkv"),  # the serving path: batch 32 at 640 px
    (128, 400, 2, 64, "bfloat16", "qkv"),
    (128, 1600, 2, 64, "bfloat16", "qkv"),
    (16, 6400, 4, 64, "bfloat16", "qkv"),
    (32, 400, 2, 64, "bfloat16", "bnhd"),
    (4, 999, 3, 32, "float32", "bnhd"),
]
LA_MAIN_CASE = 1
LA_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}  # of max |plain| (bf16: about 5 ulp)


def phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name: str, t0: float):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(fn, calls_per_event: int = 1, samples: int = 30, warmup: int = 5) -> float:
    """Time of one call after warm-up: the median over `samples` of CUDA events
    around `calls_per_event` calls, over the count. With one call per event
    pair (the `ms` of the kernel table) the reading counts the host's work
    from the start event to the first launch; with calls back to back it is
    the card's time where the host enqueues faster than the card runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls_per_event):
            fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / calls_per_event for s, e in events)


def host_ms(fn, calls: int = 200) -> float:
    """Host time of one call, over `calls` calls enqueued without a wait."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return t


def la_inputs(b, n, h, d, dtype, layout, gen):
    import torch

    if layout == "qkv":  # the module's views of the (B, 3*H*D, N) qkv conv output
        qkv = torch.randn(b, 3, h, d, n, device="cuda", generator=gen).to(dtype)
        return [qkv[:, i].permute(0, 3, 1, 2) for i in range(3)]
    return [torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype) for _ in range(3)]


def la_bound(b, n, h, d, dtype):
    """Least time for the work: read q, k, v and write y once; 4*B*H*N*D^2 FLOP."""
    import torch

    nbytes = 4 * b * n * h * d * torch.empty((), dtype=dtype).element_size()
    flops = 4 * b * h * n * d * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_ms_by_kernel(fn, calls: int = 20) -> dict[str, float]:
    """Device time per call of fn, by kernel name, from torch.profiler: the
    kernels alone, where cuda_ms may also count the host's work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def check_kernels(la):
    """Every LA_CASES shape against the plain version, timed; returns the rows
    of the kernel table and the inputs, for device_times after the serve phase."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiny = torch.zeros(1, device="cuda")
    floor_ms = cuda_ms(lambda: tiny.add_(1))
    print(f"event pair around one launch of a 1-element add: {floor_ms:.4f} ms "
          f"(the floor of a one-call `ms`)", flush=True)
    rows, inputs = [], []
    for b, n, h, d, dt, layout in LA_CASES:
        dtype = getattr(torch, dt)
        q, k, v = la_inputs(b, n, h, d, dtype, layout, gen)
        y = la.linear_attention_kernel(q, k, v)
        y_again = la.linear_attention_kernel(q, k, v)
        torch.cuda.synchronize()
        ref = la.linear_attention_reference(q, k, v)
        err = (y.float() - ref.float()).abs().max().item()
        tol = LA_RTOL[dt] * ref.float().abs().max().item()
        same = torch.equal(y, y_again)
        kernel = functools.partial(la.linear_attention_kernel, q, k, v)
        ms = cuda_ms(kernel)
        ms_b2b = cuda_ms(kernel, calls_per_event=30, samples=5)
        host = host_ms(kernel)
        plain_ms = cuda_ms(lambda: la.linear_attention_reference(q, k, v))
        bound_ms, bound_by = la_bound(b, n, h, d, dtype)
        per_sm = la.blocks_per_sm(dtype, d, 0)
        splits, chunk, ws_bytes = la.split_plan(b, n, h, d, sms, per_sm)
        print(f"linear_attention ({b},{n},{h},{d}) {dt} {layout}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e}), kernel {ms:.4f} ms per call, {ms_b2b:.4f} ms back to back, "
              f"host {host:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}); S {splits} chunks of {chunk} tokens, "
              f"{b * h * splits} context blocks, {per_sm} per SM on {sms} SMs, "
              f"workspace {ws_bytes} B; "
              f"two launches bit-identical: {same}", flush=True)
        if not err <= tol:
            raise AssertionError(f"linear attention kernel disagrees with the plain version "
                                 f"at ({b},{n},{h},{d}) {dt}: {err} > {tol}")
        if not same:
            raise AssertionError(f"linear attention kernel is not deterministic at "
                                 f"({b},{n},{h},{d}) {dt}")
        rows.append({"max_abs_err": err, "ms": ms, "ms_back_to_back": ms_b2b, "host_ms": host,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        inputs.append((q, k, v))
    return rows, inputs


def device_times(la, rows, inputs):
    """Add each case's device time (torch.profiler) to its row of the table."""
    for (b, n, h, d, dt, layout), row, (q, k, v) in zip(LA_CASES, rows, inputs):
        by_kernel = device_ms_by_kernel(lambda: la.linear_attention_kernel(q, k, v))
        row["device_ms"] = sum(by_kernel.values())
        print(f"linear_attention ({b},{n},{h},{d}) {dt} {layout}: device {row['device_ms']:.4f} "
              f"ms per call; by kernel: "
              + "; ".join(f"{key[:60]} {t:.4f}" for key, t in by_kernel.items()), flush=True)


def exercise_branches(model):
    """Seeded random weights, plus: the wavelet residual gates open (gamma 0.5)
    and class logits start at 0, so the wavelet branch counts and scores
    straddle the confidence gate, giving NMS real work."""
    import torch

    from edgeyolo_tpu_torch.nn.modules.edgeline import WaveletEnhancer

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, WaveletEnhancer):
                m.gamma.fill_(0.5)
        for seq in model.model[-1].cv3:
            seq[-1].bias.zero_()
    return model


def check_reference():
    import torch

    from edgeyolo_tpu_torch.nn.tasks import DetectionModel

    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    preds = {}
    for dev in ("cpu", "cuda"):
        m = exercise_branches(DetectionModel("edgeline-yolo.yaml", scale="n", device=dev, seed=0))
        with torch.inference_mode():
            preds[dev] = m(x.to(dev))["pred"].float().cpu()
    d = (preds["cuda"] - preds["cpu"]).abs()
    box, cls = d[..., :4].max().item(), d[..., 4:].max().item()
    print(f"f32 64px card (kernel) vs CPU (plain): box {box:.3e} px (tol 5e-3), "
          f"score {cls:.3e} (tol 1e-4)", flush=True)
    if not (torch.isfinite(preds["cuda"]).all() and box < 5e-3 and cls < 1e-4):
        raise AssertionError("the model on the card disagrees with the CPU reference")


def serve(la, card: str):
    import torch
    from torch import nn

    from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor
    from edgeyolo_tpu_torch.nn.modules import edgeline
    from edgeyolo_tpu_torch.nn.modules.edgeline import LinearAttention
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel, num_params
    from edgeyolo_tpu_torch.ops.nms import non_max_suppression

    t0 = time.perf_counter()
    model = exercise_branches(DetectionModel("edgeline-yolo.yaml", scale="n", device="cuda",
                                             dtype=torch.bfloat16, seed=0))
    n_params = num_params(model)
    print(f"model: EdgeLine-YOLO-n, {n_params} params, bf16, built in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if n_params != 2_678_699:
        raise AssertionError(f"param count {n_params} != 2,678,699")
    attn = [m for m in model.modules() if isinstance(m, LinearAttention)]
    predictor = DetectionPredictor(model, conf=0.25, iou=0.7, max_det=300, max_nms=1024,
                                   device="cuda")
    imgs = torch.randint(0, 256, (SERVE_BATCH, SERVE_IMGSZ, SERVE_IMGSZ, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))

    # warm-up, with every bf16 conv's output dtype recorded
    out_dtypes = []
    hooks = [m.register_forward_hook(lambda _m, _i, o: out_dtypes.append(o.dtype))
             for m in model.modules()
             if isinstance(m, nn.Conv2d) and m.weight.dtype == torch.bfloat16]
    t0 = time.perf_counter()
    predictor(imgs)
    torch.cuda.synchronize()
    print(f"warm-up request: {(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    for hk in hooks:
        hk.remove()
    if not out_dtypes or any(dt != torch.bfloat16 for dt in out_dtypes):
        raise AssertionError(f"conv activations are not all bf16: {set(out_dtypes)}")
    print(f"bf16 check: {len(out_dtypes)} conv outputs, all bf16", flush=True)

    la.linear_attention_kernel.launches = 0
    times = []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        det, n = predictor(imgs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = la.linear_attention_kernel.launches
    print(f"linear_attention launches in {SERVE_REQUESTS} requests: {launches} "
          f"({len(attn)} LinearAttention module(s) per forward)", flush=True)
    if launches != SERVE_REQUESTS * len(attn) or launches == 0:
        raise AssertionError("the serving path did not go through the linear attention kernel")
    ms = statistics.median(times) * 1e3
    print(f"serve: batch {SERVE_BATCH} x {SERVE_IMGSZ} px bf16, request times "
          f"{[round(t * 1e3, 3) for t in times]} ms, median {ms:.3f} ms, "
          f"{SERVE_BATCH / ms * 1e3:.1f} img/s on {card}", flush=True)

    # outputs
    det, n = det.cpu(), n.cpu()
    print(f"detections per image: min {int(n.min())}, max {int(n.max())}, "
          f"total {int(n.sum())}", flush=True)
    valid = torch.arange(det.shape[1])[None] < n[:, None]
    ok = (det.shape == (SERVE_BATCH, 300, 6) and bool(torch.isfinite(det).all())
          and bool(((n >= 0) & (n <= 300)).all())
          and bool((det[~valid] == 0).all())
          and bool((det[valid][:, 4] > 0.25).all())
          and bool(((det[..., 0] >= 0) & (det[..., 2] <= SERVE_IMGSZ) & (det[..., 0] <= det[..., 2])
                    & (det[..., 1] >= 0) & (det[..., 3] <= SERVE_IMGSZ)
                    & (det[..., 1] <= det[..., 3])).all())
          and bool(((det[..., 5] >= 0) & (det[..., 5] < model.nc)).all()))
    if not ok:
        raise AssertionError("served detections are malformed")

    # NMS on the card (matrix fixed point) against the scan oracle on the CPU
    with torch.inference_mode():
        x = imgs.cuda().permute(0, 3, 1, 2).contiguous().to(torch.bfloat16) / 255
        pred = model(x)["pred"]
        with mock.patch.object(edgeline, "linear_attention", la.linear_attention_reference):
            pred_plain = model(x)["pred"]
    kw = dict(conf_thres=0.25, iou_thres=0.7, max_det=300, max_nms=1024)
    det_m, n_m = non_max_suppression(pred, method="matrix", **kw)
    det_s, n_s = non_max_suppression(pred.cpu(), method="scan", **kw)
    nms_err = (det_m.cpu() - det_s[:, :det_m.shape[1]]).abs().max().item()
    print(f"NMS card matrix vs CPU scan: counts equal {bool(torch.equal(n_m.cpu(), n_s))}, "
          f"max abs diff {nms_err:.3e} (tol 1e-3)", flush=True)
    if not (torch.equal(n_m.cpu(), n_s) and nms_err < 1e-3):
        raise AssertionError("matrix NMS on the card disagrees with the scan oracle")

    d = (pred - pred_plain).abs()
    box, cls = d[..., :4].max().item(), d[..., 4:].max().item()
    print(f"pred kernel vs plain attention, bf16 on the card: box {box:.3e} px (tol 4), "
          f"score {cls:.3e} (tol 2e-2)", flush=True)
    if not (box <= 4.0 and cls <= 2e-2):
        raise AssertionError("bf16 prediction through the kernel disagrees with the plain path")
    profile_request(predictor, imgs, ms)
    return launches, ms


def profile_request(predictor, imgs, unprofiled_ms: float):
    """One more request under torch.profiler: device time by kernel, and the
    device's busy share both of the unprofiled median request time (the share
    to read: the profiler's own host overhead stretches the traced request)
    and of the traced request's wall time. A measurement only: a trace
    without device events is reported as not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor(imgs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    if not rows:
        print("profile: no device events in the trace; device time not measured", flush=True)
        return
    busy_us = sum(r[1] for r in rows)
    print(f"profile: device busy {busy_us / 1e3:.3f} ms in {sum(r[2] for r in rows)} device ops; "
          f"{100 * busy_us / (unprofiled_ms * 1e3):.1f}% of the unprofiled median request "
          f"({unprofiled_ms:.3f} ms), {100 * busy_us / wall_us:.1f}% of the profiled request "
          f"({wall_us / 1e3:.3f} ms)", flush=True)
    for key, us, count in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {count:5d}x  {key[:110]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "edgeyolo_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: edgeyolo_tpu_torch not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    t0 = phase("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False (f32 stays f32)", flush=True)
    done("device", t0)

    from edgeyolo_tpu_torch.ops import _build
    from edgeyolo_tpu_torch.ops import linear_attention as la

    t0 = phase("build")
    libs = _build.build()
    print(f"build wall time: {time.perf_counter() - t0:.3f} s for {sorted(libs)}", flush=True)
    done("build", t0)

    t0 = phase("kernels")
    la_rows, la_inputs_by_case = check_kernels(la)
    done("kernels", t0)

    t0 = phase("reference")
    check_reference()
    done("reference", t0)

    t0 = phase("serve")
    launches, _ = serve(la, card)
    done("serve", t0)

    t0 = phase("device times")
    device_times(la, la_rows, la_inputs_by_case)
    done("device times", t0)

    kernels = [{"name": "linear_attention", "route": "cuda",
                "source": "edgeyolo_tpu_torch/csrc/linear_attention.cu",
                "replaces": "edgeyolo_tpu/ops/pallas/linear_attention.py:25",
                "launches": launches, **la_rows[LA_MAIN_CASE], "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
