#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (edgeyolo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed and each fatal when it fails:
  1. device     card name and power limit, torch and CUDA versions, TF32 switches
  2. build      nvcc builds every CUDA source of edgeyolo_tpu_torch/csrc and g++ the
                host codec (csrc/imageio.cpp), all at once; each source's seconds
  3. kernels    every kernel's wrapper against its plain PyTorch version, on the card,
                at the shapes the serving paths give it (the flagship's D = 64, with
                TTA's N = 289 and 196 and frame-by-frame N = 400 at batch 1, MSLA's
                D = 8, 16 and 32 at 640 px, the x scale's 48 and 96, the wavelet
                mixer's LL band: N = 100 at 640 px and 1 at 64 px, D = 32 at scale n,
                128 at l and 192 at x), with times and the bound; the attention
                kernel's split of N and workspace, and two launches on the same inputs
                compared bit for bit
  4. reference  the f32 model on the card (kernel) against the same model on the
                CPU (plain version) at 64 px, gates open: EdgeLine-YOLO-n, the YOLO11
                ablation family, YOLOv13 and its MSLA, LGL, wavelet and E2E variants,
                and the YOLOv10 family, yolo11-t/-test/-tune, yolov12, yolov12x,
                yolov13x, yolov3(-spp, -tiny), yolov5(x, -p6), yolov6(x), yolov8(x,
                -p2, -p6, -test) and yolov8-ghost(-p2, -p6) at scale n or their own
                size (an E2E model: its one2one decode before the top-k at the same
                tolerances, and its (B, 84, 6) selection row by row, rows whose scores
                tie within the tolerance matched within their group); launches per
                forward
  5. serve      EdgeLine-YOLO-n in bf16 at 640 px: 1 warm-up and 3 timed requests
                of 32 images through DetectionPredictor; kernel launch counts, bf16
                activations, output checks, NMS against the scan oracle, the
                prediction against the same model with the plain attention, and
                one profiled request (device time by kernel, device busy share
                of the unprofiled request time); then yolo11n, yolo11-lineattention-n
                yolov13-dsc3k2-msla-n, yolov13-test-n (E2E: no NMS; 2 kernel launches
                per request) and yolov13-dsc3k2-lgl-n (no kernel) the same way (bf16
                conv and linear outputs, launches per request, peak memory, a profiled
                request, the bf16 prediction against f32 and against the plain
                attention; an E2E model's before its top-k); then yolov10n (E2E without
                quality, no kernel), yolov12n (no kernel), yolo11-test-n and
                yolo11-tune-n (the kernel once per request) the same way
  6. train      one f32 train step at 64 px, batch 2, on the card (kernel) against the
     reference  same step on the CPU (plain version): same seeded weights, same
                augmentation draws; the loss, every gradient and the updated params;
                EdgeLine-YOLO-n from two starts, yolov13-dsc3k2-msla-n and
                yolov13-test-n (E2EDetectLoss) from one; yolov13-test-n and yolov10n
                from class logits spread around 0 on 4 images, per tensor, and on 2
                images as a printed reading
  7. train      EdgeLine-YOLO-n, then yolov13-dsc3k2-msla-n, yolo11n, yolov13-test-n,
                yolov13-dsc3k2-lgl-n, yolov10n and yolov12n, training at
                640 px, batch 32, bf16 autocast, default
                hyps (mosaic, photometric, HSV, flips; SGD, accumulate 2): 1 warm-up
                and 6 timed steps through DetectionTrainer.train_step; bf16 at the
                kernel's input, saved views not copied, one kernel launch per step,
                params moving on update steps only, the EMA formula, BatchNorm
                statistics moving; step ms, img/s, peak memory, and one profiled
                step (the kernel's share of device time, the top device operations)
  8. fit        every fit of the script, this phase's four and those of 11, 12 and 13 (e),
                and the export of phase 15 (a job of its own),
                each in a process of its own (`chip_smoke.py --fit NAME WORK CARD`),
                FIT_PROCS at once, longest first, each one's output printed whole when it
                ends, and each fit's process seconds. The dataset path end to end: the
                port's synthetic dataset (16 train, 8 val
                PNG images, 160 px, 3 classes, seed 0) written to a temporary directory;
                YOLO("edgeline-yolo.yaml").train(150 epochs, batch 16, SGD lr0 0.01, nbs 16,
                no warmup, val each epoch) at full width; epoch and val times, the last results.csv row,
                mAP50-95 >= FIT_MAP_MIN; best.pt reloaded and validated (equal to the best
                epoch's metrics), the same val on the CPU in f32 (within FIT_CPU_TOL),
                predict on the val images; the attention kernel's launches in train, val
                and predict; the tiled NMS against the scan oracle at >= 8192 candidates;
                when every fit has ended, the trained flagship alone on the card,
                validated at 640 px on 128 synthetic images at
                batch 32 in bf16: img/s, decode and letterbox ms per image, device ms and
                NMS ms per batch, the candidates past conf 0.001, peak memory; then
                yolo11n (plain Detect, BCE) on the same protocol, held to
                YOLO11N_FIT_MAP_MIN, and yolov13-test (E2E head, wavelet HyperACE) at
                192 px (at 160 px its wavelet mixer meets an odd 5 x 5 band, which
                JAX's does not take either), held to V13_TEST_FIT_MAP_MIN, validated
                through the E2E passthrough; and yolov10n (E2E, no quality) at 160 px,
                held to V10_FIT_MAP_MIN
  9. jpeg       on the flagship the fit phase trained: (a) the val640 images through
                the port's q92 encoder and decoder on the card's host, within PIL's own
                q92 error (JPEG_Q92); the threaded batch decode and letterbox equal to
                one-by-one; ms per image on one thread and through the batch call;
                (b) the fit's 8 val images as JPEG with a COCO GT json, validated with
                save_json: predictions.json, COCO AP50-95 within JAX_COCO_GAP +
                JPEG_COCO_SLACK of mAP50-95; (c) val640 from JPEG (640 px, batch 32,
                bf16): img/s and the validator's speed split; (d) a rect validation of
                wide and tall JPEGs (1024 x 640): its non-square batch shapes; then
                predict on the JPEG files and save_crop, the crops decoded back; the
                kernel's launches in each
 10. video      (a) a 1280 x 720 MJPEG AVI (64 frames of moving shapes, the port's
                encoder) served by EdgeLine-YOLO-n at 640 px, batch 32, bf16, from the
                file and from an MJPEG-over-HTTP camera on 127.0.0.1 (a thread): frames/s
                and the decode's share; (b) test-time augmentation on the first batch:
                3 kernel launches at N = 400, 289, 196, and at 64 px in f32 against the
                CPU; (c) ByteTrack and BoT-SORT with the fit phase's model over a 160 px
                AVI of shapes moving 2 px a frame, each in its own column, batch 1,
                f32: each shape's id kept over >= 90% of the frames it is detected in,
                ids and boxes equal to the CPU's; GMC's ms per 1280 x 720 frame; frame-by-frame tracking at 640 px
                in bf16 and f32 (N = 400 at batch 1); (d) save=True (one JPEG per frame,
                one decoded against the CPU's plot outside the label bands) and
                visualize=True (one PNG per layer with a 4-D output); (e) one train
                step at batch 32 x 640 px with multi_scale; every part's kernel launches
 11. segment    the segment task and the YOLOv9 family: (a) reference: yolov9t/s/m/c/e/x
     and v9     and yolov8n-seg, yolov8n-seg-p6, yolo11n-seg, yolov9c-seg, yolov9e-seg and
                fastsam at 64 px in f32, card against CPU, at seeded and at test weights
                (SEG_REF_SCALE): boxes 5e-3 px, scores 1e-4, and for the seg models the
                mask coefficients and prototypes at 1e-4 of their largest magnitude and
                the cropped sigmoid masks of the 20 best anchors (cropped to the CPU's
                boxes on both sides) at 1e-4 as probabilities, equal at the 0.5 cut but
                within 1e-4 of it; (b) serve: yolo11n-seg and yolov9c-seg at batch 32 x
                640 px in bf16 through SegmentationPredictor (uint8 in, masks out): img/s,
                median request ms, device-busy ms of a profiled request, peak memory;
                (c) train reference: one f32 yolo11n-seg step at 64 px on 4 images (box
                masks), card against CPU per tensor at TRAIN_REF_TOL, and the f64
                witness; (d) train: yolo11n-seg at batch 32 x 640 px, bf16, default hyps,
                4 instances per image, then with copy_paste 0.5: step ms and peak memory,
                held under SEG_TRAIN_PEAK_GIB (one dense (32, 8400, 160, 160) f32 tensor
                would be 27.5 GB); (e) fit: yolo11n-seg on the synthetic segment set
                (the fit protocol), box and mask mAP50-95 held to the JAX trainer's less
                0.1 (SEG_FIT_BOX_MIN, SEG_FIT_MASK_MIN), best.pt reloaded, on the CPU,
                and predict with masks at the images' size (run in phase 8). No kernel
                runs in these models; the linear-attention launches stay 0 there
                (printed)
 12. pose and  the pose and obb tasks: (a) reference: yolov8n-pose, yolov8n-pose-p6,
     obb        yolo11n-pose, yolov8n-obb and yolo11n-obb at 64 px in f32, card against
                CPU, at seeded and test weights (POSE_OBB_REF_SCALE): boxes 5e-3 px,
                scores 1e-4, keypoints 5e-3 px and visibilities 1e-4, angles 1e-4; the
                rotated NMS blocked against its dense plain version on the card (equal
                selections), and blocked at batch 32 x max_nms 8192 (its peak memory);
                (b) serve: yolo11n-pose at batch 32 x 640 px (nc 1, kpt_shape [17, 3],
                coco-pose's) and yolo11n-obb at batch 16 x 1024 px (nc 15, DOTAv1's),
                bf16, class logits at 0 (every image fills its candidates): img/s,
                median request ms, device-busy ms, peak memory; (c) train reference:
                one f32 step of each at 64 px on 4 images (keypoints, rotated boxes),
                card against CPU per tensor at TRAIN_REF_TOL, and the f64 witness;
                (d) train: yolo11n-pose at batch 32 x 640 px with 4 keypointed boxes
                per image, yolo11n-obb at batch 16 x 1024 px with 16 rotated boxes per
                image: step ms, peak memory; (e) fit: both on the synthetic pose and obb
                sets (the fit protocol at 100 epochs), held to the JAX trainer's box and
                pose, and probiou, mAP50-95 less 0.1 on that protocol; best.pt reloaded,
                on the CPU, and predict
                (keypoints, rotated boxes) (run in phase 8). No kernel runs in these
                models
 13. classify   the classify task: (a) reference: yolov8n-cls, yolov8-cls-resnet50,
                yolov8-cls-resnet101, yolo11n-cls and yolo11-cls-resnet18 at 64 px in f32,
                card against CPU, at seeded and test weights (CLS_REF_SCALE): logits 1e-4 of
                their scale, probabilities 1e-5, top-5 indices equal; (b) serve: yolo11n-cls
                and yolov8-cls-resnet50 (a full ResNet-50: ResNet rows take no width scale),
                nc 1000, batch 32 x 224 px, bf16, through ClassificationPredictor (uint8 in,
                probs out): img/s, median request ms, device-busy ms of a profiled request,
                peak memory, bf16 conv and linear outputs; then one request of 32 JPEGs of
                500 x 375 px through the host transform (decode, PIL's bilinear resize,
                centre crop) and its share of the wall time; (c) train reference: one f32
                yolo11n-cls step at 64 px on 4 images, card against CPU per tensor at
                TRAIN_REF_TOL, and the f64 witness; (d) train: yolo11n-cls at batch 64 x 224
                px, bf16 autocast, the default classify hyps (RandAugment, erasing 0.4, HSV,
                fliplr): step ms, img/s, peak memory, a profiled step's top device ops;
                (e) fit: the classify protocol (CLS_FIT_DATA, CLS_FIT_TRAIN) held to JAX's
                top-1 less 0.1, best.pt reloaded (equal to the best epoch's row), the same
                val on the CPU in f32 (top-1 and top-5 equal), predict on the val images
                (run in phase 8).
                No cls model has a LinearAttention: the kernel's launches stay 0 (printed)
 14. rtdetr     the RT-DETR family (no kernel: its deformable sampler and matcher are
                plain PyTorch, as JAX's are plain jnp): (a) reference: rtdetr-l, rtdetr-x,
                rtdetr-resnet50, rtdetr-resnet101 and yolov8-rtdetr-n at 64 px in f32, card
                against CPU at `rt_perturbed` weights: boxes 5e-3 px and scores 1e-4 row by
                row, the encoder's selected query indices equal where a selection score lies
                more than RTDETR_TIE from its neighbours (near-ties matched within their
                group), and the sampler alone at 640 px shapes within 1e-5; (b) serve:
                rtdetr-l and rtdetr-resnet50 at batch 32 x 640 px in bf16 through
                DetectionPredictor (uint8 in, 300 queries an image out, score biases at 0):
                img/s, median request ms, device-busy ms, peak memory, the sampler's own
                device ms and share; (c) train reference: rtdetr-l's f32 step at 64 px on 4
                images with its denoising group, card against CPU (as built: the loss and the
                matched tokens; every ReLU as SiLU: per tensor but the sampling offsets, the
                params, and the f64 witness); (d) train: rtdetr-l at batch 16 x 640 px, bf16,
                4 boxes an image: step ms, peak memory, device-busy share, the loss's and the
                matcher's spans; (e) fit: yolov8-rtdetr-n on the fit protocol, held to JAX's
                best mAP50-95 less 0.1, no op without a deterministic form, and (a fit job
                of its own) 3 epochs twice under strictly deterministic algorithms equal to
                the bit (run in phase 8). The linear-attention kernel launches 0 times in all of it
 15. export     the flagship as a .pt2 (torch.export, symbolic batch) and as ONNX at 160 px
                (both exported by a job of its own in phase 8, beside the fits), the .pt2 reloaded in a fresh process that
                imports only edgeyolo_tpu_torch (`chip_smoke.py --serve-pt2 WORK CARD`) and
                served at 32 x 640 px f32 in turns with the live fused f32 model: the
                program's pred within FUSED_F32_TOL, the attention kernel launched inside
                it once a request, request ms of each; npz exported and reloaded equal to
                the bit; the flagship's ONNX at 160 px through the port's numpy executor
                against the card's f32 forward (JAX's ONNX tolerance); the registered
                op's host dispatch cost against the kernel's wrapper called directly
 16. benchmark  YOLO.benchmark of the fit phase's flagship at 640 px, batch 8, over native,
                torch_export and npz, validated on the fit's val images: mAP50-95 equal
                within 1e-6, each row's ms/img, each export's seconds
 17. registry   the registry rows no bundled YAML uses, in one test graph
                (tests/torch_registry_spec.py: Focus, C3k2_Wavelet and C3k2_TWavelet,
                MulGate, C3x, RHJM, MSLA as a row, BottleneckCSP, SPPF_Wavelet, DySample,
                C1, ConvTranspose, CBAM, WTConv2d, a TeLU conv), and the facade's fuse and
                embed: (a) reference: the graph at 64 px in f32, card against CPU, at
                seeded weights with the gates open and at its tests' weights
                (REGISTRY_REF_SCALE), unfused and fused (5e-3 px, 1e-4), and the fused card
                model against the unfused one (FUSED_F32_TOL); (b) serve: the graph at
                batch 32 x 640 px in bf16 through DetectionPredictor (bf16 conv and linear
                outputs, DySample's coordinates f32, the kernel at (32, 400, 2, 64) and
                (128, 1600, 2, 16) held against the plain version on its own inputs on the
                path, 2 launches per request, ms, img/s); then YOLO("edgeline-yolo.yaml")
                .fuse() against the same model unfused on one batch, requests in turns
                (a reading: request ms, matched detections' box and score gaps, BatchNorm
                kernels of a profiled request of each); (c) embed: YOLO.embed of 32 images
                at 640 px, the flagship at its default tap and at [10, 22] and the graph at
                [13, 27], card against CPU in f32 on the first 8 (EMBED_TOL)
 18. device     each kernel's device time at the shapes of phase 3: the context and
     times      output launches each timed by its own event pair, in DEVICE_SESSIONS
                sessions (median and spread, the SM clock read around each); after the
                serve, train, fit and jpeg phases
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout of
the repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FLOP/s by input type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
SERVE_BATCH, SERVE_IMGSZ, SERVE_REQUESTS = 32, 640, 3
# train: batch, image size, padded targets, real boxes per image (bench.py:174-176), timed steps
TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_M, TRAIN_REAL, TRAIN_STEPS = 32, 640, 16, 4, 6
TRAIN_REF_BATCH, TRAIN_REF_IMGSZ, TRAIN_REF_M = 2, 64, 8
# card (kernel) vs CPU (plain), f32: loss relative, each gradient of its max |grad|, params absolute
TRAIN_REF_TOL = {"loss": 1e-4, "grad": 1e-3, "param": 1e-5}
TRAIN_REF_HYP = {"batch": TRAIN_REF_BATCH, "nbs": TRAIN_REF_BATCH, "epochs": 1, "amp": False,
                 "optimizer": "SGD", "seed": 0}
# each f32 step against the f64 one: card gap <= WITNESS_FACTOR * CPU gap + WITNESS_FLOOR
WITNESS_FACTOR = 2.0
WITNESS_FLOOR = {"loss": 1e-6, "grad_all": 1e-6, "param": 1e-7}
# (B, N, H, D, dtype, layout); "qkv" is the module's strided view of the conv output
LA_CASES = [
    (32, 400, 2, 64, "float32", "qkv"),
    (32, 400, 2, 64, "bfloat16", "qkv"),  # the serving path: batch 32 at 640 px
    (32, 289, 2, 64, "bfloat16", "qkv"),  # TTA's 544 and 448 px canvases of a 640 px batch
    (32, 196, 2, 64, "bfloat16", "qkv"),
    (1, 400, 2, 64, "bfloat16", "qkv"),  # frame-by-frame predict and track at 640 px
    (1, 400, 2, 64, "float32", "qkv"),
    (128, 400, 2, 64, "bfloat16", "qkv"),
    (128, 1600, 2, 64, "bfloat16", "qkv"),
    (16, 6400, 4, 64, "bfloat16", "qkv"),
    (32, 400, 2, 64, "bfloat16", "bnhd"),
    (4, 999, 3, 32, "float32", "bnhd"),
    (16, 25, 2, 64, "bfloat16", "qkv"),  # the fit phase at 160 px: training (bf16)
    (16, 25, 2, 64, "float32", "qkv"),  # and its validation and prediction (f32)
    # MSLA-n at 640 px, batch 32 (layers 2, 4, 17 and 26, 21, 30) ...
    (32, 25600, 2, 8, "bfloat16", "qkv"),
    (32, 6400, 2, 16, "bfloat16", "qkv"),
    (32, 6400, 2, 8, "bfloat16", "qkv"),
    (32, 1600, 2, 16, "bfloat16", "qkv"),
    (32, 400, 2, 32, "bfloat16", "qkv"),
    # ... as the serving path gives them, the four channel quarters batched
    (128, 25600, 2, 8, "bfloat16", "qkv"),
    (128, 6400, 2, 16, "bfloat16", "qkv"),
    (128, 6400, 2, 8, "bfloat16", "qkv"),
    (128, 1600, 2, 16, "bfloat16", "qkv"),
    (128, 400, 2, 32, "bfloat16", "qkv"),
    (32, 25600, 2, 8, "float32", "qkv"),  # f32 at D = 8 (FMA products, split context)
    (4, 400, 2, 48, "bfloat16", "qkv"),  # the x scale's head dims
    (4, 400, 2, 96, "bfloat16", "qkv"),
    # the registry graph's MSLA row (layer 9) in f32 at batch 1: embed at 640 px
    (4, 1600, 2, 16, "float32", "qkv"),
]
# the wavelet mixer's LL band (yolov13-test): 10 x 10 tokens at 640 px and 1 x 1 at 64 px,
# head dim c / 2 = 32, 128 and 192 at scales n, l and x; one long case at D = 128
WAVELET_CASES = [(32, n, 2, d, dt, "qkv") for n in (100, 1) for d in (32, 128, 192)
                 for dt in ("bfloat16", "float32")] + [
    (4, 6400, 2, 128, dt, "qkv") for dt in ("bfloat16", "float32")]
LA_CASES += WAVELET_CASES
LA_MAIN_CASE = 1
LA_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}  # of max |plain| (bf16: about 5 ulp)
# fit: PARITY.md's protocol (16 train / 8 val images, 160 px, 3 classes, 150 epochs, SGD 0.01),
# with nbs 16 (one micro-step per update) and no warmup: at one batch per epoch the defaults
# (nbs 64: four averaged micro-steps per update; a warmup floor of 100 micro-steps) leave 37
# updates, most of them warming up, and the JAX package's own trainer then reaches mAP50-95
# 0.166 (the port 0.127); with these two it reaches 0.709 (tools/fit_protocol.py, PERF.md §6)
FIT = {"n_train": 16, "n_val": 8, "imgsz": 160, "nc": 3, "seed": 0}
FIT_TRAIN = {"epochs": 150, "batch": 16, "imgsz": 160, "optimizer": "SGD", "lr0": 0.01,
             "nbs": 16, "warmup_epochs": 0.0, "val": True, "seed": 0, "plots": False}
FIT_MAP_MIN = 0.5  # mAP50-95 on the val split; the JAX flagship reached 0.7774 (PARITY.md)
FIT_RELOAD_TOL = 1e-6  # best.pt validated again on the card vs the trainer's best epoch
FIT_CPU_TOL = 2e-3  # the same val on the CPU in f32, each metric
NMS_TILED_MIN = 8192  # candidates in the tiled-vs-scan check
VAL640 = {"n_val": 128, "imgsz": 640, "batch": 32}
# jpeg: the val640 images through the port's q92 encoder and decoder. PIL's q92 files of
# the same images decode within these of the source, worst image (the encoder writes
# PIL's bytes; tests/test_torch_jpeg.py::test_chip_smoke_jpeg_bounds_are_pil_s measures them)
JPEG_Q92 = {"rmse": 14.5961, "max_abs": 127}
# |COCO AP50-95 - validator mAP50-95| of the JAX package's validator with save_json on the
# fit protocol's 8 val images as JPEG q92, its own trained flagship (mAP50-95 0.688989,
# COCO AP50-95 0.691614: tools/fit_protocol.py --coco with '{"nbs": 16, "warmup_epochs":
# 0.0, "seed": 0}', CPU); the port may differ by this plus JPEG_COCO_SLACK
JAX_COCO_GAP = 0.0026245359140526503
JPEG_COCO_SLACK = 0.02
JPEG_RECT = {"n": 32, "long": 1024}  # wide and tall copies of val640 images, padded
# the families beside the flagship, at scale n: the reference phase holds each one's card
# forward against its CPU forward; the serve phase serves those in FAMILY_SERVE
FAMILIES = ("yolo11n", "yolo11-dsc3k2-wavelet-n", "yolo11-gf2detect-n", "yolo11-lineattention-n",
            "yolov13n", "yolov13-dsc3k2-msla-n", "yolov13-test-n", "yolov13-gf2-unihead-n",
            "yolov13-dsc3k2-lgl-n")
V13_TEST, LGL = "yolov13-test-n", "yolov13-dsc3k2-lgl-n"
FAMILY_SERVE = ("yolo11n", "yolo11-lineattention-n", "yolov13-dsc3k2-msla-n", V13_TEST, LGL)
# the weight scale of each model in tests/test_torch_families.py (its CONFIGS), under which
# the output depends on the image without saturating. The flagship's, not there, was scanned
# the same way against JAX on the CPU (at 2.5 its pred is 1.2e-2 px off JAX's). yolov13n takes
# MSLA-n's 1.8, not the test's 1.87: that is at the edge where rounding grows, and there the
# card's cuDNN against the CPU read 3.4e-3 px of the 5e-3 tolerance.
REF_SCALE = {"edgeline-yolo-n": 2.4, "yolo11n": 2.5, "yolo11-dsc3k2-wavelet-n": 2.4,
             "yolo11-gf2detect-n": 2.5, "yolo11-lineattention-n": 2.5, "yolov13n": 1.8,
             "yolov13-dsc3k2-msla-n": 1.8, "yolov13-test-n": 1.8, "yolov13-gf2-unihead-n": 1.8,
             "yolov13-dsc3k2-lgl-n": 1.8}
MSLA = "yolov13-dsc3k2-msla-n"
# fit: yolo11n (plain Detect, BCE) on the same protocol; the JAX package's trainer reached
# mAP50-95 YOLO11N_JAX_MAP there (tools/fit_protocol.py, PERF.md section 6), and the port is
# held to that less 0.1
YOLO11N_JAX_MAP = 0.7566  # 0.756571273958199, 275 s on a CPU
YOLO11N_FIT_MAP_MIN = round(YOLO11N_JAX_MAP - 0.1, 4)
# fit: yolov13-test on the same protocol at 192 px; the JAX package's trainer reached
# V13_TEST_JAX_MAP there (tools/fit_protocol.py '{"model": "yolov13-test.yaml", "imgsz": 192,
# "nbs": 16, "warmup_epochs": 0}', PERF.md section 6), and the port is held to that less 0.1
V13_TEST_FIT_IMGSZ = 192
V13_TEST_JAX_MAP = 0.6377  # 0.637664754828572, 608 s on a CPU
V13_TEST_FIT_MAP_MIN = round(V13_TEST_JAX_MAP - 0.1, 4)
# the configurations the YOLOv10 and plain-conv slice adds, at scale n or their own size, with
# the weight scale of their tests (tests/test_torch_v10.py, test_torch_detect_families.py,
# test_torch_v3_v5_v8.py, test_torch_plain_blocks.py); the A2C2f models (yolov12, yolov12x,
# yolov13x) at or a little below their tests', off the edge where f32 rounding grows
NEW_REF_SCALE = {"yolov10.yaml": 2.0, "yolov10n": 2.0, "yolov10s": 2.0, "yolov10m": 2.0,
                 "yolov10b": 2.0, "yolov10l": 2.0, "yolov10x": 2.0, "yolo11-t.yaml": 2.4,
                 "yolo11-test.yaml": 2.4, "yolo11-tune.yaml": 2.4, "yolov12.yaml": 1.7,
                 "yolov12x": 1.54, "yolov13x": 1.53, "yolov3": 2.1, "yolov5.yaml": 2.5,
                 "yolov5x": 2.25, "yolov5-p6.yaml": 2.5, "yolov8.yaml": 2.5, "yolov8x": 2.4,
                 "yolov8-p2.yaml": 2.5, "yolov8-test.yaml": 2.5, "yolov8-ghost.yaml": 2.5,
                 "yolov8-ghost-p2.yaml": 2.5, "yolov8-ghost-p6.yaml": 2.5, "yolov8-p6.yaml": 2.5,
                 "yolov3-spp": 2.1, "yolov3-tiny": 2.5, "yolov6.yaml": 2.5, "yolov6x": 2.5}
REF_SCALE.update(NEW_REF_SCALE)
V10, V12 = "yolov10n", "yolov12n"
# the two EdgeLine variants that carry C2PSA_LinearAttention, served beside the flagship
EDGELINE_VARIANTS = ("yolo11-test-n", "yolo11-tune-n")
FAMILY_SERVE += (V10, V12, *EDGELINE_VARIANTS)
# fit: yolov10n on the same protocol at 160 px; the JAX package's trainer reached V10_JAX_MAP
# there (tools/fit_protocol.py '{"model": "yolov10n.yaml", "nbs": 16, "warmup_epochs": 0}',
# PERF.md section 6), and the port is held to that less 0.1
V10_JAX_MAP = 0.6282  # 0.6281913969265872, 321 s on a CPU
V10_FIT_MAP_MIN = round(V10_JAX_MAP - 0.1, 4)
# device times: sessions of event pairs per kernel shape, each with the SM clock read around it
DEVICE_SESSIONS = 3
# video: a 1280 x 720 MJPEG AVI served at SERVE_IMGSZ, batch SERVE_BATCH; tracking over a
# 160 px AVI of shapes moving `speed` px a frame, each up and down its own column, each shape
# to keep one id over `id_share` of the frames it is detected in (a track of its class)
VIDEO = {"frames": 64, "hw": (720, 1280)}
TRACK = {"frames": 48, "imgsz": 160, "speed": 2.0, "id_share": 0.9}
# segment and YOLOv9: the models of that slice with the weight scales of their tests
# (tests/test_torch_v9.py, tests/test_torch_segment.py)
V9_REF_SCALE = {"yolov9t": 2.13, "yolov9s": 2.13, "yolov9m": 2.13, "yolov9c": 2.13,
                "yolov9e": 2.13, "yolov9x": 2.13}
SEG_REF_SCALE = {"yolov8n-seg": 2.0, "yolov8n-seg-p6": 2.0, "yolo11n-seg": 2.0,
                 "yolov9c-seg": 2.1, "yolov9e-seg": 2.1, "fastsam": 2.0}
SEG_SERVE = ("yolo11n-seg", "yolov9c-seg")
SEG = "yolo11n-seg"
SEG_TRAIN_PEAK_GIB = 20.0
# fit: yolo11n-seg on the fit protocol's segment form; the JAX package's trainer reached box
# mAP50-95 SEG_JAX_BOX_MAP and mask mAP50-95 SEG_JAX_MASK_MAP at its best epoch (135) there
# (JAX_PLATFORMS=cpu python tools/fit_protocol.py OUT '{"task": "segment", "nbs": 16,
# "warmup_epochs": 0.0, "seed": 0}', 351 s on a CPU), and the port is held to each less 0.1
SEG_JAX_BOX_MAP = 0.6774  # 0.67742
SEG_JAX_MASK_MAP = 0.4857  # 0.48569
SEG_FIT_BOX_MIN = round(SEG_JAX_BOX_MAP - 0.1, 4)
SEG_FIT_MASK_MIN = round(SEG_JAX_MASK_MAP - 0.1, 4)
# pose and obb: the five YAMLs' test weights (tests/test_torch_pose_obb.py's SCALE), the
# served and trained shapes (coco-pose: 1 class, 17 x 3 keypoints; DOTAv1: 15 classes at
# 1024 px), and the fits' limits: the JAX trainer's best-epoch figures on the same protocol
# (tools/fit_protocol.py '{"task": "pose" | "obb", "epochs": 100, "nbs": 16, "warmup_epochs": 0.0,
# "seed": 0}', a CPU; PERF.md section 2) less 0.1, at 100 epochs (POSE_OBB_FIT_EPOCHS): the
# script's time limit leaves no room for two more 150-epoch fits
POSE_OBB_REF_SCALE = {"yolov8n-pose": 2.0, "yolov8n-pose-p6": 2.0, "yolo11n-pose": 2.0,
                      "yolov8n-obb": 2.0, "yolo11n-obb": 2.0}
POSE, OBB = "yolo11n-pose", "yolo11n-obb"
POSE_OBB_SERVE = {POSE: (32, 640, {"nc": 1, "kpt_shape": (17, 3)}), OBB: (16, 1024, {"nc": 15})}
POSE_OBB_TRAIN = {POSE: (32, 640, 4), OBB: (16, 1024, 16)}  # batch, px, real boxes per image
ROT_NMS_SHAPE = (32, 8192)  # batch, max_nms of the blocked rotated NMS check
POSE_OBB_FIT_EPOCHS = 100
FIT_TASK_PREDICT_CONF = 0.01
POSE_JAX_BOX_MAP = 0.4811  # 0.48106
POSE_JAX_POSE_MAP = 0.6632  # 0.66321
OBB_JAX_MAP = 0.6337  # 0.63369
POSE_FIT_BOX_MIN = round(POSE_JAX_BOX_MAP - 0.1, 4)
POSE_FIT_POSE_MIN = round(POSE_JAX_POSE_MAP - 0.1, 4)
OBB_FIT_MIN = round(OBB_JAX_MAP - 0.1, 4)
# the classify phase: the five cls YAMLs at 64 px (seeded and test weights: conv and linear
# weights x CLS_REF_SCALE, BatchNorm moved), served and trained at ImageNet's shapes, and the
# fit protocol (PARITY.md's yolo11n-cls run: 8 grating classes, 128 train / 64 val images at
# 128 px; tools/fit_protocol.py '{"task": "classify", ...}' gives JAX's top-1 on it)
CLS_YAMLS = ("yolov8n-cls", "yolov8-cls-resnet50", "yolov8-cls-resnet101", "yolo11n-cls",
             "yolo11-cls-resnet18")
CLS_REF_SCALE = 1.5
CLS = "yolo11n-cls"
CLS_SERVE = ("yolo11n-cls", "yolov8-cls-resnet50")
CLS_SERVE_SHAPE = (32, 224)  # batch, px
CLS_JPEG = (32, 500, 375)  # one request of JPEGs at ImageNet's common size: n, width, height
CLS_TRAIN_SHAPE = (64, 224)
CLS_FIT_DATA = {"nc": 8, "n_train_per_class": 16, "n_val_per_class": 8, "seed": 0}
# the protocol's training, its decoded images kept in RAM (cache): a fit repeats to the bit
# either way, and the loader's decode and resize no longer hold the steps up
CLS_FIT_TRAIN = {"epochs": 100, "batch": 16, "imgsz": 128, "optimizer": "SGD", "lr0": 0.01,
                 "nbs": 16, "warmup_epochs": 0.0, "seed": 0, "cache": True}
CLS_JAX_TOP1 = 0.7031  # 0.70312, JAX's trainer on the protocol at 100 epochs (best epoch 79)
CLS_FIT_TOP1_MIN = round(CLS_JAX_TOP1 - 0.1, 4)
# the RT-DETR phases: the five rtdetr YAMLs at 64 px (their own scale, yolov8-rtdetr at n;
# weights as tests/test_torch_rtdetr.py's `rt_perturbed`), served and trained at full width,
# and the fit protocol (tools/fit_protocol.py '{"model": "yolov8-rtdetr.yaml", "nbs": 16,
# "warmup_epochs": 0.0, "seed": 0}' gives JAX's best mAP50-95 on it)
RTDETR_REF = (("rtdetr-l", None), ("rtdetr-x", None), ("rtdetr-resnet50", None),
              ("rtdetr-resnet101", None), ("yolov8-rtdetr", "n"))
RTDETR_TIE = 1e-5  # selection scores closer than this may order either way in f32
RTDETR_SERVE = ("rtdetr-l", "rtdetr-resnet50")
RTDETR_TRAIN = ("rtdetr-l", (16, 640, 4))  # JAX's default batch; px; real boxes per image
RTDETR_FIT = "yolov8-rtdetr"
RTDETR_JAX_MAP = 0.3934  # 0.39344748437027094 at its last epoch (150), 1,199 s on a CPU
RTDETR_FIT_MAP_MIN = round(RTDETR_JAX_MAP - 0.1, 4)
RTDETR_REPEAT_EPOCHS = 3  # the fit again, twice, strictly deterministic: equal to the bit
# the fit phase: every fit above (detect, segment, pose, obb, classify) runs in a process of
# its own, FIT_PROCS at once, longest first. Each is host-bound (one Python thread launching
# small kernels, the card idle most of the time): one after another they took 640 s of the
# script's 1,200 s on an H100, all eight at once 240 s, four at once 302 s (PERF.md section 6)
# the registry test graph (tests/torch_registry_spec.py) and the facade's fuse and embed
REGISTRY_REF_SCALE = 2.5  # tests/test_torch_registry_graph.py's weight SCALE
REGISTRY_LA_SHAPES = {((32, 400, 2, 64), "bfloat16"), ((128, 1600, 2, 16), "bfloat16")}
FUSED_F32_TOL = 1e-4  # fused against unfused f32 on the card: of the largest box coordinate, score
EMBED_IMAGES = [(640, 640), (480, 640), (720, 1280), (360, 480)] * 8  # (h, w), letterboxed
EMBED_IMGSZ = 640
EMBED_TOL = 1e-4  # card against CPU in f32, of each vector's largest magnitude
EMBED_CPU_IMAGES = 8  # of them embedded on the CPU too (a CPU forward at 640 px takes 0.1-0.3 s)
BN_KERNEL_WORDS = ("batch_norm", "batchnorm", "bn_fw")  # device kernels of a BatchNorm

FIT_PROCS = 8
FIT_THREADS = 2  # torch's CPU threads in a fit's process (its validation on the CPU)
FIT_TIMEOUT = 600  # s, each fit's process


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


def sm_clock_mhz() -> int:
    """The card's SM clock now (nvidia-smi clocks.sm, MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return int(out.stdout.split()[0])


def phase_event_ms(la, q, k, v, samples: int = 30) -> tuple[list[float], list[float]]:
    """Each of the kernel's two launches timed by its own event pair (recorded
    by the C entry point before the context launch, between the launches and
    after the output launch), each marked call queued behind an unmarked one so
    the card is busy when the first event is recorded: (context and merge ms,
    output ms) per sample."""
    import torch

    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(samples)]
    for trio in marks:
        for e in trio:
            e.record()  # creates the event
    torch.cuda.synchronize()
    for trio in marks:
        la.linear_attention_kernel(q, k, v)
        la.linear_attention_kernel(q, k, v, marks=trio)
    torch.cuda.synchronize()
    return ([a.elapsed_time(b) for a, b, _ in marks], [b.elapsed_time(c) for _, b, c in marks])


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
    """Add each case's device time to its row of the table: DEVICE_SESSIONS
    sessions of `phase_event_ms`, the SM clock read before and after each.
    `device_ms` is the median over sessions of a session's median context
    and merge launch plus its median output launch; `device_ms_sessions`
    holds each session's sum, `device_ms_context` and `device_ms_output`
    the two launches' medians over sessions."""
    for (b, n, h, d, dt, layout), row, (q, k, v) in zip(LA_CASES, rows, inputs):
        sessions, clocks = [], []
        for _ in range(DEVICE_SESSIONS):
            before = sm_clock_mhz()
            ctx_ms, out_ms = phase_event_ms(la, q, k, v)
            clocks.append((before, sm_clock_mhz()))
            sessions.append((statistics.median(ctx_ms), statistics.median(out_ms),
                             min(ctx_ms), max(ctx_ms), min(out_ms), max(out_ms)))
        sums = [s[0] + s[1] for s in sessions]
        if not all(math.isfinite(t) and t > 0 for t in sums):
            raise AssertionError(f"no device time read at ({b},{n},{h},{d}) {dt}: {sums}")
        row["device_ms"] = statistics.median(sums)
        row["device_ms_sessions"] = sums
        row["device_ms_context"] = statistics.median(s[0] for s in sessions)
        row["device_ms_output"] = statistics.median(s[1] for s in sessions)
        row["sm_clock_mhz"] = clocks
        print(f"linear_attention ({b},{n},{h},{d}) {dt} {layout}: device {row['device_ms']:.4f} "
              f"ms per call, median of {DEVICE_SESSIONS} sessions {[round(t, 4) for t in sums]} "
              f"(spread {max(sums) - min(sums):.4f}); by launch, median per session (min, max "
              f"of its samples): context and merge "
              + ", ".join(f"{s[0]:.4f} ({s[2]:.4f}, {s[3]:.4f})" for s in sessions)
              + "; output " + ", ".join(f"{s[1]:.4f} ({s[4]:.4f}, {s[5]:.4f})" for s in sessions)
              + f"; SM clock MHz before/after each session {clocks}", flush=True)


def open_gates(model):
    """Every zero-initialised residual gate open at 0.5 (init leaves them at 0,
    which hides the branch behind it from the output and its gradients): the
    wavelet enhancers', DSC3K2_MSLA's, the wavelet mixers' and the SS2D
    context's gamma (MSLA and the mixer, and so the attention kernel, are
    multiplied by tanh(gamma)) and the FullPAD tunnels' gate; MulGate's gamma
    with its BatchNorm scale at 1 and its zero `mix` conv drawn, and
    DySample's zero offset conv drawn."""
    import torch

    from edgeyolo_tpu_torch.nn.modules.edgeline import MulGate, WaveletEnhancer
    from edgeyolo_tpu_torch.nn.modules.extra import DySample, FullPAD_Tunnel
    from edgeyolo_tpu_torch.nn.modules.msla_lgl import (DSC3K2_MSLA, LocalSS2DContext,
                                                        WaveletMixerMultiLevel)

    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (WaveletEnhancer, WaveletMixerMultiLevel, LocalSS2DContext)) or (
                    isinstance(m, DSC3K2_MSLA) and m.msla is not None):
                m.gamma.fill_(0.5)
            elif isinstance(m, FullPAD_Tunnel):
                m.gate.fill_(0.5)
            elif isinstance(m, MulGate):  # its branch needs `mix` and the BatchNorm scale too
                m.gamma.fill_(0.5)
                m.bn.weight.fill_(1.0)
                drawn(m.mix.weight, gen)
            elif isinstance(m, DySample):  # offsets away from the fixed bilinear upsample
                drawn(m.offset.weight, gen)
    return model


def drawn(weight, gen):
    """weight filled from gen with U(+-1/sqrt(fan_in)), the seeded init's draw."""
    import torch

    w = torch.rand(weight.shape, generator=gen) * 2 - 1
    weight.copy_(w * weight[0].numel() ** -0.5)


def exercise_branches(model):
    """Seeded random weights with the gates open, and class logits (of both
    branches of an E2E head) starting at 0, so scores straddle the confidence
    gate, giving NMS real work."""
    import torch

    head = open_gates(model).model[-1]
    with torch.no_grad():
        for seq in [*head.cv3, *getattr(head, "one2one_cv3", [])]:
            seq[-1].bias.zero_()
    return model


def dense_pred(model, out: dict):
    """The pred of `model` before any selection: for an end-to-end head its
    one2one decode, (B, A, 4 + nc) with xywh boxes as Detect's, in place of
    its top-k; else `out["pred"]`."""
    head = model.model[-1]
    if not getattr(model, "end2end", False):
        return out["pred"]
    with mock.patch.object(head, "end2end", False):
        return head.decode(out["one2one_feats"], out.get("one2one_quality"))


def unmatched_rows(got, want, box_atol: float, score_atol: float) -> int:
    """Rows of an E2E selection (B, K, 6) `got` whose class and box are not
    those of `want`'s row at the same place nor, where scores tie within
    2 score_atol, of a row of that group; the sorted scores must agree within
    score_atol (every row counts as unmatched otherwise). As tests/test_torch_e2e.py."""
    import torch

    if got.shape != want.shape or (got[..., 4] - want[..., 4]).abs().max() > score_atol:
        return got.shape[0] * got.shape[1]
    bad = 0
    for b in range(got.shape[0]):
        for i in range(got.shape[1]):
            near = torch.nonzero((want[b, :, 4] - got[b, i, 4]).abs() <= 2 * score_atol)[:, 0]
            bad += not any(got[b, i, 5] == want[b, j, 5]
                           and (got[b, i, :4] - want[b, j, :4]).abs().max() <= box_atol
                           for j in [i, *near.tolist()])
    return bad


def bn_statistics_of(model, x):
    """Every BatchNorm's running statistics set to those of the batch x (one
    train-mode forward at momentum 1), as a trained model's would be: at the
    init statistics the head's output is mostly its biases."""
    import torch

    from edgeyolo_tpu_torch.nn.modules.conv import MODEL_BN_MOMENTUM, BatchNorm2d

    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        model.train()(x)
    for m in bns:
        m.momentum = MODEL_BN_MOMENTUM
    return model.eval()


def n_attention(model) -> int:
    """LinearAttention modules in the model: kernel launches per forward."""
    from edgeyolo_tpu_torch.nn.modules.edgeline import LinearAttention

    return sum(isinstance(m, LinearAttention) for m in model.modules())


def perturbed(model, scale: float, seed: int = 0):
    """The weights tests/test_torch_families.py holds against JAX: BatchNorm
    statistics, scales and shifts moved, every gate opened at random, conv
    and linear weights times `scale` (a zero-initialised one, MulGate's `mix`
    and DySample's `offset`, drawn first; WTConv2d's learned scales moved as
    scales), class logits spread around 0; under them the output depends on
    the image (at init it is mostly the head's biases)."""
    import numpy as np
    import torch

    sd = model.state_dict()
    rs = np.random.RandomState(seed)
    head = next(k for k in sd if k.endswith("dfl.conv.weight")).rsplit(".dfl.", 1)[0]
    out = {}
    for k, v in sd.items():
        a, leaf = v.cpu().numpy().copy(), k.rsplit(".", 1)[-1]
        if k.endswith("num_batches_tracked") or ".dfl." in k:
            pass
        elif leaf in ("gamma", "gate"):
            a = rs.uniform(0.3, 0.8, a.shape)
        elif leaf in ("scale_weights", "alpha"):
            a = a + rs.uniform(-0.3, 0.3, a.shape)
        elif leaf == "running_mean":
            a = rs.randn(*a.shape) * 0.1
        elif leaf == "running_var":
            a = rs.uniform(0.5, 1.5, a.shape)
        elif leaf == "bias" and k.startswith(f"{head}.cv3.") and k.endswith(".2.bias"):
            a = rs.randn(*a.shape) * 0.5
        elif leaf == "bias" or (leaf == "weight" and a.ndim == 1) or ".base_scale." in k \
                or ".wavelet_scale." in k:
            a = a + rs.randn(*a.shape) * 0.1
        elif leaf == "weight":
            if not a.any():  # MulGate's mix, DySample's offset
                a = rs.uniform(-1, 1, a.shape) * a[0].size ** -0.5
            a = a * scale
        out[k] = torch.from_numpy(np.asarray(a, v.cpu().numpy().dtype))
    # an E2E head's one2one class logits spread around 0 too (tests/test_torch_v13_e2e_families.py)
    rs = np.random.RandomState(1)
    for k, v in out.items():
        if k.startswith(f"{head}.one2one_cv3.") and k.endswith(".2.bias"):
            out[k] = torch.from_numpy((rs.randn(*v.shape) * 0.5).astype(np.float32))
    model.load_state_dict(out)
    return model


def check_reference(la) -> dict:
    """Each model's f32 forward at 64 px on the card (kernel) against the CPU
    (plain version), gates open, at its seeded weights and at the weights of
    its tests (REF_SCALE); returns the kernel's launches on the card by model.
    Each model is built once on the CPU and copied to the card."""
    import torch

    from edgeyolo_tpu_torch.nn.tasks import DetectionModel

    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    launches = {}
    for name in ("edgeline-yolo-n", *FAMILIES, *NEW_REF_SCALE):
        seeded = DetectionModel(name, device="cpu", seed=0)  # built once, copied per start
        for scale in (None, REF_SCALE[name]):
            m = copy.deepcopy(seeded)
            m = exercise_branches(m) if scale is None else perturbed(m, scale)
            preds, sels = {}, {}
            for dev, model in (("cpu", m), ("cuda", copy.deepcopy(m).to("cuda"))):
                la.linear_attention_kernel.launches = 0
                with torch.inference_mode():
                    out = model(x.to(dev))
                    preds[dev] = dense_pred(model, out).float().cpu()
                    sels[dev] = out["pred"].float().cpu()
            launches[name] = la.linear_attention_kernel.launches
            d = (preds["cuda"] - preds["cpu"]).abs()
            box, cls = d[..., :4].max().item(), d[..., 4:].max().item()
            spread = (preds["cpu"][0] - preds["cpu"][1])[..., :4].abs().max().item()
            e2e = m.end2end
            # every candidate score within the score tolerance of every other (yolov10's
            # seeded head: 0.5 to 0.5 + 6e-8): which pairs the top-k keeps is then rounding's
            # choice on either side, and the decode before it is what can be compared
            flat = (preds["cpu"][..., 4:].max() - preds["cpu"][..., 4:].min()).item() < 1e-4
            bad = unmatched_rows(sels["cuda"], sels["cpu"], 5e-3, 1e-4) if e2e and not flat else 0
            print(f"{name}: f32 64px card (kernel, {launches[name]} launches) vs CPU (plain), "
                  f"{'seeded weights' if scale is None else f'test weights x{scale}'} (boxes of "
                  f"the two images apart by up to {spread:.3e} px): box {box:.3e} px (tol 5e-3), "
                  f"score {cls:.3e} (tol 1e-4)"
                  + (f" in the one2one decode before the top-k; E2E selection "
                     f"{tuple(out['pred'].shape)}: "
                     + ("not compared: every candidate score lies within 1e-4 of the others"
                        if flat else f"{bad} rows unmatched in box, score or class (tol 0)")
                     if e2e else ""), flush=True)
            if not (torch.isfinite(preds["cuda"]).all() and box < 5e-3 and cls < 1e-4
                    and bad == 0):
                raise AssertionError(f"{name} on the card disagrees with the CPU reference")
            if launches[name] != n_attention(m):
                raise AssertionError(f"{name}: {launches[name]} kernel launches in one forward, "
                                     f"{n_attention(m)} LinearAttention modules")
            del m
    print("launches per forward of the EdgeLine variants: "
          + ", ".join(f"{n} {launches[n.removesuffix('-n') + '.yaml']}"
                      for n in EDGELINE_VARIANTS), flush=True)
    return launches


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


def profile_request(predictor, imgs, unprofiled_ms: float, rows_out: list | None = None):
    """One more request under torch.profiler: device time by kernel, and the
    device's busy share both of the unprofiled median request time (the share
    to read: the profiler's own host overhead stretches the traced request)
    and of the traced request's wall time. A measurement only: a trace
    without device events is reported as not measured. `rows_out` receives
    every (device kernel, us, count) row."""
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
    if rows_out is not None:
        rows_out.extend(rows)
    if not rows:
        print("profile: no device events in the trace; device time not measured", flush=True)
        return None
    busy_us = sum(r[1] for r in rows)
    print(f"profile: device busy {busy_us / 1e3:.3f} ms in {sum(r[2] for r in rows)} device ops; "
          f"{100 * busy_us / (unprofiled_ms * 1e3):.1f}% of the unprofiled median request "
          f"({unprofiled_ms:.3f} ms), {100 * busy_us / wall_us:.1f}% of the profiled request "
          f"({wall_us / 1e3:.3f} ms)", flush=True)
    for key, us, count in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {count:5d}x  {key[:110]}", flush=True)
    la_rows = [r for r in rows if "la_context_kernel" in r[0] or "la_output_kernel" in r[0]]
    la_us = sum(r[1] for r in la_rows)
    print(f"profile: linear-attention kernel {la_us / 1e3:.4f} ms = "
          f"{100 * la_us / busy_us:.3f}% of device time ({sum(r[2] for r in la_rows)} of its "
          f"context and output launches recorded)", flush=True)
    return busy_us / 1e3


def serve_family(la, card: str, name: str) -> int:
    """Model `name` served in bf16 at 640 px: a warm-up request with the
    dtype of every conv and linear output recorded, SERVE_REQUESTS timed
    requests of SERVE_BATCH images (with the peak memory), the output checks,
    one profiled request, and the prediction against the same weights in f32
    (the bf16 departure of ROADMAP section C) and, where the model has
    attention, against the plain attention in bf16; an end-to-end model's
    prediction before its top-k (`dense_pred`). Returns the kernel's launches
    per request."""
    import torch
    from torch import nn

    from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor
    from edgeyolo_tpu_torch.nn.modules import edgeline
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel, for_precision, num_params

    t0 = time.perf_counter()
    model = exercise_branches(DetectionModel(name, device="cuda", dtype=torch.bfloat16, seed=0))
    n_attn = n_attention(model)
    print(f"serve {name}: {num_params(model)} params, bf16, {n_attn} LinearAttention module(s), "
          f"built in {time.perf_counter() - t0:.3f} s", flush=True)
    predictor = DetectionPredictor(model, conf=0.25, iou=0.7, max_det=300, max_nms=1024,
                                   device="cuda")
    imgs = torch.randint(0, 256, (SERVE_BATCH, SERVE_IMGSZ, SERVE_IMGSZ, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    out_dtypes = []
    hooks = [m.register_forward_hook(lambda _m, _i, o: out_dtypes.append(o.dtype))
             for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear)) and m.weight.dtype == torch.bfloat16]
    t0 = time.perf_counter()
    predictor(imgs)
    torch.cuda.synchronize()
    for hk in hooks:
        hk.remove()
    print(f"serve {name}: warm-up request {(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    if not out_dtypes or any(dt != torch.bfloat16 for dt in out_dtypes):
        raise AssertionError(f"{name}: conv and linear activations are not all bf16: "
                             f"{set(out_dtypes)}")
    print(f"serve {name}: bf16 check: {len(out_dtypes)} conv and linear outputs, all bf16",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    la.linear_attention_kernel.launches = 0
    times = []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        det, n = predictor(imgs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = la.linear_attention_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != SERVE_REQUESTS * n_attn:
        raise AssertionError(f"{name}: {launches} kernel launches in {SERVE_REQUESTS} requests, "
                             f"{n_attn} LinearAttention modules")
    ms = statistics.median(times) * 1e3
    print(f"serve {name}: batch {SERVE_BATCH} x {SERVE_IMGSZ} px bf16"
          f"{' (end to end: top-k of the head, no NMS)' if model.end2end else ''}, request times "
          f"{[round(t * 1e3, 3) for t in times]} ms, median {ms:.3f} ms, "
          f"{SERVE_BATCH / ms * 1e3:.1f} img/s, {launches // SERVE_REQUESTS} kernel launches per "
          f"request, peak memory {peak / 2**30:.3f} GiB (max_memory_allocated), on {card}",
          flush=True)
    det, n = det.cpu(), n.cpu()
    if not (det.shape == (SERVE_BATCH, 300, 6) and bool(torch.isfinite(det).all())
            and bool(((n >= 0) & (n <= 300)).all())):
        raise AssertionError(f"{name}: served detections are malformed")
    print(f"serve {name}: detections per image min {int(n.min())}, max {int(n.max())}",
          flush=True)
    profile_request(predictor, imgs, ms)

    with torch.inference_mode():
        x = imgs[:8].cuda().permute(0, 3, 1, 2).contiguous().float() / 255
        pred = dense_pred(model, model(x.to(torch.bfloat16)))
        if not bool(torch.isfinite(pred).all()):
            raise AssertionError(f"{name}: non-finite bf16 prediction")
        # the bf16 departure (ROADMAP section C): the served weights, then the same weights
        # with BatchNorm statistics of these images, under which the output depends on them
        for calibrate in (False, True):
            m32 = exercise_branches(DetectionModel(name, device="cuda", seed=0))
            if calibrate:
                bn_statistics_of(m32, x)
            m16 = for_precision(m32, True)
            p16, p32 = dense_pred(m16, m16(x.to(torch.bfloat16))), dense_pred(m32, m32(x))
            d = (p16 - p32).abs()
            spread = (p32[0] - p32[1])[..., :4].abs().max().item()
            mid = ((p32[..., 4:] > 0.01) & (p32[..., 4:] < 0.99)).float().mean().item()
            print(f"serve {name}: bf16 against f32, "
                  f"{'BatchNorm statistics of the images' if calibrate else 'served weights'} "
                  f"(boxes of two images apart by up to {spread:.3e} px, {100 * mid:.1f}% of "
                  f"scores in (0.01, 0.99)), 8 images: box max {d[..., :4].max().item():.3e} px "
                  f"(mean {d[..., :4].mean().item():.3e}), score max "
                  f"{d[..., 4:].max().item():.3e} (mean {d[..., 4:].mean().item():.3e})",
                  flush=True)
            del m32, m16
        if n_attn:
            with mock.patch.object(edgeline, "linear_attention", la.linear_attention_reference):
                pred_plain = dense_pred(model, model(x.to(torch.bfloat16)))
            d = (pred - pred_plain).abs()
            box, cls = d[..., :4].max().item(), d[..., 4:].max().item()
            print(f"serve {name}: pred kernel vs plain attention, bf16 on the card: box "
                  f"{box:.3e} px (tol 4), score {cls:.3e} (tol 2e-2)", flush=True)
            if not (box <= 4.0 and cls <= 2e-2):
                raise AssertionError(f"{name}: bf16 prediction through the kernel disagrees with "
                                     f"the plain path")
    return launches // SERVE_REQUESTS


def train_batch(b: int, imgsz: int, m: int, real: int, seed: int) -> dict:
    """A collated batch as the JAX loader gives it (dataset._collate): uint8
    NHWC images, classes, normalised xywh boxes, the target mask and n_real;
    `real` random boxes per image, the rest padding."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    img = torch.randint(0, 256, (b, imgsz, imgsz, 3), dtype=torch.uint8, generator=gen)
    cls = torch.randint(0, 80, (b, m), generator=gen).float()
    xy = 0.25 + 0.5 * torch.rand(b, m, 2, generator=gen)
    wh = 0.1 + 0.3 * torch.rand(b, m, 2, generator=gen)
    mask = (torch.arange(m) < real).float().expand(b, m).contiguous()
    return {"img": img, "cls": cls, "bboxes": torch.cat([xy, wh], -1) * mask[..., None],
            "mask_gt": mask, "n_real": b}


def ref_step(la, dev: str, start, batch: dict, replay: tuple | None = None,
             name: str = "edgeline-yolo-n", within=contextlib.nullcontext,
             match: "torch.Tensor | None" = None, select: "torch.Tensor | None" = None) -> dict:
    """One train step of model `name` (default augmentation, accumulate 1 so
    it updates) on `dev` from seeded weights that `start` prepares (gates
    open), in f32, inside the context `within()` makes; in f64 when
    `replay` gives the augmented batch of an f32 step to take in place of
    this step's own augmentation, and for an RT-DETR model `select` and
    `match` the f32 step's selected encoder queries and matched columns in
    place of its own top-k and auction (near-ties order either way in f64).
    Returns the loss, the gradients, the params after the update, the
    kernel's launches, the model's attention modules, the augmented batch,
    and an RT-DETR step's selected queries (images, queries) and matched
    columns (layers, images, gt slots)."""
    import torch

    from edgeyolo_tpu_torch.nn.modules import head as head_mod
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel
    from edgeyolo_tpu_torch.train import classify as classify_mod
    from edgeyolo_tpu_torch.train import detr_loss
    from edgeyolo_tpu_torch.train import trainer as trainer_mod

    model = start(open_gates(DetectionModel(name, device=dev, seed=0)))
    if replay is not None:
        model.double()
    images = batch["img"].shape[0]  # one update over the batch: nbs = batch
    # a classify model's step augments through classify_augment_batch, one image tensor
    mod, aug_name, trainer_cls = (
        (classify_mod, "classify_augment_batch", classify_mod.ClassificationTrainer)
        if model.task == "classify" else (trainer_mod, "augment_batch",
                                          trainer_mod.DetectionTrainer))
    trainer = trainer_cls(model, {**TRAIN_REF_HYP, "batch": images, "nbs": images}, device=dev)
    trainer.setup(nb=1)
    augmented, augment_batch = [], getattr(mod, aug_name)

    def augment(*args, **kwargs):
        out = (tuple(t.double() for t in replay) if replay is not None
               else augment_batch(*args, **kwargs))
        parts = (out,) if isinstance(out, torch.Tensor) else out
        augmented.append(tuple(t.detach().cpu() for t in parts))
        return parts[0] if model.task == "classify" else out

    # f64 throughout: the port's f32 casts (BatchNorm's island, the loss) become f64 ones
    f64 = (mock.patch.object(torch.Tensor, "float", torch.Tensor.double) if replay is not None
           else contextlib.nullcontext())
    matched = (mock.patch.object(detr_loss, "auction_assign",
                                 lambda cost, mask: match.to(cost.device))
               if match is not None else contextlib.nullcontext())
    selected, topk = [], head_mod.topk_stable

    def select_queries(scores, k):
        ix = topk(scores, k)[1] if select is None else select.to(scores.device)
        selected.append(ix.cpu())
        return scores.gather(-1, ix), ix

    la.linear_attention_kernel.launches = 0
    with mock.patch.object(mod, aug_name, augment), f64, matched, within(), \
            mock.patch.object(head_mod, "topk_stable", select_queries):
        loss, _, updated = trainer.train_step(
            trainer_mod.batch_to_device(batch, torch.device(dev)), mosaic=True)
    if not updated:
        raise AssertionError("the reference step did not update the parameters")
    return {"loss": loss.item(), "launches": la.linear_attention_kernel.launches,
            "n_attn": n_attention(model), "flat_grad": trainer.flat.grad.detach().cpu().clone(),
            "grads": {n: g.detach().cpu().double() for n, g in
                      trainer.flat.unflatten(trainer.flat.grad).items()},
            "params": {n: p.detach().cpu().double() for n, p in
                       trainer.flat.unflatten(trainer.flat.data).items()},
            "augmented": augmented[0], "select": selected[0] if selected else None,
            "match": (None if getattr(trainer.criterion, "last_match", None) is None
                      else trainer.criterion.last_match.cpu())}


def step_gap(ref: dict, other: dict) -> dict:
    """How far `other`'s step is from `ref`'s: the loss relative, each gradient
    of its own max |grad| in ref and the whole gradient of its norm, the
    params after the update absolute. A bias that feeds a train-mode
    BatchNorm through a 1x1 conv has no gradient in exact arithmetic, only
    rounding noise: such a tensor (under 1e-6 of ref's largest gradient) is
    held apart, to stay under that bound in other."""
    gr, go = ref["grads"], other["grads"]
    zero_bound = 1e-6 * max(g.abs().max().item() for g in gr.values())
    zero = [n for n, g in gr.items() if g.abs().max().item() <= zero_bound]
    grad = sorted(((go[n] - g).abs().max().item() / g.abs().max().item(), n)
                  for n, g in gr.items() if n not in zero)[::-1]
    norm2 = sum(g.square().sum().item() for g in gr.values())
    diff2 = sum((go[n] - g).square().sum().item() for n, g in gr.items())
    return {"loss": abs(other["loss"] - ref["loss"]) / abs(ref["loss"]), "grad": grad,
            "grad_all": math.sqrt(diff2 / norm2), "zero": zero, "zero_bound": zero_bound,
            "zero_ok": all(go[n].abs().max().item() <= zero_bound for n in zero),
            "param": max((other["params"][n] - p).abs().max().item()
                         for n, p in ref["params"].items())}


def gap_text(gap: dict) -> str:
    return (f"loss rel {gap['loss']:.3e}; worst gradient of its max |grad| "
            + ", ".join(f"{n} {e:.3e}" for e, n in gap["grad"][:3])
            + f"; whole gradient of its norm {gap['grad_all']:.3e}; {len(gap['zero'])} zero in "
            f"exact arithmetic ({', '.join(gap['zero'])}) under {gap['zero_bound']:.3e}: "
            f"{gap['zero_ok']}; params after the update {gap['param']:.3e}")


def card_vs_cpu(la, label: str, start, batch: dict, per_tensor: bool,
                name: str = "edgeline-yolo-n") -> dict:
    """The f32 step of model `name` on the card (kernel) and on the CPU
    (plain), held to TRAIN_REF_TOL: the loss, the params after the update
    and, with `per_tensor`, each gradient. Returns the CPU's and the card's
    steps."""
    cpu, card = (ref_step(la, dev, start, batch, name=name) for dev in ("cpu", "cuda"))
    gap = step_gap(cpu, card)
    print(f"{name}: train step f32 {TRAIN_REF_IMGSZ} px batch {batch['img'].shape[0]} from "
          f"{label}, "
          f"card (kernel, {card['launches']} launches) vs CPU (plain): loss {card['loss']:.6f} vs "
          f"{cpu['loss']:.6f}, {gap_text(gap)} (tol {TRAIN_REF_TOL}"
          + ("" if per_tensor else ", gradients against the f64 step below") + ")", flush=True)
    if card["launches"] != card["n_attn"]:
        raise AssertionError(f"{name}: {card['launches']} kernel launches in the train step on "
                             f"the card, {card['n_attn']} LinearAttention modules")
    if per_tensor:
        print(f"  {name}: largest per-tensor gradient gap from {label}: {gap['grad'][0][1]} "
              f"{gap['grad'][0][0]:.3e} of its max |grad| (tol {TRAIN_REF_TOL['grad']})",
              flush=True)
    if not (math.isfinite(card["loss"]) and gap["loss"] <= TRAIN_REF_TOL["loss"]
            and (gap["grad"][0][0] <= TRAIN_REF_TOL["grad"] or not per_tensor)
            and gap["zero_ok"] and gap["param"] <= TRAIN_REF_TOL["param"]):
        raise AssertionError(f"{name}: the train step on the card disagrees with the CPU's from "
                             f"{label}")
    return cpu, card


def witness(la, start, batch: dict, cpu: dict, card: dict, name: str = "edgeline-yolo-n"):
    """Each f32 side of a step against an f64 step on the CPU's augmented
    batch (an RT-DETR step also on the CPU's selected queries and matched
    pairs: the selection meets near-ties, and the auction's bids round to its
    eps, 1e6 / (4 nq) with padded gt rows), the exact step to f32's eyes:
    the card may be no farther from it than WITNESS_FACTOR times the CPU's
    f32 step in the loss, the whole gradient and the params, with
    WITNESS_FLOOR for gaps at f32 resolution."""
    import torch

    exact = ref_step(la, "cpu", start, batch, replay=cpu["augmented"], name=name,
                     match=cpu["match"], select=cpu["select"])
    img_gap = (card["augmented"][0] - cpu["augmented"][0]).abs().max().item()
    on_card, on_cpu = step_gap(exact, card), step_gap(exact, cpu)
    g32 = cpu["flat_grad"]
    print(f"  {name}: f64 step on the CPU's augmented batch (card's img01 within {img_gap:.3e} "
          f"of it): loss {exact['loss']:.6f}; the clip's global norm of the CPU's f32 gradient "
          f"({g32.numel()} entries), accumulated in f32 "
          f"{torch.linalg.vector_norm(g32).item():.6f}, in f64 (as the port does) "
          f"{torch.linalg.vector_norm(g32, dtype=torch.float64).item():.6f}", flush=True)
    for side, g in (("card f32", on_card), ("CPU f32", on_cpu)):
        print(f"  {name}: {side} against the f64 step: {gap_text(g)}", flush=True)
    cpu_err = {n: e for e, n in on_cpu["grad"]}
    print(f"  {name}: the card's worst gradients, card / CPU against the f64 step: "
          + ", ".join(f"{n} {e:.3e} / {cpu_err[n]:.3e}" for e, n in on_card["grad"][:4]),
          flush=True)
    worse = [k for k in WITNESS_FLOOR
             if on_card[k] > WITNESS_FACTOR * on_cpu[k] + WITNESS_FLOOR[k]]
    if worse or not on_card["zero_ok"]:
        raise AssertionError(f"{name}: the card's step is farther from the f64 step than the "
                             f"CPU's: {worse}")
    return exact


def check_train_reference(la) -> dict:
    """One f32 train step on the card with the kernel and on the CPU with the
    plain version, from the same seeded weights and the same draws of one
    CPU generator, from two starts each of the flagship and yolov13-test-n
    and one each of MSLA-n and yolov10n; returns the kernel's launches in
    the card's MSLA-n and yolov13-test-n steps, by model:

    - the model's own class prior (loss ~0.16): card against CPU, at
      TRAIN_REF_TOL; the same for yolov13-dsc3k2-msla-n;
    - class logits at 0 (loss ~3928: the update is clipped at norm 10, and
      the wavelet band weights' gradients, normalised softplus weights with
      cancelling terms, are the worst conditioned): card against CPU at
      TRAIN_REF_TOL for the loss and the params, and each side against the
      f64 step (`witness`);
    - yolov13-test-n (E2EDetectLoss over both branches, the wavelet mixers'
      gates open) from its class prior: card against CPU for the loss and
      the params, and the witness for the gradients. At the class prior
      every anchor predicts the same box, so the task-aligned assignment
      meets exact ties that f32 rounding breaks: the CPU's own f32 step is
      0.11 of the max |grad| of the head's level-0 box tower from the f64
      step there, while its loss is within 1e-9 (both steps on a CPU);
    - yolov13-test-n and yolov10n (E2EDetectLoss without quality) from
      class logits spread around 0 (`spread_logits`) on 4 images: card
      against CPU at TRAIN_REF_TOL with every gradient per tensor, and the
      witness. On 2 images, where the deepest maps of a 64 px step hold 2 x 2
      and 1 x 1 positions (yolov10n's level P5, yolov13-test-n's wavelet
      band), the CPU's own f32 step is up to 0.127 (yolov13-test-n) of a max
      |grad| from the f64 one; on 4 it is within 1.9e-4 (yolov13-test-n) and
      3.7e-4 (yolov10n) of it in every tensor (ROADMAP C.10). The 2-image
      steps are printed beside them (`reading`), not held.
    """
    batch = train_batch(TRAIN_REF_BATCH, TRAIN_REF_IMGSZ, TRAIN_REF_M, 4, seed=3)
    card_vs_cpu(la, "the class prior", lambda m: m, batch, per_tensor=True)
    launches = {MSLA: card_vs_cpu(la, "the class prior", lambda m: m, batch, per_tensor=True,
                                  name=MSLA)[1]["launches"]}
    cpu, card = card_vs_cpu(la, "the class prior", lambda m: m, batch, per_tensor=False,
                            name=V13_TEST)
    launches[V13_TEST] = card["launches"]
    witness(la, lambda m: m, batch, cpu, card, V13_TEST)
    batch4 = train_batch(4, TRAIN_REF_IMGSZ, TRAIN_REF_M, 4, seed=3)
    for name in (V13_TEST, V10):
        cpu, card = card_vs_cpu(la, "class logits spread around 0", spread_logits, batch4,
                                per_tensor=True, name=name)
        witness(la, spread_logits, batch4, cpu, card, name)
        reading(la, name, spread_logits, batch)
    cpu, card = card_vs_cpu(la, "class logits at 0", exercise_branches, batch, per_tensor=False)
    witness(la, exercise_branches, batch, cpu, card)
    return launches


def reading(la, name: str, start, batch: dict) -> None:
    """The f32 step of `name` from `start` on the card and on the CPU, each
    against the f64 step, printed and not held: a size at which f32 does not
    resolve every gradient (ROADMAP C.10)."""
    cpu, card = (ref_step(la, dev, start, batch, name=name) for dev in ("cpu", "cuda"))
    exact = ref_step(la, "cpu", start, batch, replay=cpu["augmented"], name=name)
    images = batch["img"].shape[0]
    for label, ref, side in (("card against CPU", cpu, card), ("card against f64", exact, card),
                             ("CPU against f64", exact, cpu)):
        print(f"  {name} on {images} images (a reading, not held): {label}: "
              f"{gap_text(step_gap(ref, side))}", flush=True)


def spread_logits(model):
    """`perturbed` at the seeded weights (scale 1): BatchNorm statistics moved,
    gates opened, and the class logits of both branches spread around 0, so
    the task-aligned assignment meets no exact ties."""
    return perturbed(model, 1.0)


TRAIN_STAGES = ("augment", "forward", "loss", "backward", "optimizer")


def stage_times(trainer, batch, name: str) -> None:
    """One more train step with a CUDA event and a host clock reading at each
    stage boundary: each stage's span on the device timeline (its kernels and
    any idle time waiting for the host) and the host's time to enqueue it."""
    import torch

    from edgeyolo_tpu_torch.train import trainer as trainer_mod

    marks = []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((ev, time.perf_counter()))

    def marked(fn, before=False):
        def wrapper(*args, **kwargs):
            if before:
                mark()
            out = fn(*args, **kwargs)
            if not before:
                mark()
            return out
        return wrapper

    torch.cuda.synchronize()
    mark()
    with mock.patch.object(trainer_mod, "augment_batch", marked(trainer_mod.augment_batch)), \
            mock.patch.object(trainer_mod, "train_forward", marked(trainer_mod.train_forward)), \
            mock.patch.object(trainer, "criterion", marked(trainer.criterion)), \
            mock.patch.object(trainer.optimizer, "step", marked(trainer.optimizer.step, True)):
        trainer.train_step(batch, mosaic=True)
    mark()
    torch.cuda.synchronize()
    spans = [(a[0].elapsed_time(b[0]), (b[1] - a[1]) * 1e3) for a, b in zip(marks, marks[1:])]
    print(f"train stages {name}, device timeline / host enqueue ms (one step, no profiler): "
          + ", ".join(f"{name} {dev:.3f} / {host:.3f}" for name, (dev, host) in
                      zip(TRAIN_STAGES, spans))
          + f"; step {sum(d for d, _ in spans):.3f} / {sum(h for _, h in spans):.3f}", flush=True)


def box_masks(batch: dict, ratio: int = 4):
    """Instance masks (B, M, S / ratio, S / ratio) for a train batch: each
    real box filled at the mask grid, less its top-left quarter (an L, so a
    mask is not its box)."""
    import torch

    sm = batch["img"].shape[1] // ratio
    bx = batch["bboxes"]
    xyxy = torch.cat([bx[..., :2] - bx[..., 2:] / 2, bx[..., :2] + bx[..., 2:] / 2], -1) * sm
    x1, y1, x2, y2 = xyxy[..., 0].floor(), xyxy[..., 1].floor(), xyxy[..., 2].ceil(), \
        xyxy[..., 3].ceil()
    ar = torch.arange(sm, dtype=torch.float32)
    inx = (ar >= x1[..., None]) & (ar < x2[..., None])
    iny = (ar >= y1[..., None]) & (ar < y2[..., None])
    nx, ny = ar < ((x1 + x2) / 2)[..., None], ar < ((y1 + y2) / 2)[..., None]
    masks = (iny[..., :, None] & inx[..., None, :]) & ~(ny[..., :, None] & nx[..., None, :])
    return masks.float() * batch["mask_gt"][..., None, None]


def seg_dense(model, out: dict, k: int = 20):
    """A segment model's 64 px outputs to compare: pred, coefficients,
    prototypes, and the k best anchors' indices and xyxy boxes."""
    import torch

    nc = model.nc
    pred = out["pred"].float()
    top = pred[..., 4:4 + nc].amax(-1).argsort(dim=1, descending=True, stable=True)[:, :k]
    box = pred[..., :4].gather(1, top[..., None].expand(-1, -1, 4))
    xyxy = torch.cat([box[..., :2] - box[..., 2:] / 2, box[..., :2] + box[..., 2:] / 2], -1)
    return pred, out["proto"].float(), top, xyxy


def seg_reference(la) -> dict:
    """The YOLOv9 detect models and the seg models at 64 px in f32, card
    against CPU, at seeded weights and at the weights of their tests; for a
    seg model also its coefficients, prototypes and cropped masks. Returns
    the attention kernel's launches per model (0: none has attention)."""
    import torch

    from edgeyolo_tpu_torch.nn.tasks import DetectionModel
    from edgeyolo_tpu_torch.ops.segments import proto_masks

    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    launches = {}
    for name, ref_scale in (*V9_REF_SCALE.items(), *SEG_REF_SCALE.items()):
        seeded = DetectionModel(name, device="cpu", seed=0)  # built once, copied per start
        for scale in (None, ref_scale):
            t0 = time.perf_counter()
            m = copy.deepcopy(seeded)
            m = exercise_branches(m) if scale is None else perturbed(m, scale)
            outs = {}
            la.linear_attention_kernel.launches = 0
            for dev, model in (("cpu", m), ("cuda", copy.deepcopy(m).to("cuda"))):
                with torch.inference_mode():
                    outs[dev] = model(x.to(dev))
            launches[name] = la.linear_attention_kernel.launches
            pc, pg = outs["cpu"]["pred"].float(), outs["cuda"]["pred"].float().cpu()
            nc = m.nc
            d = (pg - pc).abs()
            box, cls = d[..., :4].max().item(), d[..., 4:4 + nc].max().item()
            spread = (pc[0] - pc[1])[..., :4].abs().max().item()
            ok = bool(torch.isfinite(pg).all()) and box < 5e-3 and cls < 1e-4
            line = (f"{name}: f32 64px card vs CPU, "
                    f"{'seeded weights' if scale is None else f'test weights x{scale}'} (boxes of "
                    f"the two images apart by up to {spread:.3e} px): box {box:.3e} px (tol "
                    f"5e-3), score {cls:.3e} (tol 1e-4)")
            if m.task == "segment":
                coef_scale = pc[..., 4 + nc:].abs().max().item()
                coef = d[..., 4 + nc:].max().item()
                prc, prg = outs["cpu"]["proto"].float(), outs["cuda"]["proto"].float().cpu()
                proto_scale = prc.abs().max().item()
                proto = (prg - prc).abs().max().item()
                _, _, top, xyxy = seg_dense(m, outs["cpu"])
                nm = pc.shape[-1] - 4 - nc
                idx = top[..., None].expand(-1, -1, nm)
                mc = proto_masks(prc, pc[..., 4 + nc:].gather(1, idx), xyxy, 64)
                mg = proto_masks(prg, pg[..., 4 + nc:].gather(1, idx), xyxy, 64)
                mdiff = (mg - mc).abs().max().item()
                off = (mg > 0.5) != (mc > 0.5)
                near = (mc[off] - 0.5).abs().max().item() if off.any() else 0.0
                line += (f"; coefficients {coef:.3e} of scale {coef_scale:.3e}, prototypes "
                         f"{proto:.3e} of scale {proto_scale:.3e} (tol 1e-4 of the scale); "
                         f"cropped sigmoid masks of the 20 best anchors {mdiff:.3e} (tol 1e-4), "
                         f"{int(off.sum())} pixels apart at the 0.5 cut, within {near:.3e} of it "
                         f"(tol 1e-4)")
                ok = ok and coef < 1e-4 * coef_scale and proto < 1e-4 * proto_scale \
                    and mdiff < 1e-4 and near < 1e-4
            print(line + f"; {time.perf_counter() - t0:.1f} s", flush=True)
            if not ok:
                raise AssertionError(f"{name} on the card disagrees with the CPU reference")
            if launches[name]:
                raise AssertionError(f"{name}: {launches[name]} attention launches")
            del m, outs
    return launches


def serve_segment(la, card: str, name: str) -> dict:
    """A seg model served in bf16 at SERVE_BATCH x SERVE_IMGSZ px through
    SegmentationPredictor, uint8 in and masks out: a warm-up request,
    SERVE_REQUESTS timed requests, peak memory and one profiled request."""
    import torch

    from edgeyolo_tpu_torch.engine.predictor import SegmentationPredictor
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel, num_params

    model = exercise_branches(DetectionModel(name, device="cuda", dtype=torch.bfloat16, seed=0))
    predictor = SegmentationPredictor(model, conf=0.25, iou=0.7, max_det=300, max_nms=1024,
                                      device="cuda")
    imgs = torch.randint(0, 256, (SERVE_BATCH, SERVE_IMGSZ, SERVE_IMGSZ, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    t0 = time.perf_counter()
    predictor(imgs)
    torch.cuda.synchronize()
    print(f"serve {name}: {num_params(model)} params, bf16, warm-up request "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    torch.cuda.reset_peak_memory_stats()
    la.linear_attention_kernel.launches = 0
    times = []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        det, n, masks = predictor(imgs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times) * 1e3
    det, n, masks = det.cpu(), n.cpu(), masks.cpu()
    sm = SERVE_IMGSZ // 4
    if not (det.shape == (SERVE_BATCH, 300, 6) and masks.shape == (SERVE_BATCH, 300, sm, sm)
            and bool(torch.isfinite(det).all()) and bool(torch.isfinite(masks).all())
            and float(masks.min()) >= 0 and float(masks.max()) <= 1):
        raise AssertionError(f"{name}: served detections or masks are malformed")
    kept = [int(k) for k in n]
    on = [float((masks[i, :k] > 0.5).float().mean()) for i, k in enumerate(kept) if k]
    print(f"serve {name}: batch {SERVE_BATCH} x {SERVE_IMGSZ} px bf16, uint8 in, masks "
          f"({sm} x {sm} per detection) out; request times {[round(t * 1e3, 3) for t in times]} "
          f"ms, median {ms:.3f} ms, {SERVE_BATCH / ms * 1e3:.1f} img/s, peak memory "
          f"{peak / 2**30:.3f} GiB; detections per image {min(kept)}..{max(kept)}, mask pixels "
          f"on {statistics.mean(on) if on else 0:.3f}; attention launches "
          f"{la.linear_attention_kernel.launches}; on {card}", flush=True)
    busy = profile_request(predictor, imgs, ms)
    return {"ms": ms, "img_s": SERVE_BATCH / ms * 1e3, "peak_gib": peak / 2**30,
            "busy_ms": busy}


def check_seg_train_reference(la) -> None:
    """One f32 yolo11n-seg step at 64 px on 4 images with box masks, card
    against CPU from class logits spread around 0, every gradient per tensor
    at TRAIN_REF_TOL, and the f64 witness."""
    batch4 = train_batch(4, TRAIN_REF_IMGSZ, TRAIN_REF_M, 4, seed=3)
    batch4["masks"] = box_masks(batch4)
    cpu, card = card_vs_cpu(la, "class logits spread around 0", spread_logits, batch4,
                            per_tensor=True, name=SEG)
    witness(la, spread_logits, batch4, cpu, card, SEG)


def pose_obb_reference(la) -> None:
    """The pose and obb YAMLs at 64 px in f32, card against CPU, at seeded
    weights (class logits at 0) and at their tests' weights
    (POSE_OBB_REF_SCALE): boxes 5e-3 px, scores 1e-4, keypoints 5e-3 px and
    visibilities 1e-4, angles 1e-4; no attention launches."""
    import torch

    from edgeyolo_tpu_torch.nn.tasks import DetectionModel

    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    for name, ref_scale in POSE_OBB_REF_SCALE.items():
        seeded = DetectionModel(name, device="cpu", seed=0)  # built once, copied per start
        for scale in (None, ref_scale):
            t0 = time.perf_counter()
            m = copy.deepcopy(seeded)
            m = exercise_branches(m) if scale is None else perturbed(m, scale)
            outs = {}
            la.linear_attention_kernel.launches = 0
            for dev, model in (("cpu", m), ("cuda", copy.deepcopy(m).to("cuda"))):
                with torch.inference_mode():
                    outs[dev] = model(x.to(dev))["pred"].float().cpu()
            launches = la.linear_attention_kernel.launches
            pc, pg = outs["cpu"], outs["cuda"]
            nc = m.nc
            d = (pg - pc).abs()
            box, cls = d[..., :4].max().item(), d[..., 4:4 + nc].max().item()
            spread = (pc[0] - pc[1])[..., :4].abs().max().item()
            ok = bool(torch.isfinite(pg).all()) and box < 5e-3 and cls < 1e-4
            line = (f"{name}: f32 64px card vs CPU, "
                    f"{'seeded weights' if scale is None else f'test weights x{scale}'} (boxes of "
                    f"the two images apart by up to {spread:.3e} px): box {box:.3e} px (tol "
                    f"5e-3), score {cls:.3e} (tol 1e-4)")
            if m.task == "pose":
                k = d[..., 4 + nc:].reshape(*d.shape[:2], *m.kpt_shape)
                kxy, kv = k[..., :2].max().item(), k[..., 2].max().item()
                line += f", keypoints {kxy:.3e} px (tol 5e-3), visibility {kv:.3e} (tol 1e-4)"
                ok = ok and kxy < 5e-3 and kv < 1e-4
            else:
                ang = d[..., -1].max().item()
                line += f", angle {ang:.3e} (tol 1e-4)"
                ok = ok and ang < 1e-4
            print(line + f"; {time.perf_counter() - t0:.1f} s", flush=True)
            if not ok:
                raise AssertionError(f"{name} on the card disagrees with the CPU reference")
            if launches:
                raise AssertionError(f"{name}: {launches} attention launches")


def rotated_pred(b: int, a: int, nc: int, seed: int):
    """Crowded rotated predictions (B, A, 4 + nc + 1) at 1024 px: boxes around
    a few centres at random angles, scores spread over the classes."""
    import torch

    g = torch.Generator().manual_seed(seed)
    centres = torch.rand(b, 12, 2, generator=g) * 900 + 60
    pick = torch.randint(0, 12, (b, a), generator=g)
    xy = centres.gather(1, pick[..., None].expand(-1, -1, 2)) + torch.randn(b, a, 2, generator=g) * 12
    wh = 10 + torch.rand(b, a, 2, generator=g) * 80
    ang = (torch.rand(b, a, 1, generator=g) - 0.25) * math.pi
    return torch.cat([xy, wh, torch.rand(b, a, nc, generator=g) ** 2, ang], -1)


def check_rotated_nms() -> None:
    """The rotated NMS on the card: the blocked suppression against the dense
    plain version where both fit (argmax and multi-label candidates, equal
    selections), then blocked at ROT_NMS_SHAPE (batch 32 x max_nms 8192: a
    dense (32, 8192, 8192) probiou would hold 2.1e9 pairs per temporary):
    its time and peak memory."""
    import torch

    from edgeyolo_tpu_torch.ops import nms

    def dense(cand, cls_ix, iou_thres, n_live):  # the plain version in the blocked one's place
        return nms.rotated_suppressed_dense(cand, cls_ix, iou_thres)

    pred = rotated_pred(8, 4096, 15, seed=6).cuda()
    for ml in (False, True):
        kw = dict(conf_thres=0.05, iou_thres=0.5, max_det=2048, max_nms=2048, multi_label=ml)
        db, nb = nms.nms_rotated(pred, **kw)
        with mock.patch.object(nms, "rotated_suppressed_blocked", dense):
            dd, nd = nms.nms_rotated(pred, **kw)
        err = (db - dd).abs().max().item()
        print(f"rotated NMS on the card, {'multi-label' if ml else 'argmax'}, 8 x 2048 "
              f"candidates: blocked kept {nb.tolist()}, dense {nd.tolist()}, max abs diff "
              f"{err:.3e} (tol 0)", flush=True)
        if not torch.equal(nb, nd) or err != 0:
            raise AssertionError("the blocked rotated NMS disagrees with the dense one")
    b, n = ROT_NMS_SHAPE
    big = rotated_pred(b, 21504, 15, seed=7).cuda()  # 1024 px: 128^2 + 64^2 + 32^2 anchors
    kw = dict(conf_thres=0.0, iou_thres=0.7, max_det=300, max_nms=n)
    nms.nms_rotated(big, **kw)  # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: nms.nms_rotated(big, **kw), samples=3, warmup=0)
    peak = torch.cuda.max_memory_allocated() - base
    det, kept = nms.nms_rotated(big, **kw)
    print(f"rotated NMS blocked on the card at batch {b} x max_nms {n} (each image's {n - 1} "
          f"rows against the columns after them, at most {nms.ROT_NMS_ELEMS} (image, row, "
          f"column) triples a block): {ms:.3f} ms, "
          f"peak memory over its input {peak / 2**30:.3f} GiB, kept {int(kept.min())}.."
          f"{int(kept.max())} per image (a dense version would need {b * n * n * 4 / 2**30:.1f} "
          f"GiB per temporary)", flush=True)
    if not bool(torch.isfinite(det).all()) or int(kept.min()) <= 0:
        raise AssertionError("the blocked rotated NMS at full size failed")


def serve_pose_obb(la, card: str, name: str) -> dict:
    """A pose or obb model served in bf16 at its POSE_OBB_SERVE shape, class
    logits at 0 so every image fills its NMS candidates: a warm-up request,
    SERVE_REQUESTS timed requests, peak memory and one profiled request."""
    import torch

    from edgeyolo_tpu_torch.engine.predictor import OBBPredictor, PosePredictor
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel, num_params

    bs, imgsz, extra = POSE_OBB_SERVE[name]
    model = exercise_branches(DetectionModel(name, device="cuda", dtype=torch.bfloat16, seed=0,
                                             **extra))
    if model.task == "pose":  # the axis-aligned NMS's matrix, as the other served models
        predictor = PosePredictor(model, conf=0.25, iou=0.7, max_det=300, max_nms=1024,
                                  device="cuda")
    else:  # the blocked rotated NMS at the predictor's default 8192 candidates
        predictor = OBBPredictor(model, conf=0.25, iou=0.7, max_det=300, device="cuda")
    imgs = torch.randint(0, 256, (bs, imgsz, imgsz, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    t0 = time.perf_counter()
    predictor(imgs)
    torch.cuda.synchronize()
    print(f"serve {name}: {num_params(model)} params, nc {model.nc}"
          + (f", kpt_shape {list(model.kpt_shape)}" if model.kpt_shape else "")
          + f", bf16, max_nms {predictor.max_nms}, warm-up request "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    torch.cuda.reset_peak_memory_stats()
    la.linear_attention_kernel.launches = 0
    times = []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        out = predictor(imgs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times) * 1e3
    det, n = out[0].float().cpu(), out[1].cpu()
    cols = 6 if model.task == "pose" else 7
    ok = det.shape == (bs, 300, cols) and bool(torch.isfinite(det).all()) and int(n.min()) > 0
    if model.task == "pose":
        kp = out[2].float().cpu()
        ok = ok and kp.shape == (bs, 300, 51) and bool(torch.isfinite(kp).all())
    if not ok or la.linear_attention_kernel.launches:
        raise AssertionError(f"{name}: served detections are malformed")
    kept = [int(k) for k in n]
    print(f"serve {name}: batch {bs} x {imgsz} px bf16, uint8 in, "
          f"{'keypoints' if model.task == 'pose' else 'rotated boxes'} out; request times "
          f"{[round(t * 1e3, 3) for t in times]} ms, median {ms:.3f} ms, {bs / ms * 1e3:.1f} "
          f"img/s, peak memory {peak / 2**30:.3f} GiB; detections per image "
          f"{min(kept)}..{max(kept)}; attention launches 0; on {card}", flush=True)
    busy = profile_request(predictor, imgs, ms)
    return {"ms": ms, "img_s": bs / ms * 1e3, "peak_gib": peak / 2**30, "busy_ms": busy}


def check_pose_obb_train_reference(la) -> None:
    """One f32 step of yolo11n-pose (17 keypoints per box) and of
    yolo11n-obb (rotated boxes) at 64 px on 4 images, card against CPU from
    class logits spread around 0, every gradient per tensor at
    TRAIN_REF_TOL, and the f64 witness."""
    for name, task in ((POSE, "pose"), (OBB, "obb")):
        batch4 = task_targets(train_batch(4, TRAIN_REF_IMGSZ, TRAIN_REF_M, 4, seed=3), task)
        cpu, card = card_vs_cpu(la, "class logits spread around 0", spread_logits, batch4,
                                per_tensor=True, name=name)
        witness(la, spread_logits, batch4, cpu, card, name)


def task_targets(batch: dict, task: str, seed: int = 0) -> dict:
    """`batch` with a task's extra targets: a segment model's box masks, a
    pose model's 17 keypoints per box (in pixels, inside the box, visibility
    2 or 0), an obb model's rotated boxes (the boxes turned by an angle in
    [0, pi/2))."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    bx, mask = batch["bboxes"], batch["mask_gt"]
    b, m = mask.shape
    if task == "segment":
        batch["masks"] = box_masks(batch)
    elif task == "pose":
        s = batch["img"].shape[1]
        xy = (bx[..., None, :2] + (torch.rand(b, m, 17, 2, generator=gen) - 0.5)
              * bx[..., None, 2:]) * s
        vis = torch.where(torch.rand(b, m, 17, 1, generator=gen) < 0.8, 2.0, 0.0)
        batch["keypoints"] = torch.cat([xy, vis], -1) * mask[..., None, None]
    elif task == "obb":
        ang = torch.rand(b, m, 1, generator=gen) * math.pi / 2
        batch["rboxes"] = torch.cat([bx, ang], -1) * mask[..., None]
    return batch


def train(la, card: str, name: str = "edgeline-yolo-n", copy_paste: float = 0.0,
          shape: tuple | None = None):
    """Training steps of model `name` (scale n) at full width and depth (a
    segment model with box masks, and `copy_paste`; a pose model with
    keypoints, an obb model with rotated boxes), at `shape` (batch, px, real
    boxes per image; TRAIN_BATCH, TRAIN_IMGSZ and TRAIN_REAL by default);
    returns the kernel's launches in the timed steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from edgeyolo_tpu_torch.nn.modules import edgeline
    from edgeyolo_tpu_torch.nn.modules.conv import BatchNorm2d
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel, is_rtdetr, num_trainable
    from edgeyolo_tpu_torch.train.trainer import DetectionTrainer, ModelEMA, batch_to_device

    bs, imgsz, real = shape or (TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_REAL)
    model = DetectionModel(name, device="cuda", seed=0)
    n_attn = n_attention(model)
    hyp = {"batch": bs, "nbs": 64, "optimizer": "SGD", "lr0": 0.01, "momentum": 0.937,
           "amp": True, "seed": 0, "copy_paste": copy_paste}
    trainer = DetectionTrainer(model, hyp, device="cuda")
    trainer.setup(nb=TRAIN_STEPS + 2)
    print(f"train: {name}, {num_trainable(model)} trained params (f32 masters), "
          f"batch {bs} x {imgsz} px, bf16 autocast, SGD nesterov, accumulate "
          f"{trainer.accumulate}, mosaic {hyp.get('mosaic', 1.0)}, photometric 1.0", flush=True)
    host = task_targets(train_batch(bs, imgsz, max(TRAIN_M, real), real, seed=5), model.task)
    if model.task != "detect":
        print(f"train {name}: {real} {model.task} targets per image "
              f"({', '.join(k for k in ('masks', 'keypoints', 'rboxes') if k in host)}), "
              f"copy_paste {copy_paste}", flush=True)
    batch = batch_to_device(host, torch.device("cuda"))
    bn = next(m for m in model.modules() if isinstance(m, BatchNorm2d))

    # warm-up, with what reaches the kernel recorded
    seen = []

    def recording(q, k, v):
        y = la.linear_attention(q, k, v)
        saved = y.grad_fn.saved_tensors
        seen.append((q.dtype, q.is_contiguous(), [t.data_ptr() for t in saved],
                     [t.data_ptr() for t in (q, k, v)],
                     {t.untyped_storage().data_ptr() for t in saved}))
        return y

    t0 = time.perf_counter()
    with mock.patch.object(edgeline, "linear_attention", recording):
        trainer.train_step(batch, mosaic=True)
    torch.cuda.synchronize()
    print(f"warm-up step: {(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    if len(seen) != n_attn or any(dt != torch.bfloat16 for dt, *_ in seen):
        raise AssertionError(f"the attention's input is not bf16: {[s[0] for s in seen]}")
    if any(contig or saved != inputs or len(storages) != 1
           for _, contig, saved, inputs, storages in seen):
        raise AssertionError("the attention's q, k, v are not the saved strided views of one "
                             "qkv output")
    if n_attn:
        print(f"{name}: kernel input: bf16, strided views of the qkv conv output, saved for "
              f"backward without a copy ({n_attn} LinearAttention module(s))", flush=True)

    la.linear_attention_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        p0, ema0, rv0 = trainer.flat.data.clone(), trainer.ema.ema.clone(), bn.running_var.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, updated = trainer.train_step(batch, mosaic=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        moved = not torch.equal(trainer.flat.data, p0)
        if moved != updated:
            raise AssertionError(f"params moved={moved} on a step with update={updated}")
        if updated:
            d = ModelEMA.decay(trainer.ema.updates)
            ema_ref = ema0 * d + (1 - d) * trainer.flat.data
            ema_err = (trainer.ema.ema - ema_ref).abs().max().item()
            if ema_err > 1e-6:
                raise AssertionError(f"EMA departs from its formula by {ema_err}")
        elif not torch.equal(trainer.ema.ema, ema0):
            raise AssertionError("the EMA moved on a step without an update")
        if torch.equal(bn.running_var, rv0):
            raise AssertionError("BatchNorm running statistics did not move")
    launches = la.linear_attention_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train losses {losses}")
    if launches != TRAIN_STEPS * n_attn:
        raise AssertionError(f"{launches} kernel launches in {TRAIN_STEPS} train steps")
    ms = statistics.median(times) * 1e3
    print(f"train {name}: losses {[round(x, 4) for x in losses]}, {trainer.ema.updates} updates, "
          f"EMA and BatchNorm statistics checked; kernel launches {launches} in {TRAIN_STEPS} "
          f"steps",
          flush=True)
    print(f"train {name}: batch {bs} x {imgsz} px bf16, step times "
          f"{[round(t * 1e3, 3) for t in times]} ms, median {ms:.3f} ms, "
          f"{bs / ms * 1e3:.1f} img/s, peak memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated) on {card}", flush=True)
    if model.task == "segment" and peak / 2**30 > SEG_TRAIN_PEAK_GIB:
        raise AssertionError(f"{name}: peak memory {peak / 2**30:.3f} GiB over "
                             f"{SEG_TRAIN_PEAK_GIB}: a dense mask tensor was formed")

    stage_times(trainer, batch, name)
    if is_rtdetr(model):
        detr_spans(trainer, batch, name)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, mosaic=True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    if not rows:
        print(f"train profile {name}: no device events in the trace; device time not measured",
              flush=True)
        return launches
    busy_us = sum(r[1] for r in rows)
    la_rows = [r for r in rows if "la_context_kernel" in r[0] or "la_output_kernel" in r[0]]
    la_us = sum(r[1] for r in la_rows)
    print(f"train profile {name}: device busy {busy_us / 1e3:.3f} ms in {sum(r[2] for r in rows)} "
          f"device ops, {100 * busy_us / (ms * 1e3):.1f}% of the unprofiled median step, "
          f"{100 * busy_us / wall_us:.1f}% of the profiled step ({wall_us / 1e3:.3f} ms); "
          f"linear-attention kernel {la_us / 1e3:.4f} ms = {100 * la_us / busy_us:.3f}% of "
          f"device time ({sum(r[2] for r in la_rows)} of its context and output launches "
          f"recorded) on {card}", flush=True)
    for key, us, count in rows[:20]:
        print(f"  {us / 1e3:9.3f} ms {count:5d}x  {key[:110]}", flush=True)
    return launches


def cls_perturbed(model, scale: float, seed: int = 0):
    """A classify model's test weights: BatchNorm statistics, scales and shifts
    moved, conv and linear weights times `scale`, biases moved."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        a, leaf = v.cpu().numpy().copy(), k.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            a = rs.randn(*a.shape) * 0.1
        elif leaf == "running_var":
            a = rs.uniform(0.5, 1.5, a.shape)
        elif leaf == "bias" or (leaf == "weight" and a.ndim == 1):
            a = a + rs.randn(*a.shape) * 0.1
        elif leaf == "weight":
            a = a * scale
        out[k] = torch.from_numpy(np.asarray(a, v.cpu().numpy().dtype))
    model.load_state_dict(out)
    return model


def classify_reference(la) -> int:
    """The five cls YAMLs at 64 px in f32, card against CPU, at seeded and at
    test weights: logits within 1e-4 of their largest magnitude,
    probabilities 1e-5, the top-5 indices equal. Returns the attention
    kernel's launches (none: no cls model has a LinearAttention)."""
    import torch

    from edgeyolo_tpu_torch.nn.modules.head import topk_stable
    from edgeyolo_tpu_torch.nn.tasks import ClassificationModel, num_params

    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    la.linear_attention_kernel.launches = 0
    for name in CLS_YAMLS:
        seeded = ClassificationModel(name, device="cpu", seed=0)  # built once, copied per start
        for scale in (None, CLS_REF_SCALE):
            t0 = time.perf_counter()
            m = copy.deepcopy(seeded)
            if scale is not None:
                m = cls_perturbed(m, scale)
            with torch.inference_mode():
                lc = m(x).float()
                lg = copy.deepcopy(m).to("cuda")(x.cuda()).float().cpu()
            d = (lg - lc).abs().max().item() / lc.abs().max().item()
            dp = (lg.softmax(-1) - lc.softmax(-1)).abs().max().item()
            tc, tg = topk_stable(lc, 5)[1], topk_stable(lg, 5)[1]
            srt = lc.sort(-1, descending=True).values
            gap = (srt[:, :5] - srt[:, 1:6]).min().item()
            print(f"classify reference {name}: {num_params(m)} params, nc {m.nc}, f32 64px card "
                  f"vs CPU, {'seeded weights' if scale is None else f'test weights x{scale}'}: "
                  f"logits {d:.3e} of their scale {lc.abs().max().item():.3e} (tol 1e-4), "
                  f"probabilities {dp:.3e} (tol 1e-5), top-5 equal {torch.equal(tc, tg)} "
                  f"(smallest gap among the CPU's first six logits {gap:.3e}); "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if not (bool(torch.isfinite(lg).all()) and d < 1e-4 and dp < 1e-5
                    and torch.equal(tc, tg)):
                raise AssertionError(f"{name} on the card disagrees with the CPU reference")
            del m
    return la.linear_attention_kernel.launches


def serve_classify(la, card: str, name: str) -> dict:
    """A cls model (nc 1000) served in bf16 at CLS_SERVE_SHAPE through
    ClassificationPredictor: a warm-up request with every conv and linear
    output's dtype recorded, SERVE_REQUESTS timed requests (uint8 in, probs
    out), peak memory and a profiled request."""
    import torch
    from torch import nn

    from edgeyolo_tpu_torch.engine.classify import ClassificationPredictor
    from edgeyolo_tpu_torch.nn.tasks import ClassificationModel, num_params

    bs, imgsz = CLS_SERVE_SHAPE
    model = ClassificationModel(name, device="cuda", dtype=torch.bfloat16, seed=0)
    predictor = ClassificationPredictor(model, device="cuda", imgsz=imgsz, batch=bs)
    imgs = torch.randint(0, 256, (bs, imgsz, imgsz, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    out_dtypes = []
    hooks = [m.register_forward_hook(lambda _m, _i, o: out_dtypes.append(o.dtype))
             for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    t0 = time.perf_counter()
    predictor(imgs)
    torch.cuda.synchronize()
    for hk in hooks:
        hk.remove()
    if not out_dtypes or any(dt != torch.bfloat16 for dt in out_dtypes):
        raise AssertionError(f"{name}: conv and linear outputs are not all bf16: "
                             f"{set(out_dtypes)}")
    print(f"serve {name}: {num_params(model)} params, nc {model.nc}, bf16 ({len(out_dtypes)} conv "
          f"and linear outputs, all bf16), warm-up request "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    torch.cuda.reset_peak_memory_stats()
    la.linear_attention_kernel.launches = 0
    times = []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        probs = predictor(imgs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times) * 1e3
    probs = probs.cpu()
    ok = (probs.shape == (bs, model.nc) and probs.dtype == torch.float32
          and bool(torch.isfinite(probs).all()) and (probs.sum(-1) - 1).abs().max().item() < 1e-5)
    if not ok or la.linear_attention_kernel.launches:
        raise AssertionError(f"{name}: served probabilities are malformed")
    print(f"serve {name}: batch {bs} x {imgsz} px bf16, uint8 in, probs (f32, rows summing to 1) "
          f"out; request times {[round(t * 1e3, 3) for t in times]} ms, median {ms:.3f} ms, "
          f"{bs / ms * 1e3:.1f} img/s, peak memory {peak / 2**30:.3f} GiB; attention launches 0; "
          f"on {card}", flush=True)
    busy = profile_request(predictor, imgs, ms)
    return {"ms": ms, "img_s": bs / ms * 1e3, "peak_gib": peak / 2**30, "busy_ms": busy,
            "predictor": predictor}


def classify_jpeg_request(la, card: str, predictor, work: Path) -> None:
    """One request of CLS_JPEG JPEG files (q92, the port's encoder) through
    the predictor's host transform (decode, PIL's bilinear resize of the short
    side to 224, centre crop) and its serving step: wall time and the
    transform's share of it."""
    import numpy as np

    from edgeyolo_tpu_torch.data.imageio import save_jpeg

    n, w, h = CLS_JPEG
    d = work / "cls_jpeg"
    d.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(4)
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        g = 127 + 90 * np.sin((xx * np.cos(i) + yy * np.sin(i)) / (4 + i % 5))
        save_jpeg(d / f"im_{i:02d}.jpg", np.clip(g[..., None] + rs.normal(0, 20, (h, w, 3)), 0,
                                                 255).astype(np.uint8))
    predictor.predict(str(d))  # warm-up: the host paths once
    la.linear_attention_kernel.launches = 0
    t0 = time.perf_counter()
    results = predictor.predict(str(d))
    wall = (time.perf_counter() - t0) * 1e3
    pre = sum(r.speed["preprocess"] for r in results)
    infer = results[0].speed["inference"] * len(results)
    ok = len(results) == n and all(r.probs is not None and r.orig_shape == (h, w)
                                   and np.isfinite(r.probs.data).all() for r in results)
    print(f"serve {predictor.model.cfg}: one request of {n} JPEGs of {w} x {h} px from disk: "
          f"{wall:.3f} ms wall, {n / wall * 1e3:.1f} img/s; resize and centre crop "
          f"{pre:.3f} ms ({100 * pre / wall:.1f}% of the wall), serving step {infer:.3f} ms, "
          f"decode and the rest {wall - pre - infer:.3f} ms; top-1 of the first "
          f"{results[0].probs.top1} at {results[0].probs.top1conf:.4f}; on {card}", flush=True)
    if not ok or la.linear_attention_kernel.launches:
        raise AssertionError("the JPEG request gave malformed results")


def check_classify_train_reference(la) -> None:
    """One f32 yolo11n-cls step at 64 px on 4 images from its seeded weights
    with the same draws on both sides (nc 1000), card against CPU per tensor
    at TRAIN_REF_TOL, and the f64 witness."""
    import torch

    gen = torch.Generator().manual_seed(3)
    batch = {"img": torch.randint(0, 256, (4, TRAIN_REF_IMGSZ, TRAIN_REF_IMGSZ, 3),
                                  dtype=torch.uint8, generator=gen),
             "cls": torch.randint(0, 1000, (4,), generator=gen), "n_real": 4}
    cpu, card = card_vs_cpu(la, "seeded weights", lambda m: m, batch, per_tensor=True, name=CLS)
    witness(la, lambda m: m, batch, cpu, card, CLS)


def train_classify(la, card: str) -> int:
    """yolo11n-cls (nc 1000) training at CLS_TRAIN_SHAPE, bf16 autocast, the
    default classify hyps (random-resized crop, fliplr, HSV, RandAugment,
    erasing 0.4): a warm-up step, TRAIN_STEPS timed steps, the EMA and
    BatchNorm checks, peak memory and a profiled step's top device ops.
    Returns the attention launches (none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from edgeyolo_tpu_torch.nn.modules.conv import BatchNorm2d
    from edgeyolo_tpu_torch.nn.tasks import ClassificationModel, num_trainable
    from edgeyolo_tpu_torch.train.classify import ClassificationTrainer
    from edgeyolo_tpu_torch.train.trainer import ModelEMA, batch_to_device

    bs, imgsz = CLS_TRAIN_SHAPE
    model = ClassificationModel(CLS, device="cuda", seed=0)
    trainer = ClassificationTrainer(model, {"batch": bs, "nbs": 64, "optimizer": "SGD",
                                            "amp": True, "seed": 0}, device="cuda")
    trainer.setup(nb=TRAIN_STEPS + 2)
    a = trainer.args
    print(f"train: {CLS}, {num_trainable(model)} trained params (f32 masters), batch {bs} x "
          f"{imgsz} px, bf16 autocast, SGD nesterov, accumulate {trainer.accumulate}, "
          f"auto_augment {a['auto_augment']}, erasing {a['erasing']}, fliplr {a['fliplr']}, "
          f"hsv {a['hsv_h']}/{a['hsv_s']}/{a['hsv_v']}, scale {a['scale']}", flush=True)
    gen = torch.Generator().manual_seed(5)
    host = {"img": torch.randint(0, 256, (bs, imgsz, imgsz, 3), dtype=torch.uint8,
                                 generator=gen),
            "cls": torch.randint(0, model.nc, (bs,), generator=gen), "n_real": bs}
    batch = batch_to_device(host, torch.device("cuda"))
    bn = next(m for m in model.modules() if isinstance(m, BatchNorm2d))
    t0 = time.perf_counter()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    print(f"warm-up step: {(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    la.linear_attention_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        p0, ema0, rv0 = trainer.flat.data.clone(), trainer.ema.ema.clone(), bn.running_var.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, updated = trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if (not torch.equal(trainer.flat.data, p0)) != updated:
            raise AssertionError("the params moved on a step without an update, or not on one")
        if updated:
            d = ModelEMA.decay(trainer.ema.updates)
            if (trainer.ema.ema - (ema0 * d + (1 - d) * trainer.flat.data)).abs().max() > 1e-6:
                raise AssertionError("the EMA departs from its formula")
        elif not torch.equal(trainer.ema.ema, ema0):
            raise AssertionError("the EMA moved on a step without an update")
        if torch.equal(bn.running_var, rv0):
            raise AssertionError("BatchNorm running statistics did not move")
    launches = la.linear_attention_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or launches:
        raise AssertionError(f"train {CLS}: losses {losses}, attention launches {launches}")
    ms = statistics.median(times) * 1e3
    print(f"train {CLS}: losses {[round(x, 4) for x in losses]}, {trainer.ema.updates} updates, "
          f"EMA and BatchNorm statistics checked; batch {bs} x {imgsz} px bf16, step times "
          f"{[round(t * 1e3, 3) for t in times]} ms, median {ms:.3f} ms, {bs / ms * 1e3:.1f} "
          f"img/s, peak memory {peak / 2**30:.3f} GiB; attention launches 0; on {card}",
          flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    if not rows:
        print(f"train profile {CLS}: no device events in the trace; not measured", flush=True)
        return launches
    busy_us = sum(r[1] for r in rows)
    print(f"train profile {CLS}: device busy {busy_us / 1e3:.3f} ms in "
          f"{sum(r[2] for r in rows)} device ops, {100 * busy_us / (ms * 1e3):.1f}% of the "
          f"unprofiled median step, {100 * busy_us / wall_us:.1f}% of the profiled step "
          f"({wall_us / 1e3:.3f} ms) on {card}", flush=True)
    for key, us, count in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {count:5d}x  {key[:110]}", flush=True)
    return launches


def fit_classify(la, card: str, work: Path) -> dict:
    """The classify fit protocol on the card: yolo11n-cls trained through the
    facade (CLS_FIT_TRAIN, amp, default classify hyps), top-1 held to
    CLS_FIT_TOP1_MIN (JAX's less 0.1); best.pt reloaded and validated (equal
    to the best epoch's row), the same validation on the CPU in f32 (top-1
    and top-5 equal), then predict on the val images. Returns the attention
    launches in train, val and predict (none)."""
    import csv

    import numpy as np

    from edgeyolo_tpu_torch.data.synthetic import generate_classify_dataset
    from edgeyolo_tpu_torch.engine.model import YOLO

    t0 = time.perf_counter()
    data = generate_classify_dataset(work / "data", **CLS_FIT_DATA)
    print(f"classify fit dataset: {CLS_FIT_DATA}, JPEG q92, sides 60-140 px, written in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    model = YOLO(f"{CLS}.yaml", device="cuda")
    la.linear_attention_kernel.launches = 0
    t0 = time.perf_counter()
    model.train(data=str(data), project=str(work / "runs"), name="fit", **CLS_FIT_TRAIN)
    wall = time.perf_counter() - t0
    trainer = model.trainer
    launches = {"train": la.linear_attention_kernel.launches}
    n_ep = len(trainer.epoch_times)
    overhead = (wall - sum(trainer.epoch_times) - sum(trainer.val_times)) / n_ep
    with open(trainer.save_dir / "results.csv") as f:
        rows = list(csv.DictReader(f))
    best = trainer.best_metrics
    top1 = best.get("metrics/accuracy_top1", 0.0)
    print(f"fit {CLS}: {n_ep} epochs in {wall:.3f} s; epoch (train steps) median "
          f"{statistics.median(trainer.epoch_times) * 1e3:.3f} ms, val median "
          f"{statistics.median(trainer.val_times) * 1e3:.3f} ms, the rest {overhead * 1e3:.3f} ms "
          f"an epoch; nc {model.model.nc}; every 10th epoch (epoch, loss, top1, top5): "
          + "; ".join(" ".join(r[k] for k in ("epoch", "train/loss", "metrics/accuracy_top1",
                                             "metrics/accuracy_top5")) for r in rows[9::10])
          + f"; best {json.dumps(best)}, top-1 {top1:.6f} (limit {CLS_FIT_TOP1_MIN}, JAX "
          f"{CLS_JAX_TOP1}) on {card}", flush=True)
    if not top1 >= CLS_FIT_TOP1_MIN or launches["train"]:
        raise AssertionError(f"{CLS}: top-1 {top1} < {CLS_FIT_TOP1_MIN}")
    val_kw = {"data": str(data), "batch": CLS_FIT_TRAIN["batch"], "imgsz": CLS_FIT_TRAIN["imgsz"],
              "project": str(work / "runs")}
    reloaded = YOLO(trainer.save_dir / "best.pt", device="cuda")
    m_card = reloaded.val(name="val_card", **val_kw)
    launches["val"] = la.linear_attention_kernel.launches - launches["train"]
    m_cpu = YOLO(trainer.save_dir / "best.pt", device="cpu").val(name="val_cpu", **val_kw)
    gap = metrics_gap(best, m_card)
    same_cpu = all(m_cpu[k] == m_card[k] for k in ("metrics/accuracy_top1",
                                                   "metrics/accuracy_top5"))
    print(f"fit {CLS}: best.pt reloaded on the card: {json.dumps(m_card)}, largest gap to the "
          f"best epoch {gap:.3e} (tol {FIT_RELOAD_TOL}); on the CPU in f32: {json.dumps(m_cpu)}, "
          f"top-1 and top-5 equal to the card's: {same_cpu}", flush=True)
    if gap > FIT_RELOAD_TOL or not same_cpu:
        raise AssertionError("best.pt does not validate to the trainer's metrics on the card "
                             "and the CPU")
    n0 = la.linear_attention_kernel.launches
    results = reloaded.predict(str(data / "val"), imgsz=CLS_FIT_TRAIN["imgsz"],
                               project=str(work / "runs"))
    launches["predict"] = la.linear_attention_kernel.launches - n0
    top1s = [r.probs.top1 for r in results]
    ok = (len(results) == CLS_FIT_DATA["nc"] * CLS_FIT_DATA["n_val_per_class"] and all(
        np.isfinite(r.probs.data).all() and abs(float(r.probs.data.sum()) - 1) < 1e-4
        and len(r.probs.top5) == min(5, CLS_FIT_DATA["nc"]) for r in results))
    print(f"fit {CLS}: predict on the val images: {len(results)} Results with probs, top-1 "
          f"classes {np.bincount(top1s, minlength=CLS_FIT_DATA['nc']).tolist()} by class; "
          f"attention launches {launches}", flush=True)
    if not ok or any(launches.values()):
        raise AssertionError("classify predict on the val images failed")
    return launches


def check_tiled_nms():
    """The validator's per-image tiled NMS on the card against the scan oracle,
    multi-label, at conf 0.001 and max_nms 30000 with >= NMS_TILED_MIN
    candidates per image (crowded boxes, so suppression chains run long)."""
    import torch

    from edgeyolo_tpu_torch.ops.nms import non_max_suppression

    g = torch.Generator().manual_seed(4)
    b, a, nc = 2, 4000, 3
    xy = torch.rand(b, a, 2, generator=g) * 640
    wh = 8 + torch.rand(b, a, 2, generator=g) * 120
    pred = torch.cat([xy, wh, torch.rand(b, a, nc, generator=g) ** 2], -1).cuda()
    n_cand = int((pred[..., 4:] > 0.001).sum(-1).sum(-1).min())
    kw = dict(conf_thres=0.001, iou_thres=0.7, max_det=300, max_nms=30000, multi_label=True)
    det_t, n_t = non_max_suppression(pred, method="tiled", **kw)
    det_s, n_s = non_max_suppression(pred, method="scan", **kw)
    err = (det_t - det_s[:, :det_t.shape[1]]).abs().max().item()
    print(f"tiled NMS on the card vs the scan oracle: {n_cand} candidates per image past "
          f"conf 0.001, kept {n_t.tolist()} vs {n_s.tolist()}, max abs diff {err:.3e} (tol 0)",
          flush=True)
    if n_cand < NMS_TILED_MIN or not torch.equal(n_t, n_s) or err != 0:
        raise AssertionError("the tiled NMS disagrees with the scan oracle")


def jpeg_coco_copy(data_yaml, out: Path, quality: int = 92) -> Path:
    """The val split of a YOLO dataset re-encoded as JPEG (the port's encoder) under
    numeric stems 1, 2, ..., its labels beside, a COCO GT json of the labels (category
    id = class index, no crowds) and a dataset.yaml that names it as `annotations`.
    Returns the yaml's path."""
    import numpy as np

    from edgeyolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset, img2label_path
    from edgeyolo_tpu_torch.data.imageio import load_image_rgb, save_jpeg

    cfg = check_det_dataset(data_yaml)
    ds = YOLODataset(cfg["val"], imgsz=32)
    (out / "images" / "val").mkdir(parents=True, exist_ok=True)
    (out / "labels" / "val").mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for k, (f, lab) in enumerate(zip(ds.im_files, ds.labels), start=1):
        img = load_image_rgb(f)
        h, w = img.shape[:2]
        save_jpeg(out / "images" / "val" / f"{k}.jpg", img, quality=quality)
        (out / "labels" / "val" / f"{k}.txt").write_text(Path(img2label_path(f)).read_text())
        images.append({"id": k, "width": w, "height": h, "file_name": f"{k}.jpg"})
        for c, (cx, cy, bw, bh) in zip(lab["cls"].tolist(), lab["bboxes"].astype(np.float64)):
            anns.append({"id": len(anns) + 1, "image_id": k, "category_id": int(c),
                         "bbox": [(cx - bw / 2) * w, (cy - bh / 2) * h, bw * w, bh * h],
                         "area": bw * w * bh * h, "iscrowd": 0})
    gt = out / "instances_val.json"
    gt.write_text(json.dumps({"images": images, "annotations": anns,
                              "categories": [{"id": i, "name": n}
                                             for i, n in cfg["names"].items()]}))
    names = "".join(f"  {i}: {n}\n" for i, n in cfg["names"].items())
    (out / "dataset.yaml").write_text(f"path: {out}\ntrain: images/val\nval: images/val\n"
                                      f"annotations: {gt}\nnames:\n{names}")
    return out / "dataset.yaml"


def metrics_gap(a: dict, b: dict) -> float:
    return max(abs(a[k] - b[k]) for k in a)


def fit(la, card: str, work: Path, name: str = "edgeline-yolo.yaml",
        map_min: float = FIT_MAP_MIN, imgsz: int = FIT["imgsz"],
        extra_mins: dict | None = None, jax_maps: dict | None = None,
        epochs: int = FIT_TRAIN["epochs"]) -> tuple[dict, Path]:
    """Train, validate and predict model `name` (scale n) from a dataset on
    disk at `imgsz` for `epochs`, held to mAP50-95 >= map_min (a segment, pose or obb
    model on its task's form of the dataset; `extra_mins` holds more of the
    best epoch's metrics, e.g. the mask or pose mAP50-95, each to its
    limit, printed beside `jax_maps`). Returns the attention kernel's
    launches in train, val and predict, and the best checkpoint's path."""
    import csv

    import numpy as np
    import torch

    from edgeyolo_tpu_torch.data.synthetic import generate_dataset
    from edgeyolo_tpu_torch.engine.model import YOLO
    from edgeyolo_tpu_torch.train.trainer import DetectionTrainer

    t0 = time.perf_counter()
    model = YOLO(name, device="cuda")
    data = generate_dataset(work / "fit", **FIT, task=model.task)
    print(f"fit dataset: {FIT}, {model.task}, PNG, written in {time.perf_counter() - t0:.3f} s",
          flush=True)
    val_launches = []
    validate = DetectionTrainer._validate

    def counted(self, data_cfg):
        n0 = la.linear_attention_kernel.launches
        out = validate(self, data_cfg)
        val_launches.append(la.linear_attention_kernel.launches - n0)
        return out

    la.linear_attention_kernel.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(DetectionTrainer, "_validate", counted):
        model.train(data=str(data), project=str(work / "runs"), name="fit",
                    **{**FIT_TRAIN, "imgsz": imgsz, "epochs": epochs})
    wall = time.perf_counter() - t0
    trainer = model.trainer
    n_attn = n_attention(model.model)
    ran = (lambda k: k > 0) if n_attn else (lambda k: k == 0)  # kernel launches as expected
    launches = {"train": la.linear_attention_kernel.launches - sum(val_launches),
                "train_val": sum(val_launches)}
    epochs = len(trainer.epoch_times)
    # the rest of an epoch: results.csv and the checkpoints, plus the set-up spread over it
    rest = (wall - sum(trainer.epoch_times) - sum(trainer.val_times)) / epochs
    print(f"fit {name}: {epochs} epochs in {wall:.3f} s; epoch (train steps) median "
          f"{statistics.median(trainer.epoch_times) * 1e3:.3f} ms, first "
          f"{trainer.epoch_times[0] * 1e3:.3f} ms; val median "
          f"{statistics.median(trainer.val_times) * 1e3:.3f} ms, first "
          f"{trainer.val_times[0] * 1e3:.3f} ms; outside both {rest * 1e3:.3f} ms an epoch; "
          f"{trainer.accumulate} micro-steps per update, "
          f"{trainer.ema.updates} updates; deterministic algorithms "
          f"{trainer.args['deterministic']}; on {card}", flush=True)
    with open(trainer.save_dir / "results.csv") as f:
        rows = list(csv.DictReader(f))
    print(f"fit {name}: results.csv last row: " + json.dumps(rows[-1]), flush=True)
    print(f"fit {name}: every 15th epoch (epoch, box, cls, dfl, mAP50, mAP50-95, lr): " + "; ".join(
        " ".join(r[k] for k in ("epoch", "train/box_loss", "train/cls_loss", "train/dfl_loss",
                                "metrics/mAP50(B)", "metrics/mAP50-95(B)", "lr/pg0"))
        for r in rows[14::15]), flush=True)
    best = trainer.best_metrics
    print(f"fit {name}: best fitness {trainer.best_fitness:.6f}; best epoch's metrics "
          f"{json.dumps(best)}", flush=True)
    print(f"fit {name}: attention kernel launches: {launches['train']} in train steps "
          f"({epochs} steps x {n_attn}), {launches['train_val']} in the in-loop validations",
          flush=True)
    if launches["train"] != epochs * n_attn or not ran(launches["train_val"]):
        raise AssertionError(f"{name}: the fit's training launched the attention kernel "
                             f"{launches}, {n_attn} LinearAttention modules")
    if not best.get("metrics/mAP50-95(B)", 0.0) >= map_min:
        raise AssertionError(f"{name}: mAP50-95 {best.get('metrics/mAP50-95(B)')} < {map_min}")
    if extra_mins is not None:
        limits = {"metrics/mAP50-95(B)": map_min, **extra_mins}
        print(f"fit {name}: " + ", ".join(
            f"{k} {best[k]:.6f} (limit {v}, JAX {(jax_maps or {}).get(k)})"
            for k, v in limits.items()) + f" on {card}", flush=True)
        for k, v in extra_mins.items():
            if not best[k] >= v:
                raise AssertionError(f"{name}: {k} {best[k]} < {v}")

    # reload best.pt: the same metrics on the card, and within FIT_CPU_TOL on the CPU (f32)
    val_kw = {"data": str(data), "batch": FIT_TRAIN["batch"], "imgsz": imgsz,
              "project": str(work / "runs")}
    reloaded = YOLO(trainer.save_dir / "best.pt", device="cuda")
    la.linear_attention_kernel.launches = 0
    m_card = reloaded.val(name="val_card", **val_kw)
    launches["val"] = la.linear_attention_kernel.launches
    m_cpu = YOLO(trainer.save_dir / "best.pt", device="cpu").val(name="val_cpu", **val_kw)
    gap_reload, gap_cpu = metrics_gap(best, m_card), metrics_gap(m_card, m_cpu)
    print(f"fit {name}: best.pt reloaded on the card: {json.dumps(m_card)}; largest gap to the "
          f"best epoch {gap_reload:.3e} (tol {FIT_RELOAD_TOL}); {launches['val']} kernel "
          f"launches",
          flush=True)
    print(f"fit {name}: the same val on the CPU (f32, plain attention): {json.dumps(m_cpu)}; "
          f"largest gap to the card {gap_cpu:.3e} (tol {FIT_CPU_TOL})", flush=True)
    if gap_reload > FIT_RELOAD_TOL or gap_cpu > FIT_CPU_TOL or not ran(launches["val"]):
        raise AssertionError("best.pt does not validate to the trainer's metrics on the card "
                             "and the CPU")

    la.linear_attention_kernel.launches = 0
    # a pose or obb model predicts at FIT_TASK_PREDICT_CONF: after its 100 epochs few scores
    # pass the default 0.25, and the check is of the keypoints and rotated boxes it returns
    conf = FIT_TASK_PREDICT_CONF if model.task in ("pose", "obb") else None
    results = reloaded.predict(str(data.parent / "images" / "val"), imgsz=imgsz,
                               project=str(work / "runs"), conf=conf)
    launches["predict"] = la.linear_attention_kernel.launches
    if model.task == "obb":  # rotated boxes: finite, their centres inside their images
        inside = all(np.isfinite(r.obb.data).all() and ((r.obb.xywhr[:, :2] >= 0)
                                                         & (r.obb.xywhr[:, :2] <= [w, h])).all()
                     for r, (h, w) in ((r, r.orig_shape) for r in results))
    else:
        inside = all(((b[:, :2] >= 0) & (b[:, 2:] <= [w, h]) & (b[:, :2] <= b[:, 2:])).all()
                     for b, (h, w) in ((r.boxes.xyxy, r.orig_shape) for r in results))
    print(f"fit {name}: predict on the val images: {len(results)} Results, boxes per image "
          f"{[len(r) for r in results]}, all inside their images: {inside}; first: "
          f"{results[0].verbose_str if results else None}; {launches['predict']} kernel launches",
          flush=True)
    if len(results) != FIT["n_val"] or not inside or not ran(launches["predict"]) or (
            model.task == "obb" and not any(len(r) for r in results)):
        raise AssertionError("predict on the val images failed")
    if model.task == "pose":
        k_shape = tuple(reloaded.model.kpt_shape)
        shaped = all(r.keypoints is not None and r.keypoints.data.shape == (len(r), *k_shape)
                     and np.isfinite(r.keypoints.data).all() for r in results if len(r))
        print(f"fit {name}: keypoints {k_shape} per detection, finite: {shaped}", flush=True)
        if not shaped or not any(len(r) for r in results):
            raise AssertionError(f"{name}: predict gave no keypoints")
    if model.task == "segment":
        shaped = all(r.masks is not None and r.masks.data.shape == (len(r), *r.orig_shape)
                     for r in results if len(r))
        per_image = [0 if r.masks is None else len(r.masks) for r in results]
        print(f"fit {name}: masks per image {per_image}, each at its image's size: {shaped}; "
              f"first outline "
              f"{len(results[0].masks.xy[0]) if results[0].masks is not None else 0} points",
              flush=True)
        if not shaped or not any(r.masks is not None for r in results):
            raise AssertionError(f"{name}: predict gave no masks at the images' size")
    return launches, trainer.save_dir / "best.pt"


def val640(la, model, card: str, work: Path) -> None:
    """The trained model validated at full width: 640 px, batch 32, bf16."""
    import numpy as np
    import torch

    from edgeyolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    from edgeyolo_tpu_torch.data.synthetic import generate_dataset
    from edgeyolo_tpu_torch.nn.tasks import for_precision
    from edgeyolo_tpu_torch.ops.nms import non_max_suppression

    t0 = time.perf_counter()
    data = generate_dataset(work / "val640", n_train=0, n_val=VAL640["n_val"],
                            imgsz=VAL640["imgsz"], nc=FIT["nc"], seed=1)
    print(f"val640 dataset: {VAL640['n_val']} PNG images at {VAL640['imgsz']} px, written in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    kw = {"data": str(data), "imgsz": VAL640["imgsz"], "batch": VAL640["batch"], "half": True,
          "project": str(work / "runs")}
    model.val(name="val640_warm", **kw)  # warm-up: the first batches' kernels and plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    la.linear_attention_kernel.launches = 0
    t0 = time.perf_counter()
    metrics = model.val(name="val640", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = la.linear_attention_kernel.launches
    speed = model.validator.metrics.speed
    print(f"val640: {VAL640['n_val']} images at {VAL640['imgsz']} px, batch {VAL640['batch']}, "
          f"bf16: {wall:.3f} s, {VAL640['n_val'] / wall:.1f} img/s end to end; validator speed "
          f"ms per image {json.dumps({k: round(v, 4) for k, v in speed.items()})}; "
          f"{launches} kernel launches; peak memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated); metrics {json.dumps(metrics)}; on {card}", flush=True)

    # the host's part, alone: decode and letterbox per image
    cfg = check_det_dataset(data)
    ds = YOLODataset(cfg["val"], imgsz=VAL640["imgsz"])
    t0 = time.perf_counter()
    batch = [ds.get_item(i) for i in range(VAL640["batch"])]
    host_ms = (time.perf_counter() - t0) * 1e3 / VAL640["batch"]
    # the device's part on one batch: forward, NMS, native-space boxes and matching
    validator = model.validator
    net = for_precision(model.model, True).eval()
    img = torch.from_numpy(np.stack([it["img"] for it in batch])).cuda()
    gt = tuple(torch.from_numpy(a).cuda() for a in
               validator._gt_arrays({"meta": batch}))
    step = functools.partial(validator.infer, net, img, gt, 30000)
    device_ms = cuda_ms(step, samples=10, warmup=2)
    with torch.inference_mode():
        x = img.permute(0, 3, 1, 2).contiguous().to(net.dtype) / 255
        pred = net(x)["pred"]
    cand = (pred[..., 4:] > 0.001).sum(dim=(1, 2))
    nms = functools.partial(non_max_suppression, pred, conf_thres=0.001, iou_thres=0.7,
                            max_det=300, max_nms=30000, multi_label=True, method="tiled")
    nms_ms = cuda_ms(nms, samples=10, warmup=2)
    print(f"val640: decode and letterbox {host_ms:.3f} ms per image (host, one thread); "
          f"device step (forward, NMS, matching) {device_ms:.3f} ms per batch of "
          f"{VAL640['batch']}; NMS candidates past conf 0.001 per image: min {int(cand.min())}, "
          f"median {int(cand.median())}, max {int(cand.max())} (multi-label, of "
          f"{pred.shape[1] * (pred.shape[2] - 4)}); tiled NMS {nms_ms:.3f} ms per batch; on "
          f"{card}", flush=True)
    if launches <= 0:
        raise AssertionError("the 640 px validation did not go through the attention kernel")


def padded_copies(data_yaml, out: Path, n: int, long: int) -> Path:
    """n val images of a square dataset pasted onto wide (long x side) and n onto tall
    (side x long) canvases of the same background noise, as JPEG q92, with their labels
    moved exactly (the boxes shift by the paste offset). Returns the dataset.yaml."""
    import numpy as np

    from edgeyolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset, img2label_path
    from edgeyolo_tpu_torch.data.imageio import load_image_rgb, save_jpeg

    cfg = check_det_dataset(data_yaml)
    files = YOLODataset(cfg["val"], imgsz=32).im_files[:2 * n]
    rng = np.random.RandomState(2)
    for d in ("images", "labels"):
        (out / d / "val").mkdir(parents=True, exist_ok=True)
    for k, f in enumerate(files):
        img = load_image_rgb(f)
        side = img.shape[0]
        wide = k < n
        H, W = (side, long) if wide else (long, side)
        canvas = (rng.rand(H, W, 3) * 60 + 90).astype(np.uint8)
        off = (long - side) // 2
        y0, x0 = (0, off) if wide else (off, 0)
        canvas[y0:y0 + side, x0:x0 + side] = img
        save_jpeg(out / "images" / "val" / f"{k}.jpg", canvas, quality=92)
        lines = []
        for line in Path(img2label_path(f)).read_text().split("\n"):
            if line.strip():
                c, cx, cy, bw, bh = (float(v) for v in line.split())
                lines.append(f"{int(c)} {(cx * side + x0) / W:.6f} {(cy * side + y0) / H:.6f} "
                             f"{bw * side / W:.6f} {bh * side / H:.6f}")
        (out / "labels" / "val" / f"{k}.txt").write_text("\n".join(lines) + "\n")
    names = "".join(f"  {i}: {v}\n" for i, v in cfg["names"].items())
    (out / "dataset.yaml").write_text(f"path: {out}\ntrain: images/val\nval: images/val\n"
                                      f"names:\n{names}")
    return out / "dataset.yaml"


def jpeg(la, card: str, work: Path, best: Path) -> dict:
    """JPEG in and out on the flagship the fit phase trained: (a) the codec on the
    card's host, (b) save_json and COCO AP at the fit size, (c) val640 from JPEG
    through the threaded decode, (d) a rect validation of wide and tall JPEGs, then
    predict on JPEG files and save_crop. Returns the kernel's launches in each."""
    import numpy as np
    import torch

    from edgeyolo_tpu_torch.data import letterbox as lb
    from edgeyolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    from edgeyolo_tpu_torch.data.imageio import decode_jpeg, load_image_rgb
    from edgeyolo_tpu_torch.engine.model import YOLO

    launches = {}
    # (a) the codec on the card's host, on the val640 images
    t0 = time.perf_counter()
    v640 = jpeg_coco_copy(work / "val640" / "dataset.yaml", work / "val640_jpeg")
    src = YOLODataset(check_det_dataset(work / "val640" / "dataset.yaml")["val"], imgsz=32)
    jfiles = [work / "val640_jpeg" / "images" / "val" / f"{k}.jpg"
              for k in range(1, len(src.im_files) + 1)]
    print(f"jpeg: {len(jfiles)} val640 images re-encoded as JPEG q92 in "
          f"{time.perf_counter() - t0:.3f} s ({sum(f.stat().st_size for f in jfiles) / len(jfiles):.0f}"
          f" bytes per file)", flush=True)
    blobs = [f.read_bytes() for f in jfiles]
    worst = {"rmse": 0.0, "max_abs": 0}
    for f, blob in zip(src.im_files, blobs):
        a, b = load_image_rgb(f).astype(np.int32), decode_jpeg(blob).astype(np.int32)
        worst["rmse"] = max(worst["rmse"], float(np.sqrt(((a - b) ** 2).mean())))
        worst["max_abs"] = max(worst["max_abs"], int(np.abs(a - b).max()))
    print(f"jpeg: the port's decode of its q92 files against the source, worst image: RMSE "
          f"{worst['rmse']:.4f}, max |diff| {worst['max_abs']} (bound {JPEG_Q92})", flush=True)
    if worst["rmse"] > JPEG_Q92["rmse"] or worst["max_abs"] > JPEG_Q92["max_abs"]:
        raise AssertionError(f"JPEG round trip beyond PIL's q92 error: {worst}")
    size = VAL640["imgsz"]
    batch, metas = lb.letterbox_batch(blobs, size, scaleup=False)
    for i, blob in enumerate(blobs):
        one, [meta] = lb.letterbox_batch([blob], size, scaleup=False, threads=1)
        if not (np.array_equal(one[0], batch[i]) and meta == metas[i]):
            raise AssertionError(f"the threaded batch differs from one-by-one at image {i}")
    n = VAL640["batch"]
    timing = {}
    for threads in (1, lb.THREADS):
        lb.letterbox_batch(blobs[:n], size, scaleup=False, threads=threads)
        t0 = time.perf_counter()
        lb.letterbox_batch(blobs[:n], size, scaleup=False, threads=threads)
        timing[threads] = (time.perf_counter() - t0) * 1e3 / n
    print(f"jpeg: the threaded batch equals one-by-one decoding on all {len(blobs)} images; "
          f"decode and letterbox {timing[1]:.3f} ms per image on one thread, "
          f"{timing[lb.THREADS]:.3f} ms per image through the batch call ({lb.THREADS} threads, "
          f"batch {n}, {len(os.sched_getaffinity(0))} cores); on {card}", flush=True)

    # (b) save_json and COCO AP at the fit size
    coco_yaml = jpeg_coco_copy(work / "fit" / "dataset.yaml", work / "fit_jpeg")
    model = YOLO(best, device="cuda")
    la.linear_attention_kernel.launches = 0
    m = model.val(data=str(coco_yaml), batch=FIT_TRAIN["batch"], imgsz=FIT["imgsz"],
                  save_json=True, project=str(work / "runs"), name="val_coco")
    launches["coco"] = la.linear_attention_kernel.launches
    v = model.validator
    rows = json.loads((v.save_dir / "predictions.json").read_text())
    coco = {k: val for k, val in v.metrics.speed.items() if k.startswith("coco/")}
    gap = abs(coco.get("coco/AP", float("nan")) - m["metrics/mAP50-95(B)"])
    print(f"jpeg: fit val from JPEG with save_json: {len(rows)} rows in predictions.json; "
          f"mAP50-95 {m['metrics/mAP50-95(B)']:.6f}, COCO AP50-95 {coco.get('coco/AP', 'missing')}"
          f", gap {gap:.6f} (JAX's {JAX_COCO_GAP} + {JPEG_COCO_SLACK}); {json.dumps(coco)}; "
          f"{launches['coco']} kernel launches", flush=True)
    if not rows or len(coco) != 6 or not gap <= JAX_COCO_GAP + JPEG_COCO_SLACK \
            or launches["coco"] <= 0:
        raise AssertionError("save_json / COCO evaluation on the fit data failed")

    # (c) val640 from JPEG: 640 px, batch 32, bf16, through the threaded decode
    kw = {"data": str(v640), "imgsz": size, "batch": n, "half": True,
          "project": str(work / "runs")}
    model.val(name="val640_jpeg_warm", **kw)
    torch.cuda.synchronize()
    la.linear_attention_kernel.launches = 0
    t0 = time.perf_counter()
    m = model.val(name="val640_jpeg", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["val640"] = la.linear_attention_kernel.launches
    speed = model.validator.metrics.speed
    print(f"jpeg: val640 from JPEG: {len(blobs)} images at {size} px, batch {n}, bf16: "
          f"{wall:.3f} s, {len(blobs) / wall:.1f} img/s end to end; validator speed ms per image "
          f"{json.dumps({k: round(val, 4) for k, val in speed.items()})}; "
          f"{launches['val640']} kernel launches; metrics {json.dumps(m)}; on {card}", flush=True)
    if launches["val640"] <= 0 or not all(math.isfinite(val) for val in m.values()):
        raise AssertionError("the JPEG val640 did not go through the kernel or is not finite")

    # (d) rect validation of wide and tall JPEGs at 640 px
    rect_yaml = padded_copies(work / "val640" / "dataset.yaml", work / "rect_jpeg",
                              JPEG_RECT["n"], JPEG_RECT["long"])
    shapes = []
    from edgeyolo_tpu_torch.engine import validator as validator_mod
    infer = validator_mod.DetectionValidator.infer

    def seen(self, net, img, gt, max_nms):
        shapes.append(tuple(img.shape))
        return infer(self, net, img, gt, max_nms)

    la.linear_attention_kernel.launches = 0
    with mock.patch.object(validator_mod.DetectionValidator, "infer", seen):
        m = model.val(data=str(rect_yaml), imgsz=size, batch=n, half=True, rect=True,
                      project=str(work / "runs"), name="rect_jpeg")
    launches["rect"] = la.linear_attention_kernel.launches
    print(f"jpeg: rect val of {JPEG_RECT['n']} wide and {JPEG_RECT['n']} tall JPEGs "
          f"({JPEG_RECT['long']} x {size}): batch shapes {shapes}; metrics {json.dumps(m)}; "
          f"{launches['rect']} kernel launches", flush=True)
    if len(set(shapes)) != 2 or any(h == w for _, h, w, _ in shapes) or launches["rect"] <= 0 \
            or not all(math.isfinite(val) for val in m.values()):
        raise AssertionError("the rect JPEG validation did not keep its non-square canvases")

    # predict on the JPEG files once; save_crop of one result, decoded back
    la.linear_attention_kernel.launches = 0
    results = model.predict(str(work / "fit_jpeg" / "images" / "val"), imgsz=FIT["imgsz"],
                            project=str(work / "runs"))
    launches["predict"] = la.linear_attention_kernel.launches
    r = max(results, key=len)
    r.save_crop(work / "crops", "shot.jpg")
    crops = sorted((work / "crops").rglob("*.jpg"))
    h, w = r.orig_shape
    sizes = []
    for b in r.boxes.data:
        x1, y1, x2, y2 = b[:4]
        bw, bh = (x2 - x1) * 1.02 + 10, (y2 - y1) * 1.02 + 10
        xa, xb = int(np.clip((x1 + x2) / 2 - bw / 2, 0, w)), int(np.clip((x1 + x2) / 2 + bw / 2, 0, w))
        ya, yb = int(np.clip((y1 + y2) / 2 - bh / 2, 0, h)), int(np.clip((y1 + y2) / 2 + bh / 2, 0, h))
        if xb > xa and yb > ya:
            sizes.append((yb - ya, xb - xa))
    got = sorted(load_image_rgb(c).shape[:2] for c in crops)
    print(f"jpeg: predict on {len(results)} JPEG files: boxes per image {[len(x) for x in results]}"
          f"; save_crop of {len(r)} boxes wrote {len(crops)} crops of sizes {got}; "
          f"{launches['predict']} kernel launches", flush=True)
    if len(results) != FIT["n_val"] or got != sorted(sizes) or not crops \
            or launches["predict"] <= 0:
        raise AssertionError("predict or save_crop on the JPEG files failed")
    return launches


def mjpeg_server(blobs):
    """An MJPEG-over-HTTP camera on 127.0.0.1 (a thread): each GET streams
    `blobs` as multipart/x-mixed-replace parts. Returns (server, url)."""
    import http.server
    import threading

    class Camera(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
            self.end_headers()
            for blob in blobs:
                self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n"
                                 + f"Content-Length: {len(blob)}\r\n\r\n".encode() + blob + b"\r\n")

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Camera)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/line.mjpg"


def track_ids_kept(results, truth) -> list[tuple[float, int]]:
    """For each shape of `truth` (frames, shapes, [cls, x1, y1, x2, y2]): the
    share of the frames in which it is detected (a track of its class over
    it at IoU >= 0.5, the best one) that carry its most frequent id, and the
    number of those frames."""
    import numpy as np

    from edgeyolo_tpu_torch.metrics.metrics import _box_iou_np

    shares = []
    for k in range(truth.shape[1]):
        ids = []
        for r, gt in zip(results, truth):
            if len(r.track_ids):
                iou = _box_iou_np(gt[k:k + 1, 1:5], r.boxes.xyxy)[0]
                iou = np.where(r.boxes.cls == gt[k, 0], iou, 0.0)
                j = int(iou.argmax())
                if iou[j] >= 0.5:
                    ids.append(int(r.track_ids[j]))
        top = max(set(ids), key=ids.count) if ids else None
        shares.append((ids.count(top) / len(ids) if ids else 0.0, len(ids)))
    return shares


def video(la, card: str, work: Path, best: Path) -> dict:
    """Video in, tracks out: (a) a 1280 x 720 MJPEG AVI and the same frames
    from an MJPEG camera on 127.0.0.1 served by the flagship at 640 px,
    batch 32, bf16; (b) test-time augmentation on (a)'s first batch, and on
    64 px frames in f32 against the CPU; (c) ByteTrack and BoT-SORT over a
    160 px AVI of moving shapes with the fit phase's model at batch 1, ids
    held per shape and against the CPU, then frame-by-frame tracking at 640 px
    in bf16 and f32; (d) `save` and `visualize`; (e) one train step at batch
    32 x 640 px with `multi_scale`. Returns the kernel's launches by part."""
    import numpy as np
    import torch

    from edgeyolo_tpu_torch.data.imageio import decode_jpeg, encode_jpeg, load_image_rgb
    from edgeyolo_tpu_torch.data.letterbox import letterbox
    from edgeyolo_tpu_torch.data.loaders import open_video
    from edgeyolo_tpu_torch.data.synthetic import moving_shapes, write_mjpeg_avi
    from edgeyolo_tpu_torch.engine.model import YOLO
    from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor
    from edgeyolo_tpu_torch.nn.modules import edgeline
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel
    from edgeyolo_tpu_torch.trackers.gmc import GMC
    from edgeyolo_tpu_torch.train.trainer import DetectionTrainer, batch_to_device
    from edgeyolo_tpu_torch.utils.plotting import BitmapFont

    work.mkdir(parents=True, exist_ok=True)
    runs = str(work / "runs")
    shapes = []

    def recording(q, k, v):
        shapes.append((tuple(q.shape), str(q.dtype).removeprefix("torch.")))
        return la.linear_attention(q, k, v)

    def counted(fn):
        """fn() with the kernel's launches counted and their (B, N, H, D) recorded."""
        shapes.clear()
        la.linear_attention_kernel.launches = 0
        with mock.patch.object(edgeline, "linear_attention", recording):
            out = fn()
        torch.cuda.synchronize()
        return out, la.linear_attention_kernel.launches, list(shapes)

    launches = {}
    # (a) serving from video: the AVI, then the same JPEGs from an MJPEG camera
    t0 = time.perf_counter()
    frames, _ = moving_shapes(VIDEO["frames"], *VIDEO["hw"], n_objs=6, speed=8.0, seed=11)
    avi = write_mjpeg_avi(work / "line.avi", frames, quality=90)
    blobs = [encode_jpeg(f, quality=90) for f in frames]
    print(f"video (a): {len(frames)} frames of {VIDEO['hw'][1]} x {VIDEO['hw'][0]}, MJPEG AVI "
          f"of {avi.stat().st_size} bytes written in {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    decoded = list(open_video(avi))
    decode_s = time.perf_counter() - t0
    server = YOLO("edgeline-yolo.yaml", device="cuda")  # seeded weights: an empty line
    kw = {"imgsz": SERVE_IMGSZ, "batch": SERVE_BATCH, "half": True, "save": False,
          "project": runs, "conf": 0.25}
    list(server.predict(avi, stream=True, **kw))  # warm-up: cuDNN plans of both batch shapes
    torch.cuda.synchronize()
    for what, src in (("AVI", str(avi)), ("MJPEG camera", None)):
        srv = None
        if src is None:
            srv, src = mjpeg_server(blobs)
        t0 = time.perf_counter()
        try:
            res, n, seen = counted(lambda: list(server.predict(src, stream=True, **kw)))
        finally:
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        wall = time.perf_counter() - t0
        launches[f"video_{'avi' if what == 'AVI' else 'http'}"] = n
        print(f"video (a) {what}: {len(res)} frames in {wall:.3f} s end to end, "
              f"{len(res) / wall:.1f} frames/s at {SERVE_IMGSZ} px, batch {SERVE_BATCH}, bf16; "
              f"decode of the {len(decoded)} frames alone {decode_s:.3f} s on one thread "
              f"({decode_s / wall:.1%} of the wall time); {n} kernel launches at {set(seen)}; "
              f"detections per frame {[len(r) for r in res[:8]]}...; on {card}", flush=True)
        if len(res) != len(frames) or n != -(-len(frames) // SERVE_BATCH) or \
                any(r.orig_shape != tuple(VIDEO["hw"]) for r in res):
            raise AssertionError(f"video (a): serving the {what} failed")
        if what == "AVI" and not all(np.array_equal(a, b) for a, b in
                                     zip(decoded, (decode_jpeg(b) for b in blobs))):
            raise AssertionError("video (a): the AVI's frames are not its JPEGs")

    # (b) TTA: the first batch at 640 px, three launches at N = 400, 289, 196
    tta = DetectionPredictor(server.predictor.model, conf=0.25, device="cuda", imgsz=SERVE_IMGSZ,
                             augment=True)
    first = np.stack([letterbox(f, SERVE_IMGSZ)[0] for f in decoded[:SERVE_BATCH]])
    tta(first)  # warm-up
    t0 = time.perf_counter()
    (det, n_det), n, seen = counted(lambda: tta(first))
    tta_ms = (time.perf_counter() - t0) * 1e3
    launches["tta"] = n
    want = [((SERVE_BATCH, math.ceil(SERVE_IMGSZ * s / 32) ** 2, 2, 64), "bfloat16")
            for s in (1, 0.83, 0.67)]  # 400, 289 and 196 tokens at 640 px
    print(f"video (b) TTA: batch {SERVE_BATCH} at scales 1, 0.83, 0.67 in {tta_ms:.3f} ms, "
          f"{n} kernel launches at {seen}; detections per frame {n_det.tolist()[:8]}...",
          flush=True)
    if n != 3 or seen != want:
        raise AssertionError(f"video (b): TTA launched the kernel {n} times at {seen}, not {want}")
    m32 = perturbed(DetectionModel("edgeline-yolo.yaml", device="cpu", seed=0),
                    REF_SCALE["edgeline-yolo-n"])
    small = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(3)).numpy()
    got = DetectionPredictor(copy.deepcopy(m32), conf=0.25, device="cuda", imgsz=64,
                             augment=True)(small)
    ref = DetectionPredictor(m32, conf=0.25, device="cpu", imgsz=64, augment=True)(small)
    bad = unmatched_rows(got[0].cpu(), ref[0], 5e-3, 1e-4)
    print(f"video (b) TTA f32 at 64 px, card against CPU: detections {got[1].tolist()} and "
          f"{ref[1].tolist()}, {bad} rows unmatched (boxes 5e-3 px, scores 1e-4)", flush=True)
    if bad or not torch.equal(got[1].cpu(), ref[1]) or int(ref[1].sum()) == 0:
        raise AssertionError("video (b): TTA on the card disagrees with the CPU")

    # (c) tracking with the fit model (160 px) at batch 1, then frame by frame at 640 px
    truth_frames, truth = moving_shapes(TRACK["frames"], TRACK["imgsz"], TRACK["imgsz"],
                                        n_objs=3, size=(0.2, 0.28), speed=TRACK["speed"], seed=5)
    clip = write_mjpeg_avi(work / "track.avi", truth_frames, quality=95)
    fitted = {dev: YOLO(best, device=dev) for dev in ("cuda", "cpu")}
    tkw = {"imgsz": TRACK["imgsz"], "batch": 1, "project": runs}
    for tracker in ("bytetrack", "botsort"):
        t0 = time.perf_counter()
        res, n, seen = counted(lambda: list(fitted["cuda"].track(
            str(clip), tracker=tracker, name=f"track_{tracker}", exist_ok=True, **tkw)))
        wall = time.perf_counter() - t0
        launches[f"track_{tracker}"] = n
        cpu = list(fitted["cpu"].track(str(clip), tracker=tracker, save=False, **tkw))
        shares = track_ids_kept(res, truth)
        ids_equal = all(np.array_equal(a.track_ids, b.track_ids) for a, b in zip(res, cpu))
        pairs = [(a.boxes.data, b.boxes.data) for a, b in zip(res, cpu) if len(a) and len(a) == len(b)]
        gap = max((np.abs(a[:, :4] - b[:, :4]).max() for a, b in pairs), default=0.0)
        score_gap = max((np.abs(a[:, 5] - b[:, 5]).max() for a, b in pairs), default=0.0)
        print(f"video (c) {tracker}: {len(res)} frames at {TRACK['imgsz']} px, batch 1, f32, "
              f"{wall:.3f} s ({len(res) / wall:.1f} frames/s with save); {n} kernel launches at "
              f"{set(seen)}; per shape (share of its frames under its most frequent id, frames "
              f"found) {shares}; card against CPU: ids equal {ids_equal}, boxes within "
              f"{gap:.3e} px (tol 5e-3), scores within {score_gap:.3e} (tol 1e-4)", flush=True)
        if len(res) != TRACK["frames"] or n != len(res):
            raise AssertionError(f"video (c) {tracker}: {n} launches over {len(res)} frames")
        if any(s < TRACK["id_share"] or found < TRACK["frames"] // 2 for s, found in shares):
            raise AssertionError(f"video (c) {tracker}: a shape did not keep its id: {shares}")
        if not ids_equal or len(res) != len(cpu) or gap > 5e-3 or score_gap > 1e-4 or \
                any(len(a) != len(b) or not np.array_equal(a.boxes.cls, b.boxes.cls)
                    for a, b in zip(res, cpu)):
            raise AssertionError(f"video (c) {tracker}: the card's tracks differ from the CPU's")
    gmc = GMC("sparseOptFlow")
    gmc.apply(frames[0])
    t0 = time.perf_counter()
    for f in frames[1:6]:
        gmc.apply(f)
    print(f"video (c) GMC (sparseOptFlow, numpy) {(time.perf_counter() - t0) / 5 * 1e3:.3f} ms "
          f"per {VIDEO['hw'][1]} x {VIDEO['hw'][0]} frame on the card machine's host", flush=True)
    for half in (True, False):
        dtype = "bfloat16" if half else "float32"
        t0 = time.perf_counter()
        res, n, seen = counted(lambda: list(server.track(
            str(avi), imgsz=SERVE_IMGSZ, batch=1, half=half, vid_stride=8, save=False,
            project=runs, tracker="botsort")))
        wall = time.perf_counter() - t0
        launches[f"track_640_{dtype}"] = n
        print(f"video (c) frame by frame at {SERVE_IMGSZ} px, {dtype}, BoT-SORT, vid_stride 8: "
              f"{len(res)} frames in {wall:.3f} s, {n} kernel launches at {set(seen)}",
              flush=True)
        if n != len(res) or len(res) != len(frames) // 8 or \
                set(seen) != {((1, (SERVE_IMGSZ // 32) ** 2, 2, 64), dtype)}:
            raise AssertionError(f"video (c): frame-by-frame tracking at {SERVE_IMGSZ} px, "
                                 f"{dtype}, launched {n} times at {set(seen)}")

    # (d) save (the BoT-SORT run above) and visualize
    saved = sorted((work / "runs" / "track_botsort").glob("track_*.jpg"))
    k = TRACK["frames"] // 2
    frame_k = list(open_video(clip))[k]
    (r_cpu,) = fitted["cpu"].predict(frame_k, imgsz=TRACK["imgsz"], save=False, conf=0.1,
                                     project=runs)
    plot = r_cpu.plot()
    img = load_image_rgb(work / "runs" / "track_botsort" / f"track_{k}.jpg")
    h, w = plot.shape[:2]
    font = BitmapFont(max(12, max(round((w + h) / 2 * 0.003), 2) * 4))
    mask = np.ones((h, w), bool)
    for b in r_cpu.boxes.data:
        x0, y0, x1, y1 = font.getbbox(f"{r_cpu.names[int(b[-1])]} {b[-2]:.2f}")
        mask[max(int(b[1] + y0 - 2), 0):max(int(b[1] + y1) + 1, 0),
             max(int(b[0] + x0), 0):max(int(b[0] + x1 + 2) + 1, 0)] = False
    err = np.abs(img.astype(int) - plot)[mask].max()
    own = np.abs(decode_jpeg(encode_jpeg(plot, quality=75)).astype(int) - plot)[mask].max()
    print(f"video (d) save: {len(saved)} annotated JPEGs for {TRACK['frames']} frames; frame {k} "
          f"decoded against the CPU's plot outside the label bands: max |diff| {err} (the "
          f"encoder's own error on that plot {own})", flush=True)
    if len(saved) != TRACK["frames"] or err > own:
        raise AssertionError("video (d): the saved frames are not the CPU's plots")
    vis_dir = work / "runs" / "vis"
    fitted["cuda"].predict(truth_frames[0], imgsz=TRACK["imgsz"], visualize=True, save=False,
                           project=str(vis_dir.parent), name="vis", exist_ok=True)
    with torch.inference_mode():
        m = fitted["cuda"].model
        _, caps = m(torch.zeros(1, 3, TRACK["imgsz"], TRACK["imgsz"], device="cuda"),
                    capture=[sp.i for sp in m.layers[:-1]])
    want = sum(isinstance(t, torch.Tensor) and t.ndim == 4 and 1 not in t.shape[2:]
               for t in caps.values())
    pngs = sorted(p.name for p in (vis_dir / "image0").glob("*.png"))
    print(f"video (d) visualize: {len(pngs)} feature-map PNGs (layers with 4-D output: {want}), "
          f"e.g. {pngs[:3]}", flush=True)
    if len(pngs) != want or want == 0:
        raise AssertionError("video (d): visualize did not write one PNG per layer")

    # (e) multi_scale: one train step at batch 32 x 640 px
    trainer = DetectionTrainer(DetectionModel("edgeline-yolo.yaml", device="cuda", seed=0),
                               {"batch": TRAIN_BATCH, "nbs": 64, "optimizer": "SGD", "amp": True,
                                "seed": 0, "multi_scale": True}, device="cuda")
    trainer.setup(nb=2)
    batch = batch_to_device(train_batch(TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_M, TRAIN_REAL, seed=5),
                            torch.device("cuda"))
    trainer.train_step(batch)  # warm-up
    t0 = time.perf_counter()
    (loss, items, _), n, seen = counted(lambda: trainer.train_step(batch))
    step_ms = (time.perf_counter() - t0) * 1e3
    launches["multi_scale_train_step"] = n
    print(f"video (e) multi_scale train step, batch {TRAIN_BATCH} x {TRAIN_IMGSZ} px, bf16 "
          f"autocast: {step_ms:.3f} ms, loss {float(loss):.5f}, {n} kernel launch(es) at "
          f"{set(seen)}", flush=True)
    if n != 1 or not math.isfinite(float(loss)):
        raise AssertionError("video (e): the multi_scale train step failed")
    return launches


def rt_perturbed(model, seed: int = 0):
    """tests/test_torch_rtdetr.py's weights: BatchNorm statistics, norm scales
    and shifts and biases moved, the sampling-offset and attention-weight
    kernels (0 at init) drawn at 0.02, and every score head's bias spread
    around 0, so the output depends on the image and scores straddle 0.25."""
    import re

    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        a, leaf = v.cpu().numpy().copy(), k.rsplit(".", 1)[-1]
        if k.endswith("num_batches_tracked") or "denoising_class_embed" in k:
            pass
        elif re.search(r"(sampling_offsets|attention_weights)\.weight$", k):
            a = rs.randn(*a.shape) * 0.02
        elif re.search(r"score_head(\.\d+)?\.bias$", k):
            a = rs.randn(*a.shape) * 0.5
        elif leaf == "running_mean":
            a = rs.randn(*a.shape) * 0.1
        elif leaf == "running_var":
            a = rs.uniform(0.5, 1.5, a.shape)
        elif leaf in ("bias", "in_proj_bias") or (leaf == "weight" and a.ndim == 1):
            a = a + rs.randn(*a.shape) * 0.1
        out[k] = torch.from_numpy(np.asarray(a, v.cpu().numpy().dtype))
    model.load_state_dict(out)
    return model


@contextlib.contextmanager
def smooth_relus():
    """Every ReLU built and called in the block as SiLU (the HGNet convs'
    `act="relu"`, the decoder's FFN and MLPs): a gradient at a ReLU's kink
    jumps, and f32 rounding moves a pre-activation within 1e-7 of 0 to
    either side (tools/rtdetr_relu_kinks.py)."""
    import torch.nn.functional as F

    from edgeyolo_tpu_torch.nn.modules import conv as conv_mod

    with mock.patch.dict(conv_mod.ACTIVATIONS, {"relu": F.silu}), \
            mock.patch.object(F, "relu", F.silu):
        yield


def rows_unmatched(got, want, selection, box_px: float, score: float, size: int) -> int:
    """Rows of (B, nq, 4 + nc) `got` whose box (normalised; within box_px at
    `size` px) and scores (within `score`) are not those of `want`'s row at the
    same place nor, where the queries' selection scores lie within RTDETR_TIE,
    of a row of that group (as tests/test_torch_rtdetr.py's
    assert_queries_close)."""
    bad = 0
    for b in range(got.shape[0]):
        for i in range(got.shape[1]):
            group = [i, *(j for j in range(got.shape[1]) if j != i and abs(
                selection[b, j] - selection[b, i]) <= RTDETR_TIE)]
            bad += not any((got[b, i, :4] - want[b, j, :4]).abs().max() * size < box_px
                           and (got[b, i, 4:] - want[b, j, 4:]).abs().max() < score
                           for j in group)
    return bad


def check_deform_sampler() -> None:
    """The deformable sampler alone (plain PyTorch, four index gathers a level)
    on the card against the CPU at rtdetr-l's 640 px levels, taps outside the
    maps included: the output and its gradients within 1e-5 of their scale."""
    import torch

    from edgeyolo_tpu_torch.nn.modules.transformer import ms_deform_sample

    gen = torch.Generator().manual_seed(0)
    shapes = ((80, 80), (40, 40), (20, 20))
    ins = [torch.randn(2, 8400, 8, 32, generator=gen),
           torch.rand(2, 300, 8, 3, 4, 2, generator=gen) * 1.4 - 0.2,
           torch.rand(2, 300, 8, 3, 4, generator=gen)]
    card = [t.cuda().requires_grad_() for t in ins]
    ins = [t.requires_grad_() for t in ins]
    want = ms_deform_sample(ins[0], shapes, ins[1], ins[2])
    got = ms_deform_sample(card[0], shapes, card[1], card[2])
    (want ** 2).sum().backward()
    (got ** 2).sum().backward()
    err = (got.detach().cpu() - want.detach()).abs().max().item() / want.abs().max().item()
    gerr = max((c.grad.cpu() - t.grad).abs().max().item() / t.grad.abs().max().item()
               for c, t in zip(card, ins))
    print(f"rtdetr sampler alone, value {tuple(ins[0].shape)} over levels {shapes}, locations "
          f"{tuple(ins[1].shape)} (from -0.2 to 1.2: taps outside the maps): card vs CPU "
          f"{err:.3e} of the output scale, gradients {gerr:.3e} of theirs (tol 1e-5)",
          flush=True)
    if not (err <= 1e-5 and gerr <= 1e-5):
        raise AssertionError("the deformable sampler on the card disagrees with the CPU")


def rtdetr_reference(la) -> int:
    """The five rtdetr YAMLs (RTDETR_REF) in f32 at 64 px, card against CPU, at
    `rt_perturbed` weights: boxes within 5e-3 px and scores within 1e-4 row by
    row; the encoder's selected query indices equal where a selection score
    lies more than RTDETR_TIE from its neighbours (near-ties may order either
    way, and their rows are matched within the group); then the sampler
    alone. Returns the attention kernel's launches (no RT-DETR model has a
    LinearAttention)."""
    import torch

    from edgeyolo_tpu_torch.nn.modules import head as head_mod
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel

    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    topk = head_mod.topk_stable
    launches = 0
    for name, scale in RTDETR_REF:
        m = rt_perturbed(DetectionModel(name, scale=scale, device="cpu", seed=0))
        preds, picks = {}, {}
        for dev, model in (("cpu", m), ("cuda", copy.deepcopy(m).to("cuda"))):
            seen = []

            def record(v, k, seen=seen):
                top = topk(v, k)
                seen.append(tuple(t.cpu() for t in top))
                return top

            la.linear_attention_kernel.launches = 0
            with torch.inference_mode(), mock.patch.object(head_mod, "topk_stable", record):
                preds[dev] = model(x.to(dev))["pred"].float().cpu()
            launches += la.linear_attention_kernel.launches
            picks[dev] = seen[0]
        (sel, ix_cpu), (_, ix_card) = picks["cpu"], picks["cuda"]
        gaps = (sel[:, 1:] - sel[:, :-1]).abs() > RTDETR_TIE
        apart = torch.ones_like(ix_cpu, dtype=torch.bool)
        apart[:, 1:] &= gaps
        apart[:, :-1] &= gaps
        ix_bad = int(((ix_cpu != ix_card) & apart).sum())
        d = (preds["cuda"] - preds["cpu"]).abs()
        bad = rows_unmatched(preds["cuda"], preds["cpu"], sel, 5e-3, 1e-4, 64)
        spread = (preds["cpu"][0] - preds["cpu"][1])[..., :4].abs().max().item() * 64
        label = f"{name}-{scale}" if scale else name
        print(f"{label}: f32 64px card vs CPU, {preds['cpu'].shape[1]} queries "
              f"(boxes of the two images apart by up to {spread:.3f} px): in place box "
              f"{d[..., :4].max().item() * 64:.3e} px, score {d[..., 4:].max().item():.3e}; "
              f"{int((~apart).sum())} of {apart.numel()} selections within {RTDETR_TIE} of a "
              f"neighbour, {int((ix_cpu != ix_card).sum())} indices differ, {ix_bad} of them "
              f"apart (tol 0); rows unmatched within their tie group {bad} (box 5e-3 px, score "
              f"1e-4)", flush=True)
        if not (torch.isfinite(preds["cuda"]).all() and ix_bad == 0 and bad == 0):
            raise AssertionError(f"{name} on the card disagrees with the CPU reference")
        del m
    check_deform_sampler()
    print(f"rtdetr reference: attention kernel launches {launches} (no RT-DETR model has a "
          f"LinearAttention)", flush=True)
    return launches


def serve_rtdetr(la, card: str, name: str) -> int:
    """An RT-DETR model served in bf16 at SERVE_BATCH x SERVE_IMGSZ through
    DetectionPredictor (uint8 in, detections out: no NMS), every score head's
    bias at 0 so that 300 queries an image pass conf 0.25; conv and linear
    outputs bf16 and the sampler's locations f32; SERVE_REQUESTS timed
    requests, peak memory, a profiled request, and the sampler's own device
    time over the request's six calls (CUDA events, their captured inputs)."""
    import torch
    from torch import nn

    from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor
    from edgeyolo_tpu_torch.nn.modules import transformer
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel, num_params

    bs, imgsz = SERVE_BATCH, SERVE_IMGSZ
    model = DetectionModel(name, device="cuda", dtype=torch.bfloat16, seed=0)
    head = model.model[-1]
    with torch.no_grad():
        for lin in (head.enc_score_head, *head.dec_score_head):
            lin.bias.zero_()
    predictor = DetectionPredictor(model, device="cuda", imgsz=imgsz, batch=bs)
    imgs = torch.randint(0, 256, (bs, imgsz, imgsz, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    out_dtypes, sampled = [], []
    hooks = [m.register_forward_hook(lambda _m, _i, o: out_dtypes.append(o.dtype))
             for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]

    def capture(value, shapes, loc, weights):
        sampled.append((value, shapes, loc, weights))
        return sample(value, shapes, loc, weights)

    sample = transformer.ms_deform_sample
    t0 = time.perf_counter()
    with mock.patch.object(transformer, "ms_deform_sample", capture):
        predictor(imgs)
    torch.cuda.synchronize()
    for hk in hooks:
        hk.remove()
    coords = {(v.dtype, lc.dtype, w.dtype) for v, _, lc, w in sampled}
    if not out_dtypes or any(dt != torch.bfloat16 for dt in out_dtypes) or coords != {
            (torch.bfloat16, torch.float32, torch.float32)}:
        raise AssertionError(f"{name}: conv and linear outputs {set(out_dtypes)}, sampler "
                             f"value/locations/weights {coords}")
    print(f"serve {name}: {num_params(model)} params, bf16 ({len(out_dtypes)} conv and linear "
          f"outputs, all bf16; the sampler's {len(sampled)} calls take bf16 values and f32 "
          f"locations and weights), score biases at 0, warm-up request "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    torch.cuda.reset_peak_memory_stats()
    la.linear_attention_kernel.launches = 0
    times = []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        det, n = predictor(imgs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = la.linear_attention_kernel.launches
    ms = statistics.median(times) * 1e3
    det, n = det.float().cpu(), n.cpu()
    ok = (det.shape == (bs, 300, 6) and bool((n == 300).all()) and bool(torch.isfinite(det).all())
          and bool(((det[..., :4] >= 0) & (det[..., :4] <= imgsz)).all())
          and bool((det[..., 4] > 0.25).all()) and bool((det[..., 5] == det[..., 5].round()).all()))
    if not ok or launches:
        raise AssertionError(f"{name}: served detections are malformed")
    print(f"serve {name}: batch {bs} x {imgsz} px bf16, uint8 in, {int(n.sum())} detections out "
          f"(300 queries an image, no NMS); request times {[round(t * 1e3, 3) for t in times]} "
          f"ms, median {ms:.3f} ms, {bs / ms * 1e3:.1f} img/s, peak memory "
          f"{peak / 2**30:.3f} GiB; attention launches {launches}; on {card}", flush=True)
    busy = profile_request(predictor, imgs, ms)
    sampler_ms = sum(cuda_ms(lambda a=a: sample(*a), samples=10, warmup=2) for a in sampled)
    print(f"serve {name}: the sampler's {len(sampled)} calls of a request, each timed alone on "
          f"its captured inputs (value {tuple(sampled[0][0].shape)}): {sampler_ms:.3f} ms, "
          + (f"{100 * sampler_ms / busy:.1f}% of the profiled request's device-busy {busy:.3f} "
             f"ms" if busy else "device-busy time not measured") + f"; on {card}", flush=True)
    return launches


def check_rtdetr_train_reference(la) -> int:
    """rtdetr-l's f32 train step at TRAIN_REF_IMGSZ on 4 images with its
    denoising group, card against CPU from `rt_perturbed` weights (score
    logits spread around 0, sampling offsets off their init), the same
    draws of one CPU generator on both sides:
    - as built: the loss within TRAIN_REF_TOL and the matched pairs of every
      layer equal; its gradients and params printed, not held: HGNet's ReLU
      convs and the decoder's ReLU FFN put pre-activations within f32
      rounding of their kinks, where the gradient jumps (the CPU's own step at
      8 and 1 threads parts by up to a tenth of a tensor's max |grad|:
      tools/rtdetr_relu_kinks.py);
    - every ReLU as SiLU (`smooth_relus`): card against CPU at TRAIN_REF_TOL,
      every gradient per tensor but the sampling offsets', the matched pairs
      equal, and each side against the f64 step on the CPU's augmented
      batch, selection and matched pairs (`witness`). The sampling offsets
      reach the loss only through the sampler's locations, whose gradient
      jumps where a location crosses a pixel centre (the bilinear taps
      change); their per-tensor gaps are printed beside the bound the rest
      are held to.
    Matched pairs compare as the encoder tokens matched (`matched_queries`).
    Returns the attention kernel's launches on the card."""
    name = "rtdetr-l"
    batch = train_batch(4, TRAIN_REF_IMGSZ, TRAIN_REF_M, 4, seed=3)
    cpu, card = (ref_step(la, dev, rt_perturbed, batch, name=name) for dev in ("cpu", "cuda"))
    gap = step_gap(cpu, card)
    same = bool((matched_queries(cpu) == matched_queries(card)).all())
    print(f"{name}: train step f32 {TRAIN_REF_IMGSZ} px batch 4 with its denoising group, from "
          f"rt_perturbed weights, as built (ReLU): card vs CPU loss {card['loss']:.6f} vs "
          f"{cpu['loss']:.6f}, {gap_text(gap)}; matched tokens ({tuple(cpu['match'].shape)}, "
          f"{int((cpu['match'] >= 0).sum())} matched) equal: {same} (loss tol "
          f"{TRAIN_REF_TOL['loss']}; gradients and params a reading at the ReLU kinks)",
          flush=True)
    if not (math.isfinite(card["loss"]) and gap["loss"] <= TRAIN_REF_TOL["loss"] and same):
        raise AssertionError(f"{name}: the train step on the card disagrees with the CPU's")
    with smooth_relus():
        cpu, card = (ref_step(la, dev, rt_perturbed, batch, name=name) for dev in ("cpu", "cuda"))
        gap = step_gap(cpu, card)
        held = [(e, n) for e, n in gap["grad"] if "sampling_offsets" not in n]
        located = [(e, n) for e, n in gap["grad"] if "sampling_offsets" in n]
        same = bool((matched_queries(cpu) == matched_queries(card)).all())
        print(f"{name}: every ReLU as SiLU, card vs CPU: loss {card['loss']:.6f} vs "
              f"{cpu['loss']:.6f}, {gap_text(gap)}; the worst gradient held per tensor "
              f"{held[0][1]} {held[0][0]:.3e} of its max |grad| (tol {TRAIN_REF_TOL['grad']}); "
              f"the sampling offsets' (through the sampler's locations, not held) "
              + ", ".join(f"{n} {e:.3e}" for e, n in located[:3])
              + f"; matched tokens equal: {same}; {card['launches']} kernel launches", flush=True)
        if not (gap["loss"] <= TRAIN_REF_TOL["loss"] and held[0][0] <= TRAIN_REF_TOL["grad"]
                and gap["zero_ok"] and gap["param"] <= TRAIN_REF_TOL["param"] and same
                and card["launches"] == 0):
            raise AssertionError(f"{name}: the train step on the card disagrees with the CPU's "
                                 f"with its ReLUs as SiLU")
        witness(la, rt_perturbed, batch, cpu, card, name)
    return card["launches"]


def matched_queries(step: dict):
    """An RT-DETR step's matched pairs as the encoder token each gt slot went
    to, (layers, images, gt slots), -1 where unmatched: the matcher's columns
    are positions in the selection's order, which near-ties may permute."""
    import torch

    col, sel = step["match"], step["select"]
    token = sel[None].expand(col.shape[0], -1, -1).gather(-1, col.clamp(min=0))
    return torch.where(col >= 0, token, -1)


def detr_spans(trainer, batch, name: str) -> None:
    """One more RT-DETR train step with CUDA events around the criterion and
    around the matcher inside it: their spans on the device timeline (and the
    host's time to enqueue them) against the whole step's."""
    import torch

    from edgeyolo_tpu_torch.train import detr_loss

    spans = {}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[key] = (start, end, (time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    torch.cuda.synchronize()
    matcher = timed("matcher", detr_loss.auction_assign)
    with mock.patch.object(detr_loss, "auction_assign", matcher), \
            mock.patch.object(trainer, "criterion", timed("loss", trainer.criterion)):
        timed("step", trainer.train_step)(batch, mosaic=True)
    torch.cuda.synchronize()
    ms = {k: (s.elapsed_time(e), host) for k, (s, e, host) in spans.items()}
    step = ms["step"][0]
    print(f"train {name}: RT-DETR spans, device timeline / host enqueue ms (one step, no "
          f"profiler): step {step:.3f} / {ms['step'][1]:.3f}; loss {ms['loss'][0]:.3f} / "
          f"{ms['loss'][1]:.3f} = {100 * ms['loss'][0] / step:.1f}% of the step, the matcher "
          f"within it {ms['matcher'][0]:.3f} / {ms['matcher'][1]:.3f} = "
          f"{100 * ms['matcher'][0] / step:.1f}% ({detr_loss.AUCTION_ROUNDS} rounds over "
          f"{tuple(trainer.criterion.last_match.shape)} layers x images x gt slots at once)",
          flush=True)


@contextlib.contextmanager
def strictly_deterministic(on: bool):
    """trainer.deterministic_algorithms with warn_only off: an op without a
    deterministic form raises."""
    import torch

    was = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0])
        torch.backends.cudnn.deterministic = was[1]


def fit_rtdetr(la, card: str, work: Path):
    """yolov8-rtdetr-n on the fit protocol (`fit`), held to JAX's best
    mAP50-95 less 0.1, with no op in the run lacking a deterministic form (the
    trainer warns for one). cuBLAS runs with a fixed workspace
    (CUBLAS_WORKSPACE_CONFIG) in this process, as cuBLAS needs for it."""
    import warnings

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        launches, best = fit(la, card, work, f"{RTDETR_FIT}.yaml", RTDETR_FIT_MAP_MIN,
                             extra_mins={}, jax_maps={"metrics/mAP50-95(B)": RTDETR_JAX_MAP})
    nondet = sorted({str(w.message)[:160] for w in caught if "determinis" in str(w.message)})
    print(f"fit {RTDETR_FIT}: warnings of ops without a deterministic form in the fit: "
          f"{nondet or 'none'}", flush=True)
    if nondet:
        raise AssertionError(f"{RTDETR_FIT}: the fit ran ops without a deterministic form")
    return launches, best


def repeat_rtdetr(la, card: str, work: Path):
    """RTDETR_REPEAT_EPOCHS epochs of yolov8-rtdetr-n's fit twice under
    strictly deterministic algorithms (an op without a deterministic form
    raises), their last.pt equal to the bit; a FIT_JOBS entry of its own,
    off the long fit's path. Returns the attention kernel's launches."""
    import torch

    from edgeyolo_tpu_torch.data.synthetic import generate_dataset
    from edgeyolo_tpu_torch.engine.model import YOLO
    from edgeyolo_tpu_torch.train import trainer as trainer_mod

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    data = generate_dataset(work / "data", **FIT)
    la.linear_attention_kernel.launches = 0
    runs = []
    for i in range(2):
        model = YOLO(f"{RTDETR_FIT}.yaml", device="cuda")
        t0 = time.perf_counter()
        with mock.patch.object(trainer_mod, "deterministic_algorithms", strictly_deterministic):
            model.train(data=str(data), project=str(work / "repeat"), name=f"r{i}",
                        **{**FIT_TRAIN, "epochs": RTDETR_REPEAT_EPOCHS})
        ck = torch.load(model.trainer.save_dir / "last.pt", map_location="cpu",
                        weights_only=True)
        runs.append((ck, time.perf_counter() - t0))
    same = all(torch.equal(runs[0][0][k][n], runs[1][0][k][n])
               for k in ("model", "ema") for n in runs[0][0][k])
    print(f"fit {RTDETR_FIT}: {RTDETR_REPEAT_EPOCHS} epochs twice under strictly deterministic "
          f"algorithms ({runs[0][1]:.3f} s, {runs[1][1]:.3f} s): last.pt's weights and EMA equal "
          f"to the bit: {same}; on {card}", flush=True)
    if not same:
        raise AssertionError(f"{RTDETR_FIT}: the fit does not repeat")
    return {"repeat": la.linear_attention_kernel.launches}, None


def registry_spec() -> dict:
    """The registry test graph's spec (tests/torch_registry_spec.py)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_registry_spec import SPEC

    return SPEC


def registry_reference(la) -> int:
    """The registry test graph's f32 forward at 64 px on the card (kernel)
    against the CPU (plain version), at its seeded weights with the gates open
    and at the weights of its tests (REGISTRY_REF_SCALE), unfused and fused
    (DetectionModel.fuse on each side); then the fused card model against the
    unfused one within FUSED_F32_TOL. Returns the kernel's launches per forward."""
    import torch

    from edgeyolo_tpu_torch.nn.tasks import DetectionModel

    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    seeded = DetectionModel(registry_spec(), device="cpu", seed=0)
    n_attn = n_attention(seeded)
    for scale in (None, REGISTRY_REF_SCALE):
        m = copy.deepcopy(seeded)
        m = exercise_branches(m) if scale is None else perturbed(m, scale)
        preds = {}
        for fused in (False, True):
            base = copy.deepcopy(m).fuse() if fused else m
            for dev, model in (("cpu", base), ("cuda", copy.deepcopy(base).to("cuda"))):
                la.linear_attention_kernel.launches = 0
                with torch.inference_mode():
                    preds[fused, dev] = model(x.to(dev))["pred"].float().cpu()
            launches = la.linear_attention_kernel.launches
            d = (preds[fused, "cuda"] - preds[fused, "cpu"]).abs()
            box, cls = d[..., :4].max().item(), d[..., 4:].max().item()
            spread = (preds[fused, "cpu"][0] - preds[fused, "cpu"][1])[..., :4].abs().max().item()
            print(f"registry graph{' fused' if fused else ''}: f32 64px card (kernel, {launches} "
                  f"launches) vs CPU (plain), "
                  f"{'seeded weights' if scale is None else f'test weights x{scale}'} (boxes of "
                  f"the two images apart by up to {spread:.3e} px): box {box:.3e} px (tol 5e-3), "
                  f"score {cls:.3e} (tol 1e-4)", flush=True)
            if not (torch.isfinite(preds[fused, "cuda"]).all() and box < 5e-3 and cls < 1e-4):
                raise AssertionError("the registry graph on the card disagrees with the CPU")
            if launches != n_attn:
                raise AssertionError(f"registry graph: {launches} kernel launches in one forward, "
                                     f"{n_attn} LinearAttention modules")
        d = (preds[True, "cuda"] - preds[False, "cuda"]).abs()
        scale_px = preds[False, "cuda"][..., :4].abs().max().item()
        box, cls = d[..., :4].max().item(), d[..., 4:].max().item()
        print(f"registry graph: fused vs unfused f32 on the card: box {box:.3e} px (tol "
              f"{FUSED_F32_TOL} x {scale_px:.3f}), score {cls:.3e} (tol {FUSED_F32_TOL})",
              flush=True)
        if not (box <= FUSED_F32_TOL * scale_px and cls <= FUSED_F32_TOL):
            raise AssertionError("the fused f32 registry graph moved from the unfused one")
    return n_attn


def serve_registry(la, card: str) -> int:
    """The registry test graph served at SERVE_BATCH x SERVE_IMGSZ in bf16
    through DetectionPredictor, gates open, class biases at 0 and BatchNorm
    statistics of 8 of the images: a warm-up
    request that records every conv and linear output's dtype and DySample's
    sampling coordinates' dtype and holds each attention launch's output
    against the plain version on its own inputs (REGISTRY_LA_SHAPES), then
    SERVE_REQUESTS timed requests (ms, img/s, launches per request, peak
    memory) and a profiled one. Returns the launches per request."""
    import torch
    from torch import nn

    from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor
    from edgeyolo_tpu_torch.nn.modules import edgeline
    from edgeyolo_tpu_torch.nn.modules.extra import DySample
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel, num_params

    t0 = time.perf_counter()
    model = exercise_branches(DetectionModel(registry_spec(), device="cuda",
                                             dtype=torch.bfloat16, seed=0))
    n_attn = n_attention(model)
    print(f"serve registry graph: {num_params(model)} params, bf16, {n_attn} LinearAttention "
          f"module(s), built in {time.perf_counter() - t0:.3f} s", flush=True)
    imgs = torch.randint(0, 256, (SERVE_BATCH, SERVE_IMGSZ, SERVE_IMGSZ, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    # BatchNorm statistics of 8 of the images: at init the deep activations, and so the
    # attention's inputs, are near 0 and the output hardly depends on the image
    bn_statistics_of(model, imgs[:8].cuda().permute(0, 3, 1, 2).to(torch.bfloat16) / 255)
    predictor = DetectionPredictor(model, conf=0.25, iou=0.7, max_det=300, max_nms=1024,
                                   device="cuda")
    out_dtypes, coord_dtypes, la_checks = [], [], {}
    hooks = [m.register_forward_hook(lambda _m, _i, o: out_dtypes.append(o.dtype))
             for m in model.modules()
             if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear, DySample))
             and next(m.parameters()).dtype == torch.bfloat16]
    sample_points, kernel = DySample.sample_points, edgeline.linear_attention

    def recorded_points(self, x):
        sy, sx = sample_points(self, x)
        coord_dtypes.extend((sy.dtype, sx.dtype))
        return sy, sx

    def checked_attention(q, k, v):
        y = kernel(q, k, v)
        ref = la.linear_attention_reference(q, k, v)
        la_checks[tuple(q.shape), str(q.dtype).removeprefix("torch.")] = (
            (y.float() - ref.float()).abs().max().item(),
            LA_RTOL[str(q.dtype).removeprefix("torch.")] * ref.float().abs().max().item())
        return y

    la.linear_attention_kernel.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(DySample, "sample_points", recorded_points), \
            mock.patch.object(edgeline, "linear_attention", checked_attention):
        predictor(imgs)
        torch.cuda.synchronize()
    for hk in hooks:
        hk.remove()
    print(f"serve registry graph: warm-up request {(time.perf_counter() - t0) * 1e3:.3f} ms, "
          f"{la.linear_attention_kernel.launches} kernel launches", flush=True)
    if not out_dtypes or any(dt != torch.bfloat16 for dt in out_dtypes):
        raise AssertionError(f"registry graph: conv and linear activations are not all bf16: "
                             f"{set(out_dtypes)}")
    if not coord_dtypes or any(dt != torch.float32 for dt in coord_dtypes):
        raise AssertionError(f"registry graph: DySample's coordinates are not f32: "
                             f"{set(coord_dtypes)}")
    print(f"serve registry graph: bf16 check: {len(out_dtypes)} conv, linear and DySample "
          f"outputs, all bf16; DySample's sampling coordinates f32 ({len(coord_dtypes)} "
          f"tensors)", flush=True)
    for (shape, dt), (err, tol) in sorted(la_checks.items()):
        print(f"serve registry graph: linear_attention {shape} {dt} on the path: max_abs_err "
              f"{err:.3e} against the plain version on the same inputs (tol {tol:.3e})",
              flush=True)
    if set(la_checks) != REGISTRY_LA_SHAPES or any(e > t for e, t in la_checks.values()):
        raise AssertionError(f"registry graph: kernel shapes {sorted(la_checks)} (want "
                             f"{sorted(REGISTRY_LA_SHAPES)}) or a shape disagrees with the plain "
                             f"version")

    torch.cuda.reset_peak_memory_stats()
    la.linear_attention_kernel.launches = 0
    times = []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        det, n = predictor(imgs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = la.linear_attention_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != SERVE_REQUESTS * n_attn:
        raise AssertionError(f"registry graph: {launches} kernel launches in {SERVE_REQUESTS} "
                             f"requests, {n_attn} LinearAttention modules")
    ms = statistics.median(times) * 1e3
    print(f"serve registry graph: batch {SERVE_BATCH} x {SERVE_IMGSZ} px bf16, request times "
          f"{[round(t * 1e3, 3) for t in times]} ms, median {ms:.3f} ms, "
          f"{SERVE_BATCH / ms * 1e3:.1f} img/s, {launches // SERVE_REQUESTS} kernel launches per "
          f"request, peak memory {peak / 2**30:.3f} GiB (max_memory_allocated), on {card}",
          flush=True)
    det, n = det.cpu(), n.cpu()
    if not (det.shape == (SERVE_BATCH, 300, 6) and bool(torch.isfinite(det).all())
            and bool(((n >= 0) & (n <= 300)).all()) and int(n.sum()) > 0):
        raise AssertionError("registry graph: served detections are malformed or empty")
    print(f"serve registry graph: detections per image min {int(n.min())}, max {int(n.max())}; "
          f"attention outputs on the path up to "
          f"{max(t for _, t in la_checks.values()) / LA_RTOL['bfloat16']:.3e} in magnitude",
          flush=True)
    profile_request(predictor, imgs, ms)
    return launches // SERVE_REQUESTS


def matched_gaps(det_a, n_a, det_b, n_b) -> dict:
    """Detections of a matched to b's of the same class and image at IoU >= 0.5
    (each a row's best): the share matched, and the box and score gaps."""
    import torch

    from edgeyolo_tpu_torch.ops.boxes import box_iou

    box, score, matched, total = [], [], 0, 0
    for i in range(det_a.shape[0]):
        a, b = det_a[i, :int(n_a[i])], det_b[i, :int(n_b[i])]
        total += len(a)
        if not len(a) or not len(b):
            continue
        iou = box_iou(a[:, :4], b[:, :4]) * (a[:, None, 5] == b[None, :, 5])
        best, j = iou.max(dim=1)
        ok = best >= 0.5
        matched += int(ok.sum())
        box.append((a[ok, :4] - b[j[ok], :4]).abs().amax(dim=1))
        score.append((a[ok, 4] - b[j[ok], 4]).abs())
    box = torch.cat(box) if box else torch.zeros(0)
    score = torch.cat(score) if score else torch.zeros(0)
    return {"total": total, "matched": matched,
            "box_max": box.max().item() if len(box) else float("nan"),
            "box_mean": box.mean().item() if len(box) else float("nan"),
            "score_max": score.max().item() if len(score) else float("nan"),
            "score_mean": score.mean().item() if len(score) else float("nan")}


def serve_fused(la, card: str) -> dict:
    """YOLO("edgeline-yolo.yaml").fuse() served at SERVE_BATCH x SERVE_IMGSZ in
    bf16 against the same model unfused, on the same batch, requests in turns:
    gates open, class biases at 0 and BatchNorm statistics of 8 of the images
    (so the fold moves real statistics). A reading: each side's request ms,
    the matched detections' box and score gaps, the dense pred's gaps beside
    the unfused bf16 model's own gaps to f32, and the BatchNorm kernels of one
    profiled request of each."""
    import torch

    from edgeyolo_tpu_torch.engine.model import YOLO
    from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor
    from edgeyolo_tpu_torch.nn.tasks import for_precision

    imgs = torch.randint(0, 256, (SERVE_BATCH, SERVE_IMGSZ, SERVE_IMGSZ, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    x8 = imgs[:8].cuda().permute(0, 3, 1, 2).contiguous().float() / 255
    y = YOLO("edgeline-yolo.yaml", device="cuda")
    bn_statistics_of(exercise_branches(y.model), x8)
    sides = {"unfused": for_precision(y.model, True)}
    with torch.inference_mode():
        dense32 = y.model(x8)["pred"].float()
    y.fuse()
    sides["fused"] = for_precision(y.model, True)
    print(f"fused flagship: {len(y.model.fused_bns)} BatchNorms folded into their convs in f32, "
          f"then the bf16 copy", flush=True)
    predictors = {k: DetectionPredictor(m, conf=0.25, iou=0.7, max_det=300, max_nms=1024,
                                        device="cuda") for k, m in sides.items()}
    out, times = {}, {k: [] for k in sides}
    for p in predictors.values():  # warm-up
        p(imgs)
    torch.cuda.synchronize()
    la.linear_attention_kernel.launches = 0
    for r in range(SERVE_REQUESTS):
        for k in (("unfused", "fused") if r % 2 == 0 else ("fused", "unfused")):
            t0 = time.perf_counter()
            out[k] = predictors[k](imgs)
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    launches = la.linear_attention_kernel.launches
    if launches != 2 * SERVE_REQUESTS:
        raise AssertionError(f"fused flagship: {launches} kernel launches in "
                             f"{2 * SERVE_REQUESTS} requests")
    gaps = matched_gaps(*(t.cpu() for t in out["fused"]), *(t.cpu() for t in out["unfused"]))
    with torch.inference_mode():
        dense = {k: m(x8.to(torch.bfloat16))["pred"].float() for k, m in sides.items()}
    d = (dense["fused"] - dense["unfused"]).abs()
    d16 = (dense["unfused"] - dense32).abs()  # the yardstick: bf16 serving's own departure
    bn = {}
    for k, p in predictors.items():
        rows = []
        profile_request(p, imgs, statistics.median(times[k]), rows_out=rows)
        bn[k] = sum(c for key, _, c in rows if any(w in key.lower() for w in BN_KERNEL_WORDS))
    ms = {k: statistics.median(v) for k, v in times.items()}
    print(f"fused flagship: batch {SERVE_BATCH} x {SERVE_IMGSZ} px bf16, request ms in turns: "
          f"unfused {[round(t, 3) for t in times['unfused']]} (median {ms['unfused']:.3f}), "
          f"fused {[round(t, 3) for t in times['fused']]} (median {ms['fused']:.3f}), on {card}",
          flush=True)
    print(f"fused flagship: detections fused {gaps['total']}, matched to the unfused ones "
          f"(same class, IoU >= 0.5) {gaps['matched']}; matched gaps box max "
          f"{gaps['box_max']:.3e} px (mean {gaps['box_mean']:.3e}), score max "
          f"{gaps['score_max']:.3e} (mean {gaps['score_mean']:.3e}); dense pred of 8 images: "
          f"box max {d[..., :4].max().item():.3e} px (mean {d[..., :4].mean().item():.3e}), "
          f"score max {d[..., 4:].max().item():.3e} (mean {d[..., 4:].mean().item():.3e}); "
          f"beside unfused bf16 against f32: box max {d16[..., :4].max().item():.3e} px (mean "
          f"{d16[..., :4].mean().item():.3e}), score max {d16[..., 4:].max().item():.3e} (mean "
          f"{d16[..., 4:].mean().item():.3e})", flush=True)
    print(f"fused flagship: BatchNorm device kernels in one profiled request: unfused "
          f"{bn['unfused']}, fused {bn['fused']}", flush=True)
    if not (gaps["total"] > 0 and bool(torch.isfinite(d).all())):
        raise AssertionError("fused flagship: no detections or a non-finite prediction")
    return {"launches": launches // (2 * SERVE_REQUESTS), "ms": ms, "bn_kernels": bn,
            "gaps": gaps}


def embed_check(la, card: str) -> dict:
    """YOLO.embed of len(EMBED_IMAGES) images (random pixels of mixed sizes,
    letterboxed to EMBED_IMGSZ) on the card in f32, the first EMBED_CPU_IMAGES
    of them against the CPU: the flagship at
    its default tap and at [10, 22] (layer 10 carries the kernel), the registry
    graph at [13, 27]; gates open. Each vector within EMBED_TOL of its largest
    magnitude. Gates open and BatchNorm statistics of 8 of the images.
    Returns the kernel's launches per image of each."""
    import numpy as np
    import torch

    from edgeyolo_tpu_torch.engine.model import YOLO

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_registry_spec import write_yaml

    from edgeyolo_tpu_torch.data.letterbox import letterbox_batch

    rs = np.random.RandomState(4)
    images = [rs.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in EMBED_IMAGES]
    # BatchNorm statistics of 8 of them (at init deep features hardly depend on the image)
    calib = torch.from_numpy(letterbox_batch(images[:8], EMBED_IMGSZ)[0]).cuda()
    calib = calib.permute(0, 3, 1, 2).float() / 255
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_embed_") as tmp:
        graph = str(write_yaml(Path(tmp) / "registry-graph.yaml"))
        for label, source, taps in (("flagship default tap", "edgeline-yolo.yaml", None),
                                    ("flagship [10, 22]", "edgeline-yolo.yaml", [10, 22]),
                                    ("registry graph [13, 27]", graph, [13, 27])):
            on_card = YOLO(source, device="cuda")
            bn_statistics_of(exercise_branches(on_card.model), calib)
            on_cpu = YOLO(source, device="cpu")
            on_cpu.model.load_state_dict(on_card.model.state_dict())
            kw = {"imgsz": EMBED_IMGSZ} if taps is None else {"imgsz": EMBED_IMGSZ, "embed": taps}
            la.linear_attention_kernel.launches = 0
            t0 = time.perf_counter()
            got = on_card.embed(images, **kw)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            launches[label] = la.linear_attention_kernel.launches / len(images)
            t0 = time.perf_counter()
            want = on_cpu.embed(images[:EMBED_CPU_IMAGES], **kw)
            t_cpu = time.perf_counter() - t0
            rel = max(((g.cpu() - w).abs().max() / w.abs().max()).item()
                      for g, w in zip(got, want))
            spread = (want[0] - want[1]).abs().max().item()
            print(f"embed {label}: {len(images)} images at {EMBED_IMGSZ} px, vectors of "
                  f"{got[0].numel()} f32; card {t_card:.3f} s ({launches[label]:g} kernel "
                  f"launches an image), CPU {t_cpu:.3f} s for the first {len(want)}; card vs CPU "
                  f"max {rel:.3e} of each vector's largest magnitude (tol {EMBED_TOL}); two "
                  f"images' vectors apart by "
                  f"up to {spread:.3e}", flush=True)
            if not (len(got) == len(images) and all(g.dtype == torch.float32 and g.is_cuda
                                                    for g in got) and rel <= EMBED_TOL):
                raise AssertionError(f"embed {label}: the card disagrees with the CPU")
            del on_card, on_cpu
    if not (launches["flagship [10, 22]"] == 1 and launches["registry graph [13, 27]"] == 2):
        raise AssertionError(f"embed: kernel launches an image {launches}")
    return launches


EXPORT = "edgeline-yolo"  # the flagship, exported as its fused f32 form
EXPORT_ONNX_IMGSZ = 160  # the numpy executor's size: ~1 s an image there
ONNX_TOL = {"atol": 5e-4, "rtol": 1e-3}  # JAX's own ONNX tolerance (tests/test_onnx.py)
EXPORT_ROUNDS = 4  # live, program, program, live, ...: requests of each side
BENCH = {"imgsz": 640, "batch": 8, "iters": 10, "formats": ["native", "torch_export", "npz"]}
BENCH_MAP_TOL = 1e-6


def export_flagship():
    """The exported model: the seeded flagship with its gates open and class
    logits at 0, f32 on the card, unfused (the exporter fuses a copy)."""
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel

    return exercise_branches(DetectionModel(f"{EXPORT}.yaml", device="cuda"))


def export_job(la, card: str, work: Path):
    """A fit job of its own (it runs beside the fits, in the fit phase): the
    flagship exported to a .pt2 at SERVE_IMGSZ with a symbolic batch, into
    WORK/export/pt2, and to ONNX at EXPORT_ONNX_IMGSZ, into WORK/export/onnx;
    the export seconds (taken beside the fits) in its log."""
    from edgeyolo_tpu_torch.cfg import get_cfg
    from edgeyolo_tpu_torch.export.exporter import Exporter

    n0 = la.linear_attention_kernel.launches
    model = export_flagship()
    for fmt, imgsz in (("torch_export", SERVE_IMGSZ), ("onnx", EXPORT_ONNX_IMGSZ)):
        ex = Exporter(get_cfg(overrides={"mode": "export", "format": fmt, "imgsz": imgsz}))
        path = ex(model, out_dir=work / ("pt2" if fmt == "torch_export" else fmt))
        print(f"export: {path} ({Path(path).stat().st_size} bytes) in {ex.seconds:.3f} s, beside "
              f"the fits", flush=True)
    launches = la.linear_attention_kernel.launches - n0
    print(f"export: kernel launches while tracing {launches}", flush=True)
    return {"trace": launches}, None


def serve_pt2(work: str, card: str) -> int:
    """`chip_smoke.py --serve-pt2 WORK CARD`, a fresh process that imports only
    edgeyolo_tpu_torch: the .pt2 of export_job through AutoBackend, and the
    same flagship live (fused f32), each serving SERVE_BATCH x SERVE_IMGSZ
    uint8 requests (upload, /255, forward, NMS) in turns; the program's pred
    held against the live one at FUSED_F32_TOL, its kernel launches counted
    per request. Writes WORK/serve_pt2.json."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from edgeyolo_tpu_torch.nn.autobackend import AutoBackend
    from edgeyolo_tpu_torch.ops import linear_attention as la
    from edgeyolo_tpu_torch.ops.nms import non_max_suppression

    work = Path(work)
    t0 = time.perf_counter()
    program = AutoBackend(work / "pt2" / f"{EXPORT}.pt2", device="cuda")
    load_s = time.perf_counter() - t0
    live = export_flagship().fuse().eval()
    ops = sorted({str(n.target) for n in program._program.graph.nodes
                  if "edgeyolo_tpu_torch" in str(n.target)})
    imgs = torch.randint(0, 256, (SERVE_BATCH, SERVE_IMGSZ, SERVE_IMGSZ, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(3))

    def request(fn):
        with torch.inference_mode():
            x = imgs.cuda().permute(0, 3, 1, 2).float() / 255
            pred = fn(x)
            return pred, non_max_suppression(pred, conf_thres=0.25, iou_thres=0.7, max_det=300,
                                             max_nms=1024)

    sides = {"live": lambda x: live(x)["pred"], "program": program}
    out = {k: request(f) for k, f in sides.items()}  # warm-up
    torch.cuda.synchronize()
    times, launches = {k: [] for k in sides}, 0
    for r in range(EXPORT_ROUNDS):
        for k in (("live", "program") if r % 2 == 0 else ("program", "live")):
            n0 = la.linear_attention_kernel.launches
            t = time.perf_counter()
            out[k] = request(sides[k])
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t) * 1e3)
            if k == "program":
                launches += la.linear_attention_kernel.launches - n0
    a, b = out["program"][0], out["live"][0]
    box_gap = ((a[..., :4] - b[..., :4]).abs().max() / b[..., :4].abs().max()).item()
    score_gap = (a[..., 4:] - b[..., 4:]).abs().max().item()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "edgeyolo_tpu"))
    res = {"load_s": load_s, "ops": ops, "launches_per_request": launches / EXPORT_ROUNDS,
           "ms": {k: statistics.median(v) for k, v in times.items()}, "times": times,
           "box_gap": box_gap, "score_gap": score_gap,
           "detections": [int(out[k][1][1].sum()) for k in ("program", "live")],
           "shape": list(a.shape), "foreign_modules": foreign}
    (work / "serve_pt2.json").write_text(json.dumps(res))
    print(json.dumps(res), flush=True)
    return 0


def export_phase(la, card: str, work: Path) -> dict:
    """The export path on the card: (a) the .pt2 of export_job served from a
    fresh process (serve_pt2): the program launches the attention kernel at
    least once a request and its pred is within FUSED_F32_TOL of the live fused
    f32 model's; (b) npz: exported and reloaded through AutoBackend, every
    tensor and the pred equal to the bit; (c) the flagship's ONNX of export_job
    (EXPORT_ONNX_IMGSZ) through the port's numpy executor against the card's
    f32 forward at ONNX_TOL; (d) the registered op's host dispatch: host ms a call
    of `linear_attention` (the op) and of the kernel's wrapper directly, at the
    serving shape."""
    import numpy as np
    import torch

    from edgeyolo_tpu_torch.cfg import get_cfg
    from edgeyolo_tpu_torch.export.exporter import Exporter
    from edgeyolo_tpu_torch.export.onnx_runtime import OnnxModel
    from edgeyolo_tpu_torch.nn.autobackend import AutoBackend

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--serve-pt2", str(work),
                           card], capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="", flush=True)
    if proc.returncode:
        print(proc.stderr[-4000:], flush=True)
        raise AssertionError(f"export: the .pt2 process failed (exit code {proc.returncode})")
    res = json.loads((work / "serve_pt2.json").read_text())
    print(f"export: .pt2 served from a fresh process in {time.perf_counter() - t0:.3f} s (load "
          f"{res['load_s']:.3f} s): {res['launches_per_request']} kernel launches a request inside "
          f"the program (ops {res['ops']}); request ms in turns, batch {SERVE_BATCH} x "
          f"{SERVE_IMGSZ} f32: live fused {res['ms']['live']:.3f}, program "
          f"{res['ms']['program']:.3f} ({res['times']}); pred gap box {res['box_gap']:.3e} of the "
          f"box scale, score {res['score_gap']:.3e} (tol {FUSED_F32_TOL}); detections "
          f"{res['detections']}; on {card}", flush=True)
    if not (res["launches_per_request"] >= 1 and res["box_gap"] <= FUSED_F32_TOL
            and res["score_gap"] <= FUSED_F32_TOL and not res["foreign_modules"]
            and res["ops"] == ["edgeyolo_tpu_torch.linear_attention.default"]):
        raise AssertionError(f"export: the .pt2 failed its checks: {res}")

    model = export_flagship()
    fused = copy.deepcopy(model).fuse().eval()
    ex = Exporter(get_cfg(overrides={"mode": "export", "format": "npz", "imgsz": SERVE_IMGSZ}))
    npz = AutoBackend(ex(model, out_dir=work / "npz"), device="cuda")
    want, got = fused.state_dict(), npz.model.state_dict()
    x = torch.rand(4, 3, SERVE_IMGSZ, SERVE_IMGSZ, generator=torch.Generator().manual_seed(4)).cuda()
    with torch.inference_mode():
        same = torch.equal(npz(x), fused(x)["pred"])
    if not (set(want) == set(got) and all(torch.equal(want[k], got[k]) for k in want) and same):
        raise AssertionError("export: the npz did not round-trip to the bit")
    print(f"export: npz in {ex.seconds:.3f} s, {len(want)} tensors equal to the bit, pred of 4 "
          f"images equal to the bit: {same}", flush=True)

    path = work / "onnx" / f"{EXPORT}.onnx"
    onnx = OnnxModel(path.read_bytes())
    xs = x[:1, :, :EXPORT_ONNX_IMGSZ, :EXPORT_ONNX_IMGSZ].contiguous()
    t = time.perf_counter()
    got = onnx(xs.cpu().numpy())
    run_s = time.perf_counter() - t
    with torch.inference_mode():
        want = fused(xs)["pred"].cpu().numpy()
    gap = float(np.abs(got - want).max())
    print(f"export: onnx ({len(onnx.m['nodes'])} nodes, exported by the job): the numpy executor "
          f"{run_s:.3f} s for 1 x {EXPORT_ONNX_IMGSZ} px on the host; against the card's f32 forward max |gap| {gap:.3e} (box scale "
          f"{np.abs(want[..., :4]).max():.1f}; tol {ONNX_TOL})", flush=True)
    np.testing.assert_allclose(got, want, **ONNX_TOL)

    q, k, v = la_inputs(SERVE_BATCH, 400, 2, 64, torch.bfloat16, "qkv",
                        torch.Generator(device="cuda").manual_seed(5))
    dispatch = {}
    for mode in ("grad", "inference"):
        with torch.inference_mode(mode == "inference"):
            op_ms = host_ms(lambda: la.linear_attention(q, k, v))
            direct_ms = host_ms(lambda: la.linear_attention_kernel(q, k, v))
        dispatch[mode] = (op_ms - direct_ms) * 1e3
        print(f"export: host ms a call at ({SERVE_BATCH}, 400, 2, 64) bf16 ({mode} mode): the "
              f"registered op {op_ms:.4f}, the wrapper directly {direct_ms:.4f}: dispatch "
              f"{dispatch[mode]:.1f} us a launch", flush=True)
    return {"launches_per_request": res["launches_per_request"], "ms": res["ms"],
            "onnx_s": run_s, "dispatch_us": dispatch}


def benchmark_phase(la, card: str, best: Path, data: Path, work: Path) -> list[dict]:
    """YOLO.benchmark of the fit phase's flagship on the card at BENCH's size over
    native, torch_export and npz, validated on the fit's val images: every row
    ok, their mAP50-95 equal within BENCH_MAP_TOL; each export's seconds."""
    from edgeyolo_tpu_torch.engine.model import YOLO
    from edgeyolo_tpu_torch.export import exporter

    seconds = {}
    call = exporter.Exporter.__call__

    def timed(self, model, out_dir="runs/export"):
        t = time.perf_counter()
        out = call(self, model, out_dir=out_dir)
        seconds[self.args.format] = time.perf_counter() - t
        return out

    n0 = la.linear_attention_kernel.launches
    with mock.patch.object(exporter.Exporter, "__call__", timed):
        rows = YOLO(best, device="cuda").benchmark(data=str(data), out_dir=str(work / "bench"),
                                                   verbose=False, **BENCH)
    launches = la.linear_attention_kernel.launches - n0
    for r in rows:
        print(f"benchmark: {json.dumps(r)}", flush=True)
    print(f"benchmark: export seconds {seconds}; {launches} kernel launches in the table; "
          f"{BENCH}; on {card}", flush=True)
    maps = [r.get("mAP50-95") for r in rows]
    if not (all(r["status"] == "ok" for r in rows) and all(isinstance(m, float) for m in maps)
            and max(maps) - min(maps) <= BENCH_MAP_TOL and maps[0] > 0 and launches > 0):
        raise AssertionError(f"benchmark: rows {rows}")
    return rows


FIT_JOBS = {  # name: the fit, longest first (their seconds alone on an H100)
    RTDETR_FIT: fit_rtdetr,
    "yolov13-test": lambda la, card, work: fit(la, card, work, "yolov13-test.yaml",
                                               V13_TEST_FIT_MAP_MIN, V13_TEST_FIT_IMGSZ),
    "edgeline-yolo": lambda la, card, work: fit(la, card, work),
    SEG: lambda la, card, work: fit(
        la, card, work, f"{SEG}.yaml", SEG_FIT_BOX_MIN,
        extra_mins={"metrics/mAP50-95(M)": SEG_FIT_MASK_MIN},
        jax_maps={"metrics/mAP50-95(B)": SEG_JAX_BOX_MAP, "metrics/mAP50-95(M)": SEG_JAX_MASK_MAP}),
    "yolov10n": lambda la, card, work: fit(la, card, work, "yolov10n.yaml", V10_FIT_MAP_MIN),
    "yolo11n": lambda la, card, work: fit(la, card, work, "yolo11n.yaml", YOLO11N_FIT_MAP_MIN),
    CLS: lambda la, card, work: (fit_classify(la, card, work), None),
    POSE: lambda la, card, work: fit(
        la, card, work, f"{POSE}.yaml", POSE_FIT_BOX_MIN,
        extra_mins={"metrics/mAP50-95(P)": POSE_FIT_POSE_MIN},
        jax_maps={"metrics/mAP50-95(B)": POSE_JAX_BOX_MAP,
                  "metrics/mAP50-95(P)": POSE_JAX_POSE_MAP}, epochs=POSE_OBB_FIT_EPOCHS),
    OBB: lambda la, card, work: fit(la, card, work, f"{OBB}.yaml", OBB_FIT_MIN, extra_mins={},
                                    jax_maps={"metrics/mAP50-95(B)": OBB_JAX_MAP},
                                    epochs=POSE_OBB_FIT_EPOCHS),
    f"{RTDETR_FIT}-repeat": repeat_rtdetr,
    "export": export_job,
}


def fit_worker(name: str, work: str, card: str) -> int:
    """One fit of FIT_JOBS in this process (`chip_smoke.py --fit NAME WORK CARD`),
    its data and runs under WORK/NAME; writes its launches and best.pt to
    WORK/NAME.json."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(FIT_THREADS)
    from edgeyolo_tpu_torch.ops import linear_attention as la  # the parent's build, loaded

    launches, best = FIT_JOBS[name](la, card, Path(work) / name)
    (Path(work) / f"{name}.json").write_text(json.dumps(
        {"launches": launches, "best": None if best is None else str(best)}))
    return 0


def run_fits(card: str, work: Path) -> dict:
    """Every fit of FIT_JOBS, FIT_PROCS at once, each in a process of its own
    (fit_worker). A fit's output is printed whole when it ends; a fit that fails
    or outlasts FIT_TIMEOUT fails the phase, and every fit still running is
    killed. Returns each fit's launches and best.pt."""
    pending, running, results = list(FIT_JOBS), {}, {}
    t_start = time.perf_counter()
    try:
        while pending or running:
            while pending and len(running) < FIT_PROCS:
                name = pending.pop(0)
                log = open(work / f"{name}.log", "w+")
                proc = subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--fit", name, str(work), card],
                    stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
                running[name] = (proc, log, time.perf_counter())
            time.sleep(0.2)
            for name, (proc, log, t0) in list(running.items()):
                if proc.poll() is None:
                    if time.perf_counter() - t0 > FIT_TIMEOUT:
                        raise TimeoutError(f"fit {name}: still running after {FIT_TIMEOUT} s")
                    continue
                del running[name]
                log.seek(0)
                print(log.read(), end="", flush=True)
                log.close()
                print(f"fit {name}: its process took {time.perf_counter() - t0:.3f} s, started "
                      f"at +{t0 - t_start:.3f} s of the phase, exit code {proc.returncode}",
                      flush=True)
                if proc.returncode:
                    raise AssertionError(f"fit {name} failed (exit code {proc.returncode})")
                results[name] = json.loads((work / f"{name}.json").read_text())
    finally:
        for proc, log, _ in running.values():
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            log.close()
    print(f"fits: {len(results)} in {time.perf_counter() - t_start:.3f} s, {FIT_PROCS} at once",
          flush=True)
    return results


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
    print(f"build wall time: {time.perf_counter() - t0:.3f} s for {sorted(libs)}; each source "
          f"(all compilers at once): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(_build.build_seconds.items())),
          flush=True)
    done("build", t0)

    t0 = phase("kernels")
    la_rows, la_inputs_by_case = check_kernels(la)
    done("kernels", t0)

    t0 = phase("reference")
    ref_launches = check_reference(la)
    done("reference", t0)

    t0 = phase("serve")
    launches, _ = serve(la, card)
    family_launches = {name: serve_family(la, card, name) for name in FAMILY_SERVE}
    done("serve", t0)

    t0 = phase("train reference")
    ref_train_launches = check_train_reference(la)
    done("train reference", t0)

    t0 = phase("train")
    train_launches = train(la, card)
    msla_train_launches = train(la, card, MSLA)
    train(la, card, "yolo11n")
    v13_train_launches = train(la, card, V13_TEST)
    lgl_train_launches = train(la, card, LGL)
    train(la, card, V10)
    train(la, card, V12)
    done("train", t0)

    from edgeyolo_tpu_torch.engine.model import YOLO

    t0 = phase("fit")
    check_tiled_nms()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as work:
        fits = run_fits(card, Path(work))
        fit_launches = fits["edgeline-yolo"]["launches"]
        best = Path(fits["edgeline-yolo"]["best"])
        v13_fit_launches = fits["yolov13-test"]["launches"]
        seg_fit_launches = fits[SEG]["launches"]
        cls_fit_launches = fits[CLS]["launches"]
        # the flagship at full width, alone on the card
        val640(la, YOLO(best, device="cuda"), card, Path(work) / "edgeline-yolo")
        done("fit", t0)

        t0 = phase("jpeg")
        jpeg_launches = jpeg(la, card, Path(work) / "edgeline-yolo", best)
        done("jpeg", t0)

        t0 = phase("video")
        video_launches = video(la, card, Path(work) / "video", best)
        done("video", t0)

        t0 = phase("segment reference")
        seg_ref_launches = seg_reference(la)
        done("segment reference", t0)

        t0 = phase("segment serve")
        for name in SEG_SERVE:
            serve_segment(la, card, name)
        done("segment serve", t0)

        t0 = phase("segment train reference")
        check_seg_train_reference(la)
        done("segment train reference", t0)

        t0 = phase("segment train")
        seg_train_launches = train(la, card, SEG)
        train(la, card, SEG, copy_paste=0.5)
        done("segment train", t0)

        t0 = phase("pose/obb reference")
        pose_obb_reference(la)
        check_rotated_nms()
        done("pose/obb reference", t0)

        t0 = phase("pose/obb serve")
        for name in POSE_OBB_SERVE:
            serve_pose_obb(la, card, name)
        done("pose/obb serve", t0)

        t0 = phase("pose/obb train reference")
        check_pose_obb_train_reference(la)
        done("pose/obb train reference", t0)

        t0 = phase("pose/obb train")
        for name, shape in POSE_OBB_TRAIN.items():
            if train(la, card, name, shape=shape):
                raise AssertionError(f"{name}: attention kernel launches in a model without one")
        done("pose/obb train", t0)

        t0 = phase("classify reference")
        cls_launches = {"reference": classify_reference(la)}
        done("classify reference", t0)

        t0 = phase("classify serve")
        for name in CLS_SERVE:
            served = serve_classify(la, card, name)
        classify_jpeg_request(la, card, served["predictor"], Path(work))
        cls_launches["serve"] = la.linear_attention_kernel.launches
        done("classify serve", t0)

        t0 = phase("classify train reference")
        check_classify_train_reference(la)
        done("classify train reference", t0)

        t0 = phase("classify train")
        cls_launches["train"] = train_classify(la, card)
        cls_launches.update({f"fit_{k}": v for k, v in cls_fit_launches.items()})
        print(f"classify: attention kernel launches {cls_launches} (no cls model has one)",
              flush=True)
        done("classify train", t0)

        t0 = phase("rtdetr reference")
        rt_launches = {"reference": rtdetr_reference(la)}
        done("rtdetr reference", t0)

        t0 = phase("rtdetr serve")
        rt_launches["serve"] = sum(serve_rtdetr(la, card, name) for name in RTDETR_SERVE)
        done("rtdetr serve", t0)

        t0 = phase("rtdetr train reference")
        rt_launches["train_reference"] = check_rtdetr_train_reference(la)
        done("rtdetr train reference", t0)

        t0 = phase("rtdetr train")
        rt_launches["train"] = train(la, card, RTDETR_TRAIN[0], shape=RTDETR_TRAIN[1])
        rt_launches.update({f"fit_{k}": v for k, v in fits[RTDETR_FIT]["launches"].items()})
        rt_launches.update(fits[f"{RTDETR_FIT}-repeat"]["launches"])
        print(f"rtdetr: attention kernel launches {rt_launches} (no RT-DETR model has one)",
              flush=True)
        if any(rt_launches.values()):
            raise AssertionError("the attention kernel launched in an RT-DETR model")
        done("rtdetr train", t0)

        t0 = phase("export")
        export = export_phase(la, card, Path(work) / "export")
        done("export", t0)

        t0 = phase("benchmark")
        benchmark_phase(la, card, best, Path(work) / "edgeline-yolo" / "fit" / "dataset.yaml",
                        Path(work) / "export")
        done("benchmark", t0)

    t0 = phase("registry reference")
    registry_launches = {"reference": registry_reference(la)}
    done("registry reference", t0)

    t0 = phase("registry serve")
    registry_launches["serve"] = serve_registry(la, card)
    fused = serve_fused(la, card)
    registry_launches["fused_flagship"] = fused["launches"]
    done("registry serve", t0)

    t0 = phase("registry embed")
    registry_launches.update({f"embed_{k.replace(' ', '_')}": v
                              for k, v in embed_check(la, card).items()})
    print(f"registry: attention kernel launches {registry_launches}", flush=True)
    done("registry embed", t0)

    t0 = phase("device times")
    device_times(la, la_rows, la_inputs_by_case)
    done("device times", t0)

    kernels = [{"name": "linear_attention", "route": "cuda",
                "source": "edgeyolo_tpu_torch/csrc/linear_attention.cu",
                "replaces": "edgeyolo_tpu/ops/pallas/linear_attention.py:25",
                "launches": launches, "launches_train": train_launches,
                **{f"launches_fit_{k}": v for k, v in fit_launches.items()},
                **{f"launches_jpeg_{k}": v for k, v in jpeg_launches.items()},
                "launches_yolo11_lineattention": family_launches["yolo11-lineattention-n"],
                "launches_yolo11n": family_launches["yolo11n"],
                "launches_msla": family_launches[MSLA],
                "launches_msla_train": msla_train_launches // TRAIN_STEPS,
                "launches_msla_train_reference": ref_train_launches[MSLA],
                "launches_yolov13_test": family_launches[V13_TEST],
                "launches_yolov13_test_train": v13_train_launches // TRAIN_STEPS,
                "launches_yolov13_test_train_reference": ref_train_launches[V13_TEST],
                **{f"launches_fit_yolov13_test_{k}": v for k, v in v13_fit_launches.items()},
                "launches_lgl": family_launches[LGL],
                "launches_yolo11_test": family_launches["yolo11-test-n"],
                "launches_yolo11_tune": family_launches["yolo11-tune-n"],
                "launches_lgl_train": lgl_train_launches // TRAIN_STEPS,
                "launches_reference_64px": ref_launches,
                "launches_tta": video_launches["tta"],
                "launches_track": video_launches["track_bytetrack"],
                **{f"launches_video_{k}": v for k, v in video_launches.items()},
                "launches_segment_v9_reference": sum(seg_ref_launches.values()),
                "launches_segment_train": seg_train_launches,
                **{f"launches_fit_segment_{k}": v for k, v in seg_fit_launches.items()},
                **{f"launches_classify_{k}": v for k, v in cls_launches.items()},
                **{f"launches_rtdetr_{k}": v for k, v in rt_launches.items()},
                **{f"launches_registry_{k}": v for k, v in registry_launches.items()},
                "fused_flagship": fused,
                "launches_export_pt2": export["launches_per_request"],
                "export_pt2_ms": export["ms"], "export_onnx_executor_s": export["onnx_s"],
                "op_dispatch_us": export["dispatch_us"],
                **la_rows[LA_MAIN_CASE], "library_ms": None,
                "wavelet_rows": [{"shape": list(case[:4]), "dtype": case[4], **row}
                                 for case, row in zip(LA_CASES, la_rows)
                                 if case in WAVELET_CASES]}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fit"]:
        sys.exit(fit_worker(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--serve-pt2"]:
        sys.exit(serve_pt2(*sys.argv[2:4]))
    sys.exit(main())
