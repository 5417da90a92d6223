#!/usr/bin/env python3
"""Cold-start smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run it from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``i2vsgg_tpu_torch/csrc`` with nvcc
(RoIPool, the conv1 stem, RoIAlignAvg, the identity-bottleneck chain, the
int8 conv1; one nvcc each, in parallel), holds each kernel against its plain
PyTorch version, checks small programs on the card against the same programs
on the CPU (f32; bf16 with bf16-stored weights and the chain; the int8
levers; the VGG16 and non-fused detectors), and serves the fused det+SGG
frame program (``i2vsgg_tpu_torch.serve``) at full width: ResNet-101 (and
in phase 12 VGG16) with ic+gc context, 16 classes, 26 predicates, 600x960
frames in bf16, rpn post-NMS 128 / pre-NMS 512, 8 detections with 8 per
class, with seeded random weights, along five paths:

* phase 5: f32 images and the SGG head on RoIPool (the first slice's path);
* phase 6, the second slice's path: a 12-frame synthetic video in 3
  requests, fed as conv1 parity planes packed on the host
  (``--host_planes``), the SGG head under ``pooling="align"``; then the
  same program fed f32 images under ``I2VSGG_PALLAS_CONV1=1`` (bit-equal),
  the bucketed program with buckets (4, 8), Stage C (per-frame tuples and
  ``association``) over the video, the uint8 upload
  (``dequantize_image_u8``), and a bucket below ``max_det`` (phase 6f:
  weights that leave one foreground class, the SGG head under align and
  under pool, both RoI kernels at a smaller R);
* phase 9, the third slice's path: the same video with bf16-stored weights
  (``bf16_storage_cast``) and ``I2VSGG_PALLAS_BOTTLENECK=1``, so layer3's
  22-block identity tail runs as the chain kernel; then the same weights
  with the switch off, for agreement and time;
* phase 11, the fourth slice's path (the round-5 configuration, as
  ``bench.py --int8-fc6 --int8-trunk-scope 1:layer2,layer3,layer4,@3x3
  --int8-static-acts runs/calib/act_scales_res101.json`` builds it): the
  same video as f32 images (cuDNN's conv1) on phase 9's bf16-stored weights
  with the SGG head's fc6/fc7 in int8 and the 3x3 convs of layer2-4 in int8
  with the calibration file's static activation scales; then phase 9's
  weights on the same images, for agreement and time. Phase 11b holds the
  int8 conv1 kernel (B6, which no path dispatches, as in JAX) to its plain
  version on the path's own frames and on clamped and tied inputs, and
  times it by device time;
* phase 12, the eighth slice's paths: the same video as f32 images through
  the frame program and the bucketed program (buckets (4, 8)) of 12a a
  VGG16 detector (ic+gc, align/7, class-agnostic boxes; the SGG head on
  RoIPool over its 512 channels) and 12b a ResNet-101 detector on the
  non-fused path (``POOLING_MODE=pool``: RoIPool at the detector site, the
  stride-2 layer4 on 7x7 maps, netD_pixel's full pass; the SGG head under
  align, ``spatial_type=0``, no object visual branch). Each RoI call of a
  request is held to its plain version on its own inputs and timed; 12c
  runs both programs at 64x80 on the card and on the CPU;
* phase 13, the ninth slice's paths, the drivers a user runs
  (``python -m i2vsgg_tpu_torch.tools.serve_video`` / ``test_sgg`` /
  ``test_det``, called as ``main([...])``): 13a writes an MVidVRD devkit of
  2 videos x 6 PNG frames at 360x640 (``write_devkit``) and times the PNG
  decode by row filter; 13b saves seeded full-width weights with the port's
  ``save_checkpoint`` (~1.1 GiB) and serves the devkit three times (the
  default with the SGG head on RoIPool, ``--host_planes``, ``--buckets
  4,8``; frames padded to 608x1216), and a second devkit of 4:3 frames
  (608x896) with ``--bf16_weights`` under ``I2VSGG_PALLAS_BOTTLENECK=1``
  (the chain gate refuses the 16:9 frames' map), each request's outputs
  bit-equal to the frame program called in-process on the same loader
  batches (``cudnn.deterministic`` set) and ``frame_detections.json``
  equal to their tuples; on the last request of each run the kernels are
  held to their plain versions at the shapes the drivers gave them and
  timed beside their bounds (each RoI call, the conv1 stem on the served
  planes, each chain call); 13c runs ``test_sgg`` (GT boxes) and
  ``test_det``, whose files must parse; 13d runs ``serve_video`` and
  ``test_sgg`` at the tiny size of tests/test_drivers_e2e.py on the card
  and on the CPU (``TINY_TOL``);
* phase 14, the eleventh slice's path, Stage A training
  (``train/det_da.py::train_step``): 14a takes 4 steps at full width
  (res101 ic+gc+cr, bf16 compute with f32 params, one 600x1000 source frame
  with GT boxes and one target frame a step, RPN 12000/2000, target 128,
  128 rois, 256 anchors; the port's training inits) under
  ``POOLING_MODE=align``: each step launches RoIAlignAvg (B1) twice and no
  other kernel, the losses stay finite, only the trainable params move;
  every RoI call of the last step is held to its plain version at its
  inputs and timed beside its bound and the plain backward's device time;
  the proposals' share of the step is timed. 14b does the same under
  ``POOLING_MODE=pool`` (B2). 14c runs ``python -m
  i2vsgg_tpu_torch.tools.trainval_det_da`` on the paper's pairing (an MVRD
  devkit of JPEG stills as the source, ``write_mvrd_devkit``; the PNG
  frames of ``write_devkit`` as the target) for 3 steps, ``--r`` for 2
  more, and ``test_det`` on the checkpoint; 14d holds one
  tiny deterministic step (res10, f32) on the card to the CPU's
  (``TRAIN_TINY_TOL``);
* phase 15, the twelfth slice's path, Stage B training
  (``train/sgg.py::train_step``): 15a takes 4 steps at full width (the
  res101 trunk of 14c's last checkpoint through ``restore_sgg_init``, bf16
  and frozen; the head at fc 4096, emb 300, spatial_type 2, the object
  visual branch, 62 predicates; one seeded 600x1000 frame with 8 GT boxes
  and 20 relation triples, padded to 30 boxes and 64 pairs; dropout on)
  under ``vrd_pooling=pool``: each step launches RoIPool (B2) once and no
  other kernel, runs no RoI backward, the losses stay finite, the trunk is
  bit-unchanged and every head tensor moves; the last step's RoI call is
  held to its plain version and timed beside its bound. 15b does the same
  under ``align`` (B1). 15c runs ``python -m
  i2vsgg_tpu_torch.tools.trainval_sgg`` on 14c's MVRD stills from 14c's
  checkpoint for 3 steps and ``test_sgg`` on the checkpoint it wrote,
  which must read ``vrd_pooling`` from its metadata; 15d holds one tiny
  Stage B step (res10, f32, no dropout) on the card to the CPU's
  (``SGG_TINY_TOL``);
* phase 16, the thirteenth slice's path, JPEG decode (``csrc/jpeg.cc``
  through ``data/jpeg.py``, in the host library that phase 2 builds with
  the host compiler, no kernel): 16a, run before phase 14 (whose driver
  reads JPEG stills), holds every committed fixture of
  ``tests/data/jpeg`` bit-equal to its golden (cv2's decode, written as
  PNG; the progressive one too, read since the sixteenth slice, and the
  CMYK one, read since the nineteenth), and times the decode of the
  VRD-sized stills and a 360x640 frame beside the PNG decode of the same
  pixels; 16b, after phase 15, times the loader on
  14c's MVRD stills (decode + resize) and runs ``test_det`` on
  ``MVRD_test`` at full width from 14c's checkpoint;
* phase 17, the fourteenth slice's paths, data parallelism
  (``parallel/mesh.py``) on the one card: 17a runs 14c's
  ``trainval_det_da`` (3 steps, then ``--resume`` to 4) and 15c's
  ``trainval_sgg`` (3 steps) again, each in a process that ``python -m
  torch.distributed.run --standalone --nproc_per_node 1`` starts (NCCL,
  world size 1, ``--mesh 1``; this script's ``--rank-driver`` calls the
  driver's ``main`` and reads the rank's launch counters), step 1's losses
  held to 14c's and 15c's (``DP_STEP1_RTOL``) and the all-reduce of the
  last step's gradients timed; 17b runs 14d's and 15d's tiny steps on two
  gloo ranks on the card (``--gloo-rank``; NCCL refuses two ranks on one
  device) at batch 1 against this process at batch 2 (``updates_vs``),
  the two ranks building the RoI kernel they need at once, cold; 17c
  serves phase 6's and phase 5's models over two replicas on cuda:0
  (``serve.make_sharded_program``; host planes under align: B1, B3; f32
  images under pool: B2), each replica bit-equal to the unsharded program
  on its own rows and measured against it on the whole request, each
  replica's RoI and conv1 calls held to their plain versions, then
  ``serve_video --mesh 1`` against 13b's ``--mesh 0`` run and a ragged
  tail at ``--bs 4 --mesh 2`` against ``--bs 2 --mesh 0`` (tiny, f32),
  the files equal;
* phase 18, the fifteenth slice's path, the native batch loader
  (``i2vsgg_tpu_torch/runtime``: ``csrc/io_runtime.cc`` linked with
  ``csrc/jpeg.cc``, host C++ built with the host compiler in phase 2
  beside the nvcc builds; no kernel), which ``DetectionLoader`` and the
  ``--host_planes`` packer use by default: 18a holds ``decode_image`` on
  every committed JPEG fixture and PNG golden to ``imread_bgr`` (EXIF
  orientations left unapplied, as the JAX runtime leaves them); 18b runs
  ``load_batch`` on 13a's PNG frames and 14c's JPEG stills at scale 600 at
  1 and 8 threads, each image's decode equal to ``imread_bgr``'s (the
  Python path's own inflate for PNG), each
  image bit-equal to ``runtime.preprocess_plain`` (the JAX runtime's
  arithmetic in numpy), its scale and size equal to the Python path's,
  host ms a frame beside the Python path's decode and resize; 18c holds
  ``pack_planes`` at (4, 600, 960) and (4, 608, 1216) byte-equal to the
  torch packer, host ms of both in alternating blocks; 18d runs
  ``serve_video`` (default, and ``--host_planes`` where the packer feeds
  B3) on a 48-frame devkit, 12 requests a run, with the native loader and
  with ``I2VSGG_NATIVE_IO=0`` (under ``--host_planes`` the native loader's
  runs pack alternate requests with the native and the torch packer), the
  runs of each variant in alternating order and the first request of each
  run left out of the steady state,
  and ``test_det`` on the stills with each loader; launches counted,
  detection gaps reported;
* phase 19, the sixteenth slice's path, the decode formats added to both
  decoders (``csrc/jpeg.cc``: progressive and separate-scan JPEG through
  a coefficient buffer, block smoothing where a scan script stops short;
  ``csrc/io_runtime.cc`` and ``data/image_io.py``: PNG at every bit depth
  and Adam7): 19a holds every fixture of ``tests/data/decode`` on both
  paths to its golden (cv2's decode) and each progressive 360x640 frame to
  its baseline twin, and times host ms a frame of the progressive frames
  against their baseline twins and of 16-bit and Adam7 copies of 13a's
  frames (``png_frame``) against the 8-bit frames, the decode alone and
  ``load_batch`` at 1 and 8 threads; 19b runs ``serve_video`` (default:
  B1 at the detector, B2 at the SGG site) and ``test_det`` with 13b's
  checkpoints over two devkits of the same pictures, one in the new
  formats, one as baseline JPEG and 8-bit PNG (``twin_devkits``): the
  detections and ``rel_prob`` bit-equal;
* phase 20, the seventeenth slice's paths, the int8 trunk's calibration
  and quality gate: 20a runs ``python -m
  i2vsgg_tpu_torch.tools.calibrate_act_scales`` (as ``main([...])``) on
  14c's checkpoint and 8 of its MVRD stills (bf16, scale 600, ``--bs 4``):
  the committed res101 file's 103 keys, every scale finite, > 0 and equal
  to the input abs-max that a forward hook on each ``BNConv`` witnessed,
  / 127; 20b runs ``test_det`` on ``MVRD_test`` with that file under
  ``--int8_trunk mxu:<scope>`` and ``sim:<scope>`` in the order mxu, sim,
  sim, mxu (the int8 products in the mxu runs only), each sim run's
  detections held to the first mxu run's (``SIM_TOL``), images/s of each
  run; 20c runs ``quant_trunk_ab`` (the fp arm and an mxu arm), again with
  ``--reuse_fp``, and on a rewritten copy of the checkpoint, which
  ``--reuse_fp`` must refuse;
* phase 21, the eighteenth slice's paths, the serving gates on a model the
  port trains, in a work directory of its own: 21a
  ``tools/train_gate_arm.py`` writes its corpus (``tools/learnable_data.py``:
  300 stills at 240x320, 48 of them trainval, and 20 videos of 24 frames,
  PNG files, the stills under ``.jpg`` names) and trains the res101 arm
  (profile parity240, f32, 288 steps from the port's init with bn3 zeroed;
  every still padded into the loader's 608x608 canvas): the loss every 20
  steps, host ms a step, B1 2 a step, peak memory, the last step's B1 calls
  held to their plain version (rtol 1e-5) and timed; 21b ``capacity_ab
  --ckpt`` on it at ``GATE_ROWS`` (test_det's B1, the last image's calls
  held); 21c ``calibrate_act_scales`` and ``quant_trunk_ab --mode
  mxu:<scope>`` with those scales on MVRD and MVidVRD; 21d
  ``parity_run.train_ours_sgg`` at res101 for 672 steps (B2 once a step)
  and ``quant_ab --stage_c`` (B2 once a scorer call), the last call of each
  held (exact) and timed; each gate's verdict by ``bench.py``'s rules
  (``gate_verdicts``: VOID below 0.15, PASS within 0.01), printed and in the
  results JSON under ``gates``. A verdict never fails the phase; an arm
  that did not learn (the mean loss of its last 20 steps not below its
  first 20's, or the base capacity row at mAP 0) does;
* phase 22, the nineteenth slice's paths, the last modules of the port,
  run in phase 21's work directory before it goes: 22a holds every
  fixture of ``tests/data/decode``'s later sets on both decoders
  (``csrc/jpeg.cc``: arithmetic-coded SOF9/SOF10 with DAC conditioning,
  CMYK and YCCK, lossless SOF3; each to its golden, cv2's decode; the
  modes cv2 refuses raising ``UnsupportedImageError`` naming them) and the
  four arithmetic-coded 360x640 frames to their baseline twins, and times
  host ms a frame of arithmetic-coded against baseline JPEG, the decode
  alone and ``load_batch`` at 1 and 8 threads, the kinds alternated; 22b
  runs ``serve_video`` and ``test_det`` with 13b's checkpoints over two
  devkits of the same pictures (arithmetic-coded and lossless JPEG frames,
  the lossless ones written by ``lossless_frame``, against baseline JPEG
  and 13a's PNGs): detections and ``rel_prob`` bit-equal; 22c runs
  ``tools/stage_c_hard.py`` (ours arm, res101, JAX's hard video set, whose
  147 GT it must count) and ``tools/stage_b_rescore.py::rescore`` (the
  five transforms of the raw cosine scores) on 21d's Stage B head, B2 once
  a scorer call, the last call held (exact) and timed; 22d runs
  ``utils/vis.py::save_vis`` on a frame phase 5 served and reads back the
  PNG it wrote.

Each path's kernel launch counters are set to 0 just before it and read just
after; every RoI kernel launch of a served path must be in the kernel's
staged mode (the map slice in shared memory). Phases 3, 3c, 5b and 7 hold
the RoI kernels in both modes (staged, and the first design's per-bin /
per-cell blocks, kept for maps no slice of which fits) and time both, and
each channel slice, on the same inputs. Every phase prints a line with the elapsed seconds before it starts.
Any failure raises and the script exits non-zero; without a card, or away
from the package, it exits non-zero before printing any result.

``python3 chip_smoke.py --chain-depths`` instead builds the chain kernel at
each accumulation depth (``kDepth`` 16, 32, 64 in ``csrc/bottleneck.cu``)
and holds each as phase 3d does, on phase 3d's input and on the card tests'
chain shapes (``chain_depths``).

The lines before the last are the training, data-parallel, native-loader,
JPEG, int8-gate, serving-gate, last-module and serving record (phase 14's
and 15's steps; phase 17's; phase 21's gates; phase 22's; phase 18's
and phase 16's host ms of the card's machine; ms per 4-frame request of
each path served) and the
kernels' JSON record (launches on the main path,
error against the plain version; per request: the kernel's time, its plain
version's, the library call's and the bound), then the card's name and
power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

T0 = time.time()
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12        # bf16 tensor cores, dense
H100_INT8_OPS_PER_S = 1979e12       # int8 tensor cores, dense
KERNEL_SOURCES = ("roi_pool.cu", "conv1.cu", "roi_align.cu",
                  "bottleneck.cu", "conv1_int8.cu")
# the round-5 configuration's int8 trunk scope and static activation scales
INT8_SCOPE = "layer2,layer3,layer4,@3x3"
ACT_SCALES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                          "calib", "act_scales_res101.json")

FULL = dict(backbone="res101", num_classes=16, num_rel=26, height=600,
            width=960, frames=4, requests=3, max_det=8, max_per_class=8,
            fc_dim=4096, emb_dim=300)
SMALL = dict(backbone="res10", num_classes=4, num_rel=5, height=64, width=80,
             frames=2, max_det=4, max_per_class=4, fc_dim=32, emb_dim=16)
# the chain's small program: res50 (an identity tail in layer2 and layer3)
SMALL50 = dict(SMALL, backbone="res50")
# the chain kernel's three GEMM phases and their template arguments
CHAIN_PHASES = (("down", 0), ("mid", 1), ("up", 2))
NO_LAUNCHES = {"roi_pool": 0, "roi_align": 0, "conv1": 0, "bottleneck": 0,
               "conv1_int8": 0, "int8_conv2d": 0, "int8_linear": 0}


def phase(name: str):
    print(f"[{time.time() - T0:8.2f} s] phase: {name}", flush=True)


def log(msg: str):
    print(f"[{time.time() - T0:8.2f} s]   {msg}", flush=True)


def smi_name_power() -> str | None:
    """``name, power.limit`` of card 0 as nvidia-smi reports them."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def build_models(spec: dict, cfg, generator: torch.Generator,
                 pooling: str = "pool", int8_fc: bool = False,
                 class_agnostic: bool = False, vrd: dict | None = None):
    """Detector + SGG model of ``spec`` with seeded random weights (on the
    CPU). The RPN and class logits are scaled up so that scores spread out
    and no top-k or NMS decision sits on a float near-tie; VGG16's convs get
    the ReLU gain (x sqrt 2) so that its map does not fade over thirteen
    layers. ``int8_fc`` builds the SGG head's fc6/fc7 as ``DenseInt8`` (the
    same weights); ``class_agnostic`` gives the detector a 4-wide
    ``bbox_pred``; ``vrd`` holds further ``VRDHead`` arguments
    (``in_channels``, ``spatial_type``, ``use_obj_visual``)."""
    from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
    from i2vsgg_tpu_torch.models.layers import Conv, init_weights, torch_dtype
    from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
    det = FasterRCNN_DA(spec["num_classes"], cfg, spec["backbone"],
                        class_agnostic=class_agnostic, ic=True, gc=True)
    sgg = SGGModel(VRDHead(emb_dim=spec["emb_dim"], fc_dim=spec["fc_dim"],
                           pooling=pooling,
                           dtype=torch_dtype(cfg.COMPUTE_DTYPE),
                           int8_fc=int8_fc, **(vrd or {})))
    init_weights(det, generator)
    init_weights(sgg, generator)
    with torch.no_grad():
        det.rpn.cls_score.weight.mul_(40.0)
        det.cls_score.weight.mul_(40.0)
        if spec["backbone"] == "vgg16":
            for m in det.trunk.modules():
                if isinstance(m, Conv):
                    m.weight.mul_(2.0 ** 0.5)
    prd = torch.randn(spec["num_rel"], 300, generator=generator).numpy()
    return det, sgg, prd


def small_bf16_models(cfg, int8_fc: bool = False):
    """The small res50 models of phases 4b and 4c (``SMALL50``, seed 1, the
    SGG head under align; ``int8_fc``: fc6/fc7 as ``DenseInt8``, the same
    weights), stored in bf16, with detections that are not degenerate, as
    tests/test_torch_bf16.py makes them: class logits back at their init
    scale (probabilities spread instead of saturating into ties), box
    deltas x0.1 (proposals near their anchors instead of on the border)."""
    from i2vsgg_tpu_torch.utils.params import bf16_storage_cast
    det, sgg, prd = build_models(SMALL50, cfg,
                                 torch.Generator().manual_seed(1),
                                 pooling="align", int8_fc=int8_fc)
    with torch.no_grad():
        det.cls_score.weight.div_(40.0)
        det.rpn.bbox_pred.weight.mul_(0.1)
        det.bbox_pred.weight.mul_(0.1)
    bf16_storage_cast(det)
    bf16_storage_cast(sgg)
    return det, sgg, prd


def make_inputs(spec: dict, seed: int):
    rs = np.random.RandomState(seed)
    images = (rs.randn(spec["frames"], spec["height"], spec["width"], 3)
              * 20).astype(np.float32)
    im_info = np.tile([[spec["height"], spec["width"], 1.0]],
                      (spec["frames"], 1)).astype(np.float32)
    return images, im_info


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_TRIES = 3


def profiled_ms(fn, reps: int, seen) -> dict:
    """Device ms per call of ``fn`` by kernel name, from ``torch.profiler``
    over ``reps`` calls. On the card the profiler now and then returns a
    window without the kernels the call launched; a window in which
    ``seen(times)`` is false is profiled again, up to ``PROFILE_TRIES``
    windows, and the last one is returned."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.key_averages():
            if e.device_time_total > 0:
                times[e.key] = (times.get(e.key, 0.0)
                                + e.device_time_total / 1e3 / reps)
        if seen(times):
            break
    return times


def events_ms(fn, reps: int = 20) -> float:
    """Device ms per call of ``fn`` (all of its kernels) by CUDA events
    around ``reps`` calls queued behind a busy-wait kernel that outlasts
    their launch, so that the events time the card's work, not the host's."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))   # cycles at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, match: str = "", reps: int = 20) -> float:
    """Device ms per call of ``fn`` spent in the kernels whose name contains
    ``match`` (every kernel of the call for ""), from ``torch.profiler``:
    the kernel's own time, without the host's launch overhead that
    ``cuda_ms`` of back-to-back calls includes when a call's device work is
    shorter than its host work. Where no profiled window shows such a
    kernel, the call is timed by ``events_ms`` instead, and a line says so."""
    times = profiled_ms(fn, reps, lambda t: any(match in k for k in t))
    total = sum(v for k, v in times.items() if match in k)
    if total > 0:
        return total
    ms = events_ms(fn, reps)
    log(f"the profiler saw no device time in {match!r} in {PROFILE_TRIES} "
        f"windows; timed by CUDA events behind a busy-wait: {ms:.4f} ms")
    return ms


def roi_pool_work(fmap: torch.Tensor, rois: torch.Tensor, p: int = 7):
    """Bytes and compares the RoIPool of these inputs needs: every fmap cell
    that some bin covers read once, rois read once, the output written once;
    one compare per covered element of every bin."""
    from i2vsgg_tpu_torch.ops.roi_pool import bin_bounds
    b, h, w, c = fmap.shape
    hs, he, ws, we = bin_bounds(rois, 1.0 / 16.0, h, w, p, p)
    hh = torch.arange(h, device=rois.device)
    ww = torch.arange(w, device=rois.device)
    rows = (hh >= hs[..., None]) & (hh < he[..., None])          # (R, P, H)
    cols = (ww >= ws[..., None]) & (ww < we[..., None])          # (R, P, W)
    cells = rows[:, :, None, :, None] & cols[:, None, :, None, :]
    bidx = rois[:, 0].long().clamp(0, b - 1)
    covered = sum(int(cells[bidx == i].any(dim=(0, 1, 2)).sum())
                  for i in range(b))
    esize = fmap.element_size()
    nbytes = (covered * c * esize + rois.numel() * 4
              + rois.shape[0] * p * p * c * esize)
    compares = int(cells.sum()) * c
    return nbytes, compares


def edge_rois(device) -> torch.Tensor:
    """36 rois as the SGG head builds them for 8 detections (8 object rois
    + 28 unordered-pair unions), with detections that hit the RoIPool edge
    cases: coordinates at .5 after the 1/16 scale, a 1-pixel box, boxes
    clipped at or past the feature-map edge (empty bins) and one wholly
    outside it."""
    from i2vsgg_tpu_torch.ops.boxes import union_boxes
    from i2vsgg_tpu_torch.serve import make_pair_indices, make_union_dedup
    dets = torch.tensor([
        [8.0, 24.0, 40.0, 56.0],          # 0.5, 1.5, 2.5, 3.5 cells
        [72.0, 88.0, 104.0, 120.0],       # 4.5, 5.5, 6.5, 7.5
        [500.0, 300.0, 501.0, 301.0],     # 1 pixel
        [-40.0, -40.0, 20.0, 20.0],       # past the top-left edge
        [900.0, 500.0, 1100.0, 700.0],    # right and bottom bins empty
        [1000.0, 700.0, 1200.0, 800.0],   # wholly outside: every bin empty
        [120.3, 211.9, 517.2, 468.6],     # detection-like
        [610.7, 40.1, 955.0, 590.4],
    ], device=device)
    iu1, iu2, _ = make_union_dedup(*make_pair_indices(8))
    u = union_boxes(dets[torch.as_tensor(iu1, device=device).long()],
                    dets[torch.as_tensor(iu2, device=device).long()],
                    600.0, 960.0)
    boxes = torch.cat([dets, u], 0)
    return torch.cat([torch.zeros_like(boxes[:, :1]), boxes], 1).contiguous()


def align_edge_rois(device, n_images: int = 1) -> torch.Tensor:
    """Rois for RoIAlignAvg's edge cases on a (38, 60) feature map at
    1/16, repeated for each of ``n_images`` images (grouped, R = B * N):
    past the right/bottom edge, negative coordinates, a 1-pixel box, one
    wholly outside (every tap zero), one whose samples fall in the last row
    and column (start clamped to H-2 / W-2, ratio above 1), the whole map,
    and detection-like boxes."""
    boxes = torch.tensor([
        [900.0, 500.0, 1100.0, 700.0],    # past the right and bottom edges
        [-40.0, -40.0, 20.0, 20.0],       # negative coordinates
        [-300.0, -300.0, -100.0, -50.0],  # wholly outside, top-left
        [1000.0, 700.0, 1200.0, 800.0],   # wholly outside, bottom-right
        [500.0, 300.0, 501.0, 301.0],     # 1 pixel
        [300.0, 200.0, 300.0, 200.0],     # a point
        [880.0, 560.0, 959.0, 599.0],     # last row and column (h-2 clamp)
        [0.0, 0.0, 959.0, 599.0],         # the whole map
        [8.0, 24.0, 40.0, 56.0],
        [120.3, 211.9, 517.2, 468.6],
        [610.7, 40.1, 955.0, 590.4],
        [33.3, 450.5, 400.25, 598.9],
    ], device=device)
    rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], 1)
    rois = rois.repeat(n_images, 1)
    rois[:, 0] = torch.arange(n_images, device=device).repeat_interleave(
        boxes.shape[0]).float()
    return rois.contiguous()


def held_one_ulp(got: torch.Tensor, ref: torch.Tensor, what: str,
                 min_equal: float = 0.999) -> float:
    """Hold a bf16 kernel output to its plain version: at most one bf16 ulp
    apart (|d| <= 2**-7 |ref|, plus 2**-16 max|ref| where a sum cancels to
    near zero and its f32 rounding is many ulps of the tiny result), and at
    least ``min_equal`` of the elements bit-equal. Returns the max abs
    error."""
    g, r = got.float(), ref.float()
    if g.shape != r.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != "
                             f"{tuple(r.shape)}")
    gap = (g - r).abs()
    bound = 2.0 ** -7 * r.abs() + 2.0 ** -16 * float(r.abs().max())
    equal = float((g == r).float().mean()) if g.numel() else 1.0
    err = float(gap.max()) if g.numel() else 0.0
    if not bool((gap <= bound).all()) or equal < min_equal:
        raise AssertionError(f"{what}: max abs err {err}, bit-equal share "
                             f"{equal:.6f} (needs one ulp and {min_equal})")
    log(f"{what}: within one bf16 ulp, bit-equal share {equal:.6f}, "
        f"max abs err {err:.3g}")
    return err


def held_f32(got: torch.Tensor, ref: torch.Tensor, what: str,
             scale: float) -> float:
    """f32 kernel vs reference: rtol 1e-5 with atol 1e-5 * ``scale`` (the
    input's largest magnitude). Returns the max abs error."""
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    ok = bool(((got - ref).abs() <= 1e-5 * ref.abs() + 1e-5 * scale).all())
    if not ok:
        raise AssertionError(f"{what}: max abs err {err} (rtol 1e-5, atol "
                             f"{1e-5 * scale:.3g})")
    equal = float((got == ref).float().mean()) if got.numel() else 1.0
    log(f"{what}: max abs err {err:.3g}, bit-equal share {equal:.6f}")
    return err


def held_chain(chain, x: torch.Tensor, wts: tuple, what: str,
               min_equal: float = 0.99, quiet: bool = False,
               excess_of: str = "block") -> dict:
    """Hold a bottleneck chain (``chain(x, w1, b1, w3, b3, w2, b2)``, the
    kernel's wrapper) to the plain version (f32 sums, TF32 off) at bounds
    that do not widen with depth. Two f32 summation orders part where a
    bf16 rounding of ``a`` or ``b`` flips by one ulp: W2 carries the flip
    into the residual add, and where that cancels the flip is many ulps of
    the small result; over many blocks the flips compound. So the chain is
    held block by block, each block against an f64 reference with the same
    rounding points (``ref64``), which measures how far the plain version's
    own f32 order strays on that block's data, and then as a whole:

    * each of the n blocks, run alone on the map that the chain itself gives
      it (its own output of the blocks before), is within one bf16 ulp of
      the plain version on that map (2**-7 |ref|) plus twice the plain
      version's largest excess over one ulp against ``ref64`` (plus 2**-16
      max|ref|), with at least ``min_equal`` of its elements bit-equal to
      the plain version;
    * the n-block call is bit-equal to those n one-block calls in turn: no
      state but the map passes from one block to the next;
    * at the n-block output, the share of elements within 0.02 (rtol = atol)
      of ``ref64`` is at most 0.005 below the plain version's share.

    ``excess_of="call"`` takes the plain version's excess as the largest
    over the n blocks of this call instead of each block's own: on a served
    map, where one block's plain version can happen to stray less from f64
    than its neighbours, one bf16 flip of the kernel's can exceed twice
    that block's excess alone.

    Raises AssertionError at the first bound broken. Returns the numbers:
    the largest abs error, excess and least bit-equal share over the
    blocks, and the whole chain's shares against f64."""
    import i2vsgg_tpu_torch.ops.bottleneck as chain_mod
    plain = chain_mod.bottleneck_chain_plain
    n = wts[0].shape[0]
    maps, err, worst_excess, least, blocks = [x], 0.0, 0.0, 1.0, []
    for i in range(n):
        one = tuple(t[i:i + 1] for t in wts)
        maps.append(chain(maps[-1], *one))
        with tf32_off():
            ref = plain(maps[-2], *one).float()
            ref64 = plain(maps[-2], *one, acc=torch.float64).float()
        g = maps[-1].float()
        excess = float(((ref - ref64).abs() - 2.0 ** -7 * ref64.abs())
                       .clamp_min(0).max())
        gap = (g - ref).abs()
        # the least excess that would hold every element of this block
        needs = float(((gap - 2.0 ** -7 * ref.abs()
                        - 2.0 ** -16 * float(ref.abs().max())) / 2).max())
        equal = float((g == ref).float().mean())
        err, least = max(err, float(gap.max())), min(least, equal)
        worst_excess = max(worst_excess, excess)
        blocks.append((float(gap.max()), excess, needs, equal))
    for i, (gap_max, excess, needs, equal) in enumerate(blocks):
        allowed = worst_excess if excess_of == "call" else excess
        if needs > allowed or equal < min_equal:
            raise AssertionError(
                f"{what}: block {i} alone on the chain's map: max abs err "
                f"{gap_max}, plain vs f64 excess over one ulp {excess:.4g} "
                f"(largest over the call's blocks {worst_excess:.4g}), "
                f"needs {needs:.4g}, bit-equal share {equal:.6f} (needs one "
                f"ulp + twice the {excess_of}'s excess, and {min_equal} "
                "bit-equal)")
    got = chain(x, *wts)
    if not torch.equal(got, maps[-1]):
        raise AssertionError(f"{what}: the {n}-block call differs from its "
                             f"{n} one-block calls in turn")
    with tf32_off():
        ref = plain(x, *wts).float()
        ref64 = plain(x, *wts, acc=torch.float64).float()
    g = got.float()
    within = [float(((t - ref64).abs() <= 0.02 * ref64.abs() + 0.02)
                    .float().mean()) for t in (g, ref)]
    equal64 = [float((t == ref64).float().mean()) for t in (g, ref)]
    e_all = float((g - ref).abs().max())
    vs_plain = float((g == ref).float().mean())
    msg = (f"{what}: per block: max abs err {err:.4g} (plain vs f64 excess "
           f"over one ulp at most {worst_excess:.4g}), least bit-equal "
           f"share {least:.6f}; the {n}-block call equal to the blocks in "
           f"turn; at the output: max abs err vs plain {e_all:.4g} (max "
           f"|ref| {float(ref.abs().max()):.4g}), bit-equal share vs plain "
           f"{vs_plain:.6f}; vs f64, kernel | plain: within 0.02 "
           f"{within[0]:.6f} | {within[1]:.6f}, bit-equal {equal64[0]:.6f} | "
           f"{equal64[1]:.6f}")
    if within[0] < within[1] - 0.005:
        raise AssertionError(msg + " (needs the share within 0.02 of f64 at "
                             "most 0.005 below the plain version's)")
    if not quiet:
        log(msg)
    return {"max_abs_err": max(err, e_all), "block_max_abs_err": err,
            "block_plain_excess_vs_f64": worst_excess,
            "block_excess_needed": max(b[2] for b in blocks),
            "least_block_bit_equal": least, "bit_equal_vs_plain": vs_plain,
            "within_002_vs_f64": {"kernel": within[0], "plain": within[1]},
            "bit_equal_vs_f64": {"kernel": equal64[0], "plain": equal64[1]}}


def chain_controls(kern, x: torch.Tensor, wts: tuple) -> list:
    """Show that ``held_chain`` tells a wrong chain from a right one at
    these inputs: two wrong chains, each near the kernel, must be refused.
    Returns (control, the bound that refused it) pairs."""
    import i2vsgg_tpu_torch.ops.bottleneck as chain_mod
    plain = chain_mod.bottleneck_chain_plain

    def bf16_sums(x_, *w):
        # the plain version rounding each product to bf16 before its bias
        # (bf16 GEMM outputs): one rounding point too many
        return plain(x_, *w, acc=torch.bfloat16)

    def block0_weights(x_, *w):
        # the kernel reading block 0's weights for every block
        return kern(x_, *(t[:1].expand_as(t).contiguous() for t in w))

    refused = []
    for name, fn in (("the plain version summing in bf16", bf16_sums),
                     ("the kernel on block 0's weights throughout",
                      block0_weights)):
        try:
            held_chain(fn, x, wts, name, quiet=True)
        except AssertionError as e:
            refused.append((name, str(e)))
            continue
        raise AssertionError(f"held_chain did not refuse {name}: the chain "
                             "check cannot tell a wrong chain")
    return refused


class tf32_off:
    """f32 matmuls and convolutions without TF32 (both flags), restored on
    exit: the plain versions' reference arithmetic."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def chain_work(x: torch.Tensor, w1, w3, w2, biases) -> tuple:
    """Bytes and flops of the chain on these inputs: the map read once and
    written once, every folded weight and bias read once; 2 flops a
    multiply-add of the three GEMMs over the B * H * W pixels."""
    b, h, w, c = x.shape
    n, _, m = w1.shape
    nbytes = (2 * x.numel() * x.element_size()
              + sum(t.numel() * t.element_size() for t in (w1, w3, w2))
              + sum(t.numel() * t.element_size() for t in biases))
    flops = 2 * n * b * h * w * (c * m + 9 * m * m + m * c)
    return nbytes, flops


def matched_order(got: dict, ref: dict) -> torch.Tensor:
    """Per frame, the slot of ``got`` that holds each of ``ref``'s
    detections: the same class and validity and the nearest box, taken
    greedily in ``ref``'s order. Two summation orders can swap two
    detections whose scores nearly tie; matched, they are the same
    detections. (B, K) long; raises if a detection has no partner."""
    b, k = ref["classes"].shape
    perm = torch.empty((b, k), dtype=torch.long)
    for f in range(b):
        free = list(range(k))
        for i in range(k):
            same = [j for j in free
                    if int(got["classes"][f, j]) == int(ref["classes"][f, i])
                    and bool(got["det_valid"][f, j])
                    == bool(ref["det_valid"][f, i])]
            if not same:
                raise AssertionError(f"frame {f}: detection {i} (class "
                                     f"{int(ref['classes'][f, i])}) has no "
                                     "partner")
            j = min(same, key=lambda j: float(
                (got["boxes"][f, j] - ref["boxes"][f, i]).abs().max()))
            perm[f, i] = j
            free.remove(j)
    return perm


def reordered(out: dict, perm: torch.Tensor) -> dict:
    """``out``'s detections in ``perm``'s order, its pair outputs (where it
    has them) remapped to the same detections (``ix1``/``ix2``
    unchanged)."""
    new = dict(out)
    for key in ("boxes", "scores", "classes", "det_valid"):
        new[key] = torch.stack([out[key][f][perm[f]]
                                for f in range(perm.shape[0])])
    if "ix1" not in out:
        return new
    pair = {(int(a), int(c)): p
            for p, (a, c) in enumerate(zip(out["ix1"], out["ix2"]))}
    for key in ("rel_prob", "pair_valid"):
        new[key] = torch.stack([out[key][f][torch.as_tensor(
            [pair[(int(perm[f, a]), int(perm[f, c]))]
             for a, c in zip(out["ix1"], out["ix2"])])]
            for f in range(perm.shape[0])])
    return new


def fed_stages(det_c, sgg_c, det_g, sgg_g, prd, cfg, images, im_info,
               ref: dict, dev, **kw) -> dict:
    """The frame program stage by stage on ``dev`` (models ``det_g`` and
    ``sgg_g``), each stage fed the CPU's input to it (models ``det_c`` and
    ``sgg_c``, the same weights), through the models' public stage entry
    points: the trunk's stages that run the chain, the RPN head, the
    detector past the trunk on the CPU's maps and proposals, the decode,
    and the SGG head on the CPU's detections (``ref``, the CPU program's
    output). Returns {stage: (card output, CPU output)} on the CPU, and
    under ``"witness"`` the CPU's program past the trunk fed the card's own
    trunk maps (its output dict, and the two trunks' maps)."""
    from i2vsgg_tpu_torch import serve
    from i2vsgg_tpu_torch.models.backbones import nchw_to_nhwc
    x, info = torch.as_tensor(images), torch.as_tensor(im_info)
    tr_c, tr_g = det_c.trunk, det_g.trunk
    on = lambda ts: tuple(t.to(dev) for t in ts)           # noqa: E731
    back = lambda t: t.cpu()                               # noqa: E731
    out = {}
    with torch.no_grad():
        l1 = tr_c.layer1(tr_c._stem(x))
        tap = tr_c.layer2(l1)
        c4 = tr_c.layer3(tap)
        out["layer2 (chain)"] = (back(tr_g.layer2(l1.to(dev))), tap)
        out["layer3 (chain)"] = (back(tr_g.layer3(tap.to(dev))), c4)
        maps = (nchw_to_nhwc(c4), nchw_to_nhwc(tap))
        rpn_c = det_c.rpn(maps[0])
        rpn_g = det_g.rpn(maps[0].to(dev))
        out["rpn cls_score"] = (back(rpn_g[0]), rpn_c[0])
        out["rpn bbox_pred"] = (back(rpn_g[1]), rpn_c[1])
        props = det_c.proposals(maps[0], *rpn_c, info)
        det_out_c = det_c.detect_on_features(*maps, info, props)
        det_out_g = det_g.detect_on_features(
            *on(maps), info.to(dev), type(props)(*on(props)))
        for k in ("cls_prob", "bbox_pred"):
            out[k] = (back(det_out_g[k]), det_out_c[k])
        dec = [serve.decode_detections(
            o["rois"], o["roi_valid"], o["cls_prob"], o["bbox_pred"],
            info.to(o["rois"].device), cfg, **kw)._asdict()
            for o in (det_out_c, det_out_g)]
        out["decode"] = tuple(
            {"det_valid" if k == "valid" else k: back(v) for k, v in d.items()}
            for d in (dec[1], dec[0]))
        prd_t = torch.as_tensor(np.asarray(prd, np.float32))
        heads = [serve.relation_heads(
            model, det_out_c["base_feat"].to(d), info.to(d),
            ref["boxes"].to(d), ref["det_valid"].to(d),
            serve.pair_layout(kw["max_det"], d), prd_t.to(d))[0]
            for model, d in ((sgg_g, dev), (sgg_c, "cpu"))]
        out["rel_prob"] = (back(heads[0]), heads[1])
    witness, maps_g = witness_outputs(det_c, sgg_c, det_g, prd, cfg, images,
                                      im_info, dev, **kw)
    out["witness"] = (witness, (maps_g, maps))
    return out


def witness_outputs(det_c, sgg_c, det_g, prd, cfg, images, im_info, dev,
                    **kw):
    """The CPU's program past the trunk (models ``det_c``, ``sgg_c``) fed
    the card's own trunk maps (model ``det_g``, the same weights): the
    witness a card program is held to where a near tie downstream of the
    trunk may go another way. Returns its output dict and the card's maps
    on the CPU."""
    from i2vsgg_tpu_torch import serve
    x, info = torch.as_tensor(images), torch.as_tensor(im_info)
    prd_t = torch.as_tensor(np.asarray(prd, np.float32))
    with torch.no_grad():
        maps_g = tuple(t.cpu() for t in det_g.trunk(x.to(dev)))
        witness = serve.program_outputs(
            sgg_c, det_c.detect_on_features(*maps_g, info), info, prd_t,
            serve.pair_layout(kw["max_det"], "cpu"), cfg, **kw)
    return witness, maps_g


def whole_program_checks(got: dict, ref: dict, witness: dict, what: str,
                         int8: bool = False) -> list:
    """Hold a card program's output ``got`` (on the CPU) to the CPU's
    program ``ref`` and to the ``witness`` (``witness_outputs``). Against
    the witness: classes, validity and pairs equal after matching (raises
    otherwise), and (check, value, bound) triples for boxes within 4 px,
    scores within 1e-2, rel_prob within 5e-3. Against the CPU: classes,
    validity and pairs equal after matching, scores and rel_prob within
    5e-2, and a box may be more than 4 px off only where the witness moves
    it off too (the CPU's own program, given the card's trunk maps, makes
    the same other choice). With ``int8`` the same exception holds for the
    scores and rel_prob of such a detection (and of its pairs): there the
    witness has picked another detection, which may score otherwise; an
    int8 quantization turns the trunk's ulp differences into whole steps,
    so such picks are more frequent. Returns the triples."""
    checks = []
    for name, other in (("witness", witness), ("CPU", ref)):
        perm = matched_order(got, other)
        swaps = int((perm != torch.arange(perm.shape[1])).sum())
        mine = reordered(got, perm)
        for k in ("det_valid", "classes", "pair_valid"):
            if not torch.equal(mine[k], other[k]):
                raise AssertionError(f"{what} {k}: card != {name}")
        log(f"{what} vs the {name}: classes, validity and pairs equal "
            f"({swaps} detections in another slot)")
        if name == "witness":
            for k, tol in (("boxes", 4.0), ("scores", 1e-2),
                           ("rel_prob", 5e-3)):
                checks.append((f"whole program {k} vs the witness",
                               float((mine[k].float() - witness[k].float())
                                     .abs().max()), tol))
            continue
        valid = ref["det_valid"]
        moved = ((mine["boxes"] - ref["boxes"]).abs().amax(-1) * valid)
        wit = reordered(witness, matched_order(witness, ref))
        moved_w = ((wit["boxes"] - ref["boxes"]).abs().amax(-1) * valid)
        kept = (moved_w <= 4.0) if int8 else torch.ones_like(valid)
        pair_kept = kept[:, mine["ix1"]] & kept[:, mine["ix2"]]
        for k, mask in (("scores", kept), ("rel_prob", pair_kept)):
            gap = (mine[k] - ref[k]).abs()
            gap = gap * (mask if k == "scores" else mask[..., None])
            checks.append((f"whole program {k} vs the CPU"
                           + (", where the witness keeps the CPU's box"
                              if int8 else ""), float(gap.max()), 5e-2))
        for f, i in (moved > 4.0).nonzero().tolist():
            log(f"  frame {f} detection {i} (class "
                f"{int(ref['classes'][f, i])}, score "
                f"{float(ref['scores'][f, i]):.4g}): card "
                f"{float(moved[f, i]):.3g} px from the CPU, the witness "
                f"{float(moved_w[f, i]):.3g} px")
        checks.append(("whole program boxes (px) vs the CPU, where the "
                       "witness keeps the CPU's box",
                       float((moved * (moved_w <= 4.0)).max()), 4.0))
    return checks


def int8_modules(model) -> dict:
    """The modules of ``model`` that run an int8 product: ``BNConv``s with
    int8-stored weights and the ``DenseInt8`` towers, by name."""
    from i2vsgg_tpu_torch.models.backbones import BNConv
    from i2vsgg_tpu_torch.models.sgg import DenseInt8
    return {name: m for name, m in model.named_modules()
            if isinstance(m, DenseInt8)
            or (isinstance(m, BNConv) and m.weight.dtype == torch.int8)}


class recorded_calls:
    """Record every call of the given modules (name -> module) as (name,
    positional inputs, output) while inside; with ``keep``, as (name,
    ``keep(inputs, output)``), so that no input stays alive."""

    def __init__(self, modules: dict, keep=None):
        self.modules, self.calls, self.handles = modules, [], []
        self.keep = keep or (lambda args, out: (args, out))

    def __enter__(self):
        for name, m in self.modules.items():
            self.handles.append(m.register_forward_hook(
                lambda mod, args, out, name=name:
                self.calls.append((name, *self.keep(args, out)))))
        return self.calls

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def saturated_share(det, run) -> tuple:
    """Run ``run()`` and count, at every int8 conv of ``det`` with a static
    activation scale, the inputs whose quotient ``round(x / act_scale)``
    lies beyond +-127 (clipped to it). Returns (share of all their inputs,
    the largest share at one conv and its name)."""
    convs = {n: m for n, m in int8_modules(det).items()
             if getattr(m, "act_scale", None) is not None}
    with recorded_calls(convs) as calls:
        run()
    total = clipped = 0
    worst, worst_name = 0.0, ""
    for name, args, _ in calls:
        q = torch.round(args[0].float() / convs[name].act_scale)
        n_clip = int((q.abs() > 127).sum())
        total += q.numel()
        clipped += n_clip
        if n_clip / q.numel() > worst:
            worst, worst_name = n_clip / q.numel(), name
    return clipped / max(total, 1), worst, worst_name


def conv1_int8_work(x: torch.Tensor, out: torch.Tensor) -> tuple:
    """Bytes and int8 operations of B6 on these images: the f32 images read
    once, the int8 weights and f32 scale and bias read once, the bf16
    output written once; 2 operations a multiply-add over the 147 taps."""
    b, ho, wo, c = out.shape
    nbytes = (x.numel() * x.element_size() + 64 * 160 + 2 * 64 * 4
              + out.numel() * out.element_size())
    return nbytes, 2 * b * ho * wo * c * 147


def int8_edge_images(shape, seed: int = 0) -> np.ndarray:
    """Mean-subtracted f32 images (B, H, W, 3) on which B6's quantizer,
    ``clamp(round(x + (mean - 128)), -128, 127)``, takes every branch: a
    third integer pixels, a third whose shifted f32 sum is exactly k + 0.5
    (rounded half to even; k from -131 to 130, so ties also meet the
    clamp), a third uniform in (-400, 400), mostly clamped or fractional."""
    from i2vsgg_tpu_torch.ops.conv1_int8 import DEFAULT_PIXEL_MEANS
    rng = np.random.RandomState(seed)
    means = np.asarray(DEFAULT_PIXEL_MEANS, np.float32)
    shift = means - np.float32(128.0)
    x = rng.randint(0, 256, (*shape, 3)).astype(np.float32) - means
    half = rng.randint(-131, 131, x.shape).astype(np.float32) + 0.5
    tie = (half.astype(np.float64) - shift).astype(np.float32)
    for _ in range(4):              # step to the f32 whose sum is the tie
        s = tie + shift
        tie = np.where(s > half, np.nextafter(tie, np.float32(-np.inf)),
                       np.where(s < half, np.nextafter(tie, np.float32(np.inf)),
                                tie))
    tie = np.where(tie + shift == half, tie, x)
    wide = rng.uniform(-400.0, 400.0, x.shape).astype(np.float32)
    pick = rng.randint(0, 3, x.shape)
    return np.where(pick == 1, tie, np.where(pick == 2, wide, x))


def fused_tail_blocks(trunk, h: int, w: int) -> int:
    """Blocks of the trunk's identity tails that run as the chain for an
    h x w frame: the gate (``use_fused_chain``, which reads the switch) at
    each stage's block0 output size."""
    from i2vsgg_tpu_torch.models.backbones import use_fused_chain
    h, w = (h + 1) // 2, (w + 1) // 2              # conv1 7x7/2, pad 3
    h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1      # the caffe ceil-mode pool
    n = 0
    for stage, stride in ((trunk.layer1, 1), (trunk.layer2, 2),
                          (trunk.layer3, 2)):
        h, w = (h - 1) // stride + 1, (w - 1) // stride + 1
        x = torch.empty((1, stage.planes * 4, h, w), device="meta")
        if stage.blocks > 1 and use_fused_chain(x, stage.planes):
            n += stage.blocks - 1
    return n


def roi_pool_plain_chunked(fmap, rois, *args, chunk: int = 64):
    """``roi_pool_plain`` over ``chunk`` rois at a time (each roi's output
    depends on that roi only): its row sweep holds (R, P, H, W, C) values,
    about 16 GB at the detector site's 512 rois."""
    from i2vsgg_tpu_torch.ops.roi_pool import roi_pool_plain
    return torch.cat([roi_pool_plain(fmap, rois[i:i + chunk], *args)
                      for i in range(0, rois.shape[0], chunk)])


def check_kernel_vs_plain(fmap, rois, what: str, *args) -> float:
    """RoIPool's kernel, in the mode and slice it chooses and in the
    per-bin mode, ``torch.equal`` to its plain version (``args``: pooled
    height and width, spatial scale)."""
    from i2vsgg_tpu_torch.ops.roi_pool import roi_pool
    got = roi_pool(fmap, rois, *args)
    plan = roi_pool.last_plan
    per_bin = roi_pool(fmap, rois, *args, channel_slice=-1)
    exp = roi_pool_plain_chunked(fmap, rois, *args)
    torch.cuda.synchronize()
    err = float((got.float() - exp.float()).abs().max()) if got.numel() else 0.0
    if not (torch.equal(got, exp) and torch.equal(per_bin, exp)):
        raise AssertionError(f"roi_pool kernel != plain on {what} ({plan}): "
                             f"max abs err {err}")
    log(f"roi_pool {what}: bit-exact (torch.equal) in the {plan['mode']} "
        f"mode (slice {plan['slice']}, {plan['smem_bytes']} B of shared "
        f"memory) and the per-bin mode, out {tuple(got.shape)}")
    return err


def build_facts(source: str, entry: str) -> dict:
    """Registers and spill bytes of the kernel entry of ``csrc/<source>``
    whose mangled name contains ``entry``."""
    found = [v for k, v in ptxas_report(source).items() if entry in k]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} entries of {source} match "
                             f"{entry}")
    return found[0]


def slice_times(run, match: str, slices=(8, 16, 32)) -> dict:
    """Device ms of ``run(channel_slice)``'s kernel (``kernel_ms``) at each
    channel slice (None where the slice does not fit in shared memory)."""
    out = {}
    for sl in slices:
        try:
            run(sl)
        except RuntimeError:
            out[str(sl)] = None
            continue
        out[str(sl)] = kernel_ms(lambda: run(sl), match)
    return out


def build_kernels() -> dict:
    """Build every kernel source with one nvcc each and the native batch
    loader (``runtime``: io_runtime.cc + jpeg.cc) with the host compiler,
    all started together; print each build's time and what ptxas reports.
    Returns the loader's build record (cold or not, seconds)."""
    from i2vsgg_tpu_torch import runtime
    from i2vsgg_tpu_torch.utils import cuda_build

    def one(src):
        t = time.time()
        lib = cuda_build.build(src)
        return src, lib, time.time() - t

    lib_rt = cuda_build.library_path(runtime.SOURCES, cuda_build.HOST_FLAGS,
                                     cuda_build.find_cxx())
    rt = {"cold": not lib_rt.exists(), "library": lib_rt.name}

    def host():
        t = time.time()
        runtime.library()
        return time.time() - t

    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) as pool:
        rt_future = pool.submit(host)
        built = list(pool.map(one, KERNEL_SOURCES))
        rt["build_s"] = rt_future.result()
    for src, lib, sec in built:
        log(f"built {lib.name} in {sec:.2f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas ({src}): {line.strip()}")
    log(f"built {lib_rt.name} (the native batch loader, host compiler) in "
        f"{rt['build_s']:.2f} s (cold: {rt['cold']})")
    return rt


def ptxas_report(source: str) -> dict:
    """Registers and spill bytes (stores + loads) of each kernel entry of
    ``csrc/<source>``, from its build log (``-Xptxas -v``), by mangled
    name."""
    from i2vsgg_tpu_torch.utils import cuda_build
    log_text = cuda_build.library_path(source).with_suffix(".log").read_text()
    out, name = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {"registers": None, "spill_bytes": 0}
        elif name and "spill stores" in line:
            nums = [int(t) for t in line.replace(",", " ").split()
                    if t.isdigit()]
            out[name]["spill_bytes"] = nums[1] + nums[2]
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
    return out


def chain_phase_ms(kern, x, wts, reps: int = 5) -> dict:
    """Device ms per chain call of each of the chain kernel's three GEMM
    phases (the kernels ``bottleneck_gemm<0>``, ``<1>``, ``<2>``: 1x1 down,
    3x3, 1x1 up), from ``torch.profiler`` (``profiled_ms``) over ``reps``
    calls."""
    def by_phase(times):
        out = {}
        for key, ms in times.items():
            for ph, tag in CHAIN_PHASES:
                if f"bottleneck_gemm<{tag}>" in key:
                    out[ph] = out.get(ph, 0.0) + ms
        return out

    out = by_phase(profiled_ms(
        lambda: kern(x, *wts), reps,
        lambda t: len(by_phase(t)) == len(CHAIN_PHASES)))
    if set(out) != {ph for ph, _ in CHAIN_PHASES}:
        raise AssertionError(f"the profiler saw the chain's phases {out} in "
                             f"{PROFILE_TRIES} windows")
    return out


def chain_phase_work(x, w1, w3, w2, biases) -> dict:
    """Bytes and flops of each phase of the chain on these inputs (per
    chain call): each phase's input map, weights and biases read once, its
    output written once (the up phase reads x for the residual too)."""
    b, h, w, c = x.shape
    n, _, m = w1.shape
    p, e = b * h * w, x.element_size()
    b1, b3, b2 = (t.numel() * t.element_size() for t in biases)
    return {"down": (n * p * (c + m) * e + w1.numel() * 2 + b1,
                     2 * n * p * c * m),
            "mid": (2 * n * p * m * e + w3.numel() * 2 + b3,
                    2 * n * p * 9 * m * m),
            "up": (n * p * (m + 2 * c) * e + w2.numel() * 2 + b2,
                   2 * n * p * m * c)}


def conv1_work(planes_or_images, b: int, h: int, w: int):
    """Bytes and flops of the stem on this input: the input read once, the
    weights and affine read once, the pooled output written once; 2 flops a
    multiply-add of conv1."""
    from i2vsgg_tpu_torch.ops.conv1 import conv1_plane_geometry
    g = conv1_plane_geometry(h, w)
    hp, wp = (g.ho - 2) // 2 + 1, (g.wo - 2) // 2 + 1
    nbytes = (planes_or_images.numel() * planes_or_images.element_size()
              + 147 * 64 * 2 + 2 * 64 * 4 + b * hp * wp * 64 * 2)
    flops = 2 * b * g.ho * g.wo * 64 * 147
    return nbytes, flops


def roi_align_work(fmap: torch.Tensor, rois: torch.Tensor, grid, p: int = 7):
    """Bytes and flops the RoIAlignAvg of these inputs needs: every fmap
    cell that a nonzero tap of some roi reads, once; rois read once; the
    output written once; 2 flops (an f32 FMA) per tap pair and channel."""
    from i2vsgg_tpu_torch.ops.roi_align import folded_weights
    b, h, w, c = fmap.shape
    ry, rx = folded_weights(rois, h, w, p, p, 1.0 / 16.0, grid, fmap.dtype)
    rows = (ry != 0).any(dim=1).float().reshape(b, -1, h)     # (B, N, H)
    cols = (rx != 0).any(dim=1).float().reshape(b, -1, w)
    covered = int((torch.einsum("bnh,bnw->bhw", rows, cols) > 0).sum())
    taps = float(((ry != 0).sum(dim=(1, 2)).float()
                  * (rx != 0).sum(dim=(1, 2)).float()).sum())
    g = ry.shape[1]
    esize = fmap.element_size()
    nbytes = (covered * c * esize + rois.numel() * 4
              + rois.shape[0] * g * g * c * esize)
    return nbytes, 2.0 * taps * c


def bound_of(nbytes: float, flops: float, ops_per_s: float):
    t_bytes = 1e3 * nbytes / H100_BYTES_PER_S
    t_ops = 1e3 * flops / ops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def synthetic_video(spec: dict, seed: int, n_frames: int = 12):
    """A seeded video as the loader would ship it: uint8 BGR frames of a
    random scene seen by a still camera, their f32 transport
    (mean-subtracted) and im_info, cut into requests of ``spec["frames"]``
    frames. The frames are identical: with seeded random weights the
    detector's scores saturate (ties) and its boxes hug the image border, so
    any change between frames reorders the detections and Stage C would
    have no tracks to link."""
    from i2vsgg_tpu_torch.config import Config
    rs = np.random.RandomState(seed)
    h, w, b = spec["height"], spec["width"], spec["frames"]
    scene = rs.randint(0, 256, (1, h, w, 3)).astype(np.uint8)
    u8 = np.repeat(scene, n_frames, axis=0)
    f32 = u8.astype(np.float32) - np.asarray(Config().PIXEL_MEANS,
                                             np.float32)
    info = np.tile([[h, w, 1.0]], (b, 1)).astype(np.float32)
    return [(u8[i:i + b], f32[i:i + b], info)
            for i in range(0, n_frames, b)]


def check_outputs(out: dict, spec: dict):
    b, md, nr = spec["frames"], spec["max_det"], spec["num_rel"]
    shapes = {"boxes": (b, md, 4), "scores": (b, md), "det_valid": (b, md),
              "rel_prob": (b, md * (md - 1), nr),
              "pair_valid": (b, md * (md - 1))}
    for k, s in shapes.items():
        if tuple(out[k].shape) != s:
            raise AssertionError(f"{k} shape {tuple(out[k].shape)} != {s}")
    rp = out["rel_prob"].float()
    if not bool(torch.isfinite(rp).all()):
        raise AssertionError("rel_prob has non-finite values")
    sums_err = float((rp.sum(-1) - 1.0).abs().max())
    if not sums_err <= 1e-4:
        raise AssertionError(f"rel_prob sums off 1 by {sums_err}")
    if not bool(torch.isfinite(out["boxes"]).all()):
        raise AssertionError("boxes have non-finite values")


class Counters:
    """The launch counters of the port's kernels, and the int8 GEMMs the
    int8 levers take on the card (``torch._int_mm``, not a kernel of the
    port: counted to show which path ran)."""

    def __init__(self):
        from i2vsgg_tpu_torch.ops import (bottleneck, conv1, conv1_int8, int8,
                                          roi_align, roi_pool)
        self.mods = {"roi_pool": (roi_pool.roi_pool, "launches"),
                     "roi_align": (roi_align.roi_align_avg, "launches"),
                     "conv1": (conv1, "launches"),
                     "bottleneck": (bottleneck.bottleneck_chain, "launches"),
                     "conv1_int8": (conv1_int8, "launches"),
                     "int8_conv2d": (int8.int8_conv2d, "calls"),
                     "int8_linear": (int8.int8_linear, "calls")}

    def reset(self):
        for obj, attr in self.mods.values():
            setattr(obj, attr, 0)
            for mode in getattr(obj, "launches_by_mode", ()):
                obj.launches_by_mode[mode] = 0

    def read(self) -> dict:
        return {k: getattr(obj, attr) for k, (obj, attr) in self.mods.items()}

    def modes(self) -> dict:
        """The RoI kernels' launches by mode since the last reset."""
        return {k: dict(obj.launches_by_mode)
                for k, (obj, _) in self.mods.items()
                if hasattr(obj, "launches_by_mode")}


def serve_requests(program, requests, to_input, counters, expect: dict,
                   what: str):
    """Serve ``requests`` through ``program`` (``to_input`` builds each
    request's program input on the host); the launch counters are set to 0
    just before and read just after, and must equal ``expect`` per
    request. Returns the outputs and the per-request host ms."""
    counters.reset()
    outs, times = [], []
    for req in requests:
        t = time.time()
        outs.append(program(*to_input(req)))
        torch.cuda.synchronize()
        times.append(1e3 * (time.time() - t))
    got = counters.read()
    want = {k: v * len(requests) for k, v in expect.items()}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want}")
    for k, by_mode in counters.modes().items():
        if by_mode["staged"] != got[k]:
            raise AssertionError(f"{what}: {k} launches by mode {by_mode}: "
                                 "not all staged")
    log(f"{what}: launches {got} in {len(requests)} requests; request ms "
        f"{', '.join(f'{x:.2f}' for x in times)}")
    return outs, times


def bucketed_vs_fused(fused_outs, bk_outs) -> float:
    """The bucketed program against the fused one (as
    tests/test_torch_serve.py::test_bucketed_program_matches_fused holds
    them): detections equal, the same valid pairs, their rel_prob within
    1e-3. Returns the largest rel_prob difference."""
    worst = 0.0
    for a, o in zip(fused_outs, bk_outs):
        for k in ("boxes", "scores", "classes", "det_valid"):
            if not torch.equal(a[k], o[k]):
                raise AssertionError(f"bucketed: {k} differs from the fused "
                                     "program")
        for f in range(a["det_valid"].shape[0]):
            full, part = ({(int(i), int(j)): x["rel_prob"][f, n]
                           for n, (i, j) in enumerate(zip(x["ix1"], x["ix2"]))
                           if x["pair_valid"][f, n]} for x in (a, o))
            if set(full) != set(part):
                raise AssertionError("bucketed: valid pairs differ")
            for key in full:
                worst = max(worst, float((full[key].float()
                                          - part[key].float()).abs().max()))
    if not worst <= 1e-3:
        raise AssertionError(f"bucketed: rel_prob off by {worst} > 1e-3")
    return worst


def steady_ms(times):
    return sum(times[1:]) / len(times[1:])


def same_outputs(a: dict, b: dict, what: str):
    for k in ("boxes", "scores", "classes", "det_valid", "rel_prob",
              "pair_valid"):
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs")


def recorded_roi_sites(program, inputs) -> list:
    """One call of ``program(*inputs)`` with both RoI ops recorded where the
    models call them -> [(op, site, fmap, rois, args, kwargs)], ``site``
    "det" for the detector's calls and "sgg" for the SGG head's."""
    from i2vsgg_tpu_torch.models import faster_rcnn as frcnn_mod
    from i2vsgg_tpu_torch.models import sgg as sgg_mod
    seen = []

    def rec(op, site, fn):
        def call(features, rois, *a, **k):
            seen.append((op, site, features.detach(), rois, a, k))
            return fn(features, rois, *a, **k)
        return call

    saved = {(m, op): getattr(m, op) for m in (frcnn_mod, sgg_mod)
             for op in ("roi_align_avg", "roi_pool")}
    for (m, op), fn in saved.items():
        setattr(m, op, rec(op.replace("_avg", ""),
                           "det" if m is frcnn_mod else "sgg", fn))
    try:
        program(*inputs)
    finally:
        for (m, op), fn in saved.items():
            setattr(m, op, fn)
    torch.cuda.synchronize()
    return seen


def held_roi_site(op, fmap, rois, a, k, what: str) -> dict:
    """One recorded RoI call held to its plain version on its own inputs
    (RoIPool ``torch.equal`` in its chosen and per-bin modes; RoIAlignAvg
    within one bf16 ulp, or rtol 1e-5 for an f32 output, and bit-equal to
    its per-cell mode), then timed: the kernel's and the plain version's
    device time and the bound of the work on these inputs. The kernel must
    run staged."""
    from i2vsgg_tpu_torch.ops import roi_align as ra_mod
    from i2vsgg_tpu_torch.ops import roi_pool as rp_mod
    p = a[0] if a else 7
    if op == "roi_pool":
        fn = rp_mod.roi_pool
        err = check_kernel_vs_plain(fmap, rois, what, *a)

        def plain():
            return roi_pool_plain_chunked(fmap, rois, *a)
        nbytes, ops = roi_pool_work(fmap, rois, p)
    else:
        fn = ra_mod.roi_align_avg
        grid, od = k.get("grid"), k.get("out_dtype") or fmap.dtype
        got = fn(fmap, rois, *a, **k)
        f_ref = fmap.to(od)

        def plain():
            return ra_mod.roi_align_avg_plain(f_ref, rois, *a, grid=grid)
        if od == torch.float32:
            err = held_f32(got, plain(), what, float(f_ref.abs().max()))
        else:
            err = held_one_ulp(got, plain(), what)
        if not torch.equal(got, fn(fmap, rois, *a, **k, channel_slice=-1)):
            raise AssertionError(f"{what}: staged != per-cell mode")
        nbytes, ops = roi_align_work(fmap, rois, grid, p)
        if od != fmap.dtype:                 # the f32 output's extra bytes
            nbytes += got.numel() * (od.itemsize - fmap.element_size())
    fn(fmap, rois, *a, **k)
    plan = dict(fn.last_plan)
    if plan["mode"] != "staged":
        raise AssertionError(f"{what}: {plan}")
    bnd, by = bound_of(nbytes, ops, H100_F32_OPS_PER_S)
    return {"fmap": list(fmap.shape), "dtype": str(fmap.dtype),
            "rois": rois.shape[0], "max_abs_err": err,
            "ms": kernel_ms(lambda: fn(fmap, rois, *a, **k), op + "_"),
            "slice_ms": slice_times(lambda sl: fn(
                fmap, rois, *a, **k, channel_slice=sl), op + "_"),
            "plain_ms": kernel_ms(plain, reps=3), "bound_ms": bnd,
            "bound_by": by, "bytes": nbytes, **plan}


def serve_slice8(name, det, sgg, prd, cfg, video, to_input, counters,
                 per_request: dict, card: str, **kw) -> dict:
    """Phase 12's steps for one configuration: the frame program and the
    bucketed program (buckets (4, 8)) over the video, each request's output
    checked and the bucketed program held to the frame program; then each
    RoI call of one request held to its plain version on its own inputs
    and timed (``held_roi_site``), summed per request by op and site."""
    from i2vsgg_tpu_torch import serve
    program = serve.make_frame_program(det, sgg, prd, cfg, **kw)
    outs, times = serve_requests(program, video, to_input, counters,
                                 per_request, f"{name}, frame program")
    for out in outs:
        check_outputs(out, FULL)
    bucketed = serve.make_bucketed_program(det, sgg, prd, cfg,
                                           buckets=(4, 8), **kw)
    bk_outs, bk_times = serve_requests(bucketed, video, to_input, counters,
                                       per_request,
                                       f"{name}, bucketed (4, 8)")
    for out in bk_outs:
        check_outputs(out, FULL)
    worst = bucketed_vs_fused(outs, bk_outs)
    rec = {"ms_per_request": steady_ms(times),
           "bucketed_ms_per_request": steady_ms(bk_times),
           "buckets": [o["bucket"] for o in bk_outs],
           "bucketed_max_rel_prob_diff": worst,
           "valid_detections": int(outs[-1]["det_valid"].sum())}
    log(f"{name}: buckets chosen {rec['buckets']}; detections equal to the "
        f"frame program's, valid pairs' rel_prob within {worst:.3g} (tol "
        f"1e-3); steady {rec['ms_per_request']:.2f} ms/request (bucketed "
        f"{rec['bucketed_ms_per_request']:.2f}), valid detections "
        f"{rec['valid_detections']} [{card}]")
    rec["sites"] = held_request_sites(name, program, to_input(video[-1]),
                                      per_request, card)
    return rec


def held_request_sites(name, program, inputs, per_request: dict,
                       card: str) -> dict:
    """Each RoI call of one request (``program(*inputs)``) held to its
    plain version on its own inputs and timed (``held_roi_site``), summed
    by op and site -> {"<op> <site>": record}. The calls a request makes
    must be ``per_request``'s."""
    sites = {}
    for op, site, fmap, rois, a, k in recorded_roi_sites(program, inputs):
        what = f"{name} {op} {site} site {tuple(fmap.shape)} {fmap.dtype}"
        one = held_roi_site(op, fmap, rois, a, k, what)
        key = f"{op} {site}"
        tot = sites.setdefault(key, dict(
            one, launches_per_request=0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            bytes=0, slice_ms=dict.fromkeys(one["slice_ms"], 0.0)))
        tot["launches_per_request"] += 1
        for f in ("ms", "plain_ms", "bound_ms", "bytes"):
            tot[f] += one[f]
        for sl, v in one["slice_ms"].items():    # None: the slice did not fit
            tot["slice_ms"][sl] = (None if v is None or tot["slice_ms"][sl]
                                   is None else tot["slice_ms"][sl] + v)
        tot["max_abs_err"] = max(tot["max_abs_err"], one["max_abs_err"])
    calls = {op: sum(t["launches_per_request"] for key, t in sites.items()
                     if key.startswith(op + " "))
             for op in ("roi_align", "roi_pool")}
    if calls != {op: per_request[op] for op in calls}:
        raise AssertionError(f"{name}: RoI calls a request {calls}, expected "
                             f"{per_request}")
    for key, t in sites.items():
        by_slice = {k: None if v is None else round(v * 1e3, 2)
                    for k, v in t["slice_ms"].items()}
        log(f"{name} {key}: {t['launches_per_request']} launches a request, "
            f"fmap {tuple(t['fmap'])} {t['dtype']}, {t['rois']} rois a "
            f"launch; {t['ms'] * 1e3:.2f} us of device time a request "
            f"(slice {t['slice']}, {t['smem_bytes']} B of shared memory; by "
            f"slice {by_slice} us), "
            f"plain {t['plain_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: {t['bytes']} B), "
            f"max abs err vs plain {t['max_abs_err']:.3g} [{card}]")
    return sites


def small_card_vs_cpu(name, spec, cfg, extra: dict, per: dict, counters,
                      dev, images, im_info):
    """The frame program of ``spec`` (``build_models(..., **extra)``, seed
    1) on the card and on the CPU (plain kernels), f32 with TF32 off: the
    card's RoI launches must be ``per``, and its output is held to the
    CPU's and to the witness (``whole_program_checks``: detections matched
    first)."""
    from i2vsgg_tpu_torch import serve
    kw = dict(max_det=spec["max_det"], max_per_class=spec["max_per_class"])
    det_c, sgg_c, prd = build_models(spec, cfg,
                                     torch.Generator().manual_seed(1), **extra)
    det_g, sgg_g = copy.deepcopy(det_c), copy.deepcopy(sgg_c)
    ref = serve.make_frame_program(det_c, sgg_c, prd, cfg, device="cpu",
                                   **kw)(images, im_info)
    with tf32_off():
        counters.reset()
        got = serve.make_frame_program(det_g, sgg_g, prd, cfg, device=dev,
                                       **kw)(images, im_info)
        launched = {k: counters.read()[k] for k in per}
        witness, _ = witness_outputs(det_c, sgg_c, det_g, prd, cfg, images,
                                     im_info, dev, **kw)
    if launched != per:
        raise AssertionError(f"{name}: launches {launched}, expected {per}")
    checks = whole_program_checks({k: v.cpu() for k, v in got.items()}, ref,
                                  witness, name)
    for what, err, tol in checks:
        log(f"{name} {what}: {err:.3g} (tol {tol:g})")
    bad = [what for what, err, tol in checks if not err <= tol]
    if bad:
        raise AssertionError(f"{name}, card vs CPU: {bad} out of bounds")
    log(f"{name}: launches on the card {launched}; valid detections "
        f"{int(ref['det_valid'].sum())} of {ref['det_valid'].numel()}")


# ----------------------------------------------------------------------------
# phase 13: the drivers (``python -m i2vsgg_tpu_torch.tools.serve_video``,
# ``...test_sgg``, ``...test_det``) on a devkit written here

# the drivers' command line at full width (FULL's configuration) and at the
# tiny size of tests/test_drivers_e2e.py (TINY_CFG)
DRIVER_FULL = ["--dataset", "MVidVRD", "--net", "res101", "--ic", "--gc",
               "--num_relations", str(FULL["num_rel"]), "--bs",
               str(FULL["frames"]), "--cfg", "TEST.RPN_POST_NMS_TOP_N", "128",
               "TEST.RPN_PRE_NMS_TOP_N", "512"]
DRIVER_TINY = ["--dataset", "MVidVRD", "--net", "res10", "--ic", "--gc",
               "--num_relations", str(FULL["num_rel"]), "--bs", "2",
               "--compute_dtype", "float32", "--vrd_fc_dim", "128",
               "--cfg", "TEST.RPN_PRE_NMS_TOP_N", "100",
               "TEST.RPN_POST_NMS_TOP_N", "16",
               "TEST.MAX_DETECTIONS_PER_IMAGE", "20",
               "TRAIN.MAX_NUM_GT_BOXES", "6", "TRAIN.SCALES", "[96]",
               "TEST.SCALES", "[96]"]
DEVKIT = dict(videos=2, frames=6, height=360, width=640)
# 4:3 frames (480x640, padded to 608x896 at scale 600): a stride-16 map of
# 38x56, inside the chain gate's budget, which the 16:9 frames' 38x76 map
# (608x1216) exceeds
DEVKIT_4_3 = dict(DEVKIT, height=480)


def write_devkit(root: str, seed: int = 0, shape: dict = DEVKIT) -> dict:
    """An MVidVRD-shaped devkit under ``root`` (tests/fixtures.py's layout,
    written with the port's ``write_png``, since this machine has no image
    library): ``shape``'s videos of PNG frames ``vid<v>_<fno>``, 2-3 objects
    a video moving over a noisy background, their VOC XML, the test/val
    split files, a per-frame GT relation pickle and the video-level
    annotation JSON. Returns the two files' paths. (Six frames a video are
    fewer than the ten that Stage C's association keeps a trajectory for:
    the drivers link no video relation here; phase 6d runs Stage C on a
    12-frame video.)"""
    from i2vsgg_tpu_torch.data.image_io import write_png
    from i2vsgg_tpu_torch.data.voc import VRD_CLASSES
    rs = np.random.RandomState(seed)
    base = os.path.join(root, "MVidVRD")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    h, w, n_f = shape["height"], shape["width"], shape["frames"]
    names, gt_rels, video_ann = [], {}, {}
    for v in range(shape["videos"]):
        vid = f"vid{v:02d}"
        n_obj = rs.randint(2, 4)
        cls = rs.randint(1, len(VRD_CLASSES), n_obj)
        size = rs.randint(h // 6, h // 2, (n_obj, 2))          # (bh, bw)
        start = rs.uniform(0, 1, (n_obj, 2)) * (
            np.asarray([w, h]) - size[:, ::-1])
        vel = rs.uniform(-12, 12, (n_obj, 2))
        color = rs.randint(80, 256, (n_obj, 3))
        trajs = [[] for _ in range(n_obj)]
        for f in range(n_f):
            index = f"{vid}_{f:04d}"
            im = rs.randint(0, 60, (h, w, 3)).astype(np.uint8)
            xml = ["<annotation>", f"<size><width>{w}</width><height>{h}"
                   "</height><depth>3</depth></size>"]
            for o in range(n_obj):
                bh, bw = size[o]
                x1, y1 = np.clip(start[o] + vel[o] * f, 0,
                                 [w - bw, h - bh]).astype(int)
                im[y1:y1 + bh, x1:x1 + bw] = color[o]
                box = [int(x1), int(y1), int(x1 + bw - 1), int(y1 + bh - 1)]
                trajs[o].append([float(c) for c in box])
                xml += ["<object>", f"<name>{VRD_CLASSES[cls[o]]}</name>",
                        "<difficult>0</difficult>", "<bndbox>"]
                xml += [f"<{k}>{c + 1}</{k}>" for k, c in
                        zip(("xmin", "ymin", "xmax", "ymax"), box)]
                xml += ["</bndbox>", "</object>"]
            xml.append("</annotation>")
            write_png(os.path.join(base, "JPEGImages", index + ".png"), im)
            with open(os.path.join(base, "Annotations", index + ".xml"),
                      "w") as fh:
                fh.write("\n".join(xml))
            gt_rels[index] = [(0, int(rs.randint(FULL["num_rel"])), 1)]
            names.append(index)
        video_ann[vid] = [{"triplet": [int(cls[0]), 0, int(cls[1])],
                           "duration": [0, n_f], "sub_traj": trajs[0],
                           "obj_traj": trajs[1]}]
    for split in ("test", "val", "trainval"):
        with open(os.path.join(base, "ImageSets", "Main", split + ".txt"),
                  "w") as fh:
            fh.write("\n".join(names) + "\n")
    paths = {"gt_rels": os.path.join(base, "target_gt_rels.pkl"),
             "video_ann": os.path.join(base, "video_annotations.json")}
    with open(paths["gt_rels"], "wb") as fh:
        pickle.dump(gt_rels, fh)
    with open(paths["video_ann"], "w") as fh:
        json.dump(video_ann, fh)
    return paths


def png_decode_ms(frame: np.ndarray, d: str) -> dict:
    """Host ms to decode ``frame`` written with each PNG row filter (the
    least of 3 reads), checked equal to the frame."""
    from i2vsgg_tpu_torch.data.image_io import imread_bgr, write_png
    out = {}
    for ft, name in enumerate(("none", "sub", "up", "average", "paeth")):
        path = os.path.join(d, f"filter{ft}.png")
        write_png(path, frame, ft)
        best = float("inf")
        for _ in range(3):
            t = time.time()
            got = imread_bgr(path)
            best = min(best, 1e3 * (time.time() - t))
        if not np.array_equal(got, frame):
            raise AssertionError(f"PNG filter {name}: decoded != written")
        out[name] = best
    return out


@contextlib.contextmanager
def recorded_programs():
    """Within the block, every program that ``serve.make_frame_program`` /
    ``make_bucketed_program`` returns records each call's output (on the
    CPU) and host ms (through the copy, which waits for the card). Yields
    the list of (output, ms)."""
    from i2vsgg_tpu_torch import serve
    calls = []
    saved = {n: getattr(serve, n) for n in ("make_frame_program",
                                            "make_bucketed_program")}

    def wrap(make):
        def made(*a, **k):
            program = make(*a, **k)

            def recorded(*x):
                t = time.time()
                out = {key: v.cpu() if torch.is_tensor(v) else v
                       for key, v in program(*x).items()}
                calls.append((out, 1e3 * (time.time() - t)))
                return out
            return recorded
        return made

    for n, fn in saved.items():
        setattr(serve, n, wrap(fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(serve, n, fn)


@contextlib.contextmanager
def recorded_detection_outputs():
    """Within the block, the arguments of each ``detection_output`` call
    of the port's ``serve_video`` (through ``serve.frame_relation_tuples``)
    and ``test_sgg`` (``video.metrics``): one a frame."""
    from i2vsgg_tpu_torch import serve
    from i2vsgg_tpu_torch.video import metrics
    calls, fn = [], metrics.detection_output

    def rec(*a, **k):
        calls.append([np.array(x) for x in a])
        return fn(*a, **k)

    serve.detection_output = metrics.detection_output = rec
    try:
        yield calls
    finally:
        serve.detection_output = metrics.detection_output = fn


def driver_launches(counters, what: str, fn, expect: dict, n: int):
    """Run ``fn`` (one driver run) with the launch counters set to 0 just
    before and read just after: they must be ``expect`` per unit for ``n``
    units (requests, steps, images), every RoI launch staged. Returns fn's
    result and the counts."""
    counters.reset()
    ret = fn()
    torch.cuda.synchronize()
    got = counters.read()
    want = {k: v * n for k, v in expect.items()}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want}")
    for k, by_mode in counters.modes().items():
        if by_mode["staged"] != got[k]:
            raise AssertionError(f"{what}: {k} launches by mode {by_mode}: "
                                 "not all staged")
    log(f"{what}: launches {n} x "
        f"{ {k: v // n for k, v in got.items() if v} }")
    return ret, got


def same_driver_frames(json_path: str, outs: list, what: str):
    """The driver's ``frame_detections.json`` against the tuples of the
    in-process outputs ``outs`` (one per batch of ``b`` frames, in the
    devkit's frame order): equal after a JSON round trip."""
    from i2vsgg_tpu_torch import serve
    with open(json_path) as fh:
        written = json.load(fh)
    frames = [t for vid in sorted(written) for _, t in written[vid]]
    mine = [serve.frame_relation_tuples(o, f) for o in outs
            for f in range(o["det_valid"].shape[0])]
    if json.loads(json.dumps(mine)) != frames:
        raise AssertionError(f"{what}: frame_detections.json != the tuples "
                             "of the in-process outputs")


# 13d's card-vs-CPU limits, just above what two runs measured on an H100
# (boxes 1.42e-3 px, scores 0, rel_prob 1.12e-8; PERF.md section 6): f32
# with TF32 off leaves only the summation order to differ
TINY_TOL = {"boxes": 1e-2, "scores": 1e-6, "rel_prob": 1e-6}


def matched_driver_outputs(card: list, cpu: list, what: str) -> dict:
    """The tiny driver's per-batch program outputs on the card against the
    CPU's: detections matched first (``matched_order``), then validity,
    classes and pairs equal, boxes, scores and rel_prob within
    ``TINY_TOL``. Returns the largest differences."""
    worst = {"boxes": 0.0, "scores": 0.0, "rel_prob": 0.0}
    for g, c in zip(card, cpu):
        mine = reordered(g, matched_order(g, c))
        for k in ("det_valid", "classes", "pair_valid"):
            if not torch.equal(mine[k], c[k]):
                raise AssertionError(f"{what} {k}: card != CPU")
        valid = c["det_valid"]
        for k in worst:
            gap = (mine[k].float() - c[k].float()).abs()
            if k != "rel_prob":
                gap = gap * (valid[..., None] if k == "boxes" else valid)
            worst[k] = max(worst[k], float(gap.max()))
    for k, tol in TINY_TOL.items():
        if not worst[k] <= tol:
            raise AssertionError(f"{what} {k}: card vs CPU {worst[k]} > "
                                 f"{tol}")
    return worst


@contextlib.contextmanager
def env_set(env: dict):
    """Within the block, the environment variables of ``env`` set."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def held_conv1_planes(det, planes: torch.Tensor, h: int, w: int,
                      what: str, card: str) -> dict:
    """The conv1 stem (B3) on served parity planes of h x w frames, held
    to its plain version within one bf16 ulp (phase 3b's bound) and timed
    as the trunk calls it, beside its bound and the library call (phase 7's:
    cuDNN's bf16 conv with the BN scale folded and the shift as bias, on
    bf16 images of the planes' shape)."""
    from i2vsgg_tpu_torch.ops import conv1 as c1
    weight = det.trunk.conv1.weight.detach()
    mul, add = det.trunk.bn1.affine()
    b = planes.shape[0]
    xb = torch.randn(b, h, w, 3, device=planes.device).to(
        torch.bfloat16).permute(0, 3, 1, 2)     # NCHW view, channels-last
    wf = c1.fold_v2_weight(weight, mul).contiguous(
        memory_format=torch.channels_last)
    bias = add.to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
        xb, wf, bias, stride=2, padding=3), 50)
    err = held_one_ulp(c1.conv1_stem_planes(planes, h, w, weight, mul, add),
                       c1.conv1_stem_planes_plain(planes, h, w, weight, mul,
                                                  add), what)
    prep = det.trunk.conv1_weights()
    k_ms = cuda_ms(lambda: c1.conv1_apply(planes, prep, (h, w), True), 50)
    p_ms = cuda_ms(lambda: c1.conv1_stem_planes_plain(
        planes, h, w, weight, mul, add), 5, 1)
    nbytes, flops = conv1_work(planes, planes.shape[0], h, w)
    bnd, by = bound_of(nbytes, flops, H100_BF16_OPS_PER_S)
    log(f"{what}: planes {tuple(planes.shape)}, max abs err vs plain "
        f"{err:.3g} (one bf16 ulp); kernel {k_ms * 1e3:.2f} us, plain "
        f"{p_ms * 1e3:.2f} us, cuDNN bf16 conv (+ affine) "
        f"{lib_ms * 1e3:.2f} us, bound {bnd * 1e3:.3f} us ({by}: {nbytes} "
        f"B, {flops} flop) [{card}]")
    return {"planes": list(planes.shape), "image_hw": [h, w],
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": bnd, "bound_by": by,
            "bytes": nbytes}


def held_chain_calls(program, inputs, what: str, card: str) -> list:
    """One call of ``program(*inputs)`` with each bottleneck chain (B4)
    call recorded where the stages make it; each held to its plain version
    and timed beside its bound. At each call's shape: its first block on
    the map zero-padded by 4 columns (the 3x3's own padding) gives the
    same columns, bit for bit; two blocks of random weights on a random
    map are held as phase 3d holds the chain (``held_chain``); and the
    call on its own inputs is held with the plain version's excess over
    f64 taken over the call (``excess_of="call"``)."""
    from i2vsgg_tpu_torch.models import backbones
    from i2vsgg_tpu_torch.ops import bottleneck as chain_mod
    kern, plain = chain_mod.bottleneck_chain, chain_mod.bottleneck_chain_plain
    seen = []

    def rec(x, *wts):
        seen.append((x, wts))
        return kern(x, *wts)

    backbones.bottleneck_chain = rec
    try:
        program(*inputs)
    finally:
        backbones.bottleneck_chain = kern
    torch.cuda.synchronize()
    out = []
    for x, wts in seen:
        name = f"{what}: chain of {wts[0].shape[0]} blocks on {tuple(x.shape)}"
        one = tuple(t[:1] for t in wts)
        padded = kern(torch.nn.functional.pad(x, (0, 0, 0, 4)), *one)
        if not torch.equal(padded[:, :, :x.shape[2]], kern(x, *one)):
            raise AssertionError(f"{name}: the map padded by 4 zero columns "
                                 "gives other columns")
        rx, rw = chain_test_case(x.device, *x.shape, wts[0].shape[2], 2, 0)
        held_chain(kern, rx, rw, f"{name}, random inputs of its shape",
                   quiet=True)
        check = held_chain(kern, x, wts, name, excess_of="call")
        k_ms = cuda_ms(lambda: kern(x, *wts), 20)
        with tf32_off():
            p_ms = cuda_ms(lambda: plain(x, *wts), 3, 1)
        nbytes, flops = chain_work(x, wts[0], wts[2], wts[4],
                                   (wts[1], wts[3], wts[5]))
        bnd, by = bound_of(nbytes, flops, H100_BF16_OPS_PER_S)
        log(f"{name}: kernel {k_ms:.3f} ms ({100 * bnd / k_ms:.1f} % of its "
            f"bound), plain (f32) {p_ms:.3f} ms, bound {bnd:.3f} ms ({by}: "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) [{card}]")
        out.append({"x": list(x.shape), "blocks": wts[0].shape[0],
                    "max_abs_err": check["max_abs_err"], "check": check,
                    "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": bnd, "bound_by": by,
                    "bytes": nbytes, "flops": flops})
    return out


def drivers_on_card(dev, counters, card: str, work: str) -> dict:
    """Phase 13: the port's drivers on this card (13a-13d; see the module
    docstring), their devkits and checkpoints under ``work`` (phase 17c
    serves them again; the caller removes it). Returns the phase's record,
    with those files under ``"files"``."""
    from i2vsgg_tpu_torch import serve
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.data.image_io import imread_bgr
    from i2vsgg_tpu_torch.data.pipeline import DetectionLoader, prep_image
    from i2vsgg_tpu_torch.data.roidb import combined_roidb
    from i2vsgg_tpu_torch.models.glove import load_predicate_vectors
    from i2vsgg_tpu_torch.ops.conv1 import Conv1Planes
    from i2vsgg_tpu_torch.tools import serve_video, test_det, test_sgg
    from i2vsgg_tpu_torch.tools.common import config_from_args
    from i2vsgg_tpu_torch.train.checkpoint import save_checkpoint
    from i2vsgg_tpu_torch.utils.params import bf16_storage_cast
    rec = {}
    b = FULL["frames"]
    n_frames = DEVKIT["videos"] * DEVKIT["frames"]
    n_req = n_frames // b
    saved_env = os.environ.get("I2VSGG_DATA_ROOT")
    saved_det = torch.backends.cudnn.deterministic
    try:
        phase("13a the dataset: an MVidVRD devkit of 2 videos x 6 PNG "
              "frames, 360x640, written with image_io.write_png; the Python "
              "path's decode and resize timed (phase 18 times the native "
              "loader)")
        t = time.time()
        os.environ["I2VSGG_DATA_ROOT"] = os.path.join(work, "data")
        paths = write_devkit(os.environ["I2VSGG_DATA_ROOT"])
        frame = imread_bgr(os.path.join(
            os.environ["I2VSGG_DATA_ROOT"], "MVidVRD", "JPEGImages",
            "vid00_0000.png"))
        rec["png_decode_ms"] = png_decode_ms(frame, work)
        t_r = time.time()
        resized, _ = prep_image(frame, 600, (102.9801, 115.9465, 122.7717))
        rec["resize_ms"] = 1e3 * (time.time() - t_r)
        log(f"devkit written in {time.time() - t:.2f} s; host PNG decode of "
            f"a 360x640 frame by row filter "
            f"{ {k: round(v, 2) for k, v in rec['png_decode_ms'].items()} } "
            f"ms, resize to {resized.shape[:2]} {rec['resize_ms']:.2f} ms "
            f"(host CPU of the machine of {card})")

        phase("13b serve_video at full width (res101 ic+gc, 16 classes, 26 "
              "predicates, fc 4096, scale 600, rpn 128/512, max_det 8, bs 4) "
              "from the port's checkpoints: default (RoIPool at the SGG "
              "site), --host_planes, --buckets 4,8, and --bf16_weights with "
              "I2VSGG_PALLAS_BOTTLENECK=1 on 4:3 frames; each held bit for "
              "bit to the frame program in-process on the same loader "
              "batches, and each kernel at the drivers' shapes held to its "
              "plain version")
        # the comparison needs one cuDNN algorithm per shape in both runs
        torch.backends.cudnn.deterministic = True
        roots = {"16:9": os.environ["I2VSGG_DATA_ROOT"],
                 "4:3": os.path.join(work, "data_4_3")}
        write_devkit(roots["4:3"], seed=1, shape=DEVKIT_4_3)
        args = set_dataset_args(parse_args(DRIVER_FULL), test=True)
        cfg = config_from_args(args)
        prd = load_predicate_vectors(args)
        t = time.time()
        det, sgg, _ = build_models(FULL, cfg,
                                   torch.Generator().manual_seed(13))
        ck = os.path.join(work, "ckpt")
        save_checkpoint(os.path.join(ck, "det"), det.state_dict(), 1,
                        {"pooling_mode": cfg.POOLING_MODE})
        sgg_sd = {f"trunk.{k}": v for k, v in det.trunk.state_dict().items()}
        sgg_sd.update(sgg.state_dict())
        save_checkpoint(os.path.join(ck, "sgg"), sgg_sd, 1,
                        {"vrd_pooling": "pool"})
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(ck) for f in fs)
        # the driver's --bf16_weights: restored f32, then stored in bf16
        det_b, sgg_b = (bf16_storage_cast(copy.deepcopy(m))
                        for m in (det, sgg))
        log(f"weights built and saved in {time.time() - t:.2f} s "
            f"({size / 2**30:.2f} GiB)")
        det_ck, sgg_ck = (os.path.join(ck, n, "1") for n in ("det", "sgg"))
        kw = dict(max_det=FULL["max_det"], device=dev)
        per_roi = {"roi_align": 2, "roi_pool": b}
        rec["serve"] = {}
        chain = {"I2VSGG_PALLAS_BOTTLENECK": "1"}
        for name, extra, env, frames in (
                ("default", [], {}, "16:9"),
                ("host_planes", ["--host_planes"], {}, "16:9"),
                ("buckets 4,8", ["--buckets", "4,8"], {}, "16:9"),
                ("bf16 weights, chain", ["--bf16_weights"], chain, "4:3")):
            os.environ["I2VSGG_DATA_ROOT"] = roots[frames]
            _, roidb, _, idx = combined_roidb(
                args.imdbval_name, training=False, use_flipped=False)
            batches = list(DetectionLoader(roidb, idx, cfg, b,
                                           training=False))
            hp, wp = batches[0]["image"].shape[1:3]
            models = (det_b, sgg_b) if "--bf16_weights" in extra else (det,
                                                                       sgg)
            expect = dict(NO_LAUNCHES, **per_roi)
            if name == "host_planes":
                expect["conv1"] = 1
            out_dir = os.path.join(work, "out", name.replace(" ", "_")
                                   .replace(",", ""))
            argv = DRIVER_FULL + ["--load_name", det_ck, "--sgg_load_name",
                                  sgg_ck, "--max_det", str(FULL["max_det"]),
                                  "--save_dir", out_dir] + extra
            with env_set(env):
                if env:
                    expect["bottleneck"] = 3 * fused_tail_blocks(
                        models[0].trunk, hp, wp)
                    if not expect["bottleneck"]:
                        raise AssertionError(f"{name}: the gate fuses no "
                                             f"stage at {hp}x{wp}")
                t = time.time()
                with recorded_programs() as calls:
                    rels, launched = driver_launches(
                        counters, f"serve_video {name}",
                        lambda: serve_video.main(argv), expect, n_req)
                wall = time.time() - t
                if name.startswith("buckets"):
                    program = serve.make_bucketed_program(
                        *models, prd, cfg, buckets=(4, 8), **kw)
                else:
                    program = serve.make_frame_program(*models, prd, cfg,
                                                       **kw)
                mine = []
                for batch, (out, _) in zip(batches, calls):
                    x = batch["image"]
                    if name == "host_planes":
                        x = Conv1Planes.pack(x)
                    mine.append({k: v.cpu() if torch.is_tensor(v) else v
                                 for k, v in program(x, batch["im_info"])
                                 .items()})
                    same_outputs(out, mine[-1], f"serve_video {name} vs the "
                                 "in-process frame program")
                    if out.get("bucket") != mine[-1].get("bucket"):
                        raise AssertionError(
                            f"serve_video {name}: bucket {out.get('bucket')}"
                            f" in-process {mine[-1].get('bucket')}")
                    if out.get("bucket", FULL["max_det"]) == FULL["max_det"]:
                        check_outputs(out, FULL)
                if len(mine) != n_req or len(calls) != n_req:
                    raise AssertionError(f"serve_video {name}: {len(calls)} "
                                         "requests served")
                # the kernels at the shapes this run gave them, on the last
                # request's own inputs
                what = f"13b {name} ({hp}x{wp} frames)"
                held = {}
                if name == "host_planes":
                    held["conv1"] = held_conv1_planes(
                        models[0], x.to(dev).planes, hp, wp,
                        f"{what} conv1 stem", card)
                else:
                    held["sites"] = held_request_sites(
                        what, program, (x, batch["im_info"]), per_roi, card)
                if env:
                    held["chain"] = held_chain_calls(
                        program, (x, batch["im_info"]), what, card)
                    if (3 * sum(c["blocks"] for c in held["chain"])
                            != expect["bottleneck"]):
                        raise AssertionError(f"{what}: chain calls "
                                             f"{held['chain']}")
            rel = os.path.join(out_dir, "serve", "MVidVRD_test")
            same_driver_frames(os.path.join(rel, "frame_detections.json"),
                               mine, f"serve_video {name}")
            with open(os.path.join(rel, "video_relations.json")) as fh:
                if json.load(fh) != json.loads(json.dumps(rels)):
                    raise AssertionError("video_relations.json != the "
                                         "driver's return")
            ms = [m for _, m in calls]
            r = {"frames_hw": [hp, wp],
                 "launches": {k: v // n_req for k, v in launched.items()
                              if v},
                 "request_ms": ms, "wall_s": wall,
                 "fps": 1e3 * n_frames / sum(ms),
                 "fps_after_first": 1e3 * b * (n_req - 1) / sum(ms[1:]),
                 "video_relations": sum(len(v) for v in rels.values()),
                 "buckets": [o.get("bucket") for o, _ in calls], **held}
            rec["serve"][name] = r
            log(f"serve_video {name}: outputs bit-equal to the in-process "
                f"frame program, frame_detections.json equal to its tuples; "
                f"request ms {', '.join(f'{m:.2f}' for m in ms)}; host-side "
                f"{r['fps']:.2f} frames/s ({r['fps_after_first']:.2f} after "
                f"the first request), {wall:.2f} s for the whole run with "
                f"model build and load; {r['video_relations']} video "
                f"relations [{card}]")
            del program
        os.environ["I2VSGG_DATA_ROOT"] = roots["16:9"]
        del det, sgg, det_b, sgg_b
        torch.cuda.empty_cache()

        phase("13c the evaluation drivers on the same devkit: test_sgg (GT "
              "boxes, res101 trunk, SGG head on RoIPool) and test_det")
        out_dir = os.path.join(work, "out", "eval")
        metrics, sgg_launched = driver_launches(
            counters, "test_sgg", lambda: test_sgg.main(
                DRIVER_FULL + ["--load_name", sgg_ck, "--video_ann",
                               paths["video_ann"], "--save_dir", out_dir]),
            dict(NO_LAUNCHES, roi_pool=b), n_req)
        ev = os.path.join(out_dir, "eval", "MVidVRD_test_SGG")
        for f in ("frame_detections.json", "video_relations.json"):
            with open(os.path.join(ev, f)) as fh:
                json.load(fh)
        aps, det_launched = driver_launches(
            counters, "test_det", lambda: test_det.main(
                DRIVER_FULL + ["--load_name", det_ck, "--save_dir",
                               out_dir]),
            dict(NO_LAUNCHES, roi_align=2), n_req)
        ev = os.path.join(out_dir, "eval", "MVidVRD_test")
        with open(os.path.join(ev, "detections.pkl"), "rb") as fh:
            if len(pickle.load(fh)) != 16:
                raise AssertionError("detections.pkl: not 16 classes")
        results = [f for f in os.listdir(os.path.join(ev, "adapt"))
                   if f.startswith("det_test_")]
        if len(results) != 15:
            raise AssertionError(f"test_det wrote {len(results)} result "
                                 "files, not 15")
        rec["test_sgg"] = {"mAP": float(metrics[0]),
                           "recall": {str(k): float(v) for k, v in
                                      metrics[1].items()},
                           "launches": {k: v // n_req for k, v in
                                        sgg_launched.items() if v}}
        rec["test_det"] = {"mAP": float(aps["mAP"]),
                           "launches": {k: v // n_req for k, v in
                                        det_launched.items() if v}}
        log(f"test_sgg: relation mAP {metrics[0]:.4f}, recall "
            f"{rec['test_sgg']['recall']}; test_det: mAP "
            f"{rec['test_det']['mAP']:.4f} "
            "(random weights: printed, not held)")

        phase("13d the same drivers at the tiny configuration (res10, 96 px, "
              "TINY_CFG): card vs CPU, TF32 off")
        args_t = set_dataset_args(parse_args(DRIVER_TINY), test=True)
        cfg_t = config_from_args(args_t)
        spec = dict(SMALL, num_classes=16, num_rel=FULL["num_rel"],
                    fc_dim=128, emb_dim=300)
        det_t, sgg_t, _ = build_models(spec, cfg_t,
                                       torch.Generator().manual_seed(14))
        with torch.no_grad():
            det_t.rpn.bbox_pred.weight.mul_(0.1)
            det_t.bbox_pred.weight.mul_(0.1)
        save_checkpoint(os.path.join(ck, "det_tiny"), det_t.state_dict(), 1)
        sd = {f"trunk.{k}": v for k, v in det_t.trunk.state_dict().items()}
        sd.update(sgg_t.state_dict())
        save_checkpoint(os.path.join(ck, "sgg_tiny"), sd, 1)
        tiny = {}
        for where in ("cuda", "cpu"):
            argv = DRIVER_TINY + [
                "--load_name", os.path.join(ck, "det_tiny", "1"),
                "--sgg_load_name", os.path.join(ck, "sgg_tiny", "1"),
                "--max_det", "4", "--device", where,
                "--save_dir", os.path.join(work, "tiny", where)]
            with tf32_off(), recorded_programs() as calls:
                serve_video.main(argv)
            argv = DRIVER_TINY + [
                "--load_name", os.path.join(ck, "sgg_tiny", "1"),
                "--video_ann", paths["video_ann"], "--device", where,
                "--save_dir", os.path.join(work, "tiny", where)]
            with tf32_off(), recorded_detection_outputs() as dets:
                test_sgg.main(argv)
            tiny[where] = ([o for o, _ in calls], dets)
        worst = matched_driver_outputs(tiny["cuda"][0], tiny["cpu"][0],
                                       "tiny serve_video")
        worst_sgg = 0.0
        for g, c in zip(*(tiny[w][1] for w in ("cuda", "cpu"))):
            for k in (1, 2, 4, 5):                # boxes, classes, pairs
                if not np.array_equal(g[k], c[k]):
                    raise AssertionError("tiny test_sgg: GT boxes, classes "
                                         "or pairs differ")
            worst_sgg = max(worst_sgg, float(np.abs(g[0] - c[0]).max()))
        if not worst_sgg <= TINY_TOL["rel_prob"]:
            raise AssertionError(f"tiny test_sgg rel_prob: card vs CPU "
                                 f"{worst_sgg} > {TINY_TOL['rel_prob']}")
        rec["tiny"] = dict(worst, test_sgg_rel_prob=worst_sgg)
        rec["files"] = {
            "data": roots["16:9"], "det": det_ck, "sgg": sgg_ck,
            "default_out": os.path.join(work, "out", "default"),
            "det_tiny": os.path.join(ck, "det_tiny", "1"),
            "sgg_tiny": os.path.join(ck, "sgg_tiny", "1")}
        log(f"tiny serve_video: validity, classes and pairs equal after "
            f"matching; boxes {worst['boxes']:.3g} px, scores "
            f"{worst['scores']:.3g}, rel_prob {worst['rel_prob']:.3g} (tols "
            f"{TINY_TOL}); tiny test_sgg: GT pairs equal, rel_prob "
            f"{worst_sgg:.3g} (tol {TINY_TOL['rel_prob']:g})")
    finally:
        torch.backends.cudnn.deterministic = saved_det
        if saved_env is None:
            os.environ.pop("I2VSGG_DATA_ROOT", None)
        else:
            os.environ["I2VSGG_DATA_ROOT"] = saved_env
    return rec


# ----------------------------------------------------------------------------
# phase 14: Stage A training on the card (``train/det_da.py``, the driver
# ``python -m i2vsgg_tpu_torch.tools.trainval_det_da``)

# scripts/instance_styleD_resnet101.sh's run (the MVRD stills, JPEG, as the
# source; the MVidVRD frames, PNG, as the target), with the consistency terms
# on
TRAIN_ARGS = ["--dataset", "MVRD", "--dataset_t", "MVidVRD", "--net",
              "res101", "--ic", "--gc", "--cr", "--lr", "5e-4",
              "--lr_decay_step", "10", "--lr_decay_gamma", "0.1", "--eta",
              "0.1", "--eta_style", "0.001", "--style_lambda", "1", "--bs",
              "1"]
# one source frame (with GT boxes) and one target frame a step, at the
# TRAIN scale 600 and max side 1000
TRAIN_FRAME = dict(height=600, width=1000, objects=4, num_classes=16)
TRAIN_STEPS = 4
# test_det on 14c's checkpoint
EVAL_ARGS = ["--dataset", "MVidVRD", "--net", "res101", "--ic", "--gc",
             "--bs", "4"]
# 14d, the tiny step card vs CPU (f32, TF32 off): limits just above what
# the runs measured (PERF.md §6)
TRAIN_TINY_TOL = {"loss_rtol": 5e-6, "grad_frac": 2e-4, "grad_cos": 0.99999}
TRAIN_TINY = dict(backbone="res10", height=64, width=80, frames=2,
                  objects=3, num_classes=6)


def train_frames(spec: dict, seed: int, n_frames: int = 1):
    """Seeded (source, target) batches as the loader makes them: noisy
    dark frames with ``spec["objects"]`` flat-coloured boxes, mean-subtracted
    f32 NHWC; the source carries the boxes as zero-padded GT rows
    ``[x1, y1, x2, y2, cls]`` (``TRAIN.MAX_NUM_GT_BOXES`` 30)."""
    rs = np.random.RandomState(seed)
    h, w = spec["height"], spec["width"]
    means = np.asarray((102.9801, 115.9465, 122.7717), np.float32)
    out = []
    for _ in range(2):
        ims = rs.randint(0, 60, (n_frames, h, w, 3)).astype(np.float32)
        gt = np.zeros((n_frames, 30, 5), np.float32)
        for f in range(n_frames):
            for k in range(spec["objects"]):
                bh, bw = rs.randint(h // 8, h // 2), rs.randint(w // 8, w // 2)
                y, x = rs.randint(0, h - bh), rs.randint(0, w - bw)
                ims[f, y:y + bh, x:x + bw] = rs.randint(80, 256, 3)
                gt[f, k] = [x, y, x + bw - 1, y + bh - 1,
                            rs.randint(1, spec["num_classes"])]
        out.append({"image": ims - means,
                    "im_info": np.tile([[h, w, 1.0]], (n_frames, 1)).astype(
                        np.float32),
                    "gt_boxes": gt})
    src, tgt = out
    del tgt["gt_boxes"]
    return src, tgt


def training_model(cfg, spec: dict, seed: int):
    """The Stage A training tree (ic+gc) of ``spec["backbone"]``, filled by
    the port's training inits (``models/inits.py``) on the CPU."""
    from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
    from i2vsgg_tpu_torch.models.inits import init_module
    det = FasterRCNN_DA(spec["num_classes"], cfg, spec["backbone"], ic=True,
                        gc=True, training_tree=True)
    return init_module(det, torch.Generator().manual_seed(seed))


@torch.no_grad()
def calibrate_frozen_bn(det, images, im_info):
    """Set every FrozenBatchNorm's statistics to those of its input on these
    frames (one inference pass, each BN set just before it runs), as a
    pretrained trunk's would be: with the identity statistics of a fresh
    init, a res101's activations grow block by block and its first SGD
    steps blow the losses up. Its affine stays the identity."""
    from i2vsgg_tpu_torch.models.backbones import FrozenBatchNorm

    def hook(bn, inputs):
        x = inputs[0].float()
        bn.mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))
    hooks = [m.register_forward_pre_hook(hook) for m in det.modules()
             if isinstance(m, FrozenBatchNorm)]
    try:
        det.inference(images, im_info)
    finally:
        for h in hooks:
            h.remove()


def profiled_step(fn) -> dict:
    """One call of ``fn`` (a training step) under ``torch.profiler``: its
    host ms (inflated by the profiler), the device ms summed over its
    kernels, their launches, the busy share and the kernels with the most
    device time. A window in which the profiler saw no kernel (it happens,
    ``profiled_ms``) reads 0 device ms, logged as such."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t)
    kern, n = {}, 0
    for e in prof.key_averages():
        if e.device_time_total > 0:
            kern[e.key] = e.device_time_total / 1e3
            n += e.count
    device_ms = sum(kern.values())
    return {"host_ms": host_ms, "device_ms": device_ms, "launches": n,
            "busy_share": device_ms / host_ms,
            "top": sorted(kern.items(), key=lambda kv: -kv[1])[:10]}


def train_full(name: str, pooling: str, dev, counters, card: str) -> dict:
    """14a/14b: ``TRAIN_STEPS`` steps of the port's train step at full
    width (``TRAIN_ARGS``: res101 ic+gc+cr, bf16 compute, f32 params; the
    port's training inits with the FrozenBN statistics calibrated on the
    source frame, ``calibrate_frozen_bn``) on one seeded source and target
    frame of ``TRAIN_FRAME``, under
    ``POOLING_MODE=pooling``. Each step's kernel launches (2 of the RoI
    kernel: the source's and the target's pooling; no other kernel) are
    counted; the losses must be finite; afterwards the frozen params and
    every buffer are bit-unchanged and every other param moved. Every RoI
    call of the last step is held to its plain version at its own inputs
    and timed (``held_roi_site``), beside the plain backward's device time
    and the proposals' (two NMS a step) share of the step."""
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.ops import roi_align as ra_mod
    from i2vsgg_tpu_torch.ops import roi_pool as rp_mod
    from i2vsgg_tpu_torch.tools.common import config_from_args
    from i2vsgg_tpu_torch.train.det_da import TrainState, train_step
    from i2vsgg_tpu_torch.train.optim import ReferenceSGD
    args = set_dataset_args(parse_args(TRAIN_ARGS))
    cfg = config_from_args(args).replace(POOLING_MODE=pooling)
    op = "roi_align" if pooling == "align" else "roi_pool"
    t = time.time()
    det = training_model(cfg, dict(TRAIN_FRAME, backbone="res101"), 14)
    opt = ReferenceSGD(det, args.lr, cfg)
    det.to(dev)
    state = TrainState(det, opt, seed=14)
    src, tgt = (
        {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        for b in train_frames(TRAIN_FRAME, 14))
    calibrate_frozen_bn(det, src["image"], src["im_info"])
    before = {k: v.detach().clone() for k, v in det.state_dict().items()}
    frozen = {n for n, p in det.named_parameters() if not p.requires_grad}
    log(f"res101 training tree built ({sum(p.numel() for p in det.parameters())} "
        f"params, {len(frozen)} frozen) in {time.time() - t:.2f} s")
    loss_kw = dict(eta=args.eta, eta_style=args.eta_style,
                   style_lambda=args.style_lambda, cr=args.cr)
    steps = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        out = []
        counters.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == TRAIN_STEPS - 1:
            calls = recorded_roi_sites(
                lambda: out.append(train_step(state, src, tgt, **loss_kw)),
                ())
        else:
            out.append(train_step(state, src, tgt, **loss_kw))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        m = out[0]
        got = counters.read()
        if got != dict(NO_LAUNCHES, **{op: 2}):
            raise AssertionError(f"{name} step {i + 1}: launches {got}; "
                                 f"expected 2 of {op} and nothing else")
        rec = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"{name} step {i + 1}: {rec}")
        steps.append(dict(rec, ms=ms))
        log(f"{name} step {i + 1}: {ms:.1f} ms, loss {rec['loss']:.4f} "
            f"(rpn_cls {rec['loss_rpn_cls']:.4f} rpn_box "
            f"{rec['loss_rpn_box']:.4f} rcnn_cls {rec['loss_rcnn_cls']:.4f} "
            f"rcnn_box {rec['loss_rcnn_box']:.4f} d_s {rec['dloss_s_p']:.4f}"
            f" d_t {rec['dloss_t_p']:.4f} cst {rec['loss_s_cst']:.4f}/"
            f"{rec['loss_t_cst']:.4f}), fg rois {int(rec['fg_cnt'])}")
    peak = torch.cuda.max_memory_allocated()
    after = det.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    params = {n for n, _ in det.named_parameters()}
    still = params - frozen - moved
    if moved - params or moved & frozen or still:
        raise AssertionError(
            f"{name}: buffers or frozen params moved "
            f"{sorted((moved - params) | (moved & frozen))[:5]}, trainable "
            f"params unchanged {sorted(still)[:5]}")
    if len(calls) != 2:
        raise AssertionError(f"{name}: {len(calls)} RoI calls recorded")
    profiled = profiled_step(lambda: train_step(state, src, tgt, **loss_kw))
    log(f"{name}, a fifth step under torch.profiler: {profiled['host_ms']:.1f}"
        f" ms of host time, {profiled['device_ms']:.2f} ms of device time in "
        f"{profiled['launches']} kernel launches (busy share "
        f"{profiled['busy_share']:.3f}); most device time: "
        f"{[(k[:40], round(v, 2)) for k, v in profiled['top'][:5]]}")
    sites, bwd = [], []
    for (_, _, fmap, rois, a, k), which in zip(calls, ("source", "target")):
        what = f"{name} {op} {which} ({rois.shape[0]} rois)"
        sites.append(dict(held_roi_site(op, fmap, rois, a, k, what),
                          site=which))
        g = torch.randn(rois.shape[0], 7, 7, fmap.shape[-1], device=dev,
                        dtype=fmap.dtype)
        if op == "roi_align":
            def backward():
                return ra_mod.roi_align_avg_backward(
                    g, rois, tuple(fmap.shape), fmap.dtype, *a)
        else:
            def backward():
                return rp_mod.roi_pool_backward(g, fmap, rois, *a)
        bwd.append(kernel_ms(backward, reps=3))
        s = sites[-1]
        log(f"{what}: kernel {s['ms'] * 1e3:.2f} us of device time, plain "
            f"{s['plain_ms'] * 1e3:.2f} us, bound {s['bound_ms'] * 1e3:.3f} "
            f"us ({s['bound_by']}); the plain backward "
            f"{bwd[-1] * 1e3:.2f} us [{card}]")
    # the proposals of a step (the source's and the target's NMS over the
    # 12000 top anchors), on the last step's weights
    with torch.no_grad():
        base_feat, _ = det.trunk(src["image"])
        rpn_out = det.rpn(base_feat)
        prop_ms = {w: cuda_ms(lambda: det.proposals(
            base_feat, *rpn_out, src["im_info"], training=True,
            target=w == "target"), 3, 1) for w in ("source", "target")}
    step_ms = float(np.mean([s["ms"] for s in steps[1:]]))
    rec = {"steps": steps, "launches_per_step": got[op],
           "profiled_step": profiled,
           "step_ms": step_ms, "images_per_s": 1e3 / step_ms,
           "proposals_ms": prop_ms,
           "proposals_share": sum(prop_ms.values()) / step_ms,
           "sites": sites, "backward_ms": bwd, "peak_bytes": peak,
           "moved": len(moved), "frozen": len(frozen)}
    log(f"{name}: steady step {step_ms:.1f} ms ({rec['images_per_s']:.2f} "
        f"source images/s, one target image each), proposals "
        f"{ {k: round(v, 2) for k, v in prop_ms.items()} } ms "
        f"({100 * rec['proposals_share']:.1f} % of the step), peak "
        f"{peak / 2 ** 30:.2f} GiB; {len(moved)} params moved, "
        f"{len(frozen)} frozen and every buffer bit-unchanged [{card}]")
    del det, opt, state
    torch.cuda.empty_cache()
    return rec


def train_driver_on_card(dev, counters, card: str, work: str) -> dict:
    """14c: ``trainval_det_da`` (``TRAIN_ARGS``, full width, bf16 compute)
    on the paper's pairing under ``work``: the source an MVRD devkit of
    JPEG stills (``write_mvrd_devkit``: 1024x768 and 768x1024 at scale 600,
    600x800 and 800x600), the target a PNG devkit from ``write_devkit``
    (360x640 frames: 600x1067 in a 608x1216 batch); started as a user starts
    it from a detector (``--load_name``: the port's inits with FrozenBN
    statistics calibrated on the first source still, saved in the port's
    format; the heads
    re-initialized): 3 steps, then ``--r`` for 2 more (the step count and
    the lr go on from the checkpoint), then ``test_det`` on the last
    checkpoint, whose files must parse. The record names the last
    checkpoint (``stage_a``, Stage B's start in phase 15) and the devkit's
    files (``devkit``)."""
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.data.image_io import imread_bgr
    from i2vsgg_tpu_torch.data.pipeline import prep_image
    from i2vsgg_tpu_torch.tools import test_det, trainval_det_da
    from i2vsgg_tpu_torch.tools.common import config_from_args
    from i2vsgg_tpu_torch.train.checkpoint import save_checkpoint
    saved_env = os.environ.get("I2VSGG_DATA_ROOT")
    rec = {}
    try:
        os.environ["I2VSGG_DATA_ROOT"] = os.path.join(work, "data")
        devkit = write_devkit(os.environ["I2VSGG_DATA_ROOT"])
        devkit.update(write_mvrd_devkit(os.environ["I2VSGG_DATA_ROOT"]))
        cfg = config_from_args(set_dataset_args(parse_args(TRAIN_ARGS)))
        det = training_model(cfg, dict(TRAIN_FRAME, backbone="res101"), 15)
        # the random detector's FrozenBN statistics, calibrated on the first
        # source still as the loader prepares it
        still, scale = prep_image(imread_bgr(os.path.join(
            os.environ["I2VSGG_DATA_ROOT"], "MVRD", "JPEGImages",
            "img000.jpg")), cfg.TRAIN.SCALES[0], cfg.PIXEL_MEANS)
        calibrate_frozen_bn(det.to(dev),
                            torch.as_tensor(still[None], device=dev),
                            torch.tensor([[*still.shape[:2], scale]],
                                         dtype=torch.float32, device=dev))
        save_checkpoint(os.path.join(work, "init"), det.state_dict(), 0)
        del det
        out = os.path.join(work, "out")
        common = TRAIN_ARGS + ["--save_dir", out, "--disp_interval", "1"]
        counters.reset()
        t = time.time()
        state = trainval_det_da.main(common + [
            "--max_steps", "3", "--load_name",
            os.path.join(work, "init", "0")])
        rec["train_s"] = time.time() - t
        got = counters.read()
        if state.step != 3 or got != dict(NO_LAUNCHES, roi_align=6):
            raise AssertionError(f"14c: step {state.step}, launches {got}")
        t = time.time()
        state = trainval_det_da.main(common + ["--max_steps", "5", "--r"])
        rec["resume_s"] = time.time() - t
        lr = state.optimizer.opt.param_groups[0]["lr"]
        if state.step != 5 or lr != state.optimizer.lr_schedule(4):
            raise AssertionError(f"14c --r: step {state.step}, lr {lr}")
        ck = os.path.join(out, "res101", "MVRD", "session_1")
        with open(os.path.join(ck, "logs", "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        if [r["step"] for r in logged] != [1, 2, 3, 4, 5]:
            raise AssertionError(f"14c: logged steps {logged}")
        if not all(np.isfinite(r["loss"]) for r in logged):
            raise AssertionError(f"14c: losses {logged}")
        meta = json.load(open(os.path.join(ck, "step_00000005",
                                           "metadata.json")))
        if set(meta) != {"session", "epoch", "pooling_mode",
                         "class_agnostic", "net", "dataset", "classes"}:
            raise AssertionError(f"14c: metadata {meta}")
        counters.reset()
        aps = test_det.main(EVAL_ARGS + [
            "--load_name", os.path.join(ck, "5"), "--save_dir", out])
        ev = os.path.join(out, "eval", "MVidVRD_test")
        with open(os.path.join(ev, "detections.pkl"), "rb") as fh:
            if len(pickle.load(fh)) != 16:
                raise AssertionError("14c detections.pkl: not 16 classes")
        results = [f for f in os.listdir(os.path.join(ev, "adapt"))
                   if f.startswith("det_test_")]
        if len(results) != 15:
            raise AssertionError(f"14c test_det wrote {len(results)} files")
        rec.update(losses=[r["loss"] for r in logged], logged=logged,
                   imgs_per_sec=[r["imgs_per_sec"] for r in logged],
                   test_det_mAP=float(aps["mAP"]),
                   test_det_launches={k: v for k, v in
                                      counters.read().items() if v},
                   stage_a=os.path.join(ck, "5"), devkit=devkit)
        log(f"14c: trained 3 steps in {rec['train_s']:.1f} s, resumed to 5 "
            f"in {rec['resume_s']:.1f} s (lr {lr:g}); losses "
            f"{[round(x, 3) for x in rec['losses']]}; test_det mAP "
            f"{rec['test_det_mAP']:.4f} (random weights: printed, not held) "
            f"[{card}]")
    finally:
        if saved_env is None:
            os.environ.pop("I2VSGG_DATA_ROOT", None)
        else:
            os.environ["I2VSGG_DATA_ROOT"] = saved_env
    return rec


def train_tiny_card_vs_cpu(dev, counters) -> dict:
    """14d: one deterministic step (``I2VSGG_DETERMINISTIC_SAMPLING=1``) of
    the tiny res10 tree (ic+gc+cr, f32, TF32 off, anchor scales (1, 2, 4)
    so that 64x80 frames hold anchors) on the card and on the CPU, from the
    same weights: every loss within ``loss_rtol``, every gradient within
    ``grad_frac`` of its norm and at cosine >= ``grad_cos``
    (``TRAIN_TINY_TOL``)."""
    from i2vsgg_tpu_torch.config import Config
    from i2vsgg_tpu_torch.train.det_da import det_da_loss, step_generator
    from i2vsgg_tpu_torch.train.optim import ReferenceSGD
    cfg = Config().replace(
        TRAIN=Config().TRAIN.__class__(
            RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=32,
            RPN_POST_NMS_TOP_N_TARGET=16, RPN_BATCHSIZE=32, BATCH_SIZE=16,
            MAX_NUM_GT_BOXES=30),
        COMPUTE_DTYPE="float32", ANCHOR_SCALES=(1, 2, 4))
    det_c = training_model(cfg, TRAIN_TINY, 4)
    with torch.no_grad():
        det_c.rpn.cls_score.weight.mul_(40.0)
    det_g = copy.deepcopy(det_c).to(dev)
    batches = train_frames(TRAIN_TINY, 4, TRAIN_TINY["frames"])
    saved = os.environ.get("I2VSGG_DETERMINISTIC_SAMPLING")
    os.environ["I2VSGG_DETERMINISTIC_SAMPLING"] = "1"
    out = {}
    try:
        with tf32_off():
            for where, d, det in (("cpu", torch.device("cpu"), det_c),
                                  ("card", dev, det_g)):
                ReferenceSGD(det, 1e-3, cfg)
                counters.reset()
                loss, m = det_da_loss(
                    det, *({k: torch.as_tensor(v, device=d)
                            for k, v in b.items()} for b in batches),
                    step_generator(d, 4, 0), eta=0.1, eta_style=0.01,
                    style_lambda=1.0, cr=True)
                loss.backward()
                out[where] = ({k: float(v.detach()) for k, v in m.items()},
                              {n: p.grad.cpu().double() for n, p in
                               det.named_parameters() if p.requires_grad},
                              counters.read())
    finally:
        if saved is None:
            os.environ.pop("I2VSGG_DETERMINISTIC_SAMPLING", None)
        else:
            os.environ["I2VSGG_DETERMINISTIC_SAMPLING"] = saved
    (mc, gc, _), (mg, gg, launched) = out["cpu"], out["card"]
    if launched != dict(NO_LAUNCHES, roi_align=2):
        raise AssertionError(f"14d launches on the card {launched}")
    loss_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc)
    frac = max(float((gg[n] - gc[n]).abs().max())
               / max(float(gc[n].norm()), 1e-12) for n in gc)
    cos = min(float((gg[n] * gc[n]).sum() / (gg[n].norm() * gc[n].norm()))
              for n in gc if float(gc[n].norm()) > 0)
    tol = TRAIN_TINY_TOL
    log(f"14d tiny step card vs CPU: losses rtol {loss_err:.3g} (tol "
        f"{tol['loss_rtol']:g}), gradients {frac:.3g} of their norm (tol "
        f"{tol['grad_frac']:g}), least cosine {cos:.8f} (tol "
        f"{tol['grad_cos']}); {len(gc)} gradients, fg rois "
        f"{int(mc['fg_cnt'])}, rpn_cls {mc['loss_rpn_cls']:.4f}")
    if not (loss_err <= tol["loss_rtol"] and frac <= tol["grad_frac"]
            and cos >= tol["grad_cos"] and mc["loss_rpn_cls"] > 0):
        raise AssertionError("14d: the tiny step on the card is out of "
                             f"bounds {tol}")
    return {"loss_rtol": loss_err, "grad_frac": frac, "grad_cos": cos,
            "tolerances": tol}


def training_on_card(dev, counters, card: str, work: str) -> dict:
    """Phase 14 (see the module docstring), 14c's devkit and checkpoints
    under ``work``. Returns its record."""
    rec = {}
    phase("14a Stage A training at full width: res101 ic+gc+cr, bf16 "
          "compute, one 600x1000 source frame with GT boxes and one target "
          f"frame a step, {TRAIN_STEPS} steps, POOLING_MODE=align (B1)")
    rec["14a align"] = train_full("14a", "align", dev, counters, card)
    phase("14b the same under POOLING_MODE=pool (B2)")
    rec["14b pool"] = train_full("14b", "pool", dev, counters, card)
    phase("14c the driver: trainval_det_da on the MVRD stills (JPEG) -> "
          "MVidVRD (PNG), 3 steps, --r to 5, then test_det on the checkpoint")
    rec["14c driver"] = train_driver_on_card(dev, counters, card, work)
    phase("14d one tiny deterministic step (res10, 64x80, f32, TF32 off): "
          "card vs CPU")
    rec["14d tiny"] = train_tiny_card_vs_cpu(dev, counters)
    return rec


# ----------------------------------------------------------------------------
# phase 15: Stage B training on the card (``train/sgg.py``, the driver
# ``python -m i2vsgg_tpu_torch.tools.trainval_sgg``)

# scripts/SGG_emb_resnet.sh's run with the defaults of cli/args.py: res101,
# bf16 compute with f32 params, VRDHead fc_dim 4096, emb_dim 300,
# spatial_type 2, use_obj_visual, 62 predicates, max_pairs 64,
# MAX_NUM_GT_BOXES 30, TRAIN scale 600 / max side 1000, batch 1
SGG_ARGS = ["--dataset", "MVRD", "--net", "res101", "--vrd_lr", "1e-4",
            "--bs", "1", "--num_relations", "62"]
# one seeded 600x1000 frame with 8 GT boxes and 20 relation triples a step
SGG_FRAME = dict(height=600, width=1000, objects=8, num_classes=16,
                 relations=20)
SGG_STEPS = 4
# test_sgg on 15c's checkpoint, asked for the other pooling (the
# checkpoint's metadata must win)
SGG_EVAL_ARGS = ["--dataset", "MVidVRD", "--net", "res101", "--bs", "4",
                 "--num_relations", "62", "--vrd_pooling", "align"]
# 15d, the tiny step card vs CPU (f32, TF32 off, no dropout): limits just
# above what the runs measured (8.6e-8, 2.5e-7 and 1 - 4e-13; PERF.md §6)
SGG_TINY_TOL = {"loss_rtol": 5e-7, "grad_frac": 2e-6, "grad_cos": 0.999999}
SGG_TINY = dict(height=64, width=96, objects=4, num_classes=6, frames=2,
                relations=6)


class roi_backward_calls:
    """Counts the calls of the RoI ops' plain backwards
    (``roi_align_avg_backward``, ``roi_pool_backward``, which the RoI
    ``autograd.Function``s call by name) inside the block: a Stage B step
    must make none, since the head pools a detached map."""

    def __enter__(self):
        from i2vsgg_tpu_torch.ops import roi_align as ra_mod
        from i2vsgg_tpu_torch.ops import roi_pool as rp_mod
        self.calls = {"roi_align": 0, "roi_pool": 0}
        self.saved = [(ra_mod, "roi_align_avg_backward", "roi_align"),
                      (rp_mod, "roi_pool_backward", "roi_pool")]
        self.fns = [getattr(m, n) for m, n, _ in self.saved]
        for (m, n, key), fn in zip(self.saved, self.fns):
            def counted(*a, _fn=fn, _key=key, **k):
                self.calls[_key] += 1
                return _fn(*a, **k)
            setattr(m, n, counted)
        return self

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.saved, self.fns):
            setattr(m, n, fn)


def sgg_batches(spec: dict, seed: int, max_pairs: int, n_rel: int,
                dev) -> dict:
    """A seeded Stage B batch on ``dev``: ``train_frames``' source frames
    with ``spec["objects"]`` GT boxes (padded to 30), each with
    ``spec["relations"]`` random (s, p, o) triples over its boxes, as
    ``build_pair_batch`` pads them to ``max_pairs``."""
    from i2vsgg_tpu_torch.train.sgg import build_pair_batch
    src, _ = train_frames(spec, seed, spec.get("frames", 1))
    rs = np.random.RandomState(seed + 1)
    rows = []
    for _ in range(src["image"].shape[0]):
        rels = []
        while len(rels) < spec["relations"]:
            s, o = rs.choice(spec["objects"], 2, replace=False)
            rels.append((int(s), int(rs.randint(n_rel)), int(o)))
        rows.append(build_pair_batch(rels, spec["objects"], max_pairs,
                                     n_rel))
    ix1, ix2, labels, valid = (np.stack(a) for a in zip(*rows))
    batch = {"image": src["image"], "im_info": src["im_info"],
             "obj_boxes": src["gt_boxes"][:, :, :4],
             "ix1": ix1.astype(np.int64), "ix2": ix2.astype(np.int64),
             "pair_valid": valid, "rel_labels": labels}
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def sgg_training_model(args, cfg, pooling: str, seed: int,
                       fc_dim: int | None = None, dropout_rate: float = 0.5):
    """Stage B's model of ``args`` (``VRDHead`` under ``pooling``, of width
    ``fc_dim`` if given), filled by the port's training inits on the CPU."""
    from i2vsgg_tpu_torch.models.inits import init_module
    from i2vsgg_tpu_torch.models.layers import torch_dtype
    from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
    from i2vsgg_tpu_torch.tools.common import build_trunk
    model = SGGModel(
        VRDHead(emb_dim=args.emb_dim, spatial_type=args.spatial_type,
                use_obj_visual=args.use_obj_visual,
                fc_dim=fc_dim or args.vrd_fc_dim, pooling=pooling,
                dropout_rate=dropout_rate),
        trunk=build_trunk(args.net, torch_dtype(cfg.COMPUTE_DTYPE)))
    return init_module(model, torch.Generator().manual_seed(seed))


def train_sgg_full(name: str, pooling: str, dev, counters, card: str,
                   stage_a: str) -> dict:
    """15a/15b: ``SGG_STEPS`` steps of ``train/sgg.py::train_step`` at full
    width (``SGG_ARGS``) under ``pooling``, dropout on, from the trunk of
    the Stage A checkpoint ``stage_a`` (``restore_sgg_init``), on one seeded
    ``SGG_FRAME``. Each step launches the head's RoI kernel once and no
    other kernel, and runs no RoI backward; the losses stay finite; after
    the steps the trunk (buffers included) is bit-unchanged and every vrd
    parameter moved. The last step's RoI call is held to its plain version
    at its inputs and timed (``held_roi_site``); a fifth step runs under
    the profiler."""
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.tools.common import ckpt_of, config_from_args
    from i2vsgg_tpu_torch.train.checkpoint import restore_sgg_init
    from i2vsgg_tpu_torch.train.det_da import TrainState
    from i2vsgg_tpu_torch.train.sgg import sgg_optimizer, train_step
    args = set_dataset_args(parse_args(SGG_ARGS))
    cfg = config_from_args(args)
    op = "roi_align" if pooling == "align" else "roi_pool"
    t = time.time()
    model = sgg_training_model(args, cfg, pooling, 15)
    stats = restore_sgg_init(*ckpt_of(stage_a), model)
    n_trunk = sum(1 for k in model.state_dict() if k.startswith("trunk."))
    if not stats["copied"] == stats["named"] == n_trunk:
        raise AssertionError(f"{name} restore_sgg_init: {stats}, "
                             f"{n_trunk} trunk tensors")
    model.to(dev)
    state = TrainState(model, sgg_optimizer(model, args.vrd_lr, cfg),
                       seed=15)
    prd = torch.as_tensor(np.random.RandomState(0).randn(
        args.num_relations, 300).astype(np.float32), device=dev)
    batch = sgg_batches(SGG_FRAME, 15, args.max_pairs, args.num_relations,
                        dev)
    # the copy for the check stays on the host, out of the device's peak
    before = {k: v.detach().to("cpu", copy=True)
              for k, v in model.state_dict().items()}
    vrd = {n for n, p in model.named_parameters() if p.requires_grad}
    log(f"{name}: res101 trunk from {stage_a} ({stats['copied']} of "
        f"{stats['total']} tensors), head of "
        f"{sum(p.numel() for n, p in model.named_parameters() if n in vrd)}"
        f" params in {len(vrd)} tensors, in {time.time() - t:.2f} s; "
        f"{int(batch['pair_valid'].sum())} valid pairs of "
        f"{args.max_pairs}")
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    with roi_backward_calls() as bwd:
        for i in range(SGG_STEPS):
            out = []
            counters.reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if i == SGG_STEPS - 1:
                calls = recorded_roi_sites(
                    lambda: out.append(train_step(state, batch, prd)), ())
            else:
                out.append(train_step(state, batch, prd))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
            got = counters.read()
            if got != dict(NO_LAUNCHES, **{op: 1}):
                raise AssertionError(f"{name} step {i + 1}: launches {got}; "
                                     f"expected 1 of {op} and nothing else")
            rec = {k: float(v) for k, v in out[0].items()}
            if not np.isfinite(rec["loss"]):
                raise AssertionError(f"{name} step {i + 1}: {rec}")
            steps.append(dict(rec, ms=ms))
            log(f"{name} step {i + 1}: {ms:.1f} ms, loss {rec['loss']:.5f}, "
                f"{int(rec['n_pairs'])} pairs")
        peak = torch.cuda.max_memory_allocated()
        profiled = profiled_step(lambda: train_step(state, batch, prd))
    if any(bwd.calls.values()):
        raise AssertionError(f"{name}: RoI backwards ran {bwd.calls}")
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k].cpu())}
    if moved != vrd or any(k.startswith("trunk.") for k in moved):
        raise AssertionError(
            f"{name}: moved outside the head {sorted(moved - vrd)[:5]}, "
            f"head tensors unchanged {sorted(vrd - moved)[:5]}")
    if len(calls) != 1 or calls[0][1] != "sgg":
        raise AssertionError(f"{name}: RoI calls recorded {len(calls)}")
    log(f"{name}, a fifth step under torch.profiler: "
        f"{profiled['host_ms']:.1f} ms of host time, "
        f"{profiled['device_ms']:.2f} ms of device time in "
        f"{profiled['launches']} kernel launches (busy share "
        f"{profiled['busy_share']:.3f}); most device time: "
        f"{[(k[:40], round(v, 2)) for k, v in profiled['top'][:5]]}")
    _, _, fmap, rois, a, k = calls[0]
    what = f"{name} {op} sgg ({rois.shape[0]} rois)"
    site = held_roi_site(op, fmap, rois, a, k, what)
    log(f"{what}: kernel {site['ms'] * 1e3:.2f} us of device time, plain "
        f"{site['plain_ms'] * 1e3:.2f} us, bound "
        f"{site['bound_ms'] * 1e3:.3f} us ({site['bound_by']}) [{card}]")
    step_ms = float(np.mean([s["ms"] for s in steps[1:]]))
    rec = {"steps": steps, "launches_per_step": got[op],
           "roi_backward_calls": bwd.calls, "profiled_step": profiled,
           "step_ms": step_ms, "images_per_s": 1e3 / step_ms,
           "sites": [dict(site, site="sgg")], "peak_bytes": peak,
           "resident_bytes": resident, "moved": len(moved),
           "restore": stats}
    log(f"{name}: steady step {step_ms:.1f} ms ({rec['images_per_s']:.2f} "
        f"images/s), peak {peak / 2 ** 30:.2f} GiB ({resident / 2 ** 30:.2f}"
        f" GiB allocated before the first step); {len(moved)} head "
        f"tensors moved, the trunk and its buffers bit-unchanged, no RoI "
        f"backward [{card}]")
    del model, state
    torch.cuda.empty_cache()
    return rec


def train_sgg_driver_on_card(dev, counters, card: str, work: str,
                             stage_a: str, devkit: dict) -> dict:
    """15c: ``trainval_sgg`` (``SGG_ARGS``, full width) on 14c's MVRD stills
    (JPEG) under ``work`` with their relation pickle, from 14c's Stage A
    checkpoint
    (``--load_name``), for 3 steps; then ``test_sgg`` on the checkpoint it
    wrote, asked for ``--vrd_pooling align``: the checkpoint's metadata
    (``pool``) must win, so it launches RoIPool and not RoIAlign."""
    from i2vsgg_tpu_torch.tools import test_sgg, trainval_sgg
    saved_env = os.environ.get("I2VSGG_DATA_ROOT")
    rec = {}
    try:
        os.environ["I2VSGG_DATA_ROOT"] = os.path.join(work, "data")
        out = os.path.join(work, "out_sgg")
        counters.reset()
        t = time.time()
        with roi_backward_calls() as bwd:
            state = trainval_sgg.main(SGG_ARGS + [
                "--save_dir", out, "--disp_interval", "1", "--max_steps",
                "3", "--load_name", stage_a, "--source_gt_rels_path",
                devkit["mvrd_gt_rels"]])
        rec["train_s"] = time.time() - t
        got = counters.read()
        if (state.step != 3 or got != dict(NO_LAUNCHES, roi_pool=3)
                or any(bwd.calls.values())):
            raise AssertionError(f"15c: step {state.step}, launches {got}, "
                                 f"RoI backwards {bwd.calls}")
        ck = os.path.join(out, "res101", "MVRD_SGG", "session_1")
        with open(os.path.join(ck, "logs", "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        if ([r["step"] for r in logged] != [1, 2, 3]
                or not all(np.isfinite(r["loss"]) for r in logged)):
            raise AssertionError(f"15c: logged {logged}")
        with open(os.path.join(ck, "step_00000003",
                               "metadata.json")) as fh:
            meta = json.load(fh)
        if meta != {"session": 1, "epoch": 1, "stage": "sgg",
                    "net": "res101", "num_relations": 62, "emb_dim": 300,
                    "spatial_type": 2, "vrd_pooling": "pool"}:
            raise AssertionError(f"15c: metadata {meta}")
        counters.reset()
        res = test_sgg.main(SGG_EVAL_ARGS + [
            "--video_ann", devkit["video_ann"], "--save_dir", out,
            "--load_name", os.path.join(ck, "3")])
        launched = {k: v for k, v in counters.read().items() if v}
        if set(launched) != {"roi_pool"}:
            raise AssertionError(f"15c test_sgg launches {launched}: the "
                                 "checkpoint's vrd_pooling was not read")
        with open(os.path.join(out, "eval", "MVidVRD_test_SGG",
                               "frame_detections.json")) as fh:
            frames = json.load(fh)
        if sum(len(v) for v in frames.values()) != 12:
            raise AssertionError(f"15c frame_detections: {list(frames)}")
        rec.update(losses=[r["loss"] for r in logged], logged=logged,
                   imgs_per_sec=[r["imgs_per_sec"] for r in logged],
                   test_sgg_mAP=float(res[0]), test_sgg_launches=launched)
        log(f"15c: trainval_sgg trained 3 steps in {rec['train_s']:.1f} s "
            f"(losses {[round(x, 4) for x in rec['losses']]}, "
            f"{[round(x, 2) for x in rec['imgs_per_sec']]} images/s); "
            f"test_sgg on its checkpoint read vrd_pooling=pool from the "
            f"metadata (launches {launched}), mAP {rec['test_sgg_mAP']:.4f} "
            f"(random head: printed, not held) [{card}]")
    finally:
        if saved_env is None:
            os.environ.pop("I2VSGG_DATA_ROOT", None)
        else:
            os.environ["I2VSGG_DATA_ROOT"] = saved_env
    return rec


def train_sgg_tiny_card_vs_cpu(dev, counters) -> dict:
    """15d: one Stage B loss and backward of a res10 model (head
    ``fc_dim`` 128, dropout rate 0, so no draw enters) on two 64x96 frames,
    f32 with TF32 off, on the card and on the CPU from the same weights:
    the loss within ``loss_rtol``, every vrd gradient within ``grad_frac``
    of its norm and at cosine >= ``grad_cos`` (``SGG_TINY_TOL``)."""
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.config import Config
    from i2vsgg_tpu_torch.train.det_da import step_generator
    from i2vsgg_tpu_torch.train.sgg import sgg_loss, sgg_optimizer
    args = set_dataset_args(parse_args(
        ["--net", "res10", "--num_relations", "7", "--max_pairs", "12"]))
    cfg = Config().replace(COMPUTE_DTYPE="float32")
    model_c = sgg_training_model(args, cfg, "pool", 5, fc_dim=128,
                                 dropout_rate=0.0)
    model_g = copy.deepcopy(model_c).to(dev)
    prd = np.random.RandomState(5).randn(7, 300).astype(np.float32)
    out = {}
    with tf32_off():
        for where, d, model in (("cpu", torch.device("cpu"), model_c),
                                ("card", dev, model_g)):
            sgg_optimizer(model, 1e-3, cfg)
            counters.reset()
            loss, m = sgg_loss(model, sgg_batches(SGG_TINY, 5, 12, 7, d),
                               torch.as_tensor(prd, device=d),
                               lambda: step_generator(d, 5, 0))
            loss.backward()
            out[where] = (float(loss.detach()), int(m["n_pairs"]),
                          {n: p.grad.cpu().double() for n, p in
                           model.named_parameters() if p.requires_grad},
                          counters.read())
    (lc, nc, gc, _), (lg, ng, gg, launched) = out["cpu"], out["card"]
    if launched != dict(NO_LAUNCHES, roi_pool=SGG_TINY["frames"]):
        raise AssertionError(f"15d launches on the card {launched}")
    loss_err = abs(lg - lc) / max(abs(lc), 1e-6)
    frac = max(float((gg[n] - gc[n]).abs().max())
               / max(float(gc[n].norm()), 1e-12) for n in gc)
    cos = min(float((gg[n] * gc[n]).sum() / (gg[n].norm() * gc[n].norm()))
              for n in gc if float(gc[n].norm()) > 0)
    tol = SGG_TINY_TOL
    log(f"15d tiny Stage B step card vs CPU: loss {lc:.6f} rtol "
        f"{loss_err:.3g} (tol {tol['loss_rtol']:g}), gradients {frac:.3g} "
        f"of their norm (tol {tol['grad_frac']:g}), least cosine "
        f"{cos:.8f} (tol {tol['grad_cos']}); {len(gc)} gradients, {nc} "
        f"valid pairs")
    if not (loss_err <= tol["loss_rtol"] and frac <= tol["grad_frac"]
            and cos >= tol["grad_cos"] and nc == ng > 0 and len(gc) > 20):
        raise AssertionError("15d: the tiny Stage B step on the card is out "
                             f"of bounds {tol}")
    return {"loss_rtol": loss_err, "grad_frac": frac, "grad_cos": cos,
            "tolerances": tol}


def stage_b_on_card(dev, counters, card: str, work: str,
                    stage_a: str, devkit: dict) -> dict:
    """Phase 15 (see the module docstring), from phase 14c's checkpoint
    ``stage_a`` and devkit. Returns its record."""
    rec = {}
    phase("15a Stage B training at full width: res101 trunk (bf16) from "
          "14c's checkpoint, VRDHead fc 4096, one 600x1000 frame with 8 GT "
          f"boxes and 20 relations, 64 pairs, {SGG_STEPS} steps, dropout "
          "on, vrd_pooling=pool (B2)")
    rec["15a pool"] = train_sgg_full("15a", "pool", dev, counters, card,
                                     stage_a)
    phase("15b the same under vrd_pooling=align (B1)")
    rec["15b align"] = train_sgg_full("15b", "align", dev, counters, card,
                                      stage_a)
    phase("15c the driver: trainval_sgg on 14c's MVRD stills (JPEG) from its "
          "checkpoint, 3 steps, then test_sgg on the checkpoint")
    rec["15c driver"] = train_sgg_driver_on_card(dev, counters, card, work,
                                                 stage_a, devkit)
    phase("15d one tiny Stage B step (res10, 64x96, f32, TF32 off, no "
          "dropout): card vs CPU")
    rec["15d tiny"] = train_sgg_tiny_card_vs_cpu(dev, counters)
    return rec


def training_phases(dev, counters, card: str) -> tuple:
    """Phases 14, 15, 16b, 17a, 17b and 20a-20c in one work directory (14c's
    devkits and Stage A checkpoint are phase 15's, 16b's, 17a's and 20's
    start), removed afterwards."""
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        training = training_on_card(dev, counters, card, work)
        d = training["14c driver"]
        stage_b = stage_b_on_card(dev, counters, card, work, d["stage_a"],
                                  d["devkit"])
        phase("16b the MVRD stills through the drivers: the loader's host ms "
              "a still (JPEG decode + resize), then test_det on MVRD_test at "
              "full width from 14c's checkpoint")
        mvrd = mvrd_eval_on_card(counters, card, work, d["stage_a"])
        phase("17a the training drivers under torchrun (NCCL, world size 1, "
              "--mesh 1): 14c's run for 3 steps, --r to 4, and 15c's for 3 "
              "steps; step 1 against theirs")
        dp = {"17a torchrun": torchrun_training(card, work, training,
                                                stage_b)}
        phase("17b two gloo ranks on the one card at batch 1 against one "
              "process at batch 2: 14d's tiny Stage A and 15d's tiny Stage "
              f"B, {DP_STEPS} steps")
        dp["17b gloo"] = gloo_ranks_on_card(dev, card)
        gate = int8_gate_on_card(counters, card, work, d["stage_a"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return training, stage_b, mvrd, dp, gate


# ----------------------------------------------------------------------------
# phase 16: JPEG decode (``csrc/jpeg.cc`` through ``data/jpeg.py``, built
# with the host compiler) on the committed fixtures, and the MVRD stills
# through the drivers

JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "jpeg")
# the VRD-sized stills of the fixtures (H x W: 768x1024 and 1024x768),
# copied under MVRD index names, and the video frame timed beside them
MVRD_STILLS = ("still_768x1024", "still_1024x768")
TIMED_JPEGS = MVRD_STILLS + ("frame_360x640_a",)
MVRD_IMAGES = 8
DECODE_REPS = 7
# 16b: test_det on MVRD_test (the source domain's test split)
MVRD_EVAL_BS = 4
MVRD_EVAL_ARGS = ["--dataset", "MVRD", "--net", "res101", "--ic", "--gc",
                  "--bs", str(MVRD_EVAL_BS)]


def jpeg_manifest() -> dict:
    """``tests/data/jpeg/MANIFEST.json``: each fixture's set (coverage,
    realistic, refused), its golden and shape, or the mode it is refused
    for (``tests/make_jpeg_fixtures.py`` writes them)."""
    with open(os.path.join(JPEG_DIR, "MANIFEST.json")) as fh:
        return json.load(fh)


def write_mvrd_devkit(root: str, seed: int = 0) -> dict:
    """An MVRD devkit under ``root`` in ``write_devkit``'s layout:
    ``MVRD_IMAGES`` stills ``img<i>.jpg``, copies of ``MVRD_STILLS`` in
    turn, 2-4 seeded boxes each with their VOC XML, the test/val/trainval
    split files, and a relation pickle {index: [(s, p, o)]} (Stage B's
    ``--source_gt_rels_path``). Returns that pickle's path as
    ``mvrd_gt_rels``."""
    from i2vsgg_tpu_torch.data.voc import VRD_CLASSES
    manifest = jpeg_manifest()
    rs = np.random.RandomState(seed)
    base = os.path.join(root, "MVRD")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    names, gt_rels = [], {}
    for i in range(MVRD_IMAGES):
        still = MVRD_STILLS[i % len(MVRD_STILLS)]
        h, w = manifest[still]["shape"][:2]
        index = f"img{i:03d}"
        shutil.copyfile(os.path.join(JPEG_DIR, still + ".jpg"),
                        os.path.join(base, "JPEGImages", index + ".jpg"))
        xml = ["<annotation>", f"<size><width>{w}</width><height>{h}"
               "</height><depth>3</depth></size>"]
        n_obj = rs.randint(2, 5)
        for _ in range(n_obj):
            bh, bw = rs.randint(h // 8, h // 2), rs.randint(w // 8, w // 2)
            y1, x1 = rs.randint(0, h - bh), rs.randint(0, w - bw)
            box = (x1, y1, x1 + bw - 1, y1 + bh - 1)
            xml += ["<object>", "<name>"
                    f"{VRD_CLASSES[rs.randint(1, len(VRD_CLASSES))]}</name>",
                    "<difficult>0</difficult>", "<bndbox>"]
            xml += [f"<{k}>{c + 1}</{k}>" for k, c in
                    zip(("xmin", "ymin", "xmax", "ymax"), box)]
            xml += ["</bndbox>", "</object>"]
        xml.append("</annotation>")
        with open(os.path.join(base, "Annotations", index + ".xml"),
                  "w") as fh:
            fh.write("\n".join(xml))
        pairs = [(a, b) for a in range(n_obj) for b in range(n_obj) if a != b]
        gt_rels[index] = [(int(a), int(rs.randint(FULL["num_rel"])), int(b))
                          for a, b in (pairs[k] for k in rs.permutation(
                              len(pairs))[:3])]
        names.append(index)
    for split in ("test", "val", "trainval"):
        with open(os.path.join(base, "ImageSets", "Main", split + ".txt"),
                  "w") as fh:
            fh.write("\n".join(names) + "\n")
    path = os.path.join(base, "source_gt_rels.pkl")
    with open(path, "wb") as fh:
        pickle.dump(gt_rels, fh)
    return {"mvrd_gt_rels": path}


def host_ms(fn, reps: int = DECODE_REPS) -> dict:
    """Host wall ms of ``fn()`` over ``reps`` calls: median, least and
    most."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t))
    return {"median": float(np.median(times)), "min": min(times),
            "max": max(times)}


def jpeg_fixtures_on_host(card: str) -> dict:
    """16a: with the JPEG decoder (in the port's host library, built in
    phase 2 with the batch loader), hold every committed fixture of ``tests/data/jpeg`` bit-equal to its golden (the
    PNG of cv2.imread's output, read with the port's PNG decoder), show
    that each refused fixture (none since the CMYK one is read) raises
    ``UnsupportedImageError`` naming its mode, and time the decode of
    ``TIMED_JPEGS`` beside the PNG decode of the same pixels (their
    goldens), each the median of ``DECODE_REPS`` calls. Host times of the
    machine of ``card``."""
    from i2vsgg_tpu_torch.data.image_io import (UnsupportedImageError,
                                                imread_bgr)
    rec = {}
    manifest = jpeg_manifest()
    held, refused = [], []
    for name, entry in sorted(manifest.items()):
        path = os.path.join(JPEG_DIR, name + ".jpg")
        if entry["set"] == "refused":
            try:
                imread_bgr(path)
            except UnsupportedImageError as e:
                if entry["mode"] not in str(e):
                    raise AssertionError(f"16a {name}: refused as {e}, not "
                                         f"as {entry['mode']}")
                refused.append(name)
                continue
            raise AssertionError(f"16a {name} decoded: a {entry['mode']} "
                                 "JPEG must raise UnsupportedImageError")
        golden = imread_bgr(os.path.join(JPEG_DIR, entry["golden"]))
        got = imread_bgr(path)
        if (list(got.shape) != entry["shape"]
                or not np.array_equal(got, golden)):
            raise AssertionError(f"16a {name}: decoded != its golden "
                                 f"({got.shape}, {entry['shape']})")
        held.append(name)
    rec.update(held=len(held), refused=refused)
    rec["decode_ms"] = {}
    for name in TIMED_JPEGS:
        jpg = os.path.join(JPEG_DIR, name + ".jpg")
        png = os.path.join(JPEG_DIR, manifest[name]["golden"])
        rec["decode_ms"][name] = {
            "shape": manifest[name]["shape"],
            "jpeg_bytes": os.path.getsize(jpg),
            "jpeg_decode_ms": host_ms(lambda: imread_bgr(jpg)),
            "png_decode_ms": host_ms(lambda: imread_bgr(png))}
    log(f"16a: {len(held)} fixtures bit-equal to their goldens, "
        f"{len(refused)} refused ({', '.join(refused)}); host decode ms "
        "(median of 7) JPEG / PNG of the same pixels: " + "; ".join(
            f"{n} {r['jpeg_decode_ms']['median']:.2f} / "
            f"{r['png_decode_ms']['median']:.2f}"
            for n, r in rec["decode_ms"].items())
        + f" (host CPU of the machine of {card})")
    return rec


def mvrd_eval_on_card(counters, card: str, work: str, stage_a: str) -> dict:
    """16b: the MVRD stills that 14c trained on (``write_mvrd_devkit``
    under ``work``) as the drivers read them: the loader's host ms a still
    (``imread_bgr`` + ``prep_image`` at TEST scale 600, as
    ``DetectionLoader`` calls them), then ``test_det`` on ``MVRD_test`` at
    full width (``MVRD_EVAL_ARGS``) from 14c's Stage A checkpoint
    ``stage_a``, whose files must parse; its RoIAlign launches (2 a batch:
    the det subgrid and the ic context) are counted."""
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.data.image_io import imread_bgr
    from i2vsgg_tpu_torch.data.pipeline import prep_image
    from i2vsgg_tpu_torch.data.roidb import combined_roidb
    from i2vsgg_tpu_torch.tools import test_det
    from i2vsgg_tpu_torch.tools.common import config_from_args
    saved_env = os.environ.get("I2VSGG_DATA_ROOT")
    rec = {}
    try:
        os.environ["I2VSGG_DATA_ROOT"] = os.path.join(work, "data")
        cfg = config_from_args(set_dataset_args(parse_args(MVRD_EVAL_ARGS),
                                                test=True))
        _, roidb, _, _ = combined_roidb("MVRD_test", training=False,
                                        use_flipped=False)
        decode, resize = [], []
        for entry in roidb:
            t = time.perf_counter()
            im = imread_bgr(entry["image"])
            t_r = time.perf_counter()
            prep_image(im, cfg.TEST.SCALES[0], cfg.PIXEL_MEANS)
            decode.append(1e3 * (t_r - t))
            resize.append(1e3 * (time.perf_counter() - t_r))
        loader_ms = [d + r for d, r in zip(decode, resize)]
        rec["loader_ms_per_still"] = {
            "median": float(np.median(loader_ms)), "min": min(loader_ms),
            "max": max(loader_ms), "decode_median": float(np.median(decode)),
            "resize_median": float(np.median(resize))}
        out = os.path.join(work, "out_mvrd")
        counters.reset()
        t = time.time()
        aps = test_det.main(MVRD_EVAL_ARGS + ["--load_name", stage_a,
                                              "--save_dir", out])
        rec["test_det_s"] = time.time() - t
        launched = counters.read()
        batches = -(-len(roidb) // MVRD_EVAL_BS)
        if launched != dict(NO_LAUNCHES, roi_align=2 * batches):
            raise AssertionError(f"16b test_det launches {launched}")
        ev = os.path.join(out, "eval", "MVRD_test")
        with open(os.path.join(ev, "detections.pkl"), "rb") as fh:
            dets = pickle.load(fh)
        if len(dets) != 16 or any(len(c) != len(roidb) for c in dets):
            raise AssertionError("16b detections.pkl: not 16 classes x "
                                 f"{len(roidb)} stills")
        results = [f for f in os.listdir(os.path.join(ev, "adapt"))
                   if f.startswith("det_test_")]
        if len(results) != 15:
            raise AssertionError(f"16b test_det wrote {len(results)} files")
        rec.update(stills=len(roidb), test_det_mAP=float(aps["mAP"]),
                   test_det_launches={k: v for k, v in launched.items()
                                      if v})
        r = rec["loader_ms_per_still"]
        log(f"16b: loader host ms a still (decode + resize to "
            f"{cfg.TEST.SCALES[0]} rows), "
            f"median {r['median']:.2f} (decode {r['decode_median']:.2f}, "
            f"resize {r['resize_median']:.2f}) over {len(roidb)} stills; "
            f"test_det on MVRD_test in {rec['test_det_s']:.1f} s, mAP "
            f"{rec['test_det_mAP']:.4f} (trained 5 steps from random "
            f"weights: printed, not held), launches "
            f"{rec['test_det_launches']} [{card}]")
    finally:
        if saved_env is None:
            os.environ.pop("I2VSGG_DATA_ROOT", None)
        else:
            os.environ["I2VSGG_DATA_ROOT"] = saved_env
    return rec


# ----------------------------------------------------------------------------
# phase 18: the native batch loader (``i2vsgg_tpu_torch/runtime``:
# ``csrc/io_runtime.cc`` with ``csrc/jpeg.cc``, built with the host compiler
# in phase 2): decode, batch loading, the conv1 plane packer, and the drivers
# with it and with the Python path (``I2VSGG_NATIVE_IO=0``)

LOADER_REPS = 3
PACK_SHAPES = ((4, 600, 960), (4, 608, 1216))
PACK_REPS = 5
# 18c and 18d run their arms in these orders, so that neither is always
# first or always after the other
PACK_ORDER = ("native", "torch", "torch", "native")
MEANS = (102.9801, 115.9465, 122.7717)
# 18d's devkit: 13a's frames and layout, 2 videos x 24 frames, 12 requests
# of 4 a run, of which the first (start-up, cold caches) is left out of the
# steady-state numbers
DEVKIT_18D = dict(DEVKIT, frames=24)


def native_decode_on_host(build: dict) -> dict:
    """18a: the runtime's ``decode_image`` on every committed JPEG fixture
    and its PNG golden: equal to ``imread_bgr``, the EXIF orientations 2-8
    left unapplied (``jpeg.orient`` of the decode equals ``imread_bgr``);
    the refused fixtures raise ``UnsupportedImageError`` naming their
    mode."""
    from i2vsgg_tpu_torch import runtime
    from i2vsgg_tpu_torch.data import jpeg
    from i2vsgg_tpu_torch.data.image_io import (UnsupportedImageError,
                                                imread_bgr)
    rec = dict(build, held=0, unoriented=[], refused=[])
    for name, entry in sorted(jpeg_manifest().items()):
        path = os.path.join(JPEG_DIR, name + ".jpg")
        if entry["set"] == "refused":
            try:
                runtime.decode_image(path)
            except UnsupportedImageError as e:
                if entry["mode"] not in str(e):
                    raise AssertionError(f"18a {name}: refused as {e}")
                rec["refused"].append(name)
                continue
            raise AssertionError(f"18a {name} decoded: a {entry['mode']} "
                                 "JPEG must raise UnsupportedImageError")
        got = runtime.decode_image(path)
        with open(path, "rb") as fh:
            orientation = jpeg.exif_orientation(fh.read())
        if not np.array_equal(jpeg.orient(got, orientation),
                              imread_bgr(path)):
            raise AssertionError(f"18a {name}: decode_image (orientation "
                                 f"{orientation} applied) != imread_bgr")
        if orientation != 1:
            rec["unoriented"].append(name)
        golden = os.path.join(JPEG_DIR, entry["golden"])
        if not np.array_equal(runtime.decode_image(golden),
                              imread_bgr(golden)):
            raise AssertionError(f"18a {entry['golden']}: decode_image != "
                                 "imread_bgr")
        rec["held"] += 1
    log(f"18a: the runtime built in {build['build_s']:.2f} s in phase 2 "
        f"(cold: {build['cold']}); decode_image equal to imread_bgr on "
        f"{rec['held']} fixtures and their PNG goldens, "
        f"{len(rec['unoriented'])} with their EXIF orientation left "
        f"unapplied ({', '.join(rec['unoriented'])}), refused: "
        f"{', '.join(rec['refused'])}")
    return rec


def native_batches_on_host(card: str, what: str, paths: list) -> dict:
    """18b: ``runtime.load_batch`` on ``paths`` at the drivers' scale (600)
    into their bucket, at 1 and 8 threads (the same batch), each image's
    decode equal to ``imread_bgr``'s (the Python path's own PNG inflate;
    a JPEG's EXIF orientation applied to it), each image bit-equal to
    ``runtime.preprocess_plain`` of its decode (the JAX runtime's
    arithmetic in numpy), its scale and size equal to the Python
    path's (``imread_bgr`` + ``prep_image``); the pixels' distance from the
    Python path is reported (a fraction of a pixel where a side does not
    scale to a whole number: not held). Host ms a frame, median of
    ``LOADER_REPS`` batches, beside the Python path's decode and resize ms
    a frame (median over the frames)."""
    from i2vsgg_tpu_torch import runtime
    from i2vsgg_tpu_torch.data import jpeg
    from i2vsgg_tpu_torch.data.image_io import imread_bgr
    from i2vsgg_tpu_torch.data.pipeline import bucket_hw, prep_image
    decode, resize, refs, ims = [], [], [], []
    for p in paths:
        t = time.perf_counter()
        im = imread_bgr(p)
        t_r = time.perf_counter()
        refs.append(prep_image(im, 600, MEANS))
        decode.append(1e3 * (t_r - t))
        resize.append(1e3 * (time.perf_counter() - t_r))
        ims.append(im)
    pads = [bucket_hw(*ref.shape[:2]) for ref, _ in refs]
    ph, pw = max(h for h, _ in pads), max(w for _, w in pads)
    n = len(paths)
    rec = {"images": n, "pad": [ph, pw], "python_ms_per_frame": {
        "decode_median": float(np.median(decode)),
        "resize_median": float(np.median(resize)),
        "total_median": float(np.median(np.add(decode, resize)))}}
    out = {}
    for threads in (1, 8):
        times = []
        for _ in range(LOADER_REPS):
            t = time.perf_counter()
            out[threads] = runtime.load_batch(paths, [False] * n, MEANS, 600,
                                              ph, pw, n_threads=threads)
            times.append(1e3 * (time.perf_counter() - t) / n)
        rec[f"native_ms_per_frame_{threads}_threads"] = {
            "median": float(np.median(times)), "min": min(times),
            "max": max(times)}
    for a, b in zip(out[1], out[8]):
        if not np.array_equal(a, b):
            raise AssertionError(f"18b {what}: 1 and 8 threads differ")
    images, scales, hw = out[8]
    gaps = []
    for i, (p, (ref, scale), im) in enumerate(zip(paths, refs, ims)):
        decoded = runtime.decode_image(p)
        with open(p, "rb") as fh:
            data = fh.read()
        orientation = (jpeg.exif_orientation(data)
                       if data[:2] == b"\xff\xd8" else 1)
        if not np.array_equal(jpeg.orient(decoded, orientation), im):
            raise AssertionError(f"18b {p}: decode_image (orientation "
                                 f"{orientation} applied) != imread_bgr")
        plain, s_plain, hw_plain = runtime.preprocess_plain(
            decoded, False, MEANS, 600, ph, pw)
        if not (np.array_equal(images[i], plain) and scales[i] == s_plain
                and np.array_equal(hw[i], hw_plain)):
            raise AssertionError(f"18b {p}: load_batch != preprocess_plain")
        rh, rw = ref.shape[:2]
        if scales[i] != np.float32(scale) or tuple(hw[i]) != (rh, rw):
            raise AssertionError(f"18b {p}: scale {scales[i]} / size "
                                 f"{hw[i]} vs the Python path's {scale} / "
                                 f"{(rh, rw)}")
        gaps.append(np.abs(images[i, :rh, :rw] - ref))
    rec["gap_to_python"] = {"max": max(float(g.max()) for g in gaps),
                            "mean": float(np.mean([g.mean() for g in gaps]))}
    r = rec
    log(f"18b {what}: {n} images into {ph}x{pw}, decoded as imread_bgr "
        f"decodes them, bit-equal to the plain version, scales and sizes "
        f"equal to the Python path; host ms a "
        f"frame, native "
        f"{r['native_ms_per_frame_1_threads']['median']:.2f} (1 thread) / "
        f"{r['native_ms_per_frame_8_threads']['median']:.2f} (8 threads); "
        f"Python path decode {r['python_ms_per_frame']['decode_median']:.2f}"
        f" + resize {r['python_ms_per_frame']['resize_median']:.2f}; pixel "
        f"gap to the Python path max {r['gap_to_python']['max']:.4g}, mean "
        f"{r['gap_to_python']['mean']:.4g} (reported, not held) "
        f"[{card}, {os.cpu_count()} CPUs]")
    return rec


def native_packer_on_host(card: str) -> dict:
    """18c: ``runtime.pack_planes`` (``pack_conv1_planes_np``'s default)
    at ``PACK_SHAPES``, byte-equal to the torch packer (``native=False``);
    host ms of each over blocks of ``PACK_REPS`` calls in ``PACK_ORDER``
    (median, least and most over all of a packer's calls)."""
    from i2vsgg_tpu_torch.ops.conv1 import pack_conv1_planes_np
    rec = {}
    rs = np.random.RandomState(18)
    for shape in PACK_SHAPES:
        x = (rs.randn(*shape, 3) * 40).astype(np.float32)
        got = pack_conv1_planes_np(x)
        plain = pack_conv1_planes_np(x, native=False)
        if not torch.equal(got.view(torch.int16), plain.view(torch.int16)):
            raise AssertionError(f"18c {shape}: native planes != torch "
                                 "packer's")
        times = {"native": [], "torch": []}
        for arm in PACK_ORDER:
            native = arm == "native"
            for _ in range(PACK_REPS):
                t = time.perf_counter()
                pack_conv1_planes_np(x, native=native)
                times[arm].append(1e3 * (time.perf_counter() - t))
        rec["x".join(map(str, shape))] = {
            "planes": list(got.shape), "order": list(PACK_ORDER),
            **{f"{arm}_ms": {"median": float(np.median(v)), "min": min(v),
                             "max": max(v), "all": v}
               for arm, v in times.items()}}
    log(f"18c pack_planes byte-equal to the torch packer; host ms (median, "
        f"least-most of {len(PACK_ORDER) // 2 * PACK_REPS} calls each, "
        f"blocks {', '.join(PACK_ORDER)}) native / torch: " + "; ".join(
            f"{k} {v['native_ms']['median']:.2f} ({v['native_ms']['min']:.2f}"
            f"-{v['native_ms']['max']:.2f}) / {v['torch_ms']['median']:.2f} "
            f"({v['torch_ms']['min']:.2f}-{v['torch_ms']['max']:.2f})"
            for k, v in rec.items())
        + f" [{card}, {os.cpu_count()} CPUs]")
    return rec


@contextlib.contextmanager
def timed_loaders():
    """Within the block, every ``DetectionLoader`` iteration records its
    path, the frames of each batch, the host ms its consumer waited for
    each batch, the ms of each request (from asking for its batch to
    asking for the next: the driver's loop, loader included), the wall
    seconds from the first batch asked for to the end, and frames/s over
    all of it and over the requests after the first. Yields the list of
    records."""
    from i2vsgg_tpu_torch.data import pipeline
    runs, orig = [], pipeline.DetectionLoader.__iter__

    def timed(self):
        rec = {"path": self.path, "batch_frames": [], "wait_ms": []}
        runs.append(rec)
        it = orig(self)
        asked = []
        while True:
            asked.append(time.perf_counter())
            try:
                batch = next(it)
            except StopIteration:
                break
            rec["wait_ms"].append(1e3 * (time.perf_counter() - asked[-1]))
            rec["batch_frames"].append(len(batch["indices"]))
            yield batch
        frames = rec["batch_frames"]
        rec["frames"] = sum(frames)
        rec["request_ms"] = [1e3 * float(d) for d in np.diff(asked)]
        rec["wall_s"] = asked[-1] - asked[0]
        rec["fps"] = rec["frames"] / rec["wall_s"]
        if len(frames) > 1:
            rec["steady_fps"] = sum(frames[1:]) / (asked[-1] - asked[1])

    pipeline.DetectionLoader.__iter__ = timed
    try:
        yield runs
    finally:
        pipeline.DetectionLoader.__iter__ = orig


@contextlib.contextmanager
def timed_packer(pattern: tuple):
    """Within the block, call k of ``Conv1Planes.pack`` on numpy images
    packs with the packer ``pattern[k % len(pattern)]`` names ("native" or
    "torch"), whatever ``I2VSGG_NATIVE_IO`` says, and records each call's
    packer and host ms. Yields the list of (packer, ms)."""
    from i2vsgg_tpu_torch.ops import conv1
    calls, orig = [], conv1.pack_conv1_planes_np

    def timed(x, **_):
        packer = pattern[len(calls) % len(pattern)]
        t = time.perf_counter()
        out = orig(x, native=packer == "native")
        calls.append((packer, 1e3 * (time.perf_counter() - t)))
        return out

    conv1.pack_conv1_planes_np = timed
    try:
        yield calls
    finally:
        conv1.pack_conv1_planes_np = orig


def output_gap(a: list, b: list) -> dict:
    """How far two runs' program outputs (one per request) lie apart, slot
    by slot: detection slots whose validity or class differ, and the
    largest box, score and relation-probability gaps where both are
    valid."""
    slots = boxes = scores = rel = 0.0
    for x, y in zip(a, b):
        same = ((x["det_valid"] == y["det_valid"])
                & (x["classes"] == y["classes"]))
        slots += float((~same).sum())
        both = same & x["det_valid"].bool()
        if both.any():
            boxes = max(boxes, float((x["boxes"] - y["boxes"]).abs()[both]
                                     .max()))
            scores = max(scores, float((x["scores"] - y["scores"]).abs()
                                       [both].max()))
        pairs = x["pair_valid"].bool() & y["pair_valid"].bool()
        if pairs.any():
            rel = max(rel, float((x["rel_prob"].float()
                                  - y["rel_prob"].float()).abs()[pairs]
                                 .max()))
    return {"slots_differ": int(slots), "boxes_max": boxes,
            "scores_max": scores, "rel_prob_max": rel}


def arm_summary(runs: list) -> dict:
    """One arm's steady state over its runs: frames/s of each run over the
    requests after the first, and the median ms of those requests, of the
    loader's waits and of the packer's calls (where it packed)."""
    steady = [m for r in runs for m in r["request_ms"][1:]]
    waits = [m for r in runs for m in r["wait_ms"][1:]]
    packs = [m for r in runs for _, m in r["packs"][1:]]
    return {"steady_fps": [r["steady_fps"] for r in runs],
            "request_ms_median": float(np.median(steady)),
            "wait_ms_median": float(np.median(waits)),
            "pack_ms_median": float(np.median(packs)) if packs else None,
            "wall_fps": [r["fps"] for r in runs]}


def packer_pairs(runs: list) -> dict:
    """The two packers within the native loader's ``--host_planes`` runs,
    whose requests alternate between them in blocks of two (one request
    each, in ``PACK_ORDER``'s order, or in the second run that order
    rotated by two): for each block after the first (which holds the
    run's first request), the ms of the request packed natively and of
    the one packed by the torch packer.
    Returns the pairs, each packer's median request and pack ms over the
    pairs' requests, and in how many pairs the native packer's request,
    and its pack, took less time."""
    pairs = []
    for r in runs:
        for k in range(2, len(r["request_ms"]) - 1, 2):
            by = {r["packs"][j][0]: (r["request_ms"][j], r["packs"][j][1])
                  for j in (k, k + 1)}
            pairs.append({"native_ms": by["native"][0],
                          "torch_ms": by["torch"][0],
                          "native_pack_ms": by["native"][1],
                          "torch_pack_ms": by["torch"][1]})
    med = {k: float(np.median([p[k] for p in pairs])) for k in pairs[0]}
    return {"pairs": pairs, "medians": med, "native_wins": sum(
        p["native_ms"] < p["torch_ms"] for p in pairs),
        "native_pack_wins": sum(p["native_pack_ms"] < p["torch_pack_ms"]
                                for p in pairs)}


def native_drivers_on_card(counters, card: str, files: dict,
                           devkit: str, mvrd_root: str, out: str) -> dict:
    """18d: ``serve_video`` with 13b's checkpoints on ``devkit``
    (``DEVKIT_18D``), default and ``--host_planes``, each with the native
    loader and with the Python path (``I2VSGG_NATIVE_IO=0``) in the order
    native, python, python, native. Under ``--host_planes`` the native
    loader's runs pack each request with the native packer or the torch
    packer in turn (``packer_pairs``), so the two packers meet in one run
    on the same requests; the Python path packs with the torch packer.
    Then ``test_det`` on the MVRD stills with each loader (two batches: a
    smoke reading). The launches counted as 13b and 16b count them; of
    each arm the steady state (``arm_summary``: the first request of a
    run left out) and the two loaders' detection gaps (reported, not
    held: random-weight near-ties move)."""
    from i2vsgg_tpu_torch.tools import serve_video, test_det
    b = FULL["frames"]
    n_req = DEVKIT_18D["videos"] * DEVKIT_18D["frames"] // b
    python = {"I2VSGG_NATIVE_IO": "0"}
    expect = dict(NO_LAUNCHES, roi_align=2, roi_pool=b)
    rec = {}
    saved_env = os.environ.get("I2VSGG_DATA_ROOT")
    order = ("native", "python", "python", "native")
    try:
        os.environ["I2VSGG_DATA_ROOT"] = devkit
        for name, extra in (("default", []),
                            ("host_planes", ["--host_planes"])):
            runs = {arm: [] for arm in order}
            want = dict(expect, conv1=1) if extra else expect
            outputs = {}
            for k, arm in enumerate(order):
                argv = DRIVER_FULL + [
                    "--load_name", files["det"], "--sgg_load_name",
                    files["sgg"], "--max_det", str(FULL["max_det"]),
                    "--save_dir", os.path.join(out, f"{name}_{arm}_{k}")
                ] + extra
                pattern = (("torch",) if arm == "python" else
                           PACK_ORDER if k == 0 else
                           PACK_ORDER[2:] + PACK_ORDER[:2])
                with env_set(python if arm == "python" else {}), \
                        timed_packer(pattern) as packs, \
                        timed_loaders() as loops, \
                        recorded_programs() as calls:
                    driver_launches(counters, f"18d serve_video {name} "
                                    f"({arm}, run {k + 1} of {len(order)})",
                                    lambda: serve_video.main(argv), want,
                                    n_req)
                (loop,) = loops
                if loop["path"].startswith("native") != (arm == "native"):
                    raise AssertionError(f"18d {name} {arm}: {loop['path']}")
                if len(packs) != (n_req if extra else 0):
                    raise AssertionError(f"18d {name} {arm}: {len(packs)} "
                                         f"packs for {n_req} requests")
                runs[arm].append(dict(loop, packs=packs,
                                      program_ms=[m for _, m in calls]))
                outputs.setdefault(arm, [o for o, _ in calls])
            summary = {arm: arm_summary(r) for arm, r in runs.items()}
            gap = output_gap(outputs["native"], outputs["python"])
            rec[f"serve_video {name}"] = {
                "order": list(order), "requests_a_run": n_req,
                "runs": runs, "steady": summary, "detection_gap": gap}
            log(f"18d serve_video {name}: {n_req} requests of {b} frames a "
                f"run, runs in the order {', '.join(order)}; steady state "
                "(the first request of each run left out): " + "; ".join(
                    f"{arm} loader frames/s "
                    f"{' / '.join(f'{v:.2f}' for v in m['steady_fps'])}, ms a "
                    f"request (median) {m['request_ms_median']:.2f}, loader "
                    f"wait {m['wait_ms_median']:.2f}"
                    + (f", pack {m['pack_ms_median']:.2f}"
                       if m["pack_ms_median"] is not None else "")
                    for arm, m in summary.items())
                + f"; detections native vs python loader: {gap} (reported, "
                f"not held) [{card}, {os.cpu_count()} CPUs]")
            if extra:
                pp = packer_pairs(runs["native"])
                rec[f"serve_video {name}"]["packer_pairs"] = pp
                m = pp["medians"]
                log(f"18d serve_video {name}, the packers on alternate "
                    f"requests of the native loader's runs: the native "
                    f"packer's request faster in {pp['native_wins']} of "
                    f"{len(pp['pairs'])} pairs, its pack in "
                    f"{pp['native_pack_wins']}; medians, request ms "
                    f"{m['native_ms']:.2f} native / {m['torch_ms']:.2f} "
                    f"torch, pack ms {m['native_pack_ms']:.2f} / "
                    f"{m['torch_pack_ms']:.2f} [{card}, {os.cpu_count()} "
                    "CPUs]")
        os.environ["I2VSGG_DATA_ROOT"] = mvrd_root
        runs = {}
        n_batches = -(-MVRD_IMAGES // MVRD_EVAL_BS)
        for loader in ("native", "python"):
            save = os.path.join(out, f"det_{loader}")
            with env_set(python if loader == "python" else {}), \
                    timed_loaders() as loops:
                aps, _ = driver_launches(
                    counters, f"18d test_det ({loader} loader)",
                    lambda: test_det.main(MVRD_EVAL_ARGS + [
                        "--load_name", files["det"], "--save_dir", save]),
                    dict(NO_LAUNCHES, roi_align=2), n_batches)
            with open(os.path.join(save, "eval", "MVRD_test",
                                   "detections.pkl"), "rb") as fh:
                dets = pickle.load(fh)
            runs[loader] = dict(loops[0], mAP=float(aps["mAP"]), dets=dets)
        cells = [(a, c) for ca, cc in zip(runs["native"]["dets"],
                                          runs["python"]["dets"])
                 for a, c in zip(ca, cc)]
        differ = sum(a.shape != c.shape or not np.array_equal(a, c)
                     for a, c in cells)
        rec["test_det stills"] = {
            k: {key: v for key, v in r.items() if key != "dets"}
            for k, r in runs.items()}
        rec["test_det stills"]["cells_differ"] = differ
        log(f"18d test_det on {MVRD_IMAGES} MVRD stills ({n_batches} "
            f"batches, start-up included: a smoke reading, not a rate): "
            f"{runs['native']['fps']:.2f} images/s native, "
            f"{runs['python']['fps']:.2f} Python path; mAP "
            f"{runs['native']['mAP']:.4f} / {runs['python']['mAP']:.4f}; "
            f"{differ} of {len(cells)} (class, image) detection cells differ "
            f"(reported, not held) [{card}]")
    finally:
        if saved_env is None:
            os.environ.pop("I2VSGG_DATA_ROOT", None)
        else:
            os.environ["I2VSGG_DATA_ROOT"] = saved_env
    return rec


def native_loader_on_card(counters, card: str, work: str, drivers: dict,
                          build: dict) -> dict:
    """Phase 18 (see the module docstring) on 13a's devkit and 13b's
    checkpoints under ``work``, with an MVRD devkit of the committed stills
    (14c's) and 18d's longer devkit (``DEVKIT_18D``) written beside
    them."""
    phase("18a the native loader's decode: every committed JPEG fixture and "
          "its PNG golden through runtime.decode_image")
    rec = {"18a decode": native_decode_on_host(build)}
    phase("18b runtime.load_batch at the drivers' scale: 13a's PNG frames "
          "and 14c's JPEG stills, 1 and 8 threads, held to the plain "
          "version, timed beside the Python path")
    files = drivers["files"]
    mvrd = os.path.join(work, "data18")
    write_mvrd_devkit(mvrd)
    frames = sorted(os.path.join(files["data"], "MVidVRD", "JPEGImages", f)
                    for f in os.listdir(os.path.join(
                        files["data"], "MVidVRD", "JPEGImages")))
    stills = sorted(os.path.join(mvrd, "MVRD", "JPEGImages", f)
                    for f in os.listdir(os.path.join(mvrd, "MVRD",
                                                     "JPEGImages")))
    rec["18b frames"] = native_batches_on_host(card, "PNG frames", frames)
    rec["18b stills"] = native_batches_on_host(card, "JPEG stills", stills)
    phase("18c runtime.pack_planes at (4, 600, 960) and (4, 608, 1216) "
          "against the torch packer")
    rec["18c packer"] = native_packer_on_host(card)
    phase("18d the drivers with the native loader and with "
          "I2VSGG_NATIVE_IO=0: serve_video (default, --host_planes with "
          "the two packers on alternate requests) on a 48-frame devkit, "
          "runs in alternating order, test_det on the stills")
    devkit = os.path.join(work, "data18d")
    write_devkit(devkit, seed=18, shape=DEVKIT_18D)
    rec["18d drivers"] = native_drivers_on_card(
        counters, card, files, devkit, mvrd, os.path.join(work, "out18"))
    return rec


# ----------------------------------------------------------------------------
# phase 19: the decode formats of the sixteenth slice (progressive and
# separate-scan JPEG, PNG at every bit depth and Adam7-interlaced) in both of
# the port's decoders: the committed fixtures of tests/data/decode, host ms
# beside their baseline and 8-bit twins, and the drivers on twin devkits

DECODE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "data", "decode")
# Adam7's seven passes: first column, first row, column step, row step
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# 19a's timed kinds, in the order of each rep (reversed every other rep)
FORMAT_KINDS = ("baseline", "progressive", "png8", "png16", "adam7")
# the sets of tests/data/decode that phase 19 holds (phase 22 the others)
FORMAT_SETS = ("jpeg", "prefix", "png", "frames")


def decode_manifest() -> dict:
    with open(os.path.join(DECODE_DIR, "MANIFEST.json")) as fh:
        return json.load(fh)


def png_frame(path: str, bgr: np.ndarray, depth: int = 8,
              interlace: int = 0):
    """``bgr`` (H, W, 3) uint8 as an RGB PNG of ``depth`` 8 or 16 bits (a
    sample v stored as v * 257, whose high byte is v), Adam7-interlaced
    where ``interlace``, every row of every pass unfiltered, as
    ``write_png`` writes 13a's frames; zlib level 6."""
    import struct
    import zlib
    rgb = bgr[..., ::-1]
    if depth == 16:
        rgb = (rgb.astype(np.uint16) * 257).astype(">u2")
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(b"\0" + row.tobytes() for x0, y0, dx, dy in passes
                   for row in rgb[y0::dy, x0::dx] if row.size)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    h, w = bgr.shape[:2]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0,
                                              0, interlace))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


def host_times(kinds: dict, order: tuple) -> dict:
    """Host ms a frame of each kind of ``kinds`` ({kind: paths}, frames of
    one size): the decode alone (``runtime.decode_image``, median of
    ``DECODE_REPS``; ``imread_bgr``, median of 3) and ``runtime.load_batch``
    at the drivers' scale at 1 and 8 threads (median of ``LOADER_REPS``
    batches), the kinds taken in ``order``, reversed every other rep."""
    from i2vsgg_tpu_torch import runtime
    from i2vsgg_tpu_torch.data.image_io import imread_bgr
    from i2vsgg_tpu_torch.data.pipeline import bucket_hw
    h, w = imread_bgr(kinds["baseline"][0]).shape[:2]
    scale = 600 / min(h, w)
    pad = bucket_hw(int(round(h * scale)), int(round(w * scale)))
    decode = {k: [] for k in kinds}
    python = {k: [] for k in kinds}
    batch = {(k, t): [] for k in kinds for t in (1, 8)}
    for rep in range(max(DECODE_REPS, LOADER_REPS)):
        in_order = order if rep % 2 == 0 else order[::-1]
        for kind in in_order:
            paths = kinds[kind]
            if rep < DECODE_REPS:
                for p in paths:
                    t = time.perf_counter()
                    runtime.decode_image(p)
                    decode[kind].append(1e3 * (time.perf_counter() - t))
            if rep < 3:
                for p in paths:
                    t = time.perf_counter()
                    imread_bgr(p)
                    python[kind].append(1e3 * (time.perf_counter() - t))
            if rep < LOADER_REPS:
                for n_threads in (1, 8):
                    t = time.perf_counter()
                    runtime.load_batch(paths, [False] * len(paths), MEANS,
                                       600, *pad, n_threads=n_threads)
                    batch[(kind, n_threads)].append(
                        1e3 * (time.perf_counter() - t) / len(paths))
    rec = {"frames_hw": [h, w], "pad": list(pad),
           "bytes": {k: [os.path.getsize(p) for p in v]
                     for k, v in kinds.items()}}
    for kind in kinds:
        rec[kind] = {
            "decode_ms": {"median": float(np.median(decode[kind])),
                          "min": min(decode[kind]), "max": max(decode[kind])},
            "python_decode_ms": float(np.median(python[kind])),
            "load_batch_ms_1": float(np.median(batch[(kind, 1)])),
            "load_batch_ms_8": float(np.median(batch[(kind, 8)]))}
    return rec


def decode_formats_on_host(card: str, frames: list, work: str) -> dict:
    """19a: every fixture of ``FORMAT_SETS`` (``tests/data/decode``'s sets
    of the sixteenth slice) through both decoders
    (``image_io.imread_bgr``, the Python path; ``runtime.decode_image``,
    the native runtime): each held to its golden (cv2's decode, an 8-bit
    PNG), each progressive 360x640 frame to its baseline twin's decode.
    Then host ms a frame for five kinds of four 360x640 frames each: the
    committed baseline JPEG frames and their progressive twins, four of
    13a's 8-bit PNG frames (``frames``) and the same pictures written here
    at 16 bits and Adam7-interlaced (``png_frame``); the decode alone
    (``decode_image``, median of ``DECODE_REPS``; ``imread_bgr``, median
    of 3) and ``runtime.load_batch`` at the drivers' scale at 1 and 8
    threads (median of ``LOADER_REPS`` batches), the kinds in alternating
    order. Returns the record and the paths of each kind."""
    from i2vsgg_tpu_torch import runtime
    from i2vsgg_tpu_torch.data.image_io import imread_bgr
    manifest = {k: v for k, v in decode_manifest().items()
                if v["set"] in FORMAT_SETS}
    held, twins = {}, 0
    for name, entry in sorted(manifest.items()):
        path = os.path.join(DECODE_DIR, entry["file"])
        py, native = imread_bgr(path), runtime.decode_image(path)
        if "golden" in entry:
            want = imread_bgr(os.path.join(DECODE_DIR, entry["golden"]))
        elif "twin" in entry:
            want = imread_bgr(os.path.join(DECODE_DIR, entry["twin"]))
            twins += 1
        else:
            want = py                 # a baseline twin: held by its twin
        for what, got in (("imread_bgr", py), ("decode_image", native)):
            if list(got.shape) != entry["shape"] or \
                    not np.array_equal(got, want):
                raise AssertionError(f"19a {name}: {what} != its golden or "
                                     "twin")
        held[entry["set"]] = held.get(entry["set"], 0) + 1
    if twins != 4:
        raise AssertionError(f"19a: {twins} progressive frames, not 4")
    log(f"19a: {sum(held.values())} fixtures held on both paths "
        f"({', '.join(f'{k} {v}' for k, v in sorted(held.items()))}): each "
        "to its golden, the progressive frames to their baseline twins")

    kinds = {"baseline": [], "progressive": [], "png8": [], "png16": [],
             "adam7": []}
    for name in sorted(k for k, v in manifest.items() if "twin" in v):
        kinds["progressive"].append(os.path.join(
            DECODE_DIR, manifest[name]["file"]))
        kinds["baseline"].append(os.path.join(DECODE_DIR,
                                              manifest[name]["twin"]))
    for k, src in enumerate(frames[:4]):
        bgr = imread_bgr(src)
        kinds["png8"].append(src)
        for kind, kw in (("png16", dict(depth=16)),
                         ("adam7", dict(interlace=1))):
            path = os.path.join(work, f"{kind}_{k}.png")
            png_frame(path, bgr, **kw)
            if not (np.array_equal(runtime.decode_image(path), bgr)
                    and np.array_equal(imread_bgr(path), bgr)):
                raise AssertionError(f"19a {kind} frame {k}: decoded != "
                                     "the picture written")
            kinds[kind].append(path)
    rec = dict({"held": held}, **host_times(kinds, FORMAT_KINDS))
    rel = {k: rec[k]["decode_ms"]["median"] / rec[base]["decode_ms"]["median"]
           for k, base in (("progressive", "baseline"), ("png16", "png8"),
                           ("adam7", "png8"))}
    rec["decode_ratio"] = rel
    log("19a host ms a 360x640 frame (native decode median of "
        f"{DECODE_REPS} / Python path median of 3 / load_batch at scale "
        f"600 into {rec['pad'][0]}x{rec['pad'][1]} on 1 and 8 threads): "
        + "; ".join(
            f"{k} {rec[k]['decode_ms']['median']:.2f} / "
            f"{rec[k]['python_decode_ms']:.2f} / "
            f"{rec[k]['load_batch_ms_1']:.2f}, "
            f"{rec[k]['load_batch_ms_8']:.2f}" for k in kinds)
        + "; decode ratios " + ", ".join(f"{k} {v:.2f}x"
                                         for k, v in rel.items())
        + f" [host CPU of the machine of {card}, {os.cpu_count()} CPUs]")
    return rec, kinds


def twin_devkits(src: str, kinds: dict, work: str) -> dict:
    """19b's two MVidVRD devkits, copies of 13a's (``src``, its 12 PNG
    frames and annotations, without its roidb cache): in "new formats" the
    first four frames are the committed progressive frames, the next four
    16-bit and the last four Adam7 copies of the frames they replace; in
    "twins" the same pictures as the baseline twins and 13a's 8-bit PNGs.
    The loaders dispatch on a file's first bytes, not its name, so a JPEG
    frame keeps its devkit name ``vid<v>_<fno>.png``."""
    from i2vsgg_tpu_torch.data.image_io import imread_bgr
    roots = {}
    for name in ("new formats", "twins"):
        root = os.path.join(work, "data19_" + name.replace(" ", "_"))
        shutil.copytree(os.path.join(src, "MVidVRD"),
                        os.path.join(root, "MVidVRD"),
                        ignore=shutil.ignore_patterns("cache"))
        roots[name] = root
    images = os.path.join("MVidVRD", "JPEGImages")
    names = sorted(os.listdir(os.path.join(src, images)))
    if len(names) != 12:
        raise AssertionError(f"19b: 13a's devkit has {len(names)} frames")
    for k, name in enumerate(names):
        new = os.path.join(roots["new formats"], images, name)
        twin = os.path.join(roots["twins"], images, name)
        if k < 4:
            shutil.copyfile(kinds["progressive"][k], new)
            shutil.copyfile(kinds["baseline"][k], twin)
        else:
            png_frame(new, imread_bgr(twin), **(
                dict(depth=16) if k < 8 else dict(interlace=1)))
    return roots


def drivers_over_twin_devkits(counters, card: str, files: dict, roots: dict,
                              work: str, what: str = "19b") -> dict:
    """19b (and 22b): ``serve_video`` (default: RoIAlignAvg at the
    detector, RoIPool at the SGG site) and ``test_det`` with 13b's
    checkpoints over two devkits of the same pictures (``roots``: "new
    formats" and "twins"), launches counted as 13b counts them, with
    ``cudnn.deterministic`` set: each request's detections and
    ``rel_prob`` bit-equal between the devkits, and so the files the
    drivers write; the loaders' host ms beside."""
    from i2vsgg_tpu_torch.tools import serve_video, test_det
    b = FULL["frames"]
    n_req = 12 // b
    rec = {}
    saved_env = os.environ.get("I2VSGG_DATA_ROOT")
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    outs, dets = {}, {}
    try:
        for name, root in roots.items():
            os.environ["I2VSGG_DATA_ROOT"] = root
            out = os.path.join(work, f"out{what}_" + name.replace(" ", "_"))
            with timed_loaders() as loops, recorded_programs() as calls:
                driver_launches(
                    counters, f"{what} serve_video ({name})",
                    lambda: serve_video.main(DRIVER_FULL + [
                        "--load_name", files["det"], "--sgg_load_name",
                        files["sgg"], "--max_det", str(FULL["max_det"]),
                        "--save_dir", out]),
                    dict(NO_LAUNCHES, roi_align=2, roi_pool=b), n_req)
            outs[name] = [o for o, _ in calls]
            with open(os.path.join(out, "serve", "MVidVRD_test",
                                   "frame_detections.json")) as fh:
                outs[name + " json"] = json.load(fh)
            with timed_loaders() as det_loops:
                aps, _ = driver_launches(
                    counters, f"{what} test_det ({name})",
                    lambda: test_det.main(DRIVER_FULL + [
                        "--load_name", files["det"], "--save_dir", out]),
                    dict(NO_LAUNCHES, roi_align=2), n_req)
            with open(os.path.join(out, "eval", "MVidVRD_test",
                                   "detections.pkl"), "rb") as fh:
                dets[name] = pickle.load(fh)
            rec[name] = {"serve_wait_ms": loops[0]["wait_ms"],
                         "serve_request_ms": [m for _, m in calls],
                         "test_det_wait_ms": det_loops[0]["wait_ms"],
                         "test_det_mAP": float(aps["mAP"])}
        new, twin = outs["new formats"], outs["twins"]
        if len(new) != n_req or len(twin) != n_req:
            raise AssertionError(f"{what}: {len(new)} and {len(twin)} "
                                 "requests")
        for k, (a, c) in enumerate(zip(new, twin)):
            same_outputs(a, c, f"{what} serve_video request {k + 1}: new "
                         "formats against their twins")
        if outs["new formats json"] != outs["twins json"]:
            raise AssertionError(f"{what}: frame_detections.json differ")
        cells = [(a, c) for ca, cc in zip(dets["new formats"], dets["twins"])
                 for a, c in zip(ca, cc)]
        if not all(a.shape == c.shape and np.array_equal(a, c)
                   for a, c in cells):
            raise AssertionError(f"{what} test_det: detections differ")
        rec["bit_equal"] = {"requests": n_req, "detection_cells": len(cells)}
    finally:
        torch.backends.cudnn.deterministic = saved_det
        if saved_env is None:
            os.environ.pop("I2VSGG_DATA_ROOT", None)
        else:
            os.environ["I2VSGG_DATA_ROOT"] = saved_env
    log(f"{what} serve_video and test_det over the twin devkits: {n_req} "
        "requests' detections and rel_prob bit-equal, frame_detections.json "
        f"equal, {len(cells)} test_det detection cells equal; loader waits "
        "ms a request " + "; ".join(
            f"{k} {', '.join(f'{w:.2f}' for w in r['serve_wait_ms'])}"
            for k, r in rec.items() if k != "bit_equal")
        + f" [{card}]")
    return rec


def decode_formats_on_card(counters, card: str, work: str,
                           drivers: dict) -> dict:
    """Phase 19 (see the module docstring) on 13a's devkit and 13b's
    checkpoints under ``work``."""
    phase("19a decode formats: every fixture of tests/data/decode through "
          "both decoders, held to its golden or baseline twin; host ms a "
          "frame of progressive against baseline JPEG, 16-bit and Adam7 "
          "against 8-bit PNG, on 1 and 8 threads")
    files = drivers["files"]
    images = os.path.join(files["data"], "MVidVRD", "JPEGImages")
    frames = sorted(os.path.join(images, f) for f in os.listdir(images))
    d = os.path.join(work, "frames19")
    os.makedirs(d, exist_ok=True)
    rec, kinds = decode_formats_on_host(card, frames, d)
    rec = {"19a host": rec}
    phase("19b serve_video (default: B1, B2) and test_det over twin "
          "devkits, the new formats against baseline JPEG and 8-bit PNG: "
          "detections and rel_prob bit-equal")
    rec["19b drivers"] = drivers_over_twin_devkits(
        counters, card, files, twin_devkits(files["data"], kinds, work),
        work)
    return rec


# ----------------------------------------------------------------------------
# phase 20: the int8 trunk's calibration and quality gate on the card
# (``tools/calibrate_act_scales.py``, ``tools/test_det.py`` under ``mxu`` and
# ``sim``, ``tools/quant_trunk_ab.py``) from 14c's checkpoint on its MVRD
# stills, in phase 14's work directory

# 20a: the calibration as a user runs it on 14c's checkpoint (bf16, TEST
# scale 600): two batches of 4 stills
CALIB_ARGS = ["--dataset", "MVRD", "--net", "res101", "--n_images", "8",
              "--bs", "4"]
CALIB_BATCHES = 2
# the int8 convs a batch under INT8_SCOPE: the 3x3s of layer2 (4), layer3
# (23) and layer4 (3, on the rois)
INT8_CONVS = 30
# 20b: the sim arm against the mxu arm of test_det on 14c's checkpoint,
# detections matched per class and image (``detection_gaps``). Above
# K = 1040 an f32 sum of integer taps rounds (layer3's 3x3 at K = 2304,
# layer4's at 4608), so the arms may part by a bf16 ulp here and there,
# which a static quantization may turn into an int8 step downstream. The
# first H100 runs measured no gap at all (800 of 800 detections matched,
# boxes, scores and APs equal; PERF.md section 6); the limits leave room
# for such a step
SIM_TOL = {"box_px": 0.5, "score": 1e-3, "ap": 1e-3, "unmatched": 0.01}


def detection_gaps(a: list, b: list, box_px: float) -> dict:
    """Two ``detections.pkl`` (per class, per image, (N, 5) rows: box,
    score): each row of ``a``, in descending score, taken by the free row of
    ``b`` of its class and image with the nearest box, matched where that
    box lies within ``box_px``. Returns the rows on each side, the matched
    pairs, their largest box and score gaps, and the unmatched rows' share
    and highest score (near ties at the top-100 cut change places)."""
    rows = matched = 0
    box_gap = score_gap = top_unmatched = 0.0
    n_b = 0
    for per_a, per_b in zip(a, b):
        for da, db in zip(per_a, per_b):
            rows += len(da)
            n_b += len(db)
            free = list(range(len(db)))
            for i in np.argsort(-da[:, 4], kind="stable"):
                if not free:
                    top_unmatched = max(top_unmatched, float(da[i, 4]))
                    continue
                gaps = [float(np.abs(db[j, :4] - da[i, :4]).max())
                        for j in free]
                k = int(np.argmin(gaps))
                if gaps[k] > box_px:
                    top_unmatched = max(top_unmatched, float(da[i, 4]))
                    continue
                j = free.pop(k)
                matched += 1
                box_gap = max(box_gap, gaps[k])
                score_gap = max(score_gap, float(abs(db[j, 4] - da[i, 4])))
            for j in free:
                top_unmatched = max(top_unmatched, float(db[j, 4]))
    unmatched = (rows - matched) + (n_b - matched)
    return {"rows": rows, "rows_other": n_b, "matched": matched,
            "box_px": box_gap, "score": score_gap,
            "unmatched": unmatched / max(rows + n_b, 1),
            "top_unmatched_score": top_unmatched}


def calibration_on_card(counters, card: str, work: str,
                        stage_a: str) -> tuple:
    """20a: ``calibrate_act_scales.main`` on 14c's checkpoint and stills.
    Its file must hold the committed res101 file's 103 keys, every scale
    finite and > 0 and equal, bit for bit, to the witness: the input
    abs-max of every ``BNConv`` call, taken by a forward hook
    (``recorded_calls``) on the detector the tool builds, / 127. The RoI
    launches (B1, 2 a batch) are counted from just before the call to just
    after it. Returns (record, the file's path)."""
    from i2vsgg_tpu_torch.models import faster_rcnn
    from i2vsgg_tpu_torch.models.backbones import BNConv
    from i2vsgg_tpu_torch.tools import calibrate_act_scales
    path = os.path.join(work, "act_scales_res101.json")
    hooks = []
    real = faster_rcnn.FasterRCNN_DA

    def hooked(*a, **k):
        det = real(*a, **k)
        hooks.append(recorded_calls(
            {n: m for n, m in det.named_modules() if isinstance(m, BNConv)},
            keep=lambda args, out: (args[0].float().abs().max(),)))
        hooks[-1].__enter__()
        return det

    faster_rcnn.FasterRCNN_DA = hooked
    counters.reset()
    t = time.time()
    try:
        scales = calibrate_act_scales.main(
            CALIB_ARGS + ["--ckpt", stage_a, "--json", path])
        torch.cuda.synchronize()
        wall = time.time() - t
        launched = counters.read()
    finally:
        faster_rcnn.FasterRCNN_DA = real
        for h in hooks:
            h.__exit__(None, None, None)
    if len(hooks) != 1:
        raise AssertionError(f"20a: {len(hooks)} detectors built")
    witness: dict = {}
    for name, m in hooks[0].calls:
        key = name.replace(".", "/")
        witness[key] = max(witness.get(key, 0.0), float(m))
    with open(ACT_SCALES) as fh:
        committed = json.load(fh)["scales"]
    with open(path) as fh:
        written = json.load(fh)
    if set(scales) != set(committed) or len(scales) != 103:
        raise AssertionError(f"20a: {len(scales)} keys; not the committed "
                             f"file's {len(committed)}")
    if sum(k.startswith("head/") for k in scales) != 10:
        raise AssertionError("20a: not 10 head/ keys")
    bad = [k for k, v in scales.items() if not (np.isfinite(v) and v > 0)]
    if bad:
        raise AssertionError(f"20a: scales not finite and > 0: {bad}")
    off = [k for k in scales if scales[k] != witness.get(k, -1.0) / 127.0]
    if off or set(witness) != set(scales):
        raise AssertionError(f"20a: scales != the hooks' abs-max / 127 at "
                             f"{off[:5]}")
    if (written["n_images"] != 8 or written["ckpt"] != stage_a
            or written["scales"] != scales):
        raise AssertionError(f"20a: the file holds {written['n_images']} "
                             f"images, {written['ckpt']}")
    if launched != dict(NO_LAUNCHES, roi_align=2 * CALIB_BATCHES):
        raise AssertionError(f"20a: launches {launched}")
    ratio = np.array([scales[k] / committed[k] for k in sorted(scales)])
    rec = {"keys": len(scales), "n_images": written["n_images"],
           "wall_s": wall, "host_ms_per_image": 1e3 * wall / 8,
           "hook_calls": len(hooks[0].calls),
           "roi_align_per_batch": launched["roi_align"] // CALIB_BATCHES,
           "scale_min": min(scales.values()),
           "scale_max": max(scales.values()),
           "vs_committed_median": float(np.median(ratio))}
    log(f"20a: calibrated {rec['keys']} convs on 8 stills in {wall:.2f} s "
        f"({rec['host_ms_per_image']:.1f} host ms an image, the detector's "
        f"build and restore included), {rec['hook_calls']} conv calls "
        "witnessed, every scale equal to its hook's abs-max / 127; B1 "
        f"{rec['roi_align_per_batch']} a batch; scales "
        f"{rec['scale_min']:.4g}-{rec['scale_max']:.4g}, median "
        f"{rec['vs_committed_median']:.3g}x the committed file's "
        f"(another model) [{card}]")
    return rec, path


@contextlib.contextmanager
def timed_detection(test_det):
    """Within the block, the host seconds of each ``test_det`` run's
    detection loop (``run_detection``, from its first batch to its last),
    appended to the list yielded."""
    real, spans = test_det.run_detection, []

    def timed(*a, **k):
        t = time.time()
        yield from real(*a, **k)
        torch.cuda.synchronize()
        spans.append(time.time() - t)

    test_det.run_detection = timed
    try:
        yield spans
    finally:
        test_det.run_detection = real


def sim_vs_mxu_on_card(counters, card: str, work: str, stage_a: str,
                       calib: str) -> dict:
    """20b: ``test_det`` on the whole ``MVRD_test`` split from 14c's
    checkpoint with 20a's file, ``--int8_trunk mxu:<scope>`` and
    ``sim:<scope>`` in the order mxu, sim, sim, mxu, so that neither arm
    always runs first: the int8 products run in the mxu runs only; each sim
    run's detections and APs held to the first mxu run's within
    ``SIM_TOL``; images/s of each run's detection loop, as records (8
    stills a run: the host's spread is of the size of a gap between the
    arms)."""
    from i2vsgg_tpu_torch.tools import test_det
    runs = {"mxu": [], "sim": []}
    for i, kind in enumerate(("mxu", "sim", "sim", "mxu")):
        out = os.path.join(work, f"out20_{i}_{kind}")
        counters.reset()
        with timed_detection(test_det) as spans:
            aps = test_det.main(MVRD_EVAL_ARGS + [
                "--load_name", stage_a, "--save_dir", out, "--int8_trunk",
                f"{kind}:{INT8_SCOPE}", "--act_scales", calib])
        launched = counters.read()
        want = dict(NO_LAUNCHES, roi_align=2 * CALIB_BATCHES,
                    int8_conv2d=INT8_CONVS * CALIB_BATCHES * (kind == "mxu"))
        if launched != want:
            raise AssertionError(f"20b {kind}: launches {launched}, "
                                 f"expected {want}")
        if os.environ.get("I2VSGG_INT8_PREQ_SIM") != (
                "1" if kind == "sim" else None):
            raise AssertionError(f"20b {kind}: I2VSGG_INT8_PREQ_SIM "
                                 f"{os.environ.get('I2VSGG_INT8_PREQ_SIM')}")
        with open(os.path.join(out, "eval", "MVRD_test", "detections.pkl"),
                  "rb") as fh:
            dets = pickle.load(fh)
        runs[kind].append({"aps": {k: float(v) for k, v in aps.items()},
                           "dets": dets, "loop_s": spans[0],
                           "images_per_s": MVRD_IMAGES / spans[0]})
    ref = runs["mxu"][0]
    all_gaps = []
    for run in runs["sim"]:
        gaps = detection_gaps(ref["dets"], run["dets"], SIM_TOL["box_px"])
        gaps["ap"] = max(abs(run["aps"][k] - v)
                         for k, v in ref["aps"].items())
        all_gaps.append(gaps)
        bad = [k for k in ("box_px", "score", "ap", "unmatched")
               if not gaps[k] <= SIM_TOL[k]]
        if bad:
            raise AssertionError(f"20b: sim vs mxu {bad} beyond {SIM_TOL}: "
                                 f"{gaps}")
    rates = {k: [r["images_per_s"] for r in rs] for k, rs in runs.items()}
    for gaps in all_gaps:
        log(f"20b: sim vs mxu, {gaps['matched']} of {gaps['rows']} / "
            f"{gaps['rows_other']} detections matched; largest gaps: box "
            f"{gaps['box_px']:.4g} px, score {gaps['score']:.3g}, AP "
            f"{gaps['ap']:.3g}; unmatched share {gaps['unmatched']:.4f} "
            f"(highest score {gaps['top_unmatched_score']:.3g})")
    log(f"20b: mAP mxu {ref['aps']['mAP']:.4f}, sim "
        f"{runs['sim'][0]['aps']['mAP']:.4f} (5 steps of training: printed, "
        f"not held); detection loop images/s in run order mxu "
        f"{rates['mxu'][0]}, sim {rates['sim'][0]}, sim {rates['sim'][1]}, "
        f"mxu {rates['mxu'][1]} [{card}]")
    return {"gaps": all_gaps, **{k: [{x: r[x] for x in ("aps", "loop_s",
                                                       "images_per_s")}
                                     for r in rs]
                                 for k, rs in runs.items()}}


def gate_on_card(counters, card: str, work: str, stage_a: str,
                 calib: str) -> dict:
    """20c: ``quant_trunk_ab.main`` on a copy of 14c's checkpoint: the fp
    arm and an ``mxu:<scope>`` arm with 20a's file; again with
    ``--reuse_fp``, which must copy the fp arm; then, one file of the copy
    rewritten, ``--reuse_fp`` must refuse."""
    from i2vsgg_tpu_torch.tools import quant_trunk_ab
    step = int(os.path.basename(stage_a))
    step_dir = f"step_{step:08d}"
    copy_dir = os.path.join(work, "ab_ckpt")
    shutil.copytree(os.path.join(os.path.dirname(stage_a), step_dir),
                    os.path.join(copy_dir, step_dir))
    ckpt = os.path.join(copy_dir, str(step))
    base = ["--out", os.path.join(work, "ab"), "--ckpt", ckpt, "--data",
            os.path.join(work, "data"), "--net", "res101", "--dataset",
            "MVRD", "--mode", f"mxu:{INT8_SCOPE}", "--act_scales", calib]
    first_json = os.path.join(work, "ab", "first.json")
    counters.reset()
    t = time.time()
    first = quant_trunk_ab.main(base + ["--json", first_json])
    first_s = time.time() - t
    launched = counters.read()
    # --bs 1: each arm one batch a still
    want = dict(NO_LAUNCHES, roi_align=2 * 2 * MVRD_IMAGES,
                int8_conv2d=INT8_CONVS * MVRD_IMAGES)
    if launched != want:
        raise AssertionError(f"20c: launches {launched}, expected {want}")
    t = time.time()
    again = quant_trunk_ab.main(base + [
        "--json", os.path.join(work, "ab", "again.json"), "--reuse_fp",
        first_json])
    again_s = time.time() - t
    if (again["fp"] != first["fp"] or again.get("fp_reused_from")
            != first_json or set(again["delta"]) != {"MVRD"}):
        raise AssertionError(f"20c --reuse_fp: {again} against {first}")
    meta = os.path.join(copy_dir, step_dir, "metadata.json")
    with open(meta, "a") as fh:
        fh.write("\n")
    try:
        quant_trunk_ab.main(base + [
            "--json", os.path.join(work, "ab", "refused.json"),
            "--reuse_fp", first_json])
    except ValueError as e:
        if "rewritten" not in str(e):
            raise
        refused = str(e)
    else:
        raise AssertionError("20c: --reuse_fp took the fp arm of a "
                             "rewritten checkpoint")
    rec = {"fp_mAP": first["fp"]["MVRD"]["mAP"],
           "int8_mAP": first["int8"]["MVRD"]["mAP"],
           "delta": first["delta"]["MVRD"],
           "int8_mAP_again": again["int8"]["MVRD"]["mAP"], "first_s": first_s,
           "reuse_s": again_s, "fingerprint": first["ckpt_fingerprint"],
           "refused": refused}
    log(f"20c: quant_trunk_ab fp mAP {rec['fp_mAP']:.4f}, int8 (mxu, "
        f"static scales) {rec['int8_mAP']:.4f}, delta {rec['delta']:+.4f} "
        "(a 5-step checkpoint: a record, not a claim about int8 quality); "
        f"{first_s:.1f} s, with --reuse_fp {again_s:.1f} s; the rewritten "
        f"copy refused [{card}]")
    return rec


def int8_gate_on_card(counters, card: str, work: str, stage_a: str) -> dict:
    """Phase 20a-20c (see above) on 14c's devkit and checkpoint under
    ``work``."""
    saved_env = {k: os.environ.get(k) for k in (
        "I2VSGG_DATA_ROOT", "I2VSGG_INT8_TRUNK", "I2VSGG_INT8_PREQ_SIM")}
    rec = {}
    try:
        os.environ["I2VSGG_DATA_ROOT"] = os.path.join(work, "data")
        phase("20a calibrate_act_scales on the card: 14c's res101 "
              "checkpoint, 8 MVRD stills at scale 600, --bs 4, bf16; every "
              "scale held to a forward hook's abs-max")
        t = time.time()
        rec["20a calibration"], calib = calibration_on_card(
            counters, card, work, stage_a)
        log(f"20a: {time.time() - t:.1f} s")
        phase(f"20b test_det on MVRD_test with 20a's file, --int8_trunk "
              f"mxu:{INT8_SCOPE} and sim:{INT8_SCOPE}, run mxu, sim, sim, "
              "mxu")
        t = time.time()
        rec["20b sim vs mxu"] = sim_vs_mxu_on_card(counters, card, work,
                                                   stage_a, calib)
        log(f"20b: {time.time() - t:.1f} s")
        phase("20c quant_trunk_ab: the fp arm and an mxu arm with 20a's "
              "file, then --reuse_fp, then a rewritten copy refused")
        t = time.time()
        rec["20c quant_trunk_ab"] = gate_on_card(counters, card, work,
                                                 stage_a, calib)
        log(f"20c: {time.time() - t:.1f} s")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rec


# ----------------------------------------------------------------------------
# phase 21: the serving gates on a model the port trains
# (``tools/train_gate_arm.py``, ``tools/capacity_ab.py``,
# ``tools/calibrate_act_scales.py`` + ``tools/quant_trunk_ab.py``,
# ``tools/parity_run.py::train_ours_sgg`` + ``tools/quant_ab.py``), in a
# work directory of its own

# 21a: train_gate_arm's defaults (res101, 288 steps; profile parity240)
GATE_DEPTH = 101
GATE_STEPS = 288
# 21b: the rows bench.py's _gate_rpn_capacity and _gate_det8 read at the
# bench's defaults (pre 1024, rpn 128) and at the round-5 capacity
GATE_ROWS = "1024:128:16,512:128:8,1024:128:8"
# 21c: calibrate_act_scales's defaults (64 test stills, batches of 4)
GATE_CALIB = (64, 4)
# 21d: the step of runs/quant_ab/quant_ab.json's Stage B checkpoint
GATE_SGG_STEPS = 672
# bench.py: an arm below _GATE_FLOOR voids its gate; a lever passes within
# the tolerance of its arm; _RPN_ROWS, the capacity candidates smallest first
GATE_FLOOR = 0.15
GATE_TOL = 0.01
GATE_RPN_ROWS = ((256, 32), (384, 48), (512, 64), (512, 128), (768, 128),
                 (1024, 128))
GATE_BASE = "pre1024_rpn128_det16"
# the arm learned when its mean loss over the last LOSS_WINDOW steps is
# below that over the first
LOSS_WINDOW = 20


def gate_verdicts(capacity: dict, trunk: dict, fc: dict) -> dict:
    """Each serving gate's verdict on this phase's artifacts, by
    ``bench.py``'s rules (``_gate_rpn_capacity`` and ``_gate_det8`` on
    ``capacity``, capacity_ab's results with ``GATE_ROWS``;
    ``_gate_int8trunk`` on ``trunk``, quant_trunk_ab's JSON; ``_gate_int8``
    on ``fc``, quant_ab's): VOID when the float arm is below
    ``GATE_FLOOR``, PASS when the lever is within ``GATE_TOL`` of it (for
    the capacity, the smallest candidate row that is), else FAIL.
    -> {gate: {"verdict", "why"}}."""
    def verdict(base, ok, why):
        if base < GATE_FLOOR:
            return {"verdict": "VOID",
                    "why": f"float arm {base:.4f} below {GATE_FLOOR}"}
        return {"verdict": "PASS" if ok else "FAIL", "why": why}

    base = capacity[GATE_BASE]["mAP"]
    rows = [(k, capacity[k]["mAP"]) for k in (
        f"pre{p}_rpn{n}_det8" for p, n in GATE_RPN_ROWS) if k in capacity]
    passing = [(k, m) for k, m in rows if m >= base - GATE_TOL]
    det8 = capacity["pre1024_rpn128_det8"]["mAP"]
    fp = min(v["mAP"] for v in trunk["fp"].values())
    d = fc["delta"]
    return {
        "rpn_capacity": verdict(base, bool(passing), "; ".join(
            f"{k} {m:.4f}" for k, m in (passing[:1] or rows))
            + f" vs {GATE_BASE} {base:.4f}"),
        "det8": verdict(base, det8 >= base - GATE_TOL,
                        f"det8 {det8:.4f} vs det16 {base:.4f}"),
        "int8_trunk": verdict(fp, all(
            v >= -GATE_TOL for v in trunk["delta"].values()), ", ".join(
            f"d mAP[{k}] {v:+.4f}" for k, v in trunk["delta"].items())),
        "int8_fc": verdict(
            fc["fp32"]["pred_mAP"],
            d["pred_mAP"] >= -GATE_TOL and d["top1_acc"] >= -GATE_TOL,
            f"d pred_mAP {d['pred_mAP']:+.4f}, d top1 "
            f"{d['top1_acc']:+.4f}")}


@contextlib.contextmanager
def last_calls(mod, op: str, keep: int):
    """Within the block, each call of ``mod.<op>`` (a RoI op where a model
    calls it) records its inputs; the deque yielded holds the last
    ``keep`` as (features, rois, args, kwargs)."""
    import collections
    calls, fn = collections.deque(maxlen=keep), getattr(mod, op)

    def call(features, rois, *a, **k):
        calls.append((features.detach(), rois.detach(), a, k))
        return fn(features, rois, *a, **k)

    setattr(mod, op, call)
    try:
        yield calls
    finally:
        setattr(mod, op, fn)


@contextlib.contextmanager
def timed_steps(mod):
    """Within the block, each call of ``mod.train_step`` appends (host
    time at its start, its metrics) to the list yielded; the metrics stay
    tensors, read after the run."""
    real, steps = mod.train_step, []

    def step(*a, **k):
        t = time.perf_counter()
        m = real(*a, **k)
        steps.append((t, m))
        return m

    mod.train_step = step
    try:
        yield steps
    finally:
        mod.train_step = real


def held_gate_sites(op: str, calls, names, what: str, card: str) -> list:
    """The recorded RoI calls held to their plain versions and timed
    (``held_roi_site``), each logged beside its bound."""
    sites = []
    for (fmap, rois, a, k), name in zip(calls, names):
        w = f"{what} {op} {name} ({rois.shape[0]} rois)"
        s = dict(held_roi_site(op, fmap, rois, a, k, w), site=name)
        sites.append(s)
        log(f"{w}: {list(fmap.shape)} {fmap.dtype}, kernel "
            f"{s['ms'] * 1e3:.2f} us of device time, plain "
            f"{s['plain_ms'] * 1e3:.2f} us, bound {s['bound_ms'] * 1e3:.3f} "
            f"us ({s['bound_by']}) [{card}]")
    return sites


def split_size(data: str, ds: str, split: str = "test") -> int:
    with open(os.path.join(data, ds, "ImageSets", "Main",
                           split + ".txt")) as fh:
        return len(fh.read().split())


def gate_arm_on_card(counters, card: str, out: str) -> dict:
    """21a: ``train_gate_arm.main`` (profile parity240, res101, f32, its
    288 steps) on the corpus written under ``<out>/data``: the loss of
    every step, host ms a step, B1 launches (2 a step, nothing else), peak
    memory; the last step's two B1 calls held to their plain version (f32:
    rtol 1e-5) and timed. Fails when the arm did not learn: the mean loss
    of the last ``LOSS_WINDOW`` steps not below that of the first."""
    from i2vsgg_tpu_torch.models import faster_rcnn
    from i2vsgg_tpu_torch.tools import train_gate_arm
    from i2vsgg_tpu_torch.train import det_da
    data = os.path.join(out, "data")
    t = time.time()
    train_gate_arm.ensure_parity_data(data)
    corpus_s = time.time() - t
    log(f"21a: the corpus written in {corpus_s:.1f} s: "
        f"{split_size(data, 'MVRD', 'trainval')} + "
        f"{split_size(data, 'MVRD')} stills, "
        f"{split_size(data, 'MVidVRD', 'trainval')} + "
        f"{split_size(data, 'MVidVRD')} frames (trainval + test)")
    steps = GATE_STEPS
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with timed_steps(det_da) as timed, last_calls(
            faster_rcnn, "roi_align_avg", 2) as calls:
        ckpt_dir, got = driver_launches(
            counters, "21a", lambda: train_gate_arm.main(
                ["--out", out, "--steps", str(steps), "--depth",
                 str(GATE_DEPTH), "--device", "cuda"]),
            dict(NO_LAUNCHES, roi_align=2), steps)
    wall = time.time() - t
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for _, m in timed]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"21a: {len(losses)} steps, losses "
                             f"{losses[:5]}...")
    first = float(np.mean(losses[:LOSS_WINDOW]))
    last = float(np.mean(losses[-LOSS_WINDOW:]))
    step_ms = [1e3 * (b[0] - a[0]) for a, b in zip(timed, timed[1:])]
    rec = {"corpus_s": corpus_s, "train_s": wall, "steps": steps,
           "loss_every_20": losses[LOSS_WINDOW - 1::LOSS_WINDOW],
           "loss_first_20": first, "loss_last_20": last,
           "step_ms_median": float(np.median(step_ms)),
           "step_ms_mean": float(np.mean(step_ms)),
           "roi_align_per_step": got["roi_align"] / steps,
           "peak_bytes": peak,
           "ckpt": os.path.join(ckpt_dir, str(steps))}
    log(f"21a: {steps} steps in {wall:.1f} s, host ms a step median "
        f"{rec['step_ms_median']:.1f} (mean {rec['step_ms_mean']:.1f}), B1 "
        f"{rec['roi_align_per_step']:g} a step, peak {peak / 2 ** 30:.2f} "
        f"GiB [{card}]")
    log(f"21a: loss every 20 steps "
        f"{[round(x, 4) for x in rec['loss_every_20']]}; mean of the first "
        f"20 {first:.4f}, of the last 20 {last:.4f}")
    if not last < first:
        raise AssertionError(f"21a: the arm did not learn: mean loss of the "
                             f"last 20 steps {last} >= first 20 {first}")
    rec["sites"] = held_gate_sites("roi_align", calls, ("source", "target"),
                                   "21a last step", card)
    return rec


def capacity_on_card(counters, card: str, out: str, ckpt: str,
                     cfg: list) -> dict:
    """21b: ``capacity_ab.main --ckpt`` on 21a's checkpoint, its corpus and
    config, at ``GATE_ROWS``: B1 2 an image; the last image's two B1 calls
    (the detector site at test_det's compute dtype) held and timed. Fails
    when the base row's mAP is 0."""
    from i2vsgg_tpu_torch.models import faster_rcnn
    from i2vsgg_tpu_torch.tools import capacity_ab
    data = os.path.join(out, "data")
    n = split_size(data, "MVRD")
    rows = GATE_ROWS.split(",")
    t = time.time()
    with last_calls(faster_rcnn, "roi_align_avg", 2) as calls:
        results, _ = driver_launches(
            counters, "21b", lambda: capacity_ab.main(
                ["--ckpt", ckpt, "--data", data, "--net",
                 f"res{GATE_DEPTH}", "--out",
                 os.path.join(out, "capacity"), "--rows", GATE_ROWS,
                 "--device", "cuda", "--cfg"] + cfg),
            dict(NO_LAUNCHES, roi_align=2), n * len(rows))
    wall = time.time() - t
    log(f"21b: {len(rows)} rows over {n} MVRD test stills in {wall:.1f} s: "
        + ", ".join(f"{k} mAP {v['mAP']:.4f} ({v['eval_s']} s)"
                    for k, v in results.items()) + f" [{card}]")
    if not results[GATE_BASE]["mAP"] > 0:
        raise AssertionError(f"21b: the base row {GATE_BASE} scores mAP 0: "
                             "the arm did not learn")
    return {"results": results, "wall_s": wall, "test_stills": n,
            "sites": held_gate_sites("roi_align", calls, ("det", "ic"),
                                     "21b last image", card)}


def trunk_gate_on_card(counters, card: str, out: str, ckpt: str,
                       cfg: list) -> dict:
    """21c: ``calibrate_act_scales`` on 21a's checkpoint (``GATE_CALIB``:
    its defaults, 64 MVRD test stills in batches of 4), then
    ``quant_trunk_ab --mode mxu:<INT8_SCOPE>`` with those scales on the
    MVRD and MVidVRD test splits; B1 2 a batch, the int8 arm's 3x3 convs of
    layer2-4 in int8 (``INT8_CONVS`` at res101) an image."""
    from i2vsgg_tpu_torch.models.backbones import RESNET_STAGES
    from i2vsgg_tpu_torch.tools import calibrate_act_scales, quant_trunk_ab
    data = os.path.join(out, "data")
    path = os.path.join(out, "act_scales.json")
    base = ["--ckpt", ckpt, "--net", f"res{GATE_DEPTH}", "--data", data]
    n_images, bs = GATE_CALIB
    batches = -(-min(n_images, split_size(data, "MVRD")) // bs)
    t = time.time()
    scales, _ = driver_launches(
        counters, "21c calibration", lambda: calibrate_act_scales.main(
            base + ["--dataset", "MVRD", "--json", path, "--n_images",
                    str(n_images), "--bs", str(bs), "--device", "cuda",
                    "--cfg"] + cfg),
        dict(NO_LAUNCHES, roi_align=2), batches)
    calib_s = time.time() - t
    n = split_size(data, "MVRD") + split_size(data, "MVidVRD")
    # the 3x3s of layer2-4 (INT8_CONVS at res101), one pass an image
    int8_convs = sum(RESNET_STAGES[GATE_DEPTH][1:])
    t = time.time()
    ab, _ = driver_launches(
        counters, "21c quant_trunk_ab", lambda: quant_trunk_ab.main(
            base + ["--out", os.path.join(out, "trunk_ab"), "--dataset",
                    "MVRD", "--dataset_t", "MVidVRD", "--mode",
                    f"mxu:{INT8_SCOPE}", "--act_scales", path, "--json",
                    os.path.join(out, "quant_trunk_ab.json"), "--device",
                    "cuda", "--cfg"] + cfg),
        dict(NO_LAUNCHES, roi_align=2 * 2, int8_conv2d=int8_convs), n)
    ab_s = time.time() - t
    log(f"21c: {len(scales)} scales calibrated in {calib_s:.1f} s; "
        f"quant_trunk_ab in {ab_s:.1f} s: "
        + ", ".join(f"{ds} fp {ab['fp'][ds]['mAP']:.4f} int8 "
                    f"{ab['int8'][ds]['mAP']:.4f} delta "
                    f"{ab['delta'][ds]:+.4f}" for ds in ab["delta"])
        + f" [{card}]")
    return {"scales": len(scales), "calibrate_s": calib_s, "ab_s": ab_s,
            "fp": ab["fp"], "int8": ab["int8"], "delta": ab["delta"]}


def fc_gate_on_card(counters, card: str, out: str) -> dict:
    """21d: ``parity_run.train_ours_sgg`` at res101 for ``GATE_SGG_STEPS``
    steps (the head over the trunk of ``save_init``'s step-0 checkpoint,
    f32, ``vrd_pooling=pool``: B2 once a step, nothing else), then
    ``quant_ab --stage_c``: B2 once a scorer call, the int8 arm's fc6 and
    fc7 one int8 GEMM each; the last training step's and the last scorer
    call's B2 held (exact) and timed."""
    from i2vsgg_tpu_torch.models import sgg as sgg_mod
    from i2vsgg_tpu_torch.tools import parity_run, quant_ab
    from i2vsgg_tpu_torch.train import sgg as sgg_train
    data = os.path.join(out, "data")
    t = time.time()
    with timed_steps(sgg_train) as timed, last_calls(
            sgg_mod, "roi_pool", 1) as train_call:
        driver_launches(counters, "21d training",
                        lambda: parity_run.train_ours_sgg(
                            data, out, GATE_SGG_STEPS, device="cuda"),
                        dict(NO_LAUNCHES, roi_pool=1), GATE_SGG_STEPS)
    train_s = time.time() - t
    losses = [float(m["loss"]) for _, m in timed]
    step_ms = [1e3 * (b[0] - a[0]) for a, b in zip(timed, timed[1:])]
    rec = {"train_s": train_s,
           "loss_first_20": float(np.mean(losses[:LOSS_WINDOW])),
           "loss_last_20": float(np.mean(losses[-LOSS_WINDOW:])),
           "step_ms_median": float(np.median(step_ms))}
    log(f"21d: {len(losses)} Stage B steps in {train_s:.1f} s (a "
        f"checkpoint each epoch), host ms a step median "
        f"{rec['step_ms_median']:.1f}; mean loss of "
        f"the first 20 {rec['loss_first_20']:.4f}, of the last 20 "
        f"{rec['loss_last_20']:.4f} [{card}]")
    real, scored = parity_run.sgg_scorer, {"fp32": 0, "int8": 0}

    def counted(model, device):
        fn, arm = real(model, device), (
            "int8" if model.vrd.int8_fc else "fp32")

        def score(*a):
            scored[arm] += 1
            return fn(*a)
        return score

    parity_run.sgg_scorer = counted
    t = time.time()
    try:
        with last_calls(sgg_mod, "roi_pool", 1) as score_call:
            counters.reset()
            res = quant_ab.main(["--out", out, "--depth", str(GATE_DEPTH),
                                 "--stage_c", "--json",
                                 os.path.join(out, "quant_ab.json")])
            torch.cuda.synchronize()
            got = counters.read()
    finally:
        parity_run.sgg_scorer = real
    rec["quant_ab_s"] = time.time() - t
    want = dict(NO_LAUNCHES, roi_pool=sum(scored.values()),
                int8_linear=2 * scored["int8"])
    if got != want or scored["fp32"] != scored["int8"]:
        raise AssertionError(f"21d quant_ab: launches {got}, expected "
                             f"{want} ({scored} scorer calls)")
    rec.update(scorer_calls=scored, fp32=res["fp32"], int8=res["int8"],
               delta=res["delta"])
    log(f"21d: quant_ab --stage_c in {rec['quant_ab_s']:.1f} s "
        f"({scored['fp32']} scorer calls an arm): fp32 top1 "
        f"{res['fp32']['top1_acc']:.4f} pred_mAP "
        f"{res['fp32']['pred_mAP']:.4f} R@50 {res['fp32']['R@50']:.4f}; "
        f"int8 top1 {res['int8']['top1_acc']:.4f} pred_mAP "
        f"{res['int8']['pred_mAP']:.4f} R@50 {res['int8']['R@50']:.4f}; "
        f"delta pred_mAP {res['delta']['pred_mAP']:+.4f} top1 "
        f"{res['delta']['top1_acc']:+.4f} R@50 {res['delta']['R@50']:+.4f} "
        f"[{card}]")
    rec["sites"] = (held_gate_sites("roi_pool", train_call, ("train",),
                                    "21d last Stage B step", card)
                    + held_gate_sites("roi_pool", score_call, ("scorer",),
                                      "21d last scorer call", card))
    return rec


def serving_gates_on_card(counters, card: str, after=None) -> dict:
    """Phase 21 (see the module docstring) in a work directory of its own,
    removed afterwards; ``parity_run``'s recipe and the environment are
    restored. ``after(out)``, where given, runs after 21d on the phase's
    directory ``out`` before it goes (phase 22)."""
    from i2vsgg_tpu_torch.tools import parity_run
    saved_hp = dict(parity_run.HP)
    saved_cfg = list(parity_run.CFG_OVERRIDES)
    saved_env = {k: os.environ.get(k) for k in (
        "I2VSGG_DATA_ROOT", "I2VSGG_INT8_TRUNK", "I2VSGG_INT8_PREQ_SIM")}
    work = tempfile.mkdtemp(prefix="chip_smoke_gates_")
    out = os.path.join(work, "gate")
    rec = {}
    t0 = time.time()
    try:
        phase("21a train_gate_arm on the card: the parity corpus (300 stills "
              "at 240x320, 20 videos x 24 frames) written by the port, res101 "
              "f32 Stage A from the port's init with bn3 zeroed, 288 steps")
        rec["21a arm"] = gate_arm_on_card(counters, card, out)
        cfg = list(parity_run.CFG_OVERRIDES)
        ckpt = rec["21a arm"]["ckpt"]
        phase(f"21b capacity_ab --ckpt on 21a's checkpoint, rows {GATE_ROWS}")
        rec["21b capacity"] = capacity_on_card(counters, card, out, ckpt, cfg)
        phase(f"21c calibrate_act_scales, then quant_trunk_ab --mode "
              f"mxu:{INT8_SCOPE} on MVRD and MVidVRD")
        rec["21c int8 trunk"] = trunk_gate_on_card(counters, card, out, ckpt,
                                                   cfg)
        phase(f"21d train_ours_sgg at res101 ({GATE_SGG_STEPS} steps, pool: "
              "B2) from the step-0 init, then quant_ab --stage_c")
        parity_run.HP["depth"] = GATE_DEPTH
        rec["21d int8 fc"] = fc_gate_on_card(counters, card, out)
        rec["phase_s"] = time.time() - t0
        if after is not None:
            after(out)
    finally:
        parity_run.HP.clear()
        parity_run.HP.update(saved_hp)
        parity_run.CFG_OVERRIDES = saved_cfg
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
    rec["gates"] = gate_verdicts(rec["21b capacity"]["results"],
                                 rec["21c int8 trunk"], rec["21d int8 fc"])
    for name, g in rec["gates"].items():
        log(f"21 gate {name}: {g['verdict']} ({g['why']}) under bench.py's "
            f"rules (floor {GATE_FLOOR}, tolerance {GATE_TOL})")
    log(f"21: {rec['phase_s']:.1f} s [{card}]")
    return rec


# ----------------------------------------------------------------------------
# phase 22: the last modules of the port: the decoder's arithmetic-coded,
# four-component and lossless JPEG (``csrc/jpeg.cc``) in both loaders and
# through the drivers, ``tools/stage_c_hard.py`` and
# ``tools/stage_b_rescore.py`` on phase 21d's Stage B head, and
# ``utils/vis.py`` on a frame phase 5 served; run in phase 21's work
# directory before it goes, with phase 13's devkit and checkpoints

# the sets of tests/data/decode that phase 22 holds
LAST_SETS = ("arith", "four", "lossless", "refused", "arith_frames")
# 22a's timed kinds, in the order of each rep (reversed every other rep)
ARITH_KINDS = ("baseline", "arithmetic")
# the one Huffman table of the lossless frames (tests/
# make_decode_fixtures.py's LOSSLESS_BITS): symbols 0-16
LOSSLESS_BITS = (0, 1, 5) + (1,) * 11 + (0, 0)
# 22c: the GT count of the committed JAX run's hard test set
# (runs/parity_r4c/stage_c_hard.json: the default 24 videos, 6 of them
# test videos), which the port's generator writes bit for bit
HARD_GT = 147


def lossless_frame(path: str, bgr: np.ndarray):
    """``bgr`` (H, W, 3) uint8 as a lossless JPEG (SOF3, 8 bits) as cv2
    reads it: R, G and B stored as they are in one interleaved scan,
    predictor 1 (the left sample; the first column from the sample above,
    the first sample from 128), one DHT of ``LOSSLESS_BITS``, no JFIF
    marker; the entropy-coded bits built with numpy."""
    import struct
    x = bgr[..., ::-1].astype(np.int32)
    h, w = x.shape[:2]
    pred = np.empty_like(x)
    pred[:, 1:] = x[:, :-1]
    pred[1:, 0] = x[:-1, 0]
    pred[0, 0] = 128
    diff = (x - pred).reshape(-1)
    cat = np.zeros(diff.shape, np.int64)
    mag = np.abs(diff)
    for k in range(1, 10):
        cat[mag >= 1 << (k - 1)] = k
    extra = np.where(diff >= 0, diff, diff + (1 << cat) - 1)
    codes, lens, code = np.zeros(17, np.int64), np.zeros(17, np.int64), 0
    sym = 0
    for length, count in enumerate(LOSSLESS_BITS, 1):
        for _ in range(count):
            codes[sym], lens[sym] = code, length
            code, sym = code + 1, sym + 1
        code <<= 1
    total = lens[cat] + cat
    value = (codes[cat] << cat) | extra
    shift = total[:, None] - 1 - np.arange(int(total.max()))
    bits = ((value[:, None] >> np.maximum(shift, 0)) & 1).astype(bool)
    bits = bits[shift >= 0]
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, bool)])
    data = np.packbits(bits)
    data = np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0)

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    with open(path, "wb") as fh:
        fh.write(b"\xff\xd8"
                 + seg(0xC3, struct.pack(">BHHB", 8, h, w, 3)
                       + bytes([1, 0x11, 0, 2, 0x11, 0, 3, 0x11, 0]))
                 + seg(0xC4, bytes((0,) + LOSSLESS_BITS + tuple(range(17))))
                 + seg(0xDA, bytes([3, 1, 0, 2, 0, 3, 0, 1, 0, 0]))
                 + data.tobytes() + b"\xff\xd9")


def last_decode_on_host(card: str) -> tuple:
    """22a: every fixture of ``LAST_SETS`` through both decoders
    (``image_io.imread_bgr``, ``runtime.decode_image``): each held to its
    golden (cv2's decode) or, an arithmetic-coded frame, to its baseline
    twin's decode; each refused one raises ``UnsupportedImageError`` naming
    its mode on both. Then host ms a 360x640 frame of the four committed
    baseline frames against their arithmetic-coded twins (``host_times``,
    the kinds alternated). Returns the record and the paths of each
    kind."""
    from i2vsgg_tpu_torch import runtime
    from i2vsgg_tpu_torch.data.image_io import (UnsupportedImageError,
                                                imread_bgr)
    manifest = {k: v for k, v in decode_manifest().items()
                if v["set"] in LAST_SETS}
    held, refused = {}, []
    kinds = {"baseline": [], "arithmetic": []}
    for name, entry in sorted(manifest.items()):
        path = os.path.join(DECODE_DIR, entry["file"])
        if "mode" in entry:
            for what, read in (("imread_bgr", imread_bgr),
                               ("decode_image", runtime.decode_image)):
                try:
                    read(path)
                except UnsupportedImageError as e:
                    if entry["mode"] not in str(e):
                        raise AssertionError(f"22a {name}: {what} refused "
                                             f"it as {e}")
                    continue
                raise AssertionError(f"22a {name}: {what} decoded a "
                                     f"{entry['mode']} file")
            refused.append(name)
            continue
        want = imread_bgr(os.path.join(DECODE_DIR, entry.get("golden")
                                       or entry["twin"]))
        for what, got in (("imread_bgr", imread_bgr(path)),
                          ("decode_image", runtime.decode_image(path))):
            if list(got.shape) != entry["shape"] or \
                    not np.array_equal(got, want):
                raise AssertionError(f"22a {name}: {what} != its golden or "
                                     "twin")
        held[entry["set"]] = held.get(entry["set"], 0) + 1
        if "twin" in entry:
            kinds["arithmetic"].append(path)
            kinds["baseline"].append(os.path.join(DECODE_DIR,
                                                  entry["twin"]))
    if len(kinds["arithmetic"]) != 4:
        raise AssertionError(f"22a: {len(kinds['arithmetic'])} arithmetic-"
                             "coded frames, not 4")
    log(f"22a: {sum(held.values())} fixtures held on both paths "
        f"({', '.join(f'{k} {v}' for k, v in sorted(held.items()))}), "
        f"{len(refused)} refused naming their modes on both")
    rec = dict({"held": held, "refused": refused},
               **host_times(kinds, ARITH_KINDS))
    rec["decode_ratio"] = (rec["arithmetic"]["decode_ms"]["median"]
                           / rec["baseline"]["decode_ms"]["median"])
    log("22a host ms a 360x640 frame (native decode median of "
        f"{DECODE_REPS} / Python path median of 3 / load_batch at scale "
        f"600 on 1 and 8 threads): " + "; ".join(
            f"{k} {rec[k]['decode_ms']['median']:.2f} / "
            f"{rec[k]['python_decode_ms']:.2f} / "
            f"{rec[k]['load_batch_ms_1']:.2f}, "
            f"{rec[k]['load_batch_ms_8']:.2f}" for k in kinds)
        + f"; arithmetic {rec['decode_ratio']:.2f}x baseline [host CPU of "
        f"the machine of {card}, {os.cpu_count()} CPUs]")
    return rec, kinds


def last_devkits(src: str, kinds: dict, work: str) -> dict:
    """22b's two MVidVRD devkits, copies of 13a's (``src``) as
    ``twin_devkits`` makes them: in "new formats" the first four frames are
    the committed arithmetic-coded frames and the other eight lossless
    JPEG copies of 13a's PNG frames (``lossless_frame``); in "twins" the
    baseline frames and 13a's PNGs."""
    from i2vsgg_tpu_torch.data.image_io import imread_bgr
    roots = {}
    for name in ("new formats", "twins"):
        root = os.path.join(work, "data22_" + name.replace(" ", "_"))
        shutil.copytree(os.path.join(src, "MVidVRD"),
                        os.path.join(root, "MVidVRD"),
                        ignore=shutil.ignore_patterns("cache"))
        roots[name] = root
    images = os.path.join("MVidVRD", "JPEGImages")
    names = sorted(os.listdir(os.path.join(src, images)))
    for k, name in enumerate(names):
        new = os.path.join(roots["new formats"], images, name)
        twin = os.path.join(roots["twins"], images, name)
        if k < 4:
            shutil.copyfile(kinds["arithmetic"][k], new)
            shutil.copyfile(kinds["baseline"][k], twin)
            continue
        bgr = imread_bgr(twin)
        lossless_frame(new, bgr)
        if not np.array_equal(imread_bgr(new), bgr):
            raise AssertionError(f"22b: the lossless copy of {name} "
                                 "decodes to another picture")
    return roots


def eval_tools_on_card(counters, card: str, out: str, work: str,
                       device: str = "cuda") -> dict:
    """22c: ``stage_c_hard`` (ours arm, the default 24 hard videos, 6 of
    them test videos, as the committed JAX run) and ``stage_b_rescore.
    rescore`` on 21d's Stage B head (``out``'s session 951, res101): B2
    once a scorer call and nothing else; the last ``stage_c_hard`` scorer
    call's B2 held to its plain version (exact) and timed."""
    from i2vsgg_tpu_torch.models import sgg as sgg_mod
    from i2vsgg_tpu_torch.tools import parity_run, stage_b_rescore
    from i2vsgg_tpu_torch.tools import stage_c_hard
    from i2vsgg_tpu_torch.train.checkpoint import latest_step
    ckpt_dir = os.path.join(out, f"res{GATE_DEPTH}", "MVRD_SGG",
                            "session_951")
    step = latest_step(ckpt_dir)
    real, scored = parity_run.sgg_scorer, {"n": 0}

    def counted(model, device, raw=False):
        fn = real(model, device, raw)

        def score(*a):
            scored["n"] += 1
            return fn(*a)
        return score

    def run(what, fn):
        scored["n"] = 0
        counters.reset()
        t = time.time()
        res = fn()
        torch.cuda.synchronize()
        got, n = counters.read(), scored["n"]
        if got != dict(NO_LAUNCHES, roi_pool=n) or not n:
            raise AssertionError(f"22c {what}: launches {got} in {n} scorer "
                                 "calls")
        return res, n, time.time() - t

    parity_run.sgg_scorer = counted
    try:
        with last_calls(sgg_mod, "roi_pool", 1) as hard_call:
            hard, n_hard, hard_s = run("stage_c_hard", lambda: (
                stage_c_hard.main(["--out", out, "--hard_out",
                                   os.path.join(work, "hard"), "--ours_ckpt",
                                   f"{ckpt_dir}/{step}", "--depth",
                                   str(GATE_DEPTH), "--device", device])))
        variants, n_b, rescore_s = run("stage_b_rescore", lambda: (
            stage_b_rescore.rescore(ckpt_dir, os.path.join(out, "data"),
                                    device)))
    finally:
        parity_run.sgg_scorer = real
    if hard["n_gt_hard"] != HARD_GT or hard["n_videos"] != 6:
        raise AssertionError(f"22c: a hard test set of {hard['n_videos']} "
                             f"videos and {hard['n_gt_hard']} GT, not JAX's "
                             f"6 and {HARD_GT}")
    m = hard["ours_hard"]
    log(f"22c stage_c_hard in {hard_s:.1f} s ({n_hard} scorer calls, the "
        f"hard set written): {hard['n_videos']} test videos, "
        f"{hard['n_gt_hard']} GT; rel_mAP {m['rel_mAP']:.4f} R@50 "
        f"{m['R@50']:.4f} R@100 {m['R@100']:.4f} P@1/5/10 {m['P@1']:.4f} / "
        f"{m['P@5']:.4f} / {m['P@10']:.4f} [{card}]")
    log(f"22c stage_b_rescore.rescore in {rescore_s:.1f} s ({n_b} scorer "
        "calls): " + "; ".join(
            f"{k} top1 {v['top1_acc']:.4f} pred_mAP {v['pred_mAP']:.4f}"
            for k, v in variants.items()) + f" [{card}]")
    return {"ckpt": f"{ckpt_dir}/{step}", "stage_c_hard": hard,
            "stage_c_hard_s": hard_s, "scorer_calls": n_hard,
            "rescore": variants, "rescore_s": rescore_s,
            "rescore_scorer_calls": n_b,
            "sites": held_gate_sites("roi_pool", hard_call, ("scorer",),
                                     "22c last stage_c_hard scorer call",
                                     card)}


def vis_on_card(card: str, served: dict, work: str) -> dict:
    """22d: ``utils/vis.py::save_vis`` on the first frame of phase 5's last
    request with that frame's valid detections, every score drawn: the PNG
    it wrote reads back as the drawing, boxes and labels on the frame."""
    from i2vsgg_tpu_torch.data.image_io import imread_bgr
    from i2vsgg_tpu_torch.utils import vis
    frame = served["frame"]
    n_cls = FULL["num_classes"]
    classes = ["__background__"] + [f"class{j}" for j in range(1, n_cls)]
    per = [None] + [
        np.concatenate([served["boxes"][served["classes"] == j],
                        served["scores"][served["classes"] == j, None]], 1)
        for j in range(1, n_cls)]
    path = os.path.join(work, "vis.png")
    t = time.time()
    vis.save_vis(frame, per, classes, path, thresh=0.0)
    save_s = time.time() - t
    back = imread_bgr(path)
    want = frame
    for j in range(1, n_cls):
        if len(per[j]):
            want = vis.vis_detections(want, classes[j], per[j], 0.0)[..., ::-1]
    drawn = int((back != frame).any(-1).sum())
    if back.shape != frame.shape or not np.array_equal(back, want) \
            or not drawn:
        raise AssertionError(f"22d: the PNG save_vis wrote ({back.shape}) "
                             "is not its drawing, or nothing was drawn")
    boxes = int(sum(len(d) for d in per[1:]))
    log(f"22d save_vis: {boxes} boxes on a {frame.shape[0]}x"
        f"{frame.shape[1]} frame, {drawn} pixels drawn, {save_s * 1e3:.1f} ms "
        f"to draw and write {os.path.getsize(path)} bytes, read back equal "
        f"[host CPU of the machine of {card}]")
    return {"boxes": boxes, "pixels_drawn": drawn, "save_ms": 1e3 * save_s,
            "png_bytes": os.path.getsize(path)}


def last_modules_on_card(counters, card: str, drivers: dict, work13: str,
                         out: str, served: dict) -> dict:
    """Phase 22 (see the module docstring): 22a and 22b on phase 13's
    devkit and checkpoints (``work13``), 22c on phase 21d's head (``out``,
    phase 21's work directory), 22d on phase 5's frame."""
    t0 = time.time()
    work = os.path.join(out, "phase22")
    os.makedirs(work)
    phase("22a the decoder's last modes: every arithmetic-coded, CMYK/YCCK, "
          "lossless and refused fixture of tests/data/decode through both "
          "decoders; host ms a frame of arithmetic-coded against baseline "
          "JPEG, on 1 and 8 threads")
    rec = {}
    rec["22a host"], kinds = last_decode_on_host(card)
    phase("22b serve_video (default: B1, B2) and test_det over twin "
          "devkits, arithmetic-coded and lossless JPEG against baseline JPEG "
          "and PNG: detections and rel_prob bit-equal")
    files = drivers["files"]
    rec["22b drivers"] = drivers_over_twin_devkits(
        counters, card, files, last_devkits(files["data"], kinds, work13),
        work13, "22b")
    phase("22c stage_c_hard (ours arm, res101, the hard video set) and "
          "stage_b_rescore's five transforms on 21d's Stage B head: B2 once "
          "a scorer call")
    rec["22c eval tools"] = eval_tools_on_card(counters, card, out, work)
    phase("22d utils/vis.py: save_vis on a frame phase 5 served, the PNG "
          "read back")
    rec["22d vis"] = vis_on_card(card, served, work)
    rec["phase_s"] = time.time() - t0
    log(f"22: {rec['phase_s']:.1f} s [{card}]")
    return rec


# ----------------------------------------------------------------------------
# ``--chain-depths``: how deep the chain kernel may let the tensor cores
# accumulate (csrc/bottleneck.cu's kDepth), held as phase 3d holds it

# the card tests' chain shapes: (B, H, W, C, M, n)
CHAIN_TEST_SHAPES = ((2, 9, 13, 128, 128, 3), (1, 15, 20, 256, 128, 2),
                     (4, 38, 60, 1024, 256, 1), (1, 37, 61, 512, 128, 2),
                     (3, 37, 61, 1024, 256, 1))


def chain_at_depth(depth: int):
    """``csrc/bottleneck.cu`` with ``kDepth = depth``, built into
    ``i2vsgg_tpu_torch/_build/depth/`` and loaded."""
    import ctypes
    import re
    from i2vsgg_tpu_torch.utils import cuda_build
    src = (cuda_build.CSRC_DIR / "bottleneck.cu").read_text()
    text, n = re.subn(r"constexpr int kDepth = \d+;",
                      f"constexpr int kDepth = {depth};", src)
    if n != 1:
        raise RuntimeError("bottleneck.cu has no kDepth constant to set")
    out = cuda_build.BUILD_DIR / "depth"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"bottleneck_d{depth}.cu", out / f"bottleneck_d{depth}.so"
    cu.write_text(text)
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed at depth {depth}:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def chain_test_case(dev, b, h, w, c, m, n, seed):
    """tests/test_torch_cuda.py's chain inputs: x ~ N(0, 1), weights and
    biases ~ 0.05 N(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev) * 0.05

    bf16 = torch.bfloat16
    x = torch.randn(b, h, w, c, generator=g, device=dev).to(bf16)
    return x, (r(n, c, m).to(bf16), r(n, m), r(n, 9, m, m).to(bf16),
               r(n, m), r(n, m, c).to(bf16), r(n, c))


def phase3d_chain_input(dev):
    """Phase 3d's chain input: the seeded res101 model's layer3 block0
    output and its folded 22-block tail, bf16-stored weights."""
    from i2vsgg_tpu_torch.config import Config, cfg_from_list
    from i2vsgg_tpu_torch.models.backbones import nchw_to_nhwc
    from i2vsgg_tpu_torch.utils.params import bf16_storage_cast
    cfg = cfg_from_list(["TEST.RPN_POST_NMS_TOP_N", "128",
                         "TEST.RPN_PRE_NMS_TOP_N", "512"], Config())
    det, _, _ = build_models(FULL, cfg, torch.Generator().manual_seed(3))
    det = bf16_storage_cast(det).to(dev).eval()
    trunk = det.trunk
    with torch.no_grad():
        imgs = torch.as_tensor(make_inputs(FULL, 10)[0], device=dev)
        x3 = trunk.layer3.block0(trunk.layer2(trunk.layer1(
            trunk._stem(imgs))))
        return (nchw_to_nhwc(x3).to(torch.bfloat16).contiguous(),
                trunk.layer3.folded_tail())


def chain_depths(depths=(16, 32, 64), seeds: int = 3) -> int:
    """Build the chain kernel at each accumulation depth and hold each build
    as ``held_chain`` holds the kernel: on phase 3d's input and on the card
    tests' chain shapes for ``seeds`` seeds each. Prints whether each passes
    and its least per-block bit-equal share, and the chain's time on phase
    3d's input. The kernel commits the deepest depth that passes
    everywhere."""
    from i2vsgg_tpu_torch.ops import bottleneck as chain_mod
    from i2vsgg_tpu_torch.utils import cuda_build
    dev = torch.device("cuda")
    libs = {d: chain_at_depth(d) for d in depths}
    x3, wts3 = phase3d_chain_input(dev)

    def held(x, wts, what):
        try:
            check = held_chain(chain_mod.bottleneck_chain, x, wts, what,
                               quiet=True)
        except AssertionError as e:
            return f"FAILS ({str(e)[:240]})"
        return (f"passes, least per-block bit-equal share "
                f"{check['least_block_bit_equal']:.6f}")

    for depth, lib in libs.items():
        cuda_build.load = lambda source, lib=lib: lib
        kern = chain_mod.bottleneck_chain
        log(f"depth {depth}: phase 3d input: "
            f"{held(x3, wts3, f'depth {depth}')}; chain "
            f"{cuda_ms(lambda: kern(x3, *wts3), 20):.4f} ms")
        for shape in CHAIN_TEST_SHAPES:
            for seed in range(seeds):
                x, wts = chain_test_case(dev, *shape, seed)
                log(f"depth {depth}: {shape} seed {seed}: "
                    f"{held(x, wts, f'depth {depth}')}")
    print(smi_name_power() or torch.cuda.get_device_name(0), flush=True)
    return 0


# ----------------------------------------------------------------------------
# phase 17: data parallelism (``parallel/mesh.py``): the training drivers
# under torchrun (NCCL, world size 1), two gloo ranks on the one card against
# one process, and serving over a mesh of two replicas on cuda:0

# 17a's step 1 against the non-distributed driver's step 1 (14c, 15c) on the
# same weights and data: the same kernels and cuDNN algorithms, the all-reduce
# of one rank a copy; bit-equal predicted, held to this
DP_STEP1_RTOL = 1e-5
# 17b: the two-rank run's metrics and its updates after DP_STEPS steps
# against one process at batch 2, by 14d's and 15d's limits, at an lr of
# DP_LR (at 14d's 1e-3 the tiny detector's RPN loss grows from 60 to ~3400
# in one step, and the second step magnifies the last bits of netD_style's
# updates past 14d's gradient limits: measured on the CPU)
DP_STEPS = 2
DP_LR = 1e-4
# 17c: the sharded program is held bit for bit to the unsharded program on
# each replica's own rows (the batch size of the replica); against the
# unsharded program on the whole 4-frame request it is measured, not held:
# the same frame in a batch of 2 and of 4 takes other cuDNN and cuBLAS
# algorithms in bf16, and the random-weight detector's near-ties then pick
# other detections (measured on an H100: a 508 px gap after matching).
# MATCH_PX: a detection of the whole request counts as found in the sharded
# output where one of its class lies within this many pixels
MATCH_PX = 4.0
# 17c's ragged tail: one video of 5 frames at --bs 4 --mesh 2 (a tail of 1
# frame, padded to the two replicas), against --mesh 0 at --bs 2, the
# replicas' batch: each program call then sees the same frames in both runs
# and the files must be equal (at --bs 4 the same frame in a batch of 4 and
# of 2 takes other cuDNN algorithms, and the random detector's near-ties
# move: 0.21 px between two CPU runs of one configuration)
DEVKIT_RAGGED = dict(DEVKIT, videos=1, frames=5)


def rank_driver(argv: list) -> int:
    """``python3 chip_smoke.py --rank-driver <module> <out.json> <args>``,
    the process that ``torch.distributed.run`` starts for each rank in phase
    17a: the port's training driver ``module`` (its ``main(args)``, which
    joins the process group from torchrun's variables), with the kernels'
    launch counters set to 0 just before and read just after; then the
    all-reduce of the last step's gradients timed by CUDA events
    (``all_reduce_grads``: flatten, NCCL, copy back). Rank 0 writes the
    record to ``out.json``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    import importlib
    from i2vsgg_tpu_torch.parallel import mesh
    module, out_path, args = argv[0], argv[1], argv[2:]
    counters = Counters()
    counters.reset()
    t = time.time()
    state = importlib.import_module(module).main(args)
    torch.cuda.synchronize()
    wall = time.time() - t
    launched = counters.read()
    params = state.optimizer.params()
    nbytes = sum(p.grad.numel() * p.grad.element_size() for p in params)
    ar_ms = cuda_ms(lambda: mesh.all_reduce_grads(params), 10)
    rec = {"rank": mesh.process_index(), "world": mesh.process_count(),
           "backend": mesh.backend(), "step": state.step,
           "device": str(next(state.model.parameters()).device),
           "lr": state.optimizer.opt.param_groups[0]["lr"],
           "launches": launched, "wall_s": wall, "allreduce_ms": ar_ms,
           "allreduce_bytes": nbytes, "allreduce_tensors": len(params)}
    if mesh.process_index() == 0:
        with open(out_path, "w") as fh:
            json.dump(rec, fh)
    return 0


def torchrun(module: str, args: list, out: str, timeout_s: int = 600
             ) -> dict:
    """``python -m torch.distributed.run --standalone --nproc_per_node 1``
    over this script's ``--rank-driver`` (the driver ``module`` with
    ``args``); a failed or hung rank fails the phase. Returns rank 0's
    record."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__),
           "--rank-driver", module, out] + args
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout_s)
    if proc.returncode:
        raise AssertionError(f"torchrun {module}: exit {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    printed = [line for line in proc.stdout.splitlines()
               if line.startswith("data parallel:")]
    with open(out) as fh:
        rec = json.load(fh)
    rec["printed"] = printed
    return rec


def step1_vs(logged_dp: list, logged_ref: list, what: str) -> float:
    """Step 1's losses of a distributed run against the non-distributed
    driver's (every ``loss*`` metric): the largest relative gap, held to
    ``DP_STEP1_RTOL``."""
    a, b = logged_dp[0], logged_ref[0]
    keys = [k for k in b if k.startswith(("loss", "dloss"))]
    gap = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in keys)
    if not (a["step"] == b["step"] == 1 and gap <= DP_STEP1_RTOL):
        raise AssertionError(f"{what}: step 1 {a} vs {b}: {gap} > "
                             f"{DP_STEP1_RTOL}")
    return gap


def torchrun_training(card: str, work: str, training: dict,
                      stage_b: dict) -> dict:
    """17a (see the module docstring): 14c's and 15c's runs again, each a
    process that torchrun starts (NCCL, world size 1, ``--mesh 1``), on
    their devkit and from their checkpoints under ``work``."""
    d14, d15 = training["14c driver"], stage_b["15c driver"]
    rec = {}
    out = os.path.join(work, "out_dp")
    saved_env = os.environ.get("I2VSGG_DATA_ROOT")
    os.environ["I2VSGG_DATA_ROOT"] = os.path.join(work, "data")
    try:
        common = TRAIN_ARGS + ["--save_dir", out, "--disp_interval", "1",
                               "--mesh", "1"]
        module = "i2vsgg_tpu_torch.tools.trainval_det_da"
        a = torchrun(module, common + [
            "--max_steps", "3", "--load_name",
            os.path.join(work, "init", "0")], os.path.join(work, "a.json"))
        # --resume, not --r: torchrun's parser would take --r for its own
        r = torchrun(module, common + ["--max_steps", "4", "--resume"],
                     os.path.join(work, "a_r.json"))
        ck = os.path.join(out, "res101", "MVRD", "session_1")
        with open(os.path.join(ck, "logs", "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        per_step = dict(NO_LAUNCHES, roi_align=2)
        for run, steps in ((a, 3), (r, 1)):
            if (run["backend"], run["world"]) != ("nccl", 1) or \
                    run["launches"] != {k: v * steps
                                        for k, v in per_step.items()}:
                raise AssertionError(f"17a Stage A: {run}")
        if (a["step"], r["step"]) != (3, 4) or \
                [x["step"] for x in logged] != [1, 2, 3, 4] or \
                not all(np.isfinite(x["loss"]) for x in logged) or \
                not os.path.isdir(os.path.join(ck, "step_00000004")):
            raise AssertionError(f"17a Stage A: steps {a['step']}, "
                                 f"{r['step']}; logged {logged}")
        gap = step1_vs(logged, d14["logged"], "17a Stage A")
        rec["stage_a"] = dict(run=a, resume=r, step1_rtol=gap,
                              losses=[x["loss"] for x in logged],
                              imgs_per_sec=[x["imgs_per_sec"]
                                            for x in logged])
        log(f"17a Stage A under torchrun: {a['printed']}; backend "
            f"{a['backend']}, world {a['world']}, {a['device']}; launches "
            f"{ {k: v for k, v in a['launches'].items() if v} } in 3 steps, "
            f"--r to step {r['step']} (lr {r['lr']:g}); step 1's losses "
            f"within {gap:.3g} of 14c's (tol {DP_STEP1_RTOL:g}); losses "
            f"{[round(x['loss'], 4) for x in logged]}, images/s "
            f"{[round(x['imgs_per_sec'], 3) for x in logged]} (14c "
            f"{[round(x, 3) for x in d14['imgs_per_sec']]}); all-reduce of "
            f"{a['allreduce_tensors']} gradients ({a['allreduce_bytes']} B) "
            f"{a['allreduce_ms']:.3f} ms [{card}]")

        out_b = os.path.join(work, "out_dp_sgg")
        b = torchrun("i2vsgg_tpu_torch.tools.trainval_sgg", SGG_ARGS + [
            "--save_dir", out_b, "--disp_interval", "1", "--max_steps", "3",
            "--mesh", "1", "--load_name", d14["stage_a"],
            "--source_gt_rels_path", d14["devkit"]["mvrd_gt_rels"]],
            os.path.join(work, "b.json"))
        ck = os.path.join(out_b, "res101", "MVRD_SGG", "session_1")
        with open(os.path.join(ck, "logs", "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        if (b["backend"], b["world"], b["step"]) != ("nccl", 1, 3) or \
                b["launches"] != dict(NO_LAUNCHES, roi_pool=3) or \
                [x["step"] for x in logged] != [1, 2, 3] or \
                not all(np.isfinite(x["loss"]) for x in logged):
            raise AssertionError(f"17a Stage B: {b}; logged {logged}")
        gap_b = step1_vs(logged, d15["logged"], "17a Stage B")
        rec["stage_b"] = dict(run=b, step1_rtol=gap_b,
                              losses=[x["loss"] for x in logged],
                              imgs_per_sec=[x["imgs_per_sec"]
                                            for x in logged])
        log(f"17a Stage B under torchrun: {b['printed']}; launches "
            f"{ {k: v for k, v in b['launches'].items() if v} } in 3 steps; "
            f"step 1's loss within {gap_b:.3g} of 15c's; losses "
            f"{[round(x['loss'], 4) for x in logged]}, images/s "
            f"{[round(x['imgs_per_sec'], 3) for x in logged]} (15c "
            f"{[round(x, 3) for x in d15['imgs_per_sec']]}); all-reduce of "
            f"{b['allreduce_tensors']} gradients ({b['allreduce_bytes']} B) "
            f"{b['allreduce_ms']:.3f} ms [{card}]")
    finally:
        if saved_env is None:
            os.environ.pop("I2VSGG_DATA_ROOT", None)
        else:
            os.environ["I2VSGG_DATA_ROOT"] = saved_env
    return rec


def tiny_dp_steps(stage: str, dev, rows: slice) -> list:
    """17b's run: ``DP_STEPS`` steps of 14d's tiny Stage A (``stage`` "a":
    res10 ic+gc+cr, f32, deterministic sampling) or of 15d's tiny Stage B
    ("b": dropout 0; image 1 keeps 2 of its valid pairs, so that the images'
    counts differ) on the ``rows`` of their two-frame batch, each model
    built from its seed, TF32 off. In a process group the step is the
    global batch's. Returns per step the metrics and the parameters."""
    from i2vsgg_tpu_torch.config import Config
    from i2vsgg_tpu_torch.train import det_da, sgg
    from i2vsgg_tpu_torch.train.optim import ReferenceSGD
    steps = []
    with tf32_off():
        if stage == "a":
            cfg = Config().replace(
                TRAIN=Config().TRAIN.__class__(
                    RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=32,
                    RPN_POST_NMS_TOP_N_TARGET=16, RPN_BATCHSIZE=32,
                    BATCH_SIZE=16, MAX_NUM_GT_BOXES=30),
                COMPUTE_DTYPE="float32", ANCHOR_SCALES=(1, 2, 4))
            model = training_model(cfg, TRAIN_TINY, 4)
            with torch.no_grad():
                model.rpn.cls_score.weight.mul_(40.0)
            model.to(dev)
            src, tgt = ({k: torch.as_tensor(v[rows], device=dev)
                         for k, v in b.items()}
                        for b in train_frames(TRAIN_TINY, 4,
                                              TRAIN_TINY["frames"]))
            state = det_da.TrainState(model, ReferenceSGD(model, DP_LR,
                                                          cfg), seed=4)

            def step():
                return det_da.train_step(state, src, tgt, eta=0.1,
                                         eta_style=0.01, style_lambda=1.0,
                                         cr=True)
        else:
            from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
            args = set_dataset_args(parse_args(
                ["--net", "res10", "--num_relations", "7", "--max_pairs",
                 "12"]))
            cfg = Config().replace(COMPUTE_DTYPE="float32")
            model = sgg_training_model(args, cfg, "pool", 5, fc_dim=128,
                                       dropout_rate=0.0).to(dev)
            batch = sgg_batches(SGG_TINY, 5, 12, 7, dev)
            kept = batch["pair_valid"][1].nonzero()[:2, 0]
            batch["pair_valid"][1] = False
            batch["pair_valid"][1, kept] = True
            batch = {k: v[rows] for k, v in batch.items()}
            prd = torch.as_tensor(np.random.RandomState(5).randn(
                7, 300).astype(np.float32), device=dev)
            state = det_da.TrainState(model, sgg.sgg_optimizer(model, DP_LR,
                                                               cfg), seed=5)

            def step():
                return sgg.train_step(state, batch, prd)
        params = lambda: {n: p.detach().cpu().clone()          # noqa: E731
                          for n, p in model.named_parameters()
                          if p.requires_grad}
        steps.append({"params": params()})
        for _ in range(DP_STEPS):
            m = step()
            steps.append({"metrics": {k: float(v) for k, v in m.items()},
                          "params": params()})
    return steps


def gloo_rank(argv: list) -> int:
    """``python3 chip_smoke.py --gloo-rank <rank> <world> <rendezvous file>
    <stage> <out.pt>``, one of phase 17b's ranks: it joins a gloo group on
    the card (NCCL refuses two ranks on one device) through the file
    rendezvous itself, then the port's ``maybe_init_distributed`` must find
    it; runs ``tiny_dp_steps`` on its row of the batch and saves them."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    import datetime
    import torch.distributed as dist
    from i2vsgg_tpu_torch.parallel import mesh
    from i2vsgg_tpu_torch.utils import cuda_build
    rank, world, rdv, stage, out = (int(argv[0]), int(argv[1]), argv[2],
                                    argv[3], argv[4])
    # which RoI libraries this rank has to build (17b removes them first)
    cold = {src: not cuda_build.library_path(src).exists()
            for src in ("roi_align.cu", "roi_pool.cu")}
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    if not mesh.maybe_init_distributed("cuda") or mesh.backend() != "gloo":
        raise AssertionError("the port did not take the harness's group")
    os.environ["I2VSGG_DETERMINISTIC_SAMPLING"] = "1"
    torch.save({"steps": tiny_dp_steps(stage, torch.device("cuda"),
                                       slice(rank, rank + 1)),
                "cold": cold}, out)
    mesh.sync_global_devices("done")
    dist.destroy_process_group()
    return 0


def updates_vs(got: list, ref: list, tol: dict, what: str) -> dict:
    """``got``'s run against ``ref``'s, step by step: the metrics within
    ``loss_rtol``, each tensor's update since the start at cosine >=
    ``grad_cos`` (14d's and 15d's limits), and each parameter within rtol
    1e-5 with an atol of 1e-3 of its tensor's largest update (the rule of
    tests/test_torch_train_step.py and tests/test_torch_parallel.py for a
    step: ``param_rule`` <= 1). 14d's and 15d's ``grad_frac`` (a gradient's
    gap over its norm, card against CPU) is reported over the whole update
    and not held: a batch split in two moves an update further (on the CPU,
    Stage B at 7.4e-6 of the whole update against 15d's 2e-6; netD_style's
    biases, whose update is ~1e-6, at ~7e-4 of their own). Returns the
    worst of each."""
    worst = {"loss_rtol": 0.0, "grad_cos": 1.0, "param_rule": 0.0,
             "grad_frac": 0.0}
    for i in range(1, len(ref)):
        for k, v in ref[i]["metrics"].items():
            worst["loss_rtol"] = max(worst["loss_rtol"], abs(
                got[i]["metrics"][k] - v) / max(abs(v), 1e-6))
        ups = {n: ((got[i]["params"][n] - got[0]["params"][n]).double(),
                   (p - ref[0]["params"][n]).double())
               for n, p in ref[i]["params"].items()}
        whole = float(torch.cat([u.flatten() for _, u in ups.values()])
                      .norm())
        for n, (g, u) in ups.items():
            p = ref[i]["params"][n].double()
            gap = (got[i]["params"][n].double() - p).abs()
            allow = 1e-5 * p.abs() + max(1e-3 * float(u.abs().max()), 1e-12)
            worst["param_rule"] = max(worst["param_rule"],
                                      float((gap / allow).max()))
            worst["grad_frac"] = max(worst["grad_frac"], float(
                (g - u).abs().max()) / max(whole, 1e-12))
            if float(u.norm()) > 0:
                worst["grad_cos"] = min(worst["grad_cos"], float(
                    (g * u).sum() / (g.norm() * u.norm())))
    if not (worst["loss_rtol"] <= tol["loss_rtol"]
            and worst["grad_cos"] >= tol["grad_cos"]
            and worst["param_rule"] <= 1.0):
        raise AssertionError(f"{what}: {worst} out of bounds {tol} (and "
                             "param_rule 1)")
    return worst


def gloo_ranks_on_card(dev, card: str) -> dict:
    """17b (see the module docstring): for Stage A (``TRAIN_TINY_TOL``) and
    Stage B (``SGG_TINY_TOL``), two gloo ranks on cuda:0 at batch 1 against
    this process at batch 2: the ranks bit-equal to each other, their
    metrics and updates after ``DP_STEPS`` steps within the limits. The
    built RoI libraries are removed first, so that both ranks of a stage
    build its RoI kernel at once (RoIAlign for Stage A, RoIPool for Stage
    B): ``utils/cuda_build.py`` writes aside and renames over."""
    from i2vsgg_tpu_torch.utils import cuda_build
    rec = {}
    for src in ("roi_align.cu", "roi_pool.cu"):
        cuda_build.library_path(src).unlink(missing_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    saved = os.environ.get("I2VSGG_DETERMINISTIC_SAMPLING")
    try:
        for stage, tol in (("a", TRAIN_TINY_TOL), ("b", SGG_TINY_TOL)):
            outs = [os.path.join(work, f"{stage}{r}.pt") for r in range(2)]
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--gloo-rank",
                 str(r), "2", os.path.join(work, f"{stage}.rendezvous"),
                 stage, outs[r]], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(2)]
            os.environ["I2VSGG_DETERMINISTIC_SAMPLING"] = "1"
            one = tiny_dp_steps(stage, dev, slice(None))
            logs = []
            try:
                for p in procs:
                    logs.append(p.communicate(timeout=600)[0])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for p, text in zip(procs, logs):
                if p.returncode:
                    raise AssertionError(f"17b {stage}: a rank failed "
                                         f"({p.returncode}):\n{text[-3000:]}")
            (r0, cold0), (r1, cold1) = ((d["steps"], d["cold"]) for d in (
                torch.load(o, weights_only=False) for o in outs))
            lib = "roi_align.cu" if stage == "a" else "roi_pool.cu"
            if not (cold0[lib] and cold1[lib]
                    and cuda_build.library_path(lib).exists()):
                raise AssertionError(f"17b {stage}: the ranks did not both "
                                     f"build {lib} ({cold0}, {cold1})")
            for a, b in zip(r0, r1):
                if a.get("metrics") != b.get("metrics") or any(
                        not torch.equal(a["params"][n], b["params"][n])
                        for n in a["params"]):
                    raise AssertionError(f"17b {stage}: the ranks differ")
            worst = updates_vs(r0, one, tol, f"17b Stage {stage.upper()}")
            rec[f"stage_{stage}"] = dict(worst, tolerances=tol,
                                         built_at_once=lib,
                                         metrics=[s["metrics"]
                                                  for s in r0[1:]])
            log(f"17b Stage {stage.upper()}: two gloo ranks on {dev} (both "
                f"built {lib} cold, at once) at "
                f"batch 1, bit-equal to each other, against one process at "
                f"batch 2 after {DP_STEPS} steps: metrics rtol "
                f"{worst['loss_rtol']:.3g} (tol {tol['loss_rtol']:g}), least "
                f"update cosine {worst['grad_cos']:.8f} (tol "
                f"{tol['grad_cos']}), parameters at {worst['param_rule']:.3g}"
                f" of the step rule's allowance; largest update gap "
                f"{worst['grad_frac']:.3g} of the whole update (reported); "
                f"metrics {r0[-1]['metrics']} [{card}]")
    finally:
        if saved is None:
            os.environ.pop("I2VSGG_DETERMINISTIC_SAMPLING", None)
        else:
            os.environ["I2VSGG_DETERMINISTIC_SAMPLING"] = saved
        shutil.rmtree(work, ignore_errors=True)
    return rec


PROGRAM_KEYS = ("boxes", "scores", "classes", "det_valid", "rel_prob",
                "pair_valid")


def whole_request_gap(got: list, ref: list) -> dict:
    """A sharded program's outputs against the unsharded program's on the
    whole requests, measured: whether they are bit-equal, and how many of
    the reference's valid detections the sharded output has (a valid
    detection of the same class within ``MATCH_PX`` px) and the largest
    gap among those."""
    equal, total, found, gap = True, 0, 0, 0.0
    for g, r in zip(got, ref):
        g = {k: g[k].cpu() for k in PROGRAM_KEYS}
        r = {k: r[k].cpu() for k in PROGRAM_KEYS}
        equal = equal and all(torch.equal(g[k], r[k]) for k in PROGRAM_KEYS)
        for f, i in r["det_valid"].nonzero().tolist():
            total += 1
            same = g["det_valid"][f] & (g["classes"][f] == r["classes"][f, i])
            if bool(same.any()):
                d = float((g["boxes"][f][same].float()
                           - r["boxes"][f, i].float()).abs().amax(-1).min())
                if d <= MATCH_PX:
                    found += 1
                    gap = max(gap, d)
    return {"bit_equal": equal, "detections": total, "found": found,
            "found_gap_px": gap}


@contextlib.contextmanager
def meshes_on_one_card(dev):
    """Within the block, ``make_mesh(n, ...)`` gives ``n`` times ``dev``:
    the drivers' ``--mesh n`` on the one card of this machine."""
    from i2vsgg_tpu_torch.parallel import mesh
    real = mesh.make_mesh
    mesh.make_mesh = lambda n=0, device="cuda": [torch.device(dev)] * max(
        n, 1)
    try:
        yield
    finally:
        mesh.make_mesh = real


def serving_over_mesh(dev, counters, card: str, det, sgg, sgg_align, prd,
                      cfg, drivers: dict) -> dict:
    """17c (see the module docstring): the frame program over
    ``make_mesh([cuda:0, cuda:0])`` against the unsharded program, host
    planes under align (B1, B3) and f32 images under pool (B2); the last
    request's kernels held per replica; then ``serve_video`` with
    ``--mesh 1`` against phase 13b's ``--mesh 0`` run, and a ragged tail at
    ``--bs 4 --mesh 2`` against ``--bs 2 --mesh 0`` (``DEVKIT_RAGGED``)."""
    from i2vsgg_tpu_torch import serve
    from i2vsgg_tpu_torch.ops.conv1 import Conv1Planes
    from i2vsgg_tpu_torch.parallel import mesh
    from i2vsgg_tpu_torch.tools import serve_video
    rec = {}
    b = FULL["frames"]
    kw = dict(max_det=FULL["max_det"], max_per_class=FULL["max_per_class"])
    grid = mesh.make_mesh([dev, dev])
    requests = [make_inputs(FULL, 40 + i) for i in range(FULL["requests"])]
    saved_det = torch.backends.cudnn.deterministic
    saved_env = os.environ.get("I2VSGG_DATA_ROOT")
    torch.backends.cudnn.deterministic = True
    try:
        for name, head, to_input, per in (
                ("host planes, align", sgg_align,
                 lambda r: (Conv1Planes.pack(r[0]), r[1]),
                 dict(NO_LAUNCHES, conv1=1, roi_align=2 + b)),
                ("f32 images, pool", sgg, lambda r: r,
                 dict(NO_LAUNCHES, roi_align=2, roi_pool=b))):
            what = f"17c {name}"
            t = time.time()
            replicas = mesh.replicate((det, head), grid)
            programs = [serve.make_frame_program(d, s, prd, cfg, device=m,
                                                 **kw)
                        for (d, s), m in zip(replicas, grid)]
            sharded = serve.make_sharded_program(programs, grid)
            torch.cuda.synchronize()
            build_s = time.time() - t
            unsharded = serve.make_frame_program(det, head, prd, cfg,
                                                 device=dev, **kw)
            # the stem and the detector's two RoIAlign sites run once a
            # replica, the head's site once a frame
            per_mesh = dict(per, conv1=2 * per["conv1"],
                            roi_align=per["roi_align"] + 2)
            outs, times = serve_requests(sharded, requests, to_input,
                                         counters, per_mesh, what)
            for out in outs:
                check_outputs(out, FULL)
            ref, ref_times = serve_requests(unsharded, requests, to_input,
                                            counters, per,
                                            f"{what}: unsharded")
            # each replica against the unsharded program on its own rows:
            # the same shapes, so the same algorithms: bit-equal
            for req, out in zip(requests, outs):
                x, info = to_input(req)
                for i in range(len(grid)):
                    rows = range(i * b // 2, (i + 1) * b // 2)
                    part = unsharded(mesh.take_rows(x, rows),
                                     info[list(rows)])
                    for k in PROGRAM_KEYS:
                        if not torch.equal(part[k].cpu(),
                                           out[k][list(rows)].cpu()):
                            raise AssertionError(f"{what}: replica {i}'s "
                                                 f"{k} != the unsharded "
                                                 "program on its rows")
            cmp = whole_request_gap(outs, ref)
            x, info = to_input(requests[-1])
            held = {"sites": held_request_sites(what, sharded, (x, info),
                                                {k: per_mesh[k] for k in (
                                                    "roi_align",
                                                    "roi_pool")}, card)}
            if per["conv1"]:
                held["conv1"] = [held_conv1_planes(
                    d, mesh.take_rows(x, range(i * b // 2,
                                               (i + 1) * b // 2)).to(
                        m).planes, FULL["height"], FULL["width"],
                    f"{what} replica {i} conv1 stem", card)
                    for i, ((d, _), m) in enumerate(zip(replicas, grid))]
            rec[name] = dict(cmp, ms_per_request=steady_ms(times),
                             unsharded_ms_per_request=steady_ms(ref_times),
                             request_ms=times, build_s=build_s,
                             launches_per_request=per_mesh, **held)
            log(f"{what}: two replicas on {dev}; each replica bit-equal to "
                f"the unsharded program on its own rows; against the "
                f"unsharded program on the whole request (measured): "
                f"bit-equal {cmp['bit_equal']}, {cmp['found']} of "
                f"{cmp['detections']} detections found within {MATCH_PX} px "
                f"(largest gap {cmp['found_gap_px']:.3g} px); steady "
                f"{rec[name]['ms_per_request']:.2f} ms/request against "
                f"{rec[name]['unsharded_ms_per_request']:.2f} unsharded "
                f"[{card}]")
            del replicas, programs, sharded, unsharded
            torch.cuda.empty_cache()

        files = drivers["files"]
        os.environ["I2VSGG_DATA_ROOT"] = files["data"]
        out = os.path.join(os.path.dirname(files["default_out"]), "mesh1")
        argv = DRIVER_FULL + ["--load_name", files["det"], "--sgg_load_name",
                              files["sgg"], "--max_det", str(FULL["max_det"]),
                              "--save_dir", out, "--mesh", "1"]
        n_req = DEVKIT["videos"] * DEVKIT["frames"] // b
        t = time.time()
        _, launched = driver_launches(
            counters, "17c serve_video --mesh 1", lambda: serve_video.main(
                argv), dict(NO_LAUNCHES, roi_align=2, roi_pool=b), n_req)
        wall = time.time() - t
        rel = os.path.join("serve", "MVidVRD_test", "frame_detections.json")
        with open(os.path.join(out, rel)) as fh, \
                open(os.path.join(files["default_out"], rel)) as fh0:
            if json.load(fh) != json.load(fh0):
                raise AssertionError("17c serve_video --mesh 1: "
                                     "frame_detections.json != --mesh 0's")
        rec["serve_video mesh 1"] = {"wall_s": wall, "launches": {
            k: v // n_req for k, v in launched.items() if v}}
        log(f"17c serve_video --mesh 1 at full width: frame_detections.json "
            f"equal to 13b's --mesh 0 run; {wall:.2f} s with model build and "
            f"load [{card}]")

        root = os.path.join(os.path.dirname(files["data"]), "data_ragged")
        write_devkit(root, seed=2, shape=DEVKIT_RAGGED)
        os.environ["I2VSGG_DATA_ROOT"] = root
        runs, launches = {}, {}
        for m, bs in (("0", "2"), ("2", "4")):
            runs[m] = os.path.join(root, f"out_mesh{m}")
            argv = DRIVER_TINY + ["--bs", bs, "--max_det", "4",
                                  "--load_name", files["det_tiny"],
                                  "--sgg_load_name", files["sgg_tiny"],
                                  "--save_dir", runs[m], "--mesh", m]
            counters.reset()
            with tf32_off(), meshes_on_one_card(dev):
                serve_video.main(argv)
            torch.cuda.synchronize()
            launches[m] = {k: v for k, v in counters.read().items() if v}
        # 5 frames: at --bs 2 three program calls; at --bs 4 over 2
        # replicas four, the tail frame padded to 2 (one copy)
        frames = DEVKIT_RAGGED["frames"]
        want = {"0": {"roi_align": 2 * 3, "roi_pool": frames},
                "2": {"roi_align": 2 * 4, "roi_pool": frames + 1}}
        if launches != want:
            raise AssertionError(f"17c ragged: launches {launches}, "
                                 f"expected {want}")
        with open(os.path.join(runs["0"], rel)) as fh, \
                open(os.path.join(runs["2"], rel)) as fh2:
            got0, got2 = json.load(fh), json.load(fh2)
        n = sum(len(t) for v in got0.values() for _, t in v)
        if got0 != got2 or not n:
            raise AssertionError("17c ragged: --bs 4 --mesh 2's "
                                 "frame_detections.json != --bs 2 --mesh "
                                 f"0's ({n} tuples)")
        rec["ragged"] = dict(tuples=n, launches=launches)
        log(f"17c ragged tail: {frames} frames at --bs 4 --mesh 2 (two "
            f"replicas on {dev}; the tail of 1 frame padded to 2): "
            f"frame_detections.json ({n} tuples) equal to --bs 2 --mesh "
            f"0's; launches {launches}")
    finally:
        torch.backends.cudnn.deterministic = saved_det
        if saved_env is None:
            os.environ.pop("I2VSGG_DATA_ROOT", None)
        else:
            os.environ["I2VSGG_DATA_ROOT"] = saved_env
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        from i2vsgg_tpu_torch import serve
        from i2vsgg_tpu_torch.config import Config, cfg_from_list
        from i2vsgg_tpu_torch.data.pipeline import dequantize_image_u8
        from i2vsgg_tpu_torch.models import sgg as sgg_mod
        from i2vsgg_tpu_torch.models.backbones import (act_absmax,
                                                       clear_absmax,
                                                       nchw_to_nhwc)
        from i2vsgg_tpu_torch.ops import bottleneck as chain_mod
        from i2vsgg_tpu_torch.ops import conv1 as conv1_mod
        from i2vsgg_tpu_torch.ops import conv1_int8 as c8_mod
        from i2vsgg_tpu_torch.ops import roi_align as roi_align_mod
        from i2vsgg_tpu_torch.ops import roi_pool as roi_pool_mod
        from i2vsgg_tpu_torch.utils.params import (bf16_storage_cast,
                                                   load_act_scales,
                                                   quantize_dense_params,
                                                   quantize_trunk_params)
        from i2vsgg_tpu_torch.video.association import association
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "root of a checkout", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    counters = Counters()
    kernels = {}

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    name_power = smi_name_power()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{kind} x{count}; nvidia-smi: {name_power or 'not available'}")
    card = name_power or kind

    phase("2 build (one nvcc per source and the native batch loader's "
          "host compiler, in parallel)")
    runtime_build = build_kernels()

    phase("3 roi_pool kernel vs plain at (1, 38, 60, 1024)")
    g = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    rois = edge_rois(dev)
    for dt in (torch.bfloat16, torch.float32):
        fmap = torch.randn(1, 38, 60, 1024, generator=g, device=dev).to(dt)
        max_err = max(max_err, check_kernel_vs_plain(
            fmap, rois, f"{dt} edge-case rois"))
        rnd = torch.rand(200, 4, generator=g, device=dev) * torch.tensor(
            [960.0, 600.0, 960.0, 600.0], device=dev)
        rnd = torch.cat([torch.minimum(rnd[:, :2], rnd[:, 2:]),
                         torch.maximum(rnd[:, :2], rnd[:, 2:])], 1)
        rnd = torch.cat([torch.zeros_like(rnd[:, :1]), rnd], 1).contiguous()
        max_err = max(max_err, check_kernel_vs_plain(
            fmap, rnd, f"{dt} 200 random rois"))
    fmap2 = torch.randn(2, 38, 60, 1000, generator=g, device=dev)
    rois2 = torch.cat([rnd[:100], rnd[100:]], 0).clone()
    rois2[100:, 0] = 1.0
    max_err = max(max_err, check_kernel_vs_plain(
        fmap2.bfloat16(), rois2, "bf16 B=2, C=1000 (scalar path)"))
    kernels["roi_pool"] = {"max_abs_err": max_err}

    phase("3b conv1 kernel vs plain at (4, 600, 960): images and planes, "
          "stem and conv+ReLU, the v2 mode")
    spec = FULL
    b, h, w = spec["frames"], spec["height"], spec["width"]
    x = (torch.rand(b, h, w, 3, generator=g, device=dev) * 255 - 120)
    weight = torch.randn(64, 3, 7, 7, generator=g, device=dev) / 147 ** 0.5
    mul = torch.rand(64, generator=g, device=dev) + 0.5
    add = torch.randn(64, generator=g, device=dev)
    planes = conv1_mod.Conv1Planes.pack(x.cpu().numpy()).to(dev)
    if not torch.equal(planes.planes, conv1_mod.pack_conv1_planes(x)):
        raise AssertionError("host planes != device planes")
    c1 = conv1_mod
    err = 0.0
    for name, kern, plain, args in (
            ("bn_relu images", c1.conv1_bn_relu, c1.conv1_bn_relu_plain,
             (x, weight, mul, add)),
            ("bn_relu planes", c1.conv1_bn_relu_planes,
             c1.conv1_bn_relu_planes_plain,
             (planes.planes, h, w, weight, mul, add)),
            ("stem images", c1.conv1_stem, c1.conv1_stem_plain,
             (x, weight, mul, add)),
            ("stem planes", c1.conv1_stem_planes, c1.conv1_stem_planes_plain,
             (planes.planes, h, w, weight, mul, add)),
            ("v2 images", c1.conv1_bn_relu_v2, c1.conv1_bn_relu_v2_plain,
             (x, weight, mul, add))):
        err = max(err, held_one_ulp(kern(*args), plain(*args),
                                    f"conv1 {name}"))
    for kern_i, kern_p in ((c1.conv1_stem, c1.conv1_stem_planes),
                           (c1.conv1_bn_relu, c1.conv1_bn_relu_planes)):
        if not torch.equal(kern_i(x, weight, mul, add),
                           kern_p(planes.planes, h, w, weight, mul, add)):
            raise AssertionError(f"{kern_i.__name__}: the image form and the "
                                 "planes form differ")
    log("conv1 image form == planes form, bit for bit (stem and conv+ReLU)")
    kernels["conv1"] = {"max_abs_err": err}

    phase("3c roi_align kernel vs plain: edge rois at the main path's three "
          "shapes (the SGG site's as the f32 copy and widened from bf16), "
          "staged and per-cell modes")
    err = 0.0
    for fshape, dt, grid, od in (
            ((4, 38, 60, 1024), torch.bfloat16, (0, 2, 4, 6), None),
            ((4, 38, 60, 512), torch.bfloat16, None, None),
            ((1, 38, 60, 1024), torch.float32, None, None),
            ((1, 38, 60, 1024), torch.bfloat16, None, torch.float32)):
        fmap = (torch.randn(*fshape, generator=g, device=dev) * 4).to(dt)
        n_img = fshape[0]
        edge = align_edge_rois(dev, n_img).reshape(n_img, -1, 5)
        rnd = torch.rand(n_img, 116, 4, generator=g, device=dev) * \
            torch.tensor([1000.0, 640.0, 1000.0, 640.0], device=dev) - 20
        rnd = torch.cat([torch.minimum(rnd[..., :2], rnd[..., 2:]),
                         torch.maximum(rnd[..., :2], rnd[..., 2:])], -1)
        rnd = torch.cat([edge[:, :1, :1].expand(-1, 116, 1), rnd], -1)
        rois = torch.cat([edge, rnd], 1).reshape(-1, 5).contiguous()
        got = roi_align_mod.roi_align_avg(fmap, rois, grid=grid,
                                          out_dtype=od)
        plan = roi_align_mod.roi_align_avg.last_plan
        f_ref = fmap if od is None else fmap.to(od)
        ref = roi_align_mod.roi_align_avg_plain(f_ref, rois, grid=grid)
        what = (f"roi_align {fshape} {dt}{' to ' + str(od) if od else ''} "
                f"grid {grid}, R={rois.shape[0]}, {plan['mode']} slice "
                f"{plan['slice']}")
        if got.dtype == torch.float32:
            err = max(err, held_f32(got, ref, what, float(f_ref.abs().max())))
            gat = roi_align_mod.roi_align_avg_gather(f_ref, rois)
            held_f32(got, gat, what + " vs gather", float(f_ref.abs().max()))
        else:
            err = max(err, held_one_ulp(got, ref, what))
        if od is not None and not torch.equal(
                got, roi_align_mod.roi_align_avg(f_ref, rois, grid=grid)):
            raise AssertionError(f"{what}: the widening mode != the kernel "
                                 "on the f32 copy")
        if not torch.equal(got, roi_align_mod.roi_align_avg(
                fmap, rois, grid=grid, out_dtype=od, channel_slice=-1)):
            raise AssertionError(f"{what}: staged != per-cell mode")
    log("staged == per-cell bit for bit on every shape; the widening mode "
        "== the kernel on the f32 copy")
    kernels["roi_align"] = {"max_abs_err": err}

    phase("3d bottleneck chain kernel vs plain at (4, 38, 60, 1024), n 22, "
          "M 256: the res101 model's folded layer3 weights (bf16-stored)")
    t = time.time()
    cfg = cfg_from_list(["TEST.RPN_POST_NMS_TOP_N", "128",
                         "TEST.RPN_PRE_NMS_TOP_N", "512"], Config())
    det, sgg, prd = build_models(FULL, cfg, torch.Generator().manual_seed(3))
    # the third slice's weights: the same model stored in bf16, the SGG
    # head under align (phase 9 serves them)
    det9, sgg9 = copy.deepcopy(det), copy.deepcopy(sgg)
    bf16_storage_cast(det9)
    bf16_storage_cast(sgg9)
    sgg9.vrd.pooling = "align"
    det9.to(dev).eval()
    trunk9 = det9.trunk
    with torch.no_grad():
        imgs = torch.as_tensor(make_inputs(FULL, 10)[0], device=dev)
        x3 = trunk9.layer3.block0(trunk9.layer2(trunk9.layer1(
            trunk9._stem(imgs))))
        xin = nchw_to_nhwc(x3).to(torch.bfloat16).contiguous()
        wts = trunk9.layer3.folded_tail()
    torch.cuda.synchronize()
    log(f"models built (and a bf16-stored copy on the card) in "
        f"{time.time() - t:.2f} s; layer3 block0 output {tuple(xin.shape)}, "
        f"max |x| {float(xin.float().abs().max()):.3g}, {wts[0].shape[0]} "
        f"blocks in the tail")
    kern, plain = chain_mod.bottleneck_chain, chain_mod.bottleneck_chain_plain
    # every block of the tail on the chain's own maps, the 22-block call
    # against them and against f64; then two wrong chains must be refused
    check = held_chain(kern, xin, wts, f"bottleneck {wts[0].shape[0]} "
                       "blocks")
    for name, why in chain_controls(kern, xin, wts):
        log(f"refused as it must be: {name}: {why}")
    err = check["max_abs_err"]
    k_ms = cuda_ms(lambda: kern(xin, *wts), 20)
    with tf32_off():
        p_ms = cuda_ms(lambda: plain(xin, *wts), 3, 1)
    tail9 = [getattr(trunk9.layer3, f"block{i}")
             for i in range(1, trunk9.layer3.blocks)]

    def unfused_tail():
        y = x3
        for blk in tail9:
            y = blk(y)
        return y

    with torch.no_grad():
        tail_ms = cuda_ms(unfused_tail, 20)
        # the same tail replayed from a CUDA graph: its device time, without
        # the host's launch rate (~800 small launches) in the way
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                unfused_tail()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            unfused_tail()
        tail_graph_ms = cuda_ms(graph.replay, 20)
        del graph
    nbytes, flops = chain_work(xin, wts[0], wts[2], wts[4],
                               (wts[1], wts[3], wts[5]))
    bnd, by = bound_of(nbytes, flops, H100_BF16_OPS_PER_S)
    if not k_ms < tail_graph_ms:
        raise AssertionError(f"the chain kernel ({k_ms:.3f} ms) is not below "
                             f"the cuDNN tail from a CUDA graph "
                             f"({tail_graph_ms:.3f} ms)")
    # each GEMM phase alone: its kernel's device time, rate and share of its
    # bound, with registers, dynamic shared memory and spills from the build
    phase_ms = chain_phase_ms(kern, xin, wts)
    ptxas = ptxas_report("bottleneck.cu")
    smem = chain_mod._lib().i2vsgg_bottleneck_smem_bytes()
    phases = {}
    for (ph, tag), (pb, pf) in zip(CHAIN_PHASES, chain_phase_work(
            xin, wts[0], wts[2], wts[4], (wts[1], wts[3], wts[5])).values()):
        pbnd, pby = bound_of(pb, pf, H100_BF16_OPS_PER_S)
        built = next(v for k, v in ptxas.items()
                     if f"bottleneck_gemmILi{tag}E" in k)
        phases[ph] = {"ms": phase_ms[ph], "tflops": pf / phase_ms[ph] / 1e9,
                      "bound_ms": pbnd, "bound_by": pby,
                      "share_of_bound": pbnd / phase_ms[ph],
                      "smem_bytes": smem, **built}
        log(f"chain phase {ph} ({wts[0].shape[0]} launches): "
            f"{phase_ms[ph]:.3f} ms, {phases[ph]['tflops']:.1f} TFLOP/s, "
            f"{100 * pbnd / phase_ms[ph]:.1f} % of its {pbnd:.3f} ms bound "
            f"({pby}); {built['registers']} registers, {smem} B of shared "
            f"memory, {built['spill_bytes']} B spilled [{card}]")
    kernels["bottleneck"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": bnd, "bound_by": by,
                             "library_ms": None, "cudnn_tail_ms": tail_ms,
                             "cudnn_tail_graph_ms": tail_graph_ms,
                             "phases": phases, "chain_check": check}
    log(f"bottleneck chain per request (one call, {3 * wts[0].shape[0]} "
        f"launches): kernel {k_ms:.3f} ms ({100 * bnd / k_ms:.1f} % of its "
        f"bound), plain (f32) {p_ms:.3f} ms, the unfused ResNetStage tail on "
        f"cuDNN {tail_ms:.3f} ms ({tail_graph_ms:.3f} ms replayed from a CUDA "
        f"graph), bound {bnd:.3f} ms ({by}: {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB) [{card}]")

    phase("4 small program: card vs CPU (res10, 64x80, f32, TF32 off)")
    cfg_s = Config().replace(
        TEST=Config().TEST.__class__(RPN_PRE_NMS_TOP_N=100,
                                     RPN_POST_NMS_TOP_N=16),
        COMPUTE_DTYPE="float32")
    det_c, sgg_c, prd_s = build_models(SMALL, cfg_s,
                                       torch.Generator().manual_seed(1))
    det_g, sgg_g = copy.deepcopy(det_c), copy.deepcopy(sgg_c)
    imgs_s, info_s = make_inputs(SMALL, 2)
    kw = dict(max_det=SMALL["max_det"], max_per_class=SMALL["max_per_class"])
    ref = serve.make_frame_program(det_c, sgg_c, prd_s, cfg_s, device="cpu",
                                   **kw)(imgs_s, info_s)
    with tf32_off():
        got = serve.make_frame_program(det_g, sgg_g, prd_s, cfg_s,
                                       device=dev, **kw)(imgs_s, info_s)
    got = {k: v.cpu() for k, v in got.items()}
    # f32 sums run in another order on the card: boxes and probabilities
    # agree to 1e-4 of their largest magnitude; masks and classes exactly
    for k in ("det_valid", "classes", "pair_valid"):
        if not torch.equal(got[k], ref[k]):
            raise AssertionError(f"small program {k}: card != CPU")
    for k in ("boxes", "scores", "rel_prob"):
        err = float((got[k] - ref[k]).abs().max())
        tol = 1e-4 * max(1.0, float(ref[k].abs().max()))
        if not err <= tol:
            raise AssertionError(f"small program {k}: card vs CPU max abs err "
                                 f"{err} > {tol}")
        log(f"small program {k}: max abs err {err:.3g} (tol {tol:.3g})")

    phase("4b small program, bf16: card vs CPU (res50, 64x80, bf16-stored "
          "weights, I2VSGG_PALLAS_BOTTLENECK=1, SGG head under align)")
    cfg_b = cfg_s.replace(COMPUTE_DTYPE="bfloat16")
    det_c, sgg_c, prd_b = small_bf16_models(cfg_b)
    det_g, sgg_g = copy.deepcopy(det_c), copy.deepcopy(sgg_c)
    os.environ["I2VSGG_PALLAS_BOTTLENECK"] = "1"
    try:
        ref = serve.make_frame_program(det_c, sgg_c, prd_b, cfg_b,
                                       device="cpu", **kw)(imgs_s, info_s)
        counters.reset()
        got = serve.make_frame_program(det_g, sgg_g, prd_b, cfg_b,
                                       device=dev, **kw)(imgs_s, info_s)
        launched = counters.read()["bottleneck"]
        # layer2's tail (3 blocks) and layer3's (5), 3 launches a block
        want = 3 * fused_tail_blocks(det_g.trunk, SMALL50["height"],
                                     SMALL50["width"])
        fed = fed_stages(det_c, sgg_c, det_g, sgg_g, prd_b, cfg_b, imgs_s,
                         info_s, ref, dev, **kw)
    finally:
        del os.environ["I2VSGG_PALLAS_BOTTLENECK"]
    if launched != want or not want:
        raise AssertionError(f"small bf16 program: {launched} chain launches, "
                             f"expected {want}")
    # every difference is printed before any bound is applied. Each stage
    # fed the CPU's input is held tightly: the chain stages to the bounds of
    # tests/test_torch_bottleneck.py (rtol 0.05 with an atol of one bf16 ulp
    # of max|ref|, >= 99.9 % within 0.02); the RPN head within one bf16 ulp
    # plus one ulp of its largest output; the detector head's probabilities
    # within 1e-2 and deltas within 2e-2 (its bf16 layer4 features part at
    # the ulp level between cuDNN and oneDNN); the decoded boxes within 0.5
    # px; the SGG head within 5e-3.
    checks = []
    for what in ("layer2 (chain)", "layer3 (chain)"):
        a, b_ = (nchw_to_nhwc(t).float() for t in fed[what])
        ulp = 2.0 ** -8 * float(b_.abs().max())
        gap = (a - b_).abs()
        worst = float((gap / (0.05 * b_.abs() + max(0.05, ulp))).max())
        checks.append((f"{what} on the CPU's input, worst |d| / (0.05 |ref| "
                       "+ atol)", worst, 1.0))
        checks.append((f"{what} on the CPU's input, share outside 0.02",
                       float((gap > 0.02 * b_.abs() + max(0.02, ulp)).float()
                             .mean()), 1e-3))
    for what in ("rpn cls_score", "rpn bbox_pred"):
        a, b_ = (t.float() for t in fed[what])
        excess = float(((a - b_).abs() - 2.0 ** -7 * b_.abs()).max())
        checks.append((f"{what} on the CPU's map, excess over one bf16 ulp "
                       "/ max|ref|", excess / float(b_.abs().max()),
                       2.0 ** -8))
    dec_g, dec_c = fed["decode"]
    dec_g = reordered(dec_g, matched_order(dec_g, dec_c))
    for k in ("det_valid", "classes"):
        if not torch.equal(dec_g[k], dec_c[k]):
            raise AssertionError(f"small bf16 decode {k}: card != CPU")
    for what, (a, b_), tol in (
            ("cls_prob on the CPU's maps and proposals", fed["cls_prob"],
             1e-2),
            ("bbox_pred on the CPU's maps and proposals", fed["bbox_pred"],
             2e-2),
            ("decoded boxes (px) from those", (dec_g["boxes"],
                                               dec_c["boxes"]), 0.5),
            ("rel_prob on the CPU's detections", fed["rel_prob"], 5e-3)):
        checks.append((what, float((a.float() - b_.float()).abs().max()),
                       tol))
    # the whole program. res50's bf16 trunk parts between cuDNN and oneDNN
    # by an ulp here and there, the 16 bottlenecks compound it, and the
    # RPN's box deltas times anchors of up to 368 px turn it into pixels: a
    # near tie downstream (NMS, the top-K cut) may then keep another
    # proposal. So the card's whole program is held to the CPU's program
    # past the trunk fed the card's own trunk maps, the witness
    # (``whole_program_checks``).
    got = {k: v.cpu() for k, v in got.items()}
    witness, (maps_g, maps_c) = fed["witness"]
    checks += whole_program_checks(got, ref, witness, "small bf16 program")
    gap = (maps_g[0].float() - maps_c[0].float()).abs()
    top = maps_c[0].float().abs()
    log(f"small bf16 program: c4 of the whole trunk, card vs CPU: max abs "
        f"err {float(gap.max()):.3g} (max |ref| {float(top.max()):.3g}), "
        f"share within 0.02 "
        f"{float((gap <= 0.02 * top + 0.02).float().mean()):.6f}")
    for what, err, tol in checks:
        log(f"small bf16 program {what}: {err:.3g} (tol {tol:g})")
    bad = [what for what, err, tol in checks if not err <= tol]
    if bad:
        raise AssertionError(f"small bf16 program, card vs CPU: {bad} out of "
                             "bounds")
    log(f"small bf16 program: {launched} chain launches on the card")

    phase("4c small int8 program: card vs CPU (phase 4b's res50 model at "
          "64x80, bf16-stored weights, int8 fc6/fc7, int8 3x3 convs of "
          "layer2-4 with static scales calibrated on this input)")
    # phase 4b's model with the int8 levers. Its static scales are
    # calibrated on this program's own input by the package's capture
    # (``I2VSGG_INT8_CALIB``, as ``calibrate_act_scales`` runs it): the
    # calibration file's scales belong to a trained res101 at 600x960, and
    # on these random weights they make each int8 step about one bf16 ulp
    # of the activations, so that any ulp the card and the CPU part by
    # (cuDNN's and oneDNN's bf16 sums) becomes a step (phase 11 serves the
    # file's scales at full width)
    det_c, sgg_c, prd_b = small_bf16_models(cfg_b, int8_fc=True)
    with env_set({"I2VSGG_INT8_CALIB": "1"}):
        serve.make_frame_program(det_c, sgg_c, prd_b, cfg_b, device="cpu",
                                 **kw)(imgs_s, info_s)
    scales = {k: v / 127.0 for k, v in act_absmax(det_c).items()}
    clear_absmax(det_c)
    quantize_dense_params(sgg_c)
    quantize_trunk_params(det_c, INT8_SCOPE, scales)
    det_g, sgg_g = copy.deepcopy(det_c), copy.deepcopy(sgg_c)
    mods_c = {**int8_modules(det_c), **{f"sgg.{k}": m for k, m in
                                         int8_modules(sgg_c).items()}}
    mods_g = {**int8_modules(det_g), **{f"sgg.{k}": m for k, m in
                                         int8_modules(sgg_g).items()}}
    os.environ["I2VSGG_INT8_TRUNK"] = "1:" + INT8_SCOPE
    try:
        with recorded_calls(mods_c) as calls:
            ref = serve.make_frame_program(det_c, sgg_c, prd_b, cfg_b,
                                           device="cpu", **kw)(imgs_s, info_s)
        counters.reset()
        got = serve.make_frame_program(det_g, sgg_g, prd_b, cfg_b,
                                       device=dev, **kw)(imgs_s, info_s)
        gemms = counters.read()
        # every int8 module fed the CPU's input: bit-equal (the int32 sums
        # are exact on both sides, the quantization and rescale elementwise)
        with torch.no_grad():
            for name, args, out_c in calls:
                out_g = mods_g[name](*(a.to(dev) if torch.is_tensor(a) else a
                                       for a in args))
                gap = (out_g.cpu().float() - out_c.float()).abs()
                if not torch.equal(out_g.cpu(), out_c):
                    raise AssertionError(
                        f"small int8 program: {name} fed the CPU's input "
                        f"differs from the CPU's output by {float(gap.max())}")
        witness, maps_g = witness_outputs(det_c, sgg_c, det_g, prd_b, cfg_b,
                                          imgs_s, info_s, dev, **kw)
    finally:
        del os.environ["I2VSGG_INT8_TRUNK"]
    n_convs = sum(1 for k in mods_c if not k.startswith("sgg."))
    want = {"int8_conv2d": n_convs, "int8_linear": 2 * SMALL50["frames"]}
    if {k: gemms[k] for k in want} != want or len(calls) != sum(
            want.values()):
        raise AssertionError(f"small int8 program: int8 GEMMs {gemms}, "
                             f"{len(calls)} calls on the CPU, expected "
                             f"{want}")
    log(f"small int8 program: {len(calls)} int8 module calls ({n_convs} "
        f"convs, {want['int8_linear']} DenseInt8) fed the CPU's input: "
        "bit-equal")
    got = {k: v.cpu() for k, v in got.items()}
    checks = whole_program_checks(got, ref, witness, "small int8 program",
                                  int8=True)
    for what, err, tol in checks:
        log(f"small int8 program {what}: {err:.3g} (tol {tol:g})")
    bad = [what for what, err, tol in checks if not err <= tol]
    if bad:
        raise AssertionError(f"small int8 program, card vs CPU: {bad} out of "
                             "bounds")

    phase("5 full-width serving (res101 ic+gc, 600x960 bf16, rpn128/pre512, "
          "det8), f32 images, SGG head on RoIPool")
    t = time.time()
    kw = dict(max_det=FULL["max_det"], max_per_class=FULL["max_per_class"],
              device=dev)
    program = serve.make_frame_program(det, sgg, prd, cfg, **kw)
    torch.cuda.synchronize()
    log(f"weights on the card in {time.time() - t:.2f} s")
    requests = [make_inputs(FULL, 10 + i) for i in range(FULL["requests"])]
    torch.cuda.reset_peak_memory_stats()
    # one launch of RoIPool per frame; RoIAlign on the det subgrid and the
    # ic context per request; conv1 is cuDNN's on this path
    outs, times = serve_requests(
        program, requests, lambda r: r, counters,
        dict(NO_LAUNCHES, roi_pool=FULL["frames"], roi_align=2),
        "f32 images, pool")
    kernels["roi_pool"]["launches"] = counters.read()["roi_pool"]
    for out in outs:
        check_outputs(out, FULL)
    # the first frame of the last request and its detections, which phase
    # 22d draws
    valid = outs[-1]["det_valid"][0].cpu().numpy().astype(bool)
    served = {"frame": np.clip(np.rint(
        requests[-1][0][0] + np.asarray(cfg.PIXEL_MEANS, np.float32)), 0,
        255).astype(np.uint8)}
    served.update({k: outs[-1][k][0].float().cpu().numpy()[valid]
                   for k in ("boxes", "scores")})
    served["classes"] = outs[-1]["classes"][0].cpu().numpy()[valid]
    ms = {"f32_images_pool": steady_ms(times)}
    log(f"steady: {ms['f32_images_pool']:.2f} ms/request, "
        f"{1e3 * b / ms['f32_images_pool']:.2f} frames/s [{card}]; valid "
        f"detections {int(outs[-1]['det_valid'].sum())}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("5b roi_pool on the main path's own inputs: exactness and time")
    roi_pool_fn = roi_pool_mod.roi_pool
    seen = [(f, r) for op, _, f, r, _, _ in recorded_roi_sites(
        program, requests[-1]) if op == "roi_pool"]
    k_ms = p_ms = bound_ms = per_bin_ms = call_ms = 0.0
    by_slice = {}
    bound_by = "bytes"
    for fmap, rois in seen:                       # the request's 4 frames
        kernels["roi_pool"]["max_abs_err"] = max(
            kernels["roi_pool"]["max_abs_err"],
            check_kernel_vs_plain(fmap, rois, "main-path inputs"))
        roi_pool_fn(fmap, rois)
        plan = roi_pool_mod.roi_pool.last_plan
        k_ms += kernel_ms(lambda: roi_pool_fn(fmap, rois), "roi_pool_")
        call_ms += cuda_ms(lambda: roi_pool_fn(fmap, rois), 200)
        # the first design (the per-bin mode) on the same inputs
        per_bin_ms += kernel_ms(lambda: roi_pool_fn(
            fmap, rois, channel_slice=-1), "roi_pool_")
        for sl, t in slice_times(lambda sl: roi_pool_fn(
                fmap, rois, channel_slice=sl), "roi_pool_").items():
            by_slice[sl] = None if t is None else by_slice.get(sl, 0.0) + t
        p_ms += kernel_ms(lambda: roi_pool_mod.roi_pool_plain(fmap, rois),
                          reps=3)
        nbytes, compares = roi_pool_work(fmap, rois)
        bnd, bound_by = bound_of(nbytes, compares, H100_F32_OPS_PER_S)
        bound_ms += bnd
    if plan["mode"] != "staged":
        raise AssertionError(f"roi_pool on the main path's inputs: {plan}")
    built = build_facts("roi_pool.cu", "roi_pool_staged_kernelI13__nv_"
                        "bfloat16Li8E")
    log(f"main-path inputs: fmap {tuple(fmap.shape)} {fmap.dtype}, rois "
        f"{tuple(rois.shape)} x {len(seen)} frames")
    log(f"roi_pool per request (device time): {k_ms * 1e3:.2f} us "
        f"({k_ms * 1e3 / len(seen):.2f} per launch; back-to-back calls "
        f"{call_ms * 1e3:.2f} us, host included; slice {plan['slice']}, "
        f"{plan['smem_bytes']} B of shared memory, {built['registers']} "
        f"registers, {built['spill_bytes']} B spilled), per-bin mode (the "
        f"first design) {per_bin_ms * 1e3:.2f} us, by slice "
        f"{ {k: None if v is None else round(v * 1e3, 2) for k, v in by_slice.items()} } us, "
        f"plain {p_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us [{card}]")
    kernels["roi_pool"].update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=None,
                               per_bin_ms=per_bin_ms, slice_ms=by_slice,
                               call_ms=call_ms,
                               slice=plan["slice"],
                               smem_bytes=plan["smem_bytes"], **built)

    phase("6 this slice's path: host-packed conv1 planes, SGG head under "
          "align, a 12-frame video in 3 requests")
    sgg_align = copy.deepcopy(sgg)
    sgg_align.vrd.pooling = "align"
    program = serve.make_frame_program(det, sgg_align, prd, cfg, **kw)
    video = synthetic_video(FULL, seed=20)
    per_request = dict(NO_LAUNCHES, conv1=1,    # the stem: one launch
                       roi_align=2 + FULL["frames"])
    pack_ms = []

    def planes_input(req):
        t = time.time()
        planes = conv1_mod.Conv1Planes.pack(req[1])          # on the host
        pack_ms.append(1e3 * (time.time() - t))
        return planes, req[2]

    main_outs, times = serve_requests(program, video, planes_input, counters,
                                      per_request, "host planes, align")
    launches = counters.read()
    kernels["conv1"]["launches"] = launches["conv1"]
    kernels["roi_align"]["launches"] = launches["roi_align"]
    for out in main_outs:
        check_outputs(out, FULL)
    ms["host_planes_align"] = steady_ms(times)
    log(f"steady: {ms['host_planes_align']:.2f} ms/request (host packing "
        f"{', '.join(f'{x:.2f}' for x in pack_ms)} ms of it) [{card}]")

    phase("6b the same program fed f32 images under I2VSGG_PALLAS_CONV1=1: "
          "bit-equal")
    os.environ["I2VSGG_PALLAS_CONV1"] = "1"
    try:
        env_outs, times = serve_requests(program, video,
                                         lambda r: (r[1], r[2]), counters,
                                         per_request, "f32 images, env")
    finally:
        del os.environ["I2VSGG_PALLAS_CONV1"]
    for a, o in zip(main_outs, env_outs):
        same_outputs(a, o, "planes vs images under I2VSGG_PALLAS_CONV1=1")
    ms["images_env_align"] = steady_ms(times)
    log(f"outputs bit-equal to the host-planes path; steady "
        f"{ms['images_env_align']:.2f} ms/request")

    phase("6c bucketed program, buckets (4, 8), host planes")
    bucketed = serve.make_bucketed_program(det, sgg_align, prd, cfg,
                                           buckets=(4, 8), **kw)
    bk_outs, times = serve_requests(bucketed, video,
                                    lambda r: (conv1_mod.Conv1Planes.pack(
                                        r[1]), r[2]), counters, per_request,
                                    "bucketed (4, 8)")
    worst = bucketed_vs_fused(main_outs, bk_outs)
    ms["bucketed_planes_align"] = steady_ms(times)
    log(f"buckets chosen {[o['bucket'] for o in bk_outs]}; detections equal, "
        f"valid pairs' rel_prob within {worst:.3g} (tol 1e-3); steady "
        f"{ms['bucketed_planes_align']:.2f} ms/request")

    phase("6d Stage C over the video: per-frame tuples, association")
    frames = []
    for r, out in enumerate(main_outs):
        for f in range(b):
            frames.append([r * b + f, serve.frame_relation_tuples(out, f)])
    n_tuples = sum(len(t) for _, t in frames)
    relations = association(
        {"synthetic": copy.deepcopy(frames)},
        objects=[f"class{i}" for i in range(FULL["num_classes"])],
        predicates=[f"pred{i}" for i in range(FULL["num_rel"])])
    rels = relations.get("synthetic", [])
    if not rels:
        raise AssertionError("Stage C linked no video relation over 12 "
                             "identical frames")
    for rel in rels:
        s0, s1 = rel["duration"]
        if not (0 <= s0 < s1 <= len(frames)
                and len(rel["sub_traj"]) == len(rel["obj_traj"]) == s1 - s0
                and np.isfinite(rel["score"])):
            raise AssertionError(f"malformed video relation {rel}")
    log(f"{len(frames)} frames, {n_tuples} relation tuples -> {len(rels)} "
        f"video relations (durations "
        f"{sorted({tuple(r['duration']) for r in rels})[:4]}...)")

    phase("6e uint8 upload: dequantized on the card, equal to the f32 "
          "transport")
    u8 = torch.as_tensor(video[0][0], device=dev)
    small = torch.tensor([[560.0, 900.0, 1.0]] * b, device=dev)
    want = torch.as_tensor(video[0][1], device=dev).clone()
    want[:, 560:] = 0.0
    want[:, :, 900:] = 0.0
    if not torch.equal(dequantize_image_u8(u8, small, cfg.PIXEL_MEANS),
                       want):
        raise AssertionError("dequantize_image_u8 != the padded f32 "
                             "transport")
    os.environ["I2VSGG_PALLAS_CONV1"] = "1"
    try:
        def u8_input(req):
            img = torch.as_tensor(req[0], device=dev)
            info = torch.as_tensor(req[2], device=dev)
            return dequantize_image_u8(img, info, cfg.PIXEL_MEANS), info

        for req in video:
            x8, _ = u8_input(req)
            if not torch.equal(x8, torch.as_tensor(req[1], device=dev)):
                raise AssertionError("dequantize_image_u8 != f32 transport")
        u8_outs, times = serve_requests(program, video, u8_input, counters,
                                        per_request, "uint8 upload, env")
    finally:
        del os.environ["I2VSGG_PALLAS_CONV1"]
    for a, o in zip(env_outs, u8_outs):
        same_outputs(a, o, "uint8 upload vs f32 transport")
    ms["uint8_env_align"] = steady_ms(times)
    log(f"program inputs equal to the f32 transport's (and with a 560x900 "
        f"true size, to its zero padding); outputs bit-equal; steady "
        f"{ms['uint8_env_align']:.2f} ms/request")

    phase("6f a bucket below max_det: the bucketed program (buckets (4, 8)) "
          "against the fused one on weights that leave one foreground class "
          "(background and class 1 logits raised), at most 2 detections a "
          "frame; the SGG head under align on host planes, then under pool "
          "on f32 images")
    det_sparse = copy.deepcopy(det)
    with torch.no_grad():
        det_sparse.cls_score.bias[:2] += 1e4
    kw_sparse = dict(kw, max_per_class=2)
    sparse = {}
    for pooling, sgg_m, to_in, per in (
            ("align", sgg_align, lambda r: (conv1_mod.Conv1Planes.pack(r[1]),
                                            r[2]), per_request),
            ("pool", sgg, lambda r: (r[1], r[2]),
             dict(NO_LAUNCHES, roi_pool=b, roi_align=2))):
        fused = serve.make_frame_program(det_sparse, sgg_m, prd, cfg,
                                         **kw_sparse)
        bucketed = serve.make_bucketed_program(det_sparse, sgg_m, prd, cfg,
                                               buckets=(4, 8), **kw_sparse)
        ref_outs, _ = serve_requests(fused, video, to_in, counters, per,
                                     f"one foreground class, fused, {pooling}")
        sp_outs, times = serve_requests(bucketed, video, to_in, counters, per,
                                        f"one foreground class, bucketed, "
                                        f"{pooling}")
        chosen = [o["bucket"] for o in sp_outs]
        if not all(c < FULL["max_det"] for c in chosen):
            raise AssertionError(f"buckets chosen {chosen}: none below "
                                 f"max_det {FULL['max_det']}")
        worst = bucketed_vs_fused(ref_outs, sp_outs)
        n_valid = [int(o["det_valid"].sum()) for o in sp_outs]
        sparse[pooling] = {"buckets": chosen, "valid_detections": n_valid,
                           "max_rel_prob_diff": worst,
                           "ms": steady_ms(times)}
        log(f"{pooling}: buckets chosen {chosen}, valid detections a request "
            f"{n_valid}; detections equal, valid pairs' rel_prob within "
            f"{worst:.3g} (tol 1e-3); steady {sparse[pooling]['ms']:.2f} "
            "ms/request")

    phase("7 conv1 and roi_align on the main path's own inputs: exactness "
          "and time per request")
    ra_fn = roi_align_mod.roi_align_avg
    planes = conv1_mod.Conv1Planes.pack(video[-1][1])
    sites = [(f, r, k.get("grid"), k.get("out_dtype"))
             for op, _, f, r, _, k in recorded_roi_sites(
                 program, (planes, video[-1][2])) if op == "roi_align"]
    ra = kernels["roi_align"]
    ra.update(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
              per_cell_ms=0.0, call_ms=0.0, sites=[])
    # the SGG head's sites (one a frame) take the bf16 map as it comes and
    # widen it: no f32 copy
    sgg_sites = [x for x in sites if x[3] is not None]
    if len(sgg_sites) != b or any(
            f.dtype != torch.bfloat16 or od != torch.float32
            for f, _, _, od in sgg_sites):
        raise AssertionError("the SGG site's calls: "
                             f"{[(f.dtype, od) for f, _, _, od in sites]}")
    log(f"the SGG head's {b} sites receive the bf16 map with "
        "out_dtype=float32 (no f32 copy)")
    built_by = {}
    for fmap, rois, grid, od in sites:
        od = od or fmap.dtype
        got = ra_fn(fmap, rois, grid=grid, out_dtype=od)
        plan = roi_align_mod.roi_align_avg.last_plan
        if plan["mode"] != "staged":
            raise AssertionError(f"roi_align on the main path's inputs: "
                                 f"{plan}")
        f_ref = fmap.to(od)                  # the f32 copy where it widens
        ref = roi_align_mod.roi_align_avg_plain(f_ref, rois, grid=grid)
        what = (f"roi_align {tuple(fmap.shape)} {fmap.dtype} to {od} grid "
                f"{grid}")
        if od == torch.float32:
            e = held_f32(got, ref, what + " vs plain on the f32 copy",
                         float(f_ref.abs().max()))
        else:
            e = held_one_ulp(got, ref, what)
        copy_ms = None
        if od != fmap.dtype:
            if not torch.equal(got, ra_fn(f_ref, rois, grid=grid)):
                raise AssertionError(f"{what}: != the kernel on the f32 copy")
            # the former route of this site: the f32 copy, then the first
            # design (the per-cell mode) on it
            copy_ms = kernel_ms(lambda: ra_fn(fmap.float(), rois, grid=grid,
                                              channel_slice=-1))
        ra["max_abs_err"] = max(ra["max_abs_err"], e)
        k_ms = kernel_ms(lambda: ra_fn(fmap, rois, grid=grid, out_dtype=od),
                         "roi_align_")
        c_ms = cuda_ms(lambda: ra_fn(fmap, rois, grid=grid, out_dtype=od),
                       200)
        # the first design (the per-cell mode) on the same inputs
        pc_ms = kernel_ms(lambda: ra_fn(fmap, rois, grid=grid, out_dtype=od,
                                        channel_slice=-1), "roi_align_")
        by_slice = slice_times(lambda sl: ra_fn(
            fmap, rois, grid=grid, out_dtype=od, channel_slice=sl),
            "roi_align_")
        p_ms = kernel_ms(lambda: roi_align_mod.roi_align_avg_plain(
            f_ref, rois, grid=grid), reps=3)
        nbytes, flops = roi_align_work(fmap, rois, grid)
        if od != fmap.dtype:                 # the f32 output's extra bytes
            nbytes += rois.shape[0] * got[0].numel() * (
                od.itemsize - fmap.element_size())
        bnd, by = bound_of(nbytes, flops, H100_F32_OPS_PER_S)
        inst = ("roi_align_staged_kernelI13__nv_bfloat16"
                + ("fLi8E" if od == torch.float32 else "S1_Li8E"))
        built_by[inst] = build_facts("roi_align.cu", inst)
        ra["ms"] += k_ms
        ra["call_ms"] += c_ms
        ra["per_cell_ms"] += pc_ms
        ra["plain_ms"] += p_ms
        ra["bound_ms"] += bnd
        ra["bound_by"] = by
        ra["sites"].append({"fmap": list(fmap.shape),
                            "dtype": str(fmap.dtype), "out_dtype": str(od),
                            "rois": rois.shape[0], "grid": grid, "ms": k_ms,
                            "call_ms": c_ms,
                            "per_cell_ms": pc_ms, "copy_route_ms": copy_ms,
                            "slice_ms": by_slice, "slice": plan["slice"],
                            "smem_bytes": plan["smem_bytes"],
                            "plain_ms": p_ms, "bound_ms": bnd,
                            "bytes": nbytes, **built_by[inst]})
        log(f"{what}, R={rois.shape[0]}: kernel {k_ms * 1e3:.2f} us of "
            f"device time (back-to-back calls {c_ms * 1e3:.2f} us; slice "
            f"{plan['slice']}, {plan['smem_bytes']} B of shared memory, "
            f"{built_by[inst]['registers']} registers, "
            f"{built_by[inst]['spill_bytes']} B spilled), per-cell mode (the "
            f"first design) {pc_ms * 1e3:.2f} us"
            + (f", f32 copy + per-cell mode on it (the former route) "
               f"{copy_ms * 1e3:.2f} us"
               if copy_ms is not None else "")
            + f", by slice { {k: None if v is None else round(v * 1e3, 2) for k, v in by_slice.items()} } us"
            f", plain {p_ms * 1e3:.2f} us, bound {bnd * 1e3:.3f} us "
            f"({nbytes} B) [{card}]")
    ra["registers"] = max(v["registers"] for v in built_by.values())
    ra["spill_bytes"] = max(v["spill_bytes"] for v in built_by.values())
    ra["smem_bytes"] = max(x["smem_bytes"] for x in ra["sites"])
    log(f"roi_align per request (device time): {ra['ms'] * 1e3:.2f} us "
        f"(back-to-back calls {ra['call_ms'] * 1e3:.2f} us), per-cell mode "
        f"{ra['per_cell_ms'] * 1e3:.2f} us, bound {ra['bound_ms'] * 1e3:.3f} "
        f"us [{card}]")
    if len(sites) != per_request["roi_align"]:
        raise AssertionError(f"{len(sites)} roi_align calls per request")

    c1k = kernels["conv1"]
    weight = det.trunk.conv1.weight.detach()
    mul, add = det.trunk.bn1.affine()
    pl = planes.to(dev).planes
    c1k["max_abs_err"] = max(c1k["max_abs_err"], held_one_ulp(
        c1.conv1_stem_planes(pl, h, w, weight, mul, add),
        c1.conv1_stem_planes_plain(pl, h, w, weight, mul, add),
        "conv1 stem on the main path's planes and weights"))
    # timed as the trunk calls it: one launch on the weights it prepared
    # once (the public entries prepare them per call)
    prep = det.trunk.conv1_weights()
    if not torch.equal(c1.conv1_apply(pl, prep, (h, w), True),
                       c1.conv1_stem_planes(pl, h, w, weight, mul, add)):
        raise AssertionError("conv1 on the trunk's prepared weights != the "
                             "public entry")
    k_ms = cuda_ms(lambda: c1.conv1_apply(pl, prep, (h, w), True), 50)
    p_ms = cuda_ms(lambda: c1.conv1_stem_planes_plain(pl, h, w, weight, mul,
                                                      add), 10, 1)
    # the library call: cuDNN's conv with the BN scale folded into bf16
    # weights and the shift as its bias, on the same bf16 input (ReLU and
    # the pool would be extra passes)
    xb = torch.as_tensor(video[-1][1], device=dev).to(torch.bfloat16)
    xb = xb.permute(0, 3, 1, 2)                  # NCHW view, channels-last
    wf = c1.fold_v2_weight(weight, mul).contiguous(
        memory_format=torch.channels_last)
    bias = add.to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
        xb, wf, bias, stride=2, padding=3), 50)
    nbytes, flops = conv1_work(pl, b, h, w)
    bnd, by = bound_of(nbytes, flops, H100_BF16_OPS_PER_S)
    built = {k: v for k, v in ptxas_report("conv1.cu").items()
             if "conv1_kernelILi0ELb1E" in k}.popitem()[1]
    c1k.update(ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by,
               library_ms=lib_ms, modes={},
               smem_bytes=c1._lib().i2vsgg_conv1_smem_bytes(0), **built)
    if not k_ms < lib_ms:
        raise AssertionError(f"the conv1 stem ({k_ms * 1e3:.2f} us) is not "
                             f"faster than cuDNN's conv1 ({lib_ms * 1e3:.2f} "
                             "us)")
    log(f"conv1 stem, planes {tuple(pl.shape)}: kernel {k_ms * 1e3:.2f} us "
        f"(one launch, the pool fused; {100 * bnd / k_ms:.1f} % of its "
        f"bound; {built['registers']} registers, {c1k['smem_bytes']} B of "
        f"shared memory, {built['spill_bytes']} B spilled), plain "
        f"{p_ms * 1e3:.2f} us, F.conv2d (conv + affine only) "
        f"{lib_ms * 1e3:.2f} us, bound {bnd * 1e3:.3f} us ({nbytes} B, "
        f"{flops} flop) [{card}]")
    # the other forms on the same frames and weights: the stem fed f32
    # images, and conv + ReLU without the pool (B3's unpooled entry, and the
    # v2 mode B5), whose output is the full (4, 300, 480, 64) map
    x32 = torch.as_tensor(video[-1][1], device=dev)
    prep_v2 = c1.prepare_conv1(weight, mul, add, v2=True)
    # each with its kernel instantiation (source form, pool) for the build
    # facts
    for mode, kern, plain, x_in, run, inst in (
            ("stem_images", c1.conv1_stem, c1.conv1_stem_plain, x32,
             lambda: c1.conv1_apply(x32, prep, None, True), (1, 1)),
            ("bn_relu_planes", lambda *a: c1.conv1_bn_relu_planes(
                pl, h, w, *a[1:]), lambda *a: c1.conv1_bn_relu_planes_plain(
                pl, h, w, *a[1:]), pl,
             lambda: c1.conv1_apply(pl, prep, (h, w), False), (0, 0)),
            ("v2_images", c1.conv1_bn_relu_v2, c1.conv1_bn_relu_v2_plain,
             x32, lambda: c1.conv1_apply(x32, prep_v2, None, False),
             (1, 0))):
        out = kern(x_in, weight, mul, add)
        if not torch.equal(run(), out):
            raise AssertionError(f"conv1 {mode} on prepared weights != the "
                                 "public entry")
        km = cuda_ms(run, 50)
        pm = cuda_ms(lambda: plain(x_in, weight, mul, add), 10, 1)
        nb = (x_in.numel() * x_in.element_size() + 147 * 64 * 2 + 2 * 64 * 4
              + out.numel() * out.element_size())
        bd, _ = bound_of(nb, flops, H100_BF16_OPS_PER_S)
        built = {k: v for k, v in ptxas_report("conv1.cu").items()
                 if f"conv1_kernelILi{inst[0]}ELb{inst[1]}E" in k}.popitem()[1]
        c1k["modes"][mode] = {"ms": km, "plain_ms": pm, "bound_ms": bd,
                              "bytes": nb, **built, "smem_bytes":
                              c1._lib().i2vsgg_conv1_smem_bytes(inst[0])}
        log(f"conv1 {mode}: kernel {km * 1e3:.2f} us, plain {pm * 1e3:.2f} "
            f"us, bound {bd * 1e3:.3f} us ({nb} B); {built['registers']} "
            f"registers, {c1k['modes'][mode]['smem_bytes']} B of shared "
            f"memory, {built['spill_bytes']} B spilled [{card}]")

    phase("9 the third slice's path: bf16-stored weights, "
          "I2VSGG_PALLAS_BOTTLENECK=1 (layer3's tail on the chain kernel), "
          "host planes, SGG head under align; then the switch off")
    program9 = serve.make_frame_program(det9, sgg9, prd, cfg, **kw)

    def planes9(req):
        return conv1_mod.Conv1Planes.pack(req[1]), req[2]

    os.environ["I2VSGG_PALLAS_BOTTLENECK"] = "1"
    try:
        # at 600x960 the gate fuses layer3's tail only (22 blocks)
        per9 = dict(per_request, bottleneck=3 * fused_tail_blocks(
            det9.trunk, h, w))
        if not per9["bottleneck"]:
            raise AssertionError("the gate fuses no stage on this path")
        chain_outs, times = serve_requests(program9, video, planes9, counters,
                                           per9, "bf16 weights, chain")
    finally:
        del os.environ["I2VSGG_PALLAS_BOTTLENECK"]
    kernels["bottleneck"]["launches"] = counters.read()["bottleneck"]
    for out in chain_outs:
        check_outputs(out, FULL)
    ms["bf16_chain_planes_align"] = steady_ms(times)
    off_outs, times = serve_requests(program9, video, planes9, counters,
                                     per_request, "bf16 weights, switch off")
    for out in off_outs:
        check_outputs(out, FULL)
    ms["bf16_unfused_planes_align"] = steady_ms(times)
    same_cls = torch.cat([(a["classes"] == o["classes"]).flatten()
                          for a, o in zip(chain_outs, off_outs)])
    same_valid = torch.cat([(a["det_valid"] == o["det_valid"]).flatten()
                            for a, o in zip(chain_outs, off_outs)])
    box_gap = max(float((a["boxes"] - o["boxes"]).abs().max())
                  for a, o in zip(chain_outs, off_outs))
    agreement = {"classes_equal": float(same_cls.float().mean()),
                 "valid_equal": float(same_valid.float().mean()),
                 "max_box_diff_px": box_gap,
                 "valid_detections": int(chain_outs[-1]["det_valid"].sum())}
    log(f"chain vs switch off, same weights: classes equal "
        f"{agreement['classes_equal']:.4f}, validity equal "
        f"{agreement['valid_equal']:.4f}, largest box difference "
        f"{box_gap:.3f} px; steady {ms['bf16_chain_planes_align']:.2f} vs "
        f"{ms['bf16_unfused_planes_align']:.2f} ms/request [{card}]")

    phase("11 the fourth slice's path: the round-5 int8 configuration "
          "(bf16-stored weights, int8 fc6/fc7, the 3x3 convs of layer2-4 in "
          "int8 with static scales), f32 images, cuDNN conv1, SGG head under "
          "align; then phase 9's weights on the same images")
    t = time.time()
    # as bench.py builds it: bf16 storage (phase 9's weights), then
    # quantize_dense_params, then quantize_trunk_params with the
    # calibration file's scales; I2VSGG_INT8_TRUNK set; the chain off
    det_i8 = copy.deepcopy(det9)
    sgg_i8 = sgg_mod.SGGModel(sgg_mod.VRDHead(
        emb_dim=FULL["emb_dim"], fc_dim=FULL["fc_dim"], pooling="align",
        dtype=torch.bfloat16, int8_fc=True))
    bf16_storage_cast(sgg_i8)
    sgg_i8.load_state_dict(sgg9.state_dict())
    quantize_dense_params(sgg_i8)
    quantize_trunk_params(det_i8, INT8_SCOPE, load_act_scales(ACT_SCALES))
    program11 = serve.make_frame_program(det_i8, sgg_i8, prd, cfg, **kw)
    n_i8 = len(int8_modules(det_i8))
    torch.cuda.synchronize()
    log(f"int8 models built in {time.time() - t:.2f} s: {n_i8} int8 convs "
        f"with static scales from {os.path.relpath(ACT_SCALES)}, fc6/fc7 "
        "int8")

    def images_in(req):
        return req[1], req[2]

    per11 = dict(NO_LAUNCHES, roi_align=2 + FULL["frames"], int8_conv2d=n_i8,
                 int8_linear=2 * FULL["frames"])
    os.environ["I2VSGG_INT8_TRUNK"] = "1:" + INT8_SCOPE
    try:
        i8_outs, times = serve_requests(program11, video, images_in, counters,
                                        per11, "int8 levers, f32 images")
        ms["int8_images_align"] = steady_ms(times)
        kernels["conv1_int8"] = {"launches": counters.read()["conv1_int8"]}
        sat, sat_worst, sat_name = saturated_share(
            det_i8, lambda: program11(*images_in(video[-1])))
    finally:
        del os.environ["I2VSGG_INT8_TRUNK"]
    for out in i8_outs:
        check_outputs(out, FULL)
    ref_outs, times = serve_requests(
        program9, video, images_in, counters,
        dict(NO_LAUNCHES, roi_align=2 + FULL["frames"]),
        "bf16 weights, f32 images")
    ms["bf16_images_align"] = steady_ms(times)
    same_cls = torch.cat([(a["classes"] == o["classes"]).flatten()
                          for a, o in zip(i8_outs, ref_outs)])
    same_valid = torch.cat([(a["det_valid"] == o["det_valid"]).flatten()
                            for a, o in zip(i8_outs, ref_outs)])
    both = [a["det_valid"] & o["det_valid"] & (a["classes"] == o["classes"])
            for a, o in zip(i8_outs, ref_outs)]
    box_gap = max(float(((a["boxes"] - o["boxes"]).abs().amax(-1) * v).max())
                  for a, o, v in zip(i8_outs, ref_outs, both))
    int8_vs_bf16 = {"classes_equal": float(same_cls.float().mean()),
                    "valid_equal": float(same_valid.float().mean()),
                    "max_box_diff_px_same_class": box_gap,
                    "valid_detections": int(i8_outs[-1]["det_valid"].sum()),
                    "saturated_share": sat, "saturated_share_worst": sat_worst,
                    "saturated_worst_conv": sat_name}
    log(f"int8 vs bf16 weights on the same images: classes equal "
        f"{int8_vs_bf16['classes_equal']:.4f}, validity equal "
        f"{int8_vs_bf16['valid_equal']:.4f}, largest box difference where "
        f"both keep the class {box_gap:.3f} px; activations saturated at "
        f"+-127 under the calibrated scales: {sat:.6f} of all (at most "
        f"{sat_worst:.6f}, {sat_name}); steady "
        f"{ms['int8_images_align']:.2f} vs {ms['bf16_images_align']:.2f} "
        f"ms/request (phase 9: {ms['bf16_unfused_planes_align']:.2f} with "
        f"host planes, chain off) [{card}]")

    phase("11b conv1_int8 (B6) kernel vs plain on the int8 path's frames "
          "(4, 600, 960) and conv1 weights, and on clamped and tied inputs: "
          "bit-equal; device time, bound, build facts, cuDNN's bf16 conv1")
    x8 = torch.as_tensor(video[-1][1], device=dev)   # integer pixels - means
    w1 = det_i8.trunk.conv1.weight.detach()
    mul1, add1 = det_i8.trunk.bn1.affine()
    params8 = c8_mod.conv1_int8_params(w1, mul1, add1, cfg.PIXEL_MEANS)
    got8 = c8_mod.conv1_bn_relu_int8(x8, w1, mul1, add1, cfg.PIXEL_MEANS)
    want8 = c8_mod.conv1_bn_relu_int8_plain(x8, *params8)
    if not torch.equal(got8, want8):
        raise AssertionError(
            f"conv1_int8 kernel != plain: max abs err "
            f"{float((got8.float() - want8.float()).abs().max())}")
    xe = torch.as_tensor(int8_edge_images(tuple(x8.shape[:3])), device=dev)
    if not torch.equal(c8_mod.conv1_int8_apply(xe, *params8),
                       c8_mod.conv1_bn_relu_int8_plain(xe, *params8)):
        raise AssertionError("conv1_int8 kernel != plain on clamped and tied "
                             "inputs")
    k_ms = kernel_ms(lambda: c8_mod.conv1_int8_apply(x8, *params8),
                     "conv1_int8")
    call_ms = cuda_ms(lambda: c8_mod.conv1_int8_apply(x8, *params8), 50)
    # kernel_ms's fallback, on a kernel the profiler also timed
    events = events_ms(lambda: c8_mod.conv1_int8_apply(x8, *params8))
    p_ms = cuda_ms(lambda: c8_mod.conv1_bn_relu_int8_plain(x8, *params8), 10,
                   1)
    xb = x8.to(torch.bfloat16).permute(0, 3, 1, 2)   # NCHW view, channels-last
    wf = c1.fold_v2_weight(w1, mul1).contiguous(
        memory_format=torch.channels_last)
    bias1 = add1.to(torch.bfloat16)
    cudnn_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
        xb, wf, bias1, stride=2, padding=3), 50)
    nbytes, ops = conv1_int8_work(x8, got8)
    bnd, by = bound_of(nbytes, ops, H100_INT8_OPS_PER_S)
    built = build_facts("conv1_int8.cu", "conv1_int8_kernel")
    kernels["conv1_int8"].update(
        max_abs_err=0.0, ms=k_ms, call_ms=call_ms, events_ms=events,
        plain_ms=p_ms,
        bound_ms=bnd, bound_by=by, library_ms=None,
        cudnn_bf16_conv1_ms=cudnn_ms,
        smem_bytes=c8_mod._lib().i2vsgg_conv1_int8_smem_bytes(), **built)
    log(f"conv1_int8 on {tuple(x8.shape)}: bit-equal to plain, also on "
        f"clamped and tied inputs; kernel {k_ms * 1e3:.2f} us of device time "
        f"({call_ms * 1e3:.2f} us back to back, {events * 1e3:.2f} us by "
        f"events behind a busy-wait), {100 * bnd / k_ms:.1f} % of "
        f"its bound {bnd * 1e3:.3f} us ({by}: {nbytes} B, {ops} int8 ops); "
        f"{built['registers']} registers, "
        f"{kernels['conv1_int8']['smem_bytes']} B of shared memory, "
        f"{built['spill_bytes']} B spilled; plain {p_ms * 1e3:.2f} us, cuDNN "
        f"bf16 conv (+ affine) {cudnn_ms * 1e3:.2f} us [{card}]")

    phase("12 the eighth slice's paths, served at full width on the video "
          "as f32 images: 12a VGG16 (ic+gc, align/7, class-agnostic boxes; "
          "SGG head on RoIPool over 512 channels), 12b ResNet-101 on the "
          "non-fused path (POOLING_MODE=pool; SGG head under align, "
          "spatial_type 0, no object visual branch)")
    slice8 = {}
    for name, spec, cfg12, extra, per in (
            ("12a vgg16", dict(FULL, backbone="vgg16"), cfg,
             dict(class_agnostic=True, vrd=dict(in_channels=512)),
             dict(NO_LAUNCHES, roi_align=1, roi_pool=b)),
            ("12b res101 pool", FULL, cfg.replace(POOLING_MODE="pool"),
             dict(pooling="align",
                  vrd=dict(spatial_type=0, use_obj_visual=False)),
             dict(NO_LAUNCHES, roi_pool=1, roi_align=b))):
        phase(f"{name}: frame program and bucketed program, 3 requests; "
              "each RoI call held to its plain version and timed")
        t = time.time()
        det12, sgg12, prd12 = build_models(
            spec, cfg12, torch.Generator().manual_seed(12), **extra)
        if det12.fused:
            raise AssertionError(f"{name}: the detector takes the fused path")
        log(f"models built in {time.time() - t:.2f} s")
        slice8[name] = serve_slice8(name, det12, sgg12, prd12, cfg12, video,
                                    images_in, counters, per, card, **kw)
        del det12, sgg12
        torch.cuda.empty_cache()

    phase("12c small programs of 12a and 12b: card vs CPU (64x80, 4 "
          "classes, f32, TF32 off), detections matched before comparing")
    for name, spec, cfg12, extra, per in (
            ("small vgg16", dict(SMALL, backbone="vgg16"), cfg_s,
             dict(class_agnostic=True, vrd=dict(in_channels=512)),
             dict(roi_align=1, roi_pool=SMALL["frames"])),
            ("small res101 pool", dict(SMALL, backbone="res101"),
             cfg_s.replace(POOLING_MODE="pool"),
             dict(pooling="align",
                  vrd=dict(spatial_type=0, use_obj_visual=False)),
             dict(roi_pool=1, roi_align=SMALL["frames"]))):
        small_card_vs_cpu(name, spec, cfg12, extra, per, counters, dev,
                          imgs_s, info_s)

    work13 = tempfile.mkdtemp(prefix="chip_smoke_drivers_")
    try:
        drivers = drivers_on_card(dev, counters, card, work13)
        phase("16a JPEG decode: "
              "every committed fixture held to its golden, the refused ones "
              "refused, decode times beside PNG (16b runs after phase 15)")
        jpeg_rec = {"16a fixtures": jpeg_fixtures_on_host(card)}
        training, stage_b, jpeg_rec["16b mvrd"], dp, int8_gate = (
            training_phases(dev, counters, card))
        phase("17c serving over a mesh of two replicas on cuda:0 at full "
              "width (host planes under align: B1, B3; f32 images under "
              "pool: B2), 3 requests, each replica held to the unsharded "
              "program on its rows, each replica's kernels held; "
              "serve_video --mesh 1 against 13b's --mesh 0; a ragged tail "
              "at --bs 4 --mesh 2 against --bs 2 --mesh 0")
        dp["17c mesh"] = serving_over_mesh(dev, counters, card, det, sgg,
                                           sgg_align, prd, cfg, drivers)
        native_io = native_loader_on_card(counters, card, work13, drivers,
                                          runtime_build)
        formats = decode_formats_on_card(counters, card, work13, drivers)
        last = {}
        gates = serving_gates_on_card(
            counters, card, after=lambda out: last.update(
                last_modules_on_card(counters, card, drivers, work13, out,
                                     served)))
    finally:
        shutil.rmtree(work13, ignore_errors=True)
    phase("23 results")
    print(json.dumps({"training": training, "stage_b": stage_b,
                      "data_parallel": dp, "native_io": native_io,
                      "decode_formats": formats, "int8_gate": int8_gate,
                      "serving_gates": gates, "gates": gates["gates"],
                      "last_modules": last,
                      "jpeg": jpeg_rec, "serving": {
        "ms_per_request": ms, "frames_per_request": b,
        "video_relations": len(rels), "relation_tuples": n_tuples,
        "buckets": [o["bucket"] for o in bk_outs],
        "below_max_det": sparse,
        "chain_vs_unfused": agreement, "int8_vs_bf16": int8_vs_bf16,
        "slice8": slice8, "drivers": drivers,
        "wall_s": time.time() - T0}}), flush=True)
    meta = {
        "roi_pool": ("i2vsgg_tpu_torch/csrc/roi_pool.cu",
                     "i2vsgg_tpu/ops/pallas/roi_pool_kernel.py:134",
                     "none: no single PyTorch call computes RoIPool"),
        "conv1": ("i2vsgg_tpu_torch/csrc/conv1.cu",
                  "i2vsgg_tpu/ops/pallas/conv1_kernel.py:249",
                  "F.conv2d of the bf16 input with bf16(w * mul) and the "
                  "shift as bias: conv + BN affine only (ReLU and the pool "
                  "would be extra passes)"),
        "roi_align": ("i2vsgg_tpu_torch/csrc/roi_align.cu",
                      "i2vsgg_tpu/ops/pallas/roi_align_kernel.py:119",
                      "none: no single PyTorch call computes RoIAlignAvg"),
        "bottleneck": ("i2vsgg_tpu_torch/csrc/bottleneck.cu",
                       "i2vsgg_tpu/ops/pallas/bottleneck_kernel.py:165",
                       "none: no single PyTorch call computes the chain; "
                       "yardstick: the unfused ResNetStage tail on cuDNN "
                       "(cudnn_tail_ms; cudnn_tail_graph_ms replayed from a "
                       "CUDA graph)"),
        "conv1_int8": ("i2vsgg_tpu_torch/csrc/conv1_int8.cu",
                       "i2vsgg_tpu/ops/pallas/conv1_int8_kernel.py:147",
                       "none: no single PyTorch call computes the int8 conv1; "
                       "yardstick: cuDNN's bf16 conv1 with the BN scale "
                       "folded and the shift as bias (cudnn_bf16_conv1_ms)")}
    for name in ("roi_pool", "roi_align", "conv1", "bottleneck"):
        kernels[name]["phase13_launches"] = {
            run: r["launches"].get(name, 0)
            for run, r in drivers["serve"].items()}
    # the kernels at the drivers' shapes (608x1216 and 608x896 frames)
    for name in ("roi_pool", "roi_align"):
        kernels[name]["phase13_sites"] = [
            dict(t, run=run, site=key.split()[1])
            for run, r in drivers["serve"].items()
            for key, t in r.get("sites", {}).items()
            if key.startswith(name + " ")]
    kernels["conv1"]["phase13_planes"] = drivers["serve"]["host_planes"][
        "conv1"]
    kernels["bottleneck"]["phase13_chain"] = drivers["serve"][
        "bf16 weights, chain"]["chain"]
    # the kernels at the training sites (phase 14a align, 14b pool): their
    # launches a step and each call of the last step, with the plain
    # backward's device time beside it
    for name, run in (("roi_align", "14a align"), ("roi_pool", "14b pool")):
        t = training[run]
        kernels[name]["phase14_launches_per_step"] = t["launches_per_step"]
        kernels[name]["phase14_sites"] = [
            dict(site, backward_ms=b)
            for site, b in zip(t["sites"], t["backward_ms"])]
    # the kernels at Stage B's training site (phase 15a pool, 15b align):
    # their launches a step and the last step's call
    for name, run in (("roi_pool", "15a pool"), ("roi_align", "15b align")):
        t = stage_b[run]
        kernels[name]["phase15_launches_per_step"] = t["launches_per_step"]
        kernels[name]["phase15_sites"] = t["sites"]
    # the kernels at phase 17c's replicas (two on cuda:0, a request of
    # 4 frames split 2 + 2)
    mesh_rec = dp["17c mesh"]
    for name in ("roi_pool", "roi_align"):
        kernels[name]["phase17_sites"] = [
            dict(t, path=path, site=key.split()[1])
            for path in ("host planes, align", "f32 images, pool")
            for key, t in mesh_rec[path]["sites"].items()
            if key.startswith(name + " ")]
    kernels["conv1"]["phase17_planes"] = mesh_rec["host planes, align"][
        "conv1"]
    # the kernels at phase 21's sites: B1 in the gate arm's Stage A steps
    # and test_det's detector site, B2 at Stage B's and quant_ab's scorer
    kernels["roi_align"]["phase21_launches_per_step"] = gates["21a arm"][
        "roi_align_per_step"]
    kernels["roi_align"]["phase21_sites"] = (gates["21a arm"]["sites"]
                                             + gates["21b capacity"]["sites"])
    kernels["roi_pool"]["phase21_launches_per_step"] = 1
    kernels["roi_pool"]["phase21_sites"] = gates["21d int8 fc"]["sites"]
    # B2 at phase 22c's scorer (stage_c_hard's), once a scorer call
    kernels["roi_pool"]["phase22_launches"] = (
        last["22c eval tools"]["scorer_calls"]
        + last["22c eval tools"]["rescore_scorer_calls"])
    kernels["roi_pool"]["phase22_sites"] = last["22c eval tools"]["sites"]
    for name in ("roi_pool", "roi_align"):
        kernels[name]["phase12_sites"] = [
            dict(t, path=path, site=key.split()[1])
            for path, rec in slice8.items()
            for key, t in rec["sites"].items() if key.startswith(name + " ")]
    line = []
    for name in ("roi_pool", "roi_align", "conv1", "bottleneck",
                 "conv1_int8"):
        k = kernels[name]
        line.append({"name": name, "route": "cuda", "source": meta[name][0],
                     "replaces": meta[name][1], "launches": k["launches"],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                     "library_call": meta[name][2], "per": "request",
                     **{key: k[key] for key in ("sites", "modes", "phases",
                                                "registers", "smem_bytes",
                                                "spill_bytes", "slice",
                                                "slice_ms", "per_bin_ms",
                                                "per_cell_ms", "call_ms",
                                                "cudnn_tail_ms",
                                                "cudnn_tail_graph_ms",
                                                "chain_check",
                                                "cudnn_bf16_conv1_ms",
                                                "phase12_sites",
                                                "phase13_launches",
                                                "phase13_sites",
                                                "phase13_planes",
                                                "phase13_chain",
                                                "phase14_launches_per_step",
                                                "phase14_sites",
                                                "phase15_launches_per_step",
                                                "phase15_sites",
                                                "phase17_sites",
                                                "phase17_planes",
                                                "phase21_launches_per_step",
                                                "phase21_sites",
                                                "phase22_launches",
                                                "phase22_sites")
                        if key in k}})
    print(json.dumps({"kernels": line}), flush=True)
    print(name_power or f"{kind}, power limit not read", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-driver"]:
        sys.exit(rank_driver(sys.argv[2:]))
    if sys.argv[1:2] == ["--gloo-rank"]:
        sys.exit(gloo_rank(sys.argv[2:]))
    if sys.argv[1:] == ["--chain-depths"]:
        if not torch.cuda.is_available():
            print("chip_smoke: --chain-depths needs a CUDA card",
                  file=sys.stderr)
            sys.exit(2)
        sys.exit(chain_depths())
    sys.exit(main())
