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
  runs both programs at 64x80 on the card and on the CPU.

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

The lines before the last are the serving record (ms per 4-frame request of
each path served) and the kernels' JSON record (launches on the main path,
error against the plain version; per request: the kernel's time, its plain
version's, the library call's and the bound), then the card's name and
power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
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
               min_equal: float = 0.99, quiet: bool = False) -> dict:
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

    Raises AssertionError at the first bound broken. Returns the numbers:
    the largest abs error, excess and least bit-equal share over the
    blocks, and the whole chain's shares against f64."""
    import i2vsgg_tpu_torch.ops.bottleneck as chain_mod
    plain = chain_mod.bottleneck_chain_plain
    n = wts[0].shape[0]
    maps, err, worst_excess, least = [x], 0.0, 0.0, 1.0
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
        ok = bool((gap <= 2.0 ** -7 * ref.abs() + 2 * excess
                   + 2.0 ** -16 * float(ref.abs().max())).all())
        equal = float((g == ref).float().mean())
        err, least = max(err, float(gap.max())), min(least, equal)
        worst_excess = max(worst_excess, excess)
        if not ok or equal < min_equal:
            raise AssertionError(
                f"{what}: block {i} alone on the chain's map: max abs err "
                f"{float(gap.max())}, plain vs f64 excess over one ulp "
                f"{excess:.4g}, bit-equal share {equal:.6f} (needs one ulp "
                f"+ twice that excess, and {min_equal} bit-equal)")
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
    positional inputs, output) while inside."""

    def __init__(self, modules: dict):
        self.modules, self.calls, self.handles = modules, [], []

    def __enter__(self):
        for name, m in self.modules.items():
            self.handles.append(m.register_forward_hook(
                lambda mod, args, out, name=name:
                self.calls.append((name, args, out))))
        return self.calls

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def calibrated_act_scales(det, scope: str, run) -> dict:
    """Static activation scales for the convs of ``det`` (a float model)
    that ``quantize_trunk_params(det, scope)`` selects, calibrated on the
    inputs of ``run()`` as the JAX package's
    ``tools/calibrate_act_scales.py`` calibrates them: each conv's input
    abs-max over the run, / 127, by its flax path."""
    from i2vsgg_tpu_torch.utils.params import quantize_trunk_params
    names = set(int8_modules(quantize_trunk_params(copy.deepcopy(det),
                                                   scope)))
    convs = {n: m for n, m in det.named_modules() if n in names}
    with recorded_calls(convs) as calls:
        run()
    absmax: dict = {}
    for name, args, _ in calls:
        path = name.replace(".", "/")
        absmax[path] = max(absmax.get(path, 0.0),
                           float(args[0].float().abs().max()))
    return {k: v / 127.0 for k, v in absmax.items()}


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


def build_kernels():
    """Build every kernel source with one nvcc each, all started together;
    print each build's time and what ptxas reports."""
    from i2vsgg_tpu_torch.utils import cuda_build

    def one(src):
        t = time.time()
        lib = cuda_build.build(src)
        return src, lib, time.time() - t

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(one, KERNEL_SOURCES))
    for src, lib, sec in built:
        log(f"built {lib.name} in {sec:.2f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas ({src}): {line.strip()}")


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
            seen.append((op, site, features, rois, a, k))
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
           "valid_detections": int(outs[-1]["det_valid"].sum()),
           "sites": {}}
    log(f"{name}: buckets chosen {rec['buckets']}; detections equal to the "
        f"frame program's, valid pairs' rel_prob within {worst:.3g} (tol "
        f"1e-3); steady {rec['ms_per_request']:.2f} ms/request (bucketed "
        f"{rec['bucketed_ms_per_request']:.2f}), valid detections "
        f"{rec['valid_detections']} [{card}]")
    for op, site, fmap, rois, a, k in recorded_roi_sites(
            program, to_input(video[-1])):
        what = f"{name} {op} {site} site {tuple(fmap.shape)} {fmap.dtype}"
        one = held_roi_site(op, fmap, rois, a, k, what)
        key = f"{op} {site}"
        tot = rec["sites"].setdefault(key, dict(
            one, launches_per_request=0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            bytes=0, slice_ms=dict.fromkeys(one["slice_ms"], 0.0)))
        tot["launches_per_request"] += 1
        for f in ("ms", "plain_ms", "bound_ms", "bytes"):
            tot[f] += one[f]
        for sl, v in one["slice_ms"].items():    # None: the slice did not fit
            tot["slice_ms"][sl] = (None if v is None or tot["slice_ms"][sl]
                                   is None else tot["slice_ms"][sl] + v)
        tot["max_abs_err"] = max(tot["max_abs_err"], one["max_abs_err"])
    calls = {op: sum(t["launches_per_request"] for key, t in
                     rec["sites"].items() if key.startswith(op + " "))
             for op in ("roi_align", "roi_pool")}
    if calls != {op: per_request[op] for op in calls}:
        raise AssertionError(f"{name}: RoI calls a request {calls}, expected "
                             f"{per_request}")
    for key, t in rec["sites"].items():
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
    return rec


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
        from i2vsgg_tpu_torch.models.backbones import nchw_to_nhwc
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

    phase("2 build (one nvcc per source, in parallel)")
    build_kernels()

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
    # calibrated on this program's own input, as the calibration tool
    # calibrates them: the calibration file's scales belong to a trained
    # res101 at 600x960, and on these random weights they make each int8
    # step about one bf16 ulp of the activations, so that any ulp the card
    # and the CPU part by (cuDNN's and oneDNN's bf16 sums) becomes a step
    # (phase 11 serves the file's scales at full width)
    det_c, sgg_c, prd_b = small_bf16_models(cfg_b, int8_fc=True)
    scales = calibrated_act_scales(
        det_c, INT8_SCOPE, lambda: serve.make_frame_program(
            det_c, sgg_c, prd_b, cfg_b, device="cpu", **kw)(imgs_s, info_s))
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

    phase("13 results")
    print(json.dumps({"serving": {
        "ms_per_request": ms, "frames_per_request": b,
        "video_relations": len(rels), "relation_tuples": n_tuples,
        "buckets": [o["bucket"] for o in bk_outs],
        "below_max_det": sparse,
        "chain_vs_unfused": agreement, "int8_vs_bf16": int8_vs_bf16,
        "slice8": slice8, "wall_s": time.time() - T0}}), flush=True)
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
                                                "phase12_sites")
                        if key in k}})
    print(json.dumps({"kernels": line}), flush=True)
    print(name_power or f"{kind}, power limit not read", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--chain-depths"]:
        if not torch.cuda.is_available():
            print("chip_smoke: --chain-depths needs a CUDA card",
                  file=sys.stderr)
            sys.exit(2)
        sys.exit(chain_depths())
    sys.exit(main())
