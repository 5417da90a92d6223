#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's fused det+SGG serving program.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_torch_serving.py [--requests 4] [--trace PATH]
        [--host-planes] [--vrd-pooling {pool,align}] [--bf16-params]
        [--pallas-bottleneck] [--int8-fc6] [--int8-trunk-scope 1:<scope>]
        [--int8-static-acts PATH|1]

Builds the full-width program of ``chip_smoke.py`` (res101 ic+gc, 600x960
bf16, rpn128/pre512, det8, 4 frames per request, seeded random weights),
serves one warm-up request, then three passes of ``--requests`` requests.
``--host-planes`` feeds each request as conv1 parity planes packed on the
host (``Conv1Planes``; the trunk's stem is then the conv1 kernel, and the
packing is part of each request's host time); ``--vrd-pooling`` picks the
SGG head's pooling (``pool``, ``cli/args.py``'s default, or ``align``);
``--bf16-params`` stores the weights in bf16 (``bf16_storage_cast``, as
bench.py's flag of that name does); ``--pallas-bottleneck`` sets
``I2VSGG_PALLAS_BOTTLENECK=1``, so layer3's identity tail runs as the chain
kernel (spans ``fold``, the weight fold, and ``chain``, inside ``trunk``;
the stage folds once per set of weights, so after the warm-up request the
``fold`` span launches nothing). The int8 levers are bench.py's flags of
the same names, applied in its order after ``--bf16-params``:
``--int8-fc6`` builds the SGG head's fc6/fc7 as ``DenseInt8`` with
int8-stored weights (``quantize_dense_params``); ``--int8-trunk-scope
1:<tokens>`` stores the in-scope trunk convs in int8
(``quantize_trunk_params``) and sets ``I2VSGG_INT8_TRUNK``;
``--int8-static-acts`` gives them static activation scales from a
calibration file (``runs/calib/act_scales_res101.json``), or unit scales
with ``1``. The span ``int8`` covers every int8 conv and fc (activation
quantization, the int8 GEMM, the rescale), inside ``trunk``, ``det_head``
and ``sgg_head``. The passes:

1. plain: host clock per request, ending in a synchronize (as
   ``chip_smoke.py`` times it);
2. staged: each stage of the main path timed on the host clock between
   two synchronizes (stages nest: ``stem`` — conv1, FrozenBN, ReLU and the
   pool — lies inside ``trunk``, ``roi_pool`` and ``sgg_roi_align`` inside
   ``sgg_head``);
   the synchronizes remove the overlap of host and device, so the stages
   add up to more than a plain request;
3. profiled: ``torch.profiler`` over CPU and CUDA for the device's busy
   share, the kernel launches per request and the kernels that took the
   most device time. The profiler lengthens every launch, so its times
   are larger than the plain pass's.

Prints each pass and one JSON line with all the numbers. ``--trace``
also writes the profiled pass as a Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from i2vsgg_tpu_torch import serve  # noqa: E402
from i2vsgg_tpu_torch.config import Config, cfg_from_list  # noqa: E402
from i2vsgg_tpu_torch.models import backbones, faster_rcnn, sgg  # noqa: E402
from i2vsgg_tpu_torch.utils.params import (  # noqa: E402
    bf16_storage_cast, load_act_scales, quantize_dense_params,
    quantize_trunk_params)

STAGES = ("trunk", "stem", "fold", "chain", "rpn_head", "proposals",
          "roi_align", "det_head", "context", "decode", "sgg_head",
          "roi_pool", "sgg_roi_align", "int8")


STAGE_MS: dict = {}
SYNC_STAGES = [False]


def spanned(name, fn):
    """``fn`` inside a profiler span; in the staged pass also timed between
    two synchronizes into ``STAGE_MS``."""
    def wrapper(*a, **k):
        with record_function(name):
            if not SYNC_STAGES[0]:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            STAGE_MS[name] = (STAGE_MS.get(name, 0.0)
                              + 1e3 * (time.perf_counter() - t))
            return out
    return wrapper


def instrument(det, sgg_model):
    """Wrap each stage of the main path in a profiler span (this script
    only; the port itself carries no instrumentation)."""
    det.trunk.forward = spanned("trunk", det.trunk.forward)
    det.trunk._stem = spanned("stem", det.trunk._stem)
    backbones.ResNetStage.folded_tail = spanned(
        "fold", backbones.ResNetStage.folded_tail)
    backbones.bottleneck_chain = spanned("chain", backbones.bottleneck_chain)
    backbones.BNConv._int8_forward = spanned(
        "int8", backbones.BNConv._int8_forward)
    sgg.DenseInt8.forward = spanned("int8", sgg.DenseInt8.forward)
    det.rpn.forward = spanned("rpn_head", det.rpn.forward)
    det.proposals = spanned("proposals", det.proposals)
    det.head.forward = spanned("det_head", det.head.forward)
    faster_rcnn.roi_align_avg = spanned("roi_align",
                                        faster_rcnn.roi_align_avg)
    sgg.roi_pool = spanned("roi_pool", sgg.roi_pool)
    sgg.roi_align_avg = spanned("sgg_roi_align", sgg.roi_align_avg)
    det.netD_style.forward = spanned("context", det.netD_style.forward)
    det.netD_pixel.preconv = spanned("context", det.netD_pixel.preconv)
    det.netD_pixel.context_tail = spanned("context",
                                          det.netD_pixel.context_tail)
    serve.decode_detections = spanned("decode", serve.decode_detections)
    sgg_model.head_on_features = spanned("sgg_head",
                                         sgg_model.head_on_features)


def device_work(events):
    """The device's kernel and copy events, and each stage's spans as the
    profiler mirrors them on the device timeline (first to last kernel
    the stage launched)."""
    cuda = torch.autograd.DeviceType.CUDA
    work = [e for e in events if e.device_type == cuda and e.key not in STAGES]
    spans = {k: [(e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == cuda and e.key == k] for k in STAGES}
    return work, spans


def stage_kernels(work, spans, n):
    """Per stage: device events per request and their summed ms per
    request, for the events that start inside the stage's device spans."""
    out = {}
    for k, sp in spans.items():
        inside = [e for e in work
                  if any(s <= e.time_range.start < t for s, t in sp)]
        if sp:
            out[k] = {"kernels": len(inside) / n,
                      "kernel_ms": sum(e.time_range.elapsed_us()
                                       for e in inside) / 1e3 / n}
    return out


def busy_ms(work, t0_us, t1_us) -> float:
    """Union of the device's kernel and copy intervals inside [t0, t1], in
    ms."""
    iv = sorted((max(e.time_range.start, t0_us), min(e.time_range.end, t1_us))
                for e in work
                if e.time_range.end > t0_us and e.time_range.start < t1_us)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--trace", default="")
    ap.add_argument("--host-planes", action="store_true")
    ap.add_argument("--vrd-pooling", choices=("pool", "align"),
                    default="pool")
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--pallas-bottleneck", action="store_true")
    ap.add_argument("--int8-fc6", action="store_true")
    ap.add_argument("--int8-trunk-scope", default="",
                    help="e.g. 1:layer2,layer3,layer4,@3x3")
    ap.add_argument("--int8-static-acts", default="",
                    help="a calibration JSON, or 1 for unit scales")
    args = ap.parse_args()
    if args.pallas_bottleneck:
        os.environ["I2VSGG_PALLAS_BOTTLENECK"] = "1"
    if args.int8_trunk_scope:
        os.environ["I2VSGG_INT8_TRUNK"] = args.int8_trunk_scope
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    spec = chip_smoke.FULL
    cfg = cfg_from_list(["TEST.RPN_POST_NMS_TOP_N", "128",
                         "TEST.RPN_PRE_NMS_TOP_N", "512"], Config())
    det, sgg_model, prd = chip_smoke.build_models(
        spec, cfg, torch.Generator().manual_seed(3), pooling=args.vrd_pooling,
        int8_fc=args.int8_fc6)
    if args.bf16_params:
        bf16_storage_cast(det)
        bf16_storage_cast(sgg_model)
    if args.int8_fc6:
        quantize_dense_params(sgg_model)
    if args.int8_trunk_scope:
        acts = None
        if args.int8_static_acts:
            acts = (1.0 if args.int8_static_acts == "1"
                    else load_act_scales(args.int8_static_acts))
        quantize_trunk_params(det, args.int8_trunk_scope.partition(":")[2],
                              acts)
    instrument(det, sgg_model)
    program = serve.make_frame_program(
        det, sgg_model, prd, cfg, max_det=spec["max_det"],
        max_per_class=spec["max_per_class"], device=dev)
    reqs = [chip_smoke.make_inputs(spec, 10 + i)
            for i in range(args.requests + 1)]
    if args.host_planes:
        # packed inside each request, as a loader feeding the program would
        from i2vsgg_tpu_torch.ops.conv1 import Conv1Planes
        frame_program = program

        def program(images, im_info):
            return frame_program(Conv1Planes.pack(images), im_info)
    program(*reqs[0])                                   # warm-up
    torch.cuda.synchronize()
    n = args.requests

    plain = []
    for r in reqs[1:]:
        t = time.perf_counter()
        program(*r)
        torch.cuda.synchronize()
        plain.append(1e3 * (time.perf_counter() - t))

    SYNC_STAGES[0] = True
    t = time.perf_counter()
    for r in reqs[1:]:
        program(*r)
    staged_ms = 1e3 * (time.perf_counter() - t) / n
    SYNC_STAGES[0] = False
    stage = {k: STAGE_MS[k] / n for k in STAGES if k in STAGE_MS}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for r in reqs[1:]:
            program(*r)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    avg = prof.key_averages()
    events = prof.events()
    cpu_ranges = [e.time_range for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU]
    t0 = min(r.start for r in cpu_ranges)
    t1 = max(r.end for r in cpu_ranges)
    work, spans = device_work(events)
    busy = busy_ms(work, t0, t1)
    window = (t1 - t0) / 1e3
    per_stage = stage_kernels(work, spans, n)
    kernel_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3 / n
    kernels = sorted((e for e in avg if e.device_time_total > 0
                      and e.key not in STAGES),
                     key=lambda e: -e.self_device_time_total)[:12]
    card = chip_smoke.smi_name_power() or torch.cuda.get_device_name(0)
    print(f"card: {card}; {n} requests x {spec['frames']} frames; "
          f"host planes {args.host_planes}, SGG pooling {args.vrd_pooling}, "
          f"bf16 params {args.bf16_params}, chain {args.pallas_bottleneck}, "
          f"int8 fc {args.int8_fc6}, int8 trunk {args.int8_trunk_scope!r} "
          f"(static acts {args.int8_static_acts!r})")
    print(f"plain: {', '.join(f'{x:.2f}' for x in plain)} ms/request, mean "
          f"{sum(plain) / n:.2f}")
    print(f"staged: {staged_ms:.2f} ms/request with a synchronize around "
          "each stage; stage ms/request:")
    for k, v in stage.items():
        print(f"  {k:10s} {v:8.2f}")
    print(f"profiled: {wall_ms / n:.2f} ms/request with the profiler on")
    print(f"device busy {busy / n:.2f} ms/request of a {window / n:.2f} ms "
          f"window: busy share {busy / window:.3f}, idle "
          f"{1 - busy / window:.3f}; device events sum {kernel_ms:.2f} "
          "ms/request")
    for k, v in per_stage.items():
        print(f"  {k:10s} {v['kernels']:7.1f} device events/request, "
              f"{v['kernel_ms']:7.2f} ms/request")
    for e in kernels:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/request "
              f"{e.count // n:6d} calls  {e.key[:90]}")
    launches = sum(e.count for e in avg
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / n
    print(f"kernel launches per request: {launches:.0f}")
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps({"card": card, "requests": n,
                      "host_planes": args.host_planes,
                      "vrd_pooling": args.vrd_pooling,
                      "bf16_params": args.bf16_params,
                      "pallas_bottleneck": args.pallas_bottleneck,
                      "int8_fc6": args.int8_fc6,
                      "int8_trunk_scope": args.int8_trunk_scope,
                      "int8_static_acts": args.int8_static_acts,
                      "plain_ms_per_request": plain,
                      "staged_ms_per_request": staged_ms,
                      "profiled_ms_per_request": wall_ms / n,
                      "busy_ms_per_request": busy / n,
                      "busy_share": busy / window,
                      "device_event_ms_per_request": kernel_ms,
                      "stage_device": per_stage,
                      "launches_per_request": launches, "stages": stage,
                      "top_kernels": [[e.key, e.self_device_time_total
                                       / 1e3 / n, e.count // n]
                                      for e in kernels]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
