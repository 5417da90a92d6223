"""Video serving: the fused det+SGG frame program over a frame stream, then
association — the port's counterpart of the JAX package's
``tools/serve_video.py``, with the same flags and outputs.

Every frame batch of the loader runs one frame program
(``serve.make_frame_program``: backbone, proposals, per-class NMS, top-K
detections, all-pair predicate scoring, on the device), or with
``--buckets`` the detection-count-bucketed form
(``serve.make_bucketed_program``); only the per-frame relation tuples
come back to the host, where Stage C associates them into video relations.
Writes ``<save_dir>/serve/<imdbval_name>/{frame_detections,
video_relations}.json``.

The levers of the JAX driver: ``--bf16_weights`` (bf16 weight storage),
``--host_planes`` (conv1 parity planes packed on the host,
``Conv1Planes.pack``; the conv1 kernel reads them), ``--uint8_upload``
(uint8 frames, dequantized on the device), ``--int8_fc6`` (the SGG head's
fc6/fc7 in int8, quantized at load) and ``--int8_trunk mxu:<scope>
--act_scales <file>`` (the scoped int8 trunk with static activation
scales; ``sim:<scope>``, its fake-quant twin). ``--mesh N`` serves over N
local devices in one process, as the JAX driver does: the models
replicated once onto ``make_mesh(N)``, each batch's frames split over them
(``serve.make_sharded_program``; ``--bs`` a multiple of N, a ragged tail
padded and its padded rows dropped).

Usage:
  python -m i2vsgg_tpu_torch.tools.serve_video --dataset MVidVRD \\
      --net res101 --ic --gc --load_name <det ckpt_dir>/<step> \\
      --sgg_load_name <sgg ckpt_dir>/<step> [--bs 8] [--buckets 4,8,16] \\
      [--mesh 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def extra_parser() -> argparse.ArgumentParser:
    """The flags this driver adds to ``cli/args.py``'s."""
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--sgg_load_name", default="",
                       help="the SGG checkpoint (<ckpt_dir>/<step>); the "
                            "detector's goes in --load_name")
    extra.add_argument("--max_det", default=16, type=int)
    extra.add_argument("--mesh", default=0, type=int,
                       help="serve over this many local devices (0: one): "
                            "the models replicated onto each, every batch's "
                            "frames split over them; --bs must be a "
                            "multiple")
    extra.add_argument("--buckets", default="",
                       help="comma-separated detection-count buckets "
                            "(e.g. '4,8,16', increasing, the last "
                            "--max_det): per batch, the SGG head runs on the "
                            "smallest bucket that holds the batch's largest "
                            "count of detections (serve.make_bucketed_"
                            "program). Default: one program at --max_det")
    extra.add_argument("--bf16_weights", action="store_true",
                       help="store serving weights in bf16 (FrozenBatchNorm "
                            "statistics and bbox_pred stay f32; "
                            "utils/params.py::bf16_storage_cast)")
    extra.add_argument("--host_planes", action="store_true",
                       help="pack conv1 parity planes on the host (bf16) "
                            "and feed them to the conv1 kernel; exclusive "
                            "with --uint8_upload")
    return extra


def build_serving_models(args, ns, cfg, imdb):
    """The detector and the SGG head as the driver serves them: seeded
    init, the checkpoints restored over it, then the storage levers in the
    JAX driver's order (bf16, the static-scale int8 trunk; bf16, the int8
    fc6/fc7)."""
    from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
    from i2vsgg_tpu_torch.models.layers import init_weights, torch_dtype
    from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
    from i2vsgg_tpu_torch.tools.common import (apply_act_scales, ckpt_of,
                                               vrd_pooling_of)
    from i2vsgg_tpu_torch.train.checkpoint import restore_intersection
    from i2vsgg_tpu_torch.utils.params import (bf16_storage_cast,
                                               quantize_dense_params)

    det = FasterRCNN_DA(num_classes=len(imdb.classes), cfg=cfg,
                        backbone=args.net,
                        class_agnostic=args.class_agnostic,
                        ic=args.ic, gc=args.gc)
    init_weights(det, torch.Generator().manual_seed(0))
    ckpt = ckpt_of(args.load_name)
    if ckpt is not None:
        restore_intersection(*ckpt, det)
        print(f"detector: {args.load_name}")
    if ns.bf16_weights:
        bf16_storage_cast(det)
    apply_act_scales(det, args)

    # the head pools as its weights were trained (metadata of the SGG
    # checkpoint, like the reference's in-checkpoint pooling_mode)
    vrd_pooling = vrd_pooling_of(ns.sgg_load_name, args.vrd_pooling)
    sgg = SGGModel(VRDHead(emb_dim=args.emb_dim,
                           spatial_type=args.spatial_type,
                           use_obj_visual=args.use_obj_visual,
                           fc_dim=args.vrd_fc_dim,
                           dtype=torch_dtype(cfg.COMPUTE_DTYPE),
                           pooling=vrd_pooling, int8_fc=args.int8_fc6))
    init_weights(sgg, torch.Generator().manual_seed(1))
    ckpt = ckpt_of(ns.sgg_load_name or "")
    if ckpt is not None:
        restore_intersection(*ckpt, sgg)
        print(f"sgg head: {ns.sgg_load_name}")
    if ns.bf16_weights:
        bf16_storage_cast(sgg)
    if args.int8_fc6:
        # the fc-tower weight quantization hoisted to load time
        quantize_dense_params(sgg)
    return det, sgg


def main(argv=None):
    from i2vsgg_tpu_torch import serve
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.data.pipeline import (DetectionLoader,
                                                dequantize_image_u8)
    from i2vsgg_tpu_torch.data.roidb import combined_roidb
    from i2vsgg_tpu_torch.models.glove import load_predicate_vectors
    from i2vsgg_tpu_torch.ops.conv1 import Conv1Planes
    from i2vsgg_tpu_torch.parallel.mesh import make_mesh, replicate
    from i2vsgg_tpu_torch.tools.common import config_from_args
    from i2vsgg_tpu_torch.tools.test_sgg import frame_key
    from i2vsgg_tpu_torch.utils.device import resolve_device
    from i2vsgg_tpu_torch.video.association import association

    ns, rest = extra_parser().parse_known_args(argv)
    args = set_dataset_args(parse_args(rest), test=True)
    if ns.mesh and args.batch_size % ns.mesh:
        raise ValueError(f"--bs {args.batch_size} must be a multiple of "
                         f"--mesh {ns.mesh}")
    if ns.host_planes and args.uint8_upload:
        raise ValueError("--host_planes and --uint8_upload are exclusive "
                         "(the planes ship bf16)")
    dev = resolve_device(args.device)
    cfg = config_from_args(args)

    imdb, roidb, _, idx = combined_roidb(args.imdbval_name, training=False,
                                         use_flipped=False)
    print(f"{len(roidb)} frames ({args.imdbval_name})")
    loader = DetectionLoader(roidb, idx, cfg, args.batch_size, training=False,
                             uint8_transport=args.uint8_upload)
    print(f"loader: {loader.path}")
    prd_np = load_predicate_vectors(args)
    n_rel = prd_np.shape[0]
    md = ns.max_det
    det, sgg = build_serving_models(args, ns, cfg, imdb)

    def program_on(det, sgg, dev):
        if ns.buckets:
            program = serve.make_bucketed_program(
                det, sgg, prd_np, cfg, max_det=md, device=dev,
                buckets=tuple(int(b) for b in ns.buckets.split(",")))
        else:
            program = serve.make_frame_program(det, sgg, prd_np, cfg,
                                               max_det=md, device=dev)
        if not args.uint8_upload:
            return program

        # frames ship as resized uint8 BGR; the mean subtraction and the
        # re-zeroed padding run on the device
        def dequantized(image_u8, im_info):
            info = torch.as_tensor(im_info, device=dev)
            return dequantize_image_u8(torch.as_tensor(image_u8, device=dev),
                                       info, cfg.PIXEL_MEANS), info
        return serve.with_input(program, dequantized)

    if ns.mesh:
        mesh = make_mesh(ns.mesh, dev)
        program = serve.make_sharded_program(
            [program_on(d, s, m) for (d, s), m in
             zip(replicate((det, sgg), mesh), mesh)], mesh)
        print(f"serving over a {ns.mesh}-device mesh "
              f"({', '.join(str(m) for m in mesh)}): data-parallel frame "
              f"batches of {args.batch_size}", flush=True)
    else:
        program = program_on(det, sgg, dev)
    img_key = "image_u8" if args.uint8_upload else "image"

    frame_detections = {}
    t0 = time.time()
    done = 0
    for batch in loader:
        imgs = batch[img_key]
        if ns.host_planes:
            imgs = Conv1Planes.pack(imgs)
        out = {k: v.cpu() if torch.is_tensor(v) else v
               for k, v in program(imgs, batch["im_info"]).items()}
        for bi, ridx in enumerate(batch["indices"]):
            index = os.path.splitext(os.path.basename(
                roidb[int(ridx)]["image"]))[0]
            vid, fno = frame_key(index, None)
            frame_detections.setdefault(vid, []).append(
                [fno, serve.frame_relation_tuples(out, bi)])
            done += 1
        if done % 200 < args.batch_size:
            print(f"  {done} frames ({done / (time.time() - t0):.1f} fps)")

    fps = done / (time.time() - t0)
    out_dir = os.path.join(args.save_dir, "serve", args.imdbval_name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "frame_detections.json"), "w") as f:
        json.dump(frame_detections, f)
    video_relations = association(frame_detections,
                                  objects=list(imdb.classes),
                                  predicates=[str(i) for i in range(n_rel)])
    with open(os.path.join(out_dir, "video_relations.json"), "w") as f:
        json.dump(video_relations, f)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"{done} frames -> {sum(len(v) for v in video_relations.values())} "
          f"video relations at {fps:.1f} fps (end-to-end incl. host) on "
          f"{where}")
    return video_relations


if __name__ == "__main__":
    main(sys.argv[1:])
