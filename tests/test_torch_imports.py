"""Import hygiene of the port: ``i2vsgg_tpu_torch`` and ``chip_smoke.py``
import torch, numpy and the standard library only — no JAX, flax, optax,
PyYAML, ninja, cv2, PIL, ml_dtypes, and nothing of the JAX package
``i2vsgg_tpu`` (a machine with the card has none of them). Each case runs in
a fresh interpreter with a ``sys.meta_path`` finder that refuses those
names."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLOCKER = textwrap.dedent("""
    import importlib.abc
    import sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "yaml", "ninja",
               "cv2", "PIL", "ml_dtypes", "i2vsgg_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            # exact top-level match: i2vsgg_tpu_torch is not i2vsgg_tpu
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    for mod in list(sys.modules):
        if mod.split(".")[0] in BLOCKED:
            del sys.modules[mod]
    sys.meta_path.insert(0, Refuse())
""")


def run_isolated(body: str):
    code = BLOCKER + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_port_imports_nothing_of_jax_yaml_or_the_jax_package():
    out = run_isolated("""
        import importlib
        import pkgutil

        import numpy as np
        import torch

        for blocked in ("yaml", "cv2", "PIL", "ml_dtypes"):
            try:
                importlib.import_module(blocked)
            except ImportError:
                pass
            else:
                raise SystemExit(f"the blocker let {blocked} through")

        import i2vsgg_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            i2vsgg_tpu_torch.__path__, "i2vsgg_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        from i2vsgg_tpu_torch import serve
        from i2vsgg_tpu_torch.config import Config, cfg_from_list
        from i2vsgg_tpu_torch.ops import bottleneck
        from i2vsgg_tpu_torch.utils import params
        assert "i2vsgg_tpu_torch.ops.bottleneck" in names
        assert "i2vsgg_tpu_torch.utils.params" in names
        assert "i2vsgg_tpu_torch.ops.int8" in names
        assert "i2vsgg_tpu_torch.ops.conv1_int8" in names

        cfg = cfg_from_list(["TEST.RPN_PRE_NMS_TOP_N", "100",
                             "TEST.RPN_POST_NMS_TOP_N", "16",
                             "COMPUTE_DTYPE", "float32"], Config())
        assert cfg.TEST.RPN_PRE_NMS_TOP_N == 100
        det, sgg, prd = chip_smoke.build_models(
            chip_smoke.SMALL, cfg, torch.Generator().manual_seed(0))
        program = serve.make_frame_program(det, sgg, prd, cfg, max_det=4,
                                           max_per_class=4, device="cpu")
        images, im_info = chip_smoke.make_inputs(chip_smoke.SMALL, 0)
        out = program(images, im_info)
        assert tuple(out["rel_prob"].shape) == (2, 12, 5)
        assert torch.isfinite(out["rel_prob"]).all()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("modules", len(names))
    """)
    assert "modules" in out


def test_roi_pool_cpu_path_and_missing_card():
    """The RoIPool wrapper takes the plain version for CPU tensors without
    counting a launch; the entry point raises cleanly with no card."""
    run_isolated("""
        import numpy as np
        import torch

        torch.cuda.is_available = lambda: False   # no card, whatever the host

        from i2vsgg_tpu_torch import serve
        from i2vsgg_tpu_torch.config import Config
        from i2vsgg_tpu_torch.ops.roi_pool import roi_pool, roi_pool_plain
        import chip_smoke

        feat = torch.randn(1, 8, 10, 16)
        rois = torch.tensor([[0, 0.0, 0.0, 60.0, 50.0],
                             [0, 300.0, 300.0, 400.0, 400.0]])
        before = roi_pool.launches
        out = roi_pool(feat, rois)
        assert roi_pool.launches == before == 0
        assert torch.equal(out, roi_pool_plain(feat, rois))

        cfg = Config().replace(COMPUTE_DTYPE="float32")
        det, sgg, prd = chip_smoke.build_models(
            chip_smoke.SMALL, cfg, torch.Generator().manual_seed(0))
        try:
            serve.make_frame_program(det, sgg, prd, cfg, max_det=4,
                                     max_per_class=4)
        except RuntimeError as e:
            assert "cuda" in str(e)
        else:
            raise SystemExit("make_frame_program ran without a card")
        assert chip_smoke.main() != 0          # no result without a card
    """)


def test_slice_two_paths_run_without_the_blocked_names():
    """Host planes, the bucketed program, the uint8 dequantize and Stage C,
    end to end on the CPU in the blocked interpreter; the kernels' wrappers
    count no launch there."""
    run_isolated("""
        import numpy as np
        import torch

        import chip_smoke
        from i2vsgg_tpu_torch import serve
        from i2vsgg_tpu_torch.config import Config
        from i2vsgg_tpu_torch.data.pipeline import dequantize_image_u8
        from i2vsgg_tpu_torch.ops import conv1
        from i2vsgg_tpu_torch.ops.conv1 import Conv1Planes
        from i2vsgg_tpu_torch.ops.roi_align import roi_align_avg
        from i2vsgg_tpu_torch.video.association import association

        cfg = Config().replace(
            TEST=Config().TEST.__class__(RPN_PRE_NMS_TOP_N=100,
                                         RPN_POST_NMS_TOP_N=16),
            COMPUTE_DTYPE="float32")
        spec = chip_smoke.SMALL
        det, sgg, prd = chip_smoke.build_models(
            spec, cfg, torch.Generator().manual_seed(0), pooling="align")
        video = chip_smoke.synthetic_video(spec, 0, n_frames=4)
        u8, f32, info = video[0]
        x = dequantize_image_u8(torch.from_numpy(u8), torch.from_numpy(info),
                                cfg.PIXEL_MEANS)
        assert torch.equal(x, torch.from_numpy(f32))
        program = serve.make_bucketed_program(
            det, sgg, prd, cfg, buckets=(2, 4), max_det=4, max_per_class=4,
            device="cpu")
        frames = []
        for i, (_, f32, info) in enumerate(video):
            out = program(Conv1Planes.pack(f32), info)
            for f in range(f32.shape[0]):
                frames.append([i * f32.shape[0] + f,
                               serve.frame_relation_tuples(out, f)])
        assert out["bucket"] in (2, 4)
        assert isinstance(association({"v": frames}), dict)
        assert conv1.launches == 0 and roi_align_avg.launches == 0
    """)


def test_slice_three_path_runs_without_the_blocked_names():
    """bf16-stored weights and the chain switch, end to end on the CPU in
    the blocked interpreter (res50: layer2 and layer3 tails fused); the
    chain's wrapper counts no launch there."""
    run_isolated("""
        import os

        import torch

        import chip_smoke
        from i2vsgg_tpu_torch import serve
        from i2vsgg_tpu_torch.config import Config
        from i2vsgg_tpu_torch.models import backbones
        from i2vsgg_tpu_torch.ops import bottleneck
        from i2vsgg_tpu_torch.ops.conv1 import Conv1Planes
        from i2vsgg_tpu_torch.utils.params import bf16_storage_cast

        cfg = Config().replace(
            TEST=Config().TEST.__class__(RPN_PRE_NMS_TOP_N=100,
                                         RPN_POST_NMS_TOP_N=16),
            COMPUTE_DTYPE="bfloat16")
        spec = chip_smoke.SMALL50
        det, sgg, prd = chip_smoke.build_models(
            spec, cfg, torch.Generator().manual_seed(0), pooling="align")
        bf16_storage_cast(det)
        bf16_storage_cast(sgg)
        assert det.trunk.layer3.block1.conv2.weight.dtype == torch.bfloat16
        assert det.bbox_pred.weight.dtype == torch.float32
        calls = []
        real = bottleneck.bottleneck_chain

        def counting(*a):
            calls.append(tuple(a[0].shape))
            return real(*a)

        backbones.bottleneck_chain = counting
        os.environ["I2VSGG_PALLAS_BOTTLENECK"] = "1"
        program = serve.make_frame_program(det, sgg, prd, cfg, max_det=4,
                                           max_per_class=4, device="cpu")
        _, f32, info = chip_smoke.synthetic_video(spec, 0, n_frames=2)[0]
        out = program(Conv1Planes.pack(f32), info)
        assert calls == [(2, 8, 10, 512), (2, 4, 5, 1024)], calls
        assert chip_smoke.fused_tail_blocks(det.trunk, 64, 80) == 8
        assert torch.isfinite(out["rel_prob"]).all()
        assert real.launches == 0
    """)


def test_slice_four_path_runs_without_the_blocked_names():
    """The round-5 int8 levers (bf16 storage, int8 fc6/fc7, the scoped int8
    trunk with the calibration file's static scales, read with json) end to
    end on the CPU in the blocked interpreter (res50), and the plain int8
    conv1; no kernel launch and no int8 GEMM on the card is counted
    there."""
    run_isolated("""
        import os

        import torch

        import chip_smoke
        from i2vsgg_tpu_torch import serve
        from i2vsgg_tpu_torch.config import Config
        from i2vsgg_tpu_torch.ops import conv1_int8, int8
        from i2vsgg_tpu_torch.utils.params import (
            bf16_storage_cast, load_act_scales, quantize_dense_params,
            quantize_trunk_params)

        cfg = Config().replace(
            TEST=Config().TEST.__class__(RPN_PRE_NMS_TOP_N=100,
                                         RPN_POST_NMS_TOP_N=16),
            COMPUTE_DTYPE="bfloat16")
        spec = chip_smoke.SMALL50
        det, sgg, prd = chip_smoke.build_models(
            spec, cfg, torch.Generator().manual_seed(0), pooling="align",
            int8_fc=True)
        bf16_storage_cast(det)
        bf16_storage_cast(sgg)
        quantize_dense_params(sgg)
        quantize_trunk_params(det, chip_smoke.INT8_SCOPE,
                              load_act_scales(chip_smoke.ACT_SCALES))
        assert len(chip_smoke.int8_modules(det)) == 13
        assert det.head.layer4.block0.conv2.act_scale.shape == ()
        os.environ["I2VSGG_INT8_TRUNK"] = "1:" + chip_smoke.INT8_SCOPE
        program = serve.make_frame_program(det, sgg, prd, cfg, max_det=4,
                                           max_per_class=4, device="cpu")
        _, f32, info = chip_smoke.synthetic_video(spec, 0, n_frames=2)[0]
        out = program(f32, info)
        assert torch.isfinite(out["rel_prob"]).all()
        x = torch.as_tensor(f32)
        y = conv1_int8.conv1_bn_relu_int8(x, det.trunk.conv1.weight,
                                          *det.trunk.bn1.affine())
        assert tuple(y.shape) == (2, 32, 40, 64)
        assert conv1_int8.launches == 0
        assert int8.int8_conv2d.calls == 0 and int8.int8_linear.calls == 0
    """)


def test_slice_eight_paths_run_without_the_blocked_names():
    """Phase 12's two configurations at chip_smoke.py's small size, end to
    end on the CPU in the blocked interpreter: VGG16 (class-agnostic, the
    SGG head on RoIPool over 512 channels) and ResNet under
    POOLING_MODE=pool (the head under align, spatial_type 0, no object
    visual branch), through the frame and bucketed programs, with
    relative_loc and a spatial_type=1 head fed it; no RoI launch counted
    there."""
    run_isolated("""
        import torch

        import chip_smoke
        from i2vsgg_tpu_torch import serve
        from i2vsgg_tpu_torch.config import Config
        from i2vsgg_tpu_torch.models.layers import init_weights
        from i2vsgg_tpu_torch.models.sgg import VRDHead
        from i2vsgg_tpu_torch.ops.boxes import relative_loc
        from i2vsgg_tpu_torch.ops.roi_align import roi_align_avg
        from i2vsgg_tpu_torch.ops.roi_pool import roi_pool

        cfg = Config().replace(
            TEST=Config().TEST.__class__(RPN_PRE_NMS_TOP_N=100,
                                         RPN_POST_NMS_TOP_N=16),
            COMPUTE_DTYPE="float32")
        spec = chip_smoke.SMALL
        _, f32, info = chip_smoke.synthetic_video(spec, 0, n_frames=2)[0]
        for backbone, cfg_v, extra in (
                ("vgg16", cfg, dict(class_agnostic=True,
                                    vrd=dict(in_channels=512))),
                ("res10", cfg.replace(POOLING_MODE="pool"),
                 dict(pooling="align", vrd=dict(spatial_type=0,
                                                use_obj_visual=False)))):
            det, sgg, prd = chip_smoke.build_models(
                dict(spec, backbone=backbone), cfg_v,
                torch.Generator().manual_seed(0), **extra)
            assert not det.fused
            for make, kw in ((serve.make_frame_program, {}),
                             (serve.make_bucketed_program,
                              dict(buckets=(2, 4)))):
                out = make(det, sgg, prd, cfg_v, max_det=4, max_per_class=4,
                           device="cpu", **kw)(f32, info)
                chip_smoke.check_outputs(out, spec)
        boxes = torch.tensor([[10.0, 20.0, 30.0, 60.0],
                              [20.0, 10.0, 60.0, 30.0]])
        loc = relative_loc(boxes[[0, 1]], boxes[[1, 0]])
        head = init_weights(VRDHead(emb_dim=16, fc_dim=32, in_channels=512,
                                    spatial_type=1),
                            torch.Generator().manual_seed(1))
        rois = torch.cat([torch.zeros(2, 1), boxes], 1)
        with torch.no_grad():
            res = head(torch.randn(1, 4, 5, 512), rois, rois,
                       torch.tensor([0, 1]), torch.tensor([1, 0]),
                       torch.randn(5, 300), spatial_fea=loc)
        assert tuple(res["scores"].shape) == (2, 5)
        assert roi_pool.launches == 0 and roi_align_avg.launches == 0
    """)
