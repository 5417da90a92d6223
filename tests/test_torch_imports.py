"""Import hygiene of the port: ``i2vsgg_tpu_torch`` and ``chip_smoke.py``
import torch, numpy and the standard library only — no JAX, flax, optax,
orbax, PyYAML, ninja, cv2, PIL, ml_dtypes, tensorboard, and nothing of the
JAX package
``i2vsgg_tpu``, of the JAX drivers (the top-level ``tools``) or of the
top-level ``tests``, whose generators the port's gate tools copy (a
machine with the card has none of them). Each case runs in
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

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "ninja",
               "cv2", "PIL", "ml_dtypes", "tensorboard", "i2vsgg_tpu",
               "tools", "tests"}

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

        for blocked in ("yaml", "cv2", "PIL", "ml_dtypes", "orbax", "jax",
                        "flax", "optax", "tensorboard"):
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
        for name in ("utils.torch_import", "train.checkpoint", "cli.args",
                     "data.dataset_config", "data.voc", "data.factory",
                     "data.roidb", "data.image_io", "data.pipeline",
                     "models.glove", "eval.voc_eval", "tools.serve_video",
                     "tools.test_sgg", "tools.test_det", "tools.common",
                     "models.targets", "models.inits", "train.optim",
                     "train.det_da", "utils.logging",
                     "tools.trainval_det_da", "train.sgg",
                     "tools.trainval_sgg", "data.jpeg", "utils.cuda_build",
                     "parallel", "parallel.mesh", "runtime",
                     "tools.calibrate_act_scales", "tools.quant_trunk_ab",
                     "tools.learnable_data", "tools.parity_run",
                     "tools.train_gate_arm", "tools.capacity_ab",
                     "tools.quant_ab", "tools.stage_c_hard",
                     "tools.stage_b_rescore", "utils.vis"):
            assert "i2vsgg_tpu_torch." + name in names, name
        from i2vsgg_tpu_torch.tools import calibrate_act_scales
        from i2vsgg_tpu_torch.tools import quant_trunk_ab
        assert calibrate_act_scales.parse_args(
            ["--ckpt", "c/1"]).device == "cuda"
        assert quant_trunk_ab.parse_args(["--ckpt", "c/1"]).mode == "sim"
        # the gate tools: the card by default, and outputs beside, never
        # over, the JAX tools' committed files
        from i2vsgg_tpu_torch.tools import (capacity_ab, learnable_data,
                                            parity_run, quant_ab,
                                            train_gate_arm)
        for tool in (train_gate_arm, capacity_ab, quant_ab):
            assert tool.parse_args([]).device == "cuda"
        assert capacity_ab.parse_args([]).out == "runs/torch_capacity_ab"
        assert (quant_ab.parse_args([]).json
                == "runs/torch_quant_ab/quant_ab.json")
        assert parity_run.HP["depth"] == 50
        assert len(learnable_data.LEARNABLE_CLASSES) == 8

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


def test_last_modules_without_the_blocked_names(tmp_path):
    """``tools/stage_c_hard.py``, ``tools/stage_b_rescore.py`` and
    ``utils/vis.py`` with cv2, PIL, jax and yaml refused, as the card's
    machine runs them: the tools default to the card and refuse the
    reference arm; ``save_vis`` draws and writes a PNG that the port's
    decoder reads back as the drawing."""
    out = run_isolated(f"""
        import numpy as np

        from i2vsgg_tpu_torch.data import image_io
        from i2vsgg_tpu_torch.tools import stage_b_rescore, stage_c_hard
        from i2vsgg_tpu_torch.utils import vis

        for tool, argv in ((stage_c_hard, ["--ours_ckpt", "c/1"]),
                           (stage_b_rescore, [])):
            args = tool.parse_args(argv)
            assert args.device == "cuda" and args.arms == "ours", args
            try:
                tool.main(argv + ["--arms", "ref", "--device", "cpu"])
            except ValueError as e:
                assert "/root/reference" in str(e)
            else:
                raise SystemExit("the reference arm ran")
        im = np.zeros((24, 40, 3), np.uint8)
        dets = [None, np.asarray([[2.5, 14.0, 30.2, 22.9, 0.9],
                                  [1, 1, 3, 3, 0.1]], np.float32)]
        path = "{tmp_path}/vis.png"
        vis.save_vis(im, dets, ["bg", "cat"], path)
        got = image_io.imread_bgr(path)
        want = vis.vis_detections(im, "cat", dets[1], 0.5)[..., ::-1]
        assert np.array_equal(got, want)
        assert (got[14, 2:31] == (0, 0, 204)).all()     # the top edge
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("drawn", int((got != 0).any(-1).sum()))
    """)
    assert "drawn" in out


def test_mesh_without_a_launcher_or_a_card():
    """``parallel/mesh.py`` in a fresh interpreter: without a launcher's
    variables (or with the JAX package's for one process) it joins no
    group and every collective is the identity; a CUDA mesh or a CUDA
    process group without a card raises."""
    run_isolated("""
        import os
        import torch

        torch.cuda.is_available = lambda: False   # no card, whatever the host
        for k in ("WORLD_SIZE", "RANK", "I2VSGG_COORD",
                  "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"):
            os.environ.pop(k, None)
        from i2vsgg_tpu_torch.parallel import mesh
        assert not mesh.maybe_init_distributed("cpu")
        os.environ.update(I2VSGG_COORD="127.0.0.1:1", JAX_NUM_PROCESSES="1")
        assert not mesh.maybe_init_distributed("cpu")
        assert mesh.process_count() == 1 and mesh.process_index() == 0
        t = torch.arange(3.0)
        assert torch.equal(mesh.global_sum(t), t)
        mesh.sync_global_devices("x")
        assert mesh.host_shard([1, 2, 3], 2) == [1, 2, 3]
        for call in (lambda: mesh.make_mesh(2, "cuda"),
                     lambda: mesh.maybe_init_distributed("cuda")):
            os.environ.update(WORLD_SIZE="1", RANK="0")
            try:
                call()
            except RuntimeError as e:
                assert "cuda" in str(e), e
            else:
                raise SystemExit("no card, and no error")
    """)


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

        # the drivers default to the card, and raise without one
        from i2vsgg_tpu_torch.tools import (serve_video, test_det, test_sgg,
                                            trainval_det_da, trainval_sgg)
        for main in (serve_video.main, test_sgg.main, test_det.main,
                     trainval_det_da.main, trainval_sgg.main):
            try:
                main(["--dataset", "MVidVRD", "--net", "res10"])
            except RuntimeError as e:
                assert "cuda" in str(e), e
            else:
                raise SystemExit(f"{main.__module__} ran without a card")
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


def test_drivers_run_as_modules_without_the_blocked_names(tmp_path):
    """``python -m i2vsgg_tpu_torch.tools.{serve_video,test_sgg,test_det}``
    with ``--device cpu`` on a small devkit that ``chip_smoke.write_devkit``
    writes (PNG frames, no image library), from checkpoints in the port's
    format, at chip_smoke's tiny driver configuration, in the blocked
    interpreter."""
    out = run_isolated(f"""
        import json
        import os
        import runpy
        import sys

        import torch

        import chip_smoke
        from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
        from i2vsgg_tpu_torch.tools.common import config_from_args
        from i2vsgg_tpu_torch.train.checkpoint import save_checkpoint

        root = {str(tmp_path)!r}
        os.environ["I2VSGG_DATA_ROOT"] = os.path.join(root, "data")
        chip_smoke.DEVKIT.update(height=72, width=128)
        paths = chip_smoke.write_devkit(os.environ["I2VSGG_DATA_ROOT"])
        args = set_dataset_args(parse_args(chip_smoke.DRIVER_TINY),
                                test=True)
        cfg = config_from_args(args)
        spec = dict(chip_smoke.SMALL, num_classes=16, num_rel=26,
                    fc_dim=128, emb_dim=300)
        det, sgg, _ = chip_smoke.build_models(
            spec, cfg, torch.Generator().manual_seed(0))
        ck = os.path.join(root, "ckpt")
        save_checkpoint(os.path.join(ck, "det"), det.state_dict(), 1,
                        {{"pooling_mode": "align"}})
        sd = {{"trunk." + k: v for k, v in det.trunk.state_dict().items()}}
        sd.update(sgg.state_dict())
        save_checkpoint(os.path.join(ck, "sgg"), sd, 1,
                        {{"vrd_pooling": "align"}})
        common = chip_smoke.DRIVER_TINY + ["--device", "cpu", "--save_dir",
                                           os.path.join(root, "out")]
        runs = {{
            "serve_video": ["--load_name", os.path.join(ck, "det", "1"),
                            "--sgg_load_name", os.path.join(ck, "sgg", "1"),
                            "--max_det", "4", "--uint8_upload"],
            "test_sgg": ["--load_name", os.path.join(ck, "sgg", "1"),
                         "--video_ann", paths["video_ann"]],
            "test_det": ["--load_name", os.path.join(ck, "det", "1")],
        }}
        for name, extra in runs.items():
            sys.argv = [name] + common + extra
            runpy.run_module("i2vsgg_tpu_torch.tools." + name,
                             run_name="__main__")
        for rel in ("serve/MVidVRD_test/frame_detections.json",
                    "serve/MVidVRD_test/video_relations.json",
                    "eval/MVidVRD_test_SGG/frame_detections.json",
                    "eval/MVidVRD_test/adapt/det_test_person.txt"):
            assert os.path.exists(os.path.join(root, "out", rel)), rel
        frames = json.load(open(os.path.join(
            root, "out", "serve/MVidVRD_test/frame_detections.json")))
        assert sorted(frames) == ["vid00", "vid01"]
        assert all(len(v) == 6 for v in frames.values())
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("drivers ran")
    """)
    assert "drivers ran" in out


def test_training_driver_help_and_logger_without_the_blocked_names(tmp_path):
    """``python -m i2vsgg_tpu_torch.tools.trainval_det_da --help`` in the
    blocked interpreter, and the metrics logger there: JSONL only, since
    ``torch.utils.tensorboard`` cannot import tensorboard."""
    out = run_isolated(f"""
        import json
        import os
        import runpy
        import sys

        from i2vsgg_tpu_torch.utils.logging import MetricsLogger

        log = MetricsLogger({str(tmp_path)!r}, use_tensorboard=True)
        assert log._tb is None
        log.log_scalars("train", {{"loss": 1.5}}, 3)
        log.close()
        rec = json.loads(open(os.path.join({str(tmp_path)!r},
                                           "metrics.jsonl")).read())
        assert rec["loss"] == 1.5 and rec["step"] == 3
        sys.argv = ["trainval_det_da", "--help"]
        try:
            runpy.run_module("i2vsgg_tpu_torch.tools.trainval_det_da",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in BLOCKED)
        assert not bad, bad
    """)
    assert "--pretrained_backbone" in out and "--max_steps" in out


def test_stage_b_step_and_driver_help_without_the_blocked_names():
    """Stage B in the blocked interpreter: two steps of ``train/sgg.py`` on
    a tiny res10 model on the CPU, dropout on (masks from the step's
    generator), only the head moving; and ``python -m
    i2vsgg_tpu_torch.tools.trainval_sgg --help``."""
    out = run_isolated("""
        import runpy
        import sys

        import numpy as np
        import torch

        from i2vsgg_tpu_torch.config import Config
        from i2vsgg_tpu_torch.models.backbones import ResNetTrunk
        from i2vsgg_tpu_torch.models.inits import init_module
        from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
        from i2vsgg_tpu_torch.train import sgg
        from i2vsgg_tpu_torch.train.det_da import TrainState

        model = init_module(
            SGGModel(VRDHead(emb_dim=16, fc_dim=32),
                     trunk=ResNetTrunk(depth=10, dtype=torch.float32)),
            torch.Generator().manual_seed(0))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        g = 4
        rs = np.random.RandomState(0)
        xy = rs.uniform(0, 30, (1, g, 2))
        boxes = np.concatenate([xy, xy + rs.uniform(8, 30, (1, g, 2))], -1)
        ix1, ix2, labels, valid = sgg.build_pair_batch(
            [(0, 1, 1), (1, 2, 0), (2, 0, 3)], g, 6, 5)
        batch = {"image": torch.randn(1, 64, 80, 3) * 10,
                 "im_info": torch.tensor([[64.0, 80.0, 1.0]]),
                 "obj_boxes": torch.as_tensor(boxes, dtype=torch.float32),
                 "ix1": torch.as_tensor(ix1[None]).long(),
                 "ix2": torch.as_tensor(ix2[None]).long(),
                 "pair_valid": torch.as_tensor(valid[None]),
                 "rel_labels": torch.as_tensor(labels[None])}
        state = TrainState(model, sgg.sgg_optimizer(model, 1e-2, Config()))
        prd = torch.randn(5, 300)
        for _ in range(2):
            m = sgg.train_step(state, batch, prd)
            assert np.isfinite(float(m["loss"])) and int(m["n_pairs"]) == 3
        after = model.state_dict()
        for k, v in after.items():
            assert torch.equal(v, before[k]) == k.startswith("trunk."), k
        sys.argv = ["trainval_sgg", "--help"]
        try:
            runpy.run_module("i2vsgg_tpu_torch.tools.trainval_sgg",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in BLOCKED)
        assert not bad, bad
    """)
    assert "--source_gt_rels_path" in out and "--decay_spe" in out


def test_jpeg_decoder_builds_and_decodes_without_the_blocked_names():
    """``data/jpeg.py`` and ``utils/cuda_build.py`` load with cv2, PIL, jax
    and yaml refused; the decoder builds with the host compiler and holds
    every committed fixture to its golden (read by the port's PNG decoder),
    refusing the refused ones, as ``chip_smoke.py`` does on the card's
    machine: 29 held since the progressive and the CMYK fixture are
    read."""
    out = run_isolated("""
        import json
        import os

        import numpy as np

        from i2vsgg_tpu_torch import runtime
        from i2vsgg_tpu_torch.data import image_io
        from i2vsgg_tpu_torch.utils import cuda_build

        assert cuda_build.build_host(runtime.SOURCES).exists()
        d = os.path.join("tests", "data", "jpeg")
        manifest = json.load(open(os.path.join(d, "MANIFEST.json")))
        held = 0
        for name, entry in sorted(manifest.items()):
            path = os.path.join(d, name + ".jpg")
            if entry["set"] == "refused":
                try:
                    image_io.imread_bgr(path)
                except image_io.UnsupportedImageError as e:
                    assert entry["mode"] in str(e), e
                    continue
                raise SystemExit(f"{name} decoded")
            golden = image_io.imread_bgr(os.path.join(d, entry["golden"]))
            assert np.array_equal(image_io.imread_bgr(path), golden), name
            held += 1
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("held", held)
    """)
    assert "held 29" in out


def test_decode_formats_without_the_blocked_names():
    """With cv2, PIL, jax and yaml refused, both decoders hold every
    fixture of ``tests/data/decode`` (progressive, separate-scan and
    cut-short JPEG; PNG at each depth and Adam7; arithmetic-coded, CMYK,
    YCCK and lossless JPEG) to its golden and each progressive and
    arithmetic-coded 360x640 frame to its baseline twin, as
    ``chip_smoke.py`` phases 19 and 22 do on the card's machine."""
    out = run_isolated("""
        import json
        import os

        import numpy as np

        from i2vsgg_tpu_torch import runtime
        from i2vsgg_tpu_torch.data import image_io

        d = os.path.join("tests", "data", "decode")
        manifest = json.load(open(os.path.join(d, "MANIFEST.json")))
        held = 0
        for name, entry in sorted(manifest.items()):
            want = entry.get("golden") or entry.get("twin")
            if want is None:
                continue
            want = image_io.imread_bgr(os.path.join(d, want))
            path = os.path.join(d, entry["file"])
            assert np.array_equal(image_io.imread_bgr(path), want), name
            assert np.array_equal(runtime.decode_image(path), want), name
            held += 1
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("held", held)
    """)
    assert "held 66" in out


def test_native_runtime_builds_and_loads_without_the_blocked_names(tmp_path):
    """``i2vsgg_tpu_torch.runtime`` with cv2, PIL, jax, yaml and ml_dtypes
    refused: the library builds with the host compiler from
    ``io_runtime.cc`` and ``jpeg.cc``, decodes a committed JPEG fixture as
    the port's decoder does and a PNG that ``write_png`` wrote, loads them
    as one batch equal to the plain version and packs planes equal to the
    torch packer, as ``chip_smoke.py`` runs it on the card's machine (the
    drivers above load through it by default)."""
    out = run_isolated(f"""
        import os

        import numpy as np
        import torch

        from i2vsgg_tpu_torch import runtime
        from i2vsgg_tpu_torch.data import image_io
        from i2vsgg_tpu_torch.ops import conv1

        runtime.library()
        jpg = os.path.join("tests", "data", "jpeg", "s420_q90_37x53.jpg")
        png = os.path.join({str(tmp_path)!r}, "frame.png")
        frame = np.random.RandomState(0).randint(0, 256, (21, 34, 3))
        image_io.write_png(png, frame.astype(np.uint8), 4)
        assert np.array_equal(runtime.decode_image(jpg),
                              image_io.imread_bgr(jpg))
        assert np.array_equal(runtime.decode_image(png), frame)
        means = (102.9801, 115.9465, 122.7717)
        images, scales, hw = runtime.load_batch([jpg, png], [False, True],
                                                means, 24, 32, 48)
        for i, path in enumerate((jpg, png)):
            im, scale, size = runtime.preprocess_plain(
                runtime.decode_image(path), i == 1, means, 24, 32, 48)
            assert np.array_equal(images[i], im) and scales[i] == scale
            assert np.array_equal(hw[i], size)
        g = conv1.conv1_plane_geometry(32, 48)
        planes = runtime.pack_planes(images, g.hq, g.wq)
        assert torch.equal(planes.view(torch.int16), conv1.pack_conv1_planes_np(
            images, native=False).view(torch.int16))
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("runtime ok")
    """)
    assert "runtime ok" in out
