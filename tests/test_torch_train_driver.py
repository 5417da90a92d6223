"""``trainval_det_da`` of both packages on the fixture datasets of
tests/fixtures.py, on the CPU.

Each package reads its own copy of the fixture devkit (so each builds its
gt_roidb cache from the XML). Two pairings: the devkit's PNG video frames
as both domains (``--dataset MVidVRD --dataset_t MVidVRD``), and the
paper's, the MVRD stills (JPEG, decoded by the port's own decoder and by
JAX's cv2) as the source (``--dataset MVRD --dataset_t MVidVRD``). Both start from
one reference-layout detector checkpoint (``--pretrained_backbone
--pretrained_full``: every tensor of the training tree, so both hold the
same weights) and train res10 ic+gc with f32 compute under
``I2VSGG_DETERMINISTIC_SAMPLING=1`` at tests/test_drivers_e2e.py's tiny
configuration, with anchor scales (2, 4, 8) so that the 96 px frames hold
anchors and the RPN losses are not 0.

Checked: the losses in ``metrics.jsonl`` agree at rtol 1e-4 over 2 steps
(under both pairings);
the checkpoints' metadata keys are equal; the port's momentum buffers after
2 steps agree with JAX's within 1e-3 of each buffer's norm and at cosine
>= 0.9999 (the gradients' tolerance of tests/test_torch_train_step.py);
``--r`` resumes at step 2 with that momentum (the resumed step's losses
agree with JAX's resumed step's); and the port's ``test_det`` evaluates
the checkpoint. The lr is 1e-4: at 1e-3 these weights (the RPN and class
logits scaled up for the inference tests) diverge in the second step
(loss 60 -> 3600, class logits in the thousands), and there the momentum
of netD_style, which reaches the class scores through the gc feature,
parts by 1 % of its norm between the packages while their losses still
agree to 1e-6 (measured).
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.fixtures import make_fixture_root
from tests.test_torch_checkpoint_import import jwyang_detector_state_dict
from tests.test_torch_train_step import jax_traces

from i2vsgg_tpu.train import checkpoint as jax_ckpt
from i2vsgg_tpu_torch.config import Config
from i2vsgg_tpu_torch.data.voc import VRD_CLASSES
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.train import checkpoint
from i2vsgg_tpu_torch.train.optim import ReferenceSGD
from i2vsgg_tpu_torch.utils.weights import params_from_jax
from tools import trainval_det_da as jax_driver
from i2vsgg_tpu_torch.tools import test_det as port_test_det
from i2vsgg_tpu_torch.tools import trainval_det_da as port_driver

TINY = ["--cfg",
        "TRAIN.RPN_PRE_NMS_TOP_N", "300",
        "TRAIN.RPN_POST_NMS_TOP_N", "32",
        "TRAIN.RPN_POST_NMS_TOP_N_TARGET", "16",
        "TRAIN.RPN_BATCHSIZE", "32",
        "TRAIN.BATCH_SIZE", "16",
        "TEST.RPN_PRE_NMS_TOP_N", "100",
        "TEST.RPN_POST_NMS_TOP_N", "16",
        "TEST.MAX_DETECTIONS_PER_IMAGE", "20",
        "TRAIN.MAX_NUM_GT_BOXES", "6",
        "TRAIN.SCALES", "[96]",
        "TEST.SCALES", "[96]",
        "ANCHOR_SCALES", "[2, 4, 8]"]
RUN = ["--dataset_t", "MVidVRD", "--net", "res10",
       "--bs", "1", "--epochs", "1", "--lr", "1e-4", "--ic", "--gc",
       "--style_lambda", "1", "--disp_interval", "1",
       "--compute_dtype", "float32"]
SESSION = ("res10", "MVidVRD", "session_1")


def metrics(save_dir, source="MVidVRD"):
    path = os.path.join(save_dir, "res10", source, "session_1", "logs",
                        "metrics.jsonl")
    return [json.loads(line) for line in open(path)]


def train_both(root, source, resume):
    """Both drivers on ``source`` -> MVidVRD, 2 steps (then ``--r`` to step
    3 where ``resume``), each on its own copy of the devkit; yields the save
    directories."""
    data = {pkg: make_fixture_root(str(root / f"data_{pkg}"))["root"]
            for pkg in ("jax", "port")}
    ckpt = str(root / "jwyang.pth")
    torch.save(jwyang_detector_state_dict(len(VRD_CLASSES)), ckpt)
    out = {pkg: str(root / f"out_{pkg}") for pkg in ("jax", "port")}
    old = {k: os.environ.get(k) for k in ("I2VSGG_DATA_ROOT",
                                          "I2VSGG_DETERMINISTIC_SAMPLING")}
    os.environ["I2VSGG_DETERMINISTIC_SAMPLING"] = "1"
    try:
        for pkg, main, extra in (("jax", jax_driver.main, []),
                                 ("port", port_driver.main,
                                  ["--device", "cpu"])):
            os.environ["I2VSGG_DATA_ROOT"] = data[pkg]
            common = (["--dataset", source] + RUN + extra
                      + ["--save_dir", out[pkg]] + TINY)
            state = main(common + ["--max_steps", "2",
                                   "--pretrained_backbone", ckpt,
                                   "--pretrained_full"])
            assert int(state.step) == 2
            if resume:
                state = main(common + ["--max_steps", "3", "--r"])
                assert int(state.step) == 3
        yield {"out": out, "data": data}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    yield from train_both(tmp_path_factory.mktemp("train_driver"),
                          "MVidVRD", resume=True)


@pytest.fixture(scope="module")
def runs_jpeg_source(tmp_path_factory):
    yield from train_both(tmp_path_factory.mktemp("train_driver_mvrd"),
                          "MVRD", resume=False)


def same_losses(got, want, steps):
    assert [r["step"] for r in got] == [r["step"] for r in want] == steps
    names = [k for k in want[0] if k.startswith(("loss", "dloss"))]
    assert set(names) <= set(got[0]) and "loss_rpn_cls" in names
    for g, w in zip(got, want):
        for k in names:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {w['step']} {k}")
    assert want[0]["loss_rpn_cls"] > 0


def test_losses_agree(runs):
    same_losses(*(metrics(runs["out"][p]) for p in ("port", "jax")),
                [1, 2, 3])


def test_losses_agree_on_the_jpeg_source(runs_jpeg_source):
    """The paper's pairing: the MVRD stills (JPEG) as the source domain."""
    out = runs_jpeg_source["out"]
    same_losses(*(metrics(out[p], "MVRD") for p in ("port", "jax")), [1, 2])
    port_dir = os.path.join(out["port"], "res10", "MVRD", "session_1")
    jax_dir = os.path.join(out["jax"], "res10", "MVRD", "session_1")
    got = checkpoint.load_metadata(port_dir, 2)
    assert got == jax_ckpt.load_metadata(jax_dir, 2)
    assert got["dataset"] == "MVRD"


def test_checkpoints_agree_and_resume(runs):
    port_dir = os.path.join(runs["out"]["port"], *SESSION)
    jax_dir = os.path.join(runs["out"]["jax"], *SESSION)
    assert checkpoint.latest_step(port_dir) == 3
    for step in (2, 3):
        got = checkpoint.load_metadata(port_dir, step)
        want = jax_ckpt.load_metadata(jax_dir, step)
        assert set(got) == set(want) and got == want
    # the momentum after step 2 against JAX's
    cfg = Config().replace(COMPUTE_DTYPE="float32")
    det = FasterRCNN_DA(len(VRD_CLASSES), cfg, "res10", ic=True, gc=True,
                        training_tree=True)
    opt = ReferenceSGD(det, 1e-3, cfg)
    assert checkpoint.restore_full(port_dir, 2, det, opt) == 2
    tree = jax_ckpt._load_tree(jax_ckpt._ckpt_path(jax_dir, 2))
    want = params_from_jax(jax_traces(_as_optax(tree["opt_state"])))
    got = opt.momentum()
    assert set(got) == set(want) - {n for n, _ in det.named_buffers()}
    for name, m in got.items():
        m, ref = m.double(), want[name].double()
        norm = float(ref.norm())
        assert float((m - ref).abs().max()) <= 1e-3 * max(norm, 1e-12), name
        if norm > 0:
            assert float((m * ref).sum() / (m.norm() * norm)) >= 0.9999, name


def _as_optax(raw):
    """orbax returns the optax state as plain containers: read the
    momentum traces (the dicts keyed like the params) out of it."""
    import optax
    found = []

    def walk(x):
        if isinstance(x, dict) and "trace" in x and isinstance(
                x["trace"], dict):
            found.append(optax.TraceState(trace=x["trace"]))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(raw)
    return found


def test_port_test_det_reads_the_checkpoint(runs, monkeypatch):
    monkeypatch.setenv("I2VSGG_DATA_ROOT", runs["data"]["port"])
    port_dir = os.path.join(runs["out"]["port"], *SESSION)
    aps = port_test_det.main(
        ["--dataset", "MVidVRD", "--net", "res10", "--bs", "2", "--ic",
         "--gc", "--compute_dtype", "float32", "--device", "cpu",
         "--save_dir", runs["out"]["port"], "--load_name",
         os.path.join(port_dir, "3")] + TINY)
    assert "mAP" in aps and np.isfinite(aps["mAP"])
    assert os.path.exists(os.path.join(runs["out"]["port"], "eval",
                                       "MVidVRD_test", "detections.pkl"))
