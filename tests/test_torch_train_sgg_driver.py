"""``trainval_sgg`` of both packages on the fixture datasets of
tests/fixtures.py, on the CPU.

Each package reads its own copy of the fixture devkit. The port's loader
decodes PNG only, so both train on the devkit's PNG video frames
(``--dataset MVidVRD``) with the fixture's ``target_gt_rels.pkl`` (keyed by
those frames) as ``--source_gt_rels_path``. Both start from one Stage A
checkpoint: JAX's res10 detector init, saved by JAX and converted with
``tools/jax_to_torch_checkpoint.py``; ``restore_sgg_init`` copies its trunk.
The head's init is a draw of each package's own generator, so the test
hands the port JAX's initial tree (the port's ``init_module`` replaced by a
load of it), and the dropout is the identity in both (flax's
``Dropout.__call__`` and the port's ``models/sgg.py::dropout`` replaced),
since the draws cannot match. res10, a head of width 128, f32, 96 px
frames (the ``TINY`` of tests/test_torch_drivers.py), two images a step,
2 steps.

Checked: the logged losses and pair counts agree at rtol 1e-4; the
checkpoints' metadata keys and values are equal; the saved trunk equals
the Stage A checkpoint's, bit for bit; the saved head equals JAX's at rtol
1e-5 with an atol of 1e-3 of each tensor's largest change (the rule of
tests/test_torch_train_step.py); and the port's ``test_sgg`` evaluates the
saved checkpoint with the pooling its metadata records.
"""

import json
import os

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from tests.fixtures import make_fixture_root

from i2vsgg_tpu import config as jax_config
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.train import checkpoint as jax_ckpt
from i2vsgg_tpu.train.det_da import TrainState as JaxTrainState
from i2vsgg_tpu_torch.models import inits as port_inits
from i2vsgg_tpu_torch.models import sgg as sgg_mod
from i2vsgg_tpu_torch.train import checkpoint
from i2vsgg_tpu_torch.utils.weights import params_from_jax
from tools import jax_to_torch_checkpoint
from tools import trainval_sgg as jax_driver
from i2vsgg_tpu_torch.tools import test_sgg as port_test_sgg
from i2vsgg_tpu_torch.tools import trainval_sgg as port_driver

N_REL = 7
TINY = ["--cfg",
        "TEST.RPN_PRE_NMS_TOP_N", "100",
        "TEST.RPN_POST_NMS_TOP_N", "16",
        "TEST.MAX_DETECTIONS_PER_IMAGE", "20",
        "TRAIN.MAX_NUM_GT_BOXES", "6",
        "TRAIN.SCALES", "[96]",
        "TEST.SCALES", "[96]"]
RUN = ["--dataset", "MVidVRD", "--net", "res10", "--bs", "2",
       "--epochs", "1", "--max_steps", "2", "--vrd_lr", "1e-3",
       "--num_relations", str(N_REL), "--vrd_fc_dim", "128",
       "--disp_interval", "1", "--compute_dtype", "float32"] + TINY
SESSION = ("res10", "MVidVRD_SGG", "session_1")


def logged(save_dir):
    path = os.path.join(save_dir, *SESSION, "logs", "metrics.jsonl")
    return [json.loads(line) for line in open(path)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers for 2 steps from one Stage A checkpoint, each on its own
    copy of the devkit; returns the directories and JAX's initial tree."""
    root = tmp_path_factory.mktemp("sgg_driver")
    data = {pkg: make_fixture_root(str(root / f"data_{pkg}"), n_rel=N_REL)
            for pkg in ("jax", "port")}
    cfg = jax_config.Config().replace(COMPUTE_DTYPE="float32")
    det = JaxFasterRCNN(num_classes=16, cfg=cfg, backbone="res10", ic=True,
                        gc=True)
    dp = jax.jit(lambda k: det.init(
        {"params": k}, jnp.zeros((1, 64, 80, 3)),
        jnp.asarray([[64, 80, 1.0]]), mode="inference")["params"])(
        jax.random.PRNGKey(3))
    dp = jax.tree_util.tree_map(np.array, dp)
    jdir, tdir = str(root / "stage_a_jax"), str(root / "stage_a")
    jax_ckpt.save_checkpoint(jdir, JaxTrainState(dp, {}, jnp.zeros(
        (), jnp.int32)), 1, metadata={"pooling_mode": "align"})
    jax_to_torch_checkpoint.main([os.path.join(jdir, "1"), tdir])
    out = {pkg: str(root / f"out_{pkg}") for pkg in ("jax", "port")}

    mp = pytest.MonkeyPatch()
    init = {}
    real_restore = jax_ckpt.restore_sgg_init

    def jax_restore(*a):
        init["tree"] = jax.tree_util.tree_map(np.array, real_restore(*a))
        return init["tree"]

    def port_init(model, generator):
        # JAX's initial tree (its head's draw; the trunk restored next)
        model.load_state_dict(params_from_jax(init["tree"]))
        return model
    mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mp.setattr(sgg_mod, "dropout", lambda x, rate, generator: x)
    mp.setattr(jax_ckpt, "restore_sgg_init", jax_restore)
    mp.setattr(port_inits, "init_module", port_init)
    try:
        for pkg, main, load, extra in (
                ("jax", jax_driver.main, jdir, []),
                ("port", port_driver.main, tdir, ["--device", "cpu"])):
            mp.setenv("I2VSGG_DATA_ROOT", data[pkg]["root"])
            state = main(RUN + extra + [
                "--save_dir", out[pkg],
                "--load_name", os.path.join(load, "1"),
                "--source_gt_rels_path", data[pkg]["target_gt_rels"]])
            assert int(state.step) == 2
        yield {"out": out, "data": data, "stage_a": tdir,
               "init": params_from_jax(init["tree"])}
    finally:
        mp.undo()


def test_losses_agree(runs):
    got, want = (logged(runs["out"][p]) for p in ("port", "jax"))
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        assert g["tag"] == w["tag"] == "sgg_train"
        assert set(g) == set(w)
        assert g["n_pairs"] == w["n_pairs"] > 0
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                   err_msg=f"step {w['step']}")
        assert g["loss"] > 0


def test_checkpoints_agree(runs):
    port_dir = os.path.join(runs["out"]["port"], *SESSION)
    jax_dir = os.path.join(runs["out"]["jax"], *SESSION)
    assert checkpoint.latest_step(port_dir) == 2
    got = checkpoint.load_metadata(port_dir, 2)
    want = jax_ckpt.load_metadata(jax_dir, 2)
    assert got == want and got["stage"] == "sgg"
    assert got["vrd_pooling"] == "pool"
    saved = checkpoint.load_state_dict(port_dir, 2)
    stage_a = checkpoint.load_state_dict(runs["stage_a"], 1)
    trunk = [k for k in saved if k.startswith("trunk.")]
    assert trunk and all(torch.equal(saved[k], stage_a[k]) for k in trunk)
    jtree = jax_ckpt._load_tree(jax_ckpt._ckpt_path(jax_dir, 2))["params"]
    jsaved = params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))
    init = runs["init"]
    moved = 0
    for k, v in saved.items():
        if not k.startswith("vrd."):
            continue
        step = float((jsaved[k] - init[k]).abs().max())
        np.testing.assert_allclose(v.numpy(), jsaved[k].numpy(), rtol=1e-5,
                                   atol=max(1e-3 * step, 1e-12), err_msg=k)
        moved += int(step > 0)
    assert moved > 20


def test_port_test_sgg_reads_the_checkpoint(runs, monkeypatch, capsys):
    """``--vrd_pooling align`` on the command line; the checkpoint's
    metadata (``pool``) wins."""
    data = runs["data"]["port"]
    monkeypatch.setenv("I2VSGG_DATA_ROOT", data["root"])
    port_dir = os.path.join(runs["out"]["port"], *SESSION)
    out = port_test_sgg.main(
        ["--dataset", "MVidVRD", "--net", "res10", "--bs", "2",
         "--num_relations", str(N_REL), "--compute_dtype", "float32",
         "--vrd_fc_dim", "128", "--vrd_pooling", "align",
         "--video_ann", data["video_ann"], "--device", "cpu",
         "--save_dir", runs["out"]["port"],
         "--load_name", os.path.join(port_dir, "2")] + TINY)
    mAP, rec_at_n, _ = out
    assert "vrd pooling from checkpoint metadata: pool" in \
        capsys.readouterr().out
    assert 0.0 <= mAP <= 1.0 and set(rec_at_n) == {50, 100}
    frames = json.load(open(os.path.join(
        runs["out"]["port"], "eval", "MVidVRD_test_SGG",
        "frame_detections.json")))
    assert set(frames) == {"vid00", "vid01"}
