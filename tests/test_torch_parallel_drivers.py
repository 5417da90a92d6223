"""The port's drivers in data parallel on the CPU, on the fixture datasets
of tests/fixtures.py at tests/test_torch_train_driver.py's tiny
configuration (res10, 96 px frames, f32):

* ``trainval_det_da`` under 2 gloo ranks (``file://`` rendezvous, one
  process a rank, as ``torchrun --nproc_per_node 2`` runs it): 2 steps, then
  a 2-rank ``--resume`` (the ``--r`` that torchrun's parser lets through)
  to step 3; only rank 0 writes the checkpoints and
  ``metrics.jsonl`` (one line a step, not two), both ranks log the same
  metrics, and ``--mesh 3`` in a world of 2 raises, naming torchrun;
* ``trainval_sgg`` under 2 ranks from that checkpoint: the same metrics on
  both ranks, one checkpoint;
* ``serve_video --mesh 2 --device cpu`` against ``--mesh 0`` on a devkit of
  9 frames at ``--bs 4`` (the tail batch of 1 frame padded to the mesh),
  plain and with ``--buckets``, ``--host_planes`` and ``--uint8_upload``:
  the same frames, relation triplets and boxes, scores within rtol 1e-5
  (the per-frame program sums in another batch).
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.fixtures import make_fixture_root
from tests.test_torch_parallel import Ranks
from tests.test_torch_train_driver import RUN, TINY

from i2vsgg_tpu_torch.config import Config
from i2vsgg_tpu_torch.data.voc import VRD_CLASSES
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.models.layers import init_weights
from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
from i2vsgg_tpu_torch.train import checkpoint
from i2vsgg_tpu_torch.train.optim import ReferenceSGD

N_REL = 7


@pytest.fixture(scope="module")
def stage_a(tmp_path_factory):
    """``trainval_det_da`` on 2 ranks: 2 steps, ``--r`` to 3, ``--mesh 3``;
    returns each rank's runs and the save directory."""
    tmp = tmp_path_factory.mktemp("dp_stage_a")
    root = make_fixture_root(str(tmp / "data"), n_rel=N_REL)["root"]
    out = str(tmp / "out")
    argv = (["--dataset", "MVidVRD"] + RUN + ["--device", "cpu",
                                              "--save_dir", out] + TINY)
    runs = Ranks(tmp, "driver", dict(
        module="i2vsgg_tpu_torch.tools.trainval_det_da", argv=argv,
        runs=[["--max_steps", "2"], ["--max_steps", "3", "--resume"],
              ["--max_steps", "1", "--mesh", "3"]],
        env={"I2VSGG_DATA_ROOT": root,
             "I2VSGG_DETERMINISTIC_SAMPLING": "1"})).results()
    return {"runs": runs, "out": out, "root": root, "tmp": tmp}


def _metrics(run):
    """A run's logged metrics without the rank's own images/s."""
    return [{k: v for k, v in m.items() if k != "imgs_per_sec"}
            for m in run["logged"]]


def test_trainval_det_da_on_two_ranks(stage_a):
    r0, r1 = stage_a["runs"]
    assert [r.get("step") for r in r0] == [r.get("step") for r in r1] == [
        2, 3, None]
    for a, b in zip(r0[:2], r1[:2]):
        assert _metrics(a) == _metrics(b)
        assert [m["step"] for m in a["logged"]] in ([1, 2], [3])
        assert all(np.isfinite(m["loss"]) for m in a["logged"])
    ck = os.path.join(stage_a["out"], "res10", "MVidVRD", "session_1")
    with open(os.path.join(ck, "logs", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [rec["step"] for rec in lines] == [1, 2, 3]          # rank 0 only
    assert [rec["loss"] for rec in lines] == [
        m["loss"] for r in r0[:2] for m in r["logged"]]
    assert checkpoint.latest_step(ck) == 3
    assert sorted(os.listdir(ck)) == ["logs", "step_00000002",
                                      "step_00000003"]
    cfg = Config().replace(COMPUTE_DTYPE="float32")
    det = FasterRCNN_DA(len(VRD_CLASSES), cfg, "res10", ic=True, gc=True,
                        training_tree=True)
    assert checkpoint.restore_full(ck, 3, det, ReferenceSGD(det, 1e-4,
                                                            cfg)) == 3
    for r in (r0, r1):
        assert "torchrun --nproc_per_node 3" in r[2]["error"]


def test_resume_flag_passes_through_torchrun():
    """The port's ``--resume`` (the same flag as ``--r``) reaches the driver
    through torchrun's parser. ``--r`` does not everywhere: the card
    machine's torchrun (PyTorch 2.11, Python 3.12.3) took it for an
    abbreviation of its own options (``--rdzv-*``, ``--role``, ...) and
    stopped; this machine's lets it through."""
    from torch.distributed.run import get_args_parser
    from i2vsgg_tpu_torch.cli.args import parse_args
    launch = ["--standalone", "--nproc_per_node", "2", "-m",
              "i2vsgg_tpu_torch.tools.trainval_det_da"]
    ns = get_args_parser().parse_args(launch + RUN + ["--resume"])
    assert ns.training_script_args[-1] == "--resume"
    assert parse_args(ns.training_script_args).resume
    assert parse_args(["--r"]).resume and not parse_args([]).resume


def test_trainval_sgg_on_two_ranks(stage_a):
    tmp = stage_a["tmp"]
    root = stage_a["root"]
    out = str(tmp / "out_sgg")
    ck_a = os.path.join(stage_a["out"], "res10", "MVidVRD", "session_1", "3")
    argv = ["--dataset", "MVRD", "--net", "res10", "--bs", "1",
            "--vrd_lr", "1e-4", "--num_relations", str(N_REL),
            "--vrd_fc_dim", "128", "--compute_dtype", "float32",
            "--disp_interval", "1", "--device", "cpu", "--save_dir", out,
            "--load_name", ck_a, "--source_gt_rels_path",
            os.path.join(root, "MVidVRD", "source_gt_rels.pkl")] + TINY
    r0, r1 = Ranks(tmp, "driver", dict(
        module="i2vsgg_tpu_torch.tools.trainval_sgg", argv=argv,
        runs=[["--max_steps", "2"]], env={"I2VSGG_DATA_ROOT": root}),
        tag="driver_sgg").results()
    assert r0[0]["step"] == r1[0]["step"] == 2
    strip = _metrics(r0[0])
    assert strip == _metrics(r1[0])
    assert [m["step"] for m in strip] == [1, 2]
    assert all(np.isfinite(m["loss"]) and m["n_pairs"] > 0 for m in strip)
    ck = os.path.join(out, "res10", "MVRD_SGG", "session_1")
    assert checkpoint.latest_step(ck) == 2
    assert checkpoint.load_metadata(ck, 2)["vrd_pooling"] == "pool"


# -- serve_video --mesh --------------------------------------------------

@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """A devkit of 3 videos x 3 frames and seeded res10 checkpoints (the RPN
    and class logits scaled up, the box deltas down, against near-ties)."""
    tmp = tmp_path_factory.mktemp("dp_serve")
    root = make_fixture_root(str(tmp / "data"), n_rel=N_REL, n_videos=3,
                             frames_per_video=3)["root"]
    cfg = Config().replace(COMPUTE_DTYPE="float32")
    det = FasterRCNN_DA(len(VRD_CLASSES), cfg, "res10", ic=True, gc=True)
    init_weights(det, torch.Generator().manual_seed(5))
    with torch.no_grad():
        det.rpn.cls_score.weight.mul_(40.0)
        det.cls_score.weight.mul_(40.0)
        det.rpn.bbox_pred.weight.mul_(0.1)
        det.bbox_pred.weight.mul_(0.1)
    sgg = SGGModel(VRDHead(emb_dim=300, fc_dim=128, pooling="pool"))
    init_weights(sgg, torch.Generator().manual_seed(6))
    ck = str(tmp / "ckpt")
    checkpoint.save_checkpoint(os.path.join(ck, "det"), det.state_dict(), 1,
                               {"pooling_mode": "align"})
    checkpoint.save_checkpoint(os.path.join(ck, "sgg"), sgg.state_dict(), 1,
                               {"vrd_pooling": "pool"})
    return {"root": root, "tmp": tmp,
            "det": os.path.join(ck, "det", "1"),
            "sgg": os.path.join(ck, "sgg", "1")}


def _frames(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("lever", [[], ["--buckets", "2,4"],
                                   ["--host_planes"], ["--uint8_upload"]],
                         ids=["plain", "buckets", "host_planes", "uint8"])
def test_serve_video_mesh_2_matches_mesh_0(serving, lever, monkeypatch,
                                           capsys):
    from i2vsgg_tpu_torch.tools import serve_video
    monkeypatch.setenv("I2VSGG_DATA_ROOT", serving["root"])
    tag = "_".join(lever).replace("-", "").replace(",", "") or "plain"
    got = {}
    for m in ("0", "2"):
        out = str(serving["tmp"] / f"out_{tag}_{m}")
        serve_video.main(["--dataset", "MVidVRD", "--net", "res10", "--ic",
                          "--gc", "--bs", "4", "--num_relations", str(N_REL),
                          "--compute_dtype", "float32", "--vrd_fc_dim", "128",
                          "--max_det", "4", "--device", "cpu", "--mesh", m,
                          "--load_name", serving["det"], "--sgg_load_name",
                          serving["sgg"], "--save_dir", out] + lever + TINY)
        got[m] = _frames(os.path.join(out, "serve", "MVidVRD_test",
                                      "frame_detections.json"))
    assert "serving over a 2-device mesh" in capsys.readouterr().out
    a, b = got["0"], got["2"]
    assert set(a) == set(b) == {"vid00", "vid01", "vid02"}
    n = 0
    for vid in a:
        assert [f for f, _ in a[vid]] == [f for f, _ in b[vid]]
        for (_, ta), (_, tb) in zip(a[vid], b[vid]):
            assert [t[1] for t in ta] == [t[1] for t in tb]
            np.testing.assert_allclose([t[0] for t in tb],
                                       [t[0] for t in ta], rtol=1e-5)
            np.testing.assert_allclose([t[2] for t in tb],
                                       [t[2] for t in ta], rtol=1e-5,
                                       atol=1e-3)
            n += len(ta)
    assert n > 0


def test_serve_video_mesh_needs_a_multiple_batch(serving, monkeypatch):
    from i2vsgg_tpu_torch.tools import serve_video
    monkeypatch.setenv("I2VSGG_DATA_ROOT", serving["root"])
    with pytest.raises(ValueError, match="multiple of --mesh 2"):
        serve_video.main(["--dataset", "MVidVRD", "--net", "res10", "--bs",
                          "3", "--mesh", "2", "--device", "cpu"])
