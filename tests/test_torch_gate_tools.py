"""The serving gates' tools of the port against the JAX package's, on the CPU
at a small size: the learnable corpus (``i2vsgg_tpu_torch/tools/
learnable_data.py`` against ``tests/fixtures.py``), ``train_gate_arm``'s
corpora and command line, ``capacity_ab``, ``quant_ab`` and the parity
helpers they use (``i2vsgg_tpu_torch/tools/parity_run.py``), and the gate
verdicts ``chip_smoke.py`` prints against ``bench.py``'s.

Tolerances:

* the corpus: pixels bit-equal (each package's PNG decoded with PIL), the
  XML, ``ImageSets``, ``video_annotations_*.json`` and pickles byte-equal,
  the generators' return values equal; a ``.jpg``-named still (PNG bytes:
  the card's machine has no JPEG encoder) decodes to the same pixels
  through cv2 (JAX's reader), the JAX runtime and both of the port's;
* ``train_gate_arm``: the port's ``trainval_det_da`` command line equal to
  JAX's but for the init (``--pretrained_backbone <pth>
  --pretrained_full`` -> ``--zero_init_residual``) and ``--device``;
* ``capacity_ab``: the same rows, keys and JSON schema, the APs equal and
  the last row's detections within ``test_det``'s parity bounds (scores
  rtol 1e-4, boxes rtol 1e-5), each evaluation given ``--compute_dtype
  float32`` as the driver tests run;
* ``quant_ab``: per arm ``n_pairs`` and ``n_gt`` equal, ``top1_acc`` and
  the ``--stage_c`` metrics equal, ``pred_mAP`` within 1e-6 (scores in f32
  on both sides; the int8 arm's integer products are exact in both), the
  ``delta`` int8 - fp32 of every float metric.

The Stage B head of ``quant_ab``'s scorer is built at fc width 128 in both
packages (their ``VRDHead`` patched where the tools build it), the trunk
at res10 (``parity_run.HP["depth"]``): the tools' own 4096 would put 205M
parameters on the CPU.
"""

import filecmp
import functools
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

import tests.fixtures as jax_fixtures
from i2vsgg_tpu import config as jax_config
from i2vsgg_tpu import runtime as jax_runtime
from i2vsgg_tpu.data import pipeline as jax_pipeline
from i2vsgg_tpu.models import sgg as jax_sgg
from i2vsgg_tpu.models.backbones import ResNetTrunk as JaxResNetTrunk
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.train import checkpoint as jax_ckpt
from i2vsgg_tpu.train.det_da import TrainState
from i2vsgg_tpu_torch import runtime
from i2vsgg_tpu_torch.data import image_io
from i2vsgg_tpu_torch.models import sgg as port_sgg
from i2vsgg_tpu_torch.tools import capacity_ab, learnable_data
from i2vsgg_tpu_torch.tools import parity_run, quant_ab, train_gate_arm
from i2vsgg_tpu_torch.tools import test_det as port_test_det
from i2vsgg_tpu_torch.tools import trainval_det_da as port_trainval
from i2vsgg_tpu_torch.train import checkpoint
from tools import capacity_ab as jax_capacity_ab
from tools import jax_to_torch_checkpoint
from tools import parity_run as jax_parity_run
from tools import quant_ab as jax_quant_ab
from tools import test_det as jax_test_det
from tools import train_gate_arm as jax_train_gate_arm
from tools import trainval_det_da as jax_trainval

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the small parity corpus: 16 stills (8 trainval), 2 videos of 12 frames
SMALL_DATA = dict(n_source=16, source_split=0.5, n_target=2,
                  target_split=0.5, video_target=True, n_frames=12)
# test_det at 96 px with anchors that fit the 96-px objects
EVAL_CFG = ["ANCHOR_SCALES", "[1, 2, 4]", "TEST.SCALES", "[96]",
            "TRAIN.SCALES", "[96]", "POOLING_MODE", "align"]
INIT_FLAGS = ["--pretrained_backbone", "--pretrained_full"]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _same_devkits(port_root, jax_root, jax_png_root=None):
    """Two corpora: the same files; images bit-equal (a JAX ``.jpg``, lossy,
    is held to the JAX generator's PNG twin under ``jax_png_root``), every
    other file byte-equal."""
    names = _tree(jax_root)
    assert _tree(port_root) == names and names
    for rel in names:
        p, j = os.path.join(port_root, rel), os.path.join(jax_root, rel)
        if rel.endswith(".jpg"):
            twin = os.path.join(jax_png_root, rel[:-4] + ".png")
            np.testing.assert_array_equal(_pixels(p), _pixels(twin))
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(_pixels(p), _pixels(j))
        else:
            assert filecmp.cmp(p, j, shallow=False), rel
    return names


# -- the corpus ------------------------------------------------------------

@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (11, dict(hw=(96, 128), split_frac=0.4, min_obj=2, max_obj=6,
              size_range=(20, 50), index_fmt="vid00_{:04d}")),
    (3, dict(hw=(60, 80), split_frac=0.5, min_obj=1, max_obj=3,
             size_range=(10, 30)))])
def test_learnable_stills_match_jax(tmp_path, seed, kw):
    want = jax_fixtures.make_learnable_dataset(str(tmp_path / "j"), "MVRD",
                                               7, ".png", seed=seed, **kw)
    got = learnable_data.make_learnable_dataset(str(tmp_path / "p"), "MVRD",
                                                7, ".png", seed=seed, **kw)
    assert got == want
    names = _same_devkits(str(tmp_path / "p"), str(tmp_path / "j"))
    assert sum(n.endswith(".png") for n in names) == 7
    with open(tmp_path / "p" / "MVRD" / "source_gt_rels.pkl", "rb") as f:
        assert pickle.load(f) == want[1]


@pytest.mark.parametrize("seed,kw", [
    (1, dict(n_videos=2, n_frames=12)),
    (5, dict(n_videos=3, n_frames=11, hw=(96, 128), min_obj=4, max_obj=6,
             size_range=(20, 40), max_speed=7, min_gt_len=4,
             split_frac=0.34))])
def test_learnable_videos_match_jax(tmp_path, seed, kw):
    want = jax_fixtures.make_learnable_video_dataset(
        str(tmp_path / "j"), "MVidVRD", seed=seed, **kw)
    got = learnable_data.make_learnable_video_dataset(
        str(tmp_path / "p"), "MVidVRD", seed=seed, **kw)
    assert got == want
    names = _same_devkits(str(tmp_path / "p"), str(tmp_path / "j"))
    assert "MVidVRD/video_annotations_test.json" in names
    assert sum(len(v) for v in want[2].values()) > 0     # GT trajectories


def test_jpg_named_stills_decode_alike(tmp_path):
    """A still the port writes under the ``.jpg`` name is a PNG file; cv2
    (JAX's reader), the JAX runtime and the port's two decoders read the
    pixels the generator drew."""
    jax_fixtures.make_learnable_dataset(str(tmp_path / "j"), "MVRD", 2,
                                        ".png", seed=4)
    learnable_data.make_learnable_dataset(str(tmp_path / "p"), "MVRD", 2,
                                          ".jpg", seed=4)
    for i in range(2):
        path = str(tmp_path / "p" / "MVRD" / "JPEGImages" / f"im{i:04d}.jpg")
        with open(path, "rb") as f:
            assert f.read(8) == image_io.PNG_SIGNATURE
        bgr = _pixels(str(tmp_path / "j" / "MVRD" / "JPEGImages"
                          / f"im{i:04d}.png"))[..., ::-1]
        for read in (jax_pipeline.imread_bgr, jax_runtime.decode_image,
                     image_io.imread_bgr, runtime.decode_image):
            np.testing.assert_array_equal(read(path), bgr)


# -- train_gate_arm ----------------------------------------------------------

class Recorder:
    """Calls ``fn`` with ``override`` over its keyword arguments and
    records what it was given."""

    def __init__(self, fn, **override):
        self.fn, self.override, self.calls = fn, override, []

    def __call__(self, *a, **k):
        self.calls.append((a[1:], dict(k)))      # the root differs
        return self.fn(*a, **dict(k, **self.override))


def _png_twin(monkeypatch, mod, attr):
    """``mod.<attr>`` (JAX's ``make_learnable_dataset``) also writes a PNG
    twin of each ``.jpg`` devkit under ``<root>_png``."""
    real = getattr(mod, attr)

    def both(root, ds, n, ext=".jpg", *a, **k):
        if ext == ".jpg":
            real(root + "_png", ds, n, ".png", *a, **k)
        return real(root, ds, n, ext, *a, **k)

    monkeypatch.setattr(mod, attr, both)


def test_ensure_parity_data_matches_jax(tmp_path, monkeypatch):
    """Both tools write the same corpus (at a small size: each package's
    ``make_data`` shrunk the same way, their arguments recorded and held
    equal), and refuse a root holding part of one."""
    _png_twin(monkeypatch, jax_fixtures, "make_learnable_dataset")
    small = dict(n_source=6, n_target=2, n_frames=11)
    rec_j = Recorder(jax_parity_run.make_data, **small)
    rec_p = Recorder(parity_run.make_data, **small)
    monkeypatch.setattr(jax_parity_run, "make_data", rec_j)
    monkeypatch.setattr(parity_run, "make_data", rec_p)
    jax_train_gate_arm.ensure_parity_data(str(tmp_path / "j"))
    train_gate_arm.ensure_parity_data(str(tmp_path / "p"))
    assert rec_p.calls == rec_j.calls and len(rec_j.calls) == 1
    assert rec_j.calls[0][1]["n_source"] == 300
    names = _same_devkits(str(tmp_path / "p"), str(tmp_path / "j"),
                          str(tmp_path / "j_png"))
    assert "MVidVRD/source_so_prior.pkl" in names
    # present: nothing written again
    train_gate_arm.ensure_parity_data(str(tmp_path / "p"))
    assert len(rec_p.calls) == 1
    for root, ensure in ((tmp_path / "j", jax_train_gate_arm),
                         (tmp_path / "p", train_gate_arm)):
        os.remove(root / "MVidVRD" / "source_so_prior.pkl")
        with pytest.raises(SystemExit, match="partial data root"):
            ensure.ensure_parity_data(str(root))


def test_ensure_bench600_data_matches_jax(tmp_path, monkeypatch):
    """The 600-px corpus of both tools (3 stills a domain, each generator
    call's other arguments recorded and held equal), and the refusal of a
    partial root."""
    rec_j = Recorder(jax_fixtures.make_learnable_dataset)
    rec_p = Recorder(learnable_data.make_learnable_dataset)
    monkeypatch.setattr(jax_fixtures, "make_learnable_dataset",
                        lambda root, ds, n, *a, **k: rec_j(root, ds, 3, *a,
                                                           **k))
    monkeypatch.setattr(learnable_data, "make_learnable_dataset",
                        lambda root, ds, n, *a, **k: rec_p(root, ds, 3, *a,
                                                           **k))
    _png_twin(monkeypatch, jax_fixtures, "make_learnable_dataset")
    jax_train_gate_arm.ensure_bench600_data(str(tmp_path / "j"))
    train_gate_arm.ensure_bench600_data(str(tmp_path / "p"))
    # JAX's calls less the PNG twins of its .jpg devkit
    calls_j = [c for c in rec_j.calls if c[0][2] != ".png"
               or c[0][0] == "MVidVRD"]
    assert rec_p.calls == calls_j and len(calls_j) == 2
    assert calls_j[0][1]["hw"] == (600, 800)
    _same_devkits(str(tmp_path / "p"), str(tmp_path / "j"),
                  str(tmp_path / "j_png"))
    shutil.rmtree(tmp_path / "p" / "MVidVRD")
    with pytest.raises(SystemExit, match="partial data root"):
        train_gate_arm.ensure_bench600_data(str(tmp_path / "p"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The small parity corpus (the port's generator: its ``.jpg`` stills
    are PNG files, which both packages read alike), one copy for each
    package, so that each builds its own gt_roidb cache."""
    d = tmp_path_factory.mktemp("corpus")
    parity_run.make_data(str(d / "port" / "data"), **SMALL_DATA)
    shutil.copytree(d / "port" / "data", d / "jax" / "data")
    return {pkg: str(d / pkg) for pkg in ("jax", "port")}


def _recipe(monkeypatch):
    """Each package's parity recipe restored after the test (the tools set
    it for the process)."""
    for mod in (jax_parity_run, parity_run):
        monkeypatch.setattr(mod, "HP", dict(mod.HP))
        monkeypatch.setattr(mod, "CFG_OVERRIDES", list(mod.CFG_OVERRIDES))


@pytest.mark.parametrize("profile", ["parity240", "bench600"])
def test_train_gate_arm_argv_matches_jax(corpus, tmp_path, monkeypatch,
                                         profile):
    """Both tools on one corpus: the port's driver command line is JAX's
    with ``--zero_init_residual`` for the reference's exported init, and
    ``--device``; the recipe they leave set is the same."""
    _recipe(monkeypatch)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    argv = {}
    monkeypatch.setattr(jax_parity_run, "shared_init",
                        lambda data, out, seed=0: "/init/shared_init.pth")
    monkeypatch.setattr(jax_trainval, "main",
                        lambda a: argv.setdefault("jax", list(a)))
    monkeypatch.setattr(port_trainval, "main",
                        lambda a: argv.setdefault("port", list(a)))
    monkeypatch.setenv("I2VSGG_DATA_ROOT", "")
    common = ["--out", str(tmp_path / "arm"), "--profile", profile,
              "--steps", "40", "--seed", "2"]
    got_j = jax_train_gate_arm.main(
        common + ["--data", os.path.join(corpus["jax"], "data")])
    got_p = train_gate_arm.main(
        common + ["--data", os.path.join(corpus["port"], "data"),
                  "--device", "cpu"])
    assert got_p == got_j == str(tmp_path / "arm" / "res101" / "MVRD"
                                 / "session_903")
    i = argv["jax"].index(INIT_FLAGS[0])
    assert argv["jax"][i + 1] == "/init/shared_init.pth"
    assert argv["jax"][i + 2] == INIT_FLAGS[1]
    want = (argv["jax"][:i] + ["--zero_init_residual"]
            + argv["jax"][i + 3:] + ["--device", "cpu"])
    assert argv["port"] == want
    assert parity_run.HP == jax_parity_run.HP
    assert parity_run.CFG_OVERRIDES == jax_parity_run.CFG_OVERRIDES
    assert ("TEST.SCALES" in want and want[want.index("TEST.SCALES") + 1]
            == ("[600]" if profile == "bench600" else "[240]"))


def test_train_gate_arm_trains_and_saves(corpus, tmp_path, monkeypatch):
    """The port's tool trains its arm (res10, 2 steps, on the CPU) from its
    init with bn3 zeroed and writes the checkpoint the gates read."""
    _recipe(monkeypatch)
    monkeypatch.setenv("I2VSGG_DATA_ROOT", "")
    ckpt_dir = train_gate_arm.main([
        "--out", str(tmp_path / "arm"), "--data",
        os.path.join(corpus["port"], "data"), "--steps", "2", "--depth",
        "10", "--device", "cpu"])
    assert ckpt_dir == str(tmp_path / "arm" / "res10" / "MVRD"
                           / "session_902")
    assert checkpoint.latest_step(ckpt_dir) == 2
    meta = checkpoint.load_metadata(ckpt_dir, 2)
    assert meta["pooling_mode"] == "align" and meta["net"] == "res10"
    sd = checkpoint.load_state_dict(ckpt_dir, 2)
    assert all(torch.isfinite(v).all() for v in sd.values()
               if v.is_floating_point())


# -- capacity_ab --------------------------------------------------------------

def _save_both(d, name, tree, meta):
    """A JAX tree saved by JAX's ``save_checkpoint`` as step 1 and converted
    to the port's format -> (JAX's ``<dir>/1``, the port's)."""
    jdir, tdir = os.path.join(d, "jax_" + name), os.path.join(d, name)
    jax_ckpt.save_checkpoint(jdir, TrainState(tree, {},
                                              jnp.zeros((), jnp.int32)),
                             1, metadata=meta)
    jax_to_torch_checkpoint.main([os.path.join(jdir, "1"), tdir])
    return os.path.join(jdir, "1"), os.path.join(tdir, "1")


@pytest.fixture(scope="module")
def detector(tmp_path_factory):
    """JAX's init of the res10 detector (16 classes, ic+gc), its class
    logits scaled by 40 and box deltas by 0.1 (random weights tie
    otherwise), in both formats."""
    cfg = jax_config.Config().replace(COMPUTE_DTYPE="float32")
    det = JaxFasterRCNN(num_classes=16, cfg=cfg, backbone="res10", ic=True,
                        gc=True)
    p = jax.jit(lambda k: det.init(
        {"params": k}, jnp.zeros((1, 64, 80, 3)),
        jnp.asarray([[64, 80, 1.0]]), mode="inference")["params"])(
        jax.random.PRNGKey(3))
    p = jax.tree_util.tree_map(np.array, p)
    p["rpn"]["cls_score"]["kernel"] *= 40.0
    p["cls_score"]["kernel"] *= 40.0
    p["rpn"]["bbox_pred"]["kernel"] *= 0.1
    p["bbox_pred"]["kernel"] *= 0.1
    return _save_both(str(tmp_path_factory.mktemp("det")), "det", p,
                      {"pooling_mode": "align"})


def test_capacity_ab_matches_jax(corpus, detector, tmp_path, monkeypatch):
    """Both tools' sweeps of one checkpoint (two rows, each package on its
    copy of the corpus): the same JSON schema and keys, the APs equal, the
    last row's detections within test_det's parity bounds."""
    for mod in (jax_test_det, port_test_det):
        real = mod.main
        monkeypatch.setattr(mod, "main", lambda argv, real=real: real(
            list(argv) + ["--compute_dtype", "float32"]))
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    rows = "1024:16:8,100:8:4:2"
    out = {}
    for pkg, mod, ckpt, extra in (
            ("jax", jax_capacity_ab, detector[0], []),
            ("port", capacity_ab, detector[1], ["--device", "cpu"])):
        out[pkg] = str(tmp_path / pkg)
        mod.main(["--ckpt", ckpt, "--data",
                  os.path.join(corpus[pkg], "data"), "--net", "res10",
                  "--out", out[pkg], "--rows", rows, "--cfg"] + EVAL_CFG
                 + extra)
    js = {}
    for pkg in ("jax", "port"):
        with open(os.path.join(out[pkg], "capacity_ab.json")) as f:
            js[pkg] = json.load(f)
    assert set(js["port"]) == set(js["jax"]) == {"step", "ckpt_dir",
                                                 "dataset", "results"}
    assert js["port"]["step"] == js["jax"]["step"] == 1
    assert list(js["port"]["results"]) == list(js["jax"]["results"]) == [
        "pre1024_rpn16_det8", "pre100_rpn8_det4_mpc2"]
    for key, r in js["jax"]["results"].items():
        assert set(js["port"]["results"][key]) == set(r) == {"mAP",
                                                             "eval_s"}
        assert js["port"]["results"][key]["mAP"] == r["mAP"]
    dets = []
    for pkg in ("jax", "port"):
        [run] = [d for d in os.listdir(out[pkg]) if d.startswith("eval_pid")]
        with open(os.path.join(out[pkg], run, "eval", "MVRD_test",
                               "detections.pkl"), "rb") as f:
            dets.append(pickle.load(f))
    n = 0
    for per_j, per_p in zip(*dets):
        for a, b in zip(per_j, per_p):
            assert a.shape == b.shape and len(a) <= 4
            np.testing.assert_allclose(b[:, :4], a[:, :4], rtol=1e-5,
                                       atol=1e-5 * 128)
            np.testing.assert_allclose(b[:, 4], a[:, 4], rtol=1e-4,
                                       atol=1e-4)
            n += len(a)
    assert n > 0


# -- quant_ab -----------------------------------------------------------------

FC = 128


@pytest.fixture(scope="module")
def stage_b(corpus, tmp_path_factory):
    """JAX's init of a Stage B model (res10 trunk, head at fc ``FC``, 5
    predicates) in both formats."""
    g, z = 6, jnp.zeros
    sgg = jax_sgg.SGGModel(trunk=JaxResNetTrunk(depth=10, dtype=jnp.float32),
                           vrd=jax_sgg.VRDHead(fc_dim=FC), n_rel=5)
    sp = jax.jit(lambda k: sgg.init(
        {"params": k}, z((1, 64, 80, 3)), jnp.asarray([64, 80, 1.0]),
        z((g, 4)), z((g,), jnp.int32), z((g * (g - 1),), jnp.int32),
        z((g * (g - 1),), jnp.int32), z((g * (g - 1),), bool),
        z((5, 300)))["params"])(jax.random.PRNGKey(4))
    return _save_both(str(tmp_path_factory.mktemp("sgg")), "sgg",
                      jax.tree_util.tree_map(np.array, sp),
                      {"vrd_pooling": "pool"})


def _narrow_heads(monkeypatch):
    """Both tools' ``VRDHead()`` at fc ``FC``, ``HP["depth"]`` 10."""
    monkeypatch.setattr(jax_sgg, "VRDHead",
                        functools.partial(jax_sgg.VRDHead, fc_dim=FC))
    real = port_sgg.VRDHead
    monkeypatch.setattr(port_sgg, "VRDHead",
                        lambda **k: real(**dict(k, fc_dim=FC)))
    _recipe(monkeypatch)
    monkeypatch.setitem(jax_parity_run.HP, "depth", 10)
    monkeypatch.setitem(parity_run.HP, "depth", 10)


def test_quant_ab_matches_jax(corpus, stage_b, tmp_path, monkeypatch):
    """Both tools on one Stage B checkpoint with ``--stage_c``: per arm the
    same metrics, and the port's JSON is JAX's schema."""
    _narrow_heads(monkeypatch)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setenv("I2VSGG_DATA_ROOT", "")
    want = jax_quant_ab.main(["--out", corpus["jax"], "--ckpt", stage_b[0],
                              "--stage_c", "--json",
                              str(tmp_path / "jax.json")])
    got = quant_ab.main(["--out", corpus["port"], "--ckpt", stage_b[1],
                         "--stage_c", "--json", str(tmp_path / "port.json"),
                         "--device", "cpu"])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    assert set(got) == set(want) == {"ckpt", "fp32", "int8", "delta"}
    for arm in ("fp32", "int8"):
        w, g = want[arm], got[arm]
        assert set(g) == set(w) and {"R@50", "rel_mAP", "n_gt"} < set(g)
        assert g["n_pairs"] == w["n_pairs"] > 0 and g["n_gt"] == w["n_gt"] > 0
        assert abs(g["pred_mAP"] - w["pred_mAP"]) <= 1e-6
        for k in set(g) - {"pred_mAP"}:
            assert g[k] == pytest.approx(w[k], rel=0, abs=1e-12), (arm, k)
    assert set(got["delta"]) == set(want["delta"])
    for k, v in got["delta"].items():
        assert v == got["int8"][k] - got["fp32"][k]
        assert abs(v - want["delta"][k]) <= 2e-6


def test_quant_ab_refuses_another_depth(stage_b, monkeypatch):
    """A res50 scorer on the res10 checkpoint: JAX's tool loads the layers
    the two share; the port's raises, naming both depths, before it builds
    anything."""
    _recipe(monkeypatch)
    assert parity_run.HP["depth"] == 50
    ckpt_dir, step = os.path.dirname(stage_b[1]), 1
    assert quant_ab.checkpoint_depth(ckpt_dir, step) == 10
    with pytest.raises(ValueError, match="res10 trunk.*builds res50"):
        quant_ab.build_scorer(ckpt_dir, step, False, "", "cpu")


# -- the verdicts chip_smoke.py prints ----------------------------------------

@pytest.fixture(scope="module")
def bench():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _verdict(ok, why):
    return "PASS" if ok else "VOID" if "VOID" in why else "FAIL"


@pytest.mark.parametrize("base,rows,fp,d_trunk,fc", [
    (0.30, {"pre512_rpn128_det8": 0.295, "pre1024_rpn128_det8": 0.2},
     [0.3, 0.2], [-0.005, 0.0], (0.4, -0.009, 0.0)),
    (0.30, {"pre512_rpn128_det8": 0.2, "pre1024_rpn128_det8": 0.2},
     [0.3, 0.2], [-0.02, 0.0], (0.4, -0.011, 0.0)),
    (0.10, {"pre512_rpn128_det8": 0.1, "pre1024_rpn128_det8": 0.1},
     [0.3, 0.1], [0.0, 0.0], (0.1, 0.0, 0.0)),
    (0.30, {"pre512_rpn128_det8": 0.1, "pre1024_rpn128_det8": 0.29},
     [0.3, 0.16], [0.01, 0.02], (0.4, 0.0, -0.02))])
def test_gate_verdicts_match_bench(bench, tmp_path, base, rows, fp,
                                   d_trunk, fc):
    """``chip_smoke.gate_verdicts`` against ``bench.py``'s gate functions on
    the same artifacts."""
    capacity = {chip_smoke.GATE_BASE: {"mAP": base},
                **{k: {"mAP": v} for k, v in rows.items()}}
    trunk = {"mode": "mxu:" + chip_smoke.INT8_SCOPE,
             "fp": {"MVRD": {"mAP": fp[0]}, "MVidVRD": {"mAP": fp[1]}},
             "delta": {"MVRD": d_trunk[0], "MVidVRD": d_trunk[1]}}
    quant = {"fp32": {"pred_mAP": fc[0], "top1_acc": 0.5},
             "delta": {"pred_mAP": fc[1], "top1_acc": fc[2]}}
    paths = {}
    for name, body in (("capacity", {"results": capacity}),
                       ("trunk", trunk), ("quant", quant)):
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(body, f)
    import argparse
    args = argparse.Namespace(pre_nms=1024, rpn_topn=128)
    ok, why, _, _ = bench._gate_rpn_capacity(args, paths=(paths["capacity"],))
    want = {"rpn_capacity": _verdict(ok, why),
            "det8": _verdict(*bench._gate_det8(args, paths["capacity"])),
            "int8_trunk": _verdict(*bench._gate_int8trunk(
                paths["trunk"])[:2]),
            "int8_fc": _verdict(*bench._gate_int8(paths["quant"]))}
    got = chip_smoke.gate_verdicts(capacity, trunk, quant)
    assert {k: v["verdict"] for k, v in got.items()} == want
