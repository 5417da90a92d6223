"""The port's drivers and what they read, against the JAX package on the
CPU: ``cfg_from_file`` on ``cfgs/*.yml``, ``parse_args`` /
``set_dataset_args``, ``combined_roidb`` on the fixture datasets of
tests/fixtures.py, the PNG decoder against cv2 (the JPEG decoder has
tests/test_torch_jpeg.py), the cv2-free resize (``prep_image`` within
1e-4, ``prep_image_u8`` bit-equal), the ``DetectionLoader`` (on the MVidVRD
PNG frames and on the MVRD JPEG stills), the checkpoint format, the
predicate vectors' fallback, ``voc_eval``, and ``serve_video``, ``test_sgg``
and ``test_det`` of both packages end to end (the last two on the MVidVRD
and on the MVRD test split) at res10 on 96 px frames (``TINY`` below, the
``TINY_CFG`` of tests/test_drivers_e2e.py), on one set of weights: JAX's
init saved with JAX's ``save_checkpoint`` and converted by
``tools/jax_to_torch_checkpoint.py``. Random weights tie, so the box
deltas are scaled by 0.1 and the class logits by 40 (as the earlier port
tests do). Each package reads its own copy of the fixture datasets and
builds its own gt_roidb cache from the XML; the roidb test also has each
read the other's cache. The serving levers run through both drivers too:
``serve_video --bf16_weights --int8_fc6`` and ``test_det --int8_trunk
mxu:<scope> --act_scales <calibration>``.

The int8 trunk's calibration and quality gate run on the same weights and
datasets:

* the whole res10 detector under ``I2VSGG_INT8_CALIB`` (f32) over two
  batches of the MVidVRD test frames: the same keys as JAX's
  ``flatten_absmax(intermediates)``, values within rtol 1e-5 (f32 convs sum
  in another order in XLA and oneDNN); the record is no parameter or
  buffer;
* ``test_det --int8_trunk sim:<scope> --act_scales <file>`` of both
  packages, with ``test_test_det_int8_trunk_matches_jax``'s bounds (scores
  rtol 1e-4, APs equal, boxes within 0.25 px); then ``mxu`` in the same
  process removes ``I2VSGG_INT8_PREQ_SIM``, which JAX leaves set;
* ``calibrate_act_scales`` of both packages on one checkpoint and devkit
  (``COMPUTE_DTYPE float32``): the same keys and ``n_images``, scales
  within rtol 1e-5; the port refuses ``I2VSGG_PALLAS_BOTTLENECK=1``;
* ``quant_trunk_ab`` of both: the same fp and int8 mAPs and ``delta`` (each
  evaluation given ``--compute_dtype float32``, as the other driver tests
  run); the port's ``--reuse_fp`` copies a matching fp arm and refuses a
  rewritten checkpoint.

The drivers' per-frame arrays are read where both packages hand them to
``detection_output`` (recorded, then passed on). Tolerances: detections'
classes, validity and pairs exact; boxes rtol 1e-5, detection scores and
relation probabilities rtol 1e-4 (serve_video, whose detector sums f32 in
another order), ``test_sgg``'s per-pair probabilities rtol 1e-5, each with
an atol of the same fraction of the largest magnitude; ``test_sgg``'s
metrics and ``test_det``'s APs equal. Under the int8 levers: relation
probabilities within 5e-3 (int8 fc6) and boxes within 0.25 px (the int8
trunk), as their tests say.
"""

import dataclasses
import json
import os
import pickle
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp
from PIL import Image

from tests.fixtures import make_fixture_root
from tests.make_decode_fixtures import png_image

from i2vsgg_tpu import config as jax_config
from i2vsgg_tpu.cli import args as jax_args
from i2vsgg_tpu.data import pipeline as jax_pipeline
from i2vsgg_tpu.data import roidb as jax_roidb
from i2vsgg_tpu.eval import voc_eval as jax_voc_eval
from i2vsgg_tpu.models.backbones import ResNetTrunk as JaxResNetTrunk
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.models.sgg import SGGModel as JaxSGGModel
from i2vsgg_tpu.models.sgg import VRDHead as JaxVRDHead
from i2vsgg_tpu.train import checkpoint as jax_ckpt
from i2vsgg_tpu.train.det_da import TrainState
from i2vsgg_tpu.video import metrics as jax_metrics
from i2vsgg_tpu_torch import config
from i2vsgg_tpu_torch import serve
from i2vsgg_tpu_torch.cli import args as port_args
from i2vsgg_tpu_torch.data import image_io, pipeline, roidb
from i2vsgg_tpu_torch.eval import voc_eval
from i2vsgg_tpu_torch.models import backbones as bb
from i2vsgg_tpu_torch.models import glove
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.models.layers import init_weights
from i2vsgg_tpu_torch.models.sgg import VRDHead
from i2vsgg_tpu_torch.tools import calibrate_act_scales, quant_trunk_ab
from i2vsgg_tpu_torch.tools import test_det as port_test_det
from i2vsgg_tpu_torch.train import checkpoint
from i2vsgg_tpu_torch.utils.params import quantize_trunk_params
from i2vsgg_tpu_torch.video import metrics as port_metrics
from tools import calibrate_act_scales as jax_calibrate
from tools import jax_to_torch_checkpoint
from tools import quant_trunk_ab as jax_quant_trunk_ab
from tools import serve_video as jax_serve_video
from tools import test_det as jax_test_det
from tools import test_sgg as jax_test_sgg
from tools.trainval_sgg import load_predicate_vectors as jax_prd_vectors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_FILES = ("res101", "res101_ls", "res50", "vgg16")
N_REL, MD = 7, 4
TINY = ["--cfg",
        "TEST.RPN_PRE_NMS_TOP_N", "100",
        "TEST.RPN_POST_NMS_TOP_N", "16",
        "TEST.MAX_DETECTIONS_PER_IMAGE", "20",
        "TRAIN.MAX_NUM_GT_BOXES", "6",
        "TRAIN.SCALES", "[96]",
        "TEST.SCALES", "[96]"]
COMMON = ["--dataset", "MVidVRD", "--net", "res10", "--bs", "2",
          "--num_relations", str(N_REL), "--compute_dtype", "float32",
          "--vrd_fc_dim", "128"] + TINY


def close(got, exp, rtol, atol=None):
    exp = np.asarray(exp, np.float64)
    atol = rtol if atol is None else atol
    scale = float(np.abs(exp).max()) if exp.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), exp, rtol=rtol,
                               atol=atol * max(scale, 1.0))


def _set_data_root(root):
    if root is None:
        os.environ.pop("I2VSGG_DATA_ROOT", None)
    else:
        os.environ["I2VSGG_DATA_ROOT"] = root


@pytest.fixture(scope="module")
def data_roots(tmp_path_factory):
    """Two copies of the fixture datasets (tests/fixtures.py is seeded, so
    they are equal): ``jax``, which only the JAX package reads, and
    ``port``, which only the port reads (``I2VSGG_DATA_ROOT`` points there
    by default), so that each package builds its gt_roidb cache from the
    XML itself."""
    roots = {pkg: make_fixture_root(str(tmp_path_factory.mktemp(
        "data_" + pkg)), n_rel=N_REL) for pkg in ("jax", "port")}
    old = os.environ.get("I2VSGG_DATA_ROOT")
    _set_data_root(roots["port"]["root"])
    yield roots
    _set_data_root(old)


@pytest.fixture(scope="module")
def data_root(data_roots):
    return data_roots["port"]


# -- config and command line ------------------------------------------------

@pytest.mark.parametrize("name", CFG_FILES)
def test_cfg_from_file_matches_jax(name):
    path = os.path.join(ROOT, "cfgs", f"{name}.yml")
    got = config.cfg_from_file(path)
    exp = jax_config.cfg_from_file(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(exp)
    # and through the drivers' cfg_from_list on top
    pairs = ["TEST.RPN_POST_NMS_TOP_N", "128", "TEST.SCALES", "[600]"]
    assert dataclasses.asdict(config.cfg_from_list(pairs, got)) == \
        dataclasses.asdict(jax_config.cfg_from_list(pairs, exp))


@pytest.mark.parametrize("text, what", [
    ("TRAIN:\n  - 1\n", "of the subset"),
    ("TRAIN: &a {X: 1}\n", "outside the subset"),
    ("TRAIN:\n\tSCALES: [1]\n", "tab"),
    ("A: 1\nA: 2\n", "duplicate"),
    ("A: 0x10\n", "numeric form"),
    ("TRAIN:\n   X: 1\n  Y: 2\n", "indentation"),
])
def test_yaml_subset_refuses_what_it_does_not_read(tmp_path, text, what):
    path = tmp_path / "bad.yml"
    path.write_text(text)
    with pytest.raises(config.YamlSubsetError, match=what) as e:
        config.read_yaml_subset(str(path))
    assert f"{path}:" in str(e.value)


ARGVS = [
    COMMON + ["--ic", "--gc"],
    ["--dataset", "MVRD", "--net", "vgg16", "--ls", "--cag",
     "--vrd_task", "pre_det", "--use_obj_visual", "false",
     "--int8_trunk", "mxu:layer3,@3x3", "--act_scales", "s.json"],
    ["--dataset", "MVidOR", "--int8_trunk", "--uint8_upload",
     "--cfg", "POOLING_MODE", "pool"],
    ["--dataset", "MVG", "--int8_trunk", "sim"],
    ["--int8_trunk", "sim:layer3", "--act_scales", "s.json"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_matches_jax(argv, monkeypatch):
    monkeypatch.setenv("I2VSGG_INT8_TRUNK", "stale")
    env = []
    for mod in (jax_args, port_args):
        a = mod.set_dataset_args(mod.parse_args(argv), test=True)
        env.append(os.environ.get("I2VSGG_INT8_TRUNK"))
        os.environ["I2VSGG_INT8_TRUNK"] = "stale"
        if mod is jax_args:
            exp = vars(a)
        else:
            got = vars(a)
    assert got.pop("device") == "cuda"
    assert got == exp
    assert env[0] == env[1]


# -- data --------------------------------------------------------------------

def _same_roidb(got, exp, root_got, root_exp):
    """Two combined_roidb results field by field; image paths relative to
    their data roots."""
    assert got[0].classes == exp[0].classes
    np.testing.assert_array_equal(got[2], exp[2])
    np.testing.assert_array_equal(got[3], exp[3])
    assert len(got[1]) == len(exp[1])
    for a, b in zip(got[1], exp[1]):
        assert set(a) == set(b)
        for k in a:
            if k == "image":
                assert (os.path.relpath(a[k], root_got)
                        == os.path.relpath(b[k], root_exp))
            elif isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("name", ["MVidVRD_test", "MVRD_test"])
def test_combined_roidb_matches_jax(tmp_path, monkeypatch, name):
    """Each package parses the XML of its own copy of the devkit (no cache
    there before), and the two roidbs agree field by field. Then, with the
    XML deleted, each package reads the cache the other wrote, and gets
    the same roidb again: the cache holds numpy only and is shared."""
    ds = name.split("_")[0]
    roots, parsed = {}, {}
    for pkg, mod in (("port", roidb), ("jax", jax_roidb)):
        roots[pkg] = make_fixture_root(str(tmp_path / pkg), n_rel=N_REL)[
            "root"]
        cache = os.path.join(roots[pkg], ds, "cache", name + "_gt_roidb.pkl")
        assert not os.path.exists(cache)
        monkeypatch.setenv("I2VSGG_DATA_ROOT", roots[pkg])
        parsed[pkg] = mod.combined_roidb(name, training=False,
                                         use_flipped=False)
        assert os.path.exists(cache)
    assert len(parsed["port"][1]) == (12 if "Vid" in name else 8)
    assert all(len(r["boxes"]) > 0 for r in parsed["port"][1])
    _same_roidb(parsed["port"], parsed["jax"], roots["port"], roots["jax"])
    for pkg in roots:
        shutil.rmtree(os.path.join(roots[pkg], ds, "Annotations"))
    for pkg, mod, other in (("port", roidb, "jax"), ("jax", jax_roidb,
                                                      "port")):
        monkeypatch.setenv("I2VSGG_DATA_ROOT", roots[other])
        cached = mod.combined_roidb(name, training=False, use_flipped=False)
        _same_roidb(cached, parsed[pkg], roots[other], roots[pkg])


def _png_cases(d):
    """PNGs written by cv2 and PIL (RGB, grey, RGBA, palette, grey+alpha;
    their encoders choose the row filters) and by ``write_png`` with each
    filter type, on a random and a smooth image."""
    rs = np.random.RandomState(0)
    images = {"rand": rs.randint(0, 256, (29, 41, 3)).astype(np.uint8),
              "smooth": (np.cumsum(rs.randint(0, 5, (36, 50, 3)), axis=1)
                         % 256).astype(np.uint8)}
    cases = []
    for name, bgr in images.items():
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        writers = {
            "cv2": lambda p: cv2.imwrite(p, bgr),
            "pil_rgb": lambda p: Image.fromarray(rgb).save(p),
            "pil_grey": lambda p: Image.fromarray(bgr[..., 0]).save(p),
            "pil_rgba": lambda p: Image.fromarray(
                np.dstack([rgb, bgr[..., 1]]), "RGBA").save(p),
            "pil_palette": lambda p: Image.fromarray(rgb).convert(
                "P", palette=Image.ADAPTIVE).save(p),
            "pil_grey_alpha": lambda p: Image.fromarray(
                bgr[..., 0]).convert("LA").save(p),
        }
        for ft in range(5):
            writers[f"filter{ft}"] = (
                lambda p, ft=ft: image_io.write_png(p, bgr, ft))
        for kind, write in writers.items():
            path = os.path.join(d, f"{name}_{kind}.png")
            write(path)
            cases.append(path)
    return cases


def _filters_used(path):
    data = open(path, "rb").read()
    w, h, _, ctype = struct.unpack(">IIBB", data[16:26])
    idat = b"".join(body for t, body in image_io._png_chunks(data, path)
                    if t == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


def test_png_decode_equals_cv2(tmp_path):
    used = set()
    cases = _png_cases(str(tmp_path))
    for path in cases:
        got = image_io.imread_bgr(path)
        exp = cv2.imread(path, cv2.IMREAD_COLOR)
        assert got.dtype == np.uint8 and got.shape == exp.shape, path
        assert np.array_equal(got, exp), path
        with Image.open(path) as im:
            assert image_io.image_size(path) == im.size
        used |= _filters_used(path)
    assert used == {0, 1, 2, 3, 4}       # every row filter was decoded


def test_undecodable_images_raise(tmp_path, data_root):
    """A baseline JPEG (the fixture's MVRD stills) decodes as cv2 decodes
    it, and so do a progressive JPEG and 16-bit and Adam7-interlaced PNG,
    which the port refused before it read them; a non-interlaced stream
    labelled Adam7 is corrupt (``ValueError``); a lossless arithmetic-coded
    JPEG and other formats raise ``UnsupportedImageError``."""
    jpg = os.path.join(data_root["root"], "MVRD", "JPEGImages",
                       "img000.jpg")
    with Image.open(jpg) as im:
        assert image_io.image_size(jpg) == im.size
    assert np.array_equal(image_io.imread_bgr(jpg),
                          cv2.imread(jpg, cv2.IMREAD_COLOR))
    prog = str(tmp_path / "progressive.jpg")
    cv2.imwrite(prog, cv2.imread(jpg), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with Image.open(prog) as im:
        assert image_io.image_size(prog) == im.size
    assert np.array_equal(image_io.imread_bgr(prog),
                          cv2.imread(prog, cv2.IMREAD_COLOR))
    p16 = str(tmp_path / "deep.png")
    cv2.imwrite(p16, np.full((4, 5, 3), 1000, np.uint16))
    assert np.array_equal(image_io.imread_bgr(p16),
                          cv2.imread(p16, cv2.IMREAD_COLOR))
    pint = str(tmp_path / "interlaced.png")
    open(pint, "wb").write(png_image(
        np.arange(9 * 11 * 3).reshape(9, 11, 3) % 256, 2, 8, interlace=1))
    assert np.array_equal(image_io.imread_bgr(pint),
                          cv2.imread(pint, cv2.IMREAD_COLOR))
    image_io.write_png(pint, np.zeros((8, 8, 3), np.uint8))
    data = bytearray(open(pint, "rb").read())
    data[28] = 1                                    # IHDR interlace: Adam7
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(pint, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="expected") as e:
        image_io.imread_bgr(pint)
    assert not isinstance(e.value, image_io.UnsupportedImageError)
    arith = str(tmp_path / "arithmetic.jpg")
    open(arith, "wb").write(sof11(open(jpg, "rb").read()))
    with pytest.raises(image_io.UnsupportedImageError, match="arithmetic"):
        image_io.imread_bgr(arith)
    bmp = str(tmp_path / "x.bmp")
    cv2.imwrite(bmp, np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(image_io.UnsupportedImageError):
        image_io.imread_bgr(bmp)
    with pytest.raises(FileNotFoundError):
        image_io.imread_bgr(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("hw", [(96, 128), (240, 320), (360, 640),
                                (375, 500), (720, 1280)])
def test_prep_image_matches_jax(hw):
    im = np.random.RandomState(hw[0]).randint(0, 256, (*hw, 3)).astype(
        np.uint8)
    means = config.Config().PIXEL_MEANS
    got, s = pipeline.prep_image(im, 600, means)
    exp, s_j = jax_pipeline.prep_image(im, 600, means)
    assert s == s_j and got.shape == exp.shape
    close(got, exp, 0.0, 1e-4 / max(float(np.abs(exp).max()), 1.0))
    got_u8, _ = pipeline.prep_image_u8(im, 600)
    exp_u8, _ = jax_pipeline.prep_image_u8(im, 600)
    assert np.array_equal(got_u8, exp_u8)


def test_prep_image_u8_residue_at_a_large_upscale():
    """At a ~10x upscale cv2's fixed point rounds a few values otherwise:
    the stated residue is one step on under 0.1 % of the values."""
    im = np.random.RandomState(1).randint(0, 256, (61, 77, 3)).astype(
        np.uint8)
    got, _ = pipeline.prep_image_u8(im, 600)
    exp, _ = jax_pipeline.prep_image_u8(im, 600)
    diff = np.abs(got.astype(int) - exp)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def _same_batches(got, exp, key, exact):
    for a, b in zip(got, exp):
        assert set(a) == set(b)
        for k in ("im_info", "gt_boxes", "num_boxes", "indices"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
        if exact:
            assert np.array_equal(a[key], b[key])
        else:
            close(a[key], b[key], 0.0, 1e-4 / float(np.abs(b[key]).max()))


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("uint8", [False, True])
def test_detection_loader_matches_jax(data_root, uint8, native):
    """Batches of 5 over the 12 video frames (a ragged last batch),
    resized to 120 rows (scale 1.25). Both packages' Python paths, or both
    native runtimes (bit-equal; the uint8 transport turns them off in both
    packages)."""
    cfg = config.cfg_from_list(["TEST.SCALES", "[120]"])
    cfg_j = jax_config.cfg_from_list(["TEST.SCALES", "[120]"])
    _, rdb, _, idx = roidb.combined_roidb("MVidVRD_test", training=False,
                                          use_flipped=False)
    loader = pipeline.DetectionLoader(rdb, idx, cfg, 5, training=False,
                                      native=native, uint8_transport=uint8)
    loader_j = jax_pipeline.DetectionLoader(rdb, idx, cfg_j, 5,
                                            training=False, native=native,
                                            uint8_transport=uint8)
    assert loader.native == loader_j.native == (native and not uint8)
    got, exp = list(loader), list(loader_j)
    assert len(got) == len(exp) == 3
    _same_batches(got, exp, "image_u8" if uint8 else "image",
                  exact=uint8 or native)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("uint8", [False, True])
def test_detection_loader_matches_jax_on_jpeg_stills(data_root, uint8,
                                                     native):
    """The source domain: batches of 3 over the 8 MVRD stills (JPEG, 4:2:0,
    written by PIL; a ragged last batch), resized to 120 rows. JAX's Python
    path decodes with cv2, the port's with its own decoder; JAX's runtime
    with libjpeg, the port's with the same decoder (bit-equal)."""
    cfg = config.cfg_from_list(["TEST.SCALES", "[120]"])
    cfg_j = jax_config.cfg_from_list(["TEST.SCALES", "[120]"])
    _, rdb, _, idx = roidb.combined_roidb("MVRD_test", training=False,
                                          use_flipped=False)
    assert all(e["image"].endswith(".jpg") for e in rdb)
    loader = pipeline.DetectionLoader(rdb, idx, cfg, 3, training=False,
                                      native=native, uint8_transport=uint8)
    loader_j = jax_pipeline.DetectionLoader(rdb, idx, cfg_j, 3,
                                            training=False, native=native,
                                            uint8_transport=uint8)
    assert loader.native == loader_j.native == (native and not uint8)
    got, exp = list(loader), list(loader_j)
    assert len(got) == len(exp) == 3
    _same_batches(got, exp, "image_u8" if uint8 else "image",
                  exact=uint8 or native)


@pytest.mark.parametrize("gt_truncate", ["shuffle", "first"])
def test_training_loader_native_matches_jax_on_jpeg_stills(data_root,
                                                           gt_truncate):
    """The training branch on the native runtime against JAX's, bit for
    bit: the MVRD stills with their flipped copies, aspect-grouped batches
    of 2 in the order of seed 5, at TRAIN scale 96, GT rows truncated to 2
    (shuffled or kept in order)."""
    opts = ["TRAIN.SCALES", "[96]", "TRAIN.MAX_NUM_GT_BOXES", "2"]
    cfg = config.cfg_from_list(opts)
    cfg_j = jax_config.cfg_from_list(opts)
    _, rdb, _, idx = roidb.combined_roidb("MVRD_trainval", use_flipped=True)
    _, rdb_j, _, idx_j = jax_roidb.combined_roidb("MVRD_trainval",
                                                  use_flipped=True)
    np.testing.assert_array_equal(idx, idx_j)
    assert any(e["flipped"] for e in rdb)
    assert any(len(e["boxes"]) > 2 for e in rdb)
    loader = pipeline.DetectionLoader(rdb, idx, cfg, 2, training=True,
                                      seed=5, native=True,
                                      gt_truncate=gt_truncate)
    loader_j = jax_pipeline.DetectionLoader(rdb_j, idx_j, cfg_j, 2,
                                            training=True, seed=5,
                                            native=True,
                                            gt_truncate=gt_truncate)
    assert loader.native and loader_j.native
    got, exp = list(loader), list(loader_j)
    assert len(got) == len(exp) == len(rdb) // 2
    _same_batches(got, exp, "image", exact=True)


def sof11(data: bytes) -> bytes:
    """A baseline JPEG with its SOF0 marker made SOF11 (lossless
    arithmetic coding), a mode the port still refuses."""
    out = bytearray(data)
    out[data.index(b"\xff\xc0") + 1] = 0xCB
    return bytes(out)


def test_loader_raises_on_an_undecodable_image(tmp_path, monkeypatch):
    """The loader's prefetch thread re-raises a decode error in the
    consumer: here a lossless arithmetic-coded JPEG among the MVRD
    stills."""
    root = make_fixture_root(str(tmp_path), n_rel=N_REL)["root"]
    jpg = os.path.join(root, "MVRD", "JPEGImages", "img001.jpg")
    data = open(jpg, "rb").read()
    open(jpg, "wb").write(sof11(data))
    monkeypatch.setenv("I2VSGG_DATA_ROOT", root)
    _, rdb, _, idx = roidb.combined_roidb("MVRD_test", training=False,
                                          use_flipped=False)
    loader = pipeline.DetectionLoader(rdb, idx, config.Config(), 2,
                                      training=False)
    with pytest.raises(image_io.UnsupportedImageError, match="arithmetic"):
        next(iter(loader))


# -- checkpoints, vectors, VOC eval --------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    head = init_weights(VRDHead(emb_dim=16, fc_dim=32),
                        torch.Generator().manual_seed(0))
    d = str(tmp_path / "ck")
    assert checkpoint.latest_step(d) is None
    checkpoint.save_checkpoint(d, head.state_dict(), 3,
                               {"vrd_pooling": "align"}, metric=0.5)
    checkpoint.save_checkpoint(d, head.state_dict(), 12, {}, metric=0.25)
    os.makedirs(os.path.join(d, "step_7.bak"))
    assert checkpoint.latest_step(d) == 12
    assert checkpoint.best_checkpoint(d)["step"] == 3
    assert checkpoint.load_metadata(d, 3) == {"vrd_pooling": "align"}
    other = VRDHead(emb_dim=16, fc_dim=32)
    with torch.no_grad():
        for p in other.parameters():
            p.zero_()
    stats = checkpoint.restore_intersection(d, 3, other)
    assert stats["copied"] == stats["named"] == stats["total"]
    for k, v in head.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    # a shape change stays at init; a model the checkpoint barely names
    # raises below min_match, and loads with min_match=0
    wider = VRDHead(emb_dim=16, fc_dim=64)
    stats = checkpoint.restore_intersection(d, 3, wider)
    assert stats["copied"] < stats["named"] == stats["total"]
    big = VRDHead(emb_dim=16, fc_dim=32, spatial_type=0,
                  use_obj_visual=False)
    extra = torch.nn.Module()
    extra.vrd, extra.more = big, VRDHead(emb_dim=16, fc_dim=32)
    with pytest.raises(ValueError, match="names only"):
        checkpoint.restore_intersection(d, 3, extra)
    assert checkpoint.restore_intersection(d, 3, extra, min_match=0)[
        "named"] == 0


def test_predicate_vectors_match_jax(tmp_path):
    a = port_args.parse_args(["--num_relations", "26", "--glove_path",
                              str(tmp_path / "none.txt")])
    np.testing.assert_array_equal(glove.load_predicate_vectors(a),
                                  jax_prd_vectors(a))
    # with a GloVe file (the JAX driver cannot take this branch: it calls
    # get_obj_prd_vecs without the object list its signature requires)
    words = ["on", "next", "to", "ride", "sit", "behind", "person"]
    rs = np.random.RandomState(0)
    gpath = tmp_path / "glove.txt"
    gpath.write_text("".join(
        w + " " + " ".join(f"{v:.5f}" for v in rs.randn(300)) + "\n"
        for w in words))
    ppath = tmp_path / "predicates.json"
    ppath.write_text(json.dumps(["on", "next_to", "ride", "sit-behind",
                                 "unknownword"]))
    a.glove_path, a.predicate_file = str(gpath), str(ppath)
    from i2vsgg_tpu.models.glove import get_obj_prd_vecs
    _, exp = get_obj_prd_vecs(str(gpath), str(ppath), ["person"])
    np.testing.assert_array_equal(glove.load_predicate_vectors(a), exp)


def test_voc_eval_matches_jax(data_root, tmp_path):
    devkit = os.path.join(data_root["root"], "MVidVRD")
    names = [f"vid{v:02d}_{f:04d}" for v in range(2) for f in range(6)]
    anno = os.path.join(devkit, "Annotations", "{}.xml")
    for n in names:
        assert voc_eval.parse_rec(anno.format(n)) == \
            jax_voc_eval.parse_rec(anno.format(n))
    rs = np.random.RandomState(5)
    det = tmp_path / "det.txt"
    lines = []
    for n in names:
        for o in voc_eval.parse_rec(anno.format(n)):
            x1, y1, x2, y2 = np.asarray(o["bbox"]) + rs.randint(-6, 7, 4)
            lines.append(f"{n} {rs.rand():.3f} {x1} {y1} {x2} {y2}")
    det.write_text("\n".join(lines) + "\n")
    for cls in ("person", "dog", "car"):
        got = voc_eval.voc_eval(str(det), anno, names, cls,
                                str(tmp_path / "c1"))
        exp = jax_voc_eval.voc_eval(str(det), anno, names, cls,
                                    str(tmp_path / "c2"))
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g, e)


# -- the drivers ---------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(data_root, tmp_path_factory):
    """One set of weights for both packages: JAX's init of the res10
    detector (16 classes, ic+gc) and of the SGG model (its trunk, a head of
    width 128), saved by JAX's save_checkpoint, converted to the port's
    format."""
    d = str(tmp_path_factory.mktemp("ckpt"))
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
    g, z = 6, jnp.zeros
    sgg = JaxSGGModel(trunk=JaxResNetTrunk(depth=10, dtype=jnp.float32),
                      vrd=JaxVRDHead(emb_dim=300, fc_dim=128), n_rel=N_REL)
    sp = jax.jit(lambda k: sgg.init(
        {"params": k}, z((1, 64, 80, 3)), jnp.asarray([64, 80, 1.0]),
        z((g, 4)), z((g,), jnp.int32), z((g * (g - 1),), jnp.int32),
        z((g * (g - 1),), jnp.int32), z((g * (g - 1),), bool),
        z((N_REL, 300)))["params"])(jax.random.PRNGKey(4))
    sp = jax.tree_util.tree_map(np.array, sp)
    sp["trunk"] = p["trunk"]
    out = {}
    for name, tree, meta in (("det", p, {"pooling_mode": "align"}),
                             ("sgg", sp, {"vrd_pooling": "pool"})):
        jdir, tdir = os.path.join(d, "jax_" + name), os.path.join(d, name)
        jax_ckpt.save_checkpoint(jdir, TrainState(tree, {}, z((), jnp.int32)),
                                 1, metadata=meta)
        jax_to_torch_checkpoint.main([os.path.join(jdir, "1"), tdir])
        assert checkpoint.load_metadata(tdir, 1) == meta
        out[name] = (os.path.join(jdir, "1"), os.path.join(tdir, "1"))
    out["dir"] = d
    return out


class Recorder:
    """Records the arguments of each ``detection_output`` call (one a
    frame), then runs it."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *a, **k):
        self.calls.append([np.array(x) for x in a])
        return self.fn(*a, **k)


def _run_both(monkeypatch, roots, jax_main, jax_mod, port_main, port_mod,
              argv_j, argv_p, n_frames=12):
    """Each package's driver on its own copy of the datasets, with the
    ``detection_output`` calls recorded (one for each of ``n_frames``)."""
    rec_j = Recorder(jax_mod.detection_output)
    rec_p = Recorder(port_mod.detection_output)
    monkeypatch.setattr(jax_mod, "detection_output", rec_j)
    monkeypatch.setattr(port_mod, "detection_output", rec_p)
    monkeypatch.setenv("I2VSGG_DATA_ROOT", roots["jax"]["root"])
    exp = jax_main(argv_j)
    monkeypatch.setenv("I2VSGG_DATA_ROOT", roots["port"]["root"])
    got = port_main(argv_p)
    assert len(rec_j.calls) == len(rec_p.calls) == n_frames
    return exp, got, rec_j.calls, rec_p.calls


def _same_frames(path_j, path_p, rtol=1e-4, videos=("vid00", "vid01")):
    """The two frame_detections.json: same videos and frames, and per frame
    the same relation triplets (every tuple is kept: 12 pairs x 7
    predicates < top 100)."""
    a, b = json.load(open(path_j)), json.load(open(path_p))
    assert set(a) == set(b) == set(videos)
    for vid in a:
        assert [f for f, _ in a[vid]] == [f for f, _ in b[vid]]
        for (_, ta), (_, tb) in zip(a[vid], b[vid]):
            assert len(ta) == len(tb) > 0
            assert sorted(t[1] for t in ta) == sorted(t[1] for t in tb)
            close(sorted(t[0] for t in tb), sorted(t[0] for t in ta), rtol)


def _serve_both(weights, roots, monkeypatch, extra, tag, tol):
    """serve_video of both packages with ``extra`` flags: per frame the same
    classes and pairs, boxes within rtol 1e-5, scores and relation
    probabilities within ``tol``; the same frame_detections.json keys and
    triplets."""
    from i2vsgg_tpu_torch.tools import serve_video
    d = weights["dir"]
    args = COMMON + ["--ic", "--gc", "--max_det", str(MD)] + extra
    exp, got, calls_j, calls_p = _run_both(
        monkeypatch, roots, jax_serve_video.main, jax_metrics,
        serve_video.main, serve,
        args + ["--save_dir", os.path.join(d, "out_jax" + tag),
                "--load_name", weights["det"][0],
                "--sgg_load_name", weights["sgg"][0]],
        args + ["--save_dir", os.path.join(d, "out_port" + tag),
                "--load_name", weights["det"][1],
                "--sgg_load_name", weights["sgg"][1], "--device", "cpu"])
    n_pairs = 0
    for cj, cp in zip(calls_j, calls_p):
        rel_j, boxes_j, cls_j, sc_j, i1_j, i2_j = cj
        rel_p, boxes_p, cls_p, sc_p, i1_p, i2_p = cp
        for x, y in ((cls_j, cls_p), (i1_j, i1_p), (i2_j, i2_p)):
            np.testing.assert_array_equal(y, x)
        close(boxes_p, boxes_j, 1e-5)
        close(sc_p, sc_j, tol)
        close(rel_p, rel_j, tol)
        n_pairs += len(i1_j)
    assert n_pairs > 0
    rel = os.path.join("serve", "MVidVRD_test", "frame_detections.json")
    _same_frames(os.path.join(d, "out_jax" + tag, rel),
                 os.path.join(d, "out_port" + tag, rel), tol)
    assert isinstance(got, dict) and set(got) == set(exp)
    return calls_p


def test_serve_video_matches_jax(weights, data_roots, monkeypatch):
    _serve_both(weights, data_roots, monkeypatch, [], "", 1e-4)


def test_serve_video_levers_match_jax(weights, data_roots, monkeypatch):
    """``--bf16_weights --int8_fc6``: both drivers restore the f32
    checkpoints, store the weights in bf16, then quantize fc6/fc7 to int8.
    Compute stays f32 (``--compute_dtype float32``), so the detections hold
    the f32 bounds; the relation probabilities pass through an int8
    quantization of fc6's input, where two f32 values that differ in the
    last bits can land one step apart: they are held at the res10 bound of
    tests/test_torch_int8.py, 5e-3. The port's models must come out of
    the driver's build bf16-stored with an int8 fc6."""
    from i2vsgg_tpu_torch.tools import serve_video
    quantized = []
    real = serve_video.build_serving_models

    def built(*a, **k):
        det, sgg = real(*a, **k)
        quantized.append((det.trunk.conv1.weight.dtype,
                          sgg.vrd.fc6.weight.dtype))
        return det, sgg

    monkeypatch.setattr(serve_video, "build_serving_models", built)
    calls = _serve_both(weights, data_roots, monkeypatch,
                        ["--bf16_weights", "--int8_fc6"], "_levers", 5e-3)
    assert quantized == [(torch.bfloat16, torch.int8)]
    assert len(calls) == 12


def _argv(dataset):
    """COMMON with ``--dataset dataset``."""
    argv = list(COMMON)
    argv[argv.index("--dataset") + 1] = dataset
    return argv


def _sgg_both(data_roots, weights, monkeypatch, dataset, n_frames, videos):
    """test_sgg of both packages on ``dataset``'s test split (GT boxes):
    per frame the same GT boxes, classes and pairs, the per-pair
    probabilities within rtol 1e-5; the same metrics; the same
    frame_detections.json."""
    from i2vsgg_tpu_torch.tools import test_sgg
    d = weights["dir"]
    tag = "" if dataset == "MVidVRD" else "_" + dataset
    exp, got, calls_j, calls_p = _run_both(
        monkeypatch, data_roots, jax_test_sgg.main, jax_metrics,
        test_sgg.main, port_metrics,
        _argv(dataset) + ["--video_ann", data_roots["jax"]["video_ann"],
                          "--save_dir", os.path.join(d, "out_jax" + tag),
                          "--load_name", weights["sgg"][0]],
        _argv(dataset) + ["--video_ann", data_roots["port"]["video_ann"],
                          "--save_dir", os.path.join(d, "out_port" + tag),
                          "--load_name", weights["sgg"][1],
                          "--device", "cpu"], n_frames)
    for cj, cp in zip(calls_j, calls_p):
        for k in (1, 2, 3, 4, 5):         # GT boxes, classes, confs, pairs
            np.testing.assert_array_equal(cp[k], cj[k])
        assert len(cj[4]) > 0
        close(cp[0], cj[0], 1e-5)         # the per-pair probabilities
    assert got == exp                      # mAP, recall@K, precision@K
    rel = os.path.join("eval", f"{dataset}_test_SGG", "frame_detections.json")
    _same_frames(os.path.join(d, "out_jax" + tag, rel),
                 os.path.join(d, "out_port" + tag, rel), videos=videos)


def test_test_sgg_matches_jax(data_roots, weights, monkeypatch):
    _sgg_both(data_roots, weights, monkeypatch, "MVidVRD", 12,
              ("vid00", "vid01"))


def test_test_sgg_on_jpeg_stills_matches_jax(data_roots, weights,
                                             monkeypatch):
    """The source domain's test split: the 8 MVRD stills (JPEG), each
    image its own "video" of one frame in frame_detections.json."""
    _sgg_both(data_roots, weights, monkeypatch, "MVRD", 8,
              [f"img{i:03d}" for i in range(8)])


def _det_runs(weights, roots, monkeypatch, extra, tag, dataset="MVidVRD"):
    """test_det of both packages on ``dataset``'s test split, each on its
    own datasets -> (JAX's APs, the port's)."""
    from i2vsgg_tpu_torch.tools import test_det
    d = weights["dir"]
    args = _argv(dataset) + ["--ic", "--gc"] + extra
    monkeypatch.setenv("I2VSGG_DATA_ROOT", roots["jax"]["root"])
    exp = jax_test_det.main(args + ["--save_dir", os.path.join(d, "dj" + tag),
                                    "--load_name", weights["det"][0]])
    monkeypatch.setenv("I2VSGG_DATA_ROOT", roots["port"]["root"])
    got = test_det.main(args + ["--save_dir", os.path.join(d, "dp" + tag),
                                "--load_name", weights["det"][1],
                                "--device", "cpu"])
    return exp, got


def _det_check(weights, exp, got, tag, tol, box_atol=None,
               dataset="MVidVRD"):
    """The runs of ``_det_runs``: the same APs, the same detections per
    class and image within ``tol`` (boxes within ``box_atol`` px where it
    is given) -> the port's detections."""
    d = weights["dir"]
    assert got == exp and set(got) > {"mAP"}
    dets = [pickle.load(open(os.path.join(d, x + tag, "eval",
                                          f"{dataset}_test",
                                          "detections.pkl"), "rb"))
            for x in ("dj", "dp")]
    for per_j, per_p in zip(*dets):
        for a, b in zip(per_j, per_p):
            assert a.shape == b.shape
            if box_atol is None:
                close(b, a, tol)
            else:
                np.testing.assert_allclose(b[:, :4], a[:, :4], rtol=0,
                                           atol=box_atol)
                close(b[:, 4], a[:, 4], tol)
    res = os.path.join(d, "dp" + tag, "eval", f"{dataset}_test", "adapt")
    assert os.path.exists(os.path.join(res, "det_test_person.txt"))
    return dets[1]


def _det_both(weights, roots, monkeypatch, extra, tag, tol, box_atol=None,
              dataset="MVidVRD"):
    """``_det_runs``, then ``_det_check``."""
    exp, got = _det_runs(weights, roots, monkeypatch, extra, tag, dataset)
    return _det_check(weights, exp, got, tag, tol, box_atol, dataset)


@pytest.fixture(scope="module")
def plain_det(weights, data_roots):
    """test_det of both packages on the MVidVRD test split without the
    levers, run once for the tests that read it (in whatever process or
    order they run) -> (JAX's APs, the port's)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("I2VSGG_INT8_TRUNK", raising=False)
        return _det_runs(weights, data_roots, mp, [], "")


def test_test_det_matches_jax(weights, plain_det):
    _det_check(weights, *plain_det, "", 1e-4)


def test_test_det_on_jpeg_stills_matches_jax(weights, data_roots,
                                             monkeypatch):
    """The source domain's test split: the 8 MVRD stills (JPEG)."""
    _det_both(weights, data_roots, monkeypatch, [], "_mvrd", 1e-4,
              dataset="MVRD")


def test_test_det_int8_trunk_matches_jax(weights, data_roots, monkeypatch,
                                         plain_det):
    """``--int8_trunk mxu:<scope> --act_scales <calibration>``: both drivers
    restore the checkpoint, store the scoped 3x3 convs of layer2-4 in int8
    with the calibration file's static activation scales, and drop the
    switch that set_dataset_args raised. The int8 products are exact on
    both sides and the compute is f32, but a static quantization of two
    f32 inputs that differ in their last bits can land one int8 step
    apart: the scores hold the f32 bound (rtol 1e-4) and the APs are
    equal, while a box moves by up to 0.079 px (measured): boxes are held
    within 0.25 px. The port's int8 convs must run, and the switch must be
    off after the run."""
    from i2vsgg_tpu_torch.models import backbones as port_bb
    scope = "layer2,layer3,layer4,@3x3"
    calib = os.path.join(ROOT, "runs", "calib", "act_scales_res101.json")
    n_int8 = []
    real = port_bb.int8_conv2d

    def counting(*a):
        n_int8.append(tuple(a[0].shape))
        return real(*a)

    monkeypatch.setattr(bb, "int8_conv2d", counting)
    monkeypatch.delenv("I2VSGG_INT8_TRUNK", raising=False)
    got = _det_both(weights, data_roots, monkeypatch,
                    ["--int8_trunk", "mxu:" + scope, "--act_scales", calib],
                    "_int8", 1e-4, box_atol=0.25)
    assert "I2VSGG_INT8_TRUNK" not in os.environ
    # layer2's and layer3's 3x3 on the batch, layer4's on its rois: 6
    # batches of 2 frames
    assert len(n_int8) == 3 * 6, n_int8
    plain = pickle.load(open(os.path.join(
        weights["dir"], "dp", "eval", "MVidVRD_test", "detections.pkl"),
        "rb"))
    assert any(a.shape != b.shape or not np.array_equal(a, b)
               for pa, pb in zip(got, plain) for a, b in zip(pa, pb))


# -- the int8 trunk's calibration and quality gate ----------------------------

CALIB = os.path.join(ROOT, "runs", "calib", "act_scales_res101.json")
SCOPE = "layer2,layer3,layer4,@3x3"
TINY_CFG = TINY[1:]                  # the --cfg pairs


def _tiny_cfg(mod):
    return mod.cfg_from_list(TINY_CFG + ["COMPUTE_DTYPE", "float32"],
                             mod.Config())


def test_detector_record_matches_jax(weights, data_roots, monkeypatch):
    """The res10 detector (16 classes, ic+gc, f32) on the first two batches
    of 4 MVidVRD test frames, each package on its own loader's batches
    (bit-equal: the driver tests hold them): JAX's ``flatten_absmax`` of the
    sown intermediates, maxed over the batches as its tool does, against the
    port's record. (The calibration tools' test below runs the same
    batches: JAX's eager ops then compile once.)"""
    monkeypatch.setenv("I2VSGG_INT8_CALIB", "1")
    batches = {}
    for pkg, mod, rdb in (("jax", jax_pipeline, jax_roidb),
                          ("port", None, None)):
        monkeypatch.setenv("I2VSGG_DATA_ROOT", data_roots[pkg]["root"])
        if pkg == "jax":
            _, roidb, _, idx = rdb.combined_roidb(
                "MVidVRD_test", training=False, use_flipped=False)
            loader = mod.DetectionLoader(roidb, idx, _tiny_cfg(jax_config),
                                         4, training=False)
        else:
            from i2vsgg_tpu_torch.data import pipeline, roidb as port_roidb
            _, roidb, _, idx = port_roidb.combined_roidb(
                "MVidVRD_test", training=False, use_flipped=False)
            loader = pipeline.DetectionLoader(roidb, idx, _tiny_cfg(config),
                                              4, training=False)
        batches[pkg] = [(b["image"], b["im_info"]) for b in loader][:2]
    assert len(batches["port"]) == 2
    for (a, ia), (b, ib) in zip(batches["jax"], batches["port"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)

    jm = JaxFasterRCNN(num_classes=16, cfg=_tiny_cfg(jax_config),
                       backbone="res10", ic=True, gc=True)
    params = jm.init({"params": jax.random.PRNGKey(0)},
                     jnp.zeros((1, 128, 160, 3), jnp.float32),
                     jnp.asarray([[128, 160, 1.0]], jnp.float32),
                     mode="inference")["params"]
    jdir = os.path.dirname(weights["det"][0])
    params = jax_ckpt.restore_intersection(jdir, 1, params)
    want: dict = {}
    for img, info in batches["jax"]:
        _, inter = jm.apply({"params": params}, jnp.asarray(img),
                            jnp.asarray(info), mode="inference",
                            mutable=["intermediates"])
        for path, v in jax_calibrate.flatten_absmax(
                inter["intermediates"]).items():
            want[path] = max(want.get(path, 0.0), v)

    model = FasterRCNN_DA(16, _tiny_cfg(config), "res10", ic=True, gc=True)
    init_weights(model, torch.Generator().manual_seed(0))
    checkpoint.restore_intersection(
        os.path.dirname(weights["det"][1]), 1, model)
    keys = set(model.state_dict())
    for img, info in batches["port"]:
        model.inference(torch.from_numpy(img), torch.from_numpy(info))
    got = bb.act_absmax(model)
    assert set(model.state_dict()) == keys
    # res10: layer1-3 of the trunk and layer4 of the head, 4 convs each
    assert set(got) == set(want) and len(got) == 16
    assert sum(k.startswith("head/layer4/") for k in got) == 4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_test_det_sim_matches_jax_then_mxu_drops_preq_sim(weights,
                                                          data_roots,
                                                          monkeypatch):
    """``test_det --int8_trunk sim:<scope> --act_scales <calibration>`` of
    both packages: the scoped convs stored in int8 with the file's static
    scales, convolved in fake-quant (``I2VSGG_INT8_PREQ_SIM``), held with
    the int8 driver test's bounds; no int8 product runs. Then the port's
    ``mxu`` run in the same process removes ``I2VSGG_INT8_PREQ_SIM`` and
    runs its int8 products: JAX would leave it set and serve fake-quant."""
    n_int8 = []
    real = bb.int8_conv2d

    def counting(*a):
        n_int8.append(tuple(a[0].shape))
        return real(*a)

    monkeypatch.setattr(bb, "int8_conv2d", counting)
    monkeypatch.delenv("I2VSGG_INT8_TRUNK", raising=False)
    monkeypatch.setenv("I2VSGG_INT8_PREQ_SIM", "")      # restored after
    _det_both(weights, data_roots, monkeypatch,
              ["--int8_trunk", "sim:" + SCOPE, "--act_scales", CALIB],
              "_sim", 1e-4, box_atol=0.25)
    assert os.environ["I2VSGG_INT8_PREQ_SIM"] == "1"
    assert "I2VSGG_INT8_TRUNK" not in os.environ
    assert n_int8 == []
    port_test_det.main(_argv("MVidVRD") + [
        "--ic", "--gc", "--int8_trunk", "mxu:" + SCOPE, "--act_scales",
        CALIB, "--save_dir", os.path.join(weights["dir"], "dp_mxu"),
        "--load_name", weights["det"][1], "--device", "cpu"])
    assert "I2VSGG_INT8_PREQ_SIM" not in os.environ
    # layer2's and layer3's 3x3 on the batch, layer4's on its rois: 6
    # batches of 2 frames
    assert len(n_int8) == 3 * 6


def test_calibrate_act_scales_matches_jax(weights, data_roots, monkeypatch,
                                          tmp_path):
    """Both tools on the MVidVRD test split at --bs 4 with --n_images 5:
    the count is checked before each batch, so two whole batches run and 8
    images count."""
    monkeypatch.setenv("I2VSGG_INT8_CALIB", "1")   # the JAX tool sets it
    out = {}
    for pkg, tool, ckpt in (("jax", jax_calibrate, weights["det"][0]),
                            ("port", calibrate_act_scales,
                             weights["det"][1])):
        monkeypatch.setenv("I2VSGG_DATA_ROOT", data_roots[pkg]["root"])
        path = str(tmp_path / f"{pkg}.json")
        argv = ["--ckpt", ckpt, "--dataset", "MVidVRD", "--net", "res10",
                "--n_images", "5", "--bs", "4", "--json", path,
                "--cfg", "COMPUTE_DTYPE", "float32"] + TINY_CFG
        tool.main(argv + (["--device", "cpu"] if pkg == "port" else []))
        with open(path) as f:
            out[pkg] = json.load(f)
    got, want = out["port"], out["jax"]
    assert got["n_images"] == want["n_images"] == 8
    assert got["ckpt"] == weights["det"][1]
    assert set(got["scales"]) == set(want["scales"])
    assert len(got["scales"]) == 16
    for k, v in want["scales"].items():
        np.testing.assert_allclose(got["scales"][k], v, rtol=1e-5,
                                   err_msg=k)
    # the port's file drives quantize_trunk_params of either package
    quantize_trunk_params(FasterRCNN_DA(16, _tiny_cfg(config), "res10",
                                        ic=True, gc=True), SCOPE,
                          got["scales"])


def test_calibration_refuses_the_chain_switch(monkeypatch, tmp_path):
    """Under the chain switch layer3's identity tail calls none of its
    convs, so the calibration refuses before it reads anything."""
    monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", "1")
    with pytest.raises(ValueError, match="I2VSGG_PALLAS_BOTTLENECK"):
        calibrate_act_scales.main(["--ckpt", str(tmp_path / "none" / "1"),
                                   "--net", "res10", "--device", "cpu"])


def _ab_argv(pkg, weights, roots, tmp, extra=()):
    ckpt = weights["det"][0 if pkg == "jax" else 1]
    return (["--out", str(tmp / f"out_{pkg}"), "--ckpt", ckpt,
             "--data", roots[pkg]["root"], "--net", "res10", "--dataset",
             "MVidVRD", "--rpn_topn", "16", "--pre_nms", "100",
             "--max_det", "20", "--mode", "sim:" + SCOPE, "--act_scales",
             CALIB, "--json", str(tmp / f"ab_{pkg}.json"), "--cfg"]
            + TINY_CFG + list(extra)
            + (["--device", "cpu"] if pkg == "port" else []))


def test_quant_trunk_ab_matches_jax(weights, data_roots, monkeypatch,
                                    tmp_path):
    """Both tools on one checkpoint: the fp arm, then the int8 arm under
    ``sim:<scope>`` with the calibration file; the same mAPs and delta.
    Then the port's ``--reuse_fp`` of its own file copies the fp arm and
    evaluates the int8 arm only."""
    for pkg, mod in (("jax", jax_test_det), ("port", port_test_det)):
        real = mod.main
        monkeypatch.setattr(mod, "main", lambda argv, real=real: real(
            list(argv) + ["--compute_dtype", "float32"]))
    monkeypatch.setenv("I2VSGG_DATA_ROOT", "")     # both tools set it
    monkeypatch.setenv("I2VSGG_INT8_PREQ_SIM", "")  # JAX's leaves it set
    monkeypatch.delenv("I2VSGG_INT8_TRUNK", raising=False)
    evals = []
    real_port = port_test_det.main
    monkeypatch.setattr(port_test_det, "main", lambda argv: evals.append(
        argv) or real_port(argv))
    want = jax_quant_trunk_ab.main(_ab_argv("jax", weights, data_roots,
                                            tmp_path))
    got = quant_trunk_ab.main(_ab_argv("port", weights, data_roots,
                                       tmp_path))
    assert len(evals) == 2
    for k in ("mode", "net", "act_scales"):
        assert got[k] == want[k]
    for arm in ("fp", "int8"):
        assert got[arm]["MVidVRD"]["mAP"] == want[arm]["MVidVRD"]["mAP"]
    assert got["delta"] == want["delta"]
    # random weights score an mAP of 0 here: the int8 arm's detections,
    # which each tool's last evaluation left, are held too
    dets = []
    for pkg in ("jax", "port"):
        [run] = os.listdir(tmp_path / f"out_{pkg}")
        with open(tmp_path / f"out_{pkg}" / run / "eval" / "MVidVRD_test"
                  / "detections.pkl", "rb") as f:
            dets.append(pickle.load(f))
    n = 0
    for per_j, per_p in zip(*dets):
        for a, b in zip(per_j, per_p):
            assert a.shape == b.shape
            np.testing.assert_allclose(b[:, :4], a[:, :4], rtol=0, atol=0.25)
            close(b[:, 4], a[:, 4], 1e-4)
            n += len(a)
    assert n > 0
    with open(tmp_path / "ab_port.json") as f:
        assert json.load(f)["delta"] == got["delta"]
    again = quant_trunk_ab.main(_ab_argv(
        "port", weights, data_roots, tmp_path,
        ["--reuse_fp", str(tmp_path / "ab_port.json")]))
    assert len(evals) == 3 and "--int8_trunk" in evals[-1]
    assert again["fp"] == got["fp"]
    assert again["fp_reused_from"] == str(tmp_path / "ab_port.json")
    assert again["delta"] == got["delta"]


def test_reuse_fp_refuses_a_rewritten_checkpoint(weights, tmp_path,
                                                 monkeypatch):
    """An fp arm recorded on a copy of the checkpoint; one file of the copy
    rewritten (its size and mtime change): ``--reuse_fp`` refuses before
    any evaluation. Another path, or a dataset the record lacks, is refused
    too."""
    src = os.path.dirname(weights["det"][1])
    ck = tmp_path / "ck"
    shutil.copytree(src, ck)
    ckpt = str(ck / "1")
    prev = {"ckpt": ckpt, "ckpt_fingerprint":
            quant_trunk_ab.ckpt_fingerprint(ckpt),
            "fp": {"MVidVRD": {"mAP": 0.5, "eval_s": 1.0}}}
    rec = tmp_path / "prev.json"
    rec.write_text(json.dumps(prev))
    monkeypatch.setenv("I2VSGG_DATA_ROOT", "")      # the tool sets it
    argv = ["--ckpt", ckpt, "--out", str(tmp_path / "o"), "--dataset",
            "MVidVRD", "--net", "res10", "--reuse_fp", str(rec),
            "--device", "cpu"]
    meta = ck / "step_00000001" / "metadata.json"
    meta.write_text(meta.read_text() + "\n")
    with pytest.raises(ValueError, match="rewritten"):
        quant_trunk_ab.main(argv)
    prev["ckpt_fingerprint"] = quant_trunk_ab.ckpt_fingerprint(ckpt)
    rec.write_text(json.dumps(prev))
    with pytest.raises(ValueError, match="lacks datasets"):
        quant_trunk_ab.main(argv + ["--dataset_t", "MVRD"])
    prev["ckpt"] = str(tmp_path / "elsewhere" / "1")
    rec.write_text(json.dumps(prev))
    with pytest.raises(ValueError, match="not"):
        quant_trunk_ab.main(argv)
