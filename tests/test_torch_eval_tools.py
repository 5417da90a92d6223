"""The last evaluation tools of the port against the JAX package's, on the
CPU at a small size: ``i2vsgg_tpu_torch/tools/stage_c_hard.py``,
``stage_b_rescore.py`` with the raw cosine scorer
(``parity_run._ours_sgg_score_fn(raw=True)``), ``utils/vis.py``, and
``tools/compare_loss_curves.py`` (which needs no twin) on the port's
metrics files.

Tolerances and setting:

* one Stage B model (res10 trunk, head at fc 128, 5 predicates) initialized
  by JAX, saved by JAX and carried across by the param bridge
  (``tools/jax_to_torch_checkpoint.py``), scored by each package's tool at
  fc 128 and res10 (``VRDHead`` and ``parity_run.HP`` patched in both, as
  ``test_torch_gate_tools.py`` does), each package on its own copy of the
  small parity corpus;
* ``stage_c_hard``: the hard video sets equal (annotations byte-equal,
  frames pixel-equal), the JSON's keys and GT count equal, every metric
  within 1e-6;
* ``stage_b_rescore``: the same five variants, ``top1_acc`` equal and
  ``pred_mAP`` within 1e-6; the raw scores within 1e-5 of JAX's and their
  softmax the protocol scorer's; JAX's ``main`` with its training stubbed
  over the carried-across checkpoint against the port's ``main`` and its
  ``rescore``;
* ``vis``: boxes pixel-equal to PIL's (the JAX package's drawing) outside
  the rectangles the two labels cover (JAX's in FreeType's font, the
  port's in its bitmap font, which equals PIL drawing with Pillow's
  built-in bitmap font);
* the ``ref`` arms refuse, naming ``/root/reference``.

Runtime: about 100 s alone (JAX compiles its scorer once a test).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from i2vsgg_tpu.models import sgg as jax_sgg
from i2vsgg_tpu.models.backbones import ResNetTrunk as JaxResNetTrunk
from i2vsgg_tpu.utils import vis as jax_vis
from i2vsgg_tpu_torch.tools import parity_run, stage_b_rescore, stage_c_hard
from i2vsgg_tpu_torch.utils import logging as port_logging
from i2vsgg_tpu_torch.utils import vis
from tests.test_torch_gate_tools import (FC, SMALL_DATA, _narrow_heads,
                                         _recipe, _save_both)
from tools import compare_loss_curves
from tools import parity_run as jax_parity_run
from tools import stage_b_rescore as jax_stage_b_rescore
from tools import stage_c_hard as jax_stage_c_hard


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The small parity corpus, one copy for each package."""
    d = tmp_path_factory.mktemp("corpus")
    parity_run.make_data(str(d / "port" / "data"), **SMALL_DATA)
    shutil.copytree(d / "port" / "data", d / "jax" / "data")
    return {pkg: str(d / pkg) for pkg in ("jax", "port")}


@pytest.fixture(scope="module")
def stage_b(tmp_path_factory):
    """JAX's init of a Stage B model (res10 trunk, head at fc ``FC``, 5
    predicates) in both formats as step 1."""
    g, z = 6, jnp.zeros
    sgg = jax_sgg.SGGModel(trunk=JaxResNetTrunk(depth=10, dtype=jnp.float32),
                           vrd=jax_sgg.VRDHead(fc_dim=FC), n_rel=5)
    sp = jax.jit(lambda k: sgg.init(
        {"params": k}, z((1, 64, 80, 3)), jnp.asarray([64, 80, 1.0]),
        z((g, 4)), z((g,), jnp.int32), z((g * (g - 1),), jnp.int32),
        z((g * (g - 1),), jnp.int32), z((g * (g - 1),), bool),
        z((5, 300)))["params"])(jax.random.PRNGKey(7))
    return _save_both(str(tmp_path_factory.mktemp("sgg")), "sgg",
                      jax.tree_util.tree_map(np.array, sp),
                      {"vrd_pooling": "pool"})


def _quiet_jax(monkeypatch):
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setenv("I2VSGG_DATA_ROOT", "")


def _short_videos(monkeypatch) -> dict:
    """Both packages' ``make_data`` at 12 frames a video (the tools' 24
    would double each scoring pass); each call's arguments recorded."""
    calls = {}
    for pkg, mod in (("jax", jax_parity_run), ("port", parity_run)):
        real = mod.make_data

        def short(root, *a, real=real, pkg=pkg, **k):
            calls.setdefault(pkg, []).append((a, dict(k)))
            return real(root, *a, **dict(k, n_frames=12))
        monkeypatch.setattr(mod, "make_data", short)
    return calls


# -- stage_c_hard -------------------------------------------------------------

def test_stage_c_hard_matches_jax(corpus, stage_b, tmp_path, monkeypatch):
    """Both tools' ours arm on one carried-across checkpoint: the same hard
    set, the same JSON, the metrics within 1e-6; the data root restored."""
    _narrow_heads(monkeypatch)
    _quiet_jax(monkeypatch)
    calls = _short_videos(monkeypatch)
    common = ["--n_videos", "2", "--arms", "ours", "--seed", "3"]
    want = jax_stage_c_hard.main(
        ["--out", corpus["jax"], "--hard_out", str(tmp_path / "jax"),
         "--ours_ckpt", stage_b[0]] + common)
    assert os.environ["I2VSGG_DATA_ROOT"] == os.path.join(corpus["jax"],
                                                          "data")
    got = stage_c_hard.main(
        ["--out", corpus["port"], "--hard_out", str(tmp_path / "port"),
         "--ours_ckpt", stage_b[1], "--device", "cpu"] + common)
    assert os.environ["I2VSGG_DATA_ROOT"] == os.path.join(corpus["port"],
                                                          "data")
    with open(tmp_path / "port" / "stage_c_hard.json") as f:
        assert json.load(f) == got
    assert calls["port"] == calls["jax"] == [((), dict(
        n_source=4, n_target=2, video_target=True, hard_videos=True))]
    assert set(got) == set(want) == {"n_gt_hard", "n_videos", "ours_ckpt",
                                     "seed", "ours_hard"}
    assert got["n_gt_hard"] == want["n_gt_hard"] > 0
    assert got["n_videos"] == want["n_videos"] == 1 and got["seed"] == 3
    w, g = want["ours_hard"], got["ours_hard"]
    assert set(g) == set(w) == {"rel_mAP", "R@50", "R@100", "P@1", "P@5",
                                "P@10", "n_gt"}
    assert g["n_gt"] == w["n_gt"] == got["n_gt_hard"]
    for k in set(g) - {"n_gt"}:
        assert abs(g[k] - w[k]) <= 1e-6, (k, g[k], w[k])
    # the hard set: 4-6 objects a video, written alike by both packages
    ann = os.path.join("data", "MVidVRD", "video_annotations_test.json")
    with open(tmp_path / "jax" / ann) as a, open(tmp_path / "port" / ann) as b:
        assert json.load(a) == json.load(b)
    frames = os.path.join("data", "MVidVRD", "JPEGImages")
    names = sorted(os.listdir(tmp_path / "jax" / frames))
    assert names == sorted(os.listdir(tmp_path / "port" / frames)) and names
    for name in names[::7]:
        a = np.asarray(Image.open(tmp_path / "jax" / frames / name))
        b = np.asarray(Image.open(tmp_path / "port" / frames / name))
        np.testing.assert_array_equal(a, b)


def test_stage_c_hard_reuses_the_hard_set(corpus, stage_b, tmp_path,
                                          monkeypatch):
    """A hard set already written is scored as it is, not written again; the
    scorer is built from the original data root and scores the hard one
    (both stubbed here: the metrics are the test above's)."""
    _narrow_heads(monkeypatch)
    monkeypatch.setenv("I2VSGG_DATA_ROOT", "")
    calls = _short_videos(monkeypatch)
    from i2vsgg_tpu_torch.tools import quant_ab
    built, scored = [], []
    monkeypatch.setattr(quant_ab, "build_scorer",
                        lambda *a: built.append(a) or "fn")
    monkeypatch.setattr(parity_run, "eval_video_rel", lambda fn, root: (
        scored.append((fn, root, os.environ["I2VSGG_DATA_ROOT"]))
        or {"R@50": 0.5}))
    argv = ["--out", corpus["port"], "--hard_out", str(tmp_path),
            "--ours_ckpt", stage_b[1], "--n_videos", "2", "--device", "cpu"]
    first = stage_c_hard.main(argv)
    again = stage_c_hard.main(argv)
    assert len(calls["port"]) == 1 and first == again
    assert first["ours_hard"] == {"R@50": 0.5}
    hard = str(tmp_path / "data")
    assert scored == [("fn", hard, hard)] * 2
    ckpt_dir, step = os.path.dirname(stage_b[1]), 1
    orig = os.path.join(corpus["port"], "data")
    assert [b[:4] for b in built] == [(ckpt_dir, step, False, orig)] * 2


@pytest.mark.parametrize("arms", ["ref", "ours,ref"])
def test_stage_c_hard_refuses_the_reference_arm(arms, tmp_path):
    with pytest.raises(ValueError, match="/root/reference"):
        stage_c_hard.main(["--out", str(tmp_path), "--hard_out",
                           str(tmp_path / "h"), "--ours_ckpt", "x/1",
                           "--arms", arms, "--device", "cpu"])
    assert not os.path.exists(tmp_path / "h")


# -- stage_b_rescore ----------------------------------------------------------

def _session(out: str, seed: int) -> str:
    return os.path.join(out, "res10", "MVRD_SGG", f"session_{951 + seed}")


def _place(ckpt: str, out: str, seed: int) -> str:
    """The checkpoint ``<dir>/1`` copied in as step 1 of ``out``'s session
    ``951 + seed``, where the tools' training would have written it."""
    dst = _session(out, seed)
    shutil.copytree(os.path.dirname(ckpt), dst)
    return dst


def test_raw_scorer_matches_jax(corpus, stage_b, monkeypatch):
    """``_ours_sgg_score_fn(raw=True)`` on the carried-across checkpoint:
    the cosine logits within 1e-5 of JAX's, and their softmax the protocol
    scorer's."""
    _narrow_heads(monkeypatch)
    _quiet_jax(monkeypatch)
    ckpt_j, ckpt_p = (os.path.dirname(c) for c in stage_b)
    monkeypatch.setenv("I2VSGG_DATA_ROOT", os.path.join(corpus["port"],
                                                        "data"))
    data = parity_run._stage_b_data("test")
    assert data
    raw_j = jax_parity_run._ours_sgg_score_fn(ckpt_j, raw=True)
    raw_p = parity_run._ours_sgg_score_fn(ckpt_p, device="cpu", raw=True)
    soft_p = parity_run._ours_sgg_score_fn(ckpt_p, device="cpu")
    n = 0
    for index, im, scale, boxes, classes, pairs, labels in data[:4]:
        a = raw_j(index, im, scale, boxes, pairs)
        b = raw_p(index, im, scale, boxes, pairs)
        assert a.shape == b.shape == (len(pairs), 5)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
        e = np.exp(b - b.max(-1, keepdims=True))
        np.testing.assert_allclose(soft_p(index, im, scale, boxes, pairs),
                                   e / e.sum(-1, keepdims=True), rtol=1e-5,
                                   atol=1e-6)
        assert not np.allclose(b.sum(-1), 1.0)         # logits, not a softmax
        n += len(pairs)
    assert n > 0


def test_stage_b_rescore_matches_jax(corpus, stage_b, tmp_path, monkeypatch):
    """Both tools' ``main`` over the carried-across checkpoint, placed where
    their training writes it (the training stubbed and its arguments held
    equal): the five variants' top-1 equal and pred mAP within 1e-6; the
    port's ``rescore`` on the session gives its ``main``'s; the JSON
    accumulates across invocations."""
    _narrow_heads(monkeypatch)
    _quiet_jax(monkeypatch)
    trained = {"jax": [], "port": []}
    monkeypatch.setattr(jax_parity_run, "train_ours_sgg",
                        lambda *a, **k: trained["jax"].append((a[2:], k)))
    monkeypatch.setattr(parity_run, "train_ours_sgg",
                        lambda *a, **k: trained["port"].append((a[2:], k)))
    out = {pkg: str(tmp_path / pkg) for pkg in ("jax", "port")}
    _place(stage_b[0], out["jax"], 1)
    _place(stage_b[1], out["port"], 1)
    with open(tmp_path / "port" / "stage_b_rescore.json", "w") as f:
        json.dump({"ours_s0": {"kept": True}}, f)
    common = ["--steps", "5", "--seeds", "1", "--arms", "ours"]
    want = jax_stage_b_rescore.main(
        ["--out", out["jax"], "--data", os.path.join(corpus["jax"], "data")]
        + common)
    got = stage_b_rescore.main(
        ["--out", out["port"], "--data", os.path.join(corpus["port"], "data"),
         "--device", "cpu"] + common)
    assert trained["jax"] == [((5,), {"seed": 1})]
    [(args, kw)] = trained["port"]
    assert args == (5,) and kw["seed"] == 1 and str(kw["device"]) == "cpu"
    assert got["ours_s0"] == {"kept": True}
    with open(tmp_path / "port" / "stage_b_rescore.json") as f:
        assert json.load(f) == got
    w, g = want["ours_s1"], got["ours_s1"]
    assert list(g) == list(w) == ["protocol_softmax", "raw_cosine",
                                  "sharp_T0.25", "flat_T4", "soprior_fused"]
    for name in w:
        assert g[name]["top1_acc"] == w[name]["top1_acc"], name
        assert abs(g[name]["pred_mAP"] - w[name]["pred_mAP"]) <= 1e-6, name
    assert len({v["pred_mAP"] for v in g.values()}) > 1   # the transforms act
    monkeypatch.setenv("I2VSGG_DATA_ROOT", "elsewhere")
    assert stage_b_rescore.rescore(_session(out["port"], 1),
                                   os.path.join(corpus["port"], "data"),
                                   "cpu") == g
    assert os.environ["I2VSGG_DATA_ROOT"] == "elsewhere"


def test_rescore_variants_match_jax_arithmetic():
    """``variants``' arithmetic on seeded rows against the JAX tool's
    ``metrics`` and transforms (its ``variants`` lives inside ``main``)."""
    rs = np.random.RandomState(0)
    prior = rs.dirichlet(np.ones(5), size=(15, 15))
    rows = [(rs.randn(5) * 3, (rs.rand(5) < 0.3).astype(np.float64),
             rs.randint(1, 16), rs.randint(1, 16)) for _ in range(64)]
    rows[0][1][:] = 1.0                       # every predicate has a positive
    got = stage_b_rescore.variants(rows, prior)
    sm = jax_stage_b_rescore._softmax
    raws, labs = [r[0] for r in rows], [r[1] for r in rows]
    want = {
        "protocol_softmax": [sm(s[None])[0] for s in raws],
        "raw_cosine": raws,
        "sharp_T0.25": [sm(s[None], 4.0)[0] for s in raws],
        "flat_T4": [sm(s[None], 0.25)[0] for s in raws],
        "soprior_fused": [sm(s[None])[0] + np.log(
            0.5 * (prior[a - 1, b - 1] + 1.0 / len(s)))
            for s, _, a, b in rows]}
    assert list(got) == list(want)
    for name, scores in want.items():
        assert got[name] == jax_stage_b_rescore.metrics(scores, labs), name


@pytest.mark.parametrize("arms", ["ref", "ours,ref"])
def test_stage_b_rescore_refuses_the_reference_arm(arms, tmp_path):
    with pytest.raises(ValueError, match="/root/reference"):
        stage_b_rescore.main(["--out", str(tmp_path / "o"), "--data",
                              str(tmp_path / "d"), "--arms", arms,
                              "--device", "cpu"])
    assert not os.path.exists(tmp_path / "d")


# -- vis ----------------------------------------------------------------------

def _dets(rs, h, w, n):
    x1 = rs.uniform(-8, w, n)
    y1 = rs.uniform(-8, h, n)
    x2 = x1 + rs.uniform(0, w / 2, n) * (rs.rand(n) < 0.9)
    y2 = y1 + rs.uniform(0, h / 2, n) * (rs.rand(n) < 0.9)
    return np.stack([x1, y1, x2, y2, rs.rand(n)], 1).astype(np.float32)


def _outside(boxes, shape):
    """A mask of the pixels outside every (left, top, right, bottom)."""
    keep = np.ones(shape[:2], bool)
    for x0, y0, x1, y1 in boxes:
        keep[max(int(np.floor(y0)), 0):max(int(np.ceil(y1)), 0),
             max(int(np.floor(x0)), 0):max(int(np.ceil(x1)), 0)] = False
    return keep


def _labels(dets, name, thresh):
    """The rectangles the labels of ``dets`` cover: PIL's default font's
    text box (the JAX package's) and the port's bitmap font's."""
    draw = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    out = []
    for d in dets:
        if float(d[4]) <= thresh:
            continue
        text = f"{name}: {float(d[4]):.3f}"
        xy = (float(d[0]) + 2, max(0.0, float(d[1]) - 12))
        out += [draw.textbbox(xy, text), vis.label_box(*xy, text)]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_vis_detections_boxes_equal_jax(seed):
    """Boxes of every size (empty, one pixel, past the edges) pixel-equal to
    JAX's outside the label rectangles, which cover only a small part."""
    rs = np.random.RandomState(seed)
    h, w = 60 + 10 * seed, 90
    im = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    dets = _dets(rs, h, w, 12)
    want = jax_vis.vis_detections(im, "person", dets, 0.3)
    got = vis.vis_detections(im, "person", dets, 0.3)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    keep = _outside(_labels(dets, "person", 0.3), im.shape)
    assert keep.mean() > 0.3
    np.testing.assert_array_equal(got[keep], want[keep])
    drawn = (got != im[..., ::-1]).any(-1)
    assert drawn[keep].any()                  # some box was drawn


def test_vis_label_is_pillows_bitmap_font():
    """The port's label equals PIL drawing the text with Pillow's built-in
    bitmap font at the same anchor."""
    im = np.zeros((40, 120, 3), np.uint8)
    text = "dog: 0.875 ~{}|ABCxyz"
    got = im.copy()
    vis.draw_text(got, (3.7, 9.2), text)
    pil = Image.fromarray(im.copy())
    ImageDraw.Draw(pil).text((3, 9), text, fill=vis.COLOR,
                             font=ImageFont.load_default_imagefont())
    np.testing.assert_array_equal(got, np.asarray(pil))
    x0, y0, x1, y1 = vis.label_box(3.7, 9.2, text)
    ys, xs = np.nonzero(got.any(-1))
    assert ys.min() >= y0 and ys.max() < y1 and xs.min() >= x0
    assert xs.max() < x1


def test_vis_refuses_what_pil_refuses():
    im = np.zeros((8, 8, 3), np.uint8)
    dets = np.asarray([[5, 1, 2, 4, 0.9]], np.float32)
    with pytest.raises(ValueError, match="x1 must be greater"):
        jax_vis.vis_detections(im, "a", dets)
    with pytest.raises(ValueError, match="x1 must be greater"):
        vis.vis_detections(im, "a", dets)


def test_save_vis_matches_jax(tmp_path):
    """``save_vis`` over three classes (the background's dets skipped, an
    empty class and None): the PNG the port writes reads back as its
    drawing, equal to JAX's PNG outside the label rectangles."""
    rs = np.random.RandomState(9)
    im = rs.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    classes = ["__background__", "cat", "dog", "bird", "fish"]
    per = [_dets(rs, 48, 64, 4), _dets(rs, 48, 64, 5),
           np.zeros((0, 5), np.float32), _dets(rs, 48, 64, 3), None]
    jax_vis.save_vis(im, per, classes, str(tmp_path / "jax.png"))
    vis.save_vis(im, per, classes, str(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png").convert("RGB"))
    got = np.asarray(Image.open(tmp_path / "port.png").convert("RGB"))
    boxes = [b for j, d in enumerate(per) if j and d is not None
             for b in _labels(d, classes[j], 0.5)]
    keep = _outside(boxes, im.shape)
    np.testing.assert_array_equal(got[keep], want[keep])
    img = im[..., ::-1]
    for j in (1, 3):
        img = vis.vis_detections(img[..., ::-1], classes[j], per[j], 0.5)
    np.testing.assert_array_equal(got, img)


# -- compare_loss_curves ------------------------------------------------------

def test_compare_loss_curves_reads_the_ports_metrics(tmp_path, capsys):
    """The JAX package's tool on two ``metrics.jsonl`` files written by the
    port's ``MetricsLogger``: every key of ``KEYS`` read, each window's
    mean that of the steps it holds."""
    keys = compare_loss_curves.KEYS
    paths = []
    for arm, scale in (("ours", 1.0), ("ref", 2.0)):
        logger = port_logging.MetricsLogger(str(tmp_path / arm),
                                            use_tensorboard=False)
        for step in range(1, 9):
            logger.log_scalars("train", {k: scale * (step + i / 10)
                                         for i, k in enumerate(keys)}, step)
        logger.close()
        paths.append(str(tmp_path / arm / "metrics.jsonl"))
    rows = compare_loss_curves.load(paths[0])
    assert len(rows) == 8 and set(keys) <= set(rows[0])
    means = compare_loss_curves.window_means(rows, 4)
    assert sorted(means) == [0, 1, 2]
    for i, k in enumerate(keys):              # window 1: steps 4-7
        assert means[1][k] == pytest.approx(5.5 + i / 10)
    compare_loss_curves.main(paths + ["--window", "4"])
    out = capsys.readouterr().out.splitlines()
    assert len(out[0].split()) == 1 + len(keys)
    cells = out[2].split()
    assert cells[0] == "1" and len(cells) == 1 + len(keys)
    for i, cell in enumerate(cells[1:]):
        a, b = (float(x) for x in cell.split("/"))
        assert a == pytest.approx(5.5 + i / 10, abs=1e-4)
        assert b == pytest.approx(2 * (5.5 + i / 10), abs=1e-4)
