"""The port's data parallelism (``i2vsgg_tpu_torch/parallel/mesh.py``) on
the CPU: two gloo processes (a ``file://`` rendezvous in the test's own
directory, so that test files running side by side under xdist do not
share a port) against one process at the doubled batch and against the JAX
package's single-process step, which computes the global batch's loss.

* ``host_shard`` equals JAX's over (length, world, rank, batch size) cases,
  JAX's ``jax.process_count`` / ``jax.process_index`` patched in the test;
* Stage A, tiny (res10, 64x80, f32, ``I2VSGG_DETERMINISTIC_SAMPLING=1``,
  ``RPN_BATCHSIZE`` 256 so that the two images label different counts of
  anchors, which the test asserts): 2 ranks at batch 1 for two steps
  (rank 1 starts from perturbed weights, which ``replicate`` must
  overwrite) against the port in one process at batch 2 and against JAX's
  ``make_train_step`` at batch 2. A mean of the ranks' per-image means
  would miss the RPN class loss by more than ten times the tolerance (the
  test shows it);
* Stage B, tiny: image 0 with 3 valid pairs, image 1 with 7, dropout off in
  both packages: 2 ranks at batch 1 against JAX's ``make_sgg_train_step``
  at batch 2;
* a parameter that has a gradient on one rank and none on the other, over
  buckets of 16 bytes: no hang, the sum of both;
* the sharded serving program over a 2-replica CPU mesh with a ragged
  batch (the counterpart of tests/test_serve.py::
  test_frame_program_sharded_over_mesh), and its bucketed form.

Tolerances: the ranks bit-equal to each other; against the port at batch 2
the metrics rtol 1e-5 and the parameters rtol 1e-5 with an atol of 1e-3 of
the tensor's largest update (tests/test_torch_train_step.py's rule for an
update: only the summation order differs); against JAX the metrics rtol
1e-4 and the parameters by the same rule; the sharded program's
detections, classes and pairs equal, boxes and probabilities rtol 1e-5.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from i2vsgg_tpu.config import Config as JaxConfig
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.parallel import mesh as jax_mesh
from i2vsgg_tpu.train import det_da as jax_det_da
from i2vsgg_tpu.train import sgg as jax_sgg
from i2vsgg_tpu.train.optim import sgd_reference
from i2vsgg_tpu_torch import serve
from i2vsgg_tpu_torch.config import Config, TestConfig, TrainConfig
from i2vsgg_tpu_torch.models import faster_rcnn as frcnn_mod
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.models.layers import init_weights
from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
from i2vsgg_tpu_torch.parallel import mesh
from i2vsgg_tpu_torch.train import det_da
from i2vsgg_tpu_torch.train import sgg as port_sgg
from i2vsgg_tpu_torch.train.optim import ReferenceSGD
from i2vsgg_tpu_torch.utils.weights import params_from_jax
from tests import test_torch_train_sgg as sgg_case
from tests.test_torch_train_step import jax_init, make_batches, np_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 300

# The worker a rank runs: it joins the gloo group through the file
# rendezvous itself, then calls the port's own ``maybe_init_distributed``
# (which must find the group and start no second one), runs one mode and
# saves its result with torch.save.
WORKER = r'''
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world = int(sys.argv[1]), int(sys.argv[2])
init, mode, spec_path, out_path = sys.argv[3:7]
torch.set_num_threads(2)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=240))
from i2vsgg_tpu_torch.parallel import mesh
assert mesh.maybe_init_distributed("cpu")
assert mesh.process_count() == world and mesh.process_index() == rank
spec = json.load(open(spec_path))
os.environ.update(spec.get("env", {}))


def port_cfg(spec):
    from i2vsgg_tpu_torch.config import Config, TestConfig, TrainConfig
    return Config().replace(TRAIN=TrainConfig(**spec["train"]),
                            TEST=TestConfig(**spec["test"]),
                            COMPUTE_DTYPE="float32",
                            ANCHOR_SCALES=tuple(spec["anchor_scales"]))


def params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def stage_a(spec):
    from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
    from i2vsgg_tpu_torch.train import det_da
    from i2vsgg_tpu_torch.train.optim import ReferenceSGD
    cfg = port_cfg(spec)
    pm = FasterRCNN_DA(spec["classes"], cfg, "res10", ic=True, gc=True,
                       training_tree=True)
    pm.load_state_dict(torch.load(spec["state"]))
    if rank:
        with torch.no_grad():                  # replicate must undo this
            for p in pm.parameters():
                p.add_(0.01)
    mesh.replicate(pm)
    data = np.load(spec["batches"])
    rows = slice(rank, rank + 1)
    src = {k: torch.as_tensor(data["src_" + k][rows])
           for k in ("image", "im_info", "gt_boxes")}
    tgt = {k: torch.as_tensor(data["tgt_" + k][rows])
           for k in ("image", "im_info")}
    opt = ReferenceSGD(pm, spec["lr"], cfg, clip_norm=spec["clip"])
    state = det_da.TrainState(pm, opt)
    steps = [{"params": params(pm)}]
    for _ in range(spec["steps"]):
        m = det_da.train_step(state, src, tgt, cr=spec["cr"], **spec["loss"])
        steps.append({"metrics": {k: float(v) for k, v in m.items()},
                      "params": params(pm)})
    return steps


def stage_b(spec):
    from i2vsgg_tpu_torch.config import Config
    from i2vsgg_tpu_torch.models.backbones import ResNetTrunk
    from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
    from i2vsgg_tpu_torch.train import sgg
    from i2vsgg_tpu_torch.train.det_da import TrainState
    model = SGGModel(VRDHead(emb_dim=spec["emb"], fc_dim=spec["fc"],
                             pooling=spec["pooling"], dropout_rate=0.0),
                     trunk=ResNetTrunk(depth=10, dtype=torch.float32))
    model.load_state_dict(torch.load(spec["state"]))
    mesh.replicate(model)
    data = np.load(spec["batch"])
    batch = {k: torch.as_tensor(data[k][rank:rank + 1]) for k in data.files}
    batch["ix1"], batch["ix2"] = batch["ix1"].long(), batch["ix2"].long()
    prd = torch.as_tensor(np.load(spec["prd"]))
    state = TrainState(model, sgg.sgg_optimizer(model, spec["lr"], Config()))
    steps = []
    for _ in range(spec["steps"]):
        m = sgg.train_step(state, batch, prd)
        steps.append({"metrics": {k: float(v) for k, v in m.items()},
                      "params": params(model)})
    return steps


def no_grad_on_one_rank(spec):
    torch.manual_seed(0)
    net = torch.nn.ModuleDict({"a": torch.nn.Linear(4, 3),
                               "b": torch.nn.Linear(3, 2)})
    y = net["a"](torch.arange(8.0).reshape(2, 4) * (rank + 1))
    if rank == 0:                              # "b" gets no grad on rank 1
        y = net["b"](y)
    y.sum().backward()
    local = {n: None if p.grad is None else p.grad.clone()
             for n, p in net.named_parameters()}
    mesh.all_reduce_grads(list(net.parameters()), bucket_bytes=16)
    mesh.sync_global_devices("grads")
    return {"local": local,
            "reduced": {n: p.grad.clone() for n, p in net.named_parameters()},
            "shard": mesh.host_shard(list(range(11)), 2),
            "sum": float(mesh.global_sum(torch.tensor(rank + 1.0)))}


def driver(spec):
    import importlib
    from i2vsgg_tpu_torch.utils import logging as port_logging
    main = importlib.import_module(spec["module"]).main
    logged = []
    log = port_logging.MetricsLogger.log_scalars

    def record(self, tag, scalars, step):
        logged[-1].append(dict(scalars, step=int(step)))
        return log(self, tag, scalars, step)
    port_logging.MetricsLogger.log_scalars = record
    runs = []
    for extra in spec["runs"]:
        logged.append([])
        try:
            state = main(spec["argv"] + extra)
            runs.append({"step": int(state.step), "logged": logged[-1]})
        except ValueError as e:
            runs.append({"error": str(e)})
    return runs


result = globals()[mode](spec)
torch.save(result, out_path)
mesh.sync_global_devices("done")
dist.destroy_process_group()
'''


class Ranks:
    """``world`` worker processes of ``mode`` (their files in ``tmp_path``
    named by ``tag``, by default the mode), started at once; ``results``
    waits for them (each within ``RANK_TIMEOUT_S``; all are killed if one
    fails or hangs) and returns each rank's result."""

    def __init__(self, tmp_path, mode, spec, world=2, tag=None):
        tag = tag or mode
        self.paths = [tmp_path / f"{tag}.rank{r}.pt" for r in range(world)]
        script = tmp_path / "rank_worker.py"
        script.write_text(WORKER)
        spec_path = tmp_path / f"{tag}.json"
        spec_path.write_text(json.dumps(spec))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        env.pop("XLA_FLAGS", None)
        self.procs = [subprocess.Popen(
            [sys.executable, str(script), str(r), str(world),
             str(tmp_path / f"{tag}.rendezvous"), mode, str(spec_path),
             str(self.paths[r])], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, text=True)
            for r in range(world)]

    def results(self):
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
        return [torch.load(path, weights_only=False) for path in self.paths]


def same_on_both_ranks(a, b):
    """Two ranks' results are bit-equal (tensors with ``torch.equal``)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            same_on_both_ranks(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_on_both_ranks(x, y)
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b


def close_params(got, want, before, rtol=1e-5, names=None):
    """Each parameter within ``rtol``, with an atol of 1e-3 of the largest
    magnitude of that tensor's update from ``before`` to ``want``."""
    for name in names or want:
        w = want[name].double().numpy()
        step = float(np.abs(w - before[name].double().numpy()).max())
        np.testing.assert_allclose(got[name].double().numpy(), w, rtol=rtol,
                                   atol=max(1e-3 * step, 1e-12),
                                   err_msg=name)


# -- host_shard --------------------------------------------------------------

@pytest.mark.parametrize("n, world, bs", [(10, 2, 1), (11, 2, 2), (17, 3, 2),
                                          (9, 4, 3), (5, 8, 1), (7, 1, 2)])
def test_host_shard_matches_jax(n, world, bs, monkeypatch):
    """Every rank's slice equals JAX's; the slices are disjoint, contiguous,
    of one length that ``bs`` divides."""
    entries = [f"e{i}" for i in range(n)]
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(mesh, "process_count", lambda: world)
    got = []
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(mesh, "process_index", lambda: rank)
        mine = mesh.host_shard(entries, bs)
        assert mine == jax_mesh.host_shard(entries, bs)
        got.append(mine)
    if world > 1:
        assert len({len(g) for g in got}) == 1 and len(got[0]) % bs == 0
        flat = [e for g in got for e in g]
        assert flat == entries[:len(flat)]


def test_make_mesh_and_shard_batch():
    """The CPU mesh (``n`` times cpu, an explicit list kept as given), a
    batch split in row order (tensors, numpy, ``Conv1Planes``), a ragged
    one refused; serving replicas are independent copies."""
    from i2vsgg_tpu_torch.ops.conv1 import Conv1Planes
    assert mesh.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert mesh.make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    x = np.arange(4 * 6 * 8 * 3, dtype=np.float32).reshape(4, 6, 8, 3)
    batch = {"image": x, "info": torch.arange(8.0).reshape(4, 2),
             "planes": Conv1Planes.pack(x)}
    chunks = mesh.shard_batch(batch, mesh.make_mesh(2, "cpu"))
    assert torch.equal(chunks[1]["image"], torch.from_numpy(x[2:]))
    assert torch.equal(chunks[0]["info"], batch["info"][:2])
    assert torch.equal(chunks[1]["planes"].planes,
                       batch["planes"].planes[2:])
    assert chunks[1]["planes"].shape == (2, 6, 8, 3)
    with pytest.raises(ValueError, match="pad it"):
        mesh.shard_batch(batch, mesh.make_mesh(3, "cpu"))
    lin = torch.nn.Linear(2, 2)
    a, b = mesh.replicate(lin, mesh.make_mesh(2, "cpu"))
    assert a is not b and a.weight is not lin.weight
    assert torch.equal(a.weight, lin.weight)
    assert mesh.process_count() == 1 and mesh.backend() == "none"
    assert not mesh.maybe_init_distributed("cpu")


# -- Stage A -----------------------------------------------------------------

N_CLASSES = 6
# tests/test_torch_train_step.py's tiny configuration, with every anchor
# that is not ignored labelled (RPN_BATCHSIZE 256 > the anchors of a 64x80
# frame), so that the labelled counts follow each image's GT boxes
TRAIN = dict(RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=32,
             RPN_POST_NMS_TOP_N_TARGET=16, RPN_BATCHSIZE=256, BATCH_SIZE=16,
             MAX_NUM_GT_BOXES=5)
TEST = dict(RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16)
ANCHOR_SCALES = (1, 2, 4)
LOSS = dict(eta=0.1, eta_style=0.01, style_lambda=1.0)
LR, CLIP, CR, STEPS = 1e-3, 10.0, True, 2


def port_cfg():
    return Config().replace(TRAIN=TrainConfig(**TRAIN),
                            TEST=TestConfig(**TEST), COMPUTE_DTYPE="float32",
                            ANCHOR_SCALES=ANCHOR_SCALES)


def jax_cfg():
    c = JaxConfig()
    return c.replace(TRAIN=c.TRAIN.__class__(**TRAIN),
                     TEST=c.TEST.__class__(**TEST), COMPUTE_DTYPE="float32",
                     ANCHOR_SCALES=ANCHOR_SCALES)


def T(batch, rows=slice(None)):
    return {k: torch.as_tensor(v[rows]) for k, v in batch.items()}


def port_model(sd):
    pm = FasterRCNN_DA(N_CLASSES, port_cfg(), "res10", ic=True, gc=True,
                       training_tree=True)
    pm.load_state_dict(sd)
    return pm


def test_stage_a_two_ranks_match_one_process_and_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("I2VSGG_DETERMINISTIC_SAMPLING", "1")
    p0 = jax_init("res10")
    sd = params_from_jax(p0)
    src, tgt = make_batches()
    src["gt_boxes"][1, 1:] = 0.0        # one GT box in image 1, three in 0
    torch.save(sd, tmp_path / "state.pt")
    np.savez(tmp_path / "batches.npz",
             **{f"src_{k}": v for k, v in src.items()},
             **{f"tgt_{k}": v for k, v in tgt.items()})
    ranks = Ranks(tmp_path, "stage_a", dict(
        train=TRAIN, test=TEST, anchor_scales=ANCHOR_SCALES,
        classes=N_CLASSES, state=str(tmp_path / "state.pt"),
        batches=str(tmp_path / "batches.npz"), lr=LR, clip=CLIP, cr=CR,
        loss=LOSS, steps=STEPS,
        env={"I2VSGG_DETERMINISTIC_SAMPLING": "1"}))

    # the port in one process at batch 2; each image's labelled anchors
    counts = []
    real_ce = frcnn_mod.masked_softmax_ce

    def counted(logits, labels, mask, count=None):
        if mask.dim() == 2:                     # the RPN's (B, anchors)
            counts.append(mask.sum(dim=1).tolist())
        return real_ce(logits, labels, mask, count)
    monkeypatch.setattr(frcnn_mod, "masked_softmax_ce", counted)
    pm = port_model(sd)
    state = det_da.TrainState(pm, ReferenceSGD(pm, LR, port_cfg(),
                                               clip_norm=CLIP))
    one = [{"params": {n: p.detach().clone()
                       for n, p in pm.named_parameters()}}]
    for _ in range(STEPS):
        m = det_da.train_step(state, T(src), T(tgt), cr=CR, **LOSS)
        one.append({"metrics": {k: float(v) for k, v in m.items()},
                    "params": {n: p.detach().clone()
                               for n, p in pm.named_parameters()}})
    assert counts[0][0] != counts[0][1], counts      # the fixture's premise

    # what a mean of per-image means would report as rpn_loss_cls
    per_image = []
    for i in range(2):
        pm = port_model(sd)
        ReferenceSGD(pm, LR, port_cfg())
        _, mi = det_da.det_da_loss(pm, T(src, slice(i, i + 1)),
                                   T(tgt, slice(i, i + 1)),
                                   det_da.step_generator("cpu", 0, 0), cr=CR,
                                   **LOSS)
        per_image.append(float(mi["loss_rpn_cls"].detach()))
    global_rpn = one[1]["metrics"]["loss_rpn_cls"]
    assert abs(np.mean(per_image) - global_rpn) > 10 * 1e-4 * global_rpn, (
        counts, per_image, global_rpn)

    # JAX's SPMD step on the global batch of 2, in this process
    jcfg = jax_cfg()
    jm = JaxFasterRCNN(num_classes=N_CLASSES, cfg=jcfg, backbone="res10",
                       ic=True, gc=True)
    tx = sgd_reference(LR, jcfg, clip_norm=CLIP)
    step = jax_det_da.make_train_step(jm, tx, cr=CR, **LOSS)
    js = jax_det_da.create_train_state(p0, tx)
    ref = [{"params": sd}]
    for i in range(STEPS):
        js, jmet = step(js, {k: jnp.asarray(v) for k, v in src.items()},
                        {k: jnp.asarray(v) for k, v in tgt.items()},
                        jax.random.PRNGKey(i))
        ref.append({"metrics": {k: float(v) for k, v in jmet.items()},
                    "params": params_from_jax(np_tree(js.params))})

    r0, r1 = ranks.results()
    same_on_both_ranks(r0, r1)
    # rank 1's perturbed start was replaced by rank 0's weights
    for name, t in r1[0]["params"].items():
        assert torch.equal(t, sd[name]), name
    for i in range(1, STEPS + 1):
        for k, want in one[i]["metrics"].items():
            np.testing.assert_allclose(r0[i]["metrics"][k], want, rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
        close_params(r0[i]["params"], one[i]["params"], one[i - 1]["params"])
        assert set(ref[i]["metrics"]) == set(r0[i]["metrics"])
        for k, want in ref[i]["metrics"].items():
            np.testing.assert_allclose(r0[i]["metrics"][k], want, rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i} {k}")
        close_params(r0[i]["params"], ref[i]["params"], ref[i - 1]["params"],
                     names=[n for n in r0[i]["params"]])
    assert ref[1]["metrics"]["loss_rpn_cls"] > 0
    assert ref[1]["metrics"]["fg_cnt"] == r0[1]["metrics"]["fg_cnt"] > 0


# -- Stage B -----------------------------------------------------------------

def test_stage_b_two_ranks_match_jax(tmp_path):
    """Images with 3 and 7 valid pairs; the loss is the mean over the 10
    pairs of the global batch (JAX's weighting), not the mean of the two
    images' means, which the test shows to differ."""
    pooling = "pool"
    p0 = sgg_case.jax_init(pooling)
    batch = sgg_case.make_batch(11)
    pv = np.zeros_like(batch["pair_valid"])
    pv[0, :3] = pv[1, :7] = True
    batch["pair_valid"] = pv
    prd = sgg_case.prd_vecs()
    sd = params_from_jax(p0)
    torch.save(sd, tmp_path / "state.pt")
    np.savez(tmp_path / "batch.npz", **batch)
    np.save(tmp_path / "prd.npy", prd)
    ranks = Ranks(tmp_path, "stage_b", dict(
        emb=sgg_case.EMB, fc=sgg_case.FC, pooling=pooling,
        state=str(tmp_path / "state.pt"), batch=str(tmp_path / "batch.npz"),
        prd=str(tmp_path / "prd.npy"), lr=sgg_case.LR, steps=STEPS))

    # a mean of the two images' own means, for the record
    model = SGGModel(VRDHead(emb_dim=sgg_case.EMB, fc_dim=sgg_case.FC,
                             pooling=pooling, dropout_rate=0.0),
                     trunk=sgg_case.port_model(pooling).trunk)
    model.load_state_dict(sd)
    tb = sgg_case.T(batch)
    means = [float(port_sgg.sgg_loss(
        model, {k: v[i:i + 1] for k, v in tb.items()},
        torch.from_numpy(prd), lambda: None)[0]) for i in range(2)]

    jm = sgg_case.JaxSGGModel(
        trunk=sgg_case.JaxResNetTrunk(depth=10, dtype=jnp.float32),
        vrd=sgg_case.JaxVRDHead(emb_dim=sgg_case.EMB, fc_dim=sgg_case.FC,
                                pooling=pooling, dropout_rate=0.0),
        n_rel=sgg_case.N_REL)
    tx = jax_sgg.sgg_optimizer(sgg_case.LR, JaxConfig())
    step = jax_sgg.make_sgg_train_step(jm, tx)
    js = jax_det_da.create_train_state(p0, tx)
    ref = [{"params": sd}]
    for i in range(STEPS):
        js, jmet = step(js, sgg_case.J(batch), jnp.asarray(prd),
                        jax.random.PRNGKey(i))
        ref.append({"metrics": {k: float(v) for k, v in jmet.items()},
                    "params": params_from_jax(np_tree(js.params))})

    r0, r1 = ranks.results()
    same_on_both_ranks(r0, r1)
    assert abs(np.mean(means) - ref[1]["metrics"]["loss"]) > \
        10 * 1e-4 * ref[1]["metrics"]["loss"], (means, ref[1]["metrics"])
    vrd = [n for n in sd if n.startswith("vrd.")]
    for i in range(1, STEPS + 1):
        assert r0[i - 1]["metrics"]["n_pairs"] == 10
        np.testing.assert_allclose(r0[i - 1]["metrics"]["loss"],
                                   ref[i]["metrics"]["loss"], rtol=1e-4)
        close_params(r0[i - 1]["params"], ref[i]["params"],
                     ref[i - 1]["params"], names=vrd)
    for n, t in r0[-1]["params"].items():
        if not n.startswith("vrd."):
            assert torch.equal(t, sd[n]), n


# -- collectives -------------------------------------------------------------

def test_a_grad_on_one_rank_only_reduces(tmp_path):
    """``b`` has a gradient on rank 0 and none on rank 1: both reduce the
    same buckets (rank 1's counted as zeros) and hold the sum."""
    r0, r1 = Ranks(tmp_path, "no_grad_on_one_rank", {}).results()
    assert r1["local"]["b.weight"] is None and r0["local"]["b.weight"] is \
        not None
    for n, g in r0["reduced"].items():
        want = r0["local"][n] + (r1["local"][n] if r1["local"][n] is not None
                                 else 0)
        assert torch.allclose(g, want, rtol=1e-6, atol=0), n
        assert torch.equal(g, r1["reduced"][n]), n
    assert r0["shard"] == [0, 1, 2, 3] and r1["shard"] == [4, 5, 6, 7]
    assert r0["sum"] == r1["sum"] == 3.0


# -- serving over a mesh -----------------------------------------------------

N_CLS_S, N_REL_S, MD = 4, 5, 4
SERVE_CFG = Config().replace(
    TEST=TestConfig(RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16),
    COMPUTE_DTYPE="float32")


@pytest.fixture(scope="module")
def serving_models():
    """A res10 detector (ic+gc) and an SGG head under align, seeded, with
    the RPN and class logits scaled up (tests/test_torch_serve.py's rule
    against near-ties)."""
    det = FasterRCNN_DA(N_CLS_S, SERVE_CFG, "res10", ic=True, gc=True)
    init_weights(det, torch.Generator().manual_seed(2))
    sgg = SGGModel(VRDHead(emb_dim=16, fc_dim=32, pooling="align"))
    init_weights(sgg, torch.Generator().manual_seed(3))
    with torch.no_grad():
        det.rpn.cls_score.weight.mul_(40.0)
        det.cls_score.weight.mul_(40.0)
    prd = np.random.RandomState(4).randn(N_REL_S, 300).astype(np.float32)
    return det.eval(), sgg.eval(), prd


@pytest.mark.parametrize("bucketed", [False, True])
def test_sharded_program_over_a_cpu_mesh(serving_models, bucketed):
    """5 frames over 2 replicas (padded to 6, the copy's outputs dropped)
    against the unsharded program on the same frames; under buckets the
    sharded program picks the bucket of the whole batch."""
    det, sgg, prd = serving_models
    h, w, b = 64, 80, 5
    images = (np.random.RandomState(5).randn(b, h, w, 3) * 10).astype(
        np.float32)
    im_info = np.tile([[h, w, 1.0]], (b, 1)).astype(np.float32)
    kw = dict(max_det=MD, max_per_class=4, device="cpu")

    def make(d, s, dev):
        if bucketed:
            return serve.make_bucketed_program(d, s, prd, SERVE_CFG,
                                               buckets=(2, MD),
                                               **dict(kw, device=dev))
        return serve.make_frame_program(d, s, prd, SERVE_CFG,
                                        **dict(kw, device=dev))
    ref = make(det, sgg, "cpu")(images, im_info)
    grid = mesh.make_mesh(2, "cpu")
    sharded = serve.make_sharded_program(
        [make(d, s, m) for (d, s), m in zip(mesh.replicate((det, sgg), grid),
                                            grid)], grid)
    out = sharded(images, im_info)
    assert set(out) == set(ref)
    for k in ("det_valid", "classes", "pair_valid", "ix1", "ix2"):
        assert torch.equal(out[k], ref[k]), k
    assert out["det_valid"].shape[0] == b and out["det_valid"].any()
    assert out["pair_valid"].any()
    for k in ("boxes", "scores", "rel_prob"):
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    if bucketed:
        assert out["bucket"] == ref["bucket"]
    # the uint8 path's wrapper keeps the stages
    prepared = serve.with_input(make(det, sgg, "cpu"), lambda x, i: (x, i))
    assert hasattr(prepared, "detect") == bucketed
