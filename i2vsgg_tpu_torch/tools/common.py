"""What the port's drivers share: the config from the command line, the
``--load_name`` convention (``<ckpt_dir>/<step>``), the metadata the
checkpoints carry and the training drivers' process group."""

from __future__ import annotations

import os

from i2vsgg_tpu_torch.config import Config, cfg_from_file, cfg_from_list
from i2vsgg_tpu_torch.train.checkpoint import load_metadata


def config_from_args(args, verbose: bool = False) -> Config:
    """``args.cfg_file`` (``cfgs/<net>.yml``, where it exists) over the
    defaults, then ``args.set_cfgs + args.extra_cfgs``, with
    ``COMPUTE_DTYPE`` from ``--compute_dtype``."""
    cfg = Config()
    if os.path.exists(getattr(args, "cfg_file", "")):
        cfg = cfg_from_file(args.cfg_file, cfg)
        if verbose:
            print(f"loaded config {args.cfg_file}")
    return cfg_from_list(args.set_cfgs + args.extra_cfgs, cfg).replace(
        COMPUTE_DTYPE=args.compute_dtype)


def init_data_parallel(args) -> int:
    """The training drivers' process group, joined before any device use
    (``parallel/mesh.py::maybe_init_distributed``: torchrun's variables, or
    the JAX package's). ``--mesh`` must be 0 or the world size: the port
    runs one process a card, so N cards take ``torchrun --nproc_per_node
    N``. Prints the world size, the backend and the global batch (``--bs``
    is per process, as JAX's is per host). Returns the world size."""
    from i2vsgg_tpu_torch.parallel.mesh import (backend,
                                                maybe_init_distributed,
                                                process_count)
    maybe_init_distributed(args.device)
    world = process_count()
    if args.mesh not in (0, world):
        raise ValueError(
            f"--mesh {args.mesh} in a run of {world} process(es): the port "
            "trains one process a card; launch N of them with torchrun "
            f"--nproc_per_node {args.mesh} -m i2vsgg_tpu_torch.tools.<driver>"
            " ... (--mesh 0 takes the world size)")
    print(f"data parallel: world size {world}, backend {backend()}, global "
          f"batch {args.batch_size * world} ({args.batch_size} a process)",
          flush=True)
    return world


def ckpt_of(load_name: str):
    """``--load_name``'s (ckpt_dir, step), or None when none is given
    (``""`` or the parser's default ``models``)."""
    if load_name in ("", "models"):
        return None
    return os.path.dirname(load_name), int(os.path.basename(load_name))


def metadata_of(load_name: str) -> dict:
    """The checkpoint's metadata, or {} without a checkpoint or a metadata
    file."""
    ckpt = ckpt_of(load_name)
    if ckpt is None:
        return {}
    try:
        return load_metadata(*ckpt)
    except FileNotFoundError:
        return {}


def vrd_pooling_of(load_name: str, default: str) -> str:
    """The SGG head's pooling: the checkpoint's ``vrd_pooling`` where its
    metadata records one (the head must pool as it was trained), else
    ``default`` (``--vrd_pooling``)."""
    meta = metadata_of(load_name)
    if "vrd_pooling" in meta:
        print(f"vrd pooling from checkpoint metadata: {meta['vrd_pooling']}")
        return meta["vrd_pooling"]
    return default


def apply_act_scales(det, args):
    """``--act_scales``, the deployment form of the int8 trunk, on the
    restored detector ``det``, as the JAX drivers apply it: the in-scope
    kernels of ``--int8_trunk mxu:<scope>`` or ``sim:<scope>`` stored in
    int8 with the file's static activation scales
    (``quantize_trunk_params``), then ``I2VSGG_INT8_TRUNK`` removed, so
    that no other conv quantizes on the fly. ``sim`` sets
    ``I2VSGG_INT8_PREQ_SIM=1`` (the int8-stored convs in fake-quant);
    ``mxu`` and a run without ``--act_scales`` remove it. (The JAX drivers
    leave a set value in place on ``mxu``, so that a ``sim`` run followed by
    an ``mxu`` run in one process would serve fake-quant; the port does not
    copy that.)"""
    from i2vsgg_tpu_torch.utils.params import (load_act_scales,
                                               quantize_trunk_params)
    os.environ.pop("I2VSGG_INT8_PREQ_SIM", None)
    if not args.act_scales:
        return
    kind, _, scope = (args.int8_trunk or "off").partition(":")
    if kind not in ("mxu", "sim"):
        raise ValueError("--act_scales requires --int8_trunk mxu:<scope> "
                         "or sim:<scope>")
    quantize_trunk_params(det, scope, load_act_scales(args.act_scales))
    if kind == "sim":
        os.environ["I2VSGG_INT8_PREQ_SIM"] = "1"
    os.environ.pop("I2VSGG_INT8_TRUNK", None)
    print(f"static act scales: {args.act_scales} (scope {scope!r})")


def build_trunk(net: str, dtype):
    """Stage B's own trunk for ``--net``."""
    from i2vsgg_tpu_torch.models.backbones import ResNetTrunk, VGG16Trunk
    if net == "vgg16":
        return VGG16Trunk(dtype=dtype)
    return ResNetTrunk(depth=int(net[3:]), dtype=dtype)
