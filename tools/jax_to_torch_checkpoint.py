#!/usr/bin/env python
"""Convert a JAX package checkpoint into the PyTorch port's format.

Reads one ``step_%08d`` directory that ``i2vsgg_tpu.train.checkpoint.
save_checkpoint`` wrote (the orbax tree; only its ``params`` are kept),
maps the flax parameter tree onto the port's state-dict names with
``i2vsgg_tpu_torch/utils/weights.py::params_from_jax`` (conv and dense
kernels transposed to PyTorch's layouts), and writes
``<out_dir>/step_%08d/{model.pt, metadata.json}`` with
``i2vsgg_tpu_torch.train.checkpoint.save_checkpoint``, the metadata copied
as it is (``vrd_pooling``, ``pooling_mode``, ...). The port's drivers then
take ``--load_name <out_dir>/<step>``.

Usage (with JAX installed; the port itself never imports JAX):
  python tools/jax_to_torch_checkpoint.py models/res101/MVRD/session_1/7 \\
      torch_models/res101/MVRD/session_1 [--step 7]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def convert(jax_ckpt_dir: str, step: int, out_dir: str,
            out_step: int | None = None) -> str:
    """Step ``step`` of the JAX checkpoint directory ``jax_ckpt_dir`` ->
    step ``out_step`` (default ``step``) of the port's ``out_dir``.
    Returns the written step directory."""
    import jax
    from i2vsgg_tpu.train.checkpoint import _ckpt_path, _load_tree
    from i2vsgg_tpu_torch.train.checkpoint import save_checkpoint
    from i2vsgg_tpu_torch.utils.weights import params_from_jax

    path = _ckpt_path(jax_ckpt_dir, step)
    params = jax.tree_util.tree_map(np.asarray, _load_tree(path)["params"])
    with open(os.path.join(path, "metadata.json")) as f:
        metadata = json.load(f)
    return save_checkpoint(out_dir, params_from_jax(params),
                           step if out_step is None else out_step, metadata)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("load_name", help="<jax ckpt_dir>/<step>")
    p.add_argument("out_dir", help="the port's checkpoint directory")
    p.add_argument("--step", type=int, default=None,
                   help="step number to write (default: the JAX step)")
    a = p.parse_args(argv)
    written = convert(os.path.dirname(a.load_name),
                      int(os.path.basename(a.load_name)), a.out_dir, a.step)
    print(f"wrote {written}")
    return written


if __name__ == "__main__":
    main()
