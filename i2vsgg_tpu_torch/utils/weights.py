"""Weight bridge from the JAX package's parameter trees to the port's modules.

The port's modules carry the flax module names, so a flax tree maps onto a
PyTorch state dict leaf by leaf (the inverse of
``i2vsgg_tpu/utils/torch_import.py:33-47``):

* conv ``kernel`` (KH, KW, I, O) -> ``weight`` (O, I, KH, KW)
* dense ``kernel`` (I, O) -> ``weight`` (O, I)
* every other leaf keeps its name and layout: biases, and the FrozenBN
  ``scale/bias/mean/var`` buffers.

A bf16 leaf (a tree cast by ``bf16_storage_cast``) stays bf16, bit for bit;
every other float leaf becomes f32. An int8 ``kernel`` (a tree quantized by
``quantize_trunk_params`` / ``quantize_dense_params``) is transposed as
above and stays int8; its ``kernel_scale`` (F,) and ``act_scale`` (0-d)
siblings are float leaves. Load such a state dict into a module quantized
by the port's functions of the same names (``utils/params.py``), whose
int8 ``weight`` and scale buffers it then overwrites.

Only numpy crosses the boundary: the caller converts the tree's leaves with
``np.asarray``; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays (a flax ``params`` tree) -> a flat state
    dict for the matching port module, e.g.
    ``det.load_state_dict(params_from_jax(det_params))``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: tuple):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
                continue
            a = np.asarray(value)
            # a bf16 leaf (ml_dtypes' bfloat16, known here by its name only)
            # moves as its bits and stays bf16
            is_bf16 = a.dtype.name == "bfloat16"
            is_int8 = a.dtype == np.int8 and key == "kernel"
            if is_bf16:
                a = a.view(np.int16)
            elif not (is_int8 or np.issubdtype(a.dtype, np.floating)):
                raise TypeError(f"{'/'.join(prefix + (key,))}: {a.dtype} "
                                "leaves other than int8 kernels are not "
                                "ported")
            name = key
            if key == "kernel":
                name = "weight"
                if a.ndim == 4:
                    a = a.transpose(3, 2, 0, 1)
                elif a.ndim == 2:
                    a = a.T
            if is_bf16:
                t = torch.from_numpy(np.array(a, order="C")).view(
                    torch.bfloat16)
            elif is_int8:
                t = torch.from_numpy(np.array(a, order="C"))
            else:
                t = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            out[".".join(prefix + (name,))] = t

    walk(tree, ())
    return out
