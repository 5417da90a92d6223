"""Training observability — counterpart of ``i2vsgg_tpu/utils/logging.py``.

``MetricsLogger`` writes the reference's loss-component scalars
(``trainval_net_instance_styleD_bilinear.py:204-211, 348-382``) to a JSONL
file always and to TensorBoard where ``torch.utils.tensorboard`` imports
(the card's machine has no ``tensorboard`` package). ``StepTimer`` gives
images per second over a display interval. ``start_profiler`` traces a
window of steps with ``torch.profiler`` (the JAX package's is
``jax.profiler``) and writes a Chrome trace. In a process group
(``parallel/mesh.py``) only rank 0 writes the metrics (every rank holds the
global batch's), and each rank writes its own trace.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

from i2vsgg_tpu_torch.parallel.mesh import backend, process_index


def _summary_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class MetricsLogger:
    """Appends to ``<log_dir>/metrics.jsonl`` on rank 0; on another rank it
    writes nothing."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self._jsonl = self._tb = None
        if process_index() != 0:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = _summary_writer(log_dir) if use_tensorboard else None

    def log_scalars(self, tag: str, scalars: Dict[str, float], step: int):
        if self._jsonl is None:
            return
        rec = {"tag": tag, "step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalars(tag, {k: float(v) for k, v in
                                       scalars.items()}, step)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Images (or steps) per second since the last ``rate()`` (the reference
    prints wall-clock time per display interval, trainval_…:385-407)."""

    def __init__(self):
        self._t0 = time.time()
        self._n = 0

    def tick(self, n: int = 1):
        self._n += n

    def rate(self) -> float:
        dt = time.time() - self._t0
        r = self._n / dt if dt > 0 else 0.0
        self._t0 = time.time()
        self._n = 0
        return r


def start_profiler(log_dir: Optional[str]) -> Callable[[], None]:
    """Start a ``torch.profiler`` trace (CPU and, with a card, CUDA
    activity) when ``log_dir`` is given; the returned function stops it and
    writes ``<log_dir>/trace.json`` (in a process group,
    ``trace_rank<r>.json``, one a rank). Without ``log_dir`` both do
    nothing."""
    if not log_dir:
        return lambda: None
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()

    def stop():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        name = ("trace.json" if backend() == "none"
                else f"trace_rank{process_index()}.json")
        prof.export_chrome_trace(os.path.join(log_dir, name))
    return stop
