"""Data parallelism on ``torch.distributed`` — counterpart of
``i2vsgg_tpu/parallel/mesh.py``.

The JAX package shards each batch over a ``jax.sharding.Mesh`` and lets XLA
insert the gradient ``psum``; its losses are means over the *global* batch.
The port runs one process per card, the PyTorch idiom (``torchrun
--nproc_per_node N``), and computes the same thing by hand:

* ``maybe_init_distributed`` joins the process group from torchrun's
  variables, or from the JAX package's (``I2VSGG_COORD`` /
  ``JAX_COORDINATOR_ADDRESS`` with ``JAX_NUM_PROCESSES`` /
  ``JAX_PROCESS_ID``), so that a launch written for the JAX package starts
  the port the same way; ``nccl`` on a card, ``gloo`` on the CPU;
* ``host_shard`` gives each process its slice of the ratio-sorted roidb, as
  the JAX loader does;
* every loss term is its local sum over the ``global_sum`` of its count, and
  ``all_reduce_grads`` sums the gradients over the ranks before the update:
  the gradient of the global-batch loss (a mean of per-rank means would
  differ wherever the counts differ between ranks);
* ``replicate`` broadcasts rank 0's parameters and buffers after init or
  restore, so the replicas start equal;
* for serving inside one process, ``make_mesh`` lists the devices,
  ``replicate`` copies the program's modules onto each and ``shard_batch``
  splits a batch into one row chunk a device.

The model is not wrapped in ``DistributedDataParallel``: Stage A runs two
passes (``train_source``, ``target_pass``) into one backward, with
parameters that one of them leaves unused, which DDP's forward contract does
not fit. The explicit all-reduce after ``backward()`` is JAX's ``psum``.

Not ported: ``data_sharding`` and ``replicated``, which return
``jax.sharding`` objects; PyTorch has no such object (a device list and the
row chunks of ``shard_batch`` stand in for them).
"""

from __future__ import annotations

import atexit
import copy
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# gradients and parameters are reduced in flat buckets of about this size
BUCKET_BYTES = 64 * 2 ** 20


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The world size (1 outside a process group): ``jax.process_count``."""
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    """This process's rank (0 outside a process group):
    ``jax.process_index``."""
    return dist.get_rank() if _initialized() else 0


def backend() -> str:
    """The process group's backend, or ``"none"`` outside one."""
    return dist.get_backend() if _initialized() else "none"


def maybe_init_distributed(device: str | torch.device = "cuda") -> bool:
    """Join the process group when a launcher's variables are set; True
    when this process is in one.

    * torchrun (``WORLD_SIZE`` and ``RANK``, with ``MASTER_ADDR`` /
      ``MASTER_PORT``): the group is initialized even at world size 1, so a
      one-card torchrun run takes the collective path of an N-card one (the
      JAX function returns False for one process);
    * the JAX package's ``I2VSGG_COORD`` or ``JAX_COORDINATOR_ADDRESS``
      (``host:port``) with ``JAX_NUM_PROCESSES`` > 1 and ``JAX_PROCESS_ID``.

    The backend is ``nccl`` when ``device`` is a CUDA device, else
    ``gloo``; on CUDA the process takes card ``LOCAL_RANK`` (without it,
    its rank modulo the local card count). With none of the variables set
    it initializes nothing and returns False. Idempotent: in a group that is
    already initialized (a test harness may start gloo itself) it returns
    True and changes nothing."""
    if _initialized():
        return True
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:
        world, rank, method = int(env["WORLD_SIZE"]), int(env["RANK"]), \
            "env://"
    else:
        coord = env.get("I2VSGG_COORD") or env.get("JAX_COORDINATOR_ADDRESS")
        world = int(env.get("JAX_NUM_PROCESSES", "1"))
        if not coord or world <= 1:
            return False
        rank, method = int(env.get("JAX_PROCESS_ID", "0")), f"tcp://{coord}"
    cuda = torch.device(device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(_local_rank())
    dist.init_process_group("nccl" if cuda else "gloo", init_method=method,
                            world_size=world, rank=rank)
    atexit.register(_destroy)
    return True


def _destroy():
    if _initialized():
        dist.destroy_process_group()


def _local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK``, else the rank
    modulo the local card count, else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    rank = int(os.environ.get("RANK", os.environ.get("JAX_PROCESS_ID", "0")))
    return rank % n if n else 0


def sync_global_devices(tag: str) -> None:
    """A barrier of every process (e.g. after rank 0 alone wrote a
    checkpoint); ``tag`` names it in the JAX package and is unused here.
    A no-op outside a process group."""
    del tag
    if not _initialized():
        return
    if backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def host_shard(entries: Sequence, batch_size: int) -> list:
    """This process's contiguous slice of a (ratio-sorted) roidb: each
    process loads 1/world of it, aspect grouping intact, every slice
    truncated to one common multiple of ``batch_size`` so that every rank
    takes the same number of steps (the collectives stay aligned). JAX
    ``mesh.py:67-78``."""
    n = process_count()
    if n == 1:
        return list(entries)
    i = process_index()
    per = len(entries) // n
    per -= per % max(batch_size, 1)
    return list(entries[i * per:(i + 1) * per])


def make_mesh(n_devices: int | Sequence = 0,
              device: str | torch.device = "cuda") -> List[torch.device]:
    """The serving mesh of one process: ``n_devices`` devices of
    ``device``'s type (0: every card; on the CPU, 1), or an explicit device
    list. On CUDA, cards ``cuda:0`` to ``cuda:n-1`` (more than
    ``torch.cuda.device_count()`` is refused); on the CPU, ``n`` times
    ``cpu`` (the twin of the JAX tests' virtual CPU devices). An explicit
    list may name a device twice (two replicas on one card)."""
    if not isinstance(n_devices, int):
        mesh = [torch.device(d) for d in n_devices]
        if not mesh:
            raise ValueError("an empty device list")
        return mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh requested but "
                               "torch.cuda.is_available() is False")
        count = torch.cuda.device_count()
        n = n_devices or count
        if n > count:
            raise ValueError(f"a mesh of {n} cards, but this process sees "
                             f"{count}")
        return [torch.device("cuda", i) for i in range(n)]
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}")
    return [torch.device("cpu")] * max(n_devices, 1)


def take_rows(x, rows: Sequence[int]):
    """Rows ``rows`` of a batch leaf: a tensor or numpy array by its
    leading dim, an object with ``select_rows`` (``Conv1Planes``) by that;
    anything else (a scalar, a string) unchanged."""
    if torch.is_tensor(x):
        return x[torch.as_tensor(list(rows), dtype=torch.long,
                                 device=x.device)]
    if isinstance(x, np.ndarray):
        return x[np.asarray(rows, np.int64)]
    if hasattr(x, "select_rows"):
        return x.select_rows(rows)
    return x


def _to(x, dev: torch.device):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    if torch.is_tensor(x) or hasattr(x, "select_rows"):
        return x.to(dev)
    return x


def shard_batch(batch: Dict[str, Any], mesh: Sequence[torch.device]
                ) -> List[Dict[str, Any]]:
    """Split every array of ``batch`` (a dict of tensors, numpy arrays or
    ``Conv1Planes``) by its leading dim into ``len(mesh)`` row chunks, chunk
    ``i`` moved to ``mesh[i]``. The leading dim must divide evenly (as
    under JAX's sharding); pad a ragged batch first."""
    n = len(mesh)
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows over a mesh of {n} "
                         "devices: pad it to a multiple first")
    k = rows // n
    return [{key: _to(take_rows(x, range(i * k, (i + 1) * k)), d)
             for key, x in batch.items()} for i, d in enumerate(mesh)]


def replicate(tree: Any, mesh: Optional[Sequence[torch.device]] = None):
    """Two roles, by ``mesh``:

    * serving (a mesh given): copies of ``tree`` (a module, or a tuple or
      list of modules), one moved onto each device of the mesh; returns the
      list of copies;
    * training (no mesh): every parameter and buffer of the module ``tree``
      broadcast in place from rank 0 (a no-op outside a process group), so
      that the replicas start equal whatever each rank's init or restore
      drew; returns ``tree``."""
    if mesh is not None:
        def moved(m, dev):
            return m.to(dev) if hasattr(m, "to") else m
        out = []
        for dev in mesh:
            c = copy.deepcopy(tree)
            out.append(type(c)(moved(m, dev) for m in c)
                       if isinstance(c, (tuple, list)) else moved(c, dev))
        return out
    if _initialized():
        tensors = [t.data for t in tree.parameters()] + \
            [t for t in tree.buffers()]
        _coalesced(tensors, lambda flat: dist.broadcast(flat, src=0))
    return tree


def _collective_device(t: torch.Tensor) -> torch.device:
    """Where a collective on ``t`` runs: NCCL takes CUDA tensors only."""
    if backend() == "nccl" and t.device.type != "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


@torch.no_grad()
def _coalesced(tensors: List[torch.Tensor], op,
               bucket_bytes: int = BUCKET_BYTES):
    """Run ``op`` (an in-place collective on one flat tensor) over
    ``tensors`` in buckets: consecutive tensors of one dtype and device,
    flattened, up to ``bucket_bytes`` a bucket, then copied back. Every
    rank must pass the same list (the same shapes, in the same order)."""
    i = 0
    while i < len(tensors):
        j, size = i, 0
        t0 = tensors[i]
        while (j < len(tensors) and tensors[j].dtype == t0.dtype
               and tensors[j].device == t0.device
               and (j == i or size + tensors[j].numel() * t0.element_size()
                    <= bucket_bytes)):
            size += tensors[j].numel() * t0.element_size()
            j += 1
        group = tensors[i:j]
        dev = _collective_device(t0)
        flat = torch.cat([t.reshape(-1) for t in group]).to(dev)
        op(flat)
        flat = flat.to(t0.device)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        i = j


def all_reduce_grads(params: Sequence[torch.Tensor],
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum every parameter's gradient over the ranks, in place, in flat
    buckets. A parameter whose ``.grad`` is None gets a zero gradient first,
    so that every rank reduces the same buckets over the same fixed list
    (the optimizer's trainable params, in its order). A no-op outside a
    process group."""
    if not _initialized():
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _coalesced([p.grad for p in params], dist.all_reduce, bucket_bytes)


@torch.no_grad()
def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (a detached copy; outside a process group
    the copy itself): loss normalizers, counts and metrics. Not
    differentiable."""
    out = t.detach().clone()
    if not _initialized():
        return out
    dev = _collective_device(out)
    red = out.to(dev)
    dist.all_reduce(red)
    return red.to(out.device)
