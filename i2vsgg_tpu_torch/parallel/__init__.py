"""Data parallelism on ``torch.distributed`` (``parallel/mesh.py``), the
port's counterpart of ``i2vsgg_tpu/parallel/``."""
