"""The port's drivers: ``python -m i2vsgg_tpu_torch.tools.serve_video``,
``...tools.test_sgg`` and ``...tools.test_det``, the counterparts of the
JAX package's ``tools/serve_video.py``, ``tools/test_sgg.py`` and
``tools/test_det.py``, with the same flags and outputs plus ``--device``.
"""
