"""GloVe word-vector loading for the semantic predicate/object embeddings —
the port's own copy of ``i2vsgg_tpu/models/glove.py``, with
``load_predicate_vectors`` (``tools/trainval_sgg.py:31-43`` in the JAX
package) beside it.

Host-side, numpy-only rebuild of ``lib/model/faster_rcnn/glove.py:4-59`` and
``get_obj_prd_vecs`` (``resnet_SGG_emb.py:38-63``): parses a GloVe ``.txt``
file, with the reference's fallbacks for out-of-vocabulary words — split on
spaces/hyphens and average the constituent vectors.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np


class GloVe:
    def __init__(self, path: str, dim: int = 300):
        self.dim = dim
        self.vectors: Dict[str, np.ndarray] = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                if len(parts) != dim + 1:
                    continue
                self.vectors[parts[0]] = np.asarray(parts[1:], dtype=np.float32)

    def _lookup_word(self, word: str) -> np.ndarray | None:
        w = word.lower().strip()
        if w in self.vectors:
            return self.vectors[w]
        # fallbacks: strip punctuation variants, then split compounds
        for sep in (" ", "-", "_"):
            if sep in w:
                parts = [p for p in w.split(sep) if p]
                vecs = [self.vectors[p] for p in parts if p in self.vectors]
                if vecs:
                    return np.mean(vecs, axis=0)
        return None

    def __getitem__(self, word: str) -> np.ndarray:
        v = self._lookup_word(word)
        if v is None:
            return np.zeros(self.dim, dtype=np.float32)
        return v


def get_obj_prd_vecs(glove_path: str, predicate_file: str,
                     object_list: Sequence[str] = (), dim: int = 300):
    """(n_obj, 300), (n_prd, 300) semantic vectors.
    [resnet_SGG_emb.py:38-63]

    ``object_list`` may be empty (the predicate vectors alone): the JAX
    driver's ``load_predicate_vectors`` calls this function without one,
    which the JAX signature does not accept."""
    glove = GloVe(glove_path, dim)
    with open(predicate_file) as f:
        prds: List[str] = json.load(f)
    obj_vecs = np.asarray([glove[o] for o in object_list],
                          np.float32).reshape(len(object_list), dim)
    prd_vecs = np.stack([glove[p] for p in prds]).astype(np.float32)
    return obj_vecs, prd_vecs


def load_predicate_vectors(args) -> np.ndarray:
    """GloVe predicate vectors (n_rel, 300) from ``args.glove_path`` and
    ``args.predicate_file``, or, when either file is absent (smoke runs),
    ``np.random.RandomState(0).randn(args.num_relations, 300)`` in f32: the
    JAX drivers' fallback, value for value."""
    if os.path.exists(args.glove_path) and os.path.exists(args.predicate_file):
        _, prd = get_obj_prd_vecs(args.glove_path, args.predicate_file)
        return prd.astype(np.float32)
    print(f"WARNING: glove/predicates not found "
          f"({args.glove_path}, {args.predicate_file}); "
          "using fixed random predicate vectors")
    return np.random.RandomState(0).randn(
        args.num_relations, 300).astype(np.float32)
