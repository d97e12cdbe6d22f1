"""GloVe word embeddings with a packed .npy cache.

Copy of ``vqa_project_tpu/data/glove.py``: a (q_words, emb_dim) matrix
whose rows are filled from ``glove.6B.<emb_dim>d.txt`` for every
vocabulary word present and are zero otherwise. The matrix is cached as
``<cache_dir>/glove_<key>_<vocab_size>.npy``, the key a hash of the
GloVe file's path, size and mtime, the width and the vocabulary (the
JAX package's key, so either package reuses the other's cache). Without
a GloVe file the rows are ``random_embeddings``.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np


def random_embeddings(vocab_size: int, emb_dim: int) -> np.ndarray:
    """The word embeddings used when no GloVe file is present:
    deterministic rows from ``default_rng(1000)``, times 0.1."""
    rng = np.random.default_rng(1000)
    return (rng.standard_normal((vocab_size, emb_dim)) * 0.1).astype(
        np.float32)


def _cache_key(glove_path: str, wtoi: Dict[str, int], emb_dim: int) -> str:
    st = os.stat(glove_path)
    h = hashlib.sha1()
    h.update(f"{glove_path}:{st.st_size}:{int(st.st_mtime)}:{emb_dim}".encode())
    for w, i in sorted(wtoi.items(), key=lambda kv: kv[1]):
        h.update(w.encode("utf-8", "replace"))
        h.update(str(i).encode())
    return h.hexdigest()[:16]


def load_glove_embeddings(data_dir: str, wtoi: Dict[str, int],
                          emb_dim: int = 300, vocab_size: int = 0,
                          cache_dir: Optional[str] = None) -> np.ndarray:
    """(vocab_size, emb_dim) float32 rows from
    ``<data_dir>/glove.6B.<emb_dim>d.txt``, read once and then from the
    cache (default ``<data_dir>/_tpu_cache``). vocab_size defaults to
    max(wtoi.values()) + 1 (question ids are 1-based)."""
    if vocab_size <= 0:
        vocab_size = (max(wtoi.values()) + 1) if wtoi else 1
    glove_path = os.path.join(data_dir, f"glove.6B.{emb_dim}d.txt")
    if not os.path.exists(glove_path):
        return random_embeddings(vocab_size, emb_dim)

    cache_dir = cache_dir or os.path.join(data_dir, "_tpu_cache")
    os.makedirs(cache_dir, exist_ok=True)
    key = _cache_key(glove_path, wtoi, emb_dim)
    cache = os.path.join(cache_dir, f"glove_{key}_{vocab_size}.npy")
    if os.path.exists(cache):
        return np.load(cache)
    wanted = set(wtoi.keys())
    mat = np.zeros((vocab_size, emb_dim), dtype=np.float32)
    with open(glove_path, "r", encoding="utf-8") as f:
        for line in f:
            sp = line.rstrip().split(" ")
            if sp[0] in wanted:
                mat[wtoi[sp[0]]] = np.asarray(sp[1:], dtype=np.float32)
    np.save(cache, mat)
    return mat
