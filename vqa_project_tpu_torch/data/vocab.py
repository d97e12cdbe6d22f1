"""Question and answer vocabulary IO.

The reader and writer of ``vqa_project_tpu/data/vocab.py``: the
reference's vocabulary pickles, ``{'itow': {...}, 'wtoi': {...}}``
dicts, question words 1-indexed (0 is the pad / unknown id), answers
0-indexed.
"""

from __future__ import annotations

import pickle
from typing import Dict, Tuple


def load_vocab(path: str) -> Tuple[Dict[int, str], Dict[str, int]]:
    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["itow"], d["wtoi"]


def save_vocab(path: str, itow: Dict[int, str], wtoi: Dict[str, int]) -> None:
    with open(path, "wb") as f:
        pickle.dump({"itow": itow, "wtoi": wtoi}, f)
