"""Question and answer vocabularies: IO and building.

Copy of ``vqa_project_tpu/data/vocab.py``: the reference's vocabulary
pickles, ``{'itow': {...}, 'wtoi': {...}}`` dicts, question words
1-indexed (0 is the pad / unknown id), answers 0-indexed; and the
builders the preprocessors use.
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


def build_question_vocab(token_lists) -> Tuple[Dict[int, str], Dict[str, int]]:
    """1-indexed question vocabulary over all tokens, in order of first
    appearance (index 0 is the pad / unknown id)."""
    counts: Dict[str, int] = {}
    for toks in token_lists:
        for w in toks:
            counts[w] = counts.get(w, 0) + 1
    vocab = list(counts.keys())
    itow = {i + 1: w for i, w in enumerate(vocab)}
    wtoi = {w: i + 1 for i, w in enumerate(vocab)}
    return itow, wtoi


def build_answer_vocab(answers, n_answers: int = 3000
                       ) -> Tuple[Dict[int, str], Dict[str, int]]:
    """0-indexed vocabulary of the ``n_answers`` most frequent answers
    (ties: the larger string first, as the reference's sort of
    (count, word) pairs in reverse)."""
    counts: Dict[str, int] = {}
    for a in answers:
        counts[a] = counts.get(a, 0) + 1
    ranked = sorted(((c, w) for w, c in counts.items()), reverse=True)
    vocab = [w for _, w in ranked[:n_answers]]
    itow = {i: w for i, w in enumerate(vocab)}
    wtoi = {w: i for i, w in enumerate(vocab)}
    return itow, wtoi
