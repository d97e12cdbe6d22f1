"""Question tokenization.

Copy of ``vqa_project_tpu/data/preprocess/text.py::tokenize`` on its
whitespace-split branch (what the reference's blank spacy tokenizer does
for these inputs).
"""

from __future__ import annotations

from typing import List


def tokenize(text: str) -> List[str]:
    """Lower-case, split on whitespace, then drop the LAST character of
    any token that contains '?' (so a standalone '?' becomes an empty
    token that counts toward qlen), as the reference preprocessing does."""
    toks = text.lower().split()
    return [t[:-1] if "?" in t else t for t in toks]
