"""VQA v2 text preprocessing: combine QA, tokenize, build vocabularies,
compute soft answer scores.

    python -m vqa_project_tpu_torch.data.preprocess.text --data train val \
        test --raw_dir raw --out_dir data

Counterpart of ``vqa_project_tpu/data/preprocess/text.py`` (the
reference's data/preprocess_text.py), writing the same artifacts byte
for byte: vqa_{phase}_combined.json, vqa_{phase}_toked.json,
{phase}_q_dict.p (1-indexed), {phase}_a_dict.p (0-indexed, top-n) and
vqa_{phase}_final_{n}.json with per-question
answers_w_scores = [(answer, votes / accepted votes)].

Tokenization is the JAX rule: spacy's blank-vocab Tokenizer when spacy
and its ``en_core_web_sm`` model load, else the whitespace split of
``data/text.py::tokenize``, which is what the blank tokenizer does on
these inputs; either way a token holding '?' loses its last character.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
from typing import List

from vqa_project_tpu_torch.data.text import tokenize as _whitespace_tokenize
from vqa_project_tpu_torch.data.vocab import (build_answer_vocab,
                                              build_question_vocab,
                                              save_vocab)


@functools.cache
def _spacy_tokenizer():
    """spacy's blank Tokenizer over en_core_web_sm's vocabulary (the
    reference's construction, preprocess_text.py:32-33), or None when
    spacy or the model is not installed (nothing is downloaded)."""
    try:
        import spacy
        from spacy.tokenizer import Tokenizer

        return Tokenizer(spacy.load("en_core_web_sm").vocab)
    except (ImportError, OSError):
        return None


def tokenize(text: str) -> List[str]:
    """The reference's tokenization (preprocess_text.py:106-107): lower
    case, split on whitespace, then any token containing '?' loses its
    LAST character, so a standalone '?' becomes an empty token that
    enters the question vocabulary and counts toward qlen."""
    tokenizer = _spacy_tokenizer()
    if tokenizer is None:
        return _whitespace_tokenize(text)
    toks = [t.text for t in tokenizer(text.lower())]
    return [t[:-1] if "?" in t else t for t in toks]


def combine_qa(questions: dict, annotations: List[dict],
               phase: str, out_dir: str = ".") -> List[dict]:
    """Join the VQA v2 questions json with its annotations json
    (qid-aligned, preprocess_text.py:113-135)."""
    data = []
    for i, q in enumerate(questions["questions"]):
        ann = annotations[i]
        if q["question_id"] != ann["question_id"]:
            raise ValueError(f"question {i}: id {q['question_id']} but "
                             f"annotation id {ann['question_id']}")
        answers = [a["answer"] for a in ann["answers"]]
        data.append({
            "question": q["question"],
            "question_id": q["question_id"],
            "image_id": str(q["image_id"]),
            "answer": ann["multiple_choice_answer"],
            "answers": collections.Counter(answers).most_common(),
        })
    _dump(data, os.path.join(out_dir, f"vqa_{phase}_combined.json"))
    return data


def tokenize_questions(rows: List[dict], phase: str,
                       out_dir: str = ".") -> List[dict]:
    for row in rows:
        row["question_toked"] = tokenize(row["question"])
    _dump(rows, os.path.join(out_dir, f"vqa_{phase}_toked.json"))
    return rows


def process_questions(rows: List[dict], phase: str, out_dir: str = "."):
    itow, wtoi = build_question_vocab(r["question_toked"] for r in rows)
    save_vocab(os.path.join(out_dir, f"{phase}_q_dict.p"), itow, wtoi)
    return itow, wtoi


def process_answers(rows: List[dict], phase: str, n_answers: int = 3000,
                    out_dir: str = "."):
    """Top-n answer vocab + per-question normalized answer scores
    (preprocess_text.py:37-65)."""
    itow, wtoi = build_answer_vocab((r["answer"] for r in rows), n_answers)
    save_vocab(os.path.join(out_dir, f"{phase}_a_dict.p"), itow, wtoi)

    vocab = set(wtoi)
    for row in rows:
        accepted = sum(c for w, c in row["answers"] if w in vocab)
        row["answers_w_scores"] = [
            (w, c / accepted) for w, c in row["answers"] if w in vocab
        ] if accepted else []
    _dump(rows, os.path.join(out_dir, f"vqa_{phase}_final_{n_answers}.json"))
    return rows


def run_phase(phase: str, raw_dir: str = "raw", out_dir: str = ".",
              n_answers: int = 3000):
    """Full pipeline for one phase (preprocess_text.py main)."""
    if phase != "test":
        questions = _load(os.path.join(
            raw_dir, f"v2_OpenEnded_mscoco_{phase}2014_questions.json"))
        annotations = _load(os.path.join(
            raw_dir, f"v2_mscoco_{phase}2014_annotations.json"))
        rows = combine_qa(questions, annotations["annotations"],
                          phase, out_dir)
        rows = tokenize_questions(rows, phase, out_dir)
        if phase == "train":
            process_questions(rows, phase, out_dir)
        process_answers(rows, phase, n_answers, out_dir)
    else:
        questions = _load(os.path.join(
            raw_dir, "v2_OpenEnded_mscoco_test2015_questions.json"))
        rows = [{"question": q["question"],
                 "question_id": q["question_id"],
                 "image_id": str(q["image_id"])}
                for q in questions["questions"]]
        tokenize_questions(rows, phase, out_dir)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Preprocessing for VQA v2 text data (PyTorch/CUDA port)")
    p.add_argument("--data", nargs="+", default=["train", "test"])
    p.add_argument("--nanswers", type=int, default=3000)
    p.add_argument("--raw_dir", type=str, default="raw")
    p.add_argument("--out_dir", type=str, default=".")
    args, unparsed = p.parse_known_args(argv)
    if unparsed:
        raise SystemExit(f"Unknown argument: {unparsed}")
    for phase in args.data:
        print(f"processing {phase} data")
        run_phase(phase, args.raw_dir, args.out_dir, args.nanswers)
    print("Done")


if __name__ == "__main__":
    main()
