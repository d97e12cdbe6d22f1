"""Medical-VQA preprocessors: ImageCLEF-VQA-Med, MIMIC-CXR, NIH.

Copy of ``vqa_project_tpu/data/preprocess/medical.py`` (the same
artifacts from the same dumps), tokenizing with ``data/text.py``.

    python -m vqa_project_tpu_torch.data.preprocess.medical imageclef \
        --detect_pt d.pt --gaze_pt g.pt --gaze_on_detect_pt gd.pt \
        --qa train.txt val.txt --out_dir data

The shared core is the 3-source region merge: YOLO-detected boxes,
gaze-derived boxes and gaze-on-detect boxes (17 each) are concatenated
into 51 nodes per image;
detect/gaze dumps carry 6 trailing non-feature columns (bbox xyxy at
[-6:-2]), gaze-on-detect carries 4 (bbox at [-4:]).

Each ``*.pt`` dump is a torch-saved dict
{'feat': [tensor(n_i, feat+extras)], 'image_id': [str], 'img_sizes':
[(h, w)]}. Images appearing in all three dumps with >= 17 boxes each are
kept (preprocess_imageclef.py:43-65).

Text pipelines:
- ImageCLEF: '|'-delimited QA txts filtered to valid images -> single
  vqa_imageclef_final.json with question_id = row index and
  answers = {answer: 10} (dict form).
- MIMIC: mimic_all_qa_pairs.csv split 10k train / 3k test rows; answers
  split on ';' and Counter-ranked (preprocess_mimic.py:138-160).
"""

from __future__ import annotations

import collections
import csv
import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from vqa_project_tpu_torch.data.datasets import write_sizes_csv
from vqa_project_tpu_torch.data.text import tokenize
from vqa_project_tpu_torch.data.vocab import (build_answer_vocab,
                                              build_question_vocab, save_vocab)
from vqa_project_tpu_torch.data.zarr_store import ZarrWriter

N_OBJ_PER_SOURCE = 17


def _load_pt(path: str) -> Dict:
    """A region-feature dump (a pickled dict of tensors, lists and
    tuples, hence ``weights_only=False``: load only trusted dumps)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def merge_box_feat(detect: Dict, gaze: Dict, gaze_on_detect: Dict,
                   n_obj: int = N_OBJ_PER_SOURCE
                   ) -> Dict[str, Dict[str, np.ndarray]]:
    """Merge the three region-feature dumps into 3*n_obj-node images.

    Returns {image_id: {'feat': (3n, F), 'boxes': (3n, 4),
                        'size': (w, h)}} for images valid in all dumps.
    """
    gaze_index = {iid: i for i, iid in enumerate(gaze["image_id"])}
    gd_index = {iid: i for i, iid in enumerate(gaze_on_detect["image_id"])}
    out = {}
    for det_feat, image_id, img_sizes in zip(
            detect["feat"], detect["image_id"], detect["img_sizes"]):
        det_feat = np.asarray(det_feat, dtype=np.float32)
        if det_feat.shape[0] < n_obj:
            continue
        gi = gaze_index.get(image_id)
        di = gd_index.get(image_id)
        if gi is None or di is None:
            continue
        gaze_feat = np.asarray(gaze["feat"][gi], dtype=np.float32)
        gd_feat = np.asarray(gaze_on_detect["feat"][di], dtype=np.float32)
        if gaze_feat.shape[0] < n_obj or gd_feat.shape[0] < n_obj:
            continue
        det_feat, gaze_feat, gd_feat = (
            det_feat[:n_obj], gaze_feat[:n_obj], gd_feat[:n_obj])
        # detect/gaze: 6 trailing extras with bbox at [-6:-2];
        # gaze-on-detect: bbox is the trailing 4
        feat = np.concatenate(
            [det_feat[:, :-6], gaze_feat[:, :-6], gd_feat[:, :-4]], axis=0)
        boxes = np.concatenate(
            [det_feat[:, -6:-2], gaze_feat[:, -6:-2], gd_feat[:, -4:]],
            axis=0)
        key = os.path.basename(str(image_id))
        h, w = int(img_sizes[0]), int(img_sizes[1])
        out[key] = {"feat": feat, "boxes": boxes, "size": (w, h)}
    return out


def write_feature_artifacts(merged: Dict, prefix: str, out_dir: str = "."):
    """Emit <prefix>features.zarr / <prefix>boxes.zarr /
    <prefix>image_size.csv from a merge result."""
    feats = ZarrWriter(os.path.join(out_dir, f"{prefix}features.zarr"))
    boxes = ZarrWriter(os.path.join(out_dir, f"{prefix}boxes.zarr"))
    ids = list(merged.keys())
    for iid in ids:
        feats.create_dataset(iid, merged[iid]["feat"])
        boxes.create_dataset(iid, merged[iid]["boxes"])
    write_sizes_csv(os.path.join(out_dir, f"{prefix}image_size.csv"),
                    {i: merged[i]["size"] for i in ids})


def _finalize_text(rows: List[dict], q_dict_path: str, a_dict_path: str,
                   final_json_path: str, answers_are_dict: bool):
    for row in rows:
        row["question_toked"] = tokenize(row["question"])
    itow, wtoi = build_question_vocab(r["question_toked"] for r in rows)
    save_vocab(q_dict_path, itow, wtoi)

    a_itow, a_wtoi = build_answer_vocab(
        (r["answer"] for r in rows), n_answers=10**9)  # keep all answers
    save_vocab(a_dict_path, a_itow, a_wtoi)

    for row in rows:
        items = (row["answers"].items() if answers_are_dict
                 else row["answers"])
        accepted = sum(c for w, c in items if w in a_wtoi)
        items = (row["answers"].items() if answers_are_dict
                 else row["answers"])
        row["answers_w_scores"] = [
            (w, c / accepted) for w, c in items if w in a_wtoi
        ] if accepted else []
    with open(final_json_path, "w") as f:
        json.dump(rows, f)


def preprocess_imageclef(detect_pt: str, gaze_pt: str, gaze_on_detect_pt: str,
                         qa_txts: Sequence[str], out_dir: str = "."):
    """Full ImageCLEF pipeline (features + text)."""
    merged = merge_box_feat(_load_pt(detect_pt), _load_pt(gaze_pt),
                            _load_pt(gaze_on_detect_pt))
    write_feature_artifacts(merged, "imageclef_", out_dir)

    rows = []
    valid = set(merged.keys())
    for txt in qa_txts:
        with open(txt) as f:
            for raw in csv.reader(f, delimiter="|"):
                if raw[0] + ".jpg" not in valid:
                    continue
                rows.append({
                    "question": raw[1],
                    "question_id": len(rows),
                    "image_id": raw[0],
                    "answer": raw[2],
                    "answers": {raw[2]: 10},
                })
    _finalize_text(
        rows,
        os.path.join(out_dir, "imageclef_q_dict.p"),
        os.path.join(out_dir, "imageclef_a_dict.p"),
        os.path.join(out_dir, "vqa_imageclef_final.json"),
        answers_are_dict=True)
    return rows


def preprocess_mimic(detect_pt: str, gaze_pt: str, gaze_on_detect_pt: str,
                     qa_csv: str, split: str, out_dir: str = ".",
                     train_rows: int = 10_000, test_rows: int = 3_000):
    """Full MIMIC pipeline for one split ('train' or 'val')."""
    merged = merge_box_feat(_load_pt(detect_pt), _load_pt(gaze_pt),
                            _load_pt(gaze_on_detect_pt))
    # mimic keys are dicom ids without extension (preprocess_mimic.py:80)
    merged = {k[:-4] if k.endswith(".jpg") else k: v
              for k, v in merged.items()}
    write_feature_artifacts(merged, f"mimic_{split}_", out_dir)

    rows = []
    with open(qa_csv, newline="") as f:
        reader = list(csv.DictReader(f))
    lo, hi = ((0, train_rows) if split == "train"
              else (train_rows, train_rows + test_rows))
    for i, raw in enumerate(reader[lo:hi], start=lo):
        if raw["dicom_id"] not in merged:
            continue
        answers = raw["answer"].split(";")
        counted = collections.Counter(answers).most_common()
        rows.append({
            "question": raw["question"],
            "question_id": i,
            "image_id": raw["dicom_id"],
            "answer": counted[0][0],
            "answers": counted,
        })
    _finalize_text(
        rows,
        os.path.join(out_dir, f"mimic_q_{split}_dict.p"),
        os.path.join(out_dir, f"mimic_a_{split}_dict.p"),
        os.path.join(out_dir, f"vqa_mimic_{split}_final.json"),
        answers_are_dict=False)
    return rows


def preprocess_nih(detect_pt: str, gaze_pt: str, gaze_on_detect_pt: str,
                   out_dir: str = "."):
    """NIH chest-X-ray variant: feature merge only (the reference's main
    runs only parse_box_feat, preprocess_nih.py:261-269)."""
    merged = merge_box_feat(_load_pt(detect_pt), _load_pt(gaze_pt),
                            _load_pt(gaze_on_detect_pt))
    write_feature_artifacts(merged, "nih_", out_dir)
    return merged


def main(argv=None):
    """CLI covering the three medical preprocessors
    (imageclef/preprocess_imageclef.py, mimic/preprocess_mimic.py,
    nih/preprocess_nih.py __main__ blocks)."""
    import argparse

    p = argparse.ArgumentParser(description="Medical VQA preprocessing")
    p.add_argument("dataset", choices=["imageclef", "mimic", "nih"])
    p.add_argument("--detect_pt", required=True)
    p.add_argument("--gaze_pt", required=True)
    p.add_argument("--gaze_on_detect_pt", required=True)
    p.add_argument("--qa", nargs="+", default=[],
                   help="imageclef: '|'-delimited QA txts; "
                        "mimic: the all-qa-pairs csv")
    p.add_argument("--split", default="train", choices=["train", "val"])
    p.add_argument("--out_dir", default=".")
    args, unparsed = p.parse_known_args(argv)
    if unparsed:
        raise SystemExit(f"Unknown argument: {unparsed}")

    if args.dataset == "imageclef":
        preprocess_imageclef(args.detect_pt, args.gaze_pt,
                             args.gaze_on_detect_pt, args.qa, args.out_dir)
    elif args.dataset == "mimic":
        if len(args.qa) != 1:
            raise SystemExit("mimic needs exactly one --qa csv")
        preprocess_mimic(args.detect_pt, args.gaze_pt,
                         args.gaze_on_detect_pt, args.qa[0], args.split,
                         args.out_dir)
    else:
        preprocess_nih(args.detect_pt, args.gaze_pt,
                       args.gaze_on_detect_pt, args.out_dir)
    print("Done")


if __name__ == "__main__":
    main()
