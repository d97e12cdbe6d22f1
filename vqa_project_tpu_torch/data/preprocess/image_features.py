"""Bottom-up-attention TSV -> zarr feature stores.

    python -m vqa_project_tpu_torch.data.preprocess.image_features \
        --data trainval test --raw_dir raw --out_dir data

Counterpart of ``vqa_project_tpu/data/preprocess/image_features.py``
(the reference's data/preprocess_image.py): reads the Faster R-CNN
36-box TSVs (image_id, image_w, image_h, num_boxes, boxes, features;
base64 float32 payloads) and writes the same artifacts,
{phase}.zarr, {phase}_boxes.zarr and {phase}_image_size.csv (columns
are image ids, row 0 the width, row 1 the height), which either
package reads.
"""

from __future__ import annotations

import argparse
import base64
import csv
import os
import sys
from typing import Dict, List

import numpy as np

from vqa_project_tpu_torch.data.store import write_sizes_csv
from vqa_project_tpu_torch.data.zarr_store import ZarrWriter

# a 36 x 2048 float32 feature field is ~400 kB of base64
csv.field_size_limit(sys.maxsize)

FIELDNAMES = ["image_id", "image_w", "image_h",
              "num_boxes", "boxes", "features"]

DEFAULT_TSVS = {
    "trainval": ["trainval_36/"
                 "trainval_resnet101_faster_rcnn_genome_36.tsv"],
    "test": ["test2015_36/"
             "test2015_resnet101_faster_rcnn_genome_36.tsv"],
}


def features_to_zarr(phase: str, infiles: List[str] = None,
                     out_dir: str = ".", raw_dir: str = "raw") -> None:
    """Convert ``infiles`` (default: the published TSV layout,
    ``DEFAULT_TSVS[phase]`` under ``raw_dir``) into the phase's zarr
    feature and box stores and its size CSV in ``out_dir``."""
    if infiles is None:
        names = DEFAULT_TSVS.get(phase)
        if not names:
            raise SystemExit("Unrecognised phase")
        infiles = [os.path.join(raw_dir, n) for n in names]

    boxes = ZarrWriter(os.path.join(out_dir, f"{phase}_boxes.zarr"))
    features = ZarrWriter(os.path.join(out_dir, f"{phase}.zarr"))
    image_size: Dict[str, tuple] = {}
    for infile in infiles:
        with open(infile, "r") as f:
            reader = csv.DictReader(f, delimiter="\t",
                                    fieldnames=FIELDNAMES)
            print(f"Converting {infile} to zarr...")
            for item in reader:
                iid = str(item["image_id"])
                n = int(item["num_boxes"])
                arrs = {}
                for field in ("boxes", "features"):
                    raw = base64.decodebytes(item[field].encode("utf-8"))
                    arrs[field] = np.frombuffer(
                        raw, dtype=np.float32).reshape(n, -1)
                boxes.create_dataset(iid, arrs["boxes"])
                features.create_dataset(iid, arrs["features"])
                image_size[iid] = (int(item["image_w"]),
                                   int(item["image_h"]))

    print("Writing image sizes csv...")
    write_sizes_csv(os.path.join(out_dir, f"{phase}_image_size.csv"),
                    image_size)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Preprocessing for VQA v2 image data (PyTorch/CUDA "
                    "port)")
    p.add_argument("--data", nargs="+", default=["trainval", "test"])
    p.add_argument("--out_dir", type=str, default=".")
    p.add_argument("--raw_dir", type=str, default="raw",
                   help="directory the downloader unzipped the TSV "
                        "archives into (default: ./raw)")
    args, unparsed = p.parse_known_args(argv)
    if unparsed:
        raise SystemExit(f"Unknown argument: {unparsed}")
    for phase in args.data:
        print("Converting features tsv to zarr file...")
        features_to_zarr(phase, out_dir=args.out_dir, raw_dir=args.raw_dir)
    print("Done")


if __name__ == "__main__":
    main()
