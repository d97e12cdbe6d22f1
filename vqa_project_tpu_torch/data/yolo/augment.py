"""YOLO-style image augmentations as pure numpy/cv2 functions.

Copy of ``vqa_project_tpu/data/yolo/augment.py`` (the augmentation block
of the reference's yolo_datasets.py: letterbox :834-868,
random_perspective :871-967, HSV :730-747, mosaic :750-812, mixup
:536-540, cutout :981-1028, flips :590-601) with the same numpy
Generator draws in the same order, so the same seed gives the same
pixels and labels in either package. Stateless functions over (image,
labels) pairs; host work only, nothing here touches the card.

Labels are (n, 5) float32 rows [class, x1, y1, x2, y2] in PIXEL units
unless stated otherwise.
"""

from __future__ import annotations

import math
from typing import Tuple

import cv2
import numpy as np


def letterbox(
    img: np.ndarray,
    new_shape: Tuple[int, int] = (640, 640),
    color: Tuple[int, int, int] = (114, 114, 114),
    auto: bool = True,
    scale_fill: bool = False,
    scale_up: bool = True,
    stride: int = 32,
) -> Tuple[np.ndarray, Tuple[float, float], Tuple[float, float]]:
    """Resize + pad to new_shape preserving aspect ratio.

    Returns (image, (gain_w, gain_h), (pad_w, pad_h)).
    """
    shape = img.shape[:2]  # (h, w)
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scale_up:  # only shrink (better val mAP)
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:  # minimal stride-aligned padding
        dw, dh = dw % stride, dh % stride
    elif scale_fill:  # stretch
        dw, dh = 0.0, 0.0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])

    dw /= 2
    dh /= 2
    if shape[::-1] != new_unpad:
        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right,
                             cv2.BORDER_CONSTANT, value=color)
    return img, ratio, (dw, dh)


def augment_hsv(img: np.ndarray, rng: np.random.Generator,
                hgain: float = 0.015, sgain: float = 0.7,
                vgain: float = 0.4) -> np.ndarray:
    """Random HSV jitter (yolo_datasets.py:730-747)."""
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    x = np.arange(0, 256, dtype=np.int16)
    lut_hue = ((x * r[0]) % 180).astype(np.uint8)
    lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)
    img_hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat),
                         cv2.LUT(val, lut_val))).astype(np.uint8)
    return cv2.cvtColor(img_hsv, cv2.COLOR_HSV2BGR)


def random_perspective(
    img: np.ndarray,
    labels: np.ndarray,
    rng: np.random.Generator,
    degrees: float = 10,
    translate: float = 0.1,
    scale: float = 0.1,
    shear: float = 10,
    perspective: float = 0.0,
    border: Tuple[int, int] = (0, 0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Random affine/perspective warp of image + labels
    (yolo_datasets.py:871-967). Degenerate boxes are filtered."""
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    # centre
    c = np.eye(3)
    c[0, 2] = -img.shape[1] / 2
    c[1, 2] = -img.shape[0] / 2
    # perspective
    p = np.eye(3)
    p[2, 0] = rng.uniform(-perspective, perspective)
    p[2, 1] = rng.uniform(-perspective, perspective)
    # rotation + scale
    r = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    r[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    # shear
    sh = np.eye(3)
    sh[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    sh[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    # translation
    t = np.eye(3)
    t[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    t[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    m = t @ sh @ r @ p @ c
    if (border[0] != 0) or (border[1] != 0) or (m != np.eye(3)).any():
        if perspective:
            img = cv2.warpPerspective(img, m, dsize=(width, height),
                                      borderValue=(114, 114, 114))
        else:
            img = cv2.warpAffine(img, m[:2], dsize=(width, height),
                                 borderValue=(114, 114, 114))

    n = len(labels)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = labels[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ m.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective
              else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.concatenate(
            (x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = _box_candidates(labels[:, 1:5].T * s, new.T)
        labels = labels[keep]
        labels[:, 1:5] = new[keep]
    return img, labels


def _box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1,
                    eps=1e-16):
    """Keep warped boxes that remain plausible (yolo_datasets.py:970-978)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def mosaic4(images, labels_list, img_size: int,
            rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """4-image mosaic (yolo_datasets.py:750-812): paste 4 images around a
    random centre in a 2x canvas; labels shifted accordingly (pixels)."""
    assert len(images) == 4 and len(labels_list) == 4
    s = img_size
    yc, xc = (int(rng.uniform(s // 2, 2 * s - s // 2)) for _ in range(2))
    canvas = np.full((s * 2, s * 2, images[0].shape[2]), 114, np.uint8)
    out_labels = []
    for i, (img, labels) in enumerate(zip(images, labels_list)):
        h, w = img.shape[:2]
        if i == 0:    # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            x2b, y2b = w, h
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b = 0, h - (y2a - y1a)
            x2b, y2b = min(w, x2a - x1a), h
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
            x2b, y2b = w, min(y2a - y1a, h)
        else:         # bottom-right
            x1a, y1a = xc, yc
            x2a, y2a = min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b = 0, 0
            x2b, y2b = min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(labels):
            lb = labels.copy()
            lb[:, [1, 3]] += padw
            lb[:, [2, 4]] += padh
            out_labels.append(lb)
    if out_labels:
        out = np.concatenate(out_labels, 0)
        np.clip(out[:, 1:], 0, 2 * s, out=out[:, 1:])
    else:
        out = np.zeros((0, 5), np.float32)
    return canvas, out


def mixup(img1, labels1, img2, labels2, rng: np.random.Generator):
    """Blend two mosaics with a Beta(8, 8) ratio
    (yolo_datasets.py:536-540)."""
    r = rng.beta(8.0, 8.0)
    img = (img1 * r + img2 * (1 - r)).astype(np.uint8)
    labels = np.concatenate((labels1, labels2), 0)
    return img, labels


def cutout(img: np.ndarray, labels: np.ndarray,
           rng: np.random.Generator) -> np.ndarray:
    """Random occlusion squares (yolo_datasets.py:981-1028); labels with
    >60% IoA against a cut region are dropped."""
    h, w = img.shape[:2]
    scales = ([0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8
              + [0.03125] * 16)
    for s in scales:
        mask_h = rng.integers(1, int(h * s) + 1)
        mask_w = rng.integers(1, int(w * s) + 1)
        xmin = int(max(0, rng.integers(0, w) - mask_w // 2))
        ymin = int(max(0, rng.integers(0, h) - mask_h // 2))
        xmax = int(min(w, xmin + mask_w))
        ymax = int(min(h, ymin + mask_h))
        img[ymin:ymax, xmin:xmax] = [
            int(v) for v in rng.integers(64, 191, 3)]
        if len(labels) and s > 0.03:
            box = np.array([xmin, ymin, xmax, ymax], dtype=np.float32)
            ioa = _bbox_ioa(box, labels[:, 1:5])
            labels = labels[ioa < 0.60]
    return labels


def _bbox_ioa(box1, box2, eps=1e-9):
    """Intersection over box2 area."""
    b1x1, b1y1, b1x2, b1y2 = box1
    b2x1, b2y1, b2x2, b2y2 = box2.T
    iw = (np.minimum(b1x2, b2x2) - np.maximum(b1x1, b2x1)).clip(0)
    ih = (np.minimum(b1y2, b2y2) - np.maximum(b1y1, b2y1)).clip(0)
    return iw * ih / ((b2x2 - b2x1) * (b2y2 - b2y1) + eps)


def flip_lr(img: np.ndarray, labels: np.ndarray):
    """Horizontal flip (yolo_datasets.py:595-601); labels in pixels."""
    img = np.fliplr(img).copy()
    if len(labels):
        w = img.shape[1]
        x1 = labels[:, 1].copy()
        labels[:, 1] = w - labels[:, 3]
        labels[:, 3] = w - x1
    return img, labels


def flip_ud(img: np.ndarray, labels: np.ndarray):
    """Vertical flip (yolo_datasets.py:590-594)."""
    img = np.flipud(img).copy()
    if len(labels):
        h = img.shape[0]
        y1 = labels[:, 2].copy()
        labels[:, 2] = h - labels[:, 4]
        labels[:, 4] = h - y1
    return img, labels
