"""YOLO-lineage raw-image loaders (numpy and cv2; no torch DataLoader).

Copy of ``vqa_project_tpu/data/yolo/loaders.py`` (the loader classes of
the reference's yolo_datasets.py: LoadImages :124-202, LoadWebcam
:205-259, LoadStreams :262-340, LoadImagesAndLabels :343-601 with label
caching and hash invalidation :463-514, rect-batch shape bucketing
:423-446, the RAM image cache :449-461, InfiniteDataLoader /
_RepeatSampler :89-121 and get_yolo_dataset :59-86).

Plain iterables yielding numpy (uint8 images (B, 3, H, W), f32 labels
(N, 6)), augmented from a per-dataset np.random.Generator. The labels
cache is JAX's file, ``_labels.cache.npz`` keyed by a sha1 of the file
paths and mtimes, so either package reads a cache the other wrote.
Host work only: this pipeline feeds the medical region detector and
never touches the card.
"""

from __future__ import annotations

import glob
import hashlib
import math
import os
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import cv2
import numpy as np

from vqa_project_tpu_torch.data.yolo.augment import (
    augment_hsv,
    cutout,
    flip_lr,
    flip_ud,
    letterbox,
    mixup,
    mosaic4,
    random_perspective,
)

IMG_FORMATS = ("bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp")
VID_FORMATS = ("mov", "avi", "mp4", "mpg", "mpeg", "m4v", "wmv", "mkv")

_EXIF_ORIENTATION = 0x0112  # TIFF Orientation tag


def exif_size(img) -> Tuple[int, int]:
    """EXIF-orientation-corrected (w, h) of a PIL image
    (yolo_datasets.py:43-55): orientations 6 (270deg) and 8 (90deg) swap
    the stored axes, so label-cache shapes must swap too or every
    rect-bucketing ratio on such photos is wrong."""
    w, h = img.size
    try:
        if img.getexif().get(_EXIF_ORIENTATION) in (6, 8):
            w, h = h, w
    except Exception:
        pass
    return w, h


def img2label_paths(img_paths: Sequence[str]) -> List[str]:
    """.../images/x.jpg -> .../labels/x.txt (yolo_datasets.py:34-37)."""
    sa = os.sep + "images" + os.sep
    sb = os.sep + "labels" + os.sep
    return [sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"
            for p in img_paths]


class LoadImages:
    """Iterate image files / video frames from a path or glob
    (yolo_datasets.py:124-202). Yields (path, letterboxed CHW RGB image,
    original BGR image, video_capture_or_None)."""

    def __init__(self, path: str, img_size: int = 640, stride: int = 32):
        p = str(Path(path).absolute())
        if "*" in p:
            files = sorted(glob.glob(p, recursive=True))
        elif os.path.isdir(p):
            files = sorted(glob.glob(os.path.join(p, "*.*")))
        elif os.path.isfile(p):
            files = [p]
        else:
            raise FileNotFoundError(f"{p} does not exist")

        images = [f for f in files
                  if f.split(".")[-1].lower() in IMG_FORMATS]
        videos = [f for f in files
                  if f.split(".")[-1].lower() in VID_FORMATS]
        self.img_size = img_size
        self.stride = stride
        self.files = images + videos
        self.nf = len(self.files)
        self.video_flag = [False] * len(images) + [True] * len(videos)
        self.cap = None
        if not self.files:
            raise FileNotFoundError(f"No images or videos found in {p}")

    def __len__(self):
        return self.nf

    def __iter__(self):
        self.count = 0
        return self

    def __next__(self):
        if self.count == self.nf:
            raise StopIteration
        path = self.files[self.count]
        if self.video_flag[self.count]:
            if self.cap is None:
                self.cap = cv2.VideoCapture(path)
            ok, img0 = self.cap.read()
            if not ok:
                self.cap.release()
                self.cap = None
                self.count += 1
                return self.__next__() if self.count < self.nf else next(
                    iter(()))
        else:
            self.count += 1
            img0 = cv2.imread(path)
            if img0 is None:
                raise AssertionError(f"Image Not Found {path}")
        img = letterbox(img0, self.img_size, stride=self.stride)[0]
        img = img[:, :, ::-1].transpose(2, 0, 1)  # BGR->RGB, HWC->CHW
        return path, np.ascontiguousarray(img), img0, self.cap


class LoadWebcam:
    """Single-camera stream (yolo_datasets.py:205-259)."""

    def __init__(self, pipe: str = "0", img_size: int = 640,
                 stride: int = 32):
        self.img_size = img_size
        self.stride = stride
        self.pipe = int(pipe) if pipe.isnumeric() else pipe
        self.cap = cv2.VideoCapture(self.pipe)
        self.cap.set(cv2.CAP_PROP_BUFFERSIZE, 3)

    def __iter__(self):
        self.count = -1
        return self

    def __next__(self):
        self.count += 1
        ok, img0 = self.cap.read()
        if not ok:
            self.cap.release()
            raise StopIteration
        img0 = cv2.flip(img0, 1)  # mirror
        img = letterbox(img0, self.img_size, stride=self.stride)[0]
        img = img[:, :, ::-1].transpose(2, 0, 1)
        return str(self.pipe), np.ascontiguousarray(img), img0, None


class LoadStreams:
    """Multiple RTSP/HTTP streams with daemon reader threads
    (yolo_datasets.py:262-340); ``close`` stops the readers and releases
    the captures (the JAX class has no close: its readers run until the
    process ends)."""

    def __init__(self, sources: Sequence[str], img_size: int = 640,
                 stride: int = 32):
        self.img_size = img_size
        self.stride = stride
        self.sources = list(sources)
        self.imgs = [None] * len(self.sources)
        self.caps = []
        self.threads = []
        self._stop = threading.Event()
        for i, s in enumerate(self.sources):
            cap = cv2.VideoCapture(int(s) if s.isnumeric() else s)
            if not cap.isOpened():
                self.close()
                raise ConnectionError(f"Failed to open {s}")
            self.caps.append(cap)
            _, self.imgs[i] = cap.read()
            th = threading.Thread(target=self._update, args=(i, cap),
                                  daemon=True)
            th.start()
            self.threads.append(th)

    def _update(self, i, cap):
        while cap.isOpened() and not self._stop.is_set():
            cap.grab()
            ok, im = cap.retrieve()
            if ok:
                self.imgs[i] = im
            time.sleep(0.01)

    def close(self, timeout: float = 5.0) -> None:
        """Stop the reader threads, then release the captures."""
        self._stop.set()
        for th in self.threads:
            th.join(timeout)
        for cap in self.caps:
            cap.release()

    def __iter__(self):
        return self

    def __next__(self):
        img0 = [im.copy() for im in self.imgs]
        imgs = []
        for im in img0:
            img = letterbox(im, self.img_size, auto=True,
                            stride=self.stride)[0]
            imgs.append(img[:, :, ::-1].transpose(2, 0, 1))
        return self.sources, np.ascontiguousarray(np.stack(imgs)), img0, None


class ImageLabelDataset:
    """Training dataset over images + YOLO-format label txts.

    Features reproduced from LoadImagesAndLabels: cached + validated
    labels, optional RAM image cache, rect-batch shape bucketing, mosaic,
    mixup, HSV, random_perspective, cutout and flips. __getitem__ returns
    (chw_uint8_image, (n, 5) labels [cls, x1, y1, x2, y2] in pixels).
    """

    def __init__(self, path: str, img_size: int = 640, augment: bool = False,
                 hyp: Optional[dict] = None, rect: bool = False,
                 stride: int = 32, batch_size: int = 16,
                 cache_images: bool = False, seed: int = 0):
        self.img_size = img_size
        self.augment = augment
        self.rect = rect and not augment
        self.stride = stride
        self.hyp = hyp or {}
        self.rng = np.random.default_rng(seed)

        if os.path.isdir(path):
            img_files = sorted(
                f for f in glob.glob(os.path.join(path, "**", "*.*"),
                                     recursive=True)
                if f.split(".")[-1].lower() in IMG_FORMATS)
        else:  # txt listing file paths
            with open(path) as f:
                img_files = [ln.strip() for ln in f if ln.strip()]
        if not img_files:
            raise FileNotFoundError(f"No images found in {path}")
        self.img_files = img_files
        self.label_files = img2label_paths(img_files)
        self.labels, self.shapes = self._load_or_build_cache()
        self.n = len(self.img_files)

        if self.rect:  # aspect-ratio bucketing (yolo_datasets.py:423-446)
            ar = self.shapes[:, 1] / self.shapes[:, 0]
            order = ar.argsort()
            self.img_files = [self.img_files[i] for i in order]
            self.label_files = [self.label_files[i] for i in order]
            self.labels = [self.labels[i] for i in order]
            self.shapes = self.shapes[order]
            nb = int(math.ceil(self.n / batch_size))
            shapes = []
            for b in range(nb):
                ari = ar[order][b * batch_size:(b + 1) * batch_size]
                mini, maxi = ari.min(), ari.max()
                if maxi < 1:
                    shapes.append([maxi, 1])
                elif mini > 1:
                    shapes.append([1, 1 / mini])
                else:
                    shapes.append([1, 1])
            self.batch_shapes = (np.ceil(
                np.array(shapes) * img_size / stride + 0.5)
                * stride).astype(int)
            self.batch_index = np.floor(
                np.arange(self.n) / batch_size).astype(int)

        self._ram: List[Optional[np.ndarray]] = [None] * self.n
        if cache_images:
            for i in range(self.n):
                self._ram[i] = self._load_image_raw(i)

    # ---------- label cache ----------

    def _cache_path(self) -> str:
        d = os.path.dirname(self.label_files[0]) or "."
        return os.path.join(d, "_labels.cache.npz")

    def _hash(self) -> str:
        h = hashlib.sha1()
        for p in self.img_files + self.label_files:
            h.update(p.encode())
            if os.path.exists(p):
                h.update(str(os.path.getmtime(p)).encode())
        return h.hexdigest()

    def _load_or_build_cache(self):
        cpath = self._cache_path()
        want = self._hash()
        if os.path.exists(cpath):
            with np.load(cpath, allow_pickle=True) as z:
                if str(z["hash"]) == want:
                    return list(z["labels"]), z["shapes"]
        labels, shapes = [], []
        for imgf, lblf in zip(self.img_files, self.label_files):
            # PIL reads (w, h) from the header without decoding pixels;
            # verify() is the corrupt-image check (yolo_datasets.py:472-475)
            # and exif_size the EXIF-rotation correction (:43-55).
            from PIL import Image

            try:
                with Image.open(imgf) as img:
                    wh = exif_size(img)
                    img.verify()
            except Exception as e:
                raise AssertionError(f"corrupt image {imgf}: {e}") from e
            if not (wh[0] > 9 and wh[1] > 9):
                raise AssertionError(f"image <10 pixels {imgf}")
            shapes.append(wh)
            lb = np.zeros((0, 5), np.float32)
            if os.path.exists(lblf):
                with open(lblf) as f:
                    rows = [ln.split() for ln in f if ln.strip()]
                if rows:
                    lb = np.array(rows, dtype=np.float32)
                    # validation (yolo_datasets.py:478-496)
                    if lb.shape[1] != 5:
                        raise AssertionError(f"bad label shape {lblf}")
                    if not (lb >= 0).all():
                        raise AssertionError(f"negative labels {lblf}")
                    if not (lb[:, 1:] <= 1).all():
                        raise AssertionError(
                            f"non-normalized labels {lblf}")
                    lb = np.unique(lb, axis=0)  # drop duplicates
            labels.append(lb)
        shapes = np.array(shapes, dtype=np.float64)
        np.savez(cpath, hash=want,
                 labels=np.array(labels, dtype=object), shapes=shapes)
        return labels, shapes

    # ---------- image access ----------

    def _load_image_raw(self, i):
        img = cv2.imread(self.img_files[i])
        if img is None:
            raise AssertionError(f"Image Not Found {self.img_files[i]}")
        return img

    def load_image(self, i) -> Tuple[np.ndarray, tuple, tuple]:
        """Image resized so the long side == img_size
        (yolo_datasets.py:715-727)."""
        img = self._ram[i] if self._ram[i] is not None \
            else self._load_image_raw(i)
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            img = cv2.resize(img, (int(w0 * r), int(h0 * r)),
                             interpolation=cv2.INTER_LINEAR)
        return img, (h0, w0), img.shape[:2]

    def _labels_pixels(self, i, ratio_w, ratio_h, padw=0.0, padh=0.0):
        """Normalized cxcywh -> pixel xyxy at the working resolution."""
        lb = self.labels[i].copy()
        if len(lb):
            cx, cy, bw, bh = lb[:, 1], lb[:, 2], lb[:, 3], lb[:, 4]
            lb = np.stack([
                lb[:, 0],
                (cx - bw / 2) * ratio_w + padw,
                (cy - bh / 2) * ratio_h + padh,
                (cx + bw / 2) * ratio_w + padw,
                (cy + bh / 2) * ratio_h + padh,
            ], axis=1)
        return lb.astype(np.float32)

    def __len__(self):
        return self.n

    def __getitem__(self, i) -> Tuple[np.ndarray, np.ndarray]:
        hyp = self.hyp
        if self.augment and self.rng.random() < hyp.get("mosaic", 1.0):
            img, labels = self._mosaic_sample(i)
            if self.rng.random() < hyp.get("mixup", 0.0):
                img2, labels2 = self._mosaic_sample(
                    int(self.rng.integers(0, self.n)))
                img, labels = mixup(img, labels, img2, labels2, self.rng)
        else:
            img, (h0, w0), (h, w) = self.load_image(i)
            shape = (self.batch_shapes[self.batch_index[i]]
                     if self.rect else self.img_size)
            img, ratio, pad = letterbox(img, shape, auto=False,
                                        scale_up=self.augment)
            labels = self._labels_pixels(
                i, ratio[0] * w, ratio[1] * h, pad[0], pad[1])
            if self.augment:
                img, labels = random_perspective(
                    img, labels, self.rng,
                    degrees=hyp.get("degrees", 0.0),
                    translate=hyp.get("translate", 0.1),
                    scale=hyp.get("scale", 0.5),
                    shear=hyp.get("shear", 0.0))

        if self.augment:
            img = augment_hsv(img, self.rng,
                              hyp.get("hsv_h", 0.015),
                              hyp.get("hsv_s", 0.7),
                              hyp.get("hsv_v", 0.4))
            if self.rng.random() < hyp.get("cutout", 0.0):
                labels = cutout(img, labels, self.rng)
            if self.rng.random() < hyp.get("flipud", 0.0):
                img, labels = flip_ud(img, labels)
            if self.rng.random() < hyp.get("fliplr", 0.5):
                img, labels = flip_lr(img, labels)

        chw = np.ascontiguousarray(img[:, :, ::-1].transpose(2, 0, 1))
        return chw, labels

    def _mosaic_sample(self, i):
        idxs = [i] + [int(self.rng.integers(0, self.n)) for _ in range(3)]
        imgs, lbs = [], []
        for j in idxs:
            img, _, (h, w) = self.load_image(j)
            imgs.append(img)
            lbs.append(self._labels_pixels(j, w, h))
        img, labels = mosaic4(imgs, lbs, self.img_size, self.rng)
        img, labels = random_perspective(
            img, labels, self.rng,
            degrees=self.hyp.get("degrees", 0.0),
            translate=self.hyp.get("translate", 0.1),
            scale=self.hyp.get("scale", 0.5),
            shear=self.hyp.get("shear", 0.0),
            border=(-self.img_size // 2, -self.img_size // 2))
        return img, labels


class InfiniteBatcher:
    """Endless batches with a repeating shuffled sampler
    (InfiniteDataLoader/_RepeatSampler, yolo_datasets.py:89-121).
    Yields (images (B, 3, H, W) uint8, labels (N, 6) [img_idx, cls,
    x1, y1, x2, y2])."""

    def __init__(self, dataset: ImageLabelDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator:
        while True:
            order = np.arange(len(self.ds))
            if self.shuffle:
                self.rng.shuffle(order)
            for s in range(0, len(order) - self.batch_size + 1,
                           self.batch_size):
                idxs = order[s:s + self.batch_size]
                imgs, labels = [], []
                for bi, i in enumerate(idxs):
                    img, lb = self.ds[int(i)]
                    imgs.append(img)
                    if len(lb):
                        labels.append(np.concatenate(
                            [np.full((len(lb), 1), bi, np.float32), lb], 1))
                batch_labels = (np.concatenate(labels, 0) if labels
                                else np.zeros((0, 6), np.float32))
                yield np.stack(imgs), batch_labels


def get_yolo_dataset(path: str, img_size: int = 640, batch_size: int = 16,
                     augment: bool = True, rect: bool = False,
                     hyp: Optional[dict] = None, seed: int = 0):
    """Convenience constructor (yolo_datasets.py:59-86, without the
    hardcoded imageclef path)."""
    ds = ImageLabelDataset(path, img_size=img_size, augment=augment,
                           hyp=hyp, rect=rect, batch_size=batch_size,
                           seed=seed)
    return ds, InfiniteBatcher(ds, batch_size, shuffle=not rect, seed=seed)
