"""The port's YOLO raw-image pipeline against the JAX package's, bit for
bit, on images and labels the test writes: each augmentation with the
same generator (and the generator left in the same state), the loaders
over images and a short video, the labelled dataset with and without
augmentation and with rect batches, the endless batcher, the labels
cache read across packages in both directions, and the corrupt-image,
EXIF and label checks."""

import os
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image

from vqa_project_tpu.data import yolo as j_yolo
from vqa_project_tpu.data.yolo import augment as j_aug
from vqa_project_tpu.data.yolo import loaders as j_loaders
from vqa_project_tpu_torch.data import yolo
from vqa_project_tpu_torch.data.yolo import augment, loaders

HYP = {"mosaic": 1.0, "mixup": 0.5, "fliplr": 0.5, "flipud": 0.2,
       "cutout": 0.5, "scale": 0.3, "degrees": 5.0, "shear": 2.0,
       "translate": 0.1}


def _image(h, w, seed):
    return np.random.default_rng(seed).integers(
        0, 255, size=(h, w, 3)).astype(np.uint8)


def _labels(n, size, seed):
    """(n, 5) pixel labels [cls, x1, y1, x2, y2] inside a size x size
    image."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size * 0.6, (n, 2))
    wh = rng.uniform(size * 0.1, size * 0.35, (n, 2))
    cls = rng.integers(0, 3, (n, 1))
    return np.concatenate([cls, xy, xy + wh], 1).astype(np.float32)


def _same(a, b):
    """Equal values, dtypes and shapes, nested through tuples/lists."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _both(fn_name, module, j_module, *args, seed=None, **kw):
    """fn(*args) in both packages, each from its own copy of the inputs
    and, with seed, its own generator; returns (mine, theirs) and checks
    the generators end in the same state."""
    out = []
    states = []
    for mod in (module, j_module):
        a = [x.copy() if isinstance(x, np.ndarray) else x for x in args]
        if seed is not None:
            rng = np.random.default_rng(seed)
            a.insert(fn_name[1], rng)
        out.append(getattr(mod, fn_name[0])(*a, **kw))
        if seed is not None:
            states.append(rng.random())
    if seed is not None:
        assert states[0] == states[1]
    return out


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """images/ + labels/ tree: 7 JPEGs of varied aspect, normalized
    cxcywh labels (one image unlabelled, one with a duplicate row)."""
    root = tmp_path_factory.mktemp("yolo")
    imgd, lbld = root / "images", root / "labels"
    imgd.mkdir()
    lbld.mkdir()
    rng = np.random.default_rng(3)
    for i in range(7):
        h, w = int(rng.integers(120, 400)), int(rng.integers(120, 400))
        cv2.imwrite(str(imgd / f"im{i}.jpg"), _image(h, w, i))
        if i == 3:
            continue
        rows = []
        for _ in range(int(rng.integers(1, 4))):
            cw, ch = rng.uniform(0.1, 0.4, 2)
            cx = rng.uniform(cw / 2, 1 - cw / 2)
            cy = rng.uniform(ch / 2, 1 - ch / 2)
            rows.append(f"{int(rng.integers(0, 3))} {cx} {cy} {cw} {ch}")
        if i == 5:
            rows.append(rows[0])
        (lbld / f"im{i}.txt").write_text("\n".join(rows) + "\n")
    return str(imgd)


def _copy_tree(image_dir, dst):
    shutil.copytree(os.path.dirname(image_dir), dst)
    cache = os.path.join(dst, "labels", "_labels.cache.npz")
    if os.path.exists(cache):
        os.remove(cache)
    return os.path.join(dst, "images")


def test_exports_are_jax_exports():
    assert yolo.__all__ == j_yolo.__all__
    assert loaders.IMG_FORMATS == j_loaders.IMG_FORMATS
    assert loaders.VID_FORMATS == j_loaders.VID_FORMATS


@pytest.mark.parametrize("paths", [
    ["d/images/x.jpg"], ["a/images/b/images/c.png", "images/y.jpeg"],
    ["no_images_dir/z.jpg"]])
def test_img2label_paths_matches_jax(paths):
    paths = [p.replace("/", os.sep) for p in paths]
    assert (loaders.img2label_paths(paths)
            == j_loaders.img2label_paths(paths))


# ---------------- augmentations ----------------

@pytest.mark.parametrize("kw", [
    dict(new_shape=640, auto=False), dict(new_shape=640, auto=True),
    dict(new_shape=(320, 256), auto=False, scale_fill=True),
    dict(new_shape=160, auto=False, scale_up=False),
    dict(new_shape=800, auto=False, scale_up=False, color=(0, 10, 20)),
    dict(new_shape=(300, 200), auto=True, stride=64)])
@pytest.mark.parametrize("shape", [(200, 300), (301, 97)])
def test_letterbox_matches_jax(shape, kw):
    img = _image(*shape, seed=1)
    mine, theirs = _both(("letterbox", None), augment, j_aug, img, **kw)
    _same(mine, theirs)


@pytest.mark.parametrize("gains", [(0.015, 0.7, 0.4), (0.5, 0.0, 0.9)])
def test_augment_hsv_matches_jax(gains):
    mine, theirs = _both(("augment_hsv", 1), augment, j_aug,
                         _image(64, 80, 2), *gains, seed=4)
    _same(mine, theirs)
    assert mine.dtype == np.uint8


@pytest.mark.parametrize("kw", [
    dict(), dict(degrees=0, translate=0, scale=0, shear=0),
    dict(degrees=30, translate=0.2, scale=0.5, shear=10),
    dict(perspective=0.001), dict(border=(-50, -50), scale=0.3)])
def test_random_perspective_matches_jax(kw):
    img, labels = _image(200, 200, 3), _labels(5, 200, 3)
    mine, theirs = _both(("random_perspective", 2), augment, j_aug, img,
                         labels, seed=5, **kw)
    _same(mine, theirs)


def test_random_perspective_without_labels_matches_jax():
    mine, theirs = _both(("random_perspective", 2), augment, j_aug,
                         _image(90, 120, 4), np.zeros((0, 5), np.float32),
                         seed=6)
    _same(mine, theirs)


def test_box_candidates_and_ioa_match_jax():
    a, b = _labels(9, 100, 7)[:, 1:].T, _labels(9, 100, 8)[:, 1:].T
    _same(augment._box_candidates(a, b), j_aug._box_candidates(a, b))
    box = np.array([10, 20, 60, 70], np.float32)
    _same(augment._bbox_ioa(box, b.T), j_aug._bbox_ioa(box, b.T))


@pytest.mark.parametrize("empty", [False, True])
def test_mosaic4_matches_jax(empty):
    sizes = [(100, 120), (80, 64), (130, 90), (70, 110)]
    imgs = [_image(h, w, i) for i, (h, w) in enumerate(sizes)]
    lbs = [np.zeros((0, 5), np.float32) if empty else _labels(2, 60, i)
           for i in range(4)]
    outs = []
    for mod in (augment, j_aug):
        rng = np.random.default_rng(9)
        outs.append(mod.mosaic4([x.copy() for x in imgs],
                                [x.copy() for x in lbs], 100, rng)
                    + (rng.random(),))
    _same(*outs)


def test_mixup_matches_jax():
    mine, theirs = _both(("mixup", 4), augment, j_aug, _image(50, 60, 1),
                         _labels(2, 50, 1), _image(50, 60, 2),
                         _labels(3, 50, 2), seed=10)
    _same(mine, theirs)


@pytest.mark.parametrize("n_labels", [0, 6])
def test_cutout_matches_jax(n_labels):
    img, labels = _image(160, 200, 5), _labels(n_labels, 160, 5)
    outs = []
    for mod in (augment, j_aug):
        rng = np.random.default_rng(11)
        im = img.copy()                      # cut out in place
        outs.append((mod.cutout(im, labels.copy(), rng), im, rng.random()))
    _same(*outs)


@pytest.mark.parametrize("fn", ["flip_lr", "flip_ud"])
@pytest.mark.parametrize("n_labels", [0, 3])
def test_flips_match_jax(fn, n_labels):
    mine, theirs = _both((fn, None), augment, j_aug, _image(100, 200, 6),
                         _labels(n_labels, 100, 6))
    _same(mine, theirs)


# ---------------- loaders ----------------

def _video(path, n=5, size=(96, 72)):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5, size)
    for i in range(n):
        writer.write(np.full((size[1], size[0], 3), 30 * i, np.uint8))
    writer.release()


def _frames(loader):
    return [(p, chw, img0, cap is None) for p, chw, img0, cap in loader]


def test_load_images_matches_jax(image_dir, tmp_path):
    mixed = tmp_path / "mixed"
    shutil.copytree(image_dir, mixed)
    _video(str(mixed / "clip.avi"))
    for path in (image_dir, str(mixed), os.path.join(image_dir, "im*.jpg"),
                 os.path.join(image_dir, "im2.jpg")):
        mine = loaders.LoadImages(path, img_size=160)
        theirs = j_loaders.LoadImages(path, img_size=160)
        assert len(mine) == len(theirs)
        _same(_frames(mine), _frames(theirs))
    assert sum(not f[3] for f in _frames(
        loaders.LoadImages(str(mixed), img_size=160))) == 5   # video frames
    for mod in (loaders, j_loaders):
        with pytest.raises(FileNotFoundError):
            mod.LoadImages(str(tmp_path / "nothing_here"))


def test_load_webcam_on_a_video_matches_jax(tmp_path):
    path = str(tmp_path / "cam.avi")
    _video(path, n=4)
    mine, theirs = (mod.LoadWebcam(path, img_size=64)
                    for mod in (loaders, j_loaders))
    assert mine.pipe == theirs.pipe == path
    got, want = _frames(mine), _frames(theirs)
    assert len(got) == 4
    _same(got, want)


def test_load_streams_on_a_video_matches_jax(tmp_path):
    """Reader threads keep the latest frame; the batch is the letterbox
    of the frames it returns, as JAX builds it."""
    path = str(tmp_path / "stream.avi")
    _video(path, n=3)
    streams = loaders.LoadStreams([path, path], img_size=64)
    try:
        assert all(t.daemon for t in streams.threads)
        sources, imgs, img0, cap = next(iter(streams))
    finally:
        streams.close()
    assert not any(t.is_alive() for t in streams.threads)
    assert sources == [path, path] and cap is None
    want = np.ascontiguousarray(np.stack([
        j_aug.letterbox(im, 64, auto=True, stride=32)[0][:, :, ::-1]
        .transpose(2, 0, 1) for im in img0]))
    _same(imgs, want)
    with pytest.raises(ConnectionError):
        loaders.LoadStreams([str(tmp_path / "missing.avi")])


@pytest.mark.parametrize("kw", [
    dict(img_size=160), dict(img_size=160, rect=True, batch_size=3),
    dict(img_size=128, augment=True, hyp=HYP, seed=5),
    dict(img_size=128, augment=True, seed=2),
    dict(img_size=96, augment=True, hyp=dict(HYP, mosaic=0.0), seed=8),
    dict(img_size=160, cache_images=True)])
def test_image_label_dataset_matches_jax(image_dir, kw):
    mine = loaders.ImageLabelDataset(image_dir, **kw)
    theirs = j_loaders.ImageLabelDataset(image_dir, **kw)
    assert len(mine) == len(theirs) == 7
    _same(mine.img_files, theirs.img_files)
    _same(mine.shapes, theirs.shapes)
    if kw.get("rect"):
        _same(mine.batch_shapes, theirs.batch_shapes)
        _same(mine.batch_index, theirs.batch_index)
    for i in range(len(mine)):
        _same(mine[i], theirs[i])


def test_list_file_dataset_matches_jax(image_dir, tmp_path):
    listing = tmp_path / "train.txt"
    files = sorted(os.listdir(image_dir))[:4]
    listing.write_text("\n".join(os.path.join(image_dir, f)
                                 for f in files) + "\n\n")
    mine, theirs = (mod.ImageLabelDataset(str(listing), img_size=64)
                    for mod in (loaders, j_loaders))
    assert len(mine) == 4
    for i in range(4):
        _same(mine[i], theirs[i])


@pytest.mark.parametrize("kw", [dict(augment=True, hyp=HYP),
                                dict(augment=False, rect=True)])
def test_infinite_batcher_and_get_yolo_dataset_match_jax(image_dir, kw):
    (ds, it), (jds, jit) = (mod.get_yolo_dataset(
        image_dir, img_size=96, batch_size=3, seed=4, **kw)
        for mod in (loaders, j_loaders))
    assert type(it).__name__ == "InfiniteBatcher"
    mine, theirs = iter(it), iter(jit)
    for _ in range(4):                 # past one epoch of 7 // 3 batches
        imgs, labels = next(mine)
        _same((imgs, labels), next(theirs))
        assert imgs.dtype == np.uint8 and imgs.shape[:2] == (3, 3)
        assert labels.dtype == np.float32 and labels.shape[1] == 6


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_labels_cache_is_read_across_packages(image_dir, tmp_path, writer):
    imgd = _copy_tree(image_dir, str(tmp_path / "tree"))
    cache = os.path.join(os.path.dirname(imgd), "labels",
                         "_labels.cache.npz")
    first, second = ((j_loaders, loaders) if writer == "jax"
                     else (loaders, j_loaders))
    built = first.ImageLabelDataset(imgd, img_size=64)
    mtime = os.stat(cache).st_mtime_ns
    with np.load(cache, allow_pickle=True) as z:
        assert str(z["hash"]) == built._hash()
    # a corrupt image would fail a rebuild: reading it proves the cache
    # was used, not rebuilt
    read = second.ImageLabelDataset(imgd, img_size=64)
    assert os.stat(cache).st_mtime_ns == mtime
    assert read._hash() == built._hash()
    _same(read.shapes, built.shapes)
    _same([np.asarray(x) for x in read.labels],
          [np.asarray(x) for x in built.labels])
    for i in range(len(read)):
        _same(read[i], built[i])


def test_labels_cache_rebuilds_when_a_file_changes(image_dir, tmp_path):
    imgd = _copy_tree(image_dir, str(tmp_path / "tree"))
    lbl = os.path.join(os.path.dirname(imgd), "labels", "im0.txt")
    old_hash = loaders.ImageLabelDataset(imgd, img_size=64)._hash()
    with open(lbl, "w") as f:
        f.write("2 0.5 0.5 0.25 0.25\n")
    os.utime(lbl, ns=(1, 1))
    mine = loaders.ImageLabelDataset(imgd, img_size=64)
    assert mine._hash() != old_hash
    _same(mine.labels[0], np.array([[2, 0.5, 0.5, 0.25, 0.25]], np.float32))
    theirs = j_loaders.ImageLabelDataset(imgd, img_size=64)
    _same(theirs.labels[0], mine.labels[0])


def test_exif_rotated_shape_and_corrupt_image(tmp_path):
    imgd, lbld = tmp_path / "images", tmp_path / "labels"
    imgd.mkdir()
    lbld.mkdir()
    im = Image.new("RGB", (200, 100))
    ex = Image.Exif()
    ex[0x0112] = 6                   # rotated 270: stored w x h swap
    im.save(str(imgd / "rot.jpg"), exif=ex)
    Image.new("RGB", (50, 40)).save(str(imgd / "plain.jpg"))
    (lbld / "rot.txt").write_text("0 0.5 0.5 0.2 0.2\n")
    for mod in (loaders, j_loaders):
        with Image.open(str(imgd / "rot.jpg")) as img:
            assert mod.exif_size(img) == (100, 200)
        with Image.open(str(imgd / "plain.jpg")) as img:
            assert mod.exif_size(img) == (50, 40)
    ds = loaders.ImageLabelDataset(str(imgd), img_size=64)
    assert [tuple(s) for s in ds.shapes] == [(50.0, 40.0), (100.0, 200.0)]
    (imgd / "bad.jpg").write_bytes(b"\xff\xd8 not a real jpeg")
    for mod in (loaders, j_loaders):
        with pytest.raises(AssertionError, match="corrupt image"):
            mod.ImageLabelDataset(str(imgd), img_size=64)


@pytest.mark.parametrize("label, match", [
    ("0 0.5 0.5 0.2\n", "bad label shape"),
    ("0 -0.5 0.5 0.2 0.2\n", "negative labels"),
    ("0 0.5 1.5 0.2 0.2\n", "non-normalized labels")])
def test_bad_labels_raise_as_jax(tmp_path, label, match):
    imgd, lbld = tmp_path / "images", tmp_path / "labels"
    imgd.mkdir()
    lbld.mkdir()
    cv2.imwrite(str(imgd / "a.jpg"), _image(40, 40, 1))
    (lbld / "a.txt").write_text(label)
    for mod in (loaders, j_loaders):
        with pytest.raises(AssertionError, match=match):
            mod.ImageLabelDataset(str(imgd), img_size=32)


def test_tiny_image_and_empty_folder_raise_as_jax(tmp_path):
    imgd = tmp_path / "images"
    imgd.mkdir()
    for mod in (loaders, j_loaders):
        with pytest.raises(FileNotFoundError):
            mod.ImageLabelDataset(str(imgd))
    cv2.imwrite(str(imgd / "t.jpg"), _image(8, 8, 2))
    for mod in (loaders, j_loaders):
        with pytest.raises(AssertionError, match="image <10 pixels"):
            mod.ImageLabelDataset(str(imgd), img_size=32)
