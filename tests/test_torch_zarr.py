"""The port's zarr reader and writer and its blosc decoder against the
JAX package's, on the CPU: arrays written by either package read bit
for bit by the other (raw, zlib, gzip, a missing chunk, several chunks,
a blosc chunk); the decoder on the committed frames of
tests/fixtures/blosc/ and on frames of the system libblosc where one is
installed; truncated frames; where the decoder is built and what a
failed build says."""

import ctypes
import fnmatch
import gzip
import json
import os
import tomllib
import zlib

import numpy as np
import pytest

from vqa_project_tpu.data import zarr_store as j_zarr
from vqa_project_tpu_torch.data import native, zarr_store
from vqa_project_tpu_torch.ops import _build

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "blosc")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = {c["name"]: c for c in json.load(_f)}

# (shape, dtype, clevel, shuffle): tests/test_native.py's cases
CASES = [
    ((36, 2048), np.float32, 5, 1),
    ((36, 4), np.float32, 5, 1),
    ((1000,), np.float32, 9, 1),
    ((17,), np.uint8, 5, 1),
    ((513, 7), np.float64, 1, 1),
    ((4096,), np.int16, 5, 1),
    ((2048,), np.float32, 5, 0),
    ((100000,), np.float32, 5, 1),
]


def _fixture(name):
    with open(os.path.join(FIXTURES, f"{name}.blosc"), "rb") as f:
        frame = f.read()
    with open(os.path.join(FIXTURES, f"{name}.raw"), "rb") as f:
        raw = f.read()
    return frame, raw


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _arrays(rng):
    return {"feat": rng.normal(size=(36, 24)).astype(np.float32),
            "box": rng.uniform(0, 500, size=(36, 4)).astype(np.float32),
            "ints": rng.integers(-9, 9, size=(5, 3, 2)).astype(np.int64),
            "vec": rng.normal(size=(7,)).astype(np.float64)}


@pytest.mark.parametrize("compress", [True, False], ids=["zlib", "raw"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_written_by_one_package_read_by_the_other(tmp_path, rng, compress,
                                                  writer):
    arrays = _arrays(rng)
    w = (j_zarr if writer == "jax" else zarr_store).ZarrWriter(
        str(tmp_path / "g.zarr"), compress=compress)
    for name, a in arrays.items():
        w.create_dataset(name, a)
    mine = zarr_store.open_group(str(tmp_path / "g.zarr"))
    theirs = j_zarr.open_group(str(tmp_path / "g.zarr"))
    assert mine.keys() == theirs.keys() == sorted(arrays)
    for name, a in arrays.items():
        _same(mine[name], a)
        _same(mine[name], theirs[name])
        assert name in mine


def test_writers_emit_the_same_files(tmp_path, rng):
    """One zlib level-1 chunk per array, the same .zarray, byte for
    byte."""
    arrays = _arrays(rng)
    for pkg, sub in ((j_zarr, "j"), (zarr_store, "p")):
        w = pkg.ZarrWriter(str(tmp_path / sub))
        for name, a in arrays.items():
            w.create_dataset(name, a)
    for root, _, files in os.walk(tmp_path / "j"):
        for fname in files:
            rel = os.path.relpath(os.path.join(root, fname), tmp_path / "j")
            with open(tmp_path / "j" / rel, "rb") as f:
                want = f.read()
            with open(tmp_path / "p" / rel, "rb") as f:
                assert f.read() == want, rel


def _write_array(path, data, chunks, compressor, encode, skip=(),
                 fill_value=0):
    """A zarr v2 array written by hand: chunks of ``chunks`` (edge chunks
    padded to full size, as zarr does), chunk ids in ``skip`` left out."""
    os.makedirs(path, exist_ok=True)
    meta = {"zarr_format": 2, "shape": list(data.shape),
            "chunks": list(chunks), "dtype": data.dtype.str,
            "compressor": compressor, "fill_value": fill_value,
            "filters": None, "order": "C"}
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    grid = [range(-(-s // c)) for s, c in zip(data.shape, chunks)]
    for coords in np.ndindex(*[len(g) for g in grid]):
        name = ".".join(map(str, coords))
        if name in skip:
            continue
        block = np.zeros(chunks, data.dtype)
        sel = tuple(slice(c * ch, min((c + 1) * ch, s))
                    for c, ch, s in zip(coords, chunks, data.shape))
        block[tuple(slice(0, sl.stop - sl.start) for sl in sel)] = data[sel]
        with open(os.path.join(path, name), "wb") as f:
            f.write(encode(block.tobytes()))


@pytest.mark.parametrize("codec", ["raw", "zlib", "gzip"])
def test_several_chunks_and_a_missing_one(tmp_path, rng, codec):
    data = rng.normal(size=(7, 10)).astype(np.float32)
    compressor, encode = {
        "raw": (None, lambda b: b),
        "zlib": ({"id": "zlib", "level": 1}, lambda b: zlib.compress(b, 1)),
        "gzip": ({"id": "gzip", "level": 5}, gzip.compress)}[codec]
    os.makedirs(tmp_path / "g")
    _write_array(str(tmp_path / "g" / "a"), data, (3, 4), compressor,
                 encode, skip={"1.2"}, fill_value=-7.5)
    want = data.copy()
    want[3:6, 8:10] = -7.5            # chunk (1, 2) is missing
    got = zarr_store.open_group(str(tmp_path / "g"))["a"]
    _same(got, want)
    _same(got, j_zarr.open_group(str(tmp_path / "g"))["a"])


def test_blosc_chunks_through_the_reader(tmp_path):
    """An array of blosc chunks (the committed frames), read by both
    packages' readers."""
    frame, raw = _fixture("lz4_shuffle")
    os.makedirs(tmp_path / "g")
    want = np.frombuffer(raw, np.float32).reshape(36, 64)
    _write_array(str(tmp_path / "g" / "a"), want, (36, 64),
                 {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1,
                  "blocksize": 0}, lambda b: frame)
    got = zarr_store.open_group(str(tmp_path / "g"))["a"]
    _same(got, want)
    _same(got, j_zarr.open_group(str(tmp_path / "g"))["a"])


def test_reader_refusals(tmp_path, rng):
    with pytest.raises(FileNotFoundError):
        zarr_store.open_group(str(tmp_path / "nothing"))
    _write_array(str(tmp_path / "a"), np.zeros(4, np.float32), (4,),
                 {"id": "lzma"}, lambda b: b)
    with pytest.raises(ValueError, match="lzma"):
        np.asarray(zarr_store.ZarrArray(str(tmp_path / "a")))
    with pytest.raises(KeyError):
        zarr_store.open_group(str(tmp_path))["missing"]


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_decoder_on_committed_frames(name):
    frame, raw = _fixture(name)
    assert len(raw) == MANIFEST[name]["nbytes"]
    assert native.native_blosc_decompress(frame, len(raw)) == raw
    assert native.blosc_decompress(frame, len(raw)) == raw


def test_fixtures_cover_the_frame_kinds():
    flags = {n: c["flags"] for n, c in MANIFEST.items()}
    assert flags["memcpyed"] & 0x2
    assert flags["lz4_shuffle"] & 0x1 and (flags["lz4_shuffle"] >> 5) == 1
    assert not flags["lz4_noshuffle"] & 0x1
    assert (flags["zlib_shuffle"] >> 5) == 3
    blocks = MANIFEST["lz4_blocks"]
    assert blocks["nbytes"] > blocks["blocksize"]        # two blocks
    assert blocks["nbytes"] % blocks["blocksize"]        # one leftover


def _system_compress(lib, raw, typesize, clevel, shuffle, cname=b"lz4"):
    lib.blosc_compress_ctx.restype = ctypes.c_int
    out = ctypes.create_string_buffer(len(raw) + 1024)
    rc = lib.blosc_compress_ctx(
        ctypes.c_int(clevel), ctypes.c_int(shuffle),
        ctypes.c_size_t(typesize), ctypes.c_size_t(len(raw)), raw, out,
        ctypes.c_size_t(len(out)), ctypes.c_char_p(cname),
        ctypes.c_size_t(0), ctypes.c_int(1))
    assert rc > 0
    return out.raw[:rc]


@pytest.mark.parametrize("shape,dtype,clevel,shuffle", CASES)
def test_decoder_against_system_libblosc(rng, shape, dtype, clevel,
                                         shuffle):
    """Frames of the system libblosc at the JAX package's shapes; without
    a libblosc the committed frame of the same shuffle setting stands
    in."""
    lib = native.load_system()
    if lib is None:
        frame, raw = _fixture("lz4_shuffle" if shuffle else "lz4_noshuffle")
    else:
        arr = (rng.normal(size=shape) if np.issubdtype(dtype, np.floating)
               else rng.integers(0, 100, size=shape)).astype(dtype)
        raw = arr.tobytes()
        frame = _system_compress(lib, raw, arr.dtype.itemsize, clevel,
                                 shuffle)
        assert native.system_blosc_decompress(frame, len(raw)) == raw
    assert native.native_blosc_decompress(frame, len(raw)) == raw


@pytest.mark.parametrize("name", ["lz4_shuffle", "zlib_shuffle",
                                  "lz4_blocks", "memcpyed"])
def test_truncated_frame_raises(name):
    frame, raw = _fixture(name)
    for cut in (8, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError):
            native.native_blosc_decompress(frame[:cut], len(raw))


def test_decoder_builds_under_the_user_cache_when_read_only(tmp_path,
                                                           monkeypatch):
    in_package = native.native_lib_path()
    assert in_package.parent.parent == _build.BUILD_ROOT
    real_access = _build.os.access
    monkeypatch.setattr(
        _build.os, "access",
        lambda p, mode: False if str(p) == str(_build.BUILD_ROOT.parent)
        else real_access(p, mode))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    moved = native.native_lib_path()
    assert moved.parent.parent == (tmp_path / "xdg" / "vqa_project_tpu_torch"
                                   / "_build")
    assert moved.parent.name == in_package.parent.name


def test_failed_build_says_what_is_missing(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="zlib"):
        native._build(tmp_path / "lib.so")
    assert not list(tmp_path.iterdir())


def test_no_decoder_at_all_raises(monkeypatch):
    def fail():
        raise RuntimeError("no compiler")
    monkeypatch.setattr(native, "load_native", fail)
    monkeypatch.setattr(native, "load_system", lambda: None)
    frame, raw = _fixture("memcpyed")
    with pytest.raises(RuntimeError, match="no system libblosc"):
        native.blosc_decompress(frame, len(raw))


def test_package_data_ships_the_decoder_source():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    rel = native.SOURCE.relative_to(_build.CSRC.parent).as_posix()
    assert any(fnmatch.fnmatch(rel, g)
               for g in data["vqa_project_tpu_torch"])
