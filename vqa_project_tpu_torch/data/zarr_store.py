"""Minimal zarr-v2 DirectoryStore reader and writer (numpy only).

Copy of ``vqa_project_tpu/data/zarr_store.py``. The reference stores
region features in zarr groups; the zarr package is not needed, the
on-disk v2 format is read directly:

  store/
    .zgroup                       {"zarr_format": 2}
    <array_name>/.zarray          shape/chunks/dtype/compressor metadata
    <array_name>/<i>.<j>...       chunk files

Compressors: null, zlib, gzip, and blosc (zarr-python's default codec)
through ``data/native``. Missing chunks read as ``fill_value``; arrays
may have several chunks. The writer emits one zlib level-1 chunk per
array (or a raw one), which zarr-python also reads.
"""

from __future__ import annotations

import itertools
import json
import os
import zlib
from typing import Dict, Iterator, List, Optional

import numpy as np

from vqa_project_tpu_torch.data.native import blosc_decompress


def _decode_chunk(raw: bytes, compressor: Optional[dict],
                  nbytes: int) -> bytes:
    if compressor is None:
        return raw
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.decompress(raw)
    if cid == "gzip":
        import gzip

        return gzip.decompress(raw)
    if cid == "blosc":
        return blosc_decompress(raw, nbytes)
    raise ValueError(f"unsupported zarr compressor: {cid!r}")


class ZarrArray:
    """Read-only view of one zarr-v2 array directory."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"not a zarr v2 array: {path}")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.compressor = meta.get("compressor")
        self.fill_value = meta.get("fill_value", 0)
        self.order = meta.get("order", "C")
        if meta.get("filters"):
            raise ValueError("zarr filters not supported")

    def __getitem__(self, key) -> np.ndarray:
        return np.asarray(self)[key]

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = np.empty(self.shape, dtype=self.dtype)
        if out.size and self.fill_value is not None:
            out.fill(self.fill_value)
        grid = [range(-(-s // c)) for s, c in zip(self.shape, self.chunks)]
        for coords in itertools.product(*grid):
            name = ".".join(map(str, coords)) if coords else "0"
            cpath = os.path.join(self.path, name)
            if not os.path.exists(cpath):
                continue  # missing chunk = fill_value
            with open(cpath, "rb") as f:
                raw = f.read()
            nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
            buf = _decode_chunk(raw, self.compressor, nbytes)
            chunk = np.frombuffer(buf, dtype=self.dtype).reshape(
                self.chunks, order=self.order)
            sel = tuple(
                slice(c * ch, min((c + 1) * ch, s))
                for c, ch, s in zip(coords, self.chunks, self.shape))
            sub = tuple(slice(0, sl.stop - sl.start) for sl in sel)
            out[sel] = chunk[sub]
        if dtype is not None:
            out = out.astype(dtype, copy=False)
        return out


class ZarrGroup:
    """Read-only zarr-v2 group; mirrors the zarr.open(...)[key] surface
    used by the reference dataset classes."""

    def __init__(self, path: str):
        self.path = path
        self._cache: Dict[str, ZarrArray] = {}

    def keys(self) -> List[str]:
        out = []
        for name in sorted(os.listdir(self.path)):
            if os.path.isfile(os.path.join(self.path, name, ".zarray")):
                out.append(name)
        return out

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __contains__(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self.path, str(key), ".zarray"))

    def __getitem__(self, key: str) -> ZarrArray:
        key = str(key)
        if key not in self._cache:
            apath = os.path.join(self.path, key)
            if not os.path.isfile(os.path.join(apath, ".zarray")):
                raise KeyError(key)
            self._cache[key] = ZarrArray(apath)
        return self._cache[key]


def open_group(path: str, mode: str = "r") -> "ZarrGroup":
    """zarr.open_group equivalent (read: ZarrGroup, write: ZarrWriter)."""
    if mode == "r":
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        return ZarrGroup(path)
    if mode in ("w", "a"):
        return ZarrWriter(path)
    raise ValueError(f"unsupported mode {mode!r}")


class ZarrWriter(ZarrGroup):
    """Writer emitting zarr-v2 arrays (one chunk per array, zlib level 1).

    Region-feature arrays are small (36 x 2048 fp32 = 288 KB) so a single
    chunk matches the reference's access pattern (whole-array reads).
    """

    def __init__(self, path: str, compress: bool = True):
        os.makedirs(path, exist_ok=True)
        zg = os.path.join(path, ".zgroup")
        if not os.path.exists(zg):
            with open(zg, "w") as f:
                json.dump({"zarr_format": 2}, f)
        self.compress = compress
        super().__init__(path)

    def create_dataset(self, name: str, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data)
        apath = os.path.join(self.path, str(name))
        os.makedirs(apath, exist_ok=True)
        compressor = {"id": "zlib", "level": 1} if self.compress else None
        meta = {
            "zarr_format": 2,
            "shape": list(data.shape),
            "chunks": list(data.shape) if data.ndim else [1],
            "dtype": data.dtype.str,
            "compressor": compressor,
            "fill_value": 0,
            "filters": None,
            "order": "C",
        }
        with open(os.path.join(apath, ".zarray"), "w") as f:
            json.dump(meta, f)
        raw = data.tobytes()
        if self.compress:
            raw = zlib.compress(raw, 1)
        cname = ".".join(["0"] * max(data.ndim, 1))
        with open(os.path.join(apath, cname), "wb") as f:
            f.write(raw)
