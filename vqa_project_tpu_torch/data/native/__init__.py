"""Blosc-1 decoding for the zarr reader.

``blosc_decompress(frame, nbytes)`` resolves, in this order:

1. the in-tree C++ decoder (``blosc_decoder.cpp``: LZ4, zlib and
   byte-unshuffle), built at first use with ``g++ ... -lz`` into
   ``vqa_project_tpu_torch/_build/<hash>/libvqax_blosc.so``, or under the
   user's cache directory when the package directory is read-only (the
   rule of ``ops/_build.py``); the hash covers the source and the flags;
2. a system libblosc (``blosc_decompress_ctx`` through ctypes);
3. a ``RuntimeError`` that says why neither is there.

A decoder that does not build is not retried within the process: the
reason is kept and reported.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from vqa_project_tpu_torch.ops._build import build_root

SOURCE = Path(__file__).resolve().parent / "blosc_decoder.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIB_NAME = "libvqax_blosc.so"

_lock = threading.Lock()
_native: Optional[ctypes.CDLL] = None
_native_error: Optional[str] = None
_system: Optional[ctypes.CDLL] = None


def native_lib_path() -> Path:
    """Where the decoder for the current source and flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + ("-lz",)).encode())
    h.update(SOURCE.read_bytes())
    return build_root() / h.hexdigest()[:16] / LIB_NAME


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) to build the blosc "
                           "decoder")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lz"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(
            "building the blosc decoder failed (it needs g++ and zlib's "
            "development files, zlib.h and libz.so):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or none


def load_native() -> ctypes.CDLL:
    """The in-tree decoder, built on first use; raises RuntimeError with
    the build's failure (kept for the rest of the process)."""
    global _native, _native_error
    with _lock:
        if _native is not None:
            return _native
        if _native_error is not None:
            raise RuntimeError(_native_error)
        try:
            path = native_lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _native_error = str(e)
            raise RuntimeError(_native_error) from e
        lib.vqax_blosc_decompress.restype = ctypes.c_int
        lib.vqax_blosc_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t]
        _native = lib
        return lib


def load_system() -> Optional[ctypes.CDLL]:
    """A system libblosc, or None."""
    global _system
    if _system is not None:
        return _system
    for name in ("blosc", "libblosc.so.1", "libblosc.so"):
        path = ctypes.util.find_library(name) or name
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.blosc_decompress_ctx.restype = ctypes.c_int
        _system = lib
        return lib
    return None


def native_blosc_decompress(frame: bytes, nbytes: int) -> bytes:
    """Decode with the in-tree decoder; ValueError on a bad frame."""
    lib = load_native()
    out = ctypes.create_string_buffer(nbytes)
    rc = lib.vqax_blosc_decompress(frame, len(frame), out, nbytes)
    if rc < 0:
        raise ValueError(f"blosc frame could not be decoded (code {rc})")
    return out.raw[:rc]


def system_blosc_decompress(frame: bytes, nbytes: int) -> bytes:
    """Decode with the system libblosc; ValueError on a bad frame."""
    lib = load_system()
    if lib is None:
        raise RuntimeError("no system libblosc found")
    out = ctypes.create_string_buffer(nbytes)
    rc = lib.blosc_decompress_ctx(frame, out, ctypes.c_size_t(nbytes),
                                  ctypes.c_int(1))
    if rc < 0:
        raise ValueError(f"libblosc could not decode the frame (code {rc})")
    return out.raw[:rc]


def blosc_decompress(frame: bytes, nbytes: int) -> bytes:
    """Decode a blosc frame of ``nbytes`` uncompressed bytes (from the
    zarr chunk's shape and dtype)."""
    try:
        load_native()
    except RuntimeError as e:
        if load_system() is None:
            raise RuntimeError(
                "a blosc-compressed zarr chunk, but the in-tree decoder did "
                f"not build ({e}) and no system libblosc was found") from e
        return system_blosc_decompress(frame, nbytes)
    return native_blosc_decompress(frame, nbytes)
