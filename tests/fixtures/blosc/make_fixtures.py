"""Write the blosc-1 frames of this directory with a system libblosc.

    python tests/fixtures/blosc/make_fixtures.py

Each case is ``<name>.blosc`` (the frame) and ``<name>.raw`` (the bytes
it decodes to); ``manifest.json`` lists them with their codec, shuffle,
typesize, block size and header flags. The frames let the port's decoder
be checked where no libblosc is installed (tests/test_torch_zarr.py,
chip_smoke.py phase 15).
"""

import ctypes
import ctypes.util
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# name: (array, codec, shuffle, clevel); at clevel 1 blosc splits the
# 80,000-byte case into a 65,536-byte block and a leftover block
def _cases():
    rng = np.random.default_rng(20261017)
    return {
        "lz4_shuffle": (np.round(rng.normal(size=(36, 64)), 2)
                        .astype(np.float32), b"lz4", 1, 5),
        "lz4_noshuffle": (np.round(rng.normal(size=2048), 1)
                          .astype(np.float32), b"lz4", 0, 5),
        "zlib_shuffle": (np.round(rng.normal(size=(64, 32)), 2)
                         .astype(np.float32), b"zlib", 1, 5),
        "memcpyed": (rng.integers(0, 255, size=17).astype(np.uint8),
                     b"lz4", 1, 5),
        "lz4_blocks": (rng.integers(0, 16, size=20000).astype(np.float32),
                       b"lz4", 1, 1),
        "lz4_float64": (np.round(rng.normal(size=(129, 7)), 3), b"lz4", 1,
                        1),
    }


def main():
    lib = ctypes.CDLL(ctypes.util.find_library("blosc") or "libblosc.so.1")
    lib.blosc_compress_ctx.restype = ctypes.c_int
    manifest = []
    for name, (arr, cname, shuffle, clevel) in _cases().items():
        raw = arr.tobytes()
        out = ctypes.create_string_buffer(len(raw) + 1024)
        rc = lib.blosc_compress_ctx(
            ctypes.c_int(clevel), ctypes.c_int(shuffle),
            ctypes.c_size_t(arr.dtype.itemsize), ctypes.c_size_t(len(raw)),
            raw, out, ctypes.c_size_t(len(out)), ctypes.c_char_p(cname),
            ctypes.c_size_t(0), ctypes.c_int(1))
        if rc <= 0:
            raise RuntimeError(f"{name}: blosc_compress_ctx returned {rc}")
        frame = out.raw[:rc]
        with open(os.path.join(HERE, f"{name}.blosc"), "wb") as f:
            f.write(frame)
        with open(os.path.join(HERE, f"{name}.raw"), "wb") as f:
            f.write(raw)
        manifest.append({
            "name": name, "codec": cname.decode(), "shuffle": shuffle,
            "typesize": arr.dtype.itemsize, "nbytes": len(raw),
            "cbytes": len(frame), "flags": frame[2],
            "blocksize": int.from_bytes(frame[8:12], "little")})
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


if __name__ == "__main__":
    main()
