"""Build the CUDA kernels of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to ``vqa_project_tpu_torch/_build/<hash>/`` where the
package directory is writable, else (a read-only install) to
``vqa_project_tpu_torch/_build/<hash>/`` under the user's cache directory
(``$XDG_CACHE_HOME`` or ``~/.cache``). The hash covers every source and
the compiler flags, so an edited source builds anew and an unchanged one
is reused; beside each library, ``lib<name>.log``
keeps the compiler's report (registers, shared memory and spills of each
kernel, from ``-Xptxas -v``). ``build_all`` starts one ``nvcc`` per
source, all at once. ``counted`` gives a kernel's wrapper its launch
counter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")
KERNELS = ("edge_aggregate", "edge_aggregate_bwd", "gather_rows",
           "graph_block", "graph_block_bwd", "gru_scan", "gru_scan_bwd",
           "gru_wgrad")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of each library's entry points (all return cudaError_t,
# except edge_aggregate_bwd_tiles and graph_block_bwd_groups, counts)
_SIGNATURES = {
    "edge_aggregate": {
        "edge_aggregate_fwd": [_P] * 6 + [_I] * 7 + [_P],
        "edge_aggregate_fwd_res": [_P] * 8 + [_I] * 5 + [_U, _F, _I, _I, _P],
    },
    "edge_aggregate_bwd": {
        "edge_aggregate_bwd_tiles": [_I],
        "edge_aggregate_bwd": [_P] * 13 + [_I, _I, _I, _I, _F, _I, _I, _P],
    },
    "gather_rows": {
        "gather_rows_packed": [_P, _P, _P, _P, _L] + [_I] * 5 + [_P],
        "gather_rows_blocked": [_P, _P, _P, _L, _I, _L, _I, _P],
        "gather_image_rows": [_P] * 6 + [_L] + [_I] * 6 + [_P],
    },
    "graph_block": {
        "graph_block_fwd": [_P] * 18 + [_I] * 8 + [_U, _F, _I, _P],
        "tile_gemm_run": [_P] * 4 + [_I] * 9 + [_F, _P],
        "wgmma_gemm_run": [_P] * 4 + [_I] * 8 + [_F, _I, _I, _P],
    },
    "graph_block_bwd": {
        "graph_block_bwd_groups": [_I],
        "graph_block_bwd": [_P] * 28 + [_I] * 7 + [_F, _I, _P],
    },
    "gru_scan": {
        "gru_scan_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "gru_scan_persistent": [_P] * 9 + [_I, _I, _I, _P],
    },
    "gru_scan_bwd": {
        "gru_scan_bwd_step": [_P] * 11 + [_I, _I, _I, _I, _P],
        "gru_scan_bwd_persistent": [_P] * 9 + [_I, _I, _I, _P],
        "gru_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "gru_wgrad": {
        "gru_wgrad_wgmma": [_P] * 4 + [_I, _I, _I, _P],
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return path


def build_root() -> Path:
    """BUILD_ROOT inside the package where its directory is writable,
    else the same path under the user's cache directory."""
    if os.access(BUILD_ROOT.parent, os.W_OK):
        return BUILD_ROOT
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / _PKG.name / BUILD_ROOT.name


def build_dir() -> Path:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_root() / h.hexdigest()[:16]


def _compile(nvcc: str, name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen, out: Path) -> None:
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or none


def build_all(names: Iterable[str] = KERNELS) -> float:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source in parallel, and load them. Returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        d = build_dir()
        todo = [n for n in names if not (d / f"lib{n}.so").exists()]
        if todo:
            nvcc = _nvcc()
            d.mkdir(parents=True, exist_ok=True)
            procs = {n: _compile(nvcc, n, d / f"lib{n}.so") for n in todo}
            errors = []
            for n, proc in procs.items():  # every process is waited for
                try:
                    _finish(n, proc, d / f"lib{n}.so")
                except RuntimeError as e:
                    errors.append(str(e))
            if errors:
                raise RuntimeError("\n".join(errors))
        for n in names:
            _load_locked(n, d)
    return time.perf_counter() - t0


def _load_locked(name: str, d: Path) -> ctypes.CDLL:
    if name not in _loaded:
        lib = ctypes.CDLL(str(d / f"lib{name}.so"))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]


def resource_report(name: str) -> str:
    """The ptxas lines (registers, shared memory, spills) of a built
    library's kernels."""
    log = (build_dir() / f"lib{name}.log").read_text()
    return "\n".join(line.strip() for line in log.splitlines()
                     if "registers" in line or "spill" in line)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name]
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: cudaError_t {rc} (cuda_runtime_api.h)")


# every kernel wrapper that counts its launches, each noted by
# ``counted`` where it is defined
COUNTED: list = []


def counted(fn):
    """Give the kernel wrapper ``fn`` a launch counter, ``fn.launches``
    from 0, which the wrapper adds to, and note it in ``COUNTED``."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn
